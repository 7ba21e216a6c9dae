"""COO ``__getitem__``: basic (int / slice / newaxis / Ellipsis) and advanced
(1-D integer or boolean arrays, broadcast together) indexing, on the array's
device, with the semantics and the exact output of ``sparse_tpu.ops.indexing``
(coordinates, their dtype, data, shape, fill value, canonical order).

- The leading-axis fast path (an int, a step-1 slice or a 1-D row list with
  the other axes whole): ``torch.searchsorted`` over the sorted row
  coordinate, the picked runs expanded by ``repeat_interleave``.
- The general path: one boolean mask over the stored entries for the ints
  and slices (negative steps too), a sort-join of the advanced indices (an
  int64 key of the advanced axes, a stable sort of the queries, two binary
  searches), NumPy's rule that moves the advanced axis to the front when
  the advanced indices are not adjacent, and one stable sort of the output
  by its linear key where the index can reorder it.

Reads back to the host: the fast path takes one (the row range, or the
output size together with a tensor index's bounds check); the general path
takes one (the output size, with the bounds checks). A boolean tensor index
adds the read of its ``nonzero``.

A position that holds one value gives a 0-d tensor on the array's device
(``sparse_tpu`` returns a NumPy scalar).
"""

from __future__ import annotations

import math
from numbers import Integral

import numpy as np
import torch

from .._utils import coords_dtype, full, get_out_dtype, numpy_dtype, take, torch_dtype, wide_index
from .slicing import normalize_index, run_checks

__all__ = ["getitem"]


def _scalar(data, k):
    """The 0-d tensor of ``data[k]`` (a copy)."""
    return data[k].clone()


def _fill_scalar(x):
    return full((), x.fill_value, x.dtype, x.device)


def _arange(n, device):
    return torch.arange(n, dtype=torch.int64, device=device)


def _expand_runs(lo, counts, total):
    """The positions ``lo[i], lo[i] + 1, ..., lo[i] + counts[i] - 1`` for every
    ``i`` in order, and the run ``i`` of each (``total`` = ``counts.sum()``)."""
    device = lo.device
    run = torch.repeat_interleave(_arange(lo.numel(), device), counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    within = _arange(total, device) - starts[run]
    return lo[run] + within, run


def _search_pair(rows, a, b):
    """Where ``a`` and ``b`` would go in the sorted ``rows`` (left side), read
    back together."""
    return torch.stack([torch.searchsorted(rows, a), torch.searchsorted(rows, b)]).tolist()


def _getitem_leading_fast(x, index, last_ellipsis, checks):
    """Selection on the leading axis of a canonical COO (rows sorted): a single
    row, a step-1 row range, or a 1-D row list, the other axes taken whole."""
    from ..core.coo import COO

    if x.ndim == 0 or len(index) != x.ndim or any(k is None for k in index):
        return NotImplemented
    for k, dim in zip(index[1:], x.shape[1:]):
        if not (isinstance(k, slice) and k == slice(0, dim, 1)):
            return NotImplemented
    k0 = index[0]
    rows = wide_index(x.coords[0])
    dev = x.device

    if isinstance(k0, Integral):
        k0 = int(k0)
        lo, hi = _search_pair(rows, k0, k0 + 1)
        if x.ndim == 1:
            if last_ellipsis:
                empty = torch.zeros((0, hi - lo), dtype=torch_dtype(coords_dtype(np.intp, 0)), device=dev)
                return COO._make(empty, x.data[lo:hi], (), x.fill_value)
            return _scalar(x.data, lo) if hi > lo else _fill_scalar(x)
        return COO._make(x.coords[1:, lo:hi], x.data[lo:hi], x.shape[1:], x.fill_value)

    if isinstance(k0, slice):
        start, stop, step = k0.start, k0.stop, k0.step
        if step != 1 or stop <= start:
            return NotImplemented
        lo, hi = _search_pair(rows, start, stop)
        dt = x.coords.dtype
        first = (rows[lo:hi].long() - start).to(dt)
        out_coords = torch.cat([first[None, :], x.coords[1:, lo:hi]])
        return COO._make(out_coords, x.data[lo:hi], (stop - start,) + x.shape[1:], x.fill_value)

    # a 1-D row list: join the queries against the sorted row stream
    q = k0.to(rows.dtype)
    lo = torch.searchsorted(rows, q, side="left")
    counts = torch.searchsorted(rows, q, side="right") - lo
    (total,) = run_checks(checks, [counts.sum()])
    n_q = k0.numel()
    # the picks' position is the new row: the coordinates' dtype widened only
    # where it cannot count the picks
    dt = torch_dtype(get_out_dtype(numpy_dtype(x.coords.dtype), max(n_q - 1, 0)))
    src, new_rows = _expand_runs(lo, counts, total)
    out_coords = torch.cat([new_rows[None, :].to(dt), take(x.coords[1:], (slice(None), src)).to(dt)])
    # canonical: the query order is the new row order, and each query's run is
    # ascending in the other axes
    return COO._make(out_coords, take(x.data, src), (n_q,) + x.shape[1:], x.fill_value)


def getitem(x, index):
    from ..core.coo import COO

    if isinstance(index, tuple) and index == () and x.ndim == 0:
        return _scalar(x.data, -1) if x.nnz else _fill_scalar(x)

    if isinstance(index, str):
        raise NotImplementedError(
            "field access by name needs a structured dtype, which torch tensors do not have (sparse_tpu_torch)"
        )

    # a trailing explicit Ellipsis gives a 0-d COO where a pure integer index
    # gives a scalar
    last_ellipsis = index is Ellipsis or (isinstance(index, tuple) and len(index) > 0 and index[-1] is Ellipsis)

    dev = x.device
    checks = []
    index = normalize_index(index, x.shape, device=dev, checks=checks)

    # identity (a fresh object, so that ``out=``-style mutation is safe)
    if (
        not any(k is None for k in index)
        and len(index) == x.ndim
        and all(isinstance(k, slice) and k == slice(0, d, 1) for k, d in zip(index, x.shape))
    ):
        return x.copy(deep=False)

    fast = _getitem_leading_fast(x, index, last_ellipsis, checks)
    if fast is not NotImplemented:
        return fast

    coords = x.coords
    nnz = x.nnz
    np_idx = numpy_dtype(coords.dtype)
    mask = torch.ones(nnz, dtype=torch.bool, device=dev)
    dim_entries = []  # one per index entry: how it makes an output axis
    adv_positions, adv_arrays, adv_dims = [], [], []
    # NumPy's rule: integers become 0-d advanced indices when an array index
    # is present, and count for the placement of the advanced axis
    has_arrays = any(isinstance(k, torch.Tensor) for k in index)
    reorders = False  # whether the output can leave the input's order

    d = 0
    for pos, k in enumerate(index):
        if k is None:
            dim_entries.append(("new",))
            continue
        if isinstance(k, Integral):
            mask &= wide_index(coords[d]) == int(k)
            if has_arrays:
                adv_positions.append(pos)
                dim_entries.append(("advint",))
            else:
                dim_entries.append(("int",))
        elif isinstance(k, slice):
            start, stop, step = k.start, k.stop, k.step
            c = coords[d].long()
            if step > 0:
                m = (c >= start) & (c < stop)
                if step != 1:
                    m &= (c - start) % step == 0
                newc = (c - start) // step
            else:
                m = (c <= start) & (c > stop)
                if step != -1:
                    m &= (start - c) % (-step) == 0
                newc = (start - c) // (-step)
                reorders = True
            mask &= m
            dim_entries.append(("slice", len(range(start, stop, step)), newc))
        else:  # an integer index array
            adv_positions.append(pos)
            adv_arrays.append(k)
            adv_dims.append(d)
            dim_entries.append(("adv",))
        d += 1

    if adv_arrays:
        reorders = True
        try:
            (L,) = np.broadcast_shapes(*[(a.numel(),) for a in adv_arrays])
        except ValueError as e:
            raise IndexError(f"shape mismatch among advanced indices: {e}") from None
        adv_shape = tuple(x.shape[dd] for dd in adv_dims)
        if math.prod(adv_shape) > np.iinfo(np.int64).max:
            raise ValueError("the advanced indices' key does not fit in int64")
        # join the stored entries with the index list on the advanced axes
        entry_key = _ravel([coords[dd] for dd in adv_dims], adv_shape, nnz, dev)
        query_key = _ravel([a.expand(L) for a in adv_arrays], adv_shape, L, dev)
        sorted_q, order = torch.sort(query_key, stable=True)
        lo = torch.searchsorted(sorted_q, entry_key, side="left")
        counts = torch.searchsorted(sorted_q, entry_key, side="right") - lo
        counts = torch.where(mask, counts, 0)
        (total,) = run_checks(checks, [counts.sum()])
        pos_in_q, src = _expand_runs(lo, counts, total)
        adv_result_coord = order[pos_in_q]
    else:
        L = None
        (total,) = run_checks(checks, [mask.sum()])
        src = torch.repeat_interleave(_arange(nnz, dev), mask.long(), output_size=total)
        adv_result_coord = None
    data_sel = take(x.data, src)

    # the output axes: the advanced axis at the first advanced index if the
    # advanced indices are adjacent, else in front
    out_rows, out_dtypes, out_shape = [], [], []
    adv_emitted = True
    if adv_arrays:
        ps = sorted(adv_positions)
        contiguous = len(ps) == 1 or all(b - a == 1 for a, b in zip(ps, ps[1:]))
        if not contiguous:
            out_rows.append(adv_result_coord)
            out_dtypes.append(np.dtype(np.intp))
            out_shape.append(L)
        adv_emitted = not contiguous
    for entry in dim_entries:
        kind = entry[0]
        if kind == "new":
            out_rows.append(torch.zeros(total, dtype=torch.int64, device=dev))
            out_dtypes.append(np_idx)
            out_shape.append(1)
        elif kind == "slice":
            out_rows.append(entry[2][src])
            out_dtypes.append(np_idx)
            out_shape.append(entry[1])
        elif kind in ("adv", "advint") and not adv_emitted:
            out_rows.append(adv_result_coord)
            out_dtypes.append(np.dtype(np.intp))
            out_shape.append(L)
            adv_emitted = True

    if not out_shape:
        if last_ellipsis:
            empty = torch.zeros((0, total), dtype=torch_dtype(coords_dtype(np.intp, 0)), device=dev)
            return COO._make(empty, data_sel, (), x.fill_value)
        return _scalar(data_sel, 0) if total else _fill_scalar(x)

    out_shape = tuple(int(s) for s in out_shape)
    dt = torch_dtype(coords_dtype(np.result_type(*out_dtypes), max(out_shape)))
    out_coords = torch.stack(out_rows)
    if reorders and total > 1:
        # canonical order: one stable sort of the (unique) linear keys
        order = torch.sort(_ravel(out_rows, out_shape, total, dev), stable=True).indices
        out_coords, data_sel = out_coords[:, order], take(data_sel, order)
    return COO._make(out_coords.to(dt), data_sel, out_shape, x.fill_value)


def _ravel(rows, shape, n, device):
    """The int64 row-major key of the coordinate rows ``rows`` in ``shape``."""
    key = torch.zeros(n, dtype=torch.int64, device=device)
    stride = 1
    for r, s in zip(reversed(rows), reversed(shape)):
        key += r.long() * stride
        stride *= s
    return key
