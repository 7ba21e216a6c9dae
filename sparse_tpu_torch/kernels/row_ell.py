"""Degree-sorted per-row ELL — the unstructured SpMM/SpMV path.

Rows are relabelled by descending nnz count so consecutive rows have
near-uniform width; rows of one width class share a tier. The layout is the
one ``sparse_tpu.kernels.row_ell.build_row_ell`` builds, array for array:
grouped ``(r/G, w, G)`` tiers with exact widths (``group=16``, default) or
legacy ``(r, w)`` tiers with widths quantized to ``min_pad`` (``group=0``).
It is built host-side with NumPy and moved to the device once, as one flat
``cols`` buffer and one flat ``data`` buffer (the tiers are views into
them), a per-tier table and a position→row map, so that one kernel launch
covers every tier and stores straight into the unpermuted output.

The products run in the hand-written CUDA kernels of ``csrc/row_ell.cu``
(K1 SpMV, K2 SpMM) for tensors on the GPU. Beside each wrapper sits its plain
PyTorch version (``_spmv_plain``, ``_spmm_plain``), which the wrapper takes
only for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._settings import resolve_device
from .._utils import result_dtype, torch_dtype
from . import _cuda


class RowEll(NamedTuple):
    """Tiered, degree-sorted per-row ELL layout of a 2-D sparse matrix.

    ``tiers``: tuple of ``(cols, data)`` views of shape ``(r_t/G, w_t, G)``
    (or legacy ``(r_t, w_t)``) into ``flat_cols`` / ``flat_data``, holding the
    relabelled rows' column ids and values, zero-padded to the tier shape.
    ``perm_inv`` maps original row ids to padded positions
    (``out_original = out_by_position[perm_inv]``). ``tier_table`` is int64
    ``(n_tiers + 1, 4)``: first position, width, group (1 for legacy tiers),
    offset into the flat buffers; its last row is the block of rows without
    entries. ``row_of_pos`` is the original row of each position, -1 for
    group padding.
    """

    tiers: tuple
    perm_inv: torch.Tensor  # (n_rows,) int32
    n_rows: int
    n_cols: int
    nz_rows: int
    flat_cols: torch.Tensor  # int32
    flat_data: torch.Tensor
    tier_table: torch.Tensor  # (n_tiers + 1, 4) int64
    row_of_pos: torch.Tensor  # (n_pos,) int32


def row_ell_cache_key(min_pad=8, max_tiers=None, group=16):
    """Normalized cache key for a built layout: ``min_pad`` only affects the
    legacy ``group=0`` layout, so it is normalized out when ``group > 0``."""
    return (None if group else min_pad, max_tiers, group)


# the key under which COO.to_row_ell() with all-default arguments caches
ROW_ELL_DEFAULT_KEY = row_ell_cache_key()


def _merge_bounds(bounds, max_tiers):
    """Greedily merge adjacent width classes (narrower pads up to the
    wider width), always taking the cheapest merge, until bounded."""
    while len(bounds) > max_tiers:
        costs = [
            (bounds[i + 1][1] - bounds[i + 1][0]) * (bounds[i][2] - bounds[i + 1][2])
            for i in range(len(bounds) - 1)
        ]
        i = int(np.argmin(costs))
        bounds[i] = (bounds[i][0], bounds[i + 1][1], bounds[i][2])
        del bounds[i + 1]
    return bounds


def _build_tiers(rows, cols, data, n_rows, min_pad, max_tiers, group):
    """The NumPy layout: ``(tiers, perm_inv, nz_rows)``, with the tiers as
    ``(cols int32, data)`` array pairs."""
    nnz = rows.shape[0]
    if max_tiers is None:
        max_tiers = 32 if group else 16

    counts = np.bincount(rows, minlength=n_rows) if nnz else np.zeros(n_rows, dtype=np.int64)
    perm = np.argsort(-counts, kind="stable")  # relabelled -> original
    sorted_counts = counts[perm]
    nz_rows = int((sorted_counts > 0).sum())

    tiers = []
    pos_of_sorted = np.empty(n_rows, dtype=np.int64)
    off = 0
    if nz_rows:
        order = np.argsort(rows, kind="stable")
        cols_s = cols[order]
        data_s = data[order]
        indptr = np.concatenate([[0], np.cumsum(counts)])

        w_of = sorted_counts[:nz_rows]
        if group:
            b = np.flatnonzero(np.diff(w_of)) + 1
            bounds = [
                (int(s), int(e), int(w_of[s]))
                for s, e in zip(np.concatenate([[0], b]), np.concatenate([b, [nz_rows]]))
            ]
        else:
            cls = -(-w_of // min_pad)  # ceil width class
            b = np.flatnonzero(np.diff(cls)) + 1
            bounds = [
                (int(s), int(e), int(cls[s]) * min_pad)
                for s, e in zip(np.concatenate([[0], b]), np.concatenate([b, [nz_rows]]))
            ]
        bounds = _merge_bounds(bounds, max_tiers)

        for start, end, w in bounds:
            r = end - start
            rp = -(-r // group) * group if group else r
            c2 = np.zeros((rp, w), dtype=np.int32)
            d2 = np.zeros((rp, w), dtype=data.dtype)
            orig = perm[start:end]
            s = indptr[orig]
            cnt = indptr[orig + 1] - s
            rr = np.repeat(np.arange(r), cnt)
            pos = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            src = np.repeat(s, cnt) + pos
            c2[rr, pos] = cols_s[src].astype(np.int32)
            d2[rr, pos] = data_s[src]
            if group:
                # rows within the tier sorted by first column id, pad rows last
                key = np.full(rp, np.iinfo(np.int64).max)
                key[:r] = cols_s[s]  # every tier row has >=1 entry
                o = np.argsort(key, kind="stable")
                inv_o = np.empty(rp, dtype=np.int64)
                inv_o[o] = np.arange(rp)
                c2 = c2[o]
                d2 = d2[o]
                c3 = np.ascontiguousarray(c2.reshape(rp // group, group, w).transpose(0, 2, 1))
                d3 = np.ascontiguousarray(d2.reshape(rp // group, group, w).transpose(0, 2, 1))
                tiers.append((c3, d3))
                pos_of_sorted[start:end] = off + inv_o[np.arange(r)]
            else:
                tiers.append((c2, d2))
                pos_of_sorted[start:end] = off + np.arange(r)
            off += rp

    # zero-nnz rows take the trailing positions
    pos_of_sorted[nz_rows:n_rows] = off + np.arange(n_rows - nz_rows)
    # positions include per-tier group padding, so they can exceed n_rows;
    # they must still fit the int32 indices the kernels read
    if off + (n_rows - nz_rows) > np.iinfo(np.int32).max:
        raise ValueError("row-ELL padded row count exceeds int32 index range")
    perm_inv = np.empty(n_rows, dtype=np.int64)
    perm_inv[perm] = pos_of_sorted
    return tiers, perm_inv.astype(np.int32), nz_rows


def pack_row_ell(tiers, perm_inv, n_rows, n_cols, nz_rows, device=None, dtype=np.float32):
    """A :class:`RowEll` on ``device`` from NumPy tiers and ``perm_inv``
    (``dtype`` is the value dtype used when there are no tiers)."""
    device = resolve_device(device)
    table = []
    pos = off = 0
    for c, _ in tiers:
        if c.ndim == 3:
            rp, w, g = c.shape[0] * c.shape[2], c.shape[1], c.shape[2]
        else:
            rp, w, g = c.shape[0], c.shape[1], 1
        table.append((pos, w, g, off))
        pos += rp
        off += c.size
    table.append((pos, 0, 1, off))  # rows without entries
    n_pos = pos + (n_rows - nz_rows)

    perm_inv = np.asarray(perm_inv, dtype=np.int64)
    row_of_pos = np.full(n_pos, -1, dtype=np.int32)
    row_of_pos[perm_inv] = np.arange(n_rows, dtype=np.int32)
    if tiers:
        flat_c = np.concatenate([np.asarray(c, dtype=np.int32).reshape(-1) for c, _ in tiers])
        flat_d = np.concatenate([np.asarray(d).reshape(-1) for _, d in tiers])
    else:
        flat_c = np.zeros(0, dtype=np.int32)
        flat_d = np.zeros(0, dtype=dtype)

    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    flat_cols = dev(flat_c)
    flat_data = dev(flat_d, torch_dtype(flat_d.dtype))
    views = []
    for (c, _), (_, _, _, o) in zip(tiers, table):
        views.append((flat_cols[o : o + c.size].view(c.shape), flat_data[o : o + c.size].view(c.shape)))
    return RowEll(
        tuple(views),
        dev(perm_inv, torch.int32),
        int(n_rows),
        int(n_cols),
        int(nz_rows),
        flat_cols,
        flat_data,
        dev(np.asarray(table, dtype=np.int64)),
        dev(row_of_pos),
    )


def build_row_ell(rows, cols, data, n_rows, n_cols, min_pad=8, max_tiers=None, group=16, device=None):
    """Host-side preprocessing: degree-sort rows, tier them by width class,
    lay each tier out grouped ``(r/G, w, G)`` (``group>0``, exact widths,
    default) or legacy ``(r, w)`` (``group=0``, widths quantized to
    multiples of ``min_pad``); then move the layout to ``device`` once."""
    rows = np.asarray(rows)
    data = np.asarray(data)
    tiers, perm_inv, nz_rows = _build_tiers(rows, np.asarray(cols), data, n_rows, min_pad, max_tiers, group)
    return pack_row_ell(tiers, perm_inv, n_rows, n_cols, nz_rows, device=device, dtype=data.dtype)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic; used for CPU tensors)
# ---------------------------------------------------------------------------


def _result_dtype(re, *operands):
    """NumPy promotion of the layout's values with the operands, as in
    ``sparse_tpu`` (an empty layout does not take part)."""
    dts = [t.dtype for t in operands if t is not None]
    if re.tiers:
        dts.append(re.flat_data.dtype)
    return result_dtype(*dts)


def _spmm_plain(re, dense):
    """``A @ dense`` gathered, multiplied and reduced per tier, then
    unpermuted (``sparse_tpu.kernels.row_ell._spmm`` without the w-split)."""
    n = dense.shape[1]
    dt = _result_dtype(re, dense)
    dense = dense.to(dt)
    outs = []
    for c, d in re.tiers:
        g = dense[c.long()]  # grouped (r/G, w, G, n) or legacy (r, w, n)
        rows = d.shape[0] * (d.shape[2] if d.ndim == 3 else 1)
        outs.append((d.to(dt).unsqueeze(-1) * g).sum(1).reshape(rows, n))
    outs.append(torch.zeros((re.n_rows - re.nz_rows, n), dtype=dt, device=dense.device))
    return torch.cat(outs)[re.perm_inv.long()]


def _spmv_plain(re, x, y=None):
    """``A @ x (+ y)``: the exact per-tier gather-reduce of
    ``sparse_tpu.kernels.row_ell._spmv`` (``lane_gather=False``)."""
    dt = _result_dtype(re, x, y)
    x = x.to(dt)
    outs = [(d.to(dt) * x[c.long()]).sum(1).reshape(-1) for c, d in re.tiers]
    outs.append(torch.zeros(re.n_rows - re.nz_rows, dtype=dt, device=x.device))
    out = torch.cat(outs)[re.perm_inv.long()]
    return out if y is None else out + y.to(dt)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = (torch.float32, torch.float64)


def _check_operand(re, operand, name, ndim, length):
    if not isinstance(operand, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(operand).__name__}")
    if operand.device != re.flat_cols.device:
        raise ValueError(f"{name} is on {operand.device} but the layout is on {re.flat_cols.device}")
    if operand.ndim != ndim or operand.shape[0] != length:
        raise ValueError(f"{name} of shape {tuple(operand.shape)} does not fit a {re.n_rows}x{re.n_cols} layout")


def _kernel_inputs(re, dt, *operands):
    """Layout and operands cast to ``dt`` and made contiguous for a launch."""
    if re.flat_data.dtype != dt:
        re = re._replace(flat_data=re.flat_data.to(dt))
    return (re, *(None if t is None else t.to(dt).contiguous() for t in operands))


def row_ell_spmm(re: RowEll, dense):
    """``A @ dense`` → dense ``(n_rows, N)`` tensor on the layout's device,
    accumulated in the result dtype (float32 or float64)."""
    _check_operand(re, dense, "dense", 2, re.n_cols)
    dt = _result_dtype(re, dense)
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"row_ell_spmm computes in float32 or float64, not {dt}")
    if dense.device.type == "cpu":
        return _spmm_plain(re, dense)
    re, dense = _kernel_inputs(re, dt, dense)
    out = torch.empty((re.n_rows, dense.shape[1]), dtype=dt, device=dense.device)
    return _cuda.spmm(re, dense, out)


# largest n_cols sparse_tpu's one-hot SpMV accepts (its VMEM table bound);
# the port refuses the same inputs for the same strategies
ONEHOT_SPMV_MAX_K = 8192 * 128

_STRATEGIES = (None, "exact", "onehot", "onehot3")


def row_ell_spmv(re: RowEll, x, strategy=None, y=None):
    """``A @ x`` (``+ y`` when given, in the same pass) → dense ``(n_rows,)``.

    Every ``strategy`` (``None``/``"exact"``, ``"onehot"``, ``"onehot3"``)
    runs the same exact kernel: the one-hot strategies of ``sparse_tpu`` are
    TPU gather workarounds with a relative error of 1e-6 / 1e-8, which this
    card does not need. They keep their ``n_cols`` limit."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of {_STRATEGIES}")
    _check_operand(re, x, "x", 1, re.n_cols)
    if strategy in ("onehot", "onehot3") and x.shape[0] > ONEHOT_SPMV_MAX_K:
        raise ValueError(
            f"strategy={strategy!r} requires n_cols <= {ONEHOT_SPMV_MAX_K} (got {x.shape[0]}); use the default exact path"
        )
    if y is not None:
        _check_operand(re, y, "y", 1, re.n_rows)
    dt = _result_dtype(re, x, y)
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"row_ell_spmv computes in float32 or float64, not {dt}")
    if x.device.type == "cpu":
        return _spmv_plain(re, x, y)
    re, x, y = _kernel_inputs(re, dt, x, y)
    out = torch.empty(re.n_rows, dtype=dt, device=x.device)
    return _cuda.spmv(re, x, y, out)


_SPMM_PROGRAMS = {}


def row_ell_spmm_program(re: RowEll):
    """A ``dense -> A @ dense`` callable bound to the layout, memoized on
    the layout's buffers, for repeated products against a fixed matrix
    (solvers, benchmarks)."""
    key = (id(re.flat_cols), id(re.flat_data))
    entry = _SPMM_PROGRAMS.get(key)
    if entry is not None and entry[0] is re.flat_cols and entry[1] is re.flat_data:
        return entry[2]

    def prog(dense):
        return row_ell_spmm(re, dense)

    _SPMM_PROGRAMS[key] = (re.flat_cols, re.flat_data, prog)
    if len(_SPMM_PROGRAMS) > 32:  # bound the memo
        _SPMM_PROGRAMS.pop(next(iter(_SPMM_PROGRAMS)))
    return prog
