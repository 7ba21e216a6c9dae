"""The static-shape kernel surface of ``sparse_tpu.jitops``, on torch tensors.

Functions with static output sizes and no read back to the host, which a
later ``torch.compile`` can take: the pattern-preserving ``spmm``, ``spmv``,
``sddmm``, ``mttkrp``, ``sum_dense``, ``scale``, ``map_data``,
``add_same_pattern``, ``mul_same_pattern`` and ``transpose`` (a
permutation of the entries), and the capacity-bounded ``union_elemwise``
and ``spgemm`` (``kernels.spgemm.esc_spgemm``: it reads nothing back, so it
can be captured in a CUDA graph). A 2-D CSR/CSC ``GCXS`` gives
``spmm``/``spmv`` its triplet through a device ``searchsorted`` of its
``indptr``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._utils import numpy_dtype, result_dtype, take, zero_of_dtype
from .core.coo import COO, _as_tensor, _linearize
from .core.gcxs import GCXS
from .kernels import dot as _kdot
from .kernels.elemwise import coo_elemwise_union
from .kernels.spgemm import esc_spgemm


def _triplet(a):
    """``(rows, cols, data)`` of a COO, or of a 2-D CSR/CSC ``GCXS`` (its
    ``indptr`` expanded to the compressed ids by a device ``searchsorted``
    over the entries: nnz is static, nothing is read back)."""
    if isinstance(a, GCXS):
        if a.ndim != 2 or a.compressed_axes not in ((0,), (1,)):
            raise ValueError("traceable ops accept 2-D CSR/CSC-form GCXS")
        idx = a.indices
        nnz = idx.shape[0]
        indptr = a.indptr.long()
        comp_ids = (torch.searchsorted(indptr, torch.arange(nnz, device=idx.device), right=True) - 1).to(idx.dtype)
        if a.compressed_axes == (0,):
            return comp_ids, idx, a.data
        return idx, comp_ids, a.data
    return a.coords[0], a.coords[1], a.data


def spmm(a, dense):
    """``a @ dense`` → dense ``(a.shape[0], N)`` on ``a``'s device, in the
    promoted dtype (zero fill assumed). ``a`` is a COO or a 2-D CSR/CSC
    GCXS; differentiable in its data and in ``dense``."""
    r, c, d = _triplet(a)
    dense = _as_tensor(dense, d.device)
    dt = result_dtype(d.dtype, dense.dtype)
    return _kdot.coo_spmm(r, c, d.to(dt), dense.to(dt), n_rows=a.shape[0])


def spmv(a, x):
    """``a @ x`` → dense ``(a.shape[0],)``, as :func:`spmm`."""
    r, c, d = _triplet(a)
    x = _as_tensor(x, d.device)
    dt = result_dtype(d.dtype, x.dtype)
    return _kdot.coo_spmv(r, c, d.to(dt), x.to(dt), n_rows=a.shape[0])


def sddmm(s: COO, lhs, rhs):
    """``s ⊙ (lhs @ rhs)`` at ``s``'s pattern → a COO on ``s``'s coordinates
    with a zero fill of the result dtype (``kernels.sddmm``: K4 on the GPU)."""
    if not isinstance(s, COO):
        raise TypeError(f"jitops.sddmm takes a COO sample, not {type(s).__name__}")
    r, c, d = _triplet(s)
    vals = _kdot.sddmm(r, c, d, _as_tensor(lhs, d.device), _as_tensor(rhs, d.device))
    return COO._make(s.coords, vals, s.shape, zero_of_dtype(numpy_dtype(vals.dtype)))


def mttkrp(t: COO, c, d):
    """``out[i, r] = Σ t[i, j, k] · c[j, r] · d[k, r]`` for a 3-D ``COO`` ``t``
    → dense ``(t.shape[0], r)`` on ``t``'s device. Its canonical coordinates
    are sorted by ``i``, as :func:`sparse_tpu_torch.kernels.mttkrp` needs;
    on the GPU it runs the sorted-COO MTTKRP kernel. ``c`` and ``d`` may be
    tensors on ``t``'s device or array-likes."""
    if t.ndim != 3:
        raise ValueError(f"mttkrp needs a 3-D tensor, not one of shape {t.shape}")
    c, d = _as_tensor(c, t.device), _as_tensor(d, t.device)
    return _kdot.mttkrp(t.coords[0], t.coords[1], t.coords[2], t.data, c, d, n_rows=t.shape[0])


def sum_dense(a: COO, axes):
    """``a.sum(axis=axes)`` → dense tensor (zero fill assumed), no host read."""
    return _kdot.coo_sum_axes_dense(a.coords, a.data, shape=a.shape, axes=tuple(axes))


def _unravel(lin, shape, dtype):
    coords = []
    rem = lin
    for s in reversed(shape):
        coords.append((rem % s).to(dtype))
        rem = rem // s
    return torch.stack(coords[::-1])


def scale(a: COO, scalar):
    """The stored values times ``scalar`` (a number or a 0-d tensor)."""
    return COO._make(a.coords, a.data * scalar, a.shape, a.fill_value)


def map_data(a: COO, fn):
    """``fn`` applied to the stored values; ``fn`` must map the fill value to
    itself for the result to stay consistent (the caller's contract)."""
    return COO._make(a.coords, fn(a.data), a.shape, a.fill_value)


def add_same_pattern(a: COO, b: COO):
    """``a + b`` for operands on one coordinate pattern (results of
    ``sddmm``/``map_data`` chains over one mask)."""
    return COO._make(a.coords, a.data + b.data, a.shape, a.fill_value)


def mul_same_pattern(a: COO, b: COO):
    """``a * b`` for operands on one coordinate pattern."""
    return COO._make(a.coords, a.data * b.data, a.shape, a.fill_value)


def transpose(a: COO, axes=None):
    """The axes of a canonical COO permuted, with no host read: the
    coordinates' rows permuted and the entries put in the new row-major
    order by one stable sort of the new linear key; the same nnz and
    coordinate dtype."""
    ndim = a.ndim
    if axes is None:
        axes = tuple(range(ndim))[::-1]
    axes = tuple(int(ax) % ndim for ax in axes)
    if sorted(axes) != list(range(ndim)):
        raise ValueError("repeated or incomplete axis in transpose")
    if axes == tuple(range(ndim)):
        return a
    new_shape = tuple(a.shape[ax] for ax in axes)
    coords = take(a.coords, list(axes))
    order = torch.sort(_linearize(coords, new_shape), stable=True).indices
    return COO._make(take(coords, (slice(None), order)), take(a.data, order), new_shape, a.fill_value)


def union_elemwise(func, a: COO, b: COO):
    """Capacity-bounded ``func(a, b)`` over two same-shape COO arrays, no host
    read. Returns ``(out, nnz)``: ``out`` has ``a.nnz + b.nnz`` entries, those
    past the 0-d tensor ``nnz`` being padding (coordinate 0, the result's fill
    value), and the fill value ``func(a.fill_value, b.fill_value)`` (a 0-d
    tensor); nothing is pruned. ``func`` takes tensors (``torch.add``, ...)."""
    if a.shape != b.shape:
        raise ValueError(f"union_elemwise requires equal shapes, got {a.shape} vs {b.shape}")
    size = math.prod(a.shape)
    fv_a = torch.from_numpy(np.array(a.fill_value)).to(a.device)
    fv_b = torch.from_numpy(np.array(b.fill_value)).to(b.device)
    lin_out, data_out, fill_out, nnz_out = coo_elemwise_union(
        _linearize(a.coords, a.shape), a.data, fv_a, _linearize(b.coords, b.shape), b.data, fv_b, func=func, size=size
    )
    lin_safe = torch.where(lin_out >= size, torch.zeros_like(lin_out), lin_out)
    coords = _unravel(lin_safe, a.shape, a.coords.dtype)
    return COO._make(coords, data_out, a.shape, fill_out), nnz_out


def spgemm(a: COO, b: COO, *, product_capacity, out_capacity=None):
    """Capacity-bounded ``a @ b`` of two 2-D zero-fill canonical COO arrays,
    with no read back to the host. ``product_capacity`` must bound the
    number of partial products (``kernels.spgemm.product_count`` counts
    them). Returns ``(out, nnz)``: ``out`` holds ``out_capacity`` entries
    (default ``product_capacity``), those past the 0-d tensor ``nnz`` being
    padding (coordinates 0, value 0); its coordinates take ``a``'s index
    dtype. Computed zeros are kept."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("traceable spgemm supports 2-D operands")
    if out_capacity is None:
        out_capacity = product_capacity
    out_rows, out_cols, out_data, out_nnz = esc_spgemm(
        *a.coords,
        a.data,
        *b.coords,
        b.data,
        k=a.shape[1],
        n=b.shape[1],
        product_capacity=product_capacity,
        out_capacity=out_capacity,
    )
    rows = torch.where(out_rows == np.iinfo(np.int32).max, 0, out_rows)
    coords = torch.stack([rows, out_cols]).to(a.coords.dtype)
    out = COO._make(coords, out_data, (a.shape[0], b.shape[1]), zero_of_dtype(numpy_dtype(out_data.dtype)))
    return out, out_nnz
