"""Matmul family: ``tensordot``, ``matmul``, ``dot``, ``vecdot``, ``sddmm``
and the fused ``matvec_add``, with the semantics of ``sparse_tpu.ops.dot``:

- a product with one dense operand returns a dense tensor on the sparse
  operand's device (``return_type`` may ask for a COO or GCXS);
- a product of two sparse operands (SpGEMM) returns a COO when both are
  COO and a GCXS compressed like the first GCXS operand otherwise
  (``return_type`` ``np.ndarray``/``torch.Tensor`` gives a dense tensor);
- all operands must have zero fill values (``ValueError`` otherwise);
- ``matmul`` warns "Nan will not be propagated in matrix multiplication";
- dtypes promote as NumPy's do (``np.promote_types``).

A 2-D sparse operand is a ``COO`` or ``GCXS`` (``CSR``, ``CSC``); a GCXS
multiplies through the canonical COO it keeps. float32/float64 products on
the GPU run on the COO's cached row-ELL layout (``kernels.row_ell``: the CUDA
kernels); dense × sparse runs there too, as ``(bᵀ @ aᵀ)ᵀ`` on the cached
transpose of ``b``. On the CPU they take the host library (``native.eager``:
the CSR kernels on the COO's kept ``indptr``, the entry loop for sparse
rows, ``dense_spmm_csrt`` on ``b``'s kept CSC), as ``sparse_tpu``'s host
route does. Other dtypes take the COO gather + ``index_add_`` path
(``kernels.dot``). ``sddmm`` runs ``kernels.sddmm`` (K4 on the GPU).
1-D operands, batched (N-D) ``matmul`` and ``tensordot`` reduce to these
2-D products; sparse 1-D · 1-D runs as ``(a * b).sum()``. Sparse × sparse
runs ``kernels.spgemm.spgemm_coords`` on the operands' device (S1, the CUDA
kernel, for float32/float64 on the GPU; else the torch ops: expand, one
stable sort, run sums in a fixed order; computed zeros dropped); two CSR or
two CSC operands build the GCXS result straight from the product's rows. On the
CPU, float32/float64 operands with ``native.eager.NATIVE_MIN_NNZ`` entries
or more between them take the host library's Gustavson SpGEMM
(``spgemm_csr``), with the same bits and the same zero rule.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._utils import (
    check_zero_fill_value,
    equivalent,
    index_dtype_for,
    numpy_dtype,
    result_dtype,
    signed_view,
    take,
    torch_dtype,
    uncompress_indptr,
    wide_index,
    zero_of_dtype,
)
from .. import native
from ..core.base import SparseArray
from ..core.coo import COO
from ..core.gcxs import GCXS
from ..kernels import dot as kdot
from ..kernels import spgemm as kspgemm
from ..kernels.row_ell import row_ell_spmm_program, row_ell_spmv
from ..native import eager as native_eager

__all__ = ["tensordot", "matmul", "dot", "vecdot", "matvec_add", "sddmm"]

_ROW_ELL_DTYPES = (torch.float32, torch.float64)
_DENSE_TYPES = (np.ndarray, torch.Tensor)


def _from_scipy_operands(a, b):
    """Scipy sparse operands become COO arrays on the other operand's device."""
    import scipy.sparse

    def device_of(x):
        return x.device if isinstance(x, (SparseArray, torch.Tensor)) else None

    if scipy.sparse.issparse(a):
        a = COO.from_scipy_sparse(a, device=device_of(b))
    if scipy.sparse.issparse(b):
        b = COO.from_scipy_sparse(b, device=device_of(a))
    return a, b


def _ndim(x):
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


def _dense_operand(x, device):
    """A dense operand as a tensor on ``device``: NumPy input is copied
    there; a tensor on another device raises."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"dense operand is on {x.device} but the sparse array is on {device}; move one of them first"
            )
        return x
    x = np.asarray(x)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch_dtype(x.dtype), device=device)


def _operands(a, b):
    """``(a, b)`` with the dense one as a tensor on the sparse one's device;
    two sparse operands on two devices raise. Two dense operands raise: the
    package multiplies sparse arrays."""
    if isinstance(a, SparseArray):
        if isinstance(b, SparseArray):
            if a.device != b.device:
                raise ValueError(f"sparse operands lie on different devices, {a.device} and {b.device}; move one of them first")
            return a, b
        return a, _dense_operand(b, a.device)
    if isinstance(b, SparseArray):
        return _dense_operand(a, b.device), b
    raise NotImplementedError("sparse_tpu_torch multiplies sparse arrays; use torch.matmul for dense × dense")


def _has_nan(x):
    if isinstance(x, SparseArray):
        data = x.data
        # memoized per (instance, data buffer): one device read per buffer
        memo = getattr(x, "_nan_memo", None)
        if memo is not None and memo[0] is data:
            return memo[1]
        res = bool(data.numel() and data.dtype.is_floating_point and torch.isnan(data).any())
        x._nan_memo = (data, res)
        return res
    if isinstance(x, torch.Tensor):
        return bool(x.numel() and x.dtype.is_floating_point and torch.isnan(x).any())
    x = np.asarray(x)
    return bool(x.size and np.issubdtype(x.dtype, np.floating) and np.isnan(np.min(x)))


def _warn_nan(*operands, stacklevel):
    if any(_has_nan(x) for x in operands):
        warnings.warn("Nan will not be propagated in matrix multiplication", RuntimeWarning, stacklevel=stacklevel + 1)


# ---------------------------------------------------------------------------
# tensordot
# ---------------------------------------------------------------------------


def tensordot(a, b, axes=2, *, return_type=None):
    """Tensor contraction over the given axes (NumPy semantics), with one
    sparse operand: the contracted axes moved last in ``a`` and first in
    ``b``, both reshaped to 2-D, multiplied and reshaped back.
    ``return_type`` ``np.ndarray`` (or ``torch.Tensor``) gives a dense
    tensor, ``COO``/``GCXS`` a sparse array; by default dense."""
    a, b = _from_scipy_operands(a, b)
    check_zero_fill_value(a, b, func_name="tensordot")

    if np.isscalar(a) or np.isscalar(b):
        raise ValueError("Cannot perform tensordot on scalars")
    a, b = _operands(a, b)

    try:
        iter(axes)
    except TypeError:
        axes_a = list(range(-axes, 0))
        axes_b = list(range(axes))
    else:
        axes_a, axes_b = axes
    try:
        na = len(axes_a)
        axes_a = list(axes_a)
    except TypeError:
        axes_a = [axes_a]
        na = 1
    try:
        nb = len(axes_b)
        axes_b = list(axes_b)
    except TypeError:
        axes_b = [axes_b]
        nb = 1

    as_, nda = tuple(a.shape), a.ndim
    bs, ndb = tuple(b.shape), b.ndim
    if nda == 0 or ndb == 0:
        raise ValueError(f"Input {int(nda == 0)} operand does not have enough dimensions")
    equal = na == nb
    if equal:
        for k in range(na):
            if as_[axes_a[k]] != bs[axes_b[k]]:
                equal = False
                break
            if axes_a[k] < 0:
                axes_a[k] += nda
            if axes_b[k] < 0:
                axes_b[k] += ndb
    if not equal:
        raise ValueError("shape-mismatch for sum")

    notin = [k for k in range(nda) if k not in axes_a]
    newaxes_a = notin + axes_a
    olda = [as_[axis] for axis in notin]
    notin = [k for k in range(ndb) if k not in axes_b]
    newaxes_b = axes_b + notin
    oldb = [bs[axis] for axis in notin]
    red = int(np.prod([as_[axis] for axis in axes_a], dtype=np.float64))

    if red == 0 or 0 in olda or 0 in oldb:
        return _empty_result(a, b, olda, oldb, return_type)

    at = _to_2d(a, newaxes_a, _concrete_2d_shape(as_, newaxes_a, nda - na))
    bt = _to_2d(b, newaxes_b, _concrete_2d_shape_b(bs, newaxes_b, nb))
    res = _dot(at, bt, return_type)
    return res.reshape(tuple(olda + oldb))


def _to_2d(x, axes, shape):
    if isinstance(x, SparseArray):
        return x.transpose(tuple(axes)).reshape(shape)
    return x.permute(axes).reshape(shape)


def _concrete_2d_shape(shape, newaxes, n_keep):
    keep = int(np.prod([shape[ax] for ax in newaxes[:n_keep]], dtype=np.float64))
    red = int(np.prod([shape[ax] for ax in newaxes[n_keep:]], dtype=np.float64))
    return (keep, red)


def _concrete_2d_shape_b(shape, newaxes, n_red):
    red = int(np.prod([shape[ax] for ax in newaxes[:n_red]], dtype=np.float64))
    keep = int(np.prod([shape[ax] for ax in newaxes[n_red:]], dtype=np.float64))
    return (red, keep)


def _empty_result(a, b, olda, oldb, return_type):
    shape = tuple(olda + oldb)
    dt = result_dtype(a.dtype, b.dtype)
    device = a.device if isinstance(a, SparseArray) else b.device
    both_sparse = isinstance(a, SparseArray) and isinstance(b, SparseArray)
    if return_type in _DENSE_TYPES or (return_type is None and not both_sparse):
        return torch.zeros(shape, dtype=dt, device=device)
    return COO._make(
        torch.empty((len(shape), 0), dtype=torch_dtype(index_dtype_for(max(shape, default=0))), device=device),
        torch.empty((0,), dtype=dt, device=device),
        shape,
        zero_of_dtype(numpy_dtype(dt)),
    )


# ---------------------------------------------------------------------------
# matmul, dot, vecdot
# ---------------------------------------------------------------------------


def matmul(a, b):
    """``a @ b`` with NumPy's matmul semantics (1-D promotion, broadcast
    batch axes), one operand sparse."""
    a, b = _from_scipy_operands(a, b)
    check_zero_fill_value(a, b, func_name="matmul")
    if _ndim(a) == 0 or _ndim(b) == 0:
        raise ValueError("matmul: Input operands do not have enough dimensions")
    a, b = _operands(a, b)
    _warn_nan(a, b, stacklevel=2)

    if a.ndim <= 2 and b.ndim <= 2:
        return dot(a, b)

    # batched: broadcast the leading axes, one product a batch
    a_orig, b_orig = a, b
    if a.ndim == 1:
        a = a.reshape((1,) + tuple(a.shape))
    if b.ndim == 1:
        b = b.reshape(tuple(b.shape) + (1,))
    batch = np.broadcast_shapes(tuple(a.shape[:-2]), tuple(b.shape[:-2]))
    a = _broadcast_batched(a, batch + tuple(a.shape[-2:]))
    b = _broadcast_batched(b, batch + tuple(b.shape[-2:]))
    res = [matmul(x, y) for x, y in zip(_leading_slices(a), _leading_slices(b))]
    if all(isinstance(r, torch.Tensor) for r in res):
        out = torch.stack(res)
    else:
        from .common import stack

        # ``sparse_tpu`` takes GCXS batches of a GCXS operand that needed no
        # broadcast (a broadcast gives a COO), whose products are GCXS: the
        # stack is then a GCXS too
        if isinstance(a, GCXS) or isinstance(b, GCXS):
            res = [r.asformat("gcxs") for r in res]
        out = stack(res)
    if a_orig.ndim == 1:
        out = _drop_axis(out, out.ndim - 2)
    if b_orig.ndim == 1:
        out = _drop_axis(out, out.ndim - 1)
    return out


def _drop_axis(x, axis):
    """``x`` without its length-1 ``axis`` (``x[..., 0, :]``, ``x[..., 0]``)."""
    if isinstance(x, torch.Tensor):
        return x.select(axis, 0)
    return x.reshape(x.shape[:axis] + x.shape[axis + 1 :])


def _broadcast_batched(x, shape):
    if tuple(x.shape) == shape:
        return x
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x, shape)
    from .elemwise import broadcast_to

    return broadcast_to(x, shape)


def _leading_slices(x):
    """``[x[0], x[1], ...]`` along the first axis. A sparse array gives
    canonical COOs: its canonical entries are sorted by the first axis, so
    ``x[i]`` is the run found by one ``searchsorted`` (one host read for all
    of them), its coordinates those of the other axes."""
    if isinstance(x, torch.Tensor):
        return list(x.unbind(0))
    x = x if isinstance(x, COO) else x.tocoo()
    n = x.shape[0]
    first = x.coords[0].long()
    offsets = torch.searchsorted(first, torch.arange(n + 1, device=first.device)).tolist()
    shape = x.shape[1:]
    return [
        COO._make(x.coords[1:, lo:hi], x.data[lo:hi], shape, x.fill_value) for lo, hi in zip(offsets, offsets[1:])
    ]


def dot(a, b):
    """``np.dot`` semantics (the last axis of ``a`` with the second-to-last of
    ``b``, or the last of a 1-D ``b``), one operand sparse; two 1-D operands
    give ``(a * b).sum()`` as a 0-d tensor on the device."""
    a, b = _from_scipy_operands(a, b)
    check_zero_fill_value(a, b, func_name="dot")
    if _ndim(a) == 0 or _ndim(b) == 0:
        raise ValueError("Cannot perform dot product on scalars")
    a, b = _operands(a, b)

    if a.ndim == 1 and b.ndim == 1:
        res = (a * b).sum() if isinstance(a, SparseArray) else (b * a).sum()
        return res.todense()[()] if isinstance(res, SparseArray) else res

    # 2-D fast paths: straight to the 2-D core
    if a.ndim == 2 and b.ndim in (1, 2) and a.shape[1] == b.shape[0]:
        if isinstance(a, SparseArray) and not isinstance(b, SparseArray):
            return _dot(a, b)
        if isinstance(b, SparseArray) and not isinstance(a, SparseArray) and b.ndim == 2:
            return _dot(a, b)

    return tensordot(a, b, axes=(-1, -1 if b.ndim == 1 else -2))


def vecdot(x1, x2, /, *, axis=-1):
    """Conjugating vector dot product along ``axis`` (Array API):
    ``sum(conj(x1) * x2, axis)`` in the promoted dtype, on the element-wise
    engine (sparse · sparse included)."""
    ndmin = min(x1.ndim, x2.ndim)
    if not (-ndmin <= axis < ndmin) or x1.shape[axis] != x2.shape[axis]:
        raise ValueError("Shapes must match along `axis`.")
    dt = numpy_dtype(result_dtype(x1.dtype, x2.dtype))
    if np.issubdtype(numpy_dtype(x1.dtype), np.complexfloating):
        x1 = np.conjugate(x1) if isinstance(x1, np.ndarray) else x1.conj()
    prod = x1 * x2
    if isinstance(prod, torch.Tensor):
        return prod.sum(dim=axis, dtype=torch_dtype(dt))
    return prod.sum(axis=axis, dtype=dt)


# ---------------------------------------------------------------------------
# The 2-D core
# ---------------------------------------------------------------------------


def _coo_of_dense(t):
    """A dense tensor as a canonical COO on its device, every entry that is
    not bitwise zero stored (``COO.from_numpy``'s rule)."""
    mask = ~equivalent(t, zero_of_dtype(numpy_dtype(t.dtype)))
    return COO(torch.nonzero(mask).T, take(t, mask), shape=tuple(t.shape), has_duplicates=False, sorted=True)


def _dot(a, b, return_type=None):
    """The 2-D core of ``sparse_tpu.ops.dot._dot``: sparse ``(M, K)`` ×
    dense ``(K,)``/``(K, N)``, dense ``(M, K)`` × sparse ``(K, N)``, or
    sparse × sparse, shapes already matched and a dense operand a tensor on
    the sparse one's device. One dense operand gives a dense tensor, or what
    ``return_type`` names; two sparse ones give what :func:`_sparse_dot`
    gives."""
    if isinstance(a, SparseArray) and isinstance(b, SparseArray):
        return _sparse_dot(a, b, return_type)
    res = _spmm_dense(a, b) if isinstance(a, SparseArray) else _dense_spmm(a, b)
    if return_type is COO:
        return _coo_of_dense(res)
    if return_type is GCXS:
        return _coo_of_dense(res).asformat("gcxs")
    return res


def _sparse_dot(a, b, return_type):
    """sparse × sparse (SpGEMM), ``sparse_tpu``'s output rule: all-COO
    operands give a COO; an operand that is a GCXS gives a GCXS compressed
    like the first GCXS operand (two CSR or two CSC operands straight from
    the product's rows); ``return_type`` ``COO`` gives a COO and
    ``np.ndarray``/``torch.Tensor`` a dense tensor."""
    dense = return_type in _DENSE_TYPES
    if return_type is not COO and not dense:
        direct = _spgemm_gcxs_direct(a, b)
        if direct is not None:
            return direct
    res = _spgemm(_product_coo(a), _product_coo(b))
    if dense:
        return res.todense()
    if (isinstance(a, GCXS) or isinstance(b, GCXS)) and return_type is not COO and res.ndim >= 2:
        ca = a.compressed_axes if isinstance(a, GCXS) else b.compressed_axes
        ca = tuple(ax for ax in ca if ax < res.ndim) or (0,)
        return res.asformat("gcxs", compressed_axes=ca)
    return res


def _spgemm(a, b):
    """COO ``(M, K)`` × COO ``(K, N)`` → canonical COO (``kernels.spgemm``),
    its coordinates int32/int64 for ``max(M, N)``; 1-D operands as a row or
    a column."""
    if a.ndim == 1:
        res = _spgemm(a.reshape((1, -1)), b)
        return res.reshape(res.shape[1:]) if res.ndim == 2 else res
    if b.ndim == 1:
        res = _spgemm(a, b.reshape((-1, 1)))
        return res.reshape(res.shape[:-1])
    (m, k), n = a.shape, b.shape[1]
    dt = result_dtype(a.dtype, b.dtype)
    idx = torch_dtype(index_dtype_for(max(m, n)))
    if _host_spgemm(a, b, dt):
        indptr, cols, vals = native_eager.spgemm_csr(
            _host_indptr(a), a.coords[1], a.data.to(dt), _host_indptr(b), b.coords[1], b.data.to(dt), m, n
        )
        rows, cols, vals = _drop_zero_sums(native_eager.uncompress_indptr(indptr, m), cols, vals)
        coords = torch.stack([rows, cols]).to(idx)
    else:
        coords, vals = kspgemm.spgemm_coords(*a.coords, a.data, *b.coords, b.data, m=m, k=k, n=n, index_dtype=idx)
    return COO._make(coords, vals, (m, n), zero_of_dtype(numpy_dtype(vals.dtype)))


def _host_spgemm(a, b, dt):
    """Whether a product of two sparse operands computed in ``dt`` takes the
    host library (``spgemm_csr``): CPU float32/float64 with
    ``NATIVE_MIN_NNZ`` entries or more between them, as in ``sparse_tpu``."""
    return native.host_route(a.device, dt, a.nnz + b.nnz, native_eager.NATIVE_MIN_NNZ)


def _drop_zero_sums(rows, cols, vals):
    """The entries whose sum is not zero (either sign), as
    ``kernels.spgemm.spgemm`` keeps them."""
    keep = vals != 0
    if bool(keep.all()):
        return rows, cols, vals
    return rows[keep], cols[keep], vals[keep]


def _gcxs_triplet(x):
    """``(rows, cols, data)`` of a 2-D CSR's buffers (a CSC's give those of
    its transpose), in canonical order."""
    return uncompress_indptr(x.indptr, x.nnz), x.indices, x.data


def _spgemm_gcxs_direct(a, b):
    """CSR × CSR → a GCXS compressed on ``(0,)``, or CSC × CSC → one
    compressed on ``(1,)``, built straight from the product's rows (a
    CSC's buffers are the CSR buffers of its transpose, so CSC × CSC runs as
    ``(bᵀ @ aᵀ)ᵀ``); index dtype int32/int64 for ``max(M, N, nnz)``. ``None``
    for any other pair."""
    if not (isinstance(a, GCXS) and isinstance(b, GCXS)):
        return None
    if a.ndim != 2 or b.ndim != 2 or a.compressed_axes != b.compressed_axes or a.compressed_axes not in ((0,), (1,)):
        return None
    csc = a.compressed_axes == (1,)
    m, n = a.shape[0], b.shape[1]
    first, second = (b, a) if csc else (a, b)
    m_out, n_out = (n, m) if csc else (m, n)
    dt = result_dtype(a.dtype, b.dtype)
    if _host_spgemm(a, b, dt):
        a_csr = (first.indptr, first.indices, first.data.to(dt))
        b_csr = (second.indptr, second.indices, second.data.to(dt))
        indptr, cols, vals = native_eager.spgemm_csr(*a_csr, *b_csr, m_out, n_out)
        rows, cols, vals = _drop_zero_sums(native_eager.uncompress_indptr(indptr, m_out), cols, vals)
    else:
        coords, vals = kspgemm.spgemm_coords(
            *_gcxs_triplet(first), *_gcxs_triplet(second), m=m_out, k=a.shape[1], n=n_out,
            index_dtype=torch_dtype(index_dtype_for(max(m, n))),
        )
        rows, cols = coords[0], coords[1].clone()  # the indices without the rows' buffer
    idx = torch_dtype(index_dtype_for(max(m, n, vals.numel())))
    indptr = torch.searchsorted(rows, torch.arange((n if csc else m) + 1, device=rows.device))
    return GCXS._make(
        vals, cols.to(idx), indptr.to(idx), (m, n), (1,) if csc else (0,), zero_of_dtype(numpy_dtype(vals.dtype))
    )


def _product_coo(a):
    """The COO that a product of ``a`` runs on: ``a`` itself, or the one a
    GCXS keeps (with its cached layouts)."""
    return a._product_coo() if isinstance(a, GCXS) else a


def _host_product(a, dt):
    """Whether a product of the 2-D sparse ``a`` computed in ``dt`` takes the
    host library: CPU float32/float64 (``native.host_route``)."""
    return a.ndim == 2 and native.host_route(a.device, dt, a.nnz, native_eager.NATIVE_MIN_PRODUCT_NNZ)


def _host_indptr(a):
    """The int64 row ``indptr`` of a canonical 2-D COO, kept on it."""
    return a._cached_layout("host_indptr", None, lambda: native.build_indptr(a.coords[0], a.shape[0]))


def _host_spmm(a, b, y=None):
    """sparse ``(M, K)`` × dense ``b`` (``+ y``) on the host library, as
    ``sparse_tpu``'s host route: a vector of a matrix with at most one entry
    in two rows by the entry loop (``coo_spmv_entries``), else the CSR
    kernels (``csr_spmm_dense``, ``spmv_add`` seeded with ``y``) on the
    ``indptr`` kept on the COO. A GCXS multiplies through the COO it keeps,
    so a CSR's, a CSC's and the COO's products have the same bits. ``b``
    and ``y`` come in the result dtype."""
    a = _product_coo(a)
    data = a.data.to(b.dtype)
    n_rows = a.shape[0]
    if b.ndim == 1 and a.nnz * 2 <= n_rows:
        return native_eager.coo_spmv_entries(a.coords[0], a.coords[1], data, b, n_rows, y=y)
    indptr, cols = _host_indptr(a), a.coords[1]
    if y is not None:
        return native_eager.spmv_add(indptr, cols, data, b, y, n_rows, a.shape[1], True)
    return native_eager.csr_spmm_dense(indptr, cols, data, b, n_rows)


def _spmm_dense(a, b):
    """sparse ``(M, K)`` × dense ``(K,)`` or ``(K, N)`` → dense tensor."""
    dt = result_dtype(a.dtype, b.dtype)
    if _host_product(a, dt):
        return _host_spmm(a, b.to(dt))
    a = _product_coo(a)
    if dt in _ROW_ELL_DTYPES:
        return _spmm_row_ell(a, b.to(dt))
    coords = a.coords
    data = a.data.to(dt)
    fn = kdot.coo_spmv if b.ndim == 1 else kdot.coo_spmm
    return fn(coords[0], coords[1], data, b.to(dt), n_rows=a.shape[0])


def _transposed(b):
    """``b.T`` of a 2-D COO, cached on ``b`` and rebuilt once ``b``'s buffers
    are replaced; the row-ELL layout of a product is cached on it in turn."""
    return b._cached_layout("transposed", None, lambda: b.T)


def _dense_spmm(a, b):
    """dense ``(M, K)`` × sparse ``(K, N)`` → dense ``(M, N)``.

    float32/float64 run ``(a @ b)ᵀ = bᵀ @ aᵀ`` on the row-ELL layout of
    ``b``'s cached transpose: K2 for a matrix, K1 when ``a`` has one row, as
    ``sparse_tpu`` takes a gather SpMV for ``m_rows == 1``. So a repeated
    ``x @ W`` builds ``Wᵀ``'s layout once. Other dtypes take
    ``kernels.dot.dense_coo_matmul``."""
    b = _product_coo(b)
    dt = result_dtype(a.dtype, b.dtype)
    if _host_product(b, dt):
        return _host_dense_spmm(a.to(dt), b)
    if dt in _ROW_ELL_DTYPES:
        bt = _transposed(b)
        if a.shape[0] == 1:
            return _spmm_row_ell(bt, a[0].to(dt))[None, :]
        return _spmm_row_ell(bt, a.T.to(dt)).T.contiguous()
    return kdot.dense_coo_matmul(a.to(dt), b.coords[0], b.coords[1], b.data.to(dt), n_out_cols=b.shape[1]).contiguous()


def _host_dense_spmm(x, b):
    """dense ``(M, K)`` × the canonical COO ``b (K, N)`` on the host library,
    as ``sparse_tpu``'s host route: with four rows or more (or ``b``'s CSC
    already kept) on ``b``'s CSC buffers (``transpose2d``, kept on ``b``):
    ``dense_spmm_csrt``, or the CSR SpMV for one row; else the CSC scatter
    of ``xᵀ`` over ``b``'s rows. Each output entry sums from 0 in ``b``'s row
    order on every form but the SpMV, so ``x @ b`` has the bits of ``(bᵀ @
    xᵀ)ᵀ``."""
    k, n = b.shape
    kept = b.peek_layout("host_csc", None)
    if b.dtype in native.HOST_DTYPES and (x.shape[0] >= 4 or kept is not None):
        indptr, kids, vals = kept or b._cached_layout("host_csc", None, lambda: _host_csc(b))
        vals = vals.to(x.dtype)
        if x.shape[0] == 1:
            return native_eager.csr_spmm_dense(indptr, kids, vals, x[0], n)[None, :]
        return native_eager.dense_spmm_csrt(indptr, kids, vals, x, n)
    out_t = native_eager.csc_spmm_dense(_host_indptr(b), b.coords[1], b.data.to(x.dtype), x.T, n, k)
    return out_t.T.contiguous()


def _host_csc(b):
    """``(indptr over columns, row ids, values)`` of a canonical 2-D COO: one
    stable counting scatter (``native.eager.transpose2d``)."""
    indptr, _, kids, vals = native_eager.transpose2d(b.coords[0], b.coords[1], b.data, b.shape[1], want_rows=False)
    return indptr, kids, vals


def _spmm_row_ell(a, b, y=None):
    """Products on the array's cached row-ELL layout (built once per data
    buffer, reused by every later product). ``b`` (and ``y``) come in the
    result dtype, so an empty layout promotes like a full one."""
    rell = a.to_row_ell()
    if b.ndim == 1:
        return row_ell_spmv(rell, b, y=y)
    return row_ell_spmm_program(rell)(b)


def matvec_add(a, x, y):
    """Fused ``a @ x + y`` (2-D sparse ``a``, dense 1-D ``x`` and ``y``).

    For float32/float64 one kernel pass seeds each output row with ``y``.
    Semantics are exactly ``matmul(a, x) + y`` (same fill-value errors and
    NaN warning), which is what every other case computes."""
    a, x = _from_scipy_operands(a, x)
    if (
        isinstance(a, (COO, GCXS))
        and a.ndim == 2
        and not isinstance(x, SparseArray)
        and _ndim(x) == 1
        and _ndim(y) == 1
        and a.shape[1] == np.shape(x)[0]
        and np.shape(y)[0] == a.shape[0]
    ):
        x = _dense_operand(x, a.device)
        y = _dense_operand(y, a.device)
        dt = result_dtype(a.dtype, x.dtype, y.dtype)
        if dt in _ROW_ELL_DTYPES:
            check_zero_fill_value(a, x, func_name="matmul")
            _warn_nan(a, x, stacklevel=2)
            if _host_product(a, dt):
                return _host_spmm(a, x.to(dt), y=y.to(dt))
            return _spmm_row_ell(_product_coo(a), x.to(dt), y=y.to(dt))
    out = matmul(a, x)
    y = _dense_operand(y, out.device)
    dt = result_dtype(out.dtype, y.dtype)
    return (signed_view(out.to(dt)) + signed_view(y.to(dt))).view(dt)


# ---------------------------------------------------------------------------
# SDDMM
# ---------------------------------------------------------------------------

def sddmm(s, lhs, rhs):
    """Sampled dense-dense matmul: ``s * (lhs @ rhs)`` evaluated only at the
    stored coordinates of the 2-D sparse sample ``s`` (zero fill; a
    GCXS/CSR/CSC through its COO), never forming ``lhs @ rhs``. Returns a
    ``COO`` with a copy of ``s``'s coordinates, the promoted dtype of the
    three and its zero fill, by ``kernels.sddmm``: K4 for float32/float64
    on the GPU, the plain version in that dtype for the rest (float16 and
    complex too, where ``sparse_tpu`` takes ``np.einsum``). The COO's
    canonical order sorts its rows, so the gradient in ``lhs`` sums them
    without a sort, and the array keeps the orders its gradients sum in
    (``kernels.dot.SddmmPattern``) for the next call."""
    check_zero_fill_value(s, func_name="sddmm")
    s_coo = s if isinstance(s, COO) else s.tocoo()
    lhs = _dense_operand(lhs, s_coo.device)
    rhs = _dense_operand(rhs, s_coo.device)
    dt = result_dtype(s_coo.dtype, lhs.dtype, rhs.dtype)
    rows, cols = wide_index(s_coo.coords[0]), wide_index(s_coo.coords[1])
    sizes = (lhs.shape[0], rhs.shape[1])
    pattern = s_coo._cached_layout(
        "sddmm_pattern", sizes, lambda: kdot.SddmmPattern(rows, cols, *sizes, rows_sorted=True, kept=True)
    )
    vals = kdot._sddmm(rows, cols, s_coo.data.to(dt), lhs.to(dt), rhs.to(dt), pattern=pattern)
    return COO._make(s_coo.coords.clone(), vals, s_coo.shape, zero_of_dtype(numpy_dtype(dt)))
