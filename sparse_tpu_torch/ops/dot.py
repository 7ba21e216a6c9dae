"""Matmul family, sparse × dense: ``matmul``, ``dot`` and the fused
``matvec_add``, with the semantics of ``sparse_tpu.ops.dot``:

- sparse × dense returns a dense tensor on the sparse operand's device;
- all operands must have zero fill values (``ValueError`` otherwise);
- ``matmul`` warns "Nan will not be propagated in matrix multiplication";
- dtypes promote as NumPy's do (``np.promote_types``).

The sparse operand is a 2-D ``COO`` or ``GCXS`` (``CSR``, ``CSC``); a GCXS
multiplies through the canonical COO it keeps. float32/float64 products run
on the COO's cached row-ELL layout (``kernels.row_ell``: the CUDA kernels on
the GPU); other dtypes take the COO gather + ``index_add_`` path
(``kernels.dot``). Batched (N-D) matmul, 1-D sparse operands, dense × sparse
and sparse × sparse are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._utils import check_zero_fill_value, not_ported, result_dtype, signed_view, torch_dtype
from ..core.base import SparseArray
from ..core.coo import COO
from ..core.gcxs import GCXS
from ..kernels import dot as kdot
from ..kernels.row_ell import row_ell_spmm_program, row_ell_spmv

__all__ = ["matmul", "dot", "matvec_add"]

_ROW_ELL_DTYPES = (torch.float32, torch.float64)


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


def _check_ported(a, b):
    a_sparse, b_sparse = isinstance(a, SparseArray), isinstance(b, SparseArray)
    if a_sparse and b_sparse:
        raise not_ported("sparse × sparse matmul")
    if b_sparse:
        raise not_ported("dense × sparse matmul")
    if not a_sparse:
        raise NotImplementedError("sparse_tpu_torch multiplies sparse arrays; use torch.matmul for dense × dense")
    if a.ndim > 2 or _ndim(b) > 2:
        raise not_ported("batched (N-D) matmul")
    if a.ndim == 1:
        raise not_ported("a product with a 1-D sparse operand")


def matmul(a, b):
    """``a @ b`` for a 2-D sparse ``a`` and a dense 1-D or 2-D ``b``."""
    a, b = _from_scipy_operands(a, b)
    check_zero_fill_value(a, b, func_name="matmul")
    if _ndim(a) == 0 or _ndim(b) == 0:
        raise ValueError("matmul: Input operands do not have enough dimensions")
    _check_ported(a, b)
    b = _dense_operand(b, a.device)
    _warn_nan(a, b, stacklevel=2)
    return _dot(a, b)


def dot(a, b):
    """``np.dot`` semantics (last axis of ``a`` with the second-to-last of
    ``b``), for a 2-D sparse ``a`` and a dense 1-D or 2-D ``b``."""
    a, b = _from_scipy_operands(a, b)
    check_zero_fill_value(a, b, func_name="dot")
    if _ndim(a) == 0 or _ndim(b) == 0:
        raise ValueError("Cannot perform dot product on scalars")
    _check_ported(a, b)
    return _dot(a, b)


def _dot(a, b):
    """The 2-D sparse × dense branch of ``sparse_tpu.ops.dot._dot``."""
    b = _dense_operand(b, a.device)
    if a.shape[1] != b.shape[0]:
        raise ValueError("shape-mismatch for sum")
    return _spmm_dense(a, b)


def _product_coo(a):
    """The COO that a product of ``a`` runs on: ``a`` itself, or the one a
    GCXS keeps (with its cached layouts)."""
    return a._product_coo() if isinstance(a, GCXS) else a


def _spmm_dense(a, b):
    """sparse ``(M, K)`` × dense ``(K,)`` or ``(K, N)`` → dense tensor."""
    a = _product_coo(a)
    dt = result_dtype(a.dtype, b.dtype)
    if dt in _ROW_ELL_DTYPES:
        return _spmm_row_ell(a, b.to(dt))
    coords = a.coords
    data = a.data.to(dt)
    fn = kdot.coo_spmv if b.ndim == 1 else kdot.coo_spmm
    return fn(coords[0], coords[1], data, b.to(dt), n_rows=a.shape[0])


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
            return _spmm_row_ell(_product_coo(a), x.to(dt), y=y.to(dt))
    out = matmul(a, x)
    y = _dense_operand(y, out.device)
    dt = result_dtype(out.dtype, y.dtype)
    return (signed_view(out.to(dt)) + signed_view(y.to(dt))).view(dt)
