"""The parts of ``sparse_tpu.ops.common`` built on elementwise operations and
reductions: the nan-skipping reductions, ``where``, the float predicates,
``equal``, ``result_type``, ``expand_dims``, ``matrix_transpose``,
``broadcast_shapes``, ``moveaxis`` and ``swapaxes``. The rest of the module
(concatenate/stack, kron, triu/tril, argmax, sort, unique, ...) is not
ported yet.
"""

from __future__ import annotations

import operator
import warnings
from functools import reduce as _functools_reduce

import numpy as np
import torch

from .._utils import check_zero_fill_value, index_dtype_for, normalize_axis, numpy_dtype, torch_dtype
from ..core.base import SparseArray
from ..core.coo import COO

__all__ = [
    "broadcast_shapes",
    "equal",
    "expand_dims",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "matrix_transpose",
    "moveaxis",
    "nanmax",
    "nanmean",
    "nanmin",
    "nanprod",
    "nanreduce",
    "nansum",
    "result_type",
    "swapaxes",
    "where",
]


def asCOO(x, name="asCOO", check=True):
    """A sparse array as a COO; a dense array raises (it would densify)."""
    import scipy.sparse

    if check and not isinstance(x, (SparseArray, np.ndarray, torch.Tensor)) and np.ndim(x) == 0:
        return x
    if scipy.sparse.issparse(x):
        return COO.from_scipy_sparse(x)
    if not isinstance(x, SparseArray):
        raise ValueError(f"Performing this operation would produce a dense result: {name}")
    return x if isinstance(x, COO) else x.asformat("coo")


def _validate_coo_input(x):
    import scipy.sparse

    if scipy.sparse.issparse(x):
        x = COO.from_scipy_sparse(x)
    elif not isinstance(x, SparseArray):
        raise ValueError("Input must be an instance of SparseArray")
    return x.asformat("coo") if not isinstance(x, COO) else x


# ---------------------------------------------------------------------------
# nan-skipping reductions
# ---------------------------------------------------------------------------


def nanreduce(x, method, identity=None, axis=None, keepdims=False, **kwargs):
    """``method`` reduced over ``axis`` with every NaN replaced by
    ``identity`` (``method.identity`` by default)."""
    arr = _replace_nan(x, method.identity if identity is None else identity)
    return arr.reduce(method, axis, keepdims, **kwargs)


def _replace_nan(array, value):
    if not np.issubdtype(numpy_dtype(array.dtype), np.floating):
        return array
    return where(np.isnan(array), value, array)


def nansum(x, axis=None, keepdims=False, dtype=None, out=None):
    assert out is None
    x = asCOO(x, name="nansum")
    return nanreduce(x, np.add, None, axis, keepdims, dtype=dtype)


def nanmean(x, axis=None, keepdims=False, dtype=None, out=None):
    assert out is None
    x = asCOO(x, name="nanmean")
    np_dt = numpy_dtype(x.dtype)
    if not (np.issubdtype(np_dt, np.floating) or np.issubdtype(np_dt, np.complexfloating)):
        return x.mean(axis=axis, keepdims=keepdims, dtype=dtype)
    mask = np.isnan(x)
    x2 = where(mask, 0, x)
    nancount = mask.sum(axis=axis, dtype="i8", keepdims=keepdims)
    if axis is None:
        axis = tuple(range(x.ndim))
    elif not isinstance(axis, tuple):
        axis = (axis,)
    den = _functools_reduce(operator.mul, (x.shape[i] for i in axis), 1)
    den -= nancount
    if bool((den.todense() == 0).any()):
        warnings.warn("Mean of empty slice", RuntimeWarning, stacklevel=1)
    num = np.sum(x2, axis=axis, dtype=dtype, keepdims=keepdims)
    with np.errstate(invalid="ignore", divide="ignore"):
        if num.ndim:
            return np.true_divide(num, den, casting="unsafe")
        return (num / den).astype(dtype if dtype is not None else np_dt)


def nanmax(x, axis=None, keepdims=False, dtype=None, out=None):
    """NaN-skipping max: an ``fmax`` reduce; an all-NaN slice stays NaN and
    warns, as in NumPy."""
    assert out is None
    x = asCOO(x, name="nanmax")
    ar = x.reduce(np.fmax, axis=axis, keepdims=keepdims, dtype=dtype)
    _warn_all_nan(ar)
    return ar


def nanmin(x, axis=None, keepdims=False, dtype=None, out=None):
    assert out is None
    x = asCOO(x, name="nanmin")
    ar = x.reduce(np.fmin, axis=axis, keepdims=keepdims, dtype=dtype)
    _warn_all_nan(ar)
    return ar


def _warn_all_nan(res):
    has_nan = False
    if res.data.dtype.is_floating_point:
        has_nan = bool(torch.isnan(res.data).any())
    fv = np.asarray(res.fill_value)
    has_nan = has_nan or (np.issubdtype(fv.dtype, np.floating) and bool(np.isnan(fv)))
    if has_nan:
        warnings.warn("All-NaN slice encountered", RuntimeWarning, stacklevel=2)


def nanprod(x, axis=None, keepdims=False, dtype=None, out=None):
    assert out is None
    x = asCOO(x)
    return nanreduce(x, np.multiply, None, axis, keepdims, dtype=dtype)


# ---------------------------------------------------------------------------
# where and the predicates
# ---------------------------------------------------------------------------


def where(condition, x=None, y=None):
    """``np.where``: the ternary select, or with ``condition`` alone (zero
    fill) the coordinates of its stored entries, one tensor an axis."""
    from .elemwise import elemwise

    x_given = x is not None
    y_given = y is not None
    if not (x_given or y_given):
        check_zero_fill_value(condition)
        condition = asCOO(condition, name=str(np.where))
        return tuple(condition.coords)
    if x_given != y_given:
        raise ValueError("either both or neither of x and y should be given")
    return elemwise(np.where, condition, x, y)


def _no_complex(x):
    if x.dtype.is_complex:
        raise TypeError(f"This operation is not supported for {numpy_dtype(x.dtype)} values because it would be ambiguous.")


def isposinf(x, out=None):
    from .elemwise import elemwise

    _no_complex(x)
    return elemwise(torch.isposinf, x)


def isneginf(x, out=None):
    from .elemwise import elemwise

    _no_complex(x)
    return elemwise(torch.isneginf, x)


def isinf(x, /):
    from .elemwise import elemwise

    return elemwise(np.isinf, x)


def isnan(x, /):
    from .elemwise import elemwise

    return elemwise(np.isnan, x)


def isfinite(x, /):
    from .elemwise import elemwise

    return elemwise(np.isfinite, x)


def equal(x1, x2, /):
    from .elemwise import elemwise

    return elemwise(np.equal, x1, x2)


# ---------------------------------------------------------------------------
# dtypes and axes
# ---------------------------------------------------------------------------


def result_type(*arrays_and_dtypes):
    """``np.result_type`` with sparse arrays and tensors taken by their
    dtype."""
    args = []
    for x in arrays_and_dtypes:
        if isinstance(x, (SparseArray, torch.Tensor)):
            args.append(numpy_dtype(x.dtype))
        elif isinstance(x, torch.dtype):
            args.append(numpy_dtype(x))
        else:
            args.append(x)
    return np.result_type(*args)


def expand_dims(x, /, *, axis=0):
    x = _validate_coo_input(x)
    axis = normalize_axis(axis, x.ndim + 1)
    shape = x.shape[:axis] + (1,) + x.shape[axis:]
    zeros = torch.zeros((1, x.nnz), dtype=x.coords.dtype, device=x.coords.device)
    coords = torch.cat([x.coords[:axis], zeros, x.coords[axis:]])
    dt = torch_dtype(index_dtype_for(max(shape)))
    return COO._make(coords.to(dt), x.data, shape, x.fill_value)


def matrix_transpose(x, /):
    if hasattr(x, "ndim") and x.ndim < 2:
        raise ValueError("`x.ndim >= 2` must hold.")
    if isinstance(x, SparseArray):
        return x.mT
    if isinstance(x, torch.Tensor):
        return x.transpose(-1, -2)
    return np.swapaxes(x, -1, -2)


def broadcast_shapes(*shapes):
    return np.broadcast_shapes(*shapes)


def moveaxis(a, source, destination):
    if not hasattr(source, "__iter__"):
        source = (source,)
    if not hasattr(destination, "__iter__"):
        destination = (destination,)
    source = normalize_axis(tuple(source), a.ndim)
    destination = normalize_axis(tuple(destination), a.ndim)
    if len(source) != len(destination):
        raise ValueError("`source` and `destination` arguments must have the same number of elements")
    order = [n for n in range(a.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return a.transpose(tuple(order))


def swapaxes(a, axis1, axis2):
    return a.swapaxes(axis1, axis2)
