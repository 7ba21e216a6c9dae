"""The parts of ``sparse_tpu.ops.common`` ported so far: the nan-skipping
reductions, ``where``, the float predicates, ``equal``, ``result_type``,
``expand_dims``, ``matrix_transpose``, ``broadcast_shapes``, ``moveaxis``,
``swapaxes``, ``concatenate``/``concat``/``stack`` (COO on the device;
all-GCXS inputs by ``concatenate_gcxs``/``stack_gcxs``) and
``diagonal``/``diagonalize``. The rest of the module (kron, triu/tril,
argmax, sort, unique, ...) is not ported yet.
"""

from __future__ import annotations

import operator
import warnings
from functools import reduce as _functools_reduce

import numpy as np
import torch

from .._utils import (
    check_consistent_fill_value,
    check_zero_fill_value,
    get_out_dtype,
    index_dtype_for,
    normalize_axis,
    numpy_dtype,
    result_dtype,
    take,
    torch_dtype,
    wide_index,
)
from ..core.base import SparseArray
from ..core.coo import COO

__all__ = [
    "broadcast_shapes",
    "concat",
    "concatenate",
    "diagonal",
    "diagonalize",
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
    "stack",
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


# ---------------------------------------------------------------------------
# concatenate / stack
# ---------------------------------------------------------------------------


def _coo_parts(arrays):
    """The COOs' data in their promoted dtype, their coordinates' promoted
    dtype and their device."""
    devices = {x.device for x in arrays}
    if len(devices) > 1:
        raise ValueError(f"arrays lie on different devices: {sorted(map(str, devices))}")
    dt = result_dtype(*[x.dtype for x in arrays])
    data = torch.cat([x.data.to(dt) for x in arrays])
    in_idx = np.result_type(*[numpy_dtype(x.coords.dtype) for x in arrays])
    return data, in_idx, devices.pop()


def _per_entry(values, arrays, device):
    """``values[i]`` repeated for each entry of ``arrays[i]``, built on
    ``device``."""
    counts = [x.nnz for x in arrays]
    return torch.repeat_interleave(
        torch.as_tensor(values, dtype=torch.int64).to(device), torch.tensor(counts).to(device), output_size=sum(counts)
    )


def concatenate(arrays, axis=0):
    """Join sparse arrays along an existing ``axis`` (``None``: flattened),
    on their device: the coordinates concatenated with each input's offset
    along ``axis``. All-GCXS inputs of two or more dimensions splice their
    storage (``concatenate_gcxs``); 1-D GCXS inputs give a GCXS too."""
    from ..core.gcxs import GCXS, concatenate_gcxs

    arrays = list(arrays)
    all_gcxs = all(isinstance(a, GCXS) for a in arrays)
    if all_gcxs and axis is not None and arrays and arrays[0].ndim >= 2:
        return concatenate_gcxs(arrays, axis=axis)
    arrays = [_validate_coo_input(a) for a in arrays]
    check_consistent_fill_value(arrays)
    if axis is None:
        axis = 0
        arrays = [a.flatten() for a in arrays]
    axis = normalize_axis(axis, arrays[0].ndim)
    shape = list(arrays[0].shape)
    shape[axis] = sum(x.shape[axis] for x in arrays)
    for x in arrays:
        if len(x.shape) != len(shape):
            raise ValueError("all the input array dimensions must match exactly")
        for d in range(len(shape)):
            if d != axis and x.shape[d] != shape[d]:
                raise ValueError("all the input array dimensions except for the concatenation axis must match exactly")

    data, in_idx, device = _coo_parts(arrays)
    idx_dtype = torch_dtype(get_out_dtype(in_idx, max(max(shape), 1)))
    coords = torch.cat([wide_index(x.coords).long() for x in arrays], dim=1)
    offsets = np.cumsum([0] + [x.shape[axis] for x in arrays[:-1]])
    coords[axis] += _per_entry(offsets, arrays, device)
    out = COO(
        coords.to(idx_dtype),
        data,
        shape=tuple(shape),
        has_duplicates=False,
        sorted=(axis == 0),
        fill_value=arrays[0].fill_value,
    )
    return out.asformat("gcxs") if all_gcxs else out


concat = concatenate


def stack(arrays, axis=0):
    """Join same-shape sparse arrays along a new ``axis``, on their device:
    each input's coordinates with its position inserted at ``axis``. All-GCXS
    inputs of two or more dimensions splice their storage (``stack_gcxs``)."""
    from ..core.gcxs import GCXS, stack_gcxs

    arrays = list(arrays)
    all_gcxs = all(isinstance(a, GCXS) for a in arrays)
    if all_gcxs and arrays and arrays[0].ndim >= 2:
        return stack_gcxs(arrays, axis=axis)
    arrays = [_validate_coo_input(a) for a in arrays]
    check_consistent_fill_value(arrays)
    if len({x.shape for x in arrays}) > 1:
        raise ValueError("all input arrays must have the same shape")
    axis = normalize_axis(axis, arrays[0].ndim + 1)
    shape = list(arrays[0].shape)
    shape.insert(axis, len(arrays))

    data, in_idx, device = _coo_parts(arrays)
    idx_dtype = torch_dtype(get_out_dtype(in_idx, max(max(shape), 1)))
    coords = torch.cat([wide_index(x.coords).long() for x in arrays], dim=1)
    new_row = _per_entry(np.arange(len(arrays)), arrays, device)
    coords = torch.cat([coords[:axis], new_row[None, :], coords[axis:]])
    out = COO(
        coords.to(idx_dtype),
        data,
        shape=tuple(shape),
        has_duplicates=False,
        sorted=(axis == 0),
        fill_value=arrays[0].fill_value,
    )
    return out.asformat("gcxs") if all_gcxs else out


# ---------------------------------------------------------------------------
# diagonals
# ---------------------------------------------------------------------------


def diagonal(a, offset=0, axis1=0, axis2=1):
    """The diagonal of ``a`` over ``axis1`` and ``axis2`` (``offset`` above
    it), as a COO whose last axis runs along the diagonal, the other axes
    kept in order: the entries with ``i + offset == j``, selected on the
    device."""
    a = _validate_coo_input(a)
    if a.shape[axis1] != a.shape[axis2]:
        raise ValueError("a.shape[axis1] != a.shape[axis2]")
    diag_axes = [axis for axis in range(a.ndim) if axis not in (axis1, axis2)] + [axis1]
    diag_shape = [a.shape[axis] for axis in diag_axes]
    diag_shape[-1] -= abs(offset)

    wide = wide_index(a.coords)
    idx = torch.nonzero(wide[axis1].long() + offset == wide[axis2]).flatten()
    diag_coords = [take(a.coords[axis], idx) for axis in diag_axes[:-1]]
    diag_coords.append(take(a.coords[axis1] if offset >= 0 else a.coords[axis2], idx))
    return COO(torch.stack(diag_coords), take(a.data, idx), shape=tuple(diag_shape), fill_value=a.fill_value)


def diagonalize(a, axis=0):
    """``a`` with a new last axis that repeats ``axis``: entry ``x[..., i,
    ..., i]`` of the result holds ``a[..., i, ...]``, the rest the fill."""
    if isinstance(a, SparseArray):
        a = a.asformat("coo")
    elif isinstance(a, torch.Tensor):
        a = COO.from_numpy(a.cpu().numpy(), device=a.device)
    else:
        a = COO.from_numpy(np.asarray(a))
    diag_shape = a.shape + (a.shape[axis],)
    diag_coords = torch.cat([a.coords, a.coords[axis][None, :]])
    return COO(diag_coords, a.data, shape=diag_shape, fill_value=a.fill_value)
