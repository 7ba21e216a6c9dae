"""The namespace's array functions (``sparse_tpu.ops.common``), as torch ops
over the stored entries on the array's device: the nan-skipping reductions,
``where``, the float predicates, ``equal``, ``result_type``, ``expand_dims``,
``matrix_transpose``, ``broadcast_shapes``, ``moveaxis``, ``swapaxes``,
``concatenate``/``concat``/``stack`` (all-GCXS inputs by
``concatenate_gcxs``/``stack_gcxs``), ``diagonal``/``diagonalize``, ``kron``,
``triu``/``tril``, ``nonzero``/``argwhere``, ``argmax``/``argmin``,
``roll``, ``flip``, ``unique_counts``/``unique_values``, ``sort``,
``take``, ``pad``, ``outer``, ``repeat``, ``tile``, ``unstack``, ``diff``,
``interp``, ``asCOO``/``as_coo``, ``asnumpy`` (an explicit copy to the
host), ``can_cast`` and ``isdtype``. Nothing here runs through NumPy on the
host but ``asnumpy`` and the dtype predicates.
"""

from __future__ import annotations

import operator
import warnings
from collections import namedtuple
from collections.abc import Iterable
from functools import reduce as _functools_reduce

import numpy as np
import torch

from .._utils import (
    can_store,
    check_consistent_fill_value,
    check_zero_fill_value,
    coords_dtype,
    equivalent,
    full,
    get_out_dtype,
    index_dtype_for,
    normalize_axis,
    numpy_dtype,
    result_dtype,
    torch_dtype,
    wide_index,
    zero_of_dtype,
)
from .._utils import take as _gather
from ..core.base import SparseArray
from ..core.coo import COO

__all__ = [
    "argmax",
    "argmin",
    "argwhere",
    "asCOO",
    "as_coo",
    "asnumpy",
    "broadcast_shapes",
    "can_cast",
    "concat",
    "concatenate",
    "diagonal",
    "diagonalize",
    "diff",
    "equal",
    "expand_dims",
    "flip",
    "interp",
    "isdtype",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "kron",
    "matrix_transpose",
    "moveaxis",
    "nanmax",
    "nanmean",
    "nanmin",
    "nanprod",
    "nanreduce",
    "nansum",
    "nonzero",
    "outer",
    "pad",
    "repeat",
    "result_type",
    "roll",
    "sort",
    "stack",
    "swapaxes",
    "take",
    "tile",
    "tril",
    "triu",
    "unique_counts",
    "unique_values",
    "unstack",
    "where",
]


def asCOO(x, name="asCOO", check=True):
    """A sparse array as a COO; a dense array raises (it would densify)
    unless ``check=False``, which stores it (a tensor on its device)."""
    import scipy.sparse

    if check and not isinstance(x, (SparseArray, np.ndarray, torch.Tensor)) and np.ndim(x) == 0:
        return x
    if isinstance(x, (np.ndarray, torch.Tensor)) and check:
        raise ValueError(f"Performing this operation would produce a dense result: {name}")
    if scipy.sparse.issparse(x):
        return COO.from_scipy_sparse(x)
    if not isinstance(x, SparseArray):
        if check:
            raise ValueError(f"Performing this operation would produce a dense result: {name}")
        return COO.from_numpy(x if isinstance(x, torch.Tensor) else np.asarray(x))
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
    diag_coords = [_gather(a.coords[axis], idx) for axis in diag_axes[:-1]]
    diag_coords.append(_gather(a.coords[axis1] if offset >= 0 else a.coords[axis2], idx))
    return COO(torch.stack(diag_coords), _gather(a.data, idx), shape=tuple(diag_shape), fill_value=a.fill_value)


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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _canonical(coords, data, shape, fill_value, given_dtype, sort=True):
    """A COO of unique entries at the int64 coordinates ``coords`` (ndim,
    nnz), as ``sparse_tpu``'s constructor builds it from coordinates of
    ``given_dtype``: its index dtype (``coords_dtype``) and canonical order
    (one stable sort of the linear key when ``sort``), with no read back."""
    from ..core.coo import _linearize

    shape = tuple(int(s) for s in shape)
    dt = torch_dtype(coords_dtype(given_dtype, max(shape) if shape else 0))
    if sort and data.numel() > 1:
        order = torch.sort(_linearize(coords, shape), stable=True).indices
        coords, data = coords[:, order], _gather(data, order)
    return COO._make(coords.to(dt), data, shape, fill_value)


def _comparable(t):
    """``t`` in a dtype torch compares on every device, order kept (bool as
    uint8, wide unsigned types as signed ones)."""
    from ..kernels.segment import _ordered

    return t if (t.dtype.is_floating_point or t.dtype.is_complex) else _ordered(t)


def _scalar_of(value, dtype, device):
    """The NumPy scalar ``value`` as a 0-d tensor of ``dtype`` on ``device``."""
    return full((), np.asarray(value, dtype=numpy_dtype(dtype))[()], dtype, device)


def _sparse_device(*args):
    return next((a.device for a in args if isinstance(a, SparseArray)), None)


def _run_starts(rows):
    """The runs of equal consecutive values of ``rows``: each run's value,
    length, start, and the run of every element."""
    vals, counts = torch.unique_consecutive(rows, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    run = torch.repeat_interleave(torch.arange(vals.numel(), device=rows.device), counts, output_size=rows.numel())
    return vals, counts, starts, run


def _run_min(values, run, n_runs, init):
    """The minimum of the int64 ``values`` over each run."""
    out = torch.full((n_runs,), init, dtype=torch.int64, device=values.device)
    return out.scatter_reduce_(0, run, values, "amin")


# ---------------------------------------------------------------------------
# combining, triangles, coordinates
# ---------------------------------------------------------------------------


def kron(a, b):
    """The Kronecker product: the cartesian product of the operands' stored
    entries (zero fill values; a dense operand is stored first)."""
    from .elemwise import apply_ufunc

    import scipy.sparse

    check_zero_fill_value(a, b, func_name="kron")
    a_sparse = isinstance(a, SparseArray) or scipy.sparse.issparse(a)
    b_sparse = isinstance(b, SparseArray) or scipy.sparse.issparse(b)
    if not (a_sparse or b_sparse):
        raise ValueError("Performing this operation would produce a dense result: kron")
    if np.ndim(a) == 0 or np.ndim(b) == 0:
        # against a scalar, plain scaling
        return a * b
    device = _sparse_device(a, b)
    a, b = _coo_on(a, device), _coo_on(b, device)

    ndim = max(a.ndim, b.ndim)
    a = a.reshape((1,) * (ndim - a.ndim) + a.shape)
    b = b.reshape((1,) * (ndim - b.ndim) + b.shape)
    shape = tuple(a.shape[d] * b.shape[d] for d in range(ndim))
    ac, bc = wide_index(a.coords).long(), wide_index(b.coords).long()
    b_ext = torch.tensor(b.shape, dtype=torch.int64, device=ac.device)[:, None, None]
    coords = (ac[:, :, None] * b_ext + bc[:, None, :]).reshape(ndim, -1)
    data = apply_ufunc(np.multiply, a.data[:, None], b.data[None, :]).reshape(-1)
    return _canonical(coords, data, shape, zero_of_dtype(data.dtype), np.int64)


def _coo_on(x, device):
    """A sparse, scipy or dense operand as a COO on ``device`` (a tensor on
    another device raises)."""
    import scipy.sparse

    if isinstance(x, SparseArray):
        return x if isinstance(x, COO) else x.asformat("coo")
    if scipy.sparse.issparse(x):
        return COO.from_scipy_sparse(x, device=device)
    return COO.from_numpy(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)


def _triangle(x, k, upper, name):
    check_zero_fill_value(x, func_name=name)
    if not x.ndim >= 2:
        raise NotImplementedError(f"sparse.{name} is not implemented for scalars or 1-D arrays.")
    x = _validate_coo_input(x)
    c = wide_index(x.coords)
    i, j = c[-2].long() + k, c[-1].long()
    keep = torch.nonzero(i <= j if upper else i >= j).flatten()
    dt = torch_dtype(coords_dtype(numpy_dtype(x.coords.dtype), max(x.shape)))
    coords = _gather(x.coords, (slice(None), keep)).to(dt)
    return COO._make(coords, _gather(x.data, keep), x.shape, zero_of_dtype(x.dtype))


def triu(x, k=0):
    """The upper triangle (entries with ``j - i >= k``) of the last two axes."""
    return _triangle(x, k, True, "triu")


def tril(x, k=0):
    """The lower triangle (entries with ``j - i <= k``) of the last two axes."""
    return _triangle(x, k, False, "tril")


def nonzero(x):
    """The coordinates of the stored non-zero entries (zero fill), one tensor
    an axis in the coordinates' dtype."""
    from .._utils import signed_view

    check_zero_fill_value(x, func_name="nonzero")
    x = _validate_coo_input(x)
    keep = torch.nonzero(signed_view(x.data) != 0).flatten()
    return tuple(_gather(x.coords, (slice(None), keep)))


def argwhere(a):
    """``nonzero`` as one (nnz, ndim) tensor."""
    return torch.stack(list(a.nonzero()), dim=1)


# ---------------------------------------------------------------------------
# argmax / argmin
# ---------------------------------------------------------------------------


def argmax(x, /, *, axis=None, keepdims=False):
    return _arg_minmax_common(x, axis=axis, keepdims=keepdims, mode="max")


def argmin(x, /, *, axis=None, keepdims=False):
    return _arg_minmax_common(x, axis=axis, keepdims=keepdims, mode="min")


def _arg_minmax_common(x, axis, keepdims, mode):
    """The first position of the extremum along ``axis``, the fill value's
    implicit positions included, as a COO of int64 positions. A NaN wins (its
    first position); the fill value sits at the first unoccupied position of
    each line."""
    is_max = mode == "max"
    if not isinstance(axis, (int, type(None))):
        raise ValueError(f"axis must be int or None, but it's: {type(axis)}")
    x = _validate_coo_input(x)
    if axis is None:
        flat = x.reshape(-1)
        result = int(_arg_minmax_2d(flat.reshape((1, flat.shape[0])), is_max)[0])
        if keepdims:
            return COO.from_numpy(torch.full((1,) * x.ndim, result, dtype=torch.int64, device=x.device))
        return COO.from_numpy(np.intp(result), device=x.device)
    if not (-x.ndim <= axis < x.ndim):
        raise ValueError(f"`axis={axis}` is out of bounds for array of dimension {x.ndim}.")
    axis = normalize_axis(axis, x.ndim)
    order = tuple(i for i in range(x.ndim) if i != axis) + (axis,)
    neg_shape = tuple(x.shape[i] for i in range(x.ndim) if i != axis)
    keep = int(np.prod(neg_shape, dtype=np.float64)) if neg_shape else 1
    x2 = x.transpose(order).reshape((keep, x.shape[axis]))
    res = _arg_minmax_2d(x2, is_max).reshape(neg_shape)
    if keepdims:
        res = res.unsqueeze(axis)
    return COO.from_numpy(res)


def _arg_minmax_2d(x2, is_max):
    """``arg{max,min}`` over axis 1 of a 2-D COO, dense int64 (keep,) on its
    device: per line the extremum of the stored values (a run reduction),
    its first column, the first unoccupied column (where the fill value
    first sits) and the first NaN."""
    from ..kernels.segment import reduce_runs

    keep, n = x2.shape
    if n == 0:
        raise ValueError("attempt to get argmin/argmax of an empty sequence")
    dev = x2.device
    out = torch.zeros(keep, dtype=torch.int64, device=dev)
    if x2.nnz == 0:
        return out
    rows, cols, data = x2.coords[0].long(), x2.coords[1].long(), x2.data
    grp_rows, counts, starts, run = _run_starts(rows)
    g_n = counts.numel()
    offsets = torch.cat([starts, counts[-1:] + starts[-1:]])
    m = reduce_runs(np.maximum if is_max else np.minimum, data, offsets)
    cd, cm = _comparable(data), _comparable(m)
    # the first stored column holding the extremum
    fa = _run_min(torch.where(cd == cm[run], cols, n), run, g_n, n)
    # the first unoccupied column of each line
    ranks = torch.arange(rows.numel(), device=dev) - starts[run]
    first_gap = torch.minimum(_run_min(torch.where(cols != ranks, ranks, n), run, g_n, n), counts)
    has_gap = counts < n
    fv = _scalar_of(x2.fill_value, data.dtype, dev)
    res = fa
    if data.dtype.is_floating_point:
        fv_nan = bool(np.isnan(x2.fill_value))
        first_nan = _run_min(torch.where(torch.isnan(data), cols, n), run, g_n, n)
        if fv_nan:
            first_nan = torch.minimum(first_nan, torch.where(has_gap, first_gap, n))
        rows_with_nan = first_nan < n
        res = torch.where(rows_with_nan, first_nan, res)
        cm = torch.where(rows_with_nan, torch.full_like(cm, float("nan")), cm)
    cf = _comparable(fv)
    fv_better = has_gap & ((cf > cm) if is_max else (cf < cm))
    fv_tie = has_gap & (cf == cm)
    res = torch.where(fv_better, first_gap, res)
    res = torch.where(fv_tie, torch.minimum(first_gap, res), res)
    out[grp_rows] = res
    # lines with no stored entry keep position 0 (all fill)
    return out


# ---------------------------------------------------------------------------
# structural ops
# ---------------------------------------------------------------------------


def roll(a, shift, axis=None):
    """Entries shifted along ``axis`` with wraparound (``axis=None``: over
    the flattened array), on the device."""
    a = as_coo(a)
    if axis is None:
        return roll(a.reshape((-1,)), shift, 0).reshape(a.shape)
    axis = normalize_axis(axis, a.ndim)
    if not isinstance(axis, tuple):
        axis = (axis,)
    if not isinstance(shift, Iterable):
        shift = (shift,)
    elif np.ndim(shift) > 1:
        raise ValueError("'shift' and 'axis' must be integers or 1D sequences.")
    if len(shift) == 1:
        shift = np.full(len(axis), shift)
    if len(axis) != len(shift):
        raise ValueError("If 'shift' is a 1D sequence, 'axis' must have equal length.")

    # the shifted extents must stay storable in the coordinates' dtype
    # (shape + shift elementwise, as sparse_tpu checks)
    np_idx = numpy_dtype(a.coords.dtype)
    try:
        shifted_extent = int(np.max(np.asarray(a.shape) + np.asarray([int(s) for s in shift])))
    except ValueError:  # len(axis) not broadcastable against ndim
        shifted_extent = max(max(a.shape), max(int(a.shape[ax]) + int(s) for ax, s in zip(axis, shift)))
    if not can_store(np_idx, shifted_extent):
        raise ValueError(
            f"cannot roll with coords.dtype {np_idx} and shift {shift}. Try casting coords to a larger dtype."
        )
    if np.issubdtype(np_idx, np.unsignedinteger) and any(int(s) < 0 for s in shift):
        raise ValueError(f"rolling with coords.dtype as {np_idx} is not safe. Try using a signed dtype.")

    coords = wide_index(a.coords).long().clone()
    for sh, ax in zip(shift, axis):
        if a.shape[ax]:
            coords[ax] = torch.remainder(coords[ax] + int(sh), a.shape[ax])
    return _canonical(coords, a.data.clone(), a.shape, a.fill_value, np_idx)


def flip(x, /, *, axis=None):
    """The entries in reverse order along ``axis`` (all axes by default)."""
    x = _validate_coo_input(x)
    if axis is None:
        axis = range(x.ndim)
    if not isinstance(axis, Iterable):
        axis = (axis,)
    axis = tuple(normalize_axis(ax, x.ndim) for ax in axis)
    coords = wide_index(x.coords).long().clone()
    for ax in axis:
        coords[ax] = x.shape[ax] - 1 - coords[ax]
    return _canonical(coords, x.data, x.shape, x.fill_value, numpy_dtype(x.coords.dtype))


UniqueCountsResult = namedtuple("UniqueCountsResult", ["values", "counts"])


def _sort_values(data):
    """The stable order that sorts ``data`` by value: NaN last, the zeros of
    either sign as equals (so kept in storage order), complex values by their
    real then imaginary part."""
    if data.dtype.is_complex:
        parts = (data.imag, data.real)
    else:
        parts = (data,)
    order = None
    for p in parts:
        if p.dtype.is_floating_point:
            nan = torch.isnan(p)
            key = torch.where(nan, torch.zeros_like(p), p + 0.0)  # -0.0 + 0.0 is +0.0
        else:
            nan, key = None, _comparable(p)
        key = key if order is None else key[order]
        step = torch.sort(key, stable=True).indices
        order = step if order is None else order[step]
        if nan is not None:
            step = torch.sort(nan[order].to(torch.uint8), stable=True).indices
            order = order[step]
    return order


def _unique_runs(data):
    """NumPy's ``np.unique(data, equal_nan=False)`` on the device: each
    distinct value (the first of its run in storage order; every NaN its own)
    and its count."""
    if data.numel() == 0:
        return data, torch.zeros(0, dtype=torch.int64, device=data.device)
    s = _gather(data, _sort_values(data))
    if s.dtype.is_complex:
        same = (s.real[1:] == s.real[:-1]) & (s.imag[1:] == s.imag[:-1])
    else:
        cs = _comparable(s)
        same = cs[1:] == cs[:-1]
    new = torch.ones(s.numel(), dtype=torch.bool, device=s.device)
    new[1:] = ~same
    starts = torch.nonzero(new).flatten()
    ends = torch.cat([starts[1:], torch.full((1,), s.numel(), device=s.device)])
    return _gather(s, starts), ends - starts


def _unique(x, with_counts):
    x = _validate_coo_input(x).flatten()
    values, counts = _unique_runs(x.data)
    fill_count = x.size - x.nnz
    fv = np.asarray(x.fill_value)[()]
    dev = x.device
    if fill_count > 0:
        if isinstance(fv, (np.floating, float)) and np.isnan(fv):
            # every implicit NaN is a value of its own
            values = torch.cat([values, full((fill_count,), fv, x.dtype, dev)])
            counts = torch.cat([counts, torch.ones(fill_count, dtype=torch.int64, device=dev)])
        else:
            values = torch.cat([_scalar_of(fv, x.dtype, dev).reshape(1), values])
            counts = torch.cat([torch.full((1,), fill_count, device=dev), counts])
            order = _sort_values(values)
            values, counts = _gather(values, order), counts[order]
    return UniqueCountsResult(values, counts) if with_counts else values


def unique_counts(x, /):
    """The distinct values and their counts, the fill value's implicit
    positions counted (a NaN fill value is distinct at each position)."""
    return _unique(x, True)


def unique_values(x, /):
    return _unique(x, False)


def sort(x, /, *, axis=-1, descending=False, stable=False):
    """A sorted copy along ``axis``, the fill value's implicit block placed at
    its sorted rank, on the device (two stable sorts: by value, then by line
    and NaN). NaN goes last ascending and first descending; equal values keep
    their storage order."""
    x = _validate_coo_input(x)
    if stable:
        raise ValueError("`stable=True` isn't currently supported.")
    original_ndim = x.ndim
    if x.ndim == 1:
        x = x.reshape((1, x.shape[0]))
        axis = -1
    x = moveaxis(x, source=axis, destination=-1)
    x_shape = x.shape
    n = x_shape[-1]
    x2 = x.reshape((-1, n))

    if x2.nnz:
        rows, data = x2.coords[0].long(), x2.data
        fv = np.asarray(x2.fill_value, dtype=numpy_dtype(data.dtype))[()]
        isfloat = data.dtype.is_floating_point
        nan = torch.isnan(data) if isfloat else torch.zeros_like(rows, dtype=torch.bool)
        if descending:
            if isfloat:
                key = torch.where(nan, torch.zeros_like(data), -data) + 0.0
            elif data.dtype.is_complex:
                key = -data.real.double()
            elif np.issubdtype(numpy_dtype(data.dtype), np.signedinteger):
                key = -data.long()
            else:
                key = -_comparable(data).double() if data.dtype != torch.uint64 else -data.view(torch.int64).double()
            order = torch.sort(key, stable=True).indices
            # NaN first within its line
            line = rows * 2 + (~nan).long()
        else:
            order = _sort_values(data)
            line = rows * 2 + nan.long()
        order = order[torch.sort(line[order], stable=True).indices]
        s_rows, s_data = rows[order], _gather(data, order)

        # each line's run by binary search over every line: nothing read back
        bounds = torch.searchsorted(s_rows, torch.arange(x2.shape[0] + 1, device=rows.device))
        starts = bounds[s_rows]
        m = n - (bounds[s_rows + 1] - starts)  # implicit fill positions of each entry's line
        ranks = torch.arange(s_rows.numel(), device=rows.device) - starts
        fv_is_nan = isfloat and bool(np.isnan(fv))
        cs, cf = _comparable(s_data), _comparable(_scalar_of(fv, data.dtype, rows.device))
        if descending:
            if fv_is_nan:
                above = torch.zeros_like(ranks, dtype=torch.bool)
            else:
                below = cs > cf
                if isfloat:
                    below |= torch.isnan(s_data)
                above = ~below
        elif fv_is_nan:
            above = torch.isnan(s_data)
        else:
            above = ~(cs < cf)
        new_cols = ranks + torch.where(above, m, 0)
        # the entries are in canonical order already: lines ascending, and
        # within a line the stored values below the fill block come first
        x2 = _canonical(torch.stack([s_rows, new_cols]), s_data, x2.shape, fv, np.int64, sort=False)

    x = x2.reshape(x_shape)
    x = moveaxis(x, source=-1, destination=axis)
    if original_ndim == x.ndim:
        return x
    x = x.squeeze()
    if x.shape == ():
        return x.reshape((1,))
    return x


def take(x, indices, /, *, axis=None):
    """``x`` indexed by ``indices`` along ``axis`` (flattened without one)."""
    x = _validate_coo_input(x)
    idx = indices if isinstance(indices, torch.Tensor) else np.asarray(indices)
    if axis is None:
        return x.flatten()[idx]
    axis = normalize_axis(axis, x.ndim)
    return x[(slice(None),) * axis + (idx, Ellipsis)]


def pad(array, pad_width, mode="constant", **kwargs):
    """``array`` padded with its fill value (``constant_values`` must be it)."""
    if not isinstance(array, SparseArray):
        raise NotImplementedError("Input array is not compatible.")
    if mode.lower() != "constant":
        raise NotImplementedError(f"Mode '{mode}' is not yet supported.")
    constant = kwargs.pop("constant_values", zero_of_dtype(array.dtype))
    if not bool(equivalent(np.asarray(constant), np.asarray(array.fill_value)).all()):
        raise ValueError("constant_values can only be equal to fill value.")
    if kwargs:
        raise NotImplementedError("Additional Unknown arguments present.")
    array = array.asformat("coo")
    pad_width = np.broadcast_to(pad_width, (len(array.shape), 2))
    before = torch.as_tensor(np.ascontiguousarray(pad_width[:, 0:1], dtype=np.int64), device=array.device)
    coords = wide_index(array.coords).long() + before
    shape = tuple(int(array.shape[i] + pad_width[i, 0] + pad_width[i, 1]) for i in range(array.ndim))
    return _canonical(coords, array.data, shape, array.fill_value, np.int64, sort=False)


def outer(a, b, out=None):
    """The outer product of the flattened inputs (``tensordot(a, b, 0)``)."""
    from .dot import tensordot

    assert out is None
    a = asCOO(a).flatten() if isinstance(a, SparseArray) else _flat(a)
    b = asCOO(b).flatten() if isinstance(b, SparseArray) else _flat(b)
    return tensordot(a, b, axes=0)


def _flat(x):
    return x.reshape(-1) if isinstance(x, torch.Tensor) else np.asarray(x).reshape(-1)


def asnumpy(a, dtype=None, order=None):
    """A dense NumPy array of ``a``: an explicit copy to the host."""
    if isinstance(a, SparseArray):
        a = a.todense()
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype, order=order)


def _np_dtype_arg(x):
    if isinstance(x, torch.dtype):
        return numpy_dtype(x)
    if not isinstance(x, (np.dtype, str, type)) and hasattr(x, "dtype"):
        return numpy_dtype(x.dtype)
    return x


def can_cast(from_, to, /, *, casting="safe"):
    """``np.can_cast`` with arrays and tensors taken by their dtype and torch
    dtypes by their NumPy counterparts."""
    return np.can_cast(np.dtype(_np_dtype_arg(from_)), np.dtype(_np_dtype_arg(to)), casting=casting)


def isdtype(dtype, kind):
    """``np.isdtype`` for NumPy and torch dtypes alike (in ``kind`` too)."""
    if isinstance(kind, tuple):
        kind = tuple(_np_dtype_arg(k) for k in kind)
    else:
        kind = _np_dtype_arg(kind)
    return np.isdtype(np.dtype(_np_dtype_arg(dtype)), kind)


def repeat(a, repeats, axis=None):
    """Each element repeated ``repeats`` times along ``axis``."""
    from .elemwise import broadcast_to

    if not isinstance(a, SparseArray):
        raise TypeError("`a` must be a SparseArray.")
    if not isinstance(repeats, int):
        raise ValueError("`repeats` must be an integer, uneven repeats are not yet Implemented.")
    new_shape = list(a.shape)
    axis_is_none = False
    if axis is None:
        a = a.reshape(-1)
        new_shape = [a.shape[0]]
        axis = 0
        axis_is_none = True
    if axis < 0:
        axis = a.ndim + axis
    new_shape[axis] *= repeats
    a = expand_dims(a, axis=axis + 1)
    a = broadcast_to(a, a.shape[: axis + 1] + (repeats,) + a.shape[axis + 2 :])
    out = a.reshape(tuple(new_shape))
    return out.flatten() if axis_is_none else out


def tile(a, reps):
    """``a`` repeated ``reps`` times along each axis."""
    from .elemwise import broadcast_to

    if not isinstance(a, SparseArray):
        a = as_coo(a)
    if isinstance(reps, int):
        reps = (reps,)
    reps = tuple(reps)
    if a.ndim == 0:
        a = a.reshape((1,))
    if len(reps) < a.ndim:
        reps = (1,) * (a.ndim - len(reps)) + reps
    elif len(reps) > a.ndim:
        a = a.reshape((1,) * (len(reps) - a.ndim) + a.shape)
    shape = a.shape
    ndim = len(reps)
    a = a.reshape(tuple(int(v) for v in np.column_stack(([1] * ndim, shape)).reshape(-1)))
    a = broadcast_to(a, tuple(int(v) for v in np.column_stack((reps, shape)).reshape(-1)))
    return a.reshape(tuple(int(r) * int(s) for r, s in zip(reps, shape)))


def unstack(x, axis=0):
    """The slices of ``x`` along ``axis``, one ``x[i]`` each."""
    ndim = x.ndim
    if not (-ndim <= axis < ndim):
        raise ValueError(f"axis must be in range [-{ndim}, {ndim}), got {axis}")
    if not isinstance(x, SparseArray):
        raise TypeError("`x` must be a SparseArray.")
    if axis < 0:
        axis = ndim + axis
    x = x.transpose((axis,) + tuple(i for i in range(ndim) if i != axis))
    return tuple(iter(x))


def diff(x, axis=-1, n=1, prepend=None, append=None):
    """The ``n``-th discrete difference along ``axis`` (slices subtracted)."""
    if not isinstance(x, SparseArray):
        raise TypeError("`x` must be a SparseArray.")
    if axis < 0:
        axis = x.ndim + axis
    if prepend is not None:
        x = concatenate([prepend, x], axis=axis)
    if append is not None:
        x = concatenate([x, append], axis=axis)
    result = x
    for _ in range(n):
        result = result[(slice(None),) * axis + (slice(1, None),)] - result[(slice(None),) * axis + (slice(None, -1),)]
    return result


def _fmod_remainder(a, b):
    """NumPy's float remainder (``np.remainder``) on tensors: ``fmod``, moved
    into ``b``'s sign, a zero result signed as ``b``; a NaN ``a`` passes
    through and an infinite one gives the x86 default NaN, as NumPy's do
    (torch's vectorized ``fmod`` returns other NaN bits)."""
    mod = torch.fmod(a, b)
    default_nan = torch.tensor(-(1 << 51), dtype=torch.int64, device=a.device).view(torch.float64).to(a.dtype)
    mod = torch.where(torch.isnan(a), a, torch.where(torch.isinf(a), default_nan, mod))
    fix = (mod != 0) & ((b < 0) != (mod < 0))
    mod = torch.where(fix, mod + b, mod)
    return torch.where(mod == 0, torch.copysign(torch.zeros_like(mod), torch.as_tensor(b, dtype=mod.dtype)), mod)


def _interp_real(x, xp, fp, lval, rval):
    """NumPy's ``compiled_interp`` on float64 tensors (``xp`` ascending):
    the same cases and the same operations, so the same bits."""
    n = xp.numel()
    if n == 1:
        return torch.where(x < xp[0], lval, torch.where(x > xp[0], rval, fp[0]))
    j = torch.searchsorted(xp, x, right=True) - 1
    j = torch.where(x > xp[-1], n, j)
    jc = j.clamp(0, n - 2)
    xj, xj1, yj, yj1 = xp[jc], xp[jc + 1], fp[jc], fp[jc + 1]
    slope = (yj1 - yj) / (xj1 - xj)
    res = slope * (x - xj) + yj
    # if it is NaN one way, the other way
    res = torch.where(torch.isnan(res), slope * (x - xj1) + yj1, res)
    res = torch.where(torch.isnan(res) & (yj == yj1), yj, res)
    res = torch.where(xj == x, yj, res)  # an exact sample point
    res = torch.where(j == n - 1, fp[n - 1], res)
    res = torch.where(j == n, rval, res)
    res = torch.where(j == -1, lval, res)
    return torch.where(torch.isnan(x), x, res)


def _interp_tensor(x, xp, fp, left=None, right=None, period=None):
    """``np.interp`` on tensors: float64 (complex128 for complex ``fp``)."""
    dev = x.device
    is_complex = fp.dtype.is_complex
    x = x.to(torch.float64)
    xp = xp.to(device=dev, dtype=torch.float64)
    fp = fp.to(device=dev, dtype=torch.complex128 if is_complex else torch.float64)
    if period is not None:
        if period == 0:
            raise ValueError("period must be a non-zero value")
        period = abs(period)
        left = right = None
        if xp.ndim != 1 or fp.ndim != 1:
            raise ValueError("Data points must be 1-D sequences")
        if xp.shape[0] != fp.shape[0]:
            raise ValueError("fp and xp are not of the same length")
        x = _fmod_remainder(x, period)
        xp = _fmod_remainder(xp, period)
        order = torch.sort(xp, stable=True).indices
        xp, fp = xp[order], fp[order]
        xp = torch.cat([xp[-1:] - period, xp, xp[0:1] + period])
        fp = torch.cat([fp[-1:], fp, fp[0:1]])
    if xp.ndim != 1 or fp.ndim != 1:
        raise ValueError("object too deep for desired array")
    if xp.numel() != fp.numel():
        raise ValueError("fp and xp are not of the same length.")
    if xp.numel() == 0:
        raise ValueError("array of sample points is empty")

    def edge(v, default):
        return default if v is None else torch.as_tensor(v, dtype=default.dtype, device=dev)

    if not is_complex:
        return _interp_real(x, xp, fp, edge(left, fp[0]), edge(right, fp[-1]))
    lval, rval = edge(left, fp[0]), edge(right, fp[-1])
    re = _interp_real(x, xp, fp.real, lval.real, rval.real)
    im = _interp_real(x, xp, fp.imag, lval.imag, rval.imag)
    im = torch.where(torch.isnan(x), torch.zeros_like(im), im)
    return torch.complex(re, im)


def interp(x, xp, fp, left=None, right=None, period=None):
    """``np.interp`` of the stored values and of the fill value (the result
    pruned), on the device, with NumPy's operations in NumPy's order: the
    same float64 bits."""
    from .elemwise import elemwise

    if isinstance(xp, SparseArray):
        xp = xp.todense()
    if isinstance(fp, SparseArray):
        fp = fp.todense()
    if not isinstance(x, (SparseArray, torch.Tensor)):
        return np.interp(np.asarray(x), asnumpy(xp), asnumpy(fp), left=left, right=right, period=period)
    dev = x.device
    xp_t = xp if isinstance(xp, torch.Tensor) else torch.as_tensor(np.asarray(xp), device=dev)
    fp_t = fp if isinstance(fp, torch.Tensor) else torch.as_tensor(np.asarray(fp), device=dev)
    if xp_t.device != dev or fp_t.device != dev:
        raise ValueError(f"xp and fp must lie on {dev}; move them with .to() first")

    def interp_func(xx):
        return _interp_tensor(xx, xp_t, fp_t, left=left, right=right, period=period)

    if isinstance(x, torch.Tensor):
        return interp_func(x)
    fmt = x.format
    out = elemwise(interp_func, asCOO(x))
    return out.asformat(fmt) if fmt != "coo" else out


def as_coo(x, shape=None, fill_value=None, idx_dtype=None, device=None):
    """Any supported input as a COO: sparse arrays on their device, tensors on
    theirs, scipy matrices, NumPy arrays and scalars, iterables and dicts of
    ``(coords, value)`` on ``device`` (the GPU by default)."""
    import scipy.sparse

    if hasattr(x, "shape") and shape is not None:
        raise ValueError("Cannot provide a shape in combination with something that already has a shape.")
    if hasattr(x, "fill_value") and fill_value is not None:
        raise ValueError("Cannot provide a fill-value in combination with something that already has a fill-value.")
    if isinstance(x, SparseArray):
        return x.asformat("coo")
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return COO.from_numpy(x, fill_value=fill_value, idx_dtype=idx_dtype, device=device)
    if scipy.sparse.issparse(x):
        return COO.from_scipy_sparse(x, device=device)
    if np.isscalar(x):
        return COO.from_numpy(np.asarray(x), fill_value=fill_value, idx_dtype=idx_dtype, device=device)
    if isinstance(x, (Iterable, dict)):
        return COO.from_iter(x, shape=shape, fill_value=fill_value, device=device)
    raise NotImplementedError(
        f"Format not supported for conversion. Supplied type is {type(x)}, see help(sparse.as_coo) for supported formats."
    )
