"""The creation functions and the Array-API forms of the namespace
(``sparse_tpu.ops.creation``): ``eye``, ``full``, ``zeros``, ``ones``,
``empty`` and their ``_like`` forms, each built on the device it is asked
for (the GPU unless ``device="cpu"``; a ``_like`` form on its model's
device), ``asarray`` (a tensor taken as it stands, on its own device), the
reductions, ``abs``, ``reshape``, ``astype``, ``squeeze``,
``permute_dims``/``transpose``, ``round``, ``real``/``imag`` and
``broadcast_arrays``.
"""

from __future__ import annotations

import builtins
from collections.abc import Iterable

import numpy as np
import torch

from .. import _settings
from .._utils import index_dtype_for, numpy_dtype, torch_dtype
from ..core.base import SparseArray
from ..core.coo import COO

__all__ = [
    "abs",
    "all",
    "any",
    "asarray",
    "astype",
    "broadcast_arrays",
    "empty",
    "empty_like",
    "eye",
    "full",
    "full_like",
    "imag",
    "max",
    "mean",
    "min",
    "ones",
    "ones_like",
    "permute_dims",
    "prod",
    "real",
    "reshape",
    "round",
    "squeeze",
    "std",
    "sum",
    "transpose",
    "var",
    "zeros",
    "zeros_like",
]

_FORMATS = ("coo", "dok", "gcxs", "csc", "csr")


def format_to_string(format):
    if isinstance(format, type):
        if not issubclass(format, SparseArray):
            raise ValueError(f"invalid format: {format}")
        format = format.__name__.lower()
    if isinstance(format, str):
        if format not in _FORMATS:
            raise ValueError(f"invalid format: {format}")
        return format
    raise ValueError(f"invalid format: {format}")


def _device(device):
    """The torch device of a ``device=`` argument: ``None`` (the GPU),
    ``"cuda"``/``"cpu"`` or a ``torch.device``; anything else raises."""
    if device is not None and not isinstance(device, (str, torch.device)):
        raise ValueError("Device must be `'cuda'`, `'cpu'`, a `torch.device`, or `None`.")
    return _settings.resolve_device(device)


def eye(N, M=None, k=0, dtype=float, format="coo", *, device=None, **kwargs):
    """A 2-D array with ones on the ``k``-th diagonal, built on ``device``."""
    device = _device(device)
    M = N if M is None else M
    N, M = int(N), int(M)
    n_coords = builtins.max(builtins.min(N, M - k) if k > 0 else builtins.min(N + k, M), 0)
    ar = torch.arange(n_coords, dtype=torch.int64, device=device)
    rows, cols = (ar, ar + k) if k > 0 else (ar - k, ar)
    coords = torch.stack([rows, cols]).to(torch_dtype(index_dtype_for(builtins.max(N, M))))
    data = torch.ones(n_coords, dtype=torch_dtype(np.dtype(dtype)), device=device)
    return COO._make(coords, data, (N, M), np.zeros((), dtype=np.dtype(dtype))[()]).asformat(format, **kwargs)


def full(shape, fill_value, dtype=None, format="coo", order="C", *, device=None, **kwargs):
    """An array of ``shape`` whose every element is ``fill_value``: no stored
    entry, the value as the fill value; built on ``device``."""
    device = _device(device)
    if dtype is None:
        dtype = np.array(fill_value).dtype
    dtype = numpy_dtype(dtype)
    if not isinstance(shape, tuple):
        shape = (shape,) if not isinstance(shape, Iterable) else tuple(shape)
    if order not in {"C", None}:
        raise NotImplementedError("Currently, only 'C' and None are supported.")
    shape = tuple(int(s) for s in shape)
    idx = torch_dtype(index_dtype_for(builtins.max(shape, default=0)))
    coords = torch.zeros((len(shape), 0), dtype=idx, device=device)
    data = torch.zeros(0, dtype=torch_dtype(dtype), device=device)
    fv = np.asarray(fill_value, dtype=dtype)[()]
    return COO._make(coords, data, shape, fv).asformat(format, **kwargs)


def full_like(a, fill_value, dtype=None, shape=None, format=None, **kwargs):
    """``full`` with ``a``'s shape, dtype, format and device unless given."""
    dense = isinstance(a, (np.ndarray, torch.Tensor))
    if format is None:
        format = "coo" if dense else type(a).__name__.lower()
    if format == "_compressed2d":
        format = "gcxs"
    compressed_axes = kwargs.pop("compressed_axes", None)
    if compressed_axes is None and hasattr(a, "compressed_axes") and format == "gcxs":
        kwargs["compressed_axes"] = a.compressed_axes
    elif compressed_axes is not None:
        kwargs["compressed_axes"] = compressed_axes
    if kwargs.get("device") is None and isinstance(a, (SparseArray, torch.Tensor)):
        kwargs["device"] = a.device
    return full(
        tuple(a.shape) if shape is None else shape,
        fill_value,
        dtype=(numpy_dtype(a.dtype) if dtype is None else dtype),
        format=format,
        **kwargs,
    )


def zeros(shape, dtype=float, format="coo", *, device=None, **kwargs):
    return full(shape, fill_value=0, dtype=numpy_dtype(dtype), format=format, device=device, **kwargs)


def zeros_like(a, dtype=None, shape=None, format=None, **kwargs):
    dtype = numpy_dtype(dtype) if dtype is not None else None
    return full_like(a, fill_value=0, dtype=dtype, shape=shape, format=format, **kwargs)


def ones(shape, dtype=float, format="coo", *, device=None, **kwargs):
    return full(shape, fill_value=1, dtype=numpy_dtype(dtype), format=format, device=device, **kwargs)


def ones_like(a, dtype=None, shape=None, format=None, **kwargs):
    dtype = numpy_dtype(dtype) if dtype is not None else None
    return full_like(a, fill_value=1, dtype=dtype, shape=shape, format=format, **kwargs)


def empty(shape, dtype=float, format="coo", *, device=None, **kwargs):
    return full(shape, fill_value=0, dtype=numpy_dtype(dtype), format=format, device=device, **kwargs)


def empty_like(a, dtype=None, shape=None, format=None, **kwargs):
    dtype = numpy_dtype(dtype) if dtype is not None else None
    return full_like(a, fill_value=0, dtype=dtype, shape=shape, format=format, **kwargs)


def asarray(obj, /, *, dtype=None, format=None, backend=None, copy=False, device=None):
    """``obj`` as a sparse array of ``format``. A sparse array or a tensor
    stays on its device (a ``device`` that names another raises
    ``ValueError``: nothing moves silently); NumPy input, scalars and
    sequences go to ``device`` (the GPU by default)."""
    import scipy.sparse

    from .common import as_coo

    if device is not None and not isinstance(device, (str, torch.device)):
        raise ValueError("Device must be 'cuda', 'cpu' or a torch.device if specified.")
    if format is None:
        format = obj.format if isinstance(obj, SparseArray) else "coo"
    format = format_to_string(format)

    if isinstance(obj, (SparseArray, torch.Tensor)):
        if device is not None and _settings.resolve_device(device) != obj.device:
            raise ValueError(f"array on {obj.device} given for device {device}; move it with .to() first")
        if isinstance(obj, torch.Tensor):
            t = obj if dtype is None else obj.to(torch_dtype(dtype))
            res = COO.from_numpy(t)
            return res if t.ndim == 0 else res.asformat(format)
        res = obj.asformat("coo")
        if dtype is not None and numpy_dtype(res.dtype) != numpy_dtype(dtype):
            res = res.astype(dtype)
        res = res.asformat(format)
        if copy and res is obj:
            res = res.copy()
        return res
    if scipy.sparse.issparse(obj):
        res = COO.from_scipy_sparse(obj, device=device)
        if dtype is not None and numpy_dtype(res.dtype) != numpy_dtype(dtype):
            res = res.astype(dtype)
        return res.asformat(format)
    if np.isscalar(obj):
        obj = np.asarray(obj)
    arr = np.asarray(obj, dtype=dtype)
    if arr.ndim == 0 and isinstance(obj, np.ndarray):
        return COO.from_numpy(arr, device=device)
    return COO.from_numpy(arr, device=device).asformat(format)


def all(x, /, *, axis=None, keepdims=False):  # noqa: A001
    return x.all(axis=axis, keepdims=keepdims)


def any(x, /, *, axis=None, keepdims=False):  # noqa: A001
    return x.any(axis=axis, keepdims=keepdims)


def max(x, /, *, axis=None, keepdims=False, out=None):  # noqa: A001
    return x.max(axis=axis, keepdims=keepdims, out=out)


def min(x, /, *, axis=None, keepdims=False, out=None):  # noqa: A001
    return x.min(axis=axis, keepdims=keepdims, out=out)


def mean(x, /, *, axis=None, keepdims=False, dtype=None, out=None):
    return x.mean(axis=axis, keepdims=keepdims, dtype=dtype, out=out)


def prod(x, /, *, axis=None, keepdims=False, dtype=None, out=None):
    return x.prod(axis=axis, keepdims=keepdims, dtype=dtype, out=out)


def sum(x, /, *, axis=None, keepdims=False, dtype=None, out=None):  # noqa: A001
    return x.sum(axis=axis, keepdims=keepdims, dtype=dtype, out=out)


def std(x, /, *, axis=None, correction=0.0, keepdims=False, out=None):
    return x.std(axis=axis, ddof=correction, keepdims=keepdims, out=out)


def var(x, /, *, axis=None, correction=0.0, keepdims=False, out=None):
    return x.var(axis=axis, ddof=correction, keepdims=keepdims, out=out)


def abs(x, /):  # noqa: A001
    from .elemwise import elemwise

    return elemwise(np.abs, x)


def reshape(x, /, shape, *, copy=None, order="C"):
    return x.reshape(shape, order=order) if not isinstance(x, np.ndarray) else np.reshape(x, shape)


def astype(x, dtype, /, *, copy=True):
    return x.astype(dtype, copy=copy)


def squeeze(x, /, axis=None):
    return x.squeeze(axis=axis)


def permute_dims(x, /, axes=None):
    return x.transpose(axes=axes)


def transpose(a, axes=None):
    return a.transpose(axes=axes)


def round(x, /, decimals=0, out=None):  # noqa: A001
    return x.round(decimals=decimals, out=out)


def imag(x, /):
    return x.imag


def real(x, /):
    return x.real


def broadcast_arrays(*arrays):
    """Each array broadcast to the common shape: sparse arrays as COO on
    their device, tensors by ``torch.broadcast_to``, NumPy arrays by
    ``np.broadcast_to``."""
    from .elemwise import broadcast_to

    shape = np.broadcast_shapes(*(tuple(a.shape) for a in arrays))
    out = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            out.append(np.broadcast_to(a, shape))
        elif isinstance(a, torch.Tensor):
            out.append(torch.broadcast_to(a, shape))
        else:
            out.append(broadcast_to(a, shape))
    return out
