"""The Array-API forms of the namespace (``sparse_tpu.ops.creation``): the
reductions, ``abs``, ``reshape``, ``astype``, ``squeeze``,
``permute_dims``/``transpose``, ``round``, ``real``/``imag`` and
``broadcast_arrays``. The creation functions themselves (``eye``, ``full``,
``zeros``, ...) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "abs",
    "all",
    "any",
    "astype",
    "broadcast_arrays",
    "imag",
    "max",
    "mean",
    "min",
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
]


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
