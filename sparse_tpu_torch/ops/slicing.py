"""Index canonicalization: anything accepted by ``x[...]`` as a flat tuple of
``slice`` / ``int`` / 1-D integer index / ``None`` entries, one per
dimension (plus ``None`` entries for new axes), with ``sparse_tpu``'s
semantics (``sparse_tpu.ops.slicing``): ellipsis expansion, ``None``
insertion, negative indices made positive, booleans turned into positions,
bounds checks and slice clamping, with the same ``IndexError`` messages.

An index array comes back as a NumPy ``intp`` array when no ``device`` is
given (the host form DOK uses) and as an int64 tensor on ``device``
otherwise. NumPy arrays, lists and ranges are checked on the host and copied
to the device once. A tensor index stays on its device (another device
raises ``ValueError``): its negative entries are fixed there, and its bounds
check reads two numbers back, or is handed to the caller through
``checks`` so that it joins the caller's own read.
"""

from __future__ import annotations

from collections.abc import Iterable
from numbers import Integral, Number

import numpy as np
import torch

__all__ = ["normalize_index", "run_checks"]


def normalize_index(idx, shape, device=None, checks=None):
    """Canonicalize ``idx`` against ``shape``.

    Returns a tuple with one entry per dimension of ``shape`` (interleaved
    with any ``None`` new-axis markers): each entry is a non-negative
    ``int``, a ``slice`` with concrete ``start``/``stop``/``step`` (negative
    steps keep their normalized form), or a 1-D index array of non-negative
    integers (see the module's docstring for its form). ``checks``: a list
    that receives the pending bounds checks of tensor indices, to be passed
    to :func:`run_checks`; ``None`` runs them here."""
    if not isinstance(idx, tuple):
        idx = (idx,)

    # N-D boolean mask: expands into integer arrays covering its ndim dims
    expanded = []
    for i in idx:
        if _is_bool_array(i) and i.ndim > 1:
            expanded.extend(_nonzero(i))
        else:
            expanded.append(i)
    idx = tuple(expanded)

    idx = _replace_ellipsis(idx, len(shape))

    n_dims_consumed = sum(1 for i in idx if i is not None)
    if n_dims_consumed > len(shape):
        raise IndexError(f"Too many indices for array with shape {shape}")
    # pad missing trailing dimensions with full slices
    idx = idx + (slice(None),) * (len(shape) - n_dims_consumed)

    pending = [] if checks is None else checks
    out = []
    dim = 0
    for i in idx:
        if i is None:
            out.append(None)
            continue
        out.append(_normalize_one(i, shape[dim], device, pending))
        dim += 1
    if checks is None:
        run_checks(pending)
    return tuple(out)


def run_checks(checks, extra=None):
    """Run pending bounds checks with one read back to the host, together
    with the 0-d int64 tensors of ``extra`` (all on one device). Returns
    ``extra``'s values as Python ints."""
    extra = list(extra or [])
    if not checks and not extra:
        return []
    vals = torch.stack([*[v for c in checks for v in c[:2]], *extra]).tolist()
    for k, (_, _, d) in enumerate(checks):
        lo, hi = vals[2 * k], vals[2 * k + 1]
        if lo < -d or hi >= d:
            raise IndexError(f"Index array out of bounds for axis with size {d}")
    return vals[2 * len(checks) :]


def _is_bool_array(i):
    if isinstance(i, torch.Tensor):
        return i.dtype == torch.bool
    return isinstance(i, np.ndarray) and i.dtype == np.bool_


def _nonzero(i):
    if isinstance(i, torch.Tensor):
        return tuple(torch.nonzero(i).T)
    return i.nonzero()


def _replace_ellipsis(idx, ndim):
    n_ellipsis = sum(1 for i in idx if i is Ellipsis)
    if n_ellipsis > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if n_ellipsis == 0:
        return idx
    loc = next(pos for pos, i in enumerate(idx) if i is Ellipsis)
    n_dims_consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    fill = (slice(None),) * (ndim - n_dims_consumed)
    return idx[:loc] + fill + idx[loc + 1 :]


def _normalize_one(i, d, device, checks):
    if isinstance(i, slice):
        start, stop, step = i.indices(d)
        return slice(start, stop, step)
    if isinstance(i, torch.Tensor):
        return _normalize_tensor(i, d, device, checks)
    if isinstance(i, Integral) or (isinstance(i, np.ndarray) and i.ndim == 0 and i.dtype != np.bool_):
        i = int(i)
        if i < -d or i >= d:
            raise IndexError(f"Index {i} is out of bounds for axis with size {d}")
        return i + d if i < 0 else i
    if isinstance(i, np.ndarray) and i.ndim == 0 and i.dtype == np.bool_:
        raise IndexError("0-d boolean index is not supported")
    if isinstance(i, (np.ndarray, list, tuple, range)) or (isinstance(i, Iterable) and not isinstance(i, (str, bytes))):
        arr = np.asarray(i)
        if arr.dtype == np.bool_:
            if arr.ndim != 1:
                raise IndexError("multi-dimensional boolean masks are expanded before this point")
            if arr.shape[0] != d:
                raise IndexError(f"Boolean array of length {arr.shape[0]} does not match axis of size {d}")
            return _placed(np.flatnonzero(arr), device)
        if not np.issubdtype(arr.dtype, np.integer):
            if arr.size == 0:
                return _placed(arr.astype(np.intp).reshape(arr.shape), device)
            raise IndexError(f"Invalid index dtype {arr.dtype}")
        if arr.ndim > 1:
            raise IndexError(">1-d integer array indices are not supported")
        if arr.size and (int(arr.min()) < -d or int(arr.max()) >= d):
            raise IndexError(f"Index array out of bounds for axis with size {d}")
        return _placed(np.where(arr < 0, arr + d, arr).astype(np.intp), device)
    if isinstance(i, Number):
        # non-integral scalars (0.5, 1+2j, ...) are invalid indices
        raise IndexError(f"Invalid index: {i!r} (only integers, slices, arrays, and Ellipsis are valid)")
    raise IndexError(f"Invalid index type: {type(i)}")


def _placed(arr, device):
    """A host index array in the caller's form: as it is, or an int64 tensor
    on ``device`` (one copy)."""
    if device is None:
        return arr
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.int64), device=device)


def _normalize_tensor(t, d, device, checks):
    if device is None:
        # the host form (DOK): an explicit copy of the index to the host
        return _normalize_one(t.cpu().numpy(), d, None, checks)
    if t.device != torch.device(device):
        raise ValueError(f"index tensor on {t.device} given for an array on {device}; move it with .to() first")
    if t.ndim == 0:
        if t.dtype == torch.bool:
            raise IndexError("0-d boolean index is not supported")
        if t.dtype.is_floating_point or t.dtype.is_complex:
            raise IndexError(f"Invalid index: {t!r} (only integers, slices, arrays, and Ellipsis are valid)")
        return _normalize_one(int(t), d, device, checks)
    if t.dtype == torch.bool:
        if t.ndim != 1:
            raise IndexError("multi-dimensional boolean masks are expanded before this point")
        if t.shape[0] != d:
            raise IndexError(f"Boolean array of length {t.shape[0]} does not match axis of size {d}")
        return torch.nonzero(t).flatten()
    if t.dtype.is_floating_point or t.dtype.is_complex:
        if t.numel() == 0:
            return torch.zeros(t.shape, dtype=torch.int64, device=t.device)
        raise IndexError(f"Invalid index dtype {t.dtype}")
    if t.ndim > 1:
        raise IndexError(">1-d integer array indices are not supported")
    t = t.to(torch.int64)
    if t.numel():
        checks.append((t.amin(), t.amax(), d))
    return torch.where(t < 0, t + d, t)
