"""DIA (diagonal/banded) layout and its products, on torch tensors.

Stencil-structured matrices (grid Laplacians, tridiagonal systems,
finite-difference operators) hold all of their entries on a handful of
diagonals. In DIA form the matvec is a sum of shifted element-wise
products, with no gather: ``bands[i, r] == A[r, r + offsets[i]]``.

The layout is the one ``sparse_tpu.kernels.dia.build_dia`` builds, array
for array: the offsets are the sorted distinct ``col - row`` of the entries
(Python ints), ``bands`` a dense ``(k, n)`` tensor on the array's device.
It is built on the device (a unique of the diagonals, a search, one
scatter), with one read back of the offsets.

``dia_spmv`` and ``dia_spmm`` add ``bands[i] * x_shifted`` into a result
that starts from zeros, one pass a diagonal in offset order, over the rows
that diagonal reaches (outside them the band is zero by construction): a
product, then a sum, each rounded, as XLA rounds them, so the results are
the JAX package's bit for bit. On a CUDA device, for float32 and float64,
that is one launch of the hand-written kernel D1 (``csrc/dia.cu``: a thread
a row, or a row and column of the SpMM, the same rounded products and sums
in the same order); its plain version, the torch ops ``_shifted_sum``, runs
for CPU tensors, and on every device for the other dtypes (chosen by dtype
before any launch, :func:`on_kernel`). ``dia_spmv_sharded`` splits the rows
over a mesh's ranks (``parallel.make_mesh``) and swaps the halos of ``x``
with the two ring neighbours before the same shifted sum on each segment
(D1 with a shift into the halo'd segment, or ``_sharded_sum``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._settings import resolve_device
from .._utils import result_dtype
from . import _cuda

#: refuse conversions that would pad more than this many stored values per nnz
_MAX_FILL_RATIO = 8.0
#: refuse matrices with more distinct diagonals than this (as many offsets
#: as one D1 launch takes in its arguments)
_MAX_BANDS = _cuda.DIA_MAX_BANDS


class DiaMatrix(NamedTuple):
    """Banded matrix: ``bands[i, r] == A[r, r + offsets[i]]`` (0 outside)."""

    offsets: tuple  # diagonal offsets (col - row) as Python ints, sorted
    bands: torch.Tensor  # (k, n)
    shape: tuple  # (n, n)


def _tensor(a, device):
    """``a`` as a tensor on ``device``: NumPy input is copied there, a tensor elsewhere raises."""
    if isinstance(a, torch.Tensor):
        if a.device != device:
            raise ValueError(f"an input is on {a.device} but the layout is on {device}")
        return a
    return torch.as_tensor(np.asarray(a), device=device)


def build_dia(rows, cols, data, n, max_bands=_MAX_BANDS, max_fill=_MAX_FILL_RATIO, device=None):
    """Convert canonical COO triplets of an ``n×n`` matrix to DIA form on
    the device of ``data`` (a tensor), or on ``device`` for NumPy input.

    Returns ``None`` when the matrix isn't usefully banded: more than
    ``max_bands`` distinct diagonals, or band storage exceeding
    ``max_fill`` × nnz.
    """
    if isinstance(data, torch.Tensor):
        device = data.device
    else:
        device = resolve_device(device)
    rows, cols, data = (_tensor(a, device) for a in (rows, cols, data))
    if data.numel() == 0:
        return None
    rows = rows.to(torch.int64)
    diffs = cols.to(torch.int64) - rows
    offsets = torch.unique(diffs)  # sorted
    k = offsets.numel()
    if k > max_bands or k * n > max_fill * data.numel():
        return None
    bands = torch.zeros((k, n), dtype=data.dtype, device=device)
    bands[torch.searchsorted(offsets, diffs), rows] = data
    return DiaMatrix(tuple(offsets.tolist()), bands, (n, n))


def _operand(bands, x, ndim):
    x = _tensor(x, bands.device)
    if x.ndim != ndim or x.shape[0] != bands.shape[1]:
        raise ValueError(f"operand of shape {tuple(x.shape)} does not fit {bands.shape[1]} columns")
    return x


def on_kernel(device, dt):
    """Whether a shifted sum in dtype ``dt`` on ``device`` launches D1:
    float32/float64 on a CUDA device. Decided before any launch."""
    return device.type == "cuda" and dt in (torch.float32, torch.float64)


def _bands_for_kernel(bands, dt):
    bands = bands.to(dt)
    return bands if bands.shape[1] == 0 or bands.stride(1) == 1 else bands.contiguous()


def _shifted_sum(offsets, bands, x):
    """``sum_i bands[i] * x[r + offsets[i]]`` over the rows each diagonal
    reaches; ``x`` is ``(n,)`` or ``(n, m)``: D1 where :func:`on_kernel`,
    else :func:`_shifted_sum_plain`."""
    dt = result_dtype(bands.dtype, x.dtype)
    if not on_kernel(x.device, dt):
        return _shifted_sum_plain(offsets, bands, x)
    y = torch.empty((bands.shape[1], *x.shape[1:]), dtype=dt, device=x.device)
    return _cuda.dia_shifted_sum(offsets, _bands_for_kernel(bands, dt), x.to(dt), y)


def _shifted_sum_plain(offsets, bands, x):
    """:func:`_shifted_sum` in torch ops, D1's plain version: from zeros,
    one rounded product and sum a diagonal over the rows it reaches."""
    n = bands.shape[1]
    dt = result_dtype(bands.dtype, x.dtype)
    bands, x = bands.to(dt), x.to(dt)
    y = torch.zeros((n, *x.shape[1:]), dtype=dt, device=x.device)
    for i, o in enumerate(offsets):
        r0, r1 = max(0, -o), min(n, n - o)
        if r0 >= r1:
            continue
        band = bands[i, r0:r1]
        if x.ndim == 2:
            band = band[:, None]
        y[r0:r1].add_(band * x[r0 + o : r1 + o])
    return y


def dia_spmv(offsets, bands, x):
    """``y = A @ x`` for a DIA matrix: one shifted multiply-add a diagonal."""
    return _shifted_sum(offsets, bands, _operand(bands, x, 1))


def dia_spmm(offsets, bands, dense):
    """``Y = A @ X`` for a DIA matrix and dense ``X`` of shape (n, m)."""
    return _shifted_sum(offsets, bands, _operand(bands, dense, 2))


def dia_spmv_sharded(offsets, bands, x, mesh, axis_name="x"):
    """Row-sharded banded matvec over a 1-D mesh (``parallel.make_mesh``):
    each rank holds ``n / size`` rows of ``x`` and the same columns of
    ``bands`` (slices of global arrays, or DTensors sharded so), takes the
    last ``-min(offsets)`` values of its predecessor's ``x`` and the first
    ``max(offsets)`` of its successor's (``batch_isend_irecv``; the ring
    wraps at the global edges, where the bands are zero), and adds the
    shifted products on its segment from zeros, one rounded product a
    diagonal in offset order. Returns the global ``(n,)`` on every rank, on
    the mesh's device: for a finite ``x`` the bits of :func:`dia_spmv`.

    ``n`` must divide over the mesh and the halo must fit one segment."""
    from ..parallel.sharding import _gather, _local, _mesh_dim, _rotate

    offsets = tuple(int(o) for o in offsets)
    n = bands.shape[1]
    size = mesh.size(_mesh_dim(mesh, axis_name))
    if n % size:
        raise ValueError(f"n={n} must divide over {size} devices")
    seg = n // size
    lo, hi = -min(min(offsets), 0), max(max(offsets), 0)
    if max(lo, hi) > seg:
        raise ValueError("band halo wider than a device segment; use fewer devices")
    bl = _local(bands, mesh, axis_name, dim=1)
    xl = _local(x, mesh, axis_name)
    dt = result_dtype(bl.dtype, xl.dtype)
    bl, xl = bl.to(dt), xl.to(dt)
    parts = [xl]
    if lo:
        parts.insert(0, _rotate(xl[-lo:], mesh, axis_name, shift=-1))
    if hi:
        parts.append(_rotate(xl[:hi], mesh, axis_name, shift=1))
    xp = torch.cat(parts)
    if on_kernel(xp.device, dt):
        y = _cuda.dia_shifted_sum(offsets, _bands_for_kernel(bl, dt), xp, torch.empty(seg, dtype=dt, device=xp.device), shift=lo)
    else:
        y = _sharded_sum(offsets, bl, xp, lo)
    return _gather(y, mesh, axis_name)


def _sharded_sum(offsets, bl, xp, lo):
    """A rank's shifted sum over its halo'd segment ``xp`` (``lo`` values of
    halo before it) in torch ops, D1's plain version there: from zeros, one
    rounded product and sum a diagonal over every row of the segment."""
    seg = bl.shape[1]
    y = torch.zeros(seg, dtype=xp.dtype, device=xp.device)
    for i, o in enumerate(offsets):
        y.add_(bl[i] * xp[lo + o : lo + o + seg])
    return y
