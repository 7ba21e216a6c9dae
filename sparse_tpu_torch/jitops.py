"""The static-shape kernel surface of ``sparse_tpu.jitops``, on torch tensors.

It holds ``mttkrp`` (the COO-level entry point of the MTTKRP path),
``sum_dense`` and ``union_elemwise``: functions with static output sizes
and no read back to the host, which a later ``torch.compile`` can take. The
rest of ``sparse_tpu.jitops`` is still to port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.coo import COO, _as_tensor, _linearize
from .kernels import dot as _kdot
from .kernels.elemwise import coo_elemwise_union


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
