"""``searchsorted`` for sorted probes, on torch tensors.

``sparse_tpu.kernels.search.searchsorted_sorted_probes`` works around the
TPU: every lowering of ``jnp.searchsorted`` there serializes, so for probes
that are sorted and unique it ranks them among the keys by one stable
double argsort. A GPU has a binary search of its own: here the function is
``torch.searchsorted`` on the operands' device, which takes any probes.
"""

from __future__ import annotations

import numpy as np
import torch

from .._settings import resolve_device


def searchsorted_sorted_probes(keys, probes, side="left"):
    """``searchsorted(keys, probes, side)`` → int64 positions, on the
    operands' device (the tensors among them, all on one; the GPU when
    both are NumPy): for each probe, the number of keys below it
    (``side="left"``) or at most it (``"right"``). ``keys`` sorted (ties
    fine), both 1-D, compared in their promoted dtype; the reference wants
    ``probes`` sorted and unique (e.g. ``arange``), this takes any."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    devices = {x.device for x in (keys, probes) if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"operands on more than one device: {sorted(map(str, devices))}")
    device = devices.pop() if devices else resolve_device(None)
    keys, probes = (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device) for x in (keys, probes))
    if probes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    dt = torch.promote_types(keys.dtype, probes.dtype)
    return torch.searchsorted(keys.to(dt).contiguous(), probes.to(dt).contiguous(), side=side)
