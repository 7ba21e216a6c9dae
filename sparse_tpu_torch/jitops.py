"""The static-shape kernel surface of ``sparse_tpu.jitops``, on torch tensors.

So far it holds ``mttkrp`` only, the COO-level entry point of the MTTKRP
path; the rest of ``sparse_tpu.jitops`` is still to port.
"""

from __future__ import annotations

from .core.coo import COO, _as_tensor
from .kernels import dot as _kdot


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
