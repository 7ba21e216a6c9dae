"""Global settings for sparse_tpu_torch.

The same semantics knobs as ``sparse_tpu._settings`` (read from the same
environment variables):

- ``SPARSE_AUTO_DENSIFY`` — if truthy, ``np.asarray(sparse_array)`` densifies
  instead of raising.
- ``SPARSE_WARN_ON_TOO_DENSE`` — if truthy, constructing a sparse array whose
  sparse storage is no smaller than its dense storage emits a RuntimeWarning.
- ``SPARSE_TPU_DEFAULT_INDEX_DTYPE`` — "int32" (default) or "int64"; the
  coordinate dtype used when the array shape fits.

There is no eager-matmul device knob: the device of the tensors decides where
a product runs (:func:`resolve_device`).
"""

from __future__ import annotations

import os

import torch

AUTO_DENSIFY = bool(int(os.environ.get("SPARSE_AUTO_DENSIFY", "0")))
WARN_ON_TOO_DENSE = bool(int(os.environ.get("SPARSE_WARN_ON_TOO_DENSE", "0")))
DEFAULT_INDEX_DTYPE = os.environ.get("SPARSE_TPU_DEFAULT_INDEX_DTYPE", "int32")


def resolve_device(device=None):
    """The ``torch.device`` that new arrays are placed on, with its index.

    ``None`` means the GPU. Without a usable CUDA device that raises rather
    than carrying on on the CPU: CPU placement is asked for explicitly with
    ``device="cpu"``."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sparse_tpu_torch places arrays on the GPU by default, but no CUDA device is available; "
                'pass device="cpu" to work on the CPU'
            )
        if device.index is None:  # as tensors report it, so devices compare equal
            device = torch.device("cuda", torch.cuda.current_device())
    return device
