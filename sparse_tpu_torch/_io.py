"""``save_npz`` / ``load_npz`` with ``sparse_tpu``'s npz schema (not
scipy's): a COO stores ``coords``/``data``/``shape``/``fill_value``, a GCXS
``data``/``indices``/``indptr``/``compressed_axes``/``shape``/``fill_value``.
A file written by either package loads in the other. Saving is an explicit
copy to the host; loading builds the array on ``device``.
"""

from __future__ import annotations

import numpy as np

from . import _settings
from .core.coo import COO, _as_tensor
from .core.gcxs import GCXS

__all__ = ["load_npz", "save_npz"]


def save_npz(filename, matrix, compressed=True):
    """Save a COO or GCXS array to ``filename`` (.npz), copying its buffers
    to the host. The format is not ``scipy.sparse.save_npz``'s."""
    if isinstance(matrix, COO):
        nodes = {
            "data": matrix.data.cpu().numpy(),
            "coords": matrix.coords.cpu().numpy(),
            "shape": np.asarray(matrix.shape),
            "fill_value": np.asarray(matrix.fill_value),
        }
    elif isinstance(matrix, GCXS):
        nodes = {
            "data": matrix.data.cpu().numpy(),
            "indices": matrix.indices.cpu().numpy(),
            "indptr": matrix.indptr.cpu().numpy(),
            "shape": np.asarray(matrix.shape),
            "fill_value": np.asarray(matrix.fill_value),
            "compressed_axes": np.asarray(matrix.compressed_axes),
        }
    else:
        raise ValueError(f"This object cannot be saved: {type(matrix).__name__}")
    if compressed:
        np.savez_compressed(filename, **nodes)
    else:
        np.savez(filename, **nodes)


def load_npz(filename, device=None):
    """Load a COO or GCXS array saved by ``save_npz`` (of either package),
    built on ``device`` (the GPU by default)."""
    with np.load(filename) as fp:
        try:
            return COO(
                coords=fp["coords"],
                data=fp["data"],
                shape=tuple(fp["shape"]),
                sorted=True,
                has_duplicates=False,
                fill_value=fp["fill_value"][()],
                device=device,
            )
        except KeyError:
            pass
        try:
            data, indices, indptr = fp["data"], fp["indices"], fp["indptr"]
            compressed_axes = tuple(int(a) for a in fp["compressed_axes"])
            shape = tuple(fp["shape"])
            fill_value = fp["fill_value"][()]
        except KeyError as e:
            raise RuntimeError(f"The file {filename!s} does not contain a valid sparse matrix") from e
    device = _settings.resolve_device(device)
    bufs = (_as_tensor(a, device) for a in (data, indices, indptr))
    return GCXS._make(*bufs, shape, compressed_axes, fill_value)
