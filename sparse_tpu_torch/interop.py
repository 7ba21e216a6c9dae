"""Carrying state across from ``sparse_tpu``.

Both functions take NumPy arrays (``np.asarray`` of the JAX package's
buffers) and build the port's objects from them as they are, with no
re-sorting or re-layout, so that the two packages can be fed identical state.
"""

from __future__ import annotations

import numpy as np

from ._settings import resolve_device
from ._utils import zero_of_dtype
from .core.coo import COO, _as_tensor
from .kernels.row_ell import pack_row_ell


def coo_from_arrays(coords, data, shape, fill_value=None, device=None):
    """A COO from canonical ``coords`` ``(ndim, nnz)`` and ``data`` ``(nnz,)``,
    taken as canonical: no sort, no duplicate sum, no prune."""
    device = resolve_device(device)
    data = np.asarray(data)
    fv = zero_of_dtype(data.dtype) if fill_value is None else np.asarray(fill_value, dtype=data.dtype)[()]
    return COO._make(_as_tensor(coords, device), _as_tensor(data, device), shape, fv)


def row_ell_from_arrays(tiers, perm_inv, n_rows, n_cols, nz_rows, device=None):
    """The port's ``RowEll`` from a JAX ``RowEll``'s arrays: ``tiers`` as
    ``(cols, data)`` NumPy pairs, ``perm_inv`` as a NumPy array."""
    tiers = [(np.asarray(c), np.asarray(d)) for c, d in tiers]
    return pack_row_ell(tiers, np.asarray(perm_inv), n_rows, n_cols, nz_rows, device=device)
