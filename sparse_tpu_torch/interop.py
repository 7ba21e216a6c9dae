"""Carrying state across from ``sparse_tpu``.

Every function takes NumPy arrays (``np.asarray`` of the JAX package's
buffers) and builds the port's objects from them as they are, with no
re-sorting or re-layout, so that the two packages can be fed identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from ._settings import resolve_device
from ._utils import torch_dtype, zero_of_dtype
from .core.coo import COO, _as_tensor
from .core.gcxs import GCXS, _validate_compressed_axes
from .kernels.bsr import bsr_from_numpy
from .kernels.dia import DiaMatrix
from .kernels.ell import DEFAULT_BLOCK_ROWS, block_ell_3d_from_numpy
from .kernels.row_ell import pack_row_ell
from .nn import make_block_sparse_linear_params
from .parallel.sharding import PartitionedCOO, _tensor


def coo_from_arrays(coords, data, shape, fill_value=None, device=None):
    """A COO from canonical ``coords`` ``(ndim, nnz)`` and ``data`` ``(nnz,)``,
    taken as canonical: no sort, no duplicate sum, no prune."""
    device = resolve_device(device)
    data = np.asarray(data)
    fv = zero_of_dtype(data.dtype) if fill_value is None else np.asarray(fill_value, dtype=data.dtype)[()]
    return COO._make(_as_tensor(coords, device), _as_tensor(data, device), shape, fv)


def gcxs_from_arrays(data, indices, indptr, shape, compressed_axes, fill_value=None, device=None):
    """A GCXS from a JAX ``GCXS``'s ``data``, ``indices`` and ``indptr``,
    taken as they are (index dtypes included): no sort, no prune."""
    device = resolve_device(device)
    data = np.asarray(data)
    fv = zero_of_dtype(data.dtype) if fill_value is None else np.asarray(fill_value, dtype=data.dtype)[()]
    return GCXS._make(
        _as_tensor(data, device),
        _as_tensor(indices, device),
        _as_tensor(indptr, device),
        shape,
        _validate_compressed_axes(shape, compressed_axes),
        fv,
    )


def row_ell_from_arrays(tiers, perm_inv, n_rows, n_cols, nz_rows, device=None):
    """The port's ``RowEll`` from a JAX ``RowEll``'s arrays: ``tiers`` as
    ``(cols, data)`` NumPy pairs, ``perm_inv`` as a NumPy array."""
    tiers = [(np.asarray(c), np.asarray(d)) for c, d in tiers]
    return pack_row_ell(tiers, np.asarray(perm_inv), n_rows, n_cols, nz_rows, device=device)


def dia_from_arrays(offsets, bands, shape, device=None):
    """The port's ``DiaMatrix`` from a JAX ``DiaMatrix``'s fields, taken as
    they are."""
    device = resolve_device(device)
    return DiaMatrix(tuple(int(o) for o in offsets), _float_tensor(bands, device), tuple(shape))


def _float_tensor(a, device):
    """A tensor holding a copy of the NumPy array ``a`` (JAX's buffers are
    read-only, and parameters are updated in place); bfloat16 (``ml_dtypes``,
    which JAX hands out) is carried bit for bit."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.as_tensor(a, dtype=torch_dtype(a.dtype), device=device)


def bsr_from_arrays(blocks, block_rows, block_cols, shape, block_shape=(128, 128), device=None):
    """The port's ``BSR`` from a JAX ``BSR``'s arrays, taken as they are."""
    device = resolve_device(device)
    return bsr_from_numpy(_float_tensor(blocks, device), block_rows, block_cols, shape, block_shape, device)


def block_ell_3d_from_arrays(e_rows, e_j, e_k, e_data, block_rows=DEFAULT_BLOCK_ROWS, device=None):
    """The port's ``BlockEll3d`` from the four arrays of a JAX
    ``build_block_ell_3d``, taken as they are, with the runs the kernel
    needs built beside them on the host."""
    device = resolve_device(device)
    return block_ell_3d_from_numpy(e_rows, e_j, e_k, _float_tensor(e_data, device), block_rows, device)


def partitioned_coo_from_arrays(rows, cols, data, shape, block_rows, row_starts=None):
    """The port's host ``PartitionedCOO`` (CPU tensors) from a JAX
    ``PartitionedCOO``'s leaves and its ``row_starts``, taken as they are;
    ``parallel.partition_coo_rows`` and the sharded functions take it."""
    rows, cols, data = (_tensor(np.asarray(a)) for a in (rows, cols, data))
    starts = None if row_starts is None else np.asarray(row_starts, dtype=np.int64)
    return PartitionedCOO(rows, cols, data, tuple(int(n) for n in shape), int(block_rows), starts)


def ell_partition_from_arrays(*partition):
    """The port's form of a host partition of ``sparse_tpu.parallel``: the
    arrays of ``partition_spmm_ell``'s ``(e_rows, e_cols, e_data,
    block_rows)``, ``partition_mttkrp_ell``'s ``(e_rows, e_j, e_k, e_data,
    block_rows)``, ``bucket_columns``' ``(rows, cols, data, block_cols)`` or
    ``bucket_columns_ell``'s ``(e_rows, e_cols, e_data, block_rows,
    block_cols)`` as CPU tensors, the trailing ints as ints."""
    return tuple(int(a) if np.ndim(a) == 0 else _tensor(np.asarray(a)) for a in partition)


def block_sparse_linear_params_from_arrays(
    blocks, block_rows, block_cols, bias, out_features, in_features, t_rows=None, t_cols=None, t_perm=None, device=None
):
    """The port's ``BlockSparseLinearParams`` from a JAX
    ``BlockSparseLinearParams``'s arrays (``bias`` and the transposed layout
    may be ``None``)."""
    device = resolve_device(device)
    host = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return make_block_sparse_linear_params(
        _float_tensor(blocks, device),
        host(block_rows),
        host(block_cols),
        None if bias is None else _float_tensor(bias, device),
        out_features,
        in_features,
        host(t_rows),
        host(t_cols),
        host(t_perm),
    )
