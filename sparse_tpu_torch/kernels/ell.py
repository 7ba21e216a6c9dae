"""Block-ELL layouts and their products: SpMM/SpMV of a 2-D matrix and the
MTTKRP of a 3-D tensor.

The layouts are the ones ``sparse_tpu.kernels.ell`` builds, array for array:
the stored entries grouped by ``block_rows``-row output block (stable, in
input order) and padded to one capacity per block, the pads ``data = 0``,
local row 0, column (or ``j``, ``k``) 0. They are built host-side with NumPy
and moved to the device once.

``ell_mttkrp`` runs the hand-written CUDA kernel of ``csrc/mttkrp.cu``
(counted as ``ell_mttkrp``) for tensors on the GPU and its plain PyTorch
version (``ell_mttkrp_plain``: gather, multiply, ``index_add_``) for tensors
on the CPU. The kernel needs each output row's slots together: beside the
four arrays, ``build_block_ell_3d`` builds on the host the slot ``order``
(a stable sort by global row, so pads join local row 0 of their block),
the int64 ``row_ptr`` of each row's run in it, and the int64 ``pieces``
that cut the runs longer than ``_cuda.MTTKRP_PIECE`` slots (the ragged
last block's pad run above all) over several warps. Neither package ever forms
the one-hot scatter matrix that ``sparse_tpu`` contracts on the MXU.

``ell_spmm``/``ell_spmv`` are XLA code in ``sparse_tpu``, not on a kernel
path; here they are torch ops (gather + ``index_add_``) on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._settings import resolve_device
from .._utils import result_dtype, signed_view, torch_dtype
from . import _cuda
from .bsr import _host
from .dot import (
    MTTKRP_STRATEGIES,
    _Mttkrp,
    check_indices,
    check_mttkrp_operands,
    mttkrp_dtypes,
    mttkrp_plain,
    on_kernel,
    segment_sum,
    slot_rows,
)

DEFAULT_BLOCK_ROWS = 128



def _block_ell_arrays(rows, index_arrays, data, n_rows, block_rows, pad_to):
    """``(e_rows, [e_idx, ...], e_data)`` NumPy ``(n_blocks, cap)`` arrays of
    ``sparse_tpu.kernels.ell.build_block_ell`` / ``build_block_ell_3d``."""
    rows = _host(rows)
    data = _host(data)
    nnz = rows.shape[0]
    n_blocks = -(-n_rows // block_rows)
    blk = rows // block_rows
    counts = np.bincount(blk, minlength=n_blocks)
    cap = max(-(-int(counts.max()) // pad_to) * pad_to, pad_to) if nnz else pad_to
    e_rows = np.zeros((n_blocks, cap), dtype=np.int32)
    e_idx = [np.zeros((n_blocks, cap), dtype=np.int32) for _ in index_arrays]
    e_data = np.zeros((n_blocks, cap), dtype=data.dtype)
    if nnz:
        order = np.argsort(blk, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        bo = blk[order]
        within = np.arange(nnz) - starts[bo]
        e_rows[bo, within] = (rows[order] - bo * block_rows).astype(np.int32)
        for e, idx in zip(e_idx, index_arrays):
            e[bo, within] = _host(idx)[order].astype(np.int32)
        e_data[bo, within] = data[order]
    return e_rows, e_idx, e_data


def _to_device(a, device):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # JAX's buffers; torch takes writable memory only
        a = a.copy()
    return torch.as_tensor(a, dtype=torch_dtype(a.dtype), device=device)


# ---------------------------------------------------------------------------
# 2-D: SpMM / SpMV (torch ops)
# ---------------------------------------------------------------------------


class BlockEll(NamedTuple):
    """Padded block-ELL layout of a 2-D sparse matrix (zero fill).

    e_rows/e_cols/e_data: (n_blocks, cap); padding entries have data == 0.
    """

    e_rows: torch.Tensor  # local row ids within the block, int32
    e_cols: torch.Tensor  # global column ids, int32
    e_data: torch.Tensor
    n_rows: int
    n_cols: int
    block_rows: int


def build_block_ell(rows, cols, data, n_rows, n_cols, block_rows=DEFAULT_BLOCK_ROWS, pad_to=8, device=None):
    """Host-side preprocessing: group entries by row block, pad to the max
    block population (rounded up to ``pad_to``), then move to ``device``."""
    device = resolve_device(device)
    e_rows, (e_cols,), e_data = _block_ell_arrays(rows, [cols], data, n_rows, block_rows, pad_to)
    return BlockEll(
        _to_device(e_rows, device),
        _to_device(e_cols, device),
        _to_device(e_data, device),
        int(n_rows),
        int(n_cols),
        int(block_rows),
    )


def ell_spmm(e_rows, e_cols, e_data, dense, *, n_rows, block_rows=DEFAULT_BLOCK_ROWS):
    """Block-ELL ``A @ B`` → dense ``(n_rows, N)`` in the promoted dtype."""
    dt = result_dtype(e_data.dtype, dense.dtype)
    # uint16/32/64 through their signed views: torch's CPU gathers and sums lack them
    prods = signed_view(e_data.reshape(-1).to(dt))[:, None] * signed_view(dense.to(dt))[e_cols.reshape(-1).long()]
    return segment_sum(prods, slot_rows(e_rows, block_rows), n_rows).view(dt)


def ell_spmv(e_rows, e_cols, e_data, x, *, n_rows, block_rows=DEFAULT_BLOCK_ROWS, lane_gather=None):
    """Block-ELL ``A @ x`` → dense ``(n_rows,)``. ``lane_gather`` (a TPU
    gather-rate workaround in ``sparse_tpu``) is accepted and has no effect:
    the gather is exact either way."""
    return ell_spmm(e_rows, e_cols, e_data, x[:, None], n_rows=n_rows, block_rows=block_rows)[:, 0]


# ---------------------------------------------------------------------------
# 3-D: MTTKRP
# ---------------------------------------------------------------------------


class BlockEll3d(NamedTuple):
    """Block-ELL layout of a 3-D COO tensor grouped by i-blocks.

    ``e_rows``/``e_j``/``e_k``/``e_data`` ``(n_blocks, cap)``: the arrays of
    ``sparse_tpu.kernels.ell.build_block_ell_3d``, in its order (``self[:4]``).
    ``order`` ``(n_blocks * cap,)`` int32: the flat slots stably sorted by
    global row ``block · block_rows + e_rows``; ``row_ptr``
    ``(n_blocks * block_rows + 1,)`` int64: global row ``i``'s slots are
    ``order[row_ptr[i]:row_ptr[i + 1]]``; ``pieces`` (the shape of
    ``row_ptr``, int64): ``_cuda.run_pieces(row_ptr, _cuda.MTTKRP_PIECE)``,
    how the kernel cuts the long runs.
    """

    e_rows: torch.Tensor
    e_j: torch.Tensor
    e_k: torch.Tensor
    e_data: torch.Tensor
    order: torch.Tensor
    row_ptr: torch.Tensor
    pieces: torch.Tensor
    block_rows: int


def block_ell_3d_runs(e_rows, block_rows=DEFAULT_BLOCK_ROWS):
    """``(order, row_ptr)`` of a layout's local rows ``(n_blocks, cap)``,
    computed on their device by one stable sort (``build_block_ell_3d``
    runs it on the host copy)."""
    n_blocks, cap = e_rows.shape
    if n_blocks * cap > np.iinfo(np.int32).max:
        raise ValueError(f"block-ELL layout of {n_blocks * cap} slots exceeds the int32 slot index range")
    keys, order = torch.sort(slot_rows(e_rows, block_rows), stable=True)
    bounds = torch.arange(n_blocks * block_rows + 1, device=e_rows.device)
    return order.to(torch.int32), torch.searchsorted(keys, bounds)


def block_ell_3d_from_numpy(e_rows, e_j, e_k, e_data, block_rows=DEFAULT_BLOCK_ROWS, device=None):
    """A :class:`BlockEll3d` on ``device`` from the four NumPy arrays taken as
    they are (``e_data`` may already be a tensor on ``device``), with the
    runs built on the host."""
    device = resolve_device(device)
    e_rows = _to_device(np.asarray(e_rows, dtype=np.int32), "cpu")
    order, row_ptr = block_ell_3d_runs(e_rows, block_rows)
    pieces = _cuda.run_pieces(row_ptr, _cuda.MTTKRP_PIECE)
    if not isinstance(e_data, torch.Tensor):
        e_data = _to_device(e_data, device)
    return BlockEll3d(
        e_rows.to(device),
        _to_device(np.asarray(e_j, dtype=np.int32), device),
        _to_device(np.asarray(e_k, dtype=np.int32), device),
        e_data,
        order.to(device),
        row_ptr.to(device),
        pieces.to(device),
        int(block_rows),
    )


def build_block_ell_3d(ci, cj, ck, data, n_rows, block_rows=DEFAULT_BLOCK_ROWS, pad_to=8, device=None):
    """Block-ELL layout of a 3-D COO tensor grouped by i-blocks (for
    :func:`ell_mttkrp`), built on the host and moved to ``device`` once:
    a :class:`BlockEll3d` whose first four arrays ``(e_rows, e_j, e_k,
    e_data)`` are ``sparse_tpu``'s; padding entries have data == 0.
    Coordinates may be NumPy arrays or tensors on any device."""
    e_rows, (e_j, e_k), e_data = _block_ell_arrays(ci, [cj, ck], data, n_rows, block_rows, pad_to)
    return block_ell_3d_from_numpy(e_rows, e_j, e_k, e_data, block_rows, device)


def ell_mttkrp_plain(e_rows, e_j, e_k, e_data, c, d, *, n_rows, block_rows=DEFAULT_BLOCK_ROWS, strategy="exact"):
    """:func:`ell_mttkrp` in torch ops on any device (the kernel's plain
    version): ``e_data · (C[e_j] · D[e_k])`` summed into each slot's global
    row by ``index_add_``, pads included; ``"hilo"`` as ``"exact"``."""
    return mttkrp_plain(e_rows, e_j, e_k, e_data, c, d, n_rows=n_rows, block_rows=block_rows, strategy=strategy)


def ell_mttkrp(
    e_rows,
    e_j,
    e_k,
    e_data,
    c,
    d,
    *,
    n_rows,
    block_rows=DEFAULT_BLOCK_ROWS,
    strategy="exact",
    order=None,
    row_ptr=None,
    pieces=None,
):
    """MTTKRP on the block-ELL layout: ``out[i, r] = Σ data · C[j, r] ·
    D[k, r]`` over the slots of row ``i`` → dense ``(n_rows, r)``.
    Differentiable in ``e_data``, ``c`` and ``d``.

    ``strategy`` (``sparse_tpu``'s TPU gather modes):

    - ``"exact"`` (default): the promoted dtype of ``e_data``, ``c`` and
      ``d`` (float32 or float64 on the kernel; integers and bool on the
      plain version, bool summing as "or"), exact factors;
    - ``"hilo"``: the same computation as ``"exact"`` (``sparse_tpu``'s
      hi|lo bf16 split reconstructs the factors to about 1e-7; this card
      reads them whole);
    - ``"bf16"``: factors rounded to bfloat16 (round to nearest even), their
      product in float32, then ``e_data · g`` in ``e_data``'s dtype.

    ``order``/``row_ptr``/``pieces`` are the layout's runs and their pieces
    (:class:`BlockEll3d`); on the GPU without them they are computed on the
    device each call (:func:`block_ell_3d_runs`, ``_cuda.run_pieces``; the
    pieces alone when only they are missing). A ``j`` or ``k`` outside the
    factors raises ``IndexError`` (one flag read back from the device)."""
    if strategy not in MTTKRP_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of {MTTKRP_STRATEGIES}")
    tensors = (("e_rows", e_rows), ("e_j", e_j), ("e_k", e_k), ("e_data", e_data))
    check_mttkrp_operands("ell_mttkrp", tensors, c, d)
    if e_rows.ndim != 2 or not (e_rows.shape == e_j.shape == e_k.shape == e_data.shape):
        raise ValueError("ell_mttkrp: e_rows, e_j, e_k and e_data must be (n_blocks, cap) arrays of one shape")
    if n_rows > e_rows.shape[0] * block_rows:
        raise ValueError(f"ell_mttkrp: n_rows = {n_rows} exceeds the layout's {e_rows.shape[0]} blocks")
    if (order is None) != (row_ptr is None):
        raise ValueError("ell_mttkrp: pass both order and row_ptr, or neither")
    kernel = on_kernel(e_data.device, mttkrp_dtypes(e_data, c, d, strategy)[0])
    if kernel:
        _cuda.require_cuda(e_data.device, "MTTKRP")
    check_indices(e_j, e_k, c, d)
    if kernel and order is None:
        order, row_ptr = block_ell_3d_runs(e_rows, block_rows)
    if kernel and pieces is None:
        pieces = _cuda.run_pieces(row_ptr, _cuda.MTTKRP_PIECE)
    return _Mttkrp.apply(e_rows, block_rows, e_j, e_k, e_data, c, d, n_rows, strategy, row_ptr, order, pieces)
