"""BSR — block compressed sparse row layout and its products.

The layout is the one ``sparse_tpu.kernels.bsr.build_bsr`` builds, array for
array: stored dense blocks ``(n_blocks, bm, bn)`` sorted row-major by
(block-row, block-col), one zero block at column 0 for every empty
block-row, and with ``pad_run_multiple > 1`` zero pad blocks at column 0
appended to each run. It is built host-side with NumPy and moved to the
device once, with a host-built int64 ``row_ptr`` (``n_block_rows + 1``)
that gives each block-row's run, so that the kernels need no sequential
grid.

The products run in hand-written CUDA kernels for tensors on the GPU:
``bsr_spmm_kernel`` (P2) and ``bsr_sddmm_kernel`` (P4) on the tensor cores
for float32 (as 3xTF32) and bfloat16 (``csrc/bsr_tc.cu``) and on the CUDA
cores for float64 (``csrc/bsr.cu``), and the SpMM's two-blocks-per-step
form ``bsr_spmm_kernel2`` (P3) on the CUDA cores (``csrc/bsr.cu``). Beside
them sit their plain PyTorch versions (``bsr_spmm_plain``,
``bsr_sddmm_plain``, and ``tf32_split``, the 3xTF32 split the tensor-core
kernel makes), which the wrappers take only for tensors on the CPU. There
is no ``use_pallas`` switch: the device decides.

``bsr_spmm`` and ``bsr_spmm_trainable`` are the differentiable products
(``torch.autograd.Function``): the first with the XLA-derived backward of
the JAX package (wgrad by the block SDDMM, dgrad as a torch ``bmm`` held at
full float32 precision), the second with the kernels in its backward too
(dgrad on the transposed layout, wgrad by the block SDDMM).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .._settings import resolve_device
from .._utils import torch_dtype
from . import _cuda


class BSR(NamedTuple):
    """Block compressed sparse row matrix (zero fill).

    blocks: (n_blocks, bm, bn) stored dense blocks
    block_rows/block_cols: (n_blocks,) int32 block coordinates, each
        block-row's run contiguous
    row_ptr: (n_block_rows + 1,) int64, block-row ``r``'s run is
        ``row_ptr[r]:row_ptr[r + 1]``
    """

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    shape: tuple
    block_shape: tuple
    row_ptr: torch.Tensor

    @property
    def n_blocks(self):
        return self.blocks.shape[0]

    @property
    def nnz(self):
        return int(self.blocks.shape[0] * self.blocks.shape[1] * self.blocks.shape[2])

    def todense(self):
        """The dense ``shape`` tensor on the blocks' device (overlapping
        blocks add up)."""
        m, n = self.shape
        bm, bn = self.block_shape
        mb, nb = -(-m // bm), -(-n // bn)
        out = torch.zeros((mb * nb, bm, bn), dtype=self.blocks.dtype, device=self.blocks.device)
        out.index_add_(0, self.block_rows.long() * nb + self.block_cols.long(), self.blocks)
        return out.reshape(mb, nb, bm, bn).transpose(1, 2).reshape(mb * bm, nb * bn)[:m, :n]


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def block_row_ptr(block_rows, n_block_rows):
    """Host-side int64 ``(n_block_rows + 1,)`` run offsets of a layout whose
    block-rows each form one contiguous run in ascending order (raises
    ``ValueError`` otherwise)."""
    br = _host(block_rows).astype(np.int64)
    if br.size and (br[0] < 0 or br[-1] >= n_block_rows or (np.diff(br) < 0).any()):
        raise ValueError(f"block_rows must be ascending block-row ids in [0, {n_block_rows})")
    return np.concatenate([[0], np.cumsum(np.bincount(br, minlength=n_block_rows))]).astype(np.int64)


def build_bsr_arrays(rows, cols, data, shape, block_shape=(128, 128), pad_run_multiple=1):
    """The NumPy layout ``(blocks, block_rows, block_cols)`` of
    ``sparse_tpu.kernels.bsr.build_bsr``, array for array."""
    bm, bn = block_shape
    m, k = shape
    n_block_rows = -(-m // bm)
    kb = -(-k // bn)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    data = np.asarray(data)

    brow = rows // bm
    bcol = cols // bn
    key = brow.astype(np.int64) * kb + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.flatnonzero(np.concatenate([[True], np.diff(key_s) != 0])) if key_s.size else np.empty(0, np.int64)
    uniq = key_s[starts] if key_s.size else np.empty(0, np.int64)
    block_of_entry = np.searchsorted(uniq, key_s)

    n_stored = uniq.shape[0]
    u_brow = (uniq // kb).astype(np.int32)
    u_bcol = (uniq % kb).astype(np.int32)

    # empty block-rows get one zero block at column 0
    present = np.zeros(n_block_rows, dtype=bool)
    present[u_brow] = True
    missing = np.flatnonzero(~present).astype(np.int32)

    total = n_stored + missing.shape[0]
    blocks = np.zeros((max(total, 1), bm, bn), dtype=data.dtype)
    if key_s.size:
        r_local = (rows[order] % bm).astype(np.int64)
        c_local = (cols[order] % bn).astype(np.int64)
        np.add.at(blocks, (block_of_entry, r_local, c_local), data[order])
    all_brow = np.concatenate([u_brow, missing]).astype(np.int32)
    all_bcol = np.concatenate([u_bcol, np.zeros(missing.shape[0], dtype=np.int32)]).astype(np.int32)
    if total == 0:
        all_brow = np.zeros(1, dtype=np.int32)
        all_bcol = np.zeros(1, dtype=np.int32)
        total = 1
    forder = np.argsort(all_brow.astype(np.int64) * kb + all_bcol, kind="stable")
    blocks = blocks[:total][forder]
    all_brow = all_brow[forder]
    all_bcol = all_bcol[forder]

    if pad_run_multiple > 1:
        # zero blocks at column 0 appended to each run (a stable sort by block-row alone)
        counts = np.bincount(all_brow, minlength=n_block_rows)
        extra = -(-counts // pad_run_multiple) * pad_run_multiple - counts
        if extra.sum():
            pad_rows = np.repeat(np.arange(n_block_rows, dtype=np.int32), extra)
            blocks = np.concatenate([blocks, np.zeros((pad_rows.size, bm, bn), dtype=blocks.dtype)])
            all_brow = np.concatenate([all_brow, pad_rows])
            all_bcol = np.concatenate([all_bcol, np.zeros(pad_rows.size, dtype=np.int32)])
            forder = np.argsort(all_brow.astype(np.int64) * (kb + 1), kind="stable")
            blocks = blocks[forder]
            all_brow = all_brow[forder]
            all_bcol = all_bcol[forder]
    return blocks, all_brow, all_bcol


def bsr_from_numpy(blocks, block_rows, block_cols, shape, block_shape, device=None):
    """A :class:`BSR` on ``device`` from NumPy arrays taken as they are
    (``blocks`` may already be a tensor on ``device``)."""
    device = resolve_device(device)
    if not isinstance(blocks, torch.Tensor):
        blocks = np.ascontiguousarray(blocks)
        blocks = torch.as_tensor(blocks, dtype=torch_dtype(blocks.dtype), device=device)
    row_ptr = block_row_ptr(block_rows, -(-shape[0] // block_shape[0]))
    return BSR(
        blocks,
        torch.as_tensor(np.asarray(block_rows, dtype=np.int32), device=device),
        torch.as_tensor(np.asarray(block_cols, dtype=np.int32), device=device),
        tuple(int(s) for s in shape),
        tuple(int(s) for s in block_shape),
        torch.as_tensor(row_ptr, device=device),
    )


def build_bsr(rows, cols, data, shape, block_shape=(128, 128), pad_run_multiple=1, device=None):
    """Build a BSR layout from COO triplets (host-side, one-time), then move
    it to ``device`` once.

    Every empty block-row receives one zero block. ``pad_run_multiple > 1``
    pads each block-row's run of stored blocks to a multiple of that count
    (with zero blocks), as :func:`bsr_spmm_kernel2` needs for 2."""
    blocks, brow, bcol = build_bsr_arrays(rows, cols, data, shape, block_shape, pad_run_multiple)
    return bsr_from_numpy(blocks, brow, bcol, shape, block_shape, device=device)


def transpose_bsr_layout(block_rows, block_cols, n_block_rows_t):
    """Host-side one-time transpose layout for a BSR pattern: returns
    ``(t_rows, t_cols, t_perm)`` NumPy arrays sorted row-major in the
    transposed space, with every empty transposed block-row padded by one
    zero block (``t_perm == -1``), ready for :func:`bsr_spmm_kernel` on Aᵀ
    (stored block ``j`` of Aᵀ is ``blocks[t_perm[j]]ᵀ``)."""
    br = _host(block_rows)
    bc = _host(block_cols)
    order = np.argsort(bc.astype(np.int64) * (br.max(initial=0) + 1) + br, kind="stable")
    t_rows = bc[order].astype(np.int32)
    t_cols = br[order].astype(np.int32)
    t_perm = order.astype(np.int64)
    present = np.zeros(n_block_rows_t, dtype=bool)
    present[t_rows] = True
    missing = np.flatnonzero(~present).astype(np.int32)
    if missing.size:
        t_rows = np.concatenate([t_rows, missing])
        t_cols = np.concatenate([t_cols, np.zeros(missing.size, np.int32)])
        t_perm = np.concatenate([t_perm, np.full(missing.size, -1, np.int64)])
        order2 = np.argsort(t_rows.astype(np.int64) * (int(t_cols.max(initial=0)) + 2) + t_cols, kind="stable")
        t_rows, t_cols, t_perm = t_rows[order2], t_cols[order2], t_perm[order2]
    return t_rows, t_cols, t_perm


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic; used for CPU tensors)
# ---------------------------------------------------------------------------


def _block_index(ids, size, limit):
    """``(n, size)`` element indices of the blocks ``ids`` along an axis of
    ``limit`` elements, clamped into range, and the mask of those in range."""
    idx = ids.long()[:, None] * size + torch.arange(size, device=ids.device)
    valid = (idx >= 0) & (idx < limit)
    return idx.clamp(0, max(limit - 1, 0)), valid


def _gather_row_blocks(mat, ids, size):
    """``(n, size, cols)``: the row-blocks ``ids`` of ``mat``, zero past its
    last row (no padded copy of ``mat``)."""
    idx, valid = _block_index(ids, size, mat.shape[0])
    if mat.shape[0] == 0:
        return mat.new_zeros((ids.shape[0], size, mat.shape[1]))
    return mat[idx] * valid[:, :, None].to(mat.dtype)


def _add_row_blocks(out, ids, prods):
    """``out[ids-block rows] += prods`` (``(n, size, cols)``), dropping rows past ``out``'s end."""
    n, size, cols = prods.shape
    idx, valid = _block_index(ids, size, out.shape[0])
    keep = valid.reshape(-1)
    return out.index_add_(0, idx.reshape(-1)[keep], prods.reshape(n * size, cols)[keep])


def _compute_dtype(dtype):
    # bf16 sums in float32 and rounds once at the end, as the kernel does
    return torch.float32 if dtype == torch.bfloat16 else dtype


def bsr_spmm_plain(block_rows, block_cols, blocks, dense, *, n_rows):
    """``A @ dense`` by a pad-free gather of dense's column-blocks, one
    ``bmm`` and an ``index_add_`` by block-row: the counterpart of
    ``sparse_tpu.kernels.bsr.bsr_spmm_xla``."""
    _, bm, bn = blocks.shape
    ct = _compute_dtype(dense.dtype)
    prods = torch.bmm(blocks.to(ct), _gather_row_blocks(dense.to(ct), block_cols, bn))
    out = torch.zeros((n_rows, dense.shape[1]), dtype=ct, device=dense.device)
    return _add_row_blocks(out, block_rows, prods).to(dense.dtype)


def tf32_split(x):
    """``(hi, lo)`` of float32 ``x`` as the tensor-core kernel splits it for
    3xTF32: ``hi`` is ``x`` rounded to tf32 (nearest, ties away from zero:
    ``cvt.rna.tf32.f32``), ``lo`` is ``x - hi`` rounded the same way, both
    with their low 13 mantissa bits zero (bit masking), so the tensor core
    reads them exactly; where ``hi`` is not finite, ``lo = 0``. ``hi + lo``
    rebuilds ``x`` to about 2^-22 relative, and the kernel's products are
    ``lo·hi + hi·lo + hi·hi``."""

    def rna(v):
        bits = v.view(torch.int32)
        # add half a tf32 ulp to the magnitude, then drop the 13 low bits
        rounded = torch.where(torch.isfinite(v), (bits + 0x1000) & ~0x1FFF, bits)
        return rounded.view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    lo = torch.where(torch.isfinite(hi), rna(x - hi), torch.zeros_like(x))
    return hi, lo


def bsr_sddmm_plain(block_rows, block_cols, lhs, rhs, *, block_shape=(128, 128)):
    """``out[j] = lhs[rows[j]-block, :] @ rhs[:, cols[j]-block]``: the
    row-blocks of ``lhs`` and the column-blocks of ``rhs`` gathered, then one
    ``bmm``; entries past ``lhs``'s rows or ``rhs``'s columns are zero."""
    bm, bn = block_shape
    ct = _compute_dtype(lhs.dtype)
    a = _gather_row_blocks(lhs.to(ct), block_rows, bm)
    b = _gather_row_blocks(rhs.to(ct).T, block_cols, bn).transpose(1, 2)
    return torch.bmm(a, b).to(lhs.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_spmm(block_rows, block_cols, blocks, dense, block_shape):
    for name, t in (("block_rows", block_rows), ("block_cols", block_cols), ("blocks", blocks), ("dense", dense)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != dense.device:
            raise ValueError(f"{name} is on {t.device} but dense is on {dense.device}")
    n = (blocks.shape[0],) if blocks.ndim == 3 else None
    if n is None or dense.ndim != 2 or block_rows.shape != n or block_cols.shape != n:
        raise ValueError("bsr_spmm: blocks must be (n_blocks, bm, bn) and dense 2-D, with one row and col per block")
    if block_shape is not None and tuple(block_shape) != tuple(blocks.shape[1:]):
        raise ValueError(f"block_shape {tuple(block_shape)} does not match blocks of shape {tuple(blocks.shape[1:])}")
    if blocks.dtype != dense.dtype:
        raise TypeError(f"blocks ({blocks.dtype}) and dense ({dense.dtype}) must share one dtype")
    _cuda.check_bsr_dtype(dense.dtype)


def _padded_rows(t):
    """A row-major copy of 2-D ``t`` whose rows are padded to 16 bytes (a
    TMA-legal stride), as a view of ``t``'s shape."""
    rows, cols = t.shape
    step = 16 // t.element_size()
    buf = t.new_empty((rows, max(-(-cols // step) * step, step)))
    buf[:, :cols] = t
    return buf[:, :cols]


def _tc_operands(blocks, dense):
    """``blocks`` and ``dense`` as the tensor-core kernel reads them (K-major,
    16-byte strides, a block width that is a whole number of stages),
    copied only where they are not already: a block width off the stage
    grid pads both with zero columns and rows, any other layout is copied
    into a fresh K-major buffer."""
    kps = _cuda.tc_k_per_stage(dense.dtype)
    _, _, bn = blocks.shape
    k, n = dense.shape
    if bn % kps:
        bn_p, kb = -(-bn // kps) * kps, -(-k // bn)
        blocks = torch.nn.functional.pad(blocks, (0, bn_p - bn))
        rows = dense.new_zeros((n, kb * bn))
        rows[:, :k] = dense.T
        padded = dense.new_zeros((n, kb, bn_p))
        padded[:, :, :bn] = rows.view(n, kb, bn)
        return blocks, padded.view(n, kb * bn_p).T
    if not _cuda._tc_ready(blocks, 2):
        blocks = blocks.clone(memory_format=torch.contiguous_format)
    if not _cuda._tc_ready(dense, 0):
        dense = _padded_rows(dense.T).T
    return blocks, dense


def _spmm(block_rows, block_cols, blocks, dense, n_rows, block_shape, row_ptr, pairs):
    _check_spmm(block_rows, block_cols, blocks, dense, block_shape)
    device = dense.device
    if device.type != "cpu":
        _cuda.require_cuda(device, "BSR")
    if row_ptr is None:
        row_ptr = torch.as_tensor(block_row_ptr(block_rows, -(-n_rows // blocks.shape[1])), device=device)
    if pairs == 2 and bool((torch.diff(row_ptr) % 2 != 0).any()):
        raise ValueError("bsr_spmm_kernel2 needs every block-row's run to have even length (pad_run_multiple=2)")
    if device.type == "cpu":
        return bsr_spmm_plain(block_rows, block_cols, blocks, dense, n_rows=n_rows)
    out = torch.empty((n_rows, dense.shape[1]), dtype=dense.dtype, device=device)
    cols = block_cols.to(torch.int32).contiguous()
    if dense.dtype not in _cuda.TC_DTYPES:
        return _cuda.bsr_spmm(blocks, cols, row_ptr, dense, out, pairs=pairs)
    blocks, dense = _tc_operands(blocks, dense)
    n_front, n_partial, n_tickets = _cuda.bsr_tc_scratch(blocks.shape[0], row_ptr.shape[0] - 1, blocks.shape[1], dense.shape[1])
    partial = torch.empty(n_partial, dtype=torch.float32, device=device)
    tickets = _cuda.zeroed_tickets(device, n_tickets)
    pieces = _cuda.run_pieces(row_ptr, _cuda.BSR_PIECE)
    name = "bsr_spmm" if pairs == 1 else "bsr_spmm2"
    return _cuda.bsr_spmm_tc(blocks, cols, row_ptr, pieces, dense, out, partial, tickets, name=name)


def bsr_spmm_kernel(block_rows, block_cols, blocks, dense, *, n_rows, block_shape=None, row_ptr=None):
    """``A @ dense`` for BSR ``A`` (``n_rows`` rows) on the CUDA kernel
    (P2, the counterpart of ``bsr_spmm_pallas``); its plain version for CPU
    tensors. float32 runs on the tensor cores as 3xTF32 (about 2^-21
    relative error per product, the reference's ``Precision.HIGHEST``;
    never one TF32 pass), bfloat16 on the tensor cores with a float32 sum
    and one rounding at the store, float64 on the CUDA cores. ``blocks``
    and ``dense`` may be any strided views: the tensor-core kernel reads
    both K-major (``blocks`` with its last axis contiguous, ``dense`` with
    its first, as ``x.T`` of a row-major ``x``), and this wrapper copies any
    other layout into that one first (an N-major ``dense``, a misaligned
    view, a block width that is not a multiple of 32 float32 or 64 bfloat16
    values); the layer needs no such copy. ``row_ptr``
    (:func:`block_row_ptr`, on the device) saves a host pass over
    ``block_rows``."""
    return _spmm(block_rows, block_cols, blocks, dense, n_rows, block_shape, row_ptr, pairs=1)


def bsr_spmm_kernel2(block_rows, block_cols, blocks, dense, *, n_rows, block_shape=None, row_ptr=None):
    """The two-block SpMM (P3, the counterpart of ``bsr_spmm_pallas2``).
    Every block-row's run must have even length (``build_bsr(...,
    pad_run_multiple=2)``), else ``ValueError``: the JAX package checks only
    an even total. The check reads the run lengths back from the device on
    every call. float32 and bfloat16 run on :func:`bsr_spmm_kernel`'s
    tensor-core kernel, whose stage ring walks a run block by block, so the
    pair step of the TPU pipeline buys nothing there: the same bits as
    :func:`bsr_spmm_kernel`, counted as ``bsr_spmm2``. float64 takes two
    blocks per step on the CUDA cores (``csrc/bsr.cu``)."""
    return _spmm(block_rows, block_cols, blocks, dense, n_rows, block_shape, row_ptr, pairs=2)


def _sddmm_tc_operand(t, mn_dim):
    """``t`` as the tensor-core SDDMM reads it (``_cuda.sddmm_tc_major``):
    as it lies where it can, else a row-major padded copy."""
    return t if _cuda.sddmm_tc_major(t, mn_dim) is not None else _padded_rows(t)


def bsr_sddmm_kernel(block_rows, block_cols, lhs, rhs, *, block_shape=(128, 128)):
    """Block-sampled dense-dense matmul on the CUDA kernels (P4, the
    counterpart of ``bsr_sddmm_pallas``): for each stored block ``(r, c)``
    ``lhs[r·bm:(r+1)·bm, :] @ rhs[:, c·bn:(c+1)·bn]`` (rows and columns past
    the operands' ends are zero). lhs ``(M, B)``, rhs ``(B, K)`` →
    ``(n_blocks, bm, bn)``; its plain version for CPU tensors. float32 runs
    on the tensor cores as 3xTF32 (the reference's ``Precision.HIGHEST``,
    never one TF32 pass), bfloat16 on the tensor cores with a float32 sum
    and one rounding at the store, float64 on the CUDA cores. The
    tensor-core kernel reads each operand with either axis contiguous (the
    layer's ``grad_y.T`` and ``x`` in place); this wrapper copies any other
    layout (a misaligned base, a stride that is no multiple of 16 bytes)."""
    for name, t in (("block_rows", block_rows), ("block_cols", block_cols), ("lhs", lhs), ("rhs", rhs)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != lhs.device:
            raise ValueError(f"{name} is on {t.device} but lhs is on {lhs.device}")
    if lhs.ndim != 2 or rhs.ndim != 2 or lhs.shape[1] != rhs.shape[0] or block_rows.shape != block_cols.shape:
        raise ValueError(f"bsr_sddmm: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} do not contract")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"lhs ({lhs.dtype}) and rhs ({rhs.dtype}) must share one dtype")
    _cuda.check_bsr_dtype(lhs.dtype)
    if lhs.device.type == "cpu":
        return bsr_sddmm_plain(block_rows, block_cols, lhs, rhs, block_shape=block_shape)
    _cuda.require_cuda(lhs.device, "BSR")
    bm, bn = block_shape
    out = torch.empty((block_rows.shape[0], bm, bn), dtype=lhs.dtype, device=lhs.device)
    rows, cols = block_rows.to(torch.int32).contiguous(), block_cols.to(torch.int32).contiguous()
    if lhs.dtype not in _cuda.TC_DTYPES:
        return _cuda.bsr_sddmm(rows, cols, lhs, rhs, out)
    return _cuda.bsr_sddmm_tc(rows, cols, _sddmm_tc_operand(lhs, 0), _sddmm_tc_operand(rhs, 1), out)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matmuls at full precision (no TF32 pass) inside; the caller's
    ``torch.backends.cuda.matmul.allow_tf32`` is restored on the way out."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _bsr_spmm_vjp(block_rows, block_cols, blocks, dense, g):
    """The VJP of ``A @ dense`` (what XLA derives from ``bsr_spmm_xla``):
    ``d_blocks[j] = g[rows[j]-block] @ dense[cols[j]-block]ᵀ``, the block
    SDDMM :func:`bsr_sddmm_kernel`, and ``d_dense[cols[j]-block] +=
    blocks[j]ᵀ @ g[rows[j]-block]`` as a torch ``bmm`` whose float32
    products stay at full precision whatever the caller's TF32 setting."""
    _, bm, bn = blocks.shape
    d_blocks = bsr_sddmm_kernel(block_rows, block_cols, g, dense.T, block_shape=(bm, bn))
    g_rows = _gather_row_blocks(g, block_rows, bm)  # (n_blocks, bm, N)
    with _full_f32_matmul():
        prods = torch.bmm(blocks.transpose(1, 2), g_rows)
    d_dense = torch.zeros_like(dense, memory_format=torch.contiguous_format)
    _add_row_blocks(d_dense, block_cols, prods)
    return d_blocks, d_dense


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_rows, block_cols, blocks, dense, n_rows, row_ptr):
        ctx.save_for_backward(block_rows, block_cols, blocks, dense)
        return bsr_spmm_kernel(block_rows, block_cols, blocks, dense, n_rows=n_rows, row_ptr=row_ptr)

    @staticmethod
    def backward(ctx, g):
        block_rows, block_cols, blocks, dense = ctx.saved_tensors
        d_blocks, d_dense = _bsr_spmm_vjp(block_rows, block_cols, blocks, dense, g)
        return None, None, d_blocks, d_dense, None, None


def bsr_spmm(block_rows, block_cols, blocks, dense, n_rows, row_ptr=None):
    """Differentiable BSR SpMM: kernel forward, backward as torch ops (the
    XLA-derived VJP of ``sparse_tpu.kernels.bsr.bsr_spmm``)."""
    return _BsrSpmm.apply(block_rows, block_cols, blocks, dense, n_rows, row_ptr)


def transposed_blocks(blocks, t_perm):
    """``blocks_t`` of the transposed layout: ``blocks[t_perm[j]]ᵀ``, zero
    where ``t_perm[j] == -1``, gathered into a contiguous (K-major) tensor
    in one pass, as the tensor-core SpMM reads it."""
    gathered = blocks.transpose(1, 2).index_select(0, t_perm.clamp(min=0)).contiguous()
    return gathered.masked_fill_((t_perm < 0)[:, None, None], 0)


class _BsrSpmmTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_rows, block_cols, t_rows, t_cols, t_perm, blocks, dense, n_rows, n_cols, row_ptr, t_row_ptr):
        ctx.save_for_backward(block_rows, block_cols, t_rows, t_cols, t_perm, blocks, dense)
        ctx.sizes = (n_cols, t_row_ptr)
        return bsr_spmm_kernel(block_rows, block_cols, blocks, dense, n_rows=n_rows, row_ptr=row_ptr)

    @staticmethod
    def backward(ctx, g):
        block_rows, block_cols, t_rows, t_cols, t_perm, blocks, dense = ctx.saved_tensors
        n_cols, t_row_ptr = ctx.sizes
        blocks_t = transposed_blocks(blocks, t_perm)
        d_dense = bsr_spmm_kernel(t_rows, t_cols, blocks_t, g, n_rows=n_cols, row_ptr=t_row_ptr)
        d_blocks = bsr_sddmm_kernel(block_rows, block_cols, g, dense.T, block_shape=tuple(blocks.shape[1:]))
        return None, None, None, None, None, d_blocks, d_dense, None, None, None, None


def bsr_spmm_trainable(
    block_rows, block_cols, t_rows, t_cols, t_perm, blocks, dense, n_rows, n_cols, row_ptr=None, t_row_ptr=None
):
    """Fully kernelized differentiable BSR SpMM: kernel forward, kernel
    backward — dgrad through the transposed layout
    (:func:`transpose_bsr_layout`) on :func:`bsr_spmm_kernel`, wgrad through
    :func:`bsr_sddmm_kernel`. ``row_ptr``/``t_row_ptr`` (device tensors from
    :func:`block_row_ptr`) save a host pass per call."""
    return _BsrSpmmTrainable.apply(
        block_rows, block_cols, t_rows, t_cols, t_perm, blocks, dense, n_rows, n_cols, row_ptr, t_row_ptr
    )
