"""The matched-shape gather probes g1-g3 of ``experiments/pallas_vmem2.py``
on the card.

g1 (E7) gathers per lane from a (T, 128) table and sums each block of T
index rows; g2 (E8) picks whole table rows and sums each block of T picks;
g3 (E9) is the inner loop of an SpMM cell: W weighted row picks per row of a
(T, W) layout, accumulated over W, the cell's (T, 128) accumulator folded
as ``acc.reshape(64, 128, 128).sum(0)[:8]``. Each Pallas kernel stores its
block's result in one (8, 128) output tile, g1 and g2 as 8 identical rows;
the port keeps those shapes. Each function launches its CUDA kernel
(``kernels/csrc/probes.cu``) for CUDA tensors and runs its plain PyTorch
version for CPU tensors. g1 reads its table from 32-lane column slices
held in shared memory, one a CTA (a table of up to 1,792 rows; a taller one,
g1b's, through L2); g3 reads the table through L2; g2 reads it from row
slices held in shared memory, one a CTA, as the Pallas kernel picks from its
VMEM-resident table: each block's picks of a slice's rows are counted, and
the counts multiplied with the slice.

Each runner keeps the probe's parameters and defaults, draws its inputs from
the same seeds in the same order, runs the probe's own spot check (a failure
raises), and returns a :class:`~.common.Run`.

    python -m sparse_tpu_torch.experiments.pallas_vmem2 [g1|g1b|g2|g3|all]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .._settings import resolve_device
from ..kernels import _cuda
from .common import Run, check_float_table, check_indices, check_int, n_segments, report, time_on_card


def _tile8(sums):
    """Each row of ``sums`` repeated 8 times: the probes' (8, 128) tiles."""
    return sums.unsqueeze(1).expand(-1, 8, -1).reshape(-1, sums.shape[-1])


# ---------------------------------------------------------------- g1 (E7)
def lane_gather_blocksum_plain(table, idx, T):
    """Column sums of ``table[idx[i, l], l]`` over each block of ``T`` rows,
    each in 8 identical rows."""
    picked = table[idx.long(), torch.arange(table.shape[1], device=idx.device)]
    return _tile8(picked.view(-1, T, table.shape[1]).sum(1))


def lane_gather_blocksum(table, idx, T):
    """``out[8b + c, l] = Σ_{t < T} table[idx[bT + t, l], l]`` for ``c < 8``:
    float32 ``table`` ``(rows, 128)``, int32 ``idx`` ``(n_blocks · T, 128)``
    → ``(n_blocks · 8, 128)``; the function of g1's Pallas kernel."""
    check_float_table("table", table, idx.device)
    check_int("idx", idx, 2)
    if idx.shape[1] != table.shape[1]:
        raise ValueError(f"idx of shape {tuple(idx.shape)} against a table of width {table.shape[1]}")
    n_blocks = n_segments("lane_gather_blocksum", idx.shape[0], T)
    check_indices("idx", idx, table.shape[0])
    if idx.device.type == "cpu":
        return lane_gather_blocksum_plain(table, idx, T)
    table, idx = table.contiguous(), idx.contiguous()
    out, partial, tickets = _blocksum_buffers(n_blocks, T, table.shape[0], idx.device)
    return _cuda.lane_gather_blocksum(table, idx, T, out, partial, tickets)


def _blocksum_buffers(n_blocks, T, rows, device):
    """The output and the kernel's scratch for a table of ``rows`` rows
    (partial rows and zeroed tickets on the L2 route, none on the slice
    route: ``_cuda.lane_blocksum_scratch``)."""
    out = torch.empty((n_blocks * 8, _cuda.PROBE_LANES), dtype=torch.float32, device=device)
    return (out, *_cuda.lane_blocksum_scratch(rows, n_blocks, T, device))


def g1(T=512, n_blocks=36, label="g1", device=None):
    """Per-lane gather from a (T, 128) table, summed per block of T index
    rows, timed on the card (G gathers/s)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.random((T, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, T, size=(n_blocks * T, 128), dtype=np.int32), device=dev)

    out = lane_gather_blocksum(table, idx, T)
    tb, ib = table.cpu().numpy(), idx[:T].cpu().numpy()  # spot check: the first block
    np.testing.assert_allclose(out[0].cpu().numpy(), tb[ib, np.arange(128)[None, :]].sum(axis=0), rtol=1e-4, err_msg=label)
    ms = None
    if dev.type == "cuda":
        _, partial, tickets = _blocksum_buffers(n_blocks, T, T, dev)
        ms = time_on_card(dev, lambda: _cuda.lane_gather_blocksum(table, idx, T, out, partial, tickets))
    return Run(label, {"table": table, "idx": idx}, (out,), n_blocks * T * 128, "G gathers/s", ms)


# ---------------------------------------------------------------- g2 (E8)
def row_pick_blocksum_plain(table, cols, T):
    """Sums of the table rows picked by each block of ``T`` columns, each in
    8 identical rows."""
    return _tile8(table[cols.long()].view(-1, T, table.shape[1]).sum(1))


def row_pick_blocksum(table, cols, T):
    """``out[8b + c] = Σ_{t < T} table[cols[bT + t], :]`` for ``c < 8``:
    float32 ``table`` ``(rows, 128)``, int32 ``cols`` ``(n_blocks · T,)`` →
    ``(n_blocks · 8, 128)``; the function of g2's Pallas kernel (a
    broadcast-index ``take_along_axis`` picking whole rows)."""
    check_float_table("table", table, cols.device)
    check_int("cols", cols, 1)
    n_blocks = n_segments("row_pick_blocksum", cols.shape[0], T)
    check_indices("cols", cols, table.shape[0])
    if cols.device.type == "cpu":
        return row_pick_blocksum_plain(table, cols, T)
    table, cols = table.contiguous(), cols.contiguous()
    out = torch.empty((n_blocks * 8, table.shape[1]), dtype=torch.float32, device=cols.device)
    return _cuda.row_pick_blocksum(table, cols, out, T)


def g2(T=8192, n_blocks=285, label="g2", device=None):
    """Full-row picks from a (T, 128) f32 table (4 MB at T = 8192), summed
    per block of T picks; n_blocks · T ≈ 2.33M, the bench-scale pick count.
    Timed on the card (M rows/s)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    table = torch.as_tensor(rng.random((T, 128), dtype=np.float32), device=dev)
    cols = torch.as_tensor(rng.integers(0, T, size=(n_blocks * T,), dtype=np.int32), device=dev)

    out = row_pick_blocksum(table, cols, T)
    exp = table.cpu().numpy()[cols[:T].cpu().numpy()].sum(axis=0)
    np.testing.assert_allclose(out[0].cpu().numpy(), exp, rtol=1e-4, err_msg=label)
    ms = None
    if dev.type == "cuda":
        n_slices = _cuda.row_pick_count_plan(T).n_slices
        partial = torch.empty((n_blocks, n_slices, _cuda.PROBE_LANES), dtype=torch.float32, device=dev)
        tickets = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
        ms = time_on_card(dev, lambda: _cuda.row_pick_blocksum(table, cols, out, T, partial, tickets))
    return Run(label, {"table": table, "cols": cols}, (out,), n_blocks * T, "M rows/s", ms)


# ---------------------------------------------------------------- g3 (E9)
def pick_scale_wsum_plain(table, cols2, data2):
    """``acc = Σ_w data2[..., w] · table[cols2[..., w]]`` per cell, folded
    as ``acc.reshape(64, 128, 128).sum(0)[:8]``."""
    acc = (table[cols2.long()] * data2.unsqueeze(-1)).sum(2)  # (n_cells, T, 128)
    folded = acc.view(-1, _cuda.G3_FOLD, _cuda.G3_ROWS, table.shape[1]).sum(1)
    return folded[:, : _cuda.G3_KEEP].reshape(-1, table.shape[1])


def pick_scale_wsum(table, cols2, data2):
    """Per cell ``i``: ``acc[t] = Σ_{w < W} data2[i, t, w] ·
    table[cols2[i, t, w], :]`` for ``t < 8192``, and ``out[8i + r] =
    Σ_{g < 64} acc[128g + r]`` for ``r < 8``: float32 ``table`` ``(rows,
    128)``, int32 ``cols2`` and float32 ``data2`` ``(n_cells, 8192, W)`` →
    ``(n_cells · 8, 128)``; the function of g3's Pallas kernel."""
    check_float_table("table", table, cols2.device)
    check_int("cols2", cols2, 3)
    if not isinstance(data2, torch.Tensor) or data2.dtype != torch.float32 or data2.shape != cols2.shape:
        raise TypeError("data2 must be a float32 tensor of cols2's shape")
    if data2.device != cols2.device:
        raise ValueError(f"data2 is on {data2.device}, cols2 on {cols2.device}")
    if cols2.shape[1] != _cuda.G3_T or table.shape[1] != _cuda.G3_ROWS:
        raise ValueError(f"the fold acc.reshape(64, 128, 128) takes T = {_cuda.G3_T} rows of width 128")
    check_indices("cols2", cols2, table.shape[0])
    if cols2.device.type == "cpu":
        return pick_scale_wsum_plain(table, cols2, data2)
    table, cols2, data2 = table.contiguous(), cols2.contiguous(), data2.contiguous()
    out = torch.empty((cols2.shape[0] * _cuda.G3_KEEP, table.shape[1]), dtype=torch.float32, device=cols2.device)
    return _cuda.pick_scale_wsum(table, cols2, data2, out)


def g3(T=8192, W=4, n_cells=285, label="g3", device=None):
    """Row pick + scale + W-accumulate, the SpMM cell's inner loop: n_cells
    // W cells of T × W weighted picks from a (T, 128) table, timed on the
    card (M rows/s). T must be 8192, as the Pallas kernel's fold demands.
    The rate counts the picks the output needs: the 8 kept rows of each
    cell's fold add 64 · W picks each, 1/16 of the cell's T · W."""
    if T != _cuda.G3_T:
        raise ValueError(f"g3 takes T = {_cuda.G3_T} only: its fold acc.reshape(64, 128, 128) fixes T (got {T})")
    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.random((T, 128), dtype=np.float32), device=dev)
    cols2 = torch.as_tensor(rng.integers(0, T, size=(n_cells // W, T, W), dtype=np.int32), device=dev)
    data2 = torch.as_tensor(rng.random((n_cells // W, T, W), dtype=np.float32), device=dev)

    out = pick_scale_wsum(table, cols2, data2)
    tb, cb, db = table.cpu().numpy(), cols2[0].cpu().numpy(), data2[0].cpu().numpy()  # spot check: cell 0
    acc = np.zeros((T, 128), np.float32)
    for w in range(W):
        acc += tb[cb[:, w]] * db[:, w][:, None]
    np.testing.assert_allclose(out[:8].cpu().numpy(), acc.reshape(64, 128, 128).sum(axis=0)[:8], rtol=1e-3, err_msg=label)
    ms = time_on_card(dev, lambda: _cuda.pick_scale_wsum(table, cols2, data2, out))
    n = (n_cells // W) * _cuda.G3_KEEP * _cuda.G3_FOLD * W
    return Run(label, {"table": table, "cols2": cols2, "data2": data2}, (out,), n, "M rows/s", ms)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("g1", "all"):
        report(g1(512, n_blocks=36))
    if which in ("g1b", "all"):
        report(g1(8192, n_blocks=4, label="g1b"))
    if which in ("g2", "all"):
        report(g2())
    if which in ("g3", "all"):
        report(g3())
