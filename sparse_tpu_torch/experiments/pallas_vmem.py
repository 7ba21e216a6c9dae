"""The VMEM gather probes p1-p4 of ``experiments/pallas_vmem.py`` on the card.

The Pallas probes measure random reads from a table resident in the TPU's
VMEM: p1 the sublane gather of ``take_along_axis`` (E3), p2 a loop of
per-row dynamic loads summed per segment (E4), p3 the one-hot MXU row pick
with bf16 operands (E5), p4 a loop of scalar loads at SMEM-held indices
summed per segment (E6). Here each function launches its CUDA kernel
(``kernels/csrc/probes.cu``) for CUDA tensors and runs its plain PyTorch
version for CPU tensors. p2 and p4 read their table from global memory,
where it stays in the card's L2, so their runners measure the L2 gather
rates; p1 holds 32-lane column slices of its table in shared memory when
they fit (its 512 rows do, p1b's 8192 do not), p3 its strip, rounded to
bf16, and its runner measures the card's write path.

Each runner keeps the probe's parameters and defaults, draws its inputs from
the same seeds in the same order, runs the probe's own spot check (a failure
raises), and returns a :class:`~.common.Run` with its outputs and, on the
card, its device time and rate in the probe's unit.

    python -m sparse_tpu_torch.experiments.pallas_vmem [p1|p1b|p2|p3|p4|all]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .._settings import resolve_device
from ..kernels import _cuda
from .common import Run, check_float_table, check_indices, check_int, n_segments, report, time_on_card


# ---------------------------------------------------------------- p1 (E3)
def lane_gather_plain(table, idx):
    """``out[i, l] = table[idx[i, l], l]`` by advanced indexing."""
    return table[idx.long(), torch.arange(table.shape[1], device=idx.device)]


def lane_gather(table, idx):
    """``out[i, l] = table[idx[i, l], l]``: float32 ``table`` ``(rows, 128)``,
    int32 ``idx`` ``(n, 128)``; the function of p1's Pallas kernel
    (``jnp.take_along_axis(table, idx, axis=0)``)."""
    check_float_table("table", table, idx.device)
    check_int("idx", idx, 2)
    if idx.shape[1] != table.shape[1]:
        raise ValueError(f"idx of shape {tuple(idx.shape)} against a table of width {table.shape[1]}")
    check_indices("idx", idx, table.shape[0])
    if idx.device.type == "cpu":
        return lane_gather_plain(table, idx)
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    return _cuda.lane_gather(table, idx, out)


def p1(table_h=512, n_idx_rows=18432, blk=512, label="p1", device=None):
    """take_along_axis from a (table_h, 128) table: the capability call on
    (8, 128), then the full gather, timed on the card (G gathers/s)."""
    dev = resolve_device(device)
    n_segments(label, n_idx_rows, blk)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.random((table_h, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, table_h, size=(n_idx_rows, 128), dtype=np.int32), device=dev)

    h = min(table_h, 512)
    small = lane_gather(table[:h], idx[:8] % h)
    tb, ib = table[:h].cpu().numpy(), (idx[:8] % h).cpu().numpy()
    np.testing.assert_allclose(small.cpu().numpy(), tb[ib, np.arange(128)[None, :]], err_msg=f"{label} capability")

    out = lane_gather(table, idx)
    ms = time_on_card(dev, lambda: _cuda.lane_gather(table, idx, out))
    return Run(label, {"table": table, "idx": idx}, (small, out), n_idx_rows * 128, "G gathers/s", ms)


# ---------------------------------------------------------------- p2 (E4)
def row_gather_sum_plain(strip, idx, per_step):
    """``out[g] = Σ_{w < per_step} strip[idx[g · per_step + w], :]``."""
    return strip[idx.long()].view(-1, per_step, strip.shape[1]).sum(1)


def row_gather_sum(strip, idx, per_step):
    """Sums of the strip rows picked by each run of ``per_step`` indices:
    float32 ``strip`` ``(rows, 128)``, int32 ``idx`` ``(n,)`` → ``(n /
    per_step, 128)``; the function of p2's Pallas kernel (a ``fori_loop`` of
    ``acc += strip[pl.ds(idx[w], 1), :]``)."""
    check_float_table("strip", strip, idx.device)
    check_int("idx", idx, 1)
    n_seg = n_segments("row_gather_sum", idx.shape[0], per_step)
    check_indices("idx", idx, strip.shape[0])
    if idx.device.type == "cpu":
        return row_gather_sum_plain(strip, idx, per_step)
    strip, idx = strip.contiguous(), idx.contiguous()
    out = torch.empty((n_seg, strip.shape[1]), dtype=torch.float32, device=idx.device)
    return _cuda.row_gather_sum(strip, idx, out, per_step)


def p2(strip_h=8192, n_loads=131072, per_step=1024, device=None):
    """Per-row dynamic loads from a (strip_h, 128) strip, summed per run of
    per_step, timed on the card (M rows/s)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    strip = torch.as_tensor(rng.random((strip_h, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, strip_h, size=(n_loads,), dtype=np.int32), device=dev)

    out = row_gather_sum(strip, idx, per_step)
    exp = strip.cpu().numpy()[idx[:per_step].cpu().numpy()].sum(axis=0)  # spot check: the first run
    np.testing.assert_allclose(out[0].cpu().numpy(), exp, rtol=1e-4, err_msg="p2")
    ms = time_on_card(dev, lambda: _cuda.row_gather_sum(strip, idx, out, per_step))
    return Run("p2", {"strip": strip, "idx": idx}, (out,), n_loads, "M rows/s", ms)


# ---------------------------------------------------------------- p3 (E5)
def row_pick_bf16_plain(strip, idx):
    """``out[e] = f32(bf16(strip))[idx[e], :]``."""
    return strip.to(torch.bfloat16).float()[idx.long()]


def row_pick_bf16(strip, idx):
    """The strip's rows at ``idx``, rounded to bf16 (to nearest even) and
    back to float32: float32 ``strip`` ``(rows, 128)``, int32 ``idx``
    ``(n,)`` → ``(n, 128)``; the function of p3's Pallas kernel (the one-hot
    MXU pick ``onehot(idx) @ strip.astype(bf16)``, exact in f32)."""
    check_float_table("strip", strip, idx.device)
    check_int("idx", idx, 1)
    check_indices("idx", idx, strip.shape[0])
    if idx.device.type == "cpu":
        return row_pick_bf16_plain(strip, idx)
    strip, idx = strip.contiguous(), idx.contiguous()
    out = torch.empty((idx.shape[0], strip.shape[1]), dtype=torch.float32, device=idx.device)
    return _cuda.row_pick_bf16(strip, idx, out)


def p3(strip_h=512, n_entries=1 << 21, blk=1024, dtype=torch.bfloat16, device=None):
    """The one-hot row pick from a (strip_h, 128) strip with bf16 operands,
    timed on the card (M rows/s). Only ``dtype=torch.bfloat16``, the
    probe's setting, has a kernel."""
    if dtype != torch.bfloat16:
        raise ValueError(f"p3 runs the bf16 pick only, not {dtype}")
    dev = resolve_device(device)
    n_segments("p3", n_entries, blk)
    rng = np.random.default_rng(2)
    strip = torch.as_tensor(rng.random((strip_h, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, strip_h, size=(n_entries,), dtype=np.int32), device=dev)

    out = row_pick_bf16(strip, idx)
    exp = strip.cpu().numpy()[idx[:4].cpu().numpy()]  # spot check: the first 4 picks, to bf16's grade
    np.testing.assert_allclose(out[:4].cpu().numpy(), exp, rtol=1e-2, err_msg="p3")
    ms = time_on_card(dev, lambda: _cuda.row_pick_bf16(strip, idx, out))
    return Run("p3", {"strip": strip, "idx": idx}, (out,), n_entries, "M rows/s", ms)


# ---------------------------------------------------------------- p4 (E6)
def scalar_gather_sum_plain(x, qi, qj, per_step):
    """``out[g, 0] = Σ_{w < per_step} x[qi[g · per_step + w], qj[...]]``."""
    return x[qi.long(), qj.long()].view(-1, per_step).sum(1, keepdim=True)


def scalar_gather_sum(x, qi, qj, per_step):
    """Sums of the scalars ``x[qi[w], qj[w]]`` over each run of ``per_step``
    loads: float32 ``x`` ``(rows, cols)``, int32 ``qi``/``qj`` ``(n,)`` →
    ``(n / per_step, 1)``; the function of p4's Pallas kernel."""
    check_float_table("x", x, qi.device)
    check_int("qi", qi, 1)
    check_int("qj", qj, 1)
    if qj.shape != qi.shape or qj.device != qi.device:
        raise ValueError("qi and qj differ in shape or device")
    n_seg = n_segments("scalar_gather_sum", qi.shape[0], per_step)
    check_indices("qi", qi, x.shape[0])
    check_indices("qj", qj, x.shape[1])
    if qi.device.type == "cpu":
        return scalar_gather_sum_plain(x, qi, qj, per_step)
    x, qi, qj = x.contiguous(), qi.contiguous(), qj.contiguous()
    out = torch.empty((n_seg, 1), dtype=torch.float32, device=qi.device)
    return _cuda.scalar_gather_sum(x, qi, qj, out, per_step)


def p4(n_loads=65536, per_step=1024, device=None):
    """Scalar loads from a (512, 128) table at random (row, column) pairs,
    summed per run of per_step, timed on the card (M loads/s)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.random((512, 128), dtype=np.float32), device=dev)
    qi = torch.as_tensor(rng.integers(0, 512, size=(n_loads,), dtype=np.int32), device=dev)
    qj = torch.as_tensor(rng.integers(0, 128, size=(n_loads,), dtype=np.int32), device=dev)

    out = scalar_gather_sum(x, qi, qj, per_step)
    exp = x.cpu().numpy()[qi[:per_step].cpu().numpy(), qj[:per_step].cpu().numpy()].sum()
    np.testing.assert_allclose(out[0, 0].item(), exp, rtol=1e-4, err_msg="p4")
    ms = time_on_card(dev, lambda: _cuda.scalar_gather_sum(x, qi, qj, out, per_step))
    return Run("p4", {"x": x, "qi": qi, "qj": qj}, (out,), n_loads, "M loads/s", ms)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("p1", "all"):
        report(p1(512, label="p1(512)"))
    if which in ("p1b", "all"):
        report(p1(8192, label="p1b(8192)"))
    if which in ("p2", "all"):
        report(p2())
    if which in ("p3", "all"):
        report(p3())
    if which in ("p4", "all"):
        report(p4())
