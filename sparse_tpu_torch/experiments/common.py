"""The timer and the result type of the experiment runners.

The Pallas experiments time themselves on the TPU with a scan loop over a
perturbed table, minus a measured host round trip. That method is the
TPU's. On the card a kernel is timed with CUDA events around the replay of a
CUDA graph that holds many launches, with the L2 warm from the warm-up
launches: the warm L2 stands in for the TPU's VMEM-resident table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _cuda

# time_graph calls fn this many times before it captures the timed launches
WARMUP = 3
REPS = 50


def time_graph(fn, reps=REPS):
    """Device ms per call of ``fn`` (a bare kernel launch, or torch ops that
    never synchronize), from CUDA events around the replay of a graph
    holding ``reps`` calls: no host overhead. ``fn`` is called ``WARMUP +
    reps`` times from Python."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def time_on_card(device, fn):
    """``time_graph(fn)`` on a CUDA device; None on the CPU, where no device
    time exists."""
    return time_graph(fn) if device.type == "cuda" else None


_SCALE = {"G": 1e9, "M": 1e6}


class Run(NamedTuple):
    """One run of an experiment runner: its ``inputs`` (name → tensor, as drawn), ``outputs``
    (the kernel's on the card, the plain version's on the CPU), the count
    ``n`` of the experiment's unit, and the device ms per call (None on the
    CPU)."""

    label: str
    inputs: dict
    outputs: tuple
    n: int
    unit: str  # "G gathers/s", "M rows/s" or "M loads/s", as the experiment prints
    ms: float | None

    @property
    def rate(self):
        """``n`` per second in ``unit`` (None without a device time)."""
        if self.ms is None:
            return None
        return self.n / (self.ms * 1e-3) / _SCALE[self.unit[0]]


def check_indices(name, idx, n):
    """Raise ``IndexError`` unless every index lies in ``[0, n)`` (the
    kernels read without bounds checks; one flag is read back). A tensor
    neither on the CPU nor on a CUDA device raises ``ValueError`` first:
    only the CPU takes the plain versions, only CUDA the kernels."""
    if idx.device.type != "cpu":
        _cuda.require_cuda(idx.device, "probe")
    if idx.numel() and bool(((idx < 0) | (idx >= n)).any()):
        raise IndexError(f"{name} holds an index outside [0, {n})")


def check_float_table(name, t, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.ndim != 2:
        raise TypeError(f"{name} must be a 2-D float32 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, its indices on {device}")


def check_int(name, t, ndim):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.ndim != ndim:
        raise TypeError(f"{name} must be a {ndim}-D int32 tensor")


def n_segments(name, n, seg_len):
    """``n / seg_len``; ``ValueError`` unless ``seg_len`` divides ``n``."""
    if seg_len <= 0 or n % seg_len:
        raise ValueError(f"{name}: {n} indices do not split into segments of {seg_len}")
    return n // seg_len


def report(run):
    """Print a run as the experiment printed its probe."""
    rate = "not timed (CPU)" if run.ms is None else f"{run.ms:.6f} ms = {run.rate:.2f} {run.unit}"
    print(f"{run.label}: n={run.n} {rate}", flush=True)
