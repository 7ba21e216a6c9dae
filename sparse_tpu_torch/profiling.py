"""Timing and tracing helpers (``sparse_tpu.profiling``'s names).

- :func:`benchmark`: seconds per call. For tensors on the GPU, CUDA events
  around ``iters`` eager calls after ``warmup`` calls: the device's time
  from the first launch to the last. For tensors on the CPU, the host's
  ``perf_counter`` around the same loop.
- :func:`nnz_throughput`: stored entries per second.
- :func:`trace`: ``torch.profiler`` around a block of work, written as a
  Chrome trace into ``log_dir``.
- :func:`compiled`: ``torch.compile``.

``benchmark`` times eager calls, not a CUDA graph: a function that reads a
value back to the host cannot be captured in one.
``experiments/common.py:time_graph`` stays the timer of single kernels.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def _map_tensors(fn, tree):
    """``fn`` applied to every tensor of nested tuples, lists and dicts;
    other leaves (sparse arrays among them) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return tree


def _default_perturb(args, i):
    """``i * 1e-6`` added to every floating tensor of ``args``, as the
    reference adds it inside its scan so that no call reads the same inputs."""

    def bump(t):
        return t + i * 1e-6 if t.is_floating_point() else t

    return _map_tensors(bump, args)


def _device_of(args):
    found = []
    _map_tensors(found.append, args)
    return found[0].device if found else torch.device("cpu")


def benchmark(fn, args, iters=50, warmup=1, perturb=_default_perturb):
    """Seconds per call of ``fn(*args)``.

    ``warmup`` calls first (at least one), then ``iters`` calls, each on
    ``perturb(args, i)`` (by default ``i * 1e-6`` added to every floating
    tensor, inside the timed window as in the reference's scan; ``None``
    times the same inputs every call). Where the first tensor of ``args``
    lies on the GPU, the time is CUDA events' from before the first of the
    ``iters`` calls to after the last, on the current stream; else the
    host's ``perf_counter`` around them."""
    if perturb is None:
        perturb = lambda a, i: a  # noqa: E731
    for _ in range(max(warmup, 1)):
        fn(*args)
    device = _device_of(args)
    if device.type == "cuda":
        with torch.cuda.device(device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(*perturb(args, i))
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*perturb(args, i))
    return (time.perf_counter() - t0) / iters


def nnz_throughput(seconds_per_call, nnz):
    """Stored entries per second for a kernel timing."""
    return nnz / seconds_per_call


@contextlib.contextmanager
def trace(log_dir=None):
    """``torch.profiler`` (the CPU, and CUDA where a card is present) around
    a block of work; on exit its Chrome trace is written to
    ``log_dir/trace.json`` (``log_dir`` defaults to ``sparse_tpu_torch_trace``
    under the temporary directory). Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "sparse_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def compiled(fn, **jit_kwargs):
    """``torch.compile(fn, **jit_kwargs)``: the counterpart of the reference's
    ``jax.jit``. The function must stay within what ``torch.compile`` can
    trace: the fixed-size kernels of ``sparse_tpu_torch.kernels`` and
    ``jitops`` on tensors; functions that read sizes back to the host break
    the graph and run eagerly."""
    return torch.compile(fn, **jit_kwargs)
