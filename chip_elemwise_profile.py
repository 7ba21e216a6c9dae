#!/usr/bin/env python3
"""Where the time of the element-wise operations and reductions goes, on
one NVIDIA GPU.

    python3 chip_elemwise_profile.py

Builds the operands of ``chip_smoke.py``'s ``elemwise_path`` phase (the
benchmark matrix ``a``, a second draw ``b``, a dense row ``d``, a sparse
column ``r``, the MTTKRP tensor ``t``) and runs each operation three times
under ``torch.profiler`` (CPU and CUDA activities) after one warm call.
Prints one JSON line an operation: the wall ms a call (host clock around
the three calls, synchronised), the device ms a call (the CUDA kernels'
self time), the share of the wall time the device is busy, and the five
kernels with the most device time. Last, the card's ``nvidia-smi``
``name, power.limit`` line. Imports nothing of JAX or sparse_tpu; exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

REPS = 3


def profile(fn):
    """``(wall ms, device ms, top kernels)`` a call of ``fn``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / REPS
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / REPS
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return wall, device, [(e.key[:90], e.self_device_time_total / 1e3 / REPS, e.count // REPS) for e in top]


def main():
    if not torch.cuda.is_available():
        print("chip_elemwise_profile: no CUDA device available", file=sys.stderr)
        return 2
    import sparse_tpu_torch as st
    from chip_smoke import K, M, MT_DRAWS, MT_I, MT_J, MT_K, NNZ_DRAWS, R_ROWS, nvidia_smi_name_power

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    a = st.COO(np.stack([lin // K, lin % K]), rng.random(NNZ_DRAWS, dtype=np.float32), shape=(M, K), device=dev)
    rng = np.random.default_rng(7)
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    b = st.COO(np.stack([lin // K, lin % K]), rng.random(NNZ_DRAWS, dtype=np.float32), shape=(M, K), device=dev)
    d = torch.as_tensor(rng.random(K, dtype=np.float32), device=dev)
    r_rows = np.sort(rng.choice(M, size=R_ROWS, replace=False))
    r = st.COO(np.stack([r_rows, np.zeros(R_ROWS, np.int64)]), rng.random(R_ROWS, dtype=np.float32), shape=(M, 1), device=dev)
    csr = a.asformat("csr")
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, MT_I * MT_J * MT_K, size=MT_DRAWS, dtype=np.int64))
    t = st.COO(
        np.stack([lin // (MT_J * MT_K), (lin // MT_K) % MT_J, lin % MT_K]),
        rng.random(lin.size, dtype=np.float32),
        shape=(MT_I, MT_J, MT_K),
        device=dev,
    )
    ops = {
        "a + b": lambda: a + b,
        "a > b": lambda: a > b,
        "a * d[None, :]": lambda: a * d[None, :],
        "a + r": lambda: a + r,
        "sin(a)": lambda: np.sin(a),
        "a.sum()": lambda: a.sum(),
        "a.sum(axis=0)": lambda: a.sum(axis=0),
        "a.sum(axis=1)": lambda: a.sum(axis=1),
        "a.max(axis=1)": lambda: a.max(axis=1),
        "csr.sum(axis=1)": lambda: csr.sum(axis=1),
        "t.sum(axis=(1, 2))": lambda: t.sum(axis=(1, 2)),
        "t.sum(axis=0)": lambda: t.sum(axis=0),
        "t.max(axis=2)": lambda: t.max(axis=2),
    }
    card = nvidia_smi_name_power()
    for name, fn in ops.items():
        wall, device, top = profile(fn)
        line = {"op": name, "wall_ms": wall, "device_ms": device, "busy_share": device / wall if wall else None, "top_kernels": top}
        print(json.dumps(line), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
