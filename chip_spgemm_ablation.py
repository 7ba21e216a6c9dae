#!/usr/bin/env python3
"""S1, the SpGEMM kernel's two passes, at the shape ``chip_smoke.py``'s
``spgemm_path`` runs it at, on one NVIDIA GPU (H100), with the numeric
pass's cycles counted by step.

    python3 chip_spgemm_ablation.py

The shape: ``a @ a`` of the bench matrix (65,536², 2^21 uniform draws of
seed 0, 2,096,628 entries, 6.7e7 products, one chunk of columns), in
float32 and float64. For each dtype: the port's passes
(``chip_smoke.s1_pass_ms``: device ms of each pass, median of 5, CUDA
events around each), then ``csrc/spgemm.cu`` built with ``SPGEMM_PROFILE=1``
into ``build/spgemm_ablation/`` and bound here by ctypes, whose numeric
pass counts its cycles by step (``clock64`` on each CTA's thread 0,
between its barriers) on the port's symbolic pass's row pointer: each
step's share, and its output equal to the port's bit for bit. One JSON
line a dtype and run, then the card's ``name, power.limit``. Imports
nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BUILD = Path(__file__).resolve().parent / "build" / "spgemm_ablation"
STEPS = ("waiting for a row", "step 1: the bitmap", "step 2: the scan", "step 3: the ordered walk", "step 4: the output")


def build_profile():
    """``csrc/spgemm.cu`` with ``SPGEMM_PROFILE=1``, loaded and bound."""
    from sparse_tpu_torch.kernels import _cuda

    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "profile.so"
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-DSPGEMM_PROFILE=1", "-o", str(so), str(_cuda.SOURCES["spgemm"])]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _cuda._SIGNATURES["spgemm"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.st_spgemm_profile.argtypes, lib.st_spgemm_profile.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def step_cycles(lib, a, want_out, want_vals):
    """The profiled build's numeric pass on ``a @ a``: each step's share of
    the cycles its CTAs' thread 0 spent, and the chunks it took; its output
    must equal the port's (``want_out``, ``want_vals``) bit for bit."""
    from chip_smoke import K, M
    from sparse_tpu_torch.kernels import _cuda
    from sparse_tpu_torch.kernels import spgemm as kspgemm

    ops = kspgemm.s1_operands(*a.coords, a.data, *a.coords, a.data, m=M, k=K, n=K, dt=a.data.dtype)
    row_ptr = kspgemm.s1_symbolic(ops)
    out, vals = torch.empty_like(want_out), torch.empty_like(want_vals)
    scratch = torch.zeros(2, dtype=torch.int64, device=vals.device)
    plan = _cuda.spgemm_plan(K, vals.dtype)
    suffix = {torch.float32: "f32", torch.float64: "f64"}[vals.dtype]
    fn = getattr(lib, f"st_spgemm_numeric_{suffix}_i32_{'o32' if out.dtype == torch.int32 else 'o64'}")
    buf = (ctypes.c_ulonglong * 6)()
    if lib.st_spgemm_profile(ctypes.addressof(buf)):  # zero the counters
        raise RuntimeError("st_spgemm_profile failed")
    err = fn(
        ops.ptr_a.data_ptr(), ops.cols_a.data_ptr(), ops.vals_a.data_ptr(), ops.ptr_b.data_ptr(),
        ops.cols_b.data_ptr(), ops.vals_b.data_ptr(), ops.order.data_ptr(), ops.counts.data_ptr(), M, K, plan.span,
        plan.vcap, row_ptr.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), vals.data_ptr(), scratch[0:1].data_ptr(),
        scratch[1:2].data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"the profiled numeric pass failed: {err}")
    torch.cuda.synchronize()
    if lib.st_spgemm_profile(ctypes.addressof(buf)):
        raise RuntimeError("st_spgemm_profile failed")
    ints = torch.int32 if vals.dtype == torch.float32 else torch.int64
    if not (torch.equal(out, want_out) and torch.equal(vals.view(ints), want_vals.view(ints))):
        raise AssertionError("the profiled build's numeric pass differs from the port's")
    total = sum(buf[:5])
    return {name: buf[i] / total for i, name in enumerate(STEPS)}, int(buf[5])


def main():
    if not torch.cuda.is_available():
        print("chip_spgemm_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    import sparse_tpu_torch as st
    from chip_smoke import HBM_BYTES_PER_S, K, M, NNZ_DRAWS, nvidia_smi_name_power, s1_pass_ms

    dev = torch.device("cuda")
    card = nvidia_smi_name_power()
    t0 = time.perf_counter()
    lib = build_profile()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    rng = np.random.default_rng(0)
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    data = rng.random(NNZ_DRAWS, dtype=np.float32)
    a32 = st.COO(np.stack([lin // K, lin % K]), data, shape=(M, K), device=dev)
    for a in (a32, st.COO(a32.coords, a32.data.double(), shape=(M, K))):
        ms, out, vals = s1_pass_ms(a, torch.int32)
        nnz = vals.numel()
        out_bytes = nnz * (2 * 4 + a.data.element_size())
        bound_ms = (2 * a.nnz * (2 * 4 + a.data.element_size()) + out_bytes) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({"run": "port", "dtype": str(a.data.dtype), "ms": ms, "total_ms": ms["symbolic"] + ms["numeric"],
                          "nnz_out": nnz, "bound_ms": bound_ms, "card": card}), flush=True)
        shares, chunks = step_cycles(lib, a, out, vals)
        print(json.dumps({"run": "profile", "dtype": str(a.data.dtype), "numeric_cycle_shares": shares,
                          "chunks": chunks, "same_bits": True, "card": card}), flush=True)
        del out, vals
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
