#!/usr/bin/env python3
"""Where the time of the row-ELL SpMM (K2) goes, on one NVIDIA GPU (H100).

    python3 chip_row_ell_ablation.py

Builds variants of ``sparse_tpu_torch/kernels/csrc/row_ell.cu`` side by side
(one ``nvcc`` each, started together, into ``build/row_ell_ablation/``),
each with other values of its ``ROW_ELL_*`` macros, and times K2 at the
benchmark shape (bench.py's 65,536² matrix, 2^21 entry draws, N = 128) in
float32 and float64:

- ``warp``: the one-warp-per-position kernel (``kernel=0``);
- ``staged``: the staged kernel as the entry points launch it (indices by
  bulk copy, four B-row loads in flight per warp, two CTAs an SM, the
  default L2 policy);
- ``staged_hints``: staged, B gathers evict_last, index copies evict_first,
  streaming stores; ``staged_hints_half``: evict_last on half of B's lines;
- ``hints_no_staging``: the staged kernel's grid, depth and hints, with the
  indices read from global memory instead of the bulk-copied stages;
- ``staged_depth_2``, ``staged_depth_8``: two or eight B-row loads in flight
  per warp (eight spill 4 bytes at the 64 registers two CTAs an SM allow);
- ``staged_three_ctas``: registers bounded for three CTAs an SM (it spills);
- ``staged_depth_16_one_cta``: sixteen loads in flight, one CTA an SM.

Every variant is held bit for bit against ``warp``. Each is timed from a CUDA
graph of 50 launches, L2 warm, the variants in turns (forward, then
backward), best of the two passes; then once after a 256 MB write has
flushed L2 and a spin has kept the card busy while the launch was enqueued
(median of 10). Prints one JSON line per variant and dtype (ms,
the gathered rows' TB/s, the kernel's registers from ``-Xptxas -v``), then
the card's ``name, power.limit``. Imports nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "row_ell_ablation"
M = K = 1 << 16
DRAWS = 1 << 21
N = 128

# library name -> macro values (the defaults: ROW_ELL_STAGE=1, ROW_ELL_HINTS=0,
# ROW_ELL_B_FRACTION=1.0f, ROW_ELL_DEPTH=4, ROW_ELL_MIN_BLOCKS=2)
BUILDS = {
    "default": {},
    "hints": {"ROW_ELL_HINTS": "1"},
    "hints_half": {"ROW_ELL_HINTS": "1", "ROW_ELL_B_FRACTION": "0.5f"},
    "hints_no_staging": {"ROW_ELL_HINTS": "1", "ROW_ELL_STAGE": "0"},
    "depth_2": {"ROW_ELL_DEPTH": "2"},
    "depth_8": {"ROW_ELL_DEPTH": "8"},
    "three_ctas": {"ROW_ELL_MIN_BLOCKS": "3"},
    "depth_16_one_cta": {"ROW_ELL_DEPTH": "16", "ROW_ELL_MIN_BLOCKS": "1"},
}
# variant -> (library, kernel argument of the entry point)
VARIANTS = {
    "warp": ("default", 0),
    "staged": ("default", 1),
    "staged_hints": ("hints", 1),
    "staged_hints_half": ("hints_half", 1),
    "hints_no_staging": ("hints_no_staging", 1),
    **{f"staged_{b}": (b, 1) for b in ("depth_2", "depth_8", "three_ctas", "depth_16_one_cta")},
}


def build(name):
    from sparse_tpu_torch.kernels import _cuda

    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    macros = [f"-D{k}={v}" for k, v in BUILDS[name].items()]
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, *macros, "-Xptxas", "-v", "-o", str(so), str(_cuda.SOURCES["row_ell"])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    fns = {}
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"st_row_ell_spmm_{dt}")
        fn.argtypes = _cuda._SIGNATURES["row_ell"][f"st_row_ell_spmm_{dt}"]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    return name, (fns, res.stderr + res.stdout)


def registers(ptxas):
    """Registers and spill bytes of each staged SpMM instantiation in a ptxas report."""
    out, fn = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if "staged" in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if fn and m:
            out.setdefault(fn, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_row_ell_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import gathered_rows
    from sparse_tpu_torch.experiments.common import time_graph
    from sparse_tpu_torch.kernels import _cuda, row_ell

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(pool.map(build, BUILDS))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, M * K, size=DRAWS, dtype=np.int64))
    vals = rng.random(lin.size)
    b_np = rng.random((K, N))
    cases = {}
    for tag, np_dt, dt in (("f32", np.float32, torch.float32), ("f64", np.float64, torch.float64)):
        lay = row_ell.build_row_ell(lin // K, lin % K, vals.astype(np_dt), M, K, device=dev)
        b = torch.as_tensor(b_np, dtype=dt, device=dev)
        plan = _cuda.row_ell_plan(lay, N, _cuda._WIDE[dt], dt)
        cases[tag] = (lay, b, plan, gathered_rows(lay) * N * dt.itemsize)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def launcher(variant, tag, out):
        lib, kernel = VARIANTS[variant]
        fn = libs[lib][0][tag]
        lay, b, plan, _ = cases[tag]
        args = (lay.flat_cols.data_ptr(), lay.flat_data.data_ptr(), b.data_ptr(), N, out.data_ptr(), N,
                lay.tier_table.data_ptr(), lay.tier_table.shape[0], lay.row_of_pos.data_ptr(), lay.row_of_pos.shape[0],
                _cuda._WIDE[b.dtype], kernel, plan.groups if kernel else 0)

        def go():
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{variant} {tag}: launch failed: CUDA error {err}")

        return go

    def cold_ms(go):
        times = []
        for _ in range(10):
            flush.zero_()
            torch.cuda._sleep(2_000_000)  # busy while the launch is enqueued
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            go()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    outs = {(v, tag): torch.empty((M, N), dtype=cases[tag][1].dtype, device=dev) for v in VARIANTS for tag in cases}
    for tag in cases:
        for v in VARIANTS:
            launcher(v, tag, outs[(v, tag)])()
        torch.cuda.synchronize()
        for v in VARIANTS:
            if not torch.equal(outs[(v, tag)], outs[("warp", tag)]):
                raise AssertionError(f"{v} {tag}: differs from the warp kernel")

    rows = {(v, tag): {"variant": v, "dtype": tag} for tag in cases for v in VARIANTS}
    order = list(rows)
    for keys in (order, order[::-1]):  # in turns, forward then backward
        for key in keys:
            ms = time_graph(launcher(*key, outs[key]))
            rows[key]["ms"] = min(ms, rows[key].get("ms", ms))
    for key in order:
        rows[key]["ms_l2_flushed"] = cold_ms(launcher(*key, outs[key]))
    for (v, tag), row in rows.items():
        gathered = cases[tag][3]
        lib = VARIANTS[v][0]
        print(
            json.dumps(
                {
                    **row,
                    "gathered_bytes": gathered,
                    "gathered_tb_per_s": gathered / (row["ms"] * 1e-3) / 1e12,
                    "vs_warp": row["ms"] / rows[("warp", tag)]["ms"],
                    "macros": BUILDS[lib],
                    "staged_registers": registers(libs[lib][1]) if v != "warp" else None,
                    "plan": cases[tag][2]._asdict(),
                }
            ),
            flush=True,
        )
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
