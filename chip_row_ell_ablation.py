#!/usr/bin/env python3
"""Where the time of the row-ELL SpMM (K2) and SpMV (K1) goes, on one NVIDIA GPU (H100).

    python3 chip_row_ell_ablation.py [spmm|spmv|all]

Builds variants of ``sparse_tpu_torch/kernels/csrc/row_ell.cu`` side by side
(one ``nvcc`` each, started together, into ``build/row_ell_ablation/``),
each with other values of its K2 ``ROW_ELL_*`` macros, and times K2 at the
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

Every variant is held bit for bit against ``warp``.

The K1 section times the SpMV at the same matrix, float32 and float64,
from the default build:

- ``thread``: the thread kernel (one thread per position, x through L1/L2),
  the entry points' default;
- ``cluster``: the cluster kernel (x in the cluster's shared memory) as
  ``kernel="cluster"`` launches it;
- ``cluster_2c``: the same with twice the CTAs a cluster and half the slice.

Every K1 variant is held bit for bit against ``thread``, with and without y.
Then a size sweep: the thread and cluster kernels on the bench matrix cut
to 2^13-2^21 entry draws, to find any size where the cluster kernel pays.

Each variant is timed from a CUDA graph of 50 launches, L2 warm, the
variants in turns (forward, then backward), best of the two passes; then
once after a 256 MB write has flushed L2 and a spin has kept the card busy
while the launch was enqueued (median of 10). Prints one JSON line per
variant and dtype (ms, the gathered rows' TB/s or the bound share, the
kernel's registers from ``-Xptxas -v``), then the card's ``name,
power.limit``. Imports nothing of JAX or sparse_tpu.
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
    for op in ("spmm", "spmv"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"st_row_ell_{op}_{dt}")
            fn.argtypes = _cuda._SIGNATURES["row_ell"][f"st_row_ell_{op}_{dt}"]
            fn.restype = ctypes.c_int
            fns[dt if op == "spmm" else f"spmv_{dt}"] = fn
    return name, (fns, res.stderr + res.stdout)


def registers(ptxas, key="staged"):
    """Registers and spill bytes of each instantiation whose name holds ``key`` in a ptxas report."""
    out, fn = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if key in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if fn and m:
            out.setdefault(fn, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


# K1 variant -> (kernel of st_row_ell_spmv_*, slice divisor): kernel 0 the
# thread kernel, 1 the cluster kernel; divisor 2 halves the entry point's
# slice, so a cluster has twice the CTAs
SPMV_VARIANTS = {
    "thread": (0, 1),
    "cluster": (1, 1),
    "cluster_2c": (1, 2),
}
SWEEP_DRAWS = [1 << e for e in range(13, 22)]
DTYPES = (("f32", np.float32, torch.float32), ("f64", np.float64, torch.float64))


def card_name_power():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def cold_ms(go, flush):
    """Median device ms of one launch after a 256 MB write has flushed L2."""
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


def timed_in_turns(launchers, flush):
    """``{key: {"ms", "ms_l2_flushed"}}``: CUDA graphs in turns, forward then
    backward, best of the two passes; then each once after an L2 flush."""
    from sparse_tpu_torch.experiments.common import time_graph

    rows = {key: {} for key in launchers}
    order = list(launchers)
    for keys in (order, order[::-1]):
        for key in keys:
            ms = time_graph(launchers[key])
            rows[key]["ms"] = min(ms, rows[key].get("ms", ms))
    for key in order:
        rows[key]["ms_l2_flushed"] = cold_ms(launchers[key], flush)
    return rows


def checked(fn, what):
    def go():
        err = fn()
        if err:
            raise RuntimeError(f"{what}: launch failed: CUDA error {err}")

    return go


def spmm_section(libs, dev, lin, vals, flush):
    from chip_smoke import gathered_rows
    from sparse_tpu_torch.kernels import _cuda, row_ell

    b_np = np.random.default_rng(1).random((K, N))
    cases = {}
    for tag, np_dt, dt in DTYPES:
        lay = row_ell.build_row_ell(lin // K, lin % K, vals.astype(np_dt), M, K, device=dev)
        b = torch.as_tensor(b_np, dtype=dt, device=dev)
        plan = _cuda.row_ell_plan(lay, N, _cuda._WIDE[dt], dt)
        cases[tag] = (lay, b, plan, gathered_rows(lay) * N * dt.itemsize)

    def launcher(variant, tag, out):
        lib, kernel = VARIANTS[variant]
        fn = libs[lib][0][tag]
        lay, b, plan, _ = cases[tag]
        args = (lay.flat_cols.data_ptr(), lay.flat_data.data_ptr(), b.data_ptr(), N, out.data_ptr(), N,
                lay.tier_table.data_ptr(), lay.tier_table.shape[0], lay.row_of_pos.data_ptr(), lay.row_of_pos.shape[0],
                _cuda._WIDE[b.dtype], kernel, plan.groups if kernel else 0)
        return checked(lambda: fn(*args, torch.cuda.current_stream(dev).cuda_stream), f"{variant} {tag}")

    outs = {(v, tag): torch.empty((M, N), dtype=cases[tag][1].dtype, device=dev) for v in VARIANTS for tag in cases}
    for tag in cases:
        for v in VARIANTS:
            launcher(v, tag, outs[(v, tag)])()
        torch.cuda.synchronize()
        for v in VARIANTS:
            if not torch.equal(outs[(v, tag)], outs[("warp", tag)]):
                raise AssertionError(f"{v} {tag}: differs from the warp kernel")

    rows = timed_in_turns({key: launcher(*key, outs[key]) for key in outs}, flush)
    for (v, tag), row in rows.items():
        gathered = cases[tag][3]
        lib = VARIANTS[v][0]
        print(
            json.dumps(
                {
                    "variant": v,
                    "dtype": tag,
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


def spmv_launcher(fn, lay, kernel, divisor, x, y, out, dev):
    """A launch of K1's kernel ``kernel`` on ``lay``, the slice cut by ``divisor``."""
    from sparse_tpu_torch.kernels import _cuda

    plan = _cuda.row_ell_spmv_plan(lay, x.dtype)
    slice_log2 = plan.slice_log2 - (divisor - 1)
    cluster = -(-lay.n_cols >> slice_log2)
    args = (lay.flat_cols.data_ptr(), lay.flat_data.data_ptr(), x.data_ptr(), lay.n_cols,
            None if y is None else y.data_ptr(), out.data_ptr(), lay.tier_table.data_ptr(), lay.tier_table.shape[0],
            lay.row_of_pos.data_ptr(), lay.row_of_pos.shape[0], kernel, cluster, slice_log2)
    shape = {"kernel": kernel, "cluster": cluster, "slice_log2": slice_log2}
    go = checked(lambda: fn(*args, torch.cuda.current_stream(dev).cuda_stream), f"spmv kernel {kernel}")
    go.operands = (lay, x, y, out)  # the launch reads them through raw pointers: keep them alive
    return go, shape


def spmv_bound_ms(lin, dt, m):
    """Each entry's col and value read once, each touched value of x once, out written once, over HBM's rate."""
    from chip_smoke import HBM_BYTES_PER_S

    return (lin.size * (4 + dt.itemsize) + np.unique(lin % K).size * dt.itemsize + m * dt.itemsize) / HBM_BYTES_PER_S * 1e3


def spmv_section(libs, dev, lin, vals, flush):
    from sparse_tpu_torch.kernels import row_ell

    rng = np.random.default_rng(2)
    x_np, y_np = rng.random(K), rng.random(M)
    launchers, shapes, outs, bounds = {}, {}, {}, {}
    for tag, np_dt, dt in DTYPES:
        lay = row_ell.build_row_ell(lin // K, lin % K, vals.astype(np_dt), M, K, device=dev)
        x = torch.as_tensor(x_np, dtype=dt, device=dev)
        y = torch.as_tensor(y_np, dtype=dt, device=dev)
        bounds[tag] = spmv_bound_ms(lin, dt, M)
        fn = libs["default"][0][f"spmv_{tag}"]
        for v, (kernel, divisor) in SPMV_VARIANTS.items():
            for yy in (None, y):  # bit for bit against the thread kernel, with and without y
                out = torch.empty(M, dtype=dt, device=dev)
                spmv_launcher(fn, lay, kernel, divisor, x, yy, out, dev)[0]()
                outs[(v, tag, yy is None)] = out
            out = torch.empty(M, dtype=dt, device=dev)
            launchers[(v, tag)], shapes[(v, tag)] = spmv_launcher(fn, lay, kernel, divisor, x, None, out, dev)
        torch.cuda.synchronize()
        for (v, t, no_y), out in outs.items():
            if t == tag and not torch.equal(out, outs[("thread", tag, no_y)]):
                raise AssertionError(f"K1 {v} {tag} y={not no_y}: differs from the thread kernel")
    rows = timed_in_turns(launchers, flush)
    for (v, tag), row in rows.items():
        print(
            json.dumps(
                {
                    "k1_variant": v,
                    "dtype": tag,
                    **row,
                    "bound_ms": bounds[tag],
                    "bound_share": bounds[tag] / row["ms"],
                    "vs_thread": row["ms"] / rows[("thread", tag)]["ms"],
                    "launch": shapes[(v, tag)],
                    "registers": registers(libs["default"][1], "spmv_cluster_kernel"),
                }
            ),
            flush=True,
        )

    # the size sweep: the thread kernel against the cluster kernel on the
    # bench matrix cut to fewer entry draws
    sweep = np.random.default_rng(3)
    draws_all = sweep.integers(0, M * K, size=SWEEP_DRAWS[-1], dtype=np.int64)
    for draws in SWEEP_DRAWS:
        lin_d = np.unique(draws_all[:draws])
        vals_d = sweep.random(lin_d.size)
        for tag, np_dt, dt in DTYPES:
            lay = row_ell.build_row_ell(lin_d // K, lin_d % K, vals_d.astype(np_dt), M, K, device=dev)
            x = torch.as_tensor(x_np, dtype=dt, device=dev)
            fn = libs["default"][0][f"spmv_{tag}"]
            got, runs = {}, {}
            for name in ("thread", "cluster"):
                got[name] = torch.empty(M, dtype=dt, device=dev)
                runs[name] = spmv_launcher(fn, lay, SPMV_VARIANTS[name][0], 1, x, None, got[name], dev)[0]
                runs[name]()
            torch.cuda.synchronize()
            if not all(torch.equal(o, got["thread"]) for o in got.values()):
                raise AssertionError(f"K1 sweep {draws} {tag}: the kernels differ")
            ms = {k: v["ms"] for k, v in timed_in_turns(runs, flush).items()}
            print(json.dumps({"k1_sweep_draws": draws, "dtype": tag, "slots": lay.flat_cols.numel(),
                              "nnz": int(lin_d.size), "ms": ms, "bound_ms": spmv_bound_ms(lin_d, dt, M)}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_row_ell_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("spmm", "spmv", "all"):
        print(f"chip_row_ell_ablation: unknown section {which!r}; spmm, spmv or all", file=sys.stderr)
        return 2
    names = ["default"] if which == "spmv" else list(BUILDS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(build, names))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, M * K, size=DRAWS, dtype=np.int64))
    vals = rng.random(lin.size)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    if which in ("spmm", "all"):
        spmm_section(libs, dev, lin, vals, flush)
    if which in ("spmv", "all"):
        spmv_section(libs, dev, lin, vals, flush)
    print(card_name_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
