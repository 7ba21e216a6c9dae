#!/usr/bin/env python3
"""Where the time of the SDDMM (K4) and of its gradient's row sum (K5) goes,
on one NVIDIA GPU (H100).

    python3 chip_k4_ablation.py

Builds variants of ``sparse_tpu_torch/kernels/csrc/sddmm.cu`` (K4) and
``csrc/mttkrp.cu`` (K5) side by side (one ``nvcc`` each, started together,
into ``build/k4_ablation/``), each with other values of their macros, and
times them at the benchmark shape: bench.py's 65,536² matrix (2^21 entry
draws, 2,096,628 entries, sorted by row) as the mask, K = 128, float32,
int64 indices, ``lhs`` and ``rhs.T`` row-major.

K4, both routes, as the entry points launch them but for the macro:

- ``kept_row``: the kept-row route (4 rhs rows a lane a round, a round's
  loads issued before the previous round's sums, registers bounded for
  four CTAs of 256 threads an SM); ``kept_unbounded``: no register bound;
  ``kept_five_ctas``: bounded for five CTAs; ``kept_rows_2``,
  ``kept_rows_8``: 2 or 8 a round, no bound; ``kept_rows_8_three_ctas``: 8
  a round, bounded for three CTAs;
- ``per_entry``: the per-entry route (4 entries a round);
  ``per_entry_8``: 8 entries a round; ``per_entry_four_ctas``: registers
  bounded for four CTAs an SM.

K5 along rows (``d lhs``: segments in entry order) and along columns
(``d rhs``: the entries' ids and weights gathered into the stable column
order first; the weights' gather is timed apart):

- ``row_sum``: 4 table rows in flight a lane, four CTAs an SM;
  ``row_sum_loads_2``: 2 rows, eight CTAs; ``row_sum_loads_8``: 8 rows, two
  CTAs; ``row_sum_two_ctas``: 4 rows, two CTAs.

Every K4 variant is held bit for bit against ``per_entry``, every K5
variant against ``row_sum``. Each is timed from a CUDA graph of 50
launches, L2 warm, in turns (forward, then backward), best of the two
passes, and once after a 256 MB write has flushed L2 (median of 10).
Prints one JSON line per variant (ms, gathered TB/s, the kernel's registers
and spills from ``-Xptxas -v``), then the card's ``name, power.limit``.
Imports nothing of JAX or sparse_tpu.
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
OUT = ROOT / "build" / "k4_ablation"
M = N = 1 << 16
DRAWS = 1 << 21
K = 128

# library -> (source, macro values); the defaults are the sources' own
BUILDS = {
    "sddmm": ("sddmm", {}),
    "kept_rows_2": ("sddmm", {"SDDMM_KEPT_ROWS": "2", "SDDMM_KEPT_MIN_BLOCKS": "1"}),
    "kept_rows_8": ("sddmm", {"SDDMM_KEPT_ROWS": "8", "SDDMM_KEPT_MIN_BLOCKS": "1"}),
    "kept_rows_8_three_ctas": ("sddmm", {"SDDMM_KEPT_ROWS": "8", "SDDMM_KEPT_MIN_BLOCKS": "3"}),
    "kept_unbounded": ("sddmm", {"SDDMM_KEPT_MIN_BLOCKS": "1"}),
    "kept_five_ctas": ("sddmm", {"SDDMM_KEPT_MIN_BLOCKS": "5"}),
    "entry_8": ("sddmm", {"SDDMM_ENTRY_ROUND": "8"}),
    "entry_four_ctas": ("sddmm", {"SDDMM_ENTRY_MIN_BLOCKS": "4"}),
    "row_sum": ("mttkrp", {}),
    "row_sum_loads_2": ("mttkrp", {"ROW_SUM_LOADS": "2", "ROW_SUM_MIN_BLOCKS": "8"}),
    "row_sum_loads_8": ("mttkrp", {"ROW_SUM_LOADS": "8", "ROW_SUM_MIN_BLOCKS": "2"}),
    "row_sum_two_ctas": ("mttkrp", {"ROW_SUM_MIN_BLOCKS": "2"}),
}
# K4 variant -> (library, route)
K4_VARIANTS = {
    "kept_row": ("sddmm", "kept_row"),
    "kept_rows_2": ("kept_rows_2", "kept_row"),
    "kept_rows_8": ("kept_rows_8", "kept_row"),
    "kept_rows_8_three_ctas": ("kept_rows_8_three_ctas", "kept_row"),
    "kept_unbounded": ("kept_unbounded", "kept_row"),
    "kept_five_ctas": ("kept_five_ctas", "kept_row"),
    "per_entry": ("sddmm", "per_entry"),
    "per_entry_8": ("entry_8", "per_entry"),
    "per_entry_four_ctas": ("entry_four_ctas", "per_entry"),
}
K5_LIBS = ("row_sum", "row_sum_loads_2", "row_sum_loads_8", "row_sum_two_ctas")


def build(name):
    from sparse_tpu_torch.kernels import _cuda

    source, macros = BUILDS[name]
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    flags = [f"-D{k}={v}" for k, v in macros.items()]
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(so), str(_cuda.SOURCES[source])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    fn_name = "st_sddmm_f32_i64" if source == "sddmm" else "st_row_sum_f32"
    fn = getattr(lib, fn_name)
    fn.argtypes = _cuda._SIGNATURES[source][fn_name]
    fn.restype = ctypes.c_int
    return name, (fn, res.stderr + res.stdout)


def registers(ptxas, key):
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


def checked(fn, args, what):
    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{what}: launch failed: CUDA error {err}")

    return go


def main():
    if not torch.cuda.is_available():
        print("chip_k4_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from sparse_tpu_torch.kernels import _cuda
    from sparse_tpu_torch.kernels import dot as kdot

    dev = torch.device("cuda")
    card = card_name_power()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(pool.map(build, BUILDS))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, M * N, size=DRAWS))
    rows = torch.as_tensor(lin // N, device=dev)
    cols = torch.as_tensor(lin % N, device=dev)
    nnz = rows.numel()
    gen = torch.Generator(device=dev).manual_seed(17)
    s = torch.randn(nnz, generator=gen, device=dev)
    lhs = torch.randn((M, K), generator=gen, device=dev)
    rhs_t = torch.randn((N, K), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    epw = _cuda.sddmm_entries_per_warp(nnz, sms)
    fresh = torch.ones(nnz, dtype=torch.bool, device=dev)
    fresh[1:] = rows[1:] != rows[:-1]
    fresh[::epw] = True
    lhs_loads = int(fresh.sum())

    # K4
    outs, launchers = {}, {}
    for v, (lib, route) in K4_VARIANTS.items():
        out = outs[v] = torch.empty(nnz, device=dev)
        args = (rows.data_ptr(), cols.data_ptr(), s.data_ptr(), lhs.data_ptr(), K, 1, rhs_t.data_ptr(), K, 1, nnz, K,
                epw, 1, _cuda._sddmm_vectors(K, 4, route), sms * _cuda.SDDMM_BLOCKS_PER_SM, out.data_ptr())
        launchers[v] = checked(libs[lib][0], args, v)
        launchers[v]()
    torch.cuda.synchronize()
    for v in K4_VARIANTS:
        if not torch.equal(outs[v], outs["per_entry"]):
            raise AssertionError(f"K4 {v}: differs from per_entry")
    for v, r in timed_in_turns(launchers, flush).items():
        lib, route = K4_VARIANTS[v]
        gathered = (nnz + (lhs_loads if route == "kept_row" else nnz)) * K * 4
        key = "row_kernel" if route == "kept_row" else "entry_kernelIflLb1E"
        print(json.dumps({"k4": v, "route": route, **r, "gathered_bytes": gathered,
                          "gathered_tb_per_s": gathered / (r["ms"] * 1e-3) / 1e12,
                          "registers": registers(libs[lib][1], key), "card": card}), flush=True)
    del outs, launchers

    # K5
    gs = torch.randn(nnz, generator=gen, device=dev)
    pattern = kdot.SddmmPattern(rows, cols, M, N, rows_sorted=True)
    cases = {}
    for of, axis, table in (("d_lhs", 0, rhs_t), ("d_rhs", 1, lhs)):
        ptr, order, pieces, idx = pattern.plan(axis)
        cases[of] = (ptr, pieces, idx, gs if order is None else gs[order], table)
    n_front = _cuda.front_bound(nnz, M, _cuda.MTTKRP_PIECE)
    outs, launchers = {}, {}
    for of, (ptr, pieces, idx, w, table) in cases.items():
        for lib in K5_LIBS:
            out = outs[(of, lib)] = torch.empty((M, K), device=dev)
            partial = torch.empty(n_front * K, device=dev)
            tickets = torch.zeros(n_front * _cuda.row_sum_chunks(K, torch.float32), dtype=torch.int32, device=dev)
            args = (ptr.data_ptr(), pieces.data_ptr(), M, n_front, _cuda.MTTKRP_PIECE, idx.data_ptr(), w.data_ptr(),
                    table.data_ptr(), K, 1, K, out.data_ptr(), partial.data_ptr(), tickets.data_ptr())
            launchers[(of, lib)] = checked(libs[lib][0], args, f"{of} {lib}")
            launchers[(of, lib)]()
    torch.cuda.synchronize()
    for (of, lib), out in outs.items():
        if not torch.equal(out, outs[(of, "row_sum")]):
            raise AssertionError(f"K5 {of} {lib}: differs from row_sum")
    from sparse_tpu_torch.experiments.common import time_graph

    order = pattern.plan(1)[1]
    w_gather_ms = time_graph(lambda: gs[order])
    gathered = nnz * K * 4
    for (of, lib), r in timed_in_turns(launchers, flush).items():
        print(json.dumps({"k5": lib, "of": of, **r, "gathered_bytes": gathered,
                          "gathered_tb_per_s": gathered / (r["ms"] * 1e-3) / 1e12,
                          "registers": registers(libs[lib][1], "RowSum"), "card": card}), flush=True)
    print(json.dumps({"k5_weights_gather_ms": w_gather_ms, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
