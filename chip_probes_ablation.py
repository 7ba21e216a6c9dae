#!/usr/bin/env python3
"""Where the time of the bf16 row pick (E5, p3), the row-pick block sum
(E8, g2), the one-hot SpMV products (E1), the lane-gather block sum (E7,
g1), the lane gather (E3, p1) and the row gather-sum (E4, p2) goes, on one
NVIDIA GPU (H100).

    python3 chip_probes_ablation.py [p3] [g2] [e1] [g1] [p1] [p2] [all]

Builds variants of ``sparse_tpu_torch/kernels/csrc/probes.cu`` side by side
(one ``nvcc`` each, started together, into ``build/probes_ablation/``), each
with other values of its ``PICK_*``, ``COUNT_*``, ``E1_*``, ``LANE_*`` or
``ROW_SUM_*`` macros, and times them at the probes' own sizes (the defaults
of ``pallas_vmem.py:p1``, ``p2``, ``p3``, ``pallas_vmem2.py:g2`` and
``g1``, and E1's products stream at the benchmark shape; their seeds):

- p3, a (512, 128) strip, 2^21 picks, 1.07 GB written: ``bulk`` (the strip
  in shared memory, 64-pick tiles stored by ``cp.async.bulk`` out of a ring
  of 3, as the entry point launches it); ``bulk_l2_strip`` (the same write
  path, the rows read through L2 and rounded per pick, as for a strip too
  tall for shared memory); ``tile32``, ``stages2``, ``tile32_stages4``
  (other tiles and rings); beside them ``out.zero_()`` on an output
  of the same size, the card's write ceiling, and ``torch.index_select`` of
  the strip rounded beforehand. Every variant equal to the plain version
  bit for bit.
- g2, a (8192, 128) table, 285 blocks of 8192 picks: ``counts`` (the table
  in 21 slices in shared memory, each block's picks of a slice counted and
  the counts multiplied with it, four index steps in flight a warp, as the
  entry point launches it); ``counts_depth_8`` (eight steps); ``rows``
  (the first port: every pick a 512-byte row through L2); beside them
  ``F.embedding_bag``. Every variant against the plain version at
  rtol=1e-4, atol=1e-3; the count forms twice, bit for bit. Then what sets
  the count form's time: ``counts`` again on indices that all fall in the
  table's first half (the same index scan, half the slices' rows read:
  ``half_rows_read``), and on a plan of twice the slices of half the
  height (twice the index scan, the same rows read: ``twice_the_scan``).
- e1, the products stream of E1's full SpMV at the benchmark shape
  (2,107,392 slots in blocks of 2048), both tables (hi|lo (512, 256) and
  bf16 (512, 128)): ``l2`` (the table read through L1/L2, the route of a
  table too tall for shared memory), ``smem_pairs`` / ``smem`` (the table
  in shared memory, as the entry point launches it: hi|lo half a CTA in
  pairs, bf16 whole), and the same with 512 threads a CTA instead of
  1,024. Every variant equal to the plain version bit for bit.
- g1, a (512, 128) table and 36 blocks of 512 index rows, and g1b, an
  (8192, 128) table and 4 blocks of 8192: ``l2`` (every pick a 4-byte load
  through L1/L2, g1b's route), ``slices`` (32-lane column slices in shared
  memory, a CTA a slice and block, two CTAs an SM, as the entry point
  launches it) and ``slices_1_per_sm``. Every variant against the plain
  version at rtol=1e-4, atol=1e-3 and twice, bit for bit; the two slice
  variants equal bit for bit.
- p1, a (512, 128) table and 18,432 index rows, and p1b, an (8192, 128)
  table: ``slices`` (32-lane column slices in shared memory, the rows split
  evenly over the grid's warps, one CTA an SM, 24 idx lines in flight a
  warp, as the entry point launches it), ``slices_batch_32``,
  ``slices_batch_12``, ``slices_2_per_sm``, ``slices_3_per_sm`` (16 lines),
  ``l2`` (every pick a 4-byte load through L1/L2: the first port, and
  p1b's route); beside them ``torch.gather``. Every variant equal to the
  plain version bit for bit.
- p2, an (8192, 128) strip and 128 segments of 1,024 picks: ``warps`` (a
  CTA of 32 warps a segment, 8 row reads in flight a lane, as the entry
  point launches it), ``warps_depth_4``, ``warps_depth_16`` (it spills),
  ``first_port`` (row_gather_kernel, 8 warps a segment); beside them
  ``F.embedding_bag``. Every variant against the plain version at
  rtol=1e-4, atol=1e-3 and twice, bit for bit.

Each variant is timed from a CUDA graph of 50 launches, L2 warm, in turns
(forward, then backward), best of the two passes; then once after a 256 MB
write has flushed L2 (median of 10). Prints one JSON line per variant (ms,
the rate that bounds it, the kernel's registers from ``-Xptxas -v``), then
the card's ``name, power.limit``. Imports nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from chip_row_ell_ablation import card_name_power, checked, registers, timed_in_turns

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probes_ablation"
HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = 512
PROBE_TOL = dict(rtol=1e-4, atol=1e-3)

# library name -> macro values (the defaults: PICK_TILE=64, PICK_STAGES=3,
# COUNT_DEPTH=4, E1_THREADS=1024, LANE_CTAS_PER_SM=2,
# LANE_GATHER_CTAS_PER_SM=1, LANE_GATHER_BATCH=24, ROW_SUM_DEPTH=8)
BUILDS = {
    "default": {},
    "tile32": {"PICK_TILE": "32"},
    "stages2": {"PICK_STAGES": "2"},
    "tile32_stages4": {"PICK_TILE": "32", "PICK_STAGES": "4"},
    "counts_depth_8": {"COUNT_DEPTH": "8"},
    "e1_threads_512": {"E1_THREADS": "512"},
    "lane_1_per_sm": {"LANE_CTAS_PER_SM": "1"},
    "lane_gather_batch_32": {"LANE_GATHER_BATCH": "32"},
    "lane_gather_batch_12": {"LANE_GATHER_BATCH": "12"},
    "lane_gather_2_per_sm": {"LANE_GATHER_CTAS_PER_SM": "2"},
    "lane_gather_3_per_sm": {"LANE_GATHER_CTAS_PER_SM": "3", "LANE_GATHER_BATCH": "16"},
    "row_sum_depth_4": {"ROW_SUM_DEPTH": "4"},
    "row_sum_depth_16": {"ROW_SUM_DEPTH": "16"},
}
# p3 variant -> (library, resident)
P3_VARIANTS = {
    "bulk": ("default", 1),
    "bulk_l2_strip": ("default", 0),
    "tile32": ("tile32", 1),
    "stages2": ("stages2", 1),
    "tile32_stages4": ("tile32_stages4", 1),
}
# g2 variant -> library; "rows" is the row gather
G2_VARIANTS = {"counts": "default", "counts_depth_8": "counts_depth_8", "rows": "default"}
# E1 variant -> (table, library, resident)
E1_VARIANTS = {
    "hilo l2": ("hilo", "default", 0),
    "hilo smem_pairs": ("hilo", "default", 1),
    "hilo smem_pairs_512_threads": ("hilo", "e1_threads_512", 1),
    "bf16 l2": ("bf16", "default", 0),
    "bf16 smem": ("bf16", "default", 1),
    "bf16 smem_512_threads": ("bf16", "e1_threads_512", 1),
}
# g1 variant -> (T, library, resident): resident 0 the L2 route
G1_VARIANTS = {
    "g1 l2": (512, "default", 0),
    "g1 slices": (512, "default", 1),
    "g1 slices_1_per_sm": (512, "lane_1_per_sm", 1),
    "g1b l2": (8192, "default", 0),
}

# p1 variant -> (table rows, library, resident): resident 0 the L2 route
P1_VARIANTS = {
    "p1 slices": (512, "default", 1),
    "p1 slices_batch_32": (512, "lane_gather_batch_32", 1),
    "p1 slices_batch_12": (512, "lane_gather_batch_12", 1),
    "p1 slices_2_per_sm": (512, "lane_gather_2_per_sm", 1),
    "p1 slices_3_per_sm": (512, "lane_gather_3_per_sm", 1),
    "p1 l2": (512, "default", 0),
    "p1b l2": (8192, "default", 0),
}
# p2 variant -> library; "first_port" is the row gather
P2_VARIANTS = {
    "warps": "default",
    "warps_depth_4": "row_sum_depth_4",
    "warps_depth_16": "row_sum_depth_16",
    "first_port": "default",
}
L2_ROW_BYTES_PER_S = 7.3e12  # the card's whole-row L2 rate (PERF.md §5)


def build(name):
    from sparse_tpu_torch.kernels import _cuda

    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    macros = [f"-D{k}={v}" for k, v in BUILDS[name].items()]
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, *macros, "-Xptxas", "-v", "-o", str(so), str(_cuda.SOURCES["probes"])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _cuda._SIGNATURES["probes"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return name, (lib, res.stderr + res.stdout)


def stream():
    """The current stream, read at each launch: a graph captures on its own."""
    return torch.cuda.current_stream().cuda_stream


def row_gather(lib, table, idx, out, n_seg, seg_len, copies):
    """A launch of the row gather (``st_row_gather``) over segments of ``seg_len`` consecutive indices."""
    return lambda: lib.st_row_gather(table.data_ptr(), idx.data_ptr(), None, n_seg, 1, seg_len, 0, seg_len, 1, 1, 1,
                                     copies, out.data_ptr(), stream())


def p3_section(libs, dev, flush):
    from sparse_tpu_torch.experiments import pallas_vmem as v

    rng = np.random.default_rng(2)  # p3's draws
    strip = torch.as_tensor(rng.random((512, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 512, size=(1 << 21,), dtype=np.int32), device=dev)
    n = idx.numel()
    want = v.row_pick_bf16_plain(strip, idx)
    launchers, outs = {}, {}
    for name, (lib_name, resident) in P3_VARIANTS.items():
        lib = libs[lib_name][0]
        out = torch.empty((n, 128), device=dev)
        go = lambda lib=lib, out=out, resident=resident: lib.st_row_pick_bf16(  # noqa: E731
            strip.data_ptr(), 512, idx.data_ptr(), n, resident, out.data_ptr(), stream())
        launchers[name], outs[name] = checked(go, f"p3 {name}"), out
        launchers[name]()
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not torch.equal(out, want):
            raise AssertionError(f"p3 {name}: differs from the plain version")
    del want
    ceiling = torch.empty((n, 128), device=dev)
    rounded, i64 = strip.to(torch.bfloat16).float(), idx.long()
    launchers["zero_"] = ceiling.zero_
    launchers["index_select"] = lambda: torch.index_select(rounded, 0, i64)
    rows = timed_in_turns(launchers, flush)
    written = n * ROW_BYTES
    bound_ms = (strip.numel() * 4 + n * 4 + written) / HBM_BYTES_PER_S * 1e3
    for name, row in rows.items():
        lib = P3_VARIANTS.get(name, (None,))[0]
        print(json.dumps({
            "p3_variant": name,
            **row,
            "write_tb_per_s": written / (row["ms"] * 1e-3) / 1e12,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / row["ms"],
            "vs_zero_": row["ms"] / rows["zero_"]["ms"],
            "macros": BUILDS[lib] if lib else None,
            "registers": registers(libs[lib][1], "row_pick_bf16") if lib else None,
        }), flush=True)


def g2_section(libs, dev, flush):
    import torch.nn.functional as F

    from sparse_tpu_torch.experiments import pallas_vmem2 as v2
    from sparse_tpu_torch.kernels import _cuda

    T, n_blocks = 8192, 285
    rng = np.random.default_rng(1)  # g2's draws
    table = torch.as_tensor(rng.random((T, 128), dtype=np.float32), device=dev)
    cols = torch.as_tensor(rng.integers(0, T, size=(n_blocks * T,), dtype=np.int32), device=dev)
    want = v2.row_pick_blocksum_plain(table, cols, T)
    launchers, outs = {}, {}
    plan = _cuda.row_pick_count_plan(T)
    for name, lib_name in G2_VARIANTS.items():
        lib = libs[lib_name][0]
        out = torch.empty((n_blocks * 8, 128), device=dev)
        if name == "rows":
            go = row_gather(lib, table, cols, out, n_blocks, T, 8)
        else:
            partial = torch.empty((n_blocks, plan.n_slices, 128), device=dev)
            tickets = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
            go = lambda lib=lib, out=out, partial=partial, tickets=tickets: lib.st_row_pick_counts(  # noqa: E731
                table.data_ptr(), T, cols.data_ptr(), T, n_blocks, plan.height, plan.n_slices, out.data_ptr(),
                partial.data_ptr(), tickets.data_ptr(), stream())
        launchers[name], outs[name] = checked(go, f"g2 {name}"), out
        launchers[name]()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, **PROBE_TOL, msg=lambda m, name=name: f"g2 {name}: {m}")
        if name != "rows":
            first = out.clone()
            launchers[name]()
            torch.cuda.synchronize()
            if not torch.equal(out, first):
                raise AssertionError(f"g2 {name}: two launches differ")
    bags = cols.long().view(n_blocks, T)
    launchers["embedding_bag"] = lambda: F.embedding_bag(bags, table, mode="sum")
    rows = timed_in_turns(launchers, flush)
    picks = n_blocks * T
    bound_ms = (table.numel() * 4 + cols.numel() * 4 + n_blocks * 8 * ROW_BYTES) / HBM_BYTES_PER_S * 1e3
    for name, row in rows.items():
        lib = G2_VARIANTS.get(name)
        counts = name.startswith("counts")
        print(json.dumps({
            "g2_variant": name,
            **row,
            "picked_bytes": picks * ROW_BYTES,
            # the count form reads its rows from shared memory, the row gather through L2
            ("smem_pick_tb_per_s" if counts else "l2_row_tb_per_s"): picks * ROW_BYTES / (row["ms"] * 1e-3) / 1e12,
            "l2_index_bytes": plan.n_slices * cols.numel() * 4 if counts else None,
            "plan": plan._asdict() if counts else None,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / row["ms"],
            "macros": BUILDS[lib] if lib else None,
            "registers": registers(libs[lib][1], "row_pick_counts" if counts else "row_gather") if lib else None,
        }), flush=True)

    # what sets the count form's time: half the rows read (every index in
    # the table's first half: the same scan) against twice the scan (twice
    # the slices, of half the height: the same rows read)
    lib = libs["default"][0]

    def count_launch(idx, height, n_slices):
        out = torch.empty((n_blocks * 8, 128), device=dev)
        partial = torch.empty((n_blocks, n_slices, 128), device=dev)
        tickets = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
        go = checked(lambda: lib.st_row_pick_counts(table.data_ptr(), T, idx.data_ptr(), T, n_blocks, height, n_slices,
                                                    out.data_ptr(), partial.data_ptr(), tickets.data_ptr(), stream()),
                     "g2 counts")
        go()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, v2.row_pick_blocksum_plain(table, idx, T), **PROBE_TOL)
        return go

    low = cols % (T // 2)
    half = -(-plan.height // 2)
    diag = {
        "counts": count_launch(cols, plan.height, plan.n_slices),
        "half_rows_read": count_launch(low, plan.height, plan.n_slices),
        "twice_the_scan": count_launch(cols, half, -(-T // half)),
    }
    times = timed_in_turns(diag, flush)
    for name, row in times.items():
        print(json.dumps({"g2_diagnostic": name, **row, "vs_counts": row["ms"] / times["counts"]["ms"],
                          "slices": -(-T // half) if name == "twice_the_scan" else plan.n_slices}), flush=True)


def e1_section(libs, dev, flush):
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.kernels import _cuda
    from sparse_tpu_torch.kernels.row_ell import build_row_ell

    rows, cols, data, x = e1.bench_matrix()
    re = build_row_ell(rows, cols, data, e1.M, e1.K, device=dev)
    fc, fd = e1.flatten_tiers(re, 2048)
    del re
    n = fc.numel()
    xt = torch.as_tensor(x, device=dev)
    tables = {"hilo": e1.make_table(xt, True), "bf16": e1.make_table(xt, False)}
    launchers, outs = {}, {}
    for name, (table, lib_name, resident) in E1_VARIANTS.items():
        fn, x2 = getattr(libs[lib_name][0], f"st_spmv_products_{table}"), tables[table]
        out = torch.empty((n, 1), device=dev)
        go = lambda fn=fn, x2=x2, out=out, resident=resident: fn(  # noqa: E731
            x2.data_ptr(), x2.shape[0], fc.data_ptr(), fd.data_ptr(), n, resident, out.data_ptr(), stream())
        launchers[name], outs[name] = checked(go, f"e1 {name}"), out
        launchers[name]()
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not torch.equal(out, e1.products_plain(tables[E1_VARIANTS[name][0]], fc, fd)):
            raise AssertionError(f"e1 {name}: differs from the plain version")
    rows_ = timed_in_turns(launchers, flush)
    for name, row in rows_.items():
        table, lib, _ = E1_VARIANTS[name]
        bound_ms = (fc.numel() * 4 * 3 + tables[table].numel() * 2) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "e1_variant": name,
            **row,
            "slots": n,
            "g_slots_per_s": n / (row["ms"] * 1e-3) / 1e9,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / row["ms"],
            "vs_l2": row["ms"] / rows_[f"{table} l2"]["ms"],
            "design": _cuda.spmv_products_design(512, table == "hilo") if E1_VARIANTS[name][2] else "l2",
            "macros": BUILDS[lib],
            "registers": registers(libs[lib][1], "spmv_products"),
        }), flush=True)


def g1_section(libs, dev, flush):
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2
    from sparse_tpu_torch.kernels import _cuda

    inputs = {}
    for T, n_blocks in ((512, 36), (8192, 4)):  # g1 and g1b, their draws
        rng = np.random.default_rng(0)
        table = torch.as_tensor(rng.random((T, 128), dtype=np.float32), device=dev)
        idx = torch.as_tensor(rng.integers(0, T, size=(n_blocks * T, 128), dtype=np.int32), device=dev)
        inputs[T] = (table, idx, n_blocks, v2.lane_gather_blocksum_plain(table, idx, T))
    launchers, outs = {}, {}
    for name, (T, lib_name, resident) in G1_VARIANTS.items():
        lib = libs[lib_name][0]
        table, idx, n_blocks, want = inputs[T]
        out = torch.empty((n_blocks * 8, 128), device=dev)
        partial, tickets = None, None
        if not resident:  # the L2 route's scratch, at g1's T too
            partial = torch.empty((n_blocks, -(-T // _cuda.LANE_SPLIT_ROWS), 128), device=dev)
            tickets = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
        go = lambda lib=lib, table=table, idx=idx, T=T, n_blocks=n_blocks, resident=resident, out=out, \
            partial=partial, tickets=tickets: lib.st_lane_gather_blocksum(  # noqa: E731
                table.data_ptr(), T, idx.data_ptr(), n_blocks, T, resident, out.data_ptr(),
                None if partial is None else partial.data_ptr(), None if tickets is None else tickets.data_ptr(),
                stream())
        launchers[name], outs[name] = checked(go, f"g1 {name}"), out
        launchers[name]()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, **PROBE_TOL, msg=lambda m, name=name: f"{name}: {m}")
        first = out.clone()
        launchers[name]()
        torch.cuda.synchronize()
        if not torch.equal(out, first) or (tickets is not None and tickets.any()):
            raise AssertionError(f"{name}: two launches differ or leave a ticket set")
    if not torch.equal(outs["g1 slices"], outs["g1 slices_1_per_sm"]):  # one order of every sum, whatever the grid
        raise AssertionError("g1: the slice variants differ in their bits")
    rows = timed_in_turns(launchers, flush)
    for name, row in rows.items():
        T, lib, resident = G1_VARIANTS[name]
        table, idx, n_blocks, _ = inputs[T]
        bound_ms = (table.numel() * 4 + idx.numel() * 4 + n_blocks * 8 * ROW_BYTES) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "g1_variant": name,
            **row,
            "T": T,
            "gathers": idx.numel(),
            "g_gathers_per_s": idx.numel() / (row["ms"] * 1e-3) / 1e9,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / row["ms"],
            "vs_l2": row["ms"] / rows[name.split()[0] + " l2"]["ms"],
            "macros": BUILDS[lib],
            "registers": registers(libs[lib][1], "lane_slice" if resident else "lane_gather"),
        }), flush=True)


def p1_section(libs, dev, flush):
    from sparse_tpu_torch.experiments import pallas_vmem as v

    inputs = {}
    for h in (512, 8192):  # p1's and p1b's draws
        rng = np.random.default_rng(0)
        table = torch.as_tensor(rng.random((h, 128), dtype=np.float32), device=dev)
        idx = torch.as_tensor(rng.integers(0, h, size=(18432, 128), dtype=np.int32), device=dev)
        inputs[h] = (table, idx, v.lane_gather_plain(table, idx))
    launchers = {}
    for name, (h, lib_name, resident) in P1_VARIANTS.items():
        lib = libs[lib_name][0]
        table, idx, want = inputs[h]
        out = torch.empty_like(want)
        go = lambda lib=lib, table=table, idx=idx, h=h, resident=resident, out=out: lib.st_lane_gather(  # noqa: E731
            table.data_ptr(), h, idx.data_ptr(), idx.shape[0], resident, out.data_ptr(), stream())
        launchers[name] = checked(go, name)
        launchers[name]()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: differs from the plain version")
    table, idx, _ = inputs[512]
    i64 = idx.long()
    launchers["p1 torch.gather"] = lambda: torch.gather(table, 0, i64)
    rows = timed_in_turns(launchers, flush)
    for name, row in rows.items():
        h, lib, resident = P1_VARIANTS.get(name, (512, None, None))
        table, idx, want = inputs[h]
        bound_ms = (table.numel() + idx.numel() + want.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "p1_variant": name,
            **row,
            "table_rows": h,
            "gathers": idx.numel(),
            "g_gathers_per_s": idx.numel() / (row["ms"] * 1e-3) / 1e9,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / row["ms"],
            "vs_l2": row["ms"] / rows[name.split()[0] + " l2"]["ms"],
            "macros": BUILDS[lib] if lib else None,
            "registers": (registers(libs[lib][1], "lane_slice" if resident else "lane_gather") if lib else None),
        }), flush=True)


def p2_section(libs, dev, flush):
    import torch.nn.functional as F

    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.kernels import _cuda

    strip_h, n_seg, L = 8192, 128, 1024
    rng = np.random.default_rng(1)  # p2's draws
    strip = torch.as_tensor(rng.random((strip_h, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, strip_h, size=(n_seg * L,), dtype=np.int32), device=dev)
    want = v.row_gather_sum_plain(strip, idx, L)
    plan = _cuda.row_gather_sum_plan(L, n_seg, torch.cuda.get_device_properties(dev).multi_processor_count)
    launchers = {}
    for name, lib_name in P2_VARIANTS.items():
        lib = libs[lib_name][0]
        out = torch.empty_like(want)
        if name == "first_port":
            go = row_gather(lib, strip, idx, out, n_seg, L, 1)
        else:
            go = lambda lib=lib, out=out: lib.st_row_gather_sum(  # noqa: E731
                strip.data_ptr(), idx.data_ptr(), n_seg, L, plan.warps_per_segment, plan.segments_per_cta,
                out.data_ptr(), stream())
        launchers[name] = checked(go, f"p2 {name}")
        launchers[name]()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, **PROBE_TOL, msg=lambda m, name=name: f"p2 {name}: {m}")
        first = out.clone()
        launchers[name]()
        torch.cuda.synchronize()
        if not torch.equal(out, first):
            raise AssertionError(f"p2 {name}: two launches differ")
    bags = idx.long().view(n_seg, L)
    launchers["embedding_bag"] = lambda: F.embedding_bag(bags, strip, mode="sum")
    rows = timed_in_turns(launchers, flush)
    picked = idx.numel() * ROW_BYTES
    bound_ms = (strip.numel() + idx.numel() + want.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    for name, row in rows.items():
        lib = P2_VARIANTS.get(name)
        print(json.dumps({
            "p2_variant": name,
            **row,
            "picked_bytes": picked,
            "l2_row_tb_per_s": picked / (row["ms"] * 1e-3) / 1e12,
            "l2_floor_ms": picked / L2_ROW_BYTES_PER_S * 1e3,
            "bound_ms": bound_ms,
            "bound_share": bound_ms / row["ms"],
            "vs_first_port": row["ms"] / rows["first_port"]["ms"],
            "plan": plan._asdict() if lib and name != "first_port" else None,
            "macros": BUILDS[lib] if lib else None,
            "registers": (registers(libs[lib][1], "row_gather_kernel" if name == "first_port" else "row_gather_sum")
                          if lib else None),
        }), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_probes_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    which = sys.argv[1:] or ["all"]
    sections = {
        "p3": {lib for lib, _ in P3_VARIANTS.values()},
        "g2": set(G2_VARIANTS.values()),
        "e1": {lib for _, lib, _ in E1_VARIANTS.values()},
        "g1": {lib for _, lib, _ in G1_VARIANTS.values()},
        "p1": {lib for _, lib, _ in P1_VARIANTS.values()},
        "p2": set(P2_VARIANTS.values()),
        "all": set(BUILDS),
    }
    if not set(which) <= set(sections):
        print(f"chip_probes_ablation: unknown section in {which}; {', '.join(sections)}", file=sys.stderr)
        return 2
    if "all" in which:
        which = list(sections)
    names = set().union(*(sections[w] for w in which))
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(build, sorted(names)))
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    if "p3" in which:
        p3_section(libs, dev, flush)
    if "g2" in which:
        g2_section(libs, dev, flush)
    if "e1" in which:
        e1_section(libs, dev, flush)
    if "g1" in which:
        g1_section(libs, dev, flush)
    if "p1" in which:
        p1_section(libs, dev, flush)
    if "p2" in which:
        p2_section(libs, dev, flush)
    print(card_name_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
