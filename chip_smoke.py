#!/usr/bin/env python3
"""Smoke test of sparse_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source under sparse_tpu_torch/kernels/csrc/, all started together) and
drives the port's two paths on the card:

- the sparse × dense main path: holds the row-ELL kernels against their
  plain PyTorch versions (the SpMM's staged kernel also against its
  one-warp-per-position kernel, bit for bit), drives ``COO`` → ``a @ B`` / ``a @ x`` /
  ``matvec_add`` at the benchmark shape (65,536², 2^21 entry draws, N = 128,
  float32) and the spmv_add shape (99,990 × 100,000 at density 1e-6), and
  checks the outputs against a float64 scipy oracle;
- the block-sparse layer: holds the BSR kernels (the SpMM, its two-block
  form and the block SDDMM on the tensor cores for float32 (3xTF32) and
  bfloat16 and on the CUDA cores for float64) against their plain
  versions in float32, float64 and bfloat16, on the layer's forward, dgrad
  and wgrad operands too (the wgrad's MN-major operands and K-major copies
  of them), then trains ``BlockSparseLinear(8192, 8192,
  block_density=0.25)`` at batch 512 (the JAX package's block-sparse
  training benchmark, bench_suite.py), checks the first step's output and
  both gradients against a float64 oracle, takes three SGD steps on
  which the loss must fall, then 20 more back to back for the steady
  step time, and takes one step of the layer without its transposed
  layout (the torch-op backward, its wgrad on the SDDMM kernel); the SpMM
  is timed against its run piece (forward and dgrad, no split and 32, 16,
  8 blocks);
- the MTTKRP of a 3-D tensor: builds the BASELINE-scale tensor (100,000 x
  2,000 x 2,000, 10M draws, r = 32, float32; bench_suite.py) as a ``COO``
  on the card and its block-ELL layout, holds the MTTKRP kernel against its
  plain version (float32, float64, bf16 tables; both forms), drives
  ``ell_mttkrp`` (exact and bf16), ``kernels.mttkrp`` and ``jitops.mttkrp``
  against a float64 oracle, and the example's shape (1000 x 1000 x 100 at
  density 1e-4, r = 25, float64) against ``np.einsum``; the block-ELL form
  is timed against its run piece (no split and 512, 256, 128 slots);
- the experiments: the one-hot SpMV prototype's full SpMV at the benchmark
  shape through the row-ELL layout (hi|lo and bf16 tables, blocks of 2048
  and 4096 slots) against a float64 oracle and beside K1, and the VMEM
  gather probes p1-p4 and g1-g3 at their own full sizes; each of the eight
  kernels held against its plain version, and the card's gather rates.

The launch counters show that each path ran its kernels; each kernel is
timed beside its plain version, one library call on the same inputs
(torch.sparse, which reaches cuSPARSE or torch's own kernels; timed here
only, the package never calls it) and its bound.

Output: one JSON line per phase and per kernel, then one line
``{"kernels": [...]}``, then the card's ``name, power.limit`` from
nvidia-smi, and last ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero before that line; so does a machine without a CUDA device.
Imports nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from sparse_tpu_torch.experiments.common import REPS, WARMUP, time_graph

M = K = 1 << 16  # benchmark shape (bench.py)
NNZ_DRAWS = 1 << 21
N = 128
SPMV_ADD_SHAPE = (99_990, 100_000)  # spmv_add example
SPMV_ADD_DENSITY = 1e-6

# published H100 SXM peaks at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # tensor cores, dense; float32 products at HIGHEST take three passes (3xTF32)
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense

# kernel vs plain: the two sum each row in another order (the kernel
# sequentially with FMAs, the plain version by torch's reduction)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}
# against the float64 oracle (bench.py's check)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-5)

SOURCE = {
    "row_ell_spmv": "sparse_tpu_torch/kernels/csrc/row_ell.cu",
    "row_ell_spmm": "sparse_tpu_torch/kernels/csrc/row_ell.cu",
    "bsr_spmm": "sparse_tpu_torch/kernels/csrc/bsr_tc.cu",  # float32 and bfloat16; float64 stays in bsr.cu
    "bsr_spmm2": "sparse_tpu_torch/kernels/csrc/bsr_tc.cu",  # float32 and bfloat16; float64 stays in bsr.cu
    "bsr_sddmm": "sparse_tpu_torch/kernels/csrc/bsr_tc.cu",  # float32 and bfloat16; float64 stays in bsr.cu
    "ell_mttkrp": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",
    "coo_mttkrp": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",
    **{
        k: "sparse_tpu_torch/kernels/csrc/probes.cu"
        for k in (
            "spmv_products",
            "lane_gather",
            "row_gather_sum",
            "row_pick_bf16",
            "scalar_gather_sum",
            "lane_gather_blocksum",
            "row_pick_blocksum",
            "pick_scale_wsum",
        )
    },
}
REPLACES = {
    "row_ell_spmv": "sparse_tpu/kernels/row_ell.py:231",  # _onehot_products_call (Pallas)
    "row_ell_spmm": "sparse_tpu/kernels/row_ell.py:198",  # _spmm (XLA)
    "bsr_spmm": "sparse_tpu/kernels/bsr.py:168",  # bsr_spmm_pallas (Pallas P2)
    "bsr_spmm2": "sparse_tpu/kernels/bsr.py:235",  # bsr_spmm_pallas2 (Pallas P3)
    "bsr_sddmm": "sparse_tpu/kernels/bsr.py:341",  # bsr_sddmm_pallas (Pallas P4)
    "ell_mttkrp": "experiments/mttkrp_onehot.py:38",  # products_call (Pallas E2), for ell_mttkrp
    "coo_mttkrp": "sparse_tpu/kernels/dot.py:132",  # mttkrp (XLA segment_sum)
    "spmv_products": "experiments/pallas_spmv_onehot.py:77",  # products_kernel (Pallas E1)
    "lane_gather": "experiments/pallas_vmem.py:76",  # p1 (E3)
    "row_gather_sum": "experiments/pallas_vmem.py:121",  # p2 (E4)
    "row_pick_bf16": "experiments/pallas_vmem.py:166",  # p3 (E5)
    "scalar_gather_sum": "experiments/pallas_vmem.py:209",  # p4 (E6)
    "lane_gather_blocksum": "experiments/pallas_vmem2.py:69",  # g1 (E7)
    "row_pick_blocksum": "experiments/pallas_vmem2.py:107",  # g2 (E8)
    "pick_scale_wsum": "experiments/pallas_vmem2.py:146",  # g3 (E9)
}

# the block-sparse layer at full width (bench_suite.py:324-339): 8192 x 8192,
# 25 % of the 128 x 128 blocks, batch 512, float32
LAYER_IN = LAYER_OUT = 8192
LAYER_DENSITY = 0.25
LAYER_BATCH = 512
LAYER_LR = 0.02  # SGD on the per-sample summed squared error; stable below ~0.08 at this width
# BSR kernel vs plain, unit-normal inputs (the two sum in another order)
BSR_TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-4),
    torch.float64: dict(rtol=1e-10, atol=1e-12),
    torch.bfloat16: dict(rtol=2e-2, atol=2e-2),  # one final rounding each side
}
# the training step against the float64 oracle: max|got - want| / max|want|
LAYER_ORACLE_TOL = 1e-4
# the float32 SDDMM (3xTF32) at the layer shape against its plain version, normalised as above
SDDMM_NORM_TOL = 1e-5
STEADY_STEPS = 20  # SGD steps timed back to back after the checked ones

# MTTKRP at the BASELINE scale (bench_suite.py:227-253): 100k x 2k x 2k from
# 10M draws of np.random.default_rng(0), r = 32, float32; not cut
MT_I, MT_J, MT_K, MT_R = 100_000, 2000, 2000, 32
MT_DRAWS = 10_000_000
# against the float64 oracle, max|got - want| / max|want|: exact f32, and the
# bf16 strategy's grade (tests/test_kernels.py:317)
MT_ORACLE_TOL = {"exact": 1e-5, "bf16": 3e-2}
# the example's shape (examples/mttkrp_example.py:17-41), float64, its own limit
EX_SHAPE, EX_DENSITY, EX_R, EX_RTOL = (1000, 1000, 100), 1e-4, 25, 1e-8

# the one-hot SpMV prototype against the float64 oracle, max|out - oracle| /
# max|oracle|, by table (the prototype's docstring: ~1e-5 and ~2e-3)
E1_ORACLE_TOL = {"hilo": 1e-4, "bf16": 1e-2}
# probe sums against their plain versions: up to 8,192 positive terms, about
# 4e3 at most, added in another order
PROBE_TOL = dict(rtol=1e-4, atol=1e-3)
L2_ROW_BYTES = 128 * 4  # one picked f32 table row


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_name_power():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return res.stdout.strip().splitlines()[0]


def problem(case, rng):
    """``(rows, cols, m, k)`` of a test matrix; rows/cols int64, unique entries."""
    if case == "zipf":
        m, k = 2000, 1500
        raw = rng.zipf(1.4, size=60_000)
        rows = raw[raw <= m] - 1
        lin = np.unique(rows * k + rng.integers(0, k, size=rows.size))
    elif case == "empty":
        m, k = 10, 7
        lin = np.zeros(0, dtype=np.int64)
    elif case == "k_ragged":
        m, k = 500, 1001
        lin = np.unique(rng.integers(0, m * k, size=5000))
    elif case == "zero_rows":
        m, k = 1000, 800
        lin = np.unique(rng.integers(0, m * k, size=8000))
        lin = lin[(lin // k) % 3 == 0]
    elif case == "hub":
        m, k = 200, 5000
        hub = 17 * k + rng.choice(k, size=2000, replace=False)
        lin = np.unique(np.concatenate([hub, rng.integers(0, m * k, size=300)]))
    elif case == "bench":
        m, k = M, K
        lin = np.unique(rng.integers(0, m * k, size=NNZ_DRAWS))
    else:
        raise ValueError(case)
    return lin // k, lin % k, m, k


def check_close(name, got, want, tol):
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def phase_kernels_vs_plain(dev):
    """K1 and K2 against their plain versions on the card, f32 and f64; K2's
    staged kernel equal bit for bit to its one-warp-per-position kernel."""
    from sparse_tpu_torch.kernels import _cuda, row_ell

    rng = np.random.default_rng(1)
    errs = {"row_ell_spmv": 0.0, "row_ell_spmm": 0.0}
    for case in ("zipf", "empty", "k_ragged", "zero_rows", "hub", "bench"):
        rows, cols, m, k = problem(case, rng)
        # positive values: no cancellation, so the relative tolerance holds
        vals = rng.random(rows.size)
        for dt in (torch.float32, torch.float64):
            np_dt = np.float32 if dt == torch.float32 else np.float64
            re = row_ell.build_row_ell(rows, cols, vals.astype(np_dt), m, k, device=dev)
            widths = [N, 37] if case != "bench" else [N]  # 37: ragged N, one value per lane
            for n in widths:
                b = torch.as_tensor(rng.random((k, n)), dtype=dt, device=dev)
                got = row_ell.row_ell_spmm(re, b)
                e = check_close(f"spmm {case} {dt} N={n}", got, row_ell._spmm_plain(re, b), TOL[dt])
                if _cuda.row_ell_staged_layout(re):
                    outs = [_cuda.spmm(re, b, torch.empty_like(got), kernel=kn) for kn in ("staged", "warp")]
                    if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], got)):
                        raise AssertionError(f"spmm {case} {dt} N={n}: the staged and warp kernels differ")
                if case == "bench" and dt == torch.float32:
                    errs["row_ell_spmm"] = e
            x = torch.as_tensor(rng.random(k), dtype=dt, device=dev)
            y = torch.as_tensor(rng.random(m), dtype=dt, device=dev)
            e = check_close(f"spmv {case} {dt}", row_ell.row_ell_spmv(re, x), row_ell._spmv_plain(re, x), TOL[dt])
            e_y = check_close(
                f"spmv+y {case} {dt}", row_ell.row_ell_spmv(re, x, y=y), row_ell._spmv_plain(re, x, y), TOL[dt]
            )
            if case == "bench" and dt == torch.float32:
                errs["row_ell_spmv"] = max(e, e_y)
            torch.cuda.synchronize()
        log(f"kernel_vs_plain {case}: m={m} k={k} nnz={rows.size} ok")
    return errs


def oracle_csr(rows, cols, data, shape):
    import scipy.sparse

    return scipy.sparse.csr_matrix((data.astype(np.float64), (rows, cols)), shape=shape)


def phase_main_path(dev):
    """The main path through the public entry points, counted."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

    rng = np.random.default_rng(0)
    # raw draws: unsorted, with duplicates, so the constructor sorts and sums
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    rows, cols = lin // K, lin % K
    data = rng.random(NNZ_DRAWS, dtype=np.float32)
    b_np = rng.random((K, N), dtype=np.float32)
    x_np = rng.random(K, dtype=np.float32)
    m2, k2 = SPMV_ADD_SHAPE
    lin2 = np.unique(rng.integers(0, m2 * k2, size=round(m2 * k2 * SPMV_ADD_DENSITY)))
    rows2, cols2 = lin2 // k2, lin2 % k2
    data2 = rng.random(lin2.size)
    x2 = rng.random(k2)
    y2 = rng.random(m2)
    b = torch.as_tensor(b_np, device=dev)
    x = torch.as_tensor(x_np, device=dev)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    a = st.COO(np.stack([rows, cols]), data, shape=(M, K), device=dev)
    torch.cuda.synchronize()
    t_coo = time.perf_counter()
    out1 = a @ b
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    layout = a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
    out2 = a @ b
    torch.cuda.synchronize()
    t_second = time.perf_counter()
    if layout is None or a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY) is not layout:
        raise AssertionError("the second a @ b did not reuse the cached row-ELL layout")
    outv = a @ x
    a2 = st.COO(np.stack([rows2, cols2]), data2, shape=(m2, k2), device=dev)
    outa = st.matvec_add(a2, x2, y2)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for name in ("row_ell_spmv", "row_ell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}: {launches}")
    for name, t, shape in (("a@B", out1, (M, N)), ("a@B again", out2, (M, N)), ("a@x", outv, (M,)), ("matvec_add", outa, (m2,))):
        if tuple(t.shape) != shape or t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} on {t.device}, finite={bool(torch.isfinite(t).all())}")
    if not torch.equal(out1, out2):
        raise AssertionError("a @ b differs between the first and the cached-layout call")

    ref = oracle_csr(rows, cols, data, (M, K))
    np.testing.assert_allclose(out1.cpu().numpy(), ref @ b_np.astype(np.float64), **ORACLE_TOL)
    np.testing.assert_allclose(outv.cpu().numpy(), ref @ x_np.astype(np.float64), **ORACLE_TOL)
    ref2 = oracle_csr(rows2, cols2, data2, (m2, k2))
    np.testing.assert_allclose(outa.cpu().numpy(), ref2 @ x2 + y2, rtol=1e-12, atol=0)

    log(
        json.dumps(
            {
                "main_path": "ok",
                "nnz": a.nnz,
                "launches": launches,
                "coo_build_s": t_coo - t0,
                "first_matmul_s_incl_layout_build": t_first - t_coo,
                "second_matmul_s": t_second - t_first,
                "total_s": t_end - t0,
                "peak_memory_bytes": peak,
                "spmv_add_nnz": a2.nnz,
            }
        )
    )
    return a, layout, b, x, launches


def time_eager(fn, reps=20):
    """ms per call of ``fn`` from CUDA events around ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold(fn, reps=20):
    """Median device ms of one call of ``fn`` after a 256 MB write has
    flushed the 50 MB L2 (events around the call alone). A spin of about a
    millisecond after the flush keeps the card busy while the host enqueues
    the call, so the host's time to launch stays out of the reading."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def gathered_rows(re):
    """Rows of B that K2 gathers: its tier's width for every position that
    is not group padding."""
    table = re.tier_table.cpu().tolist()
    return sum(int((re.row_of_pos[p0:nxt[0]] >= 0).sum()) * w for (p0, w, _, _), nxt in zip(table, table[1:]))


def phase_times(a, re, b, x, launches, errs, card):
    from sparse_tpu_torch.kernels import _cuda, row_ell

    csr = torch.sparse_coo_tensor(a.coords.long(), a.data, (M, K)).coalesce().to_sparse_csr()
    nnz = a.nnz
    touched = int(torch.unique(a.coords[1]).numel())
    y = torch.rand(M, device=b.device)
    out_m = torch.empty((M, N), device=b.device)
    out_v = torch.empty(M, device=b.device)
    lines = []
    specs = [
        (
            "row_ell_spmm",
            lambda: _cuda.spmm(re, b, out_m),
            lambda: row_ell.row_ell_spmm(re, b),
            lambda: row_ell._spmm_plain(re, b),
            lambda: csr @ b,
            # cols + values read, touched rows of B read, out written
            nnz * 8 + touched * N * 4 + M * N * 4,
            2 * nnz * N,
        ),
        (
            "row_ell_spmv",
            lambda: _cuda.spmv(re, x, None, out_v),
            lambda: row_ell.row_ell_spmv(re, x),
            lambda: row_ell._spmv_plain(re, x),
            lambda: torch.mv(csr, x),
            nnz * 8 + touched * 4 + M * 4,
            2 * nnz,
        ),
    ]
    # K2's staged kernel beside its warp kernel, in turns, float32 and float64
    b64, out64 = b.double(), out_m.double()
    re64 = re._replace(flat_data=re.flat_data.double())
    k2_runs = {
        f"{kn}_{tag}": (lambda kn=kn, r=r, bb=bb, o=o: _cuda.spmm(r, bb, o, kernel=kn))
        for tag, r, bb, o in (("f32", re, b, out_m), ("f64", re64, b64, out64))
        for kn in ("staged", "warp")
    }
    k2_ms = {}
    for order in (list(k2_runs), list(k2_runs)[::-1]):
        for key in order:
            k2_ms[key] = min(time_graph(k2_runs[key]), k2_ms.get(key, float("inf")))
    rows_gathered = gathered_rows(re)
    plan = _cuda.row_ell_plan(re, N, 4, torch.float32)
    k2_extra = {
        "gathered_bytes": rows_gathered * N * 4,
        "kernel_ms_by_kernel": k2_ms,
        "plan": plan._asdict(),
        "gathered_tb_per_s_by_kernel": {
            k: rows_gathered * N * (8 if k.endswith("f64") else 4) / (v * 1e-3) / 1e12 for k, v in k2_ms.items()
        },
    }
    del b64, out64, re64

    for name, launch, wrapper, plain, library, nbytes, flops in specs:
        torch.cuda.reset_peak_memory_stats()
        ms = time_graph(launch)
        peak_kernel = torch.cuda.max_memory_allocated()
        ms_wrapper = time_eager(wrapper, reps=50)
        ms_cold = time_cold(launch)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_eager(plain, reps=5)
        peak_plain = torch.cuda.max_memory_allocated()
        library_ms = time_eager(library, reps=20)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lines.append(line)
        extra = {}
        if name == "row_ell_spmm":
            extra = {**k2_extra, "gathered_tb_per_s": k2_extra["gathered_bytes"] / (ms * 1e-3) / 1e12}
        log(
            json.dumps(
                {
                    **line,
                    "kernel_ms": ms,
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    # everything allocated so far plus what the timed calls allocate
                    "peak_memory_bytes_kernel": peak_kernel,
                    "peak_memory_bytes_plain": peak_plain,
                    "shape": {"m": M, "k": K, "n": N if name == "row_ell_spmm" else 1, "nnz": nnz, "dtype": "float32"},
                    **extra,
                    "card": card,
                }
            )
        )
    return lines


def bsr_problem(case, rng, dev):
    """``(layout, m, k)`` of a BSR test matrix with unit-normal values."""
    from sparse_tpu_torch.kernels import bsr

    m, k, density, block_shape, pad = {
        "test_bsr": (500, 600, 0.02, (128, 128), 1),  # tests/test_bsr.py's ragged problem
        "empty": (128, 128, 0.0, (128, 128), 1),  # the single zero block
        "pad2": (500, 600, 0.02, (128, 128), 2),
        "block_32x64": (200, 300, 0.03, (32, 64), 1),
    }[case]
    lin = rng.choice(m * k, size=round(m * k * density), replace=False)
    layout = bsr.build_bsr(lin // k, lin % k, rng.standard_normal(lin.size), (m, k), block_shape, pad, device=dev)
    return layout, m, k


def layer_layout(dev):
    """The full-width layer, its input and its weighted-sum gradient: seeded."""
    from sparse_tpu_torch import nn

    layer = nn.BlockSparseLinear(
        LAYER_IN, LAYER_OUT, LAYER_DENSITY, generator=torch.Generator().manual_seed(0), device=dev
    )
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((LAYER_BATCH, LAYER_IN), dtype=np.float32), device=dev)
    target = torch.as_tensor(rng.standard_normal((LAYER_BATCH, LAYER_OUT), dtype=np.float32), device=dev)
    wsum = torch.as_tensor(rng.standard_normal((LAYER_BATCH, LAYER_OUT), dtype=np.float32), device=dev)
    return layer, x, target, wsum


def phase_bsr_kernels_vs_plain(dev, layer, x, wsum):
    """The three BSR kernels against their plain versions on the card, in
    float32, float64 and bfloat16: ragged edges, an empty matrix, a padded
    layout through both SpMMs, a (32, 64) block shape, transposed-view
    operands, a ragged SDDMM contraction, and the full-width layer (its
    wgrad also on K-major copies of its operands: the same result)."""
    from sparse_tpu_torch.kernels import _cuda, bsr

    rng = np.random.default_rng(2)
    errs = {"bsr_spmm": 0.0, "bsr_spmm2": 0.0, "bsr_sddmm": 0.0}
    sddmm_norm, sddmm_layouts_equal = {}, {}
    _cuda.reset_launch_counts()
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        tol = BSR_TOL[dt]
        for case in ("test_bsr", "empty", "pad2", "block_32x64"):
            a, m, k = bsr_problem(case, rng, dev)
            blocks = a.blocks.to(dt)
            for n, transposed in ((200, False), (37, False), (37, True)):
                d = torch.as_tensor(rng.standard_normal((n, k) if transposed else (k, n)), device=dev).to(dt)
                d = d.T if transposed else d
                want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, blocks, d, n_rows=m)
                got = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, blocks, d, n_rows=m, row_ptr=a.row_ptr)
                check_close(f"bsr_spmm {case} {dt} N={n} T={transposed}", got, want, tol)
                if case == "pad2":
                    got2 = bsr.bsr_spmm_kernel2(a.block_rows, a.block_cols, blocks, d, n_rows=m, row_ptr=a.row_ptr)
                    check_close(f"bsr_spmm2 {case} {dt} N={n} T={transposed}", got2, want, tol)
            for b in (96, 37):  # 37: a ragged contraction
                lhs = torch.as_tensor(rng.standard_normal((b, m)), device=dev).to(dt).T
                rhs = torch.as_tensor(rng.standard_normal((b, k)), device=dev).to(dt)
                want = bsr.bsr_sddmm_plain(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
                got = bsr.bsr_sddmm_kernel(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
                check_close(f"bsr_sddmm {case} {dt} B={b}", got, want, tol)
            torch.cuda.synchronize()
        # the full-width layer: its blocks and x.T (forward), the gradient of
        # an MSE-like loss, scaled as one (unit-normal / sqrt(batch)), for the SDDMM
        p = layer.params()
        blocks = p.blocks.detach().to(dt)
        xt = x.to(dt).T
        g = (wsum / LAYER_BATCH**0.5).to(dt).T  # (out, batch), a transposed view as in the backward
        args = (p.block_rows, p.block_cols, blocks, xt)
        want = bsr.bsr_spmm_plain(*args, n_rows=LAYER_OUT)
        e1 = check_close(f"bsr_spmm layer {dt}", bsr.bsr_spmm_kernel(*args, n_rows=LAYER_OUT, row_ptr=p.row_ptr), want, tol)
        e2 = check_close(f"bsr_spmm2 layer {dt}", bsr.bsr_spmm_kernel2(*args, n_rows=LAYER_OUT, row_ptr=p.row_ptr), want, tol)
        # the wgrad: g and x as the layer gives them (both MN-major), then
        # K-major copies of them; the same products either way
        want = bsr.bsr_sddmm_plain(p.block_rows, p.block_cols, g, x.to(dt))
        got = bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, g, x.to(dt))
        e3 = check_close(f"bsr_sddmm layer {dt}", got, want, tol)
        got_k = bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, g.contiguous(), x.to(dt).T.contiguous().T)
        check_close(f"bsr_sddmm layer K-major {dt}", got_k, want, tol)
        sddmm_norm[str(dt)] = normalised_err(got, want.double())
        sddmm_layouts_equal[str(dt)] = bool(torch.equal(got, got_k))
        if dt == torch.float32 and not (sddmm_norm[str(dt)] <= SDDMM_NORM_TOL and sddmm_layouts_equal[str(dt)]):
            raise AssertionError(f"bsr_sddmm layer float32: {sddmm_norm} normalised, MN/K-major equal {sddmm_layouts_equal}")
        del got, got_k
        # the dgrad: the K-major transposed blocks and the gradient's transposed view
        blocks_t = bsr.transposed_blocks(blocks, p.t_perm)
        args_t = (p.t_block_rows, p.t_block_cols, blocks_t, g)
        want = bsr.bsr_spmm_plain(*args_t, n_rows=LAYER_IN)
        check_close(f"bsr_spmm dgrad {dt}", bsr.bsr_spmm_kernel(*args_t, n_rows=LAYER_IN, row_ptr=p.t_row_ptr), want, tol)
        del blocks_t, want
        torch.cuda.synchronize()
        if dt == torch.float32:
            errs = {"bsr_spmm": e1, "bsr_spmm2": e2, "bsr_sddmm": e3}
        log(f"bsr kernel_vs_plain {dt}: ok")
    launches = dict(_cuda.LAUNCHES)
    if launches["bsr_spmm2"] == 0 or launches["bsr_spmm"] == 0 or launches["bsr_sddmm"] == 0:
        raise AssertionError(f"the BSR comparison launched no kernel: {launches}")
    sddmm = {"layer_normalised_err": sddmm_norm, "layer_mn_equals_k_major": sddmm_layouts_equal}
    return errs, launches, sddmm


def normalised_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def phase_training(dev, layer, x, target, wsum):
    """The block-sparse layer's training path at full width, counted: a
    first step checked against a float64 oracle, then three SGD steps."""
    from sparse_tpu_torch.kernels import LAUNCHES, bsr, reset_launch_counts

    p = layer.params()
    runs, t_runs = torch.diff(p.row_ptr), torch.diff(p.t_row_ptr)
    layout = {
        "n_pad_blocks": int((~p.blocks.detach().reshape(p.blocks.shape[0], -1).any(dim=1)).sum()),
        "run_min_max": [int(runs.min()), int(runs.max())],
        "t_run_min_max": [int(t_runs.min()), int(t_runs.max())],
        "t_run_of_block_row_0": int(t_runs[0]),
    }
    w64 = bsr.BSR(p.blocks.detach().double(), p.block_rows, p.block_cols, (LAYER_OUT, LAYER_IN), (128, 128), p.row_ptr)
    w64 = w64.todense()
    b64 = p.bias.detach().double()
    opt = torch.optim.SGD(layer.parameters(), lr=LAYER_LR)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # step 0: the output and both gradients of the weighted sum sum(y * wsum)
    x_in = x.clone().requires_grad_(True)
    y = layer(x_in)
    (y * wsum).sum().backward()
    torch.cuda.synchronize()
    first = dict(LAUNCHES)
    x64, g64 = x.double(), wsum.double()
    err_y = normalised_err(y.detach(), x64 @ w64.T + b64)
    err_dx = normalised_err(x_in.grad, g64 @ w64)
    dw = (g64.T @ x64).reshape(LAYER_OUT // 128, 128, LAYER_IN // 128, 128).transpose(1, 2)
    err_db = normalised_err(layer.blocks.grad, dw[p.block_rows.long(), p.block_cols.long()])
    del dw, w64
    for name, e in (("y", err_y), ("dx", err_dx), ("d_blocks", err_db)):
        if not e <= LAYER_ORACLE_TOL:
            raise AssertionError(f"training step 0: {name} off the float64 oracle by {e} (limit {LAYER_ORACLE_TOL})")
    if first["bsr_spmm"] < 2 or first["bsr_sddmm"] < 1:
        raise AssertionError(f"training step 0 did not run forward, dgrad and wgrad on the kernels: {first}")

    # three SGD steps on the per-sample summed squared error
    losses, steps = [], []
    for _ in range(3):
        before = dict(LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        opt.zero_grad(set_to_none=True)
        loss = ((layer(x) - target) ** 2).sum(dim=1).mean()
        loss.backward()
        opt.step()
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        per_step = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if per_step["bsr_spmm"] < 2 or per_step["bsr_sddmm"] < 1:
            raise AssertionError(f"an SGD step did not run forward, dgrad and wgrad on the kernels: {per_step}")
        losses.append(loss.item())
        steps.append({"host_s": host_s, "device_ms": start.elapsed_time(end), "launches": per_step})
    with torch.no_grad():
        losses.append(((layer(x) - target) ** 2).sum(dim=1).mean().item())
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not all(a > b for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss is not finite and falling: {losses}")

    # the steady state: STEADY_STEPS steps back to back, synchronised once, so
    # the host enqueues a step while the card runs the one before; the host
    # clock of each part is its enqueue time
    def sgd_step(marks):
        t = [time.perf_counter()]
        opt.zero_grad(set_to_none=True)
        y = layer(x)
        t.append(time.perf_counter())
        loss = ((y - target) ** 2).sum(dim=1).mean()
        loss.backward()
        t.append(time.perf_counter())
        opt.step()
        t.append(time.perf_counter())
        marks.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
        return loss

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    marks = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEADY_STEPS):
        loss = sgd_step(marks)
    end.record()
    end.synchronize()
    steady = {
        "steps": STEADY_STEPS,
        "device_ms_per_step": start.elapsed_time(end) / STEADY_STEPS,
        "host_ms_per_step": (time.perf_counter() - t0) * 1e3 / STEADY_STEPS,
        "host_enqueue_ms_median": dict(zip(("forward", "loss_backward", "sgd"), np.median(marks, axis=0).tolist())),
        "loss_after": loss.item(),
    }
    if not np.isfinite(steady["loss_after"]):
        raise AssertionError(f"the loss is not finite after {STEADY_STEPS} more steps")

    return {
        "err_y": err_y,
        "err_dx": err_dx,
        "err_d_blocks": err_db,
        "first_step_launches": first,
        "losses": losses,
        "lr": LAYER_LR,
        "steps": steps,
        "steady_state": steady,
        "launches": launches,
        "peak_memory_bytes": peak,
        "n_blocks": int(p.blocks.shape[0]),
        "layout": layout,
    }


def phase_pairs_path(dev, layer, x):
    """The two-block SpMM (P3) driven through its public wrapper on the
    trained layer's even-run layout, counted, against the layer's forward."""
    from sparse_tpu_torch.kernels import LAUNCHES, bsr, reset_launch_counts

    p = layer.params()
    with torch.no_grad():
        want = layer(x) - p.bias
        torch.cuda.synchronize()
        reset_launch_counts()
        got = bsr.bsr_spmm_kernel2(p.block_rows, p.block_cols, p.blocks, x.T, n_rows=LAYER_OUT, row_ptr=p.row_ptr).T
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        args = (p.block_rows, p.block_cols, p.blocks, x.T)
        one_block = bsr.bsr_spmm_kernel(*args, n_rows=LAYER_OUT, row_ptr=p.row_ptr).T
    if launches["bsr_spmm2"] == 0:
        raise AssertionError(f"the two-block path never launched bsr_spmm2: {launches}")
    err = normalised_err(got, want.double())
    if not err <= LAYER_ORACLE_TOL:
        raise AssertionError(f"bsr_spmm_kernel2 off the layer's forward by {err}")
    if not torch.equal(got, one_block):
        raise AssertionError("bsr_spmm_kernel2 and bsr_spmm_kernel differ on the layer's even-run layout")
    return launches, err


def phase_vjp_path(layer, x, wsum):
    """One step of the layer without its transposed layout (forward on the
    SpMM, backward as torch ops with the wgrad on the SDDMM kernel), counted,
    against the trainable path's gradients."""
    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    p = layer.params()
    grads = []
    for params in (p, p._replace(t_block_rows=None, t_block_cols=None, t_perm=None)):
        blocks = p.blocks.detach().clone().requires_grad_(True)
        x_in = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        reset_launch_counts()
        (tnn.block_sparse_linear(params._replace(blocks=blocks, bias=p.bias.detach()), x_in) * wsum).sum().backward()
        torch.cuda.synchronize()
        grads.append((blocks.grad, x_in.grad))
    launches = dict(LAUNCHES)
    if (launches["bsr_spmm"], launches["bsr_sddmm"]) != (1, 1):
        raise AssertionError(f"the layer without a transposed layout did not run its forward and wgrad on the kernels: {launches}")
    errs = {name: normalised_err(grads[1][i], grads[0][i].double()) for i, name in enumerate(("d_blocks", "dx"))}
    if not all(e <= SDDMM_NORM_TOL for e in errs.values()):
        raise AssertionError(f"the torch-op backward is off the trainable path's gradients: {errs}")
    return launches, errs, bool(torch.equal(grads[0][0], grads[1][0]))


def phase_step_breakdown(layer, x, wsum):
    """Device ms of each part of one training step (CUDA events, eager)."""
    from sparse_tpu_torch.kernels import bsr

    p = layer.params()
    blocks = p.blocks.detach()
    g = wsum.T  # the gradient of out_t, a transposed view
    blocks_t = bsr.transposed_blocks(blocks, p.t_perm)
    opt = torch.optim.SGD(layer.parameters(), lr=LAYER_LR)
    for prm in layer.parameters():
        prm.grad = torch.zeros_like(prm)
    parts = {
        "forward": lambda: bsr.bsr_spmm_kernel(p.block_rows, p.block_cols, blocks, x.T, n_rows=LAYER_OUT, row_ptr=p.row_ptr),
        "blocks_t_gather": lambda: bsr.transposed_blocks(blocks, p.t_perm),
        "dgrad": lambda: bsr.bsr_spmm_kernel(p.t_block_rows, p.t_block_cols, blocks_t, g, n_rows=LAYER_IN, row_ptr=p.t_row_ptr),
        "wgrad": lambda: bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, g, x),
        "sgd_step": opt.step,
    }
    with torch.no_grad():
        out = {name: time_eager(fn, reps=10) for name, fn in parts.items()}
    opt.zero_grad(set_to_none=True)
    return out


def phase_bsr_times(layer, x, wsum, launches, errs, card):
    """One line per BSR kernel at the full-width layer shape."""
    from sparse_tpu_torch.kernels import _cuda, bsr

    torch.backends.cuda.matmul.allow_tf32 = False
    p = layer.params()
    blocks = p.blocks.detach()
    nb, bm, bn = blocks.shape
    xt = x.T  # (in, batch), the forward's dense operand
    g = (wsum / LAYER_BATCH**0.5).T  # (out, batch), the wgrad's left operand
    cols = p.block_cols
    out_f = torch.empty((LAYER_OUT, LAYER_BATCH), device=x.device)
    out_w = torch.empty_like(blocks)
    w_dense = bsr.BSR(blocks, p.block_rows, cols, (LAYER_OUT, LAYER_IN), (bm, bn), p.row_ptr).todense()
    xt_c = xt.contiguous()

    library_notes = {}

    def yardstick(name, make):
        """One PyTorch call computing the same function, timed only; None (and
        the reason printed) where the installed torch does not take it here."""
        try:
            fn = make()
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
            library_notes[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            return None
        return time_eager(fn, reps=10)

    def bsr_matmul():
        w_bsr = w_dense.to_sparse_bsr((bm, bn))
        return lambda: w_bsr @ xt_c

    def sampled():
        # on the BSR pattern where torch takes it, else on the same pattern as
        # CSR; the pattern holds every stored block, pad blocks included
        ones = bsr.BSR(torch.ones_like(blocks), p.block_rows, cols, (LAYER_OUT, LAYER_IN), (bm, bn), p.row_ptr)
        ones = ones.todense()
        pattern = ones.to_sparse_bsr((bm, bn))
        try:
            torch.sparse.sampled_addmm(pattern, g, x, beta=0.0)
        except RuntimeError as exc:
            library_notes["bsr_sddmm_bsr_pattern"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            pattern = ones.to_sparse_csr()
        library_notes["bsr_sddmm"] = f"torch.sparse.sampled_addmm on the {pattern.layout} pattern"
        return lambda: torch.sparse.sampled_addmm(pattern, g, x, beta=0.0)

    touched_cols = int(torch.unique(cols).numel())
    touched_rows = int(torch.unique(p.block_rows).numel())
    idx_bytes = nb * 4 + (p.row_ptr.numel()) * 8
    spmm_bytes = nb * bm * bn * 4 + min(touched_cols * bn, LAYER_IN) * LAYER_BATCH * 4 + LAYER_OUT * LAYER_BATCH * 4 + idx_bytes
    sddmm_bytes = (min(touched_rows * bm, LAYER_OUT) + min(touched_cols * bn, LAYER_IN)) * LAYER_BATCH * 4 + nb * bm * bn * 4 + nb * 8
    flops = 2 * nb * bm * bn * LAYER_BATCH
    # the forward (block-rows of W) and the dgrad (block-rows of Wᵀ, K-major blocks_t)
    blocks_t = bsr.transposed_blocks(blocks, p.t_perm)
    g_dgrad = wsum.T  # the gradient of out_t, a transposed (K-major) view
    fwd = (blocks, cols, p.row_ptr, xt, LAYER_OUT)
    dgrad = (blocks_t, p.t_block_cols, p.t_row_ptr, g_dgrad, LAYER_IN)

    def tc_launch(operands, piece=_cuda.BSR_PIECE, name="bsr_spmm"):
        """The bare tensor-core launch on ``operands``, its scratch made once."""
        blk, bcols, row_ptr, dense_op, n_rows = operands
        out = torch.empty((n_rows, dense_op.shape[1]), device=dense_op.device)
        pieces = _cuda.run_pieces(row_ptr, piece)
        _, n_partial, n_tickets = _cuda.bsr_tc_scratch(blk.shape[0], row_ptr.shape[0] - 1, bm, dense_op.shape[1], piece)
        partial = torch.empty(n_partial, device=dense_op.device)
        tickets = _cuda.zeroed_tickets(dense_op.device, n_tickets)
        args = (blk, bcols, row_ptr, pieces, dense_op, out, partial, tickets)
        return lambda: _cuda.bsr_spmm_tc(*args, piece=piece, name=name)

    # the run piece L, picked on this card: no split (one CTA per run) against 32, 16 and 8 blocks
    piece_sweep = {
        str(piece): {part: time_graph(tc_launch(ops, piece), reps=20) for part, ops in (("forward", fwd), ("dgrad", dgrad))}
        for piece in (1 << 20, 32, 16, 8)
    }
    dgrad_ms = time_graph(tc_launch(dgrad), reps=20)

    def sddmm_extra():
        """The SDDMM on the layer's operands in the other layouts and dtypes:
        K-major copies of g and x (float32), bfloat16 (MN-major, read through
        the wgmma transpose bit) and float64 (the FFMA kernel of bsr.cu)."""
        g_k, x_k = g.contiguous(), x.T.contiguous().T
        g16, x16 = g.to(torch.bfloat16), x.to(torch.bfloat16)
        g64, x64 = g.double(), x.double()
        out16, out64 = torch.empty_like(out_w, dtype=torch.bfloat16), torch.empty_like(out_w, dtype=torch.float64)
        return {
            "mn_major_g_x": [_cuda.sddmm_tc_major(g, 0)[0], _cuda.sddmm_tc_major(x, 1)[0]],
            "mn_major_g_x_bf16": [_cuda.sddmm_tc_major(g16, 0)[0], _cuda.sddmm_tc_major(x16, 1)[0]],
            "kernel_ms_k_major": time_graph(lambda: _cuda.bsr_sddmm_tc(p.block_rows, cols, g_k, x_k, out_w), reps=20),
            "kernel_ms_bf16": time_graph(lambda: _cuda.bsr_sddmm_tc(p.block_rows, cols, g16, x16, out16), reps=20),
            "bf16_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
            "kernel_ms_f64_ffma": time_graph(lambda: _cuda.bsr_sddmm(p.block_rows, cols, g64, x64, out64), reps=5),
        }

    specs = [
        (
            "bsr_spmm",
            tc_launch(fwd),
            lambda: bsr.bsr_spmm_kernel(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT, row_ptr=p.row_ptr),
            lambda: bsr.bsr_spmm_plain(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT),
            bsr_matmul,
            lambda: w_dense @ xt_c,
            spmm_bytes,
        ),
        (
            "bsr_spmm2",
            tc_launch(fwd, name="bsr_spmm2"),
            lambda: bsr.bsr_spmm_kernel2(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT, row_ptr=p.row_ptr),
            lambda: bsr.bsr_spmm_plain(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT),
            bsr_matmul,
            lambda: w_dense @ xt_c,
            spmm_bytes,
        ),
        (
            "bsr_sddmm",
            lambda: _cuda.bsr_sddmm_tc(p.block_rows, cols, g, x, out_w),
            lambda: bsr.bsr_sddmm_kernel(p.block_rows, cols, g, x),
            lambda: bsr.bsr_sddmm_plain(p.block_rows, cols, g, x),
            sampled,
            lambda: g @ x,
            sddmm_bytes,
        ),
    ]
    lines = []
    for name, launch, wrapper, plain, library, dense, nbytes in specs:
        torch.cuda.reset_peak_memory_stats()
        ms = time_graph(launch, reps=20)
        peak_kernel = torch.cuda.max_memory_allocated()
        ms_wrapper = time_eager(wrapper, reps=20)
        ms_cold = time_cold(launch, reps=10)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_eager(plain, reps=5)
        peak_plain = torch.cuda.max_memory_allocated()
        library_ms = yardstick(name, library)
        dense_ms = time_eager(dense, reps=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # the same work has the same bound, whatever the kernel runs on: the
        # float32 products at HIGHEST on the CUDA cores or as 3xTF32 on the tensor cores
        t_ops = min(flops / F32_FLOPS_PER_S, 3 * flops / TF32_FLOPS_PER_S) * 1e3
        bound_ms = max(t_bytes, t_ops)
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lines.append(line)
        extra = {}
        if name == "bsr_spmm":
            extra = {"dgrad_kernel_ms": dgrad_ms, "piece": _cuda.BSR_PIECE, "piece_sweep_ms": piece_sweep}
        if name == "bsr_spmm2":  # the two-block CUDA-core kernel, float64's route, in float32
            cuda_core = lambda: _cuda.bsr_spmm(blocks, cols, p.row_ptr, xt, out_f, pairs=2)  # noqa: E731
            extra = {"cuda_core_ms": time_graph(cuda_core, reps=20)}
        if name == "bsr_sddmm":
            extra = sddmm_extra()
        log(
            json.dumps(
                {
                    **line,
                    "bound_note": "operations: 3xTF32 on the tensor cores (3 x flops / 495 TFLOP/s)"
                    if t_ops < flops / F32_FLOPS_PER_S * 1e3
                    else "operations: FP32 FMA",
                    **extra,
                    "kernel_ms": ms,
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "dense_ms": dense_ms,
                    "library_note": library_notes.get(name, "W.to_sparse_bsr((128, 128)) @ dense"),
                    "library_note_bsr_pattern": library_notes.get(f"{name}_bsr_pattern"),
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    "f32_peak_flops_per_s": F32_FLOPS_PER_S,
                    "tf32_peak_flops_per_s": TF32_FLOPS_PER_S,
                    "peak_memory_bytes_kernel": peak_kernel,
                    "peak_memory_bytes_plain": peak_plain,
                    "shape": {"out": LAYER_OUT, "in": LAYER_IN, "batch": LAYER_BATCH, "n_blocks": nb, "block": [bm, bn], "dtype": "float32"},
                    "card": card,
                }
            )
        )
    return lines


def mttkrp_problem(dev):
    """The BASELINE-scale tensor as a ``COO`` built on the card, its factors
    and its block-ELL layout, drawn as bench_suite.py draws them."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import build_block_ell_3d

    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, MT_I * MT_J * MT_K, size=MT_DRAWS, dtype=np.int64))
    coords = np.stack([lin // (MT_J * MT_K), (lin // MT_K) % MT_J, lin % MT_K])
    tv = rng.random(lin.size, dtype=np.float32)
    c = torch.as_tensor(rng.random((MT_J, MT_R), dtype=np.float32), device=dev)
    d = torch.as_tensor(rng.random((MT_K, MT_R), dtype=np.float32), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = st.COO(coords, tv, shape=(MT_I, MT_J, MT_K), device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lay = build_block_ell_3d(t.coords[0], t.coords[1], t.coords[2], t.data, MT_I, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t, c, d, lay, {"coo_build_s": t1 - t0, "layout_build_s": t2 - t1}


def example_problem(dev):
    """The example's tensor (seeded numpy draws) as a ``COO`` on the card,
    its factors, and the dense einsum oracle, computed in slabs of rows."""
    import sparse_tpu_torch as st

    I, K, L = EX_SHAPE
    rng = np.random.default_rng(0)
    lin = np.sort(rng.choice(I * K * L, size=round(I * K * L * EX_DENSITY), replace=False))
    coords = np.stack([lin // (K * L), (lin // L) % K, lin % L])
    vals = rng.random(lin.size)
    c, d = rng.random((K, EX_R)), rng.random((L, EX_R))
    want = np.empty((I, EX_R))
    for i0 in range(0, I, 100):
        sel = (coords[0] >= i0) & (coords[0] < i0 + 100)
        slab = np.zeros((100, K, L))
        slab[coords[0, sel] - i0, coords[1, sel], coords[2, sel]] = vals[sel]
        want[i0 : i0 + 100] = np.einsum("ikl,kj,lj->ij", slab, c, d, optimize=True)
    return st.COO(coords, vals, shape=EX_SHAPE, device=dev), c, d, want


def phase_mttkrp_vs_plain(t, c, d, lay):
    """The MTTKRP kernel, both forms, against its plain version at full
    width: float32, float64 and the bf16 tables (positive values: no
    cancellation, so the row-ELL tolerances hold)."""
    from sparse_tpu_torch.kernels import dot, ell

    runs = dict(order=lay.order, row_ptr=lay.row_ptr)
    errs = {}
    for dt in (torch.float32, torch.float64):
        lay_dt, c_dt, d_dt = (*lay[:3], lay.e_data.to(dt)), c.to(dt), d.to(dt)
        for strategy in ("exact", "bf16"):
            got = ell.ell_mttkrp(*lay_dt, c_dt, d_dt, n_rows=MT_I, strategy=strategy, **runs)
            want = ell.ell_mttkrp_plain(*lay_dt, c_dt, d_dt, n_rows=MT_I, strategy=strategy)
            errs[f"ell_mttkrp {strategy} {dt}"] = check_close(f"ell_mttkrp {strategy} {dt}", got, want, TOL[dt])
            del got, want
        v_dt = t.data.to(dt)
        got = dot.mttkrp(*t.coords, v_dt, c_dt, d_dt, n_rows=MT_I)
        want = dot.mttkrp_plain(*t.coords, v_dt, c_dt, d_dt, n_rows=MT_I)
        errs[f"coo_mttkrp {dt}"] = check_close(f"coo_mttkrp {dt}", got, want, TOL[dt])
        del got, want, lay_dt
        torch.cuda.synchronize()
    return errs


def phase_mttkrp_path(dev, t, c, d, lay, ex):
    """The MTTKRP path through its entry points, counted: every call must
    launch its kernel exactly once."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, dot, ell, reset_launch_counts

    t_ex, c_ex, d_ex, want_ex = ex
    lay_ex = ell.build_block_ell_3d(t_ex.coords[0], t_ex.coords[1], t_ex.coords[2], t_ex.data, EX_SHAPE[0], device=dev)
    runs = dict(order=lay.order, row_ptr=lay.row_ptr)
    c_ex_t, d_ex_t = torch.as_tensor(c_ex, device=dev), torch.as_tensor(d_ex, device=dev)
    calls = [
        ("ell exact", "ell_mttkrp", lambda: ell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, **runs)),
        ("ell bf16", "ell_mttkrp", lambda: ell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, strategy="bf16", **runs)),
        ("kernels.mttkrp", "coo_mttkrp", lambda: st.kernels.mttkrp(*t.coords, t.data, c, d, n_rows=MT_I)),
        ("jitops.mttkrp", "coo_mttkrp", lambda: st.jitops.mttkrp(t, c, d)),
        ("example jitops.mttkrp", "coo_mttkrp", lambda: st.jitops.mttkrp(t_ex, c_ex, d_ex)),
        (
            "example ell",
            "ell_mttkrp",
            lambda: ell.ell_mttkrp(*lay_ex[:4], c_ex_t, d_ex_t, n_rows=EX_SHAPE[0], order=lay_ex.order, row_ptr=lay_ex.row_ptr),
        ),
    ]
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = {}
    for label, counter, call in calls:
        before = dict(LAUNCHES)
        outs[label] = call()
        step = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if step != {k: int(k == counter) for k in LAUNCHES}:
            raise AssertionError(f"{label}: expected one {counter} launch and nothing else, got {step}")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    want = dot.mttkrp_plain(*t.coords, t.data.double(), c.double(), d.double(), n_rows=MT_I)
    errs = {}
    for label in ("ell exact", "ell bf16", "kernels.mttkrp", "jitops.mttkrp"):
        got = outs[label]
        if tuple(got.shape) != (MT_I, MT_R) or got.device.type != dev.type or got.dtype != torch.float32:
            raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} on {got.device}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: output not finite")
        errs[label] = normalised_err(got, want)
        limit = MT_ORACLE_TOL["bf16" if "bf16" in label else "exact"]
        if not errs[label] <= limit:
            raise AssertionError(f"{label}: off the float64 oracle by {errs[label]} (limit {limit})")
    if not torch.equal(outs["kernels.mttkrp"], outs["jitops.mttkrp"]):
        raise AssertionError("kernels.mttkrp and jitops.mttkrp differ on the same tensor")
    for label in ("example jitops.mttkrp", "example ell"):
        got = outs[label]
        if got.dtype != torch.float64:
            raise AssertionError(f"{label}: {got.dtype}, expected float64")
        np.testing.assert_allclose(got.cpu().numpy(), want_ex, rtol=EX_RTOL, err_msg=label)
    return launches, errs, want


def phase_mttkrp_times(t, c, d, lay, want, launches, errs, card, build):
    """One line per MTTKRP kernel at the BASELINE scale, with the bf16
    tables' time and the yardstick: torch.sparse.mm of the mode-1 unfolding
    (I x J*K CSR) with a Khatri-Rao product built beforehand."""
    from sparse_tpu_torch.kernels import _cuda, dot, ell

    slots, nnz = lay.order.numel(), t.nnz
    ej, ek, ed = (a.reshape(-1) for a in lay[1:4])
    ci, cj, ck = t.coords
    row_ptr_coo = torch.searchsorted(ci.long(), torch.arange(MT_I + 1, device=ci.device))
    c16, d16 = c.to(torch.bfloat16), d.to(torch.bfloat16)
    out = torch.empty((MT_I, MT_R), device=c.device)
    runs = dict(order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces)
    pieces_coo = _cuda.run_pieces(row_ptr_coo, _cuda.MTTKRP_PIECE)

    def scratch(n_slots, piece=_cuda.MTTKRP_PIECE):
        n_front = _cuda.front_bound(n_slots, MT_I, piece)
        return torch.empty(n_front * MT_R, device=c.device), _cuda.zeroed_tickets(c.device, n_front)

    part_ell, tix = scratch(slots)
    part_coo, _ = scratch(nnz)

    kr_ms = time_eager(lambda: (c[:, None, :] * d[None, :, :]).reshape(MT_J * MT_K, MT_R), reps=5)
    kr = (c[:, None, :] * d[None, :, :]).reshape(MT_J * MT_K, MT_R)
    unfold = torch.sparse_coo_tensor(
        torch.stack([ci.long(), cj.long() * MT_K + ck.long()]), t.data, (MT_I, MT_J * MT_K)
    ).coalesce().to_sparse_csr()
    library_note = "torch.sparse.mm(mode-1 unfolding CSR, Khatri-Rao (J*K, r)), Khatri-Rao built beforehand"
    try:
        lib_out = torch.sparse.mm(unfold, kr)
        torch.cuda.synchronize()
        library_err = normalised_err(lib_out, want)
        del lib_out
        library_ms = time_eager(lambda: torch.sparse.mm(unfold, kr), reps=10)
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
        library_ms, library_err = None, None
        library_note += f": {type(exc).__name__}: {str(exc).splitlines()[0][:200]}"

    table_bytes = (MT_J + MT_K) * MT_R * 4
    out_bytes = MT_I * MT_R * 4
    # the block-ELL runs: every pad slot of a block joins its local row 0,
    # so the ragged last block's row 0 is the longest run by far; timing the
    # rows before that block shows what its one warp costs
    run_len = torch.diff(lay.row_ptr[: MT_I + 1])
    full_rows = MT_I // 128 * 128

    def ell_launch(piece):
        pieces = _cuda.run_pieces(lay.row_ptr, piece)
        part, tickets = scratch(slots, piece)
        return lambda: _cuda.mttkrp(lay.row_ptr, pieces, lay.order, ej, ek, ed, c, d, out, part, tickets, piece=piece)

    # the piece P, picked on this card: no split (the first design) against 512, 256 and 128 slots
    ell_runs = {
        "longest_run": int(run_len.max()),
        "longest_run_row": int(run_len.argmax()),
        "median_run": float(run_len.float().median()),
        "piece": _cuda.MTTKRP_PIECE,
        "split_rows": int((run_len > _cuda.MTTKRP_PIECE).sum()),
        "pieces_of_split_rows": int(lay.pieces[MT_I]),
        "front_bound": _cuda.front_bound(slots, MT_I, _cuda.MTTKRP_PIECE),
        "piece_sweep_ms": {str(P): time_graph(ell_launch(P), reps=20) for P in (1 << 40, 512, 256, 128)},
        "kernel_ms_rows_before_last_block": time_graph(
            lambda: _cuda.mttkrp(lay.row_ptr, lay.pieces, lay.order, ej, ek, ed, c, d, out[:full_rows], part_ell, tix),
            reps=20,
        ),
        "rows_before_last_block": full_rows,
    }
    specs = [
        (
            "ell_mttkrp",
            lambda: _cuda.mttkrp(lay.row_ptr, lay.pieces, lay.order, ej, ek, ed, c, d, out, part_ell, tix),
            lambda: _cuda.mttkrp(lay.row_ptr, lay.pieces, lay.order, ej, ek, ed, c16, d16, out, part_ell, tix),
            lambda: ell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, **runs),
            lambda: ell.ell_mttkrp_plain(*lay[:4], c, d, n_rows=MT_I),
            # j, k, data and order per slot, the row offsets, the tables, the output
            slots * 16 + (MT_I + 1) * 8 + table_bytes + out_bytes,
            3 * slots * MT_R,
            slots,
        ),
        (
            "coo_mttkrp",
            lambda: _cuda.mttkrp(row_ptr_coo, pieces_coo, None, cj, ck, t.data, c, d, out, part_coo, tix),
            lambda: _cuda.mttkrp(row_ptr_coo, pieces_coo, None, cj, ck, t.data, c16, d16, out, part_coo, tix),
            lambda: dot.mttkrp(ci, cj, ck, t.data, c, d, n_rows=MT_I),
            lambda: dot.mttkrp_plain(ci, cj, ck, t.data, c, d, n_rows=MT_I),
            nnz * 12 + (MT_I + 1) * 8 + table_bytes + out_bytes,
            3 * nnz * MT_R,
            nnz,
        ),
    ]
    lines = []
    for name, launch, launch_bf16, wrapper, plain, nbytes, flops, n_slots in specs:
        torch.cuda.reset_peak_memory_stats()
        ms = time_graph(launch, reps=20)
        ms_bf16 = time_graph(launch_bf16, reps=20)
        ms_wrapper = time_eager(wrapper, reps=10)
        ms_cold = time_cold(launch, reps=10)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_eager(plain, reps=3)
        peak_plain = torch.cuda.max_memory_allocated()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lines.append(line)
        log(
            json.dumps(
                {
                    **line,
                    "kernel_ms": ms,
                    "kernel_ms_bf16_tables": ms_bf16,
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "library_note": library_note,
                    "library_err_vs_oracle": library_err,
                    "khatri_rao_build_ms": kr_ms,
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    # two factor rows of r values gathered per slot, through L2
                    "gathered_bytes": 2 * n_slots * MT_R * 4,
                    "peak_memory_bytes_plain": peak_plain,
                    **(ell_runs if name == "ell_mttkrp" else {}),
                    "shape": {"I": MT_I, "J": MT_J, "K": MT_K, "r": MT_R, "nnz": nnz, "slots": n_slots, "dtype": "float32"},
                    **build,
                    "card": card,
                }
            )
        )
    return lines


def phase_experiments(dev):
    """The experiments through their runners, counted: E1's ``main`` at the
    benchmark shape, then each probe at its ``__main__`` size. Each runner
    runs its output call, then times the kernel (``WARMUP + REPS`` calls
    from Python); E1's ``main`` times its full SpMV for each of its four
    runs, and K1 once."""
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    timed = WARMUP + REPS
    expected = {
        "spmv_products": 4 * (1 + timed),
        "row_ell_spmv": timed,
        "lane_gather": 2 * (2 + timed),  # the capability call and the gather
        "row_gather_sum": 1 + timed,
        "row_pick_bf16": 1 + timed,
        "scalar_gather_sum": 1 + timed,
        "lane_gather_blocksum": 2 * (1 + timed),
        "row_pick_blocksum": 1 + timed,
        "pick_scale_wsum": 1 + timed,
    }
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    spmv = e1.main(dev)
    runs = {
        "p1": v.p1(512, label="p1(512)", device=dev),
        "p1b": v.p1(8192, label="p1b(8192)", device=dev),
        "p2": v.p2(device=dev),
        "p3": v.p3(device=dev),
        "p4": v.p4(device=dev),
        "g1": v2.g1(512, n_blocks=36, device=dev),
        "g1b": v2.g1(8192, n_blocks=4, label="g1b", device=dev),
        "g2": v2.g2(device=dev),
        "g3": v2.g3(device=dev),
    }
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"the experiments phase launched {launches}, expected {want}")
    for label, run in spmv["runs"].items():
        limit = E1_ORACLE_TOL[label.split()[0]]
        if not run["relerr"] <= limit:
            raise AssertionError(f"E1 {label}: off the float64 oracle by {run['relerr']} (limit {limit})")
    for label, out in spmv["outputs"].items():
        if tuple(out.shape) != (M,) or out.device.type != "cuda" or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"E1 {label}: {tuple(out.shape)} on {out.device}")
    return spmv, runs, launches, seconds


def phase_experiments_vs_plain(spmv, runs):
    """Each of the eight kernels against its plain version on the phase's
    own inputs at full size: the picks bit for bit, the sums at PROBE_TOL.
    Returns the largest absolute difference of each run, by its label."""
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2

    def exact(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel and plain version differ by {float((got - want).abs().max())}")
        return 0.0

    errs = {}
    re, x = spmv["layout"], spmv["x"]
    fc, fd = e1.flatten_tiers(re, 2048)
    for hilo in (True, False):
        x2 = e1.make_table(x, hilo)
        errs[f"E1 {'hilo' if hilo else 'bf16'} blk=2048"] = exact("spmv_products", e1.products(x2, fc, fd), e1.products_plain(x2, fc, fd))
    for key in ("p1", "p1b"):
        r = runs[key]
        table, idx = r.inputs["table"], r.inputs["idx"]
        h = min(table.shape[0], 512)
        exact(f"lane_gather {r.label} capability", r.outputs[0], v.lane_gather_plain(table[:h], idx[:8] % h))
        errs[r.label] = exact(f"lane_gather {r.label}", r.outputs[1], v.lane_gather_plain(table, idx))
    r = runs["p2"]
    errs["p2"] = check_close("row_gather_sum", r.outputs[0], v.row_gather_sum_plain(r.inputs["strip"], r.inputs["idx"], 1024), PROBE_TOL)
    r = runs["p3"]
    errs["p3"] = exact("row_pick_bf16", r.outputs[0], v.row_pick_bf16_plain(r.inputs["strip"], r.inputs["idx"]))
    r = runs["p4"]
    errs["p4"] = check_close(
        "scalar_gather_sum", r.outputs[0], v.scalar_gather_sum_plain(r.inputs["x"], r.inputs["qi"], r.inputs["qj"], 1024), PROBE_TOL
    )
    for key in ("g1", "g1b"):
        r = runs[key]
        T = r.inputs["table"].shape[0]
        want = v2.lane_gather_blocksum_plain(r.inputs["table"], r.inputs["idx"], T)
        errs[r.label] = check_close(f"lane_gather_blocksum {r.label}", r.outputs[0], want, PROBE_TOL)
    r = runs["g2"]
    want = v2.row_pick_blocksum_plain(r.inputs["table"], r.inputs["cols"], r.inputs["table"].shape[0])
    errs["g2"] = check_close("row_pick_blocksum", r.outputs[0], want, PROBE_TOL)
    r = runs["g3"]
    want = v2.pick_scale_wsum_plain(r.inputs["table"], r.inputs["cols2"], r.inputs["data2"])
    errs["g3"] = check_close("pick_scale_wsum", r.outputs[0], want, PROBE_TOL)
    torch.cuda.synchronize()
    return errs


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_experiments_times(spmv, runs, launches, errs, card):
    """One line per probe run and one kernel row per kernel: device ms and
    the rate in the experiment's unit, the byte bound (each input read once,
    each output written once) and its share, the L2 bytes of the whole-row
    picks and their rate, the plain version's ms and one PyTorch call's."""
    import torch.nn.functional as F

    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2
    from sparse_tpu_torch.experiments.common import Run
    from sparse_tpu_torch.kernels import _cuda

    # E1: the products kernel alone, on the blk=2048 stream of the main run
    re, x = spmv["layout"], spmv["x"]
    fc, fd = e1.flatten_tiers(re, 2048)
    x2h, x2b = e1.make_table(x, True), e1.make_table(x, False)
    out = torch.empty((fc.numel(), 1), device=fc.device)
    e1_ms = {t: time_graph(lambda x2=x2: _cuda.spmv_products(x2, fc, fd, out)) for t, x2 in (("hilo", x2h), ("bf16", x2b))}
    e1_run = Run("E1 hilo blk=2048", {}, (out,), spmv["nnz"], "M nnz/s", e1_ms["hilo"])

    specs = []

    def add(name, run, plain, library, note, tensors, whole_rows=False):
        """``tensors``: the inputs and outputs, each counted once in the bound;
        ``whole_rows``: the run picks n 512-byte table rows through L2."""
        specs.append((name, run, plain, library, note, nbytes(*tensors), run.n * L2_ROW_BYTES if whole_rows else None))

    add("spmv_products", e1_run, lambda: e1.products_plain(x2h, fc, fd), None,
        "none: no single PyTorch call picks from a hi|lo bf16 table", (fc, fd, x2h, out))
    for r in (runs["p1"], runs["p1b"]):
        table, idx = r.inputs["table"], r.inputs["idx"]
        i64 = idx.long()
        add("lane_gather", r, lambda t=table, i=idx: v.lane_gather_plain(t, i), lambda t=table, i=i64: torch.gather(t, 0, i),
            "torch.gather(table, 0, idx), idx int64 beforehand", (table, idx, r.outputs[1]))
    r = runs["p2"]
    strip, idx = r.inputs["strip"], r.inputs["idx"]
    bags = idx.long().view(-1, 1024)
    add("row_gather_sum", r, lambda: v.row_gather_sum_plain(strip, idx, 1024), lambda: F.embedding_bag(bags, strip, mode="sum"),
        "F.embedding_bag(idx.view(128, 1024), strip, mode='sum')", (strip, idx, r.outputs[0]), whole_rows=True)
    r = runs["p3"]
    strip3, idx3 = r.inputs["strip"], r.inputs["idx"]
    rounded, i3 = strip3.to(torch.bfloat16).float(), idx3.long()
    add("row_pick_bf16", r, lambda: v.row_pick_bf16_plain(strip3, idx3), lambda: torch.index_select(rounded, 0, i3),
        "torch.index_select on the strip rounded to bf16 beforehand", (strip3, idx3, r.outputs[0]))
    r = runs["p4"]
    xs, qi, qj = r.inputs["x"], r.inputs["qi"], r.inputs["qj"]
    flat = (qi.long() * xs.shape[1] + qj.long()).view(-1, 1024)
    add("scalar_gather_sum", r, lambda: v.scalar_gather_sum_plain(xs, qi, qj, 1024),
        lambda: F.embedding_bag(flat, xs.view(-1, 1), mode="sum"),
        "F.embedding_bag(flat indices (64, 1024), x.view(-1, 1), mode='sum')", (xs, qi, qj, r.outputs[0]))
    for r in (runs["g1"], runs["g1b"]):
        table, idx = r.inputs["table"], r.inputs["idx"]
        add("lane_gather_blocksum", r, lambda t=table, i=idx: v2.lane_gather_blocksum_plain(t, i, t.shape[0]), None,
            "none: no single PyTorch call gathers per lane and sums blocks", (table, idx, r.outputs[0]))
    r = runs["g2"]
    table2, cols = r.inputs["table"], r.inputs["cols"]
    bags2 = cols.long().view(-1, table2.shape[0])
    add("row_pick_blocksum", r, lambda: v2.row_pick_blocksum_plain(table2, cols, table2.shape[0]),
        lambda: F.embedding_bag(bags2, table2, mode="sum"),
        "F.embedding_bag(cols.view(285, 8192), table, mode='sum')", (table2, cols, r.outputs[0]), whole_rows=True)
    r = runs["g3"]
    table3, cols2, data2 = r.inputs["table"], r.inputs["cols2"], r.inputs["data2"]
    n_cells, _, w = cols2.shape

    def regroup(t):  # the picks each kept output row adds: (cell, r < 8, g < 64, w)
        return t.view(n_cells, 64, 128, w)[:, :, :8, :].permute(0, 2, 1, 3).reshape(n_cells * 8, 64 * w).contiguous()

    bags3, weights3 = regroup(cols2.long()), regroup(data2)
    add("pick_scale_wsum", r, lambda: v2.pick_scale_wsum_plain(table3, cols2, data2),
        lambda: F.embedding_bag(bags3, table3, mode="sum", per_sample_weights=weights3),
        "F.embedding_bag(mode='sum', per_sample_weights) over the 1/16 of the picks that the 8 kept rows of each "
        "cell add, regrouped beforehand", (table3, cols2, data2, r.outputs[0]), whole_rows=True)

    rows, seen = [], set()
    for name, run, plain, library, note, nb, l2 in specs:
        plain_ms = time_eager(plain, reps=3)
        library_ms = None if library is None else time_eager(library, reps=10)
        bound_ms = nb / HBM_BYTES_PER_S * 1e3
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[run.label],
            "ms": run.ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": library_ms,
        }
        log(
            json.dumps(
                {
                    **line,
                    "probe": run.label,
                    "rate": run.rate,
                    "unit": run.unit,
                    "n": run.n,
                    "bound_bytes": nb,
                    "bound_share": bound_ms / run.ms,
                    "l2_bytes": l2,
                    "l2_tb_per_s": None if l2 is None else l2 / (run.ms * 1e-3) / 1e12,
                    "library_note": note,
                    **({"kernel_ms_bf16_table": e1_ms["bf16"]} if name == "spmv_products" else {}),
                    "card": card,
                }
            )
        )
        if name not in seen:  # the first run of each kernel is its row
            seen.add(name)
            rows.append(line)
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    import sparse_tpu_torch  # noqa: F401  (fails here when run outside the repository)
    from sparse_tpu_torch.kernels import _cuda

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi_name_power()
    log(f"device: {kind} count={count} nvidia-smi: {card} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.load_all()
    log(f"build: all sources in {time.perf_counter() - t0:.2f} s")
    for name, info in _cuda.BUILD_INFO.items():
        if "seconds" in info:
            log(f"build {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
            log(info["ptxas"].strip())
        else:
            log(f"build {name}: library already built at {info['path']}")

    # the sparse x dense main path (row-ELL)
    errs = phase_kernels_vs_plain(dev)
    log(json.dumps({"kernel_vs_plain": "ok", "bench_max_abs_err_f32": errs}))
    a, re, b, x, launches = phase_main_path(dev)
    lines = phase_times(a, re, b, x, launches, errs, card)
    del a, re, b, x
    torch.cuda.empty_cache()

    # the block-sparse layer (BSR)
    layer, lx, target, wsum = layer_layout(dev)
    bsr_errs, cmp_launches, sddmm_cmp = phase_bsr_kernels_vs_plain(dev, layer, lx, wsum)
    log(json.dumps({"bsr_kernel_vs_plain": "ok", "layer_max_abs_err_f32": bsr_errs, "launches": cmp_launches, "sddmm": sddmm_cmp}))
    training = phase_training(dev, layer, lx, target, wsum)
    breakdown = phase_step_breakdown(layer, lx, wsum)
    log(json.dumps({"training_path": "ok", **training, "step_breakdown_device_ms": breakdown, "card": card}))
    pairs_launches, pairs_err = phase_pairs_path(dev, layer, lx)
    log(json.dumps({"pairs_path": "ok", "launches": pairs_launches, "err_vs_layer_forward": pairs_err}))
    vjp_launches, vjp_errs, vjp_equal = phase_vjp_path(layer, lx, wsum)
    log(json.dumps({"vjp_path": "ok", "launches": vjp_launches, "err_vs_trainable": vjp_errs, "d_blocks_equal": vjp_equal}))
    bsr_launches = {**training["launches"], "bsr_spmm2": pairs_launches["bsr_spmm2"]}
    lines += phase_bsr_times(layer, lx, wsum, bsr_launches, bsr_errs, card)
    del layer, lx, target, wsum
    torch.cuda.empty_cache()

    # the MTTKRP of a 3-D tensor (block-ELL and sorted-COO forms)
    t, c, d, lay, build = mttkrp_problem(dev)
    cmp_errs = phase_mttkrp_vs_plain(t, c, d, lay)
    log(json.dumps({"mttkrp_kernel_vs_plain": "ok", "max_abs_err": cmp_errs}))
    ex = example_problem(dev)
    mt_launches, oracle_errs, want = phase_mttkrp_path(dev, t, c, d, lay, ex)
    log(
        json.dumps(
            {
                "mttkrp_path": "ok",
                "nnz": t.nnz,
                "slots": lay.order.numel(),
                "cap": lay.e_rows.shape[1],
                "launches": mt_launches,
                "err_vs_f64_oracle": oracle_errs,
                "example": {"shape": EX_SHAPE, "r": EX_R, "nnz": ex[0].nnz, "rtol": EX_RTOL},
                **build,
            }
        )
    )
    mt_errs = {"ell_mttkrp": cmp_errs["ell_mttkrp exact torch.float32"], "coo_mttkrp": cmp_errs["coo_mttkrp torch.float32"]}
    lines += phase_mttkrp_times(t, c, d, lay, want, mt_launches, mt_errs, card, build)
    del t, c, d, lay, ex, want
    torch.cuda.empty_cache()

    # the experiments: the one-hot SpMV prototype and the VMEM gather probes
    spmv, runs, ex_launches, ex_seconds = phase_experiments(dev)
    ex_errs = phase_experiments_vs_plain(spmv, runs)
    log(
        json.dumps(
            {
                "experiments": "ok",
                "seconds": ex_seconds,
                "launches": ex_launches,
                "e1_entries": spmv["entries"],
                "e1_padded": spmv["padded"],
                "e1_full_spmv": spmv["runs"],
                "k1_row_ell_spmv": spmv["row_ell_spmv"],
                "probes": {r.label: {"ms": r.ms, "rate": r.rate, "unit": r.unit, "n": r.n} for r in runs.values()},
                "max_abs_err_vs_plain": ex_errs,
                "card": card,
            }
        )
    )
    lines += phase_experiments_times(spmv, runs, ex_launches, ex_errs, card)
    del spmv, runs
    torch.cuda.empty_cache()

    log(json.dumps({"kernels": lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
