#!/usr/bin/env python3
"""Smoke test of sparse_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source under sparse_tpu_torch/kernels/csrc/, all started together) and
drives the port's two paths on the card:

- the sparse × dense main path: holds the row-ELL kernels against their
  plain PyTorch versions (the SpMM's staged kernel also against its
  one-warp-per-position kernel, and the SpMV's cluster kernel against its
  thread kernel, bit for bit), drives ``COO`` → ``a @ B`` / ``a @ x`` /
  ``matvec_add`` at the benchmark shape (65,536², 2^21 entry draws, N = 128,
  float32) and the spmv_add shape (99,990 × 100,000 at density 1e-6), and
  checks the outputs against a float64 scipy oracle; builds ``CSR`` and
  ``CSC`` arrays of the same matrix on the card and runs their products
  (``csr @ B``, ``csc @ B``, ``csr @ x``, ``csc @ x``, ``matvec_add``)
  through the same kernels, each equal bit for bit to the COO's, the second
  ``csr @ B`` on the held COO's cached layout; then runs both SpMV
  kernels at both shapes in float32 and float64, with and without y, bit
  for bit alike and against the oracle, with the entry point's default and their
  warm and L2-flushed times;
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
  kernels held against its plain version (E1 on both tables and, with a
  table too tall for shared memory, on its L2 route; g1, g1b, g2 and p2
  twice, bit for bit; p4 twice, bit for bit), E1's line with both tables'
  times and designs, p4's with its launch floor, g1's,
  g1b's, p1's and p1b's with their route (column slices in shared memory,
  or L2), p2's with its launch plan and L2 floor, and
  the card's gather rates: p3's write rate beside ``out.zero_()`` on an
  output of its size (the write ceiling), g2's shared-memory pick rate
  beside its first route's whole-row L2 rate, both timed in this run.

- SDDMM (BASELINE config 4, the ``sddmm_path`` line) on the benchmark
  matrix as the mask, K = 128, float32, ``rhs`` given as a transposed
  view: ``sparse_tpu_torch.sddmm`` against a float64 oracle (each entry
  within 1e-5 of |s| · Σ_k |lhs_ik · rhs_kj|), K4 against its plain
  version (2e-6 of the same scale) and twice bit for bit, its kept-row and
  per-entry routes bit for bit alike, the gradient of ``(w ·
  sddmm).sum()`` in s, lhs and rhs (K4 and K5, the gradient's row sum)
  against the plain version's, twice bit for bit, through
  ``kernels.sddmm`` and the COO entry point alike; the same mask with both
  operands MN-major (a weight gradient's layout: the copy rule's route
  and the strided reads it declines, bit for bit alike); the example's
  shape (a 10,000^2 float64 dense pair, a 1,000-entry mask) against its
  oracle at rtol 1e-8, its row-major ``rhs`` read in place; and dense ×
  sparse ``Bt @ a`` (Bt of 128 x 65,536) against a float64 oracle and
  equal bit for bit to ``(a.T @ Bt.T).T``, its route through K2 on the
  cached transpose; K4 timed at both shapes beside
  ``torch.sparse.sampled_addmm``, the backward beside the first port's
  torch ops (device ms and peak memory), each K5 launch beside
  ``torch.sparse.mm``;

- sparse × sparse products (SpGEMM, BASELINE config 2's example; the
  ``spgemm_path`` line): ``a @ a`` of the benchmark matrix (6.7e7 partial
  products) against scipy's ``csr @ csr`` on the host (coordinates
  exactly, values at rtol 1e-5 of a float64 oracle), twice bit for bit,
  its device ms (median of 5 eager calls), peak memory, byte bound and
  ``torch.profiler``'s top kernels beside cuSPARSE's ``torch.sparse.mm``
  of the two CSRs; the example's two 100,000² GCXS at density 1e-5
  (float64) as CSR × CSR and CSC × CSC within 1e-10 of scipy;
  ``jitops.spgemm`` of two 4,096² matrices at density 5e-4 captured in a
  CUDA graph and replayed after their values changed, against the eager
  product; ``einsum("ij,jk->ik", s, s)`` bit for bit ``s @ s``. No kernel
  of the package runs here: the JAX package leaves SpGEMM to XLA and the
  host;

- element-wise operations and reductions (BASELINE config 3, the
  ``elemwise_path`` line): unions, comparisons, a dense row, a broadcast
  sparse column, ufuncs, a cast and the reductions of the bench matrix as
  COO, CSR and CSC, the MTTKRP tensor's sums, max and a dense scale, and
  ``var``/``std`` of a 4,096² matrix, each against a float64 scipy or
  bincount oracle (coordinates exactly, values at rtol 1e-6), the float
  reductions twice bit for bit, each timed (device ms, median of 5 eager
  calls) beside torch.sparse where torch has the operation. No kernel of
  the package runs here: the JAX package leaves this path to XLA.

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
    "row_ell_spmv_cluster": "sparse_tpu_torch/kernels/csrc/row_ell.cu",
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
    "sddmm": "sparse_tpu_torch/kernels/csrc/sddmm.cu",
    "sampled_row_sum": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",
}
REPLACES = {
    "row_ell_spmv": "sparse_tpu/kernels/row_ell.py:231",  # _onehot_products_call (Pallas)
    "row_ell_spmv_cluster": "sparse_tpu/kernels/row_ell.py:231",  # the same, x in a cluster's shared memory
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
    "sddmm": "sparse_tpu/kernels/dot.py:103",  # sddmm (XLA gather + sum)
    "sampled_row_sum": "sparse_tpu/kernels/dot.py:124",  # the transpose of sddmm's gathers (XLA segment sum)
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

# SDDMM (BASELINE config 4) on the bench matrix as the mask: lhs (65,536,
# 128) and rhs (128, 65,536) given as a transposed view, float32, from a
# seeded torch.Generator (sparse_tpu/kernels/dot.py:91-95's large shape).
# Against a float64 oracle each entry within SD_ORACLE_TOL · |s| · Σ_k
# |lhs_ik · rhs_kj|; K4 against its plain version within SD_PLAIN_TOL of the
# same scale; the gradients of (w · sddmm).sum() against the plain version's
# at max|got - want| / max|want| <= SD_GRAD_TOL
SD_K = 128
SD_ORACLE_TOL, SD_PLAIN_TOL, SD_GRAD_TOL = 1e-5, 2e-6, 1e-5
# the example's shape (examples/sddmm_example.py): a 10,000^2 float64 dense
# pair and a mask of 1,000 entries, its own limit
SD_EX_LEN, SD_EX_NNZ, SD_EX_RTOL = 10_000, 1000, 1e-8

# the one-hot SpMV prototype against the float64 oracle, max|out - oracle| /
# max|oracle|, by table (the prototype's docstring: ~1e-5 and ~2e-3)
E1_ORACLE_TOL = {"hilo": 1e-4, "bf16": 1e-2}
# probe sums against their plain versions: up to 8,192 positive terms, about
# 4e3 at most, added in another order
PROBE_TOL = dict(rtol=1e-4, atol=1e-3)
L2_ROW_BYTES = 128 * 4  # one picked f32 table row
L2_ROW_BYTES_PER_S = 7.3e12  # the card's whole-row L2 rate (PERF.md §5), E4's floor


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
    staged kernel equal bit for bit to its one-warp-per-position kernel, K1's
    cluster kernel to its thread kernel."""
    from sparse_tpu_torch.kernels import _cuda, row_ell

    rng = np.random.default_rng(1)
    errs = {"row_ell_spmv": 0.0, "row_ell_spmv_cluster": 0.0, "row_ell_spmm": 0.0}
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
            k1 = {}
            for yy in (None, y):
                k1[yy is None] = [_cuda.spmv(re, x, yy, torch.empty(m, dtype=dt, device=dev), kernel=kn) for kn in ("thread", "cluster")]
                if not torch.equal(*k1[yy is None]):
                    raise AssertionError(f"spmv {case} {dt} y={yy is not None}: the cluster and thread kernels differ")
            if case == "bench" and dt == torch.float32:
                errs["row_ell_spmv"] = max(e, e_y)
                errs["row_ell_spmv_cluster"] = max(
                    check_close("spmv cluster", k1[True][1], row_ell._spmv_plain(re, x), TOL[dt]),
                    check_close("spmv+y cluster", k1[False][1], row_ell._spmv_plain(re, x, y), TOL[dt]),
                )
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


def phase_gcxs_path(dev, a, b, x):
    """CSR and CSC at the benchmark shape through the public entry points,
    counted: each built from the COO ``a`` on the card (``a.asformat("csr")``,
    ``CSC(a)``), then ``csr @ B``, ``csc @ B``, ``csr @ x``, ``csc @ x`` and
    ``matvec_add`` of both, each equal bit for bit to the COO's product and
    within ORACLE_TOL of a float64 oracle; the second ``csr @ B`` runs on the
    held COO's cached layout, and ``csr.tocoo()`` and ``csc.tocoo()`` equal
    ``a``."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

    y = torch.as_tensor(np.random.default_rng(5).random(M, dtype=np.float32), device=dev)
    want = {"B": a @ b, "x": a @ x, "x+y": st.matvec_add(a, x, y)}
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    csr = a.asformat("csr")
    torch.cuda.synchronize()
    t_csr = time.perf_counter()
    csc = st.CSC(a)
    torch.cuda.synchronize()
    t_csc = time.perf_counter()
    outs = {"csr@B": csr @ b}
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    held = csr._product_coo()
    layout = held.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
    outs["csr@B again"] = csr @ b
    torch.cuda.synchronize()
    t_second = time.perf_counter()
    reused = csr._product_coo() is held and held.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY) is layout
    if layout is None or not reused:
        raise AssertionError("the second csr @ B did not reuse the held COO's cached row-ELL layout")
    outs["csc@B"] = csc @ b
    torch.cuda.synchronize()
    t_csc_first = time.perf_counter()
    outs["csr@x"] = csr @ x
    outs["csc@x"] = csc @ x
    outs["matvec_add csr"] = st.matvec_add(csr, x, y)
    outs["matvec_add csc"] = st.matvec_add(csc, x, y)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(LAUNCHES)

    for name in ("row_ell_spmv", "row_ell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"the GCXS path never launched {name}: {launches}")
    coords, data = a.coords.cpu().numpy(), a.data.cpu().numpy()
    ref = oracle_csr(coords[0], coords[1], data, (M, K))
    oracle = {"B": ref @ b.cpu().numpy().astype(np.float64), "x": ref @ x.cpu().numpy().astype(np.float64)}
    oracle["x+y"] = oracle["x"] + y.cpu().numpy()
    for name, got in outs.items():
        key = "B" if name.endswith(("B", "again")) else ("x+y" if name.startswith("matvec") else "x")
        if got.device.type != "cuda" or not torch.equal(got, want[key]):
            raise AssertionError(f"{name}: not equal bit for bit to the COO's product")
        np.testing.assert_allclose(got.cpu().numpy(), oracle[key], **ORACLE_TOL, err_msg=name)
    for name, g in (("csr", csr), ("csc", csc)):
        back = g.tocoo()
        if not (torch.equal(back.coords, a.coords) and torch.equal(back.data, a.data)):
            raise AssertionError(f"{name}.tocoo() differs from the COO it was built from")
    log(
        json.dumps(
            {
                "gcxs_path": "ok",
                "nnz": csr.nnz,
                "launches": launches,
                "csr_build_s": t_csr - t0,
                "csc_build_s": t_csc - t_csr,
                "first_csr_matmul_s_incl_layout_build": t_first - t_csc,
                "second_csr_matmul_s": t_second - t_first,
                "first_csc_matmul_s_incl_coo_and_layout_build": t_csc_first - t_second,
                "total_s": t_end - t0,
                "index_dtypes": {"indices": str(csr.indices.dtype), "indptr": str(csr.indptr.dtype)},
            }
        )
    )
    return launches


def phase_k1(dev, card):
    """K1's two kernels at the bench shape and the spmv_add shape, float32 and
    float64, with and without y, through ``_cuda.spmv(kernel=...)``: equal bit
    for bit, each within the float64 oracle's rtol (bench.py:53), the kernel
    that ``row_ell_spmv`` launches by default, and each kernel's time warm
    (CUDA graph, in turns) and after an L2 flush. One JSON line each shape and
    dtype. Returns the launches of this path (the counts are set to 0 before
    each shape and dtype's calls and read after them, before the timing):
    both kernels must have run."""
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts, row_ell

    counted = dict.fromkeys(LAUNCHES, 0)
    rng = np.random.default_rng(3)
    m2, k2 = SPMV_ADD_SHAPE
    shapes = {"bench": (M, K, NNZ_DRAWS), "spmv_add": (m2, k2, round(m2 * k2 * SPMV_ADD_DENSITY))}
    for shape, (m, k, draws) in shapes.items():
        lin = np.unique(rng.integers(0, m * k, size=draws, dtype=np.int64))
        rows, cols = lin // k, lin % k
        vals, x_np, y_np = rng.random(lin.size), rng.random(k), rng.random(m)
        for dt, np_dt in ((torch.float32, np.float32), (torch.float64, np.float64)):
            ref = oracle_csr(rows, cols, vals.astype(np_dt), (m, k))
            want = ref @ x_np.astype(np_dt).astype(np.float64)
            re = row_ell.build_row_ell(rows, cols, vals.astype(np_dt), m, k, device=dev)
            x = torch.as_tensor(x_np, dtype=dt, device=dev)
            y = torch.as_tensor(y_np, dtype=dt, device=dev)
            rel, outs = {}, {}
            torch.cuda.synchronize()
            reset_launch_counts()
            for yy, w in ((None, want), (y, want + y_np.astype(np_dt))):
                pair = [_cuda.spmv(re, x, yy, torch.empty(m, dtype=dt, device=dev), kernel=kn) for kn in ("thread", "cluster")]
                if not torch.equal(*pair):
                    raise AssertionError(f"K1 {shape} {dt} y={yy is not None}: the cluster and thread kernels differ")
                got = pair[1].cpu().numpy().astype(np.float64)
                np.testing.assert_allclose(got, w, **ORACLE_TOL, err_msg=f"K1 {shape} {dt}")
                outs[yy is None] = pair[0]
                rel["y" if yy is not None else "no_y"] = float(np.abs(got - w).max() / max(np.abs(w).max(), 1e-300))
            # the kernel the entry point launches by default, read from the counters
            before = dict(LAUNCHES)
            if not torch.equal(row_ell.row_ell_spmv(re, x), outs[True]):
                raise AssertionError(f"K1 {shape} {dt}: row_ell_spmv differs from the thread kernel")
            default = [kn for kn in ("row_ell_spmv", "row_ell_spmv_cluster") if LAUNCHES[kn] > before[kn]]
            torch.cuda.synchronize()
            counted = {kn: counted[kn] + LAUNCHES[kn] for kn in counted}
            out = torch.empty(m, dtype=dt, device=dev)
            runs = {kn: (lambda kn=kn: _cuda.spmv(re, x, None, out, kernel=kn)) for kn in ("thread", "cluster")}
            ms = {}
            for order in (list(runs), list(runs)[::-1]):
                for kn in order:
                    ms[kn] = min(time_graph(runs[kn]), ms.get(kn, float("inf")))
            cold = {kn: time_cold(fn) for kn, fn in runs.items()}
            # cols + values read, touched values of x read, out written
            nbytes = (lin.size * (4 + dt.itemsize) + np.unique(cols).size * dt.itemsize + m * dt.itemsize)
            log(
                json.dumps(
                    {
                        "k1": shape,
                        "dtype": str(dt).replace("torch.", ""),
                        "nnz": int(lin.size),
                        "default": default,
                        "plan": _cuda.row_ell_spmv_plan(re, dt)._asdict(),
                        "equal_bit_for_bit": True,
                        "max_rel_err_vs_f64_oracle": rel,
                        "kernel_ms": ms,
                        "kernel_ms_l2_flushed": cold,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                        "bound_share": {kn: nbytes / HBM_BYTES_PER_S * 1e3 / v for kn, v in ms.items()},
                        "card": card,
                    }
                )
            )
            del re, x, y, out
        torch.cuda.empty_cache()
    for name in ("row_ell_spmv", "row_ell_spmv_cluster"):
        if counted[name] == 0:
            raise AssertionError(f"the K1 phase never launched {name}: {counted}")
    log(json.dumps({"k1_path": "ok", "launches": counted}))
    return counted


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
        (
            "row_ell_spmv_cluster",
            lambda: _cuda.spmv(re, x, None, out_v, kernel="cluster"),
            # the entry point that asks for the cluster kernel
            lambda: _cuda.spmv(re, x, None, torch.empty_like(out_v), kernel="cluster"),
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
                    **({"plan": _cuda.row_ell_spmv_plan(re, torch.float32)._asdict()} if name == "row_ell_spmv_cluster" else {}),
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
        # a table too tall for shared memory (1,024 rows) takes the L2 route; half the picks in its second half
        tall = e1.make_table(torch.cat([x, x.flip(0)]), hilo)
        c2 = fc.clone()
        c2[1::2] += x.numel()
        exact("spmv_products l2 route", e1.products(tall, c2, fd), e1.products_plain(tall, c2, fd))
    for key in ("p1", "p1b"):
        r = runs[key]
        table, idx = r.inputs["table"], r.inputs["idx"]
        h = min(table.shape[0], 512)
        exact(f"lane_gather {r.label} capability", r.outputs[0], v.lane_gather_plain(table[:h], idx[:8] % h))
        errs[r.label] = exact(f"lane_gather {r.label}", r.outputs[1], v.lane_gather_plain(table, idx))
    r = runs["p2"]
    errs["p2"] = check_close("row_gather_sum", r.outputs[0], v.row_gather_sum_plain(r.inputs["strip"], r.inputs["idx"], 1024), PROBE_TOL)
    again = v.row_gather_sum(r.inputs["strip"], r.inputs["idx"], 1024)  # sums in the plan's fixed order
    torch.cuda.synchronize()
    if not torch.equal(again, r.outputs[0]):
        raise AssertionError("row_gather_sum: two launches differ")
    r = runs["p3"]
    errs["p3"] = exact("row_pick_bf16", r.outputs[0], v.row_pick_bf16_plain(r.inputs["strip"], r.inputs["idx"]))
    r = runs["p4"]
    xs, qi, qj = r.inputs["x"], r.inputs["qi"], r.inputs["qj"]
    e6_plain = v.scalar_gather_sum_plain(xs, qi, qj, 1024)
    errs["p4"] = check_close("scalar_gather_sum", r.outputs[0], e6_plain, PROBE_TOL)
    again = v.scalar_gather_sum(xs, qi, qj, 1024)  # its sums in a fixed order
    torch.cuda.synchronize()
    if not torch.equal(again, r.outputs[0]):
        raise AssertionError("scalar_gather_sum: two launches differ")
    for key in ("g1", "g1b"):
        r = runs[key]
        T = r.inputs["table"].shape[0]
        want = v2.lane_gather_blocksum_plain(r.inputs["table"], r.inputs["idx"], T)
        errs[r.label] = check_close(f"lane_gather_blocksum {r.label}", r.outputs[0], want, PROBE_TOL)
        again = v2.lane_gather_blocksum(r.inputs["table"], r.inputs["idx"], T)  # sums in a fixed order
        torch.cuda.synchronize()
        if not torch.equal(again, r.outputs[0]):
            raise AssertionError(f"lane_gather_blocksum {r.label}: two launches differ")
    r = runs["g2"]
    table, cols = r.inputs["table"], r.inputs["cols"]
    want = v2.row_pick_blocksum_plain(table, cols, table.shape[0])
    errs["g2"] = check_close("row_pick_blocksum", r.outputs[0], want, PROBE_TOL)
    again = v2.row_pick_blocksum(table, cols, table.shape[0])  # its sums in a fixed order: the same bits every launch
    torch.cuda.synchronize()
    if not torch.equal(again, r.outputs[0]):
        raise AssertionError("row_pick_blocksum: two launches differ")
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
    e1_fields = {
        "kernel_ms_hilo_table": e1_ms["hilo"],
        "kernel_ms_bf16_table": e1_ms["bf16"],
        "design": {t: _cuda.spmv_products_design(x2.shape[0], t == "hilo") for t, x2 in (("hilo", x2h), ("bf16", x2b))},
        "bound_ms_bf16_table": nbytes(fc, fd, x2b, out) / HBM_BYTES_PER_S * 1e3,
    }

    specs = []

    def add(name, run, plain, library, note, tensors, whole_rows=False, more_bytes=0, extra=None, fields=None):
        """``tensors``: the inputs and outputs, each counted once in the bound,
        with ``more_bytes``; ``whole_rows``: the run picks n 512-byte table
        rows through L2; ``extra``: a function of the kernel's ms giving more
        fields of the run's line; ``fields``: more fields of the kernel's row."""
        specs.append(
            (name, run, plain, library, note, nbytes(*tensors) + more_bytes,
             run.n * L2_ROW_BYTES if whole_rows else None, extra, fields or {})
        )

    add("spmv_products", e1_run, lambda: e1.products_plain(x2h, fc, fd), None,
        "none: no single PyTorch call picks from a hi|lo bf16 table", (fc, fd, x2h, out))
    # the route of each lane-gather run, by its table (column slices in shared memory, or L2)
    p1_designs = {r.label: _cuda.lane_gather_design(r.inputs["table"].shape[0]) for r in (runs["p1"], runs["p1b"])}
    for r in (runs["p1"], runs["p1b"]):
        table, idx = r.inputs["table"], r.inputs["idx"]
        i64 = idx.long()
        add("lane_gather", r, lambda t=table, i=idx: v.lane_gather_plain(t, i), lambda t=table, i=i64: torch.gather(t, 0, i),
            "torch.gather(table, 0, idx), idx int64 beforehand", (table, idx, r.outputs[1]),
            fields={"design": p1_designs[r.label], "designs": p1_designs})
    r = runs["p2"]
    strip, idx = r.inputs["strip"], r.inputs["idx"]
    bags = idx.long().view(-1, 1024)
    p2_plan = _cuda.row_gather_sum_plan(1024, bags.shape[0], torch.cuda.get_device_properties(idx.device).multi_processor_count)
    add("row_gather_sum", r, lambda: v.row_gather_sum_plain(strip, idx, 1024), lambda: F.embedding_bag(bags, strip, mode="sum"),
        "F.embedding_bag(idx.view(128, 1024), strip, mode='sum')", (strip, idx, r.outputs[0]), whole_rows=True,
        extra=lambda ms, n=r.n: {"l2_floor_ms": n * L2_ROW_BYTES / L2_ROW_BYTES_PER_S * 1e3},
        fields={"plan": p2_plan._asdict(), "two_launches_equal": True})
    r = runs["p3"]
    strip3, idx3 = r.inputs["strip"], r.inputs["idx"]
    rounded, i3 = strip3.to(torch.bfloat16).float(), idx3.long()
    # the card's write ceiling: out.zero_() on an output of p3's size
    blank = torch.empty_like(r.outputs[0])
    zero_ms = time_graph(blank.zero_)
    del blank
    written = r.outputs[0].numel() * 4

    def p3_extra(ms):
        return {
            "write_tb_per_s": written / (ms * 1e-3) / 1e12,
            "zero_ms": zero_ms,
            "zero_write_tb_per_s": written / (zero_ms * 1e-3) / 1e12,
            "ms_over_zero_ms": ms / zero_ms,
            "strip_in_shared_memory": _cuda.row_pick_bf16_resident(strip3.shape[0]),
        }

    add("row_pick_bf16", r, lambda: v.row_pick_bf16_plain(strip3, idx3), lambda: torch.index_select(rounded, 0, i3),
        "torch.index_select on the strip rounded to bf16 beforehand", (strip3, idx3, r.outputs[0]), extra=p3_extra)
    r = runs["p4"]
    xs, qi, qj = r.inputs["x"], r.inputs["qi"], r.inputs["qj"]
    flat = (qi.long() * xs.shape[1] + qj.long()).view(-1, 1024)
    # E6's kernel cut to the launch alone (the launch floor) and to the index
    # loads and sums
    e6_out = torch.empty_like(r.outputs[0])
    e6_stages = {st_: time_graph(lambda st_=st_: _cuda.scalar_gather_sum_stage(xs, qi, qj, e6_out, 1024, st_))
                 for st_ in _cuda.SCALAR_GATHER_STAGES}
    add("scalar_gather_sum", r, lambda: v.scalar_gather_sum_plain(xs, qi, qj, 1024),
        lambda: F.embedding_bag(flat, xs.view(-1, 1), mode="sum"),
        "F.embedding_bag(flat indices (64, 1024), x.view(-1, 1), mode='sum')", (xs, qi, qj, r.outputs[0]),
        fields={"design": "a CTA of 256 threads a segment, four picks a thread (the first port's; wider CTAs, "
                          "int2/int4 index loads and a cluster split were slower: PERF.md section 6)",
                "launch_floor_ms": e6_stages["launch"], "indices_only_ms": e6_stages["indices"],
                "two_launches_equal": True, "card": card})
    for r in (runs["g1"], runs["g1b"]):
        table, idx = r.inputs["table"], r.inputs["idx"]
        route = "slices" if _cuda.lane_slice_resident(table.shape[0]) else "l2"
        add("lane_gather_blocksum", r, lambda t=table, i=idx: v2.lane_gather_blocksum_plain(t, i, t.shape[0]), None,
            "none: no single PyTorch call gathers per lane and sums blocks", (table, idx, r.outputs[0]),
            extra=lambda ms, route=route: {"table_route": route})
    r = runs["g2"]
    table2, cols = r.inputs["table"], r.inputs["cols"]
    T2 = table2.shape[0]
    bags2 = cols.long().view(-1, T2)
    # the first port's route, every pick a 512-byte row read through L2 (E4's
    # row gather): the card's whole-row L2 rate, beside the rate of picks served from shared memory
    rows_out = torch.empty_like(r.outputs[0])
    rows_ms = time_graph(lambda: _cuda.row_pick_blocksum(table2, cols, rows_out, T2, route="rows"))
    check_close("row_pick_blocksum rows route", rows_out, v2.row_pick_blocksum_plain(table2, cols, T2), PROBE_TOL)
    plan2 = _cuda.row_pick_count_plan(T2)
    picked = r.n * L2_ROW_BYTES

    def g2_extra(ms):
        return {
            "smem_pick_tb_per_s": picked / (ms * 1e-3) / 1e12,
            "picked_bytes": picked,
            "l2_index_bytes": plan2.n_slices * nbytes(cols),
            "slice_plan": plan2._asdict(),
            "rows_route_ms": rows_ms,
            "rows_route_l2_tb_per_s": picked / (rows_ms * 1e-3) / 1e12,
        }

    add("row_pick_blocksum", r, lambda: v2.row_pick_blocksum_plain(table2, cols, T2),
        lambda: F.embedding_bag(bags2, table2, mode="sum"),
        "F.embedding_bag(cols.view(285, 8192), table, mode='sum')", (table2, cols, r.outputs[0]), extra=g2_extra)
    r = runs["g3"]
    table3, cols2, data2 = r.inputs["table"], r.inputs["cols2"], r.inputs["data2"]
    n_cells, _, w = cols2.shape

    def regroup(t):  # the picks each kept output row adds: (cell, r < 8, g < 64, w)
        return t.view(n_cells, 64, 128, w)[:, :, :8, :].permute(0, 2, 1, 3).reshape(n_cells * 8, 64 * w).contiguous()

    bags3, weights3 = regroup(cols2.long()), regroup(data2)
    # the bound counts the work the output keeps: the table, the out rows and
    # the indices and weights of the run.n picks the 8 kept rows of a cell add
    add("pick_scale_wsum", r, lambda: v2.pick_scale_wsum_plain(table3, cols2, data2),
        lambda: F.embedding_bag(bags3, table3, mode="sum", per_sample_weights=weights3),
        "F.embedding_bag(mode='sum', per_sample_weights) over the 1/16 of the picks that the 8 kept rows of each "
        "cell add, regrouped beforehand", (table3, r.outputs[0]), whole_rows=True, more_bytes=r.n * 8)

    rows, seen = [], set()
    for name, run, plain, library, note, nb, l2, extra, fields in specs:
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
            **fields,
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
                    **(e1_fields if name == "spmv_products" else {}),
                    **(extra(run.ms) if extra else {}),
                    "card": card,
                }
            )
        )
        if name not in seen:  # the first run of each kernel is its row
            seen.add(name)
            rows.append(line)
    return rows


# ---------------------------------------------------------------------------
# elementwise operations and reductions (BASELINE config 3)
# ---------------------------------------------------------------------------

def sddmm_oracle(rows, cols, s, lhs, rhs_t, chunk=1 << 16):
    """float64 values of an SDDMM and each entry's scale |s| · Σ_k |lhs_ik ·
    rhs_kj|, in chunks on the card."""
    want = torch.empty(rows.numel(), dtype=torch.float64, device=rows.device)
    scale = torch.empty_like(want)
    for i in range(0, rows.numel(), chunk):
        prod = lhs[rows[i : i + chunk].long()].double() * rhs_t[cols[i : i + chunk].long()].double()
        sv = s[i : i + chunk].double()
        want[i : i + chunk] = sv * prod.sum(-1)
        scale[i : i + chunk] = sv.abs() * prod.abs().sum(-1)
    return want, scale


def check_sddmm(name, got, want, scale, tol):
    """Each entry within ``tol · scale`` of ``want``; the worst ratio."""
    err = (got.double() - want).abs()
    if bool((err > tol * scale).any()):
        raise AssertionError(f"{name}: {int((err > tol * scale).sum())} entries beyond {tol} of their scale")
    return float((err / scale.clamp_min(1e-300)).max()) if err.numel() else 0.0


def sddmm_example(dev):
    """The example's problem (examples/sddmm_example.py): a 10,000^2 float64
    dense pair and a 1,000-entry mask drawn with numpy from a seed, the mask
    as a COO on the card, and the oracle at the mask's coordinates."""
    import sparse_tpu_torch as st

    rng = np.random.default_rng(0)
    n = SD_EX_LEN
    lhs, rhs = rng.random((n, n)), rng.random((n, n))
    lin = np.sort(rng.choice(n * n, size=SD_EX_NNZ, replace=False))
    r, c, v = lin // n, lin % n, rng.random(SD_EX_NNZ)
    want = v * np.einsum("ek,ek->e", lhs[r], rhs.T[c])
    s = st.COO(np.stack([r, c]), v, shape=(n, n), device=dev)
    return s, torch.as_tensor(lhs, device=dev), torch.as_tensor(rhs, device=dev), want


def host_ahead_ms(fn, reps=20):
    """Device ms per call of ``fn`` with the host ahead of the card: a spin
    twice as long as the host takes to enqueue ``reps`` calls keeps the card
    busy while they are enqueued, then CUDA events around the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 2e9))  # cycles at about 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def backward_ms_and_peak(fn, rows, cols, s, lhs, rhs, w, reps=5):
    """The backward of ``(w · fn(rows, cols, s, lhs, rhs)).sum()`` in ``s``,
    ``lhs`` and ``rhs``: the bytes it allocates beyond what was live before
    it (the three gradients included); its device ms, a forward and
    backward less the forward, each with the host ahead
    (:func:`host_ahead_ms`; each forward builds its pattern anew, so the
    backward's sorts count); the eager ms of a forward and backward (the
    host's enqueue included); the gradients of two such calls."""
    ins = [t.detach().clone().requires_grad_(True) for t in (s, lhs, rhs)]
    loss = (w * fn(rows, cols, *ins)).sum()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = torch.autograd.grad(loss, ins)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    step = lambda: torch.autograd.grad((w * fn(rows, cols, *ins)).sum(), ins)  # noqa: E731
    second = step()

    def forward():
        with torch.no_grad():
            return fn(rows, cols, *ins)

    both, fwd = host_ahead_ms(step, reps=reps), host_ahead_ms(forward, reps=reps)
    timing = {
        "device_ms": both - fwd,
        "forward_backward_device_ms": both,
        "forward_device_ms": fwd,
        "forward_backward_ms_eager": time_eager(step, reps=reps),
        "extra_peak_bytes": peak,
    }
    return timing, first, second


def plain_backward(rows, cols, s, lhs, rhs, w):
    """The gradients of ``(w · sddmm).sum()`` in s, lhs and rhs as the port
    first computed them (``d s`` by K4, then two gathered (nnz, K) blocks
    summed by ``index_add_``, ``sampled_row_sum_plain``)."""
    from sparse_tpu_torch.kernels import dot as kdot

    gs = w * s
    return (
        kdot.sddmm(rows, cols, w, lhs, rhs),
        kdot.sampled_row_sum_plain(rows, cols, gs, rhs.T, lhs.shape[0]),
        kdot.sampled_row_sum_plain(cols, rows, gs, lhs, rhs.shape[1]).T,
    )


def plain_backward_ms_and_peak(rows, cols, s, lhs, rhs, w, reps=5):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = plain_backward(rows, cols, s, lhs, rhs, w)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    call = lambda: plain_backward(rows, cols, s, lhs, rhs, w)  # noqa: E731
    return {
        "device_ms": host_ahead_ms(call, reps=reps),
        "ms_eager": time_eager(call, reps=reps),
        "extra_peak_bytes": peak,
    }


def kept_row_loads(rows, epw):
    """The lhs rows K4's kept-row route loads: one at each group's first
    entry and wherever the row changes."""
    fresh = torch.ones(rows.numel(), dtype=torch.bool, device=rows.device)
    fresh[1:] = rows[1:] != rows[:-1]
    fresh[::epw] = True
    return int(fresh.sum())


def phase_sddmm_path(dev, a, card):
    """SDDMM (BASELINE config 4) and dense × sparse through the public entry
    points, counted: ``sddmm(a, lhs, rhs)`` at the bench shape against a
    float64 oracle, against the plain version and twice bit for bit, the
    gradient of ``(w · sddmm).sum()`` (K4 and K5) against the plain
    version's and twice bit for bit, through ``kernels.sddmm`` and through
    the COO entry point (equal bit for bit); the example's shape against its
    oracle at rtol 1e-8; ``Bt @ a`` against a float64 oracle and bit for bit
    equal to ``(a.T @ Bt.T).T`` (its route through K2). Then times K4 (both
    routes; both operands MN-major, the copy rule's route and the other),
    the example's call, the backward against the first port's and each K5
    launch. Returns the ``kernels`` lines of K4 and K5 and the launches of
    the path (counts set to 0 just before it, read just after)."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts
    from sparse_tpu_torch.kernels import dot as kdot
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

    gen = torch.Generator(device=dev).manual_seed(15)
    lhs = torch.randn((M, SD_K), generator=gen, device=dev)
    rhs = torch.randn((K, SD_K), generator=gen, device=dev).T  # (128, 65,536), rows of rhs.T contiguous
    w = torch.randn(a.nnz, generator=gen, device=dev)
    bt = torch.rand((N, M), generator=gen, device=dev)
    ex_s, ex_lhs, ex_rhs, ex_want = sddmm_example(dev)
    rows, cols, s = a.coords[0], a.coords[1], a.data
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = st.sddmm(a, lhs, rhs)
    torch.cuda.synchronize()
    t_sddmm = time.perf_counter()
    ins = [t.detach().clone().requires_grad_(True) for t in (s, lhs, rhs)]
    (w * kdot.sddmm(rows, cols, *ins)).sum().backward()
    torch.cuda.synchronize()
    t_grad = time.perf_counter()
    coo_ins = [t.detach().clone().requires_grad_(True) for t in (lhs, rhs)]
    (w * st.sddmm(a, *coo_ins).data).sum().backward()
    torch.cuda.synchronize()
    t_coo_grad = time.perf_counter()
    ex_out = st.sddmm(ex_s, ex_lhs, ex_rhs)
    torch.cuda.synchronize()
    t_ex = time.perf_counter()
    xs = bt @ a
    torch.cuda.synchronize()
    t_xs = time.perf_counter()
    layout = a.T.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
    xs2 = bt @ a
    torch.cuda.synchronize()
    t_xs2 = time.perf_counter()
    launches = dict(LAUNCHES)
    for name in ("sddmm", "sampled_row_sum", "row_ell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"the SDDMM path never launched {name}: {launches}")

    # bench shape: the result's form, the oracle, the plain version, the bits
    if not isinstance(out, st.COO) or out.dtype != torch.float32 or float(out.fill_value) != 0.0:
        raise AssertionError(f"sddmm gave {type(out).__name__} {out.dtype} fill {out.fill_value}")
    if not torch.equal(out.coords, a.coords) or out.coords.data_ptr() == a.coords.data_ptr():
        raise AssertionError("sddmm: the coordinates are not a copy of the sample's")
    want, scale = sddmm_oracle(rows, cols, s, lhs, rhs.T)
    worst = {"oracle": check_sddmm("sddmm vs oracle", out.data, want, scale, SD_ORACLE_TOL)}
    plain = kdot.sddmm_plain(rows, cols, s, lhs, rhs)
    worst["plain"] = check_sddmm("K4 vs sddmm_plain", out.data, plain.double(), scale, SD_PLAIN_TOL)
    if not torch.equal(st.sddmm(a, lhs, rhs).data, out.data):
        raise AssertionError("sddmm: a second launch gave other bits")
    ins_p = [t.detach().clone().requires_grad_(True) for t in (s, lhs, rhs)]
    (w * kdot.sddmm_plain(rows, cols, *ins_p)).sum().backward()
    grad_err = {n: normalised_err(x.grad, y.grad.double()) for n, x, y in zip(("s", "lhs", "rhs"), ins, ins_p)}
    if max(grad_err.values()) > SD_GRAD_TOL:
        raise AssertionError(f"sddmm gradients against the plain version's: {grad_err}")
    if not all(torch.equal(x.grad, y.grad) for x, y in zip(ins[1:], coo_ins)):
        raise AssertionError("sddmm: the COO entry point's gradients differ from kernels.sddmm's")
    max_abs_err = float((out.data - plain).abs().max())
    del plain, want, ins_p
    # the example's shape
    np.testing.assert_allclose(ex_out.data.cpu().numpy(), ex_want, rtol=SD_EX_RTOL, err_msg="sddmm example shape")
    ex_plain = kdot.sddmm_plain(ex_s.coords[0], ex_s.coords[1], ex_s.data, ex_lhs, ex_rhs)
    ex_err = float((ex_out.data - ex_plain).abs().max())
    # dense x sparse: the oracle, and the route through a's cached transpose
    oracle = oracle_csr(*a.coords.cpu().numpy(), a.data.cpu().numpy(), (M, K))
    np.testing.assert_allclose(
        xs.cpu().numpy(), (oracle.T @ bt.cpu().numpy().T.astype(np.float64)).T, **ORACLE_TOL, err_msg="Bt @ a"
    )
    if layout is None or not torch.equal(xs, (a.T @ bt.T).T) or not torch.equal(xs, xs2):
        raise AssertionError("Bt @ a: not on a's cached transpose, or not equal bit for bit to (a.T @ Bt.T).T")
    torch.cuda.synchronize()

    lines, timing = [], {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # K4 at the two shapes, its wrapper, the plain version and torch.sparse.sampled_addmm
    shapes = {
        "bench": (rows, cols, s, lhs, rhs, launches["sddmm"], max_abs_err),
        "example": (ex_s.coords[0], ex_s.coords[1], ex_s.data, ex_lhs, ex_rhs, launches["sddmm"], ex_err),
    }
    for shape, (r, c, sv, lh, rh, n_launch, err) in shapes.items():
        o = torch.empty_like(sv)
        rh_rows = kdot._sddmm_operand(rh.T, r.numel())  # as the wrapper reads it
        launch = lambda r=r, c=c, sv=sv, lh=lh, rh_rows=rh_rows, o=o, route=None: _cuda.sddmm(  # noqa: E731
            r, c, sv, lh, rh_rows, o, route=route
        )
        pattern = torch.sparse_csr_tensor(
            torch.searchsorted(r.long(), torch.arange(lh.shape[0] + 1, device=dev)), c.long(), sv, (lh.shape[0], rh.shape[1])
        )
        library = lambda pattern=pattern, lh=lh, rh=rh, sv=sv: torch.sparse.sampled_addmm(pattern, lh, rh, beta=0.0).values() * sv
        try:
            lib_got = library()
        except RuntimeError:  # cuSPARSE may refuse a transposed view: then on a contiguous copy
            rh_c = rh.contiguous()
            library = lambda pattern=pattern, lh=lh, rh_c=rh_c, sv=sv: torch.sparse.sampled_addmm(pattern, lh, rh_c, beta=0.0).values() * sv
            lib_got = library()
        lib_err = float((lib_got - launch()).abs().max())
        item, k_dim, nnz = lh.element_size(), lh.shape[1], r.numel()
        nbytes = (int(torch.unique(r).numel()) + int(torch.unique(c).numel())) * k_dim * item + nnz * (4 + 4 + 2 * item)
        flops = 2 * nnz * k_dim
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (F32_FLOPS_PER_S if item == 4 else F32_FLOPS_PER_S / 2) * 1e3
        route = _cuda.sddmm_route(k_dim, item, _cuda.sddmm_vec(lh) and _cuda.sddmm_vec(rh_rows))
        epw = _cuda.sddmm_entries_per_warp(nnz, sms)
        lhs_loads = kept_row_loads(r, epw) if route == "kept_row" else nnz
        ms = time_graph(launch)
        line = {
            "name": "sddmm",
            "route": "cuda",
            "source": SOURCE["sddmm"],
            "replaces": REPLACES["sddmm"],
            "launches": n_launch,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_eager(lambda: kdot.sddmm_plain(r, c, sv, lh, rh), reps=5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_eager(library, reps=5),
        }
        if shape == "example":
            line["shape"] = "example"
        lines.append(line)
        gathered = (lhs_loads + nnz) * k_dim * item
        copied = rh_rows.data_ptr() != rh.data_ptr()
        timing[shape] = {
            **line,
            "k4_route": route,
            "kernel_ms_l2_flushed": time_cold(launch),
            "wrapper_ms_eager": time_eager(lambda: kdot.sddmm(r, c, sv, lh, rh), reps=5),
            "rhs_t_copied": copied,
            "rhs_t_copy_ms": time_eager(lambda: rh.T.contiguous(), reps=5) if copied else 0.0,
            "entries_per_warp": epw,
            "bound_bytes": nbytes,
            "bound_share": max(t_bytes, t_ops) / ms,
            "lhs_row_loads": lhs_loads,
            "gathered_bytes": gathered,
            "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
            "l2_floor_ms": gathered / L2_ROW_BYTES_PER_S * 1e3,
            "library_max_abs_diff": lib_err,
            "card": card,
            "shape": {
                "m": lh.shape[0], "n": rh.shape[1], "k": k_dim, "nnz": nnz, "dtype": str(lh.dtype).replace("torch.", "")
            },
        }
        if shape == "bench":
            # both routes on the same operands, bit for bit alike
            by_route = {rt: launch(route=rt).clone() for rt in _cuda.SDDMM_ROUTES}
            if not torch.equal(by_route["kept_row"], by_route["per_entry"]):
                raise AssertionError("K4: the kept-row and per-entry routes gave other bits")
            timing[shape]["route_ms"] = {rt: time_graph(lambda rt=rt: launch(route=rt)) for rt in _cuda.SDDMM_ROUTES}
            timing[shape]["per_entry_gathered_bytes"] = 2 * nnz * k_dim * item
        del o, pattern, lib_got

    # the bench mask with both operands MN-major (a weight gradient's layout): the
    # copy rule's route (the wrapper, copies included) and the strided reads it declines
    lhs_mn = torch.randn((SD_K, M), generator=gen, device=dev).T
    rhs_mn = torch.randn((SD_K, K), generator=gen, device=dev)
    in_place = [_cuda.sddmm_reads_in_place(tuple(t.shape), t.stride(), 4, a.nnz) for t in (lhs_mn, rhs_mn.T)]
    o = torch.empty_like(s)
    strided = lambda: _cuda.sddmm(rows, cols, s, lhs_mn, rhs_mn.T, o)
    chosen = kdot.sddmm(rows, cols, s, lhs_mn, rhs_mn)
    if not torch.equal(chosen, strided()):
        raise AssertionError("K4: MN-major operands read in place gave other bits than their copies")
    mn_major = {
        "read_in_place": {"lhs": in_place[0], "rhs_t": in_place[1]},
        "chosen": "in_place" if all(in_place) else "copy",
        "chosen_ms_eager": time_eager(lambda: kdot.sddmm(rows, cols, s, lhs_mn, rhs_mn), reps=5),
        "copies_ms_eager": time_eager(lambda: (lhs_mn.contiguous(), rhs_mn.T.contiguous()), reps=5),
        "declined_in_place_ms": time_graph(strided, reps=5),
        "equal_bit_for_bit": True,
    }
    del lhs_mn, rhs_mn, o, chosen

    # the backward at the bench shape: the first port's (torch ops) and K5's
    new_bw, g1, g2 = backward_ms_and_peak(kdot.sddmm, rows, cols, s, lhs, rhs, w, reps=20)
    if not all(torch.equal(x, y) for x, y in zip(g1, g2)):
        raise AssertionError("sddmm backward: a second call gave other bits")
    block = a.nnz * SD_K * 4
    if new_bw["extra_peak_bytes"] >= block:
        raise AssertionError(f"sddmm backward allocated {new_bw['extra_peak_bytes']} bytes; an (nnz, K) block: {block}")
    del g1, g2
    # the COO entry point's: its rows known sorted and its pattern kept on the array across calls
    kept = a.peek_layout("sddmm_pattern", (M, K))
    if kept is None or kept.ordered != (True, False):
        raise AssertionError("sddmm: the COO entry point kept no pattern of its sorted rows")
    coo_bw, _, _ = backward_ms_and_peak(
        lambda r, c, sv, lh, rh: kdot._sddmm(r, c, sv, lh, rh, pattern=kept), rows, cols, s, lhs, rhs, w, reps=20
    )
    plain_bw = plain_backward_ms_and_peak(rows, cols, s, lhs, rhs, w)
    backward = {"plain": plain_bw, "k5": new_bw, "k5_coo_pattern_kept": coo_bw}
    # each K5 launch of the backward alone: d lhs (rows, in place) and d rhs (columns, through the stable sort)
    gs = w * s
    plan = kdot.SddmmPattern(rows, cols, M, K, rows_sorted=True)
    k5 = {}
    for of, axis, table, n_out in (("d_lhs", 0, rhs.T, M), ("d_rhs", 1, lhs, K)):
        ptr, order, pieces, idx = plan.plan(axis)
        seg = plan.ends[axis]
        w_seg = gs if order is None else gs[order]
        n_front = _cuda.front_bound(a.nnz, n_out, _cuda.MTTKRP_PIECE)
        o = torch.empty((n_out, SD_K), device=dev)
        partial = torch.empty(n_front * SD_K, device=dev)
        tickets = _cuda.zeroed_tickets(dev, n_front * _cuda.row_sum_chunks(SD_K, torch.float32))
        args = (ptr, pieces, idx, w_seg, table, o, partial, tickets)
        launch = lambda args=args: _cuda.sampled_row_sum(*args)  # noqa: E731
        got = launch().clone()
        if not torch.equal(got, launch()):
            raise AssertionError(f"K5 {of}: a second launch gave other bits")
        other = plan.ends[1 - axis]
        want_p = kdot.sampled_row_sum_plain(seg, other, gs, table, n_out)
        scale_p = kdot.sampled_row_sum_plain(seg, other, gs.abs(), table.abs(), n_out)
        if bool(((got - want_p).abs() > SD_GRAD_TOL * scale_p + 1e-30).any()):
            raise AssertionError(f"K5 {of} against sampled_row_sum_plain beyond {SD_GRAD_TOL} of its scale")
        csr = torch.sparse_csr_tensor(ptr, idx.long(), w_seg, (n_out, table.shape[0]))
        lib_err = float((torch.sparse.mm(csr, table) - got).abs().max())
        touched = int(torch.unique(other).numel())
        nbytes = touched * SD_K * 4 + a.nnz * (4 + 4) + n_out * SD_K * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * a.nnz * SD_K / F32_FLOPS_PER_S * 1e3
        ms = time_graph(launch)
        line = {
            "name": "sampled_row_sum",
            "route": "cuda",
            "source": SOURCE["sampled_row_sum"],
            "replaces": REPLACES["sampled_row_sum"],
            "launches": launches["sampled_row_sum"],
            "max_abs_err": float((got - want_p).abs().max()),
            "ms": ms,
            "plain_ms": time_eager(lambda: kdot.sampled_row_sum_plain(seg, other, gs, table, n_out), reps=5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_eager(lambda csr=csr, table=table: torch.sparse.mm(csr, table), reps=5),
            "of": of,
        }
        lines.append(line)
        gathered = a.nnz * SD_K * 4
        k5[of] = {
            **line,
            "bound_bytes": nbytes,
            "bound_share": max(t_bytes, t_ops) / ms,
            "gathered_bytes": gathered,
            "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
            "l2_floor_ms": gathered / L2_ROW_BYTES_PER_S * 1e3,
            "library_max_abs_diff": lib_err,
            "order": "in place" if order is None else "stable sort",
            "weights_gather_ms": 0.0 if order is None else time_graph(lambda order=order: gs[order]),
            "pieces": int(pieces[-1]),
            "kernel_ms_l2_flushed": time_cold(launch),
            "card": card,
        }
        del o, partial, got, want_p, scale_p, csr, w_seg
    plan_ms = time_eager(lambda: kdot.SddmmPattern(rows, cols, M, K).plan(1), reps=5)
    cols32 = cols.int()
    sort_ms = time_eager(lambda: torch.sort(cols32, stable=True), reps=20)
    log(
        json.dumps(
            {
                "sddmm_path": "ok",
                "nnz": a.nnz,
                "k": SD_K,
                "launches": launches,
                "sddmm_s": t_sddmm - t0,
                "sddmm_and_gradient_s": t_grad - t_sddmm,
                "coo_sddmm_and_gradient_s": t_coo_grad - t_grad,
                "example_s": t_ex - t_coo_grad,
                "worst_over_scale": worst,
                "gradient_err_vs_plain": grad_err,
                "backward": backward,
                "k5": k5,
                "column_order_ms_eager": plan_ms,
                "column_sort_ms": sort_ms,
                "mn_major": mn_major,
                "example": {"len": SD_EX_LEN, "nnz": ex_s.nnz, "rtol": SD_EX_RTOL, "max_abs_err_vs_plain": ex_err},
                "dense_x_sparse": {
                    "shape": [N, M],
                    "first_s_incl_transpose_and_layout": t_xs - t_ex,
                    "second_s": t_xs2 - t_xs,
                    "device_ms": device_ms(lambda: bt @ a),
                    "equal_bit_for_bit_to_aT_BtT": True,
                },
                "k4": timing,
                "card": card,
            }
        )
    )
    return lines, launches


# SpGEMM (BASELINE config 2's example, examples/matmul_example.py): the
# bench matrix squared (float32, values against a float64 oracle at
# SG_RTOL); the example's two 100,000^2 GCXS at density 1e-5 (float64, its
# own limit |got - scipy| < SG_EX_ATOL); the traceable form at
# bench_regression.py:248-270's shape (two 4,096^2 at density 5e-4,
# float32) in a CUDA graph, against the eager product at SG_GRAPH_RTOL
SG_RTOL, SG_EX_LEN, SG_EX_DENSITY, SG_EX_ATOL = 1e-5, 100_000, 1e-5, 1e-10
SG_JIT_LEN, SG_JIT_DENSITY, SG_GRAPH_RTOL = 4096, 5e-4, 1e-6
SG_REPS = 5


def _unique_draw(rng, n, density, dtype):
    """Rows, columns and values of an ``n`` x ``n`` matrix at ``density``:
    ``n^2 · density`` distinct positions, values uniform in [0, 1)."""
    lin = np.unique(rng.integers(0, n * n, size=round(n * n * density), dtype=np.int64))
    while lin.size < round(n * n * density):
        lin = np.unique(np.concatenate([lin, rng.integers(0, n * n, size=round(n * n * density) - lin.size)]))
    return lin // n, lin % n, rng.random(lin.size).astype(dtype)


def _same_product(name, c1, c2):
    """Two results of one product: the same coordinates and the same bits."""
    if not (torch.equal(c1.coords, c2.coords) and torch.equal(c1.data.view(torch.int32), c2.data.view(torch.int32))):
        raise AssertionError(f"{name}: two calls differ")


def phase_spgemm_path(dev, a, card):
    """Sparse × sparse products through the public entry points, counted
    (no hand kernel runs: the counts stay 0): ``a @ a`` of the bench matrix
    against scipy's ``csr @ csr`` on the host (coordinates exactly, values at
    SG_RTOL of a float64 oracle), twice bit for bit, its device ms, peak
    memory and byte bound beside cuSPARSE's ``torch.sparse.mm`` of the two
    CSRs (timed only); the example's GCXS pair (CSR × CSR and CSC × CSC)
    within SG_EX_ATOL of scipy; ``jitops.spgemm`` captured in a CUDA graph
    and replayed after the data changed, against the eager product; and
    ``einsum("ij,jk->ik", s, s)`` bit for bit ``s @ s``. Returns the line's
    fields."""
    import scipy.sparse

    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, product_count, reset_launch_counts

    t_phase = time.perf_counter()
    n_products = product_count(a.coords[1], a.coords[0], K)
    torch.cuda.synchronize()
    reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c1 = a @ a
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(LAUNCHES)
    c2 = a @ a
    _same_product("a @ a", c1, c2)
    if c1.shape != (M, K) or c1.data.dtype != torch.float32 or c1.data.device.type != "cuda":
        raise AssertionError(f"a @ a: {c1}")
    if not bool(torch.isfinite(c1.data).all()):
        raise AssertionError("a @ a: values not finite")
    del c2
    ms = device_ms(lambda: a @ a, reps=SG_REPS)
    from chip_elemwise_profile import profile

    wall_ms, busy_ms, top = profile(lambda: a @ a)  # torch.profiler: where the call's time goes

    # the oracle: scipy's csr @ csr on the host, in float64
    t0 = time.perf_counter()
    coords = a.coords.cpu().numpy()
    ref = scipy.sparse.csr_matrix((a.data.cpu().numpy().astype(np.float64), (coords[0], coords[1])), shape=(M, K))
    want = ref @ ref
    want.sort_indices()
    want.eliminate_zeros()
    oracle_s = time.perf_counter() - t0
    got = c1.coords.cpu().numpy()
    rows = np.repeat(np.arange(M, dtype=np.int64), np.diff(want.indptr))
    if got.shape[1] != want.nnz or not (np.array_equal(got[0], rows) and np.array_equal(got[1], want.indices)):
        raise AssertionError(f"a @ a: {got.shape[1]} coordinates, scipy {want.nnz}, or they differ")
    np.testing.assert_allclose(c1.data.cpu().numpy().astype(np.float64), want.data, rtol=SG_RTOL, err_msg="a @ a")
    del rows, got, want
    nnz_out = c1.nnz
    idx_bytes = a.coords.element_size() * 2 + a.data.element_size()
    out_bytes = nnz_out * (c1.coords.element_size() * 2 + c1.data.element_size())
    bound_ms = (2 * a.nnz * idx_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    del c1

    # cuSPARSE on the same inputs, timed only
    a_csr = a.asformat("csr")
    csr = torch.sparse_csr_tensor(a_csr.indptr.long(), a_csr.indices.long(), a_csr.data, size=(M, K))
    del a_csr
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lib = torch.sparse.mm(csr, csr)
    torch.cuda.synchronize()
    lib_peak = torch.cuda.max_memory_allocated() - base
    lib_nnz = lib._nnz()
    del lib
    lib_ms = device_ms(lambda: torch.sparse.mm(csr, csr), reps=SG_REPS)
    del csr
    torch.cuda.empty_cache()

    # the example's GCXS pair (examples/matmul_example.py), float64
    rng = np.random.default_rng(0)
    ex = {}
    ea, eb = (_unique_draw(rng, SG_EX_LEN, SG_EX_DENSITY, np.float64) for _ in range(2))
    sa, sb = (scipy.sparse.csr_matrix((v, (r, c)), shape=(SG_EX_LEN,) * 2) for r, c, v in (ea, eb))
    want = sa @ sb
    for fmt, ca in (("gcxs", (0,)), ("csc", (1,))):
        ga, gb = (st.COO(np.stack([r, c]), v, shape=(SG_EX_LEN,) * 2, device=dev).asformat(fmt) for r, c, v in (ea, eb))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = ga @ gb
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not isinstance(g, st.GCXS) or g.compressed_axes != ca or g.data.device.type != "cuda":
            raise AssertionError(f"example {fmt}: {g}")
        err = float(abs(g.to_scipy_sparse().tocsr() - want).max())
        if not err < SG_EX_ATOL:
            raise AssertionError(f"example {fmt}: max |got - scipy| {err}")
        ex[fmt] = {"compressed_axes": list(ca), "nnz": g.nnz, "max_abs_err_vs_scipy": err, "first_s": wall,
                   "device_ms": device_ms(lambda: ga @ gb, reps=SG_REPS)}
    ex_products = product_count(torch.as_tensor(ea[1]), torch.as_tensor(eb[0]), SG_EX_LEN)

    # the traceable form in a CUDA graph (bench_regression.py:248-270's shape)
    rng = np.random.default_rng(2)
    ja, jb = (st.COO(np.stack([r, c]), v, shape=(SG_JIT_LEN,) * 2, device=dev)
              for r, c, v in (_unique_draw(rng, SG_JIT_LEN, SG_JIT_DENSITY, np.float32) for _ in range(2)))
    cap = max(product_count(ja.coords[1], jb.coords[0], SG_JIT_LEN), 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        st.jitops.spgemm(ja, jb, product_capacity=cap)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, nnz = st.jitops.spgemm(ja, jb, product_capacity=cap)
    # new values in the captured buffers: the replay reads them
    ja.data.copy_(torch.rand(ja.nnz, device=dev, generator=torch.Generator(device=dev).manual_seed(3)) + 0.5)
    jb.data.copy_(torch.rand(jb.nnz, device=dev, generator=torch.Generator(device=dev).manual_seed(4)) + 0.5)
    graph.replay()
    torch.cuda.synchronize()
    eager = st.COO._make(ja.coords, ja.data, ja.shape, ja.fill_value) @ st.COO._make(jb.coords, jb.data, jb.shape, jb.fill_value)
    n = int(nnz)
    if n != eager.nnz or not torch.equal(out.coords[:, :n].long(), eager.coords.long()):
        raise AssertionError(f"jitops.spgemm in a CUDA graph: {n} entries, eager {eager.nnz}, or coordinates differ")
    torch.testing.assert_close(out.data[:n], eager.data, rtol=SG_GRAPH_RTOL, atol=0)
    if bool((out.data[n:] != 0).any()) or bool((out.coords[:, n:] != 0).any()):
        raise AssertionError("jitops.spgemm: padding is not zero")
    graph_ms = device_ms(graph.replay, reps=SG_REPS)
    ein = st.einsum("ij,jk->ik", ja, jb)
    if not (torch.equal(ein.coords, eager.coords) and torch.equal(ein.data.view(torch.int32), eager.data.view(torch.int32))):
        raise AssertionError("einsum('ij,jk->ik', s, s) differs from s @ s")
    jit = {"shape": [SG_JIT_LEN] * 2, "nnz": [ja.nnz, jb.nnz], "product_capacity": cap, "nnz_out": n,
           "graph_replay_ms": graph_ms, "eager_ms": device_ms(lambda: ja @ jb, reps=SG_REPS), "einsum_bit_for_bit": True}
    del graph, out, nnz, eager, ein
    torch.cuda.empty_cache()
    return {
        "spgemm_path": "ok",
        "bench_square": {
            "shape": [M, K], "nnz_a": a.nnz, "product_count": n_products, "nnz_out": nnz_out,
            "device_ms": ms, "first_call_s": first_s, "peak_memory_bytes": peak,
            "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
            "cusparse_ms": lib_ms, "cusparse_peak_memory_bytes": lib_peak, "cusparse_nnz": lib_nnz,
            "profile": {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms, "top5_kernels_ms_count": top},
            "same_bits_twice": True, "coords_equal_scipy": True, "rtol_vs_f64": SG_RTOL, "scipy_oracle_s": oracle_s,
        },
        "example_gcxs": {"len": SG_EX_LEN, "density": SG_EX_DENSITY, "product_count": ex_products, **ex},
        "jitops_cuda_graph": jit,
        "launches": launches,
        "seconds": time.perf_counter() - t_phase,
        "card": card,
    }


ELEM_RTOL = 1e-6  # float32 results against the float64 scipy / bincount oracle
ELEM_REPS = 5
R_ROWS = 64  # stored rows of the (65,536, 1) column r
DENSE_NATURE = (4096, 1e-3)  # var/std shape: a 4,096^2 matrix at density 1e-3


def device_ms(fn, reps=ELEM_REPS):
    """Median device ms of one eager call of ``fn`` (CUDA events around it;
    the call's reads back to the host included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bits_equal(x, y):
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y) and x.dtype == y.dtype
    return np.asarray(x).tobytes() == np.asarray(y).tobytes()


def check_sparse_2d(name, got, want, dtype, fill=0.0):
    """A 2-D port result (COO or GCXS, on the card) against a scipy float64
    oracle: coordinates exactly, values at ELEM_RTOL, dtype and fill."""
    coo = got.tocoo()
    if coo.data.device.type != "cuda":
        raise AssertionError(f"{name}: result on {coo.data.device}")
    if np.dtype(str(coo.dtype).replace("torch.", "")) != np.dtype(dtype) or float(got.fill_value) != fill:
        raise AssertionError(f"{name}: dtype {coo.dtype} fill {got.fill_value}, want {np.dtype(dtype)} {fill}")
    w = want.tocoo()
    keep = w.data != fill
    order = np.lexsort((w.col[keep], w.row[keep]))
    rows, cols, vals = w.row[keep][order], w.col[keep][order], w.data[keep][order]
    coords = coo.coords.cpu().numpy()
    if coords.shape[1] != rows.size or not (np.array_equal(coords[0], rows) and np.array_equal(coords[1], cols)):
        raise AssertionError(f"{name}: {coords.shape[1]} coordinates, the oracle {rows.size}, or they differ")
    np.testing.assert_allclose(coo.data.cpu().numpy().astype(np.float64), vals.astype(np.float64), rtol=ELEM_RTOL, err_msg=name)
    return coo.nnz


def check_entries(name, got, lin, vals, dtype, fill=0.0):
    """A port result (on the card) against the oracle's raveled positions
    ``lin`` and float64 values: positions exactly, values at ELEM_RTOL,
    dtype and fill value as NumPy's."""
    coo = got.tocoo()
    if coo.data.device.type != "cuda":
        raise AssertionError(f"{name}: result on {coo.data.device}")
    if np.dtype(str(coo.dtype).replace("torch.", "")) != np.dtype(dtype) or float(got.fill_value) != fill:
        raise AssertionError(f"{name}: dtype {coo.dtype} fill {got.fill_value}, want {np.dtype(dtype)} {fill}")
    got_lin = np.ravel_multi_index(tuple(coo.coords.cpu().numpy().astype(np.int64)), coo.shape)
    if not np.array_equal(got_lin, lin):
        raise AssertionError(f"{name}: {got_lin.size} entries, the oracle {lin.size}, or their positions differ")
    np.testing.assert_allclose(coo.data.cpu().numpy().astype(np.float64), vals, rtol=ELEM_RTOL, err_msg=name)
    return coo.nnz


def check_sparse_1d(name, got, want, dtype, fill=0.0):
    """A 1-D (or kept-axes, raveled) port result against a dense float64
    oracle vector: the entries where the oracle is not ``fill``."""
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    nz = np.flatnonzero(want != fill)
    return check_entries(name, got, nz, want[nz], dtype, fill)


def phase_elemwise_2d(dev, a):
    """The slice at the bench shape through the public entry points, float32:
    unions, broadcasting, a dense row, ufuncs, casts and reductions of COO,
    CSR and CSC arrays, each against a float64 scipy oracle; the float
    reductions twice, the same bits; each timed (device ms, median of 5)
    beside torch.sparse where it has the operation."""
    import scipy.sparse

    import sparse_tpu_torch as st

    rng = np.random.default_rng(7)
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    b = st.COO(np.stack([lin // K, lin % K]), rng.random(NNZ_DRAWS, dtype=np.float32), shape=(M, K), device=dev)
    d = torch.as_tensor(rng.random(K, dtype=np.float32), device=dev)
    r_rows = np.sort(rng.choice(M, size=R_ROWS, replace=False))
    r_vals = rng.random(R_ROWS, dtype=np.float32)
    r = st.COO(np.stack([r_rows, np.zeros(R_ROWS, np.int64)]), r_vals, shape=(M, 1), device=dev)
    a1 = st.COO(a.coords, a.data, shape=(M, K), fill_value=1.0, has_duplicates=False, sorted=True)
    csr, csc, csr_b = a.asformat("csr"), a.asformat("csc"), b.asformat("csr")
    torch.cuda.synchronize()

    def host(x):
        c = x.coords.cpu().numpy()
        return scipy.sparse.csr_matrix((x.data.cpu().numpy().astype(np.float64), (c[0], c[1])), shape=x.shape)

    A, B = host(a), host(b)
    R = scipy.sparse.csr_matrix(
        (np.repeat(r_vals.astype(np.float64), K), (np.repeat(r_rows, K), np.tile(np.arange(K), R_ROWS))), shape=(M, K)
    )
    dn = d.cpu().numpy().astype(np.float64)
    counts_row = np.diff(A.indptr)
    ops = {
        "a + b": (lambda: a + b, lambda: A + B, "2d", np.float32, 0.0),
        "a > b": (lambda: a > b, lambda: (A > B).astype(np.float64), "2d", np.bool_, 0.0),
        "(a + b) * (a > b)": (lambda: (a + b) * (a > b), lambda: (A + B).multiply(A > B), "2d", np.float32, 0.0),
        "a * d[None, :]": (lambda: a * d[None, :], lambda: A.multiply(dn[None, :]), "2d", np.float32, 0.0),
        "a + r": (lambda: a + r, lambda: A + R, "2d", np.float32, 0.0),
        "sin(a)": (lambda: np.sin(a), lambda: scipy.sparse.csr_matrix((np.sin(A.data), A.indices, A.indptr), shape=A.shape), "2d", np.float32, 0.0),
        "a.astype(float64)": (lambda: a.astype(np.float64), lambda: A, "2d", np.float64, 0.0),
        "a.sum()": (lambda: a.sum(), lambda: A.sum(), "0d", np.float32, None),
        "a.sum(axis=0)": (lambda: a.sum(axis=0), lambda: A.sum(axis=0), "1d", np.float32, 0.0),
        "a.sum(axis=1)": (lambda: a.sum(axis=1), lambda: A.sum(axis=1), "1d", np.float32, 0.0),
        "a.max(axis=1)": (lambda: a.max(axis=1), lambda: A.max(axis=1).toarray(), "1d", np.float32, 0.0),
        "a.min(axis=0)": (lambda: a.min(axis=0), lambda: A.min(axis=0).toarray(), "1d", np.float32, 0.0),
        "a.mean(axis=1)": (lambda: a.mean(axis=1), lambda: A.sum(axis=1) / K, "1d", np.float32, 0.0),
        "(a > 0.5).any(axis=0)": (lambda: (a > 0.5).any(axis=0), lambda: ((A > 0.5).sum(axis=0) > 0), "1d", np.bool_, 0.0),
        "a(fill 1).sum(axis=1)": (
            lambda: a1.sum(axis=1),
            lambda: np.where(counts_row > 0, np.asarray(A.sum(axis=1)).ravel() + (K - counts_row), float(K)),
            "1d",
            np.float32,
            float(K),
        ),
        "csr.sum(axis=1)": (lambda: csr.sum(axis=1), lambda: A.sum(axis=1), "1d", np.float32, 0.0),
        "csr.sum(axis=0)": (lambda: csr.sum(axis=0), lambda: A.sum(axis=0), "1d", np.float32, 0.0),
        "csc.max(axis=0)": (lambda: csc.max(axis=0), lambda: A.max(axis=0).toarray(), "1d", np.float32, 0.0),
        "csr + csr_b": (lambda: csr + csr_b, lambda: A + B, "2d", np.float32, 0.0),
    }
    At = torch.sparse_coo_tensor(a.coords.long(), a.data, (M, K)).coalesce()
    Bt = torch.sparse_coo_tensor(b.coords.long(), b.data, (M, K)).coalesce()
    library = {
        "a + b": lambda: (At + Bt).coalesce(),
        "a.sum()": lambda: torch.sparse.sum(At),
        "a.sum(axis=0)": lambda: torch.sparse.sum(At, dim=0),
        "a.sum(axis=1)": lambda: torch.sparse.sum(At, dim=1),
    }
    floats_twice = {"a.sum()", "a.sum(axis=0)", "a.sum(axis=1)", "a.mean(axis=1)", "a(fill 1).sum(axis=1)", "csr.sum(axis=1)", "csr.sum(axis=0)"}
    rows = {}
    for name, (run, oracle, kind, dtype, fill) in ops.items():
        got = run()
        torch.cuda.synchronize()
        want = oracle()
        if kind == "0d":
            if got.shape != () or got.data.device.type != "cuda":
                raise AssertionError(f"{name}: shape {got.shape} on {got.data.device}")
            np.testing.assert_allclose(float(got.fill_value), float(want), rtol=ELEM_RTOL, err_msg=name)
            nnz = 1
        elif kind == "1d":
            nnz = check_sparse_1d(name, got, np.asarray(want, dtype=np.float64), dtype, fill)
        else:
            nnz = check_sparse_2d(name, got, want, dtype, fill)
        if name == "csr + csr_b" and not (isinstance(got, st.GCXS) and got.compressed_axes == (0,)):
            raise AssertionError(f"csr + csr_b gave {type(got).__name__}, not a GCXS compressed along rows")
        if name in floats_twice:
            again = run()
            if not (_bits_equal(again.fill_value, got.fill_value) and (got.ndim == 0 or _bits_equal(again.tocoo().data, got.tocoo().data))):
                raise AssertionError(f"{name}: a second call gave other bits")
        row = {"ms": device_ms(run), "nnz": nnz}
        if name in library:
            row["torch_sparse_ms"] = device_ms(library[name])
        rows[name] = row
        del got
    return rows


def phase_elemwise_3d(t):
    """The MTTKRP tensor (100,000 x 2,000 x 2,000, 9,999,883 entries):
    sums over (1, 2) and over 0 (4M kept positions), a max over axis 2 and a
    dense (1, 2000, 1) scale, against np.bincount / np.maximum.reduceat in
    float64; the float reductions twice, the same bits."""
    coords = t.coords.cpu().numpy().astype(np.int64)
    vals = t.data.cpu().numpy().astype(np.float64)
    w = torch.as_tensor(np.random.default_rng(11).random((1, MT_J, 1), dtype=np.float32), device=t.device)
    wn = w.cpu().numpy().astype(np.float64).reshape(-1)
    ij = coords[0] * MT_J + coords[1]
    starts = np.flatnonzero(np.concatenate([[True], ij[1:] != ij[:-1]]))
    def dense_oracle(want):
        nz = np.flatnonzero(want)
        return nz, want[nz]

    ops = {
        "t.sum(axis=(1, 2))": (lambda: t.sum(axis=(1, 2)), lambda: dense_oracle(np.bincount(coords[0], weights=vals, minlength=MT_I))),
        "t.sum(axis=0)": (
            lambda: t.sum(axis=0),
            lambda: dense_oracle(np.bincount(coords[1] * MT_K + coords[2], weights=vals, minlength=MT_J * MT_K)),
        ),
        # entries sorted by (i, j, k): each (i, j) run's maximum, all positive
        "t.max(axis=2)": (lambda: t.max(axis=2), lambda: (ij[starts], np.maximum.reduceat(vals, starts))),
    }
    rows = {}
    for name, (run, oracle) in ops.items():
        got = run()
        nnz = check_entries(name, got, *oracle(), np.float32)
        again = run()
        if not _bits_equal(again.data, got.data):
            raise AssertionError(f"{name}: a second call gave other bits")
        rows[name] = {"ms": device_ms(run), "nnz": nnz}
        del got, again
    got = t * w
    if got.data.device.type != "cuda" or not torch.equal(got.coords, t.coords):
        raise AssertionError("t * w: not on the card or not on t's coordinates")
    np.testing.assert_allclose(got.data.cpu().numpy().astype(np.float64), vals * wn[coords[1]], rtol=ELEM_RTOL, err_msg="t * w")
    rows["t * w"] = {"ms": device_ms(lambda: t * w), "nnz": got.nnz}
    return rows


def phase_elemwise_dense_by_nature(dev):
    """``var(axis=0)`` and ``std()`` of a 4,096^2 matrix at density 1e-3:
    the keepdims mean broadcasts over every reduced position, so the union
    of ``x - mean`` is dense (16.8M entries), as in sparse_tpu."""
    import sparse_tpu_torch as st

    n, density = DENSE_NATURE
    rng = np.random.default_rng(13)
    lin = np.unique(rng.integers(0, n * n, size=round(n * n * density)))
    vals = rng.random(lin.size, dtype=np.float32)
    x = st.COO(np.stack([lin // n, lin % n]), vals, shape=(n, n), device=dev)
    dense = np.zeros((n, n))
    dense[lin // n, lin % n] = vals
    rows = {}
    got = x.var(axis=0)
    check_sparse_1d("var(axis=0)", got, dense.var(axis=0), np.float32)
    if not _bits_equal(x.var(axis=0).data, got.data):
        raise AssertionError("var(axis=0): a second call gave other bits")
    rows["var(axis=0)"] = {"ms": device_ms(lambda: x.var(axis=0)), "nnz": got.nnz, "union": n * n}
    got = x.std()
    np.testing.assert_allclose(float(got.fill_value), dense.std(), rtol=ELEM_RTOL, err_msg="std()")
    if not _bits_equal(x.std().fill_value, got.fill_value):
        raise AssertionError("std(): a second call gave other bits")
    rows["std()"] = {"ms": device_ms(lambda: x.std()), "nnz": x.nnz}
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
    phase_gcxs_path(dev, a, b, x)
    k1_launches = phase_k1(dev, card)
    # the cluster SpMV is no default (PERF.md): its launches are the K1 path's
    launches = {**launches, "row_ell_spmv_cluster": k1_launches["row_ell_spmv_cluster"]}
    lines = phase_times(a, re, b, x, launches, errs, card)
    del re, b, x
    # elementwise operations and reductions at the bench shape
    t0 = time.perf_counter()
    elem = {"bench_shape": phase_elemwise_2d(dev, a)}
    elem_s = time.perf_counter() - t0
    # SDDMM and dense x sparse on the bench matrix
    sd_lines, _ = phase_sddmm_path(dev, a, card)
    lines += sd_lines
    torch.cuda.empty_cache()
    # sparse x sparse (SpGEMM) on the bench matrix and the example's shape
    log(json.dumps(phase_spgemm_path(dev, a, card)))
    del a
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
    del c, d, lay, ex, want
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    elem["mttkrp_tensor"] = phase_elemwise_3d(t)
    del t
    torch.cuda.empty_cache()
    elem["dense_by_nature"] = phase_elemwise_dense_by_nature(dev)
    elem_s += time.perf_counter() - t0
    log(json.dumps({"elemwise_path": "ok", "seconds": elem_s, "ops": elem, "card": card}))
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
