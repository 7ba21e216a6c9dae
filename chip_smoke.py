#!/usr/bin/env python3
"""Smoke test of sparse_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels of the sparse × dense main path from the sources in
this checkout, holds each against its plain PyTorch version on the card,
drives the main path through the public entry points at the benchmark shape
(65,536², 2^21 entry draws, N = 128, float32) and the spmv_add shape
(99,990 × 100,000 at density 1e-6), checks the outputs against a float64
scipy oracle, shows through the launch counters that the path ran the
kernels, and times each kernel beside its plain version, a cuSPARSE product
(``torch.sparse_csr_tensor``, timed here only; the package never calls it)
and its bound.

Output: one JSON line per kernel with its measurements, then one line
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

M = K = 1 << 16  # benchmark shape (bench.py)
NNZ_DRAWS = 1 << 21
N = 128
SPMV_ADD_SHAPE = (99_990, 100_000)  # spmv_add example
SPMV_ADD_DENSITY = 1e-6

# published H100 SXM peaks at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel vs plain: the two sum each row in another order (the kernel
# sequentially with FMAs, the plain version by torch's reduction)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}
# against the float64 oracle (bench.py's check)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-5)

SOURCE = "sparse_tpu_torch/kernels/csrc/row_ell.cu"
REPLACES = {
    "row_ell_spmv": "sparse_tpu/kernels/row_ell.py:231",  # _onehot_products_call (Pallas)
    "row_ell_spmm": "sparse_tpu/kernels/row_ell.py:198",  # _spmm (XLA)
}


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
    """K1 and K2 against their plain versions on the card, f32 and f64."""
    from sparse_tpu_torch.kernels import row_ell

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
                e = check_close(
                    f"spmm {case} {dt} N={n}", row_ell.row_ell_spmm(re, b), row_ell._spmm_plain(re, b), TOL[dt]
                )
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

    for name, n in launches.items():
        if n == 0:
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


def time_graph(fn, reps=50):
    """Device ms per call of ``fn`` (a bare kernel launch), from CUDA events
    around the replay of a graph holding ``reps`` calls: no host overhead."""
    for _ in range(3):
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
    flushed the 50 MB L2 (events around the call alone)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
            "source": SOURCE,
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
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    # everything allocated so far plus what the timed calls allocate
                    "peak_memory_bytes_kernel": peak_kernel,
                    "peak_memory_bytes_plain": peak_plain,
                    "shape": {"m": M, "k": K, "n": N if name == "row_ell_spmm" else 1, "nnz": nnz, "dtype": "float32"},
                    "card": card,
                }
            )
        )
    return lines


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

    _cuda.load()
    info = _cuda.BUILD_INFO
    if "seconds" in info:
        log(f"build: nvcc {info['seconds']:.2f} s -> {info['path']}")
        log(info["ptxas"].strip())
    else:
        log(f"build: library already built at {info['path']}")

    errs = phase_kernels_vs_plain(dev)
    log(json.dumps({"kernel_vs_plain": "ok", "bench_max_abs_err_f32": errs}))
    a, re, b, x, launches = phase_main_path(dev)
    lines = phase_times(a, re, b, x, launches, errs, card)

    log(json.dumps({"kernels": lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
