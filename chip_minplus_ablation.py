#!/usr/bin/env python3
"""K7, the min-plus relaxation, part by part, at the shapes ``chip_smoke.py``
runs it at, on one NVIDIA GPU (H100).

    python3 chip_minplus_ablation.py [parts] [slices] [loop] [all]

The shapes (``chip_smoke.py``'s ``csgraph_path``): the bench graph
(131,072 nodes, 1,048,576 uniform random edge draws) at 8 and 128 sources,
in float64 and float32, and all sources of a 16,384-node graph of the same
kind, in float64 and float32; each round from the start table of sources 0 .. k - 1.

- ``parts``: the first kernel (K7's first design: a thread a destination
  and source column, its slots one after another, all of them; its source
  is kept here, built beside the others) against each part of the
  redesign alone and together: the new grid with 8-byte lanes, one slot in
  flight and one slot loaded at a time (the base), the padding skipped
  (the rows' filled-slot counts), 16-byte lanes with the port's slots in
  flight, the sliced route where the rule slices, all of them (the port's
  round), then other constants: one slot in flight at every group width,
  two (capped as the port's), four or eight at every group width, 4-slot
  batches of sources, 8-byte lanes. The variants are
  ``csrc/minplus.cu`` built with other ``MINPLUS_*`` macros into
  ``build/minplus_ablation/``, one ``nvcc`` each, started together.
- ``slices``: the sliced route at slices of 32 to 256 columns at all
  sources (float64 and float32), 16 to 64 at 128 sources (32 and 64 in
  float32), beside the gather route, with the filled-slot counts, for the
  builds of ``SLICE_VARIANTS``.
- ``loop``: the flag's reset: a solve's rounds (``dijkstra``'s loop at 8
  sources, and at all sources) with the first protocol (a zeroed flag, then
  the kernel, a launch each, and a read back) on the first kernel and on
  the port's, against a stamp of the solve's own, zeroed once (one launch
  and one read back a round); host ms a round, median of 5 solves, and the
  device ms of a fill and a launch from a CUDA graph against a launch alone.

Every variant's table, the first kernel's too, equals the port's round bit
for bit (the port's round is held bit for bit against the plain version by
``chip_smoke.py``). Each kernel time is a CUDA graph of 50 launches,
L2 warm. One JSON line each, then the card's ``name, power.limit``.
Imports nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BUILD = Path(__file__).resolve().parent / "build" / "minplus_ablation"

# K7's first kernel (csrc/minplus.cu's first design), entry points renamed
FIRST_KERNEL = r"""
#include <cuda_runtime.h>
#include <math.h>
namespace {
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T slots_min(const T* __restrict__ dist, const long long* __restrict__ src,
                                       const T* __restrict__ w, long long width, long long k, long long s) {
  T best = (T)INFINITY;
  for (long long l = 0; l < width; ++l) best = nan_min(best, dist[src[l] * k + s] + w[l]);
  return best;
}
template <typename T>
__global__ void __launch_bounds__(256) minplus_first_kernel(const T* __restrict__ dist, T* __restrict__ out,
    const long long* __restrict__ e_src, const T* __restrict__ e_w, long long n, long long width, long long k,
    const long long* __restrict__ t_src, const T* __restrict__ t_w, long long d, long long t_width,
    unsigned char* __restrict__ changed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * k) return;
  const long long v = i / k;
  const long long s = i - v * k;
  T best = slots_min(dist, e_src + v * width, e_w + v * width, width, k, s);
  if (v >= n - d) {
    const long long r = v - (n - d);
    best = nan_min(best, slots_min(dist, t_src + r * t_width, t_w + r * t_width, t_width, k, s));
  }
  const T old = dist[i];
  const T next = nan_min(old, best);
  out[i] = next;
  if (next < old) *changed = 1;
}
template <typename T>
int launch(const T* dist, T* out, const long long* e_src, const T* e_w, long long n, long long width, long long k,
           const long long* t_src, const T* t_w, long long d, long long t_width, unsigned char* changed,
           cudaStream_t stream) {
  const long long total = n * k;
  if (total == 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  minplus_first_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(dist, out, e_src, e_w, n, width, k, t_src, t_w, d,
                                                                 t_width, changed);
  return (int)cudaGetLastError();
}
}  // namespace
#define FIRST(SUFFIX, T)                                                                                        \
  extern "C" int st_minplus_first_##SUFFIX(const T* dist, T* out, const long long* e_src, const T* e_w,        \
      long long n, long long width, long long k, const long long* t_src, const T* t_w, long long d,            \
      long long t_width, unsigned char* changed, void* stream) {                                               \
    return launch<T>(dist, out, e_src, e_w, n, width, k, t_src, t_w, d, t_width, changed, (cudaStream_t)stream); \
  }
FIRST(f32, float)
FIRST(f64, double)
"""

# other MINPLUS_* macros of csrc/minplus.cu; "port" is the file as it stands
VARIANTS = {
    "port": {},
    "lanes8_loads1": {"MINPLUS_LANE_BYTES": 8, "MINPLUS_LOADS": 1, "MINPLUS_SLOT_BATCH": 1},  # the base
    "loads4_batch4": {"MINPLUS_WARP_SLOTS": 128, "MINPLUS_SLOT_BATCH": 4},  # 4 in flight at every L, 4-slot batches
    "loads4_uncapped": {"MINPLUS_WARP_SLOTS": 128},
    "batch4": {"MINPLUS_SLOT_BATCH": 4},
    "loads1": {"MINPLUS_LOADS": 1},
    "loads2": {"MINPLUS_LOADS": 2},
    "loads8": {"MINPLUS_LOADS": 8, "MINPLUS_WARP_SLOTS": 256},
    "lanes8": {"MINPLUS_LANE_BYTES": 8},
}
# the sliced route's widths, and the builds swept over them
SLICE_VARIANTS = ("port", "loads4_uncapped")
SLICES = {"all_16384": (32, 64, 128, 256), "all_16384_f32": (32, 64, 128, 256), "bench_128": (16, 32, 64),
          "bench_128_f32": (32, 64)}


def card_name_power():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _nvcc(name, src, defines):
    from sparse_tpu_torch.kernels import _cuda

    so = BUILD / f"{name}.so"
    flags = [f"-D{k}={v}" for k, v in defines.items()]
    res = subprocess.run([_cuda._nvcc(), *_cuda._NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    # registers a thread of each instantiation: "<dtype> L=<lanes a group>"
    regs, kernel = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '\S*?kernelI([df])(?:Li(\d+))?E", line)
        if m:
            kernel = ("f64" if m.group(1) == "d" else "f32") + (f" L={m.group(2)}" if m.group(2) else "")
        elif "Used " in line and kernel is not None:
            regs[kernel] = int(line.split("Used ")[1].split()[0])
            kernel = None
    return ctypes.CDLL(str(so)), regs


def build_all():
    """{name: (library, registers a thread)}: every variant of minplus.cu and the first kernel, built together."""
    from sparse_tpu_torch.kernels import _cuda

    BUILD.mkdir(parents=True, exist_ok=True)
    first = BUILD / "first.cu"
    first.write_text(FIRST_KERNEL)
    jobs = {name: (_cuda.SOURCES["minplus"], defines) for name, defines in VARIANTS.items()}
    jobs["first"] = (first, {})
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda job: _nvcc(job[0], *job[1]), jobs.items())))
    _p, _i64 = ctypes.c_void_p, ctypes.c_int64
    for name, (lib, _) in built.items():
        sigs = ({f"st_minplus_first_{dt}": [_p, _p, _p, _p, *[_i64] * 3, _p, _p, _i64, _i64, _p, _p] for dt in ("f32", "f64")}
                if name == "first" else _cuda._SIGNATURES["minplus"])
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return built


class Case:
    """One shape: the layout on the card, the start table, the bytes its round needs."""

    def __init__(self, name, rows, cols, w, n, k, dtype, dev):
        from sparse_tpu_torch import csgraph
        from sparse_tpu_torch.kernels import minplus

        self.name, self.n, self.k, self.dtype = name, n, k, dtype
        self.ell = minplus.build_dest_ell(rows, cols, w, n, dtype=dtype, device=dev)
        src = torch.arange(k, device=dev)
        start = src if self.ell.inv is None else self.ell.inv[src]
        self.dist = csgraph._start_table(k, n, start, dev).to(dtype)
        self.out = torch.empty_like(self.dist)
        self.stamp = torch.zeros(1, dtype=torch.int32, device=dev)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.edges = int(rows.size)
        item = self.dist.element_size()
        self.bytes = self.edges * (8 + item) + 2 * n * k * item  # each edge's source and weight, the table read and written
        self.bound_ms = self.bytes / HBM_BYTES_PER_S * 1e3
        self.slots = self.ell.e_src.numel() + (0 if self.ell.tail is None else self.ell.tail[0].numel())

    def new(self, lib, counts, cols):
        """A launch of ``lib`` (a build of minplus.cu) into ``out``."""
        from sparse_tpu_torch.kernels import _cuda

        e = self.ell
        deg = {"deg": e.deg, "t_deg": e.t_deg} if counts else {}

        def launch():
            _cuda._libs["minplus"] = lib
            return _cuda.minplus_relax(self.dist, e.e_src, e.e_w, e.tail, self.out, self.stamp, 1, slice_cols=cols, **deg)

        return launch

    def first(self, lib, dist=None, out=None, flag=None):
        """A launch of the first kernel into ``out``."""
        e = self.ell
        fn = getattr(lib, f"st_minplus_first_{'f64' if self.dtype == torch.float64 else 'f32'}")
        t_src, t_w = (None, None) if e.tail is None else e.tail
        d, t_width = (0, 0) if e.tail is None else t_src.shape

        def launch(dist=dist, out=out, flag=flag):
            dist = self.dist if dist is None else dist
            out = self.out if out is None else out
            flag = self.flag if flag is None else flag
            err = fn(dist.data_ptr(), out.data_ptr(), e.e_src.data_ptr(), e.e_w.data_ptr(), self.n, e.e_src.shape[1],
                     self.k, None if t_src is None else t_src.data_ptr(), None if t_w is None else t_w.data_ptr(), d,
                     t_width, flag.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the first kernel: CUDA error {err}")

        return launch


def cases(dev, names=None):
    import chip_smoke as cs

    _, _, (r, c, w) = cs.cg_graph(cs.CG_NODES, cs.CG_EDGES, cs.CG_SEED, dev)
    _, _, (r2, c2, w2) = cs.cg_graph(cs.CG_ALL_NODES, cs.CG_ALL_EDGES, cs.CG_SEED + 1, dev)
    specs = {
        "bench_8": (r, c, w, cs.CG_NODES, cs.CG_SOURCES, torch.float64),
        "bench_8_f32": (r, c, w, cs.CG_NODES, cs.CG_SOURCES, torch.float32),
        "bench_128": (r, c, w, cs.CG_NODES, cs.CG_WIDE_SOURCES, torch.float64),
        "bench_128_f32": (r, c, w, cs.CG_NODES, cs.CG_WIDE_SOURCES, torch.float32),
        "all_16384": (r2, c2, w2, cs.CG_ALL_NODES, cs.CG_ALL_NODES, torch.float64),
        "all_16384_f32": (r2, c2, w2, cs.CG_ALL_NODES, cs.CG_ALL_NODES, torch.float32),
    }
    for name, spec in specs.items():
        if names is None or name in names:
            yield Case(name, *spec, dev)


def timed(case, fn, want):
    """ms of ``fn`` from a CUDA graph, after checking its table equals ``want``'s bits."""
    from sparse_tpu_torch.experiments.common import time_graph

    case.out.fill_(torch.nan)
    fn()
    torch.cuda.synchronize()
    if not torch.equal(case.out, want):
        raise AssertionError(f"{case.name}: a variant's table differs from the port's round")
    return time_graph(fn)


def parts(dev, card, built):
    from sparse_tpu_torch.kernels import _cuda

    for case in cases(dev):
        route, rule_cols = _cuda.minplus_route(case.n, case.k, case.dist.element_size())
        port = built["port"][0]
        case.new(port, True, rule_cols)()
        want = case.out.clone()
        first_ms = timed(case, case.first(built["first"][0]), want)
        res = {"the first kernel": first_ms}
        base = built["lanes8_loads1"][0]
        res["base: 8-byte lanes, 1 slot in flight, every slot, gather"] = timed(case, case.new(base, False, 0), want)
        res["+ padding skipped"] = timed(case, case.new(base, True, 0), want)
        res["+ 16-byte lanes, slots in flight (the port's constants)"] = timed(case, case.new(port, False, 0), want)
        if rule_cols:
            res[f"+ sliced ({rule_cols} columns)"] = timed(case, case.new(base, False, rule_cols), want)
            res["together on the gather route"] = timed(case, case.new(port, True, 0), want)
        res[f"together (the port: {route})"] = timed(case, case.new(port, True, rule_cols), want)
        for name in VARIANTS:
            if name != "port":
                res[f"together, {name}"] = timed(case, case.new(built[name][0], True, rule_cols), want)
        _cuda._libs["minplus"] = port
        print(json.dumps({"parts": case.name, "n": case.n, "k": case.k, "dtype": str(case.dtype), "edges": case.edges,
                          "slots": case.slots, "route": route, "slice_cols": rule_cols, "ms": res,
                          "bound_ms": case.bound_ms, "bound_bytes": case.bytes,
                          "share_of_bound": {k: case.bound_ms / v for k, v in res.items()},
                          "registers": {k: v[1] for k, v in built.items()}, "equal_bits": True, "card": card}),
              flush=True)
        del case


def slices(dev, card, built):
    from sparse_tpu_torch.kernels import _cuda

    port = built["port"][0]
    for case in cases(dev, SLICES):
        case.new(port, True, 0)()
        want = case.out.clone()
        res = {}
        for name in SLICE_VARIANTS:
            lib = built[name][0]
            res[f"{name} gather"] = timed(case, case.new(lib, True, 0), want)
            for cols in SLICES[case.name]:
                res[f"{name} sliced {cols}"] = timed(case, case.new(lib, True, cols), want)
        _cuda._libs["minplus"] = port
        print(json.dumps({"slices": case.name, "n": case.n, "k": case.k, "dtype": str(case.dtype),
                          "rule": _cuda.minplus_route(case.n, case.k, case.dist.element_size()), "ms": res,
                          "bound_ms": case.bound_ms, "equal_bits": True, "card": card}), flush=True)
        del case


def _solve_ms(make_round, case, reps=5):
    """Median host ms of a solve of Jacobi rounds from the start table, each
    round ``round_fn(src, dst, number) -> fell`` (one read back), from
    ``make_round()`` once a solve, and the rounds."""
    bufs = [torch.empty_like(case.dist) for _ in range(2)]

    def solve():
        round_fn = make_round()
        d, rounds, changed = case.dist, 0, True
        while changed and rounds < case.n + 1:
            changed = round_fn(d, bufs[rounds % 2], rounds + 1)
            d = bufs[rounds % 2]
            rounds += 1
        round_fn(d, bufs[rounds % 2], rounds + 1)
        return rounds

    solve()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds = solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), rounds


def loop(dev, card, built):
    from sparse_tpu_torch.experiments.common import time_graph
    from sparse_tpu_torch.kernels import _cuda, minplus

    port, first_lib = built["port"][0], built["first"][0]
    _cuda._libs["minplus"] = port
    for case in cases(dev, ("bench_8", "all_16384")):
        e = case.ell
        _, cols = _cuda.minplus_route(case.n, case.k, case.dist.element_size())
        first = case.first(first_lib)
        kw = {"deg": e.deg, "t_deg": e.t_deg, "slice_cols": cols}

        def first_round(src, dst, _number):
            flag = torch.zeros((), dtype=torch.bool, device=dev)
            first(src, dst, flag)
            return bool(flag)

        def filled_round(src, dst, _number):
            stamp = torch.zeros(1, dtype=torch.int32, device=dev)
            _cuda.minplus_relax(src, e.e_src, e.e_w, e.tail, dst, stamp, 1, **kw)
            return stamp.item() == 1

        def kept_rounds():
            stamp = torch.zeros(1, dtype=torch.int32, device=dev)  # the solve's own, zeroed once

            def kept_round(src, dst, number):
                _cuda.minplus_relax(src, e.e_src, e.e_w, e.tail, dst, stamp, number, **kw)
                return stamp.item() == number

            return kept_round

        res = {}
        for name, fn in (("flag fill + the first kernel", lambda: first_round), ("flag fill + the port's kernel", lambda: filled_round),
                         ("the solve's stamp + the port's kernel", kept_rounds)):
            ms, rounds = _solve_ms(fn, case)
            res[name] = {"solve_ms": ms, "rounds": rounds, "ms_per_round": ms / (rounds + 1)}
        fix_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            minplus.minplus_fixpoint(case.dist, e.e_src, e.e_w, e.tail, maxiter=case.n + 1, deg=e.deg, t_deg=e.t_deg)
            torch.cuda.synchronize()
            fix_ms.append((time.perf_counter() - t0) * 1e3)
        res["minplus_fixpoint"] = {"solve_ms": float(np.median(fix_ms))}
        stamp = torch.zeros(1, dtype=torch.int32, device=dev)
        launch = lambda: _cuda.minplus_relax(case.dist, e.e_src, e.e_w, e.tail, case.out, stamp, 1, **kw)  # noqa: E731
        device = {"launch": time_graph(launch), "fill + launch": time_graph(lambda: (stamp.zero_(), launch()))}
        print(json.dumps({"loop": case.name, "n": case.n, "k": case.k, "host": res, "device_ms": device, "card": card}),
              flush=True)
        del case


def main(argv):
    if not torch.cuda.is_available():
        print("chip_minplus_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_name_power()
    t0 = time.perf_counter()
    built = build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0, "registers": {k: v[1] for k, v in built.items()}}), flush=True)
    chosen = set(argv) or {"all"}
    for name, fn in (("parts", parts), ("slices", slices), ("loop", loop)):
        if name in chosen or "all" in chosen:
            fn(dev, card, built)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
