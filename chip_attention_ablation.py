#!/usr/bin/env python3
"""Where the time of K6's tile route goes, and which of its shapes wins, on
one NVIDIA GPU (H100).

    python3 chip_attention_ablation.py [tiles] [backward] [backward_tiles]

(no argument: ``tiles`` and ``backward``; ``backward_tiles`` runs the
backward's tile route section alone). K6 is the row-ELL attention kernel of
``sparse_tpu_torch/kernels/csrc/attention.cu``;
its tile route takes a block of query rows against the union of their keys
on the tensor cores (3xTF32). At Longformer-base's width (L = 4,096 and the
long head's 65,536, a window of 256 each side, d = dv = 64, float32, seed 0):

- ``shapes``: every shape of ``_cuda.ATTENTION_TILE_CONFIGS`` (rows a block,
  key slices, CTAs a block, keys a stage; "b64x2w16" and "b64c32x2": blocks
  of 64 rows split over a cluster of two CTAs, 128 CTAs, merged in a fixed
  order; "b64c32": one CTA a block) and two the entry points do not take,
  added to a copy of the source (``ABLATION_SHAPES``: "b32", blocks of 32
  rows, 128 CTAs at L = 4,096; "b64", one CTA a block with 64-key stages),
  each on its own layout, timed alone and with the row kernel's filtered
  launch after it (the entry point's pair), twice bit for bit, against
  ``ell_attention_plain``; the row kernel alone beside them;
- ``window_sweep``: the entry points' shapes at L = 4,096 against the window
  (0 to 512 each side): the fixed cost a block and the cost a stage;
- ``phases``: each shape built once more with ``clock64`` marks: the
  cycles the first warp of each CTA spends
  laying out q, waiting for a stage (with the previous stage's P · V and the
  next stage's copies), splitting a stage, in S = qs · Kᵀ, in the softmax, and
  merging and storing, averaged over the CTAs.

``backward``: K6's backward kernel (``ell_attention_backward_kernel``, a
warp a query row) built with other ``ATTENTION_BWD_MIN_BLOCKS`` (CTAs an SM
in its launch bounds, so its registers) and ``ATTENTION_BWD_ROUND`` (slots
a round, their loads in flight) side by side (``BWD_VARIANTS``, one
``nvcc`` each, started together), each timed at both lengths with its
registers, the variants of 4 slots a round bit for bit against the
default, those of 8 against ``ell_attention_backward_rows_plain``; then
K5's two sums (``dk``, ``dv``) over the slot pattern and the whole backward
(the tile route, the row kernel and K5) on the port's defaults, with the
union layout's flagged blocks. Then the backward's tile route
(``ell_attention_backward_tiles_kernel``), from two more builds: every
shape of ``_cuda.ATTENTION_BWD_TILE_CONFIGS`` and ``BWD_ABLATION_SHAPES``
(keys a stage, key slices, one CTA or a cluster of two), and the
recomputed ``(m, l)`` pass alone (``-DATTENTION_BWD_PASS1_ONLY=1``, which
writes nothing but the route), each at both lengths, the shapes against
``ell_attention_backward_blocks_plain`` and twice bit for bit.

The copies are built into ``build/attention_ablation/``. Each time is the
best of two passes of a CUDA graph of 20 launches, L2 warm.
Prints one JSON line per measurement, then the card's ``name, power.limit``.
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
from types import SimpleNamespace

import torch

from sparse_tpu_torch import nn as tnn
from sparse_tpu_torch.experiments.common import time_graph
from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.kernels import attention as katt
from sparse_tpu_torch.kernels import dot as kdot

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "attention_ablation"
D, WINDOW, SCALE = 64, 256, 0.125
LENGTHS = (4096, 65536)
SWEEP_WINDOWS = (0, 16, 64, 128, 256, 512)
# shapes the entry points do not take: name -> (rows, key slices, CTAs, keys a stage)
ABLATION_SHAPES = {"b32": (32, 4, 1, 64), "b64": (64, 2, 1, 64)}
LAST_CASE = "    case 2: return ST_TILES(64, 4, 2, 64);\n"
PHASES = ("q_layout", "wait", "split", "scores", "softmax", "merge_store")
SOURCE = _cuda.SOURCES["attention"]
# K6's backward: name -> (ATTENTION_BWD_MIN_BLOCKS, ATTENTION_BWD_ROUND); "min1_r4" is the source's default
BWD_VARIANTS = {
    "min1_r4": (1, 4),
    "min2_r4": (2, 4),
    "min3_r4": (3, 4),
    "min4_r4": (4, 4),
    "min1_r8": (1, 8),
    "min2_r8": (2, 8),
    "min3_r8": (3, 8),
}
BWD_ENTRY = "st_ell_attention_backward_f32_i32"
BWD_TOL = 1e-5  # of max|want|: float32 sums in another order than the plain version's
# the backward tile route's shapes the entry points do not take: name -> (rows, key slices, CTAs, keys a stage)
BWD_ABLATION_SHAPES = {"b64c32": (64, 2, 1, 32), "b64c16": (64, 2, 1, 16), "b64c32x2w4": (64, 1, 2, 32)}
BWD_LAST_CASE = "    case 3: return ST_BWD_TILES(64, 4, 2, 32);\n"
BWD_TILES_ENTRY = "st_ell_attention_backward_tiles_f32"
# the tile route's builds: name -> nvcc macros
BWD_TILE_BUILDS = {"shapes": [], "pass1": ["-DATTENTION_BWD_PASS1_ONLY=1"]}
# clock64 marks: (source line, the phase that ends there)
MARKS = (
    ("  if (mine > 0) issue(0);  // its rows come while q is laid out\n", None),
    ("  float o[kNV][4];\n", 0),
    ("    __syncthreads();  // stage i landed; the fragments are free\n", 1),
    ("    // S = qs · Kᵀ over this warp's keys\n", 2),
    ("    // the rows' maxima over the positions they name\n", 3),
    ("    // P, and O += P · V: A's k index t is key 2t, t + 4 key 2t + 1\n", 4),
)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def best(fn):
    return min(time_graph(fn, reps=20) for _ in range(2))


def problem(L, window, dev, gen):
    q, k, v = (torch.randn((L, D), generator=gen, device=dev) for _ in range(3))
    rows, cols = tnn.local_attention_pattern(L, window)
    e_cols, valid = (torch.as_tensor(x, device=dev) for x in tnn.build_attention_ell(rows, cols, L))
    return q, k, v, e_cols, valid


def pair(q, k, v, e_cols, valid, blocks, config, out, route):
    """The entry point's two launches on shape ``config``."""

    def run():
        _cuda.ell_attention_tiles(q, k, v, blocks, SCALE, out, route, config)
        return _cuda.ell_attention(q, k, v, e_cols, valid, SCALE, out, block_route=route, block_rows=blocks.block)

    return run


def ablation_source():
    """attention.cu with ABLATION_SHAPES as more cases of its shape switch,
    registered in ``_cuda.ATTENTION_TILE_CONFIGS`` for this process."""
    src = _cuda.SOURCES["attention"].read_text()
    if LAST_CASE not in src:
        raise RuntimeError("chip_attention_ablation: the shape switch of attention.cu has changed")
    cases = ""
    for name, shape in ABLATION_SHAPES.items():
        cid = len(_cuda.ATTENTION_TILE_CONFIGS)
        _cuda.ATTENTION_TILE_CONFIGS[name] = (cid, *shape)
        cases += f"    case {cid}: return ST_TILES({', '.join(map(str, shape))});\n"
    return src.replace(LAST_CASE, LAST_CASE + cases)


def build(name, text):
    """Build and load ``text`` as the attention library."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / name
    path.write_text(text)
    _cuda.SOURCES["attention"] = path
    _cuda._libs.pop("attention", None)
    return _cuda.load("attention")


def phase_source(src):
    """``src`` with clock64 marks: the first thread of each CTA adds each
    phase's cycles and stores them after the three route counters."""
    for line, phase in MARKS:
        if line not in src:
            raise RuntimeError(f"chip_attention_ablation: the source has no line {line.strip()!r} to mark")
        mark = "  long long T0 = clock64(), T1, ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n" if phase is None else (
            f"  T1 = clock64(); ph[{phase}] += T1 - T0; T0 = T1;\n"
        )
        src = src.replace(line, mark + line if phase is None else line + mark if phase in (1,) else mark + line, 1)
    end = src.index("template <int BQ, int KS, int CL, int DVT, int CH>\nint launch_tiles(")
    body_end = src.rindex("}\n", 0, end)
    store = (
        "  if (tid == 0) {\n    T1 = clock64(); ph[5] += T1 - T0;\n"
        "    for (int z = 0; z < 6; ++z) route_blocks[3 + (b * CL + rank) * 8 + z] = ph[z];\n"
        "    route_blocks[3 + (b * CL + rank) * 8 + 7] = mine;\n  }\n"
    )
    return src[:body_end] + store + src[body_end:]


def build_backward_variant(name, min_blocks, slots):
    """attention.cu built with the backward's macros set: its entry point
    (ctypes, the port's argument types) and the registers ptxas gave the
    float32, int32-index, 16-byte-load instance."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"backward_{name}.so"
    macros = [f"-DATTENTION_BWD_MIN_BLOCKS={min_blocks}", f"-DATTENTION_BWD_ROUND={slots}"]
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-Xptxas", "-v", *macros, "-o", str(so), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    regs, seen = None, False
    for line in (res.stderr + res.stdout).splitlines():
        if "Compiling entry function" in line:
            seen = "ell_attention_backward_kernelIfiLb1" in line
        elif seen and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            seen = False
    fn = getattr(ctypes.CDLL(str(so)), BWD_ENTRY)
    fn.argtypes = _cuda._SIGNATURES["attention"][BWD_ENTRY]
    fn.restype = ctypes.c_int
    return fn, regs


def backward_section(dev, gen):
    with ThreadPoolExecutor(len(BWD_VARIANTS)) as pool:
        futures = {name: pool.submit(build_backward_variant, name, *shape) for name, shape in BWD_VARIANTS.items()}
        variants = {name: f.result() for name, f in futures.items()}
    for L in LENGTHS:
        q, k, v, e_cols, valid = problem(L, WINDOW, dev, gen)
        g = torch.randn((L, D), generator=gen, device=dev)
        cap = e_cols.shape[1]
        grid = _cuda.ell_attention_grid(L, dev)

        def launcher(fn, outs):
            def run():  # on the current stream at each call: a graph's capture stream while it is captured
                err = fn(
                    q.data_ptr(), D, k.data_ptr(), D, v.data_ptr(), D, g.data_ptr(), D, e_cols.data_ptr(), valid.data_ptr(),
                    L, L, cap, D, D, SCALE, 1, grid, None, 0, *(t.data_ptr() for t in outs),
                    torch.cuda.current_stream().cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(f"the backward variant's launch failed: CUDA error {err}")
                return outs

            return run

        want = katt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, SCALE, g) if L == 4096 else None
        base = None
        line = {"backward": L, "cap": cap, "grid": grid, "gathered_bytes": 3 * L * cap * D * 4}
        for name, (fn, regs) in variants.items():
            outs = [torch.empty(s_, device=dev) for s_ in ((L, D), (L, cap), (L, cap))]
            run = launcher(fn, outs)
            got = [t.clone() for t in run()]
            entry = {"registers": regs, "ms": best(run)}
            entry["gathered_tb_per_s"] = line["gathered_bytes"] / (entry["ms"] * 1e-3) / 1e12
            if name == "min1_r4":
                base = got
            if BWD_VARIANTS[name][1] == 4:
                entry["bits_as_default"] = all(torch.equal(a, b) for a, b in zip(got, base))
            if want is not None:
                entry["max_err_over_max"] = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
                if entry["max_err_over_max"] > BWD_TOL:
                    raise AssertionError(f"backward variant {name}: {entry['max_err_over_max']} from the plain version")
            if entry.get("bits_as_default") is False:
                raise AssertionError(f"backward variant {name}: other bits than the default")
            line[name] = entry
        port = [torch.empty(s_, device=dev) for s_ in ((L, D), (L, cap), (L, cap))]
        line["port_kernel_ms"] = best(lambda: _cuda.ell_attention_backward(q, k, v, g, e_cols, valid, SCALE, *port))
        # K5's two sums over the slot pattern, and the whole backward, on the port's defaults
        pattern = katt.attention_slot_pattern(e_cols, valid, L)
        ds, p = base[1], base[2]
        qs = q * SCALE
        line["k5_dk_ms"] = best(lambda: kdot._row_sum_forward(pattern, 1, ds.view(-1), qs))
        line["k5_dv_ms"] = best(lambda: kdot._row_sum_forward(pattern, 1, p.view(-1), g))
        out = katt.ell_attention(q, k, v, e_cols, valid, scale=SCALE)
        line["kernel_and_k5_ms"] = best(lambda: katt._ell_attention_backward(q, k, v, e_cols, valid, SCALE, g, out))
        line["k5_blocks_flagged"] = int(pattern.union(1, 4).flag.sum())
        line["k5_blocks"] = int(pattern.union(1, 4).flag.numel())
        print(json.dumps(line), flush=True)


def build_tiles_variant(name, text, macros):
    """``text`` (attention.cu with the ablation shapes) built with ``macros``:
    its backward tile entry point (ctypes, the port's argument types)."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / "attention_bwd_shapes.cu", OUT / f"backward_tiles_{name}.so"
    src.write_text(text)
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, *macros, "-o", str(so), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), BWD_TILES_ENTRY)
    fn.argtypes = _cuda._SIGNATURES["attention"][BWD_TILES_ENTRY]
    fn.restype = ctypes.c_int
    return fn


def bwd_ablation_source():
    """attention.cu with BWD_ABLATION_SHAPES as more cases of the backward's
    shape switch, registered in ``_cuda.ATTENTION_BWD_TILE_CONFIGS`` for this
    process."""
    src = _cuda.SOURCES["attention"].read_text()
    if BWD_LAST_CASE not in src:
        raise RuntimeError("chip_attention_ablation: the backward's shape switch of attention.cu has changed")
    cases = ""
    for name, shape in BWD_ABLATION_SHAPES.items():
        cid = len(_cuda.ATTENTION_BWD_TILE_CONFIGS)
        _cuda.ATTENTION_BWD_TILE_CONFIGS[name] = (cid, *shape)
        cases += f"    case {cid}: return ST_BWD_TILES({', '.join(map(str, shape))});\n"
    return src.replace(BWD_LAST_CASE, BWD_LAST_CASE + cases)


def backward_tiles_section(dev, gen):
    """The backward tile route's shapes and its pass 1 alone, each build's
    entry point put in the port's place
    of the attention library while it runs (the wrapper's checks and
    arguments as the port's)."""
    text = bwd_ablation_source()
    with ThreadPoolExecutor(len(BWD_TILE_BUILDS)) as pool:
        futures = {name: pool.submit(build_tiles_variant, name, text, macros) for name, macros in BWD_TILE_BUILDS.items()}
        fns = {name: f.result() for name, f in futures.items()}
    port = _cuda.load("attention")
    for L in LENGTHS:
        q, k, v, e_cols, valid = problem(L, WINDOW, dev, gen)
        g = torch.randn((L, D), generator=gen, device=dev)
        out = katt.ell_attention(q, k, v, e_cols, valid, scale=SCALE)
        blocks = katt.build_attention_blocks(e_cols, valid, L, _cuda.ATTENTION_BLOCK_ROWS)
        strips = katt.build_strip_order(blocks)
        want = katt.ell_attention_backward_blocks_plain(q, k, v, g, out, blocks, SCALE)
        cap = e_cols.shape[1]
        route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=dev)
        outs = [torch.empty(s_, device=dev) for s_ in ((L, D), (L, cap), (L, cap))]
        default = _cuda.attention_backward_tile_config(L, D, D, torch.float32, dev)
        line = {"backward_tiles": L, "cap": cap, "default": default, "mean_union": float(blocks.n_union.double().mean())}
        row = [torch.empty_like(t) for t in outs]
        line["row_kernel_ms"] = best(lambda: _cuda.ell_attention_backward(q, k, v, g, e_cols, valid, SCALE, *row))
        runs = [("shapes", c) for c in _cuda.ATTENTION_BWD_TILE_CONFIGS]
        runs += [(build, default) for build in BWD_TILE_BUILDS if build != "shapes"]
        for build, config in runs:
            if not _cuda.attention_backward_tiles_fit(D, D, torch.float32, config):
                continue
            _cuda._libs["attention"] = SimpleNamespace(**{BWD_TILES_ENTRY: fns[build]})
            try:

                def run(config=config):
                    return _cuda.ell_attention_backward_tiles(q, k, v, g, out, blocks, strips, SCALE, *outs, route, config)

                for t in outs:
                    t.fill_(float("nan"))
                got = [t.clone() for t in run()]
                _, rows, slices, ctas, chunk = _cuda.ATTENTION_BWD_TILE_CONFIGS[config]
                entry = {"rows": rows, "slices": slices, "ctas": ctas, "chunk": chunk, "ms": best(run)}
                entry["smem_bytes"] = _cuda.attention_backward_tile_smem(config, D, D)
                if not bool((route == 0).all()):
                    raise AssertionError(f"backward tiles {build} {config}: a block left the tile route")
                if build != "pass1":  # pass 1 alone writes nothing but the route
                    entry["err_of_max"] = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
                    entry["bits_twice"] = all(torch.equal(a, b) for a, b in zip(got, run()))
                    if entry["err_of_max"] > BWD_TOL or not entry["bits_twice"]:
                        raise AssertionError(f"backward tiles {build} {config}: {entry}")
            finally:
                _cuda._libs["attention"] = port
            line[config if build == "shapes" else f"{build}_{config}"] = entry
        print(json.dumps(line), flush=True)
        del q, k, v, g, out, blocks, strips, want, outs, row
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_attention_ablation: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sections = set(sys.argv[1:]) or {"tiles", "backward"}
    if "backward" in sections:
        backward_section(dev, gen)
    if sections & {"backward", "backward_tiles"}:
        backward_tiles_section(dev, gen)
    if "tiles" not in sections:
        print(card())
        return 0
    src = ablation_source()
    build("attention_shapes.cu", src)
    problems = {L: problem(L, WINDOW, dev, gen) for L in LENGTHS}
    plain = katt.ell_attention_plain(*problems[4096], SCALE)

    # every shape, each on its own layout
    for L, (q, k, v, e_cols, valid) in problems.items():
        out = torch.empty((L, D), device=dev)
        line = {"shapes": L, "row_kernel_ms": best(lambda: _cuda.ell_attention(q, k, v, e_cols, valid, SCALE, out))}
        for config, (_, rows, slices, ctas, chunk) in _cuda.ATTENTION_TILE_CONFIGS.items():
            blocks = katt.build_attention_blocks(e_cols, valid, L, rows)
            route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=dev)
            run = pair(q, k, v, e_cols, valid, blocks, config, out, route)
            got = run().clone()
            entry = {
                "rows": rows,
                "slices": slices,
                "ctas": ctas,
                "chunk": chunk,
                "ctas_launched": blocks.union.shape[0] * ctas,
                "smem_bytes": _cuda.attention_tile_smem(config, D, D),
                "tiles_ms": best(lambda: _cuda.ell_attention_tiles(q, k, v, blocks, SCALE, out, route, config)),
                "pair_ms": best(run),
                "bits_twice": bool(torch.equal(got, run())),
            }
            if L == 4096:
                entry["max_abs_err_vs_plain"] = float((got - plain).abs().max())
            line[config] = entry
        print(json.dumps(line), flush=True)

    # the entry points' shapes against the window
    L = 4096
    q, k, v = problems[L][:3]
    out = torch.empty((L, D), device=dev)
    for window in SWEEP_WINDOWS:
        e_cols, valid = problem(L, window, dev, gen)[3:]
        blocks = katt.build_attention_blocks(e_cols, valid, L, _cuda.ATTENTION_BLOCK_ROWS, ratio=1e9)
        route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=dev)
        line = {"window_sweep": window, "cap": int(e_cols.shape[1]), "mean_union": float(blocks.n_union.double().mean())}
        for config in {*_cuda.ATTENTION_TILES_FEW, *_cuda.ATTENTION_TILES_MANY}:
            line[config] = best(lambda: _cuda.ell_attention_tiles(q, k, v, blocks, SCALE, out, route, config))
        print(json.dumps(line), flush=True)

    # the phases, from a build with clock64 marks
    lib = build("attention_phases.cu", phase_source(src))
    for L, (q, k, v, e_cols, valid) in problems.items():
        out = torch.empty((L, D), device=dev)
        for config, (cid, rows, _, ctas, _) in _cuda.ATTENTION_TILE_CONFIGS.items():
            blocks = katt.build_attention_blocks(e_cols, valid, L, rows)
            n_blocks, u_cap = blocks.union.shape
            route = torch.empty(n_blocks, dtype=torch.int32, device=dev)
            marks = torch.zeros(3 + n_blocks * ctas * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                err = lib.st_ell_attention_tiles_f32(
                    q.data_ptr(), D, k.data_ptr(), D, v.data_ptr(), D, blocks.union.data_ptr(), blocks.n_union.data_ptr(),
                    blocks.count.data_ptr(), blocks.flag.data_ptr(), L, n_blocks, u_cap, D, D, SCALE, cid,
                    route.data_ptr(), marks.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(f"the marked build's launch failed: CUDA error {err}")
            torch.cuda.synchronize()
            per_cta = marks[3:].view(n_blocks * ctas, 8).double()
            mean = per_cta.mean(0).tolist()
            print(
                json.dumps(
                    {
                        "phases": L,
                        "config": config,
                        "cycles": dict(zip(PHASES, mean[:6])),
                        "stages_a_cta": mean[7],
                        "cycles_a_cta": sum(mean[:6]),
                        "clock_rate_khz": torch.cuda.get_device_properties(dev).clock_rate,
                    }
                ),
                flush=True,
            )
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
