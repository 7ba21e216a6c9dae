#!/usr/bin/env python3
"""K5, the fixed-order row sum, and its three routes (gather, sliced,
union) at the shapes the port runs it at and across a sweep, on one NVIDIA
GPU (H100).

    python3 chip_row_sum_ablation.py [step0] [slices] [unions] [variants] [orders] [all]

- ``step0``: the gather route (``csrc/mttkrp.cu``'s ``RowSum``) alone from a
  CUDA graph at four places of the port: ``graph_conv``'s forward table
  (ogbn-arxiv's sizes, K = 256) and its backward's column sum, the COO
  attention route's ``attn @ v`` and ``d k`` (Longformer-base's window with
  one global token, L = 4,096, K = 64), and the bench mask's two launches (K
  = 128). Each line: ms, the gathered bytes and their rate, the byte bound,
  ms with no segment split (one warp a segment: the front path's share),
  ``torch.sparse.mm`` (CSR x dense) on the same inputs, and the device time
  by kernel of one wrapper call under ``torch.profiler``.
- ``slices``: random patterns (about 15 entries a segment, as many segments
  as table rows) over tables of 8 to 256 MB at K = 64, 128 and 256 float32:
  the gather route (whole rows) and the sliced route at slices of 16 and 32
  values, its one grid numbered slice-major against one launch a slice (the
  sliced route on each slice's columns of the table, into an output of its
  own).
- ``unions``: banded patterns (L = 4,096 and 16,384 segments and table rows,
  a window of 64 and 256 each side, a random fraction 0-1 of each row's
  entries moved to random columns) at K = 64, 128 and 256: the gather route
  and the union route on layouts of blocks of 32 and 64 segments with
  shared memory of 112 or 224 KB a CTA (every block that fits on it,
  whatever its reuse), with each layout's mean entries a union key.
- ``variants``: patched copies of ``mttkrp.cu`` (other ``ROW_SUM_*``
  constants, built into ``build/row_sum_ablation/``, one ``nvcc`` each,
  started together) at the ``graph_conv`` table and the attention shape.
- ``orders``: the union route's two launches (the union kernel, the gather
  route on the flagged blocks) in either order on one stream, on two and
  with the union kernel on a stream of higher priority, as built and in
  patched copies (the first forms of the flagged gather's row check and of
  the union grid; the flagged gather asking for the most shared memory),
  at the attention shape, at windows of 256 made partly or wholly random
  and at the bench mask with K = 64 (most or every block flagged).

Every variant is held bit for bit against the gather route on the same
inputs. One JSON line each, then the card's ``name, power.limit``. Imports
nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
GCN_NODES, GCN_EDGES, GCN_HIDDEN = 169_343, 1_166_243, 256
AT_L, AT_WINDOW, AT_D = 4096, 256, 64
BENCH, BENCH_DRAWS, BENCH_K = 1 << 16, 1 << 21, 128


def card_name_power():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def gcn_pattern(dev):
    """chip_smoke.py's ogbn-arxiv graph: edges from seed 19, symmetric, self-loops, sorted by row."""
    rng = np.random.default_rng(19)
    n = GCN_NODES
    e = rng.integers(0, n, size=(2, GCN_EDGES))
    lin = np.unique(np.concatenate([e[0] * n + e[1], e[1] * n + e[0], np.arange(n, dtype=np.int64) * (n + 1)]))
    return torch.as_tensor(lin // n, device=dev), torch.as_tensor(lin % n, device=dev), n, n


def attention_pattern(dev):
    from sparse_tpu_torch import nn as tnn

    rows, cols = tnn.local_attention_pattern(AT_L, AT_WINDOW, 1)
    return torch.as_tensor(rows, device=dev).long(), torch.as_tensor(cols, device=dev).long(), AT_L, AT_L


def bench_pattern(dev):
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, BENCH * BENCH, size=BENCH_DRAWS))
    return torch.as_tensor(lin // BENCH, device=dev), torch.as_tensor(lin % BENCH, device=dev), BENCH, BENCH


def cases(dev):
    """name -> (pattern, axis, K): the six launches of Step 0."""
    from sparse_tpu_torch.kernels import dot as kdot

    out = {}
    for label, make, k, axes in (
        ("graph_conv", gcn_pattern, GCN_HIDDEN, (("forward", 0), ("backward_columns", 1))),
        ("attention", attention_pattern, AT_D, (("attn_v", 0), ("d_k", 1))),
        ("bench", bench_pattern, BENCH_K, (("d_lhs", 0), ("d_rhs", 1))),
    ):
        rows, cols, m, n = make(dev)
        pattern = kdot.SddmmPattern(rows, cols, m, n, rows_sorted=True)
        for of, axis in axes:
            out[f"{label}_{of}"] = (pattern, axis, k)
    return out


def profile_kernels(fn):
    """Device ms by kernel name of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if dt and ev.key and not ev.key.startswith(("aten::", "cuda", "Memcpy")):
            out[ev.key[:80]] = dt / 1e3
    return out


def step0(dev, card):
    from sparse_tpu_torch.experiments.common import time_graph
    from sparse_tpu_torch.kernels import _cuda
    from sparse_tpu_torch.kernels import dot as kdot

    gen = torch.Generator(device=dev).manual_seed(21)
    for name, (pattern, axis, k) in cases(dev).items():
        n_out, n_table = pattern.sizes[axis], pattern.sizes[1 - axis]
        ptr, order, pieces, idx = pattern.plan(axis)
        nnz = idx.numel()
        w = torch.rand(nnz, generator=gen, device=dev)
        table = torch.randn((n_table, k), generator=gen, device=dev)
        w_seg = w if order is None else w[order]
        out = torch.empty((n_out, k), device=dev)
        n_front = _cuda.front_bound(nnz, n_out, _cuda.MTTKRP_PIECE)
        partial = torch.empty(n_front * k, device=dev)
        tickets = torch.zeros(n_front * _cuda.row_sum_chunks(k, torch.float32), dtype=torch.int32, device=dev)
        launch = lambda: _cuda.sampled_row_sum(ptr, pieces, idx, w_seg, table, out, partial, tickets)  # noqa: E731
        got = launch().clone()
        # one warp a segment: no piece, no front path
        whole = nnz + 1
        pieces_whole = _cuda.run_pieces(ptr, whole)
        out_whole = torch.empty_like(out)
        unsplit = lambda: _cuda.sampled_row_sum(  # noqa: E731
            ptr, pieces_whole, idx, w_seg, table, out_whole, partial, tickets, piece=whole
        )
        unsplit()
        lens = ptr[1:] - ptr[:-1]
        csr = torch.sparse_csr_tensor(ptr, idx.long(), w_seg, (n_out, n_table))
        lib = torch.sparse.mm(csr, table)
        ms = time_graph(launch)
        ms_unsplit = time_graph(unsplit)
        touched = int(torch.unique(idx).numel())
        nbytes = touched * k * 4 + nnz * 8 + n_out * k * 4
        gathered = nnz * k * 4
        print(json.dumps({
            "step0": name, "axis": axis, "k": k, "n_out": n_out, "n_table": n_table, "nnz": nnz,
            "table_bytes": n_table * k * 4, "max_segment": int(lens.max()),
            "segments_split": int((lens > _cuda.MTTKRP_PIECE).sum()), "pieces": int(pieces[-1]),
            "ms": ms, "ms_no_split": ms_unsplit, "no_split_equal_bits": bool(torch.equal(out_whole, got)),
            "gathered_bytes": gathered, "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
            "bound_bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms,
            "library_ms": time_graph(lambda: torch.sparse.mm(csr, table), reps=10),
            "library_max_abs_diff": float((lib - got).abs().max()),
            "weights_gather_ms": 0.0 if order is None else time_graph(lambda: w[order]),
            "profile_wrapper_ms": profile_kernels(lambda: kdot._row_sum_forward(pattern, axis, w, table)),
            "card": card,
        }), flush=True)
        del out, partial, tickets, out_whole, csr, lib, table


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


class Case:
    """K5's inputs along one axis of a pattern, and a launcher of each route
    on them (``csrc/mttkrp.cu`` through ``kernels._cuda``)."""

    def __init__(self, pattern, axis, table, w):
        from sparse_tpu_torch.kernels import _cuda

        self.pattern, self.axis, self.table = pattern, axis, table
        self.ptr, order, self.pieces, self.idx = pattern.plan(axis)
        self.w = (w if order is None else w[order]).contiguous()
        self.n_out, self.k = pattern.sizes[axis], table.shape[1]
        n_front = _cuda.front_bound(self.idx.numel(), self.n_out, _cuda.MTTKRP_PIECE)
        self.partial = torch.empty(n_front * self.k, device=w.device)
        self.tickets = torch.zeros(n_front * self.k, dtype=torch.int32, device=w.device)
        self.out = torch.empty((self.n_out, self.k), device=w.device)
        self.slice_outs = {}

    def gather(self):
        from sparse_tpu_torch.kernels import _cuda

        return _cuda.sampled_row_sum(self.ptr, self.pieces, self.idx, self.w, self.table, self.out, self.partial,
                                     self.tickets)

    def sliced(self, width, per_slice=False):
        """The sliced route in one grid, or one launch a slice: the route on
        each slice's columns of the table, each into an output of its own
        (a list, read with :func:`joined`)."""
        from sparse_tpu_torch.kernels import _cuda

        if not per_slice:
            return _cuda.sampled_row_sum(self.ptr, self.pieces, self.idx, self.w, self.table, self.out, self.partial,
                                         self.tickets, slice_cols=width)
        outs = self.slice_outs.setdefault(width, [torch.empty((self.n_out, min(width, self.k - c)), device=self.w.device)
                                                  for c in range(0, self.k, width)])
        return [_cuda.sampled_row_sum(self.ptr, self.pieces, self.idx, self.w, self.table[:, c:c + o.shape[1]], o,
                                      self.partial, self.tickets, slice_cols=width)
                for c, o in zip(range(0, self.k, width), outs)]

    def layout(self, block, u_cap, reuse=0.0):
        from sparse_tpu_torch.kernels import dot as kdot

        return kdot.row_sum_union_layout(self.ptr, self.idx, self.table.shape[0], block, u_cap, reuse)

    def union(self, lay, with_gather=True):
        from sparse_tpu_torch.kernels import _cuda
        from sparse_tpu_torch.kernels import dot as kdot

        if with_gather:  # as the entry points run it: the flagged blocks' gather beside it on a second stream
            return kdot.row_sum_union_route(self.ptr, self.idx, lay, self.w, self.table, self.out, self.partial)
        return _cuda.sampled_row_sum_union(self.ptr, lay, self.w, self.table, self.out)


def joined(got):
    return torch.cat(got, 1) if isinstance(got, list) else got


def timed(case, variants):
    """{name: (ms, bits equal to the gather route's)} of ``variants`` (name ->
    launcher), each after a launch into a fresh output held against it."""
    from sparse_tpu_torch.experiments.common import time_graph

    case.out.fill_(float("nan"))
    want = case.gather().clone()
    out = {}
    for name, fn in variants.items():
        case.out.fill_(float("nan"))
        got = joined(fn())
        out[name] = {"ms": time_graph(fn, reps=20), "equal_bits": same_bits(got, want)}
        if not out[name]["equal_bits"]:
            raise AssertionError(f"K5 {name}: other bits than the gather route")
    return out


TABLE_MB = (8, 16, 32, 64, 128, 256)
SWEEP_K = (64, 128, 256)
SLICE_WIDTHS = (16, 32)
PER_SEGMENT = 15


def slices(dev, card):
    """The sliced route against the gather route over table sizes (random patterns)."""
    from sparse_tpu_torch.kernels import dot as kdot

    gen = torch.Generator(device=dev).manual_seed(22)
    for k in SWEEP_K:
        for mb in TABLE_MB:
            n = (mb << 20) // (k * 4)
            nnz = n * PER_SEGMENT
            rows = torch.sort(torch.randint(0, n, (nnz,), generator=gen, device=dev)).values
            cols = torch.randint(0, n, (nnz,), generator=gen, device=dev)
            pattern = kdot.SddmmPattern(rows, cols, n, n, rows_sorted=True)
            case = Case(pattern, 0, torch.randn((n, k), generator=gen, device=dev),
                        torch.randn(nnz, generator=gen, device=dev))
            variants = {"gather": case.gather}
            for width in SLICE_WIDTHS:
                for per_slice in (False, True):
                    variants[f"sliced_{width}_{'launch_a_slice' if per_slice else 'one_grid'}"] = (
                        lambda width=width, per_slice=per_slice: case.sliced(width, per_slice))
            res = timed(case, variants)
            gathered = nnz * k * 4
            print(json.dumps({"slices": True, "k": k, "table_mb": mb, "rows": n, "nnz": nnz,
                              "ms": {v: r["ms"] for v, r in res.items()},
                              "gathered_tb_per_s": {v: gathered / (r["ms"] * 1e-3) / 1e12 for v, r in res.items()},
                              "equal_bits": all(r["equal_bits"] for r in res.values()), "card": card}), flush=True)
            del case, pattern, rows, cols


BANDS = ((4096, 256), (4096, 64), (16_384, 64))
FRACTIONS = (0.0, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
BLOCKS = (32, 64)
SMEM_KB = (112, 224)


def unions(dev, card):
    """The union route (every block that fits, whatever its reuse) against the gather route on banded patterns."""
    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.kernels import dot as kdot

    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    for L, window in BANDS:
        rows_np, cols_np = tnn.local_attention_pattern(L, window)
        for frac in FRACTIONS:
            cols_f = cols_np.copy()
            swap = rng.random(cols_f.size) < frac
            cols_f[swap] = rng.integers(0, L, int(swap.sum()))
            rows = torch.as_tensor(rows_np, device=dev).long()
            cols = torch.as_tensor(cols_f, device=dev).long()
            pattern = kdot.SddmmPattern(rows, cols, L, L, rows_sorted=True)
            w = torch.rand(rows.numel(), generator=gen, device=dev)
            for k in SWEEP_K:
                case = Case(pattern, 0, torch.randn((L, k), generator=gen, device=dev), w)
                variants, shape = {"gather": case.gather}, {}
                for block in BLOCKS:
                    for kb in SMEM_KB:
                        u_cap = (kb << 10) // (32 * 4)
                        lay = case.layout(block, u_cap)
                        name = f"union_b{block}_{kb}kb"
                        variants[name] = lambda lay=lay: case.union(lay)
                        variants[name + "_kernel_alone"] = lambda lay=lay: case.union(lay, with_gather=False)
                        n_union = lay.n_union.double()
                        entries = torch.diff(case.ptr[torch.clamp(torch.arange(lay.flag.numel() + 1, device=dev) * block,
                                                                  max=L)]).double()
                        shape[name] = {"blocks": lay.flag.numel(), "flagged": int(lay.flag.sum()),
                                       "mean_union": float(n_union.mean()),
                                       "mean_reuse": float((entries / n_union.clamp(min=1)).mean()),
                                       "min_reuse": float((entries / n_union.clamp(min=1)).min())}
                res = {}
                from sparse_tpu_torch.experiments.common import time_graph

                case.out.fill_(float("nan"))
                want = case.gather().clone()
                for name, fn in variants.items():
                    ms = time_graph(fn, reps=20)
                    if not name.endswith("_kernel_alone"):
                        case.out.fill_(float("nan"))
                        if not same_bits(fn(), want):
                            raise AssertionError(f"K5 {name}: other bits than the gather route")
                    res[name] = ms
                print(json.dumps({"unions": True, "L": L, "window": window, "random_fraction": frac, "k": k,
                                  "nnz": int(rows.numel()), "ms": res, "layouts": shape, "equal_bits": True,
                                  "card": card}), flush=True)
                del case


def _define(name, value):
    """A patch setting the #define of ``name`` in mttkrp.cu to ``value``."""
    import re

    from sparse_tpu_torch.kernels import _cuda

    line = re.search(rf"#define {name} .*", _cuda.SOURCES["mttkrp"].read_text()).group(0)
    return line, f"#define {name} {value}"


# the gather route's launch, where a patch sets its kernel's preferred split of L1 and shared memory
_GATHER_LAUNCH = "  return launch<RowSum<T, false>, T>(row_ptr, pieces, n_rows, n_front, piece, sum, out, partial, tickets, stream);"
_UNION_LAUNCH_GRID = "  const long long grid = items < sms * cached_per_sm ? items : sms * cached_per_sm;"
_ROW_CHECK = """    const long long begin = row_ptr[row], end = row_ptr[row + 1];
    // a row of the union route (its block's flag read beside the bounds, not
    // before them: 3 % of the flagged gather on short rows), or split: its
    // pieces belong to the front warps
    if (sum.skips(row) | (end - begin > piece)) return;"""
_UNION_LAUNCH_GRID = """  long long grid = items < sms * cached_per_sm ? items : sms * cached_per_sm;
  if (grid < sms) grid = sms;"""
PATCHES = {
    # the first forms: the flag read before the row's bounds; the union grid no larger than its items
    "flag_before_bounds": [(_ROW_CHECK, """    if (sum.skips(row)) return;
    const long long begin = row_ptr[row], end = row_ptr[row + 1];
    if (end - begin > piece) return;""")],
    "union_grid_to_items": [(_UNION_LAUNCH_GRID, "  const long long grid = items < sms * cached_per_sm ? items : sms * cached_per_sm;")],
    # the flagged gather asks for the most shared memory, so the union kernel's CTAs fit beside it
    "gather_max_shared": [(_GATHER_LAUNCH, "  cudaFuncSetAttribute(run_sum_kernel<RowSum<T, false>, T>, "
                                           "cudaFuncAttributePreferredSharedMemoryCarveout, flag != nullptr ? "
                                           "(int)cudaSharedmemCarveoutMaxShared : (int)cudaSharedmemCarveoutDefault);\n"
                                           + _GATHER_LAUNCH)],
}
VARIANTS = {
    "slice_loads_4": lambda: [_define("ROW_SUM_SLICE_LOADS", 4)],
    "slice_loads_4_six_ctas": lambda: [_define("ROW_SUM_SLICE_LOADS", 4), _define("ROW_SUM_SLICE_MIN_BLOCKS", 6)],
    "slice_loads_16_two_ctas": lambda: [_define("ROW_SUM_SLICE_LOADS", 16), _define("ROW_SUM_SLICE_MIN_BLOCKS", 2)],
    "union_256_threads": lambda: [_define("ROW_SUM_UNION_THREADS", 256)],
    "union_loads_8": lambda: [_define("ROW_SUM_UNION_LOADS", 8)],
}


def build_variant(name, patches):
    """``mttkrp.cu`` with ``patches`` ((old, new) text pairs, each found
    once) built into build/row_sum_ablation/ and loaded: (name, library)."""
    import ctypes
    import subprocess as sp
    from pathlib import Path

    from sparse_tpu_torch.kernels import _cuda

    out = Path(__file__).resolve().parent / "build" / "row_sum_ablation"
    out.mkdir(parents=True, exist_ok=True)
    src = _cuda.SOURCES["mttkrp"].read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:60]!r} is not in mttkrp.cu once")
        src = src.replace(old, new)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    cmd = [_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-o", str(so), str(cu)]
    res = sp.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _cuda._SIGNATURES["mttkrp"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return name, lib


def build_variants(patches):
    """{name: library} of every (name, patches) item, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(patches)) as pool:
        return dict(pool.map(lambda item: build_variant(*item), patches.items()))


def variants(dev, card):
    """Each macro variant of mttkrp.cu at the graph_conv table (sliced) and the attention shape (union)."""
    from sparse_tpu_torch.experiments.common import time_graph
    from sparse_tpu_torch.kernels import _cuda

    libs = build_variants({name: make() for name, make in VARIANTS.items()})
    libs["default"] = _cuda.load("mttkrp")
    gen = torch.Generator(device=dev).manual_seed(24)
    cs = cases(dev)
    shapes = {
        "graph_conv_forward": (cs["graph_conv_forward"], "sliced"),
        "attention_attn_v": (cs["attention_attn_v"], "union"),
    }
    for label, ((pattern, axis, k), route) in shapes.items():
        case = Case(pattern, axis, torch.randn((pattern.sizes[1 - axis], k), generator=gen, device=dev),
                    torch.rand(pattern.ends[0].numel(), generator=gen, device=dev))
        lay = case.layout(_cuda.ROW_SUM_UNION_BLOCK,
                          _cuda.row_sum_union_capacity(4, case.table.shape[0], case.idx.numel()),
                          _cuda.ROW_SUM_UNION_REUSE)
        want = case.gather().clone()
        res = {}
        for name, lib in list(libs.items()) * 2:  # two passes, in turns; the best
            _cuda._libs["mttkrp"] = lib
            try:
                fn = (lambda: case.sliced(_cuda.ROW_SUM_SLICE_COLS, False)) if route == "sliced" \
                    else (lambda: case.union(lay))
                case.out.fill_(float("nan"))
                if not same_bits(fn(), want):
                    raise AssertionError(f"K5 {name} at {label}: other bits than the gather route")
                ms = time_graph(fn, reps=20)
            finally:
                _cuda._libs["mttkrp"] = libs["default"]
            res[name] = min(ms, res.get(name, ms))
        if route == "union":  # the flagged blocks' gather after the union kernel on one stream, as a first form ran it
            def serial():
                case.union(lay, with_gather=False)
                return _cuda.sampled_row_sum(case.ptr, lay.pieces, case.idx, case.w, case.table, case.out, case.partial,
                                             case.tickets, flag=lay.flag, block=lay.block)

            case.out.fill_(float("nan"))
            if not same_bits(serial(), want):
                raise AssertionError(f"K5 at {label}: the one-stream union route gave other bits")
            res["default_one_stream"] = time_graph(serial, reps=20)
            res["union_kernel_alone"] = time_graph(lambda: case.union(lay, with_gather=False), reps=20)
            res["gather_route"] = time_graph(case.gather, reps=20)
        print(json.dumps({"variants": label, "route": route, "ms": res,
                          "patches": {name: [new for _, new in make()] for name, make in VARIANTS.items()},
                          "card": card}), flush=True)


def orders(dev, card):
    """The union route's two launches (the union kernel, the gather route on
    the flagged blocks) on one stream and on two in either order, the union
    kernel also on a stream of higher priority, as built and with patched
    copies of mttkrp.cu (the first forms: the flag read before the row's
    bounds, the union grid no larger than its items; the flagged gather's
    preferred split of L1 and shared memory at most shared memory), at the
    attention shape (one flagged block), at windows of 256 with a fraction
    of random columns (most or all blocks flagged) and at the bench mask
    with K = 64 (every block flagged)."""
    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.experiments.common import time_graph
    from sparse_tpu_torch.kernels import _cuda
    from sparse_tpu_torch.kernels import dot as kdot

    libs = build_variants({**PATCHES, "first_forms": PATCHES["flag_before_bounds"] + PATCHES["union_grid_to_items"]})
    default = _cuda.load("mttkrp")
    libs["default"] = default
    high = torch.cuda.Stream(dev, priority=-1)
    gen = torch.Generator(device=dev).manual_seed(25)
    rng = np.random.default_rng(25)
    shapes = {"attention_attn_v": cases(dev)["attention_attn_v"][0]}
    rows_np, cols_np = tnn.local_attention_pattern(AT_L, AT_WINDOW)
    for frac in (0.02, 1.0):
        cols_f = cols_np.copy()
        swap = rng.random(cols_f.size) < frac
        cols_f[swap] = rng.integers(0, AT_L, int(swap.sum()))
        shapes[f"window_256_random_{frac}"] = kdot.SddmmPattern(
            torch.as_tensor(rows_np, device=dev).long(), torch.as_tensor(cols_f, device=dev).long(), AT_L, AT_L,
            rows_sorted=True)
    rows_b, cols_b, m_b, n_b = bench_pattern(dev)
    shapes["bench_mask_k64"] = kdot.SddmmPattern(rows_b, cols_b, m_b, n_b, rows_sorted=True)
    for label, pattern in shapes.items():
        n_table = pattern.sizes[1]
        case = Case(pattern, 0, torch.randn((n_table, AT_D), generator=gen, device=dev),
                    torch.rand(pattern.ends[0].numel(), generator=gen, device=dev))
        lay = case.layout(_cuda.ROW_SUM_UNION_BLOCK, _cuda.row_sum_union_capacity(4, n_table, case.idx.numel()),
                          _cuda.ROW_SUM_UNION_REUSE)
        union = lambda: _cuda.sampled_row_sum_union(case.ptr, lay, case.w, case.table, case.out)  # noqa: E731
        flagged = lambda: _cuda.sampled_row_sum(case.ptr, lay.pieces, case.idx, case.w, case.table, case.out,  # noqa: E731
                                                case.partial, case.tickets, flag=lay.flag, block=lay.block)

        def run(first, streams, lib="default"):
            """The two launches: ``first`` ("union" or "gather") enqueued first,
            on one stream, or on two ("two": the gather on a second stream;
            "high": the union kernel on a stream of higher priority)."""
            _cuda._libs["mttkrp"] = libs[lib]
            try:
                order = (union, flagged) if first == "union" else (flagged, union)
                if streams == "one":
                    for fn in order:
                        fn()
                    return case.out
                main = torch.cuda.current_stream()
                side = _cuda.side_stream(dev) if streams == "two" else high
                moved = flagged if streams == "two" else union
                side.wait_stream(main)
                for fn in order:
                    if fn is moved:
                        with torch.cuda.stream(side):
                            fn()
                    else:
                        fn()
                main.wait_stream(side)
            finally:
                _cuda._libs["mttkrp"] = default
            return case.out

        def alone(fn, lib):
            def go():
                _cuda._libs["mttkrp"] = libs[lib]
                try:
                    return fn()
                finally:
                    _cuda._libs["mttkrp"] = default
            return go

        variants = {}
        for lib in libs:
            variants[f"{lib}:flagged_gather_alone"] = alone(flagged, lib)
            for first in ("union", "gather"):
                for streams in ("one", "two", "high") if lib == "default" else ("two", "high"):
                    variants[f"{lib}:{streams}_stream_{first}_first"] = (
                        lambda first=first, streams=streams, lib=lib: run(first, streams, lib))
        want = case.gather().clone()
        res = {"gather_route": time_graph(case.gather, reps=20), "union_kernel_alone": time_graph(union, reps=20)}
        for _ in range(2):
            for name, fn in variants.items():
                case.out.fill_(float("nan"))
                if name.endswith("alone"):
                    case.out.copy_(want)
                fn()
                if not same_bits(case.out, want):
                    raise AssertionError(f"K5 {name} at {label}: other bits than the gather route")
                ms = time_graph(fn, reps=20)
                res[name] = min(ms, res.get(name, ms))
        print(json.dumps({"orders": label, "blocks_flagged": int(lay.flag.sum()), "blocks": lay.flag.numel(), "ms": res,
                          "patches": {name: [new for _, new in p] for name, p in PATCHES.items()}, "card": card}),
              flush=True)
        del case, lay


def main(argv):
    if not torch.cuda.is_available():
        print("chip_row_sum_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from sparse_tpu_torch.kernels import _cuda

    dev = torch.device("cuda")
    card = card_name_power()
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.load("mttkrp")
    parts = set(argv) or {"all"}
    for name, fn in (("step0", step0), ("slices", slices), ("unions", unions), ("variants", variants),
                     ("orders", orders)):
        if name in parts or "all" in parts:
            fn(dev, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
