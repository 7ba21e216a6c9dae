"""Build, load and launch the hand-written CUDA kernels of the port.

Each source under ``csrc/`` (``SOURCES``) is compiled on first use with
``nvcc`` for ``sm_90a`` into ``build/sparse_tpu_torch/`` at the repository
root, as one shared library of its own keyed by a hash of its text, and
loaded with ``ctypes`` (plain C interface: no PyTorch headers, so a build
takes seconds). ``load_all`` starts one ``nvcc`` per source at once. A
missing compiler, a failed build or a failed load raises; so does a launch
that CUDA refuses (each C entry point returns ``cudaGetLastError()``).

The launchers take tensors already on the GPU, of the kernel's dtype, check
that, allocate nothing themselves, launch on the current stream and do not
synchronize. The row-ELL, MTTKRP and probe launchers take contiguous tensors;
the BSR launchers and the SDDMM's read their operands through their
strides, K5 its table through a row stride. ``LAUNCHES``
counts the launches of each kernel; nothing else touches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "row_ell": _CSRC / "row_ell.cu",
    "bsr": _CSRC / "bsr.cu",
    "bsr_tc": _CSRC / "bsr_tc.cu",
    "mttkrp": _CSRC / "mttkrp.cu",
    "probes": _CSRC / "probes.cu",
    "sddmm": _CSRC / "sddmm.cu",
}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparse_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_p, _i64 = ctypes.c_void_p, ctypes.c_int64
# argtypes of each C entry point, by source; every one returns a CUDA error code
_SIGNATURES = {
    "row_ell": {
        **{
            f"st_row_ell_spmv_{dt}": [_p, _p, _p, _i64, _p, _p, _p, _i64, _p, _i64, _i64, _i64, _i64, _p]
            for dt in ("f32", "f64")
        },
        **{
            f"st_row_ell_spmm_{dt}": [_p, _p, _p, _i64, _p, _i64, _p, _i64, _p, _i64, _i64, _i64, _i64, _p]
            for dt in ("f32", "f64")
        },
    },
    "bsr": {
        **{
            f"st_bsr_spmm_{dt}": [_p, _i64, _i64, _i64, _p, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64, _i64, _p, _i64, _i64, _p]
            for dt in ("f32", "f64", "bf16")
        },
        "st_bsr_sddmm_f64": [_p, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64, _i64, _p, _i64, _i64, _i64, _p, _p],
    },
    "bsr_tc": {
        **{
            f"st_bsr_spmm_tc_{dt}": [_p, *[_i64] * 3, _p, _p, _p, *[_i64] * 5, _p, *[_i64] * 3, _p, _i64, _p, _p, _p]
            for dt in ("f32", "bf16")
        },
        **{
            f"st_bsr_sddmm_tc_{dt}": [_p, _p, *[_i64] * 3, _p, *[_i64] * 4, _p, *[_i64] * 3, _p, _i64, _p]
            for dt in ("f32", "bf16")
        },
    },
    "mttkrp": {
        **{
            f"st_mttkrp_{dt}": [_p, _p, _p, _i64, _i64, _i64, _p, _p, _p, _p, _p, _i64, _p, _p, _p, _p]
            for dt in ("f32", "f64", "bf16_f32", "bf16_f64")
        },
        **{f"st_row_sum_{dt}": [_p, _p, *[_i64] * 3, _p, _p, _p, *[_i64] * 3, _p, _p, _p, _p] for dt in ("f32", "f64")},
    },
    "probes": {
        **{f"st_spmv_products_{t}": [_p, _i64, _p, _p, _i64, _i64, _p, _p] for t in ("hilo", "bf16")},
        "st_lane_gather": [_p, _i64, _p, _i64, _i64, _p, _p],
        "st_lane_gather_blocksum": [_p, _i64, _p, *[_i64] * 3, _p, _p, _p, _p],
        "st_row_gather": [_p, _p, _p, *[_i64] * 9, _p, _p],
        "st_row_gather_sum": [_p, _p, *[_i64] * 4, _p, _p],
        "st_scalar_gather_sum": [_p, _i64, _p, _p, *[_i64] * 3, _p, _p],
        "st_row_pick_bf16": [_p, _i64, _p, _i64, _i64, _p, _p],
        "st_row_pick_counts": [_p, _i64, _p, *[_i64] * 4, _p, _p, _p, _p],
    },
    "sddmm": {
        f"st_sddmm_{dt}_{it}": [_p, _p, _p, _p, _i64, _i64, _p, *[_i64] * 8, _p, _p]
        for dt in ("f32", "f64")
        for it in ("i32", "i64")
    },
}

LAUNCHES = {
    "row_ell_spmv": 0,
    "row_ell_spmv_cluster": 0,
    "row_ell_spmm": 0,
    "bsr_spmm": 0,
    "bsr_spmm2": 0,
    "bsr_sddmm": 0,
    "ell_mttkrp": 0,
    "coo_mttkrp": 0,
    "spmv_products": 0,
    "lane_gather": 0,
    "row_gather_sum": 0,
    "row_pick_bf16": 0,
    "scalar_gather_sum": 0,
    "lane_gather_blocksum": 0,
    "row_pick_blocksum": 0,
    "pick_scale_wsum": 0,
    "sddmm": 0,
    "sampled_row_sum": 0,
}

# per source, set by its build: {"seconds": wall time of nvcc, "ptxas": its
# -Xptxas -v report, "path": the library}; only "path" when already built
BUILD_INFO = {}

_locks = {name: threading.Lock() for name in SOURCES}
_libs = {}
# zeroed ticket buffers of the kernels that finish split runs, by (device,
# stream); every launch leaves its tickets zero
_tickets = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of sparse_tpu_torch are compiled from "
            f"{', '.join(p.name for p in SOURCES.values())} on first use and need the CUDA toolkit"
        )
    return path


def _build(name, out):
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCES[name])]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "ptxas": res.stderr + res.stdout, "path": str(out)}


def load(name):
    """The loaded kernel library of source ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks[name]:
        if name not in _libs:
            key = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
            so = _BUILD_DIR / f"{name}_{key}.so"
            if not so.exists():
                _build(name, so)
            else:
                BUILD_INFO.setdefault(name, {"path": str(so)})
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def load_all():
    """Build (one ``nvcc`` per source, all started together) and load every library."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = [pool.submit(load, name) for name in SOURCES]
        return [f.result() for f in futures]


_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# values per lane in the SpMM's 16-byte loads
_WIDE = {torch.float32: 4, torch.float64: 2}


def _check_device(t, dtype, device, name):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")


def _check(name, t, dtype, device):
    _check_device(t, dtype, device, name)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(device, what):
    if device.type != "cuda":
        raise ValueError(f"the {what} kernels run on a CUDA device, not {device}")


def _check_layout(re, dtype, device):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the row-ELL kernels take float32 or float64, not {dtype}")
    require_cuda(device, "row-ELL")
    _check("flat_cols", re.flat_cols, torch.int32, device)
    _check("flat_data", re.flat_data, dtype, device)
    _check("tier_table", re.tier_table, torch.int64, device)
    _check("row_of_pos", re.row_of_pos, torch.int32, device)


# error codes of csrc/bsr_tc.cu beyond CUDA's own
_KERNEL_ERRORS = {
    100001: "cuTensorMapEncodeTiled is not available through the CUDA runtime",
    100002: "cuTensorMapEncodeTiled refused an operand's layout",
}


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_KERNEL_ERRORS.get(err, f'CUDA error {err}')}")


# K1's two kernels (csrc/row_ell.cu): "thread", one thread per position
# gathering x through L1/L2 (row_ell_spmv_kernel), the default, and
# "cluster", x held in the shared memory of a thread-block cluster
# (row_ell_spmv_cluster_kernel), launched only when asked for. On an H100 the
# cluster kernel lost to the thread kernel at every size measured, 8,192 to
# 2.1M entries at 65,536 columns, in float32 and float64: its gathers from
# another CTA's shared memory run slower than the thread kernel's through L2,
# and every launch first fills the cluster's slices (chip_row_ell_ablation.py;
# PERF.md). Its CTAs hold x in slices of at most SPMV_SLICE_BYTES (2^15
# float32 or 2^14 float64 values), at most SPMV_MAX_CLUSTER of them (the
# portable cluster size).
SPMV_KERNELS = ("thread", "cluster")
SPMV_SLICE_BYTES = 128 << 10
SPMV_MAX_CLUSTER = 8


class SpmvPlan(NamedTuple):
    """The cluster kernel's shape on a layout."""

    cluster: int  # CTAs a cluster, each holding one slice of x
    slice_log2: int  # a slice holds 2^slice_log2 values
    fits: bool  # x fits in SPMV_MAX_CLUSTER slices


def row_ell_spmv_plan(re, dtype):
    """The :class:`SpmvPlan` of layout ``re`` for an ``x`` of ``dtype``
    (float32 or float64). A slice holds the fewest values, a power of two of
    at least 16 and at most ``SPMV_SLICE_BYTES``, that ``ceil(n_cols / slice)``
    CTAs need; the cluster kernel runs where that is at most
    ``SPMV_MAX_CLUSTER``. x's alignment is no part of it: the kernel copies a
    slice's ragged 16-byte head and tail with plain loads."""
    max_log2 = (SPMV_SLICE_BYTES // dtype.itemsize).bit_length() - 1
    slice_log2 = min(max_log2, max(4, (max(re.n_cols, 1) - 1).bit_length()))
    cluster = max(1, -(-re.n_cols >> slice_log2))
    return SpmvPlan(cluster, slice_log2, cluster <= SPMV_MAX_CLUSTER)


def spmv(re, x, y, out, kernel="thread"):
    """Launch K1: ``out = A @ x (+ y)`` on the layout ``re``; ``re.flat_data``,
    ``x``, ``y`` and ``out`` share one float dtype. ``kernel``: ``"thread"``
    (the default) or ``"cluster"`` (x fits in ``SPMV_MAX_CLUSTER`` slices of
    :func:`row_ell_spmv_plan`). Both give the same bits. Counted as
    ``row_ell_spmv`` (thread) or ``row_ell_spmv_cluster``."""
    dtype, device = x.dtype, x.device
    if kernel not in SPMV_KERNELS:
        raise ValueError(f"row_ell_spmv: kernel must be one of {SPMV_KERNELS}, not {kernel!r}")
    _check_layout(re, dtype, device)
    _check("x", x, dtype, device)
    _check("out", out, dtype, device)
    if y is not None:
        _check("y", y, dtype, device)
    if x.shape != (re.n_cols,) or out.shape != (re.n_rows,) or (y is not None and y.shape != out.shape):
        raise ValueError("row_ell_spmv: operand shapes do not match the layout")
    cluster = slice_log2 = 0  # the thread kernel takes neither
    if kernel == "cluster":
        cluster, slice_log2, fits = row_ell_spmv_plan(re, dtype)
        if not fits:
            raise ValueError(
                f"row_ell_spmv: x of {re.n_cols} values needs {cluster} slices of 2^{slice_log2}, "
                f"more than the cluster kernel's {SPMV_MAX_CLUSTER}"
            )
    n_pos = re.row_of_pos.shape[0]
    if n_pos == 0:
        return out
    fn = getattr(load("row_ell"), f"st_row_ell_spmv_{_SUFFIX[dtype]}")
    err = fn(
        re.flat_cols.data_ptr(),
        re.flat_data.data_ptr(),
        x.data_ptr(),
        re.n_cols,
        None if y is None else y.data_ptr(),
        out.data_ptr(),
        re.tier_table.data_ptr(),
        re.tier_table.shape[0],
        re.row_of_pos.data_ptr(),
        n_pos,
        SPMV_KERNELS.index(kernel),
        cluster,
        slice_log2,
        torch.cuda.current_stream(device).cuda_stream,
    )
    name = "row_ell_spmv" if kernel == "thread" else "row_ell_spmv_cluster"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


# The staged K2 kernel (csrc/row_ell.cu: kGroup, kStageJ, kStages): a unit
# is one group of ROW_ELL_GROUP positions (one warp each) x one column tile
# of 32 * vec columns; a unit's indices are staged ROW_ELL_STAGE_J entries
# of its positions at a time, in a ring of ROW_ELL_STAGES stages.
ROW_ELL_GROUP = 16
ROW_ELL_STAGE_J = 64
ROW_ELL_STAGES = 2
SPMM_KERNELS = {"warp": 0, "staged": 1}


class RowEllPlan(NamedTuple):
    """How the staged K2 kernel walks a layout for ``N`` columns."""

    groups: int  # groups of ROW_ELL_GROUP positions in the tiers with entries
    col_tiles: int
    units: int  # groups x column tiles
    chunks: int  # index stages over all units
    zero_positions: int  # positions of the rows without entries
    stage_bytes: int  # shared memory of one stage


def row_ell_stage_bytes(dtype):
    """Bytes of one index stage: cols, values and the group's row_of_pos."""
    return ROW_ELL_STAGE_J * ROW_ELL_GROUP * (4 + dtype.itemsize) + ROW_ELL_GROUP * 4


def row_ell_chunks(width):
    """Index stages one unit of a tier of ``width`` entries takes."""
    return -(-width // ROW_ELL_STAGE_J)


def row_ell_staged_layout(re):
    """True when the staged kernel takes the layout: tiers, all grouped with
    G = ROW_ELL_GROUP and of width >= 1 (build_row_ell's default)."""
    return bool(re.tiers) and all(c.ndim == 3 and c.shape[2] == ROW_ELL_GROUP and c.shape[1] > 0 for c, _ in re.tiers)


def _row_ell_groups(re):
    return sum(c.shape[0] for c, _ in re.tiers)


def row_ell_plan(re, n, vec, dtype):
    """The :class:`RowEllPlan` of a layout that :func:`row_ell_staged_layout`
    takes, for ``n`` columns read ``vec`` values a lane."""
    col_tiles = -(-n // (32 * vec))
    groups = _row_ell_groups(re)
    chunks = col_tiles * sum(c.shape[0] * row_ell_chunks(c.shape[1]) for c, _ in re.tiers)
    zero = re.row_of_pos.shape[0] - groups * ROW_ELL_GROUP
    return RowEllPlan(groups, col_tiles, groups * col_tiles, chunks, zero, row_ell_stage_bytes(dtype))


def spmm(re, dense, out, kernel=None):
    """Launch K2: ``out = A @ dense`` on the layout ``re``; ``re.flat_data``,
    ``dense`` and ``out`` share one float dtype. ``kernel``: ``"staged"``
    (indices staged by bulk copy, persistent grid; grouped layouts with G =
    16, whose ``flat_cols``, ``flat_data`` and ``row_of_pos`` start on 16
    bytes) or ``"warp"`` (one warp per position, any layout). By default the
    staged kernel where the layout allows it and B's rows are read 16 bytes
    a lane, else the warp kernel. Both give the same bits."""
    dtype, device = dense.dtype, dense.device
    _check_layout(re, dtype, device)
    _check("dense", dense, dtype, device)
    _check("out", out, dtype, device)
    n = dense.shape[1]
    if dense.shape[0] != re.n_cols or out.shape != (re.n_rows, n):
        raise ValueError("row_ell_spmm: operand shapes do not match the layout")
    if kernel not in (None, *SPMM_KERNELS):
        raise ValueError(f"row_ell_spmm: kernel must be one of {tuple(SPMM_KERNELS)}, not {kernel!r}")
    n_pos = re.row_of_pos.shape[0]
    if n_pos == 0 or n == 0:
        return out
    wide = _WIDE[dtype]
    vec = wide if n % wide == 0 and dense.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    staged = row_ell_staged_layout(re)
    if kernel is None:
        kernel = "staged" if staged and vec == wide else "warp"
    n_groups = 0
    if kernel == "staged":
        if not staged:
            raise ValueError(f"row_ell_spmm: the staged kernel takes grouped layouts with G = {ROW_ELL_GROUP}")
        for name in ("flat_cols", "flat_data", "row_of_pos"):
            if getattr(re, name).data_ptr() % 16:
                raise ValueError(f"row_ell_spmm: {name} must start on 16 bytes for the staged kernel's bulk copies")
        n_groups = _row_ell_groups(re)
    elif -(-n // (32 * vec)) > 65535:
        raise ValueError(f"row_ell_spmm: N = {n} needs more than 65535 column tiles")
    fn = getattr(load("row_ell"), f"st_row_ell_spmm_{_SUFFIX[dtype]}")
    err = fn(
        re.flat_cols.data_ptr(),
        re.flat_data.data_ptr(),
        dense.data_ptr(),
        n,
        out.data_ptr(),
        n,
        re.tier_table.data_ptr(),
        re.tier_table.shape[0],
        re.row_of_pos.data_ptr(),
        n_pos,
        vec,
        SPMM_KERNELS[kernel],
        n_groups,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, "row_ell_spmm")
    LAUNCHES["row_ell_spmm"] += 1
    return out


# output tile of the BSR kernels (csrc/bsr.cu: TM, TN)
_BSR_TILE = 64


def check_bsr_dtype(dtype):
    if dtype not in _SUFFIX:
        raise TypeError(f"the BSR kernels take float32, float64 or bfloat16, not {dtype}")


def bsr_spmm(blocks, block_cols, row_ptr, dense, out, pairs=1):
    """Launch the BSR SpMM of ``csrc/bsr.cu`` on the CUDA cores (P2 in
    float64 with ``pairs=1``, its two-block form P3 with ``pairs=2``, which
    the wrappers run in float64 only; float32 and bfloat16 P2 and P3 are
    :func:`bsr_spmm_tc`): ``out =
    A @ dense`` with ``A``'s block-row ``r`` the run ``row_ptr[r]:row_ptr[r+1]``
    of ``blocks`` (any strides) and ``block_cols`` (int32), ``dense`` of any
    strides, ``out`` contiguous ``(n_rows, N)``. With ``pairs=2`` every run
    must have even length; the caller checks."""
    dtype, device = dense.dtype, dense.device
    check_bsr_dtype(dtype)
    if pairs == 1 and dtype in TC_DTYPES:
        raise TypeError(f"the {dtype} BSR SpMM runs on the tensor cores: bsr_spmm_tc")
    require_cuda(device, "BSR")
    _check_device(blocks, dtype, device, "blocks")
    _check_device(dense, dtype, device, "dense")
    _check("block_cols", block_cols, torch.int32, device)
    _check("row_ptr", row_ptr, torch.int64, device)
    _check("out", out, dtype, device)
    n_blocks, bm, bn = blocks.shape
    k, n = dense.shape
    n_rows = out.shape[0]
    n_block_rows = row_ptr.shape[0] - 1
    if block_cols.shape != (n_blocks,) or out.shape != (n_rows, n) or n_block_rows != -(-n_rows // bm):
        raise ValueError("bsr_spmm: operand shapes do not match the layout")
    if pairs not in (1, 2):
        raise ValueError(f"bsr_spmm: pairs must be 1 or 2, not {pairs}")
    if n_rows == 0 or n == 0:
        return out
    if -(-n // _BSR_TILE) > 65535:
        raise ValueError(f"bsr_spmm: N = {n} needs more than 65535 column tiles")
    name = "bsr_spmm" if pairs == 1 else "bsr_spmm2"
    fn = getattr(load("bsr"), f"st_bsr_spmm_{_SUFFIX[dtype]}")
    err = fn(
        blocks.data_ptr(),
        *blocks.stride(),
        block_cols.data_ptr(),
        row_ptr.data_ptr(),
        n_block_rows,
        bm,
        bn,
        dense.data_ptr(),
        k,
        n,
        *dense.stride(),
        out.data_ptr(),
        n_rows,
        pairs,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _check_sddmm(block_rows, block_cols, lhs, rhs, out):
    dtype, device = lhs.dtype, lhs.device
    require_cuda(device, "BSR")
    _check_device(lhs, dtype, device, "lhs")
    _check_device(rhs, dtype, device, "rhs")
    _check("block_rows", block_rows, torch.int32, device)
    _check("block_cols", block_cols, torch.int32, device)
    _check("out", out, dtype, device)
    n_blocks = out.shape[0]
    if lhs.ndim != 2 or rhs.ndim != 2 or out.ndim != 3 or rhs.shape[0] != lhs.shape[1]:
        raise ValueError("bsr_sddmm: lhs and rhs must be (M, B) and (B, K), out (n_blocks, bm, bn)")
    if block_rows.shape != (n_blocks,) or block_cols.shape != (n_blocks,):
        raise ValueError("bsr_sddmm: operand shapes do not match the layout")


def bsr_sddmm(block_rows, block_cols, lhs, rhs, out):
    """Launch the float64 block-sampled SDDMM (P4) of ``csrc/bsr.cu`` on the
    CUDA cores (float32 and bfloat16 are :func:`bsr_sddmm_tc`): ``out[j] =
    lhs[rows[j]-block, :] @ rhs[:, cols[j]-block]`` for every stored block,
    ``lhs`` ``(M, B)`` and ``rhs`` ``(B, K)`` of any strides, ``out``
    contiguous ``(n_blocks, bm, bn)``."""
    dtype, device = lhs.dtype, lhs.device
    check_bsr_dtype(dtype)
    if dtype in TC_DTYPES:
        raise TypeError(f"the {dtype} BSR SDDMM runs on the tensor cores: bsr_sddmm_tc")
    _check_sddmm(block_rows, block_cols, lhs, rhs, out)
    n_blocks, bm, bn = out.shape
    m, b = lhs.shape
    if out.numel() == 0:
        return out
    fn = load("bsr").st_bsr_sddmm_f64
    err = fn(
        block_rows.data_ptr(),
        block_cols.data_ptr(),
        n_blocks,
        bm,
        bn,
        lhs.data_ptr(),
        m,
        b,
        *lhs.stride(),
        rhs.data_ptr(),
        rhs.shape[1],
        *rhs.stride(),
        out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, "bsr_sddmm")
    LAUNCHES["bsr_sddmm"] += 1
    return out


# Long runs are cut into pieces counted from the run's start: MTTKRP runs
# longer than MTTKRP_PIECE slots, BSR runs longer than BSR_PIECE blocks
# (csrc/mttkrp.cu, csrc/bsr_tc.cu). Both were picked on an H100 (PERF.md).
MTTKRP_PIECE = 256
BSR_PIECE = 32


def run_pieces(row_ptr, piece):
    """int64 ``(n + 1,)`` from run offsets ``row_ptr`` ``(n + 1,)``: the
    number of pieces of ``piece`` entries that the runs longer than
    ``piece`` make, summed over the rows before each row (0 for a row that
    is not split). Torch ops on ``row_ptr``'s device."""
    lens = row_ptr[1:] - row_ptr[:-1]
    n = torch.where(lens > piece, torch.div(lens + (piece - 1), piece, rounding_mode="floor"), 0)
    out = torch.zeros(row_ptr.shape[0], dtype=torch.int64, device=row_ptr.device)
    torch.cumsum(n, 0, out=out[1:])
    return out


def front_bound(n_entries, n_rows, piece):
    """An upper bound, from sizes alone, on the pieces of :func:`run_pieces`
    over ``n_rows`` runs of ``n_entries`` in all: a split run of ``l >
    piece`` entries makes ``⌈l / piece⌉ < l / piece + 1`` pieces, and at
    most ``n_entries // (piece + 1)`` runs are split."""
    return -(-n_entries // piece) + min(n_rows, n_entries // (piece + 1))


def zeroed_tickets(device, n):
    """An int32 buffer of at least ``n`` zeros on ``device``, one per
    stream, that the kernels finishing split runs leave zero."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


# the tensor-core BSR SpMM (csrc/bsr_tc.cu): output tile BSR_TC_TILE x
# BSR_TC_TILE, stages of TC_ROW_BYTES of k per row
BSR_TC_TILE = 128
TC_ROW_BYTES = 128
TC_DTYPES = (torch.float32, torch.bfloat16)


def tc_k_per_stage(dtype):
    return TC_ROW_BYTES // dtype.itemsize


def bsr_tc_scratch(n_blocks, n_block_rows, bm, n, piece=BSR_PIECE):
    """``(n_front, partial elements, tickets)`` of a tensor-core BSR SpMM."""
    n_front = front_bound(n_blocks, n_block_rows, piece)
    tiles = -(-bm // BSR_TC_TILE) * -(-n // BSR_TC_TILE)
    return n_front, n_front * tiles * BSR_TC_TILE * BSR_TC_TILE, n_front * tiles


def _tc_ready(t, k_dim):
    """True when ``t`` has stride 1 along ``k_dim`` and TMA-legal (16-byte)
    other strides and base."""
    es = t.element_size()
    return (
        t.stride(k_dim) == 1
        and t.data_ptr() % 16 == 0
        and all((st * es) % 16 == 0 for i, st in enumerate(t.stride()) if i != k_dim)
    )


def bsr_spmm_tc(blocks, block_cols, row_ptr, pieces, dense, out, partial, tickets, piece=None, name="bsr_spmm"):
    """Launch P2 on the tensor cores (float32 as 3xTF32, bfloat16): ``out =
    A @ dense`` with ``A``'s block-row ``r`` the run ``row_ptr[r]:row_ptr[r +
    1]`` of ``blocks`` and ``block_cols`` (int32). Both operands K-major
    with 16-byte strides: ``blocks`` ``(n_blocks, bm, bn)`` with stride 1
    along bn, bn a multiple of :func:`tc_k_per_stage`; ``dense`` ``(K, N)``
    with stride 1 along K. ``out`` contiguous ``(n_rows, N)``. Runs longer
    than ``piece`` blocks (:data:`BSR_PIECE`) are split: ``pieces`` is
    ``run_pieces(row_ptr, piece)``, ``partial`` (float32) and ``tickets``
    (:func:`zeroed_tickets`) are sized by :func:`bsr_tc_scratch`. Counted
    as ``name``: ``bsr_spmm`` (P2) or ``bsr_spmm2`` (P3, whose block pairs
    were a TPU pipeline step: the stage ring walks a run block by block
    either way)."""
    if name not in ("bsr_spmm", "bsr_spmm2"):
        raise ValueError(f"bsr_spmm_tc counts as bsr_spmm or bsr_spmm2, not {name!r}")
    piece = BSR_PIECE if piece is None else int(piece)
    dtype, device = dense.dtype, dense.device
    if dtype not in TC_DTYPES:
        raise TypeError(f"the tensor-core BSR SpMM takes float32 or bfloat16, not {dtype}")
    require_cuda(device, "BSR")
    _check_device(blocks, dtype, device, "blocks")
    _check_device(dense, dtype, device, "dense")
    _check("block_cols", block_cols, torch.int32, device)
    _check("row_ptr", row_ptr, torch.int64, device)
    _check("pieces", pieces, torch.int64, device)
    _check("out", out, dtype, device)
    _check("partial", partial, torch.float32, device)
    _check("tickets", tickets, torch.int32, device)
    n_blocks, bm, bn = blocks.shape
    k, n = dense.shape
    n_rows = out.shape[0]
    n_block_rows = row_ptr.shape[0] - 1
    if (
        block_cols.shape != (n_blocks,)
        or out.shape != (n_rows, n)
        or n_block_rows != -(-n_rows // bm)
        or pieces.shape != row_ptr.shape
    ):
        raise ValueError("bsr_spmm_tc: operand shapes do not match the layout")
    if not (_tc_ready(blocks, 2) and _tc_ready(dense, 0)) or bn % tc_k_per_stage(dtype):
        raise ValueError(
            "bsr_spmm_tc: blocks and dense must be K-major with 16-byte strides and bn a multiple of "
            f"{tc_k_per_stage(dtype)}; the wrapper bsr_spmm_kernel copies other layouts"
        )
    n_front, n_partial, n_tickets = bsr_tc_scratch(n_blocks, n_block_rows, bm, n, piece)
    if partial.numel() < n_partial or tickets.numel() < n_tickets:
        raise ValueError("bsr_spmm_tc: partial or tickets smaller than bsr_tc_scratch asks")
    if n_rows == 0 or n == 0:
        return out
    if n_blocks == 0 or k == 0:  # no stored block or an empty contraction: the product is zero
        return out.zero_()
    fn = getattr(load("bsr_tc"), f"st_bsr_spmm_tc_{_SUFFIX[dtype]}")
    err = fn(
        blocks.data_ptr(),
        n_blocks,
        blocks.stride(0),
        blocks.stride(1),
        block_cols.data_ptr(),
        row_ptr.data_ptr(),
        pieces.data_ptr(),
        n_block_rows,
        n_front,
        piece,
        bm,
        bn,
        dense.data_ptr(),
        k,
        n,
        dense.stride(1),
        out.data_ptr(),
        n_rows,
        partial.data_ptr(),
        tickets.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def sddmm_tc_major(t, mn_dim):
    """How the tensor-core SDDMM reads the operand ``t`` as it lies:
    ``(True, ld)`` with stride 1 along its MN axis ``mn_dim`` (0 for lhs
    ``(M, B)``, 1 for rhs ``(B, K)``), ``(False, ld)`` with stride 1 along
    its k axis; ``ld``, the other stride, a multiple of 16 bytes and at least
    the length of the unit-stride axis, and a 16-byte aligned base. ``None``
    for any other layout."""
    for inner, mn in ((mn_dim, True), (1 - mn_dim, False)):
        ld = t.stride(1 - inner)
        if _tc_ready(t, inner) and ld >= max(t.shape[inner], 1):
            return mn, ld
    return None


def bsr_sddmm_tc(block_rows, block_cols, lhs, rhs, out):
    """Launch P4 on the tensor cores (float32 as 3xTF32, bfloat16): ``out[j]
    = lhs[rows[j]-block, :] @ rhs[:, cols[j]-block]`` for every stored block
    (zero past M and K; a zero block where an index is negative), ``lhs``
    ``(M, B)`` and ``rhs`` ``(B, K)`` each K-major or MN-major as
    :func:`sddmm_tc_major` takes them, ``out`` contiguous ``(n_blocks, bm,
    bn)``, ``block_rows``/``block_cols`` int32. Counted as ``bsr_sddmm``."""
    dtype, device = lhs.dtype, lhs.device
    if dtype not in TC_DTYPES:
        raise TypeError(f"the tensor-core BSR SDDMM takes float32 or bfloat16, not {dtype}")
    _check_sddmm(block_rows, block_cols, lhs, rhs, out)
    if out.numel() == 0:
        return out
    if min(lhs.shape[0], lhs.shape[1], rhs.shape[1]) == 0:  # nothing to read: every block is zero
        return out.zero_()
    a, b = sddmm_tc_major(lhs, 0), sddmm_tc_major(rhs, 1)
    if a is None or b is None:
        raise ValueError(
            "bsr_sddmm_tc: lhs and rhs must each have stride 1 along one axis, the other stride a multiple of "
            "16 bytes, and a 16-byte aligned base; the wrapper bsr_sddmm_kernel copies other layouts"
        )
    n_blocks, bm, bn = out.shape
    fn = getattr(load("bsr_tc"), f"st_bsr_sddmm_tc_{_SUFFIX[dtype]}")
    err = fn(
        block_rows.data_ptr(),
        block_cols.data_ptr(),
        n_blocks,
        bm,
        bn,
        lhs.data_ptr(),
        lhs.shape[0],
        lhs.shape[1],
        a[1],
        int(a[0]),
        rhs.data_ptr(),
        rhs.shape[1],
        b[1],
        int(b[0]),
        out.data_ptr(),
        torch.cuda.get_device_properties(device).multi_processor_count,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, "bsr_sddmm")
    LAUNCHES["bsr_sddmm"] += 1
    return out


# (table dtype, value dtype) -> entry point suffix of csrc/mttkrp.cu
_MTTKRP_SUFFIX = {
    (torch.float32, torch.float32): "f32",
    (torch.float64, torch.float64): "f64",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.bfloat16, torch.float64): "bf16_f64",
}


def mttkrp(row_ptr, pieces, order, cj, ck, v, c, d, out, partial, tickets, piece=None):
    """Launch the MTTKRP kernel: ``out[i] = Σ v[s] · c[cj[s]] · d[ck[s]]``
    over the slots ``s`` of row ``i``'s run ``row_ptr[i]:row_ptr[i + 1]``,
    read through ``order`` (int32, the block-ELL form, counted as
    ``ell_mttkrp``) or in place (``order=None``, the sorted-COO form,
    ``coo_mttkrp``). ``cj``/``ck`` int32 and ``v`` flat and of one length,
    ``c``/``d`` ``(J, r)``/``(K, r)`` of the table dtype, ``out`` ``(n_rows,
    r)`` of ``v``'s dtype; all contiguous. Runs longer than ``piece`` slots
    (:data:`MTTKRP_PIECE`) are split: ``pieces`` is
    ``run_pieces(row_ptr, piece)``, scratch ``partial`` of ``out``'s dtype
    holds at least ``front_bound(n_slots, n_rows, piece) · r`` values and
    ``tickets`` (int32, :func:`zeroed_tickets`) as many as ``front_bound ·
    ⌈r / 32⌉``, zero before the launch and after it. The caller guarantees
    every index in range."""
    name = "coo_mttkrp" if order is None else "ell_mttkrp"
    piece = MTTKRP_PIECE if piece is None else int(piece)
    dtype, device = v.dtype, v.device
    require_cuda(device, "MTTKRP")
    suffix = _MTTKRP_SUFFIX.get((c.dtype, dtype))
    if suffix is None:
        raise TypeError(f"the MTTKRP kernel takes tables of {dtype} or bfloat16 with {dtype} values, not {c.dtype}")
    _check("row_ptr", row_ptr, torch.int64, device)
    _check("pieces", pieces, torch.int64, device)
    if order is not None:
        _check("order", order, torch.int32, device)
    _check("cj", cj, torch.int32, device)
    _check("ck", ck, torch.int32, device)
    _check("v", v, dtype, device)
    _check("c", c, c.dtype, device)
    _check("d", d, c.dtype, device)
    _check("out", out, dtype, device)
    _check("partial", partial, dtype, device)
    _check("tickets", tickets, torch.int32, device)
    n_rows, r = out.shape
    n_slots = v.shape[0]
    n_front = front_bound(n_slots, n_rows, piece)
    if (
        cj.shape != (n_slots,)
        or ck.shape != (n_slots,)
        or (order is not None and order.shape != (n_slots,))
        or row_ptr.ndim != 1
        or row_ptr.shape[0] < n_rows + 1
        or pieces.shape[0] < n_rows + 1
        or c.ndim != 2
        or d.ndim != 2
        or c.shape[1] != r
        or d.shape[1] != r
        or partial.numel() < n_front * r
        or tickets.numel() < n_front * -(-r // 32)
    ):
        raise ValueError("mttkrp: operand shapes do not match")
    if n_rows == 0 or r == 0:
        return out
    fn = getattr(load("mttkrp"), f"st_mttkrp_{suffix}")
    err = fn(
        row_ptr.data_ptr(),
        pieces.data_ptr(),
        None if order is None else order.data_ptr(),
        n_rows,
        n_front,
        piece,
        cj.data_ptr(),
        ck.data_ptr(),
        v.data_ptr(),
        c.data_ptr(),
        d.data_ptr(),
        r,
        out.data_ptr(),
        partial.data_ptr(),
        tickets.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


# the width of every probe table (csrc/probes.cu: kLanes)
PROBE_LANES = 128
# Shared memory one CTA of an H100 may take (the opt-in maximum), less a
# reserve for the kernels' static shared memory: the budget of the probe
# kernels that hold their table there (csrc/probes.cu).
SMEM_BLOCK_BYTES = 232_448 - 1024
PROBE_ROW_BYTES = PROBE_LANES * 4


def _check_probe_table(name, t, device):
    _check(name, t, torch.float32, device)
    if t.ndim != 2 or t.shape[1] != PROBE_LANES:
        raise ValueError(f"{name} of shape {tuple(t.shape)}: the probe kernels take (rows, {PROBE_LANES})")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the probe kernels' vector loads")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def spmv_products_resident(rows, hilo):
    """True when E1's table of ``rows`` rows fits one CTA's shared memory:
    the bf16 table whole (256 bytes a row), the hi|lo table half (a CTA
    holds ``⌈rows / 2⌉`` rows of 512 bytes); 904 rows either way."""
    held = -(-rows // 2) * PROBE_ROW_BYTES if hilo else rows * PROBE_ROW_BYTES // 2
    return rows > 0 and held <= SMEM_BLOCK_BYTES


def spmv_products_design(rows, hilo):
    """The design E1's launcher (csrc/probes.cu) runs for a table of ``rows``
    rows: with the table in shared memory (spmv_products_smem_kernel), the
    hi|lo table in CTA pairs, each CTA holding half its rows
    (``"smem_pairs"``), the bf16 table whole in every CTA (``"smem"``); a
    taller table read through L1/L2 (spmv_products_kernel, ``"l2"``)."""
    if not spmv_products_resident(rows, hilo):
        return "l2"
    return "smem_pairs" if hilo else "smem"


def spmv_products(x2, cols, data, out):
    """Launch E1: ``out[e, 0] = (x2[q, m] + x2[q, 128 + m]) · data[e]`` with a
    hi|lo table ``x2`` of shape ``(rows, 256)``, or ``x2[q, m] · data[e]``
    with a bf16 table ``(rows, 128)``, where ``q, m = divmod(cols[e], 128)``;
    0 where ``q`` is outside the table. ``x2`` bfloat16 (16-byte aligned when
    it fits shared memory: :func:`spmv_products_resident`), ``cols`` int32
    and ``data`` float32 of shape ``(n,)``, ``out`` float32 ``(n, 1)``. The
    design by table: :func:`spmv_products_design`."""
    device = cols.device
    require_cuda(device, "probe")
    _check("x2", x2, torch.bfloat16, device)
    _check("cols", cols, torch.int32, device)
    _check("data", data, torch.float32, device)
    _check("out", out, torch.float32, device)
    n = cols.shape[0]
    if x2.ndim != 2 or x2.shape[1] not in (PROBE_LANES, 2 * PROBE_LANES):
        raise ValueError(f"spmv_products: x2 of shape {tuple(x2.shape)}, expected (rows, 128) or (rows, 256)")
    if cols.ndim != 1 or data.shape != (n,) or out.shape != (n, 1):
        raise ValueError("spmv_products: cols, data and out must be (n,), (n,) and (n, 1)")
    if n == 0:
        return out
    hilo = x2.shape[1] == 2 * PROBE_LANES
    resident = spmv_products_resident(x2.shape[0], hilo)
    if resident:
        _check_aligned(x2=x2)
    fn = getattr(load("probes"), "st_spmv_products_hilo" if hilo else "st_spmv_products_bf16")
    err = fn(x2.data_ptr(), x2.shape[0], cols.data_ptr(), data.data_ptr(), n, int(resident), out.data_ptr(),
             _stream(device))
    _raise_on(err, "spmv_products")
    LAUNCHES["spmv_products"] += 1
    return out


# E3's routes (csrc/probes.cu): a table whose 32-lane column slices fit one
# CTA's shared memory (rows x 128 bytes: 1,808 rows) takes the slice route
# (lane_slice_kernel<false>: a CTA a lane slice, the rows split evenly over
# the grid's warps), a taller one the L2 route (lane_gather_kernel<false>:
# every pick a 4-byte load through L1/L2)
SLICE_LANES = 32


def lane_gather_design(rows):
    """The route E3's launcher takes for a table of ``rows`` rows:
    ``"slices"`` when a 32-lane column slice of it fits one CTA's shared
    memory, else ``"l2"``."""
    return "slices" if 0 < rows * SLICE_LANES * 4 <= SMEM_BLOCK_BYTES else "l2"


def lane_gather(table, idx, out):
    """Launch E3 (``pallas_vmem.py:p1``): ``out[i, l] = table[idx[i, l], l]``;
    ``table`` float32 ``(rows, 128)``, ``idx`` int32 and ``out`` float32
    ``(n, 128)``, both 16-byte aligned. The route:
    :func:`lane_gather_design`; the slice route takes ``table`` 16-byte
    aligned too. The caller guarantees every index in range."""
    device = idx.device
    require_cuda(device, "probe")
    _check_probe_table("table", table, device)
    _check("idx", idx, torch.int32, device)
    _check("out", out, torch.float32, device)
    if idx.ndim != 2 or idx.shape[1] != PROBE_LANES or out.shape != idx.shape:
        raise ValueError(f"lane_gather: idx and out must both be (n, {PROBE_LANES})")
    _check_aligned(idx=idx, out=out)
    rows = table.shape[0]
    slices = lane_gather_design(rows) == "slices"
    if slices:
        _check_aligned(table=table)
    if idx.shape[0] == 0:
        return out
    err = load("probes").st_lane_gather(
        table.data_ptr(), rows, idx.data_ptr(), idx.shape[0], int(slices), out.data_ptr(), _stream(device)
    )
    _raise_on(err, "lane_gather")
    LAUNCHES["lane_gather"] += 1
    return out


# E7's routes (csrc/probes.cu): a table whose 32-lane column slices fit one
# CTA's shared memory beside its 16 warps' sums (rows x 128 bytes + 2 KB:
# 1,792 rows) takes the slice route
# (lane_slice_kernel<true>: a CTA a lane slice and block, no scratch), a
# taller one the L2 route (lane_gather_kernel<true>: LANE_SPLIT_ROWS rows of
# a block a CTA, their partial rows added by the block's last CTA)
SLICE_WARPS = 16
LANE_SPLIT_ROWS = 64


def lane_slice_resident(rows):
    """True when a 32-lane column slice of E7's table of ``rows`` rows fits
    one CTA's shared memory beside the warps' sums: the slice route."""
    return rows > 0 and (rows + SLICE_WARPS) * SLICE_LANES * 4 <= SMEM_BLOCK_BYTES


def lane_blocksum_scratch(rows, n_blocks, T, device):
    """The scratch of E7's route for a table of ``rows`` rows: none on the
    slice route; on the L2 route ``partial`` float32 ``(n_blocks, ⌈T / 64⌉,
    128)`` and ``tickets`` int32 ``(n_blocks,)`` of zeros."""
    if lane_slice_resident(rows):
        return None, None
    partial = torch.empty((n_blocks, -(-T // LANE_SPLIT_ROWS), PROBE_LANES), dtype=torch.float32, device=device)
    return partial, torch.zeros(n_blocks, dtype=torch.int32, device=device)


def lane_gather_blocksum(table, idx, rows_per_block, out, partial=None, tickets=None):
    """Launch E7 (``pallas_vmem2.py:g1``): ``out[8b + c, l] = Σ_{t < T}
    table[idx[bT + t, l], l]`` for ``c < 8``, ``T = rows_per_block``;
    ``table`` float32 ``(rows, 128)``, ``idx`` int32 ``(n_blocks · T,
    128)``, ``out`` float32 ``(n_blocks · 8, 128)``. The route:
    :func:`lane_slice_resident`; the slice route takes ``table`` 16-byte
    aligned, the L2 route the scratch of :func:`lane_blocksum_scratch`
    (``tickets`` zero before the first launch; each launch leaves it zero).
    The caller guarantees every index in range."""
    device = idx.device
    require_cuda(device, "probe")
    _check_probe_table("table", table, device)
    _check("idx", idx, torch.int32, device)
    _check("out", out, torch.float32, device)
    if rows_per_block <= 0 or idx.ndim != 2 or idx.shape[1] != PROBE_LANES or idx.shape[0] % rows_per_block:
        raise ValueError(f"lane_gather_blocksum: idx must be (n_blocks * {rows_per_block}, {PROBE_LANES})")
    n_blocks = idx.shape[0] // rows_per_block
    if out.shape != (n_blocks * 8, PROBE_LANES):
        raise ValueError("lane_gather_blocksum: out does not match idx")
    rows = table.shape[0]
    resident = lane_slice_resident(rows)
    if resident:
        _check_aligned(table=table)
    else:
        if partial is None or tickets is None:
            raise ValueError("lane_gather_blocksum: the L2 route takes partial and tickets (lane_blocksum_scratch)")
        _check("partial", partial, torch.float32, device)
        _check("tickets", tickets, torch.int32, device)
        if partial.shape != (n_blocks, -(-rows_per_block // LANE_SPLIT_ROWS), PROBE_LANES) or tickets.shape != (n_blocks,):
            raise ValueError("lane_gather_blocksum: partial or tickets do not match idx")
        if n_blocks > 65535:
            raise ValueError(f"lane_gather_blocksum: {n_blocks} blocks, at most 65535 on the L2 route")
    if n_blocks == 0:
        return out
    err = load("probes").st_lane_gather_blocksum(
        table.data_ptr(),
        rows,
        idx.data_ptr(),
        n_blocks,
        rows_per_block,
        int(resident),
        out.data_ptr(),
        None if resident else partial.data_ptr(),
        None if resident else tickets.data_ptr(),
        _stream(device),
    )
    _raise_on(err, "lane_gather_blocksum")
    LAUNCHES["lane_gather_blocksum"] += 1
    return out


def _row_gather(name, table, idx, weights, out, out_shape, *, n_seg, seg_per_group=1, group_stride, r_stride=0,
                n_g, g_stride=1, n_w=1, keep=1, copies=1):
    """Launch the row gather of ``csrc/probes.cu`` for g3 or g2's first
    route (segment ``s``: group ``s // seg_per_group``, place ``r``; its
    picked rows summed, stored ``copies`` times at ``(g · keep + r) · copies``
    when ``r < keep``), counted under ``name``."""
    device = idx.device
    require_cuda(device, "probe")
    _check_probe_table("table", table, device)
    _check("idx", idx, torch.int32, device)
    if weights is not None:
        _check("weights", weights, torch.float32, device)
        if weights.shape != idx.shape:
            raise ValueError(f"{name}: weights and indices differ in shape")
    _check("out", out, torch.float32, device)
    if out.shape != out_shape:
        raise ValueError(f"{name}: out of shape {tuple(out.shape)}, expected {out_shape}")
    _check_aligned(table=table, out=out)
    err = load("probes").st_row_gather(
        table.data_ptr(),
        idx.data_ptr(),
        None if weights is None else weights.data_ptr(),
        n_seg,
        seg_per_group,
        group_stride,
        r_stride,
        n_g,
        g_stride,
        n_w,
        keep,
        copies,
        out.data_ptr(),
        _stream(device),
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _segments_of(name, idx, seg_len):
    if idx.ndim != 1 or seg_len <= 0 or idx.shape[0] % seg_len:
        raise ValueError(f"{name}: indices of shape {tuple(idx.shape)} do not split into segments of {seg_len}")
    return idx.shape[0] // seg_len


class RowSumPlan(NamedTuple):
    warps_per_segment: int
    segments_per_cta: int
    ctas: int


# E4 (row_gather_sum_kernel): a warp for each 32 picks of a segment (one
# index line a round), at most ROW_SUM_WARPS (a CTA of 1,024 threads);
# short segments share a CTA of at most ROW_SUM_SHARED_WARPS warps
ROW_SUM_WARPS, ROW_SUM_SHARED_WARPS = 32, 8


def row_gather_sum_plan(seg_len, n_seg, sms):
    """E4's launch plan for ``n_seg`` segments of ``seg_len`` picks on a card
    of ``sms`` SMs: the warps of a segment, the segments of a CTA (more than
    one only when every SM still gets a CTA) and the CTAs. The sums' order,
    and so their bits, follow from ``seg_len`` and the plan."""
    if seg_len <= 0 or n_seg < 0 or sms <= 0:
        raise ValueError(f"row_gather_sum: {n_seg} segments of {seg_len} on {sms} SMs")
    wps = min(ROW_SUM_WARPS, -(-seg_len // 32))
    spc = max(1, min(ROW_SUM_SHARED_WARPS // wps, n_seg // sms))
    return RowSumPlan(wps, spc, -(-n_seg // spc))


def row_gather_sum(strip, idx, out, seg_len):
    """Launch E4 (``pallas_vmem.py:p2``): ``out[g] = Σ_{w < L}
    strip[idx[gL + w], :]``, ``L = seg_len``; ``strip`` float32 ``(rows,
    128)``, ``idx`` int32 ``(n_seg · L,)``, ``out`` float32 ``(n_seg, 128)``,
    on the plan :func:`row_gather_sum_plan` for this card. The caller
    guarantees every index in range."""
    n_seg = _segments_of("row_gather_sum", idx, seg_len)
    device = idx.device
    require_cuda(device, "probe")
    _check_probe_table("strip", strip, device)
    _check("idx", idx, torch.int32, device)
    _check("out", out, torch.float32, device)
    if out.shape != (n_seg, PROBE_LANES):
        raise ValueError(f"row_gather_sum: out of shape {tuple(out.shape)}, expected {(n_seg, PROBE_LANES)}")
    _check_aligned(strip=strip, out=out)
    if n_seg == 0:
        return out
    plan = row_gather_sum_plan(seg_len, n_seg, torch.cuda.get_device_properties(device).multi_processor_count)
    err = load("probes").st_row_gather_sum(
        strip.data_ptr(), idx.data_ptr(), n_seg, seg_len, plan.warps_per_segment, plan.segments_per_cta,
        out.data_ptr(), _stream(device)
    )
    _raise_on(err, "row_gather_sum")
    LAUNCHES["row_gather_sum"] += 1
    return out


# E5 (row_pick_bf16_kernel): chunks of PICK_TILE picks, stored out of a ring
# of PICK_STAGES tiles; the strip is held as bf16 (256 bytes a row) when it
# fits beside the ring (520 rows)
PICK_TILE, PICK_STAGES = 64, 3


def row_pick_bf16_resident(rows):
    """True when E5's strip of ``rows`` rows, rounded to bf16, fits in one
    CTA's shared memory beside the ring of output tiles."""
    return rows * PROBE_ROW_BYTES // 2 + PICK_STAGES * PICK_TILE * PROBE_ROW_BYTES <= SMEM_BLOCK_BYTES


class SlicePlan(NamedTuple):
    height: int  # rows of every slice but the last
    n_slices: int
    smem_bytes: int  # dynamic shared memory of a CTA


# E8 (row_pick_counts_kernel): per CTA a slice of the table and a row of
# counts per warp (COUNT_WARPS warps, one block each), padded to 4 counts
COUNT_WARPS = 16


def _count_smem(height):
    return height * PROBE_ROW_BYTES + COUNT_WARPS * -(-height // 4) * 16


def row_pick_count_plan(rows):
    """E8's slices of a table of ``rows`` rows: as few as fit one CTA's
    shared memory each beside the counts, of even height (slice ``s`` holds
    rows ``[s · height, min((s + 1) · height, rows))``)."""
    if rows <= 0:
        raise ValueError(f"row_pick_blocksum: a table of {rows} rows")
    max_rows = SMEM_BLOCK_BYTES // (PROBE_ROW_BYTES + COUNT_WARPS * 4)
    while _count_smem(max_rows) > SMEM_BLOCK_BYTES:
        max_rows -= 1
    n_slices = -(-rows // max_rows)
    height = -(-rows // n_slices)
    return SlicePlan(height, n_slices, _count_smem(height))


def count_units(n_slices, n_blocks, grid):
    """The (slice, block) pairs each CTA of E8's persistent grid of ``grid``
    CTAs takes, as the kernel deals them: units ``u = s · n_groups + g``
    (slice-major) of ``COUNT_WARPS`` blocks each, CTA ``i`` the units ``[i
    U / grid, (i + 1) U / grid)``."""
    n_groups = -(-n_blocks // COUNT_WARPS)
    n_units = n_slices * n_groups
    return [
        [
            (u // n_groups, b)
            for u in range(n_units * i // grid, n_units * (i + 1) // grid)
            for b in range(u % n_groups * COUNT_WARPS, min((u % n_groups + 1) * COUNT_WARPS, n_blocks))
        ]
        for i in range(grid)
    ]


def row_pick_bf16(strip, idx, out):
    """Launch E5 (``pallas_vmem.py:p3``): ``out[e] = f32(bf16(strip))[idx[e],
    :]``; ``strip`` float32 ``(rows, 128)``, ``idx`` int32 ``(n,)``, ``out``
    float32 ``(n, 128)``. The caller guarantees every index in range."""
    device = idx.device
    require_cuda(device, "probe")
    _check_probe_table("strip", strip, device)
    _check("idx", idx, torch.int32, device)
    _check("out", out, torch.float32, device)
    n = _segments_of("row_pick_bf16", idx, 1)
    if out.shape != (n, PROBE_LANES):
        raise ValueError(f"row_pick_bf16: out of shape {tuple(out.shape)}, expected {(n, PROBE_LANES)}")
    _check_aligned(strip=strip, out=out)
    if n == 0:
        return out
    resident = row_pick_bf16_resident(strip.shape[0])
    err = load("probes").st_row_pick_bf16(
        strip.data_ptr(), strip.shape[0], idx.data_ptr(), n, int(resident), out.data_ptr(), _stream(device)
    )
    _raise_on(err, "row_pick_bf16")
    LAUNCHES["row_pick_bf16"] += 1
    return out


def row_pick_blocksum(table, cols, out, rows_per_block, partial=None, tickets=None, route="counts"):
    """Launch E8 (``pallas_vmem2.py:g2``): ``out[8b + c] = Σ_{t < T}
    table[cols[bT + t], :]`` for ``c < 8``, ``T = rows_per_block``; ``out``
    float32 ``(n_blocks · 8, 128)``. The caller guarantees every index in
    range.

    ``route="counts"``: from table slices in shared memory, each block's
    picks counted and the counts multiplied with the slice
    (``row_pick_counts_kernel``), with scratch ``partial`` float32
    ``(n_blocks, n_slices, 128)`` and ``tickets`` int32 ``(n_blocks,)``, zero
    before the launch (each launch leaves it zero); both are made here when
    not given. ``route="rows"``: the first port, every pick a row read
    through L2 (E4's row gather, counted under ``row_gather_sum``), kept to
    measure the card's whole-row L2 rate beside the slices'."""
    n_blocks = _segments_of("row_pick_blocksum", cols, rows_per_block)
    out_shape = (n_blocks * 8, PROBE_LANES)
    if route == "rows":
        return _row_gather(
            "row_gather_sum", table, cols, None, out, out_shape, n_seg=n_blocks, group_stride=rows_per_block,
            n_g=rows_per_block, copies=8,
        )
    if route != "counts":
        raise ValueError(f"row_pick_blocksum: route {route!r}, expected 'counts' or 'rows'")
    device = cols.device
    require_cuda(device, "probe")
    _check_probe_table("table", table, device)
    _check("cols", cols, torch.int32, device)
    _check("out", out, torch.float32, device)
    if out.shape != out_shape:
        raise ValueError(f"row_pick_blocksum: out of shape {tuple(out.shape)}, expected {out_shape}")
    if n_blocks == 0:
        return out
    plan = row_pick_count_plan(table.shape[0])
    if partial is None:
        partial = torch.empty((n_blocks, plan.n_slices, PROBE_LANES), dtype=torch.float32, device=device)
    if tickets is None:
        tickets = zeroed_tickets(device, n_blocks)
    _check("partial", partial, torch.float32, device)
    _check("tickets", tickets, torch.int32, device)
    if partial.shape != (n_blocks, plan.n_slices, PROBE_LANES) or tickets.numel() < n_blocks:
        raise ValueError("row_pick_blocksum: partial or tickets do not match the blocks and the slices")
    _check_aligned(table=table, out=out, partial=partial)
    err = load("probes").st_row_pick_counts(
        table.data_ptr(),
        table.shape[0],
        cols.data_ptr(),
        rows_per_block,
        n_blocks,
        plan.height,
        plan.n_slices,
        out.data_ptr(),
        partial.data_ptr(),
        tickets.data_ptr(),
        _stream(device),
    )
    _raise_on(err, "row_pick_blocksum")
    LAUNCHES["row_pick_blocksum"] += 1
    return out


# pallas_vmem2.py:g3 folds each cell's (T, 128) accumulator as
# acc.reshape(64, 128, 128).sum(0)[:8], which fixes T
G3_FOLD, G3_ROWS, G3_KEEP = 64, 128, 8
G3_T = G3_FOLD * G3_ROWS


def pick_scale_wsum(table, cols2, data2, out):
    """Launch E9 (``pallas_vmem2.py:g3``): per cell ``i``, ``acc[t] =
    Σ_{w < W} data2[i, t, w] · table[cols2[i, t, w], :]`` for ``t < 8192``,
    then ``out[8i + r] = Σ_{g < 64} acc[128g + r]`` for ``r < 8``. ``cols2``
    int32 and ``data2`` float32 ``(n_cells, 8192, W)``, ``out`` float32
    ``(n_cells · 8, 128)``. The kernel computes only the 8 kept rows of each
    cell's fold (64 · W weighted picks each), over the 8 warps of a CTA."""
    if cols2.ndim != 3 or cols2.shape[1] != G3_T:
        raise ValueError(f"pick_scale_wsum: cols2 of shape {tuple(cols2.shape)}, expected (n_cells, {G3_T}, W)")
    n_cells, _, w = cols2.shape
    return _row_gather(
        "pick_scale_wsum",
        table,
        cols2,
        data2,
        out,
        (n_cells * G3_KEEP, PROBE_LANES),
        n_seg=n_cells * G3_KEEP,
        seg_per_group=G3_KEEP,
        group_stride=G3_T * w,
        r_stride=w,
        n_g=G3_FOLD,
        g_stride=G3_ROWS * w,
        n_w=w,
        keep=G3_KEEP,
    )


# the parts of E6's kernel that scalar_gather_sum_stage launches alone
SCALAR_GATHER_STAGES = {"launch": 1, "indices": 2}


def _scalar_gather_args(x, qi, qj, out, seg_len):
    device = qi.device
    require_cuda(device, "probe")
    _check("x", x, torch.float32, device)
    _check("qi", qi, torch.int32, device)
    _check("qj", qj, torch.int32, device)
    _check("out", out, torch.float32, device)
    n_seg = _segments_of("scalar_gather_sum", qi, seg_len)
    if x.ndim != 2 or qj.shape != qi.shape or out.shape != (n_seg, 1):
        raise ValueError("scalar_gather_sum: x must be 2-D, qi and qj of one shape, out (n_seg, 1)")
    return (x.data_ptr(), x.shape[1], qi.data_ptr(), qj.data_ptr(), n_seg, seg_len)


def scalar_gather_sum(x, qi, qj, out, seg_len):
    """Launch E6 (``pallas_vmem.py:p4``): ``out[g, 0] = Σ_{w < L} x[qi[gL +
    w], qj[gL + w]]``, ``L = seg_len``; ``x`` float32 ``(rows, cols)``,
    ``qi``/``qj`` int32 ``(n_seg · L,)``, ``out`` float32 ``(n_seg, 1)``. The
    caller guarantees every index in range. The sums run in a fixed order:
    the same bits on every launch."""
    args = _scalar_gather_args(x, qi, qj, out, seg_len)
    err = load("probes").st_scalar_gather_sum(*args, 0, out.data_ptr(), _stream(qi.device))
    _raise_on(err, "scalar_gather_sum")
    LAUNCHES["scalar_gather_sum"] += 1
    return out


def scalar_gather_sum_stage(x, qi, qj, out, seg_len, stage):
    """Launch E6's kernel cut to a part of it, to time that part:
    ``stage="launch"`` the grid alone (the kernel returns at once: the
    launch floor), ``"indices"`` the index loads and the sums without the
    table reads (``out`` then holds sums of ``qi + qj``). A timing probe,
    not E6: it counts no launch."""
    if stage not in SCALAR_GATHER_STAGES:
        raise ValueError(f"scalar_gather_sum_stage: stage {stage!r}, expected one of {tuple(SCALAR_GATHER_STAGES)}")
    args = _scalar_gather_args(x, qi, qj, out, seg_len)
    err = load("probes").st_scalar_gather_sum(*args, SCALAR_GATHER_STAGES[stage], out.data_ptr(), _stream(qi.device))
    _raise_on(err, "scalar_gather_sum_stage")
    return out


# K4, the SDDMM (csrc/sddmm.cu). Both routes take groups of at most 32
# entries a warp; a group shrinks (to a power of two, at least 1) until the
# groups fill SDDMM_WARPS_PER_SM warps on every SM, so a small nnz with a
# long K (the example's 1,000 entries of K = 10,000) still spreads over the
# card. The kept-row route (rows of at most SDDMM_KEPT_ROW_BYTES, a multiple
# of 16 bytes, both operands read by 16-byte loads) keeps each lhs row
# across its run of entries; the per-entry route takes the rest.
SDDMM_WARPS_PER_SM = 64
SDDMM_BLOCKS_PER_SM = 8  # CTAs of 8 warps; the grid strides past this
SDDMM_KEPT_ROW_BYTES = 2048  # 4 vectors of 16 bytes a lane
SDDMM_ROUTES = ("kept_row", "per_entry")
# bytes the card moves for one value of an MN-major operand: its own sector
SECTOR_BYTES = 32
_SDDMM_ITEM = {torch.float32: "f32", torch.float64: "f64"}
_SDDMM_INDEX = {torch.int32: "i32", torch.int64: "i64"}


def sddmm_entries_per_warp(nnz, sms):
    """Entries a warp of K4 takes: 32, or the largest power of two that
    leaves ``SDDMM_WARPS_PER_SM`` groups on each of ``sms`` SMs."""
    per = nnz // (sms * SDDMM_WARPS_PER_SM)
    epw = 1
    while epw * 2 <= min(per, 32):
        epw *= 2
    return epw


def sddmm_k_major(t):
    """True when the rows of the 2-D ``t`` (``(rows, K)``) have unit stride
    along K; a size-1 axis takes any stride."""
    return t.shape[1] <= 1 or t.stride(1) == 1


def sddmm_mn_major(t):
    """True when the 2-D ``t`` (``(rows, K)``) has unit stride along its rows."""
    return t.shape[0] <= 1 or t.stride(0) == 1


def sddmm_reads_in_place(shape, strides, itemsize, nnz):
    """Whether K4 reads an operand of ``shape`` ``(rows, K)`` and
    ``strides`` in place for ``nnz`` entries, rather than a K-major copy:
    always when it is K-major; when it is MN-major, if its strided reads
    (``SECTOR_BYTES`` for each of K values, for each entry) move no more
    bytes than the copy does (``2 · K · rows · itemsize``, read and write);
    never when neither axis has unit stride."""
    rows, k = shape
    if k <= 1 or strides[1] == 1:
        return True
    if rows <= 1 or strides[0] == 1:
        return SECTOR_BYTES * nnz <= 2 * rows * itemsize
    return False


def sddmm_vec(t):
    """True when K4 reads the operand ``t`` by 16-byte loads: K-major with
    16-byte aligned rows."""
    item = t.element_size()
    return sddmm_k_major(t) and t.data_ptr() % 16 == 0 and (t.shape[0] <= 1 or t.stride(0) * item % 16 == 0)


def sddmm_route(k, itemsize, vec=True):
    """K4's route for rows of ``k`` values of ``itemsize`` bytes, ``vec``
    when both operands take 16-byte loads (:func:`sddmm_vec`)."""
    row = k * itemsize
    return "kept_row" if vec and row <= SDDMM_KEPT_ROW_BYTES and row % 16 == 0 else "per_entry"


def _sddmm_vectors(k, itemsize, route):
    """The kept-row kernel's 16-byte vectors a lane (1, 2 or 4), 0 for the per-entry kernel."""
    if route == "per_entry":
        return 0
    n = -(-(k * itemsize // 16) // 32)
    return 1 if n <= 1 else 2 if n == 2 else 4


def sddmm(rows, cols, s, lhs_rows, rhs_rows, out, route=None):
    """Launch K4: ``out[e] = s[e] · Σ_k lhs_rows[rows[e], k] · rhs_rows[cols[e], k]``.
    ``lhs_rows`` ``(M, K)`` and ``rhs_rows`` ``(N, K)`` (that is, ``rhs.T``)
    of float32 or float64, each read in place with unit stride along K or
    along its rows (a strided value per k); ``rows``/``cols`` int32 or int64
    and ``s``/``out`` of the value dtype, contiguous ``(nnz,)``. ``route``
    (:data:`SDDMM_ROUTES`) defaults to :func:`sddmm_route`; both give the
    same bits. The caller guarantees every index in range."""
    dtype, device = lhs_rows.dtype, lhs_rows.device
    require_cuda(device, "SDDMM")
    if dtype not in _SDDMM_ITEM:
        raise TypeError(f"the SDDMM kernel takes float32 or float64, not {dtype}")
    if rows.dtype not in _SDDMM_INDEX:
        raise TypeError(f"the SDDMM kernel takes int32 or int64 indices, not {rows.dtype}")
    _check("rows", rows, rows.dtype, device)
    _check("cols", cols, rows.dtype, device)
    _check("s", s, dtype, device)
    _check("out", out, dtype, device)
    _check_device(rhs_rows, dtype, device, "rhs_rows")
    nnz = rows.shape[0]
    if lhs_rows.ndim != 2 or rhs_rows.ndim != 2 or lhs_rows.shape[1] != rhs_rows.shape[1]:
        raise ValueError("sddmm: lhs_rows and rhs_rows must be (M, K) and (N, K)")
    if rows.ndim != 1 or cols.shape != (nnz,) or s.shape != (nnz,) or out.shape != (nnz,):
        raise ValueError("sddmm: rows, cols, s and out must be 1-D of one length")
    for name, t in (("lhs_rows", lhs_rows), ("rhs_rows", rhs_rows)):
        if not (sddmm_k_major(t) or sddmm_mn_major(t)):
            raise ValueError(f"sddmm: {name} has unit stride on neither axis")
    if max(lhs_rows.shape[0], rhs_rows.shape[0]) >= 2**31:
        raise ValueError("sddmm: the kernel takes fewer than 2^31 rows of lhs_rows and rhs_rows")
    k, item = lhs_rows.shape[1], lhs_rows.element_size()
    vec = sddmm_vec(lhs_rows) and sddmm_vec(rhs_rows)
    route = sddmm_route(k, item, vec) if route is None else route
    if route not in SDDMM_ROUTES or (route == "kept_row" and sddmm_route(k, item, vec) != "kept_row"):
        raise ValueError(
            f"sddmm: route {route!r} for K = {k}; the routes are {SDDMM_ROUTES}, kept_row for 16-byte loads "
            f"of rows of at most {SDDMM_KEPT_ROW_BYTES} bytes"
        )
    if nnz == 0:
        return out
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fn = getattr(load("sddmm"), f"st_sddmm_{_SDDMM_ITEM[dtype]}_{_SDDMM_INDEX[rows.dtype]}")
    err = fn(
        rows.data_ptr(),
        cols.data_ptr(),
        s.data_ptr(),
        lhs_rows.data_ptr(),
        lhs_rows.stride(0),
        lhs_rows.stride(1),
        rhs_rows.data_ptr(),
        rhs_rows.stride(0),
        rhs_rows.stride(1),
        nnz,
        k,
        sddmm_entries_per_warp(nnz, sms),
        int(vec),
        _sddmm_vectors(k, item, route),
        sms * SDDMM_BLOCKS_PER_SM,
        out.data_ptr(),
        _stream(device),
    )
    _raise_on(err, "sddmm")
    LAUNCHES["sddmm"] += 1
    return out


def row_sum_chunks(k, dtype):
    """The column chunks of K5 (csrc/mttkrp.cu ``RowSum``): a lane owns 16 bytes of a row."""
    return -(-k // (32 * (16 // dtype.itemsize)))


def sampled_row_sum(ptr, pieces, idx, w, table, out, partial, tickets, piece=None):
    """Launch K5: ``out[i] = Σ w[e] · table[idx[e]]`` over the entries
    ``ptr[i] <= e < ptr[i + 1]`` of segment ``i``, summed in that order from
    0. ``idx`` int32 and ``w`` of the value dtype (float32 or float64), flat,
    of one length; ``table`` ``(rows, K)`` with unit stride along K and any
    row stride; ``out`` ``(n_seg, K)``. Segments longer than ``piece``
    entries (:data:`MTTKRP_PIECE`) are split: ``pieces`` is
    ``run_pieces(ptr, piece)``, scratch ``partial`` of the value dtype holds
    at least ``front_bound(n, n_seg, piece) · K`` values and ``tickets``
    (:func:`zeroed_tickets`) as many as ``front_bound · row_sum_chunks``.
    The caller guarantees every index in range."""
    piece = MTTKRP_PIECE if piece is None else int(piece)
    dtype, device = w.dtype, w.device
    require_cuda(device, "sampled row sum")
    if dtype not in _SDDMM_ITEM:
        raise TypeError(f"the sampled row sum kernel takes float32 or float64, not {dtype}")
    _check("ptr", ptr, torch.int64, device)
    _check("pieces", pieces, torch.int64, device)
    _check("idx", idx, torch.int32, device)
    _check("w", w, dtype, device)
    _check_device(table, dtype, device, "table")
    _check("out", out, dtype, device)
    _check("partial", partial, dtype, device)
    _check("tickets", tickets, torch.int32, device)
    n_seg, k = out.shape
    n = w.shape[0]
    n_front = front_bound(n, n_seg, piece)
    if (
        idx.shape != (n,)
        or ptr.ndim != 1
        or ptr.shape[0] < n_seg + 1
        or pieces.shape[0] < n_seg + 1
        or table.ndim != 2
        or table.shape[1] != k
        or partial.numel() < n_front * k
        or tickets.numel() < n_front * row_sum_chunks(k, dtype)
    ):
        raise ValueError("sampled_row_sum: operand shapes do not match")
    if not sddmm_k_major(table):
        raise ValueError("sampled_row_sum: table must have unit stride along K")
    if n_seg == 0 or k == 0:
        return out
    item = table.element_size()
    ld = table.stride(0)
    vec = table.data_ptr() % 16 == 0 and (table.shape[0] <= 1 or ld * item % 16 == 0) and k % (16 // item) == 0
    fn = getattr(load("mttkrp"), f"st_row_sum_{_SDDMM_ITEM[dtype]}")
    err = fn(
        ptr.data_ptr(),
        pieces.data_ptr(),
        n_seg,
        n_front,
        piece,
        idx.data_ptr(),
        w.data_ptr(),
        table.data_ptr(),
        ld,
        int(vec),
        k,
        out.data_ptr(),
        partial.data_ptr(),
        tickets.data_ptr(),
        _stream(device),
    )
    _raise_on(err, "sampled_row_sum")
    LAUNCHES["sampled_row_sum"] += 1
    return out
