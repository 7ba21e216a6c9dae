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
synchronize. The row-ELL and MTTKRP launchers take contiguous tensors; the
BSR launchers read their operands through their strides. ``LAUNCHES`` counts
the launches of each kernel; nothing else touches it.
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

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"row_ell": _CSRC / "row_ell.cu", "bsr": _CSRC / "bsr.cu", "mttkrp": _CSRC / "mttkrp.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparse_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_p, _i64 = ctypes.c_void_p, ctypes.c_int64
# argtypes of each C entry point, by source; every one returns a CUDA error code
_SIGNATURES = {
    "row_ell": {
        **{f"st_row_ell_spmv_{dt}": [_p, _p, _p, _p, _p, _p, _i64, _p, _i64, _p] for dt in ("f32", "f64")},
        **{f"st_row_ell_spmm_{dt}": [_p, _p, _p, _i64, _p, _i64, _p, _i64, _p, _i64, _i64, _p] for dt in ("f32", "f64")},
    },
    "bsr": {
        **{
            f"st_bsr_spmm_{dt}": [_p, _i64, _i64, _i64, _p, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64, _i64, _p, _i64, _i64, _p]
            for dt in ("f32", "f64", "bf16")
        },
        **{
            f"st_bsr_sddmm_{dt}": [_p, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64, _i64, _p, _i64, _i64, _i64, _p, _p]
            for dt in ("f32", "f64", "bf16")
        },
    },
    "mttkrp": {
        f"st_mttkrp_{dt}": [_p, _p, _i64, _p, _p, _p, _p, _p, _i64, _p, _p]
        for dt in ("f32", "f64", "bf16_f32", "bf16_f64")
    },
}

LAUNCHES = {
    "row_ell_spmv": 0,
    "row_ell_spmm": 0,
    "bsr_spmm": 0,
    "bsr_spmm2": 0,
    "bsr_sddmm": 0,
    "ell_mttkrp": 0,
    "coo_mttkrp": 0,
}

# per source, set by its build: {"seconds": wall time of nvcc, "ptxas": its
# -Xptxas -v report, "path": the library}; only "path" when already built
BUILD_INFO = {}

_locks = {name: threading.Lock() for name in SOURCES}
_libs = {}


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


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def spmv(re, x, y, out):
    """Launch K1: ``out = A @ x (+ y)`` on the layout ``re``; ``re.flat_data``,
    ``x``, ``y`` and ``out`` share one float dtype."""
    dtype, device = x.dtype, x.device
    _check_layout(re, dtype, device)
    _check("x", x, dtype, device)
    _check("out", out, dtype, device)
    if y is not None:
        _check("y", y, dtype, device)
    if x.shape != (re.n_cols,) or out.shape != (re.n_rows,) or (y is not None and y.shape != out.shape):
        raise ValueError("row_ell_spmv: operand shapes do not match the layout")
    n_pos = re.row_of_pos.shape[0]
    if n_pos == 0:
        return out
    fn = getattr(load("row_ell"), f"st_row_ell_spmv_{_SUFFIX[dtype]}")
    err = fn(
        re.flat_cols.data_ptr(),
        re.flat_data.data_ptr(),
        x.data_ptr(),
        None if y is None else y.data_ptr(),
        out.data_ptr(),
        re.tier_table.data_ptr(),
        re.tier_table.shape[0],
        re.row_of_pos.data_ptr(),
        n_pos,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, "row_ell_spmv")
    LAUNCHES["row_ell_spmv"] += 1
    return out


def spmm(re, dense, out):
    """Launch K2: ``out = A @ dense`` on the layout ``re``; ``re.flat_data``,
    ``dense`` and ``out`` share one float dtype."""
    dtype, device = dense.dtype, dense.device
    _check_layout(re, dtype, device)
    _check("dense", dense, dtype, device)
    _check("out", out, dtype, device)
    n = dense.shape[1]
    if dense.shape[0] != re.n_cols or out.shape != (re.n_rows, n):
        raise ValueError("row_ell_spmm: operand shapes do not match the layout")
    n_pos = re.row_of_pos.shape[0]
    if n_pos == 0 or n == 0:
        return out
    wide = _WIDE[dtype]
    vec = wide if n % wide == 0 and dense.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    if -(-n // (32 * vec)) > 65535:
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
    """Launch the BSR SpMM (P2 with ``pairs=1``, its two-block form P3 with
    ``pairs=2``): ``out = A @ dense`` with ``A``'s block-row ``r`` the run
    ``row_ptr[r]:row_ptr[r+1]`` of ``blocks`` (any strides) and
    ``block_cols`` (int32), ``dense`` of any strides, ``out`` contiguous
    ``(n_rows, N)``. With ``pairs=2`` every run must have even length; the
    caller checks."""
    dtype, device = dense.dtype, dense.device
    check_bsr_dtype(dtype)
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


def bsr_sddmm(block_rows, block_cols, lhs, rhs, out):
    """Launch the block-sampled SDDMM (P4): ``out[j] = lhs[rows[j]-block, :]
    @ rhs[:, cols[j]-block]`` for every stored block, ``lhs`` ``(M, B)`` and
    ``rhs`` ``(B, K)`` of any strides, ``out`` contiguous ``(n_blocks, bm, bn)``."""
    dtype, device = lhs.dtype, lhs.device
    check_bsr_dtype(dtype)
    require_cuda(device, "BSR")
    _check_device(lhs, dtype, device, "lhs")
    _check_device(rhs, dtype, device, "rhs")
    _check("block_rows", block_rows, torch.int32, device)
    _check("block_cols", block_cols, torch.int32, device)
    _check("out", out, dtype, device)
    n_blocks, bm, bn = out.shape
    m, b = lhs.shape
    if rhs.shape[0] != b or block_rows.shape != (n_blocks,) or block_cols.shape != (n_blocks,):
        raise ValueError("bsr_sddmm: operand shapes do not match the layout")
    if out.numel() == 0:
        return out
    fn = getattr(load("bsr"), f"st_bsr_sddmm_{_SUFFIX[dtype]}")
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


# (table dtype, value dtype) -> entry point suffix of csrc/mttkrp.cu
_MTTKRP_SUFFIX = {
    (torch.float32, torch.float32): "f32",
    (torch.float64, torch.float64): "f64",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.bfloat16, torch.float64): "bf16_f64",
}


def mttkrp(row_ptr, order, cj, ck, v, c, d, out):
    """Launch the MTTKRP kernel: ``out[i] = Σ v[s] · c[cj[s]] · d[ck[s]]``
    over the slots ``s`` of row ``i``'s run ``row_ptr[i]:row_ptr[i + 1]``,
    read through ``order`` (int32, the block-ELL form, counted as
    ``ell_mttkrp``) or in place (``order=None``, the sorted-COO form,
    ``coo_mttkrp``). ``cj``/``ck`` int32 and ``v`` flat and of one length,
    ``c``/``d`` ``(J, r)``/``(K, r)`` of the table dtype, ``out`` ``(n_rows,
    r)`` of ``v``'s dtype; all contiguous. The caller guarantees every index
    in range."""
    name = "coo_mttkrp" if order is None else "ell_mttkrp"
    dtype, device = v.dtype, v.device
    require_cuda(device, "MTTKRP")
    suffix = _MTTKRP_SUFFIX.get((c.dtype, dtype))
    if suffix is None:
        raise TypeError(f"the MTTKRP kernel takes tables of {dtype} or bfloat16 with {dtype} values, not {c.dtype}")
    _check("row_ptr", row_ptr, torch.int64, device)
    if order is not None:
        _check("order", order, torch.int32, device)
    _check("cj", cj, torch.int32, device)
    _check("ck", ck, torch.int32, device)
    _check("v", v, dtype, device)
    _check("c", c, c.dtype, device)
    _check("d", d, c.dtype, device)
    _check("out", out, dtype, device)
    n_rows, r = out.shape
    n_slots = v.shape[0]
    if (
        cj.shape != (n_slots,)
        or ck.shape != (n_slots,)
        or (order is not None and order.shape != (n_slots,))
        or row_ptr.ndim != 1
        or row_ptr.shape[0] < n_rows + 1
        or c.ndim != 2
        or d.ndim != 2
        or c.shape[1] != r
        or d.shape[1] != r
    ):
        raise ValueError("mttkrp: operand shapes do not match")
    if n_rows == 0 or r == 0:
        return out
    if -(-r // 32) > 65535:
        raise ValueError(f"mttkrp: r = {r} needs more than 65535 column chunks")
    fn = getattr(load("mttkrp"), f"st_mttkrp_{suffix}")
    err = fn(
        row_ptr.data_ptr(),
        None if order is None else order.data_ptr(),
        n_rows,
        cj.data_ptr(),
        ck.data_ptr(),
        v.data_ptr(),
        c.data_ptr(),
        d.data_ptr(),
        r,
        out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
