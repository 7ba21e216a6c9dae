"""Build, load and launch the hand-written CUDA kernels of the port.

The sources under ``csrc/`` are compiled on first use with ``nvcc`` for
``sm_90a`` into ``build/sparse_tpu_torch/`` at the repository root, one
shared library per source keyed by a hash of its text, and loaded with
``ctypes`` (plain C interface: no PyTorch headers, so a build takes seconds).
A missing compiler, a failed build or a failed load raises; so does a launch
that CUDA refuses (each C entry point returns ``cudaGetLastError()``).

The launchers take tensors already on the GPU, of the kernel's dtype and
contiguous, check that, allocate nothing themselves, launch on the current
stream and do not synchronize. ``LAUNCHES`` counts the launches of each
kernel; nothing else touches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "row_ell.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparse_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"row_ell_spmv": 0, "row_ell_spmm": 0}

# set by the build: {"seconds": wall time of nvcc, "ptxas": its -Xptxas -v report, "path": the library}
BUILD_INFO = {}

_lock = threading.Lock()
_lib = None


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
            f"{_SRC.name} on first use and need the CUDA toolkit"
        )
    return path


def _build(out):
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=seconds, ptxas=res.stderr + res.stdout, path=str(out))


def load():
    """The loaded kernel library, built from source first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            key = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
            so = _BUILD_DIR / f"row_ell_{key}.so"
            if not so.exists():
                _build(so)
            else:
                BUILD_INFO.setdefault("path", str(so))
            lib = ctypes.CDLL(str(so))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for dt in ("f32", "f64"):
                spmv = getattr(lib, f"st_row_ell_spmv_{dt}")
                spmv.argtypes = [p, p, p, p, p, p, i64, p, i64, p]
                spmv.restype = ctypes.c_int
                spmm = getattr(lib, f"st_row_ell_spmm_{dt}")
                spmm.argtypes = [p, p, p, i64, p, i64, p, i64, p, i64, i64, p]
                spmm.restype = ctypes.c_int
            _lib = lib
    return _lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# values per lane in the SpMM's 16-byte loads
_WIDE = {torch.float32: 4, torch.float64: 2}


def _check(name, t, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layout(re, dtype, device):
    if dtype not in _SUFFIX:
        raise TypeError(f"the row-ELL kernels take float32 or float64, not {dtype}")
    if device.type != "cuda":
        raise ValueError(f"the row-ELL kernels run on a CUDA device, not {device}")
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
    fn = getattr(load(), f"st_row_ell_spmv_{_SUFFIX[dtype]}")
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
    fn = getattr(load(), f"st_row_ell_spmm_{_SUFFIX[dtype]}")
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
