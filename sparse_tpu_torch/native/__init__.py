"""The host C++ runtime of the port: CPU tensors' canonicalization, joins,
products and SpGEMM, loaded with ``ctypes``.

``csrc/canonical.cpp``, ``csrc/eager.cpp`` and ``csrc/pool.h`` are the
port's own copies of ``sparse_tpu``'s host kernels (the same algorithms and
summation orders; C symbols prefixed ``stt_``). At the first call, never at
import, they are compiled by one fixed command,
``g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off``, into one
library under ``build/sparse_tpu_torch/`` at the repository root, named by a
hash of the sources, the flags and ``g++ --version``. Without
``-march=native`` and with contraction off, each product and each sum
rounds on its own, so the bits are the same on every x86-64 host. A missing
or failing ``g++`` raises ``RuntimeError``; nothing falls back.

The functions here and in :mod:`.eager` take CPU tensors (NumPy arrays are
taken as host tensors) and raise ``ValueError`` for a tensor on any other
device. Each counts its calls in ``CALLS`` (zeroed by :func:`reset_calls`
and by ``kernels._cuda.reset_launch_counts``), so a test can prove which
route ran. Callers choose the route before the call (:func:`host_route`):
only CPU float32/float64 data at ``NATIVE_MIN_SIZE`` entries or more
(canonicalization and sorts) or ``eager.NATIVE_MIN_NNZ`` (joins and
SpGEMM), the conditions of ``sparse_tpu``'s call sites.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

# below this size torch's sort beats the library's thread fan-out
NATIVE_MIN_SIZE = 1 << 16
HOST_DTYPES = (torch.float32, torch.float64)

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "canonical.cpp", _CSRC / "eager.cpp")
HEADERS = (_CSRC / "pool.h",)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparse_tpu_torch"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]

# calls of each binding since the last reset_calls
CALLS = defaultdict(int)
# set by the build: {"seconds", "path", "gxx_version"}
BUILD_INFO = {}

_lock = threading.Lock()
_lib = None


def reset_calls():
    """Every binding's call count to 0."""
    CALLS.clear()


def host_route(device, dtype, n=0, min_n=0):
    """Whether a call takes the library: a CPU tensor of float32/float64 at
    ``n >= min_n`` entries. CUDA tensors keep their kernels, other dtypes
    their torch ops."""
    return device.type == "cpu" and dtype in HOST_DTYPES and n >= min_n


def _gxx():
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found: sparse_tpu_torch's host library is compiled from "
            f"{', '.join(p.name for p in SOURCES)} at its first CPU call and needs g++ on PATH"
        )
    return path


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    return res.stdout


def _build(gxx, out):
    """Compile into a temporary name and move it into place, one process at
    a time (a lock file beside it); a process that waited finds it built."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        _run([gxx, *GXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)])
        os.replace(tmp, out)
        BUILD_INFO["seconds"] = time.perf_counter() - t0


_P, _I, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _signatures():
    """``{name: (restype, argtypes)}`` of every C entry point used."""
    sig = {
        "stt_argsort_i64": (_INT, [_P, _I, _P]),
        "stt_dedup_sum_sorted_f64": (_I, [_P, _P, _I, _P, _P]),
        "stt_build_indptr": (_INT, [_P, _I, _I, _P]),
        "stt_union_join_i64": (_I, [_P, _I, _P, _I, _P, _P, _P]),
        "stt_unravel_i64": (_INT, [_P, _I, _P, _I, _P]),
        "stt_spgemm_symbolic": (_INT, [_P, _P, _I, _P, _P, _I, _P]),
        "stt_spgemm_ubcount": (_INT, [_P, _P, _I, _P, _P]),
        "stt_uncompress_indptr": (_INT, [_P, _I, _P]),
        "stt_csr_row_splice_bytes": (_I, [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P]),
    }
    for ts, scalar in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
        sig[f"stt_union_join_vals_{ts}"] = (_I, [_P, _P, _I, scalar, _P, _P, _I, scalar, _P, _P, _P])
        for op in ("add", "sub", "mul"):
            sig[f"stt_{op}_join_{ts}"] = (_I, [_P, _P, _I, _P, _P, _I, _P, _P])
        sig[f"stt_bincount_sum_{ts}"] = (_INT, [_P, _P, _I, _I, _P, _P])
        sig[f"stt_row_reduce_sorted_{ts}"] = (_I, [_P, _P, _I, _P, _P, _P])
        sig[f"stt_spgemm_numeric_{ts}"] = (_INT, [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P])
        sig[f"stt_spgemm_onephase_{ts}"] = (_INT, [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P])
        for ks in ("", "_i32"):
            sig[f"stt_bincount_sum_compact_{ts}{ks}"] = (_I, [_P, _P, _I, _I, _P, _P, _P])
            sig[f"stt_sorted_reduce_compact_{ts}{ks}"] = (_I, [_P, _P, _I, _P, _P])
        for isuf in ("i64", "i32"):
            sig[f"stt_canonicalize2d_{ts}_{isuf}"] = (_I, [_P, _P, _P, _I, _I, _P, _P, _P])
            sig[f"stt_csr_spmv_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _P, _P])
            sig[f"stt_csr_spmm_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _P, _I, _P])
            sig[f"stt_csc_spmv_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _I, _P, _P])
            sig[f"stt_csc_spmm_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _I, _P, _I, _P])
            sig[f"stt_csc_spmv_acc_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _P, _P])
            sig[f"stt_coo_spmv_acc_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _P, _P])
            sig[f"stt_coo_spmv_add_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _I, _P, _P, _P])
            sig[f"stt_csr_spmv_add_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _P, _P, _P])
            sig[f"stt_csc_spmv_add_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _I, _P, _P, _P])
            sig[f"stt_transpose2d_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _I, _P, _P, _P, _P])
            sig[f"stt_dense_spmm_csrt_{ts}_{isuf}"] = (_INT, [_P, _P, _P, _I, _P, _I, _I, _P])
    for ts in ("f64", "f32", "s64"):
        for op in ("add", "sub", "mul"):
            for isuf in ("i32", "i64"):
                sig[f"stt_{op}_join2d_{ts}_{isuf}"] = (_I, [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P])
    terms = [_INT, _P, _P, _P, _P]
    for isuf in ("i64", "i32"):
        sig[f"stt_transpose2d_bytes_{isuf}"] = (_INT, [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P])
        sig[f"stt_relinearize_{isuf}"] = (_INT, [_P, _I, *terms, *terms, *terms, _P, _P, _P])
    return sig


def library():
    """The loaded host library, built first if needed (``RuntimeError`` when
    ``g++`` is missing or fails)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            gxx = _gxx()
            version = _run([gxx, "--version"])
            digest = hashlib.sha256()
            for path in (*SOURCES, *HEADERS):
                digest.update(path.read_bytes())
            digest.update(" ".join(GXX_FLAGS).encode())
            digest.update(version.encode())
            so = _BUILD_DIR / f"host_{digest.hexdigest()[:16]}.so"
            if not so.exists():
                _build(gxx, so)
            lib = ctypes.CDLL(str(so))
            for name, (restype, argtypes) in _signatures().items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            BUILD_INFO.update(path=str(so), gxx_version=version.splitlines()[0])
            _lib = lib
    return _lib


def call(name, *args):
    """Call the library's C entry point ``name`` (the caller counts it)."""
    return getattr(library(), name)(*args)


# ---------------------------------------------------------------------------
# tensors in and out
# ---------------------------------------------------------------------------


def host(t, name="tensor"):
    """``t`` as a contiguous CPU tensor (NumPy input as a host tensor); a
    tensor on another device raises ``ValueError``."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.ascontiguousarray(t))
    if t.device.type != "cpu":
        raise ValueError(f"{name} is on {t.device}: the host library takes CPU tensors")
    return t.contiguous()


def host_i64(t, name="tensor"):
    """``t`` as a contiguous int64 CPU tensor (narrow index dtypes widened)."""
    return host(t, name).to(torch.int64)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def check_values(t, name="values"):
    """The ``"f64"``/``"f32"`` suffix of a float64/float32 tensor, else ``TypeError``."""
    if t.dtype == torch.float64:
        return "f64"
    if t.dtype == torch.float32:
        return "f32"
    raise TypeError(f"{name} has dtype {t.dtype}: the host library takes float32 or float64")


# ---------------------------------------------------------------------------
# canonical.cpp
# ---------------------------------------------------------------------------


def argsort_i64(keys, max_key=None):
    """Stable argsort of non-negative int64 keys: the packed ``(key, index)``
    sort (torch) when ``max_key`` and the index fit 63 bits together, else
    the library's parallel radix sort; torch's stable sort below
    ``NATIVE_MIN_SIZE`` keys."""
    return sort_with_perm(keys, max_key)[0]


def sort_with_perm(keys, max_key=None):
    """``(perm, sorted_keys)`` of :func:`argsort_i64`; ``sorted_keys`` comes
    free from the packed sort and is ``None`` otherwise."""
    keys = host_i64(keys, "keys")
    n = keys.shape[0]
    if n < NATIVE_MIN_SIZE:
        return torch.sort(keys, stable=True)[1], None
    if max_key is None:
        max_key = int(keys.max()) if n else 0
    idx_bits = max(int(n - 1).bit_length(), 1)
    if int(max_key).bit_length() + idx_bits <= 63:
        packed = torch.sort((keys << idx_bits) | torch.arange(n, dtype=torch.int64)).values
        return packed & ((1 << idx_bits) - 1), packed >> idx_bits
    perm = torch.empty(n, dtype=torch.int64)
    CALLS["argsort_i64"] += 1
    call("stt_argsort_i64", ptr(keys), n, ptr(perm))
    return perm, None


def dedup_sum_sorted(sorted_keys, vals):
    """Sum ``vals`` (float64) over runs of equal sorted keys, each run from
    its first value in entry order: ``(unique_positions, sums)``."""
    sorted_keys = host_i64(sorted_keys, "sorted_keys")
    vals = host(vals, "vals")
    if vals.dtype != torch.float64:
        raise TypeError(f"dedup_sum_sorted takes float64 values, not {vals.dtype}")
    n = sorted_keys.shape[0]
    vals_out = torch.empty(n, dtype=torch.float64)
    unique_pos = torch.empty(n, dtype=torch.int64)
    CALLS["dedup_sum_sorted"] += 1
    u = call("stt_dedup_sum_sorted_f64", ptr(sorted_keys), ptr(vals), n, ptr(vals_out), ptr(unique_pos))
    return unique_pos[:u].clone(), vals_out[:u].clone()


def build_indptr(sorted_rows, n_rows):
    """int64 ``indptr`` (length ``n_rows + 1``) of sorted row ids: the
    library's count and prefix sum from ``NATIVE_MIN_SIZE`` ids on, torch's
    ``bincount``/``cumsum`` below."""
    sorted_rows = host_i64(sorted_rows, "sorted_rows")
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64)
    if sorted_rows.shape[0] < NATIVE_MIN_SIZE:
        torch.cumsum(torch.bincount(sorted_rows, minlength=n_rows), 0, out=indptr[1:])
        return indptr
    CALLS["build_indptr"] += 1
    call("stt_build_indptr", ptr(sorted_rows), sorted_rows.shape[0], n_rows, ptr(indptr))
    return indptr
