"""sparse_tpu_torch stands alone: it loads neither jax nor sparse_tpu nor the
repository's Pallas experiments, places data on the GPU unless told
otherwise, and never lets a tensor that is not on the CPU reach a kernel's
plain version."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import _cuda, row_ell

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "sparse_tpu_torch"


_EXPERIMENTS = ("pallas_spmv_onehot", "pallas_vmem", "pallas_vmem2")


def test_import_loads_no_jax_and_no_sparse_tpu():
    modules = [
        "sparse_tpu_torch",
        "sparse_tpu_torch.parallel",
        "sparse_tpu_torch.checkpoint",
        "sparse_tpu_torch.profiling",
        "sparse_tpu_torch.entry",
        "sparse_tpu_torch.native",
        "sparse_tpu_torch.native.eager",
    ]
    imports = ", ".join([*modules, *(f"sparse_tpu_torch.experiments.{m}" for m in _EXPERIMENTS)])
    code = f"import json, sys, {imports}; print(json.dumps(sorted(sys.modules)))"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in mods if m.split(".")[0] in ("jax", "sparse_tpu", "experiments")]
    assert bad == []
    assert all(m in mods for m in modules)
    assert all(f"sparse_tpu_torch.experiments.{m}" in mods for m in _EXPERIMENTS)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|sparse_tpu|experiments)\b", re.M)


# the package and the scripts that run it on the card
@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO).as_posix() for p in (*PKG.rglob("*.py"), *REPO.glob("chip_*.py")))
)
def test_source_imports_no_jax_and_no_sparse_tpu(path):
    assert not _FORBIDDEN.findall((REPO / path).read_text())


def test_forbidden_import_pattern():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from sparse_tpu.kernels import x")
    assert _FORBIDDEN.search("    from jax import lax")
    assert not _FORBIDDEN.search("from sparse_tpu_torch import COO")
    assert not _FORBIDDEN.search("import sparse_tpu_torch")
    assert _FORBIDDEN.search("import experiments.pallas_vmem")
    assert _FORBIDDEN.search("from experiments.pallas_spmv_onehot import products_kernel")
    assert not _FORBIDDEN.search("from sparse_tpu_torch.experiments import pallas_vmem")
    assert not _FORBIDDEN.search("from .pallas_vmem import lane_gather")


# a path into the reference package: "sparse_tpu" as a path component, or a
# path under sparse_tpu/ (not sparse_tpu_torch/), or its libraries
_REF_PATH = re.compile(r"^sparse_tpu$|(?<![\w])sparse_tpu/|_eager\.so\b|_canonical\.so\b")
# in any text of the source: the reference's native directory or libraries
_REF_NATIVE = re.compile(r"(?<![\w])sparse_tpu/native|_eager\.so\b|_canonical\.so\b")
_C_STRING = re.compile(r'"(?:[^"\\\n]|\\.)*"')


def _code_strings(path):
    """The string literals of a source file that are not docstrings (Python)
    or comments (C/C++/CUDA)."""
    text = path.read_text()
    if path.suffix == ".py":
        tree = ast.parse(text)
        docs = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
                first = node.body[0]
                if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                    docs.add(id(first.value))
        strings = (n for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str))
        return [n.value for n in strings if id(n) not in docs]
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    return [m[1:-1] for m in _C_STRING.findall(code)]


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*") if p.suffix in (".py", ".cpp", ".h", ".cu"))
)
def test_source_names_no_path_into_sparse_tpu(path):
    # the port builds and loads only its own files: no path into the
    # reference package, no library built there
    assert not _REF_NATIVE.search((REPO / path).read_text())
    assert not [s for s in _code_strings(REPO / path) if _REF_PATH.search(s)]


def test_reference_path_pattern():
    for bad in ("sparse_tpu", "sparse_tpu/native/eager.cpp", "../sparse_tpu/x.so", "a/_eager.so", "_canonical.so"):
        assert _REF_PATH.search(bad)
    for good in ("sparse_tpu_torch", "sparse_tpu_torch/native/csrc", "build/sparse_tpu_torch", "sparse_tpu.kernels"):
        assert not _REF_PATH.search(good)
    assert _REF_NATIVE.search("lib = 'sparse_tpu/native/_eager.so'") and _REF_NATIVE.search("x/_canonical.so")
    assert not _REF_NATIVE.search("native_eager.sorted_reduce_compact(keys)")
    assert _code_strings(PKG / "native" / "__init__.py")  # the scan reads code strings


def test_host_sources_ship_with_the_package():
    from sparse_tpu_torch import native

    assert native.SOURCES == (PKG / "native" / "csrc" / "canonical.cpp", PKG / "native" / "csrc" / "eager.cpp")
    assert native.HEADERS == (PKG / "native" / "csrc" / "pool.h",)
    text = ""
    for path in (*native.SOURCES, *native.HEADERS):
        assert path.exists()
        text += path.read_text()
    # the port's own symbols and pool, no environment read
    assert not re.search(r"\bst_[a-z]", text) and "stpool" not in text.replace("sttpool", "")
    assert "getenv" not in text and '#include "pool.h"' in text
    for fn in native._signatures():
        base = re.sub(r"_(f64|f32|s64)?_?(i64|i32)?$", "", fn)
        assert fn.startswith("stt_") and (f"{fn}(" in text or f"({fn}," in text or f"{base}_##TS##_##IS(" in text), fn
    assert native.GXX_FLAGS == ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]
    assert native._BUILD_DIR == REPO / "build" / "sparse_tpu_torch"


def test_default_device_is_the_gpu():
    x = np.eye(3)
    if torch.cuda.is_available():
        assert st.COO.from_numpy(x).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.COO.from_numpy(x)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.COO(np.array([[0], [1]]), np.array([1.0]), shape=(2, 2))
    assert st.COO.from_numpy(x, device="cpu").device.type == "cpu"


def test_tensor_on_another_device_is_not_moved():
    a = st.COO.from_numpy(np.eye(4), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        a @ torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError):
        st.COO(torch.zeros((2, 1), dtype=torch.int64), torch.ones(1), shape=(2, 2), device="meta")


def test_non_cpu_tensor_never_takes_the_plain_version():
    # a tensor that is not on the CPU goes to the kernel launcher, which
    # refuses what is not a CUDA device instead of computing elsewhere
    re_meta = row_ell.build_row_ell(np.array([0, 1]), np.array([1, 0]), np.array([1.0, 2.0]), 2, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        row_ell.row_ell_spmm(re_meta, torch.empty((2, 3), dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        row_ell.row_ell_spmv(re_meta, torch.empty(2, dtype=torch.float64, device="meta"))
    p = st.nn.init_block_sparse_linear(128, 128, 1.0, generator=torch.Generator().manual_seed(0), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        st.nn.block_sparse_linear(p, torch.empty((4, 128), device="meta"))
    q = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        st.nn.sparse_attention_ell(q, q, q, torch.zeros((4, 2), dtype=torch.int32, device="meta"), torch.ones((4, 2), dtype=torch.bool, device="meta"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda._nvcc()


def test_kernel_sources_ship_with_the_package():
    assert set(_cuda.SOURCES) == {"row_ell", "bsr", "bsr_tc", "mttkrp", "probes", "sddmm", "attention", "minplus", "dia", "spgemm"}
    for name, path in _cuda.SOURCES.items():
        assert path.exists() and path.parent == PKG / "kernels" / "csrc"
        src = path.read_text()
        for fn in _cuda._SIGNATURES[name]:
            # an entry point of its own or one stamped out by a source's macro (BSR, MTTKRP/K5, SDDMM, K6 and its backward, S1)
            macros = ("ST_SDDMM", "ST_MTTKRP", "ST_ROW_SUM", "ST_ELL_ATTENTION", "ST_ELL_ATTENTION_BACKWARD", "ST_SPGEMM_SYMBOLIC", "ST_SPGEMM_NUMERIC")
            assert (
                f"int {fn}(" in src
                or f"int {fn.rsplit('_', 1)[0]}_##SUFFIX(" in src
                or any(f"{macro}({fn}," in src for macro in macros)
            )
    bsr_src = _cuda.SOURCES["bsr"].read_text()
    for suffix, ctype in (("f32", "float"), ("f64", "double"), ("bf16", "__nv_bfloat16")):
        assert f"ST_BSR_SPMM_ENTRY_POINT({suffix}, {ctype})" in bsr_src
    assert "int st_bsr_sddmm_f64(" in bsr_src  # float32 and bfloat16 run on the tensor cores
    tc_src = _cuda.SOURCES["bsr_tc"].read_text()
    for suffix, ctype in (("f32", "float"), ("bf16", "__nv_bfloat16")):
        assert f"ST_BSR_TC_ENTRY_POINT({suffix}, {ctype})" in tc_src
        assert f"ST_BSR_SDDMM_TC_ENTRY_POINT({suffix}, {ctype})" in tc_src
    assert "arch=compute_90a,code=sm_90a" in _cuda._NVCC_FLAGS


def test_launch_counters_start_and_reset():
    _cuda.LAUNCHES["row_ell_spmm"] += 3
    _cuda.reset_launch_counts()
    assert _cuda.LAUNCHES == {
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
        "sampled_row_sum_sliced": 0,
        "sampled_row_sum_union": 0,
        "ell_attention": 0,
        "ell_attention_tiles": 0,
        "ell_attention_backward": 0,
        "ell_attention_backward_tiles": 0,
        "minplus_relax": 0,
        "dia_spmv": 0,
        "spgemm": 0,
    }
