"""The port's submodules name every public function of sparse_tpu's.

For ``linalg``, ``kernels``, ``kernels.dia``, ``csgraph`` and ``nn``: each
public function the reference module defines (``kernels``: exports) exists
in the port's module, and its parameters start with the reference's, in
order, with the same kinds and defaults (a dtype default by its name);
what the port adds is optional.
The JAX-only names are listed and excepted (ROADMAP §C2): the Pallas and
XLA variants of the BSR product, whose device-chosen counterparts are
``bsr_spmm_kernel``, ``bsr_sddmm_kernel`` and ``bsr_spmm_plain``, and the
TPU-only parameters (``use_pallas``, the one-hot ``strategy`` and
``lane_gather`` hints, ``rows_sorted``, ``interpret``, a JAX PRNG ``key``).
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

MODULES = ("linalg", "kernels", "kernels.dia", "kernels.search", "csgraph", "nn")

JAX_ONLY_FUNCTIONS = {"kernels": {"bsr_spmm_pallas", "bsr_sddmm_pallas", "bsr_spmm_xla"}}
JAX_ONLY_PARAMETERS = {
    ("kernels", "bsr_spmm"): {"use_pallas"},
    ("kernels", "bsr_spmm_trainable"): {"use_pallas"},
    ("kernels", "coo_spmm"): {"strategy", "rows_sorted"},
    ("kernels", "coo_spmv"): {"strategy", "rows_sorted", "lane_gather"},
    ("kernels", "row_ell_spmv"): {"lane_gather", "interpret"},
    ("nn", "block_sparse_linear"): {"use_pallas"},
    ("nn", "init_block_sparse_linear"): {"key"},
}


def _public_functions(mod):
    ref = importlib.import_module(f"sparse_tpu.{mod}")
    if mod == "kernels":  # a package of exports: jitted functions count
        names = (n for n in dir(ref) if callable(getattr(ref, n)) and not inspect.isclass(getattr(ref, n)) and not inspect.ismodule(getattr(ref, n)))
    else:
        names = (n for n, v in vars(ref).items() if inspect.isfunction(v) and v.__module__ == ref.__name__)
    return sorted(n for n in names if not n.startswith("_"))


def _default(v):
    """A default, with a dtype (torch's or JAX's) as its NumPy name."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type):
        try:
            return np.dtype(v).name
        except TypeError:
            return v
    return v


CASES = [(mod, name) for mod in MODULES for name in _public_functions(mod)]


def test_every_module_is_covered():
    assert {mod for mod, _ in CASES} == set(MODULES)
    assert ("csgraph", "bellman_ford_partitioned") in CASES and ("kernels", "dia_spmv_sharded") in CASES
    assert len(CASES) > 100


@pytest.mark.parametrize("mod,name", CASES, ids=[f"{m}.{n}" for m, n in CASES])
def test_function_exists_with_the_references_parameters(mod, name):
    if name in JAX_ONLY_FUNCTIONS.get(mod, ()):
        return
    ref = getattr(importlib.import_module(f"sparse_tpu.{mod}"), name)
    got = getattr(importlib.import_module(f"sparse_tpu_torch.{mod}"), name)
    skip = JAX_ONLY_PARAMETERS.get((mod, name), set())
    want = {k: p for k, p in inspect.signature(ref).parameters.items() if k not in skip}
    have = inspect.signature(got).parameters
    assert list(have)[: len(want)] == list(want)
    for k, p in want.items():
        assert have[k].kind == p.kind, k
        assert _default(have[k].default) == _default(p.default), k
    assert all(p.default is not inspect.Parameter.empty or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for k, p in list(have.items())[len(want) :])


def test_uncompress_indptr_is_the_references():
    from sparse_tpu.kernels import uncompress_indptr as ref
    from sparse_tpu_torch.kernels import uncompress_indptr

    indptr = np.array([0, 2, 2, 5, 6])
    np.testing.assert_array_equal(uncompress_indptr(torch.from_numpy(indptr), 6).numpy(), np.asarray(ref(jnp.asarray(indptr), 6)))
