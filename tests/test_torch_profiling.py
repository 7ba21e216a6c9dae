"""The port's profiling helpers against sparse_tpu's (CPU), as
tests/test_aux.py:13-30 and :110-118 test the reference's.

On the CPU ``benchmark`` times with the host's clock (the card's CUDA-event
timing runs in chip_smoke.py's ``parallel_path``); ``trace`` writes a Chrome
trace of ``torch.profiler``; ``compiled`` is ``torch.compile``, held on one
small function against ``sparse_tpu.compiled`` of the same product (with
the ``aot_eager`` backend: Inductor's C++ build takes tens of seconds on a
CPU).
"""

import functools
import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparse_tpu as sparse
import sparse_tpu.profiling as rprof
import sparse_tpu_torch as st
from sparse_tpu_torch import profiling as tprof

NAMES = ("benchmark", "nnz_throughput", "trace", "compiled")


def test_names_and_attributes():
    assert st.profiling is tprof and st.compiled is tprof.compiled
    assert not {"profiling", "compiled", "parallel"} & set(st.__all__)
    assert all(callable(getattr(tprof, n)) for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_are_the_references(name):
    ref = inspect.signature(getattr(rprof, name)).parameters
    got = inspect.signature(getattr(tprof, name)).parameters
    assert list(got) == list(ref)
    assert [p.kind for p in got.values()] == [p.kind for p in ref.values()]
    for p in ref:
        if name == "trace":  # the port's default directory is under the temporary directory
            continue
        if p == "perturb":
            assert got[p].default is tprof._default_perturb
            continue
        assert got[p].default is ref[p].default or got[p].default == ref[p].default


def test_benchmark_and_throughput():
    x = torch.ones(128)
    dt = tprof.benchmark(lambda x: x * 2, (x,), iters=3)
    assert dt > 0
    assert tprof.nnz_throughput(dt, 1000) == 1000 / dt == rprof.nnz_throughput(dt, 1000)


def test_default_perturb_is_the_references():
    """``i * 1e-6`` on every floating tensor, integers untouched, the same
    values as the reference's bump."""
    args = (torch.ones(4, dtype=torch.float32), torch.arange(4, dtype=torch.int32), [torch.zeros(2, dtype=torch.float64)], {"k": torch.ones(1)})
    bumped = tprof._default_perturb(args, 3)
    want = rprof._default_perturb((jnp.ones((4,), jnp.float32), jnp.arange(4, dtype=jnp.int32), [jnp.zeros(2)], {"k": jnp.ones(1, jnp.float32)}), jnp.int32(3))
    for got, ref in ((bumped[0], want[0]), (bumped[1], want[1]), (bumped[2][0], want[2][0]), (bumped[3]["k"], want[3]["k"])):
        assert got.dtype == getattr(torch, str(np.asarray(ref).dtype))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-7)
    assert bumped[1].dtype == torch.int32 and torch.equal(bumped[1], torch.arange(4, dtype=torch.int32))
    assert isinstance(bumped[2], list) and isinstance(bumped[3], dict)
    a = st.COO.from_numpy(np.eye(3), device="cpu")
    assert tprof._default_perturb((a,), 5)[0] is a  # sparse arrays pass through


def test_benchmark_perturbs_inside_the_timed_calls():
    seen = []
    table, idx = torch.ones((64, 8)), torch.zeros(16, dtype=torch.int64)
    assert tprof.benchmark(lambda t, i: seen.append(float(t[0, 0])) or t[i], (table, idx), iters=3, warmup=2) > 0
    assert seen == [1.0, 1.0, 1.0, float(np.float32(1) + np.float32(1e-6)), float(np.float32(1) + np.float32(2e-6))]
    seen.clear()
    assert tprof.benchmark(lambda t, i: seen.append(float(t[0, 0])) or t[i], (table, idx), iters=3, perturb=None) > 0
    assert seen == [1.0] * 4
    # tuple outputs, and warmup=0 still runs one warm call
    assert tprof.benchmark(lambda x: (x * 2, x + 1), (torch.ones(8),), iters=2, warmup=0) > 0


def test_trace_context(tmp_path):
    log_dir = str(tmp_path / "tr")
    with tprof.trace(log_dir) as d:
        _ = torch.ones(8).sum()
    assert d == log_dir and os.path.isdir(d)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)


def test_compiled_wrapper():
    from sparse_tpu import compiled as rcompiled
    from sparse_tpu.kernels import coo_spmm as rspmm
    from sparse_tpu_torch.kernels import coo_spmm

    a = sparse.random((10, 8), density=0.3, random_state=0)
    b = np.random.default_rng(1).random((8, 3))
    rows, cols = (torch.from_numpy(np.asarray(c)) for c in a.coords)
    data = torch.from_numpy(np.asarray(a.data))

    # keyword arguments pass through to torch.compile; "aot_eager" traces the
    # product as Inductor would but skips its C++ build (tens of seconds here)
    @functools.partial(st.compiled, backend="aot_eager")
    def f(r, c, d, x):
        return coo_spmm(r, c, d, x, n_rows=10)

    want = rcompiled(lambda x: rspmm(jnp.asarray(a.coords[0]), jnp.asarray(a.coords[1]), jnp.asarray(a.data), x, n_rows=10))(jnp.asarray(b))
    np.testing.assert_allclose(f(rows, cols, data, torch.from_numpy(b)).numpy(), np.asarray(want), rtol=1e-12)
