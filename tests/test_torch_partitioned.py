"""The port's partitioned forms against sparse_tpu's (CPU), in a world of one.

The port runs in an in-process gloo group of one rank, which holds every
shard, the edge list's one chunk or the sequence's one segment; the
reference runs on ``conftest.py``'s 8 virtual CPU devices. The reference's
own tests are ported at their tolerances (tests/test_linalg.py:462,
tests/test_dia.py:107 and 127, tests/test_csgraph.py:499, 516 and 533,
tests/test_nn.py:109, 216 and 231), and each function is held against the
reference's and against the port's unsharded call: ``dia_spmv_sharded`` with
``dia_spmv``'s bits for a finite ``x`` and the reference's NaN where the ring
wraps an ``inf``; ``bellman_ford_partitioned`` bit for bit with
predecessors, on the layout's relabelling and the scatter form, and with a
NaN weight as the reference's ``bellman_ford``; ``pagerank_partitioned`` with ``pagerank``'s bits (one chunk is the
whole edge list). Also ``entry`` and ``dryrun_multichip(1)``. Worlds of 2
and 4 are in tests/test_torch_parallel_multiprocess.py.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
import torch.distributed as dist

import jax.numpy as jnp

import sparse_tpu as sparse
import sparse_tpu.parallel as rp
import sparse_tpu_torch as st
import sparse_tpu_torch.parallel as tp
from sparse_tpu import csgraph as jc
from sparse_tpu import linalg as jl
from sparse_tpu import nn as jnn
from sparse_tpu_torch import csgraph as tc
from sparse_tpu_torch import entry as tentry
from sparse_tpu_torch import linalg as tl
from sparse_tpu_torch import nn as tnn
from sparse_tpu_torch.kernels import dia as tdia
from sparse_tpu_torch.kernels import minplus
from test_torch_csgraph_paths import both, hub_graph, random_graph, star_graph


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield tp.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rmesh():
    return rp.make_mesh(8)


def host(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(got, want):
    """``got`` (a CPU tensor) holds the reference's array: dtype, shape, values, inf and NaN."""
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert host(got).dtype == want.dtype and host(got).shape == want.shape
    np.testing.assert_array_equal(host(got), want)


def bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert host(got).tobytes() == host(want).tobytes()


# ---------------------------------------------------------------------------
# linalg.partitioned_matvec (tests/test_linalg.py:462)
# ---------------------------------------------------------------------------


def _spd(n=64, seed=7):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    return rng, B @ B.T + n * np.eye(n)


def test_cg_and_power_iteration_with_a_partitioned_matrix(mesh, rmesh):
    rng, dense = _spd()
    n = dense.shape[0]
    p = tp.partition_coo_rows(st.COO.from_numpy(dense, device="cpu"), 8, mesh=mesh)
    mv = tl.partitioned_matvec(p, mesh)
    assert mv.shape == (n, n) and mv.device == torch.device("cpu")
    b = rng.standard_normal(n)
    x, info = tl.cg(mv, b, tol=1e-10, maxiter=500)
    assert int(info) == 0 and x.device.type == "cpu"
    np.testing.assert_allclose(host(x), np.linalg.solve(dense, b), rtol=1e-6)
    lam, v, _ = tl.power_iteration(mv, tol=1e-12, maxiter=5000)
    np.testing.assert_allclose(float(lam), np.linalg.eigvalsh(dense)[-1], rtol=1e-6)
    # the reference's partitioned matvec: the same solve
    rmv = jl.partitioned_matvec(rp.partition_coo_rows(sparse.COO.from_numpy(dense), 8, mesh=rmesh), rmesh)
    rx, rinfo = jl.cg(rmv, b, tol=1e-10, maxiter=500)
    assert int(rinfo) == 0
    np.testing.assert_allclose(host(x), np.asarray(rx), rtol=1e-6)


def test_partitioned_matvec_is_spmm_replicated(mesh):
    _, dense = _spd(40, 3)
    p = tp.partition_coo_rows(st.COO.from_numpy(dense, device="cpu"), 4)
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(40))
    mv = tl.partitioned_matvec(p, mesh)
    bits(mv(v), tp.spmm_replicated(p, v[:, None], mesh)[:, 0])
    x, info = tl.bicgstab(mv, v, tol=1e-10)
    assert int(info) == 0
    np.testing.assert_allclose(dense @ host(x), host(v), atol=1e-8)


# ---------------------------------------------------------------------------
# kernels.dia_spmv_sharded (tests/test_dia.py:107, 127)
# ---------------------------------------------------------------------------


def _banded_dense(n, offsets, rng):
    dense = np.zeros((n, n))
    for o in offsets:
        idx = np.arange(max(0, -o), min(n, n - o))
        dense[idx, idx + o] = rng.standard_normal(idx.size)
    return dense


@pytest.mark.parametrize("offsets", [(-64, -1, 0, 1, 64), (-2, 3), (0,), (5, 9)])
def test_dia_spmv_sharded_matches_single_device(mesh, rmesh, offsets):
    rng = np.random.default_rng(7)
    n = 64 * 8
    dense = _banded_dense(n, offsets, rng)
    dia = st.COO.from_numpy(dense, device="cpu").to_dia()
    rdia = sparse.COO.from_numpy(dense).to_dia()
    assert dia is not None and dia.offsets == rdia.offsets
    x = rng.standard_normal(n)
    y = st.kernels.dia_spmv_sharded(dia.offsets, dia.bands, x, mesh)
    np.testing.assert_allclose(host(y), dense @ x, rtol=1e-10)
    bits(y, tdia.dia_spmv(dia.offsets, dia.bands, torch.from_numpy(x)))
    np.testing.assert_allclose(host(y), np.asarray(sparse.kernels.dia_spmv_sharded(rdia.offsets, rdia.bands, x, rmesh)), rtol=1e-10)
    # the bands and x as global NumPy arrays are taken too
    bits(tdia.dia_spmv_sharded(dia.offsets, host(dia.bands), x, mesh), y)


def test_dia_spmv_sharded_on_the_cpu_launches_nothing(mesh, monkeypatch):
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts

    def refuse(name):
        raise AssertionError(f"a CPU product loaded {name}")

    monkeypatch.setattr(_cuda, "load", refuse)
    rng = np.random.default_rng(9)
    n, offsets = 64 * 4, (-5, 0, 7)
    dia = st.COO.from_numpy(_banded_dense(n, offsets, rng), device="cpu").to_dia()
    x = torch.from_numpy(rng.standard_normal(n))
    reset_launch_counts()
    y = tdia.dia_spmv_sharded(dia.offsets, dia.bands, x, mesh)
    assert not any(LAUNCHES.values())
    xp = torch.cat([x[-5:], x, x[:7]])  # a world of one: the ring wraps onto the rank
    bits(y, tdia._sharded_sum(dia.offsets, dia.bands, xp, 5))


def test_dia_spmv_sharded_validates(mesh):
    x = np.zeros(64)
    with pytest.raises(ValueError, match="halo"):
        tdia.dia_spmv_sharded((-100, 0, 100), np.zeros((3, 64)), x, mesh)


def test_dia_spmv_sharded_wraps_as_the_reference(mesh, rmesh):
    """The ring wraps at the global edges in both packages, where the bands
    are zero: a finite ``x`` adds zeros there, an ``inf`` gives the
    reference's NaN (``0 · inf``) at the far end."""
    rng = np.random.default_rng(3)
    n = 64
    dense = _banded_dense(n, (-3, 0, 2), rng)
    dia = st.COO.from_numpy(dense, device="cpu").to_dia()
    rdia = sparse.COO.from_numpy(dense).to_dia()
    x = rng.standard_normal(n)
    x[0], x[-1] = np.inf, -np.inf
    got = tdia.dia_spmv_sharded(dia.offsets, dia.bands, x, mesh)
    want = np.asarray(sparse.kernels.dia_spmv_sharded(rdia.offsets, rdia.bands, x, rmesh))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(host(got)), np.isnan(want))
    np.testing.assert_allclose(host(got), want, rtol=1e-12, atol=0.0)  # XLA may fuse a product and its sum


def test_dia_sharded_cg_partitioned_operator(mesh):
    rng = np.random.default_rng(8)
    n = 32 * 8
    dense = _banded_dense(n, (-1, 0, 1), rng)
    dense = (dense + dense.T) / 2 + 4 * np.eye(n)
    dia = st.COO.from_numpy(dense, device="cpu").to_dia()

    def mv(v):
        return tdia.dia_spmv_sharded(dia.offsets, dia.bands, v, mesh)

    mv.shape = (n, n)
    b = torch.from_numpy(rng.standard_normal(n))
    x, info = tl.cg(mv, b, tol=1e-10)
    assert int(info) == 0
    np.testing.assert_allclose(dense @ host(x), host(b), atol=1e-6)


# ---------------------------------------------------------------------------
# csgraph (tests/test_csgraph.py:499, 516, 533)
# ---------------------------------------------------------------------------


def test_bellman_ford_partitioned_matches_single_device(mesh, rmesh):
    a, t = both(random_graph(seed=21, n=80, density=0.05))
    src = np.array([0, 3, 9])
    want = jc.bellman_ford_partitioned(a, rmesh, indices=src)
    same(tc.bellman_ford_partitioned(t, mesh, indices=src), want)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jc.bellman_ford(a, indices=src)))
    bits(tc.bellman_ford_partitioned(t, mesh, indices=src), tc.bellman_ford(t, indices=src))
    # predecessors and the scalar source's squeeze
    d1, p1 = tc.bellman_ford_partitioned(t, mesh, indices=2, return_predecessors=True)
    d2, p2 = jc.bellman_ford_partitioned(a, rmesh, indices=2, return_predecessors=True)
    same(d1, d2)
    same(p1, p2)
    assert d1.shape == (80,)


def test_bellman_ford_partitioned_negative_cycle(mesh):
    g = sps.coo_matrix((np.array([1.0, -3.0, 1.0]), (np.array([0, 1, 2]), np.array([1, 2, 0]))), shape=(3, 3))
    _, t = both(g)
    with pytest.raises(tc.NegativeCycleError):
        tc.bellman_ford_partitioned(t, mesh, indices=0)


def _graph(r, c, w, n):
    return (
        sparse.COO(np.stack([r, c]), w, shape=(n, n)),
        st.COO(np.stack([r, c]), w, shape=(n, n), device="cpu"),
    )


@pytest.mark.parametrize("graph", ["hub", "star", "nan"])
def test_bellman_ford_partitioned_on_every_route(mesh, rmesh, graph):
    if graph == "nan":
        r, c, w, n = hub_graph(seed=3)
        w = w.copy()
        w[::37] = np.nan
    else:
        r, c, w, n = hub_graph() if graph == "hub" else star_graph()
    a, t = _graph(r, c, w, n)
    ell = minplus.build_dest_ell(r, c, w, n, device="cpu")
    assert (ell is None) == (graph == "star") and (graph != "hub" or ell.perm is not None)
    src = np.array([0, 7, 50, 99])
    got = tc.bellman_ford_partitioned(t, mesh, indices=src, return_predecessors=True)
    whole = tc.bellman_ford(t, indices=src)
    if graph == "nan":  # a NaN's payload is not kept through the join
        np.testing.assert_array_equal(host(got[0]), host(whole))
    else:
        bits(got[0], whole)
    if graph == "nan":
        # NaN propagates as in the reference's bellman_ford (its partitioned
        # form's segment_min drops NaN: ROADMAP §C2)
        want = jc.bellman_ford(a, indices=src, return_predecessors=True)
        assert np.isnan(host(got[0])).any()
    else:
        want = jc.bellman_ford_partitioned(a, rmesh, indices=src, return_predecessors=True)
    same(got[0], want[0])
    same(got[1], want[1])


def test_pagerank_partitioned_matches_single_device(mesh, rmesh):
    a, t = both(random_graph(seed=73, n=90, density=0.05))
    ref, _ = jc.pagerank(a, tol=1e-13)
    got, it = tc.pagerank_partitioned(t, mesh, tol=1e-13)
    np.testing.assert_allclose(host(got), np.asarray(ref), rtol=1e-10, atol=1e-14)
    want, it_want = jc.pagerank_partitioned(a, rmesh, tol=1e-13)
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-10, atol=1e-14)
    assert isinstance(it, int) and it == it_want
    # one chunk is the whole edge list: the unsharded call's bits
    whole, it_whole = tc.pagerank(t, tol=1e-13)
    bits(got, whole)
    assert it == it_whole
    # the personalization
    pers = np.zeros(90)
    pers[:4] = 1.0
    r2, _ = jc.pagerank(a, personalize=pers, tol=1e-12)
    g2, _ = tc.pagerank_partitioned(t, mesh, personalize=pers, tol=1e-12)
    np.testing.assert_allclose(host(g2), np.asarray(r2), rtol=1e-9, atol=1e-13)


def test_partitioned_graphs_land_on_the_mesh_device(mesh):
    _, t = both(random_graph(seed=5, n=30))
    assert tc.bellman_ford_partitioned(t, mesh, indices=[0]).device.type == "cpu"
    assert tc.pagerank_partitioned(t, mesh)[0].device.type == "cpu"


# ---------------------------------------------------------------------------
# nn (tests/test_nn.py:109, 216, 231)
# ---------------------------------------------------------------------------


def test_sparse_attention_sharded_matches_single(mesh, rmesh):
    rng = np.random.default_rng(9)
    L, d = 70, 8  # not divisible by the shard count
    rows, cols = jnn.local_attention_pattern(L, 5, 2)
    q, k, v = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(3))
    single = jnn.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows), jnp.asarray(cols))
    lr, lc, valid, br = tnn.partition_attention_pattern(rows, cols, L, 8)
    out = tnn.sparse_attention_sharded(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lr, lc, valid, br, mesh)
    assert out.shape == (L, d) and out.dtype == torch.float32
    np.testing.assert_allclose(host(out), np.asarray(single), atol=1e-5)
    want = jnn.sparse_attention_sharded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lr, lc, valid, br, rmesh)
    np.testing.assert_allclose(host(out), np.asarray(want), atol=1e-5)
    # each shard is the port's COO route: the unsharded call on the same pattern
    whole = tnn.sparse_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(rows), torch.from_numpy(cols))
    np.testing.assert_allclose(host(out), host(whole), atol=1e-6)


@pytest.mark.parametrize("L,n_shards", [(70, 8), (64, 4), (33, 1)])
def test_partition_attention_pattern_is_the_references(L, n_shards):
    rows, cols = jnn.local_attention_pattern(L, 4, 1)
    got = tnn.partition_attention_pattern(rows, cols, L, n_shards)
    want = jnn.partition_attention_pattern(rows, cols, L, n_shards)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("causal", [False, True])
def test_banded_attention_sharded_matches_single(mesh, rmesh, causal):
    rng = np.random.default_rng(14)
    L, W, blk = 256, 16, 16
    q, k = (rng.standard_normal((L, 8)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((L, 12)).astype(np.float32)
    single = jnn.banded_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W, block=blk, causal=causal)
    shard = tnn.banded_attention_sharded(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=W, mesh=mesh, block=blk, causal=causal)
    assert shard.shape == (L, 12) and shard.dtype == torch.float32
    np.testing.assert_allclose(host(shard), np.asarray(single), atol=2e-5)
    want = jnn.banded_attention_sharded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W, mesh=rmesh, block=blk, causal=causal)
    np.testing.assert_allclose(host(shard), np.asarray(want), atol=2e-5)
    whole = tnn.banded_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=W, block=blk, causal=causal)
    np.testing.assert_allclose(host(shard), host(whole), atol=2e-5)


def test_banded_attention_sharded_bfloat16_accumulates_in_float32(mesh):
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    out16 = tnn.banded_attention_sharded(q.bfloat16(), q.bfloat16(), q.bfloat16(), window=5, mesh=mesh, block=16)
    assert out16.dtype == torch.bfloat16
    ref = tnn.banded_attention(q, q, q, window=5, block=16)
    np.testing.assert_allclose(out16.float().numpy(), host(ref), atol=0.05)


def test_banded_attention_sharded_validates(mesh):
    q = torch.ones((100, 4))
    with pytest.raises(ValueError, match="multiple of block"):
        tnn.banded_attention_sharded(q, q, q, window=4, mesh=mesh)
    with pytest.raises(ValueError, match="multiple of block"):
        tnn.banded_attention_sharded(q, q, q, window=200, mesh=mesh, block=50)


# ---------------------------------------------------------------------------
# entry and dryrun_multichip
# ---------------------------------------------------------------------------


def test_entry_is_the_references_step():
    import __graft_entry__ as ref_entry

    fn, args = tentry.entry(device="cpu")
    rfn, rargs = ref_entry.entry()
    for a, r in zip(args, rargs):
        same(a, r)
    out, loss = fn(*args)
    rout, rloss = rfn(*rargs)
    np.testing.assert_allclose(host(out), np.asarray(rout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)


def test_dryrun_multichip_at_a_world_of_one(mesh):
    tentry.dryrun_multichip(1)
    with pytest.raises(ValueError, match="world of 2"):
        tentry.dryrun_multichip(2)


def test_dryrun_multichip_needs_a_process_group(mesh, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tentry.dryrun_multichip(1)
