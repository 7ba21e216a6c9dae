"""The shortest paths of sparse_tpu_torch.csgraph against sparse_tpu's (CPU).

The same seeded graphs go through both packages, the port on
``device="cpu"`` (the relaxation's plain version, K7's arithmetic). The
per-destination ELL layout equals the reference's array for array; the
plain fixed point equals ``_bellman_ford_device_ell``/``_tail`` bit for bit
in float64; distances, ``inf`` patterns and predecessors of every
shortest-path entry point equal the reference's exactly, and so do the
errors. A spy shows the relaxation going through ``minplus_relax``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_tpu as sparse
import sparse_tpu_torch as st
from sparse_tpu import csgraph as jc
from sparse_tpu_torch import csgraph as tc
from sparse_tpu_torch.kernels import minplus


def random_graph(n=40, density=0.1, seed=1, weighted=True, directed=True):
    rng = np.random.default_rng(seed)
    g = sps.random(n, n, density=density, random_state=seed, data_rvs=lambda k: rng.random(k) + 0.1)
    g.setdiag(0)
    g.eliminate_zeros()
    if not weighted:
        g.data[:] = 1.0
    if not directed:
        g = g.maximum(g.T)
    return g.tocoo()


def both(g):
    """The graph as a sparse_tpu COO and a port COO on the CPU."""
    return sparse.COO.from_scipy_sparse(g), st.COO.from_scipy_sparse(g, device="cpu")


def same(got, want):
    """A tensor (or a pair) equal to the reference's arrays: values, ``inf``
    and NaN patterns, shape and dtype."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def hub_graph(seed=42, n=400):
    """``tests/test_csgraph.py:695``'s graph: two hub destinations force the
    tail and the relabelling."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, n, 300), rng.integers(0, n, 60), rng.integers(0, n, 2000)])
    c = np.concatenate([np.full(300, 7), np.full(60, 123), rng.integers(0, n, 2000)])
    return r, c, rng.random(r.size) + 0.1, n


def johnson_hub_graph(seed=43, n=300):
    """``tests/test_csgraph.py:724``'s graph: one hub, some negative weights."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, n, 200), rng.integers(0, n, 1500)])
    c = np.concatenate([np.full(200, 11), rng.integers(0, n, 1500)])
    return r, c, rng.random(r.size) - 0.05, n


def star_graph(n=2000):
    """One destination of in-degree 400 and nothing else: the reference
    refuses the layout (the scatter form runs)."""
    rng = np.random.default_rng(5)
    r = rng.choice(np.arange(1, n), 400, replace=False)
    return r, np.zeros(400, dtype=np.int64), rng.random(400) + 0.1, n


def uniform_graph(seed=7, n=600, m=4000):
    """Uniform random edges: a few destinations of high in-degree go to the tail."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m), rng.random(m) + 0.05, n


def regular_graph(seed=8, n=500, degree=6):
    """Every in-degree the same: one ELL of that width, no tail, no relabelling."""
    rng = np.random.default_rng(seed)
    c = np.repeat(np.arange(n), degree)
    return rng.integers(0, n, c.size), c, rng.random(c.size) + 0.05, n


GRAPHS = {
    "uniform": uniform_graph,
    "regular": regular_graph,
    "hub": hub_graph,
    "johnson_hub": johnson_hub_graph,
    "star": star_graph,
}


def coo_pair(r, c, w, n):
    return sparse.COO(np.stack([r, c]), w, shape=(n, n)), st.COO(np.stack([r, c]), w, shape=(n, n), device="cpu")


# ---------------------------------------------------------------------------
# the layout and the relaxation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_build_dest_ell_equals_the_reference(name, dtype):
    r, c, w, n = GRAPHS[name]()
    want = jc._build_dest_ell(r, c, w, n, np.int64, {torch.float64: np.float64, torch.float32: np.float32}[dtype])
    got = minplus.build_dest_ell(r, c, w, n, dtype=dtype, device="cpu")
    if name == "star":
        assert want is None and got is None
        return
    e_src, e_w, tail, perm = want
    same(got.e_src, e_src)
    same(got.e_w, e_w)
    assert (got.tail is None) == (tail is None) == (name == "regular")
    if tail is not None:
        same(got.tail[0], tail[0])
        same(got.tail[1], tail[1])
        same(got.perm, perm)
        np.testing.assert_array_equal(got.perm[got.inv].numpy(), np.arange(n))
    else:
        assert got.perm is None and got.inv is None


def test_build_dest_ell_of_no_edges_is_none():
    empty = np.zeros(0, dtype=np.int64)
    assert minplus.build_dest_ell(empty, empty, np.zeros(0), 5, device="cpu") is None


@pytest.mark.parametrize("name", ["uniform", "regular", "hub", "johnson_hub"])
@pytest.mark.parametrize("k", [1, 5])
def test_plain_fixed_point_equals_the_reference_bit_for_bit(name, k):
    r, c, w, n = GRAPHS[name]()
    ref = jc._build_dest_ell(r, c, w, n, np.int64, np.float64)
    ell = minplus.build_dest_ell(r, c, w, n, device="cpu")
    d0 = np.full((k, n), np.inf)
    d0[np.arange(k), np.arange(k) * 37 % n] = 0.0
    maxiter = n + 1
    if ref[2] is None:
        want, want_neg = jc._bellman_ford_device_ell(ref[0], ref[1], d0, maxiter=maxiter)
    else:
        want, want_neg = jc._bellman_ford_device_ell_tail(ref[0], ref[1], *ref[2], d0, maxiter=maxiter)
    got, neg, rounds = minplus.minplus_fixpoint(torch.from_numpy(d0.T.copy()), ell.e_src, ell.e_w, ell.tail, maxiter=maxiter)
    same(got.T.contiguous(), want)
    assert neg == bool(want_neg) and 0 < rounds <= maxiter
    # the wrapper on CPU tensors is the plain version, into out when given
    d0t = torch.from_numpy(d0.T.copy())
    one, changed = minplus.minplus_relax_plain(d0t, ell.e_src, ell.e_w, ell.tail)
    out = torch.empty_like(d0t)
    two, changed2 = minplus.minplus_relax(d0t, ell.e_src, ell.e_w, ell.tail, out=out)
    assert two is out and torch.equal(one, two) and bool(changed) == bool(changed2) is True


def test_fixed_point_with_a_negative_cycle_runs_to_maxiter_as_the_reference():
    r = np.array([0, 1, 2, 2, 3])
    c = np.array([1, 2, 0, 3, 4])
    w = np.array([1.0, -3.0, 1.0, 0.5, 2.0])
    n = 5
    ref = jc._build_dest_ell(r, c, w, n, np.int64, np.float64)
    ell = minplus.build_dest_ell(r, c, w, n, device="cpu")
    d0 = np.full((1, n), np.inf)
    d0[0, 0] = 0.0
    want, want_neg = jc._bellman_ford_device_ell(ref[0], ref[1], d0, maxiter=n + 1)
    got, neg, rounds = minplus.minplus_fixpoint(torch.from_numpy(d0.T.copy()), ell.e_src, ell.e_w, ell.tail, maxiter=n + 1)
    same(got.T.contiguous(), want)
    assert neg and bool(want_neg) and rounds == n + 1


def test_the_relaxation_goes_through_minplus_relax_and_keeps_its_layout(monkeypatch):
    r, c, w, n = hub_graph()
    _, a = coo_pair(r, c, w, n)
    calls, builds = [], []
    real_relax, real_build = minplus.minplus_relax, minplus.build_dest_ell
    monkeypatch.setattr(minplus, "minplus_relax", lambda *args, **kw: calls.append(1) or real_relax(*args, **kw))
    monkeypatch.setattr(minplus, "build_dest_ell", lambda *args, **kw: builds.append(1) or real_build(*args, **kw))
    d1 = tc.dijkstra(a, indices=[0, 7, 50])
    ell = a.peek_layout("dest_ell", True)
    assert ell is not None and ell.tail is not None and len(builds) == 1
    # the rounds of the plain fixed point, +1 for the negative-cycle round
    start = ell.inv[torch.tensor([0, 7, 50])]
    _, _, rounds = minplus.minplus_fixpoint(
        tc._start_table(3, n, start, "cpu"), ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, relax=lambda *a_, out=None: minplus.minplus_relax_plain(*a_)
    )
    assert len(calls) == rounds + 1
    d2 = tc.bellman_ford(a, indices=[0, 7, 50])
    assert torch.equal(d1, d2) and len(builds) == 1 and a.peek_layout("dest_ell", True) is ell
    # unweighted builds its own layout every call, and directed=False keys another
    tc.bellman_ford(a, indices=0, unweighted=True)
    assert len(builds) == 2 and a.peek_layout("dest_ell", True) is ell
    tc.bellman_ford(a, indices=0, directed=False)
    assert len(builds) == 3 and a.peek_layout("dest_ell", False) is not None


def test_a_replaced_buffer_builds_the_layout_anew():
    r, c, w, n = uniform_graph()
    j, a = coo_pair(r, c, w, n)
    tc.dijkstra(a, indices=[0, 1])
    first = a.peek_layout("dest_ell", True)
    a.data = a.data * 2
    same(tc.dijkstra(a, indices=[0, 1]), 2 * np.asarray(jc.dijkstra(j, indices=[0, 1])))
    assert a.peek_layout("dest_ell", True) is not first


# ---------------------------------------------------------------------------
# the entry points against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("method", ["BF", "D", "FW", "auto"])
def test_shortest_path_all_pairs(method, directed):
    j, t = both(random_graph(seed=3, directed=directed))
    same(tc.shortest_path(t, method=method, directed=directed), jc.shortest_path(j, method=method, directed=directed))


@pytest.mark.parametrize("fn", ["bellman_ford", "dijkstra", "johnson"])
@pytest.mark.parametrize("indices", [[0, 7, 13], 2, -1, None, np.array([], dtype=np.int64)])
def test_sources_and_squeeze(fn, indices):
    j, t = both(random_graph(seed=4))
    same(getattr(tc, fn)(t, indices=indices), getattr(jc, fn)(j, indices=indices))


def test_tensor_indices_are_taken():
    j, t = both(random_graph(seed=4))
    same(tc.dijkstra(t, indices=torch.tensor([3, 1])), jc.dijkstra(j, indices=[3, 1]))
    same(tc.dijkstra(t, indices=torch.tensor(5)), jc.dijkstra(j, indices=5))


@pytest.mark.parametrize("fn", ["bellman_ford", "dijkstra", "johnson"])
@pytest.mark.parametrize("directed", [True, False])
def test_predecessors(fn, directed):
    j, t = both(random_graph(seed=7, directed=directed))
    same(
        getattr(tc, fn)(t, directed=directed, return_predecessors=True),
        getattr(jc, fn)(j, directed=directed, return_predecessors=True),
    )
    same(getattr(tc, fn)(t, indices=3, return_predecessors=True), getattr(jc, fn)(j, indices=3, return_predecessors=True))


def test_unweighted_distances():
    j, t = both(random_graph(seed=6))
    same(tc.bellman_ford(t, unweighted=True), jc.bellman_ford(j, unweighted=True))
    same(tc.shortest_path(t, unweighted=True, method="FW"), jc.shortest_path(j, unweighted=True, method="FW"))


def test_negative_weights_bellman_ford():
    g = sps.coo_matrix((np.array([2.0, -1.0, 1.0, 5.0]), (np.array([0, 1, 2, 0]), np.array([1, 2, 3, 2]))), shape=(4, 4))
    j, t = both(g)
    same(tc.bellman_ford(t, indices=0), jc.bellman_ford(j, indices=0))
    same(tc.bellman_ford(t, return_predecessors=True), jc.bellman_ford(j, return_predecessors=True))


@pytest.mark.parametrize("directed", [True, False])
def test_johnson_matches_the_reference(directed):
    j, t = both(random_graph(seed=60, directed=directed))
    same(tc.johnson(t, directed=directed), jc.johnson(j, directed=directed))


def test_johnson_negative_weights():
    g = sps.coo_matrix(
        (np.array([3.0, -2.0, 1.0, 4.0, -1.0]), (np.array([0, 0, 1, 2, 3]), np.array([1, 2, 3, 3, 4]))), shape=(5, 5)
    )
    j, t = both(g)
    same(tc.johnson(t), jc.johnson(j))
    same(tc.johnson(t, indices=[0, 2], return_predecessors=True), jc.johnson(j, indices=[0, 2], return_predecessors=True))


@pytest.mark.parametrize("name", ["regular", "hub", "johnson_hub", "star"])
def test_two_tier_and_scatter_routes(name):
    r, c, w, n = GRAPHS[name]()
    j, t = coo_pair(r, c, w, n)
    src = [0, 7, 50]
    if name == "johnson_hub":
        try:
            want = jc.johnson(j, indices=src)
        except jc.NegativeCycleError:
            with pytest.raises(tc.NegativeCycleError):
                tc.johnson(t, indices=src)
            return
        same(tc.johnson(t, indices=src), want)
        return
    same(tc.bellman_ford(t, indices=src, return_predecessors=True), jc.bellman_ford(j, indices=src, return_predecessors=True))
    same(tc.dijkstra(t, indices=src, limit=1.5), jc.dijkstra(j, indices=src, limit=1.5))
    assert (t.peek_layout("dest_ell", True) is None) == (name == "star")


def test_johnson_on_the_relabelled_layout():
    r, c, w, n = hub_graph()
    j, t = coo_pair(r, c, np.abs(w - 0.3), n)
    same(tc.johnson(t, indices=[0, 7, 123], return_predecessors=True), jc.johnson(j, indices=[0, 7, 123], return_predecessors=True))


def test_negative_cycles_raise():
    g = sps.coo_matrix((np.array([1.0, -3.0, 1.0]), (np.array([0, 1, 2]), np.array([1, 2, 0]))), shape=(3, 3))
    _, t = both(g)
    for fn in (lambda: tc.bellman_ford(t, indices=0), lambda: tc.floyd_warshall(t), lambda: tc.johnson(t)):
        with pytest.raises(tc.NegativeCycleError):
            fn()
    # dijkstra checks the signs first; the scatter form's negative cycle too
    with pytest.raises(ValueError, match="non-negative"):
        tc.dijkstra(t)
    r, c, w, n = star_graph()
    _, s = coo_pair(np.concatenate([r, [0]]), np.concatenate([c, [r[0]]]), np.concatenate([-w, [-1.0]]), n)
    with pytest.raises(tc.NegativeCycleError):
        tc.bellman_ford(s, indices=0)


def test_dijkstra_limit():
    j, t = both(random_graph(seed=8))
    same(tc.dijkstra(t, indices=0, limit=0.5), jc.dijkstra(j, indices=0, limit=0.5))
    same(tc.dijkstra(t, limit=0.7, return_predecessors=True), jc.dijkstra(j, limit=0.7, return_predecessors=True))


def test_graph_without_edges():
    j = sparse.COO(np.zeros((2, 0), dtype=np.int64), np.zeros(0), shape=(4, 4))
    t = st.COO(np.zeros((2, 0), dtype=np.int64), np.zeros(0), shape=(4, 4), device="cpu")
    same(tc.bellman_ford(t, indices=[1, 2]), jc.bellman_ford(j, indices=[1, 2]))
    got = tc.dijkstra(t, indices=[1, 2], return_predecessors=True)
    want = jc.dijkstra(j, indices=[1, 2], return_predecessors=True)
    same(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    same(tc.johnson(t, indices=1), jc.johnson(j, indices=1))


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("directed", [True, False])
def test_breadth_first_order(directed):
    j, t = both(random_graph(seed=10, weighted=False, directed=directed))
    same(tc.breadth_first_order(t, 0, directed=directed), jc.breadth_first_order(j, 0, directed=directed))
    same(tc.breadth_first_order(t, 3, directed=directed, return_predecessors=False), jc.breadth_first_order(j, 3, directed=directed, return_predecessors=False))


def test_breadth_first_tree():
    j, t = both(random_graph(seed=11, directed=False))
    for start in (0, -1, 19):
        got, want = tc.breadth_first_tree(t, start, directed=False), jc.breadth_first_tree(j, start, directed=False)
        assert isinstance(got, st.COO) and got.shape == want.shape
        same(got.coords.to(torch.int64), np.asarray(want.coords).astype(np.int64))
        same(got.data, want.data)


# ---------------------------------------------------------------------------
# inputs, devices and errors
# ---------------------------------------------------------------------------


def test_accepts_gcxs_and_dense_tensors():
    g = random_graph(seed=18)
    want = jc.shortest_path(g.tocsr(), indices=0, method="BF")
    for inp in (st.CSR.from_scipy_sparse(g.tocsr(), device="cpu"), torch.from_numpy(g.toarray())):
        same(tc.shortest_path(inp, method="BF", indices=0), want)


def test_scipy_and_numpy_inputs_go_to_the_gpu():
    g = random_graph(seed=18)
    for inp in (g.tocsr(), g.toarray()):
        if torch.cuda.is_available():
            assert tc.dijkstra(inp, indices=0).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tc.dijkstra(inp, indices=0)


def test_rejects_nonzero_fill():
    with pytest.raises(ValueError, match="zero fill"):
        tc.shortest_path(st.full((3, 3), 2.5, device="cpu"), method="BF", indices=0)


def test_rejects_nonsquare():
    with pytest.raises(ValueError, match="square"):
        tc.connected_components(st.random((3, 4), density=0.5, random_state=0, device="cpu"))
    with pytest.raises(ValueError, match="square"):
        tc.bellman_ford(sps.random(5, 3, density=0.5, random_state=0), indices=0)
    with pytest.raises(ValueError, match="square"):
        tc.dijkstra(torch.ones(3, 4), indices=0)


def test_out_of_range_sources_raise():
    j, t = both(random_graph(seed=50, n=5, density=0.5))
    with pytest.raises(ValueError, match="out of range"):
        tc.bellman_ford(t, indices=7)
    with pytest.raises(ValueError, match="out of range"):
        tc.dijkstra(t, indices=[0, 5])
    with pytest.raises(ValueError, match="out of range"):
        tc.breadth_first_order(t, 9)
    with pytest.raises(ValueError, match="out of range"):
        tc.breadth_first_tree(t, -6)
    with pytest.raises(ValueError, match="1-D"):
        tc.bellman_ford(t, indices=[[0, 1]])
    same(tc.bellman_ford(t, indices=-1), jc.bellman_ford(j, indices=4))


def test_unknown_method_and_fw_indices_raise():
    _, t = both(random_graph(seed=5))
    with pytest.raises(ValueError, match="unknown method"):
        tc.shortest_path(t, method="X")
    with pytest.raises(ValueError, match="indices is unsupported"):
        tc.shortest_path(t, method="FW", indices=0)
