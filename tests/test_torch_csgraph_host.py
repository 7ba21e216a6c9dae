"""The host algorithms and helpers of sparse_tpu_torch.csgraph against
sparse_tpu's (CPU), and the module's surface.

The traversal orders, RCM, the matchings, the maximum flow, Yen's paths,
the spanning tree and the representation helpers run the reference's
NumPy code on the host; their results come back on the graph's device
(tensors where the reference returns arrays, port COOs where it returns
COOs) and equal the reference's exactly. ``__all__`` is the reference's
without its partitioned forms, and every function takes the reference's
parameter names. NumPy inputs with no device of their own go to the GPU.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_tpu as sparse
import sparse_tpu_torch as st
from sparse_tpu import csgraph as jc
from sparse_tpu_torch import csgraph as tc


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
    return sparse.COO.from_scipy_sparse(g), st.COO.from_scipy_sparse(g, device="cpu")


def same(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def same_coo(got, want):
    assert isinstance(got, st.COO) and got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_array_equal(got.coords.numpy().astype(np.int64), np.asarray(want.coords).astype(np.int64))
    same(got.data, want.data)


@pytest.fixture
def cpu_default(monkeypatch):
    """NumPy inputs placed on the CPU instead of the GPU (no card here)."""
    from sparse_tpu_torch import _settings

    real = _settings.resolve_device
    monkeypatch.setattr(tc, "resolve_device", lambda device=None: real("cpu" if device is None else device))


# ---------------------------------------------------------------------------
# traversals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("start", [0, 5, -1])
def test_depth_first_order_and_tree(directed, start):
    j, t = both(random_graph(seed=30, weighted=False, directed=directed))
    got_nodes, got_pred = tc.depth_first_order(t, start, directed=directed)
    want_nodes, want_pred = jc.depth_first_order(j, start, directed=directed)
    same(got_nodes, want_nodes)
    same(got_pred, want_pred)
    same(tc.depth_first_order(t, start, directed=directed, return_predecessors=False), want_nodes)
    jw, tw = both(random_graph(seed=31, directed=directed))
    same_coo(tc.depth_first_tree(tw, start, directed=directed), jc.depth_first_tree(jw, start, directed=directed))


@pytest.mark.parametrize("symmetric_mode", [False, True])
def test_reverse_cuthill_mckee(symmetric_mode):
    j, t = both(random_graph(seed=32, n=120, density=0.03, directed=False))
    same(tc.reverse_cuthill_mckee(t, symmetric_mode=symmetric_mode), jc.reverse_cuthill_mckee(j, symmetric_mode=symmetric_mode))


# ---------------------------------------------------------------------------
# matchings, flows, K shortest paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(30, 40), (40, 30), (25, 25)])
def test_maximum_bipartite_matching_and_structural_rank(shape):
    g = sps.random(*shape, density=0.1, random_state=7, data_rvs=lambda k: np.ones(k)).tocoo()
    j, t = both(g)
    for perm_type in ("row", "column"):
        same(tc.maximum_bipartite_matching(t, perm_type=perm_type), jc.maximum_bipartite_matching(j, perm_type=perm_type))
    rank = tc.structural_rank(t)
    assert isinstance(rank, int) and rank == jc.structural_rank(j)
    with pytest.raises(ValueError, match="perm_type"):
        tc.maximum_bipartite_matching(t, perm_type="both")


def test_maximum_flow_matches_the_reference():
    rng = np.random.default_rng(70)
    n = 30
    g = sps.random(n, n, density=0.15, random_state=70)
    g.setdiag(0)
    g.eliminate_zeros()
    g.data = np.ceil(rng.random(g.nnz) * 10)
    j, t = both(g.tocoo())
    got, want = tc.maximum_flow(t, 0, n - 1), jc.maximum_flow(j, 0, n - 1)
    assert isinstance(got, tc.MaximumFlowResult) and got.flow_value == want.flow_value
    same_coo(got.flow, want.flow)
    assert repr(got) == repr(want)


def test_maximum_flow_validation():
    t = st.COO.from_numpy(np.array([[0.0, 1.5], [0.0, 0.0]]), device="cpu")
    with pytest.raises(ValueError, match="integer"):
        tc.maximum_flow(t, 0, 1)
    t2 = st.COO.from_numpy(np.array([[0.0, 1.0], [0.0, 0.0]]), device="cpu")
    with pytest.raises(ValueError, match="differ"):
        tc.maximum_flow(t2, 0, 0)
    with pytest.raises(ValueError, match="out of range"):
        tc.maximum_flow(t2, 0, 2)
    with pytest.raises(ValueError, match="non-negative"):
        tc.maximum_flow(st.COO.from_numpy(np.array([[0.0, -1.0], [0.0, 0.0]]), device="cpu"), 0, 1)


@pytest.mark.parametrize("maximized", [False, True])
def test_min_weight_full_bipartite_matching(maximized):
    rng = np.random.default_rng(71)
    dense = rng.random((12, 15)) + 0.1
    dense = np.where(rng.random((12, 15)) < 0.5, dense, 0.0)
    dense[np.arange(12), np.arange(12)] = rng.random(12) + 0.1
    got = tc.min_weight_full_bipartite_matching(st.COO.from_numpy(dense, device="cpu"), maximized=maximized)
    want = jc.min_weight_full_bipartite_matching(sparse.COO.from_numpy(dense), maximized=maximized)
    same(got[0], want[0])
    same(got[1], want[1])


def test_min_weight_matching_negative_weights_and_no_full_matching():
    d = np.zeros((3, 3))
    d[0, 0], d[0, 1], d[1, 1], d[1, 2], d[2, 2] = 10.0, -10.0, 10.0, -10.0, 10.0
    got = tc.min_weight_full_bipartite_matching(torch.from_numpy(d))
    want = jc.min_weight_full_bipartite_matching(sparse.COO.from_numpy(d))
    same(got[0], want[0])
    same(got[1], want[1])
    d2 = np.zeros((2, 2))
    d2[0, 0] = d2[1, 0] = 1.0
    with pytest.raises(ValueError, match="no full matching"):
        tc.min_weight_full_bipartite_matching(torch.from_numpy(d2))


def test_yen_k_shortest_paths():
    rng = np.random.default_rng(72)
    for _ in range(8):
        n = int(rng.integers(6, 35))
        g = sps.random(n, n, density=0.25, random_state=int(rng.integers(1 << 30)))
        g.setdiag(0)
        g.eliminate_zeros()
        if g.nnz == 0:
            continue
        g.data = rng.random(g.nnz) + 0.1
        K = int(rng.integers(1, 5))
        j, t = both(g.tocoo())
        same(tc.yen(t, 0, n - 1, K), jc.yen(j, 0, n - 1, K))
        same(tc.yen(t, 0, n - 1, K, directed=False, unweighted=True), jc.yen(j, 0, n - 1, K, directed=False, unweighted=True))
    empty = tc.yen(torch.zeros(3, 3, dtype=torch.float64), 0, 2, 3)
    assert empty.shape == (0,) and empty.dtype == torch.float64
    with pytest.raises(ValueError, match="non-negative"):
        tc.yen(torch.tensor([[0.0, -1.0], [0.0, 0.0]]), 0, 1, 2)


# ---------------------------------------------------------------------------
# minimum spanning tree
# ---------------------------------------------------------------------------


def test_minimum_spanning_tree():
    rng = np.random.default_rng(17)
    g = sps.random(50, 50, density=0.15, random_state=17)
    g.data = rng.permutation(g.data.size).astype(np.float64) + 1.0
    j, t = both(g.maximum(g.T).tocoo())
    same_coo(tc.minimum_spanning_tree(t), jc.minimum_spanning_tree(j))
    # ties and parallel edges: the same choice as the reference's
    r = rng.integers(0, 30, 300)
    c = rng.integers(0, 30, 300)
    w = rng.integers(1, 4, 300).astype(np.float64)
    same_coo(
        tc.minimum_spanning_tree(st.COO(np.stack([r, c]), w, shape=(30, 30), device="cpu")),
        jc.minimum_spanning_tree(sparse.COO(np.stack([r, c]), w, shape=(30, 30))),
    )


def test_minimum_spanning_forest_disconnected():
    dense = np.zeros((7, 7))
    dense[:4, :4] = np.ones((4, 4)) - np.eye(4)
    dense[4:, 4:] = np.ones((3, 3)) - np.eye(3)
    got = tc.minimum_spanning_tree(torch.from_numpy(dense))
    same_coo(got, jc.minimum_spanning_tree(sparse.COO.from_numpy(dense)))
    assert got.nnz == 5


# ---------------------------------------------------------------------------
# construction and representation helpers
# ---------------------------------------------------------------------------


def test_csgraph_from_dense():
    rng = np.random.default_rng(60)
    a = rng.random((12, 12))
    a[a < 0.6] = 0.0
    a[0, 3] = np.nan
    a[1, 4] = np.inf
    a[2, 5] = -np.inf
    for kw in (dict(), dict(null_value=0), dict(null_value=np.inf, infinity_null=False), dict(nan_null=False, infinity_null=False), dict(null_value=np.nan)):
        same_coo(tc.csgraph_from_dense(torch.from_numpy(a), **kw), jc.csgraph_from_dense(a, **kw))
    b = np.full((4, 4), -1.0)
    b[0, 1], b[2, 3] = 0.0, 5.0
    got = tc.csgraph_from_dense(torch.from_numpy(b), null_value=-1)
    same_coo(got, jc.csgraph_from_dense(b, null_value=-1))
    same(tc.csgraph_to_dense(got, null_value=-1), jc.csgraph_to_dense(jc.csgraph_from_dense(b, null_value=-1), null_value=-1))
    with pytest.raises(ValueError, match="square"):
        tc.csgraph_from_dense(torch.ones(2, 3))


def test_masked_round_trip(cpu_default):
    rng = np.random.default_rng(61)
    a = rng.random((10, 10))
    a[a < 0.5] = 0.0
    got_m, want_m = tc.csgraph_masked_from_dense(a), jc.csgraph_masked_from_dense(a)
    assert isinstance(got_m, np.ma.MaskedArray)
    np.testing.assert_array_equal(np.ma.getmaskarray(got_m), np.ma.getmaskarray(want_m))
    np.testing.assert_array_equal(got_m.data, want_m.data)
    got = tc.csgraph_from_masked(got_m)
    same_coo(got, jc.csgraph_from_masked(want_m))
    back, want_back = tc.csgraph_to_masked(got), jc.csgraph_to_masked(jc.csgraph_from_masked(want_m))
    np.testing.assert_array_equal(np.ma.getmaskarray(back), np.ma.getmaskarray(want_back))
    np.testing.assert_array_equal(back.data, want_back.data)
    same_coo(tc.csgraph_from_dense(a), jc.csgraph_from_dense(a))  # NumPy input on the default device
    with pytest.raises(ValueError, match="square"):
        tc.csgraph_masked_from_dense(np.ones((2, 3)))


def test_csgraph_to_dense_collapses_duplicates_to_the_minimum():
    j, t = both(random_graph(seed=62, n=15, density=0.2))
    for null in (0, np.inf, -1.0):
        same(tc.csgraph_to_dense(t, null_value=null), jc.csgraph_to_dense(j, null_value=null))
    # duplicates reach the helper only through scipy input (a port COO sums them), which goes to the GPU
    r, c, w = np.array([0, 0, 1, 2]), np.array([1, 1, 2, 0]), np.array([3.0, 1.0, 0.0, 2.0])
    g = sps.coo_matrix((w, (r, c)), shape=(3, 3))
    if torch.cuda.is_available():
        got = tc.csgraph_to_dense(g).cpu()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.csgraph_to_dense(g)
        got = None
    want = jc.csgraph_to_dense(g)
    assert want[0, 1] == 1.0 and (got is None or np.array_equal(got.numpy(), want))


@pytest.mark.parametrize("directed", [True, False])
def test_reconstruct_path(directed):
    g = random_graph(seed=63, n=25, density=0.15, directed=directed)
    j, t = both(g)
    _, pred = jc.dijkstra(j, directed=directed, indices=0, return_predecessors=True)
    same_coo(tc.reconstruct_path(t, torch.tensor(np.asarray(pred)), directed=directed), jc.reconstruct_path(j, pred, directed=directed))
    with pytest.raises(ValueError, match="shape"):
        tc.reconstruct_path(t, np.zeros(3, dtype=np.int32))


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("null_value", [np.inf, -1.0])
def test_construct_dist_matrix(directed, null_value):
    g = random_graph(seed=64, n=20, density=0.15, directed=directed)
    j, t = both(g)
    _, pred = tc.shortest_path(t, directed=directed, return_predecessors=True)
    want = jc.construct_dist_matrix(j, pred.numpy(), directed=directed, null_value=null_value)
    same(tc.construct_dist_matrix(t, pred, directed=directed, null_value=null_value), want)
    with pytest.raises(ValueError, match="shape"):
        tc.construct_dist_matrix(t, pred[:3])


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

PARTITIONED = {"bellman_ford_partitioned", "pagerank_partitioned"}


def test_all_is_the_references_without_the_partitioned_forms():
    # the partitioned forms are ported too (tests/test_torch_partitioned.py)
    assert sorted(tc.__all__) == sorted(jc.__all__) and PARTITIONED <= set(tc.__all__)
    assert st.csgraph is tc
    assert issubclass(tc.NegativeCycleError, Exception)


@pytest.mark.parametrize("name", sorted(set(jc.__all__) - {"NegativeCycleError"}))
def test_parameter_names_are_the_references(name):
    ref = inspect.signature(getattr(jc, name)).parameters
    got = inspect.signature(getattr(tc, name)).parameters
    assert list(got) == list(ref)
    assert [p.kind for p in got.values()] == [p.kind for p in ref.values()]
    for p in ref:
        assert got[p].default is ref[p].default or got[p].default == ref[p].default


def test_results_stay_on_the_graphs_device():
    _, t = both(random_graph(seed=65, n=20, density=0.2, directed=False))
    outs = [
        tc.reverse_cuthill_mckee(t),
        tc.depth_first_order(t, 0)[0],
        tc.breadth_first_order(t, 0)[0],
        tc.maximum_bipartite_matching(t),
        tc.csgraph_to_dense(t),
        tc.laplacian(t).data,
        tc.minimum_spanning_tree(t).data,
        tc.pagerank(t)[0],
    ]
    assert all(o.device.type == "cpu" for o in outs)
