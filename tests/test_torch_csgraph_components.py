"""Components, PageRank, Floyd-Warshall and the Laplacian of
sparse_tpu_torch.csgraph against sparse_tpu's (CPU).

The same seeded graphs go through both packages, the port on
``device="cpu"``. Labels, Floyd-Warshall's distances and predecessors and
the Laplacian equal the reference's exactly; PageRank's scores agree at
rtol 1e-12 with the same iteration count (the port sums each row of ``Wᵀ``
in the row-ELL layout's order, with parallel edges' weights added first;
the reference sums the edge list's products by scatter). A spy shows
PageRank's spread going through ``row_ell_spmv``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_tpu as sparse
import sparse_tpu_torch as st
from sparse_tpu import csgraph as jc
from sparse_tpu_torch import csgraph as tc
from sparse_tpu_torch.kernels import row_ell


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
    """A port COO equal to a sparse_tpu COO: shape, coordinates, values."""
    assert isinstance(got, st.COO) and got.shape == want.shape
    np.testing.assert_array_equal(got.coords.numpy().astype(np.int64), np.asarray(want.coords).astype(np.int64))
    same(got.data, want.data)


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "seed, n, density, directed, connection",
    [
        (12, 60, 0.02, True, "weak"),
        (13, 50, 0.03, False, "weak"),
        (13, 50, 0.03, False, "strong"),
        (14, 30, 0.06, True, "strong"),
        (15, 80, 0.01, True, "strong"),
        (16, 200, 0.004, True, "weak"),
    ],
)
def test_connected_components(seed, n, density, directed, connection):
    j, t = both(random_graph(seed=seed, n=n, density=density, directed=directed))
    want_n, want_labels = jc.connected_components(j, directed=directed, connection=connection)
    got_n, got_labels = tc.connected_components(t, directed=directed, connection=connection)
    assert isinstance(got_n, int) and got_n == want_n
    same(got_labels, want_labels)
    assert tc.connected_components(t, directed=directed, connection=connection, return_labels=False) == want_n


def test_connected_components_empty_graph():
    j = sparse.COO(np.zeros((2, 0), dtype=np.int64), np.zeros(0), shape=(5, 5))
    t = st.COO(np.zeros((2, 0), dtype=np.int64), np.zeros(0), shape=(5, 5), device="cpu")
    for connection in ("weak", "strong"):
        want_n, want_labels = jc.connected_components(j, connection=connection)
        got_n, got_labels = tc.connected_components(t, connection=connection)
        assert got_n == want_n == 5
        same(got_labels, want_labels)


def test_connected_components_rejects_an_unknown_connection():
    _, t = both(random_graph(seed=12))
    with pytest.raises(ValueError, match="weak"):
        tc.connected_components(t, connection="medium")


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------


def close_scores(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize(
    "seed, n, density, kw",
    [
        (40, 50, 0.08, dict(alpha=0.85, tol=1e-14)),
        (41, 30, 0.1, dict(tol=1e-13)),
        (42, 120, 0.02, dict(alpha=0.5, tol=1e-10)),
        (43, 60, 0.05, dict(maxiter=7)),
        (44, 60, 0.05, dict(maxiter=0)),
    ],
)
def test_pagerank_matches_the_reference(seed, n, density, kw):
    j, t = both(random_graph(seed=seed, n=n, density=density))
    want, want_it = jc.pagerank(j, **kw)
    got, it = tc.pagerank(t, **kw)
    assert isinstance(it, int) and it == want_it
    close_scores(got, want)


def test_pagerank_personalized():
    j, t = both(random_graph(seed=41, n=30, density=0.1))
    pers = np.zeros(30)
    pers[:3] = 1.0
    want, want_it = jc.pagerank(j, personalize=pers, tol=1e-13)
    got, it = tc.pagerank(t, personalize=torch.from_numpy(pers), tol=1e-13)
    assert it == want_it
    close_scores(got, want)


def test_pagerank_with_parallel_edges_and_dangling_nodes():
    rng = np.random.default_rng(45)
    n = 70
    r, c = rng.integers(0, n - 10, 400), rng.integers(0, n, 400)  # the last 10 nodes have no out-edges
    w = rng.random(400) + 0.1
    j = sparse.COO(np.stack([r, c]), w, shape=(n, n))
    t = st.COO(np.stack([r, c]), w, shape=(n, n), device="cpu")
    want, want_it = jc.pagerank(j, tol=1e-13)
    got, it = tc.pagerank(t, tol=1e-13)
    assert it == want_it
    close_scores(got, want)
    # a dense tensor and a GCXS give the same scores as the COO
    dense = torch.from_numpy(t.todense().numpy())
    assert torch.equal(tc.pagerank(dense, tol=1e-13)[0], tc.pagerank(t.asformat("csr"), tol=1e-13)[0])


def test_pagerank_goes_through_row_ell_spmv_and_keeps_its_layout(monkeypatch):
    _, t = both(random_graph(seed=46, n=80, density=0.05))
    calls = []
    real = row_ell.row_ell_spmv
    monkeypatch.setattr(row_ell, "row_ell_spmv", lambda *args, **kw: calls.append(1) or real(*args, **kw))
    scores, it = tc.pagerank(t)
    assert len(calls) == it > 0
    walk = t.peek_layout("pagerank_walk", None)
    assert isinstance(walk, st.COO) and walk.peek_layout("row_ell", row_ell.ROW_ELL_DEFAULT_KEY) is not None
    again, _ = tc.pagerank(t)
    assert t.peek_layout("pagerank_walk", None) is walk and torch.equal(scores, again)


# ---------------------------------------------------------------------------
# Floyd-Warshall and the Laplacian
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("unweighted", [False, True])
def test_floyd_warshall(directed, unweighted):
    j, t = both(random_graph(seed=9, n=25, directed=directed))
    got = tc.floyd_warshall(t, directed=directed, return_predecessors=True, unweighted=unweighted)
    want = jc.floyd_warshall(j, directed=directed, return_predecessors=True, unweighted=unweighted)
    same(got[0], want[0])
    same(got[1], want[1])
    same(tc.floyd_warshall(t, directed=directed), jc.floyd_warshall(j, directed=directed))


def test_floyd_warshall_negative_weights_and_parallel_edges():
    r = np.array([0, 0, 1, 2, 3, 0])
    c = np.array([1, 2, 3, 3, 4, 1])
    w = np.array([3.0, -2.0, 1.0, 4.0, -1.0, 2.5])
    g = sps.coo_matrix((w, (r, c)), shape=(5, 5))  # scipy sums the parallel edges (0, 1)
    j, t = both(g)
    same(tc.floyd_warshall(t, return_predecessors=True)[0], jc.floyd_warshall(j, return_predecessors=True)[0])
    dense = torch.tensor([[0.0, 3.0], [-4.0, 0.0]])
    with pytest.raises(tc.NegativeCycleError):
        tc.floyd_warshall(dense)


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("use_out_degree", [False, True])
@pytest.mark.parametrize("directed", [False, True])
def test_laplacian(normed, use_out_degree, directed):
    j, t = both(random_graph(seed=15, directed=directed))
    got, got_d = tc.laplacian(t, normed=normed, return_diag=True, use_out_degree=use_out_degree)
    want, want_d = jc.laplacian(j, normed=normed, return_diag=True, use_out_degree=use_out_degree)
    same_coo(got, want)
    same(got_d, want_d)
    same_coo(tc.laplacian(t, normed=normed), jc.laplacian(j, normed=normed))
