"""The graph algorithms of sparse_tpu_torch.csgraph on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_csgraph_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). K7, the min-plus
relaxation kernel (``csrc/minplus.cu``), equals its plain version bit for
bit in float64 and float32, with and without a tail, on one round and on
the whole fixed point (a minimum is exact and each candidate one rounded
add); the shortest paths on the card equal the CPU run's exactly; PageRank
on K1 gives the same bits twice.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch import csgraph
from sparse_tpu_torch.kernels import LAUNCHES, minplus, reset_launch_counts

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _graph(kind, seed=0):
    """``(rows, cols, w, n)``: every in-degree 8 (one ELL, no tail), uniform
    random edges (a tail of the few high in-degrees) or two hub
    destinations (a tail and a relabelling)."""
    rng = np.random.default_rng(seed)
    if kind == "regular":
        n = 3000
        cols = np.repeat(np.arange(n), 8)
        rows = rng.integers(0, n, cols.size)
    elif kind == "uniform":
        n, m = 3000, 24000
        rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    else:
        n = 4000
        rows = np.concatenate([rng.integers(0, n, 200), rng.integers(0, n, 60), rng.integers(0, n, 30000)])
        cols = np.concatenate([np.full(200, 7), np.full(60, 123), rng.integers(0, n, 30000)])
    return rows, cols, rng.random(rows.size) + 0.05, n


def _start(n, k, rng, dtype, device):
    distT = torch.full((n, k), torch.inf, dtype=dtype)
    distT[torch.from_numpy(rng.choice(n, k, replace=False)), torch.arange(k)] = 0.0
    # some finite entries elsewhere, so a round both keeps and lowers values
    mask = torch.from_numpy(rng.random((n, k)) < 0.05)
    distT[mask] = torch.from_numpy(rng.random(int(mask.sum())) * 3).to(dtype)
    return distT.to(device)


@pytest.mark.parametrize("kind", ["regular", "uniform", "hub"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 8, 40])
def test_k7_equals_its_plain_version_bit_for_bit(cuda, kind, dtype, k):
    rows, cols, w, n = _graph(kind)
    ell = minplus.build_dest_ell(rows, cols, w, n, dtype=dtype, device=cuda)
    assert (ell.tail is None) == (kind == "regular")
    distT = _start(n, k, np.random.default_rng(k), dtype, cuda)
    reset_launch_counts()
    got, changed = minplus.minplus_relax(distT, ell.e_src, ell.e_w, ell.tail)
    torch.cuda.synchronize()
    assert LAUNCHES["minplus_relax"] == 1
    want, want_changed = minplus.minplus_relax_plain(distT, ell.e_src, ell.e_w, ell.tail)
    assert torch.equal(got, want) and bool(changed) == bool(want_changed)
    fix, neg, rounds = minplus.minplus_fixpoint(distT, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1)
    plain = lambda d, s, e, t, out=None: minplus.minplus_relax_plain(d, s, e, t)  # noqa: E731
    fix_p, neg_p, rounds_p = minplus.minplus_fixpoint(distT, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, relax=plain)
    assert torch.equal(fix, fix_p) and (neg, rounds) == (neg_p, rounds_p) and not neg
    assert LAUNCHES["minplus_relax"] == 1 + rounds + 1


def test_k7_propagates_nan_as_the_plain_version(cuda):
    rows, cols, w, n = _graph("hub")
    w[::97] = np.nan
    ell = minplus.build_dest_ell(rows, cols, w, n, device=cuda)
    distT = _start(n, 8, np.random.default_rng(1), torch.float64, cuda)
    distT[5, 3] = torch.nan
    got, changed = minplus.minplus_relax(distT, ell.e_src, ell.e_w, ell.tail)
    want, want_changed = minplus.minplus_relax_plain(distT, ell.e_src, ell.e_w, ell.tail)
    assert bool(torch.isnan(got).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(changed) == bool(want_changed)


def test_k7_refuses_what_it_does_not_take(cuda):
    rows, cols, w, n = _graph("uniform")
    ell = minplus.build_dest_ell(rows, cols, w, n, device=cuda)
    distT = _start(n, 4, np.random.default_rng(2), torch.float64, cuda)
    with pytest.raises(TypeError):
        minplus.minplus_relax(distT.half(), ell.e_src, ell.e_w.half())
    with pytest.raises(ValueError, match="must not be dist"):
        minplus.minplus_relax(distT, ell.e_src, ell.e_w, out=distT)
    with pytest.raises(ValueError, match="contiguous"):
        minplus.minplus_relax(distT.T.contiguous().T, ell.e_src, ell.e_w)


@pytest.mark.parametrize("kind", ["uniform", "hub"])
def test_dijkstra_on_the_card_equals_the_cpu_run(cuda, kind):
    rows, cols, w, n = _graph(kind, seed=3)
    coords = np.stack([rows, cols])
    a_gpu = st.COO(coords, w, shape=(n, n), device=cuda)
    a_cpu = st.COO(coords, w, shape=(n, n), device="cpu")
    src = [0, 7, 123, 999]
    reset_launch_counts()
    d_gpu, p_gpu = csgraph.dijkstra(a_gpu, indices=src, return_predecessors=True)
    torch.cuda.synchronize()
    assert LAUNCHES["minplus_relax"] > 0
    d_cpu, p_cpu = csgraph.dijkstra(a_cpu, indices=src, return_predecessors=True)
    assert d_gpu.device.type == "cuda" and torch.equal(d_gpu.cpu(), d_cpu) and torch.equal(p_gpu.cpu(), p_cpu)
    assert a_gpu.peek_layout("dest_ell", True) is not None
    assert torch.equal(csgraph.bellman_ford(a_gpu, indices=src).cpu(), d_cpu)
    # johnson's second phase and the BFS levels run K7 too
    assert torch.equal(csgraph.johnson(a_gpu, indices=src).cpu(), csgraph.johnson(a_cpu, indices=src))
    o_gpu, bp_gpu = csgraph.breadth_first_order(a_gpu, 7)
    o_cpu, bp_cpu = csgraph.breadth_first_order(a_cpu, 7)
    assert torch.equal(o_gpu.cpu(), o_cpu) and torch.equal(bp_gpu.cpu(), bp_cpu)


def test_pagerank_on_k1_gives_the_same_bits_twice(cuda):
    rows, cols, w, n = _graph("hub", seed=4)
    a = st.COO(np.stack([rows, cols]), w, shape=(n, n), device=cuda)
    reset_launch_counts()
    p1, it1 = csgraph.pagerank(a, tol=1e-12)
    assert LAUNCHES["row_ell_spmv"] == it1 and it1 > 0
    p2, it2 = csgraph.pagerank(a, tol=1e-12)
    assert it1 == it2 and torch.equal(p1, p2) and p1.device.type == "cuda"
    p_cpu, it_cpu = csgraph.pagerank(st.COO(np.stack([rows, cols]), w, shape=(n, n), device="cpu"), tol=1e-12)
    assert it_cpu == it1
    np.testing.assert_allclose(p1.cpu().numpy(), p_cpu.numpy(), rtol=1e-12, atol=0)


def test_components_and_floyd_warshall_on_the_card(cuda):
    rows, cols, w, n = _graph("uniform", seed=5)
    a_gpu = st.COO(np.stack([rows, cols]), w, shape=(n, n), device=cuda)
    a_cpu = st.COO(np.stack([rows, cols]), w, shape=(n, n), device="cpu")
    n_gpu, lab_gpu = csgraph.connected_components(a_gpu)
    n_cpu, lab_cpu = csgraph.connected_components(a_cpu)
    assert n_gpu == n_cpu and torch.equal(lab_gpu.cpu(), lab_cpu)
    small = st.COO(np.stack([rows[:600] % 200, cols[:600] % 200]), w[:600], shape=(200, 200), device=cuda)
    small_cpu = st.COO(np.stack([rows[:600] % 200, cols[:600] % 200]), w[:600], shape=(200, 200), device="cpu")
    d, p = csgraph.floyd_warshall(small, return_predecessors=True)
    d_c, p_c = csgraph.floyd_warshall(small_cpu, return_predecessors=True)
    assert torch.equal(d.cpu(), d_c) and torch.equal(p.cpu(), p_c)
    s_gpu = csgraph.connected_components(small, connection="strong")
    s_cpu = csgraph.connected_components(small_cpu, connection="strong")
    assert s_gpu[0] == s_cpu[0] and torch.equal(s_gpu[1].cpu(), s_cpu[1])
