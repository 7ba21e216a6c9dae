"""The graph algorithms of sparse_tpu_torch.csgraph on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_csgraph_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). K7, the min-plus
relaxation kernel (``csrc/minplus.cu``), equals its plain version bit for
bit in float64 and float32, with and without a tail, on one round and on
the whole fixed point (a minimum is exact and each candidate one rounded
add), on both routes (the sliced one forced by a zero L2 budget) and on
the sliced grid at narrower slices than the rule takes, over every slot or
only the filled ones (with the padding's one candidate folded in: NaN where
node 0's distance is NaN or -inf), with one launch a round and one fill a
solve, each solve on a stamp of its own (two solves in two threads on one
stream); the shortest paths on the card equal the CPU run's exactly;
PageRank on K1 gives the same bits twice.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch import csgraph
from sparse_tpu_torch.kernels import LAUNCHES, _cuda, minplus, reset_launch_counts

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


def _plain(d, s, e, t, out=None):
    return minplus.minplus_relax_plain(d, s, e, t)


@pytest.mark.parametrize("kind", ["regular", "uniform", "hub"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k, route", [(1, "gather"), (3, "gather"), (8, "gather"), (40, "gather"), (300, "gather"), (300, "sliced")])
@pytest.mark.parametrize("counts", [True, False], ids=["filled_slots", "every_slot"])
def test_k7_routes_equal_the_plain_version_bit_for_bit(cuda, kind, dtype, k, route, counts):
    rows, cols, w, n = _graph(kind)
    ell = minplus.build_dest_ell(rows, cols, w, n, dtype=dtype, device=cuda)
    budget = 0 if route == "sliced" else None
    assert _cuda.minplus_route(n, k, dtype.itemsize, budget)[0] == route
    deg = {"deg": ell.deg, "t_deg": ell.t_deg} if counts else {}
    distT = _start(n, k, np.random.default_rng(k + 100), dtype, cuda)
    got, changed = minplus.minplus_relax(distT, ell.e_src, ell.e_w, ell.tail, budget=budget, **deg)
    want, want_changed = minplus.minplus_relax_plain(distT, ell.e_src, ell.e_w, ell.tail)
    assert torch.equal(got, want) and bool(changed) == bool(want_changed)
    reset_launch_counts()
    fix, neg, rounds = minplus.minplus_fixpoint(distT, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, budget=budget, **deg)
    torch.cuda.synchronize()
    assert LAUNCHES["minplus_relax"] == rounds + 1
    fix_p, neg_p, rounds_p = minplus.minplus_fixpoint(distT, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, relax=_plain)
    assert torch.equal(fix, fix_p) and (neg, rounds) == (neg_p, rounds_p) and not neg


@pytest.mark.parametrize("kind", ["regular", "hub"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k, slice_bytes", [(3, 16), (40, 16), (40, 32), (300, 32), (300, 128)])
def test_k7_sliced_grid_at_any_slice_width_equals_the_plain_round(cuda, kind, dtype, k, slice_bytes):
    # the grid's indexing at slices the rule does not take (16 bytes up), the last slice partial
    cols = slice_bytes // dtype.itemsize
    rows, cols_, w, n = _graph(kind)
    ell = minplus.build_dest_ell(rows, cols_, w, n, dtype=dtype, device=cuda)
    distT = _start(n, k, np.random.default_rng(k + 200), dtype, cuda)
    want, want_changed = minplus.minplus_relax_plain(distT, ell.e_src, ell.e_w, ell.tail)
    for counts in ({"deg": ell.deg, "t_deg": ell.t_deg}, {}):
        out = torch.empty_like(distT)
        stamp = torch.zeros(1, dtype=torch.int32, device=cuda)
        _cuda.minplus_relax(distT, ell.e_src, ell.e_w, ell.tail, out, stamp, 7, slice_cols=cols, **counts)
        assert torch.equal(out, want) and (int(stamp) == 7) == bool(want_changed)


@pytest.mark.parametrize("node0", [float("nan"), float("-inf")], ids=["nan", "-inf"])
@pytest.mark.parametrize("route", ["gather", "sliced"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k7_padded_rows_take_node_0s_nan_as_the_plain_version(cuda, node0, route, dtype):
    rows, cols, w, n = _graph("uniform")
    ell = minplus.build_dest_ell(rows, cols, w, n, dtype=dtype, device=cuda)
    assert bool((ell.deg < ell.e_src.shape[1]).any()) and bool((ell.t_deg < ell.tail[0].shape[1]).any())
    distT = _start(n, 300, np.random.default_rng(7), dtype, cuda)
    distT[0, ::3] = node0
    budget = 0 if route == "sliced" else None
    assert _cuda.minplus_route(n, 300, dtype.itemsize, budget)[0] == route
    got, changed = minplus.minplus_relax(distT, ell.e_src, ell.e_w, ell.tail, deg=ell.deg, t_deg=ell.t_deg, budget=budget)
    want, want_changed = minplus.minplus_relax_plain(distT, ell.e_src, ell.e_w, ell.tail)
    assert int(torch.isnan(want).sum()) > int(torch.isnan(distT).sum())  # the padded rows' NaN
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(changed) == bool(want_changed)


@pytest.mark.parametrize("route", ["gather", "sliced"])
def test_k7_fixed_point_launches_one_kernel_a_round_and_one_fill_a_solve(cuda, route):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows, cols, w, n = _graph("hub")
    ell = minplus.build_dest_ell(rows, cols, w, n, device=cuda)
    distT = _start(n, 128, np.random.default_rng(3), torch.float64, cuda)
    budget = 0 if route == "sliced" else None
    assert _cuda.minplus_route(n, 128, 8, budget)[0] == route
    args = (distT, ell.e_src, ell.e_w, ell.tail)
    kw = {"maxiter": n + 1, "deg": ell.deg, "t_deg": ell.t_deg, "budget": budget}
    minplus.minplus_fixpoint(*args, **kw)  # the kernel built and loaded
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fix, neg, rounds = minplus.minplus_fixpoint(*args, **kw)
        torch.cuda.synchronize()
    kernels = [
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))
    ]
    assert LAUNCHES["minplus_relax"] == rounds + 1 and not neg
    k7 = [name for name in kernels if "minplus_relax_kernel" in name]
    others = [name for name in kernels if "minplus_relax_kernel" not in name]
    # the solve's stamp zeroed once (a fill kernel, or a memset, which the list leaves out)
    assert len(k7) == rounds + 1 and len(others) <= 1 and all("Fill" in name for name in others), kernels
    fix_p, _, rounds_p = minplus.minplus_fixpoint(*args, maxiter=n + 1, relax=_plain)
    assert torch.equal(fix, fix_p) and rounds == rounds_p


def test_k7_solves_in_two_threads_keep_their_own_stamps(cuda):
    # two solves on the one default stream, their rounds interleaved: each
    # reads only its own stamp, so neither takes the other's fallen round
    # for its own and stops early or late
    solves = []
    for seed in (5, 6):
        rows, cols, w, n = _graph("uniform", seed=seed)
        ell = minplus.build_dest_ell(rows, cols, w, n, device=cuda)
        distT = _start(n, 16, np.random.default_rng(seed), torch.float64, cuda)
        args = (distT, ell.e_src, ell.e_w, ell.tail)
        kw = {"maxiter": n + 1, "deg": ell.deg, "t_deg": ell.t_deg}
        solves.append((args, kw, minplus.minplus_fixpoint(*args, maxiter=n + 1, relax=_plain)))
    minplus.minplus_fixpoint(*solves[0][0], **solves[0][1])  # the kernel built and loaded
    torch.cuda.synchronize()

    def run(i):
        args, kw, _ = solves[i]
        return [minplus.minplus_fixpoint(*args, **kw) for _ in range(20)]

    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(run, (0, 1)))
    for (_, _, (want, want_neg, want_rounds)), got in zip(solves, results):
        for fix, neg, rounds in got:
            assert torch.equal(fix, want) and (neg, rounds) == (want_neg, want_rounds)


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
