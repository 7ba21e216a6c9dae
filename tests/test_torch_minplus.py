"""K7's layout counts, its padding fold and its route rule (CPU).

The redesigned min-plus round (``csrc/minplus.cu``) takes only each row's
filled slots, counted by ``build_dest_ell``'s ``deg`` and ``t_deg``, and
folds the padding slots' one candidate, ``dist[0, s] + inf``, into a padded
row's minimum once. The counts are checked here against the reference's
layout; the fold as a model in torch ops against the plain round, bit for
bit with its NaN pattern, whatever node 0's distance is; the route rule at
the sizes ``chip_smoke.py`` runs, at the budget's edge and on narrow tables
past it (the gather route, as measured). The kernel itself
runs only on the card (``tests/test_torch_csgraph_gpu.py``).
"""

import numpy as np
import pytest
import torch

from sparse_tpu import csgraph as jc
from sparse_tpu_torch.kernels import _cuda, minplus
from test_torch_csgraph_paths import GRAPHS

_NP = {torch.float64: np.float64, torch.float32: np.float32}


def reference_counts(name, dtype):
    """The graph's reference layout and the filled slots of each of its
    rows, from the edges' in-degrees in the reference's labels."""
    r, c, w, n = GRAPHS[name]()
    ref = jc._build_dest_ell(r, c, w, n, np.int64, _NP[dtype])
    if ref is None:
        return None, None, None
    e_src, e_w, tail, perm = ref
    counts = np.bincount(c, minlength=n)
    if perm is not None:
        counts = counts[np.asarray(perm)]  # perm[new] == old
    L0 = e_src.shape[1]
    deg = np.minimum(counts, L0)
    t_deg = None if tail is None else counts[n - tail[0].shape[0] :] - L0
    return ref, deg, t_deg


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_build_dest_ell_counts_the_filled_slots_of_the_reference_layout(name, dtype):
    r, c, w, n = GRAPHS[name]()
    ref, deg, t_deg = reference_counts(name, dtype)
    ell = minplus.build_dest_ell(r, c, w, n, dtype=dtype, device="cpu")
    if ref is None:
        assert ell is None
        return
    e_src, e_w, tail, _ = ref
    assert ell.deg.dtype == torch.int32 and ell.deg.shape == (n,)
    np.testing.assert_array_equal(ell.deg.numpy(), deg)
    # the filled slots are each row's prefix: finite weights there, +inf past it
    filled = np.arange(e_w.shape[1])[None, :] < deg[:, None]
    assert np.isfinite(np.asarray(e_w)[filled]).all() and np.isposinf(np.asarray(e_w)[~filled]).all()
    assert (np.asarray(e_src)[~filled] == 0).all()
    if tail is None:
        assert ell.t_deg is None
        return
    assert ell.t_deg.dtype == torch.int32
    np.testing.assert_array_equal(ell.t_deg.numpy(), t_deg)
    t_w = np.asarray(tail[1])
    t_filled = np.arange(t_w.shape[1])[None, :] < t_deg[:, None]
    assert np.isfinite(t_w[t_filled]).all() and np.isposinf(t_w[~t_filled]).all()
    assert int(ell.deg.sum()) + int(ell.t_deg.sum()) == r.size


def _nan_min(a, b):
    """The kernel's minimum: NaN where either is NaN."""
    return torch.where(torch.isnan(a) | (a < b), a, b)


def _rows_min(dist, src, w, cnt):
    """The minimum over each row's first ``cnt`` slots, +inf for none."""
    best = torch.full((src.shape[0], dist.shape[1]), torch.inf, dtype=dist.dtype)
    for slot in range(src.shape[1]):
        cand = dist[src[:, slot]] + w[:, slot, None]
        take = (cnt > slot)[:, None]
        best = torch.where(take, _nan_min(best, cand), best)
    return best


def padding_fold_model(dist, ell, fold=True):
    """K7's round as its design takes it: each row's filled slots (the tail's
    too), then, for a row with padding, ``dist[0, s] + inf`` once."""
    n, width = ell.e_src.shape
    best = _rows_min(dist, ell.e_src, ell.e_w, ell.deg)
    pad = ell.deg < width
    if ell.tail is not None:
        t_src, t_w = ell.tail
        d = t_src.shape[0]
        best[n - d :] = _nan_min(best[n - d :], _rows_min(dist, t_src, t_w, ell.t_deg))
        pad[n - d :] |= ell.t_deg < t_src.shape[1]
    if fold:
        pad_cand = (dist[0] + torch.inf)[None, :].expand_as(best)
        best = torch.where(pad[:, None], _nan_min(best, pad_cand), best)
    new = _nan_min(dist, best)
    return new, (new < dist).any()


@pytest.mark.parametrize("node0", ["finite", "inf", "-inf", "nan"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padding_fold_gives_the_plain_round_bit_for_bit(node0, dtype):
    r, c, w, n = GRAPHS["uniform"]()
    ell = minplus.build_dest_ell(r, c, w, n, dtype=dtype, device="cpu")
    assert ell.tail is not None and ell.perm is not None  # relabelled, with a padded tail
    assert bool((ell.deg < ell.e_src.shape[1]).any()) and bool((ell.t_deg < ell.tail[0].shape[1]).any())
    rng = np.random.default_rng(11)
    k = 6
    dist = torch.from_numpy(np.where(rng.random((n, k)) < 0.3, rng.random((n, k)) * 4, np.inf)).to(dtype)
    dist[0] = {"finite": 0.5, "inf": np.inf, "-inf": -np.inf, "nan": np.nan}[node0]
    dist[0, 0] = 1.25  # one finite column beside the others
    dist[3, 2] = np.nan  # NaN from a source row too
    got, changed = padding_fold_model(dist, ell)
    want, want_changed = minplus.minplus_relax_plain(dist, ell.e_src, ell.e_w, ell.tail)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(changed) == bool(want_changed)
    # without the fold the padded rows miss the plain version's NaN where node 0 is NaN or -inf
    bare, _ = padding_fold_model(dist, ell, fold=False)
    if node0 in ("-inf", "nan"):
        assert int(torch.isnan(want).sum()) > int(torch.isnan(bare).sum())
    else:
        torch.testing.assert_close(bare, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["uniform", "regular", "hub", "johnson_hub"])
def test_the_cpu_fixed_point_takes_the_counts_and_keeps_its_bits(name):
    r, c, w, n = GRAPHS[name]()
    ell = minplus.build_dest_ell(r, c, w, n, device="cpu")
    d0 = torch.full((n, 3), torch.inf, dtype=torch.float64)
    d0[torch.tensor([0, 5, 9]), torch.arange(3)] = 0.0
    want = minplus.minplus_fixpoint(d0, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1)
    got = minplus.minplus_fixpoint(d0, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, deg=ell.deg, t_deg=ell.t_deg, budget=0)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    one, changed = minplus.minplus_relax(d0, ell.e_src, ell.e_w, ell.tail, deg=ell.deg, t_deg=ell.t_deg)
    plain, plain_changed = minplus.minplus_relax_plain(d0, ell.e_src, ell.e_w, ell.tail)
    assert torch.equal(one, plain) and bool(changed) == bool(plain_changed)


# chip_smoke.py's csgraph_path: the bench graph at 8 and 128 sources, all sources of 16,384 nodes
@pytest.mark.parametrize(
    "n, k, itemsize, want",
    [
        (1 << 17, 8, 8, ("gather", 0)),
        (1 << 17, 128, 8, ("sliced", 64)),
        (1 << 14, 1 << 14, 8, ("sliced", 64)),
        (1 << 17, 128, 4, ("sliced", 64)),
        (1 << 14, 1 << 14, 4, ("sliced", 64)),
    ],
)
def test_route_rule_at_the_smoke_shapes(n, k, itemsize, want):
    assert _cuda.minplus_route(n, k, itemsize) == want


# tables past L2 narrower than two slices of the measured width stay on the gather route
@pytest.mark.parametrize(
    "n, k, itemsize, want",
    [
        (10**6, 8, 8, ("gather", 0)),
        (10**6, 100, 8, ("gather", 0)),
        (10**6, 127, 8, ("gather", 0)),
        (10**6, 127, 4, ("gather", 0)),
        (10**6, 128, 8, ("sliced", 64)),
        (10**6, 128, 4, ("sliced", 64)),
    ],
)
def test_route_rule_keeps_narrow_tables_past_l2_on_the_gather_route(n, k, itemsize, want):
    assert n * k * itemsize > _cuda.MINPLUS_L2_BUDGET
    assert _cuda.minplus_route(n, k, itemsize) == want


def test_route_rule_at_the_budget_edge():
    budget = _cuda.MINPLUS_L2_BUDGET
    cols = _cuda.MINPLUS_SLICE_COLS
    n = 20480
    k = budget // (n * 8)
    assert n * k * 8 == budget and k >= 2 * cols
    assert _cuda.minplus_route(n, k, 8) == ("gather", 0)
    assert _cuda.minplus_route(n, k + 1, 8) == ("sliced", cols)
    # float32 halves the table: the same shape stays on the gather route
    assert _cuda.minplus_route(n, k + 1, 4) == ("gather", 0)
    # a forced budget slices small tables of at least two slices, and no narrower one
    assert _cuda.minplus_route(3000, 300, 8, budget=0) == ("sliced", cols)
    assert _cuda.minplus_route(3000, 2 * cols, 4, budget=0) == ("sliced", cols)
    assert _cuda.minplus_route(3000, 2 * cols - 1, 8, budget=0) == ("gather", 0)
    assert _cuda.minplus_route(3000, 40, 8, budget=0) == ("gather", 0)
    for k in range(1, 600):
        for itemsize in (4, 8):
            want = ("sliced", cols) if k >= 2 * cols else ("gather", 0)
            assert _cuda.minplus_route(3000, k, itemsize, budget=0) == want


def test_k7_wrapper_refuses_cpu_tensors():
    r, c, w, n = GRAPHS["uniform"]()
    ell = minplus.build_dest_ell(r, c, w, n, device="cpu")
    d0 = torch.zeros((n, 2), dtype=torch.float64)
    stamp = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.minplus_relax(d0, ell.e_src, ell.e_w, ell.tail, torch.empty_like(d0), stamp, 1, deg=ell.deg)
    with pytest.raises(TypeError):
        _cuda.minplus_relax(d0.half(), ell.e_src, ell.e_w, ell.tail, torch.empty_like(d0), stamp, 1)
