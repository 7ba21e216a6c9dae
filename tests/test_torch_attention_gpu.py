"""K6, the row-ELL attention kernel (``csrc/attention.cu``: its tile route on
the tensor cores and its row kernel), and the attention and graph paths
that reach the card through ``sparse_tpu_torch.nn``, on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_attention_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). K6 against its
plain version (``ell_attention_plain``) on the same card: the two sum each
score over d and each output over the slots in another order, so outputs
are held at ``max|got - want| <= tol · max|v|`` with tol 1e-5 in float32
(sums of up to 3,000 slots) and 1e-12 in float64; NaN in the same places.
K6 sums in one order, so two launches give the same bits; so do the COO
route's K4 and K5 and their gradients. The card's results against the
port's CPU results at the same tolerances. The tile route (float32, 3xTF32)
is held to the same float32 tolerance, on every tile shape, and its block
counters show which route took each block. K6's backward kernel against
``ell_attention_backward_rows_plain`` and the whole gradient (the kernel,
then K5 for ``dk`` and ``dv``) against ``ell_attention_backward_plain`` at
the same tolerances of the largest finite magnitude, twice bit for bit; the
entry point's training path with every plain version made to raise. The
backward's tile route (float32, 3xTF32) against
``ell_attention_backward_blocks_plain`` and the row decomposition at the
same tolerance, on every backward tile shape, twice bit for bit, its block
counters apart from the forward's.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch.nn as tnn
from sparse_tpu_torch.kernels import LAUNCHES, _cuda
from sparse_tpu_torch.kernels import attention as tatt

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _problem(L, Lk, d, dv, cap, dtype, device, seed=0, idx=torch.int32, fill=0.8):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((L, d)), dtype=dtype, device=device)
    k = torch.as_tensor(rng.standard_normal((Lk, d)), dtype=dtype, device=device)
    v = torch.as_tensor(rng.standard_normal((Lk, dv)), dtype=dtype, device=device)
    e_cols = torch.as_tensor(rng.integers(0, Lk, (L, cap)), dtype=idx, device=device)
    valid = torch.as_tensor(rng.random((L, cap)) < fill, device=device)
    return q, k, v, e_cols, valid


def _assert_close(got, want, scale, tol, what):
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    ok = ~torch.isnan(want)
    err = float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _launch(q, k, v, e_cols, valid, scale=0.25):
    before = LAUNCHES["ell_attention"]
    out = tatt.ell_attention(q, k, v, e_cols, valid, scale=scale)
    assert LAUNCHES["ell_attention"] == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [1, 5, 33, 513, 1000, 1600, 3000])
@pytest.mark.parametrize("d,dv", [(64, 64), (7, 5), (130, 33), (1, 1)])
def test_k6_matches_plain(cuda, dtype, cap, d, dv):
    L = 64 if cap <= 1000 else 24
    q, k, v, e_cols, valid = _problem(L, 300, d, dv, cap, dtype, cuda, seed=cap + d)
    got = _launch(q, k, v, e_cols, valid)
    want = tatt.ell_attention_plain(q, k, v, e_cols, valid, 0.25)
    _assert_close(got, want, float(v.abs().max()), TOL[dtype], f"cap {cap} d {d} dv {dv}")
    assert torch.equal(got, _launch(q, k, v, e_cols, valid)), "a second launch gave other bits"
    in_smem = _cuda.ell_attention_in_smem(cap, q.element_size())
    assert in_smem == (cap * q.element_size() * 8 <= 48 << 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_k6_unaligned_strided_operands_and_index_dtypes(cuda, dtype, idx):
    q, k, v, e_cols, valid = _problem(50, 80, 66, 34, 40, dtype, cuda, seed=3, idx=idx)
    want = _launch(q, k, v, e_cols, valid)
    # the same values in row-strided views, one off 16-byte alignment: other loads, the same bits
    for shift in (0, 1):
        views = []
        for t in (q, k, v):
            wide = torch.zeros((t.shape[0], t.shape[1] + 5), dtype=dtype, device=cuda)
            wide[:, shift : shift + t.shape[1]] = t
            views.append(wide[:, shift : shift + t.shape[1]])
        assert torch.equal(_launch(*views, e_cols, valid), want)
    # a column-major q is read through a contiguous copy
    assert torch.equal(_launch(q.T.contiguous().T, k, v, e_cols, valid), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_empty_and_all_invalid_rows(cuda, dtype):
    q, k, v, e_cols, valid = _problem(40, 50, 16, 8, 9, dtype, cuda, seed=4)
    valid[3] = False
    valid[10:20] = False
    got = _launch(q, k, v, e_cols, valid)
    want = tatt.ell_attention_plain(q, k, v, e_cols, valid, 0.25)
    _assert_close(got, want, float(v.abs().max()), TOL[dtype], "empty rows")
    assert bool((got[3] == 0).all()) and bool((got[10:20] == 0).all())
    # a pattern from the builder: rows with no edge padded to the cap
    rows = np.array([0, 0, 2, 2, 2, 5], dtype=np.int32)
    cols = np.array([1, 3, 0, 4, 7, 2], dtype=np.int32)
    ec, va = (torch.as_tensor(x, device=cuda) for x in tnn.build_attention_ell(rows, cols, 40))
    _assert_close(_launch(q, k, v, ec, va), tatt.ell_attention_plain(q, k, v, ec, va, 0.25), float(v.abs().max()), TOL[dtype], "built")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_nonfinite_and_index_rules_equal_the_cpu(cuda, dtype):
    q, k, v, e_cols, valid = _problem(6, 9, 4, 3, 3, dtype, cuda, seed=5)
    v[2, 0] = float("inf")
    v[4, 1] = float("nan")
    e_cols[0] = torch.tensor([0, 2, 1])  # inf in a valid slot: the row NaN
    valid[0] = torch.tensor([True, True, False])
    e_cols[1] = torch.tensor([1, 4, 3])  # NaN in a padding slot: that lane NaN
    valid[1] = torch.tensor([True, False, True])
    e_cols[2] = torch.tensor([-1, -9, 0])  # from the end, both in range
    e_cols[3] = torch.tensor([0, 9, 1])  # past the table: the row NaN
    e_cols[4] = torch.tensor([1, 3, -10])  # before the table: the row NaN
    e_cols[5] = torch.tensor([1, 3, 5])
    valid[5] = False
    got = _launch(q, k, v, e_cols, valid)
    cpu = tatt.ell_attention_plain(*(t.cpu() for t in (q, k, v, e_cols, valid)), 0.25)
    _assert_close(got.cpu(), cpu, float(v[torch.isfinite(v)].abs().max()), TOL[dtype], "non-finite rules")
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isnan(got[3]).all()) and bool(torch.isnan(got[4]).all())
    assert bool(torch.isnan(got[1, 1])) and bool(torch.isfinite(got[1, [0, 2]]).all()) and bool(torch.isfinite(got[2]).all())


def test_k6_other_dtypes_take_the_plain_version_without_a_launch(cuda):
    q, k, v, e_cols, valid = _problem(30, 30, 8, 8, 6, torch.bfloat16, cuda, seed=6)
    before = LAUNCHES["ell_attention"]
    got = tatt.ell_attention(q, k, v, e_cols, valid)
    assert LAUNCHES["ell_attention"] == before and got.dtype == torch.bfloat16
    want = tatt.ell_attention_plain(q.float(), k.float(), v.float(), e_cols, valid, 1 / np.sqrt(8))
    assert float((got.float() - want).abs().max()) <= 0.05 * float(v.float().abs().max())


def _pattern(L, window, n_global):
    return tnn.local_attention_pattern(L, window, n_global)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparse_attention_routes_on_the_card_equal_the_cpu(cuda, dtype):
    L, d, dv = 256, 32, 24
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(rng.standard_normal((L, c)), dtype=dtype) for c in (d, d, dv))
    for window, n_global, route in ((16, 0, "ell"), (16, 2, "coo")):
        rows, cols = _pattern(L, window, n_global)
        if route == "coo":
            rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
        want = tnn.sparse_attention(q, k, v, rows, cols)
        pat = (rows.to(cuda), cols.to(cuda)) if route == "coo" else (rows, cols)
        before = dict(LAUNCHES)
        got = tnn.sparse_attention(q.to(cuda), k.to(cuda), v.to(cuda), *pat)
        moved = {n for n in LAUNCHES if LAUNCHES[n] != before[n]}
        # the row-ELL route in float32 takes K6's tile route, then its row kernel on what the tiles left
        ell = {"ell_attention", "ell_attention_tiles"} if dtype == torch.float32 else {"ell_attention"}
        # the COO route's pattern is kept: K5's union route, the gather route on the blocks its layout flags
        assert moved == (ell if route == "ell" else {"sddmm", "sampled_row_sum", "sampled_row_sum_union"}), moved
        _assert_close(got.cpu(), want, float(v.abs().max()), TOL[dtype], route)
        assert torch.equal(got, tnn.sparse_attention(q.to(cuda), k.to(cuda), v.to(cuda), *pat))


@pytest.mark.parametrize("route", ["coo", "ell"])
def test_sparse_attention_gradient_on_the_card(cuda, route):
    L, d = 128, 16
    rng = np.random.default_rng(8)
    q, k, v, w = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float64) for _ in range(4))
    rows, cols = _pattern(L, 8, 0 if route == "ell" else 2)
    pat_cpu = (rows, cols) if route == "ell" else (torch.as_tensor(rows), torch.as_tensor(cols))
    pat_gpu = (rows, cols) if route == "ell" else tuple(t.to(cuda) for t in pat_cpu)

    def grads(device, pat):
        ins = [t.to(device).clone().requires_grad_(True) for t in (q, k, v)]
        (w.to(device) * tnn.sparse_attention(*ins, *pat)).sum().backward()
        return [x.grad for x in ins]

    want = grads("cpu", pat_cpu)
    got = grads(cuda, pat_gpu)
    for g, x in zip(got, want):
        _assert_close(g.cpu(), x, float(x.abs().max()), 1e-12, f"{route} gradient")
    if route == "coo":  # K4 and K5 sum in a fixed order: the same bits
        assert all(torch.equal(a, b) for a, b in zip(got, grads(cuda, pat_gpu)))


def test_graph_conv_on_the_card(cuda):
    n = 500
    rng = np.random.default_rng(9)
    e = rng.integers(0, n, (2, 2000))
    lin = np.unique(np.concatenate([e[0] * n + e[1], e[1] * n + e[0], np.arange(n) * (n + 1)]))
    rows, cols = (lin // n).astype(np.int32), (lin % n).astype(np.int32)
    deg = np.bincount(rows, minlength=n)
    vals = torch.as_tensor(1 / np.sqrt(deg[rows] * deg[cols]), dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal((n, 32)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    want = tnn.graph_conv(rows, cols, vals, x, w, n_nodes=n)
    before = LAUNCHES["sampled_row_sum"]
    ins = [t.to(cuda).requires_grad_(True) for t in (vals, x, w)]
    out = tnn.graph_conv(torch.as_tensor(rows, device=cuda), torch.as_tensor(cols, device=cuda), *ins, n_nodes=n)
    assert LAUNCHES["sampled_row_sum"] == before + 1
    _assert_close(out.detach().cpu(), want, float(want.abs().max()), 1e-5, "graph_conv")
    g = torch.as_tensor(rng.standard_normal((n, 16)), dtype=torch.float32, device=cuda)
    first = torch.autograd.grad((g * out).sum(), ins)
    out2 = tnn.graph_conv(torch.as_tensor(rows, device=cuda), torch.as_tensor(cols, device=cuda), *ins, n_nodes=n)
    second = torch.autograd.grad((g * out2).sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_dense_block_forms_on_the_card_equal_the_cpu(cuda):
    L = 256
    rng = np.random.default_rng(10)
    q, k, v = (torch.as_tensor(rng.standard_normal((L, 32)), dtype=torch.float32) for _ in range(3))
    ids, valid = tnn.bigbird_block_pattern(L, block=32, n_window=1, n_random=2, n_global=1, seed=0)
    calls = [
        lambda *a: tnn.banded_attention(*a, window=20, block=32),
        lambda *a: tnn.banded_attention(*a, window=20, block=32, causal=True),
        lambda *a: tnn.longformer_attention(*a, window=20, n_global=2, block=32),
        lambda *a: tnn.block_sparse_attention(*a, ids, valid, block=32, causal=True),
    ]
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True  # the forms hold full float32 anyway
        for f in calls:
            got = f(q.to(cuda), k.to(cuda), v.to(cuda))
            _assert_close(got.cpu(), f(q, k, v), float(v.abs().max()), 1e-5, "dense form")
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


# ---------------------------------------------------------------------------
# K6's tile route
# ---------------------------------------------------------------------------


def _window(L, window, device):
    rows, cols = tnn.local_attention_pattern(L, window)
    return (torch.as_tensor(x, device=device) for x in tnn.build_attention_ell(rows, cols, L))


def _tiles(q, k, v, e_cols, valid, scale, config, ratio=tatt.ATTENTION_UNION_RATIO):
    """K6's tile route with shape ``config`` and its filtered row launch; the
    output and each block's route."""
    rows = _cuda.ATTENTION_TILE_CONFIGS[config][1]
    blocks = tatt.build_attention_blocks(e_cols, valid, k.shape[0], rows, ratio=ratio)
    out = torch.empty((q.shape[0], v.shape[1]), dtype=q.dtype, device=q.device)
    route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=q.device)
    _cuda.ell_attention_tiles(q, k, v, blocks, scale, out, route, config=config)
    scratch = None
    if not _cuda.ell_attention_in_smem(e_cols.shape[1], 4):
        scratch = torch.empty(_cuda.ell_attention_grid(q.shape[0], q.device) * 8 * e_cols.shape[1], device=q.device)
    _cuda.ell_attention(q, k, v, e_cols, valid, scale, out, scratch, block_route=route, block_rows=rows)
    return out, route


@pytest.mark.parametrize("config", list(_cuda.ATTENTION_TILE_CONFIGS))
@pytest.mark.parametrize("d,dv", [(64, 64), (8, 8), (128, 128), (16, 40)])
@pytest.mark.parametrize("pattern", ["window", "random"])
@pytest.mark.parametrize("cap", [1, 33, 513, 1700])
def test_k6_tile_route_matches_plain(cuda, config, d, dv, pattern, cap):
    rng = np.random.default_rng(cap + d)
    if pattern == "window":
        L = 300 if cap < 1000 else 2000
        e_cols, valid = _window(L, cap // 2, cuda)
        Lk = L
    else:  # columns drawn from a table small enough for every union to stay under the rule
        L, Lk = 150, 300
        e_cols = torch.as_tensor(rng.integers(0, Lk, (L, cap)), dtype=torch.int32, device=cuda)
        valid = torch.as_tensor(rng.random((L, cap)) < 0.8, device=cuda)
    q, k, v = (torch.as_tensor(rng.standard_normal(s_), dtype=torch.float32, device=cuda) for s_ in ((L, d), (Lk, d), (Lk, dv)))
    if not _cuda.attention_tiles_fit(d, dv, torch.float32, config):  # rows too wide for this shape's shared memory
        with pytest.raises(ValueError, match="do not fit"):
            _tiles(q, k, v, e_cols, valid, 0.25, config)
        return
    _cuda.reset_launch_counts()
    got, route = _tiles(q, k, v, e_cols, valid, 0.25, config, ratio=1e9)
    want = tatt.ell_attention_plain(q, k, v, e_cols, valid, 0.25)
    _assert_close(got, want, float(v.abs().max()), TOL[torch.float32], f"{config} {pattern} cap {cap} d {d} dv {dv}")
    assert bool((route == 0).all()), "every block on the tile route"
    again, _ = _tiles(q, k, v, e_cols, valid, 0.25, config, ratio=1e9)
    assert torch.equal(got, again), "a second launch gave other bits"
    n_blocks = route.shape[0]
    assert _cuda.attention_route_blocks(cuda).tolist() == [2 * n_blocks, 0, 0]
    assert LAUNCHES["ell_attention_tiles"] == LAUNCHES["ell_attention"] == 2


def test_k6_tile_route_through_the_entry_point(cuda):
    L, d = 1000, 64
    e_cols, valid = _window(L, 100, cuda)
    rng = np.random.default_rng(30)
    q, k, v = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(3))
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")  # the layout's build and both launches read nothing back
    try:
        first = tatt.ell_attention(q, k, v, e_cols, valid)
        second = tatt.ell_attention(q, k, v, e_cols, valid)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert torch.equal(first, second)
    _assert_close(first, tatt.ell_attention_plain(q, k, v, e_cols, valid, 1 / 8), float(v.abs().max()), TOL[torch.float32], "entry point")
    n_blocks = -(-L // _cuda.ATTENTION_BLOCK_ROWS)
    assert _cuda.attention_route_blocks(cuda).tolist() == [2 * n_blocks, 0, 0]
    assert LAUNCHES["ell_attention_tiles"] == LAUNCHES["ell_attention"] == 2
    # the layout is kept on the pattern's identity; an edit in place builds it anew
    kept = tatt.attention_blocks(e_cols, valid, L, _cuda.ATTENTION_BLOCK_ROWS)
    valid[5, :] = False
    assert tatt.attention_blocks(e_cols, valid, L, kept.block) is not kept
    _assert_close(tatt.ell_attention(q, k, v, e_cols, valid), tatt.ell_attention_plain(q, k, v, e_cols, valid, 1 / 8), float(v.abs().max()), TOL[torch.float32], "after an edit")


@pytest.mark.parametrize("config", list(_cuda.ATTENTION_TILE_CONFIGS))
def test_k6_tile_route_nonfinite_and_index_rules_equal_the_cpu(cuda, config):
    # a window pattern: each key lies in the unions of one or two blocks
    L, d = 384, 16
    rng = np.random.default_rng(31)
    q, k, v = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(3))
    e_cols, valid = _window(L, 5, cuda)
    v[3, 0] = float("inf")  # in valid slots of rows 0-8: those rows NaN
    valid[20, 0] = False
    v[int(e_cols[20, 0]), 5] = float("nan")  # in a padding slot of row 20, valid in its neighbours'
    k[100, 0] = float("-inf")  # a key of rows 95-105
    q[150, 1] = float("nan")  # row 150
    e_cols[250, 3] = -L - 1  # before the table: row 250 NaN
    e_cols[251, 2] = -5  # from the end
    got, route = _tiles(q, k, v, e_cols, valid, 0.25, config)
    cpu = tatt.ell_attention_plain(*(t.cpu() for t in (q, k, v, e_cols, valid)), 0.25)
    finite_v = float(v[torch.isfinite(v)].abs().max())
    _assert_close(got.cpu(), cpu, finite_v, TOL[torch.float32], "non-finite rules")
    assert bool(torch.isnan(got[2]).all()) and bool(torch.isnan(got[250]).all()) and bool(torch.isnan(got[150]).all())
    rows = _cuda.ATTENTION_TILE_CONFIGS[config][1]
    by_block = route.cpu().tolist()
    assert by_block[250 // rows] == 1  # the flag: an index outside the table
    for row in (2, 20, 100, 150):  # non-finite values in the block's union or q rows
        assert by_block[row // rows] == 2, (row, by_block)
    assert 0 in by_block  # the other blocks on the tiles
    want = tatt._block_route(q, k, v, tatt.build_attention_blocks(e_cols, valid, L, rows), 0.25)
    assert [r != 0 for r in by_block] == want.cpu().tolist()


@pytest.mark.parametrize("case", ["scattered", "d20", "float64"])
def test_k6_row_route_cases_and_their_counters(cuda, case):
    L, cap = 2048, 64  # random columns: a block's union about 27 slots' worth, past the rule
    rng = np.random.default_rng(32)
    d = 20 if case == "d20" else 64
    dtype = torch.float64 if case == "float64" else torch.float32
    q, k, v = (torch.as_tensor(rng.standard_normal((L, d)), dtype=dtype, device=cuda) for _ in range(3))
    if case == "scattered":  # random columns at the window's cap: unions past the rule
        e_cols = torch.as_tensor(rng.integers(0, L, (L, cap)), dtype=torch.int32, device=cuda)
        valid = torch.ones((L, cap), dtype=torch.bool, device=cuda)
    else:
        e_cols, valid = _window(L, cap // 2, cuda)
    _cuda.reset_launch_counts()
    got = tatt.ell_attention(q, k, v, e_cols, valid)
    _assert_close(got, tatt.ell_attention_plain(q, k, v, e_cols, valid, 1 / np.sqrt(d)), float(v.abs().max()), TOL[dtype], case)
    n_blocks = -(-L // _cuda.ATTENTION_BLOCK_ROWS)
    counters = _cuda.attention_route_blocks(cuda).tolist()
    if case == "scattered":  # the tile launch finds every block flagged; the row kernel takes them all
        assert LAUNCHES["ell_attention_tiles"] == 1 and counters == [0, n_blocks, 0]
    else:  # the row kernel alone
        assert LAUNCHES["ell_attention_tiles"] == 0 and counters == [0, 0, 0]
    assert LAUNCHES["ell_attention"] == 1
    assert sum(counters) in (0, n_blocks)


def test_k6_route_counters_sum_to_the_blocks(cuda):
    L, d = 700, 32
    rng = np.random.default_rng(33)
    q, k, v = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(3))
    e_cols, valid = _window(L, 10, cuda)  # a window's union about 4 slots' worth; random columns' about 28
    e_cols[600:] = torch.as_tensor(rng.integers(0, L, (100, e_cols.shape[1])), dtype=torch.int32, device=cuda)
    v[int(e_cols[10, 0]), 0] = float("nan")
    _cuda.reset_launch_counts()
    for _ in range(3):
        out = tatt.ell_attention(q, k, v, e_cols, valid)
    _assert_close(out, tatt.ell_attention_plain(q, k, v, e_cols, valid, 1 / np.sqrt(d)), float(v[torch.isfinite(v)].abs().max()), TOL[torch.float32], "mixed")
    n_blocks = -(-L // _cuda.ATTENTION_BLOCK_ROWS)
    tile, by_rule, by_value = _cuda.attention_route_blocks(cuda).tolist()
    assert tile + by_rule + by_value == 3 * n_blocks and tile > 0 and by_rule > 0 and by_value > 0


# ---------------------------------------------------------------------------
# K6's backward: its kernel (dq and the slot weights), then K5 for dk and dv
# ---------------------------------------------------------------------------


def _backward(q, k, v, e_cols, valid, g, scale=0.25):
    """``(dq, dk, dv)`` through ``ell_attention``'s autograd Function."""
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = tatt.ell_attention(*ins, e_cols, valid, scale=scale)
    return torch.autograd.grad(out, ins, g)


def _assert_grads(got, want, tol, what):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        finite = b[torch.isfinite(b)]
        scale = float(finite.abs().max()) if finite.numel() else 0.0
        _assert_close(a, b, scale, tol, f"{what} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [1, 5, 33, 513, 1700])
@pytest.mark.parametrize("d,dv", [(64, 64), (7, 5), (130, 33), (1, 1)])
def test_k6_backward_matches_plain(cuda, dtype, cap, d, dv):
    q, k, v, e_cols, valid = _problem(150, 170, d, dv, cap, dtype, cuda, seed=cap + d)
    g = torch.as_tensor(np.random.default_rng(40).standard_normal((150, dv)), dtype=dtype, device=cuda)
    # the kernel's own outputs against the plain decomposition's
    dq, ds, p = (torch.empty(s_, dtype=dtype, device=cuda) for s_ in ((150, d), (150, cap), (150, cap)))
    _cuda.ell_attention_backward(q, k, v, g, e_cols, valid, 0.25, dq, ds, p)
    want_rows = tatt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, 0.25, g)
    for name, a, b in zip(("dq", "ds", "p"), (dq, ds, p), want_rows):
        _assert_close(a, b, float(b.abs().max()), TOL[dtype], f"kernel {name}")
    # the whole gradient, twice bit for bit
    got = _backward(q, k, v, e_cols, valid, g)
    _assert_grads(got, tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 0.25, g), TOL[dtype], f"cap {cap}")
    assert all(torch.equal(a, b) for a, b in zip(got, _backward(q, k, v, e_cols, valid, g)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_k6_backward_strided_operands_and_index_dtypes(cuda, dtype, idx):
    q, k, v, e_cols, valid = _problem(64, 80, 24, 20, 17, dtype, cuda, seed=41, idx=idx)
    wide = torch.zeros((80, 50), dtype=dtype, device=cuda)
    wide[:, 3:27] = k  # a row stride of 50 and an offset: scalar loads
    g = torch.as_tensor(np.random.default_rng(42).standard_normal((20, 64)), dtype=dtype, device=cuda).T  # transposed: copied
    got = _backward(q, wide[:, 3:27], v, e_cols, valid, g)
    _assert_grads(got, tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 0.25, g), TOL[dtype], "strided")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_backward_nonfinite_and_index_rules_equal_the_cpu(cuda, dtype):
    q, k, v, e_cols, valid = _problem(8, 9, 4, 3, 3, dtype, cuda, seed=5)
    v[2, 0] = float("inf")
    v[4, 1] = float("nan")
    k[6, 2] = float("-inf")
    e_cols[0] = torch.tensor([0, 2, 1])  # inf in a valid slot: the row NaN
    valid[0] = torch.tensor([True, True, False])
    e_cols[1] = torch.tensor([1, 4, 3])  # NaN in a padding slot
    valid[1] = torch.tensor([True, False, True])
    e_cols[2] = torch.tensor([-1, -9, 0])  # from the end, both in range
    e_cols[3] = torch.tensor([0, 9, 1])  # past the table
    e_cols[4] = torch.tensor([1, 3, -10])  # before the table
    e_cols[5] = torch.tensor([1, 3, 5])  # no valid slot
    valid[5] = False
    e_cols[6] = torch.tensor([1, 1, 6])  # a key twice; -inf in a padding slot's k row
    valid[6] = torch.tensor([True, True, False])
    g = torch.as_tensor(np.random.default_rng(43).standard_normal((8, 3)), dtype=dtype, device=cuda)
    got = _backward(q, k, v, e_cols, valid, g)
    cpu = tatt.ell_attention_backward_plain(*(t.cpu() for t in (q, k, v, e_cols, valid)), 0.25, g.cpu())
    _assert_grads([t.cpu() for t in got], cpu, TOL[dtype], "non-finite rules")
    assert bool(torch.isnan(got[0][0]).all()) and bool(torch.isnan(got[0][3]).all())


def test_k6_backward_counters_and_no_plain_version_on_the_card(cuda, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    L, d = 512, 32
    rng = np.random.default_rng(44)
    rows, cols = tnn.local_attention_pattern(L, 16)
    q, k, v, w = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(4))
    e_cols, valid = _window(L, 16, "cpu")
    want = tatt.ell_attention_backward_plain(*(t.cpu() for t in (q, k, v)), e_cols, valid, 1 / np.sqrt(d), w.cpu())
    plains = ("ell_attention_plain", "ell_attention_backward_plain", "ell_attention_backward_rows_plain", "ell_attention_blocks_plain")
    for name in (*plains, "ell_attention_backward_blocks_plain"):
        monkeypatch.setattr(tatt, name, refuse)
    for dtype in (torch.float32, torch.float64):
        ins = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        out = tnn.sparse_attention(*ins, rows, cols)  # the row-ELL route
        loss = (w.to(dtype) * out).sum()
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")  # the slot pattern's build and the launches read nothing back
        try:
            loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        moved = {n: c for n, c in LAUNCHES.items() if c}
        # float32: the tile route once, the row kernel once (filtered); float64 the row kernel alone
        assert moved.get("ell_attention_backward") == 1, moved
        assert moved.get("ell_attention_backward_tiles", 0) == (1 if dtype == torch.float32 else 0), moved
        k5 = moved.get("sampled_row_sum_union", 0) + moved.get("sampled_row_sum", 0) + moved.get("sampled_row_sum_sliced", 0)
        k6 = {"ell_attention_backward", "ell_attention_backward_tiles"}
        assert k5 >= 2 and set(moved) <= k6 | {"sampled_row_sum_union", "sampled_row_sum", "sampled_row_sum_sliced"}, moved
        if dtype == torch.float32:
            _assert_grads([t.grad.cpu() for t in ins], want, TOL[dtype], "entry point")
            n_blocks = -(-L // _cuda.ATTENTION_BLOCK_ROWS)
            assert _cuda.attention_backward_route_blocks(cuda).tolist() == [n_blocks, 0, 0]


# ---------------------------------------------------------------------------
# K6's backward tile route
# ---------------------------------------------------------------------------


def _backward_tiles(q, k, v, g, e_cols, valid, scale, config, ratio=tatt.ATTENTION_UNION_RATIO):
    """The backward tile route with shape ``config`` and the row kernel's
    filtered launch after it: ``(dq, ds, p)``, each block's route, the
    layout and the forward's output."""
    blocks = tatt.build_attention_blocks(e_cols, valid, k.shape[0], _cuda.ATTENTION_BLOCK_ROWS, ratio=ratio)
    out = tatt.ell_attention_plain(q, k, v, e_cols, valid, scale)
    L, cap = e_cols.shape
    dq, ds, p = (torch.empty(s_, device=q.device) for s_ in ((L, q.shape[1]), (L, cap), (L, cap)))
    route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=q.device)
    _cuda.ell_attention_backward_tiles(q, k, v, g, out, blocks, tatt.build_strip_order(blocks), scale, dq, ds, p, route, config)
    _cuda.ell_attention_backward(q, k, v, g, e_cols, valid, scale, dq, ds, p, block_route=route, block_rows=blocks.block)
    return (dq, ds, p), route, blocks, out


def _cancelling(k, g, out, scale, e_cols, valid):
    """The rows whose valid slots name one key at most, and the size of the
    terms that cancel there in ``dŝ = p̂ (dP − δ)`` (``max|δ|``, ``p̂ ≤ 1``)
    and in ``dq = scale · Σ dŝ k`` (``scale · max|k| · max|δ|``): the tile
    route takes ``δ = g · out``, the row decomposition ``Σ p dP``, so in such
    a row, where ``dŝ`` and ``dq`` are 0, the two differ by the rounding of
    those terms alone."""
    c = e_cols.long()
    c = torch.where(c < 0, c + k.shape[0], c)
    lone = torch.where(valid, c, c.new_full((), 2**62)).amin(1) >= torch.where(valid, c, -1).amax(1)
    delta = (g * out).sum(1)
    delta = float(delta[torch.isfinite(delta)].abs().max())
    return lone, {"dq": scale * float(k[torch.isfinite(k)].abs().max()) * delta, "ds": delta, "p": 0.0}


def _assert_strips(got, want, tol, what, cancel):
    """``dq``, ``ds``, ``p`` within ``tol`` of the largest finite magnitude,
    in the rows :func:`_cancelling` names within ``tol`` of the larger of
    that and the cancelling terms'."""
    lone, terms = cancel
    lone = lone.to(want[0].device)
    for name, a, b in zip(("dq", "ds", "p"), got, want):
        finite = b[torch.isfinite(b)]
        size = float(finite.abs().max()) if finite.numel() else 0.0
        _assert_close(a[~lone], b[~lone], size, tol, f"{what} {name}")
        _assert_close(a[lone], b[lone], max(size, terms[name]), tol, f"{what} {name} (rows of one key)")


@pytest.mark.parametrize("config", list(_cuda.ATTENTION_BWD_TILE_CONFIGS))
@pytest.mark.parametrize("d,dv", [(64, 64), (8, 8), (128, 128), (16, 40)])
@pytest.mark.parametrize("pattern", ["window", "random"])
@pytest.mark.parametrize("cap", [1, 33, 513, 1700])
def test_k6_backward_tiles_match_plain(cuda, config, d, dv, pattern, cap):
    rng = np.random.default_rng(cap + d + 1)
    if pattern == "window":
        L = 300 if cap < 1000 else 2000
        e_cols, valid = _window(L, cap // 2, cuda)
        Lk = L
    else:  # columns drawn from a table small enough for every union to stay under the rule
        L, Lk = 150, 300
        e_cols = torch.as_tensor(rng.integers(0, Lk, (L, cap)), dtype=torch.int32, device=cuda)
        valid = torch.as_tensor(rng.random((L, cap)) < 0.8, device=cuda)
    q, k, v, g = (torch.as_tensor(rng.standard_normal(s_), dtype=torch.float32, device=cuda) for s_ in ((L, d), (Lk, d), (Lk, dv), (L, dv)))
    if not _cuda.attention_backward_tiles_fit(d, dv, torch.float32, config):  # rows too wide for this shape's shared memory
        with pytest.raises(ValueError, match="do not fit"):
            _backward_tiles(q, k, v, g, e_cols, valid, 0.25, config)
        return
    _cuda.reset_launch_counts()
    got, route, blocks, out = _backward_tiles(q, k, v, g, e_cols, valid, 0.25, config, ratio=1e9)
    what = f"{config} {pattern} cap {cap} d {d} dv {dv}"
    assert bool((route == 0).all()), "every block on the tile route"
    cancel = _cancelling(k, g, out, 0.25, e_cols, valid)
    _assert_strips(got, tatt.ell_attention_backward_blocks_plain(q, k, v, g, out, blocks, 0.25), TOL[torch.float32], what, cancel)
    if L * cap <= 300 * 513:  # the row decomposition's (L, cap, d + dv) blocks where they stay small
        want = tatt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, 0.25, g)
        _assert_strips(got, want, TOL[torch.float32], what, cancel)
    again = [t.clone() for t in _backward_tiles(q, k, v, g, e_cols, valid, 0.25, config, ratio=1e9)[0]]
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "a second launch gave other bits"
    n_blocks = route.shape[0]
    assert _cuda.attention_backward_route_blocks(cuda).tolist() == [2 * n_blocks, 0, 0]
    assert _cuda.attention_route_blocks(cuda).tolist() == [0, 0, 0]  # the forward's counters stay apart
    assert LAUNCHES["ell_attention_backward_tiles"] == LAUNCHES["ell_attention_backward"] == 2


@pytest.mark.parametrize("cap_window", [1, 40, 300])
def test_k6_backward_tiles_write_every_slot_of_their_blocks(cuda, cap_window):
    # the tiles alone: every slot of a block they take gets its weights (the
    # layout's runs by union place) or 0 and 0 (an invalid slot), nothing else
    L, d = 500, 32
    rng = np.random.default_rng(50 + cap_window)
    q, k, v, g = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(4))
    e_cols, valid = _window(L, cap_window // 2, cuda)
    valid &= torch.as_tensor(rng.random(tuple(valid.shape)) < 0.9, device=cuda)  # invalid slots inside the rows too
    config = _cuda.attention_backward_tile_config(L, d, d, torch.float32, cuda)
    blocks = tatt.build_attention_blocks(e_cols, valid, L, _cuda.ATTENTION_BLOCK_ROWS, ratio=1e9)
    out = tatt.ell_attention_plain(q, k, v, e_cols, valid, 0.25)
    dq, ds, p = (torch.full(s_, float("nan"), device=cuda) for s_ in ((L, d), tuple(e_cols.shape), tuple(e_cols.shape)))
    route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=cuda)
    _cuda.ell_attention_backward_tiles(q, k, v, g, out, blocks, tatt.build_strip_order(blocks), 0.25, dq, ds, p, route, config)
    assert bool((route == 0).all())
    assert not bool(torch.isnan(dq).any() | torch.isnan(ds).any() | torch.isnan(p).any())
    assert bool((p[~valid] == 0).all()) and bool((ds[~valid] == 0).all()) and bool((p[valid] > 0).all())
    want = tatt.ell_attention_backward_blocks_plain(q, k, v, g, out, blocks, 0.25)
    _assert_strips((dq, ds, p), want, TOL[torch.float32], f"window {cap_window}", _cancelling(k, g, out, 0.25, e_cols, valid))


@pytest.mark.parametrize("config", list(_cuda.ATTENTION_BWD_TILE_CONFIGS))
def test_k6_backward_tiles_nonfinite_and_index_rules_equal_the_cpu(cuda, config):
    L, d = 384, 16
    rng = np.random.default_rng(51)
    q, k, v, g = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(4))
    e_cols, valid = _window(L, 5, cuda)
    v[3, 0] = float("inf")  # in valid slots of rows 0-8
    valid[20, 0] = False
    v[int(e_cols[20, 0]), 5] = float("nan")  # in a padding slot of row 20, valid in its neighbours'
    k[100, 0] = float("-inf")  # a key of rows 95-105
    q[150, 1] = float("nan")  # row 150
    g[300, 2] = float("inf")  # g's row 300
    e_cols[250, 3] = -L - 1  # before the table: row 250 NaN
    e_cols[251, 2] = -5  # from the end
    got, route, blocks, out = _backward_tiles(q, k, v, g, e_cols, valid, 0.25, config)
    cpu = tatt.ell_attention_backward_rows_plain(*(t.cpu() for t in (q, k, v, e_cols, valid)), 0.25, g.cpu())
    cancel = _cancelling(k, g, out, 0.25, e_cols, valid)
    _assert_strips([t.cpu() for t in got], cpu, TOL[torch.float32], "non-finite rules", cancel)
    by_block = route.cpu().tolist()
    rows = blocks.block
    assert by_block[250 // rows] == 1  # the flag: an index outside the table
    for row in (2, 20, 100, 150, 300):  # non-finite values in the block's union, q, g or out rows
        assert by_block[row // rows] == 2, (row, by_block)
    assert 0 in by_block
    want = tatt._backward_block_route(q, k, v, g, out, blocks, 0.25)
    assert [r != 0 for r in by_block] == want.cpu().tolist()


def test_k6_backward_tile_counters_sum_to_the_blocks(cuda):
    L, d = 700, 32
    rng = np.random.default_rng(52)
    q, k, v, w = (torch.as_tensor(rng.standard_normal((L, d)), dtype=torch.float32, device=cuda) for _ in range(4))
    e_cols, valid = _window(L, 10, cuda)
    e_cols[600:] = torch.as_tensor(rng.integers(0, L, (100, e_cols.shape[1])), dtype=torch.int32, device=cuda)  # past the rule
    v[int(e_cols[10, 0]), 0] = float("nan")
    _cuda.reset_launch_counts()
    for _ in range(3):
        got = _backward(q, k, v, e_cols, valid, w, scale=1 / np.sqrt(d))
    want = tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 1 / np.sqrt(d), w)
    _assert_grads(got, want, TOL[torch.float32], "mixed")
    n_blocks = -(-L // _cuda.ATTENTION_BLOCK_ROWS)
    tile, by_rule, by_value = _cuda.attention_backward_route_blocks(cuda).tolist()
    assert tile + by_rule + by_value == 3 * n_blocks and tile > 0 and by_rule > 0 and by_value > 0
    assert LAUNCHES["ell_attention_backward_tiles"] == LAUNCHES["ell_attention_backward"] == 3
