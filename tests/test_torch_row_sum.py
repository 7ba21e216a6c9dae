"""K5's routes on the CPU: the route rule, the union layout against a NumPy
construction, and the union route's plain version against
``sampled_row_sum_plain`` and sparse_tpu's SDDMM transpose (``jax.vjp``).

The union layout is built by torch ops; here it is held array for array
against a NumPy construction of the same definition (each block's sorted
distinct table rows, each entry's place in them, the flags, the order of
the blocks and the pieces of the flagged blocks' split segments). The
union route's plain version reads each table row through the layout; it
sums the same products in the same order as ``sampled_row_sum_plain``, so
the two are held bit for bit, and both against ``jax.vjp`` of sparse_tpu's
SDDMM at rtol 1e-12 (float64) or 1e-5 (float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu_torch as st
from sparse_tpu import kernels as jk
from sparse_tpu_torch import nn as tnn
from sparse_tpu_torch.kernels import _cuda, dot

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

# (table rows, K, itemsize, kept, entries, segments) -> route, at the port's shapes
SHAPES = {
    "graph_conv_forward": ((169_343, 256, 4, True, 2_501_737, 169_343), "sliced"),  # x @ w: 173 MB, past L2
    "graph_conv_call_once": ((169_343, 256, 4, False, 2_501_737, 169_343), "sliced"),
    "attention_coo_route": ((4096, 64, 4, True, 2_043_134, 4096), "union"),  # nn's memo keeps the pattern
    "attention_float64": ((4096, 64, 8, True, 2_043_134, 4096), "union"),  # rows of 512 bytes, segments of 499
    "attention_call_once": ((4096, 64, 4, False, 2_043_134, 4096), "gather"),
    "bench_mask_kernels_sddmm": ((65_536, 128, 4, False, 2_096_628, 65_536), "gather"),  # a pattern for one call
    "bench_mask_coo_entry_point": ((65_536, 128, 4, True, 2_096_628, 65_536), "gather"),  # kept; rows of 512 bytes
    "window_129_k128": ((16_384, 128, 4, True, 2_113_280, 16_384), "gather"),  # short segments of wide rows: L1
    "window_513_k256": ((4096, 256, 4, True, 2_101_248, 4096), "union"),  # segments past a piece
    "one_slice_wide": ((10_000_000, 32, 4, False, 10, 10), "gather"),  # K within one slice: nothing to slice
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_route_rule_at_the_ports_shapes(name):
    args, want = SHAPES[name]
    assert _cuda.row_sum_route(*args) == want


def test_route_rule_is_a_function_of_sizes():
    budget = _cuda.ROW_SUM_L2_BUDGET
    k = 64
    rows_at = budget // (k * 4)
    assert _cuda.row_sum_route(rows_at, k, 4, False, 10, 10) == "gather"
    assert _cuda.row_sum_route(rows_at + 1, k, 4, False, 10, 10) == "sliced"
    assert _cuda.row_sum_route(rows_at + 1, k, 4, True, 10, 10) == "sliced"
    assert _cuda.row_sum_route(rows_at // 2 + 1, k, 8, True, 10, 10) == "sliced"  # float64 rows are twice the bytes
    assert _cuda.row_sum_route(rows_at * 1000, _cuda.ROW_SUM_SLICE_COLS, 4, True, 10, 10) == "union"
    # kept patterns: narrow rows, or a mean segment past a piece
    wide = _cuda.ROW_SUM_UNION_ROW_BYTES // 4 + 1
    piece = _cuda.MTTKRP_PIECE
    assert _cuda.row_sum_route(100, wide - 1, 4, True, 10, 10) == "union"
    assert _cuda.row_sum_route(100, wide, 4, True, piece * 10, 10) == "gather"
    assert _cuda.row_sum_route(100, wide, 4, True, piece * 10 + 1, 10) == "union"
    assert _cuda.row_sum_route(100, wide, 4, False, piece * 10 + 1, 10) == "gather"
    assert set(_cuda.ROW_SUM_ROUTES) == {"gather", "sliced", "union"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_union_capacity_fits_shared_memory_and_int16(dtype):
    item = dtype.itemsize
    cap = _cuda.row_sum_union_capacity(item, 10**6, 10**7)
    assert cap * _cuda.ROW_SUM_UNION_COLS * item <= _cuda.ROW_SUM_UNION_SMEM < cap * _cuda.ROW_SUM_UNION_COLS * item + 32 * item * 32
    assert _cuda.row_sum_union_capacity(item, 100, 10**7) == 100
    assert _cuda.row_sum_union_capacity(item, 10**6, 7) == 7
    assert _cuda.row_sum_union_capacity(item, 0, 0) == 1
    assert cap < 1 << 15


@pytest.mark.parametrize("slice_cols", [8, 16, 32])
def test_row_sum_chunks_by_route(slice_cols):
    assert _cuda.row_sum_chunks(256, torch.float32) == 2
    assert _cuda.row_sum_chunks(256, torch.float64) == 4
    assert _cuda.row_sum_chunks(256, torch.float32, slice_cols) == 256 // slice_cols
    assert _cuda.row_sum_chunks(300, torch.float32, slice_cols) == -(-300 // slice_cols)


# ---------------------------------------------------------------------------
# the union layout against NumPy
# ---------------------------------------------------------------------------


def _pattern(case, seed):
    """(rows, cols, m, n): a band of width 5 with a random fraction, random
    entries, and one long row and column (a segment past a piece)."""
    rng = np.random.default_rng(seed)
    m, n = 200, 150
    if case == "banded":
        rows = np.repeat(np.arange(m), 11)
        cols = np.clip(rows + np.tile(np.arange(-5, 6), m), 0, n - 1)
        swap = rng.random(rows.size) < 0.1
        cols[swap] = rng.integers(0, n, int(swap.sum()))
    else:
        rows, cols = rng.integers(0, m, 2500), rng.integers(0, n, 2500)
        if case == "long":
            rows[:700], cols[700:1300] = 3, 140
    return rows, cols, m, n


def _numpy_layout(ptr, idx, n_table, block, u_cap, reuse, piece):
    n_seg = ptr.size - 1
    nb = -(-n_seg // block)
    union = np.zeros((nb, u_cap), np.int64)
    n_union, flag = np.zeros(nb, np.int64), np.zeros(nb, bool)
    local = np.zeros(idx.size, np.int64)
    for b in range(nb):
        lo, hi = ptr[b * block], ptr[min((b + 1) * block, n_seg)]
        u = np.unique(idx[lo:hi])
        n_union[b] = u.size
        union[b, : min(u.size, u_cap)] = u[:u_cap]
        local[lo:hi] = np.minimum(np.searchsorted(u, idx[lo:hi]), u_cap - 1)
        longest = np.diff(ptr[b * block : min((b + 1) * block, n_seg) + 1]).max(initial=0)
        flag[b] = u.size > u_cap or (hi - lo) < reuse * u.size or longest > _cuda.ROW_SUM_UNION_LONG
    lens = np.diff(ptr)
    keep = flag[np.arange(n_seg) // block]
    n_pieces = np.where(keep & (lens > piece), -(-lens // piece), 0)
    pieces = np.concatenate([[0], np.cumsum(n_pieces)])
    return union, n_union, local, flag, np.argsort(flag, kind="stable"), pieces


@pytest.mark.parametrize("reuse", [0.0, 4.0])
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("case", ["banded", "random", "long"])
def test_union_layout_against_numpy(case, axis, block, reuse):
    rows, cols, m, n = _pattern(case, seed=3)
    pattern = dot.SddmmPattern(_t(rows), _t(cols), m, n, rows_sorted=case == "banded", kept=True)
    ptr, order, pieces, idx = pattern.plan(axis)
    n_table = pattern.sizes[1 - axis]
    u_cap = 40
    lay = dot.row_sum_union_layout(ptr, idx, n_table, block, u_cap, reuse)
    want = _numpy_layout(ptr.numpy(), idx.numpy().astype(np.int64), n_table, block, u_cap, reuse, _cuda.MTTKRP_PIECE)
    union, n_union, local, flag, work, want_pieces = want
    assert lay.union.dtype == lay.n_union.dtype == lay.work.dtype == lay.n_work.dtype == torch.int32
    assert lay.local.dtype == torch.int16 and lay.flag.dtype == torch.bool and lay.pieces.dtype == torch.int64
    np.testing.assert_array_equal(lay.union.numpy(), union)
    np.testing.assert_array_equal(lay.n_union.numpy(), n_union)
    np.testing.assert_array_equal(lay.local.numpy(), local)
    np.testing.assert_array_equal(lay.flag.numpy(), flag)
    np.testing.assert_array_equal(lay.work.numpy(), work)
    assert lay.n_work.tolist() == [int((~flag).sum())]
    np.testing.assert_array_equal(lay.pieces.numpy(), want_pieces)
    # every entry of a block whose union fits names its table row through the union
    seg_blk = np.repeat(np.arange(ptr.numel() - 1) // block, np.diff(ptr.numpy()))
    fits = n_union[seg_blk] <= u_cap
    via = lay.union.numpy()[seg_blk, lay.local.numpy()]
    np.testing.assert_array_equal(via[fits], idx.numpy()[fits])
    # each union sorted and distinct
    for b in range(lay.union.shape[0]):
        u = lay.union[b, : min(int(n_union[b]), u_cap)].numpy()
        assert np.all(np.diff(u) > 0)


def test_union_layout_flags():
    # block 0: a long segment whose union fits (every entry names one of 3 rows): kept;
    # block 1: an oversized union; block 2: low reuse (each entry a new row)
    idx = np.concatenate([np.tile([5, 9, 11], 200), np.arange(60), np.arange(100, 108)])
    lens = np.zeros(12, np.int64)
    lens[0], lens[4], lens[8] = 600, 60, 8
    ptr = _t(np.concatenate([[0], np.cumsum(lens)]))
    lay = dot.row_sum_union_layout(ptr, _t(idx.astype(np.int32)), 200, 4, 32, 2.0)
    assert lay.n_union.tolist() == [3, 60, 8]
    assert lay.flag.tolist() == [False, True, True]
    assert lay.work.tolist() == [0, 1, 2] and lay.n_work.tolist() == [1]
    assert lay.union[0, :4].tolist() == [5, 9, 11, 0]
    # the long segment is the union route's: no gather piece; the flagged blocks' segments are short
    assert int(lay.pieces[-1]) == 0
    assert lay.local[:6].tolist() == [0, 1, 2, 0, 1, 2]
    # with reuse off and room for every union, nothing is flagged
    lay = dot.row_sum_union_layout(ptr, _t(idx.astype(np.int32)), 200, 4, 64, 0.0)
    assert lay.flag.tolist() == [False, False, False] and lay.n_work.tolist() == [3]
    # a flagged block's long segment goes to the gather route's pieces
    lay = dot.row_sum_union_layout(ptr, _t(idx.astype(np.int32)), 200, 4, 2, 0.0)
    assert lay.flag.tolist() == [True, True, True]
    assert lay.pieces[1].item() == -(-600 // _cuda.MTTKRP_PIECE)


def test_union_layout_flags_a_block_with_a_long_segment():
    # a hub row named by many entries (the row-ELL attention's padding slots
    # all name key 0): its block takes the gather route, which splits it into pieces
    lens = np.full(8, 40, np.int64)
    lens[1] = _cuda.ROW_SUM_UNION_LONG  # at the limit: kept
    lens[5] = _cuda.ROW_SUM_UNION_LONG + 1
    ptr = _t(np.concatenate([[0], np.cumsum(lens)]))
    idx = _t((np.arange(int(lens.sum())) % 7).astype(np.int32))
    lay = dot.row_sum_union_layout(ptr, idx, 7, 4, 32, 2.0)
    assert lay.flag.tolist() == [False, True] and lay.work.tolist() == [0, 1]
    assert lay.pieces[-1].item() == -(-int(lens[5]) // _cuda.MTTKRP_PIECE)


def test_union_layout_of_empty_and_ragged_patterns():
    ptr = _t(np.zeros(6, np.int64))
    lay = dot.row_sum_union_layout(ptr, torch.zeros(0, dtype=torch.int32), 10, 2, 8, 4.0)
    assert lay.union.shape == (3, 8) and lay.n_union.tolist() == [0, 0, 0]
    assert lay.flag.tolist() == [False, False, False] and lay.local.shape == (0,)
    ptr = _t(np.array([0, 2, 2, 5]))
    lay = dot.row_sum_union_layout(ptr, _t(np.array([3, 3, 1, 0, 1], np.int32)), 4, 2, 8, 0.0)
    assert lay.union.tolist() == [[3, 0, 0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0, 0]]
    assert lay.n_union.tolist() == [1, 2] and lay.local.tolist() == [0, 0, 1, 0, 1]


def test_union_layout_rejects_bad_sizes():
    ptr = _t(np.array([0, 1]))
    idx = torch.zeros(1, dtype=torch.int32)
    for block, n_table, u_cap in ((0, 4, 4), (2, 0, 4), (2, 4, 0), (2, 4, 1 << 15)):
        with pytest.raises(ValueError, match="row_sum_union_layout"):
            dot.row_sum_union_layout(ptr, idx, n_table, block, u_cap, 4.0)


# ---------------------------------------------------------------------------
# the union route's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("case", ["banded", "random", "long"])
def test_union_plain_equals_sampled_row_sum_plain_and_jax(case, axis, dtype):
    rows, cols, m, n = _pattern(case, seed=5)
    rng = np.random.default_rng(6)
    k, nnz = 7, rows.size
    npd = np.float32 if dtype == torch.float32 else np.float64
    s, g = rng.standard_normal(nnz).astype(npd), rng.standard_normal(nnz).astype(npd)
    lhs, rhs = rng.standard_normal((m, k)).astype(npd), rng.standard_normal((k, n)).astype(npd)
    pattern = dot.SddmmPattern(_t(rows), _t(cols), m, n, kept=True)
    ptr, order, _, idx = pattern.plan(axis)
    w = _t(g) * _t(s)
    table = _t(rhs).T if axis == 0 else _t(lhs)
    seg = pattern.ends[axis][order]
    lay = pattern.union(axis, dtype.itemsize)
    got = dot.sampled_row_sum_union_plain(seg, idx, lay, w[order], table, pattern.sizes[axis])
    want = dot.sampled_row_sum_plain(pattern.ends[axis], pattern.ends[1 - axis], w, table, pattern.sizes[axis])
    assert torch.equal(got, want)
    # flags off: every table row read through the union
    lay0 = dot.row_sum_union_layout(ptr, idx, table.shape[0], 64, 512, 0.0)
    assert not bool(lay0.flag.any())
    assert torch.equal(dot.sampled_row_sum_union_plain(seg, idx, lay0, w[order], table, pattern.sizes[axis]), want)
    _, vjp = jax.vjp(lambda l, r: jk.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(s), l, r), jnp.asarray(lhs), jnp.asarray(rhs))
    jax_grad = np.asarray(vjp(jnp.asarray(g))[axis])
    np.testing.assert_allclose((got if axis == 0 else got.T).numpy(), jax_grad, rtol=RTOL[dtype], atol=RTOL[dtype])


def test_union_layout_kept_once_a_pattern_and_shared_with_the_transpose():
    rows, cols, m, n = _pattern("banded", seed=8)
    pattern = dot.SddmmPattern(_t(rows), _t(cols), m, n, rows_sorted=True, kept=True)
    a = pattern.union(0, 4)
    assert pattern.union(0, 4) is a
    assert pattern.T.union(1, 4) is a and pattern.T.kept
    # kept by capacity: a table of 150 rows fits either dtype's, so float64 shares it
    assert _cuda.row_sum_union_capacity(4, n, rows.size) == _cuda.row_sum_union_capacity(8, n, rows.size) == n
    assert pattern.union(0, 8) is a and a.union.shape[1] == n


def test_kept_patterns_are_the_ones_kept_across_calls():
    rows, cols = tnn.local_attention_pattern(64, 4, 1)
    assert tnn._coo_pattern(rows, cols, 64, 64, torch.device("cpu")).sddmm.kept
    a = st.random((40, 30), density=0.2, random_state=0, device="cpu")
    lhs, rhs = torch.rand(40, 3, dtype=torch.float64), torch.rand(3, 30, dtype=torch.float64)
    st.sddmm(a, lhs, rhs)
    assert a.peek_layout("sddmm_pattern", (40, 30)).kept
    assert not dot.SddmmPattern(a.coords[0], a.coords[1], 40, 30).kept


@pytest.mark.parametrize("axis", [0, 1])
def test_kept_random_mask_at_narrow_k_takes_the_union_route_with_every_block_flagged(axis):
    # a random mask kept across calls (the COO entry point's), K = 64 float32:
    # rows of 256 bytes take the union route, whose layout flags every block
    # (too little reuse), so its gather route on the flagged blocks reads every
    # row through idx, as the gather route alone does
    rng = np.random.default_rng(9)
    m, n, nnz, k = 2048, 2048, 40_000, 64
    lin = np.unique(rng.integers(0, m * n, nnz))
    rows, cols = lin // n, lin % n
    pattern = dot.SddmmPattern(_t(rows), _t(cols), m, n, rows_sorted=True, kept=True)
    ptr, order, _, idx = pattern.plan(axis)
    n_out, n_table = pattern.sizes[axis], pattern.sizes[1 - axis]
    assert _cuda.row_sum_route(n_table, k, 4, True, rows.size, n_out) == "union"
    assert _cuda.row_sum_route(n_table, k, 4, False, rows.size, n_out) == "gather"
    lay = pattern.union(axis, 4)
    assert bool(lay.flag.all()) and int(lay.n_work[0]) == 0
    assert torch.equal(lay.pieces, _cuda.run_pieces(ptr, _cuda.MTTKRP_PIECE))
    w = _t(rng.standard_normal(rows.size).astype(np.float32))
    table = _t(rng.standard_normal((n_table, k)).astype(np.float32))
    seg = pattern.ends[axis] if order is None else pattern.ends[axis][order]
    ws = w if order is None else w[order]
    got = dot.sampled_row_sum_union_plain(seg, idx, lay, ws, table, n_out)
    assert torch.equal(got, dot.sampled_row_sum_plain(pattern.ends[axis], pattern.ends[1 - axis], w, table, n_out))
