"""The port's sparse attention, segment softmax and graph convolution
(``sparse_tpu_torch.nn``) against ``sparse_tpu.nn`` on the JAX CPU backend.

Same inputs, drawn with numpy from a seed, through both packages. Pattern
builders: array for array, dtypes too. Values: float64 at rtol 1e-12 and
float32 at rtol 1e-5 (the two sum in another order: XLA's reductions
against torch's and the fixed-order sums of K4/K5's plain versions), each
with an absolute floor of the same factor times the largest magnitude
compared, so that near-zero entries are held to the scale of their row.
bfloat16 results within 2 bfloat16 ulps of the largest magnitude (both
accumulate in float32 and round once at the end, from sums in another
order). Gradients against ``jax.grad`` of the same loss at the same
tolerances (the port's segment softmax drops the row max's gradient, which
cancels up to rounding). On the CPU every entry point runs its kernels'
plain versions; K6 itself runs on the card (``test_torch_attention_gpu.py``).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu.nn as jnn
import sparse_tpu_torch.nn as tnn
from sparse_tpu_torch.kernels import attention as tatt

TOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]

# the reference, jitted (compiles once a shape; a host pattern closed over
# stays a NumPy array while tracing, so sparse_attention's route is the eager one's)
J_SEG = jax.jit(jnn.segment_softmax, static_argnames=("n_rows",))
J_ATT = jax.jit(jnn.sparse_attention)
J_ELL = jax.jit(jnn.sparse_attention_ell)
J_BANDED = jax.jit(jnn.banded_attention, static_argnames=("window", "block", "causal"))
J_LONG = jax.jit(jnn.longformer_attention, static_argnames=("window", "n_global", "block"))
J_BLOCK = jax.jit(jnn.block_sparse_attention, static_argnames=("block", "causal"))
J_GCN = jax.jit(jnn.graph_conv, static_argnames=("n_nodes",))


def _j_host_pattern(rows, cols, **kw):
    """``sparse_attention`` on a host pattern, jitted over q, k and v."""
    return jax.jit(lambda q, k, v: jnn.sparse_attention(q, k, v, rows, cols, **kw))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, equal_nan=True)


def _qkv(L, d, dv, dtype, seed, Lk=None):
    rng = np.random.default_rng(seed)
    Lk = L if Lk is None else Lk
    return (
        rng.standard_normal((L, d)).astype(dtype),
        rng.standard_normal((Lk, d)).astype(dtype),
        rng.standard_normal((Lk, dv)).astype(dtype),
    )


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# host pattern builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,window,n_global", [(0, 3, 0), (1, 2, 0), (48, 4, 0), (48, 3, 2), (100, 7, 3), (70, 70, 5)])
def test_local_attention_pattern_array_for_array(length, window, n_global):
    got, want = tnn.local_attention_pattern(length, window, n_global), jnn.local_attention_pattern(length, window, n_global)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "length,kw",
    [
        (64, dict(block=8, n_window=1, n_random=2, n_global=1, seed=3)),
        (4096, dict(block=64, n_window=1, n_random=3, n_global=2, seed=0)),
        (100, dict(block=16, n_window=2, n_random=0, n_global=0, seed=1)),
        (48, dict(block=16, n_window=0, n_random=5, n_global=1, seed=7)),
    ],
)
def test_bigbird_block_pattern_array_for_array(length, kw):
    got, want = tnn.bigbird_block_pattern(length, **kw), jnn.bigbird_block_pattern(length, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pattern", [(48, 4, 0), (48, 3, 2), (30, 2, 0)])
def test_build_attention_ell_array_for_array(pattern):
    length = pattern[0]
    rows, cols = jnn.local_attention_pattern(*pattern)
    got, want = tnn.build_attention_ell(rows, cols, length), jnn.build_attention_ell(rows, cols, length)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # rows with no edge and a sparse pattern
    got = tnn.build_attention_ell(np.array([0, 2, 2]), np.array([1, 0, 3]), 4)
    want = jnn.build_attention_ell(np.array([0, 2, 2]), np.array([1, 0, 3]), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# segment softmax
# ---------------------------------------------------------------------------


def _segment_case(case, rng):
    """``(scores, rows, n_rows, mask)``: empty rows, fully masked rows, unsorted rows."""
    n_rows = 12
    rows = np.sort(rng.integers(0, n_rows, 60)).astype(np.int32)
    rows = rows[(rows != 3) & (rows != 7)]  # rows 3 and 7 empty
    scores = rng.standard_normal(rows.size) * 3
    mask = None
    if case in ("mask", "unsorted_mask"):
        mask = rng.random(rows.size) < 0.7
        mask[rows == 5] = False  # row 5 fully masked
    if case.startswith("unsorted"):
        perm = rng.permutation(rows.size)
        rows, scores = rows[perm], scores[perm]
        mask = None if mask is None else mask[perm]
    return scores, rows, n_rows, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["plain", "mask", "unsorted", "unsorted_mask"])
@pytest.mark.parametrize("rows_as", ["numpy", "tensor"])
def test_segment_softmax_matches_sparse_tpu(dtype, case, rows_as):
    scores, rows, n_rows, mask = _segment_case(case, np.random.default_rng(5))
    scores = scores.astype(dtype)
    want = J_SEG(jnp.asarray(scores), jnp.asarray(rows), n_rows=n_rows, mask=None if mask is None else jnp.asarray(mask))
    t_rows = rows if rows_as == "numpy" else torch.as_tensor(rows)
    t_mask = None if mask is None else (mask if rows_as == "numpy" else torch.as_tensor(mask))
    got = tnn.segment_softmax(torch.as_tensor(scores), t_rows, n_rows=n_rows, mask=t_mask)
    assert got.dtype == torch.as_tensor(scores).dtype
    _close(got, want, TOL[dtype])
    if mask is not None:
        assert bool((got[torch.as_tensor(~mask)] == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["mask", "unsorted_mask"])
def test_segment_softmax_gradient_matches_jax_grad(dtype, case):
    rng = np.random.default_rng(6)
    scores, rows, n_rows, mask = _segment_case(case, rng)
    scores = scores.astype(dtype)
    w = rng.standard_normal(scores.size).astype(dtype)

    def loss(s):
        return (jnp.asarray(w) * jnn.segment_softmax(s, jnp.asarray(rows), n_rows=n_rows, mask=jnp.asarray(mask))).sum()

    want = jax.jit(jax.grad(loss))(jnp.asarray(scores))
    s = torch.as_tensor(scores).requires_grad_(True)
    (torch.as_tensor(w) * tnn.segment_softmax(s, torch.as_tensor(rows), n_rows=n_rows, mask=torch.as_tensor(mask))).sum().backward()
    _close(s.grad, want, TOL[dtype])


# ---------------------------------------------------------------------------
# sparse attention: both routes
# ---------------------------------------------------------------------------

# the windows and global tokens of tests/test_nn.py:68-69 and :131-132
ROUTE_CASES = [(4, 0), (3, 2), (5, 0)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,n_global", ROUTE_CASES)
def test_sparse_attention_coo_route_matches_sparse_tpu(dtype, window, n_global):
    L, d, dv = 48, 8, 12
    rows, cols = jnn.local_attention_pattern(L, window, n_global)
    q, k, v = _qkv(L, d, dv, dtype, seed=6)
    # device arrays take the COO route in both packages
    want = J_ATT(*_j(q, k, v, rows, cols))
    got = tnn.sparse_attention(*_t(q, k, v, rows, cols))
    _close(got, want, TOL[dtype])
    # a mask keeps a host pattern on the COO route too
    mask = np.random.default_rng(1).random(rows.size) < 0.8
    want = J_ATT(*_j(q, k, v, rows, cols), mask=jnp.asarray(mask))
    got = tnn.sparse_attention(*_t(q, k, v), rows, cols, mask=mask)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,n_global", ROUTE_CASES)
def test_sparse_attention_ell_route_matches_sparse_tpu(dtype, window, n_global):
    L, d, dv = 48, 8, 12
    rows, cols = jnn.local_attention_pattern(L, window, n_global)
    q, k, v = _qkv(L, d, dv, dtype, seed=10)
    want = _j_host_pattern(rows, cols)(*_j(q, k, v))
    got = tnn.sparse_attention(*_t(q, k, v), rows, cols)
    _close(got, want, TOL[dtype])
    e_cols, valid = jnn.build_attention_ell(rows, cols, L)
    want = J_ELL(*_j(q, k, v, e_cols, valid))
    for ec, va in ((e_cols, valid), _t(e_cols, valid), (torch.as_tensor(e_cols).long(), valid)):
        _close(tnn.sparse_attention_ell(*_t(q, k, v), ec, va), want, TOL[dtype])


def test_sparse_attention_unsorted_and_rectangular_patterns():
    # keys fewer than queries; the pattern's entries shuffled: the port puts rows in order
    rng = np.random.default_rng(11)
    Lq, Lk, d, dv = 40, 25, 6, 5
    lin = np.unique(rng.integers(0, Lq * Lk, 300))
    rows, cols = (lin // Lk).astype(np.int32), (lin % Lk).astype(np.int32)
    perm = rng.permutation(rows.size)
    q, k, v = _qkv(Lq, d, dv, np.float64, seed=12, Lk=Lk)
    want = J_ATT(*_j(q, k, v, rows, cols))
    for r, c in ((rows[perm], cols[perm]), _t(rows[perm], cols[perm]), (rows, cols)):
        _close(tnn.sparse_attention(*_t(q, k, v), r, c), want, 1e-12)


def _memo_route(memo, rows, cols, length):
    hit = memo[(id(rows), id(cols), length)]
    return "ell" if hit[2] is not None else "coo"


@pytest.mark.parametrize("window,n_global,blowup", [(5, 0, 4.0), (3, 2, 2.0), (3, 6, 4.0), (0, 0, 1.0)])
def test_ell_route_memo_and_blowup_guard_choose_as_sparse_tpu(window, n_global, blowup):
    L, d = 64, 4
    rows, cols = jnn.local_attention_pattern(L, window, n_global)
    q, k, v = _qkv(L, d, d, np.float32, seed=13)
    # eager: the reference's memo keeps device arrays, which a jit would leak
    want = jnn.sparse_attention(*_j(q, k, v), rows, cols, max_ell_blowup=blowup)
    got = tnn.sparse_attention(*_t(q, k, v), rows, cols, max_ell_blowup=blowup)
    _close(got, want, 1e-5)
    route = _memo_route(jnn._ATTENTION_ELL_MEMO, rows, cols, L)
    assert _memo_route(tnn._ATTENTION_ELL_MEMO, rows, cols, L) == route
    # the first call's choice stands for the same arrays, whatever the blowup now
    jnn.sparse_attention(*_j(q, k, v), rows, cols, max_ell_blowup=1e9 if route == "coo" else 0.0)
    tnn.sparse_attention(*_t(q, k, v), rows, cols, max_ell_blowup=1e9 if route == "coo" else 0.0)
    assert _memo_route(jnn._ATTENTION_ELL_MEMO, rows, cols, L) == route
    assert _memo_route(tnn._ATTENTION_ELL_MEMO, rows, cols, L) == route
    # copies of the arrays are new patterns: decided anew, as there
    r2, c2 = rows.copy(), cols.copy()
    jnn.sparse_attention(*_j(q, k, v), r2, c2, max_ell_blowup=1e9)
    tnn.sparse_attention(*_t(q, k, v), r2, c2, max_ell_blowup=1e9)
    assert _memo_route(tnn._ATTENTION_ELL_MEMO, r2, c2, L) == _memo_route(jnn._ATTENTION_ELL_MEMO, r2, c2, L) == "ell"
    assert len(tnn._ATTENTION_ELL_MEMO) <= 32 and len(tnn._COO_PATTERN_MEMO) <= 32


def test_coo_pattern_kept_across_calls_and_rebuilt_after_an_edit():
    rows, cols = jnn.local_attention_pattern(32, 3, 1)
    rt, ct = _t(rows, cols)
    q, k, v = _t(*_qkv(32, 4, 4, np.float64, seed=14))
    first = tnn._coo_pattern(rt, ct, 32, 32, torch.device("cpu"))
    assert tnn._coo_pattern(rt, ct, 32, 32, torch.device("cpu")) is first
    assert first.order is not None  # a tensor pattern is sorted once, not trusted
    host = tnn._coo_pattern(rows, cols, 32, 32, torch.device("cpu"))
    assert host.order is None and host.sddmm.ordered == (True, False)  # checked sorted on the host
    before = tnn.sparse_attention(q, k, v, rt, ct)
    rt[0] = 1  # an edit in place: the kept pattern would be stale
    assert tnn._coo_pattern(rt, ct, 32, 32, torch.device("cpu")) is not first
    want = J_ATT(*_j(q.numpy(), k.numpy(), v.numpy(), rt.numpy(), ct.numpy()))
    _close(tnn.sparse_attention(q, k, v, rt, ct), want, 1e-12)
    assert not torch.equal(before, tnn.sparse_attention(q, k, v, rt, ct))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["coo", "ell"])
@pytest.mark.parametrize("window,n_global", [(3, 0), (3, 2)])
def test_sparse_attention_gradient_matches_jax_grad(dtype, route, window, n_global):
    L, d, dv = 32, 6, 5
    rows, cols = jnn.local_attention_pattern(L, window, n_global)
    q, k, v = _qkv(L, d, dv, dtype, seed=15)
    w = np.random.default_rng(16).standard_normal((L, dv)).astype(dtype)
    pattern_j = (rows, cols) if route == "ell" else _j(rows, cols)  # closed over: a host pattern stays one
    pattern_t = (rows, cols) if route == "ell" else _t(rows, cols)

    def loss(q_, k_, v_):
        return (jnp.asarray(w) * jnn.sparse_attention(q_, k_, v_, *pattern_j, max_ell_blowup=1e9)).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*_j(q, k, v))
    ins = [t.requires_grad_(True) for t in _t(q, k, v)]
    (torch.as_tensor(w) * tnn.sparse_attention(*ins, *pattern_t, max_ell_blowup=1e9)).sum().backward()
    for x, g in zip(ins, want):
        _close(x.grad, g, TOL[dtype])


def test_sparse_attention_ell_nonfinite_and_index_rules_match_sparse_tpu():
    # the reference scores over the packed [k | v] row: a non-finite v value
    # in a valid slot makes its row NaN, one in a padding slot that lane;
    # jnp.take counts a negative index from the end and fills one outside
    # the table with NaN
    q, k, v = _qkv(4, 3, 2, np.float64, seed=17, Lk=5)
    v[2, 0] = np.inf
    v[4, 1] = np.nan
    e_cols = np.array([[0, 2], [1, 4], [3, 0], [-1, 7]], dtype=np.int32)
    valid = np.array([[True, True], [True, False], [True, False], [True, False]])
    want = np.asarray(J_ELL(*_j(q, k, v, e_cols, valid)))
    got = tnn.sparse_attention_ell(*_t(q, k, v), e_cols, valid).numpy()
    assert np.isnan(got[0]).all() and np.isnan(got[3]).all()  # the row with inf in a valid slot; an index past the table
    assert np.isnan(got[1, 1]) and np.isfinite(got[1, 0])  # NaN in a padding slot: that lane only
    assert np.isfinite(got[2]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got, want, 1e-12)


def test_sparse_attention_ell_empty_and_fully_padded_rows():
    e_cols, valid = jnn.build_attention_ell(np.array([0, 2]), np.array([1, 0]), 3)
    q, k, v = _qkv(3, 4, 2, np.float64, seed=18)
    want = J_ELL(*_j(q, k, v, e_cols, valid))
    got = tnn.sparse_attention_ell(*_t(q, k, v), e_cols, valid)
    _close(got, want, 1e-12)
    assert torch.equal(got[1], torch.zeros(2, dtype=torch.float64))


def test_ell_attention_plain_and_wrapper_checks():
    q, k, v = _t(*_qkv(6, 4, 3, np.float32, seed=19))
    e_cols, valid = _t(*jnn.build_attention_ell(*jnn.local_attention_pattern(6, 1), 6))
    got = tatt.ell_attention(q, k, v, e_cols, valid, scale=0.3)
    assert torch.equal(got, tatt.ell_attention_plain(q, k, v, e_cols, valid, 0.3))
    # bfloat16 takes the plain version by dtype; mixed dtypes promote
    assert tatt.ell_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), e_cols, valid).dtype == torch.bfloat16
    assert tatt.ell_attention(q, k.double(), v, e_cols, valid).dtype == torch.float64
    with pytest.raises(ValueError, match="meta"):
        tatt.ell_attention(q, k, v, e_cols.to("meta"), valid)
    with pytest.raises(TypeError):
        tatt.ell_attention(q, k, v, e_cols.float(), valid)
    with pytest.raises(ValueError, match="slot"):
        tatt.ell_attention(q, k, v, e_cols[:, :0], valid[:, :0])
    with pytest.raises(ValueError):
        tatt.ell_attention(q, k, v, e_cols[:3], valid[:3])
    # a tensor not on the CPU never takes the plain version
    meta = [t.to("meta") for t in (q, k, v, e_cols, valid)]
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.ell_attention(*meta)


# ---------------------------------------------------------------------------
# the dense block forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,window,block,causal", [(100, 7, 16, False), (47, 3, 16, False), (64, 64, 16, False), (60, 9, 16, True), (100, 7, 32, True)])
def test_banded_attention_matches_sparse_tpu(L, window, block, causal):
    q, k, v = _qkv(L, 8, 12, np.float32, seed=20)
    want = J_BANDED(*_j(q, k, v), window=window, block=block, causal=causal)
    got = tnn.banded_attention(*_t(q, k, v), window=window, block=block, causal=causal)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_banded_attention_bf16_returns_bf16():
    q, k, v = _qkv(64, 8, 8, np.float32, seed=21)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    for causal in (False, True):
        want = np.asarray(J_BANDED(*jb, window=5, block=16, causal=causal).astype(jnp.float32))
        got = tnn.banded_attention(*tb, window=5, block=16, causal=causal)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * 2.0**-8 * np.abs(want).max())


def test_banded_attention_float64():
    q, k, v = _qkv(50, 5, 3, np.float64, seed=22)
    want = J_BANDED(*_j(q, k, v), window=4, block=8, causal=True)
    _close(tnn.banded_attention(*_t(q, k, v), window=4, block=8, causal=True), want, 1e-12)


@pytest.mark.parametrize("L,window,n_global", [(100, 7, 3), (64, 5, 0), (48, 3, 8)])
def test_longformer_attention_matches_sparse_tpu(L, window, n_global):
    q, k, v = _qkv(L, 8, 12, np.float32, seed=23)
    want = J_LONG(*_j(q, k, v), window=window, n_global=n_global, block=16)
    got = tnn.longformer_attention(*_t(q, k, v), window=window, n_global=n_global, block=16)
    _close(got, want, 1e-5)
    # and the COO route on its pattern
    rows, cols = tnn.local_attention_pattern(L, window, n_global)
    _close(tnn.sparse_attention(*_t(q, k, v, rows, cols)), want, 3e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_sparse_attention_matches_sparse_tpu(causal, dtype):
    L, blk = 64, 8
    ids, valid = jnn.bigbird_block_pattern(L, block=blk, n_window=1, n_random=2, n_global=1, seed=3)
    q, k, v = _qkv(L, 8, 12, dtype, seed=24)
    want = J_BLOCK(*_j(q, k, v, ids, valid), block=blk, causal=causal)
    got = tnn.block_sparse_attention(*_t(q, k, v), ids, valid, block=blk, causal=causal)
    _close(got, want, TOL[dtype])
    got_t = tnn.block_sparse_attention(*_t(q, k, v, ids, valid), block=blk, causal=causal)
    assert torch.equal(got, got_t)
    with pytest.raises(ValueError, match="multiples"):
        tnn.block_sparse_attention(*_t(q[:60], k, v), ids, valid, block=blk)


def test_precision_other_than_highest_raises():
    q, k, v = _t(*_qkv(32, 4, 4, np.float32, seed=25))
    ids, valid = tnn.bigbird_block_pattern(32, block=8, seed=0)
    base = tnn.banded_attention(q, k, v, window=3, block=8)
    assert torch.equal(tnn.banded_attention(q, k, v, window=3, block=8, precision="highest"), base)
    assert torch.equal(tnn.banded_attention(q, k, v, window=3, block=8, precision="HIGHEST"), base)
    for precision in ("high", "default", "bfloat16", 3):
        with pytest.raises(ValueError, match="precision"):
            tnn.banded_attention(q, k, v, window=3, block=8, precision=precision)
        with pytest.raises(ValueError, match="precision"):
            tnn.longformer_attention(q, k, v, window=3, n_global=1, block=8, precision=precision)
        with pytest.raises(ValueError, match="precision"):
            tnn.block_sparse_attention(q, k, v, ids, valid, block=8, precision=precision)


def test_tf32_setting_is_ignored_and_restored():
    q, k, v = _t(*_qkv(48, 8, 8, np.float32, seed=26))
    rows, cols = tnn.local_attention_pattern(48, 4, 2)
    x, w = _t(np.random.default_rng(27).standard_normal((48, 6)).astype(np.float32), np.random.default_rng(28).standard_normal((6, 3)).astype(np.float32))
    vals = torch.ones(rows.size)
    calls = [
        lambda: tnn.banded_attention(q, k, v, window=4, block=16),
        lambda: tnn.longformer_attention(q, k, v, window=4, n_global=2, block=16),
        lambda: tnn.block_sparse_attention(q, k, v, *tnn.bigbird_block_pattern(48, block=16, seed=1), block=16),
        lambda: tnn.graph_conv(rows, cols, vals, x, w, n_nodes=48),
    ]
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        plain = [f() for f in calls]
        torch.backends.cuda.matmul.allow_tf32 = True
        for f, want in zip(calls, plain):
            assert torch.equal(f(), want)
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------------------
# graph convolution
# ---------------------------------------------------------------------------


def _graph(n, n_edges, seed):
    """A symmetric graph with self-loops, ``D^-1/2 (A + I) D^-1/2``, canonical."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(2, n_edges))
    lin = np.unique(np.concatenate([e[0] * n + e[1], e[1] * n + e[0], np.arange(n) * (n + 1)]))
    rows, cols = lin // n, lin % n
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    return rows.astype(np.int32), cols.astype(np.int32), 1.0 / np.sqrt(deg[rows] * deg[cols])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern_as", ["numpy", "tensor"])
def test_graph_conv_matches_sparse_tpu(dtype, pattern_as):
    rows, cols, vals = _graph(60, 150, seed=29)
    vals = vals.astype(dtype)
    rng = np.random.default_rng(30)
    x, w = rng.standard_normal((60, 16)).astype(dtype), rng.standard_normal((16, 8)).astype(dtype)
    want = J_GCN(*_j(rows, cols, vals, x, w), n_nodes=60)
    pat = (rows, cols) if pattern_as == "numpy" else _t(rows, cols)
    got = tnn.graph_conv(*pat, *_t(vals, x, w), n_nodes=60)
    assert got.dtype == torch.as_tensor(x).dtype
    _close(got, want, TOL[dtype])
    # unsorted triplets: put in order, not trusted
    perm = rng.permutation(rows.size)
    _close(tnn.graph_conv(rows[perm], cols[perm], *_t(vals[perm], x, w), n_nodes=60), want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_conv_gradient_matches_jax_grad(dtype):
    rows, cols, vals = _graph(40, 100, seed=31)
    vals = vals.astype(dtype)
    rng = np.random.default_rng(32)
    x, w = rng.standard_normal((40, 7)).astype(dtype), rng.standard_normal((7, 5)).astype(dtype)
    g = rng.standard_normal((40, 5)).astype(dtype)

    def loss(vals_, x_, w_):
        return (jnp.asarray(g) * jnn.graph_conv(jnp.asarray(rows), jnp.asarray(cols), vals_, x_, w_, n_nodes=40)).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*_j(vals, x, w))
    ins = [t.requires_grad_(True) for t in _t(vals, x, w)]
    (torch.as_tensor(g) * tnn.graph_conv(rows, cols, *ins, n_nodes=40)).sum().backward()
    for t, want_g in zip(ins, want):
        _close(t.grad, want_g, TOL[dtype])


def test_graph_conv_other_dtypes_take_the_plain_version():
    rows, cols, vals = _graph(20, 40, seed=33)
    x = torch.randn(20, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(4, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    want = tnn.graph_conv(rows, cols, torch.as_tensor(vals), x, w, n_nodes=20)
    got = tnn.graph_conv(rows, cols, torch.as_tensor(vals).bfloat16(), x.bfloat16(), w.bfloat16(), n_nodes=20)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=0.05 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the module's surface
# ---------------------------------------------------------------------------

# the sequence-sharded forms come with the multi-device layer (ROADMAP.md A14)
SHARDED = {"banded_attention_sharded", "partition_attention_pattern", "sparse_attention_sharded"}


def test_nn_has_every_public_function_of_sparse_tpu_nn_but_the_sharded_ones():
    public = {
        name
        for name, obj in vars(jnn).items()
        if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj)) and obj.__module__ == jnn.__name__
    }
    assert SHARDED <= public
    # the sharded forms are ported too (tests/test_torch_partitioned.py)
    missing = sorted(n for n in public if not callable(getattr(tnn, n, None)))
    assert missing == []
    for name in public - {"BlockSparseLinearParams", "init_block_sparse_linear", "block_sparse_linear"}:
        want = [p for p in inspect.signature(getattr(jnn, name)).parameters]
        assert [p for p in inspect.signature(getattr(tnn, name)).parameters] == want, name
