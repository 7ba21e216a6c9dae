"""K6's tile route on the CPU: its block layout (``build_attention_blocks``)
against a NumPy construction, array for array, and its arithmetic in torch
ops (``ell_attention_blocks_plain``: the union in chunks, the online row
maximum and sum, counts as weights) against ``sparse_tpu.nn`` on the JAX CPU
backend, float64 at rtol 1e-12 and float32 at rtol 1e-5, each with an
absolute floor of the same factor times the largest magnitude compared (the
two sum in another order: over the union in chunks, rescaled as the maximum
grows, against XLA's sums over the slots). The kernel itself runs on the
card (``test_torch_attention_gpu.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu.nn as jnn
from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.kernels import attention as tatt

TOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
J_ELL = jax.jit(jnn.sparse_attention_ell)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, equal_nan=True)


def _np_blocks(e_cols, valid, n_keys, block, ratio):
    """The layout by loops: each block's slots resolved as ``jnp.take`` reads
    them, the union of the keys inside the table, the valid slots counted,
    each counted slot's union place (else -1), each block's slots in the
    backward's order (by group of 8 places, the others last, then row,
    place, slot; each as 8 · slot + place % 8) and where each group's run
    begins."""
    n_rows, cap = e_cols.shape
    n_blocks = -(-n_rows // block)
    u_cap = max(1, min(int(ratio * cap), block * cap, n_keys))
    union = np.zeros((n_blocks, u_cap), np.int32)
    n_union = np.zeros(n_blocks, np.int32)
    count = np.zeros((n_blocks, u_cap, block), np.uint8)
    flag = np.zeros(n_blocks, bool)
    slot = np.full((n_rows, cap), -1, np.int64)
    order = np.zeros(n_rows * cap, np.int32)
    n_groups = -(-u_cap // 8)
    begin = np.zeros((n_blocks, n_groups + 2), np.int32)
    for b in range(n_blocks):
        r0, r1 = b * block, min((b + 1) * block, n_rows)
        c = e_cols[r0:r1].astype(np.int64)
        c = np.where(c < 0, c + n_keys, c)
        inside = (c >= 0) & (c < n_keys)
        keys = np.unique(c[inside])
        n_union[b] = keys.size
        union[b, : min(keys.size, u_cap)] = keys[:u_cap]
        cnt = np.zeros((u_cap, block), np.int64)
        for r in range(r1 - r0):
            for j in range(cap):
                if valid[r0 + r, j] and inside[r, j]:
                    u = int(np.searchsorted(keys, c[r, j]))
                    if u < u_cap:
                        cnt[u, r] += 1
                        slot[r0 + r, j] = u
        flag[b] = bool((~inside).any()) or keys.size > u_cap or cnt.max() > 255
        count[b] = np.minimum(cnt, 255)
        place = slot[r0:r1].reshape(-1)
        group = np.where(place >= 0, place // 8, n_groups)  # groups of 8 places, the uncounted last
        ranked = sorted(range(place.size), key=lambda f: (group[f], f // cap, max(place[f], 0), f % cap))
        order[r0 * cap : r1 * cap] = [8 * f + max(place[f], 0) % 8 for f in ranked]
        begin[b] = np.searchsorted(np.sort(group), np.arange(n_groups + 2))
        begin[b, n_groups + 1] = place.size
    return union, n_union, count, flag, slot, order, begin


def _layout_case(case, rng):
    """``(e_cols, valid, n_keys)``."""
    if case == "window":
        e, va = jnn.build_attention_ell(*jnn.local_attention_pattern(70, 6), 70)
        return np.asarray(e), np.asarray(va), 70
    if case == "duplicates_and_invalid_rows":  # slots naming one key twice, rows with no valid slot
        e = rng.integers(0, 12, (45, 7)).astype(np.int32)
        e[:, 1] = e[:, 0]
        va = rng.random((45, 7)) < 0.7
        va[3] = False
        va[40:] = False
        return e, va, 12
    if case == "negative_and_outside":  # from the end, past the table, before it; Lk < L
        e = rng.integers(-30, 30, (50, 5)).astype(np.int64)
        e[7, 2], e[33, 0] = 30, -31
        return e, rng.random((50, 5)) < 0.8, 30
    if case == "wide_keys":  # Lk > L, L not a multiple of the block
        return rng.integers(0, 500, (37, 9)).astype(np.int32), rng.random((37, 9)) < 0.9, 500
    if case == "count_past_255":  # one row names one key in 300 valid slots
        e = rng.integers(0, 40, (20, 300)).astype(np.int32)
        e[5] = 3
        return e, np.ones((20, 300), bool), 40
    raise ValueError(case)


LAYOUT_CASES = ["window", "duplicates_and_invalid_rows", "negative_and_outside", "wide_keys", "count_past_255"]


@pytest.mark.parametrize("case", LAYOUT_CASES)
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("ratio", [tatt.ATTENTION_UNION_RATIO, 1e9])
def test_build_attention_blocks_equals_a_numpy_construction(case, block, ratio):
    e, va, n_keys = _layout_case(case, np.random.default_rng(LAYOUT_CASES.index(case)))
    got = tatt.build_attention_blocks(torch.as_tensor(e), torch.as_tensor(va), n_keys, block, ratio=ratio)
    want = _np_blocks(e, va, n_keys, block, ratio)
    assert (got.block, got.n_rows, got.n_keys) == (block, e.shape[0], n_keys)
    strips = tatt.build_strip_order(got)
    fields = ("union", "n_union", "count", "flag", "places", "order", "begin")
    dtypes = (torch.int32, torch.int32, torch.uint8, torch.bool, torch.int64, torch.int32, torch.int32)
    for name, dt, g, w in zip(fields, dtypes, (*got[3:7], tatt.union_places(got, strips), *strips), want):
        assert g.dtype == dt, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.cols is not None and got.valid is not None
    if case == "negative_and_outside":
        assert bool(got.flag[7 // block]) and bool(got.flag[33 // block])
    if case == "count_past_255":
        assert bool(got.flag[5 // block])


def test_union_capacity_is_the_route_rule():
    assert tatt.union_capacity(513, 1 << 20, 64) == int(tatt.ATTENTION_UNION_RATIO * 513)
    assert tatt.union_capacity(513, 300, 64) == 300  # never past the keys
    assert tatt.union_capacity(3, 4096, 2, ratio=1e9) == 6  # never past what the block's slots can name
    assert tatt.union_capacity(1, 1, 64, ratio=0.1) == 1


def _qkv(L, d, dv, dtype, seed, Lk=None):
    rng = np.random.default_rng(seed)
    Lk = L if Lk is None else Lk
    return (
        rng.standard_normal((L, d)).astype(dtype),
        rng.standard_normal((Lk, d)).astype(dtype),
        rng.standard_normal((Lk, dv)).astype(dtype),
    )


def _bigbird_ell(L, block, seed):
    """A BigBird-like row-ELL pattern: each query block attends whole key blocks (window, random, global)."""
    ids, ok = jnn.bigbird_block_pattern(L, block=block, n_window=1, n_random=2, n_global=1, seed=seed)
    rows, cols = [], []
    for qb in range(ids.shape[0]):
        for kb in ids[qb][ok[qb]]:
            r, c = np.meshgrid(np.arange(qb * block, (qb + 1) * block), np.arange(kb * block, (kb + 1) * block), indexing="ij")
            rows.append(r.ravel())
            cols.append(c.ravel())
    lin = np.unique(np.concatenate(rows) * L + np.concatenate(cols))
    return jnn.build_attention_ell((lin // L).astype(np.int32), (lin % L).astype(np.int32), L)


def _pattern(kind, L, rng):
    if kind == "window":
        return jnn.build_attention_ell(*jnn.local_attention_pattern(L, 20), L)
    if kind == "bigbird":
        return _bigbird_ell(L, 16, seed=3)
    e = rng.integers(0, L, (L, 24)).astype(np.int32)  # scattered
    return e, rng.random((L, 24)) < 0.85


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["window", "bigbird", "scattered"])
@pytest.mark.parametrize("block,ratio", [(32, tatt.ATTENTION_UNION_RATIO), (64, 1e9), (16, 2.0)])
def test_ell_attention_blocks_plain_matches_sparse_tpu(dtype, kind, block, ratio):
    L, d, dv = 160, 16, 8
    rng = np.random.default_rng(20)
    e, va = (np.asarray(x) for x in _pattern(kind, L, rng))
    q, k, v = _qkv(L, d, dv, dtype, seed=21)
    blocks = tatt.build_attention_blocks(torch.as_tensor(e), torch.as_tensor(va), L, block, ratio=ratio)
    got = tatt.ell_attention_blocks_plain(*(torch.as_tensor(x) for x in (q, k, v)), blocks, 0.3)
    want = J_ELL(*(jnp.asarray(x) for x in (q, k, v, e, va)), scale=0.3)
    _close(got, want, TOL[dtype])
    if ratio == 1e9 or kind != "scattered":  # the chunked softmax itself ran, not only the row route
        assert not bool(blocks.flag.all())


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_ell_attention_blocks_plain_chunking_changes_nothing_but_rounding(chunk):
    q, k, v = (torch.as_tensor(x) for x in _qkv(100, 8, 8, np.float64, seed=22))
    e, va = (torch.as_tensor(x) for x in jnn.build_attention_ell(*jnn.local_attention_pattern(100, 30), 100))
    blocks = tatt.build_attention_blocks(e, va, 100, 32)
    assert not bool(blocks.flag.any())
    got = tatt.ell_attention_blocks_plain(q, k, v, blocks, 0.5, chunk=chunk)
    _close(got, tatt.ell_attention_plain(q, k, v, e, va, 0.5), 1e-12)


def test_ell_attention_blocks_plain_nonfinite_and_index_rules_match_sparse_tpu():
    # blocks with a non-finite value in q, k or v, or an index outside the
    # table, take the row route, whose rules are the reference's
    L, Lk = 96, 40
    rng = np.random.default_rng(23)
    q, k, v = _qkv(L, 8, 4, np.float64, seed=24, Lk=Lk)
    e = rng.integers(0, Lk, (L, 6)).astype(np.int32)
    va = rng.random((L, 6)) < 0.8
    v[e[0, 0], 1] = np.inf  # block 0
    k[e[40, 2], 0] = np.nan  # block 1
    q[70, 3] = np.inf  # block 2
    e[90, 1] = Lk + 3  # block 2: past the table
    blocks = tatt.build_attention_blocks(torch.as_tensor(e), torch.as_tensor(va), Lk, 32, ratio=1e9)
    got = tatt.ell_attention_blocks_plain(*(torch.as_tensor(x) for x in (q, k, v)), blocks, 0.25)
    want = np.asarray(J_ELL(*(jnp.asarray(x) for x in (q, k, v, e, va)), scale=0.25))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    _close(got, want, 1e-12)
    route = tatt._block_route(*(torch.as_tensor(x) for x in (q, k, v)), blocks, 0.25)
    assert route.tolist() == [bool(np.isin(e[:32], np.flatnonzero(~np.isfinite(v).all(1))).any()), True, True]


def test_attention_blocks_memo_rebuilds_after_an_edit_in_place():
    e, va = (torch.as_tensor(x) for x in jnn.build_attention_ell(*jnn.local_attention_pattern(64, 5), 64))
    first = tatt.attention_blocks(e, va, 64, 32)
    assert tatt.attention_blocks(e, va, 64, 32) is first
    assert tatt.attention_blocks(e, va, 64, 64) is not first  # another block size: its own layout
    e[0, 0] = 63  # an edit of e_cols
    second = tatt.attention_blocks(e, va, 64, 32)
    assert second is not first and int(second.n_union[0]) == int(first.n_union[0]) + 1  # key 63 joins block 0's union
    np.testing.assert_array_equal(second.union.numpy(), _np_blocks(e.numpy(), va.numpy(), 64, 32, tatt.ATTENTION_UNION_RATIO)[0])
    va[1, :] = False  # an edit of valid
    third = tatt.attention_blocks(e, va, 64, 32)
    assert third is not second and int(third.count[0, :, 1].sum()) == 0
    # a copy is another pattern; a dict the caller keeps holds its own
    layouts = {}
    kept = tatt.attention_blocks(e.clone(), va, 64, 32, layouts)
    assert layouts == {(64, 32): kept} and tatt.attention_blocks(e, va, 64, 32, layouts) is kept
    assert len(tatt._BLOCKS_MEMO) <= tatt._BLOCKS_MEMO_SIZE


def test_strip_order_is_built_only_when_asked_and_kept_beside_the_layout():
    # the forward's layout holds no strip order; the backward's is built once, in the same dict
    e, va = (torch.as_tensor(x) for x in jnn.build_attention_ell(*jnn.local_attention_pattern(70, 6), 70))
    layouts = {}
    blocks = tatt.attention_blocks(e, va, 70, 32, layouts)
    assert layouts == {(70, 32): blocks} and not hasattr(blocks, "order")
    strips = tatt.attention_strip_order(e, va, 70, 32, layouts)
    assert layouts == {(70, 32): blocks, ("strips", 70, 32): strips}
    assert tatt.attention_strip_order(e, va, 70, 32, layouts) is strips
    want = _np_blocks(e.numpy(), va.numpy(), 70, 32, tatt.ATTENTION_UNION_RATIO)
    np.testing.assert_array_equal(strips.order.numpy(), want[5])
    np.testing.assert_array_equal(strips.begin.numpy(), want[6])
    # by identity, after an edit in place: a new layout and a new strip order
    first = tatt.attention_strip_order(e, va, 70, 32)
    assert tatt.attention_strip_order(e, va, 70, 32) is first
    va[2, :] = False
    again = tatt.attention_strip_order(e, va, 70, 32)
    assert again is not first
    np.testing.assert_array_equal(again.order.numpy(), _np_blocks(e.numpy(), va.numpy(), 70, 32, tatt.ATTENTION_UNION_RATIO)[5])


def test_tile_route_shapes_and_fit():
    for name, (cid, rows, slices, ctas, chunk) in _cuda.ATTENTION_TILE_CONFIGS.items():
        # one layout serves every shape; a stage splits evenly over the key slices; a CTA's threads over a block's rows
        assert rows == _cuda.ATTENTION_BLOCK_ROWS and chunk % (8 * slices) == 0 and ctas in (1, 2) and slices * rows % 64 == 0, name
    assert {*_cuda.ATTENTION_TILES_FEW, *_cuda.ATTENTION_TILES_MANY} == set(_cuda.ATTENTION_TILE_CONFIGS)
    f32 = torch.float32

    def fits(d, dv, dtype=f32):
        return any(_cuda.attention_tiles_fit(d, dv, dtype, c) for c in (*_cuda.ATTENTION_TILES_FEW, *_cuda.ATTENTION_TILES_MANY))

    assert fits(64, 64) and fits(8, 8) and fits(128, 128) and fits(16, 40)
    assert not fits(64, 64, torch.float64)  # float64 takes the row kernel
    assert not fits(20, 64) and not fits(64, 20)  # widths not multiples of 8
    assert not fits(64, 136)  # dv past 128
    assert not fits(2048, 64)  # shared memory past a CTA's
    assert not _cuda.attention_tiles_fit(128, 128, f32, "b64x2w16") and _cuda.attention_tiles_fit(128, 128, f32, "b64c32x2")
    # b64x2w16: q's hi and lo, two stages of 64 keys (k and v rows padded by 4 floats, counts), their fragments
    assert _cuda.attention_tile_smem("b64x2w16", 64, 64) == 64 * 64 * 8 + 2 * 64 * (68 * 4 * 2 + 64) + 64 * 128 * 8 + 16
    # b64x2w16 at d = 8: the partials of two CTAs of 16 warps are past the stages
    assert _cuda.attention_tile_smem("b64x2w16", 8, 128) == 64 * 8 * 8 + 2 * 64 * 4 * 130 * 4 + 16


def test_ell_attention_layouts_keyword_and_cpu_path():
    q, k, v = (torch.as_tensor(x) for x in _qkv(40, 8, 8, np.float32, seed=25))
    e, va = (torch.as_tensor(x) for x in jnn.build_attention_ell(*jnn.local_attention_pattern(40, 3), 40))
    layouts = {}
    got = tatt.ell_attention(q, k, v, e, va, scale=0.3, layouts=layouts)
    assert torch.equal(got, tatt.ell_attention_plain(q, k, v, e, va, 0.3))
    assert layouts == {}  # the CPU runs the plain version: no layout is built
