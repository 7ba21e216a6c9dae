"""K6's backward tile route on the CPU: its arithmetic in torch ops
(``ell_attention_backward_blocks_plain``: ``δ = g · out``, the row maxima
and sums again over the union in chunks, ``p̂``, ``dP``, ``dŝ``, ``dq`` by
``(count ⊙ dŝ) · k``, the strips by each slot's union place) against the row
decomposition (``ell_attention_backward_rows_plain``), and with K5's plain
row sum over the slot pattern against ``jax.grad`` of
``sparse_tpu.nn.sparse_attention_ell`` on the JAX CPU backend.

The same inputs as ``test_torch_attention_backward.py`` (numpy from a seed,
L = 48, 40 keys, cap 9, d = dv = 8 or 16), in blocks of 16 and 32 rows.
Tolerances as there: float64 at rtol 1e-12 and float32 at 1e-5, each with
an absolute floor of the same factor times the largest finite magnitude
compared (the block form sums over the union in chunks and takes ``δ`` from
``g · out``, the row form over the slots and ``δ`` from ``Σ p dP``); NaN in
the same places. The kernel itself runs on the card
(``test_torch_attention_gpu.py``).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX CPU backend, through test_torch_attention_backward)

from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.kernels import attention as tatt
from sparse_tpu_torch.kernels import dot as tdot
from test_torch_attention_backward import CASES, DTYPES, LK, TOL, _case, _close, _j, _jax_ell_grads, _t

BLOCKS = [16, 32]


def _blocks_backward(case, dtype, d, block, ratio=tatt.ATTENTION_UNION_RATIO, chunk=64):
    """``(inputs, blocks, (dq, ds, p))`` of the block form at the default
    scale ``1/sqrt(d)``, ``out`` the plain forward's."""
    q, k, v, e_cols, valid, g = _t(*_case(case, dtype, d))
    scale = 1 / np.sqrt(d)
    out = tatt.ell_attention_plain(q, k, v, e_cols, valid, scale)
    blocks = tatt.build_attention_blocks(e_cols, valid, LK, block, ratio=ratio)
    got = tatt.ell_attention_backward_blocks_plain(q, k, v, g, out, blocks, scale, chunk=chunk)
    return (q, k, v, e_cols, valid, g), blocks, got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", CASES)
def test_backward_blocks_plain_equals_the_row_decomposition(case, block, d, dtype):
    (q, k, v, e_cols, valid, g), blocks, got = _blocks_backward(case, dtype, d, block)
    scale = 1 / np.sqrt(d)
    want = tatt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, scale, g)
    for name, x, y in zip(("dq", "ds", "p"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        _close(x, y.numpy(), TOL[dtype])
    route = tatt._backward_block_route(q, k, v, g, tatt.ell_attention_plain(q, k, v, e_cols, valid, scale), blocks, scale)
    if case in ("padding", "repeated_key", "negative", "empty_row"):  # every block on the tile arithmetic
        assert not bool(route.any())
    else:  # an index outside the table or a non-finite value: that block on the row decomposition
        assert bool(route.any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", CASES)
def test_backward_blocks_plain_and_k5_sums_match_jax_grad(case, block, d, dtype):
    # dk and dv as the card takes them: K5's function over attention_slot_pattern, by key
    (q, k, v, e_cols, valid, g), _, (dq, ds, p) = _blocks_backward(case, dtype, d, block)
    pattern = tatt.attention_slot_pattern(e_cols, valid, LK, {})
    dk = tdot._row_sum_forward(pattern, 1, ds.reshape(-1), q / np.sqrt(d))[:LK]
    dv = tdot._row_sum_forward(pattern, 1, p.reshape(-1), g)[:LK]
    want = _jax_ell_grads(*_j(*(x.numpy() for x in (q, k, v, e_cols, valid, g))))
    for x, y in zip((dq, dk, dv), want):
        _close(x, y, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["padding", "outside", "nonfinite_valid"])
def test_backward_blocks_plain_with_every_block_on_the_row_route(case, dtype):
    # a union capacity of one key: every block flagged by the rule, the row decomposition on every row
    (q, k, v, e_cols, valid, g), blocks, got = _blocks_backward(case, dtype, 8, 16, ratio=1e-3)
    assert bool(blocks.flag.all()) and blocks.union.shape[1] == 1
    want = tatt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, 1 / np.sqrt(8), g)
    for x, y in zip(got, want):
        _close(x, y.numpy(), TOL[dtype])


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_backward_blocks_plain_chunking_changes_nothing_but_rounding(chunk):
    (q, k, v, e_cols, valid, g), _, got = _blocks_backward("repeated_key", np.float64, 16, 32, chunk=chunk)
    want = tatt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, 1 / np.sqrt(16), g)
    for x, y in zip(got, want):
        _close(x, y.numpy(), 1e-12)


def test_backward_blocks_plain_strips_by_union_place():
    # the strips of a duplicated key: both valid slots get their key's p̂ and dŝ, a padding slot naming it 0 and 0
    (q, k, v, e_cols, valid, g), blocks, (dq, ds, p) = _blocks_backward("repeated_key", np.float64, 8, 16)
    places = tatt.union_places(blocks, tatt.build_strip_order(blocks))
    assert int(places[3, 1]) == int(places[3, 4]) >= 0
    assert float(p[3, 1]) == float(p[3, 4]) > 0 and float(ds[3, 1]) == float(ds[3, 4])
    pad = ~valid
    assert bool((places[pad] == -1).all()) and bool((p[pad] == 0).all()) and bool((ds[pad] == 0).all())
    # each row's weights sum to 1 over its valid slots (to rounding), its dŝ to 0
    rows = valid.any(1)
    np.testing.assert_allclose(p[rows].sum(1).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(ds[rows].sum(1).numpy(), 0.0, atol=1e-12 * float(ds.abs().max()))


def test_backward_tile_route_shapes_and_fit():
    configs = _cuda.ATTENTION_BWD_TILE_CONFIGS
    for name, (cid, rows, slices, ctas, chunk) in configs.items():
        # the forward's layout; a stage splits evenly over the key slices; a CTA's threads over a block's rows
        assert rows == _cuda.ATTENTION_BLOCK_ROWS and chunk % (8 * slices) == 0 and ctas in (1, 2) and slices * rows % 64 == 0, name
    assert sorted(cid for cid, *_ in configs.values()) == list(range(len(configs)))
    assert {*_cuda.ATTENTION_BWD_TILES_FEW, *_cuda.ATTENTION_BWD_TILES_MANY} == set(configs)
    f32 = torch.float32

    def fits(d, dv, dtype=f32, order=(*_cuda.ATTENTION_BWD_TILES_FEW, *_cuda.ATTENTION_BWD_TILES_MANY)):
        return [c for c in order if _cuda.attention_backward_tiles_fit(d, dv, dtype, c)]

    # the card tests' widths: every one has a shape among the entry points' (the first that fits runs)
    for d, dv in ((64, 64), (8, 8), (128, 128), (16, 40), (128, 8)):
        assert fits(d, dv, order=_cuda.ATTENTION_BWD_TILES_FEW) and fits(d, dv, order=_cuda.ATTENTION_BWD_TILES_MANY), (d, dv)
    assert fits(128, 128) == ["b64c16x2", "b64c16x2"]  # only 16-key stages leave room for 128-wide rows
    # every entry of a preference list runs at some widths: none needs the room of one before it
    widths = [(d, dv) for d in range(8, 129, 8) for dv in range(8, 129, 8)]
    for order in (_cuda.ATTENTION_BWD_TILES_FEW, _cuda.ATTENTION_BWD_TILES_MANY):
        for i, name in enumerate(order):
            assert any(fits(d, dv, order=order[: i + 1]) == [name] for d, dv in widths), (order, name)
    assert not fits(64, 64, torch.float64)  # float64 takes the row kernel
    assert not fits(20, 64) and not fits(64, 20)  # widths not multiples of 8
    assert not fits(136, 64) and not fits(64, 136)  # dQ's registers and the forward's dv bound
    # b64c32x2w16 at d = dv = 64: qs and g (hi, lo), two stages, K twice and V once (hi, lo), the strip tile,
    # the rows' δ, shift and sum and the stage's run offsets, every warp's (m, l), the flag words
    want = 64 * 128 * 8 + 2 * 32 * (68 * 4 * 2 + 64) + 32 * 192 * 8 + 2 * 64 * 40 * 4 + 64 * 12 + 36 * 4 + 2 * 4 * 64 * 8 + 16
    assert _cuda.attention_backward_tile_smem("b64c32x2w16", 64, 64) == want
    # b64c16x2 at d = dv = 128: the CTAs' dQ partials lie over everything before the rows' area
    assert _cuda.attention_backward_tile_smem("b64c16x2", 128, 128) <= 232448 < _cuda.attention_backward_tile_smem("b64c32x2", 128, 128)


def test_backward_blocks_plain_cpu_path_and_saved_output():
    # on the CPU the entry point's backward is the row decomposition; the forward's output is kept for δ
    q, k, v, e_cols, valid, g = _t(*_case("padding", np.float32, 8))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tatt.ell_attention(*ins, e_cols, valid)
    assert any(t is not None and t.shape == out.shape for t in out.grad_fn.saved_tensors if isinstance(t, torch.Tensor))
    got = torch.autograd.grad(out, ins, g)
    want = tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 1 / np.sqrt(8), g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
