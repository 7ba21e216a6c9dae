"""K6's gradient (``sparse_tpu_torch.kernels.attention``) against ``jax.grad``
of ``sparse_tpu.nn`` on the JAX CPU backend.

The same inputs, drawn with numpy from a seed, through both packages at
small sizes (L <= 64, cap <= 9, d = dv = 8 or 16). On the CPU the port's
backward is ``ell_attention_backward_plain``, the decomposition that K6's
backward kernel computes on the card (``test_torch_attention_gpu.py`` holds
the kernel against it): ``dP``, ``δ``, ``dS``, ``dq`` by rows, ``dk`` and
``dv`` summed by key. Values at the tolerances of
``test_torch_attention.py``: float64 at rtol 1e-12 and float32 at rtol 1e-5,
each with an absolute floor of the same factor times the largest finite
magnitude compared (the two sum in other orders, and the port leaves out
the row max's gradient, which cancels up to rounding); NaN in the same
places. The reference's rules for padding slots, repeated keys, indices
below 0 or outside the table, non-finite values and rows with no valid slot
are the cases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu.nn as jnn
import sparse_tpu_torch.nn as tnn
from sparse_tpu_torch.kernels import attention as tatt
from sparse_tpu_torch.kernels import dot as tdot

TOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
CASES = ["padding", "repeated_key", "negative", "outside", "nonfinite_valid", "nonfinite_padding", "empty_row"]
L, LK, CAP = 48, 40, 9


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = want[np.isfinite(want)]
    scale = float(np.abs(finite).max()) if finite.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, equal_nan=True)


def _case(case, dtype, d, seed=0):
    """``(q, k, v, e_cols, valid, g)`` as NumPy arrays: random slots, about
    a fifth of them padding, with ``case``'s edit."""
    rng = np.random.default_rng(seed)
    q, k = rng.standard_normal((L, d)).astype(dtype), rng.standard_normal((LK, d)).astype(dtype)
    v, g = rng.standard_normal((LK, d)).astype(dtype), rng.standard_normal((L, d)).astype(dtype)
    e_cols = rng.integers(0, LK, (L, CAP)).astype(np.int32)
    valid = rng.random((L, CAP)) < 0.8
    if case == "repeated_key":
        e_cols[3, 1] = e_cols[3, 4] = 7
        valid[3, [1, 4]] = True
        e_cols[5, :] = 11  # every slot the same key, padding too
    elif case == "negative":
        e_cols[2, :4] = [-1, -LK, -7, -20]
        valid[2, :4] = [True, True, False, True]
        e_cols[9, 8] = -3  # a padding slot
        valid[9, 8] = False
    elif case == "outside":
        e_cols[4, 2] = LK  # past the table in a valid slot: the row NaN
        valid[4, 2] = True
        e_cols[6, 0] = -LK - 1  # before the table in a padding slot
        valid[6, 0] = False
        e_cols[8, 3] = LK + 5  # outside the table in a row with no valid slot
        valid[8] = False
    elif case == "nonfinite_valid":
        e_cols[1, 0] = 13
        valid[1, 0] = True
        v[13, 2] = np.inf
    elif case == "nonfinite_padding":
        e_cols[10, 5] = LK - 1
        valid[10, 5] = False
        e_cols[:, :][e_cols == LK - 1] = LK - 2  # no other slot names it
        e_cols[10, 5] = LK - 1
        v[LK - 1, 0] = np.nan
    elif case == "empty_row":
        valid[12] = False
        valid[30:33] = False
    return q, k, v, e_cols, valid, g


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@jax.jit
def _jax_ell_grads(q, k, v, e_cols, valid, g):
    return jax.grad(lambda a, b, c: (g * jnn.sparse_attention_ell(a, b, c, e_cols, valid)).sum(), argnums=(0, 1, 2))(q, k, v)


def _torch_ell_grads(q, k, v, e_cols, valid, g):
    ins = [t.requires_grad_(True) for t in _t(q, k, v)]
    out = tatt.ell_attention(*ins, *_t(e_cols, valid))
    return torch.autograd.grad(out, ins, torch.as_tensor(g))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("case", CASES)
def test_ell_attention_gradient_matches_jax_grad(case, d, dtype):
    q, k, v, e_cols, valid, g = _case(case, dtype, d)
    want = _jax_ell_grads(*_j(q, k, v, e_cols, valid, g))
    got = _torch_ell_grads(q, k, v, e_cols, valid, g)
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])
    if case == "outside":
        assert bool(torch.isnan(got[0][4]).all()) and bool(torch.isnan(got[0][8]).all())
    if case == "nonfinite_valid":
        assert bool(torch.isnan(got[0][1]).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern", ["window", "window_global", "scattered"])
def test_sparse_attention_ell_route_gradient_matches_jax_grad(pattern, dtype):
    n, d = 64, 16
    if pattern == "scattered":  # random edges, a row with none, an edge twice
        rng = np.random.default_rng(3)
        rows = np.sort(rng.integers(0, n, 300)).astype(np.int32)
        rows = rows[rows != 17]
        cols = rng.integers(0, n, rows.size).astype(np.int32)
        cols[1] = cols[0] = 5
        rows[1] = rows[0]
    else:
        rows, cols = jnn.local_attention_pattern(n, 4, 2 if pattern == "window_global" else 0)
    rng = np.random.default_rng(4)
    q, k, v, w = (rng.standard_normal((n, d)).astype(dtype) for _ in range(4))

    def loss(q_, k_, v_):
        return (jnp.asarray(w) * jnn.sparse_attention(q_, k_, v_, rows, cols, max_ell_blowup=1e9)).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*_j(q, k, v))
    ins = [t.requires_grad_(True) for t in _t(q, k, v)]
    (torch.as_tensor(w) * tnn.sparse_attention(*ins, rows, cols, max_ell_blowup=1e9)).sum().backward()
    assert tnn._ATTENTION_ELL_MEMO[(id(rows), id(cols), n)][2] is not None  # the row-ELL route
    for x, y in zip(ins, want):
        _close(x.grad, y, TOL[dtype])


@pytest.mark.parametrize("case", CASES)
def test_backward_plain_equals_the_recompute_gradients(case):
    # the plain decomposition against autograd through ell_attention_plain (the old backward), float64
    q, k, v, e_cols, valid, g = _t(*_case(case, np.float64, 8, seed=1))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tatt.ell_attention_plain(*ins, e_cols, valid, 0.3), ins, g)
    got = tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 0.3, g)
    for x, y in zip(got, want):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        ok = ~torch.isnan(y)
        assert float((x[ok] - y[ok]).abs().max()) <= 1e-12


@pytest.mark.parametrize("case", ["padding", "negative", "outside", "nonfinite_padding"])
def test_slot_pattern_sums_equal_the_plain_backward(case):
    # dk and dv as the card takes them: K5's function over attention_slot_pattern, by key
    q, k, v, e_cols, valid, g = _t(*_case(case, np.float64, 8, seed=2))
    dq, ds, p = tatt.ell_attention_backward_rows_plain(q, k, v, e_cols, valid, 0.3, g)
    layouts = {}
    pattern = tatt.attention_slot_pattern(e_cols, valid, LK, layouts)
    assert tatt.attention_slot_pattern(e_cols, valid, LK, layouts) is pattern and pattern.kept
    assert pattern.sizes == (L, LK + 1) and pattern.ordered[0]
    dk = tdot._row_sum_forward(pattern, 1, ds.reshape(-1), q * 0.3)[:LK]
    dv = tdot._row_sum_forward(pattern, 1, p.reshape(-1), g)[:LK]
    want = tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 0.3, g)
    for x, y in zip((dq, dk, dv), want):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        ok = ~torch.isnan(y)
        assert float((x[ok] - y[ok]).abs().max()) <= 1e-12


def test_gradient_of_other_dtypes_and_once_differentiable():
    q, k, v, e_cols, valid, g = _t(*_case("padding", np.float32, 8, seed=5))
    ins = [t.bfloat16().requires_grad_(True) for t in (q, k, v)]
    out = tatt.ell_attention(*ins, e_cols, valid)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, ins, g.bfloat16())
    want = tatt.ell_attention_backward_plain(q, k, v, e_cols, valid, 1 / np.sqrt(8), g)
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert float((x.float() - y).abs().max()) <= 0.05 * float(y.abs().max())
    ins = [t.double().requires_grad_(True) for t in (q, k, v)]
    dq = torch.autograd.grad(tatt.ell_attention(*ins, e_cols, valid).sum(), ins[0], create_graph=True)[0]
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dq.sum(), ins[0])
