"""The port's SDDMM (``kernels.sddmm``, ``sddmm``, its gradient) and the
ported ``jitops`` functions against sparse_tpu's own results (CPU).

Same inputs, drawn with numpy from a seed, through both packages. Values:
float64 at rtol 1e-12, float32 at rtol 1e-5 (the two sum each entry's
products in another order), float16 at rtol 1e-3 (both sum in float32 and
round once), integers exactly; dtypes, coordinates, shapes, fill values and
output types equal. The gradients pass ``gradcheck``/``gradgradcheck`` and
match ``jax.grad`` of the same loss at rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu import jitops as jjit
from sparse_tpu import kernels as jk
from sparse_tpu_torch import jitops as tjit
from sparse_tpu_torch import kernels as tk
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"
RTOL = {np.float64: 1e-12, np.float32: 1e-5, np.float16: 1e-3, np.complex128: 1e-12, np.int64: 0}


def _coo(m, n, nnz, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * n, size=nnz))
    return (lin // n).astype(np.int32), (lin % n).astype(np.int32), rng.standard_normal(lin.size).astype(dtype)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _jsddmm(*arrays):
    return np.asarray(jk.sddmm(*(jnp.asarray(x) for x in arrays)))


def _values(x, dtype, rng):
    if np.issubdtype(dtype, np.integer):
        return np.round(x * 3).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        return (x + 1j * rng.standard_normal(x.shape)).astype(dtype)
    return x.astype(dtype)


def _sample(dtype, seed=0, shape=(40, 30), density=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * (rng.random(shape) < density)
    return _values(x, dtype, rng)


def _assert_same_sddmm(got, want, rtol):
    assert isinstance(got, st.COO) and isinstance(want, jsp.COO)
    assert got.shape == want.shape and got.data.device.type == "cpu"
    assert numpy_dtype(got.dtype) == np.asarray(want.data).dtype
    assert got.fill_value == want.fill_value and np.asarray(got.fill_value).dtype == np.asarray(want.fill_value).dtype
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=rtol, atol=rtol)


# ---------------------------------------------------------------------------
# kernels.sddmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("size", ["monolithic", "chunked"])
def test_kernel_sddmm_matches_sparse_tpu(dtype, size):
    rng = np.random.default_rng(11)
    if size == "chunked":  # tests/test_kernels.py's chunked problem: nnz past SDDMM_CHUNK_MIN_NNZ
        m = n = 2048
        k, nnz = 16, tk.dot.SDDMM_CHUNK_MIN_NNZ + 1234
        rows = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
        cols = rng.integers(0, n, nnz).astype(np.int32)
    else:
        m, n, k = 40, 30, 6
        rows, cols, _ = _coo(m, n, 120, 4)
        nnz = rows.size
    vals = rng.random(nnz).astype(dtype)
    lhs = rng.random((m, k)).astype(dtype)
    rhs = rng.random((k, n)).astype(dtype)
    want = _jsddmm(rows, cols, vals, lhs, rhs)
    got = tk.sddmm(_t(rows), _t(cols), _t(vals), _t(lhs), _t(rhs))
    assert got.dtype == torch.float32 if dtype == np.float32 else got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype])
    plain = tk.sddmm_plain(_t(rows), _t(cols), _t(vals), _t(lhs), _t(rhs))
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL[dtype])


def test_kernel_sddmm_promotes_and_checks():
    rows, cols, data = _coo(10, 9, 25, 3)
    lhs = np.linspace(-1, 1, 50).reshape(10, 5).astype(np.float32)
    rhs = np.linspace(1, -1, 45).reshape(5, 9)
    want = _jsddmm(rows, cols, data, lhs, rhs)
    got = tk.sddmm(_t(rows), _t(cols), _t(data), _t(lhs), _t(rhs))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        tk.sddmm(_t(rows), _t(cols), _t(data), _t(lhs), _t(rhs.T))
    with pytest.raises(ValueError, match="one length"):
        tk.sddmm(_t(rows), _t(cols[:-1]), _t(data), _t(lhs), _t(rhs))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tk.sddmm(rows, _t(cols), _t(data), _t(lhs), _t(rhs))


def test_kernel_sddmm_takes_any_layout_of_lhs_and_rhs():
    rows, cols, data = _coo(30, 20, 80, 5)
    rng = np.random.default_rng(6)
    lhs, rhs = rng.standard_normal((30, 7)), rng.standard_normal((7, 20))
    want = tk.sddmm(_t(rows), _t(cols), _t(data), _t(lhs), _t(rhs))
    for lh in (_t(lhs), _t(lhs.T.copy()).T):
        for rh in (_t(rhs), _t(rhs.T.copy()).T, _t(np.pad(rhs, ((0, 0), (1, 2))))[:, 1:-2]):
            assert torch.equal(tk.sddmm(_t(rows), _t(cols), _t(data), lh, rh), want)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grad_inputs():
    # tests/test_autodiff.py::test_sddmm_grads's inputs
    rows, cols, data = _coo(10, 9, 25, 3)
    lhs = np.linspace(-1, 1, 10 * 5).reshape(10, 5)
    rhs = np.linspace(1, -1, 5 * 9).reshape(5, 9)
    return rows, cols, data, lhs, rhs


def test_sddmm_gradcheck_and_gradgradcheck():
    rows, cols, data, lhs, rhs = _grad_inputs()
    ins = tuple(_t(x).requires_grad_(True) for x in (data, lhs, rhs))
    f = lambda d, l, r: tk.sddmm(_t(rows), _t(cols), d, l, r)  # noqa: E731
    assert torch.autograd.gradcheck(f, ins, check_forward_ad=True)
    assert torch.autograd.gradgradcheck(f, ins)


@pytest.mark.parametrize("wrt", [0, 1, 2])
def test_sddmm_gradient_matches_jax_grad(wrt):
    rows, cols, data, lhs, rhs = _grad_inputs()
    w = np.random.default_rng(12).standard_normal(rows.size)

    def jloss(d, l, r):
        return (jnp.asarray(w) * jk.sddmm(jnp.asarray(rows), jnp.asarray(cols), d, l, r)).sum() ** 2

    want = np.asarray(jax.grad(jloss, argnums=wrt)(jnp.asarray(data), jnp.asarray(lhs), jnp.asarray(rhs)))
    ins = [_t(x).requires_grad_(True) for x in (data, lhs, rhs)]
    ((_t(w) * tk.sddmm(_t(rows), _t(cols), *ins)).sum() ** 2).backward()
    np.testing.assert_allclose(ins[wrt].grad.numpy(), want, rtol=1e-12, atol=1e-12)


def test_sddmm_second_derivative_matches_jax():
    rows, cols, data, lhs, rhs = _grad_inputs()

    def jloss(l):
        return (jk.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(data), l, jnp.asarray(rhs)) ** 2).sum()

    v = np.random.default_rng(13).standard_normal(lhs.shape)
    want = np.asarray(jax.jvp(jax.grad(jloss), (jnp.asarray(lhs),), (jnp.asarray(v),))[1])
    lt = _t(lhs).requires_grad_(True)
    (g,) = torch.autograd.grad((tk.sddmm(_t(rows), _t(cols), _t(data), lt, _t(rhs)) ** 2).sum(), lt, create_graph=True)
    (hv,) = torch.autograd.grad((g * _t(v)).sum(), lt)
    np.testing.assert_allclose(hv.numpy(), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# sddmm, the entry point
# ---------------------------------------------------------------------------


def _formats(x, fmt):
    t, j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    if fmt == "coo":
        return t, j
    if fmt == "gcxs":
        return st.GCXS.from_numpy(x, device=CPU), jsp.GCXS.from_numpy(x)
    return t.asformat(fmt), j.asformat(fmt)


@pytest.mark.parametrize("fmt", ["coo", "gcxs", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64, np.complex128, np.int64])
def test_sddmm_matches_sparse_tpu(fmt, dtype):
    rng = np.random.default_rng(1)
    x = _sample(dtype, seed=2)
    lhs = _values(rng.standard_normal((40, 8)), dtype, rng)
    rhs = _values(rng.standard_normal((8, 30)), dtype, rng)
    t, j = _formats(x, fmt)
    want = jsp.sddmm(j, lhs, rhs)
    _assert_same_sddmm(st.sddmm(t, lhs, rhs), want, RTOL[dtype])
    _assert_same_sddmm(st.sddmm(t, torch.as_tensor(lhs), torch.as_tensor(rhs)), want, RTOL[dtype])


@pytest.mark.parametrize(
    "dts",
    [
        (np.float32, np.float64, np.float32),
        (np.float64, np.float32, np.float32),
        (np.int64, np.float32, np.float32),
        (np.float32, np.float32, np.int32),
        (np.int32, np.int64, np.int32),
        (np.float16, np.float32, np.float16),
        (np.float64, np.complex128, np.float64),
    ],
)
def test_sddmm_mixed_dtypes_promote_as_sparse_tpu(dts):
    rng = np.random.default_rng(3)
    x = _sample(dts[0], seed=4)
    lhs = _values(rng.standard_normal((40, 5)), dts[1], rng)
    rhs = _values(rng.standard_normal((5, 30)), dts[2], rng)
    t, j = _formats(x, "coo")
    want = jsp.sddmm(j, lhs, rhs)
    out_dt = np.result_type(*dts)
    assert np.asarray(want.data).dtype == out_dt
    _assert_same_sddmm(st.sddmm(t, lhs, rhs), want, RTOL.get(out_dt.type, 1e-5))


def test_sddmm_empty_mask_and_k_one():
    rng = np.random.default_rng(5)
    lhs, rhs = rng.standard_normal((6, 1)), rng.standard_normal((1, 7))
    for x in (np.zeros((6, 7)), _sample(np.float64, seed=6, shape=(6, 7), density=0.5)):
        t, j = _formats(x, "coo")
        _assert_same_sddmm(st.sddmm(t, lhs, rhs), jsp.sddmm(j, lhs, rhs), 1e-12)


def test_sddmm_errors():
    x = _sample(np.float64, seed=7, shape=(5, 4), density=0.5)
    t = st.COO.from_numpy(x, device=CPU, fill_value=1.0)
    j = jsp.COO.from_numpy(x, fill_value=1.0)
    lhs, rhs = np.ones((5, 3)), np.ones((3, 4))
    for mod, s in ((st, t), (jsp, j)):
        with pytest.raises(ValueError, match="zero fill values"):
            mod.sddmm(s, lhs, rhs)
    t0 = st.COO.from_numpy(x, device=CPU)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        st.sddmm(t0, lhs, rhs.T)


def test_sddmm_coordinates_are_a_copy():
    x = _sample(np.float64, seed=8)
    t = st.COO.from_numpy(x, device=CPU)
    out = st.sddmm(t, np.ones((40, 2)), np.ones((2, 30)))
    assert torch.equal(out.coords, t.coords) and out.coords.data_ptr() != t.coords.data_ptr()


# ---------------------------------------------------------------------------
# jitops
# ---------------------------------------------------------------------------


def _pipeline(mod, a, b):
    y = mod.spmm(a, b)
    s2 = mod.sddmm(a, y, b.T)
    s3 = mod.scale(s2, 2.0)
    s4 = mod.add_same_pattern(s3, s2)
    return mod.sum_dense(s4, (1,))


def test_jitops_pipeline_matches_sparse_tpu():
    # tests/test_jitops.py::test_pipeline_under_jit through both packages
    j = jsp.random((30, 20), density=0.2, random_state=0)
    b = np.random.default_rng(1).random((20, 6))
    want = np.asarray(jax.jit(lambda a, bb: _pipeline(jjit, a, bb))(j, jnp.asarray(b)))
    t = st.COO.from_numpy(j.todense(), device=CPU)
    got = _pipeline(tjit, t, torch.as_tensor(b))
    assert got.shape == (30,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_jitops_spmm_gradient_matches_sparse_tpu():
    # tests/test_jitops.py::test_grad_through_pipeline
    j = jsp.random((10, 8), density=0.3, random_state=2)
    b = np.random.default_rng(3).random((8, 4))

    def jloss(data):
        return jjit.spmm(jsp.COO._make(j.coords, data, j.shape, j.fill_value), jnp.asarray(b)).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(np.asarray(j.data))))
    t = st.COO.from_numpy(j.todense(), device=CPU)
    data = t.data.clone().requires_grad_(True)
    tjit.spmm(st.COO._make(t.coords, data, t.shape, t.fill_value), torch.as_tensor(b)).sum().backward()
    np.testing.assert_allclose(data.grad.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("op", ["spmm", "spmv"])
def test_jitops_products_match_sparse_tpu(fmt, op):
    x = _sample(np.float64, seed=9, shape=(9, 11), density=0.4)
    rng = np.random.default_rng(10)
    b = rng.random((11, 3)) if op == "spmm" else rng.random(11)
    t, j = _formats(x, fmt)
    want = np.asarray(getattr(jjit, op)(j, jnp.asarray(b)))
    got = getattr(tjit, op)(t, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    r, c, d = tjit._triplet(t)
    jr, jc, jd = jjit._triplet(j)
    order, jorder = np.lexsort((c.numpy(), r.numpy())), np.lexsort((np.asarray(jc), np.asarray(jr)))
    np.testing.assert_array_equal(r.numpy()[order], np.asarray(jr)[jorder])
    np.testing.assert_array_equal(c.numpy()[order], np.asarray(jc)[jorder])
    np.testing.assert_array_equal(d.numpy()[order], np.asarray(jd)[jorder])


def test_jitops_same_pattern_ops_and_transpose_match_sparse_tpu():
    x = _sample(np.float64, seed=11, shape=(6, 5, 4), density=0.3)
    t, j = _formats(x, "coo")
    checks = [
        (tjit.map_data(t, torch.sin), jjit.map_data(j, jnp.sin)),
        (tjit.mul_same_pattern(t, t), jjit.mul_same_pattern(j, j)),
        (tjit.add_same_pattern(t, t), jjit.add_same_pattern(j, j)),
        (tjit.scale(t, 3.0), jjit.scale(j, 3.0)),
        (tjit.transpose(t), jjit.transpose(j)),
        (tjit.transpose(t, (1, 0, 2)), jjit.transpose(j, (1, 0, 2))),
        (tjit.transpose(t, (-1, 0, 1)), jjit.transpose(j, (-1, 0, 1))),
    ]
    for got, want in checks:
        assert got.shape == want.shape and got.fill_value == want.fill_value
        assert numpy_dtype(got.coords.dtype) == np.asarray(want.coords).dtype
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)
    assert tjit.transpose(t, (0, 1, 2)) is t
    with pytest.raises(ValueError, match="repeated or incomplete"):
        tjit.transpose(t, (0, 0, 1))


def test_jitops_sddmm_keeps_the_pattern():
    x = _sample(np.float32, seed=12)
    t, j = _formats(x, "coo")
    rng = np.random.default_rng(13)
    lhs, rhs = rng.random((40, 4)).astype(np.float32), rng.random((4, 30)).astype(np.float32)
    got, want = tjit.sddmm(t, lhs, rhs), jjit.sddmm(j, jnp.asarray(lhs), jnp.asarray(rhs))
    assert got.coords is t.coords and got.dtype == torch.float32
    assert got.fill_value == 0 and np.asarray(got.fill_value).dtype == np.float32
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-5)
    with pytest.raises(TypeError, match="COO sample"):
        tjit.sddmm(t.asformat("csr"), lhs, rhs)
