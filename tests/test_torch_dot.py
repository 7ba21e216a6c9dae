"""The port's sparse × dense products against sparse_tpu's own results on
the same COO (CPU). float64 at rtol=1e-10, atol=1e-12; float32 at rtol=1e-5,
atol=1e-5 (the two packages sum each row in another order); integers exactly.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype
from sparse_tpu_torch.interop import coo_from_arrays

CPU = "cpu"


def _dense_matrix(m, k, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * (rng.random((m, k)) < density)
    if np.issubdtype(dtype, np.integer):
        x = np.round(x * 4)
    return x.astype(dtype)


def _tol(dt):
    dt = np.dtype(dt)
    if dt == np.float32:
        return dict(rtol=1e-5, atol=1e-5)
    if np.issubdtype(dt, np.integer):
        return dict(rtol=0, atol=0)
    return dict(rtol=1e-10, atol=1e-12)


def _pair(x):
    return st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)


def _check(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert numpy_dtype(got.dtype) == want.dtype
    np.testing.assert_allclose(got.numpy(), want, **_tol(want.dtype))


@pytest.mark.parametrize("shape", [(50, 40), (300, 7), (7, 300), (1, 1)])
@pytest.mark.parametrize("n", [None, 1, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_matches_sparse_tpu(shape, n, dtype):
    m, k = shape
    x = _dense_matrix(m, k, 0.1, seed=m + k, dtype=dtype)
    t, j = _pair(x)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(k if n is None else (k, n)).astype(dtype)
    want = j @ b
    _check(t @ b, want)
    _check(t @ torch.as_tensor(b), want)
    _check(st.matmul(t, b), want)
    _check(st.dot(t, b), jsp.dot(j, b))


@pytest.mark.parametrize("a_dt", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("b_dt", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("vector", [False, True])
def test_dtype_promotion_matrix(a_dt, b_dt, vector):
    x = _dense_matrix(30, 20, 0.2, seed=4, dtype=a_dt)
    t, j = _pair(x)
    rng = np.random.default_rng(2)
    b = np.round(rng.standard_normal(20 if vector else (20, 3)) * 3).astype(b_dt)
    want = np.asarray(j @ b)
    assert want.dtype == np.promote_types(a_dt, b_dt)
    _check(t @ b, want)


@pytest.mark.parametrize("a_dt", [np.uint16, np.uint32, np.uint64])
@pytest.mark.parametrize("b_dt", [np.int8, np.uint8, np.uint16, np.uint64, np.int64, np.float32])
@pytest.mark.parametrize("vector", [False, True])
def test_unsigned_data_products_match_sparse_tpu(a_dt, b_dt, vector):
    # values near the top of the type, so wrapped products and sums show
    rng = np.random.default_rng(11)
    top = np.iinfo(a_dt).max
    x = ((top - rng.integers(0, 1000, (30, 20), dtype=np.uint64)) * (rng.random((30, 20)) < 0.2)).astype(a_dt)
    t, j = _pair(x)
    assert numpy_dtype(t.dtype) == np.dtype(a_dt) == np.asarray(j.data).dtype
    b = rng.integers(0, 100, 20 if vector else (20, 3)).astype(b_dt)
    want = np.asarray(j @ b)
    assert want.dtype == np.promote_types(a_dt, b_dt)
    _check(t @ b, want)
    _check(st.dot(t, b), jsp.dot(j, b))
    if vector:
        y = rng.integers(0, 100, 30).astype(b_dt)
        _check(st.matvec_add(t, b, y), jsp.matvec_add(j, b, y))


@pytest.mark.parametrize("seed", [0, 3, 5, 7, 11])
def test_float16_products_within_float16_ulps_of_sparse_tpu(seed):
    # sparse_tpu rounds each add of np.add.at in float16; the port sums in
    # float32 and rounds once. Measured in ulps of the float16 value of
    # sum |a||b|, the scale a rounded dot product is judged by: the port
    # within 1 ulp of the float64 oracle, and within 3 of sparse_tpu.
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((20, 50)) * (rng.random((20, 50)) < 0.4)).astype(np.float16)
    b = rng.standard_normal((50, 8)).astype(np.float16)
    t, j = _pair(x)
    got, want = t @ b, np.asarray(j @ b)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    got = got.numpy().astype(np.float64)
    x64, b64 = x.astype(np.float64), b.astype(np.float64)
    ulp = np.spacing((np.abs(x64) @ np.abs(b64)).astype(np.float16)).astype(np.float64)
    assert (np.abs(got - x64 @ b64) / ulp).max() <= 1.0
    assert (np.abs(got - want.astype(np.float64)) / ulp).max() <= 3.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matvec_add_matches_sparse_tpu(dtype):
    x = _dense_matrix(200, 150, 0.05, seed=9, dtype=dtype)
    t, j = _pair(x)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(150).astype(dtype)
    y = rng.standard_normal(200).astype(dtype)
    want = jsp.matvec_add(j, v, y)
    _check(st.matvec_add(t, v, y), want)
    _check(st.matvec_add(t, torch.as_tensor(v), torch.as_tensor(y)), want)


def test_matvec_add_spmv_add_shape():
    # the spmv_add example's shape at its density: most rows are empty
    rng = np.random.default_rng(0)
    m, k = 99_990, 100_000
    lin = np.unique(rng.integers(0, m * k, size=10_000))
    coords = np.stack([lin // k, lin % k])
    data = rng.random(lin.size)
    t = st.COO(coords, data, shape=(m, k), device=CPU)
    j = jsp.COO(coords, data, shape=(m, k))
    v, y = rng.random(k), rng.random(m)
    _check(st.matvec_add(t, v, y), jsp.matvec_add(j, v, y))


def test_matvec_add_other_dtypes_take_the_unfused_form():
    x = _dense_matrix(20, 10, 0.3, seed=5, dtype=np.int64)
    t, j = _pair(x)
    v, y = np.arange(10), np.arange(20)
    _check(st.matvec_add(t, v, y), jsp.matvec_add(j, v, y))


def test_state_carried_across_with_interop():
    x = _dense_matrix(80, 60, 0.1, seed=6)
    j = jsp.COO.from_numpy(x)
    t = coo_from_arrays(np.asarray(j.coords), np.asarray(j.data), j.shape, device=CPU)
    b = np.random.default_rng(7).standard_normal((60, 4))
    _check(t @ b, j @ b)
    np.testing.assert_array_equal(t.todense().numpy(), x)


def test_scipy_operand():
    x = _dense_matrix(30, 20, 0.2, seed=8)
    b = torch.as_tensor(np.random.default_rng(9).standard_normal((20, 3)))
    _check(st.matmul(scipy.sparse.csr_matrix(x), b), x @ b.numpy())


def test_empty_operands():
    t, j = _pair(np.zeros((6, 4)))
    b = np.ones((4, 3), dtype=np.float32)
    _check(t @ b, j @ b)  # promotes to float64 although nothing is stored
    t, j = _pair(np.zeros((0, 4)))
    _check(t @ b, j @ b)


def test_nonzero_fill_raises_in_both():
    x = np.eye(3) + 1.0
    t = st.COO.from_numpy(x, fill_value=1.0, device=CPU)
    j = jsp.COO.from_numpy(x, fill_value=1.0)
    b = np.ones((3, 2))
    for mod, a in ((st, t), (jsp, j)):
        with pytest.raises(ValueError, match="zero fill values"):
            mod.matmul(a, b)
        with pytest.raises(ValueError, match="zero fill values"):
            mod.dot(a, b)
        with pytest.raises(ValueError, match="zero fill values"):
            mod.matvec_add(a, np.ones(3), np.ones(3))


def test_nan_warning_in_both():
    x = np.eye(3)
    x[1, 2] = np.nan
    t, j = _pair(x)
    b = np.ones((3, 2))
    for a in (t, j):
        with pytest.warns(RuntimeWarning, match="Nan will not be propagated"):
            a @ b
    b_nan = np.ones(3)
    b_nan[0] = np.nan
    t2, j2 = _pair(np.eye(3))
    for mod, a in ((st, t2), (jsp, j2)):
        with pytest.warns(RuntimeWarning, match="Nan will not be propagated"):
            mod.matvec_add(a, b_nan, np.zeros(3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t2 @ np.ones(3)


def test_error_paths():
    t = st.COO.from_numpy(np.eye(3), device=CPU)
    with pytest.raises(ValueError, match="shape-mismatch"):
        t @ np.ones((4, 2))
    with pytest.raises(ValueError, match="enough dimensions"):
        st.matmul(t, 2.0)
    with pytest.raises(ValueError, match="scalars"):
        st.dot(t, 2.0)


@pytest.mark.parametrize(
    "make",
    [
        # every product of two sparse operands (SpGEMM), against sparse_tpu's
        lambda p, t, t3, v: p.matmul(t, t),
        lambda p, t, t3, v: t @ t,
        lambda p, t, t3, v: p.dot(t, t),
        lambda p, t, t3, v: p.tensordot(t, t, axes=1),
        lambda p, t, t3, v: p.matmul(t3, t3),  # batched
        lambda p, t, t3, v: p.matmul(t3, t),
        lambda p, t, t3, v: p.dot(t3, t3),
        lambda p, t, t3, v: p.matmul(v, t),  # 1-D sparse × 2-D sparse
        lambda p, t, t3, v: p.dot(t, v),
    ],
)
def test_unported_operand_kinds_raise(make):
    operands = (np.eye(3) * 2.0, np.arange(1.0, 19.0).reshape(2, 3, 3), np.arange(1.0, 4.0))
    ts = [st.COO.from_numpy(x, device=CPU) for x in operands]
    js = [jsp.COO.from_numpy(x) for x in operands]
    got, want = make(st, *ts), make(jsp, *js)
    assert isinstance(got, st.COO) and got.shape == want.shape
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    assert numpy_dtype(got.coords.dtype) == np.asarray(want.coords).dtype
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)


def test_result_stays_on_the_operand_device_and_layout_is_reused():
    x = _dense_matrix(64, 64, 0.1, seed=10)
    t = st.COO.from_numpy(x, device=CPU)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((64, 8)))
    out1 = t @ b
    re = t.to_row_ell()
    out2 = t @ b
    assert t.to_row_ell() is re
    assert torch.equal(out1, out2)
