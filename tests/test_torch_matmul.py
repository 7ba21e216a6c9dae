"""The rest of the products with one sparse operand against sparse_tpu's own
results (CPU): dense × sparse, 1-D operands, batched ``matmul``,
``tensordot`` (every ``axes`` form and ``return_type``) and ``vecdot``.

Same inputs, drawn with numpy from a seed, through both packages. Values:
float64 and complex128 at rtol 1e-10, atol 1e-12; float32 at rtol=atol
1e-5 (the two sum in another order); integers exactly; float16 within 3
float16 ulps of ``Σ|a||b|`` of ``sparse_tpu`` (which rounds each add of
``np.add.at``, as ``tests/test_torch_dot.py`` holds for sparse × dense).
Dtypes, shapes and output types equal; a dense result is a ``torch.Tensor``
where ``sparse_tpu`` returns an ``np.ndarray``.
"""

import numpy as np
import pytest
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"


def _dense(shape, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * (rng.random(shape) < density)
    if np.issubdtype(dtype, np.integer):
        x = np.round(x * 4)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * x[::-1] if x.ndim else x
    return x.astype(dtype)


def _pair(x, fmt="coo"):
    t, j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    if fmt == "coo":
        return t, j
    return t.asformat(fmt), j.asformat(fmt)


def _tol(dt):
    dt = np.dtype(dt)
    if dt == np.float32:
        return dict(rtol=1e-5, atol=1e-5)
    if np.issubdtype(dt, np.integer):
        return dict(rtol=0, atol=0)
    return dict(rtol=1e-10, atol=1e-12)


def _to_np(x):
    if isinstance(x, st.SparseArray):
        return x.todense().numpy()
    if isinstance(x, jsp.SparseArray):
        return x.todense()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, want, ulp_scale=None):
    """``got`` (port) against ``want`` (sparse_tpu): kind, dtype, shape, values."""
    if isinstance(want, jsp.SparseArray):
        assert isinstance(got, st.SparseArray) and type(got).__name__ == type(want).__name__
        assert got.fill_value == want.fill_value
        dtype = np.asarray(want.data).dtype
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        dtype = np.asarray(want).dtype
    assert numpy_dtype(got.dtype) == dtype and tuple(got.shape) == tuple(want.shape)
    g, w = _to_np(got), _to_np(want)
    if ulp_scale is not None:
        ulp = np.spacing(np.asarray(ulp_scale, dtype=np.float16)).astype(np.float64)
        assert (np.abs(g.astype(np.float64) - w.astype(np.float64)) / ulp).max() <= 3.0
    else:
        np.testing.assert_allclose(g, w, **_tol(dtype))


# ---------------------------------------------------------------------------
# dense × sparse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int64])
@pytest.mark.parametrize("left", ["tensor", "ndarray", "1-d", "one row"])
def test_dense_times_sparse_matches_sparse_tpu(fmt, dtype, left):
    x = _dense((30, 20), 0.2, seed=1, dtype=dtype)
    t, j = _pair(x, fmt)
    m = {"tensor": 7, "ndarray": 7, "1-d": None, "one row": 1}[left]
    a = _dense((30,) if m is None else (m, 30), 1.0, seed=2, dtype=dtype)
    want = a @ j
    ta = a if left == "ndarray" else torch.as_tensor(a)
    scale = np.abs(a.astype(np.float64)) @ np.abs(x.astype(np.float64)) if dtype == np.float16 else None
    _check(ta @ t, want, scale)
    _check(st.matmul(ta, t), want, scale)
    _check(st.dot(ta, t), jsp.dot(a, j), scale)


@pytest.mark.parametrize("a_dt", [np.float32, np.int64])
@pytest.mark.parametrize("b_dt", [np.float64, np.int32])
def test_dense_times_sparse_promotes(a_dt, b_dt):
    x = _dense((12, 9), 0.3, seed=3, dtype=b_dt)
    t, j = _pair(x)
    a = _dense((4, 12), 1.0, seed=4, dtype=a_dt)
    want = a @ j
    assert np.asarray(want).dtype == np.promote_types(a_dt, b_dt)
    _check(torch.as_tensor(a) @ t, want)


def test_dense_times_sparse_builds_the_transposed_layout_once():
    x = _dense((40, 30), 0.1, seed=5)
    t, _ = _pair(x)
    w = torch.as_tensor(_dense((8, 40), 1.0, seed=6))
    first = w @ t
    layout = t.T.to_row_ell()
    second = w @ t
    assert t.T.to_row_ell() is layout and torch.equal(first, second)
    assert torch.equal(first, (t.T @ w.T).T)


def test_dense_times_sparse_errors():
    t, _ = _pair(_dense((4, 3), 0.5, seed=7))
    with pytest.raises(ValueError, match="shape-mismatch"):
        torch.ones((2, 5), dtype=torch.float64) @ t
    t1 = st.COO.from_numpy(np.eye(3), device=CPU, fill_value=1.0)
    with pytest.raises(ValueError, match="zero fill values"):
        np.ones((2, 3)) @ t1


# ---------------------------------------------------------------------------
# 1-D operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kinds", ["sparse·sparse", "sparse·dense", "dense·sparse"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.complex128])
def test_1d_dot_matches_sparse_tpu(kinds, dtype):
    x, y = _dense(25, 0.5, seed=8, dtype=dtype), _dense(25, 0.5, seed=9, dtype=dtype)
    tx, jx = _pair(x)
    ty, jy = _pair(y)
    ops = {
        "sparse·sparse": ((tx, ty), (jx, jy)),
        "sparse·dense": ((tx, y), (jx, y)),
        "dense·sparse": ((x, ty), (x, jy)),
    }
    (a, b), (ja, jb) = ops[kinds]
    want = jsp.dot(ja, jb)
    got = st.dot(a, b)
    assert isinstance(got, torch.Tensor) and got.shape == ()
    assert numpy_dtype(got.dtype) == np.asarray(want).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))
    np.testing.assert_allclose(st.matmul(a, b).numpy(), np.asarray(jsp.matmul(ja, jb)), **_tol(dtype))


@pytest.mark.parametrize("order", ["vector @ matrix", "matrix @ vector"])
@pytest.mark.parametrize("sparse", ["vector", "matrix"])
def test_1d_times_2d_matches_sparse_tpu(order, sparse):
    v, m = _dense(12, 0.5, seed=10), _dense((12, 12), 0.3, seed=11)
    tv, jv = _pair(v) if sparse == "vector" else (v, v)
    tm, jm = _pair(m) if sparse == "matrix" else (m, m)
    args, jargs = ((tv, tm), (jv, jm)) if order == "vector @ matrix" else ((tm, tv), (jm, jv))
    _check(st.matmul(*args), jsp.matmul(*jargs))
    _check(st.dot(*args), jsp.dot(*jargs))


# ---------------------------------------------------------------------------
# batched matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "a_shape, b_shape, sparse",
    [
        ((3, 4, 5), (3, 5, 2), "a"),
        ((3, 4, 5), (5, 2), "a"),
        ((3, 4, 5), (5,), "a"),
        ((2, 1, 4, 5), (3, 5, 2), "a"),
        ((1, 4, 5), (3, 5, 2), "a"),
        ((4, 5), (3, 5, 2), "b"),
        ((3, 4, 5), (3, 5, 2), "b"),
        ((5,), (2, 3, 5, 2), "b"),
        ((2, 3, 4, 5), (1, 5, 2), "b"),
    ],
)
def test_batched_matmul_matches_sparse_tpu(a_shape, b_shape, sparse):
    a, b = _dense(a_shape, 0.4, seed=12), _dense(b_shape, 0.4, seed=13)
    ta, ja = _pair(a) if sparse == "a" else (a, a)
    tb, jb = _pair(b) if sparse == "b" else (b, b)
    want = jsp.matmul(ja, jb)
    np.testing.assert_allclose(np.asarray(want), a @ b, rtol=1e-12)
    _check(st.matmul(ta, tb), want)
    _check(st.matmul(ta if sparse == "a" else torch.as_tensor(a), tb if sparse == "b" else torch.as_tensor(b)), want)


def test_batched_matmul_of_a_gcxs_and_an_empty_batch():
    x = _dense((3, 6, 5), 0.3, seed=14)
    g = st.GCXS.from_numpy(x, compressed_axes=(1,), device=CPU)
    b = _dense((5, 2), 1.0, seed=15)
    _check(st.matmul(g, b), jsp.matmul(jsp.GCXS.from_numpy(x, compressed_axes=(1,)), b))
    z = np.zeros((3, 6, 5))
    z[1] = x[1]
    _check(st.matmul(_pair(z)[0], b), jsp.matmul(_pair(z)[1], b))


def test_batched_sparse_times_sparse_raises():
    # batched sparse × sparse runs (SpGEMM) and matches sparse_tpu's
    t3, j3 = _pair(_dense((2, 3, 3), 0.5, seed=16))
    _check(st.matmul(t3, t3), jsp.matmul(j3, j3))


# ---------------------------------------------------------------------------
# tensordot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "a_shape, b_shape, axes",
    [
        ((4, 5), (5, 3), 1),
        ((4, 5, 6), (5, 6, 2), 2),
        ((4, 5, 6), (6, 5, 2), ([1, 2], [1, 0])),
        ((4, 5, 6), (5, 3), (1, 0)),
        ((4, 5, 6), (3, 6), (-1, -1)),
        ((4, 5, 6), (6, 3), ([-1], [0])),
        ((5, 6), (5, 6), ([0, 1], [0, 1])),
        ((6,), (6, 2), 1),
        ((4, 5), (2, 3), 0),
    ],
)
@pytest.mark.parametrize("sparse", ["a", "b"])
def test_tensordot_axes_forms_match_sparse_tpu(a_shape, b_shape, axes, sparse):
    a, b = _dense(a_shape, 0.4, seed=17), _dense(b_shape, 0.4, seed=18)
    ta, ja = _pair(a) if sparse == "a" else (a, a)
    tb, jb = _pair(b) if sparse == "b" else (b, b)
    want = jsp.tensordot(ja, jb, axes=axes)
    np.testing.assert_allclose(np.asarray(want), np.tensordot(a, b, axes=axes), rtol=1e-12, atol=1e-12)
    _check(st.tensordot(ta, tb, axes=axes), want)


@pytest.mark.parametrize("return_type", [None, np.ndarray, "COO", "GCXS"])
@pytest.mark.parametrize("sparse", ["a", "b"])
def test_tensordot_return_type_matches_sparse_tpu(return_type, sparse):
    a, b = _dense((6, 5), 0.4, seed=19), _dense((5, 4), 0.4, seed=20)
    ta, ja = _pair(a) if sparse == "a" else (a, a)
    tb, jb = _pair(b) if sparse == "b" else (b, b)
    rt_t = {"COO": st.COO, "GCXS": st.GCXS}.get(return_type, return_type)
    rt_j = {"COO": jsp.COO, "GCXS": jsp.GCXS}.get(return_type, return_type)
    got = st.tensordot(ta, tb, axes=(1, 0), return_type=rt_t)
    want = jsp.tensordot(ja, jb, axes=(1, 0), return_type=rt_j)
    _check(got, want)
    if isinstance(want, jsp.SparseArray):
        assert got.nnz == want.nnz
    if return_type == "GCXS":
        assert got.compressed_axes == want.compressed_axes


@pytest.mark.parametrize(
    "a_shape, b_shape, axes, sparse",
    [
        ((0, 5), (5, 3), 1, "a"),
        ((4, 5), (5, 0), 1, "a"),
        ((4, 0), (0, 3), 1, "a"),
        ((4, 0), (0, 3), 1, "b"),
        ((2, 3), (3, 4), 1, "both"),
    ],
)
def test_tensordot_empty_results_match_sparse_tpu(a_shape, b_shape, axes, sparse):
    a, b = np.zeros(a_shape), np.zeros(b_shape)
    ta, ja = _pair(a) if sparse in ("a", "both") else (a, a)
    tb, jb = _pair(b) if sparse in ("b", "both") else (b, b)
    if sparse == "both":  # sparse × sparse: only the empty case runs before SpGEMM
        a, b = np.zeros((2, 0)), np.zeros((0, 4))
        (ta, ja), (tb, jb) = _pair(a), _pair(b)
    want = jsp.tensordot(ja, jb, axes=axes)
    got = st.tensordot(ta, tb, axes=axes)
    _check(got, want)


def test_tensordot_errors():
    t, j = _pair(_dense((4, 5), 0.4, seed=21))
    with pytest.raises(ValueError, match="shape-mismatch"):
        st.tensordot(t, np.ones((4, 2)), axes=1)
    with pytest.raises(ValueError, match="scalars"):
        st.tensordot(t, 2.0)
    with pytest.raises(ValueError, match="shape-mismatch"):
        st.tensordot(t, t, axes=1)
    _check(st.tensordot(t, t.T, axes=1), jsp.tensordot(j, j.T, axes=1))  # sparse × sparse


# ---------------------------------------------------------------------------
# vecdot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("kinds", ["sparse·sparse", "sparse·dense", "dense·sparse"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_vecdot_matches_sparse_tpu(dtype, kinds, axis):
    x, y = _dense((6, 5), 0.5, seed=22, dtype=dtype), _dense((6, 5), 0.5, seed=23, dtype=dtype)
    tx, jx = _pair(x)
    ty, jy = _pair(y)
    ops = {
        "sparse·sparse": ((tx, ty), (jx, jy)),
        "sparse·dense": ((tx, y), (jx, y)),
        "dense·sparse": ((x, ty), (x, jy)),
    }
    (a, b), (ja, jb) = ops[kinds]
    want = jsp.vecdot(ja, jb, axis=axis)
    np.testing.assert_allclose(_to_np(want), np.sum(np.conj(x) * y, axis=axis), rtol=1e-12)
    _check(st.vecdot(a, b, axis=axis), want)


def test_vecdot_errors():
    t, _ = _pair(_dense((6, 5), 0.5, seed=24))
    with pytest.raises(ValueError, match="Shapes must match"):
        st.vecdot(t, t, axis=2)
    with pytest.raises(ValueError, match="Shapes must match"):
        st.vecdot(t, np.ones((6, 4)))
