"""The port's COO and helpers against sparse_tpu's (CPU, small sizes).

Inputs come from numpy with a seed and go to both packages as numpy arrays.
Coordinates must match exactly; values to rtol=1e-12 for float64 (duplicate
sums may associate differently) and 1e-6 for float32.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import sparse_tpu as jsp
from sparse_tpu import _utils as jutils
import sparse_tpu_torch as st
from sparse_tpu_torch import _utils as tutils
from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

CPU = "cpu"


def _assert_same(t, j):
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
    # float32 duplicate sums may round differently once (sparse_tpu may sum wider)
    rtol = 1e-6 if np.asarray(j.data).dtype == np.float32 else 1e-12
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), rtol=rtol, atol=0)
    assert tutils.numpy_dtype(t.dtype) == np.asarray(j.data).dtype
    assert np.asarray(t.fill_value).tobytes() == np.asarray(j.fill_value).tobytes()


def _triplets(seed, shape, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, s, n) for s in shape])
    if np.issubdtype(dtype, np.floating):
        data = rng.standard_normal(n).astype(dtype)
    else:
        data = rng.integers(-5, 6, n).astype(dtype)
    return coords, data


CASES = {
    "unsorted_duplicates": dict(shape=(40, 30), n=300),
    "tall": dict(shape=(500, 3), n=900),
    "three_d": dict(shape=(6, 7, 8), n=150),
    "one_d": dict(shape=(50,), n=80),
    "float32": dict(shape=(30, 30), n=200, dtype=np.float32),
    "int64": dict(shape=(30, 20), n=200, dtype=np.int64),
    "bool": dict(shape=(20, 20), n=300, dtype=np.bool_),
    # negative draws wrap, so duplicate sums wrap too
    "uint16": dict(shape=(20, 15), n=200, dtype=np.uint16),
    "uint32": dict(shape=(20, 15), n=200, dtype=np.uint32),
    "uint64": dict(shape=(6, 7, 8), n=150, dtype=np.uint64),
    "empty": dict(shape=(5, 4), n=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_constructor_canonicalizes_like_sparse_tpu(case):
    kw = CASES[case]
    coords, data = _triplets(sorted(CASES).index(case), kw["shape"], kw["n"], kw.get("dtype", np.float64))
    t = st.COO(coords, data, shape=kw["shape"], device=CPU)
    j = jsp.COO(coords, data, shape=kw["shape"])
    _assert_same(t, j)
    rtol = 1e-6 if kw.get("dtype") == np.float32 else 1e-12
    np.testing.assert_allclose(t.todense().numpy(), np.asarray(j.todense()), rtol=rtol)


@pytest.mark.parametrize("fill", [0.0, 1.5])
def test_prune_and_fill_value(fill):
    coords, data = _triplets(3, (20, 20), 120)
    data[::4] = fill  # entries equal to the fill get pruned
    t = st.COO(coords, data, shape=(20, 20), prune=True, fill_value=fill, device=CPU)
    j = jsp.COO(coords, data, shape=(20, 20), prune=True, fill_value=fill)
    _assert_same(t, j)
    np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))


def test_shape_inferred_from_coords():
    coords, data = _triplets(4, (9, 13), 60)
    t = st.COO(coords, data, device=CPU)
    j = jsp.COO(coords, data)
    _assert_same(t, j)


def test_already_sorted_input_is_kept():
    x = np.arange(12.0).reshape(3, 4)
    x[x % 3 == 0] = 0
    r, c = np.nonzero(x)
    t = st.COO(np.stack([r, c]), x[r, c], shape=x.shape, sorted=True, has_duplicates=False, device=CPU)
    j = jsp.COO(np.stack([r, c]), x[r, c], shape=x.shape, sorted=True, has_duplicates=False)
    _assert_same(t, j)


# signed zeros through the duplicate sums: -0.0 singletons beside a
# duplicated coordinate, runs made only of -0.0, a run of -0.0 and +0.0 (+0.0)
SIGNED_ZERO_CASES = {
    "singletons_beside_a_run": ([[0, 1, 1, 2]], [-0.0, 3.0, 4.0, -0.0]),
    "runs_of_minus_zero": ([[3, 0, 3, 1, 0, 3, 2]], [-0.0, -0.0, -0.0, 5.0, -0.0, -0.0, -0.0]),
    "mixed_zero_run": ([[1, 0, 1, 2, 2]], [-0.0, -0.0, 0.0, -0.0, 2.5]),
    "two_d": ([[0, 0, 1, 1, 0], [2, 2, 0, 1, 1]], [-0.0, -0.0, -0.0, 1.0, -0.0]),
}


def _bits(a):
    a = np.asarray(a)
    parts = (a.real, a.imag) if np.iscomplexobj(a) else (a,)
    return [(p.tobytes(), np.signbit(p).tolist()) for p in parts]


@pytest.mark.parametrize("case", sorted(SIGNED_ZERO_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("prune", [False, True])
def test_duplicate_sums_keep_the_sign_of_zero(case, dtype, prune):
    coords, vals = SIGNED_ZERO_CASES[case]
    coords = np.array(coords)
    data = np.array(vals, dtype=dtype)
    if np.iscomplexobj(data):  # signed zeros in the imaginary parts too
        data = data + np.array([complex(0.0, -0.0) if v == 0 else 1j for v in vals])
    shape = tuple(int(c.max()) + 1 for c in coords)
    t = st.COO(coords, data, shape=shape, prune=prune, device=CPU)
    j = jsp.COO(coords, data, shape=shape, prune=prune)
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
    assert _bits(t.data.numpy()) == _bits(j.data)
    assert _bits(t.todense().numpy()) == _bits(j.todense())


def test_duplicate_sums_keep_minus_zero_in_the_repro():
    t = st.COO([[0, 1, 1, 2]], [-0.0, 3.0, 4.0, -0.0], shape=(3,), prune=True, device=CPU)
    assert t.coords.tolist() == [[0, 1, 2]]
    assert t.data.tolist() == [0.0, 7.0, 0.0] and torch.signbit(t.data).tolist() == [True, False, True]


@pytest.mark.parametrize(
    "x,fill",
    [
        (np.array([[0.0, 1.0], [-0.0, 2.0]]), None),  # -0.0 is not the fill, bitwise
        (np.array([[np.nan, 1.0], [3.0, np.nan]]), np.nan),  # NaN fill matches NaN
        (np.array([[1, 0, 2], [0, 0, 3]], dtype=np.int32), None),
        (np.array([1.0 + 1j, 0, 2j]), None),
        (np.array([[True, False], [False, True]]), None),
        (np.array([[0, 7, 0], [2**15 + 3, 0, 1]], dtype=np.uint16), None),
        (np.array([[0, 2**31 + 9], [4, 0]], dtype=np.uint32), None),
        (np.array([[2**63 + 5, 0], [0, 7]], dtype=np.uint64), None),
        (np.array([[3, 9], [9, 1]], dtype=np.uint32), np.uint32(9)),
        (np.float64(5.0), None),  # a 0-d input is its own fill
        (np.zeros((3, 0)), None),
    ],
)
def test_from_numpy_matches(x, fill):
    t = st.COO.from_numpy(x, fill_value=fill, device=CPU)
    j = jsp.COO.from_numpy(x, fill_value=fill)
    _assert_same(t, j)
    np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_from_scipy_sparse(fmt):
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, 25, 150), rng.integers(0, 15, 150)
    m = scipy.sparse.coo_matrix((rng.standard_normal(150), (rows, cols)), shape=(25, 15)).asformat(fmt)
    t = st.COO.from_scipy_sparse(m, device=CPU)
    _assert_same(t, jsp.COO.from_scipy_sparse(m))
    _assert_same(st.COO(m, device=CPU), jsp.COO(m))


def test_single_argument_forms():
    x = np.diag([1.0, 0.0, 3.0])
    a = st.COO(x, device=CPU)
    _assert_same(a, jsp.COO(x))
    _assert_same(st.COO(a), jsp.COO(x))
    b = st.COO((np.array([1.0, 2.0]), (np.array([1, 0]), np.array([0, 2]))), device=CPU)
    _assert_same(b, jsp.COO((np.array([1.0, 2.0]), (np.array([1, 0]), np.array([0, 2])))))
    with pytest.raises(ValueError):
        st.COO("not an array", device=CPU)


def test_constructor_errors():
    with pytest.raises(IndexError):
        st.COO(np.array([[0, 5]]), np.array([1.0, 2.0]), shape=(3,), device=CPU)
    with pytest.raises(IndexError):
        st.COO(np.array([[-1]]), np.array([1.0]), shape=(3,), device=CPU)
    with pytest.raises(ValueError, match="does not match ndim"):
        st.COO(np.array([[0], [1]]), np.array([1.0]), shape=(3,), device=CPU)
    with pytest.raises(ValueError, match="data length"):
        st.COO(np.array([[0, 1]]), np.array([1.0]), shape=(3,), device=CPU)
    with pytest.raises(ValueError, match="cannot cast"):
        st.COO(np.array([[0]]), np.array([1.0]), shape=(1000,), idx_dtype=np.int8, device=CPU)
    with pytest.raises(ValueError, match="fill_value dtype"):
        st.COO(np.array([[0]]), np.array([1.0]), shape=(2,), fill_value=np.float32(1), device=CPU)


def test_properties():
    coords, data = _triplets(5, (10, 8), 30)
    t = st.COO(coords, data, shape=(10, 8), device=CPU)
    j = jsp.COO(coords, data, shape=(10, 8))
    assert (t.nnz, t.ndim, t.size, t.density) == (j.nnz, j.ndim, j.size, j.density)
    assert t.nbytes == t.data.numel() * 8 + t.coords.numel() * 4
    assert t.coords.dtype == torch.int32
    assert t.device == torch.device("cpu") and t.to("cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="todense"):
        np.asarray(t)


def test_tensor_inputs_stay_on_their_device():
    coords = torch.tensor([[2, 0, 2], [1, 1, 1]])
    t = st.COO(coords, torch.tensor([1.0, 2.0, 3.0]), shape=(3, 2))
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.todense().numpy(), [[0, 2], [0, 0], [0, 4]])


def test_to_row_ell_cached_and_rebuilt_on_buffer_replacement():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((128, 96)) * (rng.random((128, 96)) < 0.05)
    a = st.COO.from_numpy(x, device=CPU)
    a.enable_caching()
    re1 = a.to_row_ell()
    assert a.to_row_ell() is re1
    assert a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY) is re1
    b = rng.standard_normal((96, 8))
    np.testing.assert_allclose((a @ b).numpy(), x @ b, rtol=1e-10, atol=1e-12)
    a.data = a.data * 2  # buffer replaced: the cached layout must not be reused
    assert a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY) is None
    re2 = a.to_row_ell()
    assert re2 is not re1
    np.testing.assert_allclose((a @ b).numpy(), 2 * x @ b, rtol=1e-10, atol=1e-12)


def test_to_row_ell_requires_2d_zero_fill():
    with pytest.raises(ValueError, match="2-D"):
        st.COO.from_numpy(np.ones(3), device=CPU).to_row_ell()
    with pytest.raises(ValueError, match="zero fill"):
        st.COO.from_numpy(np.ones((2, 2)), fill_value=1.0, device=CPU).to_row_ell()


# -- _utils -------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "x,y",
    [
        (np.array([0.0, -0.0, np.nan, 1.0]), np.float64(0.0)),
        (np.array([0.0, -0.0, np.nan, 1.0]), np.array([-0.0, -0.0, np.nan, 2.0])),
        (np.array([1, 2, 3], dtype=np.int32), np.int32(2)),
        (np.array([1 + 1j, np.nan + 0j, -0.0 + 0j]), np.complex128(-0.0 + 0j)),
        (np.array([0.5, np.nan], dtype=np.float32), np.float32(np.nan)),
    ],
)
@pytest.mark.parametrize("loose", [False, True])
def test_equivalent_matches(x, y, loose):
    got = tutils.equivalent(torch.as_tensor(x), y, loose=loose).numpy()
    np.testing.assert_array_equal(got, jutils.equivalent(x, y, loose=loose))


@pytest.mark.parametrize("axis,ndim", [(0, 3), (-1, 3), ((0, -2), 4), (None, 2)])
def test_normalize_axis(axis, ndim):
    assert tutils.normalize_axis(axis, ndim) == jutils.normalize_axis(axis, ndim)


def test_normalize_axis_errors():
    for bad in (3, -4, (0, "a"), 1.5):
        with pytest.raises(ValueError):
            tutils.normalize_axis(bad, 3)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32, np.int64, np.float32])
@pytest.mark.parametrize("value", [-1, 100, 300, 2**31, 2**40])
def test_index_dtype_helpers(dtype, value):
    assert tutils.can_store(dtype, value) == jutils.can_store(dtype, value)
    if value >= 0 and np.issubdtype(dtype, np.integer):
        assert tutils.get_out_dtype(dtype, value) == jutils.get_out_dtype(dtype, value)
    assert tutils.index_dtype_for(abs(value)) == np.dtype(jutils.index_dtype_for(abs(value)))


def test_dtype_maps_and_zero():
    for dt in (np.bool_, np.int8, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64, np.float32, np.float64, np.complex128):
        assert tutils.numpy_dtype(tutils.torch_dtype(dt)) == np.dtype(dt)
        assert tutils.zero_of_dtype(dt) == jutils.zero_of_dtype(dt)
    with pytest.raises(TypeError):
        tutils.torch_dtype(np.dtype("U3"))
    assert tutils.result_dtype(torch.int32, torch.float32) == torch.float64  # NumPy's rule


def test_check_zero_fill_value():
    z = st.COO.from_numpy(np.eye(2), device=CPU)
    tutils.check_zero_fill_value(z, np.ones(2))
    nz = st.COO.from_numpy(np.eye(2), fill_value=1.0, device=CPU)
    with pytest.raises(ValueError, match="zero fill values"):
        tutils.check_zero_fill_value(z, nz)
    negzero = st.COO.from_numpy(np.eye(2), fill_value=-0.0, device=CPU)
    tutils.check_zero_fill_value(negzero)
