"""The port's GCXS, CSR and CSC against sparse_tpu's (CPU, small sizes).

Inputs come from numpy with a seed and go to both packages as numpy arrays.
Layouts are held exactly: ``data`` bit for bit (the sign of zero included),
``indices`` and ``indptr`` by value and by dtype. Products against
sparse_tpu at rtol=1e-12 in float64 and 1e-5 in float32, other dtypes
against NumPy.
"""

import pickle
from itertools import combinations

import numpy as np
import pytest
import scipy.sparse
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch import interop
from sparse_tpu_torch._utils import numpy_dtype
from sparse_tpu_torch.core import gcxs as tg

CPU = "cpu"
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _dense(seed, shape, density=0.3, dtype=np.float64):
    """Unit-normal values at ``density``, a few stored as -0.0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(dtype)
    x[rng.random(shape) >= density] = 0
    x[(x != 0) & (rng.random(shape) < 0.05)] = -0.0
    return x


def _np(t):
    return t.cpu().numpy()


def _same_bits(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _assert_same_gcxs(t, j, index_dtypes=True):
    assert isinstance(t, tg.GCXS)
    assert type(t).__name__ == type(j).__name__
    assert t.shape == j.shape and t.compressed_axes == j.compressed_axes
    np.testing.assert_array_equal(_np(t.indptr), np.asarray(j.indptr))
    np.testing.assert_array_equal(_np(t.indices), np.asarray(j.indices))
    if index_dtypes:
        assert numpy_dtype(t.indices.dtype) == np.asarray(j.indices).dtype
        assert numpy_dtype(t.indptr.dtype) == np.asarray(j.indptr).dtype
    _same_bits(_np(t.data), np.asarray(j.data))
    _same_bits(np.asarray(t.fill_value), np.asarray(j.fill_value))


def _assert_same_coo(t, j):
    assert isinstance(t, st.COO) and t.shape == j.shape
    np.testing.assert_array_equal(_np(t.coords), np.asarray(j.coords))
    _same_bits(_np(t.data), np.asarray(j.data))
    _same_bits(np.asarray(t.fill_value), np.asarray(j.fill_value))


def _both(x, **kw):
    """``GCXS.from_coo`` of the dense ``x`` in both packages."""
    t = st.GCXS.from_coo(st.COO.from_numpy(x, device=CPU), **kw)
    j = jsp.GCXS.from_coo(jsp.COO.from_numpy(x), **kw)
    return t, j


def _axis_choices(ndim):
    if ndim == 1:
        return [None, (), (0,)]
    return [None, *[c for k in range(1, ndim) for c in combinations(range(ndim), k)]]


FROM_COO_CASES = [(shape, ca) for shape in [(20,), (5, 6), (5, 6, 7), (3, 4, 5, 6)] for ca in _axis_choices(len(shape))]


@pytest.mark.parametrize("shape,compressed_axes", FROM_COO_CASES)
def test_from_coo_and_back_match_sparse_tpu(shape, compressed_axes):
    x = _dense(len(shape), shape)
    t, j = _both(x, compressed_axes=compressed_axes)
    _assert_same_gcxs(t, j)
    _same_bits(_np(t.todense()), np.asarray(j.todense()))
    _assert_same_coo(t.tocoo(), j.tocoo())


@pytest.mark.parametrize("shape,want", [((10, 3), (1,)), ((3, 10), (0,)), ((4, 4), (0,)), ((6, 2, 5), (1,))])
def test_default_compressed_axes_is_the_shortest(shape, want):
    t, j = _both(_dense(1, shape))
    assert t.compressed_axes == j.compressed_axes == want


def test_1d_and_0d():
    x = _dense(2, (20,))
    t, j = _both(x)
    assert t.compressed_axes == () and t.indptr.shape == (2,)
    _assert_same_gcxs(t, j)
    _assert_same_coo(t.tocoo(), j.tocoo())
    for value in (np.array(3.0), np.array(0.0)):  # a 0-d array is its own fill: no entries
        t0, j0 = st.GCXS.from_numpy(value, device=CPU), jsp.GCXS.from_numpy(value)
        _assert_same_gcxs(t0, j0)
        assert t0.shape == () and _np(t0.todense()) == value


@pytest.mark.parametrize("shape", [(0, 5), (4, 0), (4, 5, 6)])
def test_empty_arrays(shape):
    x = np.zeros(shape)
    for ca in ([None, (0,), (1,)] if len(shape) == 2 else [None, (0, 2)]):
        t, j = _both(x, compressed_axes=ca)
        _assert_same_gcxs(t, j)
        _assert_same_coo(t.tocoo(), j.tocoo())
    if len(shape) == 3:
        t, j = _both(x, compressed_axes=(0,))
        _assert_same_gcxs(t.change_compressed_axes((2,)), j.change_compressed_axes((2,)))
        _assert_same_gcxs(t.transpose((1, 2, 0)), j.transpose((1, 2, 0)))


CHANGE_CASES = [
    (shape, a, b)
    for shape in [(4, 5, 6), (3, 2, 4, 5)]
    for a in _axis_choices(len(shape))[1:]
    for b in _axis_choices(len(shape))[1:]
    if a != b and (len(shape) == 3 or len(a) + len(b) <= 4)
]


@pytest.mark.parametrize("shape,ca,ca2", CHANGE_CASES)
def test_change_compressed_axes_matches_sparse_tpu_and_the_coo_route(shape, ca, ca2):
    t, j = _both(_dense(3, shape), compressed_axes=ca)
    got = t.change_compressed_axes(ca2)
    _assert_same_gcxs(got, j.change_compressed_axes(ca2))
    _assert_same_gcxs(got, jsp.GCXS.from_coo(j.tocoo(), compressed_axes=ca2))
    route = st.GCXS.from_coo(t.tocoo(), compressed_axes=ca2)
    for a, b in zip((got.indptr, got.indices, got.data), (route.indptr, route.indices, route.data)):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "a,b",
    [
        [(4, 5), (5, 4)],
        [(3, 4, 5), (12, 5)],
        [(60,), (3, 4, 5)],
        [(3, 4, 5), (60,)],
        [(3, 4, 5), (2, -1, 3)],
        [(6, 10), (60,)],
    ],
)
@pytest.mark.parametrize("compressed_axes", [None, (0,)])
def test_reshape_matches_sparse_tpu(a, b, compressed_axes):
    x = _dense(4, a)
    t, j = _both(x, compressed_axes=None if len(a) == 1 else compressed_axes)
    _assert_same_gcxs(t.reshape(b), j.reshape(b))
    _same_bits(_np(t.reshape(b).todense()), x.reshape(b))
    _assert_same_gcxs(t.flatten(), j.flatten())
    with pytest.raises(ValueError):
        t.reshape((7, 9))


@pytest.mark.parametrize("axes", [None, (1, 0, 2), (2, 1, 0), (0, 2, 1), (1, 2, 0)])
@pytest.mark.parametrize("ca", [(0,), (1, 2), (2,)])
def test_transpose_matches_sparse_tpu(axes, ca):
    x = _dense(5, (4, 5, 6))
    t, j = _both(x, compressed_axes=ca)
    _assert_same_gcxs(t.transpose(axes), j.transpose(axes))
    _assert_same_gcxs(t.transpose(axes, compressed_axes=(0,)), j.transpose(axes, compressed_axes=(0,)))
    _assert_same_gcxs(t.T, j.T)
    _assert_same_gcxs(t.mT, j.mT)


@pytest.mark.parametrize("trial", range(20))
def test_restructure_matches_sparse_tpu_and_the_coo_route(trial):
    rng = np.random.default_rng(trial)
    ndim = int(rng.integers(2, 5))
    shape = tuple(int(rng.integers(2, 9)) for _ in range(ndim))
    x = _dense(trial, shape)
    ca = tuple(sorted(rng.choice(ndim, size=int(rng.integers(1, ndim)), replace=False).tolist()))
    t, j = _both(x, compressed_axes=ca)
    ca2 = tuple(sorted(rng.choice(ndim, size=int(rng.integers(1, ndim)), replace=False).tolist()))
    _assert_same_gcxs(t.change_compressed_axes(ca2), j.change_compressed_axes(ca2))
    axes = tuple(rng.permutation(ndim).tolist())
    if axes != tuple(range(ndim)):
        for ca3 in [(0,)] if ndim == 2 else [None, (0,)]:
            got = t.transpose(axes, compressed_axes=ca3)
            _assert_same_gcxs(got, j.transpose(axes, compressed_axes=ca3))
            _same_bits(_np(got.todense()), x.transpose(axes))
    size = int(np.prod(shape))
    for ns in ((size // shape[-1], shape[-1]), (shape[0], size // shape[0])):
        if ns != shape:
            got = t.reshape(ns)
            _assert_same_gcxs(got, j.reshape(ns))
            route = st.GCXS.from_coo(tg._reshape_coo(t.tocoo(), ns))
            assert torch.equal(got.indptr, route.indptr) and torch.equal(got.indices, route.indices)


def test_2d_transpose_is_o1_on_the_same_tensors():
    t, j = _both(_dense(6, (5, 8)), compressed_axes=(0,))
    tt = t.transpose()
    assert tt.data is t.data and tt.indices is t.indices and tt.indptr is t.indptr
    assert tt.compressed_axes == (1,) and tt.shape == (8, 5)
    _assert_same_gcxs(tt, j.transpose())
    r = st.CSR.from_numpy(_dense(6, (5, 8)), device=CPU)
    c = r.T
    assert isinstance(c, st.CSC) and c.data is r.data and isinstance(c.T, st.CSR)
    copied = r.transpose(copy=True)
    assert isinstance(copied, st.CSC) and copied.data is not r.data and torch.equal(copied.data, r.data)
    assert r.transpose((0, 1)) is r
    with pytest.raises(ValueError):
        r.transpose((0, 0))


@pytest.mark.parametrize("cls", ["CSR", "CSC"])
def test_csr_csc_match_sparse_tpu(cls):
    x = _dense(7, (6, 8), density=0.4)
    t, j = getattr(st, cls).from_numpy(x, device=CPU), getattr(jsp, cls).from_numpy(x)
    _assert_same_gcxs(t, j)
    _assert_same_gcxs(t.T, j.T)
    assert t.format == j.format == cls.lower()
    coo_t, coo_j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    _assert_same_gcxs(getattr(st, cls)(coo_t), getattr(jsp, cls)(coo_j))
    _assert_same_gcxs(getattr(st, cls)(x, device=CPU), getattr(jsp, cls)(x))
    other = st.GCXS.from_coo(coo_t, compressed_axes=(1,) if cls == "CSR" else (0,))
    other_j = jsp.GCXS.from_coo(coo_j, compressed_axes=other.compressed_axes)
    _assert_same_gcxs(getattr(st, cls)(other), getattr(jsp, cls)(other_j))
    with pytest.raises(ValueError, match="only accepts"):
        getattr(st, cls)(x, compressed_axes=(0,) if cls == "CSC" else (1,), device=CPU)
    with pytest.raises(ValueError, match="2-d"):
        getattr(st, cls)(np.ones((2, 2, 2)), device=CPU)


def test_scipy_round_trip():
    m = scipy.sparse.random(8, 9, density=0.3, random_state=0, format="csr")
    dup = scipy.sparse.csr_matrix((np.ones(4), ([0, 0, 2, 2], [1, 1, 3, 4])), shape=(3, 5))  # duplicates summed
    for src in (m, dup):
        t, j = st.GCXS.from_scipy_sparse(src, device=CPU), jsp.GCXS.from_scipy_sparse(src)
        _assert_same_gcxs(t, j)
        back = t.to_scipy_sparse()
        assert type(back) is type(j.to_scipy_sparse())
        np.testing.assert_array_equal(back.toarray(), src.toarray())
        for cls in ("CSR", "CSC"):
            tc, jc = getattr(st, cls).from_scipy_sparse(src, device=CPU), getattr(jsp, cls).from_scipy_sparse(src)
            _assert_same_gcxs(tc, jc)
            b2 = tc.to_scipy_sparse()
            assert type(b2) is type(jc.to_scipy_sparse())
            np.testing.assert_array_equal(b2.toarray(), src.toarray())
    _assert_same_gcxs(st.GCXS(m, device=CPU), jsp.GCXS(m))
    with pytest.raises(ValueError):
        st.GCXS.from_numpy(np.ones((2, 2, 2)), device=CPU).to_scipy_sparse()
    with pytest.raises(ValueError, match="fill_value"):
        st.GCXS.from_numpy(np.ones((2, 3)), fill_value=1.0, device=CPU).to_scipy_sparse()


@pytest.mark.parametrize("as_tensors", [False, True])
def test_triple_constructor(as_tensors):
    m = scipy.sparse.random(5, 6, density=0.3, random_state=0, format="csr")
    arrays = (m.data, m.indices, m.indptr)
    args = tuple(torch.as_tensor(a) for a in arrays) if as_tensors else arrays
    t = st.GCXS(args, shape=(5, 6), compressed_axes=(0,), device=None if as_tensors else CPU)
    _assert_same_gcxs(t, jsp.GCXS(arrays, shape=(5, 6), compressed_axes=(0,)))
    np.testing.assert_array_equal(_np(t.todense()), m.toarray())
    with pytest.raises(ValueError, match="shape"):
        st.GCXS(args, device=CPU)
    pruned = np.array(m.data)
    pruned[::2] = 0
    tp = st.GCXS((pruned, m.indices, m.indptr), shape=(5, 6), compressed_axes=(0,), prune=True, device=CPU)
    _assert_same_gcxs(tp, jsp.GCXS((pruned, m.indices, m.indptr), shape=(5, 6), compressed_axes=(0,), prune=True))


def test_from_numpy_constructor_and_gcxs_of_gcxs():
    x = _dense(8, (4, 5), density=0.5)
    t, j = st.GCXS(x, device=CPU), jsp.GCXS(x)
    _assert_same_gcxs(t, j)
    _assert_same_gcxs(st.GCXS(t, compressed_axes=(1,)), jsp.GCXS(j, compressed_axes=(1,)))
    coo_t, coo_j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    _assert_same_gcxs(st.GCXS(coo_t, compressed_axes=(0,)), jsp.GCXS(coo_j, compressed_axes=(0,)))
    t0, j0 = st.GCXS.from_numpy(x, compressed_axes=(0,), device=CPU), jsp.GCXS.from_numpy(x, compressed_axes=(0,))
    _assert_same_gcxs(t0, j0)
    with pytest.raises(ValueError, match="Invalid inputs"):
        st.GCXS([1, 2, 3])


@pytest.mark.parametrize(
    "shape,ca", [((4, 5), (0, 1)), ((4, 5), ()), ((4,), (1,)), ((4, 5, 6), (0, 0)), ((4, 5), (2,)), ((), (0,))]
)
def test_invalid_compressed_axes_raise_in_both(shape, ca):
    x = np.ones(shape)
    with pytest.raises(ValueError):
        jsp.GCXS.from_coo(jsp.COO.from_numpy(x), compressed_axes=ca)
    with pytest.raises(ValueError):
        st.GCXS.from_coo(st.COO.from_numpy(x, device=CPU), compressed_axes=ca)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.complex128])
def test_nbytes_density_str_and_properties(dtype):
    x = _dense(9, (10, 10), density=0.2).astype(dtype)
    t, j = _both(x)
    assert t.nbytes == j.nbytes and t.density == j.density and t.nnz == j.nnz and t.size == j.size
    assert numpy_dtype(t.dtype) == j.dtype and t.format == j.format == "gcxs" and t.ndim == 2
    # the dtype is a torch dtype, as a COO's is (ROADMAP §C2)
    assert str(t).replace("torch.", "").startswith(str(j)[:-1]) and str(t).endswith("device=cpu>")
    assert t._compressed_shape == j._compressed_shape and t._axis_order == j._axis_order


def test_fill_values():
    x = _dense(10, (4, 5), density=0.5)
    x[x == 0] = 3.0
    t, j = st.GCXS.from_numpy(x, fill_value=3.0, device=CPU), jsp.GCXS.from_numpy(x, fill_value=3.0)
    _assert_same_gcxs(t, j)
    assert float(t.fill_value) == 3.0
    _same_bits(_np(t.todense()), np.asarray(j.todense()))
    _assert_same_gcxs(t.change_compressed_axes((1,)), j.change_compressed_axes((1,)))
    _assert_same_gcxs(st.GCXS(t, fill_value=3.0), jsp.GCXS(j, fill_value=3.0))
    b = np.ones((5, 2))
    with pytest.raises(ValueError, match="zero fill"):
        j @ b
    for fn in (
        lambda: t @ b,
        lambda: st.matmul(t, b),
        lambda: st.dot(t, b),
        lambda: st.matvec_add(t, np.ones(5), np.ones(4)),
    ):
        with pytest.raises(ValueError, match="zero fill"):
            fn()


@pytest.mark.parametrize("fmt", ["coo", "gcxs", "csr", "csc", st.CSR, st.GCXS])
def test_asformat_both_ways(fmt):
    x = _dense(11, (6, 7), density=0.4)
    tc, jc = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    jfmt = fmt if isinstance(fmt, str) else fmt.__name__.lower()
    got, want = tc.asformat(fmt), jc.asformat(jfmt)
    if jfmt == "coo":
        assert got is tc
    else:
        _assert_same_gcxs(got, want)
    for ca in [(0,), (1,)]:
        tg_, jg = _both(x, compressed_axes=ca)
        got, want = tg_.asformat(fmt), jg.asformat(jfmt)
        if jfmt == "coo":
            _assert_same_coo(got, want)
        else:
            _assert_same_gcxs(got, want)
        _assert_same_gcxs(tg_.asformat("gcxs", compressed_axes=(1,)), jg.asformat("gcxs", compressed_axes=(1,)))
    _assert_same_gcxs(tc.asformat("gcxs", compressed_axes=(1,)), jc.asformat("gcxs", compressed_axes=(1,)))
    with pytest.raises(ValueError):
        st.COO.from_numpy(np.ones((2, 2, 2)), device=CPU).asformat("csr")
    with pytest.raises(NotImplementedError):
        tc.asformat("bsr")


@pytest.mark.parametrize("kind", ["tocsr", "tocsc"])
def test_coo_tocsr_tocsc_match_sparse_tpu(kind):
    x = _dense(12, (7, 9), density=0.4)
    got, want = getattr(st.COO.from_numpy(x, device=CPU), kind)(), getattr(jsp.COO.from_numpy(x), kind)()
    assert type(got) is type(want) and got.has_canonical_format
    for attr in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    _same_bits(got.data, want.data)
    with pytest.raises(ValueError):
        getattr(st.COO.from_numpy(np.ones((2, 2, 2)), device=CPU), kind)()


def test_index_dtypes_against_sparse_tpu():
    x = _dense(13, (8, 7, 6), density=0.5)
    t, j = _both(x, compressed_axes=(0,), idx_dtype=np.uint8)
    _assert_same_gcxs(t, j)  # uint8 kept in both
    for ns in ((56, 6), (336, 1)):  # minimal upcast past 255: uint8 -> uint16
        _assert_same_gcxs(t.reshape(ns), j.reshape(ns))
    assert numpy_dtype(t.reshape((336, 1)).indptr.dtype) == np.uint16
    _assert_same_gcxs(t.change_compressed_axes((2,)), j.change_compressed_axes((2,)))
    # both keep narrow coordinates: uint8
    assert t.tocoo().coords.dtype == torch.uint8 and np.asarray(j.tocoo().coords).dtype == np.uint8
    np.testing.assert_array_equal(_np(t.tocoo().coords), np.asarray(j.tocoo().coords))
    with pytest.raises(ValueError):
        st.GCXS.from_coo(st.COO.from_numpy(np.ones((300, 2)), device=CPU), idx_dtype=np.uint8)


def test_gcxs_from_arrays_carries_state_as_it_is():
    x = _dense(14, (9, 11), density=0.3)
    for ca, idx_dtype in (((0,), None), ((1,), np.uint8)):
        j = jsp.GCXS.from_coo(jsp.COO.from_numpy(x), compressed_axes=ca, idx_dtype=idx_dtype)
        arrays = (np.asarray(j.data), np.asarray(j.indices), np.asarray(j.indptr))
        t = interop.gcxs_from_arrays(*arrays, j.shape, j.compressed_axes, device=CPU)
        _assert_same_gcxs(t, j)
        b = np.random.default_rng(0).standard_normal((11, 3))
        np.testing.assert_allclose(_np(t @ b), np.asarray(j @ b), rtol=1e-12)
    j = jsp.GCXS.from_numpy(np.where(x == 0, 2.0, x), fill_value=2.0)
    arrays = (np.asarray(j.data), np.asarray(j.indices), np.asarray(j.indptr))
    t = interop.gcxs_from_arrays(*arrays, j.shape, None, fill_value=2.0, device=CPU)
    assert t.compressed_axes == j.compressed_axes
    _same_bits(_np(t.todense()), np.asarray(j.todense()))


def _operands(fmt, x):
    tc, jc = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    if fmt in ("CSR", "CSC"):
        return getattr(st, fmt)(tc), getattr(jsp, fmt)(jc)
    ca = (0,) if fmt == "GCXS0" else (1,)
    return st.GCXS.from_coo(tc, compressed_axes=ca), jsp.GCXS.from_coo(jc, compressed_axes=ca)


FORMATS = ["CSR", "CSC", "GCXS0", "GCXS1"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(50, 40), (7, 300), (300, 7)])
@pytest.mark.parametrize("n", [None, 1, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_products_match_sparse_tpu(fmt, shape, n, dtype):
    x = _dense(15, shape, density=0.1, dtype=dtype)
    t, j = _operands(fmt, x)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((shape[1],) if n is None else (shape[1], n)).astype(dtype)
    want = np.asarray(j @ b)
    for got in (t @ b, st.matmul(t, b), st.dot(t, b), t.dot(b), t @ torch.as_tensor(b)):
        assert got.dtype == torch.float32 if dtype == np.float32 else torch.float64
        np.testing.assert_allclose(_np(got), want, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(want).max())
    # the same bits as the COO's product
    assert torch.equal(t @ b, st.COO.from_numpy(x, device=CPU) @ b)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matvec_add_matches_sparse_tpu(fmt, dtype):
    x = _dense(16, (60, 45), density=0.1, dtype=dtype)
    t, j = _operands(fmt, x)
    rng = np.random.default_rng(2)
    v, y = rng.standard_normal(45).astype(dtype), rng.standard_normal(60).astype(dtype)
    want = np.asarray(jsp.matvec_add(j, v, y))
    got = st.matvec_add(t, v, y)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(want).max())
    assert torch.equal(got, st.matvec_add(st.COO.from_numpy(x, device=CPU), v, y))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize(
    "a_dt,b_dt", [(np.int64, np.int64), (np.int32, np.int64), (np.complex128, np.float64), (np.int64, np.float32)]
)
def test_products_of_other_dtypes_match_numpy(fmt, a_dt, b_dt):
    rng = np.random.default_rng(3)
    x = (rng.integers(-4, 5, (30, 20)) * (rng.random((30, 20)) < 0.2)).astype(a_dt)
    if np.issubdtype(a_dt, np.complexfloating):
        x = x + 1j * x[::-1]
    t, _ = _operands(fmt, x)
    for b in (rng.integers(-3, 4, (20, 5)).astype(b_dt), rng.integers(-3, 4, 20).astype(b_dt)):
        got = t @ b
        want = x @ b
        assert numpy_dtype(got.dtype) == want.dtype
        np.testing.assert_allclose(_np(got), want, rtol=1e-6 if want.dtype == np.float32 else 1e-12)


def test_products_reuse_the_held_coo_and_its_layout():
    x = _dense(17, (64, 48), density=0.1)
    b = np.random.default_rng(4).standard_normal((48, 8))
    for t in (st.CSR.from_numpy(x, device=CPU), st.CSC.from_numpy(x, device=CPU)):
        out1 = t @ b
        coo = t._product_coo()
        # on the CPU the product runs on the host library, on the row
        # indptr kept on the COO (the row-ELL layout is the GPU's)
        layout = coo.peek_layout("host_indptr", None)
        assert layout is not None
        out2 = t @ b
        assert t._product_coo() is coo and coo.peek_layout("host_indptr", None) is layout
        assert torch.equal(out1, out2)
        st.matvec_add(t, np.ones(48), np.ones(64))
        assert t._product_coo() is coo
        _assert_same_coo(coo, jsp.COO.from_numpy(x))
        # a replaced buffer builds the COO anew
        t.data = t.data * 2
        assert t._product_coo() is not coo
        assert torch.allclose(t @ b, 2 * out1)


@pytest.mark.parametrize(
    "call",
    [
        lambda g: g.reshape((6, 2), order="F"),
    ],
)
def test_unported_parts_raise_not_implemented(call):
    g = st.GCXS.from_numpy(_dense(18, (4, 3)), device=CPU)
    with pytest.raises(NotImplementedError):
        call(g)


def test_pickle_copy_and_device():
    x = _dense(19, (6, 5), density=0.5)
    t = st.CSR.from_numpy(x, device=CPU)
    t @ np.ones(5)
    back = pickle.loads(pickle.dumps(t))
    assert isinstance(back, st.CSR) and "_coo_memo" not in back.__dict__
    for a, b in zip((back.data, back.indices, back.indptr), (t.data, t.indices, t.indptr)):
        assert torch.equal(a, b)
    deep, shallow = t.copy(), t.copy(deep=False)
    assert deep.data is not t.data and torch.equal(deep.data, t.data) and shallow.data is t.data
    assert t.device == torch.device("cpu") and t.to("cpu").indptr.device.type == "cpu"
    with pytest.raises(ValueError, match="use .to"):
        st.GCXS(t, device="meta")


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("the default device is usable here")
    with pytest.raises(RuntimeError, match="device"):
        st.GCXS.from_numpy(np.eye(3))
    with pytest.raises(RuntimeError, match="device"):
        interop.gcxs_from_arrays(np.ones(1), np.zeros(1, np.int32), np.array([0, 1, 1], np.int32), (2, 2), (0,))
