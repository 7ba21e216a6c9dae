"""Sparse × sparse products (SpGEMM) of the port against sparse_tpu's own
results (CPU): ``a @ b``, ``dot``, ``matmul`` (2-D, 1-D, batched with
broadcasting) and ``tensordot`` of two sparse operands in every format pair,
every ``return_type`` and NumPy's dtypes, and the traceable
``kernels.esc_spgemm``/``jitops.spgemm`` against the JAX package's.

Same inputs, drawn with numpy from a seed, through both packages. Held
equal: classes, shapes, ``compressed_axes``, coordinates (``indices``,
``indptr``) by value and by dtype, fill values and value dtypes. Values:
integers and booleans exactly; float64 within 1e-12 and float32 within
1e-6 of ``Σ_k |a_ik||b_kj|`` (the float64 oracle of each entry's scale);
float16 within one float16 ulp of that scale; complex within 4 ulps of the
scale's modulus. The traceable form is held bit for bit against JAX's: it
sums each run in the same order.

The deliberate difference (ROADMAP §C2): the port drops every computed sum
equal to zero, -0.0 too, as sparse_tpu's native route (float32/float64 at
``NATIVE_MIN_NNZ`` entries or more) does; sparse_tpu's NumPy route keeps a
-0.0 sum.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu import jitops as jjit
from sparse_tpu.kernels.spgemm import esc_spgemm as jesc
from sparse_tpu.kernels.spgemm import product_count as jcount
from sparse_tpu.native import eager as jeager
from sparse_tpu_torch._utils import numpy_dtype
from sparse_tpu_torch.kernels import LAUNCHES, _cuda, esc_spgemm, product_count, reset_launch_counts
from sparse_tpu_torch.kernels import spgemm as kspgemm

CPU = "cpu"
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def _dense(shape, density, seed, dtype=np.float64):
    """Values at ``density``, +0.0 elsewhere (so no stored -0.0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    mask = rng.random(shape) < density
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return mask & (x > -0.5)
    if np.issubdtype(dt, np.unsignedinteger):
        x = np.abs(np.round(x * 4)) + 1
    elif np.issubdtype(dt, np.integer):
        x = np.round(x * 4)
    elif np.issubdtype(dt, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    x = np.where(mask, x, 0)
    return x.astype(dt)


def _pair(x, fmt="coo"):
    t, j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    if fmt == "coo":
        return t, j
    return t.asformat(fmt), j.asformat(fmt)


def _np(t):
    return t.cpu().numpy()


def _dense_of(x):
    if isinstance(x, st.SparseArray):
        return _np(x.todense())
    if isinstance(x, jsp.SparseArray):
        return np.asarray(x.todense())
    return _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _values_close(got, want, dtype, scale):
    dt = np.dtype(dtype)
    got, want = np.asarray(got), np.asarray(want)
    if dt == np.bool_ or np.issubdtype(dt, np.integer):
        np.testing.assert_array_equal(got, want)
        return
    scale = np.abs(np.asarray(scale, dtype=np.float64))
    if dt == np.float16:
        bound = np.spacing(scale.astype(np.float16)).astype(np.float64)
    elif np.issubdtype(dt, np.complexfloating):
        bound = 4 * np.finfo(dt).eps * scale
    else:
        bound = TOL[dt.type] * scale
    err = np.abs(got.astype(np.complex128 if np.iscomplexobj(got) else np.float64) - want)
    assert (err <= bound).all(), float((err - bound).max())


def _check(got, want, a_np=None, b_np=None, product=None):
    """``got`` (port) against ``want`` (sparse_tpu): class, shape, layout,
    dtypes, fill value; values against the entry scale ``|a| @ |b|``."""
    product = product or (lambda x, y: x @ y)
    scale = product(np.abs(a_np).astype(np.float64), np.abs(b_np).astype(np.float64)) if a_np is not None else None
    if isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert numpy_dtype(got.dtype) == want.dtype and tuple(got.shape) == want.shape
        _values_close(_np(got), want, want.dtype, scale if scale is not None else np.abs(want))
        return
    assert type(got).__name__ == type(want).__name__, (type(got), type(want))
    assert got.shape == want.shape
    assert numpy_dtype(got.dtype) == np.asarray(want.data).dtype
    assert np.asarray(got.fill_value).tobytes() == np.asarray(want.fill_value).tobytes()
    if isinstance(want, jsp.COO):
        np.testing.assert_array_equal(_np(got.coords), np.asarray(want.coords))
        assert numpy_dtype(got.coords.dtype) == np.asarray(want.coords).dtype
        pos = tuple(np.asarray(want.coords))
    else:
        assert got.compressed_axes == want.compressed_axes
        for name in ("indices", "indptr"):
            np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
            assert numpy_dtype(getattr(got, name).dtype) == np.asarray(getattr(want, name)).dtype, name
        pos = tuple(np.asarray(want.tocoo().coords))
    want_data = np.asarray(want.data) if isinstance(want, jsp.COO) else np.asarray(want.tocoo().data)
    got_data = _np(got.data) if isinstance(got, st.COO) else _np(got.tocoo().data)
    entry_scale = scale[pos] if scale is not None else np.abs(want_data)
    _values_close(got_data, want_data, want_data.dtype, entry_scale)


# ---------------------------------------------------------------------------
# formats, entry points, return types
# ---------------------------------------------------------------------------

FORMAT_PAIRS = [
    ("coo", "coo"),
    ("csr", "csr"),
    ("csc", "csc"),
    ("gcxs", "gcxs"),
    ("coo", "csr"),
    ("csc", "coo"),
    ("csr", "csc"),
    ("csc", "csr"),
    ("coo", "gcxs"),
]


@pytest.mark.parametrize("fa,fb", FORMAT_PAIRS)
@pytest.mark.parametrize("entry", ["matmul_op", "matmul", "dot"])
def test_formats_and_entry_points_match_sparse_tpu(fa, fb, entry):
    x, y = _dense((30, 40), 0.2, 1), _dense((40, 25), 0.2, 2)
    (ta, ja), (tb, jb) = _pair(x, fa), _pair(y, fb)
    call = {"matmul_op": lambda p, a, b: a @ b, "matmul": lambda p, a, b: p.matmul(a, b), "dot": lambda p, a, b: p.dot(a, b)}[entry]
    _check(call(st, ta, tb), call(jsp, ja, jb), x, y)


@pytest.mark.parametrize("fa,fb", [("coo", "coo"), ("csr", "csr"), ("csc", "csc"), ("coo", "csc")])
def test_formats_above_the_native_threshold(fa, fb):
    # sparse_tpu's C++ Gustavson route (and its CSR x CSR direct route)
    x, y = _dense((120, 150), 0.15, 3), _dense((150, 90), 0.15, 4)
    (ta, ja), (tb, jb) = _pair(x, fa), _pair(y, fb)
    assert ja.nnz + jb.nnz >= jeager.NATIVE_MIN_NNZ
    _check(ta @ tb, ja @ jb, x, y)


@pytest.mark.parametrize("return_type", [None, "coo", "gcxs", "ndarray", "tensor"])
@pytest.mark.parametrize("fa,fb", [("coo", "coo"), ("csr", "csr"), ("coo", "csc")])
def test_tensordot_return_types(return_type, fa, fb):
    x, y = _dense((12, 15), 0.3, 5), _dense((15, 9), 0.3, 6)
    (ta, ja), (tb, jb) = _pair(x, fa), _pair(y, fb)
    rt_t = {None: None, "coo": st.COO, "gcxs": st.GCXS, "ndarray": np.ndarray, "tensor": torch.Tensor}[return_type]
    rt_j = {None: None, "coo": jsp.COO, "gcxs": jsp.GCXS, "ndarray": np.ndarray, "tensor": np.ndarray}[return_type]
    _check(st.tensordot(ta, tb, axes=1, return_type=rt_t), jsp.tensordot(ja, jb, axes=1, return_type=rt_j), x, y)


@pytest.mark.parametrize(
    "a_shape,b_shape,axes",
    [
        ((4, 5, 6), (5, 6, 3), 2),
        ((4, 5, 6), (6, 3), 1),
        ((4, 5, 6), (3, 6, 5), ((1, 2), (2, 1))),
        ((4, 5, 6), (6, 4), ((0, 2), (1, 0))),
        ((5, 6), (6, 5), ([1], [0])),
        ((6, 5), (6, 5), (0, 0)),
        ((3, 4), (2, 5), 0),  # the outer product
        ((4, 5, 6), (4, 5, 6), 3),  # a full contraction
    ],
)
@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_tensordot_axes_forms(a_shape, b_shape, axes, fmt):
    x, y = _dense(a_shape, 0.35, 7), _dense(b_shape, 0.35, 8)
    (ta, ja), (tb, jb) = _pair(x, fmt), _pair(y, fmt)
    got, want = st.tensordot(ta, tb, axes=axes), jsp.tensordot(ja, jb, axes=axes)
    if isinstance(want, jsp.SparseArray) and want.ndim == 0:
        assert got.shape == () and np.allclose(_dense_of(got), _dense_of(want), rtol=1e-12, atol=1e-12)
        return
    _check(got, want, x, y, product=lambda p, q: np.tensordot(p, q, axes=axes))


@pytest.mark.parametrize(
    "a_shape,b_shape,entry",
    [
        *[(a, b, e) for a, b in (((6,), (6, 4)), ((5, 6), (6,)), ((6,), (6,))) for e in ("matmul", "dot")],
        ((6,), (3, 6, 4), "matmul"),
        ((3, 5, 6), (6,), "matmul"),
        ((3, 5, 6), (6,), "dot"),
    ],
)
def test_one_dimensional_operands(a_shape, b_shape, entry):
    x, y = _dense(a_shape, 0.6, 9), _dense(b_shape, 0.6, 10)
    (ta, ja), (tb, jb) = _pair(x), _pair(y)
    got, want = getattr(st, entry)(ta, tb), getattr(jsp, entry)(ja, jb)
    if len(a_shape) == len(b_shape) == 1:
        assert isinstance(got, torch.Tensor) and got.shape == ()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12)
        return
    _check(got, want, x, y, product=np.matmul)


@pytest.mark.parametrize(
    "a_shape,b_shape",
    [
        ((3, 5, 6), (3, 6, 4)),
        ((1, 5, 6), (3, 6, 4)),  # broadcast
        ((3, 5, 6), (6, 4)),
        ((5, 6), (2, 6, 4)),
        ((2, 1, 5, 6), (3, 6, 4)),
    ],
)
@pytest.mark.parametrize("fa,fb", [("coo", "coo"), ("gcxs", "gcxs"), ("coo", "gcxs")])
def test_batched_matmul(a_shape, b_shape, fa, fb):
    x, y = _dense(a_shape, 0.4, 11), _dense(b_shape, 0.4, 12)
    (ta, ja), (tb, jb) = _pair(x, fa), _pair(y, fb)
    _check(st.matmul(ta, tb), jsp.matmul(ja, jb), x, y, product=np.matmul)


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

DTYPES = [np.bool_, np.int64, np.uint8, np.uint16, np.uint32, np.uint64, np.float16, np.float32, np.float64, np.complex128]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_dtypes_match_sparse_tpu(dtype, fmt):
    x, y = _dense((25, 30), 0.3, 13, dtype), _dense((30, 20), 0.3, 14, dtype)
    (ta, ja), (tb, jb) = _pair(x, fmt), _pair(y, fmt)
    _check(ta @ tb, ja @ jb, x, y)


@pytest.mark.parametrize(
    "da,db",
    [(np.int8, np.uint8), (np.float32, np.int64), (np.bool_, np.float64), (np.int32, np.float32), (np.complex64, np.float64)],
    ids=lambda d: np.dtype(d).name,
)
def test_mixed_dtypes_promote_as_numpy(da, db):
    x, y = _dense((20, 25), 0.3, 15, da), _dense((25, 15), 0.3, 16, db)
    (ta, ja), (tb, jb) = _pair(x), _pair(y)
    _check(ta @ tb, ja @ jb, x, y)


def test_boolean_runs_sum_as_or():
    # every output entry is a run of 300 True products
    x, y = np.ones((3, 300), dtype=bool), np.ones((300, 2), dtype=bool)
    (ta, ja), (tb, jb) = _pair(x), _pair(y)
    got = ta @ tb
    _check(got, ja @ jb, x, y)
    assert got.data.dtype == torch.bool and bool(got.data.all()) and got.nnz == 6


def test_integer_sums_wrap_as_numpy():
    x = np.full((2, 40), 200, dtype=np.uint8)
    y = np.full((40, 3), 3, dtype=np.uint8)
    (ta, ja), (tb, jb) = _pair(x), _pair(y)
    _check(ta @ tb, ja @ jb, x, y)
    np.testing.assert_array_equal(_dense_of(ta @ tb), x @ y)


# ---------------------------------------------------------------------------
# structure: empty operands, cancellation, -0.0, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "x,y",
    [
        (np.zeros((4, 5)), _dense((5, 3), 0.5, 17)),  # no A entry
        (_dense((4, 5), 0.5, 18), np.zeros((5, 3))),  # no B entry
        (np.eye(4, 5), np.vstack([np.zeros((4, 3)), np.ones((1, 3))])),  # A's entries meet only empty B rows
        (np.zeros((0, 5)), np.ones((5, 3))),
        (np.ones((4, 0)), np.ones((0, 3))),
        (np.ones((4, 5)), np.ones((5, 0))),
    ],
)
@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_empty_products(x, y, fmt):
    (ta, ja), (tb, jb) = _pair(x, fmt), _pair(y, fmt)
    got, want = ta @ tb, ja @ jb
    assert got.nnz == want.nnz == 0
    _check(got, want, x, y)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_computed_zeros_are_dropped(fmt):
    x, y = np.array([[1.0, 1.0]]), np.array([[1.0], [-1.0]])
    (ta, ja), (tb, jb) = _pair(x, fmt), _pair(y, fmt)
    got, want = ta @ tb, ja @ jb
    assert got.nnz == want.nnz == 0
    _check(got, want, x, y)


def _negative_zero_operands(n):
    """``n`` products, one -0.0 among them: ``a[0, 0] * b[0, 0] = (-1) * 0.0``
    stored as a -0.0 in ``b``."""
    x = np.zeros((n, n))
    x[np.arange(n), np.arange(n)] = np.arange(1, n + 1)
    x[0, 0] = -1.0
    y = np.eye(n) * 2.0
    y[0, 0] = 0.0
    t_b = st.COO.from_numpy(y, device=CPU)
    j_b = jsp.COO.from_numpy(y)
    # store the zero: COO.from_numpy prunes +0.0
    coords = np.stack([np.arange(n), np.arange(n)])
    data = np.where(np.arange(n) == 0, 0.0, 2.0)
    t_b = st.COO(coords, data, shape=(n, n), device=CPU)
    j_b = jsp.COO(coords, data, shape=(n, n))
    return st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x), t_b, j_b


@pytest.mark.parametrize("native", [False, True], ids=["numpy_route", "native_route"])
def test_negative_zero_rule(native, monkeypatch):
    """A -0.0 sum: the port drops it, as sparse_tpu's native route does;
    sparse_tpu's NumPy route (below ``NATIVE_MIN_NNZ``) keeps it."""
    monkeypatch.setattr(jeager, "NATIVE_MIN_NNZ", 0 if native else 10**9)
    ta, ja, tb, jb = _negative_zero_operands(6)
    got, want = ta @ tb, ja @ jb
    assert got.nnz == 5 and not bool(torch.signbit(got.data).any())
    want_data = np.asarray(want.data)
    if native:
        _check(got, want)
    else:
        assert want.nnz == 6 and np.signbit(want_data[0]) and want_data[0] == 0
        np.testing.assert_array_equal(_np(got.coords), np.asarray(want.coords)[:, 1:])
        np.testing.assert_array_equal(_np(got.data), want_data[1:])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_sums_equal_the_native_route_bit_for_bit(dtype):
    # the port adds each run in product order (k ascending) from its first
    # product, as the native Gustavson loop does: the same bits
    x, y = _dense((200, 180), 0.08, 19, dtype), _dense((180, 150), 0.08, 20, dtype)
    (ta, ja), (tb, jb) = _pair(x), _pair(y)
    assert ja.nnz + jb.nnz >= jeager.NATIVE_MIN_NNZ
    got, want = ta @ tb, ja @ jb
    np.testing.assert_array_equal(_np(got.coords), np.asarray(want.coords))
    assert _np(got.data).tobytes() == np.asarray(want.data).tobytes()
    # runs of two and more products occur
    assert product_count(ta.coords[1], tb.coords[0], 180) > got.nnz


def test_nan_warning_fill_value_and_shape_errors():
    x = _dense((4, 5), 0.6, 21)
    x[0, 0] = np.nan
    ta, _ = _pair(x)
    tb, _ = _pair(_dense((5, 3), 0.6, 22))
    with pytest.warns(RuntimeWarning, match="Nan will not be propagated"):
        st.matmul(ta, tb)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        st.dot(ta, tb)  # dot does not warn, as in sparse_tpu
    t1 = st.COO.from_numpy(np.where(x == 0, 1.0, x), fill_value=1.0, device=CPU)
    with pytest.raises(ValueError, match="zero fill"):
        t1 @ tb
    with pytest.raises(ValueError, match="zero fill"):
        st.tensordot(tb.T, t1, axes=1)
    with pytest.raises(ValueError, match="shape-mismatch"):
        ta @ ta
    with pytest.raises(ValueError, match="shape-mismatch"):
        st.dot(ta, tb.T)


def test_narrow_coordinates_multiply():
    x, y = _dense((20, 30), 0.3, 23), _dense((30, 12), 0.3, 24)
    for dt in (np.uint8, np.int16, np.uint16):
        ta = st.COO(np.stack(np.nonzero(x)).astype(dt), x[np.nonzero(x)], shape=x.shape, device=CPU)
        ja = jsp.COO(np.stack(np.nonzero(x)).astype(dt), x[np.nonzero(x)], shape=x.shape)
        assert numpy_dtype(ta.coords.dtype) == np.asarray(ja.coords).dtype == dt
        tb, jb = _pair(y)
        _check(ta @ tb, ja @ jb, x, y)
        _check(tb.T @ ta.T, jb.T @ ja.T, y.T, x.T)


# ---------------------------------------------------------------------------
# the traceable form
# ---------------------------------------------------------------------------


def _esc_both(a, b, k, n, extra=0, out_capacity=None, dtype=None):
    ra, ca = np.asarray(a.coords)
    rb, cb = np.asarray(b.coords)
    da, db = np.asarray(a.data), np.asarray(b.data)
    if dtype is not None:
        da, db = da.astype(dtype), db.astype(dtype)
    cap = jcount(ca, rb, k)
    assert product_count(torch.as_tensor(ca), torch.as_tensor(rb), k) == product_count(ca, rb, k) == cap
    cap += extra
    ocap = cap if out_capacity is None else out_capacity
    j = jesc(*map(jnp.asarray, (ra, ca, da, rb, cb, db)), k=k, n=n, product_capacity=cap, out_capacity=ocap)
    t = esc_spgemm(*map(torch.as_tensor, (ra, ca, da, rb, cb, db)), k=k, n=n, product_capacity=cap, out_capacity=ocap)
    return t, j


def _same_esc(t, j):
    assert int(t[3]) == int(j[3]) and t[3].shape == ()
    for got, want in zip(t[:3], j[:3]):
        want = np.asarray(want)
        assert numpy_dtype(got.dtype) == want.dtype and tuple(got.shape) == want.shape
        assert _np(got).tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16, np.int64, np.complex128])
@pytest.mark.parametrize("shapes,density,extra", [(((25, 20), (20, 30)), (0.2, 0.2), 5), (((30, 40), (40, 8)), (0.3, 0.5), 3)])
def test_esc_spgemm_matches_jax_bit_for_bit(dtype, shapes, density, extra):
    (m, k), (_, n) = shapes
    a = jsp.random((m, k), density=density[0], random_state=0)
    b = jsp.random((k, n), density=density[1], random_state=1)
    t, j = _esc_both(a, b, k, n, extra=extra, dtype=dtype)
    _same_esc(t, j)
    nnz = int(t[3])
    res = np.zeros((m, n), dtype=np.complex128 if dtype == np.complex128 else np.float64)
    res[_np(t[0])[:nnz], _np(t[1])[:nnz]] = _np(t[2])[:nnz]
    ref = a.todense().astype(dtype) @ b.todense().astype(dtype)
    np.testing.assert_allclose(res, ref, rtol=1e-2 if dtype == np.float16 else 1e-5, atol=1e-2 if dtype == np.float16 else 1e-6)
    keys = _np(t[0])[:nnz].astype(np.int64) * n + _np(t[1])[:nnz]
    assert (np.diff(keys) > 0).all()
    assert (_np(t[0])[nnz:] == np.iinfo(np.int32).max).all() and (_np(t[2])[nnz:] == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_esc_spgemm_empty_b_rows(dtype):
    # most B rows empty: most A entries own no product
    rng = np.random.default_rng(7)
    m = kk = n = 400
    a = jsp.random((m, kk), density=0.05, random_state=2)
    import scipy.sparse as sp

    bm = sp.coo_array((rng.standard_normal(60), (np.sort(rng.integers(0, 3, 60)), rng.integers(0, n, 60))), shape=(kk, n))
    bm.sum_duplicates()
    b = jsp.COO.from_scipy_sparse(bm)
    t, j = _esc_both(a, b, kk, n, extra=7, dtype=dtype)
    _same_esc(t, j)


def test_esc_spgemm_empty_and_short_capacity():
    z = torch.zeros(1, dtype=torch.int32)
    out = esc_spgemm(z, z, torch.zeros(1), z, z, torch.zeros(1), k=4, n=4, product_capacity=4, out_capacity=4)
    assert int(out[3]) == 1 and out[2].tolist() == [0.0] * 4  # a computed zero is kept
    e = torch.zeros(0, dtype=torch.int32)
    out = esc_spgemm(e, e, torch.zeros(0), z, z, torch.ones(1), k=4, n=4, product_capacity=4, out_capacity=3)
    assert int(out[3]) == 0 and out[0].tolist() == [np.iinfo(np.int32).max] * 3
    # an output capacity below the count keeps the first entries
    a = jsp.random((20, 20), density=0.3, random_state=5)
    t, j = _esc_both(a, a, 20, 20, out_capacity=10)
    _same_esc(t, j)


@pytest.mark.parametrize("out_capacity", [None, 40])
def test_jitops_spgemm_matches_jax(out_capacity):
    rng = np.random.default_rng(5)
    dA = rng.random((15, 12)) * (rng.random((15, 12)) < 0.3)
    dB = rng.random((12, 10)) * (rng.random((12, 10)) < 0.3)
    ta, ja = _pair(dA)
    tb, jb = _pair(dB)
    cap = max(product_count(ta.coords[1], tb.coords[0], 12), 1)
    got, nnz = st.jitops.spgemm(ta, tb, product_capacity=cap, out_capacity=out_capacity)
    want, jnnz = jjit.spgemm(ja, jb, product_capacity=cap, out_capacity=out_capacity)
    assert int(nnz) == int(jnnz) and nnz.shape == ()
    assert numpy_dtype(got.coords.dtype) == np.asarray(want.coords).dtype
    assert _np(got.coords).tobytes() == np.asarray(want.coords).tobytes()
    assert _np(got.data).tobytes() == np.asarray(want.data).tobytes()
    assert got.shape == want.shape and got.fill_value == want.fill_value
    n = min(int(nnz), got.nnz)
    np.testing.assert_array_equal(_np(got.coords)[:, n:], 0)
    eager = ta @ tb
    np.testing.assert_array_equal(_np(got.coords)[:, :n], _np(eager.coords)[:, :n])
    np.testing.assert_allclose(_np(got.data)[:n], _np(eager.data)[:n], rtol=1e-12)
    with pytest.raises(ValueError, match="2-D"):
        st.jitops.spgemm(ta.reshape((1, 15, 12)), tb, product_capacity=cap)


def test_einsum_of_two_sparse_matrices_is_their_product():
    x, y = _dense((20, 30), 0.3, 25), _dense((30, 15), 0.3, 26)
    (ta, _), (tb, _) = _pair(x), _pair(y)
    got, want = st.einsum("ij,jk->ik", ta, tb), ta @ tb
    assert torch.equal(got.coords, want.coords) and _np(got.data).tobytes() == _np(want.data).tobytes()


# ---------------------------------------------------------------------------
# S1 (csrc/spgemm.cu): what of it runs on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "products",
    [[0, 5, 5, 0, 9, 1], [3], [0, 0, 0], [7, 7, 7, 7], [1, 1000, 2, 1000, 0, 3], list(range(50))],
    ids=lambda p: f"{len(p)}_rows",
)
def test_row_plan_puts_the_largest_rows_first(products):
    order, counts = kspgemm.row_plan(torch.tensor(products, dtype=torch.int64))
    assert counts.tolist() == sorted(products, reverse=True)
    # stable among equal counts, empty rows last
    want = sorted(range(len(products)), key=lambda r: (-products[r], r))
    assert order.tolist() == want
    assert counts.dtype == order.dtype == torch.int64


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3])
def test_row_products_sum_to_the_product_count(density):
    x, y = _dense((40, 30), density, 31), _dense((30, 20), density, 32)
    (ta, _), (tb, _) = _pair(x), _pair(y)
    ptr_a = torch.searchsorted(ta.coords[0], torch.arange(41))
    ptr_b = torch.searchsorted(tb.coords[0], torch.arange(31))
    per_row = kspgemm.row_products(ptr_a, ta.coords[1], ptr_b)
    want = [(np.abs(x[i]) > 0).astype(np.int64) @ (np.abs(y) > 0).sum(1) for i in range(40)]
    assert per_row.tolist() == want and per_row.dtype == torch.int64
    assert int(per_row.sum()) == product_count(ta.coords[1], tb.coords[0], 30)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 65_536, 65_537, 100_000, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spgemm_plan_sizes_its_chunks_and_shared_memory(n, dtype):
    plan = _cuda.spgemm_plan(n, dtype)
    assert plan.span % 64 == 0 and 64 <= plan.span <= _cuda.SPGEMM_CHUNK_COLS
    assert plan.span >= min(n, _cuda.SPGEMM_CHUNK_COLS) and plan.span < max(n, 1) + 64
    chunks = -(-n // plan.span)  # a row takes only those it has columns in
    assert (chunks == 1) == (n <= _cuda.SPGEMM_CHUNK_COLS)
    item = 4 if dtype == torch.float32 else 8
    assert plan.vcap == min(_cuda.SPGEMM_CACHE_BYTES // item, plan.span)


@pytest.mark.parametrize(
    "device, dtype, want",
    [("cpu", torch.float32, False), ("cpu", torch.float64, False), ("cuda", torch.float32, True), ("cuda", torch.float64, True), ("cuda", torch.int64, False), ("cuda", torch.bool, False), ("cuda", torch.float16, False), ("cuda", torch.complex128, False)],
)
def test_the_kernel_route_is_chosen_by_device_and_dtype(device, dtype, want):
    assert kspgemm.on_kernel(torch.device(device), dtype) is want


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_products_never_touch_the_kernels(monkeypatch, fmt, dtype):
    def refuse(name):
        raise AssertionError(f"a CPU product loaded {name}")

    monkeypatch.setattr(_cuda, "load", refuse)
    x, y = _dense((30, 40), 0.2, 33, dtype), _dense((40, 25), 0.2, 34, dtype)
    (ta, ja), (tb, jb) = _pair(x, fmt), _pair(y, fmt)
    reset_launch_counts()
    got = ta @ tb
    assert not any(LAUNCHES.values())
    _check(got, ja @ jb, x, y)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_spgemm_coords_on_the_cpu_is_the_stacked_plain_product(index_dtype):
    x, y = _dense((25, 35), 0.2, 35), _dense((35, 30), 0.2, 36)
    (ta, _), (tb, _) = _pair(x), _pair(y)
    coords, vals = kspgemm.spgemm_coords(*ta.coords, ta.data, *tb.coords, tb.data, m=25, k=35, n=30, index_dtype=index_dtype)
    rows, cols, want = kspgemm.spgemm(*ta.coords, ta.data, *tb.coords, tb.data, m=25, k=35, n=30)
    assert coords.dtype == index_dtype and torch.equal(coords.long(), torch.stack([rows, cols]))
    assert _np(vals).tobytes() == _np(want).tobytes()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_kernel_entry_points_raise_off_a_cuda_device(device):
    ptr = torch.zeros(3, dtype=torch.int64, device=device)
    cols = torch.zeros(0, dtype=torch.int32, device=device)
    vals = torch.zeros(0, dtype=torch.float32, device=device)
    one = torch.zeros(2, dtype=torch.int64, device=device)
    scratch = torch.zeros(1, dtype=torch.int64, device=device)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.spgemm_symbolic(ptr, cols, ptr, cols, one, one, 2, scratch, one.clone())
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.spgemm_numeric(ptr, cols, vals, ptr, cols, vals, one, one, 2, ptr, torch.zeros((2, 0), dtype=torch.int32, device=device), vals, scratch, scratch.clone())
    assert LAUNCHES["spgemm"] == 0
