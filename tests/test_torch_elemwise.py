"""The port's element-wise operations against sparse_tpu's (CPU, small sizes).

Inputs come from numpy with a seed and go to both packages as numpy arrays.
Held exactly: the output type (COO or GCXS, and ``compressed_axes``), shape,
dtype, fill value (bitwise), coordinates (``indices``/``indptr`` for GCXS)
and, bit for bit, the data of the arithmetic, comparison, logical, bitwise,
rounding and selection ops. The transcendental ops and float ``power``,
``hypot``, ``logaddexp``, ``arctan2`` and ``round(decimals != 0)`` within 4
ulps, on inputs whose results lie far from the fill value. The grids mirror
tests/test_elemwise.py and tests/test_elemwise_scalars.py.
"""

import operator
import warnings
import zlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hst

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"

DTYPES = [np.bool_, np.int8, np.uint8, np.uint16, np.int32, np.int64, np.uint64, np.float16, np.float32, np.float64, np.complex128]

UNARY_EXACT = [
    np.negative, np.positive, np.absolute, np.sign, np.floor, np.ceil, np.trunc, np.rint, np.sqrt, np.square,
    np.reciprocal, np.conjugate, np.isnan, np.isinf, np.isfinite, np.signbit, np.logical_not, np.invert,
]
UNARY_ULPS = [
    np.sin, np.cos, np.tan, np.arcsin, np.arccos, np.arctan, np.sinh, np.cosh, np.tanh, np.arcsinh, np.arctanh,
    np.exp, np.expm1, np.log, np.log1p, np.log2, np.log10,
]
BINARY_EXACT = [
    np.add, np.subtract, np.multiply, np.true_divide, np.floor_divide, np.remainder, np.maximum, np.minimum,
    np.fmax, np.fmin, np.greater, np.greater_equal, np.less, np.less_equal, np.equal, np.not_equal,
    np.logical_and, np.logical_or, np.logical_xor, np.bitwise_and, np.bitwise_or, np.bitwise_xor,
    np.left_shift, np.right_shift, np.copysign, np.nextafter,
]
BINARY_ULPS = [np.power, np.hypot, np.logaddexp, np.arctan2]

# complex arithmetic within 4 ulps of the modulus: NumPy's complex loops use
# the CPU's fused multiply-adds and SIMD algorithms (ROADMAP §C2)
COMPLEX_ULPS = {np.multiply, np.true_divide, np.square, np.reciprocal, np.absolute, np.sign, np.sqrt, np.power}

# (op, dtype) pairs with no exact torch route: NotImplementedError
UNSUPPORTED = {(np.floor_divide, np.uint64), (np.remainder, np.uint64)}


# ---------------------------------------------------------------------------
# inputs and comparison
# ---------------------------------------------------------------------------


def _seed(*parts):
    return zlib.crc32(repr([getattr(p, "__name__", p) for p in parts]).encode()) % 10_000


def values(rng, n, dtype, kind="exact"):
    """``n`` values of ``dtype``: for ``"exact"`` a mix with negative
    integers, -0.0, ±inf and NaN; for ``"ulps"`` values in (0.15, 0.85)."""
    dt = np.dtype(dtype)
    if kind == "ulps":
        v = rng.uniform(0.15, 0.85, n)
        return (v + 1j * rng.uniform(0.15, 0.85, n)).astype(dt) if dt.kind == "c" else v.astype(dt)
    if dt.kind == "b":
        return rng.random(n) < 0.5
    if dt.kind == "u":
        v = rng.integers(0, 40, n).astype(dt)
        if dt.itemsize == 8:
            v[rng.random(n) < 0.2] = np.uint64(2**64 - 3)
        return v
    if dt.kind == "i":
        return rng.integers(-20, 21, n).astype(dt)
    v = rng.standard_normal(n) * 4
    special = rng.random(n)
    v[special < 0.05] = -0.0
    v[(special >= 0.05) & (special < 0.08)] = np.inf
    v[(special >= 0.08) & (special < 0.11)] = -np.inf
    v[(special >= 0.11) & (special < 0.14)] = np.nan
    if dt.kind == "c":
        return (v + 1j * rng.standard_normal(n)).astype(dt)
    return v.astype(dt)


def dense(seed, shape, dtype=np.float64, density=0.4, kind="exact", fill=None):
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    x = values(rng, size, dtype, kind).reshape(shape)
    mask = rng.random(shape) >= density
    x[mask] = np.zeros((), dtype=dtype) if fill is None else fill
    return x


def both(x, fmt="coo", fill=None, compressed_axes=None):
    """The dense ``x`` as a sparse array in both packages."""
    fill = None if fill is None else np.asarray(fill, dtype=x.dtype)[()]
    t = st.COO.from_numpy(x, fill_value=fill, device=CPU)
    j = jsp.COO.from_numpy(x, fill_value=fill)
    if fmt == "gcxs":
        t = st.GCXS.from_coo(t, compressed_axes=compressed_axes)
        j = jsp.GCXS.from_coo(j, compressed_axes=compressed_axes)
    return t, j


def np_of(t):
    return t.cpu().numpy()


def _bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "c":
        return np.stack([_bits(a.real), _bits(a.imag)])
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def assert_values(got, want, ulps=0, rtol=None):
    """``got`` (NumPy) equal to ``want``: bit for bit, within ``ulps`` units
    in the last place, or within ``rtol``."""
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if (ulps == 0 and rtol is None) or want.dtype.kind not in "fc":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want) & np.isfinite(want)
    np.testing.assert_array_equal(got[~ok & ~np.isnan(want)], want[~ok & ~np.isnan(want)])
    g, w = got[ok].astype(np.complex128), want[ok].astype(np.complex128)
    if rtol is not None:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
        return
    # ulps of the value's magnitude (of a complex value's modulus)
    tol = ulps * np.spacing(np.abs(want[ok]).astype(want.real.dtype)).astype(np.float64)
    err = np.abs(g - w)
    assert np.all(err <= tol), np.max(err / np.maximum(tol, 1e-300))


def assert_same(t, j, ulps=0, rtol=None, index_dtypes=True):
    """The port's result ``t`` against sparse_tpu's ``j``."""
    if isinstance(j, np.ndarray):
        assert isinstance(t, torch.Tensor), type(t)
        assert_values(np_of(t), j, ulps, rtol)
        return
    assert type(t).__name__ == type(j).__name__, (type(t), type(j))
    assert t.shape == j.shape
    assert numpy_dtype(t.dtype) == np.asarray(j.data).dtype
    assert_values(np.asarray(t.fill_value).reshape(1), np.asarray(j.fill_value).reshape(1), ulps, rtol)
    if type(j).__name__ == "COO":
        np.testing.assert_array_equal(np_of(t.coords), np.asarray(j.coords))
        if index_dtypes:
            assert numpy_dtype(t.coords.dtype) == np.asarray(j.coords).dtype
    else:
        assert t.compressed_axes == j.compressed_axes
        np.testing.assert_array_equal(np_of(t.indptr), np.asarray(j.indptr))
        np.testing.assert_array_equal(np_of(t.indices), np.asarray(j.indices))
        if index_dtypes:
            assert numpy_dtype(t.indices.dtype) == np.asarray(j.indices).dtype
            assert numpy_dtype(t.indptr.dtype) == np.asarray(j.indptr).dtype
    assert_values(np_of(t.data), np.asarray(j.data), ulps, rtol)


def run_both(fn_t, fn_j):
    """``fn_j()`` and ``fn_t()``; if sparse_tpu raises, the port must raise
    the same type. Returns ``(t, j)`` or ``None``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            j = fn_j()
        except Exception as e:  # noqa: BLE001 - the port must raise the same
            with pytest.raises(type(e)):
                fn_t()
            return None
        t = fn_t()
    return t, j


def check(fn_t, fn_j, ulps=0, rtol=None, index_dtypes=True):
    res = run_both(fn_t, fn_j)
    if res is not None:
        assert_same(*res, ulps=ulps, rtol=rtol, index_dtypes=index_dtypes)


# ---------------------------------------------------------------------------
# every table entry over every dtype, COO and GCXS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("func", UNARY_EXACT + UNARY_ULPS, ids=lambda f: f.__name__)
def test_unary_ops_match_sparse_tpu(func, dtype, fmt):
    ulps = 4 if func in UNARY_ULPS or (func in COMPLEX_ULPS and np.dtype(dtype).kind == "c") else 0
    kind = "ulps" if func in UNARY_ULPS else "exact"
    x = dense(_seed(func, dtype), (6, 7), dtype, kind=kind)
    t, j = both(x, fmt)
    check(lambda: func(t), lambda: func(j), ulps=ulps)


@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("func", BINARY_EXACT + BINARY_ULPS, ids=lambda f: f.__name__)
def test_binary_ops_match_sparse_tpu(func, dtype, fmt):
    ulps = 4 if func in BINARY_ULPS or (func in COMPLEX_ULPS and np.dtype(dtype).kind == "c") else 0
    kind = "ulps" if func in BINARY_ULPS else "exact"
    seed = _seed(func, dtype)
    x, y = dense(seed, (6, 7), dtype, kind=kind), dense(seed + 1, (6, 7), dtype, kind=kind)
    if func in (np.left_shift, np.right_shift) and np.dtype(dtype).kind in "iu":
        y = np.where(y != 0, np.abs(y.astype(np.int64)) % (8 * np.dtype(dtype).itemsize + 2), 0).astype(dtype)
    (t1, j1), (t2, j2) = both(x, fmt), both(y, fmt)
    if (func, dtype) in UNSUPPORTED:
        with pytest.raises(NotImplementedError, match=func.__name__):
            func(t1, t2)
        return
    check(lambda: func(t1, t2), lambda: func(j1, j2), ulps=ulps)


@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32, np.int64, np.uint16, np.uint32, np.float16, np.float32, np.float64])
@pytest.mark.parametrize("func", [np.floor_divide, np.remainder, np.true_divide], ids=lambda f: f.__name__)
def test_division_by_zero_matches_numpy(func, dtype, fmt):
    """A zero fill divides by the divisor's fill wherever only the dividend
    stores a value: NumPy gives 0 (integers) or inf/nan (floats)."""
    x = dense(3, (5, 6), dtype, density=0.6)
    y = dense(4, (5, 6), dtype, density=0.3)
    if np.dtype(dtype).kind in "iu":
        x[0, :] = np.iinfo(dtype).min if np.dtype(dtype).kind == "i" else x[0, :]
        y[0, :] = -1 if np.dtype(dtype).kind == "i" else y[0, :]
    (t1, j1), (t2, j2) = both(x, fmt), both(y, fmt)
    check(lambda: func(t1, t2), lambda: func(j1, j2))


def test_unsupported_pairs_raise_not_implemented():
    x = dense(1, (4, 5), np.uint64)
    t, _ = both(x)
    for func in (np.floor_divide, np.remainder):
        with pytest.raises(NotImplementedError, match=f"{func.__name__} of uint64"):
            func(t, t + np.uint64(1))
    with pytest.raises(NotImplementedError, match="greater with an out-of-range Python int of uint64"):
        t > -1
    with pytest.raises(NotImplementedError, match="exp2"):
        st.elemwise(np.exp2, t)
    with pytest.raises(TypeError):  # not in the table: __array_ufunc__ gives way
        np.exp2(t)


# ---------------------------------------------------------------------------
# broadcasting, operand kinds, fill values
# ---------------------------------------------------------------------------

BROADCAST_SHAPES = [
    [(4,), (3, 4)],
    [(4, 1), (4, 5)],
    [(3, 1, 4), (3, 5, 4)],
    [(2, 3, 4), (4,)],
    [(1, 5), (5, 1)],
    [(2, 1, 1), (1, 3, 4)],
]


@pytest.mark.parametrize("fills", [(None, None), (1.0, None), (np.nan, 2.0)], ids=["zero", "one", "nan"])
@pytest.mark.parametrize("func", [np.add, np.multiply, np.maximum, np.greater, np.subtract], ids=lambda f: f.__name__)
@pytest.mark.parametrize("shapes", BROADCAST_SHAPES, ids=str)
def test_broadcasting_matches_sparse_tpu(shapes, func, fills):
    x = dense(1, shapes[0], np.float64, fill=fills[0])
    y = dense(2, shapes[1], np.float64, fill=fills[1])
    (t1, j1), (t2, j2) = both(x, fill=fills[0]), both(y, fill=fills[1])
    check(lambda: func(t1, t2), lambda: func(j1, j2))
    check(lambda: func(t2, t1), lambda: func(j2, j1))


@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_trinary_broadcasting(fmt):
    x, y, z = dense(1, (2, 1, 4)), dense(2, (3, 1)), dense(3, (1, 4), density=0.7)
    (t1, j1), (t2, j2), (t3, j3) = both(x), both(y), both(z)
    check(lambda: st.elemwise(lambda a, b, c: a * b + c, t1, t2, t3), lambda: jsp.elemwise(lambda a, b, c: a * b + c, j1, j2, j3))
    x, y, z = dense(4, (4, 5)), dense(5, (4, 5)), dense(6, (4, 5))
    (t1, j1), (t2, j2), (t3, j3) = both(x, fmt), both(y, fmt), both(z, fmt)
    check(lambda: st.where(t1 > 0, t2, t3), lambda: jsp.where(j1 > 0, j2, j3))
    check(lambda: np.where(t1 > 0, t2, t3), lambda: np.where(j1 > 0, j2, j3))
    check(lambda: t1 + t2 + t3, lambda: j1 + j2 + j3)


@pytest.mark.parametrize("n_ops", [2, 3, 4, 5])
def test_many_same_shape_operands(n_ops):
    """Two to four take the packed sort; five the general union."""
    xs = [dense(10 + i, (5, 6)) for i in range(n_ops)]
    pairs = [both(x) for x in xs]
    f = (lambda *a: sum(a[1:], a[0])) if n_ops != 3 else (lambda a, b, c: a * b - c)
    check(lambda: st.elemwise(f, *[p[0] for p in pairs]), lambda: jsp.elemwise(f, *[p[1] for p in pairs]))


def test_same_pattern_keeps_the_coordinates():
    x = dense(7, (5, 6))
    t, j = both(x)
    check(lambda: t * t, lambda: j * j)
    check(lambda: np.add(t, t.copy()), lambda: np.add(j, j.copy()))
    assert (t * t).coords.dtype == t.coords.dtype


SCALARS = [2, -3, 2.5, True, np.float32(1.5), np.int8(3), np.float64(-0.0), 1 + 2j]


@pytest.mark.parametrize("scalar", SCALARS, ids=repr)
@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32, np.float16, np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("func", [np.add, np.multiply, np.subtract, np.greater, np.maximum, np.true_divide, np.power], ids=lambda f: f.__name__)
def test_python_and_numpy_scalars_match_sparse_tpu(func, dtype, scalar):
    """Weak Python scalars (NEP 50: float32 + 2.5 stays float32) and strong
    NumPy scalars, on either side."""
    kind = "ulps" if func is np.power else "exact"
    x = dense(8, (4, 5), dtype, kind=kind)
    t, j = both(x)
    complex_result = np.dtype(dtype).kind == "c" or isinstance(scalar, complex)
    ulps = 4 if func is np.power or (func in COMPLEX_ULPS and complex_result) else 0
    check(lambda: func(t, scalar), lambda: func(j, scalar), ulps=ulps)
    check(lambda: func(scalar, t), lambda: func(scalar, j), ulps=ulps)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_mixed_sparse_dense_operands(kind):
    x = dense(9, (4, 5))
    t, j = both(x)
    row = np.random.default_rng(0).standard_normal(5)
    full = np.random.default_rng(1).standard_normal((4, 5))
    conv = (lambda a: torch.as_tensor(a)) if kind == "tensor" else (lambda a: a)
    # fill * dense stays 0: a sparse result on the sparse operand's coordinates
    check(lambda: t * conv(row), lambda: j * row)
    check(lambda: conv(row[None, :]) * t, lambda: row[None, :] * j)
    check(lambda: np.multiply(t, conv(full)), lambda: np.multiply(j, full))
    # fill + dense varies but the dense operand spans the shape: a dense result
    check(lambda: t + conv(full), lambda: j + full)
    check(lambda: conv(full) + t, lambda: full + j)
    # ... and raises where it does not span it
    with pytest.raises(ValueError, match="mixed sparse-dense"):
        t + conv(row)
    with pytest.raises(ValueError, match="mixed sparse-dense"):
        j + row
    # a constant fill array: fill 1 * ones
    ones = np.ones((4, 5))
    t1, j1 = both(x, fill=1.0)
    check(lambda: t1 * conv(ones), lambda: j1 * ones)


def test_tensor_operands_reach_the_reflected_operators():
    x = dense(11, (4, 5))
    t, j = both(x)
    v = np.random.default_rng(2).standard_normal((4, 5))
    tv = torch.as_tensor(v)
    for op in (operator.add, operator.sub, operator.mul, operator.truediv, operator.gt, operator.le, operator.eq):
        assert_same(op(tv, t), op(v, j))


def test_device_rules():
    x = dense(12, (4, 5))
    t, _ = both(x)
    meta = torch.zeros((4, 5), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        t * meta
    out = t * np.ones((4, 5))
    assert out.device.type == "cpu" and out.data.device.type == "cpu"
    with pytest.raises(ValueError, match="None of the args is sparse"):
        st.elemwise(np.add, np.ones(2), np.ones(2))
    with pytest.raises(TypeError):
        t + object()


@pytest.mark.parametrize("fill", [0.0, 1.0, np.nan, -0.0], ids=repr)
@pytest.mark.parametrize("func", [np.add, np.multiply, np.maximum, np.fmin, np.copysign, np.equal], ids=lambda f: f.__name__)
def test_nonzero_and_nan_fill_values(func, fill):
    x = dense(13, (5, 4), fill=fill)
    y = dense(14, (5, 4), fill=2.0)
    (t1, j1), (t2, j2) = both(x, fill=fill), both(y, fill=2.0)
    check(lambda: func(t1, t2), lambda: func(j1, j2))
    check(lambda: func(t1, -0.0), lambda: func(j1, -0.0))


# ---------------------------------------------------------------------------
# the non-ufunc entries and the methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64, np.complex128, np.int32, np.uint8])
def test_methods_match_sparse_tpu(dtype, fmt):
    x = dense(15, (5, 6), dtype)
    t, j = both(x, fmt)
    check(lambda: t.round(), lambda: j.round())
    check(lambda: np.round(t), lambda: np.round(j))
    check(lambda: t.real, lambda: j.real)
    check(lambda: t.imag, lambda: j.imag)
    check(lambda: t.conj(), lambda: j.conj())
    check(lambda: t.isnan(), lambda: j.isnan())
    check(lambda: t.isinf(), lambda: j.isinf())
    check(lambda: st.isfinite(t), lambda: jsp.isfinite(j))
    check(lambda: st.isposinf(t), lambda: jsp.isposinf(j))
    check(lambda: st.isneginf(t), lambda: jsp.isneginf(j))
    check(lambda: st.abs(t), lambda: jsp.abs(j), ulps=4 if np.dtype(dtype).kind == "c" else 0)
    check(lambda: st.equal(t, t), lambda: jsp.equal(j, j))
    if np.dtype(dtype).kind != "c":
        check(lambda: t.clip(-1.5, 2), lambda: j.clip(-1.5, 2))
        check(lambda: st.clip(t, min=-1), lambda: jsp.clip(j, min=-1))
        check(lambda: np.clip(t, None, 1), lambda: np.clip(j, None, 1))


@pytest.mark.parametrize("decimals", [-1, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_round_with_decimals_within_4_ulps(dtype, decimals):
    x = dense(16, (5, 6), dtype, kind="ulps") * 10
    t, j = both(x.astype(dtype))
    check(lambda: t.round(decimals), lambda: j.round(decimals), ulps=4)


@pytest.mark.parametrize("src", [np.bool_, np.int8, np.int64, np.uint16, np.float16, np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("dst", [np.bool_, np.int32, np.uint8, np.float16, np.float32, np.float64, np.complex128])
def test_astype_matches_sparse_tpu(src, dst):
    x = dense(17, (4, 6), src, kind="ulps" if np.dtype(src).kind in "fc" else "exact")
    if np.dtype(src).kind in "fc":
        x = x * 60  # finite, in range of every integer type
    t, j = both(x)
    check(lambda: t.astype(dst), lambda: j.astype(dst))
    check(lambda: st.astype(t, dst), lambda: jsp.astype(j, dst))


def test_ufunc_out_and_outer():
    x, y = dense(18, (3, 4)), dense(19, (3, 4))
    (t1, j1), (t2, j2) = both(x), both(y)
    out_t, out_j = t1.copy(), j1.copy()
    np.add(t1, t2, out=out_t)
    np.add(j1, j2, out=out_j)
    assert_same(out_t, out_j)
    with pytest.raises(TypeError):
        np.add(t1, t2, out=(st.COO.from_numpy(np.zeros((3, 4), dtype=np.int8), device=CPU),), casting="same_kind")
    a, b = dense(20, (3,)), dense(21, (4,))
    (ta, ja), (tb, jb) = both(a), both(b)
    check(lambda: np.multiply.outer(ta, tb), lambda: np.multiply.outer(ja, jb))
    check(lambda: np.add.outer(ta, b), lambda: np.add.outer(ja, b))


# ---------------------------------------------------------------------------
# the differential property test
# ---------------------------------------------------------------------------

_BCAST = hst.lists(hst.integers(1, 4), min_size=1, max_size=3).flatmap(
    lambda shape: hst.tuples(
        hst.just(tuple(shape)),
        hst.tuples(*[hst.sampled_from([d, 1]) for d in shape]).map(tuple),
    )
)


@settings(max_examples=50, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    shapes=_BCAST,
    swap=hst.booleans(),
    densities=hst.tuples(hst.floats(0.0, 1.0), hst.floats(0.0, 1.0)),
    fills=hst.tuples(hst.sampled_from([0.0, 1.0, np.nan]), hst.sampled_from([0.0, 1.0, np.nan])),
    func=hst.sampled_from([np.add, np.subtract, np.multiply, np.true_divide, np.maximum, np.fmin, np.greater, np.not_equal, np.copysign, np.logical_and]),
    seed=hst.integers(0, 2**16),
)
def test_hypothesis_binary_ops_match_sparse_tpu(shapes, swap, densities, fills, func, seed):
    sa, sb = shapes if not swap else shapes[::-1]
    x = dense(seed, sa, density=densities[0], fill=fills[0])
    y = dense(seed + 1, sb, density=densities[1], fill=fills[1])
    (t1, j1), (t2, j2) = both(x, fill=fills[0]), both(y, fill=fills[1])
    check(lambda: func(t1, t2), lambda: func(j1, j2))
