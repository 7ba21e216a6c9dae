"""The rest of the port's namespace against sparse_tpu's (CPU, small sizes):
``sort``, ``argmax``/``argmin`` and ``unique_counts``/``unique_values`` on
inputs that mix ±0.0, NaN and ties with a zero, nonzero or NaN fill value;
``interp`` bit for bit in float64 (NumPy's cases: outside the samples,
``left``/``right``, exact sample points, NaN, one sample, ``period``, complex
``fp``); ``kron``, ``triu``/``tril``, ``nonzero``/``argwhere``, ``roll``,
``flip``, ``pad``, ``outer``, ``repeat``, ``tile``; the conversions and dtype
predicates; the creation functions; ``random`` for several seeds and
formats; and the COO and array methods that came with them. Sparse results
are held exactly (coordinates and their dtype, data bit for bit, fill
value), dense ones bit for bit, unless a line says otherwise.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse
import torch
from test_torch_elemwise import _bits, assert_same, dense
from torch_index_cases import tricky

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"


def _pair(x, fill=None):
    fv = None if fill is None else np.asarray(fill, dtype=x.dtype)[()]
    return st.COO.from_numpy(x, fill_value=fv, device=CPU), jsp.COO.from_numpy(x, fill_value=fv)


def _run(t_fn, j_fn):
    """``(t, j)``, or ``None`` after checking that both raise the same type."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            j = j_fn()
        except Exception as e:  # noqa: BLE001 - the port must raise the same
            with pytest.raises(type(e)):
                t_fn()
            return None
        return t_fn(), j


def _check(t_fn, j_fn):
    res = _run(t_fn, j_fn)
    if res is None:
        return
    t, j = res
    if isinstance(j, np.ndarray):
        assert isinstance(t, torch.Tensor) and numpy_dtype(t.dtype) == j.dtype and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))
    else:
        assert_same(t, j)


SORT_CASES = [
    ((12,), -1),
    ((5, 7), 1),
    ((5, 7), 0),
    ((5, 7), -1),
    ((3, 4, 6), 2),
    ((3, 4, 6), 0),
]
SORT_FILLS = {np.float64: [None, 0.5, -1.0, np.nan], np.float32: [None, 1.0, np.nan], np.int16: [None, 2], np.uint8: [None, 3], np.bool_: [None, True]}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("shape,axis", SORT_CASES, ids=str)
@pytest.mark.parametrize(
    "dtype,fill", [(d, f) for d, fs in SORT_FILLS.items() for f in fs], ids=lambda v: repr(v) if not isinstance(v, type) else np.dtype(v).name
)
def test_sort_matches_sparse_tpu(dtype, fill, shape, axis, descending):
    x = tricky(7, shape, dtype, fill)
    t, j = _pair(x, fill)
    _check(lambda: st.sort(t, axis=axis, descending=descending), lambda: jsp.sort(j, axis=axis, descending=descending))


def test_sort_errors_and_dense_oracle():
    x = tricky(8, (4, 9), np.float64)
    t, _ = _pair(x)
    with pytest.raises(ValueError):
        st.sort(t, stable=True)
    np.testing.assert_array_equal(st.sort(t, axis=1).todense().numpy(), np.sort(x, axis=1))
    np.testing.assert_array_equal(st.sort(t, axis=0, descending=True).todense().numpy(), -np.sort(-x, axis=0))


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("func", ["argmax", "argmin"])
@pytest.mark.parametrize(
    "dtype,fill",
    [(np.float64, None), (np.float64, 0.5), (np.float64, np.nan), (np.float64, -np.inf), (np.float32, None), (np.int16, None), (np.int16, -2), (np.uint8, 4), (np.bool_, None)],
    ids=repr,
)
def test_argmax_argmin_match_sparse_tpu(dtype, fill, func, axis, keepdims):
    for seed, density in ((9, 0.6), (10, 0.15), (11, 1.0)):
        x = tricky(seed, (6, 8), dtype, fill, density)
        t, j = _pair(x, fill)
        _check(lambda: getattr(st, func)(t, axis=axis, keepdims=keepdims), lambda: getattr(jsp, func)(j, axis=axis, keepdims=keepdims))
        if not np.isnan(x).any() if x.dtype.kind == "f" else True:
            want = getattr(np, func)(x, axis=axis, keepdims=keepdims)
            np.testing.assert_array_equal(getattr(st, func)(t, axis=axis, keepdims=keepdims).todense().numpy(), want)


def test_argmax_3d_and_errors():
    x = tricky(12, (3, 4, 5), np.float64, density=0.4)
    t, j = _pair(x)
    for axis in (0, 1, 2):
        _check(lambda: st.argmax(t, axis=axis), lambda: jsp.argmax(j, axis=axis))
    for bad in ((0, 1), np.int64(0), 3):
        _check(lambda: st.argmax(t, axis=bad), lambda: jsp.argmax(j, axis=bad))
    e_t, e_j = _pair(np.zeros((3, 0)))
    _check(lambda: st.argmin(e_t, axis=1), lambda: jsp.argmin(e_j, axis=1))


def _assert_unique_same(t, j):
    """The port's ``unique_*`` against sparse_tpu's: the values by value (the
    sign of a kept zero and the order among equal values are not NumPy's to
    define; ROADMAP §C2), NaN where sparse_tpu has NaN, the dtype, and each
    run of equal values with the same counts."""
    tv, jv = (t.values, j.values) if hasattr(j, "values") else (t, j)
    tv = tv.numpy()
    assert tv.dtype == jv.dtype and tv.shape == jv.shape
    np.testing.assert_array_equal(tv, jv)  # NaN equals NaN here, -0.0 equals 0.0
    if hasattr(j, "counts"):
        tc, jc = t.counts.numpy(), j.counts
        assert tc.dtype == np.int64
        with np.errstate(invalid="ignore"):
            key = np.where(np.isnan(jv), np.arange(jv.size) + 0.5, jv) if jv.dtype.kind == "f" else jv
        for v in np.unique(key):
            sel = key == v
            np.testing.assert_array_equal(np.sort(tc[sel]), np.sort(jc[sel]))


@pytest.mark.parametrize("func", ["unique_counts", "unique_values"])
@pytest.mark.parametrize(
    "dtype,fill",
    [(np.float64, None), (np.float64, -0.0), (np.float64, 0.5), (np.float64, np.nan), (np.float32, None), (np.float32, 3.0), (np.int16, None), (np.int16, 1), (np.uint8, None), (np.bool_, None), (np.bool_, True)],
    ids=repr,
)
def test_unique_matches_sparse_tpu(dtype, fill, func):
    for seed, shape in ((13, (4, 5)), (14, (3, 2, 4)), (15, (40,))):
        x = tricky(seed, shape, dtype, fill)
        t, j = _pair(x, fill)
        _assert_unique_same(getattr(st, func)(t), getattr(jsp, func)(j))


def test_unique_zero_rule_and_storage_order():
    """The kept zero is the first zero in storage order, on every device."""
    t = st.COO(np.array([[0, 1, 2, 3]]), np.array([-0.0, 0.0, 1.0, -0.0]), shape=(6,), fill_value=5.0, device=CPU)
    vals, counts = st.unique_counts(t)
    assert vals.numpy().tobytes() == np.array([-0.0, 1.0, 5.0]).tobytes() and counts.tolist() == [3, 1, 2]
    t2 = st.COO(np.array([[0, 1]]), np.array([0.0, -0.0]), shape=(2,), fill_value=1.0, device=CPU)
    assert st.unique_values(t2).numpy().tobytes() == np.array([0.0]).tobytes()


XP = np.array([-1.0, 0.0, 0.5, 0.5, 2.0, 3.5])
FP = np.array([2.0, -1.0, 4.0, 1.0, 0.25, np.inf])


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"left": -7.0}, {"right": 9.0}, {"left": -7.0, "right": np.nan}, {"period": 2.5}, {"period": -1.5}],
    ids=repr,
)
@pytest.mark.parametrize("fill", [None, 0.5, np.nan, 3.5, -2.0], ids=repr)
def test_interp_is_numpys_bits(fill, kwargs):
    rng = np.random.default_rng(16)
    x = rng.uniform(-3, 5, (6, 7))
    x.flat[:8] = [-1.0, 0.0, 0.5, 2.0, 3.5, np.nan, -0.0, 1.25]  # sample points, NaN, -0.0
    x[rng.random(x.shape) < 0.3] = 0.0 if fill is None else fill
    t, j = _pair(x, fill)
    _check(lambda: st.interp(t, XP, FP, **kwargs), lambda: jsp.interp(j, XP, FP, **kwargs))
    got = st.interp(t, XP, FP, **kwargs).todense().numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.interp(x, XP, FP, **kwargs)))
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(_bits(st.interp(xt, torch.as_tensor(XP), FP, **kwargs).numpy()), _bits(np.interp(x, XP, FP, **kwargs)))


def test_interp_random_grids_bit_for_bit():
    rng = np.random.default_rng(17)
    for n in (1, 2, 3, 5, 40):
        xp = np.sort(rng.uniform(-10, 10, n))
        fp = rng.standard_normal(n) * 1e3
        x = rng.uniform(-12, 12, 500)
        x[:n] = xp
        want = np.interp(x, xp, fp)
        got = st.ops.common._interp_tensor(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    fp_c = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    xp = np.sort(rng.uniform(0, 1, 5))
    x = np.append(rng.uniform(-0.2, 1.2, 50), np.nan)
    got = st.ops.common._interp_tensor(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp_c))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.interp(x, xp, fp_c)))
    x32 = st.COO.from_numpy(np.array([0.0, 0.25, 0.5], dtype=np.float32), device=CPU)
    assert st.interp(x32, [0, 1], [1, 3]).dtype == torch.float64
    for bad in (dict(xp=[], fp=[]), dict(xp=[0, 1], fp=[1.0]), dict(xp=[0, 1], fp=[1.0, 2.0], period=0)):
        with pytest.raises(ValueError):
            st.interp(x32, **bad)


def _narrow(x, idx_dtype):
    nz = np.nonzero(x)
    c = np.stack(nz).astype(idx_dtype)
    return st.COO(c, x[nz], shape=x.shape, device=CPU), jsp.COO(c, x[nz], shape=x.shape)


@pytest.mark.parametrize("idx_dtype", [None, np.uint8, np.int16])
def test_structural_functions_match_sparse_tpu(idx_dtype):
    x = dense(18, (5, 6), np.float64, density=0.5)
    y = dense(19, (3, 4), np.float64, density=0.5)
    t, j = _pair(x) if idx_dtype is None else _narrow(x, idx_dtype)
    u, v = _pair(y) if idx_dtype is None else _narrow(y, idx_dtype)
    cases = [
        (lambda: st.kron(t, u), lambda: jsp.kron(j, v)),
        (lambda: st.kron(t, y), lambda: jsp.kron(j, y)),
        (lambda: st.kron(t[0], u), lambda: jsp.kron(j[0], v)),
        (lambda: st.kron(t, 2.0), lambda: jsp.kron(j, 2.0)),
        (lambda: st.triu(t), lambda: jsp.triu(j)),
        (lambda: st.triu(t, 2), lambda: jsp.triu(j, 2)),
        (lambda: st.tril(t, 1), lambda: jsp.tril(j, 1)),
        (lambda: st.tril(t[0]), lambda: jsp.tril(j[0])),
        (lambda: st.roll(t, 2, axis=1), lambda: jsp.roll(j, 2, axis=1)),
        (lambda: st.roll(t, (1, 4), axis=(0, 1)), lambda: jsp.roll(j, (1, 4), axis=(0, 1))),
        (lambda: st.roll(t, 7), lambda: jsp.roll(j, 7)),
        (lambda: st.roll(t, -2, axis=0), lambda: jsp.roll(j, -2, axis=0)),
        (lambda: st.roll(t, 300, axis=0), lambda: jsp.roll(j, 300, axis=0)),
        (lambda: st.roll(t, (1, 2), axis=0), lambda: jsp.roll(j, (1, 2), axis=0)),
        (lambda: st.flip(t), lambda: jsp.flip(j)),
        (lambda: st.flip(t, axis=1), lambda: jsp.flip(j, axis=1)),
        (lambda: st.flip(t, axis=(0, -1)), lambda: jsp.flip(j, axis=(0, -1))),
        (lambda: st.pad(t, ((1, 2), (0, 3))), lambda: jsp.pad(j, ((1, 2), (0, 3)))),
        (lambda: st.pad(t, 2), lambda: jsp.pad(j, 2)),
        (lambda: st.pad(t, 1, constant_values=1.0), lambda: jsp.pad(j, 1, constant_values=1.0)),
        (lambda: st.pad(t, 1, mode="edge"), lambda: jsp.pad(j, 1, mode="edge")),
        (lambda: st.repeat(t, 3, axis=1), lambda: jsp.repeat(j, 3, axis=1)),
        (lambda: st.repeat(t, 2), lambda: jsp.repeat(j, 2)),
        (lambda: st.repeat(t, 2, axis=-2), lambda: jsp.repeat(j, 2, axis=-2)),
        (lambda: st.tile(t, 2), lambda: jsp.tile(j, 2)),
        (lambda: st.tile(t, (2, 1, 3)), lambda: jsp.tile(j, (2, 1, 3))),
        (lambda: st.outer(u, y[0]), lambda: jsp.outer(v, y[0])),
        (lambda: st.nonzero(t), lambda: tuple(jsp.nonzero(j))),
    ]
    for f_t, f_j in cases:
        res = _run(f_t, f_j)
        if res is None:
            continue
        got, want = res
        if isinstance(want, tuple):
            for g, w in zip(got, want, strict=True):
                assert numpy_dtype(g.dtype) == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
        elif isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert_same(got, want)
    np.testing.assert_array_equal(st.argwhere(t).numpy(), jsp.argwhere(j))
    # a negative k on narrow coordinates: int64 arithmetic (sparse_tpu's
    # uint8 sum raises OverflowError there; ROADMAP §C2)
    np.testing.assert_array_equal(st.tril(t, -1).todense().numpy(), np.tril(x, -1))
    np.testing.assert_array_equal(st.triu(t, -2).todense().numpy(), np.triu(x, -2))


def test_structural_errors_match_sparse_tpu():
    x = dense(20, (5, 6), np.float64, density=0.5)
    t, j = _pair(x)
    t1, j1 = _pair(x, fill=1.0)
    for f_t, f_j in [
        (lambda: st.kron(x, x), lambda: jsp.kron(x, x)),
        (lambda: st.kron(t1, t), lambda: jsp.kron(j1, j)),
        (lambda: st.triu(t1), lambda: jsp.triu(j1)),
        (lambda: st.nonzero(t1), lambda: jsp.nonzero(j1)),
        (lambda: st.roll(t, (1, 2, 3), axis=(0, 1)), lambda: jsp.roll(j, (1, 2, 3), axis=(0, 1))),
        (lambda: st.roll(t, [[1]], axis=0), lambda: jsp.roll(j, [[1]], axis=0)),
        (lambda: st.repeat(x, 2), lambda: jsp.repeat(x, 2)),
        (lambda: st.repeat(t, [1, 2]), lambda: jsp.repeat(j, [1, 2])),
        (lambda: st.pad(x, 1), lambda: jsp.pad(x, 1)),
        (lambda: st.pad(t, 1, foo=1), lambda: jsp.pad(j, 1, foo=1)),
        (lambda: st.unstack(t, axis=3), lambda: jsp.unstack(j, axis=3)),
        (lambda: st.diff(x), lambda: jsp.diff(x)),
    ]:
        with pytest.raises(Exception) as want:
            f_j()
        with pytest.raises(want.type):
            f_t()
    tu8, ju8 = _narrow(x, np.uint8)
    with pytest.raises(ValueError):
        jsp.roll(ju8, -1, axis=0)
    with pytest.raises(ValueError):
        st.roll(tu8, -1, axis=0)


def test_conversions_and_dtype_predicates():
    x = dense(21, (4, 5), np.float32, density=0.5)
    t, j = _pair(x)
    assert_same(st.asCOO(t.asformat("csr")), jsp.asCOO(j.asformat("csr")))
    assert st.asCOO(3.0) == 3.0
    with pytest.raises(ValueError):
        st.asCOO(x)
    with pytest.raises(ValueError):
        st.asCOO(torch.as_tensor(x))
    assert_same(st.asCOO(torch.as_tensor(x), check=False), jsp.asCOO(x, check=False))
    assert_same(st.as_coo(torch.as_tensor(x)), jsp.as_coo(x))
    assert_same(st.as_coo(t.asformat("dok")), jsp.as_coo(j.asformat("dok")))
    m = scipy.sparse.random(5, 6, density=0.3, random_state=0, format="csr")
    assert_same(st.as_coo(m, device=CPU), jsp.as_coo(m))
    entries = [((0, 1), 2.0), ((2, 2), 1.0)]
    assert_same(st.as_coo(entries, shape=(3, 3), device=CPU), jsp.as_coo(entries, shape=(3, 3)))
    assert_same(st.as_coo(x, device=CPU), jsp.as_coo(x))
    assert_same(st.as_coo(np.float32(2.0), device=CPU), jsp.as_coo(np.float32(2.0)))
    for bad in (lambda a: a.as_coo(t, shape=(4, 5)), lambda a: a.as_coo(t, fill_value=1.0), lambda a: a.as_coo(object())):
        with pytest.raises(Exception) as want:
            bad(jsp)
        with pytest.raises(want.type):
            bad(st)
    got = st.asnumpy(t)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jsp.asnumpy(j))
    np.testing.assert_array_equal(st.asnumpy(torch.arange(3), dtype=np.float64), np.arange(3.0))
    for a, b in ((t, np.float64), (t, np.int8), (np.float32, np.float16), (torch.float32, torch.float64), (np.int16, "int32")):
        casting = "same_kind"
        want = jsp.can_cast(j if a is t else numpy_dtype(a) if isinstance(a, torch.dtype) else a, numpy_dtype(b) if isinstance(b, torch.dtype) else b, casting=casting)
        assert st.can_cast(a, b, casting=casting) == want
    assert st.can_cast(torch.zeros(2, dtype=torch.int8), torch.int16)
    for dt, kind in ((np.float32, "real floating"), (torch.float32, "real floating"), (torch.int16, "integral"), (torch.uint8, "signed integer"), (torch.complex64, ("real floating", "complex floating")), (torch.int32, torch.int32), (np.int32, (torch.int64, np.int32))):
        np_dt = numpy_dtype(dt) if isinstance(dt, torch.dtype) else dt
        np_kind = tuple(numpy_dtype(k) if isinstance(k, torch.dtype) else k for k in kind) if isinstance(kind, tuple) else (numpy_dtype(kind) if isinstance(kind, torch.dtype) else kind)
        assert st.isdtype(dt, kind) == jsp.isdtype(np.dtype(np_dt), np_kind)


@pytest.mark.parametrize("fmt", ["coo", "gcxs", "csr", "csc", "dok"])
def test_creation_functions_match_sparse_tpu(fmt):
    for f_t, f_j in [
        (lambda: st.eye(4, device=CPU, format=fmt), lambda: jsp.eye(4, format=fmt)),
        (lambda: st.eye(4, 6, k=2, dtype=np.int16, device=CPU, format=fmt), lambda: jsp.eye(4, 6, k=2, dtype=np.int16, format=fmt)),
        (lambda: st.eye(5, 3, k=-1, device=torch.device("cpu"), format=fmt), lambda: jsp.eye(5, 3, k=-1, format=fmt)),
        (lambda: st.eye(3, k=5, device=CPU, format=fmt), lambda: jsp.eye(3, k=5, format=fmt)),
        (lambda: st.full((3, 4), 2.5, device=CPU, format=fmt), lambda: jsp.full((3, 4), 2.5, format=fmt)),
        (lambda: st.full(4, True, device=CPU, format=fmt), lambda: jsp.full(4, True, format=fmt)),
        (lambda: st.zeros((2, 3), dtype=np.float32, device=CPU, format=fmt), lambda: jsp.zeros((2, 3), dtype=np.float32, format=fmt)),
        (lambda: st.ones((2, 3), dtype=torch.int16, device=CPU, format=fmt), lambda: jsp.ones((2, 3), dtype=np.int16, format=fmt)),
        (lambda: st.empty((3, 3), device=CPU, format=fmt), lambda: jsp.empty((3, 3), format=fmt)),
        (lambda: st.full((3, 4), 1.0, order="F", device=CPU), lambda: jsp.full((3, 4), 1.0, order="F")),
    ]:
        res = _run(f_t, f_j)
        if res is None:
            continue
        got, want = res
        if fmt == "dok":
            assert type(got).__name__ == "DOK" and got.data.keys() == want.data.keys()
            assert_same(got.to_coo(), want.to_coo())
        else:
            assert_same(got, want)
            assert got.device == torch.device("cpu")


@pytest.mark.parametrize("fmt", [None, "coo", "gcxs", "csr", "dok"])
def test_like_functions_and_asarray(fmt):
    x = dense(22, (4, 5), np.float32, density=0.5)
    for src in ("coo", "csr", "csc", "gcxs"):
        t, j = _pair(x)
        t, j = t.asformat(src), j.asformat(src)
        for f_t, f_j in [
            (lambda: st.full_like(t, 2.0, format=fmt), lambda: jsp.full_like(j, 2.0, format=fmt)),
            (lambda: st.zeros_like(t, format=fmt), lambda: jsp.zeros_like(j, format=fmt)),
            (lambda: st.ones_like(t, dtype=np.int16, format=fmt), lambda: jsp.ones_like(j, dtype=np.int16, format=fmt)),
            (lambda: st.empty_like(t, shape=(2, 2), format=fmt), lambda: jsp.empty_like(j, shape=(2, 2), format=fmt)),
            (lambda: st.asarray(t, format=fmt), lambda: jsp.asarray(j, format=fmt)),
            (lambda: st.asarray(t, dtype=np.float64, format=fmt), lambda: jsp.asarray(j, dtype=np.float64, format=fmt)),
        ]:
            res = _run(f_t, f_j)
            if res is None:
                continue
            got, want = res
            if type(want).__name__ == "DOK":
                assert_same(got.to_coo(), want.to_coo())
            else:
                assert_same(got, want)
            assert got.device == torch.device("cpu")
    for f_t, f_j in [
        (lambda: st.zeros_like(torch.as_tensor(x), format=fmt), lambda: jsp.zeros_like(x, format=fmt)),
        (lambda: st.asarray(x, format=fmt, device=CPU), lambda: jsp.asarray(x, format=fmt)),
        (lambda: st.asarray(x, dtype=np.float64, format=fmt, device="cpu"), lambda: jsp.asarray(x, dtype=np.float64, format=fmt)),
        (lambda: st.asarray(torch.as_tensor(x), format=fmt), lambda: jsp.asarray(x, format=fmt)),
        (lambda: st.asarray(x.tolist(), format=fmt, device=CPU), lambda: jsp.asarray(x.tolist(), format=fmt)),
        (lambda: st.asarray(2.5, device=CPU), lambda: jsp.asarray(2.5)),
    ]:
        res = _run(f_t, f_j)
        if res is None:
            continue
        got, want = res
        assert_same(got.to_coo() if type(want).__name__ == "DOK" else got, want.to_coo() if type(want).__name__ == "DOK" else want)
    with pytest.raises(ValueError):
        st.asarray(x, format="bsr", device=CPU)
    with pytest.raises(ValueError):
        st.asarray(x, device=3)
    with pytest.raises(ValueError):
        st.asarray(x, device=object())


RANDOM_CASES = [
    ((20, 30), {"density": 0.1}),
    ((5, 6, 7), {"density": 0.3}),
    ((40,), {"nnz": 7}),
    ((6, 6), {"density": 0.8}),
    ((4, 4), {"density": 1.0}),
    ((3, 5), {"density": 0.0}),
    ((5000, 5000), {"nnz": 200}),
    ((30, 40), {"density": 0.05, "fill_value": 1.5}),
    ((30, 40), {"density": 0.05, "idx_dtype": np.int64}),
    ((), {"density": 1.0}),
]


@pytest.mark.parametrize("seed", [0, 3, 42, 2024])
@pytest.mark.parametrize(
    "fmt,shape,kwargs",
    [
        (fmt, shape, kw)
        for fmt in ("coo", "gcxs", "csr", "dok")
        for shape, kw in RANDOM_CASES
        if (fmt != "csr" or len(shape) == 2) and (fmt != "dok" or shape != ())
    ],
    ids=str,
)
def test_random_is_sparse_tpus_draw(fmt, shape, kwargs, seed):
    got = st.random(shape, random_state=seed, format=fmt, device=CPU, **kwargs)
    want = jsp.random(shape, random_state=seed, format=fmt, **kwargs)
    if fmt == "dok":
        assert type(got).__name__ == "DOK" and got.data.keys() == want.data.keys()
        got, want = got.to_coo(), want.to_coo()
    assert_same(got, want)


def test_random_generators_and_errors():
    g_t, g_j = np.random.default_rng(5), np.random.default_rng(5)
    assert_same(st.random((8, 9), density=0.3, random_state=g_t, device=CPU), jsp.random((8, 9), density=0.3, random_state=g_j))
    rvs = lambda n: np.arange(n, dtype=np.float32)  # noqa: E731
    assert_same(st.random((8, 9), density=0.3, random_state=1, data_rvs=rvs, device=CPU), jsp.random((8, 9), density=0.3, random_state=1, data_rvs=rvs))
    from sparse_tpu_torch.testing import random_value_array

    vals = random_value_array(np.nan, 0.5)(10)
    assert np.isnan(vals[:5]).all() and not np.isnan(vals[5:]).any()
    for bad in (dict(density=0.1, nnz=3), dict(density=1.5), dict(nnz=100), dict(random_state="x")):
        with pytest.raises(ValueError):
            st.random((4, 4), device=CPU, **bad)


def test_testing_helpers():
    from sparse_tpu_torch.testing import assert_eq, assert_nnz, is_canonical

    x = dense(23, (4, 5), np.float64, density=0.5)
    t = st.COO.from_numpy(x, device=CPU)
    assert is_canonical(t) and is_canonical(t.asformat("csr"))
    assert_eq(t, x)
    assert_eq(t, t.asformat("csc"))
    assert_eq(torch.as_tensor(x), t)
    assert_nnz(t, x)
    bad = st.COO._make(t.coords.flip(1), t.data.flip(0), t.shape, t.fill_value)
    assert not is_canonical(bad)
    with pytest.raises(AssertionError):
        assert_eq(t, x + 1)
    with pytest.raises(AssertionError):
        assert_eq(t, x.astype(np.float32))


def test_coo_and_array_methods():
    x = dense(24, (4, 5), np.float64, density=0.5)
    t, j = _pair(x)
    # resize: in place, C-order truncation
    for shape in ((2, 3), (5, 6), (20,)):
        a, b = t.copy(), j.copy()
        a.resize(shape)
        b.resize(shape)
        assert_same(a, b)
    a = t.copy()
    a.resize(3, 2)
    assert a.shape == (3, 2)
    assert torch.equal(t.maybe_densify(), t.todense())
    big = st.random((100, 100), density=0.01, random_state=0, device=CPU)
    with pytest.raises(ValueError):
        big.maybe_densify()
    assert big.maybe_densify(max_size=10**5).shape == (100, 100)
    d = t.todok()
    assert type(d).__name__ == "DOK" and d.nnz == t.nnz and d.device == t.device
    assert_same(t.asformat("csr").todok().to_coo(), j.asformat("csr").todok().to_coo())
    m = t.to_scipy_sparse()
    assert isinstance(m, scipy.sparse.coo_array)
    np.testing.assert_array_equal(m.toarray(), x)
    with pytest.raises(ValueError):
        _pair(x, fill=1.0)[0].to_scipy_sparse()
    np.testing.assert_array_equal(t.dot(np.ones(5)).numpy(), np.asarray(j.dot(np.ones(5))))
    for g, w in zip(t.nonzero(), j.nonzero()):
        np.testing.assert_array_equal(g.numpy(), w)
    assert t.__array_namespace__() is st and t.asformat("csr").__array_namespace__() is st
    with pytest.raises(ValueError):
        t.__array_namespace__(api_version="2020.01")
    assert t.device == torch.device("cpu") and t.to_device("cpu") is t and t.to_device(torch.device("cpu")) is t
    assert st.COO.__array_priority__ == jsp.COO.__array_priority__
    assert (np.ones(5) * t[0]).__class__ is st.COO


@pytest.mark.parametrize("block_rows", [128, 8])
def test_to_block_ell_is_sparse_tpus_layout(block_rows):
    x = dense(25, (40, 30), np.float32, density=0.3, kind="ulps")
    t, j = _pair(x)
    got, want = t.to_block_ell(block_rows=block_rows), j.to_block_ell(block_rows=block_rows)
    for name in ("e_rows", "e_cols", "e_data"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    assert (got.n_rows, got.n_cols, got.block_rows) == (want.n_rows, want.n_cols, want.block_rows)
    assert t.to_block_ell(block_rows=block_rows) is got  # cached
    out = st.kernels.ell_spmm(got.e_rows, got.e_cols, got.e_data, torch.ones(30, 2), n_rows=40, block_rows=block_rows)
    np.testing.assert_allclose(out.numpy(), x @ np.ones((30, 2), dtype=np.float32), rtol=1e-5)
    with pytest.raises(ValueError):
        _pair(x, fill=1.0)[0].to_block_ell()
