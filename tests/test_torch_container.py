"""The rest of the container against sparse_tpu's (CPU): ``COO.from_iter``
and ``GCXS.from_iter``; narrow coordinate dtypes (int8, int16, uint8,
uint16), kept as sparse_tpu keeps them and taken by every product;
``concatenate``/``concat``/``stack`` of COO and GCXS arrays; ``diagonal``
and ``diagonalize``.

Same inputs, drawn with numpy from a seed, through both packages. Held
exactly: classes, shapes, ``compressed_axes``, coordinates (``indices``,
``indptr``) by value and by dtype, data bit for bit and fill values.
Products with narrow coordinates against the same products with int64
ones, at rtol 1e-12 (float64).
"""

import numpy as np
import pytest
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype
from sparse_tpu_torch.core import gcxs as tg

CPU = "cpu"
NARROW = [np.int8, np.int16, np.uint8, np.uint16]


def _dense(shape, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return np.where(rng.random(shape) < density, x, 0.0).astype(dtype)


def _np(t):
    return t.cpu().numpy()


def _same(t, j):
    """``t`` (port) and ``j`` (sparse_tpu) hold the same array, exactly."""
    assert type(t).__name__ == type(j).__name__ and t.shape == j.shape
    if isinstance(j, jsp.COO):
        np.testing.assert_array_equal(_np(t.coords), np.asarray(j.coords))
        assert numpy_dtype(t.coords.dtype) == np.asarray(j.coords).dtype
    else:
        assert t.compressed_axes == j.compressed_axes
        for name in ("indices", "indptr"):
            np.testing.assert_array_equal(_np(getattr(t, name)), np.asarray(getattr(j, name)))
            assert numpy_dtype(getattr(t, name).dtype) == np.asarray(getattr(j, name)).dtype, name
    want = np.asarray(j.data)
    assert numpy_dtype(t.data.dtype) == want.dtype
    assert _np(t.data).tobytes() == want.tobytes()
    assert np.asarray(t.fill_value).tobytes() == np.asarray(j.fill_value).tobytes()


# ---------------------------------------------------------------------------
# from_iter
# ---------------------------------------------------------------------------

ITERABLES = [
    ([((0, 1), 2.0), ((2, 0), 3.0), ((1, 1), -1.0)], (3, 2), None),
    ({(0, 1): 2.0, (2, 0): 3.0}, (3, 2), None),
    ([((4,), 1), ((0,), 5)], (6,), None),
    ([((0, 1, 2), 1.5), ((0, 1, 2), 2.5)], (2, 3, 4), None),  # a duplicate sums
    ([((1, 0), 2), ((0, 1), 3)], (2, 2), np.int32),
    ([], (3, 4), None),
    ([], (3, 4), np.int16),
]


@pytest.mark.parametrize("x,shape,dtype", ITERABLES)
def test_coo_from_iter(x, shape, dtype):
    _same(st.COO.from_iter(x, shape=shape, dtype=dtype, device=CPU), jsp.COO.from_iter(x, shape=shape, dtype=dtype))


@pytest.mark.parametrize("x,shape,dtype", [c for c in ITERABLES if len(c[1]) >= 2])
@pytest.mark.parametrize("compressed_axes", [None, (0,)])
def test_gcxs_from_iter(x, shape, dtype, compressed_axes):
    got = st.GCXS.from_iter(x, shape=shape, dtype=dtype, compressed_axes=compressed_axes, device=CPU)
    _same(got, jsp.GCXS.from_iter(x, shape=shape, dtype=dtype, compressed_axes=compressed_axes))


def test_from_iter_fill_value_and_errors():
    x = [((0, 0), 2.0), ((1, 1), 3.0)]
    _same(st.COO.from_iter(x, shape=(2, 2), fill_value=1.0, device=CPU), jsp.COO.from_iter(x, shape=(2, 2), fill_value=1.0))
    for bad in ([(0, 1, 2.0)], [1.0, 2.0], [((0, 0), 1.0), "ab"]):
        with pytest.raises(ValueError, match="Invalid iterable"):
            jsp.COO.from_iter(bad, shape=(2, 2))
        with pytest.raises(ValueError, match="Invalid iterable"):
            st.COO.from_iter(bad, shape=(2, 2), device=CPU)
        with pytest.raises(ValueError, match="Invalid iterable"):
            st.GCXS.from_iter(bad, shape=(2, 2), device=CPU)


# ---------------------------------------------------------------------------
# narrow coordinate dtypes
# ---------------------------------------------------------------------------


def _narrow_pair(x, dt):
    idx = np.stack(np.nonzero(x)).astype(dt)
    data = x[np.nonzero(x)]
    return st.COO(idx, data, shape=x.shape, device=CPU), jsp.COO(idx, data, shape=x.shape)


@pytest.mark.parametrize(
    "dt,shape",
    [(dt, shape) for dt in NARROW for shape in [(20, 30), (3, 300), (4, 5, 6)] if max(shape) <= np.iinfo(dt).max + 1],
    ids=str,
)
def test_narrow_coordinates_are_kept(dt, shape):
    x = _dense(shape, 0.3, 1)
    t, j = _narrow_pair(x, dt)
    _same(t, j)
    _same(t.T, j.T)
    _same(t.reshape((-1,)), j.reshape((-1,)))
    if len(shape) == 2:
        _same(t.reshape((shape[1], shape[0])), j.reshape((shape[1], shape[0])))
    for ca in [None, (0,), (len(shape) - 1,)]:
        tg_, jg = st.GCXS.from_coo(t, compressed_axes=ca), jsp.GCXS.from_coo(j, compressed_axes=ca)
        _same(tg_, jg)
        _same(tg_.tocoo(), jg.tocoo())
    # unsorted narrow input with duplicates is canonicalized as in sparse_tpu
    idx = np.stack(np.nonzero(x)).astype(dt)[:, ::-1]
    idx = np.concatenate([idx, idx[:, :3]], axis=1)
    data = np.arange(idx.shape[1], dtype=np.float64)
    _same(st.COO(idx, data, shape=shape, device=CPU), jsp.COO(idx, data, shape=shape))


@pytest.mark.parametrize("dt", NARROW, ids=lambda d: np.dtype(d).name)
def test_products_take_narrow_coordinates(dt):
    """K1/K2 (their plain versions here), K4, the gather + ``index_add_``
    path and the MTTKRP with narrow coordinates, against int64 ones."""
    x = _dense((40, 30), 0.3, 2)
    t, _ = _narrow_pair(x, dt)
    w = st.COO.from_numpy(x, device=CPU)
    assert numpy_dtype(t.coords.dtype) == np.dtype(dt) and w.coords.dtype == torch.int32
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((30, 5)))
    v = torch.as_tensor(np.random.default_rng(4).standard_normal(30))
    for got, want in (
        (t @ b, w @ b),
        (t @ v, w @ v),
        (b.T @ t.T, b.T @ w.T),
        (t.astype(np.float16) @ b.to(torch.float16), w.astype(np.float16) @ b.to(torch.float16)),  # index_add_
        (st.sddmm(t, torch.ones(40, 2, dtype=torch.float64), torch.ones(2, 30, dtype=torch.float64)).data, x[np.nonzero(x)] * 2),
        (st.matvec_add(t, v, torch.ones(40, dtype=torch.float64)), w @ v + 1),
        (st.jitops.spmm(t, b), w @ b),
        (t @ w.T, w @ w.T),
    ):
        got = got.todense() if isinstance(got, st.SparseArray) else got
        want = want.todense() if isinstance(want, st.SparseArray) else torch.as_tensor(want)
        np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64), rtol=1e-3 if got.dtype == torch.float16 else 1e-12)
    t3 = _dense((6, 7, 8), 0.3, 5)
    idx = np.stack(np.nonzero(t3)).astype(dt)
    c = torch.as_tensor(np.random.default_rng(6).standard_normal((7, 3)))
    d = torch.as_tensor(np.random.default_rng(7).standard_normal((8, 3)))
    got = st.jitops.mttkrp(st.COO(idx, t3[np.nonzero(t3)], shape=t3.shape, device=CPU), c, d)
    np.testing.assert_allclose(_np(got), np.einsum("ijk,jr,kr->ir", t3, c.numpy(), d.numpy()), rtol=1e-12)


def test_narrow_coordinates_in_elementwise_and_reductions():
    x, y = _dense((20, 30), 0.3, 8), _dense((20, 30), 0.3, 9)
    (ta, ja), (tb, jb) = _narrow_pair(x, np.uint8), _narrow_pair(y, np.int16)
    for got, want in (
        (ta + tb, x + y),
        (ta * 2.0, x * 2.0),
        (ta * torch.as_tensor(y), x * y),
        (ta.sum(axis=0), x.sum(0)),
        (ta.max(axis=1), x.max(1)),
    ):
        got = got.todense() if isinstance(got, st.SparseArray) else got
        np.testing.assert_allclose(_np(got), want, rtol=1e-12)


# ---------------------------------------------------------------------------
# concatenate / stack
# ---------------------------------------------------------------------------


def _arrays(shapes, fmt, seed=10, dtypes=None, ca=None):
    xs = [_dense(s, 0.4, seed + i, (dtypes or [np.float64] * len(shapes))[i]) for i, s in enumerate(shapes)]
    ts = [st.COO.from_numpy(x, device=CPU) for x in xs]
    js = [jsp.COO.from_numpy(x) for x in xs]
    if fmt == "gcxs":
        ts = [st.GCXS.from_coo(t, compressed_axes=ca) for t in ts]
        js = [jsp.GCXS.from_coo(j, compressed_axes=ca) for j in js]
    return ts, js


CONCATS = [
    ([(3, 4), (5, 4)], 0),
    ([(3, 4), (3, 2), (3, 1)], 1),
    ([(3, 4), (3, 4)], -1),
    ([(2, 3, 4), (2, 1, 4)], 1),
    ([(2, 3, 4), (2, 3, 5)], 2),
    ([(3, 4), (2, 5)], None),
    ([(4,), (3,)], 0),
]


@pytest.mark.parametrize("shapes,axis", CONCATS)
@pytest.mark.parametrize("fmt,ca", [("coo", None), ("gcxs", None), ("gcxs", (0,))])
def test_concatenate(shapes, axis, fmt, ca):
    if ca is not None and len(shapes[0]) < 2:
        ca = None
    ts, js = _arrays(shapes, fmt, ca=ca)
    _same(st.concatenate(ts, axis=axis), jsp.concatenate(js, axis=axis))
    _same(st.concat(ts, axis=axis), jsp.concat(js, axis=axis))


@pytest.mark.parametrize("shape,axis", [((3, 4), 0), ((3, 4), 1), ((3, 4), 2), ((3, 4), -1), ((2, 3, 4), 1), ((5,), 0), ((5,), 1)])
@pytest.mark.parametrize("fmt,ca", [("coo", None), ("gcxs", None), ("gcxs", (0,))])
def test_stack(shape, axis, fmt, ca):
    if ca is not None and len(shape) < 2:
        ca = None
    ts, js = _arrays([shape] * 3, fmt, ca=ca)
    _same(st.stack(ts, axis=axis), jsp.stack(js, axis=axis))


def test_concatenate_and_stack_promote_and_keep_index_dtypes():
    ts, js = _arrays([(3, 4), (2, 4)], "coo", dtypes=[np.float64, np.float32])
    _same(st.concatenate(ts), jsp.concatenate(js))
    # a promoted dtype that the first fill value does not have raises in both
    ts, js = _arrays([(3, 4), (2, 4)], "coo", dtypes=[np.float32, np.int64])
    with pytest.raises(ValueError, match="fill_value dtype"):
        jsp.concatenate(js)
    with pytest.raises(ValueError, match="fill_value dtype"):
        st.concatenate(ts)
    x = _dense((30, 40), 0.3, 20)
    for dt in (np.uint8, np.int16):
        t, j = _narrow_pair(x, dt)
        _same(st.concatenate([t, t], axis=1), jsp.concatenate([j, j], axis=1))  # 80 columns
        _same(st.concatenate([t] * 9, axis=1), jsp.concatenate([j] * 9, axis=1))  # 360: uint8 widens
        _same(st.stack([t, t]), jsp.stack([j, j]))
        tg_, jg = st.GCXS.from_coo(t), jsp.GCXS.from_coo(j)
        _same(st.concatenate([tg_] * 9, axis=1), jsp.concatenate([jg] * 9, axis=1))
        _same(st.stack([tg_] * 3, axis=2), jsp.stack([jg] * 3, axis=2))
    # the GCXS splices themselves
    g = [st.GCXS.from_numpy(_dense((3, 4, 5), 0.4, s), compressed_axes=(2,), device=CPU) for s in (1, 2)]
    h = [jsp.GCXS.from_numpy(_dense((3, 4, 5), 0.4, s), compressed_axes=(2,)) for s in (1, 2)]
    _same(tg.concatenate_gcxs(g, axis=1), jsp.core.gcxs.concatenate_gcxs(h, axis=1))
    _same(tg.stack_gcxs(g, axis=3), jsp.core.gcxs.stack_gcxs(h, axis=3))


def test_concatenate_and_stack_errors():
    ts, _ = _arrays([(3, 4), (3, 5)], "coo")
    for call in (
        lambda: st.concatenate(ts, axis=0),
        lambda: st.concatenate([ts[0], ts[0].reshape((12,))]),
        lambda: st.stack(ts),
        lambda: st.concatenate([]),
        lambda: st.concatenate([ts[0], st.COO.from_numpy(np.ones((3, 4)), fill_value=1.0, device=CPU)]),
        lambda: st.concatenate([ts[0], np.ones((3, 4))]),
    ):
        with pytest.raises(ValueError):
            call()
    g = [st.GCXS.from_coo(t) for t in ts]
    with pytest.raises(ValueError):
        st.concatenate(g, axis=0)
    with pytest.raises(ValueError):
        st.stack(g)


# ---------------------------------------------------------------------------
# diagonal / diagonalize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,offset,axis1,axis2",
    [((5, 5), 0, 0, 1), ((5, 5), 2, 0, 1), ((5, 5), -1, 0, 1), ((5, 5), 0, 1, 0), ((3, 4, 3), 0, 0, 2), ((4, 3, 4), 1, 0, 2), ((2, 4, 4), 0, 1, 2)],
)
@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_diagonal(shape, offset, axis1, axis2, fmt):
    ts, js = _arrays([shape], fmt, seed=30)
    _same(st.diagonal(ts[0], offset=offset, axis1=axis1, axis2=axis2), jsp.diagonal(js[0], offset=offset, axis1=axis1, axis2=axis2))


def test_diagonal_of_narrow_coordinates_and_errors():
    t, j = _narrow_pair(_dense((6, 6), 0.5, 31), np.uint8)
    _same(st.diagonal(t), jsp.diagonal(j))
    with pytest.raises(ValueError):
        st.diagonal(st.COO.from_numpy(np.ones((3, 4)), device=CPU))
    with pytest.raises(ValueError):
        st.diagonal(np.eye(3))


@pytest.mark.parametrize("shape,axis", [((4,), 0), ((3, 4), 0), ((3, 4), 1), ((2, 3, 4), 2)])
@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_diagonalize(shape, axis, fmt):
    ts, js = _arrays([shape], fmt, seed=40)
    _same(st.diagonalize(ts[0], axis=axis), jsp.diagonalize(js[0], axis=axis))
    x = _dense(shape, 0.4, 41)
    _same(st.diagonalize(torch.as_tensor(x), axis=axis), jsp.diagonalize(x, axis=axis))
