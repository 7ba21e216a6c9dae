"""The port's structural ops and namespace against sparse_tpu's (CPU, small
sizes): ``transpose``/``swapaxes``/``T``/``mT``, ``reshape`` (the 2-D digit
arithmetic and the general unravel), ``squeeze``, ``flatten``,
``broadcast_to``, ``expand_dims``, ``moveaxis``, ``matrix_transpose``, the
Array-API forms, ``broadcast_arrays``, ``result_type``, the NumPy protocols
and the namespace. Coordinates, index dtypes, data (bit for bit) and fill
values are held exactly.
"""

import numpy as np
import pytest
import torch
from test_torch_elemwise import assert_same, check, dense, np_of

import sparse_tpu as jsp
import sparse_tpu_torch as st

CPU = "cpu"


def both(x, fill=None):
    fill = None if fill is None else np.asarray(fill, dtype=x.dtype)[()]
    return st.COO.from_numpy(x, fill_value=fill, device=CPU), jsp.COO.from_numpy(x, fill_value=fill)


TRANSPOSES = [
    ((5, 6), None),
    ((5, 6), (1, 0)),
    ((5, 6), (0, 1)),
    ((3, 4, 5), None),
    ((3, 4, 5), (1, 0, 2)),
    ((3, 4, 5), (2, 0, 1)),
    ((3, 4, 5), (0, 2, 1)),
    ((2, 3, 2, 3), (3, 1, 0, 2)),
    ((2, 3, 2, 3), (-1, 0, 1, 2)),
]


@pytest.mark.parametrize("shape,axes", TRANSPOSES, ids=str)
@pytest.mark.parametrize("fill", [None, 1.5], ids=["zero", "nonzero"])
def test_transpose_matches_sparse_tpu(shape, axes, fill):
    x = dense(1, shape, fill=fill)
    t, j = both(x, fill)
    check(lambda: t.transpose(axes), lambda: j.transpose(axes))
    check(lambda: t.T, lambda: j.T)
    check(lambda: st.permute_dims(t, axes), lambda: jsp.permute_dims(j, axes))
    check(lambda: np.transpose(t, axes), lambda: np.transpose(j, axes))
    if len(shape) >= 2:
        check(lambda: t.mT, lambda: j.mT)
        check(lambda: st.matrix_transpose(t), lambda: jsp.matrix_transpose(j))
        check(lambda: t.swapaxes(0, -1), lambda: j.swapaxes(0, -1))
        check(lambda: st.swapaxes(t, 0, 1), lambda: jsp.swapaxes(j, 0, 1))
        check(lambda: st.moveaxis(t, 0, -1), lambda: jsp.moveaxis(j, 0, -1))
    np.testing.assert_array_equal(np_of(t.transpose(axes).todense()), np.transpose(x, axes))


def test_transpose_errors_and_cache():
    x = dense(2, (3, 4, 5))
    t, j = both(x)
    for bad in ((0, 0, 1), (0, 1)):
        with pytest.raises(ValueError):
            t.transpose(bad)
        with pytest.raises(ValueError):
            j.transpose(bad)
    with pytest.raises(ValueError):
        st.COO.from_numpy(np.ones(3), device=CPU).mT
    assert t.transpose() is not t.transpose()  # no cache: computed anew
    t.enable_caching()
    assert t.transpose((1, 0, 2)) is t.transpose((1, 0, 2))
    assert t.reshape((12, 5)) is t.reshape((12, 5))


RESHAPES = [
    ((6, 10), (3, 20)),  # column count multiplied: digit arithmetic
    ((6, 10), (12, 5)),  # column count divided: digit arithmetic
    ((6, 10), (4, 15)),  # neither: the general unravel
    ((6, 10), (60,)),
    ((60,), (6, 10)),
    ((3, 4, 5), (12, 5)),
    ((3, 4, 5), (2, -1, 3)),
    ((3, 4, 5), (5, 4, 3)),
    ((2, 3, 2, 3), (6, 6)),
    ((1, 5, 1, 4), (5, 4)),
]


@pytest.mark.parametrize("a,b", RESHAPES, ids=str)
@pytest.mark.parametrize("fill", [None, -2.0], ids=["zero", "nonzero"])
def test_reshape_matches_sparse_tpu(a, b, fill):
    x = dense(3, a, fill=fill)
    t, j = both(x, fill)
    check(lambda: t.reshape(b), lambda: j.reshape(b))
    check(lambda: st.reshape(t, b), lambda: jsp.reshape(j, b))
    check(lambda: t.flatten(), lambda: j.flatten())
    np.testing.assert_array_equal(np_of(t.reshape(b).todense()), x.reshape(b))
    with pytest.raises(ValueError):
        t.reshape((7, 9))
    with pytest.raises(NotImplementedError):
        t.reshape(b, order="F")


def test_reshape_of_an_elemwise_result_keeps_sparse_tpus_index_dtypes():
    x, y = dense(4, (6, 10)), dense(5, (6, 10))
    (t1, j1), (t2, j2) = both(x), both(y)
    t, j = t1 + t2, j1 + j2  # int64 coordinates in both
    for shape in ((3, 20), (12, 5), (4, 15), (60,)):
        check(lambda: t.reshape(shape), lambda: j.reshape(shape))
    check(lambda: t.T, lambda: j.T)


@pytest.mark.parametrize("shape,axis", [((1, 5, 1), None), ((1, 5, 1), 0), ((1, 5, 1), (0, 2)), ((1, 5, 1), -1), ((5,), None)])
def test_squeeze_matches_sparse_tpu(shape, axis):
    x = dense(6, shape)
    t, j = both(x)
    check(lambda: t.squeeze(axis), lambda: j.squeeze(axis))
    check(lambda: st.squeeze(t, axis=axis), lambda: jsp.squeeze(j, axis=axis))
    with pytest.raises(ValueError):
        t.squeeze(1)
    with pytest.raises(ValueError):
        j.squeeze(1)


BROADCASTS = [((4,), (3, 4)), ((4, 1), (4, 5)), ((3, 1, 4), (3, 5, 4)), ((1, 5), (2, 4, 5)), ((2, 1, 1), (2, 3, 4)), ((5,), (5,))]


@pytest.mark.parametrize("a,b", BROADCASTS, ids=str)
@pytest.mark.parametrize("fill", [None, 3.0], ids=["zero", "nonzero"])
def test_broadcast_to_matches_sparse_tpu(a, b, fill):
    x = dense(7, a, fill=fill)
    t, j = both(x, fill)
    check(lambda: st.broadcast_to(t, b), lambda: jsp.broadcast_to(j, b))
    check(lambda: t.broadcast_to(b), lambda: j.broadcast_to(b))
    np.testing.assert_array_equal(np_of(st.broadcast_to(t, b).todense()), np.broadcast_to(x, b))
    with pytest.raises(ValueError):
        st.broadcast_to(t, (7, 9, 11))


def test_broadcast_arrays_and_dense_operands():
    x, y = dense(8, (4, 1)), dense(9, (1, 5))
    (t1, j1), (t2, j2) = both(x), both(y)
    got = st.broadcast_arrays(t1, t2, np.ones(5), torch.ones(4, 1))
    want = jsp.broadcast_arrays(j1, j2, np.ones(5), np.ones((4, 1)))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(np_of(got[3]), want[3])
    assert isinstance(st.broadcast_to(torch.ones(3), (2, 3)), torch.Tensor)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_expand_dims_matches_sparse_tpu(axis):
    x = dense(10, (4, 5))
    t, j = both(x)
    check(lambda: st.expand_dims(t, axis=axis), lambda: jsp.expand_dims(j, axis=axis))
    t0, j0 = both(np.array(2.5))
    check(lambda: st.expand_dims(t0, axis=0), lambda: jsp.expand_dims(j0, axis=0))


def test_result_type_and_broadcast_shapes():
    t, j = both(dense(11, (3, 4), np.float32))
    ti, ji = both(dense(12, (3, 4), np.int16))
    assert st.result_type(t, ti) == jsp.result_type(j, ji) == np.float32
    assert st.result_type(t, np.float64, torch.zeros(1, dtype=torch.int64)) == np.float64
    assert st.result_type(ti, torch.int32) == jsp.result_type(ji, np.int32)
    assert st.broadcast_shapes((3, 1), (1, 4)) == jsp.broadcast_shapes((3, 1), (1, 4)) == (3, 4)


def test_namespace_reexports_numpys_ufuncs():
    names = [
        "add", "subtract", "multiply", "divide", "floor_divide", "remainder", "negative", "positive", "sign",
        "sqrt", "square", "exp", "log", "sin", "cos", "tanh", "greater", "less_equal", "not_equal", "maximum",
        "minimum", "logical_and", "logical_not", "bitwise_and", "bitwise_not", "copysign", "nextafter", "hypot",
        "logaddexp", "reciprocal", "signbit", "trunc", "ceil", "floor", "conj", "nan", "inf", "pi", "e",
        "float32", "int64", "uint8", "finfo", "iinfo", "newaxis",
    ]
    for name in names:
        assert getattr(st, name) is getattr(jsp, name), name
    for name, np_name in (("acos", "arccos"), ("atan2", "arctan2"), ("pow", "power"), ("bitwise_invert", "invert"), ("bitwise_left_shift", "left_shift"), ("bool", "bool_")):
        assert getattr(st, name) is getattr(np, np_name)
    for name in ("elemwise", "broadcast_to", "where", "nansum", "nanmax", "result_type", "expand_dims", "moveaxis", "sum", "var", "std", "clip", "isposinf"):
        assert callable(getattr(st, name))
    assert set(st.__all__) <= set(dir(st))


def test_all_names_only_what_sparse_tpu_names():
    assert st.__all__ == jsp.__all__ and len(st.__all__) == 171
    for name in ("CSC", "CSR", "jitops", "kernels", "matvec_add", "nn", "sddmm", "swapaxes", "transpose"):
        assert hasattr(st, name) and name not in st.__all__, name
    for name in ("einsum", "concat", "concatenate", "stack", "diagonal", "diagonalize"):
        assert name in st.__all__ and name in jsp.__all__, name


def test_array_function_dispatch():
    x = dense(13, (4, 5))
    t, j = both(x)
    assert np.shape(t) == (4, 5) and np.ndim(t) == 2 and np.size(t) == 20
    check(lambda: np.sum(t, axis=0), lambda: np.sum(j, axis=0), rtol=1e-12)
    check(lambda: np.where(t > 0, t, -1.0), lambda: np.where(j > 0, j, -1.0))
    check(lambda: np.round(t, 1), lambda: np.round(j, 1), ulps=4)
    check(lambda: np.clip(t, -1, 1), lambda: np.clip(j, -1, 1))
    check(lambda: np.real(t), lambda: np.real(j))
    check(lambda: np.squeeze(t), lambda: np.squeeze(j))
    check(lambda: np.concatenate([t, t]), lambda: np.concatenate([j, j]))
    check(lambda: np.kron(t, t), lambda: np.kron(j, j))


def test_scalar_conversions_and_0d_results():
    t, j = both(dense(14, (3, 4)))
    s_t, s_j = t.sum(), j.sum()
    assert s_t.shape == () and float(s_t) == pytest.approx(float(s_j), rel=1e-12)
    assert bool(t.max() > 0) == bool(j.max() > 0)
    with pytest.raises(ValueError):
        float(t)
    check(lambda: t.mean(keepdims=True), lambda: j.mean(keepdims=True), rtol=1e-12)


def test_where_with_one_argument_and_errors():
    x = dense(15, (4, 5))
    t, j = both(x)
    got, want = st.where(t), jsp.where(j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), w)
    with pytest.raises(ValueError):
        st.where(t, t)
    t1, _ = both(x, fill=1.0)
    with pytest.raises(ValueError, match="zero fill"):
        st.where(t1)
