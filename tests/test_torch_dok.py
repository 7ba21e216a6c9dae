"""The port's DOK against sparse_tpu's (CPU): one case for each test of
tests/test_dok.py, plus the device a DOK keeps, its tensors and reductions.
DOK is a dict on the host in both packages; its COO is built on the DOK's
device and held exactly against sparse_tpu's (coordinates, dtypes, data bit
for bit, fill value)."""

import numpy as np
import pytest
import torch
from test_torch_elemwise import assert_same

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch.testing import assert_eq

CPU = "cpu"


def _both(*args, **kwargs):
    return st.DOK(*args, device=CPU, **kwargs), jsp.DOK(*args, **kwargs)


def _same(d_t, d_j):
    assert type(d_t).__name__ == "DOK" and d_t.shape == d_j.shape and d_t.nnz == d_j.nnz
    assert d_t.data.keys() == d_j.data.keys()
    assert_same(d_t.to_coo(), d_j.to_coo())


def test_construct_and_get():
    t, j = _both((3, 4))
    t[1, 2] = j[1, 2] = 5.0
    assert t[1, 2] == j[1, 2] == 5.0 and t[0, 0] == j[0, 0] == 0.0
    assert type(t[0, 0]) is type(j[0, 0])
    assert t.nnz == 1
    _same(t, j)


def test_negative_index():
    t, j = _both((3, 4))
    t[-1, -1] = j[-1, -1] = 2.0
    assert t[2, 3] == 2.0
    _same(t, j)


def test_out_of_bounds():
    t, _ = _both((3, 4))
    with pytest.raises(IndexError):
        t[5, 0] = 1.0
    with pytest.raises(IndexError):
        _ = t[5, 0]
    with pytest.raises(IndexError):
        _ = t[1]


@pytest.mark.parametrize(
    "key,value",
    [((1, slice(1, 4)), 3.0), (2, 1.0), ((slice(None), 0), 4.0), ((slice(None, None, -2), slice(1, 3)), 2.0), ((Ellipsis, 1), 6.0), (([0, 2], slice(None)), 7.0)],
    ids=repr,
)
def test_set_slice(key, value):
    t, j = _both((4, 5))
    t[key] = j[key] = value
    x = np.zeros((4, 5))
    x[key] = value
    _same(t, j)
    assert_eq(t.to_coo(), x)


def test_set_array_values():
    t, j = _both((3, 4))
    vals = np.arange(4, dtype=np.float64)
    t[0, :] = vals
    j[0, :] = vals
    t[1, :] = torch.arange(4, dtype=torch.float64)  # a tensor value: copied to the host
    j[1, :] = vals
    t[2, 1:3] = [5.0, 6.0]
    j[2, 1:3] = [5.0, 6.0]
    _same(t, j)
    for bad in ([[5.0, 6.0]], [1.0, 2.0, 3.0]):
        with pytest.raises(ValueError):
            j[2, 1:3] = bad
        with pytest.raises(ValueError):
            t[2, 1:3] = bad


def test_set_fill_removes():
    t, j = _both((3, 3))
    t[1, 1] = j[1, 1] = 5.0
    assert t.nnz == 1
    t[1, 1] = j[1, 1] = 0.0
    assert t.nnz == j.nnz == 0
    t[0, :] = j[0, :] = np.array([1.0, 0.0, 2.0])
    t[0, 2] = j[0, 2] = -0.0  # bitwise: -0.0 is no fill value
    _same(t, j)


def test_fancy_set_get():
    t, j = _both((5, 5))
    rows, cols = np.array([0, 2, 4]), np.array([1, 3, 0])
    t[rows, cols] = j[rows, cols] = 7.0
    t[[1, 3], [2, 2]] = j[[1, 3], [2, 2]] = np.array([8.0, 9.0])
    _same(t, j)
    assert_same(t[rows, cols], j[rows, cols])
    for bad in (lambda d: d.__setitem__(([0, 1], [0]), 1.0), lambda d: d.__setitem__(([0.5], [1]), 1.0), lambda d: d.__setitem__(([0, 1],), 1.0), lambda d: d.__setitem__(([0, 1], [1, 2]), [1.0, 2.0, 3.0]), lambda d: d[[0, 1], [0]], lambda d: d[[0.5], [1]]):
        with pytest.raises(Exception) as want:
            bad(j)
        with pytest.raises(want.type):
            bad(t)


def test_from_to_coo():
    s_t = st.random((5, 6), density=0.3, random_state=0, device=CPU)
    s_j = jsp.random((5, 6), density=0.3, random_state=0)
    d_t, d_j = st.DOK.from_coo(s_t), jsp.DOK.from_coo(s_j)
    assert d_t.nnz == s_t.nnz and d_t.device == s_t.device
    _same(d_t, d_j)
    assert_same(d_t.to_coo(), s_j)
    assert torch.equal(d_t.todense(), s_t.todense())
    assert_same(s_t.asformat("dok").to_coo(), s_j)


def test_from_numpy():
    x = np.random.default_rng(0).random((4, 5))
    x[x < 0.5] = 0
    _same(st.DOK.from_numpy(x, device=CPU), jsp.DOK.from_numpy(x))
    _same(st.DOK.from_numpy(x, fill_value=0.75, device=CPU), jsp.DOK.from_numpy(x, fill_value=0.75))


def test_ctor_conversions():
    s_t = st.random((4, 4), density=0.3, random_state=0, device=CPU)
    s_j = jsp.random((4, 4), density=0.3, random_state=0)
    _same(st.DOK(s_t), jsp.DOK(s_j))
    _same(st.DOK(s_t.asformat("csr")), jsp.DOK(s_j.asformat("csr")))
    x = s_j.todense()
    _same(st.DOK(x, device=CPU), jsp.DOK(x))
    _same(st.DOK(st.DOK(s_t)), jsp.DOK(jsp.DOK(s_j)))
    m = s_j.to_scipy_sparse()
    _same(st.DOK(m, device=CPU), jsp.DOK(m))


def test_dict_init():
    t, j = _both((2, 3), data={(0, 1): 4.0, (1, 2): 5.0})
    _same(t, j)
    t, j = _both((2, 3), data={(0, 1): np.uint8(4), (1, 2): np.uint16(5)})
    assert t.dtype == torch.uint16 and t.data.keys() == j.data.keys()
    # the zero fill value stays float64 there, as in sparse_tpu: its COO raises
    with pytest.raises(ValueError):
        j.to_coo()
    with pytest.raises(ValueError):
        t.to_coo()
    with pytest.raises(ValueError):
        st.DOK((2, 3), data=[1.0], device=CPU)


def test_fill_value():
    t, j = _both((3, 3), fill_value=1.5, dtype=np.float64)
    assert t[0, 0] == j[0, 0] == 1.5
    t[1, 1] = j[1, 1] = 3.0
    x = np.full((3, 3), 1.5)
    x[1, 1] = 3.0
    assert np.allclose(t.todense().numpy(), x)
    _same(t, j)


def test_getitem_complex_falls_back_to_coo():
    s_t = st.random((5, 6), density=0.4, random_state=0, device=CPU)
    s_j = jsp.random((5, 6), density=0.4, random_state=0)
    d_t, d_j = st.DOK.from_coo(s_t), jsp.DOK.from_coo(s_j)
    for key in ((slice(1, 4), slice(None, None, 2)), (Ellipsis, 2), (None, 1), (slice(None, None, -1),)):
        assert_same(d_t[key], d_j[key])
    for key in (1, (slice(None), [0, 5])):
        with pytest.raises(IndexError):
            d_j[key]
        with pytest.raises(IndexError):
            d_t[key]


def test_asformat():
    t, j = _both((3, 3), data={(0, 0): 1.0})
    assert isinstance(t.asformat("coo"), st.COO) and isinstance(t.asformat("gcxs"), st.GCXS)
    assert t.asformat("dok") is t and t.todok() is t
    assert_same(t.asformat("csc"), j.asformat("csc"))
    assert t.asformat("coo").device == torch.device("cpu")


def test_elemwise_output_dok():
    a_t = st.random((4, 4), density=0.3, random_state=0, format="dok", device=CPU)
    b_t = st.random((4, 4), density=0.3, random_state=1, format="dok", device=CPU)
    a_j = jsp.random((4, 4), density=0.3, random_state=0, format="dok")
    b_j = jsp.random((4, 4), density=0.3, random_state=1, format="dok")
    res = a_t + b_t
    assert isinstance(res, st.DOK)
    _same(res, a_j + b_j)
    _same(a_t * 2.0, a_j * 2.0)
    assert isinstance(a_t + a_t.to_coo(), st.COO)


def test_reductions():
    d_t = st.random((4, 5), density=0.3, random_state=0, format="dok", device=CPU)
    d_j = jsp.random((4, 5), density=0.3, random_state=0, format="dok")
    assert_same(d_t.sum(axis=0), d_j.sum(axis=0))
    assert_same(d_t.max(axis=1), d_j.max(axis=1))
    assert float(d_t.sum()) == pytest.approx(float(d_j.sum()), rel=1e-12)
    _same(d_t.reshape((5, 4)), d_j.reshape((5, 4)))
    _same(d_t.transpose(), d_j.transpose())


def test_len_repr_copy_and_device():
    t, j = _both((3, 4))
    assert len(t) == 3 and "DOK" in repr(t) and "cpu" in repr(t)
    t[0, 1] = 2.0
    c = t.copy()
    c[0, 1] = 3.0
    assert t[0, 1] == 2.0 and c.device == t.device
    j[0, 1] = 2.0
    assert t.to_device("cpu") is t and t.nbytes == j.nbytes
    with pytest.raises(TypeError):
        len(st.DOK((), device=CPU))
    assert st.DOK((2, 2), device=CPU).dtype == torch.float64
