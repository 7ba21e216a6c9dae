"""The port's ``einsum`` against sparse_tpu's on the cases of
``tests/test_einsum.py`` (CPU), with COO and GCXS operands, a dense
operand, the sublist form, ``dtype=`` and the errors.

Same inputs, drawn with numpy from a seed, through both packages. Held
equal: the result's class, shape, dtype, fill value and coordinates (by
value and dtype); values at rtol 1e-12 (float64) of the entry's scale
``einsum(|a|, |b|)`` (a full sum, as a 0-d result's fill value, too: the
two packages add in another order). A dense result is a ``torch.Tensor`` where sparse_tpu
returns an ``np.ndarray``.
"""

import numpy as np
import pytest
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"

CASES_2OPS = [
    ("ij,jk->ik", (4, 5), (5, 6)),
    ("ij,jk", (4, 5), (5, 6)),
    ("ij,ij->ij", (4, 5), (4, 5)),
    ("ij,ij->", (4, 5), (4, 5)),
    ("ij,kj->ik", (4, 5), (6, 5)),
    ("ijk,jkl->il", (2, 3, 4), (3, 4, 5)),
    ("ijk,kl->ijl", (2, 3, 4), (4, 5)),
    ("i,i->", (5,), (5,)),
    ("i,j->ij", (4,), (5,)),
    ("ij,j->i", (4, 5), (5,)),
    ("bij,bjk->bik", (2, 3, 4), (2, 4, 5)),
    ("...ij,...jk->...ik", (2, 3, 4), (2, 4, 5)),
    ("ij,jk->ki", (4, 5), (5, 6)),
    ("ij,kl->ijkl", (2, 3), (4, 2)),
    ("ij,kl->", (2, 3), (4, 2)),
    ("ij,kj->ikj", (3, 4), (5, 4)),
    ("ijk,ijk->", (2, 3, 4), (2, 3, 4)),
    ("ijk,jk->i", (2, 3, 4), (3, 4)),
    ("ijk,jk->ij", (2, 3, 4), (3, 4)),
    ("ijk,jk->ik", (2, 3, 4), (3, 4)),
    ("ab,bc->ca", (3, 4), (4, 5)),
    ("...k,...k->...", (2, 3, 4), (2, 3, 4)),
    ("i...,i...->...", (2, 3, 4), (2, 3, 4)),
]

CASES_1OP = [
    ("ij->ji", (4, 5)),
    ("ij->", (4, 5)),
    ("ij->i", (4, 5)),
    ("ij->j", (4, 5)),
    ("ii->i", (5, 5)),
    ("ii->", (5, 5)),
    ("ijk->ikj", (2, 3, 4)),
    ("ijk->k", (2, 3, 4)),
    ("iji->j", (3, 4, 3)),
    ("...i->...", (2, 3, 4)),
    ("ij...->...", (2, 3, 4)),
    ("ijk->ijk", (2, 3, 4)),
    ("ijk->kij", (2, 3, 4)),
    ("iij->ij", (3, 3, 4)),
    ("iij->j", (3, 3, 4)),
    ("iji->ij", (3, 4, 3)),
    ("ii", (4, 4)),
    ("ij", (3, 4)),
    ("...jk->...kj", (2, 3, 4)),
]


def _dense(shape, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return np.where(rng.random(shape) < density, x, 0.0)


def _pair(x, fmt):
    t, j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    return (t, j) if fmt == "coo" else (t.asformat(fmt), j.asformat(fmt))


def _values(x):
    if isinstance(x, st.SparseArray):
        return x.todense().numpy()
    if isinstance(x, jsp.SparseArray):
        return np.asarray(x.todense())
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, want, scale):
    scale = np.abs(np.asarray(scale, dtype=np.float64))
    if isinstance(want, jsp.SparseArray):
        assert type(got).__name__ == type(want).__name__
        assert got.shape == want.shape and numpy_dtype(got.dtype) == np.asarray(want.data).dtype
        if want.ndim:  # a 0-d result is its own fill value: a full sum, held below
            assert np.asarray(got.fill_value).tobytes() == np.asarray(want.fill_value).tobytes()
        if isinstance(want, jsp.COO) and want.ndim:
            np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
            assert numpy_dtype(got.coords.dtype) == np.asarray(want.coords).dtype
        elif isinstance(want, jsp.GCXS):
            assert got.compressed_axes == want.compressed_axes
            np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
            np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    else:
        assert isinstance(got, torch.Tensor) and tuple(got.shape) == np.shape(want)
        assert numpy_dtype(got.dtype) == np.asarray(want).dtype
    err = np.abs(_values(got) - _values(want))
    assert (err <= 1e-12 * scale + 1e-300).all()


@pytest.mark.parametrize("subscript,a_shape,b_shape", CASES_2OPS)
@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_einsum_two_operands(subscript, a_shape, b_shape, fmt):
    x, y = _dense(a_shape, 0.4, 0), _dense(b_shape, 0.4, 1)
    (ta, ja), (tb, jb) = _pair(x, fmt), _pair(y, fmt)
    _check(st.einsum(subscript, ta, tb), jsp.einsum(subscript, ja, jb), np.einsum(subscript, np.abs(x), np.abs(y)))


@pytest.mark.parametrize("subscript,shape", CASES_1OP)
@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_einsum_single_operand(subscript, shape, fmt):
    x = _dense(shape, 0.4, 3)
    t, j = _pair(x, fmt)
    _check(st.einsum(subscript, t), jsp.einsum(subscript, j), np.einsum(subscript, np.abs(x)))


@pytest.mark.parametrize(
    "subscript,shapes",
    [
        ("ij,jk,kl->il", ((3, 4), (4, 5), (5, 2))),
        ("ij,jk,kl->li", ((3, 4), (4, 5), (5, 2))),
        ("ab,bc,cd,de->ae", ((3, 4), (4, 5), (5, 2), (2, 3))),
        ("ij,ij,ij->ij", ((3, 4), (3, 4), (3, 4))),
    ],
)
def test_einsum_three_or_more_operands(subscript, shapes):
    xs = [_dense(s, 0.5, i) for i, s in enumerate(shapes)]
    pairs = [_pair(x, "coo") for x in xs]
    got = st.einsum(subscript, *[p[0] for p in pairs])
    want = jsp.einsum(subscript, *[p[1] for p in pairs])
    _check(got, want, np.einsum(subscript, *[np.abs(x) for x in xs]))


@pytest.mark.parametrize("dense_as", ["ndarray", "tensor"])
@pytest.mark.parametrize("subscript", ["ij,jk->ik", "ij,jk->ki", "ij,ij->ij"])
def test_einsum_mixed_dense(dense_as, subscript):
    x = _dense((3, 4), 0.5, 0)
    y = np.random.default_rng(1).random((4, 5) if subscript != "ij,ij->ij" else (3, 4))
    t, j = _pair(x, "coo")
    yt = y if dense_as == "ndarray" else torch.as_tensor(y)
    _check(st.einsum(subscript, t, yt), jsp.einsum(subscript, j, y), np.einsum(subscript, np.abs(x), y))


def test_einsum_interleaved():
    x, y = _dense((3, 4), 0.5, 0), _dense((4, 5), 0.5, 1)
    (ta, ja), (tb, jb) = _pair(x, "coo"), _pair(y, "coo")
    scale = np.einsum(np.abs(x), [0, 1], np.abs(y), [1, 2], [0, 2])
    _check(st.einsum(ta, [0, 1], tb, [1, 2], [0, 2]), jsp.einsum(ja, [0, 1], jb, [1, 2], [0, 2]), scale)
    _check(st.einsum(ta, [0, 1], tb, [1, 2]), jsp.einsum(ja, [0, 1], jb, [1, 2]), scale)
    with pytest.raises(TypeError, match="sublist"):
        st.einsum(ta, "ij", tb, [1, 2])


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.complex128])
def test_einsum_dtype(dtype):
    x = _dense((3, 4), 0.5, 0)
    t, j = _pair(x, "coo")
    got, want = st.einsum("ij->i", t, dtype=dtype), jsp.einsum("ij->i", j, dtype=dtype)
    assert numpy_dtype(got.dtype) == np.dtype(dtype) == want.dtype
    np.testing.assert_array_equal(_values(got), _values(want))
    got, want = st.einsum("ij,jk->ik", t, t.T, dtype=dtype), jsp.einsum("ij,jk->ik", j, j.T, dtype=dtype)
    assert numpy_dtype(got.dtype) == want.dtype
    np.testing.assert_allclose(_values(got), _values(want), rtol=1e-6)


def test_einsum_errors():
    t, j = _pair(_dense((3, 4), 0.5, 0), "coo")
    for call in (
        lambda p, a: p.einsum("ij,jk->ik", a),
        lambda p, a: p.einsum("ijk->i", a),
        lambda p, a: p.einsum("ij->il", a),
        lambda p, a: p.einsum("ij->ii", a),
        lambda p, a: p.einsum("ij,jk->ik", a, a),
        lambda p, a: p.einsum(),
    ):
        with pytest.raises(ValueError):
            call(jsp, j)
        with pytest.raises(ValueError):
            call(st, t)
    with pytest.raises(TypeError, match="unexpected keyword"):
        st.einsum("ij->i", t, out=None)
