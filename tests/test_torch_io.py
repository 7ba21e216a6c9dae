"""The port's npz I/O and format conversions against sparse_tpu's (CPU): the
cases of tests/test_io_conversion.py, and files written by one package and
read by the other, COO and GCXS, compressed or not, equal array for array
(data, coordinates or ``indices``/``indptr``, their dtypes, shape, fill
value, ``compressed_axes``)."""

import numpy as np
import pytest
import scipy.sparse
import torch
from test_torch_elemwise import assert_same

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch.testing import assert_eq

CPU = "cpu"
FORMATS = ["coo", "gcxs", "dok", "csr", "csc"]


def _random(fmt, shape=(5, 6), **kwargs):
    return st.random(shape, density=0.3, random_state=0, format=fmt, device=CPU, **kwargs), jsp.random(
        shape, density=0.3, random_state=0, format=fmt, **kwargs
    )


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
def test_save_load_npz(tmp_path, compressed, fmt):
    t, j = _random(fmt)
    st.save_npz(tmp_path / "t.npz", t, compressed=compressed)
    loaded = st.load_npz(tmp_path / "t.npz", device=CPU)
    assert_eq(loaded, j.todense())
    assert type(loaded).__name__.lower().startswith(fmt[:3]) and loaded.device == torch.device("cpu")
    assert_same(loaded, j)


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize(
    "make",
    [
        lambda p, **k: p.random((5, 6), density=0.3, random_state=1, **k),
        lambda p, **k: p.random((3, 4, 5), density=0.3, random_state=2, format="gcxs", compressed_axes=(0, 2), **k),
        lambda p, **k: p.random((6, 7), density=0.4, random_state=3, format="csc", **k),
        lambda p, **k: p.random((40,), density=0.2, random_state=4, format="gcxs", **k),
        lambda p, **k: p.random((4, 5), density=0.5, random_state=5, fill_value=1.5, **k),
        lambda p, **k: p.random((4, 5), density=0.5, random_state=6, data_rvs=lambda n: np.arange(n, dtype=np.int16), **k),
        lambda p, **k: p.random((300, 7), density=0.1, random_state=7, idx_dtype=np.int64, **k),
        lambda p, **k: p.random((), density=1.0, random_state=8, **k),
    ],
)
def test_files_cross_between_packages(tmp_path, make, compressed):
    t, j = make(st, device=CPU), make(jsp)
    st.save_npz(tmp_path / "from_port.npz", t, compressed=compressed)
    jsp.save_npz(tmp_path / "from_jax.npz", j, compressed=compressed)
    with np.load(tmp_path / "from_port.npz") as a, np.load(tmp_path / "from_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    want = jsp.load_npz(tmp_path / "from_jax.npz")
    assert_same(st.load_npz(tmp_path / "from_jax.npz", device=CPU), want)
    assert_same(st.load_npz(tmp_path / "from_port.npz", device="cpu"), want)
    back = jsp.load_npz(tmp_path / "from_port.npz")
    assert type(back) is type(want) and back.shape == want.shape
    names = ("coords", "data") if isinstance(want, jsp.COO) else ("data", "indices", "indptr")
    for name in names:
        a, b = np.asarray(getattr(back, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_narrow_coordinates_and_unsigned_data_round_trip(tmp_path):
    x = np.random.default_rng(0).integers(0, 4, (6, 7)).astype(np.uint16)
    nz = np.nonzero(x)
    t = st.COO(np.stack(nz).astype(np.uint8), x[nz], shape=x.shape, device=CPU)
    j = jsp.COO(np.stack(nz).astype(np.uint8), x[nz], shape=x.shape)
    st.save_npz(tmp_path / "u.npz", t)
    assert_same(st.load_npz(tmp_path / "u.npz", device=CPU), j)
    back = jsp.load_npz(tmp_path / "u.npz")
    for name in ("coords", "data"):
        a, b = np.asarray(getattr(back, name)), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_save_load_fill_value(tmp_path):
    x = np.random.default_rng(0).random((4, 5))
    x[x < 0.5] = 1.5
    s = st.COO.from_numpy(x, fill_value=1.5, device=CPU)
    st.save_npz(tmp_path / "fv.npz", s)
    loaded = st.load_npz(tmp_path / "fv.npz", device=CPU)
    assert float(loaded.fill_value) == 1.5
    assert_eq(loaded, x)


def test_load_invalid(tmp_path):
    np.savez(tmp_path / "bad.npz", foo=np.arange(3))
    with pytest.raises(RuntimeError):
        st.load_npz(tmp_path / "bad.npz", device=CPU)


def test_save_invalid_type(tmp_path):
    with pytest.raises(ValueError):
        st.save_npz(tmp_path / "x.npz", np.arange(3))
    with pytest.raises(ValueError):
        st.save_npz(tmp_path / "x.npz", st.DOK((2, 2), device=CPU))


@pytest.mark.parametrize("format1", FORMATS)
@pytest.mark.parametrize("format2", FORMATS)
def test_conversion_grid(format1, format2):
    shape = (6, 8) if format1 in ("csr", "csc") or format2 in ("csr", "csc") else (4, 5, 6)
    t, j = _random(format1, shape)
    dense = j.todense()
    conv_t, conv_j = t.asformat(format2), j.asformat(format2)
    assert_eq(conv_t, dense)
    assert type(conv_t).__name__ == type(conv_j).__name__
    back_t, back_j = conv_t.asformat(format1), conv_j.asformat(format1)
    assert_eq(back_t, dense)
    if format1 != "dok" and format2 != "dok":
        assert_same(conv_t, conv_j)
        assert_same(back_t, back_j)


@pytest.mark.parametrize("format1", ["coo", "gcxs", "dok"])
@pytest.mark.parametrize("format2", ["coo", "gcxs", "dok"])
def test_conversion_fill_value(format1, format2):
    x = np.random.default_rng(0).random((4, 5))
    x[x < 0.5] = 0.5
    if format1 == "coo":
        s = st.COO.from_numpy(x, fill_value=0.5, device=CPU)
    elif format1 == "gcxs":
        s = st.GCXS.from_numpy(x, fill_value=0.5, device=CPU)
    else:
        s = st.DOK.from_numpy(x, fill_value=0.5, device=CPU)
    conv = s.asformat(format2)
    assert float(np.asarray(conv.fill_value)) == 0.5
    assert np.allclose(conv.todense().numpy(), x)


def test_asarray_formats():
    x = np.random.default_rng(0).random((5, 6))
    x[x < 0.5] = 0
    for fmt in FORMATS:
        res = st.asarray(x, format=fmt, device=CPU)
        assert res.format == fmt
        assert_eq(res, x)


def test_asarray_dtype():
    res = st.asarray(np.eye(3), dtype=np.float32, device=CPU)
    assert res.dtype == torch.float32


def test_as_coo():
    assert_eq(st.as_coo(np.eye(4), device=CPU), np.eye(4))
    assert_eq(st.as_coo(scipy.sparse.eye(4), device=CPU), np.eye(4))
    assert_eq(st.as_coo(torch.eye(4)), np.eye(4, dtype=np.float32))
