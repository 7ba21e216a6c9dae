"""Indexing, ``sort``, ``argmax``/``argmin`` and ``unique_*`` on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_indexing_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). No hand kernel runs
here: these are torch ops on the array's device, and their results on the
card equal the port's results on the CPU bit for bit (coordinates, their
dtype, data, fill value; a scalar result a 0-d tensor on the card), on
inputs that mix ±0.0, NaN and ties, with NumPy and CUDA-tensor indices
alike.
"""

import numpy as np
import pytest
import torch
from torch_index_cases import ADVANCED, AXIS_SELS, MORE, SLICE_TABLE, tricky

import sparse_tpu_torch as st

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's results against the CPU's")
    return torch.device("cuda")


def _pair(x, cuda, fill=None, fmt="coo"):
    fv = None if fill is None else np.asarray(fill, dtype=x.dtype)[()]
    return tuple(st.COO.from_numpy(x, fill_value=fv, device=d).asformat(fmt) for d in (cuda, "cpu"))


def _bits(t):
    return t.detach().cpu().numpy().tobytes()


def _same(got, want):
    """A result on the card equal to the CPU's, bit for bit."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.device.type == "cuda"
        assert got.dtype == want.dtype and got.shape == want.shape and _bits(got) == _bits(want)
        return
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert type(got) is type(want) and got.shape == want.shape and got.device.type == "cuda"
    assert np.asarray(got.fill_value).tobytes() == np.asarray(want.fill_value).tobytes()
    assert got.dtype == want.dtype and _bits(got.data) == _bits(want.data)
    if isinstance(want, st.COO):
        assert got.coords.dtype == want.coords.dtype and _bits(got.coords) == _bits(want.coords)
    else:
        assert got.compressed_axes == want.compressed_axes
        for a, b in ((got.indices, want.indices), (got.indptr, want.indptr)):
            assert a.dtype == b.dtype and _bits(a) == _bits(b)


def _both_raise_or_same(f_gpu, f_cpu):
    try:
        want = f_cpu()
    except Exception as e:  # noqa: BLE001 - the card must raise the same
        with pytest.raises(type(e)):
            f_gpu()
        return
    _same(f_gpu(), want)


def _on(index, device):
    """``index`` with its lists and arrays as int64 (or bool) tensors on
    ``device``."""
    if not isinstance(index, tuple):
        return _on((index,), device)[0]
    out = []
    for k in index:
        if isinstance(k, (list, np.ndarray)):
            a = np.asarray(k)
            a = a.astype(np.int64) if a.dtype.kind != "b" else a
            out.append(torch.as_tensor(a, device=device))
        else:
            out.append(k)
    return tuple(out)


@pytest.mark.parametrize("nonzero_fill", [False, True], ids=["zero_fill", "nonzero_fill"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.bool_], ids=lambda d: np.dtype(d).name)
def test_indexing_table_on_the_card(cuda, dtype, nonzero_fill):
    fill = {np.float32: 1.5, np.float64: np.nan, np.int16: 3, np.bool_: True}[dtype] if nonzero_fill else None
    g, c = _pair(tricky(1, (4, 5, 6), dtype, fill), cuda, fill)
    for index in SLICE_TABLE + ADVANCED + MORE:
        _both_raise_or_same(lambda: g[index], lambda: c[index])
        if any(isinstance(k, (list, np.ndarray)) for k in (index if isinstance(index, tuple) else (index,))):
            _both_raise_or_same(lambda: g[_on(index, cuda)], lambda: c[index])


def test_index_tensor_devices_and_bounds(cuda):
    g, _ = _pair(tricky(2, (6, 7), np.float64), cuda)
    with pytest.raises(ValueError):
        g[torch.tensor([0, 1])]  # a CPU index for a CUDA array
    with pytest.raises(IndexError):
        g[torch.tensor([0, 6], device=cuda)]
    with pytest.raises(IndexError):
        g[:, torch.tensor([-8], device=cuda)]


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_gcxs_picks_on_the_card(cuda, fmt):
    g, c = _pair(tricky(3, (7, 7), np.float32, density=0.4), cuda, fmt=fmt)
    for first in AXIS_SELS:
        _both_raise_or_same(lambda: g[first], lambda: c[first])
        for second in AXIS_SELS:
            _both_raise_or_same(lambda: g[first, second], lambda: c[first, second])
            _both_raise_or_same(lambda: g[_on((first, second), cuda)], lambda: c[first, second])


@pytest.mark.parametrize("dtype,fill", [(np.float64, None), (np.float64, 0.5), (np.float64, np.nan), (np.float32, -1.0), (np.int16, 2), (np.uint8, None), (np.bool_, True)], ids=repr)
def test_sort_argmax_unique_on_the_card(cuda, dtype, fill):
    for seed, shape in ((4, (5, 9)), (5, (3, 4, 6)), (6, (300, 257))):
        g, c = _pair(tricky(seed, shape, dtype, fill), cuda, fill)
        for axis in (0, -1):
            for descending in (False, True):
                _same(st.sort(g, axis=axis, descending=descending), st.sort(c, axis=axis, descending=descending))
            for keepdims in (False, True):
                _same(st.argmax(g, axis=axis, keepdims=keepdims), st.argmax(c, axis=axis, keepdims=keepdims))
                _same(st.argmin(g, axis=axis, keepdims=keepdims), st.argmin(c, axis=axis, keepdims=keepdims))
        _same(st.argmax(g), st.argmax(c))
        if fill is None or not np.isnan(fill) or shape[0] < 300:
            _same(tuple(st.unique_counts(g)), tuple(st.unique_counts(c)))
            _same(st.unique_values(g), st.unique_values(c))


def test_creation_io_and_the_rest_on_the_card(cuda, tmp_path):
    x = tricky(7, (40, 30), np.float32, density=0.3)
    g, c = _pair(np.nan_to_num(x, nan=1.0, posinf=2.0, neginf=-2.0), cuda)
    _same(st.eye(50, 40, k=3, device=cuda), st.eye(50, 40, k=3, device="cpu"))
    _same(st.full((3, 4), 2.5, device=cuda, format="csr"), st.full((3, 4), 2.5, device="cpu", format="csr"))
    _same(st.zeros_like(g), st.zeros_like(c))
    _same(st.random((500, 400), density=0.01, random_state=3, device=cuda), st.random((500, 400), density=0.01, random_state=3, device="cpu"))
    for fn in (lambda a: st.triu(a, 1), lambda a: st.roll(a, 7, axis=1), lambda a: st.flip(a), lambda a: st.kron(a[:4], a[:3]), lambda a: st.pad(a, 2), lambda a: st.nonzero(a), lambda a: st.take(a, [5, 1, 5], axis=1), lambda a: st.diff(a, axis=0)):
        _same(fn(g), fn(c))
    st.save_npz(tmp_path / "g.npz", g.asformat("csr"))
    _same(st.load_npz(tmp_path / "g.npz", device=cuda), st.load_npz(tmp_path / "g.npz", device="cpu"))
    d = g.asformat("dok")
    d[3, 4] = 7.0
    assert d.device == g.device and d.to_coo().device == g.device
    xp, fp = torch.linspace(-1, 2, 9, dtype=torch.float64, device=cuda), torch.linspace(3, -5, 9, dtype=torch.float64, device=cuda)
    _same(st.interp(g, xp, fp), st.interp(c, xp.cpu(), fp.cpu()))
