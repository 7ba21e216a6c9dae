"""The port's indexing against sparse_tpu's (CPU, small sizes): COO
``__getitem__`` over tests/test_coo.py's slicing table and advanced-index
list on a 3-D array at a zero and a nonzero fill value in float32, float64,
int16 and bool; the scalar results and the ``IndexError`` cases; narrow
coordinate dtypes; index tensors; ``unstack``, ``iter``, ``take`` and
``diff``; and every ``_getitem_fast`` pattern of CSR and CSC with its COO
fallback. Indexing does no arithmetic, so the outputs are held bit for bit:
type, shape, coordinates (or ``indptr``/``indices``) and their dtypes, data,
fill value and ``compressed_axes``.
"""

import numpy as np
import pytest
import torch
from test_torch_elemwise import assert_same, dense
from torch_index_cases import ADVANCED, AXIS_SELS, MORE, SLICE_TABLE

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"

ERRORS = [10, (0, 0, 0, 0), (1, 7), ([0, 9],), (Ellipsis, Ellipsis), (0.5,), ([[0, 1]],), ([0, 1], [0, 1, 2])]

DTYPES = [np.float32, np.float64, np.int16, np.bool_]
FILLS = {np.float32: 1.5, np.float64: np.nan, np.int16: 3, np.bool_: True}


def _arrays(dtype, nonzero_fill, seed=0, shape=(4, 5, 6)):
    fill = FILLS[dtype] if nonzero_fill else None
    x = dense(seed, shape, dtype, density=0.45, fill=fill)
    fv = None if fill is None else np.asarray(fill, dtype=dtype)[()]
    return x, st.COO.from_numpy(x, fill_value=fv, device=CPU), jsp.COO.from_numpy(x, fill_value=fv)


def _same(t, j):
    """The port's indexing result against sparse_tpu's, bit for bit: a 0-d
    tensor for a NumPy scalar, else the same sparse array."""
    if isinstance(j, (np.generic, np.ndarray)) and not hasattr(j, "fill_value"):
        assert isinstance(t, torch.Tensor) and t.ndim == 0 and t.device.type == "cpu", type(t)
        assert numpy_dtype(t.dtype) == np.asarray(j).dtype
        got, want = t.numpy().reshape(1), np.asarray(j).reshape(1)
        assert got.tobytes() == want.tobytes(), (got, want)
        return
    assert_same(t, j)


def _run(t_fn, j_fn):
    try:
        j = j_fn()
    except Exception as e:  # noqa: BLE001 - the port must raise the same type
        with pytest.raises(type(e)):
            t_fn()
        return
    _same(t_fn(), j)


@pytest.mark.parametrize("nonzero_fill", [False, True], ids=["zero_fill", "nonzero_fill"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("index", SLICE_TABLE + ADVANCED + MORE, ids=repr)
def test_getitem_matches_sparse_tpu(index, dtype, nonzero_fill):
    x, t, j = _arrays(dtype, nonzero_fill)
    _run(lambda: t[index], lambda: j[index])
    out = t[index]
    if isinstance(out, st.COO):
        np.testing.assert_array_equal(out.todense().numpy(), x[index])


@pytest.mark.parametrize("index", ERRORS, ids=repr)
def test_index_errors_match_sparse_tpu(index):
    _, t, j = _arrays(np.float64, False)
    with pytest.raises(Exception) as want:
        j[index]
    with pytest.raises(want.type):
        t[index]


def test_scalar_results_are_0d_tensors():
    x, t, _ = _arrays(np.float64, False)
    nz = np.argwhere(x != 0)[0]
    z = np.argwhere(x == 0)[0]
    for pos in (tuple(nz), tuple(z), (1, 2, 3)):
        got = t[pos]
        assert isinstance(got, torch.Tensor) and got.shape == () and got.dtype == torch.float64
        assert got.numpy().tobytes() == x[pos].tobytes()
    t0, j0 = st.COO.from_numpy(np.array(2.5), device=CPU), jsp.COO.from_numpy(np.array(2.5))
    _same(t0[()], j0[()])
    _same(t0[...], j0[...])
    one = st.COO(np.zeros((0, 1), dtype=np.int64), np.array([4.0]), shape=(), device=CPU)
    assert one[()].item() == 4.0


@pytest.mark.parametrize("idx_dtype", [np.uint8, np.int16, np.uint16, np.int32])
@pytest.mark.parametrize(
    "index",
    [2, (slice(1, 3),), ([3, 0, 3],), (slice(None), [4, 1]), (slice(None, None, -1), 2), (None, 1), ([1, 2], [3, 3])],
    ids=repr,
)
def test_narrow_coordinate_dtypes(index, idx_dtype):
    x = dense(5, (6, 7), np.float64, density=0.5)
    nz = np.nonzero(x)
    coords = np.stack(nz).astype(idx_dtype)
    t = st.COO(coords, x[nz], shape=x.shape, device=CPU)
    j = jsp.COO(coords, x[nz], shape=x.shape)
    assert numpy_dtype(t.coords.dtype) == np.asarray(j.coords).dtype
    _run(lambda: t[index], lambda: j[index])


def test_many_row_picks_widen_narrow_coordinates():
    """Picks past the coordinates' range: the new row count is stored in a
    dtype that holds it (sparse_tpu's uint8 rows wrap here; ROADMAP §C2)."""
    x = dense(6, (10, 4), np.float64, density=0.6)
    nz = np.nonzero(x)
    t = st.COO(np.stack(nz).astype(np.uint8), x[nz], shape=x.shape, device=CPU)
    picks = np.random.default_rng(0).integers(0, 10, size=300)
    out = t[picks]
    assert out.shape == (300, 4) and numpy_dtype(out.coords.dtype) == np.uint16
    np.testing.assert_array_equal(out.todense().numpy(), x[picks])


@pytest.mark.parametrize(
    "index",
    [([3, 0, 3],), (slice(None), [4, 1, 4]), (np.array([True, False, True, True]),), ([1, -1], slice(None), [0, 2])],
    ids=repr,
)
def test_tensor_indices_match_numpy_indices(index):
    _, t, j = _arrays(np.float64, True)
    as_tensor = tuple(torch.as_tensor(np.asarray(k)) if isinstance(k, (list, np.ndarray)) else k for k in index)
    _same(t[as_tensor], j[index])
    _same(t[index], j[index])


def test_tensor_index_bounds_and_devices():
    _, t, _ = _arrays(np.float64, False)
    with pytest.raises(IndexError):
        t[torch.tensor([0, 4])]
    with pytest.raises(IndexError):
        t[:, torch.tensor([-6, 1])]
    with pytest.raises(IndexError):
        t[torch.tensor([True, False])]
    assert t[torch.tensor(2)].shape == (5, 6)
    with pytest.raises(NotImplementedError, match="structured dtype"):
        t["field"]


def test_identity_and_caching():
    _, t, _ = _arrays(np.float64, False)
    assert len(t) == 4 and t.format == "coo"
    out = t[:, :, :]
    assert out is not t and out.coords is t.coords
    t.enable_caching()
    assert t[1:3] is t[1:3]
    assert t[[0, 1]] is not t[[0, 1]]  # an unhashable index is not memoized
    picks = torch.tensor([2, 0])
    first = t[picks]
    picks[0] = 1  # a tensor hashes by identity: never memoized
    assert first is not t[picks]
    np.testing.assert_array_equal(t[picks].todense().numpy(), t.todense().numpy()[[1, 0]])
    assert t[(slice(None), torch.tensor([1]))].shape == (4, 1, 6)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_unstack_iter_take_diff(axis):
    x, t, j = _arrays(np.float64, False)
    for a, b in zip(st.unstack(t, axis=axis), jsp.unstack(j, axis=axis), strict=True):
        _same(a, b)
    for a, b in zip(iter(t), iter(j), strict=True):
        _same(a, b)
    _same(st.take(t, [3, 0, 3], axis=axis), jsp.take(j, [3, 0, 3], axis=axis))
    _same(st.take(t, np.array([7, 1, 20])), jsp.take(j, np.array([7, 1, 20])))
    _same(st.take(t, torch.tensor([2, 2]), axis=axis), jsp.take(j, np.array([2, 2]), axis=axis))
    for n in (1, 2):
        _same(st.diff(t, axis=axis, n=n), jsp.diff(j, axis=axis, n=n))
    pre = st.COO.from_numpy(x[:1] if axis == 0 else x[:, :1] if axis == 1 else x[..., :1], device=CPU)
    pre_j = jsp.COO.from_numpy(pre.todense().numpy())
    _same(st.diff(t, axis=axis, prepend=pre, append=pre), jsp.diff(j, axis=axis, prepend=pre_j, append=pre_j))


# ---------------------------------------------------------------------------
# GCXS, CSR and CSC
# ---------------------------------------------------------------------------

def _gcxs_pair(fmt, dtype=np.float64, shape=(7, 7), fill=None, seed=11):
    x = dense(seed, shape, dtype, density=0.4, fill=fill)
    fv = None if fill is None else np.asarray(fill, dtype=dtype)[()]
    cls_t = {"csr": st.CSR, "csc": st.CSC}[fmt]
    cls_j = {"csr": jsp.CSR, "csc": jsp.CSC}[fmt]
    return x, cls_t.from_numpy(x, fill_value=fv, device=CPU), cls_j.from_numpy(x, fill_value=fv)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("second", AXIS_SELS, ids=repr)
@pytest.mark.parametrize("first", AXIS_SELS, ids=repr)
def test_gcxs_2d_patterns_match_sparse_tpu(first, second, fmt):
    x, t, j = _gcxs_pair(fmt)
    _run(lambda: t[first, second], lambda: j[first, second])
    _run(lambda: t[first], lambda: j[first])


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize(
    "index",
    [(None, 1), (Ellipsis, 2), (1, 2, 3), ([1, 2], [3, 4]), (0.5, 1), (7, 0), (0, -8), ([0, 9], 1), ([True], 2)],
    ids=repr,
)
def test_gcxs_fallbacks_and_errors_match_sparse_tpu(index, fmt):
    _, t, j = _gcxs_pair(fmt, np.float32, fill=2.0)
    _run(lambda: t[index], lambda: j[index])


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.bool_], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_gcxs_picks_in_other_dtypes(fmt, dtype):
    _, t, j = _gcxs_pair(fmt, dtype)
    for index in ((slice(None), [0, 6]), ([6, 0, 6],), (3, slice(1, 4)), (slice(2, 6), 4)):
        _run(lambda: t[index], lambda: j[index])


@pytest.mark.parametrize("compressed_axes", [(0,), (1,), (2,), (0, 2)])
@pytest.mark.parametrize("index", [1, (slice(None), 2), ([0, 2], slice(1, 3)), (Ellipsis, [1, 0]), (1, 2, 3), (None, 0)], ids=repr)
def test_gcxs_nd_through_the_coo(index, compressed_axes):
    x = dense(12, (3, 4, 5), np.float64, density=0.5)
    t = st.GCXS.from_numpy(x, compressed_axes=compressed_axes, device=CPU)
    j = jsp.GCXS.from_numpy(x, compressed_axes=compressed_axes)
    _run(lambda: t[index], lambda: j[index])


def test_gcxs_tensor_picks_and_iteration():
    _, t, j = _gcxs_pair("csr")
    _same(t[torch.tensor([5, 1, 5])], j[np.array([5, 1, 5])])
    _same(t[:, torch.tensor([0, 3, 6])], j[:, np.array([0, 3, 6])])
    _same(t[torch.tensor([True, False, True, False, True, True, False])], j[np.array([True, False, True, False, True, True, False])])
    with pytest.raises(IndexError):
        t[torch.tensor([0, 7])]
    rows_t, rows_j = list(t), list(j)
    assert len(rows_t) == len(rows_j) == 7
    for a, b in zip(rows_t, rows_j):
        _same(a, b)
    for a, b in zip(st.unstack(t), jsp.unstack(j)):
        _same(a, b)
