"""The port's host C++ runtime (``sparse_tpu_torch.native``) against
``sparse_tpu.native`` and its call sites on both CPU routes.

Mirrors ``tests/test_native_eager.py`` function by function: each binding
runs on the same inputs (sizes and values from a NumPy seed) as
``sparse_tpu``'s, float32 and float64, with the thresholds at 0. Functions
without products or whose sums are written out (joins, canonicalization,
SpGEMM, transposes, reductions) agree bit for bit; the sparse × dense
products agree at rtol 1e-12 (float64) and 1e-5 (float32), because
``sparse_tpu``'s library is built with ``-march=native`` and g++ contracts
its ``a*b+c`` into FMA there, where the port's ``-ffp-contract=off`` rounds
each product apart. Each call site of the COO constructor, the sparse ×
dense products, the element-wise union and SpGEMM runs on both CPU routes
(``route`` below): the library's counters move on one and stay at 0 on the
other, and where both sum in one order the bits are equal.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_tpu as jsp
from sparse_tpu import native as jnative
from sparse_tpu.native import eager as jeager
import sparse_tpu_torch as st
from sparse_tpu_torch import native
from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.native import eager as te

CPU = "cpu"
TOL = {np.float64: 1e-12, np.float32: 1e-5}
FLOATS = [np.float64, np.float32]


@pytest.fixture(autouse=True)
def _reference_native(monkeypatch):
    """``sparse_tpu``'s library at thresholds 0, and the port's counters zeroed."""
    if jeager.get_lib() is None or jnative.get_lib() is None:
        pytest.fail("sparse_tpu's native library did not build")
    monkeypatch.setattr(jeager, "NATIVE_MIN_NNZ", 0)
    monkeypatch.setattr(jnative, "NATIVE_MIN_SIZE", 0)
    native.reset_calls()


@pytest.fixture(params=["host", "torch"])
def route(request, monkeypatch):
    """The port's CPU route: ``"host"`` puts every threshold at 0, ``"torch"``
    past any size here."""
    low = 0 if request.param == "host" else 10**15
    monkeypatch.setattr(native, "NATIVE_MIN_SIZE", low)
    monkeypatch.setattr(te, "NATIVE_MIN_NNZ", low)
    monkeypatch.setattr(te, "NATIVE_MIN_PRODUCT_NNZ", low)
    return request.param


def _calls(*names):
    return sum(native.CALLS[n] for n in names)


def _check_route(route, *names):
    moved = _calls(*names)
    assert (moved > 0) if route == "host" else (moved == 0), (route, dict(native.CALLS))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _close(got, want, dtype):
    scale = max(1.0, np.abs(want).max(initial=0))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL[dtype], atol=TOL[dtype] * scale)


def _same_coo(t, j, rtol=None):
    np.testing.assert_array_equal(_np(t.coords).astype(np.int64), np.asarray(j.coords).astype(np.int64))
    if rtol is None:
        _bits_equal(t.data, np.asarray(j.data))
    else:
        np.testing.assert_allclose(_np(t.data), np.asarray(j.data), rtol=rtol, atol=rtol)


def _dense(shape, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * (rng.random(shape) < density)).astype(dtype)


# ---------------------------------------------------------------------------
# the bindings against sparse_tpu.native.eager
# ---------------------------------------------------------------------------


def test_union_join():
    ka = np.array([1, 3, 5, 7], dtype=np.int64)
    kb = np.array([2, 3, 8], dtype=np.int64)
    keys, ia, ib = te.union_join(ka, kb)
    np.testing.assert_array_equal(keys, [1, 2, 3, 5, 7, 8])
    np.testing.assert_array_equal(ia, [0, -1, 1, 2, 3, -1])
    np.testing.assert_array_equal(ib, [-1, 0, 1, -1, -1, 2])
    for g, w in zip((keys, ia, ib), jeager.union_join(ka, kb)):
        _bits_equal(g, w)
    assert native.CALLS["union_join"] == 1


def test_union_join_empty_sides():
    ka = torch.tensor([4, 9])
    kb = torch.empty(0, dtype=torch.int64)
    keys, ia, ib = te.union_join(ka, kb)
    assert keys.tolist() == [4, 9] and ib.tolist() == [-1, -1]
    keys, ia, ib = te.union_join(kb, ka)
    assert keys.tolist() == [4, 9] and ia.tolist() == [-1, -1]


@pytest.mark.parametrize("dtype", FLOATS)
def test_union_join_values_matches_sparse_tpu(dtype):
    rng = np.random.default_rng(1)
    ka = np.sort(rng.choice(3000, 400, replace=False)).astype(np.int64)
    kb = np.sort(rng.choice(3000, 300, replace=False)).astype(np.int64)
    va, vb = rng.standard_normal(400).astype(dtype), rng.standard_normal(300).astype(dtype)
    got = te.union_join_values(ka, va, dtype(1.5), kb, vb, dtype(-0.0))
    for g, w in zip(got, jeager.union_join_values(ka, va, dtype(1.5), kb, vb, dtype(-0.0))):
        _bits_equal(g, w)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("op", ["add", "subtract", "multiply"])
def test_fused_join_matches_numpy(op, dtype):
    rng = np.random.default_rng(0)
    n = 500
    ka = np.sort(rng.choice(5000, n, replace=False)).astype(np.int64)
    kb = np.sort(rng.choice(5000, n, replace=False)).astype(np.int64)
    va = rng.standard_normal(n).astype(dtype)
    vb = rng.standard_normal(n).astype(dtype)
    keys, vals = te.fused_join(op, ka, va, kb, vb)
    da, db = np.zeros(5000, dtype=dtype), np.zeros(5000, dtype=dtype)
    da[ka], db[kb] = va, vb
    got = np.zeros(5000, dtype=dtype)
    got[_np(keys)] = _np(vals)
    np.testing.assert_array_equal(got, getattr(np, op)(da, db))
    assert not np.any((_np(vals) == 0) & ~np.signbit(_np(vals)))  # no stored +0.0
    jk, jv = jeager.fused_join(op, ka, va, kb, vb)
    _bits_equal(keys, jk)
    _bits_equal(vals, jv)


def test_fused_join_ieee_semantics():
    keys, vals = te.fused_join("multiply", np.array([0]), np.array([np.inf]), np.array([1]), np.array([2.0]))
    assert keys.tolist() == [0] and bool(torch.isnan(vals[0]))
    ka, kb = np.array([0, 1]), np.array([0, 2])
    keys, vals = te.fused_join("subtract", ka, np.array([1.0, -0.0]), kb, np.array([1.0, 1.0]))
    assert keys.tolist() == [1, 2]
    assert bool(torch.signbit(vals[0])) and vals[0] == 0 and vals[1] == -1.0


@pytest.mark.parametrize("op", ["add", "subtract", "multiply"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_fused_join_2d_kernel(op, idx_dtype, dtype):
    rng = np.random.default_rng(31)
    m, k = 40, 30
    lin_a = np.sort(rng.choice(m * k, 200, replace=False))
    lin_b = np.sort(rng.choice(m * k, 180, replace=False))
    ra, ca = (lin_a // k).astype(idx_dtype), (lin_a % k).astype(idx_dtype)
    rb, cb = (lin_b // k).astype(idx_dtype), (lin_b % k).astype(idx_dtype)
    va = (rng.standard_normal(200) * 4).astype(dtype)
    vb = (rng.standard_normal(180) * 4).astype(dtype)
    ro, co, vo = te.fused_join_2d(op, ra, ca, va, rb, cb, vb, k)
    assert ro.dtype == torch.from_numpy(np.empty(0, idx_dtype)).dtype
    da, db = np.zeros((m, k), dtype=dtype), np.zeros((m, k), dtype=dtype)
    da[ra, ca], db[rb, cb] = va, vb
    got = np.zeros((m, k), dtype=dtype)
    got[_np(ro), _np(co)] = _np(vo)
    np.testing.assert_array_equal(got, getattr(np, op)(da, db))
    assert (np.diff(_np(ro).astype(np.int64) * k + _np(co)) > 0).all()
    for g, w in zip((ro, co, vo), jeager.fused_join_2d(op, ra, ca, va, rb, cb, vb, k)):
        _bits_equal(g, w)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_canonicalize2d_kernel(idx_dtype, dtype):
    rng = np.random.default_rng(21)
    m, k, n = 40, 30, 500
    rows = rng.integers(0, m, n).astype(idx_dtype)
    cols = rng.integers(0, k, n).astype(idx_dtype)
    vals = rng.standard_normal(n).astype(dtype)
    ro, co, vo = te.canonicalize2d(rows, cols, vals, m)
    assert _np(ro).dtype == idx_dtype
    dense = np.zeros((m, k))
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    got = np.zeros((m, k))
    got[_np(ro), _np(co)] = _np(vo)
    np.testing.assert_allclose(got, dense, rtol=TOL[dtype], atol=TOL[dtype])
    assert (np.diff(_np(ro).astype(np.int64) * k + _np(co)) > 0).all()
    for g, w in zip((ro, co, vo), jeager.canonicalize2d(rows, cols, vals, m)):
        _bits_equal(g, w)


@pytest.mark.parametrize("dtype", FLOATS)
def test_spgemm_csr_vs_scipy_and_sparse_tpu(dtype):
    rng = np.random.default_rng(5)
    a = sps.random(300, 200, 0.05, format="csr", random_state=rng).astype(dtype)
    b = sps.random(200, 250, 0.05, format="csr", random_state=rng).astype(dtype)
    pc, jc, vc = te.spgemm_csr(a.indptr, a.indices, a.data, b.indptr, b.indices, b.data, 300, 250)
    c = sps.csr_matrix((_np(vc), _np(jc), _np(pc)), shape=(300, 250))
    assert abs(c - a @ b).max() < TOL[dtype]
    for r in range(300):
        assert np.all(np.diff(_np(jc)[int(pc[r]) : int(pc[r + 1])]) > 0)
    want = jeager.spgemm_csr(a.indptr, a.indices, a.data, b.indptr, b.indices, b.data, 300, 250)
    for g, w in zip((pc, jc, vc), want):
        _bits_equal(g, w)


def test_spgemm_csr_two_phase_matches_sparse_tpu():
    # a product bound far past the operands' sizes takes the symbolic and
    # numeric passes
    rng = np.random.default_rng(6)
    a = sps.random(400, 60, 0.5, format="csr", random_state=rng)
    b = sps.random(60, 500, 0.5, format="csr", random_state=rng)
    args = (a.indptr, a.indices, a.data, b.indptr, b.indices, b.data, 400, 500)
    for g, w in zip(te.spgemm_csr(*args), jeager.spgemm_csr(*args)):
        _bits_equal(g, w)
    pc, jc, vc = (_np(x) for x in te.spgemm_csr(*args))
    assert np.allclose(sps.csr_matrix((vc, jc, pc), shape=(400, 500)).toarray(), (a @ b).toarray())


def test_csr_spmm_dense_kernel_direct():
    rng = np.random.default_rng(12)
    a = sps.random(200, 150, 0.1, format="csr", random_state=rng)
    d = rng.random((150, 17))
    out = te.csr_spmm_dense(a.indptr, a.indices, a.data, d, 200)
    _close(out, a @ d, np.float64)
    _close(out, jeager.csr_spmm_dense(a.indptr, a.indices, a.data, d, 200), np.float64)
    v = rng.random(150)
    _close(te.csr_spmm_dense(a.indptr, a.indices, a.data, v, 200), a @ v, np.float64)
    _close(te.csr_spmm_dense(a.indptr, a.indices, a.data, v[:, None], 200), (a @ v)[:, None], np.float64)
    # int32 indices take the i32 kernels, with the int64 kernels' bits
    wide = te.csr_spmm_dense(a.indptr.astype(np.int64), a.indices.astype(np.int64), a.data, d, 200)
    assert torch.equal(wide, te.csr_spmm_dense(a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data, d, 200))


def test_csc_spmm_dense_kernel_direct():
    rng = np.random.default_rng(13)
    a = sps.random(120, 90, 0.1, format="csc", random_state=rng)
    d = rng.random((90, 33))
    out = te.csc_spmm_dense(a.indptr, a.indices, a.data, d, 120, 90)
    _close(out, a @ d, np.float64)
    _close(out, jeager.csc_spmm_dense(a.indptr, a.indices, a.data, d, 120, 90), np.float64)
    v = rng.random(90)
    _close(te.csc_spmm_dense(a.indptr, a.indices, a.data, v, 120, 90), a @ v, np.float64)


@pytest.mark.parametrize("dtype", FLOATS)
def test_entry_loop_and_spmv_add_match_sparse_tpu(dtype):
    rng = np.random.default_rng(14)
    a = sps.random(3000, 2500, 1e-4, format="coo", random_state=rng).astype(dtype)
    x, y = rng.standard_normal(2500).astype(dtype), rng.standard_normal(3000).astype(dtype)
    r, c = a.row.astype(np.int64), a.col.astype(np.int64)
    for yy in (None, y):
        got = te.coo_spmv_entries(r, c, a.data, x, 3000, y=yy)
        _close(got, jeager.coo_spmv_entries(r, c, a.data, x, 3000, y=yy), dtype)
        _close(got, a @ x + (0 if yy is None else yy), dtype)
    csr = a.tocsr()
    for compressed_rows, m in ((True, csr), (False, a.tocsc())):
        got = te.spmv_add(m.indptr, m.indices, m.data, x, y, 3000, 2500, compressed_rows)
        _close(got, jeager.spmv_add(m.indptr, m.indices, m.data, x, y, 3000, 2500, compressed_rows), dtype)


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", FLOATS)
def test_transpose2d_kernel(idx_dtype, dtype):
    rng = np.random.default_rng(7)
    n_rows, n_cols, nnz = 61, 97, 800
    lin = np.sort(rng.choice(n_rows * n_cols, size=nnz, replace=False))
    rows, cols = (lin // n_cols).astype(idx_dtype), (lin % n_cols).astype(idx_dtype)
    vals = rng.standard_normal(nnz).astype(dtype)
    indptr, rows_t, cols_t, vals_t = te.transpose2d(rows, cols, vals, n_cols)
    dense = np.zeros((n_rows, n_cols), dtype=dtype)
    dense[rows, cols] = vals
    ref = st.COO.from_numpy(dense.T, device=CPU)
    np.testing.assert_array_equal(_np(rows_t), _np(ref.coords[0]))
    np.testing.assert_array_equal(_np(cols_t), _np(ref.coords[1]))
    _bits_equal(vals_t, _np(ref.data))
    np.testing.assert_array_equal(np.diff(_np(indptr)), np.bincount(cols, minlength=n_cols))
    for g, w in zip((indptr, rows_t, cols_t, vals_t), jeager.transpose2d(rows, cols, vals, n_cols)):
        _bits_equal(g, w)
    assert te.transpose2d(rows, cols, vals, n_cols, want_rows=False)[1] is None


def test_transpose2d_empty_and_empty_columns():
    rows = torch.empty(0, dtype=torch.int64)
    indptr, rows_t, cols_t, vals_t = te.transpose2d(rows, rows.clone(), torch.empty(0, dtype=torch.float64), 5)
    assert indptr.tolist() == [0] * 6 and rows_t.numel() == 0 and vals_t.numel() == 0
    rows = torch.arange(4)
    indptr, rows_t, cols_t, vals_t = te.transpose2d(rows, torch.full((4,), 2), torch.arange(4.0), 5)
    assert indptr.tolist() == [0, 0, 0, 4, 4, 4] and cols_t.tolist() == rows.tolist() and rows_t.tolist() == [2] * 4


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int8, np.bool_, np.float16, np.complex128, np.uint16])
def test_transpose2d_generic_dtypes(dtype):
    rng = np.random.default_rng(3)
    d = (rng.random((211, 173)) * 4).astype(dtype) * (rng.random((211, 173)) < 0.3).astype(dtype)
    s = st.COO.from_numpy(d, device=CPU)
    _, rows_t, cols_t, vals_t = te.transpose2d(s.coords[0], s.coords[1], s.data, s.shape[1])
    ref = st.COO.from_numpy(d.T, device=CPU)
    np.testing.assert_array_equal(_np(rows_t), _np(ref.coords[0]))
    np.testing.assert_array_equal(_np(cols_t), _np(ref.coords[1]))
    _bits_equal(vals_t, _np(ref.data))


def test_dense_spmm_csrt_kernel_direct():
    rng = np.random.default_rng(9)
    k, n, m = 200, 130, 16
    s = jsp.random((k, n), density=0.06, random_state=rng)
    indptr, kids, vals = s._csc_buffers()
    x = rng.standard_normal((m, k))
    out = te.dense_spmm_csrt(indptr, kids, vals, x, n)
    _close(out, x @ s.todense(), np.float64)
    _close(out, jeager.dense_spmm_csrt(indptr, kids, vals, x, n), np.float64)


@pytest.mark.parametrize("dtype", FLOATS)
def test_reductions_match_sparse_tpu(dtype):
    rng = np.random.default_rng(15)
    keys = np.sort(rng.integers(0, 300, 5000)).astype(np.int64)
    w = rng.standard_normal(5000).astype(dtype)
    w[keys == 7] = 0  # a zero sum, dropped by the compact forms
    for g, x in zip(te.bincount_sum(keys, w, 300), jeager.bincount_sum(keys, w, 300)):
        _bits_equal(g, x)
    for g, x in zip(te.row_reduce_sorted(keys, w), jeager.row_reduce_sorted(keys, w)):
        _bits_equal(g, x)
    for k in (keys, keys.astype(np.int32)):
        for g, x in zip(te.sorted_reduce_compact(k, w), jeager.sorted_reduce_compact(k, w)):
            _bits_equal(g, x)
        for g, x in zip(te.bincount_sum_compact(k, w, 300), jeager.bincount_sum_compact(k, w, 300)):
            _bits_equal(g, x)
    assert 7 not in te.sorted_reduce_compact(keys, w)[0].tolist()


def test_unravel_uncompress_relinearize_splice_match_sparse_tpu():
    rng = np.random.default_rng(16)
    shape = (7, 11, 13)
    keys = np.sort(rng.choice(7 * 11 * 13, 300, replace=False)).astype(np.int64)
    _bits_equal(te.unravel(keys, shape), jeager.unravel(keys, shape))
    indptr = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 50))]).astype(np.int64)
    _bits_equal(te.uncompress_indptr(indptr, 50), jeager.uncompress_indptr(indptr, 50))
    indices = rng.integers(0, 40, int(indptr[-1])).astype(np.int32)
    lin = [(0, 1, 0, 40), (1, 1, 0, 1)]
    row, col = [(2, 8, 0, 1)], [(2, 1, 8, 1)]
    for g, w in zip(te.relinearize(indptr, indices, lin, row, col), jeager.relinearize(indptr, indices, lin, row, col)):
        _bits_equal(g, w)
    data = rng.standard_normal(int(indptr[-1]))
    picks = np.array([3, 0, 49, 3, 17])
    want = jeager.csr_row_splice(indptr, indices, data, picks)
    for g, w in zip(te.csr_row_splice(indptr, indices, data, picks), want):
        _bits_equal(g, w)


def test_canonical_functions_match_sparse_tpu(monkeypatch):
    monkeypatch.setattr(native, "NATIVE_MIN_SIZE", 0)
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << 40, 2000).astype(np.int64)
    # the packed sort (torch) and, past 63 bits, the library's radix sort
    for max_key in (None, (1 << 62) - 1):
        perm, sorted_keys = native.sort_with_perm(keys, max_key=max_key)
        want_perm, want_sorted = jnative.sort_with_perm(keys, max_key=max_key)
        _bits_equal(perm, want_perm)
        assert (sorted_keys is None) == (want_sorted is None)
        _bits_equal(native.argsort_i64(keys, max_key=max_key), jnative.argsort_i64(keys, max_key=max_key))
    assert native.CALLS["argsort_i64"] == 2
    sk = np.sort(rng.integers(0, 500, 3000)).astype(np.int64)
    v = rng.standard_normal(3000)
    for g, w in zip(native.dedup_sum_sorted(sk, v), jnative.dedup_sum_sorted(sk, v)):
        _bits_equal(g, w)
    _bits_equal(native.build_indptr(sk, 600), jnative.build_indptr(sk, 600))
    assert native.CALLS["build_indptr"] == 1 and native.CALLS["dedup_sum_sorted"] == 1


def test_pool_dispatch_stress_alternating_slot_counts():
    rng = np.random.default_rng(11)
    n = 1 << 19  # past the n >> 17 threading threshold
    keys_sorted = np.sort(rng.integers(0, 5000, n)).astype(np.int64)
    w = rng.standard_normal(n)
    keys_small = np.sort(rng.integers(0, 50, 1 << 18)).astype(np.int64)
    w_small = rng.standard_normal(1 << 18)
    firsts = {}
    for _ in range(10):
        for name, keys, weights, n_bins in (("big", keys_sorted, w, 5000), ("small", keys_small, w_small, 50)):
            exp = np.bincount(keys, weights=weights, minlength=n_bins)
            idx, vals = te.sorted_reduce_compact(keys, weights)
            dense = np.zeros(n_bins)
            dense[_np(idx)] = _np(vals)
            np.testing.assert_allclose(dense, exp, rtol=1e-12, atol=1e-12)
            first = firsts.setdefault(name, (idx, vals))
            assert torch.equal(first[0], idx) and torch.equal(first[1], vals)
            idx2, vals2 = te.bincount_sum_compact(keys, weights, n_bins)
            dense2 = np.zeros(n_bins)
            dense2[_np(idx2)] = _np(vals2)
            np.testing.assert_allclose(dense2, exp, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# devices, dtypes and the build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda t: te.union_join(t, t),
        lambda t: te.canonicalize2d(t, t, t.double(), 4),
        lambda t: te.csr_spmm_dense(torch.tensor([0, 1]), torch.tensor([0]), torch.ones(1).double(), t.double(), 1),
        lambda t: te.fused_join("add", t, t.double(), t, t.double()),
        lambda t: native.build_indptr(t, 3),
        lambda t: te.spgemm_csr(t, t, t.double(), t, t, t.double(), 1, 1),
    ],
)
def test_a_tensor_on_another_device_raises(call):
    with pytest.raises(ValueError, match="host library takes CPU tensors"):
        call(torch.zeros(3, dtype=torch.int64, device="meta"))
    assert sum(native.CALLS.values()) == 0


def test_other_value_dtypes_raise_typeerror():
    with pytest.raises(TypeError):
        te.canonicalize2d(torch.tensor([0]), torch.tensor([0]), torch.tensor([1], dtype=torch.int64), 1)
    with pytest.raises(TypeError):
        te.fused_join("add", torch.tensor([0]), torch.tensor([1.0]).double(), torch.tensor([0]), torch.tensor([1.0]))
    with pytest.raises(ValueError):
        te.fused_join("divide", torch.tensor([0]), torch.tensor([1.0]), torch.tensor([0]), torch.tensor([1.0]))


def test_the_build_is_one_fixed_command():
    assert native.GXX_FLAGS == ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]
    assert not any("march" in f for f in native.GXX_FLAGS)
    lib = native.library()
    path = native.BUILD_INFO["path"]
    assert path.startswith(str(native._BUILD_DIR)) and "sparse_tpu/native" not in path
    assert lib is native.library()
    assert all(src.parent.name == "csrc" and src.parent.parent.name == "native" for src in native.SOURCES)


def test_a_missing_gxx_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        te.union_join(torch.tensor([1]), torch.tensor([2]))
    # a call site on the host route raises too: nothing falls back
    monkeypatch.setattr(te, "NATIVE_MIN_PRODUCT_NNZ", 0)
    a = st.COO.from_numpy(np.eye(3), device=CPU)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        a @ torch.ones(3, dtype=torch.float64)


def test_a_failing_gxx_raises_with_its_output(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "GXX_FLAGS", [*native.GXX_FLAGS, "-fno-such-option-anywhere"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*no-such-option-anywhere"):
        native.library()


def test_counters_reset_with_the_launch_counters():
    te.union_join(torch.tensor([1]), torch.tensor([2]))
    assert native.CALLS["union_join"] == 1
    _cuda.reset_launch_counts()
    assert sum(native.CALLS.values()) == 0


# ---------------------------------------------------------------------------
# row 1: the COO constructor
# ---------------------------------------------------------------------------


def _triplet(n, shape, seed, dtype):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, s, n) for s in shape])
    vals = rng.standard_normal(n).astype(dtype)
    vals[::7] = -0.0
    return coords, vals


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("idx_dtype", [np.int64, np.int32, np.uint8])
def test_coo_canonicalization_on_both_routes(route, dtype, idx_dtype):
    coords, vals = _triplet(3000, (50, 60), 22, dtype)
    coords = coords.astype(idx_dtype)
    t = st.COO(coords, vals, shape=(50, 60), device=CPU)
    _check_route(route, "canonicalize2d")
    j = jsp.COO(coords, vals, shape=(50, 60))
    _same_coo(t, j)
    assert t.coords.dtype == torch.from_numpy(np.asarray(j.coords)).dtype


@pytest.mark.parametrize("dtype", FLOATS)
def test_coo_canonicalization_routes_agree_bit_for_bit(dtype, monkeypatch):
    coords, vals = _triplet(5000, (64, 64), 23, dtype)
    outs = []
    for low in (0, 10**15):
        monkeypatch.setattr(native, "NATIVE_MIN_SIZE", low)
        outs.append(st.COO(coords, vals, shape=(64, 64), device=CPU))
    assert torch.equal(outs[0].coords, outs[1].coords)
    _bits_equal(outs[0].data, _np(outs[1].data))


@pytest.mark.parametrize("dtype", FLOATS)
def test_nd_and_sorted_coo_take_the_sort_and_the_duplicate_sum(route, dtype):
    # sparse_tpu sums float32 duplicates by NumPy's pairwise reduceat, the
    # port in entry order (ROADMAP §C2): float32 at rtol 1e-5
    rtol = None if dtype == np.float64 else TOL[dtype]
    coords, vals = _triplet(4000, (9, 10, 11), 24, dtype)
    t = st.COO(coords, vals, shape=(9, 10, 11), device=CPU)
    _same_coo(t, jsp.COO(coords, vals, shape=(9, 10, 11)), rtol)
    # sorted with duplicates: the float64 duplicate sum alone
    native.reset_calls()
    order = np.lexsort(coords[::-1])
    s = st.COO(coords[:, order], vals[order], shape=(9, 10, 11), sorted=True, device=CPU)
    _same_coo(s, jsp.COO(coords[:, order], vals[order], shape=(9, 10, 11), sorted=True), rtol)
    if dtype == np.float64:
        _check_route(route, "dedup_sum_sorted")
    else:
        assert native.CALLS["dedup_sum_sorted"] == 0  # float64 only, as in sparse_tpu


def test_other_dtypes_keep_the_torch_route(route):
    coords, vals = _triplet(3000, (50, 60), 25, np.float64)
    for dt in (np.int64, np.float16, np.complex128):
        st.COO(coords, (vals * 4).astype(dt), shape=(50, 60), device=CPU)
    assert sum(native.CALLS.values()) == 0


SIGNED_ZERO_CASES = {
    "plus_minus": ([[0, 0, 1, 1]], [-0.0, 0.0, 0.0, -0.0]),
    "minus_run": ([[2, 2, 2, 0]], [-0.0, -0.0, -0.0, 1.0]),
    "two_d": ([[0, 0, 1, 1, 0], [2, 2, 0, 1, 1]], [-0.0, -0.0, -0.0, 1.0, -0.0]),
}


@pytest.mark.parametrize("case", sorted(SIGNED_ZERO_CASES))
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("prune", [False, True])
def test_duplicate_sums_keep_the_sign_of_zero(route, case, dtype, prune):
    # tests/test_torch_coo.py's rule, on both CPU routes
    coords, vals = SIGNED_ZERO_CASES[case]
    coords, data = np.array(coords), np.array(vals, dtype=dtype)
    shape = tuple(int(c.max()) + 1 for c in coords)
    t = st.COO(coords, data, shape=shape, prune=prune, device=CPU)
    j = jsp.COO(coords, data, shape=shape, prune=prune)
    if len(shape) == 2:
        _check_route(route, "canonicalize2d")
    _same_coo(t, j)
    _bits_equal(t.todense(), np.asarray(j.todense()))


# ---------------------------------------------------------------------------
# row 2: sparse × dense products
# ---------------------------------------------------------------------------

PRODUCT_CALLS = ("csr_spmm_dense", "csc_spmm_dense", "coo_spmv_entries", "spmv_add", "dense_spmm_csrt")


def _formats(x, fmt):
    a = st.COO.from_numpy(x, device=CPU)
    j = jsp.COO.from_numpy(x)
    if fmt == "coo":
        return a, j
    if fmt == "gcxs":
        return st.GCXS.from_numpy(x, compressed_axes=(1,), device=CPU), jsp.GCXS.from_numpy(x, compressed_axes=(1,))
    return a.asformat(fmt), j.asformat(fmt)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("fmt", ["coo", "gcxs", "csr", "csc"])
def test_spmm_dense_on_both_routes(route, fmt, dtype):
    rng = np.random.default_rng(11)
    x = _dense((37, 29), 0.25, 11, dtype)
    a, j = _formats(x, fmt)
    d, v = rng.random((29, 5)).astype(dtype), rng.random(29).astype(dtype)
    left = rng.random((6, 37)).astype(dtype)
    native.reset_calls()
    for got, want in ((a @ d, j @ d), (a @ v, j @ v), (torch.as_tensor(left) @ a, left @ j)):
        assert got.dtype == torch.from_numpy(np.empty(0, dtype)).dtype
        _close(got, want, dtype)
    _close(st.matvec_add(a, v, np.ones(37, dtype)), jsp.matvec_add(j, v, np.ones(37, dtype)), dtype)
    _check_route(route, *PRODUCT_CALLS)


@pytest.mark.parametrize("dtype", FLOATS)
def test_host_products_of_a_gcxs_have_the_coos_bits(dtype, monkeypatch):
    monkeypatch.setattr(te, "NATIVE_MIN_PRODUCT_NNZ", 0)
    x = _dense((50, 40), 0.2, 12, dtype)
    b = np.random.default_rng(13).standard_normal((40, 7)).astype(dtype)
    coo = st.COO.from_numpy(x, device=CPU)
    for fmt in ("csr", "csc", "gcxs"):
        a = _formats(x, fmt)[0]
        assert torch.equal(a @ b, coo @ b) and torch.equal(a @ b[:, 0], coo @ b[:, 0])


def test_layout_kept_and_out1_equals_out2(route):
    # tests/test_torch_dot.py's layout-reuse rule on both routes: the host
    # route keeps the row indptr, the torch route the row-ELL layout
    x = _dense((64, 64), 0.1, 10)
    t = st.COO.from_numpy(x, device=CPU)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((64, 8)))
    out1 = t @ b
    kept = t.peek_layout("host_indptr", None)
    assert (kept is not None) == (route == "host")
    out2 = t @ b
    assert torch.equal(out1, out2)
    if route == "host":
        assert t.peek_layout("host_indptr", None) is kept
    _check_route(route, "csr_spmm_dense")


@pytest.mark.parametrize("m_rows", [1, 2, 3, 4, 32])
def test_dense_at_sparse_all_row_counts(route, m_rows):
    rng = np.random.default_rng(m_rows)
    k, n = 120, 90
    s = st.random((k, n), density=0.07, random_state=m_rows, device=CPU)
    dense = s.todense().numpy()
    x = rng.standard_normal((m_rows, k))
    got = torch.as_tensor(x) @ s
    np.testing.assert_allclose(got.numpy(), x @ dense, rtol=1e-12, atol=1e-12)
    if m_rows > 1:
        # dense_spmm_csrt, the CSC scatter and the CSR SpMM of the
        # transpose add each output entry from 0 in one order
        assert torch.equal(got, (s.T @ torch.as_tensor(x).T).T)
    _check_route(route, *PRODUCT_CALLS)


def test_dense_at_sparse_keeps_the_csc_buffers(monkeypatch):
    monkeypatch.setattr(te, "NATIVE_MIN_PRODUCT_NNZ", 0)
    rng = np.random.default_rng(5)
    s = st.random((150, 60), density=0.1, random_state=5, device=CPU)
    x = torch.as_tensor(rng.standard_normal((8, 150)))
    first = x @ s
    kept = s.peek_layout("host_csc", None)
    assert kept is not None and native.CALLS["transpose2d"] == 1
    xv = torch.as_tensor(rng.standard_normal((2, 150)))
    np.testing.assert_allclose((xv @ s).numpy(), xv.numpy() @ s.todense().numpy(), rtol=1e-12)
    assert native.CALLS["transpose2d"] == 1 and native.CALLS["dense_spmm_csrt"] == 2  # two rows: the kept CSC
    assert torch.equal(first, x @ s)


def test_dense_times_sparse_equals_the_transposed_product(route):
    # tests/test_torch_matmul.py's rule on both routes
    x = _dense((40, 30), 0.1, 5)
    t = st.COO.from_numpy(x, device=CPU)
    w = torch.as_tensor(_dense((8, 40), 1.0, 6))
    first = w @ t
    assert torch.equal(first, w @ t) and torch.equal(first, (t.T @ w.T).T)
    _check_route(route, "dense_spmm_csrt")


def test_spmm_dense_nan_inf_semantics(route):
    x = np.array([[np.inf, 0.0], [1.0, np.nan]])
    a = st.COO.from_numpy(x, device=CPU)
    d = np.array([[0.0, 1.0], [2.0, 3.0]])
    with np.errstate(invalid="ignore"):
        expected = x @ d
    with pytest.warns(RuntimeWarning, match="Nan will not be propagated"):
        got = (a @ d).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expected))
    np.testing.assert_allclose(got[~np.isnan(got)], expected[~np.isnan(expected)])


@pytest.mark.parametrize("fmt,ca", [("gcxs", (0,)), ("gcxs", (1,)), ("coo", None)])
@pytest.mark.parametrize("regime", ["sparse_rows", "dense_rows"])
def test_matvec_add_fused_and_entry_paths(route, fmt, ca, regime):
    rng = np.random.default_rng(3)
    shape, density = ((8000, 9000), 1e-5) if regime == "sparse_rows" else ((800, 900), 5e-2)
    kw = {"compressed_axes": ca} if ca else {}
    m = st.random(shape, density=density, random_state=5, format=fmt, device=CPU, **kw)
    sm = sps.csr_array(m.to_scipy_sparse())
    x, y = rng.standard_normal(shape[1]), rng.standard_normal(shape[0])
    for _ in range(2):
        np.testing.assert_allclose((m @ x).numpy(), sm @ x, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(st.matvec_add(m, x, y).numpy(), sm @ x + y, rtol=1e-10)
    _check_route(route, "coo_spmv_entries" if regime == "sparse_rows" else "spmv_add")
    m32 = m.astype(np.float32)
    got32 = st.matvec_add(m32, x.astype(np.float32), y.astype(np.float32)).numpy()
    np.testing.assert_allclose(got32, (sm @ x + y).astype(np.float32), rtol=1e-3, atol=1e-3)


def test_matvec_add_semantics_match_expression(route):
    rng = np.random.default_rng(4)
    m = st.random((500, 400), density=0.01, random_state=9, device=CPU)
    x, y = rng.standard_normal(400), rng.standard_normal(500)
    bad = st.COO(m.coords, m.data, shape=m.shape, fill_value=1.0, device=CPU)
    with pytest.raises(ValueError):
        st.matvec_add(bad, x, y)
    xn = x.copy()
    xn[3] = np.nan
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        st.matvec_add(m, xn, y)
    assert sum("Nan will not be propagated" in str(r.message) for r in rec) == 1
    native.reset_calls()
    mi = st.COO(m.coords, torch.ones(m.nnz, dtype=torch.int64), shape=m.shape, device=CPU)
    xi, yi = np.ones(400, dtype=np.int64), np.arange(500)
    np.testing.assert_array_equal(st.matvec_add(mi, xi, yi).numpy(), (mi @ xi).numpy() + yi)
    assert sum(native.CALLS.values()) == 0  # integers keep the torch ops


# ---------------------------------------------------------------------------
# row 3: the element-wise union
# ---------------------------------------------------------------------------

UNION_CALLS = ("fused_join_2d", "fused_join", "union_join_values", "union_join")


@pytest.mark.parametrize("op", [np.add, np.subtract, np.multiply])
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("shape", [(17, 23, 5), (60, 70)])
def test_elemwise_on_both_routes(route, op, dtype, shape):
    rng = np.random.default_rng(3)
    d1 = (rng.random(shape) * (rng.random(shape) < 0.3)).astype(dtype)
    d2 = (rng.random(shape) * (rng.random(shape) < 0.3)).astype(dtype)
    d1.flat[::5] = -d2.flat[::5]  # cancellations: +0.0 sums, pruned
    t1, t2 = st.COO.from_numpy(d1, device=CPU), st.COO.from_numpy(d2, device=CPU)
    got = op(t1, t2)
    _check_route(route, "fused_join_2d" if len(shape) == 2 else "fused_join")
    _same_coo(got, op(jsp.COO.from_numpy(d1), jsp.COO.from_numpy(d2)))


def test_elemwise_union_join_routes(route):
    rng = np.random.default_rng(4)
    d1 = rng.random((40, 40)) * (rng.random((40, 40)) < 0.2)
    d2 = rng.random((40, 40)) * (rng.random((40, 40)) < 0.2)
    t1, t2 = st.COO.from_numpy(d1, device=CPU), st.COO.from_numpy(d2, device=CPU)
    j1, j2 = jsp.COO.from_numpy(d1), jsp.COO.from_numpy(d2)
    _same_coo(np.maximum(t1, t2), np.maximum(j1, j2))
    _same_coo(t1 > t2, j1 > j2)
    _check_route(route, "union_join_values")
    # two float dtypes: the keys-only join
    native.reset_calls()
    t3, j3 = st.COO.from_numpy(d2.astype(np.float32), device=CPU), jsp.COO.from_numpy(d2.astype(np.float32))
    _same_coo(t1 + t3, j1 + j3)
    _check_route(route, "union_join")


def test_elemwise_nonzero_fill_takes_the_union(route):
    d1 = np.full((90, 90), 2.0)
    d1[0, 0] = 5.0
    d2 = np.full((90, 90), 3.0)
    d2[1, 1] = 7.0
    d1[::3, ::2] = 0.5
    t1 = st.COO.from_numpy(d1, fill_value=2.0, device=CPU)
    t2 = st.COO.from_numpy(d2, fill_value=3.0, device=CPU)
    res = t1 + t2
    assert res.fill_value == 5.0
    np.testing.assert_array_equal(res.todense().numpy(), d1 + d2)
    if route == "host":
        assert native.CALLS["union_join_values"] == 1 and native.CALLS["fused_join_2d"] == 0
    else:
        assert sum(native.CALLS.values()) == 0


@pytest.mark.parametrize("op", [np.add, np.subtract, np.multiply])
def test_gcxs_elemwise(route, op):
    rng = np.random.default_rng(41)
    for axes in [(0,), (1,), (0, 2)]:
        ndim = max(axes) + 2
        shape = tuple(int(s) for s in rng.integers(3, 9, ndim))
        d1 = rng.random(shape) * (rng.random(shape) < 0.4)
        d2 = rng.random(shape) * (rng.random(shape) < 0.4)
        g1 = st.GCXS.from_numpy(d1, compressed_axes=axes, device=CPU)
        g2 = st.GCXS.from_numpy(d2, compressed_axes=axes, device=CPU)
        r = op(g1, g2)
        assert isinstance(r, st.GCXS) and r.compressed_axes == axes
        j1, j2 = (jsp.GCXS.from_numpy(d, compressed_axes=axes) for d in (d1, d2))
        _same_coo(r.tocoo(), op(j1, j2).tocoo())
    _check_route(route, *UNION_CALLS)


def test_gcxs_elemwise_mixed_axes(route):
    rng = np.random.default_rng(42)
    d1 = rng.random((120, 100)) * (rng.random((120, 100)) < 0.4)
    d2 = rng.random((120, 100)) * (rng.random((120, 100)) < 0.4)
    c1 = st.GCXS.from_numpy(d1, compressed_axes=(0,), device=CPU)
    c2 = st.GCXS.from_numpy(d2, compressed_axes=(1,), device=CPU)
    native.reset_calls()
    got = c1 + c2
    np.testing.assert_array_equal(got.todense().numpy(), d1 + d2)
    _same_coo(got.tocoo(), (jsp.GCXS.from_numpy(d1, compressed_axes=(0,)) + jsp.GCXS.from_numpy(d2)).tocoo())
    _check_route(route, "fused_join_2d")


def test_elemwise_other_dtypes_keep_the_torch_ops(route):
    rng = np.random.default_rng(43)
    d1 = (rng.integers(0, 3, (50, 50)) * (rng.random((50, 50)) < 0.3)).astype(np.int64)
    t1, t2 = st.COO.from_numpy(d1, device=CPU), st.COO.from_numpy(d1.T.copy(), device=CPU)
    _same_coo(t1 + t2, jsp.COO.from_numpy(d1) + jsp.COO.from_numpy(d1.T.copy()))
    j1, j2 = (jsp.COO.from_numpy(d).astype(np.float16) for d in (d1, d1.T.copy()))
    _same_coo(t1.astype(np.float16) * t2.astype(np.float16), j1 * j2)
    assert sum(native.CALLS.values()) == 0


# ---------------------------------------------------------------------------
# row 4: SpGEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_spgemm_on_both_routes(route, fmt, dtype):
    x, y = _dense((200, 180), 0.08, 19, dtype), _dense((180, 150), 0.08, 20, dtype)
    (ta, ja), (tb, jb) = _formats(x, fmt), _formats(y, fmt)
    got, want = ta @ tb, ja @ jb
    assert type(got).__name__ == type(want).__name__
    _same_coo(got.tocoo() if fmt != "coo" else got, want.tocoo() if fmt != "coo" else want)
    _check_route(route, "spgemm_csr")


def test_spgemm_routes_agree_bit_for_bit(monkeypatch):
    x, y = _dense((120, 100), 0.1, 21), _dense((100, 90), 0.1, 22)
    outs = []
    for low in (0, 10**15):
        monkeypatch.setattr(te, "NATIVE_MIN_NNZ", low)
        ta, tb = st.COO.from_numpy(x, device=CPU), st.COO.from_numpy(y, device=CPU)
        outs.append(ta @ tb)
    assert torch.equal(outs[0].coords, outs[1].coords)
    _bits_equal(outs[0].data, _np(outs[1].data))


def test_negative_zero_rule(route):
    # tests/test_torch_spgemm.py's rule on both routes: a -0.0 sum is dropped
    n = 6
    x = np.zeros((n, n))
    x[np.arange(n), np.arange(n)] = np.arange(1, n + 1)
    x[0, 0] = -1.0
    coords = np.stack([np.arange(n), np.arange(n)])
    data = np.where(np.arange(n) == 0, 0.0, 2.0)
    ta, tb = st.COO.from_numpy(x, device=CPU), st.COO(coords, data, shape=(n, n), device=CPU)
    got = ta @ tb
    assert got.nnz == 5 and not bool(torch.signbit(got.data).any())
    _same_coo(got, jsp.COO.from_numpy(x) @ jsp.COO(coords, data, shape=(n, n)))
    _check_route(route, "spgemm_csr")


def test_spgemm_prunes_computed_zeros(route):
    ta = st.COO.from_numpy(np.array([[1.0, -1.0]]), device=CPU)
    tb = st.COO.from_numpy(np.array([[1.0], [1.0]]), device=CPU)
    c = ta @ tb
    assert c.nnz == 0 and float(c.todense()[0, 0]) == 0.0
    _check_route(route, "spgemm_csr")


def test_spgemm_other_dtypes_keep_the_torch_ops(route):
    x = (_dense((60, 50), 0.2, 23) * 4).astype(np.int64)
    ta = st.COO.from_numpy(x, device=CPU)
    _same_coo(ta @ ta.T, jsp.COO.from_numpy(x) @ jsp.COO.from_numpy(x).T)
    assert native.CALLS["spgemm_csr"] == 0


# ---------------------------------------------------------------------------
# row 5, the part ported: the 2-D transpose and the GCXS compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64, np.uint16])
def test_coo_transpose_on_both_routes(route, dtype, idx_dtype):
    s = st.random((300, 317), density=0.05, random_state=3, device=CPU).astype(dtype)
    s = st.COO(s.coords.numpy().astype(idx_dtype), s.data, shape=s.shape, sorted=True, has_duplicates=False, device=CPU)
    native.reset_calls()
    t = s.T
    _check_route(route, "transpose2d")
    coords = s.coords.numpy().astype(idx_dtype)
    ref = jsp.COO(coords, s.data.numpy(), shape=s.shape, sorted=True, has_duplicates=False).T
    _same_coo(t, ref)
    assert t.coords.dtype == s.coords.dtype
    assert torch.equal(t.todense(), s.todense().T)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.float16])
@pytest.mark.parametrize("axes", [(1,), (2,), (1, 2), (0,), (0, 1)])
def test_gcxs_compression_matches_sparse_tpu(dtype, axes):
    # sparse_tpu compresses float32/float64 by the counting scatter at any
    # size; the port too, and other dtypes by its stable sort
    x = (_dense((6, 7, 8), 0.3, 44) * 8).astype(dtype)
    g = st.GCXS.from_numpy(x, compressed_axes=axes, device=CPU)
    j = jsp.GCXS.from_numpy(x, compressed_axes=axes)
    for name in ("indptr", "indices", "data"):
        _bits_equal(getattr(g, name), np.asarray(getattr(j, name)).astype(getattr(g, name).numpy().dtype))
    moved = native.CALLS["transpose2d"]
    if axes == tuple(range(len(axes))) or dtype not in FLOATS:
        assert moved == 0  # leading axes are in order already; other dtypes keep the torch ops
    else:
        assert moved == 1
    csc = st.COO.from_numpy(x[0], device=CPU).asformat("csc")
    np.testing.assert_array_equal(csc.todense().numpy(), x[0])


@pytest.mark.parametrize("dtype", FLOATS)
def test_tocsr_tocsc_match_scipy(dtype):
    s = st.random((83, 71), density=0.08, random_state=11, device=CPU).astype(dtype)
    ref = sps.coo_matrix((s.data.numpy(), tuple(s.coords.numpy())), shape=s.shape)
    native.reset_calls()
    csr, csc = s.tocsr(), s.tocsc()
    assert native.CALLS["transpose2d"] == 1  # the CSC by the counting scatter
    assert sps.issparse(csr) and csr.format == "csr" and sps.issparse(csc) and csc.format == "csc"
    assert (csr != ref.tocsr()).nnz == 0 and (csc != ref.tocsc()).nnz == 0
    np.testing.assert_array_equal(csc.toarray(), s.todense().numpy())


def test_tocsr_nonzero_fill_raises():
    s = st.COO.from_numpy(np.arange(6.0).reshape(2, 3), fill_value=1.0, device=CPU)
    with pytest.raises(ValueError):
        s.tocsr()
    assert sum(native.CALLS.values()) == 0


def test_other_dtypes_transpose_on_the_torch_ops(route):
    s = (st.random((200, 210), density=0.2, random_state=4, device=CPU) * 8).astype(np.int64)
    native.reset_calls()
    _same_coo(s.T, jsp.COO(s.coords.numpy(), s.data.numpy(), shape=s.shape).T)
    assert native.CALLS["transpose2d"] == 0


# ---------------------------------------------------------------------------
# row 5, the rest: reductions, reshape, GCXS restructuring and row picks
# ---------------------------------------------------------------------------


def _sum_pair(x, fill, axis, dtype):
    t = st.COO.from_numpy(x, fill_value=dtype(fill), device=CPU)
    j = jsp.COO.from_numpy(x, fill_value=dtype(fill))
    return t.sum(axis=axis), j.sum(axis=axis)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize(
    "shape,axis,fill,fn",
    [
        ((300, 200), 1, 0.0, "sorted_reduce_compact"),  # leading kept axis, zero fill
        ((300, 200), 0, 0.0, "bincount_sum_compact"),
        ((20, 30, 40), (0, 2), 0.0, "bincount_sum_compact"),
        ((20, 30, 40), 2, 0.0, "sorted_reduce_compact"),
        ((300, 200), 0, 1.5, "bincount_sum"),  # another fill
        ((300, 200), 1, 1.5, "row_reduce_sorted"),
        ((3000, 3000), 0, 0.0, "bincount_sum_compact"),
    ],
)
def test_coo_sums_match_sparse_tpus_host_route(dtype, shape, axis, fill, fn):
    x = _dense(shape, 0.02 if shape[0] == 3000 else 0.3, 45, dtype)
    if fill:
        x = np.where(x == 0, dtype(fill), x)
    x.flat[::11] = -x.flat[::11]  # sums near zero, some exactly zero
    got, want = _sum_pair(x, fill, axis, dtype)
    assert native.CALLS[fn] == 1, dict(native.CALLS)
    _same_coo(got, want)
    assert got.fill_value == want.fill_value


def test_coo_sums_of_other_dtypes_and_reductions_keep_the_torch_ops():
    x = (_dense((60, 50), 0.3, 46) * 8).astype(np.int64)
    got, want = _sum_pair(x, 0, 0, np.int64)
    _same_coo(got, want)
    t = st.COO.from_numpy(_dense((60, 50), 0.3, 47), device=CPU)
    t.max(axis=0)
    t.sum(axis=0, dtype=np.float32)
    assert sum(native.CALLS.values()) == 0


@pytest.mark.parametrize("dtype", FLOATS)
def test_gcxs_sum_over_the_compressed_axes_is_sparse_tpus_bincount(dtype):
    x = _dense((120, 90), 0.2, 48, dtype)
    for fmt, axis in (("csr", 0), ("csc", 1)):
        t, j = _formats(x, fmt)
        native.reset_calls()
        got, want = t.sum(axis=axis), j.sum(axis=axis)
        assert native.CALLS["bincount_sum"] == 1
        _same_coo(got.tocoo(), want.tocoo())


@pytest.mark.parametrize("dtype", FLOATS + [np.int64])
def test_gcxs_restructuring_matches_sparse_tpu(dtype):
    x = (_dense((6, 8, 10), 0.3, 49) * 8).astype(dtype)
    t = st.GCXS.from_numpy(x, compressed_axes=(0,), device=CPU)
    j = jsp.GCXS.from_numpy(x, compressed_axes=(0,))
    cases = [
        lambda g: g.change_compressed_axes((2,)),  # a row-key scatter
        lambda g: g.change_compressed_axes((1, 2)),
        lambda g: g.transpose((2, 0, 1)),  # a full re-sort
        lambda g: g.reshape((48, 10)),  # C order kept
        lambda g: g.reshape((10, 48), compressed_axes=(1,)),
    ]
    for make in cases:
        native.reset_calls()
        got, want = make(t), make(j)
        for name in ("indptr", "indices", "data"):
            _bits_equal(getattr(got, name), np.asarray(getattr(want, name)).astype(getattr(got, name).numpy().dtype))
        assert got.shape == want.shape and got.compressed_axes == want.compressed_axes
        assert (native.CALLS["relinearize"] == 1) == (dtype in FLOATS), dict(native.CALLS)


@pytest.mark.parametrize("dtype", FLOATS + [np.int64])
def test_gcxs_row_picks_splice_as_sparse_tpu(dtype):
    x = (_dense((50, 40), 0.3, 50) * 8).astype(dtype)
    for fmt in ("csr", "csc"):
        t, j = _formats(x, fmt)
        picks = [7, 0, 7, 39, 3]
        index = (picks,) if fmt == "csr" else (slice(None), picks)
        native.reset_calls()
        got, want = t[index], j[index]
        assert (native.CALLS["csr_row_splice"] == 1) == (dtype in FLOATS)
        for name in ("indptr", "indices", "data"):
            _bits_equal(getattr(got, name), np.asarray(getattr(want, name)).astype(getattr(got, name).numpy().dtype))


@pytest.mark.parametrize("dtype", FLOATS)
def test_coo_reshape_unravels_on_both_routes(route, dtype):
    x = _dense((64, 30, 20), 0.3, 51, dtype)
    t, j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    native.reset_calls()
    for shape in ((640, 60), (8, 8, 600), (38400,)):
        got, want = t.reshape(shape), j.reshape(shape)
        np.testing.assert_array_equal(_np(got.coords).astype(np.int64), np.asarray(want.coords).astype(np.int64))
        _bits_equal(got.data, np.asarray(want.data))
    _check_route(route, "unravel")
