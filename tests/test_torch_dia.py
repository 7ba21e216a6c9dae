"""The port's banded (DIA) layout and its products against sparse_tpu's (CPU).

Counterparts of tests/test_dia.py, minus its two sharded tests (the
multi-device layer is not ported). ``build_dia`` equals the JAX package's
array for array; ``dia_spmv``/``dia_spmm`` agree at rtol 1e-12 (float64)
and 1e-6 (float32): the two add the same rounded products in the same
offset order. Solutions agree at rtol 1e-8 of their largest entry (the two
packages sum the inner products in other orders), with equal ``info`` and
iteration counts. The route tests read the layouts cached on the operand
(``peek_layout``).
"""

import numpy as np
import pytest
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu.kernels import build_dia as j_build_dia
from sparse_tpu.kernels import dia_spmm as j_dia_spmm
from sparse_tpu.kernels import dia_spmv as j_dia_spmv
from sparse_tpu_torch import linalg
from sparse_tpu_torch.interop import coo_from_arrays, dia_from_arrays, gcxs_from_arrays
from sparse_tpu_torch.kernels import DiaMatrix, LAUNCHES, _cuda, build_dia, dia_spmm, dia_spmv, reset_launch_counts
from sparse_tpu_torch.kernels import dia as tdia
from sparse_tpu_torch.kernels.row_ell import row_ell_cache_key

CPU = "cpu"
RTOL = {np.float64: 1e-12, np.float32: 1e-6}
DIA_KEY = (64, 8.0)


def _banded_dense(n, offsets, rng, dtype=np.float64):
    dense = np.zeros((n, n), dtype=dtype)
    for o in offsets:
        idx = np.arange(max(0, -o), min(n, n - o))
        dense[idx, idx + o] = rng.standard_normal(idx.size)
    return dense


def _both(dense):
    j = sparse.COO.from_numpy(dense)
    t = coo_from_arrays(np.asarray(j.coords), np.asarray(j.data), j.shape, device=CPU)
    return j, t


def _laplacian(m):
    lap = np.zeros((m * m, m * m))
    for i in range(m):
        for j in range(m):
            k = i * m + j
            lap[k, k] = 4
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < m and 0 <= jj < m:
                    lap[k, ii * m + jj] = -1
    return lap


def _close(got, want, rtol=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


def _same_layout(t, j):
    assert t.offsets == j.offsets and all(type(o) is int for o in t.offsets)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.bands.numpy(), np.asarray(j.bands))
    assert t.bands.numpy().dtype == np.asarray(j.bands).dtype


OFFSET_SETS = [(-7, -1, 0, 1, 7), (0,), (-2, 3), (-50, 0, 50), (-150, 150), (5,)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_build_dia_equals_sparse_tpu(offsets, dtype):
    rng = np.random.default_rng(sum(offsets) + 400 + len(offsets))
    n = 200
    dense = _banded_dense(n, offsets, rng, dtype)
    j, t = _both(dense)
    cj = np.asarray(j.coords)
    want = j_build_dia(cj[0], cj[1], np.asarray(j.data), n)
    got = build_dia(t.coords[0], t.coords[1], t.data, n)
    assert want is not None and isinstance(got, DiaMatrix)
    _same_layout(got, want)
    # NumPy input builds on the device asked for
    _same_layout(build_dia(cj[0], cj[1], np.asarray(j.data), n, device=CPU), want)
    _same_layout(t.to_dia(), j.to_dia())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_dia_products_match_sparse_tpu(offsets, dtype):
    rng = np.random.default_rng(len(offsets) * 11 + 3)
    n = 200
    dense = _banded_dense(n, offsets, rng, dtype)
    j, _ = _both(dense)
    jd = j.to_dia()
    td = dia_from_arrays(jd.offsets, jd.bands, jd.shape, device=CPU)
    x = rng.standard_normal(n).astype(dtype)
    X = rng.standard_normal((n, 4)).astype(dtype)
    got_v = dia_spmv(td.offsets, td.bands, torch.from_numpy(x))
    got_m = dia_spmm(td.offsets, td.bands, torch.from_numpy(X))
    assert got_v.dtype == torch.from_numpy(x).dtype and got_m.shape == (n, 4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(j_dia_spmv(jd.offsets, jd.bands, x)), rtol=RTOL[dtype], atol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(j_dia_spmm(jd.offsets, jd.bands, X)), rtol=RTOL[dtype], atol=0)
    np.testing.assert_allclose(got_v.numpy(), dense.astype(np.float64) @ x, rtol=RTOL[dtype] * 100, atol=RTOL[dtype])


def test_dia_products_promote_like_numpy():
    rng = np.random.default_rng(1)
    dense = _banded_dense(50, (-1, 0, 2), rng, np.float32)
    jd = sparse.COO.from_numpy(dense).to_dia()
    td = dia_from_arrays(jd.offsets, jd.bands, jd.shape, device=CPU)
    x = rng.standard_normal(50)  # float64
    got = dia_spmv(td.offsets, td.bands, torch.from_numpy(x))
    want = np.asarray(j_dia_spmv(jd.offsets, jd.bands, x))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match="meta"):
        dia_spmv(td.offsets, td.bands, torch.empty(50, device="meta"))
    with pytest.raises(ValueError, match="does not fit"):
        dia_spmv(td.offsets, td.bands, torch.zeros(49, dtype=torch.float64))


def test_dia_rejects_unstructured():
    B = sparse.random((100, 100), density=0.2, random_state=1)
    cb = np.asarray(B.coords)
    assert j_build_dia(cb[0], cb[1], np.asarray(B.data), 100) is None
    assert build_dia(cb[0], cb[1], np.asarray(B.data), 100, device=CPU) is None
    t = coo_from_arrays(cb, np.asarray(B.data), B.shape, device=CPU)
    assert B.to_dia() is None and t.to_dia() is None


def test_dia_rejects_padding_blowup_and_empty():
    # two far-apart diagonals with only a few entries each: k*n >> nnz
    n = 10_000
    rows = np.array([0, 1, 2, 5000, 5001])
    cols = np.array([0, 1, 2, 9000, 9001])
    data = np.ones(5)
    assert j_build_dia(rows, cols, data, n) is None
    assert build_dia(rows, cols, data, n, device=CPU) is None
    # the limits are parameters: a looser fill ratio accepts the same matrix
    want = j_build_dia(rows, cols, data, n, max_fill=10_000.0)
    _same_layout(build_dia(rows, cols, data, n, max_fill=10_000.0, device=CPU), want)
    # more diagonals than max_bands
    assert j_build_dia(rows, cols, data, n, max_bands=1, max_fill=1e9) is None
    assert build_dia(rows, cols, data, n, max_bands=1, max_fill=1e9, device=CPU) is None
    assert build_dia(rows[:0], cols[:0], data[:0], n, device=CPU) is None


def test_to_dia_not_square_or_nonzero_fill():
    rect = coo_from_arrays(np.array([[0, 1], [0, 1]]), np.array([1.0, 2.0]), (3, 4), device=CPU)
    assert rect.to_dia() is None
    nz = coo_from_arrays(np.array([[0, 1], [0, 1]]), np.array([1.0, 2.0]), (3, 3), fill_value=1.0, device=CPU)
    jnz = sparse.COO(np.array([[0, 1], [0, 1]]), np.array([1.0, 2.0]), shape=(3, 3), fill_value=1.0)
    with pytest.raises(ValueError, match="zero fill"):
        jnz.to_dia()
    with pytest.raises(ValueError, match="zero fill"):
        nz.to_dia()


def test_to_dia_cached_and_rebuilt_after_data_replaced():
    rng = np.random.default_rng(2)
    dense = _banded_dense(64, (-1, 0, 1), rng)
    j, t = _both(dense)
    d1 = t.to_dia()
    assert t.to_dia() is d1 and t.peek_layout("dia", DIA_KEY) is d1  # memoized on the instance
    t.data = t.data * 2.0
    assert t.peek_layout("dia", DIA_KEY) is None  # the entry's buffers were replaced
    d2 = t.to_dia()
    assert d2 is not d1
    np.testing.assert_array_equal(d2.bands.numpy(), 2 * np.asarray(j.to_dia().bands))


def test_cg_uses_dia_on_laplacian():
    rng = np.random.default_rng(3)
    lap = _laplacian(24)
    j, t = _both(lap)
    b = rng.standard_normal(lap.shape[0])
    xj, infoj, itj = jlinalg.cg(j, b, tol=1e-10, return_iters=True)
    x, info, it = linalg.cg(t, b, tol=1e-10, return_iters=True)
    assert (info, it) == (int(infoj), int(itj)) and info == 0
    _close(x, xj)
    # the DIA layout was built and cached, the row-ELL one never
    assert t.peek_layout("dia", DIA_KEY) is not None
    assert t.peek_layout("row_ell", row_ell_cache_key()) is None
    # nonsymmetric-solver path on the same operator
    x2, info2 = linalg.bicgstab(t, b, tol=1e-10)
    xj2, infoj2 = jlinalg.bicgstab(j, b, tol=1e-10)
    assert info2 == int(infoj2) == 0
    _close(x2, xj2)


def test_gcxs_operand_gets_dia_matvec(monkeypatch):
    rng = np.random.default_rng(5)
    dense = _banded_dense(80, (-1, 0, 1), rng)
    dense = (dense + dense.T) / 2 + 4 * np.eye(80)  # SPD for CG
    G = sparse.COO.from_numpy(dense).asformat("csr")
    g = gcxs_from_arrays(G.data, G.indices, G.indptr, G.shape, G.compressed_axes, device=CPU)
    b = rng.standard_normal(80)
    calls = []
    real = linalg._dia.dia_spmv
    monkeypatch.setattr(linalg._dia, "dia_spmv", lambda *a: calls.append(1) or real(*a))
    x, info = linalg.cg(g, b, tol=1e-10)
    xj, infoj = jlinalg.cg(G, b, tol=1e-10)
    assert info == int(infoj) == 0 and calls
    _close(x, xj)
    # the DIA layout lives on the COO the GCXS keeps for its products
    assert g._product_coo().peek_layout("dia", DIA_KEY) is not None


def test_solver_rebuilds_on_buffer_replacement():
    # replacing A.data must not serve a stale layout
    rng = np.random.default_rng(9)
    n = 60
    dense = _banded_dense(n, (-1, 0, 1), rng)
    dense = (dense + dense.T) / 2 + 4 * np.eye(n)
    j, t = _both(dense)
    b = rng.standard_normal(n)
    x1, info1 = linalg.cg(t, b, tol=1e-10)
    assert info1 == 0
    t.data = t.data * 2.0
    j.data = np.asarray(j.data) * 2.0
    x2, info2 = linalg.cg(t, b, tol=1e-10)
    xj2, infoj2 = jlinalg.cg(j, b, tol=1e-10)
    assert info2 == int(infoj2) == 0
    _close(x2, xj2)
    np.testing.assert_allclose(x2.numpy(), x1.numpy() / 2, rtol=1e-6)


# ---------------------------------------------------------------------------
# D1 (csrc/dia.cu): what of it runs on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offsets", [(), (0,), (-3, 0, 5), tuple(range(-32, 32)), (-(1 << 62), 1 << 62)])
def test_offsets_pack_into_the_kernel_argument(offsets):
    arg = _cuda.dia_offsets_arg(offsets)
    assert len(arg) == max(len(offsets), 1) and list(arg)[: len(offsets)] == list(offsets)


@pytest.mark.parametrize("bad", [tuple(range(65)), (1 << 63,), (-(1 << 63) - 1,)])
def test_offsets_past_one_launch_or_int64_are_refused(bad):
    with pytest.raises(ValueError):
        _cuda.dia_offsets_arg(bad)
    assert _cuda.DIA_MAX_BANDS == tdia._MAX_BANDS == 64


@pytest.mark.parametrize(
    "device, dtype, want",
    [("cpu", torch.float32, False), ("cpu", torch.float64, False), ("cuda", torch.float32, True), ("cuda", torch.float64, True), ("cuda", torch.int64, False), ("cuda", torch.float16, False), ("meta", torch.float64, False)],
)
def test_the_kernel_route_is_chosen_by_device_and_dtype(device, dtype, want):
    assert tdia.on_kernel(torch.device(device), dtype) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_products_never_touch_the_kernels(monkeypatch, dtype):
    def refuse(name):
        raise AssertionError(f"a CPU product loaded {name}")

    monkeypatch.setattr(_cuda, "load", refuse)
    rng = np.random.default_rng(11)
    offsets = tuple(range(-40, 40))  # past one launch's 64
    dense = _banded_dense(120, offsets, rng, np.float64)
    rows, cols = np.nonzero(dense)
    td = build_dia(rows, cols, dense[rows, cols], 120, max_bands=100, max_fill=100.0, device=CPU)
    bands = td.bands.to(dtype)
    x = torch.from_numpy(rng.standard_normal(120)).to(dtype)
    xm = torch.stack([x, 2 * x], 1)
    reset_launch_counts()
    got_v = dia_spmv(td.offsets, bands, x)
    got_m = dia_spmm(td.offsets, bands, xm)
    assert not any(LAUNCHES.values())
    assert torch.equal(got_v, tdia._shifted_sum_plain(td.offsets, bands, x))
    assert torch.equal(got_m, tdia._shifted_sum_plain(td.offsets, bands, xm))
    np.testing.assert_allclose(got_v.double().numpy(), dense @ x.double().numpy(), rtol=0, atol=1e-4 * np.abs(dense).sum(1).max())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_kernel_entry_point_raises_off_a_cuda_device(device):
    bands = torch.zeros((1, 8), dtype=torch.float64, device=device)
    x = torch.zeros(8, dtype=torch.float64, device=device)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.dia_shifted_sum((0,), bands, x, torch.empty(8, dtype=torch.float64, device=device))
    assert LAUNCHES["dia_spmv"] == 0
