"""The port's host bridges (sparse_tpu_torch.linalg) against sparse_tpu's (CPU).

``spsolve``, ``spsolve_triangular``, ``splu``/``spilu``/``factorized``,
``inv`` and ``expm`` run scipy on the host in both packages, and the port
returns its results on the operand's device; ``matrix_power`` runs on the
port's SpGEMM; ``eigsh``/``eigs`` with ``sigma`` run the shift-invert
Arnoldi on the host. The same inputs go through both packages, held at
rtol 1e-12 (of the largest entry for vectors and matrices).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu_torch import COO, linalg
from sparse_tpu_torch.interop import coo_from_arrays, gcxs_from_arrays

CPU = "cpu"


def both(dense):
    j = sparse.COO.from_numpy(dense)
    return j, coo_from_arrays(np.asarray(j.coords), np.asarray(j.data), j.shape, device=CPU)


def close(got, want, rtol=1e-12):
    got = got.todense() if isinstance(got, COO) else got
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want.todense() if hasattr(want, "todense") else want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def spd_dense():
    rng = np.random.default_rng(0)
    n = 80
    B = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    return B @ B.T + n * np.eye(n)


def test_spsolve_matches_sparse_tpu():
    dense = spd_dense()
    j, t = both(dense)
    b = np.random.default_rng(15).standard_normal(dense.shape[0])
    x = linalg.spsolve(t, b)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    close(x, jlinalg.spsolve(j, b))
    g = j.asformat("csr")
    tg = gcxs_from_arrays(g.data, g.indices, g.indptr, g.shape, g.compressed_axes, device=CPU)
    close(linalg.spsolve(tg, torch.from_numpy(b)), jlinalg.spsolve(g, b))
    with pytest.raises(ValueError, match="meta"):
        linalg.spsolve(t, torch.empty(80, dtype=torch.float64, device="meta"))
    with pytest.raises(TypeError):
        linalg.spsolve(torch.eye(3), b[:3])


def test_spsolve_triangular_matches_sparse_tpu():
    rng = np.random.default_rng(16)
    n = 30
    dense = np.tril(rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)) + 2 * np.eye(n)
    j, t = both(dense)
    b = rng.standard_normal(n)
    close(linalg.spsolve_triangular(t, b, lower=True), jlinalg.spsolve_triangular(j, b, lower=True))
    ju, tu = both(dense.T.copy())
    close(
        linalg.spsolve_triangular(tu, b, lower=False, unit_diagonal=True),
        jlinalg.spsolve_triangular(ju, b, lower=False, unit_diagonal=True),
    )


def test_splu_spilu_factorized_match_sparse_tpu():
    dense = spd_dense()
    j, t = both(dense)
    b = np.arange(dense.shape[0], dtype=np.float64)
    lu, jlu = linalg.splu(t), jlinalg.splu(j)
    close(lu.solve(b), jlu.solve(b))
    close(lu.solve(torch.from_numpy(b), trans="T"), jlu.solve(b, trans="T"))
    close(linalg.factorized(t)(b), jlinalg.factorized(j)(b))
    assert isinstance(lu.L, COO) and isinstance(lu.U, COO) and lu.L.device.type == "cpu"
    close(lu.L, jlu.L)
    close(lu.U, jlu.U)
    assert lu.shape == jlu.shape and lu.nnz == jlu.nnz
    np.testing.assert_array_equal(lu.perm_r, jlu.perm_r)
    np.testing.assert_array_equal(lu.perm_c, jlu.perm_c)
    ilu, jilu = linalg.spilu(t, drop_tol=1e-8), jlinalg.spilu(j, drop_tol=1e-8)
    close(ilu.solve(b), jilu.solve(b))
    # the preconditioner factory drives cg
    x, info = linalg.cg(t, b, M=ilu.solve, tol=1e-10)
    assert info == 0
    close(x, np.linalg.solve(dense, b), 1e-8)


def test_inv_expm_match_sparse_tpu():
    rng = np.random.default_rng(14)
    n = 25
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2) + n * np.eye(n)
    j, t = both(dense)
    got = linalg.inv(t)
    assert isinstance(got, COO) and got.device.type == "cpu"
    close(got, jlinalg.inv(j))
    jb, tb = both(dense / n)
    got_e = linalg.expm(tb)
    assert isinstance(got_e, COO)
    close(got_e, jlinalg.expm(jb))


def test_matrix_power_matches_sparse_tpu():
    rng = np.random.default_rng(15)
    dense = (rng.random((20, 20)) < 0.15) * rng.standard_normal((20, 20))
    j, t = both(dense)
    for p in (0, 1, 2, 3, 5):
        got = linalg.matrix_power(t, p)
        want = jlinalg.matrix_power(j, p)
        assert isinstance(got, COO) and got.dtype == torch.float64
        close(got, want)
    with pytest.raises(ValueError):
        linalg.matrix_power(t, -1)
    with pytest.raises(ValueError):
        linalg.matrix_power(both(dense[:, :10])[1], 2)


def test_eigsh_shift_invert_matches_sparse_tpu():
    n = 80
    dense = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    j, t = both(dense)
    v0 = np.random.default_rng(3).standard_normal(n)
    w, X = linalg.eigsh(t, k=3, sigma=0.0, ncv=30, v0=v0)
    wj, Xj = jlinalg.eigsh(j, k=3, sigma=0.0, ncv=30, v0=v0)
    assert w.dtype == torch.float64 and w.device.type == "cpu"
    close(w, wj)
    close(X, Xj, 1e-10)
    w_i, _ = linalg.eigsh(t, k=2, sigma=0.9, ncv=40, v0=torch.from_numpy(v0))
    close(w_i, jlinalg.eigsh(j, k=2, sigma=0.9, ncv=40, v0=v0)[0])
    np.testing.assert_allclose(np.sort(w_i.numpy()), np.sort(spla.eigsh(dense, k=2, sigma=0.9, return_eigenvectors=False)), rtol=1e-8)
    with pytest.raises(ValueError, match="shift-invert"):
        linalg.eigsh(t, k=2, sigma=0.5, which="SA")
    with pytest.raises(TypeError):
        linalg.eigsh(linalg.LinearOperator((n, n), lambda v: v), k=2, sigma=0.5)


def test_eigs_shift_invert_matches_sparse_tpu():
    rng = np.random.default_rng(22)
    n = 60
    dense = np.diag(np.linspace(0.5, 30.0, n)) + rng.standard_normal((n, n)) * 0.05 * (rng.random((n, n)) < 0.1)
    j, t = both(dense)
    v0 = rng.standard_normal(n)
    w, X = linalg.eigs(t, k=2, sigma=5.0, ncv=30, v0=v0)
    wj, Xj = jlinalg.eigs(j, k=2, sigma=5.0, ncv=30, v0=v0)
    close(w, wj)
    close(X, Xj, 1e-10)
    with pytest.raises(ValueError):
        linalg.eigs(t, k=2, sigma=5.0, which="SR")
