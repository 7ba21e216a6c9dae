"""The port's other spectral functions (sparse_tpu_torch.linalg) against sparse_tpu's (CPU).

``svds``, ``lobpcg``, ``power_iteration``, ``eigs``, ``onenormest``,
``expm_multiply`` and ``norm`` on the same operands through
``sparse_tpu.linalg`` (JAX on the CPU) and the port, passing the same
``v0``/``X`` or holding what does not depend on the start. Tolerances:
eigenvalues and singular values at rtol 1e-8 (float64), eigenvectors up
to sign at 1e-6 of the unit vector, the Krylov exponential at rtol 1e-8 of
its largest entry, norms at 1e-12.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu_torch import linalg
from sparse_tpu_torch.interop import coo_from_arrays
from torch_linalg_cases import CPU, both, close, port_coo, same_vectors_up_to_sign, spd_dense

def test_svds_matches_sparse_tpu():
    rng = np.random.default_rng(12)
    m, n = 80, 50
    dense = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.15)
    j, t = both(dense)
    U, s, Vh = linalg.svds(t, k=3, ncv=n)
    _, sj, _ = jlinalg.svds(j, k=3, ncv=n)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-8)
    np.testing.assert_allclose(s.numpy(), np.sort(np.linalg.svd(dense, compute_uv=False))[-3:], rtol=1e-8)
    for i in range(3):
        np.testing.assert_allclose(dense @ Vh[i].numpy(), s[i].item() * U[:, i].numpy(), rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="k must be"):
        linalg.svds(t, k=50)
    with pytest.raises(TypeError):
        linalg.svds(lambda v: v)


def test_lobpcg_matches_sparse_tpu():
    dense = spd_dense()
    j, t = both(dense)
    X = np.random.default_rng(3).standard_normal((dense.shape[0], 3))
    wj, Uj, itj = jlinalg.lobpcg(j, k=3, X=X, maxiter=200)
    w, U, it = linalg.lobpcg(t, k=3, X=X, maxiter=200)
    # the convergence count is read from residuals at the rounding floor: within one iteration
    assert type(it) is int and abs(it - int(itj)) <= 1
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-8)
    same_vectors_up_to_sign(U, Uj)
    # a callable operator and the seeded start
    A = torch.from_numpy(dense)
    w2, _, _ = linalg.lobpcg(lambda v: A @ v, k=3, X=torch.from_numpy(X), maxiter=200)
    np.testing.assert_allclose(w2.numpy(), w.numpy(), rtol=1e-8)
    w3, _, _ = linalg.lobpcg(t, k=3, maxiter=200, key=1)
    np.testing.assert_allclose(w3.numpy(), np.sort(np.linalg.eigvalsh(dense))[-3:], rtol=1e-6)
    with pytest.raises(ValueError, match="lobpcg requires"):
        linalg.lobpcg(t, k=dense.shape[0])
    with pytest.raises(ValueError, match="needs `n`"):
        linalg.lobpcg(lambda v: v, k=2)


def test_power_iteration_matches_sparse_tpu():
    rng = np.random.default_rng(5)
    n = 70
    B = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    dense = B @ B.T
    j, t = both(dense)
    v0 = rng.standard_normal(n)
    lj, vj, itj = jlinalg.power_iteration(j, v0=v0, tol=1e-12, maxiter=5000)
    lam, v, it = linalg.power_iteration(t, v0=v0, tol=1e-12, maxiter=5000)
    assert type(it) is int and abs(it - int(itj)) <= 1
    np.testing.assert_allclose(lam.item(), float(lj), rtol=1e-12)
    close(v, vj, 1e-8)
    np.testing.assert_allclose(lam.item(), np.linalg.eigvalsh(dense)[-1], rtol=1e-6)


EIGS_CASES = {
    "dominant_real": dict(k=3, which="LM", ncv=30, tol=1e-8),
    "complex_pair": dict(k=2, which="LM", ncv=20, tol=1e-9),
    "smallest_real": dict(k=2, which="SR", ncv=40, maxiter=30, tol=1e-6),
}


def eigs_dense(case):
    rng = np.random.default_rng(20)
    if case == "dominant_real":
        n = 60
        return rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2) + np.diag(np.linspace(1.0, 30.0, n))
    if case == "complex_pair":
        dense = np.diag(np.linspace(0.1, 1.0, 40))
        dense[0, 1], dense[1, 0] = -5.0, 5.0
        dense[0, 0] = dense[1, 1] = 2.0
        return dense
    d = np.linspace(-10.0, 10.0, 50)
    return np.diag(d) + rng.standard_normal((50, 50)) * 0.01 * (rng.random((50, 50)) < 0.1)


@pytest.mark.parametrize("case", sorted(EIGS_CASES))
def test_eigs_matches_sparse_tpu(case):
    dense = eigs_dense(case)
    j, t = both(dense)
    kw = EIGS_CASES[case]
    v0 = np.random.default_rng(9).standard_normal(dense.shape[0])
    wj, Xj = jlinalg.eigs(j, v0=v0, **kw)
    w, X = linalg.eigs(t, v0=v0, **kw)
    # complex unless every selected eigenvalue is real, as NumPy's eig (and the JAX package) give them
    assert w.numpy().dtype == np.asarray(wj).dtype and X.shape == (dense.shape[0], kw["k"])
    np.testing.assert_allclose(np.sort_complex(w.numpy()), np.sort_complex(np.asarray(wj)), rtol=1e-8)
    for i in range(kw["k"]):
        x = X[:, i].numpy()
        r = dense @ x - w[i].item() * x
        assert np.linalg.norm(r) < 1e-4 * abs(w[i].item())


def test_onenormest_matches_sparse_tpu():
    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        dense = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.2)
        j, t = both(dense)
        exact = np.abs(dense).sum(axis=0).max()
        # t=1 draws nothing: the two packages take the same steps
        assert linalg.onenormest(t, t=1) == pytest.approx(jlinalg.onenormest(j, t=1), rel=1e-12)
        est = linalg.onenormest(t, t=4)
        assert 0.5 * exact <= est <= exact * (1 + 1e-10)
    est, v, w = linalg.onenormest(t, t=8, itmax=8, compute_v=True, compute_w=True)
    np.testing.assert_allclose(est, exact, rtol=1e-12)
    np.testing.assert_allclose(w.numpy(), dense @ v.numpy(), rtol=1e-12, atol=1e-12)
    assert v.device.type == "cpu" and linalg.onenormest(t, t=8, itmax=8, compute_v=True)[0] == est
    with pytest.raises(ValueError, match="square"):
        linalg.onenormest(port_coo(sparse.COO.from_numpy(dense[:, :30])))


def test_expm_multiply_matches_sparse_tpu():
    rng = np.random.default_rng(13)
    n = 60
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1) * 0.3
    j, t = both(dense)
    b = rng.standard_normal(n)
    close(linalg.expm_multiply(t, b, m=n), jlinalg.expm_multiply(j, b, m=n))
    close(linalg.expm_multiply(t, b, t=0.5, m=40), jlinalg.expm_multiply(j, b, t=0.5, m=40))
    # a long Krylov basis on a graph Laplacian stays orthogonal (CGS2)
    g = sps.random(200, 200, density=0.04, random_state=5)
    g = g.maximum(g.T)
    lap = (sps.diags(np.asarray(g.sum(axis=1)).ravel()) - g).toarray()
    jl, tl = both(lap)
    sig = np.random.default_rng(0).standard_normal(200)
    close(linalg.expm_multiply(tl, sig, t=-1.0, m=80), jlinalg.expm_multiply(jl, sig, t=-1.0, m=80))


def test_norm_matches_sparse_tpu():
    rng = np.random.default_rng(14)
    dense = rng.standard_normal((40, 30)) * (rng.random((40, 30)) < 0.2)
    j, t = both(dense)
    for ord_ in ("fro", 1, np.inf, 2):
        got, want = linalg.norm(t, ord_), jlinalg.norm(j, ord_)
        assert type(got) is float
        np.testing.assert_allclose(got, want, rtol=1e-12 if ord_ != 2 else 1e-8)
    for ord_, axis in ((1, 0), (np.inf, 1), (2, 0), ("fro", 1)):
        got = linalg.norm(t, ord_, axis=axis)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), np.asarray(jlinalg.norm(j, ord_, axis=axis)), rtol=1e-12)
    vec_j = sparse.COO.from_numpy(dense[3])
    vec_t = port_coo(vec_j)
    for ord_ in (None, 1, np.inf):
        np.testing.assert_allclose(linalg.norm(vec_t, ord_), jlinalg.norm(vec_j, ord_), rtol=1e-12)
    small_j, small_t = both(dense[:2, :5])
    np.testing.assert_allclose(linalg.norm(small_t, 2), jlinalg.norm(small_j, 2), rtol=1e-12)
    with pytest.raises(ValueError, match="zero fill"):
        linalg.norm(coo_from_arrays(np.zeros((2, 0), dtype=np.int64), np.zeros(0), (3, 3), fill_value=1.0, device=CPU))
    with pytest.raises(ValueError, match="invalid norm order"):
        linalg.norm(t, 3)
