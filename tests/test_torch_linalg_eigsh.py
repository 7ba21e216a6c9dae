"""The port's eigsh (sparse_tpu_torch.linalg) against sparse_tpu's (CPU).

The same operands through ``sparse_tpu.linalg.eigsh`` (JAX on the CPU) and
the port. Random start vectors are drawn differently by the two packages
(``jax.random`` and a ``torch.Generator``), so the comparisons either pass
the same ``v0`` or hold what does not depend on the start. The port looks
once more than the JAX package before it stops (``_eigsh_mv``): where that
finds the second copy of a double eigenvalue that the JAX package misses,
the port is held against the closed form. Tolerances: eigenvalues at rtol
1e-8 (float64; the float32 case at 1e-4), eigenvectors up to sign at 1e-6
of the unit vector.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu_torch import linalg
from sparse_tpu_torch.interop import gcxs_from_arrays
from torch_linalg_cases import CPU, both, poisson_dense, port_coo, same_vectors_up_to_sign, spd_dense

@pytest.mark.parametrize("which,k,ncv", [("LM", 4, None), ("LA", 3, None), ("SA", 3, 80)])
def test_eigsh_matches_sparse_tpu(which, k, ncv):
    dense = spd_dense()
    j, t = both(dense)
    v0 = np.random.default_rng(7).standard_normal(dense.shape[0])
    wj, Vj = jlinalg.eigsh(j, k=k, which=which, ncv=ncv, v0=v0)
    w, V = linalg.eigsh(t, k=k, which=which, ncv=ncv, v0=v0)
    assert w.dtype == torch.float64 and V.shape == (dense.shape[0], k)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-8)
    same_vectors_up_to_sign(V, Vj)
    ref = np.sort(np.linalg.eigvalsh(dense))
    np.testing.assert_allclose(w.numpy(), ref[-k:] if which != "SA" else ref[:k], rtol=1e-7)


def poisson_top(side, k):
    i = np.arange(1, side + 1)
    lam1 = 4 * np.sin(np.pi * i / (2 * (side + 1))) ** 2
    return np.sort((lam1[:, None] + lam1[None, :]).ravel())[-k:]


@pytest.mark.parametrize("side", [16, 20, 32])
def test_eigsh_clustered_poisson_against_closed_form(side):
    # the top four hold a double eigenvalue; random starts: the values do not depend on them
    j, t = both(poisson_dense(side))
    ref = poisson_top(side, 4)
    w, V = linalg.eigsh(t, k=4)
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-8)
    dense = poisson_dense(side)
    for c in range(4):
        v = V[:, c].numpy()
        assert np.linalg.norm(dense @ v - w[c].item() * v) < 1e-6
    np.testing.assert_allclose(V.T.numpy() @ V.numpy(), np.eye(4), atol=1e-8)
    wj = np.asarray(jlinalg.eigsh(j, k=4)[0])
    if side == 20:
        np.testing.assert_allclose(w.numpy(), wj, rtol=1e-8)
    else:
        # the JAX package stops on the first restart that reaches k and misses
        # the double eigenvalue's second copy; the port looks once more
        assert np.sum(np.isclose(wj, ref[1], rtol=1e-8)) == 1 and np.sum(np.isclose(w.numpy(), ref[1], rtol=1e-8)) == 2


def test_eigsh_degenerate_and_validation():
    _, t = both(np.eye(10))
    w, V = linalg.eigsh(t, k=2)
    np.testing.assert_allclose(w.numpy(), [1.0, 1.0], rtol=1e-10)
    np.testing.assert_allclose(V.T.numpy() @ V.numpy(), np.eye(2), atol=1e-8)
    D = np.diag([5.0, 5.0, 2.0, 1.0, 0.5, 0.25])
    jd, td = both(D)
    w2, _ = linalg.eigsh(td, k=3)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jlinalg.eigsh(jd, k=3)[0]), rtol=1e-9)
    with pytest.raises(ValueError, match="k must be"):
        linalg.eigsh(t, k=10)
    with pytest.raises(ValueError, match="which"):
        linalg.eigsh(t, k=2, which="XX")


def test_eigsh_indefinite_tiny_norm_and_gcxs():
    rng = np.random.default_rng(11)
    n = 60
    B = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    dense = (B + B.T) / 2
    j, t = both(dense)
    w, _ = linalg.eigsh(t, k=3, which="LM", ncv=n)
    np.testing.assert_allclose(w.numpy(), np.asarray(jlinalg.eigsh(j, k=3, which="LM", ncv=n)[0]), rtol=1e-8)
    tiny = spd_dense() * 1e-8
    jt, tt = both(tiny)
    np.testing.assert_allclose(linalg.eigsh(tt, k=3)[0].numpy(), np.asarray(jlinalg.eigsh(jt, k=3)[0]), rtol=1e-8)
    g = sparse.COO.from_numpy(spd_dense()).asformat("csr")
    tg = gcxs_from_arrays(g.data, g.indices, g.indptr, g.shape, g.compressed_axes, device=CPU)
    np.testing.assert_allclose(linalg.eigsh(tg, k=2)[0].numpy(), np.asarray(jlinalg.eigsh(g, k=2)[0]), rtol=1e-8)


def test_eigsh_float32_interior_competitor():
    import os

    path = os.path.join(os.path.dirname(__file__), "data", "eigsh_f32_interior_competitor.npz")
    S = sps.load_npz(path)
    j = sparse.COO.from_scipy_sparse(S.tocoo())
    w, _ = linalg.eigsh(port_coo(j), k=2, ncv=40)
    assert w.dtype == torch.float32
    ref = np.sort(np.linalg.eigvalsh(S.toarray().astype(np.float64)))[-2:]
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-4)


def test_start_keys():
    _, t = both(spd_dense())
    w1, V1 = linalg.eigsh(t, k=2, key=5)
    w2, V2 = linalg.eigsh(t, k=2, key=torch.Generator().manual_seed(5))
    assert torch.equal(w1, w2) and torch.equal(V1, V2)
    w0, _ = linalg.eigsh(t, k=2)
    w00, _ = linalg.eigsh(t, k=2, key=0)
    assert torch.equal(w0, w00)
    np.testing.assert_allclose(w0.numpy(), w1.numpy(), rtol=1e-8)
    lam1, _, it1 = linalg.power_iteration(t, key=3, tol=1e-12)
    lam2, _, it2 = linalg.power_iteration(t, key=torch.Generator().manual_seed(3), tol=1e-12)
    assert it1 == it2 and torch.equal(lam1, lam2)
