"""Shared inputs and comparisons of the port's linalg tests (tests/test_torch_linalg_*.py).

Every matrix is made from a numpy seed; ``jax_solve`` runs each JAX
package solve once a process (it compiles a whole program) so that the
port's runs through several operand kinds are held against one result.
"""

import functools

import numpy as np
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu_torch import linalg
from sparse_tpu_torch.interop import coo_from_arrays, gcxs_from_arrays

CPU = "cpu"
DIA_KEY = (64, 8.0)


def np_of(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, rtol=1e-8):
    """``got`` equals ``want`` within ``rtol`` of ``want``'s largest entry."""
    want = np.asarray(want)
    got = np_of(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def same_vectors_up_to_sign(got, want, tol=1e-6):
    got, want = np_of(got), np.asarray(want)
    for i in range(want.shape[1]):
        g, w = got[:, i], want[:, i]
        np.testing.assert_allclose(np.sign(g @ w) * g, w, rtol=0, atol=tol)


def port_coo(j):
    """The port's CPU COO holding the JAX COO ``j``'s arrays as they are."""
    return coo_from_arrays(np.asarray(j.coords), np.asarray(j.data), j.shape, device=CPU)


def both(dense):
    j = sparse.COO.from_numpy(dense)
    return j, port_coo(j)


def port_operand(j, kind):
    """The port's operand of kind ``kind`` holding the JAX COO ``j``'s matrix."""
    t = port_coo(j)
    if kind == "coo":
        return t
    if kind == "csr":
        g = j.asformat("csr")
        return gcxs_from_arrays(g.data, g.indices, g.indptr, g.shape, g.compressed_axes, device=CPU)
    if kind == "linop":
        return linalg.aslinearoperator(t)
    raise ValueError(kind)


def spd_dense():
    rng = np.random.default_rng(0)
    n = 80
    B = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    return B @ B.T + n * np.eye(n)


def nonsym_dense():
    rng = np.random.default_rng(4)
    n = 60
    M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    return M + n * np.eye(n)  # diagonally dominant, nonsymmetric


def indefinite_dense():
    rng = np.random.default_rng(6)
    n = 50
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([-np.linspace(1, 5, n // 2), np.linspace(1, 5, n - n // 2)])
    return (Q * lam) @ Q.T


def poisson_dense(side):
    """The 5-point Laplacian of a side × side grid (examples/solvers_example.py)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    A = 4.0 * np.eye(n)
    for di, dj in ((0, 1), (1, 0)):
        a = idx[: side - di, : side - dj].ravel()
        b = idx[di:, dj:].ravel()
        A[a, b] = A[b, a] = -1.0
    return A


MATRICES = {
    "spd": spd_dense,
    "nonsym": nonsym_dense,
    "indefinite": indefinite_dense,
    "poisson": lambda: poisson_dense(12),
    "rect": lambda: nonsym_dense()[:, :40],
}


@functools.lru_cache(maxsize=None)
def jax_operand(name):
    return sparse.COO.from_numpy(MATRICES[name]())


def rhs(name, seed=1):
    return np.random.default_rng(seed).standard_normal(MATRICES[name]().shape[0])


@functools.lru_cache(maxsize=None)
def jax_solve(solver, name, kw=()):
    """The JAX package's result of ``solver`` on matrix ``name`` as NumPy."""
    res = getattr(jlinalg, solver)(jax_operand(name), rhs(name), **dict(kw))
    return tuple(np.asarray(r) for r in res)


KINDS = ["coo", "csr", "linop"]


def check_solve(solver, name, kw, kind):
    """The port's ``solver`` on matrix ``name`` through operand ``kind``
    against the JAX package's: the solution at rtol 1e-8 of its largest
    entry, ``info`` (0) and any iteration count equal, as Python ints."""
    want = jax_solve(solver, name, kw)
    # a LinearOperator has no device: the right-hand side's is used (NumPy input goes to the GPU)
    b = torch.from_numpy(rhs(name)) if kind == "linop" else rhs(name)
    got = getattr(linalg, solver)(port_operand(jax_operand(name), kind), b, **dict(kw))
    assert isinstance(got[0], torch.Tensor) and got[0].device.type == "cpu"
    assert all(type(v) is int for v in got[1:])
    assert got[1:] == tuple(int(v) for v in want[1:]) and got[1] == 0
    close(got[0], want[0])


def solve_ids(solves):
    return [f"{s}-{n}-{dict(k).get('restart', '')}" for s, n, k in solves]
