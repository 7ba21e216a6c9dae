"""The rest of the port's Krylov solvers against sparse_tpu's (CPU).

``bicg``, ``qmr``, ``lgmres``, ``gcrotmk`` (which need Aᵀ or keep an
augmenting subspace), ``lsqr`` and ``lsmr`` on a rectangular operand, and
complex Hermitian solves, as tests/test_torch_linalg_krylov.py holds the
others: the solution at rtol 1e-8 of its largest entry, ``info`` equal.
The operand kinds: a COO (the row-ELL route), a CSR ``GCXS``
(``jitops.spmv``) and a ``LinearOperator`` from ``aslinearoperator``,
which carries Aᵀ.
"""

import numpy as np
import pytest
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu_torch import linalg
from torch_linalg_cases import KINDS, check_solve, close, port_coo, solve_ids

SOLVES = [
    ("bicg", "nonsym", (("tol", 1e-10),)),
    ("qmr", "nonsym", (("tol", 1e-10),)),
    ("lgmres", "nonsym", (("tol", 1e-10), ("inner_m", 8), ("outer_k", 2))),
    ("gcrotmk", "nonsym", (("tol", 1e-10), ("m", 8), ("k", 4))),
    ("lsqr", "rect", (("tol", 1e-10),)),
    ("lsmr", "rect", (("tol", 1e-12),)),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("solver,name,kw", SOLVES, ids=solve_ids(SOLVES))
def test_solver_matches_sparse_tpu(solver, name, kw, kind):
    check_solve(solver, name, kw, kind)


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "cgs", "bicg"])
def test_complex_hermitian_solves(solver):
    # complex operands take the general matvec (their fill value is complex); the
    # inner products conjugate, as the reference's _vdot does
    rng = np.random.default_rng(8)
    n = 40
    B = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) * (rng.random((n, n)) < 0.1)
    j = sparse.COO.from_numpy(B @ B.conj().T + n * np.eye(n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xj, infoj = getattr(jlinalg, solver)(j, b, tol=1e-10)[:2]
    x, info = getattr(linalg, solver)(port_coo(j), b, tol=1e-10)[:2]
    assert x.dtype == torch.complex128 and info == int(infoj) == 0
    close(x, xj)
