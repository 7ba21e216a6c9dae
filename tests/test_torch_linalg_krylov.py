"""The port's Krylov solvers (sparse_tpu_torch.linalg) against sparse_tpu's (CPU).

``cg``, ``bicgstab``, ``gmres``, ``minres``, ``cgs`` and ``tfqmr`` (the
rest in tests/test_torch_linalg_krylov_rest.py). The same operands and
right-hand sides, made from numpy seeds (``torch_linalg_cases``), go
through ``sparse_tpu.linalg`` (JAX on the CPU) and the port. Tolerances (float64): solutions at rtol 1e-8 of their
largest entry (the packages sum inner products in other orders), ``info``
equal, iteration counts equal where ``return_iters`` gives them. Each JAX
solve runs once and the port's runs are held against it through each
operand kind: a COO (the row-ELL route, or the DIA route for a banded
matrix), a CSR ``GCXS`` (``jitops.spmv``, or DIA) and a ``LinearOperator``.
"""

import pytest

from sparse_tpu_torch import linalg
from torch_linalg_cases import KINDS, check_solve, close, jax_operand, jax_solve, port_coo, rhs, solve_ids

SOLVES = [
    ("cg", "spd", (("tol", 1e-10), ("return_iters", True))),
    ("cg", "poisson", (("tol", 1e-10), ("return_iters", True))),
    ("bicgstab", "nonsym", (("tol", 1e-10),)),
    ("gmres", "nonsym", (("tol", 1e-10), ("restart", 10))),
    ("gmres", "poisson", (("tol", 1e-10), ("restart", 40))),
    ("minres", "indefinite", (("tol", 1e-10),)),
    ("cgs", "nonsym", (("tol", 1e-10),)),
    ("tfqmr", "nonsym", (("tol", 1e-10),)),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("solver,name,kw", SOLVES, ids=solve_ids(SOLVES))
def test_solver_matches_sparse_tpu(solver, name, kw, kind):
    check_solve(solver, name, kw, kind)


@pytest.mark.parametrize(
    "solver,kw",
    [
        ("cg", (("maxiter", 7),)),
        ("bicgstab", (("maxiter", 3),)),
        ("gmres", (("restart", 4), ("maxiter", 2))),
        ("minres", (("maxiter", 5),)),
        ("tfqmr", (("maxiter", 3),)),
        ("qmr", (("maxiter", 4),)),
    ],
)
def test_unconverged_info_is_the_iteration_count(solver, kw):
    name = "spd"
    want = jax_solve(solver, name, (("tol", 1e-14),) + kw)
    x, info = getattr(linalg, solver)(port_coo(jax_operand(name)), rhs(name), tol=1e-14, **dict(kw))
    assert info == int(want[1]) == dict(kw)["maxiter"]
    close(x, want[0])
