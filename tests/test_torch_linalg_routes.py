"""Routes, options and the surface of sparse_tpu_torch.linalg against sparse_tpu's (CPU).

Preconditioners, ``x0``, ``atol`` and float32 solves against the JAX
package (float64 solutions at rtol 1e-8 of their largest entry, ``info``
and iteration counts equal; float32 at rtol 1e-4 with ``info`` 0 on both
sides); the route rules (a spy on ``row_ell_spmv``, the layouts cached on
the operand); failures inside a layout build or a launch propagating out
of ``cg``; the device and dtype rules; ``LinearOperator`` and
``aslinearoperator``; the public surface against the reference's
(``__all__``, parameter names).
"""

import inspect

import numpy as np
import pytest
import torch

import sparse_tpu as sparse
from sparse_tpu import linalg as jlinalg
from sparse_tpu_torch import linalg
from sparse_tpu_torch.kernels import row_ell as t_row_ell
from sparse_tpu_torch.kernels.row_ell import row_ell_cache_key
from torch_linalg_cases import DIA_KEY, MATRICES, close, jax_operand, jax_solve, port_coo, rhs

ROW_ELL_KEY = row_ell_cache_key()

def test_cg_preconditioners_and_x0():
    j = jax_operand("spd")
    dense = MATRICES["spd"]()
    b = rhs("spd")
    t = port_coo(j)
    diag = np.diag(dense).copy()
    xj, infoj, itj = jlinalg.cg(j, b, tol=1e-10, M=diag, return_iters=True)
    x, info, it = linalg.cg(t, b, tol=1e-10, M=diag, return_iters=True)
    assert (info, it) == (int(infoj), int(itj)) == (0, it)
    close(x, xj)
    # a callable preconditioner: the same Jacobi step
    x2, info2, it2 = linalg.cg(t, b, tol=1e-10, M=lambda r: r / torch.from_numpy(diag), return_iters=True)
    assert (info2, it2) == (info, it)
    close(x2, xj)
    x0 = np.linspace(-1, 1, b.size)
    xj3, infoj3, itj3 = jlinalg.cg(j, b, x0=x0, tol=1e-10, return_iters=True)
    x3, info3, it3 = linalg.cg(t, b, x0=torch.from_numpy(x0), tol=1e-10, return_iters=True)
    assert (info3, it3) == (int(infoj3), int(itj3))
    close(x3, xj3)
    # atol alone stops the loop
    xj4, infoj4, itj4 = jlinalg.cg(j, b, tol=0.0, atol=1e-3, return_iters=True)
    x4, info4, it4 = linalg.cg(t, b, tol=0.0, atol=1e-3, return_iters=True)
    assert (info4, it4) == (int(infoj4), int(itj4)) and it4 < int(jax_solve("cg", "spd", (("tol", 1e-10), ("return_iters", True)))[2])
    close(x4, xj4)


@pytest.mark.parametrize("solver", ["gmres", "lgmres", "gcrotmk"])
def test_right_preconditioned_solvers(solver):
    j = jax_operand("nonsym")
    b = rhs("nonsym")
    diag = np.diag(MATRICES["nonsym"]()).copy()
    xj, infoj = getattr(jlinalg, solver)(j, b, tol=1e-10, M=diag)
    x, info = getattr(linalg, solver)(port_coo(j), b, tol=1e-10, M=diag)
    assert info == int(infoj) == 0
    close(x, xj)


def test_gmres_converged_start_is_noop():
    j = jax_operand("nonsym")
    t = port_coo(j)
    dense = MATRICES["nonsym"]()
    x_true = np.linspace(0, 1, dense.shape[0])
    b = dense @ x_true
    x, info = linalg.gmres(t, b, x0=torch.from_numpy(x_true), tol=1e-6)
    xj, infoj = jlinalg.gmres(j, b, x0=x_true, tol=1e-6)
    assert info == int(infoj) == 0
    close(x, xj, 1e-12)


def test_float32_solves():
    dense = MATRICES["spd"]().astype(np.float32)
    j = sparse.COO.from_numpy(dense)
    t = port_coo(j)
    b = rhs("spd").astype(np.float32)
    for solver, kw in (("cg", {}), ("gmres", {"restart": 20}), ("bicgstab", {})):
        xj, infoj = getattr(jlinalg, solver)(j, b, tol=1e-5, **kw)[:2]
        x, info = getattr(linalg, solver)(t, b, tol=1e-5, **kw)[:2]
        assert x.dtype == torch.float32 and int(infoj) == 0 and info == 0
        close(x, xj, 1e-4)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


def test_non_banded_solve_runs_row_ell_spmv(monkeypatch):
    calls = []
    real = t_row_ell.row_ell_spmv
    monkeypatch.setattr(t_row_ell, "row_ell_spmv", lambda *a, **k: calls.append(1) or real(*a, **k))
    t = port_coo(jax_operand("spd"))
    x, info, it = linalg.cg(t, rhs("spd"), tol=1e-10, return_iters=True)
    assert info == 0 and len(calls) == it + 1  # one matvec an iteration, one for r0
    assert t.peek_layout("row_ell", ROW_ELL_KEY) is not None
    assert t.peek_layout("dia", DIA_KEY) is None  # built and refused: nothing cached
    # the banded operand never reaches it
    calls.clear()
    p = port_coo(jax_operand("poisson"))
    linalg.cg(p, rhs("poisson"), tol=1e-10)
    assert calls == [] and p.peek_layout("row_ell", ROW_ELL_KEY) is None
    assert p.peek_layout("dia", DIA_KEY).offsets == (-12, -1, 0, 1, 12)


def test_other_dtypes_take_the_general_matvec(monkeypatch):
    # an integer matrix: the row-ELL SpMV takes float32/float64 only, so the
    # route goes to jitops.spmv before a row-ELL layout is built
    dense = np.round(MATRICES["spd"]()).astype(np.int64)
    j = sparse.COO.from_numpy(dense)
    t = port_coo(j)
    monkeypatch.setattr(t_row_ell, "row_ell_spmv", lambda *a, **k: pytest.fail("row_ell_spmv on int64"))
    b = rhs("spd")
    xj, infoj = jlinalg.cg(j, b, tol=1e-10)
    x, info = linalg.cg(t, b, tol=1e-10)
    assert info == int(infoj) == 0 and t.peek_layout("row_ell", ROW_ELL_KEY) is None
    close(x, xj)


@pytest.mark.parametrize("where", ["build_row_ell", "build_dia", "row_ell_spmv"])
def test_failures_propagate_out_of_cg(monkeypatch, where):
    import sparse_tpu_torch.kernels.dia as t_dia

    module = t_dia if where == "build_dia" else t_row_ell
    name = "poisson" if where == "build_dia" else "spd"

    def boom(*args, **kwargs):
        raise RuntimeError(f"{where} failed")

    monkeypatch.setattr(module, where, boom)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        linalg.cg(port_coo(jax_operand(name)), rhs(name), tol=1e-10)


def test_devices_are_not_mixed():
    t = port_coo(jax_operand("spd"))
    with pytest.raises(ValueError, match="meta"):
        linalg.cg(t, torch.empty(80, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="meta"):
        linalg.cg(t, rhs("spd"), x0=torch.empty(80, dtype=torch.float64, device="meta"))
    # a NumPy right-hand side goes to the operand's device
    x, _ = linalg.cg(t, rhs("spd"))
    assert x.device.type == "cpu" and x.dtype == torch.float64


# ---------------------------------------------------------------------------
# operators and the public surface
# ---------------------------------------------------------------------------


def test_linearoperator_matvec_rmatvec():
    dense = MATRICES["nonsym"]()
    j = jax_operand("nonsym")
    op = linalg.aslinearoperator(port_coo(j))
    assert linalg.aslinearoperator(op) is op and op.shape == dense.shape and op.dtype == torch.float64
    x = torch.from_numpy(rhs("nonsym"))
    close(op.matvec(x), dense @ x.numpy(), 1e-12)
    close(op.rmatvec(x), dense.T @ x.numpy(), 1e-12)
    close(op.T @ x, dense.T @ x.numpy(), 1e-12)
    close(op(x), dense @ x.numpy(), 1e-12)
    assert repr(op) == repr(jlinalg.aslinearoperator(j)) == "<60x60 LinearOperator>"
    dense_op = linalg.aslinearoperator(torch.from_numpy(dense))
    close(dense_op.H.matvec(x), dense.T @ x.numpy(), 1e-12)
    with pytest.raises(NotImplementedError):
        linalg.LinearOperator((3, 3), lambda v: v).rmatvec(torch.zeros(3))
    with pytest.raises(ValueError):
        linalg.LinearOperator((3,), lambda v: v)
    with pytest.raises(TypeError):
        linalg.lsqr(lambda v: v, rhs("nonsym"))


def test_matrix_free_operator():
    dense = MATRICES["spd"]()
    A = torch.from_numpy(dense)
    b = rhs("spd")
    op = linalg.LinearOperator(dense.shape, lambda v: A @ v, lambda v: A.T @ v)
    xj, infoj = jlinalg.cg(jlinalg.LinearOperator(dense.shape, lambda v: dense @ v), b, tol=1e-10)
    for operand in (op, lambda v: A @ v):
        x, info = linalg.cg(operand, torch.from_numpy(b), tol=1e-10)
        assert info == int(infoj) == 0
        close(x, xj)
    x, info = linalg.lsmr(op, torch.from_numpy(b), tol=1e-12)
    assert info == 0
    close(x, np.linalg.solve(dense, b), 1e-8)


def _params(f):
    return list(inspect.signature(f.__init__ if inspect.isclass(f) else f).parameters.items())


def test_public_surface_matches_sparse_tpu():
    assert linalg.__all__ == jlinalg.__all__  # partitioned_matvec included
    for name in linalg.__all__:
        got, want = _params(getattr(linalg, name)), _params(getattr(jlinalg, name))
        assert [(n, p.kind, p.default) for n, p in got] == [(n, p.kind, p.default) for n, p in want], name
    import sparse_tpu_torch as st

    assert st.linalg is linalg and "linalg" not in st.__all__
