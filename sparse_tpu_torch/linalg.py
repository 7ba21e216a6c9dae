"""Iterative solvers and spectral functions over sparse arrays, on torch tensors.

The surface of ``sparse_tpu.linalg`` (modelled on ``scipy.sparse.linalg``):
the Krylov solvers (``cg``, ``bicgstab``, ``gmres``, ``minres``, ``lsqr``,
``cgs``, ``tfqmr``, ``lsmr``, ``bicg``, ``lgmres``, ``gcrotmk``, ``qmr``), the
spectral functions (``eigsh``, ``svds``, ``lobpcg``, ``eigs``,
``power_iteration``, ``onenormest``, ``expm_multiply``, ``norm``) and the
host bridges to scipy (``spsolve``, ``spsolve_triangular``, ``splu``,
``spilu``, ``factorized``, ``inv``, ``expm``, the shift-invert mode of
``eigsh``/``eigs``), plus ``matrix_power`` on the port's SpGEMM and
``partitioned_matvec``, the matvec of a matrix row-partitioned over a mesh
(``parallel``).

Every vector lives on the operand's device. A solver iterates in Python:
each iteration enqueues its work on the device and reads back one 0-d
boolean, the stop test ``(rnorm > target) & (it < maxiter)`` of the JAX
package's ``lax.while_loop`` (the iteration count is a host int). The fixed
trip-count loops (an Arnoldi cycle, the Lanczos steps) read nothing back.
``info`` and iteration counts come back as Python ints.

Each matvec of a 2-D zero-fill COO takes one of two routes, decided by
explicit checks on the operand: a square banded matrix (``COO.to_dia`` not
``None``) runs the DIA shifts (``kernels.dia_spmv``); any other float32 or
float64 matrix runs the row-ELL SpMV (``kernels.row_ell_spmv``, the CUDA
kernel of ``csrc/row_ell.cu`` on the card) on its cached layout. A square
zero-fill GCXS takes the DIA route through the COO it keeps for its
products. Everything else goes to ``jitops.spmv``. A failure while a layout
is built or a kernel launched propagates.

Products against a basis (Gram-Schmidt, reorthogonalization, LOBPCG's
blocks) run float32 at full precision whatever
``torch.backends.cuda.matmul.allow_tf32`` says. Random start vectors are
drawn from ``key``: a ``torch.Generator`` or an int seed (``None`` is seed
0), on the generator's device, then moved to the operand's.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from . import jitops
from ._settings import resolve_device
from ._utils import numpy_dtype
from .core.base import SparseArray
from .core.coo import COO
from .core.gcxs import GCXS
from .kernels import dia as _dia
from .kernels import row_ell as _row_ell
from .kernels.bsr import _full_f32_matmul

__all__ = [
    "LinearOperator",
    "aslinearoperator",
    "bicg",
    "bicgstab",
    "cg",
    "cgs",
    "eigs",
    "eigsh",
    "expm",
    "expm_multiply",
    "factorized",
    "gcrotmk",
    "gmres",
    "inv",
    "lgmres",
    "lobpcg",
    "lsmr",
    "lsqr",
    "matrix_power",
    "minres",
    "norm",
    "onenormest",
    "partitioned_matvec",
    "power_iteration",
    "qmr",
    "spilu",
    "splu",
    "spsolve",
    "spsolve_triangular",
    "svds",
    "tfqmr",
]

_ROW_ELL_DTYPES = (torch.float32, torch.float64)


# ---------------------------------------------------------------------------
# vectors, devices and random draws
# ---------------------------------------------------------------------------


def _vdot(x, y):
    """Conjugating inner product as an element-wise multiply and a sum."""
    return torch.sum(torch.conj(x) * y)


def _norm(v, dim=None, keepdim=False):
    return torch.linalg.vector_norm(v, dim=dim, keepdim=keepdim)


def _device_of(A):
    """The operand's device: a sparse array's, a callable's ``device``
    attribute (:func:`partitioned_matvec`'s), else ``None``."""
    return A.device if isinstance(A, SparseArray) else getattr(A, "device", None)


def partitioned_matvec(pcoo, mesh, axis_name="x"):
    """``v -> A @ v`` for a :class:`~sparse_tpu_torch.parallel.PartitionedCOO`
    on ``mesh``: each rank's row shards times the replicated ``v``
    (``parallel.spmm_replicated``), gathered, so every rank holds the whole
    product. The callable carries ``shape`` and ``device`` (the mesh's), so
    it drops into :func:`cg`, :func:`bicgstab` and :func:`power_iteration`,
    whose vectors then live on the mesh's device."""
    from .parallel.sharding import _device, spmm_replicated

    def mv(v):
        return spmm_replicated(pcoo, v[:, None], mesh, axis_name=axis_name)[:, 0]

    mv.shape = pcoo.shape
    mv.device = _device(mesh)
    return mv


def _as_vector(v, device, name="b"):
    """``v`` as a tensor on ``device``: NumPy input is copied there (to the
    GPU when ``device`` is ``None``), a tensor elsewhere raises."""
    if isinstance(v, torch.Tensor):
        if device is not None and v.device != device:
            raise ValueError(f"{name} is on {v.device} but the operator is on {device}; move it with .to() first")
        return v
    return torch.tensor(np.asarray(v), device=resolve_device(device))


def _host(v, device, name="b"):
    """``v`` as a NumPy array for a host bridge (a tensor must be on ``device``)."""
    if isinstance(v, torch.Tensor):
        return _as_vector(v, device, name).cpu().numpy()
    return np.asarray(v)


def _generator(key):
    """A ``torch.Generator`` from ``key``: itself, or seeded with the int (0 for ``None``)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(0 if key is None else int(key))


def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device).to(device)


def _real_dtype(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def _eps(dtype):
    return torch.finfo(dtype).eps


def _scalar(value, like):
    """``value`` as a 0-d tensor of ``like``'s real dtype on its device (a
    fill on the device, no copy from the host)."""
    return torch.full((), value, dtype=_real_dtype(like.dtype), device=like.device)


def _target(b, tol, atol):
    """``max(tol * ||b||, atol)`` in ``b``'s dtype, a 0-d tensor."""
    return torch.maximum(_scalar(tol, b) * _norm(b), _scalar(atol, b))


def _nonzero(z):
    """``z`` with its zeros replaced by ones (a guarded denominator)."""
    return torch.where(z != 0, z, torch.ones_like(z))


def _start(x0, b):
    return torch.zeros_like(b) if x0 is None else _as_vector(x0, b.device, "x0")


def _psolve(M, b):
    """The preconditioner ``r -> M r``: none, a callable, or a diagonal vector."""
    if M is None:
        return lambda r: r
    if callable(M):
        return M
    md = _as_vector(M, b.device, "M")
    return lambda r: r / md


def _info(rnorm, target, it):
    return 0 if bool(rnorm <= target) else it


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


class LinearOperator:
    """Matrix-free operator: ``shape`` + ``matvec`` (+ optional ``rmatvec``)
    — the scipy.sparse.linalg.LinearOperator shape of the idea. Every
    solver here accepts one; :func:`lsqr`/:func:`lsmr`/:func:`onenormest`
    use ``rmatvec`` when the operand is not a sparse array."""

    def __init__(self, shape, matvec, rmatvec=None, dtype=None):
        self.shape = tuple(shape)
        if len(self.shape) != 2:
            raise ValueError(f"LinearOperator shape must be 2-D, got {self.shape}")
        self._matvec = matvec
        self._rmatvec = rmatvec
        self.dtype = dtype

    def matvec(self, x):
        return self._matvec(x)

    def rmatvec(self, x):
        if self._rmatvec is None:
            raise NotImplementedError("this LinearOperator has no rmatvec")
        return self._rmatvec(x)

    def __call__(self, x):
        return self._matvec(x)

    def __matmul__(self, x):
        return self._matvec(x)

    @property
    def T(self):
        """Transpose operator (swaps matvec and rmatvec)."""
        return LinearOperator((self.shape[1], self.shape[0]), self.rmatvec, self._matvec, dtype=self.dtype)

    H = T

    def __repr__(self):
        return f"<{self.shape[0]}x{self.shape[1]} LinearOperator>"


def aslinearoperator(A):
    """Wrap a sparse array, a dense matrix (a tensor, or NumPy input, which
    goes to the GPU) as a :class:`LinearOperator` with both ``matvec`` and
    ``rmatvec``."""
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, SparseArray):
        if A.ndim != 2:
            raise ValueError("aslinearoperator requires a 2-D array")
        return LinearOperator(A.shape, _as_matvec(A), _as_matvec(A.transpose()), dtype=A.dtype)
    a = _as_vector(A, None, "A")
    if a.ndim != 2:
        raise ValueError("aslinearoperator requires a 2-D array")
    ah = a.conj().T

    @_full_f32_matmul()
    def mv(x):
        return a @ x

    @_full_f32_matmul()
    def rmv(x):
        return ah @ x

    return LinearOperator(a.shape, mv, rmv, dtype=a.dtype)


def _as_matvec_pair(A):
    """``(matvec, rmatvec, shape)`` for solvers that need Aᵀ (lsqr/lsmr/
    onenormest): sparse arrays transpose for free; LinearOperators must
    carry an rmatvec."""
    if isinstance(A, SparseArray):
        if A.ndim != 2:
            raise ValueError("expected a 2-D operator")
        return _as_matvec(A), _as_matvec(A.transpose()), A.shape
    if isinstance(A, LinearOperator):
        return A.matvec, A.rmatvec, A.shape
    raise TypeError("expected a sparse array or a LinearOperator (needs Aᵀ)")


def _zero_fill(A):
    fv = np.asarray(A.fill_value)[()]
    return isinstance(fv, (int, float, np.floating, np.integer)) and fv == 0


def _dia_matvec(dia):
    return lambda v: _dia.dia_spmv(dia.offsets, dia.bands, v)


def _as_matvec(A):
    """``v -> A @ v`` by the route the operand calls for (module docstring)."""
    if isinstance(A, LinearOperator):
        return A.matvec
    if isinstance(A, SparseArray):
        if isinstance(A, COO) and A.ndim == 2 and _zero_fill(A):
            if A.shape[0] == A.shape[1]:
                dia = A.to_dia()
                if dia is not None:
                    return _dia_matvec(dia)
            if A.dtype in _ROW_ELL_DTYPES:
                rell = A.to_row_ell()
                return lambda v: _row_ell.row_ell_spmv(rell, v)
        elif isinstance(A, GCXS) and A.ndim == 2 and A.shape[0] == A.shape[1] and _zero_fill(A):
            dia = A._product_coo().to_dia()
            if dia is not None:
                return _dia_matvec(dia)
        return functools.partial(jitops.spmv, A)
    if callable(A):
        return A
    raise TypeError(f"expected a sparse array or a matvec callable, got {type(A)}")


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------


def cg(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None, M=None, return_iters=False):
    """Conjugate gradient for symmetric positive-definite ``A``.

    Returns ``(x, info)`` with scipy's convention: ``info == 0`` on
    convergence (``||r|| <= max(tol * ||b||, atol)``), else the iteration
    count. ``M`` is an optional preconditioner: a callable ``r -> M @ r``
    or a diagonal vector (Jacobi). With ``return_iters`` the result is
    ``(x, info, iterations)``.
    """
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    mv = _as_matvec(A)
    psolve = _psolve(M, b)
    x = _start(x0, b)
    r = b - mv(x)
    z = psolve(r)
    p = z
    rz = _vdot(r, z)
    target = _target(b, tol, atol)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        ap = mv(p)
        alpha = rz / _vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = psolve(r)
        rz_new = _vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm, it = _norm(r), it + 1
    info = _info(rnorm, target, it)
    return (x, info, it) if return_iters else (x, info)


def bicgstab(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None):
    """BiCGSTAB for general (nonsymmetric) ``A``; scipy-style ``(x, info)``."""
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    mv = _as_matvec(A)
    x = _start(x0, b)
    r = b - mv(x)
    r_hat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    target = _target(b, tol, atol)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        rho_new = _vdot(r_hat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = mv(p)
        alpha = rho_new / _vdot(r_hat, v)
        s = r - alpha * v
        t = mv(s)
        omega = _vdot(t, s) / _vdot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


@_full_f32_matmul()
def _cgs2_step(V, j, w):
    """One classical Gram-Schmidt pass with a correction pass of ``w``
    against rows ``0..j`` of ``V``: ``(w, h)``."""
    Vj = V[: j + 1]
    h = Vj @ w
    w = w - h @ Vj
    h2 = Vj @ w
    return w - h2 @ Vj, h + h2


def _unit_or_zero(w, eps):
    """``(w / ||w||, ||w||)``, the direction zeroed where ``||w|| <= eps``."""
    nrm = _norm(w)
    keep = nrm > eps
    return torch.where(keep, w / torch.where(keep, nrm, 1.0), torch.zeros_like(w)), nrm


def _arnoldi(mv, v0, m):
    """``m``-step Arnoldi with CGS2 reorthogonalization from the unit (or
    zero) ``v0``: returns ``V ((m+1, n))`` and the Hessenberg ``H ((m+1,
    m))``; rows of ``V`` after a happy breakdown stay zero. Nothing is read
    back."""
    n = v0.shape[0]
    dt = v0.dtype
    eps = _eps(dt)
    V = torch.zeros((m + 1, n), dtype=dt, device=v0.device)
    H = torch.zeros((m + 1, m), dtype=dt, device=v0.device)
    V[0] = v0
    for j in range(m):
        w, h = _cgs2_step(V, j, mv(V[j]))
        V[j + 1], hnext = _unit_or_zero(w, eps)
        H[: j + 1, j] = h
        H[j + 1, j] = hnext
    return V, H


def _ridge_solve(Q, R, rhs, eps):
    """``R⁻¹ Qᵀ rhs``, with a unit ridge on the dead diagonal entries of ``R``
    (happy breakdown, zero-padded columns: ``Qᵀ rhs`` is ~0 there)."""
    rdiag = torch.abs(torch.diagonal(R))
    ridge = torch.where(rdiag > eps * torch.clamp_min(rdiag.max(), 1.0), 0.0, 1.0).to(R.dtype)
    with _full_f32_matmul():
        qtr = Q.T @ rhs
    return torch.linalg.solve_triangular(R + torch.diag(ridge), qtr[:, None], upper=True)[:, 0]


def gmres(A, b, x0=None, *, tol=1e-8, atol=0.0, restart=20, maxiter=None, M=None):
    """Restarted GMRES(m) for general ``A``; scipy-style ``(x, info)``.

    Each restart cycle runs ``restart`` Arnoldi steps (CGS2) and solves the
    small least-squares problem on the Hessenberg matrix by QR. ``maxiter``
    counts restart cycles (scipy's outer-iteration convention); ``M`` is a
    right preconditioner: a callable ``v -> M @ v`` or a diagonal vector.
    """
    b = _as_vector(b, _device_of(A))
    n = b.shape[0]
    m = min(restart, n)
    if maxiter is None:
        maxiter = max(10 * n // m, 10)
    x = _start(x0, b)
    return _gmres_program(_as_matvec(A), _psolve(M, b), m, b, x, tol, atol, maxiter)


def _gmres_program(mv, psolve, m, b, x, tol, atol, maxiter):
    target = _target(b, tol, atol)
    eps = _eps(b.dtype)

    def arnoldi_cycle(x, r, beta):
        # a converged residual gives a zero basis and a no-op update
        V, H = _arnoldi(lambda v: mv(psolve(v)), r / torch.where(beta > 0, beta, 1.0), m)
        rhs = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
        rhs[0] = beta
        Q, R = torch.linalg.qr(H)
        y = _ridge_solve(Q, R, rhs, eps)
        with _full_f32_matmul():
            return x + psolve(y @ V[:m])

    # the true residual after every cycle (one extra matvec): the
    # GMRES-identity estimate undershoots by the basis's orthonormality loss
    r = b - mv(x)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        x = arnoldi_cycle(x, r, rnorm)
        r = b - mv(x)
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


def minres(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None):
    """MINRES for symmetric (possibly indefinite) ``A``; scipy-style
    ``(x, info)``.

    Paige-Saunders three-term Lanczos with Givens rotations; the rotated
    residual norm ``|eta|`` is the stop test. Use :func:`cg` when ``A`` is
    definite.
    """
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    mv = _as_matvec(A)
    x = _start(x0, b)
    r = b - mv(x)
    beta1 = _norm(r)
    target = _target(b, tol, atol)
    v = r / torch.where(beta1 > 0, beta1, 1.0)
    v_prev = w = w_prev = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    beta, gamma0, gamma1, sigma0, sigma1, eta = zero, one, one, zero, zero, beta1
    eta_abs, it = beta1, 0
    while it < maxiter and bool(eta_abs > target):
        av = mv(v)
        alpha = _vdot(v, av)
        v_next = av - alpha * v - beta * v_prev
        beta_next = _norm(v_next)
        v_next = v_next / torch.where(beta_next > 0, beta_next, 1.0)
        # apply the two previous Givens rotations to the new tridiagonal column
        delta = gamma1 * alpha - gamma0 * sigma1 * beta
        rho2 = sigma1 * alpha + gamma0 * gamma1 * beta
        rho3 = sigma0 * beta
        rho1 = torch.sqrt(delta * delta + beta_next * beta_next)
        rho1s = torch.where(rho1 > 0, rho1, 1.0)
        gamma_new = delta / rho1s
        sigma_new = beta_next / rho1s
        w_next = (v - rho3 * w_prev - rho2 * w) / rho1s
        x = x + gamma_new * eta * w_next
        eta = -sigma_new * eta
        v, v_prev, w, w_prev, beta = v_next, v, w_next, w, beta_next
        gamma0, gamma1, sigma0, sigma1 = gamma1, gamma_new, sigma1, sigma_new
        eta_abs, it = torch.abs(eta), it + 1
    rnorm = _norm(b - mv(x))
    return x, _info(rnorm, torch.maximum(target, 10 * _eps(b.dtype) * beta1), it)


def lsqr(A, b, *, tol=1e-8, atol=0.0, maxiter=None):
    """Least-squares ``min ||A x - b||_2`` for (rectangular) sparse ``A``
    via CGLS — the conjugate-gradient form of LSQR (same Krylov space).

    Returns ``(x, info)``: ``info == 0`` when the normal-equation residual
    satisfies ``||Aᵀ(b - A x)|| <= max(tol * ||Aᵀ b||, atol)``, else the
    iteration count.
    """
    mv, mvt, shape = _as_matvec_pair(A)
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * max(shape)
    x = torch.zeros(shape[1], dtype=b.dtype, device=b.device)
    r = b
    s = mvt(r)
    p = s
    gamma = _vdot(s, s)
    target = torch.maximum(_scalar(tol, b) * torch.sqrt(gamma), _scalar(atol, b))
    gnorm, it = torch.sqrt(gamma), 0
    while it < maxiter and bool(gnorm > target):
        q = mv(p)
        alpha = gamma / _vdot(q, q)
        x = x + alpha * p
        r = r - alpha * q
        s = mvt(r)
        gamma_new = _vdot(s, s)
        p = s + (gamma_new / gamma) * p
        gamma = gamma_new
        gnorm, it = torch.sqrt(gamma), it + 1
    return x, _info(gnorm, target, it)


def cgs(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None):
    """Conjugate Gradient Squared for general ``A`` (transpose-free);
    scipy-style ``(x, info)``."""
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    mv = _as_matvec(A)
    x = _start(x0, b)
    r = b - mv(x)
    r_hat = u = p = r
    rho = _vdot(r_hat, r)
    target = _target(b, tol, atol)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        v = mv(p)
        alpha = rho / _nonzero(_vdot(r_hat, v))
        q = u - alpha * v
        x = x + alpha * (u + q)
        r = r - alpha * mv(u + q)
        rho_new = _vdot(r_hat, r)
        beta = rho_new / _nonzero(rho)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        rho = rho_new
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


def tfqmr(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None):
    """Transpose-Free QMR (Freund '93) for general ``A``; scipy-style
    ``(x, info)``. Two matvecs per iteration; the quasi-residual bound
    ``tau * sqrt(2(it+1))`` is the stop test, and ``info`` uses the true
    final residual."""
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    mv = _as_matvec(A)
    x = _start(x0, b)
    r0 = b - mv(x)
    r_star = u = w = r0
    au = mv(u)  # A u, carried separately: v is the search direction, not A u
    v = au
    d = torch.zeros_like(b)
    tau = _norm(r0)
    theta = eta = torch.zeros((), dtype=b.dtype, device=b.device)
    rho = _vdot(r_star, r0)
    target = _target(b, tol, atol)

    def half_step(x, w, d, u_j, au_j, alpha, tau, theta, eta):
        w = w - alpha * au_j
        d = u_j + (theta * theta * eta / _nonzero(alpha)) * d
        theta = _norm(w) / torch.where(tau > 0, tau, 1.0)
        c = 1.0 / torch.sqrt(1.0 + theta * theta)
        tau = tau * theta * c
        eta = c * c * alpha
        return x + eta * d, w, d, tau, theta, eta

    bound, it = tau, 0
    while it < maxiter and bool(bound > target):
        alpha = rho / _nonzero(_vdot(r_star, v))
        u2 = u - alpha * v
        # the even half-step consumes A u, the odd one A u2 (a fresh matvec)
        x, w, d, tau, theta, eta = half_step(x, w, d, u, au, alpha, tau, theta, eta)
        au2 = mv(u2)
        x, w, d, tau, theta, eta = half_step(x, w, d, u2, au2, alpha, tau, theta, eta)
        rho_new = _vdot(r_star, w)
        beta = rho_new / _nonzero(rho)
        u = w + beta * u2
        au = mv(u)
        v = au + beta * (au2 + beta * v)
        rho = rho_new
        bound, it = tau * math.sqrt(2.0 * (it + 1.0)), it + 1
    rnorm = _norm(b - mv(x))
    return x, _info(rnorm, torch.maximum(target, 10.0 * _eps(b.dtype) * tau), it)


def lsmr(A, b, *, tol=1e-8, atol=0.0, maxiter=None):
    """Least squares via LSMR (Fong & Saunders 2011): MINRES on the normal
    equations through Golub-Kahan bidiagonalization — the normal-equation
    residual ``||Aᵀr||`` decreases monotonically, unlike :func:`lsqr`'s.

    Accepts a sparse array or a :class:`LinearOperator` with ``rmatvec``.
    Returns ``(x, info)`` with the same convention as :func:`lsqr`.
    """
    mv, rmv, shape = _as_matvec_pair(A)
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * max(shape)
    beta0 = _norm(b)
    u = b / torch.where(beta0 > 0, beta0, 1.0)
    v_raw = rmv(u)
    alpha = _norm(v_raw)
    v = v_raw / torch.where(alpha > 0, alpha, 1.0)
    x = torch.zeros(shape[1], dtype=b.dtype, device=b.device)
    h = v
    hbar = torch.zeros_like(v)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    zetabar = alpha * beta0  # == ||Aᵀ b||
    target = torch.maximum(_scalar(tol, b) * zetabar, _scalar(atol, b))
    alphabar, rho_p, rhobar_p, cbar, sbar = alpha, one, one, one, zero
    normar, it = zetabar, 0
    while it < maxiter and bool(normar > target):
        u = mv(v) - alpha * u
        beta = _norm(u)
        u = u / torch.where(beta > 0, beta, 1.0)
        v_new = rmv(u) - beta * v
        alpha_new = _norm(v_new)
        v_new = v_new / torch.where(alpha_new > 0, alpha_new, 1.0)

        rho = torch.sqrt(alphabar * alphabar + beta * beta)
        rho_s = torch.where(rho > 0, rho, 1.0)
        c = alphabar / rho_s
        s = beta / rho_s
        theta_new = s * alpha_new
        alphabar = c * alpha_new

        thetabar = sbar * rho
        rhobar = torch.sqrt((cbar * rho) ** 2 + theta_new * theta_new)
        rhobar_s = torch.where(rhobar > 0, rhobar, 1.0)
        cbar = cbar * rho / rhobar_s
        sbar = theta_new / rhobar_s
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        hbar = h - (thetabar * rho / _nonzero(rho_p * rhobar_p)) * hbar
        x = x + (zeta / _nonzero(rho * rhobar)) * hbar
        h = v_new - (theta_new / rho_s) * h
        v, alpha, rho_p, rhobar_p = v_new, alpha_new, rho, rhobar
        normar, it = torch.abs(zetabar), it + 1
    # scipy's istop convention: trust the recurrence's ||Aᵀr|| estimate
    return x, _info(normar, target, it)


def bicg(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None):
    """BiConjugate Gradient for general ``A``; scipy-style ``(x, info)``.

    The classic two-sided method: one ``A`` and one ``Aᵀ`` matvec per
    iteration, with the shadow residual driven by ``Aᵀ``.
    """
    mv, rmv, _ = _as_matvec_pair(A)
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    x = _start(x0, b)
    r = b - mv(x)
    rt = p = pt = r
    rho = _vdot(rt, r)
    target = _target(b, tol, atol)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        q = mv(p)
        qt = rmv(pt)
        alpha = rho / _nonzero(_vdot(pt, q))
        x = x + alpha * p
        r = r - alpha * q
        rt = rt - alpha * qt
        rho_new = _vdot(rt, r)
        beta = rho_new / _nonzero(rho)
        p = r + beta * p
        pt = rt + beta * pt
        rho = rho_new
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


def _krylov_rows(mv, r, m, eps, C=None):
    """Rows of an ``m``-vector orthonormal Krylov basis of ``mv`` at ``r``
    (CGS2; first projected off the rows of ``C`` when given), zero after a
    breakdown: ``(m, n)``."""
    V = torch.zeros((m, r.shape[0]), dtype=r.dtype, device=r.device)
    beta = _norm(r)
    V[0] = r / torch.where(beta > 0, beta, 1.0)
    for j in range(m - 1):
        w = mv(V[j])
        if C is not None:
            with _full_f32_matmul():
                w = w - (C @ w) @ C
        V[j + 1], _ = _unit_or_zero(_cgs2_step(V, j, w)[0], eps)
    return V


def lgmres(A, b, x0=None, *, tol=1e-8, atol=0.0, inner_m=30, outer_k=3, maxiter=1000, M=None):
    """LGMRES-family solver: restarted GMRES whose subspace is augmented
    with the last ``outer_k`` outer-iteration corrections (Baker, Jessup &
    Manteuffel '05 — the idea behind scipy's ``lgmres``).

    Each outer step builds the direction block ``W = [Krylov_m(r) ; Z]``
    (``Z`` = stored corrections, zero-padded to ``outer_k`` rows), applies
    ``A`` to all rows and solves the (n × (m+k)) least-squares by QR.
    ``maxiter`` counts outer cycles. Returns scipy-style ``(x, info)``.
    """
    b = _as_vector(b, _device_of(A))
    n = b.shape[0]
    m = min(inner_m, n)
    k = min(outer_k, n)
    mv = _as_matvec(A)
    psolve = _psolve(M, b)
    op = lambda v: mv(psolve(v))  # noqa: E731
    eps = _eps(b.dtype)
    target = _target(b, tol, atol)

    def cycle(x, r, Z):
        W = torch.cat([_krylov_rows(op, r, m, eps), Z])  # (m+k, n) directions
        C = torch.stack([op(w) for w in W])  # A @ each direction
        Q, R = torch.linalg.qr(C.T)
        y = _ridge_solve(Q, R, r, eps)
        with _full_f32_matmul():
            dx = psolve(y @ W)
        z, ndx = _unit_or_zero(dx, eps)
        Z = torch.roll(Z, shifts=1, dims=0)
        Z[0] = z
        return x + dx, Z

    x = _start(x0, b)
    Z = torch.zeros((k, n), dtype=b.dtype, device=b.device)
    r = b - mv(x)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        x, Z = cycle(x, r, Z)
        r = b - mv(x)
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


def gcrotmk(A, b, x0=None, *, tol=1e-8, atol=0.0, m=20, k=None, maxiter=1000, M=None):
    """GCROT(m,k) (Hicken & Zingg / de Sturler; scipy's ``gcrotmk``):
    restarted GMRES with an explicitly kept recycled subspace ``(U, C)``,
    ``C = A U`` orthonormal, that persists across restarts.

    Each outer cycle first removes the recycled components from the
    residual (``x += U Cᵀ r; r -= C Cᵀ r``), runs an ``m``-step Arnoldi
    least-squares on what remains (orthogonal to ``C``), then inserts the
    new correction into the recycle buffer (oldest-out). ``U``/``C`` are
    ``(k, n)`` zero-padded buffers. ``maxiter`` counts outer cycles.
    Returns scipy-style ``(x, info)``.
    """
    b = _as_vector(b, _device_of(A))
    n = b.shape[0]
    m = min(m, n)
    if k is None:
        k = m
    k = min(k, n)
    mv = _as_matvec(A)
    psolve = _psolve(M, b)
    op = lambda v: mv(psolve(v))  # noqa: E731
    eps = _eps(b.dtype)
    target = _target(b, tol, atol)

    @_full_f32_matmul()
    def cycle(x, r, U, C):
        # project the recycled subspace out of the residual
        cr = C @ r
        x = x + cr @ U
        r = r - cr @ C
        V = _krylov_rows(op, r, m, eps, C=C)
        AV = torch.stack([op(w) for w in V])
        # AV's C-components were removed from the BASIS, not from A's
        # action: project them out of the target space too
        AVp = AV - (AV @ C.T) @ C
        Q, R = torch.linalg.qr(AVp.T)
        y = _ridge_solve(Q, R, r, eps)
        du = psolve(y @ V)
        # cancel A du's components along C by moving along U (A U == C),
        # leaving A du C-free: the new recycle direction c_new
        adu = y @ AV
        cu = C @ adu
        du = du - cu @ U
        c_new = adu - cu @ C
        nc = _norm(c_new)
        keep = nc > eps
        scale = torch.where(keep, nc, 1.0)
        x = x + du
        U = torch.roll(U, 1, dims=0)
        C = torch.roll(C, 1, dims=0)
        U[0] = torch.where(keep, du / scale, torch.zeros_like(du))
        C[0] = torch.where(keep, c_new / scale, torch.zeros_like(c_new))
        return x, U, C

    x = _start(x0, b)
    U = torch.zeros((k, n), dtype=b.dtype, device=b.device)
    C = torch.zeros((k, n), dtype=b.dtype, device=b.device)
    r = b - mv(x)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        x, U, C = cycle(x, r, U, C)
        r = b - mv(x)
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


def qmr(A, b, x0=None, *, tol=1e-8, atol=0.0, maxiter=None):
    """Quasi-Minimal Residual (Freund & Nachtigal) for general ``A``;
    scipy-style ``(x, info)``.

    Two-sided (biorthogonal) Lanczos — one ``A`` and one ``Aᵀ`` matvec per
    iteration — with the QMR Givens smoothing of the BiCG recurrence. Needs
    ``Aᵀ``: takes a sparse array or a :class:`LinearOperator` with
    ``rmatvec`` (use :func:`tfqmr` for a transpose-free variant). No
    lookahead: Lanczos breakdowns stop progress (guarded against division
    by zero; ``info`` then reports the iteration count).
    """
    mv, rmv, _ = _as_matvec_pair(A)
    b = _as_vector(b, _device_of(A))
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    eps = _eps(b.dtype)
    x = _start(x0, b)
    r = b - mv(x)
    target = _target(b, tol, atol)

    def safe(z):
        return torch.where(torch.abs(z) > eps, z, torch.where(z >= 0, eps, -eps).to(z.dtype))

    # the coupled two-term variant (Freund/Nachtigal '91, as in the
    # templates): the v-tilde/w-tilde Lanczos pair, the p/q search pair,
    # Givens smoothing of the quasi-residual
    v_t = w_t = r
    rho = xi = tau = _norm(r)
    gamma = torch.ones((), dtype=b.dtype, device=b.device)
    eta = -gamma
    theta = torch.zeros((), dtype=b.dtype, device=b.device)
    eps_k = torch.ones((), dtype=b.dtype, device=b.device)
    p = q = d = s = torch.zeros_like(b)
    rnorm, it = _norm(r), 0
    while it < maxiter and bool(rnorm > target):
        v = v_t / safe(rho)
        w = w_t / safe(xi)
        delta = _vdot(w, v)
        p = v - (xi * delta / safe(eps_k)) * p
        q = w - (rho * delta / safe(eps_k)) * q
        pt = mv(p)
        eps_new = _vdot(q, pt)
        beta = eps_new / safe(delta)
        v_t = pt - beta * v
        rho_new = _norm(v_t)
        w_t = rmv(q) - beta * w
        xi = _norm(w_t)
        theta_new = rho_new / safe(gamma * torch.abs(beta))
        gamma_new = 1.0 / torch.sqrt(1.0 + theta_new * theta_new)
        eta = -eta * rho * gamma_new * gamma_new / safe(beta * gamma * gamma)
        d = eta * p + (theta * gamma_new) ** 2 * d
        s = eta * pt + (theta * gamma_new) ** 2 * s
        x = x + d
        r = r - s
        tau = tau * theta_new * gamma_new
        rho, gamma, theta, eps_k = rho_new, gamma_new, theta_new, eps_new
        rnorm, it = _norm(r), it + 1
    return x, _info(rnorm, target, it)


# ---------------------------------------------------------------------------
# spectral functions
# ---------------------------------------------------------------------------


@_full_f32_matmul()
def _lanczos(mv, v0, m, defl=None):
    """``m``-step Lanczos with full reorthogonalization.

    Returns the basis ``V (m, n)`` and the tridiagonal coefficients
    ``(alpha (m,), beta (m,))``; ``beta[m-1]`` is the edge coupling out of
    the Krylov block, which the residual estimate needs. ``defl`` (d, n) is
    an optional orthonormal deflation basis: every Lanczos vector is also
    orthogonalized against it. Nothing is read back."""
    n = v0.shape[0]
    dt = v0.dtype
    eps = _eps(dt)

    def orth_defl(w):
        return w if defl is None else w - (defl @ w) @ defl

    v = orth_defl(v0)
    V = torch.zeros((m, n), dtype=dt, device=v0.device)
    V[0] = v / torch.clamp_min(_norm(v), eps)
    alpha = torch.zeros(m, dtype=dt, device=v0.device)
    beta = torch.zeros(m, dtype=dt, device=v0.device)
    for j in range(m):
        w = mv(V[j])
        a = V[j] @ w
        # full reorthogonalization against rows 0..j
        w, _ = _cgs2_step(V, j, w - a * V[j])
        w, bj = _unit_or_zero(orth_defl(w), eps)
        if j + 1 < m:
            V[j + 1] = w
        alpha[j] = a
        beta[j] = bj
    return V, alpha, beta


def _eigsh_mv(mv, n, k, *, which="LM", m, key, dtype, device, v0=None, tol=None):
    """Restarted-deflated Lanczos core shared by :func:`eigsh`,
    :func:`svds`, and the spectral :func:`norm`.

    Each restart runs a fixed-budget Lanczos confined to the orthogonal
    complement of the converged Ritz vectors, so eigenvalue multiplicities,
    happy breakdowns and clustered spectra all resolve: only pairs whose
    Lanczos residual estimate ``|beta_edge * S[last, j]|`` meets ``tol``
    are accepted and deflated; unconverged cluster siblings are re-found by
    later (deflated) restarts. Ritz pairs supported only by dead
    (zero-padded) rows are filtered by their mass on live rows.

    The loop ends only after a restart that began with ``k`` pairs found
    and saw nothing, converged or not, beating the ``k``-th of them. The
    JAX package ends on the first restart that reaches ``k``: a Krylov space
    holds one vector of each eigenspace, so a second copy of a repeated
    eigenvalue (the 2-D Poisson spectrum's) was never looked for, and a
    smaller value took its place.
    """
    if tol is None:
        tol = 1e-8 if torch.finfo(dtype).bits >= 64 else 1e-4
    gen = _generator(key)
    # budget-doubling ceiling: room to resolve clusters without an (n, n) basis
    m_cap = min(n, max(32 * k, 4 * m, 320))
    found_vals: list = []
    found_vecs: list = []
    spare_vals: list = []
    spare_vecs: list = []
    spare_res: list = []

    def metric(vals_arr):
        # larger metric == more wanted by `which`
        if which == "LM":
            return np.abs(vals_arr)
        if which == "LA":
            return np.asarray(vals_arr)
        return -np.asarray(vals_arr)

    for restart in range(2 * k + 8):
        if v0 is None or restart > 0:
            v0 = _normal(gen, (n,), dtype, device)
        defl = torch.as_tensor(np.stack(found_vecs), device=device) if found_vecs else None
        V, alpha, beta = _lanczos(mv, _as_vector(v0, device, "v0").to(dtype), m, defl=defl)
        a_h, b_h = alpha.cpu(), beta.cpu()
        T = torch.diag(a_h) + torch.diag(b_h[:-1], 1) + torch.diag(b_h[:-1], -1)
        theta, S = torch.linalg.eigh(T)
        live_mask = (_norm(V, dim=1) > 0.5).cpu().numpy()
        with _full_f32_matmul():
            vecs = (S.T.to(device) @ V).cpu().numpy()  # rows = Ritz vectors
        theta, Snp, beta_np = theta.numpy(), S.numpy(), b_h.numpy()
        support = (Snp * Snp * live_mask.astype(Snp.dtype)[:, None]).sum(axis=0)
        lr = int(np.flatnonzero(live_mask).max()) if live_mask.any() else 0
        res = np.abs(beta_np[lr] * Snp[lr, :])
        valid = support > 0.5
        if not valid.any():
            break
        # relative acceptance threshold: no 1.0 floor, or matrices with
        # spectral norm << 1 would accept restart-0 Ritz garbage
        scale = max(np.abs(theta[valid]).max(), np.finfo(np.float64).tiny)
        # the k-th wanted value this restart began with (None: fewer than k found)
        thr_start = np.sort(metric(np.asarray(found_vals)))[-k] if len(found_vals) >= k else None
        made_progress = False
        round_unconverged = []
        round_accepted = []
        for j in np.flatnonzero(valid):
            vrow = vecs[j]
            nrm = np.linalg.norm(vrow)
            if nrm == 0:
                continue
            if res[j] <= tol * scale:
                found_vals.append(theta[j])
                found_vecs.append(vrow / nrm)
                round_accepted.append(theta[j])
                made_progress = True
            else:
                round_unconverged.append(theta[j])
                spare_vals.append(theta[j])
                spare_vecs.append(vrow / nrm)
                spare_res.append(res[j])
        if len(found_vals) >= k:
            if m >= n:
                break
            # done only when no unconverged Ritz candidate of this round
            # beats the k-th selected value in the `which` direction
            thr = np.sort(metric(np.asarray(found_vals)))[-k]
            comp = metric(np.asarray(round_unconverged)).max() if round_unconverged else -np.inf
            new_best = metric(np.asarray(round_accepted)).max() if round_accepted else -np.inf
            if comp <= thr + tol * scale and thr_start is not None and new_best <= thr_start + tol * scale:
                break
        if not made_progress:
            if m >= m_cap:
                # budget ceiling and still nothing converged: keep the best
                # unconverged pairs (with a warning below)
                break
            # the restarted form of scipy's "raise ncv"
            m = min(2 * m, m_cap)
        v0 = None
    if len(found_vals) < k:
        missing = k - len(found_vals)
        if spare_vals:
            # best-residual spares first, skipping any that overlaps a kept pair
            for j in np.argsort(spare_res):
                if len(found_vals) >= k:
                    break
                cand = spare_vecs[j]
                if found_vecs and np.max(np.abs(np.stack(found_vecs) @ cand)) > 0.9:
                    continue
                found_vals.append(spare_vals[j])
                found_vecs.append(cand)
        if len(found_vals) < k:
            raise RuntimeError(f"Lanczos found only {len(found_vals)} eigenpairs after restarts; raise ncv")
        warnings.warn(
            f"eigsh: {missing} of {k} Ritz pairs did not reach tol={tol:g}; raise ncv for clustered spectra",
            RuntimeWarning,
            stacklevel=3,
        )
    vals = np.asarray(found_vals)
    vecs = np.stack(found_vecs)
    if which == "LM":
        order = np.argsort(np.abs(vals))[-k:]
        idx = order[np.argsort(vals[order])]
    elif which == "LA":
        idx = np.argsort(vals)[-k:]
    elif which == "SA":
        idx = np.argsort(vals)[:k]
    else:
        raise ValueError(f"which must be 'LM', 'LA', or 'SA'; got {which!r}")
    return torch.as_tensor(vals[idx], device=device), torch.as_tensor(vecs[idx].T.copy(), device=device)


def _shift_invert_solve(A, sigma):
    """Host ``v -> (A - sigma I)^{-1} v`` (one SuperLU factorization, f64):
    every matvec of the shift-invert Krylov loop is a host LU solve, so the
    loop runs on the host too."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    if not isinstance(A, SparseArray):
        raise TypeError("sigma (shift-invert) requires a sparse array operand")
    sp = A.to_scipy_sparse().tocsc().astype("float64")
    lu = spla.splu((sp - sigma * sps.eye(sp.shape[0], format="csc")).tocsc())
    return lu.solve


def _arnoldi_np(mv, v0, m):
    """Host ``m``-step Arnoldi (CGS2), numpy f64. Returns ``(V, H, j)``
    with ``j <= m`` the steps completed before a happy breakdown."""
    n = v0.size
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    V[0] = v0 / np.linalg.norm(v0)
    for j in range(m):
        w = mv(V[j]).astype(np.float64)
        h = V[: j + 1] @ w
        w = w - h @ V[: j + 1]
        h2 = V[: j + 1] @ w
        w = w - h2 @ V[: j + 1]
        h = h + h2
        hn = np.linalg.norm(w)
        H[: j + 1, j] = h
        H[j + 1, j] = hn
        if hn <= 1e-14 * max(1.0, np.abs(H).max()):
            return V, H, j + 1
        V[j + 1] = w / hn
    return V, H, m


def _host_normal(gen, n):
    """A float32 normal draw as a float64 host vector (the shift-invert seeds)."""
    return _normal(gen, (n,), torch.float32, "cpu").double().numpy()


def _host_si_eigs(solve, n, k, *, m, sym, tol, v0, key, maxiter=10):
    """Restarted host Arnoldi on the shift-inverted operator: returns the
    ``k`` largest-|nu| Ritz pairs of OP = (A - sigma I)^{-1}."""
    gen = _generator(key)
    if v0 is None:
        seed = _host_normal(gen, n)
    else:
        seed = np.asarray(v0.cpu() if isinstance(v0, torch.Tensor) else v0, dtype=np.float64)
    nu_s = Y_s = None
    V = j = None
    for _ in range(maxiter):
        V, H, j = _arnoldi_np(solve, seed, m)
        Hm = H[:j, :j]
        if sym:
            nu, Y = np.linalg.eigh((Hm + Hm.T) / 2)
        else:
            nu, Y = np.linalg.eig(Hm)
        if j < k:
            # invariant subspace smaller than k: re-seed randomly
            seed = _host_normal(gen, n)
            continue
        idx = np.argsort(-np.abs(nu))[:k]
        nu_s, Y_s = nu[idx], Y[:, idx]
        # breakdown at j < m means the Krylov space is invariant: exact
        resid = np.abs(H[j, j - 1] * Y_s[-1, :]) if j == m else np.zeros(k)
        if np.all(resid <= tol * np.maximum(np.abs(nu_s), 1e-30)):
            break
        restart = (V[:j].T @ Y_s.sum(axis=1)).real
        nrm = np.linalg.norm(restart)
        if not np.isfinite(nrm) or nrm < 1e-12:
            restart = _host_normal(gen, n)
            nrm = np.linalg.norm(restart)
        seed = restart / nrm
    X = V[:j].T @ Y_s
    X = X / np.linalg.norm(X, axis=0, keepdims=True)
    return nu_s, X


def _operand_dtype(A):
    return A.data.dtype if isinstance(getattr(A, "data", None), torch.Tensor) else torch.float64


def eigsh(A, k=6, *, which="LM", v0=None, ncv=None, key=None, tol=None, sigma=None):
    """Top-``k`` eigenpairs of a symmetric sparse matrix via Lanczos.

    The Krylov builds run on the operand's device (:func:`_lanczos`, full
    reorthogonalization); the small tridiagonal problem is one ``eigh`` on
    the host. Degenerate spectra (multiplicity, early breakdown) are handled
    by deflated restarts. ``which``: 'LM' (largest magnitude), 'LA'
    (largest algebraic), 'SA' (smallest algebraic). Returns
    ``(eigenvalues, eigenvectors)`` in scipy's ascending order. Fixed
    Krylov budget ``ncv`` (default ``min(n, max(4k, 40))``) per restart.

    With ``sigma`` the problem runs in shift-invert mode (scipy parity): a
    host Krylov loop over ``(A - sigma I)^{-1}`` (:func:`_host_si_eigs`),
    and the ``k`` eigenvalues closest to sigma come back as
    ``sigma + 1/nu``.
    """
    n = A.shape[0]
    if not 0 < k < n:
        raise ValueError(f"k must be in (0, n); got k={k}, n={n}")
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"which must be 'LM', 'LA', or 'SA'; got {which!r}")
    m = min(n, max(4 * k, 40)) if ncv is None else min(max(ncv, k + 1), n)
    dt = _operand_dtype(A)
    if sigma is not None:
        if which != "LM":
            raise ValueError("shift-invert mode supports which='LM' (closest to sigma)")
        solve = _shift_invert_solve(A, sigma)
        nu, vecs = _host_si_eigs(solve, n, k, m=m, sym=True, tol=tol if tol is not None else 1e-10, v0=v0, key=key)
        w = sigma + 1.0 / np.asarray(nu)
        order = np.argsort(w)
        return torch.as_tensor(w[order], dtype=dt, device=A.device), torch.as_tensor(vecs[:, order], dtype=dt, device=A.device)
    device = _device_of(A) or (v0.device if isinstance(v0, torch.Tensor) else resolve_device(None))
    return _eigsh_mv(_as_matvec(A), n, k, which=which, m=m, key=key, dtype=dt, device=device, v0=v0, tol=tol)


def svds(A, k=6, *, ncv=None, key=None, tol=None):
    """Top-``k`` singular triplets of a sparse matrix, scipy-ordered
    ``(U, s, Vh)`` with ``s`` ascending.

    Runs the deflated-restart Lanczos on the Gram operator
    ``v -> Aᵀ(A v)`` and recovers the left vectors as ``A V / s``. The
    squared conditioning is fine for well-separated leading singular
    values; raise ``ncv`` otherwise. ``key`` is taken and unused, as in the
    reference: the Gram restarts draw from seed 0.
    """
    if not isinstance(A, SparseArray):
        raise TypeError("svds requires a sparse array (needs Aᵀ for the Gram operator)")
    n_min = min(A.shape)
    if not 0 < k < n_min:
        raise ValueError(f"k must be in (0, min(A.shape)); got k={k}, shape={A.shape}")
    mv = _as_matvec(A)
    mvt = _as_matvec(A.transpose())
    n_cols = A.shape[1]
    dt = A.data.dtype
    m = min(n_cols, max(4 * k, 40)) if ncv is None else min(max(ncv, k + 1), n_cols)
    vals, V = _eigsh_mv(
        lambda v: mvt(mv(v)), n_cols, k, which="LA", m=m, key=0, dtype=dt, device=A.device, tol=tol
    )
    s = torch.sqrt(torch.clamp_min(vals, 0))
    AV = torch.stack([mv(V[:, i]) for i in range(k)], dim=1)
    U = AV / torch.where(s > 0, s, 1.0)[None, :]
    return U, s, V.T


def lobpcg(A, k=4, *, X=None, maxiter=100, tol=None, key=None, n=None):
    """Top-``k`` (largest) eigenpairs via block LOBPCG, the algorithm of
    ``jax.experimental.sparse.linalg.lobpcg_standard`` (which the JAX
    package wraps) with a block product over the sparse array
    (``jitops.spmm``: one SpMM per iteration). Returns ``(eigenvalues,
    eigenvectors, iterations)`` with eigenvalues ascending."""
    if isinstance(A, SparseArray):
        n = A.shape[0]
        op = functools.partial(jitops.spmm, A)
        dt = A.data.dtype
        device = A.device
    elif callable(A):
        if n is None and X is None:
            raise ValueError("lobpcg with a matvec callable needs `n` or an explicit `X`")
        n = X.shape[0] if n is None else n
        op = lambda V: torch.stack([A(V[:, i]) for i in range(V.shape[1])], dim=1)  # noqa: E731
        dt = torch.float64
        device = X.device if isinstance(X, torch.Tensor) else resolve_device(None)
    else:
        raise TypeError(f"expected a sparse array or matvec callable, got {type(A)}")
    if not 0 < k < n // 2:
        raise ValueError(f"lobpcg requires 0 < k < n/2; got k={k}, n={n}")
    if X is None:
        X = _normal(_generator(key), (n, k), dt, device)
    theta, U, iters = _lobpcg_standard(op, _as_vector(X, device, "X"), maxiter, tol)
    order = torch.argsort(theta)
    return theta[order], U[:, order], iters


@_full_f32_matmul()
def _lobpcg_standard(A, X, m, tol):
    """Top-``k`` standard eigenpairs of the block operator ``A`` from the
    start block ``X (n, k)``: ``(theta, U, iterations)``. Each iteration
    reads back one count (the converged pairs)."""
    n, k = X.shape
    dt = X.dtype
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(dt).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    if AX.dtype != dt or AX.shape != (n, k):
        raise ValueError(f"A must map ({n}, {k}) blocks of {dt} to the same, got {tuple(AX.shape)} of {AX.dtype}")
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i, converged = 0, 0
    while i < m and converged < k:
        # X, P, R kept orthonormal (R and P columns may be zero after truncation)
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = _rayleigh_ritz_orth(A, XPR)
        B = Q[:, :k]
        B = B / _norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / _norm(X, dim=0, keepdim=True)
        # P: concat(0, Q[k:, :k]) orthogonalized against Q[:, :k] in the
        # standard basis, then mapped through the orthonormal XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = _norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, 1.0, normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        # converged when |r| is small against the rounding error of the residual itself
        reltol = (_norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int((_norm(R, dim=0) < tol * reltol).sum())
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _eigh_descending(A):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """A truncated orthonormal basis of ``X`` (SVQB): columns found
    degenerate in ``XᵀX``'s eigenbasis come back zero."""
    norms = _norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = _eps(X.dtype) * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diag(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    """The component of ``U`` in the complement of the orthonormal
    ``basis`` (zero columns allowed), its nonzero columns orthonormal;
    columns that are not clearly outside the basis come back zero."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = _norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S):
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X, m):
    """``m`` directions orthonormal to the orthonormal ``X (n, k)``, from
    block Householder reflectors (deterministic, no random overlap)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat(
        [torch.eye(m, dtype=X.dtype, device=X.device), torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)]
    )
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h


def power_iteration(A, *, key=None, v0=None, tol=1e-9, maxiter=1000):
    """Dominant eigenpair of ``A`` by normalized power iteration.

    Returns ``(eigenvalue, eigenvector, iterations)``; the eigenvalue is a
    0-d tensor, the iteration count an int.
    """
    device = _device_of(A)
    if v0 is None:
        dt = _operand_dtype(A)
        v0 = _normal(_generator(key), (A.shape[0],), dt, device or resolve_device(None))
    v = _as_vector(v0, device, "v0")
    mv = _as_matvec(A)
    v = v / _norm(v)
    v_prev = torch.full_like(v, float("inf"))
    tol_t = _scalar(tol, v)
    it = 0
    while it < maxiter and bool(_norm(v - v_prev) > tol_t):
        w = mv(v)
        w = w / _norm(w)
        # fix the sign so the convergence test is orientation-free
        w = w * torch.sign(_vdot(w, v))
        v, v_prev, it = w, v, it + 1
    return _vdot(v, mv(v)), v, it


def onenormest(A, t=2, itmax=5, compute_v=False, compute_w=False, key=None):
    """Estimate ``||A||_1`` by the Higham–Tisseur block power method
    (scipy.sparse.linalg.onenormest parity) — a lower bound that is almost
    always exact, using only ``matvec``/``rmatvec``. ``key`` (default seed
    1) draws the random sign columns. ``v`` and ``w`` come back as tensors
    on the operand's device."""
    mv, rmv, shape = _as_matvec_pair(A)
    n = shape[1]
    if shape[0] != n:
        raise ValueError("onenormest expects a square operator")
    t = min(t, n)
    device = _device_of(A) or resolve_device(None)

    def mm(f, X):
        cols = torch.as_tensor(X, device=device)
        return torch.stack([f(cols[:, j]) for j in range(X.shape[1])], dim=1).cpu().numpy()

    X = np.ones((n, t)) / n
    if t > 1:
        signs = torch.randint(0, 2, (n, t - 1), generator=_generator(1 if key is None else key)) * 2 - 1
        X[:, 1:] = signs.numpy() / n
    est_old = 0.0
    ind_hist = np.zeros(n, dtype=bool)
    v_best = np.zeros(n)
    w_best = None
    for k in range(itmax):
        Y = mm(mv, X)
        norms = np.abs(Y).sum(axis=0)
        j_best = int(np.argmax(norms))
        est = float(norms[j_best])
        if est > est_old:
            v_best = X[:, j_best]
            w_best = Y[:, j_best]
        if k > 0 and est <= est_old:
            est = est_old
            break
        est_old = est
        S = np.where(Y >= 0, 1.0, -1.0)
        Z = mm(rmv, S)
        h = np.abs(Z).max(axis=1)
        if k > 0 and float(h.max()) <= float((Z[:, 0] * X[:, 0]).sum()):
            break
        order = np.argsort(-h)
        fresh = [i for i in order if not ind_hist[i]][:t]
        if not fresh:
            break
        X = np.zeros((n, t))
        for c, i in enumerate(fresh):
            X[i, c] = 1.0
            ind_hist[i] = True
    if w_best is None:
        w_best = mm(mv, v_best[:, None])[:, 0]
    v_t, w_t = torch.as_tensor(v_best, device=device), torch.as_tensor(w_best, device=device)
    if compute_v and compute_w:
        return est, v_t, w_t
    if compute_v:
        return est, v_t
    if compute_w:
        return est, w_t
    return est


def expm_multiply(A, b, *, t=1.0, m=30):
    """``exp(t A) @ b`` without forming the (dense) matrix exponential.

    Krylov approximation: an ``m``-step Arnoldi basis of ``A`` at ``b``
    (CGS2) and the small Hessenberg exponential lifted back:
    ``||b|| · V exp(t H) e1``. Exact when ``m >= n``; raise ``m`` for large
    ``|t| * ||A||``. Works for general (nonsymmetric) ``A``.
    """
    b = _as_vector(b, _device_of(A))
    m = min(m, b.shape[0])
    beta = _norm(b)
    V, H = _arnoldi(_as_matvec(A), b / torch.where(beta > 0, beta, 1.0), m)
    eHt = torch.linalg.matrix_exp(_scalar(t, b).to(b.dtype) * H[:m, :m])
    with _full_f32_matmul():
        return beta * (eHt[:, 0] @ V[:m])


def norm(A, ord="fro", axis=None):
    """Matrix/vector norm of a sparse array (scipy.sparse.linalg.norm parity).

    ``ord``: 'fro' (default), 1, inf, or 2 (the spectral norm, through
    :func:`svds`). A norm over the whole array is a Python float; over an
    ``axis`` a dense tensor on the array's device. Requires zero fill.
    """
    from .ops.common import asCOO

    if not isinstance(A, SparseArray):
        raise TypeError("norm expects a sparse array")
    if not np.asarray(A.fill_value)[()] == 0:
        raise ValueError("norm requires a zero fill value")
    coo = asCOO(A)
    mag = torch.abs(coo.data)

    def fro():
        return float(torch.sqrt((mag**2).sum()))

    def top(t):
        return float(t.max()) if t.numel() else 0.0

    if axis is None:
        if coo.ndim == 1:
            if ord in (None, 2, "fro", "f"):
                return fro()
            if ord == 1:
                return float(mag.sum())
            if ord == np.inf:
                return top(mag)
            raise ValueError(f"invalid norm order {ord!r} for vectors")
        if coo.ndim != 2:
            raise ValueError("matrix norms require a 2-D array")
        if ord in ("fro", "f", None):
            return fro()
        if ord == 2:
            # spectral norm (scipy parity): largest singular value
            if min(coo.shape) <= 2 or coo.nnz == 0:
                return float(torch.linalg.matrix_norm(coo.todense(), 2))
            _, s, _ = svds(coo, k=1)
            return float(s[0])
        if ord == 1:  # max column sum
            return top(abs(coo).sum(axis=0).todense())
        if ord == np.inf:  # max row sum
            return top(abs(coo).sum(axis=1).todense())
        raise ValueError(f"invalid norm order {ord!r}")
    # axis-wise reductions return dense vectors like scipy
    if ord in (None, 2, "fro", "f"):
        return torch.sqrt((abs(coo) ** 2).sum(axis=axis).todense())
    if ord == 1:
        return abs(coo).sum(axis=axis).todense()
    if ord == np.inf:
        return abs(coo).max(axis=axis).todense()
    raise ValueError(f"invalid norm order {ord!r}")


def _select_ritz(w, which, k):
    keys = {
        "LM": -np.abs(w),
        "SM": np.abs(w),
        "LR": -w.real,
        "SR": w.real,
        "LI": -w.imag,
        "SI": w.imag,
    }
    if which not in keys:
        raise ValueError(f"which must be one of {sorted(keys)}, got {which!r}")
    return np.argsort(keys[which], kind="stable")[:k]


def eigs(A, k=6, *, which="LM", ncv=None, maxiter=None, tol=None, v0=None, key=None, sigma=None):
    """``k`` eigenpairs of a general (nonsymmetric) ``A`` by restarted
    Arnoldi — the scipy.sparse.linalg.eigs surface.

    The ``ncv``-step Arnoldi factorization runs on the operand's device
    (:func:`_arnoldi`); only the small ``(ncv, ncv)`` Hessenberg
    eigenproblem is solved on the host. Restarts re-seed with the sum of
    the wanted Ritz vectors. Returns ``(w, X)`` complex, on the operand's
    device, with Ritz residuals ``||A x - w x|| <= tol * |w|``.

    With ``sigma``, a host Arnoldi runs on ``(A - sigma I)^{-1}``
    (:func:`_host_si_eigs`) and returns the ``k`` eigenvalues closest to
    ``sigma`` as ``sigma + 1/nu`` (``which`` must stay 'LM').
    """
    n = A.shape[0]
    if sigma is not None:
        if which != "LM":
            raise ValueError("shift-invert mode supports which='LM' (closest to sigma)")
        m_si = min(n, ncv if ncv is not None else max(2 * k + 1, 20))
        solve = _shift_invert_solve(A, sigma)
        nu, X = _host_si_eigs(
            solve, n, k, m=m_si, sym=False, tol=tol if tol is not None else 1e-10, v0=v0, key=key
        )
        return torch.as_tensor(sigma + 1.0 / nu, device=A.device), torch.as_tensor(X, device=A.device)
    device = _device_of(A) or (v0.device if isinstance(v0, torch.Tensor) else resolve_device(None))
    mv = _as_matvec(A)
    if k >= n - 1:
        raise ValueError("k must be < n - 1 for Arnoldi; densify for full spectra")
    m = min(n, ncv if ncv is not None else max(2 * k + 1, 20))
    if maxiter is None:
        maxiter = 10
    gen = _generator(key)
    dt = _operand_dtype(A)
    v0 = _normal(gen, (n,), dt, device) if v0 is None else _as_vector(v0, device, "v0").to(dt)
    if tol is None:
        tol = 1e-6 if torch.finfo(dt).bits >= 64 else 1e-4
    w_sel = X_small = V_host = None
    for _ in range(maxiter):
        V, H = _arnoldi(mv, v0 / torch.clamp_min(_norm(v0), _eps(dt)), m)
        H = H.cpu().double().numpy()
        Hm = H[:m, :m]
        hlast = float(H[m, m - 1])
        w, Y = np.linalg.eig(Hm)
        idx = _select_ritz(w, which, k)
        w_sel, X_small = w[idx], Y[:, idx]
        # Arnoldi residual identity: ||A x - w x|| = |h_{m+1,m}| |e_m^T y|
        resid = np.abs(hlast * X_small[m - 1, :])
        V_host = V[:m].cpu().double().numpy()
        if np.all(resid <= tol * np.maximum(np.abs(w_sel), 1e-30)):
            break
        # explicit restart: combined wanted Ritz directions (real field)
        seed = (V_host.T @ X_small.sum(axis=1)).real
        nrm = np.linalg.norm(seed)
        if not np.isfinite(nrm) or nrm < 1e-12:
            v0 = _normal(gen, (n,), dt, device)
        else:
            v0 = torch.as_tensor(seed / nrm, dtype=dt, device=device)
    X = V_host.T @ X_small
    X = X / np.linalg.norm(X, axis=0, keepdims=True)
    return torch.as_tensor(w_sel, device=device), torch.as_tensor(X, device=device)


# ---------------------------------------------------------------------------
# host bridges (scipy), results on the operand's device
# ---------------------------------------------------------------------------


def _sparse_operand(A, name):
    if not isinstance(A, SparseArray):
        raise TypeError(f"{name} expects a sparse array")
    return A


def spsolve(A, b):
    """Direct solve ``A x = b`` via the host sparse LU (SuperLU through
    scipy), for small and medium systems; ``x`` comes back on ``A``'s
    device. For large systems prefer the iterative solvers."""
    import scipy.sparse.linalg as spla

    _sparse_operand(A, "spsolve")
    x = spla.spsolve(A.to_scipy_sparse().tocsr(), _host(b, A.device))
    return torch.as_tensor(x, device=A.device)


def spsolve_triangular(A, b, lower=True, unit_diagonal=False):
    """Triangular solve ``A x = b`` on the host (scipy bridge, like
    :func:`spsolve`): substitution is sequential, so it stays a host path."""
    import scipy.sparse.linalg as spla

    _sparse_operand(A, "spsolve_triangular")
    x = spla.spsolve_triangular(
        A.to_scipy_sparse().tocsr(), _host(b, A.device), lower=lower, unit_diagonal=unit_diagonal
    )
    return torch.as_tensor(x, device=A.device)


def inv(A):
    """Sparse inverse via the host direct factorization (SuperLU through
    scipy); returns a COO on ``A``'s device. Prefer solving systems over
    forming inverses."""
    import scipy.sparse.linalg as spla

    _sparse_operand(A, "inv")
    return COO.from_scipy_sparse(spla.inv(A.to_scipy_sparse().tocsc()), device=A.device)


def expm(A):
    """Sparse matrix exponential (Padé + scaling-squaring on the host via
    scipy); returns a COO on ``A``'s device. For the action
    ``exp(tA) @ b`` without forming the exponential, use
    :func:`expm_multiply`."""
    import scipy.sparse.linalg as spla

    _sparse_operand(A, "expm")
    return COO.from_scipy_sparse(spla.expm(A.to_scipy_sparse().tocsc()), device=A.device)


def matrix_power(A, power):
    """``A ** power`` for square sparse ``A`` by binary exponentiation over
    the SpGEMM on ``A``'s device (scipy.sparse.linalg.matrix_power parity);
    ``power == 0`` returns the sparse identity."""
    from .ops.creation import eye

    _sparse_operand(A, "matrix_power")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("matrix_power expects a square matrix")
    power = int(power)
    if power < 0:
        raise ValueError("negative powers are not supported (invert explicitly)")
    if power == 0:
        return eye(A.shape[0], dtype=numpy_dtype(A.dtype), device=A.device)
    result = None
    base = A
    while power:
        if power & 1:
            result = base if result is None else result @ base
        power >>= 1
        if power:
            base = base @ base
    return result


class _SuperLUFactor:
    """Thin wrapper over scipy's SuperLU object: ``solve(b)`` plus the
    permutation/L/U constituents re-exposed as COO arrays, all on the
    factored array's device."""

    def __init__(self, slu, device):
        self._slu = slu
        self._device = device
        self.shape = slu.shape
        self.nnz = slu.nnz
        self.perm_r = slu.perm_r
        self.perm_c = slu.perm_c

    def solve(self, b, trans="N"):
        return torch.as_tensor(self._slu.solve(_host(b, self._device), trans=trans), device=self._device)

    @property
    def L(self):
        return COO.from_scipy_sparse(self._slu.L.tocoo(), device=self._device)

    @property
    def U(self):
        return COO.from_scipy_sparse(self._slu.U.tocoo(), device=self._device)


def splu(A, **kwargs):
    """LU-factorize ``A`` once (host SuperLU bridge) for repeated solves:
    returns an object with ``.solve(b)``, ``.L``/``.U`` as COO, and the
    row/column permutations."""
    import scipy.sparse.linalg as spla

    _sparse_operand(A, "splu")
    return _SuperLUFactor(spla.splu(A.to_scipy_sparse().tocsc(), **kwargs), A.device)


def spilu(A, **kwargs):
    """Incomplete LU (host SuperLU bridge) — the standard preconditioner
    factory: ``M = spilu(A); cg(A, b, M=M.solve)``."""
    import scipy.sparse.linalg as spla

    _sparse_operand(A, "spilu")
    return _SuperLUFactor(spla.spilu(A.to_scipy_sparse().tocsc(), **kwargs), A.device)


def factorized(A):
    """``factorized(A)(b)`` solves ``A x = b`` reusing one LU factorization
    (scipy parity; host bridge)."""
    return splu(A).solve
