"""The solvers of sparse_tpu_torch.linalg on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_linalg_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). A non-banded
operand's matvecs run K1 (``csrc/row_ell.cu``): ``cg`` on the card counts
one launch an iteration and one for the first residual, and its solution
equals the CPU run's (the plain version's) at rtol 1e-12 of its largest
entry (float64: K1 sums each row in another order). A banded operand's
matvecs run the DIA shifts on D1 (``csrc/dia.cu``, the same rounded products
in the same order as the CPU's torch ops), one launch a matvec and no other
kernel. The float32 products against a Krylov basis run
at full precision: ``gmres`` and ``eigsh`` give the same bits with
``allow_tf32`` set as without it.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch import linalg
from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _spd(n, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return ((B @ B.T) / (n * density) + np.eye(n)).astype(dtype)


def _poisson(side, device, dtype=torch.float64):
    n = side * side
    idx = torch.arange(n, device=device).reshape(side, side)
    rows, cols, vals = [idx.reshape(-1)], [idx.reshape(-1)], [torch.full((n,), 4.0, dtype=dtype, device=device)]
    for di, dj in ((0, 1), (1, 0)):
        a = idx[: side - di, : side - dj].reshape(-1)
        b = idx[di:, dj:].reshape(-1)
        rows += [a, b]
        cols += [b, a]
        vals += [torch.full((a.numel(),), -1.0, dtype=dtype, device=device)] * 2
    return st.COO(torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals), shape=(n, n))


def test_cg_through_k1_equals_the_cpu_run(cuda):
    dense = _spd(2000, 0.002, 0)
    b = np.random.default_rng(1).standard_normal(2000)
    a_gpu = st.COO.from_numpy(dense, device=cuda)
    a_cpu = st.COO.from_numpy(dense, device="cpu")
    reset_launch_counts()
    x, info, it = linalg.cg(a_gpu, b, tol=1e-10, return_iters=True)
    assert LAUNCHES["row_ell_spmv"] == it + 1 and info == 0 and it > 5
    x_cpu, info_cpu, it_cpu = linalg.cg(a_cpu, b, tol=1e-10, return_iters=True)
    assert (info, it) == (info_cpu, it_cpu) and x.device.type == "cuda"
    _close(x, x_cpu, 1e-12)


def test_dia_route_on_the_card_equals_the_cpu_run(cuda):
    a_gpu = _poisson(48, cuda)
    a_cpu = a_gpu.to("cpu")
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(48 * 48))
    reset_launch_counts()
    x, info, it = linalg.cg(a_gpu, b.to(cuda), tol=1e-10, return_iters=True)
    assert {k: v for k, v in LAUNCHES.items() if v} == {"dia_spmv": it + 1}  # D1 a matvec, no other kernel
    assert a_gpu.peek_layout("dia", (64, 8.0)).offsets == (-48, -1, 0, 1, 48)
    x_cpu, info_cpu, it_cpu = linalg.cg(a_cpu, b, tol=1e-10, return_iters=True)
    assert (info, it) == (info_cpu, it_cpu) == (0, it)
    _close(x, x_cpu, 1e-12)
    xg, infog = linalg.gmres(a_gpu, b.to(cuda), tol=1e-10, restart=30)
    xg_cpu, infog_cpu = linalg.gmres(a_cpu, b, tol=1e-10, restart=30)
    assert infog == infog_cpu == 0
    _close(xg, xg_cpu, 1e-10)


@pytest.mark.parametrize("solver", ["gmres", "eigsh"])
def test_float32_basis_products_ignore_allow_tf32(cuda, solver):
    dense = _spd(3000, 0.002, 3, np.float32)
    if solver == "gmres":  # nonsymmetric
        dense[np.triu_indices(3000, 1)] *= 1.1
    a = st.COO.from_numpy(dense, device=cuda)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(3000).astype(np.float32)).to(cuda)

    def run():
        if solver == "gmres":
            x, info = linalg.gmres(a, b, tol=1e-5, restart=30)
            return (x,)
        return linalg.eigsh(a, k=3, key=1)

    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        got = run()
        assert torch.backends.cuda.matmul.allow_tf32  # restored after each product block
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
