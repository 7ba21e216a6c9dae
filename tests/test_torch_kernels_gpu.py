"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). Tolerances: the
kernel and the plain version sum each row in another order; float64 at
rtol=1e-12 and float32 at rtol=1e-5, atol=1e-6, on positive values (no
cancellation).
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import _cuda, row_ell

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _problem(case, seed):
    rng = np.random.default_rng(seed)
    if case == "zipf":
        m, k = 600, 500
        raw = rng.zipf(1.4, size=20_000)
        rows = raw[raw <= m] - 1
        lin = np.unique(rows * k + rng.integers(0, k, size=rows.size))
    elif case == "empty":
        m, k, lin = 10, 7, np.zeros(0, dtype=np.int64)
    elif case == "k_ragged":
        m, k = 300, 1001
        lin = np.unique(rng.integers(0, m * k, size=3000))
    elif case == "zero_rows":
        m, k = 400, 300
        lin = np.unique(rng.integers(0, m * k, size=3000))
        lin = lin[(lin // k) % 3 == 0]
    else:  # hub
        m, k = 100, 3000
        lin = np.unique(np.concatenate([5 * k + rng.choice(k, 1500, replace=False), rng.integers(0, m * k, 200)]))
    return lin // k, lin % k, rng.random(lin.size), m, k


CASES = ["zipf", "empty", "k_ragged", "zero_rows", "hub"]
DTYPES = [torch.float32, torch.float64]


def _layout(case, dt, cuda, group=16):
    rows, cols, vals, m, k = _problem(case, CASES.index(case))
    np_dt = np.float32 if dt == torch.float32 else np.float64
    return row_ell.build_row_ell(rows, cols, vals.astype(np_dt), m, k, group=group, device=cuda), m, k


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [128, 37, 1])
def test_spmm_kernel_matches_plain(cuda, case, dt, n):
    re, m, k = _layout(case, dt, cuda)
    b = torch.rand((k, n), dtype=dt, device=cuda)
    got = row_ell.row_ell_spmm(re, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, row_ell._spmm_plain(re, b), **TOL[dt])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("with_y", [False, True])
def test_spmv_kernel_matches_plain(cuda, case, dt, with_y):
    re, m, k = _layout(case, dt, cuda)
    x = torch.rand(k, dtype=dt, device=cuda)
    y = torch.rand(m, dtype=dt, device=cuda) if with_y else None
    got = row_ell.row_ell_spmv(re, x, y=y)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, row_ell._spmv_plain(re, x, y), **TOL[dt])


@pytest.mark.parametrize("group", [0, 8])
def test_kernels_take_every_layout(cuda, group):
    re, m, k = _layout("zipf", torch.float64, cuda, group=group)
    b = torch.rand((k, 64), dtype=torch.float64, device=cuda)
    torch.testing.assert_close(row_ell.row_ell_spmm(re, b), row_ell._spmm_plain(re, b), **TOL[torch.float64])
    x = b[:, 0].contiguous()
    torch.testing.assert_close(row_ell.row_ell_spmv(re, x), row_ell._spmv_plain(re, x), **TOL[torch.float64])


def test_unaligned_dense_operand(cuda):
    re, m, k = _layout("zipf", torch.float32, cuda)
    base = torch.rand(k * 128 + 1, device=cuda)
    b = base[1:].view(k, 128)  # 4-byte aligned only: the one-value-per-lane form
    torch.testing.assert_close(row_ell.row_ell_spmm(re, b), row_ell._spmm_plain(re, b), **TOL[torch.float32])


def test_launch_counters_and_main_path(cuda):
    rng = np.random.default_rng(0)
    x = rng.random((500, 400)) * (rng.random((500, 400)) < 0.05)
    a = st.COO.from_numpy(x, device=cuda)
    b = rng.random((400, 32))
    v, y = rng.random(400), rng.random(500)
    _cuda.reset_launch_counts()
    out_m = a @ b
    out_v = a @ v
    out_a = st.matvec_add(a, v, y)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {"row_ell_spmv": 2, "row_ell_spmm": 1}
    np.testing.assert_allclose(out_m.cpu().numpy(), x @ b, rtol=1e-12)
    np.testing.assert_allclose(out_v.cpu().numpy(), x @ v, rtol=1e-12)
    np.testing.assert_allclose(out_a.cpu().numpy(), x @ v + y, rtol=1e-12)
    cpu = st.COO.from_numpy(x, device="cpu")
    torch.testing.assert_close(out_m.cpu(), cpu @ b, rtol=1e-12, atol=0.0)


def test_wrapper_refuses_mismatched_inputs(cuda):
    re, m, k = _layout("zipf", torch.float32, cuda)
    with pytest.raises(ValueError):
        row_ell.row_ell_spmm(re, torch.rand((k, 4)))  # on the CPU, layout on the card
    with pytest.raises(TypeError):
        _cuda.spmv(re, torch.rand(k, dtype=torch.float64, device=cuda), None, torch.empty(m, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.spmm(re, torch.rand((4, k), device=cuda).T, torch.empty((m, 4), device=cuda))
