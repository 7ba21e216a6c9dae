"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). Tolerances: the
kernel and the plain version sum each row in another order; row-ELL float64
at rtol=1e-12 and float32 at rtol=1e-5, atol=1e-6, on positive values (no
cancellation); BSR on unit-normal values float32 at rtol=atol=1e-4, float64
at rtol=1e-10, atol=1e-12, bfloat16 (one final rounding each side) at
rtol=atol=2e-2.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import _cuda, bsr, row_ell

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
    assert _cuda.LAUNCHES == {"row_ell_spmv": 2, "row_ell_spmm": 1, "bsr_spmm": 0, "bsr_spmm2": 0, "bsr_sddmm": 0}
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


BSR_TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-4),
    torch.float64: dict(rtol=1e-10, atol=1e-12),
    torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
}
BSR_DTYPES = [torch.float32, torch.float64, torch.bfloat16]
# (m, k, density, block shape, pad_run_multiple): tests/test_bsr.py's ragged
# problem, the empty matrix, a padded layout, a small block shape
BSR_CASES = {
    "test_bsr": (500, 600, 0.02, (128, 128), 1),
    "empty": (128, 128, 0.0, (128, 128), 1),
    "pad2": (500, 600, 0.02, (128, 128), 2),
    "block_32x64": (200, 300, 0.03, (32, 64), 1),
}


def _bsr(case, dt, cuda):
    m, k, density, bs, pad = BSR_CASES[case]
    rng = np.random.default_rng(list(BSR_CASES).index(case))
    lin = np.unique(rng.integers(0, m * k, size=int(m * k * density)))
    layout = bsr.build_bsr(lin // k, lin % k, rng.standard_normal(lin.size), (m, k), bs, pad, device=cuda)
    return layout._replace(blocks=layout.blocks.to(dt)), m, k


@pytest.mark.parametrize("case", list(BSR_CASES))
@pytest.mark.parametrize("dt", BSR_DTYPES)
@pytest.mark.parametrize("n,transposed", [(200, False), (37, False), (37, True)])
def test_bsr_spmm_kernel_matches_plain(cuda, case, dt, n, transposed):
    a, m, k = _bsr(case, dt, cuda)
    dense = torch.randn((n, k) if transposed else (k, n), device=cuda).to(dt)
    dense = dense.T if transposed else dense
    kernels = [bsr.bsr_spmm_kernel] + ([bsr.bsr_spmm_kernel2] if BSR_CASES[case][4] == 2 else [])
    want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m)
    for fn in kernels:
        got = fn(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m, row_ptr=a.row_ptr)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **BSR_TOL[dt])


@pytest.mark.parametrize("case", ["test_bsr", "block_32x64"])
@pytest.mark.parametrize("dt", BSR_DTYPES)
@pytest.mark.parametrize("b", [96, 37])
def test_bsr_sddmm_kernel_matches_plain(cuda, case, dt, b):
    a, m, k = _bsr(case, dt, cuda)
    lhs = torch.randn((b, m), device=cuda).to(dt).T  # a transposed view, as the wgrad's gradient
    rhs = torch.randn((b, k), device=cuda).to(dt)
    got = bsr.bsr_sddmm_kernel(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
    torch.cuda.synchronize()
    want = bsr.bsr_sddmm_plain(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
    torch.testing.assert_close(got, want, **BSR_TOL[dt])


def test_block_sparse_linear_trains_through_the_kernels(cuda):
    from sparse_tpu_torch import nn as tnn

    layer = tnn.BlockSparseLinear(384, 256, 0.5, generator=torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn((16, 384), device=cuda, requires_grad=True)
    _cuda.reset_launch_counts()
    y = layer(x)
    (y * y).sum().backward()
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["bsr_spmm"], _cuda.LAUNCHES["bsr_sddmm"]) == (2, 1)
    p = layer.params()
    w = bsr.BSR(p.blocks.detach().double(), p.block_rows, p.block_cols, (256, 384), (128, 128), p.row_ptr).todense()
    torch.testing.assert_close(y.double(), x.double() @ w.T + p.bias.double(), rtol=1e-4, atol=1e-4)
    g = 2 * y.detach().double()
    torch.testing.assert_close(x.grad.double(), g @ w, rtol=1e-4, atol=1e-4)
    dw = g.T @ x.detach().double()
    rows, cols = p.block_rows.long(), p.block_cols.long()
    want = torch.stack([dw[r * 128 : (r + 1) * 128, c * 128 : (c + 1) * 128] for r, c in zip(rows.tolist(), cols.tolist())])
    torch.testing.assert_close(layer.blocks.grad.double(), want, rtol=1e-4, atol=1e-4)


def test_bsr_launchers_refuse_mismatched_inputs(cuda):
    a, m, k = _bsr("test_bsr", torch.float32, cuda)
    with pytest.raises(ValueError):
        bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, a.blocks, torch.rand((k, 4)), n_rows=m)  # dense on the CPU
    with pytest.raises(TypeError):
        bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, a.blocks, torch.rand((k, 4), dtype=torch.float64, device=cuda), n_rows=m)
    # runs of 1 and 3 blocks: an even total is not enough
    br = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=cuda)
    bc = torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="even length"):
        bsr.bsr_spmm_kernel2(br, bc, torch.ones((4, 2, 2), device=cuda), torch.ones((6, 1), device=cuda), n_rows=4)
