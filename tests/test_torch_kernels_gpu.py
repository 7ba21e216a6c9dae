"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). Tolerances: the
kernel and the plain version sum each row in another order; row-ELL float64
at rtol=1e-12 and float32 at rtol=1e-5, atol=1e-6, on positive values (no
cancellation); BSR on unit-normal values float32 at rtol=atol=1e-4, float64
at rtol=1e-10, atol=1e-12, bfloat16 (one final rounding each side) at
rtol=atol=2e-2; MTTKRP on positive values at the row-ELL tolerances, for
every table type (the bf16 tables' products are exact in float32 on both
sides, so only the order of the row sum differs). The probe kernels
(csrc/probes.cu): the picks (E1, p1, p3) exactly; the sums (p2, p4, g1-g3)
of positive values at rtol=1e-4, atol=1e-3, as chip_smoke.py holds them.
The SDDMM at max|got - want| / max|want| <= 1e-5 in float32 (3xTF32) and
1e-10 in float64, bfloat16 at the BSR tolerance.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import _cuda, bsr, dot, ell, row_ell

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
    assert _cuda.LAUNCHES == {**{k: 0 for k in _cuda.LAUNCHES}, "row_ell_spmv": 2, "row_ell_spmm": 1}
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


# ---------------------------------------------------------------- K2's staged kernel
SMOKE_CASES = ["zipf", "empty", "k_ragged", "zero_rows", "hub", "bench"]


def _smoke_layout(case, dt, cuda):
    """chip_smoke.py's matrices (its ``problem``), bench included, with
    positive values."""
    from chip_smoke import problem

    rng = np.random.default_rng(SMOKE_CASES.index(case))
    rows, cols, m, k = problem(case, rng)
    vals = rng.random(rows.size).astype(np.float32 if dt == torch.float32 else np.float64)
    return row_ell.build_row_ell(rows, cols, vals, m, k, device=cuda), m, k


def _both_kernels(re, b):
    out = [_cuda.spmm(re, b, b.new_empty((re.n_rows, b.shape[1])), kernel=kn) for kn in ("staged", "warp")]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("case", SMOKE_CASES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [128, 37])
def test_spmm_staged_kernel_equals_warp_kernel(cuda, case, dt, n):
    re, m, k = _smoke_layout(case, dt, cuda)
    b = torch.rand((k, n), dtype=dt, device=cuda)
    if case == "empty":  # no tiers: the warp kernel's, and the staged one refuses it
        assert not _cuda.row_ell_staged_layout(re)
        with pytest.raises(ValueError, match="grouped"):
            _cuda.spmm(re, b, torch.empty((m, n), dtype=dt, device=cuda), kernel="staged")
        assert not row_ell.row_ell_spmm(re, b).any()
        return
    staged, warp = _both_kernels(re, b)
    assert torch.equal(staged, warp)
    torch.testing.assert_close(staged, row_ell._spmm_plain(re, b), **TOL[dt])
    _cuda.reset_launch_counts()
    assert torch.equal(row_ell.row_ell_spmm(re, b), staged)
    assert _cuda.LAUNCHES["row_ell_spmm"] == 1


@pytest.mark.parametrize("width", [64, 65, 130, 1000])
@pytest.mark.parametrize("dt", DTYPES)
def test_spmm_staged_rows_wider_than_a_stage(cuda, width, dt):
    # row 3 holds `width` entries (one or several stages), the others a few
    rng = np.random.default_rng(width)
    m, k = 300, 2000
    lin = np.unique(np.concatenate([3 * k + rng.choice(k, width, replace=False), rng.integers(0, m * k, 900)]))
    vals = rng.random(lin.size).astype(np.float32 if dt == torch.float32 else np.float64)
    re = row_ell.build_row_ell(lin // k, lin % k, vals, m, k, device=cuda)
    plan = _cuda.row_ell_plan(re, 64, _cuda._WIDE[dt], dt)
    assert max(c.shape[1] for c, _ in re.tiers) >= width and plan.chunks > plan.units
    b = torch.rand((k, 64), dtype=dt, device=cuda)
    staged, warp = _both_kernels(re, b)
    assert torch.equal(staged, warp)
    torch.testing.assert_close(staged, row_ell._spmm_plain(re, b), **TOL[dt])


def test_spmm_staged_layout_with_fewer_units_than_ctas(cuda):
    # 40 rows with entries (3 groups), 5,000 rows without: the grid is the
    # zero rows' CTAs, most of which get no unit
    rng = np.random.default_rng(5)
    m, k = 5040, 300
    rows = np.repeat(np.arange(40) * 126, 5)
    cols = rng.integers(0, k, rows.size)
    lin = np.unique(rows * k + cols)
    re = row_ell.build_row_ell(lin // k, lin % k, rng.random(lin.size).astype(np.float32), m, k, device=cuda)
    plan = _cuda.row_ell_plan(re, 128, 4, torch.float32)
    assert plan.units < torch.cuda.get_device_properties(cuda).multi_processor_count and plan.zero_positions == m - 40
    b = torch.rand((k, 128), device=cuda)
    staged, warp = _both_kernels(re, b)
    assert torch.equal(staged, warp)
    torch.testing.assert_close(staged, row_ell._spmm_plain(re, b), **TOL[torch.float32])


def test_spmm_staged_kernel_refuses_misaligned_indices(cuda):
    re, m, k = _layout("zipf", torch.float32, cuda)
    b = torch.rand((k, 128), device=cuda)
    n_cols = re.flat_cols.numel()
    buf = torch.empty(n_cols + 1, dtype=torch.int32, device=cuda)
    buf[1:] = re.flat_cols
    shifted = re._replace(flat_cols=buf[1:])  # the same indices, 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16 bytes"):
        row_ell.row_ell_spmm(shifted, b)
    with pytest.raises(ValueError, match="16 bytes"):
        _cuda.spmm(shifted, b, torch.empty((m, 128), device=cuda), kernel="staged")
    got = _cuda.spmm(shifted, b, torch.empty((m, 128), device=cuda), kernel="warp")
    torch.testing.assert_close(got, row_ell._spmm_plain(re, b), **TOL[torch.float32])
    legacy, _, _ = _layout("zipf", torch.float32, cuda, group=0)
    with pytest.raises(ValueError, match="grouped"):
        _cuda.spmm(legacy, b, torch.empty((m, 128), device=cuda), kernel="staged")
    with pytest.raises(ValueError, match="kernel must be"):
        _cuda.spmm(re, b, torch.empty((m, 128), device=cuda), kernel="fast")


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


# the SDDMM against its plain version, max|got - want| / max|want|: float32
# (3xTF32 on the tensor cores) and float64 (FFMA) near their own rounding;
# bfloat16 at BSR_TOL (one final rounding each side)
SDDMM_NORM_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


def _sddmm_operand(rows, depth, layout, dt, cuda):
    """An SDDMM operand of ``rows`` MN values and ``depth`` k values, as a
    ``(rows, depth)`` view: "mn" with the MN axis contiguous (as the layer's
    ``grad_y.T`` and ``x``), "k" with the k axis contiguous, both with rows
    padded to 32 values, or "misaligned" (k contiguous, a base one value off
    16 bytes, which the wrapper copies)."""
    pad = 32
    if layout == "mn":
        return torch.randn((depth, -(-rows // pad) * pad), device=cuda).to(dt)[:, :rows].T
    if layout == "k":
        return torch.randn((rows, -(-depth // pad) * pad), device=cuda).to(dt)[:, :depth]
    return torch.randn(rows * depth + 1, device=cuda).to(dt)[1:].view(rows, depth)


def _check_sddmm(got, want, dt):
    assert got.dtype == want.dtype == dt and got.shape == want.shape
    if dt == torch.bfloat16:
        torch.testing.assert_close(got, want, **BSR_TOL[dt])
    elif want.abs().max() == 0:
        assert not got.any()
    else:
        assert float((got.double() - want.double()).abs().max() / want.double().abs().max()) <= SDDMM_NORM_TOL[dt]


@pytest.mark.parametrize("case", ["test_bsr", "block_32x64", "pad2"])
@pytest.mark.parametrize("dt", BSR_DTYPES)
@pytest.mark.parametrize("b", [96, 37, 0])  # 37: a contraction off the 32-value stage; 0: zero blocks
@pytest.mark.parametrize("layout", ["mn", "k", "misaligned"])
def test_bsr_sddmm_kernel_matches_plain(cuda, case, dt, b, layout):
    a, m, k = _bsr(case, dt, cuda)
    lhs = _sddmm_operand(m, b, layout, dt, cuda)
    rhs = _sddmm_operand(k, b, layout, dt, cuda).T
    _cuda.reset_launch_counts()
    got = bsr.bsr_sddmm_kernel(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
    torch.cuda.synchronize()
    # a launch of the tensor-core kernel (float32, bfloat16) or the FFMA one (float64); none for B = 0
    assert _cuda.LAUNCHES["bsr_sddmm"] == (0 if b == 0 and dt != torch.float64 else 1)
    want = bsr.bsr_sddmm_plain(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
    _check_sddmm(got, want, dt)
    if case == "pad2":  # pad blocks are computed like any other and get a nonzero product
        pads = ~a.blocks.reshape(a.blocks.shape[0], -1).any(dim=1)
        assert pads.any() and (b == 0 or got[pads].abs().max() > 0)
    assert torch.equal(bsr.bsr_sddmm_kernel(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape), got)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_shape", [(128, 128), (256, 192), (48, 40)])
def test_bsr_sddmm_tc_edges(cuda, dt, block_shape):
    # negative indices and blocks past M or K are zero blocks; blocks that
    # overhang M or K are masked; several 128 x 128 tiles per block
    bm, bn = block_shape
    m, k = 2 * bm + bm // 2, 3 * bn - bn // 3
    rows = torch.tensor([0, -1, 2, 1, 3, 2, 0], dtype=torch.int32, device=cuda)
    cols = torch.tensor([2, 0, 1, -1, 0, 2, 0], dtype=torch.int32, device=cuda)
    lhs = _sddmm_operand(m, 77, "mn", dt, cuda)
    rhs = _sddmm_operand(k, 77, "mn", dt, cuda).T
    got = bsr.bsr_sddmm_kernel(rows, cols, lhs, rhs, block_shape=block_shape)
    torch.cuda.synchronize()
    want = bsr.bsr_sddmm_plain(rows, cols, lhs, rhs, block_shape=block_shape)
    _check_sddmm(got, want, dt)
    assert not got[[1, 3, 4]].any()


def test_bsr_sddmm_layer_operands_mn_and_k_major_agree(cuda):
    # the layer's shapes at batch 512: grad_y.T and x as they come (MN-major),
    # and K-major copies of them
    from sparse_tpu_torch import nn as tnn

    layer = tnn.BlockSparseLinear(1024, 768, 0.25, generator=torch.Generator().manual_seed(1), device=cuda)
    p = layer.params()
    x = torch.randn((512, 1024), device=cuda)
    g = torch.randn((512, 768), device=cuda).T / 512**0.5
    want = bsr.bsr_sddmm_plain(p.block_rows, p.block_cols, g, x)
    outs = []
    for lhs, rhs in ((g, x), (g.contiguous(), x.T.contiguous().T)):
        assert _cuda.sddmm_tc_major(lhs, 0) is not None and _cuda.sddmm_tc_major(rhs, 1) is not None
        outs.append(bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, lhs, rhs))
        _check_sddmm(outs[-1], want, torch.float32)
    assert torch.equal(outs[0], outs[1])  # the same split and products either way


def test_bsr_spmm_vjp_holds_full_precision_under_tf32(cuda):
    # C1.3: the torch-op backward (the layer without a transposed layout) under
    # allow_tf32 = True: d_blocks on the 3xTF32 SDDMM, d_dense's bmm held at
    # full float32, both at 1e-5 against float64; the caller's flag restored
    a, m, k = _bsr("test_bsr", torch.float32, cuda)
    dense = torch.randn((k, 256), device=cuda)
    g = torch.randn((m, 256), device=cuda)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        blocks = a.blocks.clone().requires_grad_(True)
        d = dense.clone().requires_grad_(True)
        _cuda.reset_launch_counts()
        (bsr.bsr_spmm(a.block_rows, a.block_cols, blocks, d, m, a.row_ptr) * g).sum().backward()
        torch.cuda.synchronize()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert _cuda.LAUNCHES["bsr_sddmm"] == 1
    want_blocks = bsr.bsr_sddmm_plain(a.block_rows, a.block_cols, g.double(), dense.double().T)
    w64 = bsr.BSR(a.blocks.double(), a.block_rows, a.block_cols, (m, k), (128, 128), a.row_ptr).todense()
    want_dense = w64.T @ g.double()
    for got, want in ((blocks.grad, want_blocks), (d.grad, want_dense)):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5


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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["pad2", "long_run"])
def test_bsr_spmm_kernel2_equals_kernel_on_the_tensor_cores(cuda, dt, case):
    if case == "pad2":
        a, m, k = _bsr("pad2", dt, cuda)
    else:  # block-row 0 a run of 100 blocks (4 pieces), block-row 1 of 2
        rng = np.random.default_rng(32)
        m, k = 2 * 128, 100 * 128
        brow = np.concatenate([np.zeros(100, np.int64), [1, 1]])
        bcol = np.concatenate([np.arange(100), np.sort(rng.choice(100, 2, replace=False))])
        blocks = torch.as_tensor(rng.standard_normal((102, 128, 128)), device=cuda).to(dt)
        a = bsr.bsr_from_numpy(blocks, brow, bcol, (m, k), (128, 128), device=cuda)
    assert not bool((torch.diff(a.row_ptr) % 2).any())
    dense = torch.randn((200, k), device=cuda).to(dt).T
    _cuda.reset_launch_counts()
    two = bsr.bsr_spmm_kernel2(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m, row_ptr=a.row_ptr)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {**{k: 0 for k in _cuda.LAUNCHES}, "bsr_spmm2": 1}
    one = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m, row_ptr=a.row_ptr)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["bsr_spmm"] == 1
    assert torch.equal(two, one)
    want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m)
    tol = dict(rtol=1e-4, atol=1e-3) if (dt == torch.float32 and case == "long_run") else BSR_TOL[dt]
    torch.testing.assert_close(two, want, **tol)
    pieces = _cuda.run_pieces(a.row_ptr, _cuda.BSR_PIECE)
    scratch = (torch.empty_like(two), two.float(), _cuda.zeroed_tickets(cuda, 1))
    with pytest.raises(ValueError, match="bsr_spmm or bsr_spmm2"):
        _cuda.bsr_spmm_tc(a.blocks, a.block_cols, a.row_ptr, pieces, dense, *scratch, name="bsr_sddmm")


# (I, J, K, draws): a ragged I (three blocks and 44 rows), rows without
# entries, and one hub row with a run of several hundred slots
MTTKRP_CASES = {"ragged": (3 * 128 + 44, 50, 40, 6000), "hub": (300, 60, 70, 2000)}


def _tensor3(case, dt, cuda):
    I, J, K, draws = MTTKRP_CASES[case]
    rng = np.random.default_rng(list(MTTKRP_CASES).index(case))
    lin = rng.integers(0, I * J * K, draws)
    if case == "hub":
        lin = np.concatenate([lin, 7 * J * K + rng.choice(J * K, 700, replace=False)])
    lin = np.unique(lin)
    lin = lin[(lin // (J * K)) % 5 != 3]  # every fifth row empty
    coords = np.stack([lin // (J * K), (lin // K) % J, lin % K])
    return st.COO(coords, rng.random(lin.size).astype(np.float32 if dt == torch.float32 else np.float64), shape=(I, J, K), device=cuda)


def _mttkrp_factors(t, r, dt, cuda):
    g = torch.Generator(device="cpu").manual_seed(r)
    return tuple(torch.rand((n, r), generator=g, dtype=dt).to(cuda) for n in t.shape[1:])


@pytest.mark.parametrize("case", list(MTTKRP_CASES))
@pytest.mark.parametrize("dt,strategy", [(torch.float32, "exact"), (torch.float64, "exact"), (torch.float32, "bf16"), (torch.float64, "bf16")])
@pytest.mark.parametrize("r", [25, 32, 64])
def test_ell_mttkrp_kernel_matches_plain(cuda, case, dt, strategy, r):
    t = _tensor3(case, dt, cuda)
    c, d = _mttkrp_factors(t, r, dt, cuda)
    lay = ell.build_block_ell_3d(t.coords[0], t.coords[1], t.coords[2], t.data, t.shape[0], device=cuda)
    want = ell.ell_mttkrp_plain(*lay[:4], c, d, n_rows=t.shape[0], strategy=strategy)
    _cuda.reset_launch_counts()
    got = ell.ell_mttkrp(*lay[:4], c, d, n_rows=t.shape[0], strategy=strategy, order=lay.order, row_ptr=lay.row_ptr)
    bare = ell.ell_mttkrp(*lay[:4], c, d, n_rows=t.shape[0], strategy=strategy)  # runs sorted on the device
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ell_mttkrp"] == 2 and got.dtype == dt
    torch.testing.assert_close(got, want, **TOL[dt])
    assert torch.equal(bare, got)  # the same run order: deterministic to the bit


@pytest.mark.parametrize("case", list(MTTKRP_CASES))
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("r", [25, 32, 64])
def test_coo_mttkrp_kernel_matches_plain(cuda, case, dt, r):
    t = _tensor3(case, dt, cuda)
    c, d = _mttkrp_factors(t, r, dt, cuda)
    _cuda.reset_launch_counts()
    got = st.jitops.mttkrp(t, c, d)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["coo_mttkrp"] == 1 and got.dtype == dt
    torch.testing.assert_close(got, dot.mttkrp_plain(*t.coords, t.data, c, d, n_rows=t.shape[0]), **TOL[dt])
    # the block-ELL form sums each row's entries in the same order (its pad
    # slots add an exact 0 to local row 0 of each block)
    lay = ell.build_block_ell_3d(t.coords[0], t.coords[1], t.coords[2], t.data, t.shape[0], device=cuda)
    assert torch.equal(ell.ell_mttkrp(*lay[:4], c, d, n_rows=t.shape[0], order=lay.order, row_ptr=lay.row_ptr), got)


def test_mttkrp_kernels_on_empty_tensors(cuda):
    c, d = torch.ones((4, 3), device=cuda), torch.ones((5, 3), device=cuda)
    empty = [torch.empty(0, dtype=torch.int32, device=cuda) for _ in range(3)]
    lay = ell.build_block_ell_3d(*empty, torch.empty(0, device=cuda), 16, device=cuda)
    _cuda.reset_launch_counts()
    out = ell.ell_mttkrp(*lay[:4], c, d, n_rows=16, order=lay.order, row_ptr=lay.row_ptr)
    out_coo = dot.mttkrp(*empty, torch.empty(0, device=cuda), c, d, n_rows=16)
    torch.cuda.synchronize()
    assert out.shape == out_coo.shape == (16, 3) and not out.any() and not out_coo.any()
    assert (_cuda.LAUNCHES["ell_mttkrp"], _cuda.LAUNCHES["coo_mttkrp"]) == (1, 1)  # empty rows store zeros
    zero = ell.build_block_ell_3d(*empty, torch.empty(0, device=cuda), 0, device=cuda)
    assert ell.ell_mttkrp(*zero[:4], c, d, n_rows=0).shape == (0, 3)


def test_mttkrp_kernel_refuses_unsorted_rows(cuda):
    t = _tensor3("ragged", torch.float32, cuda)
    c, d = _mttkrp_factors(t, 32, torch.float32, cuda)
    ci, cj, ck = t.coords
    with pytest.raises(ValueError, match="sorted"):
        dot.mttkrp(ci.flip(0), cj, ck, t.data, c, d, n_rows=t.shape[0])
    with pytest.raises(IndexError):
        dot.mttkrp(ci, cj, ck, t.data, c[:10], d, n_rows=t.shape[0])
    ptr = torch.zeros(2, dtype=torch.int64, device=cuda)
    scratch = torch.empty(4096, device=cuda)
    with pytest.raises(TypeError):
        _cuda.mttkrp(ptr, ptr, None, cj, ck, t.data, c.double(), d.double(), torch.empty((1, 32), device=cuda), scratch, _cuda.zeroed_tickets(cuda, 64))


def _tail_tensor(dt, cuda):
    """A ragged last block of 20 rows padded to the cap of full blocks (its
    row 0 takes every pad slot) and a hub row of 2,400 entries: both runs
    longer than 4 pieces."""
    I, J, K = 2 * 128 + 20, 60, 70
    rng = np.random.default_rng(21)
    lin = np.unique(np.concatenate([rng.integers(0, 256 * J * K, 9000), rng.integers(256 * J * K, I * J * K, 300)]))
    lin = np.union1d(lin[lin // (J * K) != 9], 9 * J * K + rng.choice(J * K, 2400, replace=False))
    coords = np.stack([lin // (J * K), (lin // K) % J, lin % K])
    return st.COO(coords, rng.random(lin.size).astype(np.float32 if dt == torch.float32 else np.float64), shape=(I, J, K), device=cuda)


@pytest.mark.parametrize("dt,strategy", [(torch.float32, "exact"), (torch.float64, "exact"), (torch.float32, "bf16"), (torch.float64, "bf16")])
@pytest.mark.parametrize("r", [25, 32, 64])
def test_mttkrp_tail_runs_split_over_warps(cuda, dt, strategy, r):
    t = _tail_tensor(dt, cuda)
    c, d = _mttkrp_factors(t, r, dt, cuda)
    I = t.shape[0]
    lay = ell.build_block_ell_3d(t.coords[0], t.coords[1], t.coords[2], t.data, I, device=cuda)
    runs = torch.diff(lay.row_ptr[: I + 1])
    assert int(runs[9]) > 4 * _cuda.MTTKRP_PIECE and int(runs[256]) > 4 * _cuda.MTTKRP_PIECE
    assert int(lay.pieces[I]) >= 10  # both long runs are cut
    want = ell.ell_mttkrp_plain(*lay[:4], c, d, n_rows=I, strategy=strategy)
    _cuda.reset_launch_counts()
    got = ell.ell_mttkrp(*lay[:4], c, d, n_rows=I, strategy=strategy, order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces)
    bare = ell.ell_mttkrp(*lay[:4], c, d, n_rows=I, strategy=strategy)  # runs and pieces derived on the device
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {**{k: 0 for k in _cuda.LAUNCHES}, "ell_mttkrp": 2}
    torch.testing.assert_close(got, want, **TOL[dt])
    assert torch.equal(bare, got)
    again = ell.ell_mttkrp(*lay[:4], c, d, n_rows=I, strategy=strategy, order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces)
    assert torch.equal(again, got)  # the tickets came back to zero: the same bits
    if strategy == "exact":  # the sorted-COO form, split at the same offsets, to the bit
        _cuda.reset_launch_counts()
        coo = dot.mttkrp(*t.coords, t.data, c, d, n_rows=I)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES == {**{k: 0 for k in _cuda.LAUNCHES}, "coo_mttkrp": 1}
        assert torch.equal(coo, got)


@pytest.mark.parametrize("piece", [1, 2])
def test_mttkrp_more_pieces_than_front_warps(cuda, piece):
    # every run of more than `piece` slots split: thousands of pieces, so
    # each front warp strides over several of them
    t = _tensor3("ragged", torch.float32, cuda)
    c, d = _mttkrp_factors(t, 40, torch.float32, cuda)
    I, ci, cj, ck = t.shape[0], *t.coords
    row_ptr = torch.searchsorted(ci.long(), torch.arange(I + 1, device=cuda))
    pieces = _cuda.run_pieces(row_ptr, piece)
    n_front = _cuda.front_bound(t.nnz, I, piece)
    assert int(pieces[I]) > (2048 if piece == 1 else 1000)
    out = torch.empty((I, 40), device=cuda)
    partial = torch.empty(n_front * 40, device=cuda)
    tickets = _cuda.zeroed_tickets(cuda, n_front * 2)
    _cuda.mttkrp(row_ptr, pieces, None, cj, ck, t.data, c, d, out, partial, tickets, piece=piece)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, dot.mttkrp_plain(ci, cj, ck, t.data, c, d, n_rows=I), **TOL[torch.float32])
    assert not tickets.any()


def _bsr_long_run(dt, cuda, n_blocks_row0=100):
    """Block-row 0 holds a run of 100 blocks (4 pieces of 32), the others a few."""
    bm = bn = 128
    m, k = 3 * bm, n_blocks_row0 * bn
    rng = np.random.default_rng(31)
    cols0 = np.arange(n_blocks_row0)
    other = rng.choice(n_blocks_row0, 6, replace=False)
    brow = np.concatenate([np.zeros(n_blocks_row0, np.int64), [1] * 3, [2] * 3])
    bcol = np.concatenate([cols0, np.sort(other[:3]), np.sort(other[3:])])
    blocks = torch.as_tensor(rng.standard_normal((brow.size, bm, bn)), device=cuda).to(dt)
    a = bsr.bsr_from_numpy(blocks, brow, bcol, (m, k), (bm, bn), device=cuda)
    return a, m, k


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [512, 37])
def test_bsr_spmm_long_run_split_into_pieces(cuda, dt, n):
    a, m, k = _bsr_long_run(dt, cuda)
    runs = torch.diff(a.row_ptr)
    assert int(runs[0]) >= 3 * _cuda.BSR_PIECE
    dense = torch.randn((n, k), device=cuda).to(dt).T  # K-major, as the layer's x.T
    want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m)
    _cuda.reset_launch_counts()
    got = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m, row_ptr=a.row_ptr)
    again = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, a.blocks, dense, n_rows=m, row_ptr=a.row_ptr)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {**{k: 0 for k in _cuda.LAUNCHES}, "bsr_spmm": 2}
    # a 12,800-long contraction of unit normals: sums of about 113, so the f32 limit scales up
    tol = dict(rtol=1e-4, atol=1e-3) if dt == torch.float32 else BSR_TOL[dt]
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(again, got)  # deterministic: pieces summed in order


@pytest.mark.parametrize("run_blocks", [16, 51])
def test_bsr_spmm_f32_is_3xtf32_not_one_tf32_pass(cuda, run_blocks):
    # the layer's contraction lengths (2,048 and 6,528) against a float64
    # oracle at 1e-5 normalised: one TF32 pass misses it by about 30x
    a, m, k = _bsr_long_run(torch.float32, cuda, run_blocks)
    x = torch.randn((256, k), device=cuda)
    got = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, a.blocks, x.T, n_rows=m, row_ptr=a.row_ptr)
    w = bsr.BSR(a.blocks.double(), a.block_rows, a.block_cols, (m, k), (128, 128), a.row_ptr).todense()
    want = w @ x.T.double()
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    hi_w = bsr.BSR(bsr.tf32_split(a.blocks)[0], a.block_rows, a.block_cols, (m, k), (128, 128), a.row_ptr).todense()
    one_pass = hi_w.double() @ bsr.tf32_split(x)[0].T.double()
    assert float((one_pass - want).abs().max() / want.abs().max()) > 1e-5


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["k_major", "n_major", "offset_view", "blocks_t_view"])
def test_bsr_spmm_takes_every_operand_layout(cuda, dt, layout):
    a, m, k = _bsr("test_bsr", dt, cuda)
    blocks = a.blocks
    base = torch.randn((64, k), device=cuda).to(dt)
    dense = {
        "k_major": base.T,  # x.T of a row-major x: read in place
        "n_major": base.T.contiguous(),  # copied into K-major by the wrapper
        "offset_view": torch.randn((64 * k + 1,), device=cuda).to(dt)[1:].view(64, k).T,  # misaligned base
        "blocks_t_view": base.T,
    }[layout]
    if layout == "blocks_t_view":  # an M-major blocks view: copied into K-major
        blocks = blocks.transpose(1, 2).contiguous().transpose(1, 2)
    want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, blocks, dense, n_rows=m)
    got = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, blocks, dense, n_rows=m, row_ptr=a.row_ptr)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **BSR_TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_bsr_spmm_pads_a_block_width_off_the_stage_grid(cuda, dt):
    # 48 x 40 blocks: bm below a warpgroup's 64 rows, bn not a whole stage,
    # K = 300 ragged against bn
    rng = np.random.default_rng(41)
    m, k = 200, 300
    lin = np.unique(rng.integers(0, m * k, 2000))
    a = bsr.build_bsr(lin // k, lin % k, rng.standard_normal(lin.size), (m, k), (48, 40), device=cuda)
    blocks = a.blocks.to(dt)
    for dense in (torch.randn((37, k), device=cuda).to(dt).T, torch.randn((k, 130), device=cuda).to(dt)):
        want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, blocks, dense, n_rows=m)
        got = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, blocks, dense, n_rows=m, row_ptr=a.row_ptr)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **BSR_TOL[dt])


def test_bsr_tc_launcher_refuses_what_its_kernel_does_not_take(cuda):
    a, m, k = _bsr("test_bsr", torch.float32, cuda)
    cols = a.block_cols
    pieces = _cuda.run_pieces(a.row_ptr, _cuda.BSR_PIECE)
    _, n_partial, n_tickets = _cuda.bsr_tc_scratch(a.blocks.shape[0], a.row_ptr.shape[0] - 1, 128, 64)
    partial, tickets = torch.empty(n_partial, device=cuda), _cuda.zeroed_tickets(cuda, n_tickets)
    out = torch.empty((m, 64), device=cuda)
    with pytest.raises(ValueError, match="K-major"):  # an N-major dense operand
        _cuda.bsr_spmm_tc(a.blocks, cols, a.row_ptr, pieces, torch.randn((k, 64), device=cuda), out, partial, tickets)
    with pytest.raises(TypeError):
        _cuda.bsr_spmm_tc(a.blocks.double(), cols, a.row_ptr, pieces, torch.randn((64, k), device=cuda).double().T, out.double(), partial, tickets)
    with pytest.raises(ValueError, match="smaller"):
        _cuda.bsr_spmm_tc(a.blocks, cols, a.row_ptr, pieces, torch.randn((64, k), device=cuda).T, out, partial[:10], tickets)
    # the SDDMM: float64 is the FFMA kernel's, float32 the tensor cores', and a
    # misaligned operand goes through the wrapper's copy
    lhs, rhs, d_out = torch.randn((m, 40), device=cuda), torch.randn((40, k), device=cuda), torch.empty_like(a.blocks)
    with pytest.raises(TypeError, match="tensor cores"):
        _cuda.bsr_sddmm(a.block_rows, cols, lhs, rhs, d_out)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _cuda.bsr_sddmm_tc(a.block_rows, cols, lhs.double(), rhs.double(), d_out.double())
    with pytest.raises(ValueError, match="stride 1"):
        _cuda.bsr_sddmm_tc(a.block_rows, cols, torch.randn(m * 40 + 1, device=cuda)[1:].view(m, 40), rhs, d_out)
    with pytest.raises(ValueError, match="layout"):
        _cuda.bsr_sddmm_tc(a.block_rows[1:], cols, lhs, rhs, d_out)


# ---------------------------------------------------------------- probes (csrc/probes.cu)
PROBE_SUMS = dict(rtol=1e-4, atol=1e-3)


def _probe_gen(seed):
    return np.random.default_rng(seed)


def _rand(rng, shape, cuda):
    return torch.as_tensor(rng.random(shape, dtype=np.float32), device=cuda)


def _ints(rng, high, shape, cuda):
    return torch.as_tensor(rng.integers(0, high, size=shape, dtype=np.int32), device=cuda)


@pytest.mark.parametrize("hilo", [True, False])
@pytest.mark.parametrize("n", [4096, 1001, 1])
def test_spmv_products_kernel_equals_plain(cuda, hilo, n):
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1

    rng = _probe_gen(n)
    x2 = e1.make_table(_rand(rng, 65536, cuda), hilo)
    cols = _ints(rng, 65536, n, cuda)
    cols[: min(n, 3)] = torch.tensor([-5, 65536, 1 << 30][: min(n, 3)], dtype=torch.int32, device=cuda)
    data = _rand(rng, n, cuda)
    _cuda.reset_launch_counts()
    got = e1.products(x2, cols, data)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["spmv_products"] == 1
    assert torch.equal(got, e1.products_plain(x2, cols, data))


@pytest.mark.parametrize("table_h,rows", [(512, 18432 // 16), (8192, 37), (300, 1)])
def test_lane_gather_kernel_equals_plain(cuda, table_h, rows):
    from sparse_tpu_torch.experiments import pallas_vmem as v

    rng = _probe_gen(rows)
    table, idx = _rand(rng, (table_h, 128), cuda), _ints(rng, table_h, (rows, 128), cuda)
    got = v.lane_gather(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, v.lane_gather_plain(table, idx))


@pytest.mark.parametrize("T,n_blocks", [(512, 5), (8192, 2), (200, 3), (65, 1), (1, 4)])
def test_lane_gather_blocksum_kernel_matches_plain(cuda, T, n_blocks):
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2

    rng = _probe_gen(T)
    table, idx = _rand(rng, (T, 128), cuda), _ints(rng, T, (n_blocks * T, 128), cuda)
    got = v2.lane_gather_blocksum(table, idx, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, v2.lane_gather_blocksum_plain(table, idx, T), **PROBE_SUMS)
    # the tickets return to zero: a second launch on the same scratch gives the same bits
    out, partial, tickets = v2._blocksum_buffers(n_blocks, T, cuda)
    for _ in range(3):
        _cuda.lane_gather_blocksum(table, idx, T, out, partial, tickets)
        torch.cuda.synchronize()
        assert torch.equal(out, got) and not tickets.any()


@pytest.mark.parametrize("strip_h,n_seg,per_step", [(8192, 9, 1024), (256, 5, 37), (100, 7, 1), (512, 2, 5000)])
def test_row_gather_sum_kernel_matches_plain(cuda, strip_h, n_seg, per_step):
    from sparse_tpu_torch.experiments import pallas_vmem as v

    rng = _probe_gen(per_step)
    strip, idx = _rand(rng, (strip_h, 128), cuda), _ints(rng, strip_h, n_seg * per_step, cuda)
    got = v.row_gather_sum(strip, idx, per_step)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, v.row_gather_sum_plain(strip, idx, per_step), **PROBE_SUMS)


@pytest.mark.parametrize("strip_h,n", [(512, 4096), (8192, 37), (3, 1)])
def test_row_pick_bf16_kernel_equals_plain(cuda, strip_h, n):
    from sparse_tpu_torch.experiments import pallas_vmem as v

    rng = _probe_gen(n)
    strip = torch.as_tensor(rng.standard_normal((strip_h, 128), dtype=np.float32), device=cuda)
    idx = _ints(rng, strip_h, n, cuda)
    got = v.row_pick_bf16(strip, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, v.row_pick_bf16_plain(strip, idx))


@pytest.mark.parametrize("T,n_blocks", [(8192, 3), (2000, 2), (37, 5)])
def test_row_pick_blocksum_kernel_matches_plain(cuda, T, n_blocks):
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2

    rng = _probe_gen(T)
    table, cols = _rand(rng, (T, 128), cuda), _ints(rng, T, n_blocks * T, cuda)
    got = v2.row_pick_blocksum(table, cols, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, v2.row_pick_blocksum_plain(table, cols, T), **PROBE_SUMS)


@pytest.mark.parametrize("n_cells,W,table_h", [(2, 4, 8192), (1, 3, 500), (3, 1, 8192)])
def test_pick_scale_wsum_kernel_matches_plain(cuda, n_cells, W, table_h):
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2

    rng = _probe_gen(W)
    table = _rand(rng, (table_h, 128), cuda)
    cols2, data2 = _ints(rng, table_h, (n_cells, 8192, W), cuda), _rand(rng, (n_cells, 8192, W), cuda)
    got = v2.pick_scale_wsum(table, cols2, data2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, v2.pick_scale_wsum_plain(table, cols2, data2), **PROBE_SUMS)


@pytest.mark.parametrize("rows,cols,n_seg,per_step", [(512, 128, 3, 1024), (100, 77, 5, 37), (1, 1, 2, 1)])
def test_scalar_gather_sum_kernel_matches_plain(cuda, rows, cols, n_seg, per_step):
    from sparse_tpu_torch.experiments import pallas_vmem as v

    rng = _probe_gen(per_step)
    x = _rand(rng, (rows, cols), cuda)
    qi, qj = _ints(rng, rows, n_seg * per_step, cuda), _ints(rng, cols, n_seg * per_step, cuda)
    got = v.scalar_gather_sum(x, qi, qj, per_step)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, v.scalar_gather_sum_plain(x, qi, qj, per_step), **PROBE_SUMS)


def test_probe_runners_run_and_count_on_the_card(cuda):
    from sparse_tpu_torch.experiments import common, pallas_vmem as v, pallas_vmem2 as v2

    calls = common.WARMUP + common.REPS
    runs = {
        "lane_gather": (lambda: v.p1(512, 1024, 512), 2 + calls),
        "row_gather_sum": (lambda: v.p2(256, 2048, 1024), 1 + calls),
        "row_pick_bf16": (lambda: v.p3(512, 2048, 1024), 1 + calls),
        "scalar_gather_sum": (lambda: v.p4(2048, 1024), 1 + calls),
        "lane_gather_blocksum": (lambda: v2.g1(512, 2), 1 + calls),
        "row_pick_blocksum": (lambda: v2.g2(512, 2), 1 + calls),
        "pick_scale_wsum": (lambda: v2.g3(8192, 4, 8), 1 + calls),
    }
    for name, (drive, launches) in runs.items():
        _cuda.reset_launch_counts()
        run = drive()
        assert _cuda.LAUNCHES == {**{k: 0 for k in _cuda.LAUNCHES}, name: launches}, name
        assert run.ms > 0 and run.rate > 0 and all(o.device.type == "cuda" for o in run.outputs)


def test_probe_launchers_refuse_what_their_kernels_do_not_take(cuda):
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1

    table = torch.rand((64, 128), device=cuda)
    idx = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    out = torch.empty((8, 128), device=cuda)
    with pytest.raises(TypeError):
        _cuda.lane_gather(table.double(), idx, out)
    with pytest.raises(ValueError, match="aligned"):
        base = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=cuda)
        _cuda.lane_gather(table, base[1:].view(8, 128), out)
    with pytest.raises(ValueError):
        _cuda.lane_gather(torch.rand((64, 96), device=cuda), idx[:, :96].contiguous(), out[:, :96].contiguous())
    with pytest.raises(ValueError):
        _cuda.row_pick_blocksum(table, idx.view(-1), torch.empty((8, 128), device=cuda), 8)  # out is one block short
    with pytest.raises(ValueError, match="8192"):
        _cuda.pick_scale_wsum(table, torch.zeros((1, 512, 4), dtype=torch.int32, device=cuda), torch.ones((1, 512, 4), device=cuda), out)
    with pytest.raises(TypeError):
        e1.products(torch.rand((512, 128), device=cuda), idx.view(-1), torch.rand(1024, device=cuda))
    with pytest.raises(TypeError):
        _cuda.spmv_products(torch.rand((512, 128), device=cuda), idx.view(-1), torch.rand(1024, device=cuda), torch.empty((1024, 1), device=cuda))
    with pytest.raises(ValueError):
        _cuda.scalar_gather_sum(table, idx.view(-1), idx.view(-1), torch.empty((3, 1), device=cuda), 1000)
