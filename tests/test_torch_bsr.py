"""The port's BSR layout and products against sparse_tpu's (CPU).

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against those in
tests/test_torch_kernels_gpu.py. The JAX side runs bsr_spmm_xla and the
Pallas kernels P2-P4 in interpret mode. Tolerances: float64 at rtol=1e-10
(as tests/test_bsr.py); float32 at rtol=1e-5, atol=1e-5 (the two sides sum
in another order); the SDDMM at atol=1e-4 (as tests/test_bsr.py:108).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparse_tpu as sparse
from sparse_tpu.kernels import bsr as jb
from sparse_tpu_torch.interop import bsr_from_arrays
from sparse_tpu_torch.kernels import bsr as tb

CPU = "cpu"
F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-5)


def _problem(dtype=np.float64):
    """tests/test_bsr.py's problem: 500 x 600 at density 0.02 (ragged edges)."""
    a = sparse.random((500, 600), density=0.02, random_state=0)
    rows, cols = np.asarray(a.coords)
    return rows, cols, np.asarray(a.data).astype(dtype), a.todense().astype(dtype)


def _triplets(case):
    if case == "test_bsr":
        rows, cols, data, _ = _problem()
        return rows, cols, data, (500, 600), (128, 128)
    if case == "empty":
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0), (128, 128), (128, 128)
    if case == "empty_block_rows":  # tests/test_bsr.py:35-40: block-rows 1 and 3 empty
        return np.array([0, 300, 301]), np.array([5, 10, 500]), np.ones(3), (400, 600), (128, 128)
    if case == "duplicates":
        return np.array([0, 0, 130]), np.array([1, 1, 200]), np.array([2.0, 3.0, 4.0]), (256, 256), (128, 128)
    if case == "block_32x64":
        rng = np.random.default_rng(4)
        lin = np.unique(rng.integers(0, 200 * 300, size=600))
        return lin // 300, lin % 300, rng.standard_normal(lin.size), (200, 300), (32, 64)
    raise ValueError(case)


CASES = ["test_bsr", "empty", "empty_block_rows", "duplicates", "block_32x64"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pad", [1, 2])
def test_layout_identical_to_sparse_tpu(case, pad):
    rows, cols, data, shape, bs = _triplets(case)
    j = jb.build_bsr(rows, cols, data, shape, bs, pad_run_multiple=pad)
    t = tb.build_bsr(rows, cols, data, shape, bs, pad_run_multiple=pad, device=CPU)
    np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
    np.testing.assert_array_equal(t.block_rows.numpy(), np.asarray(j.block_rows))
    np.testing.assert_array_equal(t.block_cols.numpy(), np.asarray(j.block_cols))
    assert t.block_rows.dtype == t.block_cols.dtype == torch.int32
    assert (t.shape, t.block_shape, t.n_blocks, t.nnz) == (j.shape, j.block_shape, j.n_blocks, j.nnz)
    # the run offsets: every block-row's run, in order, of a length divisible by pad
    rp = t.row_ptr.numpy()
    assert rp.dtype == np.int64 and rp.shape == (-(-shape[0] // bs[0]) + 1,)
    np.testing.assert_array_equal(np.repeat(np.arange(rp.size - 1), np.diff(rp)), t.block_rows.numpy())
    assert (np.diff(rp) % pad == 0).all() and (np.diff(rp) > 0).all()
    np.testing.assert_array_equal(t.todense().numpy(), j.todense())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pad", [1, 2])
def test_transpose_layout_identical_to_sparse_tpu(case, pad):
    rows, cols, data, shape, bs = _triplets(case)
    j = jb.build_bsr(rows, cols, data, shape, bs, pad_run_multiple=pad)
    t = tb.build_bsr(rows, cols, data, shape, bs, pad_run_multiple=pad, device=CPU)
    n_t = -(-shape[1] // bs[1])
    want = jb.transpose_bsr_layout(j.block_rows, j.block_cols, n_t)
    got = tb.transpose_bsr_layout(t.block_rows, t.block_cols, n_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # the transposed layout's blocks hold Aᵀ
    t_rows, t_cols, t_perm = got
    at = tb.BSR(
        tb.transposed_blocks(t.blocks, torch.as_tensor(t_perm)),
        torch.as_tensor(t_rows),
        torch.as_tensor(t_cols),
        shape[::-1],
        bs[::-1],
        torch.as_tensor(tb.block_row_ptr(t_rows, n_t)),
    )
    np.testing.assert_array_equal(at.todense().numpy(), t.todense().numpy().T)


@pytest.mark.parametrize("n", [200, 37])
def test_spmm_plain_matches_sparse_tpu_xla_f64(n):
    rows, cols, data, dense_a = _problem()
    j = jb.build_bsr(rows, cols, data, (500, 600))
    t = tb.build_bsr(rows, cols, data, (500, 600), device=CPU)
    b = np.random.default_rng(1).random((600, n))
    want = np.asarray(jb.bsr_spmm_xla(j.block_rows, j.block_cols, j.blocks, jnp.asarray(b), n_rows=500))
    got = tb.bsr_spmm_plain(t.block_rows, t.block_cols, t.blocks, torch.as_tensor(b), n_rows=500)
    np.testing.assert_allclose(got.numpy(), want, **F64)
    np.testing.assert_allclose(got.numpy(), dense_a @ b, **F64)
    # the wrapper takes the plain version for CPU tensors
    kern = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.as_tensor(b), n_rows=500)
    np.testing.assert_array_equal(kern.numpy(), got.numpy())


def test_spmm_plain_matches_sparse_tpu_xla_f32():
    rows, cols, data, _ = _problem(np.float32)
    j = jb.build_bsr(rows, cols, data, (500, 600))
    t = tb.build_bsr(rows, cols, data, (500, 600), device=CPU)
    b = np.random.default_rng(1).standard_normal((600, 200)).astype(np.float32)
    want = np.asarray(jb.bsr_spmm_xla(j.block_rows, j.block_cols, j.blocks, jnp.asarray(b), n_rows=500))
    got = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.as_tensor(b), n_rows=500)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
def test_spmm_matches_pallas_interpret(dtype, tol):
    rows, cols, data, _ = _problem(dtype)
    j = jb.build_bsr(rows, cols, data, (500, 600))
    t = tb.build_bsr(rows, cols, data, (500, 600), device=CPU)
    b = np.random.default_rng(1).random((600, 200)).astype(dtype)
    want = np.asarray(jb.bsr_spmm_pallas(j.block_rows, j.block_cols, j.blocks, jnp.asarray(b), n_rows=500, interpret=True))
    got = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.as_tensor(b), n_rows=500)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
def test_spmm2_matches_pallas2_interpret(dtype, tol):
    rows, cols, data, _ = _problem(dtype)
    j = jb.build_bsr(rows, cols, data, (500, 600), pad_run_multiple=2)
    t = tb.build_bsr(rows, cols, data, (500, 600), pad_run_multiple=2, device=CPU)
    b = np.random.default_rng(1).random((600, 200)).astype(dtype)
    want = np.asarray(
        jb.bsr_spmm_pallas2(j.block_rows, j.block_cols, j.blocks, jnp.asarray(b), n_rows=500, interpret=True)
    )
    got = tb.bsr_spmm_kernel2(t.block_rows, t.block_cols, t.blocks, torch.as_tensor(b), n_rows=500)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    # the one-block kernel takes the padded layout too
    got1 = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.as_tensor(b), n_rows=500)
    np.testing.assert_allclose(got1.numpy(), want, **tol)


def _sddmm_case():
    """tests/test_bsr.py:89-109."""
    rng = np.random.default_rng(3)
    m, b, k = 256, 96, 384
    nb = (m // 128) * (k // 128)
    sel = rng.random(nb) < 0.6
    bi = (np.arange(nb) // (k // 128))[sel].astype(np.int64) * 128
    bj = (np.arange(nb) % (k // 128))[sel].astype(np.int64) * 128
    bsr = jb.build_bsr(bi, bj, np.ones(bi.size, np.float32), (m, k))
    lhs = rng.standard_normal((m, b)).astype(np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    return bsr, lhs, rhs


def test_sddmm_plain_matches_pallas_interpret():
    bsr, lhs, rhs = _sddmm_case()
    want = np.asarray(
        jb.bsr_sddmm_pallas(bsr.block_rows, bsr.block_cols, jnp.asarray(lhs), jnp.asarray(rhs), interpret=True)
    )
    rows, cols = torch.as_tensor(np.asarray(bsr.block_rows)), torch.as_tensor(np.asarray(bsr.block_cols))
    got = tb.bsr_sddmm_plain(rows, cols, torch.as_tensor(lhs), torch.as_tensor(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    kern = tb.bsr_sddmm_kernel(rows, cols, torch.as_tensor(lhs), torch.as_tensor(rhs))
    np.testing.assert_array_equal(kern.numpy(), got.numpy())


@pytest.mark.parametrize("ragged", ["B", "M", "K"])
def test_sddmm_ragged_edges_match_pallas_interpret(ragged):
    # a contraction, row count or column count that is no multiple of the tile:
    # the Pallas kernel pads with zeros, the port masks
    rng = np.random.default_rng(7)
    m, b, k = {"B": (256, 37, 384), "M": (200, 64, 384), "K": (256, 64, 300)}[ragged]
    r, c = np.meshgrid(np.arange(0, m, 128), np.arange(0, k, 128), indexing="ij")
    bsr = jb.build_bsr(r.ravel(), c.ravel(), np.ones(r.size, np.float32), (m, k))
    lhs = rng.standard_normal((m, b))
    rhs = rng.standard_normal((b, k))
    want = np.asarray(
        jb.bsr_sddmm_pallas(bsr.block_rows, bsr.block_cols, jnp.asarray(lhs), jnp.asarray(rhs), interpret=True)
    )
    rows, cols = torch.as_tensor(np.asarray(bsr.block_rows)), torch.as_tensor(np.asarray(bsr.block_cols))
    got = tb.bsr_sddmm_kernel(rows, cols, torch.as_tensor(lhs), torch.as_tensor(rhs))
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_transposed_view_operands():
    rows, cols, data, dense_a = _problem()
    t = tb.build_bsr(rows, cols, data, (500, 600), device=CPU)
    bt = torch.as_tensor(np.random.default_rng(2).standard_normal((37, 600)))
    got = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, bt.T, n_rows=500)
    np.testing.assert_allclose(got.numpy(), dense_a @ bt.numpy().T, **F64)
    lhs = torch.as_tensor(np.random.default_rng(3).standard_normal((37, 500)))
    got = tb.bsr_sddmm_kernel(t.block_rows, t.block_cols, lhs.T, bt)
    want = tb.bsr_sddmm_kernel(t.block_rows, t.block_cols, lhs.T.contiguous(), bt.contiguous())
    r, c = int(t.block_rows[0]) * 128, int(t.block_cols[0]) * 128
    full = np.zeros((640, 640))
    full[:500, :600] = lhs.numpy().T @ bt.numpy()
    np.testing.assert_allclose(got.numpy()[0], full[r : r + 128, c : c + 128], **F64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F64)


def test_bfloat16_sums_in_float32():
    rows, cols, data, _ = _problem(np.float32)
    t = tb.build_bsr(rows, cols, data, (500, 600), device=CPU)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((600, 64)).astype(np.float32))
    blocks16, b16 = t.blocks.to(torch.bfloat16), b.to(torch.bfloat16)
    got = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, blocks16, b16, n_rows=500)
    assert got.dtype == torch.bfloat16
    # one rounding of the float32 sum of the bf16 inputs
    want = tb.bsr_spmm_plain(t.block_rows, t.block_cols, blocks16.float(), b16.float(), n_rows=500).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def test_empty_matrix():
    j = jb.build_bsr(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0), (128, 128))
    t = tb.build_bsr(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0), (128, 128), device=CPU)
    want = np.asarray(jb.bsr_spmm_xla(j.block_rows, j.block_cols, j.blocks, jnp.ones((128, 8)), n_rows=128))
    got = tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.ones((128, 8), dtype=torch.float64), n_rows=128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmm_kernel2_raises_on_odd_runs():
    rows, cols, data, _ = _problem()
    t = tb.build_bsr(rows, cols, data, (500, 600), device=CPU)  # runs of odd length
    assert (np.diff(t.row_ptr.numpy()) % 2).any()
    b = torch.ones((600, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="even length"):
        tb.bsr_spmm_kernel2(t.block_rows, t.block_cols, t.blocks, b, n_rows=500)
    # an even total is not enough: runs of 1 and 3 blocks
    br, bc = torch.tensor([0, 1, 1, 1], dtype=torch.int32), torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    blocks = torch.ones((4, 2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="even length"):
        tb.bsr_spmm_kernel2(br, bc, blocks, torch.ones((6, 1), dtype=torch.float64), n_rows=4)


def test_cuda_only_wrappers_refuse_other_devices():
    t = tb.build_bsr(np.array([0, 1]), np.array([1, 0]), np.array([1.0, 2.0]), (2, 2), (1, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.empty((2, 3), dtype=torch.float64, device="meta"), n_rows=2)
    with pytest.raises(ValueError, match="CUDA device"):
        tb.bsr_sddmm_kernel(
            t.block_rows, t.block_cols, torch.empty((2, 3), device="meta"), torch.empty((3, 2), device="meta"), block_shape=(1, 1)
        )
    cpu = tb.build_bsr(np.array([0, 1]), np.array([1, 0]), np.array([1.0, 2.0]), (2, 2), (1, 1), device=CPU)
    with pytest.raises(ValueError, match="is on"):
        tb.bsr_spmm_kernel(cpu.block_rows, cpu.block_cols, cpu.blocks, torch.empty((2, 3), dtype=torch.float64, device="meta"), n_rows=2)


def test_wrapper_argument_errors():
    t = tb.build_bsr(np.array([0, 1]), np.array([1, 0]), np.array([1.0, 2.0]), (2, 2), (1, 1), device=CPU)
    with pytest.raises(TypeError, match="share one dtype"):
        tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.ones((2, 3)), n_rows=2)
    with pytest.raises(ValueError, match="block_shape"):
        tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks, torch.ones((2, 3), dtype=torch.float64), n_rows=2, block_shape=(2, 2))
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        tb.bsr_spmm_kernel(t.block_rows, t.block_cols, t.blocks.half(), torch.ones((2, 3), dtype=torch.half), n_rows=2)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        tb.bsr_sddmm_kernel(t.block_rows, t.block_cols, torch.ones((2, 3), dtype=torch.int64), torch.ones((3, 2), dtype=torch.int64), block_shape=(1, 1))
    with pytest.raises(ValueError, match="ascending"):
        tb.block_row_ptr(np.array([1, 0]), 2)
    with pytest.raises(ValueError, match="do not contract"):
        tb.bsr_sddmm_kernel(t.block_rows, t.block_cols, torch.ones((2, 3)), torch.ones((4, 2)), block_shape=(1, 1))


def test_bsr_from_sparse_tpu_arrays():
    rows, cols, data, dense_a = _problem()
    j = jb.build_bsr(rows, cols, data, (500, 600), pad_run_multiple=2)
    t = bsr_from_arrays(np.asarray(j.blocks), np.asarray(j.block_rows), np.asarray(j.block_cols), j.shape, j.block_shape, CPU)
    np.testing.assert_array_equal(t.todense().numpy(), dense_a)
    np.testing.assert_array_equal(t.row_ptr.numpy(), tb.build_bsr(rows, cols, data, (500, 600), pad_run_multiple=2, device=CPU).row_ptr.numpy())
    # bfloat16 buffers are carried bit for bit
    t16 = bsr_from_arrays(np.asarray(j.blocks.astype(jnp.bfloat16)), np.asarray(j.block_rows), np.asarray(j.block_cols), j.shape, j.block_shape, CPU)
    assert t16.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(t16.blocks.float().numpy(), np.asarray(j.blocks.astype(jnp.bfloat16).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the tensor-core SpMM (csrc/bsr_tc.cu): run pieces, K-major operands, 3xTF32
# ---------------------------------------------------------------------------


def _block_spans(row_ptr, pieces, piece):
    """``{block-row: [(begin, end), ...]}`` as csrc/bsr_tc.cu's CTAs take the
    runs: the pieces of split runs first, then one CTA per unsplit run."""
    n = row_ptr.size - 1
    spans = {}
    for u in range(int(pieces[n])):
        r = int(np.searchsorted(pieces, u, side="right")) - 1
        begin = int(row_ptr[r]) + (u - int(pieces[r])) * piece
        spans.setdefault(r, []).append((begin, min(begin + piece, int(row_ptr[r + 1]))))
    for r in range(n):
        if pieces[r + 1] == pieces[r]:
            spans[r] = [(int(row_ptr[r]), int(row_ptr[r + 1]))]
    return spans


@pytest.mark.parametrize("piece", [None, 1, 3])
@pytest.mark.parametrize("case", ["layer", "t_layer", "test_bsr", "empty_block_rows"])
def test_run_pieces_cover_every_block_in_run_order(case, piece):
    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.kernels import _cuda

    if case in ("layer", "t_layer"):  # runs padded to even length; transposed: pads in block-row 0
        p = tnn.init_block_sparse_linear(1024, 8192, 0.25, generator=torch.Generator().manual_seed(1), device=CPU)
        row_ptr = (p.row_ptr if case == "layer" else p.t_row_ptr).numpy()
    else:
        rows, cols, data, shape, bs = _triplets(case)
        row_ptr = tb.build_bsr(rows, cols, data, shape, bs, device=CPU).row_ptr.numpy()
    L = _cuda.BSR_PIECE if piece is None else piece
    pieces = _cuda.run_pieces(torch.as_tensor(row_ptr), L).numpy()
    assert pieces.dtype == np.int64 and pieces.shape == row_ptr.shape
    assert pieces[-1] <= _cuda.front_bound(int(row_ptr[-1]), row_ptr.size - 1, L)
    spans = _block_spans(row_ptr, pieces, L)
    covered = []
    for r in range(row_ptr.size - 1):
        length, got = int(row_ptr[r + 1] - row_ptr[r]), spans[r]
        assert len(got) == (1 if length <= L else -(-length // L))
        assert got[0][0] == row_ptr[r] and got[-1][1] == row_ptr[r + 1]
        assert all(a[1] == b[0] for a, b in zip(got, got[1:])) and all(e - b == L for b, e in got[:-1])
        covered += [np.arange(b, e) for b, e in got]
    np.testing.assert_array_equal(np.sort(np.concatenate(covered)), np.arange(int(row_ptr[-1])))
    if case == "t_layer" and piece is None:  # the dgrad's long pad run is cut
        assert len(spans[0]) >= 3


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pad", [1, 2])
def test_transposed_blocks_are_kmajor_and_equal_sparse_tpu(case, pad):
    rows, cols, data, shape, bs = _triplets(case)
    t = tb.build_bsr(rows, cols, data, shape, bs, pad_run_multiple=pad, device=CPU)
    n_t = -(-shape[1] // bs[1])
    _, _, t_perm = tb.transpose_bsr_layout(t.block_rows, t.block_cols, n_t)
    blocks = jnp.asarray(t.blocks.numpy())
    tp = jnp.asarray(t_perm)
    want = np.asarray(jnp.where((tp < 0)[:, None, None], 0, blocks[jnp.clip(tp, 0, None)]).transpose(0, 2, 1))
    got = tb.transposed_blocks(t.blocks, torch.as_tensor(t_perm))
    assert got.is_contiguous() and got.shape == (t_perm.size, bs[1], bs[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[torch.as_tensor(t_perm) < 0].any()


def test_tf32_split_rebuilds_float32():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(200_000).astype(np.float32) * np.exp2(rng.integers(-100, 100, 200_000)).astype(np.float32)
    x = torch.as_tensor(np.concatenate([x, np.float32([0.0, -0.0, 1.0, 1 + 2**-12, 3.0e38])]))
    hi, lo = tb.tf32_split(x)
    for part in (hi, lo):  # tf32 values: the 13 low mantissa bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0**-21 * x.double().abs()).all())
    hi, lo = tb.tf32_split(torch.tensor([float("inf"), -float("inf"), float("nan")]))
    assert hi[:2].isinf().all() and not lo[:2].any() and hi[2].isnan()


@pytest.mark.parametrize("k", [2048, 4096, 6528])
def test_three_tf32_passes_reach_float64_and_one_does_not(k):
    # the layer's contraction lengths: runs of 16 to 51 blocks of 128
    rng = np.random.default_rng(k)
    a = torch.as_tensor(rng.standard_normal((64, k), dtype=np.float32))
    b = torch.as_tensor(rng.standard_normal((k, 64), dtype=np.float32))
    want = a.double() @ b.double()
    (ah, al), (bh, bl) = tb.tf32_split(a), tb.tf32_split(b)
    # products of tf32 values are exact in float32; the sums run in float32, as on the tensor cores
    three = al @ bh + ah @ bl + ah @ bh

    def norm_err(got):
        return float((got.double() - want).abs().max() / want.abs().max())

    assert norm_err(three) <= 1e-5
    assert norm_err(ah @ bh) > 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["off_grid_width", "n_major", "misaligned"])
def test_tc_operands_keep_the_product(dtype, layout):
    """What the wrapper hands the tensor-core kernel: K-major operands with
    16-byte strides and a block width that fills whole stages, copied only
    where needed, with the same product."""
    from sparse_tpu_torch.kernels import _cuda

    rng = np.random.default_rng(9)
    m, k, bs = (200, 300, (48, 40)) if layout == "off_grid_width" else (500, 600, (128, 128))
    lin = np.unique(rng.integers(0, m * k, 900))
    a = tb.build_bsr(lin // k, lin % k, rng.standard_normal(lin.size), (m, k), bs, device=CPU)
    blocks = a.blocks.to(dtype)
    base = torch.as_tensor(rng.standard_normal((37, k))).to(dtype)
    dense = {
        "off_grid_width": base.T,
        "n_major": base.T.contiguous(),
        "misaligned": torch.as_tensor(rng.standard_normal(37 * k + 1)).to(dtype)[1:].view(37, k).T,
    }[layout]
    bp, dp = tb._tc_operands(blocks, dense)
    assert _cuda._tc_ready(bp, 2) and _cuda._tc_ready(dp, 0)
    assert bp.shape[2] % _cuda.tc_k_per_stage(dtype) == 0
    if layout == "off_grid_width":  # padded with zero columns and rows
        kps = _cuda.tc_k_per_stage(dtype)
        assert bp.shape[2] == -(-bs[1] // kps) * kps and not bp[:, :, bs[1] :].any()
    else:  # the blocks are read in place, only dense is copied
        assert bp is blocks
    want = tb.bsr_spmm_plain(a.block_rows, a.block_cols, blocks.float(), dense.float(), n_rows=m)
    got = tb.bsr_spmm_plain(a.block_rows, a.block_cols, bp.float(), dp.float(), n_rows=m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
