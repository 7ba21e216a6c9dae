"""The port's block-sparse linear layer against sparse_tpu.nn's (CPU).

The JAX parameters are carried across with sparse_tpu_torch.interop, since
jax.random and torch.Generator never draw the same numbers; the JAX side
runs its XLA path (use_pallas=False). Tolerances: float32 at rtol=1e-5,
atol=1e-5 (the two sides sum in another order); gradcheck in float64 at its
defaults.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparse_tpu.nn import block_sparse_linear as j_linear
from sparse_tpu.nn import init_block_sparse_linear as j_init
from sparse_tpu_torch import nn as tnn
from sparse_tpu_torch.interop import block_sparse_linear_params_from_arrays
from sparse_tpu_torch.kernels import bsr as tb

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)


def _carry(jp, transposed=True):
    a = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    return block_sparse_linear_params_from_arrays(
        a(jp.blocks),
        a(jp.block_rows),
        a(jp.block_cols),
        a(jp.bias),
        jp.out_features,
        jp.in_features,
        a(jp.t_block_rows) if transposed else None,
        a(jp.t_block_cols) if transposed else None,
        a(jp.t_perm) if transposed else None,
        device=CPU,
    )


def _jax_params(key=0, n_in=256, n_out=384, density=0.5, bias=True):
    """tests/test_nn.py:13-24's layer (256 -> 384, density 0.5)."""
    return j_init(jax.random.PRNGKey(key), in_features=n_in, out_features=n_out, block_density=density, bias=bias)


def test_forward_matches_sparse_tpu():
    jp = _jax_params()
    jp = jp._replace(bias=jnp.asarray(np.random.default_rng(4).standard_normal(384).astype(np.float32)))
    x = np.random.default_rng(1).random((8, 256)).astype(np.float32)
    want = np.asarray(j_linear(jp, jnp.asarray(x), use_pallas=False))
    tp = _carry(jp)
    got = tnn.block_sparse_linear(tp, torch.as_tensor(x))
    assert got.shape == (8, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    # the non-trainable layout (no transposed layout) gives the same forward
    got_nt = tnn.block_sparse_linear(_carry(jp, transposed=False), torch.as_tensor(x))
    np.testing.assert_allclose(got_nt.detach().numpy(), want, **F32)


def _jax_grads(jp, x, w, transposed):
    if not transposed:
        jp = jp._replace(t_block_rows=None, t_block_cols=None, t_perm=None)

    def loss(blocks, x_):
        return (j_linear(jp._replace(blocks=blocks), x_, use_pallas=False) * w).sum()

    gb, gx = jax.grad(loss, argnums=(0, 1))(jp.blocks, jnp.asarray(x))
    return np.asarray(gb), np.asarray(gx)


def _port_grads(tp, x, w):
    blocks = tp.blocks.clone().requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    (tnn.block_sparse_linear(tp._replace(blocks=blocks), xt) * torch.as_tensor(w)).sum().backward()
    return blocks.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("transposed", [True, False], ids=["trainable", "bsr_spmm"])
def test_gradients_match_jax_grad(transposed):
    # as tests/test_bsr.py:112-131
    jp = _jax_params()
    x = np.random.default_rng(1).standard_normal((32, 256)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((384,)).astype(np.float32)
    gb_want, gx_want = _jax_grads(jp, x, w, transposed)
    gb, gx = _port_grads(_carry(jp, transposed), x, w)
    np.testing.assert_allclose(gb, gb_want, **F32)
    np.testing.assert_allclose(gx, gx_want, **F32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pad", [1, 2])
def test_bsr_spmm_vjp_matches_jax_grad(dtype, pad):
    # the layer's path without a transposed layout: d_blocks by the block
    # SDDMM, d_dense by a bmm, on a ragged (500, 600) matrix (the reference's
    # bsr_spmm takes 128 x 128 blocks only)
    from sparse_tpu.kernels import bsr as jb

    block_shape = (128, 128)
    rng = np.random.default_rng(12)
    lin = np.unique(rng.integers(0, 500 * 600, 4000))
    j = jb.build_bsr(lin // 600, lin % 600, rng.standard_normal(lin.size).astype(dtype), (500, 600), block_shape, pad)
    t = tb.bsr_from_numpy(np.asarray(j.blocks), np.asarray(j.block_rows), np.asarray(j.block_cols), (500, 600), block_shape, device=CPU)
    x = rng.standard_normal((600, 24)).astype(dtype)
    w = rng.standard_normal((500, 24)).astype(dtype)

    def loss(blocks, dense):
        return (jb.bsr_spmm(j.block_rows, j.block_cols, blocks, dense, 500, False) * w).sum()

    gb_want, gx_want = jax.grad(loss, argnums=(0, 1))(j.blocks, jnp.asarray(x))
    blocks = t.blocks.clone().requires_grad_(True)
    dense = torch.as_tensor(x).requires_grad_(True)
    (tb.bsr_spmm(t.block_rows, t.block_cols, blocks, dense, 500) * torch.as_tensor(w)).sum().backward()
    tol = F32 if dtype == np.float32 else dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(gb_want), **tol)
    np.testing.assert_allclose(dense.grad.numpy(), np.asarray(gx_want), **tol)


def test_bsr_spmm_vjp_holds_full_f32_precision_and_restores_the_flag(monkeypatch):
    # the torch-op dgrad runs with TF32 off whatever the caller set, and the
    # caller's flag comes back, also when the product raises
    bsr, *_ = _tiny_layout()
    blocks = bsr.blocks.float().requires_grad_(True)
    dense = torch.randn((7, 3), requires_grad=True)
    seen, bmm = [], torch.bmm

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return bmm(*args)

    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        monkeypatch.setattr(torch, "bmm", spy)
        tb.bsr_spmm(bsr.block_rows, bsr.block_cols, blocks, dense, 5).sum().backward()
        assert False in seen and torch.backends.cuda.matmul.allow_tf32
        monkeypatch.setattr(torch, "bmm", lambda *args: (_ for _ in ()).throw(RuntimeError("bmm failed")))
        with pytest.raises(RuntimeError, match="bmm failed"):
            tb.bsr_spmm(bsr.block_rows, bsr.block_cols, blocks, dense, 5).sum().backward()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_pad_blocks_get_the_reference_gradient():
    # pad_run_multiple=2 pads runs with zero blocks at column 0; the wgrad
    # computes every stored block, so pads get a nonzero gradient in both
    jp = _jax_params(key=3, n_in=384, n_out=512, density=0.5)
    pads = np.flatnonzero(~np.asarray(jp.blocks).reshape(jp.blocks.shape[0], -1).any(axis=1))
    assert pads.size > 0
    x = np.random.default_rng(5).standard_normal((16, 384)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal((512,)).astype(np.float32)
    gb_want, _ = _jax_grads(jp, x, w, True)
    gb, _ = _port_grads(_carry(jp), x, w)
    assert np.abs(gb[pads]).max() > 0
    np.testing.assert_allclose(gb[pads], gb_want[pads], **F32)


def _tiny_layout():
    rng = np.random.default_rng(9)
    lin = np.unique(rng.integers(0, 5 * 7, size=9))
    bsr = tb.build_bsr(lin // 7, lin % 7, rng.standard_normal(lin.size), (5, 7), (2, 3), pad_run_multiple=2, device=CPU)
    t_rows, t_cols, t_perm = tb.transpose_bsr_layout(bsr.block_rows, bsr.block_cols, 3)
    return bsr, torch.as_tensor(t_rows), torch.as_tensor(t_cols), torch.as_tensor(t_perm)


def test_gradcheck_bsr_spmm():
    bsr, *_ = _tiny_layout()
    blocks = torch.randn(bsr.blocks.shape, dtype=torch.float64, requires_grad=True)
    dense = torch.randn((7, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda b, d: tb.bsr_spmm(bsr.block_rows, bsr.block_cols, b, d, 5), (blocks, dense))


def test_gradcheck_bsr_spmm_trainable():
    bsr, t_rows, t_cols, t_perm = _tiny_layout()
    blocks = torch.randn(bsr.blocks.shape, dtype=torch.float64, requires_grad=True)
    dense = torch.randn((3, 7), dtype=torch.float64).T.requires_grad_(True)  # a transposed view, as x.T

    def f(b, d):
        return tb.bsr_spmm_trainable(bsr.block_rows, bsr.block_cols, t_rows, t_cols, t_perm, b, d, 5, 7)

    assert torch.autograd.gradcheck(f, (blocks, dense))


def test_trainable_and_plain_vjp_agree():
    bsr, t_rows, t_cols, t_perm = _tiny_layout()
    g = torch.randn((5, 4), dtype=torch.float64)
    dense = torch.randn((7, 4), dtype=torch.float64)
    grads = []
    for fn in (
        lambda b, d: tb.bsr_spmm(bsr.block_rows, bsr.block_cols, b, d, 5),
        lambda b, d: tb.bsr_spmm_trainable(bsr.block_rows, bsr.block_cols, t_rows, t_cols, t_perm, b, d, 5, 7),
    ):
        b = bsr.blocks.clone().requires_grad_(True)
        d = dense.clone().requires_grad_(True)
        (fn(b, d) * g).sum().backward()
        grads.append((b.grad, d.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-12, atol=1e-12)


def test_init_layout():
    g = torch.Generator().manual_seed(0)
    p = tnn.init_block_sparse_linear(640, 384, block_density=0.4, generator=g, device=CPU)
    n = p.blocks.shape[0]
    assert p.blocks.shape[1:] == (128, 128) and p.blocks.dtype == torch.float32
    assert p.bias.shape == (384,) and not p.bias.any()
    runs = torch.diff(p.row_ptr)
    assert runs.shape == (3,) and (runs % 2 == 0).all() and int(runs.sum()) == n
    # pad blocks (zeros) only where a run was padded; real blocks drawn at 1/sqrt(in·density)
    nonzero = p.blocks.reshape(n, -1).any(dim=1)
    assert 0 < int(nonzero.sum()) <= n
    assert abs(float(p.blocks[nonzero].std()) - 1 / np.sqrt(640 * 0.4)) < 0.01
    # the transposed layout holds the same matrix
    w = tb.BSR(p.blocks, p.block_rows, p.block_cols, (384, 640), (128, 128), p.row_ptr).todense()
    wt = tb.BSR(
        tb.transposed_blocks(p.blocks, p.t_perm), p.t_block_rows, p.t_block_cols, (640, 384), (128, 128), p.t_row_ptr
    ).todense()
    torch.testing.assert_close(wt, w.T, rtol=0, atol=0)
    # the same seed draws the same layer
    q = tnn.init_block_sparse_linear(640, 384, block_density=0.4, generator=torch.Generator().manual_seed(0), device=CPU)
    assert torch.equal(p.blocks, q.blocks) and torch.equal(p.block_cols, q.block_cols)


def test_module_parameters_and_one_sgd_step():
    g = torch.Generator().manual_seed(1)
    layer = tnn.BlockSparseLinear(256, 384, block_density=0.5, generator=g, device=CPU)
    assert [n for n, _ in layer.named_parameters()] == ["blocks", "bias"]
    assert {n for n, _ in layer.named_buffers()} == {
        "block_rows", "block_cols", "t_block_rows", "t_block_cols", "t_perm", "row_ptr", "t_row_ptr"
    }
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((32, 256)).astype(np.float32))
    target = torch.as_tensor(rng.standard_normal((32, 384)).astype(np.float32))
    opt = torch.optim.SGD(layer.parameters(), lr=0.02)

    def loss_fn():
        return ((layer(x) - target) ** 2).sum(dim=1).mean()

    loss0 = loss_fn()
    opt.zero_grad()
    loss0.backward()
    assert layer.blocks.grad.shape == layer.blocks.shape and layer.bias.grad.shape == (384,)
    opt.step()
    assert loss_fn().item() < loss0.item()
    # the module computes what the functional form does
    y = tnn.block_sparse_linear(layer.params(), x)
    torch.testing.assert_close(layer(x), y, rtol=0, atol=0)


def test_module_from_sparse_tpu_params():
    jp = _jax_params()
    x = np.random.default_rng(1).random((8, 256)).astype(np.float32)
    layer = tnn.BlockSparseLinear.from_params(_carry(jp))
    assert (layer.in_features, layer.out_features) == (256, 384)
    assert [n for n, _ in layer.named_parameters()] == ["blocks", "bias"]
    want = np.asarray(j_linear(jp, jnp.asarray(x), use_pallas=False))
    np.testing.assert_allclose(layer(torch.as_tensor(x)).detach().numpy(), want, **F32)
