"""Neural-network building blocks over sparse weights.

- :class:`BlockSparseLinear` — a linear layer whose weight matrix is
  block-sparse (BSR, 128×128 blocks by default), trained through the
  hand-written BSR kernels: kernel forward, kernel dgrad on the transposed
  layout, kernel wgrad by the block SDDMM.
- :func:`init_block_sparse_linear` / :func:`block_sparse_linear` — the same
  layer as a parameter dataclass and a pure function, with the layout of
  ``sparse_tpu.nn``: ``y = (W @ xᵀ)ᵀ + b``.

The random block mask and weights come from a ``torch.Generator``; they
differ from ``jax.random``'s for the same seed, so the tests carry the JAX
package's parameters across with :mod:`sparse_tpu_torch.interop`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._settings import resolve_device
from .kernels.bsr import block_row_ptr, bsr_spmm, bsr_spmm_trainable, build_bsr_arrays, transpose_bsr_layout


@dataclasses.dataclass
class BlockSparseLinearParams:
    """Parameters of a block-sparse linear layer (y = x @ Wᵀ + b).

    ``row_ptr`` and ``t_row_ptr`` are the run offsets of the layout and of
    its transpose (:func:`~sparse_tpu_torch.kernels.bsr.block_row_ptr`), so
    that no call makes a host pass over the layout."""

    blocks: torch.Tensor  # (n_blocks, bm, bn)
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    bias: torch.Tensor | None
    out_features: int
    in_features: int
    # transposed layout (dgrad path); None on layouts built before training
    t_block_rows: torch.Tensor | None = None
    t_block_cols: torch.Tensor | None = None
    t_perm: torch.Tensor | None = None
    row_ptr: torch.Tensor | None = None
    t_row_ptr: torch.Tensor | None = None

    def _replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


def make_block_sparse_linear_params(
    blocks, block_rows, block_cols, bias, out_features, in_features, t_rows=None, t_cols=None, t_perm=None
):
    """:class:`BlockSparseLinearParams` from tensors already on one device,
    with both run offsets computed once on the host."""
    device = blocks.device
    bm, bn = blocks.shape[1:]
    as_dev = lambda a, dt: None if a is None else torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    t_row_ptr = None if t_rows is None else as_dev(block_row_ptr(t_rows, -(-in_features // bn)), torch.int64)
    return BlockSparseLinearParams(
        blocks,
        as_dev(block_rows, torch.int32),
        as_dev(block_cols, torch.int32),
        bias,
        int(out_features),
        int(in_features),
        as_dev(t_rows, torch.int32),
        as_dev(t_cols, torch.int32),
        as_dev(t_perm, torch.int64),
        as_dev(block_row_ptr(block_rows, -(-out_features // bm)), torch.int64),
        t_row_ptr,
    )


def init_block_sparse_linear(
    in_features,
    out_features,
    block_density=0.25,
    block_shape=(128, 128),
    dtype=torch.float32,
    bias=True,
    generator=None,
    device=None,
):
    """Initialize a block-sparse linear layer with a random block mask.

    The weight is W (out_features, in_features) stored as BSR on the layout
    of ``sparse_tpu.nn.init_block_sparse_linear``: runs padded to even
    length with zero blocks, and the transposed layout for dgrad. Mask and
    weights are drawn on the CPU from ``generator`` (``torch.Generator``),
    then moved to ``device`` once."""
    device = resolve_device(device)
    bm, bn = block_shape
    n_br = -(-out_features // bm)
    n_bc = -(-in_features // bn)
    mask = (torch.rand(n_br * n_bc, generator=generator, dtype=torch.float64) < block_density).numpy()
    bi = (np.arange(n_br * n_bc) // n_bc)[mask].astype(np.int64) * bm
    bj = (np.arange(n_br * n_bc) % n_bc)[mask].astype(np.int64) * bn
    ones, brow, bcol = build_bsr_arrays(
        bi, bj, np.ones(bi.size, dtype=np.float32), (out_features, in_features), block_shape, pad_run_multiple=2
    )
    n_blocks = ones.shape[0]
    scale = 1.0 / np.sqrt(max(in_features * block_density, 1.0))
    blocks = torch.randn((n_blocks, bm, bn), generator=generator, dtype=dtype) * scale
    # zero the pad blocks so they start inert
    nonpad = torch.as_tensor(ones.reshape(n_blocks, -1).sum(axis=1) > 0)
    blocks = (blocks * nonpad[:, None, None].to(dtype)).to(device)
    b = torch.zeros(out_features, dtype=dtype, device=device) if bias else None
    t_rows, t_cols, t_perm = transpose_bsr_layout(brow, bcol, n_bc)
    return make_block_sparse_linear_params(blocks, brow, bcol, b, out_features, in_features, t_rows, t_cols, t_perm)


def block_sparse_linear(params: BlockSparseLinearParams, x):
    """Apply the layer: ``y = x @ Wᵀ (+ bias)`` with W block-sparse.

    ``x``: (batch, in_features) → (batch, out_features). The contraction is
    expressed as ``W @ xᵀ`` so the BSR SpMM kernel applies directly; ``xᵀ``
    and the gradient of ``yᵀ`` are read by the kernels as strided views."""
    if params.t_block_rows is not None:
        out_t = bsr_spmm_trainable(
            params.block_rows,
            params.block_cols,
            params.t_block_rows,
            params.t_block_cols,
            params.t_perm,
            params.blocks,
            x.T,
            params.out_features,
            params.in_features,
            params.row_ptr,
            params.t_row_ptr,
        )
    else:
        # kernel forward, backward as torch ops
        out_t = bsr_spmm(params.block_rows, params.block_cols, params.blocks, x.T, params.out_features, params.row_ptr)
    y = out_t.T
    if params.bias is not None:
        y = y + params.bias[None, :]
    return y


class BlockSparseLinear(torch.nn.Module):
    """:func:`block_sparse_linear` as a module: ``blocks`` and ``bias`` are
    parameters, the layout (and its transpose and run offsets) buffers."""

    def __init__(
        self,
        in_features,
        out_features,
        block_density=0.25,
        block_shape=(128, 128),
        dtype=torch.float32,
        bias=True,
        generator=None,
        device=None,
    ):
        super().__init__()
        self._set(init_block_sparse_linear(in_features, out_features, block_density, block_shape, dtype, bias, generator, device))

    @classmethod
    def from_params(cls, params: BlockSparseLinearParams):
        """The module holding ``params`` (e.g. carried across by
        :mod:`sparse_tpu_torch.interop`)."""
        layer = cls.__new__(cls)
        torch.nn.Module.__init__(layer)
        layer._set(params)
        return layer

    def _set(self, params):
        self.in_features = params.in_features
        self.out_features = params.out_features
        self.blocks = torch.nn.Parameter(params.blocks)
        self.bias = None if params.bias is None else torch.nn.Parameter(params.bias)
        for name in ("block_rows", "block_cols", "t_block_rows", "t_block_cols", "t_perm", "row_ptr", "t_row_ptr"):
            self.register_buffer(name, getattr(params, name))

    def params(self) -> BlockSparseLinearParams:
        return BlockSparseLinearParams(
            self.blocks,
            self.block_rows,
            self.block_cols,
            self.bias,
            self.out_features,
            self.in_features,
            self.t_block_rows,
            self.t_block_cols,
            self.t_perm,
            self.row_ptr,
            self.t_row_ptr,
        )

    def forward(self, x):
        return block_sparse_linear(self.params(), x)
