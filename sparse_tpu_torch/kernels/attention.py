"""Attention over a row-ELL pattern: K6 and its plain version.

``ell_attention`` is ``sparse_tpu.nn.sparse_attention_ell``'s function: for
float32/float64 tensors on the GPU it runs the hand-written CUDA kernel K6
of ``csrc/attention.cu`` (counted as ``ell_attention``) or raises; on the
CPU it runs ``ell_attention_plain``, and so does every other dtype on any
device, as ``kernels.sddmm`` routes float16 and bfloat16. Its gradient is a
``torch.autograd.Function`` whose backward is, for now, the plain version's
autograd on a recompute.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

_KERNEL_DTYPES = (torch.float32, torch.float64)


def _take_rows(table, idx):
    """``jnp.take(table, idx, axis=0)``: an index below 0 counts from the
    end, one outside ``[-n, n)`` gives a row of NaN (its fill mode)."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    g = table[idx.clamp(0, max(n - 1, 0))]
    return torch.where(inside[..., None], g, torch.full((), float("nan"), dtype=g.dtype, device=g.device))


def ell_attention_plain(q, k, v, e_cols, valid, scale):
    """K6's function in torch ops, on any device: ``sparse_tpu/nn.py:303-316``
    line for line. ``[k | v]`` packed into one table and gathered as an
    ``(L, cap, d + dv)`` block; ``q`` scaled and zero-padded over the v
    lanes; the masked softmax over the slots; the block summed, weighted by
    it, and its v lanes kept. The three tensors share one dtype."""
    d, dv = q.shape[-1], v.shape[-1]
    kv = torch.cat([k, v], dim=1)  # (Lk, d+dv)
    g = _take_rows(kv, e_cols)  # (L, cap, d+dv): one gather
    qs = q * scale
    qp = torch.cat([qs, torch.zeros((q.shape[0], dv), dtype=q.dtype, device=q.device)], dim=1)
    scores = (qp[:, None, :] * g).sum(dim=-1)
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    scores = torch.where(valid, scores, neg_inf)
    m = torch.max(scores, dim=1, keepdim=True).values
    e = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    e = torch.where(valid, e, torch.zeros_like(e))
    denom = e.sum(dim=1, keepdim=True)
    attn = e / torch.where(denom == 0, torch.ones_like(denom), denom)
    return (attn[:, :, None] * g).sum(dim=1)[:, d:]


def _ell_attention_forward(q, k, v, e_cols, valid, scale):
    if q.device.type == "cpu":
        return ell_attention_plain(q, k, v, e_cols, valid, scale)
    _cuda.require_cuda(q.device, "row-ELL attention")
    n_rows, cap = e_cols.shape
    out = torch.empty((n_rows, v.shape[1]), dtype=q.dtype, device=q.device)
    scratch = None
    if not _cuda.ell_attention_in_smem(cap, q.element_size()):
        n = _cuda.ell_attention_grid(n_rows, q.device) * _cuda.ATTENTION_WARPS * cap
        scratch = torch.empty(n, dtype=q.dtype, device=q.device)
    rows = [t if _cuda.sddmm_k_major(t) else t.contiguous() for t in (q, k, v)]
    return _cuda.ell_attention(*rows, e_cols.contiguous(), valid.contiguous(), scale, out, scratch)


class _EllAttention(torch.autograd.Function):
    """K6 forward (plain on the CPU). The backward, for now, is the plain
    version's autograd on a recompute: it builds the ``(L, cap, d + dv)``
    block the forward never writes."""

    @staticmethod
    def forward(ctx, q, k, v, e_cols, valid, scale):
        ctx.save_for_backward(q, k, v, e_cols, valid)
        ctx.scale = scale
        return _ell_attention_forward(q, k, v, e_cols, valid, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, e_cols, valid = ctx.saved_tensors
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = ell_attention_plain(*ins, e_cols, valid, ctx.scale)
        grads = torch.autograd.grad(out, ins, g, allow_unused=True)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad[:3])), None, None, None)


def ell_attention(q, k, v, e_cols, valid, *, scale=None):
    """Sparse attention over a row-ELL pattern: query row ``i`` attends the
    keys ``e_cols[i, j]`` where ``valid[i, j]``. ``q`` ``(L, d)``, ``k``
    ``(Lk, d)``, ``v`` ``(Lk, dv)``, ``e_cols`` ``(L, cap)`` int32/int64,
    ``valid`` ``(L, cap)`` bool, all on one device → ``(L, dv)`` in the
    promoted dtype; ``scale`` defaults to ``1/sqrt(d)``. Differentiable in
    ``q``, ``k`` and ``v``.

    float32/float64 on the GPU launch K6 (``csrc/attention.cu``) or raise;
    on the CPU, and for other dtypes on any device, the plain version runs.
    The reference's rules hold on both: a non-finite ``v`` value in a valid
    slot makes its row NaN, one in a padding slot that lane; an index below
    0 counts from the end, one outside the table makes its row NaN."""
    for name, t in (("q", q), ("k", k), ("v", v), ("e_cols", e_cols), ("valid", valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ell_attention: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"ell_attention: {name} is on {t.device} but q is on {q.device}")
    if q.ndim != 2 or k.ndim != 2 or v.ndim != 2 or k.shape[1] != q.shape[1] or k.shape[0] != v.shape[0]:
        raise ValueError(f"ell_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} must be (L, d), (Lk, d), (Lk, dv)")
    if e_cols.ndim != 2 or e_cols.shape[0] != q.shape[0] or valid.shape != e_cols.shape:
        raise ValueError(f"ell_attention: e_cols {tuple(e_cols.shape)} and valid {tuple(valid.shape)} must be (L, cap)")
    if e_cols.dtype not in (torch.int32, torch.int64) or valid.dtype != torch.bool:
        raise TypeError(f"ell_attention: e_cols must be int32 or int64 and valid bool, not {e_cols.dtype}, {valid.dtype}")
    if e_cols.shape[1] < 1 or k.shape[0] < 1:
        raise ValueError("ell_attention: at least one slot a row and one key")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if dt in _KERNEL_DTYPES:
        return _EllAttention.apply(q, k, v, e_cols, valid, float(scale))
    return ell_attention_plain(q, k, v, e_cols, valid, scale)
