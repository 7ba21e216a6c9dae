"""Attention over a row-ELL pattern: K6, its block layout and plain versions.

``ell_attention`` is ``sparse_tpu.nn.sparse_attention_ell``'s function. For
float32/float64 tensors on the GPU it launches K6 (``csrc/attention.cu``)
or raises; on the CPU it runs ``ell_attention_plain``, and so does every
other dtype on any device, as ``kernels.sddmm`` routes float16 and bfloat16.

K6 has two routes. float32 rows whose widths fit
(:func:`~sparse_tpu_torch.kernels._cuda.attention_tile_config`) take the tile
route first: a CTA a block of query rows against the union of their keys
(:func:`build_attention_blocks`, kept once a pattern), the scores and the
weighted sum as dense tiles on the tensor cores in 3xTF32 (counted
``ell_attention_tiles``); then the row kernel, filtered on the card, takes
the blocks the tile route left (an index outside the table, a union past
the route rule, a non-finite value). float64 and the other widths take the
row kernel alone, a warp a query row (counted ``ell_attention`` either
way). ``ell_attention_blocks_plain`` runs the tile route's arithmetic in
torch ops.

The gradient is a ``torch.autograd.Function``. For float32/float64 on the
GPU its backward launches K6's backward kernels, then K5 (``kernels.dot``'s
fixed-order row sum) twice over the pattern's slots by key, for ``dk`` and
``dv``, or raises. float32 rows whose widths fit
(:func:`~sparse_tpu_torch.kernels._cuda.attention_backward_tile_config`)
take the backward's tile route first, on the forward's block layout: the
row maxima and sums again, then ``p̂``, ``dP``, ``dŝ`` and ``dq`` on the
tensor cores and the strips ``ds`` and ``p`` by each slot's union index
(counted ``ell_attention_backward_tiles``); the row backward kernel (a warp
a query row: the scores again, ``dP``, the softmax, ``δ``, ``dS`` and
``dq``; counted ``ell_attention_backward``) takes the blocks it leaves, or
every row for float64 and the other widths.
``ell_attention_backward_blocks_plain`` runs the tile route's arithmetic in
torch ops. On the CPU, and for other dtypes, ``ell_attention_backward_plain``
runs the row decomposition in torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from .dot import SddmmPattern, _row_sum_forward

_KERNEL_DTYPES = (torch.float32, torch.float64)
# the route rule: a block takes the tile route when its union holds at most
# this many keys a slot of a row (its layout keeps that many: ratio · cap, a
# count tile of ratio · cap · 64 bytes a block). From chip_smoke.py's sweep on
# an H100: at 129 slots a row the tile route wins up to a union of 11.5 · cap
# and loses from 16.8 · cap; at 513 it wins up to 8 · cap, all a 4,096-key
# table allows (PERF.md)
ATTENTION_UNION_RATIO = 12.0
_COUNT_MAX = 255  # counts are uint8: a block past it takes the row route
PLACE_GROUP = 8  # union places a group of the backward's strip order (csrc/attention.cu's kPlaceGroup)


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


def ell_attention_backward_rows_plain(q, k, v, e_cols, valid, scale, g):
    """What K6's backward kernel writes, in torch ops on any device:
    ``(dq, ds, p)``, ``dq`` ``(L, d)`` and the slot weights of ``dk`` and
    ``dv``, ``ds`` and ``p`` ``(L, cap)``.

    The reference's VJP (``jax.grad`` of ``sparse_tpu/nn.py:282``) over the
    packed ``[k | v]`` block: ``s`` and ``p`` the forward's scores and
    masked softmax; ``dP = [0 | g] · [k | v]_j`` (NaN where a slot's k row
    holds a non-finite value or its index is outside the table: ``0 · inf``
    and the fill row); ``δ = Σ_j p·dP`` over every slot; ``dS = p ⊙ (dP −
    δ)`` on the valid slots, 0 on the others; ``dq = scale · Σ_j dS·[k]_j``
    over every slot (the fill row's NaN too). ``dk[c]`` sums ``dS·qs + p·0``
    and ``dv[c]`` sums ``dS·0 + p·g`` over the slots naming ``c``: the
    weights written are ``dS`` where ``p`` is finite (else NaN) and ``p``
    where ``dS`` is finite (else NaN). The row max's gradient, which cancels
    up to rounding, is left out."""
    d, dv = q.shape[-1], v.shape[-1]
    rows = _take_rows(torch.cat([k, v], dim=1), e_cols)  # (L, cap, d+dv), NaN rows outside the table
    qs = q * scale
    zeros = torch.zeros((), dtype=q.dtype, device=q.device)
    s = (torch.cat([qs, zeros.expand(q.shape[0], dv)], dim=1)[:, None, :] * rows).sum(dim=-1)
    s = torch.where(valid, s, torch.full((), float("-inf"), dtype=s.dtype, device=s.device))
    m = torch.max(s, dim=1, keepdim=True).values
    e = torch.where(valid, torch.exp(s - torch.where(torch.isfinite(m), m, zeros)), zeros)
    denom = e.sum(dim=1, keepdim=True)
    p = e / torch.where(denom == 0, torch.ones_like(denom), denom)
    dp = (torch.cat([zeros.expand(q.shape[0], d), g], dim=1)[:, None, :] * rows).sum(dim=-1)
    delta = (p * dp).sum(dim=1, keepdim=True)
    ds = torch.where(valid, p * (dp - delta), zeros)
    dq = (ds[:, :, None] * rows[:, :, :d]).sum(dim=1) * scale
    nan = torch.full((), float("nan"), dtype=q.dtype, device=q.device)
    return dq, torch.where(torch.isfinite(p), ds, nan), torch.where(torch.isfinite(ds), p, nan)


def _slot_keys(e_cols, n_keys):
    """Each slot's key row, an index below 0 read from the end; ``n_keys``
    for one outside the table (whose gradient the reference drops)."""
    c = e_cols.long()
    c = torch.where(c < 0, c + n_keys, c)
    return torch.where((c >= 0) & (c < n_keys), c, n_keys)


def ell_attention_backward_plain(q, k, v, e_cols, valid, scale, g):
    """The gradient ``(dq, dk, dv)`` of :func:`ell_attention_plain`'s output
    against ``g`` ``(L, dv)``, in torch ops on any device: the decomposition
    of :func:`ell_attention_backward_rows_plain`, ``dk`` and ``dv`` summed
    over the slots by key (``index_add_``)."""
    n_keys, d, dv = k.shape[0], q.shape[1], v.shape[1]
    dq, ds, p = ell_attention_backward_rows_plain(q, k, v, e_cols, valid, scale, g)
    at = _slot_keys(e_cols, n_keys).reshape(-1)
    dk = torch.zeros((n_keys + 1, d), dtype=q.dtype, device=q.device)
    dk.index_add_(0, at, (ds[:, :, None] * (q * scale)[:, None, :]).reshape(-1, d))
    dvv = torch.zeros((n_keys + 1, dv), dtype=q.dtype, device=q.device)
    dvv.index_add_(0, at, (p[:, :, None] * g[:, None, :]).reshape(-1, dv))
    return dq, dk[:n_keys], dvv[:n_keys]


# ---------------------------------------------------------------------------
# the tile route's block layout
# ---------------------------------------------------------------------------


class AttentionBlocks(NamedTuple):
    """The tile route's layout of a row-ELL pattern (``e_cols``, ``valid``)
    over ``n_keys`` keys, in blocks of ``block`` consecutive query rows.

    ``union`` ``(n_blocks, u_cap)`` int32: block b's union, the sorted
    distinct key rows its slots name (padding slots too; an index below 0
    read from the end, as ``jnp.take`` reads it), in ``union[b,
    :n_union[b]]``, 0 past it. ``n_union`` ``(n_blocks,)`` int32: the
    union's size, which may pass ``u_cap``. ``count`` ``(n_blocks, u_cap,
    block)`` uint8: ``count[b, u, r]`` the valid slots of row ``b · block +
    r`` naming key ``union[b, u]`` (a duplicate slot counts twice), each
    union key's counts in a row of ``block`` bytes (the ``(block, |U_b|)``
    tile stored key-major), 0 for rows past ``n_rows``. ``flag``
    ``(n_blocks,)`` bool: an index outside ``[-n_keys, n_keys)``, a union
    past ``u_cap`` (the route rule) or a count past 255; such a block takes
    the row kernel. ``cols`` and ``valid`` are the pattern the layout was
    built from."""

    block: int
    n_rows: int
    n_keys: int
    union: torch.Tensor
    n_union: torch.Tensor
    count: torch.Tensor
    flag: torch.Tensor
    cols: torch.Tensor
    valid: torch.Tensor


class StripOrder(NamedTuple):
    """The order in which the backward's tile route writes the strips of an
    :class:`AttentionBlocks`, its union places in groups of ``PLACE_GROUP``
    (8, a divisor of every stage). ``order`` ``(L · cap,)`` int32: each
    block's slots in the block's own span ``[b · block · cap, ...)``, its
    counted slots (a valid slot inside the table whose key the layout
    keeps) by group of places, then row, then place, then slot, its other
    slots after them, each as ``8 · (r · cap + j) + place % 8`` (``r · cap
    + j`` the slot within the block). ``begin`` ``(n_blocks, ⌈u_cap / 8⌉ +
    2)`` int32: where in the block's span each group begins, then where the
    others do and the span's end (:func:`union_places` gives each slot its
    place). A stage's slots are one run of it, and a row's slots of a group
    lie side by side in the strips: a warp's stores of a run share few
    sectors. Only the backward reads it, so it is built apart from the
    layout (:func:`attention_strip_order`)."""

    order: torch.Tensor
    begin: torch.Tensor


def union_capacity(cap, n_keys, block, ratio=ATTENTION_UNION_RATIO):
    """Keys a block's union keeps: ``ratio · cap`` (the route rule), at most
    the keys ``block`` rows of ``cap`` slots can name, at least 1."""
    return max(1, min(int(ratio * cap), block * cap, n_keys))


def build_attention_blocks(e_cols, valid, n_keys, block, ratio=ATTENTION_UNION_RATIO):
    """The :class:`AttentionBlocks` of ``(e_cols, valid)`` on their device,
    by torch ops and nothing read back: one sort of ``block_id · n_keys +
    key`` over every slot, the first of each run marked and ranked, the
    ranks scattered back to the slots; a second sort of the valid slots'
    places in the count tiles, whose runs' lengths are the counts (integer
    sums, the same in any order; no dense integer tile)."""
    if e_cols.ndim != 2 or valid.shape != e_cols.shape:
        raise ValueError(f"build_attention_blocks: e_cols {tuple(e_cols.shape)} and valid {tuple(valid.shape)} must be (L, cap)")
    if block < 1 or n_keys < 1:
        raise ValueError("build_attention_blocks: block and n_keys must be positive")
    dev = e_cols.device
    n_rows, cap = e_cols.shape
    n_blocks = -(-n_rows // block)
    u_cap = union_capacity(cap, n_keys, block, ratio)
    c = e_cols.long()
    c = torch.where(c < 0, c + n_keys, c)
    inside = (c >= 0) & (c < n_keys)
    row = torch.arange(n_rows, device=dev)
    blk = torch.div(row, block, rounding_mode="floor")
    outside = torch.zeros(n_blocks, dtype=torch.int64, device=dev).index_add_(0, blk, (~inside).sum(1))
    sentinel = n_blocks * n_keys  # slots outside the table sort last and name no key
    key = torch.where(inside, blk[:, None] * n_keys + c, sentinel).reshape(-1)
    skey, perm = torch.sort(key)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    first &= skey != sentinel
    sblk = torch.div(skey, n_keys, rounding_mode="floor").clamp_(max=max(n_blocks - 1, 0))
    n_union = torch.zeros(n_blocks, dtype=torch.int64, device=dev).index_add_(0, sblk, first.long())
    start = torch.cumsum(n_union, 0) - n_union
    local = torch.cumsum(first, 0) - 1 - start[sblk]  # each slot's place in its block's union
    keep = first & (local < u_cap)
    union = torch.zeros(n_blocks * u_cap + 1, dtype=torch.int32, device=dev)
    union.index_put_((torch.where(keep, sblk * u_cap + local, n_blocks * u_cap),), (skey - sblk * n_keys).to(torch.int32))
    local_slot = torch.empty_like(local).scatter_(0, perm, local).view(n_rows, cap)
    # the counts: the valid slots' places in the count tiles sorted, each run's length stored at its first
    counted = valid & inside & (local_slot < u_cap)
    size = n_blocks * u_cap * block
    at, _ = torch.sort(torch.where(counted, (blk[:, None] * u_cap + local_slot) * block + (row - blk * block)[:, None], size).reshape(-1))
    starts = torch.ones_like(at, dtype=torch.bool)
    starts[1:] = at[1:] != at[:-1]
    starts &= at != size
    run = torch.cumsum(starts, 0) - 1
    runs = torch.zeros(at.numel(), dtype=torch.int64, device=dev).index_add_(0, run.clamp_(min=0), (at != size).long())
    lengths = runs[run]
    count = torch.zeros(size + 1, dtype=torch.uint8, device=dev)
    count.index_put_((torch.where(starts, at, size),), lengths.clamp(max=_COUNT_MAX).to(torch.uint8))
    over = torch.zeros(n_blocks, dtype=torch.int64, device=dev)
    over.index_add_(0, torch.div(at.clamp(max=size - 1), u_cap * block, rounding_mode="floor"), (starts & (lengths > _COUNT_MAX)).long())
    flag = (outside > 0) | (n_union > u_cap) | (over > 0)
    return AttentionBlocks(
        block,
        n_rows,
        n_keys,
        union[:-1].view(n_blocks, u_cap),
        n_union.to(torch.int32),
        count[:-1].view(n_blocks, u_cap, block),
        flag,
        e_cols,
        valid,
    )


def build_strip_order(blocks):
    """The :class:`StripOrder` of the layout ``blocks`` on its device, by
    torch ops and nothing read back: each slot's union place by a search of
    its key among its block's kept union (every block's keys sorted, its
    padding after them), then one stable sort of every slot by block, group
    of places (the others last), row and place, ``begin`` by
    ``searchsorted`` on it."""
    e_cols, valid = blocks.cols, blocks.valid
    n_rows, cap = e_cols.shape
    n_blocks, u_cap = blocks.union.shape
    block, n_keys, dev = blocks.block, blocks.n_keys, e_cols.device
    c = e_cols.long()
    c = torch.where(c < 0, c + n_keys, c)
    inside = (c >= 0) & (c < n_keys)
    row = torch.arange(n_rows, device=dev)
    blk = torch.div(row, block, rounding_mode="floor")
    live = torch.arange(u_cap, device=dev)[None, :] < blocks.n_union[:, None].long()
    table = (torch.arange(n_blocks, device=dev)[:, None] * (n_keys + 1) + torch.where(live, blocks.union.long(), n_keys)).reshape(-1)
    want = blk[:, None] * (n_keys + 1) + c.clamp(0, n_keys - 1)
    at = torch.searchsorted(table, want.reshape(-1)).view(n_rows, cap).clamp_(max=max(table.numel() - 1, 0))
    counted = valid & inside & (table[at] == want)
    place = at - blk[:, None] * u_cap
    n_groups = -(-u_cap // PLACE_GROUP)
    group = torch.where(counted, torch.div(place, PLACE_GROUP, rounding_mode="floor"), n_groups)
    sub = torch.where(counted, place % PLACE_GROUP, 0)
    rank = ((blk[:, None] * (n_groups + 1) + group) * block + (row - blk * block)[:, None]) * PLACE_GROUP + sub
    rank, order = torch.sort(rank.reshape(-1), stable=True)
    span = block * cap
    bounds = (torch.arange(n_blocks, device=dev)[:, None] * (n_groups + 1) + torch.arange(n_groups + 2, device=dev)) * block
    begin = torch.searchsorted(rank, bounds * PLACE_GROUP) - torch.arange(n_blocks, device=dev)[:, None] * span
    order = (order % span) * PLACE_GROUP + sub.reshape(-1)[order]
    return StripOrder(order.to(torch.int32), begin.to(torch.int32))


_BLOCKS_MEMO_SIZE = 8
# (id(e_cols), id(valid)) -> {(n_keys, block): AttentionBlocks}, with the
# sources' version counters (an entry holds its sources: ids stay theirs)
_BLOCKS_MEMO = {}


def _kept_layouts(e_cols, valid, layouts):
    """``layouts`` (a dict the caller keeps beside its pattern, as
    ``nn.sparse_attention``'s memo does), or else the dict of a memo keyed by
    the identity of ``e_cols`` and ``valid``, new after an edit in place
    (their version counters)."""
    if layouts is None:
        key = (id(e_cols), id(valid))
        hit = _BLOCKS_MEMO.get(key)
        versions = (e_cols._version, valid._version)
        if hit is None or hit[0] is not e_cols or hit[1] is not valid or hit[2] != versions:
            hit = (e_cols, valid, versions, {})
            _BLOCKS_MEMO.pop(key, None)
            _BLOCKS_MEMO[key] = hit
            if len(_BLOCKS_MEMO) > _BLOCKS_MEMO_SIZE:
                _BLOCKS_MEMO.pop(next(iter(_BLOCKS_MEMO)))
        layouts = hit[3]
    return layouts


def attention_blocks(e_cols, valid, n_keys, block, layouts=None):
    """The :class:`AttentionBlocks` of ``(e_cols, valid)``, built once and
    kept (:func:`_kept_layouts`)."""
    layouts = _kept_layouts(e_cols, valid, layouts)
    blocks = layouts.get((n_keys, block))
    if blocks is None:
        blocks = layouts[(n_keys, block)] = build_attention_blocks(e_cols, valid, n_keys, block)
    return blocks


def attention_strip_order(e_cols, valid, n_keys, block, layouts=None):
    """The :class:`StripOrder` of :func:`attention_blocks`'s layout, built
    the first time a backward asks for it and kept beside the layout
    (:func:`_kept_layouts`), so a caller that runs no backward pays
    nothing for it."""
    layouts = _kept_layouts(e_cols, valid, layouts)
    key = ("strips", n_keys, block)
    strips = layouts.get(key)
    if strips is None:
        strips = layouts[key] = build_strip_order(attention_blocks(e_cols, valid, n_keys, block, layouts))
    return strips


def attention_slot_pattern(e_cols, valid, n_keys, layouts=None):
    """The :class:`~sparse_tpu_torch.kernels.dot.SddmmPattern` of the
    pattern's slots, which the backward's K5 sums along by key: entry ``i ·
    cap + j`` at row ``i`` (sorted) and column ``e_cols[i, j]`` (an index
    below 0 read from the end), every slot, padding too; a slot outside the
    table in an extra column ``n_keys``, whose sum is dropped. ``kept``
    (K5's union route), built once beside the tile layout
    (:func:`_kept_layouts`)."""
    layouts = _kept_layouts(e_cols, valid, layouts)
    key = ("slots", n_keys)
    pattern = layouts.get(key)
    if pattern is None:
        n_rows, cap = e_cols.shape
        rows = torch.arange(n_rows, dtype=torch.int32, device=e_cols.device).repeat_interleave(cap)
        cols = _slot_keys(e_cols, n_keys).reshape(-1).to(torch.int32 if n_keys < 2**31 - 1 else torch.int64)
        pattern = layouts[key] = SddmmPattern(rows, cols, n_rows, n_keys + 1, rows_sorted=True, kept=True)
    return pattern


def _block_route(q, k, v, blocks, scale):
    """Per block, True where the tile route leaves it to the row kernel: the
    layout's flag, or a non-finite value among its q rows (scaled) or its
    union's k and v rows."""
    n_blocks, u_cap = blocks.union.shape
    rows = n_blocks * blocks.block
    qbad = torch.zeros(rows, dtype=torch.bool, device=q.device)
    qbad[: q.shape[0]] = ~torch.isfinite(q * scale).all(1)
    kbad = ~(torch.isfinite(k).all(1) & torch.isfinite(v).all(1))
    live = torch.arange(u_cap, device=q.device)[None, :] < blocks.n_union[:, None].long()
    ubad = (kbad[blocks.union.long()] & live).any(1)
    return blocks.flag | qbad.view(n_blocks, -1).any(1) | ubad


def ell_attention_blocks_plain(q, k, v, blocks, scale, chunk=64):
    """The tile route's arithmetic in torch ops, on any device: for each
    block, the union in chunks of ``chunk`` keys; scores ``qs · kᵀ`` (``qs =
    q · scale``, the reference's); where a count is not 0, the running row
    maximum (an empty row's shift 0), ``p = count · exp(s − m)``, the running
    sum and ``p @ v`` rescaled as the maximum grows; at the end the sum
    divided out once (0 counts as 1). The blocks the kernel leaves to its
    row kernel (:func:`_block_route`) take ``ell_attention_plain``."""
    d, dv = q.shape[1], v.shape[1]
    n_blocks, u_cap = blocks.union.shape
    B, L = blocks.block, q.shape[0]
    dt, dev = q.dtype, q.device
    qb = torch.zeros((n_blocks * B, d), dtype=dt, device=dev)
    qb[:L] = q * scale
    qb = qb.view(n_blocks, B, d)
    m = torch.full((n_blocks, B), float("-inf"), dtype=dt, device=dev)
    s_run = torch.zeros((n_blocks, B), dtype=dt, device=dev)
    o = torch.zeros((n_blocks, B, dv), dtype=dt, device=dev)
    pos = torch.arange(u_cap, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    # the union's longest kept run; past it every chunk is padding (a read back: this is no path's code)
    for c0 in range(0, int(blocks.n_union.max().clamp(max=u_cap)) if n_blocks else 0, chunk):
        idx = blocks.union[:, c0 : c0 + chunk].long()
        live = (pos[c0 : c0 + chunk][None, :] < blocks.n_union[:, None].long())[..., None]
        kc = torch.where(live, k[idx], zero)
        vc = torch.where(live, v[idx], zero)
        cnt = blocks.count[:, c0 : c0 + chunk, :].transpose(1, 2).to(dt)  # (n_blocks, B, C)
        s = torch.matmul(qb, kc.transpose(1, 2))
        named = cnt != 0
        m_new = torch.maximum(m, torch.where(named, s, float("-inf")).amax(-1))
        alpha = torch.where(m == float("-inf"), zero, torch.exp(m - m_new))
        shift = torch.where(m_new == float("-inf"), zero, m_new)
        p = torch.where(named, cnt * torch.exp(s - shift[..., None]), zero)
        s_run = s_run * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.matmul(p, vc)
        m = m_new
    out = (o / torch.where(s_run == 0, torch.ones_like(s_run), s_run)[..., None]).reshape(-1, dv)[:L]
    by_row = _block_route(q, k, v, blocks, scale).repeat_interleave(B)[:L]
    return torch.where(by_row[:, None], ell_attention_plain(q, k, v, blocks.cols, blocks.valid, scale), out)


def union_places(blocks, strips):
    """Each slot's place in its block's union from the strip order
    ``strips`` of the layout ``blocks`` (:class:`StripOrder`), ``(L, cap)``
    int64, -1 for a slot the layout does not count (invalid, outside the
    table, past ``u_cap``)."""
    n_blocks = blocks.union.shape[0]
    n_rows, cap = blocks.cols.shape
    n_groups = strips.begin.shape[1] - 2
    span, dev = blocks.block * cap, strips.order.device
    at = torch.arange(n_rows * cap, device=dev)  # a position of the order: its block, its place in the span
    b = torch.div(at, span, rounding_mode="floor")
    rel = torch.zeros(n_blocks * span, dtype=torch.int64, device=dev)
    rel[: at.numel()] = at - b * span
    group = torch.searchsorted(strips.begin[:, 1 : n_groups + 1].contiguous().long(), rel.view(n_blocks, span), right=True)
    group = group.reshape(-1)[: at.numel()]
    entry = strips.order.long()
    place = torch.where(group < n_groups, group * PLACE_GROUP + entry % PLACE_GROUP, -1)
    places = torch.empty(n_rows * cap, dtype=torch.int64, device=dev)
    places[b * span + torch.div(entry, PLACE_GROUP, rounding_mode="floor")] = place
    return places.view(n_rows, cap)


def _backward_block_route(q, k, v, g, out, blocks, scale):
    """Per block, True where the backward's tile route leaves it to the row
    kernel: :func:`_block_route`'s rule, or a non-finite value among its g
    or out rows."""
    n_blocks = blocks.union.shape[0]
    bad = torch.zeros(n_blocks * blocks.block, dtype=torch.bool, device=q.device)
    bad[: q.shape[0]] = ~(torch.isfinite(g).all(1) & torch.isfinite(out).all(1))
    return _block_route(q, k, v, blocks, scale) | bad.view(n_blocks, -1).any(1)


def ell_attention_backward_blocks_plain(q, k, v, g, out, blocks, scale, chunk=64):
    """The backward tile route's arithmetic in torch ops, on any device:
    ``(dq, ds, p)`` as :func:`ell_attention_backward_rows_plain` gives them,
    ``out`` the forward's output. For each block, ``δ = g · out`` a row;
    pass 1 over the union in chunks of ``chunk`` keys: scores ``qs · kᵀ``
    and, where a count is not 0, the running row maximum ``m`` (an empty
    row's shift 0) and ``l = Σ count · exp(s − m)`` (0 counts as 1); pass 2
    over the same chunks: ``p̂ = exp(s − m) / l`` where a count is not 0,
    ``dP = g · vᵀ``, ``dŝ = p̂ (dP − δ)``, ``dq += (count ⊙ dŝ) · k``, and
    each slot's ``p̂`` and ``dŝ`` by its union place (:func:`union_places`
    of :func:`build_strip_order`; 0 and 0 where it has none); ``dq``
    scaled once. The blocks the kernel leaves to its row kernel
    (:func:`_backward_block_route`) take
    ``ell_attention_backward_rows_plain`` on their rows alone, so no ``(L,
    cap, d + dv)`` block is built."""
    d = q.shape[1]
    n_blocks, u_cap = blocks.union.shape
    B, L = blocks.block, q.shape[0]
    dt, dev = q.dtype, q.device
    zero = torch.zeros((), dtype=dt, device=dev)

    def by_blocks(x):
        y = torch.zeros((n_blocks * B, x.shape[1]), dtype=dt, device=dev)
        y[:L] = x
        return y.view(n_blocks, B, -1)

    qb, gb = by_blocks(q * scale), by_blocks(g)
    delta = by_blocks((g * out).sum(1, keepdim=True))[..., 0]
    pos = torch.arange(u_cap, device=dev)
    # the union's longest kept run; past it every chunk is padding (a read back: this is no path's code)
    starts = range(0, int(blocks.n_union.max().clamp(max=u_cap)) if n_blocks else 0, chunk)

    def chunk_of(c0):
        idx = blocks.union[:, c0 : c0 + chunk].long()
        live = (pos[c0 : c0 + chunk][None, :] < blocks.n_union[:, None].long())[..., None]
        cnt = blocks.count[:, c0 : c0 + chunk, :].transpose(1, 2).to(dt)  # (n_blocks, B, C)
        return torch.where(live, k[idx], zero), torch.where(live, v[idx], zero), cnt

    m = torch.full((n_blocks, B), float("-inf"), dtype=dt, device=dev)
    l_run = torch.zeros((n_blocks, B), dtype=dt, device=dev)
    for c0 in starts:
        kc, _, cnt = chunk_of(c0)
        s = torch.matmul(qb, kc.transpose(1, 2))
        named = cnt != 0
        m_new = torch.maximum(m, torch.where(named, s, float("-inf")).amax(-1))
        alpha = torch.where(m == float("-inf"), zero, torch.exp(m - m_new))
        shift = torch.where(m_new == float("-inf"), zero, m_new)
        l_run = l_run * alpha + torch.where(named, cnt * torch.exp(s - shift[..., None]), zero).sum(-1)
        m = m_new
    shift = torch.where(m == float("-inf"), zero, m)[..., None]
    l_run = torch.where(l_run == 0, torch.ones_like(l_run), l_run)[..., None]
    dqb = torch.zeros((n_blocks, B, d), dtype=dt, device=dev)
    slot = union_places(blocks, build_strip_order(blocks))
    ds = torch.zeros(slot.shape, dtype=dt, device=dev)
    p = torch.zeros(slot.shape, dtype=dt, device=dev)
    for c0 in starts:
        kc, vc, cnt = chunk_of(c0)
        s = torch.matmul(qb, kc.transpose(1, 2))
        p_hat = torch.where(cnt != 0, torch.exp(s - shift) / l_run, zero)
        ds_hat = p_hat * (torch.matmul(gb, vc.transpose(1, 2)) - delta[..., None])
        dqb += torch.matmul(cnt * ds_hat, kc)
        width = kc.shape[1]
        here = (slot >= c0) & (slot < c0 + width)
        at = (slot - c0).clamp(0, width - 1)
        p = torch.where(here, p_hat.reshape(n_blocks * B, width)[:L].gather(1, at), p)
        ds = torch.where(here, ds_hat.reshape(n_blocks * B, width)[:L].gather(1, at), ds)
    dq = dqb.reshape(-1, d)[:L] * scale
    by_row = _backward_block_route(q, k, v, g, out, blocks, scale).repeat_interleave(B)[:L]
    rows = by_row.nonzero().flatten()
    if rows.numel():
        rq, rds, rp = ell_attention_backward_rows_plain(q[rows], k, v, blocks.cols[rows], blocks.valid[rows], scale, g[rows])
        dq[rows], ds[rows], p[rows] = rq, rds, rp
    return dq, ds, p


def _aligned(t):
    """``t`` itself where the tile route reads it in place (rows of 16-byte
    aligned vectors), else a fresh copy."""
    return t if _cuda.sddmm_vec(t) else torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _ell_attention_forward(q, k, v, e_cols, valid, scale, layouts=None):
    if q.device.type == "cpu":
        return ell_attention_plain(q, k, v, e_cols, valid, scale)
    _cuda.require_cuda(q.device, "row-ELL attention")
    n_rows, cap = e_cols.shape
    out = torch.empty((n_rows, v.shape[1]), dtype=q.dtype, device=q.device)
    route, rows_a_block = None, 0
    config = _cuda.attention_tile_config(n_rows, q.shape[1], v.shape[1], q.dtype, q.device) if n_rows else None
    if config is not None:
        rows_a_block = _cuda.ATTENTION_BLOCK_ROWS
        blocks = attention_blocks(e_cols, valid, k.shape[0], rows_a_block, layouts)
        route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=q.device)
        _cuda.ell_attention_tiles(_aligned(q), _aligned(k), _aligned(v), blocks, scale, out, route, config)
    scratch = None
    if not _cuda.ell_attention_in_smem(cap, q.element_size()):
        n = _cuda.ell_attention_grid(n_rows, q.device) * _cuda.ATTENTION_WARPS * cap
        scratch = torch.empty(n, dtype=q.dtype, device=q.device)
    rows = [t if _cuda.sddmm_k_major(t) else t.contiguous() for t in (q, k, v)]
    return _cuda.ell_attention(
        *rows, e_cols.contiguous(), valid.contiguous(), scale, out, scratch, block_route=route, block_rows=rows_a_block
    )


def _ell_attention_backward(q, k, v, e_cols, valid, scale, g, out, layouts=None):
    """``(dq, dk, dv)`` against ``g``; ``out`` the forward's output."""
    if q.device.type == "cpu" or q.dtype not in _KERNEL_DTYPES:
        return ell_attention_backward_plain(q, k, v, e_cols, valid, scale, g)
    _cuda.require_cuda(q.device, "row-ELL attention")
    n_rows, cap = e_cols.shape
    n_keys = k.shape[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ds = torch.empty((n_rows, cap), dtype=q.dtype, device=q.device)
    p = torch.empty((n_rows, cap), dtype=q.dtype, device=q.device)
    q_, k_, v_, g_ = (t if _cuda.sddmm_k_major(t) else t.contiguous() for t in (q, k, v, g))
    route, rows_a_block = None, 0
    config = _cuda.attention_backward_tile_config(n_rows, q.shape[1], v.shape[1], q.dtype, q.device) if n_rows else None
    if config is not None:
        rows_a_block = _cuda.ATTENTION_BLOCK_ROWS
        blocks = attention_blocks(e_cols, valid, n_keys, rows_a_block, layouts)
        strips = attention_strip_order(e_cols, valid, n_keys, rows_a_block, layouts)
        route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=q.device)
        g_ = _aligned(g_)
        _cuda.ell_attention_backward_tiles(
            _aligned(q), _aligned(k), _aligned(v), g_, _aligned(out), blocks, strips, scale, dq, ds, p, route, config
        )
    _cuda.ell_attention_backward(
        q_, k_, v_, g_, e_cols.contiguous(), valid.contiguous(), scale, dq, ds, p, block_route=route, block_rows=rows_a_block
    )
    pattern = attention_slot_pattern(e_cols, valid, n_keys, layouts)
    dk = _row_sum_forward(pattern, 1, ds.view(-1), q * scale)
    dv = _row_sum_forward(pattern, 1, p.view(-1), g_)
    return dq, dk[:n_keys], dv[:n_keys]


class _EllAttention(torch.autograd.Function):
    """K6 forward (plain on the CPU and for dtypes K6 does not take), its
    output kept for the backward's ``δ``. Its backward, once
    differentiable: for float32/float64 on the GPU, K6's backward kernels
    (the tile route where it fits, then the row kernel on what it leaves:
    ``dq`` and the slot weights ``dS`` and ``p``), then ``dk`` and ``dv`` by
    K5 over :func:`attention_slot_pattern`, or a raise; elsewhere
    :func:`ell_attention_backward_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, e_cols, valid, scale, layouts):
        ctx.scale, ctx.layouts = scale, layouts
        if q.dtype not in _KERNEL_DTYPES:
            out = ell_attention_plain(q, k, v, e_cols, valid, scale)
        else:
            out = _ell_attention_forward(q, k, v, e_cols, valid, scale, layouts)
        ctx.save_for_backward(q, k, v, e_cols, valid, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, e_cols, valid, out = ctx.saved_tensors
        grads = _ell_attention_backward(q, k, v, e_cols, valid, ctx.scale, g, out, ctx.layouts)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad[:3])), None, None, None, None)


def ell_attention(q, k, v, e_cols, valid, *, scale=None, layouts=None):
    """Sparse attention over a row-ELL pattern: query row ``i`` attends the
    keys ``e_cols[i, j]`` where ``valid[i, j]``. ``q`` ``(L, d)``, ``k``
    ``(Lk, d)``, ``v`` ``(Lk, dv)``, ``e_cols`` ``(L, cap)`` int32/int64,
    ``valid`` ``(L, cap)`` bool, all on one device → ``(L, dv)`` in the
    promoted dtype; ``scale`` defaults to ``1/sqrt(d)``. Differentiable in
    ``q``, ``k`` and ``v`` (once).

    float32/float64 on the GPU launch K6 (``csrc/attention.cu``) or raise:
    float32 rows that fit its tile route take it, with the row kernel on the
    blocks it leaves; the rest the row kernel alone. The gradient launches
    K6's backward kernels (the same two routes) and K5 twice (``dk``,
    ``dv``). The tile route's layout (:func:`attention_blocks`), the
    backward's strip order (:func:`attention_strip_order`) and slot pattern
    (:func:`attention_slot_pattern`) are kept in ``layouts`` where the
    caller gives a dict, else by the identity of ``e_cols`` and ``valid``.
    On the CPU, and for other dtypes on any device, the plain versions run
    (``ell_attention_plain``, ``ell_attention_backward_plain``).
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
    return _EllAttention.apply(q.to(dt), k.to(dt), v.to(dt), e_cols, valid, float(scale), layouts)
