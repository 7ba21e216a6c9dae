"""Neural-network building blocks over sparse weights and sparse patterns.

- :class:`BlockSparseLinear` — a linear layer whose weight matrix is
  block-sparse (BSR, 128×128 blocks by default), trained through the
  hand-written BSR kernels: kernel forward, kernel dgrad on the transposed
  layout, kernel wgrad by the block SDDMM.
- :func:`init_block_sparse_linear` / :func:`block_sparse_linear` — the same
  layer as a parameter dataclass and a pure function, with the layout of
  ``sparse_tpu.nn``: ``y = (W @ xᵀ)ᵀ + b``.
- :func:`graph_conv` — GCN propagation ``Â (x @ w)``: the product at full
  float32, then the sparse side on K5, the fixed-order row sum.
- :func:`sparse_attention` — attention at the edges of a (query, key)
  pattern. A host pattern (NumPy) of near-uniform degree takes the row-ELL
  route, :func:`sparse_attention_ell` on K6; any other pattern the COO
  route: scores by K4 (the SDDMM), :func:`segment_softmax`, the weighted
  sum by K5. Both routes give the same bits on every call.
- :func:`banded_attention`, :func:`block_sparse_attention` and
  :func:`longformer_attention` — the dense block forms (sliding window,
  BigBird block lists, window plus global tokens) as torch gathers and
  full-precision products.
- :func:`local_attention_pattern`, :func:`bigbird_block_pattern` and
  :func:`build_attention_ell` — the host pattern builders, the same arrays
  as ``sparse_tpu.nn``'s.

Attention functions take one head, ``q (L, d)``, as ``sparse_tpu.nn``'s do;
heads are a loop. :func:`banded_attention_sharded` and
:func:`sparse_attention_sharded` (with :func:`partition_attention_pattern`)
split the sequence over a mesh's ranks (``parallel.make_mesh``).

The random block mask and weights come from a ``torch.Generator``; they
differ from ``jax.random``'s for the same seed, so the tests carry the JAX
package's parameters across with :mod:`sparse_tpu_torch.interop`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._settings import resolve_device
from ._utils import wide_index
from .kernels.attention import ell_attention
from .kernels.bsr import (
    _full_f32_matmul,
    block_row_ptr,
    bsr_spmm,
    bsr_spmm_trainable,
    build_bsr_arrays,
    transpose_bsr_layout,
)
from .kernels.dot import SddmmPattern, _sddmm, _SampledRowSum, sampled_row_sum_plain
from .kernels.segment import segment_reduce


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


# ---------------------------------------------------------------------------
# placement of the attention and graph functions' operands
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = (torch.float32, torch.float64)
_HALF = (torch.float16, torch.bfloat16)


def _device_of(*xs):
    """The device of the tensors among ``xs`` (all on one device, else
    ``ValueError``); the GPU when none is a tensor."""
    devices = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"operands on more than one device: {sorted(map(str, devices))}")
    return devices.pop() if devices else resolve_device(None)


def _on(x, device, dtype=None):
    """``x`` as a tensor on ``device`` (a tensor stays where it is: the
    caller checked its device), in ``dtype`` when given."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)
    return t if dtype is None else t.to(dtype)


def _promote(*dtypes):
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


# ---------------------------------------------------------------------------
# host pattern builders (NumPy, the same arrays as sparse_tpu.nn's)
# ---------------------------------------------------------------------------


def local_attention_pattern(length, window, n_global=0):
    """Canonical COO pattern for sliding-window attention with optional
    global tokens (the Longformer-style mask): each query attends to keys
    within ``window`` positions, plus the first ``n_global`` keys attend/are
    attended everywhere. Host-side, returns (rows, cols) int32."""
    i = np.arange(length)
    lo = np.maximum(i - window, 0)
    hi = np.minimum(i + window + 1, length)
    counts = hi - lo
    rows = np.repeat(i, counts)
    cols = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)]) if length else np.empty(0, np.int64)
    if n_global:
        gi = np.arange(n_global)
        extra_rows = np.concatenate([np.repeat(gi, length), np.tile(i, n_global)])
        extra_cols = np.concatenate([np.tile(i, n_global), np.repeat(gi, length)])
        rows = np.concatenate([rows, extra_rows])
        cols = np.concatenate([cols, extra_cols])
        lin = rows * length + cols
        lin = np.unique(lin)
        rows, cols = lin // length, lin % length
    return rows.astype(np.int32), cols.astype(np.int32)


def bigbird_block_pattern(length, *, block=128, n_window=1, n_random=2, n_global=1, seed=0):
    """Block pattern for :func:`block_sparse_attention` in the BigBird
    style: each query block attends its ``n_window`` neighbor blocks each
    side (plus itself), ``n_random`` random blocks (``np.random.default_rng
    (seed)``, so ``sparse_tpu.nn``'s draw), and the first ``n_global``
    blocks. Host-side; deduplicated per row. Returns ``(block_ids,
    block_valid)``."""
    nb = -(-length // block)
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(nb):
        sel = set(range(n_global))
        sel.update(range(max(b - n_window, 0), min(b + n_window + 1, nb)))
        pool = [x for x in range(nb) if x not in sel]
        if pool and n_random:
            sel.update(rng.choice(pool, size=min(n_random, len(pool)), replace=False).tolist())
        rows.append(sorted(sel))
    nsel = max(len(r) for r in rows)
    ids = np.zeros((nb, nsel), dtype=np.int32)
    valid = np.zeros((nb, nsel), dtype=bool)
    for b, r in enumerate(rows):
        ids[b, : len(r)] = r
        valid[b, : len(r)] = True
    return ids, valid


def build_attention_ell(rows, cols, length):
    """Row-ELL layout of an attention pattern: pad every query row to the
    max degree. Host-side. Returns ``(e_cols (L, cap) int32, valid (L, cap)
    bool)`` NumPy arrays for :func:`sparse_attention_ell`. Rows must be
    canonical (sorted)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    counts = np.bincount(rows, minlength=length)
    cap = max(int(counts.max()), 1)
    e_cols = np.zeros((length, cap), dtype=np.int32)
    valid = np.zeros((length, cap), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(rows.size) - starts[rows]
    e_cols[rows, within] = cols
    valid[rows, within] = True
    return e_cols, valid


# ---------------------------------------------------------------------------
# patterns kept across calls
# ---------------------------------------------------------------------------

_MEMO_SIZE = 32
# sparse_tpu.nn's _ATTENTION_ELL_MEMO: (id(rows), id(cols), L) -> (rows, cols,
# e_cols, valid, {device: (e_cols, valid, layouts) there}), e_cols None where
# the route was refused; the first call's choice stands, as there. `layouts`
# keeps K6's tile layouts of the device copies (kernels.attention.attention_blocks)
_ATTENTION_ELL_MEMO = {}
# (id(rows), id(cols), n_rows, n_cols, device) -> _CooPattern
_COO_PATTERN_MEMO = {}


def _remember(memo, key, value):
    memo[key] = value
    if len(memo) > _MEMO_SIZE:
        memo.pop(next(iter(memo)))


def _versions(*xs):
    """In-place edits of the tensors among ``xs`` (their version counters);
    a NumPy array's go unseen, as in ``sparse_tpu.nn``'s memo."""
    return tuple(x._version if isinstance(x, torch.Tensor) else None for x in xs)


@dataclasses.dataclass
class _CooPattern:
    """A COO pattern on a device with the orders its kernels sum in: the
    :class:`~sparse_tpu_torch.kernels.dot.SddmmPattern` (rows, then columns
    for the gradients) and the row ids in row order with the permutation
    that sorts them (None when they come sorted) for the segment softmax."""

    rows: torch.Tensor
    cols: torch.Tensor
    sddmm: SddmmPattern
    seg: torch.Tensor  # int64 row ids in row order
    order: torch.Tensor | None
    source: tuple  # the caller's (rows, cols) objects
    versions: tuple


def _coo_pattern(rows, cols, n_rows, n_cols, device):
    """The :class:`_CooPattern` of ``(rows, cols)``, kept across calls by
    the identity of the caller's arrays (NumPy or tensors; a tensor edited
    in place is built anew). A NumPy pattern is checked sorted on the host,
    once; a tensor pattern is not read back: its rows are put in order by a
    stable sort, once."""
    key = (id(rows), id(cols), n_rows, n_cols, device)
    hit = _COO_PATTERN_MEMO.get(key)
    if hit is not None and hit.source[0] is rows and hit.source[1] is cols and hit.versions == _versions(rows, cols):
        return hit
    on_host = not isinstance(rows, torch.Tensor)
    rows_sorted = on_host and bool(np.all(np.diff(np.asarray(rows)) >= 0))
    rows_t = wide_index(_on(rows, device))
    cols_t = wide_index(_on(cols, device))
    if rows_t.ndim != 1 or cols_t.shape != rows_t.shape:
        raise ValueError(f"rows {tuple(rows_t.shape)} and cols {tuple(cols_t.shape)} must be 1-D of one length")
    pattern = SddmmPattern(rows_t, cols_t, n_rows, n_cols, rows_sorted=rows_sorted, kept=True)
    _, order, _, _ = pattern.plan(0)
    seg = rows_t.long() if order is None else rows_t.long()[order]
    entry = _CooPattern(rows_t, cols_t, pattern, seg, order, (rows, cols), _versions(rows, cols))
    _remember(_COO_PATTERN_MEMO, key, entry)
    return entry


# ---------------------------------------------------------------------------
# graph convolution and the segment softmax
# ---------------------------------------------------------------------------


def graph_conv(rows, cols, vals, x, w, *, n_nodes):
    """GCN propagation: ``Â (x @ w)`` with ``Â`` a normalized sparse
    adjacency given as COO triplets (``n_nodes`` rows). Differentiable in
    ``vals``, ``x`` and ``w``.

    ``x @ w`` is one ``torch.matmul`` at full float32 whatever the caller's
    TF32 setting; ``Â`` times it runs, for float32/float64, on K5 (the
    fixed-order row sum of ``csrc/mttkrp.cu``) on the GPU, its gradient on
    K4 and K5, the same bits every call; the plain version on the CPU and
    for other dtypes. The pattern's row order is kept across calls on the
    identity of ``rows`` and ``cols``."""
    device = _device_of(rows, cols, vals, x, w)
    x, w = _on(x, device), _on(w, device)
    with _full_f32_matmul():
        xw = x @ w
    vals = _on(vals, device)
    dt = _promote(vals.dtype, xw.dtype)
    vals, xw = vals.to(dt), xw.to(dt)
    pattern = _coo_pattern(rows, cols, n_nodes, xw.shape[0], device)
    if dt in _KERNEL_DTYPES:
        return _SampledRowSum.apply(pattern.sddmm, 0, vals, xw)
    return sampled_row_sum_plain(pattern.rows, pattern.cols, vals, xw, n_nodes)


def _softmax_runs(scores, seg, n_rows, mask):
    """The reference's CPU formulation (``sparse_tpu/nn.py:200-206``) over
    scores in row order: row max (``isfinite``-guarded), ``exp``, the mask,
    the row sum (``0 → 1``)."""
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    if mask is not None:
        scores = torch.where(mask, scores, neg_inf)
    row_max = segment_reduce(scores, seg, n_rows, op="max")
    shifted = scores - torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))[seg]
    expd = torch.exp(shifted)
    if mask is not None:
        expd = torch.where(mask, expd, torch.zeros_like(expd))
    denom = segment_reduce(expd, seg, n_rows, op="sum")
    return expd / torch.where(denom == 0, torch.ones_like(denom), denom)[seg]


def _in_order(x, order):
    return x if order is None or x is None else x[order]


def _back_in_place(x, order):
    return x if order is None else torch.empty_like(x).index_copy_(0, order, x)


class _SegmentSoftmax(torch.autograd.Function):
    """The segment softmax over ``seg`` (int64 row ids in row order; entries
    taken through ``order`` when not None) with its gradient ``y · (g − Σ_row
    y·g)``: what autograd of the forward gives with the row max detached
    (its gradient cancels: a softmax does not change when its inputs shift
    together). Sums in a fixed order, so the same bits every call."""

    @staticmethod
    def forward(ctx, scores, seg, order, mask, n_rows):
        y = _softmax_runs(_in_order(scores, order), seg, n_rows, _in_order(mask, order))
        ctx.save_for_backward(y, seg, order)
        ctx.n_rows = n_rows
        return _back_in_place(y, order)

    @staticmethod
    def backward(ctx, g):
        y, seg, order = ctx.saved_tensors
        gs = _in_order(g, order)
        total = segment_reduce(y * gs, seg, ctx.n_rows, op="sum")
        return _back_in_place(y * (gs - total[seg]), order), None, None, None, None


def segment_softmax(scores, rows, *, n_rows, mask=None):
    """Numerically stable softmax over the row segments of a COO pattern.

    ``scores``: (nnz,) logits at the stored coordinates; ``rows`` their row
    ids; ``mask``: optional (nnz,) bool, False entries get weight 0 (padding
    slots of capacity-bounded patterns). Rows need not be sorted: a NumPy
    ``rows`` is checked on the host, a tensor one is put in order by a
    stable sort. Differentiable in ``scores`` (:class:`_SegmentSoftmax`; the
    row max is detached, since its gradient cancels)."""
    device = _device_of(scores, rows, mask)
    scores = _on(scores, device)
    if not isinstance(rows, torch.Tensor) and bool(np.all(np.diff(np.asarray(rows)) >= 0)):
        seg, order = _on(rows, device).long(), None
    else:
        seg, order = torch.sort(wide_index(_on(rows, device)).long(), stable=True)
    mask = None if mask is None else _on(mask, device, torch.bool)
    return _SegmentSoftmax.apply(scores, seg, order, mask, n_rows)


# ---------------------------------------------------------------------------
# sparse attention: the COO and row-ELL routes
# ---------------------------------------------------------------------------


def _ell_route(rows, cols, length, max_ell_blowup, device):
    """The row-ELL layout of a host pattern on ``device`` with the dict
    that keeps its tile layouts, or None where ``sparse_tpu.nn.sparse_attention``
    takes its COO route (the blowup guard and the 2^26-slot cap), memoized
    as there."""
    key = (id(rows), id(cols), length)
    hit = _ATTENTION_ELL_MEMO.get(key)
    if hit is None or hit[0] is not rows or hit[1] is not cols:
        cap = int(np.bincount(rows, minlength=length).max())
        e_cols = valid = None
        if length * cap <= max_ell_blowup * rows.size and length * cap <= (1 << 26):
            # build_attention_ell takes rows in order: unsorted ones are put in order, not trusted
            order = slice(None) if bool(np.all(np.diff(rows) >= 0)) else np.argsort(rows, kind="stable")
            e_cols, valid = build_attention_ell(rows[order], cols[order], length)
        hit = (rows, cols, e_cols, valid, {})
        _remember(_ATTENTION_ELL_MEMO, key, hit)
    if hit[2] is None:
        return None
    copies = hit[4]
    if device not in copies:
        copies[device] = (torch.as_tensor(hit[2], device=device), torch.as_tensor(hit[3], device=device), {})
    return copies[device]


def sparse_attention(q, k, v, rows, cols, *, scale=None, mask=None, max_ell_blowup=4.0):
    """Attention restricted to a sparse (query, key) pattern.

    ``rows``/``cols``: the COO pattern of allowed edges (NumPy arrays or
    tensors on ``q``'s device), e.g. a sliding window with global tokens.
    Computes, only at the stored edges:

        scores = (q @ kᵀ) · scale      (scale 1/sqrt(d) by default)
        attn   = softmax_row(scores)
        out    = attn @ v

    q: (Lq, d), k: (Lk, d), v: (Lk, dv) → (Lq, dv). Differentiable in q, k
    and v. ``mask`` marks valid entries of a capacity-padded pattern.

    The route is ``sparse_tpu.nn.sparse_attention``'s. A host pattern (NumPy
    ``rows`` and ``cols``) with no ``mask`` whose padded row-ELL layout has
    at most ``max_ell_blowup`` times its edges and at most 2^26 slots runs
    :func:`sparse_attention_ell` (K6); the layout and the choice are kept
    across calls on the arrays' identity, with K6's tile layout (built on
    the first float32 call on a card). Every other pattern, tensors
    included (no read back to the host), takes the COO route: the scores by
    K4 (``k.T`` read in place), :func:`segment_softmax`, ``attn @ v`` by K5,
    for float32/float64 on the GPU; the gradient on K4 and K5. One pattern
    serves the scores and the output, kept across calls on the identity of
    ``rows`` and ``cols``: a sorted host pattern is never sorted again, and
    unsorted rows are put in order, not trusted."""
    device = _device_of(q, k, v, rows, cols, mask)
    q, k, v = _on(q, device), _on(k, device), _on(v, device)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    if mask is None and type(rows) is np.ndarray and type(cols) is np.ndarray and rows.size:
        ell = _ell_route(rows, cols, q.shape[0], max_ell_blowup, device)
        if ell is not None:
            e_cols, valid, layouts = ell
            return ell_attention(q, k, v, e_cols, valid, scale=scale, layouts=layouts)
    pattern = _coo_pattern(rows, cols, q.shape[0], k.shape[0], device)
    dt = _promote(q.dtype, k.dtype)
    scores = _sddmm(
        pattern.rows, pattern.cols, torch.ones(pattern.rows.shape[0], dtype=dt, device=device), q.to(dt), k.to(dt).T,
        pattern.sddmm,
    ) * scale
    mask = None if mask is None else _on(mask, device, torch.bool)
    attn = _SegmentSoftmax.apply(scores, pattern.seg, pattern.order, mask, q.shape[0])
    ot = _promote(attn.dtype, v.dtype)
    attn, v = attn.to(ot), v.to(ot)
    if ot in _KERNEL_DTYPES:
        return _SampledRowSum.apply(pattern.sddmm, 0, attn, v)
    return sampled_row_sum_plain(pattern.rows, pattern.cols, attn, v, q.shape[0])


def sparse_attention_ell(q, k, v, e_cols, valid, *, scale=None):
    """Sparse attention over a row-ELL pattern (:func:`build_attention_ell`):
    query row ``i`` attends the keys ``e_cols[i, j]`` where ``valid[i, j]``.

    q (L, d), k (Lk, d), v (Lk, dv), e_cols/valid (L, cap) → (L, dv), in
    the promoted dtype. ``e_cols``/``valid`` given as NumPy are copied once
    to ``q``'s device. float32/float64 on the GPU run K6
    (:func:`~sparse_tpu_torch.kernels.attention.ell_attention`), which
    writes none of the reference's ``(L, cap, d + dv)`` blocks; its tile
    layout is kept on the identity of the int32/int64 tensors ``e_cols``
    and ``valid`` (anything else is copied, and laid out, every call), and
    so is the slot pattern of its gradient, which runs K6's backward kernel
    and K5 (``dk``, ``dv``) on the card."""
    device = _device_of(q, k, v, e_cols, valid)
    q, k, v = _on(q, device), _on(k, device), _on(v, device)
    e_cols = wide_index(_on(e_cols, device))
    return ell_attention(q, k, v, e_cols, _on(valid, device, torch.bool), scale=scale)


# ---------------------------------------------------------------------------
# the dense block forms
# ---------------------------------------------------------------------------


def _check_precision(precision):
    """``precision``: None or "highest" (the contractions run at full float32
    whatever the caller's TF32 setting); anything else raises."""
    if precision is None or (isinstance(precision, str) and precision.lower() == "highest"):
        return
    raise ValueError(f"precision must be None or 'highest' (full float32), not {precision!r}")


def _acc_dtype(*ts):
    """The dtype scores and output accumulate in: float32 for bfloat16 and
    float16 inputs, else their promoted dtype."""
    dt = _promote(*(t.dtype for t in ts))
    return torch.float32 if dt in _HALF else dt


def _masked_softmax(scores, allowed):
    """``sparse_tpu.nn``'s dense masked softmax over the last axis: masked
    to -inf, the max ``isfinite``-guarded, masked ``exp``, the sum ``0 → 1``."""
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    scores = torch.where(allowed, scores, neg_inf)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    e = torch.where(allowed, e, torch.zeros_like(e))
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.where(denom == 0, torch.ones_like(denom), denom)


def _block_attention(qb, ks, vs, allowed, scale):
    """Scores ``qb @ ksᵀ · scale``, the masked softmax, ``@ vs``, batched over
    blocks, the products at full float32."""
    with _full_f32_matmul():
        scores = torch.matmul(qb, ks.transpose(1, 2)) * scale
        return torch.matmul(_masked_softmax(scores, allowed), vs)


def _stripe(length, block, window, device):
    """``(nb, starts' stripe positions (nb, block + 2·window))``: query block
    ``b``'s key stripe covers ``[b·block − window, b·block + block + window)``."""
    nb = -(-length // block)
    starts = torch.arange(nb, device=device) * block - window
    return nb, starts[:, None] + torch.arange(block + 2 * window, device=device)[None, :]


def _query_positions(nb, block, device):
    return (torch.arange(nb, device=device) * block)[:, None, None] + torch.arange(block, device=device)[None, :, None]


def banded_attention(q, k, v, *, window, scale=None, block=128, causal=False, precision=None):
    """Sliding-window attention as dense block compute: queries in blocks of
    ``block`` share one contiguous key stripe of ``block + 2·window``
    positions. O(L·(2W+block)·d).

    ``causal=True`` additionally masks future positions (each query attends
    keys in ``[i-window, i]``). Equivalent to :func:`sparse_attention` on
    ``local_attention_pattern(L, window)`` for the non-causal case.
    q (L, d), k (L, d), v (L, dv) → (L, dv) in ``q``'s dtype; bfloat16 and
    float16 inputs accumulate in float32. ``precision``: None or
    "highest"."""
    _check_precision(precision)
    device = _device_of(q, k, v)
    q, k, v = _on(q, device), _on(k, device), _on(v, device)
    L, d = q.shape
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    acc = _acc_dtype(q, k, v)
    nb, stripe_pos = _stripe(L, block, window, device)
    Lp = nb * block
    qb = torch.nn.functional.pad(q.to(acc), (0, 0, 0, Lp - L)).reshape(nb, block, d)
    flat = stripe_pos.clamp(0, k.shape[0] - 1).reshape(-1)
    ks = k.to(acc).index_select(0, flat).reshape(nb, -1, d)
    vs = v.to(acc).index_select(0, flat).reshape(nb, -1, v.shape[1])
    qpos = _query_positions(nb, block, device)
    kpos = stripe_pos[:, None, :]
    in_band = ((qpos - kpos).abs() <= window) & (kpos >= 0) & (kpos < k.shape[0])
    if causal:
        in_band &= kpos <= qpos
    out = _block_attention(qb, ks, vs, in_band, scale)
    return out.reshape(Lp, v.shape[1])[:L].to(q.dtype)


def block_sparse_attention(q, k, v, block_ids, block_valid, *, scale=None, block=128, causal=False, precision=None):
    """Attention over a block-granular sparsity pattern: query block ``b``
    attends exactly the key blocks listed in ``block_ids[b]`` (padded;
    ``block_valid`` flags real entries) — the window / random / global
    block patterns of BigBird (:func:`bigbird_block_pattern`). q (L, d),
    k/v (Lk, ·) with ``L`` and ``Lk`` multiples of ``block`` → (L, dv) in
    ``q``'s dtype. ``causal`` masks future positions inside selected
    blocks. ``precision``: None or "highest"."""
    _check_precision(precision)
    device = _device_of(q, k, v, block_ids, block_valid)
    q, k, v = _on(q, device), _on(k, device), _on(v, device)
    block_ids = _on(block_ids, device).long()
    block_valid = _on(block_valid, device, torch.bool)
    L, d = q.shape
    Lk = k.shape[0]
    if L % block or Lk % block:
        raise ValueError(f"sequence lengths ({L}, {Lk}) must be multiples of block={block}")
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    acc = _acc_dtype(q, k, v)
    nb, nsel = block_ids.shape
    if nb != L // block:
        raise ValueError(f"block_ids rows {nb} != L/block {L // block}")
    qb = q.to(acc).reshape(nb, block, d)
    flat = (block_ids[:, :, None] * block + torch.arange(block, device=device)[None, None, :]).reshape(nb, nsel * block)
    flat = flat.clamp(0, Lk - 1)
    ks = k.to(acc).index_select(0, flat.reshape(-1)).reshape(nb, nsel * block, d)
    vs = v.to(acc).index_select(0, flat.reshape(-1)).reshape(nb, nsel * block, v.shape[1])
    allowed = torch.repeat_interleave(block_valid, block, dim=1)[:, None, :]
    if causal:
        allowed = allowed & (flat[:, None, :] <= _query_positions(nb, block, device))
    out = _block_attention(qb, ks, vs, allowed, scale)
    return out.reshape(L, v.shape[1]).to(q.dtype)


def longformer_attention(q, k, v, *, window, n_global=0, scale=None, block=128, precision=None):
    """Sliding-window + global-token attention (the Longformer pattern) as
    dense block compute, the composite of :func:`banded_attention`:

    - every query attends its ``window`` band **and** the first ``n_global``
      keys (global columns appended to each block's key stripe);
    - the first ``n_global`` queries attend **all** keys (a dense
      (n_global × L) strip replacing those rows).

    Matches :func:`sparse_attention` on ``local_attention_pattern(L, window,
    n_global)``. q (L, d) → (L, dv) in ``q``'s dtype. ``precision``: None
    or "highest"."""
    _check_precision(precision)
    device = _device_of(q, k, v)
    q, k, v = _on(q, device), _on(k, device), _on(v, device)
    L, d = q.shape
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    acc = _acc_dtype(q, k, v)
    G = n_global
    nb, stripe_pos = _stripe(L, block, window, device)
    S = stripe_pos.shape[1]
    Lp = nb * block
    qb = torch.nn.functional.pad(q.to(acc), (0, 0, 0, Lp - L)).reshape(nb, block, d)
    if G:
        glob = torch.arange(G, device=device)[None, :].expand(nb, G)
        stripe_pos = torch.cat([stripe_pos, glob], dim=1)
    flat = stripe_pos.clamp(0, k.shape[0] - 1).reshape(-1)
    ks = k.to(acc).index_select(0, flat).reshape(nb, S + G, d)
    vs = v.to(acc).index_select(0, flat).reshape(nb, S + G, v.shape[1])
    qpos = _query_positions(nb, block, device)
    kpos = stripe_pos[:, None, :]
    in_band = ((qpos - kpos).abs() <= window) & (kpos >= 0) & (kpos < k.shape[0])
    if G:
        is_global_col = torch.cat(
            [torch.zeros((nb, 1, S), dtype=torch.bool, device=device), torch.ones((nb, 1, G), dtype=torch.bool, device=device)],
            dim=2,
        )
        # a band stripe may also cover a global position: keep one copy (the band's)
        dup = (kpos < G) & is_global_col & ((qpos - kpos).abs() <= window)
        allowed = (in_band | is_global_col) & ~dup
    else:
        allowed = in_band
    out = _block_attention(qb, ks, vs, allowed, scale).reshape(Lp, v.shape[1])[:L].to(q.dtype)
    if G:
        # global rows: dense attention over all keys
        with _full_f32_matmul():
            gs = (q[:G].to(acc) @ k.to(acc).T) * scale
            rows_g = (torch.softmax(gs, dim=-1) @ v.to(acc)).to(q.dtype)
        out = torch.cat([rows_g, out[G:]])
    return out


# ---------------------------------------------------------------------------
# the sequence-sharded forms (a mesh of ranks, parallel.make_mesh)
# ---------------------------------------------------------------------------


def banded_attention_sharded(q, k, v, *, window, mesh, axis_name="x", block=128, causal=False):
    """Sequence-parallel :func:`banded_attention` over a 1-D mesh: each rank
    holds ``L / size`` rows of q, k and v (slices of the global arrays, or
    DTensors sharded so), takes the last ``window`` rows of k and v from its
    predecessor and the first ``window`` from its successor
    (``batch_isend_irecv``; the ring wraps, where the mask drops the keys
    past either end), and runs the blocked band attention on its segment:
    each block of queries against its stripe of ``block + 2·window`` keys,
    global positions, ``causal`` masking, scale ``1/√d``; bfloat16 and
    float16 accumulate in float32. Returns the global ``(L, dv)`` on every
    rank, in q's dtype, on the mesh's device. ``L`` must divide over the
    ranks and a segment be a multiple of ``block`` and at least
    ``window``."""
    from .parallel.sharding import _gather, _local, _mesh_dim, _rotate

    dim = _mesh_dim(mesh, axis_name)
    size, coord = mesh.size(dim), mesh.get_local_rank(dim)
    L = q.shape[0]
    if L % size:
        raise ValueError(f"sequence length {L} must divide over {size} devices")
    seg_len = L // size
    if seg_len % block or window > seg_len:
        raise ValueError(f"segment {seg_len} must be a multiple of block={block} and >= window={window}")
    qs, ks, vs = (_local(x, mesh, axis_name) for x in (q, k, v))
    # the halos: [predecessor's last window | own | successor's first window]
    k_ext = torch.cat([_rotate(ks[-window:], mesh, axis_name, shift=-1), ks, _rotate(ks[:window], mesh, axis_name)])
    v_ext = torch.cat([_rotate(vs[-window:], mesh, axis_name, shift=-1), vs, _rotate(vs[:window], mesh, axis_name)])
    d = qs.shape[-1]
    acc = _acc_dtype(qs, ks, vs)
    nb = seg_len // block
    device = qs.device
    stripe = torch.arange(block + 2 * window, device=device)[None, :] + (torch.arange(nb, device=device) * block)[:, None]
    flat = stripe.reshape(-1)
    kb = k_ext.to(acc).index_select(0, flat).reshape(nb, -1, d)
    vb = v_ext.to(acc).index_select(0, flat).reshape(nb, -1, v_ext.shape[-1])
    offset = coord * seg_len
    qpos = offset + _query_positions(nb, block, device)
    kpos = offset + stripe[:, None, :] - window
    in_band = ((qpos - kpos).abs() <= window) & (kpos >= 0) & (kpos < size * seg_len)
    if causal:
        in_band &= kpos <= qpos
    out = _block_attention(qs.to(acc).reshape(nb, block, d), kb, vb, in_band, 1.0 / np.sqrt(d))
    return _gather(out.reshape(seg_len, -1).to(qs.dtype), mesh, axis_name)


def partition_attention_pattern(rows, cols, length, n_shards):
    """Partition an attention edge pattern by query-row blocks for
    :func:`sparse_attention_sharded`. Host NumPy, ``sparse_tpu.nn``'s
    arrays: ``(local_rows, cols, valid, block_rows)``, the three ``(n_shards,
    cap)`` (int32, int32, bool; ``valid`` flags real edges) with a common
    capacity a shard."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    block_rows = -(-length // n_shards)
    shard_of = rows // block_rows
    counts = np.bincount(shard_of, minlength=n_shards)
    cap = max(int(counts.max()), 1)
    lr = np.zeros((n_shards, cap), dtype=np.int32)
    lc = np.zeros((n_shards, cap), dtype=np.int32)
    valid = np.zeros((n_shards, cap), dtype=bool)
    for s in range(n_shards):
        sel = shard_of == s
        c = int(counts[s])
        lr[s, :c] = rows[sel] - s * block_rows
        lc[s, :c] = cols[sel]
        valid[s, :c] = True
    return lr, lc, valid, block_rows


def sparse_attention_sharded(q, k, v, local_rows, cols, valid, block_rows, mesh, axis_name="x"):
    """Sequence-sharded :func:`sparse_attention` over a 1-D mesh: the query
    rows and their pattern edges block-partitioned over the ranks (inputs
    from :func:`partition_attention_pattern`; ``n_shards`` a multiple of the
    mesh's size, a rank taking its consecutive shards), k and v replicated.
    A shard runs the COO route: its scores on K4 (the SDDMM) times
    ``1/√d``, :func:`segment_softmax` with the shard's ``valid`` mask, the
    weighted sum on K5; no collective but the output's gather. Returns the
    global ``(L, dv)`` on every rank, on the mesh's device."""
    from .parallel.sharding import _gather, _locals, _replicated

    n_shards = local_rows.shape[0]
    L = q.shape[0]
    q_pad = torch.nn.functional.pad(_replicated(q, mesh), (0, 0, 0, n_shards * block_rows - L))
    q_blocks = q_pad.reshape(n_shards, block_rows, q_pad.shape[1])
    qb, lr, lc, m = _locals(mesh, axis_name, q_blocks, local_rows, cols, valid)
    k, v = _replicated(k, mesh), _replicated(v, mesh)
    outs = [sparse_attention(q_, k, v, r_, c_, mask=m_) for q_, r_, c_, m_ in zip(qb, lr, lc, m)]
    out = _gather(torch.stack(outs), mesh, axis_name)
    return out.reshape(n_shards * block_rows, -1)[:L]
