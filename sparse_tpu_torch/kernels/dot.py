"""COO products as torch gather + ``index_add_``, and the sorted-segment MTTKRP.

``coo_spmm``/``coo_spmv`` are the path for the dtypes the row-ELL kernels do
not take (integers, complex, float16): ``ops.dot`` sends those here by dtype,
as ``sparse_tpu`` keeps them off its row-ELL path. Same functions as
``sparse_tpu.kernels.dot.coo_spmm`` and ``coo_spmv``.

``mttkrp`` is ``sparse_tpu.kernels.dot.mttkrp``: for float32/float64
tensors on the GPU it runs the hand-written CUDA kernel of
``csrc/mttkrp.cu`` (counted as ``coo_mttkrp``), with each row's run found by
``torch.searchsorted`` and the pieces of the long runs by one ``cumsum``
(``_cuda.run_pieces``), both on the device; ``mttkrp_plain`` beside it is
its plain PyTorch version, taken for tensors on the CPU and, by dtype before
any launch, for integer and bool data on any device (products and sums in
NumPy's promoted dtype, the unsigned types through their signed views). The differentiable core (``_Mttkrp``) is shared
with the block-ELL form, ``ell.ell_mttkrp``.

``sddmm`` is ``sparse_tpu.kernels.dot.sddmm``: for float32/float64 tensors
on the GPU it runs the hand-written CUDA kernel K4 of ``csrc/sddmm.cu``
(counted as ``sddmm``) or raises; other dtypes take ``sddmm_plain`` by
dtype, as ``sparse_tpu`` routes float16 and complex off its kernel. Its
gradient in the sample values, ``lhs`` and ``rhs`` is a
``torch.autograd.Function`` whose backward runs K4 again and K5, the
weighted row sum of ``csrc/mttkrp.cu`` (``sampled_row_sum_plain`` beside
it), in a fixed order and twice differentiable. K5 has three routes with
the same bits (``_cuda.row_sum_route``): the gather route (counted
``sampled_row_sum``), the sliced route for tables past L2
(``sampled_row_sum_sliced``) and, for a pattern kept across calls, the union
route on the blocks of its union layout (``row_sum_union_layout``; counted
``sampled_row_sum_union``, ``sampled_row_sum_union_plain`` beside it) with
the gather route on the blocks the layout flags. ``dense_coo_matmul`` is
dense × COO as gather + ``index_add_``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._utils import as_int64, result_dtype, signed_view, sum_dtype, take, wide_index
from . import _cuda


def coo_spmm(rows, cols, data, dense, *, n_rows):
    """``A @ B`` for COO ``A`` (zero fill) and dense ``B (K, N)`` of
    ``data``'s dtype → ``(n_rows, N)``."""
    out = torch.zeros((n_rows, dense.shape[1]), dtype=data.dtype, device=data.device)
    signed_view(out).index_add_(0, rows.long(), signed_view(data)[:, None] * signed_view(dense)[cols.long()])
    return out


def dense_coo_matmul(dense, rows, cols, data, *, n_out_cols):
    """``B @ A``: dense ``B (M, K)`` × COO ``A (K, N)`` of ``dense``'s dtype
    → dense ``(M, N)``, with no host read: the columns ``B[:, rows]`` times
    ``data``, added into the output columns ``cols``."""
    out = torch.zeros((n_out_cols, dense.shape[0]), dtype=dense.dtype, device=dense.device)
    prod = signed_view(dense).T[rows.long()] * signed_view(data)[:, None]  # (nnz, M)
    signed_view(out).index_add_(0, cols.long(), prod)
    return out.T


def coo_spmv(rows, cols, data, x, *, n_rows):
    """``A @ x`` for COO ``A`` and a dense vector ``x`` of ``data``'s dtype → ``(n_rows,)``."""
    out = torch.zeros(n_rows, dtype=data.dtype, device=data.device)
    signed_view(out).index_add_(0, rows.long(), signed_view(data) * signed_view(x)[cols.long()])
    return out


# ---------------------------------------------------------------------------
# MTTKRP: out[i, :] = Σ_{e in row i} v[e] · C[j[e], :] · D[k[e], :]
# ---------------------------------------------------------------------------

MTTKRP_STRATEGIES = ("exact", "hilo", "bf16")
_KERNEL_DTYPES = (torch.float32, torch.float64)
_PLAIN_DTYPES = (
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint8, torch.uint16, torch.uint32, torch.uint64,
)  # fmt: skip


def mttkrp_dtypes(data, c, d, strategy="exact"):
    """``(value dtype, table dtype)`` of an MTTKRP, as ``sparse_tpu`` computes
    it: NumPy promotion of the three for ``"exact"``/``"hilo"``; for
    ``"bf16"`` bfloat16 tables and ``data``'s dtype. The value dtype is
    float32, float64, an integer type or bool, else ``TypeError``."""
    vt = data.dtype if strategy == "bf16" else result_dtype(data.dtype, c.dtype, d.dtype)
    if vt not in _KERNEL_DTYPES + _PLAIN_DTYPES:
        raise TypeError(f"mttkrp computes in float32, float64, an integer type or bool, not {vt}")
    return vt, torch.bfloat16 if strategy == "bf16" else vt


def on_kernel(device, vt):
    """Whether an MTTKRP of value dtype ``vt`` on ``device`` launches its
    kernel: float32/float64 on the GPU. Decided before any launch; integer
    and bool data take the plain version on every device."""
    return device.type != "cpu" and vt in _KERNEL_DTYPES


def _as_int(x, dt):
    """Float ``x`` truncated to the integer or bool dtype ``dt`` (the
    unsigned types through int64 and their signed views)."""
    signed = signed_view(torch.empty(0, dtype=dt)).dtype
    if signed == dt:
        return x.to(dt)
    return x.to(torch.int64).to(signed).view(dt)


def slot_rows(rows, block_rows=0):
    """The int64 output row of every slot, flat: ``rows`` itself for the COO
    form (``block_rows=0``); ``block · block_rows + rows[block, slot]`` for
    a block-ELL ``rows`` of local row ids ``(n_blocks, cap)``."""
    if not block_rows:
        return rows.long()
    base = torch.arange(rows.shape[0], device=rows.device, dtype=torch.int64)[:, None] * block_rows
    return (rows.long() + base).reshape(-1)


def _products(cj, ck, v, c, d, strategy):
    """``(n_slots, r)``: ``v · (C[j] · D[k])`` in the value dtype, flat slots;
    ``"bf16"`` multiplies the bf16-rounded factors in float32 (exact) first."""
    vt, tt = mttkrp_dtypes(v, c, d, strategy)
    cg, dg = take(c.to(tt), cj.long()), take(d.to(tt), ck.long())
    if vt in _KERNEL_DTYPES:
        g = (cg.float() * dg.float()).to(vt) if strategy == "bf16" else cg * dg
        return v.to(vt)[:, None] * g
    # integers multiply modulo their width (unsigned as signed, the same
    # bits); bool as "and"
    g = _as_int(cg.float() * dg.float(), vt) if strategy == "bf16" else signed_view(cg) * signed_view(dg)
    return (signed_view(v.to(vt))[:, None] * signed_view(g)).view(vt)


def segment_sum(prods, rows, n_rows):
    """``out[rows[s]] += prods[s]`` into ``(n_rows, r)`` zeros; rows outside
    ``[0, n_rows)`` are dropped, as ``jax.ops.segment_sum`` drops them."""
    keep = (rows >= 0) & (rows < n_rows)
    if not bool(keep.all()):
        rows, prods = rows[keep], prods[keep]
    out = torch.zeros((n_rows, prods.shape[1]), dtype=prods.dtype, device=prods.device)
    signed_view(out).index_add_(0, rows, signed_view(prods))  # booleans add as "or"
    return out


def mttkrp_plain(coords_i, coords_j, coords_k, data, c, d, *, n_rows, block_rows=0, strategy="exact"):
    """The kernel's function in torch ops (gather, multiply, ``index_add_``),
    on any device. ``coords_i`` is the COO form's row ids (``block_rows=0``)
    or a block-ELL layout's local rows; ``coords_j``/``coords_k``/``data``
    have its shape."""
    prods = _products(coords_j.reshape(-1), coords_k.reshape(-1), data.reshape(-1), c, d, strategy)
    return segment_sum(prods, slot_rows(coords_i, block_rows), n_rows)


def check_indices(cj, ck, c, d, ci=None):
    """Raise ``IndexError`` unless every ``cj``/``ck`` indexes a row of
    ``c``/``d``, and ``ValueError`` unless ``ci`` (when given) is sorted:
    one host read for all of it. The kernel reads the factors unchecked."""
    if cj.numel() == 0:
        return
    flags = [cj.min() < 0, cj.max() >= c.shape[0], ck.min() < 0, ck.max() >= d.shape[0]]
    if ci is not None and ci.numel() > 1:
        flags.append((ci[1:] < ci[:-1]).any())
    bad = torch.stack(flags).tolist()
    if any(bad[:4]):
        raise IndexError(f"mttkrp: a j or k index is out of range for factors of {c.shape[0]} and {d.shape[0]} rows")
    if len(bad) > 4 and bad[4]:
        raise ValueError("mttkrp: coords_i must be sorted (sparse_tpu's segment sum assumes indices_are_sorted)")


def _mttkrp_forward(rows, block_rows, cj, ck, data, c, d, n_rows, strategy, row_ptr, order, pieces):
    vt, tt = mttkrp_dtypes(data, c, d, strategy)
    if not on_kernel(data.device, vt):
        return mttkrp_plain(rows, cj, ck, data, c, d, n_rows=n_rows, block_rows=block_rows, strategy=strategy)
    device = data.device
    _cuda.require_cuda(device, "MTTKRP")
    r = c.shape[1]
    out = torch.empty((n_rows, r), dtype=vt, device=device)
    n_front = _cuda.front_bound(data.numel(), n_rows, _cuda.MTTKRP_PIECE)
    partial = torch.empty(n_front * r, dtype=vt, device=device)
    tickets = _cuda.zeroed_tickets(device, n_front * -(-r // 32))
    i32 = torch.int32
    return _cuda.mttkrp(
        row_ptr,
        pieces,
        order,
        cj.reshape(-1).to(i32).contiguous(),
        ck.reshape(-1).to(i32).contiguous(),
        data.reshape(-1).to(vt).contiguous(),
        c.to(tt).contiguous(),
        d.to(tt).contiguous(),
        out,
        partial,
        tickets,
    )


class _Mttkrp(torch.autograd.Function):
    """Kernel forward (plain on the CPU); backward as torch ops, the VJP
    that JAX derives: ``d data[s] = Σ_r g[row(s)] · C[j] · D[k]``,
    ``dC = index_add_ by j of data · g[row] · D[k]``, ``dD`` likewise by k.
    For ``"bf16"`` the rounding of the factors passes the gradient straight
    through, in the value dtype."""

    @staticmethod
    def forward(ctx, rows, block_rows, cj, ck, data, c, d, n_rows, strategy, row_ptr, order, pieces):
        ctx.save_for_backward(rows, cj, ck, data, c, d)
        ctx.meta = (block_rows, n_rows, strategy)
        return _mttkrp_forward(rows, block_rows, cj, ck, data, c, d, n_rows, strategy, row_ptr, order, pieces)

    @staticmethod
    def backward(ctx, g):
        rows, cj, ck, data, c, d = ctx.saved_tensors
        block_rows, n_rows, strategy = ctx.meta
        vt, tt = mttkrp_dtypes(data, c, d, strategy)
        flat = slot_rows(rows, block_rows)
        g_ext = torch.cat([g.to(vt), g.new_zeros((1, g.shape[1]), dtype=vt)])
        gr = g_ext[torch.where((flat >= 0) & (flat < n_rows), flat, n_rows)]
        cf, df = c.to(tt).to(vt), d.to(tt).to(vt)
        cjl, ckl = cj.reshape(-1).long(), ck.reshape(-1).long()
        cg, dg = cf[cjl], df[ckl]
        v = data.reshape(-1).to(vt)[:, None]
        d_data = d_c = d_d = None
        if ctx.needs_input_grad[4]:
            d_data = (gr * cg * dg).sum(1).reshape(data.shape).to(data.dtype)
        if ctx.needs_input_grad[5]:
            d_c = torch.zeros_like(cf).index_add_(0, cjl, v * gr * dg).to(c.dtype)
        if ctx.needs_input_grad[6]:
            d_d = torch.zeros_like(df).index_add_(0, ckl, v * gr * cg).to(d.dtype)
        return None, None, None, None, d_data, d_c, d_d, None, None, None, None, None


def check_mttkrp_operands(what, tensors, c, d):
    """Tensors on one device; ``c`` and ``d`` 2-D with one rank ``r``."""
    device = c.device
    for name, t in (*tensors, ("c", c), ("d", d)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device} but c is on {device}")
    if c.ndim != 2 or d.ndim != 2 or c.shape[1] != d.shape[1]:
        raise ValueError(f"{what}: c {tuple(c.shape)} and d {tuple(d.shape)} must be (J, r) and (K, r)")


def mttkrp(coords_i, coords_j, coords_k, data, c, d, *, n_rows):
    """MTTKRP of a 3-D COO tensor B with entries sorted by ``coords_i``:
    ``out[i, r] = Σ_{(i,j,k) in B} B[i,j,k] · C[j, r] · D[k, r]`` → dense
    ``(n_rows, r)`` in the promoted dtype (float32 or float64 on the kernel;
    integers on the plain version, modulo their width; bool raises
    ``TypeError``, as ``sparse_tpu``'s segment sum refuses it).
    Differentiable in ``data``, ``c`` and ``d``.

    ``coords_i`` must be sorted (``ValueError`` otherwise; ``sparse_tpu``
    assumes it without checking); ``i`` outside ``[0, n_rows)`` is dropped,
    a ``j`` or ``k`` outside the factors raises ``IndexError``. The checks
    read one flag vector back from the device."""
    tensors = (("coords_i", coords_i), ("coords_j", coords_j), ("coords_k", coords_k), ("data", data))
    check_mttkrp_operands("mttkrp", tensors, c, d)
    coords_i, coords_j, coords_k = wide_index(coords_i), wide_index(coords_j), wide_index(coords_k)
    if not coords_i.ndim == coords_j.ndim == coords_k.ndim == data.ndim == 1 or not (
        coords_i.shape == coords_j.shape == coords_k.shape == data.shape
    ):
        raise ValueError("mttkrp: coords_i, coords_j, coords_k and data must be 1-D of one length")
    vt, _ = mttkrp_dtypes(data, c, d)
    if vt == torch.bool:
        raise TypeError("mttkrp: bool data has no sum (sparse_tpu's segment sum refuses bool)")
    kernel = on_kernel(data.device, vt)
    if kernel:
        _cuda.require_cuda(data.device, "MTTKRP")
    check_indices(coords_j, coords_k, c, d, ci=coords_i)
    row_ptr = pieces = None
    if kernel:
        ci = coords_i if coords_i.dtype == torch.int64 else coords_i.long()
        row_ptr = torch.searchsorted(ci, torch.arange(n_rows + 1, device=ci.device))
        pieces = _cuda.run_pieces(row_ptr, _cuda.MTTKRP_PIECE)
    return _Mttkrp.apply(coords_i, 0, coords_j, coords_k, data, c, d, n_rows, "exact", row_ptr, None, pieces)


def coo_sum_axes_dense(coords, data, *, shape, axes):
    """``x.sum(axis=axes)`` of a COO's triplet as a dense tensor of the kept
    shape, with no host read: the kept-axes key sorted (stable) and each run
    summed by ``torch.segment_reduce`` over offsets from ``searchsorted``
    (the same bits every call; integers exactly). The dtype stays ``data``'s,
    as in ``sparse_tpu.kernels.dot.coo_sum_axes_dense``."""
    from .segment import segment_reduce

    keep = tuple(d for d in range(len(shape)) if d not in set(axes))
    keep_shape = tuple(shape[d] for d in keep)
    if not keep:
        return data.sum(dtype=data.dtype).reshape(())
    keep_size = 1
    for s in keep_shape:
        keep_size *= s
    lin = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    stride = 1
    for d in reversed(keep):
        lin += coords[d].to(torch.int64) * stride
        stride *= shape[d]
    lin, order = torch.sort(lin, stable=True)
    return segment_reduce(data[order], lin, keep_size, op="sum").reshape(keep_shape)


# ---------------------------------------------------------------------------
# SDDMM: out[e] = s[e] · (lhs[rows[e], :] · rhs[:, cols[e]])
# ---------------------------------------------------------------------------

# sparse_tpu's chunking of its XLA form (kernels/dot.py:SDDMM_CHUNK): the plain
# version keeps it, so its two gathered (chunk, K) blocks bound its memory
SDDMM_CHUNK = 32768
SDDMM_CHUNK_MIN_NNZ = 4 * SDDMM_CHUNK
_HALF = (torch.float16, torch.bfloat16)


def _rowdot(rows, cols, sample_data, lhs, rhs_t):
    lg, rg = lhs[rows.long()], rhs_t[cols.long()]
    if lhs.dtype in _HALF:  # products and sum in float32, one rounding (NumPy's einsum)
        return sample_data * (lg.float() * rg.float()).sum(-1).to(lhs.dtype)
    if lhs.dtype.is_floating_point or lhs.dtype.is_complex:
        return sample_data * (lg * rg).sum(-1)
    # products in the operands' dtype, their sum in NumPy's (int64, or uint64
    # through its signed view: the same bits), as the reference's jnp.sum; the
    # unsigned products and samples zero-extend
    prod = (signed_view(lg) * signed_view(rg)).view(lhs.dtype)
    return (as_int64(sample_data) * as_int64(prod).sum(-1)).view(sum_dtype(lhs.dtype))


def sddmm_plain(rows, cols, sample_data, lhs, rhs):
    """K4's function in torch ops, on any device: gather ``lhs[rows]`` and
    ``rhs.T[cols]``, multiply, sum over K, times ``sample_data``; above
    ``SDDMM_CHUNK_MIN_NNZ`` entries in chunks of ``SDDMM_CHUNK``, as
    ``sparse_tpu`` scans them. The three operands share one dtype; float16
    and bfloat16 sum in float32 and round once; integers and bool multiply
    in their dtype and sum, and return, in NumPy's sum dtype (int64, or
    uint64 for the unsigned)."""
    nnz = rows.shape[0]
    rhs_t = rhs.T
    if nnz < SDDMM_CHUNK_MIN_NNZ:
        return _rowdot(rows, cols, sample_data, lhs, rhs_t)
    out = torch.empty(nnz, dtype=sum_dtype(lhs.dtype), device=sample_data.device)
    for start in range(0, nnz, SDDMM_CHUNK):
        sl = slice(start, start + SDDMM_CHUNK)
        out[sl] = _rowdot(rows[sl], cols[sl], sample_data[sl], lhs, rhs_t)
    return out


class RowSumUnion(NamedTuple):
    """K5's union layout of the segments ``ptr`` over a table of ``n_table``
    rows, in blocks of ``block`` consecutive segments (:func:`row_sum_union_layout`).

    ``union`` ``(n_blocks, u_cap)`` int32: block b's union, the sorted
    distinct table rows its entries name, in ``union[b, :n_union[b]]``, 0
    past it. ``n_union`` ``(n_blocks,)`` int32: the union's size, which may
    pass ``u_cap``. ``local`` ``(n,)`` int16: each entry's place in its
    block's union (``union[b, local[e]] == idx[e]``; at most ``u_cap - 1``,
    meaningless in a block whose union passes ``u_cap``). ``flag``
    ``(n_blocks,)`` bool: a union past ``u_cap``, fewer entries than
    ``reuse`` times the union, or a segment longer than
    ``_cuda.ROW_SUM_UNION_LONG`` entries; such a block takes the gather
    route.
    ``work`` ``(n_blocks,)`` int32: the blocks not flagged, in order, then
    the flagged; ``n_work`` ``(1,)`` int32 the count of the first.
    ``pieces``: :func:`~sparse_tpu_torch.kernels._cuda.run_pieces` of the
    flagged blocks' segments alone (the gather route's split segments)."""

    block: int
    n_table: int
    union: torch.Tensor
    n_union: torch.Tensor
    local: torch.Tensor
    flag: torch.Tensor
    work: torch.Tensor
    n_work: torch.Tensor
    pieces: torch.Tensor


def row_sum_union_layout(ptr, idx, n_table, block, u_cap, reuse, piece=None):
    """The :class:`RowSumUnion` of the segments ``ptr`` (int64 ``(n_seg +
    1,)``) whose entries name table rows ``idx`` (in segment order), on
    their device, by torch ops and nothing read back: one sort of
    ``block_id · n_table + idx`` over every entry, the first of each run
    marked and ranked, the ranks scattered back to the entries (the method
    of :func:`~sparse_tpu_torch.kernels.attention.build_attention_blocks`)."""
    piece = _cuda.MTTKRP_PIECE if piece is None else int(piece)
    if block < 1 or n_table < 1 or not 1 <= u_cap < 1 << 15:
        raise ValueError("row_sum_union_layout: block and n_table must be positive, u_cap in [1, 2^15)")
    dev = idx.device
    n_seg, n = ptr.shape[0] - 1, idx.shape[0]
    n_blocks = -(-n_seg // block)
    lens = ptr[1:] - ptr[:-1]
    seg_blk = torch.div(torch.arange(n_seg, device=dev), block, rounding_mode="floor")
    blk = torch.repeat_interleave(seg_blk, lens, output_size=n)
    skey, perm = torch.sort(blk * n_table + idx.long())
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    sblk = torch.div(skey, n_table, rounding_mode="floor")
    n_union = torch.zeros(n_blocks, dtype=torch.int64, device=dev).index_add_(0, sblk, first.long())
    start = torch.cumsum(n_union, 0) - n_union
    local = torch.cumsum(first, 0) - 1 - start[sblk]  # each entry's place in its block's union
    keep = first & (local < u_cap)
    union = torch.zeros(n_blocks * u_cap + 1, dtype=torch.int32, device=dev)
    union.index_put_((torch.where(keep, sblk * u_cap + local, n_blocks * u_cap),), (skey - sblk * n_table).to(torch.int32))
    local_e = torch.empty_like(local).scatter_(0, perm, local.clamp(max=u_cap - 1))
    bounds = torch.arange(n_blocks + 1, device=dev) * block
    entries = ptr[bounds.clamp(max=n_seg)]
    longest = torch.zeros(n_blocks, dtype=lens.dtype, device=dev).scatter_reduce_(0, seg_blk, lens, "amax")
    flag = (n_union > u_cap) | ((entries[1:] - entries[:-1]) < reuse * n_union) | (longest > _cuda.ROW_SUM_UNION_LONG)
    work = torch.sort(flag.to(torch.int32), stable=True).indices.to(torch.int32)
    n_work = (~flag).sum().to(torch.int32).reshape(1)
    return RowSumUnion(
        block,
        n_table,
        union[:-1].view(n_blocks, u_cap),
        n_union.to(torch.int32),
        local_e.to(torch.int16),
        flag,
        work,
        n_work,
        _cuda.run_pieces(ptr, piece, keep=flag[seg_blk]),
    )


class SddmmPattern:
    """The entries of an SDDMM in the two orders its gradient sums in: by
    row (``d lhs``, axis 0) and by column (``d rhs``, axis 1). For each
    axis, built on the device on its first use and kept, with no host
    read: the segment pointer (``searchsorted``), the entries' order in it
    (a stable sort of the segment ids, int32 keys where they fit; None when
    the ids come sorted, as a canonical COO's rows do), the pieces of the
    long segments and the other axis's ids in that order. A pattern ``kept``
    across calls (``nn``'s memo, the COO entry point's) also keeps K5's
    union layout of each axis (:meth:`union`), and K5 takes the union route
    on it. ``T`` is the same pattern with the axes swapped, sharing what was
    built."""

    def __init__(self, rows, cols, n_rows, n_cols, rows_sorted=False, kept=False):
        self.ends = (rows, cols)
        self.sizes = (n_rows, n_cols)
        self.ordered = (rows_sorted, False)
        self.kept = kept
        self._plans = ([], [])
        self._unions = ({}, {})

    @property
    def T(self):
        t = object.__new__(SddmmPattern)
        t.ends, t.sizes, t.ordered, t._plans = self.ends[::-1], self.sizes[::-1], self.ordered[::-1], self._plans[::-1]
        t.kept, t._unions = self.kept, self._unions[::-1]
        return t

    def plan(self, axis):
        """``(ptr, order, pieces, idx)`` of K5 summing along ``axis``:
        ``order`` int64 or None, ``idx`` the other axis's ids in that order,
        int32."""
        if not self._plans[axis]:
            seg, idx = self.ends[axis], self.ends[1 - axis]
            n = self.sizes[axis]
            key = torch.int32 if n < 2**31 - 1 else torch.int64
            seg = seg.to(key)
            order = None
            if not self.ordered[axis]:
                seg, order = torch.sort(seg, stable=True)
                idx = idx[order]
            ptr = torch.searchsorted(seg, torch.arange(n + 1, dtype=key, device=seg.device))
            pieces = _cuda.run_pieces(ptr, _cuda.MTTKRP_PIECE)
            self._plans[axis].append((ptr, order, pieces, idx.to(torch.int32).contiguous()))
        return self._plans[axis][0]

    def union(self, axis, itemsize):
        """K5's :class:`RowSumUnion` along ``axis`` for table values of
        ``itemsize`` bytes, built on its first use and kept."""
        ptr, _, _, idx = self.plan(axis)
        n_table = self.sizes[1 - axis]
        u_cap = _cuda.row_sum_union_capacity(itemsize, n_table, idx.shape[0])
        memo = self._unions[axis]
        if u_cap not in memo:
            memo[u_cap] = row_sum_union_layout(
                ptr, idx, n_table, _cuda.ROW_SUM_UNION_BLOCK, u_cap, _cuda.ROW_SUM_UNION_REUSE
            )
        return memo[u_cap]


def sampled_row_sum_plain(seg, idx, w, table, n_out):
    """K5's function in torch ops, on any device: ``out[i] = Σ w[e] ·
    table[idx[e]]`` over the entries ``e`` with ``seg[e] == i``, as
    ``index_add_`` of the gathered rows (on the card its atomics add in
    no fixed order) → ``(n_out, K)``."""
    out = torch.zeros((n_out, table.shape[1]), dtype=w.dtype, device=w.device)
    return out.index_add_(0, seg.long(), w[:, None] * table[idx.long()])


def sampled_row_sum_union_plain(seg, idx, layout, w, table, n_out):
    """K5's union route's read in torch ops, on any device: the entries
    ``(seg, idx, w)`` in segment order, each table row taken through its
    block's union, ``layout.union[block][layout.local]`` (through ``idx`` in
    a block the layout flags, as the gather route reads them), summed as
    :func:`sampled_row_sum_plain` sums → ``(n_out, K)``."""
    blk = torch.div(seg.long(), layout.block, rounding_mode="floor")
    rows = torch.where(layout.flag[blk], idx.long(), layout.union[blk, layout.local.long()].long())
    out = torch.zeros((n_out, table.shape[1]), dtype=w.dtype, device=w.device)
    return out.index_add_(0, seg.long(), w[:, None] * table[rows])


def _row_sum_forward(pattern, axis, w, table):
    n_out = pattern.sizes[axis]
    if w.device.type == "cpu" or w.dtype not in _KERNEL_DTYPES:
        return sampled_row_sum_plain(pattern.ends[axis], pattern.ends[1 - axis], w, table, n_out)
    _cuda.require_cuda(w.device, "sampled row sum")
    ptr, order, pieces, idx = pattern.plan(axis)
    w = (w if order is None else w[order]).contiguous()
    k = table.shape[1]
    rows = table if _cuda.sddmm_k_major(table) else table.contiguous()
    route = _cuda.row_sum_route(rows.shape[0], k, w.element_size(), pattern.kept, w.shape[0], n_out)
    out = torch.empty((n_out, k), dtype=w.dtype, device=w.device)
    n_front = _cuda.front_bound(w.shape[0], n_out, _cuda.MTTKRP_PIECE)
    partial = torch.empty(n_front * k, dtype=w.dtype, device=w.device)
    if route == "union":
        return row_sum_union_route(ptr, idx, pattern.union(axis, w.element_size()), w, rows, out, partial)
    slice_cols = _cuda.ROW_SUM_SLICE_COLS if route == "sliced" else None
    tickets = _cuda.zeroed_tickets(w.device, n_front * _cuda.row_sum_chunks(k, w.dtype, slice_cols))
    return _cuda.sampled_row_sum(ptr, pieces, idx, w, rows, out, partial, tickets, slice_cols=slice_cols)


def row_sum_union_route(ptr, idx, layout, w, table, out, partial):
    """K5's union route on the card: the union kernel on the blocks
    ``layout`` keeps (counted ``sampled_row_sum_union``) and, beside it on a
    second stream that the current one waits for, the gather route on the
    blocks it flags (``sampled_row_sum``), whose split segments' chains of
    pieces would otherwise follow the union kernel's. The union kernel is
    launched first, so its CTAs take their SMs before the gather's fill
    them, and with at least a CTA an SM, so the gather finds every SM alike
    where most blocks are flagged. ``partial`` as for the gather route;
    every row of ``out`` written."""
    main = torch.cuda.current_stream(w.device)
    side = _cuda.side_stream(w.device)
    side.wait_stream(main)  # the inputs, as they stand before the union kernel
    _cuda.sampled_row_sum_union(ptr, layout, w, table, out)
    with torch.cuda.stream(side):
        n_front = _cuda.front_bound(w.shape[0], out.shape[0], _cuda.MTTKRP_PIECE)
        tickets = _cuda.zeroed_tickets(w.device, n_front * _cuda.row_sum_chunks(out.shape[1], w.dtype))
        _cuda.sampled_row_sum(ptr, layout.pieces, idx, w, table, out, partial, tickets, flag=layout.flag, block=layout.block)
    main.wait_stream(side)
    return out


class _SampledRowSum(torch.autograd.Function):
    """K5 (``csrc/mttkrp.cu``, on the route of ``_cuda.row_sum_route``;
    plain on the CPU): ``out[i] = Σ_e w[e] · table[idx[e]]`` over the
    entries of segment ``i`` of ``pattern`` along ``axis``, summed in the
    pattern's order, so the same bits every call and on every route. Its
    derivatives: in ``w`` an SDDMM (K4) of the output's gradient with
    ``table`` on the same entries, in ``table`` K5 over the other axis;
    twice differentiable through both."""

    @staticmethod
    def forward(ctx, pattern, axis, w, table):
        ctx.save_for_backward(w, table)
        ctx.meta = (pattern, axis)
        return _row_sum_forward(pattern, axis, w, table)

    @staticmethod
    def backward(ctx, g):
        w, table = ctx.saved_tensors
        pattern, axis = ctx.meta
        d_w = d_table = None
        if ctx.needs_input_grad[2]:
            along = pattern if axis == 0 else pattern.T
            d_w = _Sddmm.apply(*along.ends, torch.ones_like(w), g, table.T, along)
        if ctx.needs_input_grad[3]:
            d_table = _SampledRowSum.apply(pattern, 1 - axis, w, g)
        return None, None, d_w, d_table


def _sddmm_operand(t, nnz):
    """The 2-D ``t`` (``lhs`` or ``rhs.T``) as K4 reads it for ``nnz``
    entries: itself, or one K-major copy where the copy moves fewer bytes
    than strided reads would (:func:`_cuda.sddmm_reads_in_place`)."""
    return t if _cuda.sddmm_reads_in_place(tuple(t.shape), t.stride(), t.element_size(), nnz) else t.contiguous()


def _sddmm_forward(rows, cols, sample_data, lhs, rhs):
    if sample_data.device.type == "cpu":
        return sddmm_plain(rows, cols, sample_data, lhs, rhs)
    _cuda.require_cuda(sample_data.device, "SDDMM")
    nnz = rows.shape[0]
    lhs_rows, rhs_rows = _sddmm_operand(lhs, nnz), _sddmm_operand(rhs.T, nnz)
    idx = torch.int64 if torch.int64 in (rows.dtype, cols.dtype) else torch.int32
    out = torch.empty(nnz, dtype=sample_data.dtype, device=sample_data.device)
    return _cuda.sddmm(
        rows.to(idx).contiguous(), cols.to(idx).contiguous(), sample_data.contiguous(), lhs_rows, rhs_rows, out
    )


class _Sddmm(torch.autograd.Function):
    """K4 forward (plain on the CPU); its backward is the VJP that JAX
    derives, with no (nnz, K) block and no atomics: ``d s = sddmm(rows,
    cols, g, lhs, rhs)`` through this same Function, ``d lhs[i] = Σ_{e in
    row i} (g·s)[e] · rhs.T[cols[e]]`` and ``d rhs.T[j] = Σ_{e in column j}
    (g·s)[e] · lhs[rows[e]]`` by K5 over ``pattern``'s two orders. Both
    Functions are differentiable, so it is too (second order). Forward
    mode: the sum of the three SDDMMs with one tangent each."""

    @staticmethod
    def forward(ctx, rows, cols, sample_data, lhs, rhs, pattern):
        ctx.save_for_backward(rows, cols, sample_data, lhs, rhs)
        ctx.save_for_forward(rows, cols, sample_data, lhs, rhs)
        ctx.pattern = pattern
        return _sddmm_forward(rows, cols, sample_data, lhs, rhs)

    @staticmethod
    def jvp(ctx, _rows, _cols, d_s, d_lhs, d_rhs, _pattern):
        rows, cols, sample_data, lhs, rhs = ctx.saved_tensors
        out = torch.zeros(rows.shape[0], dtype=sample_data.dtype, device=sample_data.device)
        for s_, l_, r_ in ((d_s, lhs, rhs), (sample_data, d_lhs, rhs), (sample_data, lhs, d_rhs)):
            if s_ is not None and l_ is not None and r_ is not None:
                out = out + _sddmm_forward(rows, cols, s_, l_, r_)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, cols, sample_data, lhs, rhs = ctx.saved_tensors
        pattern = ctx.pattern
        d_s = d_lhs = d_rhs = None
        if ctx.needs_input_grad[2]:
            d_s = _Sddmm.apply(rows, cols, g, lhs, rhs, pattern)
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            gs = g * sample_data
            if ctx.needs_input_grad[3]:
                d_lhs = _SampledRowSum.apply(pattern, 0, gs, rhs.T)
            if ctx.needs_input_grad[4]:
                d_rhs = _SampledRowSum.apply(pattern, 1, gs, lhs).T
        return None, None, d_s, d_lhs, d_rhs, None


def sddmm(rows, cols, sample_data, lhs, rhs):
    """Sampled dense-dense matmul: ``sample_data[e] · (lhs[rows[e], :] @
    rhs[:, cols[e]])`` for every stored entry → ``(nnz,)``; ``lhs`` ``(M,
    K)``, ``rhs`` ``(K, N)``, all on one device, in their promoted dtype.
    Differentiable in ``sample_data``, ``lhs`` and ``rhs``, to second order.

    float32/float64 on the GPU launch K4 (``csrc/sddmm.cu``; ``lhs`` and
    ``rhs.T`` read in place, or copied once where a copy moves fewer bytes
    than strided reads, :func:`_cuda.sddmm_reads_in_place`) or raise, and so
    does the gradient (K5, ``csrc/mttkrp.cu``); on the CPU, and for other
    dtypes on any device, the plain versions run. Indices are not checked;
    nnz = 0 returns an empty output without a launch."""
    return _sddmm(rows, cols, sample_data, lhs, rhs)


def _sddmm(rows, cols, sample_data, lhs, rhs, pattern=None):
    """:func:`sddmm`, its gradient summed along ``pattern`` (an
    :class:`SddmmPattern` of these ``rows`` and ``cols``, widened, for ``lhs``
    and ``rhs``'s sizes; by default a new one that knows nothing of their
    order)."""
    for name, t in (("rows", rows), ("cols", cols), ("sample_data", sample_data), ("lhs", lhs), ("rhs", rhs)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sddmm: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != sample_data.device:
            raise ValueError(f"sddmm: {name} is on {t.device} but sample_data is on {sample_data.device}")
    nnz = rows.shape[0]
    if lhs.ndim != 2 or rhs.ndim != 2 or lhs.shape[1] != rhs.shape[0]:
        raise ValueError(f"sddmm: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} must be (M, K) and (K, N)")
    if rows.ndim != 1 or cols.shape != (nnz,) or sample_data.shape != (nnz,):
        raise ValueError("sddmm: rows, cols and sample_data must be 1-D of one length")
    dt = result_dtype(sample_data.dtype, lhs.dtype, rhs.dtype)
    sample_data, lhs, rhs = sample_data.to(dt), lhs.to(dt), rhs.to(dt)
    rows, cols = wide_index(rows), wide_index(cols)
    if dt in _KERNEL_DTYPES:
        if pattern is None:
            pattern = SddmmPattern(rows, cols, lhs.shape[0], rhs.shape[1])
        return _Sddmm.apply(rows, cols, sample_data, lhs, rhs, pattern)
    return sddmm_plain(rows, cols, sample_data, lhs, rhs)
