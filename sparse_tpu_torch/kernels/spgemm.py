"""Sparse × sparse products (SpGEMM) of canonical COO operands on the
operands' device: the counterparts of ``sparse_tpu``'s eager
``ops/dot.py:_spgemm`` (NumPy and host C++) and its traceable
``kernels/spgemm.py:esc_spgemm`` (XLA).

The eager product's entry point is :func:`spgemm_coords`. On a CUDA device,
for float32 and float64, it launches the hand-written kernel S1
(``csrc/spgemm.cu``, two passes: a row-wise Gustavson product over a column
bitmap in shared memory, see there) on the operands' CSR row pointers, with
rows taken largest product count first (:func:`row_plan`), and writes the
product's coordinates straight in their final index dtype. Its plain
version, the torch ops of :func:`spgemm` below, runs for CPU tensors and,
on every device, for the other dtypes (chosen by dtype before any launch,
:func:`on_kernel`). Both have the same bits. The torch ops, and the
traceable form, are expand, sort and contract:

- **Expand.** B is canonical, so its row pointer is one ``searchsorted`` of
  its rows. Each A entry ``(i, k)`` owns ``counts_b[k]`` products, one for
  each entry of B's row ``k`` in column order; the products come out in A's
  canonical order (row ``i``, then ``k`` ascending).
- **Sort.** One stable ``torch.sort`` of the int64 key ``i * n + j``: the
  products of one output entry stay in product order, ``k`` ascending.
- **Contract.** Each run of equal keys is summed in a fixed order, with no
  atomics, so the sums have the same bits on every call on every device.

The eager form (:func:`spgemm`) reads the number of products back to the
host once and sizes everything exactly. It sums each run from its first
product, adding the later ones in order (``k`` ascending), the order of
``sparse_tpu``'s Gustavson loop (``sums[c] = av * bv``, then ``+=``): one
step a run position, each step adding the t-th product of every run longer
than t. It drops every sum equal to zero (computed zeros, either sign), as
``sparse_tpu``'s native route does. float16 and bfloat16 runs sum in float32
and round once; booleans sum as "or".

The traceable form (:func:`esc_spgemm`) takes static capacities and reads
nothing back, so it can be captured in a CUDA graph. It sums each run by a
backward segmented scan (the JAX package's order), keeps computed zeros and
returns its count of entries as a 0-d tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._utils import result_dtype, select, signed_view, take, wide_index
from . import _cuda

__all__ = [
    "S1Operands",
    "esc_spgemm",
    "on_kernel",
    "product_count",
    "row_plan",
    "row_products",
    "s1_numeric",
    "s1_operands",
    "s1_symbolic",
    "spgemm",
    "spgemm_coords",
]

# runs are summed in this dtype, then rounded once
_ACC = {torch.float16: torch.float32, torch.bfloat16: torch.float32}
_SENTINEL_ROW = int(np.iinfo(np.int32).max)


def product_count(cols_a, rows_b, k):
    """The exact number of expanded partial products of ``A @ B``: the sum
    over A's entries of the number of B entries in the row that A's column
    names (``cols_a`` A's column ids, ``rows_b`` B's row ids, ``k`` the
    contraction extent). Tensors (on any device) or arrays; a Python int."""
    if isinstance(cols_a, torch.Tensor) and isinstance(rows_b, torch.Tensor):
        counts_b = torch.bincount(wide_index(rows_b).long(), minlength=k)
        return int(counts_b[wide_index(cols_a).long()].sum())
    counts_b = np.bincount(np.asarray(rows_b), minlength=k)
    return int(counts_b[np.asarray(cols_a)].sum())


def _expansion(ca, rb, k):
    """Per A entry: its number of products (``repeats``, the population of
    B's row ``k``) and ``shift``, with which product ``p`` of entry ``e``
    reads B's entry ``shift[e] + p``."""
    b_ptr = torch.searchsorted(rb, torch.arange(k + 1, device=rb.device))
    counts = b_ptr[1:] - b_ptr[:-1]
    repeats = counts[ca]
    shift = b_ptr[ca] - (torch.cumsum(repeats, 0) - repeats)
    return repeats, shift


def _mul(x, y):
    """``x * y`` (bools: "and"), wide unsigned types through signed views."""
    if x.dtype == torch.bool:
        return x & y
    return (signed_view(x) * signed_view(y)).view(x.dtype)


def _plus(x, y):
    """``x + y`` (bools: "or"), wide unsigned types through signed views."""
    if x.dtype == torch.bool:
        return x | y
    return (signed_view(x) + signed_view(y)).view(x.dtype)


def _run_sums(vals, starts, counts):
    """Each run's sum: its first value, then its later values added in order
    (one step a run position; only runs of two or more take part), with no
    atomics. float16/bfloat16 in float32, rounded once."""
    sums = take(vals, starts)
    multi = torch.nonzero(counts > 1).flatten()
    if not multi.numel():
        return sums
    # runs longer than t are a prefix once the runs are sorted by length
    lengths, order = torch.sort(counts[multi], descending=True, stable=True)
    runs, pos = multi[order], starts[multi][order]
    at_least = torch.bincount(lengths).flip(0).cumsum(0).flip(0).tolist()  # at_least[c]: runs of c or more
    acc_dt = _ACC.get(vals.dtype, vals.dtype)
    acc = take(vals, pos).to(acc_dt)
    for t in range(1, len(at_least) - 1):
        n_t = at_least[t + 1]  # the runs longer than t
        acc[:n_t] = _plus(acc[:n_t], take(vals, pos[:n_t] + t).to(acc_dt))
    signed_view(sums)[runs] = signed_view(acc.to(vals.dtype))
    return sums


def spgemm(rows_a, cols_a, data_a, rows_b, cols_b, data_b, *, m, k, n):
    """``A (m, k) @ B (k, n)`` of two canonical COO operands given as their
    row ids, column ids and values (tensors on one device; any index dtype),
    eagerly: ``(rows, cols, vals)`` of the canonical product, int64 ids and
    values in the promoted dtype, every sum equal to zero dropped. Reads the
    number of products, the number of output entries and the run lengths
    back to the host."""
    device = data_a.device
    dt = result_dtype(data_a.dtype, data_b.dtype)
    empty = (torch.empty(0, dtype=torch.int64, device=device),) * 2 + (torch.empty(0, dtype=dt, device=device),)
    if not data_a.numel() or not data_b.numel():
        return empty
    ra, ca = wide_index(rows_a).long(), wide_index(cols_a).long()
    rb, cb = wide_index(rows_b).long(), wide_index(cols_b).long()
    repeats, shift = _expansion(ca, rb, k)
    total = int(repeats.sum())  # the one read of the expansion
    if total == 0:
        return empty
    owner = torch.repeat_interleave(torch.arange(ca.numel(), device=device), repeats, output_size=total)
    b_idx = torch.arange(total, device=device).add_(shift[owner])
    key = ra[owner].mul_(n).add_(cb[b_idx])
    vals = _mul(take(data_a.to(dt), owner), take(data_b.to(dt), b_idx))
    del owner, b_idx
    key, perm = torch.sort(key, stable=True)
    vals = take(vals, perm)
    del perm
    key, counts = torch.unique_consecutive(key, return_counts=True)
    if key.numel() != total:
        starts = torch.cumsum(counts, 0).sub_(counts)
        vals = _run_sums(vals, starts, counts)
    keep = signed_view(vals) != 0
    if not bool(keep.all()):
        key, vals = key[keep], take(vals, keep)
    return key // n, key % n, vals


def on_kernel(device, dt):
    """Whether an eager product computed in ``dt`` on ``device`` launches
    S1: float32/float64 on a CUDA device. Decided before any launch; the
    other dtypes take :func:`spgemm`'s torch ops on every device."""
    return device.type == "cuda" and dt in (torch.float32, torch.float64)


def row_products(ptr_a, cols_a, ptr_b):
    """The partial products of each row of ``A @ B`` (int64, one a row of
    ``A``): over the row's entries, the population of the row of ``B``
    that the entry's column names. ``ptr_a``/``ptr_b`` the operands' int64
    row pointers, ``cols_a`` A's column ids."""
    counts_b = ptr_b[1:] - ptr_b[:-1]
    ends = torch.zeros(cols_a.numel() + 1, dtype=torch.int64, device=ptr_a.device)
    torch.cumsum(counts_b[cols_a.long()], 0, out=ends[1:])
    return ends[ptr_a[1:]] - ends[ptr_a[:-1]]


def row_plan(products):
    """S1's order of the rows: ``(order, counts)``, the rows' indices by
    product count, largest first (stable among equal counts), and their
    counts in that order. The rows with no products come last; the kernels'
    CTAs take rows from the front and stop at the first of them."""
    counts, order = torch.sort(products, descending=True, stable=True)
    return order, counts


class S1Operands(NamedTuple):
    """S1's inputs for one product: both operands as CSR (int64 row
    pointers, column ids in one dtype, values in the product's dtype), the
    rows of ``A`` in :func:`row_plan`'s order with their product counts,
    and the product's ``m`` rows and ``n`` columns."""

    ptr_a: torch.Tensor
    cols_a: torch.Tensor
    vals_a: torch.Tensor
    ptr_b: torch.Tensor
    cols_b: torch.Tensor
    vals_b: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor
    m: int
    n: int


def s1_operands(rows_a, cols_a, data_a, rows_b, cols_b, data_b, *, m, k, n, dt):
    """The :class:`S1Operands` of ``A (m, k) @ B (k, n)``, two canonical COO
    operands on one CUDA device, computed in ``dt``."""
    device = data_a.device
    ptr_a = torch.searchsorted(wide_index(rows_a), torch.arange(m + 1, device=device))
    ptr_b = torch.searchsorted(wide_index(rows_b), torch.arange(k + 1, device=device))
    it = torch.int32 if max(k, n) <= np.iinfo(np.int32).max else torch.int64
    ca, cb = (wide_index(c).to(it).contiguous() for c in (cols_a, cols_b))
    va, vb = (d.to(dt).contiguous() for d in (data_a, data_b))
    order, counts = row_plan(row_products(ptr_a, ca, ptr_b))
    return S1Operands(ptr_a, ca, va, ptr_b, cb, vb, order, counts, m, n)


def s1_symbolic(ops):
    """S1's symbolic pass on ``ops``: the product's row pointer (int64,
    ``m + 1``), the cumulative sum of its rows' distinct columns."""
    device = ops.ptr_a.device
    counter = torch.zeros(1, dtype=torch.int64, device=device)
    row_count = torch.zeros(ops.m, dtype=torch.int64, device=device)
    _cuda.spgemm_symbolic(ops.ptr_a, ops.cols_a, ops.ptr_b, ops.cols_b, ops.order, ops.counts, ops.n, counter, row_count)
    row_ptr = torch.zeros(ops.m + 1, dtype=torch.int64, device=device)
    torch.cumsum(row_count, 0, out=row_ptr[1:])
    return row_ptr


def s1_numeric(ops, row_ptr, nnz, index_dtype):
    """S1's numeric pass on ``ops`` into ``nnz`` (``row_ptr[-1]``) entries:
    ``(coords, vals, zeros)``, the (2, nnz) coordinates in ``index_dtype``,
    the sums, those equal to zero kept, and their count (a one-element
    int64 tensor)."""
    device = ops.ptr_a.device
    scratch = torch.zeros(2, dtype=torch.int64, device=device)  # the row counter, the count of zero sums
    coords = torch.empty((2, nnz), dtype=index_dtype, device=device)
    vals = torch.empty(nnz, dtype=ops.vals_a.dtype, device=device)
    if nnz:
        _cuda.spgemm_numeric(
            ops.ptr_a, ops.cols_a, ops.vals_a, ops.ptr_b, ops.cols_b, ops.vals_b, ops.order, ops.counts, ops.n,
            row_ptr, coords, vals, scratch[0:1], scratch[1:2]
        )
    return coords, vals, scratch[1:2]


def spgemm_coords(rows_a, cols_a, data_a, rows_b, cols_b, data_b, *, m, k, n, index_dtype):
    """``A (m, k) @ B (k, n)`` of two canonical COO operands, eagerly:
    ``(coords, vals)``, the canonical product's (2, nnz) coordinates in
    ``index_dtype`` (int32 or int64) and its values in the promoted dtype,
    every sum equal to zero dropped. S1 where :func:`on_kernel` (reads back
    the output's size and its count of zero sums), else :func:`spgemm`'s
    torch ops; the same bits either way."""
    dt = result_dtype(data_a.dtype, data_b.dtype)
    if not on_kernel(data_a.device, dt):
        rows, cols, vals = spgemm(rows_a, cols_a, data_a, rows_b, cols_b, data_b, m=m, k=k, n=n)
        return torch.stack([rows, cols]).to(index_dtype), vals
    device = data_a.device
    if not data_a.numel() or not data_b.numel():
        return torch.empty((2, 0), dtype=index_dtype, device=device), torch.empty(0, dtype=dt, device=device)
    ops = s1_operands(rows_a, cols_a, data_a, rows_b, cols_b, data_b, m=m, k=k, n=n, dt=dt)
    row_ptr = s1_symbolic(ops)
    nnz = int(row_ptr[-1])  # the one read of the symbolic pass
    coords, vals, zeros = s1_numeric(ops, row_ptr, nnz, index_dtype)
    if nnz and int(zeros):  # sums equal to zero, dropped
        keep = vals != 0
        coords, vals = coords[:, keep], vals[keep]
    return coords, vals


def esc_spgemm(rows_a, cols_a, data_a, rows_b, cols_b, data_b, *, k, n, product_capacity, out_capacity):
    """``A (m, k) @ B (k, n)`` of two canonical COO operands with static
    sizes and no read back to the host (it can be captured in a CUDA graph).

    ``product_capacity`` must bound the number of partial products
    (:func:`product_count`). Returns ``(out_rows, out_cols, out_data,
    out_nnz)``: tensors of length ``out_capacity`` whose first ``out_nnz``
    entries are the product's, in canonical order, and whose rest is padding
    (row int32 max, column 0, value 0), with ``out_nnz`` a 0-d int64 tensor.
    Computed zeros are kept. Rows and columns are int32, values the promoted
    dtype. Each run is summed by a backward segmented scan, as the JAX
    package sums it: a fixed order with no atomics."""
    device = data_a.device
    dt = result_dtype(data_a.dtype, data_b.dtype)
    nnz_a, nnz_b = data_a.shape[0], data_b.shape[0]
    pcap, ocap = int(product_capacity), int(out_capacity)
    if nnz_a == 0 or nnz_b == 0 or pcap == 0:
        return (
            torch.full((ocap,), _SENTINEL_ROW, dtype=torch.int32, device=device),
            torch.zeros(ocap, dtype=torch.int32, device=device),
            torch.zeros(ocap, dtype=dt, device=device),
            torch.zeros((), dtype=torch.int64, device=device),
        )
    ra, ca = wide_index(rows_a).long(), wide_index(cols_a).long()
    rb, cb = wide_index(rows_b).long(), wide_index(cols_b).long()
    repeats, shift = _expansion(ca, rb, k)
    ends = torch.cumsum(repeats, 0)
    p = torch.arange(pcap, device=device)
    # the A entry of product p: the number of ends at or below p
    owner = torch.searchsorted(ends, p, right=True).clamp_(max=nnz_a - 1)
    valid = p < ends[-1]
    b_idx = (shift[owner] + p).clamp_(0, nnz_b - 1)
    i = torch.where(valid, ra[owner], _SENTINEL_ROW)
    j = torch.where(valid, cb[b_idx], 0)
    prod = _mul(take(data_a.to(dt), owner), take(data_b.to(dt), b_idx))
    v = select(valid, prod, torch.zeros_like(prod))
    key, perm = torch.sort(i * n + j, stable=True)
    v = take(v, perm)

    is_new = torch.ones(pcap, dtype=torch.bool, device=device)
    is_new[1:] = key[1:] != key[:-1]
    is_new &= key < _SENTINEL_ROW * n
    seg = torch.cumsum(is_new, 0)
    out_nnz = seg[-1]
    # backward Hillis-Steele scan within segments: each run's total lands at
    # its head (padding folds into the last run with value zero)
    x = v
    d = 1
    while d < pcap:
        shifted = torch.zeros_like(x)
        signed_view(shifted)[:-d] = signed_view(select(seg[d:] == seg[:-d], x[d:], shifted[d:]))
        x = _plus(x, shifted)
        d *= 2
    # compact the heads into their slots (slot ocap takes every other product)
    slot = torch.where(is_new, seg - 1, ocap).clamp_(max=ocap)
    keys_out = torch.full((ocap + 1,), -1, dtype=torch.int64, device=device)
    keys_out[slot] = key
    sums = torch.zeros(ocap + 1, dtype=dt, device=device)
    signed_view(sums)[slot] = signed_view(x)
    in_range = torch.arange(ocap, device=device) < out_nnz
    keys_out = keys_out[:ocap]
    out_rows = torch.where(in_range, keys_out // n, _SENTINEL_ROW).to(torch.int32)
    out_cols = torch.where(in_range, keys_out % n, 0).to(torch.int32)
    out_data = select(in_range, sums[:ocap], torch.zeros_like(sums[:ocap]))
    return out_rows, out_cols, out_data, out_nnz
