"""Bindings of ``csrc/eager.cpp``: the host library's joins, reductions,
sparse × dense products, SpGEMM and restructuring kernels, the
counterparts of ``sparse_tpu.native.eager``'s functions on CPU tensors.

Every function takes CPU tensors (NumPy arrays as host tensors; another
device raises ``ValueError``), returns CPU tensors, counts its calls in
``native.CALLS`` under its own name and raises where the library does not
take its input (``TypeError`` for a value dtype other than float32/float64
where the C code has no other). The callers in ``core`` and ``ops`` decide
the route before calling: ``NATIVE_MIN_NNZ`` combined entries for the joins
and SpGEMM, ``NATIVE_MIN_PRODUCT_NNZ`` for the sparse × dense products (0:
``sparse_tpu``'s host products have no size floor).
"""

from __future__ import annotations

import torch

from . import CALLS, call, check_values, host, host_i64, ptr

# below this combined nnz the torch ops win on call overhead
NATIVE_MIN_NNZ = 4096
# sparse × dense products take the library at any size, as sparse_tpu's do
NATIVE_MIN_PRODUCT_NNZ = 0

_I32_MAX = 2**31 - 1


def _pair_dtype(*ts):
    """``("i32", ts)`` when every index tensor is int32, else ``("i64", ts as int64)``."""
    if all(t.dtype == torch.int32 for t in ts):
        return "i32", ts
    return "i64", tuple(t.to(torch.int64) for t in ts)


def _index_pair(indptr, idx):
    """``(indptr, idx, suffix)`` in one index dtype: int32 when ``idx`` is
    int32 and ``indptr`` fits it, else int64."""
    indptr, idx = host(indptr, "indptr"), host(idx, "indices")
    if idx.dtype == torch.int32 and (indptr.numel() == 0 or int(indptr[-1]) <= _I32_MAX):
        return indptr.to(torch.int32), idx, "i32"
    return indptr.to(torch.int64), idx.to(torch.int64), "i64"


def union_join(ka, kb):
    """Union of two sorted unique int64 key streams: ``(keys, ia, ib)``, the
    position of each union key in ``ka``/``kb`` or -1."""
    ka, kb = host_i64(ka, "ka"), host_i64(kb, "kb")
    na, nb = ka.shape[0], kb.shape[0]
    k_out, ia, ib = (torch.empty(na + nb, dtype=torch.int64) for _ in range(3))
    CALLS["union_join"] += 1
    u = call("stt_union_join_i64", ptr(ka), na, ptr(kb), nb, ptr(k_out), ptr(ia), ptr(ib))
    return k_out[:u], ia[:u], ib[:u]


def union_join_values(ka, va, fa, kb, vb, fb):
    """Union of two sorted unique key streams with both value streams at the
    union (the stored value or the operand's fill ``fa``/``fb``), one pass:
    ``(keys, va_out, vb_out)``. ``va`` and ``vb`` share a float dtype."""
    ka, kb = host_i64(ka, "ka"), host_i64(kb, "kb")
    va, vb = host(va, "va"), host(vb, "vb")
    ts = check_values(va, "va")
    if vb.dtype != va.dtype:
        raise TypeError(f"union_join_values: va is {va.dtype} but vb is {vb.dtype}")
    na, nb = ka.shape[0], kb.shape[0]
    k_out = torch.empty(na + nb, dtype=torch.int64)
    va_out, vb_out = torch.empty(na + nb, dtype=va.dtype), torch.empty(na + nb, dtype=va.dtype)
    CALLS["union_join_values"] += 1
    u = call(
        f"stt_union_join_vals_{ts}",
        ptr(ka), ptr(va), na, float(fa), ptr(kb), ptr(vb), nb, float(fb), ptr(k_out), ptr(va_out), ptr(vb_out),
    )
    return k_out[:u], va_out[:u], vb_out[:u]


_FUSED = {"add": "add", "subtract": "sub", "multiply": "mul"}


def _fused_op(op_name):
    if op_name not in _FUSED:
        raise ValueError(f"fused joins take add, subtract or multiply, not {op_name!r}")
    return _FUSED[op_name]


def fused_join_2d(op_name, ra, ca, va, rb, cb, vb, k_cols):
    """2-D fused {add, subtract, multiply} of two canonical zero-fill
    operands, merged on their ``(row, col)`` pairs: ``(rows, cols, values)``
    with every result bitwise +0.0 (integers: 0) dropped. Values float64,
    float32 or int64, one dtype; indices int32 when all four are, else int64."""
    op = _fused_op(op_name)
    va, vb = host(va, "va"), host(vb, "vb")
    if va.dtype != vb.dtype or va.dtype not in (torch.float64, torch.float32, torch.int64):
        raise TypeError(f"fused_join_2d takes one float64, float32 or int64 value dtype, not {va.dtype}/{vb.dtype}")
    isuf, (ra, ca, rb, cb) = _pair_dtype(*(host(t, "coordinates") for t in (ra, ca, rb, cb)))
    tsuf = "s64" if va.dtype == torch.int64 else check_values(va)
    na, nb = ra.shape[0], rb.shape[0]
    r_out, c_out = torch.empty(na + nb, dtype=ra.dtype), torch.empty(na + nb, dtype=ra.dtype)
    v_out = torch.empty(na + nb, dtype=va.dtype)
    CALLS["fused_join_2d"] += 1
    u = call(
        f"stt_{op}_join2d_{tsuf}_{isuf}",
        ptr(ra), ptr(ca), ptr(va), na, ptr(rb), ptr(cb), ptr(vb), nb, int(k_cols), ptr(r_out), ptr(c_out), ptr(v_out),
    )
    return r_out[:u], c_out[:u], v_out[:u]


def fused_join(op_name, ka, va, kb, vb):
    """Fused sorted-union {add, subtract, multiply} on linear keys, zero
    fills, exact IEEE results, bitwise +0.0 dropped: ``(keys, values)``."""
    op = _fused_op(op_name)
    ka, kb = host_i64(ka, "ka"), host_i64(kb, "kb")
    va, vb = host(va, "va"), host(vb, "vb")
    ts = check_values(va, "va")
    if vb.dtype != va.dtype:
        raise TypeError(f"fused_join: va is {va.dtype} but vb is {vb.dtype}")
    na, nb = ka.shape[0], kb.shape[0]
    k_out, v_out = torch.empty(na + nb, dtype=torch.int64), torch.empty(na + nb, dtype=va.dtype)
    CALLS["fused_join"] += 1
    u = call(f"stt_{op}_join_{ts}", ptr(ka), ptr(va), na, ptr(kb), ptr(vb), nb, ptr(k_out), ptr(v_out))
    return k_out[:u].clone(), v_out[:u].clone()


def canonicalize2d(rows, cols, vals, n_rows):
    """A 2-D COO triplet sorted row-major with duplicates summed (a counting
    sort by row, a stable sort a row, each run summed from its first value in
    entry order): ``(rows, cols, vals)``, int32 indices when both inputs are,
    else int64."""
    vals = host(vals, "vals")
    ts = check_values(vals)
    isuf, (rows, cols) = _pair_dtype(host(rows, "rows"), host(cols, "cols"))
    n = rows.shape[0]
    rows_out, cols_out = torch.empty(n, dtype=rows.dtype), torch.empty(n, dtype=rows.dtype)
    vals_out = torch.empty(n, dtype=vals.dtype)
    CALLS["canonicalize2d"] += 1
    u = call(
        f"stt_canonicalize2d_{ts}_{isuf}",
        ptr(rows), ptr(cols), ptr(vals), n, int(n_rows), ptr(rows_out), ptr(cols_out), ptr(vals_out),
    )
    return rows_out[:u], cols_out[:u], vals_out[:u]


def bincount_sum(keys, weights, n_bins):
    """``(bincount(keys, weights), bincount(keys))`` in one pass, the sums
    in the weights' dtype."""
    keys, weights = host_i64(keys, "keys"), host(weights, "weights")
    ts = check_values(weights, "weights")
    sums, counts = torch.empty(n_bins, dtype=weights.dtype), torch.empty(n_bins, dtype=torch.int64)
    CALLS["bincount_sum"] += 1
    call(f"stt_bincount_sum_{ts}", ptr(keys), ptr(weights), keys.shape[0], n_bins, ptr(sums), ptr(counts))
    return sums, counts


def _keys_for_reduce(keys):
    keys = host(keys, "keys")
    if keys.dtype == torch.int32:
        return keys, "_i32"
    return keys.to(torch.int64), ""


def bincount_sum_compact(keys, weights, n_bins):
    """The weighted bincount's bins whose sum is nonzero: ``(idx, vals)``."""
    keys, ks = _keys_for_reduce(keys)
    weights = host(weights, "weights")
    ts = check_values(weights, "weights")
    sums = torch.empty(n_bins, dtype=weights.dtype)
    out_idx, out_vals = torch.empty(n_bins, dtype=torch.int64), torch.empty(n_bins, dtype=weights.dtype)
    CALLS["bincount_sum_compact"] += 1
    m = call(
        f"stt_bincount_sum_compact_{ts}{ks}",
        ptr(keys), ptr(weights), keys.shape[0], n_bins, ptr(sums), ptr(out_idx), ptr(out_vals),
    )
    return out_idx[:m], out_vals[:m]


def sorted_reduce_compact(keys, weights, max_runs=None):
    """Add-reduce over sorted keys, the runs whose sum is nonzero: ``(idx,
    vals)`` (each run summed by four accumulators). ``max_runs`` bounds the
    distinct keys."""
    keys, ks = _keys_for_reduce(keys)
    weights = host(weights, "weights")
    ts = check_values(weights, "weights")
    n = keys.shape[0]
    cap = n if max_runs is None else min(n, int(max_runs))
    out_idx, out_vals = torch.empty(cap, dtype=torch.int64), torch.empty(cap, dtype=weights.dtype)
    CALLS["sorted_reduce_compact"] += 1
    m = call(f"stt_sorted_reduce_compact_{ts}{ks}", ptr(keys), ptr(weights), n, ptr(out_idx), ptr(out_vals))
    return out_idx[:m], out_vals[:m]


def row_reduce_sorted(keys, weights):
    """One-pass grouped add-reduce over sorted keys: ``(keys, sums, counts)``."""
    keys, weights = host_i64(keys, "keys"), host(weights, "weights")
    ts = check_values(weights, "weights")
    n = keys.shape[0]
    keys_out, counts = torch.empty(n, dtype=torch.int64), torch.empty(n, dtype=torch.int64)
    sums = torch.empty(n, dtype=weights.dtype)
    CALLS["row_reduce_sorted"] += 1
    g = call(f"stt_row_reduce_sorted_{ts}", ptr(keys), ptr(weights), n, ptr(keys_out), ptr(sums), ptr(counts))
    return keys_out[:g], sums[:g], counts[:g]


def unravel(keys, shape):
    """Row-major unravel of int64 keys into an int64 ``(ndim, n)`` tensor."""
    keys = host_i64(keys, "keys")
    shape_t = torch.tensor([int(s) for s in shape], dtype=torch.int64)
    n, ndim = keys.shape[0], shape_t.shape[0]
    coords = torch.empty((ndim, n), dtype=torch.int64)
    CALLS["unravel"] += 1
    call("stt_unravel_i64", ptr(keys), n, ptr(shape_t), ndim, ptr(coords))
    return coords


def _dense_of(b, dtype, name="b"):
    return host(b, name).to(dtype).contiguous()


def csr_spmm_dense(indptr, cols, vals, b, n_rows):
    """CSR × dense → dense (threaded rows): ``b`` ``(K,)`` (four accumulators
    a row) or ``(K, N)`` (each output row summed from 0 in column order)."""
    pa, ja, isuf = _index_pair(indptr, cols)
    va = host(vals, "vals")
    ts = check_values(va)
    b = _dense_of(b, va.dtype)
    if b.ndim == 2 and b.shape[1] == 1:
        return csr_spmm_dense(pa, ja, va, b[:, 0], n_rows)[:, None]
    CALLS["csr_spmm_dense"] += 1
    if b.ndim == 1:
        out = torch.empty(n_rows, dtype=va.dtype)
        call(f"stt_csr_spmv_{ts}_{isuf}", ptr(pa), ptr(ja), ptr(va), n_rows, ptr(b), ptr(out))
        return out
    n = b.shape[1]
    out = torch.empty((n_rows, n), dtype=va.dtype)
    call(f"stt_csr_spmm_{ts}_{isuf}", ptr(pa), ptr(ja), ptr(va), n_rows, ptr(b), n, ptr(out))
    return out


def csc_spmm_dense(indptr, rows, vals, b, n_rows, n_cols):
    """CSC × dense → dense: one scatter pass over the columns (threaded over
    slices of ``b``'s columns for a matrix)."""
    pc, ia, isuf = _index_pair(indptr, rows)
    va = host(vals, "vals")
    ts = check_values(va)
    b = _dense_of(b, va.dtype)
    if b.ndim == 2 and b.shape[1] == 1:
        return csc_spmm_dense(pc, ia, va, b[:, 0], n_rows, n_cols)[:, None]
    CALLS["csc_spmm_dense"] += 1
    if b.ndim == 1:
        out = torch.zeros(n_rows, dtype=va.dtype)
        call(f"stt_csc_spmv_acc_{ts}_{isuf}", ptr(pc), ptr(ia), ptr(va), n_cols, ptr(b), ptr(out))
        return out
    n = b.shape[1]
    out = torch.empty((n_rows, n), dtype=va.dtype)
    call(f"stt_csc_spmm_{ts}_{isuf}", ptr(pc), ptr(ia), ptr(va), n_cols, n_rows, ptr(b), n, ptr(out))
    return out


def coo_spmv_entries(rows, cols, vals, x, n_rows, y=None):
    """Entry-loop matvec for the sparse-row regime (nnz ≪ rows): ``A @ x``
    (from zeros) or ``A @ x + y`` (seeded with ``y``), entries in order."""
    va = host(vals, "vals")
    ts = check_values(va)
    isuf, (ri, ci) = _pair_dtype(host(rows, "rows"), host(cols, "cols"))
    x = _dense_of(x, va.dtype, "x")
    CALLS["coo_spmv_entries"] += 1
    if y is not None:
        y = _dense_of(y, va.dtype, "y")
        out = torch.empty(n_rows, dtype=va.dtype)
        call(f"stt_coo_spmv_add_{ts}_{isuf}", ptr(ri), ptr(ci), ptr(va), va.shape[0], n_rows, ptr(x), ptr(y), ptr(out))
        return out
    out = torch.zeros(n_rows, dtype=va.dtype)
    call(f"stt_coo_spmv_acc_{ts}_{isuf}", ptr(ri), ptr(ci), ptr(va), va.shape[0], ptr(x), ptr(out))
    return out


def spmv_add(indptr, idx, vals, x, y, n_rows, n_cols, compressed_rows):
    """Fused ``A @ x + y`` (CSR when ``compressed_rows``, else CSC), the
    output seeded with ``y``."""
    pa, ja, isuf = _index_pair(indptr, idx)
    va = host(vals, "vals")
    ts = check_values(va)
    x, y = _dense_of(x, va.dtype, "x"), _dense_of(y, va.dtype, "y")
    if x.ndim != 1 or tuple(y.shape) != (n_rows,):
        raise ValueError(f"spmv_add: x {tuple(x.shape)} and y {tuple(y.shape)} must be 1-D, y of {n_rows}")
    out = torch.empty(n_rows, dtype=va.dtype)
    CALLS["spmv_add"] += 1
    if compressed_rows:
        call(f"stt_csr_spmv_add_{ts}_{isuf}", ptr(pa), ptr(ja), ptr(va), n_rows, ptr(x), ptr(y), ptr(out))
    else:
        call(f"stt_csc_spmv_add_{ts}_{isuf}", ptr(pa), ptr(ja), ptr(va), n_cols, n_rows, ptr(x), ptr(y), ptr(out))
    return out


def spgemm_csr(indptr_a, cols_a, vals_a, indptr_b, cols_b, vals_b, n_rows, n_cols):
    """CSR × CSR Gustavson SpGEMM (nnz-balanced threaded rows): ``(indptr,
    cols, vals)``, columns sorted within each row, each sum from the first
    product in ``k`` order, computed zeros kept."""
    pa, ja = host_i64(indptr_a, "indptr_a"), host_i64(cols_a, "cols_a")
    pb, jb = host_i64(indptr_b, "indptr_b"), host_i64(cols_b, "cols_b")
    va, vb = host(vals_a, "vals_a"), host(vals_b, "vals_b")
    ts = check_values(va, "vals_a")
    if vb.dtype != va.dtype:
        raise TypeError(f"spgemm_csr: vals_a is {va.dtype} but vals_b is {vb.dtype}")
    CALLS["spgemm_csr"] += 1
    # one phase when the product bound is near the operands' sizes: no
    # symbolic pass, compacted in the kernel
    pc_ub = torch.empty(n_rows + 1, dtype=torch.int64)
    call("stt_spgemm_ubcount", ptr(pa), ptr(ja), n_rows, ptr(pb), ptr(pc_ub))
    ub_total = int(pc_ub[-1])
    if ub_total <= max(3 * (va.shape[0] + vb.shape[0]), 1 << 20):
        pc = torch.empty(n_rows + 1, dtype=torch.int64)
        jc, vc = torch.empty(ub_total, dtype=torch.int64), torch.empty(ub_total, dtype=va.dtype)
        call(
            f"stt_spgemm_onephase_{ts}",
            ptr(pa), ptr(ja), ptr(va), n_rows, ptr(pb), ptr(jb), ptr(vb), n_cols, ptr(pc_ub), ptr(pc), ptr(jc), ptr(vc),
        )
        nnz_c = int(pc[-1])
        return pc, jc[:nnz_c], vc[:nnz_c]
    row_nnz = torch.empty(n_rows, dtype=torch.int64)
    call("stt_spgemm_symbolic", ptr(pa), ptr(ja), n_rows, ptr(pb), ptr(jb), n_cols, ptr(row_nnz))
    pc = torch.zeros(n_rows + 1, dtype=torch.int64)
    torch.cumsum(row_nnz, 0, out=pc[1:])
    nnz_c = int(pc[-1])
    jc, vc = torch.empty(nnz_c, dtype=torch.int64), torch.empty(nnz_c, dtype=va.dtype)
    call(
        f"stt_spgemm_numeric_{ts}",
        ptr(pa), ptr(ja), ptr(va), n_rows, ptr(pb), ptr(jb), ptr(vb), n_cols, ptr(pc), ptr(jc), ptr(vc),
    )
    return pc, jc, vc


def uncompress_indptr(indptr, n_rows):
    """int64 row ids of a compressed format (threaded over rows)."""
    pc = host_i64(indptr, "indptr")
    ic = torch.empty(int(pc[-1]), dtype=torch.int64)
    CALLS["uncompress_indptr"] += 1
    call("stt_uncompress_indptr", ptr(pc), n_rows, ptr(ic))
    return ic


def transpose2d(rows, cols, vals, n_cols, want_rows=True):
    """Stable counting-scatter transpose of a canonical 2-D COO triplet:
    ``(indptr, rows_t, cols_t, vals_t)``, ``indptr`` over the input's
    columns (with ``cols_t``/``vals_t`` also the input's CSC), ``rows_t``
    ``None`` unless ``want_rows``. float32/float64 values by the typed
    kernel, other dtypes of 1-16 bytes as their bytes."""
    vals = host(vals, "vals")
    isuf, (rows, cols) = _pair_dtype(host(rows, "rows"), host(cols, "cols"))
    n = rows.shape[0]
    indptr = torch.empty(n_cols + 1, dtype=torch.int64)
    rows_t = torch.empty(n, dtype=rows.dtype) if want_rows else None
    cols_t, vals_t = torch.empty(n, dtype=rows.dtype), torch.empty(n, dtype=vals.dtype)
    rows_p = ptr(rows_t) if want_rows else None
    CALLS["transpose2d"] += 1
    if vals.dtype in (torch.float64, torch.float32):
        call(
            f"stt_transpose2d_{check_values(vals)}_{isuf}",
            ptr(rows), ptr(cols), ptr(vals), n, n_cols, ptr(indptr), rows_p, ptr(cols_t), ptr(vals_t),
        )
    else:
        itemsize = vals.element_size()
        if itemsize not in (1, 2, 4, 8, 16):
            raise TypeError(f"transpose2d moves values of 1-16 bytes, not {vals.dtype}")
        call(
            f"stt_transpose2d_bytes_{isuf}",
            ptr(rows), ptr(cols), ptr(vals), n, n_cols, itemsize, ptr(indptr), rows_p, ptr(cols_t), ptr(vals_t),
        )
    return indptr, rows_t, cols_t, vals_t


def dense_spmm_csrt(indptr, kids, vals, x, n_out):
    """dense ``(M, K)`` × sparse ``(K, N)`` → dense ``(M, N)`` on the CSR of
    the sparse operand's transpose (``indptr`` over N, ``kids`` the K ids:
    its CSC), both dense transposes in the kernel; each output row of the
    transpose summed from 0 in entry order."""
    pn = host_i64(indptr, "indptr")
    kids = host(kids, "kids")
    if kids.dtype != torch.int32:
        kids = kids.to(torch.int64)
    isuf = "i32" if kids.dtype == torch.int32 else "i64"
    va = host(vals, "vals")
    ts = check_values(va)
    x = _dense_of(x, va.dtype, "x")
    m, k = x.shape
    out = torch.empty((m, n_out), dtype=va.dtype)
    CALLS["dense_spmm_csrt"] += 1
    call(f"stt_dense_spmm_csrt_{ts}_{isuf}", ptr(pn), ptr(kids), ptr(va), n_out, ptr(x), m, k, ptr(out))
    return out


def relinearize(indptr, indices, lin_terms, row_terms, col_terms):
    """Per stored entry of a compressed layout (row ``r`` expanded from
    ``indptr``, index ``j``): the target keys ``Σ ((src // div) % mod) ·
    mul`` of ``row_terms`` and ``col_terms`` (``src`` 0: ``r``, 1: ``j``, 2:
    the key of ``lin_terms``; ``mod`` 0: none). ``(new_row, new_col)`` int64."""
    pc = host_i64(indptr, "indptr")
    indices = host(indices, "indices")
    if indices.dtype != torch.int32:
        indices = indices.to(torch.int64)
    isuf = "i32" if indices.dtype == torch.int32 else "i64"
    n_rows, nnz = pc.shape[0] - 1, int(pc[-1])
    out_row, out_col = torch.empty(nnz, dtype=torch.int64), torch.empty(nnz, dtype=torch.int64)

    def pack(terms):
        """The C arguments of a term list and the tensors they point into
        (held until the call returns)."""
        cols = list(zip(*terms)) if terms else [(), (), (), ()]
        src = torch.tensor(cols[0], dtype=torch.int8)
        div, mod, mul = (torch.tensor(c, dtype=torch.int64) for c in cols[1:])
        return [len(terms), ptr(src), ptr(div), ptr(mod), ptr(mul)], (src, div, mod, mul)

    (la, _lk), (ra, _rk), (ca, _ck) = pack(lin_terms), pack(row_terms), pack(col_terms)
    CALLS["relinearize"] += 1
    call(f"stt_relinearize_{isuf}", ptr(pc), n_rows, *la, *ra, *ca, ptr(out_row), ptr(out_col), ptr(indices))
    return out_row, out_col


def csr_row_splice(indptr, indices, data, picks):
    """Rows ``picks`` of a CSR packed into a compact CSR, segment copies of
    any index and value width: ``(rel_indptr, indices, data)``."""
    pc = host_i64(indptr, "indptr")
    picks = host_i64(picks, "picks")
    indices, data = host(indices, "indices"), host(data, "data")
    total = int((pc[picks + 1] - pc[picks]).sum()) if picks.numel() else 0
    rel_indptr = torch.empty(picks.numel() + 1, dtype=torch.int64)
    ind_out, dat_out = torch.empty(total, dtype=indices.dtype), torch.empty(total, dtype=data.dtype)
    CALLS["csr_row_splice"] += 1
    call(
        "stt_csr_row_splice_bytes",
        ptr(pc), ptr(indices), indices.element_size(), ptr(data), data.element_size(),
        ptr(picks), picks.numel(), ptr(rel_indptr), ptr(ind_out), ptr(dat_out),
    )
    return rel_indptr, ind_out, dat_out
