"""The one-hot SpMV prototype of ``experiments/pallas_spmv_onehot.py`` on
the card.

The Pallas prototype (E1) computes the SpMV's per-entry products stream in
the row-ELL layout order with a one-hot MXU pick of ``x`` from a bf16 table
resident in VMEM, and leaves the per-row segment sums to XLA:

    q, m = divmod(c, 128)
    picked = onehot(q, 512) @ x2          # (512, 256) hi|lo or (512, 128) bf16 table
    sel = (picked_hi + picked_lo)[m]      # hi|lo folded in f32
    prod = sel * data

Two table precisions: ``hilo``, x2 = [bf16(x) | bf16(x - bf16(x))], relative
error ~1e-5; ``bf16``, x2 = bf16(x), ~2e-3. Here :func:`products` launches
the products kernel (``kernels/csrc/probes.cu``, counter ``spmv_products``;
the table in shared memory when it fits, as the benchmark shape's 512 rows
do: ``_cuda.spmv_products_design``) for CUDA tensors and
:func:`products_plain` runs for CPU tensors; the segment sums over the
port's row-ELL tiers are torch ops, as they were XLA.
:func:`main` runs the prototype's SpMV at the benchmark shape (65,536², 2^21
entry draws) against a float64 oracle and times it beside K1.

    python -m sparse_tpu_torch.experiments.pallas_spmv_onehot
"""

from __future__ import annotations

import numpy as np
import torch

from .._settings import resolve_device
from ..kernels import _cuda
from ..kernels.row_ell import build_row_ell, row_ell_spmv
from .common import time_on_card

M = K = 1 << 16
NNZ = 1 << 21
LANES = 128
BLOCKS = (2048, 4096)


def make_table(x, hilo):
    """The bf16 table of ``x`` (float32, length a multiple of 128; 65,536 at
    the benchmark shape): ``[hi | lo]`` of shape ``(K / 128, 256)`` with
    ``hi = bf16(x)``, ``lo = bf16(x − f32(hi))`` (both rounded to nearest
    even), or ``hi`` alone ``(K / 128, 128)``."""
    if x.dtype != torch.float32 or x.ndim != 1 or x.shape[0] % LANES:
        raise ValueError(f"make_table takes a float32 vector whose length is a multiple of {LANES}")
    hi = x.to(torch.bfloat16)
    if not hilo:
        return hi.view(-1, LANES)
    lo = (x - hi.float()).to(torch.bfloat16)
    return torch.cat([hi.view(-1, LANES), lo.view(-1, LANES)], dim=1)


def products_plain(x2, cols, data):
    """``out[e, 0] = (f32(x2[q, m]) + f32(x2[q, 128 + m])) · data[e]`` (hi|lo)
    or ``f32(x2[q, m]) · data[e]`` (bf16), ``q, m = divmod(cols[e], 128)``;
    0 where ``q`` is outside the table (its one-hot row is all zeros)."""
    q = torch.div(cols, LANES, rounding_mode="floor").long()
    m = (cols - q * LANES).long()
    inside = (q >= 0) & (q < x2.shape[0])
    q = q.clamp(0, x2.shape[0] - 1)
    sel = x2[q, m].float()
    if x2.shape[1] == 2 * LANES:
        sel = sel + x2[q, LANES + m].float()
    return (torch.where(inside, sel, 0.0) * data).unsqueeze(1)


def products(x2, cols, data):
    """The products stream ``(n, 1)`` float32 of E1's Pallas kernel for a
    table ``x2`` from :func:`make_table` (hi|lo when it has 256 columns),
    int32 ``cols`` and float32 ``data`` of shape ``(n,)``."""
    if x2.dtype != torch.bfloat16 or x2.ndim != 2 or x2.shape[1] not in (LANES, 2 * LANES):
        raise TypeError("x2 must be a bfloat16 table of shape (rows, 128) or (rows, 256)")
    if cols.dtype != torch.int32 or data.dtype != torch.float32 or cols.ndim != 1 or data.shape != cols.shape:
        raise TypeError("cols and data must be int32 and float32 vectors of one length")
    if not x2.device == cols.device == data.device:
        raise ValueError(f"x2, cols and data lie on {x2.device}, {cols.device} and {data.device}")
    if cols.device.type == "cpu":
        return products_plain(x2, cols, data)
    out = torch.empty((cols.shape[0], 1), dtype=torch.float32, device=cols.device)
    return _cuda.spmv_products(x2.contiguous(), cols.contiguous(), data.contiguous(), out)


def flatten_tiers(re, blk):
    """The row-ELL tiers of ``re`` as one stream in layout order, zero-padded
    to a multiple of ``blk``: ``(cols int32, data float32)``."""
    n = sum(c.numel() for c, _ in re.tiers)
    n_pad = -(-n // blk) * blk
    device = re.flat_cols.device
    fc = torch.zeros(n_pad, dtype=torch.int32, device=device)
    fd = torch.zeros(n_pad, dtype=torch.float32, device=device)
    if re.tiers:
        fc[:n] = torch.cat([c.reshape(-1) for c, _ in re.tiers])
        fd[:n] = torch.cat([d.reshape(-1) for _, d in re.tiers]).float()
    return fc, fd


def full_spmv(x2, fcols, fdata, re):
    """``A @ x`` through the products stream: each tier's products summed
    over its width axis, the rows without entries appended as zeros, then
    unpermuted with ``perm_inv``."""
    prods = products(x2, fcols, fdata).view(-1)
    outs, off = [], 0
    for c, _ in re.tiers:
        outs.append(prods[off : off + c.numel()].view(c.shape).sum(1).reshape(-1))  # (r/G, w, G) -> (r,)
        off += c.numel()
    outs.append(torch.zeros(re.n_rows - re.nz_rows, dtype=torch.float32, device=prods.device))
    return torch.cat(outs)[re.perm_inv.long()]


def bench_matrix():
    """``bench.py``'s matrix and vector, drawn as the prototype draws them:
    ``(rows, cols, data, x)`` with unique entries."""
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, M * K, size=NNZ, dtype=np.int64))
    rows = (lin // K).astype(np.int32)
    cols = (lin % K).astype(np.int32)
    data = rng.random(lin.size, dtype=np.float32)
    x = rng.random(K, dtype=np.float32)
    return rows, cols, data, x


def main(device=None):
    """The prototype's SpMV at the benchmark shape: hi|lo and bf16 tables at
    blocks of 2048 and 4096 slots against the float64 oracle, and K1
    (``row_ell_spmv``) on the same layout. Returns what the prototype
    printed: the entry counts, and for each run its relative error
    ``max|out − oracle| / max|oracle|`` and, on the card, ms and M nnz/s;
    besides, each run's output, the layout and ``x``."""
    dev = resolve_device(device)
    rows, cols, data, x = bench_matrix()
    nnz = rows.size
    re = build_row_ell(rows, cols, data, M, K, device=dev)
    oracle = np.zeros(M, dtype=np.float64)
    np.add.at(oracle, rows, data.astype(np.float64) * x.astype(np.float64)[cols])
    xt = torch.as_tensor(x, device=dev)

    def rate(ms):
        return None if ms is None else nnz / (ms * 1e-3) / 1e6

    result = {"nnz": nnz, "entries": sum(c.numel() for c, _ in re.tiers), "padded": {}, "runs": {}, "outputs": {}}
    result.update(layout=re, x=xt)
    for hilo in (True, False):
        x2 = make_table(xt, hilo)
        for blk in BLOCKS:
            label = f"{'hilo' if hilo else 'bf16'} blk={blk}"
            fc, fd = flatten_tiers(re, blk)
            result["padded"][blk] = fc.numel()
            out = full_spmv(x2, fc, fd, re)
            rel = float(np.abs(out.cpu().numpy() - oracle).max() / np.abs(oracle).max())
            ms = time_on_card(dev, lambda: full_spmv(x2, fc, fd, re))
            result["runs"][label] = {"ms": ms, "m_nnz_per_s": rate(ms), "relerr": rel}
            result["outputs"][label] = out
    ms = time_on_card(dev, lambda: row_ell_spmv(re, xt))
    result["row_ell_spmv"] = {"ms": ms, "m_nnz_per_s": rate(ms)}
    return result


if __name__ == "__main__":
    res = main()
    print(f"entries {res['entries']} padded {res['padded']}", flush=True)
    for label, r in res["runs"].items():
        print(f"{label}: {r['ms']:.6f} ms = {r['m_nnz_per_s']:.1f} M nnz/s, relerr {r['relerr']:.2e}", flush=True)
    r = res["row_ell_spmv"]
    print(f"row_ell_spmv (K1): {r['ms']:.6f} ms = {r['m_nnz_per_s']:.1f} M nnz/s", flush=True)
