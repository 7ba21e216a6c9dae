"""The min-plus relaxation of the shortest-path solvers: the per-destination
ELL layout and one Jacobi round over it.

``build_dest_ell`` builds the layout of ``sparse_tpu.csgraph._build_dest_ell``
array for array, on the host with NumPy, and moves it to the device once:
``e_src (n, L0)`` and ``e_w (n, L0)`` hold each destination's in-edges
(sources and weights, ``+inf`` padding), a tail ELL the overflow edges of
the few destinations of degree above ``L0``, which are relabelled to the
last ``d`` ids.

One round (``minplus_relax``) computes, for every destination ``v`` and
source column ``s`` of the transposed distance table ``distT (n, k)``::

    new[v, s] = min(distT[v, s], min_l distT[e_src[v, l], s] + e_w[v, l])

with the tail's slots joining the inner minimum for ``v >= n - d``, and the
0-d flag ``any(new < distT)``. Each round reads only the previous round's
table (Jacobi), as the reference's ``lax.while_loop`` does, so the rounds,
the fixed point and the negative-cycle test are the reference's. The
minimum propagates NaN as ``jnp.min`` does, and ``fl(d + w)`` is rounded
once, so a round's bits do not depend on the order of the slots.

On a CUDA tensor the round is K7, the hand-written kernel of
``csrc/minplus.cu`` (it replaces the XLA relaxation of
``sparse_tpu/csgraph.py:_bellman_ford_device_ell`` and ``_tail``), on the
route ``_cuda.minplus_route`` picks from the table's size (the gather route,
or column slices for a table past L2), taking only each row's filled slots
where the layout's counts ``deg``/``t_deg`` are given; on a CPU tensor it is
the plain version ``minplus_relax_plain``, which materialises the gathered
``(n, L0, k)`` block. Every route gives the plain version's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._settings import resolve_device
from .._utils import numpy_dtype
from . import _cuda


class DestEll(NamedTuple):
    """Per-destination ELL layout of a graph's edges (relabelled ids when
    ``perm`` is not ``None``)."""

    e_src: torch.Tensor  # (n, L0) int64 source of each in-edge slot, 0 in padding
    e_w: torch.Tensor  # (n, L0) weight of each slot, +inf in padding
    tail: tuple | None  # (t_src, t_w), each (d, Lt): overflow slots of destinations n - d .. n - 1
    perm: torch.Tensor | None  # (n,) int64, perm[new_id] == old_id
    inv: torch.Tensor | None  # (n,) int64, inv[old_id] == new_id
    deg: torch.Tensor  # (n,) int32, min(in-degree, L0): the filled slots of each row, its prefix
    t_deg: torch.Tensor | None  # (d,) int32, the filled slots of each tail row, its prefix


def build_dest_ell(rows, cols, w, n, *, width_cap=256, dtype=torch.float64, device=None):
    """The :class:`DestEll` layout of the edges ``rows[e] -> cols[e]`` with
    weights ``w`` (host NumPy arrays) of an ``n``-node graph, on ``device``
    (the GPU for ``None``), or ``None`` where the reference refuses one: no
    edges, or a padded width past ``width_cap`` on a degree-skewed graph.

    ``L0`` is the smallest of 4, 8, 12, ..., 256 below the largest in-degree
    that leaves at most 1,024 destinations and 1 % of the edges (at least
    64) to the tail; else the largest in-degree, and no tail. ``deg`` and
    ``t_deg`` count each row's filled slots (int32: 4 bytes a row beside the
    reference's arrays)."""
    device = resolve_device(device)
    if rows.size == 0:
        return None
    counts = np.bincount(cols, minlength=n)
    L = int(counts.max())
    mean = rows.size / max(n, 1)
    L0 = L
    for cand in sorted({4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256}):
        if cand >= L:
            break
        d = int((counts > cand).sum())
        if d <= 1024 and int(np.maximum(counts - cand, 0).sum()) <= max(rows.size // 100, 64):
            L0 = cand
            break
    if L0 > max(32, 8 * mean) and L0 > width_cap:
        return None

    perm = inv = None
    if L0 < L:
        high = counts > L0
        perm = np.concatenate([np.flatnonzero(~high), np.flatnonzero(high)])
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        rows = inv[rows]
        cols = inv[cols]
        counts = counts[perm]

    fdt = numpy_dtype(dtype)
    order = np.argsort(cols, kind="stable")
    cs, rs, ws = cols[order], rows[order], w[order].astype(fdt)
    within = np.arange(rows.size) - np.concatenate([[0], np.cumsum(counts)])[:-1][cs]
    main = within < L0
    e_src = np.zeros((n, L0), dtype=np.int64)
    e_w = np.full((n, L0), np.inf, dtype=fdt)
    e_src[cs[main], within[main]] = rs[main]
    e_w[cs[main], within[main]] = ws[main]
    tail = t_deg = None
    if not main.all():
        t = ~main
        d = int(high.sum())
        Lt = int((counts[n - d :] - L0).max())
        t_src = np.zeros((d, Lt), dtype=np.int64)
        t_w = np.full((d, Lt), np.inf, dtype=fdt)
        t_src[cs[t] - (n - d), within[t] - L0] = rs[t]
        t_w[cs[t] - (n - d), within[t] - L0] = ws[t]
        tail = (torch.from_numpy(t_src).to(device), torch.from_numpy(t_w).to(device))
        t_deg = (counts[n - d :] - L0).astype(np.int32)
    deg = np.minimum(counts, L0).astype(np.int32)

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return DestEll(dev(e_src), dev(e_w), tail, dev(perm), dev(inv), dev(deg), dev(t_deg))


def minplus_relax_plain(distT, e_src, e_w, tail=None):
    """One round in torch ops: ``(new, changed)``, ``new`` a new ``(n, k)``
    table and ``changed`` the 0-d bool ``any(new < distT)``."""
    n, width = e_src.shape
    g = distT[e_src.reshape(-1)].reshape(n, width, -1)
    best = torch.amin(g + e_w[:, :, None], dim=1)  # (n, k); padding is +inf
    if tail is not None:
        t_src, t_w = tail
        d, t_width = t_src.shape
        tg = distT[t_src.reshape(-1)].reshape(d, t_width, -1)
        t_best = torch.amin(tg + t_w[:, :, None], dim=1)
        best[n - d :] = torch.minimum(best[n - d :], t_best)
    new = torch.minimum(distT, best)
    return new, (new < distT).any()


def minplus_relax(distT, e_src, e_w, tail=None, out=None, *, deg=None, t_deg=None, budget=None):
    """One round, ``(new, changed)``: K7 on a CUDA ``distT`` (float32 or
    float64, contiguous; the layout on the same device, ``e_w`` of its
    dtype), on ``_cuda.minplus_route``'s route for ``budget`` (the L2
    budget in bytes; ``None`` for the rule's), taking only the ``deg``/
    ``t_deg`` filled slots of each row where given, writing into ``out`` (a
    new table when ``None``; never ``distT``); the plain version on a CPU
    tensor, copied into ``out`` when one is given. ``changed`` is a 0-d
    bool tensor on ``distT``'s device."""
    if distT.device.type == "cpu":
        new, changed = minplus_relax_plain(distT, e_src, e_w, tail)
        if out is not None:
            new = out.copy_(new)
        return new, changed
    if out is None:
        out = torch.empty_like(distT, memory_format=torch.contiguous_format)
    _, cols = _cuda.minplus_route(*distT.shape, distT.element_size(), budget)
    stamp = torch.zeros(1, dtype=torch.int32, device=distT.device)
    _cuda.minplus_relax(distT, e_src, e_w, tail, out, stamp, 1, deg=deg, t_deg=t_deg, slice_cols=cols)
    return out, stamp[0] == 1


def _k7_launches(distT, *, deg=None, t_deg=None, budget=None):
    """``(launch, stamp)``: ``launch(src, e_src, e_w, tail, out)`` runs one
    round on K7 into ``out``, on the route ``_cuda.minplus_route`` picks for
    ``distT``'s shape and ``budget``, over the ``deg``/``t_deg`` filled
    slots where given, and returns the round's number ``r`` (1, 2, ...); the
    round writes ``r`` into the int32 ``stamp`` where a value fell. The
    stamp is zeroed once, here: no fill a round, and nothing read back."""
    _, cols = _cuda.minplus_route(*distT.shape, distT.element_size(), budget)
    stamp = torch.zeros(1, dtype=torch.int32, device=distT.device)
    number = 0

    def launch(src, e_src, e_w, tail, out):
        nonlocal number
        number += 1
        _cuda.minplus_relax(src.contiguous(), e_src, e_w, tail, out, stamp, number, deg=deg, t_deg=t_deg, slice_cols=cols)
        return number

    return launch, stamp


def _k7_rounds(distT, *, deg=None, t_deg=None, budget=None):
    """A solve's round on K7 for :func:`minplus_fixpoint`'s ``relax``
    (:func:`_k7_launches`' launch), returning the Python bool ``stamp ==
    r``: one launch and one read back a round, no fill."""
    launch, stamp = _k7_launches(distT, deg=deg, t_deg=t_deg, budget=budget)

    def relax(src, e_src, e_w, tail, out):
        number = launch(src, e_src, e_w, tail, out)
        return out, stamp.item() == number

    return relax


def minplus_fixpoint(distT, e_src, e_w, tail=None, *, maxiter, relax=None, deg=None, t_deg=None, budget=None):
    """Jacobi rounds from ``distT`` until a round changes nothing or
    ``maxiter`` rounds ran, then one more round for the negative-cycle
    test, as the reference's loop (``csgraph.py:240-250``): ``(table,
    has_neg, rounds)``, ``has_neg`` a Python bool. ``distT`` is left as it
    is: the rounds ping-pong between two tables of their own. ``relax`` is
    the round; it takes ``out=`` and returns a flag, read back once a
    round. For ``None`` it is :func:`_k7_rounds`' on a CUDA table (with
    ``deg``, ``t_deg`` and ``budget``) and :func:`minplus_relax` on a CPU
    one."""
    if relax is None:
        relax = _k7_rounds(distT, deg=deg, t_deg=t_deg, budget=budget) if distT.device.type == "cuda" else minplus_relax
    bufs = [torch.empty_like(distT, memory_format=torch.contiguous_format) for _ in range(2)]
    rounds, changed = 0, True
    while changed and rounds < maxiter:
        distT, flag = relax(distT, e_src, e_w, tail, out=bufs[rounds % 2])
        changed = bool(flag)
        rounds += 1
    _, neg = relax(distT, e_src, e_w, tail, out=bufs[rounds % 2])
    return distT, bool(neg), rounds
