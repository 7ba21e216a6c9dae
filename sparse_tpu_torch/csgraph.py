"""Graph algorithms over sparse adjacency matrices, on torch tensors.

The surface of ``sparse_tpu.csgraph`` (modelled on ``scipy.sparse.csgraph``).
Stored entries are edges and the fill value must be zero;
``directed=False`` reads each stored edge both ways.

The shortest paths (``bellman_ford``, ``dijkstra``, ``shortest_path``'s
``'BF'``/``'D'``, ``johnson``'s second phase, the BFS levels) run the
min-plus relaxation to its fixed point: a Python loop of Jacobi rounds over
the per-destination ELL layout (``kernels.minplus.build_dest_ell``, cached
on a COO operand), each round one launch of K7 (``csrc/minplus.cu``) on
the card and one 0-d flag read back, then one more round for the
negative-cycle test, as the reference's ``lax.while_loop`` runs them. A
graph whose layout the reference refuses (degree skew past the tail's
reach), and ``johnson``'s first phase, take the scatter form:
``scatter_reduce_("amin")`` over the edge list. ``pagerank`` spreads its
mass with ``Wᵀ p`` on K1 (the row-ELL SpMV) over the row-ELL layout of
``Wᵀ``, cached on the operand. Weak components run label propagation
with ``scatter_reduce_``; strong components the boolean closure by
repeated squaring in float32 at full precision; Floyd-Warshall a loop of
torch ops over ``k``. The traversal orders, the spanning tree, the
matchings, the maximum flow, Yen's paths and the representation helpers
are host NumPy, as in the reference. ``bellman_ford_partitioned`` and
``pagerank_partitioned`` split the edge list over a mesh's ranks
(``parallel.make_mesh``): a rank's rounds on K7 or K1 over its chunk, the
ranks joined by one collective a round.

Distances, weights and scores are float64 and indices int64 on every
device (the reference's types on its CPU backend, and scipy's). Results
live on the operand's device: a port sparse array's or a dense tensor's
own, and the GPU for a scipy matrix or a NumPy array. They are tensors
where the reference returns NumPy arrays and port COOs where it returns
COOs; masked arrays stay ``numpy.ma``. No build or launch is wrapped in a
``try``: a failure propagates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as _dist

from ._settings import resolve_device
from .core.base import SparseArray
from .core.coo import COO
from .kernels import minplus as _minplus
from .kernels import row_ell as _row_ell
from .kernels.bsr import _full_f32_matmul

__all__ = [
    "NegativeCycleError",
    "bellman_ford",
    "bellman_ford_partitioned",
    "breadth_first_order",
    "breadth_first_tree",
    "connected_components",
    "construct_dist_matrix",
    "csgraph_from_dense",
    "csgraph_from_masked",
    "csgraph_masked_from_dense",
    "csgraph_to_dense",
    "csgraph_to_masked",
    "depth_first_order",
    "depth_first_tree",
    "dijkstra",
    "floyd_warshall",
    "johnson",
    "laplacian",
    "maximum_bipartite_matching",
    "maximum_flow",
    "min_weight_full_bipartite_matching",
    "minimum_spanning_tree",
    "pagerank",
    "pagerank_partitioned",
    "reconstruct_path",
    "reverse_cuthill_mckee",
    "shortest_path",
    "structural_rank",
    "yen",
]

_F = torch.float64
_I = torch.int64
_NULL_IDX = -9999


class NegativeCycleError(Exception):
    """Raised when a negative-weight cycle is reachable in shortest-path routines."""


def _host(x):
    """``x`` as a NumPy array (a tensor is copied from its device)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ndim(x):
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def _square_error(shape):
    return ValueError(f"csgraph requires a square 2-D adjacency matrix, got {tuple(shape)}")


def _graph_triplet(csgraph, *, directed=True, unweighted=False, square=True):
    """Any graph input as host ``(rows, cols, weights, n, device)``: int64,
    int64, float64 NumPy arrays, the node count and the device results go
    to.

    Takes port sparse arrays (any format; their device), scipy sparse
    matrices and NumPy arrays (the GPU), and dense tensors (their device;
    nonzero entries are edges). With ``directed=False`` the edge list holds
    both orientations."""
    import scipy.sparse as sps

    from .ops.common import asCOO

    if isinstance(csgraph, SparseArray):
        coo = asCOO(csgraph)
        if not np.asarray(coo.fill_value)[()] == 0:
            raise ValueError("csgraph routines require a zero fill value")
        if coo.ndim != 2 or (square and coo.shape[0] != coo.shape[1]):
            raise _square_error(coo.shape)
        coords = coo.coords.cpu().numpy()
        rows, cols = coords[0], coords[1]
        w = coo.data.cpu().numpy().astype(np.float64)
        n, device = coo.shape[0], coo.device
    elif sps.issparse(csgraph):
        c = csgraph.tocoo()
        if square and c.shape[0] != c.shape[1]:
            raise _square_error(c.shape)
        rows, cols, w = c.row.astype(np.int64), c.col.astype(np.int64), c.data.astype(np.float64)
        n, device = c.shape[0], resolve_device(None)
    else:
        device = csgraph.device if isinstance(csgraph, torch.Tensor) else None
        a = _host(csgraph)
        if a.ndim != 2 or (square and a.shape[0] != a.shape[1]):
            raise _square_error(a.shape)
        rows, cols = np.nonzero(a)
        w = a[rows, cols].astype(np.float64)
        n, device = a.shape[0], resolve_device(device)
    if unweighted:
        w = np.ones_like(w)
    if not directed:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        w = np.concatenate([w, w])
    return rows.astype(np.int64), cols.astype(np.int64), w, n, device


def _edges(rows, cols, w, device):
    """The edge list's host arrays as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in (rows, cols, w))


# ---------------------------------------------------------------------------
# the min-plus relaxation (Bellman-Ford)
# ---------------------------------------------------------------------------


def _relax_scatter(rows, cols, w):
    """One round of the scatter form over the edge list, as the ``relax`` of
    :func:`~sparse_tpu_torch.kernels.minplus.minplus_fixpoint` (which passes
    it no layout): ``min(distT, segment_min(distT[rows] + w, cols))`` on the
    transposed ``(n, k)`` table, and the 0-d flag of a fall."""

    def relax(distT, _e_src, _e_w, _tail, out):
        cand = distT[rows] + w[:, None]  # (nnz, k)
        best = torch.full_like(distT, torch.inf)  # segment_min's identity
        best.scatter_reduce_(0, cols[:, None].expand_as(cand), cand, "amin")
        new = torch.minimum(distT, best, out=out)
        return new, (new < distT).any()

    return relax


def _bellman_ford_device(rows, cols, w, distT0, *, n):
    """The scatter form's fixed point from the transposed start table
    ``(n, k)``, for graphs the layout refuses and johnson's potentials:
    ``(dist (k, n), has_neg)``, ``has_neg`` True iff one more round still
    improves (a reachable negative cycle). The rounds are
    ``minplus_fixpoint``'s, one 0-d flag read back a round."""
    relax = _relax_scatter(rows, cols, w)
    distT, has_neg, _ = _minplus.minplus_fixpoint(distT0, None, None, maxiter=n + 1, relax=relax)
    return distT.T.contiguous(), has_neg


def _predecessors_device(rows, cols, w, dist, sources, *, n):
    """Post-hoc predecessor matrix: ``pred[s, v]`` = the smallest ``u`` with
    an edge ``u→v`` on a shortest path (``dist[s,u] + w == dist[s,v]``);
    -9999 for unreachable nodes and for the source itself (scipy's
    convention). int32, as the reference returns it."""
    k = dist.shape[0]
    d_rows = dist[:, rows]
    on_path = torch.isfinite(d_rows) & (d_rows + w[None, :] == dist[:, cols])
    cand = torch.where(on_path, rows[None, :], n)  # (k, nnz)
    # segment_min's identity (int max) where a node has no incoming edge
    best = torch.full((n, k), torch.iinfo(_I).max, dtype=_I, device=dist.device)
    best.scatter_reduce_(0, cols[:, None].expand(-1, k), cand.T, "amin")
    best = best.T
    pred = torch.where(best >= n, _NULL_IDX, best)
    src_mask = torch.arange(n, device=dist.device)[None, :] == sources[:, None]
    return torch.where(src_mask, _NULL_IDX, pred).to(torch.int32)


def _canon_index(i, n, what="index"):
    """Numpy-style index canonicalization: negatives wrap once, anything
    outside [-n, n) raises."""
    i = int(i)
    if not -n <= i < n:
        raise ValueError(f"{what} {i} out of range for a graph with {n} nodes")
    return i % n


def _prepare_sources(indices, n):
    """The sources as int64 node ids, negatives wrapped once; all nodes for ``None``."""
    if indices is None:
        return np.arange(n, dtype=np.int64)
    idx = np.atleast_1d(np.asarray(_host(indices), dtype=np.int64))
    if idx.ndim != 1:
        raise ValueError("indices must be a scalar or 1-D array of source nodes")
    if idx.size and (idx.min() < -n or idx.max() >= n):
        raise ValueError(f"source indices out of range for a graph with {n} nodes")
    return idx % n


def _start_table(k, n, zero_at, device):
    """The transposed start table ``(n, k)``: ``+inf``, and 0 at
    ``(zero_at[j], j)``."""
    distT = torch.full((n, k), torch.inf, dtype=_F, device=device)
    distT[zero_at, torch.arange(k, device=device)] = 0.0
    return distT


def _relax_ell(ell, distT0, n):
    """The fixed point over the layout from the transposed start table (in
    the layout's labels): ``(dist (k, n) in the input's labels, has_neg)``."""
    distT, has_neg, _ = _minplus.minplus_fixpoint(
        distT0, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, deg=ell.deg, t_deg=ell.t_deg
    )
    if ell.inv is not None:
        return torch.index_select(distT.T, 1, ell.inv), has_neg  # back to the input's labels
    return distT.T.contiguous(), has_neg


def _shortest_path_bf(
    csgraph,
    *,
    directed,
    indices,
    unweighted,
    return_predecessors,
    check_negative=True,
    require_nonnegative=False,
):
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=directed, unweighted=unweighted)
    if require_nonnegative and rows.size and w.min() < 0:
        raise ValueError("dijkstra requires non-negative edge weights; use bellman_ford")
    sources = _prepare_sources(indices, n)
    k = sources.shape[0]
    src = torch.from_numpy(sources).to(device)
    if rows.size == 0:
        dist = _start_table(k, n, src, device).T.contiguous()
        has_neg = False
    else:
        # the layout is kept on a COO operand: repeated calls on one graph
        # pay only the relaxation loop
        cached = getattr(csgraph, "_cached_layout", None)
        if cached is not None and not unweighted:
            ell = cached("dest_ell", bool(directed), lambda: _minplus.build_dest_ell(rows, cols, w, n, device=device))
        else:
            ell = _minplus.build_dest_ell(rows, cols, w, n, device=device)
        if ell is not None:
            # high-degree destinations were relabelled to the last ids
            start = src if ell.inv is None else ell.inv[src]
            dist, has_neg = _relax_ell(ell, _start_table(k, n, start, device), n)
        else:
            dist, has_neg = _bellman_ford_device(*_edges(rows, cols, w, device), _start_table(k, n, src, device), n=n)
    if check_negative and has_neg:
        raise NegativeCycleError("negative-weight cycle detected in the graph")
    if return_predecessors:
        if rows.size == 0:
            pred = torch.full((k, n), _NULL_IDX, dtype=torch.int32, device=device)
        else:
            pred = _predecessors_device(*_edges(rows, cols, w, device), dist, src, n=n)
        return dist, pred
    return dist


def bellman_ford(csgraph, directed=True, indices=None, return_predecessors=False, unweighted=False):
    """Multi-source Bellman-Ford shortest paths (min-plus relaxation on the
    operand's device; K7 on the card).

    Mirrors ``scipy.sparse.csgraph.bellman_ford``: returns the
    ``(n_sources, n)`` distance tensor (and the int32 predecessor tensor
    when requested), raising :class:`NegativeCycleError` on reachable
    negative cycles.
    """
    out = _shortest_path_bf(
        csgraph,
        directed=directed,
        indices=indices,
        unweighted=unweighted,
        return_predecessors=return_predecessors,
    )
    return _squeeze_sources(out, indices, return_predecessors)


def dijkstra(
    csgraph, directed=True, indices=None, return_predecessors=False, unweighted=False, limit=np.inf
):
    """Shortest paths for non-negative weights (scipy-compatible signature).

    Validates non-negativity and runs the same relaxation as
    :func:`bellman_ford` (identical results for non-negative graphs);
    ``limit`` masks distances beyond the horizon to ``inf`` afterwards.
    """
    out = _shortest_path_bf(
        csgraph,
        directed=directed,
        indices=indices,
        unweighted=unweighted,
        return_predecessors=return_predecessors,
        check_negative=False,
        require_nonnegative=True,
    )
    if np.isfinite(limit):
        if return_predecessors:
            dist, pred = out
            far = dist > limit
            out = (torch.where(far, torch.inf, dist), torch.where(far, _NULL_IDX, pred))
        else:
            out = torch.where(out > limit, torch.inf, out)
    return _squeeze_sources(out, indices, return_predecessors)


# ---------------------------------------------------------------------------
# the partitioned relaxation (the edge list split over a mesh's ranks)
# ---------------------------------------------------------------------------

_LOW63 = 0x7FFFFFFFFFFFFFFF


def _min_keys(t):
    """float64 ``t`` as int64 keys in the same order, NaN the least: an
    ``all_reduce(MIN)`` of the keys is ``jnp.minimum``'s (NaN propagates),
    whatever NaN rule the backend's float minimum has."""
    b = t.view(torch.int64)
    key = torch.where(b < 0, b ^ _LOW63, b)
    return torch.where(torch.isnan(t), torch.iinfo(torch.int64).min, key)


def _from_min_keys(key):
    """:func:`_min_keys`' inverse; a NaN comes back as the quiet NaN
    ``torch.nan`` (its payload is not kept)."""
    t = torch.where(key < 0, key ^ _LOW63, key).view(torch.float64)
    return torch.where(key == torch.iinfo(torch.int64).min, torch.nan, t)


def _edge_chunk(mesh, axis_name, arrays, fills):
    """The rank's chunk of the edge list: ``arrays`` padded to a multiple of
    the axis's size with ``fills`` (the reference's padding edges 0 → 0)
    and cut into equal chunks, one a rank in rank order."""
    from .parallel.sharding import _mesh_dim

    dim = _mesh_dim(mesh, axis_name)
    size, coord = mesh.size(dim), mesh.get_local_rank(dim)
    cap = max(-(-arrays[0].size // size), 1)
    pad = cap * size - arrays[0].size
    return [np.concatenate([a, np.full(pad, f, dtype=a.dtype)])[coord * cap : (coord + 1) * cap] for a, f in zip(arrays, fills)]


def bellman_ford_partitioned(
    csgraph, mesh, *, indices=None, directed=True, unweighted=False, return_predecessors=False, axis_name="x"
):
    """Multi-source Bellman-Ford with the edge list split over the ranks of
    ``mesh``'s axis (``parallel.make_mesh``): the same results as
    :func:`bellman_ford`, bit for bit, at every world size.

    The edges are cut into one equal chunk a rank, padded with ``+inf``
    edges 0 → 0. Each Jacobi round a rank relaxes the shared ``(n, k)``
    table over its chunk, on K7 over the chunk's ``build_dest_ell`` layout
    (built once a call; the scatter form where the layout is refused), and
    one ``all_reduce(MIN)`` joins the ranks' tables (int64 keys in the
    floats' order, so NaN propagates as in the reference); the flag of a
    fall is taken from the joined table and read back once a round. The
    rounds run to the fixed point (at most ``n + 1``), then one more tests
    for a negative cycle (:class:`NegativeCycleError`). Predecessors come
    from the whole edge list. The table is in the input's labels: where a
    chunk's layout relabels the nodes, the rank maps the table into the
    layout's labels and its round back, every round, at every world size.
    Results are on the mesh's device."""
    from .parallel.sharding import _device, _mesh_dim

    rows, cols, w, n, _ = _graph_triplet(csgraph, directed=directed, unweighted=unweighted)
    device = _device(mesh)
    dim = _mesh_dim(mesh, axis_name)
    group = mesh.get_group(dim)
    sources = _prepare_sources(indices, n)
    k = sources.shape[0]
    src = torch.from_numpy(sources).to(device)
    r_c, c_c, w_c = _edge_chunk(mesh, axis_name, (rows, cols, w), (0, 0, np.inf))
    ell = _minplus.build_dest_ell(r_c, c_c, w_c, n, device=device)
    relabel = ell is not None and ell.perm is not None
    local = torch.empty((n, k), dtype=_F, device=device)  # the rank's round, before the join
    if ell is None:
        scatter = _relax_scatter(*_edges(r_c, c_c, w_c, device))
    elif device.type == "cuda":
        launch, _ = _minplus._k7_launches(local, deg=ell.deg, t_deg=ell.t_deg)

    def relax(distT, _e_src, _e_w, _tail, out):
        mine = distT.index_select(0, ell.perm) if relabel else distT
        if ell is None:
            scatter(mine, None, None, None, local)
        elif device.type == "cuda":
            launch(mine, ell.e_src, ell.e_w, ell.tail, local)
        else:
            local.copy_(_minplus.minplus_relax_plain(mine, ell.e_src, ell.e_w, ell.tail)[0])
        keys = _min_keys(local.index_select(0, ell.inv) if relabel else local)
        _dist.all_reduce(keys, op=_dist.ReduceOp.MIN, group=group)
        new = out.copy_(_from_min_keys(keys))
        return new, (new < distT).any()

    distT, has_neg, _ = _minplus.minplus_fixpoint(_start_table(k, n, src, device), None, None, maxiter=n + 1, relax=relax)
    dist_t = distT.T.contiguous()
    if has_neg:
        raise NegativeCycleError("negative-weight cycle detected in the graph")
    if return_predecessors:
        if rows.size:
            pred = _predecessors_device(*_edges(rows, cols, w, device), dist_t, src, n=n)
        else:
            pred = torch.full((k, n), _NULL_IDX, dtype=torch.int32, device=device)
        return _squeeze_sources((dist_t, pred), indices, True)
    return _squeeze_sources(dist_t, indices, False)


def _squeeze_sources(out, indices, return_predecessors):
    if indices is not None and _ndim(indices) == 0:
        if return_predecessors:
            return out[0][0], out[1][0]
        return out[0]
    return out


def shortest_path(
    csgraph,
    method="auto",
    directed=True,
    return_predecessors=False,
    unweighted=False,
    indices=None,
):
    """All-pairs / multi-source shortest paths.

    ``method``: 'FW' (dense Floyd-Warshall, all pairs), 'BF'/'D' (the
    min-plus relaxation), or 'auto' — FW when all pairs are requested on a
    small dense-ish graph, BF otherwise.
    """
    if method == "auto":
        rows, _, _, n, _ = _graph_triplet(csgraph, directed=directed)
        dense_enough = n <= 2048 and rows.size >= n
        method = "FW" if indices is None and dense_enough else "BF"
    if method == "FW":
        if indices is not None:
            raise ValueError("Floyd-Warshall computes all pairs; indices is unsupported")
        return floyd_warshall(
            csgraph, directed=directed, return_predecessors=return_predecessors, unweighted=unweighted
        )
    if method in ("BF", "D"):
        fn = bellman_ford if method == "BF" else dijkstra
        return fn(
            csgraph,
            directed=directed,
            indices=indices,
            return_predecessors=return_predecessors,
            unweighted=unweighted,
        )
    raise ValueError(f"unknown method {method!r}; expected 'auto', 'FW', 'BF', or 'D'")


def johnson(csgraph, directed=True, indices=None, return_predecessors=False, unweighted=False):
    """All-pairs / multi-source shortest paths with negative edge weights
    (no negative cycles) via Johnson's reweighting.

    One Bellman-Ford from a virtual source (the scatter form) gives
    potentials ``h``; edges reweight to ``w + h[u] - h[v] >= 0`` and a
    second, multi-source relaxation runs on the reweighted graph (on its
    own ELL layout where the reference builds one: K7 on the card);
    distances shift back by ``h[v] - h[u]``.
    """
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=directed, unweighted=unweighted)
    sources = _prepare_sources(indices, n)
    if rows.size == 0:
        return bellman_ford(
            csgraph, directed=directed, indices=indices,
            return_predecessors=return_predecessors, unweighted=unweighted,
        )
    # phase 1: potentials = shortest distance from a virtual node connected
    # to every vertex with weight 0 == BF with all-zero initial distances
    rj, cj, wj = _edges(rows, cols, w, device)
    h, has_neg = _bellman_ford_device(rj, cj, wj, torch.zeros((n, 1), dtype=_F, device=device), n=n)
    if has_neg:
        raise NegativeCycleError("negative-weight cycle detected in the graph")
    h = h[0]
    h_host = h.cpu().numpy()
    # phase 2: non-negative reweighted relaxation + unshift
    w2 = w + h_host[rows] - h_host[cols]
    w2 = np.maximum(w2, 0.0)  # clip fp residue; exact zeros on shortest edges
    k = sources.shape[0]
    src = torch.from_numpy(sources).to(device)
    w2j = torch.from_numpy(w2).to(device)
    d0 = _start_table(k, n, src, device)  # transposed: (n, k)
    ell = _minplus.build_dest_ell(rows, cols, w2, n, device=device)
    if ell is not None:
        d0_l = d0 if ell.perm is None else d0[ell.perm]  # d0_l[new] = d0[perm[new]]
        dist_rw, _ = _relax_ell(ell, d0_l, n)
    else:
        dist_rw, _ = _bellman_ford_device(rj, cj, w2j, d0, n=n)
    dist = dist_rw + (h[None, :] - h[src][:, None])
    if return_predecessors:
        # predecessors on the REWEIGHTED relaxation: shortest paths are
        # invariant under the potential shift, and the fp equality
        # dist[u] + w == dist[v] only holds exactly for the quantities the
        # relaxation computed
        pred = _predecessors_device(rj, cj, w2j, dist_rw, src, n=n)
        out = (dist, pred)
    else:
        out = dist
    return _squeeze_sources(out, indices, return_predecessors)


# ---------------------------------------------------------------------------
# Floyd-Warshall (dense, on the device)
# ---------------------------------------------------------------------------


def _floyd_warshall_device(d, p, *, track_pred):
    """``n`` out-of-place steps ``min(D, D[:, k] + D[k, :])`` (and the
    predecessors they pick), as the reference's ``fori_loop``."""
    for k in range(d.shape[0]):
        via = d[:, k, None] + d[None, k, :]
        better = via < d
        d = torch.where(better, via, d)
        if track_pred:
            p = torch.where(better, p[None, k, :], p)
    return d, p


def floyd_warshall(csgraph, directed=True, return_predecessors=False, unweighted=False):
    """All-pairs shortest paths via dense Floyd-Warshall on the device.

    O(n²) memory / O(n³) work: one pass of torch ops a ``k``. Raises
    :class:`NegativeCycleError` if any diagonal entry goes negative.
    """
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=directed, unweighted=unweighted)
    d0 = np.full((n, n), np.inf, dtype=np.float64)
    # parallel edges keep the lightest weight
    np.minimum.at(d0, (rows, cols), w)
    np.fill_diagonal(d0, np.minimum(np.diag(d0), 0.0))
    p0 = np.full((n, n), _NULL_IDX, dtype=np.int32)
    p0[rows, cols] = rows
    np.fill_diagonal(p0, _NULL_IDX)
    d, p = _floyd_warshall_device(
        torch.from_numpy(d0).to(device), torch.from_numpy(p0).to(device), track_pred=return_predecessors
    )
    if bool((torch.diagonal(d) < 0).any()):
        raise NegativeCycleError("negative-weight cycle detected in the graph")
    if return_predecessors:
        return d, p
    return d


# ---------------------------------------------------------------------------
# BFS, DFS and the host traversals
# ---------------------------------------------------------------------------


def breadth_first_order(csgraph, i_start, directed=True, return_predecessors=True):
    """BFS node ordering + predecessors from ``i_start``.

    Levels come from the unweighted relaxation (one round per BFS frontier;
    K7 on the card); the node order is sorted by ``(level, node id)`` on the
    host — a valid BFS order (scipy's order additionally depends on its
    queue, so compare by level, not position).
    """
    dist, pred = _shortest_path_bf(
        csgraph,
        directed=directed,
        indices=np.asarray(_host(i_start)),
        unweighted=True,
        return_predecessors=True,
    )
    dist_h, pred = dist[0].cpu().numpy(), pred[0]
    reachable = np.flatnonzero(np.isfinite(dist_h))
    order = torch.from_numpy(reachable[np.argsort(dist_h[reachable], kind="stable")].astype(np.int64))
    order = order.to(dist.device)
    if return_predecessors:
        return order, pred
    return order


def _tree(order, pred, rows, cols, w, n, start, device):
    """The tree of edges ``(pred[v], v)`` over ``order`` but ``start``, each
    with its lightest original weight, as a COO on ``device``."""
    order, pred = _host(order), _host(pred)
    v = order[order != start]
    u = pred[v].astype(np.int64)
    # lexsort edges by (row, col, weight), searchsorted the linearized key
    eorder = np.lexsort((w, cols, rows))
    keys = rows[eorder] * n + cols[eorder]
    pos = np.searchsorted(keys, u * n + v)
    return COO(np.stack([u, v]), w[eorder][pos], shape=(n, n), device=device)


def breadth_first_tree(csgraph, i_start, directed=True):
    """The BFS tree as a sparse matrix: edge ``(pred[v], v)`` for every
    reachable ``v != i_start``, carrying the original edge weight."""
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=directed)
    start = _canon_index(i_start, n, "i_start")
    order, pred = breadth_first_order(csgraph, start, directed=directed)
    return _tree(order, pred, rows, cols, w, n, start, device)


def _csr_adjacency(csgraph, *, directed=True):
    """Host CSR adjacency ``(indptr, indices, n, device)`` for the traversal orders."""
    rows, cols, _, n, device = _graph_triplet(csgraph, directed=directed)
    order = np.lexsort((cols, rows))
    rows_s, cols_s = rows[order], cols[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows_s + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cols_s, n, device


def depth_first_order(csgraph, i_start, directed=True, return_predecessors=True):
    """DFS preorder + predecessors from ``i_start`` (scipy-compatible).

    DFS is sequential: a host stack walk over the CSR adjacency,
    neighbours explored in index order as scipy does.
    """
    indptr, indices, n, device = _csr_adjacency(csgraph, directed=directed)
    i_start = _canon_index(i_start, n, "i_start")
    visited = np.zeros(n, dtype=bool)
    pred = np.full(n, _NULL_IDX, dtype=np.int32)
    order = []
    # push neighbours in reverse so the lowest index pops first like scipy
    stack = [i_start]
    stack_pred = [_NULL_IDX]
    while stack:
        v = stack.pop()
        p = stack_pred.pop()
        if visited[v]:
            continue
        visited[v] = True
        if p >= 0:
            pred[v] = p
        order.append(v)
        nbrs = indices[indptr[v] : indptr[v + 1]]
        fresh = nbrs[~visited[nbrs]][::-1]
        stack.extend(fresh.tolist())
        stack_pred.extend([v] * fresh.size)
    node_array = torch.tensor(order, dtype=_I).to(device)
    if return_predecessors:
        return node_array, torch.from_numpy(pred).to(device)
    return node_array


def depth_first_tree(csgraph, i_start, directed=True):
    """The DFS tree as a sparse matrix (edge ``(pred[v], v)`` with the
    original weight), mirroring :func:`breadth_first_tree`."""
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=directed)
    start = _canon_index(i_start, n, "i_start")
    order, pred = depth_first_order(csgraph, start, directed=directed)
    return _tree(order, pred, rows, cols, w, n, start, device)


def reverse_cuthill_mckee(csgraph, symmetric_mode=False):
    """Bandwidth-reducing node permutation (RCM).

    BFS from minimum-degree seeds, visiting neighbours in increasing-degree
    order, then reversed. Host algorithm (sequential by nature); the graph
    is symmetrized unless ``symmetric_mode``.
    """
    indptr, indices, n, device = _csr_adjacency(csgraph, directed=bool(symmetric_mode))
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # component seeds in min-degree order
    seeds = np.argsort(degree, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        pos += 1
        head = pos - 1
        while head < pos:
            v = order[head]
            head += 1
            nbrs = indices[indptr[v] : indptr[v + 1]]
            fresh = nbrs[~visited[nbrs]]
            if fresh.size:
                fresh = np.unique(fresh)
                fresh = fresh[np.argsort(degree[fresh], kind="stable")]
                visited[fresh] = True
                order[pos : pos + fresh.size] = fresh
                pos += fresh.size
    return torch.from_numpy(order[::-1].copy()).to(device)


# ---------------------------------------------------------------------------
# matchings, flows and K shortest paths (host)
# ---------------------------------------------------------------------------


def _matching(graph):
    """Kuhn's augmenting paths: ``(match_col, match_row, device)``, int64."""
    rows, cols, _, _, device = _graph_triplet(graph, directed=True, square=False)
    n_rows, n_cols = graph.shape
    order = np.lexsort((cols, rows))
    rows_s, cols_s = rows[order], cols[order]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows_s + 1, 1)
    np.cumsum(indptr, out=indptr)

    match_col = np.full(n_cols, -1, dtype=np.int64)  # col -> row
    match_row = np.full(n_rows, -1, dtype=np.int64)  # row -> col

    def augment(r, seen):
        for c in cols_s[indptr[r] : indptr[r + 1]]:
            if seen[c]:
                continue
            seen[c] = True
            if match_col[c] < 0 or augment(match_col[c], seen):
                match_col[c] = r
                match_row[r] = c
                return True
        return False

    import sys as _sys

    old_limit = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old_limit, n_rows + n_cols + 100))
    try:
        for r in range(n_rows):
            if match_row[r] < 0:
                augment(r, np.zeros(n_cols, dtype=bool))
    finally:
        _sys.setrecursionlimit(old_limit)
    return match_col, match_row, device


def maximum_bipartite_matching(graph, perm_type="row"):
    """Maximum matching of the bipartite graph whose biadjacency matrix is
    ``graph`` (Kuhn's augmenting-path algorithm on the host).

    scipy's convention: ``perm_type='row'`` returns, for each column, the
    matched row (length ``n_cols``, -1 when unmatched); ``'column'``
    returns, for each row, the matched column (length ``n_rows``). An
    int32 tensor on the graph's device.
    """
    match_col, match_row, device = _matching(graph)
    if perm_type == "row":
        return torch.from_numpy(match_col.astype(np.int32)).to(device)
    if perm_type == "column":
        return torch.from_numpy(match_row.astype(np.int32)).to(device)
    raise ValueError("perm_type must be 'row' or 'column'")


def structural_rank(graph):
    """Structural rank = size of the maximum bipartite matching of the
    sparsity pattern (scipy-compatible), a Python int."""
    _, match_row, _ = _matching(graph)
    return int((match_row >= 0).sum())


class MaximumFlowResult:
    """Mirror of scipy's result object: ``flow_value`` and the ``flow``
    matrix (COO; ``flow[u, v]`` is the flow sent along edge ``u -> v``,
    with the skew-symmetric reverse entries like scipy)."""

    def __init__(self, flow_value, flow):
        self.flow_value = flow_value
        self.flow = flow

    def __repr__(self):
        return f"MaximumFlowResult(flow_value={self.flow_value})"


def maximum_flow(csgraph, source, sink):
    """Maximum flow between ``source`` and ``sink`` via Dinic's algorithm
    (host; scipy-compatible, integer capacities required).

    BFS builds the level graph each phase; blocking flow runs an iterative
    DFS with current-arc pointers. Returns :class:`MaximumFlowResult`, its
    ``flow`` a COO on the graph's device.
    """
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=True)
    source = _canon_index(source, n, "source")
    sink = _canon_index(sink, n, "sink")
    if source == sink:
        raise ValueError("source and sink must differ")
    if not np.all(w == np.round(w)):
        raise ValueError("maximum_flow requires integer capacities (scipy convention)")
    caps = w.astype(np.int64)
    if caps.size and caps.min() < 0:
        raise ValueError("capacities must be non-negative")

    # arc arrays: forward arc 2i, reverse arc 2i+1 (paired by xor 1)
    m = rows.size
    arc_head = np.empty(2 * m, dtype=np.int64)
    arc_cap = np.zeros(2 * m, dtype=np.int64)
    arc_head[0::2] = cols
    arc_head[1::2] = rows
    arc_cap[0::2] = caps
    arc_tail = np.empty(2 * m, dtype=np.int64)
    arc_tail[0::2] = rows
    arc_tail[1::2] = cols
    adj = np.argsort(arc_tail, kind="stable")  # arcs sorted by tail
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, arc_tail[adj] + 1, 1)
    np.cumsum(indptr, out=indptr)

    flow_value = 0
    while True:
        # BFS level graph over arcs with residual capacity
        level = np.full(n, -1, dtype=np.int64)
        level[source] = 0
        frontier = [source]
        while frontier and level[sink] < 0:
            nxt = []
            for u in frontier:
                for a in adj[indptr[u] : indptr[u + 1]]:
                    if arc_cap[a] > 0 and level[arc_head[a]] < 0:
                        level[arc_head[a]] = level[u] + 1
                        nxt.append(int(arc_head[a]))
            frontier = nxt
        if level[sink] < 0:
            break
        # blocking flow: iterative DFS with current-arc pointers
        ptr = indptr[:-1].copy()
        stack = [source]
        path_arcs: list = []
        while stack:
            u = stack[-1]
            if u == sink:
                pushed = min(int(arc_cap[a]) for a in path_arcs)
                for a in path_arcs:
                    arc_cap[a] -= pushed
                    arc_cap[a ^ 1] += pushed
                flow_value += pushed
                # retreat to the first saturated arc on the path
                for i, a in enumerate(path_arcs):
                    if arc_cap[a] == 0:
                        del stack[i + 1 :]
                        del path_arcs[i:]
                        break
                continue
            advanced = False
            while ptr[u] < indptr[u + 1]:
                a = adj[ptr[u]]
                if arc_cap[a] > 0 and level[arc_head[a]] == level[u] + 1:
                    stack.append(int(arc_head[a]))
                    path_arcs.append(int(a))
                    advanced = True
                    break
                ptr[u] += 1
            if not advanced:
                level[u] = -1  # dead end this phase
                stack.pop()
                if path_arcs:
                    path_arcs.pop()

    sent = caps - arc_cap[0::2]  # flow on each original edge (may be < 0 if reverse used)
    # scipy reports the skew-symmetric flow matrix on the residual structure
    fr = np.concatenate([rows, cols])
    fc = np.concatenate([cols, rows])
    fv = np.concatenate([sent, -sent])
    flow = COO((fv.astype(np.float64), (fr, fc)), shape=(n, n), device=device)
    return MaximumFlowResult(int(flow_value), flow)


def min_weight_full_bipartite_matching(biadjacency, maximized=False):
    """Minimum-weight full bipartite matching (scipy-compatible
    ``(row_ind, col_ind)``, int64 tensors), solved on the host by the dense
    Jonker-Volgenant assignment (``scipy.optimize.linear_sum_assignment``)
    with a dominating sentinel for absent edges; raises when no full
    matching exists. Stored entries are edges with their weight.
    """
    import scipy.optimize

    rows, cols, w, _, device = _graph_triplet(biadjacency, directed=True, square=False)
    n_rows, n_cols = biadjacency.shape
    # linear_sum_assignment rejects inf: shift edge costs non-negative
    # first (every full matching has the same size, so the argmin is
    # unchanged) and mark absent edges with a finite sentinel that then
    # provably dominates any full matching
    wv = -w if maximized else w
    shift = float(wv.min()) if wv.size else 0.0
    wv = wv - min(shift, 0.0)
    span = float(wv.max()) if wv.size else 1.0
    big = (span + 1.0) * (min(n_rows, n_cols) + 1)
    cost = np.full((n_rows, n_cols), big)
    cost[rows, cols] = wv
    r, c = scipy.optimize.linear_sum_assignment(cost)
    present = np.zeros((n_rows, n_cols), dtype=bool)
    present[rows, cols] = True
    if not present[r, c].all():
        raise ValueError("no full matching exists")
    return torch.from_numpy(r.astype(np.int64)).to(device), torch.from_numpy(c.astype(np.int64)).to(device)


def _dijkstra_host(indptr, indices, weights, src, dst, banned_nodes, banned_edges):
    """Single-pair host Dijkstra over CSR arcs with node/edge bans; returns
    ``(dist, path-as-node-list)`` or ``(inf, None)``."""
    import heapq

    n = indptr.shape[0] - 1
    dist = np.full(n, np.inf)
    prev = np.full(n, -1, dtype=np.int64)
    dist[src] = 0.0
    heap = [(0.0, src)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        if u == dst:
            break
        for e in range(int(indptr[u]), int(indptr[u + 1])):
            if e in banned_edges:
                continue
            v = int(indices[e])
            if v in banned_nodes:
                continue
            nd = d + float(weights[e])
            if nd < dist[v]:
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    if not np.isfinite(dist[dst]):
        return np.inf, None
    path = [dst]
    node = dst
    while node != src:
        node = int(prev[node])
        path.append(node)
    return float(dist[dst]), path[::-1]


def yen(csgraph, source, sink, K, *, directed=True, unweighted=False):
    """K shortest loopless paths from ``source`` to ``sink`` (Yen's
    algorithm on the host, scipy-compatible): the float64 tensor of up to
    ``K`` path lengths in nondecreasing order."""
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=directed, unweighted=unweighted)
    source = _canon_index(source, n, "source")
    sink = _canon_index(sink, n, "sink")
    if rows.size and w.min() < 0:
        raise ValueError("yen requires non-negative edge weights")
    order = np.lexsort((w, cols, rows))
    rows_s, cols_s, w_s = rows[order], cols[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows_s + 1, 1)
    np.cumsum(indptr, out=indptr)

    d0, p0 = _dijkstra_host(indptr, cols_s, w_s, source, sink, set(), set())
    if p0 is None:
        return torch.empty(0, dtype=_F, device=device)
    import heapq

    A = [(d0, p0)]
    B: list = []
    seen_paths = {tuple(p0)}
    while len(A) < K:
        prev_path = A[-1][1]
        for j in range(len(prev_path) - 1):
            spur = prev_path[j]
            root = prev_path[: j + 1]
            banned_edges = set()
            for dp, p in A:
                if len(p) > j and p[: j + 1] == root:
                    u, v = p[j], p[j + 1]
                    for e in range(int(indptr[u]), int(indptr[u + 1])):
                        if int(cols_s[e]) == v:
                            banned_edges.add(e)
            banned_nodes = set(root[:-1])
            sd, sp = _dijkstra_host(indptr, cols_s, w_s, spur, sink, banned_nodes, banned_edges)
            if sp is None:
                continue
            root_cost = 0.0
            for a, b in zip(root[:-1], root[1:]):
                best = np.inf
                for e in range(int(indptr[a]), int(indptr[a + 1])):
                    if int(cols_s[e]) == b:
                        best = min(best, float(w_s[e]))
                root_cost += best
            cand = root[:-1] + sp
            tc = tuple(cand)
            if tc not in seen_paths:
                seen_paths.add(tc)
                heapq.heappush(B, (root_cost + sd, cand))
        if not B:
            break
        A.append(heapq.heappop(B))
    return torch.tensor([d for d, _ in A[:K]], dtype=_F).to(device)


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------


def _label_propagation_device(rows, cols, *, n):
    """Min-label propagation to a fixed point: every node takes the smallest
    label among itself and its in-neighbours. On a symmetrized edge list the
    fixed point labels each weakly-connected component by its smallest node
    id. One scatter-min pass and one flag read back a round."""
    labels = torch.arange(n, dtype=_I, device=rows.device)
    changed = True
    while changed:
        best = torch.full((n,), torch.iinfo(_I).max, dtype=_I, device=rows.device)  # segment_min's identity
        best.scatter_reduce_(0, cols, labels[rows], "amin")
        new = torch.minimum(labels, best)
        changed = bool((new < labels).any())
        labels = new
    return labels


def connected_components(csgraph, directed=True, connection="weak", return_labels=True):
    """Connected components, scipy-compatible ``(n_components, labels)``,
    the labels an int32 tensor on the graph's device.

    Weak components run min-label propagation on the device (symmetrized
    edge list). Strong components use the dense boolean transitive closure
    by repeated squaring (O(n²) memory — for small and medium graphs).
    """
    if connection not in ("weak", "strong"):
        raise ValueError("connection must be 'weak' or 'strong'")
    if connection == "strong" and directed:
        labels = _strong_components(csgraph)
    else:
        rows, cols, _, n, device = _graph_triplet(csgraph, directed=False)
        if rows.size == 0:
            labels = torch.arange(n, dtype=_I, device=device)
        else:
            labels = _label_propagation_device(
                torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device), n=n
            )
    # representative = smallest node id in the component, so ascending
    # representative order == first-occurrence order (scipy's labeling)
    _, labels = torch.unique(labels, return_inverse=True)
    n_components = int(labels.max()) + 1 if labels.numel() else 0
    if return_labels:
        return n_components, labels.to(torch.int32)
    return n_components


def _closure_device(rows, cols, *, n, rounds):
    reach = torch.zeros((n, n), dtype=torch.bool, device=rows.device)
    reach[rows, cols] = True
    reach |= torch.eye(n, dtype=torch.bool, device=rows.device)
    with _full_f32_matmul():
        for _ in range(rounds):
            rf = reach.to(torch.float32)
            reach = (rf @ rf) > 0
    return reach


def _strong_components(csgraph):
    rows, cols, _, n, device = _graph_triplet(csgraph, directed=True)
    if n == 0:
        return torch.arange(0, dtype=_I, device=device)
    rounds = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    reach = _closure_device(torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device), n=n, rounds=rounds)
    strong = reach & reach.T
    return torch.argmax(strong.to(torch.uint8), dim=1)  # smallest mutual node id


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------


def _pagerank_inputs(csgraph, personalize):
    """Out-degree-normalized edge weights, dangling mask and teleport vector
    (host NumPy), and the graph's device."""
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=True)
    out_deg = np.zeros(n)
    np.add.at(out_deg, rows, w)
    dangling = out_deg == 0
    with np.errstate(invalid="ignore", divide="ignore"):
        w_norm = np.where(out_deg[rows] > 0, w / out_deg[rows], 0.0)
    tele = np.full(n, 1.0 / n) if personalize is None else np.asarray(_host(personalize), dtype=np.float64)
    tele = tele / tele.sum()
    return rows, cols, w_norm, dangling, tele, n, device


def pagerank(csgraph, *, alpha=0.85, tol=1e-10, maxiter=200, personalize=None):
    """PageRank scores by damped power iteration: ``(scores, iterations)``,
    a float64 tensor on the graph's device and a Python int.

    Each round spreads the mass with ``Wᵀ p`` on K1 (the row-ELL SpMV, over
    the layout of the out-normalized ``Wᵀ``, a COO kept on a COO operand
    with its layout), adds the dangling mass and the teleport, and reads
    back the stop test ``(delta > tol) & (it < maxiter)`` with ``delta``
    the L1 change (networkx's convergence). Not part of scipy.csgraph.
    """
    rows, cols, w_norm, dangling, tele, n, device = _pagerank_inputs(csgraph, personalize)

    def walk():
        # Wᵀ: its row v holds the normalized weights of v's in-edges; the
        # COO adds parallel edges' weights
        coords = torch.from_numpy(np.stack([cols, rows])).to(device)
        return COO(coords, torch.from_numpy(w_norm).to(device), shape=(n, n))

    cached = getattr(csgraph, "_cached_layout", None)
    wt = cached("pagerank_walk", None, walk) if cached is not None else walk()
    layout = wt.to_row_ell()
    return _pagerank_iterate(lambda p: _row_ell.row_ell_spmv(layout, p), dangling, tele, n, device, alpha, tol, maxiter)


def _pagerank_iterate(spread, dangling, tele, n, device, alpha, tol, maxiter):
    """The damped power iteration from the uniform vector: ``spread(p)`` is
    ``Wᵀ p``; the dangling mass and the teleport are added, and the stop
    test ``(delta > tol) & (it < maxiter)`` is read back once a round, with
    ``delta`` the L1 change. Returns ``(p, iterations)``."""
    dj = torch.from_numpy(dangling).to(device)
    tj = torch.from_numpy(tele).to(device)
    p = torch.full((n,), 1.0 / n, dtype=_F, device=device)
    delta = torch.tensor(torch.inf, dtype=_F, device=device)
    it = 0
    while bool((delta > tol) & (it < maxiter)):
        dangling_mass = torch.sum(torch.where(dj, p, 0.0))
        new = alpha * (spread(p) + dangling_mass * tj) + (1.0 - alpha) * tj
        delta = torch.sum(torch.abs(new - p))
        p, it = new, it + 1
    return p, it


def pagerank_partitioned(csgraph, mesh, *, alpha=0.85, tol=1e-10, maxiter=200, personalize=None, axis_name="x"):
    """:func:`pagerank` with the edge list split over the ranks of
    ``mesh``'s axis: ``(scores, iterations)``, the scores on the mesh's
    device.

    The edges are cut into one equal chunk a rank, padded with weight-0
    edges 0 → 0. Each iteration a rank spreads ``p`` over its chunk with
    K1 (``row_ell_spmv`` on the row-ELL layout of the chunk's ``Wᵀ``, built
    once a call as :func:`pagerank` builds the whole graph's), the ranks'
    spreads are gathered and summed in rank order (the same bits at every
    world for one chunking; at a world of one :func:`pagerank`'s), and the
    dangling mass, the teleport and the L1 stop test follow as in
    :func:`pagerank`, one read back an iteration."""
    from .parallel.sharding import _device, _gather, _shard_sum

    rows, cols, w_norm, dangling, tele, n, _ = _pagerank_inputs(csgraph, personalize)
    device = _device(mesh)
    r_c, c_c, w_c = _edge_chunk(mesh, axis_name, (rows, cols, w_norm), (0, 0, 0.0))
    wt = COO(torch.from_numpy(np.stack([c_c, r_c])).to(device), torch.from_numpy(w_c).to(device), shape=(n, n))
    layout = wt.to_row_ell()

    def spread(p):
        return _shard_sum(_gather(_row_ell.row_ell_spmv(layout, p)[None], mesh, axis_name))

    return _pagerank_iterate(spread, dangling, tele, n, device, alpha, tol, maxiter)


# ---------------------------------------------------------------------------
# Laplacian
# ---------------------------------------------------------------------------


def laplacian(csgraph, normed=False, return_diag=False, use_out_degree=False):
    """Graph Laplacian ``L = D - A`` (or the symmetric-normalized form), as
    a COO on the graph's device (and the diagonal as a tensor).

    Matches scipy: the input diagonal is ignored, degrees count the
    remaining entries (in-degree by default, out-degree with
    ``use_out_degree``), and isolated nodes get degree 1 in the normalized
    form.
    """
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=True)
    off = rows != cols
    rows, cols, w = rows[off], cols[off], w[off]
    deg = np.zeros(n)
    np.add.at(deg, rows if use_out_degree else cols, w)
    if normed:
        isolated = deg == 0
        dsqrt = np.sqrt(np.where(isolated, 1.0, deg))
        off_data = -w / (dsqrt[rows] * dsqrt[cols])
        diag_data = np.where(isolated, 0.0, 1.0)
        # scipy returns the sqrt-degree scaling vector (isolated nodes -> 1)
        diag_out = dsqrt
    else:
        off_data = -w
        diag_data = deg
        diag_out = deg
    all_rows = np.concatenate([rows, np.arange(n)])
    all_cols = np.concatenate([cols, np.arange(n)])
    all_data = np.concatenate([off_data, diag_data])
    lap = COO(np.stack([all_rows, all_cols]), all_data, shape=(n, n), prune=True, device=device)
    if return_diag:
        return lap, torch.from_numpy(diag_out).to(device)
    return lap


# ---------------------------------------------------------------------------
# minimum spanning tree (Borůvka, vectorized host rounds)
# ---------------------------------------------------------------------------


def minimum_spanning_tree(csgraph, overwrite=False):
    """Minimum spanning forest via Borůvka's algorithm on the host.

    Each round every component picks its lightest outgoing edge (one
    vectorized ``minimum.at`` per side) and components merge by hooking +
    pointer jumping; ≤ log₂(n) rounds. Returns the forest as an
    upper-triangular COO on the graph's device (``tree[min(u,v), max(u,v)]
    = w``), matching scipy's nnz and total weight.
    """
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=False)
    # undirected: each edge appears both ways; keep one canonical copy
    keep = rows < cols
    u, v, w = rows[keep], cols[keep], w[keep]
    # dedupe parallel edges keeping the lightest (sort by weight, first wins)
    order = np.lexsort((w, v, u))
    u, v, w = u[order], v[order], w[order]
    first = np.ones(u.size, dtype=bool)
    if u.size:
        first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    u, v, w = u[first], v[first], w[first]

    m = u.size
    # rank: index into the weight-sorted edge list — integer minimum over
    # ranks == lexicographic (weight, tiebreak) minimum over edges
    rank_order = np.argsort(w, kind="stable")
    rank = np.empty(m, dtype=np.int64)
    rank[rank_order] = np.arange(m)

    comp = np.arange(n, dtype=np.int64)
    chosen = np.zeros(m, dtype=bool)
    while True:
        cu, cv = comp[u], comp[v]
        cross = cu != cv
        if not np.any(cross):
            break
        best = np.full(n, m, dtype=np.int64)
        np.minimum.at(best, cu[cross], rank[cross])
        np.minimum.at(best, cv[cross], rank[cross])
        sel = rank_order[np.unique(best[best < m])]
        chosen[sel] = True
        # hook: the larger component root points at the smaller
        a, b = comp[u[sel]], comp[v[sel]]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        parent = np.arange(n, dtype=np.int64)
        # multiple hooks may target one root; keep the smallest destination
        np.minimum.at(parent, hi, lo)
        # pointer jumping to full compression
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
        comp = parent[comp]

    tu, tv, tw = u[chosen], v[chosen], w[chosen]
    return COO(np.stack([tu, tv]), tw, shape=(n, n), device=device)


# ---------------------------------------------------------------------------
# graph construction / representation helpers (scipy.sparse.csgraph
# parity; host NumPy)
# ---------------------------------------------------------------------------


def _null_mask(a, null_value, nan_null, infinity_null):
    null = np.zeros(a.shape, dtype=bool)
    if null_value is not None:
        if np.isnan(null_value):
            null |= np.isnan(a)
        elif np.isinf(null_value):
            null |= np.isinf(a) & (np.sign(a) == np.sign(null_value))
        else:
            null |= a == null_value
    if nan_null:
        null |= np.isnan(a)
    if infinity_null:
        null |= np.isinf(a)
    return null


def csgraph_from_dense(graph, null_value=0, nan_null=True, infinity_null=True):
    """Dense adjacency matrix -> sparse graph (COO on the input tensor's
    device, or the GPU).

    Entries equal to ``null_value`` (and NaN / infinities per the flags)
    are non-edges; everything else — including explicit zeros when
    ``null_value`` is not 0 — is a stored edge. Mirrors
    ``scipy.sparse.csgraph.csgraph_from_dense``.
    """
    device = graph.device if isinstance(graph, torch.Tensor) else None
    a = np.asarray(_host(graph), dtype=np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise _square_error(a.shape)
    keep = ~_null_mask(a, null_value, nan_null, infinity_null)
    rows, cols = np.nonzero(keep)
    return COO(np.stack([rows, cols]), a[rows, cols], shape=a.shape, device=resolve_device(device))


def csgraph_from_masked(graph):
    """Masked dense adjacency matrix (``numpy.ma``) -> sparse graph (COO on
    the GPU); masked entries are non-edges, unmasked zeros are stored
    edges."""
    a = np.ma.asarray(graph)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise _square_error(a.shape)
    keep = ~np.ma.getmaskarray(a)
    rows, cols = np.nonzero(keep)
    data = np.asarray(a.data, dtype=np.float64)[rows, cols]
    return COO(np.stack([rows, cols]), data, shape=a.shape, device=resolve_device(None))


def csgraph_masked_from_dense(graph, null_value=0, nan_null=True, infinity_null=True, copy=True):
    """Dense adjacency matrix -> ``np.ma.MaskedArray`` with non-edges masked."""
    a = np.array(_host(graph), dtype=np.float64, copy=copy)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise _square_error(a.shape)
    return np.ma.masked_array(a, mask=_null_mask(a, null_value, nan_null, infinity_null))


def _dense_min(rows, cols, w, n, fill):
    """``(n, n)`` host array of ``fill`` holding each edge's lightest weight."""
    out = np.full((n, n), np.float64(fill))
    # duplicates -> min: sort descending by weight so the smallest lands last
    order = np.lexsort((-w,))
    out[rows[order], cols[order]] = w[order]
    return out


def csgraph_to_dense(csgraph, null_value=0):
    """Sparse graph -> dense adjacency tensor on the graph's device, with
    non-edges set to ``null_value`` (stored zero-weight edges stay 0).
    Duplicate edges collapse to the minimum weight, like scipy."""
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=True)
    return torch.from_numpy(_dense_min(rows, cols, w, n, null_value)).to(device)


def csgraph_to_masked(csgraph):
    """Sparse graph -> ``np.ma.MaskedArray`` with non-edges masked."""
    rows, cols, w, n, _ = _graph_triplet(csgraph, directed=True)
    mask = np.ones((n, n), dtype=bool)
    mask[rows, cols] = False
    return np.ma.masked_array(_dense_min(rows, cols, w, n, 0.0), mask=mask)


def _edge_weights(rows, cols, w, n, q_rows, q_cols, *, directed):
    """Vectorized weight lookup ``G[q_rows, q_cols]`` over the edge triplet;
    missing edges -> +inf. Undirected: min over the two stored directions."""
    key = rows * n + cols
    # duplicates keep the min weight: sort (key asc, weight asc) so the
    # side="left" searchsorted hit is the group's minimum
    order = np.lexsort((w, key))
    skey, sw = key[order], w[order]
    first = np.searchsorted(skey, q_rows * n + q_cols, side="left")
    first_c = np.minimum(first, max(skey.size - 1, 0))
    if skey.size == 0:
        found = np.zeros(q_rows.shape, dtype=bool)
    else:
        found = (first < skey.size) & (skey[first_c] == q_rows * n + q_cols)
    vals = np.where(found, sw[first_c] if skey.size else 0.0, np.inf)
    if not directed:
        rev = _edge_weights(rows, cols, w, n, q_cols, q_rows, directed=True)
        vals = np.minimum(vals, rev)
    return vals


def reconstruct_path(csgraph, predecessors, directed=True):
    """Tree of the edges ``(predecessors[j], j)`` with weights taken from
    ``csgraph``, as a COO on the graph's device — scipy's
    ``reconstruct_path``."""
    rows, cols, w, n, device = _graph_triplet(csgraph, directed=True)
    pred = _host(predecessors)
    if pred.shape != (n,):
        raise ValueError(f"predecessors must have shape ({n},), got {pred.shape}")
    j = np.nonzero(pred >= 0)[0]
    p = pred[j].astype(np.int64)
    data = _edge_weights(rows, cols, w, n, p, j, directed=directed)
    data = np.where(np.isinf(data), 0.0, data)
    return COO(np.stack([p, j]), data, shape=(n, n), device=device)


def construct_dist_matrix(graph, predecessors, directed=True, null_value=np.inf):
    """Distance matrix from a full ``(n, n)`` predecessor matrix, a tensor
    on the graph's device: entry ``(i, j)`` sums the edge weights along the
    predecessor path from ``i`` to ``j`` (``null_value`` where no path
    exists, 0 on the diagonal). Path sums run by pointer doubling on the
    host."""
    rows, cols, w, n, device = _graph_triplet(graph, directed=True)
    pred = _host(predecessors)
    if pred.shape != (n, n):
        raise ValueError(f"predecessors must have shape ({n}, {n}), got {pred.shape}")

    idx = np.arange(n)
    valid = pred >= 0
    p = np.where(valid, pred, idx[None, :]).astype(np.int64)
    # edge weight into j from its predecessor (0 at roots/self-loops)
    e = np.where(
        valid,
        _edge_weights(rows, cols, w, n, p.ravel(), np.tile(idx, n), directed=directed).reshape(n, n),
        0.0,
    )
    # pointer doubling to the root of each predecessor tree, accumulating
    # path weight; roots self-loop with weight 0 so both converge
    jump, acc = p, e
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)):
        ri = idx[:, None]
        acc = acc + acc[ri, jump]
        jump = jump[ri, jump]
    dist = np.where(jump == idx[:, None], acc, np.float64(null_value))
    np.fill_diagonal(dist, 0.0)
    return torch.from_numpy(dist).to(device)
