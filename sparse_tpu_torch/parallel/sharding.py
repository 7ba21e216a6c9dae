"""Multi-device execution on ``torch.distributed``: row-block partitioned
sparse operands and the collective products of ``sparse_tpu.parallel``.

The functions, their parameters and their results are
``sparse_tpu.parallel.sharding``'s; the machinery is PyTorch's:

- A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`, one device
  a rank: 1-D and named ``axis_name`` (:func:`make_mesh`), or 2-D
  ``("x", "y")`` for :func:`spmm_2d`/:func:`spmm_2d_ell`. NCCL serves the
  GPU; gloo serves the CPU, where a caller asks for it with
  ``device="cpu"``. The caller starts the process group.
- A sharded array is a ``DTensor`` sharded on its leading axis over the
  mesh axis (``Shard(0)``, the counterpart of ``P(axis, ...)``): the
  partitioners place their leaves so when given a mesh. Every function
  also takes the global array (a tensor or a NumPy array, the same on every
  rank) and keeps the rank's part of it.
- ``n_shards`` is a multiple of the mesh axis's size. Each rank takes
  ``n_shards / size`` consecutive shards, as ``P(axis)`` splits the leading
  axis; a world of one holds every shard. A rank runs one call of the
  port's function a shard, in shard order.
- ``shard_map``'s output specs are an ``all_gather``: every function
  returns the global result, a plain tensor on the mesh's device, on every
  rank. ``ppermute`` is ``batch_isend_irecv`` (a rank's pair with itself is
  a local copy: gloo refuses a send to self). ``psum`` is an ``all_gather``
  of the shards' partials summed in shard order, so the result has the same
  bits at every world size.

What a shard runs is the port's counterpart of what the reference's shard
runs; DTensor's operators do none of the arithmetic:

| reference, a shard | here, a shard |
|---|---|
| ``ell_mttkrp`` (``mttkrp_sharded_ell``) | ``kernels.ell.ell_mttkrp``: E2's ``mttkrp_kernel`` on the GPU |
| ``segment_sum`` MTTKRP (``mttkrp_sharded``) | ``kernels.dot.mttkrp``: K3 on the GPU, after a stable sort by row (the zero padding sits at the shard's end) |
| gather and sum (``sddmm_sharded``) | ``kernels.dot.sddmm``: K4 on the GPU |
| ``esc_spgemm`` | ``kernels.spgemm.esc_spgemm`` (torch ops) |
| ``coo_elemwise_union`` | ``kernels.elemwise.coo_elemwise_union`` (torch ops) |
| ``ell_spmm`` | ``kernels.ell.ell_spmm`` (torch ops) |
| ``segment_sum`` SpMM | ``kernels.dot.coo_spmm`` (torch ops) |

The partitioners are host NumPy, array for array the reference's (int32
rows and columns); their leaves are CPU tensors without a mesh.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from .._utils import _sample_without_replacement, result_dtype, torch_dtype
from ..kernels.dot import coo_spmm, mttkrp, sddmm
from ..kernels.elemwise import coo_elemwise_union
from ..kernels.ell import DEFAULT_BLOCK_ROWS, _block_ell_arrays, ell_mttkrp, ell_spmm
from ..kernels.spgemm import esc_spgemm, product_count


def make_mesh(n_devices=None, axis_name="x", devices=None, *, device=None):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over the ranks ``devices``
    (default: the ranks of the default process group, in order), cut to the
    first ``n_devices``.

    ``device`` is the ranks' device type: ``None`` means the GPU (a NCCL
    group), and raises without one; ``"cpu"`` asks for the CPU (a gloo
    group). The caller starts the default process group first
    (``torch.distributed.init_process_group``). Unlike the reference, which
    falls back to the host's CPU devices, a world with fewer ranks than
    asked raises ``ValueError``."""
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('make_mesh places the mesh on the GPU by default, but no CUDA device is available; pass device="cpu"')
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh takes a cuda or cpu device, not {device!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed's default process group: call "
            "torch.distributed.init_process_group (nccl on GPUs, gloo on the CPU) first"
        )
    backend = str(dist.get_backend())
    want = "nccl" if device_type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a {device_type} mesh needs a {want} process group, not {backend!r}")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if n_devices is None:
        n_devices = len(ranks)
    if len(ranks) < n_devices:
        raise ValueError(f"requested {n_devices} ranks, only {len(ranks)} in the world")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.tensor(ranks[:n_devices]), mesh_dim_names=(axis_name,))


@dataclasses.dataclass(eq=False)
class PartitionedCOO:
    """A 2-D COO matrix row-block partitioned over a mesh axis.

    ``rows``/``cols``/``data`` ``(n_shards, cap)``: CPU tensors, or DTensors
    sharded on their leading axis when placed on a mesh. ``rows`` are local
    (relative to the shard's first row), ``cols`` global; padding entries
    have row 0, column 0 and ``data == 0``. ``row_starts`` (int64, an
    nnz-balanced partition's first row of each shard) is ``None`` for
    even row blocks."""

    rows: torch.Tensor
    cols: torch.Tensor
    data: torch.Tensor
    shape: tuple
    block_rows: int
    row_starts: np.ndarray | None = None

    @property
    def n_shards(self):
        return self.rows.shape[0]


# ---------------------------------------------------------------------------
# placement and collectives
# ---------------------------------------------------------------------------


def _is_dtensor(t):
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _host(a):
    """The global array ``a`` as a NumPy array (a DTensor is gathered)."""
    if _is_dtensor(a):
        a = a.full_tensor()
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tensor(a, device=None):
    """``a`` (a NumPy array or a tensor) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # JAX's buffers; torch takes writable memory only
        a = a.copy()
    return torch.as_tensor(a, dtype=torch_dtype(a.dtype), device=device)


def _mesh_dim(mesh, axis_name):
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r}; its axes are {names}")
    return names.index(axis_name)


def _device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _span(mesh, axis_name, n):
    """The rank's ``[lo, hi)`` of ``n`` leading entries split over the axis."""
    dim = _mesh_dim(mesh, axis_name)
    size = mesh.size(dim)
    if n % size:
        raise ValueError(f"{n} shards (or columns) do not split over the {size} ranks of mesh axis {axis_name!r}")
    k = n // size
    coord = mesh.get_local_rank(dim)
    return coord * k, (coord + 1) * k


def _placements(mesh, axis_name, dim=0):
    from torch.distributed.tensor import Replicate, Shard

    on = _mesh_dim(mesh, axis_name)
    return [Shard(dim) if i == on else Replicate() for i in range(mesh.ndim)]


def _local(a, mesh, axis_name, dim=0):
    """The rank's part of ``a`` split along ``dim`` over ``axis_name``, on the
    mesh's device: a DTensor's local shard (redistributed first where it is
    placed otherwise), or the rank's slice of a global array."""
    if _is_dtensor(a):
        if a.device_mesh != mesh:
            raise ValueError("a DTensor operand must lie on the mesh it is computed on")
        return a.redistribute(mesh, _placements(mesh, axis_name, dim)).to_local()
    lo, hi = _span(mesh, axis_name, a.shape[dim])
    index = (slice(None),) * dim + (slice(lo, hi),)
    return _tensor(a[index], _device(mesh))


def _replicated(a, mesh):
    """The whole of ``a`` on the mesh's device."""
    if _is_dtensor(a):
        return a.full_tensor()
    return _tensor(a, _device(mesh))


def _place(arrays, mesh, axis_name):
    """Host arrays as CPU tensors, or as DTensors sharded on their leading
    axis over ``axis_name`` of ``mesh``."""
    if mesh is None:
        return [_tensor(a) for a in arrays]
    from torch.distributed.tensor import DTensor

    # n_shards splits evenly over the axis, so the local shards give the global shape
    return [DTensor.from_local(_local(a, mesh, axis_name), mesh, _placements(mesh, axis_name), run_check=False) for a in arrays]


def _gather(local, mesh, axis_name, dim=0):
    """Every rank's ``local`` along ``axis_name``, concatenated along ``dim``
    in rank order (the all_gather that stands for a sharded output spec)."""
    group = mesh.get_group(_mesh_dim(mesh, axis_name))
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim)


def _rotate(block, mesh, axis_name):
    """``ppermute`` by one step down the ring: each rank sends ``block`` to
    its predecessor and receives its successor's. A ring of one keeps its
    own block (the pair is a local copy)."""
    dim = _mesh_dim(mesh, axis_name)
    size = mesh.size(dim)
    if size == 1:
        return block
    group = mesh.get_group(dim)
    coord = mesh.get_local_rank(dim)
    dst = dist.get_global_rank(group, (coord - 1) % size)
    src = dist.get_global_rank(group, (coord + 1) % size)
    block = block.contiguous()
    received = torch.empty_like(block)
    ops = [dist.P2POp(dist.isend, block, dst, group), dist.P2POp(dist.irecv, received, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return received


def _shard_sum(parts):
    """``parts`` summed over the leading (shard) axis in shard order."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


# ---------------------------------------------------------------------------
# partitioners (host NumPy)
# ---------------------------------------------------------------------------


def _coo_host(coo):
    from ..core.coo import COO

    if not isinstance(coo, COO):
        coo = coo.asformat("coo")
    return coo, _host(coo.coords), _host(coo.data)


def partition_coo_rows(coo, n_shards, mesh=None, axis_name="x", balance="rows"):
    """Partition a 2-D COO array into ``n_shards`` row blocks.

    ``balance="rows"`` splits the row space evenly. ``balance="nnz"`` picks
    row boundaries that equalize stored entries per shard; shards then cover
    unequal row ranges, all padded to a common ``block_rows``, and local row
    ids are relative to each shard's own start (``row_starts``).

    Each shard's nnz is padded to the global max. Returns a
    :class:`PartitionedCOO`; with ``mesh``, its leaves are DTensors sharded
    on their leading axis over ``axis_name``, else CPU tensors."""
    coo, coords, data = _coo_host(coo)
    if coo.ndim != 2:
        raise ValueError("partition_coo_rows requires a 2-D array")
    M, K = coo.shape
    rows = coords[0].astype(np.int64)
    cols = coords[1].astype(np.int64)

    row_starts = None
    if balance == "nnz" and rows.size:
        # boundaries at equal-nnz quantiles of the (sorted) row stream,
        # snapped to row edges
        targets = (np.arange(1, n_shards) * rows.size) // n_shards
        boundary_rows = np.minimum(rows[targets] + 1, M)
        row_starts = np.concatenate([[0], np.sort(boundary_rows)]).astype(np.int64)
        shard_of = np.searchsorted(row_starts, rows, side="right") - 1
        extents = np.diff(np.concatenate([row_starts, [M]]))
        block_rows = max(int(extents.max()), 1)
        starts = row_starts
    else:
        block_rows = -(-M // n_shards)
        shard_of = rows // block_rows
        starts = np.arange(n_shards, dtype=np.int64) * block_rows
    counts = np.bincount(shard_of, minlength=n_shards)
    cap = max(int(counts.max()), 1)
    out_rows = np.zeros((n_shards, cap), dtype=np.int32)
    out_cols = np.zeros((n_shards, cap), dtype=np.int32)
    out_data = np.zeros((n_shards, cap), dtype=data.dtype)
    for s in range(n_shards):
        sel = shard_of == s
        k = int(counts[s])
        out_rows[s, :k] = (rows[sel] - starts[s]).astype(np.int32)
        out_cols[s, :k] = cols[sel].astype(np.int32)
        out_data[s, :k] = data[sel]
    r, c, d = _place((out_rows, out_cols, out_data), mesh, axis_name)
    return PartitionedCOO(r, c, d, (M, K), block_rows, row_starts)


def random_partitioned(
    shape,
    density=None,
    *,
    nnz=None,
    n_shards,
    mesh=None,
    axis_name="x",
    random_state=None,
    data_rvs=None,
    dtype=np.float64,
):
    """A random row-block-partitioned 2-D COO generated shard by shard (the
    global triplet is never formed), with ``sparse_tpu``'s draws for the
    same ``random_state``: ``nnz = round(density * M * K)`` cells uniform
    without replacement, split over the row blocks by a multivariate
    hypergeometric, then sampled inside each block."""
    M, K = shape
    elements = M * K
    if density is not None and nnz is not None:
        raise ValueError("'density' and 'nnz' are mutually exclusive")
    if density is None and nnz is None:
        density = 0.01
    if nnz is None:
        nnz = int(round(elements * density))
    if not (0 <= nnz <= elements):
        raise ValueError(f"cannot generate {nnz} samples from {elements} elements")
    rng = random_state if isinstance(random_state, np.random.Generator) else np.random.default_rng(random_state)

    block_rows = -(-M // n_shards)
    extents = np.minimum(block_rows, M - block_rows * np.arange(n_shards)).clip(min=0)
    cells = (extents * K).astype(np.int64)
    counts = rng.multivariate_hypergeometric(cells, nnz) if nnz else np.zeros(n_shards, dtype=np.int64)
    cap = max(int(counts.max()), 1)

    out_rows = np.zeros((n_shards, cap), dtype=np.int32)
    out_cols = np.zeros((n_shards, cap), dtype=np.int32)
    out_data = np.zeros((n_shards, cap), dtype=dtype)
    for s in range(n_shards):
        k = int(counts[s])
        if not k:
            continue
        lin = _sample_without_replacement(rng, int(cells[s]), k)
        out_rows[s, :k] = (lin // K).astype(np.int32)
        out_cols[s, :k] = (lin % K).astype(np.int32)
        out_data[s, :k] = (data_rvs(k) if data_rvs is not None else rng.random(k)).astype(dtype, copy=False)
    r, c, d = _place((out_rows, out_cols, out_data), mesh, axis_name)
    return PartitionedCOO(r, c, d, (M, K), block_rows)


def bucket_columns(pcoo, n_buckets):
    """Re-bucket a PartitionedCOO's entries by column block, padding each
    (shard, bucket) to a common capacity: the layout :func:`spmm_ring`
    consumes. Returns ``(rows, cols, data, block_cols)``, the three
    ``(n_shards, n_buckets, bcap)`` CPU tensors with columns local to their
    bucket; the zero padding is dropped."""
    n_shards, _ = pcoo.rows.shape
    K = pcoo.shape[1]
    block_cols = -(-K // n_buckets)
    rows, cols, data = _host(pcoo.rows), _host(pcoo.cols), _host(pcoo.data)

    bucket_of = cols // block_cols
    caps = np.zeros((n_shards, n_buckets), dtype=np.int64)
    for s in range(n_shards):
        caps[s] = np.bincount(bucket_of[s][data[s] != 0], minlength=n_buckets)
    bcap = max(int(caps.max()), 1)

    out_rows = np.zeros((n_shards, n_buckets, bcap), dtype=np.int32)
    out_cols = np.zeros((n_shards, n_buckets, bcap), dtype=np.int32)
    out_data = np.zeros((n_shards, n_buckets, bcap), dtype=data.dtype)
    for s in range(n_shards):
        for b in range(n_buckets):
            sel = (bucket_of[s] == b) & (data[s] != 0)
            k = int(sel.sum())
            out_rows[s, b, :k] = rows[s][sel]
            out_cols[s, b, :k] = cols[s][sel] - b * block_cols
            out_data[s, b, :k] = data[s][sel]
    return (*_place((out_rows, out_cols, out_data), None, None), block_cols)


def _padded_stack(parts, n_shards, dtype):
    """``(n_shards, n_blocks, cap)``: each shard's ``(n_blocks, w)`` array
    zero-padded to the widest."""
    cap = max(max(p.shape[1] for p in parts), 1)
    out = np.zeros((n_shards, parts[0].shape[0], cap), dtype=dtype)
    for s, p in enumerate(parts):
        out[s, :, : p.shape[1]] = p
    return out


def bucket_columns_ell(coo, n_shards, n_buckets=None, block_rows_ell=128):
    """Host partitioner for :func:`spmm_ring_ell`: row shards, each bucketed
    by column block, every (shard, bucket) in block-ELL form over the
    shard's local 128-row blocks (one capacity). Returns ``(e_rows, e_cols,
    e_data, block_rows, block_cols)``, the arrays ``(n_shards, n_buckets,
    n_blocks, cap)`` CPU tensors, ``e_cols`` local to the bucket."""
    if n_buckets is None:
        n_buckets = n_shards
    coo, coords, data = _coo_host(coo)
    n_rows, n_cols = coo.shape
    block_rows = -(-n_rows // n_shards)
    block_rows = -(-block_rows // block_rows_ell) * block_rows_ell
    block_cols = -(-n_cols // n_buckets)
    shard_of = np.minimum(coords[0] // block_rows, n_shards - 1)
    bucket_of = np.minimum(coords[1] // block_cols, n_buckets - 1)
    parts = {}
    for s in range(n_shards):
        for b in range(n_buckets):
            sel = (shard_of == s) & (bucket_of == b)
            parts[s, b] = _block_ell_arrays(
                coords[0][sel] - s * block_rows, [coords[1][sel] - b * block_cols], data[sel], block_rows, block_rows_ell, 8
            )
    cap = max(max(p[0].shape[1] for p in parts.values()), 1)
    nb = block_rows // block_rows_ell
    e_rows = np.zeros((n_shards, n_buckets, nb, cap), dtype=np.int32)
    e_cols = np.zeros((n_shards, n_buckets, nb, cap), dtype=np.int32)
    e_data = np.zeros((n_shards, n_buckets, nb, cap), dtype=data.dtype)
    for (s, b), (r, (c,), d) in parts.items():
        w = c.shape[1]
        e_rows[s, b, :, :w] = r
        e_cols[s, b, :, :w] = c
        e_data[s, b, :, :w] = d
    return (*_place((e_rows, e_cols, e_data), None, None), block_rows, block_cols)


def partition_spmm_ell(coo, n_shards, block_rows_ell=128):
    """Host partitioner for :func:`spmm_sharded_ell`: row shards, each in
    block-ELL form (local 128-row blocks, one capacity). Returns ``(e_rows,
    e_cols, e_data, block_rows)``, the arrays ``(n_shards, n_blocks, cap)``
    CPU tensors."""
    coo, coords, data = _coo_host(coo)
    n_rows = coo.shape[0]
    block_rows = -(-n_rows // n_shards)
    block_rows = -(-block_rows // block_rows_ell) * block_rows_ell
    shard_of = np.minimum(coords[0] // block_rows, n_shards - 1)
    parts = []
    for s in range(n_shards):
        sel = shard_of == s
        parts.append(
            _block_ell_arrays(coords[0][sel] - s * block_rows, [coords[1][sel]], data[sel], block_rows, block_rows_ell, 8)
        )
    e_rows = _padded_stack([p[0] for p in parts], n_shards, np.int32)
    e_cols = _padded_stack([p[1][0] for p in parts], n_shards, np.int32)
    e_data = _padded_stack([p[2] for p in parts], n_shards, data.dtype)
    return (*_place((e_rows, e_cols, e_data), None, None), block_rows)


def partition_mttkrp_ell(coords, data, n_rows, n_shards, block_rows_ell=128):
    """Host partitioner for :func:`mttkrp_sharded_ell`: i-partition a 3-D
    COO tensor (``coords`` ``(3, nnz)``) into row-block shards, each in
    block-ELL form (local 128-row blocks, one capacity). Returns ``(e_rows,
    e_j, e_k, e_data, block_rows)``, the arrays ``(n_shards, n_blocks,
    cap)`` CPU tensors."""
    coords = _host(coords)
    data = _host(data)
    block_rows = -(-n_rows // n_shards)
    block_rows = -(-block_rows // block_rows_ell) * block_rows_ell
    shard_of = np.minimum(coords[0] // block_rows, n_shards - 1)
    parts = []
    for s in range(n_shards):
        sel = shard_of == s
        parts.append(
            _block_ell_arrays(
                coords[0][sel] - s * block_rows, [coords[1][sel], coords[2][sel]], data[sel], block_rows, block_rows_ell, 8
            )
        )
    e_rows = _padded_stack([p[0] for p in parts], n_shards, np.int32)
    e_j = _padded_stack([p[1][0] for p in parts], n_shards, np.int32)
    e_k = _padded_stack([p[1][1] for p in parts], n_shards, np.int32)
    e_data = _padded_stack([p[2] for p in parts], n_shards, data.dtype)
    return (*_place((e_rows, e_j, e_k, e_data), None, None), block_rows)


# ---------------------------------------------------------------------------
# sharded products
# ---------------------------------------------------------------------------


def _locals(mesh, axis_name, *arrays):
    return [_local(a, mesh, axis_name) for a in arrays]


def _shard_start(pcoo, s):
    """The first global row of shard ``s``."""
    return int(pcoo.row_starts[s]) if pcoo.row_starts is not None else s * pcoo.block_rows


def _stitch(out, n_rows, block_rows, row_starts):
    """``(n_shards, block_rows, ...)`` shard outputs → the ``n_rows`` global
    rows: each nnz-balanced shard's valid prefix, or the even blocks cut."""
    if row_starts is not None:
        extents = np.diff(np.concatenate([row_starts, [n_rows]]))
        return torch.cat([out[s, : int(e)] for s, e in enumerate(extents)], 0)
    return out.reshape(out.shape[0] * block_rows, *out.shape[2:])[:n_rows]


def _coo_products(rows, cols, data, dense, n_rows):
    """``coo_spmm`` of each shard (leading axis) in the promoted dtype."""
    dt = result_dtype(data.dtype, dense.dtype)
    dense = dense.to(dt)
    return torch.stack([coo_spmm(r, c, d.to(dt), dense, n_rows=n_rows) for r, c, d in zip(rows, cols, data)])


def spmm_replicated(pcoo, dense, mesh, axis_name="x"):
    """Sharded SpMM with ``dense`` replicated on every rank: each rank's row
    shards times ``dense``, gathered; ``(M, N)``."""
    rows, cols, data = _locals(mesh, axis_name, pcoo.rows, pcoo.cols, pcoo.data)
    b = _replicated(dense, mesh)
    out = _gather(_coo_products(rows, cols, data, b, pcoo.block_rows), mesh, axis_name)
    return _stitch(out, pcoo.shape[0], pcoo.block_rows, pcoo.row_starts)


def _ring_chunk(n_buckets, block_cols, chunk, mesh, axis_name):
    """The buckets of a rank's resident dense chunk, checked against the ring."""
    size = mesh.size(_mesh_dim(mesh, axis_name))
    if n_buckets % size:
        raise ValueError(f"{n_buckets} buckets do not split over a ring of {size} ranks")
    per_rank = n_buckets // size
    if chunk.shape[0] != per_rank * block_cols:
        raise ValueError(
            f"the rank's dense block has {chunk.shape[0]} rows, not {per_rank} buckets of {block_cols} "
            f"(dense_sharded must hold n_buckets * block_cols rows)"
        )
    return size, per_rank


def _ring(local_buckets, chunk, block_cols, mesh, axis_name, product, acc):
    """The ring schedule: ``acc[s] += product(shard s's bucket b, dense of
    bucket b)`` for every local shard and bucket, the dense chunks rotating
    down the ring (after ``i`` steps a rank holds chunk ``rank + i``)."""
    n_buckets = local_buckets[0].shape[1]
    size, per_rank = _ring_chunk(n_buckets, block_cols, chunk, mesh, axis_name)
    coord = mesh.get_local_rank(_mesh_dim(mesh, axis_name))
    for i in range(size):
        first = ((coord + i) % size) * per_rank
        for j in range(per_rank):
            blk = chunk[j * block_cols : (j + 1) * block_cols]
            for s in range(acc.shape[0]):
                acc[s] += product(*(a[s, first + j] for a in local_buckets), blk)
        if i < size - 1:
            chunk = _rotate(chunk, mesh, axis_name)
    return acc


def spmm_ring(bucketed, pcoo_shape, block_rows, dense_sharded, mesh, axis_name="x"):
    """Ring SpMM: ``dense_sharded`` (``n_buckets * block_cols`` rows) split
    into one chunk a rank; each step contracts the local column buckets that
    match the resident chunk, then passes the chunk down the ring. ``(M,
    N)``. ``bucketed`` from :func:`bucket_columns`."""
    out_rows, out_cols, out_data, block_cols = bucketed
    rows, cols, data = _locals(mesh, axis_name, out_rows, out_cols, out_data)
    chunk = _local(dense_sharded, mesh, axis_name)
    dt = result_dtype(data.dtype, chunk.dtype)
    acc = torch.zeros((rows.shape[0], block_rows, chunk.shape[-1]), dtype=dt, device=chunk.device)

    def product(r, c, d, blk):
        return coo_spmm(r, c, d.to(dt), blk.to(dt), n_rows=block_rows)

    acc = _ring((rows, cols, data), chunk, block_cols, mesh, axis_name, product, acc)
    return _gather(acc, mesh, axis_name).reshape(-1, chunk.shape[-1])[: pcoo_shape[0]]


def spmm_ring_ell(bucketed, n_rows, dense_sharded, mesh, axis_name="x"):
    """Ring SpMM with ``ell_spmm`` a bucket: the block-ELL form of
    :func:`spmm_ring`. ``bucketed`` from :func:`bucket_columns_ell` with as
    many buckets as shards, a multiple of the ring's size; ``dense_sharded``
    padded to ``n_buckets * block_cols`` rows."""
    e_rows, e_cols, e_data, block_rows, block_cols = bucketed
    n_shards, n_buckets = e_rows.shape[:2]
    size = mesh.size(_mesh_dim(mesh, axis_name))
    # a bucket count that differs from the shard count would pair shards with
    # the wrong dense blocks
    if n_buckets != n_shards or n_shards % size:
        raise ValueError(
            f"spmm_ring_ell needs n_buckets == n_shards, a multiple of the mesh axis size; "
            f"got n_buckets={n_buckets}, n_shards={n_shards}, |{axis_name}|={size}"
        )
    er, ec, ed = _locals(mesh, axis_name, e_rows, e_cols, e_data)
    chunk = _local(dense_sharded, mesh, axis_name)
    dt = result_dtype(ed.dtype, chunk.dtype)
    acc = torch.zeros((er.shape[0], block_rows, chunk.shape[-1]), dtype=dt, device=chunk.device)

    def product(r, c, d, blk):
        return ell_spmm(r, c, d, blk, n_rows=block_rows, block_rows=DEFAULT_BLOCK_ROWS)

    acc = _ring((er, ec, ed), chunk, block_cols, mesh, axis_name, product, acc)
    return _gather(acc, mesh, axis_name).reshape(-1, chunk.shape[-1])[:n_rows]


def _gather_2d(out, mesh, row_axis, col_axis):
    """``(k, rows, n/ny)`` pieces of a ``P(row_axis, None, col_axis)`` output
    → the global ``(n_shards, rows, n)``."""
    return _gather(_gather(out, mesh, col_axis, dim=2), mesh, row_axis, dim=0)


def spmm_2d(pcoo, dense, mesh, row_axis="x", col_axis="y"):
    """SpMM over a 2-D mesh: the sparse row shards split over ``row_axis``,
    ``dense``'s columns over ``col_axis``; each rank contracts its row
    shards with its column slice, no collective but the output's gather."""
    rows, cols, data = _locals(mesh, row_axis, pcoo.rows, pcoo.cols, pcoo.data)
    b = _local(dense, mesh, col_axis, dim=1)
    out = _gather_2d(_coo_products(rows, cols, data, b, pcoo.block_rows), mesh, row_axis, col_axis)
    return _stitch(out, pcoo.shape[0], pcoo.block_rows, pcoo.row_starts)


def _ell_products(er, ec, ed, dense):
    return torch.stack([ell_spmm(r, c, v, dense, n_rows=r.shape[0] * DEFAULT_BLOCK_ROWS) for r, c, v in zip(er, ec, ed)])


def spmm_2d_ell(e_rows, e_cols, e_data, n_rows, dense, mesh, row_axis="x", col_axis="y"):
    """:func:`spmm_2d` with ``ell_spmm`` a shard, on the layout of
    :func:`partition_spmm_ell`; ``dense``'s columns split over ``col_axis``."""
    er, ec, ed = _locals(mesh, row_axis, e_rows, e_cols, e_data)
    out = _gather_2d(_ell_products(er, ec, ed, _local(dense, mesh, col_axis, dim=1)), mesh, row_axis, col_axis)
    return out.reshape(-1, out.shape[-1])[:n_rows]


def spmm_sharded_ell(e_rows, e_cols, e_data, dense, n_rows, mesh, axis_name="x"):
    """Sharded SpMM with ``ell_spmm`` a shard, on the layout of
    :func:`partition_spmm_ell`; ``dense`` replicated. ``(n_rows, N)``."""
    er, ec, ed = _locals(mesh, axis_name, e_rows, e_cols, e_data)
    out = _gather(_ell_products(er, ec, ed, _replicated(dense, mesh)), mesh, axis_name)
    return out.reshape(-1, out.shape[-1])[:n_rows]


def sddmm_sharded(pcoo_s, lhs, rhs, mesh, axis_name="x"):
    """Sharded SDDMM: the sample matrix row-sharded, each shard with its
    ``block_rows`` rows of ``lhs`` (from its first row: ``row_starts`` on an
    nnz-balanced partition), ``rhs`` replicated; one ``kernels.dot.sddmm``
    a shard (K4 on the GPU). Returns the ``(n_shards, cap)`` values aligned
    with ``pcoo_s.data`` (padding entries hold 0)."""
    rows, cols, data = _locals(mesh, axis_name, pcoo_s.rows, pcoo_s.cols, pcoo_s.data)
    block_rows = pcoo_s.block_rows
    lhs, b = _replicated(lhs, mesh), _replicated(rhs, mesh)
    out = []
    for s, (r, c, d) in zip(range(*_span(mesh, axis_name, pcoo_s.n_shards)), zip(rows, cols, data)):
        first = _shard_start(pcoo_s, s)
        block = lhs[first : first + block_rows]
        if block.shape[0] < block_rows:
            block = torch.cat([block, block.new_zeros((block_rows - block.shape[0], block.shape[1]))])
        out.append(sddmm(r, c, d, block, b))
    return _gather(torch.stack(out), mesh, axis_name)


def spgemm_sharded(pcoo_a, b_coo, mesh, axis_name="x", product_capacity=None, out_capacity=None):
    """Sharded SpGEMM: A row-sharded, B's canonical COO triplets replicated;
    ``esc_spgemm`` a shard. Returns ``(rows, cols, data, nnz)``: per-shard
    padded triplets ``(n_shards, out_capacity)`` with local rows, and the
    per-shard counts; :func:`assemble_spgemm_result` makes the global COO."""
    from ..core.coo import COO

    if not isinstance(b_coo, COO):
        b_coo = b_coo.asformat("coo")
    K, N = b_coo.shape
    device = _device(mesh)
    rb = b_coo.coords[0].to(device=device, dtype=torch.int32)
    cb = b_coo.coords[1].to(device=device, dtype=torch.int32)
    db = b_coo.data.to(device)
    if product_capacity is None:
        # per-shard worst case (padding entries hit row 0 of B, so they count)
        cols_a, rows_b = _host(pcoo_a.cols), _host(b_coo.coords[0])
        product_capacity = max(max(product_count(cols_a[s], rows_b, K) for s in range(pcoo_a.n_shards)), 1)
    if out_capacity is None:
        out_capacity = product_capacity
    ra, ca, da = _locals(mesh, axis_name, pcoo_a.rows, pcoo_a.cols, pcoo_a.data)
    shards = [
        esc_spgemm(
            r, c, d.to(db.dtype), rb, cb, db, k=K, n=N, product_capacity=int(product_capacity), out_capacity=int(out_capacity)
        )
        for r, c, d in zip(ra, ca, da)
    ]
    return tuple(_gather(torch.stack(parts), mesh, axis_name) for parts in zip(*shards))


def assemble_spgemm_result(shard_out, pcoo_a, n_cols):
    """Host: stitch :func:`spgemm_sharded`'s per-shard padded output into a
    global COO on its device (computed zeros pruned)."""
    from ..core.coo import COO

    device = shard_out[0].device
    rows_o, cols_o, data_o, nnz_o = (_host(x) for x in shard_out)
    parts_r, parts_c, parts_d = [], [], []
    for s in range(rows_o.shape[0]):
        n = int(nnz_o[s])
        parts_r.append(rows_o[s, :n].astype(np.int64) + _shard_start(pcoo_a, s))
        parts_c.append(cols_o[s, :n].astype(np.int64))
        parts_d.append(data_o[s, :n])
    return COO(
        np.stack([np.concatenate(parts_r), np.concatenate(parts_c)]),
        np.concatenate(parts_d),
        shape=(pcoo_a.shape[0], n_cols),
        has_duplicates=False,
        sorted=True,
        prune=True,
        device=device,
    )


def mttkrp_sharded(coords_i, coords_j, coords_k, data, c, d, n_rows, mesh, axis_name="x"):
    """Sharded MTTKRP: the 3-D tensor i-partitioned (``(n_shards, cap)``
    arrays, local ``i``, zero padding), the factors replicated; one
    ``kernels.dot.mttkrp`` a shard (K3 on the GPU) after a stable sort of
    the shard by ``i``. ``(n_rows, r)``."""
    block_rows = -(-n_rows // coords_i.shape[0])
    ci, cj, ck, v = _locals(mesh, axis_name, coords_i, coords_j, coords_k, data)
    c, d = _replicated(c, mesh), _replicated(d, mesh)
    outs = []
    for s in range(ci.shape[0]):
        order = torch.sort(ci[s], stable=True)[1]
        outs.append(mttkrp(ci[s][order], cj[s][order], ck[s][order], v[s][order], c, d, n_rows=block_rows))
    return _gather(torch.stack(outs), mesh, axis_name).reshape(-1, c.shape[1])[:n_rows]


def mttkrp_sharded_ell(e_rows, e_j, e_k, e_data, c, d, n_rows, block_rows, mesh, axis_name="x", strategy="exact"):
    """Sharded MTTKRP with ``ell_mttkrp`` a shard (E2's kernel on the GPU;
    each shard's runs sorted on the device), on the layout of
    :func:`partition_mttkrp_ell`; factors replicated. ``strategy`` passes
    through to ``ell_mttkrp``. ``(n_rows, r)``."""
    er, ej, ek, ed = _locals(mesh, axis_name, e_rows, e_j, e_k, e_data)
    c, d = _replicated(c, mesh), _replicated(d, mesh)
    outs = [
        ell_mttkrp(r, j, k, v, c, d, n_rows=r.shape[0] * DEFAULT_BLOCK_ROWS, strategy=strategy)
        for r, j, k, v in zip(er, ej, ek, ed)
    ]
    return _gather(torch.stack(outs), mesh, axis_name).reshape(-1, c.shape[1])[:n_rows]


# ---------------------------------------------------------------------------
# element-wise operations and reductions over identically partitioned operands
# ---------------------------------------------------------------------------


def elemwise_partitioned(func, pa: PartitionedCOO, pb: PartitionedCOO, mesh, axis_name="x"):
    """Shard-local element-wise ``func`` (on tensors, e.g. ``torch.add``)
    over two identically partitioned zero-fill operands; no communication
    but the output's gather.

    ``func`` must map (0, 0) to 0, since the padding survives as zeros.
    Returns ``(out, nnz_per_shard)``: a PartitionedCOO of capacity ``cap_a +
    cap_b`` (entries past each shard's count are zero padding) and the
    per-shard union counts."""
    if pa.shape != pb.shape or pa.block_rows != pb.block_rows or pa.n_shards != pb.n_shards:
        raise ValueError("operands must share shape and partitioning")
    sa, sb = pa.row_starts, pb.row_starts
    if (sa is None) != (sb is None) or (sa is not None and not np.array_equal(sa, sb)):
        raise ValueError("operands must share row_starts (nnz-balanced partitions)")
    probe = func(torch.zeros(1, dtype=pa.data.dtype), torch.zeros(1, dtype=pb.data.dtype))
    if probe[0] != 0:
        raise ValueError(f"elemwise_partitioned requires func(0, 0) == 0, got {probe[0].item()!r}")
    k_cols = pa.shape[1]
    size = pa.block_rows * k_cols
    ra, ca, da, rb, cb, db = _locals(mesh, axis_name, pa.rows, pa.cols, pa.data, pb.rows, pb.cols, pb.data)
    outs = []
    for s in range(ra.shape[0]):
        # padding entries carry local coordinate 0 with data 0; they merge
        # into one union slot that holds func(0, 0) == 0
        lin, vals, _, nnz = coo_elemwise_union(
            ra[s].long() * k_cols + ca[s].long(),
            da[s],
            torch.zeros((), dtype=da.dtype),
            rb[s].long() * k_cols + cb[s].long(),
            db[s],
            torch.zeros((), dtype=db.dtype),
            func=func,
            size=size,
        )
        lin = torch.where(lin >= size, 0, lin)
        outs.append(((lin // k_cols).to(torch.int32), (lin % k_cols).to(torch.int32), vals, nnz))
    r, c, v, nnz = (_gather(torch.stack(parts), mesh, axis_name) for parts in zip(*outs))
    return PartitionedCOO(r, c, v, pa.shape, pa.block_rows, sa), nnz


def sum_partitioned(pcoo: PartitionedCOO, mesh, axis=None, axis_name="x"):
    """Sharded ``sum`` of a zero-fill PartitionedCOO → dense, on the mesh's
    device: ``axis=1`` ``(M,)`` within rows (no communication but the
    gather), ``axis=0`` ``(K,)`` across the row partition, ``axis=None``
    the 0-d total. The last two are the shards' partials summed in shard
    order: the same bits at every world size."""
    M, K = pcoo.shape
    rows, cols, data = _locals(mesh, axis_name, pcoo.rows, pcoo.cols, pcoo.data)
    if axis == 1:
        parts = [data.new_zeros(pcoo.block_rows).index_add_(0, r.long(), d) for r, d in zip(rows, data)]
        return _stitch(_gather(torch.stack(parts), mesh, axis_name), M, pcoo.block_rows, pcoo.row_starts)
    if axis == 0:
        parts = [data.new_zeros(K).index_add_(0, c.long(), d) for c, d in zip(cols, data)]
        return _shard_sum(_gather(torch.stack(parts), mesh, axis_name))
    if axis is not None:
        raise ValueError(f"sum_partitioned takes axis 0, 1 or None, not {axis!r}")
    return _shard_sum(_gather(data.sum(1, dtype=data.dtype), mesh, axis_name))
