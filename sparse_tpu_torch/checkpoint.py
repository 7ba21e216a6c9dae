"""Checkpoint and restore of a :class:`~sparse_tpu_torch.parallel.PartitionedCOO`
in ``sparse_tpu.checkpoint``'s npz layout: ``meta.json`` (``shape``,
``block_rows``, ``n_shards``, ``row_starts``) beside ``arrays.npz``
(``rows``, ``cols``, ``data``, each ``(n_shards, cap)``).

That layout is the port's one format (there is no orbax here): a checkpoint
written by either package's npz layout loads in the other. The restore is
elastic: the shards go onto any mesh whose axis size divides ``n_shards``
(8 shards onto 4 ranks, two a rank).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch.distributed as dist

from .parallel.sharding import PartitionedCOO, _host, _place


def save_partitioned(path, pcoo: PartitionedCOO):
    """Write ``pcoo`` under the directory ``path``. Sharded leaves are
    gathered first, so every rank of the group calls this; rank 0 writes,
    then the group waits for it."""
    arrays = {"rows": _host(pcoo.rows), "cols": _host(pcoo.cols), "data": _host(pcoo.data)}
    distributed = dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        meta = {
            "shape": [int(n) for n in pcoo.shape],
            "block_rows": int(pcoo.block_rows),
            "n_shards": int(pcoo.n_shards),
            "row_starts": None if pcoo.row_starts is None else [int(r) for r in pcoo.row_starts],
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    if distributed:
        dist.barrier()


def load_partitioned(path, mesh=None, axis_name="x") -> PartitionedCOO:
    """Read a checkpoint; with ``mesh`` each rank keeps its own shards, as
    DTensors sharded on their leading axis over ``axis_name``, else the
    leaves are CPU tensors."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as fp:
        arrays = (fp["rows"], fp["cols"], fp["data"])
    rows, cols, data = _place(arrays, mesh, axis_name)
    row_starts = meta.get("row_starts")
    return PartitionedCOO(
        rows,
        cols,
        data,
        tuple(meta["shape"]),
        meta["block_rows"],
        None if not row_starts else np.asarray(row_starts, dtype=np.int64),
    )
