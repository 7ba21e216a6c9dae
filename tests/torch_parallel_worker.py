"""One rank of a gloo group that runs the port's multi-device layer
(tests/test_torch_parallel_multiprocess.py spawns it).

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT [CHECKPOINT]

The rank joins a gloo group of ``WORLD`` ranks rendezvousing on the file
``STORE``, runs every feature of ``FEATURES`` on the inputs of
:func:`make_inputs` (numpy seeds, the same in every process), and writes
what each returned to ``OUT/rank<RANK>.npz`` (``<feature>/<name>`` keys;
names that start with ``rank_`` are the rank's own, the rest global)
with ``OUT/rank<RANK>.json`` saying ``"ok"`` or the traceback of each
feature. ``CHECKPOINT`` is a directory holding ``"8_shards"``, the
8-shard partition of input ``"a"`` saved by the test process (no process
group): every world restores it. Imports nothing of JAX or
``sparse_tpu``: the test process holds the results against the reference.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import traceback

import numpy as np

N_SHARDS = 8


def _matrix(m, k, density, seed, dtype=np.float64):
    """``(coords, data, shape)`` of a random 2-D matrix, row-major."""
    rng = np.random.default_rng(seed)
    dense = rng.random((m, k)) * (rng.random((m, k)) < density)
    rows, cols = np.nonzero(dense)
    return np.stack([rows, cols]).astype(np.int64), dense[rows, cols].astype(dtype), (m, k)


def make_inputs():
    """Every input of every feature, from numpy seeds."""
    rng = np.random.default_rng(7)
    I, J, K, R = 2100, 40, 50, 8
    lin = np.unique(rng.integers(0, I * J * K, 30000))
    t3 = np.stack([lin // (J * K), (lin // K) % J, lin % K]).astype(np.int32)
    skew_rows = np.concatenate([rng.integers(0, 20, 3000), rng.integers(20, 500, 500)])
    skew_cols = np.concatenate([rng.integers(0, 300, 3000), rng.integers(0, 300, 500)])
    skew_lin = np.unique(skew_rows * 300 + skew_cols)
    return {
        "a": _matrix(1000, 800, 0.01, 0),
        "b": rng.random((800, 16)),
        "skew": (np.stack([skew_lin // 300, skew_lin % 300]), rng.random(skew_lin.size), (500, 300)),
        "skew_b": rng.random((300, 8)),
        "e": _matrix(70, 40, 0.15, 1),
        "f": _matrix(70, 40, 0.15, 2),
        "s": _matrix(200, 150, 0.05, 6),
        "lhs": rng.random((200, 8)),
        "rhs": rng.random((8, 150)),
        "ga": _matrix(240, 60, 0.05, 3),
        "gb": _matrix(60, 80, 0.05, 4),
        "ell": _matrix(2100, 500, 0.02, 27, np.float32),
        "ell_b": rng.random((500, 16)).astype(np.float32),
        "t3": (t3, rng.random(lin.size).astype(np.float32), (I, J, K)),
        "t3_c": rng.random((J, R)).astype(np.float32),
        "t3_d": rng.random((K, R)).astype(np.float32),
        "m3": _matrix(64, 120, 0.05, 5),  # a (64, 10 x 12) tensor's unfolding
        "m3_c": rng.random((10, 4)),
        "m3_d": rng.random((12, 4)),
    }


def mttkrp_shards(coords, data, m, n_shards):
    """tests/test_parallel.py:61's i-partition: local rows, zero padding."""
    block_rows = -(-m // n_shards)
    shard_of = coords[0] // block_rows
    cap = max(int(np.bincount(shard_of, minlength=n_shards).max()), 1)
    out = [np.zeros((n_shards, cap), dtype=np.int32) for _ in range(3)] + [np.zeros((n_shards, cap), dtype=data.dtype)]
    for s in range(n_shards):
        sel = shard_of == s
        k = int(sel.sum())
        out[0][s, :k] = coords[0][sel] - s * block_rows
        out[1][s, :k] = coords[1][sel]
        out[2][s, :k] = coords[2][sel]
        out[3][s, :k] = data[sel]
    return out


def m3_coords(coords):
    """The (64, 10, 12) tensor's coordinates from its unfolding's."""
    return np.stack([coords[0], coords[1] // 12, coords[1] % 12])


# ---------------------------------------------------------------------------
# the features (run in the worker)
# ---------------------------------------------------------------------------


def _coo(st, case):
    coords, data, shape = case
    return st.COO(coords, data, shape=shape, device="cpu")


def _dtensor(t, mesh, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements, run_check=False)


def _features(st, tp, tck, torch, dist, inputs, checkpoint_dir):
    from torch.distributed.tensor import Replicate, Shard

    world = dist.get_world_size()
    rank = dist.get_rank()
    mesh = tp.make_mesh(device="cpu")
    a, b = _coo(st, inputs["a"]), inputs["b"]
    n_rows = 1000

    def local_span(n):
        k = n // world
        return rank * k, (rank + 1) * k

    def placement():
        pc = tp.partition_coo_rows(a, N_SHARDS, mesh=mesh)
        lo, hi = local_span(N_SHARDS)
        return {
            "rank_rows": pc.rows.to_local().numpy(),
            "rank_data": pc.data.to_local().numpy(),
            "rank_span": np.array([lo, hi]),
            "rows": pc.rows.full_tensor().numpy(),
        }

    def spmm_replicated():
        pc = tp.partition_coo_rows(a, N_SHARDS, mesh=mesh)
        skew = tp.partition_coo_rows(_coo(st, inputs["skew"]), N_SHARDS, mesh=mesh, balance="nnz")
        return {
            "out": tp.spmm_replicated(pc, b, mesh).numpy(),
            "nnz_balanced": tp.spmm_replicated(skew, inputs["skew_b"], mesh).numpy(),
        }

    def ring_dense(block_cols, n_buckets):
        b_pad = np.zeros((n_buckets * block_cols, b.shape[1]))
        b_pad[: b.shape[0]] = b
        lo, hi = local_span(b_pad.shape[0])
        return _dtensor(torch.from_numpy(b_pad[lo:hi].copy()), mesh, [Shard(0)])

    def spmm_ring():
        out = {}
        for n_shards in sorted({world, N_SHARDS}):  # one shard a rank (the reference's form), and several
            pc = tp.partition_coo_rows(a, n_shards)
            bucketed = tp.bucket_columns(pc, n_shards)
            out[f"shards{n_shards}"] = tp.spmm_ring(bucketed, a.shape, pc.block_rows, ring_dense(bucketed[3], n_shards), mesh).numpy()
        return out

    def spmm_ring_ell():
        bucketed = tp.bucket_columns_ell(a, N_SHARDS)
        return {"out": tp.spmm_ring_ell(bucketed, n_rows, ring_dense(bucketed[4], N_SHARDS), mesh).numpy()}

    def spmm_sharded_ell():
        part = tp.partition_spmm_ell(_coo(st, inputs["ell"]), N_SHARDS)
        return {"out": tp.spmm_sharded_ell(*part[:3], inputs["ell_b"], 2100, mesh).numpy()}

    def spmm_2d():
        from torch.distributed.device_mesh import DeviceMesh

        nx = 2
        mesh2 = DeviceMesh("cpu", torch.arange(world).reshape(nx, world // nx), mesh_dim_names=("x", "y"))
        pc = tp.partition_coo_rows(a, 2, mesh=mesh2, axis_name="x")
        dense = _dtensor(torch.from_numpy(np.ascontiguousarray(np.split(b, world // nx, axis=1)[mesh2.get_local_rank("y")])), mesh2, [Replicate(), Shard(1)])
        ell = tp.partition_spmm_ell(_coo(st, inputs["ell"]), 4)
        return {
            "coo": tp.spmm_2d(pc, dense, mesh2).numpy(),
            "ell": tp.spmm_2d_ell(*ell[:3], 2100, inputs["ell_b"], mesh2).numpy(),
        }

    def sddmm_sharded():
        pc = tp.partition_coo_rows(_coo(st, inputs["s"]), N_SHARDS, mesh=mesh)
        return {"out": tp.sddmm_sharded(pc, inputs["lhs"], inputs["rhs"], mesh).numpy()}

    def spgemm_sharded():
        pc = tp.partition_coo_rows(_coo(st, inputs["ga"]), N_SHARDS, mesh=mesh)
        shard_out = tp.spgemm_sharded(pc, _coo(st, inputs["gb"]), mesh)
        res = tp.assemble_spgemm_result(shard_out, pc, 80)
        return {**{f"out{i}": x.numpy() for i, x in enumerate(shard_out)}, "coords": res.coords.numpy(), "data": res.data.numpy()}

    def mttkrp_sharded():
        coords, data, _ = inputs["m3"]
        shards = mttkrp_shards(m3_coords(coords), data, 64, N_SHARDS)
        lo, hi = local_span(N_SHARDS)
        local = [_dtensor(torch.from_numpy(x[lo:hi].copy()), mesh, [Shard(0)]) for x in shards]
        return {"out": tp.mttkrp_sharded(*local, torch.from_numpy(inputs["m3_c"]), torch.from_numpy(inputs["m3_d"]), 64, mesh).numpy()}

    def mttkrp_sharded_ell():
        coords, data, (I, _, _) = inputs["t3"]
        part = tp.partition_mttkrp_ell(coords, data, I, N_SHARDS)
        return {"out": tp.mttkrp_sharded_ell(*part[:4], inputs["t3_c"], inputs["t3_d"], I, part[4], mesh).numpy()}

    def elemwise_partitioned():
        pa, pb = (tp.partition_coo_rows(_coo(st, inputs[k]), N_SHARDS, mesh=mesh) for k in ("e", "f"))
        out = {}
        for name, fn in (("add", torch.add), ("multiply", torch.multiply), ("maximum", torch.maximum)):
            res, nnz = tp.elemwise_partitioned(fn, pa, pb, mesh)
            out.update({f"{name}_rows": res.rows.numpy(), f"{name}_cols": res.cols.numpy(), f"{name}_data": res.data.numpy(), f"{name}_nnz": nnz.numpy()})
        return out

    def sum_partitioned():
        out = {}
        for balance in ("rows", "nnz"):
            pc = tp.partition_coo_rows(_coo(st, inputs["e"]), N_SHARDS, mesh=mesh, balance=balance)
            for axis in (0, 1, None):
                out[f"{balance}_{axis}"] = tp.sum_partitioned(pc, mesh, axis=axis).numpy()
        return out

    def checkpoint():
        pc = tp.partition_coo_rows(a, N_SHARDS, mesh=mesh)
        own = os.path.join(checkpoint_dir, f"world{world}")
        tck.save_partitioned(own, pc)
        restored = tck.load_partitioned(own, mesh=mesh)
        other = tck.load_partitioned(os.path.join(checkpoint_dir, "8_shards"), mesh=mesh)
        return {
            "same": tp.spmm_replicated(restored, b, mesh).numpy(),
            "rank_shards": np.array(restored.rows.to_local().shape[0]),
            "other_world": tp.spmm_replicated(other, b, mesh).numpy(),
            "rank_other_shards": np.array(other.rows.to_local().shape[0]),
        }

    return {
        "placement": placement,
        "spmm_replicated": spmm_replicated,
        "spmm_ring": spmm_ring,
        "spmm_ring_ell": spmm_ring_ell,
        "spmm_sharded_ell": spmm_sharded_ell,
        "spmm_2d": spmm_2d,
        "sddmm_sharded": sddmm_sharded,
        "spgemm_sharded": spgemm_sharded,
        "mttkrp_sharded": mttkrp_sharded,
        "mttkrp_sharded_ell": mttkrp_sharded_ell,
        "elemwise_partitioned": elemwise_partitioned,
        "sum_partitioned": sum_partitioned,
        "checkpoint": checkpoint,
    }


FEATURES = (
    "placement",
    "spmm_replicated",
    "spmm_ring",
    "spmm_ring_ell",
    "spmm_sharded_ell",
    "spmm_2d",
    "sddmm_sharded",
    "spgemm_sharded",
    "mttkrp_sharded",
    "mttkrp_sharded_ell",
    "elemwise_partitioned",
    "sum_partitioned",
    "checkpoint",
)


def main(argv):
    rank, world, store_path, out_dir = int(argv[1]), int(argv[2]), argv[3], argv[4]
    checkpoint_dir = argv[5] if len(argv) > 5 else out_dir
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the test machine's cores

    import sparse_tpu_torch as st
    import sparse_tpu_torch.parallel as tp
    from sparse_tpu_torch import checkpoint as tck

    # a rank whose feature failed mid-collective leaves the others waiting: a
    # minute's timeout turns that into their failure too, not a hang
    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world, timeout=timeout)
    status, arrays = {}, {}
    try:
        features = _features(st, tp, tck, torch, dist, make_inputs(), checkpoint_dir)
        for name in FEATURES:
            try:
                for key, value in features[name]().items():
                    arrays[f"{name}/{key}"] = value
                status[name] = "ok"
            except Exception:  # each feature reports its own failure; the others still run
                status[name] = traceback.format_exc()
            dist.barrier()
    finally:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(status, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
