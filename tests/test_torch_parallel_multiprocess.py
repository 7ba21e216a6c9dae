"""The port's multi-device layer in gloo groups of 2 and 4 processes.

Each group is spawned once for the module (tests/torch_parallel_worker.py,
which imports ``sparse_tpu_torch`` only): its ranks rendezvous on a
``FileStore``, run every feature on inputs made from numpy seeds and write
what each returned. Each feature at each world size is one test case here,
held against ``sparse_tpu``'s result on ``conftest.py``'s 8 virtual
devices, and every rank must hold the same global result. The ring's
rotations cross process boundaries, ``spmm_2d*`` run on a 2 x 1 and a 2 x 2
mesh (gloo sub-groups), and a checkpoint of 8 shards saved here (no process
group) restores onto both worlds (four and two shards a rank) beside each
world's own round trip. ``sum_partitioned``, ``bellman_ford_partitioned``
and ``dia_spmv_sharded`` have the same bits at worlds of 1, 2 and 4. The
partitioned forms of ``linalg``, ``kernels.dia``, ``csgraph`` and ``nn``
run at the reference tests' tolerances, int16 and the wide unsigned dtypes
go through the collectives as bytes, and ``entry.dryrun_multichip`` runs at
each world. Tolerances as tests/test_torch_parallel.py.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import sparse_tpu as sparse
import sparse_tpu.parallel as rp
import sparse_tpu_torch as st
import sparse_tpu_torch.parallel as tp
from torch_parallel_worker import FEATURES, INT_DTYPES, N_SHARDS, m3_coords, make_inputs, mttkrp_shards

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLDS = (2, 4)
F64 = dict(rtol=1e-12, atol=0.0)


def _spawn(world, out_dir, checkpoint_dir):
    out_dir.mkdir()
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(out_dir / "store"), str(out_dir), str(checkpoint_dir)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for r in range(world)
    ]


def _collect(world, procs, out_dir):
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
    status = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    outs = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return status, outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from sparse_tpu_torch import checkpoint as tck

    base = tmp_path_factory.mktemp("gloo_worlds")
    checkpoint_dir = base / "checkpoints"
    a = make_inputs()["a"]
    tck.save_partitioned(str(checkpoint_dir / "8_shards"), tp.partition_coo_rows(st.COO(a[0], a[1], shape=a[2], device="cpu"), N_SHARDS))
    procs = {w: _spawn(w, base / f"world{w}", checkpoint_dir) for w in WORLDS}  # both groups at once
    return {w: _collect(w, procs[w], base / f"world{w}") for w in WORLDS}


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def _ref_coo(case):
    coords, data, shape = case
    return sparse.COO(coords, data, shape=shape)


def _mesh(n):
    return rp.make_mesh(n)


def _feature(runs, world, feature):
    """Each rank's outputs of ``feature`` (after checking that it ran and
    that every rank holds the same global result)."""
    status, outs = runs[world]
    for r in range(world):
        assert status[r][feature] == "ok", f"rank {r}: {status[r][feature]}"
    mine = [{k.split("/", 1)[1]: v for k, v in o.items() if k.startswith(feature + "/")} for o in outs]
    for r in range(1, world):
        for k, v in mine[0].items():
            if not k.startswith("rank_"):
                np.testing.assert_array_equal(mine[r][k], v, err_msg=f"rank {r}'s {k}")
    return mine


def _close(got, want, **tol):
    np.testing.assert_allclose(got, np.asarray(want), **(tol or F64))


def _scaled_close(got, want, scale, tol=1e-5):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol * np.maximum(scale, np.finfo(np.float32).tiny)), err.max()


def check_placement(world, mine, inputs):
    want = np.asarray(rp.partition_coo_rows(_ref_coo(inputs["a"]), N_SHARDS).rows)
    for o in mine:
        lo, hi = o["rank_span"]
        assert hi - lo == N_SHARDS // world
        np.testing.assert_array_equal(o["rank_rows"], want[lo:hi])
    np.testing.assert_array_equal(mine[0]["rows"], want)


def check_spmm_replicated(world, mine, inputs):
    m = _mesh(N_SHARDS)
    a, skew = _ref_coo(inputs["a"]), _ref_coo(inputs["skew"])
    _close(mine[0]["out"], rp.spmm_replicated(rp.partition_coo_rows(a, N_SHARDS, mesh=m), jnp.asarray(inputs["b"]), m))
    want = rp.spmm_replicated(rp.partition_coo_rows(skew, N_SHARDS, mesh=m, balance="nnz"), jnp.asarray(inputs["skew_b"]), m)
    _close(mine[0]["nnz_balanced"], want)


def _ref_ring(a, b, n_shards, ell):
    m = _mesh(n_shards)
    if ell:
        bucketed = rp.bucket_columns_ell(a, n_shards)
        block_cols, block_rows = bucketed[4], None
    else:
        pc = rp.partition_coo_rows(a, n_shards)
        bucketed = rp.bucket_columns(pc, n_shards)
        block_cols, block_rows = bucketed[3], pc.block_rows
    b_pad = np.zeros((n_shards * block_cols, b.shape[1]))
    b_pad[: b.shape[0]] = b
    dense = jax.device_put(jnp.asarray(b_pad), NamedSharding(m, P("x", None)))
    if ell:
        return rp.spmm_ring_ell(bucketed, a.shape[0], dense, m)
    return rp.spmm_ring(bucketed, a.shape, block_rows, dense, m)


def check_spmm_ring(world, mine, inputs):
    a = _ref_coo(inputs["a"])
    for n_shards in sorted({world, N_SHARDS}):
        _close(mine[0][f"shards{n_shards}"], _ref_ring(a, inputs["b"], n_shards, ell=False))


def check_spmm_ring_ell(world, mine, inputs):
    _close(mine[0]["out"], _ref_ring(_ref_coo(inputs["a"]), inputs["b"], N_SHARDS, ell=True))


def check_spmm_sharded_ell(world, mine, inputs):
    a, b = _ref_coo(inputs["ell"]), inputs["ell_b"]
    want = rp.spmm_sharded_ell(*rp.partition_spmm_ell(a, N_SHARDS)[:3], jnp.asarray(b), 2100, _mesh(N_SHARDS))
    _scaled_close(mine[0]["out"], want, np.abs(a.todense()) @ np.abs(b))


def check_spmm_2d(world, mine, inputs):
    devs = np.asarray(jax.devices()[:8])
    a, b = _ref_coo(inputs["a"]), inputs["b"]
    m2 = Mesh(devs.reshape(2, 4), ("x", "y"))
    pc = rp.partition_coo_rows(a, 2)
    sh = NamedSharding(m2, P("x", None))
    placed = rp.PartitionedCOO(*(jax.device_put(jnp.asarray(np.asarray(x)), sh) for x in (pc.rows, pc.cols, pc.data)), pc.shape, pc.block_rows)
    _close(mine[0]["coo"], rp.spmm_2d(placed, jax.device_put(jnp.asarray(b), NamedSharding(m2, P(None, "y"))), m2))
    e, eb = _ref_coo(inputs["ell"]), inputs["ell_b"]
    want = rp.spmm_2d_ell(*rp.partition_spmm_ell(e, 4)[:3], 2100, jnp.asarray(eb), Mesh(devs.reshape(4, 2), ("x", "y")))
    _scaled_close(mine[0]["ell"], want, np.abs(e.todense()) @ np.abs(eb))


def check_sddmm_sharded(world, mine, inputs):
    m = _mesh(N_SHARDS)
    pc = rp.partition_coo_rows(_ref_coo(inputs["s"]), N_SHARDS, mesh=m)
    _close(mine[0]["out"], rp.sddmm_sharded(pc, inputs["lhs"], inputs["rhs"], m))


def check_spgemm_sharded(world, mine, inputs):
    m = _mesh(N_SHARDS)
    pc = rp.partition_coo_rows(_ref_coo(inputs["ga"]), N_SHARDS, mesh=m)
    b = _ref_coo(inputs["gb"])
    want = rp.spgemm_sharded(pc, b, m)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(mine[0][f"out{i}"], np.asarray(want[i]))
    _close(mine[0]["out2"], want[2])
    res = rp.assemble_spgemm_result(want, pc, 80)
    np.testing.assert_array_equal(mine[0]["coords"], np.asarray(res.coords))
    _close(mine[0]["data"], res.data)


def check_mttkrp_sharded(world, mine, inputs):
    coords, data, _ = inputs["m3"]
    shards = mttkrp_shards(m3_coords(coords), data, 64, N_SHARDS)
    want = rp.mttkrp_sharded(*(jnp.asarray(x) for x in shards), jnp.asarray(inputs["m3_c"]), jnp.asarray(inputs["m3_d"]), 64, _mesh(N_SHARDS))
    _close(mine[0]["out"], want)


def check_mttkrp_sharded_ell(world, mine, inputs):
    coords, data, (I, _, _) = inputs["t3"]
    part = rp.partition_mttkrp_ell(coords, data, I, N_SHARDS)
    want = rp.mttkrp_sharded_ell(*part[:4], inputs["t3_c"], inputs["t3_d"], I, part[4], _mesh(N_SHARDS))
    _close(mine[0]["out"], want, rtol=1e-5, atol=0.0)


def check_elemwise_partitioned(world, mine, inputs):
    m = _mesh(N_SHARDS)
    pa, pb = (rp.partition_coo_rows(_ref_coo(inputs[k]), N_SHARDS, mesh=m) for k in ("e", "f"))
    for name, fn in (("add", jnp.add), ("multiply", jnp.multiply), ("maximum", jnp.maximum)):
        out, nnz = rp.elemwise_partitioned(fn, pa, pb, m)
        for key, want in (("rows", out.rows), ("cols", out.cols), ("data", out.data), ("nnz", nnz)):
            np.testing.assert_array_equal(mine[0][f"{name}_{key}"], np.asarray(want))


def _sum_cases():
    return [f"{balance}_{axis}" for balance in ("rows", "nnz") for axis in (0, 1, None)]


def check_sum_partitioned(world, mine, inputs):
    m = _mesh(N_SHARDS)
    e = _ref_coo(inputs["e"])
    for balance in ("rows", "nnz"):
        pc = rp.partition_coo_rows(e, N_SHARDS, mesh=m, balance=balance)
        for axis in (0, 1, None):
            _close(mine[0][f"{balance}_{axis}"], rp.sum_partitioned(pc, m, axis=axis))


def check_checkpoint(world, mine, inputs):
    a, b = _ref_coo(inputs["a"]), inputs["b"]
    want = a.todense() @ b
    for o in mine:
        assert int(o["rank_shards"]) == int(o["rank_other_shards"]) == N_SHARDS // world
    _close(mine[0]["same"], want)
    _close(mine[0]["other_world"], want)


def check_partitioned_matvec(world, mine, inputs):
    from sparse_tpu import linalg

    m = _mesh(N_SHARDS)
    mv = linalg.partitioned_matvec(rp.partition_coo_rows(_ref_coo(inputs["spd"]), N_SHARDS, mesh=m), m)
    x, info = linalg.cg(mv, inputs["spd_b"], tol=1e-10, maxiter=500)
    assert int(mine[0]["info"]) == int(info) == 0
    _close(mine[0]["x"], x, rtol=1e-6, atol=0.0)


def check_dia_spmv_sharded(world, mine, inputs):
    from sparse_tpu.kernels import dia_spmv_sharded

    offsets, bands = inputs["band"]
    x = inputs["band_x"]
    _close(mine[0]["y"], dia_spmv_sharded(tuple(offsets), bands, x, _mesh(N_SHARDS)), rtol=1e-10, atol=0.0)
    with_inf = x.copy()
    with_inf[0], with_inf[-1] = np.inf, -np.inf
    want = np.asarray(dia_spmv_sharded(tuple(offsets), bands, with_inf, _mesh(N_SHARDS)))
    np.testing.assert_array_equal(np.isnan(mine[0]["with_inf"]), np.isnan(want))
    _close(mine[0]["with_inf"], want, rtol=1e-12, atol=0.0)
    for o in mine:
        assert "must divide" in str(o["rank_refused"])


def _graph(case, inputs, nan=False):
    r, c, w, n = inputs[case]
    if nan:
        w = w.copy()
        w[::37] = np.nan
    return sparse.COO(np.stack([r, c]), w, shape=(n, n))


def check_bellman_ford_partitioned(world, mine, inputs):
    from sparse_tpu import csgraph

    m = _mesh(N_SHARDS)
    for case in ("graph", "hub"):
        d, p = csgraph.bellman_ford_partitioned(_graph(case, inputs), m, indices=[0, 7, 50], return_predecessors=True)
        np.testing.assert_array_equal(mine[0][f"{case}_dist"], np.asarray(d))
        np.testing.assert_array_equal(mine[0][f"{case}_pred"], np.asarray(p))
    # NaN propagates as in the reference's bellman_ford (ROADMAP §C2)
    np.testing.assert_array_equal(mine[0]["nan_dist"], np.asarray(csgraph.bellman_ford(_graph("graph", inputs, nan=True), indices=[0, 3])))
    assert bool(mine[0]["negative_cycle_raised"])


def check_pagerank_partitioned(world, mine, inputs):
    from sparse_tpu import csgraph

    m = _mesh(N_SHARDS)
    want, it = csgraph.pagerank_partitioned(_graph("graph", inputs), m, tol=1e-13)
    _close(mine[0]["p"], want, rtol=1e-10, atol=1e-14)
    assert int(mine[0]["iterations"]) == it
    pers = np.zeros(120)
    pers[:4] = 1.0
    want2, _ = csgraph.pagerank_partitioned(_graph("graph", inputs), m, personalize=pers, tol=1e-12)
    _close(mine[0]["personalized"], want2, rtol=1e-9, atol=1e-13)


def check_banded_attention_sharded(world, mine, inputs):
    from sparse_tpu import nn

    q, k, v = (jnp.asarray(inputs[f"attn_{x}"]) for x in "qkv")
    for c in (False, True):
        want = nn.banded_attention_sharded(q, k, v, window=16, mesh=_mesh(N_SHARDS), block=16, causal=c)
        _close(mine[0][f"causal_{c}"], want, rtol=0.0, atol=2e-5)
    for o in mine:
        assert "must divide" in str(o["rank_refused"])


def check_sparse_attention_sharded(world, mine, inputs):
    from sparse_tpu import nn

    rows, cols = nn.local_attention_pattern(70, 5, 2)
    q, k, v = (jnp.asarray(inputs[f"attn_{x}"][:70, :8]) for x in "qkv")
    lr, lc, valid, br = nn.partition_attention_pattern(rows, cols, 70, N_SHARDS)
    _close(mine[0]["out"], nn.sparse_attention_sharded(q, k, v, lr, lc, valid, br, _mesh(N_SHARDS)), rtol=0.0, atol=1e-5)


def check_int_gathers(world, mine, inputs):
    m = _mesh(N_SHARDS)
    coords, data, shape = inputs["ints"]
    vals = np.round(data * 98 + 1)
    sharded = NamedSharding(m, P("x", None))
    for name in INT_DTYPES:
        a = sparse.COO(coords, vals.astype(name), shape=shape)
        pc = rp.partition_coo_rows(a, N_SHARDS, mesh=m)
        b = (np.arange(40 * 3).reshape(40, 3) % 5).astype(name)
        bucketed = rp.bucket_columns(rp.partition_coo_rows(a, N_SHARDS), N_SHARDS)
        b_pad = np.zeros((N_SHARDS * bucketed[3], 3), dtype=name)
        b_pad[:40] = b
        want = {
            "spmm": rp.spmm_replicated(pc, jnp.asarray(b), m),
            "ring": rp.spmm_ring(bucketed, shape, pc.block_rows, jax.device_put(jnp.asarray(b_pad), sharded), m),
            **{f"sum_{axis}": rp.sum_partitioned(pc, m, axis=axis) for axis in (0, 1, None)},
            "sddmm": rp.sddmm_sharded(pc, (np.arange(64 * 3).reshape(64, 3) % 4).astype(name), b.T.copy(), m),
        }
        union, nnz = rp.elemwise_partitioned(jnp.bitwise_or, pc, pc, m)
        want.update(union=union.data, union_nnz=nnz)
        for key, w in want.items():
            got, w = mine[0][f"{name}_{key}"], np.asarray(w)
            assert got.dtype == w.dtype, (name, key, got.dtype, w.dtype)
            np.testing.assert_array_equal(got, w, err_msg=f"{name} {key}")


def check_dryrun_multichip(world, mine, inputs):
    assert all(bool(o["done"]) for o in mine)


CHECKS = {name: globals()[f"check_{name}"] for name in FEATURES}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("feature", FEATURES)
def test_feature(runs, inputs, world, feature):
    CHECKS[feature](world, _feature(runs, world, feature), inputs)


def test_sum_partitioned_has_the_same_bits_at_every_world(runs, inputs, tmp_path):
    e = st.COO(inputs["e"][0], inputs["e"][1], shape=inputs["e"][2], device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = tp.make_mesh(device="cpu")
        world1 = {}
        for balance in ("rows", "nnz"):
            pc = tp.partition_coo_rows(e, N_SHARDS, mesh=mesh, balance=balance)
            for axis in (0, 1, None):
                world1[f"{balance}_{axis}"] = tp.sum_partitioned(pc, mesh, axis=axis).numpy()
    finally:
        dist.destroy_process_group()
    for world in WORLDS:
        mine = _feature(runs, world, "sum_partitioned")[0]
        for case in _sum_cases():
            assert mine[case].dtype == world1[case].dtype
            assert mine[case].tobytes() == world1[case].tobytes(), (world, case)


def test_partitioned_forms_have_the_same_bits_at_every_world(runs, inputs, tmp_path):
    """``bellman_ford_partitioned`` (the hub graph's layout relabels at every
    world) and ``dia_spmv_sharded`` give the bits of a world of one at 2 and
    4 ranks."""
    from sparse_tpu_torch import csgraph

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = tp.make_mesh(device="cpu")
        world1 = {}
        for case in ("graph", "hub"):
            r, c, w, n = inputs[case]
            g = st.COO(np.stack([r, c]), w, shape=(n, n), device="cpu")
            d, p = csgraph.bellman_ford_partitioned(g, mesh, indices=[0, 7, 50], return_predecessors=True)
            world1[f"bellman_ford_partitioned/{case}_dist"], world1[f"bellman_ford_partitioned/{case}_pred"] = d.numpy(), p.numpy()
        offsets, bands = inputs["band"]
        world1["dia_spmv_sharded/y"] = st.kernels.dia_spmv_sharded(tuple(offsets), bands, inputs["band_x"], mesh).numpy()
    finally:
        dist.destroy_process_group()
    for world in WORLDS:
        for key, want in world1.items():
            feature, name = key.split("/")
            got = _feature(runs, world, feature)[0][name]
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (world, key)
