"""The port's multi-device layer against sparse_tpu's (CPU), in a world of one.

The port runs in an in-process gloo group of one rank (a ``FileStore`` in
a temporary directory), which holds every shard; the reference runs on
``conftest.py``'s 8 virtual CPU devices with 8 shards, one a device. Inputs
come from numpy seeds at tests/test_parallel.py's sizes. The partitions are
compared array for array (dtypes too); results at rtol 1e-12 in float64,
and in float32 at PERF.md §2's tolerances: MTTKRP 1e-5 and SDDMM 1e-5 of
``|s| · Σ|lhs · rhs|``, the ELL SpMM at 1e-5 of ``Σ|a · b|``. Groups of 2
and 4 ranks are in tests/test_torch_parallel_multiprocess.py.
"""

import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import sparse_tpu as sparse
import sparse_tpu.parallel as rp
import sparse_tpu_torch as st
import sparse_tpu_torch.parallel as tp
from sparse_tpu_torch import checkpoint as tck
from sparse_tpu_torch.interop import ell_partition_from_arrays, partitioned_coo_from_arrays
from torch_parallel_worker import mttkrp_shards

N_DEV = 8
F64 = dict(rtol=1e-12, atol=0.0)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield tp.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rmesh():
    return rp.make_mesh(N_DEV)


def both(shape, density, seed, dtype=np.float64):
    """The same random matrix as a ``sparse_tpu`` COO and a port COO on the CPU."""
    a = sparse.random(shape, density=density, random_state=seed)
    a = sparse.COO(np.asarray(a.coords), np.asarray(a.data, dtype), shape=a.shape)
    return a, st.COO(np.asarray(a.coords), np.asarray(a.data), shape=a.shape, device="cpu")


def host(x):
    """A port leaf (a tensor or a DTensor) as a NumPy array."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.numpy()


def same_arrays(got, want):
    for g, w in zip(got, want):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def same_partition(tpc, rpc):
    same_arrays((tpc.rows, tpc.cols, tpc.data), (rpc.rows, rpc.cols, rpc.data))
    assert tpc.shape == rpc.shape and tpc.block_rows == rpc.block_rows and tpc.n_shards == rpc.n_shards
    want = getattr(rpc, "row_starts", None)
    assert (tpc.row_starts is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(tpc.row_starts, want)


def close(got, want, **tol):
    np.testing.assert_allclose(host(got), np.asarray(want), **(tol or F64))


def scaled_close(got, want, scale, tol):
    err = np.abs(host(got).astype(np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol * np.maximum(scale, np.finfo(np.float32).tiny)), err.max()


# ---------------------------------------------------------------------------
# names, parameters, the mesh
# ---------------------------------------------------------------------------

PARALLEL_NAMES = sorted(n for n in dir(rp) if not n.startswith("_") and n != "sharding")


def test_names_are_the_references():
    assert len(PARALLEL_NAMES) == 21
    assert sorted(n for n in dir(tp) if not n.startswith("_") and n != "sharding") == PARALLEL_NAMES
    assert st.parallel is tp
    assert not {"parallel", "profiling", "compiled"} & set(st.__all__)


def _same_parameters(ref_fn, got_fn):
    ref = inspect.signature(ref_fn).parameters
    got = inspect.signature(got_fn).parameters
    assert list(got)[: len(ref)] == list(ref)
    for p in ref:
        assert got[p].kind == ref[p].kind
        assert got[p].default is ref[p].default or got[p].default == ref[p].default
    # what the port adds is optional
    assert all(got[p].default is not inspect.Parameter.empty for p in list(got)[len(ref) :])


@pytest.mark.parametrize("name", PARALLEL_NAMES)
def test_parameter_names_are_the_references(name):
    _same_parameters(getattr(rp, name), getattr(tp, name))


@pytest.mark.parametrize("name", ["save_partitioned", "load_partitioned"])
def test_checkpoint_parameter_names_are_the_references(name):
    import sparse_tpu.checkpoint as rck

    _same_parameters(getattr(rck, name), getattr(tck, name))


def test_make_mesh(mesh):
    assert mesh.mesh_dim_names == ("x",) and mesh.size(0) == 1 and mesh.device_type == "cpu"
    assert tp.make_mesh(1, axis_name="rows", device="cpu").mesh_dim_names == ("rows",)
    assert tp.make_mesh(devices=[0], device="cpu").size(0) == 1
    with pytest.raises(ValueError, match="requested 2 ranks"):
        tp.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tp.make_mesh(device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tp.make_mesh()


def test_make_mesh_needs_a_process_group(mesh, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tp.make_mesh(device="cpu")


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("shape,density,n_shards", [((1000, 800), 0.01, 8), ((257, 130), 0.05, 8), ((64, 64), 0.1, 3), ((70, 40), 0.15, 16)])
def test_partition_coo_rows_is_the_references(mesh, shape, density, n_shards, balance):
    a, t = both(shape, density, 0)
    want = rp.partition_coo_rows(a, n_shards, balance=balance)
    same_partition(tp.partition_coo_rows(t, n_shards, balance=balance), want)
    placed = tp.partition_coo_rows(t, n_shards, mesh=mesh, balance=balance)
    assert type(placed.rows).__name__ == "DTensor" and placed.rows.to_local().shape == placed.rows.shape
    same_partition(placed, want)


def test_partition_preserves_all_entries():
    a, t = both((100, 50), 0.1, 0)
    pcoo = tp.partition_coo_rows(t, N_DEV)
    assert np.isclose(float(pcoo.data.sum()), float(np.asarray(a.data).sum()))


def test_nnz_balance_zipf_worst_case(mesh, rmesh):
    """tests/test_parallel.py:120's Zipf case: the partition array for array,
    its efficiency bound, and the SpMM on it."""
    rng = np.random.default_rng(42)
    M, K = 100_000, 2_000
    raw = rng.zipf(1.3, size=400_000)
    rows = (raw[raw <= M] - 1).astype(np.int64)
    cols = rng.integers(0, K, size=rows.size)
    lin = np.unique(rows * K + cols)
    rows, cols = lin // K, lin % K
    data = rng.random(rows.size)
    a = sparse.COO(np.stack([rows, cols]), data, shape=(M, K))
    t = st.COO(np.stack([rows, cols]), data, shape=(M, K), device="cpu")
    p_nnz = tp.partition_coo_rows(t, N_DEV, balance="nnz")
    same_partition(p_nnz, rp.partition_coo_rows(a, N_DEV, balance="nnz"))
    loads = (p_nnz.data != 0).sum(1).numpy()
    assert loads.sum() == rows.size
    assert loads.max() <= rows.size / N_DEV + int(np.bincount(rows).max())
    assert loads.mean() / loads.max() >= 0.70
    p_rows = tp.partition_coo_rows(t, N_DEV, balance="rows")
    loads_rows = (p_rows.data != 0).sum(1).numpy()
    assert loads_rows.mean() / loads_rows.max() < loads.mean() / loads.max()
    b = rng.random((K, 4))
    want = rp.spmm_replicated(rp.partition_coo_rows(a, N_DEV, mesh=rmesh, balance="nnz"), jnp.asarray(b), rmesh)
    close(tp.spmm_replicated(tp.partition_coo_rows(t, N_DEV, mesh=mesh, balance="nnz"), b, mesh), want)


@pytest.mark.parametrize("kw", [dict(shape=(40, 24), nnz=200, random_state=0), dict(shape=(1000, 100), density=0.02, random_state=2), dict(shape=(37, 11), nnz=0, random_state=1)])
def test_random_partitioned_is_the_references(mesh, kw):
    kw = dict(kw)
    shape = kw.pop("shape")
    want = rp.random_partitioned(shape, n_shards=N_DEV, **kw)
    same_partition(tp.random_partitioned(shape, n_shards=N_DEV, **kw), want)
    placed = tp.random_partitioned(shape, n_shards=N_DEV, mesh=mesh, **kw)
    same_partition(placed, want)
    b = np.random.default_rng(1).standard_normal((shape[1], 3))
    close(tp.spmm_replicated(placed, b, mesh), rp.spmm_replicated(want, b, mesh=rp.make_mesh(N_DEV)))


def test_random_partitioned_data_rvs_and_dtype():
    kw = dict(nnz=50, n_shards=4, random_state=3, data_rvs=lambda k: np.arange(k) + 1.0, dtype=np.float32)
    same_partition(tp.random_partitioned((20, 30), **kw), rp.random_partitioned((20, 30), **kw))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tp.random_partitioned((4, 4), 0.1, nnz=2, n_shards=2)


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,density", [((1000, 800), 0.01), ((257, 130), 0.05), ((64, 64), 0.1)])
def test_spmm_replicated(mesh, rmesh, shape, density):
    a, t = both(shape, density, 0)
    b = np.random.default_rng(1).random((shape[1], 16))
    want = rp.spmm_replicated(rp.partition_coo_rows(a, N_DEV, mesh=rmesh), jnp.asarray(b), rmesh)
    close(tp.spmm_replicated(tp.partition_coo_rows(t, N_DEV, mesh=mesh), b, mesh), want)
    # a host partition and a dense tensor are taken as the global arrays
    close(tp.spmm_replicated(tp.partition_coo_rows(t, N_DEV), torch.from_numpy(b), mesh), want)


def test_spmm_nnz_balanced(mesh, rmesh):
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.integers(0, 20, 5000), rng.integers(20, 500, 500)])
    cols = np.concatenate([rng.integers(0, 300, 5000), rng.integers(0, 300, 500)])
    data = rng.random(rows.size)
    a = sparse.COO(np.stack([rows, cols]), data, shape=(500, 300))
    t = st.COO(np.stack([rows, cols]), data, shape=(500, 300), device="cpu")
    b = rng.random((300, 8))
    want = rp.spmm_replicated(rp.partition_coo_rows(a, N_DEV, mesh=rmesh, balance="nnz"), jnp.asarray(b), rmesh)
    got = tp.spmm_replicated(tp.partition_coo_rows(t, N_DEV, mesh=mesh, balance="nnz"), b, mesh)
    close(got, want)


def _ring_dense(k, block_cols, n_buckets, n, seed, dtype=np.float64):
    b = np.random.default_rng(seed).random((k, n)).astype(dtype)
    b_pad = np.zeros((n_buckets * block_cols, n), dtype=dtype)
    b_pad[:k] = b
    return b, b_pad


@pytest.mark.parametrize("dense_as", ["dtensor", "tensor"])
def test_spmm_ring(mesh, rmesh, dense_as):
    a, t = both((1000, 800), 0.01, 0)
    bucketed_r = rp.bucket_columns(rp.partition_coo_rows(a, N_DEV), N_DEV)
    pc = tp.partition_coo_rows(t, N_DEV)
    bucketed = tp.bucket_columns(pc, N_DEV)
    same_arrays(bucketed[:3], bucketed_r[:3])
    assert bucketed[3] == bucketed_r[3]
    _, b_pad = _ring_dense(800, bucketed[3], N_DEV, 32, 1)
    want = rp.spmm_ring(bucketed_r, (1000, 800), pc.block_rows, jax.device_put(jnp.asarray(b_pad), NamedSharding(rmesh, P("x", None))), rmesh)
    dense = torch.from_numpy(b_pad)
    if dense_as == "dtensor":
        from torch.distributed.tensor import DTensor, Shard

        dense = DTensor.from_local(dense, mesh, [Shard(0)], run_check=False)
    close(tp.spmm_ring(bucketed, (1000, 800), pc.block_rows, dense, mesh), want)


def test_spmm_ring_checks_the_dense_block(mesh):
    _, t = both((100, 80), 0.05, 0)
    bucketed = tp.bucket_columns(tp.partition_coo_rows(t, 4), 4)
    with pytest.raises(ValueError, match="n_buckets \\* block_cols"):
        tp.spmm_ring(bucketed, (100, 80), 25, torch.zeros(80 - 1, 3, dtype=torch.float64), mesh)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_ring_ell(mesh, rmesh, dtype):
    m, k, n = 1100, 700, 8
    a, t = both((m, k), 0.03, 33, dtype)
    want_b = rp.bucket_columns_ell(a, N_DEV)
    bucketed = tp.bucket_columns_ell(t, N_DEV)
    same_arrays(bucketed[:3], want_b[:3])
    assert bucketed[3:] == want_b[3:]
    b, b_pad = _ring_dense(k, bucketed[4], N_DEV, n, 33, dtype)
    want = rp.spmm_ring_ell(want_b, m, jax.device_put(jnp.asarray(b_pad), NamedSharding(rmesh, P("x", None))), rmesh)
    got = tp.spmm_ring_ell(bucketed, m, b_pad, mesh)
    if dtype == np.float64:
        close(got, want)
    else:
        scaled_close(got, want, np.abs(a.todense()) @ np.abs(b), 1e-5)


def test_spmm_ring_ell_rejects_bucket_shard_mismatch(mesh, rmesh):
    a, t = both((256, 256), 0.05, 7, np.float32)
    with pytest.raises(ValueError, match="n_buckets"):
        rp.spmm_ring_ell(rp.bucket_columns_ell(a, 4), 256, jnp.zeros((4 * 64, 8), jnp.float32), rmesh)
    bucketed = tp.bucket_columns_ell(t, 4, n_buckets=2)
    with pytest.raises(ValueError, match="n_buckets"):
        tp.spmm_ring_ell(bucketed, 256, torch.zeros(2 * bucketed[4], 8), mesh)


@pytest.mark.parametrize("shape,density,n_shards", [((2100, 500), 0.02, 8), ((257, 130), 0.05, 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_sharded_ell(mesh, rmesh, shape, density, n_shards, dtype):
    a, t = both(shape, density, 27, dtype)
    part_r = rp.partition_spmm_ell(a, n_shards)
    part = tp.partition_spmm_ell(t, n_shards)
    same_arrays(part[:3], part_r[:3])
    assert part[3] == part_r[3]
    b = np.random.default_rng(27).random((shape[1], 16)).astype(dtype)
    want = rp.spmm_sharded_ell(*part_r[:3], jnp.asarray(b), shape[0], rmesh)
    got = tp.spmm_sharded_ell(*part[:3], b, shape[0], mesh)
    if dtype == np.float64:
        close(got, want)
    else:
        scaled_close(got, want, np.abs(a.todense()) @ np.abs(b), 1e-5)


def test_spmm_sharded_ell_empty_shard(mesh, rmesh):
    d = np.zeros((2048, 64))
    d[:10, :5] = np.random.default_rng(3).random((10, 5))
    a, t = sparse.COO.from_numpy(d), st.COO.from_numpy(d, device="cpu")
    b = np.random.default_rng(4).random((64, 4))
    part = tp.partition_spmm_ell(t, 8)
    same_arrays(part[:3], rp.partition_spmm_ell(a, 8)[:3])
    close(tp.spmm_sharded_ell(*part[:3], b, 2048, mesh), d @ b)


def _mesh_2d(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("x", "y")), Mesh(
        np.asarray(jax.devices()[:8]).reshape(shape), ("x", "y")
    )


@pytest.mark.parametrize("dense_as", ["dtensor", "tensor"])
def test_spmm_2d(mesh, dense_as):
    mesh2, rmesh2 = _mesh_2d((2, 4))
    a, t = both((200, 100), 0.05, 0)
    b = np.random.default_rng(1).random((100, 16))
    rpc = rp.partition_coo_rows(a, 2)
    sh = NamedSharding(rmesh2, P("x", None))
    placed = rp.PartitionedCOO(*(jax.device_put(jnp.asarray(np.asarray(x)), sh) for x in (rpc.rows, rpc.cols, rpc.data)), rpc.shape, rpc.block_rows)
    want = rp.spmm_2d(placed, jax.device_put(jnp.asarray(b), NamedSharding(rmesh2, P(None, "y"))), rmesh2)
    pc = tp.partition_coo_rows(t, 2, mesh=mesh2, axis_name="x")
    dense = torch.from_numpy(b)
    if dense_as == "dtensor":
        from torch.distributed.tensor import DTensor, Replicate, Shard

        dense = DTensor.from_local(dense, mesh2, [Replicate(), Shard(1)], run_check=False)
    close(tp.spmm_2d(pc, dense, mesh2), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_2d_ell(mesh, dtype):
    mesh2, rmesh2 = _mesh_2d((4, 2))
    a, t = both((1000, 300), 0.04, 35, dtype)
    b = np.random.default_rng(35).random((300, 16)).astype(dtype)
    part_r = rp.partition_spmm_ell(a, 4)
    want = rp.spmm_2d_ell(*part_r[:3], 1000, jnp.asarray(b), rmesh2)
    part = tp.partition_spmm_ell(t, 4)
    got = tp.spmm_2d_ell(*part[:3], 1000, b, mesh2)
    if dtype == np.float64:
        close(got, want)
    else:
        scaled_close(got, want, np.abs(a.todense()) @ np.abs(b), 1e-5)


# ---------------------------------------------------------------------------
# SDDMM, SpGEMM, MTTKRP
# ---------------------------------------------------------------------------


def _sddmm_scale(pc, lhs, rhs):
    """Each entry's ``|s| · Σ_k |lhs_ik · rhs_kj|`` (global rows from the
    partition's shard starts; padding entries read row 0)."""
    rows, cols, data = (host(x) for x in (pc.rows, pc.cols, pc.data))
    starts = pc.row_starts if pc.row_starts is not None else np.arange(pc.n_shards) * pc.block_rows
    grow = np.minimum(rows + starts[:, None], lhs.shape[0] - 1)
    return np.abs(data) * np.einsum("sek,sek->se", np.abs(lhs[grow]).astype(np.float64), np.abs(rhs.T[cols]).astype(np.float64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sddmm_sharded(mesh, rmesh, dtype):
    s, t = both((200, 150), 0.05, 6, dtype)
    rng = np.random.default_rng(1)
    lhs, rhs = rng.random((200, 8)).astype(dtype), rng.random((8, 150)).astype(dtype)
    want = np.asarray(rp.sddmm_sharded(rp.partition_coo_rows(s, N_DEV, mesh=rmesh), lhs, rhs, rmesh))
    pc = tp.partition_coo_rows(t, N_DEV, mesh=mesh)
    got = tp.sddmm_sharded(pc, lhs, torch.from_numpy(rhs), mesh)
    assert got.shape == want.shape and host(got).dtype == want.dtype
    if dtype == np.float64:
        close(got, want)
    else:
        scaled_close(got, want, _sddmm_scale(pc, lhs, rhs), 1e-5)


def test_sddmm_sharded_nnz_balanced(mesh):
    """On an nnz-balanced partition each shard takes ``lhs`` from its
    ``row_starts`` (the reference takes ``s · block_rows`` there, ROADMAP
    C2): against the dense product at the partition's entries."""
    s, t = both((200, 150), 0.05, 6)
    rng = np.random.default_rng(1)
    lhs, rhs = rng.random((200, 8)), rng.random((8, 150))
    pc = tp.partition_coo_rows(t, N_DEV, mesh=mesh, balance="nnz")
    rows, cols, data = (host(x) for x in (pc.rows, pc.cols, pc.data))
    grow = np.minimum(rows + pc.row_starts[:, None], 199)
    np.testing.assert_allclose(host(tp.sddmm_sharded(pc, lhs, rhs, mesh)), data * (lhs @ rhs)[grow, cols], rtol=1e-12)


def test_spgemm_sharded(mesh, rmesh):
    a, t = both((240, 60), 0.05, 0)
    b, tb = both((60, 80), 0.05, 1)
    rpc = rp.partition_coo_rows(a, N_DEV, mesh=rmesh)
    want = rp.spgemm_sharded(rpc, b, rmesh)
    pc = tp.partition_coo_rows(t, N_DEV, mesh=mesh)
    got = tp.spgemm_sharded(pc, tb, mesh)
    same_arrays(got[:2], want[:2])
    same_arrays(got[3:], [np.asarray(want[3]).astype(np.int64)])
    close(got[2], want[2])
    res = tp.assemble_spgemm_result(got, pc, 80)
    ref = rp.assemble_spgemm_result(want, rpc, 80)
    np.testing.assert_array_equal(res.coords.numpy(), np.asarray(ref.coords))
    close(res.data, ref.data)
    np.testing.assert_allclose(res.todense().numpy(), a.todense() @ b.todense(), rtol=1e-12)


def test_spgemm_sharded_capacities(mesh, rmesh):
    a, t = both((64, 40), 0.1, 4)
    b, tb = both((40, 30), 0.1, 5)
    want = rp.spgemm_sharded(rp.partition_coo_rows(a, N_DEV, mesh=rmesh), b, rmesh, product_capacity=64, out_capacity=48)
    got = tp.spgemm_sharded(tp.partition_coo_rows(t, N_DEV, mesh=mesh), tb, mesh, product_capacity=64, out_capacity=48)
    assert got[0].shape == (N_DEV, 48)
    same_arrays(got[:2], want[:2])
    close(got[2], want[2])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mttkrp_sharded(mesh, rmesh, dtype):
    m = 64
    t = sparse.random((m, 10, 12), density=0.05, random_state=2)
    coords, data = np.asarray(t.coords), np.asarray(t.data).astype(dtype)
    shards = mttkrp_shards(coords, data, m, N_DEV)
    c = np.random.default_rng(3).random((10, 4)).astype(dtype)
    d = np.random.default_rng(4).random((12, 4)).astype(dtype)
    want = np.asarray(rp.mttkrp_sharded(*(jnp.asarray(x) for x in shards), jnp.asarray(c), jnp.asarray(d), m, rmesh))
    got = tp.mttkrp_sharded(*shards, torch.from_numpy(c), torch.from_numpy(d), m, mesh)
    assert host(got).dtype == want.dtype
    tol = F64 if dtype == np.float64 else dict(rtol=1e-5, atol=0.0)
    close(got, want, **tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mttkrp_sharded_ell(mesh, rmesh, dtype):
    rng = np.random.default_rng(21)
    I, J, K, R = 2100, 40, 50, 8
    lin = np.unique(rng.integers(0, I * J * K, 30000))
    coords = np.stack([lin // (J * K), (lin // K) % J, lin % K]).astype(np.int32)
    tv = rng.random(lin.size).astype(dtype)
    C, D = rng.random((J, R)).astype(dtype), rng.random((K, R)).astype(dtype)
    part_r = rp.partition_mttkrp_ell(coords, tv, I, N_DEV)
    part = tp.partition_mttkrp_ell(coords, tv, I, N_DEV)
    same_arrays(part[:4], part_r[:4])
    assert part[4] == part_r[4]
    want = np.asarray(rp.mttkrp_sharded_ell(*part_r[:4], C, D, I, part_r[4], rmesh))
    got = tp.mttkrp_sharded_ell(*part[:4], C, D, I, part[4], mesh)
    tol = F64 if dtype == np.float64 else dict(rtol=1e-5, atol=0.0)
    close(got, want, **tol)
    # coordinates given as a tensor partition the same
    same_arrays(tp.partition_mttkrp_ell(torch.from_numpy(coords), torch.from_numpy(tv), I, N_DEV)[:4], part_r[:4])


def test_mttkrp_sharded_ell_bf16(mesh, rmesh):
    rng = np.random.default_rng(23)
    I, J, K, R = 1000, 30, 20, 8
    lin = np.unique(rng.integers(0, I * J * K, 8000))
    coords = np.stack([lin // (J * K), (lin // K) % J, lin % K]).astype(np.int32)
    tv = rng.random(lin.size).astype(np.float32)
    C, D = rng.random((J, R)).astype(np.float32), rng.random((K, R)).astype(np.float32)
    part = tp.partition_mttkrp_ell(coords, tv, I, N_DEV)
    part_r = rp.partition_mttkrp_ell(coords, tv, I, N_DEV)
    want = np.asarray(rp.mttkrp_sharded_ell(*part_r[:4], C, D, I, part_r[4], rmesh, strategy="bf16"))
    close(tp.mttkrp_sharded_ell(*part[:4], C, D, I, part[4], mesh, strategy="bf16"), want, rtol=1e-5, atol=1e-6)


def test_mttkrp_sharded_ell_empty_shard(mesh, rmesh):
    rng = np.random.default_rng(22)
    I, J, K, R = 1024, 10, 12, 4
    ci, cj, ck = rng.integers(0, 100, 500), rng.integers(0, J, 500), rng.integers(0, K, 500)
    lin = np.unique(ci * J * K + cj * K + ck)
    coords = np.stack([lin // (J * K), (lin // K) % J, lin % K]).astype(np.int32)
    tv = rng.random(lin.size)
    C, D = rng.random((J, R)), rng.random((K, R))
    part = tp.partition_mttkrp_ell(coords, tv, I, 8)
    part_r = rp.partition_mttkrp_ell(coords, tv, I, 8)
    want = np.asarray(rp.mttkrp_sharded_ell(*part_r[:4], C, D, I, part_r[4], rmesh))
    close(tp.mttkrp_sharded_ell(*part[:4], C, D, I, part[4], mesh), want)


# ---------------------------------------------------------------------------
# element-wise and reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("funcs", [(torch.add, jnp.add), (torch.multiply, jnp.multiply), (torch.maximum, jnp.maximum), (torch.subtract, jnp.subtract)])
def test_elemwise_partitioned(mesh, rmesh, funcs):
    a, ta = both((70, 40), 0.15, 1)
    b, tb = both((70, 40), 0.15, 2)
    f, jf = funcs
    out_r, nnz_r = rp.elemwise_partitioned(jf, *(rp.partition_coo_rows(x, N_DEV, mesh=rmesh) for x in (a, b)), rmesh)
    out, nnz = tp.elemwise_partitioned(f, *(tp.partition_coo_rows(x, N_DEV, mesh=mesh) for x in (ta, tb)), mesh)
    same_arrays((out.rows, out.cols, out.data, nnz), (out_r.rows, out_r.cols, out_r.data, np.asarray(nnz_r).astype(np.int64)))
    assert out.shape == out_r.shape and out.block_rows == out_r.block_rows and out.row_starts is None


def test_elemwise_partitioned_same_pattern_nnz_balanced(mesh, rmesh):
    a, ta = both((70, 40), 0.15, 1)
    b = sparse.COO(np.asarray(a.coords), np.asarray(a.data) * 3 - 1, shape=a.shape)
    tb = st.COO(np.asarray(b.coords), np.asarray(b.data), shape=b.shape, device="cpu")
    out_r, nnz_r = rp.elemwise_partitioned(jnp.add, *(rp.partition_coo_rows(x, N_DEV, mesh=rmesh, balance="nnz") for x in (a, b)), rmesh)
    out, nnz = tp.elemwise_partitioned(torch.add, *(tp.partition_coo_rows(x, N_DEV, mesh=mesh, balance="nnz") for x in (ta, tb)), mesh)
    same_arrays((out.rows, out.cols, out.data, nnz), (out_r.rows, out_r.cols, out_r.data, np.asarray(nnz_r).astype(np.int64)))
    np.testing.assert_array_equal(out.row_starts, out_r.row_starts)
    np.testing.assert_allclose(tp.sum_partitioned(out, mesh, axis=1).numpy(), (a.todense() + b.todense()).sum(1), rtol=1e-12)


def test_elemwise_partitioned_rejects_bad_funcs_and_partitions(mesh):
    _, ta = both((70, 40), 0.15, 1)
    _, tb = both((70, 40), 0.15, 2)
    pa, pb = tp.partition_coo_rows(ta, 8, mesh=mesh), tp.partition_coo_rows(tb, 8, mesh=mesh)
    with pytest.raises(ValueError, match="func"):
        tp.elemwise_partitioned(torch.logaddexp, pa, pb, mesh)
    with pytest.raises(ValueError, match="partition"):
        tp.elemwise_partitioned(torch.add, pa, tp.partition_coo_rows(tb, 8, mesh=mesh, balance="nnz"), mesh)
    with pytest.raises(ValueError, match="partitioning"):
        tp.elemwise_partitioned(torch.add, pa, tp.partition_coo_rows(tb, 4, mesh=mesh), mesh)


@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("axis", [0, 1, None])
def test_sum_partitioned(mesh, rmesh, balance, axis):
    a, t = both((70, 40), 0.15, 5)
    want = rp.sum_partitioned(rp.partition_coo_rows(a, N_DEV, mesh=rmesh, balance=balance), rmesh, axis=axis)
    got = tp.sum_partitioned(tp.partition_coo_rows(t, N_DEV, mesh=mesh, balance=balance), mesh, axis=axis)
    assert got.shape == np.shape(want)
    close(got, want)
    np.testing.assert_allclose(host(got), a.todense().sum(axis=axis), rtol=1e-12)


def test_sum_partitioned_is_a_shard_order_sum(mesh):
    _, t = both((300, 50), 0.1, 9)
    pc = tp.partition_coo_rows(t, N_DEV, mesh=mesh)
    parts = pc.data.full_tensor().sum(1)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    assert torch.equal(tp.sum_partitioned(pc, mesh), total)
    with pytest.raises(ValueError, match="axis"):
        tp.sum_partitioned(pc, mesh, axis=2)


# ---------------------------------------------------------------------------
# checkpoint and interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_checkpoint_roundtrip(tmp_path, mesh, balance):
    a, t = both((200, 100), 0.05, 9)
    pc = tp.partition_coo_rows(t, N_DEV, mesh=mesh, balance=balance)
    tck.save_partitioned(str(tmp_path / "ckpt"), pc)
    restored = tck.load_partitioned(str(tmp_path / "ckpt"), mesh=mesh)
    same_partition(restored, rp.partition_coo_rows(a, N_DEV, balance=balance))
    assert type(restored.rows).__name__ == "DTensor"
    b = np.random.default_rng(1).random((100, 4))
    close(tp.spmm_replicated(restored, b, mesh), a.todense() @ b)
    host_copy = tck.load_partitioned(str(tmp_path / "ckpt"))
    assert isinstance(host_copy.rows, torch.Tensor) and type(host_copy.rows).__name__ == "Tensor"
    same_partition(host_copy, rp.partition_coo_rows(a, N_DEV, balance=balance))


def test_checkpoint_restores_8_shards_onto_fewer_ranks(tmp_path, mesh):
    """8 shards saved, restored onto this world (one rank holding all 8);
    the restore onto 4 ranks is tests/test_torch_parallel_multiprocess.py's."""
    a, t = both((160, 50), 0.1, 3)
    tck.save_partitioned(str(tmp_path / "ck"), tp.partition_coo_rows(t, N_DEV))
    restored = tck.load_partitioned(str(tmp_path / "ck"), mesh=mesh)
    assert restored.rows.to_local().shape[0] == 8
    b = np.random.default_rng(2).random((50, 4))
    close(tp.spmm_replicated(restored, b, mesh), a.todense() @ b)


def test_checkpoint_files_cross_packages(tmp_path, monkeypatch):
    import builtins

    import sparse_tpu.checkpoint as rck

    a, t = both((40, 30), 0.2, 0)
    # the port's files load in the reference (its npz reader)
    tck.save_partitioned(str(tmp_path / "port"), tp.partition_coo_rows(t, 4, balance="nnz"))
    same_partition(tp.partition_coo_rows(t, 4, balance="nnz"), rck.load_partitioned(str(tmp_path / "port")))
    # the reference's npz layout (orbax unavailable) loads in the port
    real_import = builtins.__import__

    def no_orbax(name, *args, **kwargs):
        if name.startswith("orbax"):
            raise ImportError("no orbax")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_orbax)
    rck.save_partitioned(str(tmp_path / "ref"), rp.partition_coo_rows(a, 4))
    monkeypatch.undo()
    same_partition(tck.load_partitioned(str(tmp_path / "ref")), rp.partition_coo_rows(a, 4))


def test_interop_partitions(mesh, rmesh):
    a, _ = both((300, 200), 0.05, 11)
    b = np.random.default_rng(11).random((200, 6))
    rpc = rp.partition_coo_rows(a, N_DEV, balance="nnz")
    pc = partitioned_coo_from_arrays(np.asarray(rpc.rows), np.asarray(rpc.cols), np.asarray(rpc.data), rpc.shape, rpc.block_rows, rpc.row_starts)
    same_partition(pc, rpc)
    close(tp.spmm_replicated(pc, b, mesh), rp.spmm_replicated(rpc, jnp.asarray(b), rmesh))
    part_r = rp.partition_spmm_ell(a, N_DEV)
    part = ell_partition_from_arrays(*part_r)
    assert isinstance(part[3], int) and part[3] == part_r[3]
    close(tp.spmm_sharded_ell(*part[:3], b, 300, mesh), rp.spmm_sharded_ell(*part_r[:3], jnp.asarray(b), 300, rmesh))
    rng = np.random.default_rng(12)
    lin = np.unique(rng.integers(0, 500 * 20 * 30, 3000))
    coords = np.stack([lin // 600, (lin // 30) % 20, lin % 30])
    tv = rng.random(lin.size)
    C, D = rng.random((20, 4)), rng.random((30, 4))
    mt_r = rp.partition_mttkrp_ell(coords, tv, 500, N_DEV)
    mt = ell_partition_from_arrays(*mt_r)
    close(tp.mttkrp_sharded_ell(*mt[:4], C, D, 500, mt[4], mesh), rp.mttkrp_sharded_ell(*mt_r[:4], C, D, 500, mt_r[4], rmesh))
