"""The multi-device layer on integer and bool data against sparse_tpu's (CPU).

Every data-carrying function of ``sparse_tpu_torch.parallel`` at int8,
int16, uint8, uint16, uint32, uint64 and bool, in an in-process gloo world
of one, against ``sparse_tpu.parallel`` on ``conftest.py``'s 8 virtual
devices: the same arrays, dtypes and values. gloo's collectives refuse
int16, uint16, uint32 and uint64, which travel as their bytes;
``sum_partitioned`` totals bool and integers in NumPy's sum dtype (int64,
uint64 for the unsigned) over axis 0 and ``None``; where the reference's
segment sums refuse bool data (the COO products, the sums over an axis),
the port gives NumPy's answer (ROADMAP §C2), held against NumPy.
``elemwise_partitioned`` runs ``bitwise_or`` (torch has no CPU ``add`` for
uint16/32/64; the caller's function takes tensors, ROADMAP §C2) and
``add`` where torch has it. Values
are 1-99 (dense operands 0-4), so narrow sums overflow as they do in the
reference. The MTTKRPs at these dtypes are in
``tests/test_torch_mttkrp_dtypes.py``.
"""

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

N_DEV = 8
DTYPES = [np.int8, np.int16, np.uint8, np.uint16, np.uint32, np.uint64, np.bool_]
IDS = [np.dtype(d).name for d in DTYPES]


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


def both(dtype, shape=(64, 40), density=0.3, seed=0):
    """A matrix of values 1-99 as a ``sparse_tpu`` COO and a port COO on the CPU."""
    rng = np.random.default_rng(seed)
    dense = rng.integers(1, 100, shape) * (rng.random(shape) < density)
    r, c = np.nonzero(dense)
    d = dense[r, c].astype(dtype)
    return sparse.COO(np.stack([r, c]), d, shape=shape), st.COO(np.stack([r, c]), d, shape=shape, device="cpu")


def operand(dtype, shape, seed):
    return np.random.default_rng(seed).integers(0, 5, shape).astype(dtype)


def host(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(got, want):
    gs = got if isinstance(got, (tuple, list)) else (got,)
    ws = want if isinstance(want, (tuple, list)) else (want,)
    assert len(gs) == len(ws)
    for g, w in zip(gs, ws):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def against(port, ref, oracle):
    """``port()`` equals ``ref()``; where the reference refuses bool data
    (``TypeError`` from JAX's segment sums), ``oracle()``: NumPy's answer,
    which the port keeps (ROADMAP §C2)."""
    try:
        want = ref()
    except TypeError:
        want = oracle()
    same(port(), want)


def _ring_dense(b, block_cols, n_buckets):
    b_pad = np.zeros((n_buckets * block_cols, b.shape[1]), dtype=b.dtype)
    b_pad[: b.shape[0]] = b
    return b_pad


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_partitioners(dtype):
    a, t = both(dtype)
    for balance in ("rows", "nnz"):
        rpc, tpc = rp.partition_coo_rows(a, N_DEV, balance=balance), tp.partition_coo_rows(t, N_DEV, balance=balance)
        same((tpc.rows, tpc.cols, tpc.data), (rpc.rows, rpc.cols, rpc.data))
    same(tp.bucket_columns(tp.partition_coo_rows(t, N_DEV), N_DEV)[:3], rp.bucket_columns(rp.partition_coo_rows(a, N_DEV), N_DEV)[:3])
    same(tp.bucket_columns_ell(t, N_DEV)[:3], rp.bucket_columns_ell(a, N_DEV)[:3])
    same(tp.partition_spmm_ell(t, N_DEV)[:3], rp.partition_spmm_ell(a, N_DEV)[:3])
    coords = np.stack([np.asarray(a.coords[0]), np.asarray(a.coords[1]) % 8, np.asarray(a.coords[1]) // 8])
    same(tp.partition_mttkrp_ell(coords, np.asarray(a.data), 64, N_DEV)[:4], rp.partition_mttkrp_ell(coords, np.asarray(a.data), 64, N_DEV)[:4])
    kw = dict(nnz=200, n_shards=N_DEV, random_state=0, data_rvs=lambda k: np.arange(k) % 100 + 1, dtype=dtype)
    same(tp.random_partitioned((40, 24), **kw).data, rp.random_partitioned((40, 24), **kw).data)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_spmm_replicated_and_spmm_2d(mesh, rmesh, dtype):
    a, t = both(dtype)
    b = operand(dtype, (40, 4), 1)
    product = lambda: a.todense() @ b  # noqa: E731  (bool: NumPy's "or" of "and"s)
    against(
        lambda: tp.spmm_replicated(tp.partition_coo_rows(t, N_DEV, mesh=mesh), b, mesh),
        lambda: rp.spmm_replicated(rp.partition_coo_rows(a, N_DEV, mesh=rmesh), jnp.asarray(b), rmesh),
        product,
    )
    from torch.distributed.device_mesh import DeviceMesh

    mesh2 = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("x", "y"))
    rmesh2 = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("x", "y"))

    def ref_2d():
        pc = rp.partition_coo_rows(a, 2)
        sh = NamedSharding(rmesh2, P("x", None))
        placed = rp.PartitionedCOO(*(jax.device_put(jnp.asarray(np.asarray(x)), sh) for x in (pc.rows, pc.cols, pc.data)), pc.shape, pc.block_rows)
        return rp.spmm_2d(placed, jax.device_put(jnp.asarray(b), NamedSharding(rmesh2, P(None, "y"))), rmesh2)

    against(lambda: tp.spmm_2d(tp.partition_coo_rows(t, 2), b, mesh2), ref_2d, product)
    ell_r, ell_t = rp.partition_spmm_ell(a, 2), tp.partition_spmm_ell(t, 2)
    same(
        tp.spmm_2d_ell(*ell_t[:3], 64, b, mesh2),
        rp.spmm_2d_ell(*ell_r[:3], 64, jax.device_put(jnp.asarray(b), NamedSharding(rmesh2, P(None, "y"))), rmesh2),
    )


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_rings_and_the_sharded_ell_spmm(mesh, rmesh, dtype):
    a, t = both(dtype)
    b = operand(dtype, (40, 3), 2)
    bk_r, bk_t = rp.bucket_columns(rp.partition_coo_rows(a, N_DEV), N_DEV), tp.bucket_columns(tp.partition_coo_rows(t, N_DEV), N_DEV)
    b_pad = _ring_dense(b, bk_t[3], N_DEV)
    sharded = NamedSharding(rmesh, P("x", None))
    against(
        lambda: tp.spmm_ring(bk_t, (64, 40), 8, b_pad, mesh),
        lambda: rp.spmm_ring(bk_r, (64, 40), 8, jax.device_put(jnp.asarray(b_pad), sharded), rmesh),
        lambda: a.todense() @ b,
    )
    be_r, be_t = rp.bucket_columns_ell(a, N_DEV), tp.bucket_columns_ell(t, N_DEV)
    b_pad = _ring_dense(b, be_t[4], N_DEV)
    same(tp.spmm_ring_ell(be_t, 64, b_pad, mesh), rp.spmm_ring_ell(be_r, 64, jax.device_put(jnp.asarray(b_pad), sharded), rmesh))
    pe_r, pe_t = rp.partition_spmm_ell(a, N_DEV), tp.partition_spmm_ell(t, N_DEV)
    same(tp.spmm_sharded_ell(*pe_t[:3], b, 64, mesh), rp.spmm_sharded_ell(*pe_r[:3], jnp.asarray(b), 64, rmesh))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_sddmm_sharded(mesh, rmesh, dtype):
    a, t = both(dtype)
    lhs, rhs = operand(dtype, (64, 3), 3), operand(dtype, (3, 40), 4)
    got = tp.sddmm_sharded(tp.partition_coo_rows(t, N_DEV, mesh=mesh), lhs, rhs, mesh)
    same(got, rp.sddmm_sharded(rp.partition_coo_rows(a, N_DEV, mesh=rmesh), lhs, rhs, rmesh))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_spgemm_sharded(mesh, rmesh, dtype):
    a, t = both(dtype)
    coords = np.asarray(a.coords)[::-1].copy()
    b_r = sparse.COO(coords, np.asarray(a.data), shape=(40, 64))
    b_t = st.COO(coords, np.asarray(a.data), shape=(40, 64), device="cpu")
    rpc, tpc = rp.partition_coo_rows(a, N_DEV, mesh=rmesh), tp.partition_coo_rows(t, N_DEV, mesh=mesh)
    want = rp.spgemm_sharded(rpc, b_r, rmesh)
    got = tp.spgemm_sharded(tpc, b_t, mesh)
    same(got[:3], want[:3])
    np.testing.assert_array_equal(host(got[3]), np.asarray(want[3]))
    res, ref = tp.assemble_spgemm_result(got, tpc, 64), rp.assemble_spgemm_result(want, rpc, 64)
    same((res.coords, res.data), (ref.coords, ref.data))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_elemwise_partitioned(mesh, rmesh, dtype):
    a, t = both(dtype)
    a2, t2 = both(dtype, seed=1)
    pairs = [(torch.bitwise_or, jnp.bitwise_or)]
    if dtype in (np.int8, np.int16, np.uint8, np.bool_):
        pairs.append((torch.add, jnp.add))
    for tf, jf in pairs:
        got, nnz = tp.elemwise_partitioned(tf, tp.partition_coo_rows(t, N_DEV, mesh=mesh), tp.partition_coo_rows(t2, N_DEV, mesh=mesh), mesh)
        want, rnnz = rp.elemwise_partitioned(jf, rp.partition_coo_rows(a, N_DEV, mesh=rmesh), rp.partition_coo_rows(a2, N_DEV, mesh=rmesh), rmesh)
        same((got.rows, got.cols, got.data), (want.rows, want.cols, want.data))
        np.testing.assert_array_equal(host(nnz), np.asarray(rnnz))


@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("axis", [0, 1, None])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_sum_partitioned(mesh, rmesh, dtype, axis, balance):
    a, t = both(dtype)
    against(
        lambda: tp.sum_partitioned(tp.partition_coo_rows(t, N_DEV, mesh=mesh, balance=balance), mesh, axis=axis),
        lambda: rp.sum_partitioned(rp.partition_coo_rows(a, N_DEV, mesh=rmesh, balance=balance), rmesh, axis=axis),
        # bool: counts over axis 0 (NumPy's sum), "any" within a row (the data's dtype)
        lambda: a.todense().sum(axis=0) if axis == 0 else a.todense().any(axis=1),
    )


def test_sum_partitioned_totals_int8_in_int64(mesh):
    """int8 values 1-99: the total as int64, not wrapped in int8."""
    a, t = both(np.int8)
    total = tp.sum_partitioned(tp.partition_coo_rows(t, N_DEV, mesh=mesh), mesh)
    assert total.dtype == torch.int64 and int(total) == int(np.asarray(a.data).astype(np.int64).sum()) > 127


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_checkpoint_roundtrip(tmp_path, mesh, dtype):
    _, t = both(dtype)
    pc = tp.partition_coo_rows(t, N_DEV, mesh=mesh)
    tck.save_partitioned(str(tmp_path / "ck"), pc)
    back = tck.load_partitioned(str(tmp_path / "ck"), mesh=mesh)
    same((back.rows, back.cols, back.data), (host(pc.rows), host(pc.cols), host(pc.data)))
