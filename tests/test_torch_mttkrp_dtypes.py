"""MTTKRP of integer and bool data against ``sparse_tpu``'s (ROADMAP §C1.4).

Every MTTKRP entry point of the port at int8, int16, uint8, uint16, uint32,
uint64 and bool (the dtypes of ``tests/test_torch_parallel_dtypes.py``):
``kernels.dot.mttkrp`` and ``mttkrp_plain``, ``kernels.ell.ell_mttkrp`` in
its three strategies and ``ell_mttkrp_plain``, ``jitops.mttkrp``, and
``parallel.mttkrp_sharded``/``mttkrp_sharded_ell`` in an in-process gloo
world of one against ``sparse_tpu.parallel`` on ``conftest.py``'s 8
virtual devices. Products and sums are in NumPy's promoted dtype, modulo
its width (data 1-99 and factors 0-4 overflow the narrow types as they do
in the reference), so every result is exact. Bool follows the reference
entry point by entry point: its segment-sum MTTKRP (``mttkrp``,
``mttkrp_sharded``, ``jitops.mttkrp``) raises ``TypeError``, its block-ELL
form sums as "or". The kernels keep float32/float64; on the GPU the dtype
sends these calls to the plain version before any launch
(``kernels.dot.on_kernel``).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import sparse_tpu as sparse
import sparse_tpu.parallel as rp
from sparse_tpu import jitops as rjit
from sparse_tpu.kernels import dot as rdot
from sparse_tpu.kernels import ell as rell
import sparse_tpu_torch as st
import sparse_tpu_torch.parallel as tp
from sparse_tpu_torch import jitops as tjit
from sparse_tpu_torch.kernels import dot as tdot
from sparse_tpu_torch.kernels import ell as tell

N_DEV = 8
DTYPES = [np.int8, np.int16, np.uint8, np.uint16, np.uint32, np.uint64, np.bool_]
IDS = [np.dtype(d).name for d in DTYPES]
N_ROWS, J, K, R = 30, 9, 7, 5


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


def _tensor(seed, dtype, n=200):
    """A sorted 3-D COO triplet: values 1-99 in ``dtype``, and factors 0-4."""
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, N_ROWS * J * K, n))
    coords = np.stack([lin // (J * K), (lin // K) % J, lin % K]).astype(np.int32)
    data = rng.integers(1, 100, lin.size).astype(dtype)
    c = rng.integers(0, 5, (J, R)).astype(dtype)
    d = rng.integers(0, 5, (K, R)).astype(dtype)
    return coords, data, c, d


def _reference(coords, data, c, d):
    return rdot.mttkrp(*(jnp.asarray(x) for x in (*coords, data, c, d)), n_rows=N_ROWS)


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_mttkrp_matches_sparse_tpu(dtype):
    coords, data, c, d = _tensor(1, dtype)
    args = (*(_t(x) for x in coords), _t(data), _t(c), _t(d))
    if dtype == np.bool_:
        with pytest.raises(TypeError):
            _reference(coords, data, c, d)
        with pytest.raises(TypeError, match="bool"):
            tdot.mttkrp(*args, n_rows=N_ROWS)
        return
    want = _reference(coords, data, c, d)
    _same(tdot.mttkrp(*args, n_rows=N_ROWS), want)
    _same(tdot.mttkrp_plain(*args, n_rows=N_ROWS), want)


@pytest.mark.parametrize("strategy", ["exact", "hilo", "bf16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_ell_mttkrp_matches_sparse_tpu(dtype, strategy):
    coords, data, c, d = _tensor(2, dtype)
    lay_r = rell.build_block_ell_3d(*coords, data, N_ROWS)
    lay = tell.build_block_ell_3d(*coords, data, N_ROWS, device="cpu")
    want = rell.ell_mttkrp(*lay_r[:4], jnp.asarray(c), jnp.asarray(d), n_rows=N_ROWS, strategy=strategy)
    _same(tell.ell_mttkrp(*lay[:4], _t(c), _t(d), n_rows=N_ROWS, strategy=strategy), want)
    _same(tell.ell_mttkrp_plain(*lay[:4], _t(c), _t(d), n_rows=N_ROWS, strategy=strategy), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_jitops_mttkrp_matches_sparse_tpu(dtype):
    coords, data, c, d = _tensor(3, dtype)
    t = st.COO(coords, data, shape=(N_ROWS, J, K), device="cpu")
    r = sparse.COO(coords, data, shape=(N_ROWS, J, K))
    if dtype == np.bool_:
        with pytest.raises(TypeError):
            rjit.mttkrp(r, jnp.asarray(c), jnp.asarray(d))
        with pytest.raises(TypeError):
            tjit.mttkrp(t, c, d)
        return
    _same(tjit.mttkrp(t, c, d), rjit.mttkrp(r, jnp.asarray(c), jnp.asarray(d)))


@pytest.mark.parametrize(
    "data_dt,factor_dt",
    [(np.int8, np.int16), (np.uint8, np.int8), (np.uint16, np.uint32), (np.int16, np.uint64), (np.bool_, np.int8)],
)
def test_mixed_integer_dtypes_promote_as_numpy(data_dt, factor_dt):
    coords, data, c, d = _tensor(4, data_dt)
    c, d = c.astype(factor_dt), d.astype(factor_dt)
    want = _reference(coords, data, c, d)
    got = tdot.mttkrp(*(_t(x) for x in coords), _t(data), _t(c), _t(d), n_rows=N_ROWS)
    assert got.numpy().dtype == np.promote_types(np.promote_types(data_dt, factor_dt), factor_dt)
    _same(got, want)


def test_float_data_with_integer_factors_is_float():
    coords, data, c, d = _tensor(5, np.int16)
    data = data.astype(np.float32)
    got = tdot.mttkrp(*(_t(x) for x in coords), _t(data), _t(c), _t(d), n_rows=N_ROWS)
    assert got.dtype == torch.float32
    want = _reference(coords, data, c, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_other_dtypes_still_raise():
    coords, data, c, d = _tensor(6, np.int16)
    args = [_t(x) for x in coords]
    for dt in (torch.bfloat16, torch.float16, torch.complex64):
        with pytest.raises(TypeError):
            tdot.mttkrp(*args, _t(data).to(dt), _t(c).to(dt), _t(d).to(dt), n_rows=N_ROWS)


def test_the_route_is_decided_by_dtype_before_any_launch():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for dt in (torch.int8, torch.uint64, torch.bool, torch.int64):
        assert not tdot.on_kernel(cuda, dt) and not tdot.on_kernel(cpu, dt)
    for dt in (torch.float32, torch.float64):
        assert tdot.on_kernel(cuda, dt) and not tdot.on_kernel(cpu, dt)


def _shards(coords, data, n_shards):
    """tests/test_parallel.py:61's i-partition: local rows, zero padding."""
    block_rows = -(-N_ROWS // n_shards)
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


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_mttkrp_sharded_matches_sparse_tpu(mesh, rmesh, dtype):
    coords, data, c, d = _tensor(7, dtype)
    shards = _shards(coords, data, N_DEV)
    if dtype == np.bool_:
        with pytest.raises(TypeError):
            rp.mttkrp_sharded(*(jnp.asarray(x) for x in shards), jnp.asarray(c), jnp.asarray(d), N_ROWS, rmesh)
        with pytest.raises(TypeError):
            tp.mttkrp_sharded(*(_t(x) for x in shards), _t(c), _t(d), N_ROWS, mesh)
        return
    want = rp.mttkrp_sharded(*(jnp.asarray(x) for x in shards), jnp.asarray(c), jnp.asarray(d), N_ROWS, rmesh)
    _same(tp.mttkrp_sharded(*(_t(x) for x in shards), _t(c), _t(d), N_ROWS, mesh), want)


@pytest.mark.parametrize("strategy", ["exact", "bf16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_mttkrp_sharded_ell_matches_sparse_tpu(mesh, rmesh, dtype, strategy):
    coords, data, c, d = _tensor(8, dtype, n=600)
    part_r = rp.partition_mttkrp_ell(coords, data, N_ROWS, N_DEV)
    part = tp.partition_mttkrp_ell(coords, data, N_ROWS, N_DEV)
    want = rp.mttkrp_sharded_ell(*part_r[:4], c, d, N_ROWS, part_r[4], rmesh, strategy=strategy)
    _same(tp.mttkrp_sharded_ell(*part[:4], _t(c), _t(d), N_ROWS, part[4], mesh, strategy=strategy), want)
