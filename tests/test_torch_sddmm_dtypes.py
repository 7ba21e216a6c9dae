"""SDDMM of integer and bool operands against sparse_tpu's (CPU).

The reference multiplies in the operands' dtype and sums with ``jnp.sum``,
which sums int8, int32 and bool in int64 and uint8 in uint64, and returns
that dtype. The port's plain version (these dtypes never reach K4) does the
same at every entry point: ``sparse_tpu_torch.sddmm``, ``kernels.sddmm``
(also above its chunking threshold), ``jitops.sddmm`` and
``parallel.sddmm_sharded``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import sparse_tpu as sparse
import sparse_tpu.parallel as rp
import sparse_tpu_torch as st
import sparse_tpu_torch.parallel as tp
from sparse_tpu import jitops as rjit
from sparse_tpu.kernels import dot as rdot
from sparse_tpu_torch import jitops as tjit
from sparse_tpu_torch.kernels import dot as tdot

DTYPES = [np.int8, np.int32, np.uint8, np.bool_]
IDS = [np.dtype(d).name for d in DTYPES]


def operands(dtype, m=30, k=5, n=20, nnz=90, seed=0, high=100):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * n, nnz))
    rows, cols = lin // n, lin % n
    draw = (lambda shape: rng.random(shape) < 0.5) if dtype == np.bool_ else (lambda shape: rng.integers(1, high, shape))
    return rows, cols, draw(lin.size).astype(dtype), draw((m, k)).astype(dtype), draw((k, n)).astype(dtype)


def same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_kernels_sddmm(dtype):
    rows, cols, s, lhs, rhs = operands(dtype)
    want = rdot.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(s), jnp.asarray(lhs), jnp.asarray(rhs))
    same(tdot.sddmm(*(torch.from_numpy(x) for x in (rows, cols, s, lhs, rhs))), want)
    same(tdot.sddmm_plain(*(torch.from_numpy(x) for x in (rows, cols, s, lhs, rhs))), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_kernels_sddmm_in_chunks(dtype):
    """Past ``SDDMM_CHUNK_MIN_NNZ`` entries the plain version runs in chunks."""
    rows, cols, s, lhs, rhs = operands(dtype, m=1000, k=3, n=1000, nnz=tdot.SDDMM_CHUNK_MIN_NNZ + 20000, seed=1)
    assert rows.size >= tdot.SDDMM_CHUNK_MIN_NNZ
    want = rdot.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(s), jnp.asarray(lhs), jnp.asarray(rhs))
    same(tdot.sddmm_plain(*(torch.from_numpy(x) for x in (rows, cols, s, lhs, rhs))), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_sddmm_entry_points(dtype):
    rows, cols, s, lhs, rhs = operands(dtype, seed=2)
    coords = np.stack([rows, cols])
    a, t = sparse.COO(coords, s, shape=(30, 20)), st.COO(coords, s, shape=(30, 20), device="cpu")
    want = sparse.sddmm(a, lhs, rhs)
    got = st.sddmm(t, torch.from_numpy(lhs), torch.from_numpy(rhs))
    same(got.coords, want.coords)
    same(got.data, want.data)
    assert np.asarray(got.fill_value).dtype == np.asarray(want.fill_value).dtype
    want_j = rjit.sddmm(a, jnp.asarray(lhs), jnp.asarray(rhs))
    got_j = tjit.sddmm(t, lhs, rhs)
    same(got_j.data, want_j.data)


def test_int32_sums_do_not_wrap():
    """Four products of 40,000 × 40,000 in a row: 6,400,000,000 as int64."""
    ones = np.ones(1, np.int32)
    lhs = np.full((1, 4), 40_000, np.int32)
    rhs = np.full((4, 1), 40_000, np.int32)
    zeros = np.zeros(1, np.int64)
    got = tdot.sddmm(*(torch.from_numpy(x) for x in (zeros, zeros, ones, lhs, rhs)))
    assert got.dtype == torch.int64 and int(got[0]) == 6_400_000_000
    same(got, rdot.sddmm(jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(ones), jnp.asarray(lhs), jnp.asarray(rhs)))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32], ids=["uint16", "uint32"])
def test_wide_unsigned_zero_extend(dtype):
    """uint16 and uint32 operands and samples at or above the sign bit: the
    products wrap in the operands' width and then widen without their sign."""
    bits = 8 * np.dtype(dtype).itemsize
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 30, 90), rng.integers(0, 20, 90)
    draw = lambda shape: rng.integers(1 << (bits - 1), 1 << bits, shape, dtype=np.uint64).astype(dtype)
    s, lhs, rhs = draw(90), draw((30, 5)), draw((5, 20))
    want = rdot.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(s), jnp.asarray(lhs), jnp.asarray(rhs))
    args = [torch.from_numpy(x) for x in (rows, cols)] + [torch.from_numpy(x.view(f"int{bits}")).view(getattr(torch, f"uint{bits}")) for x in (s, lhs, rhs)]
    same(tdot.sddmm(*args).view(torch.int64), np.asarray(want).view(np.int64))
    same(tdot.sddmm_plain(*args).view(torch.int64), np.asarray(want).view(np.int64))
    assert tdot.sddmm(*args).dtype == torch.uint64 and np.asarray(want).dtype == np.uint64


@pytest.mark.parametrize("dtype", [np.int32], ids=["int32"])
def test_sddmm_sharded(tmp_path, dtype):
    rows, cols, s, lhs, rhs = operands(dtype, m=64, n=40, nnz=300, seed=3)
    coords = np.stack([rows, cols])
    a, t = sparse.COO(coords, s, shape=(64, 40)), st.COO(coords, s, shape=(64, 40), device="cpu")
    rmesh = rp.make_mesh(8)
    want = rp.sddmm_sharded(rp.partition_coo_rows(a, 8, mesh=rmesh), lhs, rhs, rmesh)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = tp.make_mesh(device="cpu")
        got = tp.sddmm_sharded(tp.partition_coo_rows(t, 8, mesh=mesh), lhs, rhs, mesh)
    finally:
        dist.destroy_process_group()
    same(got, want)
