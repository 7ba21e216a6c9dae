"""The multi-device layer on the card: NCCL in a world of one.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_parallel_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). One process group
for the module, from an in-process ``HashStore``; the rank holds every
shard. Each shard's kernel (E2 through ``mttkrp_sharded_ell``, K3 through
``mttkrp_sharded``, K4 through ``sddmm_sharded``) is held against its plain
version shard by shard and launched once a shard; the torch-op products
against the dense product on the card; the rest against the host. A child
process finds out whether NCCL takes a send to the same rank (the ring
never posts one).
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import sparse_tpu_torch as st
import sparse_tpu_torch.parallel as tp
from sparse_tpu_torch import checkpoint as tck
from sparse_tpu_torch import profiling
from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from sparse_tpu_torch.kernels import dot, ell

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tp.make_mesh()
    finally:
        dist.destroy_process_group()


def _matrix(m, k, density, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * k, round(m * k * density)))
    vals = rng.random(lin.size).astype(np.float32 if dtype == torch.float32 else np.float64)
    return st.COO(np.stack([lin // k, lin % k]), vals, shape=(m, k), device="cuda")


def _tensor3(seed, I, J, K, draws):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, I * J * K, draws))
    return np.stack([lin // (J * K), (lin // K) % J, lin % K]), rng.random(lin.size)


def test_make_mesh_on_the_card(mesh):
    assert mesh.device_type == "cuda" and mesh.size(0) == 1 and "nccl" in str(dist.get_backend())
    pc = tp.partition_coo_rows(_matrix(300, 200, 0.05, 0), 4, mesh=mesh)
    assert pc.rows.to_local().device.type == "cuda" and pc.rows.to_local().shape[0] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_mttkrp_sharded_ell_runs_e2_a_shard(mesh, dtype, n_shards):
    I, J, K, R = 2100, 40, 50, 16
    coords, vals = _tensor3(21, I, J, K, 40000)
    rng = np.random.default_rng(1)
    c = torch.as_tensor(rng.random((J, R)), dtype=dtype, device="cuda")
    d = torch.as_tensor(rng.random((K, R)), dtype=dtype, device="cuda")
    part = tp.partition_mttkrp_ell(coords, vals.astype(np.float32 if dtype == torch.float32 else np.float64), I, n_shards)
    on_card = [x.cuda() for x in part[:4]]
    reset_launch_counts()
    got = tp.mttkrp_sharded_ell(*on_card, c, d, I, part[4], mesh)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_mttkrp"] == n_shards
    want = torch.cat([ell.ell_mttkrp_plain(*(x[s] for x in on_card), c, d, n_rows=part[4]) for s in range(n_shards)])[:I]
    torch.testing.assert_close(got, want, **TOL[dtype])
    assert torch.equal(got, tp.mttkrp_sharded_ell(*on_card, c, d, I, part[4], mesh))  # a fixed order: the same bits


def test_mttkrp_sharded_ell_one_shard_is_the_whole_layouts_bits(mesh):
    I, J, K, R = 5000, 60, 70, 32
    coords, vals = _tensor3(5, I, J, K, 200000)
    vals = vals.astype(np.float32)
    rng = np.random.default_rng(2)
    c, d = (torch.as_tensor(rng.random((n, R)), dtype=torch.float32, device="cuda") for n in (J, K))
    part = tp.partition_mttkrp_ell(coords, vals, I, 1)
    lay = ell.build_block_ell_3d(*coords, vals, I, device="cuda")
    whole = ell.ell_mttkrp(*lay[:4], c, d, n_rows=I, order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces)
    assert torch.equal(tp.mttkrp_sharded_ell(*(x.cuda() for x in part[:4]), c, d, I, part[4], mesh), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mttkrp_sharded_runs_k3_a_shard(mesh, dtype):
    m, n_shards = 3000, 4
    coords, vals = _tensor3(3, m, 30, 40, 50000)
    block_rows = -(-m // n_shards)
    shard_of = coords[0] // block_rows
    cap = int(np.bincount(shard_of, minlength=n_shards).max())
    arrays = [np.zeros((n_shards, cap), dtype=np.int32) for _ in range(3)] + [np.zeros((n_shards, cap))]
    for s in range(n_shards):
        sel = shard_of == s
        k = int(sel.sum())
        for x, src in zip(arrays, (coords[0][sel] - s * block_rows, coords[1][sel], coords[2][sel], vals[sel])):
            x[s, :k] = src
    ci, cj, ck, v = (torch.as_tensor(x, device="cuda") for x in arrays)
    v = v.to(dtype)
    rng = np.random.default_rng(4)
    c, d = (torch.as_tensor(rng.random((n, 8)), dtype=dtype, device="cuda") for n in (30, 40))
    reset_launch_counts()
    got = tp.mttkrp_sharded(ci, cj, ck, v, c, d, m, mesh)
    torch.cuda.synchronize()
    assert LAUNCHES["coo_mttkrp"] == n_shards
    want = torch.cat([dot.mttkrp_plain(ci[s], cj[s], ck[s], v[s], c, d, n_rows=block_rows) for s in range(n_shards)])[:m]
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sddmm_sharded_runs_k4_a_shard(mesh, dtype):
    s = _matrix(2000, 1500, 0.01, 6, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lhs = torch.rand((2000, 64), generator=gen, device="cuda", dtype=dtype)
    rhs = torch.rand((1500, 64), generator=gen, device="cuda", dtype=dtype).T
    pc = tp.partition_coo_rows(s, 8, mesh=mesh)
    reset_launch_counts()
    got = tp.sddmm_sharded(pc, lhs, rhs, mesh)
    torch.cuda.synchronize()
    assert LAUNCHES["sddmm"] == 8
    rows, cols, data = (x.full_tensor() for x in (pc.rows, pc.cols, pc.data))
    lhs_pad = torch.cat([lhs, lhs.new_zeros((8 * pc.block_rows - 2000, 64))]).reshape(8, pc.block_rows, 64)
    want = torch.stack([dot.sddmm_plain(rows[i].long(), cols[i].long(), data[i], lhs_pad[i], rhs) for i in range(8)])
    torch.testing.assert_close(got, want, **TOL[dtype])


def test_products_of_torch_ops_on_the_card(mesh):
    a = _matrix(4000, 3000, 0.005, 7, torch.float64)
    b = torch.rand((3000, 32), dtype=torch.float64, device="cuda")
    want = a.todense() @ b
    pc = tp.partition_coo_rows(a, 4, mesh=mesh)
    torch.testing.assert_close(tp.spmm_replicated(pc, b, mesh), want, **TOL[torch.float64])
    bucketed = tp.bucket_columns(pc, 4)
    torch.testing.assert_close(tp.spmm_ring(bucketed, a.shape, pc.block_rows, b, mesh), want, **TOL[torch.float64])
    ring_ell = tp.bucket_columns_ell(a, 4)
    b_pad = torch.cat([b, b.new_zeros((4 * ring_ell[4] - 3000, 32))])
    torch.testing.assert_close(tp.spmm_ring_ell(ring_ell, 4000, b_pad, mesh), want, **TOL[torch.float64])
    part = tp.partition_spmm_ell(a, 4)
    torch.testing.assert_close(tp.spmm_sharded_ell(*part[:3], b, 4000, mesh), want, **TOL[torch.float64])
    from torch.distributed.device_mesh import DeviceMesh

    mesh2 = DeviceMesh("cuda", torch.arange(1).reshape(1, 1), mesh_dim_names=("x", "y"))
    torch.testing.assert_close(tp.spmm_2d(tp.partition_coo_rows(a, 2), b, mesh2), want, **TOL[torch.float64])
    torch.testing.assert_close(tp.spmm_2d_ell(*part[:3], 4000, b, mesh2), want, **TOL[torch.float64])


def test_reductions_elemwise_spgemm_and_checkpoint_on_the_card(mesh, tmp_path):
    a = _matrix(700, 400, 0.02, 8, torch.float64)
    host = a.todense().cpu()
    pc = tp.partition_coo_rows(a, 4, mesh=mesh)
    for axis in (0, 1, None):
        torch.testing.assert_close(tp.sum_partitioned(pc, mesh, axis=axis).cpu(), host.sum(dim=axis) if axis is not None else host.sum(), **TOL[torch.float64])
    out, nnz = tp.elemwise_partitioned(torch.add, pc, pc, mesh)
    rows = (out.rows.long() + torch.arange(4, device="cuda")[:, None] * out.block_rows).cpu()
    dense = torch.zeros(700, 400, dtype=torch.float64)
    for s in range(4):
        k = int(nnz[s])
        dense.index_put_((rows[s, :k], out.cols[s, :k].long().cpu()), out.data[s, :k].cpu(), accumulate=True)
    torch.testing.assert_close(dense, 2 * host, **TOL[torch.float64])
    b = _matrix(400, 300, 0.02, 9, torch.float64)
    res = tp.assemble_spgemm_result(tp.spgemm_sharded(pc, b, mesh), pc, 300)
    assert res.device.type == "cuda"
    torch.testing.assert_close(res.todense().cpu(), host @ b.todense().cpu(), **TOL[torch.float64])
    tck.save_partitioned(str(tmp_path / "ck"), pc)
    restored = tck.load_partitioned(str(tmp_path / "ck"), mesh=mesh)
    assert restored.rows.to_local().device.type == "cuda"
    for x, y in ((restored.rows, pc.rows), (restored.cols, pc.cols), (restored.data, pc.data)):
        assert torch.equal(x.full_tensor(), y.full_tensor())


def test_profiling_on_the_card(mesh, tmp_path):
    x = torch.rand(1 << 20, device="cuda")
    assert profiling.benchmark(lambda v: v * 2, (x,), iters=10) > 0
    coords, vals = _tensor3(9, 1000, 20, 30, 20000)
    part = tp.partition_mttkrp_ell(coords, vals.astype(np.float32), 1000, 2)
    c, d = torch.rand((20, 8), device="cuda"), torch.rand((30, 8), device="cuda")
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        tp.mttkrp_sharded_ell(*(p.cuda() for p in part[:4]), c, d, 1000, part[4], mesh)
        torch.cuda.synchronize()
    import json

    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"]
    e2 = [k for k in kernels if "run_sum_kernel" in k and "MttkrpSum" in k]  # E2's kernel
    assert log_dir == str(tmp_path / "tr") and len(e2) == 2, (sorted(set(kernels))[:12], sorted({str(e.get("cat")) for e in events}))


_SELF_SEND = textwrap.dedent(
    """
    import torch, torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    x = torch.arange(4.0, device="cuda"); y = torch.zeros(4, device="cuda")
    try:
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 0), dist.P2POp(dist.irecv, y, 0)]):
            w.wait()
        torch.cuda.synchronize()
        print("SELF_SEND accepted", bool(torch.equal(x, y)))
    except Exception as e:
        print("SELF_SEND refused", type(e).__name__, str(e).splitlines()[0][:200])
    dist.destroy_process_group()
    """
)


def test_nccl_self_send_is_reported(mesh):
    """Whether NCCL takes a send to the same rank, in a child process with a
    time limit (the ring posts none: a ring of one keeps its block)."""
    try:
        res = subprocess.run([sys.executable, "-c", _SELF_SEND], capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        print("SELF_SEND hung: killed after 120 s")
        return
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("SELF_SEND")]
    print(line[0] if line else f"SELF_SEND no answer, rc {res.returncode}: {res.stderr[-500:]}")
    assert line or res.returncode != 0  # an answer, or a child that died on the send
