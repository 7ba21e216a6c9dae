"""One-call proofs of the port: the single-device step and the whole
multi-device pipeline (the counterparts of ``entry`` and
``dryrun_multichip`` in the repository's ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, args)``: the fused forward step of the main
  workload, a COO SpMM, a bias, and the SDDMM epilogue at the matrix's
  pattern (K4 on the card), at ``m = k = 8192``, ``n = 128`` and ``2^17``
  entry draws, float32.
- :func:`dryrun_multichip` runs one step of every distributed path on the
  caller's process group (gloo on the CPU, NCCL on the card) at small
  shapes, each against a host oracle or the unsharded call, with the JAX
  package's asserts and tolerances: the shard-direct partition and the
  replicated SpMM, the ring SpMMs, the element-wise union and the sums, the
  banded attention's halos, both MTTKRPs, the ELL SpMMs, the 2-D mesh (at
  four ranks or more, an even count), SpGEMM, SDDMM, the partitioned
  Bellman-Ford and PageRank, CG on a partitioned matvec, then ragged and
  degenerate shapes. It starts no process.
"""

from __future__ import annotations

import numpy as np
import torch

from ._settings import resolve_device


def _make_problem(m, k, nnz, n, seed=0, device=None):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * k, size=nnz, dtype=np.int64))
    rows = (lin // k).astype(np.int32)
    cols = (lin % k).astype(np.int32)
    data = rng.random(lin.size, dtype=np.float32)
    dense = rng.random((k, n), dtype=np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (rows, cols, data, dense))


def entry(device=None):
    """``(fn, example_args)``: the forward step ``fn(rows, cols, data,
    dense, bias) -> (out, loss)`` with ``out = A @ dense + bias`` and
    ``loss`` the sum of the SDDMM ``A ⊙ (out @ denseᵀ)``, and its inputs on
    ``device`` (the GPU by default)."""
    from .kernels import dot as kdot

    device = resolve_device(device)
    m = k = 8192
    n = 128
    rows, cols, data, dense = _make_problem(m, k, nnz=1 << 17, n=n, device=device)
    bias = torch.zeros((n,), dtype=torch.float32, device=device)

    def forward(rows, cols, data, dense, bias):
        out = kdot.coo_spmm(rows, cols, data, dense, n_rows=m)
        out = out + bias[None, :]
        # the SDDMM epilogue at A's pattern: A ⊙ (out @ denseᵀ)
        sample = kdot.sddmm(rows, cols, data, out, dense.T)
        return out, sample.sum()

    return forward, (rows, cols, data, dense, bias)


def _host(x):
    """A result (tensor, DTensor or array) as a NumPy array."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _coo32(a, dtype=torch.float32):
    """``a`` with its values cast (the JAX package's ``np.asarray(a.data, dtype)``)."""
    from .core.coo import COO

    return COO(a.coords, a.data.to(dtype), shape=a.shape)


def _mesh_2d(mesh, n_devices):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh.device_type, torch.arange(n_devices).reshape(2, n_devices // 2), mesh_dim_names=("x", "y"))


def dryrun_multichip(n_devices: int) -> None:
    """Run one distributed step of every path over a mesh of ``n_devices``
    ranks: the caller's default process group, gloo (a CPU mesh) or NCCL (a
    GPU mesh), of exactly that size. Raises ``RuntimeError`` without a
    process group, ``ValueError`` for another world size, and
    ``AssertionError`` where a step disagrees."""
    import torch.distributed as dist

    import sparse_tpu_torch as sparse
    from .parallel import make_mesh
    from .parallel.sharding import _device

    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip runs on the caller's process group: call torch.distributed.init_process_group first")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a world of {n_devices} ranks, not {dist.get_world_size()}")
    mesh = make_mesh(n_devices, device=None if "nccl" in str(dist.get_backend()) else "cpu")
    dev = _device(mesh)
    m, k, n = 16 * n_devices, 8 * n_devices, 8

    a = _coo32(sparse.random((m, k), density=0.2, random_state=0, device=dev))
    b = np.random.default_rng(1).random((k, n), dtype=np.float32)
    a_dense = _host(a.todense())
    expected = a_dense @ b

    # shard-direct construction (no global triplet) + replicated SpMM
    from .parallel import random_partitioned, spmm_replicated

    pr = random_partitioned((m, k), density=0.15, n_shards=n_devices, mesh=mesh, random_state=3, dtype=np.float32)
    rows_np, cols_np, data_np = (_host(x) for x in (pr.rows, pr.cols, pr.data))
    dense_pr = np.zeros((m, k), dtype=np.float32)
    for s in range(n_devices):
        v = data_np[s] != 0
        dense_pr[rows_np[s][v] + s * pr.block_rows, cols_np[s][v]] = data_np[s][v]
    np.testing.assert_allclose(_host(spmm_replicated(pr, b, mesh=mesh)), dense_pr @ b, rtol=1e-4)

    # ring SpMM: rows of A sharded, K-blocks of B rotated around the ring
    from .parallel import bucket_columns, partition_coo_rows, spmm_ring

    pcoo = partition_coo_rows(a, n_devices)
    out_rows, out_cols, out_data, block_cols = bucket_columns(pcoo, n_devices)
    b_pad = np.zeros((n_devices * block_cols, n), dtype=np.float32)
    b_pad[:k] = b
    out = spmm_ring((out_rows, out_cols, out_data, block_cols), (m, k), pcoo.block_rows, b_pad, mesh)
    np.testing.assert_allclose(_host(out), expected, rtol=1e-4)

    # shard-local element-wise union + the sums
    from .parallel import elemwise_partitioned, sum_partitioned

    a2 = _coo32(sparse.random((m, k), density=0.2, random_state=5, device=dev))
    a2_dense = _host(a2.todense())
    p1 = partition_coo_rows(a, n_devices)
    p2 = partition_coo_rows(a2, n_devices)
    esum, _ = elemwise_partitioned(torch.add, p1, p2, mesh)
    np.testing.assert_allclose(_host(sum_partitioned(esum, mesh, axis=0)), (a_dense + a2_dense).sum(axis=0), rtol=1e-4)
    np.testing.assert_allclose(_host(sum_partitioned(p1, mesh, axis=1)), a_dense.sum(axis=1), rtol=1e-4)

    # sequence-parallel banded attention (halos over the ring)
    from .nn import banded_attention, banded_attention_sharded

    rng2 = np.random.default_rng(7)
    lq = 16 * n_devices
    qa = torch.from_numpy(rng2.standard_normal((lq, 8)).astype(np.float32)).to(dev)
    att_single = banded_attention(qa, qa, qa, window=4, block=8)
    att_shard = banded_attention_sharded(qa, qa, qa, window=4, mesh=mesh, block=8)
    np.testing.assert_allclose(_host(att_shard), _host(att_single), atol=5e-2)

    # sharded MTTKRP on a 3-D tensor, i-partitioned
    from .parallel import mttkrp_sharded

    t = sparse.random((m, 8, 8), density=0.1, random_state=2, device=dev)
    coords = _host(t.coords)
    data = _host(t.data).astype(np.float32)
    block_rows = -(-m // n_devices)
    shard_of = coords[0] // block_rows
    cap = max(int(np.bincount(shard_of, minlength=n_devices).max()), 1)
    ci, cj, ck = (np.zeros((n_devices, cap), dtype=np.int32) for _ in range(3))
    cv = np.zeros((n_devices, cap), dtype=np.float32)
    for s in range(n_devices):
        sel = shard_of == s
        cnt = int(sel.sum())
        ci[s, :cnt] = coords[0][sel] - s * block_rows
        cj[s, :cnt] = coords[1][sel]
        ck[s, :cnt] = coords[2][sel]
        cv[s, :cnt] = data[sel]
    c = np.random.default_rng(3).random((8, 4), dtype=np.float32)
    d = np.random.default_rng(4).random((8, 4), dtype=np.float32)
    on_dev = [torch.from_numpy(x).to(dev) for x in (ci, cj, ck, cv, c, d)]
    res = mttkrp_sharded(*on_dev, m, mesh)
    expected_m = np.einsum("ijk,jr,kr->ir", _host(t.todense()).astype(np.float32), c, d)
    np.testing.assert_allclose(_host(res), expected_m, rtol=1e-4)

    # the block-ELL kernel's form of the sharded MTTKRP
    from .parallel import mttkrp_sharded_ell, partition_mttkrp_ell

    er, ej, ek, ed2, br2 = partition_mttkrp_ell(coords, data, m, n_devices)
    res2 = mttkrp_sharded_ell(er, ej, ek, ed2, c, d, m, br2, mesh)
    np.testing.assert_allclose(_host(res2), expected_m, rtol=1e-4)

    # the block-ELL sharded SpMM
    from .parallel import partition_spmm_ell, spmm_sharded_ell

    a2d = _coo32(sparse.random((m, k), density=0.08, random_state=9, device=dev))
    a2d_dense = _host(a2d.todense())
    b2d = np.random.default_rng(10).random((k, 8)).astype(np.float32)
    er2, ec2, ed3, _br3 = partition_spmm_ell(a2d, n_devices)
    res3 = spmm_sharded_ell(er2, ec2, ed3, torch.from_numpy(b2d).to(dev), m, mesh)
    np.testing.assert_allclose(_host(res3), a2d_dense @ b2d, rtol=1e-4, atol=1e-5)

    # the block-ELL ring
    from .parallel import bucket_columns_ell, spmm_ring_ell

    bucketed = bucket_columns_ell(a2d, n_devices)
    bc = bucketed[4]
    b_pad = np.zeros((n_devices * bc, b2d.shape[1]), dtype=np.float32)
    b_pad[: b2d.shape[0]] = b2d
    res4 = spmm_ring_ell(bucketed, m, b_pad, mesh)
    np.testing.assert_allclose(_host(res4), a2d_dense @ b2d, rtol=1e-4, atol=1e-5)

    # a 2-D mesh (rows over x, the dense columns over y) where the count factors
    if n_devices >= 4 and n_devices % 2 == 0:
        from .parallel import spmm_2d

        mesh2 = _mesh_2d(mesh, n_devices)
        pc = partition_coo_rows(a, 2, mesh=mesh2, axis_name="x")
        np.testing.assert_allclose(_host(spmm_2d(pc, torch.from_numpy(b).to(dev), mesh2)), expected, rtol=1e-4)

    # sharded SpGEMM over a replicated right operand, reassembled
    from .parallel import assemble_spgemm_result, spgemm_sharded

    bsp = _coo32(sparse.random((k, 3 * n_devices), density=0.15, random_state=13, device=dev), torch.float64)
    shard_out = spgemm_sharded(p1, bsp, mesh)
    res_spgemm = assemble_spgemm_result(shard_out, p1, bsp.shape[1])
    np.testing.assert_allclose(_host(res_spgemm.todense()), a_dense @ _host(bsp.todense()), rtol=1e-5)

    # sharded SDDMM at the shards' own coordinates
    from .parallel import sddmm_sharded

    lhs = np.random.default_rng(21).random((m, 8)).astype(np.float32)
    rhs = np.random.default_rng(22).random((8, k)).astype(np.float32)
    vals = _host(sddmm_sharded(p1, lhs, rhs, mesh))
    full = lhs @ rhs
    rows_p, cols_p, data_p = (_host(x) for x in (p1.rows, p1.cols, p1.data))
    for sdx in range(n_devices):
        grow = np.minimum(rows_p[sdx] + sdx * p1.block_rows, m - 1)
        mask = data_p[sdx] != 0
        np.testing.assert_allclose(vals[sdx] * mask, data_p[sdx] * full[grow, cols_p[sdx]] * mask, rtol=1e-4)

    # the edge-partitioned relaxation and PageRank
    from . import csgraph

    gm = sparse.random((m, m), density=0.1, random_state=9, device=dev)
    gm = sparse.COO(gm.coords, gm.data.abs() + 0.1, shape=gm.shape)
    src = np.array([0, 1])
    d_single = csgraph.bellman_ford(gm, indices=src)
    d_shard = csgraph.bellman_ford_partitioned(gm, mesh, indices=src)
    np.testing.assert_array_equal(_host(d_shard), _host(d_single))
    pr_single, _ = csgraph.pagerank(gm, tol=1e-12)
    pr_shard, _ = csgraph.pagerank_partitioned(gm, mesh, tol=1e-12)
    np.testing.assert_allclose(_host(pr_shard), _host(pr_single), rtol=1e-9, atol=1e-13)

    # CG against a matvec whose matrix is row-partitioned over the mesh
    from . import linalg

    spd_dense = (a_dense @ a_dense.T + m * np.eye(m)).astype(np.float32)
    p_spd = partition_coo_rows(sparse.COO.from_numpy(spd_dense, device=dev), n_devices)
    mvec = linalg.partitioned_matvec(p_spd, mesh)
    bs = np.random.default_rng(11).standard_normal(m).astype(np.float32)
    xs, info = linalg.cg(mvec, torch.from_numpy(bs).to(dev), tol=1e-6, maxiter=5 * m)
    np.testing.assert_allclose(spd_dense @ _host(xs), bs, atol=5e-3)

    _dryrun_adversarial(mesh, n_devices)


def _dryrun_adversarial(mesh, n_devices):
    """Ragged and degenerate shapes: a row count that the ranks do not
    divide, a shard with no entries, an nnz-balanced partition with empty
    blocks, and a 2-D mesh whose factors divide neither M nor N (the caller
    pads by ceiling division and slices back)."""
    import sparse_tpu_torch as sparse
    from .parallel import bucket_columns, partition_coo_rows, spmm_replicated, spmm_ring, sum_partitioned
    from .parallel.sharding import _device

    dev = _device(mesh)
    # 1. ragged everything: m, k, n coprime to the rank count
    m, k, n = 16 * n_devices + 3, 8 * n_devices + 5, 7
    a = _coo32(sparse.random((m, k), density=0.15, random_state=31, device=dev))
    b = np.random.default_rng(32).random((k, n), dtype=np.float32)
    expected = _host(a.todense()) @ b
    bt = torch.from_numpy(b).to(dev)

    pc = partition_coo_rows(a, n_devices)
    np.testing.assert_allclose(_host(spmm_replicated(pc, bt, mesh)), expected, rtol=1e-4)
    bucketed = bucket_columns(pc, n_devices)
    block_cols = bucketed[3]
    b_pad = np.zeros((n_devices * block_cols, n), dtype=np.float32)
    b_pad[:k] = b
    np.testing.assert_allclose(_host(spmm_ring(bucketed, (m, k), pc.block_rows, b_pad, mesh)), expected, rtol=1e-4)

    # 2. a shard with no entries: every entry in the first row block
    rows_z = np.arange(5) % max(pc.block_rows - 1, 1)
    cols_z = np.arange(5) % k
    az = sparse.COO(np.stack([rows_z, cols_z]), np.ones(5, np.float32), shape=(m, k), device=dev)
    az_dense = _host(az.todense())
    pz = partition_coo_rows(az, n_devices)
    np.testing.assert_allclose(_host(spmm_replicated(pz, bt, mesh)), az_dense @ b, rtol=1e-4)
    np.testing.assert_allclose(_host(sum_partitioned(pz, mesh, axis=1)), az_dense.sum(axis=1), rtol=1e-4)

    # 3. an nnz-balanced partition whose skew leaves blocks empty
    pzb = partition_coo_rows(az, n_devices, balance="nnz")
    np.testing.assert_allclose(_host(spmm_replicated(pzb, bt, mesh)), az_dense @ b, rtol=1e-4)

    # 4. a 2-D mesh whose factors divide neither M nor N: ceiling pad + slice
    if n_devices >= 4 and n_devices % 2 == 0:
        from .parallel import spmm_2d

        ny = n_devices // 2
        mesh2 = _mesh_2d(mesh, n_devices)
        n_pad = -(-n // ny) * ny
        bp = np.zeros((k, n_pad), dtype=np.float32)
        bp[:, :n] = b
        pc2 = partition_coo_rows(a, 2, mesh=mesh2, axis_name="x")
        out2 = _host(spmm_2d(pc2, torch.from_numpy(bp).to(dev), mesh2))[:, :n]
        np.testing.assert_allclose(out2, expected, rtol=1e-4)
