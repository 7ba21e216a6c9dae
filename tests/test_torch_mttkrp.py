"""The port's MTTKRP path against sparse_tpu's (CPU).

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernel itself is held against those in tests/test_torch_kernels_gpu.py. The
JAX side runs every path of ``ell_mttkrp`` (monolithic, the int16-split
tables, the float64 scan, ``"bf16"``, ``"hilo"``), the segment-sum
``mttkrp``, ``jitops.mttkrp`` and the one-hot Pallas prototype
``experiments/mttkrp_onehot.py:products_call`` in interpret mode.

Tolerances: float64 at rtol=1e-12; float32 at atol=1e-4 (as
tests/test_kernels.py), the two sides summing each row in another order;
``"bf16"`` at the float32 tolerance too, since both sides round the factors
to bf16 the same way (round to nearest even) and multiply them exactly in
float32; ``"hilo"`` (exact in the port, ~1e-7 relative in sparse_tpu) at
atol=1e-4; the Pallas prototype at a normalised max error of 1e-5, its hi|lo
grade.
"""

import functools
import importlib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu as sparse
from sparse_tpu import jitops as j_jitops
from sparse_tpu import kernels as jk
from sparse_tpu.kernels.ell import MTTKRP_SCAN_MIN_BLOCKS
from sparse_tpu_torch import COO
from sparse_tpu_torch import jitops as t_jitops
from sparse_tpu_torch.interop import _float_tensor, block_ell_3d_from_arrays, coo_from_arrays
from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.kernels import dot as td
from sparse_tpu_torch.kernels import ell as te

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
F64 = dict(rtol=1e-12, atol=0.0)
F32 = dict(rtol=1e-5, atol=1e-4)


def _tensor3(seed, I, J, K, draws, dtype=np.float32):
    """``(ci, cj, ck, values)`` of unique entries, sorted by their linear index."""
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, I * J * K, draws))
    ci = (lin // (J * K)).astype(np.int32)
    cj = ((lin // K) % J).astype(np.int32)
    ck = (lin % K).astype(np.int32)
    return ci, cj, ck, rng.random(lin.size).astype(dtype)


def _factors(seed, J, K, R, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.random((J, R)).astype(dtype), rng.random((K, R)).astype(dtype)


# (I, J, K, R, draws): tests/test_kernels.py's monolithic problem (< 32
# blocks), its scan / int16 problem (>= 32 blocks, ragged I), and small ones
SHAPES = {
    "monolithic": (300, 40, 50, 8, 5000),
    "many_blocks": (MTTKRP_SCAN_MIN_BLOCKS * 128 + 77, 30, 40, 8, 20000),
    "one_block": (100, 7, 9, 3, 60),
}


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "ragged", "block_rows_8", "empty"])
def test_block_ell_3d_identical_to_sparse_tpu(case):
    block_rows = 8 if case == "block_rows_8" else 128
    if case == "empty":
        I, ci, cj, ck, tv = 16, *(np.empty(0, np.int32) for _ in range(3)), np.empty(0, np.float32)
    elif case == "ragged":
        I = SHAPES["many_blocks"][0]
        ci, cj, ck, tv = _tensor3(3, I, 30, 40, 20000)
    else:
        I = 300
        ci, cj, ck, tv = _tensor3(int(case[-1]) if case[-1].isdigit() else 9, I, 40, 50, 5000)
    want = jk.build_block_ell_3d(ci, cj, ck, tv, I, block_rows=block_rows)
    got = te.build_block_ell_3d(ci, cj, ck, tv, I, block_rows=block_rows, device=CPU)
    for name, w, g in zip(("e_rows", "e_j", "e_k", "e_data"), want, got[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert g.dtype == (torch.float32 if name == "e_data" else torch.int32)
    # the runs: every slot once, grouped by global row in ascending order,
    # pads (data 0, local row 0) in row 0 of their block
    n_blocks, cap = got.e_rows.shape
    rows = (np.arange(n_blocks)[:, None] * block_rows + got.e_rows.numpy()).reshape(-1)
    order, row_ptr = got.order.numpy(), got.row_ptr.numpy()
    assert got.order.dtype == torch.int32 and got.row_ptr.dtype == torch.int64
    assert row_ptr.shape == (n_blocks * block_rows + 1,) and row_ptr[-1] == n_blocks * cap
    np.testing.assert_array_equal(np.sort(order), np.arange(n_blocks * cap))
    np.testing.assert_array_equal(rows[order], np.repeat(np.arange(n_blocks * block_rows), np.diff(row_ptr)))
    # computed on the device (one stable sort) they are the same arrays
    order_d, row_ptr_d = te.block_ell_3d_runs(got.e_rows, block_rows)
    assert torch.equal(order_d, got.order) and torch.equal(row_ptr_d, got.row_ptr)


def test_interop_carries_the_jax_layout():
    ci, cj, ck, tv = _tensor3(5, 300, 40, 50, 5000)
    want = te.build_block_ell_3d(ci, cj, ck, tv, 300, device=CPU)
    got = block_ell_3d_from_arrays(*jk.build_block_ell_3d(ci, cj, ck, tv, 300), device=CPU)
    for name, w, g in zip(want._fields, want, got):
        assert (torch.equal(w, g) if isinstance(w, torch.Tensor) else w == g), name


def _ell_case(case, dtype, strategy):
    I, J, K, R, draws = SHAPES[case]
    ci, cj, ck, tv = _tensor3(31, I, J, K, draws, dtype)
    C, D = _factors(32, J, K, R, dtype)
    want = np.array(
        jk.ell_mttkrp(*jk.build_block_ell_3d(ci, cj, ck, tv, I), jnp.asarray(C), jnp.asarray(D), n_rows=I, strategy=strategy)
    )
    lay = te.build_block_ell_3d(ci, cj, ck, tv, I, device=CPU)
    got = te.ell_mttkrp(
        *lay[:4], _float_tensor(C, CPU), _float_tensor(D, CPU), n_rows=I, strategy=strategy, order=lay.order, row_ptr=lay.row_ptr
    )
    return got, want, lay, (ci, cj, ck, tv, C, D)


@pytest.mark.parametrize(
    "case,dtype,strategy",
    [
        ("monolithic", np.float32, "exact"),  # one-hot einsum over all blocks
        ("many_blocks", np.float32, "exact"),  # the int16-split tables
        ("many_blocks", np.float64, "exact"),  # the scan over groups of blocks
        ("monolithic", np.float64, "exact"),
        ("monolithic", np.float32, "bf16"),
        ("many_blocks", np.float32, "bf16"),
        ("monolithic", np.float32, "hilo"),
        ("many_blocks", np.float32, "hilo"),
        ("one_block", np.float64, "bf16"),  # bf16 factors, float64 values
    ],
)
def test_ell_mttkrp_matches_sparse_tpu(case, dtype, strategy):
    got, want, lay, (*_, C, D) = _ell_case(case, dtype, strategy)
    assert got.dtype == torch.from_numpy(want).dtype and got.shape == want.shape
    tol = F64 if dtype == np.float64 and strategy == "exact" else F32
    torch.testing.assert_close(got, torch.from_numpy(want), **tol)
    # the bare arrays (no runs) give the same result
    bare = te.ell_mttkrp(*lay[:4], torch.from_numpy(C), torch.from_numpy(D), n_rows=want.shape[0], strategy=strategy)
    torch.testing.assert_close(bare, got, rtol=0, atol=0)


def test_ell_mttkrp_plain_is_the_wrapper_on_the_cpu():
    got, _, lay, (*_, C, D) = _ell_case("monolithic", np.float32, "bf16")
    plain = te.ell_mttkrp_plain(*lay[:4], torch.from_numpy(C), torch.from_numpy(D), n_rows=300, strategy="bf16")
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_ell_mttkrp_empty():
    # tests/test_kernels.py:344: no entries, one block of pad slots
    lay = te.build_block_ell_3d(*(np.empty(0, np.int32) for _ in range(3)), np.empty(0, np.float32), 16, device=CPU)
    out = te.ell_mttkrp(*lay[:4], torch.ones((4, 3)), torch.ones((5, 3)), n_rows=16, order=lay.order, row_ptr=lay.row_ptr)
    assert out.shape == (16, 3) and out.dtype == torch.float32
    assert not out.any()
    zero = te.build_block_ell_3d(*(np.empty(0, np.int32) for _ in range(3)), np.empty(0), 0, device=CPU)
    assert te.ell_mttkrp(*zero[:4], torch.ones((4, 3)), torch.ones((5, 3)), n_rows=0).shape == (0, 3)


def test_ell_mttkrp_nonfinite_products_stay_in_their_row():
    # pad slots (data 0, local row 0, j = k = 0) are computed like entries,
    # so with C[0] infinite a pad's 0 * inf is NaN in local row 0 of its
    # block, and an entry with j = 0 makes its row infinite: the slot-by-slot
    # sum in numpy. sparse_tpu's one-hot contraction multiplies every product
    # of a block by the 0s of the other rows too, so there one non-finite
    # product makes its whole block NaN (a deliberate difference).
    ci, cj, ck, tv = _tensor3(7, 300, 40, 50, 3000)
    C, D = _factors(8, 40, 50, 4)
    C[0] = np.inf
    lay = te.build_block_ell_3d(ci, cj, ck, tv, 300, device=CPU)
    got = te.ell_mttkrp(*lay[:4], torch.from_numpy(C), torch.from_numpy(D), n_rows=300).numpy()
    er, ej, ek, ed = (a.numpy().ravel() for a in lay[:4])
    rows = (np.arange(lay.e_rows.shape[0])[:, None] * 128 + lay.e_rows.numpy()).ravel()
    with np.errstate(invalid="ignore"):
        want = np.zeros((lay.e_rows.shape[0] * 128, 4))
        np.add.at(want, rows, ed[:, None].astype(np.float64) * (C[ej].astype(np.float64) * D[ek]))
    want = want[:300]
    assert np.isnan(want).any() and np.isinf(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **F32)
    jax_out = np.asarray(jk.ell_mttkrp(*jk.build_block_ell_3d(ci, cj, ck, tv, 300), jnp.asarray(C), jnp.asarray(D), n_rows=300))
    for b in range(3):
        blk = slice(b * 128, (b + 1) * 128)
        if np.isfinite(want[blk]).all():
            np.testing.assert_allclose(got[blk], jax_out[blk], **F32)
        else:
            assert np.isnan(jax_out[blk]).all()


def test_mttkrp_matches_sparse_tpu():
    # tests/test_kernels.py:91
    t = sparse.random((20, 10, 12), density=0.05, random_state=0)
    c = np.random.default_rng(1).random((10, 4))
    d = np.random.default_rng(2).random((12, 4))
    coords, data = np.asarray(t.coords), np.asarray(t.data)
    want = np.asarray(jk.mttkrp(*map(jnp.asarray, (*coords, data, c, d)), n_rows=20))
    got = td.mttkrp(*map(torch.from_numpy, (*coords, data, c, d)), n_rows=20)
    torch.testing.assert_close(got, torch.from_numpy(want), **F64)
    np.testing.assert_allclose(got.numpy(), np.einsum("ijk,jr,kr->ir", t.todense(), c, d), rtol=1e-12)
    # float32 and a ragged row range: i past n_rows is dropped in both
    c32, d32, v32 = c.astype(np.float32), d.astype(np.float32), data.astype(np.float32)
    want32 = np.asarray(jk.mttkrp(*map(jnp.asarray, (*coords, v32, c32, d32)), n_rows=15))
    got32 = td.mttkrp(*map(torch.from_numpy, (*coords, v32, c32, d32)), n_rows=15)
    torch.testing.assert_close(got32, torch.from_numpy(want32), **F32)
    plain = td.mttkrp_plain(*map(torch.from_numpy, (*coords, v32, c32, d32)), n_rows=15)
    torch.testing.assert_close(plain, got32, rtol=0, atol=0)


def _grad_problem():
    # tests/test_autodiff.py:70
    rng = np.random.default_rng(4)
    I, J, K, R = 8, 7, 6, 3
    lin = np.unique(rng.integers(0, I * J * K, size=40))
    ci = (lin // (J * K)).astype(np.int32)
    cj = ((lin // K) % J).astype(np.int32)
    ck = (lin % K).astype(np.int32)
    data = rng.standard_normal(lin.size)
    C = rng.standard_normal((J, R))
    D = rng.standard_normal((K, R))
    W = rng.standard_normal((I, R))
    return I, ci, cj, ck, data, C, D, W


def _torch_grads(fn, data, C, D, W):
    args = [torch.tensor(a, requires_grad=True) for a in (data, C, D)]
    (fn(*args) * torch.from_numpy(W)).sum().backward()
    return [a.grad for a in args]


def test_mttkrp_grads_match_jax():
    I, ci, cj, ck, data, C, D, W = _grad_problem()
    j_loss = lambda v, c, d: (jk.mttkrp(ci, cj, ck, v, c, d, n_rows=I) * W).sum()  # noqa: E731
    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(data), jnp.asarray(C), jnp.asarray(D))
    ti, tj, tk = map(torch.from_numpy, (ci, cj, ck))
    got = _torch_grads(lambda v, c, d: td.mttkrp(ti, tj, tk, v, c, d, n_rows=I), data, C, D, W)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(w)), **F64)


def test_ell_mttkrp_grads_match_jax():
    I, ci, cj, ck, data, C, D, W = _grad_problem()
    er, ej, ek, ed = jk.build_block_ell_3d(ci, cj, ck, data, I, block_rows=4)
    j_loss = lambda v, c, d: (jk.ell_mttkrp(er, ej, ek, v, c, d, n_rows=I, block_rows=4) * W).sum()  # noqa: E731
    want = jax.grad(j_loss, argnums=(0, 1, 2))(ed, jnp.asarray(C), jnp.asarray(D))
    lay = te.build_block_ell_3d(ci, cj, ck, data, I, block_rows=4, device=CPU)
    got = _torch_grads(
        lambda v, c, d: te.ell_mttkrp(lay.e_rows, lay.e_j, lay.e_k, v, c, d, n_rows=I, block_rows=4),
        lay.e_data.numpy(),
        C,
        D,
        W,
    )
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(w)), **F64)


@pytest.mark.parametrize("form", ["coo", "ell", "ell_bf16"])
def test_gradcheck(form):
    I, ci, cj, ck, data, C, D, _ = _grad_problem()
    args = tuple(torch.tensor(a, requires_grad=True) for a in (data, C, D))
    if form == "coo":
        ti, tj, tk = map(torch.from_numpy, (ci, cj, ck))
        fn = lambda v, c, d: td.mttkrp(ti, tj, tk, v, c, d, n_rows=I)  # noqa: E731
    else:
        lay = te.build_block_ell_3d(ci, cj, ck, data, I, block_rows=4, device=CPU)
        strategy = "bf16" if form == "ell_bf16" else "exact"
        # the data's gradient through the layout's slots (pads included)
        args = (lay.e_data.clone().requires_grad_(True), *args[1:])
        if strategy == "bf16":  # straight through the factors' rounding: exact in the data only
            args = (args[0], args[1].detach(), args[2].detach())
        fn = lambda v, c, d: te.ell_mttkrp(  # noqa: E731
            lay.e_rows, lay.e_j, lay.e_k, v, c, d, n_rows=I, block_rows=4, strategy=strategy
        )
    assert torch.autograd.gradcheck(fn, args)


def test_jitops_mttkrp_matches_sparse_tpu():
    # tests/test_jitops.py:47, the COO carried across as it is
    t = sparse.random((12, 7, 5), density=0.2, random_state=4)
    c = np.random.default_rng(5).random((7, 3))
    d = np.random.default_rng(6).random((5, 3))
    want = np.asarray(jax.jit(j_jitops.mttkrp)(t, jnp.asarray(c), jnp.asarray(d)))
    tt = coo_from_arrays(np.asarray(t.coords), np.asarray(t.data), t.shape, device=CPU)
    torch.testing.assert_close(t_jitops.mttkrp(tt, c, d), torch.from_numpy(want), **F64)
    # a COO built by the port's constructor from unsorted draws, duplicates summed
    rng = np.random.default_rng(9)
    coords = np.stack([rng.integers(0, s, 300) for s in (12, 7, 5)])
    vals = rng.random(300)
    built = COO(coords, vals, shape=(12, 7, 5), device=CPU)
    dense = np.zeros((12, 7, 5))
    np.add.at(dense, tuple(coords), vals)
    np.testing.assert_allclose(t_jitops.mttkrp(built, c, d).numpy(), np.einsum("ijk,jr,kr->ir", dense, c, d), rtol=1e-12)
    with pytest.raises(ValueError, match="3-D"):
        t_jitops.mttkrp(COO(coords[:2], vals, shape=(12, 7), device=CPU), c, d)


def test_mttkrp_refuses_what_the_kernel_cannot_take():
    ci, cj, ck, tv = (torch.from_numpy(a) for a in _tensor3(1, 30, 6, 7, 200))
    C, D = (torch.from_numpy(a) for a in _factors(2, 6, 7, 4))
    with pytest.raises(ValueError, match="sorted"):
        td.mttkrp(ci.flip(0), cj, ck, tv, C, D, n_rows=30)
    with pytest.raises(IndexError):
        td.mttkrp(ci, cj, ck, tv, C[:3], D, n_rows=30)
    with pytest.raises(IndexError):
        td.mttkrp(ci, cj, -ck, tv, C, D, n_rows=30)
    with pytest.raises(TypeError):
        td.mttkrp(ci, cj, ck, tv.to(torch.bfloat16), C, D, n_rows=30)
    lay = te.build_block_ell_3d(ci, cj, ck, tv, 30, device=CPU)
    with pytest.raises(ValueError, match="strategy"):
        te.ell_mttkrp(*lay[:4], C, D, n_rows=30, strategy="onehot")
    with pytest.raises(IndexError):
        te.ell_mttkrp(*lay[:4], C, D[:2], n_rows=30)
    with pytest.raises(ValueError, match="n_rows"):
        te.ell_mttkrp(*lay[:4], C, D, n_rows=129)
    with pytest.raises(ValueError, match="both"):
        te.ell_mttkrp(*lay[:4], C, D, n_rows=30, order=lay.order)


def test_non_cpu_tensors_never_take_the_plain_version():
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA device"):
        td.mttkrp(meta(5, dt=i32), meta(5, dt=i32), meta(5, dt=i32), meta(5), meta(3, 2), meta(4, 2), n_rows=6)
    with pytest.raises(ValueError, match="CUDA device"):
        te.ell_mttkrp(meta(1, 8, dt=i32), meta(1, 8, dt=i32), meta(1, 8, dt=i32), meta(1, 8), meta(3, 2), meta(4, 2), n_rows=6)


@pytest.mark.parametrize("block_rows", [8, 128])
def test_block_ell_spmm_spmv_match_sparse_tpu(block_rows):
    # tests/test_kernels.py:110's problem
    m, k, n = 40, 30, 8
    a = sparse.random((m, k), density=0.1, random_state=0)
    rows, cols = np.asarray(a.coords)
    data = np.asarray(a.data)
    dense = np.random.default_rng(1).random((k, n))
    x = np.random.default_rng(2).random(k)
    j = jk.build_block_ell(rows, cols, data, m, k, block_rows=block_rows)
    t = te.build_block_ell(rows, cols, data, m, k, block_rows=block_rows, device=CPU)
    for name in ("e_rows", "e_cols", "e_data"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    assert (t.n_rows, t.n_cols, t.block_rows) == (j.n_rows, j.n_cols, j.block_rows)
    want = np.asarray(jk.ell_spmm(j.e_rows, j.e_cols, j.e_data, jnp.asarray(dense), n_rows=m, block_rows=block_rows))
    got = te.ell_spmm(t.e_rows, t.e_cols, t.e_data, torch.from_numpy(dense), n_rows=m, block_rows=block_rows)
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-10, atol=0.0)
    want_v = np.asarray(jk.ell_spmv(j.e_rows, j.e_cols, j.e_data, jnp.asarray(x), n_rows=m, block_rows=block_rows))
    for lane_gather in (None, True, False):  # accepted, no effect
        got_v = te.ell_spmv(t.e_rows, t.e_cols, t.e_data, torch.from_numpy(x), n_rows=m, block_rows=block_rows, lane_gather=lane_gather)
        torch.testing.assert_close(got_v, torch.from_numpy(want_v), rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(got.numpy(), a.todense() @ dense, rtol=1e-10)


def test_block_ell_empty():
    # tests/test_kernels.py:121
    t = te.build_block_ell(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0), 16, 16, device=CPU)
    j = jk.build_block_ell(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0), 16, 16)
    assert t.e_rows.shape == j.e_rows.shape
    out = te.ell_spmm(t.e_rows, t.e_cols, t.e_data, torch.ones((16, 4), dtype=torch.float64), n_rows=16)
    assert out.shape == (16, 4) and not out.any()


def _load_mttkrp_onehot(monkeypatch):
    """experiments/mttkrp_onehot.py with its Pallas calls in interpret mode:
    its module attribute ``pl`` replaced, no file of it changed."""
    from jax.experimental import pallas as pl

    monkeypatch.syspath_prepend(str(REPO))
    mod = importlib.import_module("experiments.mttkrp_onehot")
    interp = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(mod, "pl", interp)
    return mod


def test_onehot_prototype_in_interpret_mode_matches_the_port(monkeypatch):
    # E2, the Pallas kernel this path replaces, at the shape of its own
    # check scaled down: J = 300, K = 200, r = 8, two blocks of 2048 slots
    mod = _load_mttkrp_onehot(monkeypatch)
    I, J, K, r, blk = 600, 300, 200, 8, 2048
    ci, cj, ck, tv = _tensor3(11, I, J, K, 3600)
    C, D = _factors(12, J, K, r)
    lay = te.build_block_ell_3d(ci, cj, ck, tv, I, device=CPU)
    n_blocks, cap = lay.e_rows.shape
    n_pad = -(-(n_blocks * cap) // blk) * blk
    flat = [np.zeros(n_pad, a.numpy().dtype) for a in lay[1:4]]
    for f, a in zip(flat, lay[1:4]):
        f[: n_blocks * cap] = a.numpy().ravel()
    ct, dt = mod.split_t(C), mod.split_t(D)
    call = mod.products_call(n_pad, r, ct.shape[1], dt.shape[1], blk)
    prods = np.asarray(call(ct, dt, *map(jnp.asarray, flat)))  # (r, n_pad) float32
    assert prods.shape == (r, n_pad) and prods.dtype == np.float32
    # the one-hot block scatter of the prototype's full(), in numpy
    want = np.zeros((n_blocks * 128, r))
    rows = (np.arange(n_blocks)[:, None] * 128 + lay.e_rows.numpy()).ravel()
    np.add.at(want, rows, prods[:, : n_blocks * cap].T.astype(np.float64))
    want = want[:I]
    got = te.ell_mttkrp(*lay[:4], torch.from_numpy(C), torch.from_numpy(D), n_rows=I, order=lay.order, row_ptr=lay.row_ptr)
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) <= 1e-5


# ---------------------------------------------------------------------------
# the pieces that cut long runs (csrc/mttkrp.cu)
# ---------------------------------------------------------------------------


def _kernel_spans(row_ptr, pieces, piece, n_rows):
    """``{row: [(begin, end), ...]}``: the slot ranges that csrc/mttkrp.cu's
    warps take, in the kernel's own mapping: front units ``u <
    pieces[n_rows]`` are the pieces of split rows, then one unit per
    unsplit row."""
    row_ptr, pieces = np.asarray(row_ptr), np.asarray(pieces)
    spans = {}
    for u in range(int(pieces[n_rows])):
        row = int(np.searchsorted(pieces[: n_rows + 1], u, side="right")) - 1
        begin = int(row_ptr[row]) + (u - int(pieces[row])) * piece
        spans.setdefault(row, []).append((begin, min(begin + piece, int(row_ptr[row + 1]))))
    for row in range(n_rows):
        if pieces[row + 1] == pieces[row]:
            spans[row] = [(int(row_ptr[row]), int(row_ptr[row + 1]))]
    return spans


def _check_spans(row_ptr, pieces, piece, n_rows, n_entries):
    """Every entry in exactly one piece, each row's pieces in run order from
    its first entry, one piece for a run of at most ``piece``, ⌈len / piece⌉
    otherwise, and no more front units than the grid's bound."""
    row_ptr = np.asarray(row_ptr)
    assert np.asarray(pieces).dtype == np.int64 and np.asarray(pieces).shape == row_ptr.shape
    spans = _kernel_spans(row_ptr, pieces, piece, n_rows)
    covered = []
    for row in range(n_rows):
        length = int(row_ptr[row + 1] - row_ptr[row])
        got = spans[row]
        assert len(got) == (1 if length <= piece else -(-length // piece)), row
        assert got[0][0] == row_ptr[row] and got[-1][1] == row_ptr[row + 1]
        assert all(a[1] == b[0] for a, b in zip(got, got[1:])) and all(0 < e - b <= piece for b, e in got[:-1])
        covered += [np.arange(b, e) for b, e in got]
    covered = np.concatenate(covered) if covered else np.empty(0, np.int64)
    np.testing.assert_array_equal(np.sort(covered), np.arange(int(row_ptr[n_rows]) - int(row_ptr[0])) + int(row_ptr[0]))
    assert int(np.asarray(pieces)[n_rows]) <= _cuda.front_bound(n_entries, n_rows, piece)
    return spans


@pytest.mark.parametrize("piece", [None, 16, 1])
@pytest.mark.parametrize("case", ["seed0", "ragged", "hub"])
def test_block_ell_3d_pieces_cover_every_slot_in_run_order(case, piece):
    I, J, K, draws = {"seed0": (300, 40, 50, 5000), "ragged": (3 * 128 + 44, 30, 40, 20000), "hub": (300, 60, 70, 2000)}[case]
    ci, cj, ck, tv = _tensor3(7, I, J, K, draws)
    if case == "hub":  # one row with a run of 2,400 entries
        rng = np.random.default_rng(8)
        hub = np.unique(rng.integers(0, J * K, 2600))[:2400]
        keep = ci != 7
        ci = np.concatenate([ci[keep], np.full(hub.size, 7, np.int32)])
        cj = np.concatenate([cj[keep], (hub // K).astype(np.int32)])
        ck = np.concatenate([ck[keep], (hub % K).astype(np.int32)])
        tv = np.concatenate([tv[keep], rng.random(hub.size).astype(np.float32)])
        order = np.argsort(ci, kind="stable")
        ci, cj, ck, tv = ci[order], cj[order], ck[order], tv[order]
    lay = te.build_block_ell_3d(ci, cj, ck, tv, I, device=CPU)
    p = _cuda.MTTKRP_PIECE if piece is None else piece
    n_slots = lay.order.numel()
    # the host-built pieces of the layout, and the same derivation from runs sorted "on the device"
    pieces = lay.pieces if piece is None else _cuda.run_pieces(lay.row_ptr, p)
    _check_spans(lay.row_ptr.numpy(), pieces.numpy(), p, I, n_slots)
    _, row_ptr_d = te.block_ell_3d_runs(lay.e_rows)
    assert torch.equal(_cuda.run_pieces(row_ptr_d, p), pieces)
    # the sorted-COO form derives its pieces from searchsorted offsets
    coo_ptr = torch.searchsorted(torch.as_tensor(ci).long(), torch.arange(I + 1))
    _check_spans(coo_ptr.numpy(), _cuda.run_pieces(coo_ptr, p).numpy(), p, I, ci.size)


def test_baseline_like_tail_gives_ceil_len_over_piece_pieces():
    # a last block of 32 rows padded to the cap of full blocks: its row 0
    # collects every pad slot, as row 99,968 does at the BASELINE scale
    I, J, K = 3 * 128 + 32, 50, 60
    rng = np.random.default_rng(11)
    ci = np.sort(np.concatenate([rng.integers(0, 384, 24000), rng.integers(384, I, 600)])).astype(np.int32)
    cj, ck = rng.integers(0, J, ci.size).astype(np.int32), rng.integers(0, K, ci.size).astype(np.int32)
    tv = rng.random(ci.size).astype(np.float32)
    lay = te.build_block_ell_3d(ci, cj, ck, tv, I, device=CPU)
    row_ptr, P = lay.row_ptr.numpy(), _cuda.MTTKRP_PIECE
    tail = int(np.diff(row_ptr).argmax())
    length = int(row_ptr[tail + 1] - row_ptr[tail])
    assert tail == 384 and length > 4 * P  # the ragged block's row 0 holds its pads
    spans = _check_spans(row_ptr, lay.pieces.numpy(), P, I, lay.order.numel())
    assert len(spans[tail]) == -(-length // P)
    # the layout with its pieces still computes the MTTKRP of the triplets
    C, D = (torch.from_numpy(f) for f in _factors(12, J, K, 4))
    got = te.ell_mttkrp(*lay[:4], C, D, n_rows=I, order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces)
    want = td.mttkrp_plain(*(torch.from_numpy(a) for a in (ci, cj, ck, tv)), C, D, n_rows=I)
    torch.testing.assert_close(got, want, **F32)
