"""The port's counterparts of the Pallas experiments against the experiments
themselves (CPU).

The JAX side runs ``experiments/pallas_spmv_onehot.py:products_kernel``
(E1) and the probes ``p1``-``p4`` of ``experiments/pallas_vmem.py`` and
``g1``-``g3`` of ``experiments/pallas_vmem2.py`` (E3-E9) in Pallas
interpret mode, with no file of theirs changed: each module's attribute
``pl`` is replaced by a namespace whose ``pallas_call`` runs in interpret
mode and records its outputs, and its ``bench`` by a stub that calls the
function once. The port's runners draw the same inputs from the same seeds
on the CPU, where each entry point runs its plain PyTorch version; the CUDA
kernels themselves are held against those in
tests/test_torch_kernels_gpu.py.

Tolerances: the picks (E1 with either table, p1 and its capability call, p3)
are exact on both sides, so they must be equal; the sums (p2, p4, g1-g3)
add in another order than the Pallas kernels' loops and reductions, on
positive values (no cancellation), at rtol=1e-5. E1's full SpMV against a
float64 oracle and against ``sparse_tpu``'s exact ``row_ell_spmv``, as
``max|out - want| / max|want|``: 1e-4 with the hi|lo table and 1e-2 with the
bf16 table (the prototype's ~1e-5 and ~2e-3).
"""

import importlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse_tpu.kernels import build_row_ell as j_build_row_ell
from sparse_tpu.kernels import row_ell_spmv as j_row_ell_spmv
from sparse_tpu_torch.experiments import common
from sparse_tpu_torch.experiments import pallas_spmv_onehot as t_spmv
from sparse_tpu_torch.experiments import pallas_vmem as t_vmem
from sparse_tpu_torch.experiments import pallas_vmem2 as t_vmem2
from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.kernels.row_ell import build_row_ell

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
SUMS = dict(rtol=1e-5, atol=0.0)
# max|out - want| / max|want| of the full SpMV, by table
SPMV_LIMIT = {True: 1e-4, False: 1e-2}


def _load(monkeypatch, name):
    """``experiments/<name>.py`` with its Pallas calls in interpret mode and
    its ``bench`` a single call; returns the module and the list that
    collects every ``pallas_call``'s output as numpy."""
    from jax.experimental import pallas as pl

    monkeypatch.syspath_prepend(str(REPO))
    path, limit = list(sys.path), sys.getrecursionlimit()
    try:  # pallas_spmv_onehot.py edits both when it is imported
        mod = importlib.import_module(f"experiments.{name}")
    finally:
        sys.path[:] = path
        sys.setrecursionlimit(limit)
    outputs = []

    def pallas_call(*args, **kwargs):
        call = pl.pallas_call(*args, interpret=True, **kwargs)

        def run(*operands):
            out = call(*operands)
            outputs.append(np.asarray(out))
            return out

        return run

    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec, ds=pl.ds))
    monkeypatch.setattr(mod, "bench", lambda fn, args, **kw: (fn(*args), 1.0)[1])
    return mod, outputs


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """A bfloat16 numpy (ml_dtypes) array as a torch tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)


# ------------------------------------------------------------------ E1
def _e1_inputs(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random(t_spmv.K, dtype=np.float32)
    cols = rng.integers(0, t_spmv.K, size=n, dtype=np.int32)
    data = rng.random(n, dtype=np.float32)
    cols[-300:] = 0  # the zero pad slots of a padded stream
    data[-300:] = 0.0
    return x, cols, data


def _jax_table(x, hilo):
    # the prototype's tables (experiments/pallas_spmv_onehot.py:141-146)
    x_hi = x.astype(np.float32).astype(jnp.bfloat16)
    x_lo = (x - np.asarray(x_hi, dtype=np.float32)).astype(jnp.bfloat16)
    if not hilo:
        return jnp.asarray(x_hi).reshape(512, 128)
    return jnp.concatenate([jnp.asarray(x_hi).reshape(512, 128), jnp.asarray(x_lo).reshape(512, 128)], axis=1)


@pytest.mark.parametrize("hilo", [True, False])
def test_e1_products_equal_the_pallas_kernel(monkeypatch, hilo):
    mod, outputs = _load(monkeypatch, "pallas_spmv_onehot")
    x, cols, data = _e1_inputs()
    x2_j = _jax_table(x, hilo)
    want = np.asarray(mod.products_kernel(hilo, 2048)(x2_j, jnp.asarray(cols), jnp.asarray(data)))
    assert want.shape == (4096, 1) and want.dtype == np.float32 and len(outputs) == 1

    x2 = t_spmv.make_table(torch.from_numpy(x), hilo)
    assert torch.equal(x2, _bf16(x2_j))
    got = t_spmv.products(x2, torch.from_numpy(cols), torch.from_numpy(data))
    assert torch.equal(got, _t(want))
    hi = x2[:, :128].reshape(-1).float()
    folded = hi + x2[:, 128:].reshape(-1).float() if hilo else hi
    c = torch.from_numpy(cols).long()
    assert torch.equal(got[:, 0], folded[c] * torch.from_numpy(data))


def test_e1_products_pick_zero_outside_the_table(monkeypatch):
    # a column past the table, or negative, matches no one-hot row
    mod, _ = _load(monkeypatch, "pallas_spmv_onehot")
    x, cols, data = _e1_inputs(n=2048, seed=6)
    cols[:5] = [-1, -129, 65536, 70000, 1 << 30]
    x2_j = _jax_table(x, True)
    want = np.asarray(mod.products_kernel(True, 2048)(x2_j, jnp.asarray(cols), jnp.asarray(data)))
    got = t_spmv.products(_bf16(x2_j), torch.from_numpy(cols), torch.from_numpy(data))
    assert torch.equal(got, _t(want))
    assert not got[:5].any()


def _small_bench(seed=7, m=3000, draws=30_000):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * t_spmv.K, size=draws, dtype=np.int64))
    rows = (lin // t_spmv.K).astype(np.int32)
    cols = (lin % t_spmv.K).astype(np.int32)
    return rows, cols, rng.random(lin.size, dtype=np.float32), rng.random(t_spmv.K, dtype=np.float32), m


@pytest.mark.parametrize("hilo", [True, False])
@pytest.mark.parametrize("blk", t_spmv.BLOCKS)
def test_e1_full_spmv_against_sparse_tpu_and_the_oracle(hilo, blk):
    rows, cols, data, x, m = _small_bench()
    re = build_row_ell(rows, cols, data, m, t_spmv.K, device=CPU)
    fc, fd = t_spmv.flatten_tiers(re, blk)
    n = sum(c.numel() for c, _ in re.tiers)
    assert fc.numel() % blk == 0 and fc.numel() - n < blk
    assert torch.equal(fc[:n], re.flat_cols) and not fc[n:].any() and not fd[n:].any()
    out = t_spmv.full_spmv(t_spmv.make_table(torch.from_numpy(x), hilo), fc, fd, re)
    assert out.shape == (m,) and out.dtype == torch.float32

    oracle = np.zeros(m)
    np.add.at(oracle, rows, data.astype(np.float64) * x.astype(np.float64)[cols])
    assert np.abs(out.numpy() - oracle).max() / np.abs(oracle).max() <= SPMV_LIMIT[hilo]
    j_re = j_build_row_ell(rows, cols, data, m, t_spmv.K)
    want = np.asarray(j_row_ell_spmv(j_re, jnp.asarray(x), strategy="exact"))
    assert np.abs(out.numpy() - want).max() / np.abs(want).max() <= SPMV_LIMIT[hilo]


def test_e1_main_at_the_bench_shape_on_the_cpu():
    res = t_spmv.main(device=CPU)
    assert res["nnz"] == 2_096_628 and res["entries"] >= res["nnz"]
    for blk, n_pad in res["padded"].items():
        assert n_pad % blk == 0 and n_pad - res["entries"] < blk
    assert set(res["runs"]) == {f"{t} blk={b}" for t in ("hilo", "bf16") for b in t_spmv.BLOCKS}
    for label, run in res["runs"].items():
        assert run["ms"] is None and run["relerr"] <= SPMV_LIMIT[label.startswith("hilo")]
    # the padding does not change the values
    assert torch.equal(res["outputs"]["hilo blk=2048"], res["outputs"]["hilo blk=4096"])
    assert res["row_ell_spmv"]["ms"] is None


# ------------------------------------------------------------------ E3-E6
@pytest.mark.parametrize("table_h", [512, 1808, 8192])
def test_p1_equals_the_pallas_probe(monkeypatch, table_h):
    mod, outputs = _load(monkeypatch, "pallas_vmem")
    mod.p1(table_h, 1024, 512)
    small, out = outputs
    assert small.shape == (8, 128) and out.shape == (1024, 128)
    run = t_vmem.p1(table_h, 1024, 512, device=CPU)
    assert torch.equal(run.outputs[0], _t(small)) and torch.equal(run.outputs[1], _t(out))
    assert run.n == 1024 * 128 and run.ms is None and run.rate is None


@pytest.mark.parametrize("n_loads,per_step", [(2048, 1024), (37 * 6, 37)])
def test_p2_matches_the_pallas_probe(monkeypatch, n_loads, per_step):
    mod, outputs = _load(monkeypatch, "pallas_vmem")
    mod.p2(256, n_loads, per_step)
    n_seg = n_loads // per_step
    assert len(outputs) == 2 and outputs[0].shape == (n_seg, 128)  # the check, then the stubbed bench
    run = t_vmem.p2(256, n_loads, per_step, device=CPU)
    torch.testing.assert_close(run.outputs[0], _t(outputs[0]), **SUMS)


def test_p3_equals_the_pallas_probe(monkeypatch):
    mod, outputs = _load(monkeypatch, "pallas_vmem")
    mod.p3(512, 2048, 1024)
    run = t_vmem.p3(512, 2048, 1024, device=CPU)
    got = run.outputs[0]
    assert torch.equal(got, _t(outputs[0]))
    strip, idx = run.inputs["strip"], run.inputs["idx"]
    assert torch.equal(got, strip.to(torch.bfloat16).float()[idx.long()])
    assert 0 < float((got - strip[idx.long()]).abs().max()) < 4e-3  # the bf16 rounding of the strip


def test_p4_matches_the_pallas_probe(monkeypatch):
    mod, outputs = _load(monkeypatch, "pallas_vmem")
    mod.p4(2048, 1024)
    assert outputs[0].shape == (2, 1)
    run = t_vmem.p4(2048, 1024, device=CPU)
    torch.testing.assert_close(run.outputs[0], _t(outputs[0]), **SUMS)


# ------------------------------------------------------------------ E7-E9
@pytest.mark.parametrize("T,n_blocks", [(512, 2), (200, 3)])
def test_g1_matches_the_pallas_probe(monkeypatch, T, n_blocks):
    mod, outputs = _load(monkeypatch, "pallas_vmem2")
    mod.g1(T, n_blocks)
    run = t_vmem2.g1(T, n_blocks, device=CPU)
    assert run.outputs[0].shape == (n_blocks * 8, 128)
    torch.testing.assert_close(run.outputs[0], _t(outputs[0]), **SUMS)
    assert torch.equal(run.outputs[0].view(n_blocks, 8, 128), run.outputs[0][::8].unsqueeze(1).expand(-1, 8, -1))


@pytest.mark.parametrize("T,n_blocks", [(512, 2), (200, 3)])
def test_g2_matches_the_pallas_probe(monkeypatch, T, n_blocks):
    mod, outputs = _load(monkeypatch, "pallas_vmem2")
    mod.g2(T, n_blocks)
    run = t_vmem2.g2(T, n_blocks, device=CPU)
    assert run.outputs[0].shape == (n_blocks * 8, 128)
    torch.testing.assert_close(run.outputs[0], _t(outputs[0]), **SUMS)


def test_g3_matches_the_pallas_probe(monkeypatch):
    mod, outputs = _load(monkeypatch, "pallas_vmem2")
    mod.g3(8192, 4, 4)
    run = t_vmem2.g3(8192, 4, 4, device=CPU)
    # the rate counts the picks the 8 kept rows need: 8 rows x 64 folds x W
    assert run.outputs[0].shape == (8, 128) and run.n == 8 * 64 * 4
    torch.testing.assert_close(run.outputs[0], _t(outputs[0]), **SUMS)


def test_g3_takes_t_8192_only():
    with pytest.raises(ValueError, match="8192"):
        t_vmem2.g3(T=512, device=CPU)
    table = torch.rand(512, 128)
    cols2 = torch.zeros((1, 512, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="8192"):
        t_vmem2.pick_scale_wsum(table, cols2, torch.ones((1, 512, 4)))


# ------------------------------------------------------------------ entry points
def _probe_calls(rng):
    """Each entry point with small CPU inputs, and its plain version."""
    table = torch.from_numpy(rng.random((300, 128), dtype=np.float32))
    idx2 = torch.from_numpy(rng.integers(0, 300, size=(6 * 40, 128), dtype=np.int32))
    idx1 = torch.from_numpy(rng.integers(0, 300, size=6 * 40, dtype=np.int32))
    cols2 = torch.from_numpy(rng.integers(0, 300, size=(2, 8192, 3), dtype=np.int32))
    data2 = torch.from_numpy(rng.random((2, 8192, 3), dtype=np.float32))
    qj = torch.from_numpy(rng.integers(0, 128, size=6 * 40, dtype=np.int32))
    x, cols, data = _e1_inputs(n=1000)
    x2 = t_spmv.make_table(torch.from_numpy(x), True)
    cols, data = torch.from_numpy(cols), torch.from_numpy(data)
    return {
        "lane_gather": (t_vmem.lane_gather, t_vmem.lane_gather_plain, (table, idx2)),
        "row_gather_sum": (t_vmem.row_gather_sum, t_vmem.row_gather_sum_plain, (table, idx1, 40)),
        "row_pick_bf16": (t_vmem.row_pick_bf16, t_vmem.row_pick_bf16_plain, (table, idx1)),
        "scalar_gather_sum": (t_vmem.scalar_gather_sum, t_vmem.scalar_gather_sum_plain, (table, idx1, qj, 40)),
        "lane_gather_blocksum": (t_vmem2.lane_gather_blocksum, t_vmem2.lane_gather_blocksum_plain, (table, idx2, 40)),
        "row_pick_blocksum": (t_vmem2.row_pick_blocksum, t_vmem2.row_pick_blocksum_plain, (table, idx1, 40)),
        "pick_scale_wsum": (t_vmem2.pick_scale_wsum, t_vmem2.pick_scale_wsum_plain, (table, cols2, data2)),
        "spmv_products": (t_spmv.products, t_spmv.products_plain, (x2, cols, data)),
    }


@pytest.mark.parametrize("name", sorted(_probe_calls(np.random.default_rng(0))))
def test_entry_points_take_the_plain_version_on_the_cpu(name):
    entry, plain, args = _probe_calls(np.random.default_rng(1))[name]
    _cuda.reset_launch_counts()
    got = entry(*args)
    assert torch.equal(got, plain(*args))
    assert _cuda.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", sorted(set(_probe_calls(np.random.default_rng(0))) - {"spmv_products"}))
def test_entry_points_refuse_indices_outside_the_table(name):
    entry, _, args = _probe_calls(np.random.default_rng(2))[name]
    args = list(args)
    args[1] = args[1].clone()
    args[1].view(-1)[7] = args[0].shape[0]
    with pytest.raises(IndexError):
        entry(*args)
    args[1].view(-1)[7] = -1
    with pytest.raises(IndexError):
        entry(*args)


@pytest.mark.parametrize("name", sorted(_probe_calls(np.random.default_rng(0))))
def test_entry_points_send_other_devices_to_the_kernel(name):
    # a tensor that is not on the CPU never takes the plain version: the
    # launcher refuses what is not a CUDA device
    entry, _, args = _probe_calls(np.random.default_rng(3))[name]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        entry(*meta)


def test_runners_keep_the_probes_parameters():
    with pytest.raises(ValueError):
        t_vmem.p1(512, 1000, 512, device=CPU)  # 1000 rows do not split into blocks of 512
    with pytest.raises(ValueError):
        t_vmem.p2(256, 2000, 1024, device=CPU)
    with pytest.raises(ValueError, match="bf16"):
        t_vmem.p3(512, 2048, 1024, dtype=torch.float32, device=CPU)
    assert t_vmem.p1(8192, 512, 512, device=CPU).inputs["table"].shape == (8192, 128)


def test_run_rate_in_the_probes_units():
    run = common.Run("p", {}, (), 2_000_000, "M rows/s", 0.5)
    assert run.rate == pytest.approx(4000.0)
    assert common.Run("p", {}, (), 2_000_000_000, "G gathers/s", 1.0).rate == pytest.approx(2000.0)
    assert common.Run("p", {}, (), 1, "M loads/s", None).rate is None
    assert common.time_on_card(torch.device(CPU), lambda: None) is None


# ------------------------------------------------------------------ E5 and E8 plans
@pytest.mark.parametrize("rows", [1, 37, 391, 401, 402, 2000, 8192, 100_000])
def test_row_pick_count_plan_covers_the_table_once_within_shared_memory(rows):
    plan = _cuda.row_pick_count_plan(rows)
    bounds = [(s * plan.height, min((s + 1) * plan.height, rows)) for s in range(plan.n_slices)]
    assert all(hi > lo for lo, hi in bounds)  # no slice is empty
    held = np.concatenate([np.arange(lo, hi) for lo, hi in bounds])
    assert np.array_equal(held, np.arange(rows))  # every row in exactly one slice
    # the slice and a row of counts a warp, padded to 16 bytes
    counts = _cuda.COUNT_WARPS * -(-plan.height // 4) * 16
    assert plan.smem_bytes == plan.height * _cuda.PROBE_ROW_BYTES + counts <= _cuda.SMEM_BLOCK_BYTES
    # as few slices as fit: 401 rows do, 402 do not
    assert plan.n_slices == -(-rows // 401)


@pytest.mark.parametrize("n_slices,n_blocks,grid", [(21, 285, 132), (250, 3, 132), (1, 1, 1), (21, 1, 21), (3, 40, 7)])
def test_count_units_cover_every_slice_and_block_once(n_slices, n_blocks, grid):
    units = _cuda.count_units(n_slices, n_blocks, grid)
    flat = [u for cta in units for u in cta]
    assert sorted(flat) == [(s, b) for s in range(n_slices) for b in range(n_blocks)]
    assert len(flat) == len(set(flat))
    groups = [len({(s, b // _cuda.COUNT_WARPS) for s, b in cta}) for cta in units]
    assert max(groups) - min(groups) <= 1  # units of COUNT_WARPS blocks, balanced
    # a CTA's units are slice-major, so it holds each of its slices once
    for cta in units:
        slices = [s for s, _ in cta]
        assert slices == sorted(slices)


def test_row_pick_bf16_strip_resident_up_to_the_budget():
    assert _cuda.row_pick_bf16_resident(512)  # the probe's strip
    assert _cuda.row_pick_bf16_resident(520) and not _cuda.row_pick_bf16_resident(521)
    assert not _cuda.row_pick_bf16_resident(8192)
    ring = _cuda.PICK_STAGES * _cuda.PICK_TILE * _cuda.PROBE_ROW_BYTES
    assert 520 * _cuda.PROBE_ROW_BYTES // 2 + ring <= _cuda.SMEM_BLOCK_BYTES


def test_row_pick_blocksum_launcher_takes_only_its_routes():
    table, cols = torch.zeros((8, 128)), torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        _cuda.row_pick_blocksum(table, cols, torch.empty((16, 128)), 8, route="slices")
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.row_pick_blocksum(table, cols, torch.empty((16, 128)), 8)


# ------------------------------------------------------------------ E1 and E7 routes
@pytest.mark.parametrize("hilo", [True, False])
def test_spmv_products_table_resident_up_to_the_budget(hilo):
    assert _cuda.spmv_products_resident(512, hilo)  # the benchmark's table: x of 65,536
    assert _cuda.spmv_products_resident(904, hilo) and not _cuda.spmv_products_resident(905, hilo)
    assert not _cuda.spmv_products_resident(0, hilo)
    # bf16: every CTA holds the table; hi|lo: each CTA of a pair half its rows
    held = -(-904 // 2) * 2 * 128 * 2 if hilo else 904 * 128 * 2
    assert held <= _cuda.SMEM_BLOCK_BYTES < held + (1024 if hilo else 256)
    assert _cuda.spmv_products_design(512, hilo) == ("smem_pairs" if hilo else "smem")
    assert _cuda.spmv_products_design(905, hilo) == "l2"


def test_lane_slice_resident_up_to_the_budget():
    assert _cuda.lane_slice_resident(512)  # g1's table: 64 KB a 32-lane slice
    assert _cuda.lane_slice_resident(1792) and not _cuda.lane_slice_resident(1793)
    assert not _cuda.lane_slice_resident(8192) and not _cuda.lane_slice_resident(0)  # g1b's: 1 MB a slice
    sums = _cuda.SLICE_WARPS * _cuda.SLICE_LANES * 4  # beside each warp's 32 sums
    assert 1792 * _cuda.SLICE_LANES * 4 + sums <= _cuda.SMEM_BLOCK_BYTES < 1793 * _cuda.SLICE_LANES * 4 + sums


@pytest.mark.parametrize("rows,T,splits", [(512, 512, None), (8192, 8192, 128), (200, 200, None), (1793, 64, 1), (1793, 65, 2)])
def test_lane_blocksum_scratch_follows_the_route(rows, T, splits):
    out, partial, tickets = t_vmem2._blocksum_buffers(3, T, rows, CPU)
    assert out.shape == (24, 128)
    if splits is None:  # the slice route: a CTA a lane slice and block, no scratch
        assert partial is None and tickets is None
    else:
        assert partial.shape == (3, splits, 128) and tickets.shape == (3,) and not tickets.any()


# ------------------------------------------------------------------ E3 and E4 plans
@pytest.mark.parametrize("rows,design", [(1, "slices"), (512, "slices"), (1808, "slices"), (1809, "l2"), (8192, "l2")])
def test_lane_gather_design_takes_slices_up_to_the_budget(rows, design):
    assert _cuda.lane_gather_design(rows) == design
    # a 32-lane column slice, 128 bytes a row, and no warp sums beside it
    assert (rows * _cuda.SLICE_LANES * 4 <= _cuda.SMEM_BLOCK_BYTES) == (design == "slices")
    assert 1808 * 128 <= _cuda.SMEM_BLOCK_BYTES < 1809 * 128


@pytest.mark.parametrize("seg_len", [1, 37, 1024, 5000])
@pytest.mark.parametrize("n_seg", [1, 128, 300])
def test_row_gather_sum_plan_keeps_the_sms_busy(seg_len, n_seg):
    sms = 132
    plan = _cuda.row_gather_sum_plan(seg_len, n_seg, sms)
    wps, spc, ctas = plan
    # a warp for each 32 picks, one CTA of 32 warps for a segment of 1,024 or more
    assert wps == min(32, -(-seg_len // 32)) and (wps == 32) == (seg_len > 992)
    assert wps * spc * 32 <= 1024 and (spc == 1 or wps * spc <= _cuda.ROW_SUM_SHARED_WARPS)
    assert ctas == -(-n_seg // spc) and (ctas - 1) * spc < n_seg <= ctas * spc
    # segments share a CTA only while every SM still gets one
    assert spc == 1 or ctas >= sms
    # p2's defaults: one CTA of 1,024 threads a segment, 128 of the 132 SMs
    if (seg_len, n_seg) == (1024, 128):
        assert plan == (32, 1, 128)
    if seg_len == 1 and n_seg == 300:
        assert plan == (1, 2, 150)


def test_row_gather_sum_plan_refuses_empty_segments():
    with pytest.raises(ValueError):
        _cuda.row_gather_sum_plan(0, 4, 132)

