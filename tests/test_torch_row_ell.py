"""The port's row-ELL layout and products against sparse_tpu's (CPU).

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
CUDA kernels themselves are held against those in
tests/test_torch_kernels_gpu.py. Tolerances: float64 exact paths at
rtol=1e-10, atol=1e-12 (as tests/test_row_ell.py); against sparse_tpu's
one-hot Pallas SpMV (interpret mode, relative error ~1e-6 by design) at
rtol=1e-3, atol=1e-5 (as tests/test_row_ell.py:153).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse_tpu.kernels import row_ell as jre
from sparse_tpu_torch._utils import torch_dtype
from sparse_tpu_torch.interop import row_ell_from_arrays
from sparse_tpu_torch.kernels import _cuda
from sparse_tpu_torch.kernels import row_ell as tre

CPU = "cpu"
EXACT = dict(rtol=1e-10, atol=1e-12)


def _random_problem(m, k, density, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        # hub rows: Zipf-ish degree distribution
        raw = rng.zipf(1.4, size=int(m * k * density * 3))
        rows = (raw[raw <= m] - 1).astype(np.int64)
        cols = rng.integers(0, k, size=rows.size)
        lin = np.unique(rows * k + cols)
    else:
        lin = np.unique(rng.integers(0, m * k, size=int(m * k * density), dtype=np.int64))
    rows, cols = (lin // k).astype(np.int64), (lin % k).astype(np.int64)
    data = rng.standard_normal(lin.size)
    return rows, cols, data


SHAPES = [((300, 200), 0.02), ((64, 512), 0.05), ((1000, 128), 0.005)]
LAYOUTS = [dict(), dict(max_tiers=4), dict(group=0), dict(group=0, min_pad=4, max_tiers=3), dict(group=8)]


def _problem(shape, density, skew):
    m, k = shape
    return _random_problem(m, k, density, seed=m * 7 + k + int(skew), skew=skew)


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
@pytest.mark.parametrize("shape,density", SHAPES)
@pytest.mark.parametrize("skew", [False, True])
def test_layout_identical_to_sparse_tpu(shape, density, skew, layout):
    kw = LAYOUTS[layout]
    rows, cols, data = _problem(shape, density, skew)
    j = jre.build_row_ell(rows, cols, data, *shape, **kw)
    t = tre.build_row_ell(rows, cols, data, *shape, device=CPU, **kw)
    assert (t.n_rows, t.n_cols, t.nz_rows) == (j.n_rows, j.n_cols, j.nz_rows)
    assert len(t.tiers) == len(j.tiers)
    for (tc, td), (jc, jd) in zip(t.tiers, j.tiers):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert tc.dtype == torch.int32 and torch_dtype(np.asarray(jd).dtype) == td.dtype
    np.testing.assert_array_equal(t.perm_inv.numpy(), np.asarray(j.perm_inv))
    # the kernels' view of the same layout: every position maps back to its row
    rop = t.row_of_pos.numpy()
    np.testing.assert_array_equal(rop[t.perm_inv.numpy()], np.arange(shape[0]))
    assert (rop >= 0).sum() == shape[0]
    table = t.tier_table.numpy()
    assert table.shape == (len(t.tiers) + 1, 4) and table[-1, 1] == 0
    assert t.flat_cols.numel() == sum(c.numel() for c, _ in t.tiers) == table[-1, 3]


@pytest.mark.parametrize("shape,density", SHAPES)
@pytest.mark.parametrize("skew", [False, True])
def test_plain_products_match_sparse_tpu_exact(shape, density, skew):
    m, k = shape
    rows, cols, data = _problem(shape, density, skew)
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((k, 16))
    x = dense[:, 0].copy()
    y = rng.standard_normal(m)
    j = jre.build_row_ell(rows, cols, data, m, k)
    t = tre.build_row_ell(rows, cols, data, m, k, device=CPU)
    want_m = np.asarray(jre.row_ell_spmm(j, jnp.asarray(dense)))
    want_v = np.asarray(jre.row_ell_spmv(j, jnp.asarray(x), strategy="exact"))
    np.testing.assert_allclose(tre.row_ell_spmm(t, torch.as_tensor(dense)).numpy(), want_m, **EXACT)
    np.testing.assert_allclose(tre.row_ell_spmv(t, torch.as_tensor(x)).numpy(), want_v, **EXACT)
    np.testing.assert_allclose(tre.row_ell_spmv(t, torch.as_tensor(x), strategy="exact").numpy(), want_v, **EXACT)
    out_y = tre.row_ell_spmv(t, torch.as_tensor(x), y=torch.as_tensor(y))
    np.testing.assert_allclose(out_y.numpy(), want_v + y, **EXACT)
    np.testing.assert_allclose(tre.row_ell_spmm_program(t)(torch.as_tensor(dense)).numpy(), want_m, **EXACT)


@pytest.mark.parametrize("layout", [0, 2])
def test_layout_from_sparse_tpu_arrays_reproduces_its_products(layout):
    kw = LAYOUTS[layout]
    rows, cols, data = _problem((300, 200), 0.02, True)
    j = jre.build_row_ell(rows, cols, data, 300, 200, **kw)
    t = row_ell_from_arrays(
        [(np.asarray(c), np.asarray(d)) for c, d in j.tiers], np.asarray(j.perm_inv), j.n_rows, j.n_cols, j.nz_rows, CPU
    )
    dense = np.random.default_rng(2).standard_normal((200, 5))
    np.testing.assert_allclose(
        tre.row_ell_spmm(t, torch.as_tensor(dense)).numpy(), np.asarray(jre.row_ell_spmm(j, jnp.asarray(dense))), **EXACT
    )
    x = dense[:, 1].copy()
    np.testing.assert_allclose(
        tre.row_ell_spmv(t, torch.as_tensor(x)).numpy(), np.asarray(jre.row_ell_spmv(j, jnp.asarray(x))), **EXACT
    )


@pytest.mark.parametrize("strategy", ["onehot", "onehot3"])
@pytest.mark.parametrize("m,k,density", [(150, 300, 0.05), (96, 8192, 0.004)])
def test_spmv_vs_sparse_tpu_onehot_interpret(strategy, m, k, density):
    rng = np.random.default_rng(11)
    dense = (rng.random((m, k)) * (rng.random((m, k)) < density)).astype(np.float32)
    r, c = np.nonzero(dense)
    args = (r.astype(np.int32), c.astype(np.int32), dense[r, c], m, k)
    x = rng.random(k, dtype=np.float32)
    want = np.asarray(jre.row_ell_spmv(jre.build_row_ell(*args), jnp.asarray(x), strategy=strategy, interpret=True))
    got = tre.row_ell_spmv(tre.build_row_ell(*args, device=CPU), torch.as_tensor(x), strategy=strategy)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)

    # empty matrix
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32), 5, 7)
    want0 = np.asarray(jre.row_ell_spmv(jre.build_row_ell(*empty), jnp.ones(7, jnp.float32), strategy=strategy, interpret=True))
    got0 = tre.row_ell_spmv(tre.build_row_ell(*empty, device=CPU), torch.ones(7), strategy=strategy)
    np.testing.assert_array_equal(got0.numpy(), want0)


def test_onehot_max_k_refused_by_both():
    k = jre.ONEHOT_SPMV_MAX_K + 1
    assert tre.ONEHOT_SPMV_MAX_K == jre.ONEHOT_SPMV_MAX_K
    rows, cols, data = np.array([0, 1]), np.array([0, k - 1]), np.array([1.0, 2.0])
    x = np.zeros(k, dtype=np.float32)
    t = tre.build_row_ell(rows, cols, data, 2, k, device=CPU)
    for strategy in ("onehot", "onehot3"):
        with pytest.raises(ValueError, match="requires n_cols"):
            jre.row_ell_spmv(jre.build_row_ell(rows, cols, data, 2, k), jnp.asarray(x), strategy=strategy)
        with pytest.raises(ValueError, match="requires n_cols"):
            tre.row_ell_spmv(t, torch.as_tensor(x), strategy=strategy)
    # the exact strategy takes it
    np.testing.assert_array_equal(tre.row_ell_spmv(t, torch.as_tensor(x)).numpy(), [0.0, 0.0])


def test_empty_and_degenerate():
    t = tre.build_row_ell(np.array([], dtype=np.int64), np.array([], dtype=np.int64), np.array([]), 10, 7, device=CPU)
    assert t.tiers == () and t.row_of_pos.numel() == 10
    np.testing.assert_array_equal(tre.row_ell_spmm(t, torch.ones((7, 3), dtype=torch.float64)).numpy(), np.zeros((10, 3)))
    np.testing.assert_array_equal(tre.row_ell_spmv(t, torch.ones(7, dtype=torch.float64)).numpy(), np.zeros(10))
    # a layout without tiers promotes like sparse_tpu: to the operand's dtype
    assert tre.row_ell_spmv(t, torch.ones(7)).dtype == torch.float32
    # a single dense-ish row
    t = tre.build_row_ell(np.zeros(5, dtype=np.int64), np.arange(5), np.arange(1.0, 6.0), 3, 5, device=CPU)
    np.testing.assert_allclose(tre.row_ell_spmv(t, torch.ones(5, dtype=torch.float64)).numpy(), [15.0, 0, 0])
    # zero rows
    t = tre.build_row_ell(np.array([], dtype=np.int64), np.array([], dtype=np.int64), np.array([]), 0, 4, device=CPU)
    assert tre.row_ell_spmm(t, torch.ones((4, 2), dtype=torch.float64)).shape == (0, 2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("group", [16, 0])
def test_spmm_with_no_columns_matches_sparse_tpu(dtype, group):
    # a product with N = 0: an empty (n_rows, 0) result, as sparse_tpu returns
    import sparse_tpu as jsp
    import sparse_tpu_torch as st

    x = (np.eye(4)[:, :3] * 2.0).astype(dtype)
    b = np.zeros((3, 0), dtype=dtype)
    want = np.asarray(jsp.COO.from_numpy(x) @ b)
    got = st.COO.from_numpy(x, device=CPU) @ b
    assert got.shape == want.shape == (4, 0) and got.dtype == torch_dtype(want.dtype)
    t = tre.build_row_ell(*np.nonzero(x), x[np.nonzero(x)], 4, 3, group=group, device=CPU)
    out = tre.row_ell_spmm(t, torch.as_tensor(b))
    assert out.shape == (4, 0) and out.dtype == torch_dtype(dtype)


def test_mixed_dtypes_promote():
    rows, cols, data = _problem((64, 512), 0.05, False)
    t32 = tre.build_row_ell(rows, cols, data.astype(np.float32), 64, 512, device=CPU)
    x64 = np.random.default_rng(3).standard_normal(512)
    out = tre.row_ell_spmv(t32, torch.as_tensor(x64))
    assert out.dtype == torch.float64
    want = np.zeros(64)
    np.add.at(want, rows, data.astype(np.float32).astype(np.float64) * x64[cols])
    np.testing.assert_allclose(out.numpy(), want, **EXACT)


def test_wrapper_argument_errors():
    t = tre.build_row_ell(np.array([0]), np.array([1]), np.array([1.0]), 2, 3, device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        tre.row_ell_spmm(t, torch.ones((4, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="does not fit"):
        tre.row_ell_spmv(t, torch.ones(3, dtype=torch.float64), y=torch.ones(3, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        tre.row_ell_spmv(tre.build_row_ell(np.array([0]), np.array([1]), np.array([1]), 2, 3, device=CPU), torch.ones(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tre.row_ell_spmv(t, np.ones(3))
    with pytest.raises(ValueError, match="unknown strategy"):
        tre.row_ell_spmv(t, torch.ones(3, dtype=torch.float64), strategy="lanes")


def test_program_is_memoized_per_layout():
    rows, cols, data = _problem((300, 200), 0.02, False)
    t = tre.build_row_ell(rows, cols, data, 300, 200, device=CPU)
    assert tre.row_ell_spmm_program(t) is tre.row_ell_spmm_program(t)
    t2 = tre.build_row_ell(rows, cols, data, 300, 200, device=CPU)
    assert tre.row_ell_spmm_program(t2) is not tre.row_ell_spmm_program(t)


# ---------------------------------------------------------------- the staged K2 kernel's plan
def _brute_plan(t, n, vec):
    """Units, chunks and zero positions of the staged kernel by walking the
    layout's positions one at a time."""
    groups = chunks = 0
    for c, _ in t.tiers:
        for _g in range(c.shape[0]):
            groups += 1
            j0 = 0
            while j0 < c.shape[1]:
                chunks += 1
                j0 += _cuda.ROW_ELL_STAGE_J
    tiles = -(-n // (32 * vec))
    return groups * tiles, chunks * tiles, t.row_of_pos.numel() - _cuda.ROW_ELL_GROUP * groups


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
@pytest.mark.parametrize("shape,density", SHAPES)
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("n,vec", [(128, 4), (37, 1), (300, 2)])
def test_staged_plan_walks_every_position(shape, density, skew, layout, n, vec):
    kw = LAYOUTS[layout]
    rows, cols, data = _problem(shape, density, skew)
    t = tre.build_row_ell(rows, cols, data, *shape, device=CPU, **kw)
    staged = _cuda.row_ell_staged_layout(t)
    assert staged == (kw.get("group", 16) == _cuda.ROW_ELL_GROUP)
    if not staged:
        return
    plan = _cuda.row_ell_plan(t, n, vec, torch.float64)
    assert (plan.units, plan.chunks, plan.zero_positions) == _brute_plan(t, n, vec)
    assert plan.col_tiles == -(-n // (32 * vec)) and plan.groups * _cuda.ROW_ELL_GROUP == t.tier_table[-1, 0]
    # every unit's index block starts on 16 entries: the bulk copies' 16-byte alignment
    assert all(int(off) % _cuda.ROW_ELL_GROUP == 0 for off in t.tier_table[:, 3])


@pytest.mark.parametrize("width,chunks", [(1, 1), (18, 1), (63, 1), (64, 1), (65, 2), (128, 2), (129, 3), (1500, 24)])
def test_staged_chunks_per_width(width, chunks):
    assert _cuda.row_ell_chunks(width) == chunks


@pytest.mark.parametrize("dtype,nbytes", [(torch.float32, 64 * 16 * 8 + 64), (torch.float64, 64 * 16 * 12 + 64)])
def test_staged_stage_bytes(dtype, nbytes):
    assert _cuda.row_ell_stage_bytes(dtype) == nbytes and nbytes % 16 == 0


def test_staged_plan_of_the_bench_layout():
    # bench.py's matrix as chip_smoke.py draws it: 65,536², 2^21 draws of
    # default_rng(0), duplicates summed; 32 tiers of widths 18-59, one stage
    # a unit
    m = k = 1 << 16
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, m * k, size=1 << 21, dtype=np.int64))
    t = tre.build_row_ell(lin // k, lin % k, np.ones(lin.size, np.float32), m, k, device=CPU)
    widths = [c.shape[1] for c, _ in t.tiers]
    assert len(widths) == 32 and (min(widths), max(widths)) == (18, 59)
    assert lin.size == 2_096_628 and t.flat_cols.numel() == 2_105_696
    # 65,536 rows in 4,111 groups of 16: each tier pads its rows up to whole
    # groups (240 padding positions), no row without entries
    plan = _cuda.row_ell_plan(t, 128, 4, torch.float32)
    assert plan == _cuda.RowEllPlan(
        groups=4111, col_tiles=1, units=4111, chunks=4111, zero_positions=0, stage_bytes=8256
    )
    assert int((t.row_of_pos < 0).sum()) == 4111 * 16 - m


# ---------------------------------------------------------------- K1's cluster plan
def _layout_of(m, k, nnz, seed, dtype=np.float32, **kw):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * k, size=nnz, dtype=np.int64))
    return tre.build_row_ell(lin // k, lin % k, rng.random(lin.size).astype(dtype), m, k, device=CPU, **kw)


@pytest.mark.parametrize(
    "dtype,n_cols,cluster,slice_log2",
    [
        (torch.float32, 65_536, 2, 15),  # the bench shape: two slices of 128 KB
        (torch.float64, 65_536, 4, 14),
        (torch.float32, 65_537, 3, 15),  # one column past two slices
        (torch.float64, 100_000, 7, 14),  # the spmv_add shape
        (torch.float32, 262_144, 8, 15),  # the widest x the cluster kernel holds
        (torch.float32, 262_145, 9, 15),
        (torch.float64, 131_072, 8, 14),
        (torch.float64, 131_073, 9, 14),
        (torch.float32, 1000, 1, 10),  # a small x: one CTA, the least power of two that holds it
        (torch.float64, 16, 1, 4),
        (torch.float32, 3, 1, 4),  # slices of at least 16 values
    ],
)
def test_spmv_plan_cluster_and_slice(dtype, n_cols, cluster, slice_log2):
    t = _layout_of(50, n_cols, 200, n_cols)
    plan = _cuda.row_ell_spmv_plan(t, dtype)
    assert (plan.cluster, plan.slice_log2) == (cluster, slice_log2)
    assert plan.fits == (cluster <= _cuda.SPMV_MAX_CLUSTER)
    assert (1 << slice_log2) * dtype.itemsize <= _cuda.SPMV_SLICE_BYTES
    assert cluster << slice_log2 >= n_cols > (cluster - 1) << slice_log2 or n_cols <= 16


def test_spmv_plan_of_the_spmv_add_shape():
    # sparse_tpu/ops/dot.py:580: 99,990 x 100,000 at density 1e-6, float64
    t = _layout_of(99_990, 100_000, 9_999, 3, dtype=np.float64)
    assert _cuda.row_ell_spmv_plan(t, torch.float64) == _cuda.SpmvPlan(cluster=7, slice_log2=14, fits=True)


def test_spmv_plan_of_the_bench_layout():
    m = k = 1 << 16
    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, m * k, size=1 << 21, dtype=np.int64))
    t = tre.build_row_ell(lin // k, lin % k, np.ones(lin.size, np.float32), m, k, device=CPU)
    assert t.flat_cols.numel() == 2_105_696
    for dtype, cluster, slice_log2 in ((torch.float32, 2, 15), (torch.float64, 4, 14)):
        assert _cuda.row_ell_spmv_plan(t, dtype) == _cuda.SpmvPlan(cluster, slice_log2, True)


def test_spmv_refuses_an_unknown_kernel_name():
    t = _layout_of(20, 30, 50, 5)
    for kernel in ("fast", None):
        with pytest.raises(ValueError, match="kernel must be one of"):
            _cuda.spmv(t, torch.ones(30), None, torch.empty(20), kernel=kernel)
    with pytest.raises(ValueError, match="run on a CUDA device"):
        _cuda.spmv(t, torch.ones(30), None, torch.empty(20), kernel="cluster")
