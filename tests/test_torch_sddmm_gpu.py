"""K4, the SDDMM kernel (``csrc/sddmm.cu``), K5, its gradient's weighted row
sum (``csrc/mttkrp.cu``), and the products that reach the card through this
slice's entry points, on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_sddmm_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). K4 against its
plain version (``sddmm_plain``) on the same card: the two sum each entry's
products in another order, so each entry is held at ``|got - want| <=
tol · |s| · Σ_k |lhs_ik · rhs_kj|`` with tol 1e-5 in float32 and 1e-12 in
float64 (a sum of K products rounded in either order stays within about
K/32 · eps of that scale). Dense × sparse on the card against the port's CPU
result at rtol 1e-5 (float32) or 1e-12 (float64), and bit for bit equal to
``(b.T @ a.T).T``, the route it takes through K1/K2. K4 sums each entry in
one order whatever the layout of its operands and whichever route, so
those are held bit for bit; K5 adds each segment in a fixed order, so it
gives the same bits on every launch (the atomics of ``index_add`` did not).
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import LAUNCHES, _cuda, dot

pytestmark = pytest.mark.gpu

NORM_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _problem(m, n, k, nnz, dtype, device, seed=0, idx=torch.int32):
    rng = np.random.default_rng(seed)
    lin = np.sort(rng.integers(0, m * n, nnz))
    rows = torch.as_tensor(lin // n, dtype=idx, device=device)
    cols = torch.as_tensor(lin % n, dtype=idx, device=device)
    s = torch.as_tensor(rng.standard_normal(nnz), dtype=dtype, device=device)
    lhs = torch.as_tensor(rng.standard_normal((m, k)), dtype=dtype, device=device)
    rhs = torch.as_tensor(rng.standard_normal((k, n)), dtype=dtype, device=device)
    return rows, cols, s, lhs, rhs


def _layout(t, kind):
    """``t`` (2-D) with the same values as a row-major, a transposed view or
    a column-sliced (strided rows) tensor."""
    if kind == "row_major":
        return t.contiguous()
    if kind == "transposed":
        return t.T.contiguous().T
    wide = torch.zeros((t.shape[0], t.shape[1] + 3), dtype=t.dtype, device=t.device)
    wide[:, 1 : 1 + t.shape[1]] = t
    return wide[:, 1 : 1 + t.shape[1]]


def _scale(rows, cols, s, lhs, rhs):
    return s.abs() * (lhs[rows.long()].abs() * rhs.T[cols.long()].abs()).sum(-1)


def _assert_norm_close(got, want, scale, tol, what):
    err = (got - want).abs()
    bad = err > tol * scale
    worst = float((err / scale.clamp_min(1e-300)).max())
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} entries off, worst {worst}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 7, 32, 128, 10_000])
@pytest.mark.parametrize("lhs_layout", ["row_major", "transposed"])
@pytest.mark.parametrize("rhs_layout", ["row_major", "transposed", "strided"])
def test_k4_matches_plain(cuda, dtype, k, lhs_layout, rhs_layout):
    nnz = 300 if k == 10_000 else 5000
    rows, cols, s, lhs, rhs = _problem(200, 150, k, nnz, dtype, cuda, seed=k)
    lhs, rhs = _layout(lhs, lhs_layout), _layout(rhs, rhs_layout)
    before = LAUNCHES["sddmm"]
    got = dot.sddmm(rows, cols, s, lhs, rhs)
    assert LAUNCHES["sddmm"] == before + 1
    want = dot.sddmm_plain(rows, cols, s, lhs, rhs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.device.type == "cuda" and got.shape == (nnz,)
    _assert_norm_close(got, want, _scale(rows, cols, s, lhs, rhs), NORM_TOL[dtype], f"K={k}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_same_bits_twice_and_int64_indices(cuda, dtype):
    rows, cols, s, lhs, rhs = _problem(500, 400, 128, 20_000, dtype, cuda, seed=3)
    first = dot.sddmm(rows, cols, s, lhs, rhs.T.contiguous().T)
    second = dot.sddmm(rows, cols, s, lhs, rhs.T.contiguous().T)
    wide = dot.sddmm(rows.long(), cols.long(), s, lhs, rhs.T.contiguous().T)
    assert torch.equal(first, second) and torch.equal(first, wide)


def test_k4_chunked_size_matches_plain(cuda):
    # above SDDMM_CHUNK_MIN_NNZ the plain version runs in chunks
    nnz = dot.SDDMM_CHUNK_MIN_NNZ + 1234
    rows, cols, s, lhs, rhs = _problem(2048, 2048, 16, nnz, torch.float32, cuda, seed=11)
    got = dot.sddmm(rows, cols, s, lhs, rhs)
    want = dot.sddmm_plain(rows, cols, s, lhs, rhs)
    _assert_norm_close(got, want, _scale(rows, cols, s, lhs, rhs), NORM_TOL[torch.float32], "chunked")


def test_k4_empty_output_launches_nothing(cuda):
    rows, cols, s, lhs, rhs = _problem(20, 30, 8, 0, torch.float32, cuda)
    before = LAUNCHES["sddmm"]
    out = dot.sddmm(rows, cols, s, lhs, rhs)
    assert out.shape == (0,) and out.device.type == "cuda" and LAUNCHES["sddmm"] == before


def test_k4_rejects_what_it_does_not_take(cuda):
    rows, cols, s, lhs, rhs = _problem(20, 30, 8, 10, torch.float32, cuda)
    out = torch.empty(10, device=cuda)
    with pytest.raises(ValueError, match="unit stride on neither axis"):
        _cuda.sddmm(rows, cols, s, torch.zeros((20, 16), device=cuda)[:, ::2], rhs.T, out)
    with pytest.raises(ValueError, match="route"):
        _cuda.sddmm(rows, cols, s, lhs, rhs.T, out, route="kept_row_everywhere")
    with pytest.raises(ValueError, match="route"):  # an MN-major operand takes the per-entry route
        _cuda.sddmm(rows, cols, s, lhs, rhs.contiguous().T, out, route="kept_row")
    with pytest.raises(TypeError, match="float32 or float64"):
        _cuda.sddmm(rows, cols, s.half(), lhs.half(), rhs.T.half(), out.half())
    with pytest.raises(ValueError, match="is on"):
        dot.sddmm(rows, cols, s.cpu(), lhs, rhs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_gradients_match_plain(cuda, dtype):
    rows, cols, s, lhs, rhs = _problem(300, 200, 64, 4000, dtype, cuda, seed=5)
    w = torch.as_tensor(np.random.default_rng(6).standard_normal(4000), dtype=dtype, device=cuda)
    grads = []
    for fn in (dot.sddmm, dot.sddmm_plain):
        ins = [t.clone().requires_grad_(True) for t in (s, lhs, rhs)]
        (w * fn(rows, cols, *ins)).sum().backward()
        grads.append([t.grad for t in ins])
    for name, got, want in zip(("s", "lhs", "rhs"), *grads):
        scale = want.abs().max()
        assert float((got - want).abs().max()) <= NORM_TOL[dtype] * 10 * float(scale), name


def test_k4_second_order_on_the_card(cuda):
    rows, cols, s, lhs, rhs = _problem(12, 9, 5, 30, torch.float64, cuda, seed=7)
    ins = [t.clone().requires_grad_(True) for t in (s, lhs, rhs)]
    assert torch.autograd.gradgradcheck(lambda *a: dot.sddmm(rows, cols, *a), ins)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int64])
def test_sddmm_entry_point_matches_cpu(cuda, fmt, dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((40, 30)) * (rng.random((40, 30)) < 0.2)
    lhs, rhs = rng.standard_normal((40, 16)), rng.standard_normal((16, 30))
    scale = 3 if np.issubdtype(dtype, np.integer) else 1
    x, lhs, rhs = (np.round(v * scale, 8 if scale == 1 else 0).astype(dtype) for v in (x, lhs, rhs))
    outs = []
    for dev in ("cpu", cuda):
        s = st.COO.from_numpy(x, device=dev)
        s = s if fmt == "coo" else s.asformat(fmt)
        outs.append(st.sddmm(s, lhs, rhs))
    cpu, card = outs
    assert card.data.device.type == "cuda" and card.dtype == cpu.dtype and card.fill_value == cpu.fill_value
    assert torch.equal(card.coords.cpu(), cpu.coords)
    rtol = {np.float32: 1e-5, np.float64: 1e-12, np.float16: 1e-3, np.int64: 0}[dtype]
    np.testing.assert_allclose(card.data.cpu().numpy(), cpu.data.numpy(), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 9])
def test_dense_times_sparse_routes_through_the_transpose(cuda, fmt, dtype, m):
    rng = np.random.default_rng(9)
    x = (rng.random((300, 200)) * (rng.random((300, 200)) < 0.05)).astype(dtype)
    a_np = rng.random((m, 300)).astype(dtype)
    cpu = st.COO.from_numpy(x, device="cpu")
    card = st.COO.from_numpy(x, device=cuda)
    card = card if fmt == "coo" else card.asformat(fmt)
    a = torch.as_tensor(a_np, device=cuda)
    before = dict(LAUNCHES)
    got = a @ card
    kernel = "row_ell_spmv" if m == 1 else "row_ell_spmm"
    assert LAUNCHES[kernel] == before[kernel] + 1
    coo = card if fmt == "coo" else card._product_coo()
    assert torch.equal(got, (coo.T @ a[0])[None, :] if m == 1 else (coo.T @ a.T).T)
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.cpu().numpy(), (torch.as_tensor(a_np) @ cpu).numpy(), rtol=rtol, atol=rtol)
    vec = torch.as_tensor(a_np[0], device=cuda) @ card
    assert vec.shape == (200,) and torch.equal(vec, got[0] if m == 1 else (coo.T @ a[0]))


def test_batched_matmul_and_dot_on_the_card(cuda):
    rng = np.random.default_rng(10)
    x = rng.random((3, 20, 15)) * (rng.random((3, 20, 15)) < 0.2)
    b = rng.random((3, 15, 4))
    got = st.matmul(st.COO.from_numpy(x, device=cuda), torch.as_tensor(b, device=cuda))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), x @ b, rtol=1e-12)
    v = rng.random(15) * (rng.random(15) < 0.5)
    d = st.dot(st.COO.from_numpy(v, device=cuda), torch.as_tensor(v, device=cuda))
    assert d.shape == () and d.device.type == "cuda"
    np.testing.assert_allclose(float(d), v @ v, rtol=1e-12)


# ---------------------------------------------------------------------------
# K4's layouts and routes, bit for bit
# ---------------------------------------------------------------------------


def _launch(rows, cols, s, lhs_rows, rhs_rows, route=None):
    out = torch.empty_like(s)
    return _cuda.sddmm(rows, cols, s, lhs_rows, rhs_rows, out, route=route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 7, 128, 1000])
@pytest.mark.parametrize("lhs_layout", ["k_major", "mn_major"])
@pytest.mark.parametrize("rhs_layout", ["k_major", "mn_major"])
def test_k4_mn_major_equals_k_major_bit_for_bit(cuda, dtype, k, lhs_layout, rhs_layout):
    rows, cols, s, lhs, rhs = _problem(300, 200, k, 3000, dtype, cuda, seed=40 + k)
    rhs_t = rhs.T.contiguous()
    lhs_in = lhs if lhs_layout == "k_major" else lhs.T.contiguous().T
    rhs_in = rhs_t if rhs_layout == "k_major" else rhs.contiguous().T
    if k > 1:  # a single column is both
        assert _cuda.sddmm_k_major(lhs_in) == (lhs_layout == "k_major")
        assert _cuda.sddmm_k_major(rhs_in) == (rhs_layout == "k_major")
    want = _launch(rows, cols, s, lhs.contiguous(), rhs_t, route="per_entry")
    assert torch.equal(_launch(rows, cols, s, lhs_in, rhs_in), want)
    if _cuda.sddmm_route(k, lhs.element_size(), _cuda.sddmm_vec(lhs_in) and _cuda.sddmm_vec(rhs_in)) == "kept_row":
        assert torch.equal(_launch(rows, cols, s, lhs_in, rhs_in, route="kept_row"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [4, 8, 64, 128, 132, 256])  # rows of a multiple of 16 bytes up to 2 KB
@pytest.mark.parametrize("order", ["sorted", "unsorted", "short_rows"])
def test_k4_kept_row_equals_per_entry_bit_for_bit(cuda, dtype, k, order):
    assert _cuda.sddmm_route(k, 4 if dtype == torch.float32 else 8) == "kept_row"
    m = 40 if order == "sorted" else 3000  # about 100 entries a row, or about one
    rows, cols, s, lhs, rhs = _problem(m, 500, k, 4000, dtype, cuda, seed=k)
    if order == "unsorted":
        perm = torch.randperm(rows.numel(), generator=torch.Generator().manual_seed(k)).to(cuda)
        rows, cols, s = rows[perm], cols[perm], s[perm]
    rhs_t = rhs.T.contiguous()
    kept = _launch(rows, cols, s, lhs, rhs_t, route="kept_row")
    assert torch.equal(kept, _launch(rows, cols, s, lhs, rhs_t, route="per_entry"))
    assert torch.equal(kept, _launch(rows, cols, s, lhs, rhs_t))  # the default route is kept_row here
    want = dot.sddmm_plain(rows, cols, s, lhs, rhs)
    _assert_norm_close(kept, want, _scale(rows, cols, s, lhs, rhs), NORM_TOL[dtype], f"K={k} {order}")


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("route", ["kept_row", "per_entry"])
def test_k4_same_bits_twice_each_route(cuda, idx, route):
    rows, cols, s, lhs, rhs = _problem(700, 600, 128, 30_000, torch.float32, cuda, seed=9, idx=idx)
    first = _launch(rows, cols, s, lhs, rhs.T.contiguous(), route=route)
    assert torch.equal(first, _launch(rows, cols, s, lhs, rhs.T.contiguous(), route=route))
    assert torch.equal(first, _launch(rows.long(), cols.long(), s, lhs, rhs.T.contiguous(), route=route))


def test_k4_example_shape_reads_a_row_major_rhs_in_place(cuda):
    # examples/sddmm_example.py's layout at a smaller size: few entries, a row-major rhs
    rows, cols, s, lhs, rhs = _problem(2000, 2000, 2000, 50, torch.float64, cuda, seed=12)
    assert dot._sddmm_operand(rhs.T, 50).data_ptr() == rhs.data_ptr()
    got = dot.sddmm(rows, cols, s, lhs, rhs)
    assert torch.equal(got, _launch(rows, cols, s, lhs, rhs.T.contiguous()))
    _assert_norm_close(got, dot.sddmm_plain(rows, cols, s, lhs, rhs), _scale(rows, cols, s, lhs, rhs), 1e-12, "example")


# ---------------------------------------------------------------------------
# K5, the gradient's weighted row sum
# ---------------------------------------------------------------------------


def _k5_problem(n_seg, n_idx, k, nnz, dtype, cuda, seed, empty_every=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_seg, nnz)
    if empty_every:
        seg = seg - seg % empty_every  # only every empty_every-th segment has entries
    rows = torch.as_tensor(seg, device=cuda)
    cols = torch.as_tensor(rng.integers(0, n_idx, nnz), device=cuda)
    w = torch.as_tensor(rng.standard_normal(nnz), dtype=dtype, device=cuda)
    table = torch.as_tensor(rng.standard_normal((n_idx, k)), dtype=dtype, device=cuda)
    return rows, cols, w, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 6, 128, 300])
@pytest.mark.parametrize("shape", ["short", "long", "empty"])
@pytest.mark.parametrize("axis", [0, 1])
def test_k5_matches_plain_and_gives_the_same_bits_twice(cuda, dtype, k, shape, axis):
    # "long": segments of about 2,000 entries, past a piece of 256; "empty": most segments empty
    n_seg, empty_every = {"short": (500, 0), "long": (10, 0), "empty": (400, 7)}[shape]
    rows, cols, w, table = _k5_problem(n_seg, 300, k, 20_000, dtype, cuda, seed=k, empty_every=empty_every)
    # axis 1: the same sums along the second axis of the swapped pattern, through a stable sort
    pattern = dot.SddmmPattern(rows, cols, n_seg, 300) if axis == 0 else dot.SddmmPattern(cols, rows, 300, n_seg)
    seg, idx = pattern.ends[axis], pattern.ends[1 - axis]
    before = LAUNCHES["sampled_row_sum"]
    got = dot._SampledRowSum.apply(pattern, axis, w, table)
    again = dot._SampledRowSum.apply(pattern, axis, w, table)
    assert LAUNCHES["sampled_row_sum"] == before + 2
    want = dot.sampled_row_sum_plain(seg, idx, w, table, pattern.sizes[axis])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = dot.sampled_row_sum_plain(seg, idx, w.abs(), table.abs(), pattern.sizes[axis])
    _assert_norm_close(got, want, scale, NORM_TOL[dtype], f"K5 K={k} {shape}")
    if shape == "empty":
        assert bool((got[torch.arange(pattern.sizes[axis], device=cuda) % 7 != 0] == 0).all())


def test_k5_reads_a_strided_table_and_raises_on_an_mn_major_one(cuda):
    rows, cols, w, table = _k5_problem(50, 80, 128, 3000, torch.float32, cuda, seed=3)
    pattern = dot.SddmmPattern(rows, cols, 50, 80)
    wide = torch.zeros((80, 140), device=cuda)
    wide[:, 5:133] = table
    got = dot._SampledRowSum.apply(pattern, 0, w, wide[:, 5:133])  # 4-byte aligned rows: scalar loads
    assert torch.equal(got, dot._SampledRowSum.apply(pattern, 0, w, table))
    ptr, _, pieces, idx = pattern.plan(0)
    out = torch.empty((50, 128), device=cuda)
    tickets = _cuda.zeroed_tickets(cuda, 64)
    with pytest.raises(ValueError, match="unit stride along K"):
        _cuda.sampled_row_sum(ptr, pieces, idx, w, table.T.contiguous().T, out, out.flatten(), tickets)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sorted_rows", [False, True])
def test_sddmm_backward_runs_k5_without_a_host_read(cuda, dtype, sorted_rows):
    rows, cols, s, lhs, rhs = _problem(300, 200, 64, 4000, dtype, cuda, seed=5)
    w = torch.as_tensor(np.random.default_rng(6).standard_normal(4000), dtype=dtype, device=cuda)
    ins = [t.clone().requires_grad_(True) for t in (s, lhs, rhs)]
    pattern = dot.SddmmPattern(rows.long(), cols.long(), 300, 200, rows_sorted=sorted_rows)
    loss = (w * dot._sddmm(rows, cols, *ins, pattern=pattern)).sum()
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = torch.autograd.grad(loss, ins, retain_graph=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES["sampled_row_sum"] == before["sampled_row_sum"] + 2
    assert LAUNCHES["sddmm"] == before["sddmm"] + 1
    again = torch.autograd.grad(loss, ins)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sddmm_backward_bits_do_not_depend_on_the_row_hint(cuda, dtype):
    # sorted rows: the hinted plan (no sort) and the sorted one sum in the same order
    rows, cols, s, lhs, rhs = _problem(300, 200, 32, 5000, dtype, cuda, seed=8)
    g = torch.as_tensor(np.random.default_rng(9).standard_normal(5000), dtype=dtype, device=cuda)
    grads = []
    for hint in (False, True):
        ins = [t.clone().requires_grad_(True) for t in (s, lhs, rhs)]
        dot._sddmm(rows, cols, *ins, pattern=dot.SddmmPattern(rows.long(), cols.long(), 300, 200, rows_sorted=hint)).backward(g)
        grads.append([t.grad for t in ins])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_k5_second_order_on_the_card(cuda):
    rows, cols, w, table = _k5_problem(9, 7, 4, 40, torch.float64, cuda, seed=13)
    pattern = dot.SddmmPattern(rows, cols, 9, 7)
    ins = (w.requires_grad_(True), table.requires_grad_(True))
    for axis, tab in ((0, table), (1, torch.rand((9, 4), dtype=torch.float64, device=cuda, requires_grad=True))):
        f = lambda w_, t_, axis=axis: dot._SampledRowSum.apply(pattern, axis, w_, t_)  # noqa: E731
        assert torch.autograd.gradcheck(f, (ins[0], tab))
        assert torch.autograd.gradgradcheck(f, (ins[0], tab))
