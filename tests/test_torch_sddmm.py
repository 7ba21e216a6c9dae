"""The port's SDDMM (``kernels.sddmm``, ``sddmm``, its gradient) and the
ported ``jitops`` functions against sparse_tpu's own results (CPU).

Same inputs, drawn with numpy from a seed, through both packages. Values:
float64 at rtol 1e-12, float32 at rtol 1e-5 (the two sum each entry's
products in another order), float16 at rtol 1e-3 (both sum in float32 and
round once), integers exactly; dtypes, coordinates, shapes, fill values and
output types equal. The gradients pass ``gradcheck``/``gradgradcheck`` and
match ``jax.grad`` of the same loss at rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu import jitops as jjit
from sparse_tpu import kernels as jk
from sparse_tpu_torch import jitops as tjit
from sparse_tpu_torch import kernels as tk
from sparse_tpu_torch._utils import numpy_dtype

CPU = "cpu"
RTOL = {np.float64: 1e-12, np.float32: 1e-5, np.float16: 1e-3, np.complex128: 1e-12, np.int64: 0}


def _coo(m, n, nnz, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * n, size=nnz))
    return (lin // n).astype(np.int32), (lin % n).astype(np.int32), rng.standard_normal(lin.size).astype(dtype)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _jsddmm(*arrays):
    return np.asarray(jk.sddmm(*(jnp.asarray(x) for x in arrays)))


def _values(x, dtype, rng):
    if np.issubdtype(dtype, np.integer):
        return np.round(x * 3).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        return (x + 1j * rng.standard_normal(x.shape)).astype(dtype)
    return x.astype(dtype)


def _sample(dtype, seed=0, shape=(40, 30), density=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * (rng.random(shape) < density)
    return _values(x, dtype, rng)


def _assert_same_sddmm(got, want, rtol):
    assert isinstance(got, st.COO) and isinstance(want, jsp.COO)
    assert got.shape == want.shape and got.data.device.type == "cpu"
    assert numpy_dtype(got.dtype) == np.asarray(want.data).dtype
    assert got.fill_value == want.fill_value and np.asarray(got.fill_value).dtype == np.asarray(want.fill_value).dtype
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=rtol, atol=rtol)


# ---------------------------------------------------------------------------
# kernels.sddmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("size", ["monolithic", "chunked"])
def test_kernel_sddmm_matches_sparse_tpu(dtype, size):
    rng = np.random.default_rng(11)
    if size == "chunked":  # tests/test_kernels.py's chunked problem: nnz past SDDMM_CHUNK_MIN_NNZ
        m = n = 2048
        k, nnz = 16, tk.dot.SDDMM_CHUNK_MIN_NNZ + 1234
        rows = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
        cols = rng.integers(0, n, nnz).astype(np.int32)
    else:
        m, n, k = 40, 30, 6
        rows, cols, _ = _coo(m, n, 120, 4)
        nnz = rows.size
    vals = rng.random(nnz).astype(dtype)
    lhs = rng.random((m, k)).astype(dtype)
    rhs = rng.random((k, n)).astype(dtype)
    want = _jsddmm(rows, cols, vals, lhs, rhs)
    got = tk.sddmm(_t(rows), _t(cols), _t(vals), _t(lhs), _t(rhs))
    assert got.dtype == torch.float32 if dtype == np.float32 else got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype])
    plain = tk.sddmm_plain(_t(rows), _t(cols), _t(vals), _t(lhs), _t(rhs))
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL[dtype])


def test_kernel_sddmm_promotes_and_checks():
    rows, cols, data = _coo(10, 9, 25, 3)
    lhs = np.linspace(-1, 1, 50).reshape(10, 5).astype(np.float32)
    rhs = np.linspace(1, -1, 45).reshape(5, 9)
    want = _jsddmm(rows, cols, data, lhs, rhs)
    got = tk.sddmm(_t(rows), _t(cols), _t(data), _t(lhs), _t(rhs))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        tk.sddmm(_t(rows), _t(cols), _t(data), _t(lhs), _t(rhs.T))
    with pytest.raises(ValueError, match="one length"):
        tk.sddmm(_t(rows), _t(cols[:-1]), _t(data), _t(lhs), _t(rhs))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tk.sddmm(rows, _t(cols), _t(data), _t(lhs), _t(rhs))


def test_kernel_sddmm_takes_any_layout_of_lhs_and_rhs():
    rows, cols, data = _coo(30, 20, 80, 5)
    rng = np.random.default_rng(6)
    lhs, rhs = rng.standard_normal((30, 7)), rng.standard_normal((7, 20))
    want = tk.sddmm(_t(rows), _t(cols), _t(data), _t(lhs), _t(rhs))
    for lh in (_t(lhs), _t(lhs.T.copy()).T):
        for rh in (_t(rhs), _t(rhs.T.copy()).T, _t(np.pad(rhs, ((0, 0), (1, 2))))[:, 1:-2]):
            assert torch.equal(tk.sddmm(_t(rows), _t(cols), _t(data), lh, rh), want)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grad_inputs():
    # tests/test_autodiff.py::test_sddmm_grads's inputs
    rows, cols, data = _coo(10, 9, 25, 3)
    lhs = np.linspace(-1, 1, 10 * 5).reshape(10, 5)
    rhs = np.linspace(1, -1, 5 * 9).reshape(5, 9)
    return rows, cols, data, lhs, rhs


def test_sddmm_gradcheck_and_gradgradcheck():
    rows, cols, data, lhs, rhs = _grad_inputs()
    ins = tuple(_t(x).requires_grad_(True) for x in (data, lhs, rhs))
    f = lambda d, l, r: tk.sddmm(_t(rows), _t(cols), d, l, r)  # noqa: E731
    assert torch.autograd.gradcheck(f, ins, check_forward_ad=True)
    assert torch.autograd.gradgradcheck(f, ins)


@pytest.mark.parametrize("wrt", [0, 1, 2])
def test_sddmm_gradient_matches_jax_grad(wrt):
    rows, cols, data, lhs, rhs = _grad_inputs()
    w = np.random.default_rng(12).standard_normal(rows.size)

    def jloss(d, l, r):
        return (jnp.asarray(w) * jk.sddmm(jnp.asarray(rows), jnp.asarray(cols), d, l, r)).sum() ** 2

    want = np.asarray(jax.grad(jloss, argnums=wrt)(jnp.asarray(data), jnp.asarray(lhs), jnp.asarray(rhs)))
    ins = [_t(x).requires_grad_(True) for x in (data, lhs, rhs)]
    ((_t(w) * tk.sddmm(_t(rows), _t(cols), *ins)).sum() ** 2).backward()
    np.testing.assert_allclose(ins[wrt].grad.numpy(), want, rtol=1e-12, atol=1e-12)


def test_sddmm_second_derivative_matches_jax():
    rows, cols, data, lhs, rhs = _grad_inputs()

    def jloss(l):
        return (jk.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(data), l, jnp.asarray(rhs)) ** 2).sum()

    v = np.random.default_rng(13).standard_normal(lhs.shape)
    want = np.asarray(jax.jvp(jax.grad(jloss), (jnp.asarray(lhs),), (jnp.asarray(v),))[1])
    lt = _t(lhs).requires_grad_(True)
    (g,) = torch.autograd.grad((tk.sddmm(_t(rows), _t(cols), _t(data), lt, _t(rhs)) ** 2).sum(), lt, create_graph=True)
    (hv,) = torch.autograd.grad((g * _t(v)).sum(), lt)
    np.testing.assert_allclose(hv.numpy(), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# K4's copy rule and routes; K5 (the gradient's weighted row sum) and its plan
# ---------------------------------------------------------------------------


def _strides(layout, rows, k):
    return {"k_major": (k, 1), "mn_major": (1, rows), "neither": (2 * k, 2)}[layout]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [1, 1000, 65536])
@pytest.mark.parametrize("nnz", [10, 1000, 2_096_628])
@pytest.mark.parametrize("k", [1, 128, 10_000])
@pytest.mark.parametrize("layout", ["k_major", "mn_major", "neither"])
def test_copy_rule_is_a_function_of_shapes_strides_and_nnz(layout, k, nnz, rows, itemsize):
    # a K-major copy moves 2 · K · rows · item bytes; strided reads 32 bytes a value, K a row read
    strides = _strides(layout, rows, k)
    got = tk._cuda.sddmm_reads_in_place((rows, k), strides, itemsize, nnz)
    k_major = k == 1 or strides[1] == 1
    mn_major = rows == 1 or strides[0] == 1
    want = k_major or (mn_major and 32 * k * nnz <= 2 * k * rows * itemsize)
    assert got == want


def test_copy_rule_at_the_example_and_the_bench_mask():
    # examples/sddmm_example.py: rhs row-major (10,000², float64), 1,000 entries: rhs.T read in place
    # (meta tensors: shapes and strides without memory)
    rhs_t = torch.empty((10_000, 10_000), dtype=torch.float64, device="meta").T
    assert tk._cuda.sddmm_reads_in_place(tuple(rhs_t.shape), rhs_t.stride(), 8, 1000)
    assert tk.dot._sddmm_operand(rhs_t, 1000) is rhs_t
    # the bench mask (65,536², 2,096,628 entries, K = 128, float32) with MN-major operands: copied
    lhs = torch.empty((128, 65536), device="meta").T
    assert not tk._cuda.sddmm_reads_in_place(tuple(lhs.shape), lhs.stride(), 4, 2_096_628)
    copy = tk.dot._sddmm_operand(lhs, 2_096_628)
    assert copy.is_contiguous() and copy.shape == lhs.shape
    # a K-major operand is read in place whatever its row stride; unit stride on neither axis is copied
    wide = torch.empty((50, 300), device="meta")[:, 10:138]
    assert tk.dot._sddmm_operand(wide, 10**9) is wide
    assert tk.dot._sddmm_operand(torch.empty((50, 256), device="meta")[:, ::2], 1).is_contiguous()


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [1, 7, 128, 130, 256, 512, 513, 10_000])
def test_k4_route_and_vectors_a_lane(k, itemsize, vec):
    # the kept-row route: both operands by 16-byte loads, rows of a multiple of 16 bytes up to 2 KB
    route = tk._cuda.sddmm_route(k, itemsize, vec)
    assert route == ("kept_row" if vec and k * itemsize <= 2048 and k * itemsize % 16 == 0 else "per_entry")
    nv = tk._cuda._sddmm_vectors(k, itemsize, route)
    if route == "per_entry":
        assert nv == 0
    else:
        # every 16-byte vector of the row has a lane: vectors lane + 32 q for q < nv
        assert nv in (1, 2, 4) and 32 * nv >= k * itemsize // 16 and (nv == 1 or 32 * nv // 2 < k * itemsize // 16)


def _segment_problem(case, seed, m=13, n=11, nnz=90):
    """rows, cols (int64) of a case: canonical order, unsorted rows, empty
    rows and columns, repeated (i, j) entries."""
    rng = np.random.default_rng(seed)
    if case == "empty_rows":  # rows 0, 5-8 and 12, columns 3-6 never sampled
        rows = rng.choice([1, 2, 3, 4, 9, 10, 11], nnz)
        cols = rng.choice([0, 1, 2, 7, 8, 9, 10], nnz)
    else:
        rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    if case == "repeated":
        rows[nnz // 2 :], cols[nnz // 2 :] = rows[: nnz - nnz // 2], cols[: nnz - nnz // 2]
    if case in ("sorted", "empty_rows", "repeated"):
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
    return rows, cols, m, n


CASES = ["sorted", "unsorted", "empty_rows", "repeated"]


@pytest.mark.parametrize("wrt", ["lhs", "rhs"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_sampled_row_sum_matches_jax_vjp(case, dtype, idx_dtype, wrt):
    rows, cols, m, n = _segment_problem(case, seed=CASES.index(case))
    rng = np.random.default_rng(21)
    k, nnz = 6, rows.size
    s, g = rng.standard_normal(nnz).astype(dtype), rng.standard_normal(nnz).astype(dtype)
    lhs, rhs = rng.standard_normal((m, k)).astype(dtype), rng.standard_normal((k, n)).astype(dtype)
    ri, ci = rows.astype(idx_dtype), cols.astype(idx_dtype)
    _, vjp = jax.vjp(lambda l, r: jk.sddmm(jnp.asarray(ri), jnp.asarray(ci), jnp.asarray(s), l, r), jnp.asarray(lhs), jnp.asarray(rhs))
    want = np.asarray(vjp(jnp.asarray(g))[0 if wrt == "lhs" else 1])
    rtol = RTOL[dtype]
    w = _t(g) * _t(s)
    sorted_rows = case != "unsorted"
    pattern = tk.dot.SddmmPattern(_t(ri).long(), _t(ci).long(), m, n, rows_sorted=sorted_rows)
    if wrt == "lhs":
        plain = tk.dot.sampled_row_sum_plain(_t(ri), _t(ci), w, _t(rhs).T, m)
        fn = tk.dot._SampledRowSum.apply(pattern, 0, w, _t(rhs).T)
    else:
        plain = tk.dot.sampled_row_sum_plain(_t(ci), _t(ri), w, _t(lhs), n).T
        fn = tk.dot._SampledRowSum.apply(pattern, 1, w, _t(lhs)).T
    for got in (plain, fn):
        assert got.dtype == w.dtype and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)
    # through the entry point's backward, its rows sorted or not
    ins = [_t(lhs).requires_grad_(True), _t(rhs).requires_grad_(True)]
    out = tk.dot._sddmm(_t(ri), _t(ci), _t(s), *ins, pattern=pattern)
    out.backward(_t(g))
    np.testing.assert_allclose(ins[0 if wrt == "lhs" else 1].grad.numpy(), want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_sampled_row_sum_gradcheck_and_gradgradcheck(case, axis):
    rows, cols, m, n = _segment_problem(case, seed=7 + CASES.index(case), nnz=25)
    rng = np.random.default_rng(22)
    pattern = tk.dot.SddmmPattern(_t(rows), _t(cols), m, n, rows_sorted=case != "unsorted")
    w = _t(rng.standard_normal(rows.size)).requires_grad_(True)
    table = _t(rng.standard_normal((n if axis == 0 else m, 3))).requires_grad_(True)
    f = lambda w_, t_: tk.dot._SampledRowSum.apply(pattern, axis, w_, t_)  # noqa: E731
    assert torch.autograd.gradcheck(f, (w, table))
    assert torch.autograd.gradgradcheck(f, (w, table))


@pytest.mark.parametrize("piece", [1, 4, 256])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_k5_plan_built_by_torch_ops(case, axis, piece, monkeypatch):
    # the segment pointer, the stable order and the pieces, against NumPy; a
    # sum that follows the plan (segments, pieces in piece order) against the plain version
    monkeypatch.setattr(tk._cuda, "MTTKRP_PIECE", piece)
    rows, cols, m, n = _segment_problem(case, seed=30 + CASES.index(case), nnz=200)
    seg, idx, n_seg = (rows, cols, m) if axis == 0 else (cols, rows, n)
    pattern = tk.dot.SddmmPattern(_t(rows), _t(cols), m, n, rows_sorted=case != "unsorted")
    ptr, order, pieces, idx32 = pattern.plan(axis)
    assert ptr.dtype == pieces.dtype == torch.int64 and idx32.dtype == torch.int32
    want_order = np.argsort(seg, kind="stable")
    if axis == 0 and case != "unsorted":
        assert order is None
        want_order = np.arange(seg.size)
    else:
        assert order.dtype == torch.int64
        np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(ptr.numpy(), np.searchsorted(seg[want_order], np.arange(n_seg + 1)))
    np.testing.assert_array_equal(idx32.numpy(), idx[want_order])
    lens = np.diff(ptr.numpy())
    n_pieces = np.where(lens > piece, -(-lens // piece), 0)
    np.testing.assert_array_equal(pieces.numpy(), np.concatenate([[0], np.cumsum(n_pieces)]))
    assert int(pieces[-1]) <= tk._cuda.front_bound(seg.size, n_seg, piece)
    rng = np.random.default_rng(31)
    w, table = rng.standard_normal(seg.size), rng.standard_normal((int(idx.max()) + 1, 5))
    out = np.zeros((n_seg, 5))
    for i in range(n_seg):
        entries = want_order[ptr[i] : ptr[i + 1]]
        parts = [entries[p : p + piece] for p in range(0, entries.size, piece)] if entries.size > piece else [entries]
        for part in parts:
            acc = np.zeros(5)
            for e in part:
                acc += w[e] * table[idx[e]]
            out[i] += acc
    plain = tk.dot.sampled_row_sum_plain(_t(seg), _t(idx), _t(w), _t(table), n_seg)
    np.testing.assert_allclose(plain.numpy(), out, rtol=1e-12, atol=1e-12)


def test_coo_entry_point_keeps_its_pattern_and_matches_kernels_sddmm():
    # a canonical COO's rows are sorted: its pattern needs no row sort and is kept for the next call
    x = _sample(np.float64, seed=14)
    t = st.COO.from_numpy(x, device=CPU)
    rng = np.random.default_rng(15)
    lhs, rhs, g = rng.standard_normal((40, 5)), rng.standard_normal((5, 30)), rng.standard_normal(t.nnz)
    grads = []
    for call in range(2):
        ins = [_t(lhs).requires_grad_(True), _t(rhs).requires_grad_(True)]
        st.sddmm(t, *ins).data.backward(_t(g))
        grads.append([x.grad for x in ins])
        pattern = t.peek_layout("sddmm_pattern", (40, 30))
        assert isinstance(pattern, tk.dot.SddmmPattern) and pattern.ordered == (True, False)
        if call == 0:
            first = pattern
    assert pattern is first
    ins = [_t(lhs).requires_grad_(True), _t(rhs).requires_grad_(True)]
    tk.sddmm(t.coords[0], t.coords[1], t.data, *ins).backward(_t(g))
    for got in grads:
        assert all(torch.equal(a, b.grad) for a, b in zip(got, ins))


# ---------------------------------------------------------------------------
# sddmm, the entry point
# ---------------------------------------------------------------------------


def _formats(x, fmt):
    t, j = st.COO.from_numpy(x, device=CPU), jsp.COO.from_numpy(x)
    if fmt == "coo":
        return t, j
    if fmt == "gcxs":
        return st.GCXS.from_numpy(x, device=CPU), jsp.GCXS.from_numpy(x)
    return t.asformat(fmt), j.asformat(fmt)


@pytest.mark.parametrize("fmt", ["coo", "gcxs", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64, np.complex128, np.int64])
def test_sddmm_matches_sparse_tpu(fmt, dtype):
    rng = np.random.default_rng(1)
    x = _sample(dtype, seed=2)
    lhs = _values(rng.standard_normal((40, 8)), dtype, rng)
    rhs = _values(rng.standard_normal((8, 30)), dtype, rng)
    t, j = _formats(x, fmt)
    want = jsp.sddmm(j, lhs, rhs)
    _assert_same_sddmm(st.sddmm(t, lhs, rhs), want, RTOL[dtype])
    _assert_same_sddmm(st.sddmm(t, torch.as_tensor(lhs), torch.as_tensor(rhs)), want, RTOL[dtype])


@pytest.mark.parametrize(
    "dts",
    [
        (np.float32, np.float64, np.float32),
        (np.float64, np.float32, np.float32),
        (np.int64, np.float32, np.float32),
        (np.float32, np.float32, np.int32),
        (np.int32, np.int64, np.int32),
        (np.float16, np.float32, np.float16),
        (np.float64, np.complex128, np.float64),
    ],
)
def test_sddmm_mixed_dtypes_promote_as_sparse_tpu(dts):
    rng = np.random.default_rng(3)
    x = _sample(dts[0], seed=4)
    lhs = _values(rng.standard_normal((40, 5)), dts[1], rng)
    rhs = _values(rng.standard_normal((5, 30)), dts[2], rng)
    t, j = _formats(x, "coo")
    want = jsp.sddmm(j, lhs, rhs)
    out_dt = np.result_type(*dts)
    assert np.asarray(want.data).dtype == out_dt
    _assert_same_sddmm(st.sddmm(t, lhs, rhs), want, RTOL.get(out_dt.type, 1e-5))


def test_sddmm_empty_mask_and_k_one():
    rng = np.random.default_rng(5)
    lhs, rhs = rng.standard_normal((6, 1)), rng.standard_normal((1, 7))
    for x in (np.zeros((6, 7)), _sample(np.float64, seed=6, shape=(6, 7), density=0.5)):
        t, j = _formats(x, "coo")
        _assert_same_sddmm(st.sddmm(t, lhs, rhs), jsp.sddmm(j, lhs, rhs), 1e-12)


def test_sddmm_errors():
    x = _sample(np.float64, seed=7, shape=(5, 4), density=0.5)
    t = st.COO.from_numpy(x, device=CPU, fill_value=1.0)
    j = jsp.COO.from_numpy(x, fill_value=1.0)
    lhs, rhs = np.ones((5, 3)), np.ones((3, 4))
    for mod, s in ((st, t), (jsp, j)):
        with pytest.raises(ValueError, match="zero fill values"):
            mod.sddmm(s, lhs, rhs)
    t0 = st.COO.from_numpy(x, device=CPU)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        st.sddmm(t0, lhs, rhs.T)


def test_sddmm_coordinates_are_a_copy():
    x = _sample(np.float64, seed=8)
    t = st.COO.from_numpy(x, device=CPU)
    out = st.sddmm(t, np.ones((40, 2)), np.ones((2, 30)))
    assert torch.equal(out.coords, t.coords) and out.coords.data_ptr() != t.coords.data_ptr()


# ---------------------------------------------------------------------------
# jitops
# ---------------------------------------------------------------------------


def _pipeline(mod, a, b):
    y = mod.spmm(a, b)
    s2 = mod.sddmm(a, y, b.T)
    s3 = mod.scale(s2, 2.0)
    s4 = mod.add_same_pattern(s3, s2)
    return mod.sum_dense(s4, (1,))


def test_jitops_pipeline_matches_sparse_tpu():
    # tests/test_jitops.py::test_pipeline_under_jit through both packages
    j = jsp.random((30, 20), density=0.2, random_state=0)
    b = np.random.default_rng(1).random((20, 6))
    want = np.asarray(jax.jit(lambda a, bb: _pipeline(jjit, a, bb))(j, jnp.asarray(b)))
    t = st.COO.from_numpy(j.todense(), device=CPU)
    got = _pipeline(tjit, t, torch.as_tensor(b))
    assert got.shape == (30,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_jitops_spmm_gradient_matches_sparse_tpu():
    # tests/test_jitops.py::test_grad_through_pipeline
    j = jsp.random((10, 8), density=0.3, random_state=2)
    b = np.random.default_rng(3).random((8, 4))

    def jloss(data):
        return jjit.spmm(jsp.COO._make(j.coords, data, j.shape, j.fill_value), jnp.asarray(b)).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(np.asarray(j.data))))
    t = st.COO.from_numpy(j.todense(), device=CPU)
    data = t.data.clone().requires_grad_(True)
    tjit.spmm(st.COO._make(t.coords, data, t.shape, t.fill_value), torch.as_tensor(b)).sum().backward()
    np.testing.assert_allclose(data.grad.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
@pytest.mark.parametrize("op", ["spmm", "spmv"])
def test_jitops_products_match_sparse_tpu(fmt, op):
    x = _sample(np.float64, seed=9, shape=(9, 11), density=0.4)
    rng = np.random.default_rng(10)
    b = rng.random((11, 3)) if op == "spmm" else rng.random(11)
    t, j = _formats(x, fmt)
    want = np.asarray(getattr(jjit, op)(j, jnp.asarray(b)))
    got = getattr(tjit, op)(t, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    r, c, d = tjit._triplet(t)
    jr, jc, jd = jjit._triplet(j)
    order, jorder = np.lexsort((c.numpy(), r.numpy())), np.lexsort((np.asarray(jc), np.asarray(jr)))
    np.testing.assert_array_equal(r.numpy()[order], np.asarray(jr)[jorder])
    np.testing.assert_array_equal(c.numpy()[order], np.asarray(jc)[jorder])
    np.testing.assert_array_equal(d.numpy()[order], np.asarray(jd)[jorder])


def test_jitops_same_pattern_ops_and_transpose_match_sparse_tpu():
    x = _sample(np.float64, seed=11, shape=(6, 5, 4), density=0.3)
    t, j = _formats(x, "coo")
    checks = [
        (tjit.map_data(t, torch.sin), jjit.map_data(j, jnp.sin)),
        (tjit.mul_same_pattern(t, t), jjit.mul_same_pattern(j, j)),
        (tjit.add_same_pattern(t, t), jjit.add_same_pattern(j, j)),
        (tjit.scale(t, 3.0), jjit.scale(j, 3.0)),
        (tjit.transpose(t), jjit.transpose(j)),
        (tjit.transpose(t, (1, 0, 2)), jjit.transpose(j, (1, 0, 2))),
        (tjit.transpose(t, (-1, 0, 1)), jjit.transpose(j, (-1, 0, 1))),
    ]
    for got, want in checks:
        assert got.shape == want.shape and got.fill_value == want.fill_value
        assert numpy_dtype(got.coords.dtype) == np.asarray(want.coords).dtype
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)
    assert tjit.transpose(t, (0, 1, 2)) is t
    with pytest.raises(ValueError, match="repeated or incomplete"):
        tjit.transpose(t, (0, 0, 1))


def test_jitops_sddmm_keeps_the_pattern():
    x = _sample(np.float32, seed=12)
    t, j = _formats(x, "coo")
    rng = np.random.default_rng(13)
    lhs, rhs = rng.random((40, 4)).astype(np.float32), rng.random((4, 30)).astype(np.float32)
    got, want = tjit.sddmm(t, lhs, rhs), jjit.sddmm(j, jnp.asarray(lhs), jnp.asarray(rhs))
    assert got.coords is t.coords and got.dtype == torch.float32
    assert got.fill_value == 0 and np.asarray(got.fill_value).dtype == np.float32
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-5)
    with pytest.raises(TypeError, match="COO sample"):
        tjit.sddmm(t.asformat("csr"), lhs, rhs)
