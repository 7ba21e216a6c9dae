"""The port's reductions against sparse_tpu's (CPU, small sizes), and the
traceable segment and union forms against their JAX counterparts.

Inputs come from numpy with a seed and go to both packages as numpy arrays.
Held exactly: output type, shape, dtype, fill value, coordinates and, for
integer and bool data and for ``max``/``min``/``any``/``all``/``fmax``/
``fmin``, the values. Float sums, products, ``mean``, ``var`` and ``std`` at
rtol 1e-12 in float64 and 1e-5 in float32 (float16 at 1e-2), on values
whose sums do not cancel. The grid mirrors the reduction tests of
tests/test_coo.py: axis None, each axis, negative axes and tuples, with and
without ``keepdims``, 1-D to 4-D, zero and nonzero fill values.
"""

import warnings
from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_elemwise import assert_same, check, np_of

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu.kernels import dot as jdot
from sparse_tpu.kernels import segment as jseg
from sparse_tpu.kernels.elemwise import coo_elemwise_union as jax_union
from sparse_tpu_torch import jitops
from sparse_tpu_torch.kernels import dot as tdot
from sparse_tpu_torch.kernels import segment as tseg
from sparse_tpu_torch.kernels.elemwise import coo_elemwise_union

CPU = "cpu"
RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5, np.dtype(np.float16): 1e-2, np.dtype(np.complex128): 1e-12}
METHODS = ["sum", "max", "min", "prod", "any", "all", "mean", "var", "std"]
FLOAT_RESULT = {"sum", "prod", "mean", "var", "std"}


def data(seed, shape, dtype=np.float64, density=0.5, fill=None):
    """Values that cannot cancel: floats in [0.5, 1.5) with random sign
    only where ``signed``; integers in [-4, 5); bools."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        x = rng.random(shape) < 0.5
    elif dt.kind in "iu":
        lo = 0 if dt.kind == "u" else -4
        x = rng.integers(lo, 5, shape).astype(dt)
    elif dt.kind == "c":
        x = (rng.uniform(0.5, 1.5, shape) + 1j * rng.uniform(0.5, 1.5, shape)).astype(dt)
    else:
        x = rng.uniform(0.5, 1.5, shape).astype(dt)
    x[rng.random(shape) >= density] = 0 if fill is None else fill
    return x


def both(x, fmt="coo", fill=None, compressed_axes=None):
    fill = None if fill is None else np.asarray(fill, dtype=x.dtype)[()]
    t = st.COO.from_numpy(x, fill_value=fill, device=CPU)
    j = jsp.COO.from_numpy(x, fill_value=fill)
    if fmt == "gcxs":
        t = st.GCXS.from_coo(t, compressed_axes=compressed_axes)
        j = jsp.GCXS.from_coo(j, compressed_axes=compressed_axes)
    return t, j


def axis_choices(ndim):
    """None, -1 and every tuple of axes (in 4-D, of up to two axes and all four)."""
    out = [None, -1]
    for k in range(1, ndim + 1):
        if ndim < 4 or k <= 2 or k == ndim:
            out += list(combinations(range(ndim), k))
    return out


def reduce_check(t, j, method, axis, keepdims, **kw):
    dt = np.dtype(np.asarray(j.data).dtype)
    float_res = method in FLOAT_RESULT and (dt.kind in "fc" or method in ("mean", "var", "std"))
    res_dt = np.float64 if (method in ("mean", "var", "std") and dt.kind in "biu") else dt
    rtol = RTOL.get(np.dtype(res_dt)) if float_res else None
    check(
        lambda: getattr(t, method)(axis=axis, keepdims=keepdims, **kw),
        lambda: getattr(j, method)(axis=axis, keepdims=keepdims, **kw),
        rtol=rtol,
    )


SHAPES = [(7,), (5, 6), (4, 3, 5), (2, 3, 2, 3)]
GRID = [(shape, axis) for shape in SHAPES for axis in axis_choices(len(shape))]


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape,axis", GRID, ids=str)
def test_reductions_match_sparse_tpu(shape, axis, method, keepdims):
    x = data(len(shape), shape)
    for fill in (None, 1.0):
        t, j = both(x if fill is None else np.where(x == 0, 1.0, x), fill=fill)
        reduce_check(t, j, method, axis, keepdims)


DTYPES = [np.bool_, np.int8, np.uint8, np.uint16, np.int32, np.int64, np.uint64, np.float16, np.float32, np.float64, np.complex128]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_reduction_dtypes_match_sparse_tpu(dtype, method):
    """NumPy's dtype rules: small integers sum to int64/uint64, ``mean`` of
    integers is float64, float16 ``mean`` accumulates in float32."""
    x = data(3, (4, 5, 3), dtype)
    t, j = both(x)
    for axis in (None, 0, 2, (0, 1), (1, 2)):
        if np.dtype(dtype).kind == "c" and (method in ("max", "min") or (method == "prod" and axis is not None)):
            # no lexicographic complex reduction in torch (ROADMAP §C2)
            with pytest.raises(NotImplementedError, match=f"{'maximum' if method == 'max' else 'minimum' if method == 'min' else 'multiply'}.reduce of complex128"):
                getattr(t, method)(axis=axis)
            continue
        reduce_check(t, j, method, axis, False)


@pytest.mark.parametrize("fill", [None, 2.0], ids=["zero", "nonzero"])
@pytest.mark.parametrize("ca", [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("method", ["sum", "max", "min", "prod", "any", "mean", "var"])
def test_gcxs_reductions_match_sparse_tpu(method, ca, fill):
    """Both GCXS paths (``indptr`` segments over the uncompressed axes, the
    ``indices`` key for an add over the compressed axes) and the COO route."""
    x = data(5, (4, 5, 6))
    t, j = both(x if fill is None else np.where(x == 0, 2.0, x), "gcxs", fill=fill, compressed_axes=ca)
    for axis in (None, 0, 1, 2, (0, 1), (0, 2), (1, 2)):
        reduce_check(t, j, method, axis, False)
    reduce_check(t, j, method, (0, 2), True)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64, np.bool_])
def test_csr_csc_reductions(fmt, dtype):
    x = data(6, (9, 7), dtype)
    t = st.COO.from_numpy(x, device=CPU).asformat(fmt)
    j = jsp.COO.from_numpy(x).asformat(fmt)
    for method in ("sum", "max", "min", "any", "all"):
        for axis in (None, 0, 1):
            reduce_check(t, j, method, axis, False)


def test_zero_sums_and_signed_zeros():
    """Float sums that cancel to zero are dropped under a zero fill (as
    sparse_tpu's fused sum drops them); a run of -0.0 keeps its sign where
    sparse_tpu's sum does."""
    x = np.array([[1.0, -1.0, 0, 2.0], [-0.0, 0, 0, 3.0], [0, 0, 0, -0.0]])
    for fmt in ("coo", "gcxs"):
        for ca in ((0,), (1,)):
            t, j = both(x, fmt, compressed_axes=ca if fmt == "gcxs" else None)
            for axis in (0, 1):
                check(lambda: t.sum(axis=axis), lambda: j.sum(axis=axis))
            check(lambda: t.sum(axis=1, dtype=np.float32), lambda: j.sum(axis=1, dtype=np.float32))


def test_super_ufunc_correction():
    x = data(7, (5, 6))
    x[x == 0] = 1.5
    t, j = both(x, fill=1.5)
    for axis in (None, 0, 1):
        reduce_check(t, j, "sum", axis, False)
        reduce_check(t, j, "prod", axis, False)
    xi = data(8, (5, 6), np.int64)
    xi[xi == 0] = 2
    t, j = both(xi, fill=2)
    for axis in (None, 0, 1):
        reduce_check(t, j, "sum", axis, False)
        reduce_check(t, j, "prod", axis, False)


def test_dense_result_and_empty_arrays():
    x = data(9, (4, 5))
    x[x == 0] = 1
    t, j = both(x.astype(np.int64), fill=1)
    with pytest.raises(ValueError, match="dense result"):
        t.reduce(np.bitwise_xor, axis=0)
    with pytest.raises(ValueError, match="dense result"):
        j.reduce(np.bitwise_xor, axis=0)
    for shape in ((0, 5), (3, 0)):
        t, j = both(np.zeros(shape))
        for method in ("sum", "max", "prod"):
            for axis in (None, 0, 1):
                check(lambda: getattr(t, method)(axis=axis), lambda: getattr(j, method)(axis=axis))


@pytest.mark.parametrize("fname", ["nansum", "nanmean", "nanmax", "nanmin", "nanprod"])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_nan_reductions_match_sparse_tpu(fname, axis):
    x = data(10, (6, 5))
    x[0, :] = np.nan  # an all-NaN slice
    x[2, 1] = x[3, 4] = np.nan
    t, j = both(x)
    rtol = 1e-12 if fname in ("nansum", "nanmean", "nanprod") else None
    check(lambda: getattr(st, fname)(t, axis=axis), lambda: getattr(jsp, fname)(j, axis=axis), rtol=rtol)
    # the same warnings ("All-NaN slice encountered", "Mean of empty slice")
    seen = []
    for arr, mod in ((j, jsp), (t, st)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            getattr(mod, fname)(arr, axis=axis)
        seen.append(sorted({str(m.message) for m in w if m.category is RuntimeWarning and "slice" in str(m.message)}))
    assert seen[0] == seen[1]
    check(lambda: st.nanreduce(t, np.add, axis=axis), lambda: jsp.nanreduce(j, np.add, axis=axis), rtol=1e-12)


@pytest.mark.parametrize("fname", ["sum", "max", "min", "prod", "mean", "std", "var", "all", "any"])
def test_array_api_forms(fname):
    x = data(11, (4, 6))
    t, j = both(x)
    rtol = 1e-12 if fname in FLOAT_RESULT else None
    check(lambda: getattr(st, fname)(t, axis=1), lambda: getattr(jsp, fname)(j, axis=1), rtol=rtol)
    check(lambda: getattr(np, fname)(t, axis=0), lambda: getattr(np, fname)(j, axis=0), rtol=rtol)


def test_float_reductions_are_deterministic():
    x = data(12, (40, 30), np.float32)
    t, _ = both(x)
    for axis in (None, 0, 1):
        a, b = t.sum(axis=axis), t.sum(axis=axis)
        assert a.fill_value.tobytes() == b.fill_value.tobytes()
        if a.ndim:
            assert torch.equal(a.data, b.data)


# ---------------------------------------------------------------------------
# the traceable forms against their JAX counterparts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_segment_reduce_matches_jax(op, dtype):
    rng = np.random.default_rng(13)
    ids = np.sort(rng.integers(-1, 9, 60))
    vals = data(14, (60,), dtype, density=1.0)
    got = tseg.segment_reduce(torch.as_tensor(vals), torch.as_tensor(ids), 8, op=op)
    want = np.asarray(jseg.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 8, op=op))
    if np.dtype(dtype).kind == "f" and op in ("sum", "prod"):
        np.testing.assert_allclose(np_of(got), want, rtol=1e-5 if dtype == np.float32 else 1e-12)
    else:
        np.testing.assert_array_equal(np_of(got), want)
    assert np_of(got).dtype == want.dtype
    perm = rng.permutation(ids.size)
    got_u = tseg.segment_reduce(torch.as_tensor(vals[perm]), torch.as_tensor(ids[perm]), 8, op=op, indices_are_sorted=False)
    np.testing.assert_allclose(np_of(got_u), want, rtol=1e-5)


def test_segment_reduce_of_complex_values_sums_only():
    vals = torch.tensor([1 + 2j, 3 - 1j, 0.5j], dtype=torch.complex128)
    ids = torch.tensor([0, 0, 2])
    np.testing.assert_array_equal(np_of(tseg.segment_reduce(vals, ids, 3)), np.array([4 + 1j, 0, 0.5j]))
    for op in ("prod", "max", "min"):
        with pytest.raises(NotImplementedError, match=f"segment {op} of complex"):
            tseg.segment_reduce(vals, ids, 3, op=op)


@pytest.mark.parametrize("block_rows", [4, 512])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_onehot_mm_matches_jax(dtype, block_rows):
    rng = np.random.default_rng(15)
    ids = np.sort(rng.integers(0, 12, 50))
    vals = rng.standard_normal((50, 3)).astype(dtype)
    got = tseg.segment_sum_onehot_mm(torch.as_tensor(vals), torch.as_tensor(ids), num_segments=10, block_rows=block_rows)
    want = np.asarray(jseg.segment_sum_onehot_mm(jnp.asarray(vals), jnp.asarray(ids), num_segments=10, block_rows=block_rows))
    np.testing.assert_allclose(np_of(got), want, rtol=1e-5 if dtype == np.float32 else 1e-12, atol=1e-6)


@pytest.mark.parametrize("axes", [(0,), (1,), (2,), (0, 2), (1, 2), (0, 1, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_coo_sum_axes_dense_matches_jax(axes, dtype):
    x = data(16, (4, 5, 6), dtype)
    t, j = both(x)
    got = tdot.coo_sum_axes_dense(t.coords, t.data, shape=t.shape, axes=axes)
    want = np.asarray(jdot.coo_sum_axes_dense(jnp.asarray(j.coords), jnp.asarray(j.data), shape=j.shape, axes=axes))
    rtol = {np.float32: 1e-5, np.float64: 1e-12}.get(dtype, 0)
    np.testing.assert_allclose(np_of(got), want, rtol=rtol)
    assert np_of(got).dtype == want.dtype
    np.testing.assert_allclose(np_of(jitops.sum_dense(t, axes)), np.asarray(jsp.jitops.sum_dense(j, axes)), rtol=rtol)


UNION_FUNCS = [(torch.add, jnp.add), (torch.mul, jnp.multiply), (torch.maximum, jnp.maximum), (torch.sub, jnp.subtract)]


@pytest.mark.parametrize("fills", [(0.0, 0.0), (1.0, 2.0), (np.nan, 0.0)], ids=str)
@pytest.mark.parametrize("funcs", UNION_FUNCS, ids=lambda f: f[0].__name__)
def test_coo_elemwise_union_matches_jax_bit_for_bit(funcs, fills):
    rng = np.random.default_rng(17)
    size = 50
    lin_a = np.sort(rng.choice(size, 12, replace=False))
    lin_b = np.sort(rng.choice(size, 15, replace=False))
    da, db = rng.standard_normal(12), rng.standard_normal(15)
    da[0] = -0.0
    got = coo_elemwise_union(
        torch.as_tensor(lin_a), torch.as_tensor(da), fills[0], torch.as_tensor(lin_b), torch.as_tensor(db), fills[1], func=funcs[0], size=size
    )
    want = jax_union(
        jnp.asarray(lin_a), jnp.asarray(da), jnp.asarray(fills[0]), jnp.asarray(lin_b), jnp.asarray(db), jnp.asarray(fills[1]), func=funcs[1], size=size
    )
    for g, w in zip(got, want):
        g, w = np_of(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.float64:
            # bit for bit, a NaN's payload aside (each library makes its own)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            g, w = np.where(np.isnan(g), 0, g), np.where(np.isnan(w), 0, w)
            g, w = g.view(np.uint64), w.view(np.uint64)
        np.testing.assert_array_equal(g, w)


def test_union_elemwise_matches_jitops():
    x, y = data(18, (5, 6)), data(19, (5, 6))
    (t1, j1), (t2, j2) = both(x), both(y)
    out_t, n_t = jitops.union_elemwise(torch.add, t1, t2)
    out_j, n_j = jsp.jitops.union_elemwise(jnp.add, j1, j2)
    assert int(n_t) == int(n_j)
    np.testing.assert_array_equal(np_of(out_t.coords), np.asarray(out_j.coords))
    np.testing.assert_array_equal(np_of(out_t.data), np.asarray(out_j.data))
    assert float(out_t.fill_value) == float(out_j.fill_value)
    n = int(n_t)
    dense = np.zeros((5, 6))
    dense[tuple(np_of(out_t.coords)[:, :n])] = np_of(out_t.data)[:n]
    np.testing.assert_array_equal(dense, x + y)


def test_traceable_forms_make_no_host_read(monkeypatch):
    """No ``.item()``, ``bool()`` or ``.tolist()`` on a tensor."""
    def refuse(*a, **k):
        raise AssertionError("host read")

    x, y = data(20, (5, 6)), data(21, (5, 6))
    (t1, _), (t2, _) = both(x), both(y)
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    jitops.union_elemwise(torch.add, t1, t2)
    jitops.sum_dense(t1, (0,))
    tseg.segment_reduce(t1.data, t1.coords[0], 5)
    tseg.segment_sum_onehot_mm(t1.data[:, None], t1.coords[0], num_segments=5)
    tdot.coo_sum_axes_dense(t1.coords, t1.data, shape=t1.shape, axes=(1,))
    monkeypatch.undo()
    assert_same(t1 + t2, both(x)[1] + both(y)[1])
