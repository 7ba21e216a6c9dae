"""Sparse × sparse products (SpGEMM), narrow coordinates and the rest of the
container on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_spgemm_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). float32 and
float64 products run S1 (``csrc/spgemm.cu``, two launches: the symbolic and
the numeric pass), the other dtypes its plain version's torch ops; both add
each output entry's products in one fixed order (from the first, then k
ascending), so S1 equals the plain ``kernels.spgemm.spgemm`` on the card bit
for bit (coordinates and value bits: empty rows, a row past the shared-memory
cache, columns past one chunk, a run of many products on one column, ±0.0
first products, computed zeros, NaN and inf; int32 and int64 coordinates),
the card's results equal the port's CPU results bit for bit (float32,
float64, integers, booleans) and two calls give the same bits. The
narrow-coordinate tests hold the row-ELL kernels (K1, K2) and K4
against the same products with int32 coordinates, bit for bit, with their
launch counters moving.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import LAUNCHES, _cuda, product_count, reset_launch_counts
from sparse_tpu_torch.kernels import spgemm as kspgemm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _dense(shape, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    mask = rng.random(shape) < density
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return mask
    if np.issubdtype(dt, np.unsignedinteger):
        x = np.abs(np.round(x * 4)) + 1
    elif np.issubdtype(dt, np.integer):
        x = np.round(x * 4)
    return np.where(mask, x, 0).astype(dt)


def _same(got, want):
    """Two COO/GCXS results hold the same entries with the same bits."""
    got, want = got.tocoo(), want.tocoo()
    assert got.shape == want.shape and got.coords.dtype == want.coords.dtype and got.data.dtype == want.data.dtype
    assert torch.equal(got.coords.cpu(), want.coords.cpu())
    g, w = got.data.cpu(), want.data.cpu()
    assert g.numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_same_bits_twice_and_as_on_the_cpu(cuda, dtype, fmt):
    x, y = _dense((1500, 1200), 0.02, 1, dtype), _dense((1200, 1000), 0.02, 2, dtype)
    ta, tb = (st.COO.from_numpy(v, device=cuda).asformat(fmt) for v in (x, y))
    ca, cb = (st.COO.from_numpy(v, device="cpu").asformat(fmt) for v in (x, y))
    got = ta @ tb
    assert got.data.device.type == "cuda" and type(got).__name__ == type(ca @ cb).__name__
    _same(got, ta @ tb)
    _same(got, ca @ cb)
    assert product_count(ta.tocoo().coords[1], tb.tocoo().coords[0], 1200) > got.nnz  # runs of several products
    ref = x.astype(np.float64) @ y.astype(np.float64)
    np.testing.assert_allclose(got.todense().cpu().numpy(), ref, rtol=1e-5 if dtype == np.float32 else 1e-12, atol=1e-5 if dtype == np.float32 else 1e-12)


def test_boolean_runs_of_many_products_sum_as_or(cuda):
    x, y = np.ones((4, 600), dtype=bool), np.ones((600, 3), dtype=bool)
    x[1] = False
    got = st.COO.from_numpy(x, device=cuda) @ st.COO.from_numpy(y, device=cuda)
    assert got.data.dtype == torch.bool and got.nnz == 9 and bool(got.data.all())
    np.testing.assert_array_equal(got.todense().cpu().numpy(), x @ y)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int64, np.float16, np.bool_], ids=lambda d: np.dtype(d).name)
def test_other_dtypes_on_the_card(cuda, dtype):
    x, y = _dense((60, 70), 0.2, 3, dtype), _dense((70, 50), 0.2, 4, dtype)
    got = st.COO.from_numpy(x, device=cuda) @ st.COO.from_numpy(y, device=cuda)
    _same(got, st.COO.from_numpy(x, device="cpu") @ st.COO.from_numpy(y, device="cpu"))
    if np.dtype(dtype) != np.float16:
        np.testing.assert_array_equal(got.todense().cpu().numpy(), x @ y)


def test_complex_on_the_card(cuda):
    rng = np.random.default_rng(5)
    x = _dense((40, 50), 0.3, 6) + 1j * rng.standard_normal((40, 50)) * (rng.random((40, 50)) < 0.3)
    y = _dense((50, 30), 0.3, 7) * (1 - 2j)
    got = st.COO.from_numpy(x, device=cuda) @ st.COO.from_numpy(y, device=cuda)
    np.testing.assert_allclose(got.todense().cpu().numpy(), x @ y, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dt", [np.uint8, np.int16, np.uint16], ids=lambda d: np.dtype(d).name)
def test_narrow_coordinates_launch_the_kernels(cuda, dt):
    x = _dense((200, 250), 0.1, 8, np.float32)
    idx = np.stack(np.nonzero(x))
    narrow = st.COO(idx.astype(dt), x[np.nonzero(x)], shape=x.shape, device=cuda)
    wide = st.COO(idx, x[np.nonzero(x)], shape=x.shape, device=cuda)
    assert narrow.coords.dtype == getattr(torch, np.dtype(dt).name) and wide.coords.dtype == torch.int32
    b = torch.rand(250, 16, device=cuda)
    v = torch.rand(250, device=cuda)
    lhs, rhs = torch.rand(200, 32, device=cuda), torch.rand(32, 250, device=cuda)
    for name, call in (
        ("row_ell_spmm", lambda s: s @ b),
        ("row_ell_spmv", lambda s: s @ v),
        ("sddmm", lambda s: st.sddmm(s, lhs, rhs).data),
    ):
        reset_launch_counts()
        got = call(narrow)
        assert LAUNCHES[name] >= 1, (name, dict(LAUNCHES))
        assert torch.equal(got, call(wide)), name
    _same(narrow @ wide.T, wide @ wide.T)
    on_cpu = st.COO(idx.astype(dt), x[np.nonzero(x)], shape=x.shape, device="cpu")
    for op in (
        lambda s: s.T,
        lambda s: st.concatenate([s, s], axis=1),
        lambda s: st.stack([s, s], axis=1),
        lambda s: st.GCXS.from_coo(s, compressed_axes=(1,)).tocoo(),
    ):
        got, want = op(narrow), op(wide)
        assert got.coords.dtype == op(on_cpu).coords.dtype  # narrow, as on the CPU (test_torch_container.py)
        assert torch.equal(got.coords.long(), want.coords.long()) and torch.equal(got.data, want.data)


def test_jitops_spgemm_in_a_cuda_graph(cuda):
    x, y = _dense((300, 400), 0.02, 9, np.float32), _dense((400, 350), 0.02, 10, np.float32)
    a, b = st.COO.from_numpy(x, device=cuda), st.COO.from_numpy(y, device=cuda)
    cap = product_count(a.coords[1], b.coords[0], 400)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        st.jitops.spgemm(a, b, product_capacity=cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, nnz = st.jitops.spgemm(a, b, product_capacity=cap)
    a.data.mul_(2.0)
    b.data.add_(1.0)
    graph.replay()
    n = int(nnz)
    ca = st.COO._make(a.coords.cpu(), a.data.cpu(), a.shape, a.fill_value)
    cb = st.COO._make(b.coords.cpu(), b.data.cpu(), b.shape, b.fill_value)
    cpu_out, cpu_nnz = st.jitops.spgemm(ca, cb, product_capacity=cap)
    assert n == int(cpu_nnz)
    assert torch.equal(out.coords.cpu(), cpu_out.coords) and out.data.cpu().numpy().tobytes() == cpu_out.data.numpy().tobytes()
    eager = ca @ cb
    assert torch.equal(out.coords[:, :n].cpu(), eager.coords)
    torch.testing.assert_close(out.data[:n].cpu(), eager.data, rtol=1e-6, atol=0)


def test_einsum_and_tensordot_on_the_card(cuda):
    x, y = _dense((3, 40, 50), 0.2, 11), _dense((50, 30), 0.2, 12)
    a, b = st.COO.from_numpy(x, device=cuda), st.COO.from_numpy(y, device=cuda)
    _same(st.einsum("bij,jk->bik", a, b), st.einsum("bij,jk->bik", *(st.COO.from_numpy(v, device="cpu") for v in (x, y))))
    _same(st.matmul(a, b), st.matmul(st.COO.from_numpy(x, device="cpu"), st.COO.from_numpy(y, device="cpu")))
    np.testing.assert_allclose(st.tensordot(a, b, axes=1).todense().cpu().numpy(), np.tensordot(x, y, axes=1), rtol=1e-12, atol=1e-12)


def test_operands_on_two_devices_raise(cuda):
    x = _dense((10, 10), 0.3, 13)
    a, b = st.COO.from_numpy(x, device=cuda), st.COO.from_numpy(x, device="cpu")
    for call in (lambda: a @ b, lambda: st.dot(b, a), lambda: st.tensordot(a, b, axes=1), lambda: st.concatenate([a, b])):
        with pytest.raises(ValueError, match="device"):
            call()


# S1 against its plain version on the card, on raw canonical COO operands
# (explicit zeros kept): (m, k, n, density of A, of B) and a value set
S1_CASES = {
    "random": (300, 400, 350, 0.05, 0.05),
    "empty_rows": (300, 400, 350, 0.05, 0.05),  # every third row of A and every fifth of B emptied
    "past_the_cache": (4, 3000, 5000, 1.0, 0.01),  # row 0: 150k products over about 5,000 columns
    "chunks": (50, 500, 150_000, 0.1, 0.001),  # three chunks of 65,536 columns
    "one_column": (3, 2000, 50, 1.0, 0.05),  # column 7 in every row of B: 2,000 products on it
    "signed_zeros": (200, 150, 180, 0.1, 0.1),  # values in {±0.0, ±1, 2}: ±0.0 first products, computed zeros
    "not_finite": (200, 150, 180, 0.1, 0.1),  # ±inf and NaN among the values
}


def _operand(m, k, density, rng, dtype, case, cuda):
    mask = rng.random((m, k)) < density
    vals = rng.standard_normal((m, k))
    if case == "signed_zeros":
        vals = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, 2.0]), size=(m, k))
    elif case == "not_finite":
        vals[rng.random((m, k)) < 0.05] = np.inf
        vals[rng.random((m, k)) < 0.05] = -np.inf
        vals[rng.random((m, k)) < 0.02] = np.nan
    r, c = np.nonzero(mask)
    return (torch.as_tensor(r, device=cuda), torch.as_tensor(c, device=cuda), torch.as_tensor(vals[r, c], device=cuda).to(dtype))


def _s1_operands(case, dtype, cuda):
    m, k, n, da, db = S1_CASES[case]
    rng = np.random.default_rng(len(case))
    a = _operand(m, k, da, rng, dtype, case, cuda)
    b = _operand(k, n, db, rng, dtype, case, cuda)
    if case == "empty_rows":
        a = tuple(t[a[0] % 3 != 0] for t in a)
        b = tuple(t[b[0] % 5 != 0] for t in b)
    elif case == "one_column":
        keep = b[1] != 7
        b = tuple(t[keep] for t in b)
        lin = torch.cat([b[0] * n + b[1], torch.arange(k, device=cuda) * n + 7])
        lin, order = torch.sort(lin)
        vals = torch.cat([b[2], torch.as_tensor(rng.standard_normal(k), device=cuda).to(dtype)])[order]
        b = (lin // n, lin % n, vals)
    return a, b, (m, k, n)


def _bits(t):
    return t.cpu().contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", list(S1_CASES))
def test_s1_equals_its_plain_version_bit_for_bit(cuda, case, dtype, index_dtype):
    a, b, (m, k, n) = _s1_operands(case, dtype, cuda)
    reset_launch_counts()
    coords, vals = kspgemm.spgemm_coords(*a, *b, m=m, k=k, n=n, index_dtype=index_dtype)
    assert LAUNCHES["spgemm"] == 2 and sum(LAUNCHES.values()) == 2
    rows, cols, want = kspgemm.spgemm(*a, *b, m=m, k=k, n=n)
    assert coords.dtype == index_dtype and vals.dtype == dtype and coords.device.type == "cuda"
    assert torch.equal(coords.long(), torch.stack([rows, cols]))
    assert torch.equal(_bits(vals), _bits(want))
    again = kspgemm.spgemm_coords(*a, *b, m=m, k=k, n=n, index_dtype=index_dtype)
    assert torch.equal(again[0], coords) and torch.equal(_bits(again[1]), _bits(vals))
    if case == "past_the_cache":
        assert int((rows == 0).sum()) > _cuda.spgemm_plan(n, dtype).vcap
    if case == "chunks":
        assert -(-n // _cuda.spgemm_plan(n, dtype).span) == 3
    if case == "signed_zeros":  # computed zeros were dropped, and -0.0 first products taken
        assert bool((vals != 0).all()) and product_count(a[1], b[0], k) > vals.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", ["random", "chunks", "one_column"])
def test_s1_with_int64_column_ids(cuda, case, dtype):
    """The kernels' int64 column route (taken past 2^31 - 1 columns) on
    small products, through the launchers, which keep the sums equal to
    zero: the plain version's entries and bits where the sums are not."""
    a, b, (m, k, n) = _s1_operands(case, dtype, cuda)
    ptr_a = torch.searchsorted(a[0], torch.arange(m + 1, device=cuda))
    ptr_b = torch.searchsorted(b[0], torch.arange(k + 1, device=cuda))
    order, counts = kspgemm.row_plan(kspgemm.row_products(ptr_a, a[1], ptr_b))
    scratch = torch.zeros(3, dtype=torch.int64, device=cuda)
    row_count = torch.zeros(m, dtype=torch.int64, device=cuda)
    _cuda.spgemm_symbolic(ptr_a, a[1], ptr_b, b[1], order, counts, n, scratch[0:1], row_count)
    row_ptr = torch.zeros(m + 1, dtype=torch.int64, device=cuda)
    torch.cumsum(row_count, 0, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    coords = torch.empty((2, nnz), dtype=torch.int64, device=cuda)
    vals = torch.empty(nnz, dtype=dtype, device=cuda)
    _cuda.spgemm_numeric(ptr_a, a[1], a[2], ptr_b, b[1], b[2], order, counts, n, row_ptr, coords, vals, scratch[1:2], scratch[2:3])
    rows, cols, want = kspgemm.spgemm(*a, *b, m=m, k=k, n=n)
    keep = vals != 0
    assert int(scratch[2]) == int((~keep).sum()) and torch.equal(coords[:, keep], torch.stack([rows, cols]))
    assert torch.equal(_bits(vals[keep]), _bits(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_public_entry_points_launch_s1(cuda, dtype, fmt):
    x, y = _dense((500, 400), 0.03, 14, dtype), _dense((400, 300), 0.03, 15, dtype)
    ta, tb = (st.COO.from_numpy(v, device=cuda).asformat(fmt) for v in (x, y))
    want = st.COO.from_numpy(x, device="cpu").asformat(fmt) @ st.COO.from_numpy(y, device="cpu").asformat(fmt)
    for name, call in (
        ("@", lambda: ta @ tb),
        ("matmul", lambda: st.matmul(ta, tb)),
        ("dot", lambda: st.dot(ta, tb)),
        ("tensordot", lambda: st.tensordot(ta, tb, axes=1)),
        ("einsum", lambda: st.einsum("ij,jk->ik", ta, tb)),
    ):
        reset_launch_counts()
        got = call()
        assert LAUNCHES["spgemm"] == 2 and sum(LAUNCHES.values()) == 2, (name, dict(LAUNCHES))
        assert torch.equal(_bits(got.todense()), _bits(want.todense())), name
    _same(ta @ tb, want)


def test_other_dtypes_launch_nothing(cuda):
    x, y = _dense((60, 70), 0.2, 16, np.int64), _dense((70, 50), 0.2, 17, np.int64)
    reset_launch_counts()
    got = st.COO.from_numpy(x, device=cuda) @ st.COO.from_numpy(y, device=cuda)
    assert not any(LAUNCHES.values()) and got.data.dtype == torch.int64
    np.testing.assert_array_equal(got.todense().cpu().numpy(), x @ y)
