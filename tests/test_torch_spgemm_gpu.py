"""Sparse × sparse products (SpGEMM), narrow coordinates and the rest of the
container on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_spgemm_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). No hand kernel
computes SpGEMM: its torch ops add each run of products in one fixed order
on every device, so the card's results equal the port's CPU results bit for
bit (float32, float64, integers, booleans) and two calls give the same
bits. The narrow-coordinate tests hold the row-ELL kernels (K1, K2) and K4
against the same products with int32 coordinates, bit for bit, with their
launch counters moving.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch.kernels import LAUNCHES, product_count, reset_launch_counts

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
