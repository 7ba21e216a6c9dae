"""Element-wise operations and reductions on the card against the port's
own CPU results.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_elemwise_gpu.py``. Elsewhere every test skips (from a
fixture, so each pytest worker collects the same tests). The same inputs,
drawn with numpy from a seed, go to a COO or GCXS array on the CPU and on
the card: coordinates, dtypes and fill values must be equal, and the data
bit for bit for the exact ops (the transcendental ones within 4 ulps of the
CPU's, complex ones within 8, both sides being within 4 of the true value;
complex arithmetic within 4; float sums, products, means and variances at rtol 1e-12 in float64
and 1e-5 in float32, the card and the CPU adding in other orders). A float
reduction on the card gives the same bits on two calls; every result stays
on the card, and an operand on another device raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st

pytestmark = pytest.mark.gpu

DTYPES = [np.bool_, np.int8, np.uint8, np.uint16, np.int32, np.int64, np.uint64, np.float16, np.float32, np.float64, np.complex128]
EXACT = [
    np.add, np.subtract, np.multiply, np.true_divide, np.floor_divide, np.remainder, np.maximum, np.fmin,
    np.greater, np.less_equal, np.equal, np.logical_and, np.bitwise_xor, np.left_shift, np.right_shift, np.copysign,
]
UNARY_EXACT = [np.negative, np.absolute, np.sign, np.sqrt, np.square, np.reciprocal, np.floor, np.rint, np.isnan, np.signbit]
UNARY_ULPS = [np.sin, np.exp, np.log1p, np.tanh, np.arctan]
RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5, np.dtype(np.float16): 1e-2, np.dtype(np.complex128): 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def values(rng, shape, dtype, kind="exact"):
    dt = np.dtype(dtype)
    n = int(np.prod(shape))
    if kind == "ulps":
        v = rng.uniform(0.15, 0.85, n)
        v = (v + 1j * rng.uniform(0.15, 0.85, n)) if dt.kind == "c" else v
    elif dt.kind == "b":
        v = rng.random(n) < 0.5
    elif dt.kind == "u":
        v = rng.integers(0, 40, n).astype(dt)
        if dt.itemsize == 8:
            v[rng.random(n) < 0.2] = np.uint64(2**64 - 3)
    elif dt.kind == "i":
        v = rng.integers(-20, 21, n)
    else:
        v = rng.standard_normal(n) * 4
        s = rng.random(n)
        v[s < 0.05] = -0.0
        v[(s >= 0.05) & (s < 0.08)] = np.inf
        v[(s >= 0.08) & (s < 0.11)] = np.nan
        v = (v + 1j * rng.standard_normal(n)) if dt.kind == "c" else v
    x = np.asarray(v).astype(dt).reshape(shape)
    x[rng.random(shape) >= 0.4] = 0
    return x


def pair(x, dev, fmt="coo", fill=None):
    fill = None if fill is None else np.asarray(fill, dtype=x.dtype)[()]
    c, g = st.COO.from_numpy(x, fill_value=fill, device="cpu"), st.COO.from_numpy(x, fill_value=fill, device=dev)
    if fmt == "gcxs":
        c, g = st.GCXS.from_coo(c, compressed_axes=(1,)), st.GCXS.from_coo(g, compressed_axes=(1,))
    return c, g


def _bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "c":
        return np.stack([_bits(a.real), _bits(a.imag)])
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def same(on_card, on_cpu, ulps=0, rtol=None):
    """The card's result against the CPU's."""
    if isinstance(on_cpu, torch.Tensor):
        assert on_card.device.type == "cuda"
        g, w = on_card.cpu().numpy(), on_cpu.numpy()
    else:
        assert type(on_card) is type(on_cpu) and on_card.shape == on_cpu.shape
        assert on_card.dtype == on_cpu.dtype
        assert np.asarray(on_card.fill_value).tobytes() == np.asarray(on_cpu.fill_value).tobytes() or rtol is not None
        card, cpu = on_card.tocoo(), on_cpu.tocoo()
        assert card.data.device.type == "cuda" and card.coords.device.type == "cuda"
        assert torch.equal(card.coords.cpu(), cpu.coords)
        g, w = card.data.cpu().numpy(), cpu.data.numpy()
    if ulps == 0 and rtol is None or w.dtype.kind not in "fc":
        np.testing.assert_array_equal(_bits(g), _bits(w))
        return
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = np.isfinite(w)
    if rtol is not None:
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol)
    else:
        tol = ulps * np.spacing(np.abs(w[ok]).astype(w.real.dtype))
        err = np.abs(g[ok] - w[ok])
        assert np.all(err <= tol), f"{np.max(err / tol) * ulps:.1f} ulps"


def run(fn, *args):
    """``fn`` on the CPU operands and on the card's; ``None`` when it raises
    (then both must raise the same type)."""
    cpu, card = [a[0] for a in args], [a[1] for a in args]
    try:
        want = fn(*cpu)
    except Exception as e:  # noqa: BLE001 - the card must raise the same
        with pytest.raises(type(e)):
            fn(*card)
        return None
    return fn(*card), want


@pytest.mark.parametrize("fmt", ["coo", "gcxs"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("func", EXACT, ids=lambda f: f.__name__)
def test_binary_ops_on_the_card_match_the_cpu(cuda, func, dtype, fmt):
    rng = np.random.default_rng(1)
    x, y = values(rng, (30, 40), dtype), values(rng, (30, 40), dtype)
    if func in (np.left_shift, np.right_shift) and np.dtype(dtype).kind in "iu":
        y = (np.abs(y.astype(np.int64)) % (8 * np.dtype(dtype).itemsize + 2)).astype(dtype)
    res = run(lambda a, b: func(a, b), pair(x, cuda, fmt), pair(y, cuda, fmt))
    if res is not None:
        ulps = 4 if np.dtype(dtype).kind == "c" and func in (np.multiply, np.true_divide) else 0
        same(*res, ulps=ulps)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("func", UNARY_EXACT + UNARY_ULPS, ids=lambda f: f.__name__)
def test_unary_ops_on_the_card_match_the_cpu(cuda, func, dtype):
    rng = np.random.default_rng(2)
    complex_ = np.dtype(dtype).kind == "c"
    # the card's and the CPU's complex transcendental functions each lie
    # within 4 ulps of the modulus, so they may differ by 8
    ulps = (8 if complex_ else 4) if func in UNARY_ULPS else (4 if complex_ and func in (np.absolute, np.sign, np.sqrt, np.square, np.reciprocal) else 0)
    x = values(rng, (30, 40), dtype, "ulps" if func in UNARY_ULPS else "exact")
    res = run(func, pair(x, cuda))
    if res is not None:
        same(*res, ulps=ulps)


@pytest.mark.parametrize("shapes", [[(4, 1), (4, 50)], [(3, 1, 40), (3, 20, 40)], [(1, 50), (30, 1)]], ids=str)
def test_broadcasting_scalars_and_dense_operands_on_the_card(cuda, shapes):
    rng = np.random.default_rng(3)
    x, y = values(rng, shapes[0], np.float32), values(rng, shapes[1], np.float32)
    for fill in (None, 1.5):
        a, b = pair(np.where(x == 0, fill or 0, x).astype(np.float32), cuda, fill=fill), pair(y, cuda)
        for fn in (np.add, np.multiply, np.greater, lambda p, q: st.where(p > 0, p, q), lambda p, q: p * 2 + q / 3.5):
            res = run(fn, a, b)
            if res is not None:
                same(*res)
    row = rng.random(shapes[1][-1]).astype(np.float32)  # finite: fill * row stays 0
    res = run(lambda p, d: p * d, pair(y, cuda), (torch.as_tensor(row), torch.as_tensor(row, device=cuda)))
    same(*res)


METHODS = ["sum", "max", "min", "prod", "any", "all", "mean", "var", "std"]


@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.uint16, np.int64, np.uint64, np.float16, np.float32, np.float64, np.complex128], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("method", METHODS)
def test_reductions_on_the_card_match_the_cpu(cuda, method, dtype):
    rng = np.random.default_rng(4)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = np.where(rng.random((6, 7, 8)) < 0.4, rng.uniform(0.5, 1.5, (6, 7, 8)), 0).astype(dt)
    else:
        x = values(rng, (6, 7, 8), dtype) if dt.kind != "c" else (rng.uniform(0.5, 1.5, (6, 7, 8)) * (rng.random((6, 7, 8)) < 0.4)).astype(dt)
    for fmt in ("coo", "gcxs"):
        a = pair(x, cuda, fmt)
        for axis in (None, 0, 1, 2, (0, 1), (1, 2), (0, 2)):
            res = run(lambda p: getattr(p, method)(axis=axis), a)
            if res is None:
                continue
            floats = method in ("sum", "prod", "mean", "var", "std") and (dt.kind in "fc" or method in ("mean", "var", "std"))
            res_dt = np.dtype(np.float64) if method in ("mean", "var", "std") and dt.kind in "biu" else dt
            same(*res, rtol=RTOL[res_dt] if floats else None)
            if floats:  # the same bits on a second call
                again = getattr(a[1], method)(axis=axis)
                assert np.asarray(again.fill_value).tobytes() == np.asarray(res[0].fill_value).tobytes()
                if again.ndim:
                    assert torch.equal(again.tocoo().data, res[0].tocoo().data)


def test_csr_csc_paths_on_the_card(cuda):
    rng = np.random.default_rng(5)
    x = (rng.uniform(0.5, 1.5, (60, 70)) * (rng.random((60, 70)) < 0.2)).astype(np.float32)
    for fmt in ("csr", "csc"):
        cpu = st.COO.from_numpy(x, device="cpu").asformat(fmt)
        card = st.COO.from_numpy(x, device=cuda).asformat(fmt)
        for method in ("sum", "max", "min"):
            for axis in (None, 0, 1):
                same(getattr(card, method)(axis=axis), getattr(cpu, method)(axis=axis), rtol=1e-5)
        same(card + card.T.T, cpu + cpu.T.T)


def test_mixed_devices_raise_and_results_stay_on_the_card(cuda):
    x = (np.random.default_rng(6).random((5, 6)) < 0.3).astype(np.float64)
    cpu, card = pair(x, cuda)
    with pytest.raises(ValueError):
        card + torch.ones(6)
    with pytest.raises(ValueError):
        card + cpu
    with pytest.raises(ValueError):
        torch.ones(6) * card
    outs = {
        "+ 1": card + 1,
        "* ndarray": card * np.ones(6),
        "+ tensor": card + torch.ones(6, device=cuda),
        "sin": np.sin(card),
        "sum": card.sum(axis=0),
        "T": card.T,
        "reshape": card.reshape((3, 10)),
    }
    for name, out in outs.items():
        assert out.data.device.type == "cuda" and out.coords.device.type == "cuda", name
    dense = card + torch.arange(30.0, device=cuda).reshape(5, 6)  # fill + dense varies: a dense tensor on the card
    assert isinstance(dense, torch.Tensor) and dense.device.type == "cuda"


def test_traceable_forms_on_the_card(cuda):
    from sparse_tpu_torch import jitops
    from sparse_tpu_torch.kernels import segment

    rng = np.random.default_rng(7)
    x, y = (rng.random((20, 30)) * (rng.random((20, 30)) < 0.3)), (rng.random((20, 30)) * (rng.random((20, 30)) < 0.3))
    (ca, ga), (cb, gb) = pair(x, cuda), pair(y, cuda)
    out_c, n_c = jitops.union_elemwise(torch.add, ca, cb)
    out_g, n_g = jitops.union_elemwise(torch.add, ga, gb)
    assert int(n_c) == int(n_g) and torch.equal(out_g.coords.cpu(), out_c.coords) and torch.equal(out_g.data.cpu(), out_c.data)
    np.testing.assert_allclose(jitops.sum_dense(ga, (0,)).cpu().numpy(), jitops.sum_dense(ca, (0,)).numpy(), rtol=1e-12)
    ids = torch.as_tensor(np.sort(rng.integers(0, 10, 100)))
    vals = torch.as_tensor(rng.random((100, 3)))
    want = segment.segment_sum_onehot_mm(vals, ids, num_segments=8)
    got = segment.segment_sum_onehot_mm(vals.to(cuda), ids.to(cuda), num_segments=8)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12)
    assert torch.equal(got, segment.segment_sum_onehot_mm(vals.to(cuda), ids.to(cuda), num_segments=8))
