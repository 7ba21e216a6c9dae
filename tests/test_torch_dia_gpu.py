"""D1, the DIA shifted sum (``csrc/dia.cu``), on the card.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m gpu --noconftest
tests/test_torch_dia_gpu.py``. Elsewhere every test skips (from a fixture,
so each pytest worker collects the same tests). ``dia_spmv``, ``dia_spmm``
and ``dia_spmv_sharded`` on a CUDA tensor of float32/float64 launch D1, which
adds the same rounded products in the same offset order as the torch ops it
replaces (``_shifted_sum_plain``, ``_sharded_sum``): held bit for bit
against them on the same inputs, with offsets past ±n, strided operands,
more offsets than one launch takes, and values that are not finite. Other
dtypes keep the torch ops and launch nothing.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts
from sparse_tpu_torch.kernels import dia as kdia

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.cpu().contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
    assert torch.equal(_bits(got), _bits(want))


def _bands(offsets, n, seed, dtype, cuda):
    """Random bands, zero where a diagonal leaves the matrix (as build_dia
    lays them out)."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n))
    for i, o in enumerate(offsets):
        bands[i, : max(0, -o)] = 0
        bands[i, min(n, n - o) :] = 0
    return torch.as_tensor(bands, dtype=dtype, device=cuda)


OFFSETS = [(-7, -1, 0, 1, 7), (0,), (-2, 3), (-300, 0, 300), (5,), (-1000, -1, 0, 999, 5000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("offsets", OFFSETS, ids=str)
def test_spmv_and_spmm_equal_the_torch_ops_bit_for_bit(cuda, dtype, offsets):
    n = 1000  # offsets past ±n reach no row
    bands = _bands(offsets, n, len(offsets), dtype, cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    xm = torch.as_tensor(rng.standard_normal((n, 6)), dtype=dtype, device=cuda)
    reset_launch_counts()
    got_v = kdia.dia_spmv(offsets, bands, x)
    got_m = kdia.dia_spmm(offsets, bands, xm)
    assert LAUNCHES["dia_spmv"] == 2 and sum(LAUNCHES.values()) == 2
    _same(got_v, kdia._shifted_sum_plain(offsets, bands, x))
    _same(got_m, kdia._shifted_sum_plain(offsets, bands, xm))
    _same(got_v, kdia.dia_spmv(offsets, bands, x))  # twice, the same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_strided_operands(cuda, dtype):
    n, offsets = 513, (-3, 0, 2)
    full = _bands(offsets, 2 * n, 1, dtype, cuda)
    bands = full[:, ::2]  # a band row stride of 2 n and a column stride of 2
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(3 * n), dtype=dtype, device=cuda)[::3]
    xt = torch.as_tensor(rng.standard_normal((5, n)), dtype=dtype, device=cuda).T  # (n, 5), column stride n
    assert not x.is_contiguous() and not xt.is_contiguous() and not bands.is_contiguous()
    _same(kdia.dia_spmv(offsets, bands, x), kdia._shifted_sum_plain(offsets, bands.contiguous(), x.contiguous()))
    _same(kdia.dia_spmm(offsets, bands, xt), kdia._shifted_sum_plain(offsets, bands.contiguous(), xt.contiguous()))


def test_more_offsets_than_one_launch_takes(cuda):
    n = 400
    offsets = tuple(range(-70, 70, 2))  # 70 diagonals: two launches, the second going on from the first
    bands = _bands(offsets, n, 3, torch.float64, cuda)
    x = torch.randn(n, dtype=torch.float64, device=cuda)
    reset_launch_counts()
    got = kdia.dia_spmv(offsets, bands, x)
    assert LAUNCHES["dia_spmv"] == 2
    _same(got, kdia._shifted_sum_plain(offsets, bands, x))


def test_mixed_dtypes_promote_and_other_dtypes_keep_the_torch_ops(cuda):
    offsets = (-1, 0, 1)
    bands = _bands(offsets, 300, 4, torch.float32, cuda)
    x = torch.randn(300, dtype=torch.float64, device=cuda)
    reset_launch_counts()
    got = kdia.dia_spmv(offsets, bands, x)
    assert got.dtype == torch.float64 and LAUNCHES["dia_spmv"] == 1
    _same(got, kdia._shifted_sum_plain(offsets, bands, x))
    reset_launch_counts()
    ib = torch.randint(-3, 4, (3, 300), device=cuda)
    ix = torch.randint(-3, 4, (300,), device=cuda)
    got = kdia.dia_spmv(offsets, ib, ix)
    assert not any(LAUNCHES.values()) and got.dtype == torch.int64
    assert torch.equal(got, kdia._shifted_sum_plain(offsets, ib, ix))


def test_values_that_are_not_finite(cuda):
    offsets = (-1, 0, 1)
    bands = _bands(offsets, 64, 5, torch.float32, cuda)
    x = torch.randn(64, device=cuda)
    x[3], x[10], x[20] = float("inf"), float("nan"), -0.0
    bands[1, 30] = -0.0
    _same(kdia.dia_spmv(offsets, bands, x), kdia._shifted_sum_plain(offsets, bands, x))


def test_the_kernel_entry_point_checks_its_operands(cuda):
    bands = torch.zeros((2, 8), device=cuda)
    x = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="shapes"):
        _cuda.dia_shifted_sum((0,), bands, x, torch.empty(8, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        _cuda.dia_shifted_sum((0, 1), bands.half(), x.half(), torch.empty(8, device=cuda).half())
    with pytest.raises(ValueError, match="unit column stride"):
        _cuda.dia_shifted_sum((0, 1), torch.zeros((2, 16), device=cuda)[:, ::2], x, torch.empty(8, device=cuda))


@pytest.fixture
def mesh(cuda):
    from sparse_tpu_torch import parallel

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_sharded_on_a_world_of_one(mesh, dtype):
    n, offsets = 4096, (-64, -1, 0, 1, 64)
    bands = _bands(offsets, n, 6, dtype, "cuda")
    x = torch.randn(n, dtype=dtype, device="cuda")
    reset_launch_counts()
    got = kdia.dia_spmv_sharded(offsets, bands, x, mesh)
    assert {k: v for k, v in LAUNCHES.items() if v} == {"dia_spmv": 1}
    _same(got, kdia.dia_spmv(offsets, bands, x))
    # the torch ops on the same halo'd segment (a world of one: the ring wraps onto itself)
    xp = torch.cat([x[-64:], x, x[:64]])
    _same(got, kdia._sharded_sum(offsets, bands, xp, 64))
