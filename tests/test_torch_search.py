"""``sparse_tpu_torch.kernels.search`` against ``sparse_tpu.kernels.search``
on the JAX CPU backend: the same keys and probes, drawn with numpy from a
seed, through both, positions equal exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse_tpu.kernels import search as jsearch
from sparse_tpu_torch.kernels import search as tsearch


def _keys(kind, rng):
    if kind == "ties":  # runs of equal keys, probes landing on and between them
        return np.sort(rng.integers(0, 20, 60)).astype(np.int32)
    if kind == "empty":
        return np.zeros(0, dtype=np.int32)
    return np.sort(rng.integers(-50, 200, 300)).astype(np.int64)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["ties", "wide", "empty"])
@pytest.mark.parametrize("probes", ["arange", "sparse", "none"])
def test_searchsorted_sorted_probes_matches_sparse_tpu(side, kind, probes):
    rng = np.random.default_rng(0)
    keys = _keys(kind, rng)
    p = {"arange": np.arange(-3, 25, dtype=np.int32), "sparse": np.unique(rng.integers(-60, 210, 40)), "none": np.zeros(0, dtype=np.int32)}[probes]
    want = np.asarray(jsearch.searchsorted_sorted_probes(jnp.asarray(keys), jnp.asarray(p), side))
    got = tsearch.searchsorted_sorted_probes(torch.as_tensor(keys), torch.as_tensor(p), side)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, p, side))


def test_searchsorted_sorted_probes_promotes_and_checks():
    keys = torch.tensor([0.5, 1.0, 1.0, 2.5], dtype=torch.float64)
    got = tsearch.searchsorted_sorted_probes(keys, torch.arange(4), "right")
    assert got.tolist() == [0, 3, 3, 4]
    with pytest.raises(ValueError, match="side"):
        tsearch.searchsorted_sorted_probes(keys, torch.arange(4), "middle")
    with pytest.raises(ValueError, match="more than one device"):
        tsearch.searchsorted_sorted_probes(keys, torch.arange(4, device="meta"))
