"""``SparseArray`` — the abstract base of the sparse formats.

Shape and fill-value validation and the common properties, as in
``sparse_tpu.core.base``. The NumPy protocols, the elementwise operators and
the reduction driver come with later slices of the port.
"""

from __future__ import annotations

import abc
from collections.abc import Iterable
from numbers import Integral

import numpy as np
import torch

from .. import _settings
from .._utils import numpy_dtype, zero_of_dtype


class SparseArray(abc.ABC):
    def __init__(self, shape, fill_value=None):
        if not isinstance(shape, Iterable):
            shape = (shape,)
        if not all(isinstance(sh, Integral) and int(sh) >= 0 for sh in shape):
            raise ValueError(f"shape must be non-negative integers, got {shape}")
        self.shape = tuple(int(sh) for sh in shape)
        np_dt = numpy_dtype(self.dtype)
        if fill_value is None:
            self.fill_value = zero_of_dtype(np_dt)
            return
        if isinstance(fill_value, torch.Tensor):
            fill_value = fill_value.detach().cpu().numpy()
        if hasattr(fill_value, "dtype") and np.dtype(fill_value.dtype) != np_dt:
            raise ValueError(f"fill_value dtype {fill_value.dtype} does not match array dtype {np_dt}")
        self.fill_value = np.asarray(fill_value, dtype=np_dt)[()]

    # -- abstract storage interface ------------------------------------------------
    @property
    @abc.abstractmethod
    def dtype(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def nnz(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @abc.abstractmethod
    def todense(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _make_shallow_copy_of(self, other):
        self.__dict__ = other.__dict__.copy()

    # -- common properties ---------------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        out = 1
        for sh in self.shape:
            out *= sh
        return out

    @property
    def density(self):
        return self.nnz / self.size if self.size else float("nan")

    # -- densification gate --------------------------------------------------------
    def __array__(self, *args, **kwargs):
        if not _settings.AUTO_DENSIFY:
            raise RuntimeError(
                "Cannot convert a sparse array to dense automatically. To manually densify, use the todense method."
            )
        return np.asarray(self.todense().cpu().numpy(), *args, **kwargs)

    # ``ndarray @ sparse`` defers to ``__rmatmul__`` instead of densifying
    __array_ufunc__ = None

    def __matmul__(self, other):
        from ..ops.dot import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from ..ops.dot import matmul

        return matmul(other, self)
