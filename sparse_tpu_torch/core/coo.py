"""COO — the N-D coordinate sparse format, on torch tensors.

Storage: ``coords`` with shape ``(ndim, nnz)`` and ``data`` with shape
``(nnz,)``, both tensors on one device, always kept **canonical**:
coordinates sorted in row-major (C) order, duplicates summed, and
(optionally) entries equal to the fill value pruned — the semantics of
``sparse_tpu.core.coo.COO``. Canonicalization runs with torch ops on the
array's device: a stable ``torch.sort`` of the int64 linear key, a segment
sum of duplicates (``index_add_``) and a bitwise prune of the fill.

Arrays are placed on the GPU unless the caller asks for another device
(``device="cpu"``); see :func:`sparse_tpu_torch._settings.resolve_device`.
"""

from __future__ import annotations

import warnings
from collections import defaultdict, deque
from numbers import Integral

import numpy as np
import torch

from .. import _settings
from .._utils import (
    can_store,
    check_zero_fill_value,
    equivalent,
    index_dtype_for,
    numpy_dtype,
    signed_view,
    torch_dtype,
    zero_of_dtype,
)
from .base import SparseArray


class _LayoutEntry:
    """Entry type for ``COO._cached_layout``: a built kernel layout guarded
    by the identities of the buffers it was derived from."""

    __slots__ = ("bufs", "value")

    def __init__(self, bufs, value):
        self.bufs = bufs
        self.value = value


def _is_int(dtype):
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _as_tensor(x, device, dtype=None):
    """``x`` (numpy / sequence / tensor) as a tensor on ``device``. A tensor
    that lies elsewhere raises: nothing moves between devices silently."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"tensor on {x.device} given for an array on {device}; move it with .to() first")
        return x if dtype is None else x.to(dtype)
    x = np.asarray(x)
    dt = torch_dtype(x.dtype if dtype is None else dtype)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)


class COO(SparseArray):
    """N-dimensional coordinate-format sparse array on torch tensors.

    Parameters
    ----------
    coords : array-like or tensor (ndim, nnz), or constructor input
        Coordinates, or any of: ndarray (dense values), another COO, a scipy
        sparse matrix, or scipy-style ``(data, (row, col))``.
    data : array-like or tensor (nnz,), optional
    shape : tuple of int, optional (inferred from coords when omitted)
    fill_value : scalar, default 0
    device : torch device, optional
        Where the array lives. ``None`` means the GPU for NumPy input (an
        error without one) and the inputs' own device for tensor input.
    """

    def __init__(
        self,
        coords,
        data=None,
        shape=None,
        has_duplicates=True,
        sorted=False,
        prune=False,
        cache=False,
        fill_value=None,
        idx_dtype=None,
        device=None,
    ):
        if data is None:
            if isinstance(coords, tuple) and len(coords) == 2 and isinstance(coords[1], (tuple, list)):
                # scipy-style (data, (row, col, ...))
                data, coords = coords[0], np.stack([np.asarray(c) for c in coords[1]], axis=0)
            else:
                arr = _interpret_single_arg(coords, shape, fill_value, device)
                self.__dict__ = arr.__dict__.copy()
                if cache:
                    self.enable_caching()
                return

        self._cache = None
        if cache:
            self.enable_caching()

        if device is None and isinstance(coords, torch.Tensor):
            device = coords.device
        device = _settings.resolve_device(device)
        if isinstance(coords, torch.Tensor):
            coords = _as_tensor(coords, device, None if _is_int(coords.dtype) else torch.int64)
        else:
            coords = _as_tensor(np.asarray(coords).astype(np.int64, copy=False), device)
        data = _as_tensor(data, device)
        if coords.ndim == 1:
            if shape is not None and tuple(np.atleast_1d(shape)) == () and coords.numel() == 0:
                coords = coords.reshape(0, data.numel())
            else:
                coords = coords[None, :]
        if data.ndim == 0:
            data = data.expand(coords.shape[1]).clone()
        if data.ndim != 1:
            raise ValueError("data must be a scalar or 1-dimensional.")
        if coords.ndim != 2:
            raise ValueError("coords must be 2-dimensional (ndim, nnz)")
        if data.shape[0] != coords.shape[1]:
            raise ValueError(f"data length {data.shape[0]} does not match coords nnz {coords.shape[1]}")

        if coords.numel():
            # one host read for the inference and the bounds check
            cmin = int(coords.amin())
            cmax = coords.amax(dim=1).tolist()
        else:
            cmin, cmax = 0, [-1] * coords.shape[0]
        if shape is None:
            shape = tuple(m + 1 for m in cmax)
        if isinstance(shape, Integral):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        if len(shape) != coords.shape[0]:
            raise ValueError(f"The shape of `coords` {tuple(coords.shape)} does not match ndim of the shape {shape}.")
        if cmin < 0 or any(m >= s for m, s in zip(cmax, shape)):
            raise IndexError(f"coords out of bounds for shape {shape}")

        max_extent = max(shape) if shape else 0
        if idx_dtype is not None:
            if not can_store(idx_dtype, max_extent):
                raise ValueError(f"cannot cast array with shape {shape} to dtype {idx_dtype}.")
        else:
            idx_dtype = index_dtype_for(max_extent)
        self.coords = coords.to(torch_dtype(idx_dtype))
        self.data = data
        super().__init__(shape, fill_value=fill_value)

        if not sorted or has_duplicates:
            lin = self.linear_loc()
            if not sorted:
                lin = self._sort_indices(lin)
            if has_duplicates:
                self._sum_duplicates(lin)
        if prune:
            self._prune()

        if _settings.WARN_ON_TOO_DENSE and self.nbytes >= self.size * self.data.element_size():
            warnings.warn(
                "Attempting to create a sparse array that takes no less memory than a dense array.",
                RuntimeWarning,
                stacklevel=2,
            )

    # -- fast internal constructor (no canonicalization) -----------------------------
    @classmethod
    def _make(cls, coords, data, shape, fill_value):
        self = object.__new__(cls)
        self._cache = None
        self.coords = coords
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.fill_value = fill_value
        return self

    # -- caching -------------------------------------------------------------------
    def enable_caching(self):
        """Memoize derived results (3-deep per op) and kernel layouts."""
        self._cache = defaultdict(lambda: deque(maxlen=3))
        return self

    def _cached(self, op, key, compute):
        if self._cache is None:
            return compute()
        for k, v in self._cache[op]:
            if k == key:
                return v
        value = compute()
        if isinstance(value, COO) and value._cache is None and value is not self:
            value.enable_caching()
        self._cache[op].append((key, value))
        return value

    def _cached_layout(self, op, key, compute):
        """Layout memo hardened against buffer REPLACEMENT (``a.data = new``):
        the entry records buffer identities and rebuilds on mismatch.
        In-place element mutation stays outside the contract."""
        if self._cache is None:
            self.enable_caching()
        bufs = (self.coords, self.data)
        entry = self._cached(op, key, lambda: _LayoutEntry(bufs, compute()))
        if any(a is not b for a, b in zip(entry.bufs, bufs)):
            entry.bufs = bufs
            entry.value = compute()
        return entry.value

    def peek_layout(self, op, key):
        """The cached layout for ``(op, key)`` without computing one, or
        ``None``; refuses entries whose buffers were replaced."""
        cache = getattr(self, "_cache", None)
        if not cache or op not in cache:
            return None
        for k, v in cache[op]:
            if k == key and isinstance(v, _LayoutEntry):
                if any(a is not b for a, b in zip(v.bufs, (self.coords, self.data))):
                    return None
                return v.value
        return None

    # -- canonicalization ----------------------------------------------------------
    def linear_loc(self):
        """Row-major linearized coordinates, int64 tensor of shape ``(nnz,)``."""
        if self.ndim == 0:
            return torch.zeros(self.coords.shape[1], dtype=torch.int64, device=self.coords.device)
        if self.size > np.iinfo(np.int64).max:
            raise ValueError("Cannot linearize an array with more than 2**63 elements.")
        out = None
        stride = 1
        for d in range(self.ndim - 1, -1, -1):
            term = self.coords[d].to(torch.int64) * stride
            out = term if out is None else out.add_(term)
            stride *= self.shape[d]
        return out

    def _sort_indices(self, lin):
        """Sort entries into canonical row-major order (stable, so duplicates
        keep their input order). Returns the sorted linear keys."""
        if lin.numel() > 1 and not bool((lin[1:] >= lin[:-1]).all()):
            lin, order = torch.sort(lin, stable=True)
            self.coords = self.coords[:, order]
            self.data = self.data[order]
        return lin

    def _sum_duplicates(self, lin):
        if lin.numel() == 0:
            return
        uniq, inverse, counts = torch.unique_consecutive(lin, return_inverse=True, return_counts=True)
        if uniq.numel() == lin.numel():
            return
        starts = torch.cumsum(counts, 0) - counts
        # float and complex sums start from -0.0 (in both parts), the identity
        # that keeps the sign of every zero (-0.0 + -0.0 is -0.0), as a run
        # summed from its first value does
        dt = self.data.dtype
        seed = complex(-0.0, -0.0) if dt.is_complex else (-0.0 if dt.is_floating_point else 0)
        sums = torch.full((uniq.numel(),), seed, dtype=dt, device=lin.device)
        signed_view(sums).index_add_(0, inverse, signed_view(self.data))  # booleans add as "or"
        self.data = sums
        self.coords = self.coords[:, starts]

    def _prune(self):
        mask = ~equivalent(self.data, self.fill_value)
        if not bool(mask.all()):
            self.coords = self.coords[:, mask]
            self.data = self.data[mask]

    # -- constructors ----------------------------------------------------------------
    @classmethod
    def from_numpy(cls, x, fill_value=None, idx_dtype=None, device=None):
        """Sparse copy of a dense NumPy array: every entry not bitwise equal
        to ``fill_value`` (default 0; a 0-d input is its own fill) is stored."""
        x = np.asarray(x)
        if fill_value is None:
            fill_value = zero_of_dtype(x.dtype) if x.shape else x[()]
        device = _settings.resolve_device(device)
        xt = _as_tensor(x, device)
        mask = ~equivalent(xt, np.asarray(fill_value, dtype=x.dtype))
        if x.ndim:
            coords = torch.nonzero(mask).T  # row-major order: already canonical
            data = xt[mask]
        else:  # a 0-d array stores its value at the empty coordinate
            coords = torch.zeros((0, int(mask)), dtype=torch.int64, device=device)
            data = xt.reshape(1)[mask.reshape(1)]
        return cls(
            coords,
            data,
            shape=x.shape,
            fill_value=fill_value,
            has_duplicates=False,
            sorted=True,
            idx_dtype=idx_dtype,
            device=device,
        )

    @classmethod
    def from_scipy_sparse(cls, x, /, *, fill_value=None, device=None):
        x = x.tocoo()
        if hasattr(x, "coords"):  # n-D coo_array (scipy >= 1.14)
            coords = np.stack(x.coords, axis=0)
        else:
            coords = np.stack([x.row, x.col], axis=0)
        return cls(
            coords,
            np.asarray(x.data),
            shape=x.shape,
            has_duplicates=not x.has_canonical_format,
            sorted=False,
            fill_value=fill_value,
            device=device,
        )

    # -- properties ------------------------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return int(self.coords.shape[1])

    @property
    def nbytes(self):
        return self.data.numel() * self.data.element_size() + self.coords.numel() * self.coords.element_size()

    @property
    def device(self):
        return self.data.device

    def to(self, device):
        """A copy of this array on ``device`` (layout caches are not carried)."""
        device = torch.device(device)
        return COO._make(self.coords.to(device), self.data.to(device), self.shape, self.fill_value)

    def __str__(self):
        return (
            f"<COO: shape={self.shape}, dtype={self.dtype}, nnz={self.nnz}, "
            f"fill_value={self.fill_value}, device={self.device}>"
        )

    __repr__ = __str__

    # -- densify ---------------------------------------------------------------------
    def todense(self):
        """Dense tensor on the array's device, holding ``fill_value`` where no
        entry is stored."""
        out = torch.full(self.shape, self.fill_value.item(), dtype=self.dtype, device=self.device)
        if self.ndim:
            signed_view(out)[tuple(self.coords.to(torch.int64))] = signed_view(self.data)
        elif self.nnz:
            out = self.data[-1].reshape(())
        return out

    # -- conversions -----------------------------------------------------------------
    def tocoo(self):
        return self

    def asformat(self, format, **kwargs):
        """This array as ``"coo"`` (itself), ``"gcxs"`` (``GCXS.from_coo``
        with ``kwargs``), ``"csr"`` or ``"csc"`` (2-D only), built on the
        array's device."""
        from .._utils import convert_format, not_ported
        from .gcxs import CSC, CSR, GCXS

        format = convert_format(format)
        if format == "coo":
            return self
        if format == "gcxs":
            return GCXS.from_coo(self, **kwargs)
        if format in ("csr", "csc"):
            if self.ndim != 2:
                raise ValueError(f"{format} is only valid for 2-D arrays")
            cls, compressed_axes = (CSR, (0,)) if format == "csr" else (CSC, (1,))
            return cls(GCXS.from_coo(self, compressed_axes=compressed_axes))
        if format == "dok":
            raise not_ported("the DOK format")
        raise NotImplementedError(f"The given format {format} is not supported.")

    def _tocsr_csc(self, kind):
        from .._utils import check_fill_value

        check_fill_value(self, [0], func_name="tocsr" if kind == "csr" else "tocsc")
        if self.ndim != 2:
            raise ValueError("Can only convert a 2-dimensional array to a Scipy sparse matrix.")
        m = self.asformat(kind).to_scipy_sparse()
        m.has_canonical_format = True
        return m

    def tocsr(self):
        """A scipy ``csr_array`` of this 2-D array (zero fill), on the host."""
        return self._cached("tocsr", None, lambda: self._tocsr_csc("csr"))

    def tocsc(self):
        """A scipy ``csc_array`` of this 2-D array (zero fill), on the host."""
        return self._cached("tocsc", None, lambda: self._tocsr_csc("csc"))

    # -- kernel layouts --------------------------------------------------------------
    def to_row_ell(self, min_pad=8, max_tiers=None, group=16):
        """Cached degree-sorted per-row ELL layout — the SpMM/SpMV kernels'
        input (``kernels.row_ell_spmm``), built once on the host and kept on
        the array's device; requires a 2-D zero-fill matrix. ``group=16``
        (default) builds the exact-width grouped ``(r/G, w, G)`` layout;
        ``group=0`` the legacy ``(r, w)``."""
        from ..kernels.row_ell import build_row_ell, row_ell_cache_key

        if self.ndim != 2:
            raise ValueError("row-ELL requires a 2-D matrix")
        check_zero_fill_value(self, func_name="to_row_ell")

        def compute():
            coords = self.coords.cpu().numpy()
            return build_row_ell(
                coords[0],
                coords[1],
                self.data.cpu().numpy(),
                self.shape[0],
                self.shape[1],
                min_pad=min_pad,
                max_tiers=max_tiers,
                group=group,
                device=self.device,
            )

        return self._cached_layout("row_ell", row_ell_cache_key(min_pad, max_tiers, group), compute)


def _interpret_single_arg(x, shape, fill_value, device):
    """``COO(x)`` for x: another COO, a dense ndarray, or a scipy sparse matrix."""
    import scipy.sparse

    if isinstance(x, COO):
        if shape is not None and tuple(shape) != x.shape:
            raise ValueError("Cannot change shape when converting to COO; use reshape")
        if device is not None and _settings.resolve_device(device) != x.device:
            raise ValueError(f"COO on {x.device} given for an array on {device}; use .to() first")
        if fill_value is not None:
            return COO._make(x.coords, x.data, x.shape, np.asarray(fill_value, dtype=numpy_dtype(x.dtype))[()])
        return x
    if isinstance(x, np.ndarray):
        if shape is not None and tuple(shape) != x.shape:
            raise ValueError("Cannot interpret input as COO array.")
        return COO.from_numpy(x, fill_value=fill_value, device=device)
    if scipy.sparse.issparse(x):
        return COO.from_scipy_sparse(x, fill_value=fill_value, device=device)
    raise ValueError("Cannot interpret input as COO array.")
