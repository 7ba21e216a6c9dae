"""COO — the N-D coordinate sparse format, on torch tensors.

Storage: ``coords`` with shape ``(ndim, nnz)`` and ``data`` with shape
``(nnz,)``, both tensors on one device, always kept **canonical**:
coordinates sorted in row-major (C) order, duplicates summed, and
(optionally) entries equal to the fill value pruned — the semantics of
``sparse_tpu.core.coo.COO``. Canonicalization runs with torch ops on the
array's device: a stable ``torch.sort`` of the int64 linear key, a segment
sum of duplicates (``index_add_``) and a bitwise prune of the fill; a CPU
array of float32/float64 data with ``native.NATIVE_MIN_SIZE`` entries or
more takes the host library instead (one ``canonicalize2d`` call in 2-D,
else its sort and duplicate sum), with the same bits; so do its 2-D
transpose, its reshape and its add-reductions over some axes
(``sparse_tpu``'s host route, see ``_host_sum``).

Arrays are placed on the GPU unless the caller asks for another device
(``device="cpu"``); see :func:`sparse_tpu_torch._settings.resolve_device`.
"""

from __future__ import annotations

import math
import warnings
from collections import defaultdict, deque
from collections.abc import Iterable
from numbers import Integral

import numpy as np
import torch

from .. import _settings, native
from ..native import eager as native_eager
from .._utils import (
    can_store,
    check_zero_fill_value,
    equivalent,
    full,
    coords_dtype,
    get_out_dtype,
    index_dtype_for,
    normalize_axis,
    numpy_dtype,
    signed_view,
    take,
    torch_dtype,
    wide_index,
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
            coords = np.asarray(coords)
            if not np.issubdtype(coords.dtype, np.integer):
                coords = coords.astype(np.int64)
            coords = _as_tensor(coords, device)
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
            wide = wide_index(coords)
            cmin, *cmax = torch.cat([wide.amin().reshape(1), wide.amax(dim=1)]).tolist()
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
            # narrow input coordinates are kept, widened only as far as the
            # shape needs
            idx_dtype = coords_dtype(coords.dtype, max_extent)
        self.coords = coords.to(torch_dtype(idx_dtype))
        self.data = data
        super().__init__(shape, fill_value=fill_value)

        if (not sorted or has_duplicates) and not self._canonicalize2d_host(sorted):
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

    def _canonicalize2d_host(self, already_sorted):
        """Sort and sum duplicates in one call of the host library
        (``native.eager.canonicalize2d``: a counting sort by row, a stable
        sort a row, runs summed from their first value in entry order) for a
        2-D CPU array of float32/float64 data with ``NATIVE_MIN_SIZE`` entries
        or more, as ``sparse_tpu`` does; the same bits as the torch route.
        Returns whether it ran."""
        n = self.coords.shape[1]
        if (
            self.ndim != 2
            or already_sorted
            or not native.host_route(self.data.device, self.data.dtype, n, native.NATIVE_MIN_SIZE)
            # the counting sort allocates O(rows): not for hyper-tall matrices
            or self.shape[0] > max(4 * n, 1 << 22)
        ):
            return False
        rows, cols, vals = native_eager.canonicalize2d(self.coords[0], self.coords[1], self.data, self.shape[0])
        self.coords = torch.stack([rows, cols]).to(self.coords.dtype)
        self.data = vals
        return True

    def _sort_indices(self, lin):
        """Sort entries into canonical row-major order (stable, so duplicates
        keep their input order). Returns the sorted linear keys. CPU
        float32/float64 arrays of ``NATIVE_MIN_SIZE`` entries or more sort
        by ``native.sort_with_perm``, as ``sparse_tpu`` does."""
        if lin.numel() > 1 and not bool((lin[1:] >= lin[:-1]).all()):
            if native.host_route(self.data.device, self.data.dtype, lin.numel(), native.NATIVE_MIN_SIZE):
                order, lin_sorted = native.sort_with_perm(lin, max_key=self.size - 1)
                lin = lin[order] if lin_sorted is None else lin_sorted
            else:
                lin, order = torch.sort(lin, stable=True)
            self.coords = take(self.coords, (slice(None), order))
            self.data = take(self.data, order)
        return lin

    def _sum_duplicates(self, lin):
        if lin.numel() == 0:
            return
        if self.data.dtype == torch.float64 and native.host_route(
            self.data.device, self.data.dtype, lin.numel(), native.NATIVE_MIN_SIZE
        ):
            if bool((lin[1:] != lin[:-1]).all()):
                return
            # each run summed from its first value in entry order: the bits
            # of the torch route below
            starts, self.data = native.dedup_sum_sorted(lin, self.data)
            self.coords = take(self.coords, (slice(None), starts))
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
        self.coords = take(self.coords, (slice(None), starts))

    def _prune(self):
        mask = ~equivalent(self.data, self.fill_value)
        if not bool(mask.all()):
            self.coords = take(self.coords, (slice(None), mask))
            self.data = take(self.data, mask)

    # -- constructors ----------------------------------------------------------------
    @classmethod
    def from_numpy(cls, x, fill_value=None, idx_dtype=None, device=None):
        """Sparse copy of a dense NumPy array or tensor: every entry not
        bitwise equal to ``fill_value`` (default 0; a 0-d input is its own
        fill) is stored. A tensor stays on its device (``device`` must name
        it); NumPy input goes to ``device``."""
        if isinstance(x, torch.Tensor):
            device = x.device if device is None else _settings.resolve_device(device)
            xt = _as_tensor(x, device)
            np_dt = numpy_dtype(xt.dtype)
            if fill_value is None:
                fill_value = zero_of_dtype(np_dt) if xt.ndim else xt.cpu().numpy()[()]
        else:
            x = np.asarray(x)
            np_dt = x.dtype
            if fill_value is None:
                fill_value = zero_of_dtype(np_dt) if x.shape else x[()]
            device = _settings.resolve_device(device)
            xt = _as_tensor(x, device).reshape(x.shape)
        mask = ~equivalent(xt, np.asarray(fill_value, dtype=np_dt))
        if xt.ndim:
            coords = torch.nonzero(mask).T  # row-major order: already canonical
            data = take(xt, tuple(coords))
        else:  # a 0-d array stores its value at the empty coordinate
            coords = torch.zeros((0, int(mask)), dtype=torch.int64, device=device)
            data = take(xt.reshape(1), mask.reshape(1))
        return cls._from_canonical(coords, data, tuple(xt.shape), fill_value, idx_dtype)

    @classmethod
    def _from_canonical(cls, coords, data, shape, fill_value, idx_dtype=None):
        """A COO of coordinates known canonical and in bounds, as the
        constructor builds it (the index dtype, the fill value's checks), with
        nothing read back from the device."""
        max_extent = max(shape) if shape else 0
        if idx_dtype is not None:
            if not can_store(idx_dtype, max_extent):
                raise ValueError(f"cannot cast array with shape {shape} to dtype {idx_dtype}.")
        else:
            idx_dtype = coords_dtype(coords.dtype, max_extent)
        self = cls._make(coords.to(torch_dtype(idx_dtype)), data, shape, None)
        SparseArray.__init__(self, shape, fill_value=fill_value)
        if _settings.WARN_ON_TOO_DENSE and self.nbytes >= self.size * self.data.element_size():
            warnings.warn(
                "Attempting to create a sparse array that takes no less memory than a dense array.",
                RuntimeWarning,
                stacklevel=2,
            )
        return self

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

    @classmethod
    def from_iter(cls, x, shape, fill_value=None, dtype=None, device=None):
        """A COO from an iterable of ``(coords, value)`` pairs or a dict
        ``{coords: value}`` (``dtype`` for the values; an empty input holds
        no entry, float64 unless ``dtype`` says otherwise)."""
        if isinstance(x, dict):
            x = list(x.items())
        x = list(x)
        if len(x) == 0:
            return cls(
                np.empty((len(shape), 0), dtype=np.intp),
                np.empty((0,), dtype=dtype if dtype is not None else np.float64),
                shape=shape,
                fill_value=fill_value,
                device=device,
            )
        if not all(isinstance(item, tuple) and len(item) == 2 for item in x):
            raise ValueError("Invalid iterable to convert to COO.")
        coords = np.stack([np.atleast_1d(np.asarray(c)) for c, _ in x], axis=1)
        data = np.asarray([v for _, v in x], dtype=dtype)
        return cls(coords, data, shape=shape, fill_value=fill_value, device=device)

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
        out = full(self.shape, self.fill_value, self.dtype, self.device)
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
        array's device, or ``"dok"`` (a dict on the host)."""
        from .._utils import convert_format
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
            from .dok import DOK

            return DOK.from_coo(self, **kwargs)
        raise NotImplementedError(f"The given format {format} is not supported.")

    def to_scipy_sparse(self, /, *, accept_fv=None):
        """A scipy ``coo_array`` of this array (fill value in ``accept_fv``,
        default ``[0]``): an explicit copy to the host."""
        import scipy.sparse

        from .._utils import check_fill_value

        check_fill_value(self, [0] if accept_fv is None else accept_fv, func_name="to_scipy_sparse")
        coords = tuple(wide_index(self.coords).cpu().numpy())
        return scipy.sparse.coo_array((self.data.cpu().numpy(), coords), shape=self.shape)

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

    # -- structural ops ----------------------------------------------------------------
    @property
    def format(self):
        return "coo"

    @property
    def T(self):
        return self.transpose()

    @property
    def mT(self):
        if self.ndim < 2:
            raise ValueError("Cannot compute matrix transpose if `ndim < 2`.")
        axes = list(range(self.ndim))
        axes[-1], axes[-2] = axes[-2], axes[-1]
        return self.transpose(tuple(axes))

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, index):
        """NumPy indexing on the device (``ops.indexing.getitem``); a position
        holding one value gives a 0-d tensor. Memoized for hashable indices
        once caching is enabled (not for tensors, which hash by identity and
        compare element by element)."""
        from ..ops.indexing import getitem

        parts = index if isinstance(index, tuple) else (index,)
        if self._cache is not None and not any(isinstance(k, torch.Tensor) for k in parts):
            try:
                hash(index)
            except TypeError:
                return getitem(self, index)
            return self._cached("getitem", index, lambda: getitem(self, index))
        return getitem(self, index)

    def transpose(self, axes=None):
        """The axes permuted, on the device: the coordinates' rows permuted and
        the entries re-sorted by the new linear key (2-D: one stable sort of
        the new row key, since canonical order already sorts each column's
        entries by row; a CPU array of float32/float64 data with
        ``NATIVE_MIN_NNZ`` entries or more by the host library's counting
        scatter, the same entries). Cached as ``sparse_tpu`` caches it."""
        if axes is None:
            axes = tuple(reversed(range(self.ndim)))
        axes = normalize_axis(axes, self.ndim)
        if not isinstance(axes, tuple):
            axes = (axes,)
        if len(set(axes)) != len(axes) or len(axes) != self.ndim:
            raise ValueError("repeated or incomplete axis in transpose")
        if axes == tuple(range(self.ndim)):
            return self

        def compute():
            shape = tuple(self.shape[ax] for ax in axes)
            dt = torch_dtype(coords_dtype(self.coords.dtype, max(shape) if shape else 0))
            if (
                axes == (1, 0)
                and native.host_route(self.data.device, self.data.dtype, self.nnz, native_eager.NATIVE_MIN_NNZ)
                and self.shape[1] <= max(4 * self.nnz, 1 << 22)
            ):
                # the host library's stable counting scatter by column, as
                # sparse_tpu transposes: the entries of the sort below
                _, rows, cols, vals = native_eager.transpose2d(self.coords[0], self.coords[1], self.data, shape[0])
                return COO._make(torch.stack([rows, cols]).to(dt), vals, shape, self.fill_value)
            coords = wide_index(self.coords)[list(axes), :]
            if axes == (1, 0):
                order = torch.sort(coords[0], stable=True).indices
            else:
                order = torch.sort(_linearize(coords, shape), stable=True).indices
            return COO._make(coords[:, order].to(dt), take(self.data, order), shape, self.fill_value)

        return self._cached("transpose", axes, compute)

    def swapaxes(self, axis1, axis2):
        axis1 = normalize_axis(axis1, self.ndim)
        axis2 = normalize_axis(axis2, self.ndim)
        axes = list(range(self.ndim))
        axes[axis1], axes[axis2] = axes[axis2], axes[axis1]
        return self.transpose(tuple(axes))

    def reshape(self, shape, order="C"):
        """The same entries in ``shape`` (C order), on the device: a 2-D to
        2-D reshape whose column counts divide is digit arithmetic on the
        coordinates; any other unravels the linear key (a CPU array of
        float32/float64 data with ``NATIVE_MIN_NNZ`` entries or more by the
        host library's ``unravel``). The linear order, and so the canonical
        order, is kept: nothing is sorted."""
        shape = tuple(shape) if isinstance(shape, Iterable) else (shape,)
        if order not in ("C", None):
            raise NotImplementedError("The `order` parameter is not supported")
        if any(d == -1 for d in shape):
            extra = int(self.size / np.prod([d for d in shape if d != -1], dtype=np.float64)) if self.size else 0
            shape = tuple([d if d != -1 else extra for d in shape])
        shape = tuple(int(d) for d in shape)
        if self.shape == shape:
            return self
        if self.size != math.prod(shape):
            raise ValueError(f"cannot reshape array of size {self.size} into shape {shape}")

        def compute():
            max_extent = max(shape) if shape else 0
            if self.ndim == 2 and len(shape) == 2 and self.nnz and all(shape):
                k_old, k_new = self.shape[1], shape[1]
                dt = torch_dtype(get_out_dtype(numpy_dtype(self.coords.dtype), max_extent))
                r, c = wide_index(self.coords[0]), wide_index(self.coords[1])
                coords = None
                if k_old % k_new == 0:
                    q = k_old // k_new
                    coords = torch.stack([r * q + c // k_new, c % k_new])
                elif k_new % k_old == 0:
                    q = k_new // k_old
                    coords = torch.stack([r // q, (r % q) * k_old + c])
                if coords is not None:
                    return COO._make(coords.to(dt), self.data, shape, self.fill_value)
            dt = torch_dtype(coords_dtype(get_out_dtype(numpy_dtype(self.coords.dtype), max_extent), max_extent))
            if not shape:
                return COO._make(torch.zeros((0, self.nnz), dtype=dt, device=self.device), self.data, shape, self.fill_value)
            lin = self.linear_loc()
            host = native.host_route(self.data.device, self.data.dtype, self.nnz, native_eager.NATIVE_MIN_NNZ)
            if host and all(shape):
                # the host library's threaded unravel, as sparse_tpu reshapes
                return COO._make(native_eager.unravel(lin, shape).to(dt), self.data, shape, self.fill_value)
            coords = torch.empty((len(shape), self.nnz), dtype=dt, device=self.device)
            for d in range(len(shape) - 1, -1, -1):
                coords[d] = lin % shape[d] if d else lin
                lin = lin // shape[d]
            return COO._make(coords, self.data, shape, self.fill_value)

        return self._cached("reshape", shape, compute)

    def squeeze(self, axis=None):
        if axis is None:
            axis = tuple(i for i, d in enumerate(self.shape) if d == 1)
        else:
            if isinstance(axis, Integral):
                axis = (int(axis),)
            elif not isinstance(axis, Iterable):
                raise ValueError(f"Invalid axis parameter: `{axis}`.")
            axis = normalize_axis(axis, self.ndim)
            for ax in axis:
                if self.shape[ax] != 1:
                    raise ValueError(f"Specified axis `{ax}` has a size greater than one: {self.shape[ax]}")
        return self.reshape(tuple(d for i, d in enumerate(self.shape) if i not in axis))

    def flatten(self, order="C"):
        return self.reshape(-1, order=order)

    def broadcast_to(self, shape):
        from ..ops.elemwise import broadcast_to

        return broadcast_to(self, shape)

    def copy(self, deep=True):
        if deep:
            return COO._make(self.coords.clone(), self.data.clone(), self.shape, self.fill_value)
        return COO._make(self.coords, self.data, self.shape, self.fill_value)

    def resize(self, *args, refcheck=True, coords_dtype=np.intp):
        """Resize in place to the new shape, as ``np.ndarray.resize``: the
        entries whose C-order position lies beyond the new size are dropped.
        Derived results cached on the array are dropped too."""
        shape = args[0] if len(args) == 1 and isinstance(args[0], tuple) else args
        shape = tuple(int(s) for s in shape)
        lin = self.linear_loc()
        keep = lin < math.prod(shape)
        lin = lin[keep]
        dt = torch_dtype(index_dtype_for(max(shape) if shape else 0))
        coords = torch.empty((len(shape), lin.numel()), dtype=dt, device=self.device)
        for d in range(len(shape) - 1, -1, -1):
            coords[d] = lin % shape[d] if shape[d] else lin
            lin = lin // shape[d] if shape[d] else lin
        self.coords, self.data, self.shape = coords, take(self.data, keep), shape
        if self._cache is not None:
            self.enable_caching()

    def nonzero(self):
        """The coordinates of the stored non-zero entries (zero fill only)."""
        from ..ops.common import nonzero

        return nonzero(self)

    def dot(self, other):
        from ..ops.dot import dot

        return dot(self, other)

    # -- reduction plumbing ------------------------------------------------------------
    def _reduce_calc(self, method, axis, keepdims=False, **kwargs):
        """The reduction of ``method`` over ``axis`` on the device: over every
        axis, one reduce of ``data`` (the fill value's share added by the
        super-ufunc or ``method`` itself), returned as ``(value,)``; over some,
        each run of entries that share the kept axes' key, returned as
        ``(data, counts, axis, n_reduced, attrs)`` for ``reduce``."""
        from ..kernels.segment import reduce_all, reduce_runs
        from .base import _apply, _fill_tensor, _reduce_super_ufunc

        kw_dtype = kwargs.get("dtype")
        if set(axis) == set(range(self.ndim)):
            fv = self.fill_value
            if self.nnz:
                result = reduce_all(method, self.data, kw_dtype)
            else:
                result = _fill_tensor(fv, self.device)
            if self.nnz != self.size and (method in (np.add, np.multiply) or equivalent(method(fv, fv), fv)):
                sup = _reduce_super_ufunc.get(method)
                if sup is not None:
                    missing = sup(fv, self.size - self.nnz)
                    result = _apply(method, result, _fill_tensor(missing, self.device), {}) if self.nnz else _fill_tensor(sup(fv, self.size), self.device)
                elif self.nnz:
                    result = _apply(method, result, _fill_tensor(fv, self.device), kwargs)
                else:
                    result = _fill_tensor(fv, self.device)
            result = result.cpu().numpy()
            if kw_dtype is not None:
                result = np.asarray(result).astype(kw_dtype)
            return (np.asarray(result)[()],)

        neg_axis = tuple(ax for ax in range(self.ndim) if ax not in set(axis))
        neg_shape = tuple(self.shape[ax] for ax in neg_axis)
        keep = math.prod(neg_shape)
        red = math.prod(self.shape[ax] for ax in axis)
        keys = _linearize(take(self.coords, list(neg_axis)), neg_shape)
        data = self.data
        leading = neg_axis == tuple(range(len(neg_axis)))
        if method is np.add and kw_dtype is None and self.nnz and native.host_route(self.device, self.dtype):
            zero_fill = bool(np.all(np.asarray(self.fill_value) == 0))
            result, counts, keys, drop_zero = _host_sum(keys, data, keep, leading, zero_fill, self.nnz)
            return result, counts, axis, red, (neg_shape, keys, drop_zero)
        if not leading:
            # the kept axes do not lead: group by a stable sort of their key
            keys, order = torch.sort(keys, stable=True)
            data = take(data, order)
        if self.nnz:
            keys, counts = torch.unique_consecutive(keys, return_counts=True)
            offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=self.device)
            torch.cumsum(counts, 0, out=offsets[1:])
            result = reduce_runs(method, data, offsets, kw_dtype)
        else:
            from ..kernels.segment import result_dtype

            counts = torch.zeros(0, dtype=torch.int64, device=self.device)
            result = torch.zeros(0, dtype=torch_dtype(result_dtype(method, self.dtype, kw_dtype)), device=self.device)
        # ``sparse_tpu`` sums zero-fill float32/float64 entries in a fused pass
        # that drops every sum equal to zero (either sign)
        drop_zero = (
            method is np.add
            and kw_dtype is None
            and self.nnz > 0
            and self.dtype in (torch.float32, torch.float64)
            and bool(np.all(np.asarray(self.fill_value) == 0))
            and keep <= max(16 * self.nnz, 1 << 22)
        )
        return result, counts, axis, red, (neg_shape, keys, drop_zero)

    def _reduce_return(self, data, arr_attrs, result_fill_value):
        return _kept_result(data, arr_attrs, result_fill_value)

    # -- kernel layouts --------------------------------------------------------------
    def to_block_ell(self, block_rows=128):
        """Cached block-ELL layout of a 2-D zero-fill matrix (``kernels.ell_spmm``'s
        input; ``sparse_tpu``'s arrays, built on the host and kept on the
        array's device)."""
        from ..kernels.ell import build_block_ell

        if self.ndim != 2:
            raise ValueError("block-ELL requires a 2-D matrix")
        check_zero_fill_value(self, func_name="to_block_ell")

        def compute():
            rows, cols = wide_index(self.coords).cpu().numpy()
            data = self.data.cpu().numpy()
            return build_block_ell(rows, cols, data, *self.shape, block_rows=block_rows, device=self.device)

        return self._cached_layout("block_ell", block_rows, compute)

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
            coords = wide_index(self.coords).cpu().numpy()
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

    def to_dia(self, max_bands=64, max_fill=8.0):
        """Cached DIA (banded) layout, built on the array's device, or
        ``None`` when the matrix isn't usefully banded (or not square 2-D):
        the matvec becomes shifted multiply-adds (``kernels.dia_spmv``),
        with no gather."""
        from ..kernels.dia import build_dia

        if self.ndim != 2 or self.shape[0] != self.shape[1]:
            return None
        check_zero_fill_value(self, func_name="to_dia")

        def compute():
            return build_dia(
                self.coords[0], self.coords[1], self.data, self.shape[0], max_bands=max_bands, max_fill=max_fill
            )

        return self._cached_layout("dia", (max_bands, max_fill), compute)


def _host_sum(keys, data, keep, leading, zero_fill, nnz):
    """The add-reduction of float32/float64 ``data`` over the runs of the
    kept axes' ``keys`` on the host library, at ``sparse_tpu``'s conditions:
    ``(sums, counts, keys, drop_zero)``. With a zero fill and at most ``16 ·
    nnz`` (or 2^22) kept positions, one fused pass that drops every sum
    equal to zero and counts nothing (``sorted_reduce_compact`` on leading
    kept axes, four accumulators a run; ``bincount_sum_compact`` otherwise);
    else on other kept axes ``bincount_sum`` (bins from +0.0, entries in
    order) while the positions are few, and ``row_reduce_sorted`` (each run
    from its first entry) over the runs of the stably sorted keys."""
    small = keep <= max(16 * nnz, 1 << 22)
    if small and zero_fill:
        if leading:
            idx, sums = native_eager.sorted_reduce_compact(keys, data, max_runs=keep)
        else:
            idx, sums = native_eager.bincount_sum_compact(keys, data, keep)
        return sums, None, idx, True
    if small and not leading:
        sums, counts = native_eager.bincount_sum(keys, data, keep)
        idx = torch.nonzero(counts).flatten()
        return sums[idx], counts[idx], idx, False
    if not leading:
        keys, order = torch.sort(keys, stable=True)
        data = take(data, order)
    idx, sums, counts = native_eager.row_reduce_sorted(keys, data)
    return sums, counts, idx, False


def _kept_result(data, arr_attrs, result_fill_value):
    """The COO of a reduction over some axes: one entry per kept key whose
    value is not the result's fill (sums equal to zero are dropped where
    ``sparse_tpu``'s fused zero-fill sum drops them), in the kept shape."""
    neg_shape, keys, drop_zero = arr_attrs
    keep = math.prod(neg_shape)
    mask = (data != 0) if drop_zero else ~equivalent(data, result_fill_value)
    dt = torch_dtype(index_dtype_for(keep))
    out = COO._make(keys[mask][None, :].to(dt), take(data, mask), (keep,), result_fill_value)
    return out.reshape(neg_shape)


def _linearize(coords, shape):
    """The int64 row-major key of ``coords`` (one row an axis) in ``shape``."""
    key = torch.zeros(coords.shape[1], dtype=torch.int64, device=coords.device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        key += coords[d].to(torch.int64) * stride
        stride *= shape[d]
    return key


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
