"""DOK — the dict-of-keys format, the mutable builder format.

DOK is a dict on the host by nature, as in ``sparse_tpu``: ``{coord_tuple:
value}`` with NumPy scalar values. It remembers a device (the GPU unless
``device="cpu"``; a DOK made from a COO takes the COO's), and ``to_coo`` /
``todense`` / ``asformat`` build there, one copy of the entries to the
device. ``from_coo`` copies the entries to the host once. ``__setitem__``
takes scalars, slices (expanded over the index grid), and 1-D/N-D fancy
indices, and deletes an entry whose new value equals the fill value;
``__getitem__`` reads one element from the dict (a NumPy scalar) and goes
through the COO for anything else.
"""

from __future__ import annotations

from numbers import Integral

import numpy as np
import torch

from .. import _settings
from .._utils import equivalent, numpy_dtype, torch_dtype, wide_index
from .base import SparseArray
from .coo import COO


class DOK(SparseArray):
    """Dict-of-keys mutable sparse array, on the host.

    Parameters
    ----------
    shape : tuple of int, or a COO / sparse array / ndarray / scipy matrix /
        DOK to convert
    data : dict ``{coords: value}``, optional
    dtype : optional (float64 until the first value says otherwise)
    fill_value : scalar, default 0
    device : torch device, optional
        Where ``to_coo`` and ``todense`` build; ``None`` means the GPU (a
        converted sparse array keeps its own device).
    """

    def __init__(self, shape, data=None, dtype=None, fill_value=None, device=None):
        import scipy.sparse

        if isinstance(shape, COO):
            self._make_shallow_copy_of(DOK.from_coo(shape))
            return
        if isinstance(shape, np.ndarray):
            self._make_shallow_copy_of(DOK.from_numpy(shape, device=device))
            return
        if isinstance(shape, SparseArray) and not isinstance(shape, DOK):
            self._make_shallow_copy_of(DOK.from_coo(shape.tocoo()))
            return
        if isinstance(shape, DOK):
            arr = shape
            self.data = dict(arr.data)
            self.dtype_ = arr.dtype_
            self._device = arr.device
            SparseArray.__init__(self, arr.shape, fill_value=arr.fill_value if fill_value is None else fill_value)
            return
        if scipy.sparse.issparse(shape):
            self._make_shallow_copy_of(DOK.from_coo(COO.from_scipy_sparse(shape, device=device)))
            return

        if isinstance(shape, Integral):
            shape = (int(shape),)
        self.data = {}
        self.dtype_ = numpy_dtype(dtype) if dtype is not None else None
        self._device = _settings.resolve_device(device)
        SparseArray.__init__(self, shape, fill_value=fill_value)

        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise ValueError("data must be a dict.")
        if self.dtype_ is None and data:
            # the dtype spans every initial value ({uint8, uint16} -> uint16)
            self.dtype_ = np.result_type(*[np.asarray(v) for v in data.values()])
        for c, d in data.items():
            self[c] = d

    # -- properties --------------------------------------------------------------------
    @property
    def dtype(self):
        """A torch dtype, as the other formats give (float64 until the first
        value says otherwise)."""
        return torch_dtype(self._np_dtype)

    @property
    def _np_dtype(self):
        return self.dtype_ if self.dtype_ is not None else np.dtype(np.float64)

    @property
    def device(self):
        return self._device

    @property
    def nnz(self):
        return len(self.data)

    @property
    def format(self):
        return "dok"

    @property
    def nbytes(self):
        return self.nnz * (self._np_dtype.itemsize + self.ndim * np.dtype(np.intp).itemsize)

    def to(self, device):
        """A copy of this DOK whose conversions build on ``device``."""
        out = self.copy()
        out._device = torch.device(device)
        return out

    # -- conversions -------------------------------------------------------------------
    @classmethod
    def from_coo(cls, x):
        """The entries of a COO, copied to the host once; the DOK keeps the
        COO's device."""
        ar = cls(x.shape, dtype=numpy_dtype(x.dtype), fill_value=x.fill_value, device=x.device)
        coords = wide_index(x.coords).cpu().numpy()
        data = x.data.cpu().numpy()
        ar.data = dict(zip(map(tuple, coords.T.tolist()), list(data)))
        return ar

    @classmethod
    def from_numpy(cls, x, fill_value=None, device=None):
        return cls.from_coo(COO.from_numpy(x, fill_value=fill_value, device=device))

    @classmethod
    def from_scipy_sparse(cls, x, /, *, fill_value=None, device=None):
        return cls.from_coo(COO.from_scipy_sparse(x, fill_value=fill_value, device=device))

    def to_coo(self):
        """The COO of the entries, built on the DOK's device (one copy)."""
        if not self.data:
            return COO(
                np.empty((self.ndim, 0), dtype=np.intp),
                np.empty((0,), dtype=self._np_dtype),
                shape=self.shape,
                fill_value=self.fill_value,
                device=self.device,
            )
        coords = np.array(list(self.data.keys()), dtype=np.intp).T.reshape(self.ndim, -1)
        data = np.array(list(self.data.values()), dtype=self._np_dtype)
        return COO(coords, data, shape=self.shape, fill_value=self.fill_value, device=self.device)

    tocoo = to_coo

    def todense(self):
        """The dense tensor on the DOK's device."""
        return self.to_coo().todense()

    def asformat(self, format, **kwargs):
        from .._utils import convert_format

        format = convert_format(format)
        if format == "dok":
            return self
        return self.to_coo().asformat(format, **kwargs)

    def __str__(self):
        return (
            f"<DOK: shape={self.shape}, dtype={self.dtype}, nnz={self.nnz}, "
            f"fill_value={self.fill_value}, device={self.device}>"
        )

    __repr__ = __str__

    # -- get --------------------------------------------------------------------------
    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)

        if all(isinstance(k, Integral) for k in key) and len(key) == self.ndim:
            key = tuple(int(k) + self.shape[i] if int(k) < 0 else int(k) for i, k in enumerate(key))
            for i, k in enumerate(key):
                if k < 0 or k >= self.shape[i]:
                    raise IndexError(f"index {k} is out of bounds for axis {i} with size {self.shape[i]}")
            if key in self.data:
                return self.data[key]
            return np.asarray(self.fill_value, dtype=self._np_dtype)[()]

        if all(isinstance(k, Integral) for k in key) and len(key) != self.ndim:
            raise IndexError(f"too many indices for array with {self.ndim} dimensions")

        if any(isinstance(k, (list, np.ndarray)) for k in key):
            arrs = [np.asarray(k) for k in key]
            if not all(a.ndim == 1 and np.issubdtype(a.dtype, np.integer) for a in arrs):
                raise IndexError("DOK fancy indices must be 1-D integer arrays.")
            if len(key) != self.ndim:
                raise NotImplementedError("DOK fancy indexing requires one index array per dimension.")
            if len({len(a) for a in arrs}) != 1:
                raise IndexError("DOK fancy index arrays must have equal lengths.")
            n = len(arrs[0])
            out = np.empty(n, dtype=self._np_dtype)
            for i in range(n):
                out[i] = self[tuple(int(a[i]) for a in arrs)]
            return COO.from_numpy(out, fill_value=self.fill_value, device=self.device)

        return self.to_coo()[key]

    # -- set --------------------------------------------------------------------------
    def __setitem__(self, key, value):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()  # DOK lives on the host
        value = np.asarray(value, dtype=self.dtype_)
        if self.dtype_ is None:
            self.dtype_ = value.dtype
            self.fill_value = np.asarray(self.fill_value, dtype=value.dtype)[()]

        if not isinstance(key, tuple):
            key = (key,)

        # a full scalar coordinate
        if len(key) == self.ndim and all(isinstance(k, Integral) for k in key) and value.ndim == 0:
            self._setone(tuple(int(k) for k in key), value[()])
            return

        # a tuple of per-dimension index sequences
        if key and all(isinstance(k, (np.ndarray, list, tuple)) for k in key):
            if len(key) != self.ndim:
                raise NotImplementedError(f"Index sequences for all {self.ndim} array dimensions needed!")
            if len({len(k) for k in key}) != 1:
                raise IndexError("Unequal length of index sequences!")
            arrs = [np.asarray(k) for k in key]
            if not all(np.issubdtype(a.dtype, np.integer) for a in arrs):
                raise IndexError("Indices must be sequences of integer types!")
            if arrs[0].ndim != 1:
                raise IndexError("Indices are not 1d sequences!")
            if value.ndim > 1:
                raise ValueError(f"Dimension of values ({value.ndim}) must be 0 or 1!")
            if value.ndim == 1 and value.shape != arrs[0].shape:
                raise ValueError(f"Shape mismatch of indices ({arrs[0].shape}) and values ({value.shape})!")
            vals = np.broadcast_to(value, (len(arrs[0]),))
            for i in range(len(arrs[0])):
                self._setone(tuple(int(a[i]) for a in arrs), vals[i])
            return

        # ints and slices, expanded over the index grid
        self._setitem_general(key, value)

    def _setone(self, coord, value):
        coord = tuple(int(c) + self.shape[i] if int(c) < 0 else int(c) for i, c in enumerate(coord))
        for i, c in enumerate(coord):
            if c < 0 or c >= self.shape[i]:
                raise IndexError(f"index {c} is out of bounds for axis {i} with size {self.shape[i]}")
        value = np.asarray(value, dtype=self._np_dtype)
        if bool(equivalent(value, np.asarray(self.fill_value, dtype=self._np_dtype))):
            self.data.pop(coord, None)
        else:
            self.data[coord] = value[()]

    def _setitem_general(self, key, value):
        from ..ops.slicing import normalize_index

        key = normalize_index(key, self.shape)
        if any(k is None for k in key):
            raise IndexError("newaxis is not supported in DOK assignment")
        ranges = []
        out_dims = []
        for k in key:
            if isinstance(k, Integral):
                ranges.append(np.array([int(k)]))
            elif isinstance(k, slice):
                ranges.append(np.arange(k.start, k.stop, k.step))
                out_dims.append(len(ranges[-1]))
            else:
                ranges.append(np.asarray(k))
                out_dims.append(len(ranges[-1]))
        value = np.broadcast_to(value, tuple(out_dims)).reshape(tuple(out_dims))
        grids = np.meshgrid(*ranges, indexing="ij")
        # the value's axes are the non-integer ones: expand it to the full grid
        full_value = value.reshape(tuple(len(r) if not isinstance(k, Integral) else 1 for r, k in zip(ranges, key)))
        full_value = np.broadcast_to(full_value, grids[0].shape)

        flat_vals = np.ascontiguousarray(full_value).reshape(-1).astype(self._np_dtype)
        keys = list(zip(*[g.reshape(-1).tolist() for g in grids]))
        keep = ~equivalent(flat_vals, np.asarray(self.fill_value, dtype=self._np_dtype)).numpy()
        if bool(keep.all()):
            self.data.update(zip(keys, list(flat_vals)))
            return
        vals_list = list(flat_vals)
        for i, k_ in enumerate(keys):
            if keep[i]:
                self.data[k_] = vals_list[i]
            else:
                self.data.pop(k_, None)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- structure and reductions through the COO ---------------------------------------
    def reshape(self, shape, order="C"):
        return self.to_coo().reshape(shape, order=order).asformat("dok")

    def transpose(self, axes=None):
        return self.to_coo().transpose(axes).asformat("dok")

    def _reduce_calc(self, method, axis, keepdims=False, **kwargs):
        return self.to_coo()._reduce_calc(method, axis, keepdims, **kwargs)

    def _reduce_return(self, data, arr_attrs, result_fill_value):
        from .coo import _kept_result

        return _kept_result(data, arr_attrs, result_fill_value)

    def copy(self, deep=True):
        out = DOK(self.shape, dtype=self.dtype_, fill_value=self.fill_value, device=self.device)
        out.data = dict(self.data)
        return out
