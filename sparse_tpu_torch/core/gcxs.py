"""GCXS — the generalized compressed sparse format for N dimensions, with
its 2-D specializations CSR and CSC, on torch tensors.

Layout (as ``sparse_tpu.core.gcxs``): choose a subset ``compressed_axes`` of
the dimensions; logically transpose the array so that those axes lead;
flatten it to a matrix of shape ``(row_size, col_size)``; store that matrix
as CSR: ``data``, ``indices`` (the column of each entry) and ``indptr``
(where each row's entries start), tensors on one device.

Every conversion runs with torch ops on the array's device: axis groups
raveled to int64 keys, a stable ``torch.sort`` by the compressed key alone
(a canonical COO is already in uncompressed order within one key),
``indptr`` by a binary search of the sorted keys, and the row of each entry
expanded from ``indptr`` by ``repeat_interleave``. ``_restructure`` (transpose,
reshape, new compressed axes) computes each entry's new keys with mixed-radix
integer ops and reorders only as far as the old order does not already give
the new one. CPU arrays of float32/float64 data take the host library for
these steps (``native``: ``transpose2d``'s counting scatter in
``from_coo``, ``relinearize`` and the scatter or ``canonicalize2d`` in
``_restructure``, ``csr_row_splice`` for row picks), as ``sparse_tpu``
does, with the same results.

Products of a 2-D array (``@``, ``matmul``, ``dot``, ``matvec_add``) run on
its canonical COO, which the array keeps while its buffers stay the same
ones, and so on that COO's cached row-ELL layout and the CUDA kernels.

Reductions run on the device (``_reduce_calc``): over exactly the
uncompressed axes one segment reduce with ``indptr`` as its offsets, an add
over exactly the compressed axes on runs of ``indices`` (float32/float64 on
the CPU: the host library's ``bincount_sum``), anything else through the
COO. Elementwise operations on GCXS operands return a GCXS.

``concatenate_gcxs``/``stack_gcxs`` splice the inputs' storage on the device.

Indexing (``__getitem__``) splices ``indptr`` on the device for the 2-D
patterns of ``_getitem_fast`` and goes through the COO otherwise;
``asformat("dok")`` gives a DOK on the host.
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from collections.abc import Iterable
from numbers import Integral

import numpy as np
import torch

from .. import _settings, native
from ..native import eager as native_eager
from .._utils import (
    can_store,
    check_fill_value,
    convert_format,
    coords_dtype,
    equivalent,
    full,
    get_out_dtype,
    index_dtype_for,
    normalize_axis,
    numpy_dtype,
    take,
    torch_dtype,
    uncompress_indptr,
    zero_of_dtype,
)
from .base import SparseArray
from .coo import COO, _as_tensor


def _validate_compressed_axes(shape, compressed_axes):
    ndim = len(shape)
    if ndim == 0:
        if compressed_axes is not None and tuple(compressed_axes) != ():
            raise ValueError("no axes to compress for 0d array")
        return ()
    if ndim == 1:
        if compressed_axes is not None and tuple(compressed_axes) not in ((), (0,)):
            raise ValueError("compressed_axes must be None for 1-D arrays")
        return ()
    if compressed_axes is None:
        return (int(np.argmin(shape)),)
    compressed_axes = normalize_axis(tuple(compressed_axes), ndim)
    if len(compressed_axes) == 0 or len(compressed_axes) >= ndim:
        raise ValueError("compressed_axes must be a proper non-empty subset of the axes")
    if len(set(compressed_axes)) != len(compressed_axes):
        raise ValueError("repeated axis in compressed_axes")
    return tuple(sorted(compressed_axes))


def _ravel(coords, axes, shape, nnz, device):
    """The int64 C-order key of each entry's coordinates along ``axes``."""
    key = None
    for a in axes:
        c = coords[a].long()
        key = c if key is None else key * shape[a] + c
    return torch.zeros(nnz, dtype=torch.int64, device=device) if key is None else key


def _unravel(key, dims):
    """The inverse of ``_ravel``: one int64 tensor per extent in ``dims``."""
    out = []
    for d in reversed(dims[1:]):
        out.append(key % d)
        key = key // d
    return [key, *reversed(out)] if dims else []


def _build_indptr(rows, row_size):
    """``indptr`` (int64, ``row_size + 1``) of sorted int64 row ids: where
    each row's run starts, found by binary search on the device (a CUDA
    ``bincount`` would read its input's maximum back to the host)."""
    bounds = torch.arange(row_size + 1, dtype=torch.int64, device=rows.device)
    return torch.searchsorted(rows, bounds)


def _reshape_coo(x, shape):
    """A canonical COO reshaped in C order (its linear order, and so its
    canonical order, is kept)."""
    if x.size != math.prod(shape):
        raise ValueError(f"cannot reshape array of size {x.size} into shape {shape}")
    dt = torch_dtype(index_dtype_for(max(shape) if shape else 0))
    device = x.data.device
    if shape:
        coords = torch.stack(_unravel(x.linear_loc(), shape)).to(dt)
    else:
        coords = torch.zeros((0, x.nnz), dtype=dt, device=device)
    return COO._make(coords, x.data, shape, x.fill_value)


class GCXS(SparseArray):
    """Generalized CSR/CSC sparse array on torch tensors.

    Construct from a COO, a GCXS, a NumPy array, a scipy sparse matrix, or
    the raw ``(data, indices, indptr)`` triple (with ``shape``).
    ``device``: where the array lives; ``None`` means the GPU for NumPy and
    scipy input and the inputs' own device for tensors and sparse arrays.
    """

    def __init__(
        self, arg, shape=None, compressed_axes=None, prune=False, fill_value=None, idx_dtype=None, device=None
    ):
        import scipy.sparse

        if isinstance(arg, SparseArray):
            if device is not None and _settings.resolve_device(device) != arg.device:
                raise ValueError(f"array on {arg.device} given for an array on {device}; use .to() first")
            if isinstance(arg, GCXS):
                if compressed_axes is not None and tuple(compressed_axes) != arg.compressed_axes:
                    arg = arg.change_compressed_axes(compressed_axes)
                self._make_shallow_copy_of(arg)
                if fill_value is not None:
                    self.fill_value = np.asarray(fill_value, dtype=numpy_dtype(self.dtype))[()]
                return
            gcxs = GCXS.from_coo(arg.tocoo(), compressed_axes=compressed_axes, idx_dtype=idx_dtype)
            self._make_shallow_copy_of(gcxs)
            return
        if isinstance(arg, np.ndarray):
            coo = COO.from_numpy(arg, fill_value=fill_value, device=device)
            self._make_shallow_copy_of(GCXS.from_coo(coo, compressed_axes=compressed_axes, idx_dtype=idx_dtype))
            return
        if scipy.sparse.issparse(arg):
            coo = COO.from_scipy_sparse(arg, fill_value=fill_value, device=device)
            self._make_shallow_copy_of(GCXS.from_coo(coo, compressed_axes=compressed_axes, idx_dtype=idx_dtype))
            return
        if isinstance(arg, tuple) and len(arg) == 3:
            data, indices, indptr = arg
            if shape is None:
                raise ValueError("shape must be provided when constructing from (data, indices, indptr)")
            compressed_axes = _validate_compressed_axes(shape, compressed_axes)
            if device is None and isinstance(data, torch.Tensor):
                device = data.device
            device = _settings.resolve_device(device)
            self.data = _as_tensor(data, device)
            self.indices = _as_tensor(indices, device)
            self.indptr = _as_tensor(indptr, device)
            self.compressed_axes = compressed_axes
            super().__init__(shape, fill_value=fill_value)
            if prune:
                self._prune()
            return
        raise ValueError(f"Invalid inputs to GCXS: {type(arg)}")

    # -- fast internal constructor -------------------------------------------------
    @classmethod
    def _make(cls, data, indices, indptr, shape, compressed_axes, fill_value):
        self = object.__new__(cls)
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)
        self.compressed_axes = tuple(compressed_axes)
        self.fill_value = fill_value
        return self

    # -- memoization -----------------------------------------------------------------
    def enable_caching(self):
        """Memoize derived results (3-deep per op)."""
        self._cache = defaultdict(lambda: deque(maxlen=3))
        return self

    def _cached(self, op, key, compute):
        cache = getattr(self, "_cache", None)
        if cache is None:
            return compute()
        for k, v in cache[op]:
            if k == key:
                return v
        value = compute()
        cache[op].append((key, value))
        return value

    def _product_coo(self):
        """The canonical COO that this array's products run on, with its
        cached kernel layouts. It is kept while ``data``, ``indices`` and
        ``indptr`` are the same tensors, and built anew once one of them is
        replaced (in-place changes stay outside the contract, as for a
        COO's layouts)."""
        bufs = (self.data, self.indices, self.indptr)
        memo = self.__dict__.get("_coo_memo")
        if memo is None or any(a is not b for a, b in zip(memo[0], bufs)):
            memo = (bufs, self.tocoo().enable_caching())
            self._coo_memo = memo
        return memo[1]

    # caches and the held COO are dropped on pickle
    def __getstate__(self):
        return (self.data, self.indices, self.indptr, self.shape, self.compressed_axes, self.fill_value)

    def __setstate__(self, state):
        self.data, self.indices, self.indptr, self.shape, self.compressed_axes, self.fill_value = state

    # -- axis bookkeeping ------------------------------------------------------------
    @property
    def _axis_order(self):
        """(compressed axes..., uncompressed axes...) permutation."""
        comp = self.compressed_axes
        return comp + tuple(a for a in range(self.ndim) if a not in comp)

    @property
    def _compressed_shape(self):
        comp = self.compressed_axes
        row_size = math.prod(self.shape[a] for a in comp)
        col_size = math.prod(self.shape[a] for a in range(self.ndim) if a not in comp)
        return (row_size, col_size)

    # -- constructors ------------------------------------------------------------------
    @classmethod
    def from_coo(cls, x, compressed_axes=None, idx_dtype=None):
        """Compress a COO on its device: no copy to the host."""
        compressed_axes = _validate_compressed_axes(x.shape, compressed_axes)
        comp = compressed_axes
        uncomp = tuple(a for a in range(x.ndim) if a not in comp)
        row_size = math.prod(x.shape[a] for a in comp)
        col_size = math.prod(x.shape[a] for a in uncomp)
        data, device, nnz = x.data, x.data.device, x.nnz
        rows = _ravel(x.coords, comp, x.shape, nnz, device)
        cols = _ravel(x.coords, uncomp, x.shape, nnz, device)

        limit = max(row_size, col_size, nnz)
        if idx_dtype is not None:
            if not can_store(idx_dtype, limit):
                raise ValueError(
                    f"cannot store array with the compressed shape {(row_size, col_size)} "
                    f"and nnz {nnz} with dtype {idx_dtype}."
                )
        else:
            # keep the COO's index dtype when it can address the compressed
            # layout; minimal upcast otherwise
            idx_dtype = get_out_dtype(x.coords.dtype, limit)
        tdt = torch_dtype(idx_dtype)

        # a canonical COO is sorted by (comp, uncomp) when the compressed axes
        # lead; otherwise its order within one compressed key is already
        # uncompressed-lex, so a stable sort by that key alone suffices: on
        # the CPU for float32/float64 data the host library's stable counting
        # scatter (``transpose2d``, as sparse_tpu does), the same entries
        host = native.host_route(device, data.dtype)
        if comp != tuple(range(len(comp))) and host and row_size <= max(4 * nnz, 1 << 22):
            indptr, _, cols, data = native_eager.transpose2d(cols, rows, data, row_size, want_rows=False)
            return cls._make(data, cols.to(tdt), indptr.to(tdt), x.shape, compressed_axes, x.fill_value)
        if comp != tuple(range(len(comp))):
            rows, order = torch.sort(rows, stable=True)
            cols = cols[order]
            data = take(data, order)
        indptr = native.build_indptr(rows, row_size) if host else _build_indptr(rows, row_size)
        return cls._make(data, cols.to(tdt), indptr.to(tdt), x.shape, compressed_axes, x.fill_value)

    @classmethod
    def from_numpy(cls, x, compressed_axes=None, fill_value=None, idx_dtype=None, device=None):
        coo = COO.from_numpy(x, fill_value=fill_value, device=device)
        return cls.from_coo(coo, compressed_axes=compressed_axes, idx_dtype=idx_dtype)

    @classmethod
    def from_scipy_sparse(cls, x, /, *, fill_value=None, device=None):
        x = x.tocsr()
        x.sum_duplicates()
        device = _settings.resolve_device(device)
        return cls._make(
            _as_tensor(x.data, device),
            _as_tensor(x.indices, device),
            _as_tensor(x.indptr, device),
            x.shape,
            (0,),
            zero_of_dtype(x.dtype) if fill_value is None else np.asarray(fill_value, dtype=x.dtype)[()],
        )

    @classmethod
    def from_iter(cls, x, shape, fill_value=None, compressed_axes=None, dtype=None, device=None):
        """``COO.from_iter`` compressed along ``compressed_axes``."""
        coo = COO.from_iter(x, shape=shape, fill_value=fill_value, dtype=dtype, device=device)
        return cls.from_coo(coo, compressed_axes=compressed_axes)

    # -- properties ---------------------------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return int(self.data.shape[0])

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in (self.data, self.indices, self.indptr))

    @property
    def device(self):
        return self.data.device

    def to(self, device):
        """A copy of this array on ``device`` (caches are not carried)."""
        device = torch.device(device)
        return type(self)._make(
            self.data.to(device),
            self.indices.to(device),
            self.indptr.to(device),
            self.shape,
            self.compressed_axes,
            self.fill_value,
        )

    @property
    def format(self):
        return "gcxs"

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

    def __str__(self):
        return (
            f"<GCXS: shape={self.shape}, dtype={self.dtype}, nnz={self.nnz}, fill_value={self.fill_value}, "
            f"compressed_axes={self.compressed_axes}, device={self.device}>"
        )

    __repr__ = __str__

    def _prune(self):
        if bool((~equivalent(self.data, self.fill_value)).all()):
            return
        coo = self.tocoo()
        coo._prune()
        self._make_shallow_copy_of(GCXS.from_coo(coo, compressed_axes=self.compressed_axes))

    # -- conversions ----------------------------------------------------------------------
    def tocoo(self):
        """The canonical COO of the same entries, on the array's device. Its
        coordinates keep a narrow ``indices`` dtype with the least upcast the
        shape needs, and are int32/int64 otherwise, as ``sparse_tpu``'s."""
        nnz = self.nnz
        comp = self.compressed_axes
        uncomp = tuple(a for a in range(self.ndim) if a not in comp)
        extent = max(self.shape) if self.shape else 0
        dt = torch_dtype(coords_dtype(get_out_dtype(numpy_dtype(self.indices.dtype), extent), extent))
        coords = torch.empty((self.ndim, nnz), dtype=dt, device=self.device)
        if comp:
            rows = uncompress_indptr(self.indptr, nnz)
            for a, c in zip(comp, _unravel(rows, [self.shape[a] for a in comp])):
                coords[a] = c
        if uncomp:
            for a, c in zip(uncomp, _unravel(self.indices.long(), [self.shape[a] for a in uncomp])):
                coords[a] = c
        coo = COO._make(coords, self.data, self.shape, self.fill_value)
        if comp + uncomp != tuple(range(self.ndim)):
            # the entries lie in the compressed key's order, not row-major:
            # sorted with no check, which would read a bool back to the host
            order = torch.sort(coo.linear_loc(), stable=True).indices
            coo.coords, coo.data = take(coords, (slice(None), order)), take(self.data, order)
        return coo

    def todense(self):
        return self.tocoo().todense()

    def to_scipy_sparse(self, /, *, accept_fv=None):
        """A scipy ``csr_array`` (``compressed_axes == (0,)``) or ``csc_array``
        of the buffers, copied to the host."""
        import scipy.sparse

        if accept_fv is None:
            accept_fv = [0]
        check_fill_value(self, accept_fv, func_name="to_scipy_sparse")
        if self.ndim != 2:
            raise ValueError("Can only convert a 2-dimensional array to a Scipy sparse matrix.")
        arrays = tuple(t.cpu().numpy() for t in (self.data, self.indices, self.indptr))
        if self.compressed_axes == (0,):
            return scipy.sparse.csr_array(arrays, shape=self.shape)
        return scipy.sparse.csc_array(arrays, shape=self.shape)

    def asformat(self, format, **kwargs):
        format = convert_format(format)
        if format == "gcxs":
            compressed_axes = kwargs.get("compressed_axes")
            if compressed_axes is not None and tuple(compressed_axes) != self.compressed_axes:
                return self.change_compressed_axes(compressed_axes)
            return self
        if format == "coo":
            return self.tocoo()
        if format == "dok":
            from .dok import DOK

            return DOK.from_coo(self.tocoo(), **kwargs)
        if format == "csr":
            return CSR(self.change_compressed_axes((0,))) if self.compressed_axes != (0,) else CSR(self)
        if format == "csc":
            return CSC(self.change_compressed_axes((1,))) if self.compressed_axes != (1,) else CSC(self)
        raise NotImplementedError(f"The given format {format} is not supported.")

    def change_compressed_axes(self, new_compressed_axes):
        """Re-compress along other axes (new keys, sort, new ``indptr``)."""
        new_compressed_axes = _validate_compressed_axes(self.shape, new_compressed_axes)
        if new_compressed_axes == self.compressed_axes:
            return self
        return self._restructure(self.shape, compressed_axes=new_compressed_axes)

    def _restructure(self, new_shape, axes=None, compressed_axes=None):
        """Uncompress, relinearize, sort and rebuild in one pass on the
        device, never building a COO.

        Applies an optional axis permutation ``axes`` (transpose), then, when
        ``new_shape`` differs from the permuted shape, a C-order
        relinearization (reshape), and compresses along ``compressed_axes``
        of the target shape. Each entry's target keys are sums of
        mixed-radix terms ``((src // div) % mod) * mul`` over its compressed
        row id (src 0), its stored index (src 1) or, for a reshape, its
        C-order linear index (src 2). The sort is the cheapest one the old
        order allows (``sig`` tracks it)."""
        comp = self.compressed_axes
        uncomp = tuple(a for a in range(self.ndim) if a not in comp)
        comp_shape = tuple(self.shape[a] for a in comp)
        uncomp_shape = tuple(self.shape[a] for a in uncomp)
        new_shape = tuple(int(d) for d in new_shape)
        new_comp = _validate_compressed_axes(new_shape, compressed_axes)
        new_uncomp = tuple(a for a in range(len(new_shape)) if a not in new_comp)
        new_row_size = math.prod(new_shape[a] for a in new_comp)
        new_col_size = math.prod(new_shape[a] for a in new_uncomp)

        data = self.data
        nnz = self.nnz
        idx_np = numpy_dtype(self.indices.dtype)
        if nnz == 0:
            tdt = torch_dtype(get_out_dtype(idx_np, max(new_row_size, new_col_size)))
            return GCXS._make(
                data,
                torch.zeros(0, dtype=tdt, device=self.device),
                torch.zeros(new_row_size + 1, dtype=tdt, device=self.device),
                new_shape,
                new_comp,
                self.fill_value,
            )

        def base_term(a):
            """(src, div, mod) extracting original axis ``a``'s digit."""
            if a in comp:
                i = comp.index(a)
                return (0, math.prod(comp_shape[i + 1 :]), 0 if i == 0 else self.shape[a])
            i = uncomp.index(a)
            return (1, math.prod(uncomp_shape[i + 1 :]), 0 if i == 0 else self.shape[a])

        # ``sig``: the significance sequence (in target axis labels) the
        # entries are lex-sorted by now
        if axes is not None:
            shape_p = tuple(self.shape[a] for a in axes)
            pos = {a: p for p, a in enumerate(axes)}
            sig = tuple(pos[a] for a in comp + uncomp)
            src_axis = list(axes)
        else:
            shape_p = self.shape
            sig = comp + uncomp
            src_axis = list(range(self.ndim))

        if new_shape != shape_p:
            # a C-order relinearization keeps the linear order only when the
            # entries were in C order already
            if math.prod(new_shape) != self.size:
                raise ValueError(f"cannot reshape array of size {self.size} into shape {new_shape}")
            sig = tuple(range(len(new_shape))) if sig == tuple(range(self.ndim)) else None
            lin_terms = [(*base_term(a), math.prod(shape_p[i + 1 :])) for i, a in enumerate(src_axis)]

            def key_terms(axs):
                terms = []
                for i, a in enumerate(axs):
                    mod = 0 if a == 0 else new_shape[a]
                    terms.append((2, math.prod(new_shape[a + 1 :]), mod, math.prod(new_shape[b] for b in axs[i + 1 :])))
                return terms

        else:
            lin_terms = []

            def key_terms(axs):
                return [
                    (*base_term(src_axis[a]), math.prod(new_shape[b] for b in axs[i + 1 :])) for i, a in enumerate(axs)
                ]

        # CPU float32/float64 data: the host library's relinearization, scatter
        # and sorts, as sparse_tpu restructures (integer keys and moved
        # entries: the torch route's results)
        host = native.host_route(self.device, data.dtype)
        if host:
            new_row, new_col = native_eager.relinearize(
                self.indptr, self.indices, lin_terms, key_terms(new_comp), key_terms(new_uncomp)
            )
        else:
            crow = uncompress_indptr(self.indptr, nnz)
            idx = self.indices.long()

            def eval_terms(terms, lin):
                key = torch.zeros(nnz, dtype=torch.int64, device=self.device)
                for s, d, m, u in terms:
                    v = (crow, idx, lin)[s]
                    if d != 1:
                        v = v // d
                    if m:
                        v = v % m
                    key += v * u if u != 1 else v
                return key

            lin = eval_terms(lin_terms, None) if lin_terms else None
            new_row = eval_terms(key_terms(new_comp), lin)
            new_col = eval_terms(key_terms(new_uncomp), lin)

        # reorder: already sorted; one stable sort by the row key (ties are
        # already in column order); or a sort by the whole key, unique since
        # no two entries share a position
        tdt = torch_dtype(get_out_dtype(idx_np, max(new_row_size, new_col_size, nnz)))
        if sig is not None and sig == new_comp + new_uncomp:
            data = data.clone()
        elif sig is not None and tuple(a for a in sig if a not in new_comp) == new_uncomp:
            if host and new_row_size <= max(4 * nnz, 1 << 22):
                indptr, _, new_col, data = native_eager.transpose2d(
                    new_col, new_row, data, new_row_size, want_rows=False
                )
                return GCXS._make(data, new_col.to(tdt), indptr.to(tdt), new_shape, new_comp, self.fill_value)
            new_row, order = torch.sort(new_row, stable=True)
            new_col, data = new_col[order], take(data, order)
        elif host:
            new_row, new_col, data = native_eager.canonicalize2d(new_row, new_col, data, new_row_size)
        else:
            _, order = torch.sort(new_row * new_col_size + new_col, stable=True)
            new_row, new_col, data = new_row[order], new_col[order], take(data, order)
        indptr = native.build_indptr(new_row, new_row_size) if host else _build_indptr(new_row, new_row_size)
        return GCXS._make(data, new_col.to(tdt), indptr.to(tdt), new_shape, new_comp, self.fill_value)

    # -- structural ops ---------------------------------------------------------------------
    def reshape(self, shape, order="C", compressed_axes=None):
        shape = tuple(shape) if isinstance(shape, Iterable) else (shape,)
        if order not in ("C", None):
            raise NotImplementedError("The `order` parameter is not supported.")
        if any(d == -1 for d in shape):
            extra = int(self.size / np.prod([d for d in shape if d != -1], dtype=np.float64))
            shape = tuple([d if d != -1 else extra for d in shape])
        if self.shape == shape:
            return self
        if len(shape) >= 2 and self.ndim >= 1:
            return self._restructure(shape, compressed_axes=compressed_axes)
        coo = _reshape_coo(self.tocoo(), shape)
        if len(shape) == 1:
            return GCXS.from_coo(coo)
        return GCXS.from_coo(coo, compressed_axes=compressed_axes)

    def transpose(self, axes=None, compressed_axes=None):
        if axes is None:
            axes = tuple(reversed(range(self.ndim)))
        axes = normalize_axis(axes, self.ndim)
        if not isinstance(axes, tuple):
            axes = (axes,)
        if axes == tuple(range(self.ndim)):
            return self
        if self.ndim == 2 and compressed_axes is None:
            # O(1): the CSR of A is the CSC of Aᵀ, on the same buffers
            return GCXS._make(
                self.data,
                self.indices,
                self.indptr,
                (self.shape[1], self.shape[0]),
                (1 - self.compressed_axes[0],),
                self.fill_value,
            )
        return self._restructure(tuple(self.shape[a] for a in axes), axes=axes, compressed_axes=compressed_axes)

    def flatten(self, order="C"):
        return self.reshape(-1, order=order)

    def __getitem__(self, index):
        """NumPy indexing on the device: the 2-D patterns of ``_getitem_fast``
        splice ``indptr``; anything else indexes the COO and compresses the
        result (along this array's ``compressed_axes`` where the result has
        them). A position holding one value gives a 0-d tensor."""
        from ..ops.indexing import getitem

        fast = self._getitem_fast(index)
        if fast is not NotImplemented:
            return fast
        out = getitem(self.tocoo(), index)
        if isinstance(out, COO) and out.ndim >= 1:
            keep = out.ndim > max(self.compressed_axes, default=0) and out.ndim >= 2
            try:
                return GCXS.from_coo(out, compressed_axes=self.compressed_axes if keep else None)
            except ValueError:
                return GCXS.from_coo(out)
        return out

    @staticmethod
    def _classify_axis_sel(sel, n, device, checks=None):
        """One 2-D index component as ``(kind, payload)``: ``("full", None)``,
        ``("int", i)``, ``("range", (c0, c1))`` for a step-1 slice, or
        ``("fancy", (positions, host))`` for a 1-D integer or boolean array
        (int64 positions on ``device``; ``host``, the NumPy positions when the
        index came from the host, else ``None``); ``None`` when unsupported
        here. A tensor's bounds check reads back here, or joins ``checks``
        (``ops.slicing.run_checks``) with its positions clamped until then."""
        if isinstance(sel, Integral):
            i = int(sel)
            i += n if i < 0 else 0
            if not (0 <= i < n):
                raise IndexError(f"index {sel} out of bounds for axis with size {n}")
            return ("int", i)
        if isinstance(sel, slice):
            if sel == slice(None):
                return ("full", None)
            start, stop, step = sel.indices(n)
            if step != 1:
                return None
            return ("range", (start, max(start, stop)))
        if isinstance(sel, torch.Tensor):
            if sel.device != device:
                raise ValueError(f"index tensor on {sel.device} given for an array on {device}; move it first")
            if sel.ndim == 1 and sel.dtype == torch.bool:
                if sel.numel() != n:
                    raise IndexError(f"boolean index of size {sel.numel()} for axis with size {n}")
                return ("fancy", (torch.nonzero(sel).flatten(), None))
            if sel.ndim == 1 and not (sel.dtype.is_floating_point or sel.dtype.is_complex):
                t = sel.long()
                if t.numel() and checks is None:
                    lo, hi = torch.stack([t.amin(), t.amax()]).tolist()
                    if lo < -n or hi >= n:
                        raise IndexError(f"index out of bounds for axis with size {n}")
                elif t.numel():
                    # checked with the caller's read; clamped until then
                    checks.append((t.amin(), t.amax(), n))
                    t = t.clamp(-n, n - 1)
                return ("fancy", (torch.where(t < 0, t + n, t), None))
            return None
        arr = np.asarray(sel)
        if arr.ndim == 1 and arr.dtype.kind == "b":
            if arr.size != n:
                raise IndexError(f"boolean index of size {arr.size} for axis with size {n}")
            pos = np.flatnonzero(arr)
        elif arr.ndim == 1 and arr.dtype.kind in "iu":
            if arr.size and (arr.min() < -n or arr.max() >= n):
                raise IndexError(f"index out of bounds for axis with size {n}")
            pos = np.where(arr < 0, arr + n, arr).astype(np.int64)
        else:
            return None
        return ("fancy", (torch.as_tensor(pos, dtype=torch.int64, device=device), pos))

    def _getitem_fast(self, index):
        """The 2-D patterns without a COO: an int, a step-1 slice or an
        integer-array pick along the compressed axis, with an int, a step-1
        slice or a strictly increasing integer-array filter along the other;
        ``indptr`` spliced on the device (each pick's range through
        ``repeat_interleave`` and ``cumsum``), then one masked pass. Reads
        back: the picked ranges' bounds or total, and the filter's count."""
        from ..ops.slicing import run_checks

        if self.ndim != 2 or self.compressed_axes not in ((0,), (1,)):
            return NotImplemented
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) > 2 or any(i is None or i is Ellipsis for i in index):
            return NotImplemented
        index = index + (slice(None),) * (2 - len(index))
        comp_ax = self.compressed_axes[0]
        n_comp, n_unc = self.shape[comp_ax], self.shape[1 - comp_ax]
        dev = self.device
        checks = []  # the compressed axis' tensor picks: checked with the total's read
        comp_sel = self._classify_axis_sel(index[comp_ax], n_comp, dev, checks)
        unc_sel = self._classify_axis_sel(index[1 - comp_ax], n_unc, dev)
        if comp_sel is None or unc_sel is None:
            return NotImplemented
        if comp_sel[0] == "fancy" and unc_sel[0] == "fancy":
            # two advanced indices select pointwise (NumPy), not the outer
            # product this path computes
            return NotImplemented
        if unc_sel[0] == "fancy":
            pos, host = unc_sel[1]
            increasing = bool(np.all(np.diff(host) > 0)) if host is not None else bool((pos[1:] > pos[:-1]).all())
            if pos.numel() > 1 and not increasing:
                # repeated or unordered filters would need a per-row re-sort
                return NotImplemented
        indptr, indices, data = self.indptr, self.indices, self.data

        # phase 1: the compressed-axis selection (indptr spliced)
        kind, payload = comp_sel
        if kind == "int":
            lo, hi = indptr[payload : payload + 2].tolist()
            sub_data, sub_ind = data[lo:hi], indices[lo:hi]
            rel_indptr = torch.zeros(2, dtype=torch.int64, device=dev)
            rel_indptr[1] = hi - lo
            n_sel = 1
        elif kind in ("full", "range"):
            start, stop = (0, n_comp) if kind == "full" else payload
            lo, hi = torch.stack([indptr[start], indptr[stop]]).tolist()
            sub_data, sub_ind = data[lo:hi], indices[lo:hi]
            rel_indptr = indptr[start : stop + 1].long() - lo
            n_sel = stop - start
        else:  # picks, in pick order (repeats allowed)
            sel_pos = payload[0]
            lo = indptr[sel_pos].long()
            counts = indptr[sel_pos + 1].long() - lo
            (total,) = run_checks(checks, [counts.sum()])
            if native.host_route(dev, data.dtype):
                # the host library's segment copies, as sparse_tpu splices
                rel_indptr, sub_ind, sub_data = native_eager.csr_row_splice(indptr, indices, data, sel_pos)
            else:
                run = torch.repeat_interleave(torch.arange(sel_pos.numel(), device=dev), counts, output_size=total)
                ends = torch.cumsum(counts, 0)
                src = lo[run] + torch.arange(total, device=dev) - (ends - counts)[run]
                sub_data, sub_ind = take(data, src), take(indices, src)
                rel_indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), ends])
            n_sel = sel_pos.numel()
        comp_is_scalar = kind == "int"

        # phase 2: the other axis' filter (one masked pass)
        ukind, upayload = unc_sel
        hit = None
        if ukind == "full":
            new_ind, new_data, new_width = sub_ind, sub_data, n_unc
        else:
            wide = sub_ind.long()
            if ukind == "int":
                hit = torch.nonzero(wide == upayload).flatten()
                new_ind = torch.zeros(hit.numel(), dtype=sub_ind.dtype, device=dev)
                new_width = 1
            elif ukind == "range":
                c0, c1 = upayload
                hit = torch.nonzero((wide >= c0) & (wide < c1)).flatten()
                new_ind = (wide[hit] - c0).to(sub_ind.dtype)
                new_width = c1 - c0
            else:
                pos = upayload[0]
                remap = torch.full((n_unc,), -1, dtype=torch.int64, device=dev)
                remap[pos] = torch.arange(pos.numel(), device=dev)
                mapped = remap[wide]
                hit = torch.nonzero(mapped >= 0).flatten()
                new_ind = mapped[hit].to(sub_ind.dtype)
                new_width = pos.numel()
            new_data = take(sub_data, hit)

        if comp_is_scalar and ukind == "int":
            return new_data[0].clone() if new_data.numel() else full((), self.fill_value, self.dtype, dev)
        if comp_is_scalar:
            # a 1-D row: compressed_axes (), indptr [0, nnz]
            one = torch.zeros(2, dtype=indptr.dtype, device=dev)
            one[1] = new_ind.numel()
            return GCXS._make(new_data, new_ind, one, (new_width,), (), self.fill_value)
        if ukind == "int":
            # a 1-D result along the compressed axis: each hit's segment
            rows = torch.searchsorted(rel_indptr, hit, right=True) - 1
            dt = torch_dtype(index_dtype_for(n_sel))
            return GCXS.from_coo(COO._make(rows[None, :].to(dt), new_data, (n_sel,), self.fill_value))
        if hit is None:
            new_indptr = rel_indptr.to(indptr.dtype)
        else:
            kept = torch.zeros(sub_ind.numel() + 1, dtype=torch.int64, device=dev)
            kept[hit + 1] = 1
            new_indptr = torch.cumsum(kept, 0)[rel_indptr].to(indptr.dtype)
        new_shape = (n_sel, new_width) if comp_ax == 0 else (new_width, n_sel)
        return GCXS._make(new_data, new_ind, new_indptr, new_shape, self.compressed_axes, self.fill_value)

    def _reduce_calc(self, method, axis, keepdims=False, **kwargs):
        """Reductions on the device. Reducing exactly the uncompressed axes
        reduces each compressed row: one segment reduce with ``indptr`` as its
        offsets. Add-reducing exactly the compressed axes keeps the
        uncompressed key, which is ``indices``: runs of a stable sort of it.
        Anything else goes through the COO."""
        from ..kernels.segment import reduce_runs

        comp = self.compressed_axes
        uncomp = tuple(a for a in range(self.ndim) if a not in comp)
        kw_dtype = kwargs.get("dtype")
        if self.ndim >= 2 and set(axis) == set(uncomp) and self.nnz:
            indptr = self.indptr.long()
            counts_all = indptr[1:] - indptr[:-1]
            nonempty = torch.nonzero(counts_all).flatten()
            result = take(reduce_runs(method, self.data, indptr, kw_dtype), nonempty)
            comp_shape = tuple(self.shape[a] for a in comp)
            n_cols = math.prod(self.shape[a] for a in uncomp)
            return result, counts_all[nonempty], axis, n_cols, (("rows", nonempty, comp_shape), comp)

        uncomp_shape = tuple(self.shape[a] for a in uncomp)
        keep = math.prod(uncomp_shape)
        if (
            method is np.add
            and kw_dtype is None
            and set(axis) == set(comp)
            and uncomp
            and self.nnz
            and not (self.dtype.is_complex or self.dtype == torch.bool)
            and keep <= max(16 * self.nnz, 1 << 22)
        ):
            if native.host_route(self.device, self.dtype):
                # the host library's bincount, as sparse_tpu sums
                sums, counts = native_eager.bincount_sum(self.indices, self.data, keep)
                keys = torch.nonzero(counts).flatten()
                sums, counts = sums[keys], counts[keys]
            else:
                keys, order = torch.sort(self.indices.long(), stable=True)
                keys, counts = torch.unique_consecutive(keys, return_counts=True)
                offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=self.device)
                torch.cumsum(counts, 0, out=offsets[1:])
                sums = reduce_runs(np.add, take(self.data, order), offsets)
                if sums.dtype.is_floating_point:
                    sums = sums + 0.0  # the sums start from +0.0, as ``sparse_tpu``'s bincount does
            red = math.prod(self.shape[a] for a in axis)
            return sums, counts, axis, red, ((uncomp_shape, keys, False), comp)

        out = self.tocoo()._reduce_calc(method, axis, keepdims, **kwargs)
        if len(out) == 1:
            return out
        data, counts, axis, n_cols, attrs = out
        return data, counts, axis, n_cols, (attrs, comp)

    def _reduce_return(self, data, arr_attrs, result_fill_value):
        from .coo import _kept_result

        attrs, compressed_axes = arr_attrs
        if attrs[0] == "rows":
            _, nonempty, comp_shape = attrs
            size = math.prod(comp_shape)
            mask = ~equivalent(data, result_fill_value)
            dt = torch_dtype(index_dtype_for(size))
            out = COO._make(nonempty[mask][None, :].to(dt), take(data, mask), (size,), result_fill_value)
            return GCXS.from_coo(out.reshape(comp_shape))
        out = _kept_result(data, attrs, result_fill_value)
        if out.ndim < 2:
            return GCXS.from_coo(out)
        try:
            return GCXS.from_coo(out, compressed_axes=tuple(a for a in compressed_axes if a < out.ndim) or None)
        except ValueError:
            return GCXS.from_coo(out)

    def dot(self, other):
        from ..ops.dot import dot

        return dot(self, other)

    def copy(self, deep=True):
        bufs = (self.data, self.indices, self.indptr)
        if deep:
            bufs = tuple(t.clone() for t in bufs)
        return GCXS._make(*bufs, self.shape, self.compressed_axes, self.fill_value)


class _Compressed2d(GCXS):
    def __init__(self, arg, shape=None, prune=False, fill_value=None, device=None, **kwargs):
        cls_axis = self._cls_compressed_axes
        ca = kwargs.pop("compressed_axes", None)
        if ca is not None and tuple(ca) != cls_axis:
            raise ValueError(f"{type(self).__name__} only accepts compressed_axes={cls_axis} but got: {ca}")
        if kwargs:
            raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
        if not hasattr(arg, "shape") and shape is None and not (isinstance(arg, tuple) and len(arg) == 3):
            raise ValueError("missing `shape` argument")
        probe_shape = shape if shape is not None else getattr(arg, "shape", None)
        if probe_shape is not None and len(probe_shape) != 2:
            raise ValueError(f"{type(self).__name__} must be 2-d, passed {len(probe_shape)}-d shape.")
        super().__init__(arg, shape=shape, compressed_axes=cls_axis, prune=prune, fill_value=fill_value, device=device)

    @classmethod
    def from_numpy(cls, x, fill_value=None, idx_dtype=None, device=None):
        coo = COO.from_numpy(x, fill_value=fill_value, device=device)
        return cls(GCXS.from_coo(coo, compressed_axes=cls._cls_compressed_axes, idx_dtype=idx_dtype))

    @classmethod
    def from_scipy_sparse(cls, x, /, *, fill_value=None, device=None):
        x = x.tocsr() if cls._cls_compressed_axes == (0,) else x.tocsc()
        x.sum_duplicates()
        device = _settings.resolve_device(device)
        return cls._make(
            _as_tensor(x.data, device),
            _as_tensor(x.indices, device),
            _as_tensor(x.indptr, device),
            x.shape,
            cls._cls_compressed_axes,
            zero_of_dtype(x.dtype) if fill_value is None else np.asarray(fill_value, dtype=x.dtype)[()],
        )

    def __str__(self):
        return (
            f"<{type(self).__name__}: shape={self.shape}, dtype={self.dtype}, nnz={self.nnz}, "
            f"fill_value={self.fill_value}, device={self.device}>"
        )

    __repr__ = __str__

    def transpose(self, axes=None, copy=False, compressed_axes=None):
        """The O(1) transpose: the other class on the same buffers (copies
        of them with ``copy=True``)."""
        if axes is not None:
            ax = tuple(normalize_axis(tuple(axes) if isinstance(axes, Iterable) else (axes,), 2))
            if ax not in ((0, 1), (1, 0)):
                raise ValueError(f"Invalid transpose axes: {axes}")
            if ax == (0, 1):
                return self.copy() if copy else self
        bufs = (self.data, self.indices, self.indptr)
        if copy:
            bufs = tuple(t.clone() for t in bufs)
        other = CSC if isinstance(self, CSR) else CSR
        return other._make(*bufs, (self.shape[1], self.shape[0]), other._cls_compressed_axes, self.fill_value)


class CSR(_Compressed2d):
    """2-D compressed-sparse-row matrix (GCXS with compressed_axes=(0,))."""

    _cls_compressed_axes = (0,)

    @property
    def format(self):
        return "csr"


class CSC(_Compressed2d):
    """2-D compressed-sparse-column matrix (GCXS with compressed_axes=(1,))."""

    _cls_compressed_axes = (1,)

    @property
    def format(self):
        return "csc"


def _check_devices(arrays):
    devices = {x.device for x in arrays}
    if len(devices) > 1:
        raise ValueError(f"arrays lie on different devices: {sorted(map(str, devices))}")


def concatenate_gcxs(arrays, axis=0):
    """Concatenate GCXS arrays along ``axis`` by splicing their storage on the
    device. Compressed along exactly ``(axis,)`` (inputs compressed otherwise
    are re-compressed first), the flattened matrices stack vertically:
    ``indices`` and ``data`` concatenate as they are and each later
    ``indptr`` is shifted by the entries before it. The index dtype is the
    inputs' with the least upcast the result needs (``get_out_dtype``)."""
    from .._utils import check_consistent_fill_value, result_dtype

    check_consistent_fill_value(arrays)
    _check_devices(arrays)
    ndim = arrays[0].ndim
    axis = normalize_axis(axis, ndim)
    shape = list(arrays[0].shape)
    shape[axis] = sum(int(x.shape[axis]) for x in arrays)
    for x in arrays:
        if x.ndim != ndim:
            raise ValueError("all the input array dimensions must match exactly")
        for d in range(ndim):
            if d != axis and x.shape[d] != shape[d]:
                raise ValueError("all the input array dimensions except for the concatenation axis must match exactly")

    arrays = [x.change_compressed_axes((axis,)) for x in arrays]
    total_nnz = sum(x.nnz for x in arrays)
    col_size = arrays[0]._compressed_shape[1]
    in_idx = np.result_type(*[numpy_dtype(x.indices.dtype) for x in arrays])
    tdt = torch_dtype(get_out_dtype(in_idx, max(shape[axis], col_size, total_nnz, 1)))
    device = arrays[0].device
    parts, nnz_off = [torch.zeros(1, dtype=torch.int64, device=device)], 0
    for x in arrays:
        parts.append(x.indptr[1:].long() + nnz_off)
        nnz_off += x.nnz
    indptr = torch.cat(parts).to(tdt)
    indices = torch.cat([x.indices.long() for x in arrays]).to(tdt)
    dt = result_dtype(*[x.dtype for x in arrays])
    data = torch.cat([x.data.to(dt) for x in arrays])
    return GCXS._make(data, indices, indptr, tuple(shape), (axis,), arrays[0].fill_value)


def stack_gcxs(arrays, axis=0):
    """Stack GCXS arrays along a new ``axis`` by splicing their storage on the
    device. Compressed along ``(axis,)``, the flattened result has one row per
    input, whose column indices are that input's C-order linear locations:
    the compressed row and index of each entry when its compressed axes
    lead (its storage order is C order), else its canonical COO's."""
    from .._utils import check_consistent_fill_value, result_dtype

    check_consistent_fill_value(arrays)
    _check_devices(arrays)
    if len({x.shape for x in arrays}) > 1:
        raise ValueError("all input arrays must have the same shape")
    ndim = arrays[0].ndim
    axis = normalize_axis(axis, ndim + 1)
    in_shape = arrays[0].shape
    col_size = math.prod(in_shape)
    total_nnz = sum(x.nnz for x in arrays)
    in_idx = np.result_type(*[numpy_dtype(x.indices.dtype) for x in arrays])
    tdt = torch_dtype(get_out_dtype(in_idx, max(len(arrays), col_size, total_nnz, 1)))
    dt = result_dtype(*[x.dtype for x in arrays])

    locs, datas = [], []
    for x in arrays:
        ca = x.compressed_axes
        if ca == tuple(range(len(ca))):
            rows = uncompress_indptr(x.indptr, x.nnz)
            locs.append(rows * x._compressed_shape[1] + x.indices.long())
            datas.append(x.data)
        else:
            coo = x.tocoo()
            locs.append(coo.linear_loc())
            datas.append(coo.data)
    indices = torch.cat(locs).to(tdt)
    data = torch.cat([d.to(dt) for d in datas])
    counts = torch.tensor([0] + [x.nnz for x in arrays], dtype=torch.int64)
    indptr = torch.cumsum(counts, 0).to(device=arrays[0].device, dtype=tdt)
    shape = list(in_shape)
    shape.insert(axis, len(arrays))
    return GCXS._make(data, indices, indptr, tuple(shape), (axis,), arrays[0].fill_value)
