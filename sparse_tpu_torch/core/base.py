"""``SparseArray`` — the abstract base of the sparse formats.

Shape and fill-value validation, the common properties, the NumPy protocols
and operators, and the fill-value-aware reduction driver with the statistics
built on it, as in ``sparse_tpu.core.base``:

- ``__array_ufunc__`` (NEP 13): ``np.add(a, b)``, ``a + b``, ``np.sin(a)``,
  ``np.add.outer`` and ``np.add.reduce`` reach the op table of
  ``ops.elemwise`` and ``reduce``; ``np.matmul`` goes to ``ops.dot.matmul``;
- ``__array_function__`` (NEP 18): ``np.sum(a)``, ``np.where(c, a, b)``, ...
  dispatch to the port's namespace;
- the operators of ``np.lib.mixins.NDArrayOperatorsMixin``; ``tensor + a``
  reaches ``a.__radd__``, since torch gives way to an operand it does not
  know;
- ``reduce`` and ``sum``/``max``/``min``/``prod``/``any``/``all``/``mean``/
  ``var``/``std`` with NumPy's dtype rules.

The formats (COO, GCXS) implement ``_reduce_calc`` / ``_reduce_return``.
"""

from __future__ import annotations

import abc
import warnings
from collections.abc import Iterable
from numbers import Integral

import numpy as np
import torch

from .. import _settings
from .._utils import equivalent, normalize_axis, numpy_dtype, select, zero_of_dtype

# Reductions whose missing-fill-value correction has a closed form:
# reduce(op, fv repeated k times) == super_op(fv, k).
_reduce_super_ufunc = {np.add: np.multiply, np.multiply: np.power}


class SparseArray(np.lib.mixins.NDArrayOperatorsMixin, abc.ABC):
    __array_priority__ = 12.5  # beat ndarray in binary ops

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

    @property
    def device(self):
        """The ``torch.device`` the array's tensors live on."""
        return self.data.device

    def to_device(self, device, /, *, stream=None):
        """The array on ``device``: itself when it is there already, else a
        copy moved there (``to``), the one explicit move."""
        if _settings.resolve_device(device) == self.device:
            return self
        return self.to(device)

    def maybe_densify(self, max_size=1000, min_density=0.25):
        """The dense tensor when the array is small or dense enough, else
        ``ValueError``."""
        if self.size > max_size and self.density < min_density:
            raise ValueError("Operation would require converting large sparse array to dense")
        return self.todense()

    def todok(self):
        return self.asformat("dok")

    # -- Array-API -----------------------------------------------------------------
    def __array_namespace__(self, *, api_version=None):
        if api_version is None:
            api_version = "2024.12"
        if api_version not in {"2021.12", "2022.12", "2023.12", "2024.12"}:
            raise ValueError(f'"{api_version}" Array API version not supported.')
        import sparse_tpu_torch

        return sparse_tpu_torch

    # -- densification gate --------------------------------------------------------
    def __array__(self, *args, **kwargs):
        if not _settings.AUTO_DENSIFY:
            raise RuntimeError(
                "Cannot convert a sparse array to dense automatically. To manually densify, use the todense method."
            )
        return np.asarray(self.todense().cpu().numpy(), *args, **kwargs)

    def _repr_html_(self):
        """The Jupyter display: ``sparse_tpu``'s summary table (format, dtype,
        shape, nnz, density, read-only, size, storage ratio, compressed axes)."""
        from .._utils import html_table

        return html_table(self)

    # -- NEP-18: __array_function__ ------------------------------------------------
    def __array_function__(self, func, types, args, kwargs):
        import sparse_tpu_torch

        if func is np.shape:
            return args[0].shape
        if func is np.ndim:
            return args[0].ndim
        if func is np.size:
            return args[0].size
        sparse_func = getattr(sparse_tpu_torch, func.__name__, None)
        if sparse_func is None:
            sparse_func = getattr(type(self), func.__name__, None)
            if sparse_func is None:
                return NotImplemented
            if isinstance(sparse_func, property):
                return sparse_func.fget(args[0])
            return sparse_func(*args, **kwargs)
        try:
            return sparse_func(*args, **kwargs)
        except TypeError:
            return NotImplemented

    # -- NEP-13: __array_ufunc__ ---------------------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        from ..ops.elemwise import _FUNCTION_OPS, _UFUNC_OPS, elemwise

        out = kwargs.pop("out", None)
        if out is not None and not all(isinstance(x, type(self)) for x in out):
            return NotImplemented
        if out is not None:
            # dry run on 1-element NumPy stand-ins: NumPy's casting errors for
            # an incompatible ``out`` dtype, then the result pinned to it
            test_args = [np.empty((1,), dtype=numpy_dtype(a.dtype)) if hasattr(a, "dtype") else a for a in inputs]
            test_kwargs = kwargs.copy()
            if method == "reduce":
                test_kwargs["axis"] = None
            test_out = tuple(np.empty((1,), dtype=numpy_dtype(a.dtype)) for a in out)
            getattr(ufunc, method)(*test_args, out=test_out[0] if len(test_out) == 1 else test_out, **test_kwargs)
            kwargs["dtype"] = numpy_dtype(out[0].dtype)

        if ufunc is np.matmul and method == "__call__":
            from ..ops.dot import matmul

            if len(inputs) != 2:
                return NotImplemented
            result = matmul(*inputs)
        elif ufunc not in _UFUNC_OPS and ufunc not in _FUNCTION_OPS:
            return NotImplemented
        elif method == "__call__":
            result = elemwise(ufunc, *inputs, **kwargs)
        elif method == "outer":
            # a.outer(b) == f(a[..., None, ...], b[None, ...])
            if len(inputs) != 2:
                return NotImplemented
            a, b = inputs
            result = elemwise(ufunc, _expand(a, _ndim(b), trailing=True), _expand(b, _ndim(a), trailing=False), **kwargs)
        elif method == "reduce":
            (arr,) = inputs
            if not isinstance(arr, SparseArray):
                return NotImplemented
            result = arr.reduce(ufunc, **kwargs)
        else:
            return NotImplemented

        if out is not None:
            (out,) = out
            if out.shape != result.shape:
                raise ValueError(f"non-broadcastable output operand with shape {out.shape} doesn't match result shape")
            out._make_shallow_copy_of(result)
            return out
        return result

    # -- scalar conversion ---------------------------------------------------------
    def _to_scalar(self, builtin):
        if self.size != 1 or self.shape != ():
            raise ValueError(f"{builtin.__name__} must be called on an array with one element.")
        return builtin(self.todense().reshape(-1)[0].item())

    def __bool__(self):
        return self._to_scalar(bool)

    def __float__(self):
        return self._to_scalar(float)

    def __int__(self):
        return self._to_scalar(int)

    def __index__(self):
        return self._to_scalar(int)

    # ``@`` runs the port's matmul (unported operand kinds raise
    # NotImplementedError, not NotImplemented)
    def __matmul__(self, other):
        from ..ops.dot import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from ..ops.dot import matmul

        return matmul(other, self)

    # -- the fill-value-aware reduction driver -------------------------------------
    def reduce(self, method, axis=(0,), keepdims=False, **kwargs):
        """Apply ``method`` (a NumPy ufunc) as a reduction over ``axis``.

        The result's fill value is ``method.reduce([fv] * k)`` over the k
        collapsed elements: representable only when ``method(fv, fv) == fv``
        or a closed-form "super ufunc" exists (add → multiply, multiply →
        power); otherwise ``ValueError``. A reduction over every axis gives a
        0-d COO whose fill value is the result."""
        from .coo import COO

        axis = normalize_axis(axis, self.ndim)
        zero_reduce_result = method.reduce([self.fill_value, self.fill_value], **kwargs)
        reduce_super_ufunc = _reduce_super_ufunc.get(method)
        if not equivalent(zero_reduce_result, self.fill_value) and reduce_super_ufunc is None:
            raise ValueError(f"Performing this reduction operation would produce a dense result: {method!s}")

        if axis is None:
            axis = tuple(range(self.ndim))
        if not isinstance(axis, tuple):
            axis = (axis,)

        out = self._reduce_calc(method, axis, keepdims, **kwargs)
        if len(out) == 1:
            res = out[0] if isinstance(out[0], SparseArray) else COO.from_numpy(np.asarray(out[0]), device=self.device)
            if keepdims:
                res = res.reshape((1,) * self.ndim)
            return res

        data, counts, axis, n_cols, arr_attrs = out
        result_fill_value = self.fill_value
        if reduce_super_ufunc is None:
            missing = counts != n_cols
            corrected = _apply(method, data, _fill_tensor(self.fill_value, data.device), kwargs)
            data = select(missing, corrected.to(data.dtype), data)
        elif method is np.add and np.all(self.fill_value == 0):
            # the missing positions add fv * k = ±0.0, an add identity
            result_fill_value = reduce_super_ufunc(self.fill_value, n_cols)
        else:
            fill_t = _fill_tensor(self.fill_value, data.device)
            missing = _apply(reduce_super_ufunc, fill_t, n_cols - counts, {})
            data = _apply(method, data, missing, {}).to(data.dtype)
            result_fill_value = reduce_super_ufunc(self.fill_value, n_cols)

        result_fill_value = np.asarray(result_fill_value, dtype=numpy_dtype(data.dtype))[()]
        out = self._reduce_return(data, arr_attrs, result_fill_value)

        if keepdims:
            shape = list(self.shape)
            for ax in axis:
                shape[ax] = 1
            out = out.reshape(tuple(shape))
        if out.ndim == 0:
            return COO.from_numpy(out.todense().cpu().numpy(), device=self.device)
        return out

    # -- statistics ------------------------------------------------------------------
    def sum(self, axis=None, keepdims=False, dtype=None, out=None):
        assert out is None
        return np.add.reduce(self, out=out, axis=axis, keepdims=keepdims, dtype=dtype)

    def max(self, axis=None, keepdims=False, out=None):
        assert out is None
        return np.maximum.reduce(self, out=out, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False, out=None):
        assert out is None
        return np.logical_or.reduce(self, out=out, axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False, out=None):
        assert out is None
        return np.logical_and.reduce(self, out=out, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, out=None):
        assert out is None
        return np.minimum.reduce(self, out=out, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, dtype=None, out=None):
        assert out is None
        return np.multiply.reduce(self, out=out, axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None, out=None):
        if axis is None:
            axis = tuple(range(self.ndim))
        elif not isinstance(axis, tuple):
            axis = (axis,)
        den = 1
        for ax in axis:
            den *= self.shape[ax]
        np_dt = numpy_dtype(self.dtype)
        if dtype is None:
            if np.issubdtype(np_dt, np.integer) or np.issubdtype(np_dt, np.bool_):
                dtype = inter_dtype = np.dtype("f8")
            else:
                dtype = np_dt
                inter_dtype = np.dtype("f4") if issubclass(dtype.type, np.float16) else dtype
        else:
            inter_dtype = dtype

        num = self.sum(axis=axis, keepdims=keepdims, dtype=inter_dtype)
        if num.ndim:
            res = np.true_divide(num, den, casting="unsafe")
            return res.astype(dtype) if numpy_dtype(res.dtype) != dtype else res
        return np.divide(num, den, dtype=dtype, out=out)

    def var(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
        from ..ops.elemwise import elemwise

        axis = normalize_axis(axis, self.ndim)
        if axis is None:
            axis = tuple(range(self.ndim))
        if not isinstance(axis, tuple):
            axis = (axis,)
        rcount = 1
        for ax in axis:
            rcount *= self.shape[ax]
        if ddof >= rcount:
            warnings.warn("Degrees of freedom <= 0 for slice", RuntimeWarning, stacklevel=1)

        np_dt = numpy_dtype(self.dtype)
        out_dtype = None
        if dtype is None and (np.issubdtype(np_dt, np.integer) or np.issubdtype(np_dt, np.bool_)):
            dtype = np.dtype("f8")
        elif dtype is None and np.issubdtype(np_dt, np.floating) and np_dt.itemsize < 8:
            # sub-f8 floats accumulate in f8, cast back at the end
            dtype = np.dtype("f8")
            out_dtype = np_dt

        arrmean = self.sum(axis, dtype=dtype, keepdims=True)
        arrmean = elemwise(np.divide, arrmean, rcount, dtype=numpy_dtype(arrmean.dtype))
        x = self.astype(dtype) - arrmean if out_dtype is not None else self - arrmean
        if np.issubdtype(np_dt, np.complexfloating):
            x = x.real * x.real + x.imag * x.imag
        else:
            x = elemwise(np.multiply, x, x, dtype=numpy_dtype(x.dtype))
        ret = x.sum(axis=axis, dtype=dtype, out=out, keepdims=keepdims)
        rcount = max([rcount - ddof, 0])
        ret = elemwise(np.divide, ret, rcount, dtype=numpy_dtype(ret.dtype), casting="unsafe")
        if out_dtype is not None:
            ret = ret.astype(out_dtype)
        return ret

    def std(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
        ret = self.var(axis=axis, dtype=dtype, out=out, ddof=ddof, keepdims=keepdims)
        return np.sqrt(ret)

    # -- elementwise methods ---------------------------------------------------------
    def round(self, decimals=0, out=None):
        if out is not None and not isinstance(out, tuple):
            out = (out,)
        return self.__array_ufunc__(np.round, "__call__", self, decimals=decimals, out=out)

    round_ = round

    def clip(self, min=None, max=None, out=None):  # noqa: A002
        if min is None and max is None:
            raise ValueError("One of max or min must be given.")
        if out is not None and not isinstance(out, tuple):
            out = (out,)
        return self.__array_ufunc__(np.clip, "__call__", self, a_min=min, a_max=max, out=out)

    def astype(self, dtype, casting="unsafe", copy=True):
        from ..ops.elemwise import elemwise

        if numpy_dtype(self.dtype) == numpy_dtype(dtype) and not copy:
            return self
        return elemwise(np.ndarray.astype, self, dtype=numpy_dtype(dtype), casting=casting, copy=copy)

    @property
    def real(self):
        from ..ops.elemwise import elemwise

        return elemwise(np.real, self)

    @property
    def imag(self):
        from ..ops.elemwise import elemwise

        return elemwise(np.imag, self)

    def conj(self):
        from ..ops.elemwise import elemwise

        return elemwise(np.conj, self)

    def isnan(self):
        from ..ops.elemwise import elemwise

        return elemwise(np.isnan, self)

    def isinf(self):
        from ..ops.elemwise import elemwise

        return elemwise(np.isinf, self)


def _ndim(x):
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


def _expand(x, k, trailing):
    """``x`` with ``k`` extent-1 axes added after (``trailing``) or before
    its own, for ``ufunc.outer``."""
    if not isinstance(x, (SparseArray, torch.Tensor)):
        x = np.asarray(x)
    shape = tuple(x.shape) + (1,) * k if trailing else (1,) * k + tuple(x.shape)
    return x.reshape(shape)


def _fill_tensor(fill_value, device):
    return torch.from_numpy(np.array(fill_value)).to(device)


def _apply(method, a, b, kwargs):
    """``method(a, b)`` on the device with NumPy's dtype rules; ``b`` may be
    an int64 tensor of counts."""
    from ..ops.elemwise import apply_ufunc

    return apply_ufunc(method, a, b, **{k: v for k, v in kwargs.items() if k == "dtype"})
