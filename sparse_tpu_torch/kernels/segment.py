"""Segment reductions, on torch tensors.

``segment_reduce`` and ``segment_sum_onehot_mm`` are the traceable forms of
``sparse_tpu.kernels.segment``: static output sizes and no read back to the
host. On the TPU the second is a one-hot matrix product on the MXU; here it
is the same row segment sum (``block_rows`` is accepted and changes
nothing).

``reduce_all`` and ``reduce_runs`` are the eager reductions behind
``SparseArray.reduce``: one NumPy ufunc (``np.add``, ``np.multiply``,
``np.maximum``, ``np.minimum``, ``np.fmax``, ``np.fmin``,
``np.logical_or``, ``np.logical_and``) over all of ``data`` or over each
run of consecutive entries, in NumPy's result dtype
(``method.reduce``'s: small integers sum to int64/uint64). A float result
has the same bits on every call: floats reduce through
``torch.segment_reduce`` (each run in order, sums started from -0.0 so that
the sign of a zero survives, float16 in float32), integers exactly (sums by
an int64 ``cumsum``, the rest by ``scatter_reduce``, whose order cannot
change an integer result).
"""

from __future__ import annotations

import numpy as np
import torch

from .._utils import numpy_dtype, signed_view, torch_dtype

_I64 = torch.int64
_INT64_MIN = -(1 << 63)

_JAX_OPS = ("sum", "prod", "max", "min")


def _unsupported(method, dtype):
    return NotImplementedError(
        f"{method.__name__}.reduce of {numpy_dtype(dtype)} has no exact torch route in sparse_tpu_torch"
    )


def _identity(op, dtype):
    """The value of an empty segment in ``jax.ops.segment_*``."""
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _offsets(segment_ids, num_segments):
    bounds = torch.arange(num_segments + 1, dtype=segment_ids.dtype, device=segment_ids.device)
    return torch.searchsorted(segment_ids, bounds)


def segment_reduce(data, segment_ids, num_segments, op="sum", indices_are_sorted=True):
    """Reduce ``data`` by ``segment_ids`` into ``num_segments`` slots (ids
    outside ``[0, num_segments)`` are dropped; an empty slot holds the op's
    identity, as in ``jax.ops.segment_*``). Sorted ids on floats run one
    ``torch.segment_reduce`` over the runs' offsets (the same bits every
    call); unsorted ids or integers scatter (exact for integers)."""
    if op not in _JAX_OPS:
        raise ValueError(f"op must be one of {_JAX_OPS}, not {op!r}")
    ids = segment_ids.to(_I64)
    if indices_are_sorted and (data.dtype.is_floating_point or data.dtype.is_complex):
        return _segment_floats(data, _offsets(ids, num_segments), op, initial=_identity(op, data.real.dtype) if not data.dtype.is_complex else 0)
    out = torch.full((num_segments, *data.shape[1:]), _identity(op, data.dtype), dtype=data.dtype, device=data.device)
    valid = (ids >= 0) & (ids < num_segments)
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    src = data
    if op == "sum":
        src = torch.where(valid.reshape(-1, *[1] * (data.ndim - 1)), data, torch.zeros_like(data))
        signed_view(out).index_add_(0, ids, signed_view(src))
        return out
    if op == "prod":
        src = torch.where(valid.reshape(-1, *[1] * (data.ndim - 1)), data, torch.ones_like(data))
    else:
        src = torch.where(valid.reshape(-1, *[1] * (data.ndim - 1)), data, torch.full_like(data, _identity(op, data.dtype)))
    idx = ids.reshape(-1, *[1] * (data.ndim - 1)).expand_as(src)
    return out.scatter_reduce_(0, idx, src, {"prod": "prod", "max": "amax", "min": "amin"}[op])


def _segment_floats(data, offsets, op, initial=None):
    """``torch.segment_reduce`` over ``offsets`` of a float or complex
    ``data`` (complex as its two float parts; float16 in float32)."""
    if data.dtype.is_complex:
        if op != "sum":
            raise NotImplementedError(f"segment {op} of complex values has no exact torch route in sparse_tpu_torch")
        parts = _segment_floats(torch.view_as_real(data), offsets, op, initial)
        return torch.view_as_complex(parts.contiguous())
    if data.dtype in (torch.float16, torch.bfloat16):
        return _segment_floats(data.float(), offsets, op, initial).to(data.dtype)
    return torch.segment_reduce(data, op, offsets=offsets, initial=initial, unsafe=True)


def segment_sum_onehot_mm(values, segment_ids, *, num_segments, block_rows=512):
    """Segment-sum of ``values (nnz, N)`` by sorted ``segment_ids`` into
    ``(num_segments, N)``: on the GPU a row segment sum, not the TPU's one-hot
    contraction, so ``block_rows`` changes nothing. Ids outside
    ``[0, num_segments)`` are dropped, as the one-hot rows drop them."""
    del block_rows
    return segment_reduce(values, segment_ids, num_segments, op="sum", indices_are_sorted=True)


# ---------------------------------------------------------------------------
# eager reductions of ``SparseArray.reduce``
# ---------------------------------------------------------------------------


def result_dtype(method, dtype, kw_dtype=None):
    """NumPy's dtype of ``method.reduce`` over ``dtype`` (with ``dtype=``)."""
    return method.reduce(np.ones(1, dtype=numpy_dtype(dtype)), dtype=kw_dtype).dtype


def _to(data, dtype):
    if data.dtype.is_complex and not dtype.is_complex:
        data = data.real
    return data.to(dtype)


def _ordered(x):
    if x.dtype in (torch.uint16, torch.uint32):
        return x.to(_I64)
    if x.dtype == torch.uint64:
        return x.view(_I64) ^ _INT64_MIN
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _unordered(y, dtype):
    if dtype == torch.uint64:
        return (y ^ _INT64_MIN).view(torch.uint64)
    return y.to(dtype)


def _truth(x):
    if x.dtype == torch.bool:
        return x
    return x != 0 if x.dtype.is_complex else ~(signed_view(x) == 0)


def _prepare(method, data, kw_dtype):
    """``(x, out dtype)``: ``data`` cast to NumPy's reduce dtype (its truth
    values for the logical reductions)."""
    out = torch_dtype(result_dtype(method, data.dtype, kw_dtype))
    if method in (np.logical_or, np.logical_and):
        return _truth(data), out
    return _to(data, out), out


def reduce_all(method, data, kw_dtype=None):
    """``method.reduce(data)`` as a 0-d tensor on ``data``'s device."""
    x, out = _prepare(method, data, kw_dtype)
    if method in (np.add, np.multiply):
        if out.is_floating_point or out.is_complex:
            fn = torch.sum if method is np.add else torch.prod
            return fn(x.float()).half() if out == torch.float16 else fn(x)
        # integers exactly: modular int64 arithmetic, then NumPy's width
        s = signed_view(x) if out == torch.uint64 else x.to(_I64)
        r = s.sum() if method is np.add else s.prod()
        return r.view(out) if out == torch.uint64 else r.to(out)
    if method in (np.logical_or, np.logical_and):
        return x.any() if method is np.logical_or else x.all()
    if method in (np.maximum, np.minimum, np.fmax, np.fmin):
        if out.is_complex:
            raise _unsupported(method, out)
        big = method in (np.maximum, np.fmax)
        if out.is_floating_point:
            if method in (np.fmax, np.fmin):
                nan = torch.isnan(x)
                y = torch.where(nan, torch.full_like(x, float("-inf") if big else float("inf")), x)
                r = y.amax() if big else y.amin()
                return torch.where(nan.all(), torch.full_like(r, float("nan")), r)
            return x.amax() if big else x.amin()
        y = _ordered(x)
        return _unordered(y.amax() if big else y.amin(), out)
    raise NotImplementedError(f"{method.__name__}.reduce is not ported to sparse_tpu_torch")


def reduce_runs(method, data, offsets, kw_dtype=None):
    """``method.reduceat`` of ``data`` at the starts of consecutive,
    non-empty runs: run ``i`` is ``data[offsets[i]:offsets[i + 1]]``. One
    value per run, in NumPy's reduce dtype."""
    x, out = _prepare(method, data, kw_dtype)
    n_runs = offsets.numel() - 1
    if method is np.add and (out.is_floating_point or out.is_complex):
        return _segment_floats(x, offsets, "sum", initial=-0.0)
    if method is np.multiply and (out.is_floating_point or out.is_complex):
        if out.is_complex:
            raise _unsupported(method, out)
        return _segment_floats(x, offsets, "prod")
    if method is np.add:
        # exact integer sums: differences of an int64 cumsum (modular)
        s = signed_view(x).to(_I64) if out != torch.uint64 else signed_view(x)
        cs = torch.zeros(s.numel() + 1, dtype=_I64, device=s.device)
        torch.cumsum(s, 0, out=cs[1:])
        sums = cs[offsets[1:]] - cs[offsets[:-1]]
        return sums.view(out) if out == torch.uint64 else sums.to(out)
    if method in (np.maximum, np.minimum, np.fmax, np.fmin) and out.is_floating_point:
        big = method in (np.maximum, np.fmax)
        if method in (np.fmax, np.fmin):
            nan = torch.isnan(x)
            y = torch.where(nan, torch.full_like(x, float("-inf") if big else float("inf")), x)
            r = _segment_floats(y, offsets, "max" if big else "min")
            valid = torch.zeros(x.numel() + 1, dtype=_I64, device=x.device)
            torch.cumsum((~nan).to(_I64), 0, out=valid[1:])
            none = (valid[offsets[1:]] - valid[offsets[:-1]]) == 0
            return torch.where(none, torch.full_like(r, float("nan")), r)
        return _segment_floats(x, offsets, "max" if big else "min")
    if method in (np.maximum, np.minimum, np.fmax, np.fmin, np.logical_or, np.logical_and, np.multiply):
        if out.is_complex:
            raise _unsupported(method, out)
        counts = offsets[1:] - offsets[:-1]
        run = torch.repeat_interleave(torch.arange(n_runs, device=x.device), counts, output_size=x.numel())
        if method is np.multiply:
            y = signed_view(x) if out == torch.uint64 else x.to(_I64)
            res = torch.ones(n_runs, dtype=_I64, device=x.device).scatter_reduce_(0, run, y, "prod")
            return res.view(out) if out == torch.uint64 else res.to(out)
        big = method in (np.maximum, np.fmax, np.logical_or)
        y = _ordered(x)
        init = torch.iinfo(y.dtype).min if big else torch.iinfo(y.dtype).max
        res = torch.full((n_runs,), init, dtype=y.dtype, device=x.device)
        res.scatter_reduce_(0, run, y, "amax" if big else "amin")
        return res.to(torch.bool) if out == torch.bool else _unordered(res, out)
    raise NotImplementedError(f"{method.__name__}.reduce is not ported to sparse_tpu_torch")
