"""Shared helpers: dtype maps between NumPy and torch, bitwise fill-value
equivalence, axis normalization, index-dtype sizing, random arrays and the
test oracle.

Same semantics as ``sparse_tpu._utils`` (``equivalent``, ``zero_of_dtype``,
``normalize_axis``, ``can_store``, ``index_dtype_for``, ``get_out_dtype``,
``check_zero_fill_value``, ``check_fill_value``, ``convert_format``,
``random``, ``random_value_array``, ``is_canonical``, ``assert_nnz``,
``assert_eq``); ``equivalent`` works on torch tensors so that a prune runs on
the device the data lives on, ``uncompress_indptr`` expands a compressed
format's ``indptr`` there, and ``random`` draws on the host with NumPy as
``sparse_tpu.random`` does (the same array for the same seed) and copies to
the device once.
"""

from __future__ import annotations

import warnings
from collections.abc import Iterable
from numbers import Integral

import numpy as np
import torch

from . import _settings

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}

# same-width integer views for the bitwise float compare
_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}

# torch implements few ops for its unsigned types wider than 8 bits (no
# index_add_ or index_put on the CPU); their values are kept as they are and
# worked on through a view as the signed type of the same width, whose
# wrapping sums and products have the same bits
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def signed_view(t):
    """``t`` viewed as the signed integer type of its width when its dtype
    is uint16, uint32 or uint64 (same bits, modular arithmetic), else ``t``."""
    signed = _SIGNED.get(t.dtype)
    return t if signed is None else t.view(signed)


def as_int64(t):
    """``t``'s integer or bool values as int64, modulo 2**64: the unsigned
    types zero-extended (uint64 by its signed view, the same bits)."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    signed = _SIGNED.get(t.dtype)
    if signed is None:
        return t.to(torch.int64)
    return t.view(signed).to(torch.int64) & ((1 << (8 * t.element_size())) - 1)


def take(t, index):
    """``t[index]`` (index tensors, a tuple of them or a boolean mask); the
    unsigned types wider than 8 bits, which CUDA's indexing lacks, through
    their signed view (the same bits)."""
    signed = _SIGNED.get(t.dtype)
    return t[index] if signed is None else t.view(signed)[index].view(t.dtype)


# index dtypes torch cannot index or add with (a uint8 index is even read as
# a mask), widened where they are used: the stored coordinates keep them
_WIDE_INDEX = {
    torch.int8: torch.int32,
    torch.int16: torch.int32,
    torch.uint8: torch.int32,
    torch.uint16: torch.int32,
    torch.uint32: torch.int64,
    torch.uint64: torch.int64,
}


def wide_index(t):
    """The index tensor ``t`` in a dtype torch indexes and computes with:
    int8/int16/uint8/uint16 as int32, uint32/uint64 as int64, int32 and
    int64 as they are (no copy)."""
    wide = _WIDE_INDEX.get(t.dtype)
    return t if wide is None else t.to(wide)


def coords_dtype(given, max_extent):
    """The index dtype a COO stores for coordinates given in ``given``
    (NumPy or torch) and an array whose largest extent is ``max_extent``:
    int32 or int64 (``index_dtype_for``), unless ``given`` is a narrower
    integer type, which is kept with the least upcast the extent needs
    (uint8 → uint16), as ``sparse_tpu``'s COO keeps it."""
    out = index_dtype_for(max_extent)
    given = numpy_dtype(given)
    if np.issubdtype(given, np.integer) and given.itemsize < out.itemsize:
        small = get_out_dtype(given, max_extent)
        if small.itemsize < out.itemsize:
            out = small
    return out


def select(cond, a, b):
    """``torch.where(cond, a, b)`` for tensors of one dtype, the wide
    unsigned types through their signed view."""
    signed = _SIGNED.get(a.dtype)
    if signed is None:
        return torch.where(cond, a, b)
    return torch.where(cond, a.view(signed), b.view(signed)).view(a.dtype)


def full(shape, value, dtype, device):
    """``torch.full`` for every dtype: a wide unsigned value is written
    through the signed view of its bits."""
    signed = _SIGNED.get(dtype)
    if signed is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    bits = np.asarray(value, dtype=numpy_dtype(dtype)).view(numpy_dtype(signed))[()]
    return torch.full(shape, int(bits), dtype=signed, device=device).view(dtype)


def torch_dtype(dtype):
    """The torch dtype for a NumPy or torch dtype (TypeError if torch has none)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    try:
        return _NP_TO_TORCH[dt]
    except KeyError:
        raise TypeError(f"dtype {dt} is not supported by sparse_tpu_torch") from None


def numpy_dtype(dtype):
    """The NumPy dtype for a torch or NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_TO_NP[dtype]
        except KeyError:
            raise TypeError(f"dtype {dtype} has no NumPy counterpart") from None
    return np.dtype(dtype)


def result_dtype(*dtypes):
    """NumPy promotion (``np.promote_types``) of torch/NumPy dtypes, as a torch dtype."""
    out = numpy_dtype(dtypes[0])
    for dt in dtypes[1:]:
        out = np.promote_types(out, numpy_dtype(dt))
    return torch_dtype(out)


def sum_dtype(dtype):
    """The dtype ``np.sum`` (and ``jnp.sum`` under x64) sums ``dtype`` in,
    as a torch dtype: bool and the signed integers int64, the unsigned
    uint64, the rest themselves."""
    dtype = torch_dtype(dtype)
    if _is_inexact(dtype):
        return dtype
    return torch.uint64 if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64) else torch.int64


def _is_inexact(dtype):
    return dtype.is_floating_point or dtype.is_complex


def equivalent(x, y, /, loose=False):
    """Element-wise equivalence with *bitwise* float semantics, on tensors.

    For float/complex dtypes two values are equivalent iff their bit patterns
    match — so ``NaN ≡ NaN`` and ``0.0 ≢ -0.0``. With ``loose=True`` values
    compare by ``==`` but NaNs still match (``NaN ≡ NaN``, ``0.0 ≡ -0.0``).
    Non-float dtypes use ``==``. ``y`` may be a scalar; it is placed on ``x``'s
    device."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    y = y.to(x.device) if isinstance(y, torch.Tensor) else torch.from_numpy(np.array(y)).to(x.device)
    dt = result_dtype(x.dtype, y.dtype)
    x = x.to(dt)
    y = y.to(dt)
    if not _is_inexact(dt):
        return signed_view(x) == signed_view(y)
    if dt.is_complex:
        xr, yr = torch.view_as_real(x.resolve_conj()), torch.view_as_real(y.resolve_conj())
        return equivalent(xr[..., 0], yr[..., 0], loose=loose) & equivalent(xr[..., 1], yr[..., 1], loose=loose)
    if loose:
        return (x == y) | (torch.isnan(x) & torch.isnan(y))
    bits = _BITS[dt]
    return x.contiguous().view(bits) == y.contiguous().view(bits)


def zero_of_dtype(dtype):
    """A NumPy zero scalar of ``dtype`` (torch or NumPy)."""
    return np.zeros((), dtype=numpy_dtype(dtype))[()]


def normalize_axis(axis, ndim):
    """Normalize negative/iterable axes against ``ndim``; raise on overflow."""
    if axis is None:
        return None
    if isinstance(axis, Integral):
        axis = int(axis)
        if axis < 0:
            axis += ndim
        if axis < 0 or axis >= ndim:
            raise ValueError(f"Invalid axis index {axis} for ndim={ndim}")
        return axis
    if isinstance(axis, Iterable):
        if not all(isinstance(a, Integral) for a in axis):
            raise ValueError(f"axis {axis} not understood")
        return tuple(normalize_axis(a, ndim) for a in axis)
    raise ValueError(f"axis {axis} not understood")


def can_store(dtype, nelem):
    """Whether ``dtype`` can represent the scalar ``nelem`` exactly (handles
    negatives and overflow)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            warnings.filterwarnings("error", "out-of-bound", DeprecationWarning)
            return bool(np.array(nelem, dtype=numpy_dtype(dtype)) == np.array(nelem))
    except (ValueError, OverflowError):
        return False


def index_dtype_for(max_value):
    """Smallest of int32/int64 that can hold ``max_value`` (NumPy dtype)."""
    if _settings.DEFAULT_INDEX_DTYPE == "int64":
        return np.dtype(np.int64)
    return np.dtype(np.int32 if max_value <= np.iinfo(np.int32).max else np.int64)


def get_out_dtype(arr_dtype, max_value):
    """Index dtype for outputs: keep ``arr_dtype`` when it can store the
    value, else the minimal upcast (uint8 → uint16, ...)."""
    if can_store(arr_dtype, max_value):
        return numpy_dtype(arr_dtype)
    return np.dtype(np.min_scalar_type(int(max_value)))


def check_zero_fill_value(*args, func_name=""):
    """Raise ``ValueError`` unless every sparse argument has a zero fill value
    (``-0.0`` counts as zero). The test is memoized per instance, keyed on the
    fill value object, so reassigning ``fill_value`` re-runs it."""
    for i, arr in enumerate(args):
        if hasattr(arr, "fill_value"):
            if getattr(arr, "size", 1) == 0:
                continue
            fv = arr.fill_value
            memo = getattr(arr, "_fv_is_zero_memo", None)
            if memo is not None and memo[0] is fv:
                ok = memo[1]
            else:
                # loose equivalence with zero: NaN never matches, -0.0 does
                ok = bool(np.asarray(fv) == 0)
                try:
                    arr._fv_is_zero_memo = (fv, ok)
                except AttributeError:
                    pass
            if not ok:
                raise ValueError(
                    f"This operation requires zero fill values, but argument {i:d} had a fill value of {fv!s}."
                )


def check_fill_value(arr, accept_fv, func_name=""):
    """Raise ``ValueError`` unless ``arr.fill_value`` is loosely equivalent
    to one of ``accept_fv`` (a scalar or a sequence)."""
    accept = accept_fv if isinstance(accept_fv, Iterable) and not isinstance(accept_fv, str) else [accept_fv]
    fv = torch.as_tensor(np.asarray(arr.fill_value))
    if not any(bool(equivalent(fv, a, loose=True).all()) for a in accept):
        raise ValueError(f"fill_value={arr.fill_value!r} but should be in {accept}.")


def convert_format(format):
    """A format spec (a class of the package or a string) as its lowercase
    string name."""
    from .core.base import SparseArray

    if isinstance(format, type):
        if not issubclass(format, SparseArray):
            raise ValueError(f"Invalid format: {format}")
        return format.__name__.lower()
    if isinstance(format, str):
        return format
    raise ValueError(f"Invalid format: {format}")


def not_ported(what):
    """The error every part of ``sparse_tpu`` that the port lacks raises."""
    return NotImplementedError(f"{what} is not yet ported to sparse_tpu_torch")


def html_table(arr):
    """The HTML summary table of ``_repr_html_``, cell for cell
    ``sparse_tpu``'s; "Data Type" holds the array's torch dtype."""
    table = ["<table><tbody>"]
    headings = ["Format", "Data Type", "Shape", "nnz", "Density", "Read-only"]
    info = [
        type(arr).__name__.lower(),
        str(arr.dtype),
        str(arr.shape),
        str(arr.nnz),
        str(arr.density),
        str(not hasattr(arr, "__setitem__")),
    ]
    if hasattr(arr, "nbytes"):
        headings.append("Size")
        info.append(human_readable_size(arr.nbytes))
        headings.append("Storage ratio")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            ratio = float(np.float64(arr.nbytes) / np.float64(arr.size * arr.dtype.itemsize))
        info.append(f"{ratio:.2f}")
    if type(arr).__name__ == "GCXS":
        headings.append("Compressed Axes")
        info.append(str(arr.compressed_axes))
    for h, i in zip(headings, info):
        table.append(f'<tr><th style="text-align: left">{h}</th><td style="text-align: left">{i}</td></tr>')
    table.append("</tbody></table>")
    return "".join(table)


def human_readable_size(size):
    """``size`` bytes as ``sparse_tpu`` prints them: bytes below 1 KiB, then
    one decimal and K, M, G or T."""
    for limit, suffix in [(2**10, ""), (2**20, "K"), (2**30, "M"), (2**40, "G")]:
        if size < limit:
            if not suffix:
                return str(size)
            return f"{size / (limit / 2**10):.1f}{suffix}"
    return f"{size / 2**40:.1f}T"


def uncompress_indptr(indptr, nnz):
    """The int64 row of every stored entry of a compressed format, on
    ``indptr``'s device: row ``r`` repeated ``indptr[r + 1] - indptr[r]``
    times. ``nnz`` (``indptr[-1]``, known to the caller) sizes the output,
    so nothing is read back from the device."""
    indptr = indptr.long()
    counts = indptr[1:] - indptr[:-1]
    rows = torch.arange(counts.numel(), dtype=torch.int64, device=indptr.device)
    return torch.repeat_interleave(rows, counts, output_size=nnz)


def check_consistent_fill_value(arrays):
    """Raise ``ValueError`` unless every array has the first one's fill value
    (bitwise)."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("At least one array required.")
    fv = arrays[0].fill_value
    for i, arr in enumerate(arrays):
        if not bool(equivalent(torch.as_tensor(np.asarray(arr.fill_value)), fv).all()):
            raise ValueError(
                f"This operation requires consistent fill-values, but argument {i} has fill value {arr.fill_value!s}"
                f" while argument 0 has fill value {fv!s}."
            )


def isscalar(x):
    """A 0-d value that is no sparse array."""
    return np.ndim(x) == 0 and not hasattr(x, "fill_value")


# ---------------------------------------------------------------------------
# random arrays and the test oracle
# ---------------------------------------------------------------------------


def random_value_array(value, fraction):
    """A data generator for ``random(data_rvs=...)``: arrays of which a
    ``fraction`` of the entries equal ``value`` (NaN-laden data, say)."""

    def replace_values(n):
        i = int(n * fraction)
        ar = np.empty((n,), dtype=np.float64)
        ar[:i] = value
        ar[i:] = np.random.rand(n - i)
        return ar

    return replace_values


def random(
    shape,
    density=None,
    nnz=None,
    random_state=None,
    data_rvs=None,
    format="coo",
    fill_value=None,
    idx_dtype=None,
    device=None,
    **kwargs,
):
    """A random sparse array of the given density or nnz, built on ``device``
    (the GPU by default). The positions and values are drawn on the host with
    NumPy exactly as ``sparse_tpu.random`` draws them, so an integer seed
    gives its array bit for bit, then copied to the device once.

    Positions: ``nnz`` distinct linear indices uniform over the array (a
    sorted ``rng.choice`` without replacement, or draws with replacement
    deduplicated and topped up over a space past 2^24 elements); values
    ``rng.random(nnz)`` unless ``data_rvs`` gives them."""
    from .core.coo import COO

    if not isinstance(shape, Iterable):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    elements = int(np.prod(shape, dtype=np.float64)) if len(shape) else 1
    if density is not None and nnz is not None:
        raise ValueError("'density' and 'nnz' are mutually exclusive")
    if density is None:
        density = 0.01
    if not (0 <= density <= 1):
        raise ValueError(f"density {density} is not in the unit interval")
    if nnz is None:
        nnz = int(round(elements * density))
    if not (0 <= nnz <= elements):
        raise ValueError(f"cannot generate {nnz} samples from {elements} elements")

    if random_state is None:
        rng = np.random.default_rng()
    elif isinstance(random_state, Integral):
        rng = np.random.default_rng(random_state)
    elif isinstance(random_state, np.random.RandomState | np.random.Generator):
        rng = random_state
    else:
        raise ValueError("random_state must be None, an int, RandomState, or Generator")

    ind = _sample_without_replacement(rng, elements, nnz)
    data = rng.random(nnz) if data_rvs is None else data_rvs(nnz)
    if len(shape):
        coords = np.stack(np.unravel_index(ind, shape), axis=0)
    else:
        coords = np.empty((0, nnz), dtype=np.intp)
    ar = COO(
        coords,
        data,
        shape=shape,
        fill_value=fill_value,
        has_duplicates=False,
        sorted=True,
        idx_dtype=idx_dtype,
        device=device,
    )
    return ar.asformat(format, **kwargs)


def _sample_without_replacement(rng, n, k):
    """``k`` distinct sorted integers uniform over ``[0, n)`` (the draws of
    ``sparse_tpu._utils._sample_without_replacement``)."""
    if k == 0:
        return np.empty(0, dtype=np.int64)
    if k == n:
        return np.arange(n, dtype=np.int64)
    if n <= 1 << 24 or k > n // 2:
        if k > n // 2:
            # over half: sample the complement
            comp = _sample_without_replacement(rng, n, n - k)
            mask = np.ones(n, dtype=bool)
            mask[comp] = False
            return np.flatnonzero(mask).astype(np.int64)
        return np.sort(rng.choice(n, size=k, replace=False).astype(np.int64))
    # a sparse sample of a huge space: draw with replacement, dedup, top up
    out = np.empty(0, dtype=np.int64)
    need = k
    while need > 0:
        draw = rng.integers(0, n, size=int(need * 1.1) + 16, dtype=np.int64)
        out = np.unique(np.concatenate([out, draw]))
        need = k - out.size
    if out.size > k:
        sel = rng.choice(out.size, size=k, replace=False)
        out = np.sort(out[sel])
    return out


def is_canonical(x):
    """True iff a COO is sorted, has no duplicates and stores no fill value."""
    from .core.coo import COO

    if not isinstance(x, COO):
        return True
    lin = x.linear_loc()
    return bool((lin[1:] > lin[:-1]).all()) and not bool(equivalent(x.data, x.fill_value).any())


def _host(v):
    """A dense NumPy array of a sparse array, tensor, scipy matrix or array."""
    from .core.base import SparseArray

    if isinstance(v, SparseArray):
        v = v.todense()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "toarray"):
        return np.asarray(v.toarray())
    return np.asarray(v)


def assert_nnz(s, x):
    fill_value = np.asarray(s.fill_value)
    assert np.sum(~equivalent(torch.as_tensor(np.asarray(x)), fill_value).numpy()) == s.nnz


def assert_eq(x, y, check_nnz=True, compare_dtype=True, **kwargs):
    """Oracle equality of any mix of sparse arrays, tensors, NumPy arrays and
    scipy matrices: shape, dtype, canonical form and nnz of COO operands,
    fill values of two sparse operands, and the dense forms on the host
    (``allclose(equal_nan=True)`` for floats, exact otherwise)."""
    from .core.base import SparseArray
    from .core.coo import COO

    assert tuple(x.shape) == tuple(y.shape), f"shape mismatch: {x.shape} vs {y.shape}"
    if compare_dtype:
        assert numpy_dtype(x.dtype) == numpy_dtype(y.dtype), f"dtype mismatch: {x.dtype} vs {y.dtype}"
    if isinstance(x, COO):
        assert is_canonical(x), "left operand not canonical"
    if isinstance(y, COO):
        assert is_canonical(y), "right operand not canonical"
    if isinstance(x, SparseArray) and isinstance(y, SparseArray):
        fx, fy = torch.as_tensor(np.asarray(x.fill_value)), np.asarray(y.fill_value)
        assert bool(equivalent(fx, fy).all()), f"fill_value mismatch: {x.fill_value} vs {y.fill_value}"

    xx, yy = _host(x), _host(y)
    if check_nnz:
        if isinstance(x, SparseArray):
            assert_nnz(x, xx)
        if isinstance(y, SparseArray):
            assert_nnz(y, yy)
    if np.issubdtype(xx.dtype, np.floating) or np.issubdtype(xx.dtype, np.complexfloating):
        # float32-precision components get accumulation-order slack
        if "rtol" not in kwargs and np.finfo(xx.dtype).eps >= np.finfo(np.float32).eps:
            kwargs["rtol"] = 1e-5
        np.testing.assert_allclose(xx, yy, equal_nan=True, **kwargs)
    else:
        np.testing.assert_array_equal(xx, yy)
