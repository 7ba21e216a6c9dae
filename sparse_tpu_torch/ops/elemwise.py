"""Element-wise ops with N-ary broadcasting and the fill-value algebra, on
torch tensors: ``elemwise`` and ``broadcast_to``, with the semantics of
``sparse_tpu.ops.elemwise``.

The algorithm is the reference's **union + gather**, run with torch ops on
the operands' device:

1. expand each sparse operand's linear coordinates through broadcasting into
   the result's index space (``_expand_linear``),
2. take their sorted union (``torch.cat``, a sort, run starts),
3. evaluate every operand at each union coordinate: its stored value when
   present (``torch.searchsorted`` on its own sorted linear coordinates), else
   its fill value; dense operands are gathered directly,
4. apply the op once over the whole union and prune the entries bitwise
   equal to the result's fill value.

Operands that share one coordinate pattern skip the union; two to four
same-shape operands take one packed sort of their owner-tagged keys. Two
same-shape CPU operands of float32/float64 data with
``native.eager.NATIVE_MIN_NNZ`` entries or more between them take the host
library's single-pass joins instead, as ``sparse_tpu``'s host route does:
``a + b``, ``a - b`` and ``a * b`` of +0.0 fills evaluated and pruned in the
join (``fused_join_2d``/``fused_join``), other operations on the union of
``union_join_values`` (``union_join`` for two float dtypes). The
union's size and the pruned size are the two reads back to the host.

**The op table.** The vocabulary is NumPy's: ``elemwise(np.add, a, b)``,
``np.add(a, b)`` and ``a + b`` all reach the table entry for ``np.add``,
a torch function. The result's fill value and dtype are computed as the
reference computes them, by NumPy on the fill values (0-d host scalars, so
NumPy's errors, warnings and NEP 50 weak-scalar rules hold unchanged). The
operands are cast to the input dtypes of ``ufunc.resolve_dtypes`` before the
torch op runs, because torch promotes otherwise (int32 > float32 compares in
float64; float32 + 2 stays float32). A NumPy function that is not in the
table raises ``NotImplementedError``; any other callable (a lambda, a torch
function) is called on torch tensors, for the fill values as for the union
values, and its result dtype is torch's.

Where torch lacks an op for a dtype the table computes it exactly another
way (unsigned types through a wider or a signed view, integer division
masked where NumPy gives 0) or raises ``NotImplementedError`` naming the op
and dtype: ``floor_divide`` and ``remainder`` of uint64. Nothing is computed
on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._utils import equivalent, numpy_dtype, select, signed_view, take, torch_dtype, wide_index
from .. import native
from ..core.base import SparseArray
from ..core.coo import COO
from ..native import eager as native_eager

__all__ = ["elemwise", "broadcast_to", "apply_ufunc", "op_for"]

_I64 = torch.int64
_WIDE_UNSIGNED = (torch.uint16, torch.uint32)
_INT64_MIN = -(1 << 63)

# float dtype -> (the integer dtype of its width, its sign bit, the CPU's
# default NaN), as integers of that dtype
_FLOAT_BITS = {
    torch.float16: (torch.int16, -(1 << 15), -(1 << 9)),
    torch.float32: (torch.int32, -(1 << 31), -(1 << 22)),
    torch.float64: (torch.int64, _INT64_MIN, -(1 << 51)),
}


# ---------------------------------------------------------------------------
# the op table: NumPy function -> torch implementation
# ---------------------------------------------------------------------------


def _unsupported(name, dtype):
    return NotImplementedError(f"{name} of {numpy_dtype(dtype)} has no exact torch route in sparse_tpu_torch")


def _is_float(x):
    return x.dtype.is_floating_point


def _ordered(x):
    """``x`` as a signed tensor with the same order (for comparisons): wide
    unsigned types widen to int64, uint64 flips its sign bit, bool becomes
    uint8."""
    if x.dtype in _WIDE_UNSIGNED:
        return x.to(_I64)
    if x.dtype == torch.uint64:
        return x.view(_I64) ^ _INT64_MIN
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _truth(x):
    """``x != 0`` as bool (NaN is true, as in NumPy)."""
    if x.dtype == torch.bool:
        return x
    return ~(signed_view(x) == 0) if not x.dtype.is_complex else (x != 0)


def _bits(op):
    """``op`` on integers through the same-width signed view (modular
    arithmetic gives the same bits), on other dtypes as it is."""

    def f(*xs):
        dt = xs[0].dtype
        if dt in (torch.uint16, torch.uint32, torch.uint64):
            return op(*(signed_view(x) for x in xs)).view(dt)
        return op(*xs)

    return f


def _partwise(op):
    """``op`` on complex values part by part (torch's complex ``add`` scales
    the second operand by a complex ``alpha``, which turns an infinite part's
    partner into NaN); on the rest through ``_bits``."""
    bits = _bits(op)

    def f(a, b):
        if a.dtype.is_complex:
            return torch.view_as_complex(op(torch.view_as_real(a), torch.view_as_real(b)).contiguous())
        return bits(a, b)

    return f


def _f16_up(fn):
    """Run ``fn`` on float16 operands in float32 and round once, as NumPy's
    half loops do."""

    def f(*xs):
        if xs[0].dtype == torch.float16:
            return fn(*(x.float() for x in xs)).half()
        return fn(*xs)

    return f


# -- comparisons ---------------------------------------------------------------


def _complex_cmp(a, b, kind):
    """NumPy's lexicographic complex order (``CLT``/``CLE``/``CGT``/``CGE``)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    ok = ~torch.isnan(ai) & ~torch.isnan(bi)
    if kind == "lt":
        return ((ar < br) & ok) | ((ar == br) & (ai < bi))
    if kind == "le":
        return ((ar < br) & ok) | ((ar == br) & (ai <= bi))
    if kind == "gt":
        return ((ar > br) & ok) | ((ar == br) & (ai > bi))
    return ((ar > br) & ok) | ((ar == br) & (ai >= bi))


def _cmp(kind):
    op = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge}[kind]

    def f(a, b):
        if a.dtype.is_complex:
            return _complex_cmp(a, b, kind)
        return op(_ordered(a), _ordered(b))

    return f


def _eq(a, b):
    return signed_view(a) == signed_view(b)


def _ne(a, b):
    return ~(signed_view(a) == signed_view(b))


# -- maximum / minimum ---------------------------------------------------------
# NumPy's loops settle a tie of +0.0 and -0.0 by dtype: the half loops keep the
# first operand, the float32/float64 loops the second. NaN: maximum/minimum
# propagate it, fmax/fmin skip it.


def _minmax(kind):
    def f(a, b):
        if a.dtype.is_complex:
            nan_a = torch.isnan(a.real) | torch.isnan(a.imag)
            nan_b = torch.isnan(b.real) | torch.isnan(b.imag)
            order = _complex_cmp(a, b, "ge" if kind in ("max", "fmax") else "le")
            a_wins = (order | nan_a) if kind in ("max", "min") else (order | nan_b)
            return torch.where(a_wins, a, b)
        if _is_float(a):
            if a.dtype == torch.float16:
                order = (a >= b) if kind in ("max", "fmax") else (a <= b)
            else:
                order = (a > b) if kind in ("max", "fmax") else (a < b)
            a_wins = order | (torch.isnan(a) if kind in ("max", "min") else torch.isnan(b))
            return torch.where(a_wins, a, b)
        oa, ob = _ordered(a), _ordered(b)
        return select(oa > ob if kind in ("max", "fmax") else oa < ob, a, b)

    return f


# -- division ------------------------------------------------------------------


def _int_div_parts(a, b, name):
    """Integer ``a``, ``b`` made safe for torch's division: wide unsigned
    widened to int64, zero divisors (NumPy gives 0) and ``MIN // -1`` masked.
    Returns ``(a, b_safe, zero, overflow)``."""
    if a.dtype == torch.uint64:
        raise _unsupported(name, a.dtype)
    if a.dtype in _WIDE_UNSIGNED:
        a, b = a.to(_I64), b.to(_I64)
    zero = b == 0
    if a.dtype.is_signed:
        ovf = (b == -1) & (a == torch.iinfo(a.dtype).min)
    else:
        ovf = torch.zeros_like(zero)
    return a, torch.where(zero | ovf, torch.ones_like(b), b), zero, ovf


def _np_divmod(a, b):
    """NumPy's ``npy_divmod`` for floats: ``(floor quotient, remainder)``,
    the remainder with the divisor's sign (a zero remainder too)."""
    mod = torch.fmod(a, b)
    zero_b = b == 0
    div = (a - mod) / b
    adj = (mod != 0) & ((b < 0) != (mod < 0))
    zero_mod = mod == 0
    mod = torch.where(adj, mod + b, mod)
    div = torch.where(adj, div - 1, div)
    mod = torch.where(zero_mod, torch.copysign(torch.zeros_like(b), b), mod)
    fl = torch.floor(div)
    fl = torch.where(div - fl > 0.5, fl + 1, fl)
    fl = torch.where(div == 0, torch.copysign(torch.zeros_like(a), a / b), fl)
    q = torch.where(zero_b, a / b, fl)
    mod = torch.where(zero_b, torch.fmod(a, b), mod)
    return q, mod


def _floor_divide(a, b):
    if _is_float(a):
        return _f16_up(lambda x, y: _np_divmod(x, y)[0])(a, b)
    dt = a.dtype
    a2, bs, zero, ovf = _int_div_parts(a, b, "floor_divide")
    q = torch.floor_divide(a2, bs)
    q = torch.where(zero, torch.zeros_like(q), q)
    q = torch.where(ovf, a2, q)
    return q.to(dt)


def _remainder(a, b):
    if _is_float(a):
        return _f16_up(lambda x, y: _np_divmod(x, y)[1])(a, b)
    dt = a.dtype
    a2, bs, zero, ovf = _int_div_parts(a, b, "remainder")
    r = torch.remainder(a2, bs)
    r = torch.where(zero | ovf, torch.zeros_like(r), r)
    return r.to(dt)


def _power(a, b):
    if a.dtype.is_complex:  # NumPy's z ** 0 is exactly 1
        return torch.where(b == 0, torch.ones_like(a), torch.pow(a, b))
    if a.dtype.is_floating_point:
        return torch.pow(a, b)
    if b.dtype.is_signed and bool((b < 0).any()):
        raise ValueError("Integers to negative integer powers are not allowed.")
    return _bits(torch.pow)(a, b)


def _reciprocal(a):
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return torch.reciprocal(a)
    # C integer division 1 / x; NumPy's own value where x == 0
    with np.errstate(all="ignore"):
        at_zero = np.reciprocal(np.zeros(1, dtype=numpy_dtype(a.dtype)))
    v = signed_view(a)
    out = torch.where(v == 1, torch.ones_like(v), torch.zeros_like(v))
    if a.dtype.is_signed:
        out = torch.where(v == -1, torch.full_like(v, -1), out)
    zero = torch.from_numpy(at_zero.view(numpy_dtype(v.dtype))).to(a.device)[0]
    return torch.where(v == 0, zero, out).view(a.dtype)


# -- shifts --------------------------------------------------------------------


def _shift(left):
    def f(a, b):
        dt = a.dtype
        bits = dt.itemsize * 8
        if dt in _WIDE_UNSIGNED:
            a, b = a.to(_I64), b.to(_I64)
        sa, sb = signed_view(a), signed_view(b)
        big = (sb < 0) | (sb >= bits)
        s = torch.where(big, torch.zeros_like(sb), sb)
        if left:
            out = torch.bitwise_left_shift(sa, s)
            out = torch.where(big, torch.zeros_like(out), out)
        elif dt == torch.uint64:
            # a logical shift through the signed view
            one = torch.ones_like(s)
            out = torch.where(s == 0, sa, torch.bitwise_right_shift(torch.bitwise_right_shift(sa, one) & ~_INT64_MIN, s - one))
            out = torch.where(big, torch.zeros_like(out), out)
        else:
            out = torch.bitwise_right_shift(sa, s)
            fill = torch.where(sa < 0, torch.full_like(sa, -1), torch.zeros_like(sa)) if dt.is_signed else torch.zeros_like(sa)
            out = torch.where(big, fill, out)
        return out.view(dt) if dt == torch.uint64 else out.to(dt)

    return f


# -- unary ---------------------------------------------------------------------


def _abs(a):
    if a.dtype in _FLOAT_BITS:
        bits, sign = _float_bits(a)
        return (bits & ~sign).view(a.dtype)
    if a.dtype == torch.bool or not (a.dtype.is_signed or a.dtype.is_complex):
        return a.clone()
    return torch.abs(a)


def _sign(a):
    if a.dtype.is_complex:
        return _csign(a)
    if _is_float(a):
        return torch.where(torch.isnan(a), a, torch.sign(a))
    if a.dtype.is_signed:
        return torch.sign(a)
    return _truth(a).to(a.dtype)


# The sign ops on floats work on the bits, so that a NaN keeps its payload
# and gets NumPy's sign on every device (the GPU's float negation and
# absolute value may return another NaN).


def _float_bits(x):
    int_dt, sign, _ = _FLOAT_BITS[x.dtype]
    return x.view(int_dt), sign


def _negative(a):
    if a.dtype.is_complex:  # each part's sign flipped, a NaN's too, as in NumPy
        return torch.view_as_complex(_negative(torch.view_as_real(a)).contiguous())
    if a.dtype in _FLOAT_BITS:
        bits, sign = _float_bits(a)
        return (bits ^ sign).view(a.dtype)
    return _bits(torch.neg)(a)


def _copysign(a, b):
    (bits_a, sign), (bits_b, _) = _float_bits(a), _float_bits(b)
    return ((bits_a & ~sign) | (bits_b & sign)).view(a.dtype)


def _float_only(fn, identity=None):
    """``fn`` on floats; on the integer and bool loops NumPy has for the
    predicates, ``identity(a)``."""

    def f(a):
        if a.dtype.is_floating_point or a.dtype.is_complex:
            return fn(a)
        return identity(a)

    return f


def _nextafter(a, b):
    """NumPy's ``nextafter``: where ``a == b``, C's gives ``b`` (so the sign
    of a zero ``b`` wins) and NumPy's half version ``a``; a NaN operand gives
    a NaN, the half version's own positive one."""
    half = a.dtype == torch.float16
    res = torch.where(a == b, a if half else b, torch.nextafter(a, b))
    if half:
        return torch.where(torch.isnan(a) | torch.isnan(b), torch.tensor(0x7E00, dtype=torch.int16, device=a.device).view(torch.float16), res)
    return _numpy_nans(res, [a, b])


def _conj(a):
    return torch.conj(a).resolve_conj() if a.dtype.is_complex else a.clone()


def _logical(op):
    return lambda a, b: op(_truth(a), _truth(b))


# -- sqrt and complex sign ----------------------------------------------------


def _two_prod(a, b):
    """``(p, e)`` with ``p + e == a * b`` exactly (Dekker, no FMA)."""
    c = 134217729.0  # 2**27 + 1, Veltkamp's splitter for float64
    p = a * b

    def split(x):
        t = c * x
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _sqrt(a):
    """IEEE ``sqrt``, correctly rounded on every device: float64 takes one
    Newton step with the residual ``a - s*s`` computed exactly (the CPU's
    ``torch.sqrt`` can be an ulp off), narrower floats go through float64."""
    if a.dtype.is_complex:
        return torch.sqrt(a)
    if a.dtype != torch.float64:
        return _sqrt(a.double()).to(a.dtype)
    s = torch.sqrt(a)
    p, e = _two_prod(s, s)
    fixed = s + ((a - p) - e) / (2 * s)
    return torch.where((s > 0) & torch.isfinite(s), fixed, s)


def _csign(a):
    """NumPy's complex sign: ``z / |z|``, with its rules for NaN, inf and 0."""
    ar, ai = a.real, a.imag
    m = torch.abs(a)
    nan = torch.full_like(ar, float("nan"))
    zero, one = torch.zeros_like(ar), torch.ones_like(ar)
    re, im = ar / m, ai / m
    inf_r, inf_i = torch.isinf(ar), torch.isinf(ai)
    re = torch.where(torch.isinf(m), torch.where(inf_r, torch.where(inf_i, nan, torch.where(ar > 0, one, -one)), zero), re)
    im = torch.where(torch.isinf(m), torch.where(inf_r, torch.where(inf_i, nan, zero), torch.where(ai > 0, one, -one)), im)
    re = torch.where(m == 0, zero, re)
    im = torch.where(m == 0, zero, im)
    re = torch.where(torch.isnan(m), nan, re)
    im = torch.where(torch.isnan(m), nan, im)
    return torch.complex(re, im)


# -- NaN bits ------------------------------------------------------------------
# NumPy's loops compute with the CPU's float instructions: a NaN made from
# operands that are not NaN is the default NaN (the sign bit set), and a NaN
# operand propagates (the first one). Torch and the GPU make other NaNs, so
# the results of the computing ops are set to those bits.

def _default_nan(dtype, device):
    int_dt, _, bits = _FLOAT_BITS[dtype]
    return torch.tensor(bits, dtype=int_dt, device=device).view(dtype)


def _numpy_nans(res, inputs):
    if res.dtype.is_complex:
        parts = [_numpy_nans(p, [getattr(x, part) if x.dtype.is_complex else x for x in inputs]) for part, p in (("real", res.real), ("imag", res.imag))]
        return torch.complex(*parts)
    if res.dtype not in _FLOAT_BITS:
        return res
    pick = _default_nan(res.dtype, res.device)
    for x in reversed(inputs):
        if x.dtype == res.dtype:
            pick = torch.where(torch.isnan(x), x, pick)
    return torch.where(torch.isnan(res), pick, res)


# -- the NumPy functions that are not ufuncs ----------------------------------


def _np_round(a, decimals=0, out=None):
    """``np.round``: ``rint`` for ``decimals == 0``, else NumPy's own steps
    (``x * 10**d``, ``rint``, ``/ 10**d`` in the array's dtype), each part of
    a complex value alike."""
    if a.dtype.is_complex:
        r = torch.view_as_real(a)
        return torch.view_as_complex(_np_round(r, decimals).contiguous())
    if not (a.dtype.is_floating_point):
        if decimals >= 0:
            return a.clone()
        f = 10.0 ** (-decimals)
        return (torch.round(a.double() / f) * f).to(a.dtype)
    if decimals == 0:
        return torch.round(a)
    if decimals > 0:
        f = torch.tensor(10.0**decimals, dtype=a.dtype, device=a.device)
        return torch.round(a * f) / f
    f = torch.tensor(10.0 ** (-decimals), dtype=a.dtype, device=a.device)
    return torch.round(a / f) * f


def _np_clip(a, a_min=None, a_max=None, out=None, *, min=None, max=None, **kwargs):  # noqa: A002
    """``np.clip`` with NumPy's tie rule: a bound equal to the value (as
    +0.0 and -0.0 are) wins in the float32/float64 loops and loses in the
    half loop; NaN propagates."""
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    keep_on_tie = a.dtype == torch.float16 or not _is_float(a)
    nan = torch.isnan(a) if _is_float(a) else torch.zeros_like(a, dtype=torch.bool)
    for bound, kind in ((lo, "ge" if keep_on_tie else "gt"), (hi, "le" if keep_on_tie else "lt")):
        if bound is not None:
            b = _scalar_tensor(bound, numpy_dtype(a.dtype), a.device).expand_as(a)
            a = select(_cmp(kind)(a, b) | nan, a, b)
    return a


def _np_where(cond, x, y):
    shape = torch.broadcast_shapes(cond.shape, x.shape, y.shape)
    return select(_truth(cond).expand(shape), x.expand(shape), y.expand(shape))


def _np_real(a):
    return a.real.clone() if a.dtype.is_complex else a.clone()


def _np_imag(a):
    return a.imag.clone() if a.dtype.is_complex else torch.zeros_like(a)


def _np_astype(a, dtype=None, casting="unsafe", copy=True, **kwargs):
    dt = torch_dtype(dtype)
    if a.dtype.is_complex and not dt.is_complex:
        a = a.real
    return a.to(dt, copy=True)


_UFUNC_OPS = {
    np.add: _partwise(torch.add),
    np.subtract: _partwise(torch.sub),
    np.multiply: _bits(torch.mul),
    np.true_divide: torch.div,
    np.floor_divide: _floor_divide,
    np.remainder: _remainder,
    np.power: _power,
    np.negative: _negative,
    np.positive: lambda a: a.clone(),
    np.absolute: _abs,
    np.sign: _sign,
    np.square: _bits(lambda a: a * a),
    np.reciprocal: _reciprocal,
    np.sqrt: _sqrt,
    np.exp: torch.exp,
    np.expm1: torch.expm1,
    np.log: torch.log,
    np.log1p: torch.log1p,
    np.log2: torch.log2,
    np.log10: torch.log10,
    np.sin: torch.sin,
    np.cos: torch.cos,
    np.tan: torch.tan,
    np.arcsin: torch.asin,
    np.arccos: torch.acos,
    np.arctan: torch.atan,
    np.sinh: torch.sinh,
    np.cosh: torch.cosh,
    np.tanh: torch.tanh,
    np.arcsinh: torch.asinh,
    np.arccosh: torch.acosh,
    np.arctanh: torch.atanh,
    np.arctan2: torch.atan2,
    np.hypot: torch.hypot,
    np.logaddexp: torch.logaddexp,
    np.floor: _float_only(torch.floor, torch.clone),
    np.ceil: _float_only(torch.ceil, torch.clone),
    np.trunc: _float_only(torch.trunc, torch.clone),
    np.rint: _np_round,
    np.conjugate: _conj,
    np.copysign: _copysign,
    np.nextafter: _nextafter,
    np.signbit: _float_only(torch.signbit, lambda a: _ordered(a) < 0),
    np.isnan: _float_only(torch.isnan, lambda a: torch.zeros_like(a, dtype=torch.bool)),
    np.isinf: _float_only(torch.isinf, lambda a: torch.zeros_like(a, dtype=torch.bool)),
    np.isfinite: _float_only(torch.isfinite, lambda a: torch.ones_like(a, dtype=torch.bool)),
    np.greater: _cmp("gt"),
    np.greater_equal: _cmp("ge"),
    np.less: _cmp("lt"),
    np.less_equal: _cmp("le"),
    np.equal: _eq,
    np.not_equal: _ne,
    np.maximum: _minmax("max"),
    np.minimum: _minmax("min"),
    np.fmax: _minmax("fmax"),
    np.fmin: _minmax("fmin"),
    np.logical_and: _logical(torch.logical_and),
    np.logical_or: _logical(torch.logical_or),
    np.logical_xor: _logical(torch.logical_xor),
    np.logical_not: lambda a: ~_truth(a),
    np.bitwise_and: _bits(torch.bitwise_and),
    np.bitwise_or: _bits(torch.bitwise_or),
    np.bitwise_xor: _bits(torch.bitwise_xor),
    np.invert: _bits(torch.bitwise_not),
    np.left_shift: _shift(True),
    np.right_shift: _shift(False),
}

# the NumPy functions that ``sparse_tpu`` passes to ``elemwise`` and that are
# no ufuncs (their inputs take the result's dtype, ``_input_dtypes``)
_FUNCTION_OPS = {
    np.round: _np_round,
    np.clip: _np_clip,
    np.where: _np_where,
    np.real: _np_real,
    np.imag: _np_imag,
    np.ndarray.astype: _np_astype,
}


# the ops whose NaN results take NumPy's bits (``_numpy_nans``); the others
# select or copy their operands' values
_COMPUTING = frozenset(_UFUNC_OPS) - {
    np.positive, np.negative, np.absolute, np.conjugate, np.copysign, np.maximum, np.minimum, np.fmax, np.fmin,
    np.isnan, np.isinf, np.isfinite, np.signbit, np.nextafter,
}


def op_for(func):
    """The torch implementation of the NumPy function ``func``, or ``None``
    for a callable that is no NumPy function (called on tensors as it is).
    A NumPy function that the table lacks raises ``NotImplementedError``."""
    op = _UFUNC_OPS.get(func)
    if op is None:
        op = _FUNCTION_OPS.get(func)
    if op is not None:
        return op
    if isinstance(func, np.ufunc) or (getattr(func, "__module__", None) or "").split(".")[0] == "numpy":
        raise NotImplementedError(f"{getattr(func, '__name__', func)!s} is not in sparse_tpu_torch's table of elementwise ops")
    return None


def _is_weak(x):
    return isinstance(x, (bool, int, float, complex)) and not isinstance(x, np.generic)


def _weak_key(x):
    """The argument ``ufunc.resolve_dtypes`` takes for a Python scalar."""
    if isinstance(x, bool):
        return np.dtype(np.bool_)
    return type(x)


def _input_dtypes(func, operand_keys, out_dtype, kwargs):
    """The NumPy dtypes the operands are cast to before the torch op: the
    loop ``ufunc.resolve_dtypes`` picks (with the ``dtype=`` signature), or
    for the functions that are not ufuncs, the result's dtype."""
    if isinstance(func, np.ufunc):
        try:
            return list(_resolve(func, operand_keys, kwargs)[: func.nin])
        except (TypeError, ValueError):
            return [out_dtype] * len(operand_keys)
    if func is np.where:
        return [None, out_dtype, out_dtype]
    if func in (np.real, np.imag, np.ndarray.astype):
        return [None] * len(operand_keys)
    return [out_dtype] * len(operand_keys)


def _resolve(func, keys, kwargs):
    """``func.resolve_dtypes`` of the operand dtypes (Python scalar types for
    weak scalars), under the ``dtype=`` signature and ``casting=``."""
    opts = {}
    if kwargs.get("dtype") is not None:
        opts["signature"] = (None,) * func.nin + (np.dtype(kwargs["dtype"]),) * func.nout
    if kwargs.get("casting") is not None:
        opts["casting"] = kwargs["casting"]
    return func.resolve_dtypes(tuple(keys) + (None,) * func.nout, **opts)


_UFUNC_ONLY_KWARGS = ("casting", "order", "subok", "dtype", "signature")


def _torch_kwargs(func, kwargs):
    if isinstance(func, np.ufunc):
        return {k: v for k, v in kwargs.items() if k not in _UFUNC_ONLY_KWARGS}
    if func is np.ndarray.astype:
        return kwargs
    return {k: v for k, v in kwargs.items() if k not in ("casting", "dtype")}


def _scalar_tensor(value, np_dtype, device):
    """A 0-d tensor on ``device`` of the host scalar ``value`` converted by
    NumPy (so a Python float becomes float16 as NumPy rounds it)."""
    return torch.from_numpy(np.array(value, dtype=np_dtype)).to(device)


_COMPARISONS = frozenset({np.greater, np.greater_equal, np.less, np.less_equal, np.equal, np.not_equal})


def _fits(value, dtype):
    return dtype is None or not isinstance(value, int) or np.dtype(dtype).kind not in "iu" or (
        np.iinfo(dtype).min <= value <= np.iinfo(dtype).max
    )


def _run_op(func, op, values, in_dtypes, device, kwargs):
    """``op`` (the table's torch implementation) on ``values`` (tensors and
    Python scalars), each cast first to its NumPy input dtype."""
    if func in _COMPARISONS and not all(_fits(v, dt) for v, dt in zip(values, in_dtypes)):
        # NumPy compares with a Python int out of the array's range exactly
        if any(dt is not None and np.dtype(dt) == np.uint64 for dt in in_dtypes):
            raise _unsupported(func.__name__ + " with an out-of-range Python int", torch.uint64)
        in_dtypes = [np.dtype(np.int64)] * len(values)
    cast = []
    for v, dt in zip(values, in_dtypes):
        if isinstance(v, torch.Tensor):
            cast.append(v if dt is None or v.dtype == torch_dtype(dt) else _to(v, torch_dtype(dt)))
        else:
            cast.append(_scalar_tensor(v, dt if dt is not None else np.asarray(v).dtype, device))
    try:
        res = op(*cast, **_torch_kwargs(func, kwargs))
        return _numpy_nans(res, [c for c in cast if c.dtype.is_floating_point or c.dtype.is_complex]) if func in _COMPUTING else res
    except RuntimeError as e:
        if "not implemented for" in str(e) or "not supported" in str(e):
            name = getattr(func, "__name__", str(func))
            raise _unsupported(name, cast[0].dtype) from e
        raise


def _to(t, dtype):
    """``t.to(dtype)``; complex to real takes the real part (NumPy's cast,
    without torch's warning)."""
    if t.dtype.is_complex and not dtype.is_complex:
        t = t.real
    return t.to(dtype)


def apply_ufunc(func, *tensors, **kwargs):
    """``func`` (a table entry) on tensors with NumPy's dtype rules: the
    inputs cast to ``func.resolve_dtypes``' loop, the result in its output
    dtype. All operands are strong (tensors), as NumPy arrays are."""
    op = op_for(func)
    keys = [numpy_dtype(t.dtype) for t in tensors]
    res = _resolve(func, keys, kwargs)
    out = _run_op(func, op, tensors, list(res[:-1]), tensors[0].device, kwargs)
    return _to(out, torch_dtype(res[-1]))


# ---------------------------------------------------------------------------
# the elementwise engine
# ---------------------------------------------------------------------------


def _strides(shape):
    strides = [0] * len(shape)
    s = 1
    for d in range(len(shape) - 1, -1, -1):
        strides[d] = s
        s *= shape[d]
    return strides


def _unravel(linear, shape):
    """Row-major unravel of int64 keys into an int64 ``(ndim, n)`` tensor."""
    out = torch.empty((len(shape), linear.numel()), dtype=_I64, device=linear.device)
    rem = linear
    for d in range(len(shape) - 1, 0, -1):
        if shape[d]:
            out[d] = rem % shape[d]
            rem = rem // shape[d]
        else:
            out[d] = 0
    if shape:
        out[0] = rem
    return out


def _align_shape(shape, full_shape):
    return (1,) * (len(full_shape) - len(shape)) + tuple(shape)


def _expand_linear(a, full_shape):
    """Linear coordinates (in ``full_shape``, row-major, unsorted) of every
    result position ``a``'s stored entries cover under broadcasting: an entry
    at an extent-1 axis that broadcasts covers each index of it, in the
    cartesian order of the broadcast axes. Returns ``(keys, n_bcast)``."""
    ashape = _align_shape(a.shape, full_shape)
    off = len(full_shape) - a.ndim
    base = torch.zeros(a.nnz, dtype=_I64, device=a.device)
    strides = _strides(full_shape)
    offsets = torch.zeros(1, dtype=_I64, device=a.device)
    n_bcast = 1
    for d in range(len(full_shape)):
        d_a = d - off
        if ashape[d] == full_shape[d]:
            if d_a >= 0 and a.shape[d_a] != 1:
                base += a.coords[d_a].to(_I64) * strides[d]
        else:
            step = torch.arange(full_shape[d], dtype=_I64, device=a.device) * strides[d]
            offsets = (offsets[:, None] + step[None, :]).reshape(-1)
            n_bcast *= full_shape[d]
    if n_bcast == 1:
        return base, 1
    return (base[:, None] + offsets[None, :]).reshape(-1), n_bcast


def _lookup(a, union_coords, union_lin, full_shape):
    """``a``'s value at each union coordinate: its stored value where the
    (broadcast-mapped) coordinate is present, else its fill value."""
    n = union_coords.shape[1]
    if a.shape == tuple(full_shape):
        lin = union_lin
    else:
        offset = len(full_shape) - a.ndim
        strides = _strides(a.shape)
        lin = torch.zeros(n, dtype=_I64, device=a.device)
        for d_a in range(a.ndim):
            if a.shape[d_a] != 1:
                lin += union_coords[offset + d_a] * strides[d_a]
    fill = _scalar_tensor(a.fill_value, numpy_dtype(a.dtype), a.device)
    if a.nnz == 0:
        return fill.expand(n).clone()
    a_lin = a.linear_loc()
    pos = torch.searchsorted(a_lin, lin).clamp_(max=a.nnz - 1)
    found = a_lin[pos] == lin
    return select(found, take(a.data, pos), fill.expand(n))


def _gather_dense(t, union_coords, full_shape):
    if t.ndim == 0:
        return t
    offset = len(full_shape) - t.ndim
    idx = tuple(
        torch.zeros(union_coords.shape[1], dtype=_I64, device=t.device) if t.shape[d] == 1 else wide_index(union_coords[offset + d])
        for d in range(t.ndim)
    )
    return take(t, idx)


def _device_of(args):
    devices = {a.device for a in args if isinstance(a, SparseArray)}
    if len(devices) > 1:
        raise ValueError(f"sparse operands lie on different devices: {sorted(map(str, devices))}")
    return devices.pop()


def _dense_tensor(x, device):
    """A dense operand as a tensor on ``device``: NumPy input is copied
    there; a tensor on another device raises."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"dense operand is on {x.device} but the sparse operands are on {device}; move it first")
        return x
    x = np.asarray(x)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch_dtype(x.dtype), device=device)


def _first_element(t):
    """The first element of a dense tensor as a 1-element NumPy array (the
    fill-value computation's stand-in for the whole operand)."""
    return t.reshape(-1)[:1].cpu().numpy()


def _choose_output_format(args):
    """all-DOK → DOK; all-GCXS → GCXS with their common ``compressed_axes``;
    else COO."""
    from ..core.dok import DOK
    from ..core.gcxs import GCXS

    sparse_args = [a for a in args if isinstance(a, SparseArray)]
    if sparse_args and all(isinstance(a, DOK) for a in sparse_args):
        return "dok", {}
    if sparse_args and all(isinstance(a, GCXS) for a in sparse_args):
        axes = {a.compressed_axes for a in sparse_args}
        if len(axes) == 1:
            return "gcxs", {"compressed_axes": sparse_args[0].compressed_axes}
        return "gcxs", {}
    return "coo", {}


def _to_output_format(out, fmt, fmt_kwargs):
    return out if fmt == "coo" else out.asformat(fmt, **fmt_kwargs)


def _same_pattern(sparse_args, full_shape):
    first = sparse_args[0]
    if not all(a.shape == tuple(full_shape) for a in sparse_args):
        return False
    if len({a.nnz for a in sparse_args}) != 1:
        return False
    for a in sparse_args[1:]:
        if a.coords is first.coords:
            continue
        ca, cf = a.coords, first.coords
        if ca.dtype != cf.dtype:
            ca, cf = ca.to(_I64), cf.to(_I64)
        if not torch.equal(ca, cf):
            return False
    return True


def elemwise(func, *args, **kwargs):
    """Apply ``func`` element-wise over sparse, dense and scalar operands.

    ``func`` is a NumPy function of the op table (``np.add``, ``np.sin``,
    ``np.where``, ...) or any callable on torch tensors. Sparse operands
    (COO, GCXS, scipy sparse) broadcast against dense ones (tensors on the
    sparse operands' device, NumPy arrays, copied there) and Python scalars.
    The result is a COO (a GCXS or a DOK when every sparse operand is one), or a
    dense tensor when ``func(fill values, dense operands)`` varies and the
    dense operands alone span the shape."""
    import scipy.sparse

    out_format, out_kwargs = _choose_output_format(args)
    if not any(isinstance(arg, SparseArray) or scipy.sparse.issparse(arg) for arg in args):
        raise ValueError(f"None of the args is sparse: {args}")

    op = op_for(func)
    sparse_in = [a for a in args if isinstance(a, SparseArray)]
    device = _device_of(sparse_in) if sparse_in else None
    processed = []
    for arg in args:
        if scipy.sparse.issparse(arg):
            arg = COO.from_scipy_sparse(arg, device=device)
            device = device or arg.device
        elif isinstance(arg, SparseArray) and not isinstance(arg, COO):
            arg = arg.tocoo()
        elif not isinstance(arg, (SparseArray, torch.Tensor, np.ndarray, np.generic, bool, int, float, complex, list, tuple)):
            return NotImplemented
        processed.append(arg)
    args = processed
    for i, a in enumerate(args):
        if not (isinstance(a, COO) or _is_weak(a)):
            args[i] = _dense_tensor(a, device)

    sparse_args = [a for a in args if isinstance(a, COO)]
    dense_args = [a for a in args if isinstance(a, torch.Tensor)]
    full_shape = tuple(np.broadcast_shapes(*[a.shape for a in args if not _is_weak(a)]))
    dense_shape = tuple(np.broadcast_shapes(*[a.shape for a in dense_args])) if dense_args else ()

    # --- the result's fill value and dtype, on host scalars ---------------------
    dtype = kwargs.pop("dtype", None)
    if op is None:
        fill_value, out_np = _callable_fill(func, args, kwargs, device)
        in_dtypes = [None] * len(args)
    else:
        fill_value, out_np = _numpy_fill(func, args, dtype, kwargs)
        keys = [_weak_key(a) if _is_weak(a) else numpy_dtype(a.dtype) for a in args]
        in_kwargs = dict(kwargs, dtype=dtype)
        in_dtypes = _input_dtypes(func, keys, out_np, in_kwargs)
    out_dt = torch_dtype(out_np)
    kwargs_op = dict(kwargs, dtype=dtype) if func is np.ndarray.astype else kwargs

    def evaluate(values):
        if op is None:
            res = func(*values, **kwargs_op)
        else:
            res = _run_op(func, op, values, in_dtypes, device, kwargs_op)
        res = res if isinstance(res, torch.Tensor) else torch.as_tensor(res, device=device)
        return _to(res, out_dt)

    # --- a dense operand: func(fill values, dense) must be constant -------------
    equivalent_fv = True
    if any(t.numel() > 1 for t in dense_args):
        fills = [
            _scalar_tensor(a.fill_value, numpy_dtype(a.dtype), device).reshape(1) if isinstance(a, COO) else a
            for a in args
        ]
        candidate = evaluate(fills)
        equivalent_fv = bool(equivalent(candidate, fill_value, loose=True).all())
    if not equivalent_fv:
        if full_shape != dense_shape:
            raise ValueError(
                "Performing a mixed sparse-dense operation that would result in a dense array. "
                "Please make sure that func(sparse_fill_values, ndarrays) is a constant array."
            )
        values = [a.todense() if isinstance(a, COO) else a for a in args]
        return torch.broadcast_to(evaluate(values), full_shape).contiguous()

    full_size = math.prod(full_shape)
    if full_size > np.iinfo(np.int64).max:
        raise ValueError("array too large for element-wise operation")

    def finish(values, union_coords):
        result = evaluate(values)
        if result.ndim == 0:
            result = result.expand(union_coords.shape[1]).clone()
        keep = ~equivalent(result, fill_value)
        union_coords, result = take(union_coords, (slice(None), keep)), take(result, keep)
        out = COO._make(union_coords, result, full_shape, fill_value)
        return _to_output_format(out, out_format, out_kwargs)

    # same coordinate pattern at the full shape: no union
    if _same_pattern(sparse_args, full_shape):
        coords = sparse_args[0].coords
        values = [a.data if isinstance(a, COO) else (a if _is_weak(a) else _gather_dense(a, coords, full_shape)) for a in args]
        return finish(values, coords)

    host = _host_union(func, args, sparse_args, kwargs, dtype, out_dt, fill_value, full_shape)
    if host is not None:
        out, values, union_coords = host
        if out is not None:
            return _to_output_format(out, out_format, out_kwargs)
        return finish(values, union_coords)

    # two to four same-shape operands: one packed sort of owner-tagged keys
    k_sp = len(sparse_args)
    owner_bits = 2 if k_sp > 2 else 1
    if (
        2 <= k_sp <= 4
        and len({id(a) for a in sparse_args}) == k_sp
        and all(a.shape == full_shape for a in sparse_args)
        and full_size < (1 << (62 - owner_bits))
    ):
        lins = [a.linear_loc() for a in sparse_args]
        packed = torch.cat([(lin << owner_bits) | i for i, lin in enumerate(lins)])
        packed, order = torch.sort(packed)
        lin_s = packed >> owner_bits
        is_new = torch.ones_like(lin_s, dtype=torch.bool)
        is_new[1:] = lin_s[1:] != lin_s[:-1]
        u_id = torch.cumsum(is_new, 0) - 1
        union = lin_s[is_new]
        union_coords = _unravel(union, full_shape)
        n_union = union.numel()
        u_of_input = torch.empty_like(u_id)
        u_of_input[order] = u_id  # the union slot of each input entry
        starts = np.cumsum([0] + [lin.numel() for lin in lins])
        values = []
        pos = {id(a): i for i, a in enumerate(sparse_args)}
        for a in args:
            if isinstance(a, COO):
                i = pos[id(a)]
                fill = _scalar_tensor(a.fill_value, numpy_dtype(a.dtype), device)
                vals = fill.expand(n_union).clone()
                signed_view(vals)[u_of_input[starts[i] : starts[i + 1]]] = signed_view(a.data)
                values.append(vals)
            else:
                values.append(a if _is_weak(a) else _gather_dense(a, union_coords, full_shape))
        return finish(values, union_coords)

    # the general union
    expanded = [_expand_linear(a, full_shape)[0] for a in sparse_args]
    keys = torch.sort(torch.cat(expanded) if len(expanded) > 1 else expanded[0]).values
    if keys.numel():
        is_new = torch.ones_like(keys, dtype=torch.bool)
        is_new[1:] = keys[1:] != keys[:-1]
        union = keys[is_new]
    else:
        union = keys
    union_coords = _unravel(union, full_shape)
    values = []
    for a in args:
        if isinstance(a, COO):
            values.append(_lookup(a, union_coords, union, full_shape))
        else:
            values.append(a if _is_weak(a) else _gather_dense(a, union_coords, full_shape))
    return finish(values, union_coords)


_FUSED_UFUNCS = {np.add: "add", np.subtract: "subtract", np.multiply: "multiply"}


def _is_pos_zero(v):
    v = np.asarray(v)
    return v.dtype.kind == "f" and v == 0 and not np.signbit(v)


def _host_unravel(keys, shape):
    if keys.numel() >= native_eager.NATIVE_MIN_NNZ and all(shape):
        return native_eager.unravel(keys, shape)
    return _unravel(keys, shape)


def _host_union(func, args, sparse_args, kwargs, dtype, out_dt, fill_value, full_shape):
    """The host library's union of two distinct same-shape CPU operands of
    float32/float64 data with ``NATIVE_MIN_NNZ`` entries or more between
    them, as ``sparse_tpu``'s host route: ``(out, None, None)`` from a fused
    join (``a + b``, ``a - b``, ``a * b`` with +0.0 fills: evaluated and
    pruned of bitwise +0.0 in one pass, on ``(row, col)`` pairs in 2-D), or
    ``(None, values, union_coords)`` of a union join for the caller's
    evaluation; ``None`` where the torch route runs."""
    if len(sparse_args) != 2:
        return None
    a0, a1 = sparse_args
    d0, d1 = a0.data, a1.data
    if (
        a0 is a1
        or a0.shape != full_shape
        or a1.shape != full_shape
        or not native.host_route(a0.device, d0.dtype, a0.nnz + a1.nnz, native_eager.NATIVE_MIN_NNZ)
        or d1.dtype not in native.HOST_DTYPES
    ):
        return None
    name = _FUSED_UFUNCS.get(func)
    fusable = (
        name is not None
        and len(args) == 2
        and args[0] is a0
        and args[1] is a1
        and not kwargs
        and dtype is None
        and d0.dtype == d1.dtype == out_dt
        and _is_pos_zero(a0.fill_value)
        and _is_pos_zero(a1.fill_value)
        and _is_pos_zero(fill_value)
    )
    if fusable and len(full_shape) == 2:
        rows, cols, vals = native_eager.fused_join_2d(name, *a0.coords, d0, *a1.coords, d1, full_shape[1])
        return COO._make(torch.stack([rows, cols]).to(_I64), vals, full_shape, fill_value), None, None
    lin0, lin1 = a0.linear_loc(), a1.linear_loc()
    if fusable:
        keys, vals = native_eager.fused_join(name, lin0, d0, lin1, d1)
        return COO._make(_host_unravel(keys, full_shape), vals, full_shape, fill_value), None, None
    if d0.dtype == d1.dtype:
        keys, v0, v1 = native_eager.union_join_values(lin0, d0, a0.fill_value, lin1, d1, a1.fill_value)
    else:
        keys, ia, ib = native_eager.union_join(lin0, lin1)
        v0, v1 = (
            select(i >= 0, take(d, i.clamp(min=0)), torch.tensor(a.fill_value, dtype=d.dtype))
            if d.numel()
            else torch.full(i.shape, a.fill_value.item(), dtype=d.dtype)
            for a, d, i in ((a0, d0, ia), (a1, d1, ib))
        )
    union_coords = _host_unravel(keys, full_shape)
    values = [
        v0 if a is a0 else v1 if a is a1 else a if _is_weak(a) else _gather_dense(a, union_coords, full_shape)
        for a in args
    ]
    return None, values, union_coords


def _numpy_fill(func, args, dtype, kwargs):
    """The result's fill value (a NumPy scalar) and dtype, computed by NumPy
    as ``sparse_tpu`` computes them: ``func`` on each sparse operand's fill
    value (a 1-element array), each dense operand's first element (a
    1-element array) and the Python scalars themselves (weak)."""
    fv_args = []
    for a in args:
        if isinstance(a, COO):
            fv_args.append(np.atleast_1d(np.asarray(a.fill_value)))
        elif _is_weak(a):
            fv_args.append(a)
        elif a.numel() == 0:
            fv_args.append(np.zeros(1, dtype=numpy_dtype(a.dtype)))
        else:
            fv_args.append(_first_element(a))
    if dtype is not None:
        try:
            arr = func(*fv_args, dtype=dtype, **kwargs)
        except TypeError:  # plain functions (np.round, ...) take no dtype
            arr = func(*fv_args, **kwargs)
    else:
        arr = func(*fv_args, **kwargs)
    fill_value = np.asarray(arr).reshape(-1)[0]
    if dtype is not None:
        fill_value = np.asarray(fill_value).astype(dtype)[()]
    return fill_value, np.asarray(fill_value).dtype


def _callable_fill(func, args, kwargs, device):
    """Fill value and dtype of a callable that is no NumPy function: ``func``
    on torch tensors of the fill values (and of each dense operand's first
    element); the dtype is torch's."""
    fv_args = []
    for a in args:
        if isinstance(a, COO):
            fv_args.append(_scalar_tensor(a.fill_value, numpy_dtype(a.dtype), device).reshape(1))
        elif _is_weak(a):
            fv_args.append(a)
        else:
            fv_args.append(a.reshape(-1)[:1] if a.numel() else torch.zeros(1, dtype=a.dtype, device=device))
    res = func(*fv_args, **kwargs)
    res = res if isinstance(res, torch.Tensor) else torch.as_tensor(res)
    fill_value = res.reshape(-1)[0].cpu().numpy()[()]
    return fill_value, numpy_dtype(res.dtype)


def broadcast_to(x, shape):
    """``x`` broadcast to ``shape``: a COO (a sparse array's entries
    replicated along its broadcast axes, on its device), a tensor through
    ``torch.broadcast_to``, a NumPy array through ``np.broadcast_to``."""
    if not isinstance(x, COO):
        if isinstance(x, SparseArray):
            x = x.tocoo()
        elif isinstance(x, torch.Tensor):
            return torch.broadcast_to(x, shape)
        else:
            return np.broadcast_to(x, shape)
    shape = tuple(int(s) for s in shape)
    if x.shape == shape:
        return x
    np.broadcast_shapes(x.shape, shape)  # raises on a shape it cannot broadcast to
    lin, n_bcast = _expand_linear(x, shape)
    lin, order = torch.sort(lin, stable=True)
    data = take(x.data, order // n_bcast)  # entry e's keys sit at e * n_bcast + [0, n_bcast)
    return COO._make(_unravel(lin, shape), data, shape, x.fill_value)

