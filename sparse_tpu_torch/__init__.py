"""sparse_tpu_torch — the port of ``sparse_tpu`` to PyTorch and CUDA.

N-dimensional sparse arrays on torch tensors, with the semantics of
``sparse_tpu`` (the reference, which stays beside this package unchanged).
Arrays live on the GPU unless ``device="cpu"`` is asked for; the hot
products run in hand-written CUDA kernels (``kernels``). This package never
imports ``jax`` or ``sparse_tpu``.

It holds the sparse × dense main path (a canonical 2-D ``COO``, ``a @ b`` /
``matmul`` / ``dot`` on the cached row-ELL layout, the fused ``matvec_add``),
the compressed formats ``GCXS``, ``CSR`` and ``CSC`` (built, converted and
restructured on the device; their products on the same path), element-wise
operations with broadcasting and the fill-value algebra (``elemwise``, the
NumPy ufuncs and operators on sparse arrays, ``broadcast_to``) and the
reductions (``sum``, ``max``, ``mean``, ``var``, the nan-reductions, ...)
of COO and GCXS arrays on their device,
the block-sparse linear layer of ``nn`` (BSR forward, dgrad and wgrad
kernels), the MTTKRP of a 3-D tensor (``jitops.mttkrp`` on a ``COO``,
``kernels.mttkrp`` and the block-ELL ``kernels.ell_mttkrp``, one CUDA
kernel), the sampled dense-dense matmul ``sddmm`` (one CUDA kernel, with
its gradient), the rest of the products with one sparse operand (dense ×
sparse, 1-D and batched ``matmul``/``dot``, ``tensordot`` and ``vecdot``),
the products of two sparse operands (SpGEMM: ``a @ b``, ``dot``,
``matmul``, ``tensordot``, and the capacity-bounded ``jitops.spgemm``),
``einsum``, ``concatenate``/``stack`` and ``diagonal``/``diagonalize``,
indexing and slicing of COO and GCXS on the device (``x[...]``, ``take``),
the DOK format (a dict on the host), ``save_npz``/``load_npz`` with
``sparse_tpu``'s npz schema, the creation functions (``eye``, ``full``,
``zeros``, ``asarray``, ...), ``random`` (``sparse_tpu.random``'s draws) and
the rest of the namespace (``sort``, ``argmax``, ``unique_counts``,
``kron``, ``interp``, ...), and ``linalg``: the Krylov solvers and spectral
functions of ``sparse_tpu.linalg`` on the operand's device (their matvecs on
the DIA shifts or the row-ELL SpMV kernel) with scipy's direct solvers as host
bridges, and ``csgraph``: the graph algorithms of ``sparse_tpu.csgraph``
(shortest paths on the min-plus relaxation kernel, PageRank on the row-ELL
SpMV kernel). ``testing`` holds ``assert_eq`` and its kin. ``parallel``
holds the multi-device layer on ``torch.distributed`` (row-partitioned
operands and their sharded products), ``checkpoint`` its save and restore,
and ``profiling`` the timers (``benchmark`` on CUDA events, ``trace`` on
``torch.profiler``, ``compiled``).

``CSR``, ``CSC``, ``compiled``, ``csgraph``, ``jitops``, ``kernels``, ``linalg``,
``matvec_add``, ``nn``, ``parallel``, ``profiling``, ``sddmm``, ``swapaxes``
and ``transpose`` are attributes, not names of ``__all__``, which names
exactly what ``sparse_tpu.__all__`` names.

The namespace re-exports NumPy's ufuncs under ``sparse_tpu``'s names
(``sparse_tpu_torch.add is np.add``): called on a sparse array they run on
its device through ``__array_ufunc__``.
"""

from numpy import (
    add,
    bitwise_and,
    bitwise_not,
    bitwise_or,
    bitwise_xor,
    ceil,
    complex64,
    complex128,
    conj,
    copysign,
    cos,
    cosh,
    divide,
    e,
    exp,
    expm1,
    finfo,
    float16,
    float32,
    float64,
    floor,
    floor_divide,
    greater,
    greater_equal,
    hypot,
    iinfo,
    inf,
    int8,
    int16,
    int32,
    int64,
    less,
    less_equal,
    log,
    log1p,
    log2,
    log10,
    logaddexp,
    logical_and,
    logical_not,
    logical_or,
    logical_xor,
    maximum,
    minimum,
    multiply,
    nan,
    negative,
    newaxis,
    nextafter,
    not_equal,
    pi,
    positive,
    reciprocal,
    remainder,
    sign,
    signbit,
    sin,
    sinh,
    sqrt,
    square,
    subtract,
    tan,
    tanh,
    trunc,
    uint8,
    uint16,
    uint32,
    uint64,
)
from numpy import arccos as acos
from numpy import arccosh as acosh
from numpy import arcsin as asin
from numpy import arcsinh as asinh
from numpy import arctan as atan
from numpy import arctan2 as atan2
from numpy import arctanh as atanh
from numpy import bool_ as bool  # noqa: A001
from numpy import invert as bitwise_invert
from numpy import left_shift as bitwise_left_shift
from numpy import power as pow  # noqa: A001
from numpy import right_shift as bitwise_right_shift

from . import jitops, kernels, nn
from ._io import load_npz, save_npz
from ._utils import random
from .core.base import SparseArray
from .core.coo import COO
from .core.dok import DOK
from .core.gcxs import CSC, CSR, GCXS
from .ops.common import (
    argmax,
    argmin,
    argwhere,
    asCOO,
    as_coo,
    asnumpy,
    broadcast_shapes,
    can_cast,
    concat,
    concatenate,
    diagonal,
    diagonalize,
    diff,
    equal,
    expand_dims,
    flip,
    interp,
    isdtype,
    isfinite,
    isinf,
    isnan,
    isneginf,
    isposinf,
    kron,
    matrix_transpose,
    moveaxis,
    nanmax,
    nanmean,
    nanmin,
    nanprod,
    nanreduce,
    nansum,
    nonzero,
    outer,
    pad,
    repeat,
    result_type,
    roll,
    sort,
    stack,
    swapaxes,
    take,
    tile,
    tril,
    triu,
    unique_counts,
    unique_values,
    unstack,
    where,
)
from .ops.creation import (
    abs,  # noqa: A004
    all,  # noqa: A004
    any,  # noqa: A004
    asarray,
    astype,
    broadcast_arrays,
    empty,
    empty_like,
    eye,
    full,
    full_like,
    imag,
    max,  # noqa: A004
    mean,
    min,  # noqa: A004
    ones,
    ones_like,
    permute_dims,
    prod,
    real,
    reshape,
    round,  # noqa: A004
    squeeze,
    std,
    sum,  # noqa: A004
    transpose,
    var,
    zeros,
    zeros_like,
)
from .ops.dot import dot, matmul, matvec_add, sddmm, tensordot, vecdot
from .ops.einsum import einsum
from .ops.elemwise import broadcast_to, elemwise
from . import linalg  # noqa: E402  (after the namespace it builds on)
from . import csgraph  # noqa: E402
from . import parallel  # noqa: E402
from . import profiling  # noqa: E402
from .profiling import compiled  # noqa: E402


def clip(a, min=None, max=None, out=None, *, a_min=None, a_max=None):  # noqa: A002
    """Clip values to ``[min, max]`` (``a_min``/``a_max`` are NumPy's names)."""
    if a_min is not None:
        min = a_min  # noqa: A001
    if a_max is not None:
        max = a_max  # noqa: A001
    return a.clip(min=min, max=max, out=out)


__all__ = sorted(
    [
        "COO",
        "DOK",
        "GCXS",
        "SparseArray",
        "abs",
        "acos",
        "acosh",
        "add",
        "all",
        "any",
        "argmax",
        "argmin",
        "argwhere",
        "asCOO",
        "as_coo",
        "asarray",
        "asin",
        "asinh",
        "asnumpy",
        "astype",
        "atan",
        "atan2",
        "atanh",
        "bitwise_and",
        "bitwise_invert",
        "bitwise_left_shift",
        "bitwise_not",
        "bitwise_or",
        "bitwise_right_shift",
        "bitwise_xor",
        "bool",
        "broadcast_arrays",
        "broadcast_shapes",
        "broadcast_to",
        "can_cast",
        "ceil",
        "clip",
        "complex128",
        "complex64",
        "concat",
        "concatenate",
        "conj",
        "copysign",
        "cos",
        "cosh",
        "diagonal",
        "diagonalize",
        "diff",
        "divide",
        "dot",
        "e",
        "einsum",
        "elemwise",
        "empty",
        "empty_like",
        "equal",
        "exp",
        "expand_dims",
        "expm1",
        "eye",
        "finfo",
        "flip",
        "float16",
        "float32",
        "float64",
        "floor",
        "floor_divide",
        "full",
        "full_like",
        "greater",
        "greater_equal",
        "hypot",
        "iinfo",
        "imag",
        "inf",
        "int16",
        "int32",
        "int64",
        "int8",
        "interp",
        "isfinite",
        "isdtype",
        "isinf",
        "isnan",
        "isneginf",
        "isposinf",
        "kron",
        "less",
        "less_equal",
        "load_npz",
        "log",
        "log10",
        "log1p",
        "log2",
        "logaddexp",
        "logical_and",
        "logical_not",
        "logical_or",
        "logical_xor",
        "matmul",
        "matrix_transpose",
        "max",
        "maximum",
        "mean",
        "min",
        "minimum",
        "moveaxis",
        "multiply",
        "nan",
        "nanmax",
        "nanmean",
        "nanmin",
        "nanprod",
        "nanreduce",
        "nansum",
        "negative",
        "newaxis",
        "nextafter",
        "nonzero",
        "not_equal",
        "ones",
        "ones_like",
        "outer",
        "pad",
        "permute_dims",
        "pi",
        "positive",
        "pow",
        "prod",
        "random",
        "real",
        "reciprocal",
        "remainder",
        "repeat",
        "reshape",
        "result_type",
        "roll",
        "round",
        "save_npz",
        "sign",
        "signbit",
        "sin",
        "sinh",
        "sort",
        "sqrt",
        "square",
        "squeeze",
        "stack",
        "std",
        "subtract",
        "sum",
        "take",
        "tan",
        "tanh",
        "tensordot",
        "tile",
        "tril",
        "triu",
        "trunc",
        "uint16",
        "uint32",
        "uint64",
        "uint8",
        "unique_counts",
        "unique_values",
        "unstack",
        "var",
        "vecdot",
        "where",
        "zeros",
        "zeros_like",
    ]
)
