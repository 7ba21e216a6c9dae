"""``einsum`` over sparse operands, with the semantics of
``sparse_tpu.ops.einsum``: the subscripts (a string, or operands
interleaved with sublists, with an ellipsis), the implicit output, and the
same errors. A two-operand pure contraction runs as one ``tensordot`` (a
sparse × sparse one on ``kernels.spgemm``); three or more operands without
repeated labels contract pairwise in a greedy order; anything else takes
the diagonals of repeated labels, aligns every operand into one label
space, multiplies through the element-wise engine and sums the contracted
labels. Dense operands are tensors on the sparse operands' device (NumPy
arrays are copied there). All-GCXS sparse operands give a GCXS, others a
COO; a contraction with one dense operand gives a dense tensor.
"""

from __future__ import annotations

import string
from collections.abc import Iterable

import numpy as np
import torch

from .._utils import numpy_dtype, result_dtype, signed_view, torch_dtype
from ..core.base import SparseArray
from .common import diagonal as _diagonal

__all__ = ["einsum"]

_LETTERS = string.ascii_letters


def _sublist_to_subscript(sublist):
    return "".join("..." if item is Ellipsis else _LETTERS[int(item)] for item in sublist)


def _parse_operands(operands):
    """``(input subscripts, output subscript or None, operands)``."""
    if isinstance(operands[0], str):
        subscripts = operands[0].replace(" ", "")
        arrays = list(operands[1:])
        in_sub, out_sub = subscripts.split("->") if "->" in subscripts else (subscripts, None)
        return in_sub.split(","), out_sub, arrays

    def _check_sublist(s):
        if (
            isinstance(s, (str, SparseArray, np.ndarray, torch.Tensor))
            or not isinstance(s, Iterable)
            or not all(item is Ellipsis or isinstance(item, int) for item in s)
        ):
            raise TypeError(
                "einsum subscripts must be a string or interleaved operand/sublist pairs "
                "where each sublist contains ints or Ellipsis"
            )

    arrays = list(operands[::2])
    sublists = list(operands[1::2])
    out_sub = None
    if len(sublists) == len(arrays) + 1 or (len(operands) % 2 == 1):
        arrays = list(operands[:-1:2])
        sublists = list(operands[1:-1:2])
        for s in [*sublists, operands[-1]]:
            _check_sublist(s)
        out_sub = _sublist_to_subscript(operands[-1])
    else:
        for s in sublists:
            _check_sublist(s)
    return [_sublist_to_subscript(s) for s in sublists], out_sub, arrays


def _expand_ellipsis(inputs, out_sub, arrays):
    used = set("".join(inputs) + (out_sub or "")) - {"."}
    free = [c for c in _LETTERS if c not in used]
    max_ell = 0
    for sub, arr in zip(inputs, arrays):
        if "..." in sub:
            max_ell = max(max_ell, np.ndim(arr) - len(sub.replace("...", "")))
    ell_labels = "".join(free[:max_ell])
    new_inputs = []
    for k, (sub, arr) in enumerate(zip(inputs, arrays)):
        if "..." in sub:
            n_ell = np.ndim(arr) - len(sub.replace("...", ""))
            if n_ell < 0:
                raise ValueError("operand has fewer dimensions than subscripts given")
            sub = sub.replace("...", ell_labels[max_ell - n_ell :])
        if len(sub) != np.ndim(arr):
            # trailing length-1 axes are dropped, as ``sparse_tpu`` drops them
            shape = tuple(np.shape(arr))
            if len(sub) < np.ndim(arr) and all(d == 1 for d in shape[len(sub) :]):
                arrays[k] = arr.reshape(shape[: len(sub)])
            else:
                raise ValueError(f"operand has {np.ndim(arr)} dimensions but {len(sub)} subscripts given")
        new_inputs.append(sub)
    if out_sub is not None and "..." in out_sub:
        out_sub = out_sub.replace("...", ell_labels)
    return new_inputs, out_sub, ell_labels


def _on_device(arrays):
    """NumPy operands as tensors on the sparse operands' device."""
    devices = {a.device for a in arrays if isinstance(a, (SparseArray, torch.Tensor))}
    device = next(iter(devices)) if len(devices) == 1 else None
    out = []
    for a in arrays:
        if isinstance(a, (np.ndarray, np.generic)) and device is not None:
            a = np.asarray(a)
            a = torch.as_tensor(np.ascontiguousarray(a), dtype=torch_dtype(a.dtype), device=device)
        out.append(a)
    return out


def einsum(*operands, **kwargs):
    """Evaluate the Einstein summation convention on sparse and dense
    operands (``dtype=`` casts the result)."""
    dtype = kwargs.pop("dtype", None)
    if kwargs:
        raise TypeError(f"einsum() got unexpected keyword arguments {list(kwargs)}")
    if not operands:
        raise ValueError("must specify the einstein sum subscripts string and at least one operand")

    inputs, out_sub, arrays = _parse_operands(operands)
    arrays = _on_device(arrays)

    from ..core.gcxs import GCXS

    sparse_ops = [a for a in arrays if isinstance(a, SparseArray)]
    if sparse_ops and all(isinstance(a, GCXS) for a in sparse_ops):
        result = _einsum_coo(inputs, out_sub, arrays, dtype)
        return result.asformat("gcxs") if isinstance(result, SparseArray) else result
    return _einsum_coo(inputs, out_sub, arrays, dtype)


def _transpose(x, perm):
    return x.transpose(tuple(perm)) if isinstance(x, SparseArray) else x.permute(tuple(perm))


def _einsum_coo(inputs, out_sub, arrays, dtype):
    if len(inputs) != len(arrays):
        raise ValueError("number of einsum subscripts must be equal to the number of operands")

    inputs, out_sub, ell_labels = _expand_ellipsis(inputs, out_sub, arrays)

    # implicit output: the labels that occur once, sorted, the ellipsis first
    all_labels = "".join(inputs)
    if out_sub is None:
        counts = {c: all_labels.count(c) for c in set(all_labels)}
        out_sub = ell_labels + "".join(sorted(c for c in counts if counts[c] == 1 and c not in ell_labels))
    else:
        for c in out_sub:
            if c not in all_labels:
                raise ValueError(f"output subscript {c} does not appear in any input")
        if len(set(out_sub)) != len(out_sub):
            raise ValueError("output subscript includes a repeated label")

    # two operands, a pure contraction: one tensordot (SpGEMM when both are
    # sparse), where the general path would expand each over the other's axes
    if len(arrays) == 2 and dtype is None:
        s0, s1 = inputs
        if len(set(s0)) == len(s0) and len(set(s1)) == len(s1):
            shared = [c for c in s0 if c in s1]
            free0 = [c for c in s0 if c not in s1]
            free1 = [c for c in s1 if c not in s0]
            if shared and all(c not in out_sub for c in shared) and set(out_sub) == set(free0 + free1):
                from .dot import tensordot

                res = tensordot(arrays[0], arrays[1], axes=([s0.index(c) for c in shared], [s1.index(c) for c in shared]))
                natural = free0 + free1
                if natural != list(out_sub):
                    res = _transpose(res, [natural.index(c) for c in out_sub])
                return res

    # three or more operands: contract pairwise in a greedy order (the pair
    # that shares the most labels first), each pair through einsum again
    if len(arrays) > 2 and dtype is None and all(len(set(s)) == len(s) for s in inputs):
        remaining = list(zip(inputs, arrays))
        while len(remaining) > 2:
            best = None
            for i in range(len(remaining)):
                for j in range(i + 1, len(remaining)):
                    shared = len(set(remaining[i][0]) & set(remaining[j][0]))
                    if best is None or shared > best[0]:
                        best = (shared, i, j)
            _, i, j = best
            si, ai = remaining[i]
            sj, aj = remaining[j]
            others = [s for k, (s, _) in enumerate(remaining) if k not in (i, j)]
            keep = set(out_sub) | set("".join(others))
            both = si + sj
            pair_out = "".join(c for c in both if (c in keep or both.count(c) == 1) and both.index(c) == both.find(c))
            seen = set()
            pair_out = "".join(c for c in pair_out if not (c in seen or seen.add(c)))
            res = einsum(f"{si},{sj}->{pair_out}", ai, aj)
            remaining = [r for k, r in enumerate(remaining) if k not in (i, j)] + [(pair_out, res)]
        (s0, a0), (s1, a1) = remaining
        return einsum(f"{s0},{s1}->{out_sub}", a0, a1)

    # repeated labels within an operand: its diagonal (moved last)
    proc_arrays, proc_inputs = [], []
    for sub, arr in zip(inputs, arrays):
        while len(set(sub)) != len(sub):
            for c in sub:
                if sub.count(c) > 1:
                    ax1 = sub.index(c)
                    ax2 = sub.index(c, ax1 + 1)
                    if isinstance(arr, SparseArray):
                        arr = _diagonal(arr, axis1=ax1, axis2=ax2)
                    else:
                        arr = torch.diagonal(torch.as_tensor(arr), dim1=ax1, dim2=ax2)
                    sub = "".join(ch for i, ch in enumerate(sub) if i not in (ax1, ax2)) + c
                    break
        proc_arrays.append(arr)
        proc_inputs.append(sub)

    extents = {}
    for sub, arr in zip(proc_inputs, proc_arrays):
        for c, d in zip(sub, np.shape(arr)):
            if c in extents and extents[c] != d and 1 not in (extents[c], d):
                raise ValueError(f"inconsistent extent for label {c}")
            extents[c] = max(extents.get(c, 1), d)

    contracted = [c for c in sorted(set(all_labels)) if c not in out_sub]
    full_order = out_sub + "".join(contracted)

    # each operand in the full label space, length 1 along its missing labels
    aligned = []
    for sub, arr in zip(proc_inputs, proc_arrays):
        perm = sorted(range(len(sub)), key=lambda i: full_order.index(sub[i]))
        if not isinstance(arr, SparseArray):
            arr = torch.as_tensor(arr)
        if len(perm) > 1:
            arr = _transpose(arr, perm)
        sub_sorted = "".join(sub[i] for i in perm)
        new_shape = tuple(np.shape(arr)[sub_sorted.index(c)] if c in sub_sorted else 1 for c in full_order)
        aligned.append(arr.reshape(new_shape))

    result = aligned[0]
    if len(aligned) > 1:
        from .elemwise import elemwise

        for nxt in aligned[1:]:
            if isinstance(result, SparseArray) or isinstance(nxt, SparseArray):
                result = elemwise(np.multiply, result, nxt)
            else:
                dt = result_dtype(result.dtype, nxt.dtype)
                result = result.to(dt) * nxt.to(dt)

    if contracted:
        axes = tuple(full_order.index(c) for c in contracted)
        if isinstance(result, SparseArray):
            result = result.sum(axis=axes)
        else:
            dt = torch_dtype(np.empty(0, numpy_dtype(result.dtype)).sum().dtype)  # NumPy's sum dtype
            result = signed_view(result.to(dt)).sum(dim=axes).view(dt)

    if dtype is not None:
        result = result.astype(dtype) if isinstance(result, SparseArray) else result.to(torch_dtype(numpy_dtype(dtype)))
    return result
