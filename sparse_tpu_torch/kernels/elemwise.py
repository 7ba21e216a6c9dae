"""The traceable element-wise union of two COO operands, on torch tensors
(``sparse_tpu.kernels.elemwise.coo_elemwise_union``).

The eager engine (``ops/elemwise.py``) compacts its result, which reads its
size back to the host. This form has static sizes and no host read, so a
later ``torch.compile`` can take it: the union is padded to ``nnz_a +
nnz_b`` with the out-of-range coordinate ``size`` and the output fill
value, and its true length comes back as a 0-d tensor. Nothing is pruned.
"""

from __future__ import annotations

import numpy as np
import torch

from .._utils import signed_view


def _scalar(v, device):
    """A fill value as a 0-d tensor; a Python scalar takes NumPy's dtype
    (float64, int64), as under JAX's x64."""
    return v.to(device) if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)).to(device)


def coo_elemwise_union(lin_a, data_a, fv_a, lin_b, data_b, fv_b, *, func, size):
    """Binary ``func`` (on tensors) over the union of two sorted
    linear-coordinate streams of one shape with ``size`` elements.

    Returns ``(lin_out, data_out, fill_out, nnz_out)``: the arrays have
    length ``nnz_a + nnz_b``, the entries past ``nnz_out`` (a 0-d tensor)
    have coordinate ``size`` and the output fill ``func(fv_a, fv_b)``. As in
    ``sparse_tpu``, ``data_b`` is cast to ``data_a``'s dtype, and each
    operand's value at a union slot is summed from zeros, so a stored -0.0
    reads as +0.0."""
    na, nb = lin_a.shape[0], lin_b.shape[0]
    cap = na + nb
    device = data_a.device
    fv_a = _scalar(fv_a, device)
    fv_b = _scalar(fv_b, device)
    fill_out = func(fv_a, fv_b)

    lin_all = torch.cat([lin_a, lin_b])
    owner = torch.cat([torch.zeros(na, dtype=torch.int32, device=device), torch.ones(nb, dtype=torch.int32, device=device)])
    val_all = torch.cat([data_a, data_b.to(data_a.dtype)])
    lin_s, order = torch.sort(lin_all, stable=True)
    owner_s = owner[order]
    val_s = val_all[order]

    is_new = torch.ones(cap, dtype=torch.bool, device=device)
    is_new[1:] = lin_s[1:] != lin_s[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    nnz_out = is_new.sum()

    # bool values sum as int64, as the reference's jnp.where(..., val, 0)
    # promotes them; uint16/32/64 through their signed views (the same bits)
    sv = signed_view(val_s)
    acc, vt = (torch.int64, torch.int64) if val_s.dtype == torch.bool else (sv.dtype, val_s.dtype)
    zero = torch.zeros((), dtype=acc, device=device)
    a_val = torch.zeros(cap, dtype=acc, device=device).index_add_(0, seg, torch.where(owner_s == 0, sv, zero)).view(vt)
    b_val = torch.zeros(cap, dtype=acc, device=device).index_add_(0, seg, torch.where(owner_s == 1, sv, zero)).view(vt)
    a_present = torch.zeros(cap, dtype=torch.int32, device=device).index_add_(0, seg, (owner_s == 0).to(torch.int32)) > 0
    b_present = torch.zeros(cap, dtype=torch.int32, device=device).index_add_(0, seg, (owner_s == 1).to(torch.int32)) > 0
    a_val = torch.where(a_present, a_val, fv_a.to(a_val.dtype))
    b_val = torch.where(b_present, b_val, fv_b.to(b_val.dtype))

    # every slot of a run holds the same key: the scatter is order-free
    lin_u = torch.zeros(cap, dtype=lin_s.dtype, device=device).index_put_((seg,), lin_s)

    in_range = torch.arange(cap, device=device) < nnz_out
    lin_out = torch.where(in_range, lin_u, torch.full_like(lin_u, size))
    data_out = torch.where(in_range, func(a_val, b_val), fill_out)
    return lin_out, data_out, fill_out, nnz_out
