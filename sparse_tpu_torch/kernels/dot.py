"""COO SpMM/SpMV as torch gather + ``index_add_``.

The path for the dtypes the row-ELL kernels do not take (integers, complex,
float16): ``ops.dot`` sends those here by dtype, as ``sparse_tpu`` keeps them
off its row-ELL path. Same functions as ``sparse_tpu.kernels.dot.coo_spmm``
and ``coo_spmv``.
"""

from __future__ import annotations

import torch


def coo_spmm(rows, cols, data, dense, *, n_rows):
    """``A @ B`` for COO ``A`` (zero fill) and dense ``B (K, N)`` → ``(n_rows, N)``."""
    out = torch.zeros((n_rows, dense.shape[1]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, rows.long(), data[:, None] * dense[cols.long()])


def coo_spmv(rows, cols, data, x, *, n_rows):
    """``A @ x`` for COO ``A`` and a dense vector ``x`` → ``(n_rows,)``."""
    out = torch.zeros(n_rows, dtype=data.dtype, device=data.device)
    return out.index_add_(0, rows.long(), data * x[cols.long()])
