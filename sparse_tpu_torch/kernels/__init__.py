"""Compute kernels of sparse_tpu_torch.

``row_ell`` holds the row-ELL layout and the wrappers of the CUDA kernels
(``csrc/row_ell.cu``, built and launched by ``_cuda``); ``dot`` the COO
gather + ``index_add_`` products for the dtypes those kernels do not take.
"""

from ._cuda import LAUNCHES, reset_launch_counts
from .dot import coo_spmm, coo_spmv
from .row_ell import (
    ONEHOT_SPMV_MAX_K,
    RowEll,
    build_row_ell,
    row_ell_spmm,
    row_ell_spmm_program,
    row_ell_spmv,
)

__all__ = [
    "LAUNCHES",
    "ONEHOT_SPMV_MAX_K",
    "RowEll",
    "build_row_ell",
    "coo_spmm",
    "coo_spmv",
    "reset_launch_counts",
    "row_ell_spmm",
    "row_ell_spmm_program",
    "row_ell_spmv",
]
