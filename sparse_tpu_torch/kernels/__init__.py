"""Compute kernels of sparse_tpu_torch.

``row_ell`` holds the row-ELL layout and the wrappers of its CUDA kernels
(``csrc/row_ell.cu``); ``bsr`` the block-sparse layout, the wrappers of its
CUDA kernels (``csrc/bsr.cu``) and the differentiable BSR products; both
are built and launched by ``_cuda``. ``dot`` holds the COO gather +
``index_add_`` products for the dtypes the row-ELL kernels do not take.
"""

from ._cuda import LAUNCHES, reset_launch_counts
from .bsr import (
    BSR,
    block_row_ptr,
    bsr_sddmm_kernel,
    bsr_sddmm_plain,
    bsr_spmm,
    bsr_spmm_kernel,
    bsr_spmm_kernel2,
    bsr_spmm_plain,
    bsr_spmm_trainable,
    build_bsr,
    transpose_bsr_layout,
)
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
    "BSR",
    "LAUNCHES",
    "ONEHOT_SPMV_MAX_K",
    "RowEll",
    "block_row_ptr",
    "bsr_sddmm_kernel",
    "bsr_sddmm_plain",
    "bsr_spmm",
    "bsr_spmm_kernel",
    "bsr_spmm_kernel2",
    "bsr_spmm_plain",
    "bsr_spmm_trainable",
    "build_bsr",
    "build_row_ell",
    "coo_spmm",
    "coo_spmv",
    "reset_launch_counts",
    "row_ell_spmm",
    "row_ell_spmm_program",
    "row_ell_spmv",
    "transpose_bsr_layout",
]
