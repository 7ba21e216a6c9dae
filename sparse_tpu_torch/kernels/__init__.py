"""Compute kernels of sparse_tpu_torch.

``row_ell`` holds the row-ELL layout and the wrappers of its CUDA kernels
(``csrc/row_ell.cu``); ``bsr`` the block-sparse layout, the wrappers of its
CUDA kernels (``csrc/bsr.cu``) and the differentiable BSR products; ``ell``
the block-ELL layouts, their SpMM/SpMV and the block-ELL MTTKRP; ``dot`` the
COO gather + ``index_add_`` products for the dtypes the row-ELL kernels do
not take (``dense_coo_matmul`` too), the sorted-COO MTTKRP, the SDDMM
(``sddmm``, its CUDA kernel in ``csrc/sddmm.cu``, and ``sddmm_plain``), its
gradient's row sum (``sampled_row_sum_plain`` beside its kernel) and
``coo_sum_axes_dense``. Both MTTKRP forms and the SDDMM gradient's row sum
run one CUDA kernel (``csrc/mttkrp.cu``). ``_cuda`` builds and
launches every kernel. ``segment`` (segment reductions, the reductions'
runs), ``elemwise`` (the traceable union of two COO operands) and
``spgemm`` (sparse × sparse, eager and capacity-bounded, with
``product_count``) are torch ops: the JAX package leaves their work to XLA.
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
from .dot import coo_spmm, coo_spmv, coo_sum_axes_dense, dense_coo_matmul, mttkrp, mttkrp_plain, sddmm, sddmm_plain
from .elemwise import coo_elemwise_union
from .segment import segment_reduce, segment_sum_onehot_mm
from .spgemm import esc_spgemm, product_count
from .ell import (
    DEFAULT_BLOCK_ROWS,
    BlockEll,
    BlockEll3d,
    block_ell_3d_runs,
    build_block_ell,
    build_block_ell_3d,
    ell_mttkrp,
    ell_mttkrp_plain,
    ell_spmm,
    ell_spmv,
)
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
    "DEFAULT_BLOCK_ROWS",
    "BlockEll",
    "BlockEll3d",
    "LAUNCHES",
    "ONEHOT_SPMV_MAX_K",
    "RowEll",
    "block_ell_3d_runs",
    "block_row_ptr",
    "bsr_sddmm_kernel",
    "bsr_sddmm_plain",
    "bsr_spmm",
    "bsr_spmm_kernel",
    "bsr_spmm_kernel2",
    "bsr_spmm_plain",
    "bsr_spmm_trainable",
    "build_block_ell",
    "build_block_ell_3d",
    "build_bsr",
    "build_row_ell",
    "coo_elemwise_union",
    "coo_spmm",
    "coo_spmv",
    "coo_sum_axes_dense",
    "dense_coo_matmul",
    "ell_mttkrp",
    "ell_mttkrp_plain",
    "ell_spmm",
    "ell_spmv",
    "esc_spgemm",
    "mttkrp",
    "mttkrp_plain",
    "product_count",
    "reset_launch_counts",
    "row_ell_spmm",
    "row_ell_spmm_program",
    "row_ell_spmv",
    "sddmm",
    "sddmm_plain",
    "segment_reduce",
    "segment_sum_onehot_mm",
    "transpose_bsr_layout",
]
