"""Compute kernels of sparse_tpu_torch.

``row_ell`` holds the row-ELL layout and the wrappers of its CUDA kernels
(``csrc/row_ell.cu``); ``bsr`` the block-sparse layout, the wrappers of its
CUDA kernels (``csrc/bsr.cu``) and the differentiable BSR products; ``ell``
the block-ELL layouts, their SpMM/SpMV and the block-ELL MTTKRP; ``dot`` the
COO gather + ``index_add_`` products for the dtypes the row-ELL kernels do
not take (``dense_coo_matmul`` too), the sorted-COO MTTKRP, the SDDMM
(``sddmm``, its CUDA kernel in ``csrc/sddmm.cu``, and ``sddmm_plain``), its
gradient's row sum (``sampled_row_sum_plain`` beside its kernel's three
routes; the union route's layout ``row_sum_union_layout`` and plain
version ``sampled_row_sum_union_plain``) and ``coo_sum_axes_dense``. Both MTTKRP forms and the SDDMM gradient's row sum
run one CUDA kernel (``csrc/mttkrp.cu``). ``attention`` holds the row-ELL
attention, K6 (``ell_attention``, its CUDA kernels in ``csrc/attention.cu``:
the tile route on the tensor cores over a block layout,
``build_attention_blocks``, and the row kernel; ``ell_attention_plain`` and
the tile route's ``ell_attention_blocks_plain``) and its gradient (K6's
backward kernels, its tile route on the same layout and its row kernel,
then K5 by key over ``attention_slot_pattern``;
``ell_attention_backward_plain`` and the tile route's
``ell_attention_backward_blocks_plain``). ``minplus`` holds the
shortest paths' per-destination ELL layout (``build_dest_ell``) and the
min-plus relaxation round, K7 (``minplus_relax``, its CUDA kernel in
``csrc/minplus.cu``, and ``minplus_relax_plain``). ``spgemm`` holds sparse ×
sparse, eager (``spgemm_coords``: S1, its CUDA kernel's two passes in
``csrc/spgemm.cu``, for float32/float64 on the card, the torch ops of
``spgemm`` otherwise) and capacity-bounded (``esc_spgemm``, torch ops), with
``product_count``; ``dia`` the banded layout (``build_dia``) and its shifted
products ``dia_spmv``/``dia_spmm`` and ``dia_spmv_sharded`` with its halos
over the ring (D1, its CUDA kernel in ``csrc/dia.cu``, for float32/float64
on the card; ``_shifted_sum_plain`` otherwise). ``_cuda`` builds and
launches every kernel. ``segment`` (segment reductions, the reductions'
runs), ``elemwise`` (the traceable union of two COO operands) and
``search`` (``searchsorted_sorted_probes`` on ``torch.searchsorted``) are
torch ops: the JAX package leaves their work to XLA.
"""

from .._utils import uncompress_indptr
from ._cuda import LAUNCHES, reset_launch_counts
from .attention import ell_attention, ell_attention_backward_plain, ell_attention_plain
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
from .dia import DiaMatrix, build_dia, dia_spmm, dia_spmv, dia_spmv_sharded
from .dot import coo_spmm, coo_spmv, coo_sum_axes_dense, dense_coo_matmul, mttkrp, mttkrp_plain, sddmm, sddmm_plain
from .elemwise import coo_elemwise_union
from .minplus import DestEll, build_dest_ell, minplus_relax, minplus_relax_plain
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
    "DestEll",
    "DiaMatrix",
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
    "build_dest_ell",
    "build_dia",
    "build_row_ell",
    "coo_elemwise_union",
    "coo_spmm",
    "coo_spmv",
    "coo_sum_axes_dense",
    "dense_coo_matmul",
    "dia_spmm",
    "dia_spmv",
    "dia_spmv_sharded",
    "ell_attention",
    "ell_attention_backward_plain",
    "ell_attention_plain",
    "ell_mttkrp",
    "ell_mttkrp_plain",
    "ell_spmm",
    "ell_spmv",
    "esc_spgemm",
    "minplus_relax",
    "minplus_relax_plain",
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
    "uncompress_indptr",
]
