"""Multi-device execution on ``torch.distributed`` (``sparse_tpu.parallel``'s
functions, ``sharding``'s docstring for the mapping)."""

from .sharding import (  # noqa: F401
    PartitionedCOO,
    assemble_spgemm_result,
    bucket_columns,
    bucket_columns_ell,
    elemwise_partitioned,
    make_mesh,
    mttkrp_sharded,
    mttkrp_sharded_ell,
    partition_coo_rows,
    partition_mttkrp_ell,
    partition_spmm_ell,
    random_partitioned,
    sddmm_sharded,
    spgemm_sharded,
    spmm_2d,
    spmm_2d_ell,
    spmm_replicated,
    spmm_ring,
    spmm_ring_ell,
    spmm_sharded_ell,
    sum_partitioned,
)
