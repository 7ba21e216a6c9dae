#!/usr/bin/env python3
"""Smoke test of sparse_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source under sparse_tpu_torch/kernels/csrc/, all started together) and
drives the port's two paths on the card:

- the sparse × dense main path: holds the row-ELL kernels against their
  plain PyTorch versions (the SpMM's staged kernel also against its
  one-warp-per-position kernel, and the SpMV's cluster kernel against its
  thread kernel, bit for bit), drives ``COO`` → ``a @ B`` / ``a @ x`` /
  ``matvec_add`` at the benchmark shape (65,536², 2^21 entry draws, N = 128,
  float32) and the spmv_add shape (99,990 × 100,000 at density 1e-6), and
  checks the outputs against a float64 scipy oracle; builds ``CSR`` and
  ``CSC`` arrays of the same matrix on the card and runs their products
  (``csr @ B``, ``csc @ B``, ``csr @ x``, ``csc @ x``, ``matvec_add``)
  through the same kernels, each equal bit for bit to the COO's, the second
  ``csr @ B`` on the held COO's cached layout; then runs both SpMV
  kernels at both shapes in float32 and float64, with and without y, bit
  for bit alike and against the oracle, with the entry point's default and their
  warm and L2-flushed times;
- the block-sparse layer: holds the BSR kernels (the SpMM, its two-block
  form and the block SDDMM on the tensor cores for float32 (3xTF32) and
  bfloat16 and on the CUDA cores for float64) against their plain
  versions in float32, float64 and bfloat16, on the layer's forward, dgrad
  and wgrad operands too (the wgrad's MN-major operands and K-major copies
  of them), then trains ``BlockSparseLinear(8192, 8192,
  block_density=0.25)`` at batch 512 (the JAX package's block-sparse
  training benchmark, bench_suite.py), checks the first step's output and
  both gradients against a float64 oracle, takes three SGD steps on
  which the loss must fall, then 20 more back to back for the steady
  step time, and takes one step of the layer without its transposed
  layout (the torch-op backward, its wgrad on the SDDMM kernel); the SpMM
  is timed against its run piece (forward and dgrad, no split and 32, 16,
  8 blocks);
- the MTTKRP of a 3-D tensor: builds the BASELINE-scale tensor (100,000 x
  2,000 x 2,000, 10M draws, r = 32, float32; bench_suite.py) as a ``COO``
  on the card and its block-ELL layout, holds the MTTKRP kernel against its
  plain version (float32, float64, bf16 tables; both forms), drives
  ``ell_mttkrp`` (exact and bf16), ``kernels.mttkrp`` and ``jitops.mttkrp``
  against a float64 oracle, and the example's shape (1000 x 1000 x 100 at
  density 1e-4, r = 25, float64) against ``np.einsum``; the block-ELL form
  is timed against its run piece (no split and 512, 256, 128 slots);
- the experiments: the one-hot SpMV prototype's full SpMV at the benchmark
  shape through the row-ELL layout (hi|lo and bf16 tables, blocks of 2048
  and 4096 slots) against a float64 oracle and beside K1, and the VMEM
  gather probes p1-p4 and g1-g3 at their own full sizes; each of the eight
  kernels held against its plain version (E1 on both tables and, with a
  table too tall for shared memory, on its L2 route; g1, g1b, g2 and p2
  twice, bit for bit; p4 twice, bit for bit), E1's line with both tables'
  times and designs, p4's with its launch floor, g1's,
  g1b's, p1's and p1b's with their route (column slices in shared memory,
  or L2), p2's with its launch plan and L2 floor, and
  the card's gather rates: p3's write rate beside ``out.zero_()`` on an
  output of its size (the write ceiling), g2's shared-memory pick rate
  beside its first route's whole-row L2 rate, both timed in this run.

- SDDMM (BASELINE config 4, the ``sddmm_path`` line) on the benchmark
  matrix as the mask, K = 128, float32, ``rhs`` given as a transposed
  view: ``sparse_tpu_torch.sddmm`` against a float64 oracle (each entry
  within 1e-5 of |s| · Σ_k |lhs_ik · rhs_kj|), K4 against its plain
  version (2e-6 of the same scale) and twice bit for bit, its kept-row and
  per-entry routes bit for bit alike, the gradient of ``(w ·
  sddmm).sum()`` in s, lhs and rhs (K4 and K5, the gradient's row sum)
  against the plain version's, twice bit for bit, through
  ``kernels.sddmm`` and the COO entry point alike; the same mask with both
  operands MN-major (a weight gradient's layout: the copy rule's route
  and the strided reads it declines, bit for bit alike); the example's
  shape (a 10,000^2 float64 dense pair, a 1,000-entry mask) against its
  oracle at rtol 1e-8, its row-major ``rhs`` read in place; and dense ×
  sparse ``Bt @ a`` (Bt of 128 x 65,536) against a float64 oracle and
  equal bit for bit to ``(a.T @ Bt.T).T``, its route through K2 on the
  cached transpose; K4 timed at both shapes beside
  ``torch.sparse.sampled_addmm``, the backward beside the first port's
  torch ops (device ms and peak memory), each K5 launch beside
  ``torch.sparse.mm`` (the gather route, which the COO entry point's kept
  pattern takes too, bit for bit alike);

- sparse × sparse products (SpGEMM, BASELINE config 2's example; the
  ``spgemm_path`` line): ``a @ a`` of the benchmark matrix (6.7e7 partial
  products) on S1 (``csrc/spgemm.cu``: its symbolic and numeric pass, two
  launches counted, no other kernel) against scipy's ``csr @ csr`` on the
  host (coordinates exactly, values at rtol 1e-5 of a float64 oracle),
  twice bit for bit, and S1 bit for bit against its plain version's torch
  ops on the same inputs; its device ms (median of 5 eager calls), each
  pass's, the plain version's, peak memory, byte bound and
  ``torch.profiler``'s top kernels beside cuSPARSE's ``torch.sparse.mm``
  of the two CSRs; the example's two 100,000² GCXS at density 1e-5
  (float64, two column chunks of S1) as CSR × CSR and CSC × CSC within
  1e-10 of scipy; ``jitops.spgemm`` (the traceable form, torch ops) of two
  4,096² matrices at density 5e-4 captured in a CUDA graph and replayed
  after their values changed, against the eager product;
  ``einsum("ij,jk->ik", s, s)`` bit for bit ``s @ s``;

- the Krylov solvers (the ``linalg_path`` line), float64, on the 5-point
  Poisson matrix at side 1,024: CG through the DIA route, whose matvecs
  launch D1 (``csrc/dia.cu``) once each and no other kernel, and through
  K1 on the permuted matrix, both within 2 · tol of scipy's residual; D1
  bit for bit against its plain torch ops at that shape, timed as a CUDA
  graph beside them, ``torch.mv`` of the CSR and its byte bound; gmres,
  tfqmr, eigsh and spsolve on K1 at sides 256 and 128;

- indexing and the rest of the namespace (the ``indexing_path`` line): a
  GNN-style minibatch of 4,096 rows picked from the benchmark matrix as a
  COO (the leading fast path) and a CSR (``indptr`` spliced), equal to
  scipy's ``A[picks]`` exactly, then ``@ B`` and ``@ x`` on K2 and K1 (their
  counters advance) against a float64 oracle; 4,096 column picks, a 2-D
  slice, ``a[::-1, ::2]`` and two scalars exactly against scipy;
  bench_regression.py's three indexing cases at its 10,000^2 shape;
  ``sort``, ``argmax``, ``unique_counts``, ``nonzero``, ``triu``, ``roll``
  and ``eye(65536) @ B`` at the benchmark shape against host oracles built
  from the stored entries; the npz round trip of the COO and the CSR, bit
  for bit; a DOK of the regression matrix through 1,000 edits against
  scipy's ``dok_array``; each operation's eager and device ms and its
  synchronizing calls, the card's busy share during ``a[picks]``, and
  ``index_select``/``torch.sort`` beside them (timed only). No kernel of
  the package is new here: the JAX package leaves this work to the host;

- sparse attention and graph convolution (the ``attention_path`` line), at
  the full width of public models, float32, 12 heads of 64 a loop at L =
  4,096: Longformer-base's window of 256 each side with one global token on
  the COO route (K4 scores, the segment softmax, K5's weighted sum) and
  without it on the row-ELL route (K6), ``longformer_attention`` and
  ``banded_attention`` (causal too), BigBird's blocks of 64 with 3 random
  blocks through ``block_sparse_attention``; one head at L = 65,536 on K6
  and ``banded_attention``; one head of a scattered pattern (129 random
  columns a row) on K6; ``graph_conv`` at ogbn-arxiv's sizes (169,343
  nodes, 1,166,243 edges drawn from a seed, 128 features, hidden 256). Each
  output against a float64 oracle (dense masked softmax on the card, scipy
  for ``graph_conv``) within 1e-4 · max|v|; K6's tile route (3xTF32) and
  its row kernel each against the plain version (2e-6 · max|v|) and twice
  bit for bit; the blocks each route of K6 took (the window's and the long
  head's on the tiles, the scattered head's on the row kernel); the
  gradients of both routes against the plain versions' (the COO route's and
  ``graph_conv``'s twice bit for bit), each route's launches counted on its
  own; K6's backward kernel (``dq`` and the slot weights of ``dk``/``dv``)
  against ``ell_attention_backward_rows_plain`` and the whole gradient (the
  kernel, then K5 twice over the slots by key) against
  ``ell_attention_backward_plain`` at the window's width in float32 and
  float64, each twice bit for bit; its tile route (float32, 3xTF32 on K6's
  block layout, the row kernel after it on the blocks it leaves) against
  ``ell_attention_backward_blocks_plain`` and the row decomposition, twice
  bit for bit; a 12-head layer's forward and backward on the row-ELL route
  counted (K6, its backward's tiles and row kernel and K5 a head, no plain
  version, the backward's blocks by route); the long head's forward and
  backward on the row-ELL route against the COO route's gradients (1e-4 ·
  max|grad|) and its tile backward's ``dq``, ``ds``, ``p`` against
  ``ell_attention_backward_blocks_plain`` (union chunks, no 17.2 GB block),
  with its time and peak bytes; device ms a head and a 12-head layer (forward, and forward
  with backward), peak memory, and
  ``scaled_dot_product_attention`` with the pattern's dense mask beside them
  (timed only); a sweep of K6's two routes from the window to random
  columns at the same cap against the mean union a block (the route rule);
  K5's routes where these paths run it: ``graph_conv``'s table and its
  backward's column sum on the sliced route (173 MB, past L2), the COO
  route's ``attn @ v`` and ``d k`` on the union route (its blocks' tables
  rows in shared memory), each bit for bit against the gather route and
  twice, against its plain version, timed beside the gather route and
  ``torch.sparse.mm``, with the union layout's build time and bytes;

- the graph algorithms (the ``csgraph_path`` line), float64, on the bench
  graph of bench_suite.py:386-389 (131,072 nodes, 1,048,576 uniform random
  edges, weights U[0.05, 1.05), from a seed): ``dijkstra`` and
  ``bellman_ford`` from 8 sources on K7, the min-plus relaxation kernel
  (its gather route), against scipy at rtol 1e-12 with its ``inf``
  pattern, K7 counted at the rounds + 1 and held bit for bit against its
  plain version (one round over the filled slots and over every slot, the
  fixed point), the layout built once for two calls, the predecessor trees
  through ``reconstruct_path``; ``dijkstra`` from 128 sources on K7's
  sliced route (the table past L2), its fixed point and one round bit for
  bit against the plain version's, counted at the rounds + 1; all sources
  of a 16,384-node graph through ``shortest_path`` on the sliced route (64
  seeded rows against scipy; one round bit for bit against the plain round
  taken a column slice at a time, its whole block would be 34 GB), counted
  at the rounds + 1; PageRank on K1 against a host power iteration; weak
  components, the spanning tree of the symmetrised graph and
  Floyd-Warshall at 1,024 nodes against scipy; K7 timed on each route (and
  on the gather route where the rule slices, its round at 128 and at all
  sources bit for bit against the plain round too) beside ``scatter_reduce_``
  "amin" over the edge list and the plain round, with each bound, the
  layout's count bytes, the solve's wall split into the edge list's read
  back and the loop;

- element-wise operations and reductions (BASELINE config 3, the
  ``elemwise_path`` line): unions, comparisons, a dense row, a broadcast
  sparse column, ufuncs, a cast and the reductions of the bench matrix as
  COO, CSR and CSC, the MTTKRP tensor's sums, max and a dense scale, and
  ``var``/``std`` of a 4,096² matrix, each against a float64 scipy or
  bincount oracle (coordinates exactly, values at rtol 1e-6), the float
  reductions twice bit for bit, each timed (device ms, median of 5 eager
  calls) beside torch.sparse where torch has the operation. No kernel of
  the package runs here: the JAX package leaves this path to XLA.

- the multi-device layer (``sparse_tpu_torch.parallel``, the
  ``parallel_path`` line) on a mesh of one NCCL rank (a process group from
  an in-process ``HashStore``) holding every shard: BASELINE config 5's
  MTTKRP tensor in 1 and 4 shards through ``mttkrp_sharded_ell`` (E2 once
  a shard) and ``mttkrp_sharded`` (K3 once a shard), each against the
  unsharded call (one shard the same bits, four within 1e-5); on the bench
  matrix in 4 shards ``sddmm_sharded`` (K4 once a shard, K = 128) within
  1e-5 of ``|s|·Σ|lhs·rhs|``, ``spmm_sharded_ell``, ``spmm_replicated``,
  ``spmm_ring`` (the dense operand a DTensor sharded over K) and
  ``spmm_ring_ell`` (a ring of one) against ``a @ B`` on K2, the sums
  against a float64 bincount, ``elemwise_partitioned`` exactly as
  ``a + a.T``; ``spgemm_sharded`` at 4,096² against ``a4 @ a4``; the bench
  partition's checkpoint round trip; ``profiling.benchmark`` beside
  ``time_graph`` on K2 and ``profiling.trace`` of one sharded MTTKRP naming
  E2's kernel once a shard; each sharded call's wall and device ms (median
  of 5 eager calls) beside the unsharded call's, one line a pair.

- the partitioned forms (the ``partitioned_path`` line) on the same world
  of one, at the unsharded paths' shapes: ``bellman_ford_partitioned`` on
  the bench graph from 8 sources with predecessors (K7 once a round, the
  unsharded solve's count; distances and predecessors bit for bit
  ``bellman_ford``'s and ``dijkstra``'s), ``pagerank_partitioned`` (K1 once
  an iteration, within 1e-12 of max |p| of ``pagerank``, its bits
  reported), ``dia_spmv_sharded`` on the Poisson matrix at side 1,024 (bit
  for bit ``dia_spmv``), CG to 1e-8 on ``partitioned_matvec`` over 4 row
  shards (its true residual, its iterations beside K1's solve),
  ``banded_attention_sharded`` (causal and not) and
  ``sparse_attention_sharded`` in 4 shards (K4 and K5 once a shard) at the
  attention head's shape within 1e-4 · max|v| of the unsharded calls;
  ``entry()``'s step against its plain version and
  ``dryrun_multichip(1)``; each call's wall and device ms beside the
  unsharded call's, one line a pair; the path's launches join the K7, K1,
  K4 and K5 rows of the ``kernels`` line (``partitioned_path_launches``).

- the host path (the ``host_path`` line), on the machine's CPU: builds the
  host library (``sparse_tpu_torch/native``, g++), prints g++'s first line,
  the CPU model and the thread counts, and runs its call sites at the
  benchmark shape in float32 on both CPU routes (the library, and the
  plain torch ops with every threshold past the size): the canonical COO
  from the shuffled draws with duplicates, ``a @ B`` (N = 128), ``a @ x``,
  ``matvec_add``, ``a + a.T`` and ``a @ a``. The COO, ``a + a.T`` and ``a @ a``
  are bit for bit the plain route's; the products within float32's
  tolerance of it and of the float64 oracle. The library's call counters
  move on its route and stay at 0 on the other; each call's host ms (median
  of 3 on the library, one call on the plain route) stands beside the
  card's name and power limit. An integer MTTKRP on the card launches no
  kernel and equals the CPU's.

The launch counters show that each path ran its kernels; each kernel is
timed beside its plain version, one library call on the same inputs
(torch.sparse, which reaches cuSPARSE or torch's own kernels; timed here
only, the package never calls it) and its bound.

Output: one JSON line per phase and per kernel, then one line
``{"kernels": [...]}``, then the card's ``name, power.limit`` from
nvidia-smi, and last ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero before that line; so does a machine without a CUDA device.
Imports nothing of JAX or sparse_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from sparse_tpu_torch.experiments.common import REPS, WARMUP, time_graph

M = K = 1 << 16  # benchmark shape (bench.py)
NNZ_DRAWS = 1 << 21
BENCH_NNZ = 2_096_628  # the canonical COO of those draws (seed 0)
N = 128
SPMV_ADD_SHAPE = (99_990, 100_000)  # spmv_add example
SPMV_ADD_DENSITY = 1e-6

# published H100 SXM peaks at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # tensor cores, dense; float32 products at HIGHEST take three passes (3xTF32)
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense

# kernel vs plain: the two sum each row in another order (the kernel
# sequentially with FMAs, the plain version by torch's reduction)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}
# against the float64 oracle (bench.py's check)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-5)

SOURCE = {
    "row_ell_spmv": "sparse_tpu_torch/kernels/csrc/row_ell.cu",
    "row_ell_spmv_cluster": "sparse_tpu_torch/kernels/csrc/row_ell.cu",
    "row_ell_spmm": "sparse_tpu_torch/kernels/csrc/row_ell.cu",
    "bsr_spmm": "sparse_tpu_torch/kernels/csrc/bsr_tc.cu",  # float32 and bfloat16; float64 stays in bsr.cu
    "bsr_spmm2": "sparse_tpu_torch/kernels/csrc/bsr_tc.cu",  # float32 and bfloat16; float64 stays in bsr.cu
    "bsr_sddmm": "sparse_tpu_torch/kernels/csrc/bsr_tc.cu",  # float32 and bfloat16; float64 stays in bsr.cu
    "ell_mttkrp": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",
    "coo_mttkrp": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",
    **{
        k: "sparse_tpu_torch/kernels/csrc/probes.cu"
        for k in (
            "spmv_products",
            "lane_gather",
            "row_gather_sum",
            "row_pick_bf16",
            "scalar_gather_sum",
            "lane_gather_blocksum",
            "row_pick_blocksum",
            "pick_scale_wsum",
        )
    },
    "sddmm": "sparse_tpu_torch/kernels/csrc/sddmm.cu",
    "sampled_row_sum": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",  # K5's gather route
    "sampled_row_sum_sliced": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",  # K5's sliced route
    "sampled_row_sum_union": "sparse_tpu_torch/kernels/csrc/mttkrp.cu",  # K5's union route
    "ell_attention": "sparse_tpu_torch/kernels/csrc/attention.cu",
    "ell_attention_tiles": "sparse_tpu_torch/kernels/csrc/attention.cu",
    "ell_attention_backward": "sparse_tpu_torch/kernels/csrc/attention.cu",
    "ell_attention_backward_tiles": "sparse_tpu_torch/kernels/csrc/attention.cu",
    "minplus_relax": "sparse_tpu_torch/kernels/csrc/minplus.cu",
    "dia_spmv": "sparse_tpu_torch/kernels/csrc/dia.cu",
    "spgemm": "sparse_tpu_torch/kernels/csrc/spgemm.cu",
}
REPLACES = {
    "row_ell_spmv": "sparse_tpu/kernels/row_ell.py:231",  # _onehot_products_call (Pallas)
    "row_ell_spmv_cluster": "sparse_tpu/kernels/row_ell.py:231",  # the same, x in a cluster's shared memory
    "row_ell_spmm": "sparse_tpu/kernels/row_ell.py:198",  # _spmm (XLA)
    "bsr_spmm": "sparse_tpu/kernels/bsr.py:168",  # bsr_spmm_pallas (Pallas P2)
    "bsr_spmm2": "sparse_tpu/kernels/bsr.py:235",  # bsr_spmm_pallas2 (Pallas P3)
    "bsr_sddmm": "sparse_tpu/kernels/bsr.py:341",  # bsr_sddmm_pallas (Pallas P4)
    "ell_mttkrp": "experiments/mttkrp_onehot.py:38",  # products_call (Pallas E2), for ell_mttkrp
    "coo_mttkrp": "sparse_tpu/kernels/dot.py:132",  # mttkrp (XLA segment_sum)
    "spmv_products": "experiments/pallas_spmv_onehot.py:77",  # products_kernel (Pallas E1)
    "lane_gather": "experiments/pallas_vmem.py:76",  # p1 (E3)
    "row_gather_sum": "experiments/pallas_vmem.py:121",  # p2 (E4)
    "row_pick_bf16": "experiments/pallas_vmem.py:166",  # p3 (E5)
    "scalar_gather_sum": "experiments/pallas_vmem.py:209",  # p4 (E6)
    "lane_gather_blocksum": "experiments/pallas_vmem2.py:69",  # g1 (E7)
    "row_pick_blocksum": "experiments/pallas_vmem2.py:107",  # g2 (E8)
    "pick_scale_wsum": "experiments/pallas_vmem2.py:146",  # g3 (E9)
    "sddmm": "sparse_tpu/kernels/dot.py:103",  # sddmm (XLA gather + sum)
    "sampled_row_sum": "sparse_tpu/kernels/dot.py:124",  # the transpose of sddmm's gathers (XLA segment sum)
    "sampled_row_sum_sliced": "sparse_tpu/kernels/dot.py:124",  # the same function, K5's sliced route
    "sampled_row_sum_union": "sparse_tpu/kernels/dot.py:124",  # the same function, K5's union route
    "ell_attention": "sparse_tpu/nn.py:282",  # sparse_attention_ell (XLA gather, score, masked softmax, weighted sum)
    "ell_attention_tiles": "sparse_tpu/nn.py:282",  # the same function, its tile route
    "ell_attention_backward": "sparse_tpu/nn.py:282",  # the gradient of sparse_attention_ell (jax.grad through the XLA code)
    "ell_attention_backward_tiles": "sparse_tpu/nn.py:282",  # the same gradient, its tile route
    "minplus_relax": "sparse_tpu/csgraph.py:228",  # _bellman_ford_device_ell and its _tail form :255 (XLA)
    "dia_spmv": "sparse_tpu/kernels/dia.py:67",  # dia_spmv (XLA shifted multiply-adds; dia_spmm :147 alike)
    "spgemm": "sparse_tpu/kernels/spgemm.py:124",  # esc_spgemm (XLA) and the eager ops/dot.py:_spgemm :738
}

# the block-sparse layer at full width (bench_suite.py:324-339): 8192 x 8192,
# 25 % of the 128 x 128 blocks, batch 512, float32
LAYER_IN = LAYER_OUT = 8192
LAYER_DENSITY = 0.25
LAYER_BATCH = 512
LAYER_LR = 0.02  # SGD on the per-sample summed squared error; stable below ~0.08 at this width
# BSR kernel vs plain, unit-normal inputs (the two sum in another order)
BSR_TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-4),
    torch.float64: dict(rtol=1e-10, atol=1e-12),
    torch.bfloat16: dict(rtol=2e-2, atol=2e-2),  # one final rounding each side
}
# the training step against the float64 oracle: max|got - want| / max|want|
LAYER_ORACLE_TOL = 1e-4
# the float32 SDDMM (3xTF32) at the layer shape against its plain version, normalised as above
SDDMM_NORM_TOL = 1e-5
STEADY_STEPS = 20  # SGD steps timed back to back after the checked ones

# MTTKRP at the BASELINE scale (bench_suite.py:227-253): 100k x 2k x 2k from
# 10M draws of np.random.default_rng(0), r = 32, float32; not cut
MT_I, MT_J, MT_K, MT_R = 100_000, 2000, 2000, 32
MT_DRAWS = 10_000_000
# against the float64 oracle, max|got - want| / max|want|: exact f32, and the
# bf16 strategy's grade (tests/test_kernels.py:317)
MT_ORACLE_TOL = {"exact": 1e-5, "bf16": 3e-2}
# the example's shape (examples/mttkrp_example.py:17-41), float64, its own limit
EX_SHAPE, EX_DENSITY, EX_R, EX_RTOL = (1000, 1000, 100), 1e-4, 25, 1e-8

# SDDMM (BASELINE config 4) on the bench matrix as the mask: lhs (65,536,
# 128) and rhs (128, 65,536) given as a transposed view, float32, from a
# seeded torch.Generator (sparse_tpu/kernels/dot.py:91-95's large shape).
# Against a float64 oracle each entry within SD_ORACLE_TOL · |s| · Σ_k
# |lhs_ik · rhs_kj|; K4 against its plain version within SD_PLAIN_TOL of the
# same scale; the gradients of (w · sddmm).sum() against the plain version's
# at max|got - want| / max|want| <= SD_GRAD_TOL
SD_K = 128
SD_NARROW_K = 64  # K5's union route on the bench mask's kept pattern: rows of 256 bytes, every block flagged
K5_ALL_FLAGGED_SLACK = 1.05  # there the union route's two launches within 5 % of the gather route alone
SD_ORACLE_TOL, SD_PLAIN_TOL, SD_GRAD_TOL = 1e-5, 2e-6, 1e-5
# the example's shape (examples/sddmm_example.py): a 10,000^2 float64 dense
# pair and a mask of 1,000 entries, its own limit
SD_EX_LEN, SD_EX_NNZ, SD_EX_RTOL = 10_000, 1000, 1e-8

# the one-hot SpMV prototype against the float64 oracle, max|out - oracle| /
# max|oracle|, by table (the prototype's docstring: ~1e-5 and ~2e-3)
E1_ORACLE_TOL = {"hilo": 1e-4, "bf16": 1e-2}
# probe sums against their plain versions: up to 8,192 positive terms, about
# 4e3 at most, added in another order
PROBE_TOL = dict(rtol=1e-4, atol=1e-3)
L2_ROW_BYTES = 128 * 4  # one picked f32 table row
L2_ROW_BYTES_PER_S = 7.3e12  # the card's whole-row L2 rate (PERF.md §5), E4's floor


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_name_power():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return res.stdout.strip().splitlines()[0]


def problem(case, rng):
    """``(rows, cols, m, k)`` of a test matrix; rows/cols int64, unique entries."""
    if case == "zipf":
        m, k = 2000, 1500
        raw = rng.zipf(1.4, size=60_000)
        rows = raw[raw <= m] - 1
        lin = np.unique(rows * k + rng.integers(0, k, size=rows.size))
    elif case == "empty":
        m, k = 10, 7
        lin = np.zeros(0, dtype=np.int64)
    elif case == "k_ragged":
        m, k = 500, 1001
        lin = np.unique(rng.integers(0, m * k, size=5000))
    elif case == "zero_rows":
        m, k = 1000, 800
        lin = np.unique(rng.integers(0, m * k, size=8000))
        lin = lin[(lin // k) % 3 == 0]
    elif case == "hub":
        m, k = 200, 5000
        hub = 17 * k + rng.choice(k, size=2000, replace=False)
        lin = np.unique(np.concatenate([hub, rng.integers(0, m * k, size=300)]))
    elif case == "bench":
        m, k = M, K
        lin = np.unique(rng.integers(0, m * k, size=NNZ_DRAWS))
    else:
        raise ValueError(case)
    return lin // k, lin % k, m, k


def check_close(name, got, want, tol):
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def phase_kernels_vs_plain(dev):
    """K1 and K2 against their plain versions on the card, f32 and f64; K2's
    staged kernel equal bit for bit to its one-warp-per-position kernel, K1's
    cluster kernel to its thread kernel."""
    from sparse_tpu_torch.kernels import _cuda, row_ell

    rng = np.random.default_rng(1)
    errs = {"row_ell_spmv": 0.0, "row_ell_spmv_cluster": 0.0, "row_ell_spmm": 0.0}
    for case in ("zipf", "empty", "k_ragged", "zero_rows", "hub", "bench"):
        rows, cols, m, k = problem(case, rng)
        # positive values: no cancellation, so the relative tolerance holds
        vals = rng.random(rows.size)
        for dt in (torch.float32, torch.float64):
            np_dt = np.float32 if dt == torch.float32 else np.float64
            re = row_ell.build_row_ell(rows, cols, vals.astype(np_dt), m, k, device=dev)
            widths = [N, 37] if case != "bench" else [N]  # 37: ragged N, one value per lane
            for n in widths:
                b = torch.as_tensor(rng.random((k, n)), dtype=dt, device=dev)
                got = row_ell.row_ell_spmm(re, b)
                e = check_close(f"spmm {case} {dt} N={n}", got, row_ell._spmm_plain(re, b), TOL[dt])
                if _cuda.row_ell_staged_layout(re):
                    outs = [_cuda.spmm(re, b, torch.empty_like(got), kernel=kn) for kn in ("staged", "warp")]
                    if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], got)):
                        raise AssertionError(f"spmm {case} {dt} N={n}: the staged and warp kernels differ")
                if case == "bench" and dt == torch.float32:
                    errs["row_ell_spmm"] = e
            x = torch.as_tensor(rng.random(k), dtype=dt, device=dev)
            y = torch.as_tensor(rng.random(m), dtype=dt, device=dev)
            e = check_close(f"spmv {case} {dt}", row_ell.row_ell_spmv(re, x), row_ell._spmv_plain(re, x), TOL[dt])
            e_y = check_close(
                f"spmv+y {case} {dt}", row_ell.row_ell_spmv(re, x, y=y), row_ell._spmv_plain(re, x, y), TOL[dt]
            )
            k1 = {}
            for yy in (None, y):
                k1[yy is None] = [_cuda.spmv(re, x, yy, torch.empty(m, dtype=dt, device=dev), kernel=kn) for kn in ("thread", "cluster")]
                if not torch.equal(*k1[yy is None]):
                    raise AssertionError(f"spmv {case} {dt} y={yy is not None}: the cluster and thread kernels differ")
            if case == "bench" and dt == torch.float32:
                errs["row_ell_spmv"] = max(e, e_y)
                errs["row_ell_spmv_cluster"] = max(
                    check_close("spmv cluster", k1[True][1], row_ell._spmv_plain(re, x), TOL[dt]),
                    check_close("spmv+y cluster", k1[False][1], row_ell._spmv_plain(re, x, y), TOL[dt]),
                )
            torch.cuda.synchronize()
        log(f"kernel_vs_plain {case}: m={m} k={k} nnz={rows.size} ok")
    return errs


def oracle_csr(rows, cols, data, shape):
    import scipy.sparse

    return scipy.sparse.csr_matrix((data.astype(np.float64), (rows, cols)), shape=shape)


def phase_main_path(dev):
    """The main path through the public entry points, counted."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

    rng = np.random.default_rng(0)
    # raw draws: unsorted, with duplicates, so the constructor sorts and sums
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    rows, cols = lin // K, lin % K
    data = rng.random(NNZ_DRAWS, dtype=np.float32)
    b_np = rng.random((K, N), dtype=np.float32)
    x_np = rng.random(K, dtype=np.float32)
    m2, k2 = SPMV_ADD_SHAPE
    lin2 = np.unique(rng.integers(0, m2 * k2, size=round(m2 * k2 * SPMV_ADD_DENSITY)))
    rows2, cols2 = lin2 // k2, lin2 % k2
    data2 = rng.random(lin2.size)
    x2 = rng.random(k2)
    y2 = rng.random(m2)
    b = torch.as_tensor(b_np, device=dev)
    x = torch.as_tensor(x_np, device=dev)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    a = st.COO(np.stack([rows, cols]), data, shape=(M, K), device=dev)
    torch.cuda.synchronize()
    t_coo = time.perf_counter()
    out1 = a @ b
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    layout = a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
    out2 = a @ b
    torch.cuda.synchronize()
    t_second = time.perf_counter()
    if layout is None or a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY) is not layout:
        raise AssertionError("the second a @ b did not reuse the cached row-ELL layout")
    outv = a @ x
    a2 = st.COO(np.stack([rows2, cols2]), data2, shape=(m2, k2), device=dev)
    outa = st.matvec_add(a2, x2, y2)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for name in ("row_ell_spmv", "row_ell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}: {launches}")
    for name, t, shape in (("a@B", out1, (M, N)), ("a@B again", out2, (M, N)), ("a@x", outv, (M,)), ("matvec_add", outa, (m2,))):
        if tuple(t.shape) != shape or t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} on {t.device}, finite={bool(torch.isfinite(t).all())}")
    if not torch.equal(out1, out2):
        raise AssertionError("a @ b differs between the first and the cached-layout call")

    ref = oracle_csr(rows, cols, data, (M, K))
    np.testing.assert_allclose(out1.cpu().numpy(), ref @ b_np.astype(np.float64), **ORACLE_TOL)
    np.testing.assert_allclose(outv.cpu().numpy(), ref @ x_np.astype(np.float64), **ORACLE_TOL)
    ref2 = oracle_csr(rows2, cols2, data2, (m2, k2))
    np.testing.assert_allclose(outa.cpu().numpy(), ref2 @ x2 + y2, rtol=1e-12, atol=0)

    log(
        json.dumps(
            {
                "main_path": "ok",
                "nnz": a.nnz,
                "launches": launches,
                "coo_build_s": t_coo - t0,
                "first_matmul_s_incl_layout_build": t_first - t_coo,
                "second_matmul_s": t_second - t_first,
                "total_s": t_end - t0,
                "peak_memory_bytes": peak,
                "spmv_add_nnz": a2.nnz,
            }
        )
    )
    return a, layout, b, x, launches


def phase_gcxs_path(dev, a, b, x):
    """CSR and CSC at the benchmark shape through the public entry points,
    counted: each built from the COO ``a`` on the card (``a.asformat("csr")``,
    ``CSC(a)``), then ``csr @ B``, ``csc @ B``, ``csr @ x``, ``csc @ x`` and
    ``matvec_add`` of both, each equal bit for bit to the COO's product and
    within ORACLE_TOL of a float64 oracle; the second ``csr @ B`` runs on the
    held COO's cached layout, and ``csr.tocoo()`` and ``csc.tocoo()`` equal
    ``a``."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

    y = torch.as_tensor(np.random.default_rng(5).random(M, dtype=np.float32), device=dev)
    want = {"B": a @ b, "x": a @ x, "x+y": st.matvec_add(a, x, y)}
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    csr = a.asformat("csr")
    torch.cuda.synchronize()
    t_csr = time.perf_counter()
    csc = st.CSC(a)
    torch.cuda.synchronize()
    t_csc = time.perf_counter()
    outs = {"csr@B": csr @ b}
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    held = csr._product_coo()
    layout = held.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
    outs["csr@B again"] = csr @ b
    torch.cuda.synchronize()
    t_second = time.perf_counter()
    reused = csr._product_coo() is held and held.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY) is layout
    if layout is None or not reused:
        raise AssertionError("the second csr @ B did not reuse the held COO's cached row-ELL layout")
    outs["csc@B"] = csc @ b
    torch.cuda.synchronize()
    t_csc_first = time.perf_counter()
    outs["csr@x"] = csr @ x
    outs["csc@x"] = csc @ x
    outs["matvec_add csr"] = st.matvec_add(csr, x, y)
    outs["matvec_add csc"] = st.matvec_add(csc, x, y)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(LAUNCHES)

    for name in ("row_ell_spmv", "row_ell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"the GCXS path never launched {name}: {launches}")
    coords, data = a.coords.cpu().numpy(), a.data.cpu().numpy()
    ref = oracle_csr(coords[0], coords[1], data, (M, K))
    oracle = {"B": ref @ b.cpu().numpy().astype(np.float64), "x": ref @ x.cpu().numpy().astype(np.float64)}
    oracle["x+y"] = oracle["x"] + y.cpu().numpy()
    for name, got in outs.items():
        key = "B" if name.endswith(("B", "again")) else ("x+y" if name.startswith("matvec") else "x")
        if got.device.type != "cuda" or not torch.equal(got, want[key]):
            raise AssertionError(f"{name}: not equal bit for bit to the COO's product")
        np.testing.assert_allclose(got.cpu().numpy(), oracle[key], **ORACLE_TOL, err_msg=name)
    for name, g in (("csr", csr), ("csc", csc)):
        back = g.tocoo()
        if not (torch.equal(back.coords, a.coords) and torch.equal(back.data, a.data)):
            raise AssertionError(f"{name}.tocoo() differs from the COO it was built from")
    log(
        json.dumps(
            {
                "gcxs_path": "ok",
                "nnz": csr.nnz,
                "launches": launches,
                "csr_build_s": t_csr - t0,
                "csc_build_s": t_csc - t_csr,
                "first_csr_matmul_s_incl_layout_build": t_first - t_csc,
                "second_csr_matmul_s": t_second - t_first,
                "first_csc_matmul_s_incl_coo_and_layout_build": t_csc_first - t_second,
                "total_s": t_end - t0,
                "index_dtypes": {"indices": str(csr.indices.dtype), "indptr": str(csr.indptr.dtype)},
            }
        )
    )
    return launches


def phase_k1(dev, card):
    """K1's two kernels at the bench shape and the spmv_add shape, float32 and
    float64, with and without y, through ``_cuda.spmv(kernel=...)``: equal bit
    for bit, each within the float64 oracle's rtol (bench.py:53), the kernel
    that ``row_ell_spmv`` launches by default, and each kernel's time warm
    (CUDA graph, in turns) and after an L2 flush. One JSON line each shape and
    dtype. Returns the launches of this path (the counts are set to 0 before
    each shape and dtype's calls and read after them, before the timing):
    both kernels must have run."""
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts, row_ell

    counted = dict.fromkeys(LAUNCHES, 0)
    rng = np.random.default_rng(3)
    m2, k2 = SPMV_ADD_SHAPE
    shapes = {"bench": (M, K, NNZ_DRAWS), "spmv_add": (m2, k2, round(m2 * k2 * SPMV_ADD_DENSITY))}
    for shape, (m, k, draws) in shapes.items():
        lin = np.unique(rng.integers(0, m * k, size=draws, dtype=np.int64))
        rows, cols = lin // k, lin % k
        vals, x_np, y_np = rng.random(lin.size), rng.random(k), rng.random(m)
        for dt, np_dt in ((torch.float32, np.float32), (torch.float64, np.float64)):
            ref = oracle_csr(rows, cols, vals.astype(np_dt), (m, k))
            want = ref @ x_np.astype(np_dt).astype(np.float64)
            re = row_ell.build_row_ell(rows, cols, vals.astype(np_dt), m, k, device=dev)
            x = torch.as_tensor(x_np, dtype=dt, device=dev)
            y = torch.as_tensor(y_np, dtype=dt, device=dev)
            rel, outs = {}, {}
            torch.cuda.synchronize()
            reset_launch_counts()
            for yy, w in ((None, want), (y, want + y_np.astype(np_dt))):
                pair = [_cuda.spmv(re, x, yy, torch.empty(m, dtype=dt, device=dev), kernel=kn) for kn in ("thread", "cluster")]
                if not torch.equal(*pair):
                    raise AssertionError(f"K1 {shape} {dt} y={yy is not None}: the cluster and thread kernels differ")
                got = pair[1].cpu().numpy().astype(np.float64)
                np.testing.assert_allclose(got, w, **ORACLE_TOL, err_msg=f"K1 {shape} {dt}")
                outs[yy is None] = pair[0]
                rel["y" if yy is not None else "no_y"] = float(np.abs(got - w).max() / max(np.abs(w).max(), 1e-300))
            # the kernel the entry point launches by default, read from the counters
            before = dict(LAUNCHES)
            if not torch.equal(row_ell.row_ell_spmv(re, x), outs[True]):
                raise AssertionError(f"K1 {shape} {dt}: row_ell_spmv differs from the thread kernel")
            default = [kn for kn in ("row_ell_spmv", "row_ell_spmv_cluster") if LAUNCHES[kn] > before[kn]]
            torch.cuda.synchronize()
            counted = {kn: counted[kn] + LAUNCHES[kn] for kn in counted}
            out = torch.empty(m, dtype=dt, device=dev)
            runs = {kn: (lambda kn=kn: _cuda.spmv(re, x, None, out, kernel=kn)) for kn in ("thread", "cluster")}
            ms = {}
            for order in (list(runs), list(runs)[::-1]):
                for kn in order:
                    ms[kn] = min(time_graph(runs[kn]), ms.get(kn, float("inf")))
            cold = {kn: time_cold(fn) for kn, fn in runs.items()}
            # cols + values read, touched values of x read, out written
            nbytes = (lin.size * (4 + dt.itemsize) + np.unique(cols).size * dt.itemsize + m * dt.itemsize)
            log(
                json.dumps(
                    {
                        "k1": shape,
                        "dtype": str(dt).replace("torch.", ""),
                        "nnz": int(lin.size),
                        "default": default,
                        "plan": _cuda.row_ell_spmv_plan(re, dt)._asdict(),
                        "equal_bit_for_bit": True,
                        "max_rel_err_vs_f64_oracle": rel,
                        "kernel_ms": ms,
                        "kernel_ms_l2_flushed": cold,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                        "bound_share": {kn: nbytes / HBM_BYTES_PER_S * 1e3 / v for kn, v in ms.items()},
                        "card": card,
                    }
                )
            )
            del re, x, y, out
        torch.cuda.empty_cache()
    for name in ("row_ell_spmv", "row_ell_spmv_cluster"):
        if counted[name] == 0:
            raise AssertionError(f"the K1 phase never launched {name}: {counted}")
    log(json.dumps({"k1_path": "ok", "launches": counted}))
    return counted


def time_eager(fn, reps=20):
    """ms per call of ``fn`` from CUDA events around ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold(fn, reps=20):
    """Median device ms of one call of ``fn`` after a 256 MB write has
    flushed the 50 MB L2 (events around the call alone). A spin of about a
    millisecond after the flush keeps the card busy while the host enqueues
    the call, so the host's time to launch stays out of the reading."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def gathered_rows(re):
    """Rows of B that K2 gathers: its tier's width for every position that
    is not group padding."""
    table = re.tier_table.cpu().tolist()
    return sum(int((re.row_of_pos[p0:nxt[0]] >= 0).sum()) * w for (p0, w, _, _), nxt in zip(table, table[1:]))


def phase_times(a, re, b, x, launches, errs, card):
    from sparse_tpu_torch.kernels import _cuda, row_ell

    csr = torch.sparse_coo_tensor(a.coords.long(), a.data, (M, K)).coalesce().to_sparse_csr()
    nnz = a.nnz
    touched = int(torch.unique(a.coords[1]).numel())
    y = torch.rand(M, device=b.device)
    out_m = torch.empty((M, N), device=b.device)
    out_v = torch.empty(M, device=b.device)
    lines = []
    specs = [
        (
            "row_ell_spmm",
            lambda: _cuda.spmm(re, b, out_m),
            lambda: row_ell.row_ell_spmm(re, b),
            lambda: row_ell._spmm_plain(re, b),
            lambda: csr @ b,
            # cols + values read, touched rows of B read, out written
            nnz * 8 + touched * N * 4 + M * N * 4,
            2 * nnz * N,
        ),
        (
            "row_ell_spmv",
            lambda: _cuda.spmv(re, x, None, out_v),
            lambda: row_ell.row_ell_spmv(re, x),
            lambda: row_ell._spmv_plain(re, x),
            lambda: torch.mv(csr, x),
            nnz * 8 + touched * 4 + M * 4,
            2 * nnz,
        ),
        (
            "row_ell_spmv_cluster",
            lambda: _cuda.spmv(re, x, None, out_v, kernel="cluster"),
            # the entry point that asks for the cluster kernel
            lambda: _cuda.spmv(re, x, None, torch.empty_like(out_v), kernel="cluster"),
            lambda: row_ell._spmv_plain(re, x),
            lambda: torch.mv(csr, x),
            nnz * 8 + touched * 4 + M * 4,
            2 * nnz,
        ),
    ]
    # K2's staged kernel beside its warp kernel, in turns, float32 and float64
    b64, out64 = b.double(), out_m.double()
    re64 = re._replace(flat_data=re.flat_data.double())
    k2_runs = {
        f"{kn}_{tag}": (lambda kn=kn, r=r, bb=bb, o=o: _cuda.spmm(r, bb, o, kernel=kn))
        for tag, r, bb, o in (("f32", re, b, out_m), ("f64", re64, b64, out64))
        for kn in ("staged", "warp")
    }
    k2_ms = {}
    for order in (list(k2_runs), list(k2_runs)[::-1]):
        for key in order:
            k2_ms[key] = min(time_graph(k2_runs[key]), k2_ms.get(key, float("inf")))
    rows_gathered = gathered_rows(re)
    plan = _cuda.row_ell_plan(re, N, 4, torch.float32)
    k2_extra = {
        "gathered_bytes": rows_gathered * N * 4,
        "kernel_ms_by_kernel": k2_ms,
        "plan": plan._asdict(),
        "gathered_tb_per_s_by_kernel": {
            k: rows_gathered * N * (8 if k.endswith("f64") else 4) / (v * 1e-3) / 1e12 for k, v in k2_ms.items()
        },
    }
    del b64, out64, re64

    for name, launch, wrapper, plain, library, nbytes, flops in specs:
        torch.cuda.reset_peak_memory_stats()
        ms = time_graph(launch)
        peak_kernel = torch.cuda.max_memory_allocated()
        ms_wrapper = time_eager(wrapper, reps=50)
        ms_cold = time_cold(launch)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_eager(plain, reps=5)
        peak_plain = torch.cuda.max_memory_allocated()
        library_ms = time_eager(library, reps=20)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lines.append(line)
        extra = {}
        if name == "row_ell_spmm":
            extra = {**k2_extra, "gathered_tb_per_s": k2_extra["gathered_bytes"] / (ms * 1e-3) / 1e12}
        log(
            json.dumps(
                {
                    **line,
                    "kernel_ms": ms,
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    # everything allocated so far plus what the timed calls allocate
                    "peak_memory_bytes_kernel": peak_kernel,
                    "peak_memory_bytes_plain": peak_plain,
                    "shape": {"m": M, "k": K, "n": N if name == "row_ell_spmm" else 1, "nnz": nnz, "dtype": "float32"},
                    **({"plan": _cuda.row_ell_spmv_plan(re, torch.float32)._asdict()} if name == "row_ell_spmv_cluster" else {}),
                    **extra,
                    "card": card,
                }
            )
        )
    return lines


def bsr_problem(case, rng, dev):
    """``(layout, m, k)`` of a BSR test matrix with unit-normal values."""
    from sparse_tpu_torch.kernels import bsr

    m, k, density, block_shape, pad = {
        "test_bsr": (500, 600, 0.02, (128, 128), 1),  # tests/test_bsr.py's ragged problem
        "empty": (128, 128, 0.0, (128, 128), 1),  # the single zero block
        "pad2": (500, 600, 0.02, (128, 128), 2),
        "block_32x64": (200, 300, 0.03, (32, 64), 1),
    }[case]
    lin = rng.choice(m * k, size=round(m * k * density), replace=False)
    layout = bsr.build_bsr(lin // k, lin % k, rng.standard_normal(lin.size), (m, k), block_shape, pad, device=dev)
    return layout, m, k


def layer_layout(dev):
    """The full-width layer, its input and its weighted-sum gradient: seeded."""
    from sparse_tpu_torch import nn

    layer = nn.BlockSparseLinear(
        LAYER_IN, LAYER_OUT, LAYER_DENSITY, generator=torch.Generator().manual_seed(0), device=dev
    )
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((LAYER_BATCH, LAYER_IN), dtype=np.float32), device=dev)
    target = torch.as_tensor(rng.standard_normal((LAYER_BATCH, LAYER_OUT), dtype=np.float32), device=dev)
    wsum = torch.as_tensor(rng.standard_normal((LAYER_BATCH, LAYER_OUT), dtype=np.float32), device=dev)
    return layer, x, target, wsum


def phase_bsr_kernels_vs_plain(dev, layer, x, wsum):
    """The three BSR kernels against their plain versions on the card, in
    float32, float64 and bfloat16: ragged edges, an empty matrix, a padded
    layout through both SpMMs, a (32, 64) block shape, transposed-view
    operands, a ragged SDDMM contraction, and the full-width layer (its
    wgrad also on K-major copies of its operands: the same result)."""
    from sparse_tpu_torch.kernels import _cuda, bsr

    rng = np.random.default_rng(2)
    errs = {"bsr_spmm": 0.0, "bsr_spmm2": 0.0, "bsr_sddmm": 0.0}
    sddmm_norm, sddmm_layouts_equal = {}, {}
    _cuda.reset_launch_counts()
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        tol = BSR_TOL[dt]
        for case in ("test_bsr", "empty", "pad2", "block_32x64"):
            a, m, k = bsr_problem(case, rng, dev)
            blocks = a.blocks.to(dt)
            for n, transposed in ((200, False), (37, False), (37, True)):
                d = torch.as_tensor(rng.standard_normal((n, k) if transposed else (k, n)), device=dev).to(dt)
                d = d.T if transposed else d
                want = bsr.bsr_spmm_plain(a.block_rows, a.block_cols, blocks, d, n_rows=m)
                got = bsr.bsr_spmm_kernel(a.block_rows, a.block_cols, blocks, d, n_rows=m, row_ptr=a.row_ptr)
                check_close(f"bsr_spmm {case} {dt} N={n} T={transposed}", got, want, tol)
                if case == "pad2":
                    got2 = bsr.bsr_spmm_kernel2(a.block_rows, a.block_cols, blocks, d, n_rows=m, row_ptr=a.row_ptr)
                    check_close(f"bsr_spmm2 {case} {dt} N={n} T={transposed}", got2, want, tol)
            for b in (96, 37):  # 37: a ragged contraction
                lhs = torch.as_tensor(rng.standard_normal((b, m)), device=dev).to(dt).T
                rhs = torch.as_tensor(rng.standard_normal((b, k)), device=dev).to(dt)
                want = bsr.bsr_sddmm_plain(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
                got = bsr.bsr_sddmm_kernel(a.block_rows, a.block_cols, lhs, rhs, block_shape=a.block_shape)
                check_close(f"bsr_sddmm {case} {dt} B={b}", got, want, tol)
            torch.cuda.synchronize()
        # the full-width layer: its blocks and x.T (forward), the gradient of
        # an MSE-like loss, scaled as one (unit-normal / sqrt(batch)), for the SDDMM
        p = layer.params()
        blocks = p.blocks.detach().to(dt)
        xt = x.to(dt).T
        g = (wsum / LAYER_BATCH**0.5).to(dt).T  # (out, batch), a transposed view as in the backward
        args = (p.block_rows, p.block_cols, blocks, xt)
        want = bsr.bsr_spmm_plain(*args, n_rows=LAYER_OUT)
        e1 = check_close(f"bsr_spmm layer {dt}", bsr.bsr_spmm_kernel(*args, n_rows=LAYER_OUT, row_ptr=p.row_ptr), want, tol)
        e2 = check_close(f"bsr_spmm2 layer {dt}", bsr.bsr_spmm_kernel2(*args, n_rows=LAYER_OUT, row_ptr=p.row_ptr), want, tol)
        # the wgrad: g and x as the layer gives them (both MN-major), then
        # K-major copies of them; the same products either way
        want = bsr.bsr_sddmm_plain(p.block_rows, p.block_cols, g, x.to(dt))
        got = bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, g, x.to(dt))
        e3 = check_close(f"bsr_sddmm layer {dt}", got, want, tol)
        got_k = bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, g.contiguous(), x.to(dt).T.contiguous().T)
        check_close(f"bsr_sddmm layer K-major {dt}", got_k, want, tol)
        sddmm_norm[str(dt)] = normalised_err(got, want.double())
        sddmm_layouts_equal[str(dt)] = bool(torch.equal(got, got_k))
        if dt == torch.float32 and not (sddmm_norm[str(dt)] <= SDDMM_NORM_TOL and sddmm_layouts_equal[str(dt)]):
            raise AssertionError(f"bsr_sddmm layer float32: {sddmm_norm} normalised, MN/K-major equal {sddmm_layouts_equal}")
        del got, got_k
        # the dgrad: the K-major transposed blocks and the gradient's transposed view
        blocks_t = bsr.transposed_blocks(blocks, p.t_perm)
        args_t = (p.t_block_rows, p.t_block_cols, blocks_t, g)
        want = bsr.bsr_spmm_plain(*args_t, n_rows=LAYER_IN)
        check_close(f"bsr_spmm dgrad {dt}", bsr.bsr_spmm_kernel(*args_t, n_rows=LAYER_IN, row_ptr=p.t_row_ptr), want, tol)
        del blocks_t, want
        torch.cuda.synchronize()
        if dt == torch.float32:
            errs = {"bsr_spmm": e1, "bsr_spmm2": e2, "bsr_sddmm": e3}
        log(f"bsr kernel_vs_plain {dt}: ok")
    launches = dict(_cuda.LAUNCHES)
    if launches["bsr_spmm2"] == 0 or launches["bsr_spmm"] == 0 or launches["bsr_sddmm"] == 0:
        raise AssertionError(f"the BSR comparison launched no kernel: {launches}")
    sddmm = {"layer_normalised_err": sddmm_norm, "layer_mn_equals_k_major": sddmm_layouts_equal}
    return errs, launches, sddmm


def normalised_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def phase_training(dev, layer, x, target, wsum):
    """The block-sparse layer's training path at full width, counted: a
    first step checked against a float64 oracle, then three SGD steps."""
    from sparse_tpu_torch.kernels import LAUNCHES, bsr, reset_launch_counts

    p = layer.params()
    runs, t_runs = torch.diff(p.row_ptr), torch.diff(p.t_row_ptr)
    layout = {
        "n_pad_blocks": int((~p.blocks.detach().reshape(p.blocks.shape[0], -1).any(dim=1)).sum()),
        "run_min_max": [int(runs.min()), int(runs.max())],
        "t_run_min_max": [int(t_runs.min()), int(t_runs.max())],
        "t_run_of_block_row_0": int(t_runs[0]),
    }
    w64 = bsr.BSR(p.blocks.detach().double(), p.block_rows, p.block_cols, (LAYER_OUT, LAYER_IN), (128, 128), p.row_ptr)
    w64 = w64.todense()
    b64 = p.bias.detach().double()
    opt = torch.optim.SGD(layer.parameters(), lr=LAYER_LR)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # step 0: the output and both gradients of the weighted sum sum(y * wsum)
    x_in = x.clone().requires_grad_(True)
    y = layer(x_in)
    (y * wsum).sum().backward()
    torch.cuda.synchronize()
    first = dict(LAUNCHES)
    x64, g64 = x.double(), wsum.double()
    err_y = normalised_err(y.detach(), x64 @ w64.T + b64)
    err_dx = normalised_err(x_in.grad, g64 @ w64)
    dw = (g64.T @ x64).reshape(LAYER_OUT // 128, 128, LAYER_IN // 128, 128).transpose(1, 2)
    err_db = normalised_err(layer.blocks.grad, dw[p.block_rows.long(), p.block_cols.long()])
    del dw, w64
    for name, e in (("y", err_y), ("dx", err_dx), ("d_blocks", err_db)):
        if not e <= LAYER_ORACLE_TOL:
            raise AssertionError(f"training step 0: {name} off the float64 oracle by {e} (limit {LAYER_ORACLE_TOL})")
    if first["bsr_spmm"] < 2 or first["bsr_sddmm"] < 1:
        raise AssertionError(f"training step 0 did not run forward, dgrad and wgrad on the kernels: {first}")

    # three SGD steps on the per-sample summed squared error
    losses, steps = [], []
    for _ in range(3):
        before = dict(LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        opt.zero_grad(set_to_none=True)
        loss = ((layer(x) - target) ** 2).sum(dim=1).mean()
        loss.backward()
        opt.step()
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        per_step = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if per_step["bsr_spmm"] < 2 or per_step["bsr_sddmm"] < 1:
            raise AssertionError(f"an SGD step did not run forward, dgrad and wgrad on the kernels: {per_step}")
        losses.append(loss.item())
        steps.append({"host_s": host_s, "device_ms": start.elapsed_time(end), "launches": per_step})
    with torch.no_grad():
        losses.append(((layer(x) - target) ** 2).sum(dim=1).mean().item())
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not all(a > b for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss is not finite and falling: {losses}")

    # the steady state: STEADY_STEPS steps back to back, synchronised once, so
    # the host enqueues a step while the card runs the one before; the host
    # clock of each part is its enqueue time
    def sgd_step(marks):
        t = [time.perf_counter()]
        opt.zero_grad(set_to_none=True)
        y = layer(x)
        t.append(time.perf_counter())
        loss = ((y - target) ** 2).sum(dim=1).mean()
        loss.backward()
        t.append(time.perf_counter())
        opt.step()
        t.append(time.perf_counter())
        marks.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
        return loss

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    marks = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEADY_STEPS):
        loss = sgd_step(marks)
    end.record()
    end.synchronize()
    steady = {
        "steps": STEADY_STEPS,
        "device_ms_per_step": start.elapsed_time(end) / STEADY_STEPS,
        "host_ms_per_step": (time.perf_counter() - t0) * 1e3 / STEADY_STEPS,
        "host_enqueue_ms_median": dict(zip(("forward", "loss_backward", "sgd"), np.median(marks, axis=0).tolist())),
        "loss_after": loss.item(),
    }
    if not np.isfinite(steady["loss_after"]):
        raise AssertionError(f"the loss is not finite after {STEADY_STEPS} more steps")

    return {
        "err_y": err_y,
        "err_dx": err_dx,
        "err_d_blocks": err_db,
        "first_step_launches": first,
        "losses": losses,
        "lr": LAYER_LR,
        "steps": steps,
        "steady_state": steady,
        "launches": launches,
        "peak_memory_bytes": peak,
        "n_blocks": int(p.blocks.shape[0]),
        "layout": layout,
    }


def phase_pairs_path(dev, layer, x):
    """The two-block SpMM (P3) driven through its public wrapper on the
    trained layer's even-run layout, counted, against the layer's forward."""
    from sparse_tpu_torch.kernels import LAUNCHES, bsr, reset_launch_counts

    p = layer.params()
    with torch.no_grad():
        want = layer(x) - p.bias
        torch.cuda.synchronize()
        reset_launch_counts()
        got = bsr.bsr_spmm_kernel2(p.block_rows, p.block_cols, p.blocks, x.T, n_rows=LAYER_OUT, row_ptr=p.row_ptr).T
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        args = (p.block_rows, p.block_cols, p.blocks, x.T)
        one_block = bsr.bsr_spmm_kernel(*args, n_rows=LAYER_OUT, row_ptr=p.row_ptr).T
    if launches["bsr_spmm2"] == 0:
        raise AssertionError(f"the two-block path never launched bsr_spmm2: {launches}")
    err = normalised_err(got, want.double())
    if not err <= LAYER_ORACLE_TOL:
        raise AssertionError(f"bsr_spmm_kernel2 off the layer's forward by {err}")
    if not torch.equal(got, one_block):
        raise AssertionError("bsr_spmm_kernel2 and bsr_spmm_kernel differ on the layer's even-run layout")
    return launches, err


def phase_vjp_path(layer, x, wsum):
    """One step of the layer without its transposed layout (forward on the
    SpMM, backward as torch ops with the wgrad on the SDDMM kernel), counted,
    against the trainable path's gradients."""
    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    p = layer.params()
    grads = []
    for params in (p, p._replace(t_block_rows=None, t_block_cols=None, t_perm=None)):
        blocks = p.blocks.detach().clone().requires_grad_(True)
        x_in = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        reset_launch_counts()
        (tnn.block_sparse_linear(params._replace(blocks=blocks, bias=p.bias.detach()), x_in) * wsum).sum().backward()
        torch.cuda.synchronize()
        grads.append((blocks.grad, x_in.grad))
    launches = dict(LAUNCHES)
    if (launches["bsr_spmm"], launches["bsr_sddmm"]) != (1, 1):
        raise AssertionError(f"the layer without a transposed layout did not run its forward and wgrad on the kernels: {launches}")
    errs = {name: normalised_err(grads[1][i], grads[0][i].double()) for i, name in enumerate(("d_blocks", "dx"))}
    if not all(e <= SDDMM_NORM_TOL for e in errs.values()):
        raise AssertionError(f"the torch-op backward is off the trainable path's gradients: {errs}")
    return launches, errs, bool(torch.equal(grads[0][0], grads[1][0]))


def phase_step_breakdown(layer, x, wsum):
    """Device ms of each part of one training step (CUDA events, eager)."""
    from sparse_tpu_torch.kernels import bsr

    p = layer.params()
    blocks = p.blocks.detach()
    g = wsum.T  # the gradient of out_t, a transposed view
    blocks_t = bsr.transposed_blocks(blocks, p.t_perm)
    opt = torch.optim.SGD(layer.parameters(), lr=LAYER_LR)
    for prm in layer.parameters():
        prm.grad = torch.zeros_like(prm)
    parts = {
        "forward": lambda: bsr.bsr_spmm_kernel(p.block_rows, p.block_cols, blocks, x.T, n_rows=LAYER_OUT, row_ptr=p.row_ptr),
        "blocks_t_gather": lambda: bsr.transposed_blocks(blocks, p.t_perm),
        "dgrad": lambda: bsr.bsr_spmm_kernel(p.t_block_rows, p.t_block_cols, blocks_t, g, n_rows=LAYER_IN, row_ptr=p.t_row_ptr),
        "wgrad": lambda: bsr.bsr_sddmm_kernel(p.block_rows, p.block_cols, g, x),
        "sgd_step": opt.step,
    }
    with torch.no_grad():
        out = {name: time_eager(fn, reps=10) for name, fn in parts.items()}
    opt.zero_grad(set_to_none=True)
    return out


def phase_bsr_times(layer, x, wsum, launches, errs, card):
    """One line per BSR kernel at the full-width layer shape."""
    from sparse_tpu_torch.kernels import _cuda, bsr

    torch.backends.cuda.matmul.allow_tf32 = False
    p = layer.params()
    blocks = p.blocks.detach()
    nb, bm, bn = blocks.shape
    xt = x.T  # (in, batch), the forward's dense operand
    g = (wsum / LAYER_BATCH**0.5).T  # (out, batch), the wgrad's left operand
    cols = p.block_cols
    out_f = torch.empty((LAYER_OUT, LAYER_BATCH), device=x.device)
    out_w = torch.empty_like(blocks)
    w_dense = bsr.BSR(blocks, p.block_rows, cols, (LAYER_OUT, LAYER_IN), (bm, bn), p.row_ptr).todense()
    xt_c = xt.contiguous()

    library_notes = {}

    def yardstick(name, make):
        """One PyTorch call computing the same function, timed only; None (and
        the reason printed) where the installed torch does not take it here."""
        try:
            fn = make()
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
            library_notes[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            return None
        return time_eager(fn, reps=10)

    def bsr_matmul():
        w_bsr = w_dense.to_sparse_bsr((bm, bn))
        return lambda: w_bsr @ xt_c

    def sampled():
        # on the BSR pattern where torch takes it, else on the same pattern as
        # CSR; the pattern holds every stored block, pad blocks included
        ones = bsr.BSR(torch.ones_like(blocks), p.block_rows, cols, (LAYER_OUT, LAYER_IN), (bm, bn), p.row_ptr)
        ones = ones.todense()
        pattern = ones.to_sparse_bsr((bm, bn))
        try:
            torch.sparse.sampled_addmm(pattern, g, x, beta=0.0)
        except RuntimeError as exc:
            library_notes["bsr_sddmm_bsr_pattern"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            pattern = ones.to_sparse_csr()
        library_notes["bsr_sddmm"] = f"torch.sparse.sampled_addmm on the {pattern.layout} pattern"
        return lambda: torch.sparse.sampled_addmm(pattern, g, x, beta=0.0)

    touched_cols = int(torch.unique(cols).numel())
    touched_rows = int(torch.unique(p.block_rows).numel())
    idx_bytes = nb * 4 + (p.row_ptr.numel()) * 8
    spmm_bytes = nb * bm * bn * 4 + min(touched_cols * bn, LAYER_IN) * LAYER_BATCH * 4 + LAYER_OUT * LAYER_BATCH * 4 + idx_bytes
    sddmm_bytes = (min(touched_rows * bm, LAYER_OUT) + min(touched_cols * bn, LAYER_IN)) * LAYER_BATCH * 4 + nb * bm * bn * 4 + nb * 8
    flops = 2 * nb * bm * bn * LAYER_BATCH
    # the forward (block-rows of W) and the dgrad (block-rows of Wᵀ, K-major blocks_t)
    blocks_t = bsr.transposed_blocks(blocks, p.t_perm)
    g_dgrad = wsum.T  # the gradient of out_t, a transposed (K-major) view
    fwd = (blocks, cols, p.row_ptr, xt, LAYER_OUT)
    dgrad = (blocks_t, p.t_block_cols, p.t_row_ptr, g_dgrad, LAYER_IN)

    def tc_launch(operands, piece=_cuda.BSR_PIECE, name="bsr_spmm"):
        """The bare tensor-core launch on ``operands``, its scratch made once."""
        blk, bcols, row_ptr, dense_op, n_rows = operands
        out = torch.empty((n_rows, dense_op.shape[1]), device=dense_op.device)
        pieces = _cuda.run_pieces(row_ptr, piece)
        _, n_partial, n_tickets = _cuda.bsr_tc_scratch(blk.shape[0], row_ptr.shape[0] - 1, bm, dense_op.shape[1], piece)
        partial = torch.empty(n_partial, device=dense_op.device)
        tickets = _cuda.zeroed_tickets(dense_op.device, n_tickets)
        args = (blk, bcols, row_ptr, pieces, dense_op, out, partial, tickets)
        return lambda: _cuda.bsr_spmm_tc(*args, piece=piece, name=name)

    # the run piece L, picked on this card: no split (one CTA per run) against 32, 16 and 8 blocks
    piece_sweep = {
        str(piece): {part: time_graph(tc_launch(ops, piece), reps=20) for part, ops in (("forward", fwd), ("dgrad", dgrad))}
        for piece in (1 << 20, 32, 16, 8)
    }
    dgrad_ms = time_graph(tc_launch(dgrad), reps=20)

    def sddmm_extra():
        """The SDDMM on the layer's operands in the other layouts and dtypes:
        K-major copies of g and x (float32), bfloat16 (MN-major, read through
        the wgmma transpose bit) and float64 (the FFMA kernel of bsr.cu)."""
        g_k, x_k = g.contiguous(), x.T.contiguous().T
        g16, x16 = g.to(torch.bfloat16), x.to(torch.bfloat16)
        g64, x64 = g.double(), x.double()
        out16, out64 = torch.empty_like(out_w, dtype=torch.bfloat16), torch.empty_like(out_w, dtype=torch.float64)
        return {
            "mn_major_g_x": [_cuda.sddmm_tc_major(g, 0)[0], _cuda.sddmm_tc_major(x, 1)[0]],
            "mn_major_g_x_bf16": [_cuda.sddmm_tc_major(g16, 0)[0], _cuda.sddmm_tc_major(x16, 1)[0]],
            "kernel_ms_k_major": time_graph(lambda: _cuda.bsr_sddmm_tc(p.block_rows, cols, g_k, x_k, out_w), reps=20),
            "kernel_ms_bf16": time_graph(lambda: _cuda.bsr_sddmm_tc(p.block_rows, cols, g16, x16, out16), reps=20),
            "bf16_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
            "kernel_ms_f64_ffma": time_graph(lambda: _cuda.bsr_sddmm(p.block_rows, cols, g64, x64, out64), reps=5),
        }

    specs = [
        (
            "bsr_spmm",
            tc_launch(fwd),
            lambda: bsr.bsr_spmm_kernel(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT, row_ptr=p.row_ptr),
            lambda: bsr.bsr_spmm_plain(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT),
            bsr_matmul,
            lambda: w_dense @ xt_c,
            spmm_bytes,
        ),
        (
            "bsr_spmm2",
            tc_launch(fwd, name="bsr_spmm2"),
            lambda: bsr.bsr_spmm_kernel2(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT, row_ptr=p.row_ptr),
            lambda: bsr.bsr_spmm_plain(p.block_rows, cols, blocks, xt, n_rows=LAYER_OUT),
            bsr_matmul,
            lambda: w_dense @ xt_c,
            spmm_bytes,
        ),
        (
            "bsr_sddmm",
            lambda: _cuda.bsr_sddmm_tc(p.block_rows, cols, g, x, out_w),
            lambda: bsr.bsr_sddmm_kernel(p.block_rows, cols, g, x),
            lambda: bsr.bsr_sddmm_plain(p.block_rows, cols, g, x),
            sampled,
            lambda: g @ x,
            sddmm_bytes,
        ),
    ]
    lines = []
    for name, launch, wrapper, plain, library, dense, nbytes in specs:
        torch.cuda.reset_peak_memory_stats()
        ms = time_graph(launch, reps=20)
        peak_kernel = torch.cuda.max_memory_allocated()
        ms_wrapper = time_eager(wrapper, reps=20)
        ms_cold = time_cold(launch, reps=10)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_eager(plain, reps=5)
        peak_plain = torch.cuda.max_memory_allocated()
        library_ms = yardstick(name, library)
        dense_ms = time_eager(dense, reps=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # the same work has the same bound, whatever the kernel runs on: the
        # float32 products at HIGHEST on the CUDA cores or as 3xTF32 on the tensor cores
        t_ops = min(flops / F32_FLOPS_PER_S, 3 * flops / TF32_FLOPS_PER_S) * 1e3
        bound_ms = max(t_bytes, t_ops)
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lines.append(line)
        extra = {}
        if name == "bsr_spmm":
            extra = {"dgrad_kernel_ms": dgrad_ms, "piece": _cuda.BSR_PIECE, "piece_sweep_ms": piece_sweep}
        if name == "bsr_spmm2":  # the two-block CUDA-core kernel, float64's route, in float32
            cuda_core = lambda: _cuda.bsr_spmm(blocks, cols, p.row_ptr, xt, out_f, pairs=2)  # noqa: E731
            extra = {"cuda_core_ms": time_graph(cuda_core, reps=20)}
        if name == "bsr_sddmm":
            extra = sddmm_extra()
        log(
            json.dumps(
                {
                    **line,
                    "bound_note": "operations: 3xTF32 on the tensor cores (3 x flops / 495 TFLOP/s)"
                    if t_ops < flops / F32_FLOPS_PER_S * 1e3
                    else "operations: FP32 FMA",
                    **extra,
                    "kernel_ms": ms,
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "dense_ms": dense_ms,
                    "library_note": library_notes.get(name, "W.to_sparse_bsr((128, 128)) @ dense"),
                    "library_note_bsr_pattern": library_notes.get(f"{name}_bsr_pattern"),
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    "f32_peak_flops_per_s": F32_FLOPS_PER_S,
                    "tf32_peak_flops_per_s": TF32_FLOPS_PER_S,
                    "peak_memory_bytes_kernel": peak_kernel,
                    "peak_memory_bytes_plain": peak_plain,
                    "shape": {"out": LAYER_OUT, "in": LAYER_IN, "batch": LAYER_BATCH, "n_blocks": nb, "block": [bm, bn], "dtype": "float32"},
                    "card": card,
                }
            )
        )
    return lines


def mttkrp_problem(dev):
    """The BASELINE-scale tensor as a ``COO`` built on the card, its factors
    and its block-ELL layout, drawn as bench_suite.py draws them."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import build_block_ell_3d

    rng = np.random.default_rng(0)
    lin = np.unique(rng.integers(0, MT_I * MT_J * MT_K, size=MT_DRAWS, dtype=np.int64))
    coords = np.stack([lin // (MT_J * MT_K), (lin // MT_K) % MT_J, lin % MT_K])
    tv = rng.random(lin.size, dtype=np.float32)
    c = torch.as_tensor(rng.random((MT_J, MT_R), dtype=np.float32), device=dev)
    d = torch.as_tensor(rng.random((MT_K, MT_R), dtype=np.float32), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = st.COO(coords, tv, shape=(MT_I, MT_J, MT_K), device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lay = build_block_ell_3d(t.coords[0], t.coords[1], t.coords[2], t.data, MT_I, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t, c, d, lay, {"coo_build_s": t1 - t0, "layout_build_s": t2 - t1}


def example_problem(dev):
    """The example's tensor (seeded numpy draws) as a ``COO`` on the card,
    its factors, and the dense einsum oracle, computed in slabs of rows."""
    import sparse_tpu_torch as st

    I, K, L = EX_SHAPE
    rng = np.random.default_rng(0)
    lin = np.sort(rng.choice(I * K * L, size=round(I * K * L * EX_DENSITY), replace=False))
    coords = np.stack([lin // (K * L), (lin // L) % K, lin % L])
    vals = rng.random(lin.size)
    c, d = rng.random((K, EX_R)), rng.random((L, EX_R))
    want = np.empty((I, EX_R))
    for i0 in range(0, I, 100):
        sel = (coords[0] >= i0) & (coords[0] < i0 + 100)
        slab = np.zeros((100, K, L))
        slab[coords[0, sel] - i0, coords[1, sel], coords[2, sel]] = vals[sel]
        want[i0 : i0 + 100] = np.einsum("ikl,kj,lj->ij", slab, c, d, optimize=True)
    return st.COO(coords, vals, shape=EX_SHAPE, device=dev), c, d, want


def phase_mttkrp_vs_plain(t, c, d, lay):
    """The MTTKRP kernel, both forms, against its plain version at full
    width: float32, float64 and the bf16 tables (positive values: no
    cancellation, so the row-ELL tolerances hold)."""
    from sparse_tpu_torch.kernels import dot, ell

    runs = dict(order=lay.order, row_ptr=lay.row_ptr)
    errs = {}
    for dt in (torch.float32, torch.float64):
        lay_dt, c_dt, d_dt = (*lay[:3], lay.e_data.to(dt)), c.to(dt), d.to(dt)
        for strategy in ("exact", "bf16"):
            got = ell.ell_mttkrp(*lay_dt, c_dt, d_dt, n_rows=MT_I, strategy=strategy, **runs)
            want = ell.ell_mttkrp_plain(*lay_dt, c_dt, d_dt, n_rows=MT_I, strategy=strategy)
            errs[f"ell_mttkrp {strategy} {dt}"] = check_close(f"ell_mttkrp {strategy} {dt}", got, want, TOL[dt])
            del got, want
        v_dt = t.data.to(dt)
        got = dot.mttkrp(*t.coords, v_dt, c_dt, d_dt, n_rows=MT_I)
        want = dot.mttkrp_plain(*t.coords, v_dt, c_dt, d_dt, n_rows=MT_I)
        errs[f"coo_mttkrp {dt}"] = check_close(f"coo_mttkrp {dt}", got, want, TOL[dt])
        del got, want, lay_dt
        torch.cuda.synchronize()
    return errs


def phase_mttkrp_path(dev, t, c, d, lay, ex):
    """The MTTKRP path through its entry points, counted: every call must
    launch its kernel exactly once."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, dot, ell, reset_launch_counts

    t_ex, c_ex, d_ex, want_ex = ex
    lay_ex = ell.build_block_ell_3d(t_ex.coords[0], t_ex.coords[1], t_ex.coords[2], t_ex.data, EX_SHAPE[0], device=dev)
    runs = dict(order=lay.order, row_ptr=lay.row_ptr)
    c_ex_t, d_ex_t = torch.as_tensor(c_ex, device=dev), torch.as_tensor(d_ex, device=dev)
    calls = [
        ("ell exact", "ell_mttkrp", lambda: ell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, **runs)),
        ("ell bf16", "ell_mttkrp", lambda: ell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, strategy="bf16", **runs)),
        ("kernels.mttkrp", "coo_mttkrp", lambda: st.kernels.mttkrp(*t.coords, t.data, c, d, n_rows=MT_I)),
        ("jitops.mttkrp", "coo_mttkrp", lambda: st.jitops.mttkrp(t, c, d)),
        ("example jitops.mttkrp", "coo_mttkrp", lambda: st.jitops.mttkrp(t_ex, c_ex, d_ex)),
        (
            "example ell",
            "ell_mttkrp",
            lambda: ell.ell_mttkrp(*lay_ex[:4], c_ex_t, d_ex_t, n_rows=EX_SHAPE[0], order=lay_ex.order, row_ptr=lay_ex.row_ptr),
        ),
    ]
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = {}
    for label, counter, call in calls:
        before = dict(LAUNCHES)
        outs[label] = call()
        step = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if step != {k: int(k == counter) for k in LAUNCHES}:
            raise AssertionError(f"{label}: expected one {counter} launch and nothing else, got {step}")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    want = dot.mttkrp_plain(*t.coords, t.data.double(), c.double(), d.double(), n_rows=MT_I)
    errs = {}
    for label in ("ell exact", "ell bf16", "kernels.mttkrp", "jitops.mttkrp"):
        got = outs[label]
        if tuple(got.shape) != (MT_I, MT_R) or got.device.type != dev.type or got.dtype != torch.float32:
            raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} on {got.device}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: output not finite")
        errs[label] = normalised_err(got, want)
        limit = MT_ORACLE_TOL["bf16" if "bf16" in label else "exact"]
        if not errs[label] <= limit:
            raise AssertionError(f"{label}: off the float64 oracle by {errs[label]} (limit {limit})")
    if not torch.equal(outs["kernels.mttkrp"], outs["jitops.mttkrp"]):
        raise AssertionError("kernels.mttkrp and jitops.mttkrp differ on the same tensor")
    for label in ("example jitops.mttkrp", "example ell"):
        got = outs[label]
        if got.dtype != torch.float64:
            raise AssertionError(f"{label}: {got.dtype}, expected float64")
        np.testing.assert_allclose(got.cpu().numpy(), want_ex, rtol=EX_RTOL, err_msg=label)
    return launches, errs, want


def phase_mttkrp_times(t, c, d, lay, want, launches, errs, card, build):
    """One line per MTTKRP kernel at the BASELINE scale, with the bf16
    tables' time and the yardstick: torch.sparse.mm of the mode-1 unfolding
    (I x J*K CSR) with a Khatri-Rao product built beforehand."""
    from sparse_tpu_torch.kernels import _cuda, dot, ell

    slots, nnz = lay.order.numel(), t.nnz
    ej, ek, ed = (a.reshape(-1) for a in lay[1:4])
    ci, cj, ck = t.coords
    row_ptr_coo = torch.searchsorted(ci.long(), torch.arange(MT_I + 1, device=ci.device))
    c16, d16 = c.to(torch.bfloat16), d.to(torch.bfloat16)
    out = torch.empty((MT_I, MT_R), device=c.device)
    runs = dict(order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces)
    pieces_coo = _cuda.run_pieces(row_ptr_coo, _cuda.MTTKRP_PIECE)

    def scratch(n_slots, piece=_cuda.MTTKRP_PIECE):
        n_front = _cuda.front_bound(n_slots, MT_I, piece)
        return torch.empty(n_front * MT_R, device=c.device), _cuda.zeroed_tickets(c.device, n_front)

    part_ell, tix = scratch(slots)
    part_coo, _ = scratch(nnz)

    kr_ms = time_eager(lambda: (c[:, None, :] * d[None, :, :]).reshape(MT_J * MT_K, MT_R), reps=5)
    kr = (c[:, None, :] * d[None, :, :]).reshape(MT_J * MT_K, MT_R)
    unfold = torch.sparse_coo_tensor(
        torch.stack([ci.long(), cj.long() * MT_K + ck.long()]), t.data, (MT_I, MT_J * MT_K)
    ).coalesce().to_sparse_csr()
    library_note = "torch.sparse.mm(mode-1 unfolding CSR, Khatri-Rao (J*K, r)), Khatri-Rao built beforehand"
    try:
        lib_out = torch.sparse.mm(unfold, kr)
        torch.cuda.synchronize()
        library_err = normalised_err(lib_out, want)
        del lib_out
        library_ms = time_eager(lambda: torch.sparse.mm(unfold, kr), reps=10)
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
        library_ms, library_err = None, None
        library_note += f": {type(exc).__name__}: {str(exc).splitlines()[0][:200]}"

    table_bytes = (MT_J + MT_K) * MT_R * 4
    out_bytes = MT_I * MT_R * 4
    # the block-ELL runs: every pad slot of a block joins its local row 0,
    # so the ragged last block's row 0 is the longest run by far; timing the
    # rows before that block shows what its one warp costs
    run_len = torch.diff(lay.row_ptr[: MT_I + 1])
    full_rows = MT_I // 128 * 128

    def ell_launch(piece):
        pieces = _cuda.run_pieces(lay.row_ptr, piece)
        part, tickets = scratch(slots, piece)
        return lambda: _cuda.mttkrp(lay.row_ptr, pieces, lay.order, ej, ek, ed, c, d, out, part, tickets, piece=piece)

    # the piece P, picked on this card: no split (the first design) against 512, 256 and 128 slots
    ell_runs = {
        "longest_run": int(run_len.max()),
        "longest_run_row": int(run_len.argmax()),
        "median_run": float(run_len.float().median()),
        "piece": _cuda.MTTKRP_PIECE,
        "split_rows": int((run_len > _cuda.MTTKRP_PIECE).sum()),
        "pieces_of_split_rows": int(lay.pieces[MT_I]),
        "front_bound": _cuda.front_bound(slots, MT_I, _cuda.MTTKRP_PIECE),
        "piece_sweep_ms": {str(P): time_graph(ell_launch(P), reps=20) for P in (1 << 40, 512, 256, 128)},
        "kernel_ms_rows_before_last_block": time_graph(
            lambda: _cuda.mttkrp(lay.row_ptr, lay.pieces, lay.order, ej, ek, ed, c, d, out[:full_rows], part_ell, tix),
            reps=20,
        ),
        "rows_before_last_block": full_rows,
    }
    specs = [
        (
            "ell_mttkrp",
            lambda: _cuda.mttkrp(lay.row_ptr, lay.pieces, lay.order, ej, ek, ed, c, d, out, part_ell, tix),
            lambda: _cuda.mttkrp(lay.row_ptr, lay.pieces, lay.order, ej, ek, ed, c16, d16, out, part_ell, tix),
            lambda: ell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, **runs),
            lambda: ell.ell_mttkrp_plain(*lay[:4], c, d, n_rows=MT_I),
            # j, k, data and order per slot, the row offsets, the tables, the output
            slots * 16 + (MT_I + 1) * 8 + table_bytes + out_bytes,
            3 * slots * MT_R,
            slots,
        ),
        (
            "coo_mttkrp",
            lambda: _cuda.mttkrp(row_ptr_coo, pieces_coo, None, cj, ck, t.data, c, d, out, part_coo, tix),
            lambda: _cuda.mttkrp(row_ptr_coo, pieces_coo, None, cj, ck, t.data, c16, d16, out, part_coo, tix),
            lambda: dot.mttkrp(ci, cj, ck, t.data, c, d, n_rows=MT_I),
            lambda: dot.mttkrp_plain(ci, cj, ck, t.data, c, d, n_rows=MT_I),
            nnz * 12 + (MT_I + 1) * 8 + table_bytes + out_bytes,
            3 * nnz * MT_R,
            nnz,
        ),
    ]
    lines = []
    for name, launch, launch_bf16, wrapper, plain, nbytes, flops, n_slots in specs:
        torch.cuda.reset_peak_memory_stats()
        ms = time_graph(launch, reps=20)
        ms_bf16 = time_graph(launch_bf16, reps=20)
        ms_wrapper = time_eager(wrapper, reps=10)
        ms_cold = time_cold(launch, reps=10)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_eager(plain, reps=3)
        peak_plain = torch.cuda.max_memory_allocated()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lines.append(line)
        log(
            json.dumps(
                {
                    **line,
                    "kernel_ms": ms,
                    "kernel_ms_bf16_tables": ms_bf16,
                    "kernel_ms_l2_flushed": ms_cold,
                    "wrapper_ms_eager": ms_wrapper,
                    "library_note": library_note,
                    "library_err_vs_oracle": library_err,
                    "khatri_rao_build_ms": kr_ms,
                    "bound_bytes": nbytes,
                    "bound_flops": flops,
                    "bound_share": bound_ms / ms,
                    # two factor rows of r values gathered per slot, through L2
                    "gathered_bytes": 2 * n_slots * MT_R * 4,
                    "peak_memory_bytes_plain": peak_plain,
                    **(ell_runs if name == "ell_mttkrp" else {}),
                    "shape": {"I": MT_I, "J": MT_J, "K": MT_K, "r": MT_R, "nnz": nnz, "slots": n_slots, "dtype": "float32"},
                    **build,
                    "card": card,
                }
            )
        )
    return lines


def phase_experiments(dev):
    """The experiments through their runners, counted: E1's ``main`` at the
    benchmark shape, then each probe at its ``__main__`` size. Each runner
    runs its output call, then times the kernel (``WARMUP + REPS`` calls
    from Python); E1's ``main`` times its full SpMV for each of its four
    runs, and K1 once."""
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    timed = WARMUP + REPS
    expected = {
        "spmv_products": 4 * (1 + timed),
        "row_ell_spmv": timed,
        "lane_gather": 2 * (2 + timed),  # the capability call and the gather
        "row_gather_sum": 1 + timed,
        "row_pick_bf16": 1 + timed,
        "scalar_gather_sum": 1 + timed,
        "lane_gather_blocksum": 2 * (1 + timed),
        "row_pick_blocksum": 1 + timed,
        "pick_scale_wsum": 1 + timed,
    }
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    spmv = e1.main(dev)
    runs = {
        "p1": v.p1(512, label="p1(512)", device=dev),
        "p1b": v.p1(8192, label="p1b(8192)", device=dev),
        "p2": v.p2(device=dev),
        "p3": v.p3(device=dev),
        "p4": v.p4(device=dev),
        "g1": v2.g1(512, n_blocks=36, device=dev),
        "g1b": v2.g1(8192, n_blocks=4, label="g1b", device=dev),
        "g2": v2.g2(device=dev),
        "g3": v2.g3(device=dev),
    }
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"the experiments phase launched {launches}, expected {want}")
    for label, run in spmv["runs"].items():
        limit = E1_ORACLE_TOL[label.split()[0]]
        if not run["relerr"] <= limit:
            raise AssertionError(f"E1 {label}: off the float64 oracle by {run['relerr']} (limit {limit})")
    for label, out in spmv["outputs"].items():
        if tuple(out.shape) != (M,) or out.device.type != "cuda" or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"E1 {label}: {tuple(out.shape)} on {out.device}")
    return spmv, runs, launches, seconds


def phase_experiments_vs_plain(spmv, runs):
    """Each of the eight kernels against its plain version on the phase's
    own inputs at full size: the picks bit for bit, the sums at PROBE_TOL.
    Returns the largest absolute difference of each run, by its label."""
    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2

    def exact(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel and plain version differ by {float((got - want).abs().max())}")
        return 0.0

    errs = {}
    re, x = spmv["layout"], spmv["x"]
    fc, fd = e1.flatten_tiers(re, 2048)
    for hilo in (True, False):
        x2 = e1.make_table(x, hilo)
        errs[f"E1 {'hilo' if hilo else 'bf16'} blk=2048"] = exact("spmv_products", e1.products(x2, fc, fd), e1.products_plain(x2, fc, fd))
        # a table too tall for shared memory (1,024 rows) takes the L2 route; half the picks in its second half
        tall = e1.make_table(torch.cat([x, x.flip(0)]), hilo)
        c2 = fc.clone()
        c2[1::2] += x.numel()
        exact("spmv_products l2 route", e1.products(tall, c2, fd), e1.products_plain(tall, c2, fd))
    for key in ("p1", "p1b"):
        r = runs[key]
        table, idx = r.inputs["table"], r.inputs["idx"]
        h = min(table.shape[0], 512)
        exact(f"lane_gather {r.label} capability", r.outputs[0], v.lane_gather_plain(table[:h], idx[:8] % h))
        errs[r.label] = exact(f"lane_gather {r.label}", r.outputs[1], v.lane_gather_plain(table, idx))
    r = runs["p2"]
    errs["p2"] = check_close("row_gather_sum", r.outputs[0], v.row_gather_sum_plain(r.inputs["strip"], r.inputs["idx"], 1024), PROBE_TOL)
    again = v.row_gather_sum(r.inputs["strip"], r.inputs["idx"], 1024)  # sums in the plan's fixed order
    torch.cuda.synchronize()
    if not torch.equal(again, r.outputs[0]):
        raise AssertionError("row_gather_sum: two launches differ")
    r = runs["p3"]
    errs["p3"] = exact("row_pick_bf16", r.outputs[0], v.row_pick_bf16_plain(r.inputs["strip"], r.inputs["idx"]))
    r = runs["p4"]
    xs, qi, qj = r.inputs["x"], r.inputs["qi"], r.inputs["qj"]
    e6_plain = v.scalar_gather_sum_plain(xs, qi, qj, 1024)
    errs["p4"] = check_close("scalar_gather_sum", r.outputs[0], e6_plain, PROBE_TOL)
    again = v.scalar_gather_sum(xs, qi, qj, 1024)  # its sums in a fixed order
    torch.cuda.synchronize()
    if not torch.equal(again, r.outputs[0]):
        raise AssertionError("scalar_gather_sum: two launches differ")
    for key in ("g1", "g1b"):
        r = runs[key]
        T = r.inputs["table"].shape[0]
        want = v2.lane_gather_blocksum_plain(r.inputs["table"], r.inputs["idx"], T)
        errs[r.label] = check_close(f"lane_gather_blocksum {r.label}", r.outputs[0], want, PROBE_TOL)
        again = v2.lane_gather_blocksum(r.inputs["table"], r.inputs["idx"], T)  # sums in a fixed order
        torch.cuda.synchronize()
        if not torch.equal(again, r.outputs[0]):
            raise AssertionError(f"lane_gather_blocksum {r.label}: two launches differ")
    r = runs["g2"]
    table, cols = r.inputs["table"], r.inputs["cols"]
    want = v2.row_pick_blocksum_plain(table, cols, table.shape[0])
    errs["g2"] = check_close("row_pick_blocksum", r.outputs[0], want, PROBE_TOL)
    again = v2.row_pick_blocksum(table, cols, table.shape[0])  # its sums in a fixed order: the same bits every launch
    torch.cuda.synchronize()
    if not torch.equal(again, r.outputs[0]):
        raise AssertionError("row_pick_blocksum: two launches differ")
    r = runs["g3"]
    want = v2.pick_scale_wsum_plain(r.inputs["table"], r.inputs["cols2"], r.inputs["data2"])
    errs["g3"] = check_close("pick_scale_wsum", r.outputs[0], want, PROBE_TOL)
    torch.cuda.synchronize()
    return errs


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_experiments_times(spmv, runs, launches, errs, card):
    """One line per probe run and one kernel row per kernel: device ms and
    the rate in the experiment's unit, the byte bound (each input read once,
    each output written once) and its share, the L2 bytes of the whole-row
    picks and their rate, the plain version's ms and one PyTorch call's."""
    import torch.nn.functional as F

    from sparse_tpu_torch.experiments import pallas_spmv_onehot as e1
    from sparse_tpu_torch.experiments import pallas_vmem as v
    from sparse_tpu_torch.experiments import pallas_vmem2 as v2
    from sparse_tpu_torch.experiments.common import Run
    from sparse_tpu_torch.kernels import _cuda

    # E1: the products kernel alone, on the blk=2048 stream of the main run
    re, x = spmv["layout"], spmv["x"]
    fc, fd = e1.flatten_tiers(re, 2048)
    x2h, x2b = e1.make_table(x, True), e1.make_table(x, False)
    out = torch.empty((fc.numel(), 1), device=fc.device)
    e1_ms = {t: time_graph(lambda x2=x2: _cuda.spmv_products(x2, fc, fd, out)) for t, x2 in (("hilo", x2h), ("bf16", x2b))}
    e1_run = Run("E1 hilo blk=2048", {}, (out,), spmv["nnz"], "M nnz/s", e1_ms["hilo"])
    e1_fields = {
        "kernel_ms_hilo_table": e1_ms["hilo"],
        "kernel_ms_bf16_table": e1_ms["bf16"],
        "design": {t: _cuda.spmv_products_design(x2.shape[0], t == "hilo") for t, x2 in (("hilo", x2h), ("bf16", x2b))},
        "bound_ms_bf16_table": nbytes(fc, fd, x2b, out) / HBM_BYTES_PER_S * 1e3,
    }

    specs = []

    def add(name, run, plain, library, note, tensors, whole_rows=False, more_bytes=0, extra=None, fields=None):
        """``tensors``: the inputs and outputs, each counted once in the bound,
        with ``more_bytes``; ``whole_rows``: the run picks n 512-byte table
        rows through L2; ``extra``: a function of the kernel's ms giving more
        fields of the run's line; ``fields``: more fields of the kernel's row."""
        specs.append(
            (name, run, plain, library, note, nbytes(*tensors) + more_bytes,
             run.n * L2_ROW_BYTES if whole_rows else None, extra, fields or {})
        )

    add("spmv_products", e1_run, lambda: e1.products_plain(x2h, fc, fd), None,
        "none: no single PyTorch call picks from a hi|lo bf16 table", (fc, fd, x2h, out))
    # the route of each lane-gather run, by its table (column slices in shared memory, or L2)
    p1_designs = {r.label: _cuda.lane_gather_design(r.inputs["table"].shape[0]) for r in (runs["p1"], runs["p1b"])}
    for r in (runs["p1"], runs["p1b"]):
        table, idx = r.inputs["table"], r.inputs["idx"]
        i64 = idx.long()
        add("lane_gather", r, lambda t=table, i=idx: v.lane_gather_plain(t, i), lambda t=table, i=i64: torch.gather(t, 0, i),
            "torch.gather(table, 0, idx), idx int64 beforehand", (table, idx, r.outputs[1]),
            fields={"design": p1_designs[r.label], "designs": p1_designs})
    r = runs["p2"]
    strip, idx = r.inputs["strip"], r.inputs["idx"]
    bags = idx.long().view(-1, 1024)
    p2_plan = _cuda.row_gather_sum_plan(1024, bags.shape[0], torch.cuda.get_device_properties(idx.device).multi_processor_count)
    add("row_gather_sum", r, lambda: v.row_gather_sum_plain(strip, idx, 1024), lambda: F.embedding_bag(bags, strip, mode="sum"),
        "F.embedding_bag(idx.view(128, 1024), strip, mode='sum')", (strip, idx, r.outputs[0]), whole_rows=True,
        extra=lambda ms, n=r.n: {"l2_floor_ms": n * L2_ROW_BYTES / L2_ROW_BYTES_PER_S * 1e3},
        fields={"plan": p2_plan._asdict(), "two_launches_equal": True})
    r = runs["p3"]
    strip3, idx3 = r.inputs["strip"], r.inputs["idx"]
    rounded, i3 = strip3.to(torch.bfloat16).float(), idx3.long()
    # the card's write ceiling: out.zero_() on an output of p3's size
    blank = torch.empty_like(r.outputs[0])
    zero_ms = time_graph(blank.zero_)
    del blank
    written = r.outputs[0].numel() * 4

    def p3_extra(ms):
        return {
            "write_tb_per_s": written / (ms * 1e-3) / 1e12,
            "zero_ms": zero_ms,
            "zero_write_tb_per_s": written / (zero_ms * 1e-3) / 1e12,
            "ms_over_zero_ms": ms / zero_ms,
            "strip_in_shared_memory": _cuda.row_pick_bf16_resident(strip3.shape[0]),
        }

    add("row_pick_bf16", r, lambda: v.row_pick_bf16_plain(strip3, idx3), lambda: torch.index_select(rounded, 0, i3),
        "torch.index_select on the strip rounded to bf16 beforehand", (strip3, idx3, r.outputs[0]), extra=p3_extra)
    r = runs["p4"]
    xs, qi, qj = r.inputs["x"], r.inputs["qi"], r.inputs["qj"]
    flat = (qi.long() * xs.shape[1] + qj.long()).view(-1, 1024)
    # E6's kernel cut to the launch alone (the launch floor) and to the index
    # loads and sums
    e6_out = torch.empty_like(r.outputs[0])
    e6_stages = {st_: time_graph(lambda st_=st_: _cuda.scalar_gather_sum_stage(xs, qi, qj, e6_out, 1024, st_))
                 for st_ in _cuda.SCALAR_GATHER_STAGES}
    add("scalar_gather_sum", r, lambda: v.scalar_gather_sum_plain(xs, qi, qj, 1024),
        lambda: F.embedding_bag(flat, xs.view(-1, 1), mode="sum"),
        "F.embedding_bag(flat indices (64, 1024), x.view(-1, 1), mode='sum')", (xs, qi, qj, r.outputs[0]),
        fields={"design": "a CTA of 256 threads a segment, four picks a thread (the first port's; wider CTAs, "
                          "int2/int4 index loads and a cluster split were slower: PERF.md section 6)",
                "launch_floor_ms": e6_stages["launch"], "indices_only_ms": e6_stages["indices"],
                "two_launches_equal": True, "card": card})
    for r in (runs["g1"], runs["g1b"]):
        table, idx = r.inputs["table"], r.inputs["idx"]
        route = "slices" if _cuda.lane_slice_resident(table.shape[0]) else "l2"
        add("lane_gather_blocksum", r, lambda t=table, i=idx: v2.lane_gather_blocksum_plain(t, i, t.shape[0]), None,
            "none: no single PyTorch call gathers per lane and sums blocks", (table, idx, r.outputs[0]),
            extra=lambda ms, route=route: {"table_route": route})
    r = runs["g2"]
    table2, cols = r.inputs["table"], r.inputs["cols"]
    T2 = table2.shape[0]
    bags2 = cols.long().view(-1, T2)
    # the first port's route, every pick a 512-byte row read through L2 (E4's
    # row gather): the card's whole-row L2 rate, beside the rate of picks served from shared memory
    rows_out = torch.empty_like(r.outputs[0])
    rows_ms = time_graph(lambda: _cuda.row_pick_blocksum(table2, cols, rows_out, T2, route="rows"))
    check_close("row_pick_blocksum rows route", rows_out, v2.row_pick_blocksum_plain(table2, cols, T2), PROBE_TOL)
    plan2 = _cuda.row_pick_count_plan(T2)
    picked = r.n * L2_ROW_BYTES

    def g2_extra(ms):
        return {
            "smem_pick_tb_per_s": picked / (ms * 1e-3) / 1e12,
            "picked_bytes": picked,
            "l2_index_bytes": plan2.n_slices * nbytes(cols),
            "slice_plan": plan2._asdict(),
            "rows_route_ms": rows_ms,
            "rows_route_l2_tb_per_s": picked / (rows_ms * 1e-3) / 1e12,
        }

    add("row_pick_blocksum", r, lambda: v2.row_pick_blocksum_plain(table2, cols, T2),
        lambda: F.embedding_bag(bags2, table2, mode="sum"),
        "F.embedding_bag(cols.view(285, 8192), table, mode='sum')", (table2, cols, r.outputs[0]), extra=g2_extra)
    r = runs["g3"]
    table3, cols2, data2 = r.inputs["table"], r.inputs["cols2"], r.inputs["data2"]
    n_cells, _, w = cols2.shape

    def regroup(t):  # the picks each kept output row adds: (cell, r < 8, g < 64, w)
        return t.view(n_cells, 64, 128, w)[:, :, :8, :].permute(0, 2, 1, 3).reshape(n_cells * 8, 64 * w).contiguous()

    bags3, weights3 = regroup(cols2.long()), regroup(data2)
    # the bound counts the work the output keeps: the table, the out rows and
    # the indices and weights of the run.n picks the 8 kept rows of a cell add
    add("pick_scale_wsum", r, lambda: v2.pick_scale_wsum_plain(table3, cols2, data2),
        lambda: F.embedding_bag(bags3, table3, mode="sum", per_sample_weights=weights3),
        "F.embedding_bag(mode='sum', per_sample_weights) over the 1/16 of the picks that the 8 kept rows of each "
        "cell add, regrouped beforehand", (table3, r.outputs[0]), whole_rows=True, more_bytes=r.n * 8)

    rows, seen = [], set()
    for name, run, plain, library, note, nb, l2, extra, fields in specs:
        plain_ms = time_eager(plain, reps=3)
        library_ms = None if library is None else time_eager(library, reps=10)
        bound_ms = nb / HBM_BYTES_PER_S * 1e3
        line = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[run.label],
            "ms": run.ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": library_ms,
            **fields,
        }
        log(
            json.dumps(
                {
                    **line,
                    "probe": run.label,
                    "rate": run.rate,
                    "unit": run.unit,
                    "n": run.n,
                    "bound_bytes": nb,
                    "bound_share": bound_ms / run.ms,
                    "l2_bytes": l2,
                    "l2_tb_per_s": None if l2 is None else l2 / (run.ms * 1e-3) / 1e12,
                    "library_note": note,
                    **(e1_fields if name == "spmv_products" else {}),
                    **(extra(run.ms) if extra else {}),
                    "card": card,
                }
            )
        )
        if name not in seen:  # the first run of each kernel is its row
            seen.add(name)
            rows.append(line)
    return rows


# ---------------------------------------------------------------------------
# elementwise operations and reductions (BASELINE config 3)
# ---------------------------------------------------------------------------

def sddmm_oracle(rows, cols, s, lhs, rhs_t, chunk=1 << 16):
    """float64 values of an SDDMM and each entry's scale |s| · Σ_k |lhs_ik ·
    rhs_kj|, in chunks on the card."""
    want = torch.empty(rows.numel(), dtype=torch.float64, device=rows.device)
    scale = torch.empty_like(want)
    for i in range(0, rows.numel(), chunk):
        prod = lhs[rows[i : i + chunk].long()].double() * rhs_t[cols[i : i + chunk].long()].double()
        sv = s[i : i + chunk].double()
        want[i : i + chunk] = sv * prod.sum(-1)
        scale[i : i + chunk] = sv.abs() * prod.abs().sum(-1)
    return want, scale


def check_sddmm(name, got, want, scale, tol):
    """Each entry within ``tol · scale`` of ``want``; the worst ratio."""
    err = (got.double() - want).abs()
    if bool((err > tol * scale).any()):
        raise AssertionError(f"{name}: {int((err > tol * scale).sum())} entries beyond {tol} of their scale")
    return float((err / scale.clamp_min(1e-300)).max()) if err.numel() else 0.0


def sddmm_example(dev):
    """The example's problem (examples/sddmm_example.py): a 10,000^2 float64
    dense pair and a 1,000-entry mask drawn with numpy from a seed, the mask
    as a COO on the card, and the oracle at the mask's coordinates."""
    import sparse_tpu_torch as st

    rng = np.random.default_rng(0)
    n = SD_EX_LEN
    lhs, rhs = rng.random((n, n)), rng.random((n, n))
    lin = np.sort(rng.choice(n * n, size=SD_EX_NNZ, replace=False))
    r, c, v = lin // n, lin % n, rng.random(SD_EX_NNZ)
    want = v * np.einsum("ek,ek->e", lhs[r], rhs.T[c])
    s = st.COO(np.stack([r, c]), v, shape=(n, n), device=dev)
    return s, torch.as_tensor(lhs, device=dev), torch.as_tensor(rhs, device=dev), want


def host_ahead_ms(fn, reps=20):
    """Device ms per call of ``fn`` with the host ahead of the card: a spin
    twice as long as the host takes to enqueue ``reps`` calls keeps the card
    busy while they are enqueued, then CUDA events around the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 2e9))  # cycles at about 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def backward_ms_and_peak(fn, rows, cols, s, lhs, rhs, w, reps=5):
    """The backward of ``(w · fn(rows, cols, s, lhs, rhs)).sum()`` in ``s``,
    ``lhs`` and ``rhs``: the bytes it allocates beyond what was live before
    it (the three gradients included); its device ms, a forward and
    backward less the forward, each with the host ahead
    (:func:`host_ahead_ms`; each forward builds its pattern anew, so the
    backward's sorts count); the eager ms of a forward and backward (the
    host's enqueue included); the gradients of two such calls."""
    ins = [t.detach().clone().requires_grad_(True) for t in (s, lhs, rhs)]
    loss = (w * fn(rows, cols, *ins)).sum()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = torch.autograd.grad(loss, ins)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    step = lambda: torch.autograd.grad((w * fn(rows, cols, *ins)).sum(), ins)  # noqa: E731
    second = step()

    def forward():
        with torch.no_grad():
            return fn(rows, cols, *ins)

    both, fwd = host_ahead_ms(step, reps=reps), host_ahead_ms(forward, reps=reps)
    timing = {
        "device_ms": both - fwd,
        "forward_backward_device_ms": both,
        "forward_device_ms": fwd,
        "forward_backward_ms_eager": time_eager(step, reps=reps),
        "extra_peak_bytes": peak,
    }
    return timing, first, second


def plain_backward(rows, cols, s, lhs, rhs, w):
    """The gradients of ``(w · sddmm).sum()`` in s, lhs and rhs as the port
    first computed them (``d s`` by K4, then two gathered (nnz, K) blocks
    summed by ``index_add_``, ``sampled_row_sum_plain``)."""
    from sparse_tpu_torch.kernels import dot as kdot

    gs = w * s
    return (
        kdot.sddmm(rows, cols, w, lhs, rhs),
        kdot.sampled_row_sum_plain(rows, cols, gs, rhs.T, lhs.shape[0]),
        kdot.sampled_row_sum_plain(cols, rows, gs, lhs, rhs.shape[1]).T,
    )


def plain_backward_ms_and_peak(rows, cols, s, lhs, rhs, w, reps=5):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = plain_backward(rows, cols, s, lhs, rhs, w)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    call = lambda: plain_backward(rows, cols, s, lhs, rhs, w)  # noqa: E731
    return {
        "device_ms": host_ahead_ms(call, reps=reps),
        "ms_eager": time_eager(call, reps=reps),
        "extra_peak_bytes": peak,
    }


def kept_row_loads(rows, epw):
    """The lhs rows K4's kept-row route loads: one at each group's first
    entry and wherever the row changes."""
    fresh = torch.ones(rows.numel(), dtype=torch.bool, device=rows.device)
    fresh[1:] = rows[1:] != rows[:-1]
    fresh[::epw] = True
    return int(fresh.sum())


def same_bits(a, b):
    """Equal bit for bit (-0.0 apart from +0.0)."""
    view = torch.int32 if a.element_size() == 4 else torch.int64
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def k5_route_line(of, pattern, axis, w, table, launches, card):
    """K5 at one place of a path: the route the rule gives ``pattern`` (kept
    across calls or not) along ``axis`` for ``table``, its sum held bit for
    bit against the gather route's on the same inputs and twice, against
    ``sampled_row_sum_plain`` within SD_GRAD_TOL of ``Σ |w| · |table row|``,
    timed (CUDA graphs) beside the gather route, the plain version and
    ``torch.sparse.mm`` (CSR × dense, timed only). ``launches``: the route's
    counter from the path's run. Returns the ``kernels`` line and its
    detail."""
    from sparse_tpu_torch.kernels import _cuda
    from sparse_tpu_torch.kernels import dot as kdot

    ptr, order, pieces, idx = pattern.plan(axis)
    ws = (w if order is None else w[order]).contiguous()
    seg, other = pattern.ends[axis], pattern.ends[1 - axis]
    n_out, k, n = pattern.sizes[axis], table.shape[1], ws.shape[0]
    item = table.element_size()
    route = _cuda.row_sum_route(table.shape[0], k, item, pattern.kept, n, n_out)
    n_front = _cuda.front_bound(n, n_out, _cuda.MTTKRP_PIECE)
    partial = torch.empty(n_front * k, dtype=w.dtype, device=w.device)
    tickets = _cuda.zeroed_tickets(w.device, n_front * _cuda.row_sum_chunks(k, w.dtype, 1))
    out_g, out_r = (torch.empty((n_out, k), dtype=w.dtype, device=w.device) for _ in range(2))
    gather = lambda: _cuda.sampled_row_sum(ptr, pieces, idx, ws, table, out_g, partial, tickets)  # noqa: E731
    detail = {"of": of, "k5_route": route, "k": k, "n_out": n_out, "table_rows": table.shape[0], "nnz": n}
    if route == "sliced":
        name = "sampled_row_sum_sliced"
        launch = lambda: _cuda.sampled_row_sum(  # noqa: E731
            ptr, pieces, idx, ws, table, out_r, partial, tickets, slice_cols=_cuda.ROW_SUM_SLICE_COLS
        )
        detail["slice_cols"] = _cuda.ROW_SUM_SLICE_COLS
    elif route == "union":
        name = "sampled_row_sum_union"
        lay = pattern.union(axis, item)
        union_only = lambda: _cuda.sampled_row_sum_union(ptr, lay, ws, table, out_r)  # noqa: E731
        # the entry point's two launches: the union kernel, the gather route on the flagged blocks beside it
        launch = lambda: kdot.row_sum_union_route(ptr, idx, lay, ws, table, out_r, partial)  # noqa: E731
    else:
        name, launch = "sampled_row_sum", gather
    want = gather().clone()
    got = launch().clone()
    if not same_bits(got, want) or not same_bits(launch(), got):
        raise AssertionError(f"K5 {of}: the {route} route gave other bits than the gather route, or a second launch did")
    plain = kdot.sampled_row_sum_plain(seg, other, w, table, n_out)
    scale = kdot.sampled_row_sum_plain(seg, other, w.abs(), table.abs(), n_out)
    if bool(((got - plain).abs() > SD_GRAD_TOL * scale + 1e-30).any()):
        raise AssertionError(f"K5 {of} against sampled_row_sum_plain beyond {SD_GRAD_TOL} of its scale")
    csr = torch.sparse_csr_tensor(ptr, idx.long(), ws, (n_out, table.shape[0]))
    lib_err = float((torch.sparse.mm(csr, table) - got).abs().max())
    touched = int(torch.unique(idx).numel())
    nbytes = touched * k * item + n * (4 + item) + n_out * k * item
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * k / F32_FLOPS_PER_S * 1e3
    ms, gather_ms = time_graph(launch), time_graph(gather)
    line = {
        "name": name,
        "route": "cuda",
        "source": SOURCE[name],
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": float((got - plain).abs().max()),
        "ms": ms,
        "plain_ms": time_eager(lambda: kdot.sampled_row_sum_plain(seg, other, w, table, n_out), reps=5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_eager(lambda: torch.sparse.mm(csr, table), reps=5),
        "of": of,
        "k5_route": route,
    }
    gathered = n * k * item
    detail.update(
        {
            **{key: line[key] for key in ("ms", "launches", "plain_ms", "bound_ms", "library_ms", "max_abs_err")},
            "bound_share": max(t_bytes, t_ops) / ms,
            "bound_bytes": nbytes,
            "gather_route_ms": gather_ms,
            "equal_bits_to_gather_route": True,
            "equal_bits_twice": True,
            "gathered_bytes": gathered,
            "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
            "gather_route_tb_per_s": gathered / (gather_ms * 1e-3) / 1e12,
            "library_max_abs_diff": lib_err,
            "weights_gather_ms": 0.0 if order is None else time_graph(lambda: w[order]),
            "card": card,
        }
    )
    if route == "union":
        seg_sorted = seg if order is None else seg[order]
        union_plain = kdot.sampled_row_sum_union_plain(seg_sorted, idx, lay, ws, table, n_out)
        detail.update(
            {
                "union_kernel_ms": time_graph(union_only),
                "blocks": lay.flag.numel(),
                "blocks_flagged": int(lay.flag.sum()),
                "union_capacity": lay.union.shape[1],
                "mean_union": float(lay.n_union.double().mean()),
                "union_plain_max_abs_diff": float((union_plain - got).abs().max()),
            }
        )
    del partial, out_g, out_r, csr, plain, scale
    return line, detail


def phase_sddmm_path(dev, a, card):
    """SDDMM (BASELINE config 4) and dense × sparse through the public entry
    points, counted: ``sddmm(a, lhs, rhs)`` at the bench shape against a
    float64 oracle, against the plain version and twice bit for bit, the
    gradient of ``(w · sddmm).sum()`` (K4 and K5) against the plain
    version's and twice bit for bit, through ``kernels.sddmm`` and through
    the COO entry point (equal bit for bit); the example's shape against its
    oracle at rtol 1e-8; ``Bt @ a`` against a float64 oracle and bit for bit
    equal to ``(a.T @ Bt.T).T`` (its route through K2). Then times K4 (both
    routes; both operands MN-major, the copy rule's route and the other),
    the example's call, the backward against the first port's and each K5
    launch. Returns the ``kernels`` lines of K4 and K5 and the launches of
    the path (counts set to 0 just before it, read just after)."""
    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts
    from sparse_tpu_torch.kernels import dot as kdot
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY

    gen = torch.Generator(device=dev).manual_seed(15)
    lhs = torch.randn((M, SD_K), generator=gen, device=dev)
    rhs = torch.randn((K, SD_K), generator=gen, device=dev).T  # (128, 65,536), rows of rhs.T contiguous
    w = torch.randn(a.nnz, generator=gen, device=dev)
    bt = torch.rand((N, M), generator=gen, device=dev)
    ex_s, ex_lhs, ex_rhs, ex_want = sddmm_example(dev)
    rows, cols, s = a.coords[0], a.coords[1], a.data
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = st.sddmm(a, lhs, rhs)
    torch.cuda.synchronize()
    t_sddmm = time.perf_counter()
    ins = [t.detach().clone().requires_grad_(True) for t in (s, lhs, rhs)]
    (w * kdot.sddmm(rows, cols, *ins)).sum().backward()
    torch.cuda.synchronize()
    t_grad = time.perf_counter()
    coo_ins = [t.detach().clone().requires_grad_(True) for t in (lhs, rhs)]
    (w * st.sddmm(a, *coo_ins).data).sum().backward()
    torch.cuda.synchronize()
    t_coo_grad = time.perf_counter()
    ex_out = st.sddmm(ex_s, ex_lhs, ex_rhs)
    torch.cuda.synchronize()
    t_ex = time.perf_counter()
    xs = bt @ a
    torch.cuda.synchronize()
    t_xs = time.perf_counter()
    layout = a.T.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
    xs2 = bt @ a
    torch.cuda.synchronize()
    t_xs2 = time.perf_counter()
    launches = dict(LAUNCHES)
    for name in ("sddmm", "sampled_row_sum", "row_ell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"the SDDMM path never launched {name}: {launches}")

    # bench shape: the result's form, the oracle, the plain version, the bits
    if not isinstance(out, st.COO) or out.dtype != torch.float32 or float(out.fill_value) != 0.0:
        raise AssertionError(f"sddmm gave {type(out).__name__} {out.dtype} fill {out.fill_value}")
    if not torch.equal(out.coords, a.coords) or out.coords.data_ptr() == a.coords.data_ptr():
        raise AssertionError("sddmm: the coordinates are not a copy of the sample's")
    want, scale = sddmm_oracle(rows, cols, s, lhs, rhs.T)
    worst = {"oracle": check_sddmm("sddmm vs oracle", out.data, want, scale, SD_ORACLE_TOL)}
    plain = kdot.sddmm_plain(rows, cols, s, lhs, rhs)
    worst["plain"] = check_sddmm("K4 vs sddmm_plain", out.data, plain.double(), scale, SD_PLAIN_TOL)
    if not torch.equal(st.sddmm(a, lhs, rhs).data, out.data):
        raise AssertionError("sddmm: a second launch gave other bits")
    ins_p = [t.detach().clone().requires_grad_(True) for t in (s, lhs, rhs)]
    (w * kdot.sddmm_plain(rows, cols, *ins_p)).sum().backward()
    grad_err = {n: normalised_err(x.grad, y.grad.double()) for n, x, y in zip(("s", "lhs", "rhs"), ins, ins_p)}
    if max(grad_err.values()) > SD_GRAD_TOL:
        raise AssertionError(f"sddmm gradients against the plain version's: {grad_err}")
    if not all(torch.equal(x.grad, y.grad) for x, y in zip(ins[1:], coo_ins)):
        raise AssertionError("sddmm: the COO entry point's gradients differ from kernels.sddmm's")
    max_abs_err = float((out.data - plain).abs().max())
    del plain, want, ins_p
    # the example's shape
    np.testing.assert_allclose(ex_out.data.cpu().numpy(), ex_want, rtol=SD_EX_RTOL, err_msg="sddmm example shape")
    ex_plain = kdot.sddmm_plain(ex_s.coords[0], ex_s.coords[1], ex_s.data, ex_lhs, ex_rhs)
    ex_err = float((ex_out.data - ex_plain).abs().max())
    # dense x sparse: the oracle, and the route through a's cached transpose
    oracle = oracle_csr(*a.coords.cpu().numpy(), a.data.cpu().numpy(), (M, K))
    np.testing.assert_allclose(
        xs.cpu().numpy(), (oracle.T @ bt.cpu().numpy().T.astype(np.float64)).T, **ORACLE_TOL, err_msg="Bt @ a"
    )
    if layout is None or not torch.equal(xs, (a.T @ bt.T).T) or not torch.equal(xs, xs2):
        raise AssertionError("Bt @ a: not on a's cached transpose, or not equal bit for bit to (a.T @ Bt.T).T")
    torch.cuda.synchronize()

    lines, timing = [], {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # K4 at the two shapes, its wrapper, the plain version and torch.sparse.sampled_addmm
    shapes = {
        "bench": (rows, cols, s, lhs, rhs, launches["sddmm"], max_abs_err),
        "example": (ex_s.coords[0], ex_s.coords[1], ex_s.data, ex_lhs, ex_rhs, launches["sddmm"], ex_err),
    }
    for shape, (r, c, sv, lh, rh, n_launch, err) in shapes.items():
        o = torch.empty_like(sv)
        rh_rows = kdot._sddmm_operand(rh.T, r.numel())  # as the wrapper reads it
        launch = lambda r=r, c=c, sv=sv, lh=lh, rh_rows=rh_rows, o=o, route=None: _cuda.sddmm(  # noqa: E731
            r, c, sv, lh, rh_rows, o, route=route
        )
        pattern = torch.sparse_csr_tensor(
            torch.searchsorted(r.long(), torch.arange(lh.shape[0] + 1, device=dev)), c.long(), sv, (lh.shape[0], rh.shape[1])
        )
        library = lambda pattern=pattern, lh=lh, rh=rh, sv=sv: torch.sparse.sampled_addmm(pattern, lh, rh, beta=0.0).values() * sv
        try:
            lib_got = library()
        except RuntimeError:  # cuSPARSE may refuse a transposed view: then on a contiguous copy
            rh_c = rh.contiguous()
            library = lambda pattern=pattern, lh=lh, rh_c=rh_c, sv=sv: torch.sparse.sampled_addmm(pattern, lh, rh_c, beta=0.0).values() * sv
            lib_got = library()
        lib_err = float((lib_got - launch()).abs().max())
        item, k_dim, nnz = lh.element_size(), lh.shape[1], r.numel()
        nbytes = (int(torch.unique(r).numel()) + int(torch.unique(c).numel())) * k_dim * item + nnz * (4 + 4 + 2 * item)
        flops = 2 * nnz * k_dim
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (F32_FLOPS_PER_S if item == 4 else F32_FLOPS_PER_S / 2) * 1e3
        route = _cuda.sddmm_route(k_dim, item, _cuda.sddmm_vec(lh) and _cuda.sddmm_vec(rh_rows))
        epw = _cuda.sddmm_entries_per_warp(nnz, sms)
        lhs_loads = kept_row_loads(r, epw) if route == "kept_row" else nnz
        ms = time_graph(launch)
        line = {
            "name": "sddmm",
            "route": "cuda",
            "source": SOURCE["sddmm"],
            "replaces": REPLACES["sddmm"],
            "launches": n_launch,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_eager(lambda: kdot.sddmm_plain(r, c, sv, lh, rh), reps=5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_eager(library, reps=5),
        }
        if shape == "example":
            line["shape"] = "example"
        lines.append(line)
        gathered = (lhs_loads + nnz) * k_dim * item
        copied = rh_rows.data_ptr() != rh.data_ptr()
        timing[shape] = {
            **line,
            "k4_route": route,
            "kernel_ms_l2_flushed": time_cold(launch),
            "wrapper_ms_eager": time_eager(lambda: kdot.sddmm(r, c, sv, lh, rh), reps=5),
            "rhs_t_copied": copied,
            "rhs_t_copy_ms": time_eager(lambda: rh.T.contiguous(), reps=5) if copied else 0.0,
            "entries_per_warp": epw,
            "bound_bytes": nbytes,
            "bound_share": max(t_bytes, t_ops) / ms,
            "lhs_row_loads": lhs_loads,
            "gathered_bytes": gathered,
            "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
            "l2_floor_ms": gathered / L2_ROW_BYTES_PER_S * 1e3,
            "library_max_abs_diff": lib_err,
            "card": card,
            "shape": {
                "m": lh.shape[0], "n": rh.shape[1], "k": k_dim, "nnz": nnz, "dtype": str(lh.dtype).replace("torch.", "")
            },
        }
        if shape == "bench":
            # both routes on the same operands, bit for bit alike
            by_route = {rt: launch(route=rt).clone() for rt in _cuda.SDDMM_ROUTES}
            if not torch.equal(by_route["kept_row"], by_route["per_entry"]):
                raise AssertionError("K4: the kept-row and per-entry routes gave other bits")
            timing[shape]["route_ms"] = {rt: time_graph(lambda rt=rt: launch(route=rt)) for rt in _cuda.SDDMM_ROUTES}
            timing[shape]["per_entry_gathered_bytes"] = 2 * nnz * k_dim * item
        del o, pattern, lib_got

    # the bench mask with both operands MN-major (a weight gradient's layout): the
    # copy rule's route (the wrapper, copies included) and the strided reads it declines
    lhs_mn = torch.randn((SD_K, M), generator=gen, device=dev).T
    rhs_mn = torch.randn((SD_K, K), generator=gen, device=dev)
    in_place = [_cuda.sddmm_reads_in_place(tuple(t.shape), t.stride(), 4, a.nnz) for t in (lhs_mn, rhs_mn.T)]
    o = torch.empty_like(s)
    strided = lambda: _cuda.sddmm(rows, cols, s, lhs_mn, rhs_mn.T, o)
    chosen = kdot.sddmm(rows, cols, s, lhs_mn, rhs_mn)
    if not torch.equal(chosen, strided()):
        raise AssertionError("K4: MN-major operands read in place gave other bits than their copies")
    mn_major = {
        "read_in_place": {"lhs": in_place[0], "rhs_t": in_place[1]},
        "chosen": "in_place" if all(in_place) else "copy",
        "chosen_ms_eager": time_eager(lambda: kdot.sddmm(rows, cols, s, lhs_mn, rhs_mn), reps=5),
        "copies_ms_eager": time_eager(lambda: (lhs_mn.contiguous(), rhs_mn.T.contiguous()), reps=5),
        "declined_in_place_ms": time_graph(strided, reps=5),
        "equal_bit_for_bit": True,
    }
    del lhs_mn, rhs_mn, o, chosen

    # the backward at the bench shape: the first port's (torch ops) and K5's
    new_bw, g1, g2 = backward_ms_and_peak(kdot.sddmm, rows, cols, s, lhs, rhs, w, reps=20)
    if not all(torch.equal(x, y) for x, y in zip(g1, g2)):
        raise AssertionError("sddmm backward: a second call gave other bits")
    block = a.nnz * SD_K * 4
    if new_bw["extra_peak_bytes"] >= block:
        raise AssertionError(f"sddmm backward allocated {new_bw['extra_peak_bytes']} bytes; an (nnz, K) block: {block}")
    del g1, g2
    # the COO entry point's: its rows known sorted and its pattern kept on the array across calls
    kept = a.peek_layout("sddmm_pattern", (M, K))
    if kept is None or kept.ordered != (True, False):
        raise AssertionError("sddmm: the COO entry point kept no pattern of its sorted rows")
    coo_bw, _, _ = backward_ms_and_peak(
        lambda r, c, sv, lh, rh: kdot._sddmm(r, c, sv, lh, rh, pattern=kept), rows, cols, s, lhs, rhs, w, reps=20
    )
    plain_bw = plain_backward_ms_and_peak(rows, cols, s, lhs, rhs, w)
    backward = {"plain": plain_bw, "k5": new_bw, "k5_coo_pattern_kept": coo_bw}
    # each K5 launch of the backward alone: d lhs (rows, in place) and d rhs (columns, through the stable sort)
    gs = w * s
    plan = kdot.SddmmPattern(rows, cols, M, K, rows_sorted=True)
    k5 = {}
    for of, axis, table, n_out in (("d_lhs", 0, rhs.T, M), ("d_rhs", 1, lhs, K)):
        ptr, order, pieces, idx = plan.plan(axis)
        seg = plan.ends[axis]
        w_seg = gs if order is None else gs[order]
        n_front = _cuda.front_bound(a.nnz, n_out, _cuda.MTTKRP_PIECE)
        o = torch.empty((n_out, SD_K), device=dev)
        partial = torch.empty(n_front * SD_K, device=dev)
        tickets = _cuda.zeroed_tickets(dev, n_front * _cuda.row_sum_chunks(SD_K, torch.float32))
        args = (ptr, pieces, idx, w_seg, table, o, partial, tickets)
        launch = lambda args=args: _cuda.sampled_row_sum(*args)  # noqa: E731
        got = launch().clone()
        if not torch.equal(got, launch()):
            raise AssertionError(f"K5 {of}: a second launch gave other bits")
        other = plan.ends[1 - axis]
        want_p = kdot.sampled_row_sum_plain(seg, other, gs, table, n_out)
        scale_p = kdot.sampled_row_sum_plain(seg, other, gs.abs(), table.abs(), n_out)
        if bool(((got - want_p).abs() > SD_GRAD_TOL * scale_p + 1e-30).any()):
            raise AssertionError(f"K5 {of} against sampled_row_sum_plain beyond {SD_GRAD_TOL} of its scale")
        csr = torch.sparse_csr_tensor(ptr, idx.long(), w_seg, (n_out, table.shape[0]))
        lib_err = float((torch.sparse.mm(csr, table) - got).abs().max())
        touched = int(torch.unique(other).numel())
        nbytes = touched * SD_K * 4 + a.nnz * (4 + 4) + n_out * SD_K * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * a.nnz * SD_K / F32_FLOPS_PER_S * 1e3
        ms = time_graph(launch)
        line = {
            "name": "sampled_row_sum",
            "route": "cuda",
            "source": SOURCE["sampled_row_sum"],
            "replaces": REPLACES["sampled_row_sum"],
            "launches": launches["sampled_row_sum"],
            "max_abs_err": float((got - want_p).abs().max()),
            "ms": ms,
            "plain_ms": time_eager(lambda: kdot.sampled_row_sum_plain(seg, other, gs, table, n_out), reps=5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_eager(lambda csr=csr, table=table: torch.sparse.mm(csr, table), reps=5),
            "of": of,
            "k5_route": "gather",
        }
        lines.append(line)
        gathered = a.nnz * SD_K * 4
        k5[of] = {
            **line,
            "bound_bytes": nbytes,
            "bound_share": max(t_bytes, t_ops) / ms,
            "gathered_bytes": gathered,
            "gathered_tb_per_s": gathered / (ms * 1e-3) / 1e12,
            "l2_floor_ms": gathered / L2_ROW_BYTES_PER_S * 1e3,
            "library_max_abs_diff": lib_err,
            "order": "in place" if order is None else "stable sort",
            "weights_gather_ms": 0.0 if order is None else time_graph(lambda order=order: gs[order]),
            "pieces": int(pieces[-1]),
            "kernel_ms_l2_flushed": time_cold(launch),
            "card": card,
        }
        # the COO entry point's kept pattern: by the route rule the gather route
        # too (K = 128 rows of 512 bytes, segments of 32 entries); the same bits
        fwd = lambda axis=axis, table=table: kdot._row_sum_forward(kept, axis, gs, table)  # noqa: E731
        if not same_bits(fwd(), got):
            raise AssertionError(f"K5 {of}: the COO entry point's route gave other bits than the gather route")
        k5[of]["coo_entry_point"] = {
            "k5_route": _cuda.row_sum_route(table.shape[0], SD_K, 4, kept.kept, a.nnz, n_out),
            "ms_incl_weights_gather": time_graph(fwd),
            "equal_bits_to_gather_route": True,
        }
        del o, partial, got, want_p, scale_p, csr, w_seg
    # the COO entry point's kept pattern at K = 64 (rows of 256 bytes): by the
    # route rule the union route, whose layout flags every block of this random
    # mask (too little reuse), so the gather route beside it takes them all;
    # the backward counted alone, each launch against the gather route's bits
    ins64 = [
        torch.randn(shape, generator=gen, device=dev).requires_grad_(True)
        for shape in ((M, SD_NARROW_K), (SD_NARROW_K, K))
    ]
    loss64 = (w * st.sddmm(a, *ins64).data).sum()
    torch.cuda.synchronize()
    reset_launch_counts()
    loss64.backward()
    torch.cuda.synchronize()
    backward64 = {kn: c for kn, c in LAUNCHES.items() if c}
    n_union = backward64.get("sampled_row_sum_union", 0)
    if n_union < 1 or backward64.get("sampled_row_sum") != n_union:
        raise AssertionError(f"sddmm backward at K = {SD_NARROW_K}: K5's union route and gather expected: {backward64}")
    for of, axis, table in (
        ("d_lhs_k64_kept", 0, ins64[1].detach().T.contiguous()),
        ("d_rhs_k64_kept", 1, ins64[0].detach()),
    ):
        line, k5[of] = k5_route_line(of, kept, axis, gs, table, backward64["sampled_row_sum_union"], card)
        if k5[of]["k5_route"] != "union":
            raise AssertionError(f"K5 {of}: the {k5[of]['k5_route']} route, expected the union route")
        if k5[of]["ms"] > K5_ALL_FLAGGED_SLACK * k5[of]["gather_route_ms"]:
            raise AssertionError(
                f"K5 {of}: the union route ({k5[of]['ms']} ms, {k5[of]['blocks_flagged']} of {k5[of]['blocks']} blocks "
                f"flagged) past {K5_ALL_FLAGGED_SLACK} times the gather route's {k5[of]['gather_route_ms']} ms"
            )
        k5[of]["launches_backward"] = backward64
        lines.append(line)
    del ins64, loss64
    plan_ms = time_eager(lambda: kdot.SddmmPattern(rows, cols, M, K).plan(1), reps=5)
    cols32 = cols.int()
    sort_ms = time_eager(lambda: torch.sort(cols32, stable=True), reps=20)
    log(
        json.dumps(
            {
                "sddmm_path": "ok",
                "nnz": a.nnz,
                "k": SD_K,
                "launches": launches,
                "sddmm_s": t_sddmm - t0,
                "sddmm_and_gradient_s": t_grad - t_sddmm,
                "coo_sddmm_and_gradient_s": t_coo_grad - t_grad,
                "example_s": t_ex - t_coo_grad,
                "worst_over_scale": worst,
                "gradient_err_vs_plain": grad_err,
                "backward": backward,
                "k5": k5,
                "column_order_ms_eager": plan_ms,
                "column_sort_ms": sort_ms,
                "mn_major": mn_major,
                "example": {"len": SD_EX_LEN, "nnz": ex_s.nnz, "rtol": SD_EX_RTOL, "max_abs_err_vs_plain": ex_err},
                "dense_x_sparse": {
                    "shape": [N, M],
                    "first_s_incl_transpose_and_layout": t_xs - t_ex,
                    "second_s": t_xs2 - t_xs,
                    "device_ms": device_ms(lambda: bt @ a),
                    "equal_bit_for_bit_to_aT_BtT": True,
                },
                "k4": timing,
                "card": card,
            }
        )
    )
    return lines, launches


# SpGEMM (BASELINE config 2's example, examples/matmul_example.py): the
# bench matrix squared (float32, values against a float64 oracle at
# SG_RTOL); the example's two 100,000^2 GCXS at density 1e-5 (float64, its
# own limit |got - scipy| < SG_EX_ATOL); the traceable form at
# bench_regression.py:248-270's shape (two 4,096^2 at density 5e-4,
# float32) in a CUDA graph, against the eager product at SG_GRAPH_RTOL
SG_RTOL, SG_EX_LEN, SG_EX_DENSITY, SG_EX_ATOL = 1e-5, 100_000, 1e-5, 1e-10
SG_JIT_LEN, SG_JIT_DENSITY, SG_GRAPH_RTOL = 4096, 5e-4, 1e-6
SG_REPS = 5


def _unique_draw(rng, n, density, dtype):
    """Rows, columns and values of an ``n`` x ``n`` matrix at ``density``:
    ``n^2 · density`` distinct positions, values uniform in [0, 1)."""
    lin = np.unique(rng.integers(0, n * n, size=round(n * n * density), dtype=np.int64))
    while lin.size < round(n * n * density):
        lin = np.unique(np.concatenate([lin, rng.integers(0, n * n, size=round(n * n * density) - lin.size)]))
    return lin // n, lin % n, rng.random(lin.size).astype(dtype)


def _same_product(name, c1, c2):
    """Two results of one product: the same coordinates and the same bits."""
    if not (torch.equal(c1.coords, c2.coords) and torch.equal(c1.data.view(torch.int32), c2.data.view(torch.int32))):
        raise AssertionError(f"{name}: two calls differ")


def s1_pass_ms(a, index_dtype, reps=SG_REPS):
    """Device ms of S1's symbolic and numeric passes alone on ``a @ a``
    (median of ``reps``, CUDA events around each), through the helpers that
    ``kernels.spgemm.spgemm_coords`` runs them by, and the passes' output
    (coordinates in ``index_dtype`` and sums, those equal to zero kept). A
    pass's time holds its launch and the torch ops beside it (the symbolic
    pass's row pointer, the numeric pass's allocations); the read back of the
    size between them is outside both."""
    from sparse_tpu_torch.kernels import spgemm as kspgemm

    ops = kspgemm.s1_operands(*a.coords, a.data, *a.coords, a.data, m=M, k=K, n=K, dt=a.data.dtype)
    times = {"symbolic": [], "numeric": []}
    out = vals = None
    for _ in range(reps + 1):  # the first pair warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        row_ptr = kspgemm.s1_symbolic(ops)
        end.record()
        nnz = int(row_ptr[-1])
        times["symbolic"].append(start.elapsed_time(end))
        del out, vals
        start.record()
        out, vals, _ = kspgemm.s1_numeric(ops, row_ptr, nnz, index_dtype)
        end.record()
        end.synchronize()
        times["numeric"].append(start.elapsed_time(end))
    return {name: float(np.median(t[1:])) for name, t in times.items()}, out, vals


def phase_spgemm_path(dev, a, card):
    """Sparse × sparse products through the public entry points, counted
    (S1's two passes, no other kernel): ``a @ a`` of the bench matrix
    against scipy's ``csr @ csr`` on the host (coordinates exactly, values at
    SG_RTOL of a float64 oracle), twice bit for bit, S1 bit for bit against
    its plain version on the same inputs, their device ms, S1's passes
    alone, peak memory and byte bound beside cuSPARSE's ``torch.sparse.mm``
    of the two CSRs (timed only); the example's GCXS pair (CSR × CSR and
    CSC × CSC) within SG_EX_ATOL of scipy; ``jitops.spgemm`` captured in a
    CUDA graph and replayed after the data changed, against the eager
    product; and ``einsum("ij,jk->ik", s, s)`` bit for bit ``s @ s``.
    Returns the line's fields and S1's kernel row."""
    import scipy.sparse

    import sparse_tpu_torch as st
    from sparse_tpu_torch.kernels import LAUNCHES, product_count, reset_launch_counts
    from sparse_tpu_torch.kernels import spgemm as kspgemm

    t_phase = time.perf_counter()
    n_products = product_count(a.coords[1], a.coords[0], K)
    torch.cuda.synchronize()
    reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c1 = a @ a
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(LAUNCHES)
    if launches["spgemm"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"a @ a: S1's two passes did not run alone: {launches}")
    c2 = a @ a
    _same_product("a @ a", c1, c2)
    if c1.shape != (M, K) or c1.data.dtype != torch.float32 or c1.data.device.type != "cuda":
        raise AssertionError(f"a @ a: {c1}")
    if not bool(torch.isfinite(c1.data).all()):
        raise AssertionError("a @ a: values not finite")
    del c2
    ms = device_ms(lambda: a @ a, reps=SG_REPS)
    from chip_elemwise_profile import profile

    wall_ms, busy_ms, top = profile(lambda: a @ a)  # torch.profiler: where the call's time goes

    # the oracle: scipy's csr @ csr on the host, in float64
    t0 = time.perf_counter()
    coords = a.coords.cpu().numpy()
    ref = scipy.sparse.csr_matrix((a.data.cpu().numpy().astype(np.float64), (coords[0], coords[1])), shape=(M, K))
    want = ref @ ref
    want.sort_indices()
    want.eliminate_zeros()
    oracle_s = time.perf_counter() - t0
    got = c1.coords.cpu().numpy()
    rows = np.repeat(np.arange(M, dtype=np.int64), np.diff(want.indptr))
    if got.shape[1] != want.nnz or not (np.array_equal(got[0], rows) and np.array_equal(got[1], want.indices)):
        raise AssertionError(f"a @ a: {got.shape[1]} coordinates, scipy {want.nnz}, or they differ")
    np.testing.assert_allclose(c1.data.cpu().numpy().astype(np.float64), want.data, rtol=SG_RTOL, err_msg="a @ a")
    del rows, got, want

    # S1 against its plain version (the torch ops) on the same inputs, bit for bit
    ra, ca, va = a.coords[0], a.coords[1], a.data
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p_rows, p_cols, p_vals = kspgemm.spgemm(ra, ca, va, ra, ca, va, m=M, k=K, n=K)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - base
    if not (torch.equal(c1.coords.long(), torch.stack([p_rows, p_cols])) and torch.equal(c1.data.view(torch.int32), p_vals.view(torch.int32))):
        raise AssertionError("a @ a: S1 differs from its plain version")
    s1_err = float((c1.data - p_vals).abs().max())
    del p_rows, p_cols, p_vals
    plain_ms = device_ms(lambda: kspgemm.spgemm(ra, ca, va, ra, ca, va, m=M, k=K, n=K), reps=SG_REPS)
    route_ms = device_ms(lambda: kspgemm.spgemm_coords(ra, ca, va, ra, ca, va, m=M, k=K, n=K, index_dtype=c1.coords.dtype), reps=SG_REPS)
    passes, out, vals = s1_pass_ms(a, c1.coords.dtype)
    keep = vals != 0  # the passes keep the sums equal to zero, which the entry point drops
    if not (torch.equal(out[:, keep], c1.coords) and torch.equal(vals[keep].view(torch.int32), c1.data.view(torch.int32))):
        raise AssertionError("a @ a: S1's passes alone differ from the entry point")
    del out, vals, keep
    torch.cuda.empty_cache()
    nnz_out = c1.nnz
    idx_bytes = a.coords.element_size() * 2 + a.data.element_size()
    out_bytes = nnz_out * (c1.coords.element_size() * 2 + c1.data.element_size())
    bound_ms = (2 * a.nnz * idx_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    del c1

    # cuSPARSE on the same inputs, timed only
    a_csr = a.asformat("csr")
    csr = torch.sparse_csr_tensor(a_csr.indptr.long(), a_csr.indices.long(), a_csr.data, size=(M, K))
    del a_csr
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lib = torch.sparse.mm(csr, csr)
    torch.cuda.synchronize()
    lib_peak = torch.cuda.max_memory_allocated() - base
    lib_nnz = lib._nnz()
    del lib
    lib_ms = device_ms(lambda: torch.sparse.mm(csr, csr), reps=SG_REPS)
    del csr
    torch.cuda.empty_cache()

    # the example's GCXS pair (examples/matmul_example.py), float64
    rng = np.random.default_rng(0)
    ex = {}
    ea, eb = (_unique_draw(rng, SG_EX_LEN, SG_EX_DENSITY, np.float64) for _ in range(2))
    sa, sb = (scipy.sparse.csr_matrix((v, (r, c)), shape=(SG_EX_LEN,) * 2) for r, c, v in (ea, eb))
    want = sa @ sb
    for fmt, ca in (("gcxs", (0,)), ("csc", (1,))):
        ga, gb = (st.COO(np.stack([r, c]), v, shape=(SG_EX_LEN,) * 2, device=dev).asformat(fmt) for r, c, v in (ea, eb))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = ga @ gb
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not isinstance(g, st.GCXS) or g.compressed_axes != ca or g.data.device.type != "cuda":
            raise AssertionError(f"example {fmt}: {g}")
        err = float(abs(g.to_scipy_sparse().tocsr() - want).max())
        if not err < SG_EX_ATOL:
            raise AssertionError(f"example {fmt}: max |got - scipy| {err}")
        ex[fmt] = {"compressed_axes": list(ca), "nnz": g.nnz, "max_abs_err_vs_scipy": err, "first_s": wall,
                   "device_ms": device_ms(lambda: ga @ gb, reps=SG_REPS)}
    ex_products = product_count(torch.as_tensor(ea[1]), torch.as_tensor(eb[0]), SG_EX_LEN)

    # the traceable form in a CUDA graph (bench_regression.py:248-270's shape)
    rng = np.random.default_rng(2)
    ja, jb = (st.COO(np.stack([r, c]), v, shape=(SG_JIT_LEN,) * 2, device=dev)
              for r, c, v in (_unique_draw(rng, SG_JIT_LEN, SG_JIT_DENSITY, np.float32) for _ in range(2)))
    cap = max(product_count(ja.coords[1], jb.coords[0], SG_JIT_LEN), 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        st.jitops.spgemm(ja, jb, product_capacity=cap)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, nnz = st.jitops.spgemm(ja, jb, product_capacity=cap)
    # new values in the captured buffers: the replay reads them
    ja.data.copy_(torch.rand(ja.nnz, device=dev, generator=torch.Generator(device=dev).manual_seed(3)) + 0.5)
    jb.data.copy_(torch.rand(jb.nnz, device=dev, generator=torch.Generator(device=dev).manual_seed(4)) + 0.5)
    graph.replay()
    torch.cuda.synchronize()
    eager = st.COO._make(ja.coords, ja.data, ja.shape, ja.fill_value) @ st.COO._make(jb.coords, jb.data, jb.shape, jb.fill_value)
    n = int(nnz)
    if n != eager.nnz or not torch.equal(out.coords[:, :n].long(), eager.coords.long()):
        raise AssertionError(f"jitops.spgemm in a CUDA graph: {n} entries, eager {eager.nnz}, or coordinates differ")
    torch.testing.assert_close(out.data[:n], eager.data, rtol=SG_GRAPH_RTOL, atol=0)
    if bool((out.data[n:] != 0).any()) or bool((out.coords[:, n:] != 0).any()):
        raise AssertionError("jitops.spgemm: padding is not zero")
    graph_ms = device_ms(graph.replay, reps=SG_REPS)
    ein = st.einsum("ij,jk->ik", ja, jb)
    if not (torch.equal(ein.coords, eager.coords) and torch.equal(ein.data.view(torch.int32), eager.data.view(torch.int32))):
        raise AssertionError("einsum('ij,jk->ik', s, s) differs from s @ s")
    jit = {"shape": [SG_JIT_LEN] * 2, "nnz": [ja.nnz, jb.nnz], "product_capacity": cap, "nnz_out": n,
           "graph_replay_ms": graph_ms, "eager_ms": device_ms(lambda: ja @ jb, reps=SG_REPS), "einsum_bit_for_bit": True}
    del graph, out, nnz, eager, ein
    torch.cuda.empty_cache()
    return {
        "spgemm_path": "ok",
        "bench_square": {
            "shape": [M, K], "nnz_a": a.nnz, "product_count": n_products, "nnz_out": nnz_out,
            "device_ms": ms, "first_call_s": first_s, "peak_memory_bytes": peak,
            "s1_route_ms": route_ms, "s1_symbolic_ms": passes["symbolic"], "s1_numeric_ms": passes["numeric"],
            "plain_ms": plain_ms, "plain_peak_memory_bytes": plain_peak, "s1_equals_plain_bit_for_bit": True,
            "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
            "cusparse_ms": lib_ms, "cusparse_peak_memory_bytes": lib_peak, "cusparse_nnz": lib_nnz,
            "profile": {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms, "top5_kernels_ms_count": top},
            "same_bits_twice": True, "coords_equal_scipy": True, "rtol_vs_f64": SG_RTOL, "scipy_oracle_s": oracle_s,
        },
        "example_gcxs": {"len": SG_EX_LEN, "density": SG_EX_DENSITY, "product_count": ex_products, **ex},
        "jitops_cuda_graph": jit,
        "launches": launches,
        "seconds": time.perf_counter() - t_phase,
        "card": card,
    }, {
        "name": "S1 spgemm (spgemm_path: a @ a, bench matrix, float32)",
        "route": "cuda",
        "source": SOURCE["spgemm"],
        "replaces": REPLACES["spgemm"],
        "launches": launches["spgemm"],  # the symbolic and the numeric pass
        "max_abs_err": s1_err,  # against the plain version: the same bits
        "ms": passes["symbolic"] + passes["numeric"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": lib_ms,
        "symbolic_ms": passes["symbolic"],
        "numeric_ms": passes["numeric"],
        "entry_ms": ms,  # a @ a, eager: the row pointers, the plan, both passes and two reads back
        "peak_memory_bytes": peak,
        "plain_peak_memory_bytes": plain_peak,
        "library_peak_memory_bytes": lib_peak,
    }


ELEM_RTOL = 1e-6  # float32 results against the float64 scipy / bincount oracle
ELEM_REPS = 5
R_ROWS = 64  # stored rows of the (65,536, 1) column r
DENSE_NATURE = (4096, 1e-3)  # var/std shape: a 4,096^2 matrix at density 1e-3


def device_ms(fn, reps=ELEM_REPS):
    """Median device ms of one eager call of ``fn`` (CUDA events around it;
    the call's reads back to the host included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bits_equal(x, y):
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y) and x.dtype == y.dtype
    return np.asarray(x).tobytes() == np.asarray(y).tobytes()


def check_sparse_2d(name, got, want, dtype, fill=0.0):
    """A 2-D port result (COO or GCXS, on the card) against a scipy float64
    oracle: coordinates exactly, values at ELEM_RTOL, dtype and fill."""
    coo = got.tocoo()
    if coo.data.device.type != "cuda":
        raise AssertionError(f"{name}: result on {coo.data.device}")
    if np.dtype(str(coo.dtype).replace("torch.", "")) != np.dtype(dtype) or float(got.fill_value) != fill:
        raise AssertionError(f"{name}: dtype {coo.dtype} fill {got.fill_value}, want {np.dtype(dtype)} {fill}")
    w = want.tocoo()
    keep = w.data != fill
    order = np.lexsort((w.col[keep], w.row[keep]))
    rows, cols, vals = w.row[keep][order], w.col[keep][order], w.data[keep][order]
    coords = coo.coords.cpu().numpy()
    if coords.shape[1] != rows.size or not (np.array_equal(coords[0], rows) and np.array_equal(coords[1], cols)):
        raise AssertionError(f"{name}: {coords.shape[1]} coordinates, the oracle {rows.size}, or they differ")
    np.testing.assert_allclose(coo.data.cpu().numpy().astype(np.float64), vals.astype(np.float64), rtol=ELEM_RTOL, err_msg=name)
    return coo.nnz


def check_entries(name, got, lin, vals, dtype, fill=0.0):
    """A port result (on the card) against the oracle's raveled positions
    ``lin`` and float64 values: positions exactly, values at ELEM_RTOL,
    dtype and fill value as NumPy's."""
    coo = got.tocoo()
    if coo.data.device.type != "cuda":
        raise AssertionError(f"{name}: result on {coo.data.device}")
    if np.dtype(str(coo.dtype).replace("torch.", "")) != np.dtype(dtype) or float(got.fill_value) != fill:
        raise AssertionError(f"{name}: dtype {coo.dtype} fill {got.fill_value}, want {np.dtype(dtype)} {fill}")
    got_lin = np.ravel_multi_index(tuple(coo.coords.cpu().numpy().astype(np.int64)), coo.shape)
    if not np.array_equal(got_lin, lin):
        raise AssertionError(f"{name}: {got_lin.size} entries, the oracle {lin.size}, or their positions differ")
    np.testing.assert_allclose(coo.data.cpu().numpy().astype(np.float64), vals, rtol=ELEM_RTOL, err_msg=name)
    return coo.nnz


def check_sparse_1d(name, got, want, dtype, fill=0.0):
    """A 1-D (or kept-axes, raveled) port result against a dense float64
    oracle vector: the entries where the oracle is not ``fill``."""
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    nz = np.flatnonzero(want != fill)
    return check_entries(name, got, nz, want[nz], dtype, fill)


def phase_elemwise_2d(dev, a):
    """The slice at the bench shape through the public entry points, float32:
    unions, broadcasting, a dense row, ufuncs, casts and reductions of COO,
    CSR and CSC arrays, each against a float64 scipy oracle; the float
    reductions twice, the same bits; each timed (device ms, median of 5)
    beside torch.sparse where it has the operation."""
    import scipy.sparse

    import sparse_tpu_torch as st

    rng = np.random.default_rng(7)
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    b = st.COO(np.stack([lin // K, lin % K]), rng.random(NNZ_DRAWS, dtype=np.float32), shape=(M, K), device=dev)
    d = torch.as_tensor(rng.random(K, dtype=np.float32), device=dev)
    r_rows = np.sort(rng.choice(M, size=R_ROWS, replace=False))
    r_vals = rng.random(R_ROWS, dtype=np.float32)
    r = st.COO(np.stack([r_rows, np.zeros(R_ROWS, np.int64)]), r_vals, shape=(M, 1), device=dev)
    a1 = st.COO(a.coords, a.data, shape=(M, K), fill_value=1.0, has_duplicates=False, sorted=True)
    csr, csc, csr_b = a.asformat("csr"), a.asformat("csc"), b.asformat("csr")
    torch.cuda.synchronize()

    def host(x):
        c = x.coords.cpu().numpy()
        return scipy.sparse.csr_matrix((x.data.cpu().numpy().astype(np.float64), (c[0], c[1])), shape=x.shape)

    A, B = host(a), host(b)
    R = scipy.sparse.csr_matrix(
        (np.repeat(r_vals.astype(np.float64), K), (np.repeat(r_rows, K), np.tile(np.arange(K), R_ROWS))), shape=(M, K)
    )
    dn = d.cpu().numpy().astype(np.float64)
    counts_row = np.diff(A.indptr)
    ops = {
        "a + b": (lambda: a + b, lambda: A + B, "2d", np.float32, 0.0),
        "a > b": (lambda: a > b, lambda: (A > B).astype(np.float64), "2d", np.bool_, 0.0),
        "(a + b) * (a > b)": (lambda: (a + b) * (a > b), lambda: (A + B).multiply(A > B), "2d", np.float32, 0.0),
        "a * d[None, :]": (lambda: a * d[None, :], lambda: A.multiply(dn[None, :]), "2d", np.float32, 0.0),
        "a + r": (lambda: a + r, lambda: A + R, "2d", np.float32, 0.0),
        "sin(a)": (lambda: np.sin(a), lambda: scipy.sparse.csr_matrix((np.sin(A.data), A.indices, A.indptr), shape=A.shape), "2d", np.float32, 0.0),
        "a.astype(float64)": (lambda: a.astype(np.float64), lambda: A, "2d", np.float64, 0.0),
        "a.sum()": (lambda: a.sum(), lambda: A.sum(), "0d", np.float32, None),
        "a.sum(axis=0)": (lambda: a.sum(axis=0), lambda: A.sum(axis=0), "1d", np.float32, 0.0),
        "a.sum(axis=1)": (lambda: a.sum(axis=1), lambda: A.sum(axis=1), "1d", np.float32, 0.0),
        "a.max(axis=1)": (lambda: a.max(axis=1), lambda: A.max(axis=1).toarray(), "1d", np.float32, 0.0),
        "a.min(axis=0)": (lambda: a.min(axis=0), lambda: A.min(axis=0).toarray(), "1d", np.float32, 0.0),
        "a.mean(axis=1)": (lambda: a.mean(axis=1), lambda: A.sum(axis=1) / K, "1d", np.float32, 0.0),
        "(a > 0.5).any(axis=0)": (lambda: (a > 0.5).any(axis=0), lambda: ((A > 0.5).sum(axis=0) > 0), "1d", np.bool_, 0.0),
        "a(fill 1).sum(axis=1)": (
            lambda: a1.sum(axis=1),
            lambda: np.where(counts_row > 0, np.asarray(A.sum(axis=1)).ravel() + (K - counts_row), float(K)),
            "1d",
            np.float32,
            float(K),
        ),
        "csr.sum(axis=1)": (lambda: csr.sum(axis=1), lambda: A.sum(axis=1), "1d", np.float32, 0.0),
        "csr.sum(axis=0)": (lambda: csr.sum(axis=0), lambda: A.sum(axis=0), "1d", np.float32, 0.0),
        "csc.max(axis=0)": (lambda: csc.max(axis=0), lambda: A.max(axis=0).toarray(), "1d", np.float32, 0.0),
        "csr + csr_b": (lambda: csr + csr_b, lambda: A + B, "2d", np.float32, 0.0),
    }
    At = torch.sparse_coo_tensor(a.coords.long(), a.data, (M, K)).coalesce()
    Bt = torch.sparse_coo_tensor(b.coords.long(), b.data, (M, K)).coalesce()
    library = {
        "a + b": lambda: (At + Bt).coalesce(),
        "a.sum()": lambda: torch.sparse.sum(At),
        "a.sum(axis=0)": lambda: torch.sparse.sum(At, dim=0),
        "a.sum(axis=1)": lambda: torch.sparse.sum(At, dim=1),
    }
    floats_twice = {"a.sum()", "a.sum(axis=0)", "a.sum(axis=1)", "a.mean(axis=1)", "a(fill 1).sum(axis=1)", "csr.sum(axis=1)", "csr.sum(axis=0)"}
    rows = {}
    for name, (run, oracle, kind, dtype, fill) in ops.items():
        got = run()
        torch.cuda.synchronize()
        want = oracle()
        if kind == "0d":
            if got.shape != () or got.data.device.type != "cuda":
                raise AssertionError(f"{name}: shape {got.shape} on {got.data.device}")
            np.testing.assert_allclose(float(got.fill_value), float(want), rtol=ELEM_RTOL, err_msg=name)
            nnz = 1
        elif kind == "1d":
            nnz = check_sparse_1d(name, got, np.asarray(want, dtype=np.float64), dtype, fill)
        else:
            nnz = check_sparse_2d(name, got, want, dtype, fill)
        if name == "csr + csr_b" and not (isinstance(got, st.GCXS) and got.compressed_axes == (0,)):
            raise AssertionError(f"csr + csr_b gave {type(got).__name__}, not a GCXS compressed along rows")
        if name in floats_twice:
            again = run()
            if not (_bits_equal(again.fill_value, got.fill_value) and (got.ndim == 0 or _bits_equal(again.tocoo().data, got.tocoo().data))):
                raise AssertionError(f"{name}: a second call gave other bits")
        row = {"ms": device_ms(run), "nnz": nnz}
        if name in library:
            row["torch_sparse_ms"] = device_ms(library[name])
        rows[name] = row
        del got
    return rows


def phase_elemwise_3d(t):
    """The MTTKRP tensor (100,000 x 2,000 x 2,000, 9,999,883 entries):
    sums over (1, 2) and over 0 (4M kept positions), a max over axis 2 and a
    dense (1, 2000, 1) scale, against np.bincount / np.maximum.reduceat in
    float64; the float reductions twice, the same bits."""
    coords = t.coords.cpu().numpy().astype(np.int64)
    vals = t.data.cpu().numpy().astype(np.float64)
    w = torch.as_tensor(np.random.default_rng(11).random((1, MT_J, 1), dtype=np.float32), device=t.device)
    wn = w.cpu().numpy().astype(np.float64).reshape(-1)
    ij = coords[0] * MT_J + coords[1]
    starts = np.flatnonzero(np.concatenate([[True], ij[1:] != ij[:-1]]))
    def dense_oracle(want):
        nz = np.flatnonzero(want)
        return nz, want[nz]

    ops = {
        "t.sum(axis=(1, 2))": (lambda: t.sum(axis=(1, 2)), lambda: dense_oracle(np.bincount(coords[0], weights=vals, minlength=MT_I))),
        "t.sum(axis=0)": (
            lambda: t.sum(axis=0),
            lambda: dense_oracle(np.bincount(coords[1] * MT_K + coords[2], weights=vals, minlength=MT_J * MT_K)),
        ),
        # entries sorted by (i, j, k): each (i, j) run's maximum, all positive
        "t.max(axis=2)": (lambda: t.max(axis=2), lambda: (ij[starts], np.maximum.reduceat(vals, starts))),
    }
    rows = {}
    for name, (run, oracle) in ops.items():
        got = run()
        nnz = check_entries(name, got, *oracle(), np.float32)
        again = run()
        if not _bits_equal(again.data, got.data):
            raise AssertionError(f"{name}: a second call gave other bits")
        rows[name] = {"ms": device_ms(run), "nnz": nnz}
        del got, again
    got = t * w
    if got.data.device.type != "cuda" or not torch.equal(got.coords, t.coords):
        raise AssertionError("t * w: not on the card or not on t's coordinates")
    np.testing.assert_allclose(got.data.cpu().numpy().astype(np.float64), vals * wn[coords[1]], rtol=ELEM_RTOL, err_msg="t * w")
    rows["t * w"] = {"ms": device_ms(lambda: t * w), "nnz": got.nnz}
    return rows


def phase_elemwise_dense_by_nature(dev):
    """``var(axis=0)`` and ``std()`` of a 4,096^2 matrix at density 1e-3:
    the keepdims mean broadcasts over every reduced position, so the union
    of ``x - mean`` is dense (16.8M entries), as in sparse_tpu."""
    import sparse_tpu_torch as st

    n, density = DENSE_NATURE
    rng = np.random.default_rng(13)
    lin = np.unique(rng.integers(0, n * n, size=round(n * n * density)))
    vals = rng.random(lin.size, dtype=np.float32)
    x = st.COO(np.stack([lin // n, lin % n]), vals, shape=(n, n), device=dev)
    dense = np.zeros((n, n))
    dense[lin // n, lin % n] = vals
    rows = {}
    got = x.var(axis=0)
    check_sparse_1d("var(axis=0)", got, dense.var(axis=0), np.float32)
    if not _bits_equal(x.var(axis=0).data, got.data):
        raise AssertionError("var(axis=0): a second call gave other bits")
    rows["var(axis=0)"] = {"ms": device_ms(lambda: x.var(axis=0)), "nnz": got.nnz, "union": n * n}
    got = x.std()
    np.testing.assert_allclose(float(got.fill_value), dense.std(), rtol=ELEM_RTOL, err_msg="std()")
    if not _bits_equal(x.std().fill_value, got.fill_value):
        raise AssertionError("std(): a second call gave other bits")
    rows["std()"] = {"ms": device_ms(lambda: x.std()), "nnz": x.nnz}
    return rows

# ---------------------------------------------------------------------------
# indexing and slicing of COO and GCXS, DOK, npz I/O, creation and the rest
# of the namespace (no kernel of their own: torch ops on the array's device;
# the picked rows' products run on K2 and K1)
# ---------------------------------------------------------------------------

IX_PICKS = 4096  # a GNN-style minibatch: rows (and columns) drawn unsorted, repeats allowed
IX_SEED = 18
# bench_regression.py:350-356: a 10,000^2 draw at density 1e-3 (random_state=9),
# its slice and 500 row picks (drawn here from their own seed)
IX_REG_SHAPE, IX_REG_DENSITY, IX_REG_STATE, IX_REG_PICKS = (10_000, 10_000), 1e-3, 9, 500
IX_DOK_EDITS = 1000
IX_REPS = 5
IX_SAVE_DIR = "build/indexing_path"  # npz round trips, inside the checkout, removed after


def reads_back(fn):
    """The synchronizing CUDA calls that one call of ``fn`` makes (torch's
    sync debug mode): its reads back to the host, and its copies from
    pageable host memory (a NumPy index's copy to the card)."""
    import warnings

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(str(w.message).startswith("called a synchronizing CUDA operation") for w in caught)


def eager_ms(fn, reps=IX_REPS):
    """Median host ms of one eager call of ``fn``, synchronised after it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_entries(x):
    """A 2-D port array's entries on the host: int64 rows and columns, data."""
    coo = x.tocoo()
    c = coo.coords.cpu().numpy().astype(np.int64)
    return c[0], c[1], coo.data.cpu().numpy()


def check_exact(name, got, rows, cols, vals, shape):
    """A 2-D port result on the card holding exactly the oracle's entries:
    canonical coordinates, the data's dtype and bits."""
    if got.data.device.type != "cuda" or tuple(got.shape) != tuple(shape):
        raise AssertionError(f"{name}: {got} (want shape {tuple(shape)} on the card)")
    order = np.lexsort((cols, rows))
    r, c, v = host_entries(got)
    if not (np.array_equal(r, rows[order]) and np.array_equal(c, cols[order])):
        raise AssertionError(f"{name}: {r.size} coordinates, the oracle {rows.size}, or they differ")
    if v.dtype != vals.dtype or v.tobytes() != vals[order].tobytes():
        raise AssertionError(f"{name}: the values differ from the oracle's")
    return int(r.size)


def check_scipy(name, got, want):
    """A 2-D port result equal to a scipy matrix's entries exactly."""
    w = want.tocoo()
    return check_exact(name, got, w.row.astype(np.int64), w.col.astype(np.int64), w.data, w.shape)


def _same_arrays(name, got, want):
    """Two port arrays of one format with the same shape, fill value and
    buffers, bit for bit (the npz round trip; a CSR loads as a GCXS)."""
    import sparse_tpu_torch as st

    names = ("coords", "data") if isinstance(want, st.COO) else ("data", "indices", "indptr")
    same_format = isinstance(got, st.COO) == isinstance(want, st.COO)
    if not same_format or got.shape != want.shape or np.asarray(got.fill_value).tobytes() != np.asarray(want.fill_value).tobytes():
        raise AssertionError(f"{name}: {got} against {want}")
    if not isinstance(want, st.COO) and got.compressed_axes != want.compressed_axes:
        raise AssertionError(f"{name}: compressed_axes {got.compressed_axes}")
    for n in names:
        g, w = getattr(got, n), getattr(want, n)
        if g.dtype != w.dtype or g.device != w.device or not torch.equal(g, w):
            raise AssertionError(f"{name}: {n} differs")


def argmax_rows_oracle(rows, cols, vals, n_rows, n_cols):
    """``argmax(axis=1)`` of a zero-fill matrix from its entries (rows
    sorted), on the host: the first column of each row's maximum, the fill
    value at the row's first unoccupied column where it ties or wins."""
    out = np.zeros(n_rows, dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, np.diff(rows) != 0])
    counts = np.diff(np.r_[starts, rows.size])
    m = np.maximum.reduceat(vals, starts)
    fa = np.minimum.reduceat(np.where(vals == np.repeat(m, counts), cols, n_cols), starts)
    ranks = np.arange(rows.size) - np.repeat(starts, counts)
    gap = np.minimum(np.minimum.reduceat(np.where(cols != ranks, ranks, n_cols), starts), counts)
    has_gap = counts < n_cols
    res = np.where(has_gap & (m < 0), gap, fa)
    res = np.where(has_gap & (m == 0), np.minimum(gap, fa), res)
    out[rows[starts]] = res
    return out


def phase_indexing_path(dev, a, card):
    """Indexing, DOK, npz I/O, creation and the rest of the namespace on the
    card through the public entry points, each checked exactly against an
    oracle built on the host from the stored entries (scipy, NumPy): a
    GNN-style minibatch of 4,096 rows picked from the bench matrix as a COO
    (the leading fast path) and a CSR (``indptr`` spliced), then ``@ B`` and
    ``@ x`` on K2 and K1 (counters advance) against a float64 oracle; the
    general path (4,096 column picks, a 2-D slice, reversed and stepped
    slices, two scalars); bench_regression.py's three indexing cases at its
    shape; sort, argmax, unique_counts, nonzero, triu, roll and ``eye @ B``
    at the bench shape; the npz round trip of the COO and the CSR; a DOK of
    the regression matrix through 1,000 edits against scipy's ``dok_array``.
    Each operation's eager ms (median of 5), device ms (CUDA events) and
    synchronizing calls; the card's busy share during ``a[picks]``; the
    library yardsticks, timed only."""
    import shutil
    from pathlib import Path

    import scipy.sparse

    import sparse_tpu_torch as st
    from chip_elemwise_profile import profile
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    t_phase = time.perf_counter()
    # a view of the matrix with no memo of results, so that each timed call
    # computes (the main path's array memoizes its layouts and its results)
    a = a.copy(deep=False)
    rng = np.random.default_rng(IX_SEED)
    rows, cols, vals = host_entries(a)
    A = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(M, K))
    csr = a.asformat("csr")
    picks_np = rng.integers(0, M, IX_PICKS)
    cols_np = rng.integers(0, K, IX_PICKS)
    picks = torch.as_tensor(picks_np, device=dev)
    cpicks = torch.as_tensor(cols_np, device=dev)
    b = torch.as_tensor(rng.random((K, N), dtype=np.float32), device=dev)
    x = torch.as_tensor(rng.random(K, dtype=np.float32), device=dev)
    torch.cuda.synchronize()
    ops = {}

    def timed(name, fn, nnz):
        ops[name] = {"eager_ms": eager_ms(fn), "device_ms": device_ms(fn), "reads_back": reads_back(fn), "nnz": nnz}

    # the minibatch: rows picked on the COO's leading fast path and the CSR's
    # spliced indptr, then the products on K2 and K1
    reset_launch_counts()
    sub = a[picks]
    sub_csr = csr[picks]
    out_b = sub @ b
    out_x = sub @ x
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name in ("row_ell_spmm", "row_ell_spmv"):
        if launches[name] == 0:
            raise AssertionError(f"a[picks] @ B / @ x never launched {name}: {launches}")
    want_sub = A[picks_np]
    n_sub = check_scipy("a[picks]", sub, want_sub)
    check_scipy("csr[picks]", sub_csr, want_sub)
    if type(sub_csr) is not st.GCXS or sub_csr.compressed_axes != (0,):
        raise AssertionError(f"csr[picks]: {sub_csr}")
    ref = want_sub.astype(np.float64)
    np.testing.assert_allclose(out_b.cpu().numpy(), ref @ b.cpu().numpy().astype(np.float64), **ORACLE_TOL)
    np.testing.assert_allclose(out_x.cpu().numpy(), ref @ x.cpu().numpy().astype(np.float64), **ORACLE_TOL)
    del out_b, out_x, ref, want_sub
    timed("a[picks]", lambda: a[picks], n_sub)
    timed("csr[picks]", lambda: csr[picks], n_sub)
    timed("a[picks] @ B", lambda: sub @ b, n_sub)
    timed("a[picks] @ x", lambda: sub @ x, n_sub)
    wall_ms, busy_ms, top = profile(lambda: a[picks])
    busy = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms, "top5_kernels_ms_count": top}
    del sub, sub_csr

    # the general path, against scipy
    general = [
        ("a[:, cols]", lambda: a[:, cpicks], A[:, cols_np]),
        ("a[8192:40960, 1000:60000]", lambda: a[8192:40960, 1000:60000], A[8192:40960, 1000:60000]),
        ("a[::-1, ::2]", lambda: a[::-1, ::2], A[::-1, ::2]),
    ]
    for name, fn, want in general:
        timed(name, fn, check_scipy(name, fn(), want))
    i, j = int(rows[len(rows) // 2]), int(cols[len(rows) // 2])
    row_cols = set(cols[rows == 0].tolist())
    j_fill = next(c for c in range(K) if c not in row_cols)
    for name, pos, want in (("a[i, j] stored", (i, j), A[i, j]), ("a[i, j] fill", (0, j_fill), A[0, j_fill])):
        got = a[pos]
        if not (isinstance(got, torch.Tensor) and got.shape == () and got.device.type == "cuda"):
            raise AssertionError(f"{name}: {got!r}")
        if got.cpu().numpy().tobytes() != np.float32(want).tobytes():
            raise AssertionError(f"{name}: {got.item()} against scipy's {want}")
        timed(name, lambda pos=pos: a[pos], 1)

    # bench_regression.py's three cases at its shape
    ix = st.random(IX_REG_SHAPE, density=IX_REG_DENSITY, random_state=IX_REG_STATE, device=dev)
    r2, c2, v2 = host_entries(ix)
    IX = scipy.sparse.csr_matrix((v2, (r2, c2)), shape=IX_REG_SHAPE)
    reg_picks = np.random.default_rng(IX_REG_STATE).integers(0, IX_REG_SHAPE[0], IX_REG_PICKS)
    gxi = ix.asformat("gcxs")
    for name, fn, want in (
        ("regression ix[2000:8000, 1000:9000]", lambda: ix[2000:8000, 1000:9000], IX[2000:8000, 1000:9000]),
        ("regression ix[picks]", lambda: ix[reg_picks], IX[reg_picks]),
        ("regression gcxs[picks]", lambda: gxi[reg_picks], IX[reg_picks]),
    ):
        timed(name, fn, check_scipy(name, fn(), want))

    # the rest of the namespace at the bench shape
    order = np.lexsort((vals, rows))
    s_rows, s_vals = rows[order], vals[order]
    starts = np.flatnonzero(np.r_[True, np.diff(s_rows) != 0])
    counts = np.diff(np.r_[starts, s_rows.size])
    ranks = np.arange(s_rows.size) - np.repeat(starts, counts)
    above = ~(s_vals < 0)  # the fill value 0 sorts before every stored value >= 0
    s_cols = ranks + np.where(above, K - np.repeat(counts, counts), 0)
    timed("sort(a, axis=1)", lambda: st.sort(a, axis=1), check_exact("sort(a, axis=1)", st.sort(a, axis=1), s_rows, s_cols, s_vals, (M, K)))
    del order, s_rows, s_vals, s_cols, ranks
    got = st.argmax(a, axis=1)
    if not np.array_equal(got.todense().cpu().numpy(), argmax_rows_oracle(rows, cols, vals, M, K)):
        raise AssertionError("argmax(a, axis=1) differs from the oracle")
    timed("argmax(a, axis=1)", lambda: st.argmax(a, axis=1), got.nnz)
    uv, uc = np.unique(vals, return_counts=True)
    u_order = np.argsort(np.r_[np.float32(0), uv], kind="stable")
    want_v, want_c = np.r_[np.float32(0), uv][u_order], np.r_[M * K - a.nnz, uc][u_order]
    got_v, got_c = st.unique_counts(a)
    if got_v.cpu().numpy().tobytes() != want_v.astype(np.float32).tobytes() or not np.array_equal(got_c.cpu().numpy(), want_c):
        raise AssertionError("unique_counts(a) differs from np.unique's")
    timed("unique_counts(a)", lambda: st.unique_counts(a), int(got_v.numel()))
    got_nz = st.nonzero(a)
    keep = vals != 0
    if not (np.array_equal(got_nz[0].cpu().numpy(), rows[keep]) and np.array_equal(got_nz[1].cpu().numpy(), cols[keep])):
        raise AssertionError("nonzero(a) differs from the stored non-zero entries")
    timed("nonzero(a)", lambda: st.nonzero(a), int(keep.sum()))
    up = cols >= rows
    timed("triu(a)", lambda: st.triu(a), check_exact("triu(a)", st.triu(a), rows[up], cols[up], vals[up], (M, K)))
    timed("roll(a, 17, axis=1)", lambda: st.roll(a, 17, axis=1), check_exact("roll(a, 17, axis=1)", st.roll(a, 17, axis=1), rows, (cols + 17) % K, vals, (M, K)))
    del got, got_v, got_c, got_nz, keep, up
    eye = st.eye(M, dtype=np.float32, device=dev)
    reset_launch_counts()
    prod = eye @ b
    torch.cuda.synchronize()
    if LAUNCHES["row_ell_spmm"] == 0 or not torch.equal(prod, b):
        raise AssertionError(f"eye(65536) @ B: {dict(LAUNCHES)}, equal to B: {torch.equal(prod, b)}")
    timed("eye(65536)", lambda: st.eye(M, dtype=np.float32, device=dev), M)
    timed("eye(65536) @ B", lambda: eye @ b, M)
    del eye, prod

    # the npz round trip of the COO and the CSR, bit for bit
    save_dir = Path(IX_SAVE_DIR)
    save_dir.mkdir(parents=True, exist_ok=True)
    try:
        for name, arr in (("coo", a), ("csr", csr)):
            path = save_dir / f"{name}.npz"
            t0 = time.perf_counter()
            st.save_npz(path, arr)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = st.load_npz(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            _same_arrays(f"npz {name}", back, arr)
            ops[f"npz {name}"] = {"save_s": save_s, "load_s": load_s, "file_bytes": path.stat().st_size, "nnz": arr.nnz}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    # a DOK of the regression matrix through 1,000 edits, against scipy's dok_array
    edits = np.random.default_rng(IX_SEED + 1).integers(0, IX_REG_SHAPE[0], (IX_DOK_EDITS, 2))
    new_vals = np.random.default_rng(IX_SEED + 2).random(IX_DOK_EDITS)
    new_vals[::10] = 0.0  # a zero deletes the entry in both
    t0 = time.perf_counter()
    d = ix.asformat("dok")
    dok_build_s = time.perf_counter() - t0
    D = IX.todok()
    t0 = time.perf_counter()
    for (p, q), v in zip(edits.tolist(), new_vals.tolist()):
        d[p, q] = v
    dok_edit_s = time.perf_counter() - t0
    for (p, q), v in zip(edits.tolist(), new_vals.tolist()):
        D[p, q] = v
    t0 = time.perf_counter()
    dc = d.to_coo()
    torch.cuda.synchronize()
    dok_to_coo_s = time.perf_counter() - t0
    n_dok = check_scipy("DOK edits .to_coo()", dc, D.tocoo())
    ops["dok"] = {"build_s": dok_build_s, "edits_s": dok_edit_s, "edit_us": dok_edit_s / IX_DOK_EDITS * 1e6, "to_coo_s": dok_to_coo_s, "nnz": n_dok}

    # the library yardsticks, timed only
    tsp = torch.sparse_coo_tensor(a.coords.long(), a.data, (M, K)).coalesce()
    library = {
        "index_select(0, picks)": device_ms(lambda: tsp.index_select(0, picks)),
        "index_select(1, cols)": device_ms(lambda: tsp.index_select(1, cpicks)),
        "torch.sort(a.data)": device_ms(lambda: torch.sort(a.data)),
    }
    del tsp
    return {
        "indexing_path": "ok",
        "picks": IX_PICKS,
        "launches_on_picked_rows": launches,
        "ops": ops,
        "a[picks]_profile": busy,
        "library_ms": library,
        "regression_shape": list(IX_REG_SHAPE),
        "regression_nnz": ix.nnz,
        "seconds": time.perf_counter() - t_phase,
        "card": card,
    }


# Sparse attention and graph convolution (the attention_path line), float32,
# heads a loop, at the full width of public models:
# - Longformer-base (allenai/longformer-base-4096: hidden 768, 12 heads of 64,
#   attention_window 512, so 256 each side), L = 4,096: the window with one
#   global token (the COO route: K4, the segment softmax, K5), the window alone
#   (the row-ELL route: K6), longformer_attention and banded_attention;
# - BigBird (google/bigbird-roberta-base: block_size 64, num_random_blocks 3,
#   one window block each side, two global blocks), L = 4,096;
# - one long head at the reference docstring's scale, L = 65,536, W = 256
#   (33.6M slots): banded_attention against K6's row-ELL route;
# - one head of a scattered pattern, 129 distinct random columns a row: K6's
#   unions past the route rule (at 513 a row, a 4,096-key table holds every
#   union within it), its row kernel;
# - K6's route sweep: the window's e_cols with a fraction of each row's slots
#   replaced by random columns, from none to all, both routes timed;
# - GCN propagation at OGB ogbn-arxiv's sizes (169,343 nodes, 1,166,243
#   edges, 128 features; hidden 256), a graph drawn from a seed.
AT_L, AT_HEADS, AT_D, AT_WINDOW, AT_BLOCK = 4096, 12, 64, 256, 128
BB_BLOCK, BB_WINDOW, BB_RANDOM, BB_GLOBAL = 64, 1, 3, 2
AT_LONG_L = 65_536
GCN_NODES, GCN_EDGES, GCN_IN, GCN_HIDDEN = 169_343, 1_166_243, 128, 256
# each output against a float64 oracle within AT_ORACLE_TOL · max|v|: float32
# scores of 64 products of unit normals scaled by 1/8 round at about 1e-6 of
# their size, the weights inherit that, and an output row sums up to 4,096 of
# them in float32; 1e-4 leaves room for the sums' order
AT_ORACLE_TOL = 1e-4
# K6 against its plain version on the same inputs (sums in another order), · max|v|
AT_PLAIN_TOL = 2e-6
AT_PLAIN_TOL_F64 = 1e-12  # the same in float64 (the row kernel)
# the gradients against the plain versions', max|got - want| / max|want|
AT_GRAD_TOL = 1e-5
AT_GRAD_TOL_F64 = 1e-12  # the same in float64 (K6's backward kernel and K5 against the plain backward)
# the long head's gradients on the row-ELL route against the COO route's, of max|grad|:
# float32 sums of 513 slots in two other orders
AT_LONG_GRAD_TOL = 1e-4
# graph_conv against scipy's float64 product, max|got - want| / max|want|: x @ w
# sums 128 float32 products, K5 a row's ~15 weighted rows
GCN_TOL = 1e-5
AT_REPS = 5
# K6's route sweep: windows (513 and 129 slots a row), fractions of their slots made random
AT_SWEEP_WINDOWS = (256, 64)
AT_SCATTER_CAP = 129
AT_SWEEP = (0.0, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0)


def at_device_ms(fn, reps=AT_REPS):
    """Median device ms of one call of ``fn`` with the host ahead of the card:
    a spin of twice the host's enqueue time before each call, CUDA events
    around the call alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int(max(2 * host_s, 1e-3) * 2e9))  # cycles at about 2 GHz
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def peak_bytes(fn):
    """Bytes one call of ``fn`` allocates beyond what was live before it, its output included."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def masked_oracle(q, k, v, allowed, scale):
    """Dense masked softmax attention in float64 on the card."""
    s = (q.double() @ k.double().T) * scale
    s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))) * allowed
    denom = e.sum(dim=-1, keepdim=True)
    return (e / torch.where(denom == 0, torch.ones_like(denom), denom)) @ v.double()


def band_oracle(q, k, v, window, scale, chunk=1024):
    """:func:`masked_oracle` of a sliding window, a chunk of query rows at a time over its key stripe."""
    L = q.shape[0]
    out = torch.empty((L, v.shape[1]), dtype=torch.float64, device=q.device)
    for r0 in range(0, L, chunk):
        r1, c0 = min(r0 + chunk, L), max(r0 - window, 0)
        c1 = min(r1 + window, L)
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(c0, c1, device=q.device)[None, :]
        out[r0:r1] = masked_oracle(q[r0:r1], k[c0:c1], v[c0:c1], (qpos - kpos).abs() <= window, scale)
    return out


def dense_allowed(rows, cols, length, dev):
    allowed = torch.zeros((length, length), dtype=torch.bool, device=dev)
    allowed[torch.as_tensor(rows, device=dev).long(), torch.as_tensor(cols, device=dev).long()] = True
    return allowed


def check_attention(name, got, want, v):
    """``max|got - want| <= AT_ORACLE_TOL · max|v|``; that ratio."""
    vmax = float(v.abs().max())
    err = float((got.double() - want).abs().max())
    if not err <= AT_ORACLE_TOL * vmax:
        raise AssertionError(f"{name}: {err} from the float64 oracle, beyond {AT_ORACLE_TOL} · max|v| = {AT_ORACLE_TOL * vmax}")
    return err / vmax


def by_heads(fn, q, k, v):
    """``fn`` on each head of ``(H, L, d)`` tensors, stacked: heads are a loop."""
    return torch.stack([fn(q[h], k[h], v[h]) for h in range(q.shape[0])])


def phase_attention_path(dev, card):
    """Sparse attention and GCN propagation through ``sparse_tpu_torch.nn``,
    counted route by route (counts set to 0 just before each, read just
    after): K4 and K5 on the COO route, K6 on the row-ELL route, none on the
    dense block forms, K5 in ``graph_conv``. Each output against a float64
    oracle on the card (scipy for ``graph_conv``), K6 against its plain
    version and twice bit for bit, the gradients of ``(w · attention).sum()``
    in q, k and v on both routes against the plain versions' (the COO route's
    twice bit for bit), ``graph_conv``'s gradient twice bit for bit. Then
    device ms a head and a 12-head layer, peak memory, and
    ``scaled_dot_product_attention`` with the pattern's dense mask beside
    them (timed only). Returns the phase's line and K6's ``kernels`` line."""
    import scipy.sparse as sp

    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts
    from sparse_tpu_torch.kernels import attention as katt
    from sparse_tpu_torch.kernels import dot as kdot

    t_phase = time.perf_counter()
    H, L, D, W = AT_HEADS, AT_L, AT_D, AT_WINDOW
    scale = 1.0 / np.sqrt(D)
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn((H, L, D), generator=gen, device=dev) for _ in range(3))
    rows_g, cols_g = tnn.local_attention_pattern(L, W, 1)
    rows_w, cols_w = tnn.local_attention_pattern(L, W)
    bb_ids, bb_valid = tnn.bigbird_block_pattern(
        L, block=BB_BLOCK, n_window=BB_WINDOW, n_random=BB_RANDOM, n_global=BB_GLOBAL, seed=0
    )
    # held on the card, as a caller running many steps holds them (a NumPy list is copied every call)
    bb_ids_t, bb_valid_t = torch.as_tensor(bb_ids, device=dev), torch.as_tensor(bb_valid, device=dev)
    ql, kl, vl = (torch.randn((AT_LONG_L, D), generator=gen, device=dev) for _ in range(3))
    t0 = time.perf_counter()
    rows_l, cols_l = tnn.local_attention_pattern(AT_LONG_L, W)
    long_pattern_s = time.perf_counter() - t0
    # the scattered head: AT_SCATTER_CAP distinct random columns a row (seed 20)
    cap_w = 2 * W + 1
    rng_s = np.random.default_rng(20)
    cols_s = np.argsort(rng_s.random((L, L)), axis=1)[:, :AT_SCATTER_CAP].astype(np.int32)
    cols_s.sort(axis=1)
    rows_s = np.repeat(np.arange(L, dtype=np.int32), AT_SCATTER_CAP)
    cols_s = cols_s.reshape(-1)
    # the graph: edges drawn from a seed, made symmetric with self-loops, D^-1/2 (A + I) D^-1/2
    rng = np.random.default_rng(19)
    n = GCN_NODES
    e = rng.integers(0, n, size=(2, GCN_EDGES))
    lin = np.unique(np.concatenate([e[0] * n + e[1], e[1] * n + e[0], np.arange(n, dtype=np.int64) * (n + 1)]))
    g_rows, g_cols = lin // n, lin % n
    deg = np.bincount(g_rows, minlength=n).astype(np.float64)
    g_vals = 1.0 / np.sqrt(deg[g_rows] * deg[g_cols])
    gr = torch.as_tensor(g_rows.astype(np.int32), device=dev)
    gc = torch.as_tensor(g_cols.astype(np.int32), device=dev)
    gv = torch.as_tensor(g_vals, dtype=torch.float32, device=dev)
    x = torch.randn((n, GCN_IN), generator=gen, device=dev)
    w = torch.randn((GCN_IN, GCN_HIDDEN), generator=gen, device=dev) / np.sqrt(GCN_IN)
    torch.cuda.synchronize()

    coo_head = lambda a, b, c: tnn.sparse_attention(a, b, c, rows_g, cols_g)  # noqa: E731
    ell_head = lambda a, b, c: tnn.sparse_attention(a, b, c, rows_w, cols_w)  # noqa: E731
    heads = {
        "coo_route": coo_head,
        "ell_route": ell_head,
        "longformer": lambda a, b, c: tnn.longformer_attention(a, b, c, window=W, n_global=1, block=AT_BLOCK),
        "banded": lambda a, b, c: tnn.banded_attention(a, b, c, window=W, block=AT_BLOCK),
        "banded_causal": lambda a, b, c: tnn.banded_attention(a, b, c, window=W, block=AT_BLOCK, causal=True),
        "bigbird": lambda a, b, c: tnn.block_sparse_attention(a, b, c, bb_ids_t, bb_valid_t, block=BB_BLOCK),
    }
    singles = {
        "long_ell": lambda: tnn.sparse_attention(ql, kl, vl, rows_l, cols_l),
        "long_banded": lambda: tnn.banded_attention(ql, kl, vl, window=W, block=AT_BLOCK),
        "scattered": lambda: tnn.sparse_attention(q[0], k[0], v[0], rows_s, cols_s),
        "graph_conv": lambda: tnn.graph_conv(gr, gc, gv, x, w, n_nodes=n),
    }
    launches, outs, first_s, first_peak, blocks_taken = {}, {}, {}, {}, {}
    for name, fn in [*((nm, lambda f=f: by_heads(f, q, k, v)) for nm, f in heads.items()), *singles.items()]:
        reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        first_s[name] = time.perf_counter() - t0
        first_peak[name] = torch.cuda.max_memory_allocated() - base  # the layouts' builds included
        launches[name] = {kn: c for kn, c in LAUNCHES.items() if c}
        # K6's blocks by route: [tile, row by the rule or an index, row by a non-finite value]
        blocks_taken[name] = _cuda.attention_route_blocks(dev).tolist()
    k6_kernels = {"ell_attention", "ell_attention_tiles"}  # the tile route, then the row kernel on what it left
    # the COO route's kept pattern: K5's union route, the gather route on the
    # blocks its layout flags; graph_conv's table (173 MB) past L2: the sliced route
    expect = {
        "coo_route": {"sddmm", "sampled_row_sum", "sampled_row_sum_union"},
        "ell_route": k6_kernels,
        "long_ell": k6_kernels,
        "scattered": k6_kernels,
        "graph_conv": {"sampled_row_sum_sliced"},
    }
    for name, got in launches.items():
        if set(got) != expect.get(name, set()):
            raise AssertionError(f"attention path, {name}: launched {got}, expected {sorted(expect.get(name, set()))}")
    if (
        launches["ell_route"]["ell_attention"] != H
        or launches["ell_route"]["ell_attention_tiles"] != H
        or launches["coo_route"]["sddmm"] != H
        or launches["coo_route"]["sampled_row_sum_union"] != H
        or launches["graph_conv"]["sampled_row_sum_sliced"] != 1
    ):
        raise AssertionError(f"attention path: a launch a head expected, got {launches}")
    n_blk, n_blk_long = -(-L // _cuda.ATTENTION_BLOCK_ROWS), -(-AT_LONG_L // _cuda.ATTENTION_BLOCK_ROWS)
    want_blocks = {"ell_route": [H * n_blk, 0, 0], "long_ell": [n_blk_long, 0, 0], "scattered": [0, n_blk, 0]}
    for name, want in want_blocks.items():
        if blocks_taken[name] != want:
            raise AssertionError(f"attention path, {name}: K6's blocks by route {blocks_taken[name]}, expected {want}")

    # each output against the float64 oracle
    allowed_g = dense_allowed(rows_g, cols_g, L, dev)
    allowed_w = dense_allowed(rows_w, cols_w, L, dev)
    pos = torch.arange(L, device=dev)
    blocks = torch.zeros((L // BB_BLOCK, L // BB_BLOCK), dtype=torch.bool, device=dev)
    ids_t = bb_ids_t.long()
    blocks[torch.arange(blocks.shape[0], device=dev)[:, None].expand_as(ids_t)[bb_valid_t], ids_t[bb_valid_t]] = True
    allowed = {
        "coo_route": allowed_g,
        "ell_route": allowed_w,
        "longformer": allowed_g,
        "banded": allowed_w,
        "banded_causal": allowed_w & (pos[None, :] <= pos[:, None]),
        "bigbird": blocks.repeat_interleave(BB_BLOCK, 0).repeat_interleave(BB_BLOCK, 1),
    }
    worst = {name: 0.0 for name in allowed}
    for h in range(H):
        want_g = masked_oracle(q[h], k[h], v[h], allowed_g, scale)
        want_w = masked_oracle(q[h], k[h], v[h], allowed_w, scale)
        for name, mask in allowed.items():
            want = want_g if mask is allowed_g else want_w if mask is allowed_w else masked_oracle(q[h], k[h], v[h], mask, scale)
            worst[name] = max(worst[name], check_attention(f"{name}, head {h}", outs[name][h], want, v[h]))
    worst["scattered"] = check_attention(
        "scattered head", outs["scattered"], masked_oracle(q[0], k[0], v[0], dense_allowed(rows_s, cols_s, L, dev), scale), v[0]
    )
    want_long = band_oracle(ql, kl, vl, W, scale)
    worst["long_ell"] = check_attention("long head, row-ELL route", outs["long_ell"], want_long, vl)
    worst["long_banded"] = check_attention("long head, banded_attention", outs["long_banded"], want_long, vl)
    del want_long
    agree = {
        "longformer_vs_coo_route": float((outs["longformer"] - outs["coo_route"]).abs().max()),
        "banded_vs_ell_route": float((outs["banded"] - outs["ell_route"]).abs().max()),
        "long_banded_vs_ell": float((outs["long_banded"] - outs["long_ell"]).abs().max()),
    }
    # graph_conv against scipy's float64 product
    a_host = sp.csr_matrix((g_vals, (g_rows, g_cols)), shape=(n, n))
    want_gcn = a_host @ (x.double().cpu().numpy() @ w.double().cpu().numpy())
    gcn_err = float(np.abs(outs["graph_conv"].double().cpu().numpy() - want_gcn).max() / np.abs(want_gcn).max())
    if not gcn_err <= GCN_TOL:
        raise AssertionError(f"graph_conv: {gcn_err} from scipy's float64 product, beyond {GCN_TOL}")
    del a_host, want_gcn

    # K6's two routes against the plain version, each twice bit for bit; the tile route's bits the entry point's
    e_np, valid_np = tnn.build_attention_ell(rows_w, cols_w, L)
    e_cols, valid = torch.as_tensor(e_np, device=dev), torch.as_tensor(valid_np, device=dev)
    out_k, out_t = torch.empty((L, D), device=dev), torch.empty((L, D), device=dev)
    launch = lambda: _cuda.ell_attention(q[0], k[0], v[0], e_cols, valid, scale, out_k)  # noqa: E731
    config = _cuda.attention_tile_config(L, D, D, torch.float32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = katt.build_attention_blocks(e_cols, valid, L, _cuda.ATTENTION_BLOCK_ROWS)
    torch.cuda.synchronize()
    layout_first_s = time.perf_counter() - t0
    by_block = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=dev)
    tiles = lambda: _cuda.ell_attention_tiles(q[0], k[0], v[0], blocks, scale, out_t, by_block, config)  # noqa: E731

    def tile_route():  # the entry point's two launches: the tiles, the row kernel on the blocks they left
        tiles()
        return _cuda.ell_attention(q[0], k[0], v[0], e_cols, valid, scale, out_t, block_route=by_block, block_rows=blocks.block)

    plain = katt.ell_attention_plain(q[0], k[0], v[0], e_cols, valid, scale)
    vmax0 = float(v[0].abs().max())
    k6_err = {}
    for route_name, fn in (("row", launch), ("tiles", tile_route)):
        got = fn().clone()
        k6_err[route_name] = float((got - plain).abs().max())
        if not k6_err[route_name] <= AT_PLAIN_TOL * vmax0:
            raise AssertionError(f"K6's {route_name} route against ell_attention_plain: {k6_err[route_name]} beyond {AT_PLAIN_TOL} · max|v|")
        if not torch.equal(got, fn()):
            raise AssertionError(f"K6's {route_name} route: a second launch gave other bits")
    if not torch.equal(out_t, outs["ell_route"][0]):
        raise AssertionError("K6: the entry point gave other bits than its tile route")
    if by_block.tolist() != [0] * blocks.union.shape[0]:
        raise AssertionError("K6: a block of Longformer's window left the tile route")
    # float64 takes the row kernel (no tile route): its first measurement, against the plain version
    q64, k64, v64 = (t[0].double() for t in (q, k, v))
    out64 = torch.empty((L, D), dtype=torch.float64, device=dev)
    launch64 = lambda: _cuda.ell_attention(q64, k64, v64, e_cols, valid, scale, out64)  # noqa: E731
    k6_err["row_float64"] = float((launch64() - katt.ell_attention_plain(q64, k64, v64, e_cols, valid, scale)).abs().max())
    if not k6_err["row_float64"] <= AT_PLAIN_TOL_F64 * vmax0:
        raise AssertionError(f"K6's row kernel in float64 against ell_attention_plain: {k6_err['row_float64']}")
    if _cuda.attention_tile_config(L, D, D, torch.float64, dev) is not None:
        raise AssertionError("K6: float64 must take the row kernel")
    blocks_plain = katt.ell_attention_blocks_plain(q[0], k[0], v[0], blocks, scale)
    blocks_plain_err = float((blocks_plain - plain).abs().max())
    if not blocks_plain_err <= AT_PLAIN_TOL * vmax0:
        raise AssertionError(f"ell_attention_blocks_plain against ell_attention_plain: {blocks_plain_err}")
    del plain, blocks_plain

    # the route sweep: a window's slots made random, a fraction of each row's,
    # both routes, at Longformer's cap and a quarter of it
    sweep = []
    rng_w = np.random.default_rng(21)
    out_w = torch.empty((L, D), device=dev)
    for w_s in AT_SWEEP_WINDOWS:
        e_w, valid_w = (torch.as_tensor(a, device=dev) for a in tnn.build_attention_ell(*tnn.local_attention_pattern(L, w_s), L))
        for frac in AT_SWEEP:
            e_f = e_w.clone()
            swap = torch.as_tensor(rng_w.random(tuple(e_w.shape)) < frac, device=dev)
            e_f[swap] = torch.as_tensor(rng_w.integers(0, L, int(swap.sum())), dtype=e_f.dtype, device=dev)
            forced = katt.build_attention_blocks(e_f, valid_w, L, _cuda.ATTENTION_BLOCK_ROWS, ratio=1e9)
            ruled = katt.build_attention_blocks(e_f, valid_w, L, _cuda.ATTENTION_BLOCK_ROWS)
            route_f = torch.empty(forced.union.shape[0], dtype=torch.int32, device=dev)

            def forced_tiles(forced=forced, route_f=route_f, e_f=e_f, valid_w=valid_w):
                _cuda.ell_attention_tiles(q[0], k[0], v[0], forced, scale, out_w, route_f, config)
                return _cuda.ell_attention(q[0], k[0], v[0], e_f, valid_w, scale, out_w, block_route=route_f, block_rows=forced.block)

            err = float((forced_tiles() - katt.ell_attention_plain(q[0], k[0], v[0], e_f, valid_w, scale)).abs().max())
            if not err <= AT_PLAIN_TOL * vmax0:
                raise AssertionError(f"K6's tile route at cap {e_w.shape[1]}, {frac} random: {err} from the plain version")
            sweep.append(
                {
                    "cap": int(e_w.shape[1]),
                    "random_fraction": frac,
                    "mean_union_over_cap": float(forced.n_union.double().mean()) / e_w.shape[1],
                    "max_union_over_cap": float(forced.n_union.max()) / e_w.shape[1],
                    "tiles_ms": time_graph(forced_tiles),
                    "row_ms": time_graph(lambda e_f=e_f, valid_w=valid_w: _cuda.ell_attention(q[0], k[0], v[0], e_f, valid_w, scale, out_w)),
                    "blocks_the_rule_refuses": int(ruled.flag.sum()),
                    "max_abs_err_tiles": err,
                }
            )
    torch.cuda.synchronize()

    # the gradients of (wts · attention).sum() in q, k and v, head 0
    wts = torch.randn((L, D), generator=gen, device=dev)

    def grads(fn):
        ins = [t[0].clone().requires_grad_(True) for t in (q, k, v)]
        (wts * fn(*ins)).sum().backward()
        return [t.grad for t in ins]

    kept = tnn._coo_pattern(rows_g, cols_g, L, L, dev)

    def coo_plain(a, b, c):  # the COO route in torch ops: sddmm_plain, the softmax's runs, sampled_row_sum_plain
        ones = torch.ones(kept.rows.shape[0], device=dev)
        attn = tnn._softmax_runs(kdot.sddmm_plain(kept.rows, kept.cols, ones, a, b.T) * scale, kept.seg, L, None)
        return kdot.sampled_row_sum_plain(kept.rows, kept.cols, attn, c, L)

    grad_err = {}
    g1, g2 = grads(coo_head), grads(coo_head)
    if not all(torch.equal(x_, y_) for x_, y_ in zip(g1, g2)):
        raise AssertionError("COO route: a second backward gave other bits")
    gp = grads(coo_plain)
    grad_err["coo_route"] = {nm: normalised_err(x_, y_.double()) for nm, x_, y_ in zip("qkv", g1, gp)}
    del g2, gp
    ge = grads(ell_head)
    if not all(torch.equal(x_, y_) for x_, y_ in zip(ge, grads(ell_head))):
        raise AssertionError("row-ELL route: a second backward gave other bits")
    gp = grads(lambda a, b, c: katt.ell_attention_plain(a, b, c, e_cols, valid, scale))
    grad_err["ell_route"] = {nm: normalised_err(x_, y_.double()) for nm, x_, y_ in zip("qkv", ge, gp)}
    del ge, gp
    for route, errs in grad_err.items():
        if max(errs.values()) > AT_GRAD_TOL:
            raise AssertionError(f"{route} gradients against the plain version's: {errs}")

    # K6's backward at the window's width, head 0, g = wts: the kernel's dq,
    # ds and p against ell_attention_backward_rows_plain, the whole gradient
    # (the kernel, then K5 for dk and dv) against ell_attention_backward_plain,
    # float32 and float64, each twice bit for bit
    strips = tuple(e_cols.shape)
    kb_out = [torch.empty(s_, device=dev) for s_ in ((L, D), strips, strips)]

    def k6_backward(qq, kk, vv, gg, outs=None):
        outs = outs or [torch.empty(s_, dtype=qq.dtype, device=dev) for s_ in ((L, D), strips, strips)]
        return _cuda.ell_attention_backward(qq, kk, vv, gg, e_cols, valid, scale, *outs)

    kb_err, kb_grad_err = {}, {}
    for dt_name, dt_, tol in (("float32", torch.float32, AT_GRAD_TOL), ("float64", torch.float64, AT_GRAD_TOL_F64)):
        qq, kk, vv, gg = (t.to(dt_) for t in (q[0], k[0], v[0], wts))
        fwd = katt.ell_attention(qq, kk, vv, e_cols, valid, scale=scale)  # the forward's output, the backward's δ
        got = [t.clone() for t in k6_backward(qq, kk, vv, gg)]
        want = katt.ell_attention_backward_rows_plain(qq, kk, vv, e_cols, valid, scale, gg)
        kb_err[dt_name] = {nm: float((a_ - b_).abs().max()) for nm, a_, b_ in zip(("dq", "ds", "p"), got, want)}
        for nm, b_ in zip(("dq", "ds", "p"), want):
            if not kb_err[dt_name][nm] <= tol * float(b_.abs().max()):
                raise AssertionError(f"K6's backward kernel, {dt_name} {nm}: {kb_err[dt_name][nm]} beyond {tol} · max|{nm}|")
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, k6_backward(qq, kk, vv, gg))):
            raise AssertionError(f"K6's backward kernel, {dt_name}: a second launch gave other bits")
        del got, want
        full = katt._ell_attention_backward(qq, kk, vv, e_cols, valid, scale, gg, fwd)
        plain_full = katt.ell_attention_backward_plain(qq, kk, vv, e_cols, valid, scale, gg)
        kb_grad_err[dt_name] = {nm: normalised_err(a_, b_.double()) for nm, a_, b_ in zip(("dq", "dk", "dv"), full, plain_full)}
        if max(kb_grad_err[dt_name].values()) > tol:
            raise AssertionError(f"K6's backward and K5, {dt_name}, against ell_attention_backward_plain: {kb_grad_err[dt_name]}")
        if not all(torch.equal(a_, b_) for a_, b_ in zip(full, katt._ell_attention_backward(qq, kk, vv, e_cols, valid, scale, gg, fwd))):
            raise AssertionError(f"K6's backward and K5, {dt_name}: a second backward gave other bits")
        del full, plain_full, qq, kk, vv, gg, fwd
    torch.cuda.empty_cache()

    # K6's backward tile route at the window's width, head 0, float32, g =
    # wts, out the entry point's forward: its dq, ds and p (the tiles, then
    # the row kernel on the blocks they leave) against
    # ell_attention_backward_blocks_plain and ell_attention_backward_rows_plain,
    # twice bit for bit
    out0 = outs["ell_route"][0]
    bconfig = _cuda.attention_backward_tile_config(L, D, D, torch.float32, dev)
    bt_out = [torch.empty(s_, device=dev) for s_ in ((L, D), strips, strips)]
    bt_route = torch.empty(blocks.union.shape[0], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    border = katt.build_strip_order(blocks)  # the backward's alone: the forward's layout holds none
    torch.cuda.synchronize()
    strip_order_first_s = time.perf_counter() - t0
    bt_tiles = lambda: _cuda.ell_attention_backward_tiles(q[0], k[0], v[0], wts, out0, blocks, border, scale, *bt_out, bt_route, bconfig)  # noqa: E731

    def bt_pair():  # the entry point's two launches
        bt_tiles()
        return _cuda.ell_attention_backward(q[0], k[0], v[0], wts, e_cols, valid, scale, *bt_out, block_route=bt_route, block_rows=blocks.block)

    got = [t.clone() for t in bt_pair()]
    if bt_route.tolist() != [0] * blocks.union.shape[0]:
        raise AssertionError("K6's backward: a block of Longformer's window left the tile route")
    bt_err = {}
    for against, want in (
        ("blocks_plain", katt.ell_attention_backward_blocks_plain(q[0], k[0], v[0], wts, out0, blocks, scale)),
        ("rows_plain", katt.ell_attention_backward_rows_plain(q[0], k[0], v[0], e_cols, valid, scale, wts)),
    ):
        bt_err[against] = {nm: float((a_ - b_).abs().max()) / float(b_.abs().max()) for nm, a_, b_ in zip(("dq", "ds", "p"), got, want)}
        if against == "blocks_plain":
            bt_abs_err = max(float((a_ - b_).abs().max()) for a_, b_ in zip(got, want))
        if max(bt_err[against].values()) > AT_GRAD_TOL:
            raise AssertionError(f"K6's backward tile route against ell_attention_backward_{against}: {bt_err[against]}")
        del want
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, bt_pair())):
        raise AssertionError("K6's backward tile route: a second launch gave other bits")
    del got

    def layer_grads(f):  # a 12-head layer's forward and backward, heads a loop
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (wts * by_heads(f, *ins)).sum().backward()
        return [t.grad for t in ins]

    # the training path of the row-ELL route, counted: K6 forward, its backward and K5 a head, no plain version
    torch.cuda.synchronize()
    reset_launch_counts()
    layer_grads(ell_head)
    torch.cuda.synchronize()
    launches["ell_route_training"] = lt = {kn: c for kn, c in LAUNCHES.items() if c}
    bwd_blocks = {"ell_route_training": _cuda.attention_backward_route_blocks(dev).tolist()}
    k6_bwd_kernels = {"ell_attention_backward", "ell_attention_backward_tiles"}  # the tile route, then the row kernel on what it left
    if (
        lt.get("ell_attention") != H
        or lt.get("ell_attention_tiles") != H
        or lt.get("ell_attention_backward_tiles") != H
        or lt.get("ell_attention_backward") != H
        or lt.get("sampled_row_sum_union") != 2 * H
        or not set(lt) <= k6_kernels | k6_bwd_kernels | {"sampled_row_sum_union", "sampled_row_sum"}
        or bwd_blocks["ell_route_training"] != [H * n_blk, 0, 0]
    ):
        raise AssertionError(f"row-ELL route training: K6, its backward's two kernels and K5 twice a head expected, got {lt}, {bwd_blocks}")

    # the long head's forward and backward: the row-ELL route against the COO
    # route's gradients (copies of the pattern: the route memo keys on identity)
    wl = torch.randn((AT_LONG_L, D), generator=gen, device=dev)
    rows_lc, cols_lc = rows_l.copy(), cols_l.copy()

    def long_grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (ql, kl, vl)]
        (wl * fn(*ins)).sum().backward()
        return [t.grad for t in ins]

    ell_long = lambda a, b, c: tnn.sparse_attention(a, b, c, rows_l, cols_l)  # noqa: E731
    coo_long = lambda a, b, c: tnn.sparse_attention(a, b, c, rows_lc, cols_lc, max_ell_blowup=0)  # noqa: E731
    torch.cuda.synchronize()
    reset_launch_counts()
    gl = long_grads(ell_long)
    torch.cuda.synchronize()
    launches["long_ell_training"] = ll = {kn: c for kn, c in LAUNCHES.items() if c}
    bwd_blocks["long_ell_training"] = _cuda.attention_backward_route_blocks(dev).tolist()
    if (
        ll.get("ell_attention_backward") != 1
        or ll.get("ell_attention_backward_tiles") != 1
        or ll.get("sampled_row_sum_union", 0) + ll.get("sampled_row_sum", 0) < 2
        or bwd_blocks["long_ell_training"] != [n_blk_long, 0, 0]
    ):
        raise AssertionError(f"long head training: K6's backward's two kernels and K5 expected, got {ll}, {bwd_blocks}")
    gc_ = long_grads(coo_long)
    long_grad_err = {nm: float((a_ - b_).abs().max() / b_.abs().max()) for nm, a_, b_ in zip(("dq", "dk", "dv"), gl, gc_)}
    if max(long_grad_err.values()) > AT_LONG_GRAD_TOL:
        raise AssertionError(f"long head: the row-ELL route's gradients against the COO route's: {long_grad_err}")
    del gl, gc_
    # the long head's tile backward (the entry point's config, its two
    # launches) against ell_attention_backward_blocks_plain, which runs in
    # union chunks: the row decomposition would write 17.2 GB blocks
    e_l, valid_l = (torch.as_tensor(a, device=dev) for a in tnn.build_attention_ell(rows_l, cols_l, AT_LONG_L))
    blocks_l = katt.build_attention_blocks(e_l, valid_l, AT_LONG_L, _cuda.ATTENTION_BLOCK_ROWS)
    out_l = outs["long_ell"]
    bl_out = [torch.empty(s_, device=dev) for s_ in ((AT_LONG_L, D), tuple(e_l.shape), tuple(e_l.shape))]
    bl_route = torch.empty(blocks_l.union.shape[0], dtype=torch.int32, device=dev)
    bl_config = _cuda.attention_backward_tile_config(AT_LONG_L, D, D, torch.float32, dev)
    _cuda.ell_attention_backward_tiles(ql, kl, vl, wl, out_l, blocks_l, katt.build_strip_order(blocks_l), scale, *bl_out, bl_route, bl_config)
    _cuda.ell_attention_backward(ql, kl, vl, wl, e_l, valid_l, scale, *bl_out, block_route=bl_route, block_rows=blocks_l.block)
    want_l = katt.ell_attention_backward_blocks_plain(ql, kl, vl, wl, out_l, blocks_l, scale)
    long_tile_err = {nm: float((a_ - b_).abs().max()) / float(b_.abs().max()) for nm, a_, b_ in zip(("dq", "ds", "p"), bl_out, want_l)}
    if max(long_tile_err.values()) > AT_GRAD_TOL or bl_route.tolist() != [0] * blocks_l.union.shape[0]:
        raise AssertionError(f"long head: K6's backward tile route against ell_attention_backward_blocks_plain: {long_tile_err}")
    del want_l, bl_out, blocks_l, e_l, valid_l
    torch.cuda.empty_cache()
    gwts = torch.randn((n, GCN_HIDDEN), generator=gen, device=dev)

    def gcn_grads():
        ins = [t.clone().requires_grad_(True) for t in (gv, x, w)]
        return torch.autograd.grad((gwts * tnn.graph_conv(gr, gc, *ins, n_nodes=n)).sum(), ins)

    if not all(torch.equal(x_, y_) for x_, y_ in zip(gcn_grads(), gcn_grads())):
        raise AssertionError("graph_conv: a second backward gave other bits")
    torch.cuda.synchronize()

    def counted_backward(fn, ins, weight):  # the launches of one backward alone
        ins = [t.detach().clone().requires_grad_(True) for t in ins]
        loss = (weight * fn(*ins)).sum()
        torch.cuda.synchronize()
        reset_launch_counts()
        loss.backward()
        torch.cuda.synchronize()
        return {kn: c for kn, c in LAUNCHES.items() if c}

    # the COO route's d v, d q and d k on the union route (the gather route on
    # its flagged blocks); graph_conv's column sum on the sliced route
    launches_backward = {
        "coo_route": counted_backward(coo_head, [t[0] for t in (q, k, v)], wts),
        "graph_conv": counted_backward(
            lambda a_, b_, c_: tnn.graph_conv(gr, gc, a_, b_, c_, n_nodes=n), (gv, x, w), gwts
        ),
    }
    lb_coo, lb_gcn = launches_backward["coo_route"], launches_backward["graph_conv"]
    if lb_coo.get("sampled_row_sum_union", 0) < 1 or lb_coo.get("sampled_row_sum") != lb_coo["sampled_row_sum_union"]:
        raise AssertionError(f"COO route backward: K5's union route and its flagged gather expected, got {lb_coo}")
    if lb_gcn.get("sampled_row_sum_sliced", 0) < 1 or "sampled_row_sum" in lb_gcn or "sampled_row_sum_union" in lb_gcn:
        raise AssertionError(f"graph_conv backward: K5's sliced route alone expected, got {lb_gcn}")

    # K5's routes where these paths run it: graph_conv's table and its
    # backward's column sum (the sliced route), the COO route's attn @ v and
    # d k (the union route), each against the gather route bit for bit
    gpat = tnn._coo_pattern(gr, gc, n, n, dev).sddmm
    with torch.no_grad():
        xw = x @ w
        ones = torch.ones(kept.rows.shape[0], device=dev)
        attn0 = tnn._softmax_runs(kdot.sddmm_plain(kept.rows, kept.cols, ones, q[0], k[0].T) * scale, kept.seg, L, None)
        gs0 = attn0 * torch.randn(attn0.shape, generator=gen, device=dev)
    k5_lines, k5 = [], {}
    for of, pat, axis, w_e, table, n_launch in (
        ("graph_conv_forward", gpat, 0, gv, xw, launches["graph_conv"]["sampled_row_sum_sliced"]),
        ("graph_conv_backward_columns", gpat, 1, gv, gwts, lb_gcn["sampled_row_sum_sliced"]),
        ("attention_attn_v", kept.sddmm, 0, attn0, v[0], launches["coo_route"]["sampled_row_sum_union"]),
        ("attention_d_k", kept.sddmm, 1, gs0, q[0], lb_coo["sampled_row_sum_union"]),
    ):
        line, k5[of] = k5_route_line(of, pat, axis, w_e, table, n_launch, card)
        k5_lines.append(line)
    want_routes = {"graph_conv_forward": "sliced", "graph_conv_backward_columns": "sliced", "attention_attn_v": "union", "attention_d_k": "union"}
    if {of: d["k5_route"] for of, d in k5.items()} != want_routes:
        raise AssertionError(f"K5's routes: {[(of, d['k5_route']) for of, d in k5.items()]}, expected {want_routes}")
    # the union layout of the COO route's rows, built anew: its time and bytes
    ptr0, _, _, idx0 = kept.sddmm.plan(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay0 = kdot.row_sum_union_layout(
        ptr0, idx0, L, _cuda.ROW_SUM_UNION_BLOCK, _cuda.row_sum_union_capacity(4, L, idx0.numel()), _cuda.ROW_SUM_UNION_REUSE
    )
    torch.cuda.synchronize()
    k5["union_layout"] = {
        "first_build_s": time.perf_counter() - t0,
        "bytes": sum(t.numel() * t.element_size() for t in lay0[2:]),
        "block": lay0.block,
        "capacity": lay0.union.shape[1],
        "blocks_flagged": int(lay0.flag.sum()),
        "rule": {
            "l2_budget_bytes": _cuda.ROW_SUM_L2_BUDGET,
            "slice_cols": _cuda.ROW_SUM_SLICE_COLS,
            "union_block": _cuda.ROW_SUM_UNION_BLOCK,
            "union_reuse": _cuda.ROW_SUM_UNION_REUSE,
            "union_smem_bytes": _cuda.ROW_SUM_UNION_SMEM,
        },
    }
    del lay0, xw, attn0, gs0

    # times: a head, a 12-head layer, peak memory; the yardstick
    import torch.nn.functional as F

    times = {}
    for name, f in heads.items():
        times[name] = {
            "head_ms": at_device_ms(lambda f=f: f(q[0], k[0], v[0])),
            "layer_ms": at_device_ms(lambda f=f: by_heads(f, q, k, v)),
            "layer_ms_eager": time_eager(lambda f=f: by_heads(f, q, k, v), reps=3),
            "head_peak_bytes": peak_bytes(lambda f=f: f(q[0], k[0], v[0])),
            "first_layer_s": first_s[name],
        }
    for route, f in (("coo_route", coo_head), ("ell_route", ell_head)):
        times[route]["head_forward_backward_ms"] = at_device_ms(lambda f=f: grads(f))
        times[route]["layer_forward_backward_ms"] = at_device_ms(lambda f=f: layer_grads(f))
        times[route]["head_forward_backward_peak_bytes"] = peak_bytes(lambda f=f: grads(f))
    for name in ("long_ell", "long_banded", "scattered", "graph_conv"):
        times[name] = {
            "ms": at_device_ms(singles[name]),
            "peak_bytes": peak_bytes(singles[name]),
            "first_s": first_s[name],
            "first_peak_bytes": first_peak[name],
        }
    for name, f in (("long_ell", ell_long), ("long_coo", coo_long)):
        times.setdefault(name, {})["forward_backward_ms"] = at_device_ms(lambda f=f: long_grads(f))
        times[name]["forward_backward_peak_bytes"] = peak_bytes(lambda f=f: long_grads(f))
    times["graph_conv"]["forward_backward_ms"] = at_device_ms(gcn_grads)
    times["graph_conv"]["xw_ms"] = at_device_ms(lambda: x @ w)
    times["long_pattern_host_s"] = long_pattern_s
    sdpa = {}
    for name, mask in (("window", allowed_w), ("window_global", allowed_g)):
        one = lambda mask=mask: F.scaled_dot_product_attention(q[0][None, None], k[0][None, None], v[0][None, None], attn_mask=mask)  # noqa: E731
        layer = lambda mask=mask: F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask)  # noqa: E731
        ref = outs["ell_route"][0] if name == "window" else outs["coo_route"][0]

        def one_fb(mask=mask):
            ins = [t[0].clone().requires_grad_(True) for t in (q, k, v)]
            (wts * F.scaled_dot_product_attention(*(t[None, None] for t in ins), attn_mask=mask)[0, 0]).sum().backward()

        def layer_fb(mask=mask):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (wts * F.scaled_dot_product_attention(*(t[None] for t in ins), attn_mask=mask)[0]).sum().backward()

        ins_s = [t[0].clone().requires_grad_(True) for t in (q, k, v)]
        out_s = F.scaled_dot_product_attention(*(t[None, None] for t in ins_s), attn_mask=mask)[0, 0]
        sdpa[name] = {
            "head_ms": at_device_ms(one),
            "layer_ms": at_device_ms(layer),
            "head_max_abs_diff": float((one()[0, 0] - ref).abs().max()),
            "head_forward_backward_ms": at_device_ms(one_fb),
            "layer_forward_backward_ms": at_device_ms(layer_fb),
            "head_backward_ms": at_device_ms(lambda out_s=out_s, ins_s=ins_s: torch.autograd.grad(out_s, ins_s, wts, retain_graph=True)),
        }
        del out_s, ins_s

    # K6's lines: the Longformer window at L = 4,096, head 0. The function's
    # bound: q, out, the distinct k and v rows and the pattern read once from
    # HBM; its products (scores over the valid slots, the weighted sum over
    # every slot) at the lesser of the CUDA cores and 3xTF32 on the tensor cores
    slots = e_cols.numel()
    n_valid = int(valid.sum())
    touched = int(torch.unique(e_cols[valid]).numel())
    nbytes = (2 * L * D + touched * 2 * D) * 4 + slots * (4 + 1)
    flops = n_valid * 2 * D + slots * (2 * D + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(flops / F32_FLOPS_PER_S, 3 * flops / TF32_FLOPS_PER_S) * 1e3
    bound = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    gathered = (n_valid + slots) * D * 4
    union_rows = int(blocks.n_union.sum())
    ms_row, ms_tiles, ms_route = time_graph(launch), time_graph(tiles), time_graph(tile_route)
    # K6's backward kernel: q, g, the distinct k and v rows its slots name and
    # the pattern read once, dq and the two (L, cap) strips written once; its
    # products: the scores over the valid slots, dP and dq over every slot (2
    # d each), the softmax, δ and dS (6 a slot)
    touched_all = int(torch.unique(e_cols).numel())
    nbytes_b = (3 * L * D + touched_all * 2 * D) * 4 + slots * (4 + 1) + 2 * slots * 4
    flops_b = n_valid * 2 * D + slots * (4 * D + 6)
    tb_bytes = nbytes_b / HBM_BYTES_PER_S * 1e3
    tb_ops = min(flops_b / F32_FLOPS_PER_S, 3 * flops_b / TF32_FLOPS_PER_S) * 1e3
    bound_b = {"bound_ms": max(tb_bytes, tb_ops), "bound_by": "bytes" if tb_bytes >= tb_ops else "operations"}
    kb_launch = lambda: k6_backward(q[0], k[0], v[0], wts, kb_out)  # noqa: E731
    wts64 = wts.double()
    kb_out64 = [t.double() for t in kb_out]
    ms_backward = time_graph(kb_launch)
    slot_pattern = katt.attention_slot_pattern(e_cols, valid, L)
    qs0 = q[0] * scale
    ms_k5_dk = time_graph(lambda: kdot._row_sum_forward(slot_pattern, 1, kb_out[1].view(-1), qs0))
    ms_k5_dv = time_graph(lambda: kdot._row_sum_forward(slot_pattern, 1, kb_out[2].view(-1), wts))
    ms_backward_all = time_graph(lambda: katt._ell_attention_backward(q[0], k[0], v[0], e_cols, valid, scale, wts, out0))
    # the backward's tile route: the function's bound is the row kernel's with
    # out read too (its δ); the products its tiles do (S twice, dP, dQ over
    # each block's union, 3xTF32) beside it
    nbytes_bt = nbytes_b + L * D * 4
    tb_bytes_t = nbytes_bt / HBM_BYTES_PER_S * 1e3
    bound_bt = {"bound_ms": max(tb_bytes_t, tb_ops), "bound_by": "bytes" if tb_bytes_t >= tb_ops else "operations"}
    tile_flops = 3 * _cuda.ATTENTION_BLOCK_ROWS * union_rows * (6 * D + 2 * D)
    ms_bt, ms_bt_pair = time_graph(bt_tiles), time_graph(bt_pair)
    lines = [
        {
            "name": "ell_attention",
            "route": "cuda",
            "source": SOURCE["ell_attention"],
            "replaces": REPLACES["ell_attention"],
            "launches": launches["ell_route"]["ell_attention"],
            "max_abs_err": k6_err["row"],
            "ms": ms_row,
            "plain_ms": time_eager(lambda: katt.ell_attention_plain(q[0], k[0], v[0], e_cols, valid, scale), reps=3),
            **bound,
            "library_ms": sdpa["window"]["head_ms"],
        },
        {
            "name": "ell_attention_tiles",
            "route": "cuda",
            "source": SOURCE["ell_attention_tiles"],
            "replaces": REPLACES["ell_attention_tiles"],
            "launches": launches["ell_route"]["ell_attention_tiles"],
            "max_abs_err": k6_err["tiles"],
            "ms": ms_tiles,
            "plain_ms": time_eager(lambda: katt.ell_attention_blocks_plain(q[0], k[0], v[0], blocks, scale), reps=3),
            **bound,
            "library_ms": sdpa["window"]["head_ms"],
        },
        {
            "name": "ell_attention_backward",
            "route": "cuda",
            "source": SOURCE["ell_attention_backward"],
            "replaces": REPLACES["ell_attention_backward"],
            "launches": launches["ell_route_training"]["ell_attention_backward"],
            "max_abs_err": max(kb_err["float32"].values()),
            "ms": ms_backward,
            "plain_ms": time_eager(
                lambda: katt.ell_attention_backward_rows_plain(q[0], k[0], v[0], e_cols, valid, scale, wts), reps=3
            ),
            **bound_b,
            "library_ms": sdpa["window"]["head_backward_ms"],
        },
        {
            "name": "ell_attention_backward_tiles",
            "route": "cuda",
            "source": SOURCE["ell_attention_backward_tiles"],
            "replaces": REPLACES["ell_attention_backward_tiles"],
            "launches": launches["ell_route_training"]["ell_attention_backward_tiles"],
            "max_abs_err": bt_abs_err,
            "ms": ms_bt,
            "plain_ms": time_eager(
                lambda: katt.ell_attention_backward_blocks_plain(q[0], k[0], v[0], wts, out0, blocks, scale), reps=3
            ),
            **bound_bt,
            "library_ms": sdpa["window"]["head_backward_ms"],
        },
    ]
    k6 = {
        "shape": {"L": L, "cap": int(e_cols.shape[1]), "d": D, "dv": D, "slots": slots, "valid": n_valid},
        "tile_config": config,
        "launches": {"tiles": launches["ell_route"]["ell_attention_tiles"], "row": launches["ell_route"]["ell_attention"]},
        "blocks_by_route": {name: dict(zip(("tiles", "row_by_rule", "row_by_value"), blocks_taken[name])) for name in want_blocks},
        "mean_union_over_cap": union_rows / blocks.union.shape[0] / cap_w,
        "union_rows_bytes": union_rows * 2 * D * 4,
        "union_rule_ratio": katt.ATTENTION_UNION_RATIO,
        "tiles_ms": ms_tiles,
        "route_ms": ms_route,
        "row_kernel_ms": ms_row,
        "row_kernel_strip": "shared memory" if _cuda.ell_attention_in_smem(int(e_cols.shape[1]), 4) else "scratch",
        "row_kernel_ms_l2_flushed": time_cold(launch),
        "row_kernel_float64_ms": time_graph(launch64),
        "route_ms_l2_flushed": time_cold(tile_route),
        "layout_first_s": layout_first_s,
        "layout_bytes": sum(t.numel() * t.element_size() for t in (blocks.union, blocks.n_union, blocks.count, blocks.flag)),
        "blocks_plain_err": blocks_plain_err,
        "bound_bytes": nbytes,
        "bound_flops": flops,
        "bound_share_tiles": bound["bound_ms"] / ms_tiles,
        "gathered_bytes_row_kernel": gathered,
        "gathered_tb_per_s_row_kernel": gathered / (ms_row * 1e-3) / 1e12,
        "l2_floor_ms_row_kernel": gathered / L2_ROW_BYTES_PER_S * 1e3,
        "sweep": sweep,
        "library": "scaled_dot_product_attention, the pattern's dense boolean mask",
        "backward": {
            "tile_config": bconfig,
            "strip_order_first_s": strip_order_first_s,
            "strip_order_bytes": sum(t.numel() * t.element_size() for t in border),
            "kernel_ms": ms_bt,
            "kernel_ms_l2_flushed": time_cold(bt_tiles),
            "pair_ms": ms_bt_pair,
            "bound_bytes": nbytes_bt,
            "bound_share": bound_bt["bound_ms"] / ms_bt,
            "tile_flops": tile_flops,
            "tile_flops_ms_at_tf32_peak": tile_flops / TF32_FLOPS_PER_S * 1e3,
            "blocks_by_route": {nm: dict(zip(("tiles", "row_by_rule", "row_by_value"), c)) for nm, c in bwd_blocks.items()},
            "err_vs_plain_of_max": bt_err,
            "long_head_err_vs_blocks_plain_of_max": long_tile_err,
            "long_head_tile_config": bl_config,
            "row_kernel_ms": ms_backward,
            "row_kernel_float64_ms": time_graph(lambda: k6_backward(q64, k64, v64, wts64, kb_out64)),
            "k5_dk_ms": ms_k5_dk,
            "k5_dv_ms": ms_k5_dv,
            "kernel_and_k5_ms": ms_backward_all,
            "k5_route": _cuda.row_sum_route(L, D, 4, True, slots, L + 1),
            "row_kernel_bound_bytes": nbytes_b,
            "bound_flops": flops_b,
            "row_kernel_bound_share": bound_b["bound_ms"] / ms_backward,
            "row_kernel_gathered_bytes": 3 * slots * D * 4,
            "row_kernel_gathered_tb_per_s": 3 * slots * D * 4 / (ms_backward * 1e-3) / 1e12,
            "row_kernel_l2_floor_ms": 3 * slots * D * 4 / L2_ROW_BYTES_PER_S * 1e3,
            "row_kernel_ms_l2_flushed": time_cold(kb_launch),
            "max_abs_err_vs_rows_plain": kb_err,
            "gradient_err_vs_plain": kb_grad_err,
            "long_head_gradient_err_vs_coo_route": long_grad_err,
            "sdpa_head_backward_ms": sdpa["window"]["head_backward_ms"],
        },
        "card": card,
    }
    result = {
        "attention_path": "ok",
        "seconds": time.perf_counter() - t_phase,
        "shapes": {
            "heads": H,
            "L": L,
            "d": D,
            "window": W,
            "coo_route_nnz": int(rows_g.size),
            "ell_route_nnz": int(rows_w.size),
            "bigbird_blocks_a_row": int(bb_ids.shape[1]),
            "long_L": AT_LONG_L,
            "long_slots": int(rows_l.size),
            "scattered_nnz": int(rows_s.size),
            "graph": {"nodes": n, "edges_drawn": GCN_EDGES, "entries": int(lin.size), "features": GCN_IN, "hidden": GCN_HIDDEN},
        },
        "launches": launches,
        "worst_over_max_v": worst,
        "tolerance": {
            "oracle": AT_ORACLE_TOL,
            "k6_vs_plain": AT_PLAIN_TOL,
            "k6_vs_plain_float64": AT_PLAIN_TOL_F64,
            "gradients": AT_GRAD_TOL,
            "gradients_float64": AT_GRAD_TOL_F64,
            "long_head_gradients_vs_coo_route": AT_LONG_GRAD_TOL,
            "graph_conv": GCN_TOL,
        },
        "agreement_max_abs": agree,
        "graph_conv_err_vs_scipy": gcn_err,
        "k6_vs_plain_max_abs": k6_err,
        "gradient_err_vs_plain": grad_err,
        "bits_equal_twice": {
            "k6_row": True,
            "k6_tiles": True,
            "k6_backward": True,
            "ell_route_gradient": True,
            "coo_route_gradient": True,
            "graph_conv_gradient": True,
        },
        "times": times,
        "sdpa": sdpa,
        "k6": k6,
        "k5": k5,
        "launches_backward": launches_backward,
        "card": card,
    }
    return result, lines + k5_lines

# ---------------------------------------------------------------------------
# linalg: the Krylov solvers on the card, their matvecs on the DIA shifts or K1
# ---------------------------------------------------------------------------

# the 5-point Poisson matrix of examples/solvers_example.py:poisson_2d at side
# 1,024 (n = 1,048,576, 5,238,784 entries), float64, CG to tol 1e-8 on both routes
LA_SIDE, LA_TOL = 1024, 1e-8
LA_SMALL_SIDE = 256  # gmres(restart=40), tfqmr and spsolve on the example's perturbation
LA_UPPER = 0.3  # the example's nonsymmetric perturbation: +0.3 on the upper neighbours
LA_OTHER_TOL = 1e-10  # the example's tolerance for gmres and tfqmr
# eigsh(k=4) at the example's side 128 against the closed form. A Krylov budget
# of ncv = 128 per restart (the default, 40, doubles to at most 320 and
# converges nothing on this clustered spectrum, in both packages: PERF.md)
LA_EIG_SIDE, LA_EIG_K, LA_EIG_NCV, LA_EIG_RTOL = 128, 4, 128, 1e-8
# the true residual on the host in float64 against the solver's own:
# ||b - A x|| <= LA_SLACK * tol * ||b||
LA_SLACK = 2.0
LA_SPSOLVE_RTOL = 1e-10  # against scipy's spsolve of the same matrix, of the largest entry
LA_MATVEC_TOL = 1e-13  # K1 against its plain version, D1 against scipy: of max_r sum_j |a_rj x_j|
LA_SEED = 22
LA_REPS = 3  # each solve's wall ms is the median of this many
F64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
DIA_KEY = (64, 8.0)


def poisson_triplets(side, dev):
    """``(rows, cols, vals)`` of the 5-point Laplacian of a side × side grid
    (examples/solvers_example.py:poisson_2d), built on ``dev``, float64."""
    n = side * side
    idx = torch.arange(n, device=dev).reshape(side, side)
    rows, cols = [idx.reshape(-1)], [idx.reshape(-1)]
    vals = [torch.full((n,), 4.0, dtype=torch.float64, device=dev)]
    for di, dj in ((0, 1), (1, 0)):
        a = idx[: side - di, : side - dj].reshape(-1)
        b = idx[di:, dj:].reshape(-1)
        rows += [a, b]
        cols += [b, a]
        vals += [torch.full((a.numel(),), -1.0, dtype=torch.float64, device=dev)] * 2
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def la_operators(side, dev, upper=0.0):
    """The Poisson matrix (``upper`` added to its upper neighbours) as a COO
    on ``dev``, the same matrix under a seeded symmetric permutation
    (``P A Pᵀ``: entry ``(r, c)`` moves to ``(sigma[r], sigma[c])``), sigma,
    and the matrix and its permuted form as scipy CSR on the host."""
    import scipy.sparse as sps
    import sparse_tpu_torch as st

    r, c, v = poisson_triplets(side, dev)
    if upper:
        v = v + upper * (c > r)
    n = side * side
    sigma = torch.randperm(n, generator=torch.Generator().manual_seed(LA_SEED + side)).to(dev)
    a = st.COO(torch.stack([r, c]), v, shape=(n, n))
    ap = st.COO(torch.stack([sigma[r], sigma[c]]), v, shape=(n, n))
    rh, ch, vh, sh = (t.cpu().numpy() for t in (r, c, v, sigma))
    host = sps.csr_matrix((vh, (rh, ch)), shape=(n, n))
    host_p = sps.csr_matrix((vh, (sh[rh], sh[ch])), shape=(n, n))
    return a, ap, sigma, host, host_p


def la_rhs(n, dev, sigma, seed):
    """A seeded right-hand side and its permuted form (``bp[sigma] = b``)."""
    b = torch.randn(n, generator=torch.Generator().manual_seed(seed), dtype=torch.float64).to(dev)
    bp = torch.empty_like(b)
    bp[sigma] = b
    return b, bp


def la_check_residual(name, host, x, b, tol):
    """``||b - A x|| <= LA_SLACK * tol * ||b||`` on the host in float64; the
    relative residual."""
    bh = b.cpu().numpy()
    rel = float(np.linalg.norm(bh - host @ x.cpu().numpy()) / np.linalg.norm(bh))
    if not rel <= LA_SLACK * tol:
        raise AssertionError(f"{name}: relative residual {rel} > {LA_SLACK} * {tol}")
    return rel


def la_wall_ms(fn):
    """Median wall ms of ``LA_REPS`` calls of ``fn``, each ended by a synchronize."""
    times = []
    for _ in range(LA_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cg_iteration_device_ms(mv, b):
    """Device ms of one CG iteration on ``mv`` (the matvec and the vector
    updates of ``linalg.cg``, in place, without the stop test's read back),
    from a CUDA graph of back-to-back iterations: the floor a captured
    block of iterations would approach."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rz = torch.dot(r, r)

    def step():
        ap = mv(p)
        alpha = rz / torch.dot(p, ap)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        rz_new = torch.dot(r, r)
        p.mul_(rz_new / rz).add_(r)
        rz.copy_(rz_new)
        torch.linalg.vector_norm(r)

    return time_graph(step)


def phase_linalg_path(dev, card):
    """``sparse_tpu_torch.linalg`` on the card: CG at side 1,024 through the
    DIA route (D1 once a matvec) and, on the permuted matrix, through K1;
    D1 bit for bit against its plain version at that shape; gmres, tfqmr,
    eigsh and spsolve at sides 256/128 through the permuted form. Returns
    ``(line, [k1_kernel_line, d1_kernel_line])``."""
    import scipy.sparse.linalg as spla

    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts, row_ell
    from sparse_tpu_torch.kernels import dia as kdia
    from sparse_tpu_torch.kernels.row_ell import row_ell_cache_key

    t_phase = time.perf_counter()
    a, ap, sigma, host, _ = la_operators(LA_SIDE, dev)
    n, nnz = a.shape[0], a.nnz
    b, bp = la_rhs(n, dev, sigma, LA_SEED)

    def cg(op, rhs):
        return linalg.cg(op, rhs, tol=LA_TOL, return_iters=True)

    # the DIA route: the banded matrix, its matvecs counted at the module function and on D1's counter
    dia_calls = []
    real_dia = kdia.dia_spmv
    kdia.dia_spmv = lambda *args: dia_calls.append(1) or real_dia(*args)
    reset_launch_counts()
    try:
        x, info, it = cg(a, b)
        torch.cuda.synchronize()
    finally:
        kdia.dia_spmv = real_dia
    launches_dia = dict(LAUNCHES)
    dia = a.peek_layout("dia", DIA_KEY)
    if dia is None or dia.offsets != (-LA_SIDE, -1, 0, 1, LA_SIDE):
        raise AssertionError(f"linalg_path: the banded matrix built no 5-offset DIA layout ({dia and dia.offsets})")
    if launches_dia["dia_spmv"] != it + 1 or sum(launches_dia.values()) != it + 1 or a.peek_layout("row_ell", row_ell_cache_key()) is not None:
        raise AssertionError(f"linalg_path: the DIA route launched {launches_dia} for {it} iterations, or built a row-ELL layout")
    if info != 0 or len(dia_calls) != it + 1:
        raise AssertionError(f"linalg_path: DIA cg info {info}, {len(dia_calls)} matvecs for {it} iterations")

    # the K1 route: the permuted matrix has far more than 64 diagonals
    reset_launch_counts()
    xp, infop, itp = cg(ap, bp)
    torch.cuda.synchronize()
    launches_k1 = dict(LAUNCHES)
    if ap.to_dia() is not None or ap.peek_layout("row_ell", row_ell_cache_key()) is None:
        raise AssertionError("linalg_path: the permuted matrix did not take the row-ELL route")
    if infop != 0 or launches_k1["row_ell_spmv"] != itp + 1 or sum(launches_k1.values()) != itp + 1:
        raise AssertionError(f"linalg_path: K1 cg info {infop}, launches {launches_k1} for {itp} iterations")

    res_dia = la_check_residual("cg DIA", host, x, b, LA_TOL)
    x_back = xp[sigma]  # P x, read back to A's numbering
    res_k1 = la_check_residual("cg K1", host, x_back, b, LA_TOL)
    # both residuals within LA_SLACK * tol * ||b||: each solution within
    # that over lambda_min of the exact one, so within twice that of the other
    lam_min = 8 * np.sin(np.pi / (2 * (LA_SIDE + 1))) ** 2
    bnorm = float(torch.linalg.vector_norm(b))
    diff = float(torch.linalg.vector_norm(x_back - x))
    diff_bound = 2 * LA_SLACK * LA_TOL * bnorm / lam_min
    if not diff <= diff_bound:
        raise AssertionError(f"linalg_path: ||P x_permuted - x|| = {diff} > {diff_bound}")

    routes = {}
    for route, op, rhs, iters in (("dia", a, b, it), ("k1", ap, bp, itp)):
        wall = la_wall_ms(lambda op=op, rhs=rhs: cg(op, rhs))
        routes[route] = {
            "iterations": iters,
            "wall_ms": wall,
            "ms_per_iteration": wall / iters,
            "reads_back_per_solve": reads_back(lambda op=op, rhs=rhs: cg(op, rhs)),
            "device_ms_per_iteration_graph": cg_iteration_device_ms(linalg._as_matvec(op), rhs),
        }
    routes["dia"]["relative_residual"], routes["k1"]["relative_residual"] = res_dia, res_k1

    # the matvec alone, at the Poisson shape
    xv = torch.randn(n, generator=torch.Generator().manual_seed(LA_SEED + 1), dtype=torch.float64).to(dev)
    rell = ap.to_row_ell()
    out = torch.empty(n, dtype=torch.float64, device=dev)
    # the matvecs' errors against the scale of their terms, max_r sum_j |a_rj x_j|
    # (the permuted matrix's rows are the same rows): five float64 terms in another order
    term_scale = float((abs(host) @ np.abs(xv.cpu().numpy())).max())
    k1_kernel = row_ell.row_ell_spmv(rell, xv)
    k1_err = float((k1_kernel - row_ell._spmv_plain(rell, xv)).abs().max())
    if not k1_err <= LA_MATVEC_TOL * term_scale:
        raise AssertionError(f"linalg_path: K1 against its plain version, max abs err {k1_err}")
    k1_ms = time_graph(lambda: _cuda.spmv(rell, xv, None, out))
    k1_eager_ms = time_eager(lambda: row_ell.row_ell_spmv(rell, xv))
    k1_plain_ms = time_eager(lambda: row_ell._spmv_plain(rell, xv), reps=5)
    csr_p = torch.sparse_coo_tensor(ap.coords.long(), ap.data, (n, n)).coalesce().to_sparse_csr()
    csr = torch.sparse_coo_tensor(a.coords.long(), a.data, (n, n)).coalesce().to_sparse_csr()
    k1_lib_ms = time_eager(lambda: torch.mv(csr_p, xv))
    d1_out = kdia.dia_spmv(dia.offsets, dia.bands, xv)
    d1_plain = kdia._shifted_sum_plain(dia.offsets, dia.bands, xv)
    if not torch.equal(d1_out.view(torch.int64), d1_plain.view(torch.int64)):
        raise AssertionError("linalg_path: D1 differs from its plain version (the torch ops)")
    d1_err = float((d1_out - d1_plain).abs().max())
    d1_host_err = float(np.abs(d1_out.cpu().numpy() - host @ xv.cpu().numpy()).max())
    if not d1_host_err <= LA_MATVEC_TOL * term_scale:
        raise AssertionError(f"linalg_path: dia_spmv against the host product, max abs err {d1_host_err}")
    d1_ms = time_graph(lambda: _cuda.dia_shifted_sum(dia.offsets, dia.bands, xv, out))
    d1_eager_ms = time_eager(lambda: kdia.dia_spmv(dia.offsets, dia.bands, xv))
    d1_plain_ms = time_eager(lambda: kdia._shifted_sum_plain(dia.offsets, dia.bands, xv))
    d1_plain_graph_ms = time_graph(lambda: kdia._shifted_sum_plain(dia.offsets, dia.bands, xv))
    d1_lib_ms = time_eager(lambda: torch.mv(csr, xv))
    # bytes the function must move: each input read once, the output written once
    k1_bytes = nnz * (4 + 8) + 8 * n + 8 * n  # int32 column and float64 value an entry, x, y
    d1_bytes = len(dia.offsets) * n * 8 + 8 * n + 8 * n  # the bands, x, y
    flops = 2 * nnz

    def bound(nbytes):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    k1_bound, k1_by = bound(k1_bytes)
    d1_bound, d1_by = bound(d1_bytes)
    k1_line = {
        "name": "row_ell_spmv (linalg_path: cg, Poisson 1,024², float64)",
        "route": "cuda",
        "source": SOURCE["row_ell_spmv"],
        "replaces": REPLACES["row_ell_spmv"],
        "launches": launches_k1["row_ell_spmv"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": k1_lib_ms,
    }
    d1_line = {
        "name": "D1 dia_spmv (linalg_path: cg, Poisson 1,024², float64)",
        "route": "cuda",
        "source": SOURCE["dia_spmv"],
        "replaces": REPLACES["dia_spmv"],
        "launches": launches_dia["dia_spmv"],
        "max_abs_err": d1_err,  # against the plain version: the same bits
        "ms": d1_ms,  # the kernel from a CUDA graph
        "plain_ms": d1_plain_ms,  # the torch ops (11 launches), eager
        "bound_ms": d1_bound,
        "bound_by": d1_by,
        "library_ms": d1_lib_ms,
        "plain_graph_ms": d1_plain_graph_ms,
        "max_abs_err_vs_scipy": d1_host_err,
    }
    for line, nbytes, eager in ((k1_line, k1_bytes, k1_eager_ms), (d1_line, d1_bytes, d1_eager_ms)):
        log(json.dumps({**line, "eager_ms": eager, "bound_bytes": nbytes, "bound_share": line["bound_ms"] / line["ms"], "card": card}))

    # the other solvers, each once through the permuted form (K1)
    a2, ap2, sigma2, host2, host2_p = la_operators(LA_SMALL_SIDE, dev, upper=LA_UPPER)
    b2, bp2 = la_rhs(a2.shape[0], dev, sigma2, LA_SEED + 2)
    others = {}
    for name, fn in (
        ("gmres", lambda: linalg.gmres(ap2, bp2, tol=LA_OTHER_TOL, restart=40)),
        ("tfqmr", lambda: linalg.tfqmr(ap2, bp2, tol=LA_OTHER_TOL)),
    ):
        reset_launch_counts()
        xo, info_o = fn()
        torch.cuda.synchronize()
        matvecs = LAUNCHES["row_ell_spmv"]
        if info_o != 0 or matvecs == 0 or sum(LAUNCHES.values()) != matvecs:
            raise AssertionError(f"linalg_path: {name} info {info_o}, launches {dict(LAUNCHES)}")
        rel = la_check_residual(name, host2, xo[sigma2], b2, LA_OTHER_TOL)
        wall = la_wall_ms(fn)
        others[name] = {"matvecs": matvecs, "wall_ms": wall, "ms_per_matvec": wall / matvecs, "reads_back_per_solve": reads_back(fn), "relative_residual": rel}

    _, ap3, _, _, _ = la_operators(LA_EIG_SIDE, dev)

    def eig():
        return linalg.eigsh(ap3, k=LA_EIG_K, ncv=LA_EIG_NCV)

    reset_launch_counts()
    w, V = eig()
    torch.cuda.synchronize()
    eig_matvecs = LAUNCHES["row_ell_spmv"]
    i = np.arange(1, LA_EIG_SIDE + 1)
    lam1 = 4 * np.sin(np.pi * i / (2 * (LA_EIG_SIDE + 1))) ** 2
    want_w = np.sort((lam1[:, None] + lam1[None, :]).ravel())[-LA_EIG_K:]
    if eig_matvecs == 0 or not np.allclose(w.cpu().numpy(), want_w, rtol=LA_EIG_RTOL, atol=0):
        raise AssertionError(f"linalg_path: eigsh {w.cpu().numpy()} against the closed form {want_w}, {eig_matvecs} K1 launches")
    wall = la_wall_ms(eig)
    others["eigsh"] = {"matvecs": eig_matvecs, "wall_ms": wall, "ms_per_matvec": wall / eig_matvecs, "reads_back_per_solve": reads_back(eig), "eigenvalues": w.cpu().numpy().tolist()}

    xs = linalg.spsolve(ap2, bp2)
    want_s = spla.spsolve(host2_p.tocsc(), bp2.cpu().numpy())
    s_err = float(np.abs(xs.cpu().numpy() - want_s).max())
    if xs.device.type != "cuda" or not s_err <= LA_SPSOLVE_RTOL * np.abs(want_s).max():
        raise AssertionError(f"linalg_path: spsolve against scipy's, max abs err {s_err}")
    others["spsolve"] = {"wall_ms": la_wall_ms(lambda: linalg.spsolve(ap2, bp2)), "max_abs_err_vs_scipy": s_err}

    line = {
        "linalg_path": "ok",
        "seconds": time.perf_counter() - t_phase,
        "poisson": {"side": LA_SIDE, "n": n, "nnz": nnz, "tol": LA_TOL, "dia_offsets": list(dia.offsets)},
        "cg": routes,
        "iterations": {"dia": it, "k1": itp},
        "launches": {"dia_route": launches_dia, "k1_route": launches_k1, "dia_spmv_calls": len(dia_calls)},
        "permuted_vs_natural": {"abs_diff": diff, "bound": diff_bound, "relative": diff / float(torch.linalg.vector_norm(x))},
        "matvec_ms": {
            "k1_graph": k1_ms,
            "k1_eager": k1_eager_ms,
            "dia_eager": d1_eager_ms,
            "dia_graph": d1_ms,
            "dia_plain_eager": d1_plain_ms,
            "dia_plain_graph": d1_plain_graph_ms,
            "torch_mv_csr_permuted": k1_lib_ms,
            "torch_mv_csr": d1_lib_ms,
            "k1_bound": k1_bound,
            "dia_bound": d1_bound,
        },
        "others": others,
        "kernel_lines": [k1_line, d1_line],
        "card": card,
    }
    return line, [k1_line, d1_line]


# csgraph on the card (the csgraph_path line), float64: the bench graph of
# bench_suite.py:386-389 (n = 131,072 nodes, 1,048,576 uniform random edges,
# weights U[0.05, 1.05), 8 sources), drawn from CG_SEED; the COO sums the
# draws' parallel edges, and scipy sees the COO's canonical entries
CG_NODES, CG_EDGES, CG_SOURCES = 1 << 17, 1 << 20, 8
CG_WIDE_SOURCES = 128  # K7's sliced route through dijkstra against the plain version: its block is 2.1 GB a round
# all sources, where the plain version runs a column slice at a time (its
# whole block would be 34 GB a round): 16,384 nodes, 131,072 edges of the
# same kind, 64 seeded rows against scipy
CG_ALL_NODES, CG_ALL_EDGES, CG_ALL_SAMPLE = 1 << 14, 1 << 17, 64
CG_ALL_PLAIN_COLS = 1024  # the plain round at all sources, a column slice at a time (2.1 GB blocks)
CG_FW_NODES = 1024  # floyd_warshall on a graph of the same kind, mean degree 8
CG_SEED = 23
CG_RTOL = 1e-12  # distances, the tree's weight and Floyd-Warshall against scipy
CG_PR_RTOL = 1e-12  # PageRank's scores against the host power iteration: max |Δ| over max |p|
CG_PR_TOL = 1e-10  # pagerank's default stop tolerance
CG_PATH_SOURCES = 3  # sources whose predecessor trees are checked with reconstruct_path


def cg_graph(n, m, seed, dev):
    """A uniform random graph as a port COO on ``dev`` and scipy CSR of its
    canonical entries (the draws' parallel edges summed), and the host
    entries ``(rows, cols, w)``."""
    import scipy.sparse as sps
    import sparse_tpu_torch as st

    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m) + 0.05
    a = st.COO(torch.from_numpy(np.stack([rows, cols])).to(dev), torch.from_numpy(w).to(dev), shape=(n, n))
    c = a.coords.cpu().numpy().astype(np.int64)
    d = a.data.cpu().numpy()
    return a, sps.csr_matrix((d, (c[0], c[1])), shape=(n, n)), (c[0], c[1], d)


def cg_check_dist(name, got, want):
    """``got`` (a tensor) against scipy's distances: the same ``inf``
    pattern, finite entries within CG_RTOL; the largest relative error."""
    got = got.cpu().numpy()
    fin = np.isfinite(want)
    if got.shape != want.shape or not np.array_equal(np.isfinite(got), fin):
        raise AssertionError(f"csgraph_path: {name}: shape {got.shape} or inf pattern differs from scipy's")
    rel = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), np.finfo(np.float64).tiny)
    err = float(rel.max()) if rel.size else 0.0
    if not err <= CG_RTOL:
        raise AssertionError(f"csgraph_path: {name}: relative error {err} > {CG_RTOL}")
    return err


def cg_max_abs_diff(x, y):
    """``max |x - y|`` of two tables, 0 where they hold the same value
    (``inf`` included), ``inf`` where their ``inf`` patterns differ."""
    return float(torch.where(x == y, torch.zeros_like(x), (x - y).abs()).max())


def cg_pagerank_host(host, alpha=0.85, tol=CG_PR_TOL, maxiter=200):
    """PageRank by the reference's formula on the host in float64 (scipy CSR
    of the out-normalized Wᵀ): ``(scores, iterations)``."""
    import scipy.sparse as sps

    n = host.shape[0]
    c = host.tocoo()
    out_deg = np.zeros(n)
    np.add.at(out_deg, c.row, c.data)
    dangling = out_deg == 0
    wn = np.where(out_deg[c.row] > 0, c.data / np.where(out_deg[c.row] > 0, out_deg[c.row], 1.0), 0.0)
    wt = sps.csr_matrix((wn, (c.col, c.row)), shape=(n, n))
    tele = np.full(n, 1.0 / n)
    p = np.full(n, 1.0 / n)
    delta, it = np.inf, 0
    while delta > tol and it < maxiter:
        new = alpha * (wt @ p + p[dangling].sum() * tele) + (1.0 - alpha) * tele
        delta = np.abs(new - p).sum()
        p, it = new, it + 1
    return p, it


def phase_csgraph_path(dev, card):
    """``sparse_tpu_torch.csgraph`` on the card: the shortest paths on K7 at
    the bench graph's size against scipy, K7 against its plain version bit
    for bit, all sources on a 16,384-node graph, PageRank on K1, the
    components, the spanning tree and Floyd-Warshall. Returns ``(line,
    [k7_kernel_line, k1_kernel_line])``."""
    import scipy.sparse.csgraph as sp_csgraph
    import sparse_tpu_torch as st
    from sparse_tpu_torch import csgraph
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, minplus, reset_launch_counts, row_ell

    t_phase = time.perf_counter()
    a, host, (h_rows, h_cols, h_w) = cg_graph(CG_NODES, CG_EDGES, CG_SEED, dev)
    n, nnz = CG_NODES, a.nnz
    sources = np.arange(CG_SOURCES)

    # the main path: dijkstra from 8 sources, the layout built on the first call
    builds = []
    real_build = minplus.build_dest_ell
    minplus.build_dest_ell = lambda *args, **kw: builds.append(1) or real_build(*args, **kw)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        dist = csgraph.dijkstra(a, indices=sources)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches_dij = dict(LAUNCHES)
        ell = a.peek_layout("dest_ell", True)
        reset_launch_counts()
        dist_bf = csgraph.bellman_ford(a, indices=sources)
        torch.cuda.synchronize()
        launches_bf = dict(LAUNCHES)
        if len(builds) != 1 or a.peek_layout("dest_ell", True) is not ell:
            raise AssertionError(f"csgraph_path: the layout was built {len(builds)} times for two calls on one COO")
    finally:
        minplus.build_dest_ell = real_build
    if ell is None:
        raise AssertionError("csgraph_path: the bench graph built no dest-ELL layout")
    L0 = ell.e_src.shape[1]
    tail_shape = None if ell.tail is None else list(ell.tail[0].shape)

    # the rounds, from the plain version's fixed point on the same start table
    src = torch.from_numpy(sources).to(dev)
    start = src if ell.inv is None else ell.inv[src]
    distT0 = csgraph._start_table(CG_SOURCES, n, start, dev)

    def plain(d, s, e, t, out=None):
        return minplus.minplus_relax_plain(d, s, e, t)

    fix_p, neg_p, rounds = minplus.minplus_fixpoint(distT0, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, relax=plain)
    dist_p = fix_p.T.contiguous() if ell.inv is None else torch.index_select(fix_p.T, 1, ell.inv)
    k7_err = cg_max_abs_diff(dist, dist_p)
    if neg_p or not torch.equal(dist, dist_p) or not torch.equal(dist_bf, dist):
        raise AssertionError("csgraph_path: dijkstra/bellman_ford on K7 differ from the plain fixed point")
    for name, got in (("dijkstra", launches_dij), ("bellman_ford", launches_bf)):
        if got["minplus_relax"] != rounds + 1 or got["row_ell_spmv"] != 0 or sum(got.values()) != rounds + 1:
            raise AssertionError(f"csgraph_path: {name} launched {got} for {rounds} rounds (+1 for has_neg)")
    want = sp_csgraph.dijkstra(host, indices=sources)
    err_dij = cg_check_dist("dijkstra, 8 sources", dist, want)
    err_bf = cg_check_dist("bellman_ford, 8 sources", dist_bf, want)

    # predecessors: each tree's edges against scipy's distances
    d_pred, pred = csgraph.dijkstra(a, indices=sources, return_predecessors=True)
    if not torch.equal(d_pred, dist):
        raise AssertionError("csgraph_path: dijkstra with predecessors moved the distances")
    path_err = 0.0
    for s in range(CG_PATH_SOURCES):
        tree = csgraph.reconstruct_path(a, pred[s])
        p, j = (t.cpu().numpy() for t in tree.coords)
        tw = tree.data.cpu().numpy()
        reach = np.isfinite(want[s])
        if not (np.array_equal(np.sort(j), np.flatnonzero(reach & (np.arange(n) != s))) and reach[p].all()):
            raise AssertionError(f"csgraph_path: the predecessor tree of source {s} does not span its reachable nodes")
        rel = np.abs(want[s, p] + tw - want[s, j]) / want[s, j]
        path_err = max(path_err, float(rel.max()))
    if not path_err <= CG_RTOL:
        raise AssertionError(f"csgraph_path: predecessor edges off scipy's distances by {path_err}")

    # K7 against its plain version: one round on the rule's route, over the
    # filled slots (the port's path) and over every slot
    route8, cols8 = _cuda.minplus_route(n, CG_SOURCES, 8)
    deg = {"deg": ell.deg, "t_deg": ell.t_deg}
    out = torch.empty_like(distT0)
    one_p, changed_p = minplus.minplus_relax_plain(distT0, ell.e_src, ell.e_w, ell.tail)
    for counts in (deg, {}):
        one_k, changed_k = minplus.minplus_relax(distT0, ell.e_src, ell.e_w, ell.tail, out=out, **counts)
        k7_err = max(k7_err, cg_max_abs_diff(one_k, one_p))
        if not (torch.equal(one_k, one_p) and bool(changed_k) == bool(changed_p)):
            raise AssertionError(f"csgraph_path: one K7 round ({route8}, counts {bool(counts)}) differs from the plain round")

    # 128 sources through dijkstra: the sliced route, its fixed point bit for bit against the plain one
    wide = np.arange(CG_WIDE_SOURCES)
    route_w, cols_w = _cuda.minplus_route(n, CG_WIDE_SOURCES, 8)
    if route_w != "sliced":
        raise AssertionError(f"csgraph_path: the route rule sends 128 sources to {route_w}, not the sliced route")
    reset_launch_counts()
    dist_w = csgraph.dijkstra(a, indices=wide)
    torch.cuda.synchronize()
    launches_w = dict(LAUNCHES)
    wide_t = torch.from_numpy(wide).to(dev)
    wide0 = csgraph._start_table(CG_WIDE_SOURCES, n, wide_t if ell.inv is None else ell.inv[wide_t], dev)
    fix_w, neg_w, rounds_w = minplus.minplus_fixpoint(wide0, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, relax=plain)
    dist_wp = fix_w.T.contiguous() if ell.inv is None else torch.index_select(fix_w.T, 1, ell.inv)
    k7_err_w = cg_max_abs_diff(dist_w, dist_wp)
    if neg_w or not torch.equal(dist_w, dist_wp):
        raise AssertionError("csgraph_path: dijkstra from 128 sources on K7's sliced route differs from the plain fixed point")
    if launches_w["minplus_relax"] != rounds_w + 1 or sum(launches_w.values()) != rounds_w + 1:
        raise AssertionError(f"csgraph_path: dijkstra from 128 sources launched {launches_w} for {rounds_w} rounds (+1)")
    del fix_w, dist_wp, dist_w
    out_w = torch.empty_like(wide0)
    one_w, changed_w = minplus.minplus_relax(wide0, ell.e_src, ell.e_w, ell.tail, out=out_w, **deg)
    one_wp, changed_wp = minplus.minplus_relax_plain(wide0, ell.e_src, ell.e_w, ell.tail)
    k7_err_w = max(k7_err_w, cg_max_abs_diff(one_w, one_wp))
    if not (torch.equal(one_w, one_wp) and bool(changed_w) == bool(changed_wp)):
        raise AssertionError("csgraph_path: one round of K7's sliced route at 128 sources differs from the plain round")

    # times at the bench graph
    solve_ms = la_wall_ms(lambda: csgraph.dijkstra(a, indices=sources))
    solve_reads = reads_back(lambda: csgraph.dijkstra(a, indices=sources))
    # the solve's parts: the edge list read back to the host, and the loop of rounds alone
    triplet_ms = la_wall_ms(lambda: csgraph._graph_triplet(a))
    loop_ms = la_wall_ms(lambda: minplus.minplus_fixpoint(distT0, ell.e_src, ell.e_w, ell.tail, maxiter=n + 1, **deg))
    stamp = torch.zeros(1, dtype=torch.int32, device=dev)

    def k7(table, dst, cols, layout=ell):
        counts = {"deg": layout.deg, "t_deg": layout.t_deg}
        return lambda: _cuda.minplus_relax(table, layout.e_src, layout.e_w, layout.tail, dst, stamp, 1, slice_cols=cols, **counts)

    # no single PyTorch call computes a min-plus product: scatter_reduce_'s
    # "amin" over the edge list, its candidates computed beforehand
    def library_ms(table, rows_, cols_, w_, reps):
        cand = table[rows_]
        cand += w_[:, None]
        seg = torch.full_like(table, torch.inf)
        idx = cols_[:, None].expand(-1, table.shape[1])
        ms = time_eager(lambda: seg.scatter_reduce_(0, idx, cand, "amin"), reps=reps)
        del cand, seg
        return ms

    k7_ms = time_graph(k7(distT0, out, cols8))
    k7_eager = time_eager(lambda: minplus.minplus_relax(distT0, ell.e_src, ell.e_w, ell.tail, out=out, **deg))
    plain_eager = time_eager(lambda: minplus.minplus_relax_plain(distT0, ell.e_src, ell.e_w, ell.tail), reps=5)
    plain_graph = time_graph(lambda: minplus.minplus_relax_plain(distT0, ell.e_src, ell.e_w, ell.tail), reps=5)
    e_rows, e_cols, e_w = (torch.from_numpy(x).to(dev) for x in (h_rows, h_cols, h_w))
    if ell.inv is not None:  # the layout's labels, as the tables'
        e_rows, e_cols = ell.inv[e_rows], ell.inv[e_cols]
    lib_ms = library_ms(distT0, e_rows, e_cols, e_w, 20)
    k7_w_ms = time_graph(k7(wide0, out_w, cols_w))
    k7_w_gather_ms = time_graph(k7(wide0, out_w, 0))
    # the gather route's table at 128 sources (several 32-lane chunks a destination), bit for bit
    k7_err_w = max(k7_err_w, cg_max_abs_diff(out_w, one_wp))
    if not torch.equal(out_w, one_wp):
        raise AssertionError("csgraph_path: one round of K7's gather route at 128 sources differs from the plain round")
    del one_wp
    plain_w_ms = time_eager(lambda: minplus.minplus_relax_plain(wide0, ell.e_src, ell.e_w, ell.tail), reps=2)
    lib_w_ms = library_ms(wide0, e_rows, e_cols, e_w, 5)
    del wide0, out_w, one_w, e_rows, e_cols, e_w
    # the bytes a round needs: each edge's source and weight (int64 and
    # float64) once, the table read once and written once; the layout's +inf
    # padding slots are not counted
    k7_bytes = nnz * 16 + 2 * n * CG_SOURCES * 8
    k7_bound = k7_bytes / HBM_BYTES_PER_S * 1e3  # a comparison and an add an edge: far below the float64 peak
    k7_w_bytes = nnz * 16 + 2 * n * CG_WIDE_SOURCES * 8
    k7_w_bound = k7_w_bytes / HBM_BYTES_PER_S * 1e3
    slots = ell.e_src.numel() + (0 if ell.tail is None else ell.tail[0].numel())
    layout_extra = 4 * (ell.deg.numel() + (0 if ell.t_deg is None else ell.t_deg.numel()))  # deg and t_deg, int32
    k7_line = {
        "name": f"K7 minplus_relax, {route8} route (csgraph_path: dijkstra, bench graph 131,072 nodes, 8 sources, float64)",
        "route": "cuda",
        "source": SOURCE["minplus_relax"],
        "replaces": REPLACES["minplus_relax"],
        "launches": launches_dij["minplus_relax"],
        "max_abs_err": k7_err,  # one round on the filled slots and on every slot, both fixed points, against the plain version
        "ms": k7_ms,
        "plain_ms": plain_eager,
        "bound_ms": k7_bound,
        "bound_by": "bytes",
        "library_ms": lib_ms,  # scatter_reduce_(..., "amin") over the edge list, one call
    }
    k7_w_line = {
        "name": f"K7 minplus_relax, {route_w} route, {cols_w} columns a slice (csgraph_path: dijkstra, bench graph, 128 sources, float64)",
        "route": "cuda",
        "source": SOURCE["minplus_relax"],
        "replaces": REPLACES["minplus_relax"],
        "launches": launches_w["minplus_relax"],
        "max_abs_err": k7_err_w,  # the fixed point through dijkstra and one round on each route, against the plain version
        "ms": k7_w_ms,
        "plain_ms": plain_w_ms,
        "bound_ms": k7_w_bound,
        "bound_by": "bytes",
        "library_ms": lib_w_ms,
    }
    library = "scatter_reduce_ amin over the edge list (candidates precomputed); no PyTorch call computes a min-plus product"
    log(json.dumps({**k7_line, "eager_ms": k7_eager, "plain_graph_ms": plain_graph, "bound_bytes": k7_bytes, "bound_share": k7_bound / k7_ms, "layout_slots": slots, "layout_extra_bytes": layout_extra, "edges": nnz, "library": library, "card": card}))
    log(json.dumps({**k7_w_line, "gather_route_ms": k7_w_gather_ms, "bound_bytes": k7_w_bytes, "bound_share": k7_w_bound / k7_w_ms, "rounds": rounds_w, "library": library, "card": card}))
    del distT0, out

    # all sources, through shortest_path on the sliced route
    a_all, host_all, (r_all, c_all, w_all) = cg_graph(CG_ALL_NODES, CG_ALL_EDGES, CG_SEED + 1, dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_all = csgraph.shortest_path(a_all, method="BF")
    torch.cuda.synchronize()
    all_s = time.perf_counter() - t0
    launches_all = dict(LAUNCHES)
    all_rounds = launches_all["minplus_relax"] - 1
    if sum(launches_all.values()) != all_rounds + 1 or all_rounds < 1:
        raise AssertionError(f"csgraph_path: shortest_path at all sources launched {launches_all}")
    sample = np.sort(np.random.default_rng(CG_SEED + 2).choice(CG_ALL_NODES, CG_ALL_SAMPLE, replace=False))
    err_all = cg_check_dist("shortest_path BF, all sources (sample)", d_all[torch.from_numpy(sample).to(dev)], sp_csgraph.dijkstra(host_all, indices=sample))
    ell_all = a_all.peek_layout("dest_ell", True)
    del d_all
    route_all, cols_all = _cuda.minplus_route(CG_ALL_NODES, CG_ALL_NODES, 8)
    if route_all != "sliced":
        raise AssertionError(f"csgraph_path: the route rule sends all sources to {route_all}, not the sliced route")
    all0 = csgraph._start_table(CG_ALL_NODES, CG_ALL_NODES, torch.arange(CG_ALL_NODES, device=dev) if ell_all.inv is None else ell_all.inv, dev)
    all_out = torch.empty_like(all0)
    all_round_ms = time_graph(k7(all0, all_out, cols_all, ell_all), reps=5)

    def plain_all():
        """The plain round in slices of CG_ALL_PLAIN_COLS columns (its whole block would be 34 GB)."""
        got = torch.empty_like(all0)
        for c0 in range(0, CG_ALL_NODES, CG_ALL_PLAIN_COLS):
            got[:, c0 : c0 + CG_ALL_PLAIN_COLS] = minplus.minplus_relax_plain(all0[:, c0 : c0 + CG_ALL_PLAIN_COLS].contiguous(), ell_all.e_src, ell_all.e_w, ell_all.tail)[0]
        return got

    want_all = plain_all()
    k7(all0, all_out, cols_all, ell_all)()
    k7_err_all = cg_max_abs_diff(all_out, want_all)
    if not torch.equal(all_out, want_all):
        raise AssertionError("csgraph_path: K7's sliced round at all sources differs from the plain round")
    all_gather_ms = time_graph(k7(all0, all_out, 0, ell_all), reps=5)
    k7_err_all = max(k7_err_all, cg_max_abs_diff(all_out, want_all))
    if not torch.equal(all_out, want_all):
        raise AssertionError("csgraph_path: K7's gather round at all sources differs from the plain round")
    del want_all
    plain_all_ms = time_eager(plain_all, reps=1)
    r_t, c_t, w_t = (torch.from_numpy(x).to(dev) for x in (r_all, c_all, w_all))
    if ell_all.inv is not None:
        r_t, c_t = ell_all.inv[r_t], ell_all.inv[c_t]
    lib_all_ms = library_ms(all0, r_t, c_t, w_t, 1)
    all_bytes = a_all.nnz * 16 + 2 * all0.numel() * 8
    all_bound = all_bytes / HBM_BYTES_PER_S * 1e3
    k7_all_line = {
        "name": f"K7 minplus_relax, {route_all} route, {cols_all} columns a slice (csgraph_path: shortest_path BF, all sources of 16,384 nodes, float64)",
        "route": "cuda",
        "source": SOURCE["minplus_relax"],
        "replaces": REPLACES["minplus_relax"],
        "launches": launches_all["minplus_relax"],
        "max_abs_err": k7_err_all,  # one round on each route against the plain round taken in column slices
        "ms": all_round_ms,
        "plain_ms": plain_all_ms,  # the plain round in column slices of CG_ALL_PLAIN_COLS
        "bound_ms": all_bound,
        "bound_by": "bytes",
        "library_ms": lib_all_ms,
    }
    log(json.dumps({**k7_all_line, "gather_route_ms": all_gather_ms, "bound_bytes": all_bytes, "bound_share": all_bound / all_round_ms, "rounds": all_rounds, "library": library, "card": card}))
    del all0, all_out, a_all, r_t, c_t, w_t
    torch.cuda.empty_cache()

    # PageRank on K1
    reset_launch_counts()
    scores, iters = csgraph.pagerank(a)
    torch.cuda.synchronize()
    launches_pr = dict(LAUNCHES)
    want_p, want_it = cg_pagerank_host(host)
    pr_err = float(np.abs(scores.cpu().numpy() - want_p).max())
    pr_rel = pr_err / float(np.abs(want_p).max())
    if iters != want_it or not pr_rel <= CG_PR_RTOL:
        raise AssertionError(f"csgraph_path: pagerank {iters} iterations (host {want_it}), max abs err {pr_err}, relative {pr_rel}")
    if launches_pr["row_ell_spmv"] != iters or sum(launches_pr.values()) != iters:
        raise AssertionError(f"csgraph_path: pagerank launched {launches_pr} for {iters} iterations")
    scores2, _ = csgraph.pagerank(a)
    if not torch.equal(scores, scores2):
        raise AssertionError("csgraph_path: pagerank's scores moved between two calls")
    pr_ms = la_wall_ms(lambda: csgraph.pagerank(a))
    pr_inputs_ms = la_wall_ms(lambda: csgraph._pagerank_inputs(a, None))
    pr_reads = reads_back(lambda: csgraph.pagerank(a))
    wt = a.peek_layout("pagerank_walk", None)
    rell = wt.to_row_ell()
    p_vec = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    pr_out = torch.empty_like(p_vec)
    k1_got = row_ell.row_ell_spmv(rell, p_vec)
    k1_err = float((k1_got - row_ell._spmv_plain(rell, p_vec)).abs().max())
    if not k1_err <= 1e-15:
        raise AssertionError(f"csgraph_path: K1 at PageRank's shape against its plain version, max abs err {k1_err}")
    k1_ms = time_graph(lambda: _cuda.spmv(rell, p_vec, None, pr_out))
    k1_plain = time_eager(lambda: row_ell._spmv_plain(rell, p_vec), reps=5)
    csr_wt = torch.sparse_coo_tensor(wt.coords.long(), wt.data, (n, n)).coalesce().to_sparse_csr()
    k1_lib = time_eager(lambda: torch.mv(csr_wt, p_vec))
    k1_bytes = wt.nnz * (4 + 8) + 8 * n + 8 * n  # int32 column and float64 value an entry, x, y
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, 2 * wt.nnz / F64_FLOPS_PER_S) * 1e3
    k1_line = {
        "name": "row_ell_spmv (csgraph_path: pagerank's Wᵀ p, bench graph, float64)",
        "route": "cuda",
        "source": SOURCE["row_ell_spmv"],
        "replaces": REPLACES["row_ell_spmv"],
        "launches": launches_pr["row_ell_spmv"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain,
        "bound_ms": k1_bound,
        "bound_by": "bytes",
        "library_ms": k1_lib,
    }
    log(json.dumps({**k1_line, "bound_bytes": k1_bytes, "bound_share": k1_bound / k1_ms, "card": card}))
    del csr_wt, k1_got

    # weak components, the spanning tree of the symmetrised graph, Floyd-Warshall
    t0 = time.perf_counter()
    n_cc, labels = csgraph.connected_components(a)
    torch.cuda.synchronize()
    cc_s = time.perf_counter() - t0
    ref_n, ref_labels = sp_csgraph.connected_components(host, directed=True, connection="weak")
    if n_cc != ref_n or not np.array_equal(labels.cpu().numpy(), ref_labels):
        raise AssertionError(f"csgraph_path: {n_cc} weak components against scipy's {ref_n}, or other labels")
    und = host.maximum(host.T)
    und_c = und.tocoo()
    a_und = st.COO(torch.from_numpy(np.stack([und_c.row, und_c.col]).astype(np.int64)).to(dev), torch.from_numpy(und_c.data).to(dev), shape=(n, n))
    t0 = time.perf_counter()
    tree = csgraph.minimum_spanning_tree(a_und)
    mst_s = time.perf_counter() - t0
    ref_tree = sp_csgraph.minimum_spanning_tree(und)
    tree_w, ref_w = float(tree.data.sum()), float(ref_tree.data.sum())
    if tree.nnz != ref_tree.nnz or not abs(tree_w - ref_w) <= CG_RTOL * ref_w:
        raise AssertionError(f"csgraph_path: spanning tree nnz {tree.nnz} weight {tree_w} against scipy's {ref_tree.nnz}, {ref_w}")
    a_fw, host_fw, _ = cg_graph(CG_FW_NODES, 8 * CG_FW_NODES, CG_SEED + 3, dev)
    t0 = time.perf_counter()
    d_fw = csgraph.floyd_warshall(a_fw)
    torch.cuda.synchronize()
    fw_s = time.perf_counter() - t0
    err_fw = cg_check_dist("floyd_warshall", d_fw, sp_csgraph.floyd_warshall(host_fw))

    line = {
        "csgraph_path": "ok",
        "seconds": time.perf_counter() - t_phase,
        "graph": {"nodes": n, "edge_draws": CG_EDGES, "edges": nnz, "sources": CG_SOURCES, "seed": CG_SEED},
        "layout": {"L0": L0, "tail": tail_shape, "relabelled": ell.inv is not None, "first_call_s_incl_layout": first_s},
        "rounds": rounds,
        "launches": {k: {c: v for c, v in got.items() if v} for k, got in (("dijkstra", launches_dij), ("bellman_ford", launches_bf), ("dijkstra_128_sources", launches_w), ("shortest_path_all_sources", launches_all), ("pagerank", launches_pr))},
        "rel_err_vs_scipy": {"dijkstra": err_dij, "bellman_ford": err_bf, "predecessor_edges": path_err, "all_sources_sample": err_all, "floyd_warshall": err_fw},
        "solve": {"wall_ms": solve_ms, "ms_per_round": solve_ms / (rounds + 1), "reads_back_per_solve": solve_reads, "graph_triplet_ms": triplet_ms, "loop_ms": loop_ms, "loop_ms_per_round": loop_ms / (rounds + 1)},
        "k7_ms": {"route": route8, "graph": k7_ms, "eager": k7_eager, "plain_eager": plain_eager, "plain_graph": plain_graph, "bound": k7_bound, "scatter_reduce_amin": lib_ms},
        "layout_extra_bytes": layout_extra,
        "wide_128_sources": {"route": route_w, "slice_cols": cols_w, "rounds": rounds_w, "launches": launches_w["minplus_relax"], "k7_round_ms": k7_w_ms, "gather_route_ms": k7_w_gather_ms, "k7_round_bound_ms": k7_w_bound, "plain_ms": plain_w_ms, "scatter_reduce_amin": lib_w_ms, "plain_block_bytes": n * L0 * CG_WIDE_SOURCES * 8},
        "all_sources": {"nodes": CG_ALL_NODES, "edges": CG_ALL_EDGES, "route": route_all, "slice_cols": cols_all, "rounds": all_rounds, "wall_s": all_s, "k7_round_ms": all_round_ms, "gather_route_ms": all_gather_ms, "k7_round_bound_ms": all_bound, "plain_ms": plain_all_ms, "plain": f"in column slices of {CG_ALL_PLAIN_COLS} (the whole block would be n * L0 * k * 8 bytes)", "scatter_reduce_amin": lib_all_ms, "sample_rows": CG_ALL_SAMPLE},
        "pagerank": {"iterations": iters, "max_abs_err_vs_host": pr_err, "rel_err_vs_host": pr_rel, "wall_ms": pr_ms, "ms_per_iteration": pr_ms / iters, "reads_back_per_solve": pr_reads, "inputs_ms": pr_inputs_ms, "k1_ms": k1_ms},
        "components": {"n": n_cc, "seconds": cc_s},
        "spanning_tree": {"nnz": tree.nnz, "weight": tree_w, "seconds": mst_s},
        "floyd_warshall": {"nodes": CG_FW_NODES, "seconds": fw_s},
        "card": card,
    }
    return line, [k7_line, k7_w_line, k7_all_line, k1_line]


# The multi-device layer (the parallel_path line): a world of one on NCCL,
# its process group from an in-process HashStore, the rank holding every
# shard. BASELINE config 5's MTTKRP tensor in 1 and PAR_SHARDS shards (E2
# through mttkrp_sharded_ell, K3 through mttkrp_sharded), SDDMM (K4) and the
# SpMMs, sums and unions on the bench matrix in PAR_SHARDS shards, SpGEMM at
# the spgemm_path's 4,096^2 shape (jitops.spgemm's), the bench partition's
# checkpoint, profiling.benchmark on K2 and profiling.trace around
# mttkrp_sharded_ell
PAR_SHARDS = 4
PAR_REPS = 5  # wall and device ms: the median of this many eager calls
# sum_partitioned in float32 against a float64 bincount: each shard's
# partial sums up to 2.1M entries in another order than the oracle
PAR_SUM_RTOL = 1e-5
PAR_SPGEMM_RTOL = 1e-5  # SpGEMM's tolerance (PERF.md §2)
PAR_DIR = "build/parallel_path"  # the checkpoint and the trace, inside the checkout, removed after


def wall_and_device_ms(fn, reps=PAR_REPS):
    """(median host ms of one eager call up to its synchronize, median
    device ms of one call from CUDA events around it)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls)), device_ms(fn, reps)


def mttkrp_coo_shards(coords, vals, n_rows, n_shards):
    """``mttkrp_sharded``'s i-partition (tests/test_parallel.py:61's form)
    of a row-sorted COO tensor, built on its device: ``(n_shards, cap)``
    local rows, ``j``, ``k`` and values, zero padding at each shard's end."""
    block_rows = -(-n_rows // n_shards)
    ci = coords[0].long()
    bounds = torch.searchsorted(ci, torch.arange(n_shards + 1, device=ci.device) * block_rows).tolist()
    counts = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    cap = max(max(counts), 1)
    out = [torch.zeros((n_shards, cap), dtype=torch.int32, device=ci.device) for _ in range(3)]
    out.append(torch.zeros((n_shards, cap), dtype=vals.dtype, device=ci.device))
    for s, (lo, k) in enumerate(zip(bounds, counts)):
        for o, src in zip(out, (ci - s * block_rows, coords[1], coords[2], vals)):
            o[s, :k] = src[lo : lo + k]
    return out


def shard_prefixes(x, counts):
    """The first ``counts[s]`` entries of each shard's row of ``x``, in shard order."""
    return torch.cat([x[s, :k] for s, k in enumerate(counts)])


def phase_parallel_path(dev, a, t, c, d, lay, card):
    """The multi-device layer (``sparse_tpu_torch.parallel``) through its
    entry points on a mesh of one NCCL rank, counted: E2 once a shard of
    ``mttkrp_sharded_ell``, K3 of ``mttkrp_sharded``, K4 of ``sddmm_sharded``,
    no other kernel. Each result against the unsharded call on the card:
    one shard the same bits, several within MT_ORACLE_TOL (MTTKRP) or
    SD_ORACLE_TOL (SDDMM), the SpMMs within ORACLE_TOL of ``a @ B`` (K2), the
    sums within PAR_SUM_RTOL of a float64 bincount, the union exactly as
    ``a + a.T``, SpGEMM's coordinates exactly as ``a4 @ a4`` and its values
    within PAR_SPGEMM_RTOL; the checkpoint's round trip array for array;
    ``profiling.benchmark`` beside ``time_graph`` on K2; ``profiling.trace``
    of one ``mttkrp_sharded_ell`` naming E2's kernel (``run_sum_kernel`` on
    its ``MttkrpSum``) once a shard.
    Returns the phase's line and one line a timed pair."""
    import shutil

    import torch.distributed as dist

    import sparse_tpu_torch as st
    from sparse_tpu_torch import checkpoint, parallel, profiling
    from sparse_tpu_torch.kernels import LAUNCHES, _cuda, reset_launch_counts
    from sparse_tpu_torch.kernels import dot as kdot
    from sparse_tpu_torch.kernels import ell as kell
    from sparse_tpu_torch.kernels.row_ell import ROW_ELL_DEFAULT_KEY
    from torch.distributed.tensor import DTensor, Shard

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh()
        n = PAR_SHARDS
        gen = torch.Generator(device=dev).manual_seed(25)
        bmat = torch.rand((K, N), generator=gen, device=dev)
        lhs = torch.rand((M, SD_K), generator=gen, device=dev)
        rhs = torch.rand((K, SD_K), generator=gen, device=dev).T
        rng = np.random.default_rng(25)
        r4, c4, v4 = _unique_draw(rng, SG_JIT_LEN, SG_JIT_DENSITY, np.float32)
        a4 = st.COO(np.stack([r4, c4]), v4, shape=(SG_JIT_LEN,) * 2, device=dev)
        at = a.T
        torch.cuda.synchronize()

        # the host partitions (set-up: once a matrix), moved to the card once
        t0 = time.perf_counter()
        mt_ell = {k: parallel.partition_mttkrp_ell(t.coords, t.data, MT_I, k) for k in (1, n)}
        t_mt_ell = time.perf_counter()
        mt_ell = {k: (*(x.to(dev) for x in p[:4]), p[4]) for k, p in mt_ell.items()}
        mt_coo = {k: mttkrp_coo_shards(t.coords, t.data, MT_I, k) for k in (1, n)}
        pc = parallel.partition_coo_rows(a, n, mesh=mesh)
        pct = parallel.partition_coo_rows(at, n, mesh=mesh)
        pc4 = parallel.partition_coo_rows(a4, n, mesh=mesh)
        spmm_ell = (*(x.to(dev) for x in parallel.partition_spmm_ell(a, n)[:3]),)
        ring = parallel.bucket_columns(pc, n)
        ring = (*(x.to(dev) for x in ring[:3]), ring[3])
        ring_ell = parallel.bucket_columns_ell(a, n)
        ring_ell = (*(x.to(dev) for x in ring_ell[:3]), *ring_ell[3:])
        dense_ring = DTensor.from_local(bmat, mesh, [Shard(0)], run_check=False)  # K-sharded, as the reference takes it
        torch.cuda.synchronize()
        setup_s = {"partition_mttkrp_ell_1_and_4": t_mt_ell - t0, "all": time.perf_counter() - t0}
        if ring[3] * n != K or ring_ell[4] * n != K:
            raise AssertionError("parallel_path: the bench shape's column buckets do not tile K")

        calls = {
            **{f"mttkrp_sharded_ell_{k}": (lambda k=k: parallel.mttkrp_sharded_ell(*mt_ell[k][:4], c, d, MT_I, mt_ell[k][4], mesh)) for k in (1, n)},
            **{f"mttkrp_sharded_{k}": (lambda k=k: parallel.mttkrp_sharded(*mt_coo[k], c, d, MT_I, mesh)) for k in (1, n)},
            "sddmm_sharded": lambda: parallel.sddmm_sharded(pc, lhs, rhs, mesh),
            "spmm_sharded_ell": lambda: parallel.spmm_sharded_ell(*spmm_ell, bmat, M, mesh),
            "spmm_replicated": lambda: parallel.spmm_replicated(pc, bmat, mesh),
            "spmm_ring": lambda: parallel.spmm_ring(ring, (M, K), pc.block_rows, dense_ring, mesh),
            "spmm_ring_ell": lambda: parallel.spmm_ring_ell(ring_ell, M, bmat, mesh),
            **{f"sum_partitioned_{ax}": (lambda ax=ax: parallel.sum_partitioned(pc, mesh, axis=ax)) for ax in (0, 1, None)},
            "elemwise_partitioned": lambda: parallel.elemwise_partitioned(torch.add, pc, pct, mesh),
            "spgemm_sharded": lambda: parallel.spgemm_sharded(pc4, a4, mesh),
        }
        # the path, counted: every count to 0 just before it, read just after
        reset_launch_counts()
        t0 = time.perf_counter()
        got = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want_launches = {"ell_mttkrp": 1 + n, "coo_mttkrp": 1 + n, "sddmm": n}
        if {k: v for k, v in launches.items() if v} != want_launches:
            raise AssertionError(f"parallel_path: launches {launches}, expected {want_launches} and no other kernel")

        # against the unsharded calls on the card
        unsharded = {
            "ell_mttkrp": lambda: kell.ell_mttkrp(*lay[:4], c, d, n_rows=MT_I, order=lay.order, row_ptr=lay.row_ptr, pieces=lay.pieces),
            "mttkrp": lambda: kdot.mttkrp(*t.coords, t.data, c, d, n_rows=MT_I),
            "sddmm": lambda: kdot.sddmm(a.coords[0], a.coords[1], a.data, lhs, rhs),
            "a @ B": lambda: a @ bmat,
            **{f"a.sum(axis={ax})": (lambda ax=ax: a.sum(axis=ax)) for ax in (0, 1, None)},
            "a + a.T": lambda: a + at,
            "jitops.spgemm": None,  # set below, with its capacity
        }
        checks = {}
        same_bits = {}
        for form, whole in (("mttkrp_sharded_ell", unsharded["ell_mttkrp"]()), ("mttkrp_sharded", unsharded["mttkrp"]())):
            for k in (1, n):
                out = got[f"{form}_{k}"]
                rows_same = int((out == whole).all(1).sum())
                same_bits[f"{form}_{k}"] = {"rows_same_bits": rows_same, "rows": MT_I}
                if k == 1 and not torch.equal(out, whole):
                    raise AssertionError(f"parallel_path: {form} with one shard differs from the unsharded call in {MT_I - rows_same} rows")
                err = normalised_err(out, whole.double())
                if not err <= MT_ORACLE_TOL["exact"]:
                    raise AssertionError(f"parallel_path: {form} with {k} shards at {err} of the unsharded call")
                checks[f"{form}_{k}"] = err
        counts = torch.bincount(a.coords[0].long() // pc.block_rows, minlength=n).tolist()
        sd_whole = unsharded["sddmm"]()
        sd_got = shard_prefixes(got["sddmm_sharded"], counts)
        # every input is nonnegative: the value is its own scale |s| · Σ|lhs · rhs|
        checks["sddmm_sharded"] = check_sddmm("sddmm_sharded", sd_got, sd_whole.double(), sd_whole.double().abs(), SD_ORACLE_TOL)
        same_bits["sddmm_sharded"] = bool(torch.equal(sd_got, sd_whole))
        mm_whole = unsharded["a @ B"]()
        for name in ("spmm_sharded_ell", "spmm_replicated", "spmm_ring", "spmm_ring_ell"):
            checks[name] = check_close(name, got[name], mm_whole, ORACLE_TOL)
        rows_h, cols_h = (x.cpu().numpy() for x in a.coords)
        vals_h = a.data.double().cpu().numpy()
        oracle = {0: np.bincount(cols_h, vals_h, minlength=K), 1: np.bincount(rows_h, vals_h, minlength=M), None: vals_h.sum()}
        for ax in (0, 1, None):
            name = f"sum_partitioned_{ax}"
            want = torch.as_tensor(oracle[ax], device=dev)
            torch.testing.assert_close(got[name].double(), want, rtol=PAR_SUM_RTOL, atol=0, msg=lambda m, name=name: f"{name}: {m}")
            checks[name] = float(((got[name].double() - want).abs() / want.abs().clamp_min(1e-300)).max())
        union, nnz = got["elemwise_partitioned"]
        nnz = nnz.tolist()
        keep = shard_prefixes(union.data, nnz) != 0  # the padding's one slot a shard holds func(0, 0) = 0
        u_rows = shard_prefixes(union.rows.long() + torch.arange(n, device=dev)[:, None] * union.block_rows, nnz)[keep]
        u_cols, u_vals = shard_prefixes(union.cols.long(), nnz)[keep], shard_prefixes(union.data, nnz)[keep]
        e_whole = unsharded["a + a.T"]()
        if not (torch.equal(torch.stack([u_rows, u_cols]), e_whole.coords.long()) and torch.equal(u_vals, e_whole.data)):
            raise AssertionError("parallel_path: elemwise_partitioned differs from a + a.T")
        checks["elemwise_partitioned"] = 0.0
        sg = parallel.assemble_spgemm_result(got["spgemm_sharded"], pc4, SG_JIT_LEN)
        sg_whole = a4 @ a4
        if not torch.equal(sg.coords.long(), sg_whole.coords.long()):
            raise AssertionError("parallel_path: spgemm_sharded's coordinates differ from a4 @ a4")
        torch.testing.assert_close(sg.data, sg_whole.data, rtol=PAR_SPGEMM_RTOL, atol=0)
        checks["spgemm_sharded"] = float(((sg.data - sg_whole.data).abs() / sg_whole.data.abs()).max())
        cap4 = int(got["spgemm_sharded"][0].shape[1])
        cap_whole = max(st.kernels.product_count(a4.coords[1], a4.coords[0], SG_JIT_LEN), 1)
        unsharded["jitops.spgemm"] = lambda: st.jitops.spgemm(a4, a4, product_capacity=cap_whole)

        # the checkpoint of the bench partition, and the profiling helpers
        t0 = time.perf_counter()
        checkpoint.save_partitioned(f"{PAR_DIR}/ckpt", pc)
        t_save = time.perf_counter()
        back = checkpoint.load_partitioned(f"{PAR_DIR}/ckpt", mesh=mesh)
        torch.cuda.synchronize()
        t_load = time.perf_counter()
        for x, y in ((back.rows, pc.rows), (back.cols, pc.cols), (back.data, pc.data)):
            if not torch.equal(x.full_tensor(), y.full_tensor()):
                raise AssertionError("parallel_path: the checkpoint's round trip changed an array")
        re = a.peek_layout("row_ell", ROW_ELL_DEFAULT_KEY)
        out_m = torch.empty((M, N), device=dev)
        k2_graph_ms = time_graph(lambda: _cuda.spmm(re, bmat, out_m))
        k2_bench_ms = profiling.benchmark(lambda b: _cuda.spmm(re, b, out_m), (bmat,), iters=50) * 1e3
        k2_bench_plain_ms = profiling.benchmark(lambda b: _cuda.spmm(re, b, out_m), (bmat,), iters=50, perturb=None) * 1e3
        bump_ms = time_graph(lambda: bmat + 1e-6)
        with profiling.trace(f"{PAR_DIR}/trace") as log_dir:
            parallel.mttkrp_sharded_ell(*mt_ell[n][:4], c, d, MT_I, mt_ell[n][4], mesh)
            torch.cuda.synchronize()
        with open(f"{log_dir}/trace.json") as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
        # E2's kernel: csrc/mttkrp.cu's run_sum_kernel on its MTTKRP sum
        named = sum("run_sum_kernel" in e.get("name", "") and "MttkrpSum" in e.get("name", "") for e in kernels)
        if named != n:
            names = sorted({e.get("name", "")[:120] for e in kernels})[:12]
            cats = sorted({str(e.get("cat")) for e in events})
            raise AssertionError(f"parallel_path: the trace names E2's kernel {named} times, not once a shard ({n}); kernels {names}; categories {cats}")
        by_kernel = {}
        for e in kernels:
            key = e["name"].split("(")[0][:80]
            by_kernel[key] = by_kernel.get(key, 0.0) + e.get("dur", 0.0) / 1e3
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]

        # each sharded call beside its unsharded call: wall and device ms
        pairs = {
            **{f"mttkrp_sharded_ell_{k}": "ell_mttkrp" for k in (1, n)},
            **{f"mttkrp_sharded_{k}": "mttkrp" for k in (1, n)},
            "sddmm_sharded": "sddmm",
            **{k: "a @ B" for k in ("spmm_sharded_ell", "spmm_replicated", "spmm_ring", "spmm_ring_ell")},
            **{f"sum_partitioned_{ax}": f"a.sum(axis={ax})" for ax in (0, 1, None)},
            "elemwise_partitioned": "a + a.T",
            "spgemm_sharded": "jitops.spgemm",
        }
        whole_ms = {name: wall_and_device_ms(fn) for name, fn in unsharded.items()}
        lines = []
        for name, whole in pairs.items():
            wall, dev_ms = wall_and_device_ms(calls[name])
            w_wall, w_dev = whole_ms[whole]
            lines.append(
                {
                    "parallel_call": name,
                    "shards": 1 if name.endswith("_1") else n,
                    "wall_ms": wall,
                    "device_ms": dev_ms,
                    "unsharded": whole,
                    "unsharded_wall_ms": w_wall,
                    "unsharded_device_ms": w_dev,
                    "layer_wall_ms": wall - w_wall,
                    "layer_device_ms": dev_ms - w_dev,
                    "card": card,
                }
            )
        line = {
            "parallel_path": "ok",
            "seconds": time.perf_counter() - t_phase,
            "world": dist.get_world_size(),
            "backend": str(dist.get_backend()),
            "shards": n,
            "shapes": {"mttkrp": [MT_I, MT_J, MT_K, MT_R, t.nnz], "bench": [M, K, a.nnz, N, SD_K], "spgemm": [SG_JIT_LEN, a4.nnz]},
            "mttkrp_ell_caps": {k: int(mt_ell[k][0].shape[-1]) for k in (1, n)},
            "spgemm_capacity": {"sharded": cap4, "whole": cap_whole},
            "setup_s": setup_s,
            "path_s": path_s,
            "launches": {k: v for k, v in launches.items() if v},
            "err_vs_unsharded": checks,
            "same_bits": same_bits,
            "checkpoint": {"save_s": t_save - t0, "load_s": t_load - t_save},
            "profiling": {
                "k2_time_graph_ms": k2_graph_ms,
                "k2_benchmark_ms": k2_bench_ms,
                "k2_benchmark_unperturbed_ms": k2_bench_plain_ms,
                "perturb_add_ms": bump_ms,
                "trace_e2_kernel_events": named,
                "trace_top_kernels_ms": top,
            },
            "card": card,
        }
        return line, lines
    finally:
        dist.destroy_process_group()
        shutil.rmtree(PAR_DIR, ignore_errors=True)


# The partitioned forms (the partitioned_path line): the same world of one on
# NCCL, at the unsharded paths' shapes: the csgraph_path's bench graph
# (bellman_ford_partitioned on K7 from CG_SOURCES sources, with predecessors;
# pagerank_partitioned on K1), the linalg_path's Poisson matrix at side
# LA_SIDE (dia_spmv_sharded on its 5 offsets; cg on partitioned_matvec over
# PAR_SHARDS row shards), the attention_path's head (L = AT_L, window
# AT_WINDOW, d = dv = AT_D: banded_attention_sharded, causal and not;
# sparse_attention_sharded over PAR_SHARDS shards, K4 and K5 a shard), then
# entry() and dryrun_multichip(1)
PT_CG_REPS = 1  # a partitioned CG solve takes seconds: one timed call a side
PT_SEED = 26


def phase_partitioned_path(dev, card):
    """The partitioned forms through their entry points on a mesh of one
    NCCL rank, counted: K7 once a round of ``bellman_ford_partitioned`` (the
    unsharded solve's count), K1 once an iteration of
    ``pagerank_partitioned``, K4 and K5 once a shard of
    ``sparse_attention_sharded``, D1 once for ``dia_spmv_sharded``, no
    other kernel. Each result against the
    unsharded call on the card: the distances and predecessors bit for bit
    (``bellman_ford`` and ``dijkstra``), PageRank within CG_PR_RTOL of max
    |p| (whether its bits are equal is reported), ``dia_spmv_sharded`` bit
    for bit ``dia_spmv``, the partitioned CG converged with a true residual
    within LA_SLACK · LA_TOL, the attentions within AT_ORACLE_TOL · max|v|;
    ``entry()``'s step against its plain version within ORACLE_TOL;
    ``dryrun_multichip(1)``'s own asserts. Returns the phase's line and one
    line a timed pair."""
    import torch.distributed as dist

    import sparse_tpu_torch as st
    from sparse_tpu_torch import csgraph, entry, linalg, nn, parallel
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts, row_ell
    from sparse_tpu_torch.kernels import dia as kdia
    from sparse_tpu_torch.kernels import dot as kdot

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh()
        n = PAR_SHARDS
        g, _, _ = cg_graph(CG_NODES, CG_EDGES, CG_SEED, dev)
        sources = np.arange(CG_SOURCES)
        r, c, vals = poisson_triplets(LA_SIDE, dev)
        n_la = LA_SIDE * LA_SIDE
        lap = st.COO(torch.stack([r, c]), vals, shape=(n_la, n_la))
        dia = lap.to_dia()
        if dia is None or dia.offsets != (-LA_SIDE, -1, 0, 1, LA_SIDE):
            raise AssertionError(f"partitioned_path: the Poisson matrix built no 5-offset DIA layout ({dia and dia.offsets})")
        gen = torch.Generator(device=dev).manual_seed(PT_SEED)
        x_la = torch.randn(n_la, generator=gen, dtype=torch.float64, device=dev)
        b_la = torch.randn(n_la, generator=gen, dtype=torch.float64, device=dev)
        p_lap = parallel.partition_coo_rows(lap, n, mesh=mesh)
        mv = linalg.partitioned_matvec(p_lap, mesh)
        q, k, v = (torch.randn((AT_L, AT_D), generator=gen, device=dev) for _ in range(3))
        rows, cols = nn.local_attention_pattern(AT_L, AT_WINDOW)
        lr, lc, valid, br = nn.partition_attention_pattern(rows, cols, AT_L, n)
        pattern = [torch.as_tensor(x, device=dev) for x in (lr, lc, valid)]
        rows_t, cols_t = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_phase

        calls = {
            "bellman_ford_partitioned": lambda: csgraph.bellman_ford_partitioned(g, mesh, indices=sources, return_predecessors=True),
            "pagerank_partitioned": lambda: csgraph.pagerank_partitioned(g, mesh),
            "dia_spmv_sharded": lambda: kdia.dia_spmv_sharded(dia.offsets, dia.bands, x_la, mesh),
            "cg_partitioned_matvec": lambda: linalg.cg(mv, b_la, tol=LA_TOL, return_iters=True),
            **{f"banded_attention_sharded_causal_{cz}": (lambda cz=cz: nn.banded_attention_sharded(q, k, v, window=AT_WINDOW, mesh=mesh, block=AT_BLOCK, causal=cz)) for cz in (False, True)},
            "sparse_attention_sharded": lambda: nn.sparse_attention_sharded(q, k, v, *pattern, br, mesh),
        }
        # the path, counted: every count to 0 just before it, read just after
        reset_launch_counts()
        t0 = time.perf_counter()
        got = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = {kk: vv for kk, vv in LAUNCHES.items() if vv}

        # the unsharded calls on the card
        unsharded = {
            "bellman_ford_partitioned": lambda: csgraph.bellman_ford(g, indices=sources, return_predecessors=True),
            "pagerank_partitioned": lambda: csgraph.pagerank(g),
            "dia_spmv_sharded": lambda: kdia.dia_spmv(dia.offsets, dia.bands, x_la),
            "cg_partitioned_matvec": None,  # set below: the K1 solve of the same matrix
            **{f"banded_attention_sharded_causal_{cz}": (lambda cz=cz: nn.banded_attention(q, k, v, window=AT_WINDOW, block=AT_BLOCK, causal=cz)) for cz in (False, True)},
            "sparse_attention_sharded": lambda: nn.sparse_attention(q, k, v, rows_t, cols_t),
        }
        reset_launch_counts()
        d_bf, p_bf = unsharded["bellman_ford_partitioned"]()
        torch.cuda.synchronize()
        bf_rounds = LAUNCHES["minplus_relax"]
        d_dij, p_dij = csgraph.dijkstra(g, indices=sources, return_predecessors=True)
        reset_launch_counts()
        pr_whole, pr_it_whole = unsharded["pagerank_partitioned"]()
        torch.cuda.synchronize()
        pr_launches_whole = LAUNCHES["row_ell_spmv"]
        pr, pr_it = got["pagerank_partitioned"]
        # K5's calls: its gather and sliced routes' launches (the union route
        # launches its union kernel and the gather route on its flagged blocks)
        k5_union = launches.get("sampled_row_sum_union", 0)
        k5 = launches.get("sampled_row_sum", 0) + launches.get("sampled_row_sum_sliced", 0)
        want_launches = {"minplus_relax": bf_rounds, "row_ell_spmv": pr_it, "sddmm": n, "dia_spmv": 1}
        others = sum(launches.values()) - sum(want_launches.values()) - k5 - k5_union
        if {kk: launches.get(kk, 0) for kk in want_launches} != want_launches or k5 != n or k5_union > launches.get("sampled_row_sum", 0) or others:
            raise AssertionError(f"partitioned_path: launches {launches}, expected {want_launches}, {n} K5 calls, no other kernel")

        checks, same_bits = {}, {}
        d_pt, p_pt = got["bellman_ford_partitioned"]
        for name, (dd, pp) in (("bellman_ford", (d_bf, p_bf)), ("dijkstra", (d_dij, p_dij))):
            if not (torch.equal(d_pt, dd) and torch.equal(p_pt, pp)):
                raise AssertionError(f"partitioned_path: bellman_ford_partitioned differs from {name} in its distances or predecessors")
        same_bits["bellman_ford_partitioned"] = True
        pr_err = float((pr - pr_whole).abs().max() / pr_whole.abs().max())
        if not (pr_err <= CG_PR_RTOL and pr_it == pr_it_whole and pr_launches_whole == pr_it_whole):
            raise AssertionError(f"partitioned_path: pagerank_partitioned at {pr_err} of max |p| ({pr_it} iterations, the unsharded {pr_it_whole})")
        checks["pagerank_partitioned"] = pr_err
        same_bits["pagerank_partitioned"] = bool(torch.equal(pr, pr_whole))
        if not torch.equal(got["dia_spmv_sharded"], unsharded["dia_spmv_sharded"]()):
            raise AssertionError("partitioned_path: dia_spmv_sharded differs from dia_spmv")
        same_bits["dia_spmv_sharded"] = True
        x_cg, info_cg, it_cg = got["cg_partitioned_matvec"]
        res_cg = float(torch.linalg.vector_norm(b_la - kdia.dia_spmv(dia.offsets, dia.bands, x_cg)) / torch.linalg.vector_norm(b_la))
        if info_cg != 0 or not res_cg <= LA_SLACK * LA_TOL:
            raise AssertionError(f"partitioned_path: cg on partitioned_matvec info {info_cg}, true residual {res_cg}")
        rell = lap.to_row_ell()

        def mv_k1(vec):
            return row_ell.row_ell_spmv(rell, vec)

        mv_k1.shape = lap.shape
        unsharded["cg_partitioned_matvec"] = lambda: linalg.cg(mv_k1, b_la, tol=LA_TOL, return_iters=True)
        _, info_k1, it_k1 = unsharded["cg_partitioned_matvec"]()
        checks["cg_partitioned_matvec"] = res_cg
        for name in ("banded_attention_sharded_causal_False", "banded_attention_sharded_causal_True", "sparse_attention_sharded"):
            checks[name] = check_attention(f"partitioned_path: {name}", got[name], unsharded[name]().double(), v)

        # entry(): the fused step against its plain version; dryrun_multichip(1)
        fn, args = entry.entry()
        e_rows, e_cols, e_data, e_dense, e_bias = args

        def plain_step():
            out = kdot.coo_spmm(e_rows, e_cols, e_data, e_dense, n_rows=8192) + e_bias[None, :]
            return out, kdot.sddmm_plain(e_rows.long(), e_cols.long(), e_data, out, e_dense.T).sum()

        reset_launch_counts()
        e_out, e_loss = fn(*args)
        torch.cuda.synchronize()
        entry_launches = {kk: vv for kk, vv in LAUNCHES.items() if vv}
        p_out, p_loss = plain_step()
        checks["entry_out"] = check_close("entry out", e_out, p_out, ORACLE_TOL)
        # the step's SDDMM entries (K4, again on its own out: the same bits
        # sum to its loss) each within SD_PLAIN_TOL of their scale of the
        # plain version's on the same inputs; the loss is their sum
        e_sample = kdot.sddmm(e_rows, e_cols, e_data, e_out, e_dense.T)
        if not torch.equal(e_sample.sum(), e_loss):
            raise AssertionError("partitioned_path: entry's loss is not the sum of its SDDMM entries")
        _, e_scale = sddmm_oracle(e_rows, e_cols, e_data, e_out, e_dense)
        e_plain = kdot.sddmm_plain(e_rows, e_cols, e_data, e_out, e_dense.T)
        checks["entry_sddmm"] = check_sddmm("entry SDDMM vs sddmm_plain", e_sample, e_plain.double(), e_scale, SD_PLAIN_TOL)
        checks["entry_loss"] = check_close("entry loss", e_loss[None], p_loss[None], ORACLE_TOL)
        del e_sample, e_scale, e_plain
        reset_launch_counts()
        t0 = time.perf_counter()
        entry.dryrun_multichip(1)
        torch.cuda.synchronize()
        dryrun_s = time.perf_counter() - t0
        dryrun_launches = {kk: vv for kk, vv in LAUNCHES.items() if vv}

        # each partitioned call beside its unsharded call: wall and device ms
        lines = []
        pairs = {**{name: (calls[name], unsharded[name]) for name in calls}, "entry": (lambda: fn(*args), plain_step)}
        for name, (sharded_fn, whole_fn) in pairs.items():
            reps = PT_CG_REPS if name.startswith("cg_") else PAR_REPS
            wall, dev_ms = wall_and_device_ms(sharded_fn, reps)
            w_wall, w_dev = wall_and_device_ms(whole_fn, reps)
            lines.append(
                {
                    "partitioned_call": name,
                    "wall_ms": wall,
                    "device_ms": dev_ms,
                    "unsharded": "plain step" if name == "entry" else ("cg on K1, the same matrix" if name.startswith("cg_") else "the unsharded call"),
                    "unsharded_wall_ms": w_wall,
                    "unsharded_device_ms": w_dev,
                    "reps": reps,
                    "card": card,
                }
            )
        line = {
            "partitioned_path": "ok",
            "seconds": time.perf_counter() - t_phase,
            "world": dist.get_world_size(),
            "backend": str(dist.get_backend()),
            "shards": n,
            "shapes": {
                "graph": [CG_NODES, g.nnz, CG_SOURCES],
                "poisson": [LA_SIDE, n_la, lap.nnz, list(dia.offsets)],
                "attention": [AT_L, AT_WINDOW, AT_D, AT_BLOCK, len(rows)],
                "entry": [8192, 8192, int(e_rows.numel()), 128],
            },
            "setup_s": setup_s,
            "path_s": path_s,
            "launches": launches,
            "bellman_ford_rounds_unsharded_launches": bf_rounds,
            "pagerank_iterations": {"partitioned": pr_it, "unsharded": pr_it_whole},
            "cg_iterations": {"partitioned_matvec": it_cg, "k1": it_k1, "k1_info": info_k1},
            "err_vs_unsharded": checks,
            "same_bits": same_bits,
            "entry_launches": entry_launches,
            "dryrun_multichip_1": {"seconds": dryrun_s, "launches": dryrun_launches},
            "card": card,
        }
        return line, lines
    finally:
        dist.destroy_process_group()


# the one kernel row a later path's counter joins, by name and by the shape
# or route it runs: K7's gather route at the bench graph from 8 sources and
# K1 on PageRank's Wᵀ p (the path's shapes); K5's union route on the
# attention head's attn @ v, whose query shards the sharded attention runs
# (with the gather route's launches on the flagged blocks, which that
# route's entry point makes); K4 on the bench row, the one K4 row not at the
# example's shape (the path runs it on the attention shards, L = AT_L,
# d = AT_D); D1 at the linalg_path's Poisson shape, whose segment
# dia_spmv_sharded takes. The partitioned_path line holds every counter
PATH_ROWS = {
    "minplus_relax": lambda row: row["name"].startswith("K7 minplus_relax, gather route") and ", 8 sources" in row["name"],
    "row_ell_spmv": lambda row: row["name"].startswith("row_ell_spmv (csgraph_path: pagerank"),
    "sddmm": lambda row: row["name"] == "sddmm" and "shape" not in row,
    "sampled_row_sum_union": lambda row: row.get("of") == "attention_attn_v",
    "dia_spmv": lambda row: row["name"].startswith("D1 dia_spmv"),
}
PATH_ROW_EXTRA = {"sampled_row_sum_union": ("sampled_row_sum", "flagged_gather_launches")}


HOST_REPS = 3  # host ms of the library route: median of 3 calls


def cpu_model():
    """The CPU's model name from ``/proc/cpuinfo``, else its vendor, family
    and model numbers; with the FMA and AVX flags either way."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping") if k in fields
    )
    flags = [f for f in ("fma", "avx2", "avx512f") if f in fields.get("flags", "").split()]
    return f"{name or 'unknown'} ({' '.join(flags) or 'no fma/avx2/avx512f flag'})"


def host_ms(fn, reps):
    """``(median ms, last result)`` of ``reps`` calls of ``fn`` on the host."""
    times, out = [], None
    for _ in range(reps):
        del out
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def phase_host_path(dev, card):
    """The host library's call sites at the bench shape on the CPU, against
    the plain CPU route (the torch ops), and an integer MTTKRP on the card."""
    import os

    import sparse_tpu_torch as st
    from sparse_tpu_torch import native
    from sparse_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from sparse_tpu_torch.kernels import dot as kdot
    from sparse_tpu_torch.native import eager as te

    t0 = time.perf_counter()
    native.library()
    build = {"build_s": time.perf_counter() - t0, **native.BUILD_INFO}
    threads = {
        "os_cpu_count": os.cpu_count(),
        "affinity": len(os.sched_getaffinity(0)),
        "torch": torch.get_num_threads(),
    }
    log(json.dumps({"host_build": build, "cpu": cpu_model(), "threads": threads}))

    rng = np.random.default_rng(0)
    lin = rng.integers(0, M * K, size=NNZ_DRAWS, dtype=np.int64)
    rows, cols = lin // K, lin % K
    coords = torch.as_tensor(np.stack([rows, cols]))
    data = torch.as_tensor(rng.random(NNZ_DRAWS, dtype=np.float32))
    b = torch.as_tensor(rng.random((K, N), dtype=np.float32))
    x = torch.as_tensor(rng.random(K, dtype=np.float32))
    y = torch.as_tensor(rng.random(M, dtype=np.float32))

    defaults = (native.NATIVE_MIN_SIZE, te.NATIVE_MIN_NNZ, te.NATIVE_MIN_PRODUCT_NNZ)

    def set_thresholds(values):
        native.NATIVE_MIN_SIZE, te.NATIVE_MIN_NNZ, te.NATIVE_MIN_PRODUCT_NNZ = values

    out, ms, calls = {}, {}, {}
    try:
        for route, thresholds, reps in (("host", defaults, HOST_REPS), ("plain", (10**15,) * 3, 1)):
            set_thresholds(thresholds)
            native.reset_calls()
            res, times = {}, {}
            times["coo"], a = host_ms(lambda: st.COO(coords, data, shape=(M, K), device="cpu"), reps)
            res["coo"] = a
            times["a@B"], res["a@B"] = host_ms(lambda: a @ b, reps)
            times["a@x"], res["a@x"] = host_ms(lambda: a @ x, reps)
            times["matvec_add"], res["matvec_add"] = host_ms(lambda: st.matvec_add(a, x, y), reps)
            at = a.T
            times["a+a.T"], res["a+a.T"] = host_ms(lambda: a + at, reps)
            times["a@a"], res["a@a"] = host_ms(lambda: a @ a, reps)
            out[route], ms[route], calls[route] = res, times, dict(native.CALLS)
            del a, at, res
    finally:
        set_thresholds(defaults)

    # the library ran on its route and nowhere else
    want_calls = {
        "coo": "canonicalize2d",
        "a@B": "csr_spmm_dense",
        "matvec_add": "spmv_add",
        "a+a.T": "fused_join_2d",
        "a@a": "spgemm_csr",
    }
    for name, fn in want_calls.items():
        if calls["host"].get(fn, 0) == 0:
            raise AssertionError(f"host_path: {name} never called {fn} on the library route: {calls['host']}")
    if any(calls["plain"].values()):
        raise AssertionError(f"host_path: the plain route called the library: {calls['plain']}")
    # bit for bit where both routes sum in one order
    h, p = out["host"], out["plain"]
    checks = {}
    for name in ("coo", "a+a.T", "a@a"):
        hd, pd = h[name].data, p[name].data
        if not (torch.equal(h[name].coords, p[name].coords) and hd.dtype == pd.dtype == torch.float32):
            raise AssertionError(f"host_path: {name}'s coordinates differ from the plain route's")
        if not torch.equal(hd.view(torch.int32), pd.view(torch.int32)):
            raise AssertionError(f"host_path: {name}'s values differ from the plain route's bits")
        checks[name] = {"bits": "equal", "nnz": h[name].nnz}
    if h["coo"].nnz != BENCH_NNZ:
        raise AssertionError(f"host_path: the canonical COO holds {h['coo'].nnz} entries")
    ref = oracle_csr(rows, cols, data.numpy(), (M, K))
    oracles = {"a@B": ref @ b.numpy().astype(np.float64), "a@x": ref @ x.numpy().astype(np.float64)}
    oracles["matvec_add"] = oracles["a@x"] + y.numpy().astype(np.float64)
    for name, want in oracles.items():
        got = h[name].numpy()
        if not np.isfinite(got).all() or got.shape != want.shape:
            raise AssertionError(f"host_path: {name} of shape {got.shape}, finite={bool(np.isfinite(got).all())}")
        np.testing.assert_allclose(got, p[name].numpy(), **TOL[torch.float32])
        np.testing.assert_allclose(got, want, **ORACLE_TOL)
        checks[name] = {
            "max_abs_diff_vs_plain": float(np.abs(got - p[name].numpy()).max()),
            "max_rel_err_vs_f64": float(np.abs(got - want).max() / np.abs(want).max()),
        }

    # an integer MTTKRP on the card takes the plain version, by dtype, before any launch
    mi = np.random.default_rng(1)
    ci = torch.as_tensor(np.sort(mi.integers(0, 1000, 50_000)), device=dev)
    cj, ck = (torch.as_tensor(mi.integers(0, 200, 50_000), device=dev) for _ in range(2))
    v = torch.as_tensor(mi.integers(1, 100, 50_000).astype(np.int16), device=dev)
    cf, df = (torch.as_tensor(mi.integers(0, 5, (200, 16)).astype(np.int16), device=dev) for _ in range(2))
    reset_launch_counts()
    got = kdot.mttkrp(ci, cj, ck, v, cf, df, n_rows=1000)
    torch.cuda.synchronize()
    if sum(LAUNCHES.values()) or got.dtype != torch.int16:
        raise AssertionError(f"an int16 MTTKRP on the card launched {dict(LAUNCHES)} -> {got.dtype}")
    want = kdot.mttkrp(*(t.cpu() for t in (ci, cj, ck, v, cf, df)), n_rows=1000)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("the int16 MTTKRP on the card differs from the CPU's")
    checks["mttkrp_int16_cuda"] = {"launches": 0, "equal_to_cpu": True}

    return {
        "host_path": "ok",
        "cpu": cpu_model(),
        "threads": threads,
        "gxx": build.get("gxx_version"),
        "build_s": build["build_s"],
        "shape": [M, K],
        "draws": NNZ_DRAWS,
        "n": N,
        "host_ms": ms["host"],
        "plain_ms": ms["plain"],
        "calls": calls["host"],
        "plain_calls": calls["plain"],
        "checks": checks,
        "card": card,
    }


def add_path_launches(lines, path, launches):
    """The one kernel row of ``lines`` that ``PATH_ROWS`` matches for each
    counter gains ``<path>_launches``: that counter's launches on the path
    (the union route's row also its flagged blocks' gather launches)."""
    for counter, matches in PATH_ROWS.items():
        rows = [row for row in lines if matches(row)]
        if len(rows) != 1:
            raise AssertionError(f"{path}: {len(rows)} kernel rows match {counter}'s, not one")
        rows[0][f"{path}_launches"] = launches.get(counter, 0)
        if counter in PATH_ROW_EXTRA:
            other, key = PATH_ROW_EXTRA[counter]
            rows[0][f"{path}_{key}"] = launches.get(other, 0)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    import sparse_tpu_torch  # noqa: F401  (fails here when run outside the repository)
    from sparse_tpu_torch.kernels import _cuda

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi_name_power()
    log(f"device: {kind} count={count} nvidia-smi: {card} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.load_all()
    log(f"build: all sources in {time.perf_counter() - t0:.2f} s")
    for name, info in _cuda.BUILD_INFO.items():
        if "seconds" in info:
            log(f"build {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
            log(info["ptxas"].strip())
        else:
            log(f"build {name}: library already built at {info['path']}")

    # the sparse x dense main path (row-ELL)
    errs = phase_kernels_vs_plain(dev)
    log(json.dumps({"kernel_vs_plain": "ok", "bench_max_abs_err_f32": errs}))
    a, re, b, x, launches = phase_main_path(dev)
    phase_gcxs_path(dev, a, b, x)
    k1_launches = phase_k1(dev, card)
    # the cluster SpMV is no default (PERF.md): its launches are the K1 path's
    launches = {**launches, "row_ell_spmv_cluster": k1_launches["row_ell_spmv_cluster"]}
    lines = phase_times(a, re, b, x, launches, errs, card)
    del re, b, x
    # elementwise operations and reductions at the bench shape
    t0 = time.perf_counter()
    elem = {"bench_shape": phase_elemwise_2d(dev, a)}
    elem_s = time.perf_counter() - t0
    # SDDMM and dense x sparse on the bench matrix
    sd_lines, _ = phase_sddmm_path(dev, a, card)
    lines += sd_lines
    torch.cuda.empty_cache()
    # sparse x sparse (SpGEMM, S1) on the bench matrix and the example's shape
    sg_line, sg_kernel = phase_spgemm_path(dev, a, card)
    log(json.dumps(sg_line))
    lines.append(sg_kernel)
    del sg_line
    torch.cuda.empty_cache()
    # indexing, DOK, npz I/O, creation and the rest of the namespace on the bench matrix
    log(json.dumps(phase_indexing_path(dev, a, card)))
    torch.cuda.empty_cache()
    # sparse attention (Longformer, BigBird, one long head) and GCN propagation
    at_line, at_kernels = phase_attention_path(dev, card)
    log(json.dumps(at_line))
    lines += at_kernels
    del at_line
    torch.cuda.empty_cache()
    # the Krylov solvers (linalg): CG on the DIA shifts and on K1, gmres, tfqmr, eigsh, spsolve
    la_line, la_kernels = phase_linalg_path(dev, card)
    log(json.dumps(la_line))
    lines += la_kernels
    del la_line
    torch.cuda.empty_cache()
    # csgraph: shortest paths on K7, PageRank on K1, components, spanning tree, Floyd-Warshall
    cg_line, cg_kernels = phase_csgraph_path(dev, card)
    log(json.dumps(cg_line))
    lines += cg_kernels
    del cg_line
    torch.cuda.empty_cache()

    # the block-sparse layer (BSR)
    layer, lx, target, wsum = layer_layout(dev)
    bsr_errs, cmp_launches, sddmm_cmp = phase_bsr_kernels_vs_plain(dev, layer, lx, wsum)
    log(json.dumps({"bsr_kernel_vs_plain": "ok", "layer_max_abs_err_f32": bsr_errs, "launches": cmp_launches, "sddmm": sddmm_cmp}))
    training = phase_training(dev, layer, lx, target, wsum)
    breakdown = phase_step_breakdown(layer, lx, wsum)
    log(json.dumps({"training_path": "ok", **training, "step_breakdown_device_ms": breakdown, "card": card}))
    pairs_launches, pairs_err = phase_pairs_path(dev, layer, lx)
    log(json.dumps({"pairs_path": "ok", "launches": pairs_launches, "err_vs_layer_forward": pairs_err}))
    vjp_launches, vjp_errs, vjp_equal = phase_vjp_path(layer, lx, wsum)
    log(json.dumps({"vjp_path": "ok", "launches": vjp_launches, "err_vs_trainable": vjp_errs, "d_blocks_equal": vjp_equal}))
    bsr_launches = {**training["launches"], "bsr_spmm2": pairs_launches["bsr_spmm2"]}
    lines += phase_bsr_times(layer, lx, wsum, bsr_launches, bsr_errs, card)
    del layer, lx, target, wsum
    torch.cuda.empty_cache()

    # the MTTKRP of a 3-D tensor (block-ELL and sorted-COO forms)
    t, c, d, lay, build = mttkrp_problem(dev)
    cmp_errs = phase_mttkrp_vs_plain(t, c, d, lay)
    log(json.dumps({"mttkrp_kernel_vs_plain": "ok", "max_abs_err": cmp_errs}))
    ex = example_problem(dev)
    mt_launches, oracle_errs, want = phase_mttkrp_path(dev, t, c, d, lay, ex)
    log(
        json.dumps(
            {
                "mttkrp_path": "ok",
                "nnz": t.nnz,
                "slots": lay.order.numel(),
                "cap": lay.e_rows.shape[1],
                "launches": mt_launches,
                "err_vs_f64_oracle": oracle_errs,
                "example": {"shape": EX_SHAPE, "r": EX_R, "nnz": ex[0].nnz, "rtol": EX_RTOL},
                **build,
            }
        )
    )
    mt_errs = {"ell_mttkrp": cmp_errs["ell_mttkrp exact torch.float32"], "coo_mttkrp": cmp_errs["coo_mttkrp torch.float32"]}
    lines += phase_mttkrp_times(t, c, d, lay, want, mt_launches, mt_errs, card, build)
    del ex, want
    torch.cuda.empty_cache()
    # the multi-device layer on a mesh of one NCCL rank (MTTKRP, SDDMM, SpMM, ...)
    par_line, par_calls = phase_parallel_path(dev, a, t, c, d, lay, card)
    for call in par_calls:
        log(json.dumps(call))
    log(json.dumps(par_line))
    del a, c, d, lay, par_line, par_calls
    torch.cuda.empty_cache()
    # the partitioned forms on the same world of one (K7, K1, K4 and K5 on each rank's part)
    pt_line, pt_calls = phase_partitioned_path(dev, card)
    for call in pt_calls:
        log(json.dumps(call))
    log(json.dumps(pt_line))
    add_path_launches(lines, "partitioned_path", pt_line["launches"])
    del pt_line, pt_calls
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    elem["mttkrp_tensor"] = phase_elemwise_3d(t)
    del t
    torch.cuda.empty_cache()
    elem["dense_by_nature"] = phase_elemwise_dense_by_nature(dev)
    elem_s += time.perf_counter() - t0
    log(json.dumps({"elemwise_path": "ok", "seconds": elem_s, "ops": elem, "card": card}))
    torch.cuda.empty_cache()

    # the experiments: the one-hot SpMV prototype and the VMEM gather probes
    spmv, runs, ex_launches, ex_seconds = phase_experiments(dev)
    ex_errs = phase_experiments_vs_plain(spmv, runs)
    log(
        json.dumps(
            {
                "experiments": "ok",
                "seconds": ex_seconds,
                "launches": ex_launches,
                "e1_entries": spmv["entries"],
                "e1_padded": spmv["padded"],
                "e1_full_spmv": spmv["runs"],
                "k1_row_ell_spmv": spmv["row_ell_spmv"],
                "probes": {r.label: {"ms": r.ms, "rate": r.rate, "unit": r.unit, "n": r.n} for r in runs.values()},
                "max_abs_err_vs_plain": ex_errs,
                "card": card,
            }
        )
    )
    lines += phase_experiments_times(spmv, runs, ex_launches, ex_errs, card)
    del spmv, runs
    torch.cuda.empty_cache()

    # the host library's call sites on the machine's CPU (no kernel of the card)
    log(json.dumps(phase_host_path(dev, card)))

    log(json.dumps({"kernels": lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
