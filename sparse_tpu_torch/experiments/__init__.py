"""Counterparts of the repository's Pallas experiments (``experiments/``).

Each module bears the name of the experiment it ports and holds, for each
Pallas function there, a function on tensors that launches its CUDA kernel
(``kernels/csrc/probes.cu``) for CUDA tensors and runs its plain PyTorch
version for CPU tensors, and a runner that draws the experiment's inputs
with its seeds, at its sizes, and times the kernel on the card:

- ``pallas_spmv_onehot``: the one-hot SpMV prototype (E1) and its full SpMV
  at the benchmark shape through the port's row-ELL layout;
- ``pallas_vmem``: the gather probes p1-p4 (E3-E6);
- ``pallas_vmem2``: the gather probes g1-g3 (E7-E9).

``common`` holds the timer and the runners' result type. ``sparse_tpu_torch``
does not import this package.
"""
