"""sparse_tpu_torch — the port of ``sparse_tpu`` to PyTorch and CUDA.

N-dimensional sparse arrays on torch tensors, with the semantics of
``sparse_tpu`` (the reference, which stays beside this package unchanged).
Arrays live on the GPU unless ``device="cpu"`` is asked for; the hot
products run in hand-written CUDA kernels (``kernels``). This package never
imports ``jax`` or ``sparse_tpu``.

It holds the sparse × dense main path (a canonical 2-D ``COO``, ``a @ b`` /
``matmul`` / ``dot`` on the cached row-ELL layout, the fused ``matvec_add``),
the compressed formats ``GCXS``, ``CSR`` and ``CSC`` (built, converted and
restructured on the device; their products on the same path),
the block-sparse linear layer of ``nn`` (BSR forward, dgrad and wgrad
kernels), and the MTTKRP of a 3-D tensor (``jitops.mttkrp`` on a ``COO``,
``kernels.mttkrp`` and the block-ELL ``kernels.ell_mttkrp``, one CUDA
kernel).
"""

from . import jitops, kernels, nn
from .core.base import SparseArray
from .core.coo import COO
from .core.gcxs import CSC, CSR, GCXS
from .ops.dot import dot, matmul, matvec_add

__all__ = ["COO", "CSC", "CSR", "GCXS", "SparseArray", "dot", "jitops", "kernels", "matmul", "matvec_add", "nn"]
