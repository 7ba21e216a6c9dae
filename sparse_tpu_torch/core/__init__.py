from .base import SparseArray
from .coo import COO
from .gcxs import CSC, CSR, GCXS

__all__ = ["COO", "CSC", "CSR", "GCXS", "SparseArray"]
