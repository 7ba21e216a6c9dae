from .base import SparseArray
from .coo import COO

__all__ = ["COO", "SparseArray"]
