from .dot import dot, matmul, matvec_add
from .elemwise import broadcast_to, elemwise

__all__ = ["broadcast_to", "dot", "elemwise", "matmul", "matvec_add"]
