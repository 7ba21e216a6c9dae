from .dot import dot, matmul, matvec_add

__all__ = ["dot", "matmul", "matvec_add"]
