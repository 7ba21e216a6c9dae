"""Public testing helpers (oracle asserts) for suites that test code built on
``sparse_tpu_torch``: ``from sparse_tpu_torch.testing import assert_eq``."""

from ._utils import assert_eq, assert_nnz, is_canonical, random_value_array  # noqa: F401
