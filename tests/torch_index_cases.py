"""What the port's indexing and namespace tests share (no JAX import, so the
card's tests use it too): tests/test_coo.py's slicing table and
advanced-index list, more cases of the general path, the 2-D axis
selections of GCXS's fast path, and inputs that mix ties, ±0.0 and NaN."""

import numpy as np


def tricky(seed, shape, dtype, fill=None, density=0.6):
    """Values with ties, ±0.0 and NaN (floats), at ``density``, the rest
    ``fill`` (default zero)."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    n = int(np.prod(shape))
    if dt.kind == "f":
        v = rng.choice(np.array([-2.0, -0.0, 0.0, 0.5, 1.0, 3.0, np.nan, np.inf, -np.inf]), n)
    elif dt.kind == "b":
        v = rng.random(n) < 0.5
    elif dt.kind == "u":
        v = rng.integers(0, 5, n)
    else:
        v = rng.integers(-3, 4, n)
    x = v.astype(dt).reshape(shape)
    x[rng.random(shape) >= density] = np.zeros((), dt) if fill is None else fill
    return x

# tests/test_coo.py:188-214
SLICE_TABLE = [
    0,
    1,
    -1,
    (1, 2),
    (1, 2, 3),
    (1, -2, 3),
    (slice(0, 2),),
    (slice(None),),
    (slice(None), slice(None), slice(None)),
    (slice(1, 4), slice(0, 5, 2)),
    (slice(None, None, -1),),
    (slice(4, 1, -1), 2),
    (slice(None), slice(None, None, 2)),
    (0, slice(1, 4)),
    (slice(1, 2), slice(None), -1),
    (Ellipsis,),
    (0, Ellipsis),
    (Ellipsis, 1),
    (slice(1, 3), Ellipsis),
    (None, 1),
    (1, None, 2),
    (slice(1, 3), None),
    (None,),
    (slice(None, None, 3),),
    (slice(5, 1, -2),),
    (slice(None), 2, slice(None, None, -2)),
]

# tests/test_coo.py:224-237
ADVANCED = [
    ([0, 2],),
    ([0, 0, 1],),
    (slice(None), [1, 2]),
    (1, [0, 2]),
    ([2, 0], slice(None), 3),
    (np.array([1, 3]),),
    ([True, False, True, False],),
    (slice(None), np.array([0, 2, 4]), slice(None)),
    ([0, 1], [0, 1]),
    (slice(None), [0, 1], [0, 1]),
]

# more of the general path: reversed and stepped slices with picks, picks
# apart (the advanced axis in front), repeats, nothing matched, empty lists,
# boolean masks, negative picks, Ellipsis and newaxis with picks
MORE = [
    (slice(None, None, -1), [3, 0, 3]),
    ([1, 3], slice(None, None, -2), [0, 5]),
    ([2, 2], 1, [5, 0]),
    (0, slice(None), [4, 4, 1]),
    ([], slice(None)),
    (slice(None), []),
    (np.array([], dtype=np.int64), 2),
    ([-1, -4], slice(2, None)),
    (Ellipsis, [0, 5, 2]),
    (None, [1, 0], None, slice(1, 3)),
    (np.array([True, False, True, True]), 1, slice(None, None, 2)),
    ([3, 0], [4, 1], [5, 2]),
    (slice(4, 1, -1), [0, 2], slice(1, 5, 3)),
    (slice(2, 2), 1),
    (slice(3, 1), [0]),
    (1, 2, Ellipsis),
    (1, 2, 3, Ellipsis),
]

# one axis of a 7 x 7 CSR or CSC: every kind _getitem_fast takes, and some it leaves to the COO
AXIS_SELS = [
    2,
    -1,
    slice(None),
    slice(1, 5),
    slice(-4, -1),
    slice(5, 2),
    [4, 0, 4, 2],
    np.array([1, 3, 6]),
    [],
    np.array([True, False, True, False, True, True, False]),
    slice(None, None, 2),
    [3, 1],
]
