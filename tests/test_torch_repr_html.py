"""``_repr_html_`` of the port's arrays against ``sparse_tpu``'s, cell by cell.

COO, GCXS, CSR, CSC and DOK of the same values give the same table: the
format, shape, nnz, density, read-only flag, size, storage ratio and
compressed axes; the "Data Type" cell holds the port's torch dtype
(ROADMAP §C2).
"""

import re

import numpy as np
import pytest
import torch

import sparse_tpu as jsp
import sparse_tpu_torch as st
from sparse_tpu_torch._utils import human_readable_size, numpy_dtype

CPU = "cpu"
ROW = '<tr><th style="text-align: left">{}</th><td style="text-align: left">{}</td></tr>'
CELL = re.compile(re.escape(ROW).replace(r"\{\}", "(.*?)"))


def _cells(html):
    assert html.startswith("<table><tbody>") and html.endswith("</tbody></table>")
    cells = CELL.findall(html)
    rows = "".join(ROW.format(h, v) for h, v in cells)
    assert rows == html[len("<table><tbody>") : -len("</tbody></table>")]
    return cells


def _dense(shape, density, seed, dtype):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 9, shape) * (rng.random(shape) < density)).astype(dtype)


MAKERS = {
    "coo": lambda m, x, dev: m.COO.from_numpy(x, **dev),
    "gcxs": lambda m, x, dev: m.GCXS.from_numpy(x, compressed_axes=(1,), **dev),
    "gcxs3d": lambda m, x, dev: m.GCXS.from_numpy(x.reshape(2, -1, x.shape[-1]), compressed_axes=(0, 2), **dev),
    "csr": lambda m, x, dev: m.COO.from_numpy(x, **dev).asformat("csr"),
    "csc": lambda m, x, dev: m.COO.from_numpy(x, **dev).asformat("csc"),
    "dok": lambda m, x, dev: m.COO.from_numpy(x, **dev).asformat("dok"),
}


@pytest.mark.parametrize("fmt", sorted(MAKERS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16, np.uint8, np.bool_])
@pytest.mark.parametrize("shape,density", [((6, 8), 0.3), ((40, 30), 0.05), ((4, 6), 0.0), ((64, 64), 0.9)])
def test_repr_html_matches_sparse_tpu_cell_by_cell(fmt, dtype, shape, density):
    x = _dense(shape, density, 3, dtype)
    t = MAKERS[fmt](st, x, {"device": CPU})
    j = MAKERS[fmt](jsp, x, {})
    got, want = _cells(t._repr_html_()), _cells(j._repr_html_())
    assert [h for h, _ in got] == [h for h, _ in want]
    for (h, g), (_, w) in zip(got, want):
        if h == "Data Type":
            assert g == str(t.dtype) and numpy_dtype(t.dtype) == np.dtype(w)
        else:
            assert g == w, (h, g, w)


def test_repr_html_headings_by_format():
    x = _dense((6, 8), 0.3, 4, np.float64)
    for fmt, extra in (("coo", []), ("csr", []), ("csc", []), ("dok", []), ("gcxs", ["Compressed Axes"])):
        cells = _cells(MAKERS[fmt](st, x, {"device": CPU})._repr_html_())
        headings = ["Format", "Data Type", "Shape", "nnz", "Density", "Read-only", "Size", "Storage ratio"]
        assert [h for h, _ in cells] == headings + extra
        assert dict(cells)["Format"] == fmt
        assert dict(cells)["Read-only"] == str(fmt != "dok")
        assert dict(cells)["Data Type"] == "torch.float64"


@pytest.mark.parametrize("size", [0, 1, 1023, 1024, 1536, 2**20 - 1, 2**20, 5 * 2**30 + 7, 2**40, 3 * 2**41])
def test_human_readable_size_matches_sparse_tpu(size):
    from sparse_tpu._utils import human_readable_size as want

    assert human_readable_size(size) == want(size)


def test_repr_html_of_an_array_on_its_device_reads_no_values():
    # the table needs only shapes and counts: a tensor-built COO's table
    # equals the NumPy-built one's
    x = _dense((10, 7), 0.4, 5, np.float32)
    a = st.COO.from_numpy(torch.as_tensor(x))
    assert a._repr_html_() == st.COO.from_numpy(x, device=CPU)._repr_html_()
