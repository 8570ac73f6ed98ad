"""tpucg_torch's MatrixMarket I/O (a NumPy copy of ``tpucg.io.mmio``) against
tpucg's on the same files: coordinate general, symmetric and pattern files
and array files, written by hand and by tpucg's writer, round trips through
both writers, and the row-range index and loader."""

import numpy as np
import pytest

import tpucg.io.mmio as jmmio
import tpucg.sparse.formats as jfmt
from tpucg_torch.io.generator import random_geometric_spd
from tpucg_torch.io.mmio import (
    build_mm_index,
    expand_matrix_market,
    load_matrix_market,
    load_matrix_market_rows,
    save_matrix_market,
)
from tpucg_torch.sparse.formats import COOMatrix

HAND = {
    "general": ["%%MatrixMarket matrix coordinate real general", "% a comment", "3 3 4",
                "1 1 2.0", "2 2 3.0", "3 3 4.0", "1 3 -1.5"],
    "symmetric": ["%%MatrixMarket matrix coordinate real symmetric", "2 2 3", "1 1 2",
                  "2 1 -1", "2 2 2"],
    "pattern": ["%%MatrixMarket matrix coordinate pattern general", "2 2 2", "1 1", "2 2"],
    "integer": ["%%MatrixMarket matrix coordinate integer symmetric", "3 3 3", "1 1 4",
                "3 1 -2", "3 3 7"],
    "fortran": ["%%MatrixMarket matrix coordinate real general", "2 2 2", "1 1 1.5D+01",
                "2 2 -2.5d-1"],
    "array": ["%%MatrixMarket matrix array real general", "2 3", "1", "2", "3", "4", "5", "6"],
    "array_symmetric": ["%%MatrixMarket matrix array real symmetric", "3 3", "1", "2", "3",
                        "4", "5", "6"],
    "blank_lines": ["%%MatrixMarket matrix coordinate real general", "", "2 2 2", "",
                    "1 2 1.0", "% inner comment", "2 1 1.0"],
}


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        return
    assert type(got).__name__ == "COOMatrix" and got.shape == want.shape
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


@pytest.mark.parametrize("case", sorted(HAND))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_load_equals_tpucgs(tmp_path, case, dtype):
    path = tmp_path / f"{case}.mtx"
    path.write_text("\n".join(HAND[case]) + "\n")
    _same(load_matrix_market(str(path), dtype=dtype), jmmio.load_matrix_market(str(path),
                                                                                 dtype=dtype))


@pytest.mark.parametrize("header,msg", [
    ("%%MatrixMarket matrix coordinate complex general", "field"),
    ("%%MatrixMarket matrix coordinate real hermitian", "symmetry"),
    ("%%MatrixMarket matrix coordinate real skew-symmetric", "symmetry"),
    ("%%MatrixMarket vector coordinate real general", "object"),
    ("%%MatrixMarket matrix array pattern general", "pattern"),
    ("not a header at all", "not a MatrixMarket"),
])
def test_rejects_what_tpucg_rejects(tmp_path, header, msg):
    path = tmp_path / "bad.mtx"
    path.write_text(header + "\n2 2 1\n1 1 1\n")
    with pytest.raises(ValueError, match=msg):
        load_matrix_market(str(path))
    with pytest.raises(ValueError, match=msg):
        jmmio.load_matrix_market(str(path))


def test_rejects_bad_counts_and_indices(tmp_path):
    for body, msg in (("2 2 3\n1 1 1\n2 2 1\n", "expected 3 entries"),
                      ("2 2 1\n3 1 1\n", "out of range"),
                      ("2 2 1\n1 1 x\n", "unparsable")):
        path = tmp_path / "bad.mtx"
        path.write_text("%%MatrixMarket matrix coordinate real general\n" + body)
        with pytest.raises(ValueError, match=msg):
            load_matrix_market(str(path))


def _geometric():
    A, b, _ = random_geometric_spd(400, seed=3, avg_degree=6.0)
    return A, b


@pytest.mark.parametrize("symmetric", [False, True])
def test_round_trip_through_both_writers(tmp_path, symmetric):
    A, b = _geometric()
    ours, theirs = tmp_path / "ours.mtx", tmp_path / "theirs.mtx"
    save_matrix_market(str(ours), A, symmetric=symmetric, comment="geometric n=400")
    coo = A.to_coo()
    jcoo = jfmt.COOMatrix(row=coo.row, col=coo.col, data=coo.data, shape=coo.shape)
    jmmio.save_matrix_market(str(theirs), jcoo, symmetric=symmetric, comment="geometric n=400")
    assert ours.read_text() == theirs.read_text()
    back = load_matrix_market(str(ours))
    _same(back, jmmio.load_matrix_market(str(ours)))
    np.testing.assert_array_equal(back.to_csr().to_dense(), A.to_dense())


@pytest.mark.parametrize("symmetric", [False, True])
def test_dense_and_vector_files(tmp_path, symmetric):
    rng = np.random.default_rng(0)
    M = rng.standard_normal((5, 5)).astype(np.float32)
    M = M + M.T if symmetric else M
    for arr in (M, rng.standard_normal(7).astype(np.float32)):
        sym = symmetric and arr.ndim == 2
        ours, theirs = tmp_path / "o.mtx", tmp_path / "t.mtx"
        save_matrix_market(str(ours), arr, symmetric=sym)
        jmmio.save_matrix_market(str(theirs), arr, symmetric=sym)
        assert ours.read_text() == theirs.read_text()
        _same(load_matrix_market(str(ours)), jmmio.load_matrix_market(str(ours)))


def test_row_index_and_row_loader_equal_tpucgs(tmp_path):
    A, _ = _geometric()
    sym, ours, theirs = tmp_path / "s.mtx", tmp_path / "o.mtx", tmp_path / "t.mtx"
    save_matrix_market(str(sym), A, symmetric=True)
    idx = expand_matrix_market(str(sym), str(ours))
    jidx = jmmio.expand_matrix_market(str(sym), str(theirs))
    assert ours.read_text() == theirs.read_text()
    with np.load(idx) as z, np.load(jidx) as jz:
        for key in jz.files:
            np.testing.assert_array_equal(z[key], jz[key])
    assert build_mm_index(str(ours)) == idx
    for r0, r1 in ((0, 400), (0, 1), (123, 321), (399, 400), (50, 50)):
        coo, shape, nbytes = load_matrix_market_rows(str(ours), r0, r1)
        jcoo, jshape, jnbytes = jmmio.load_matrix_market_rows(str(ours), r0, r1)
        _same(coo, jcoo)
        assert (shape, nbytes) == (jshape, jnbytes)
    with pytest.raises(ValueError, match="symmetric"):
        build_mm_index(str(sym))
    with pytest.raises(FileNotFoundError, match="build_mm_index"):
        load_matrix_market_rows(str(sym), 0, 1)


def test_unsorted_file_refuses_an_index(tmp_path):
    path = tmp_path / "u.mtx"
    save_matrix_market(str(path), COOMatrix(row=np.array([1, 0]), col=np.array([0, 1]),
                                            data=np.ones(2, np.float32), shape=(2, 2)))
    with pytest.raises(ValueError, match="row-sorted"):
        build_mm_index(str(path))
