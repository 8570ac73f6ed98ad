"""Sparse containers on the host (a NumPy copy of ``tpucg.sparse.formats``'s
COO, CSR and DIA parts; BSR and ELL come with slice D).

COO and CSR are the interchange formats. DIA (``DIAMatrix``) is the device
format of banded matrices: ``DiaOperator`` places its (ndiag, n) slab on the
card, where the DIA SpMV is a shift-and-add over dense rows, no gather.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate format: (row, col, val) triples."""

    row: np.ndarray
    col: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def to_csr(self) -> "CSRMatrix":
        order = np.lexsort((self.col, self.row))
        row, col, data = self.row[order], self.col[order], self.data[order]
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, row + 1, 1)
        return CSRMatrix(
            indptr=np.cumsum(indptr),
            indices=col.astype(np.int32),
            data=data,
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        A = np.zeros(self.shape, dtype=self.data.dtype)
        np.add.at(A, (self.row, self.col), self.data)
        return A


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse rows: indptr (n+1), indices (nnz), data (nnz)."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_coo(self) -> COOMatrix:
        row = np.repeat(np.arange(self.shape[0], dtype=np.int64), self.row_lengths)
        return COOMatrix(row=row, col=self.indices.astype(np.int64),
                         data=self.data, shape=self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference SpMV (oracle for kernel tests)."""
        prod = self.data * x[self.indices]
        out = np.zeros(self.shape[0], dtype=np.result_type(self.data, x))
        np.add.at(out, np.repeat(np.arange(self.shape[0]), self.row_lengths), prod)
        return out


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal (DIA) storage of a banded matrix.

    ``offsets`` (ndiag,) sorted diagonal offsets (0 = main, +k super, -k
    sub); ``data`` (ndiag, n) with ``data[d, i] = A[i, i + offsets[d]]``
    (entries whose column falls outside [0, n) are 0).
    """

    offsets: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def ndiag(self) -> int:
        return int(self.offsets.size)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.data))

    def to_dense(self) -> np.ndarray:
        n = self.shape[0]
        A = np.zeros(self.shape, dtype=self.data.dtype)
        idx = np.arange(n)
        for d, off in enumerate(self.offsets):
            cols = idx + off
            valid = (cols >= 0) & (cols < self.shape[1])
            A[idx[valid], cols[valid]] += self.data[d, valid]
        return A

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference SpMV (oracle for kernel tests)."""
        n = self.shape[0]
        y = np.zeros(n, np.result_type(self.data, x))
        idx = np.arange(n)
        for d, off in enumerate(self.offsets):
            cols = idx + off
            valid = (cols >= 0) & (cols < n)
            y[idx[valid]] += self.data[d, valid] * x[cols[valid]]
        return y


def csr_to_dia(csr: CSRMatrix, max_diags: int = 256) -> DIAMatrix:
    """Convert CSR to DIA. Refuses matrices with more than ``max_diags``
    distinct diagonals (DIA pays off only for banded structure)."""
    coo = csr.to_coo()
    offs = coo.col - coo.row
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        raise ValueError(
            f"matrix has {uniq.size} distinct diagonals (> {max_diags}); "
            "DIA is for banded matrices — use ELL/BSR instead"
        )
    n = csr.shape[0]
    data = np.zeros((uniq.size, n), dtype=csr.data.dtype)
    dpos = np.searchsorted(uniq, offs)
    # Fancy assignment is valid only when (row, col) pairs are unique; CSR
    # permits duplicates, so a bincount over the (diagonal, row) keys finds
    # them and the summing scatter takes over when any key repeats.
    key = dpos.astype(np.int64) * n + coo.row
    counts = np.bincount(key, minlength=uniq.size * n)
    if counts.size and counts.max() > 1:
        np.add.at(data, (dpos, coo.row), coo.data)
    else:
        data[dpos, coo.row] = coo.data
    return DIAMatrix(offsets=uniq.astype(np.int64), data=data, shape=csr.shape)
