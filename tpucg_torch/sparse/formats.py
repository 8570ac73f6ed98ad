"""Sparse containers on the host (a NumPy copy of ``tpucg.sparse.formats``).

COO and CSR are the interchange formats. DIA (``DIAMatrix``) is the device
format of banded matrices: ``DiaOperator`` places its (ndiag, n) slab on the
card, where the DIA SpMV is a shift-and-add over dense rows, no gather. BSR
(``BSRMatrix``, dense bs x bs blocks) and ELLPACK (``EllMatrix``, rows padded
to one width) are the device forms of blocky and of general sparse matrices
(``BsrOperator``, ``EllOperator``); irregular matrices go to WELL
(``tpucg_torch.sparse.well``).
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
class EllMatrix:
    """ELLPACK: rows padded to equal length L.

    values (n, L) float; indices (n, L) int32, padded entries point at column
    0 with value 0, so the gather stays in bounds and adds nothing. SpMV is
    ``(values * x[indices]).sum(axis=1)``.
    """

    values: np.ndarray
    indices: np.ndarray
    shape: Tuple[int, int]

    @property
    def row_width(self) -> int:
        return int(self.values.shape[1])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.values))


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


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block sparse rows: dense (bs x bs) blocks on a block-CSR skeleton.

    ``indptr`` (n_block_rows + 1), ``indices`` (nnzb) block-column ids,
    ``data`` (nnzb, bs, bs). The shape is the logical (rows, cols); rows and
    cols must be multiples of bs.
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def blocksize(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnzb(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.data))

    @property
    def block_row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_dense(self) -> np.ndarray:
        bs = self.blocksize
        A = np.zeros(self.shape, dtype=self.data.dtype)
        for br in range(self.shape[0] // bs):
            for k in range(self.indptr[br], self.indptr[br + 1]):
                bc = self.indices[k]
                A[br * bs:(br + 1) * bs, bc * bs:(bc + 1) * bs] += self.data[k]
        return A

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference block SpMV (oracle for kernel tests)."""
        bs = self.blocksize
        xb = x.reshape(-1, bs)
        yb = np.zeros((self.shape[0] // bs, bs), np.result_type(self.data, x))
        for br in range(yb.shape[0]):
            for k in range(self.indptr[br], self.indptr[br + 1]):
                yb[br] += self.data[k] @ xb[self.indices[k]]
        return yb.reshape(-1)


def csr_to_bsr(csr: CSRMatrix, blocksize: int) -> BSRMatrix:
    """Re-block a CSR matrix into (bs x bs) dense blocks (zero-filled).

    Square shapes that bs does not divide are padded to the next multiple of
    bs with an identity tail (unit diagonal on the pad rows, so SPD systems
    stay SPD and the pad coordinates are inert); the returned shape is the
    padded one. Non-square shapes that bs does not divide raise.
    """
    n_rows, n_cols = csr.shape
    bs = blocksize
    if n_rows % bs or n_cols % bs:
        if n_rows != n_cols:
            raise ValueError(
                f"shape {csr.shape} not divisible by blocksize {bs} and not "
                "square (identity-tail padding needs square)"
            )
        npad = -(-n_rows // bs) * bs
        coo0 = csr.to_coo()
        tail = np.arange(n_rows, npad, dtype=coo0.row.dtype)
        csr = COOMatrix(
            row=np.concatenate([coo0.row, tail]),
            col=np.concatenate([coo0.col.astype(coo0.row.dtype), tail]),
            data=np.concatenate([coo0.data, np.ones(tail.size, coo0.data.dtype)]),
            shape=(npad, npad),
        ).to_csr()
        n_rows = n_cols = npad
    coo = csr.to_coo()
    brow = coo.row // bs
    bcol = coo.col // bs
    # Unique (brow, bcol) pairs in block-CSR order.
    key = brow * (n_cols // bs) + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inverse_s = np.unique(key_s, return_inverse=True)
    data = np.zeros((uniq.size, bs, bs), dtype=coo.data.dtype)
    r_in = (coo.row[order] % bs).astype(np.int64)
    c_in = (coo.col[order] % bs).astype(np.int64)
    np.add.at(data, (inverse_s, r_in, c_in), coo.data[order])
    u_brow = (uniq // (n_cols // bs)).astype(np.int64)
    u_bcol = (uniq % (n_cols // bs)).astype(np.int32)
    indptr = np.zeros(n_rows // bs + 1, dtype=np.int64)
    np.add.at(indptr, u_brow + 1, 1)
    return BSRMatrix(indptr=np.cumsum(indptr), indices=u_bcol, data=data, shape=csr.shape)


def csr_diagonal_blocks(csr: CSRMatrix, bs: int, npad: int = None, shards: int = 1) -> np.ndarray:
    """The (nb, bs, bs) diagonal blocks of a CSR matrix: the block-Jacobi
    set-up of formats whose entries only the host can address (WELL).

    The block grid restarts at every shard boundary (``npad/shards`` rows a
    shard), so no block crosses a shard. Rows past ``csr.shape[0]`` (the
    identity tail) and a shard's grid tail (when bs does not divide its rows)
    get identity rows: padded coordinates pass through unchanged.
    """
    n = csr.shape[0]
    if npad is None:
        npad = n
    rps = npad // shards
    if rps * shards != npad:
        raise ValueError(f"shards={shards} must divide npad={npad}")
    nbl = -(-rps // bs)
    blocks = np.zeros((shards * nbl, bs, bs), np.float32)
    coo = csr.to_coo()
    r, c, v = coo.row, coo.col, coo.data.astype(np.float32)
    lr, lc = r % rps, c % rps
    keep = ((r // rps) == (c // rps)) & ((lr // bs) == (lc // bs))
    bid = (r[keep] // rps) * nbl + (lr[keep] // bs)
    np.add.at(blocks, (bid, lr[keep] % bs, lc[keep] % bs), v[keep])
    # Identity diagonals for pad rows (global index >= n) and grid-tail rows
    # (local index >= rps): neither carries off-diagonal entries.
    bid_all = np.arange(shards * nbl)
    local = (bid_all % nbl)[:, None] * bs + np.arange(bs)[None, :]
    g = (bid_all // nbl)[:, None] * rps + local
    ident = (g >= n) | (local >= rps)
    di = np.arange(bs)
    blocks[:, di, di] = np.where(ident, 1.0, blocks[:, di, di])
    return blocks


def csr_to_ell(csr: CSRMatrix, width_align: int = 1) -> EllMatrix:
    """Convert CSR to ELLPACK, padding the row width to a multiple of
    ``width_align``."""
    n = csr.shape[0]
    lengths = csr.row_lengths
    L = int(lengths.max()) if n else 0
    L = max(1, ((L + width_align - 1) // width_align) * width_align)
    values = np.zeros((n, L), dtype=csr.data.dtype)
    indices = np.zeros((n, L), dtype=np.int32)
    # Position of each entry within its row.
    within = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1], lengths)
    rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
    values[rows, within] = csr.data
    indices[rows, within] = csr.indices
    return EllMatrix(values=values, indices=indices, shape=csr.shape)
