"""Test systems (a NumPy copy of ``tpucg.io.generator``'s dense generators
and its 3-D Poisson Laplacian; the other sparse ones come with their slices).

A = 0.5*(R + R^T) + n*I for uniform random R, as in the reference's
``generateSPDmatrix.m``: symmetric and strictly diagonally dominant, hence
SPD and well-conditioned (CG converges in a handful of laps).

``poisson3d_csr`` and ``poisson3d_dia`` build the 7-point Dirichlet
Laplacian on an m^3 grid (n = m^3, flat index x*m^2 + y*m + z), the sparse
workload of ``BASELINE.json``; ``PoissonOperator`` applies the same operator
as a stencil.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpucg_torch.sparse.formats import CSRMatrix, DIAMatrix


def generate_spd_system(
    n: int,
    seed: int = 0,
    dtype=np.float32,
    x0: str = "zeros",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random dense SPD system (A, b, x0); the same arrays as tpucg's for the
    same seed. x0 is zeros or ``"random"``."""
    rng = np.random.default_rng(seed)
    R = rng.random((n, n), dtype=np.float64)
    A = 0.5 * (R + R.T) + n * np.eye(n)
    b = rng.random(n, dtype=np.float64)
    if x0 == "zeros":
        x = np.zeros(n, dtype=dtype)
    elif x0 == "random":
        x = rng.random(n).astype(dtype)
    else:
        raise ValueError(f"unknown x0 mode {x0!r}")
    return A.astype(dtype), b.astype(dtype), x


def generate_spd_system_f32(
    n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Memory-lean float32 variant for large n: the same construction in
    float32 with in-place updates (peak host memory 2 * n^2 * 4 bytes). Draws
    a different random stream than ``generate_spd_system``."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n), dtype=np.float32)
    A = A + A.T
    A *= np.float32(0.5)
    idx = np.arange(n)
    A[idx, idx] += np.float32(n)
    b = rng.random(n, dtype=np.float32)
    return A, b, np.zeros(n, np.float32)


def _poisson3d_deltas_masks(m: int):
    """The 7-point stencil's column deltas (ascending) and per-row validity
    masks, shared by the CSR and DIA constructors."""
    n = m * m * m
    idx = np.arange(n, dtype=np.int64)
    ix, rem = np.divmod(idx, m * m)
    iy, iz = np.divmod(rem, m)
    deltas = (-m * m, -m, -1, 0, 1, m, m * m)
    masks = (
        ix > 0, iy > 0, iz > 0, np.ones(n, dtype=bool),
        iz < m - 1, iy < m - 1, ix < m - 1,
    )
    return n, idx, deltas, masks


def poisson3d_csr(m: int, dtype=np.float32) -> CSRMatrix:
    """7-point Laplacian on an m*m*m grid with Dirichlet boundaries, as CSR:
    row i has 6 on the diagonal and -1 for each in-grid neighbour. Built
    vectorised and already in CSR order (the 7 candidate columns of a row
    are in ascending-delta order)."""
    n, idx, deltas, masks = _poisson3d_deltas_masks(m)
    mask2 = np.stack(masks, axis=1)                      # (n, 7)
    cols2 = idx[:, None] + np.asarray(deltas)            # (n, 7)
    vals_row = np.asarray([-1, -1, -1, 6, -1, -1, -1], dtype=dtype)
    keep = mask2.reshape(-1)
    cols = cols2.reshape(-1)[keep]
    vals = np.broadcast_to(vals_row, (n, 7)).reshape(-1)[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mask2.sum(axis=1), out=indptr[1:])
    return CSRMatrix(indptr=indptr, indices=cols.astype(np.int32), data=vals, shape=(n, n))


def poisson3d_dia(m: int, dtype=np.float32) -> DIAMatrix:
    """7-point Laplacian directly in DIA form, in O(n): ``data[d, i] = A[i,
    i + offsets[d]]`` with out-of-grid neighbours zero, the analytic form of
    ``csr_to_dia(poisson3d_csr(m))`` (m = 128 never builds the 14.6M-entry
    CSR)."""
    n, idx, deltas, masks = _poisson3d_deltas_masks(m)
    data = np.zeros((7, n), dtype=dtype)
    for d, (delta, mask) in enumerate(zip(deltas, masks)):
        data[d, mask] = -1.0 if delta != 0 else 6.0
    return DIAMatrix(offsets=np.asarray(deltas, dtype=np.int64), data=data, shape=(n, n))
