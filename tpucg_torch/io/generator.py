"""Test systems (a NumPy copy of ``tpucg.io.generator``).

A = 0.5*(R + R^T) + n*I for uniform random R, as in the reference's
``generateSPDmatrix.m``: symmetric and strictly diagonally dominant, hence
SPD and well-conditioned (CG converges in a handful of laps).

``poisson3d_csr`` and ``poisson3d_dia`` build the 7-point Dirichlet
Laplacian on an m^3 grid (n = m^3, flat index x*m^2 + y*m + z), the sparse
workload of ``BASELINE.json``; ``PoissonOperator`` applies the same operator
as a stencil. The irregular systems are tpucg's: the graph Laplacian of a
random geometric graph (``random_geometric_spd``), the P1 finite-element
stiffness matrix on a random Delaunay mesh (``fem_p1_system``, which needs
scipy), its anisotropic variant and the structured anisotropic grid.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpucg_torch.sparse.formats import COOMatrix, CSRMatrix, DIAMatrix


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


def random_geometric_graph_csr(
    n: int,
    seed: int = 0,
    dim: int = 2,
    avg_degree: float = 10.0,
    shuffle: bool = False,
    dtype=np.float32,
) -> CSRMatrix:
    """Random geometric graph adjacency (symmetric, zero diagonal).

    n points uniform in the unit square/cube, edges between pairs closer than
    the radius giving ~``avg_degree`` expected neighbors. This is the
    unstructured-mesh analog of the reference's random SPD generator:
    genuinely irregular row lengths and column patterns, no constant band,
    no block structure. Vertices are labeled in spatial-cell order (the
    locality a real mesh numbering has); ``shuffle=True`` destroys that for
    ordering experiments (``tpucg_torch.sparse.ordering.rcm_order``).
    """
    rng = np.random.default_rng(seed)
    pts = rng.random((n, dim))
    if dim == 2:
        r = float(np.sqrt(avg_degree / (np.pi * n)))
    elif dim == 3:
        r = float((avg_degree / (4.0 / 3.0 * np.pi * n)) ** (1.0 / 3.0))
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    ncell = max(1, int(np.floor(1.0 / r)))
    cell = np.minimum((pts * ncell).astype(np.int64), ncell - 1)
    # Row-major cell id; sorting by it gives the locality labeling.
    cid = cell[:, 0]
    for d in range(1, dim):
        cid = cid * ncell + cell[:, d]
    order = np.argsort(cid, kind="stable")
    pts = pts[order]
    cid = cid[order]
    ncells_total = ncell ** dim
    starts = np.searchsorted(cid, np.arange(ncells_total + 1))

    # Forward half of the neighbor-cell offsets (plus self) — each unordered
    # pair is generated once, then symmetrized.
    if dim == 2:
        offsets = [(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]
    else:
        offsets = [(0, 0, 0)]
        for dx in (0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if (dx, dy, dz) > (0, 0, 0):
                        offsets.append((dx, dy, dz))
    rows_l, cols_l = [], []
    idx_all = np.arange(n, dtype=np.int64)
    for off in offsets:
        ncid = cid.copy()
        ok = np.ones(n, dtype=bool)
        for d, o in enumerate(off):
            if o:
                c_d = cell[order][:, d] + o
                ok &= (c_d >= 0) & (c_d < ncell)
                ncid = ncid + o * (ncell ** (dim - 1 - d))
        src = idx_all[ok]
        ncid_ok = ncid[ok]
        cnt = starts[ncid_ok + 1] - starts[ncid_ok]
        total = int(cnt.sum())
        if total == 0:
            continue
        rows = np.repeat(src, cnt)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt
        )
        cols = np.repeat(starts[ncid_ok], cnt) + within
        d2 = np.sum((pts[rows] - pts[cols]) ** 2, axis=1)
        keep = d2 <= r * r
        if off == offsets[0]:
            keep &= cols > rows  # self cell: dedupe + drop the diagonal
        rows_l.append(rows[keep])
        cols_l.append(cols[keep])
    rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.empty(0, np.int64)
    # Symmetrize.
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    if shuffle:
        relabel = rng.permutation(n)
        rows, cols = relabel[rows], relabel[cols]
    vals = np.ones(rows.size, dtype=dtype)
    return COOMatrix(row=rows, col=cols, data=vals, shape=(n, n)).to_csr()


def random_geometric_spd(
    n: int,
    seed: int = 0,
    dim: int = 2,
    avg_degree: float = 10.0,
    shift: float = 1.0,
    shuffle: bool = False,
    dtype=np.float32,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """Unstructured SPD test system (A, b, x0): graph Laplacian of a random
    geometric graph plus a diagonal shift (L is PSD; L + shift*I is SPD with
    condition ~ (2*max_degree + shift) / shift): tpucg's irregular-sparse
    benchmark workload."""
    adj = random_geometric_graph_csr(
        n, seed=seed, dim=dim, avg_degree=avg_degree, shuffle=shuffle,
        dtype=np.float64,
    )
    coo = adj.to_coo()
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, coo.row, coo.data)
    rows = np.concatenate([coo.row, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([coo.col, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([-coo.data, deg + shift])
    A = COOMatrix(row=rows, col=cols, data=vals.astype(dtype),
                  shape=(n, n)).to_csr()
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal(n).astype(dtype)
    x0 = np.zeros(n, dtype=dtype)
    return A, b, x0


def fem_p1_system(
    n_points: int,
    seed: int = 0,
    shuffle: bool = False,
    dtype=np.float32,
    diffusion=None,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """Unstructured 2-D FEM system: P1 (linear-triangle) stiffness matrix on
    a random Delaunay mesh of the unit square, Dirichlet boundary eliminated.

    The SuiteSparse-style real-world workload (genuinely irregular row
    lengths, cotangent-weight values, mesh topology): assemble
    K_ij = sum_T grad(phi_i) . K grad(phi_j) |T| over all triangles, drop
    rows/cols of convex-hull (boundary) nodes — K restricted to interior
    nodes is SPD (Poisson problem with Dirichlet conditions). b is the
    assembled unit load vector. Interior nodes keep Delaunay input order
    (spatial locality comparable to a real mesh numbering);
    ``shuffle=True`` destroys it for reordering experiments
    (``tpucg_torch.sparse.ordering.rcm_order``).

    ``diffusion``: optional per-triangle SPD diffusion tensor — a callable
    mapping the (nt, 2) triangle centroids to (nt, 2, 2) tensors (the
    isotropic Laplacian K = I when None). Used by
    :func:`fem_p1_aniso_system` to build the anisotropic-diffusion family.

    Returns (A_csr, b, x0). Requires scipy (Delaunay); raises ImportError
    with a clear message if unavailable.
    """
    try:
        from scipy.spatial import Delaunay
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "fem_p1_system needs scipy.spatial.Delaunay; generate the "
            "irregular workload with random_geometric_spd instead"
        ) from e
    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    # Sort by spatial cell for a realistic mesh numbering.
    ncell = max(1, int(np.sqrt(n_points / 64.0)))
    cid = (np.minimum((pts[:, 0] * ncell).astype(np.int64), ncell - 1)
           * ncell
           + np.minimum((pts[:, 1] * ncell).astype(np.int64), ncell - 1))
    pts = pts[np.argsort(cid, kind="stable")]
    tri = Delaunay(pts)
    T = tri.simplices  # (nt, 3)
    # P1 stiffness per triangle: with edge vectors e_k opposite vertex k,
    # grad(phi_k) = perp(e_k) / (2|T|), so for a diffusion tensor K
    # K_local[i, j] = perp(e_i) . K perp(e_j) / (4 |T|)
    # (the isotropic case reduces to (e_i . e_j) / (4 |T|): a rotation
    # applied to both sides of the identity cancels).
    p0, p1, p2 = pts[T[:, 0]], pts[T[:, 1]], pts[T[:, 2]]
    e0 = p2 - p1
    e1 = p0 - p2
    e2 = p1 - p0
    area2 = np.abs(e2[:, 0] * (-e1[:, 1]) - e2[:, 1] * (-e1[:, 0]))  # 2|T|
    area2 = np.maximum(area2, 1e-14)
    E = np.stack([e0, e1, e2], axis=1)          # (nt, 3, 2)
    if diffusion is None:
        Kloc = np.einsum("tid,tjd->tij", E, E) / (2.0 * area2)[:, None, None]
    else:
        centroids = (p0 + p1 + p2) / 3.0        # (nt, 2)
        Kt = np.asarray(diffusion(centroids))   # (nt, 2, 2) SPD
        if Kt.shape != (T.shape[0], 2, 2):
            raise ValueError(
                f"diffusion must map (nt, 2) centroids to (nt, 2, 2) "
                f"tensors, got {Kt.shape}"
            )
        Perp = np.stack([-E[:, :, 1], E[:, :, 0]], axis=2)  # perp(e_k)
        Kloc = np.einsum("tic,tcd,tjd->tij", Perp, Kt, Perp) / (
            2.0 * area2
        )[:, None, None]
    rows = np.repeat(T, 3, axis=1).reshape(-1)          # i index
    cols = np.tile(T, (1, 3)).reshape(-1)               # j index
    vals = Kloc.reshape(-1)
    # Interior nodes only (hull nodes carry the Dirichlet condition).
    boundary = np.zeros(pts.shape[0], dtype=bool)
    boundary[np.unique(tri.convex_hull)] = True
    keep = ~boundary[rows] & ~boundary[cols]
    renum = np.cumsum(~boundary) - 1
    rows, cols, vals = renum[rows[keep]], renum[cols[keep]], vals[keep]
    n = int((~boundary).sum())
    if shuffle:
        relabel = rng.permutation(n)
        rows, cols = relabel[rows], relabel[cols]
    A = COOMatrix(row=rows, col=cols, data=vals.astype(dtype),
                  shape=(n, n)).to_csr()
    # Unit load: b_i = sum_T |T|/3 over triangles touching i (interior).
    b = np.zeros(pts.shape[0])
    np.add.at(b, T.reshape(-1), np.repeat(area2 / 6.0, 3))  # |T|/3 each
    b = b[~boundary]
    if shuffle:
        b_s = np.empty_like(b)
        b_s[relabel] = b
        b = b_s
    return A, b.astype(dtype), np.zeros(n, dtype)


def fem_p1_aniso_system(
    n_points: int,
    eps: float = 1e-2,
    theta: float = np.pi / 6.0,
    rotating: bool = False,
    seed: int = 0,
    shuffle: bool = False,
    dtype=np.float32,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """Anisotropic-diffusion P1 FEM system, the second independent
    generator family: the same unstructured Delaunay
    pipeline as :func:`fem_p1_system` but with the diffusion tensor

        K(x) = R(t)^T diag(1, eps) R(t),   t = theta (fixed) or the
        rotating field t(x) = theta + atan2(y - 1/2, x - 1/2)

    so heat flows ``1/eps`` times more easily along one direction than
    across it. This is the classic ITERATION-HARD input (strong coupling
    along characteristic lines, weak across): condition grows ~1/eps and
    point-Jacobi CG degrades far beyond the isotropic family. ``rotating=True`` bends the
    characteristic direction around the domain center (no single
    grid-aligned ordering can follow it — the harder variant).

    Returns (A_csr, b, x0) with the same conventions as
    :func:`fem_p1_system`.
    """
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")

    def diffusion(c):
        t = np.full(c.shape[0], float(theta))
        if rotating:
            t = t + np.arctan2(c[:, 1] - 0.5, c[:, 0] - 0.5)
        ct, st = np.cos(t), np.sin(t)
        # R^T diag(1, eps) R assembled directly: K = u u^T + eps v v^T
        # with u = (ct, st) the strong direction, v = (-st, ct).
        u = np.stack([ct, st], axis=1)
        v = np.stack([-st, ct], axis=1)
        return (
            np.einsum("ti,tj->tij", u, u)
            + float(eps) * np.einsum("ti,tj->tij", v, v)
        )

    return fem_p1_system(
        n_points, seed=seed, shuffle=shuffle, dtype=dtype,
        diffusion=diffusion,
    )


def aniso_grid_system(
    m: int,
    eps: float = 1e-2,
    seed: int = 0,
    shuffle: bool = False,
    dtype=np.float32,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """STRUCTURED anisotropic diffusion: the 5-point stencil of
    -u_xx - eps * u_yy on an m x m Dirichlet grid (n = m^2), strong
    coupling along x-lines (-1), weak across (-eps), diagonal 2 + 2 eps.

    The companion of :func:`fem_p1_aniso_system` on the other side of the
    mesh-regularity axis: here the strong couplings form LONG unbroken
    lines, the workload where ordering-based semi-coarsening pays.
    ``shuffle=True`` scrambles the numbering — the arbitrary-.mtx
    stand-in; ``tpucg_torch.sparse.ordering.strength_order`` (CLI
    ``--strength-order``) recovers line-contiguous numbering from the
    matrix alone, where plain RCM cannot (it follows weak and strong
    edges alike).

    Returns (A_csr, b, x0) in the common generator convention.
    """
    if m < 2:
        raise ValueError(f"m must be >= 2, got {m}")
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    n = m * m
    k = np.arange(n, dtype=np.int64)
    i, j = k // m, k % m
    rows = [k]
    cols = [k]
    vals = [np.full(n, 2.0 + 2.0 * float(eps))]
    right = k[j < m - 1]
    down = k[i < m - 1]
    rows += [right, right + 1, down, down + m]
    cols += [right + 1, right, down + m, down]
    vals += [
        np.full(right.size, -1.0), np.full(right.size, -1.0),
        np.full(down.size, -float(eps)), np.full(down.size, -float(eps)),
    ]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals).astype(dtype)
    if shuffle:
        relabel = np.random.default_rng(seed).permutation(n)
        rows, cols = relabel[rows], relabel[cols]
    A = COOMatrix(row=rows, col=cols, data=vals, shape=(n, n)).to_csr()
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal(n).astype(dtype)
    return A, b, np.zeros(n, dtype=dtype)
