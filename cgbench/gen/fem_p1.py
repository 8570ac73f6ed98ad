"""tpucg's P1 finite-element system, frozen.

A copy of ``fem_p1_system`` (``tpucg_torch/io/generator.py``, itself a copy
of ``tpucg/io/generator.py``) for the isotropic Laplacian in mesh order, with
the COO-to-CSR step of ``tpucg_torch.sparse.formats`` inlined: the same
arrays, duplicates kept (each edge appears once per triangle that holds it),
so that the yardstick does not move when the program's generator does.
"""

from __future__ import annotations

import numpy as np

# make() reads no run seed: the harness keeps its arrays once per checkout.
SEEDLESS = True


def fem_p1_csr(n_points: int, seed: int = 0):
    """(indptr int64 (n+1,), indices int32 (nnz,), data float32 (nnz,), n):
    the stiffness matrix of a random Delaunay mesh of ``n_points`` points in
    the unit square, boundary (convex hull) nodes eliminated."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    ncell = max(1, int(np.sqrt(n_points / 64.0)))
    cid = (np.minimum((pts[:, 0] * ncell).astype(np.int64), ncell - 1) * ncell
           + np.minimum((pts[:, 1] * ncell).astype(np.int64), ncell - 1))
    pts = pts[np.argsort(cid, kind="stable")]
    tri = Delaunay(pts)
    T = tri.simplices
    p0, p1, p2 = pts[T[:, 0]], pts[T[:, 1]], pts[T[:, 2]]
    e0, e1, e2 = p2 - p1, p0 - p2, p1 - p0
    area2 = np.maximum(np.abs(e2[:, 0] * (-e1[:, 1]) - e2[:, 1] * (-e1[:, 0])), 1e-14)
    E = np.stack([e0, e1, e2], axis=1)
    Kloc = np.einsum("tid,tjd->tij", E, E) / (2.0 * area2)[:, None, None]
    rows = np.repeat(T, 3, axis=1).reshape(-1)
    cols = np.tile(T, (1, 3)).reshape(-1)
    vals = Kloc.reshape(-1)
    boundary = np.zeros(pts.shape[0], dtype=bool)
    boundary[np.unique(tri.convex_hull)] = True
    keep = ~boundary[rows] & ~boundary[cols]
    renum = np.cumsum(~boundary) - 1
    rows, cols, vals = renum[rows[keep]], renum[cols[keep]], vals[keep].astype(np.float32)
    n = int((~boundary).sum())
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols.astype(np.int32), vals, n


def make(config: dict, seed: int, device):
    """The configuration's matrix: its mesh comes from ``mesh_seed`` (the
    deployment's mesh), never from the run's seed, so every run solves the
    same system and only the loads change."""
    indptr, indices, data, n = fem_p1_csr(int(config["n_points"]), int(config["mesh_seed"]))
    return {"kind": "csr", "n": n, "indptr": indptr, "indices": indices, "data": data}
