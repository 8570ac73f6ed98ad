"""tpucg_torch's k-column WELL product (``WellOperator.matvec_multi``, K13 x
k's plain version over the operator's ``WellRows`` layout) and the
multi-RHS and block solves on it, against tpucg on the CPU: the cases of
tpucg's ``tests/test_well_multi.py``.

Tolerances: the k-column product equals the single-column one column by
column bit for bit, and tpucg's vmapped ``well_spmv_xla`` bit for bit (both
sum each row in ascending slot order from +0); tpucg's vmapped Pallas
kernel (interpret mode) within 1e-6 of sum |a_ij x_j|. Solves: laps within
one of tpucg's and of the port's single-vector solves, x within 1e-5 of
max |x| at equal laps (tpucg's template holds its own multi to its singles
at 2e-3 relative; the port is held tighter to tpucg's multi), block CG's
within 1e-4 (its coupled trajectory rounds further apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import arrowhead_spd, scaled_err
from tpucg.solver.cg import _cg_block_jit, _cg_multi_jit
from tpucg.solver.cg import block_jacobi_minv as j_block_jacobi_minv
from tpucg.solver.operators import WellOperator as JWellOperator
from tpucg_torch.io.generator import random_geometric_spd
from tpucg_torch.kernels.gather_spmv import (TILE, TILE_MAX, well_rows, well_spmv_multi,
                                             well_spmv_multi_torch)
from tpucg_torch.solver.cg import cg_solve, cg_solve_block, cg_solve_multi
from tpucg_torch.solver.operators import WellOperator
from tpucg_torch.solver.sharded import well_shard_block
from tpucg_torch.sparse.well import csr_to_well_sharded

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def geo():
    A, b, _ = random_geometric_spd(500, seed=4, avg_degree=10.0)
    return A, b


def _rhs(npad, n, k, seed=0):
    B = np.zeros((npad, k), np.float32)
    B[:n] = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return B


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_multi_is_the_single_column_product(geo, k, dtype):
    A, _ = geo
    op = WellOperator.from_csr(A, device=CPU, storage_dtype=dtype)
    X = torch.from_numpy(_rhs(op.padded_n, A.shape[0], k, seed=1))
    Y = op.matvec_multi(X)
    assert Y.shape == (op.padded_n, k) and Y.dtype == torch.float32
    for j in range(k):
        assert torch.equal(Y[:, j], op.matvec(X[:, j].contiguous())), j
    assert torch.equal(Y, well_spmv_multi(op.rows, X, op.padded_n))
    assert torch.equal(Y, well_spmv_multi_torch(op.rows, X, op.padded_n))


@pytest.mark.parametrize("k", [1, 3])
def test_matvec_multi_matches_tpucgs_vmapped_kernels(geo, k):
    A, _ = geo
    op = WellOperator.from_csr(A, device=CPU)
    X = _rhs(op.padded_n, A.shape[0], k, seed=2)
    Y = op.matvec_multi(torch.from_numpy(X)).numpy()
    xla = JWellOperator.from_csr(A, backend="xla").matvec_multi(jnp.asarray(X))
    np.testing.assert_array_equal(Y, np.asarray(xla))
    pallas = np.asarray(JWellOperator.from_csr(A, backend="pallas").matvec_multi(jnp.asarray(X)))
    absA = WellOperator.from_csr(type(A)(indptr=A.indptr, indices=A.indices,
                                         data=np.abs(A.data), shape=A.shape), device=CPU)
    scale = absA.matvec_multi(torch.from_numpy(np.abs(X))).numpy()
    assert np.all(np.abs(Y - pallas) <= 1e-6 * np.maximum(scale, 1e-30))


def test_matvec_multi_bf16_is_the_single_column_product_of_tpucg(geo):
    A, _ = geo
    op = WellOperator.from_csr(A, device=CPU, storage_dtype=torch.bfloat16)
    X = _rhs(op.padded_n, A.shape[0], 4, seed=2)
    Y = op.matvec_multi(torch.from_numpy(X)).numpy()
    jop = JWellOperator.from_csr(A, backend="xla", storage_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(Y, np.asarray(jop.matvec_multi(jnp.asarray(X))))


@pytest.mark.parametrize("precondition", ["none", "jacobi", "block_jacobi"])
def test_multi_well_matches_singles_and_tpucg(geo, precondition):
    A, _ = geo
    n, k, bs = A.shape[0], 4, 64
    op = WellOperator.from_csr(A, device=CPU,
                               pc_block_size=bs if precondition == "block_jacobi" else None)
    B = _rhs(op.padded_n, n, k, seed=3)
    tol = 1e-5 * float(np.linalg.norm(B[:n, 0]))
    kw = dict(tol=tol, maxiter=4 * n, precondition=precondition, pc_block_size=bs)
    res = cg_solve_multi(op, B[:n], **kw)
    assert bool(res.converged.all())
    for j in range(k):
        single = cg_solve(op, B[:n, j], **kw)
        assert bool(single.converged)
        assert abs(int(res.iterations[j]) - int(single.iterations)) <= 1
        if int(res.iterations[j]) == int(single.iterations):
            assert scaled_err(res.x[:, j].numpy(), single.x.numpy()) <= 1e-5
    jop = JWellOperator.from_csr(A, backend="xla",
                                 pc_block_size=bs if precondition == "block_jacobi" else None)
    minv = None
    if precondition == "jacobi":
        d = jop.diagonal()
        minv = jnp.where(d != 0, 1.0 / d, 1.0)
    elif precondition == "block_jacobi":
        minv = j_block_jacobi_minv(jop, bs)
    ref = _cg_multi_jit(jop, jnp.asarray(B), jnp.zeros_like(jnp.asarray(B)), minv, tol, 4 * n,
                        True)
    its, jits = res.iterations.numpy(), np.asarray(ref.iterations)
    assert np.abs(its - jits).max() <= 1
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    for j in np.flatnonzero(its == jits):
        assert scaled_err(res.x[:, j].numpy(), np.asarray(ref.x)[:n, j]) <= 1e-5


def test_multi_well_column_tail_freezes(geo):
    A, _ = geo
    n = A.shape[0]
    op = WellOperator.from_csr(A, device=CPU)
    B = np.zeros((n, 3), np.float32)
    B[:, 0] = np.random.default_rng(5).standard_normal(n)
    B[:, 1] = 0.01 * B[:, 0]  # same direction, smaller: fewer laps
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    res = cg_solve_multi(op, B, tol=tol, maxiter=4 * n)
    its = res.iterations.tolist()
    assert bool(res.converged.all()) and its[2] == 0 and its[1] < its[0]
    assert bool((res.x[:, 2] == 0).all())
    Bp = np.zeros((op.padded_n, 3), np.float32)
    Bp[:n] = B
    ref = _cg_multi_jit(JWellOperator.from_csr(A, backend="xla"), jnp.asarray(Bp),
                        jnp.zeros((op.padded_n, 3)), None, tol, 4 * n, True)
    assert np.abs(res.iterations.numpy() - np.asarray(ref.iterations)).max() <= 1


def test_block_cg_well_uses_the_k_column_product_and_converges(geo):
    A, _ = geo
    n, k = A.shape[0], 4
    op = WellOperator.from_csr(A, device=CPU)
    B = _rhs(op.padded_n, n, k, seed=6)
    tol = 1e-5 * float(np.linalg.norm(B[:n, 0]))
    before = well_spmv_multi_torch.launches
    res = cg_solve_block(op, B[:n], tol=tol, maxiter=4 * n)
    assert well_spmv_multi_torch.launches > before
    assert bool(res.converged.all())
    X = res.x.numpy()
    for j in range(k):
        assert np.linalg.norm(B[:n, j] - A.matvec(X[:, j].astype(np.float64))) < 4 * tol, j
    ref = _cg_block_jit(JWellOperator.from_csr(A, backend="xla"), jnp.asarray(B),
                        jnp.zeros_like(jnp.asarray(B)), tol, 4 * n)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 1
    if int(res.iterations) == int(ref.iterations):
        # Block CG on a graph Laplacian stopped at 1e-5 ||b|| (24 laps):
        # the two f32 trajectories (XLA fuses each axpy into an FMA, torch
        # does not) end 1.9e-5 of max |x| apart.
        assert scaled_err(X, np.asarray(ref.x)[:n]) <= 1e-4


# The layout's tiles and its long rows (the rows of more than half a tile,
# which K13 x k takes with a block each, ``WellRows.long_rows``) in every
# layout the operator, a rank's block and a forced tile build: each row in
# exactly one tile, a long row a tile of its own, the slot cap held; the
# plain k-column product over any of those layouts is tpucg's.

LAYOUT_TILES = (2, 64, 1024, TILE, TILE_MAX)


@pytest.fixture(scope="module")
def arrow():
    return arrowhead_spd(3000, seed=1)


def _matrix(kind, geo, arrow):
    return geo[0] if kind == "geometric" else arrow


def _check_tiles(rows, nrows):
    """Each of ``nrows`` rows in exactly one tile, a row of more than half a
    tile a tile of its own and listed in ``long_rows``, every other tile at
    most ``tile`` slots; returns the long rows."""
    ptr = rows.rowptr.long()
    lens = torch.diff(ptr)
    assert lens.numel() == nrows
    tptr = rows.tptr.long()
    assert rows.tptr.dtype == torch.int32 and rows.tptr.is_contiguous()
    assert int(tptr[0]) == 0 and int(tptr[-1]) == nrows
    assert bool((torch.diff(tptr) > 0).all())
    slots = ptr[tptr[1:]] - ptr[tptr[:-1]]
    single = torch.diff(tptr) == 1
    assert bool((slots[~single] <= rows.tile).all())
    long_rows = torch.nonzero(lens > rows.tile // 2).reshape(-1).tolist()
    assert rows.long_rows.dtype == torch.int32 and rows.long_rows.is_contiguous()
    assert rows.long_rows.tolist() == long_rows
    starts = set(tptr.tolist())
    assert all(r in starts and r + 1 in starts for r in long_rows)
    return long_rows


@pytest.mark.parametrize("tile", LAYOUT_TILES)
@pytest.mark.parametrize("kind", ["geometric", "arrowhead"])
def test_long_rows_are_the_rows_past_half_a_tile(geo, arrow, kind, tile):
    op = WellOperator.from_csr(_matrix(kind, geo, arrow), device=CPU)
    rows = well_rows(op.vals, op.lidx, op.gidl, op.wrow, op.sgb, op.bg, op.nsg, tile=tile)
    long_rows = _check_tiles(rows, op.nsg * op.bg * 128)
    if kind == "arrowhead":
        assert long_rows[:1] == ([0] if arrow.shape[0] > tile // 2 else [])


@pytest.mark.parametrize("k", [2, 5, 16, 33])
@pytest.mark.parametrize("kind", ["geometric", "arrowhead"])
def test_multi_plain_over_any_tiling_is_tpucgs(geo, arrow, kind, k):
    A = _matrix(kind, geo, arrow)
    op = WellOperator.from_csr(A, device=CPU)
    X = _rhs(op.padded_n, A.shape[0], k, seed=k)
    want = np.asarray(JWellOperator.from_csr(A, backend="xla").matvec_multi(jnp.asarray(X)))
    for tile in (64, TILE, TILE_MAX):
        rows = well_rows(op.vals, op.lidx, op.gidl, op.wrow, op.sgb, op.bg, op.nsg, tile=tile)
        Y = well_spmv_multi_torch(rows, torch.from_numpy(X), op.padded_n).numpy()
        np.testing.assert_array_equal(Y, want, err_msg=f"tile {tile}")


@pytest.mark.parametrize("P", [2, 3])
def test_sharded_rank_layouts_list_their_long_rows(arrow, P):
    # A rank's block gets the operator's tiling and long rows (the
    # arrowhead's full row, on rank 0), and its plain product is the block's
    # rows of A X.
    n = arrow.shape[0]
    stacked, statics = csr_to_well_sharded(arrow, P)
    rps, npad = int(statics["rps"]), int(statics["npad"])
    X = _rhs(npad, n, 8, seed=P)
    dense = np.zeros((npad, npad))
    dense[:n, :n] = _dense(arrow)
    dense[np.arange(n, npad), np.arange(n, npad)] = 1.0
    want = dense @ X.astype(np.float64)
    scale = np.abs(dense) @ np.abs(X.astype(np.float64))
    for rank in range(P):
        rows = well_shard_block(stacked, statics, rank, n, CPU).arrays[5]
        long_rows = _check_tiles(rows, rows.rowptr.numel() - 1)
        assert long_rows == ([0] if rank == 0 else [])
        Y = well_spmv_multi_torch(rows, torch.from_numpy(X), rps).numpy()
        blk = slice(rank * rps, (rank + 1) * rps)
        assert np.all(np.abs(Y - want[blk]) <= 1e-5 * np.maximum(scale[blk], 1e-30))


def _dense(csr):
    out = np.zeros(csr.shape)
    for i in range(csr.shape[0]):
        lo, hi = csr.indptr[i], csr.indptr[i + 1]
        np.add.at(out[i], csr.indices[lo:hi], csr.data[lo:hi])
    return out
