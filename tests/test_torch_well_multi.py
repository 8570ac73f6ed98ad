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
from _torch_helpers import scaled_err
from tpucg.solver.cg import _cg_block_jit, _cg_multi_jit
from tpucg.solver.cg import block_jacobi_minv as j_block_jacobi_minv
from tpucg.solver.operators import WellOperator as JWellOperator
from tpucg_torch.io.generator import random_geometric_spd
from tpucg_torch.kernels.gather_spmv import well_spmv_multi, well_spmv_multi_torch
from tpucg_torch.solver.cg import cg_solve, cg_solve_block, cg_solve_multi
from tpucg_torch.solver.operators import WellOperator

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
