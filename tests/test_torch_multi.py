"""tpucg_torch's multi-RHS solve (``cg_solve_multi``, ``multi_cg_loop``)
and the k-column products K6 x k and K8 x k against tpucg on the CPU: the
serial cases of tpucg's ``tests/test_multi.py``, on the same NumPy inputs.

Tolerances: laps equal where the spectra set them (a circulant system whose
spectrum has m levels stops every column in m laps), else within one lap
(the rounding of r at the stop is of the order of tol); x within 1e-5 of
max |x| at equal laps; the result's fields and shapes are tpucg's. The
plain k-column products equal their single-column plain versions column by
column bit for bit, and tpucg's vmapped Pallas kernels (interpret mode)
within 1e-6 of sum |a_ij x_j|, as the single-column ones do
(``test_torch_sparse.py``, ``test_torch_stencil.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import (
    circulant_spd_batch,
    random_banded_dia,
    scaled_err,
    tpucg_padded_dense,
)
from tpucg.kernels.spmv import dia_interleave as j_interleave
from tpucg.kernels.spmv import dia_spmv_pallas
from tpucg.kernels.stencil import poisson3d_pallas
from tpucg.solver.operators import DiaOperator as JDiaOperator
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.io.generator import generate_spd_system, poisson3d_csr, poisson3d_dia
from tpucg_torch.kernels.spmv import dia_spmv_multi, dia_spmv_multi_torch, dia_spmv_torch
from tpucg_torch.kernels.stencil import poisson3d_multi, poisson3d_multi_torch, poisson3d_torch
from tpucg_torch.solver.cg import cg_solve, cg_solve_multi
from tpucg_torch.solver.operators import DiaOperator, EllOperator, PoissonOperator
from tpucg_torch.solver.oracle import oracle_cg
from tpucg_torch.sparse.formats import DIAMatrix

CPU = torch.device("cpu")


def _held(port, ref, laps=1):
    """The port's multi result against tpucg's, column by column: the same
    fields and shapes, laps within ``laps``, x within 1e-5 of max |x| where
    the laps are equal, the same ``converged``."""
    x, jx = port.x.numpy(), np.asarray(ref.x)
    assert x.shape == jx.shape and port.x.dtype == torch.float32
    for f in ("iterations", "residual_norm", "converged"):
        assert tuple(getattr(port, f).shape) == np.asarray(getattr(ref, f)).shape, f
    its, jits = port.iterations.numpy(), np.asarray(ref.iterations)
    assert np.abs(its - jits).max() <= laps, (its, jits)
    np.testing.assert_array_equal(port.converged.numpy(), np.asarray(ref.converged))
    for j in np.flatnonzero(its == jits):
        assert scaled_err(x[:, j], jx[:, j]) <= 1e-5, j


@pytest.fixture(scope="module")
def dense64():
    n, k = 64, 5
    A, _, _ = generate_spd_system(n, seed=0)
    B = np.random.default_rng(1).random((n, k)).astype(np.float32)
    return A, B, tpucg.cg_solve_multi(tpucg_padded_dense(A), B)


def test_multi_matches_per_column_solves(dense64):
    A, B, ref = dense64
    n, k = B.shape
    res = cg_solve_multi(A, B, device=CPU)
    assert res.x.shape == (n, k) and res.iterations.shape == (k,)
    assert res.iterations.dtype == torch.int32 and res.converged.dtype == torch.bool
    _held(res, ref)
    for j in range(k):
        x_ref, k_ref, _ = oracle_cg(A, B[:, j], np.zeros(n, np.float32))
        assert bool(res.converged[j])
        assert abs(int(res.iterations[j]) - k_ref) <= 1
        np.testing.assert_allclose(res.x[:, j].numpy(), x_ref, rtol=1e-4, atol=1e-6)
        single = cg_solve(A, B[:, j], device=CPU, fused="never")
        assert abs(int(res.iterations[j]) - int(single.iterations)) <= 1


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_multi_laps_are_set_by_the_spectrum(pc):
    # Circulant systems of m = 3 and 5 levels stop every column in m laps in
    # both packages (tol 1e-2 with b ~ U(0, 1): circulant_spd_batch).
    As, _, _ = circulant_spd_batch(6, 200, seed=3)
    for i in (2, 4):
        B = np.random.default_rng(i).random((200, 4)).astype(np.float32)
        res = cg_solve_multi(As[i], B, device=CPU, tol=1e-2, precondition=pc)
        ref = tpucg.cg_solve_multi(tpucg_padded_dense(As[i]), B, tol=1e-2, precondition=pc)
        assert res.iterations.tolist() == [i + 1] * 4
        _held(res, ref, laps=0)


def test_multi_independent_convergence():
    n = 48
    A, _, _ = generate_spd_system(n, seed=2)
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal((n, 2)).astype(np.float32)
    B = (A @ x_true).astype(np.float32)
    B[:, 1] *= 1e-3  # a much smaller rhs: fewer laps at an absolute tol
    res = cg_solve_multi(A, B, device=CPU)
    assert bool(res.converged.all())
    assert int(res.iterations[1]) <= int(res.iterations[0])
    _held(res, tpucg.cg_solve_multi(tpucg_padded_dense(A), B))


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi", "poly"])
def test_multi_padded_and_preconditioned(pc):
    n, k = 67, 3
    A, _, _ = generate_spd_system(n, seed=4)
    B = np.random.default_rng(5).random((n, k)).astype(np.float32)
    kw = dict(precondition=pc, pc_block_size=16, poly_degree=3)
    res = cg_solve_multi(A, B, device=CPU, **kw)
    assert res.x.shape == (n, k) and bool(res.converged.all())
    for j in range(k):
        assert np.linalg.norm(B[:, j] - A @ res.x[:, j].numpy()) < 1e-5
        single = cg_solve(A, B[:, j], device=CPU, fused="never", **kw)
        assert abs(int(res.iterations[j]) - int(single.iterations)) <= 1
    _held(res, tpucg.cg_solve_multi(tpucg_padded_dense(A), B, **kw))


def test_multi_rejects_pipelined_and_bad_shapes():
    A, b, _ = generate_spd_system(16, seed=0)
    with pytest.raises(ValueError, match="method"):
        cg_solve_multi(A, np.ones((16, 2)), method="pipelined", device=CPU)
    with pytest.raises(ValueError, match="shape"):
        cg_solve_multi(A, b, device=CPU)  # 1-D B
    with pytest.raises(ValueError, match="shape"):
        cg_solve_multi(A, np.ones((16, 2)), np.ones((16, 3)), device=CPU)


@pytest.fixture(scope="module")
def poisson8():
    csr = poisson3d_csr(8)
    n = csr.shape[0]
    X_true = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    B = np.stack([csr.matvec(X_true[:, j]) for j in range(3)], axis=1).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    ref = tpucg.cg_solve_multi(JPoissonOperator(m=8, kernel="xla"), B, tol=tol, maxiter=4 * n)
    return csr, X_true, B, tol, ref


def test_multi_with_sparse_operators(poisson8):
    csr, X_true, B, tol, ref = poisson8
    n = csr.shape[0]
    r = cg_solve_multi(EllOperator.from_csr(csr, device=CPU), B, tol=tol, maxiter=4 * n)
    assert bool(r.converged.all())
    np.testing.assert_allclose(r.x.numpy(), X_true, atol=1e-2)
    r2 = cg_solve_multi(PoissonOperator(8, device=CPU), B, tol=tol, maxiter=4 * n)
    assert bool(r2.converged.all())
    np.testing.assert_allclose(r2.x.numpy(), r.x.numpy(), rtol=1e-3, atol=1e-4)
    _held(r2, ref)
    r3 = cg_solve_multi(DiaOperator.from_dia(poisson3d_dia(8), device=CPU), B, tol=tol,
                        maxiter=4 * n)
    # The DIA and stencil products are one function bit for bit (6 u minus
    # the neighbours in one order; the DIA slab stores 6 and -1).
    assert torch.equal(r3.iterations, r2.iterations)
    np.testing.assert_allclose(r3.x.numpy(), r2.x.numpy(), rtol=1e-5, atol=1e-6)


def test_multi_poisson_stencil_m16(poisson8):
    # tpucg's template runs its Pallas stencil under vmap here; the port's
    # plain K8 x k carries the (n, k) block.
    m, k = 16, 2
    op = PoissonOperator(m, device=CPU)
    n = m ** 3
    X_true = np.random.default_rng(1).standard_normal((n, k)).astype(np.float32)
    B = poisson3d_multi_torch(torch.from_numpy(X_true), m).numpy()
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    r = cg_solve_multi(op, B, tol=tol, maxiter=4 * n)
    assert bool(r.converged.all())
    np.testing.assert_allclose(r.x.numpy(), X_true, atol=1e-2)


def test_multi_zero_column_stops_at_zero_laps_and_later_steps_change_nothing():
    n = 96
    A, b, _ = generate_spd_system(n, seed=6)
    B = np.stack([b, 0.01 * b, np.zeros(n, np.float32)], axis=1)
    runs = [cg_solve_multi(A, B, device=CPU, chunk=c) for c in (None, 1, 3, 64)]
    its = runs[0].iterations.tolist()
    assert its[2] == 0 and its[1] <= its[0]
    assert bool((runs[0].x[:, 2] == 0).all())
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f


def test_multi_maxiter_cut_reports_each_column():
    A, _, _ = generate_spd_system(128, seed=7)
    B = np.random.default_rng(8).random((128, 2)).astype(np.float32)
    res = cg_solve_multi(A, B, device=CPU, tol=1e-12, maxiter=2)
    ref = tpucg.cg_solve_multi(tpucg_padded_dense(A), B, tol=1e-12, maxiter=2)
    assert res.iterations.tolist() == [2, 2] == np.asarray(ref.iterations).tolist()
    assert not bool(res.converged.any())
    np.testing.assert_allclose(res.residual_norm.numpy(), np.asarray(ref.residual_norm),
                               rtol=1e-4)


# ---- the plain k-column products ------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n, offsets", [(300, (-7, -1, 0, 1, 7)), (256, (-200, 0, 200)),
                                        (129, (0,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_multi_plain_is_the_single_plain_column_by_column(k, n, offsets, dtype):
    _, data, _ = random_banded_dia(n, offsets, seed=k)
    data = torch.from_numpy(data).to(dtype)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal((n, k)).astype(np.float32))
    Y = dia_spmv_multi_torch(data, offsets, X)
    assert Y.shape == (n, k) and Y.dtype == torch.float32
    for j in range(k):
        assert torch.equal(Y[:, j], dia_spmv_torch(data, offsets, X[:, j].contiguous())), j
    assert torch.equal(dia_spmv_multi(data, offsets, X), Y)  # a CPU slab: the plain version
    # Through the operator, padded as tpucg pads (n = 300 -> 384).
    op = DiaOperator.from_dia(DIAMatrix(offsets=np.asarray(offsets),
                                        data=data.float().numpy(), shape=(n, n)), device=CPU,
                              storage_dtype=dtype)
    Xp = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (op.padded_n, k)).astype(np.float32))
    Yp = op.matvec_multi(Xp)
    for j in range(k):
        assert torch.equal(Yp[:, j], op.matvec(Xp[:, j].contiguous())), j


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("m", [2, 5, 8])
def test_poisson_multi_plain_is_the_single_plain_column_by_column(k, m):
    U = torch.from_numpy(np.random.default_rng(m + k).standard_normal(
        (m ** 3, k)).astype(np.float32))
    Y = poisson3d_multi_torch(U, m)
    for j in range(k):
        assert torch.equal(Y[:, j], poisson3d_torch(U[:, j].contiguous(), m)), j
    assert torch.equal(poisson3d_multi(U, m), Y)
    assert torch.equal(PoissonOperator(m, device=CPU).matvec_multi(U), Y)
    # A transposed view is read as its values (the operator makes it
    # contiguous for the kernel).
    assert torch.equal(PoissonOperator(m, device=CPU).matvec_multi(U.T.contiguous().T), Y)


def test_dia_multi_plain_matches_tpucgs_vmapped_pallas():
    # tpucg's Pallas DIA kernel under vmap (interpret mode) rounds otherwise
    # than the plain sums, as the single-column one does: 1e-6 of
    # sum_d |data[d, i] X[i + off_d, j]|.
    n, k, offsets = 512, 3, (-7, -1, 0, 1, 7)
    _, data, _ = random_banded_dia(n, offsets, seed=3)
    X = np.random.default_rng(4).standard_normal((n, k)).astype(np.float32)
    got = dia_spmv_multi_torch(torch.from_numpy(data), offsets, torch.from_numpy(X)).numpy()
    j = jnp.asarray(j_interleave(data))
    pallas = np.asarray(jax.vmap(lambda x: dia_spmv_pallas(j, offsets, x), in_axes=1,
                                 out_axes=1)(jnp.asarray(X)))
    scale = dia_spmv_multi_torch(torch.from_numpy(np.abs(data)).double(), offsets,
                                 torch.from_numpy(np.abs(X)).double()).numpy()
    assert np.all(np.abs(got - pallas) <= 1e-6 * scale)
    jop = JDiaOperator.from_dia(tpucg.sparse.formats.DIAMatrix(
        offsets=np.asarray(offsets), data=data, shape=(n, n)), backend="xla")
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jop.matvec, in_axes=1, out_axes=1)(
        jnp.asarray(X))))


def test_poisson_multi_plain_matches_tpucgs_vmapped_pallas():
    m, k = 16, 2
    U = np.random.default_rng(5).standard_normal((m ** 3, k)).astype(np.float32)
    got = poisson3d_multi_torch(torch.from_numpy(U), m).numpy()
    pallas = np.asarray(jax.vmap(lambda u: poisson3d_pallas(u, m), in_axes=1, out_axes=1)(
        jnp.asarray(U)))
    absu = torch.from_numpy(np.abs(U))
    scale = 12 * np.abs(U) - poisson3d_multi_torch(absu, m).numpy()
    assert np.all(np.abs(got - pallas) <= 1e-6 * scale)
    xla = jax.vmap(JPoissonOperator(m=m)._matvec_xla, in_axes=1, out_axes=1)(jnp.asarray(U))
    np.testing.assert_array_equal(got, np.asarray(xla))
