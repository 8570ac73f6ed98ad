"""The port's deflated and recycling CG (``solver/deflation.py``) against
tpucg's, on the CPU: the serial cases of tpucg's ``tests/test_deflation.py``.
The same seeded NumPy systems go through both packages; tpucg's dense
operator is ``tpucg_padded_dense`` (the port's padded operator, XLA), its
sparse ones its own. Laps are held equal, or within 2 where a sequence's
rounding carries over solves (tpucg's own round-trip bound), x within 1e-4
of max |x|; the A-orthonormal basis equals tpucg's within 1e-5, and a
``RecyclingCG`` state saved by either package loads in the other."""

import os

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import scaled_err, tpucg_padded_dense
from tpucg_torch.interop import deflation_basis_from_numpy
from tpucg_torch.io.generator import fem_p1_system, generate_spd_system
from tpucg_torch.solver.cg import TRUE_CHECK_EVERY, cg_solve
from tpucg_torch.solver.deflation import (
    DEFLATED_REPLACE_EVERY,
    RecyclingCG,
    build_deflation_basis,
    cg_solve_deflated,
)
from tpucg_torch.solver.oracle import oracle_cg
from tpucg_torch.solver.operators import DenseOperator, best_sparse_operator
from tpucg_torch.solver.twolevel import build_two_level

CPU = torch.device("cpu")


def _clustered_spd(n=256, n_small=3, seed=0):
    """tpucg's test system: n_small eigenvalues at 0.01, 0.02, ... under a
    [1, 2] bulk; returns (A, the slow eigenvectors)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([0.01 * (1.0 + np.arange(n_small)),
                          1.0 + rng.uniform(0.0, 1.0, n - n_small)])
    A = (Q * lam) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32), Q[:, :n_small].astype(np.float32)


def _both(A, b, V, **kw):
    port = cg_solve_deflated(A, b, V, device=CPU, **kw)
    ref = tpucg.cg_solve_deflated(tpucg_padded_dense(A), b, V, **kw)
    return port, ref


def test_eigen_deflation_matches_tpucg_and_cuts_laps():
    A, V = _clustered_spd()
    n = A.shape[0]
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _both(A, b, V, tol=tol, maxiter=4 * n)
    plain = cg_solve(A, b, device=CPU, tol=tol, maxiter=4 * n)
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    assert int(port.iterations) * 2 < int(plain.iterations)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4
    x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    assert np.abs(port.x.numpy() - x_ref).max() < 1e-2 * np.abs(x_ref).max()


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi", "poly"])
def test_deflation_composes_with_preconditioners(pc):
    # tpucg's badly scaled clustered system (Jacobi's case), and block Jacobi
    # and poly on it.
    A, Vlow = _clustered_spd(n=256, seed=8)
    d = np.exp(np.random.default_rng(9).uniform(0, np.log(30), 256))
    As = (A * d[:, None] * d[None, :]).astype(np.float32)
    b = np.random.default_rng(10).standard_normal(256).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b / np.sqrt(np.diag(As))))
    kw = dict(tol=tol, maxiter=4 * 256, precondition=pc, pc_block_size=32)
    port, ref = _both(As, b, (Vlow / d[:, None]).astype(np.float32), **kw)
    assert bool(port.converged) and bool(ref.converged)
    assert abs(int(port.iterations) - int(ref.iterations)) <= 1
    assert np.linalg.norm(b - As @ port.x.numpy()) < 10 * tol
    if int(port.iterations) == int(ref.iterations):
        assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_harmless_subspaces_single_vectors_and_padding():
    # A random space, a 1-D V on n = 100 (padded to 128) and duplicated
    # columns (pruned to one) all keep the oracle's solution.
    A, b, x0 = generate_spd_system(192, seed=3)
    V = np.random.default_rng(4).standard_normal((192, 5)).astype(np.float32)
    res = cg_solve_deflated(A, b, V, x0=x0, device=CPU)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), oracle_cg(A, b, x0, tol=1e-6)[0],
                               rtol=1e-3, atol=1e-4)
    A, b, _ = generate_spd_system(100, seed=5)
    res = cg_solve_deflated(A, b, np.ones(100, np.float32), device=CPU)
    assert bool(res.converged) and res.x.shape == (100,)
    np.testing.assert_allclose(res.x.numpy(), oracle_cg(A, b, np.zeros(100, np.float32),
                                                        tol=1e-6)[0], rtol=1e-3, atol=1e-4)
    A, b, _ = generate_spd_system(128, seed=6)
    v = np.random.default_rng(7).standard_normal(128).astype(np.float32)
    basis = build_deflation_basis(A, np.stack([v, v, 2 * v], axis=1), device=CPU)
    assert basis.m == 1
    res = cg_solve_deflated(A, b, basis=basis, device=CPU)
    assert bool(res.converged) and np.isfinite(res.x.numpy()).all()


def test_basis_is_a_orthonormal_and_equals_tpucgs():
    # tpucg's near-degenerate solution stack; columns aligned in sign
    # (each package's eigh picks its own).
    A, b, _ = generate_spd_system(256, seed=20)
    x = np.linalg.solve(A.astype(np.float64), np.asarray(b, np.float64))
    V = np.stack([x, x * (1 + 1e-3 * np.random.default_rng(21).standard_normal(256))],
                 axis=1).astype(np.float32)
    basis = build_deflation_basis(A, V, device=CPU)
    W = basis.W.double().numpy()
    np.testing.assert_allclose(W.T @ (A.astype(np.float64) @ W), np.eye(basis.m), atol=5e-4)
    assert torch.equal(basis.Ginv, torch.eye(basis.m))
    ref = tpucg.build_deflation_basis(tpucg_padded_dense(A), V)
    assert basis.m == ref.m == 2
    for mine, theirs in ((basis.W, ref.W), (basis.AW, ref.AW)):
        m, t = mine.numpy(), np.asarray(theirs)
        t = t * np.sign(np.sum(m * t, axis=0))
        assert np.abs(m - t).max() <= 1e-5 * np.abs(t).max()
    # tpucg's basis carried into the port deflates as the port's own does.
    carried = deflation_basis_from_numpy(ref.W, ref.AW, ref.Ginv)
    tol = 1e-5 * float(np.linalg.norm(b))
    own = cg_solve_deflated(A, b, basis=basis, tol=tol, device=CPU)
    theirs = cg_solve_deflated(A, b, basis=carried, tol=tol, device=CPU)
    assert int(own.iterations) == int(theirs.iterations) and bool(theirs.converged)
    assert scaled_err(theirs.x.numpy(), own.x.numpy()) <= 1e-5


def test_galerkin_warm_start_solves_an_exact_subspace():
    A, _ = _clustered_spd(n=128, seed=14)
    W = np.random.default_rng(15).standard_normal((128, 4)).astype(np.float32)
    y = np.random.default_rng(16).standard_normal(4).astype(np.float32)
    b = (A @ W @ y).astype(np.float32)
    port, ref = _both(A, b, W, tol=1e-4)
    assert bool(port.converged) and int(port.iterations) == int(ref.iterations) == 0


def test_validation():
    A, V = _clustered_spd(n=128, seed=11)
    b = np.random.default_rng(12).standard_normal(128).astype(np.float32)
    basis = build_deflation_basis(A, V, device=CPU)
    with pytest.raises(ValueError, match="exactly one"):
        cg_solve_deflated(A, b, V, basis=basis, device=CPU)
    with pytest.raises(ValueError, match="exactly one"):
        cg_solve_deflated(A, b, device=CPU)
    with pytest.raises(ValueError, match="method"):
        cg_solve_deflated(A, b, V, method="pipelined", device=CPU)
    with pytest.raises(ValueError, match="float32"):
        cg_solve_deflated(A, b, V, dtype=torch.float64, device=CPU)
    A2, _ = _clustered_spd(n=300, seed=11)
    with pytest.raises(ValueError, match="padded size"):
        cg_solve_deflated(A2, np.ones(300, np.float32), basis=basis, device=CPU)
    assert DEFLATED_REPLACE_EVERY is None  # tpucg's: replacement off


# ---- RecyclingCG ------------------------------------------------------------


def _sequence(n=256, seed=30):
    A, _ = _clustered_spd(n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    base = rng.standard_normal(n).astype(np.float32)
    drift = rng.standard_normal(n).astype(np.float32)
    return A, [base + 0.1 * t * drift for t in range(5)], 1e-4 * float(np.linalg.norm(base))


def test_recycling_sequence_matches_tpucg_and_laps_drop():
    A, rhs, tol = _sequence()
    port = RecyclingCG(A, max_vectors=3, tol=tol, maxiter=1024, device=CPU)
    ref = tpucg.RecyclingCG(tpucg_padded_dense(A), max_vectors=3, tol=tol, maxiter=1024,
                            kernel="xla")
    laps, ref_laps = [], []
    for b in rhs:
        r, j = port.solve(b), ref.solve(b)
        assert bool(r.converged) and bool(j.converged)
        laps.append(int(r.iterations))
        ref_laps.append(int(j.iterations))
    assert all(abs(a - c) <= 2 for a, c in zip(laps, ref_laps)), (laps, ref_laps)
    assert min(laps[1:]) * 2 < laps[0], laps
    assert port._basis is not None and port._basis.m == 3


@pytest.mark.parametrize("saver", ["tpucg", "port"])
def test_recycling_state_loads_across_packages(tmp_path, saver):
    # Three solves in one package, saved; the other loads the stack (the
    # probe signatures agree) and continues within 2 laps of an
    # uninterrupted run of its own.
    A, rhs, tol = _sequence()
    path = str(tmp_path / "rec_state.npz")

    def make(which):
        if which == "tpucg":
            return tpucg.RecyclingCG(tpucg_padded_dense(A), max_vectors=3, tol=tol,
                                     maxiter=1024, kernel="xla")
        return RecyclingCG(A, max_vectors=3, tol=tol, maxiter=1024, device=CPU)

    loader = "port" if saver == "tpucg" else "tpucg"
    whole = make(loader)
    want = [int(whole.solve(b).iterations) for b in rhs]
    first = make(saver)
    for b in rhs[:3]:
        first.solve(b)
    first.save_state(path)
    resumed = make(loader)
    assert resumed.load_state(path) == 3
    for t in (3, 4):
        r = resumed.solve(rhs[t])
        assert bool(r.converged) and abs(int(r.iterations) - want[t]) <= 2


def test_recycling_refuses_a_foreign_operator(tmp_path):
    A1, _ = _clustered_spd(n=128, seed=32)
    A2, _ = _clustered_spd(n=128, seed=33)
    b = np.random.default_rng(34).standard_normal(128).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    path = str(tmp_path / "rec_state.npz")
    ref = tpucg.RecyclingCG(tpucg_padded_dense(A1), max_vectors=2, tol=tol, maxiter=1024,
                            kernel="xla")
    ref.solve(b)
    ref.save_state(path)
    with pytest.raises(ValueError, match="DIFFERENT operator"):
        RecyclingCG(A2, max_vectors=2, tol=tol, maxiter=1024, device=CPU).load_state(path)
    port = RecyclingCG(A1, max_vectors=2, tol=tol, maxiter=1024, device=CPU)
    assert port.load_state(path) == 1


def test_recycling_with_two_level_on_fem_matches_tpucg():
    # The FEM sequence with the two-level base (deflation x two-level: true
    # residual checked every 16 laps in both): laps equal solve by solve.
    A, b0, _ = fem_p1_system(3_000, seed=3)
    n = A.shape[0]
    rng = np.random.default_rng(11)
    rhs = [b0.astype(np.float32)]
    for _ in range(2):
        rhs.append((rhs[-1] + 0.05 * rng.standard_normal(n) * np.abs(b0).max())
                   .astype(np.float32))
    tol = 1e-3 * float(np.linalg.norm(b0))
    op = best_sparse_operator(A, device=CPU)
    jop = tpucg.best_sparse_operator(A)
    port = RecyclingCG(op, max_vectors=2, tol=tol, maxiter=4 * n, device=CPU,
                       two_level=build_two_level(A, agg_size=32, npad=op.padded_n, device=CPU))
    ref = tpucg.RecyclingCG(jop, max_vectors=2, tol=tol, maxiter=4 * n,
                            two_level=tpucg.build_two_level(A, agg_size=32, npad=jop.padded_n))
    for b in rhs:
        r, j = port.solve(b), ref.solve(b)
        assert bool(r.converged) == bool(j.converged)
        assert int(r.iterations) == int(j.iterations)
        assert int(r.iterations) % TRUE_CHECK_EVERY == 0
        assert scaled_err(r.x.numpy(), np.asarray(j.x)) <= 1e-4
    assert port._basis is not None and port._basis.m == 2


def test_recycling_refusals(tmp_path):
    A, _ = _clustered_spd(n=128, seed=40)
    # On a mesh (M14 step 5) it keeps tpucg's ValueError for two_level= and
    # for a checkpointed solve (tpucg's "serial-only"); test_torch_sharded_m12.py
    # holds its solves to tpucg's.
    from tpucg_torch.comm.mesh import Mesh

    mesh = Mesh(group=None, rank=0, size=1, device=CPU, backend="gloo")
    with pytest.raises(ValueError, match="serial-only"):
        RecyclingCG(A, mesh=mesh, two_level=object())
    with pytest.raises(ValueError, match="RecyclingCG checkpoint_path is serial-only"):
        RecyclingCG(A, mesh=mesh).solve(np.ones(128, np.float32),
                                        checkpoint_path=str(tmp_path / "mesh.npz"))
    # checkpoint_path= (M13) runs: the solve of the plain sequence, its file
    # removed on convergence, its solution admitted.
    b = np.ones(128, np.float32)
    ck = str(tmp_path / "x.npz")
    rec = RecyclingCG(A, device=CPU, tol=1e-4 * float(np.linalg.norm(b)), maxiter=1024)
    res = rec.solve(b, checkpoint_path=ck, segment_iters=4)
    want = cg_solve(A, b, device=CPU, tol=1e-4 * float(np.linalg.norm(b)), maxiter=1024)
    assert bool(res.converged) and int(res.iterations) == int(want.iterations)
    assert torch.equal(res.x, want.x) and not os.path.exists(ck)
    assert rec._basis is not None and rec._basis.m == 1
    assert isinstance(RecyclingCG(A, device=CPU).op, DenseOperator)
