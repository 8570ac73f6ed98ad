"""tpucg_torch's pipelined CG (``method="pipelined"``, Ghysels-Vanroose)
against tpucg on the CPU: the serial cases of tpucg's
``tests/test_pipelined.py``, with the same NumPy inputs through both
packages' plain routes. Dense systems whose n is not a multiple of 128 go
to tpucg as ``tpucg_padded_dense`` (the port's padded operator). Laps are
held equal where the spectrum sets them and within one lap elsewhere;
x as ``_torch_helpers.held_to`` holds it (within 1e-5 of max |x| where
the laps are equal, or within tpucg's own error on an ill-conditioned
system: pipelined CG's recurrences carry rounding further than CG's)."""

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import (
    circulant_spd_batch,
    held_to,
    scaled_err,
    spd_kappa,
    tpucg_padded_dense,
)
from tpucg_torch.io.generator import fem_p1_system, generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.solver.cg import PIPE_REPLACE_EVERY, cg_solve
from tpucg_torch.solver.operators import EllOperator

CPU = torch.device("cpu")


def _both(A, b, x0=None, **kw):
    """The port's solve and tpucg's, of the same padded operator."""
    port = cg_solve(A, b, x0, device=CPU, method="pipelined", **kw)
    ref = tpucg.cg_solve(tpucg_padded_dense(A), b, x0, method="pipelined", **kw)
    return port, ref


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_pipelined_golden(g):
    port = cg_solve(g["A"], g["b"], g["x0"], device=CPU, method="pipelined")
    ref = tpucg.cg_solve(g["A"], g["b"], g["x0"], method="pipelined")
    assert int(port.iterations) == int(ref.iterations) == g["iters"]
    assert bool(port.converged) and bool(ref.converged)
    np.testing.assert_allclose(port.x.numpy(), g["x_star"], atol=2e-3)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5


@pytest.mark.parametrize("n, seed", [(128, 0), (192, 2), (256, 1)])
def test_pipelined_matches_classic_and_tpucg(n, seed):
    # Pipelined CG's recurrences drift in f32 (its attainable floor sits
    # above classic CG's), so the tolerance scales with ||b||, as tpucg's
    # distributed pipelined tests set it.
    A, b, x0 = generate_spd_system(n, seed=seed)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _both(A, b, x0, tol=tol)
    classic = cg_solve(A, b, x0, device=CPU, tol=tol)
    assert bool(port.converged)
    held_to(port, ref, 1)
    assert abs(int(port.iterations) - int(classic.iterations)) <= 1
    assert scaled_err(port.x.numpy(), classic.x.numpy()) <= 1e-4


def test_pipelined_at_the_reference_tolerance():
    # tpucg's classic comparison at the reference's absolute tol 1e-6 (n =
    # 128, ||b|| = 7.3) asks for 1.4e-7 relative: pipelined's recurrence
    # floor. The iterates up to it agree; whether the last lap lands under
    # tol is rounding (tpucg stops at 5 laps here and grinds at n = 256).
    A, b, x0 = generate_spd_system(128, seed=0)
    port, ref = _both(A, b, x0, maxiter=5)
    assert int(port.iterations) == int(ref.iterations) == 5
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5
    assert float(port.residual_norm) < 2e-6 and float(ref.residual_norm) < 2e-6
    A2, b2, x2 = generate_spd_system(256, seed=0)
    port, ref = _both(A2, b2, x2, maxiter=40)
    assert int(port.iterations) == int(ref.iterations) == 40
    assert not bool(port.converged) and not bool(ref.converged)
    assert float(port.residual_norm) < 1e-5 and float(ref.residual_norm) < 1e-5


def test_pipelined_spectrum_sets_the_laps():
    # A circulant system of m eigenvalue levels: CG ends in m laps.
    A, b, _ = circulant_spd_batch(6, 256, seed=3)
    for i in range(5):
        port, ref = _both(A[i], b[i], tol=1e-2)
        assert int(port.iterations) == int(ref.iterations) == 1 + i % 6
        assert bool(port.converged)
        assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5


def test_pipelined_many_iterations():
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 12.0) * np.eye(n)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _both(A, b, x0, tol=tol)
    classic = cg_solve(A, b, x0, device=CPU, tol=tol)
    assert int(classic.iterations) >= 10 and bool(port.converged)
    held_to(port, ref, 1, x_true=np.linalg.solve(A.astype(np.float64), b))
    assert abs(int(port.iterations) - int(classic.iterations)) <= 2
    assert np.linalg.norm(b - A @ port.x.numpy()) < 5 * tol


def test_pipelined_maxiter_cap_reports_honestly():
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 8.0) * np.eye(n)).astype(np.float32)
    port, ref = _both(A, b, x0, maxiter=3)
    assert int(port.iterations) == int(ref.iterations) == 3
    assert not bool(port.converged) and not bool(ref.converged)
    # Cut by the cap, the result reports the final r.r (not the last
    # lap-top test's).
    assert float(port.residual_norm) > 1e-6
    np.testing.assert_allclose(float(port.residual_norm), float(ref.residual_norm), rtol=1e-4)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5


def _scaled_system(n=96, seed=12):
    """tpucg's badly scaled system (``test_pipelined.py``): A0 = sym(R) +
    n I scaled by d = 10^U(-2, 2) on both sides; b = A x_true."""
    rng = np.random.default_rng(seed)
    R = rng.random((n, n))
    A0 = 0.5 * (R + R.T) + n * np.eye(n)
    d = 10.0 ** rng.uniform(-2, 2, n)
    A = ((A0 * d).T * d).astype(np.float32)
    x_true = rng.standard_normal(n)
    b = (A @ x_true).astype(np.float32)
    return A, b, x_true


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi"])
def test_pipelined_preconditioned_matches_tpucg(pc):
    # Preconditioned pipelined CG carries u = M^-1 r and q = M^-1 s, and
    # replaces its residual every PIPE_REPLACE_EVERY laps.
    A, b, x_true = _scaled_system()
    n = A.shape[0]
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=10 * n, precondition=pc, pc_block_size=16)
    port, ref = _both(A, b, **kw)
    assert bool(port.converged)
    held_to(port, ref, 1, x_true=x_true)
    classic = cg_solve(A, b, device=CPU, **kw)
    assert abs(int(port.iterations) - int(classic.iterations)) <= 2
    resid = np.linalg.norm(b.astype(np.float64) - A.astype(np.float64)
                           @ port.x.numpy().astype(np.float64))
    assert resid / np.linalg.norm(b) < 1e-4
    if pc == "jacobi":
        plain = cg_solve(A, b, device=CPU, method="pipelined", tol=tol, maxiter=10 * n)
        assert int(port.iterations) < int(plain.iterations)


@pytest.mark.parametrize("pc", ["jacobi", "poly"])
def test_pipelined_preconditioned_generator_system(pc):
    n = 128
    A, b, x0 = generate_spd_system(n, seed=3)
    port, ref = _both(A, b, x0, tol=1e-5 * float(np.linalg.norm(b)), precondition=pc,
                      poly_degree=2)
    assert bool(port.converged)
    held_to(port, ref, 1)


def test_pipelined_poly_on_the_scaled_system_fails_as_tpucg_does():
    # Pipelined PCG on the degree-2 Neumann polynomial of this system does
    # not converge in tpucg either: both grind to the cap.
    A, b, _ = _scaled_system()
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=300, precondition="poly",
              poly_degree=2)
    port, ref = _both(A, b, **kw)
    assert int(port.iterations) == int(ref.iterations) == 300
    assert not bool(port.converged) and not bool(ref.converged)


def test_preconditioned_pipelined_reports_true_residual():
    # Without replacement the preconditioned recurrence drifts away from the
    # true residual on an FEM Laplacian; with it (PIPE_REPLACE_EVERY = 25)
    # the reported residual tracks the true one.
    assert PIPE_REPLACE_EVERY == 25
    A, b, _ = fem_p1_system(2_000, seed=0)
    n = A.shape[0]
    tol = 1e-2 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=4 * n, precondition="jacobi", method="pipelined")
    port = cg_solve(EllOperator.from_csr(A, device=CPU), b, **kw)
    ref = tpucg.cg_solve(tpucg.EllOperator.from_csr(A), b, **kw)
    assert bool(port.converged) and bool(ref.converged)
    true_r = np.linalg.norm(b - A.matvec(port.x.numpy()[:n].astype(np.float64)))
    assert true_r <= 3.0 * max(float(port.residual_norm), tol / 3)
    # Hundreds of laps of an ill-conditioned mesh: the two trajectories round
    # apart; the lap counts stay within 2%.
    assert abs(int(port.iterations) - int(ref.iterations)) <= 0.02 * int(ref.iterations) + 1


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_pipelined_chunk_sizes_are_bit_identical(pc):
    # kappa 100 (and 1000 with Jacobi, whose laps pass two replacements).
    A, b = spd_kappa(200, 100.0 if pc == "none" else 1000.0, seed=2)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=2000, precondition=pc,
              method="pipelined")
    runs = [cg_solve(A, b, device=CPU, chunk=c, **kw) for c in (None, 1, 3, 64)]
    assert bool(runs[0].converged)
    assert int(runs[0].iterations) > 2 * PIPE_REPLACE_EVERY or pc == "none"
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f
