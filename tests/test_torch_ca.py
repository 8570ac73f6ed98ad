"""tpucg_torch's communication-avoiding s-step CG (``method="ca"``) against
tpucg on the CPU: the serial cases of tpucg's ``tests/test_ca.py``, the same
NumPy inputs through both packages' plain routes (dense systems to tpucg as
``tpucg_padded_dense``, the port's padded operator, whose identity tail
enters the basis interval). Laps are held equal where the spectrum sets
them and within one block (s laps) elsewhere; x within 1e-5 of max |x|
where the laps are equal (``_torch_helpers.held_to``)."""

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import circulant_spd_batch, held_to, scaled_err, tpucg_padded_dense
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import PoissonOperator

CPU = torch.device("cpu")


def _both(A, b, x0=None, **kw):
    port = cg_solve(A, b, x0, device=CPU, method="ca", **kw)
    ref = tpucg.cg_solve(tpucg_padded_dense(A), b, x0, method="ca", **kw)
    return port, ref


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_ca_golden(g):
    # tpucg's bound: near the absolute 1e-6 floor a block's tentative stop
    # can be refuted by the exact check and the safe restart finishes (its
    # unpadded 4x4 takes 6 laps).
    n = g["A"].shape[0]
    port = cg_solve(g["A"], g["b"], g["x0"], device=CPU, method="ca", maxiter=4 * n)
    ref = tpucg.cg_solve(g["A"], g["b"], g["x0"], method="ca", maxiter=4 * n)
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) <= g["iters"] + 2
    assert abs(int(port.iterations) - int(ref.iterations)) <= 3
    np.testing.assert_allclose(port.x.numpy(), g["x_star"], atol=2e-3)


@pytest.mark.parametrize("s_step", [1, 2, 3, 4])
def test_ca_matches_classic_clustered_spectrum(s_step):
    A, b, x0 = generate_spd_system(128, seed=0)
    port, ref = _both(A, b, x0, s_step=s_step)
    classic = cg_solve(A, b, x0, device=CPU)
    assert bool(port.converged)
    held_to(port, ref, s_step)
    assert abs(int(port.iterations) - int(classic.iterations)) <= 1
    np.testing.assert_allclose(port.x.numpy(), classic.x.numpy(), rtol=1e-4, atol=1e-6)
    # residual_norm is the exact block-end ||r||.
    resid = np.linalg.norm(b - A @ port.x.numpy())
    assert abs(float(port.residual_norm) - resid) < 5e-6 + 0.5 * resid


def test_ca_spectrum_sets_the_laps():
    A, b, _ = circulant_spd_batch(6, 256, seed=3)
    for i in range(5):
        port, ref = _both(A[i], b[i], tol=1e-2, s_step=3)
        assert int(port.iterations) == int(ref.iterations) == 1 + i % 6
        assert bool(port.converged)
        assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5


def test_ca_spread_spectrum_many_iterations():
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 12.0) * np.eye(n)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _both(A, b, x0, s_step=3, tol=tol)
    classic = cg_solve(A, b, x0, device=CPU, tol=tol)
    assert int(classic.iterations) >= 10 and bool(port.converged)
    held_to(port, ref, 3)
    assert abs(int(port.iterations) - int(classic.iterations)) <= 3
    assert np.linalg.norm(b - A @ port.x.numpy()) < 5 * tol


def test_ca_maxiter_cap_reports_honestly():
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 8.0) * np.eye(n)).astype(np.float32)
    port, ref = _both(A, b, x0, s_step=3, maxiter=4)
    # k never passes maxiter, even inside a block.
    assert int(port.iterations) == int(ref.iterations) == 4
    assert not bool(port.converged) and not bool(ref.converged)
    assert float(port.residual_norm) > 1e-6
    np.testing.assert_allclose(float(port.residual_norm), float(ref.residual_norm), rtol=1e-3)


def test_ca_s1_degenerates_to_verified_cg():
    A, b, x0 = generate_spd_system(64, seed=7)
    port, ref = _both(A, b, x0, s_step=1)
    classic = cg_solve(A, b, x0, device=CPU)
    assert bool(port.converged)
    held_to(port, ref, 1)
    assert abs(int(port.iterations) - int(classic.iterations)) <= 1


def test_ca_scalar_identity_operator():
    # A = 3 I, padded: its identity tail adds the eigenvalue 1. The port's
    # Gram (f64 sums, rounded to f32) resolves lap 1's residual below tol:
    # 1 lap, as tpucg's unpadded operator takes; tpucg's f32 Gram of the
    # padded operator leaves it above tol and runs the block out (3 laps).
    n = 32
    A = (3.0 * np.eye(n)).astype(np.float32)
    b = np.linspace(1, 2, n).astype(np.float32)
    port, ref = _both(A, b, s_step=3)
    assert bool(port.converged) and int(port.iterations) <= 3
    held_to(port, ref, 3)
    assert int(port.iterations) == int(tpucg.cg_solve(A, b, method="ca").iterations) == 1
    np.testing.assert_allclose(port.x.numpy(), b / 3.0, rtol=1e-5)


def test_ca_gram_sums_in_float64():
    # The first block's towers both start from p = r: its Gram is singular,
    # and the coordinate laps follow its rounding. Summed in f32 (torch's
    # order) this padded system diverged (||r|| 2e32 by lap 60) where tpucg
    # converged in 4 laps; the f64-summed Gram converges in 3.
    from tpucg_torch.solver.cg import gram_f32

    V = torch.from_numpy(np.random.default_rng(0).standard_normal((1000, 7)).astype(np.float32))
    want = (V.double().T @ V.double()).float()
    assert torch.equal(gram_f32(V), want) and gram_f32(V).dtype == torch.float32
    A, b, x0 = generate_spd_system(1000, seed=2)
    port, ref = _both(A, b, x0, s_step=3, tol=1e-5 * float(np.linalg.norm(b)), maxiter=60)
    assert bool(port.converged) and bool(ref.converged)
    held_to(port, ref, 3)


def test_ca_exactly_scalar_operator():
    # A = 51.2 I, unpadded (n = 256): a zero-width spectrum. The width floor
    # keeps the basis finite, and the first lap solves it.
    A, b, _ = circulant_spd_batch(1, 256, seed=3)
    assert np.array_equal(A[0], 51.2 * np.eye(256, dtype=np.float32))
    port, ref = _both(A[0], b[0], s_step=3)
    assert int(port.iterations) == int(ref.iterations) == 1
    assert bool(port.converged) and torch.isfinite(port.x).all()
    np.testing.assert_allclose(port.x.numpy(), b[0] / np.float32(51.2), rtol=1e-5)


def test_ca_poisson_operator():
    # The spread Poisson spectrum on the stencil operator (tpucg's serial
    # reference of its sharded CA case).
    m = 8
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.array(JPoissonOperator(m=m, kernel="xla").matvec(x_true))
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=4 * m ** 3, method="ca", s_step=3)
    port = cg_solve(PoissonOperator(m, device=CPU), b, **kw)
    ref = tpucg.cg_solve(JPoissonOperator(m=m, kernel="xla"), b, **kw)
    classic = cg_solve(PoissonOperator(m, device=CPU), b, tol=tol, maxiter=4 * m ** 3)
    assert bool(port.converged)
    held_to(port, ref, 3)
    assert abs(int(port.iterations) - int(classic.iterations)) <= 3
    np.testing.assert_allclose(port.x.numpy(), x_true, atol=1e-3)


def test_ca_config_validation():
    with pytest.raises(ValueError, match="s_step"):
        CGConfig(s_step=0)
    with pytest.raises(ValueError, match="precondition"):
        CGConfig(method="ca", precondition="jacobi")
    A, b, x0 = generate_spd_system(32, seed=0)
    with pytest.raises(ValueError, match="record_residuals"):
        cg_solve(A, b, x0, device=CPU, method="ca", record_residuals=True)


def test_ca_chunk_sizes_are_bit_identical():
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 12.0) * np.eye(n)).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), method="ca", s_step=3)
    runs = [cg_solve(A, b, x0, device=CPU, chunk=c, **kw) for c in (None, 1, 5, 64)]
    assert int(runs[0].iterations) >= 10
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f
