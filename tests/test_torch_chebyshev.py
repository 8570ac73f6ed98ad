"""tpucg_torch's Chebyshev iteration (``method="chebyshev"``) against tpucg
on the CPU: the serial cases of tpucg's ``tests/test_chebyshev.py``, the
same NumPy inputs through both packages' plain routes (dense systems to
tpucg as ``tpucg_padded_dense``, the port's padded operator, whose identity
tail enters the interval). Laps are held within one check (``check_every``
laps), x within 1e-5 of max |x| where the laps are equal, or within
tpucg's own error on an ill-conditioned system (``_torch_helpers.held_to``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpucg
from _torch_helpers import held_to, laplacian1d, scaled_err, tpucg_padded_dense
from tpucg.kernels.blas1 import dot_xla
from tpucg.solver.cg import chebyshev_loop as j_chebyshev_loop
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.solver.cg import cg_solve, chebyshev_loop
from tpucg_torch.solver.operators import PoissonOperator

CPU = torch.device("cpu")


def _both(A, b, x0=None, **kw):
    port = cg_solve(A, b, x0, device=CPU, method="chebyshev", **kw)
    ref = tpucg.cg_solve(tpucg_padded_dense(A), b, x0, method="chebyshev", **kw)
    return port, ref


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_chebyshev_golden(g):
    port, ref = _both(g["A"], g["b"], g["x0"], maxiter=256)
    assert bool(port.converged)
    held_to(port, ref, 8)
    resid = np.linalg.norm(g["b"] - g["A"] @ port.x.numpy())
    assert resid < 2e-6
    np.testing.assert_allclose(port.x.numpy(), g["x_star"], atol=2e-3)


def test_chebyshev_clustered_spectrum():
    A, b, x0 = generate_spd_system(128, seed=0)
    port, ref = _both(A, b, x0, maxiter=512)
    classic = cg_solve(A, b, x0, device=CPU)
    assert bool(port.converged)
    assert int(port.iterations) == int(ref.iterations)
    held_to(port, ref, 8)
    np.testing.assert_allclose(port.x.numpy(), classic.x.numpy(), rtol=1e-4, atol=1e-5)
    # residual_norm is the exact chunk-end ||r||.
    resid = np.linalg.norm(b - A @ port.x.numpy())
    assert abs(float(port.residual_norm) - resid) < 5e-6 + 0.5 * resid


def test_chebyshev_poisson_needs_more_laps_than_cg():
    m = 8
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    b = np.array(JPoissonOperator(m=m, kernel="xla").matvec(x_true))
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=8 * m ** 3, method="chebyshev")
    port = cg_solve(PoissonOperator(m, device=CPU), b, **kw)
    ref = tpucg.cg_solve(JPoissonOperator(m=m, kernel="xla"), b, **kw)
    cg = cg_solve(PoissonOperator(m, device=CPU), b, tol=tol, maxiter=8 * m ** 3)
    assert bool(port.converged)
    held_to(port, ref, 8)
    assert int(port.iterations) >= int(cg.iterations)
    np.testing.assert_allclose(port.x.numpy(), x_true, atol=1e-3)


def test_chebyshev_check_cadence_and_cap():
    A, b, x0 = generate_spd_system(96, seed=4)
    port, ref = _both(A, b, x0, check_every=8, maxiter=512)
    assert bool(port.converged) and int(port.iterations) % 8 == 0
    held_to(port, ref, 8)
    one, ref1 = _both(A, b, x0, check_every=1, maxiter=512)
    assert bool(one.converged) and int(one.iterations) <= int(port.iterations)
    held_to(one, ref1, 1)
    # The cap stops laps inside a chunk: k never passes maxiter.
    cap, refc = _both(A, b, x0, check_every=8, maxiter=3, tol=1e-30)
    assert int(cap.iterations) == int(refc.iterations) == 3
    assert not bool(cap.converged)
    assert scaled_err(cap.x.numpy(), np.asarray(refc.x)) <= 1e-5


@pytest.mark.parametrize("pc", ["jacobi", "poly", "block_jacobi"])
def test_chebyshev_preconditioned(pc):
    # Chebyshev on M^-1 A (its interval estimated on the preconditioned
    # operator); laps stay dot-free. Jacobi on a badly scaled system, poly
    # and block Jacobi on a 1-D Laplacian.
    n = 256
    if pc == "jacobi":
        rng = np.random.default_rng(7)
        A, b, _ = generate_spd_system(n, seed=7)
        d = np.exp(rng.uniform(0.0, np.log(30.0), n)).astype(np.float32)
        A = (A * d[:, None] * d[None, :]).astype(np.float32)
    else:
        A = laplacian1d(n)
        b = np.cos(np.arange(n) * 0.3).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=64 * n, precondition=pc, poly_degree=2, pc_block_size=32)
    port, ref = _both(A, b, **kw)
    assert bool(port.converged)
    held_to(port, ref, 8, x_true=np.linalg.solve(A.astype(np.float64), b))
    plain = cg_solve(A, b, device=CPU, method="chebyshev", tol=tol, maxiter=64 * n)
    if bool(plain.converged):
        assert int(port.iterations) <= int(plain.iterations)
    assert np.linalg.norm(b - A @ port.x.numpy()) < 5 * tol


def _loops(A, b, tol, power_iters, maxiter=4096, check_every=4):
    """The port's and tpucg's ``chebyshev_loop`` on one dense f32 A."""
    At = torch.from_numpy(A)
    port = chebyshev_loop(lambda v, act=None: At @ v, lambda u, v, act=None: torch.dot(u, v),
                          torch.from_numpy(b), torch.zeros(len(b)), tol=tol, maxiter=maxiter,
                          check_every=check_every, power_iters=power_iters)
    Aj = jnp.asarray(A)
    ref = j_chebyshev_loop(lambda v: jnp.dot(Aj, v, precision="highest"), dot_xla,
                           jnp.asarray(b), jnp.zeros(len(b), jnp.float32), tol=tol,
                           maxiter=maxiter, check_every=check_every, power_iters=power_iters)
    return port, ref


def test_chebyshev_bad_interval_guard_recovers():
    # power_iters=1 gives a garbage interval; the chunk guard (re-anchor,
    # widen on divergence) must still converge the solve.
    n = 128
    A, b, _ = generate_spd_system(n, seed=3)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _loops(A, b, tol, power_iters=1)
    assert bool(port.done) and bool(ref.done)
    assert abs(int(port.k) - int(ref.k)) <= 4
    assert np.linalg.norm(b - A @ port.x.numpy()) < 5e-5 * float(np.linalg.norm(b))


@pytest.mark.parametrize("power_iters", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_chebyshev_guard_fuzz(power_iters, seed):
    # Starved interval estimates on log-spread spectra (3 decades) converge
    # through the widen-and-restart guard.
    n = 96
    rng = np.random.default_rng(seed)
    w = np.exp(rng.uniform(np.log(1e-2), np.log(10.0), n))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * w) @ Q.T
    A = (0.5 * (A + A.T)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    port, ref = _loops(A, b, tol, power_iters, maxiter=65536)
    assert bool(port.done) and bool(ref.done), (float(port.rslast), float(ref.rslast))
    assert np.linalg.norm(b - A.astype(np.float64) @ port.x.numpy()) < 10 * tol
    # The guard's path is rounding-sensitive (when a chunk stalls, how far
    # the interval widens): the two loops end within 10% of each other.
    assert abs(int(port.k) - int(ref.k)) <= 0.1 * int(ref.k) + 4


def test_chebyshev_scalar_identity_operator():
    # A = 3 I: the safety pads open a deliberate [0.75 c, 1.1 c] interval.
    n = 32
    A = (3.0 * np.eye(n)).astype(np.float32)
    b = np.linspace(1, 2, n).astype(np.float32)
    port, ref = _both(A, b, check_every=1, maxiter=64)
    assert bool(port.converged) and int(port.iterations) <= 16
    held_to(port, ref, 1)
    np.testing.assert_allclose(port.x.numpy(), b / 3.0, rtol=1e-5)


def test_chebyshev_config_validation():
    with pytest.raises(ValueError, match="check_every"):
        CGConfig(check_every=0)
    A, b, x0 = generate_spd_system(32, seed=0)
    with pytest.raises(ValueError, match="record_residuals"):
        cg_solve(A, b, x0, device=CPU, method="chebyshev", record_residuals=True)


def test_chebyshev_chunk_sizes_are_bit_identical():
    A, b, x0 = generate_spd_system(96, seed=4)
    kw = dict(method="chebyshev", maxiter=512, check_every=4)
    runs = [cg_solve(A, b, x0, device=CPU, chunk=c, **kw) for c in (None, 1, 9, 64)]
    assert int(runs[0].iterations) > 8
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f
