"""tpucg_torch's spectral intervals against tpucg on the CPU: the
two-sided power method (``spectral_interval_estimate``, the public
``spectral_interval``, ``lambda_max_estimate(absolute=)``) within 1e-4
relative on the same operators, and the cases of tpucg's
``tests/test_interval.py`` that run serially: a cached ``interval=`` is
used by CA and Chebyshev solves, tolerates a padded interval, and is
refused by the other methods."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpucg
import tpucg_torch
from _torch_helpers import held_to, random_banded_dia, tpucg_padded_dense
from tpucg.kernels.blas1 import dot_xla
from tpucg.solver.cg import lambda_max_estimate as j_lambda_max_estimate
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.solver.cg import cg_solve, lambda_max_estimate, spectral_interval
from tpucg_torch.solver.operators import DiaOperator, PoissonOperator
from tpucg_torch.sparse.formats import DIAMatrix

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def system():
    # n = 256: no identity tail, so tpucg's own dense operator is the port's
    # (the padded case is below).
    A, b, x0 = generate_spd_system(256, seed=3)
    lam_lo, lam_hi, _ = spectral_interval(A, device=CPU)
    return A, b, x0, (lam_lo, lam_hi)


def _close(got, want, rtol=1e-4):
    for g, w in zip(got, want):
        assert abs(g - w) <= rtol * abs(w), (got, want)


@pytest.mark.parametrize("n, seed", [(192, 3), (256, 0), (96, 4)])
def test_spectral_interval_dense_matches_tpucg(n, seed):
    A, _, _ = generate_spd_system(n, seed=seed)
    got = spectral_interval(A, device=CPU)
    _close(got, tpucg.spectral_interval(tpucg_padded_dense(A)))
    if n % 128 == 0:  # no padding: tpucg's own dense operator is the same one
        _close(got, tpucg.spectral_interval(A))
    assert 0 < got[0] <= got[1] and got[2] == pytest.approx(got[1] / got[0])


@pytest.mark.parametrize("m", [6, 12])
def test_spectral_interval_poisson_matches_tpucg(m):
    got = spectral_interval(PoissonOperator(m, device=CPU))
    _close(got, tpucg.spectral_interval(JPoissonOperator(m=m, kernel="xla")))


def test_spectral_interval_dia_matches_tpucg():
    offsets, data, _ = random_banded_dia(200, (-3, -1, 0, 1, 3), seed=2)
    dia = DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(200, 200))
    got = spectral_interval(DiaOperator.from_dia(dia, device=CPU))
    jdia = tpucg.sparse.formats.DIAMatrix(offsets=np.asarray(offsets), data=data,
                                           shape=(200, 200))
    # backend="auto" pads as the port pads (an identity tail to 256; "xla"
    # keeps n = 200) and packs the slab interleaved; its product on the CPU
    # is XLA's.
    jop = tpucg.solver.operators.DiaOperator.from_dia(jdia, backend="auto")
    assert jop.padded_n == 256
    _close(got, tpucg.spectral_interval(jop))


def test_spectral_interval_is_exported():
    assert tpucg_torch.spectral_interval is spectral_interval
    assert "spectral_interval" in tpucg_torch.__all__


@pytest.mark.parametrize("absolute", [False, True])
def test_lambda_max_estimate_absolute_matches_tpucg(absolute):
    # An indefinite operator (A - 2 mu I, dominant eigenvalue negative): the
    # signed Rayleigh quotient, or with absolute= its magnitude.
    A, _, _ = generate_spd_system(128, seed=1)
    A = (A - 3.0 * 128 * np.eye(128)).astype(np.float32)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    got = lambda_max_estimate(lambda v, act=None: At @ v, lambda u, v, act=None: torch.dot(u, v),
                              torch.zeros(128), 16, absolute=absolute)
    want = j_lambda_max_estimate(lambda v: jnp.dot(Aj, v, precision="highest"), dot_xla,
                                 jnp.zeros(128, jnp.float32), 16, absolute=absolute)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert (float(got) > 1.0) == absolute


@pytest.mark.parametrize("method", ["ca", "chebyshev"])
def test_serial_interval_matches_estimated(system, method):
    A, b, x0, iv = system
    cold = cg_solve(A, b, x0, device=CPU, method=method, maxiter=800)
    warm = cg_solve(A, b, x0, device=CPU, method=method, maxiter=800, interval=iv)
    assert bool(warm.converged)
    # The same estimator gives the same interval: the laps cannot degrade.
    assert int(warm.iterations) <= int(cold.iterations)
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), rtol=1e-3, atol=1e-5)
    ref = tpucg.cg_solve(A, b, x0, method=method, maxiter=800, interval=iv)
    held_to(warm, ref, 3 if method == "ca" else 8)


@pytest.mark.parametrize("method", ["ca", "chebyshev"])
def test_padded_operator_interval(method):
    # n = 192 pads to 256: the identity tail's eigenvalue 1 is in the
    # power method's seed, so lam_lo is ~1 in both packages (tpucg's
    # unpadded operator: ~190), and Chebyshev's rate is the wide interval's.
    # Its lap count is then set by the f32 floor of a long trajectory
    # (tpucg's own takes 704 laps cold and 1,056 with the cached interval):
    # x is held, the laps are not.
    A, b, x0 = generate_spd_system(192, seed=3)
    iv = spectral_interval(A, device=CPU)
    assert iv[0] < 1.01 and tpucg.spectral_interval(A)[0] > 100
    kw = dict(method=method, maxiter=3000, interval=iv[:2])
    port = cg_solve(A, b, x0, device=CPU, **kw)
    ref = tpucg.cg_solve(tpucg_padded_dense(A), b, x0, **kw)
    assert bool(port.converged) and bool(ref.converged)
    if method == "ca":
        held_to(port, ref, 3)
    else:
        assert int(port.iterations) > 300 and int(ref.iterations) > 300
    assert np.abs(port.x.numpy() - np.asarray(ref.x)).max() <= 1e-5 * np.abs(ref.x).max()


def test_serial_interval_tolerates_padding(system):
    # A widened interval: CA's basis conditioning changes, its result not.
    A, b, x0, (lo, hi) = system
    r = cg_solve(A, b, x0, device=CPU, method="ca", maxiter=800, interval=(0.5 * lo, 1.5 * hi))
    ref = tpucg.cg_solve(A, b, x0, method="ca", maxiter=800, interval=(0.5 * lo, 1.5 * hi))
    assert bool(r.converged)
    held_to(r, ref, 3)
    assert np.linalg.norm(b - A @ r.x.numpy()) < 5e-6


@pytest.mark.parametrize("method", ["cg", "pipelined"])
def test_interval_requires_ca_or_chebyshev(system, method):
    A, b, x0, iv = system
    with pytest.raises(ValueError, match="interval"):
        cg_solve(A, b, x0, device=CPU, method=method, interval=iv)


@pytest.mark.parametrize("method", ["ca", "chebyshev"])
def test_operator_interval(method):
    # Poisson on the stencil operator: one spectral_interval call, reused.
    m = 12
    op = PoissonOperator(m, device=CPU)
    b = np.random.default_rng(5).standard_normal(op.n).astype(np.float32)
    lam_lo, lam_hi, _ = spectral_interval(op)
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(method=method, tol=tol, maxiter=4 * op.n)
    cold = cg_solve(op, b, **kw)
    warm = cg_solve(op, b, interval=(lam_lo, lam_hi), **kw)
    assert bool(warm.converged)
    assert int(warm.iterations) <= int(cold.iterations) + 8
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), rtol=1e-3, atol=1e-4)
    ref = tpucg.cg_solve(JPoissonOperator(m=m, kernel="xla"), b, interval=(lam_lo, lam_hi),
                         **kw)
    held_to(warm, ref, 3 if method == "ca" else 8)
