"""The port's two-level and multilevel preconditioner (``solver/twolevel.py``)
against tpucg's, on the CPU: the serial cases of tpucg's
``tests/test_twolevel.py``. The same seeded NumPy systems (the FEM P1 mesh
Laplacian, the geometric graph) go through both packages' builds and
solves. Two-level solves stop on the true residual every 16 laps in both, so
their laps are held equal; x within 1e-4 of max |x|. tpucg's cycle carried
into the port (``interop.two_level_from_numpy``) gives the port's cycle on
the same vector within f32 rounding, and the built hierarchies agree level
by level."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpucg
from tpucg.kernels.blas1 import dot_xla
from tpucg.solver.twolevel import make_two_level_precond as j_make_two_level_precond

from _torch_helpers import scaled_err
from tpucg_torch.interop import (
    two_level_from_numpy,
    well_operator_from_numpy,
)
from tpucg_torch.io.generator import fem_p1_system, random_geometric_spd
from tpucg_torch.solver.cg import TRUE_CHECK_EVERY, cg_solve, lap_ops
from tpucg_torch.solver.operators import EllOperator, WellOperator
from tpucg_torch.solver.twolevel import TwoLevel, build_two_level, make_two_level_precond
from tpucg_torch.sparse.formats import COOMatrix

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fem():
    A, b, _ = fem_p1_system(6_000, seed=0)
    return A, b


def _both(A, b, op, jop, agg, tol, **kw):
    """Each package's two-level solve of the same system, each with its own
    build for its operator's padding."""
    build_kw = {k: kw.pop(k) for k in ("smooth_degree", "coarse_max") if k in kw}
    tl = build_two_level(A, agg_size=agg, npad=op.padded_n, device=CPU, **build_kw)
    jtl = tpucg.build_two_level(A, agg_size=agg, npad=jop.padded_n, **build_kw)
    port = cg_solve(op, b, tol=tol, maxiter=4 * A.shape[0], two_level=tl, **kw)
    ref = tpucg.cg_solve(jop, b, tol=tol, maxiter=4 * A.shape[0], two_level=jtl, **kw)
    return port, ref, tl, jtl


def test_two_level_matches_tpucg_on_fem(fem):
    # Above the n = 6k FEM true-residual floor (~4e-4 ||b||), as tpucg's test.
    A, b = fem
    tol = 1e-3 * float(np.linalg.norm(b))
    port, ref, tl, _ = _both(A, b, EllOperator.from_csr(A, device=CPU),
                             tpucg.EllOperator.from_csr(A), 32, tol)
    assert bool(port.converged) and bool(ref.converged)
    k = int(port.iterations)
    assert k == int(ref.iterations) and k % TRUE_CHECK_EVERY == 0
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4
    assert float(port.residual_norm) < tol
    assert tl.levels == 1 and tl.nc == -(-tl.npad // 32)


def test_two_level_halves_jacobi_laps(fem):
    A, b = fem
    op = EllOperator.from_csr(A, device=CPU)
    tol = 1e-3 * float(np.linalg.norm(b))
    jac = cg_solve(op, b, tol=tol, maxiter=4 * A.shape[0], precondition="jacobi")
    tl = build_two_level(A, agg_size=32, npad=op.padded_n, device=CPU)
    two = cg_solve(op, b, tol=tol, maxiter=4 * A.shape[0], two_level=tl)
    assert bool(two.converged) and bool(jac.converged)
    assert int(two.iterations) * 2 <= int(jac.iterations)


@pytest.mark.parametrize("form", ["jacobi", "chebyshev", "pipelined"])
def test_two_level_forms_match_tpucg(fem, form):
    # The Chebyshev smoother (degree 2) under classic PCG, and the damped
    # Jacobi cycle under pipelined PCG (replacement every 25 laps; its
    # convergence test is a lap late, so its laps are held within one).
    A, b = fem
    tol = 1e-3 * float(np.linalg.norm(b))
    kw = {"chebyshev": dict(smooth_degree=2), "pipelined": dict(method="pipelined"),
          "jacobi": {}}[form]
    port, ref, _, _ = _both(A, b, EllOperator.from_csr(A, device=CPU),
                            tpucg.EllOperator.from_csr(A), 32, tol, **kw)
    assert bool(port.converged) and bool(ref.converged)
    within = 1 if form == "pipelined" else 0
    assert abs(int(port.iterations) - int(ref.iterations)) <= within
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_two_level_on_well_operator():
    # tpucg's test runs n = 20,000; 12,000 keeps the case (the graph's
    # two-level laps against Jacobi's) at 60% of the plain WELL products.
    A, b, _ = random_geometric_spd(12_000, seed=0, avg_degree=12.0, shift=0.05)
    op = WellOperator.from_csr(A, device=CPU)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref, tl, _ = _both(A, b, op, tpucg.WellOperator.from_csr(A), 64, tol)
    assert tl.npad == op.padded_n
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4
    jac = cg_solve(op, b, tol=tol, maxiter=4 * A.shape[0], precondition="jacobi")
    assert int(port.iterations) < int(jac.iterations)


def _carry(jtl) -> TwoLevel:
    """tpucg's TwoLevel (recursively) as the port's, through the interop."""
    def fields(t):
        f = {name: np.asarray(getattr(t, name)) for name in
             ("acinv", "dinv", "agg", "npad", "omega", "smooth_degree", "smooth_alpha",
              "coarse_cycles")}
        if t.inner is not None:
            c = t.coarse_op
            assert type(c).__name__ == "WellOperator"
            f["coarse_op"] = well_operator_from_numpy(
                *(np.asarray(getattr(c, k)) for k in ("vals", "lidx", "gidl", "wrow", "sgb",
                                                      "dvec")), n=c.n, bg=c.bg, nsg=c.nsg)
            f["inner"] = fields(t.inner)
        return f
    return two_level_from_numpy(fields(jtl))


@pytest.mark.parametrize("agg, coarse_max", [(32, None), (4, 64)], ids=["dense", "multilevel"])
def test_cycle_and_hierarchy_equal_tpucgs(agg, coarse_max):
    # The builds agree level by level (sizes, the coarse operators' class,
    # the dense inverse within f32), and the port's cycle, on tpucg's carried
    # hierarchy and on its own, equals tpucg's on the same r within 1e-5 of
    # max |z|.
    A, b, _ = fem_p1_system(1_500, seed=1)
    op = EllOperator.from_csr(A, device=CPU)
    jop = tpucg.EllOperator.from_csr(A)
    tl = build_two_level(A, agg_size=agg, npad=op.padded_n, coarse_max=coarse_max, device=CPU)
    jtl = tpucg.build_two_level(A, agg_size=agg, npad=jop.padded_n, coarse_max=coarse_max)
    assert tl.levels == jtl.levels == (1 if coarse_max is None else 2)
    t, j = tl, jtl
    while t is not None:
        assert (t.nc, t.agg, t.npad) == (j.nc, j.agg, j.npad)
        assert type(t.coarse_op).__name__ == type(j.coarse_op).__name__
        np.testing.assert_array_equal(t.dinv.numpy(), np.asarray(j.dinv))
        np.testing.assert_allclose(t.acinv.numpy(), np.asarray(j.acinv), rtol=1e-5, atol=1e-6)
        t, j = t.inner, j.inner
    r = np.random.default_rng(7).standard_normal(op.padded_n).astype(np.float32)
    matvec, dot, _ = lap_ops(op, "torch")
    jz = np.asarray(j_make_two_level_precond(jtl, jop.matvec, dot_xla, jnp.asarray(r))(
        jnp.asarray(r)))
    for built in (tl, _carry(jtl)):
        z = make_two_level_precond(built, matvec, dot, torch.from_numpy(r))(torch.from_numpy(r))
        assert scaled_err(z.numpy(), jz) <= 1e-5


@pytest.mark.parametrize("coarse_max", [None, 64], ids=["dense", "multilevel"])
def test_two_level_cycle_is_spd(coarse_max):
    # PCG needs M fixed and SPD: B = precond(I), materialized a column at a
    # time, is symmetric with positive eigenvalues: the Chebyshev-smoothed
    # cycle, and the multilevel form with its inner cycles (on a smaller
    # mesh: each column runs the plain WELL product of the coarse level).
    A, _, _ = fem_p1_system(600 if coarse_max else 900, seed=1)
    op = EllOperator.from_csr(A, device=CPU)
    n = op.padded_n
    tl = build_two_level(A, agg_size=2 if coarse_max else 32, npad=n, coarse_max=coarse_max,
                         smooth_degree=1 if coarse_max else 2, device=CPU)
    assert tl.levels == (2 if coarse_max else 1)
    matvec, dot, _ = lap_ops(op, "torch")
    pc = make_two_level_precond(tl, matvec, dot, torch.zeros(n))
    eye = torch.eye(n)
    B = torch.stack([pc(eye[i]) for i in range(n)], dim=1).double().numpy()
    assert np.abs(B - B.T).max() <= 1e-5 * np.abs(B).max()
    assert np.linalg.eigvalsh(0.5 * (B + B.T)).min() > 0


def test_multilevel_solve_matches_tpucg(fem):
    A, b = fem
    tol = 1e-3 * float(np.linalg.norm(b))
    port, ref, tl, jtl = _both(A, b, EllOperator.from_csr(A, device=CPU),
                               tpucg.EllOperator.from_csr(A), 8, tol, coarse_max=64)
    assert tl.levels == jtl.levels == 2 and tl.inner.nc == jtl.inner.nc
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_two_level_validation(fem):
    A, b = fem
    op = EllOperator.from_csr(A, device=CPU)
    tl = build_two_level(A, agg_size=32, npad=op.padded_n, device=CPU)
    with pytest.raises(ValueError, match="padded size"):
        bad = build_two_level(A, agg_size=32, npad=op.padded_n + 128, device=CPU)
        cg_solve(op, b, two_level=bad)
    with pytest.raises(ValueError, match="method='cg'"):
        cg_solve(op, b, two_level=tl, method="chebyshev")
    with pytest.raises(ValueError, match="precondition"):
        cg_solve(op, b, two_level=tl, precondition="jacobi")
    with pytest.raises(ValueError, match="float32"):
        cg_solve(op, b, two_level=tl, dtype=torch.float64)
    with pytest.raises(ValueError, match="agg_size"):
        build_two_level(A, agg_size=1, device=CPU)
    with pytest.raises(ValueError, match="smooth_degree"):
        build_two_level(A, smooth_degree=0, device=CPU)
    with pytest.raises(ValueError, match="square"):
        build_two_level(COOMatrix(row=np.array([0]), col=np.array([0]),
                                  data=np.array([1.0], np.float32), shape=(2, 3)).to_csr(),
                        device=CPU)
    # tpucg's dense-inverse floor: coarse_max below 256 still stops at 256.
    assert build_two_level(A, agg_size=32, npad=op.padded_n, coarse_max=8,
                           device=CPU).levels == 1
