"""``cg_loop``'s periodic modes against tpucg's, on the CPU: true-residual
stopping (``check_true_every``) with its guarded finish and stagnation exit,
the stagnation carry across calls (``stag_carry``/``return_stag``) and
residual replacement (``replace_every``). The same seeded NumPy inputs go
through tpucg's ``cg_loop`` (XLA on the CPU) and the port's (the plain
route, ``lap_ops(op, "torch")``). Laps are held equal (they quantize to the
check cadence, or the spectrum sets them), x within 1e-4 of max |x| (1e-5
where the laps are few); the guarded finish's plain versions equal its NumPy
emulation bit for bit, which the card tests hold K3 and K2 to."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
import tpucg
from tpucg.kernels.blas1 import dot_xla
from tpucg.kernels.blas1 import fused_update as j_fused_update
from tpucg.solver.cg import cg_loop as j_cg_loop

from _torch_helpers import (
    alpha_emulated,
    lap_tail_emulated,
    scaled_err,
    spd_kappa,
    tpucg_padded_dense,
)
from tpucg_torch.io.generator import fem_p1_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.kernels.blas1 import FLT_MIN, LapTail, alpha_torch, lap_tail_torch
from tpucg_torch.solver.cg import (
    TRUE_CHECK_EVERY,
    StagCarry,
    cg_loop,
    cg_solve,
    init_state,
    lap_ops,
)
from tpucg_torch.solver.operators import DenseOperator, best_sparse_operator
from tpucg_torch.solver.twolevel import build_two_level

CPU = torch.device("cpu")


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


# ---- the guarded finish, plain versions against the emulation ----------------


@pytest.mark.parametrize("pap", [2.0, 0.0, -0.0, -3.0, float("nan")],
                         ids=["pos", "zero", "negzero", "neg", "nan"])
def test_guarded_alpha_equals_the_emulation(pap):
    rsold = torch.tensor(1.7)
    p = torch.tensor(pap)
    for safe, guard, rule in ((False, False, 0), (True, False, 1), (True, True, 2)):
        got = alpha_torch(p, rsold, safe, guard)
        assert _bits(got.numpy()) == _bits(alpha_emulated(pap, 1.7, rule))
    # Without safe_alpha the guard does nothing (tpucg's rule).
    assert _bits(alpha_torch(p, rsold, False, True).numpy()) == _bits(alpha_emulated(pap, 1.7, 0))


@pytest.mark.parametrize("rs_new", [0.3, 0.0, -0.25, float("nan")],
                         ids=["pos", "zero", "neg", "nan"])
@pytest.mark.parametrize("rr, tol2", [(0.5, 0.01), (0.5, -1.0), (0.001, 0.01)],
                         ids=["runs", "check_true", "stops"])
def test_guarded_tail_equals_the_emulation(rs_new, rr, tol2):
    t = LapTail(k=torch.tensor(3, dtype=torch.int32), rsold=torch.tensor(0.8),
                rslast=torch.tensor(0.9), done=torch.tensor(False), active=torch.tensor(True))
    for guard in (False, True):
        got = lap_tail_torch(t, torch.tensor(rr), torch.tensor(rs_new), torch.tensor(tol2), 10,
                             guard)
        want = lap_tail_emulated(3, 0.8, False, rr, rs_new, tol2, 10, guard)
        assert int(got.k) == want["k"] and bool(got.done) == want["done"]
        assert bool(got.active) == want["active"] and bool(got.step) == want["step"]
        for name in ("rsold", "rslast", "beta"):
            assert _bits(getattr(got, name).numpy()) == _bits(want[name]), (guard, name)
    if rs_new > 0:  # a healthy lap: the guard changes no bit
        plain = lap_tail_torch(t, torch.tensor(rr), torch.tensor(rs_new), torch.tensor(tol2), 10)
        guarded = lap_tail_torch(t, torch.tensor(rr), torch.tensor(rs_new), torch.tensor(tol2),
                                 10, True)
        assert all(torch.equal(a, b) for a, b in zip(plain[:7], guarded[:7]))
    assert FLT_MIN == float(np.finfo(np.float32).tiny)


# ---- both packages' loops ---------------------------------------------------


def _loops(A, b, *, tol, maxiter, jacobi=False, **kw):
    """The port's ``cg_loop`` (plain route) and tpucg's on the same padded
    dense operator; returns both final states (the port's as tensors,
    tpucg's as NumPy arrays)."""
    op = DenseOperator.create(A, device=CPU)
    npad = op.padded_n
    bp = F.pad(torch.as_tensor(b), (0, npad - len(b)))
    minv = torch.where(op.diagonal() != 0, 1.0 / op.diagonal(), 1.0) if jacobi else None
    matvec, dot, lap = lap_ops(op, "torch")
    port = cg_loop(matvec, dot, lap, bp, torch.zeros(npad), tol=tol, maxiter=maxiter,
                   precond=None if minv is None else (lambda r, act=None: minv * r), **kw)
    jop = tpucg_padded_dense(A)
    jb = jnp.asarray(bp.numpy())
    jminv = None if minv is None else jnp.asarray(minv.numpy())
    ref = j_cg_loop(jop.matvec, dot_xla, functools.partial(j_fused_update, backend="xla"), jb,
                    jnp.zeros(npad, jnp.float32), tol=tol, maxiter=maxiter,
                    precond=None if jminv is None else (lambda r: jminv * r), **kw)
    return port, ref


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_check_true_goldens_match_the_unguarded_laps(g):
    # Checked every lap, the true residual stops where the recurrence did:
    # the goldens' 2 and 4 laps, in both packages, the guarded finish
    # changing nothing on their healthy laps.
    plain, _ = _loops(g["A"], g["b"], tol=1e-6, maxiter=64)
    port, ref = _loops(g["A"], g["b"], tol=1e-6, maxiter=64, check_true_every=1)
    n = len(g["b"])
    assert int(plain.k) == int(port.k) == int(ref.k) == g["iters"]
    assert torch.equal(port.x, plain.x)
    np.testing.assert_allclose(port.x[:n].numpy(), g["x_star"], atol=1e-5)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5
    # At tpucg's cadence the stop quantizes to the first boundary; the laps
    # past convergence are guarded no-ops (p.Ap and r.r at 0).
    port16, ref16 = _loops(g["A"], g["b"], tol=1e-6, maxiter=64,
                           check_true_every=TRUE_CHECK_EVERY)
    assert int(port16.k) == int(ref16.k) == TRUE_CHECK_EVERY
    assert bool(port16.done) and np.isfinite(port16.x.numpy()).all()
    np.testing.assert_allclose(port16.x[:n].numpy(), g["x_star"], atol=1e-5)


def test_check_true_matches_tpucg_cg_loop():
    # tol well above the f32 floor (the true r.r at the stop is ~4% of
    # tol^2 in both): the boundary, not rounding, sets the laps.
    A, b = spd_kappa(200, 100.0, seed=3)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _loops(A, b, tol=tol, maxiter=2000, jacobi=True, check_true_every=16)
    assert int(port.k) == int(ref.k) and int(port.k) % 16 == 0
    assert bool(port.done) and bool(ref.done)
    assert float(port.rslast) < tol ** 2 and float(ref.rslast) < tol ** 2
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_maxiter_mid_window_keeps_the_recurrence_rr():
    # Cut at lap 20 (a check at 16 only): rslast is lap 20's recurrence r.r,
    # as tpucg's is, and the 16-lap check did not stop the solve.
    A, b = spd_kappa(200, 1e3, seed=3)
    tol = 1e-9 * float(np.linalg.norm(b))
    port, ref = _loops(A, b, tol=tol, maxiter=20, check_true_every=16)
    assert int(port.k) == int(ref.k) == 20 and not bool(port.done) and not bool(ref.done)
    rec = float(torch.dot(port.r, port.r))
    assert abs(float(port.rslast) - rec) <= 1e-5 * rec
    np.testing.assert_allclose(float(port.rslast), float(ref.rslast), rtol=1e-3)


def test_replace_every_matches_tpucg():
    A, b = spd_kappa(64, 100.0, seed=5)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _loops(A, b, tol=tol, maxiter=500, jacobi=True, replace_every=5)
    assert int(port.k) == int(ref.k) and bool(port.done) and bool(ref.done)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-5
    assert float(port.rslast) < tol ** 2 and float(ref.rslast) < tol ** 2


def _check_true_solve(chunk=None, **kw):
    A, b = spd_kappa(200, 100.0, seed=3)
    tol = 1e-5 * float(np.linalg.norm(b))
    op = DenseOperator.create(A, device=CPU)
    bp = F.pad(torch.as_tensor(b), (0, op.padded_n - 200))
    return cg_loop(*lap_ops(op, "torch"), bp, torch.zeros(op.padded_n), tol=tol, maxiter=2000,
                   check_true_every=16, chunk=chunk, return_stag=True, **kw)


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_chunk_size_moves_no_result(chunk):
    (want, want_stag) = _check_true_solve()
    (got, stag) = _check_true_solve(chunk)
    assert isinstance(stag, StagCarry)
    for name in ("k", "x", "r", "p", "rsold", "rslast", "done"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(stag.prev_rr, want_stag.prev_rr)
    assert torch.equal(stag.prev_stag, want_stag.prev_stag)


def test_a_stopped_state_changes_nothing():
    st, stag = _check_true_solve()
    again, stag2 = _check_true_solve(state=st, stag_carry=stag)
    for name in ("k", "x", "r", "p", "rsold", "rslast", "done"):
        assert torch.equal(getattr(again, name), getattr(st, name)), name
    assert torch.equal(stag2.prev_rr, stag.prev_rr) and torch.equal(stag2.prev_stag,
                                                                      stag.prev_stag)


def test_periodic_modes_are_refused_together_and_without_b():
    op = DenseOperator.create(GOLDEN_2X2["A"], device=CPU)
    b = F.pad(torch.as_tensor(GOLDEN_2X2["b"]), (0, op.padded_n - 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        cg_loop(*lap_ops(op, "torch"), b, torch.zeros_like(b), tol=1e-6, maxiter=4,
                check_true_every=16, replace_every=5)
    st = init_state(op.matvec, lambda u, v, act: torch.dot(u, v), b, torch.zeros_like(b), 1e-6)
    with pytest.raises(ValueError, match="need b"):
        cg_loop(*lap_ops(op, "torch"), None, None, tol=1e-6, maxiter=4, state=st,
                check_true_every=16)
    # Without check_true_every the carry passes through (default inf, False).
    _, carry = cg_loop(*lap_ops(op, "torch"), b, torch.zeros_like(b), tol=1e-6, maxiter=4,
                       return_stag=True)
    assert float(carry.prev_rr) == float("inf") and not bool(carry.prev_stag)


# ---- the stagnation exit: tpucg's FEM fixture (test_checkpoint.py:492) -------


@pytest.fixture(scope="module")
def stagnating():
    """FEM n = 6,000 (seed 1) on WELL with tpucg's two-level (agg 32) at tol
    1e-7 ||b||, below the f32 floor: it stagnation-stops."""
    A, b, _ = fem_p1_system(6_000, seed=1)
    op = best_sparse_operator(A, device=CPU)
    tl = build_two_level(A, agg_size=32, npad=op.padded_n, device=CPU)
    tol = 1e-7 * float(np.linalg.norm(b))
    return A, b, op, tl, tol, 4 * A.shape[0]


def test_stagnation_stops_in_tpucgs_window(stagnating):
    A, b, op, tl, tol, cap = stagnating
    port = cg_solve(op, b, tol=tol, maxiter=cap, two_level=tl)
    jop = tpucg.best_sparse_operator(A)
    ref = tpucg.cg_solve(jop, b, tol=tol, maxiter=cap,
                         two_level=tpucg.build_two_level(A, agg_size=32, npad=jop.padded_n))
    k = int(port.iterations)
    assert k == int(ref.iterations) and k < cap and k % TRUE_CHECK_EVERY == 0
    assert not bool(port.converged) and not bool(ref.converged)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_stag_carry_threads_two_calls(stagnating):
    # The solve split mid-window (at 40 laps) with its carry threaded stops at
    # the single call's lap with its x, bit for bit; the carry is what the
    # single call would hold there.
    A, b, op, tl, tol, cap = stagnating
    from tpucg_torch.solver.twolevel import make_two_level_precond

    bp = F.pad(torch.as_tensor(b), (0, op.padded_n - op.n))
    matvec, dot, lap = lap_ops(op, "torch")
    pc = make_two_level_precond(tl, matvec, dot, bp)
    kw = dict(tol=tol, precond=pc, check_true_every=TRUE_CHECK_EVERY, return_stag=True)
    x0 = torch.zeros(op.padded_n)
    whole, stag = cg_loop(matvec, dot, lap, bp, x0, maxiter=cap, **kw)
    first, carry = cg_loop(matvec, dot, lap, bp, x0, maxiter=40, **kw)
    assert int(first.k) == 40 and not bool(first.done)
    second, carry2 = cg_loop(matvec, dot, lap, bp, None, maxiter=cap, state=first,
                             stag_carry=carry, **kw)
    assert int(second.k) == int(whole.k) < cap and bool(second.done)
    assert torch.equal(second.x, whole.x) and torch.equal(second.rslast, whole.rslast)
    assert torch.equal(carry2.prev_rr, stag.prev_rr) and bool(carry2.prev_stag)
