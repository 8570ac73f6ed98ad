"""tpucg_torch's whole-solve path against tpucg on the CPU: the plain version
of K4 (``fused_cg_solve_torch``) against ``fused_cg_solve_pallas`` in
interpret mode, the polynomial preconditioner on the lap path, and the gate
``_fused_eligible`` over tpucg's own cases. The kernel itself runs only on
the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
import tpucg.kernels.fused
import tpucg.solver.cg
from _torch_helpers import rel_err
from tpucg.io.partitioner import pad_identity_tail
from tpucg.kernels.blas1 import dot_xla
from tpucg.kernels.fused import fused_cg_solve_pallas
from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.kernels.blas1 import fused_update_torch
from tpucg_torch.kernels.fused import FUSED_AUTO_MAX_N, FUSED_MAX_N, fused_cg_solve_cuda
from tpucg_torch.kernels.matvec import matvec_torch
from tpucg_torch.solver import cg as port_cg
from tpucg_torch.solver.cg import (
    _fused_eligible,
    cg_solve,
    lambda_max_estimate,
    lap_ops,
    make_poly_precond,
)
from tpucg_torch.solver.fused import fused_cg_solve, fused_cg_solve_torch
from tpucg_torch.solver.operators import DenseOperator

CPU = torch.device("cpu")
PCS = [("none", 0), ("jacobi", 0), ("poly", 2), ("poly", 3)]
PC_IDS = ["none", "jacobi", "poly2", "poly3"]


def _padded(A, b, x0, npad):
    Ap = pad_identity_tail(np.asarray(A, np.float32), npad)
    bp = np.zeros(npad, np.float32)
    bp[: len(b)] = b
    xp = np.zeros(npad, np.float32)
    xp[: len(x0)] = x0
    return Ap, bp, xp


def _minv(Ap):
    d = np.diagonal(Ap)
    return np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)


def _both_k4(Ap, bp, xp, precondition="none", poly_degree=0, **kw):
    """tpucg's K4 (interpret mode) and the port's plain K4 on the same
    arrays: two (x, k, rr) triples of numpy values."""
    minv = _minv(Ap) if precondition == "jacobi" else None
    j = fused_cg_solve_pallas(
        jnp.asarray(Ap), jnp.asarray(bp), jnp.asarray(xp), precondition=precondition,
        poly_degree=poly_degree, minv=None if minv is None else jnp.asarray(minv), **kw)
    t = fused_cg_solve_torch(
        torch.from_numpy(Ap), torch.from_numpy(bp), torch.from_numpy(xp),
        precondition=precondition, poly_degree=poly_degree,
        minv=None if minv is None else torch.from_numpy(minv), **kw)
    return [np.asarray(v) for v in j], [v.numpy() for v in t]


def _tols(precondition, want):
    # tpucg's own bounds: test_fused.py:45-46 (none) and :430 (preconditioned),
    # whose systems have x of order 1. Here x can be of order 1/n, so the
    # preconditioned atol is taken relative to the solution's size.
    if precondition == "none":
        return dict(rtol=1e-5, atol=1e-7)
    return dict(rtol=2e-3, atol=2e-4 * float(np.abs(want).max()))


def _system(name):
    if name == "n200":
        A, b, x0 = generate_spd_system(200, seed=0)
        return A, b, x0, 256
    g = GOLDEN_2X2 if name == "golden2x2" else GOLDEN_4X4
    return g["A"], g["b"], g["x0"], 128


@pytest.mark.parametrize("system", ["n200", "golden2x2", "golden4x4"])
@pytest.mark.parametrize("pc, deg", PCS, ids=PC_IDS)
def test_plain_k4_matches_tpucg_kernel(system, pc, deg):
    A, b, x0, npad = _system(system)
    n = len(b)
    (xj, kj, rj), (xt, kt, rt) = _both_k4(*_padded(A, b, x0, npad), tol=1e-6, maxiter=n,
                                          precondition=pc, poly_degree=deg)
    assert kt.dtype == np.int32 and kt.shape == () and rt.dtype == np.float32 and rt.shape == ()
    assert int(kt) == int(kj)
    assert float(rt) < 1e-12 and float(rj) < 1e-12
    np.testing.assert_allclose(xt[:n], xj[:n], **_tols(pc, xj[:n]))
    np.testing.assert_array_equal(xt[n:], 0.0)  # the identity tail stays at 0
    if system != "n200":
        g = GOLDEN_2X2 if system == "golden2x2" else GOLDEN_4X4
        np.testing.assert_allclose(xt[:n], g["x_star"], atol=2e-3)
        if pc == "none":
            assert int(kt) == g["iters"]


def test_plain_k4_maxiter_cap_and_exact_guess():
    # tpucg's test_fused.py:64-83 on both packages.
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 8.0) * np.eye(n)).astype(np.float32)
    (xj, kj, rj), (xt, kt, rt) = _both_k4(*_padded(A, b, x0, 128), tol=1e-6, maxiter=3)
    assert int(kt) == int(kj) == 3
    assert float(rt) > 1e-12
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-7)
    ref = tpucg.cg_solve(A, b, fused="never")
    xstar = np.asarray(ref.x)
    bstar = (np.asarray(A, np.float64) @ xstar.astype(np.float64)).astype(np.float32)
    (_, kj, _), (xt, kt, _) = _both_k4(*_padded(A, bstar, xstar, 128), tol=1e-4, maxiter=128)
    assert int(kt) == int(kj) == 0
    np.testing.assert_array_equal(xt[:n], xstar)


def test_plain_k4_poly_on_a_laplacian_matches_tpucg():
    # Many laps (150-180): the power method's w and the in-kernel Neumann
    # apply must track tpucg's lap for lap.
    n = 256
    A = (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)
    b = np.cos(np.arange(n) * 0.3).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    for deg in (2, 3):
        (xj, kj, _), (xt, kt, _) = _both_k4(A, b, np.zeros(n, np.float32), tol=tol,
                                            maxiter=4 * n, precondition="poly", poly_degree=deg)
        assert int(kt) == int(kj)
        np.testing.assert_allclose(xt, xj, rtol=2e-3, atol=2e-4 * np.abs(xj).max())


def test_plain_k4_safe_alpha_off_matches_tpucg():
    A, b, x0 = generate_spd_system(100, seed=6)
    (xj, kj, _), (xt, kt, _) = _both_k4(*_padded(A, b, x0, 128), tol=1e-6, maxiter=100,
                                        safe_alpha=False)
    assert int(kt) == int(kj)
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-7)


# ---- the polynomial preconditioner on the lap path --------------------------


def _laplacian(n):
    A = (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)
    return A, np.cos(np.arange(n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("system", ["spd", "laplacian"])
def test_lambda_max_estimate_matches_tpucg(system):
    if system == "spd":
        A, b, _ = generate_spd_system(200, seed=1)
    else:
        A, b = _laplacian(200)
    op = DenseOperator.create(A, device=CPU)
    bp = torch.nn.functional.pad(torch.from_numpy(b), (0, op.padded_n - 200))
    matvec, dot, _ = lap_ops(op, "torch")
    lam = lambda_max_estimate(matvec, dot, bp)
    jop = tpucg.DenseOperator.create(op.A.numpy(), backend="xla")  # the same padded A
    lam_j = tpucg.solver.cg.lambda_max_estimate(jop.matvec, dot_xla, jnp.asarray(bp.numpy()))
    assert lam.shape == () and lam.dtype == torch.float32
    assert abs(float(lam) - float(lam_j)) <= 1e-5 * float(lam_j)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_poly_precond_apply_matches_tpucg(degree):
    A, b, _ = generate_spd_system(200, seed=2)
    op = DenseOperator.create(A, device=CPU)
    npad = op.padded_n
    bp = np.zeros(npad, np.float32)
    bp[:200] = b
    r = np.random.default_rng(degree).standard_normal(npad).astype(np.float32)
    matvec, dot, _ = lap_ops(op, "torch")
    z = make_poly_precond(matvec, dot, torch.from_numpy(bp), degree)(torch.from_numpy(r))
    jop = tpucg.DenseOperator.create(op.A.numpy(), backend="xla")  # the same padded A
    zj = tpucg.solver.cg.make_poly_precond(jop.matvec, dot_xla, jnp.asarray(bp), degree)(
        jnp.asarray(r))
    assert rel_err(z.numpy(), zj) <= 1e-5


def test_poly_degree_below_one_is_refused():
    with pytest.raises(ValueError, match="poly_degree must be >= 1"):
        CGConfig(poly_degree=0)
    op = DenseOperator.create(np.eye(128, dtype=np.float32), device=CPU)
    matvec, dot, _ = lap_ops(op, "torch")
    with pytest.raises(ValueError, match="poly degree must be >= 1"):
        make_poly_precond(matvec, dot, torch.ones(128), 0)


@pytest.mark.parametrize("system", ["spd", "laplacian"])
@pytest.mark.parametrize("degree", [2, 3])
def test_poly_lap_path_matches_tpucg(system, degree):
    if system == "spd":
        A, b, x0 = generate_spd_system(300, seed=3)
        kw = dict(tol=1e-6)
    else:
        A, b = _laplacian(256)
        x0 = np.zeros(256, np.float32)
        kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=4 * 256)
    kw.update(precondition="poly", poly_degree=degree)
    port = cg_solve(A, b, x0, device=CPU, fused="never", **kw)
    ref = tpucg.cg_solve(A, b, x0, kernel="pallas", fused="never", **kw)
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(port.x.numpy(), xr, rtol=2e-3, atol=2e-4 * np.abs(xr).max())
    if system == "laplacian":
        plain = cg_solve(A, b, x0, device=CPU, **{**kw, "precondition": "none"})
        assert int(port.iterations) < int(plain.iterations)


def test_poly_chunk_sizes_are_bit_identical():
    A, b = _laplacian(200)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=800, precondition="poly",
              poly_degree=3, device=CPU)
    runs = [cg_solve(A, b, chunk=c, **kw) for c in (None, 1, 5)]
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x) and torch.equal(r.iterations, runs[0].iterations)


# ---- the gate: tpucg's case table (tests/test_fused.py:103-148) -------------


def _gate_cases():
    """(label, config kwargs, operator kind, backend index, record, dtype
    index): backend and dtype index 0/1 pick ("pallas", "xla") in tpucg and
    ("cuda", "torch") in the port, and (f32, f64)."""
    return [
        ("base", {}, "n256", 0, False, 0),
        ("plain_backend", {}, "n256", 1, False, 0),
        ("history", {}, "n256", 0, True, 0),
        ("jacobi", dict(precondition="jacobi"), "n256", 0, False, 0),
        ("poly", dict(precondition="poly"), "n256", 0, False, 0),
        ("block_jacobi", dict(precondition="block_jacobi"), "n256", 0, False, 0),
        ("never", dict(fused="never"), "n256", 0, False, 0),
        ("pipelined", dict(method="pipelined"), "n256", 0, False, 0),
        ("f64", {}, "n256", 0, False, 1),
        ("bf16", {}, "bf16", 0, False, 0),
        ("above_auto", {}, "big", 0, False, 0),
        ("above_auto_always", dict(fused="always"), "big", 0, False, 0),
        ("over_cap_always", dict(fused="always"), "over", 0, False, 0),
        ("over_cap_never", dict(fused="never"), "over", 0, False, 0),
    ]


def _gate_ops(kind, A):
    """The same operator in both packages."""
    if kind == "n256":
        return (tpucg.solver.operators.as_operator(np.asarray(A), backend="pallas"),
                DenseOperator.create(A, device=CPU))
    if kind == "bf16":
        return (tpucg.DenseOperator.create(np.asarray(A), backend="pallas", dtype=jnp.bfloat16),
                DenseOperator.create(A, dtype=torch.bfloat16, device=CPU))
    n = tpucg.kernels.fused.FUSED_AUTO_MAX_N + 128 if kind == "big" else FUSED_MAX_N + 128
    return (tpucg.DenseOperator(A=jnp.zeros((n, n), jnp.float32), n=n, backend="pallas"),
            DenseOperator(A=torch.zeros(n, n), n=n))


@pytest.mark.parametrize("case", _gate_cases(), ids=lambda c: c[0])
def test_fused_gate_matches_tpucg(case, monkeypatch):
    # The auto caps are each card's own crossover; the table is tpucg's, so
    # the port's gate runs it under tpucg's cap.
    monkeypatch.setattr(port_cg, "FUSED_AUTO_MAX_N", tpucg.kernels.fused.FUSED_AUTO_MAX_N)
    _, kw, kind, bi, record, di = case
    A, _, _ = generate_spd_system(256, seed=1)
    jop, op = _gate_ops(kind, A)
    want = tpucg.solver.cg._fused_eligible(
        tpucg.CGConfig(kernel="pallas", **kw), jop, ("pallas", "xla")[bi],
        (jnp.float32, jnp.float64)[di], record)
    got = _fused_eligible(CGConfig(**kw), op, ("cuda", "torch")[bi],
                          (torch.float32, torch.float64)[di], record)
    assert got == want


def test_fused_auto_cap_is_the_cards_own():
    assert FUSED_AUTO_MAX_N % 128 == 0 and 0 <= FUSED_AUTO_MAX_N <= FUSED_MAX_N
    assert port_cg.FUSED_AUTO_MAX_N == FUSED_AUTO_MAX_N
    assert FUSED_MAX_N == tpucg.kernels.fused.FUSED_MAX_N
    A, _, _ = generate_spd_system(100, seed=0)
    op = DenseOperator.create(A, device=CPU)
    expect = "dense" if FUSED_AUTO_MAX_N >= 128 else None
    assert _fused_eligible(CGConfig(), op, "cuda", torch.float32, False) == expect


# ---- routing and the wrappers on the CPU ------------------------------------


@pytest.mark.parametrize("fused", ["always", "auto", "never"])
def test_fused_option_on_the_torch_backend_takes_the_lap_path(fused):
    # tpucg's fused="always" on "xla" takes the lap path; so does the port's
    # on "torch": the plain K4 never runs inside cg_solve.
    g = GOLDEN_4X4
    before_k4, before_k1 = fused_cg_solve_torch.launches, matvec_torch.launches
    res = cg_solve(g["A"], g["b"], g["x0"], device=CPU, fused=fused)
    assert int(res.iterations) == 4 and bool(res.converged)
    assert fused_cg_solve_torch.launches == before_k4
    assert matvec_torch.launches > before_k1


def test_dispatch_runs_the_plain_version_for_cpu_tensors():
    Ap, bp, xp = (torch.from_numpy(a) for a in _padded(GOLDEN_2X2["A"], GOLDEN_2X2["b"],
                                                       GOLDEN_2X2["x0"], 128))
    before, before_upd = fused_cg_solve_torch.launches, fused_update_torch.launches
    x, k, rr = fused_cg_solve(Ap, bp, xp, tol=1e-6, maxiter=2)
    assert fused_cg_solve_torch.launches == before + 1
    assert fused_update_torch.launches > before_upd
    assert int(k) == 2 and x.device == CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_cg_solve(Ap, bp, xp, backend="cuda", tol=1e-6, maxiter=2)


def test_k4_operands_are_refused_with_tpucgs_messages():
    v = torch.zeros(FUSED_MAX_N + 128)
    kw = dict(tol=1e-6, maxiter=4)
    for fn in (fused_cg_solve_torch, fused_cg_solve_cuda):
        with pytest.raises(ValueError, match="fused solve needs 128-aligned n <= 4096"):
            fn(torch.zeros(FUSED_MAX_N + 128, FUSED_MAX_N + 128), v, v, **kw)
        with pytest.raises(ValueError, match="fused solve needs 128-aligned"):
            fn(torch.zeros(200, 200), torch.zeros(200), torch.zeros(200), **kw)
        with pytest.raises(ValueError, match="f32-only"):
            fn(torch.zeros(128, 128, dtype=torch.bfloat16), torch.zeros(128), torch.zeros(128),
               **kw)
        with pytest.raises(ValueError, match="requires minv"):
            fn(torch.eye(128), torch.zeros(128), torch.zeros(128), precondition="jacobi", **kw)
        with pytest.raises(ValueError, match="b must be f32"):
            fn(torch.eye(128), torch.zeros(64), torch.zeros(128), **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_cg_solve_cuda(torch.eye(128), torch.zeros(128), torch.zeros(128), **kw)
    with pytest.raises(ValueError, match="fused solve needs 128-aligned n <= 4096"):
        fused_cg_solve_pallas(jnp.zeros((FUSED_MAX_N + 128,) * 2), jnp.zeros(FUSED_MAX_N + 128),
                              jnp.zeros(FUSED_MAX_N + 128), **kw)


def test_k4_plain_version_leaves_its_inputs_alone():
    A, b, x0 = generate_spd_system(100, seed=8, x0="random")
    Ap, bp, xp = (torch.from_numpy(a) for a in _padded(A, b, x0, 128))
    kept = [t.clone() for t in (Ap, bp, xp)]
    fused_cg_solve_torch(Ap, bp, xp, tol=1e-6, maxiter=100, precondition="poly",
                                    poly_degree=2)
    assert all(torch.equal(a, b_) for a, b_ in zip((Ap, bp, xp), kept))
