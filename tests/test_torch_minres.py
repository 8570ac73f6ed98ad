"""The port's MINRES (``solver/minres.py``) against tpucg's, on the CPU: the
serial cases of tpucg's ``tests/test_minres.py``. The same seeded NumPy
systems, symmetric indefinite and SPD, go through both packages (tpucg's
dense operator as ``tpucg_padded_dense``, the port's padded operator, XLA;
its banded one in DIA form), plain, Jacobi (1/|diag A|) and block Jacobi
(|B|^-1): laps equal, x within 1e-4 of max |x|, converged on the true
residual. tpucg's ``"auto"`` sends Jacobi dense MINRES to its XLA GEMV; the
port keeps the operator's kernel (K1; its plain version here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpucg
from tpucg.solver.minres import abs_inv_blocks as j_abs_inv_blocks
from tpucg.sparse.formats import DIAMatrix as JDIAMatrix

from _torch_helpers import scaled_err, tpucg_padded_dense
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.kernels.matvec import matvec_torch
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.minres import abs_inv_blocks, minres_solve
from tpucg_torch.solver.operators import DenseOperator, DiaOperator
from tpucg_torch.sparse.formats import DIAMatrix

CPU = torch.device("cpu")


def _sym_indefinite(n=192, seed=0, scale=False):
    """tpucg's test system (half the spectrum in [-2, -1], half in [1, 2]);
    ``scale`` is its benchmark's badly scaled variant (10^U(-1.5, 1.5))."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    half = n // 2
    lam = np.concatenate([-(1.0 + rng.uniform(0.0, 1.0, half)),
                          1.0 + rng.uniform(0.0, 1.0, n - half)])
    A = (Q * lam) @ Q.T
    if scale:
        s = 10.0 ** rng.uniform(-1.5, 1.5, n)
        A = A * s[None, :] * s[:, None]
    return (0.5 * (A + A.T)).astype(np.float32)


def _both(A, b, x0=None, **kw):
    port = minres_solve(A, b, x0, device=CPU, **kw)
    ref = tpucg.minres_solve(tpucg_padded_dense(A), b, x0, kernel="xla", **kw)
    return port, ref


def _held(port, ref, x_tol=1e-4):
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= x_tol


def test_indefinite_matches_tpucg():
    # tpucg's system, plain: 22 laps in both.
    A = _sym_indefinite()
    n = A.shape[0]
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _both(A, b, tol=tol, maxiter=8 * n)
    _held(port, ref)
    assert float(port.residual_norm) < tol
    r = np.linalg.norm(b - A.astype(np.float64) @ port.x.numpy().astype(np.float64))
    assert r < tol


def _scaled_band(n=2048, e=1.0, seed=3):
    """The staggered band of ``_staggered_band`` scaled S B S, s =
    10^U(-e, e): plain MINRES stalls (8,192 laps, unconverged, in both), and
    Jacobi and block Jacobi undo the scaling, so their laps are few and set
    by the spectrum, not by rounding. (On tpucg's dense indefinite systems
    the diagonal sits near 0, and Jacobi MINRES runs 200-350 laps that the
    two packages' f32 orders end a few per cent apart.)"""
    data, offsets = _staggered_band(n)
    s = 10.0 ** np.random.default_rng(seed).uniform(-e, e, n)
    for d, off in enumerate(offsets):
        j = np.arange(n) + off
        ok = (j >= 0) & (j < n)
        data[d, ok] = data[d, ok] * s[ok] * s[j[ok]]
    return data.astype(np.float32), offsets


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi"])
def test_preconditioned_indefinite_matches_tpucg(pc):
    n = 2048
    data, offsets = _scaled_band(n)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    op = DiaOperator.from_dia(DIAMatrix(data=data, offsets=offsets, shape=(n, n)), device=CPU)
    jop = tpucg.DiaOperator.from_dia(JDIAMatrix(data=data, offsets=offsets, shape=(n, n)),
                                     backend="xla")
    kw = dict(tol=tol, maxiter=4 * n, precondition=pc, pc_block_size=32)
    port = minres_solve(op, b, **kw)
    ref = tpucg.minres_solve(jop, b, kernel="xla", **kw)
    _held(port, ref)
    assert int(port.iterations) <= 32


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_spd_matches_cg_and_tpucg(pc):
    A, b, x0 = generate_spd_system(128, seed=2)
    tol = 1e-5 * float(np.linalg.norm(b))
    port, ref = _both(A, b, x0, tol=tol, precondition=pc)
    _held(port, ref)
    cg = cg_solve(A, b, x0, device=CPU, tol=tol)
    np.testing.assert_allclose(port.x.numpy(), cg.x.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_goldens(g):
    # The 4x4 at tol 1e-5 (at 1e-6 its Krylov space runs out at lap 4 above
    # tol, and neither package converges within maxiter = n).
    tol = 1e-6 if g is GOLDEN_2X2 else 1e-5
    port = minres_solve(g["A"], g["b"], g["x0"], device=CPU, tol=tol)
    ref = tpucg.minres_solve(g["A"], g["b"], g["x0"], kernel="xla", tol=tol)
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    np.testing.assert_allclose(port.x.numpy(), g["x_star"], atol=1e-4)


def test_exact_x0_stops_at_lap_zero():
    A = _sym_indefinite(n=64, seed=3)
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    res = minres_solve(A, (A @ x).astype(np.float32), x, tol=1e-3, device=CPU)
    assert bool(res.converged) and int(res.iterations) == 0


def test_padding_and_operator_input():
    # n = 100 pads to 128; the operator itself is accepted.
    A = _sym_indefinite(n=100, seed=5)
    b = np.random.default_rng(6).standard_normal(100).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    port = minres_solve(DenseOperator.create(A, device=CPU), b, tol=tol, maxiter=800)
    ref = tpucg.minres_solve(tpucg_padded_dense(A), b, tol=tol, maxiter=800, kernel="xla")
    assert port.x.shape == (100,)
    _held(port, ref)


def _staggered_band(n, w=64):
    """tpucg's benchmark band (``benchmarks/minres_bench.py:47``) at a
    smaller stripe: offsets +-1, +-w under a +-5 diagonal in stripes of w
    rows, |lambda| in [1, 9] of both signs."""
    data = np.zeros((5, n), np.float32)
    data[0] = data[4] = -1.0
    data[1] = data[3] = -1.0
    data[2] = np.where((np.arange(n) // w) % 2 == 0, 5.0, -5.0)
    return data, (-w, -1, 0, 1, w)


def test_banded_dia_matches_tpucg():
    n = 4096
    data, offsets = _staggered_band(n)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    op = DiaOperator.from_dia(DIAMatrix(data=data, offsets=offsets, shape=(n, n)), device=CPU)
    jop = tpucg.DiaOperator.from_dia(JDIAMatrix(data=data, offsets=offsets, shape=(n, n)),
                                     backend="xla")
    port = minres_solve(op, b, tol=tol, maxiter=4 * n)
    ref = tpucg.minres_solve(jop, b, tol=tol, maxiter=4 * n, kernel="xla")
    _held(port, ref)


@pytest.mark.parametrize("scale", [False, True], ids=["plain", "scaled"])
def test_abs_inv_blocks_equals_tpucgs(scale):
    # f32 eigh, as tpucg's: within 1e-5 of tpucg's on well-conditioned
    # blocks. On the badly scaled ones (block condition ~1e6) both f32
    # results sit ~3% of max |B^-1| from the float64 |B|^-1 and within 2e-4
    # of each other; the port no further from float64 than tpucg (x 1.01).
    A = _sym_indefinite(n=128, seed=8, scale=scale)
    blocks = DenseOperator.create(A, device=CPU).diagonal_blocks(32)
    got = abs_inv_blocks(blocks).numpy()
    want = np.asarray(j_abs_inv_blocks(jnp.asarray(blocks.numpy())))
    top = np.abs(want).max()
    if scale:
        exact = abs_inv_blocks(blocks.double()).numpy()
        assert np.abs(got - want).max() <= 2e-4 * top
        assert np.abs(got - exact).max() <= 1.01 * np.abs(want - exact).max()
    else:
        assert np.abs(got - want).max() <= 1e-5 * top
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))
    assert np.linalg.eigvalsh(got.astype(np.float64)).min() > 0


def test_jacobi_dense_minres_keeps_the_operators_matvec():
    # tpucg's "auto" reroutes Jacobi dense MINRES to XLA's GEMV (a TPU
    # fusion cliff); the port keeps the operator's kernel, K1, whose plain
    # version runs here: each lap and each confirmation is one of its calls.
    A = _sym_indefinite(seed=9)
    b = np.random.default_rng(2).standard_normal(192).astype(np.float32)
    before = matvec_torch.launches
    res = minres_solve(A, b, tol=1e-4 * float(np.linalg.norm(b)), precondition="jacobi",
                       maxiter=2000, device=CPU)
    assert bool(res.converged)
    assert matvec_torch.launches - before >= int(res.iterations) + 2


def test_validation():
    A = _sym_indefinite(n=64, seed=10)
    b = np.ones(64, np.float32)
    with pytest.raises(ValueError, match="method variants"):
        minres_solve(A, b, method="pipelined", device=CPU)
    with pytest.raises(ValueError, match="SPD M"):
        minres_solve(A, b, precondition="poly", device=CPU)
    with pytest.raises(ValueError, match="float32"):
        minres_solve(A, b, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        minres_solve(A, np.ones(63, np.float32), device=CPU)
