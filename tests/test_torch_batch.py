"""tpucg_torch's batched solve against tpucg on the CPU: the plain version of
K5 (``fused_batch_cg_solve_torch``) against ``fused_batch_cg_solve_pallas``
in interpret mode, and ``cg_solve_batch`` against tpucg's (its plain batched
loop where K5 does not apply: poly, and padded n above 2048). The kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import circulant_spd_batch, scaled_err, shifted_spd_batch
from tpucg.kernels.fused import fused_batch_cg_solve_pallas
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.kernels.fused import FUSED_BATCH_MAX_N, fused_batch_cg_solve_cuda
from tpucg_torch.solver.cg import batch_cg_loop, cg_solve, cg_solve_batch
from tpucg_torch.solver.fused import fused_batch_cg_solve, fused_batch_cg_solve_torch

CPU = torch.device("cpu")


def _make_batch(nsys, n, seed=0):
    """tpucg's test_batch.py systems: diagonal shifts n, n/2, n/4, ... so
    that the systems need different lap counts."""
    rng = np.random.default_rng(seed)
    As, bs = [], []
    for i in range(nsys):
        M = rng.standard_normal((n, n)).astype(np.float32)
        As.append(0.5 * (M + M.T) + (n / (1 + i)) * np.eye(n, dtype=np.float32))
        bs.append(rng.standard_normal(n).astype(np.float32))
    return np.stack(As), np.stack(bs)


def _pad(As, bs, X0, npad):
    nsys, n = bs.shape
    Ap = np.zeros((nsys, npad, npad), np.float32)
    Ap[:, :n, :n] = As
    idx = np.arange(n, npad)
    Ap[:, idx, idx] = 1.0
    bp = np.zeros((nsys, npad), np.float32)
    bp[:, :n] = bs
    xp = np.zeros((nsys, npad), np.float32)
    xp[:, :n] = X0
    return Ap, bp, xp


def _both_k5(Ap, bp, xp, precondition="none", **kw):
    """tpucg's K5 (interpret mode) and the port's plain K5 on the same
    arrays: two (x, k, rr) triples of numpy values."""
    minv = None
    if precondition == "jacobi":
        d = np.diagonal(Ap, axis1=1, axis2=2)
        minv = np.where(d != 0, 1.0 / d, 1.0).astype(np.float32)
    j = fused_batch_cg_solve_pallas(
        jnp.asarray(Ap), jnp.asarray(bp), jnp.asarray(xp), precondition=precondition,
        minv=None if minv is None else jnp.asarray(minv), **kw)
    t = fused_batch_cg_solve_torch(
        torch.from_numpy(Ap), torch.from_numpy(bp), torch.from_numpy(xp),
        precondition=precondition, minv=None if minv is None else torch.from_numpy(minv), **kw)
    return [np.asarray(v) for v in j], [v.numpy() for v in t]


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
def test_plain_k5_matches_tpucg_kernel(precondition):
    nsys, n = 4, 96
    As, bs = _make_batch(nsys, n)
    (xj, kj, rj), (xt, kt, rt) = _both_k5(*_pad(As, bs, np.zeros_like(bs), 128), tol=1e-5,
                                          maxiter=4 * n, precondition=precondition)
    assert xt.shape == (nsys, 128) and kt.shape == rt.shape == (nsys,)
    assert kt.dtype == np.int32 and rt.dtype == np.float32
    np.testing.assert_array_equal(kt, kj)
    assert len(set(kt.tolist())) > 1, kt  # the systems stop at different laps
    assert (rt < 1e-10).all()
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)


def test_plain_k5_goldens_together():
    As = np.stack([
        np.pad(GOLDEN_2X2["A"], ((0, 2), (0, 2))) + np.diag([0, 0, 1, 1]),
        GOLDEN_4X4["A"],
    ]).astype(np.float32)
    bs = np.stack([np.pad(GOLDEN_2X2["b"], (0, 2)), GOLDEN_4X4["b"]]).astype(np.float32)
    (xj, kj, _), (xt, kt, _) = _both_k5(*_pad(As, bs, np.zeros_like(bs), 128), tol=1e-6,
                                        maxiter=4)
    assert kt.tolist() == kj.tolist() == [GOLDEN_2X2["iters"], GOLDEN_4X4["iters"]]
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    res = cg_solve_batch(As, bs, device=CPU)
    assert res.iterations.tolist() == [2, 4]
    np.testing.assert_allclose(res.x[0, :2].numpy(), GOLDEN_2X2["x_star"], atol=2e-3)
    np.testing.assert_allclose(res.x[1].numpy(), GOLDEN_4X4["x_star"], atol=2e-3)


def test_plain_k5_x0_maxiter_and_exact_guess():
    nsys, n = 3, 128
    As, bs = _make_batch(nsys, n, seed=2)
    X0 = 0.1 * np.ones((nsys, n), np.float32)
    # System 2 starts at an exact solution: x0 = e_0 and b = A e_0 (column 0
    # of A, exact in f32 whatever the order of the sums) stop at k = 0.
    X0[2] = 0.0
    X0[2, 0] = 1.0
    bs[2] = As[2][:, 0]
    (xj, kj, _), (xt, kt, _) = _both_k5(As, bs, X0, tol=1e-5, maxiter=4 * n)
    np.testing.assert_array_equal(kt, kj)
    assert kt[2] == 0 and kt[0] > 0 and kt[1] > 0
    np.testing.assert_array_equal(xt[2], X0[2])
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    (xj, kj, rj), (xt, kt, rt) = _both_k5(As, bs, X0, tol=1e-5, maxiter=2)
    assert kt.tolist() == kj.tolist() == [2, 2, 0]
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
def test_cg_solve_batch_matches_tpucg(precondition):
    nsys, n = 4, 96  # n not 128-aligned: the batched identity tail
    As, bs = _make_batch(nsys, n, seed=1)
    X0 = 0.1 * np.ones((nsys, n), np.float32)
    kw = dict(tol=1e-5, maxiter=4 * n, precondition=precondition)
    port = cg_solve_batch(As, bs, X0, device=CPU, **kw)
    ref = tpucg.cg_solve_batch(As, bs, X0, kernel="pallas", **kw)
    assert port.x.shape == (nsys, n) and port.iterations.shape == (nsys,)
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(port.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.residual_norm.numpy(), np.asarray(ref.residual_norm),
                               rtol=1e-2, atol=1e-7)
    for i in range(nsys):
        one = cg_solve(As[i], bs[i], X0[i], device=CPU, **kw)
        assert int(one.iterations) == int(port.iterations[i])


@pytest.mark.parametrize("degree", [2, 3])
def test_cg_solve_batch_poly_matches_tpucg(degree):
    nsys, n = 3, 64
    As, bs = _make_batch(nsys, n, seed=1)
    kw = dict(precondition="poly", poly_degree=degree, tol=1e-5, maxiter=4 * n)
    port = cg_solve_batch(As, bs, device=CPU, **kw)
    ref = tpucg.cg_solve_batch(As, bs, kernel="xla", **kw)
    assert bool(port.converged.all())
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=2e-3, atol=2e-4)
    for i in range(nsys):
        one = cg_solve(As[i], bs[i], device=CPU, **kw)
        assert int(one.iterations) == int(port.iterations[i])
        np.testing.assert_allclose(port.x[i].numpy(), one.x.numpy(), rtol=2e-3, atol=2e-4)


def test_cg_solve_batch_above_the_k5_cap_matches_tpucg():
    n = FUSED_BATCH_MAX_N + 52  # padded 2176: the plain batched loop
    As, bs = _make_batch(2, n, seed=5)
    port = cg_solve_batch(As, bs, device=CPU, tol=1e-4)
    ref = tpucg.cg_solve_batch(As, bs, kernel="xla", tol=1e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-5, atol=1e-6)


def test_cg_solve_batch_never_runs_the_plain_k5():
    # On the torch backend cg_solve_batch runs batch_cg_loop, whatever fused.
    As, bs = _make_batch(2, 32)
    before = fused_batch_cg_solve_torch.launches
    for fused in ("auto", "always", "never"):
        res = cg_solve_batch(As, bs, device=CPU, fused=fused)
        assert bool(res.converged.all())
    assert fused_batch_cg_solve_torch.launches == before


def test_batch_chunk_sizes_are_bit_identical():
    As, bs = _make_batch(4, 96, seed=3)
    runs = [cg_solve_batch(As, bs, device=CPU, tol=1e-5, chunk=c) for c in (None, 1, 5)]
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x) and torch.equal(r.iterations, runs[0].iterations)
    with pytest.raises(ValueError, match="chunk"):
        batch_cg_loop(lambda v, act=None: v, torch.ones(1, 4), torch.zeros(1, 4), tol=1e-6,
                      maxiter=4, chunk=0)


def test_batch_input_validation():
    # tpucg's messages (test_batch.py:103-112).
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        cg_solve_batch(np.eye(4, dtype=np.float32), np.ones(4), device=CPU)
    As, bs = _make_batch(2, 32)
    with pytest.raises(ValueError, match="b must be"):
        cg_solve_batch(As, bs[:1], device=CPU)
    with pytest.raises(ValueError, match="X0 must be"):
        cg_solve_batch(As, bs, np.ones((2, 16), np.float32), device=CPU)
    with pytest.raises(ValueError, match="method='cg'"):
        cg_solve_batch(As, bs, method="pipelined", device=CPU)
    with pytest.raises(ValueError, match="block inverses"):
        cg_solve_batch(As, bs, precondition="block_jacobi", device=CPU)


def test_k5_operands_are_refused_with_tpucgs_messages():
    n = FUSED_BATCH_MAX_N + 128
    kw = dict(tol=1e-6, maxiter=4)
    for fn in (fused_batch_cg_solve_torch, fused_batch_cg_solve_cuda):
        with pytest.raises(ValueError, match="batched fused"):
            fn(torch.zeros(1, n, n), torch.zeros(1, n), torch.zeros(1, n), **kw)
        with pytest.raises(ValueError, match=r"\(B, n, n\)"):
            fn(torch.zeros(128, 128), torch.zeros(128), torch.zeros(128), **kw)
        with pytest.raises(ValueError, match="f32-only"):
            fn(torch.zeros(1, 128, 128, dtype=torch.bfloat16), torch.zeros(1, 128),
               torch.zeros(1, 128), **kw)
        with pytest.raises(ValueError, match="none/jacobi"):
            fn(torch.zeros(1, 128, 128), torch.zeros(1, 128), torch.zeros(1, 128),
               precondition="poly", **kw)
        with pytest.raises(ValueError, match="x0 must be f32"):
            fn(torch.zeros(2, 128, 128), torch.zeros(2, 128), torch.zeros(1, 128), **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_batch_cg_solve_cuda(torch.eye(128)[None], torch.ones(1, 128), torch.zeros(1, 128),
                                  **kw)
    with pytest.raises(ValueError, match="batched fused"):
        fused_batch_cg_solve_pallas(jnp.zeros((1, n, n)), jnp.zeros((1, n)), jnp.zeros((1, n)),
                                    **kw)


def test_k5_dispatch_runs_the_plain_version_for_cpu_tensors():
    A = torch.eye(128)[None].repeat(2, 1, 1) * torch.tensor([2.0, 4.0])[:, None, None]
    before = fused_batch_cg_solve_torch.launches
    x, k, rr = fused_batch_cg_solve(A, torch.ones(2, 128), torch.zeros(2, 128), tol=1e-6,
                                    maxiter=10)
    assert fused_batch_cg_solve_torch.launches == before + 1
    assert k.tolist() == [1, 1]
    torch.testing.assert_close(x, torch.tensor([0.5, 0.25])[:, None].expand(2, 128))


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
def test_circulant_batch_laps_are_set_by_the_spectra(precondition):
    # System i has 1 + i % 6 eigenvalue levels and a constant diagonal:
    # CG and Jacobi-PCG end in that many laps, in both packages and in K5's
    # plain version; the last system starts at its solution.
    nsys, n = 8, 128
    As, bs, X0 = circulant_spd_batch(nsys, n, seed=7)
    want = [1 + i % 6 for i in range(nsys - 1)] + [0]
    np.testing.assert_array_equal(np.diagonal(As, axis1=1, axis2=2),
                                  np.diagonal(As, axis1=1, axis2=2)[:, :1].repeat(n, 1))
    np.testing.assert_allclose(As, np.swapaxes(As, 1, 2), rtol=0, atol=1e-4)
    port = cg_solve_batch(As, bs, X0, device=CPU, tol=1e-2, precondition=precondition)
    assert port.iterations.tolist() == want
    (xj, kj, _), (xt, kt, _) = _both_k5(As, bs, X0, tol=1e-2, maxiter=n,
                                        precondition=precondition)
    assert kt.tolist() == kj.tolist() == want
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.x.numpy(), xt, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
def test_shifted_batch_stops_within_a_lap_of_tpucg(precondition):
    # Systems with their own seeds and shifts at tol 1e-6 stop where the
    # rounding of r is of the order of tol: two correct f32 orders of
    # summation may stop a lap apart, never more, with x close relative to
    # its size; the last system starts at its solution.
    nsys, n = 6, 128
    As, bs, X0 = shifted_spd_batch(nsys, n, seed=11)
    (xj, kj, rj), (xt, kt, rt) = _both_k5(As, bs, X0, tol=1e-6, maxiter=n,
                                          precondition=precondition)
    assert kt[-1] == kj[-1] == 0 and (kt[:-1] > 0).all()
    assert np.abs(kt - kj).max() <= 1
    assert (rt < 1e-12).all() and (rj < 1e-12).all()
    assert scaled_err(xt, xj) <= 1e-4
