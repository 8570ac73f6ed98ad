"""tpucg_torch's true block CG (``cg_solve_block``: ``block_cg_loop``,
``block_pcg_loop`` and their k x k algebra) against tpucg on the CPU: the
serial cases of tpucg's ``tests/test_block.py``, on the same NumPy inputs.

Tolerances: the shared lap count within one of tpucg's (equal where the
spectra set it: a circulant system of m levels, k = 1); x within 1e-5 of
max |x| where the laps are equal, or tpucg's own test's tolerance where it
is looser (the Jacobi and block-Jacobi routes: 1e-3 and 5e-3 relative, as
tpucg holds them to its single-vector solves), or where the stop at 1e-4
||b|| on a spread spectrum bounds it (the fuzz cases: 2e-3); every column's true
residual within tpucg's contract (the M^-1/2-weighted norm under Jacobi);
the result's fields and shapes are tpucg's. The k x k helpers are held to
tpucg's on random SPD Grams within 1e-4 of their largest entry (two f32
factorizations of one matrix, summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
import tpucg.solver.cg as jcg
from _torch_helpers import (
    circulant_spd_batch,
    laplacian1d,
    scaled_err,
    tpucg_padded_dense,
)
from tpucg.solver.operators import DiaOperator as JDiaOperator
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
import tpucg_torch.solver.cg as cg
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.solver.cg import BLOCK_CG_MAX_K, cg_solve, cg_solve_block, cg_solve_multi
from tpucg_torch.solver.operators import DiaOperator, PoissonOperator
from tpucg_torch.solver.oracle import oracle_cg
from tpucg_torch.sparse.formats import DIAMatrix

CPU = torch.device("cpu")


def _held(port, ref, laps=1, x_tol=1e-5):
    """The port's block result against tpucg's: fields and shapes, the
    shared laps within ``laps``, ``converged``, and x within ``x_tol`` of
    max |x| where the laps are equal."""
    assert port.x.shape == np.asarray(ref.x).shape
    assert port.iterations.dim() == 0 and port.iterations.dtype == torch.int32
    for f in ("residual_norm", "converged"):
        assert tuple(getattr(port, f).shape) == np.asarray(getattr(ref, f)).shape, f
    k, jk = int(port.iterations), int(ref.iterations)
    assert abs(k - jk) <= laps, (k, jk)
    np.testing.assert_array_equal(port.converged.numpy(), np.asarray(ref.converged))
    if k == jk:
        assert scaled_err(port.x.numpy(), np.asarray(ref.x)) <= x_tol


@pytest.fixture(scope="module")
def gen128():
    n, k = 128, 4
    A, _, _ = generate_spd_system(n, seed=0)
    B = np.random.default_rng(1).standard_normal((n, k)).astype(np.float32)
    return A, B, tpucg.cg_solve_block(A, B)


def test_block_parity_with_oracle(gen128):
    A, B, ref = gen128
    n, k = B.shape
    res = cg_solve_block(A, B, device=CPU)
    assert bool(res.converged.all()) and res.x.shape == (n, k)
    _held(res, ref)
    for j in range(k):
        x_ref, _, _ = oracle_cg(A, B[:, j], np.zeros(n, np.float32))
        np.testing.assert_allclose(res.x[:, j].numpy(), x_ref, rtol=1e-4, atol=1e-5)


def test_block_laps_are_set_by_the_spectrum():
    # A circulant system of 4 levels: the block space holds the solution
    # after 4 laps at k = 1 (block CG is CG) in both packages.
    As, _, _ = circulant_spd_batch(6, 256, seed=1)
    B = np.random.default_rng(2).random((256, 1)).astype(np.float32)
    res = cg_solve_block(As[3], B, device=CPU, tol=1e-2)
    ref = tpucg.cg_solve_block(tpucg_padded_dense(As[3]), B, tol=1e-2)
    assert int(res.iterations) == int(ref.iterations) == 4
    _held(res, ref, laps=0)


@pytest.fixture(scope="module")
def lap256():
    n, k = 256, 8
    A = laplacian1d(n)
    B = np.random.default_rng(2).standard_normal((n, k)).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(B[:, 0]))
    return A, B, tol, tpucg.cg_solve_block(A, B, tol=tol, maxiter=4 * n)


def test_block_beats_single_vector_iterations(lap256):
    A, B, tol, ref = lap256
    n, k = B.shape
    res = cg_solve_block(A, B, tol=tol, maxiter=4 * n, device=CPU)
    assert bool(res.converged.all())
    _held(res, ref, laps=2, x_tol=1e-4)
    worst_single = max(int(cg_solve(A, B[:, j], tol=tol, maxiter=4 * n, device=CPU,
                                    fused="never").iterations) for j in range(k))
    assert int(res.iterations) < worst_single
    multi = cg_solve_multi(A, B, tol=tol, maxiter=4 * n, device=CPU)
    assert int(res.iterations) < int(multi.iterations.max())


def test_block_k1_degenerates_to_cg():
    n = 96
    A, b, x0 = generate_spd_system(n, seed=3)
    ref = cg_solve(A, b, x0, device=CPU)
    res = cg_solve_block(A, b[:, None], x0[:, None], device=CPU)
    assert bool(res.converged.all())
    assert abs(int(res.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(res.x[:, 0].numpy(), ref.x.numpy(), rtol=1e-4, atol=1e-6)
    _held(res, tpucg.cg_solve_block(A, b[:, None], x0[:, None]))


def test_block_duplicate_columns_rank_deficient():
    n = 96
    A, b, _ = generate_spd_system(n, seed=4)
    B = np.stack([b, b], axis=1)
    res = cg_solve_block(A, B, device=CPU)
    assert bool(res.converged.all()) and bool(torch.isfinite(res.x).all())
    np.testing.assert_allclose(res.x[:, 0].numpy(), res.x[:, 1].numpy(), rtol=1e-5, atol=1e-6)
    x_ref, _, _ = oracle_cg(A, B[:, 0], np.zeros(n, np.float32))
    np.testing.assert_allclose(res.x[:, 0].numpy(), x_ref, rtol=1e-4, atol=1e-5)
    _held(res, tpucg.cg_solve_block(A, B))


def test_block_mixed_difficulty_freezes_converged_columns():
    n, k = 192, 3
    A = laplacian1d(n)
    _, V = np.linalg.eigh(A)
    B = np.random.default_rng(5).standard_normal((n, k)).astype(np.float32)
    B[:, 0] = (A @ V[:, n // 2]).astype(np.float32)  # x* an eigenvector
    tol = 1e-4 * float(np.linalg.norm(B[:, 1]))
    res = cg_solve_block(A, B, tol=tol, maxiter=4 * n, device=CPU)
    assert bool(res.converged.all())
    for j in range(k):
        assert np.linalg.norm(B[:, j] - A @ res.x[:, j].numpy()) < 5 * tol, j
    _held(res, tpucg.cg_solve_block(A, B, tol=tol, maxiter=4 * n), laps=2, x_tol=1e-4)


def test_block_operator_stencil():
    m, k = 8, 4
    op = PoissonOperator(m, device=CPU)
    n = m ** 3
    X_true = np.random.default_rng(6).standard_normal((n, k)).astype(np.float32)
    B = op.matvec_multi(torch.from_numpy(X_true)).numpy()
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    res = cg_solve_block(op, B, tol=tol, maxiter=4 * n)
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.x.numpy(), X_true, atol=1e-3)
    multi = cg_solve_multi(op, B, tol=tol, maxiter=4 * n)
    assert int(res.iterations) <= int(multi.iterations.max())
    _held(res, tpucg.cg_solve_block(JPoissonOperator(m=m, kernel="xla"), B, tol=tol,
                                    maxiter=4 * n))


def test_block_validation():
    A, b, _ = generate_spd_system(32, seed=0)
    with pytest.raises(ValueError, match="shape"):
        cg_solve_block(A, b, device=CPU)  # 1-D B
    with pytest.raises(ValueError, match="method"):
        cg_solve_block(A, b[:, None], method="pipelined", device=CPU)
    with pytest.raises(ValueError, match="precondition"):
        cg_solve_block(A, b[:, None], method="ca", device=CPU)


def test_block_k_cap():
    A, _, _ = generate_spd_system(64, seed=0)
    assert BLOCK_CG_MAX_K == jcg.BLOCK_CG_MAX_K == 32
    with pytest.raises(ValueError, match="k <= 32"):
        cg_solve_block(A, np.ones((64, 33), np.float32), device=CPU)


def test_block_jacobi_equilibration():
    n, k = 192, 4
    rng = np.random.default_rng(11)
    A, _, _ = generate_spd_system(n, seed=11)
    d = np.exp(rng.uniform(0.0, np.log(1e3), n)).astype(np.float32)
    A = (A * d[:, None] * d[None, :]).astype(np.float32)
    B = rng.standard_normal((n, k)).astype(np.float32)
    scale = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-5 * float(np.linalg.norm(scale * B[:, 0]))
    pc = cg_solve_block(A, B, precondition="jacobi", tol=tol, maxiter=4 * n, device=CPU)
    assert bool(pc.converged.all()) and int(pc.iterations) <= 40
    for j in range(k):
        assert np.linalg.norm(scale * (B[:, j] - A @ pc.x[:, j].numpy())) < 5 * tol, j
    _held(pc, tpucg.cg_solve_block(A, B, precondition="jacobi", tol=tol, maxiter=4 * n),
          x_tol=1e-3)


@pytest.fixture(scope="module")
def scaled_band():
    n, k = 192, 4
    rng = np.random.default_rng(12)
    band = (3 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)
    d = np.exp(rng.uniform(0.0, np.log(100.0), n)).astype(np.float32)
    A = (band * d[:, None] * d[None, :]).astype(np.float32)
    idx = np.arange(n)
    data = np.zeros((3, n), np.float32)
    data[0, idx[1:]] = A[idx[1:], idx[1:] - 1]
    data[1] = np.diag(A)
    data[2, idx[:-1]] = A[idx[:-1], idx[:-1] + 1]
    B = rng.standard_normal((n, k)).astype(np.float32)
    return A, data, B


def test_block_jacobi_matrix_free_operator(scaled_band):
    A, data, B = scaled_band
    n, k = B.shape
    dia = DIAMatrix(offsets=np.array([-1, 0, 1]), data=data, shape=(n, n))
    np.testing.assert_allclose(dia.to_dense(), A)
    op = DiaOperator.from_dia(dia, device=CPU)
    scale = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-5 * float(np.linalg.norm(scale * B[:, 0]))
    mf = cg_solve_block(op, B, precondition="jacobi", tol=tol, maxiter=4 * n)
    assert bool(mf.converged.all())
    plain = cg_solve_block(op, B, tol=tol, maxiter=4 * n)
    assert int(mf.iterations) < int(plain.iterations)
    dense = cg_solve_block(A, B, precondition="jacobi", tol=tol, maxiter=4 * n, device=CPU)
    for j in range(k):
        assert np.linalg.norm(scale * (B[:, j] - A @ mf.x[:, j].numpy())) < 5 * tol, j
    np.testing.assert_allclose(mf.x.numpy(), dense.x.numpy(), rtol=1e-3, atol=1e-4)
    jop = JDiaOperator.from_dia(tpucg.sparse.formats.DIAMatrix(
        offsets=np.array([-1, 0, 1]), data=data, shape=(n, n)), backend="xla")
    _held(mf, tpucg.cg_solve_block(jop, B, precondition="jacobi", tol=tol, maxiter=4 * n),
          x_tol=1e-3)


def test_block_poly_preconditioned():
    m, k = 8, 4
    op = PoissonOperator(m, device=CPU)
    n = m ** 3
    B = np.random.default_rng(13).standard_normal((n, k)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(B[:, 0]))
    kw = dict(tol=tol, maxiter=4 * n, precondition="poly", poly_degree=3)
    pr = cg_solve_block(op, B, **kw)
    assert bool(pr.converged.all())
    plain = cg_solve_block(op, B, tol=tol, maxiter=4 * n)
    assert int(pr.iterations) < int(plain.iterations)
    for j in range(k):
        ref = cg_solve(op, B[:, j], fused="never", **kw)
        np.testing.assert_allclose(pr.x[:, j].numpy(), ref.x.numpy(), rtol=1e-3, atol=1e-4)
    _held(pr, tpucg.cg_solve_block(JPoissonOperator(m=m, kernel="xla"), B, **kw), x_tol=1e-4)
    # Zero columns stay finite through the signed pair Gram.
    rz = cg_solve_block(op, np.zeros((n, 2), np.float32), precondition="poly", poly_degree=2)
    assert bool(rz.converged.all()) and bool(torch.isfinite(rz.x).all())


def test_block_zero_columns_do_not_nan():
    n = 32
    A, b, _ = generate_spd_system(n, seed=0)
    r = cg_solve_block(A, np.zeros((n, 2), np.float32), device=CPU)
    assert bool(r.converged.all()) and bool(torch.isfinite(r.x).all())
    assert float(r.x.abs().max()) == 0.0
    B = np.stack([np.zeros(n, np.float32), b], axis=1)
    r2 = cg_solve_block(A, B, device=CPU)
    assert bool(r2.converged.all()) and float(r2.x[:, 0].abs().max()) == 0.0
    x_ref, _, _ = oracle_cg(A, b, np.zeros(n, np.float32))
    np.testing.assert_allclose(r2.x[:, 1].numpy(), x_ref, rtol=1e-4, atol=1e-5)
    _held(r2, tpucg.cg_solve_block(tpucg_padded_dense(A), B))


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 5), (3, 6)])
def test_block_fuzz_random_spectra(seed, k):
    n = 96
    rng = np.random.default_rng(seed)
    w = np.exp(rng.uniform(np.log(0.1), np.log(10.0), n))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((Q * w) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    B = rng.standard_normal((n, k)).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(B[:, 0]))
    res = cg_solve_block(A, B, tol=tol, maxiter=8 * n, device=CPU)
    assert bool(res.converged.all()), (seed, k)
    for j in range(k):
        resid = np.linalg.norm(B[:, j].astype(np.float64)
                               - A.astype(np.float64) @ res.x[:, j].numpy())
        assert resid < 5 * tol, (seed, k, j, resid)
    # Each solve stops at 1e-4 ||b|| on a spectrum spread 100x: two f32
    # solves that both meet tol agree to ~kappa tol, not to 1e-5.
    _held(res, tpucg.cg_solve_block(tpucg_padded_dense(A), B, tol=tol, maxiter=8 * n),
          laps=2, x_tol=2e-3)


def test_block_cg_block_jacobi():
    n, k = 512, 4
    rng = np.random.default_rng(15)
    band = 2.05 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    d = np.exp(rng.uniform(0.0, np.log(30.0), n))
    A = (band * d[:, None] * d[None, :]).astype(np.float32)
    B = rng.standard_normal((n, k)).astype(np.float32)
    sc = 1.0 / np.sqrt(np.diag(A))
    tol = 1e-4 * float(np.linalg.norm(sc * B[:, 0]))
    kw = dict(tol=tol, maxiter=8 * n)
    rj = cg_solve_block(A, B, precondition="jacobi", device=CPU, **kw)
    rbj = cg_solve_block(A, B, precondition="block_jacobi", pc_block_size=64, device=CPU, **kw)
    assert bool(rbj.converged.all()) and int(rbj.iterations) < int(rj.iterations)
    for j in range(k):
        ref = cg_solve(A, B[:, j], precondition="block_jacobi", pc_block_size=64, device=CPU,
                       fused="never", **kw)
        np.testing.assert_allclose(rbj.x[:, j].numpy(), ref.x.numpy(), rtol=5e-3, atol=1e-3)
    _held(rbj, tpucg.cg_solve_block(A, B, precondition="block_jacobi", pc_block_size=64, **kw),
          laps=2, x_tol=5e-3)


def test_block_chunk_sizes_are_bit_identical():
    # A lap enqueued after the inner loop's stop changes nothing.
    A, _, _ = generate_spd_system(200, seed=9)
    B = np.random.default_rng(10).standard_normal((200, 3)).astype(np.float32)
    runs = [cg_solve_block(A, B, device=CPU, chunk=c, tol=1e-5) for c in (None, 1, 3, 64)]
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f


def test_block_maxiter_zero_runs_nothing():
    A, _, _ = generate_spd_system(64, seed=0)
    B = np.ones((64, 2), np.float32)
    res = cg_solve_block(A, B, device=CPU, maxiter=0)
    ref = tpucg.cg_solve_block(tpucg_padded_dense(A), B, maxiter=0)
    assert int(res.iterations) == int(ref.iterations) == 0
    assert bool(torch.isinf(res.residual_norm).all()) and not bool(res.converged.any())
    assert np.isinf(np.asarray(ref.residual_norm)).all()


# ---- the k x k algebra against tpucg's ------------------------------------


def _spd_gram(k, seed, spread=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    w = np.exp(rng.uniform(0.0, np.log(spread), k))
    G = ((Q * w) @ Q.T).astype(np.float32)
    return 0.5 * (G + G.T)


def _close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_kxk_helpers_match_tpucgs(k):
    G = _spd_gram(k, seed=k)
    eye = np.eye(k, dtype=np.float32)
    Gt, eyet = torch.from_numpy(G), torch.from_numpy(eye)
    L = cg._chol_lower(Gt, k)
    _close(L, jcg._chol_lower(jnp.asarray(G), k))
    np.testing.assert_allclose((L @ L.T).numpy(), G, rtol=1e-4, atol=1e-4 * np.abs(G).max())
    M = np.random.default_rng(k).standard_normal((k, 5)).astype(np.float32)
    _close(cg._tri_solve_lower(L, torch.from_numpy(M), k),
           jcg._tri_solve_lower(jnp.asarray(np.asarray(L)), jnp.asarray(M), k))
    _close(cg._spd_inv(Gt, eyet, k), jcg._spd_inv(jnp.asarray(G), jnp.asarray(eye), k), 1e-3)
    # The diagonal floor: a zero Gram factors to finite values.
    assert bool(torch.isfinite(cg._chol_lower(torch.zeros(k, k), k)).all())


@pytest.mark.parametrize("k", [1, 4])
def test_cholqr_helpers_match_tpucgs(k):
    n = 64
    rng = np.random.default_rng(20 + k)
    Y = rng.standard_normal((n, k)).astype(np.float32) * np.logspace(0, 3, k,
                                                                     dtype=np.float32)
    d = np.exp(rng.uniform(0.0, 1.0, n)).astype(np.float32)  # a Jacobi M^-1
    eye = np.eye(k, dtype=np.float32)
    gram_t, gram_j = (lambda U, V: U.T @ V), (lambda U, V: U.T @ V)
    Yt, eyet = torch.from_numpy(Y), torch.from_numpy(eye)
    Q, R = cg._cholqr2(gram_t, Yt, eyet)
    jQ, jR = jcg._cholqr2(gram_j, jnp.asarray(Y), jnp.asarray(eye))
    _close(Q, jQ)
    _close(R, jR)
    np.testing.assert_allclose((Q.T @ Q).numpy(), eye, atol=1e-5)
    dt = torch.from_numpy(d)[:, None]
    pc_t = lambda V: dt * V  # noqa: E731
    pc_j = lambda V: jnp.asarray(d)[:, None] * V  # noqa: E731
    U, V, C = cg._cholqr2_pc(gram_t, pc_t, Yt, pc_t(Yt), eyet)
    jU, jV, jC = jcg._cholqr2_pc(gram_j, pc_j, jnp.asarray(Y), pc_j(jnp.asarray(Y)),
                                 jnp.asarray(eye))
    for got, want in ((U, jU), (V, jV), (C, jC)):
        _close(got, want)
    np.testing.assert_allclose((V.T @ (dt * V)).numpy(), eye, atol=1e-5)
    # Zero columns keep finite factors (the 1e-15 / 1e-18 floors).
    Z = torch.zeros(n, k)
    assert all(bool(torch.isfinite(t).all()) for t in cg._cholqr2(gram_t, Z, eyet))
    assert all(bool(torch.isfinite(t).all()) for t in cg._cholqr2_pc(gram_t, pc_t, Z, Z, eyet))


def test_block_sqrt_pair_and_apply_match_tpucgs():
    rng = np.random.default_rng(30)
    blocks = np.stack([_spd_gram(8, s) for s in range(5)])
    blocks[-1] = 0.0  # a singular block: the eigenvalue floor keeps it finite
    isq, sq = cg.sqrt_pair_blocks(torch.from_numpy(blocks))
    jisq, jsq = jcg.sqrt_pair_blocks(jnp.asarray(blocks))
    assert bool(torch.isfinite(isq).all()) and bool(torch.isfinite(sq).all())
    for got, want in ((isq[:-1], jisq[:-1]), (sq[:-1], jsq[:-1])):
        _close(got, want, 1e-3)
    Y = rng.standard_normal((37, 3)).astype(np.float32)
    app = cg.make_block_apply(sq, 37)(torch.from_numpy(Y))
    _close(app, jcg.make_block_apply(jnp.asarray(sq.numpy()), 37)(jnp.asarray(Y)))
