"""tpucg_torch's block Jacobi (``precondition="block_jacobi"``) against
tpucg on the CPU: the block-Jacobi cases of tpucg's ``tests/test_precond.py``
that run serially. ``diagonal_blocks`` is held bit for bit on the dense,
DIA (canonical, and tpucg's interleaved slab carried across), Poisson and
WELL operators; the inverted blocks within 1e-5 of max |minv|; solves by
``_torch_helpers.held_to`` (laps within one, equal where the spectrum sets
them; x within 1e-5 of max |x| at equal laps, or within tpucg's own error
on an ill-conditioned system)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpucg
import tpucg.sparse.formats as jfmt
from _torch_helpers import held_to, laplacian1d, scaled_err, tpucg_padded_dense
from tpucg.solver.cg import block_jacobi_minv as j_block_jacobi_minv
from tpucg.solver.cg import make_block_precond as j_make_block_precond
from tpucg.solver.operators import DiaOperator as JDiaOperator
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg.solver.operators import WellOperator as JWellOperator
from tpucg_torch.config import CGConfig
from tpucg_torch.interop import dia_operator_from_numpy, well_operator_from_numpy
from tpucg_torch.io.generator import fem_p1_system, poisson3d_csr, random_geometric_spd
from tpucg_torch.solver.cg import (
    block_jacobi_minv,
    cg_solve,
    cg_solve_batch,
    make_block_precond,
)
from tpucg_torch.solver.operators import (
    DenseOperator,
    DiaOperator,
    EllOperator,
    PoissonOperator,
    WellOperator,
    best_sparse_operator,
)
from tpucg_torch.sparse.formats import COOMatrix, DIAMatrix

CPU = torch.device("cpu")


def _blocks_ref(A, bs):
    """The (nb, bs, bs) diagonal blocks of a dense A, identity past its end."""
    N = A.shape[0]
    nb = -(-N // bs)
    out = np.zeros((nb, bs, bs), np.float32)
    for q in range(nb):
        lo, hi = q * bs, min((q + 1) * bs, N)
        out[q, :hi - lo, :hi - lo] = A[lo:hi, lo:hi]
        for r in range(hi - lo, bs):
            out[q, r, r] = 1.0
    return out


def _jcsr(csr):
    return jfmt.CSRMatrix(indptr=csr.indptr, indices=csr.indices, data=csr.data, shape=csr.shape)


@pytest.mark.parametrize("bs", [8, 48, 64])
def test_dense_diagonal_blocks_are_tpucgs(bs):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, 100)).astype(np.float32)
    A = A + A.T + 200 * np.eye(100, dtype=np.float32)
    op = DenseOperator.create(A, device=CPU)
    got = op.diagonal_blocks(bs).numpy()
    jop = tpucg.DenseOperator.create(A, backend="pallas")  # padded to 128, as the port's
    np.testing.assert_array_equal(got, np.asarray(jop.diagonal_blocks(bs)))
    np.testing.assert_array_equal(got, _blocks_ref(op.A.numpy(), bs))
    bf = DenseOperator.create(A, device=CPU, dtype=torch.bfloat16).diagonal_blocks(bs)
    assert bf.dtype == torch.float32


def _band(n, offs, seed=0):
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offs), n), np.float32)
    Ad = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        v = rng.standard_normal(hi - lo).astype(np.float32)
        data[d, lo:hi] = v
        Ad[idx[lo:hi], idx[lo:hi] + off] = v
    return data, Ad


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("bs", [8, 64])
def test_dia_diagonal_blocks_are_tpucgs(n, bs):
    offs = [-7, -1, 0, 1, 7]
    data, Ad = _band(n, offs)
    op = DiaOperator.from_dia(DIAMatrix(offsets=np.array(offs), data=data, shape=(n, n)),
                              device=CPU)
    got = op.diagonal_blocks(bs).numpy()
    Adp = np.eye(op.padded_n, dtype=np.float32)
    Adp[:n, :n] = Ad
    np.testing.assert_array_equal(got, _blocks_ref(Adp, bs))
    jdia = jfmt.DIAMatrix(offsets=np.array(offs), data=data, shape=(n, n))
    # "pallas" packs tpucg's slab interleaved (and pads as the port pads);
    # its blocks come from the de-interleaved slab.
    jop = JDiaOperator.from_dia(jdia, backend="pallas")
    assert jop.interleaved and jop.padded_n == op.padded_n
    np.testing.assert_array_equal(got, np.asarray(jop.diagonal_blocks(bs)))
    carried = dia_operator_from_numpy(np.asarray(jop.data), jop.offsets, n, interleaved=True)
    np.testing.assert_array_equal(carried.diagonal_blocks(bs).numpy(), got)
    bf = DiaOperator.from_dia(DIAMatrix(offsets=np.array(offs), data=data, shape=(n, n)),
                              device=CPU, storage_dtype=torch.bfloat16).diagonal_blocks(bs)
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("bs", [4, 16, 128])
def test_poisson_diagonal_blocks_are_tpucgs(bs):
    # 128 > m^2: all three stencil offsets land inside a block.
    got = PoissonOperator(8, device=CPU).diagonal_blocks(bs).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        JPoissonOperator(m=8, kernel="xla").diagonal_blocks(bs)))
    np.testing.assert_array_equal(
        got, _blocks_ref(poisson3d_csr(8).to_dense().astype(np.float32), bs))


@pytest.mark.parametrize("bs", [16, 64])
def test_well_diagonal_blocks_are_tpucgs(bs):
    A, _, _ = random_geometric_spd(600, seed=8)
    op = WellOperator.from_csr(A, device=CPU, pc_block_size=bs)
    jop = JWellOperator.from_csr(_jcsr(A), backend="xla", pc_block_size=bs)
    np.testing.assert_array_equal(op.diagonal_blocks(bs).numpy(), np.asarray(jop.dblk))
    promoted = best_sparse_operator(A, device=CPU, pc_block_size=bs)
    assert isinstance(promoted, WellOperator)
    np.testing.assert_array_equal(promoted.dblk.numpy(), np.asarray(jop.dblk))
    carried = well_operator_from_numpy(*(np.asarray(getattr(jop, f)) for f in (
        "vals", "lidx", "gidl", "wrow", "sgb", "dvec")), jop.n, jop.bg, jop.nsg,
        dblk=np.asarray(jop.dblk))
    np.testing.assert_array_equal(carried.diagonal_blocks(bs).numpy(), np.asarray(jop.dblk))
    with pytest.raises(ValueError, match=f"pc_block_size={bs}"):
        op.diagonal_blocks(bs // 2)


def test_operators_without_blocks_refuse_as_tpucg_does():
    bare = WellOperator.from_csr(random_geometric_spd(600, seed=8)[0], device=CPU)
    with pytest.raises(NotImplementedError, match="from_csr"):
        bare.diagonal_blocks(16)
    ell = EllOperator.from_csr(poisson3d_csr(4), device=CPU)
    with pytest.raises(NotImplementedError, match="does not expose diagonal blocks"):
        ell.diagonal_blocks(16)
    with pytest.raises(NotImplementedError, match="does not expose diagonal blocks"):
        cg_solve(ell, np.ones(64, np.float32), precondition="block_jacobi")
    with pytest.raises(ValueError, match="pc_block_size"):
        CGConfig(precondition="block_jacobi", pc_block_size=1)
    L = laplacian1d(256)
    b = np.ones(256, np.float32)
    with pytest.raises(ValueError, match="block"):
        cg_solve_batch(np.stack([L, L]), np.stack([b, b]), precondition="block_jacobi",
                       device=CPU)


@pytest.mark.parametrize("bs", [8, 24, 64])
def test_minv_and_its_apply_match_tpucg(bs):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((300, 300)).astype(np.float32)
    A = (A @ A.T / 300 + np.eye(300)).astype(np.float32)
    op = DenseOperator.create(A, device=CPU)
    minv = block_jacobi_minv(op, bs)
    jminv = np.asarray(j_block_jacobi_minv(tpucg.DenseOperator.create(A, backend="pallas"), bs))
    assert minv.shape == jminv.shape == (-(-op.padded_n // bs), bs, bs)
    assert np.abs(minv.numpy() - jminv).max() <= 1e-5 * np.abs(jminv).max()
    assert torch.equal(minv, minv.transpose(1, 2))
    r = rng.standard_normal(op.padded_n).astype(np.float32)
    z = make_block_precond(minv, op.padded_n)(torch.from_numpy(r))
    jz = np.asarray(j_make_block_precond(jnp.asarray(jminv), op.padded_n)(jnp.asarray(r)))
    assert z.shape == (op.padded_n,)
    assert scaled_err(z.numpy(), jz) <= 1e-5


def test_block_jacobi_beats_plain_and_point_on_band():
    # A constant-diagonal band: point Jacobi changes nothing, block Jacobi
    # absorbs the in-block band and cuts the laps 4x.
    n = 1024
    L = laplacian1d(n)
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=8 * n)
    plain = cg_solve(L, b, device=CPU, **kw)
    bj = cg_solve(L, b, device=CPU, precondition="block_jacobi", pc_block_size=64, **kw)
    ref = tpucg.cg_solve(L, b, precondition="block_jacobi", pc_block_size=64, **kw)
    assert bool(bj.converged)
    held_to(bj, ref, 1, x_true=np.linalg.solve(L.astype(np.float64), b))
    assert int(bj.iterations) * 4 < int(plain.iterations)
    assert np.linalg.norm(b - L @ bj.x.numpy()) < 2 * tol


@pytest.mark.parametrize("layout", ["canonical", "interleaved"])
def test_block_jacobi_on_dia(layout):
    n = 512
    L = laplacian1d(n)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tol = 4e-3 * float(np.linalg.norm(b))
    idx = np.arange(n)
    data = np.zeros((3, n), np.float32)
    data[0, idx[1:]] = -1.0
    data[1] = 2.0
    data[2, idx[:-1]] = -1.0
    jdia = jfmt.DIAMatrix(offsets=np.array([-1, 0, 1]), data=data, shape=(n, n))
    jop = JDiaOperator.from_dia(jdia, backend="pallas" if layout == "interleaved" else "xla")
    if layout == "interleaved":
        op = dia_operator_from_numpy(np.asarray(jop.data), jop.offsets, n, interleaved=True)
    else:
        op = DiaOperator.from_dia(DIAMatrix(offsets=np.array([-1, 0, 1]), data=data,
                                            shape=(n, n)), device=CPU)
    kw = dict(tol=tol, maxiter=8 * n, precondition="block_jacobi")
    res = cg_solve(op, b, **kw)
    ref = tpucg.cg_solve(JDiaOperator.from_dia(jdia, backend="xla"), b, **kw)
    assert bool(res.converged)
    held_to(res, ref, 1, x_true=np.linalg.solve(L.astype(np.float64), b))
    assert np.linalg.norm(b - L @ res.x.numpy()[:n]) < 2 * tol


def test_block_jacobi_chebyshev_composition():
    n = 512
    L = laplacian1d(n)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    kw = dict(tol=4e-3 * float(np.linalg.norm(b)), maxiter=8 * n, precondition="block_jacobi")
    ref_cg = cg_solve(L, b, device=CPU, **kw)
    rc = cg_solve(L, b, device=CPU, method="chebyshev", **kw)
    jrc = tpucg.cg_solve(L, b, method="chebyshev", **kw)
    assert bool(rc.converged)
    held_to(rc, jrc, 8, x_true=np.linalg.solve(L.astype(np.float64), b))
    np.testing.assert_allclose(rc.x.numpy(), ref_cg.x.numpy(), rtol=0.05,
                               atol=5e-2 * float(np.abs(ref_cg.x.numpy()).max()))


def test_block_jacobi_poisson_parity():
    m = 8
    n = m ** 3
    b = np.ones(n, np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=8 * n)
    p0 = cg_solve(PoissonOperator(m, device=CPU), b, **kw)
    pb = cg_solve(PoissonOperator(m, device=CPU), b, precondition="block_jacobi",
                  pc_block_size=64, **kw)
    ref = tpucg.cg_solve(JPoissonOperator(m=m, kernel="xla"), b, precondition="block_jacobi",
                         pc_block_size=64, **kw)
    assert bool(pb.converged) and int(pb.iterations) < int(p0.iterations)
    held_to(pb, ref, 1)
    np.testing.assert_allclose(pb.x.numpy(), p0.x.numpy(), rtol=1e-3, atol=1e-4)


def test_block_jacobi_non_dividing_block_size():
    # bs = 24 does not divide 256: the grid's tail blocks are identity. The
    # residuals agree to 3-4 digits through lap 23 (||r|| 4.3e-3, ||b|| =
    # 16); lap 24's last drop lands in f32 noise (2.1e-4 here, 4.7e-5 in
    # tpucg), so x is held to 1e-4 of max |x| (3e-5 apart), and at tpucg's
    # template tol 1e-5 the laps round apart (30 in tpucg, 37 here): tol is
    # 1e-3.
    n = 256
    L = laplacian1d(n)
    b = np.ones(n, np.float32)
    kw = dict(precondition="block_jacobi", pc_block_size=24, tol=1e-3)
    res = cg_solve(L, b, device=CPU, **kw)
    ref = tpucg.cg_solve(L, b, **kw)
    assert bool(res.converged) and bool(ref.converged)
    assert int(res.iterations) == int(ref.iterations) == 24
    assert scaled_err(res.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_block_jacobi_on_well_spectrum_sets_the_laps():
    # Block-diagonal 4 x 4 blocks: M = A up to the ridge, so one lap (plain
    # CG takes 8, tests/test_torch_well.py).
    rng = np.random.default_rng(0)
    n, bsz = 1000, 4
    Q, _ = np.linalg.qr(rng.standard_normal((bsz, bsz)))
    blk = (Q * np.array([1.0, 2.0, 4.0, 8.0])) @ Q.T
    r, c = np.meshgrid(np.arange(bsz), np.arange(bsz), indexing="ij")
    base = np.repeat(np.arange(n // bsz) * bsz, bsz * bsz)
    A = COOMatrix(row=base + np.tile(r.ravel(), n // bsz), col=base + np.tile(c.ravel(), n // bsz),
                  data=np.tile(blk.ravel(), n // bsz).astype(np.float32), shape=(n, n)).to_csr()
    b = rng.standard_normal(n).astype(np.float32)
    kw = dict(tol=1e-2, precondition="block_jacobi", pc_block_size=8, maxiter=50)
    res = cg_solve(WellOperator.from_csr(A, device=CPU, pc_block_size=8), b, **kw)
    ref = tpucg.cg_solve(JWellOperator.from_csr(_jcsr(A), backend="xla", pc_block_size=8), b,
                         **kw)
    assert int(res.iterations) == int(ref.iterations) == 1
    assert scaled_err(res.x.numpy(), np.asarray(ref.x)) <= 1e-5


def test_block_jacobi_on_fem_well_matches_tpucg():
    A, b, _ = fem_p1_system(1_500, seed=0)
    n = A.shape[0]
    tol = 1e-4 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=4 * n, precondition="block_jacobi", pc_block_size=32)
    res = cg_solve(best_sparse_operator(A, device=CPU, pc_block_size=32), b, **kw)
    ref = tpucg.cg_solve(tpucg.best_sparse_operator(_jcsr(A), backend="xla", pc_block_size=32),
                         b, **kw)
    jac = cg_solve(best_sparse_operator(A, device=CPU), b, tol=tol, maxiter=4 * n,
                   precondition="jacobi")
    assert bool(res.converged) and int(res.iterations) < int(jac.iterations)
    # Hundreds of laps on an FEM mesh: the trajectories round apart by a lap
    # or two.
    assert abs(int(res.iterations) - int(ref.iterations)) <= 0.02 * int(ref.iterations) + 1
    assert scaled_err(res.x.numpy(), np.asarray(ref.x)) <= 1e-3


def test_block_jacobi_pipelined_dense_padded():
    # A padded dense system (n = 200 -> 256) under pipelined PCG with blocks.
    rng = np.random.default_rng(3)
    A = rng.standard_normal((200, 200)).astype(np.float32)
    A = (A @ A.T / 200 + 0.5 * np.eye(200)).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=2000, method="pipelined",
              precondition="block_jacobi", pc_block_size=32)
    res = cg_solve(A, b, device=CPU, **kw)
    ref = tpucg.cg_solve(tpucg_padded_dense(A), b, **kw)
    assert bool(res.converged)
    held_to(res, ref, 1, x_true=np.linalg.solve(A.astype(np.float64), b))
