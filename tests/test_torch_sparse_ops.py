"""tpucg_torch's BSR and ELL path and ``best_sparse_operator`` against tpucg
on the CPU: ``csr_to_bsr``, ``csr_to_ell`` and ``csr_diagonal_blocks``
(array-equal), the ``EllOperator`` and ``BsrOperator`` products (plain torch
ops on either device, as tpucg's are XLA ops), the operators carried across
from tpucg, ``best_sparse_operator``'s choices and padding, ``as_operator``,
and CG solves through each format."""

import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.formats as jfmt
import tpucg.solver.operators as jops
from _torch_helpers import rel_err, scaled_err
from tpucg_torch.interop import bsr_operator_from_numpy, ell_operator_from_numpy
from tpucg_torch.io.generator import poisson3d_csr, random_geometric_spd
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import (
    BsrOperator,
    EllOperator,
    WellOperator,
    as_operator,
    best_sparse_operator,
)
from tpucg_torch.sparse.formats import (
    COOMatrix,
    csr_diagonal_blocks,
    csr_to_bsr,
    csr_to_ell,
)

CPU = torch.device("cpu")


def _blocky(nb=100, bs=8, seed=4):
    """tpucg's block-dense, diagonal-scattered SPD system
    (``tests/test_sparse.py:303-316``): dense 8 x 8 blocks on the block
    diagonal and one more per block row, symmetrised, plus nb I."""
    rng = np.random.default_rng(seed)
    A = np.zeros((nb, nb), np.float32)
    for br in range(nb // bs):
        A[br * bs:(br + 1) * bs, br * bs:(br + 1) * bs] = rng.random((bs, bs))
        bc = int(rng.integers(0, nb // bs))
        A[br * bs:(br + 1) * bs, bc * bs:(bc + 1) * bs] = rng.random((bs, bs))
    A = 0.5 * (A + A.T) + nb * np.eye(nb, dtype=np.float32)
    r, c = np.nonzero(A)
    return COOMatrix(row=r, col=c, data=A[r, c], shape=A.shape).to_csr(), A


def _scattered(n=96, seed=5):
    """tpucg's scattered-scalar SPD system (``tests/test_sparse.py:326-337``)."""
    rng = np.random.default_rng(seed)
    M = np.zeros((n, n), np.float32)
    np.add.at(M, (rng.integers(0, n, 300), rng.integers(0, n, 300)),
              rng.random(300).astype(np.float32))
    M = 0.5 * (M + M.T) + n * np.eye(n, dtype=np.float32)
    r, c = np.nonzero(M)
    return COOMatrix(row=r, col=c, data=M[r, c], shape=M.shape).to_csr(), M


def _arrays_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("which", ["blocky", "poisson", "odd"])
def test_csr_to_bsr_equals_tpucgs(which, bs):
    csr = {"blocky": lambda: _blocky()[0], "poisson": lambda: poisson3d_csr(4),
           "odd": lambda: _scattered(99)[0]}[which]()
    _arrays_equal(csr_to_bsr(csr, bs), jfmt.csr_to_bsr(csr, bs),
                  ("indptr", "indices", "data"))
    np.testing.assert_array_equal(csr_to_bsr(csr, bs).to_dense()[:csr.shape[0], :csr.shape[0]],
                                  csr.to_dense())


@pytest.mark.parametrize("align", [1, 8])
def test_csr_to_ell_equals_tpucgs(align):
    for csr in (_scattered()[0], poisson3d_csr(3), random_geometric_spd(500, seed=1)[0]):
        _arrays_equal(csr_to_ell(csr, align), jfmt.csr_to_ell(csr, align), ("values", "indices"))
        assert csr_to_ell(csr).nnz == jfmt.csr_to_ell(csr).nnz


@pytest.mark.parametrize("bs,npad,shards", [(48, 768, 1), (16, 704, 2), (8, None, 1)])
def test_csr_diagonal_blocks_equal_tpucgs(bs, npad, shards):
    A, _, _ = random_geometric_spd(700, seed=0, shift=0.3)
    np.testing.assert_array_equal(csr_diagonal_blocks(A, bs, npad=npad, shards=shards),
                                  jfmt.csr_diagonal_blocks(A, bs, npad=npad, shards=shards))


def test_ell_operator_matches_tpucgs():
    csr, M = _scattered()
    op = EllOperator.from_csr(csr, device=CPU)
    jop = jops.EllOperator.from_csr(csr)
    assert (op.n, op.padded_n, op.backend) == (jop.n, jop.padded_n, "torch")
    x = np.random.default_rng(1).standard_normal(op.n).astype(np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jop.matvec(x)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(y, M @ x, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    carried = ell_operator_from_numpy(np.asarray(jop.values), np.asarray(jop.indices), jop.n)
    np.testing.assert_array_equal(carried.matvec(torch.from_numpy(x)).numpy(), y)
    yy = torch.empty(op.n)
    op.launcher()(torch.from_numpy(x), yy, None, 0)  # the lap's core fills y
    np.testing.assert_array_equal(yy.numpy(), y)


def test_bsr_operator_matches_tpucgs():
    csr, A = _blocky()
    bsr = csr_to_bsr(csr, 4)
    op = BsrOperator.from_bsr(bsr, device=CPU)
    jop = jops.BsrOperator.from_bsr(jfmt.csr_to_bsr(csr, 4))
    assert (op.n, op.padded_n) == (jop.n, jop.padded_n) == (100, 100)
    x = np.random.default_rng(2).standard_normal(op.padded_n).astype(np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jop.matvec(x)), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(y, A @ x, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    carried = bsr_operator_from_numpy(np.asarray(jop.values), np.asarray(jop.indices), jop.n)
    np.testing.assert_array_equal(carried.matvec(torch.from_numpy(x)).numpy(), y)
    with pytest.raises(ValueError, match="BsrOperator needs"):
        BsrOperator(values=op.values, indices=op.indices[:, :0], n=100)


CHOICES = {
    # case: (csr maker, kwargs, expected class)
    "poisson": (lambda: poisson3d_csr(6), {}, "DiaOperator"),
    "poisson_odd": (lambda: poisson3d_csr(5), {}, "DiaOperator"),
    # n = 100: the skeleton is padded to 104 with an identity tail.
    "blocky": (lambda: _blocky()[0], dict(max_diags=8), "BsrOperator"),
    # 16 x 16 tiles store too many zeros (fill cap 3): WELL.
    "blocky_bs16": (lambda: _blocky()[0], dict(max_diags=8, blocksize=16), "WellOperator"),
    "geometric": (lambda: random_geometric_spd(1000, seed=6, avg_degree=9.0)[0], {},
                  "WellOperator"),
    "scattered": (lambda: _scattered()[0], dict(max_diags=8, bsr_fill_cap=1.2), "WellOperator"),
    "ell": (lambda: random_geometric_spd(1000, seed=6, avg_degree=9.0)[0],
            dict(fallback="ell"), "EllOperator"),
}


@pytest.mark.parametrize("case", sorted(CHOICES))
def test_best_sparse_operator_picks_as_tpucg(case):
    make, kw, want = CHOICES[case]
    csr = make()
    op = best_sparse_operator(csr, device=CPU, **kw)
    jop = jops.best_sparse_operator(csr, **kw)
    assert type(op).__name__ == type(jop).__name__ == want
    assert (op.n, op.padded_n) == (jop.n, jop.padded_n)
    if case == "blocky":
        assert (op.n, op.padded_n) == (100, 104)
    assert op.backend == "torch" and op.device == CPU
    x = np.random.default_rng(3).standard_normal(op.padded_n).astype(np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy()
    jy = np.asarray(jop.matvec(x))
    assert rel_err(y, jy) <= 1e-6


def test_best_sparse_operator_pc_block_size_names_m8():
    # pc_block_size (once refused as M8) has the WELL operator carry block
    # Jacobi's blocks, taken from the CSR as tpucg takes them.
    A, _, _ = random_geometric_spd(600, seed=8)
    op = best_sparse_operator(A, pc_block_size=32, device=CPU)
    jop = jops.best_sparse_operator(_tpucg_csr(A), backend="xla", pc_block_size=32)
    assert isinstance(op, WellOperator) and isinstance(jop, jops.WellOperator)
    np.testing.assert_array_equal(op.diagonal_blocks(32).numpy(), np.asarray(jop.dblk))
    assert best_sparse_operator(A, device=CPU).dblk is None


def _tpucg_csr(csr):
    return jfmt.CSRMatrix(indptr=csr.indptr, indices=csr.indices, data=csr.data, shape=csr.shape)


def test_as_operator_takes_sparse_containers_as_tpucg_does():
    csr, _ = _scattered()
    assert isinstance(as_operator(csr, device=CPU), EllOperator)
    assert isinstance(as_operator(_tpucg_csr(csr), device=CPU), EllOperator)
    assert isinstance(jops.as_operator(_tpucg_csr(csr)), jops.EllOperator)
    assert isinstance(as_operator(jfmt.csr_to_ell(csr), device=CPU), EllOperator)
    assert isinstance(as_operator(jfmt.csr_to_bsr(csr, 4), device=CPU), BsrOperator)
    from tpucg.sparse.well import csr_to_well as j_csr_to_well

    w = as_operator(j_csr_to_well(csr), device=CPU, dtype=torch.bfloat16)
    assert isinstance(w, WellOperator) and w.vals.dtype == torch.bfloat16
    assert isinstance(as_operator(poisson3d_csr(3), device=CPU), EllOperator)
    with pytest.raises(TypeError, match="to_csr"):
        as_operator(csr.to_coo(), device=CPU)
    with pytest.raises(TypeError, match="to_csr"):
        as_operator(torch.eye(3).to_sparse(), device=CPU)


@pytest.mark.parametrize("case", ["poisson", "blocky", "scattered", "ell"])
@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_cg_solve_through_each_format_matches_tpucg(case, pc):
    make, kw, _ = CHOICES[case]
    csr = make()
    n = csr.shape[0]
    b = np.random.default_rng(7).random(n).astype(np.float32)
    op = best_sparse_operator(csr, device=CPU, **kw)
    jop = jops.best_sparse_operator(csr, **kw)
    res = cg_solve(op, b, tol=1e-5, maxiter=4 * n, precondition=pc)
    jres = tpucg.cg_solve(jop, b, tol=1e-5, maxiter=4 * n, precondition=pc)
    assert bool(res.converged) and res.x.shape == (n,)
    assert abs(int(res.iterations) - int(jres.iterations)) <= 1
    assert scaled_err(res.x.numpy(), np.asarray(jres.x)[:n]) <= 1e-4


def test_cg_solve_bare_csr_goes_to_ell_as_in_tpucg():
    csr, M = _scattered()
    b = np.random.default_rng(8).random(96).astype(np.float32)
    res = cg_solve(csr, b, device=CPU, maxiter=400)
    jres = tpucg.cg_solve(_tpucg_csr(csr), b, maxiter=400)
    assert int(res.iterations) == int(jres.iterations) and bool(res.converged)
    np.testing.assert_allclose(M @ res.x.numpy(), b, atol=1e-4 * 96)
