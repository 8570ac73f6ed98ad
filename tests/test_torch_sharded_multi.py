"""tpucg_torch's sharded multi-RHS and block CG (ROADMAP M14 step 3:
``sharded_cg_solve_multi``, ``sharded_cg_solve_block``) over
torch.distributed (gloo on the CPU), against tpucg's at the same number of
ranks; a world of one rank against the port's serial solves; tpucg's
refusals.

Worlds of 2 and 4 ranks are spawned once for the module
(``_torch_helpers.run_world``); every rank runs every case of
``MULTI_CASES`` and ``BLOCK_CASES`` and rank 0 returns the results, while
this process solves each case with tpucg on ``make_mesh(P)`` of the 8 CPU
devices that ``tests/conftest.py`` forces. Tolerances follow tpucg's own
tests: a multi-RHS column's laps within one of tpucg's (each column is a
classic CG recurrence that stops where ||r|| meets tol within rounding), a
block solve's shared laps within one (two preconditioned: tpucg allows two
between its sharded and serial preconditioned block solves), x within 1e-4
of max |x| (1e-3 preconditioned, tpucg's own bound), every column
converged.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.formats as jfmt
from _torch_helpers import (
    BLOCK_CASES,
    MULTI_CASES,
    multi_case,
    multi_case_operator,
    run_world,
    scaled_err,
    sharded_multi_worker,
)
from tpucg.solver.operators import BsrOperator as JBsrOperator
from tpucg.solver.operators import EllOperator as JEllOperator
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.comm.mesh import init_distributed, make_mesh
from tpucg_torch.io.generator import generate_spd_system, poisson3d_dia, random_geometric_spd
from tpucg_torch.solver.cg import BLOCK_CG_MAX_K, cg_solve_block, cg_solve_multi
from tpucg_torch.solver.operators import DiaOperator, PoissonOperator, WellOperator
from tpucg_torch.solver.sharded import sharded_cg_solve_block, sharded_cg_solve_multi

WORLDS = (2, 4)
NAMES = list(MULTI_CASES) + list(BLOCK_CASES)


def _jax_operator(s):
    """tpucg's A of a case: the dense array, or tpucg's operator of the
    port's host container."""
    if "A" in s:
        return s["A"]
    op = s["op"]
    kind = type(op).__name__
    if isinstance(op, tuple):
        return JPoissonOperator(m=op[1])
    if kind == "DIAMatrix":
        return jfmt.DIAMatrix(offsets=op.offsets, data=op.data, shape=op.shape)
    if kind == "BSRMatrix":
        return JBsrOperator.from_bsr(jfmt.BSRMatrix(indptr=op.indptr, indices=op.indices,
                                                    data=op.data, shape=op.shape))
    csr = jfmt.CSRMatrix(indptr=op.indptr, indices=op.indices, data=op.data, shape=op.shape)
    return csr if s.get("well") else JEllOperator.from_csr(csr)


def _jax_case(name, P):
    s, B, kw = multi_case(name)
    solve = tpucg.sharded_cg_solve_multi if name in MULTI_CASES else tpucg.sharded_cg_solve_block
    res = solve(_jax_operator(s), B, mesh=tpucg.make_mesh(P), **kw)
    return {k: np.asarray(getattr(res, k))
            for k in ("x", "iterations", "residual_norm", "converged")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({P: {case: result}} from one spawned gloo world of each size, both
    running at once; {(case, P): tpucg's result}, solved meanwhile)."""
    tmp = tmp_path_factory.mktemp("rendezvous")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {P: pool.submit(run_world, P, sharded_multi_worker,
                                  rendezvous=str(tmp / f"world{P}")) for P in WORLDS}
        ref = {(name, P): _jax_case(name, P) for P in WORLDS for name in NAMES}
        return {P: f.result() for P, f in futures.items()}, ref


@pytest.fixture(scope="module")
def one_rank():
    """This process as a world of one rank (gloo, an in-process store)."""
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(MULTI_CASES))
def test_multi_matches_tpucg(runs, name, P):
    got, want = runs[0][P][name], runs[1][(name, P)]
    assert got["converged"].all() and want["converged"].all()
    assert got["x"].shape == want["x"].shape
    np.testing.assert_allclose(got["iterations"], want["iterations"], atol=1)
    assert scaled_err(got["x"].T, want["x"].T) <= 1e-4


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_block_matches_tpucg(runs, name, P):
    got, want = runs[0][P][name], runs[1][(name, P)]
    pc = BLOCK_CASES[name][2].get("precondition", "none")
    assert got["converged"].all() and want["converged"].all()
    assert got["iterations"].shape == ()
    assert abs(int(got["iterations"]) - int(want["iterations"])) <= (1 if pc == "none" else 2)
    assert got["x"].shape == want["x"].shape
    assert scaled_err(got["x"].T, want["x"].T) <= (1e-4 if pc == "none" else 1e-3)


@pytest.mark.parametrize("P", WORLDS)
def test_block_shares_laps_on_related_columns(runs, P):
    # tpucg's test_block.py:124: one block-Krylov space takes no more
    # laps than the slowest independent column (Poisson m = 8, k = 3).
    assert int(runs[0][P]["block_poisson_m8"]["iterations"]) <= \
        int(runs[0][P]["multi_poisson_m8_k3"]["iterations"].max())


# ---- one rank against the serial solves ---------------------------------------


@pytest.mark.parametrize("kind", ["dense", "poisson", "dia", "well"])
def test_one_rank_multi_equals_serial(one_rank, kind):
    # A world of one rank runs the serial multi-RHS loop on the same
    # product: x and every column's laps bit for bit (the dense operator
    # pads to 256 on both paths; the stencil and DIA products are the plain
    # k-column versions, each column the single-column one's).
    rng = np.random.default_rng(7)
    if kind == "dense":
        A = generate_spd_system(256, seed=3)[0]
        serial_A, n, tol = A, 256, 1e-6
    elif kind == "well":
        A = random_geometric_spd(1500, seed=3, avg_degree=8.0, shuffle=True)[0]
        serial_A, n, tol = WellOperator.from_csr(A, device="cpu"), 1500, 1e-3
    else:
        A = PoissonOperator(8, device="cpu") if kind == "poisson" else poisson3d_dia(8)
        serial_A = A if kind == "poisson" else DiaOperator.from_dia(A, device="cpu")
        n, tol = 512, 1e-3
    B = rng.standard_normal((n, 4)).astype(np.float32)
    got = sharded_cg_solve_multi(A, B, mesh=one_rank, tol=tol, maxiter=4 * n)
    want = cg_solve_multi(serial_A, B, device="cpu", tol=tol, maxiter=4 * n)
    assert got.converged.all() and torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.x, want.x)


@pytest.mark.parametrize("pc", ["none", "block_jacobi", "poly"])
def test_one_rank_block_equals_serial_dense(one_rank, pc):
    # Unpreconditioned, block Jacobi (the blocks' M^-1/2 around the product)
    # and poly (lambda_max through the k-column product's column 0) take the
    # serial solve's route on one rank: bit for bit.
    A = generate_spd_system(256, seed=4)[0]
    B = np.random.default_rng(8).standard_normal((256, 3)).astype(np.float32)
    kw = dict(precondition=pc, pc_block_size=32, poly_degree=2, tol=1e-5, maxiter=512)
    got = sharded_cg_solve_block(A, B, mesh=one_rank, **kw)
    want = cg_solve_block(A, B, device="cpu", **kw)
    assert got.converged.all() and int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)


# ---- tpucg's refusals and messages --------------------------------------------


def test_refusals_and_messages(one_rank):
    A, b, _ = generate_spd_system(32, seed=0)
    B = np.stack([b, b], 1)
    for kw in ({"method": "pipelined"}, {"precondition": "jacobi"}):
        with pytest.raises(ValueError, match="method='cg', precondition='none'"):
            sharded_cg_solve_multi(A, B, mesh=one_rank, **kw)
    with pytest.raises(ValueError, match="method"):
        sharded_cg_solve_block(A, B, mesh=one_rank, method="pipelined")
    with pytest.raises(ValueError, match="shape"):
        sharded_cg_solve_block(A, b, mesh=one_rank)
    with pytest.raises(ValueError, match=f"k <= {BLOCK_CG_MAX_K}"):
        sharded_cg_solve_block(A, np.ones((32, BLOCK_CG_MAX_K + 1), np.float32), mesh=one_rank)
    with pytest.raises(ValueError, match="block Jacobi on sharded sparse operators"):
        sharded_cg_solve_block(PoissonOperator(4, device="cpu"), np.ones((64, 2), np.float32),
                               mesh=one_rank, precondition="block_jacobi")
    with pytest.raises(TypeError, match="CSR"):
        sharded_cg_solve_multi(WellOperator.from_csr(random_geometric_spd(300, seed=1)[0],
                                                     device="cpu"),
                               np.ones((300, 2), np.float32), mesh=one_rank)
    # A multi-RHS solve whose columns are the same converges each as one.
    res = sharded_cg_solve_multi(A, B, mesh=one_rank)
    assert res.converged.all() and torch.equal(res.x[:, 0], res.x[:, 1])
    assert res.x.shape == (32, 2) and res.iterations.shape == (2,)
