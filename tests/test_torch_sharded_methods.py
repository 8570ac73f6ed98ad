"""tpucg_torch's sharded pipelined, CA and Chebyshev CG and block Jacobi
(ROADMAP M14 step 2) over torch.distributed (gloo on the CPU), against
tpucg's sharded solves at the same number of ranks; a world of one rank
against the port's serial solve; and block Jacobi's host set-up against
tpucg's arrays.

Worlds of 2 and 4 ranks are spawned once for the module
(``_torch_helpers.run_world``); every rank runs every case of
``METHOD_DENSE_CASES`` (those of ``METHOD_OVERLAP_CASES`` with both
strategies) and ``METHOD_OPERATOR_CASES``
and rank 0 returns the results. tpucg runs each case on ``make_mesh(P)`` of
the 8 CPU devices that ``tests/conftest.py`` forces. Both packages pad a
dense system alike (rows in multiples of 8 a rank, or of
lcm(8, pc_block_size) under block Jacobi), so the power method's seed,
which both take over each rank's own rows, is the same at the same P: CA's,
Chebyshev's and poly's intervals depend on P, and a case is held only
against tpucg at its own P.

Tolerances follow tpucg's own tests of these methods: laps within one (two
for a CA solve, whose tentative stops are confirmed by an exact residual
check per block of s laps, and a check of ``check_every`` laps for
Chebyshev, whose stops fall on check boundaries) and x within 1e-4 of max
|x| (1e-3 for Chebyshev, whose interval estimate sets its accuracy, and for
the badly scaled DIA system); each also converged where tpucg's converged.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.formats as jfmt
from _torch_helpers import (
    METHOD_DENSE_CASES,
    METHOD_OPERATOR_CASES,
    METHOD_OVERLAP_CASES,
    method_case_kwargs,
    run_world,
    scaled_err,
    sharded_methods_worker,
    sharded_system,
)
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg.solver.sharded import sharded_cg_solve as j_sharded_cg_solve
from tpucg.solver.sharded import sharded_operator_cg_solve as j_sharded_operator_cg_solve
from tpucg_torch.comm.mesh import Mesh, init_distributed, make_mesh
from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import (
    generate_spd_system,
    poisson3d_csr,
    poisson3d_dia,
    random_geometric_spd,
)
from tpucg_torch.solver.cg import cg_solve, spectral_interval
from tpucg_torch.solver.operators import (
    BsrOperator,
    DiaOperator,
    EllOperator,
    PoissonOperator,
    WellOperator,
)
from tpucg_torch.solver import sharded as port_sharded
from tpucg_torch.solver.sharded import (
    ROW_ALIGN,
    distribute_system,
    pc_align,
    sharded_cg_solve,
    sharded_operator_cg_solve,
)
from tpucg_torch.sparse.formats import csr_to_bsr

WORLDS = (2, 4)
DENSE_IDS = [(name, s) for name in METHOD_DENSE_CASES
             for s in ("allgather", "overlap")[:2 if name in METHOD_OVERLAP_CASES else 1]]
OPERATOR_IDS = [(name, None) for name in METHOD_OPERATOR_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({P: {(case, strategy): result}} from one spawned gloo world of each
    size, both worlds running at once; {(case, strategy, P): tpucg's
    solve}, solved here while the worlds run)."""
    tmp = tmp_path_factory.mktemp("rendezvous")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {P: pool.submit(run_world, P, sharded_methods_worker,
                                  rendezvous=str(tmp / f"world{P}")) for P in WORLDS}
        ref = {(name, strategy, P): _jax_case(name, strategy, P)
               for P in WORLDS for name, strategy in DENSE_IDS + OPERATOR_IDS}
        return {P: f.result() for P, f in futures.items()}, ref


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one_rank():
    """This process as a world of one rank (gloo, an in-process store)."""
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


def _jax_case(name, strategy, P):
    """tpucg's sharded solve of the case on make_mesh(P)."""
    dense = name in METHOD_DENSE_CASES
    s = sharded_system((METHOD_DENSE_CASES if dense else METHOD_OPERATOR_CASES)[name][0])
    kw = method_case_kwargs(name, s)
    mesh = tpucg.make_mesh(P)
    if dense:
        return j_sharded_cg_solve(s["A"], s["b"], s["x0"], mesh=mesh, strategy=strategy, **kw)
    op = s["op"]
    kind = type(op).__name__
    if isinstance(op, tuple):
        op = JPoissonOperator(m=op[1])
    elif kind == "DIAMatrix":
        op = jfmt.DIAMatrix(offsets=op.offsets, data=op.data, shape=op.shape)
    else:  # a CSR: tpucg's sharded WELL
        op = jfmt.CSRMatrix(indptr=op.indptr, indices=op.indices, data=op.data, shape=op.shape)
    return j_sharded_operator_cg_solve(op, s["b"], s["x0"], mesh=mesh, **kw)


def _laps_within(name):
    kw = {**METHOD_DENSE_CASES, **METHOD_OPERATOR_CASES}[name][1]
    return {"ca": 2, "chebyshev": kw.get("check_every", 8)}.get(kw.get("method"), 1)


def _held(name, got, want):
    k, jk = got["iterations"], int(want.iterations)
    assert got["converged"] and bool(want.converged), (got["converged"], bool(want.converged))
    assert abs(k - jk) <= _laps_within(name), (k, jk)
    kw = {**METHOD_DENSE_CASES, **METHOD_OPERATOR_CASES}[name][1]
    bound = 1e-3 if kw.get("method") == "chebyshev" or name.startswith("dia_scaled") else 1e-4
    jx = np.asarray(want.x)
    assert got["x"].shape == jx.shape
    assert scaled_err(got["x"], jx) <= bound, scaled_err(got["x"], jx)
    return k, jk


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name,strategy", DENSE_IDS)
def test_dense_method_matches_tpucg(runs, name, strategy, P):
    _held(name, runs[0][P][(name, strategy)], runs[1][(name, strategy, P)])


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(METHOD_OPERATOR_CASES))
def test_operator_method_matches_tpucg(runs, name, P):
    got = runs[0][P][(name, None)]
    _held(name, got, runs[1][(name, None, P)])
    s = sharded_system(METHOD_OPERATOR_CASES[name][0])
    if "x_true" in s:
        assert scaled_err(got["x"], s["x_true"]) <= 2e-3


@pytest.mark.parametrize("P", WORLDS)
def test_block_jacobi_beats_jacobi_on_the_scaled_band(worlds, P):
    # tpucg's test_sharded_sparse.py:532: block Jacobi absorbs the coupling
    # inside its blocks that point Jacobi cannot.
    w = worlds[P]
    assert w[("dia_scaled_block_jacobi", None)]["iterations"] < w["dia_scaled_jacobi_laps"]


def test_worlds_rank_sum_vectors_in_rank_order(worlds):
    # Every rank holds the same sums of the partials (1 + r) / 3 (1, 2, ...),
    # added left to right in rank order in float32.
    for P in WORLDS:
        for shape, got in zip(((5,), (3, 4)), worlds[P]["rank_sum"]):
            base = np.arange(1, int(np.prod(shape)) + 1, dtype=np.float32).reshape(shape)
            want = np.zeros(shape, np.float32)
            for r in range(P):
                want = want + np.float32(np.float32(1 + r) / np.float32(3)) * base
            assert got.shape == (P,) + shape
            for r in range(P):
                np.testing.assert_array_equal(got[r], want)


def test_pipelined_lap_is_one_rank_sum(worlds):
    # The mesh's counter over 8 more laps: a pipelined lap makes one gather
    # of its direction (the allgather matvec) and ONE rank_sum of its stacked
    # dots; a classic lap the gather and two (p.Ap, then r.r).
    for P in WORLDS:
        calls = worlds[P]["calls"]
        assert calls[("pipelined", 16)] - calls[("pipelined", 8)] == 8 * 2
        assert calls[("cg", 16)] - calls[("cg", 8)] == 8 * 3


# ---- one rank against the serial solve ---------------------------------------


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
@pytest.mark.parametrize("kw", [
    {"method": "pipelined", "tol": 1e-4},
    {"method": "pipelined", "precondition": "jacobi", "tol": 1e-4},
    {"method": "ca", "s_step": 3},
    {"method": "chebyshev"},
    {"method": "chebyshev", "precondition": "poly"},
    {"precondition": "block_jacobi", "pc_block_size": 32},
], ids=["pipelined", "pipelined_jacobi", "ca", "chebyshev", "chebyshev_poly", "block_jacobi"])
def test_one_rank_equals_serial_dense(one_rank, strategy, kw):
    # npad 256 on both paths: the same operator, seeds and sums bit for bit.
    A, b, x0 = generate_spd_system(256, seed=3)
    got = sharded_cg_solve(A, b, x0, mesh=one_rank, strategy=strategy, **kw)
    want = cg_solve(A, b, x0, device="cpu", **kw)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual_norm, want.residual_norm)


@pytest.mark.parametrize("kw", [
    {"method": "pipelined"}, {"method": "ca", "s_step": 4}, {"method": "chebyshev"},
    {"precondition": "block_jacobi", "pc_block_size": 64},
    {"method": "pipelined", "precondition": "block_jacobi", "pc_block_size": 64},
], ids=["pipelined", "ca", "chebyshev", "block_jacobi", "pipelined_block_jacobi"])
@pytest.mark.parametrize("kind", ["poisson", "dia"])
def test_one_rank_equals_serial_operator(one_rank, kind, kw):
    m = 8
    op = (PoissonOperator(m, device="cpu") if kind == "poisson"
          else DiaOperator.from_dia(poisson3d_dia(m), device="cpu"))
    b = np.random.default_rng(4).standard_normal(m ** 3).astype(np.float32)
    kw = dict(kw, tol=1e-5 * float(np.linalg.norm(b)), maxiter=8 * m ** 3)
    got = sharded_operator_cg_solve(op, b, mesh=one_rank, **kw)
    want = cg_solve(op, b, fused="never", **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)


def test_one_rank_well_block_jacobi_equals_serial(one_rank):
    # One rank's WELL pack and blocks are the serial promotion's.
    A, b, _ = random_geometric_spd(1500, seed=3, avg_degree=8.0, shuffle=True)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4 * A.shape[0],
              precondition="block_jacobi", pc_block_size=32)
    for method in ("cg", "pipelined"):
        got = sharded_operator_cg_solve(A, b, mesh=one_rank, method=method, **kw)
        want = cg_solve(WellOperator.from_csr(A, device="cpu", pc_block_size=32), b,
                        method=method, **kw)
        assert bool(got.converged) and int(got.iterations) == int(want.iterations)
        assert torch.equal(got.x, want.x)


def test_one_rank_interval_equals_serial(one_rank):
    A, b, x0 = generate_spd_system(256, seed=5)
    iv = spectral_interval(A, device="cpu")[:2]
    for method in ("ca", "chebyshev"):
        got = sharded_cg_solve(A, b, x0, mesh=one_rank, method=method, interval=iv)
        want = cg_solve(A, b, x0, device="cpu", method=method, interval=iv)
        assert bool(got.converged) and int(got.iterations) == int(want.iterations)
        assert torch.equal(got.x, want.x)


# ---- block Jacobi's host set-up against tpucg's arrays ------------------------


def test_pc_align_is_tpucgs():
    from tpucg.solver.sharded import pc_align as j_pc_align

    for pc, bs in (("none", 64), ("jacobi", 24), ("block_jacobi", 64), ("block_jacobi", 24),
                   ("block_jacobi", 7), ("block_jacobi", 256)):
        cfg = CGConfig(precondition=pc, pc_block_size=bs)
        jcfg = tpucg.CGConfig(precondition=pc, pc_block_size=bs)
        assert pc_align(ROW_ALIGN, cfg) == j_pc_align(ROW_ALIGN, jcfg)


@pytest.mark.parametrize("m,num", [(6, 1), (6, 8), (8, 2), (9, 3), (5, 4)])
def test_poisson_dia_rows_are_tpucgs(m, num):
    from tpucg.solver.sharded import _poisson_dia_rows as j_rows

    npad = -(-m // num) * num * m * m
    offs, rows = port_sharded._poisson_dia_rows(m, npad)
    joffs, jrows = j_rows(m, npad)
    assert offs == joffs and rows.dtype == jrows.dtype == np.float32
    np.testing.assert_array_equal(rows, jrows)


@pytest.mark.parametrize("num,bs", [(1, 16), (2, 16), (4, 24), (8, 64), (3, 7)])
def test_diag_blocks_sharded_are_tpucgs(num, bs):
    from tpucg.solver.sharded import _diag_blocks_sharded as j_blocks

    # A random band with offsets inside and beyond a block, rows of 128 a
    # shard (so bs = 24, 7 leave a grid tail whose band entries are cut).
    rng = np.random.default_rng(num * 100 + bs)
    offsets = (-70, -9, -1, 0, 1, 9, 70)
    data = rng.standard_normal((len(offsets), 128 * num)).astype(np.float32)
    got = port_sharded._diag_blocks_sharded(offsets, data, num, bs)
    want = j_blocks(offsets, data, num, bs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # Each rank's share from its own rows alone is its slice of the whole.
    nbl = got.shape[0] // num
    for r in range(num):
        mesh = Mesh(group=None, rank=r, size=num, device=torch.device("cpu"), backend="gloo")
        np.testing.assert_array_equal(port_sharded._rank_blocks(offsets, data, mesh, bs),
                                      want[r * nbl:(r + 1) * nbl])


def _fake_mesh(rank, size):
    return Mesh(group=None, rank=rank, size=size, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("P", [1, 2, 4])
def test_operator_blocks_are_tpucgs(P):
    # The blocks each rank of P takes (Poisson m = 6 plane-padded, DIA m = 6
    # row-padded, the WELL CSR) are its slice of tpucg's minv_host, the
    # blocks its sharded solve inverts.
    from tpucg.solver.sharded import _prepare_sharded_operator as j_prepare

    jcfg = tpucg.CGConfig(precondition="block_jacobi", pc_block_size=24)
    cfg = CGConfig(precondition="block_jacobi", pc_block_size=24)
    A_geo = random_geometric_spd(1000, seed=2, avg_degree=8.0, shuffle=True)[0]
    dia = poisson3d_dia(6)
    cases = ((PoissonOperator(6, device="cpu"), JPoissonOperator(m=6)),
             (dia, jfmt.DIAMatrix(offsets=dia.offsets, data=dia.data, shape=dia.shape)),
             (A_geo, jfmt.CSRMatrix(indptr=A_geo.indptr, indices=A_geo.indices,
                                    data=A_geo.data, shape=A_geo.shape)))
    for op, jop in cases:
        want = np.asarray(j_prepare(jop, tpucg.make_mesh(P), jcfg)[4])
        nbl = want.shape[0] // P
        for r in range(P):
            sop = port_sharded._prepare_sharded_operator(op, _fake_mesh(r, P), cfg)
            np.testing.assert_array_equal(sop.blocks.numpy(), want[r * nbl:(r + 1) * nbl],
                                          err_msg=type(op).__name__)


def test_dense_local_blocks_are_the_own_squares(one_rank):
    # Both layouts: the rank's diagonal blocks of bs, cut from its own square.
    A, b, _ = generate_spd_system(100, seed=1)
    cfg = CGConfig(precondition="block_jacobi", pc_block_size=24)
    for strategy in ("allgather", "overlap"):
        system = distribute_system(A, b, mesh=one_rank, strategy=strategy, config=cfg)
        assert system.part.n_padded == 120 and system.part.block_rows % 24 == 0
        blocks = port_sharded._local_diag_blocks(system, 24).numpy()
        Ap = np.eye(120, dtype=np.float32)
        Ap[:100, :100] = A
        for i in range(5):
            np.testing.assert_array_equal(blocks[i], Ap[24 * i:24 * (i + 1), 24 * i:24 * (i + 1)])


# ---- tpucg's refusals and messages --------------------------------------------


def test_refusals_and_messages(one_rank):
    A, b, _ = generate_spd_system(64, seed=0)
    with pytest.raises(ValueError, match="interval"):
        sharded_cg_solve(A, b, mesh=one_rank, method="pipelined", interval=(1.0, 2.0))
    with pytest.raises(ValueError, match="interval"):
        sharded_operator_cg_solve(PoissonOperator(4, device="cpu"), np.ones(64, np.float32),
                                  mesh=one_rank, interval=(1.0, 2.0))
    with pytest.raises(ValueError, match="record_residuals requires method='cg'"):
        sharded_cg_solve(A, b, mesh=one_rank, method="ca", record_residuals=True)
    with pytest.raises(ValueError, match="record_residuals requires method='cg'"):
        sharded_operator_cg_solve(PoissonOperator(4, device="cpu"), np.ones(64, np.float32),
                                  mesh=one_rank, method="chebyshev", record_residuals=True)
    # A placed system whose rank blocks are not whole bs-blocks: tpucg's
    # ValueError, never a silent re-pad.
    system = distribute_system(A, b, mesh=one_rank)
    assert system.part.block_rows == 64
    with pytest.raises(ValueError, match="pc_block_size=24"):
        sharded_cg_solve(system, mesh=one_rank, precondition="block_jacobi", pc_block_size=24)
    # ELL and BSR: block Jacobi refused with tpucg's message
    # (test_sharded_sparse.py:617).
    from tpucg_torch.sparse.formats import COOMatrix

    n = 64
    ii = np.arange(n)
    csr = COOMatrix(row=ii, col=ii, data=np.full(n, 2.0, np.float32), shape=(n, n)).to_csr()
    for bad in (EllOperator.from_csr(csr, device="cpu"),
                BsrOperator.from_bsr(csr_to_bsr(csr, 8), device="cpu")):
        with pytest.raises(ValueError, match="block_jacobi"):
            sharded_operator_cg_solve(bad, np.ones(n, np.float32), mesh=one_rank,
                                      precondition="block_jacobi", pc_block_size=8)
    # The methods on ELL and BSR run (x gathered whole, plain products).
    csr = poisson3d_csr(4)
    b4 = np.ones(64, np.float32)
    for op in (EllOperator.from_csr(csr, device="cpu"),
               BsrOperator.from_bsr(csr_to_bsr(csr, 8), device="cpu")):
        for method in ("pipelined", "ca", "chebyshev"):
            res = sharded_operator_cg_solve(op, b4, mesh=one_rank, method=method, tol=8e-5,
                                            maxiter=512)
            assert bool(res.converged), (type(op).__name__, method)
            np.testing.assert_allclose(csr.matvec(res.x.numpy().astype(np.float64)), b4,
                                       atol=1e-3)
