"""tpucg_torch's M12 on the mesh (ROADMAP M14 step 5) against tpucg's:
two-level and multilevel PCG (classic and pipelined) on sharded WELL,
Poisson slabs and DIA band halos, ``sharded_cg_solve_deflated`` (dense and
operator arms), ``RecyclingCG(mesh=)``, ``sharded_minres_solve`` (dense with
none, Jacobi and block Jacobi, and operators) and ``sharded_cg_solve_ir``
(allgather, overlap, padding), with tpucg's systems and seeds
(``tests/test_twolevel.py``, ``test_deflation.py``, ``test_minres.py``,
``test_ir.py``; host-sharded WELL with two-level is in
``test_torch_host_sharded.py``).

Worlds of 2 and 4 gloo ranks are spawned once for the module
(``_torch_helpers.sharded_m12_worker`` over ``M12_CASES``); tpucg runs each
case on ``make_mesh(P)`` of the 8 CPU devices that ``tests/conftest.py``
forces while the worlds run. A world of one rank runs in this process.

Tolerances: laps equal tpucg's at the same P and x within 1e-5 of max |x|,
except where the sums' order moves the stop (x then within 1e-4): a
pipelined solve tests its stop every lap on a recurrence whose rounding
follows the order of its sums (within one lap); an IR solve's inner laps
stop at a relative 3e-2 of each round's residual in bf16-rate products
(within one lap a round); and deflating with the plain solve's x starts at
the solution, so the stop lands on the f32 noise of the first residual
(tpucg's own bound, at most 2 laps).
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.formats as jfmt
from _torch_helpers import (
    M12_CASES,
    m12_kwargs,
    m12_npad,
    m12_system,
    run_world,
    scaled_err,
    sharded_m12_worker,
)
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.comm.mesh import init_distributed, make_mesh
from tpucg_torch.io.generator import generate_spd_system, poisson3d_csr, random_geometric_spd
from tpucg_torch.solver.cg import TRUE_CHECK_EVERY, cg_solve
from tpucg_torch.solver.deflation import RecyclingCG, sharded_cg_solve_deflated
from tpucg_torch.solver.ir import cg_solve_ir, sharded_cg_solve_ir
from tpucg_torch.solver.minres import minres_solve, sharded_minres_solve
from tpucg_torch.solver.operators import PoissonOperator, WellOperator
from tpucg_torch.solver.sharded import sharded_cg_solve, sharded_operator_cg_solve
from tpucg_torch.solver.twolevel import build_two_level

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({P: {case: result}} from one spawned gloo world of each size, both
    at once; {(case, P): tpucg's solve}, solved here meanwhile)."""
    tmp = tmp_path_factory.mktemp("rendezvous")
    systems = {name: m12_system(M12_CASES[name][1]) for name in M12_CASES}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {P: pool.submit(run_world, P, sharded_m12_worker, args=(systems,),
                                  rendezvous=str(tmp / f"world{P}")) for P in WORLDS}
        ref = {(name, P): _jax_case(name, P, systems[name]) for P in WORLDS
               for name in M12_CASES}
        return {P: f.result() for P, f in futures.items()}, ref


@pytest.fixture(scope="module")
def one_rank():
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


def _jax_op(op):
    if isinstance(op, tuple):
        return JPoissonOperator(m=op[1])
    if type(op).__name__ == "DIAMatrix":
        return jfmt.DIAMatrix(offsets=op.offsets, data=op.data, shape=op.shape)
    return _jax_csr(op)


def _jax_csr(csr):
    return jfmt.CSRMatrix(indptr=csr.indptr, indices=csr.indices, data=csr.data,
                          shape=csr.shape)


def _jax_case(name, P, s):
    """tpucg's solve of the case, system ``s``, on make_mesh(P)."""
    solver, spec, raw = M12_CASES[name]
    kw = m12_kwargs(name, s)
    mesh = tpucg.make_mesh(P)
    A = s["A"] if "A" in s else _jax_op(s["op"])
    b = s["b"]
    if solver == "two_level":
        t = raw["tl"]
        tl = tpucg.build_two_level(_jax_csr(s["csr"]), agg_size=t["agg"], npad=m12_npad(s, P),
                                   smooth_degree=t.get("smooth_degree", 1),
                                   coarse_max=t.get("coarse_max"))
        return tpucg.sharded_operator_cg_solve(A, b, mesh=mesh, two_level=tl, **kw)
    if solver == "deflated":
        V = raw["V"]
        if V == "low":
            V = s["low"]
        elif V == "plain":
            V = np.asarray(tpucg.sharded_operator_cg_solve(A, b, mesh=mesh, **kw).x)
        else:
            V = np.random.default_rng(V[0]).standard_normal((b.shape[0], V[1]))
        return tpucg.sharded_cg_solve_deflated(A, b, V.astype(np.float32), mesh=mesh, **kw)
    if solver == "minres":
        return tpucg.sharded_minres_solve(A, b, mesh=mesh, **kw)
    if solver == "ir":
        return tpucg.sharded_cg_solve_ir(A, b, mesh=mesh, **kw)
    drift = np.random.default_rng(spec[2] + 100).standard_normal(b.shape[0])
    rec = tpucg.RecyclingCG(A, max_vectors=4, mesh=mesh, **kw)
    return [rec.solve((b + 0.05 * t * drift).astype(np.float32)) for t in range(raw["steps"])]


def _laps_slack(name):
    solver, _, raw = M12_CASES[name]
    if raw.get("V") == "plain":
        return 2  # tpucg's own bound (test_deflation.py:301): the stop is at the f32 noise
    return 1 if raw.get("method") == "pipelined" or solver == "ir" else 0


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", [n for n in M12_CASES if M12_CASES[n][0] != "recycling"])
def test_m12_on_the_mesh_matches_tpucg(runs, name, P):
    got, want = runs[0][P][name], runs[1][(name, P)]
    assert got["converged"] and bool(want.converged)
    k, jk = got["iterations"], int(want.iterations)
    slack = _laps_slack(name)
    if slack == 2:
        assert k <= 2 and jk <= 2, (k, jk)
    else:
        assert abs(k - jk) <= slack, (k, jk)
    jx = np.asarray(want.x)
    assert got["x"].shape == jx.shape
    assert scaled_err(got["x"], jx) <= (1e-4 if slack else 1e-5), scaled_err(got["x"], jx)
    solver, spec, raw = M12_CASES[name]
    if solver == "two_level" and raw.get("method") != "pipelined":
        assert k % TRUE_CHECK_EVERY == 0  # classic PCG stops on a true-residual check
    if raw.get("V") in ("low", "plain"):  # a slow or exact subspace deflated: a few laps
        assert k <= (2 if raw["V"] == "plain" else 12), k


@pytest.mark.parametrize("P", WORLDS)
def test_recycling_on_the_mesh_matches_tpucg(runs, P):
    got, want = runs[0][P]["recycling_poisson_m8"], runs[1][("recycling_poisson_m8", P)]
    assert got["converged"] and all(bool(w.converged) for w in want)
    assert got["iterations"] == [int(w.iterations) for w in want]
    for x, w in zip(got["x"], want):
        assert scaled_err(x, np.asarray(w.x)) <= 1e-5
    assert got["iterations"][-1] * 2 < got["iterations"][0]  # the recycling payoff


@pytest.mark.parametrize("P", WORLDS)
def test_two_level_cuts_the_laps(runs, P):
    # tpucg's test_two_level_sharded_dia: the cycle beats the plain solve.
    w = runs[0][P]
    assert w["tl_dia_m16"]["iterations"] < 60 and w["tl_poisson_m12"]["iterations"] < 60


# ---- one rank against the serial solves ---------------------------------------


@pytest.mark.parametrize("method", ["cg", "pipelined"])
@pytest.mark.parametrize("coarse_max", [None, 64])
def test_one_rank_two_level_equals_serial(one_rank, method, coarse_max):
    # One rank's WELL pack is the serial one, its aggregates the serial
    # cycle's, its gathered coarse residual the serial restriction.
    A, b, _ = random_geometric_spd(5000, seed=2, avg_degree=12.0, shift=0.05)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4 * A.shape[0], method=method)
    op = WellOperator.from_csr(A, device="cpu")
    tl = build_two_level(A, agg_size=16, npad=op.padded_n, coarse_max=coarse_max, device="cpu")
    got = sharded_operator_cg_solve(A, b, mesh=one_rank, two_level=tl, **kw)
    want = cg_solve(op, b, two_level=tl, **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)


def test_one_rank_poisson_two_level_equals_serial(one_rank):
    m = 12
    b = np.random.default_rng(5).standard_normal(m ** 3).astype(np.float32)
    op = PoissonOperator(m, device="cpu")
    tl = build_two_level(poisson3d_csr(m), agg_size=16, npad=m ** 3, device="cpu")
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4 * m ** 3, two_level=tl)
    got = sharded_operator_cg_solve(op, b, mesh=one_rank, **kw)
    want = cg_solve(op, b, fused="never", **kw)
    assert int(got.iterations) == int(want.iterations) and torch.equal(got.x, want.x)


@pytest.mark.parametrize("pc", ["none", "jacobi", "block_jacobi"])
def test_one_rank_minres_equals_serial(one_rank, pc):
    # n = 256: both paths pad alike (none), so the same sums bit for bit.
    from _torch_helpers import sym_indefinite

    A = sym_indefinite(256, seed=3)
    b = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=1024, precondition=pc,
              pc_block_size=32)
    got = sharded_minres_solve(A, b, mesh=one_rank, **kw)
    want = minres_solve(A, b, device="cpu", **kw)
    assert int(got.iterations) == int(want.iterations) and bool(got.converged)
    assert torch.equal(got.x, want.x) and torch.equal(got.residual_norm, want.residual_norm)


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_one_rank_ir_equals_serial(one_rank, strategy):
    A, b, _ = generate_spd_system(256, seed=4)
    A = (A - (256 - 256 / 32.0) * np.eye(256)).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)))
    got = sharded_cg_solve_ir(A, b, mesh=one_rank, strategy=strategy, **kw)
    want = cg_solve_ir(A, b, device="cpu", **kw)
    assert int(got.iterations) == int(want.iterations) and bool(got.converged)
    assert torch.equal(got.x, want.x)


def test_one_rank_deflated_and_recycling(one_rank):
    # The sharded deflation keeps tpucg's explicit (W^T A W)^-1 with an
    # orthonormal W, the serial one folds it into an A-orthonormal W, so
    # the two differ in rounding only: laps equal, x within 1e-5.
    from tpucg_torch.solver.deflation import cg_solve_deflated
    from _torch_helpers import _clustered_spd

    A, V = _clustered_spd(n=256, seed=30)
    b = np.random.default_rng(31).standard_normal(256).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=1024)
    got = sharded_cg_solve_deflated(A, b, V, mesh=one_rank, **kw)
    want = cg_solve_deflated(A, b, V, device="cpu", **kw)
    assert int(got.iterations) == int(want.iterations)
    assert scaled_err(got.x.numpy(), want.x.numpy()) <= 1e-5
    rec = RecyclingCG(A, mesh=one_rank, **kw)
    first = rec.solve(b)
    assert int(first.iterations) == int(sharded_cg_solve(A, b, mesh=one_rank, **kw).iterations)
    second = rec.solve(b)
    assert bool(second.converged) and int(second.iterations) <= 1


# ---- the refusals -------------------------------------------------------------


def test_refusals_and_messages(one_rank, tmp_path):
    A, b, _ = random_geometric_spd(3000, seed=3, avg_degree=10.0)
    tl = build_two_level(A, agg_size=64, device="cpu", npad=3072)
    with pytest.raises(ValueError, match="method='cg' or 'pipelined'"):
        sharded_operator_cg_solve(A, b, mesh=one_rank, two_level=tl, method="ca")
    with pytest.raises(ValueError, match="method='cg' or 'pipelined'"):
        sharded_operator_cg_solve(A, b, mesh=one_rank, two_level=tl, precondition="jacobi")
    bad = build_two_level(A, agg_size=64, device="cpu", npad=3200)
    with pytest.raises(ValueError, match="sharded decomposition pads to 3072"):
        sharded_operator_cg_solve(A, b, mesh=one_rank, two_level=bad)
    badagg = build_two_level(A, agg_size=5 * 128, device="cpu", npad=3072)
    with pytest.raises(ValueError, match="rows-per-shard"):
        sharded_operator_cg_solve(A, b, mesh=one_rank, two_level=badagg)
    A64, b64, _ = generate_spd_system(64, seed=37)
    with pytest.raises(ValueError, match="method"):
        sharded_cg_solve_deflated(A64, b64, np.ones((64, 1), np.float32), mesh=one_rank,
                                  method="pipelined")
    with pytest.raises(ValueError, match="block Jacobi"):
        sharded_cg_solve_deflated(PoissonOperator(4, device="cpu"), np.ones(64, np.float32),
                                  np.ones((64, 1), np.float32), mesh=one_rank,
                                  precondition="block_jacobi")
    with pytest.raises(ValueError, match="V must have 64 rows"):
        sharded_cg_solve_deflated(A64, b64, np.ones((63, 1), np.float32), mesh=one_rank)
    with pytest.raises(ValueError, match="no usable directions"):
        sharded_cg_solve_deflated(A64, b64, np.zeros((64, 1), np.float32), mesh=one_rank)
    with pytest.raises(ValueError, match="no method variants"):
        sharded_minres_solve(A64, b64, mesh=one_rank, method="pipelined")
    with pytest.raises(ValueError, match="M must be SPD"):
        sharded_minres_solve(A64, b64, mesh=one_rank, precondition="poly")
    with pytest.raises(ValueError, match="'none' or 'jacobi'"):
        sharded_minres_solve(PoissonOperator(4, device="cpu"), np.ones(64, np.float32),
                             mesh=one_rank, precondition="block_jacobi")
    with pytest.raises(ValueError, match="pc_block_size=48 must divide"):
        sharded_minres_solve(A64, b64, mesh=one_rank, precondition="block_jacobi",
                             pc_block_size=48)
    for kw in ({"method": "pipelined"}, {"precondition": "jacobi"}):
        with pytest.raises(ValueError, match="sharded_cg_solve_ir supports"):
            sharded_cg_solve_ir(A64, b64, mesh=one_rank, **kw)
    with pytest.raises(ValueError, match="float32"):
        sharded_cg_solve_ir(A64, b64, mesh=one_rank, dtype=torch.float64)
    # RecyclingCG on a mesh: tpucg's ValueError with two_level, and for a
    # checkpointed solve (tpucg's "serial-only").
    with pytest.raises(ValueError, match="serial-only"):
        RecyclingCG(A, mesh=one_rank, two_level=tl)
    rec = RecyclingCG(A64, mesh=one_rank)
    with pytest.raises(ValueError, match="RecyclingCG checkpoint_path is serial-only"):
        rec.solve(b64, checkpoint_path=str(tmp_path / "ck.npz"))
    # The port's 2-D mesh (make_mesh2d, M14 step 7): IR and the operator
    # solves refuse it in tpucg's words; the dense deflated, MINRES and
    # recycling solves run their SUMMA arms (held to tpucg's in
    # test_torch_sharded2d.py). tpucg's own mesh is not this package's.
    from tpucg_torch.comm.mesh import make_mesh2d

    mesh2d = make_mesh2d(1, 1, device="cpu")
    with pytest.raises(ValueError, match="sharded_cg_solve_ir runs on 1-D meshes"):
        sharded_cg_solve_ir(A64, b64, mesh=mesh2d)
    with pytest.raises(ValueError, match="the 2-D SUMMA arm is dense"):
        sharded_operator_cg_solve(A, b, mesh=mesh2d)
    tol = 1e-5 * float(np.linalg.norm(b64))
    for call in (lambda: sharded_cg_solve_deflated(A64, b64, np.ones((64, 1)), mesh=mesh2d,
                                                   tol=tol),
                 lambda: sharded_minres_solve(A64, b64, mesh=mesh2d, tol=tol),
                 lambda: RecyclingCG(A64, mesh=mesh2d, tol=tol).solve(b64)):
        assert bool(call().converged)
    jmesh = tpucg.make_mesh2d(2, 2)
    for call in (lambda: sharded_cg_solve_deflated(A64, b64, np.ones((64, 1)), mesh=jmesh),
                 lambda: sharded_minres_solve(A64, b64, mesh=jmesh),
                 lambda: sharded_cg_solve_ir(A64, b64, mesh=jmesh),
                 lambda: sharded_operator_cg_solve(A, b, mesh=jmesh),
                 lambda: RecyclingCG(A64, mesh=jmesh)):
        with pytest.raises(TypeError, match="Mesh2D"):
            call()
