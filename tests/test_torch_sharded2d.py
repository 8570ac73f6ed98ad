"""tpucg_torch's 2-D SUMMA decomposition (ROADMAP M14 step 7) against tpucg's:
``make_mesh2d``, ``_colperm_2d``, ``distribute_system_2d`` and the 2-D arms
of ``sharded_cg_solve`` (cg, pipelined, CA, Chebyshev; none, Jacobi, poly;
``record_residuals``; bf16 storage), ``sharded_minres_solve``,
``sharded_cg_solve_deflated``, ``sharded_cg_solve_multi`` and
``sharded_cg_solve_block`` with tpucg's systems and seeds
(``tests/test_sharded2d.py`` and the 2-D cases of ``test_ca.py``,
``test_chebyshev.py``, ``test_poly_precond.py`` and ``test_interval.py``).

One world of 4 gloo ranks is spawned for the module and runs every case on
the 2 x 2, 1 x 4 and 4 x 1 meshes (``_torch_helpers.sharded2d_worker`` over
``SUMMA_CASES``); tpucg runs each on ``make_mesh2d`` of the same shape over
the 8 CPU devices that ``tests/conftest.py`` forces, while the world runs.
A 1 x 1 mesh runs in this process, against the port's 1-D one-rank solve.

Tolerances: x within 1e-5 of max |x| of tpucg's (``X_TOL`` names the one
case where tpucg's own meshes disagree by more); laps equal where the
spectrum sets them, else within one (the f32 sums' order moves the stop:
pipelined, CA's verified block ends, Chebyshev's checks, bf16 products,
MINRES's Lanczos laps, and where the port pads otherwise than tpucg, whose
power method then starts from another seed vector; deflating with the
plain solve's x stops on the f32 noise of the first residual, tpucg's own
bound of 2 laps).
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import (
    SUMMA_CASES,
    SUMMA_SHAPES,
    run_world,
    scaled_err,
    sharded2d_worker,
    summa_kwargs,
    summa_rhs,
    summa_system,
)
from tpucg.solver.sharded import _colperm_2d as jax_colperm_2d
from tpucg_torch.comm.mesh import Mesh2D, init_distributed, make_mesh, make_mesh2d
from tpucg_torch.io.generator import generate_spd_system, poisson3d_dia
from tpucg_torch.solver.deflation import sharded_cg_solve_deflated
from tpucg_torch.solver.ir import sharded_cg_solve_ir
from tpucg_torch.solver.minres import sharded_minres_solve
from tpucg_torch.solver.operators import PoissonOperator
from tpucg_torch.solver.sharded import (
    _colperm_2d,
    distribute_system,
    distribute_system_2d,
    sharded_cg_solve,
    sharded_cg_solve_block,
    sharded_cg_solve_multi,
    sharded_operator_cg_solve,
    summa_pad,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({(case, shape): result} from one spawned gloo world of 4 ranks;
    {(case, shape): tpucg's solve}, solved here meanwhile)."""
    tmp = tmp_path_factory.mktemp("rendezvous")
    systems = {name: summa_system(SUMMA_CASES[name][1]) for name in SUMMA_CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_world, 4, sharded2d_worker, args=(systems, SUMMA_SHAPES),
                          rendezvous=str(tmp / "world4"))
        ref = {(name, shape): _jax_case(name, shape, systems[name]) for shape in SUMMA_SHAPES
               for name in SUMMA_CASES}
        return fut.result(), ref


@pytest.fixture(scope="module")
def one_rank():
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu"), make_mesh2d(1, 1, device="cpu")
    torch.distributed.destroy_process_group()


def _jax_case(name, shape, s):
    """tpucg's solve of the case on make_mesh2d(*shape)."""
    solver, _, raw = SUMMA_CASES[name]
    mesh = tpucg.make_mesh2d(*shape)
    kw = summa_kwargs(name, s, torch_dtypes=False)
    A, b, x0 = s["A"], s["b"], s["x0"]
    if solver == "cg":
        return tpucg.sharded_cg_solve(A, b, x0, mesh=mesh, **kw)
    if solver == "minres":
        return tpucg.sharded_minres_solve(A, b, mesh=mesh, **kw)
    if solver == "deflated":
        V = raw["V"]
        if V == "plain":
            V = np.asarray(tpucg.sharded_cg_solve(A, b, mesh=mesh, **kw).x)
        else:
            V = np.random.default_rng(V[0]).standard_normal((b.shape[0], V[1]))
        return tpucg.sharded_cg_solve_deflated(A, b, V.astype(np.float32), mesh=mesh, **kw)
    fn = tpucg.sharded_cg_solve_multi if solver == "multi" else tpucg.sharded_cg_solve_block
    return fn(A, summa_rhs(name, s), mesh=mesh, **kw)


# tpucg's badly diagonal-scaled Jacobi system (d = 10^U(-2, 2)) stops after
# 4 laps at 1e-5 ||b||, where x still moves with the sums' order: tpucg's
# own 1-D solves on 1 and 4 devices differ by 2.3e-5 of max |x| and its 1-D
# and 2 x 2 solves by 3.9e-5.
X_TOL = {"jacobi_scaled_n96": 1e-4}


def _laps_slack(name, shape):
    solver, spec, raw = SUMMA_CASES[name]
    if raw.get("V") == "plain":
        return 2
    n = 4 if spec[0] == "golden" else spec[1]
    padded_otherwise = summa_pad(n, *shape) != -(-n // (shape[0] * shape[1])) * shape[0] * shape[1]
    rounding = (raw.get("method") in ("pipelined", "ca", "chebyshev") or solver == "minres"
                or "storage_dtype" in raw)
    return 1 if rounding or (padded_otherwise and raw.get("precondition") == "poly") else 0


@pytest.mark.parametrize("shape", SUMMA_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(SUMMA_CASES))
def test_2d_matches_tpucg(runs, name, shape):
    got, want = runs[0][(name, shape)], runs[1][(name, shape)]
    solver = SUMMA_CASES[name][0]
    assert np.all(got["converged"]) and np.asarray(want.converged).all()
    k, jk = np.asarray(got["iterations"]), np.asarray(want.iterations)
    slack = _laps_slack(name, shape)
    if slack == 2:
        assert k <= 2 and jk <= 2, (k, jk)
    else:
        assert np.abs(k - jk).max() <= slack, (k, jk)
    jx = np.asarray(want.x)
    assert got["x"].shape == jx.shape
    err = scaled_err(got["x"].T if solver in ("multi", "block") else got["x"],
                     jx.T if solver in ("multi", "block") else jx)
    assert err <= X_TOL.get(name, 1e-5), err
    if name == "record_n96":
        h, jh = got["hist"], np.asarray(want.residual_history)
        kk = int(k)
        assert h.shape == jh.shape and np.all(np.isfinite(h[:kk + 1]))
        assert h[kk] < 1e-6 and np.all(np.isnan(h[kk + 1:]))
        assert abs(h[0] - jh[0]) <= 1e-6 * jh[0]  # ||r0||; later entries follow the sums' order
    if name == "golden_4x4":
        from tpucg_torch.io.golden import GOLDEN_4X4

        assert int(k) == int(GOLDEN_4X4["iters"])
        np.testing.assert_allclose(got["x"], GOLDEN_4X4["x_star"], atol=2e-3)


@pytest.mark.parametrize("shape", SUMMA_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_2d_transport_is_counted(runs, shape):
    # Every case's gathers and sums counted into the world's stats.
    st = runs[0][("stats", shape)]
    assert st["calls"] > 0 and st["seconds"] > 0


def test_make_mesh2d_spans_the_world(runs):
    # tpucg's make_mesh2d takes the first rows x cols devices; the port's
    # mesh is the whole world, and a smaller one is refused on every rank.
    assert "the port's 2-D mesh is the whole world" in runs[0]["smaller_mesh"]


def test_colperm_is_tpucgs_permutation():
    for npad, R, C in ((48, 2, 4), (96, 2, 2), (128, 1, 4), (64, 4, 1), (16, 1, 1)):
        perm = _colperm_2d(npad, R, C)
        assert sorted(perm.tolist()) == list(range(npad))
        np.testing.assert_array_equal(perm, jax_colperm_2d(npad, R, C))
    # device (i, j) gathers chunks (0..R-1, j): block j of the permuted order.
    cs = 48 // 8
    np.testing.assert_array_equal(_colperm_2d(48, 2, 4)[:2 * cs],
                                  np.concatenate([np.arange(0, cs), np.arange(4 * cs, 5 * cs)]))


def test_summa_pad_aligns_the_block_columns():
    # npad / C a multiple of K1's 8 on every backend, npad a multiple of R C;
    # a 1 x 1 mesh pads as the 1-D solve's rows of 8.
    for n in (1, 4, 67, 96, 200, 8192):
        for R, C in ((1, 1), (2, 2), (1, 4), (4, 1), (2, 4), (3, 2)):
            npad = summa_pad(n, R, C)
            assert npad >= n and npad % (R * C) == 0 and (npad // C) % 8 == 0
            assert npad - n < np.lcm(R * C, 8 * C)
    assert summa_pad(67, 1, 1) == 72


@pytest.mark.parametrize("kw", [
    {}, {"precondition": "jacobi"}, {"method": "pipelined"}, {"method": "ca"},
    {"method": "chebyshev"}, {"precondition": "poly"}, {"storage_dtype": torch.bfloat16},
    {"record_residuals": True},
], ids=["cg", "jacobi", "pipelined", "ca", "chebyshev", "poly", "bf16", "record"])
def test_1x1_is_the_1d_one_rank_solve_bit_for_bit(one_rank, kw):
    mesh1, mesh2 = one_rank
    A, b, x0 = generate_spd_system(100, seed=5)
    A = (A - 88.0 * np.eye(100)).astype(np.float32)
    kw = dict(kw, tol=1e-5 * float(np.linalg.norm(b)), maxiter=800)
    r1 = sharded_cg_solve(A, b, x0, mesh=mesh1, **kw)
    r2 = sharded_cg_solve(A, b, x0, mesh=mesh2, **kw)
    assert int(r1.iterations) == int(r2.iterations) and bool(r2.converged)
    assert torch.equal(r1.x, r2.x)
    if kw.get("record_residuals"):
        assert torch.equal(r1.residual_history.isnan(), r2.residual_history.isnan())
        assert torch.equal(r1.residual_history.nan_to_num(), r2.residual_history.nan_to_num())


def test_1x1_placement_and_the_other_solves(one_rank):
    mesh1, mesh2 = one_rank
    A, b, x0 = generate_spd_system(100, seed=5)
    s2 = distribute_system_2d(A, b, x0, mesh2)
    s1 = distribute_system(A, b, x0, mesh1)
    assert s2.npad == 104 and torch.equal(s2.A, s1.A) and torch.equal(s2.b, s1.b)
    npad, A2, b2, x02 = s2.npad, *s2[:3]
    assert (A2.shape, b2.shape, x02.shape) == ((npad, npad), (npad,), (npad,))
    s16 = distribute_system_2d(A, b, None, mesh2, storage_dtype=torch.bfloat16)
    assert s16.A.dtype == torch.bfloat16 and not s16.x0.any()
    B = np.random.default_rng(1).standard_normal((100, 8)).astype(np.float32)
    for fn, kw in ((sharded_cg_solve_multi, {}), (sharded_cg_solve_block, {}),
                   (sharded_cg_solve_block, {"precondition": "jacobi"}),
                   (sharded_cg_solve_block, {"precondition": "poly"})):
        r1, r2 = fn(A, B, mesh=mesh1, **kw), fn(A, B, mesh=mesh2, **kw)
        assert torch.equal(r1.iterations, r2.iterations)
        assert torch.equal(r1.x, r2.x), (fn.__name__, kw)
    V = np.random.default_rng(2).standard_normal((100, 3)).astype(np.float32)
    for kw in ({}, {"precondition": "jacobi"}):
        r1 = sharded_cg_solve_deflated(A, b, V, mesh=mesh1, **kw)
        r2 = sharded_cg_solve_deflated(A, b, V, mesh=mesh2, **kw)
        assert int(r1.iterations) == int(r2.iterations) and torch.equal(r1.x, r2.x)
    for kw in ({}, {"precondition": "jacobi"}):
        r1 = sharded_minres_solve(A, b, mesh=mesh1, **kw)
        r2 = sharded_minres_solve(A, b, mesh=mesh2, **kw)
        assert int(r1.iterations) == int(r2.iterations) and torch.equal(r1.x, r2.x)


def _raises_like_tpucg(port_call, jax_call, match):
    with pytest.raises(ValueError, match=match):
        port_call()
    with pytest.raises(ValueError, match=match):
        jax_call()


def test_2d_refusals_match_tpucgs(one_rank):
    # Each 2-D refusal is tpucg's ValueError, in its words.
    _, mesh2 = one_rank
    jmesh = tpucg.make_mesh2d(2, 2)
    A, b, x0 = generate_spd_system(96, seed=1)
    B = np.ones((96, 3), np.float32)
    iv = (0.5, 200.0)
    _raises_like_tpucg(lambda: sharded_cg_solve(A, b, x0, mesh=mesh2, method="ca", interval=iv),
                       lambda: tpucg.sharded_cg_solve(A, b, x0, mesh=jmesh, method="ca",
                                                      interval=iv), "1-D")
    _raises_like_tpucg(lambda: sharded_cg_solve(A, b, mesh=mesh2, precondition="block_jacobi"),
                       lambda: tpucg.sharded_cg_solve(A, b, mesh=jmesh,
                                                      precondition="block_jacobi"),
                       "block_jacobi")
    _raises_like_tpucg(lambda: sharded_cg_solve(A, b, mesh=mesh2, n=96),
                       lambda: tpucg.sharded_cg_solve(A, b, mesh=jmesh, n=96), "n override")
    _raises_like_tpucg(lambda: sharded_minres_solve(A, b, mesh=mesh2, precondition="block_jacobi"),
                       lambda: tpucg.sharded_minres_solve(A, b, mesh=jmesh,
                                                          precondition="block_jacobi"),
                       "block_jacobi")
    _raises_like_tpucg(lambda: sharded_cg_solve_block(A, B, mesh=mesh2,
                                                      precondition="block_jacobi"),
                       lambda: tpucg.sharded_cg_solve_block(A, B, mesh=jmesh,
                                                            precondition="block_jacobi"),
                       "block Jacobi")
    _raises_like_tpucg(lambda: sharded_cg_solve_deflated(A, b, B, mesh=mesh2,
                                                         precondition="block_jacobi"),
                       lambda: tpucg.sharded_cg_solve_deflated(A, b, B, mesh=jmesh,
                                                              precondition="block_jacobi"),
                       "block Jacobi")
    _raises_like_tpucg(lambda: sharded_cg_solve_ir(A, b, mesh=mesh2),
                       lambda: tpucg.sharded_cg_solve_ir(A, b, mesh=jmesh), "1-D meshes")
    # Sparse operators take the 1-D decompositions (the 2-D arm is dense).
    from tpucg.io.generator import poisson3d_dia as jax_poisson3d_dia

    dia, jdia = poisson3d_dia(4), jax_poisson3d_dia(4)
    bd = np.ones(64, np.float32)
    Bd = np.ones((64, 2), np.float32)
    dense = "the 2-D SUMMA arm is dense"
    for port, jax in ((lambda: sharded_cg_solve_multi(dia, Bd, mesh=mesh2),
                       lambda: tpucg.sharded_cg_solve_multi(jdia, Bd, mesh=jmesh)),
                      (lambda: sharded_cg_solve_block(dia, Bd, mesh=mesh2),
                       lambda: tpucg.sharded_cg_solve_block(jdia, Bd, mesh=jmesh)),
                      (lambda: sharded_cg_solve_deflated(dia, bd, Bd, mesh=mesh2),
                       lambda: tpucg.sharded_cg_solve_deflated(jdia, bd, Bd, mesh=jmesh)),
                      (lambda: sharded_minres_solve(dia, bd, mesh=mesh2),
                       lambda: tpucg.sharded_minres_solve(jdia, bd, mesh=jmesh))):
        _raises_like_tpucg(port, jax, dense)
    with pytest.raises(ValueError, match=dense):
        sharded_operator_cg_solve(PoissonOperator(4, device="cpu"), bd, mesh=mesh2)


def test_make_mesh2d_surface(one_rank):
    mesh1, mesh2 = one_rank
    assert isinstance(mesh2, Mesh2D) and mesh2.shape == (1, 1) and (mesh2.i, mesh2.j) == (0, 0)
    assert (mesh2.rank, mesh2.size, mesh2.device, mesh2.backend) == (0, 1,
                                                                       torch.device("cpu"),
                                                                       "gloo")
    assert repr(mesh2) == "Mesh2D(rows x cols = 1 x 1: rank 0 = (0, 0) on cpu, transport gloo)"
    assert mesh2.col.size == mesh2.row.size == 1 and mesh2.stats is mesh2.world.stats
    assert mesh2.row.stats is mesh2.stats and mesh2.col.stats is mesh2.stats
    with pytest.raises(ValueError, match="only 1 ranks"):
        make_mesh2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="rows, cols >= 1"):
        make_mesh2d(0, 1, device="cpu")
    with pytest.raises(TypeError, match="Mesh2D"):
        distribute_system_2d(np.eye(8, dtype=np.float32), np.ones(8, np.float32), mesh=mesh1)
    with pytest.raises(ValueError, match="distribute_system_2d"):
        distribute_system(np.eye(8, dtype=np.float32), np.ones(8, np.float32), mesh=mesh2)
