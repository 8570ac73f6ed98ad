"""tpucg_torch's checkpoint on the mesh (ROADMAP M14 step 6) against tpucg's:
``sharded_cg_solve_checkpointed`` (1-D dense, a file per rank on more than
one rank; 2-D SUMMA, the whole-state file) and
``sharded_operator_cg_solve_checkpointed`` (Poisson slabs, DIA band halos,
sharded WELL with Jacobi and the two-level cycle; the whole-state file),
with tpucg's systems (``tests/test_checkpoint.py``'s sharded cases and
``tests/test_sharded_sparse.py``'s operators).

A solve killed at a segment boundary (capped at a lap count, its file
kept) and resumed from its file in a fresh call equals the uncheckpointed
sharded solve bit for bit, at 1 rank (in this process) and in worlds of 2
and 4 gloo ranks spawned once for the module
(``_torch_helpers.sharded_checkpoint_worker`` over ``CKPT_CASES``). The
file follows the rule of ``tpucg_torch.solver.checkpoint``'s docstring,
pinned here: one rank writes tpucg's whole-state file, more ranks of the
1-D dense solve a file per rank with tpucg's ``save_checkpoint_mp`` keys,
the 2-D and operator solves the whole-state file. Files cross the packages
at one rank and on a 2 x 2 mesh. Every refusal is tpucg's error type and,
on a mesh, raised on every rank (none left waiting).
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import (
    CKPT_CASES,
    ckpt_case_run,
    ckpt_systems,
    run_world,
    scaled_err,
    sharded_checkpoint_worker,
)
from tpucg_torch.comm.mesh import init_distributed, make_mesh, make_mesh2d
from tpucg_torch.solver.checkpoint import (
    save_checkpoint_mp,
    sharded_cg_solve_checkpointed,
    sharded_operator_cg_solve_checkpointed,
)
from tpucg_torch.solver.operators import PoissonOperator
from tpucg_torch.solver.sharded import distribute_system, sharded_cg_solve

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    return ckpt_systems(str(tmp_path_factory.mktemp("ckpt_systems")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, systems):
    """{P: rank 0's results} from one spawned gloo world of each size, both
    at once; tpucg's 2 x 2 whole-state file (capped at 8 laps) is written
    first for the world of 4 to resume, and tpucg's uninterrupted 2 x 2
    solve is solved here meanwhile."""
    from tpucg.solver.checkpoint import sharded_cg_solve_checkpointed as jax_ckpt

    tmp = tmp_path_factory.mktemp("ckpt_worlds")
    A, b, x0 = systems["dense"]
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=400)
    jfile = str(tmp / "tpucg_2x2.npz")
    jmesh = tpucg.make_mesh2d(2, 2)
    capped = jax_ckpt(A, b, x0, mesh=jmesh, segment_iters=4, checkpoint_path=jfile,
                      **dict(kw, maxiter=8))
    assert int(capped.iterations) == 8 and os.path.exists(jfile)
    dirs = {P: tmp / f"w{P}" for P in WORLDS}
    for p in dirs.values():
        p.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {P: pool.submit(run_world, P, sharded_checkpoint_worker,
                                  args=(str(dirs[P]), systems, jfile if P == 4 else None),
                                  rendezvous=str(tmp / f"rv{P}")) for P in WORLDS}
        jref = tpucg.sharded_cg_solve(A, b, x0, mesh=jmesh, **kw)
        return {P: f.result() for P, f in futures.items()}, jref


@pytest.fixture(scope="module")
def one_rank():
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu"), make_mesh2d(1, 1, device="cpu")
    torch.distributed.destroy_process_group()


def _expected_files(kind, P):
    """[whole-state file, .proc0, .proc1, ...] that a capped solve keeps."""
    if P == 1 or kind != "dense":
        return [True] + [False] * P
    return [False] + [True] * P


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_kill_and_resume_is_bit_for_bit_on_the_mesh(runs, name, P):
    got = runs[0][P][name]
    kind, o = CKPT_CASES[name]
    assert got["capped_laps"] == o["cap"] and not got["capped_converged"]
    assert got["kept"] == _expected_files(kind, P)
    assert got["converged"] and got["laps"] == got["ref_laps"] > o["cap"]
    assert got["bits"]
    assert not any(got["left"])  # a converged solve removes its files


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("what", ["tol", "precondition", "signature", "n", "host_arrays",
                                  "torn", "topology", "missing"])
def test_refusals_raise_on_every_rank(runs, what, P):
    got = runs[0][P][what]
    assert got["error"] is not None and got["error"][0] == "ValueError", got
    assert got["ranks_raised"] == P
    match = {"tol": "tol", "precondition": "precondition", "signature": "DIFFERENT system",
             "n": "n=64", "host_arrays": "load_system_sharded", "torn": "torn",
             "topology": "same topology", "missing": "torn"}[what]
    assert match in got["error"][1], got["error"]


def test_tpucgs_2x2_file_resumes_on_the_ports_2x2_world(runs):
    got, jref = runs[0][4]["tpucg_2d"], runs[1]
    assert got["converged"] and not got["left"]
    assert abs(got["laps"] - int(jref.iterations)) <= 1
    assert scaled_err(got["x"], np.asarray(jref.x)) <= 1e-5
    assert scaled_err(got["x"], runs[0][4]["tpucg_2d_plain"]) <= 1e-5


@pytest.mark.parametrize("P", WORLDS)
def test_mesh_results_match_tpucgs_checkpointed_solves(runs, systems, P):
    # The resumed dense and Poisson solves against tpucg's checkpointed
    # solves on make_mesh(P), run through.
    from tpucg.solver.checkpoint import (
        sharded_cg_solve_checkpointed as jax_dense,
        sharded_operator_cg_solve_checkpointed as jax_op,
    )
    from tpucg.solver.operators import PoissonOperator as JPoisson

    A, b, x0 = systems["dense"]
    jd = jax_dense(A, b, x0, mesh=tpucg.make_mesh(P), segment_iters=4,
                   tol=1e-5 * float(np.linalg.norm(b)), maxiter=400)
    got = runs[0][P]["dense_allgather"]
    assert abs(got["laps"] - int(jd.iterations)) <= 1  # the stop lies at the f32 noise
    assert scaled_err(got["x"], np.asarray(jd.x)) <= 1e-5
    bp = systems["poisson_b"]
    jp = jax_op(JPoisson(m=8), bp, mesh=tpucg.make_mesh(P), segment_iters=8,
                tol=1e-5 * float(np.linalg.norm(bp)), maxiter=2000)
    got = runs[0][P]["poisson_m8"]
    assert abs(got["laps"] - int(jp.iterations)) <= 1
    assert scaled_err(got["x"], np.asarray(jp.x)) <= 1e-5


# ---- one rank, in this process ------------------------------------------------


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_kill_and_resume_is_bit_for_bit_at_one_rank(one_rank, systems, tmp_path, name):
    mesh, mesh2d = one_rank
    plain, ck = ckpt_case_run(mesh, mesh2d, name, systems)
    kind, o = CKPT_CASES[name]
    path = str(tmp_path / "c.npz")
    ref = plain()
    straight = ck(segment_iters=o["seg"])
    assert int(straight.iterations) == int(ref.iterations) and torch.equal(straight.x, ref.x)
    capped = ck(segment_iters=o["seg"], maxiter=o["cap"], checkpoint_path=path)
    assert int(capped.iterations) == o["cap"]
    assert [os.path.exists(path), os.path.exists(path + ".proc0")] == [True, False]
    res = ck(segment_iters=o["seg"], checkpoint_path=path)
    assert bool(res.converged) and int(res.iterations) == int(ref.iterations)
    assert torch.equal(res.x, ref.x) and not os.path.exists(path)


def test_one_rank_files_cross_the_packages(one_rank, systems, tmp_path):
    # tpucg's single-process file of its sharded solve resumes in the
    # port's one-rank solve, and the port's in tpucg's (make_mesh(1)).
    from tpucg.solver.checkpoint import sharded_cg_solve_checkpointed as jax_ckpt

    mesh, _ = one_rank
    A, b, x0 = systems["dense"]
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=400)
    ref = sharded_cg_solve(A, b, x0, mesh=mesh, **kw)
    jref = tpucg.sharded_cg_solve(A, b, x0, mesh=tpucg.make_mesh(1), **kw)
    for writer in ("tpucg", "port"):
        path = str(tmp_path / f"{writer}.npz")
        first = (lambda **k: jax_ckpt(A, b, x0, mesh=tpucg.make_mesh(1), **k)) \
            if writer == "tpucg" else \
            (lambda **k: sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, **k))
        then = (lambda **k: sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, **k)) \
            if writer == "tpucg" else \
            (lambda **k: jax_ckpt(A, b, x0, mesh=tpucg.make_mesh(1), **k))
        capped = first(segment_iters=4, checkpoint_path=path, **dict(kw, maxiter=8))
        assert int(capped.iterations) == 8 and os.path.exists(path)
        res = then(segment_iters=4, checkpoint_path=path, **kw)
        assert bool(res.converged) and not os.path.exists(path)
        assert abs(int(res.iterations) - int(ref.iterations)) <= 1
        assert abs(int(ref.iterations) - int(jref.iterations)) <= 1
        assert scaled_err(np.asarray(res.x), ref.x.numpy()) <= 1e-5


def test_per_rank_file_is_tpucgs_save_checkpoint_mp(one_rank, tmp_path):
    # The port's per-rank file carries tpucg's keys, dtypes and shapes, and
    # the same values, for the same state.
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Ps

    from tpucg.solver.cg import _State as JState
    from tpucg.solver.checkpoint import save_checkpoint_mp as jax_save_mp

    mesh, _ = one_rank
    rng = np.random.default_rng(3)
    x, r, p = (rng.standard_normal(64).astype(np.float32) for _ in range(3))
    sig = rng.standard_normal(8)
    jm = tpucg.make_mesh(8)
    sh = NamedSharding(jm, Ps(jm.axis_names[0]))
    jstate = JState(k=jnp.int32(7), x=jax.device_put(x, sh), r=jax.device_put(r, sh),
                    p=jax.device_put(p, sh), rsold=jnp.float32(0.5), rslast=jnp.float32(0.25),
                    done=jnp.bool_(False))
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_save_mp(jpath, jstate, 60, 1e-5, signature=sig, precondition="jacobi")
    state = dict(k=np.int32(7), x=x, r=r, p=p, rsold=np.float32(0.5), rslast=np.float32(0.25),
                 done=np.bool_(False))
    save_checkpoint_mp(ppath, state, 60, 1e-5, signature=sig, precondition="jacobi", mesh=mesh)
    with np.load(jpath + ".proc0") as jz, np.load(ppath + ".proc0") as pz:
        assert set(jz.files) == set(pz.files)
        for key in jz.files:
            assert jz[key].dtype == pz[key].dtype and jz[key].shape == pz[key].shape, key
            np.testing.assert_array_equal(jz[key], pz[key], err_msg=key)


def test_refusals_match_tpucgs_error_types(one_rank, systems, tmp_path):
    from tpucg.solver.checkpoint import (
        sharded_cg_solve_checkpointed as jax_dense,
        sharded_operator_cg_solve_checkpointed as jax_op,
    )
    from tpucg.solver.operators import PoissonOperator as JPoisson

    mesh, mesh2d = one_rank
    A, b, x0 = systems["dense"]
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=400)
    for i, (port, jax) in enumerate((
            (lambda p, **k: sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, checkpoint_path=p,
                                                          **k),
             lambda p, **k: jax_dense(A, b, x0, mesh=tpucg.make_mesh(1), checkpoint_path=p,
                                      **k)),
            (lambda p, **k: sharded_operator_cg_solve_checkpointed(
                PoissonOperator(8, device="cpu"), systems["poisson_b"], mesh=mesh,
                checkpoint_path=p, **k),
             lambda p, **k: jax_op(JPoisson(m=8), systems["poisson_b"],
                                   mesh=tpucg.make_mesh(1), checkpoint_path=p, **k)))):
        for fn in (port, jax):
            path = str(tmp_path / f"r{i}_{fn is port}.npz")
            tol = 1e-5 * float(np.linalg.norm(b if i == 0 else systems["poisson_b"]))
            fn(path, segment_iters=2, maxiter=2, tol=tol)
            for bad in (dict(tol=2 * tol), dict(tol=tol, precondition="jacobi")):
                with pytest.raises(ValueError, match="tol|precondition"):
                    fn(path, **bad)
    # Another system (b doubled) and another size.
    path = str(tmp_path / "sys.npz")
    sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, checkpoint_path=path, segment_iters=2,
                                  **dict(kw, maxiter=2))
    with pytest.raises(ValueError, match="DIFFERENT system"):
        sharded_cg_solve_checkpointed(A, 2 * b, x0, mesh=mesh, checkpoint_path=path, **kw)
    with pytest.raises(ValueError, match="n=96"):
        sharded_cg_solve_checkpointed(A[:64, :64], b[:64], None, mesh=mesh, checkpoint_path=path,
                                      **kw)
    # tpucg's 2-D and operator refusals.
    system = distribute_system(A, b, x0, mesh)
    for bad in (lambda: sharded_cg_solve_checkpointed(system, mesh=mesh2d),
                lambda: sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh2d, n=96)):
        with pytest.raises(ValueError, match="2-D checkpointing takes host arrays"):
            bad()
    with pytest.raises(ValueError, match="1-D meshes"):
        sharded_operator_cg_solve_checkpointed(PoissonOperator(8, device="cpu"),
                                               systems["poisson_b"], mesh=mesh2d)
    with pytest.raises(ValueError, match="n override"):
        sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, n=64)
    for pc in ("poly", "block_jacobi"):
        with pytest.raises(ValueError, match="precondition in"):
            sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, precondition=pc)
        with pytest.raises(ValueError, match="precondition in"):
            jax_dense(A, b, x0, mesh=tpucg.make_mesh(1), precondition=pc)
    with pytest.raises(ValueError, match="method='cg'"):
        sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, method="pipelined")
    with pytest.raises(ValueError, match="THE preconditioner"):
        sharded_operator_cg_solve_checkpointed(PoissonOperator(8, device="cpu"),
                                               systems["poisson_b"], mesh=mesh,
                                               precondition="jacobi", two_level=object())


def test_placement_checks_are_the_plain_solves(one_rank, systems):
    """The checkpointed and plain 1-D dense solves place a system through
    one helper: a DistributedSystem laid out for another strategy or stored
    in bf16 is refused by both (the checkpoint is f32 only)."""
    mesh, _ = one_rank
    A, b, x0 = systems["dense"]
    for solve in (sharded_cg_solve, sharded_cg_solve_checkpointed):
        with pytest.raises(ValueError, match="strategy 'allgather'"):
            solve(distribute_system(A, b, x0, mesh), mesh=mesh, strategy="overlap")
        with pytest.raises(ValueError, match="stores A in torch.bfloat16"):
            solve(distribute_system(A, b, x0, mesh, storage_dtype=torch.bfloat16), mesh=mesh)
        with pytest.raises(ValueError, match="holds its b and x0"):
            solve(distribute_system(A, b, x0, mesh), b, mesh=mesh)
