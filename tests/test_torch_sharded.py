"""tpucg_torch's distributed CG over torch.distributed (gloo on the CPU)
against tpucg's sharded solves at the same number of ranks, and a world of
one rank against the port's serial solve.

Worlds of 2 and 4 ranks are spawned once for the module
(``_torch_helpers.run_world``, a file rendezvous in the test's temporary
directory); every rank runs every case of ``DENSE_CASES`` (with both
strategies) and ``OPERATOR_CASES``, and rank 0 returns the results. tpucg
runs each case on ``make_mesh(P)`` of the 8 CPU devices that
``tests/conftest.py`` forces. Tolerances follow tpucg's own tests: laps
equal where they hold its sharded solve to its serial one, within one where
they allow one, and x within their tolerances, measured against max |x| for
the generator systems (x ~ 1/n). Generator systems that stop where ||r||
meets tol within rounding are held within one lap; ``spectrum_n96``, whose
spectrum sets the laps, pins equality.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.formats as jfmt
from _torch_helpers import (
    DENSE_CASES,
    OPERATOR_CASES,
    run_world,
    scaled_err,
    sharded_cases_worker,
    sharded_system,
)
from tpucg.solver.operators import BsrOperator as JBsrOperator
from tpucg.solver.operators import EllOperator as JEllOperator
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg.solver.sharded import sharded_cg_solve as j_sharded_cg_solve
from tpucg.solver.sharded import sharded_operator_cg_solve as j_sharded_operator_cg_solve
from tpucg_torch.comm.mesh import Mesh, init_distributed, make_mesh
from tpucg_torch.io.generator import generate_spd_system, poisson3d_csr, poisson3d_dia
from tpucg_torch.io.partitioner import RowPartition, pad_system
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import (
    BsrOperator,
    DiaOperator,
    EllOperator,
    PoissonOperator,
    WellOperator,
)
from tpucg_torch.solver.sharded import (
    DistributedSystem,
    distribute_system,
    ROW_ALIGN,
    sharded_cg_solve,
    sharded_operator_cg_solve,
)
from tpucg_torch.sparse.formats import csr_to_bsr

WORLDS = (2, 4)
DENSE_IDS = [(name, s) for name in DENSE_CASES for s in ("allgather", "overlap")]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{P: {(case, strategy): result}} from one spawned gloo world of each
    size, both worlds running at once."""
    tmp = tmp_path_factory.mktemp("rendezvous")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {P: pool.submit(run_world, P, sharded_cases_worker,
                                  rendezvous=str(tmp / f"world{P}")) for P in WORLDS}
        return {P: f.result() for P, f in futures.items()}


@pytest.fixture(scope="module")
def one_rank():
    """This process as a world of one rank (gloo, an in-process store)."""
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


def _jax_case(name, strategy, P):
    """tpucg's sharded solve of the case on make_mesh(P)."""
    spec, kw = DENSE_CASES[name] if name in DENSE_CASES else OPERATOR_CASES[name]
    kw = dict(kw)
    s = sharded_system(spec)
    bf16 = kw.pop("storage", "f32") == "bf16"
    if "tol_rel" in kw:
        kw["tol"] = kw.pop("tol_rel") * float(np.linalg.norm(s["b"]))
    extra = {"storage_dtype": jnp.bfloat16} if bf16 else {}
    mesh = tpucg.make_mesh(P)
    if "A" in s:
        return j_sharded_cg_solve(s["A"], s["b"], s["x0"], mesh=mesh, strategy=strategy,
                                  **extra, **kw)
    op = s["op"]
    kind = type(op).__name__
    if isinstance(op, tuple):
        op = JPoissonOperator(m=op[1])
    elif kind == "DIAMatrix":
        op = jfmt.DIAMatrix(offsets=op.offsets, data=op.data, shape=op.shape)
    elif kind == "CSRMatrix":
        op = JEllOperator.from_csr(jfmt.CSRMatrix(indptr=op.indptr, indices=op.indices,
                                                  data=op.data, shape=op.shape))
    else:
        op = JBsrOperator.from_bsr(jfmt.BSRMatrix(indptr=op.indptr, indices=op.indices,
                                                  data=op.data, shape=op.shape))
    n = s["b"].shape[0]
    kw.setdefault("tol", 1e-5 * float(np.linalg.norm(s["b"])))
    kw.setdefault("maxiter", 4 * n)
    return j_sharded_operator_cg_solve(op, s["b"], s["x0"], mesh=mesh, **extra, **kw)


# Laps equal to tpucg's where its own test holds its sharded solve to its
# serial one (test_sharded.py:142, test_sharded_sparse.py:27-109) or the
# spectrum sets them; within one where its test allows one (DIA, BSR, the
# generator systems against the oracle, bf16, the preconditioned Poisson).
EQUAL_LAPS = ("golden_4x4", "spectrum_n96", "record_n96", "poisson_m8",
              "poisson_m9_pad_planes", "ell_m7")


def _laps_ok(name, got, want):
    return got == want if name in EQUAL_LAPS else abs(got - want) <= 1


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name,strategy", DENSE_IDS)
def test_dense_matches_tpucg(worlds, name, strategy, P):
    got = worlds[P][(name, strategy)]
    want = _jax_case(name, strategy, P)
    k, jk = got["iterations"], int(want.iterations)
    jx = np.asarray(want.x)
    assert got["converged"] and bool(want.converged)
    assert _laps_ok(name, k, jk), (k, jk)
    assert got["x"].shape == jx.shape
    if name == "golden_4x4":
        assert k == 4
        np.testing.assert_allclose(got["x"], [-1.0, 1.0, -1.0, 1.0], atol=1e-5)
    elif name == "spectrum_n96":
        assert k == 4
    bound = 2e-3 if name == "bf16_n96" else 1e-4
    assert scaled_err(got["x"], jx) <= bound
    if name == "record_n96":
        hs, hj = got["hist"], np.asarray(want.residual_history)
        np.testing.assert_allclose(hs[0], hj[0], rtol=1e-4)
        kk = min(k, jk)
        np.testing.assert_allclose(np.log10(hs[1:kk + 1]), np.log10(hj[1:kk + 1]), atol=0.5)
        assert np.all(np.isnan(hs[k + 1:])) and hs[k] < 1e-6
    else:
        assert got["hist"] is None


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(OPERATOR_CASES))
def test_operator_matches_tpucg(worlds, name, P):
    got = worlds[P][(name, None)]
    want = _jax_case(name, None, P)
    k, jk = got["iterations"], int(want.iterations)
    jx = np.asarray(want.x)
    assert got["converged"] and bool(want.converged)
    assert _laps_ok(name, k, jk), (k, jk)
    bound = 1e-3 if name == "dia_m16_bf16" else 1e-4
    assert scaled_err(got["x"], jx) <= bound
    x_true = sharded_system(OPERATOR_CASES[name][0])["x_true"]
    assert scaled_err(got["x"], x_true) <= 2e-3


def test_worlds_sum_in_rank_order(worlds):
    # Every rank holds the same sum of the partials (1 + r) / 3, added left to
    # right in rank order in float32.
    for P in WORLDS:
        sums = worlds[P]["rank_sum"]
        want = np.float32(0)
        for r in range(P):
            want = np.float32(want + np.float32(np.float32(1 + r) / np.float32(3)))
        assert sums == [float(want)] * P


# ---- one rank against the serial solve ---------------------------------------


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_one_rank_equals_serial_dense(one_rank, strategy, pc):
    A, b, x0 = generate_spd_system(256, seed=3)  # npad 256 on both paths
    got = sharded_cg_solve(A, b, x0, mesh=one_rank, strategy=strategy, precondition=pc,
                           record_residuals=True)
    want = cg_solve(A, b, x0, device="cpu", precondition=pc, record_residuals=True)
    assert int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual_history.nan_to_num(-1.0),
                       want.residual_history.nan_to_num(-1.0))


def _operators():
    m = 10
    csr = poisson3d_csr(m)
    return {
        "poisson": PoissonOperator(m, device="cpu"),
        "dia_f32": DiaOperator.from_dia(poisson3d_dia(m), device="cpu"),
        "dia_bf16": DiaOperator.from_dia(poisson3d_dia(m), device="cpu",
                                         storage_dtype=torch.bfloat16),
        "ell": EllOperator.from_csr(csr, device="cpu"),
        "bsr": BsrOperator.from_bsr(csr_to_bsr(csr, 8), device="cpu"),
    }


@pytest.mark.parametrize("kind", ["poisson", "dia_f32", "dia_bf16", "ell", "bsr"])
@pytest.mark.parametrize("pc", ["none", "poly"])
def test_one_rank_equals_serial_operator(one_rank, kind, pc):
    op = _operators()[kind]
    n = op.n
    xt = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    b = poisson3d_csr(10).matvec(xt).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4 * n, precondition=pc)
    storage = op.data.dtype if kind.startswith("dia") else torch.float32
    got = sharded_operator_cg_solve(op, b, mesh=one_rank, storage_dtype=storage, **kw)
    want = cg_solve(op, b, **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)


def test_distribute_system_layouts(one_rank):
    A, b, x0 = generate_spd_system(50, seed=2)
    part = RowPartition(n=50, num_shards=1, align=ROW_ALIGN)
    Ap, bp, x0p = pad_system(A, b, x0, part)
    for strategy in ("allgather", "overlap"):
        sys_ = distribute_system(A, b, x0, one_rank, strategy=strategy)
        assert isinstance(sys_, DistributedSystem) and sys_.part == part
        assert np.array_equal(sys_.A.reshape(56, 56).numpy(), Ap)
        assert np.array_equal(sys_.b.numpy(), bp) and np.array_equal(sys_.x0.numpy(), x0p)
        res = sharded_cg_solve(sys_, mesh=one_rank, strategy=strategy, n=40)
        assert res.x.shape == (40,)
        with pytest.raises(ValueError, match="strategy"):
            sharded_cg_solve(sys_, mesh=one_rank,
                             strategy="overlap" if strategy == "allgather" else "allgather")
        with pytest.raises(ValueError, match="storage_dtype"):
            sharded_cg_solve(sys_, mesh=one_rank, strategy=strategy,
                             storage_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="b and x0"):
            sharded_cg_solve(sys_, b, mesh=one_rank, strategy=strategy)


def test_refusals_name_their_roadmap_item(one_rank):
    A, b, _ = generate_spd_system(16, seed=0)
    op = PoissonOperator(4, device="cpu")
    b4 = np.ones(64, np.float32)
    for kw, item in (({"method": "pipelined"}, "M8"), ({"precondition": "block_jacobi"}, "M8"),
                     ({"interval": (1.0, 2.0)}, "M8")):
        with pytest.raises(NotImplementedError, match=item):
            sharded_cg_solve(A, b, mesh=one_rank, **kw)
        with pytest.raises(NotImplementedError, match=item):
            sharded_operator_cg_solve(op, b4, mesh=one_rank, **kw)
    with pytest.raises(NotImplementedError, match="M14 step 5"):
        sharded_operator_cg_solve(op, b4, mesh=one_rank, two_level=object())
    csr = poisson3d_csr(4)
    with pytest.raises(NotImplementedError, match="shard packers"):
        sharded_operator_cg_solve(csr, b4, mesh=one_rank)
    with pytest.raises(NotImplementedError, match="shard packers"):
        sharded_operator_cg_solve(WellOperator.from_csr(csr, device="cpu"), b4, mesh=one_rank)
    with pytest.raises(ValueError, match="bfloat16"):
        sharded_operator_cg_solve(op, b4, mesh=one_rank, storage_dtype=torch.bfloat16)
    no_main = DiaOperator(data=torch.ones(2, 128), offsets=(-1, 1), n=128)
    with pytest.raises(ValueError, match="main diagonal"):
        sharded_operator_cg_solve(no_main, np.ones(128, np.float32), mesh=one_rank)
    with pytest.raises(ValueError, match="strategy"):
        sharded_cg_solve(A, b, mesh=one_rank, strategy="ring")


def test_mesh_surface(one_rank):
    assert (one_rank.rank, one_rank.size, one_rank.backend) == (0, 1, "gloo")
    assert repr(one_rank) == "Mesh(rows: rank 0 of 1 on cpu, transport gloo)"
    assert not one_rank.staged
    staged = Mesh(group=None, rank=0, size=2, device=torch.device("cuda", 0), backend="gloo")
    assert staged.staged and "pinned host memory" in repr(staged)
    s = one_rank.rank_sum(torch.tensor(0.1))
    assert torch.equal(s, torch.tensor(0.1))
    with pytest.raises(ValueError, match="nccl"):
        make_mesh(device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            make_mesh(device="cuda")
        with pytest.raises(RuntimeError, match="card"):
            make_mesh()
    with pytest.raises(ValueError, match="together"):
        init_distributed(init_method="file:///nowhere", backend="gloo")


def test_partitioner_is_tpucgs():
    from tpucg.io.partitioner import RowPartition as JRowPartition
    from tpucg.io.partitioner import pad_system as j_pad_system

    A, b, x0 = generate_spd_system(10, seed=9)
    for shards, align in ((8, 8), (3, 1), (1, 128)):
        part, jpart = RowPartition(10, shards, align), JRowPartition(10, shards, align)
        assert (part.n_padded, part.block_rows) == (jpart.n_padded, jpart.block_rows)
        assert part.row_range(shards - 1) == jpart.row_range(shards - 1)
        for got, want in zip(pad_system(A, b, x0, part), j_pad_system(A, b, x0, jpart)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="out of range"):
        RowPartition(10, 2).row_range(2)
