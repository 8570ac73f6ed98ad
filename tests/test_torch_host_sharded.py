"""tpucg_torch's host-sharded loading (ROADMAP M14 step 4) against tpucg's:
the native range parser and ``load_matrix_rows`` (tpucg's
``tests/test_native.py:88-125`` and the row-range cases of
``tests/test_textio.py``), ``local_rows_to_well_shard``,
``load_system_sharded``, ``load_well_system_sharded`` and
``build_two_level_from_parts`` (tpucg's ``tests/test_sharded_io_mtx.py``).

Worlds of 2 and 4 gloo ranks are spawned once for the module
(``_torch_helpers.run_world``, ``host_sharded_worker``) on the files of
``host_sharded_files``; tpucg loads the same files on ``make_mesh(P)`` of
the 8 CPU devices that ``tests/conftest.py`` forces while the worlds run.
Each rank of the port reads only its rows: the tokens it asks of the range
parser and the bytes it reads of the ``.mtx`` are counted. A world of one
rank runs in this process.

Tolerances: the loaded arrays equal tpucg's bit for bit; laps equal
tpucg's; x within 1e-4 of max |x| (5e-4 for the two-level solves, which stop
near FEM's f32 floor, where an iterate moves with the sums' order); the
two-level coarse inverse, whose float64 partial sums the ranks add in
another order than tpucg's single process, within 1e-6 relative, and the
same bits on every rank. FEM's Jacobi solve runs at 3e-4 ||b||, where
tpucg's own sharded solve takes 198 laps on 1, 2, 4 and 8 devices (at
tpucg's 1e-4, below the f32 floor, it takes 218-223 and the stop moves with
the sums' order). The pipelined two-level solve tests its stop every lap
on a recurrence whose rounding follows the sums' order: tpucg's own takes
65, 64, 65 and 66 laps on 1, 2, 4 and 8 devices, and the port is held
within one lap of tpucg's at the same P.
"""

import concurrent.futures
import os
import warnings

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import host_sharded_files, host_sharded_worker, run_world, scaled_err
from tpucg.io import _native as j_native
from tpucg.io import mmio as j_mmio
from tpucg.io import textio as j_textio
from tpucg.solver.sharded import load_system_sharded as j_load_system_sharded
from tpucg.solver.sharded import load_well_system_sharded as j_load_well_system_sharded
from tpucg.solver.sharded import sharded_cg_solve as j_sharded_cg_solve
from tpucg.solver.sharded import sharded_operator_cg_solve as j_sharded_operator_cg_solve
from tpucg.solver.twolevel import build_two_level as j_build_two_level
from tpucg.solver.twolevel import build_two_level_from_parts as j_build_from_parts
from tpucg.sparse import well as j_well
from tpucg_torch.comm.mesh import Mesh, init_distributed, make_mesh
from tpucg_torch.io import _native, mmio
from tpucg_torch.io.generator import random_geometric_spd
from tpucg_torch.io.textio import load_matrix_rows, load_system, save_array
from tpucg_torch.solver.sharded import (
    distribute_system,
    load_system_sharded,
    load_well_system_sharded,
    sharded_cg_solve,
    sharded_operator_cg_solve,
)
from tpucg_torch.solver.twolevel import build_two_level, build_two_level_from_parts
from tpucg_torch.sparse import well as port_well

WORLDS = (2, 4)
PACKS = ("vals", "lidx", "gidl", "wrow", "sgb")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return host_sharded_files(str(tmp_path_factory.mktemp("host_sharded")))


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """({P: rank 0's results}) from one spawned gloo world of each size,
    both at once; {P: tpucg's loads and solves}, computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("rendezvous")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {P: pool.submit(run_world, P, host_sharded_worker, args=(files,),
                                  rendezvous=str(tmp / f"world{P}")) for P in WORLDS}
        ref = {P: _jax_side(files, P) for P in WORLDS}
        return {P: f.result() for P, f in futures.items()}, ref


@pytest.fixture(scope="module")
def one_rank():
    """This process as a world of one rank (gloo, an in-process store)."""
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


def _jax_side(files, P):
    mesh = tpucg.make_mesh(P)
    out = {}
    for fmt in ("txt", "npy"):
        jA, jb, jx0, n = j_load_system_sharded(files[f"A_{fmt}"], files["b_txt"],
                                               files["x0_txt"], mesh=mesh)
        out[("dense", fmt)] = (np.asarray(jA), np.asarray(jb), np.asarray(jx0), n)
        for strategy in ("allgather", "overlap"):
            out[("dense", fmt, strategy)] = j_sharded_cg_solve(jA, jb, jx0, mesh=mesh, n=n,
                                                               strategy=strategy)
    ws = j_load_well_system_sharded(files["fem"], files["fem_b"], mesh=mesh, two_level_agg=64)
    out["well"] = ws
    nb = float(np.linalg.norm(np.load(files["fem_b"]).astype(np.float64)))
    n = ws.n
    for label, kw in (("jacobi", dict(precondition="jacobi", tol=3e-4 * nb)),
                      ("two_level", dict(two_level=ws.two_level, tol=2e-3 * nb)),
                      ("two_level_pipelined", dict(two_level=ws.two_level, method="pipelined",
                                                   tol=5e-3 * nb))):
        out[("well", label)] = j_sharded_operator_cg_solve(ws, mesh=mesh, maxiter=4 * n, **kw)
    return out


def _blocks_to_rows(stacked, strategy):
    """The ranks' blocks (P, blk, npad) or (P, P, blk, blk) as (npad, npad)."""
    if strategy == "overlap":
        P, _, blk, _ = stacked.shape
        stacked = stacked.transpose(0, 2, 1, 3).reshape(P, blk, P * blk)
    return stacked.reshape(-1, stacked.shape[-1])


# ---- the range parser and load_matrix_rows ------------------------------------


@pytest.fixture(scope="module")
def native_lib():
    if _native._load() is None or j_native._load() is None:
        pytest.skip("native libfastio.so unavailable (no g++/make?)")


def test_parse_range_equals_tpucgs(native_lib, tmp_path):
    # tpucg's test_native.py:88: interior, first and last ranges, and a
    # range past the end (its ValueError).
    vals = np.random.default_rng(3).random(10_000).astype(np.float32)
    p = str(tmp_path / "rng.txt")
    save_array(p, vals, fmt="%r")
    for start, count in ((1234, 567), (0, 10), (9_990, 10)):
        got = _native.parse_floats_range(p, start, count)
        np.testing.assert_array_equal(got, vals[start:start + count])
        np.testing.assert_array_equal(got, j_native.parse_floats_range(p, start, count))
    for parse in (_native.parse_floats_range, j_native.parse_floats_range):
        with pytest.raises(ValueError, match="yielded"):
            parse(p, 9_999, 5)
        with pytest.raises(IOError, match="failed to open"):
            parse(str(tmp_path / "missing.txt"), 0, 1)


def test_parse_range_multithreaded_equals_tpucgs(native_lib, tmp_path):
    # tpucg's test_native.py:105: a file over 1 MiB, parsed in threads.
    vals = np.random.default_rng(4).random(300_000).astype(np.float32)
    p = str(tmp_path / "big.txt")
    save_array(p, vals, fmt="%.8f")
    assert os.path.getsize(p) > (1 << 20)
    got = _native.parse_floats_range(p, 100_001, 123_456)
    np.testing.assert_array_equal(got, j_native.parse_floats_range(p, 100_001, 123_456))
    with open(p, "rb") as f:
        toks = j_textio._FLOAT_RE.findall(f.read())[100_001:100_001 + 123_456]
    np.testing.assert_array_equal(got, np.array([float(t) for t in toks], np.float32))


@pytest.mark.parametrize("fmt", ["txt", "npy"])
@pytest.mark.parametrize("rows", [(7, 23), (0, 40), (39, 40), (12, 12)])
def test_load_matrix_rows_equals_tpucgs(native_lib, tmp_path, fmt, rows):
    # tpucg's test_native.py:116 and test_textio.py's .npy rows.
    A = np.random.default_rng(5).random((40, 40)).astype(np.float32)
    p = str(tmp_path / f"A.{fmt}")
    save_array(p, A, fmt="%r") if fmt == "txt" else np.save(p, A)
    got = load_matrix_rows(p, *rows, 40)
    want = j_textio.load_matrix_rows(p, *rows, 40)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, A[rows[0]:rows[1]])


def test_load_matrix_rows_fallbacks_and_refusals(tmp_path, monkeypatch):
    A = np.random.default_rng(6).random((12, 12)).astype(np.float64)
    p = str(tmp_path / "A.txt")
    save_array(p, A, fmt="%.17g")
    # f64: the native parser is f32-only, so both packages warn and parse
    # the whole file; the rows keep their 17 digits.
    for load in (load_matrix_rows, j_textio.load_matrix_rows):
        with pytest.warns(RuntimeWarning, match="WHOLE matrix"):
            got = load(p, 3, 9, 12, dtype=np.float64)
        np.testing.assert_array_equal(got, A[3:9])
        with pytest.raises(ValueError, match="invalid row range"):
            load(p, 5, 3, 12)
        with pytest.warns(RuntimeWarning), pytest.raises(ValueError, match="expected 169"):
            load(p, 0, 2, 13, dtype=np.float64)
    wrong = str(tmp_path / "A.npy")
    np.save(wrong, A[:6].astype(np.float32))
    with pytest.raises(ValueError, match="expected 144 values"):
        load_matrix_rows(wrong, 0, 2, 12)
    # A library without the range symbol (a stale build): None, then the
    # warned whole-file path (tpucg's AttributeError case, _native.py:80-85).
    monkeypatch.setattr(_native, "_LIB", object())
    monkeypatch.setattr(_native, "_TRIED", True)
    assert _native.parse_floats_range(p, 0, 3) is None
    monkeypatch.setattr(_native, "parse_floats", lambda path: None)
    with pytest.warns(RuntimeWarning, match="range parser unavailable"):
        got = load_matrix_rows(p, 1, 4, 12)
    np.testing.assert_array_equal(got, A[1:4].astype(np.float32))
    with pytest.raises(FileNotFoundError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            load_matrix_rows(str(tmp_path / "none.txt"), 0, 1, 12)


# ---- local_rows_to_well_shard -------------------------------------------------


@pytest.mark.parametrize("P", [1, 4, 16])
def test_local_rows_to_well_shard_equals_tpucgs(tmp_path, P):
    # Each shard from its own rows (load_matrix_market_rows), shard 0's BS
    # for the rest as load_well_system_sharded does; at P = 16 shards 8-15
    # lie wholly in the identity tail (an empty COO).
    A, _, _ = random_geometric_spd(1000, seed=4, avg_degree=8.0)
    p = str(tmp_path / "g.mtx")
    mmio.save_matrix_market(p, A, symmetric=False)
    mmio.build_mm_index(p)
    n = A.shape[0]
    rps = -(-n // (P * port_well.LANE)) * port_well.LANE
    npad = P * rps
    BS = None
    from tpucg_torch.sparse.formats import COOMatrix

    for s in range(P):
        r0, r1 = s * rps, min(n, (s + 1) * rps)
        coo = (mmio.load_matrix_market_rows(p, r0, r1)[0] if r1 > r0 else
               COOMatrix(row=np.empty(0, np.int64), col=np.empty(0, np.int64),
                         data=np.empty(0, np.float32), shape=(rps, npad)))
        jcoo = j_mmio.load_matrix_market_rows(p, r0, r1)[0] if r1 > r0 else coo
        got = port_well.local_rows_to_well_shard(coo, s, rps, npad, n, BS)
        want = j_well.local_rows_to_well_shard(jcoo, s, rps, npad, n, BS)
        BS = got.block_sublanes if BS is None else BS
        assert got.block_sublanes == want.block_sublanes == BS
        assert got.shape == want.shape and got.groups_per_super == want.groups_per_super
        for k in PACKS:
            np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)), err_msg=k)


# ---- one rank -----------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["txt", "npy"])
@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_one_rank_dense_load_equals_distribute_system(one_rank, files, fmt, strategy):
    A, b, x0 = load_system(files["A_txt"], files["b_txt"], files["x0_txt"])
    for x0_path, x0v in ((files["x0_txt"], x0), (None, None)):
        got = load_system_sharded(files[f"A_{fmt}"], files["b_txt"], x0_path, mesh=one_rank,
                                  strategy=strategy)
        want = distribute_system(A, b, x0v, one_rank, strategy=strategy)
        assert got.part == want.part and got.n == 100 and got.strategy == strategy
        for f in ("A", "b", "x0"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        res = sharded_cg_solve(got, mesh=one_rank, strategy=strategy)
        ref = sharded_cg_solve(A, b, x0v, mesh=one_rank, strategy=strategy)
        assert int(res.iterations) == int(ref.iterations) and torch.equal(res.x, ref.x)
    jA, jb, jx0, n = j_load_system_sharded(files[f"A_{fmt}"], files["b_txt"], files["x0_txt"],
                                           mesh=tpucg.make_mesh(1))
    got = load_system_sharded(files[f"A_{fmt}"], files["b_txt"], files["x0_txt"],
                              mesh=one_rank)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(got.x0.numpy(), np.asarray(jx0))


def test_one_rank_well_load_equals_the_whole_pack(one_rank, files):
    from tpucg_torch.io.mmio import load_matrix_market
    from tpucg_torch.sparse.well import csr_to_well_sharded

    ws = load_well_system_sharded(files["fem"], files["fem_b"], mesh=one_rank)
    csr = load_matrix_market(files["fem"]).to_csr()
    stacked, st = csr_to_well_sharded(csr, 1)
    jws = j_load_well_system_sharded(files["fem"], files["fem_b"], mesh=tpucg.make_mesh(1))
    for i, k in enumerate(PACKS):
        np.testing.assert_array_equal(ws.block.arrays[i].numpy(), stacked[k][0], err_msg=k)
        np.testing.assert_array_equal(ws.block.arrays[i].numpy(),
                                      np.asarray(jws.op_arrays[i])[0], err_msg=k)
    assert (ws.n, ws.npad, ws.statics["rps"]) == (csr.shape[0], st["npad"], st["rps"])
    np.testing.assert_array_equal(ws.diag, jws.diag)
    np.testing.assert_array_equal(ws.b.numpy(), np.asarray(jws.b))
    with np.load(mmio.mm_index_path(files["fem"])) as z:
        off = z["row_offsets"]
    assert ws.bytes_read == off[-1] - off[0] == jws.bytes_read
    nb = float(np.linalg.norm(np.load(files["fem_b"]).astype(np.float64)))
    kw = dict(mesh=one_rank, precondition="jacobi", tol=3e-4 * nb, maxiter=4 * ws.n)
    got = sharded_operator_cg_solve(ws, **kw)
    want = sharded_operator_cg_solve(csr, np.load(files["fem_b"]), **kw)
    assert int(got.iterations) == int(want.iterations) and torch.equal(got.x, want.x)


def test_two_level_from_parts_one_rank_equals_tpucgs(one_rank, files):
    # One rank: the same parts in the same order, bit for bit tpucg's; the
    # diagonal summed from the parts or passed; and tpucg's comparison with
    # the whole build (test_sharded_io_mtx.py:153).
    n = mmio.load_matrix_market(files["fem"]).shape[0]
    num = 8
    rps = -(-n // (num * 128)) * 128
    npad = num * rps
    parts, jparts = [], []
    for s in range(num):
        r0, r1 = s * rps, min(n, (s + 1) * rps)
        if r1 > r0:
            parts.append((r0, mmio.load_matrix_market_rows(files["fem"], r0, r1)[0]))
            jparts.append((r0, j_mmio.load_matrix_market_rows(files["fem"], r0, r1)[0]))
    want = j_build_from_parts(jparts, n=n, npad=npad, agg_size=64)
    for mesh in (None, one_rank):
        got = build_two_level_from_parts(parts, n=n, npad=npad, agg_size=64, mesh=mesh,
                                         device="cpu")
        np.testing.assert_array_equal(got.acinv.numpy(), np.asarray(want.acinv))
        np.testing.assert_array_equal(got.dinv.numpy(), np.asarray(want.dinv))
        assert (got.agg, got.npad, got.nc) == (64, npad, npad // 64)
    given = build_two_level_from_parts(parts, n=n, npad=npad, agg_size=64, device="cpu",
                                       diag=1.0 / want.dinv, smooth_degree=2)
    np.testing.assert_array_equal(given.acinv.numpy(), np.asarray(want.acinv))
    assert given.smooth_degree == 2
    A = mmio.load_matrix_market(files["fem"]).to_csr()
    full = build_two_level(A, agg_size=64, npad=npad, device="cpu")
    np.testing.assert_allclose(got.acinv.numpy(), full.acinv.numpy(), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(got.dinv.numpy(), full.dinv.numpy(), rtol=1e-6)
    jfull = j_build_two_level(A, agg_size=64, npad=npad)
    np.testing.assert_array_equal(full.acinv.numpy(), np.asarray(jfull.acinv))
    with pytest.raises(ValueError, match="agg_size must be >= 2"):
        build_two_level_from_parts(parts, n=n, npad=npad, agg_size=1)
    with pytest.raises(ValueError, match=r"agg_size \| npad"):
        build_two_level_from_parts(parts, n=n, npad=npad, agg_size=100)
    with pytest.raises(ValueError, match="diag must have shape"):
        build_two_level_from_parts(parts, n=n, npad=npad, agg_size=64, diag=np.ones(3))
    with pytest.raises(ValueError, match="smooth_degree"):
        build_two_level_from_parts(parts, n=n, npad=npad, agg_size=64, smooth_degree=0)


def test_refusals(one_rank, files, tmp_path):
    ws = load_well_system_sharded(files["fem"], files["fem_b"], mesh=one_rank)
    b = np.load(files["fem_b"])
    with pytest.raises(ValueError, match="bfloat16"):
        sharded_operator_cg_solve(ws, mesh=one_rank, storage_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs the source CSR"):
        sharded_operator_cg_solve(ws, mesh=one_rank, precondition="block_jacobi")
    other = Mesh(group=None, rank=1, size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="packed for rank 0 of 1"):
        sharded_operator_cg_solve(ws, b, mesh=other)
    with pytest.raises(ValueError, match="two_level_agg=100 must divide"):
        load_well_system_sharded(files["fem"], files["fem_b"], mesh=one_rank, two_level_agg=100)
    with pytest.raises(ValueError, match="b is required"):
        sharded_operator_cg_solve(mmio.load_matrix_market(files["fem"]).to_csr(),
                                  mesh=one_rank)
    with pytest.raises(ValueError, match="b must have shape"):
        sharded_operator_cg_solve(ws, b[:10], mesh=one_rank)
    with pytest.raises(ValueError, match=f"expected {ws.n} values"):
        load_well_system_sharded(files["fem"], files["b_txt"].replace("b.txt", "A.npy"),
                                 mesh=one_rank)
    rect = str(tmp_path / "rect.mtx")
    from tpucg_torch.sparse.formats import COOMatrix

    mmio.save_matrix_market(rect, COOMatrix(row=np.arange(3), col=np.arange(3),
                                            data=np.ones(3, np.float32), shape=(3, 4)))
    mmio.build_mm_index(rect)
    with pytest.raises(ValueError, match="CG needs square SPD"):
        load_well_system_sharded(rect, mesh=one_rank)
    with pytest.raises(ValueError, match="unknown strategy"):
        load_system_sharded(files["A_txt"], files["b_txt"], mesh=one_rank, strategy="ring")
    # The port's 2-D mesh is refused in tpucg's words (its loaders take a
    # 1-D mesh); tpucg's own mesh is not a mesh of this package.
    from tpucg_torch.comm.mesh import make_mesh2d

    with pytest.raises(ValueError, match="takes a 1-D mesh"):
        load_system_sharded(files["A_txt"], files["b_txt"], mesh=make_mesh2d(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="takes a 1-D mesh"):
        load_well_system_sharded(files["fem"], mesh=make_mesh2d(1, 1, device="cpu"))
    with pytest.raises(TypeError, match="Mesh2D"):
        load_system_sharded(files["A_txt"], files["b_txt"], mesh=tpucg.make_mesh(1))
    # A placed system whose rank blocks are not whole bs-blocks: the
    # solve's ValueError; with the config, the partition aligns to them.
    s = load_system_sharded(files["A_txt"], files["b_txt"], mesh=one_rank)
    with pytest.raises(ValueError, match="pc_block_size=24"):
        sharded_cg_solve(s, mesh=one_rank, precondition="block_jacobi", pc_block_size=24)
    from tpucg_torch.config import CGConfig

    s = load_system_sharded(files["A_txt"], files["b_txt"], mesh=one_rank,
                            config=CGConfig(precondition="block_jacobi", pc_block_size=24))
    assert s.part.block_rows % 24 == 0
    assert bool(sharded_cg_solve(s, mesh=one_rank, precondition="block_jacobi",
                                 pc_block_size=24).converged)


def test_exports_leave_only_step_6_and_7():
    # Steps 6 and 7 brought the last three names: no name of tpucg is missing.
    import tpucg_torch

    assert set(tpucg.__all__) - set(tpucg_torch.__all__) == set()
    for name in ("sharded_cg_solve_checkpointed", "sharded_operator_cg_solve_checkpointed",
                 "make_mesh2d", "Mesh2D", "distribute_system_2d"):
        assert hasattr(tpucg_torch, name), name
    for name in ("load_system_sharded", "load_well_system_sharded", "WellShardedSystem",
                 "build_two_level_from_parts", "load_matrix_rows", "sharded_cg_solve_deflated",
                 "sharded_minres_solve", "sharded_cg_solve_ir"):
        assert hasattr(tpucg_torch, name), name


# ---- worlds of 2 and 4 ranks --------------------------------------------------


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("fmt", ["txt", "npy"])
@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_dense_load_equals_tpucgs_row_blocks(runs, files, P, fmt, strategy):
    got = runs[0][P][("dense", fmt, strategy)]
    jA, jb, jx0, n = runs[1][P][("dense", fmt)]
    assert n == 100 and got["part"].n_padded == jA.shape[0]
    np.testing.assert_array_equal(_blocks_to_rows(got["A"], strategy), jA)
    np.testing.assert_array_equal(got["b"].reshape(-1), jb)
    np.testing.assert_array_equal(got["x0"].reshape(-1), jx0)
    assert got["same"].all()  # each rank's block is distribute_system's
    # Each rank asked the range parser for its own rows only (a .npy is a
    # memory map: no parse), and no rank parsed the whole matrix file.
    blk = got["part"].block_rows
    rows = [max(0, min(n, (r + 1) * blk) - r * blk) for r in range(P)]
    want = [r * n for r in rows] if fmt == "txt" else [0] * P
    assert got["tokens"].reshape(-1).tolist() == want
    assert not got["whole_matrix_parses"].any()
    ref = runs[1][P][("dense", fmt, strategy)]
    assert got["converged"] and bool(ref.converged)
    assert got["iterations"] == int(ref.iterations)
    assert scaled_err(got["x"], np.asarray(ref.x)) <= 1e-4


@pytest.mark.parametrize("P", WORLDS)
def test_well_load_equals_tpucgs_packs(runs, files, P):
    got, jws = runs[0][P]["well"], runs[1][P]["well"]
    assert (got["n"], got["npad"]) == (jws.n, jws.npad)
    for i, k in enumerate(PACKS):
        want = np.asarray(jws.op_arrays[i])
        assert got["packs"][k].shape == want.shape, k
        np.testing.assert_array_equal(got["packs"][k], want, err_msg=k)
    jgidl = np.asarray(jws.op_arrays[2])
    assert got["statics"]["block_sublanes"] == jgidl.shape[2]
    assert got["statics"]["n_sublanes"] == np.asarray(jws.op_arrays[0]).shape[1]
    for r in range(P):  # every rank holds the same summed diagonal
        np.testing.assert_array_equal(got["diag"][r], jws.diag)
    np.testing.assert_array_equal(got["b"].reshape(-1), np.asarray(jws.b))


@pytest.mark.parametrize("P", WORLDS)
def test_each_rank_reads_its_share_of_the_mtx(runs, files, P):
    got = runs[0][P]["well"]
    with np.load(mmio.mm_index_path(files["fem"])) as z:
        off = z["row_offsets"]
    rps, n = got["statics"]["rps"], got["n"]
    want = [int(off[min(n, (r + 1) * rps)] - off[min(n, r * rps)]) for r in range(P)]
    read = got["bytes_read"].reshape(-1).tolist()
    assert read == want and sum(read) == off[-1] - off[0] <= files["fem_bytes"]
    for b in read:  # about 1/P of the file each
        assert 0.5 / P < b / files["fem_bytes"] < 1.5 / P, read


@pytest.mark.parametrize("P", WORLDS)
def test_two_level_from_parts_on_the_mesh(runs, P):
    got, jws = runs[0][P]["well"], runs[1][P]["well"]
    acinv = got["acinv"]
    for r in range(1, P):  # the same bits on every rank
        np.testing.assert_array_equal(acinv[r], acinv[0])
        np.testing.assert_array_equal(got["dinv"][r], got["dinv"][0])
    want = np.asarray(jws.two_level.acinv)
    assert np.abs(acinv[0] - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got["dinv"][0], np.asarray(jws.two_level.dinv))


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("label", ["jacobi", "two_level", "two_level_pipelined"])
def test_well_solves_match_tpucgs(runs, P, label):
    got, ref = runs[0][P][("well", label)], runs[1][P][("well", label)]
    assert got["converged"] and bool(ref.converged)
    slack = 1 if label == "two_level_pipelined" else 0
    assert abs(got["iterations"] - int(ref.iterations)) <= slack, (got["iterations"],
                                                                    int(ref.iterations))
    bound = 1e-4 if label == "jacobi" else 5e-4
    assert scaled_err(got["x"], np.asarray(ref.x)) <= bound


def test_host_sum_and_max_over_the_ranks(runs):
    for P in WORLDS:
        got = runs[0][P]
        want = np.zeros(6)
        for r in range(P):
            want = want + np.arange(6, dtype=np.float64) * (r + 1) / 3.0
        for r in range(P):
            np.testing.assert_array_equal(got["host_sum"][r], want)
            assert got["host_max"][r].tolist() == [3 * (P - 1), 7]
