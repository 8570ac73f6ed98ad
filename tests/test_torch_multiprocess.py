"""tpucg's multi-process tests (``tests/test_multiprocess.py``) on the port:
worlds of gloo ranks on the CPU, one OS process a rank, as tpucg runs one
JAX process a host (ROADMAP M14 step 8).

The dense battery runs once on a world of 2 ranks with tpucg's input (n =
72, seed 8, the reference's text format): each rank parses only its own
rows (``load_system_sharded``), solves under both strategies, caps and
resumes the checkpoint through its own file (``<path>.proc<rank>``), and
runs Chebyshev, block CG and block Jacobi
(``_torch_helpers.mp_dense_worker``). The operator battery runs on worlds
of 2 and 4 ranks with tpucg's wide inputs (Poisson m = 8 slabs and their
DIA form, sharded WELL with the two-level cycle, the indexed ``.mtx`` read
host-sharded; ``mp_operator_worker``). Every input is made by tpucg's
generators and every result is held to tpucg's oracle on the same arrays.
Each world is spawned once for the module; the tests assert what tpucg's
assert, on the files the ranks write.
"""

import json
import os

import numpy as np
import pytest

import tpucg
from _torch_helpers import mp_dense_worker, mp_operator_worker, run_world
from tpucg.solver.oracle import oracle_cg
from tpucg_torch.io.partitioner import RowPartition

NPROC = 2


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    """Run the 2-rank battery once; tests assert on its files."""
    from tpucg.io.textio import save_array

    workdir = str(tmp_path_factory.mktemp("mp"))
    n = 72  # not divisible by 8 ranks' rows: pad rows live on the last rank
    A, b, x0 = tpucg.generate_spd_system(n, seed=8)
    save_array(os.path.join(workdir, "A.txt"), A, fmt="%r")
    save_array(os.path.join(workdir, "b.txt"), b, fmt="%r")
    save_array(os.path.join(workdir, "x0.txt"), x0, fmt="%r")
    assert run_world(NPROC, mp_dense_worker, args=(workdir,),
                     rendezvous=os.path.join(workdir, "rv"), timeout_s=420)
    return workdir, (A, b, x0, n)


def _meta(workdir, name):
    with open(os.path.join(workdir, name)) as f:
        return json.load(f)


def test_multiprocess_solve_matches_oracle(mp_run):
    workdir, (A, b, x0, n) = mp_run
    ox, oiters, _ = oracle_cg(A, b, x0)
    for strategy in ("allgather", "overlap"):
        x = np.load(os.path.join(workdir, f"x_{strategy}.npy"))
        meta = _meta(workdir, f"meta_{strategy}.json")
        assert meta["converged"], strategy
        assert abs(meta["iterations"] - oiters) <= 1, strategy
        assert x.shape == (n,)
        np.testing.assert_allclose(x, ox, rtol=1e-4, atol=1e-5)


def test_multiprocess_checkpoint_resume(mp_run):
    """A capped checkpointed solve resumed across the same 2-rank world:
    per-rank row-block files, the torn-write guard, and a resumed
    trajectory bit-identical to the uninterrupted solve."""
    workdir, (A, b, x0, n) = mp_run
    ox, oiters, _ = oracle_cg(A, b, x0)
    x_ck = np.load(os.path.join(workdir, "x_ckpt.npy"))
    x_plain = np.load(os.path.join(workdir, "x_ckpt_plain.npy"))
    meta = _meta(workdir, "meta_ckpt.json")
    assert meta["converged"]
    assert meta["iterations"] == meta["plain_iterations"]
    assert abs(meta["iterations"] - oiters) <= 1
    np.testing.assert_array_equal(x_ck, x_plain)
    np.testing.assert_allclose(x_ck, ox, rtol=1e-4, atol=1e-5)


def test_multiprocess_round2_arms(mp_run):
    """Chebyshev, true block CG and block Jacobi across the 2-rank world."""
    workdir, (A, b, x0, n) = mp_run
    meta = _meta(workdir, "meta_arms.json")
    assert meta["cheb_converged"] and meta["block_converged"]
    ox, _, _ = oracle_cg(A, b, x0)
    np.testing.assert_allclose(np.load(os.path.join(workdir, "x_cheb.npy")), ox, rtol=1e-3,
                               atol=1e-4)
    x_blk = np.load(os.path.join(workdir, "x_block.npy"))
    Bk = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    assert x_blk.shape == (n, 3)
    for j in range(3):
        xj, _, _ = oracle_cg(A, Bk[:, j], np.zeros(n, np.float32))
        np.testing.assert_allclose(x_blk[:, j], xj, rtol=1e-4, atol=1e-5)
    assert meta["bj_converged"]
    np.testing.assert_allclose(np.load(os.path.join(workdir, "x_bj.npy")), ox, rtol=1e-3,
                               atol=1e-4)


def test_multiprocess_loading_is_host_sharded(mp_run):
    """Each rank's file reads cover exactly its own rows: no rank reads all
    of A."""
    workdir, (_, _, _, n) = mp_run
    blk = RowPartition(n=n, num_shards=NPROC, align=8).block_rows
    all_reads = []
    for rank in range(NPROC):
        reads = _meta(workdir, f"reads_{rank}.json")
        assert reads, f"rank {rank} read nothing"
        assert min(r0 for r0, _ in reads) >= rank * blk
        assert max(r1 for _, r1 in reads) <= (rank + 1) * blk, (rank, reads)
        all_reads += reads
    covered = set()
    for r0, r1 in all_reads:
        covered.update(range(r0, r1))
    assert covered == set(range(n)), "every logical row read"


@pytest.fixture(scope="module", params=[2, 4], ids=["p2", "p4"])
def mp_run_wide(request, tmp_path_factory):
    from tpucg.io.generator import poisson3d_dia, random_geometric_spd
    from tpucg.io.mmio import expand_matrix_market

    nproc = request.param
    workdir = str(tmp_path_factory.mktemp(f"mp{nproc}"))
    Am, bm, _ = random_geometric_spd(2048, seed=9, avg_degree=8.0)
    sym = os.path.join(workdir, "G_sym.mtx")
    tpucg.save_matrix_market(sym, Am.to_coo(), symmetric=True)
    expand_matrix_market(sym, os.path.join(workdir, "G.mtx"))
    np.save(os.path.join(workdir, "gb.npy"), bm)
    m = 8
    dia = poisson3d_dia(m)
    Aw, bw, _ = random_geometric_spd(1024, seed=5, avg_degree=8.0)
    np.savez(os.path.join(workdir, "ops.npz"), m=m, dia_offsets=np.asarray(dia.offsets),
             dia_data=np.asarray(dia.data), w_indptr=Aw.indptr, w_indices=Aw.indices,
             w_data=Aw.data, w_shape=np.asarray(Aw.shape), w_b=bw)
    assert run_world(nproc, mp_operator_worker, args=(workdir,),
                     rendezvous=os.path.join(workdir, "rv"), timeout_s=420)
    return workdir, nproc


def test_multiprocess_wide_operator_arms(mp_run_wide):
    """Slab-halo Poisson and band-halo DIA across the ranks match the
    oracle on the assembled system; WELL with two-level too."""
    from tpucg.io.generator import random_geometric_spd

    workdir, nproc = mp_run_wide
    m = 8
    n = m ** 3
    A = np.asarray(tpucg.poisson3d_csr(m).to_dense(), np.float32)
    b = np.ones(n, np.float32)
    tol = 1.0e-5 * float(np.linalg.norm(b))
    ox, oiters, _ = oracle_cg(A, b, np.zeros(n, np.float32), tol=tol)
    meta = _meta(workdir, "meta_op.json")
    assert meta["nproc"] == nproc
    for arm in ("poisson", "dia"):
        assert meta[f"{arm}_converged"], arm
        assert abs(meta[f"{arm}_iterations"] - oiters) <= 1, arm
        x = np.load(os.path.join(workdir, f"x_op_{arm}.npy"))[:n]
        np.testing.assert_allclose(x, ox, rtol=1e-4, atol=1e-5, err_msg=arm)
    Aw, bw, _ = random_geometric_spd(1024, seed=5, avg_degree=8.0)
    tol_w = 1e-5 * float(np.linalg.norm(bw))
    oxw, oiw, _ = oracle_cg(np.asarray(Aw.to_dense(), np.float32), bw,
                            np.zeros(1024, np.float32), tol=tol_w)
    assert meta["well2l_converged"]
    xw = np.load(os.path.join(workdir, "x_op_well2l.npy"))[:1024]
    np.testing.assert_allclose(xw, oxw, rtol=2e-3, atol=2e-4)
    # Two-level laps quantize to the 16-lap true-residual check.
    assert meta["well2l_iterations"] <= oiw + 16


def test_multiprocess_mtx_loading_is_host_sharded(mp_run_wide):
    """Every rank's matrix bytes read is about its own share of the indexed
    ``.mtx``, and the host-sharded solve matches the oracle."""
    from tpucg.io.generator import random_geometric_spd

    workdir, nproc = mp_run_wide
    meta = _meta(workdir, "meta_op.json")
    n = meta["mtx_n"]
    assert meta["mtx_converged"]
    Am, bm, _ = random_geometric_spd(2048, seed=9, avg_degree=8.0)
    tol = 1e-5 * float(np.linalg.norm(bm))
    ox, _, _ = oracle_cg(np.asarray(Am.to_dense(), np.float32), bm, np.zeros(n, np.float32),
                         tol=tol)
    x = np.load(os.path.join(workdir, "x_op_mtx.npy"))[:n]
    np.testing.assert_allclose(x, ox, rtol=2e-3, atol=2e-4)
    data_bytes = os.path.getsize(os.path.join(workdir, "G.mtx"))
    per = [_meta(workdir, f"mtx_bytes_{rank}.json")["bytes_read"] for rank in range(nproc)]
    assert all(b > 0 for b in per)
    assert sum(per) <= data_bytes
    share = data_bytes / nproc
    for rank, br in enumerate(per):
        assert br <= 1.6 * share, (rank, br, share)
