"""``python -m tpucg_torch solve A.mtx b.mtx`` against tpucg's CLI, both run
in-process on the CPU: the same operator class, laps within one and x
within 1e-4 of max |x|, with and without a reordering; the bench forms of
tpucg's sparse operators; the methods, block Jacobi and cached intervals
against tpucg's CLI; the options that later slices bring; the distributed
solve of an irregular ``.mtx`` (sharded WELL) and ``--checkpoint``, whose
files either package's CLI resumes."""

import os
import re

import numpy as np
import pytest
import torch

import tpucg.cli as jcli
from _torch_helpers import scaled_err
from tpucg_torch import cli
from tpucg_torch.io.generator import fem_p1_system, poisson3d_csr, random_geometric_spd
from tpucg_torch.io.mmio import save_matrix_market
from tpucg_torch.io.textio import load_vector


def _files(tmp_path, A, b):
    pa, pb = str(tmp_path / "A.mtx"), str(tmp_path / "b.mtx")
    save_matrix_market(pa, A, symmetric=True)
    save_matrix_market(pb, b)
    return pa, pb


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    fmt = re.search(r"system size\s+: \d+ x \d+\s+\[([^\]]+)\]", out).group(1)
    laps = int(re.search(r"iterations\s+: (\d+)", out).group(1))
    return rc, out, fmt, laps


SYSTEMS = {
    "fem": lambda: fem_p1_system(1500, seed=0)[:2],
    "geometric_shuffled": lambda: random_geometric_spd(1200, seed=3, avg_degree=8.0,
                                                       shuffle=True)[:2],
    "poisson": lambda: (poisson3d_csr(6), np.ones(216, np.float32)),
}


@pytest.mark.parametrize("order", [[], ["--rcm"], ["--strength-order"]])
@pytest.mark.parametrize("case,pc", [("fem", "jacobi"), ("geometric_shuffled", "none"),
                                     ("poisson", "none")])
def test_solve_mtx_matches_tpucgs_cli(tmp_path, capsys, case, pc, order):
    A, b = SYSTEMS[case]()
    pa, pb = _files(tmp_path, A, b)
    tol = str(1e-5 * float(np.linalg.norm(b)))
    common = ["solve", pa, pb, "--tol", tol, "--maxiter", "3000", "--precondition", pc] + order
    x_ours, x_theirs = str(tmp_path / "x.txt"), str(tmp_path / "jx.txt")
    rc, out, fmt, laps = _run(cli.main, common + ["--device", "cpu", "--output", x_ours], capsys)
    jrc, jout, jfmt_, jlaps = _run(jcli.main, common + ["--output", x_theirs], capsys)
    assert rc == jrc == 0, out + jout
    assert fmt == jfmt_
    if not order:
        assert fmt == ("DiaOperator" if case == "poisson" else "WellOperator")
    assert abs(laps - jlaps) <= 1
    n = A.shape[0]
    x, jx = load_vector(x_ours, n=n), load_vector(x_theirs, n=n)
    assert scaled_err(x, jx) <= 1e-4
    # x is in the file's numbering: its float64 residual is tpucg's. (FEM's
    # b ~ 1/n makes A x cancel: the f32 floor of ||b - A x|| / ||b|| lies
    # far above tol already at this size, and grows with n.)
    res = [np.linalg.norm(b - A.matvec(v.astype(np.float64))) for v in (x, jx)]
    assert res[0] <= 2 * res[1] + 1e-6 * np.linalg.norm(b)
    if case == "fem":
        assert res[1] > 5e-5 * np.linalg.norm(b)


def test_solve_mtx_bf16_and_dense_array_files(tmp_path, capsys):
    A, b = SYSTEMS["geometric_shuffled"]()
    pa, pb = _files(tmp_path, A, b)
    rc, out, fmt, _ = _run(cli.main, ["solve", pa, pb, "--device", "cpu", "--storage", "bf16",
                                      "--tol", str(1e-3 * float(np.linalg.norm(b))), "--rcm"],
                           capsys)
    assert rc == 0 and fmt == "WellOperator+rcm+bf16", out
    dense, rhs = str(tmp_path / "D.mtx"), str(tmp_path / "ones.npy")
    save_matrix_market(dense, poisson3d_csr(3).to_dense(), symmetric=True)
    np.save(rhs, np.ones(27, np.float32))
    rc, out, fmt, _ = _run(cli.main, ["solve", dense, rhs, "--device", "cpu"], capsys)
    assert rc == 0 and fmt == "dense", out


@pytest.mark.parametrize("flags,item", [
    (["--two-level", "64"], "M12"),
    (["--strategy", "allgather"], "M14"),
    (["--method", "minres"], "M12"),
    (["--method", "ca"], "M8"),
    (["--precondition", "block_jacobi"], "M8"),
    (["--pc-block-size", "32"], "M8"),
])
def test_later_slices_name_their_roadmap_item(tmp_path, capsys, flags, item):
    # M8's options (method, block Jacobi), M12's (two-level, MINRES) and M14
    # step 1's distributed solve of an irregular matrix (promoted to WELL,
    # handed to the ranks as its CSR and packed into row blocks of WELL) now
    # solve, as tpucg's CLI does (tpucg's on its 8 CPU devices, the port's
    # as a world of one rank).
    A, b = SYSTEMS["geometric_shuffled" if "--strategy" in flags else "poisson"]()
    pa, pb = _files(tmp_path, A, b)
    out = _held_to_tpucgs_cli(tmp_path, capsys, pa, pb, A, b, flags, laps=3)
    assert "--strategy" not in flags or (
        "[WellOperator]" in out and "strategy             : allgather" in out)


def _held_to_tpucgs_cli(tmp_path, capsys, pa, pb, A, b, flags, laps):
    """One solve through both CLIs at tol 1e-5 ||b||: rc 0, the same
    operator class, laps within ``laps`` (for CA: no more than ``laps``
    over tpucg's, since the port's Gram, summed in f64, refutes fewer of
    the tentative stops that tpucg's f32 Gram fires), x within 1e-4 of
    max |x|."""
    common = ["solve", pa, pb, "--tol", str(1e-5 * float(np.linalg.norm(b))),
              "--maxiter", "3000"] + flags
    x_ours, x_theirs = str(tmp_path / "x.txt"), str(tmp_path / "jx.txt")
    rc, out, fmt, k = _run(cli.main, common + ["--device", "cpu", "--output", x_ours], capsys)
    jrc, jout, jfmt_, jk = _run(jcli.main, common + ["--output", x_theirs], capsys)
    assert rc == jrc == 0, out + jout
    assert fmt == jfmt_
    assert (k - jk <= laps if "ca" in flags else abs(k - jk) <= laps), (k, jk)
    n = A.shape[0]
    assert scaled_err(load_vector(x_ours, n=n), load_vector(x_theirs, n=n)) <= 1e-4
    return out


@pytest.mark.parametrize("flags,laps", [
    (["--method", "pipelined", "--precondition", "jacobi"], 1),
    (["--method", "ca", "--s-step", "4"], 4),
    (["--method", "chebyshev", "--check-every", "4"], 4),
    (["--method", "chebyshev", "--interval", "0.3", "12.0"], 8),
    (["--method", "ca", "--interval", "0.3", "12.0"], 3),
    (["--precondition", "block_jacobi", "--pc-block-size", "36"], 1),
    (["--method", "pipelined", "--precondition", "block_jacobi"], 1),
])
def test_solve_methods_match_tpucgs_cli(tmp_path, capsys, flags, laps):
    # The Poisson m = 6 Laplacian (promoted to DIA; its spectrum lies in
    # [0.3, 12]).
    A, b = SYSTEMS["poisson"]()
    pa, pb = _files(tmp_path, A, b)
    out = _held_to_tpucgs_cli(tmp_path, capsys, pa, pb, A, b, flags, laps)
    assert "DiaOperator" in out


def test_solve_fem_block_jacobi_carries_the_blocks_to_well(tmp_path, capsys):
    # An irregular .mtx promoted to WELL: the promotion takes block Jacobi's
    # blocks from the CSR, as tpucg's does.
    A, b = SYSTEMS["fem"]()
    pa, pb = _files(tmp_path, A, b)
    out = _held_to_tpucgs_cli(tmp_path, capsys, pa, pb, A, b,
                              ["--precondition", "block_jacobi", "--pc-block-size", "32"], 1)
    assert "[WellOperator]" in out


def test_residual_history_needs_method_cg(tmp_path, capsys):
    A, b = SYSTEMS["poisson"]()
    pa, pb = _files(tmp_path, A, b)
    rc, out, _, _ = _run(cli.main, ["solve", pa, pb, "--device", "cpu", "--method", "ca",
                                    "--residual-history"], capsys)
    assert rc == 0 and "requires --method cg" in out and "||r_0||" not in out


def test_distributed_methods_name_m14(tmp_path, capsys):
    # The distributed pipelined, CA and Chebyshev methods and block Jacobi
    # (once refused, naming ROADMAP M14) solve on the mesh, a world of one
    # rank here: A = I, x = b.
    pa, pb, px = (str(tmp_path / f) for f in ("A.npy", "b.npy", "x.txt"))
    np.save(pa, np.eye(16, dtype=np.float32))
    np.save(pb, np.ones(16, np.float32))
    for flags in (["--method", "pipelined"], ["--precondition", "block_jacobi"],
                  ["--method", "ca", "--interval", "1", "2"],
                  ["--method", "chebyshev", "--interval", "0.9", "1.1"]):
        rc = cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "allgather",
                       "--output", px] + flags)
        out = capsys.readouterr().out
        assert rc == 0 and "converged            : True" in out, (flags, out)
        assert "strategy allgather" in out
        np.testing.assert_allclose(load_vector(px, n=16), 1.0, atol=1e-6)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case,flags,laps", [
    ("poisson", ["--method", "pipelined", "--precondition", "jacobi"], 1),
    ("poisson", ["--precondition", "block_jacobi", "--pc-block-size", "64"], 1),
    ("poisson", ["--method", "chebyshev", "--interval", "0.3", "12.0"], 8),
    ("poisson", ["--method", "ca", "--interval", "0.3", "12.0"], 3),
    ("geometric_shuffled", ["--method", "pipelined", "--precondition", "block_jacobi"], 1),
])
def test_solve_strategy_methods_match_tpucgs_cli(tmp_path, capsys, case, flags, laps):
    # The methods and block Jacobi on the mesh through both CLIs (tpucg's on
    # its 8 CPU devices, the port's as a world of one rank): the Poisson
    # .mtx as DIA row blocks with band halos, the irregular one as row
    # blocks of WELL. The blocks of 64 fall alike on both meshes (they
    # divide every rank's rows), and the interval is given, so neither
    # solve depends on its mesh's padding.
    A, b = SYSTEMS[case]()
    pa, pb = _files(tmp_path, A, b)
    out = _held_to_tpucgs_cli(tmp_path, capsys, pa, pb, A, b,
                              ["--strategy", "allgather"] + flags, laps)
    assert "strategy             : allgather" in out
    assert ("[DiaOperator]" if case == "poisson" else "[WellOperator]") in out


def test_bf16_refused_for_bsr():
    from tpucg_torch.solver.operators import BsrOperator

    op = BsrOperator(values=torch.zeros(1, 1, 8, 8), indices=torch.zeros(1, 1, dtype=torch.int32),
                     n=8)
    with pytest.raises(SystemExit, match="bf16"):
        cli._bf16_operator(op)


@pytest.mark.parametrize("route,kind", [("poisson-ell", "EllOperator"),
                                        ("poisson-bsr", "BsrOperator"),
                                        ("poisson-auto", "DiaOperator")])
def test_bench_operators_are_tpucgs_systems(route, kind):
    import argparse

    op, b, nnz, nbytes = cli._poisson_system(route, 6, torch.float32, "auto", "cpu")
    assert type(op).__name__ == kind and nnz == 7 * 216 - 6 * 36 and nbytes > 0
    args = argparse.Namespace(operator=route, m=6, n=0)
    _, jop, jb, _, _, jnnz = jcli._build_bench_system(args, "xla")
    np.testing.assert_array_equal(b, jb)
    assert jnnz == nnz
    with pytest.raises(SystemExit, match="bf16"):
        cli._poisson_system(route, 6, torch.bfloat16, "auto", "cpu")


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_solve_strategy_dense_equals_serial(tmp_path, capsys, strategy):
    # One rank: the distributed solve is the serial one, lap for lap and bit
    # for bit (n = 128, the same padding on both paths).
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.textio import save_array

    A, b, _ = generate_spd_system(128, seed=4)
    pa, pb = str(tmp_path / "A.txt"), str(tmp_path / "b.txt")
    save_array(pa, A, fmt="%r")
    save_array(pb, b, fmt="%r")
    outs = {}
    for how in ("serial", strategy):
        x = str(tmp_path / f"x_{how}.txt")
        assert cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", how,
                         "--precondition", "jacobi", "--output", x]) == 0
        out = capsys.readouterr().out
        outs[how] = (int(re.search(r"iterations\s+: (\d+)", out).group(1)),
                     load_vector(x, n=128), out)
    assert outs["serial"][0] == outs[strategy][0]
    np.testing.assert_array_equal(outs["serial"][1], outs[strategy][1])
    assert f"strategy {strategy}" in outs[strategy][2] and "rank 0 of 1" in outs[strategy][2]
    assert not torch.distributed.is_initialized()  # the command ended its world of one


@pytest.mark.parametrize("case,fmt", [("poisson", "DiaOperator")])
def test_solve_strategy_mtx_distributes_the_promoted_operator(tmp_path, capsys, case, fmt):
    A, b = SYSTEMS[case]()
    pa, pb = _files(tmp_path, A, b)
    tol = str(1e-5 * float(np.linalg.norm(b)))
    laps = {}
    for how in ("serial", "allgather"):
        rc, out, got_fmt, laps[how] = _run(
            cli.main, ["solve", pa, pb, "--device", "cpu", "--tol", tol, "--strategy", how,
                       "--fused", "never"], capsys)
        assert rc == 0 and got_fmt == fmt, out
    assert laps["serial"] == laps["allgather"]


def test_solve_strategy_summa_and_bench_without_card(tmp_path):
    # tpucg's --strategy has no 2-D arm (its SUMMA decomposition is reached
    # through the library's make_mesh2d): argparse refuses summa in both.
    A, b = SYSTEMS["poisson"]()
    pa, pb = _files(tmp_path, A, b)
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(["solve", pa, pb, "--strategy", "summa"])
        assert e.value.code == 2
    if not torch.cuda.is_available():
        assert cli.main(["bench", "--compare-strategies", "--n", "128"]) == 2
        assert cli.main(["bench", "--strategy", "overlap", "--n", "128"]) == 2


def test_selftest_runs_tpucgs_multi_rhs_check(capsys):
    # tpucg's selftest checks a k=2 multi-RHS solve (b and b/2) against the
    # oracle; the port's runs the same check through cg_solve_multi.
    rc = cli.main(["selftest", "--device", "cpu", "--n", "64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    line = next(ln for ln in out.splitlines() if "multi-RHS (k=2)" in ln)
    assert "[ok]" in line and "iters [" in line


# ---- M12: two-level and MINRES through the CLI ------------------------------


def _held_at(tmp_path, capsys, A, b, flags, rel_tol, laps=0):
    """``solve`` through both CLIs at tol ``rel_tol`` ||b||: rc 0, the same
    format tag, laps within ``laps``, x within 1e-4 of max |x|."""
    pa, pb = _files(tmp_path, A, b)
    common = ["solve", pa, pb, "--tol", repr(rel_tol * float(np.linalg.norm(b))),
              "--maxiter", "3000"] + flags
    x_ours, x_theirs = str(tmp_path / "x.txt"), str(tmp_path / "jx.txt")
    rc, out, fmt, k = _run(cli.main, common + ["--device", "cpu", "--output", x_ours], capsys)
    jrc, jout, jfmt_, jk = _run(jcli.main, common + ["--output", x_theirs], capsys)
    assert rc == jrc == 0, out + jout
    assert fmt == jfmt_
    assert abs(k - jk) <= laps, (k, jk)
    n = A.shape[0]
    assert scaled_err(load_vector(x_ours, n=n), load_vector(x_theirs, n=n)) <= 1e-4
    return fmt, k


@pytest.mark.parametrize("flags,tag,laps", [
    (["--two-level", "32"], "WellOperator+2lvl32", 0),
    (["--two-level", "32", "--smooth-degree", "2"], "WellOperator+2lvl32", 0),
    (["--two-level", "4", "--coarse-max", "64"], "WellOperator+2lvl4x2lv", 0),
    (["--two-level", "32", "--method", "pipelined"], "WellOperator+2lvl32", 1),
], ids=["jacobi_smoother", "chebyshev_smoother", "multilevel", "pipelined"])
def test_solve_two_level_matches_tpucgs_cli(tmp_path, capsys, flags, tag, laps):
    # The FEM 1.5k .mtx (WELL) at tol 1e-3 ||b||, above its f32 floor: the
    # format tags (+2lvl, x2lv for the multilevel hierarchy), the laps (a
    # multiple of 16 for classic PCG's true-residual checks) and x.
    A, b = SYSTEMS["fem"]()
    fmt, k = _held_at(tmp_path, capsys, A, b, flags, 1e-3, laps)
    assert fmt == tag
    assert "--method" in flags or k % 16 == 0


@pytest.mark.parametrize("pc", ["none", "jacobi", "block_jacobi"])
def test_solve_minres_matches_tpucgs_cli(tmp_path, capsys, pc):
    # Poisson m = 6 (DIA) at tol 1e-5 ||b||; 8-9 laps, where the phibar
    # trigger's rounding can move the stop by one (tpucg_torch's own MINRES
    # parity, laps equal, is in test_torch_minres.py).
    A, b = SYSTEMS["poisson"]()
    fmt, _ = _held_at(tmp_path, capsys, A, b, ["--method", "minres", "--precondition", pc,
                                               "--pc-block-size", "36"], 1e-5, laps=1)
    assert fmt == "DiaOperator"


def test_solve_minres_dense_text(tmp_path, capsys):
    # A dense system from the reference's text format: MINRES on the
    # DenseOperator (K1 on the card), the oracle's x.
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.textio import save_array
    from tpucg_torch.solver.oracle import oracle_cg

    A, b, x0 = generate_spd_system(64, seed=4)
    pa, pb, px = (str(tmp_path / f) for f in ("A.txt", "b.txt", "x.txt"))
    save_array(pa, A.ravel())
    save_array(pb, b)
    rc = cli.main(["solve", pa, pb, "--device", "cpu", "--method", "minres", "--output", px])
    out = capsys.readouterr().out
    assert rc == 0 and "converged            : True" in out, out
    np.testing.assert_allclose(load_vector(px, n=64), oracle_cg(A, b, x0)[0], atol=1e-4)


def test_m12_options_refused_where_tpucg_refuses_or_on_the_mesh(tmp_path, capsys):
    A, b = SYSTEMS["fem"]()
    pa, pb = _files(tmp_path, A, b)
    with pytest.raises(SystemExit, match="do not apply to --method minres"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--method", "minres",
                  "--two-level", "32"])
    # On the mesh (M14 step 5 brought --two-level and --method minres there,
    # steps 6 and 7 the checkpoint): --strategy summa is argparse's refusal,
    # as tpucg's; --checkpoint with --two-level runs the checkpointed
    # operator solve under the cycle, laps and x bit for bit the command
    # without --checkpoint; --checkpoint with --method minres is refused by
    # the checkpointed solve's config (an unknown method there), a
    # ValueError as in tpucg.
    ck = str(tmp_path / "ck.npz")
    tol = repr(1e-3 * float(np.linalg.norm(b)))
    for flags in (["--two-level", "32"], ["--method", "minres"]):
        with pytest.raises(SystemExit):
            cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "summa"] + flags)
    xs = [str(tmp_path / f"x{i}.txt") for i in range(2)]
    laps = []
    for extra, x in ((["--checkpoint", ck, "--segment-iters", "32"], xs[0]), ([], xs[1])):
        rc, out, _, k = _run(cli.main, ["solve", pa, pb, "--device", "cpu", "--strategy",
                                        "allgather", "--tol", tol, "--two-level", "32",
                                        "--output", x] + extra, capsys)
        assert rc == 0, out
        laps.append(k)
    assert laps[0] == laps[1]
    np.testing.assert_array_equal(load_vector(xs[0], n=A.shape[0]),
                                  load_vector(xs[1], n=A.shape[0]))
    with pytest.raises(ValueError, match="method"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "allgather",
                  "--checkpoint", ck, "--method", "minres"])
    assert not os.path.exists(ck) and not torch.distributed.is_initialized()
    dense, rhs = str(tmp_path / "D.npy"), str(tmp_path / "r.npy")
    np.save(dense, np.eye(8, dtype=np.float32))
    np.save(rhs, np.ones(8, np.float32))
    with pytest.raises(SystemExit, match="sparse .mtx"):
        cli.main(["solve", dense, rhs, "--device", "cpu", "--two-level", "4"])


# ---- M14 step 1 and M13 through the CLI --------------------------------------


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_solve_strategy_irregular_mtx_bf16(tmp_path, capsys, strategy):
    # --storage bf16 rides the sharded WELL solve as its storage dtype.
    A, b = SYSTEMS["geometric_shuffled"]()
    pa, pb = _files(tmp_path, A, b)
    tol = 1e-3 * float(np.linalg.norm(b))
    rc, out, fmt, k = _run(cli.main, ["solve", pa, pb, "--device", "cpu", "--strategy", strategy,
                                      "--storage", "bf16", "--tol", repr(tol)], capsys)
    assert rc == 0 and fmt == "WellOperator+bf16", out
    _, _, _, k_serial = _run(cli.main, ["solve", pa, pb, "--device", "cpu", "--storage", "bf16",
                                        "--tol", repr(tol)], capsys)
    assert k == k_serial


def _ck_argv(pa, pb, ck, *extra):
    return ["solve", pa, pb, "--precondition", "jacobi", "--checkpoint", ck,
            "--segment-iters", "16"] + list(extra)


@pytest.mark.parametrize("writer", ["port", "tpucg"])
def test_solve_mtx_checkpoint_resumes_across_clis(tmp_path, capsys, writer):
    # A capped run keeps its file (rc 3, "checkpoint retained"); the other
    # package's CLI resumes it to the end (rc 0) and removes it. The port's
    # resume of its own file equals its run through bit for bit.
    A, b = SYSTEMS["fem"]()
    pa, pb = _files(tmp_path, A, b)
    tol = ["--tol", repr(1e-5 * float(np.linalg.norm(b)))]
    ck, x_full, x_res = (str(tmp_path / f) for f in ("ck.npz", "full.txt", "res.txt"))
    first, then = ((cli.main, jcli.main) if writer == "port" else (jcli.main, cli.main))
    dev = lambda main: ["--device", "cpu"] if main is cli.main else []  # noqa: E731
    rc, out, fmt, k = _run(first, _ck_argv(pa, pb, ck, "--maxiter", "32", *tol, *dev(first)),
                           capsys)
    assert rc == 3 and k == 32 and fmt == "WellOperator", out
    assert "checkpoint retained  : " + ck in out and "checkpointed every 16 iters" in out
    assert os.path.exists(ck)
    rc, out, _, k_res = _run(then, _ck_argv(pa, pb, ck, *tol, *dev(then), "--output", x_res),
                             capsys)
    assert rc == 0 and not os.path.exists(ck), out
    rc, out, _, k_full = _run(cli.main, ["solve", pa, pb, "--precondition", "jacobi",
                                         "--device", "cpu", "--fused", "never", *tol,
                                         "--output", x_full], capsys)
    assert rc == 0 and abs(k_res - k_full) <= 1, (k_res, k_full)
    n = A.shape[0]
    assert scaled_err(load_vector(x_res, n=n), load_vector(x_full, n=n)) <= 1e-4


def test_solve_dense_checkpoint_resume_is_bit_identical(tmp_path, capsys):
    # tpucg's _cmd_solve_checkpointed on the reference's text format: killed
    # at 8 laps and resumed, the same laps and x as the run through; the
    # residual history is not recorded (tpucg's note).
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.textio import save_array

    n = 96
    A, b, _ = generate_spd_system(n, seed=4)
    A = (A - np.float32(n - n / 8.0) * np.eye(n, dtype=np.float32)).astype(np.float32)
    pa, pb = str(tmp_path / "A.txt"), str(tmp_path / "b.txt")
    save_array(pa, A.ravel(), fmt="%r")
    save_array(pb, b, fmt="%r")
    ck, xa, xb = (str(tmp_path / f) for f in ("ck.npz", "xa.txt", "xb.txt"))
    base = ["solve", pa, pb, "--device", "cpu", "--checkpoint", ck, "--segment-iters", "4"]
    assert cli.main(base + ["--output", xa]) == 0 and not os.path.exists(ck)
    out = capsys.readouterr().out
    k_full = int(re.search(r"iterations\s+: (\d+)", out).group(1))
    assert k_full > 8 and "checkpointed every 4 iters" in out
    assert cli.main(base + ["--maxiter", "8", "--residual-history"]) == 3
    out = capsys.readouterr().out
    assert "not recorded by checkpointed solves" in out and "||r_0||" not in out
    assert "checkpoint retained" in out and os.path.exists(ck)
    assert cli.main(base + ["--output", xb]) == 0 and not os.path.exists(ck)
    out = capsys.readouterr().out
    assert int(re.search(r"iterations\s+: (\d+)", out).group(1)) == k_full
    np.testing.assert_array_equal(load_vector(xa, n=n), load_vector(xb, n=n))


def test_checkpoint_refusals(tmp_path, capsys):
    A, b = SYSTEMS["geometric_shuffled"]()
    pa, pb = _files(tmp_path, A, b)
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(SystemExit, match="--interval"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--checkpoint", ck, "--method",
                  "chebyshev", "--interval", "0.1", "10"])
    with pytest.raises(SystemExit, match="bf16"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--checkpoint", ck, "--strategy",
                  "allgather", "--storage", "bf16"])
    # --checkpoint with --strategy runs on the mesh (a world of one rank
    # here): the sharded WELL solve in segments equals the one without
    # them, laps and x bit for bit, and removes its file.
    xs = [str(tmp_path / f"x{i}.txt") for i in range(2)]
    laps = []
    for extra, x in ((["--checkpoint", ck, "--segment-iters", "16"], xs[0]), ([], xs[1])):
        rc, out, fmt, k = _run(cli.main, ["solve", pa, pb, "--device", "cpu", "--strategy",
                                          "allgather", "--output", x] + extra, capsys)
        assert rc == 0 and fmt == "WellOperator", out
        laps.append(k)
    assert "checkpointed every 16 iters" not in out and laps[0] == laps[1]
    np.testing.assert_array_equal(load_vector(xs[0], n=A.shape[0]),
                                  load_vector(xs[1], n=A.shape[0]))
    dense, rhs = str(tmp_path / "D.npy"), str(tmp_path / "r.npy")
    np.save(dense, np.eye(8, dtype=np.float32))
    np.save(rhs, np.ones(8, np.float32))
    assert cli.main(["solve", dense, rhs, "--device", "cpu", "--checkpoint", ck, "--strategy",
                     "overlap", "--output", xs[0]]) == 0
    np.testing.assert_array_equal(load_vector(xs[0], n=8), np.ones(8, np.float32))
    with pytest.raises(ValueError, match="method='cg'"):
        cli.main(["solve", dense, rhs, "--device", "cpu", "--checkpoint", ck, "--method",
                  "pipelined"])
    assert not os.path.exists(ck) and not torch.distributed.is_initialized()


# ---- M14 steps 4 and 5 through the CLI ----------------------------------------


def _solve_out(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out
    return rc, out, int(re.search(r"iterations\s+: (\d+)", out).group(1))


@pytest.mark.parametrize("fmt", ["txt", "npy"])
@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_solve_strategy_text_loads_host_sharded(tmp_path, capsys, monkeypatch, fmt, strategy):
    # tpucg's cli.py:575-600: the sharded dense path loads through
    # load_system_sharded (the rank parses its own rows: the range parser is
    # asked for n^2 tokens on one rank), never the whole-system loader; the
    # solve equals the serial one (one rank, the same padding) and tpucg's
    # CLI's (its 8 CPU devices).
    from tpucg_torch.io import _native, textio
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.textio import save_array
    from tpucg_torch.solver import sharded

    n = 128
    A, b, _ = generate_spd_system(n, seed=4)
    pa, pb = str(tmp_path / f"A.{fmt}"), str(tmp_path / "b.txt")
    save_array(pa, A, fmt="%r") if fmt == "txt" else np.save(pa, A)
    save_array(pb, b, fmt="%r")
    x_serial, x_mesh, x_j = (str(tmp_path / f) for f in ("xs.txt", "xm.txt", "xj.txt"))
    common = ["solve", pa, pb, "--precondition", "jacobi"]
    rc, _, k_serial = _solve_out(common + ["--device", "cpu", "--output", x_serial], capsys)
    loads, asked = [], []
    real_load, real_range = sharded.load_system_sharded, _native.parse_floats_range

    def load(*a, **kw):
        loads.append(a[0])
        return real_load(*a, **kw)

    def ranged(path, start, count):
        asked.append(count)
        return real_range(path, start, count)

    def whole(*a, **kw):
        raise AssertionError("the sharded path loaded the whole system")
    monkeypatch.setattr(sharded, "load_system_sharded", load)
    monkeypatch.setattr(_native, "parse_floats_range", ranged)
    monkeypatch.setattr(textio, "load_system", whole)
    rc2, out, k_mesh = _solve_out(common + ["--device", "cpu", "--strategy", strategy,
                                            "--output", x_mesh], capsys)
    assert rc == rc2 == 0 and loads == [pa], out
    assert sum(asked) == (n * n if fmt == "txt" else 0)
    assert k_mesh == k_serial
    np.testing.assert_array_equal(load_vector(x_mesh, n=n), load_vector(x_serial, n=n))
    monkeypatch.undo()
    jrc = jcli.main(common + ["--strategy", strategy, "--output", x_j])
    jout = capsys.readouterr().out
    assert jrc == 0 and int(re.search(r"iterations\s+: (\d+)", jout).group(1)) == k_mesh
    assert scaled_err(load_vector(x_mesh, n=n), load_vector(x_j, n=n)) <= 1e-4
    assert not torch.distributed.is_initialized()


def test_solve_strategy_text_refusals(tmp_path):
    # tpucg's refusals on the host-sharded route (cli.py:582-587, 593-596).
    pa, pb = str(tmp_path / "A.npy"), str(tmp_path / "b.npy")
    np.save(pa, np.eye(16, dtype=np.float32))
    np.save(pb, np.ones(16, np.float32))
    with pytest.raises(SystemExit, match="host-sharded loading"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "allgather",
                  "--storage", "bf16"])
    with pytest.raises(ValueError, match="--n 15 does not match the 16 values"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "overlap", "--n", "15"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flags", [["--two-level", "32"],
                                   ["--two-level", "32", "--method", "pipelined"],
                                   ["--two-level", "16", "--coarse-max", "64"],
                                   ["--method", "minres", "--precondition", "jacobi"]],
                         ids=["two_level", "two_level_pipelined", "multilevel", "minres"])
def test_solve_strategy_takes_m12_options(tmp_path, capsys, flags):
    # tpucg's cli.py:374-400: --two-level (the WELL decomposition's
    # padding) and --method minres on the mesh. One rank pads as the serial
    # operator does, so the distributed solve is the serial one bit for bit;
    # tpucg's CLI on its 8 devices converges too, x within 1e-3 of max |x|
    # (its padding, hence its coarse tail, is another).
    A, b = SYSTEMS["geometric_shuffled"]()
    pa, pb = _files(tmp_path, A, b)
    n = A.shape[0]
    common = ["solve", pa, pb, "--tol", str(1e-5 * float(np.linalg.norm(b))), "--maxiter",
              "3000", "--rcm"] + flags
    xs, xm, xj = (str(tmp_path / f) for f in ("xs.txt", "xm.txt", "xj.txt"))
    rc, out_s, fmt_s, k_s = _run(cli.main, common + ["--device", "cpu", "--output", xs], capsys)
    rc2, out_m, fmt_m, k_m = _run(cli.main, common + ["--device", "cpu", "--strategy",
                                                      "allgather", "--output", xm], capsys)
    assert rc == rc2 == 0 and fmt_s == fmt_m and "WellOperator+rcm" in fmt_m, out_m
    assert ("+2lvl" in fmt_m) == ("--two-level" in flags)
    assert k_s == k_m and "strategy             : allgather" in out_m
    np.testing.assert_array_equal(load_vector(xm, n=n), load_vector(xs, n=n))
    jrc, jout, jfmt_, _ = _run(jcli.main, common + ["--strategy", "allgather", "--output", xj],
                               capsys)
    assert jrc == 0 and jfmt_ == fmt_m, jout
    assert scaled_err(load_vector(xm, n=n), load_vector(xj, n=n)) <= 1e-3
    assert not torch.distributed.is_initialized()


def test_solve_strategy_minres_dense_and_two_level_refusal(tmp_path, capsys):
    # --method minres on a dense text system with --strategy: tpucg's CLI
    # loads A whole there (cli.py:560-572); one rank equals the serial solve.
    # --two-level with --strategy on a format other than WELL or DIA is
    # tpucg's SystemExit.
    from tpucg_torch.io.textio import save_array
    from _torch_helpers import sym_indefinite

    A = sym_indefinite(128, seed=2)
    b = np.random.default_rng(3).standard_normal(128).astype(np.float32)
    pa, pb = str(tmp_path / "A.txt"), str(tmp_path / "b.txt")
    save_array(pa, A, fmt="%r")
    save_array(pb, b, fmt="%r")
    outs = {}
    for how in ("serial", "overlap"):
        x = str(tmp_path / f"x_{how}.txt")
        rc, out, k = _solve_out(["solve", pa, pb, "--device", "cpu", "--method", "minres",
                                 "--tol", "1e-4", "--strategy", how, "--output", x], capsys)
        assert rc == 0, out
        outs[how] = (k, load_vector(x, n=128))
    assert outs["serial"][0] == outs["overlap"][0]
    np.testing.assert_array_equal(outs["serial"][1], outs["overlap"][1])
    # Dense 8 x 8 blocks at block offsets 0, +-5, +-11 (75 diagonals: no
    # DIA; full tiles: BSR).
    from tpucg_torch.sparse.formats import COOMatrix

    nb = 32
    bi, bj = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    keep = np.isin(bj - bi, (0, 5, -5, 11, -11))
    bi, bj = bi[keep], bj[keep]
    ii = (bi[:, None, None] * 8 + np.arange(8)[None, :, None]) + 0 * np.arange(8)[None, None]
    jj = (bj[:, None, None] * 8 + np.arange(8)[None, None, :]) + 0 * np.arange(8)[None, :, None]
    ii, jj = ii.ravel(), jj.ravel()
    coo = COOMatrix(row=ii, col=jj, data=np.where(ii == jj, 64.0, -0.1).astype(np.float32),
                    shape=(8 * nb, 8 * nb))
    pa2, pb2 = _files(tmp_path, coo, np.ones(8 * nb, np.float32))
    rc, out, fmt, _ = _run(cli.main, ["solve", pa2, pb2, "--device", "cpu"], capsys)
    assert rc == 0 and fmt == "BsrOperator", out
    with pytest.raises(SystemExit, match="WELL/DIA decompositions"):
        cli.main(["solve", pa2, pb2, "--device", "cpu", "--strategy", "allgather",
                  "--two-level", "8"])
    assert not torch.distributed.is_initialized()
