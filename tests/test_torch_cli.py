"""``python -m tpucg_torch solve A.mtx b.mtx`` against tpucg's CLI, both run
in-process on the CPU: the same operator class, laps within one and x
within 1e-4 of max |x|, with and without a reordering; the bench forms of
tpucg's sparse operators; the methods, block Jacobi and cached intervals
against tpucg's CLI; the options that later slices bring."""

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
    # M8's options (method, block Jacobi) now solve, as tpucg's CLI does. A
    # distributed solve of an irregular matrix (promoted to WELL) is still
    # refused: it needs the WELL shard packers.
    A, b = SYSTEMS["geometric_shuffled" if "--strategy" in flags else "poisson"]()
    pa, pb = _files(tmp_path, A, b)
    if item == "M8":
        _held_to_tpucgs_cli(tmp_path, capsys, pa, pb, A, b, flags, laps=3)
        return
    with pytest.raises(NotImplementedError, match=item) as err:
        cli.main(["solve", pa, pb, "--device", "cpu"] + flags)
    assert "--strategy" not in flags or "shard packers" in str(err.value)


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


def test_distributed_methods_name_m14(tmp_path):
    pa, pb = str(tmp_path / "A.npy"), str(tmp_path / "b.npy")
    np.save(pa, np.eye(16, dtype=np.float32))
    np.save(pb, np.ones(16, np.float32))
    for flags in (["--method", "pipelined"], ["--precondition", "block_jacobi"],
                  ["--method", "ca", "--interval", "1", "2"]):
        with pytest.raises(NotImplementedError, match="M14"):
            cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "allgather"] + flags)


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
    A, b = SYSTEMS["poisson"]()
    pa, pb = _files(tmp_path, A, b)
    with pytest.raises(NotImplementedError, match="SUMMA"):
        cli.main(["solve", pa, pb, "--device", "cpu", "--strategy", "summa"])
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
