"""The bench's lap cap against tpucg's, on the CPU.

tpucg's ``bench`` caps every arm's solve at 4 n laps (``tpucg/cli.py:954``
serial, ``:975`` sharded); the port's arms read theirs from one place,
``cli._bench_solve_kw``. At a ``--tol`` that the system cannot reach
(1e-30 at n = 64), tpucg's ``bench --json`` reports 256 laps in every arm,
and the port's solves on the bench's own systems, made as its arms make
them, take the same 256.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import tpucg.cli as jcli
from tpucg_torch import cli
from tpucg_torch.comm.mesh import init_distributed, make_mesh
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.sharded import distribute_system, sharded_cg_solve

CPU = torch.device("cpu")
N = 64  # dense n, and m^3 for the Poisson arms (m = 4)
TOL = 1e-30  # its square is 0 in f32: no arm can converge
ARMS = [("dense", "serial"), ("dense", "allgather"), ("dense", "overlap"),
        ("poisson-free", "serial"), ("poisson-dia", "serial")]


def _size_argv(operator):
    return ["--n", str(N)] if operator == "dense" else ["--operator", operator, "--m", "4"]


@pytest.fixture(scope="module")
def tpucg_reports():
    """{(operator, strategy): report} of tpucg's ``bench --json`` on the CPU."""
    got = {}
    for operator in ("dense", "poisson-free", "poisson-dia"):
        argv = ["bench", "--tol", repr(TOL), "--json", "--repeats", "1"] + _size_argv(operator)
        if operator == "dense":
            argv.append("--compare-strategies")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert jcli.main(argv) == 0
        for line in out.getvalue().splitlines():
            rep = json.loads(line)
            got[(operator, rep["strategy"].split("/")[0])] = rep
    return got


@pytest.fixture(scope="module")
def one_rank():
    """This process as a world of one rank (gloo, an in-process store)."""
    init_distributed(backend="gloo", device="cpu")
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


def _port_solve(args, strategy, kw, mesh):
    """The arm's solve as ``cli._bench_one`` makes it, on the CPU."""
    if args.operator == "dense":
        A, b, x0 = generate_spd_system(args.n, seed=0)
        if strategy == "serial":
            return cg_solve(A, b, x0, device=CPU, fused=args.fused, **kw)
        system = distribute_system(A, b, x0, mesh, strategy=strategy)
        return sharded_cg_solve(system, mesh=mesh, strategy=strategy,
                                storage_dtype=torch.float32, **kw)
    op, b, _, _ = cli._poisson_system(args.operator, args.m, torch.float32, args.kernel, CPU)
    return cg_solve(op, torch.as_tensor(b), None, fused=args.fused, **kw)


@pytest.mark.parametrize("operator,strategy", ARMS, ids=[f"{o}-{s}" for o, s in ARMS])
def test_bench_caps_every_arm_at_4n_laps_as_tpucgs(operator, strategy, tpucg_reports,
                                                   one_rank):
    args = cli.build_parser().parse_args(
        ["bench", "--tol", repr(TOL), "--strategy", strategy] + _size_argv(operator))
    kw = cli._bench_solve_kw(args, N, args.tol)
    assert kw["maxiter"] == 4 * N and kw["tol"] == TOL
    theirs = tpucg_reports[(operator, strategy)]
    assert theirs["n"] == N and theirs["iterations"] == 4 * N
    res = _port_solve(args, strategy, kw, one_rank)
    assert int(res.iterations) == theirs["iterations"]
    assert not bool(res.converged)
    # Both run into the f32 floor the same way: tpucg's residual is NaN.
    assert np.isnan(theirs["residual_norm"]) == np.isnan(float(res.residual_norm))
