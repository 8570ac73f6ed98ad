"""The port's default device is the card, on the CPU with no card.

``device=None`` means the card. Where there is none, every entry point that
would otherwise pick the CPU by itself raises a ``RuntimeError`` naming
``device='cpu'``: the CPU runs only where the caller asks for it, as these
tests do everywhere else. Data that already lives on the CPU (a tensor or an
operator there) is such an asking. ``info`` is a report, not a solve, and
keeps reporting that there is no CUDA device.
"""

import json

import numpy as np
import pytest
import torch

from tpucg_torch import cli, dryrun
from tpucg_torch.comm.mesh import init_distributed, make_mesh
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.textio import save_array
from tpucg_torch.kernels import dispatch
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import DenseOperator
from tpucg_torch.solver.sharded import sharded_cg_solve

N = 64


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # init_distributed is a no-op in a world that exists: let it decide.
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)


@pytest.fixture(scope="module")
def system():
    return generate_spd_system(N, seed=0)


@pytest.fixture(scope="module")
def files(tmp_path_factory, system):
    A, b, _ = system
    d = tmp_path_factory.mktemp("system")
    np.save(d / "A.npy", A)
    save_array(str(d / "b.txt"), b, fmt="%r")
    return str(d / "A.npy"), str(d / "b.txt")


ENTRY_POINTS = {
    "canonical_device": lambda s, f: dispatch.canonical_device(None),
    "resolve_backend": lambda s, f: dispatch.resolve_backend("auto"),
    "cg_solve": lambda s, f: cg_solve(*s),
    "DenseOperator.create": lambda s, f: DenseOperator.create(s[0]),
    "init_distributed": lambda s, f: init_distributed(),
    "make_mesh": lambda s, f: make_mesh(),
    "sharded_cg_solve": lambda s, f: sharded_cg_solve(*s),
    "cli solve": lambda s, f: cli.main(["solve", *f]),
    "cli solve --strategy": lambda s, f: cli.main(["solve", *f, "--strategy", "allgather"]),
    "cli selftest": lambda s, f: cli.main(["selftest"]),
    "dryrun.entry": lambda s, f: dryrun.entry(),
    "dryrun_multichip": lambda s, f: dryrun.dryrun_multichip(2),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_no_card_raises_naming_the_cpu(name, no_card, system, files, capsys):
    with pytest.raises(RuntimeError, match="needs a card and there is none: pass device='cpu'"):
        ENTRY_POINTS[name](system, files)


def test_data_on_the_cpu_keeps_the_cpu(no_card, system):
    A, b, x0 = system
    res = cg_solve(torch.as_tensor(A), b, x0)
    want = cg_solve(A, b, x0, device="cpu")
    assert res.x.device.type == "cpu" and bool(res.converged)
    assert int(res.iterations) == int(want.iterations)
    assert torch.equal(res.x, want.x)
    op = DenseOperator.create(A, device="cpu")
    assert int(cg_solve(op, b, x0).iterations) == int(want.iterations)


def test_info_reports_no_card(no_card, capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["cuda_available"] is False and info["device"] == "cpu"
    assert info["kernel_backend"] == "torch"
