"""The comparison that decides ``correct`` is shown to fail.

1. The control (the nearest precision below the configuration's) in the
   program's place comes out not correct, at a size a CPU test holds; on the
   card ``cgbench/control.py`` reads it at the cells' own sizes.
2. A run driven on the CPU, past the harness's look for a card, with the
   timed path broken underneath, comes out not correct, once for each fault
   a cell can have: a solve that returns its state unchanged, half of the
   batch left out, an answer altered where it is produced, and a call that
   reports it did not converge. (The exchange between chips has no fault
   here: every cell runs on one card.)
"""

import time

import pytest
import torch

from cgbench import harness, spec
from cgbench.solvers import Program, ReferenceControl, control_for
from cgbench.tests._small import small_config

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cell, solver_of=None, seconds=0.05, device="cpu", config=None):
    _, cfg, wl = spec.load_cell(BENCH, cell)
    cfg = small_config(cfg) if config is None else config
    wl = dict(wl, sample_calls=4)
    solver = None if solver_of is None else solver_of(cfg, wl, device)
    return harness.execute(cell, 2**31 + 77, seconds, False, device, time.time(), bench=BENCH,
                           config=cfg, workload=wl, solver=solver)


class Faulty(Program):
    """The program with one fault planted where its answer is produced."""

    fault = None

    def call(self, B, tol):
        X, laps, conv = super().call(B, tol)
        n, k = X.shape
        if self.fault == "unchanged":       # the solve returns x0, claims success
            X = torch.zeros_like(X)
        elif self.fault == "half_left_out":  # half of the batch never solved
            if k > 1:
                X[:, k // 2:] = 0
            else:
                X[n // 2:] = 0
        elif self.fault == "altered":       # one value of x wrong
            lim = self.workload["limits"]["x_err"]
            i = int(X[:, 0].abs().argmax())
            X[i, 0] += 10 * lim * float(X[:, 0].norm())
        elif self.fault == "unconverged":   # one call says it did not converge
            conv = conv.clone()
            conv[0] = False
        return X, laps, conv


def _faulty(fault):
    def make(cfg, wl, device):
        f = Faulty(cfg, wl, device)
        f.fault = fault
        return f
    return make


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_at_small_size(cell):
    rec = _run(cell)
    assert rec["correct"], rec["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered", "unconverged"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_fails(cell, fault):
    rec = _run(cell, _faulty(fault))
    assert not rec["correct"], (fault, rec["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    """TF32 in the reference for the dense cells, the program's bf16 WELL
    storage for the FEM ones."""
    _, cfg, wl = spec.load_cell(BENCH, cell)
    kind = type(control_for(cfg, wl, "cpu"))
    assert kind is (ReferenceControl if cfg.get("tf32") is False else Program)
    rec = _run(cell, control_for)
    assert not rec["correct"], rec["checks"]
    assert rec["checks"]["x_err"]["value"] > rec["checks"]["x_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell, card):
    """At the cell's own size, on the card (a short window)."""
    _, cfg, _ = spec.load_cell(BENCH, cell)
    rec = _run(cell, control_for, seconds=1.0, device=card, config=cfg)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_on_the_card(cell, card):
    _, cfg, _ = spec.load_cell(BENCH, cell)
    rec = _run(cell, seconds=1.0, device=card, config=cfg)
    assert rec["correct"], rec["checks"]
