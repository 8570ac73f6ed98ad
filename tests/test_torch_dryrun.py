"""The port's dry-run entry points (``tpucg_torch/dryrun.py``) against
tpucg's (``__graft_entry__.py``) on the CPU: ``entry()`` takes the laps of
tpucg's jitted ``entry()`` and x within 1e-5 of max |x|; ``dryrun_multichip``
runs tpucg's battery on a gloo world of 4 CPU ranks and passes; a case that
misses its oracle fails the world with its label."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import raising_worker, scaled_err
from tpucg_torch import dryrun
from tpucg_torch.solver.cg import CGResult

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_entry_matches_tpucgs():
    fn, args = dryrun.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.float32 for a in args)
    x, k, rnorm = fn(*args)
    jfn, jargs = graft.entry()
    jx, jk, jrnorm = jax.jit(jfn)(*jargs)
    assert x.shape == args[1].shape
    assert int(k) == int(jk) >= 1
    assert float(rnorm) < 1e-5 and float(jrnorm) < 1e-5
    assert scaled_err(x.numpy(), np.asarray(jx)) <= 1e-5
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))


def test_dryrun_multichip_4_on_a_cpu_world():
    line = dryrun.dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK: 4 ranks on cpu (gloo)")


def test_a_case_off_its_oracle_fails_with_its_label(tmp_path):
    x_ref = np.linspace(1.0, 2.0, 16, dtype=np.float32)
    good = CGResult(x=torch.as_tensor(x_ref), iterations=torch.tensor(5),
                    residual_norm=torch.tensor(1e-7), converged=torch.tensor(True))
    dryrun._check_parity(good, x_ref, 5, "case")
    for bad in (good._replace(x=good.x * 1.001), good._replace(iterations=torch.tensor(7)),
                good._replace(converged=torch.tensor(False)), good._replace(x=good.x[:8])):
        with pytest.raises(AssertionError, match="well-sharded"):
            dryrun._check_parity(bad, x_ref, 5, "well-sharded")
    # A rank's failed check fails the world and the call, with its label.
    with pytest.raises(Exception, match="dia-sharded-bf16"):
        dryrun.spawn_world(2, raising_worker, args=("dia-sharded-bf16",),
                           rendezvous=str(tmp_path / "rv"), timeout_s=120)
