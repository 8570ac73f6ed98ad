"""tpucg_torch's mixed-precision iterative refinement (``cg_solve_ir``)
against tpucg on the CPU: the serial cases of tpucg's ``tests/test_ir.py``,
on the same NumPy inputs.

Each round's inner solve is the port's ``cg_loop`` on the bf16 operator
(the plain K1 with bf16 A, K3, K2), each round's true residual the f32
product. Tolerances: the true f32 residual under tpucg's bound (1.2e-6 at
tol 1e-6, tpucg's margin for f32 evaluation noise); rounds' total inner
laps within 2 of tpucg's (the bf16 inner solves round apart: XLA fuses
each axpy into an FMA, torch does not); x within tpucg's own tolerance of
its f32 solve (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import scaled_err
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.kernels.blas1 import fused_update_torch
from tpucg_torch.kernels.matvec import matvec_torch
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.ir import cg_solve_ir, ir_loop
from tpucg_torch.solver.operators import DenseOperator

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def system():
    A, b, x0 = generate_spd_system(128, seed=5)
    return A, b, x0, tpucg.cg_solve_ir(A, b, x0)


def test_ir_meets_f32_contract(system):
    A, b, x0, ref = system
    res = cg_solve_ir(A, b, x0, device=CPU)
    assert bool(res.converged) and bool(ref.converged)
    assert np.linalg.norm(b - A @ res.x.numpy()) < 1.2e-6
    plain = cg_solve(A, b, x0, device=CPU)
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), rtol=1e-4, atol=1e-6)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    assert float(res.residual_norm) < 1e-6
    assert res.x.shape == (128,) and res.iterations.dim() == 0
    assert scaled_err(res.x.numpy(), np.asarray(ref.x)) <= 1e-4


def test_ir_beats_raw_bf16_accuracy(system):
    A, b, x0, _ = system
    op16 = DenseOperator.create(A, dtype=torch.bfloat16, device=CPU)
    raw = cg_solve(op16, b, x0, tol=1e-6, maxiter=4 * A.shape[0])
    raw_true = np.linalg.norm(b - A @ raw.x.numpy())
    ir_true = np.linalg.norm(b - A @ cg_solve_ir(A, b, x0, device=CPU).x.numpy())
    assert ir_true < 1.2e-6 < raw_true


def test_ir_iteration_accounting(system):
    A, b, x0, _ = system
    res = cg_solve_ir(A, b, x0, device=CPU)
    assert 2 <= int(res.iterations) <= 64


def test_ir_runs_the_bf16_and_f32_products(monkeypatch):
    # Inner laps multiply by the bf16 A and update x and r with the plain
    # K2; each round's true residual multiplies by the f32 A.
    import sys

    mv = sys.modules["tpucg_torch.kernels.matvec"]  # the package exports a `matvec` too
    A, b, x0 = generate_spd_system(128, seed=6)
    seen = []

    def counted(A_, x):
        seen.append(A_.dtype)
        return matvec_torch(A_, x)
    counted.launches = 0  # the original counts itself under the patched name
    monkeypatch.setattr(mv, "matvec_torch", counted)
    before = fused_update_torch.launches
    res = cg_solve_ir(A, b, x0, device=CPU)
    laps = int(res.iterations)
    assert bool(res.converged)
    assert fused_update_torch.launches - before >= laps  # frozen laps of a chunk too
    assert seen.count(torch.bfloat16) > laps and seen.count(torch.float32) >= 2


def test_ir_validation(system):
    A, b, x0, _ = system
    with pytest.raises(ValueError, match="cg_solve_ir"):
        cg_solve_ir(A, b, x0, method="pipelined", device=CPU)
    with pytest.raises(ValueError, match="cg_solve_ir"):
        cg_solve_ir(A, b, x0, precondition="jacobi", device=CPU)
    with pytest.raises(ValueError, match="float64"):
        cg_solve_ir(A, b, x0, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        cg_solve_ir(A, b[:5], device=CPU)


@pytest.mark.parametrize("n, seed", [(512, 0), (384, 4)])
def test_ir_on_tpucgs_conditioned_system(n, seed):
    # tpucg's IR benchmark system (benchmarks/extensions.py bench_ir): the
    # generator's A shifted down by (n - n/32) I, SPD from n ~ 200 on (its
    # noise's spectral radius is ~sqrt(n/6)), a few dozen inner laps.
    A, b, x0 = generate_spd_system(n, seed=seed)
    A = (A - (n - n / 32.0) * np.eye(n)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    res = cg_solve_ir(A, b, x0, tol=tol, device=CPU)
    ref = tpucg.cg_solve_ir(A, b, x0, tol=tol)
    assert bool(res.converged) and bool(ref.converged)
    assert float(res.residual_norm) < tol
    assert float(np.linalg.norm(b - A @ res.x.numpy())) < 2 * tol
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2


def test_ir_stalls_at_the_f32_floor_and_keeps_the_better_iterate():
    # A tolerance below the f32 floor: rounds stop contracting r.r 4x, the
    # loop stops on `stalled` well before max_refine and reports its best
    # true residual, unconverged, as tpucg's does.
    A, b, x0 = generate_spd_system(128, seed=7)
    res = cg_solve_ir(A, b, x0, tol=1e-12, device=CPU, max_refine=20)
    ref = tpucg.cg_solve_ir(A, b, x0, tol=1e-12, max_refine=20)
    assert not bool(res.converged) and not bool(ref.converged)
    assert float(res.residual_norm) < 1e-5
    r = b - A @ res.x.numpy()
    assert float(np.linalg.norm(r)) < 4 * float(res.residual_norm) + 1e-6
    assert int(res.iterations) < 20 * 128


def test_ir_loop_with_closures():
    # ir_loop on plain closures: the same refinement with any inner solver.
    A, b, _ = generate_spd_system(64, seed=8)
    At = torch.from_numpy(A)
    bt = torch.from_numpy(b)
    sol = torch.linalg.solve(At.double(), bt.double()).float()

    class Exact:
        def __init__(self, x):
            self.x, self.k = x, torch.tensor(1, dtype=torch.int32)

    s = ir_loop(lambda x: At @ x, lambda u, v, act=None: torch.dot(u, v),
                lambda rhs: Exact(torch.linalg.solve(At.double(), rhs.double()).float()),
                bt, torch.zeros(64), tol=1e-6, max_refine=6)
    assert bool(s.done) and 1 <= s.j <= 3
    assert int(s.inner_total) == s.j
    np.testing.assert_allclose(s.x.numpy(), sol.numpy(), rtol=1e-4, atol=1e-6)
