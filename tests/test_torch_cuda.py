"""tpucg_torch's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. This file
imports neither jax nor tpucg, so it runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _torch_helpers import cuda_device, rel_err  # noqa: F401  (fixture)
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.kernels.blas1 import dot_cuda, dot_torch, fused_update_cuda, fused_update_torch
from tpucg_torch.kernels.matvec import matvec_cuda, matvec_torch
from tpucg_torch.solver.cg import cg_loop, cg_solve, lap_ops
from tpucg_torch.solver.operators import DenseOperator

pytestmark = pytest.mark.cuda


def _rand(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return 2 * torch.rand(shape, generator=g, device=dev) - 1


@pytest.mark.parametrize("shape", [(128, 128), (1024, 1024), (256, 8192), (384, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_kernel_matches_plain(cuda_device, shape, dtype):
    A = _rand(cuda_device, *shape).to(dtype)
    x = _rand(cuda_device, shape[1], seed=1)
    y = matvec_cuda(A, x)
    scale = float((A.float().abs() @ x.abs()).max())
    # f32 sums in another order than cuBLAS: 1e-5 of max(|A| |x|).
    assert float((y - matvec_torch(A, x)).abs().max()) <= 1e-5 * scale
    assert torch.equal(y, matvec_cuda(A, x))


@pytest.mark.parametrize("n", [128, 1000, 8192, 100_000])
def test_blas1_kernels_match_plain(cuda_device, n):
    x, r, p, ap = (_rand(cuda_device, n, seed=s) for s in range(4))
    alpha = torch.tensor(0.37, device=cuda_device)
    got = fused_update_cuda(x, r, p, ap, alpha)
    want = fused_update_torch(x, r, p, ap, alpha)
    # one FMA rounding against two
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    assert abs(float(got[2]) - float(want[2])) <= 1e-5 * float(want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, fused_update_cuda(x, r, p, ap, alpha)))
    d = dot_cuda(p, ap)
    assert abs(float(d) - float(dot_torch(p, ap))) <= 1e-5 * float(torch.dot(p.abs(), ap.abs()))
    assert torch.equal(d, dot_cuda(p, ap))


def test_active_flag_zero_writes_nothing(cuda_device):
    x, r, p, ap = (_rand(cuda_device, 1024, seed=s) for s in range(4))
    x0, r0 = x.clone(), r.clone()
    off = torch.zeros((), dtype=torch.int32, device=cuda_device)
    fused_update_cuda(x, r, p, ap, torch.tensor(0.5, device=cuda_device), out=(x, r), active=off)
    assert torch.equal(x, x0) and torch.equal(r, r0)
    on = torch.ones((), dtype=torch.int32, device=cuda_device)
    fused_update_cuda(x, r, p, ap, torch.tensor(0.5, device=cuda_device), out=(x, r), active=on)
    torch.testing.assert_close(x, x0 + 0.5 * p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_goldens_on_card(cuda_device, g):
    res = cg_solve(g["A"], g["b"], g["x0"], device=cuda_device)
    assert int(res.iterations) == g["iters"] and bool(res.converged)
    np.testing.assert_allclose(res.x.cpu().numpy(), g["x_star"], atol=1e-5)


def test_device_named_without_index(cuda_device):
    g = GOLDEN_2X2
    op = DenseOperator.create(g["A"], device="cuda")
    for A in (g["A"], op):
        res = cg_solve(A, g["b"], device="cuda")
        assert int(res.iterations) == 2 and res.x.device == cuda_device


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
def test_solve_on_card_matches_cpu(cuda_device, precondition):
    A, b, x0 = generate_spd_system(1000, seed=0)
    before = matvec_cuda.launches
    card = cg_solve(A, b, x0, device=cuda_device, precondition=precondition)
    cpu = cg_solve(A, b, x0, device="cpu", precondition=precondition)
    assert matvec_cuda.launches > before
    assert int(card.iterations) == int(cpu.iterations)
    assert rel_err(card.x.cpu(), cpu.x) <= 1e-5


def test_chunk_sizes_bit_identical_on_card(cuda_device):
    A, b, x0 = generate_spd_system(1000, seed=4)
    runs = [cg_solve(A, b, x0, device=cuda_device, chunk=c, record_residuals=True)
            for c in (None, 1, 3, 64)]
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x)
        assert torch.equal(r.iterations, runs[0].iterations)
        assert torch.equal(r.residual_history.nan_to_num(-1.0),
                           runs[0].residual_history.nan_to_num(-1.0))


def test_laps_after_done_change_nothing_on_card(cuda_device):
    A, b, x0 = generate_spd_system(1000, seed=0)
    op = DenseOperator.create(A, device=cuda_device)
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=cuda_device), (0, 24))
    x0d = torch.zeros_like(bd)
    ops = lap_ops(op, "cuda")
    done = cg_loop(*ops, bd, x0d, tol=1e-6, maxiter=1000)
    assert bool(done.done)
    again = cg_loop(*ops, None, None, tol=1e-6, maxiter=1000, state=done, chunk=8)
    for a, b_ in zip(done, again):
        if a is not None:
            assert torch.equal(a, b_)


def test_plain_operator_needs_the_plain_kernel(cuda_device):
    g = GOLDEN_4X4
    op = DenseOperator.create(g["A"], backend="torch", device=cuda_device)
    assert op.backend == "torch"
    with pytest.raises(ValueError, match="asked for 'cuda'"):
        cg_solve(op, g["b"])  # kernel="auto" is "cuda" on the card
    before = matvec_cuda.launches, dot_cuda.launches, fused_update_cuda.launches
    res = cg_solve(op, g["b"], kernel="torch")
    assert int(res.iterations) == 4
    assert (matvec_cuda.launches, dot_cuda.launches, fused_update_cuda.launches) == before


def test_lap_buffers_do_not_leak_into_the_state(cuda_device):
    # The cuda lap reuses its output buffers; what a solve returns must not
    # change when the same lap closures run another solve.
    A, b, x0 = generate_spd_system(1000, seed=1)
    op = DenseOperator.create(A, device=cuda_device)
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=cuda_device), (0, 24))
    ops = lap_ops(op, "cuda")
    first = cg_loop(*ops, bd, torch.zeros_like(bd), tol=1e-6, maxiter=1000)
    kept = [None if t is None else t.clone() for t in first]
    cg_loop(*ops, 2 * bd, torch.zeros_like(bd), tol=1e-6, maxiter=1000)
    for a, b_ in zip(first, kept):
        if a is not None:
            assert torch.equal(a, b_)
