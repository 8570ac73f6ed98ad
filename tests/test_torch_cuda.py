"""tpucg_torch's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. This file
imports neither jax nor tpucg, so it runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import (  # noqa: F401  (fixture)
    BAND_SETS,
    FAR_BAND,
    FAR_BAND_N,
    arrowhead_spd,
    banded_battery,
    banded_spectrum_battery,
    batch_dia_cg_emulated,
    circulant_spd_batch,
    cuda_device,
    dot_emulated,
    fused_update_emulated,
    k11_edge_npads,
    padded_batch,
    random_banded_dia,
    rel_err,
    scaled_err,
    shifted_spd_batch,
)
from tpucg_torch.io.generator import (
    fem_p1_system,
    generate_spd_system,
    poisson3d_dia,
    random_geometric_spd,
)
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.kernels.blas1 import (
    CudaLapTail,
    LapTail,
    alpha_torch,
    dot_alpha_cuda,
    dot_alpha_torch,
    dot_alpha_launch,
    dot_cuda,
    dot_launch,
    dot_tail_launch,
    dot_torch,
    fused_update_cuda,
    fused_update_tail_launch,
    fused_update_torch,
    lap_tail_torch,
    p_update_cuda,
    p_update_launch,
    p_update_torch,
    scratch_for,
)
from tpucg_torch.bench.probe_gather import (
    EDGE_NWS,
    EDGE_ROWS,
    EG_EDGE_N,
    RG_EDGE_ROWS,
    ROLL_EDGE_ROWS,
    ROLL_SHIFTS,
    SG_EDGE_ROWS,
    SG_EDGE_VROWS,
    edge_windows,
    index_cases,
    stream_edges,
)
from tpucg_torch.bench.timing import trace_calls
from tpucg_torch.kernels.dispatch import cuda_stream
from tpucg_torch.kernels.fused import (
    BATCH_DIA_WARPS,
    FUSED_BATCH_MAX_N,
    FUSED_MAX_N,
    batch_cluster_plan,
    batch_dia_warps_plan,
    dense_resident_plan,
    dense_resident_plans,
    fused_batch_cg_solve_cuda,
    fused_batch_dia_cg_solve_cuda,
    fused_batch_dia_plan,
    fused_cg_plan,
    fused_cg_solve_cuda,
    dia_tile_plan,
    fused_dia_cg_solve_cuda,
    fused_dia_grid,
    fused_stencil_cg_solve_cuda,
    fused_stencil_grid,
)
from tpucg_torch.kernels.gather_spmv import (
    well_rows,
    well_spmv_cuda,
    well_spmv_fused_gather,
    well_spmv_launch,
    well_spmv_torch,
)
from tpucg_torch.kernels.matvec import matvec_cuda, matvec_torch
from tpucg_torch.kernels.spmv import dia_spmv_cuda, dia_spmv_torch
from tpucg_torch.kernels.stencil import (
    library_march_tile,
    poisson3d_cuda,
    poisson3d_torch,
    stencil_march_plan,
)
from tpucg_torch.solver.cg import (
    cg_loop,
    cg_solve,
    cg_solve_batch,
    cg_solve_batch_banded,
    lap_ops,
    make_precond,
)
from tpucg_torch.solver.fused import (
    fused_batch_cg_solve_torch,
    fused_batch_dia_cg_solve_torch,
    fused_cg_solve_torch,
    fused_dia_cg_solve_torch,
    fused_stencil_cg_solve_torch,
)
from tpucg_torch.solver.operators import (
    DenseOperator,
    DiaOperator,
    PoissonOperator,
    WellOperator,
    best_sparse_operator,
)
from tpucg_torch.sparse.formats import DIAMatrix
from tpucg_torch.solver.oracle import oracle_cg

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


@pytest.mark.parametrize("precondition", ["none", "jacobi", "poly"])
def test_solve_on_card_matches_cpu(cuda_device, precondition):
    # fused="never": the lap path (K1-K3), which small solves leave for K4.
    A, b, x0 = generate_spd_system(1000, seed=0)
    before = matvec_cuda.launches
    card = cg_solve(A, b, x0, device=cuda_device, precondition=precondition, fused="never")
    cpu = cg_solve(A, b, x0, device="cpu", precondition=precondition)
    assert matvec_cuda.launches > before
    assert int(card.iterations) == int(cpu.iterations)
    assert rel_err(card.x.cpu(), cpu.x) <= 1e-5


def test_chunk_sizes_bit_identical_on_card(cuda_device):
    A, b, x0 = generate_spd_system(1000, seed=4)
    runs = [cg_solve(A, b, x0, device=cuda_device, chunk=c, record_residuals=True,
                     fused="never") for c in (None, 1, 3, 64)]
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


# ---- K2 and K3 in one launch each, with the lap's scalar work -----------------

N_ONE_LAUNCH = [1, 255, 8192, 16384, 128 ** 3, 299_964]


def _f32_bits(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, np.float32).view(np.int32)


def _np_vectors(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("n", N_ONE_LAUNCH)
def test_k3_k2_equal_the_emulation_bit_for_bit_on_card(cuda_device, n):
    x, r, p, ap = _np_vectors(n, 4, n)
    xd, rd, pd, apd = (torch.from_numpy(v).to(cuda_device) for v in (x, r, p, ap))
    want = dot_emulated(p, ap)
    for _ in range(2):  # the second launch finds the ticket put back to 0
        np.testing.assert_array_equal(_f32_bits(dot_cuda(pd, apd)), _f32_bits(want))
    rsold = np.float32(2.5)
    pap, alpha = dot_alpha_cuda(pd, apd, torch.tensor(rsold, device=cuda_device))
    np.testing.assert_array_equal(_f32_bits(pap), _f32_bits(want))
    np.testing.assert_array_equal(_f32_bits(alpha), _f32_bits(np.float32(rsold / want)))
    a = np.float32(0.37)
    got = fused_update_cuda(xd, rd, pd, apd, torch.tensor(a, device=cuda_device))
    for g, w in zip(got, fused_update_emulated(x, r, p, ap, a)):
        np.testing.assert_array_equal(_f32_bits(g), _f32_bits(w))


def _kernel_events(fn):
    """{device kernel name: launches} of one call of ``fn`` (memcpy and
    memset left out), retried when the trace holds no device event."""
    for _ in range(3):
        _, ops = trace_calls(fn, 1)
        kernels = {k: c for k, (c, _) in ops.items() if not k.startswith(("Memcpy", "Memset"))}
        if kernels:
            return kernels
    pytest.fail("the profiler's trace held no device event")


def test_k2_k3_and_p_update_are_one_launch_each_on_card(cuda_device):
    n = 8192
    x, r, p, ap = (_rand(cuda_device, n, seed=s) for s in range(4))
    scratch, out, alpha, rr, beta = (scratch_for(x),) + tuple(
        torch.full((), 0.5, device=cuda_device) for _ in range(4))
    step = torch.ones((), dtype=torch.int32, device=cuda_device)
    s = CudaLapTail(cuda_device)
    tol2 = torch.zeros((), device=cuda_device)
    stream = cuda_stream(x)
    s.load(torch.tensor(0), torch.tensor(1.0), torch.tensor(1.0), torch.tensor(False), tol2, 10)
    calls = {
        "dot": lambda: dot_launch(x, p, scratch, out, None, stream),
        "alpha": lambda: dot_alpha_launch(p, ap, scratch, out, s.rsold, alpha, True, None,
                                          stream),
        "tail": lambda: dot_tail_launch(r, x, scratch, out, s.address, stream),
        "update": lambda: fused_update_tail_launch(x, r, p, ap, alpha, x, r, scratch, rr,
                                                   s.address, stream),
        "p": lambda: p_update_launch(r, p, beta, step, scratch, stream),
    }
    for what, fn in calls.items():
        step.fill_(1)
        kernels = _kernel_events(fn)
        assert sum(kernels.values()) == 1, (what, kernels)
        assert not any("sum_partials" in k for k in kernels), kernels


def _tail_on_card(dev, k, rsold, done, maxiter, hist_n=16):
    s = CudaLapTail(dev)
    hist = torch.full((hist_n,), float("nan"), device=dev)
    s.load(torch.tensor(k, dtype=torch.int32), torch.tensor(rsold), torch.tensor(7.0),
           torch.tensor(done), torch.tensor(1e-3, device=dev) ** 2, maxiter, hist)
    plain = LapTail(k=s.k.clone(), rsold=s.rsold.clone(), rslast=s.rslast.clone(),
                    done=s.done.clone(), active=s.active.bool(), hist=hist.clone())
    return s, plain


def _same_bits(a, b):
    """Equal bit for bit (f32 compared as int32, so NaNs compare too)."""
    if a.dtype == torch.float32:
        a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def _assert_tail_equal(s, t):
    """The card's tail buffers ``s`` against ``lap_tail_torch``'s ``t``."""
    for f in ("k", "rsold", "rslast", "done", "beta", "hist"):
        assert _same_bits(getattr(s, f), getattr(t, f).to(s.hist.device)), f
    assert bool(s.active) == bool(t.active) and bool(s.step) == bool(t.step)


@pytest.mark.parametrize("k, maxiter, scale", [(3, 100, 1.0), (3, 100, 1e-6), (99, 100, 1.0)],
                         ids=["steps", "stops", "reaches-maxiter"])
def test_tails_and_alpha_equal_the_plain_versions_on_card(cuda_device, k, maxiter, scale):
    n = 8192
    x, r, p, ap, z = (_rand(cuda_device, n, seed=s) for s in range(5))
    r = r * scale
    ap = ap * scale
    stream = cuda_stream(x)
    for safe in (True, False):
        s, plain = _tail_on_card(cuda_device, k, 2.0, False, maxiter)
        scratch = scratch_for(x)
        out, alpha = (torch.empty((), device=cuda_device) for _ in range(2))
        dot_alpha_launch(p, ap, scratch, out, s.rsold, alpha, safe, s.active.data_ptr(), stream)
        assert torch.equal(alpha, alpha_torch(out, plain.rsold, safe))
        xo, ro = x.clone(), r.clone()
        fused_update_tail_launch(xo, ro, p, ap, alpha, xo, ro, scratch, s.rr, s.address, stream)
        want = fused_update_cuda(x, r, p, ap, alpha)
        assert torch.equal(xo, want[0]) and torch.equal(ro, want[1])
        assert torch.equal(s.rr, want[2])
        _assert_tail_equal(s, lap_tail_torch(plain, s.rr, s.rr, s.tol2, maxiter))
        # p's update, then its flag is cleared
        beta, step = s.beta.clone(), s.step.bool()
        pp = p.clone()
        p_update_launch(ro, pp, s.beta, s.step, scratch, stream)
        assert torch.equal(pp, p_update_torch(ro, p, beta, step))
        assert int(s.step) == 0
    # K3's tail: rs_new = r.z, the lap's r.r from its slot
    s, plain = _tail_on_card(cuda_device, k, 2.0, False, maxiter)
    s.rr.copy_(torch.dot(r, r))
    out = torch.empty((), device=cuda_device)
    dot_tail_launch(r, z, scratch_for(r), out, s.address, stream)
    assert torch.equal(out, dot_cuda(r, z))
    _assert_tail_equal(s, lap_tail_torch(plain, s.rr, out, s.tol2, maxiter))


def test_a_frozen_lap_changes_no_buffer_on_card(cuda_device):
    n = 8192
    x, r, p, ap = (_rand(cuda_device, n, seed=s) for s in range(4))
    s, _ = _tail_on_card(cuda_device, 5, 2.0, True, 100)  # done: frozen
    assert int(s.active) == 0
    scratch = scratch_for(x)
    out, alpha = torch.zeros((), device=cuda_device), torch.full((), 0.5, device=cuda_device)
    stream = cuda_stream(x)
    held = [t.clone() for t in (x, r, p, ap, scratch, out, alpha, s.k, s.rsold, s.rslast,
                                s.done, s.active, s.beta, s.step, s.rr, s.hist)]
    before = dot_cuda.launches, fused_update_cuda.launches, p_update_cuda.launches
    dot_alpha_launch(p, ap, scratch, out, s.rsold, alpha, True, s.active.data_ptr(), stream)
    fused_update_tail_launch(x, r, p, ap, alpha, x, r, scratch, s.rr, s.address, stream)
    dot_tail_launch(r, x, scratch, out, s.address, stream)
    p_update_launch(r, p, s.beta, s.step, scratch, stream)
    torch.cuda.synchronize()
    assert (dot_cuda.launches, fused_update_cuda.launches, p_update_cuda.launches) == tuple(
        b + c for b, c in zip(before, (2, 1, 1)))
    for a, b in zip((x, r, p, ap, scratch, out, alpha, s.k, s.rsold, s.rslast, s.done,
                     s.active, s.beta, s.step, s.rr, s.hist), held):
        assert _same_bits(a, b)


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_a_second_solve_on_the_same_lap_repeats_on_card(cuda_device, pc):
    A, b, x0 = generate_spd_system(1000, seed=2)
    op = DenseOperator.create(A, device=cuda_device)
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=cuda_device), (0, 24))
    matvec, dot, lap = lap_ops(op, "cuda")
    d = op.diagonal()
    minv = torch.where(d != 0, 1.0 / d, 1.0)
    precond = make_precond(pc, minv, matvec, dot, bd, 3)
    runs = [cg_loop(matvec, dot, lap, bd, torch.zeros_like(bd), tol=1e-6, maxiter=1000,
                    precond=precond, hist_len=1000) for _ in range(2)]
    assert bool(runs[0].done)
    for a, b_ in zip(*runs):
        assert _same_bits(a, b_)


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_maxiter_cut_p_is_the_same_for_every_chunk_on_card(cuda_device, pc):
    # The lap that reaches maxiter steps p; the frozen laps after it (in a
    # chunk that outlasts it) must not step it again.
    A, b, x0 = generate_spd_system(1000, seed=4)
    runs = [cg_solve(A, b, x0, device=cuda_device, precondition=pc, poly_degree=3,
                     fused="never", tol=1e-12, maxiter=5, chunk=c) for c in (1, 8, None)]
    op = DenseOperator.create(A, device=cuda_device)
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=cuda_device), (0, 24))
    x0d = torch.nn.functional.pad(torch.as_tensor(x0, device=cuda_device), (0, 24))
    matvec, dot, lap = lap_ops(op, "cuda")
    d = op.diagonal()
    precond = make_precond(pc, torch.where(d != 0, 1.0 / d, 1.0), matvec, dot, bd, 3)
    states = [cg_loop(matvec, dot, lap, bd, x0d, tol=1e-12, maxiter=5, precond=precond,
                      chunk=c) for c in (1, 8)]
    assert int(states[0].k) == 5 and not bool(states[0].done)
    for f in ("k", "x", "r", "p", "rsold", "rslast", "done"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f
    for res in runs[1:]:
        assert torch.equal(res.x, runs[0].x) and torch.equal(res.iterations, runs[0].iterations)


def test_lap_route_is_four_launches_a_lap_on_card(cuda_device):
    A, b, x0 = generate_spd_system(8192, seed=0)
    op = DenseOperator.create(A, device=cuda_device)
    del A
    bd = torch.as_tensor(b, device=cuda_device)

    def kernels(laps):
        return _kernel_events(lambda: cg_solve(op, bd, tol=1e-30, maxiter=laps, chunk=8))

    short, long = kernels(16), kernels(48)
    per_lap = (sum(long.values()) - sum(short.values())) / 32
    assert per_lap == 4, (short, long)
    counts = {k: long.get(k, 0) - short.get(k, 0) for k in long}
    assert sorted(c for c in counts.values() if c) == [32, 32, 32, 32], counts


# ---- the whole solve: K4 (one system) and K5 (a batch) -----------------------


def _k4_operands(dev, n, seed=0):
    A, b, x0 = generate_spd_system(n, seed=seed)
    op = DenseOperator.create(A, device=dev)
    pad = op.padded_n - n
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=dev), (0, pad))
    x0d = torch.nn.functional.pad(torch.as_tensor(x0, device=dev), (0, pad))
    d = op.diagonal()
    return (A, b, x0), op, bd, x0d, torch.where(d != 0, 1.0 / d, 1.0)


# x against another correct f32 solve, relative to the solution's size
# (x ~ 1/n on these systems, so a fixed atol would hide a wrong x):
# max |x - x_plain| <= 1e-5 max |x_plain| for none and jacobi (f32 sums in
# another order) and 1e-4 for poly (its power method and Neumann apply sum in
# other orders too).
def _x_bound(pc):
    return 1e-4 if pc == "poly" else 1e-5


@pytest.mark.parametrize("n", [100, 1000, 2048, 4096],
                         ids=["npad128", "npad1024", "npad2048", "npad4096"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_k4_matches_plain_on_card(cuda_device, n, pc):
    (A, b, x0), op, bd, x0d, minv = _k4_operands(cuda_device, n)
    kw = dict(tol=1e-6, maxiter=n, precondition=pc, poly_degree=3 if pc == "poly" else 0,
              minv=minv if pc == "jacobi" else None)
    x, k, rr = fused_cg_solve_cuda(op.A, bd, x0d, **kw)
    xp, kp, rp = fused_cg_solve_torch(op.A, bd, x0d, **kw)
    assert x.shape == (op.padded_n,) and k.dtype == torch.int32 and rr.shape == ()
    assert int(k) == int(kp) and float(rr) < 1e-12
    assert scaled_err(x.cpu(), xp.cpu()) <= _x_bound(pc)
    again = fused_cg_solve_cuda(op.A, bd, x0d, **kw)
    assert all(torch.equal(u, v) for u, v in zip((x, k, rr), again))
    if pc == "none":
        assert int(k) == oracle_cg(A, b, x0)[1]


@pytest.mark.parametrize("npad", [128, 256, 1024, 1152, 2048, 2176, 3072, 4096])
def test_k4_library_plan_is_dense_resident_plan(cuda_device, npad):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for plan in [dense_resident_plan(npad, sms)] + dense_resident_plans(npad, sms):
        forced = None if plan == dense_resident_plan(npad, sms) else (plan.blocks_per_sm,
                                                                      plan.resident)
        assert fused_cg_plan(npad, forced) == (plan.blocks_per_sm, plan.grid, plan.resident,
                                               plan.smem_bytes)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("pc", ["none", "poly"])
def test_k4_every_forced_plan_takes_the_plans_laps(cuda_device, n, pc):
    (A, b, x0), op, bd, x0d, minv = _k4_operands(cuda_device, n)
    kw = dict(tol=1e-6, maxiter=n, precondition=pc, poly_degree=3 if pc == "poly" else 0)
    x, k, rr = fused_cg_solve_cuda(op.A, bd, x0d, **kw)
    xp, kp, _ = fused_cg_solve_torch(op.A, bd, x0d, **kw)
    assert int(k) == int(kp)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for plan in dense_resident_plans(op.padded_n, sms):
        try:
            got = fused_cg_solve_cuda(op.A, bd, x0d, _plan=(plan.blocks_per_sm, plan.resident),
                                      **kw)
        except RuntimeError as e:
            # Only a grid the card cannot hold at once (registers) may be
            # refused; the plan's own grid never is.
            assert "cooperative" in str(e) and plan.grid != dense_resident_plan(
                op.padded_n, sms).grid, (plan.describe(), e)
            continue
        assert int(got[1]) == int(k), plan.describe()
        assert scaled_err(got[0].cpu(), xp.cpu()) <= _x_bound(pc), plan.describe()
        if plan.grid == dense_resident_plan(op.padded_n, sms).grid:
            # The same grid sums the partials in the same order, wherever
            # the rows lie.
            assert all(torch.equal(u, v) for u, v in zip((x, k, rr), got)), plan.describe()


def test_k4_refuses_a_forced_plan_that_does_not_fit(cuda_device):
    (_, _, _), op, bd, x0d, _ = _k4_operands(cuda_device, 4096)
    with pytest.raises(RuntimeError, match="fused_cg_solve_cuda"):
        fused_cg_solve_cuda(op.A, bd, x0d, tol=1e-6, maxiter=8, _plan=(1, 40))
    with pytest.raises(RuntimeError, match="fused_cg_plan"):
        fused_cg_plan(4096, (9, 0))


def test_k4_maxiter_cap_and_exact_guess_on_card(cuda_device):
    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - (n - n / 8.0) * np.eye(n)).astype(np.float32)
    op = DenseOperator.create(A, device=cuda_device)
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=cuda_device), (0, 32))
    z = torch.zeros_like(bd)
    x, k, rr = fused_cg_solve_cuda(op.A, bd, z, tol=1e-6, maxiter=3)
    xp, kp, _ = fused_cg_solve_torch(op.A, bd, z, tol=1e-6, maxiter=3)
    assert int(k) == int(kp) == 3 and float(rr) > 1e-12
    torch.testing.assert_close(x, xp, rtol=1e-5, atol=1e-6)
    e0 = torch.zeros_like(bd)
    e0[0] = 1.0  # A e0 is column 0, exact whatever the order of the sums
    x, k, rr = fused_cg_solve_cuda(op.A, op.A[:, 0].contiguous(), e0, tol=1e-6, maxiter=128)
    assert int(k) == 0 and float(rr) == 0.0 and torch.equal(x, e0)


def test_k4_refuses_what_it_cannot_run_on_card(cuda_device):
    big = FUSED_MAX_N + 128
    v = torch.zeros(big, device=cuda_device)
    with pytest.raises(ValueError, match="fused solve needs 128-aligned n <= 4096"):
        fused_cg_solve_cuda(torch.zeros(big, big, device=cuda_device), v, v, tol=1e-6, maxiter=4)
    nb = FUSED_BATCH_MAX_N + 128
    vb = torch.zeros(1, nb, device=cuda_device)
    with pytest.raises(ValueError, match="batched fused solve needs 128-aligned n <= 2048"):
        fused_batch_cg_solve_cuda(torch.zeros(1, nb, nb, device=cuda_device), vb, vb,
                                  tol=1e-6, maxiter=4)


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_fused_always_runs_k4_and_nothing_else(cuda_device, g):
    wrappers = (fused_cg_solve_cuda, fused_cg_solve_torch, matvec_cuda, dot_cuda,
                fused_update_cuda)
    before = [w.launches for w in wrappers]
    res = cg_solve(g["A"], g["b"], g["x0"], device=cuda_device, fused="always")
    assert int(res.iterations) == g["iters"] and bool(res.converged)
    np.testing.assert_allclose(res.x.cpu().numpy(), g["x_star"], atol=1e-5)
    assert [w.launches - b_ for w, b_ in zip(wrappers, before)] == [1, 0, 0, 0, 0]


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_fused_always_solve_matches_the_lap_path(cuda_device, pc):
    A, b, x0 = generate_spd_system(1000, seed=2)
    fused = cg_solve(A, b, x0, device=cuda_device, precondition=pc, fused="always")
    laps = cg_solve(A, b, x0, device=cuda_device, precondition=pc, fused="never")
    assert int(fused.iterations) == int(laps.iterations) and bool(fused.converged)
    assert fused.x.shape == (1000,)
    assert scaled_err(fused.x.cpu(), laps.x.cpu()) <= _x_bound(pc)


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_k5_matches_plain_on_card(cuda_device, pc):
    As, bs, X0 = circulant_spd_batch(12, 1000)
    A = torch.zeros(12, 1024, 1024, device=cuda_device)
    A[:, :1000, :1000] = torch.as_tensor(As, device=cuda_device)
    idx = torch.arange(1000, 1024, device=cuda_device)
    A[:, idx, idx] = 1.0
    b = torch.nn.functional.pad(torch.as_tensor(bs, device=cuda_device), (0, 24))
    x0 = torch.nn.functional.pad(torch.as_tensor(X0, device=cuda_device), (0, 24))
    d = torch.diagonal(A, dim1=1, dim2=2)
    # Lap counts fixed by the spectra: tol 1e-2 lies far from ||r|| on both
    # sides of the last lap, so no rounding order can move it.
    kw = dict(tol=1e-2, maxiter=1000, precondition=pc,
              minv=torch.where(d != 0, 1.0 / d, 1.0) if pc == "jacobi" else None)
    x, k, rr = fused_batch_cg_solve_cuda(A, b, x0, **kw)
    xp, kp, _ = fused_batch_cg_solve_torch(A, b, x0, **kw)
    assert torch.equal(k, kp) and k.tolist() == [1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 0]
    assert bool((rr < 1e-4).all())
    torch.testing.assert_close(x, xp, rtol=1e-5, atol=1e-6)
    assert scaled_err(x.cpu(), xp.cpu()) <= 1e-4
    again = fused_batch_cg_solve_cuda(A, b, x0, **kw)
    assert all(torch.equal(u, v) for u, v in zip((x, k, rr), again))


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_k5_shifted_batch_within_a_lap_on_card(cuda_device, pc):
    # generate_spd_system-style systems with their own seeds and shifts at
    # tol 1e-6: they stop where the rounding of r is of the order of tol, so
    # K5 and its plain version may stop a lap apart, never more.
    As, bs, X0 = shifted_spd_batch(16, 1000, seed=100)
    A = torch.nn.functional.pad(torch.as_tensor(As, device=cuda_device), (0, 24, 0, 24))
    idx = torch.arange(1000, 1024, device=cuda_device)
    A[:, idx, idx] = 1.0
    b = torch.nn.functional.pad(torch.as_tensor(bs, device=cuda_device), (0, 24))
    x0 = torch.nn.functional.pad(torch.as_tensor(X0, device=cuda_device), (0, 24))
    d = torch.diagonal(A, dim1=1, dim2=2)
    kw = dict(tol=1e-6, maxiter=1000, precondition=pc,
              minv=torch.where(d != 0, 1.0 / d, 1.0) if pc == "jacobi" else None)
    x, k, rr = fused_batch_cg_solve_cuda(A, b, x0, **kw)
    xp, kp, _ = fused_batch_cg_solve_torch(A, b, x0, **kw)
    assert int(k[-1]) == int(kp[-1]) == 0 and bool(k[:-1].gt(0).all())
    assert int((k - kp).abs().max()) <= 1 and bool((rr < 1e-12).all())
    assert scaled_err(x.cpu(), xp.cpu()) <= 1e-4
    again = fused_batch_cg_solve_cuda(A, b, x0, **kw)
    assert all(torch.equal(u, v) for u, v in zip((x, k, rr), again))


@pytest.mark.parametrize("pc", ["none", "jacobi"])
@pytest.mark.parametrize("kind", ["circulant", "shifted"])
@pytest.mark.parametrize("nsys,n", [(12, 1000), (4, 2048)])
def test_k5_is_bit_identical_for_every_cluster_on_card(cuda_device, nsys, n, kind, pc):
    # Each system on 1, 2, 4 or 8 blocks: the rows' sums and the scalars'
    # reductions keep the one-block order, so x, k and r.r keep its bits.
    make, tol = (circulant_spd_batch, 1e-2) if kind == "circulant" else (shifted_spd_batch, 1e-6)
    A, b, x0, minv = padded_batch(*make(nsys, n, seed=7), cuda_device)
    kw = dict(tol=tol, maxiter=n, precondition=pc, minv=minv if pc == "jacobi" else None)
    planned = fused_batch_cg_solve_cuda(A, b, x0, **kw)
    assert batch_cluster_plan(nsys, A.shape[1]).cluster == 8
    for cluster in (1, 2, 4, 8):
        got = fused_batch_cg_solve_cuda(A, b, x0, _cluster=cluster, **kw)
        assert all(torch.equal(u, v) for u, v in zip(planned, got)), cluster
    x, k, _ = planned
    xp, kp, _ = fused_batch_cg_solve_torch(A, b, x0, **kw)
    assert int(k[-1]) == 0 and bool(k[:-1].gt(0).all())
    assert int((k - kp).abs().max()) <= (0 if kind == "circulant" else 1)
    assert scaled_err(x.cpu(), xp.cpu()) <= 1e-4


def test_cg_solve_batch_runs_k5_once_on_a_full_card(cuda_device):
    # B = 200 fills the card's SMs: one block a system (C = 1), one launch.
    As, bs, X0 = circulant_spd_batch(200, 256, seed=5)
    assert batch_cluster_plan(200, 256).cluster == 1
    before = (fused_batch_cg_solve_cuda.launches, fused_batch_cg_solve_torch.launches)
    res = cg_solve_batch(As, bs, X0, device=cuda_device, tol=1e-2)
    assert (fused_batch_cg_solve_cuda.launches - before[0],
            fused_batch_cg_solve_torch.launches - before[1]) == (1, 0)
    assert res.iterations.tolist() == [1 + i % 6 for i in range(199)] + [0]
    A, b, x0, _ = padded_batch(As, bs, X0, cuda_device)
    xp, kp, _ = fused_batch_cg_solve_torch(A, b, x0, tol=1e-2, maxiter=256)
    assert res.iterations.tolist() == kp.tolist()
    assert scaled_err(res.x.cpu(), xp[:, :256].cpu()) <= 1e-4


def test_cg_solve_batch_runs_k5_on_card(cuda_device):
    As, bs, X0 = circulant_spd_batch(6, 300, seed=3)
    before = (fused_batch_cg_solve_cuda.launches, fused_batch_cg_solve_torch.launches)
    res = cg_solve_batch(As, bs, X0, device=cuda_device, tol=1e-2)
    assert (fused_batch_cg_solve_cuda.launches - before[0],
            fused_batch_cg_solve_torch.launches - before[1]) == (1, 0)
    cpu = cg_solve_batch(As, bs, X0, device="cpu", tol=1e-2)
    assert torch.equal(res.iterations.cpu(), cpu.iterations)
    torch.testing.assert_close(res.x.cpu(), cpu.x, rtol=1e-5, atol=1e-6)
    for i in range(6):
        one = cg_solve(As[i], bs[i], X0[i], device=cuda_device, fused="never", tol=1e-2)
        assert int(one.iterations) == int(res.iterations[i])


# ---- the structured-sparse path: K6, K8 (lap) and K10, K11 (whole solve) ----


@pytest.mark.parametrize("band", list(BAND_SETS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [512, 1000, 70_000])
def test_dia_spmv_kernel_equals_plain(cuda_device, band, dtype, n):
    # The same products and sums in the same order, each rounded on its own:
    # bit for bit.
    offsets, data, _ = random_banded_dia(n, BAND_SETS[band], seed=n)
    d = torch.as_tensor(data, device=cuda_device).to(dtype)
    x = _rand(cuda_device, n, seed=3)
    y = dia_spmv_cuda(d, offsets, x)
    assert torch.equal(y, dia_spmv_torch(d, offsets, x))
    assert torch.equal(y, dia_spmv_cuda(d, offsets, x))


@pytest.mark.parametrize("m", [2, 3, 10, 16, 33])
def test_poisson3d_kernel_equals_plain(cuda_device, m):
    u = _rand(cuda_device, m ** 3, seed=m)
    y = poisson3d_cuda(u, m)
    assert torch.equal(y, poisson3d_torch(u, m))
    assert torch.equal(y, poisson3d_cuda(u, m))


# K8/K9's march (csrc/sparse.cu poisson3d_march_kernel): the plan's edge
# shapes (one tile; lines of 25 and 33 chunks; m % 4 != 0, scalar loads),
# each forced tile of bench/k8_march.py's sweep, the library's plan against
# stencil_march_plan, misaligned operands, one-plane and uneven slabs.


@pytest.mark.parametrize("m", [2, 3, 10, 33, 100, 129])
def test_k8_march_at_the_plans_edge_shapes(cuda_device, m):
    u = _rand(cuda_device, m ** 3, seed=m)
    y = poisson3d_cuda(u, m)
    assert torch.equal(y, poisson3d_torch(u, m))
    assert torch.equal(y, poisson3d_cuda(u, m))


def _sweep():
    from tpucg_torch.bench.k8_march import SWEEP
    return [(m, tile) for m, tiles in SWEEP.items() for tile in tiles]


@pytest.mark.parametrize("m,tile", _sweep())
def test_k8_on_each_forced_tile_of_the_sweep(cuda_device, m, tile):
    ty, tz, nx = tile
    plan = stencil_march_plan(m, ty=ty, tz=tz, nx=nx)
    u = _rand(cuda_device, m ** 3, seed=m)
    y = poisson3d_cuda(u, m, _plan=plan)
    assert torch.equal(y, poisson3d_torch(u, m))
    assert torch.equal(y, poisson3d_cuda(u, m, _plan=plan))


def test_k8_k9_library_plans_stencil_march_plans_tiles(cuda_device):
    for m in (2, 3, 10, 16, 33, 64, 100, 128, 129, 192, 256, 1000, 1024, 1280):
        for mp in sorted({1, 2, max(1, m // 4), m}):
            p = stencil_march_plan(m, mp)
            assert library_march_tile(m, mp) == (p.tz, p.ty, p.nx), (m, mp)


@pytest.mark.parametrize("m,P", [(16, 16), (10, 3), (33, 4), (128, 3), (129, 2)])
def test_k9_one_plane_and_uneven_slabs_concatenate_to_k8(cuda_device, m, P):
    from tpucg_torch.kernels.stencil import poisson3d_slab_cuda, poisson3d_slab_torch

    mm = m * m
    u = _rand(cuda_device, m ** 3, seed=m + P)
    parts, start = [], 0
    for r in range(P):
        mp = m // P + (r < m % P)
        ub = u[start * mm:(start + mp) * mm]
        zero = torch.zeros(mm, device=cuda_device)
        lo = u[(start - 1) * mm:start * mm] if start > 0 else zero
        hi = u[(start + mp) * mm:(start + mp + 1) * mm] if start + mp < m else zero
        y = poisson3d_slab_cuda(ub, lo, hi, m)
        assert torch.equal(y, poisson3d_slab_torch(ub, lo, hi, m))
        assert torch.equal(y, poisson3d_slab_cuda(ub, lo, hi, m))
        parts.append(y)
        start += mp
    assert torch.equal(torch.cat(parts), poisson3d_cuda(u, m))


def test_k8_k9_misaligned_operands_and_forced_plans_on_card(cuda_device):
    # u 4 bytes past a 16-byte boundary: the march takes scalar loads.
    from tpucg_torch.kernels.stencil import poisson3d_slab_cuda, poisson3d_slab_torch

    m, mm = 16, 256
    big = _rand(cuda_device, m ** 3 + 1 + 2 * mm, seed=4)
    u = big[1:1 + m ** 3]
    assert u.data_ptr() % 16 == 4
    assert torch.equal(poisson3d_cuda(u, m), poisson3d_torch(u, m))
    ub, lo, hi = big[1:1 + 4 * mm], big[1 + 4 * mm:1 + 5 * mm], big[2 + 5 * mm:2 + 6 * mm]
    assert torch.equal(poisson3d_slab_cuda(ub, lo, hi, m), poisson3d_slab_torch(ub, lo, hi, m))
    plan = stencil_march_plan(m, 4, halo=True, tz=8, ty=5, nx=3)
    assert torch.equal(poisson3d_slab_cuda(ub, lo, hi, m, _plan=plan),
                       poisson3d_slab_torch(ub, lo, hi, m))
    with pytest.raises(ValueError, match="the plan is for"):
        poisson3d_cuda(u, m, _plan=stencil_march_plan(m + 1))
    with pytest.raises(ValueError, match="the plan is for"):
        poisson3d_slab_cuda(ub, lo, hi, m, _plan=stencil_march_plan(m, 4))


def test_bf16_poisson_slab_equals_f32_on_card(cuda_device):
    # 6, -1 and the identity tail are exact in bf16.
    dia = poisson3d_dia(12)
    f32 = DiaOperator.from_dia(dia, device=cuda_device)
    bf16 = DiaOperator.from_dia(dia, storage_dtype=torch.bfloat16, device=cuda_device)
    x = _rand(cuda_device, f32.padded_n, seed=5)
    assert torch.equal(f32.matvec(x), bf16.matvec(x))


def test_sparse_active_flag_zero_returns_at_once(cuda_device):
    off = torch.zeros((), dtype=torch.int32, device=cuda_device)
    u = _rand(cuda_device, 8 ** 3)
    y = torch.full_like(u, 7.0)
    from tpucg_torch.kernels.spmv import dia_spmv_launch, offsets_array
    from tpucg_torch.kernels.stencil import poisson3d_launch, poisson3d_slab_launch
    stream = torch.cuda.current_stream().cuda_stream
    poisson3d_launch(u, y, 8, off.data_ptr(), stream)
    poisson3d_launch(u, y, 8, off.data_ptr(), stream, plan=stencil_march_plan(8, tz=4, nx=3))
    z = torch.zeros(64, device=cuda_device)
    poisson3d_slab_launch(u, z, z, y, 8, 8, off.data_ptr(), stream)
    poisson3d_slab_launch(u, z, z, y, 8, 8, off.data_ptr(), stream,
                          plan=stencil_march_plan(8, 8, halo=True, ty=3, nx=2))
    op = DiaOperator.from_dia(poisson3d_dia(8), device=cuda_device)
    dia_spmv_launch(op.data, offsets_array(op.offsets), u, y, off.data_ptr(), stream)
    assert bool((y == 7.0).all())


def _poisson_rhs(dev, m, seed):
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal(m ** 3).astype(np.float32), device=dev)
    x0 = torch.as_tensor(0.1 * rng.standard_normal(m ** 3).astype(np.float32), device=dev)
    return b, x0


# Whole solves against their plain versions: sums in other orders, so laps
# within one (tpucg's own bound, tests/test_fused.py:167) and x within 1e-4
# of max |x|. K10's cases: one tile (m = 10), the near/far switch of +-m^2
# (32: staged, 33: read through L2), a partial last tile (m = 101,
# 1,030,301 rows); "cache": m = 10 and 101 in turn in one process (one
# occupancy count for every m).
def _k10_case(dev, m, pc):
    b, x0 = _poisson_rhs(dev, m, seed=m)
    tol = 1e-5 * float(b.norm())
    kw = dict(tol=tol, maxiter=min(4 * m ** 3, 4000), precondition=pc,
              poly_degree=3 if pc == "poly" else 0)
    x, k, rr = fused_stencil_cg_solve_cuda(b, x0, m, **kw)
    xp, kp, _ = fused_stencil_cg_solve_torch(b, x0, m, **kw)
    assert abs(int(k) - int(kp)) <= 1 and float(rr) < tol ** 2
    assert scaled_err(x.cpu(), xp.cpu()) <= 1e-4
    again = fused_stencil_cg_solve_cuda(b, x0, m, **kw)
    assert all(torch.equal(u, v) for u, v in zip((x, k, rr), again))


@pytest.mark.parametrize("m", [10, 16, 24, 32, 33, 101, "cache"])
@pytest.mark.parametrize("pc", ["none", "poly"])
def test_k10_matches_plain_on_card(cuda_device, m, pc):
    for mm in ((10, 101, 10) if m == "cache" else (m,)):
        _k10_case(cuda_device, mm, pc)


def test_k10_grid_on_card(cuda_device):
    # At most one block per 256 rows; else the occupancy count at the
    # window's shared bytes, at least the 4 blocks an SM of the launch bounds.
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fused_stencil_grid(10) == 4 and fused_stencil_grid(2) == 1
    grid = fused_stencil_grid(128)
    assert grid % sms == 0 and grid // sms >= 4 and grid == fused_stencil_grid(192)


# One lap against the plain version: a wrong window or a wrong far column
# shows in x at once; alpha's sums in another order leave x within 1e-6 of
# max |x|.
@pytest.mark.parametrize("m", [2, 10, 32, 33, 101])
def test_k10_one_lap_matches_plain_on_card(cuda_device, m):
    b, x0 = _poisson_rhs(cuda_device, m, seed=m + 1)
    kw = dict(tol=0.0, maxiter=1)
    x, k, _ = fused_stencil_cg_solve_cuda(b, x0, m, **kw)
    xp, kp, _ = fused_stencil_cg_solve_torch(b, x0, m, **kw)
    assert int(k) == int(kp) == 1
    assert scaled_err(x.cpu(), xp.cpu()) <= 1e-6


def _k11_systems(dev, band, dtype):
    """(data, offsets, b, x0, tol) of each K11 case, padded; "windows" gives
    two systems whose staged windows differ, solved in turn in one process."""
    if band == "windows":
        return (_k11_systems(dev, "tridiagonal", dtype)
                + _k11_systems(dev, "multi_row", dtype)
                + _k11_systems(dev, "tridiagonal", dtype))
    if band == "edge":
        # Tiles dealt unevenly: blocks with no row, blocks with three tiles,
        # a partial last tile (dia_tile_plan, k11_edge_npads).
        grid = fused_dia_grid(2 ** 24, dtype)
        systems = []
        for npad in k11_edge_npads(grid):
            assert fused_dia_grid(npad, dtype) == grid
            offsets, data, b = random_banded_dia(npad, BAND_SETS["cross_row"], seed=3)
            op = DiaOperator(data=torch.as_tensor(data, device=dev).to(dtype), offsets=offsets,
                             n=npad)
            assert op.padded_n == npad and npad % dia_tile_plan(npad, offsets).tile
            systems.append((op, b, 1e-6))
        return systems
    if band == "poisson16":
        dia = poisson3d_dia(16)
        b = np.random.default_rng(1).standard_normal(16 ** 3).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
    else:
        n = FAR_BAND_N if band == "far" else 1000
        offsets, data, b = random_banded_dia(
            n, FAR_BAND if band == "far" else BAND_SETS[band], seed=2)
        dia = DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(n, n))
        tol = 1e-6
    return [(DiaOperator.from_dia(dia, storage_dtype=dtype, device=dev), b, tol)]


@pytest.mark.parametrize("band", list(BAND_SETS) + ["poisson16", "far", "edge", "windows"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k11_matches_plain_on_card(cuda_device, band, pc, dtype):
    for op, b, tol in _k11_systems(cuda_device, band, dtype):
        pad = op.padded_n - op.n
        bd = torch.nn.functional.pad(torch.as_tensor(b, device=cuda_device), (0, pad))
        x0 = 0.1 * _rand(cuda_device, op.padded_n, seed=4)
        x0[op.n:] = 0.0
        kw = dict(tol=tol, maxiter=min(4 * op.padded_n, 4000), precondition=pc,
                  poly_degree=3 if pc == "poly" else 0)
        x, k, rr = fused_dia_cg_solve_cuda(op.data, op.offsets, bd, x0, **kw)
        xp, kp, _ = fused_dia_cg_solve_torch(op.data, op.offsets, bd, x0, **kw)
        assert abs(int(k) - int(kp)) <= 1 and float(rr) < tol ** 2
        assert scaled_err(x.cpu(), xp.cpu()) <= 1e-4
        again = fused_dia_cg_solve_cuda(op.data, op.offsets, bd, x0, **kw)
        assert all(torch.equal(u, v) for u, v in zip((x, k, rr), again))


def test_k10_k11_refuse_what_they_cannot_run_on_card(cuda_device):
    b = torch.zeros(8 ** 3, device=cuda_device)
    with pytest.raises(ValueError, match="supports precondition none/poly"):
        fused_stencil_cg_solve_cuda(b, b, 8, tol=1e-6, maxiter=4, precondition="jacobi")
    data = torch.ones(2, 512, device=cuda_device)
    v = torch.zeros(512, device=cuda_device)
    with pytest.raises(ValueError, match="jacobi needs a stored main diagonal"):
        fused_dia_cg_solve_cuda(data, (-1, 1), v, v, tol=1e-6, maxiter=4, precondition="jacobi")


_SPARSE_WRAPPERS = (fused_stencil_cg_solve_cuda, fused_dia_cg_solve_cuda, poisson3d_cuda,
                    dia_spmv_cuda, dot_cuda, fused_update_cuda, poisson3d_torch, dia_spmv_torch,
                    fused_stencil_cg_solve_torch, fused_dia_cg_solve_torch)


@pytest.mark.parametrize("kind", ["poisson", "dia_f32", "dia_bf16"])
def test_cg_solve_sparse_routes_on_card(cuda_device, kind):
    m = 16
    if kind == "poisson":
        op = PoissonOperator(m, device=cuda_device)
    else:
        dtype = torch.bfloat16 if kind == "dia_bf16" else torch.float32
        op = DiaOperator.from_dia(poisson3d_dia(m), storage_dtype=dtype, device=cuda_device)
    b, _ = _poisson_rhs(cuda_device, m, seed=9)
    tol = 1e-5 * float(b.norm())
    before = [w.launches for w in _SPARSE_WRAPPERS]
    fused = cg_solve(op, b, tol=tol, maxiter=4 * m ** 3)
    counts = [w.launches - c for w, c in zip(_SPARSE_WRAPPERS, before)]
    assert counts[:2] == ([1, 0] if kind == "poisson" else [0, 1]) and sum(counts[2:]) == 0
    before = [w.launches for w in _SPARSE_WRAPPERS]
    laps = cg_solve(op, b, tol=tol, maxiter=4 * m ** 3, fused="never")
    counts = [w.launches - c for w, c in zip(_SPARSE_WRAPPERS, before)]
    matvec = 2 if kind == "poisson" else 3
    assert counts[:2] == [0, 0] and all(counts[i] > 0 for i in (matvec, 4, 5))
    assert sum(counts[6:]) == 0
    assert bool(fused.converged) and bool(laps.converged)
    assert abs(int(fused.iterations) - int(laps.iterations)) <= 1
    assert scaled_err(fused.x.cpu(), laps.x.cpu()) <= 1e-4


# ---- the irregular path: K13 (K14 its second name) and K12 ----


def _well(kind):
    if kind == "arrowhead":
        return arrowhead_spd(5000, seed=0)
    if kind == "fem":
        return fem_p1_system(20_000, seed=0)[0]
    if kind == "geometric_shuffled":
        return random_geometric_spd(30_000, seed=3, avg_degree=12.0, shuffle=True)[0]
    return random_geometric_spd(30_000, seed=0, avg_degree=12.0)[0]


@pytest.mark.parametrize("kind", ["fem", "geometric", "geometric_shuffled", "arrowhead"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_well_spmv_kernel_equals_plain(cuda_device, kind, dtype):
    # The same products and sums in the same order (each row's live slots
    # in ascending sublane), each rounded on its own: bit for bit; the
    # arrowhead's first row is longer than a tile.
    op = WellOperator.from_csr(_well(kind), storage_dtype=dtype, device=cuda_device)
    x2 = _rand(cuda_device, op.n_groups, 128, seed=2)
    args = (op.vals, op.lidx, op.gidl, op.wrow, op.sgb, x2, op.bg, op.nsg)
    y = well_spmv_cuda(*args)
    assert torch.equal(y, well_spmv_torch(*args))
    assert torch.equal(y, well_spmv_cuda(*args, index=op.rows))
    assert torch.equal(y, well_spmv_cuda(*args, index=op.rows))  # repeat
    assert torch.equal(y, well_spmv_fused_gather(*args))
    assert torch.equal(op.matvec(x2.reshape(-1)), y.reshape(-1)[: op.padded_n])
    for tile in (2, 64, 4096):  # other tilings, the same sums
        rows = well_rows(op.vals, op.lidx, op.gidl, op.wrow, op.sgb, op.bg, op.nsg, tile=tile)
        assert torch.equal(y, well_spmv_cuda(*args, index=rows))


def test_well_spmv_counts_and_flag(cuda_device):
    op = WellOperator.from_csr(_well("geometric"), device=cuda_device)
    x = _rand(cuda_device, op.padded_n, seed=1)
    before = (well_spmv_cuda.launches, well_spmv_torch.launches)
    op.matvec(x)
    well_spmv_fused_gather(op.vals, op.lidx, op.gidl, op.wrow, op.sgb,
                           x.reshape(-1, 128), op.bg, op.nsg)
    assert (well_spmv_cuda.launches - before[0], well_spmv_torch.launches - before[1]) == (2, 0)
    y = torch.full_like(x, 7.0)
    off = torch.zeros((), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    well_spmv_launch(op.rows, x, y, op.padded_n, off.data_ptr(), stream)
    assert bool((y == 7.0).all())
    # The operator's launch core writes rows [0, padded_n) and no further.
    big = torch.full((op.nsg * op.bg * 128 + 5,), 7.0, device=cuda_device)
    op.launcher()(x, big, torch.ones_like(off).data_ptr(), stream)
    assert torch.equal(big[: op.padded_n], op.matvec(x)) and bool((big[op.padded_n:] == 7.0).all())


def test_well_spmv_nan_reaches_only_the_rows_that_read_it(cuda_device):
    A = _well("geometric")
    op = WellOperator.from_csr(A, device=cuda_device)
    x = _rand(cuda_device, op.padded_n, seed=3)
    x[0] = float("nan")
    y = op.matvec(x)[: A.shape[0]].cpu().numpy()
    coo = A.to_coo()
    readers = np.zeros(A.shape[0], bool)
    readers[coo.row[(coo.col == 0) & (coo.data != 0)]] = True
    assert readers.any() and np.array_equal(np.isnan(y), readers)


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_cg_solve_on_well_runs_k13_on_card(cuda_device, pc):
    A, b, _ = random_geometric_spd(20_000, seed=4, avg_degree=12.0, shift=0.3)
    op = best_sparse_operator(A, device=cuda_device)
    assert isinstance(op, WellOperator) and op.backend == "cuda"
    tol = 1e-5 * float(np.linalg.norm(b))
    before = (well_spmv_cuda.launches, well_spmv_torch.launches)
    res = cg_solve(op, b, tol=tol, precondition=pc, maxiter=2000)
    assert well_spmv_cuda.launches > before[0] and well_spmv_torch.launches == before[1]
    plain = WellOperator(vals=op.vals, lidx=op.lidx, gidl=op.gidl, wrow=op.wrow, sgb=op.sgb,
                         dvec=op.dvec, n=op.n, bg=op.bg, nsg=op.nsg, backend="torch")
    ref = cg_solve(plain, b, tol=tol, precondition=pc, maxiter=2000, kernel="torch")
    assert bool(res.converged) and abs(int(res.iterations) - int(ref.iterations)) <= 1
    assert scaled_err(res.x.cpu(), ref.x.cpu()) <= 1e-4


def test_cg_solve_on_ell_and_bsr_on_card(cuda_device):
    from tpucg_torch.io.generator import poisson3d_csr
    from tpucg_torch.solver.operators import BsrOperator, EllOperator
    from tpucg_torch.sparse.formats import csr_to_bsr

    csr = poisson3d_csr(12)
    b = np.random.default_rng(0).standard_normal(csr.shape[0]).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    ell = EllOperator.from_csr(csr, device=cuda_device)
    bsr = BsrOperator.from_bsr(csr_to_bsr(csr, 8), device=cuda_device)
    dia = best_sparse_operator(csr, device=cuda_device)
    laps = [int(cg_solve(op, b, tol=tol, maxiter=1000, fused="never").iterations)
            for op in (ell, bsr, dia)]
    assert max(laps) - min(laps) <= 1


@pytest.mark.parametrize("pc", ["none", "jacobi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("battery", ["tpucg", "spectrum"])
def test_k12_matches_plain_on_card(cuda_device, pc, dtype, battery):
    if battery == "tpucg":
        data, offsets, b = banded_battery(64, 1024, seed=0)
        tol, laps = 1e-5, None
    else:
        data, offsets, b, laps = banded_spectrum_battery(64, 1024, seed=0)
        tol = 1e-2
    d = torch.as_tensor(data, device=cuda_device).to(dtype)
    bd = torch.as_tensor(b, device=cuda_device)
    z = torch.zeros_like(bd)
    kw = dict(tol=tol, maxiter=1024, precondition=pc)
    x, k, rr = fused_batch_dia_cg_solve_cuda(d, offsets, bd, z, **kw)
    xp, kp, _ = fused_batch_dia_cg_solve_torch(d, offsets, bd, z, **kw)
    if laps is None:
        assert int((k - kp).abs().max()) <= 1
    else:
        assert k.tolist() == kp.tolist() == laps
    assert bool((rr < tol ** 2).all()) and scaled_err(x.cpu(), xp.cpu()) <= 1e-4
    again = fused_batch_dia_cg_solve_cuda(d, offsets, bd, z, **kw)
    assert all(torch.equal(u, v) for u, v in zip((x, k, rr), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_k12_equals_the_emulation_bit_for_bit_on_card(cuda_device, pc, dtype):
    data, offsets, b = banded_battery(8, 256, seed=3)
    d = torch.as_tensor(data, device=cuda_device).to(dtype)
    bd = torch.as_tensor(b, device=cuda_device)
    z = torch.zeros_like(bd)
    kw = dict(tol=1e-5, maxiter=256, precondition=pc)
    want = batch_dia_cg_emulated(d.float().cpu().numpy(), offsets, b, np.zeros_like(b), 1e-5, 256,
                                 jacobi=pc == "jacobi")
    for w in (None,) + BATCH_DIA_WARPS:
        got = fused_batch_dia_cg_solve_cuda(d, offsets, bd, z, **kw,
                                            **({} if w is None else {"_plan": (w, True)}))
        for u, v in zip(got, want):
            assert np.array_equal(u.cpu().numpy(), v), (w, pc, dtype)


@pytest.mark.parametrize("shape", [(64, 1024, 3), (8, 2048, 5), (4, 128, 3), (3, 14464, 3)])
def test_k12_every_forced_plan_is_the_plans_bits_on_card(cuda_device, shape):
    nsys, n, ndiag = shape
    offsets = tuple(range(-(ndiag // 2), ndiag // 2 + 1))
    # One SPD band, scaled by a factor a system.
    data = random_banded_dia(n, offsets, seed=n)[1][None].repeat(nsys, 0)
    data = data * np.random.default_rng(n).uniform(0.8, 1.2, (nsys, 1, 1)).astype(np.float32)
    b = np.random.default_rng(n + 1).standard_normal((nsys, n)).astype(np.float32)
    d = torch.as_tensor(data, device=cuda_device)
    bd = torch.as_tensor(b, device=cuda_device)
    z = torch.zeros_like(bd)
    for pc in ("none", "jacobi"):
        kw = dict(tol=1e-5, maxiter=n, precondition=pc)
        ref = fused_batch_dia_cg_solve_cuda(d, offsets, bd, z, **kw)
        for w in BATCH_DIA_WARPS:
            for slab in (True, False):
                try:
                    batch_dia_warps_plan(nsys, n, ndiag, warps=w, slab=slab)
                except ValueError:
                    continue  # W above the virtual warps, or a slab that does not fit
                got = fused_batch_dia_cg_solve_cuda(d, offsets, bd, z, _plan=(w, slab), **kw)
                assert all(torch.equal(u, v) for u, v in zip(ref, got)), (shape, pc, w, slab)


@pytest.mark.parametrize("shape", [(256, 1024, 3, torch.float32), (256, 1024, 3, torch.bfloat16),
                                   (8, 256, 3, torch.float32), (5, 14464, 3, torch.float32),
                                   (100000, 128, 3, torch.float32), (64, 2048, 7, torch.bfloat16)])
def test_k12_library_plan_is_batch_dia_warps_plan(cuda_device, shape):
    nsys, n, ndiag, dtype = shape
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for w, slab in [(None, None)] + [(w, s) for w in BATCH_DIA_WARPS for s in (True, False)]:
        try:
            plan = batch_dia_warps_plan(nsys, n, ndiag, dtype, sms, warps=w, slab=slab)
        except ValueError:
            with pytest.raises(RuntimeError, match="fused_batch_dia_plan"):
                fused_batch_dia_plan(nsys, n, ndiag, dtype, (w, slab))
            continue
        forced = None if w is None else (w, slab)
        assert fused_batch_dia_plan(nsys, n, ndiag, dtype, forced) == (
            plan.warps, int(plan.regs), plan.systems, plan.grid, plan.threads, plan.smem_bytes,
            plan.pad, int(plan.slab), plan.sys_bytes), (shape, w, slab)


@pytest.mark.parametrize("n", [128, 1000, 4096, 14464])
def test_k12_sizes_and_cap_on_card(cuda_device, n):
    data, offsets, b = banded_battery(8, n, seed=1)
    before = fused_batch_dia_cg_solve_cuda.launches
    res = cg_solve_batch_banded(data, offsets, b, tol=1e-5, device=cuda_device)
    assert fused_batch_dia_cg_solve_cuda.launches == before + 1
    ref = cg_solve_batch_banded(data, offsets, b, tol=1e-5, device=cuda_device, fused="never")
    assert fused_batch_dia_cg_solve_cuda.launches == before + 1
    assert bool(res.converged.all()) and int((res.iterations - ref.iterations).abs().max()) <= 1
    assert scaled_err(res.x.cpu(), ref.x.cpu()) <= 1e-4


def test_k12_above_the_cap_runs_the_plain_loop(cuda_device):
    data, offsets, b = banded_battery(2, 14464 + 128, seed=2)
    before = (fused_batch_dia_cg_solve_cuda.launches, fused_batch_dia_cg_solve_torch.launches)
    res = cg_solve_batch_banded(data, offsets, b, tol=1e-5, device=cuda_device)
    assert (fused_batch_dia_cg_solve_cuda.launches, fused_batch_dia_cg_solve_torch.launches) \
        == before and bool(res.converged.all())


@pytest.mark.parametrize("route", ["poisson-ell", "poisson-bsr", "poisson-auto"])
def test_bench_sparse_forms_print_one_json_line(cuda_device, route):
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "tpucg_torch", "bench", "--operator", route,
                           "--m", "8", "--repeats", "5"], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == f"{route.replace('-', '_')}_cg_solve_time_m8" and line["value"] > 0


# ---- the distributed path: K7, K9 and one rank on NCCL --------------------------


def _halos(v, r, blk, pad, dev):
    zero = torch.zeros(pad, device=dev)
    lo = v[r * blk - pad:r * blk].contiguous() if r > 0 else zero
    hi = v[(r + 1) * blk:(r + 1) * blk + pad].contiguous() if (r + 1) * blk < v.numel() else zero
    return lo, hi


@pytest.mark.parametrize("m,P", [(64, 1), (64, 2), (64, 4), (10, 5), (2, 2), (33, 3)])
def test_k9_equals_plain_and_concatenates_to_k8(cuda_device, m, P):
    from tpucg_torch.kernels.stencil import poisson3d_slab_cuda, poisson3d_slab_torch

    mm = m * m
    u = _rand(cuda_device, m ** 3, seed=m)
    blk, parts = m ** 3 // P, []
    for r in range(P):
        lo, hi = _halos(u, r, blk, mm, cuda_device)
        ub = u[r * blk:(r + 1) * blk]
        y = poisson3d_slab_cuda(ub, lo, hi, m)
        assert torch.equal(y, poisson3d_slab_torch(ub, lo, hi, m))
        parts.append(y)
    assert torch.equal(torch.cat(parts), poisson3d_cuda(u, m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band,P", [("poisson32", 1), ("poisson32", 4), ("cross_row", 2),
                                    ("multi_row", 4)])
def test_k7_equals_plain_and_concatenates_to_k6(cuda_device, band, P, dtype):
    from tpucg_torch.kernels.spmv import dia_spmv_halo_cuda, dia_spmv_halo_torch, halo_length

    if band == "poisson32":
        dia = poisson3d_dia(32)
        offsets, data = tuple(int(o) for o in dia.offsets), np.asarray(dia.data, np.float32)
    else:
        offsets, data, _ = random_banded_dia(4096, BAND_SETS[band], seed=5)
    d = torch.as_tensor(data, device=cuda_device).to(dtype)
    x = _rand(cuda_device, d.shape[1], seed=P)
    pad, blk, parts = halo_length(offsets), d.shape[1] // P, []
    for r in range(P):
        lo, hi = _halos(x, r, blk, pad, cuda_device)
        db, xb = d[:, r * blk:(r + 1) * blk].contiguous(), x[r * blk:(r + 1) * blk]
        y = dia_spmv_halo_cuda(db, offsets, xb, lo, hi)
        assert torch.equal(y, dia_spmv_halo_torch(db, offsets, xb, lo, hi))
        parts.append(y)
    assert torch.equal(torch.cat(parts), dia_spmv_cuda(d, offsets, x))


def test_k7_k9_flag_and_checks_on_card(cuda_device):
    from tpucg_torch.kernels.spmv import dia_spmv_halo_cuda
    from tpucg_torch.kernels.stencil import poisson3d_slab_cuda

    u = _rand(cuda_device, 4 * 64)
    z = torch.zeros(64, device=cuda_device)
    off = torch.zeros((), dtype=torch.int32, device=cuda_device)
    before = poisson3d_slab_cuda.launches
    y = poisson3d_slab_cuda(u, z, z, 8)
    y0 = y.clone()
    poisson3d_slab_cuda(u + 1, z, z, 8, active=off)  # flag 0: returns at once
    assert poisson3d_slab_cuda.launches == before + 2 and torch.equal(y, y0)
    with pytest.raises(ValueError, match="halo_lo"):
        poisson3d_slab_cuda(u, z[:-1], z, 8)
    d = torch.ones(3, 256, device=cuda_device)
    with pytest.raises(ValueError, match="halos must be 128"):
        dia_spmv_halo_cuda(d, (-1, 0, 1), u, z, z)


@pytest.fixture
def nccl_one_rank(cuda_device):
    """This process as a world of one NCCL rank on the card."""
    from tpucg_torch.comm.mesh import init_distributed, make_mesh

    init_distributed(backend="nccl", device=cuda_device)
    yield make_mesh(device=cuda_device, backend="nccl")
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("case", ["dense_allgather", "dense_overlap", "poisson", "dia_f32",
                                  "dia_bf16", "ell"])
def test_one_nccl_rank_equals_the_serial_lap_path(nccl_one_rank, case):
    from tpucg_torch.io.generator import poisson3d_csr
    from tpucg_torch.kernels.spmv import dia_spmv_halo_cuda, dia_spmv_halo_torch
    from tpucg_torch.kernels.stencil import poisson3d_slab_cuda, poisson3d_slab_torch
    from tpucg_torch.solver.operators import EllOperator
    from tpucg_torch.solver.sharded import sharded_cg_solve, sharded_operator_cg_solve

    dev = nccl_one_rank.device
    counted = (matvec_cuda, dot_cuda, fused_update_cuda, poisson3d_slab_cuda, dia_spmv_halo_cuda)
    plain = (matvec_torch, dot_torch, fused_update_torch, poisson3d_slab_torch,
             dia_spmv_halo_torch)
    if case.startswith("dense"):
        A, b, x0 = generate_spd_system(1024, seed=1)
        want = cg_solve(A, b, x0, device=dev, fused="never", precondition="jacobi")
        before = [w.launches for w in counted + plain]
        got = sharded_cg_solve(A, b, x0, mesh=nccl_one_rank, strategy=case.split("_")[1],
                               precondition="jacobi")
        kernels = (matvec_cuda, dot_cuda, fused_update_cuda)
    else:
        m = 24
        xt = np.random.default_rng(2).standard_normal(m ** 3).astype(np.float32)
        b = poisson3d_csr(m).matvec(xt).astype(np.float32)
        op = {"poisson": lambda: PoissonOperator(m, device=dev),
              "dia_f32": lambda: DiaOperator.from_dia(poisson3d_dia(m), device=dev),
              "dia_bf16": lambda: DiaOperator.from_dia(poisson3d_dia(m), device=dev,
                                                       storage_dtype=torch.bfloat16),
              "ell": lambda: EllOperator.from_csr(poisson3d_csr(m), device=dev)}[case]()
        kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=2000, precondition="poly")
        want = cg_solve(op, b, fused="never", **kw)
        before = [w.launches for w in counted + plain]
        storage = torch.bfloat16 if case == "dia_bf16" else torch.float32
        got = sharded_operator_cg_solve(op, b, mesh=nccl_one_rank, storage_dtype=storage, **kw)
        kernels = (dot_cuda, fused_update_cuda) + (
            (poisson3d_slab_cuda,) if case == "poisson" else
            (dia_spmv_halo_cuda,) if case.startswith("dia") else ())
    torch.cuda.synchronize()
    after = dict(zip(counted + plain, [w.launches - n for w, n in zip(counted + plain, before)]))
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)
    assert all(after[k] > 0 for k in kernels) and all(after[p] == 0 for p in plain)


def test_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    from _torch_helpers import card_world_worker, run_world

    m = 16
    xt = np.random.default_rng(0).standard_normal(m ** 3).astype(np.float32)
    b = poisson3d_dia(m).matvec(xt).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=1000)
    got = run_world(2, card_world_worker, args=([("poisson", None), ("dia", None)], m, b, kw),
                    rendezvous=str(tmp_path / "world"), timeout_s=300)
    assert "pinned host memory" in got["mesh"]
    want = cg_solve(PoissonOperator(m, device=cuda_device), b, **kw)
    for case in (("poisson", None), ("dia", None)):
        r = got[case]
        assert r["converged"] and abs(r["laps"] - int(want.iterations)) <= 1
        assert scaled_err(r["x"], want.x.cpu().numpy()) <= 1e-4
        assert r["transport_calls"] > 0


# ---- the gather probes P1-P7 (benchmarks/probe_gather.py) -----------------------


def _probes(dev):
    from tpucg_torch.bench import probe_gather as drv

    return {p.pid: p for p in drv.PROBES}, drv.device_inputs(drv.probe_inputs(0), dev)


@pytest.mark.parametrize("pid", ["P1", "P2", "P3", "P4", "P5", "P6", "P7"])
def test_probe_kernel_equals_plain(cuda_device, pid):
    from tpucg_torch.kernels import probe_gather as kp

    probes, t = _probes(cuda_device)
    p = probes[pid]
    kernel, plain = getattr(kp, p.kernel), p.plain
    before = (kernel.launches, plain.launches)
    got = p.run(*p.args(t))
    torch.cuda.synchronize()
    assert (kernel.launches, plain.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, p.plain(*p.args(t)))  # data moved, P5 summed in k order
    assert torch.equal(got, p.run(*p.args(t)))


@pytest.mark.parametrize("shift", [5, 0, 1, 127, 128, 300, -3])
def test_roll_dyn_kernel_reads_its_shift_on_the_card(cuda_device, shift):
    from tpucg_torch.kernels.probe_gather import roll_dyn_cuda, roll_dyn_torch

    _, t = _probes(cuda_device)
    s = torch.tensor([shift], dtype=torch.int32, device=cuda_device)
    got = roll_dyn_cuda(s, t["V"])
    assert torch.equal(got, roll_dyn_torch(s, t["V"]))
    assert torch.equal(got, torch.roll(t["V"], shift, 1))


def test_probe_kernels_off_the_script_shapes(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    g = torch.Generator(device=cuda_device).manual_seed(4)
    v = torch.randn(37, 128, generator=g, device=cuda_device)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=cuda_device, dtype=torch.int32)

    cases = [
        (kp.lane_gather_cuda, kp.lane_gather_torch, (v, ints(128, 37, 128))),  # ragged block
        (kp.sub_gather_cuda, kp.sub_gather_torch, (v, ints(37, 5, 128))),
        (kp.row_gather_cuda, kp.row_gather_torch, (v, ints(37, 11))),
        (kp.elem_gather_cuda, kp.elem_gather_torch, (v.reshape(-1), ints(37 * 128, 333))),
        (kp.dynslice_cuda, kp.dynslice_torch, (ints(29, 1), v)),
        (kp.dynslice_cuda, kp.dynslice_torch, (ints(29, 1024), v)),
        (kp.roll_dyn_cuda, kp.roll_dyn_torch, (ints(1000, 1) - 500, v)),
    ]
    for kernel, plain, args in cases:
        assert torch.equal(kernel(*args), plain(*args)), kernel.__name__


def test_probe_wrappers_refuse_on_the_card(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    v = torch.zeros(8, 128, device=cuda_device)
    idx = torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        kp.lane_gather_cuda(v, idx)  # idx on the CPU
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp.row_gather_cuda(v.reshape(-1)[1:129].reshape(1, 128),
                           torch.zeros(1, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="must be a contiguous"):
        kp.roll_dyn_cuda(torch.zeros(1, dtype=torch.int64, device=cuda_device), v)


def test_probe_driver_on_the_card(cuda_device, capsys):
    from tpucg_torch.bench import probe_gather as drv

    assert drv.main([]) == 0
    out = capsys.readouterr().out
    for p in drv.PROBES:
        assert f"\n{p.pid} {p.name}" in out
    assert out.count("library rate,") == 2 and "ABOVE PEAK" not in out


# ---- P1/P7 a warp a row, 16 bytes a thread; P5 with every window in flight --------

def _lane_case(dev, rows, fill):
    g = torch.Generator(device=dev).manual_seed(rows)
    v = torch.randn(rows, 128, generator=g, device=dev)
    if fill is None:
        idx = torch.randint(0, 128, (rows, 128), generator=g, device=dev, dtype=torch.int32)
    else:  # every lane of a warp on one bank
        idx = torch.full((rows, 128), fill, dtype=torch.int32, device=dev)
    return v, idx


@pytest.mark.parametrize("fill", [None, 0, 127])
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_lane_gather_kernel_equals_plain_at_every_row_count(cuda_device, rows, fill):
    from tpucg_torch.kernels import probe_gather as kp

    v, idx = _lane_case(cuda_device, rows, fill)
    before = (kp.lane_gather_cuda.launches, kp.lane_gather_torch.launches)
    got = kp.lane_gather(v, idx)
    torch.cuda.synchronize()
    assert (kp.lane_gather_cuda.launches, kp.lane_gather_torch.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, kp.lane_gather_torch(v, idx))
    assert torch.equal(got, kp.lane_gather_cuda(v, idx))


@pytest.mark.parametrize("rows", [3, 8193, 65536])
def test_lane_gather_forced_plans_equal_plain(cuda_device, rows):
    # Every block width, a ragged last block among them.
    from tpucg_torch.kernels import probe_gather as kp

    v, idx = _lane_case(cuda_device, rows, None)
    want = kp.lane_gather_torch(v, idx)
    for warps in (1, 2, 4, 8, 16):
        plan = kp.LaneGatherPlan(rows, warps)
        got = kp.lane_gather_cuda(v, idx, _plan=plan)
        assert torch.equal(got, want), str(plan)
        assert torch.equal(got, kp.lane_gather_cuda(v, idx, _plan=plan)), str(plan)


def test_lane_gather_library_refuses_a_block_too_wide(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    v, idx = _lane_case(cuda_device, 64, None)
    with pytest.raises(RuntimeError):
        kp.lane_gather_cuda(v, idx, _plan=kp.LaneGatherPlan(64, kp.LG_MAX_WARPS + 1))


@pytest.mark.parametrize("nw", EDGE_NWS)
def test_dynslice_kernel_equals_plain_bit_for_bit(cuda_device, nw):
    from tpucg_torch.kernels import probe_gather as kp

    g = torch.Generator(device=cuda_device).manual_seed(nw)
    x2 = torch.randn(2048, 128, generator=g, device=cuda_device)
    w = torch.as_tensor(edge_windows(nw, 2048, nw), device=cuda_device)
    got = kp.dynslice_cuda(w, x2)
    assert torch.equal(got, kp.dynslice_torch(w, x2))
    assert torch.equal(got, kp.dynslice_cuda(w, x2))
    before = (kp.dynslice_cuda.launches, kp.dynslice_torch.launches)
    assert torch.equal(kp.dynslice(w, x2), got)  # through the dispatcher
    assert (kp.dynslice_cuda.launches, kp.dynslice_torch.launches) == (before[0] + 1, before[1])


def test_staged_probes_refuse_on_the_card(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    v = torch.zeros(8 * 128 + 4, device=cuda_device)
    off = v[1:1 + 8 * 128].view(8, 128)  # 4 bytes off a 16-byte boundary
    idx = torch.zeros(8, 128, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp.lane_gather_cuda(off, idx)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp.dynslice_cuda(torch.zeros(2, dtype=torch.int32, device=cuda_device), off)
    with pytest.raises(ValueError, match="a plan for 9 rows"):
        kp.lane_gather_cuda(v[:1024].view(8, 128), idx, _plan=kp.lane_gather_plan(9))


# ---- P2 staged (or direct above its cap); P6 a warp a row, rotated by shuffles ----


def _sub_case(dev, v_rows, m, fill, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(v_rows, 128, generator=g, device=dev)
    if fill is None:
        idx = torch.randint(0, v_rows, (m, 128), generator=g, device=dev, dtype=torch.int32)
    else:
        idx = torch.full((m, 128), fill, dtype=torch.int32, device=dev)
    return v, idx


@pytest.mark.parametrize("v_rows", SG_EDGE_VROWS)
def test_sub_gather_kernel_equals_plain_at_every_shape(cuda_device, v_rows):
    from tpucg_torch.kernels import probe_gather as kp

    for m in SG_EDGE_ROWS:
        for fill in (None, 0, v_rows - 1):
            v, idx = _sub_case(cuda_device, v_rows, m, fill, v_rows + m)
            before = (kp.sub_gather_cuda.launches, kp.sub_gather_torch.launches)
            got = kp.sub_gather(v, idx)
            torch.cuda.synchronize()
            assert (kp.sub_gather_cuda.launches, kp.sub_gather_torch.launches) == (
                before[0] + 1, before[1])
            what = f"{kp.sub_gather_plan(v_rows, m, kp._sms(v))}, rows {fill}"
            assert torch.equal(got, kp.sub_gather_torch(v, idx)), what
            assert torch.equal(got, kp.sub_gather_cuda(v, idx)), what


@pytest.mark.parametrize("v_rows,m", [(1, 3), (256, 256), (300, 1000), (2048, 8192),
                                      (7264, 33), (7265, 257)])
def test_sub_gather_forced_plans_equal_plain(cuda_device, v_rows, m):
    # Both forms below the cap, staged blocks of 1 ... 8 warps and runs
    # from one row to all of them; the direct form on 32 ... 256 threads.
    from tpucg_torch.kernels import probe_gather as kp

    v, idx = _sub_case(cuda_device, v_rows, m, None, m)
    want = kp.sub_gather_torch(v, idx)
    plans = [kp.SubGatherPlan(v_rows, m, 0, threads) for threads in (32, 96, 256)]
    if v_rows <= kp.SG_MAX_ROWS:
        plans += [kp.SubGatherPlan(v_rows, m, run, threads)
                  for run in sorted({1, 7, -(-m // 8), m}) for threads in (32, 64, 160, 256)]
    for plan in plans:
        got = kp.sub_gather_cuda(v, idx, _plan=plan)
        assert torch.equal(got, want), str(plan)
        assert torch.equal(got, kp.sub_gather_cuda(v, idx, _plan=plan)), str(plan)


def test_sub_gather_library_refuses_what_it_cannot_run(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    cap = kp.SG_MAX_ROWS
    v, idx = _sub_case(cuda_device, cap + 1, 4, None, 0)
    with pytest.raises(RuntimeError):  # a slab above 227 KB
        kp.sub_gather_cuda(v, idx, _plan=kp.SubGatherPlan(cap + 1, 4, 4, 256))
    for threads in (0, 48, 288):
        with pytest.raises(RuntimeError):
            kp.sub_gather_cuda(v, idx, _plan=kp.SubGatherPlan(cap + 1, 4, 0, threads))
    with pytest.raises(ValueError, match="a plan for v of"):
        kp.sub_gather_cuda(v, idx, _plan=kp.sub_gather_plan(cap, 4))


@pytest.mark.parametrize("rows", ROLL_EDGE_ROWS)
def test_roll_dyn_kernel_at_every_row_count_and_shift(cuda_device, rows):
    from tpucg_torch.kernels import probe_gather as kp

    x = torch.randn(rows, 128, generator=torch.Generator(device=cuda_device).manual_seed(rows),
                    device=cuda_device)
    for shift in ROLL_SHIFTS:
        s = torch.tensor([shift], dtype=torch.int32, device=cuda_device)
        before = (kp.roll_dyn_cuda.launches, kp.roll_dyn_torch.launches)
        got = kp.roll_dyn(s, x)
        torch.cuda.synchronize()
        assert (kp.roll_dyn_cuda.launches, kp.roll_dyn_torch.launches) == (
            before[0] + 1, before[1])
        assert torch.equal(got, kp.roll_dyn_torch(s, x)), shift
        assert torch.equal(got, torch.roll(x, shift, 1)), shift
        assert torch.equal(got, kp.roll_dyn_cuda(s, x)), shift


def test_sub_gather_and_roll_refuse_on_the_card(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    flat = torch.zeros(8 * 128 + 4, device=cuda_device)
    off = flat[1:1 + 8 * 128].view(8, 128)  # 4 bytes off a 16-byte boundary
    iflat = torch.zeros(8 * 128 + 4, dtype=torch.int32, device=cuda_device)
    ioff = iflat[1:1 + 8 * 128].view(8, 128)
    v, idx = flat[:1024].view(8, 128), iflat[:1024].view(8, 128)
    s = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = (kp.sub_gather_cuda.launches, kp.roll_dyn_cuda.launches)
    for call in (lambda: kp.sub_gather_cuda(off, idx), lambda: kp.sub_gather_cuda(v, ioff),
                 lambda: kp.roll_dyn_cuda(s, off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    assert (kp.sub_gather_cuda.launches, kp.roll_dyn_cuda.launches) == before
    with pytest.raises(ValueError, match="one CUDA device"):
        kp.roll_dyn_cuda(s.cpu(), v)


# ---- P3 and P4: every walk at every edge size, bit for bit ---------------------


@pytest.mark.parametrize("rows", RG_EDGE_ROWS)
def test_row_gather_kernel_at_every_size(cuda_device, rows):
    from tpucg_torch.kernels import probe_gather as kp

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x2 = torch.randn(2048, 128, generator=g, device=cuda_device)
    for ridx in index_cases(2048, (rows,), g, cuda_device):
        want = kp.row_gather_torch(x2, ridx)
        before = (kp.row_gather_cuda.launches, kp.row_gather_torch.launches)
        got = kp.row_gather(x2, ridx)
        torch.cuda.synchronize()
        assert (kp.row_gather_cuda.launches, kp.row_gather_torch.launches) == (
            before[0] + 1, before[1])
        assert torch.equal(got, want)
        assert torch.equal(got, kp.row_gather_cuda(x2, ridx))


@pytest.mark.parametrize("n", EG_EDGE_N + stream_edges(132))
def test_elem_gather_kernel_at_every_size_and_plan(cuda_device, n):
    from tpucg_torch.kernels import probe_gather as kp

    g = torch.Generator(device=cuda_device).manual_seed(n)
    xf = torch.randn(262144, generator=g, device=cuda_device)
    plans = [kp.ElemGatherPlan(n, False), kp.ElemGatherPlan(n, True)]
    for eidx in index_cases(xf.numel(), (n,), g, cuda_device):
        want = kp.elem_gather_torch(xf, eidx)
        before = (kp.elem_gather_cuda.launches, kp.elem_gather_torch.launches)
        got = kp.elem_gather(xf, eidx)
        torch.cuda.synchronize()
        assert (kp.elem_gather_cuda.launches, kp.elem_gather_torch.launches) == (
            before[0] + 1, before[1])
        assert torch.equal(got, want)
        for plan in plans:
            got = kp.elem_gather_cuda(xf, eidx, _plan=plan)
            assert torch.equal(got, want), str(plan)
            assert torch.equal(got, kp.elem_gather_cuda(xf, eidx, _plan=plan)), str(plan)


def test_elem_gather_kernel_at_fem_300k(cuda_device):
    """P4 at FEM 300k's CSR column indices (its default plan streams) and in
    both walks, bit-equal to plain and to its repeat."""
    from tpucg_torch.io.generator import fem_p1_system
    from tpucg_torch.kernels import probe_gather as kp

    A = fem_p1_system(300_000, seed=0)[0]
    xf = torch.randn(A.shape[0], generator=torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    eidx = torch.as_tensor(A.indices.astype(np.int32), device=cuda_device)
    assert kp.elem_gather_plan(eidx.numel(), kp._sms(xf)).stream
    want = kp.elem_gather_torch(xf, eidx)
    for plan in (None, kp.ElemGatherPlan(eidx.numel(), False),
                 kp.ElemGatherPlan(eidx.numel(), True)):
        got = kp.elem_gather_cuda(xf, eidx, _plan=plan)
        assert torch.equal(got, want), str(plan)
        assert torch.equal(got, kp.elem_gather_cuda(xf, eidx, _plan=plan)), str(plan)


def test_row_and_elem_gather_refuse_what_they_cannot_run(cuda_device):
    from tpucg_torch.kernels import probe_gather as kp

    x2 = torch.zeros(16, 128, device=cuda_device)
    ridx = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    before = (kp.row_gather_cuda.launches, kp.elem_gather_cuda.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp.row_gather_cuda(x2.reshape(-1)[1:1 + 8 * 128].view(8, 128), ridx)
    with pytest.raises(ValueError, match="CUDA device"):
        kp.row_gather_cuda(x2, ridx.cpu())
    xf, eidx = x2.reshape(-1), ridx
    with pytest.raises(ValueError, match="a plan for 6 elements"):
        kp.elem_gather_cuda(xf, eidx, _plan=kp.elem_gather_plan(6))
    with pytest.raises(ValueError, match="CUDA device"):
        kp.elem_gather_cuda(xf.cpu(), eidx)
    assert (kp.row_gather_cuda.launches, kp.elem_gather_cuda.launches) == before


# ---- M8 on the card: pipelined, CA, Chebyshev, block Jacobi, intervals --------

M8_CUDA = (matvec_cuda, dot_cuda, poisson3d_cuda, well_spmv_cuda, fused_update_cuda)
M8_PLAIN = (matvec_torch, dot_torch, poisson3d_torch, well_spmv_torch, fused_update_torch,
            dot_alpha_torch, lap_tail_torch, p_update_torch)


def _counted(fn):
    """fn() with the launch counts of the kernels and plain versions around
    it: (result, {name: launches of the kernels}, launches of the plain
    versions)."""
    before = {w: w.launches for w in M8_CUDA + M8_PLAIN}
    out = fn()
    torch.cuda.synchronize()
    moved = {w: w.launches - before[w] for w in before}
    return (out, {w.__name__: moved[w] for w in M8_CUDA},
            sum(moved[w] for w in M8_PLAIN))


def _m8_held(card, plain, laps):
    assert bool(card.converged) and bool(plain.converged)
    assert abs(int(card.iterations) - int(plain.iterations)) <= laps
    assert scaled_err(card.x.cpu().numpy(), plain.x.cpu().numpy()) <= 1e-4


@pytest.mark.parametrize("method, pc, laps", [
    ("pipelined", "none", 1), ("pipelined", "jacobi", 1), ("pipelined", "block_jacobi", 1),
    ("ca", "none", 3), ("chebyshev", "none", 8), ("chebyshev", "block_jacobi", 8),
    ("cg", "block_jacobi", 1),
])
def test_m8_dense_on_card_matches_plain(cuda_device, method, pc, laps):
    A, b, x0 = generate_spd_system(1000, seed=2)
    kw = dict(method=method, precondition=pc, pc_block_size=64, maxiter=2000,
              tol=1e-5 * float(np.linalg.norm(b)))
    op = DenseOperator.create(A, device=cuda_device)
    card, k, plain_runs = _counted(lambda: cg_solve(op, b, x0, **kw))
    plain = cg_solve(DenseOperator(A=op.A, n=op.n, backend="torch"), b, x0, kernel="torch",
                     **kw)
    _m8_held(card, plain, laps)
    assert k["matvec_cuda"] > 0 and k["dot_cuda"] > 0 and plain_runs == 0
    assert (k["fused_update_cuda"] > 0) == (method == "cg")
    assert card.x.device == cuda_device


@pytest.mark.parametrize("method, pc, laps", [
    ("pipelined", "none", 1), ("chebyshev", "none", 8), ("ca", "none", 3),
    ("cg", "block_jacobi", 1),
])
def test_m8_poisson_on_card_matches_plain(cuda_device, method, pc, laps):
    m = 24
    rng = np.random.default_rng(0)
    xt = torch.as_tensor(rng.standard_normal(m ** 3).astype(np.float32), device=cuda_device)
    b = poisson3d_torch(xt, m)
    kw = dict(method=method, precondition=pc, maxiter=4000, tol=1e-5 * float(b.norm()))
    op = PoissonOperator(m, device=cuda_device)
    if method == "chebyshev":  # one interval, reused
        from tpucg_torch.solver.cg import spectral_interval

        kw["interval"] = spectral_interval(op)[:2]
    card, k, plain_runs = _counted(lambda: cg_solve(op, b, **kw))
    plain = cg_solve(PoissonOperator(m, backend="torch", device=cuda_device), b,
                     kernel="torch", **kw)
    _m8_held(card, plain, laps)
    assert k["poisson3d_cuda"] > 0 and k["dot_cuda"] > 0 and plain_runs == 0
    true = float((b.double() - poisson3d_torch(card.x.double(), m)).norm() / b.double().norm())
    # Unpreconditioned pipelined CG has no residual replacement: its
    # recurrence drifts to a true residual near 1e-4 ||b|| (tpucg's too).
    assert true <= (2e-4 if (method, pc) == ("pipelined", "none") else 2e-5)


def test_m8_well_block_jacobi_on_card_matches_plain(cuda_device):
    import dataclasses

    A, b, _ = fem_p1_system(3000, seed=0)
    op = best_sparse_operator(A, device=cuda_device, pc_block_size=64)
    assert isinstance(op, WellOperator) and op.dblk.device == cuda_device
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4000, precondition="block_jacobi")
    card, k, plain_runs = _counted(lambda: cg_solve(op, b, **kw))
    plain = cg_solve(dataclasses.replace(op, backend="torch"), b, kernel="torch", **kw)
    assert bool(card.converged) and bool(plain.converged)
    assert abs(int(card.iterations) - int(plain.iterations)) <= 0.01 * int(plain.iterations) + 1
    assert k["well_spmv_cuda"] > 0 and k["fused_update_cuda"] > 0 and plain_runs == 0


@pytest.mark.parametrize("method", ["pipelined", "ca", "chebyshev"])
def test_m8_chunk_sizes_bit_identical_on_card(cuda_device, method):
    # A step enqueued after the stop (or past maxiter) changes nothing.
    A, b, x0 = generate_spd_system(1000, seed=4)
    kw = dict(method=method, tol=1e-5 * float(np.linalg.norm(b)), maxiter=500,
              precondition="jacobi" if method == "pipelined" else "none")
    runs = [cg_solve(A, b, x0, device=cuda_device, chunk=c, **kw) for c in (None, 1, 5, 64)]
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f


def test_m8_block_products_run_in_full_f32_on_card(cuda_device):
    # strict_f32 (the fixture) keeps the block products and CA's Gram
    # product off TF32: the card's block apply equals a float64 product to
    # f32 rounding.
    from tpucg_torch.solver.cg import block_jacobi_minv, make_block_precond

    assert not torch.backends.cuda.matmul.allow_tf32
    A, _, _ = generate_spd_system(1000, seed=3)
    op = DenseOperator.create(A, device=cuda_device)
    minv = block_jacobi_minv(op, 64)
    r = _rand(cuda_device, op.padded_n, seed=5)
    z = make_block_precond(minv, op.padded_n)(r)
    want = torch.bmm(minv.double(), r.double().reshape(-1, 64, 1)).reshape(-1)
    assert float((z.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# M9: the k-column forms K6 x k, K8 x k and K13 x k, and the multi-RHS,
# block, f64 and refinement solves on the card.

from tpucg_torch.kernels.gather_spmv import (  # noqa: E402
    TILE_MAX,
    well_spmv_multi_cuda,
    well_spmv_multi_launch,
    well_spmv_multi_torch,
)
from tpucg_torch.kernels.spmv import (  # noqa: E402
    dia_spmv_multi_cuda,
    dia_spmv_multi_torch,
)
from tpucg_torch.kernels.stencil import (  # noqa: E402
    poisson3d_multi_cuda,
    poisson3d_multi_torch,
)

M9_K = (1, 3, 8, 32, 33)


def _m9_columns_equal(Y, single, X):
    """Each column of Y equals the single-column kernel on X's column."""
    for j in range(X.shape[1]):
        assert torch.equal(Y[:, j], single(X[:, j].contiguous())), j


@pytest.mark.parametrize("k", M9_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, offsets", [(1000, (-7, -1, 0, 1, 7)), (129, (0,)),
                                        (4096, (-1000, -64, 0, 64, 1000))])
def test_m9_dia_multi_equals_plain_and_k6(cuda_device, k, dtype, n, offsets):
    _, data, _ = random_banded_dia(n, offsets, seed=k)
    data = torch.as_tensor(data, device=cuda_device).to(dtype)
    X = _rand(cuda_device, n, k, seed=k)
    Y = dia_spmv_multi_cuda(data, offsets, X)
    assert torch.equal(Y, dia_spmv_multi_torch(data, offsets, X))
    assert torch.equal(Y, dia_spmv_multi_cuda(data, offsets, X))
    _m9_columns_equal(Y, lambda x: dia_spmv_cuda(data, offsets, x), X)


@pytest.mark.parametrize("k", M9_K)
@pytest.mark.parametrize("m", [2, 3, 33, 64])
def test_m9_poisson_multi_equals_plain_and_k8(cuda_device, k, m):
    U = _rand(cuda_device, m ** 3, k, seed=m + k)
    Y = poisson3d_multi_cuda(U, m)
    assert torch.equal(Y, poisson3d_multi_torch(U, m))
    assert torch.equal(Y, poisson3d_multi_cuda(U, m))
    _m9_columns_equal(Y, lambda u: poisson3d_cuda(u, m), U)


# K13 x k's column counts: one thread a row's 4-column group (k % 4 == 0)
# or column, the lighter thread from 8 groups on (k = 32, 64; 8, 16 and 33
# scalar columns), and the long rows' passes of 32 columns (33, 64).
M9_WELL_K = (1, 2, 3, 4, 5, 8, 16, 32, 33, 64)


def _m9_well_op(kind, dev, dtype):
    A = {"geometric": lambda: random_geometric_spd(3000, seed=2)[0],
         "arrowhead": lambda: arrowhead_spd(5000, seed=1),
         "fem": lambda: fem_p1_system(2000, seed=0)[0]}[kind]()
    return WellOperator.from_csr(A, device=dev, storage_dtype=dtype)


def _m9_well_held(op, X):
    """K13 x k on X equals the plain version and its repeat bit for bit, and
    K13 column by column."""
    Y = op.matvec_multi(X)
    assert torch.equal(Y, well_spmv_multi_torch(op.rows, X, op.padded_n))
    assert torch.equal(Y, op.matvec_multi(X))
    _m9_columns_equal(Y, op.matvec, X)
    return Y


@pytest.mark.parametrize("k", M9_WELL_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["geometric", "arrowhead", "fem"])
def test_m9_well_multi_equals_plain_and_k13(cuda_device, k, dtype, kind):
    op = _m9_well_op(kind, cuda_device, dtype)
    assert op.rows.long_rows.numel() == (kind == "arrowhead")
    X = _rand(cuda_device, op.padded_n, k, seed=k)
    Y = _m9_well_held(op, X)
    # The largest tile: the arrowhead's long row is then the flat kernel's.
    big = well_rows(op.vals, op.lidx, op.gidl, op.wrow, op.sgb, op.bg, op.nsg, tile=TILE_MAX)
    assert big.long_rows.numel() == 0
    assert torch.equal(well_spmv_multi_cuda(big, X, op.padded_n), Y)


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["geometric", "arrowhead"])
def test_m9_well_multi_misaligned_x_takes_scalar_columns(cuda_device, k, dtype, kind):
    # X 4 bytes past a 16-byte boundary: a column a thread (V = 1) where the
    # aligned block takes 4; the same bits either way.
    op = _m9_well_op(kind, cuda_device, dtype)
    X = _rand(cuda_device, op.padded_n, k, seed=k + 1)
    buf = torch.empty(X.numel() + 1, dtype=torch.float32, device=cuda_device)
    Xm = buf[1:].view(op.padded_n, k)
    Xm.copy_(X)
    assert Xm.is_contiguous() and Xm.data_ptr() % 16 == 4
    assert torch.equal(_m9_well_held(op, Xm), _m9_well_held(op, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_m9_well_multi_long_rows_in_column_passes(cuda_device, dtype):
    # The arrowhead's first row (5,000 slots) with a small tile: long rows
    # of several chunks of products and, at k = 72, three passes of columns
    # (32, 32, 8); rows 1.. the flat kernel's.
    A = arrowhead_spd(5000, seed=1)
    op = WellOperator.from_csr(A, device=cuda_device, storage_dtype=dtype)
    rows = well_rows(op.vals, op.lidx, op.gidl, op.wrow, op.sgb, op.bg, op.nsg, tile=64)
    assert rows.long_rows.tolist() == [0]
    for k in (1, 32, 72):
        X = _rand(cuda_device, op.padded_n, k, seed=k)
        Y = well_spmv_multi_cuda(rows, X, op.padded_n)
        assert torch.equal(Y, well_spmv_multi_torch(rows, X, op.padded_n))
        assert torch.equal(Y, op.matvec_multi(X))


def test_m9_multi_kernels_flag_zero_write_nothing(cuda_device):
    from tpucg_torch.kernels.spmv import dia_spmv_multi_launch, offsets_array
    from tpucg_torch.kernels.stencil import poisson3d_multi_launch

    off = torch.zeros((), dtype=torch.int32, device=cuda_device)
    stream = cuda_stream(off)
    m, k = 16, 4
    U = _rand(cuda_device, m ** 3, k)
    Y = torch.full_like(U, 7.0)
    poisson3d_multi_launch(U, Y, m, off.data_ptr(), stream)
    _, data, _ = random_banded_dia(m ** 3, (-1, 0, 1), seed=0)
    data = torch.as_tensor(data, device=cuda_device)
    dia_spmv_multi_launch(data, offsets_array((-1, 0, 1)), U, Y, off.data_ptr(), stream)
    op = WellOperator.from_csr(random_geometric_spd(3000, seed=2)[0], device=cuda_device)
    Xw = _rand(cuda_device, op.padded_n, k)
    Yw = torch.full_like(Xw, 7.0)
    well_spmv_multi_launch(op.rows, Xw, Yw, op.padded_n, off.data_ptr(), stream)
    # The long rows' kernel too (the arrowhead's first row).
    oa = WellOperator.from_csr(arrowhead_spd(5000, seed=1), device=cuda_device)
    Xa = _rand(cuda_device, oa.padded_n, k)
    Ya = torch.full_like(Xa, 7.0)
    well_spmv_multi_launch(oa.rows, Xa, Ya, oa.padded_n, off.data_ptr(), stream)
    torch.cuda.synchronize()
    assert bool((Y == 7.0).all()) and bool((Yw == 7.0).all()) and bool((Ya == 7.0).all())


M9_CUDA = (matvec_cuda, dot_cuda, fused_update_cuda, p_update_cuda, dia_spmv_cuda,
           poisson3d_cuda, well_spmv_cuda, dia_spmv_multi_cuda, poisson3d_multi_cuda,
           well_spmv_multi_cuda)
M9_PLAIN = (matvec_torch, dot_torch, fused_update_torch, p_update_torch, dia_spmv_torch,
            poisson3d_torch, well_spmv_torch, dia_spmv_multi_torch, poisson3d_multi_torch,
            well_spmv_multi_torch)


def _m9_counted(fn):
    before = {w: w.launches for w in M9_CUDA + M9_PLAIN}
    out = fn()
    torch.cuda.synchronize()
    moved = {w.__name__: w.launches - before[w] for w in before}
    return out, moved


def _m9_operator(kind, dev, backend="auto"):
    if kind == "poisson":
        return PoissonOperator(16, backend=backend, device=dev)
    if kind == "dia":
        return DiaOperator.from_dia(poisson3d_dia(16), backend=backend, device=dev)
    A = random_geometric_spd(3000, seed=2)[0]
    return WellOperator.from_csr(A, backend=backend, device=dev, pc_block_size=16)


@pytest.mark.parametrize("kind, kernel", [("poisson", "poisson3d_multi_cuda"),
                                          ("dia", "dia_spmv_multi_cuda"),
                                          ("well", "well_spmv_multi_cuda")])
@pytest.mark.parametrize("solver, pc", [("multi", "none"), ("multi", "jacobi"),
                                        ("multi", "poly"), ("block", "none"),
                                        ("block", "block_jacobi"), ("block", "poly")])
def test_m9_solves_on_card_run_the_k_column_kernels(cuda_device, kind, kernel, solver, pc):
    from tpucg_torch.solver.cg import cg_solve_block, cg_solve_multi

    op = _m9_operator(kind, cuda_device)
    plain = _m9_operator(kind, cuda_device, backend="torch")
    rng = np.random.default_rng(0)
    B = np.zeros((op.n, 4), np.float32)
    B[:] = rng.standard_normal((op.n, 4))
    kw = dict(tol=1e-5 * float(np.linalg.norm(B[:, 0])), maxiter=2000, precondition=pc,
              pc_block_size=16)
    fn = cg_solve_multi if solver == "multi" else cg_solve_block
    card, moved = _m9_counted(lambda: fn(op, B, **kw))
    ref, moved_p = _m9_counted(lambda: fn(plain, B, kernel="torch", **kw))
    assert moved[kernel] > 0 and all(c == 0 for w, c in moved.items() if w.endswith("_torch"))
    assert all(c == 0 for w, c in moved_p.items() if w.endswith("_cuda"))
    assert bool(card.converged.all()) and bool(ref.converged.all())
    assert int((card.iterations - ref.iterations).abs().max()) <= 1
    assert scaled_err(card.x.cpu().numpy(), ref.x.cpu().numpy()) <= 1e-4


@pytest.mark.parametrize("solver", ["multi", "block"])
def test_m9_chunk_sizes_bit_identical_on_card(cuda_device, solver):
    from tpucg_torch.solver.cg import cg_solve_block, cg_solve_multi

    op = PoissonOperator(16, device=cuda_device)
    B = np.random.default_rng(1).standard_normal((op.n, 3)).astype(np.float32)
    fn = cg_solve_multi if solver == "multi" else cg_solve_block
    kw = dict(tol=1e-5 * float(np.linalg.norm(B[:, 0])), maxiter=500)
    runs = [fn(op, B, chunk=c, **kw) for c in (None, 1, 7, 64)]
    for r in runs[1:]:
        for f in ("x", "iterations", "residual_norm", "converged"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f


def test_m9_f64_solves_on_card_run_no_kernel(cuda_device):
    A, b, x0 = generate_spd_system(512, seed=3)
    res, moved = _m9_counted(lambda: cg_solve(A, b, x0, device=cuda_device,
                                              dtype=torch.float64, tol=1e-12))
    assert res.x.dtype == torch.float64 and res.x.device == cuda_device
    assert bool(res.converged) and all(c == 0 for w, c in moved.items() if w.endswith("_cuda"))
    resid = np.linalg.norm(b - A.astype(np.float64) @ res.x.cpu().numpy())
    assert resid < 1e-10
    op = PoissonOperator(16, device=cuda_device)
    bp = np.ones(op.n)
    rp, moved = _m9_counted(lambda: cg_solve(op, bp, dtype=torch.float64, tol=1e-10,
                                             maxiter=2000))
    assert bool(rp.converged) and rp.x.dtype == torch.float64
    assert all(c == 0 for w, c in moved.items() if w.endswith("_cuda"))
    with pytest.raises(ValueError, match="f64"):
        cg_solve(A, b, device=cuda_device, dtype=torch.float64, kernel="cuda")


def test_m9_ir_on_card_runs_k1_bf16_and_f32(cuda_device):
    from tpucg_torch.solver.ir import cg_solve_ir

    n = 1024
    A, b, x0 = generate_spd_system(n, seed=5)
    A = (A - (n - n / 32.0) * np.eye(n)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    res, moved = _m9_counted(lambda: cg_solve_ir(A, b, x0, tol=tol, device=cuda_device))
    assert bool(res.converged) and float(res.residual_norm) < tol
    assert moved["matvec_cuda"] > 0 and moved["dot_cuda"] > 0 and moved["fused_update_cuda"] > 0
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch"))
    plain = cg_solve_ir(A, b, x0, tol=tol, device=cuda_device, kernel="torch")
    assert bool(plain.converged)
    assert abs(int(res.iterations) - int(plain.iterations)) <= 4


# ---- M12: the guarded finish, two-level, deflation, MINRES -----------------

from _torch_helpers import alpha_emulated, lap_tail_emulated  # noqa: E402
from tpucg_torch.solver.cg import TRUE_CHECK_EVERY  # noqa: E402
from tpucg_torch.solver.deflation import RecyclingCG, cg_solve_deflated  # noqa: E402
from tpucg_torch.solver.minres import minres_solve  # noqa: E402
from tpucg_torch.solver.twolevel import build_two_level  # noqa: E402

F32_BITS = np.int32

def _m12_dot_cases(dev, n=8192):
    """(u, v) pairs whose dot is > 0, == 0, < 0 and NaN."""
    v = _rand(dev, n, seed=11)
    nan = v.clone()
    nan[17] = float("nan")
    return {"pos": (v, v), "zero": (torch.zeros_like(v), v), "neg": (-v, v), "nan": (nan, v)}


@pytest.mark.parametrize("case", ["pos", "zero", "neg", "nan"])
def test_m12_guarded_alpha_equals_the_emulation_on_card(cuda_device, case):
    u, v = _m12_dot_cases(cuda_device)[case]
    rsold = torch.tensor(1.7, device=cuda_device)
    pap, alpha = dot_alpha_cuda(u, v, rsold, True, guard=True)
    d = dot_emulated(u.cpu().numpy(), v.cpu().numpy())
    # A NaN sum's payload is the hardware's (0x7fffffff here, NumPy's
    # 0x7fc00000): NaN is compared as NaN, every other value bit for bit.
    assert (np.isnan(d) and np.isnan(float(pap))) or \
        np.float32(float(pap)).view(F32_BITS) == np.float32(d).view(F32_BITS)
    want = alpha_emulated(d, 1.7, 2)
    assert np.float32(float(alpha)).view(F32_BITS) == want.view(F32_BITS)
    assert _same_bits(alpha, alpha_torch(pap, rsold, True, True))
    again = dot_alpha_cuda(u, v, rsold, True, guard=True)
    assert _same_bits(pap, again[0]) and _same_bits(alpha, again[1])
    # Unguarded, the parent's rule: a negative p.Ap divides, a NaN passes.
    _, plain = dot_alpha_cuda(u, v, rsold, True)
    unguarded = alpha_emulated(d, 1.7, 1)
    assert (np.isnan(unguarded) and np.isnan(float(plain))) or \
        np.float32(float(plain)).view(F32_BITS) == unguarded.view(F32_BITS)


def _m12_tail(dev, tol2):
    s = CudaLapTail(dev)
    s.load(torch.tensor(3, dtype=torch.int32), torch.tensor(0.8), torch.tensor(0.9),
           torch.tensor(False), torch.tensor(tol2, device=dev), 100)
    return s


def _m12_tail_matches(s, want):
    assert int(s.k) == want["k"] and bool(s.done) == want["done"]
    assert bool(s.active) == want["active"] and bool(s.step) == want["step"]
    for name in ("rsold", "rslast", "beta"):
        assert np.float32(float(getattr(s, name))).view(F32_BITS) == \
            np.float32(want[name]).view(F32_BITS), name


@pytest.mark.parametrize("case", ["pos", "zero", "neg", "nan"])
@pytest.mark.parametrize("tol2", [-1.0, 1e-6], ids=["check_true", "tested"])
def test_m12_guarded_k3_tail_equals_the_emulation_on_card(cuda_device, case, tol2):
    u, v = _m12_dot_cases(cuda_device)[case]
    stream = cuda_stream(u)
    runs = []
    for _ in range(2):
        s = _m12_tail(cuda_device, tol2)
        s.rr.fill_(0.5)
        out = torch.empty((), device=cuda_device)
        dot_tail_launch(u, v, scratch_for(u), out, s.address, stream, guard=True)
        torch.cuda.synchronize()
        d = dot_emulated(u.cpu().numpy(), v.cpu().numpy())
        _m12_tail_matches(s, lap_tail_emulated(3, 0.8, False, 0.5, d, tol2, 100, True))
        plain = lap_tail_torch(LapTail(k=torch.tensor(3, dtype=torch.int32),
                                       rsold=torch.tensor(0.8), rslast=torch.tensor(0.9),
                                       done=torch.tensor(False), active=torch.tensor(True)),
                               torch.tensor(0.5), out.cpu(), torch.tensor(tol2), 100, True)
        assert _same_bits(s.rsold.cpu(), plain.rsold) and _same_bits(s.beta.cpu(), plain.beta)
        runs.append([t.clone() for t in (out, s.k, s.rsold, s.rslast, s.beta, s.step)])
        assert (np.isnan(d) and np.isnan(float(out))) or \
            np.float32(float(out)).view(F32_BITS) == np.float32(d).view(F32_BITS)
    assert all(_same_bits(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("case", ["pos", "zero"])
def test_m12_guarded_k2_tail_equals_the_emulation_on_card(cuda_device, case):
    # r' = r - alpha ap is exactly 0 for r = alpha ap with alpha a power of 2.
    n = 8192
    x, p, ap = (_rand(cuda_device, n, seed=s) for s in (21, 22, 23))
    r = 0.5 * ap if case == "zero" else _rand(cuda_device, n, seed=24)
    alpha = torch.tensor(0.5, device=cuda_device)
    s = _m12_tail(cuda_device, -1.0)
    xo, ro = x.clone(), r.clone()
    fused_update_tail_launch(xo, ro, p, ap, alpha, xo, ro, scratch_for(x), s.rr, s.address,
                             cuda_stream(x), guard=True)
    torch.cuda.synchronize()
    emu = fused_update_emulated(*(t.cpu().numpy() for t in (x, r, p, ap)), np.float32(0.5))
    assert np.array_equal(xo.cpu().numpy().view(F32_BITS), emu[0].view(F32_BITS))
    assert np.array_equal(ro.cpu().numpy().view(F32_BITS), emu[1].view(F32_BITS))
    assert (float(s.rr) == 0.0) == (case == "zero")
    _m12_tail_matches(s, lap_tail_emulated(3, 0.8, False, emu[2], emu[2], -1.0, 100, True))


def _m12_fem(dev, seed=1, n=6_000):
    A, b, _ = fem_p1_system(n, seed=seed)
    op = WellOperator.from_csr(A, device=dev)
    return A, b, op


@pytest.mark.parametrize("form", ["two_level", "multilevel", "pipelined"])
def test_m12_two_level_on_card_matches_the_plain_route(cuda_device, form):
    # K13, K3 and K2 (with the guarded finish) run; laps within one check
    # window of the plain route on the card; chunk sizes move no bit.
    A, b, op = _m12_fem(cuda_device)
    tol = 1e-3 * float(np.linalg.norm(b))
    kw = dict(coarse_max=64) if form == "multilevel" else {}
    tl = build_two_level(A, agg_size=8 if kw else 32, npad=op.padded_n, device=cuda_device, **kw)
    method = "pipelined" if form == "pipelined" else "cg"
    res, moved = _m9_counted(lambda: cg_solve(op, b, tol=tol, maxiter=4000, two_level=tl,
                                              method=method))
    assert bool(res.converged)
    assert moved["well_spmv_cuda"] > 0 and moved["dot_cuda"] > 0
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch"))
    if method == "cg":
        assert moved["fused_update_cuda"] > 0 and int(res.iterations) % TRUE_CHECK_EVERY == 0
        again = cg_solve(op, b, tol=tol, maxiter=4000, two_level=tl, chunk=5)
        assert _same_bits(again.x, res.x) and int(again.iterations) == int(res.iterations)

    def plain(t):
        if t.inner is None:
            return t
        return dataclasses.replace(t, coarse_op=dataclasses.replace(t.coarse_op,
                                                                    backend="torch"),
                                   inner=plain(t.inner))
    ref = cg_solve(dataclasses.replace(op, backend="torch"), b, tol=tol, maxiter=4000,
                   kernel="torch", two_level=plain(tl), method=method)
    assert bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= TRUE_CHECK_EVERY
    assert scaled_err(res.x.cpu().numpy(), ref.x.cpu().numpy()) <= 1e-3


def test_m12_recycling_builds_its_basis_on_k13xk_on_card(cuda_device):
    A, b, op = _m12_fem(cuda_device, seed=3, n=4_000)
    tl = build_two_level(A, agg_size=32, npad=op.padded_n, device=cuda_device)
    rec = RecyclingCG(op, max_vectors=2, tol=1e-3 * float(np.linalg.norm(b)), maxiter=4000,
                      two_level=tl)
    wave = np.sin(2 * np.pi * 3 * np.arange(len(b)) / len(b)) * np.abs(b).max()
    for t in range(3):
        res, moved = _m9_counted(lambda: rec.solve((b + 0.1 * t * wave).astype(np.float32)))
        assert bool(res.converged) or float(res.residual_norm) < 0.1 * np.linalg.norm(b)
        assert moved["well_spmv_multi_cuda"] > 0  # the basis's A W
    assert rec._basis.m == 2 and rec._basis.W.device == cuda_device


def test_m12_dense_deflation_on_card(cuda_device):
    rng = np.random.default_rng(0)
    n = 512
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[0.01, 0.02, 0.03], 1.0 + rng.uniform(0, 1, n - 3)])
    A = (0.5 * ((Q * lam) @ Q.T + ((Q * lam) @ Q.T).T)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    plain = cg_solve(A, b, device=cuda_device, tol=tol, maxiter=4 * n)
    res, moved = _m9_counted(lambda: cg_solve_deflated(A, b, Q[:, :3].astype(np.float32),
                                                       device=cuda_device, tol=tol,
                                                       maxiter=4 * n))
    assert bool(res.converged) and int(res.iterations) * 2 < int(plain.iterations)
    assert moved["matvec_cuda"] > 0 and moved["fused_update_cuda"] > 0
    ref = cg_solve_deflated(A, b, Q[:, :3].astype(np.float32), device=cuda_device, tol=tol,
                            maxiter=4 * n, kernel="torch")
    assert int(ref.iterations) == int(res.iterations)


@pytest.mark.parametrize("pc", ["none", "jacobi", "block_jacobi"])
def test_m12_minres_on_card_matches_the_plain_route(cuda_device, pc):
    # Dense jacobi MINRES keeps K1 (tpucg's "auto" would take XLA's GEMV).
    rng = np.random.default_rng(0)
    n = 512
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([-(1 + rng.uniform(0, 1, n // 2)), 1 + rng.uniform(0, 1, n // 2)])
    A = (Q * lam) @ Q.T
    if pc != "none":
        s = 10.0 ** rng.uniform(-0.5, 0.5, n)
        A = A * s[None, :] * s[:, None]
    A = (0.5 * (A + A.T)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=8 * n, precondition=pc,
              pc_block_size=64)
    res, moved = _m9_counted(lambda: minres_solve(A, b, device=cuda_device, **kw))
    assert bool(res.converged)
    assert moved["matvec_cuda"] > 0 and moved["dot_cuda"] > 0
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch"))
    ref = minres_solve(A, b, device=cuda_device, kernel="torch", **kw)
    assert bool(ref.converged)
    # Hundreds of f32 Lanczos laps: two summation orders (K1 and K3 against
    # torch.mv and torch.dot) end within 3% of each other.
    assert abs(int(res.iterations) - int(ref.iterations)) <= max(1, 3 * int(ref.iterations) // 100)


# ---- M13: the serial checkpoint; M14 step 1: sharded WELL ----------------------

from tpucg_torch.solver.checkpoint import cg_solve_checkpointed  # noqa: E402


@pytest.fixture
def fem300k_two_level(cuda_device):
    """FEM 300k (mesh order) promoted to WELL, with the two-level cycle of
    ``chip_smoke.py``'s phase 21 (agg 64, Chebyshev smoother)."""
    A, b, _ = fem_p1_system(300_000, seed=0)
    op = best_sparse_operator(A, device=cuda_device)
    tl = build_two_level(A, agg_size=64, npad=op.padded_n, smooth_degree=2, device=cuda_device)
    return A, b, op, tl


def test_m13_well_two_level_kill_and_resume_on_card(fem300k_two_level, tmp_path):
    # At 5e-2 ||b|| (above FEM 300k's f32 floor, ~1.9e-2): the segmented
    # solve, a solve killed at a segment boundary and resumed from its file,
    # and cg_solve take the same laps and x bit for bit; K13, K3 and K2 run,
    # no plain version.
    A, b, op, tl = fem300k_two_level
    assert isinstance(op, WellOperator)
    kw = dict(tol=5e-2 * float(np.linalg.norm(b)), maxiter=4000, two_level=tl)
    seg, moved = _m9_counted(lambda: cg_solve_checkpointed(op, b, segment_iters=32, **kw))
    k = int(seg.iterations)
    assert bool(seg.converged) and k % TRUE_CHECK_EVERY == 0 and k >= 2 * TRUE_CHECK_EVERY
    assert all(moved[w] > 0 for w in ("well_spmv_cuda", "dot_cuda", "fused_update_cuda"))
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch"))
    plain = cg_solve(op, b, **kw)
    assert int(plain.iterations) == k and _same_bits(plain.x, seg.x)
    ck = str(tmp_path / "fem.npz")
    kill = (k // 2) // TRUE_CHECK_EVERY * TRUE_CHECK_EVERY
    part = cg_solve_checkpointed(op, b, segment_iters=16, checkpoint_path=ck,
                                 **dict(kw, maxiter=kill))
    assert int(part.iterations) == kill and not bool(part.converged)
    res = cg_solve_checkpointed(op, b, segment_iters=32, checkpoint_path=ck, **kw)
    assert int(res.iterations) == k and _same_bits(res.x, seg.x)
    assert res.x.device == op.device


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_m14_one_nccl_rank_sharded_well_equals_the_serial_route(nccl_one_rank, pc, storage):
    # The shuffled geometric graph (one stored entry a diagonal): one rank's
    # WELL pack is the serial promotion's, so the sharded solve (K13 on the
    # gathered x, K3 and K2; the lap's tail and p's update in torch ops)
    # equals the serial lap route bit for bit.
    from tpucg_torch.solver.sharded import sharded_operator_cg_solve

    dev = nccl_one_rank.device
    A, b, _ = random_geometric_spd(50_000, seed=0, avg_degree=12.0, shuffle=True)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4000, precondition=pc)
    want = cg_solve(WellOperator.from_csr(A, device=dev, storage_dtype=storage), b, **kw)
    got, moved = _m9_counted(lambda: sharded_operator_cg_solve(
        A, b, mesh=nccl_one_rank, storage_dtype=storage, **kw))
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert _same_bits(got.x, want.x)
    assert all(moved[w] > 0 for w in ("well_spmv_cuda", "dot_cuda", "fused_update_cuda"))
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch") and w != "p_update_torch")


# ---- M14 steps 2-3: the methods, block Jacobi, multi-RHS and block CG on the mesh ----


from tpucg_torch.solver.cg import cg_solve_block, cg_solve_multi  # noqa: E402


def _m14s23_clean(moved):
    """No plain version ran but the sharded lap's tail and p's update."""
    return all(c == 0 for w, c in moved.items()
               if w.endswith("_torch") and w not in ("lap_tail_torch", "p_update_torch"))


@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
@pytest.mark.parametrize("kw", [
    {"method": "pipelined", "tol": 1e-4}, {"method": "ca", "s_step": 3},
    {"method": "chebyshev"}, {"precondition": "block_jacobi", "pc_block_size": 64},
    {"method": "pipelined", "precondition": "block_jacobi", "pc_block_size": 64, "tol": 1e-4},
], ids=["pipelined", "ca", "chebyshev", "block_jacobi", "pipelined_block_jacobi"])
def test_m14s23_one_nccl_rank_dense_methods_equal_serial(nccl_one_rank, strategy, kw):
    # One rank's closures are the serial solve's kernels on the same
    # operands (K1 on the gathered p, K3's partials gathered back): laps and
    # x bit for bit; block Jacobi's PCG adds K2.
    from tpucg_torch.solver.sharded import sharded_cg_solve

    dev = nccl_one_rank.device
    A, b, x0 = generate_spd_system(1024, seed=0)
    want = cg_solve(A, b, x0, device=dev, fused="never", **kw)
    got, moved = _m9_counted(lambda: sharded_cg_solve(A, b, x0, mesh=nccl_one_rank,
                                                      strategy=strategy, **kw))
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert _same_bits(got.x, want.x)
    assert moved["matvec_cuda"] > 0 and moved["dot_cuda"] > 0 and _m14s23_clean(moved)


@pytest.mark.parametrize("kind", ["poisson", "dia", "well"])
def test_m14s23_one_nccl_rank_operator_block_jacobi(nccl_one_rank, kind):
    # Block Jacobi from the rank's own blocks (Poisson's and DIA's DIA rows,
    # WELL's CSR) with K9, K7 or K13, equal to the serial lap route bit for
    # bit; pipelined on Poisson too (on the geometric graph its recurrence
    # drifts below tol 1e-5 ||b|| in both routes).
    from tpucg_torch.kernels.spmv import dia_spmv_halo_cuda
    from tpucg_torch.kernels.stencil import poisson3d_slab_cuda
    from tpucg_torch.solver.sharded import sharded_operator_cg_solve

    dev = nccl_one_rank.device
    if kind == "well":
        A, b, _ = random_geometric_spd(20_000, seed=1, avg_degree=12.0, shuffle=True)
        sharded_op, serial_op, kern = A, WellOperator.from_csr(A, device=dev,
                                                               pc_block_size=64), "well_spmv_cuda"
    else:
        m = 24
        b = poisson3d_dia(m).matvec(np.random.default_rng(3).standard_normal(m ** 3)
                                    .astype(np.float32)).astype(np.float32)
        sharded_op = serial_op = (PoissonOperator(m, device=dev) if kind == "poisson"
                                  else DiaOperator.from_dia(poisson3d_dia(m), device=dev))
        kern = "poisson3d_slab_cuda" if kind == "poisson" else "dia_spmv_halo_cuda"
    for method in ("cg", "pipelined") if kind == "poisson" else ("cg",):
        kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4000, method=method,
                  precondition="block_jacobi", pc_block_size=64)
        want = cg_solve(serial_op, b, fused="never", **kw)
        before = {w: w.launches for w in (poisson3d_slab_cuda, dia_spmv_halo_cuda)}
        got, moved = _m9_counted(lambda: sharded_operator_cg_solve(sharded_op, b,
                                                                   mesh=nccl_one_rank, **kw))
        moved.update({w.__name__: w.launches - c for w, c in before.items()})
        assert bool(got.converged) and int(got.iterations) == int(want.iterations), method
        assert _same_bits(got.x, want.x), method
        assert moved[kern] > 0 and moved["dot_cuda"] > 0 and _m14s23_clean(moved)


@pytest.mark.parametrize("kind", ["dense", "poisson", "well"])
def test_m14s23_one_nccl_rank_multi_and_block_equal_serial(nccl_one_rank, kind):
    # k = 8: the dense GEMM on the gathered block, Poisson's (halo, 8)
    # exchange and plain batched stencil, WELL's K13 x k over the rank's
    # layout; the rank-summed column dots and Grams of one rank are the
    # serial ones: multi-RHS laps and x bit for bit. Block CG's laps are
    # equal and x within 1e-5 of max |x|: its serial product takes the k x k
    # algebra's transposed views (cuBLAS sums those in another order), the
    # sharded one a contiguous gathered block.
    from tpucg_torch.solver.sharded import sharded_cg_solve_block, sharded_cg_solve_multi

    dev = nccl_one_rank.device
    rng = np.random.default_rng(4)
    if kind == "dense":
        A = generate_spd_system(1024, seed=2)[0]
        sharded_A, serial_A, tol = A, A, 1e-6
    elif kind == "poisson":
        sharded_A = serial_A = PoissonOperator(16, device=dev)
        tol = 1e-3
    else:
        A = random_geometric_spd(20_000, seed=1, avg_degree=12.0, shuffle=True)[0]
        sharded_A, serial_A, tol = A, WellOperator.from_csr(A, device=dev), 1e-2
    n = 1024 if kind == "dense" else (4096 if kind == "poisson" else 20_000)
    B = rng.standard_normal((n, 8)).astype(np.float32)
    kw = dict(tol=tol, maxiter=4000)
    for sharded, serial in ((sharded_cg_solve_multi, cg_solve_multi),
                            (sharded_cg_solve_block, cg_solve_block)):
        want = serial(serial_A, B, device=dev, **kw)
        got, moved = _m9_counted(lambda: sharded(sharded_A, B, mesh=nccl_one_rank, **kw))
        assert bool(got.converged.all()) and torch.equal(got.iterations.cpu(),
                                                         want.iterations.cpu()), sharded
        if sharded is sharded_cg_solve_multi:
            assert _same_bits(got.x, want.x)
        else:
            assert scaled_err(got.x.T.cpu().numpy(), want.x.T.cpu().numpy()) <= 1e-5
        assert _m14s23_clean(moved)
        if kind == "well":
            assert moved["well_spmv_multi_cuda"] > 0


def test_m14s23_pipelined_lap_is_one_rank_sum_on_card(nccl_one_rank):
    # The transport's calls over 32 more laps: a pipelined lap gathers p once
    # and sums its stacked dots in one rank_sum, a classic lap two.
    from tpucg_torch.solver.sharded import distribute_system, sharded_cg_solve

    mesh = nccl_one_rank
    system = distribute_system(*generate_spd_system(1024, seed=0), mesh)
    for method, per_lap in (("pipelined", 2), ("cg", 3)):
        calls = []
        for laps in (16, 48):
            mesh.stats.update(calls=0, seconds=0.0)
            sharded_cg_solve(system, mesh=mesh, method=method, tol=1e-30, maxiter=laps, chunk=16)
            calls.append(mesh.stats["calls"])
        assert calls[1] - calls[0] == 32 * per_lap, method


def test_m14s23_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    # chip_smoke.py's gloo world at small sizes: dense pipelined and block
    # Jacobi, the geometric graph's multi-RHS and block CG at k = 8 (K13 x k).
    from _torch_helpers import card_methods_worker, run_world

    A, b, x0 = generate_spd_system(1024, seed=0)
    A_g = random_geometric_spd(20_000, seed=0, avg_degree=12.0)[0]
    B = np.random.default_rng(0).standard_normal((20_000, 8)).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(B[:, 0])), maxiter=2000)
    cases = [("dense", {"method": "pipelined", "tol": 1e-4}),
             ("dense", {"precondition": "block_jacobi", "pc_block_size": 64}),
             ("multi", kw), ("block", kw)]
    got = run_world(2, card_methods_worker, args=(cases, 0, 1024, 20_000, "cuda:0"),
                    rendezvous=str(tmp_path / "world"), timeout_s=300)
    op_g = WellOperator.from_csr(A_g, device=cuda_device)
    refs = [cg_solve(A, b, x0, device=cuda_device, **cases[0][1]),
            cg_solve(A, b, x0, device=cuda_device, **cases[1][1]),
            cg_solve_multi(op_g, B, **kw), cg_solve_block(op_g, B, **kw)]
    for i, ref in enumerate(refs):
        r = got[i]
        assert r["converged"].all() and bool(ref.converged.all()), i
        assert np.abs(r["laps"].reshape(-1) - ref.iterations.cpu().numpy().reshape(-1)).max() <= 1
        x = r["x"].reshape(r["x"].shape[0], -1).T
        assert scaled_err(x, ref.x.reshape(ref.x.shape[0], -1).T.cpu().numpy()) <= 1e-4, i
    assert got[2]["launches"]["well_spmv_multi_cuda"] > 0
    assert got["per_lap"]["pipelined"][0] == 2 and got["per_lap"]["cg"][0] == 3


# ---- M14 steps 4-5: host-sharded loading and M12 on the mesh ------------------


def _m14s45_fem_files(tmp_path, n=20_000):
    """An indexed general .mtx of fem_p1_system(n, seed=0) and its b (.npy)."""
    from tpucg_torch.io.generator import fem_p1_system
    from tpucg_torch.io.mmio import build_mm_index, save_matrix_market

    A, b, _ = fem_p1_system(n, seed=0)
    paths = {"fem": str(tmp_path / "fem.mtx"), "fem_b": str(tmp_path / "fem_b.npy")}
    save_matrix_market(paths["fem"], A, symmetric=False)
    build_mm_index(paths["fem"])
    np.save(paths["fem_b"], b)
    return A, b, paths


@pytest.mark.parametrize("fmt", ["txt", "npy"])
@pytest.mark.parametrize("strategy", ["allgather", "overlap"])
def test_m14s45_host_sharded_dense_load_on_card(nccl_one_rank, tmp_path, fmt, strategy):
    # The rank's block parsed from its own rows (the range parser on text, a
    # memory map on .npy) is distribute_system's; its solve is the whole
    # system's bit for bit (K1, K3).
    from tpucg_torch.io.textio import save_array
    from tpucg_torch.solver.sharded import (
        distribute_system,
        load_system_sharded,
        sharded_cg_solve,
    )

    A, b, x0 = generate_spd_system(500, seed=1)
    pa, pb, px = (str(tmp_path / f) for f in (f"A.{fmt}", "b.txt", "x0.txt"))
    save_array(pa, A, fmt="%r") if fmt == "txt" else np.save(pa, A)
    save_array(pb, b, fmt="%r")
    save_array(px, x0, fmt="%r")
    got = load_system_sharded(pa, pb, px, mesh=nccl_one_rank, strategy=strategy)
    want = distribute_system(A, b, x0, nccl_one_rank, strategy=strategy)
    assert got.A.device == nccl_one_rank.device and got.part == want.part
    for f in ("A", "b", "x0"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    res, moved = _m9_counted(lambda: sharded_cg_solve(got, mesh=nccl_one_rank,
                                                      strategy=strategy))
    ref = sharded_cg_solve(A, b, x0, mesh=nccl_one_rank, strategy=strategy)
    assert bool(res.converged) and int(res.iterations) == int(ref.iterations)
    assert _same_bits(res.x, ref.x)
    assert moved["matvec_cuda"] > 0 and moved["dot_cuda"] > 0 and _m14s23_clean(moved)


def test_m14s45_host_sharded_well_on_card(nccl_one_rank, tmp_path):
    # One rank reads the whole file's rows and packs what csr_to_well_sharded
    # packs; its Jacobi solve is the CSR route's bit for bit (K13); the
    # two-level cycle built from the parts solves with K13 and K3.
    from tpucg_torch.solver.sharded import load_well_system_sharded, sharded_operator_cg_solve
    from tpucg_torch.sparse.well import csr_to_well_sharded

    A, b, paths = _m14s45_fem_files(tmp_path)
    ws = load_well_system_sharded(paths["fem"], paths["fem_b"], mesh=nccl_one_rank,
                                  two_level_agg=64, smooth_degree=2)
    stacked, _ = csr_to_well_sharded(A, 1)
    for i, k in enumerate(("vals", "lidx", "gidl", "wrow", "sgb")):
        assert np.array_equal(ws.block.arrays[i].cpu().numpy(), stacked[k][0]), k
    assert ws.two_level.device == nccl_one_rank.device
    nb = float(np.linalg.norm(b))
    kw = dict(precondition="jacobi", tol=1e-4 * nb, maxiter=4000)
    got, moved = _m9_counted(lambda: sharded_operator_cg_solve(ws, mesh=nccl_one_rank, **kw))
    want = sharded_operator_cg_solve(A, b, mesh=nccl_one_rank, **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert _same_bits(got.x, want.x)
    assert moved["well_spmv_cuda"] > 0 and _m14s23_clean(moved)
    got, moved = _m9_counted(lambda: sharded_operator_cg_solve(
        ws, mesh=nccl_one_rank, two_level=ws.two_level, tol=2e-3 * nb, maxiter=4000))
    assert int(got.iterations) % 16 == 0 and int(got.iterations) < int(want.iterations)
    assert moved["well_spmv_cuda"] > 0 and moved["dot_cuda"] > 0 and _m14s23_clean(moved)


@pytest.mark.parametrize("method,coarse_max", [("cg", None), ("pipelined", None), ("cg", 64)],
                         ids=["two_level", "two_level_pipelined", "multilevel"])
def test_m14s45_two_level_equals_serial_on_card(nccl_one_rank, method, coarse_max):
    # One rank's WELL pack, aggregates and gathered coarse residual are the
    # serial cycle's: laps and x bit for bit (K13, K3; the multilevel
    # hierarchy's coarse operator on its own kernel, with local dots).
    from tpucg_torch.solver.sharded import sharded_operator_cg_solve
    from tpucg_torch.solver.twolevel import build_two_level

    dev = nccl_one_rank.device
    A, b, _ = random_geometric_spd(20_000, seed=2, avg_degree=12.0, shift=0.05)
    op = WellOperator.from_csr(A, device=dev)
    tl = build_two_level(A, agg_size=16 if coarse_max else 64, npad=op.padded_n,
                         coarse_max=coarse_max, device=dev)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=2000, method=method, two_level=tl)
    want = cg_solve(op, b, **kw)
    got, moved = _m9_counted(lambda: sharded_operator_cg_solve(A, b, mesh=nccl_one_rank, **kw))
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert _same_bits(got.x, want.x)
    assert moved["well_spmv_cuda"] > 0 and moved["dot_cuda"] > 0 and _m14s23_clean(moved)


def test_m14s45_deflation_recycling_minres_ir_on_card(nccl_one_rank):
    # Each against its serial solve on the card: laps equal, x within 1e-5
    # of max |x| (the sharded deflation keeps tpucg's explicit (W^T A W)^-1,
    # the serial one an A-orthonormal W); MINRES bit for bit; IR's inner
    # laps on K1's bf16 form, its residual on K1's f32 form.
    from _torch_helpers import _clustered_spd
    from tpucg_torch.solver.deflation import (
        RecyclingCG,
        cg_solve_deflated,
        sharded_cg_solve_deflated,
    )
    from tpucg_torch.solver.ir import cg_solve_ir, sharded_cg_solve_ir
    from tpucg_torch.solver.minres import minres_solve, sharded_minres_solve

    mesh, dev = nccl_one_rank, nccl_one_rank.device
    A, V = _clustered_spd(n=512, seed=0)
    b = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=2048)
    got, moved = _m9_counted(lambda: sharded_cg_solve_deflated(A, b, V, mesh=mesh, **kw))
    want = cg_solve_deflated(A, b, V, device=dev, **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert scaled_err(got.x.cpu().numpy(), want.x.cpu().numpy()) <= 1e-5
    assert moved["matvec_cuda"] > 0 and _m14s23_clean(moved)
    op = PoissonOperator(16, device=dev)
    bp = np.random.default_rng(2).standard_normal(16 ** 3).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(bp)), maxiter=1000)
    rec, rec_s = RecyclingCG(op, mesh=mesh, **kw), RecyclingCG(op, **kw)
    for t in range(3):
        bt = (bp * (1.0 + 0.1 * t)).astype(np.float32)
        got, want = rec.solve(bt), rec_s.solve(bt)
        assert bool(got.converged) and int(got.iterations) == int(want.iterations), t
        assert scaled_err(got.x.cpu().numpy(), want.x.cpu().numpy()) <= 1e-5
    A, b, x0 = generate_spd_system(512, seed=3)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), precondition="jacobi")
    got, moved = _m9_counted(lambda: sharded_minres_solve(A, b, x0, mesh=mesh, **kw))
    want = minres_solve(A, b, x0, device=dev, **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert _same_bits(got.x, want.x) and moved["matvec_cuda"] > 0 and _m14s23_clean(moved)
    A_ir = (A - (512 - 16.0) * np.eye(512, dtype=np.float32)).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)))
    bf16 = matvec_cuda.bf16_launches
    got, moved = _m9_counted(lambda: sharded_cg_solve_ir(A_ir, b, mesh=mesh, **kw))
    bf16 = matvec_cuda.bf16_launches - bf16
    want = cg_solve_ir(A_ir, b, device=dev, **kw)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert _same_bits(got.x, want.x)
    assert 0 < bf16 < moved["matvec_cuda"] and _m14s23_clean(moved)


def test_m14s45_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    # chip_smoke.py's gloo world at small sizes: each rank reads about half
    # of the .mtx; the two-level cycle adds its matvecs' gathers and one
    # coarse gather a lap; MINRES and IR take one rank's laps.
    from _torch_helpers import card_m14s45_worker, run_world
    from tpucg_torch.comm.mesh import init_distributed, make_mesh
    from tpucg_torch.io.mmio import mm_index_path
    from tpucg_torch.solver.ir import sharded_cg_solve_ir
    from tpucg_torch.solver.minres import sharded_minres_solve

    A, b, paths = _m14s45_fem_files(tmp_path)
    nb = float(np.linalg.norm(b))
    fem_kw = dict(two_level_agg=64, smooth_degree=2, tol=2e-3 * nb, maxiter=4000)
    got = run_world(2, card_m14s45_worker, args=(paths, fem_kw, 512, "cuda:0"),
                    rendezvous=str(tmp_path / "world"), timeout_s=300)
    with np.load(mm_index_path(paths["fem"])) as z:
        data = int(z["row_offsets"][-1] - z["row_offsets"][0])
    assert sum(got["bytes_read"]) == data
    assert all(0.4 < r / data < 0.6 for r in got["bytes_read"])
    assert got["two_level"]["converged"] and got["two_level"]["launches"]["well_spmv_cuda"] > 0
    assert got["per_lap"]["two_level"][0] - got["per_lap"]["jacobi"][0] == 5 + 2 / 16
    init_distributed(backend="nccl", device=cuda_device)
    mesh = make_mesh(device=cuda_device, backend="nccl")
    try:
        Ad, bd, _ = generate_spd_system(512, seed=0)
        tol = 1e-5 * float(np.linalg.norm(bd))
        refs = {"minres": sharded_minres_solve(Ad, bd, mesh=mesh, precondition="jacobi",
                                               tol=tol),
                "ir": sharded_cg_solve_ir((Ad - (512 - 16.0) * np.eye(512, dtype=np.float32))
                                          .astype(np.float32), bd, mesh=mesh, tol=tol)}
    finally:
        torch.distributed.destroy_process_group()
    for label, ref in refs.items():
        r = got[label]
        assert r["converged"] and r["laps"] == int(ref.iterations), label
        assert scaled_err(r["x"], ref.x.cpu().numpy()) <= 1e-4, label


# ---- M15: the CLI's last parts and the dry-run entry points on the card ---------


def test_m15_bench_json_lines_then_the_metric_line(cuda_device, capsys):
    # With --json every arm's report is a JSON line on stdout, then the
    # metric line, last; without it stdout is the metric line alone.
    import json

    from tpucg_torch import cli

    assert cli.main(["bench", "--n", "1024", "--repeats", "5", "--json"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(ln) for ln in lines]
    assert len(rows) == 2 and rows[-1]["metric"] == "dense_cg_solve_time_n1024"
    A, b, x0 = generate_spd_system(1024, seed=0)
    want = cg_solve(A, b, x0, device=cuda_device)
    assert rows[0]["iterations"] == int(want.iterations) and rows[0]["strategy"] == "serial"
    assert cli.main(["bench", "--n", "1024", "--repeats", "5", "--tol", "1e-3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["metric"] == "dense_cg_solve_time_n1024"


def test_m15_bench_json_poisson_iterations_are_the_librarys(cuda_device, capsys):
    import json

    from tpucg_torch import cli

    assert cli.main(["bench", "--operator", "poisson-free", "--m", "32", "--repeats", "5",
                     "--json"]) == 0
    rep, metric = (json.loads(ln) for ln in capsys.readouterr().out.splitlines())
    op, b, _, _ = cli._poisson_system("poisson-free", 32, torch.float32, "auto", cuda_device)
    want = cg_solve(op, b, tol=1e-5 * float(np.linalg.norm(b)), maxiter=4 * op.n)
    assert rep["iterations"] == int(want.iterations) and rep["nnz"] == 7 * 32 ** 3 - 6 * 32 * 32
    assert metric["metric"] == "poisson_free_cg_solve_time_m32"


@pytest.mark.parametrize("strategy", ["serial", "allgather"])
def test_bench_caps_a_dense_solve_at_4n_laps_on_card(cuda_device, capsys, strategy):
    # tpucg's bench caps every arm at 4 n laps: at a tol that n = 256 cannot
    # reach, the serial arm (K4) and one NCCL rank's take 1024 laps.
    import json

    from tpucg_torch import cli

    argv = ["bench", "--n", "256", "--tol", "1e-30", "--repeats", "5", "--json",
            "--strategy", strategy]
    assert cli.main(argv + ([] if strategy == "serial" else ["--devices", "1"])) == 0
    rep = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rep["strategy"] == strategy and rep["n"] == 256
    assert rep["iterations"] == 4 * 256 and not rep["residual_norm"] <= 1e-30


def test_m15_numpy_fed_solve_runs_on_the_card(cuda_device):
    # device=None is the card: numpy data goes there and runs K1, K3 and K2.
    A, b, x0 = generate_spd_system(8192, seed=0)
    res, moved = _m9_counted(lambda: cg_solve(A, b, x0))
    assert res.x.device == cuda_device and bool(res.converged)
    assert moved["matvec_cuda"] > 0 and moved["dot_cuda"] > 0 and moved["fused_update_cuda"] > 0
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch"))


def test_m15_entry_runs_the_lap_kernels(cuda_device):
    from tpucg_torch.dryrun import entry

    fn, args = entry()
    assert args[0].device == cuda_device
    (x, k, rnorm), moved = _m9_counted(lambda: fn(*args))
    assert x.shape == (1024,) and int(k) >= 1 and float(rnorm) < 1e-5
    assert moved["matvec_cuda"] > 0 and moved["dot_cuda"] > 0 and moved["fused_update_cuda"] > 0
    assert all(c == 0 for w, c in moved.items() if w.endswith("_torch"))


def test_m15_deflate_and_debug_nans_on_card(cuda_device, tmp_path, capsys):
    from tpucg_torch import cli
    from tpucg_torch.io.textio import load_vector, save_array

    A, b, x0 = generate_spd_system(512, seed=2)
    x_star = oracle_cg(A, b, x0)[0]
    V = np.stack([x_star, b], axis=1).astype(np.float32)
    pa, pb, pv, px = (str(tmp_path / f) for f in ("A.npy", "b.txt", "V.npy", "x.txt"))
    np.save(pa, A)
    save_array(pb, b, fmt="%r")
    np.save(pv, V)
    tol = 1e-5 * float(np.linalg.norm(b))
    assert cli.main(["solve", pa, pb, "--deflate", pv, "--tol", repr(tol), "--output", px]) == 0
    out = capsys.readouterr().out
    want = cg_solve_deflated(A, b, V, device=cuda_device, tol=tol)
    assert f"iterations           : {int(want.iterations)}" in out and int(want.iterations) <= 2
    np.testing.assert_array_equal(load_vector(px, n=512), want.x.cpu().numpy())
    bn = b.copy()
    bn[7] = np.nan
    save_array(pb, bn, fmt="%r")
    with pytest.raises(FloatingPointError, match="not finite"):
        cli.main(["solve", pa, pb, "--debug-nans", "--maxiter", "16"])
