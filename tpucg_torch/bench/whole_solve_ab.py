"""Parent against change for the whole-solve kernels K4, K5, K10, K11 and
K12, the stencil kernels K8 and K9, K2 and K3, the lap routes and the
probes P1-P7 on one card: the same cases run from two
checkouts of the package in turns (parent, change, change, parent), each
run in a process of its own that builds that checkout's kernels, and the
results set side by side.

    python tpucg_torch/bench/whole_solve_ab.py PARENT_ROOT CHANGE_ROOT [--only K5]

Run it by path, not with ``-m``: a run's process gets its checkout's root as
``PYTHONPATH`` and working directory, so ``tpucg_torch`` is that
checkout's, and it calls only entry points both checkouts have. The solve
cases: K4 at n = 1000, 2048 and 4096 (``generate_spd_system``, seed 0, tol
1e-6) with precondition none, jacobi and poly (degree 3); K5 on the circulant
batches of ``chip_smoke.py`` phase 8 (``tests/_torch_helpers.py``
``circulant_spd_batch``, seed 100, tol 1e-2, identity-padded) at 64 x
1000, 16 x 2048 and 256 x 512 with none and jacobi; K10 at m = 128 with
none and poly; K11 at m = 128, f32 and bf16 slabs, none, jacobi and poly;
the lap routes (``lap_route``: ``lap_ops`` and ``cg_loop`` as ``cg_solve``
runs them with ``fused="never"``): "K8 lap route" (``PoissonOperator(128)``)
and "lap K6" (its DIA form, f32), all on tpucg's Poisson bench system (tol
1e-5 ||b||, x0 = 0), "lap dense n=8192" (the reference's system, tol 1e-6,
none, jacobi and poly) and "lap FEM 300k jacobi" (``fem_p1_system(300_000,
seed=0)`` through ``best_sparse_operator``, K13, tol 1e-5 ||b||), each
also with its busy share, device ops and kernel launches a lap (one
profiled solve over the laps its chunks enqueued); K12 on tpucg's battery of 256 tridiagonal systems
of n = 1024 (``tests/_torch_helpers.py`` ``banded_battery``, seed 0, tol
1e-5, x0 = 0), f32 and bf16 slabs, none and jacobi. For each it prints the
laps and the median ms of 5 solves (CUDA events, after one warm-up) of the
four runs, and for K4 and K12 also the queued device ms (calls queued
behind a spin kernel, ``bench.timing.device_timing``) and the host ms a
call (the wrapper's own work, timed while a spin kernel holds the card).
K3 and K2 at n =
8192 through their launch cores (one scratch), µs a call queued, with
``torch.dot`` beside K3. The lap cases ("K4
lap"): K4 at n = 1000, 2048 and 4096, none, jacobi and poly, at tol = 0
(no lap passes the stopping test), µs a lap as the slope of the queued
device time between maxiter = 8 and 40 and the intercept (launch and
set-up); their x is not compared. The kernel
cases: K8 at m = 64, 100, 128, 192 and 256 and K9 at m = 128 on the slabs
of P = 1, 2 and 4 ranks (rank 0 and rank P // 2, halos cut from u), u
standard normal (``default_rng(m)``); for each, µs a launch warm (queued
calls on one u) and cold (rotating over 8 copies of the operands). Then,
for every case, whether x (a kernel's y) and the laps of parent and change
are bit-identical, the largest |x_change - x_parent| over max |x_parent|,
and whether each checkout repeats itself bit for bit; then the card's name
and power limit. The probe cases, on ``probe_inputs(0)`` through the
checked wrappers (their default plans): "P1" (256 x 128), "P2" at the
script's shape, at 8192 idx rows of its 2048-row ``x2`` and at 256 idx
rows of a 16,384-row v, "P3" and "P4" at the script's shapes, "P5" at the
script's 64 windows and at 1,024 (random offsets into a 4096-row table),
"P6" at 256 and 8192 rows (shift 5), "P7 cold" (rotating over 8 copies of
its 12 MB) and "P7 L2" (one set), µs a call queued, their outputs compared
bit for bit; with any of them, "launch floor": a one-element ``fill_``
queued the same way. ``--only`` keeps the cases
whose label starts with one of its words.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional, Sequence


def k5_batch(nsys: int, n: int, dev):
    """``circulant_spd_batch(nsys, n, seed=100)`` as ``cg_solve_batch`` pads
    it, on ``dev``: A, b, x0 and Jacobi's 1/diag. The helpers come from this
    script's checkout, so both runs solve the same batch."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from _torch_helpers import circulant_spd_batch, padded_batch

    return padded_batch(*circulant_spd_batch(nsys, n, seed=100), dev)


COLD_SETS = 8  # copies of a kernel case's operands its cold timing rotates over


def _rotating(calls):
    """One call of the next of ``calls`` a call, each output kept until its
    turn comes again. (Here and not imported: the parent's package may not
    have ``bench.k8_march``.)"""
    held, turn = [None] * len(calls), [0]

    def call():
        k = turn[0]
        held[k] = calls[k]()
        turn[0] = (k + 1) % len(calls)
    return call


def stencil_cases(dev) -> dict:
    """K8 and K9's cases: label -> (launch, operands); ``launch(*operands)``
    returns y."""
    import numpy as np
    import torch

    from tpucg_torch.kernels.stencil import poisson3d_cuda, poisson3d_slab_cuda

    def u_of(m):
        return torch.as_tensor(np.random.default_rng(m).standard_normal(m ** 3)
                               .astype(np.float32), device=dev)

    cases = {}
    for m in (64, 100, 128, 192, 256):
        cases[f"K8 m={m}"] = (lambda v, m_=m: poisson3d_cuda(v, m_), lambda m_=m: (u_of(m_),))
    m, mm = 128, 128 * 128
    for P in (1, 2, 4):
        blk = m ** 3 // P
        for r in sorted({0, P // 2}):
            def operands(r_=r, blk_=blk):
                u = u_of(m)
                zero = torch.zeros(mm, device=dev)
                lo = u[r_ * blk_ - mm:r_ * blk_].clone() if r_ > 0 else zero
                hi = u[(r_ + 1) * blk_:(r_ + 1) * blk_ + mm].clone() if (r_ + 1) * blk_ < m ** 3 \
                    else zero.clone()
                return u[r_ * blk_:(r_ + 1) * blk_].clone(), lo, hi
            cases[f"K9 m={m} P={P} rank {r}"] = (
                lambda ub, lo, hi: poisson3d_slab_cuda(ub, lo, hi, m), operands)
    return cases


def blas_cases(dev) -> dict:
    """K3 and K2 at n = 8192 through their launch cores, as the lap calls
    them (one scratch, made once): label -> (launch, the library call or
    None); ``launch()`` returns its outputs."""
    import numpy as np
    import torch

    from tpucg_torch.kernels.blas1 import dot_launch, fused_update_launch, scratch_for
    from tpucg_torch.kernels.dispatch import cuda_stream

    rng = np.random.default_rng(8192)
    x, r, p, ap = (torch.as_tensor(rng.standard_normal(8192).astype(np.float32), device=dev)
                   for _ in range(4))
    alpha = torch.tensor(0.37, device=dev)
    stream, scratch = cuda_stream(x), scratch_for(x)
    out, rr = torch.empty((), device=dev), torch.empty((), device=dev)
    xo, ro = torch.empty_like(x), torch.empty_like(r)

    def k3():
        dot_launch(p, ap, scratch, out, None, stream)
        return (out,)

    def k2():
        fused_update_launch(x, r, p, ap, alpha, xo, ro, scratch, rr, None, stream)
        return xo, ro, rr
    return {"K3 n=8192": (k3, lambda: torch.dot(p, ap)), "K2 n=8192": (k2, None)}


def probe_cases(dev) -> dict:
    """P1, P2, P5, P6 and P7's cases: label -> (launch, operand sets); the
    timed call rotates over the sets, and the output compared is the first
    set's."""
    import numpy as np
    import torch

    from tpucg_torch.bench.probe_gather import device_inputs, probe_inputs
    from tpucg_torch.kernels.probe_gather import (
        dynslice_cuda,
        elem_gather_cuda,
        lane_gather_cuda,
        roll_dyn_cuda,
        row_gather_cuda,
        sub_gather_cuda,
    )

    t = device_inputs(probe_inputs(0), dev)
    rng = np.random.default_rng(1024)
    table = torch.randn(4096, 128, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    w1024 = torch.as_tensor(rng.integers(0, 4096 - 8 + 1, 1024).astype(np.int32), device=dev)
    big = (t["Vb"], t["LIb"])
    tall = torch.randn(16384, 128, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)

    def rows_of(hi, m):
        return torch.as_tensor(rng.integers(0, hi, (m, 128)).astype(np.int32), device=dev)
    return {
        "P1 256x128": (lane_gather_cuda, [(t["V"], t["LI"])]),
        "P2 256x128": (sub_gather_cuda, [(t["V"], t["SI"])]),
        "P2 8192x128": (sub_gather_cuda, [(t["x2"], rows_of(2048, 8192))]),
        "P2 tall": (sub_gather_cuda, [(tall, rows_of(16384, 256))]),
        "P3 256 rows": (row_gather_cuda, [(t["x2"], t["ridx"])]),
        "P4 256x128": (elem_gather_cuda, [(t["xf"], t["eidx"])]),
        "P6 256x128": (roll_dyn_cuda, [(t["shift"], t["V"])]),
        "P6 8192x128": (roll_dyn_cuda, [(t["shift"], t["Vb"])]),
        "P5 nw=64": (dynslice_cuda, [(t["widx"], t["x2"])]),
        "P5 nw=1024": (dynslice_cuda, [(w1024, table)]),
        "P7 cold 8192x128": (lane_gather_cuda,
                             [big] + [tuple(a.clone() for a in big) for _ in range(COLD_SETS - 1)]),
        "P7 L2 8192x128": (lane_gather_cuda, [big]),
    }


def banded(nsys: int, n: int, dev):
    """tpucg's battery (``banded_battery(nsys, n, seed=0)``) on ``dev``: the
    f32 slab, its offsets, b and x0 = 0."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from _torch_helpers import banded_battery

    import torch

    data, offsets, b = banded_battery(nsys, n, seed=0)
    bd = torch.as_tensor(b, device=dev)
    return torch.as_tensor(data, device=dev), offsets, bd, torch.zeros_like(bd)


def host_seconds_per_call(fn, reps: int = 100) -> float:
    """The host's time a call of ``fn`` (the wrapper's own work: checks,
    allocation, the launch) while a spin kernel holds the card, so the host
    never waits on the queue: the median of 5 windows of ``reps`` calls.
    (Here and not in ``bench.timing``: the parent's package may not have
    it.)"""
    import statistics
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(5):
        torch.cuda._sleep(int(4e9 * reps * 1e-4))  # ~0.2 ms a call at 2 GHz at least
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        windows.append((time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return statistics.median(windows)


def lap_route(op, b, pc: str, tol: float, maxiter: int):
    """A lap-route solve of ``op`` as ``cg_solve`` runs it (b padded, x0 =
    0, jacobi's 1/diag, poly of degree 3 estimated in the call), through
    ``lap_ops`` and ``cg_loop``, which both checkouts have: returns a call
    that gives (x, k, r.r)."""
    import torch

    from tpucg_torch.solver.cg import cg_loop, lap_ops, make_precond

    b = torch.nn.functional.pad(b, (0, op.padded_n - b.shape[0]))
    minv = None
    if pc == "jacobi":
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0)

    def solve():
        matvec, dot, lap = lap_ops(op, "cuda")
        precond = make_precond(pc, minv, matvec, dot, b, 3)
        s = cg_loop(matvec, dot, lap, b, torch.zeros_like(b), tol=tol, maxiter=maxiter,
                    precond=precond)
        return s.x, s.k, s.rslast
    return solve


def profile_solve(fn, laps: int) -> dict:
    """One profiled call of a lap-route solve that stopped after ``laps``:
    the device's busy share of the host's wall, and its device ops and
    kernel launches (memcpy and memset left out) over the laps the chunks
    enqueued (``tests/_torch_helpers.py`` ``laps_run``). A trace with no
    device event is taken again, at most three times."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from _torch_helpers import laps_run

    from tpucg_torch.bench.timing import trace_calls

    enqueued = laps_run(laps)
    for _ in range(3):
        wall, ops = trace_calls(fn, 1)
        if ops:
            break
    if not ops:
        return {}
    kernels = sum(c for name, (c, _) in ops.items() if not name.startswith(("Memcpy", "Memset")))
    return {"busy share": sum(us for _, us in ops.values()) / 1e6 / wall,
            "device ops a lap": sum(c for c, _ in ops.values()) / enqueued,
            "kernels a lap": kernels / enqueued}


LAPS = (8, 40)  # maxiter of the two tol = 0 runs whose slope is a lap


def lap_slope(solve) -> tuple:
    """(µs a lap, µs of launch and set-up) from the queued device time of
    ``solve(maxiter)`` at the two maxiters of ``LAPS``."""
    from tpucg_torch.bench.timing import device_timing

    t = [device_timing(lambda m=m: solve(m), iters=5, reps=20).median * 1e6 for m in LAPS]
    slope = (t[1] - t[0]) / (LAPS[1] - LAPS[0])
    return slope, t[0] - LAPS[0] * slope


def worker(out: str, only: Sequence[str] = ()) -> None:
    """Every case's laps, x and median ms, from the ``tpucg_torch`` on the
    path, saved to ``out`` with ``torch.save``; with ``only``, the cases
    whose label starts with one of its words."""
    import torch

    from tpucg_torch.bench.k11_lap import poisson_rhs
    from tpucg_torch.bench.timing import device_seconds_per_call, time_fn
    import numpy as np

    from tpucg_torch.io.generator import fem_p1_system, generate_spd_system, poisson3d_dia
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.fused import (
        fused_batch_cg_solve_cuda,
        fused_batch_dia_cg_solve_cuda,
        fused_cg_solve_cuda,
        fused_dia_cg_solve_cuda,
        fused_stencil_cg_solve_cuda,
    )
    from tpucg_torch.solver.operators import (
        DenseOperator,
        DiaOperator,
        PoissonOperator,
        best_sparse_operator,
    )

    strict_f32()
    dev = torch.device("cuda", 0)
    wanted = lambda label: not only or any(label.startswith(w) for w in only)  # noqa: E731
    cases, slopes = {}, {}
    for n in (1000, 2048, 4096):
        A, b, x0 = generate_spd_system(n, seed=0)
        op = DenseOperator.create(A, device=dev)
        pad = op.padded_n - n
        bp = torch.nn.functional.pad(torch.as_tensor(b, device=dev), (0, pad))
        x0p = torch.nn.functional.pad(torch.as_tensor(x0, device=dev), (0, pad))
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0)
        for pc in ("none", "jacobi", "poly"):
            kw = dict(tol=1e-6, maxiter=n, precondition=pc, poly_degree=3 if pc == "poly" else 0,
                      minv=minv if pc == "jacobi" else None)
            cases[f"K4 n={n} {pc}"] = (lambda A_=op.A, b_=bp, x_=x0p, kw_=kw:
                                       fused_cg_solve_cuda(A_, b_, x_, **kw_))
            slopes[f"K4 lap n={n} {pc}"] = (lambda m, A_=op.A, b_=bp, x_=x0p, kw_=kw:
                                            fused_cg_solve_cuda(A_, b_, x_,
                                                                **dict(kw_, tol=0.0, maxiter=m)))
    for nsys, n in ((64, 1000), (16, 2048), (256, 512)):
        A, b, x0, minv = k5_batch(nsys, n, dev)
        for pc in ("none", "jacobi"):
            kw = dict(tol=1e-2, maxiter=n, precondition=pc, minv=minv if pc == "jacobi" else None)
            cases[f"K5 {nsys}x{n} {pc}"] = (lambda A_=A, b_=b, x_=x0, kw_=kw:
                                            fused_batch_cg_solve_cuda(A_, b_, x_, **kw_))
    m = 128
    b = poisson_rhs(m, dev)
    z = torch.zeros_like(b)
    tol, maxiter = 1e-5 * float(b.norm()), 8 * m + 200
    for pc in ("none", "poly"):
        kw = dict(tol=tol, maxiter=maxiter, precondition=pc, poly_degree=3 if pc == "poly" else 0)
        cases[f"K10 m={m} {pc}"] = lambda kw_=kw: fused_stencil_cg_solve_cuda(b, z, m, **kw_)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        op = DiaOperator.from_dia(poisson3d_dia(m), storage_dtype=dt, device=dev)
        for pc in ("none", "jacobi", "poly"):
            kw = dict(tol=tol, maxiter=maxiter, precondition=pc,
                      poly_degree=3 if pc == "poly" else 0)
            cases[f"K11 m={m} {name} {pc}"] = (
                lambda op_=op, kw_=kw: fused_dia_cg_solve_cuda(op_.data, op_.offsets, b, z, **kw_))
    cases[f"K8 lap route m={m}"] = lap_route(PoissonOperator(m, device=dev), b, "none", tol,
                                             maxiter)
    cases[f"lap K6 m={m} f32"] = lap_route(DiaOperator.from_dia(poisson3d_dia(m), device=dev), b,
                                           "none", tol, maxiter)
    if wanted("lap dense") or wanted("lap FEM"):
        A, bn, _ = generate_spd_system(8192, seed=0)
        op8 = DenseOperator.create(A, device=dev)
        del A
        b8 = torch.as_tensor(bn, device=dev)
        for pc in ("none", "jacobi", "poly"):
            cases[f"lap dense n=8192 {pc}"] = lap_route(op8, b8, pc, 1e-6, 8192)
        A_fem, b_fem, _ = fem_p1_system(300_000, seed=0)
        bf = torch.as_tensor(b_fem, device=dev)
        cases["lap FEM 300k jacobi"] = lap_route(
            best_sparse_operator(A_fem, device=dev), bf, "jacobi",
            1e-5 * float(np.linalg.norm(b_fem.astype(np.float64))), 4000)
    d32, offsets, bb, zb = banded(256, 1024, dev)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        d = d32.to(dt)
        for pc in ("none", "jacobi"):
            kw = dict(tol=1e-5, maxiter=1024, precondition=pc)
            cases[f"K12 256x1024 {name} {pc}"] = (
                lambda d_=d, kw_=kw: fused_batch_dia_cg_solve_cuda(d_, offsets, bb, zb, **kw_))
    results = {}
    for label, fn in cases.items():
        if not wanted(label):
            continue
        x, k, rr = fn()
        times = {"ms": time_fn(fn, warmup=1, iters=5).median * 1e3}
        if label.startswith(("K4", "K12")):
            times["device ms"] = device_seconds_per_call(fn, reps=50) * 1e3
            times["host ms"] = host_seconds_per_call(fn) * 1e3
        if label.startswith(("lap", "K8 lap")):
            times.update(profile_solve(fn, int(k)))
        results[label] = (k.tolist(), x.cpu() if rr is None else (x.cpu(), rr.cpu()), times)
    for label, (launch, library) in blas_cases(dev).items():
        if wanted(label):
            times = {"device us": device_seconds_per_call(launch) * 1e6}
            if library is not None:
                times["torch.dot us"] = device_seconds_per_call(library) * 1e6
            results[label] = (None, tuple(t.cpu() for t in launch()), times)
    for label, solve in slopes.items():
        if wanted(label):
            slope, fixed = lap_slope(solve)
            results[label] = (None, None, {"us a lap": slope, "set-up us": fixed})
    for label, (launch, operands) in stencil_cases(dev).items():
        if not wanted(label):
            continue
        args = operands()
        copies = [args] + [tuple(a.clone() for a in args) for _ in range(COLD_SETS - 1)]
        warm = device_seconds_per_call(lambda: launch(*args))
        cold = device_seconds_per_call(_rotating([lambda c=c: launch(*c) for c in copies]))
        results[label] = (None, launch(*args).cpu(), {"warm us": warm * 1e6, "cold us": cold * 1e6})
        del args, copies
        torch.cuda.empty_cache()
    probes = {label: case for label, case in probe_cases(dev).items() if wanted(label)}
    for label, (launch, sets) in probes.items():
        calls = [lambda a=a: launch(*a) for a in sets]
        call = calls[0] if len(calls) == 1 else _rotating(calls)
        results[label] = (None, launch(*sets[0]).cpu(),
                          {"device us": device_seconds_per_call(call) * 1e6})
    if probes:
        one = torch.empty(1, device=dev)
        results["launch floor"] = (None, None, {"device us": device_seconds_per_call(
            lambda: one.fill_(1.0)) * 1e6})
    torch.save(results, out)


def _laps(k) -> str:
    """A solve's laps, or a batch's as its least, largest and sum."""
    return str(k) if isinstance(k, int) else f"{min(k)}..{max(k)} (sum {sum(k)})"


def _equal(a, b) -> bool:
    """Bit for bit: two tensors, or two tuples of them."""
    import torch

    if isinstance(a, tuple):
        return all(_equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def compare(roots: Sequence[str], outs: Sequence[str]) -> None:
    """Runs 0 and 3 are the parent, 1 and 2 the change. A solve's x (and
    r.r) and laps are compared bit for bit, a kernel's y; a lap case has
    times only."""
    import torch

    runs = [torch.load(o) for o in outs]
    print(f"parent {roots[0]}, change {roots[1]}; runs: parent, change, change, parent")
    for label in runs[0]:
        (kp, xp, names), (kc, xc, _) = runs[0][label], runs[1][label]
        times = "; ".join(f"{name} " + " / ".join(
            f"{r[label][2].get(name, float('nan')):.5f}" for r in runs) for name in names)
        if xp is None:
            print(f"  {label}: {times}", flush=True)
            continue
        if kp is not None:
            times = "laps " + " / ".join(_laps(r[label][0]) for r in runs) + "; " + times
        x0p, x0c = (xp[0], xc[0]) if isinstance(xp, tuple) else (xp, xc)
        err = float((x0c - x0p).abs().max()) / float(x0p.abs().max())
        same = kp == kc and _equal(xp, xc)
        repeat = all(runs[i][label][0] == runs[j][label][0]
                     and _equal(runs[i][label][1], runs[j][label][1]) for i, j in ((0, 3), (1, 2)))
        print(f"  {label}: {times}; parent = change bit for bit: {same}; max |x_c - "
              f"x_p| / max |x_p| = {err:.3e}; each repeats itself: {repeat}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="PARENT_ROOT CHANGE_ROOT")
    ap.add_argument("--only", nargs="+", default=(), metavar="PREFIX",
                    help="run the cases whose label starts with one of these (e.g. K5)")
    ap.add_argument("--worker", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.only)
        return 0
    if len(args.roots) != 2:
        ap.error("give PARENT_ROOT and CHANGE_ROOT")
    parent, change = (str(Path(r).resolve()) for r in args.roots)
    order = (parent, change, change, parent)
    with tempfile.TemporaryDirectory(dir=change) as tmp:
        outs = [os.path.join(tmp, f"run{i}.pt") for i in range(4)]
        for root, out in zip(order, outs):
            env = dict(os.environ, PYTHONPATH=root)
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", out,
                            *(["--only", *args.only] if args.only else [])],
                           cwd=root, env=env, check=True)
        compare(order, outs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
