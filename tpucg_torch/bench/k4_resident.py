"""K4 (the dense whole solve) on the card: µs a lap, launch and set-up, the
wrapper against the device, and the resident-A plan's sweep.

    python -m tpucg_torch.bench.k4_resident [--n 128 1000 2048 4096]
        [--precondition none jacobi poly] [--sweep 2048 4096]

For each n it builds ``generate_spd_system(n, seed=0)`` through
``DenseOperator`` (identity-padded to a multiple of 128) and prints:
- the lap: K4's queued device time (``bench.timing.device_timing``: calls
  queued behind a spin kernel) at tol = 0 with maxiter = 8 and 40. No lap
  passes the stopping test at tol 0, so each call runs every lap up to
  maxiter: the slope is µs a lap, the intercept launch plus set-up (r0 and,
  under poly, the power method). These calls time laps only; their x is
  not checked. Beside the slope, A's bytes and their time at the card's
  HBM peak: the least a lap's matvec would take if it read A from device
  memory, which a lap that reads A from shared memory and L2 passes;
- the reference solve (tol 1e-6, maxiter n): its laps, the wrapper's time
  a call (``time_fn``: CUDA events around back-to-back calls, host work
  included) and the queued device time;
- the plan (``kernels.fused.dense_resident_plan``): grid, resident rows a
  block, rows read through L2, shared bytes a block, and whether the grid
  is the one-warp-a-row grid of the kernel before A was kept on chip.

``--sweep`` times, at each n it names, every forced plan of
``dense_resident_plans`` (blocks an SM and resident rows a block) at tol 0
(µs a lap) and on the reference solve, and checks that each plan takes the
plan's laps (a plan whose grid the card cannot hold at once is refused by
the launch, and printed so). The card's name and power limit close the report. There is
no CPU mode: K4 runs only on a card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.timing import (
    device_timing,
    hbm_peak_bytes_per_s,
    nvidia_smi_card,
    time_fn,
)
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.kernels import fused as kf
from tpucg_torch.kernels.dispatch import strict_f32
from tpucg_torch.solver.operators import DenseOperator

NS = (128, 1000, 2048, 4096)
LAPS = (8, 40)  # maxiter of the two tol = 0 runs whose slope is a lap


def operands(n: int, dev):
    """The padded operator's A, b, x0 and Jacobi's 1/diag on ``dev``."""
    A, b, x0 = generate_spd_system(n, seed=0)
    op = DenseOperator.create(A, device=dev)
    pad = op.padded_n - n
    bd = torch.nn.functional.pad(torch.as_tensor(b, device=dev), (0, pad))
    x0d = torch.nn.functional.pad(torch.as_tensor(x0, device=dev), (0, pad))
    d = op.diagonal()
    return op.A, bd, x0d, torch.where(d != 0, 1.0 / d, 1.0)


def solve_kw(pc: str, minv, **kw) -> dict:
    return dict(kw, precondition=pc, poly_degree=3 if pc == "poly" else 0,
                minv=minv if pc == "jacobi" else None)


def lap_slope(solve) -> tuple:
    """(µs a lap, µs of launch and set-up) from the queued device time of
    ``solve(maxiter)`` at the two maxiters of ``LAPS``."""
    t = [device_timing(lambda m=m: solve(m), iters=5, reps=20).median * 1e6 for m in LAPS]
    slope = (t[1] - t[0]) / (LAPS[1] - LAPS[0])
    return slope, t[0] - LAPS[0] * slope


def case_line(n: int, pc: str, A, b, x0, minv, peak: float, plan=None) -> str:
    """One n and preconditioner: the lap's slope and the reference solve."""
    extra = {} if plan is None else {"_plan": plan}
    slope, fixed = lap_slope(lambda m: kf.fused_cg_solve_cuda(
        A, b, x0, **solve_kw(pc, minv, tol=0.0, maxiter=m), **extra))
    kw = solve_kw(pc, minv, tol=1e-6, maxiter=n)
    solve = lambda: kf.fused_cg_solve_cuda(A, b, x0, **kw, **extra)  # noqa: E731
    laps = int(solve()[1])
    wrapper = time_fn(solve, warmup=2, iters=7, reps=10).median * 1e3
    device = device_timing(solve, iters=5, reps=50).median * 1e3
    a_us = 4 * A.shape[0] ** 2 / peak * 1e6
    return (f"{pc}: {slope:.3f} us a lap (A's {4 * A.shape[0] ** 2 / 2 ** 20:.2f} MiB at HBM "
            f"peak {a_us:.3f} us), launch + set-up {fixed:.3f} us; reference solve {laps} "
            f"laps, wrapper {wrapper:.5f} ms, queued device {device:.5f} ms"), laps


def plan_line(npad: int, sms: int) -> str:
    """The plan's line, or a note where this checkout has no plan."""
    if not hasattr(kf, "dense_resident_plan"):
        return "plan: none (A read from device memory by every matvec)"
    return "plan: " + kf.dense_resident_plan(npad, sms).describe()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", nargs="*", type=int, default=NS)
    ap.add_argument("--precondition", nargs="+", default=["none", "jacobi", "poly"],
                    choices=["none", "jacobi", "poly"])
    ap.add_argument("--sweep", nargs="*", type=int, default=(), metavar="N",
                    help="time every forced resident-A plan at these n")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_resident: K4 runs only on a CUDA device", file=sys.stderr)
        return 1
    strict_f32()
    dev = torch.device("cuda", 0)
    peak = hbm_peak_bytes_per_s(torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in args.n:
        A, b, x0, minv = operands(n, dev)
        print(f"K4 n={n} (npad {A.shape[0]}), {plan_line(A.shape[0], sms)}", flush=True)
        for pc in args.precondition:
            print("  " + case_line(n, pc, A, b, x0, minv, peak)[0], flush=True)
        del A, b, x0, minv
        torch.cuda.empty_cache()
    for n in args.sweep:
        A, b, x0, minv = operands(n, dev)
        npad = A.shape[0]
        want = {pc: int(kf.fused_cg_solve_cuda(A, b, x0, **solve_kw(pc, minv, tol=1e-6,
                                                                     maxiter=n))[1])
                for pc in args.precondition}
        print(f"K4 sweep n={n} (npad {npad}); the plan: {plan_line(npad, sms)}", flush=True)
        for plan in kf.dense_resident_plans(npad, sms):
            print(f"  forced {plan.describe()}", flush=True)
            for pc in args.precondition:
                try:
                    text, laps = case_line(n, pc, A, b, x0, minv, peak,
                                           plan=(plan.blocks_per_sm, plan.resident))
                except RuntimeError as e:  # the card cannot hold the grid at once
                    print(f"    {pc}: refused ({e})", flush=True)
                    continue
                if laps != want[pc]:
                    raise RuntimeError(f"K4 n={n} {pc}: forced plan {plan.describe()} took "
                                       f"{laps} laps, the plan {want[pc]}")
                print("    " + text, flush=True)
        del A, b, x0, minv
        torch.cuda.empty_cache()
    print(nvidia_smi_card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
