"""K12 (the batched banded whole solve) on the card: the wrapper against the
device, and the sweep of warps a system.

    python -m tpucg_torch.bench.k12_warps [256x1024 ...] [--dtype f32 bf16]
        [--precondition none jacobi] [--sweep]

For each shape B x n it builds tpucg's battery (``tests/_torch_helpers.py``
``banded_battery(B, n, seed=0)``: tridiagonal, offsets (-1, 0, 1)), stores
its slab in each dtype and solves it at tpucg's tol 1e-5 from x0 = 0,
printing the laps (least, largest, sum), the wrapper's time a call
(``time_fn``: CUDA events around back-to-back calls, host work included)
and the queued device time (``bench.timing.device_timing``: calls queued
behind a spin kernel), with the plan (``kernels.fused.batch_dia_warps_plan``)
where this checkout has one. ``--sweep`` also times K12 forced onto each W
of ``BATCH_DIA_WARPS`` warps a system, with the slab in shared memory and
streamed, and holds x, k and r.r of each bit-identical to the plan's. The
card's
name and power limit close the report. There is no CPU mode: K12 runs only
on a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.timing import device_timing, nvidia_smi_card, time_fn
from tpucg_torch.kernels import fused as kf
from tpucg_torch.kernels.dispatch import strict_f32

SHAPES = ("256x1024",)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def battery(nsys: int, n: int, dev):
    """tpucg's battery on ``dev``: the f32 slab, offsets, b and x0 = 0."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from _torch_helpers import banded_battery

    data, offsets, b = banded_battery(nsys, n, seed=0)
    bd = torch.as_tensor(b, device=dev)
    return torch.as_tensor(data, device=dev), offsets, bd, torch.zeros_like(bd)


def timed(solve) -> str:
    x, k, rr = solve()
    laps = k.tolist()
    wrapper = time_fn(solve, warmup=1, iters=7).median * 1e3
    device = device_timing(solve, iters=5, reps=50).median * 1e3
    return (f"laps {min(laps)}..{max(laps)} (sum {sum(laps)}), wrapper {wrapper:.5f} ms, "
            f"queued device {device:.5f} ms")


def plan_text(nsys: int, npad: int, ndiag: int, dtype) -> str:
    if not hasattr(kf, "batch_dia_warps_plan"):
        return "plan: none (one block of min(n, 1024) threads a system)"
    return "plan: " + kf.batch_dia_warps_plan(nsys, npad, ndiag, dtype).describe()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shapes", nargs="*", default=SHAPES, help="B x n, e.g. 256x1024")
    ap.add_argument("--dtype", nargs="+", default=list(DTYPES), choices=list(DTYPES))
    ap.add_argument("--precondition", nargs="+", default=["none", "jacobi"],
                    choices=["none", "jacobi"])
    ap.add_argument("--sweep", action="store_true",
                    help="also time every forced W, slab in shared memory and streamed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k12_warps: K12 runs only on a CUDA device", file=sys.stderr)
        return 1
    strict_f32()
    dev = torch.device("cuda", 0)
    for shape in args.shapes:
        nsys, n = (int(v) for v in shape.split("x"))
        data32, offsets, b, z = battery(nsys, n, dev)
        for dname in args.dtype:
            d = data32.to(DTYPES[dname])
            for pc in args.precondition:
                kw = dict(tol=1e-5, maxiter=n, precondition=pc)
                solve = lambda: kf.fused_batch_dia_cg_solve_cuda(  # noqa: E731
                    d, offsets, b, z, **kw)
                print(f"K12 {shape} {dname} {pc}: {plan_text(nsys, n, len(offsets), d.dtype)}; "
                      f"{timed(solve)}", flush=True)
                if not args.sweep:
                    continue
                ref = solve()
                for w in kf.BATCH_DIA_WARPS:
                    for slab in (True, False):
                        forced = lambda w=w, s=slab: kf.fused_batch_dia_cg_solve_cuda(  # noqa: E731
                            d, offsets, b, z, _plan=(w, s), **kw)
                        try:
                            got = forced()
                        except RuntimeError as e:  # W above the virtual warps, or no room
                            print(f"  forced W = {w}, slab {slab}: refused ({e})", flush=True)
                            continue
                        if not all(torch.equal(u, v) for u, v in zip(ref, got)):
                            raise RuntimeError(f"K12 {shape} {dname} {pc}: W = {w}, slab in "
                                               f"shared memory {slab} differs from the plan's")
                        where = "in shared memory" if slab else "streamed"
                        print(f"  forced W = {w}, slab {where}: {timed(forced)}; "
                              f"bit-identical to the plan's", flush=True)
        del data32, b, z
        torch.cuda.empty_cache()
    print(nvidia_smi_card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
