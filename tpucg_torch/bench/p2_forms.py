"""P2's two forms on the card, side by side over the heights of v and idx:

    python -m tpucg_torch.bench.p2_forms [--v-rows 256 2048] [--rows 256 8192] [--reps 2]

For each v of ``v_rows`` rows and idx of ``rows`` rows (random rows, seed
0), P2's kernel (``kernels/probe_gather.py`` ``sub_gather_cuda``) on forced
plans: the staged form on 1, 2, 4 and 8 runs of idx rows (16 column groups
each, 256 threads a block) where its slab fits, and the direct form on 32,
64, 128 and 256 threads a block. Each plan is held to the plain version
bit for bit, then timed ``--reps`` times (µs a launch, calls queued behind
a spin kernel, ``bench.timing.device_seconds_per_call``), the plans in
turns and in reverse order on every other turn. A line a shape: each
plan's times, the fastest, and ``sub_gather_plan``'s pick with its time
beside the fastest's. Then one launch's floor and the card's name and
power limit. ``sub_gather_plan``'s rule (the form, the runs, the direct
form's block) was fitted to this sweep.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.timing import device_seconds_per_call, nvidia_smi_card
from tpucg_torch.kernels import probe_gather as kp

V_ROWS = (256, 1024, 2048, 4096, 7264)
ROWS = (256, 512, 1024, 2048, 4096, 8192)
RUNS = (1, 2, 4, 8)
THREADS = (32, 64, 128, 256)


def plans(v_rows: int, rows: int) -> dict:
    """label -> the forced plans of the sweep at one shape."""
    out = {}
    if v_rows <= kp.SG_MAX_ROWS:
        for runs in RUNS:
            if runs <= rows:
                out[f"staged {runs} runs"] = kp.SubGatherPlan(v_rows, rows, -(-rows // runs),
                                                              kp.SG_MAX_THREADS)
    for threads in THREADS:
        out[f"direct {threads}"] = kp.SubGatherPlan(v_rows, rows, 0, threads)
    return out


def shape_line(v_rows: int, rows: int, reps: int, dev) -> str:
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(v_rows, kp.LANE, generator=g, device=dev)
    idx = torch.randint(0, v_rows, (rows, kp.LANE), generator=g, device=dev, dtype=torch.int32)
    want = kp.sub_gather_torch(v, idx)
    forced = plans(v_rows, rows)
    pick = kp.sub_gather_plan(v_rows, rows, kp._sms(v))
    forced.setdefault("plan", pick)
    for label, plan in forced.items():
        if not torch.equal(kp.sub_gather_cuda(v, idx, _plan=plan), want):
            raise RuntimeError(f"P2 at v {v_rows}, idx {rows}, {plan}: differs from plain")
    us = {label: [] for label in forced}
    for rep in range(reps):
        order = list(forced.items())
        for label, plan in order if rep % 2 == 0 else order[::-1]:
            us[label].append(device_seconds_per_call(
                lambda p=plan: kp.sub_gather_cuda(v, idx, _plan=p)) * 1e6)
    median = {label: sorted(t)[len(t) // 2] for label, t in us.items()}
    best = min(median, key=median.get)
    picked = next(label for label, plan in forced.items() if plan == pick)
    return (f"P2 v {v_rows} rows, idx {rows} rows: " + "; ".join(
        f"{label} " + "/".join(f"{t:.3f}" for t in times) for label, times in us.items())
        + f"; fastest {best} {median[best]:.3f}; plan picks {picked} {median[picked]:.3f} us "
        f"({pick})")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.p2_forms",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--v-rows", type=int, nargs="+", default=V_ROWS)
    ap.add_argument("--rows", type=int, nargs="+", default=ROWS)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("p2_forms measures on the card, and there is no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = nvidia_smi_card()
    print(f"device: {torch.cuda.get_device_name(dev)} [{card}]; µs a launch, queued", flush=True)
    for v_rows in args.v_rows:
        for rows in args.rows:
            print(shape_line(v_rows, rows, args.reps, dev), flush=True)
    one = torch.empty(1, device=dev)
    print(f"launch floor (a one-element fill_, queued): "
          f"{device_seconds_per_call(lambda: one.fill_(1.0)) * 1e6:.3f} us")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
