"""K8 on the card at forced march tiles: the 7-point stencil at m = 128 and
256 (``python -m tpucg_torch.bench.k8_march [--m 128 256]``), each tile
(TY lines x TZ z x NX planes a block) beside the plan's.

For each grid edge it draws u (standard normal, ``default_rng(m)``, f32),
takes K8 on the plan's tile (``stencil_march_plan``) and holds it to the
plain ``poisson3d_torch`` bit for bit, then for each tile of ``SWEEP`` (and
the plan's) holds K8 on that tile to the same bits and prints one line: the
tile, the grid, the threads and shared bytes a block, the ratio of u's reads
to u, and µs a launch warm (calls queued on one u, which stays in the 50 MB
L2 at m = 128) and cold (rotating over ``COLD_SETS`` copies of u, more than
L2 holds), each with its share of the bound (u read and y written once at
the HBM peak). The plan's tile is marked "(plan)". The card's name and
power limit close the report. There is no CPU mode: K8 runs only on a card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpucg_torch.bench.timing import (
    device_seconds_per_call,
    hbm_peak_bytes_per_s,
    nvidia_smi_card,
    rotating,
    stencil_bytes,
)
from tpucg_torch.kernels.stencil import poisson3d_cuda, poisson3d_torch, stencil_march_plan

COLD_SETS = 8  # copies of u a cold timing rotates over (67 MB at m = 128)

# Forced tiles (TY, TZ, NX) a grid edge is timed at, beside the plan's.
SWEEP = {
    128: ((16, 128, 2), (16, 128, 8), (16, 128, 16), (8, 128, 2), (8, 128, 4), (8, 128, 8),
          (4, 128, 8), (16, 64, 8), (32, 64, 8), (32, 64, 16)),
    256: ((16, 128, 8), (16, 128, 16), (16, 128, 64), (8, 128, 16), (8, 128, 32),
          (32, 64, 32), (16, 64, 32)),
}


def cold_seconds(launch: Callable[..., torch.Tensor], args: tuple,
                 sets: int = COLD_SETS) -> float:
    """Device seconds a call of ``launch(*args)`` when its operands are not
    in L2: queued calls rotating over ``sets`` copies of ``args``."""
    copies = [args] + [tuple(a.clone() for a in args) for _ in range(sets - 1)]
    return device_seconds_per_call(rotating([lambda c=c: launch(*c) for c in copies]))


def line(m: int, plan, want: torch.Tensor, u: torch.Tensor, peak: float, mark: str = "") -> str:
    """One tile's report line (module docstring); raises if K8 on it differs
    from ``want``."""
    launch = lambda v: poisson3d_cuda(v, m, _plan=plan)  # noqa: E731
    if not torch.equal(launch(u), want):
        raise RuntimeError(f"K8 m={m} tile {plan.ty}x{plan.tz}x{plan.nx}: differs from plain")
    warm, cold = device_seconds_per_call(lambda: launch(u)), cold_seconds(launch, (u,))
    bound = stencil_bytes(m ** 3) / peak
    return (f"K8 m={m} {plan.ty}x{plan.tz}x{plan.nx}{mark}: {plan.describe()}; warm "
            f"{warm * 1e6:.3f} us ({bound / warm:.1%} of the {bound * 1e6:.3f} us bound), cold "
            f"{cold * 1e6:.3f} us ({bound / cold:.1%}); bit-identical to plain")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", nargs="+", type=int, default=sorted(SWEEP))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_march: K8 runs only on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    peak = hbm_peak_bytes_per_s(torch.cuda.get_device_name(0))
    for m in args.m:
        u = torch.as_tensor(np.random.default_rng(m).standard_normal(m ** 3).astype(np.float32),
                            device=dev)
        plan = stencil_march_plan(m)
        want = poisson3d_cuda(u, m)
        if not torch.equal(want, poisson3d_torch(u, m)):
            raise RuntimeError(f"K8 m={m}: the plan's tile differs from plain")
        print(line(m, plan, want, u, peak, " (plan)"), flush=True)
        for ty, tz, nx in SWEEP.get(m, ()):
            print(line(m, stencil_march_plan(m, ty=ty, tz=tz, nx=nx), want, u, peak), flush=True)
        del u, want
        torch.cuda.empty_cache()
    print(nvidia_smi_card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
