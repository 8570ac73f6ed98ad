"""K11's lap on the card: the whole banded solve of tpucg's Poisson bench
system in DIA form (``bench --operator poisson-dia``), one cooperative
launch a solve, set beside the bytes its slab must stream each lap.

    python -m tpucg_torch.bench.k11_lap [--m 128] [--storage f32 bf16]
        [--precondition none jacobi poly]

For each slab dtype and preconditioner (poly: degree 3, two more matvecs
and grid-wide syncs a lap) it solves b = A x_true (x_true standard normal
from ``default_rng(0)``, f32) from x0 = 0 at tol 1e-5 ||b|| with K11 and
with its plain version, holds the laps within one and x within 1e-4 of max
|x|, and prints one line (``line``): laps, ms a solve (CUDA events, median of 5
after one warm-up), µs a lap, the slab's µs a lap at the HBM peak and its
share of the lap, the tile plan (T, H, the window, the near and far
offsets), the grid, the tiles (and the most a block owns) and the shared
bytes. The card's
name and power limit close the report. There is no CPU mode: K11 runs only
on a card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from tpucg_torch.bench.timing import hbm_peak_bytes_per_s, nvidia_smi_card, time_fn
from tpucg_torch.io.generator import poisson3d_dia
from tpucg_torch.kernels.fused import dia_tile_plan, fused_dia_cg_solve_cuda, fused_dia_grid
from tpucg_torch.kernels.stencil import poisson3d_torch
from tpucg_torch.solver.fused import fused_dia_cg_solve_torch
from tpucg_torch.solver.operators import DiaOperator

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def poisson_rhs(m: int, device) -> torch.Tensor:
    """tpucg's bench right-hand side: b = A x_true, x_true standard normal
    (``default_rng(0)``, f32), A the m^3 Laplacian (the plain stencil)."""
    xt = np.random.default_rng(0).standard_normal(m ** 3).astype(np.float32)
    return poisson3d_torch(torch.as_tensor(xt, device=device), m)


def measure(op: DiaOperator, b: torch.Tensor, x0: torch.Tensor, *, tol: float, maxiter: int,
            peak: float, precondition: str = "none") -> dict:
    """One K11 solve of ``op`` timed (median of 5 after one warm-up), its
    plan and grid, and its slab's bytes at ``peak`` bytes/s a lap."""
    solve = lambda: fused_dia_cg_solve_cuda(  # noqa: E731
        op.data, op.offsets, b, x0, tol=tol, maxiter=maxiter, precondition=precondition,
        poly_degree=3 if precondition == "poly" else 0)
    x, k, _ = solve()
    laps = int(k)
    t = time_fn(solve, warmup=1, iters=5)
    slab = op.data.numel() * op.data.element_size()
    return dict(x=x, laps=laps, t=t, lap_us=t.median / max(laps, 1) * 1e6, slab=slab,
                slab_us=slab / peak * 1e6, plan=dia_tile_plan(op.padded_n, op.offsets),
                grid=fused_dia_grid(op.padded_n, op.data.dtype))


def line(label: str, r: dict, sms: int) -> str:
    """``measure``'s result as one line."""
    t, plan = r["t"], r["plan"]
    return (f"{label}: {r['laps']} laps, {t.median * 1e3:.5f} ms per solve (min "
            f"{t.min * 1e3:.5f}, max {t.max * 1e3:.5f}, 5 solves), {r['lap_us']:.3f} us per lap; "
            f"the slab ({r['slab'] / 1e6:.1f} MB) at the HBM peak {r['slab_us']:.3f} us a lap "
            f"({100 * r['slab_us'] / r['lap_us']:.1f}% of the lap); tile T = {plan.tile} rows, "
            f"halo H = {plan.halo}, window [{plan.lo}, {plan.hi}] (near {plan.near}, far "
            f"{plan.far}), grid {r['grid']} blocks ({r['grid'] / sms:g} an SM), {plan.ntiles} "
            f"tiles, at most {-(-plan.ntiles // r['grid'])} a block, {plan.smem_bytes} B of "
            "shared memory a block")


def run(m: int, storages: Sequence[str], preconditions: Sequence[str]) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("K11 runs only on a card, and there is no CUDA device")
    dev = torch.device("cuda", 0)
    peak = hbm_peak_bytes_per_s(torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = poisson_rhs(m, dev)
    z = torch.zeros_like(b)
    tol, maxiter = 1e-5 * float(b.norm()), 8 * m + 200
    dia = poisson3d_dia(m)
    for name in storages:
        op = DiaOperator.from_dia(dia, storage_dtype=DTYPES[name], device=dev)
        for pc in preconditions:
            r = measure(op, b, z, tol=tol, maxiter=maxiter, peak=peak, precondition=pc)
            xp, kp, _ = fused_dia_cg_solve_torch(op.data, op.offsets, b, z, tol=tol,
                                                 maxiter=maxiter, precondition=pc,
                                                 poly_degree=3 if pc == "poly" else 0)
            err = float((r["x"] - xp).abs().max()) / float(xp.abs().max())
            if abs(r["laps"] - int(kp)) > 1 or err > 1e-4:
                raise RuntimeError(f"K11 m={m} {name} {pc}: {r['laps']} laps (plain {int(kp)}), "
                                   f"x within {err:.3e} of max |x| (bound 1e-4)")
            print(line(f"K11 m={m} {name} {pc}", r, sms) + f"; plain {int(kp)} laps, x within "
                  f"{err:.3e} of max |x|", flush=True)
    print(nvidia_smi_card())


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.k11_lap",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--storage", nargs="+", choices=tuple(DTYPES), default=("f32", "bf16"))
    ap.add_argument("--precondition", nargs="+", choices=("none", "jacobi", "poly"),
                    default=("none",))
    args = ap.parse_args(argv)
    run(args.m, args.storage, args.precondition)
    return 0


if __name__ == "__main__":
    sys.exit(main())
