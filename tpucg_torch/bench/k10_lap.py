"""K10's lap on the card: the whole matrix-free Poisson solve of tpucg's
bench system (``bench --operator poisson-free``), one cooperative launch a
solve, set beside the bytes its vectors must move each lap.

    python -m tpucg_torch.bench.k10_lap [--m 128 192] [--precondition none poly]

For each grid edge and preconditioner (poly: degree 3, two more matvecs and
grid-wide syncs a lap) it solves b = A x_true (``k11_lap.poisson_rhs``)
from x0 = 0 at tol 1e-5 ||b|| with K10 and with its plain version, holds
the laps within one and x within 1e-4 of max |x|, and prints one line
(``line``): laps, ms a solve (CUDA events, median of 5 after one warm-up),
µs a lap, the lap's distinct vector bytes (``lap_vector_bytes``) at the HBM
peak and their share of the lap, the tile plan (T, H, the window, the near
and far offsets), the grid, the tiles (and the most a block owns) and the
shared bytes. The card's name and power limit close the report. There is no
CPU mode: K10 runs only on a card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.k11_lap import poisson_rhs
from tpucg_torch.bench.timing import hbm_peak_bytes_per_s, nvidia_smi_card, time_fn
from tpucg_torch.kernels.fused import (
    fused_stencil_cg_solve_cuda,
    fused_stencil_grid,
    stencil_tile_plan,
)
from tpucg_torch.solver.fused import fused_stencil_cg_solve_torch

POLY_DEGREE = 3


def lap_vector_bytes(n: int, precondition: str = "none", degree: int = POLY_DEGREE) -> int:
    """The f32 vector bytes one lap of K10 must move, each vector read or
    written once a phase: the matvec reads z (r without a preconditioner)
    and p_old and writes p and Ap; the update reads x, p, r and Ap and
    writes x and r (and z under poly); each of poly's degree - 1 further
    Neumann terms reads z and r and writes z."""
    per_row = 16 + 24
    if precondition == "poly":
        per_row += 4 + 12 * (degree - 1)
    return per_row * n


def measure(m: int, b: torch.Tensor, x0: torch.Tensor, *, tol: float, maxiter: int,
            peak: float, precondition: str = "none") -> dict:
    """One K10 solve on the m^3 grid timed (median of 5 after one warm-up),
    its plan and grid, and its vectors' bytes at ``peak`` bytes/s a lap."""
    solve = lambda: fused_stencil_cg_solve_cuda(  # noqa: E731
        b, x0, m, tol=tol, maxiter=maxiter, precondition=precondition,
        poly_degree=POLY_DEGREE if precondition == "poly" else 0)
    x, k, _ = solve()
    laps = int(k)
    t = time_fn(solve, warmup=1, iters=5)
    vec = lap_vector_bytes(m ** 3, precondition)
    return dict(x=x, laps=laps, t=t, lap_us=t.median / max(laps, 1) * 1e6, vec=vec,
                vec_us=vec / peak * 1e6, plan=stencil_tile_plan(m), grid=fused_stencil_grid(m))


def line(label: str, r: dict, sms: int) -> str:
    """``measure``'s result as one line."""
    t, plan = r["t"], r["plan"]
    return (f"{label}: {r['laps']} laps, {t.median * 1e3:.5f} ms per solve (min "
            f"{t.min * 1e3:.5f}, max {t.max * 1e3:.5f}, 5 solves), {r['lap_us']:.3f} us per lap; "
            f"the lap's vectors ({r['vec'] / 1e6:.1f} MB) at the HBM peak {r['vec_us']:.3f} us "
            f"({100 * r['vec_us'] / r['lap_us']:.1f}% of the lap); tile T = {plan.tile} rows, "
            f"halo H = {plan.halo}, window [{plan.lo}, {plan.hi}] (near {plan.near}, far "
            f"{plan.far}), grid {r['grid']} blocks ({r['grid'] / sms:g} an SM), {plan.ntiles} "
            f"tiles, at most {-(-plan.ntiles // r['grid'])} a block, {plan.smem_bytes} B of "
            "shared memory a block")


def check_against_plain(label: str, m: int, r: dict, b: torch.Tensor, x0: torch.Tensor, *,
                        tol: float, maxiter: int, precondition: str = "none") -> str:
    """Holds ``measure``'s solve to the plain version (laps within one, x
    within 1e-4 of max |x|); raises otherwise, else returns the comparison."""
    xp, kp, _ = fused_stencil_cg_solve_torch(
        b, x0, m, tol=tol, maxiter=maxiter, precondition=precondition,
        poly_degree=POLY_DEGREE if precondition == "poly" else 0)
    err = float((r["x"] - xp).abs().max()) / float(xp.abs().max())
    if abs(r["laps"] - int(kp)) > 1 or err > 1e-4:
        raise RuntimeError(f"{label}: {r['laps']} laps (plain {int(kp)}), x within {err:.3e} of "
                           "max |x| (bound 1e-4)")
    return f"plain {int(kp)} laps, x within {err:.3e} of max |x|"


def run(ms: Sequence[int], preconditions: Sequence[str]) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("K10 runs only on a card, and there is no CUDA device")
    dev = torch.device("cuda", 0)
    peak = hbm_peak_bytes_per_s(torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in ms:
        b = poisson_rhs(m, dev)
        z = torch.zeros_like(b)
        tol, maxiter = 1e-5 * float(b.norm()), 8 * m + 200
        for pc in preconditions:
            label = f"K10 m={m} {pc}"
            r = measure(m, b, z, tol=tol, maxiter=maxiter, peak=peak, precondition=pc)
            cmp = check_against_plain(label, m, r, b, z, tol=tol, maxiter=maxiter,
                                      precondition=pc)
            print(f"{line(label, r, sms)}; {cmp}", flush=True)
    print(nvidia_smi_card())


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.k10_lap",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=(128,))
    ap.add_argument("--precondition", nargs="+", choices=("none", "poly"), default=("none",))
    args = ap.parse_args(argv)
    run(args.m, args.precondition)
    return 0


if __name__ == "__main__":
    sys.exit(main())
