"""K5 on the card at each cluster size: the batched dense solve of the
circulant batches of ``chip_smoke.py`` phase 8, each system on a cluster of
C = 1, 2, 4 or 8 blocks, set beside the streaming floor.

    python -m tpucg_torch.bench.k5_clusters [64x1000 16x2048 256x512 ...]
        [--precondition none jacobi]

For each shape B x n it builds ``circulant_spd_batch(B, n, seed=100)``
(``tests/_torch_helpers.py``; identity-padded to a multiple of 128 as
``cg_solve_batch`` pads it), solves it at tol 1e-2 with K5 forced to each
C, holds x, k and r.r bit-identical to C = 1's, and prints one line: the
laps, the plan's C (``batch_cluster_plan`` on the card's SMs), the
clusters the card holds at once for each C, the streaming floor (A re-read
by every matvec: sum (laps + 1) npad^2 4 bytes at the HBM peak) and the
median ms of 7 solves (CUDA events, after one warm-up) at each C with its
share of the floor. The card's name and power limit close the report.
There is no CPU mode: K5 runs only on a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.timing import hbm_peak_bytes_per_s, nvidia_smi_card, time_fn
from tpucg_torch.kernels.dispatch import strict_f32
from tpucg_torch.kernels.fused import (
    batch_cluster_plan,
    fused_batch_cg_solve_cuda,
    fused_batch_clusters,
)

CLUSTERS = (1, 2, 4, 8)
SHAPES = ("64x1000", "16x2048", "256x512", "32x2048", "40x2048", "66x1024", "96x1024",
          "128x1024", "100x512")


def circulant_batch(nsys: int, n: int, dev):
    """The phase-8 circulant batch as ``cg_solve_batch`` pads it, on ``dev``:
    A, b, x0 and Jacobi's 1/diag."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from _torch_helpers import circulant_spd_batch, padded_batch

    return padded_batch(*circulant_spd_batch(nsys, n, seed=100), dev)


def line(nsys: int, n: int, precondition: str, dev, peak: float) -> str:
    """One shape's report line (module docstring)."""
    A, b, x0, minv = circulant_batch(nsys, n, dev)
    npad = A.shape[1]
    kw = dict(tol=1e-2, maxiter=n, precondition=precondition,
              minv=minv if precondition == "jacobi" else None)
    ref = fused_batch_cg_solve_cuda(A, b, x0, _cluster=1, **kw)
    laps = ref[1].tolist()
    floor = 4 * npad * npad * sum(k + 1 for k in laps) / peak
    cells = []
    for c in CLUSTERS:
        solve = lambda c=c: fused_batch_cg_solve_cuda(A, b, x0, _cluster=c, **kw)  # noqa: E731
        if not all(torch.equal(u, v) for u, v in zip(ref, solve())):
            raise RuntimeError(f"K5 {nsys}x{n} {precondition}: C = {c} differs from C = 1")
        ms = time_fn(solve, warmup=1, iters=7).median * 1e3
        cells.append(f"C={c} {ms:.5f} ({floor * 1e3 / ms:.1%})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    held = ", ".join(str(fused_batch_clusters(npad, c)) for c in CLUSTERS)
    return (f"K5 {nsys}x{n} {precondition}: laps {min(laps)}..{max(laps)} (sum {sum(laps)}), "
            f"plan C = {batch_cluster_plan(nsys, npad, sms).cluster}, clusters held at once "
            f"for C = 1, 2, 4, 8: {held}; streaming floor {floor * 1e3:.5f} ms; ms (floor's "
            f"share): " + ", ".join(cells) + "; x, k, r.r bit-identical across C")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shapes", nargs="*", default=SHAPES, help="B x n, e.g. 64x1000")
    ap.add_argument("--precondition", nargs="+", default=["none"], choices=["none", "jacobi"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_clusters: K5 runs only on a CUDA device", file=sys.stderr)
        return 1
    strict_f32()
    dev = torch.device("cuda", 0)
    peak = hbm_peak_bytes_per_s(torch.cuda.get_device_name(0))
    for shape in args.shapes:
        nsys, n = (int(v) for v in shape.split("x"))
        for pc in args.precondition:
            print(line(nsys, n, pc, dev, peak), flush=True)
            torch.cuda.empty_cache()
    print(nvidia_smi_card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
