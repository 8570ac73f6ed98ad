"""K13 x k (the k-column WELL product) of a parent checkout against this
checkout's, in one process on one card:

    python -m tpucg_torch.bench.k13_multi_ab PARENT_ROOT [--reps 3] [--only FEM]

``PARENT_ROOT`` is a checkout of the parent (``git archive`` of it unpacked
into an ignored directory such as ``build/parent``). Its
``tpucg_torch.solver.operators`` and ``tpucg_torch.solver.cg`` are imported
beside this checkout's (``probe_ab.parent_modules``), so each side builds
its own ``WellOperator`` layout and launches through its own wrapper, C
entry point and kernel library, built under its own root.

The product cases: FEM 300k (``fem_p1_system(300_000, seed=0)``) at k = 1,
3, 8 and 32 with f32 values and k = 8 with bf16 values; the geometric graph
``random_geometric_spd(100_000, seed=0, avg_degree=12.0)`` at k = 8; an
SPD arrowhead of n = 5000 (``arrowhead``: its first row, 5000 slots, is
longer than half a tile, so the change takes it with a block of its own) at
k = 8 and 32, where a third side, "flat alone", runs the change's kernel
over the same operator's layout built with ``tile=TILE_MAX``, which lists
no long row, so the flat grid walks row 0 a thread a column group. X is
standard normal (seed k), zero on the padding rows. Each case first holds
the sides' products to each other bit for bit, and each side to its
repeat; then it times them ``--reps`` times in turns (the order turned by
one side each turn, parent first on the first): µs a call queued behind a
spin kernel (``bench.timing.device_seconds_per_call``).
Printed: each side's median and spread (min to max over the turns), the
change over the parent, and the share of the bound, the bytes of the
function (nnz (itemsize + 4) + 4 (n + 1) + 8 n k) at the card's HBM peak.

The solve case: ``cg_solve_multi`` on FEM 300k, Jacobi, k = 8 (B standard
normal, seed 8; tol 3e-4 ||B[:, 0]||, maxiter 1000) through both
checkouts: laps and x held to each other bit for bit, then each side's
median ms a solve (CUDA events, ``bench.timing.time_fn``: 1 warm-up, 5
solves) in turns. Last, the card's name and power limit.
``--only`` keeps the cases whose label starts with one of its words.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from tpucg_torch.bench.probe_ab import parent_modules
from tpucg_torch.bench.timing import (device_seconds_per_call, hbm_peak_bytes_per_s,
                                      nvidia_smi_card, time_fn)
from tpucg_torch.io.generator import fem_p1_system, random_geometric_spd
from tpucg_torch.kernels.gather_spmv import TILE_MAX, well_rows, well_spmv_multi_cuda
from tpucg_torch.solver import cg as change_cg
from tpucg_torch.solver import operators as change_ops
from tpucg_torch.sparse.formats import COOMatrix

SOLVE = "FEM 300k cg_solve_multi jacobi k=8"


def product_cases() -> list:
    """(label, matrix maker, k, storage dtype) of the product cases."""
    fem = lambda: fem_p1_system(300_000, seed=0)[0]  # noqa: E731
    cases = [(f"FEM 300k f32 k={k}", fem, k, torch.float32) for k in (1, 3, 8, 32)]
    cases.append(("FEM 300k bf16 k=8", fem, 8, torch.bfloat16))
    cases.append(("geometric 100k f32 k=8",
                  lambda: random_geometric_spd(100_000, seed=0, avg_degree=12.0)[0], 8,
                  torch.float32))
    cases += [(f"arrowhead 5000 f32 k={k}", lambda: arrowhead(5000), k, torch.float32)
              for k in (8, 32)]
    return cases


def arrowhead(n: int, seed: int = 0):
    """An SPD arrowhead CSR: a full first row and column (c ~ U(-1, 1)), a
    diagonal d ~ 2 + U(0, 1), A[0, 0] = sum c^2 / d + 1, float32."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, n - 1)
    d = 2.0 + rng.random(n - 1)
    i = np.arange(1, n)
    row = np.r_[np.zeros(n, np.int64), i, i]
    col = np.r_[np.arange(n), np.zeros(n - 1, np.int64), i]
    data = np.r_[float(np.sum(c * c / d)) + 1.0, c, c, d].astype(np.float32)
    return COOMatrix(row=row, col=col, data=data, shape=(n, n)).to_csr()


def block(npad: int, n: int, k: int, seed: int, dev) -> torch.Tensor:
    """A standard normal (npad, k) block, zero on the padding rows."""
    X = np.zeros((npad, k), np.float32)
    X[:n] = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return torch.as_tensor(X, device=dev)


def in_turns(sides: dict, reps: int, timer) -> dict:
    """``timer`` of each side ``reps`` times, the order turned by one side
    each turn (the first side first on the first turn)."""
    names = list(sides)
    out = {side: [] for side in names}
    for rep in range(reps):
        turn = rep % len(names)
        for side in names[turn:] + names[:turn]:
            out[side].append(timer(sides[side]))
    return out


def spread(ts: Sequence[float], unit: str) -> str:
    return (f"{statistics.median(ts):.3f} {unit} [{min(ts):.3f}..{max(ts):.3f}] "
            f"({'/'.join(f'{t:.3f}' for t in ts)})")


def product_line(label, make, k, dtype, parent_ops, reps, dev, peak) -> str:
    A = make()
    ops = {"parent": parent_ops.WellOperator.from_csr(A, device=dev, storage_dtype=dtype),
           "change": change_ops.WellOperator.from_csr(A, device=dev, storage_dtype=dtype)}
    op = ops["change"]
    npad = op.padded_n
    X = block(npad, A.shape[0], k, k, dev)
    fns = {side: (lambda o=o: o.matvec_multi(X)) for side, o in ops.items()}
    if op.rows.long_rows.numel():
        flat = well_rows(op.vals, op.lidx, op.gidl, op.wrow, op.sgb, op.bg, op.nsg,
                         tile=TILE_MAX)
        if flat.long_rows.numel():
            raise RuntimeError(f"{label}: a row longer than half of TILE_MAX")
        fns["flat alone"] = lambda: well_spmv_multi_cuda(flat, X, npad)
    Y = {side: f() for side, f in fns.items()}
    for side, f in fns.items():
        if not torch.equal(f(), Y[side]):
            raise RuntimeError(f"{label}: the {side}'s product does not repeat bit for bit")
        if not torch.equal(Y["parent"], Y[side]):
            e = float((Y["parent"] - Y[side]).abs().max())
            raise RuntimeError(f"{label}: parent and {side} differ (max abs {e})")
    us = in_turns(fns, reps, lambda f: device_seconds_per_call(f) * 1e6)
    nnz = op.rows.cols.numel()
    nbytes = nnz * (op.rows.rvals.element_size() + 4) + 4 * (npad + 1) + 8 * npad * k
    bound = nbytes / peak * 1e6
    med = {side: statistics.median(ts) for side, ts in us.items()}
    longest = int(torch.diff(op.rows.rowptr).max())
    return (f"{label} (n={A.shape[0]}, {nnz} live slots, longest row {longest}, "
            f"{op.rows.long_rows.numel()} long rows): bit-identical; "
            + ", ".join(f"{side} {spread(ts, 'us')}" for side, ts in us.items()) + "; "
            + ", ".join(f"{side}/parent {med[side] / med['parent']:.4f}"
                        for side in us if side != "parent")
            + f"; bound {bound:.3f} us: "
            + ", ".join(f"{side} {bound / med[side]:.1%}" for side in us) + " of it")


def solve_line(parent_ops, parent_cg, reps, dev) -> str:
    A = fem_p1_system(300_000, seed=0)[0]
    n, k = A.shape[0], 8
    B = block(n, n, k, 8, dev)
    kw = dict(tol=3e-4 * float(B[:, 0].norm()), maxiter=1000, precondition="jacobi", device=dev)
    sides = {"parent": (parent_cg, parent_ops.WellOperator.from_csr(A, device=dev)),
             "change": (change_cg, change_ops.WellOperator.from_csr(A, device=dev))}
    res = {side: cg.cg_solve_multi(op, B, **kw) for side, (cg, op) in sides.items()}
    laps = {side: r.iterations.tolist() for side, r in res.items()}
    if laps["parent"] != laps["change"] or not torch.equal(res["parent"].x, res["change"].x):
        raise RuntimeError(f"{SOLVE}: laps {laps}, x equal "
                           f"{torch.equal(res['parent'].x, res['change'].x)}")
    ms = in_turns({side: (lambda cg=cg, op=op: cg.cg_solve_multi(op, B, **kw))
                   for side, (cg, op) in sides.items()}, reps,
                  lambda f: time_fn(f, warmup=1, iters=5).median * 1e3)
    med = {side: statistics.median(ts) for side, ts in ms.items()}
    return (f"{SOLVE} (n={n}, tol 3e-4 ||B[:, 0]||, maxiter 1000): laps {laps['change']} and x "
            f"bit-identical; parent {spread(ms['parent'], 'ms')}, change "
            f"{spread(ms['change'], 'ms')} a solve; change/parent "
            f"{med['change'] / med['parent']:.4f}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.k13_multi_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", metavar="PARENT_ROOT", help="a checkout of the parent")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="+", default=(), metavar="PREFIX")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k13_multi_ab measures on the card, and there is no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    parent_ops, parent_cg = parent_modules(args.parent, "solver.operators", "solver.cg")
    card = nvidia_smi_card()
    peak = hbm_peak_bytes_per_s(torch.cuda.get_device_name(dev))
    print(f"device: {torch.cuda.get_device_name(dev)} [{card}]; parent {args.parent}; "
          "µs a call, queued", flush=True)

    def wanted(label: str) -> bool:
        return not args.only or any(label.startswith(w) for w in args.only)

    for label, make, k, dtype in product_cases():
        if wanted(label):
            print(product_line(label, make, k, dtype, parent_ops, args.reps, dev, peak),
                  flush=True)
    if wanted(SOLVE):
        print(solve_line(parent_ops, parent_cg, args.reps, dev), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
