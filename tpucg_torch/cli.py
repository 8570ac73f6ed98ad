"""``python -m tpucg_torch``: solve, selftest, bench and info for the dense
slice of the port (the counterparts of tpucg's ``cmd_solve``,
``cmd_selftest``, ``cmd_bench`` and ``cmd_info``). ``solve`` and ``bench``
take tpucg's ``--fused {auto,always,never}``: ``always`` runs a padded n <=
4096 as one launch of the whole-solve kernel K4, ``never`` the lap path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

# The reference's serial CG-phase seconds by n (results.xlsx sheet2; the
# values tpucg's bench.py compares against).
BASELINE_S = {512: 0.005, 1024: 0.016, 2048: 0.039, 4096: 0.186, 8192: 0.562}


def cmd_solve(args) -> int:
    import numpy as np
    import torch

    from tpucg_torch.io.textio import load_system, save_array
    from tpucg_torch.kernels.dispatch import canonical_device
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator

    t_total0 = time.perf_counter()
    A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
    n = A.shape[0]
    load_s = time.perf_counter() - t_total0
    device = canonical_device(args.device)
    t0 = time.perf_counter()
    op = DenseOperator.create(
        A, backend=args.kernel, device=device,
        dtype=torch.bfloat16 if args.storage == "bf16" else torch.float32,
    )
    res = cg_solve(
        op, b, x0, tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
        precondition=args.precondition, poly_degree=args.poly_degree, fused=args.fused,
        record_residuals=args.residual_history,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    print(f"system size          : {n} x {n}")
    print(f"device               : {device} [{op.backend}]")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes operator placement)")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if res.residual_history is not None:
        hist = res.residual_history.cpu().numpy()
        for i in range(int(res.iterations) + 1):
            print(f"  ||r_{i}||{' ' * (12 - len(str(i)))}: {hist[i]:.6e}")
    x = res.x.cpu().numpy()
    if args.print_solution:
        np.set_printoptions(threshold=64, precision=7)
        print(f"x                    : {x}")
    if args.output:
        save_array(args.output, x, fmt="%r")
        print(f"solution written     : {args.output}")
    return 0 if bool(res.converged) else 3


def cmd_selftest(args) -> int:
    import numpy as np
    import torch

    from tpucg_torch.io import _native
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
    from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.oracle import oracle_cg

    device = canonical_device(args.device)
    failures = []

    def check(name, ok, detail=""):
        print(f"  [{'ok' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""))
        if not ok:
            failures.append(name)

    print(f"device: {device} (kernels: {resolve_backend('auto', device)})")
    # fused="always" runs K4 on the card and the lap path elsewhere;
    # fused="never" always runs the lap path.
    for label, g in (("golden 2x2", GOLDEN_2X2), ("golden 4x4", GOLDEN_4X4)):
        for fused in ("never", "always"):
            r = cg_solve(g["A"], g["b"], g["x0"], kernel=args.kernel, device=device,
                         fused=fused)
            ok = (
                int(r.iterations) == g["iters"]
                and bool(r.converged)
                and np.allclose(r.x.cpu().numpy(), g["x_star"], atol=1e-5)
            )
            check(f"{label} fused={fused}", ok,
                  f"{int(r.iterations)} iters, ||r||={float(r.residual_norm):.2e}")
    n = args.n
    A, b, x0 = generate_spd_system(n, seed=0)
    x_ref, k_ref, _ = oracle_cg(A, b, x0)
    for pc in ("none", "jacobi", "poly"):
        r = cg_solve(A, b, x0, precondition=pc, kernel=args.kernel, device=device)
        check(
            f"random SPD n={n} precondition={pc} vs oracle",
            bool(r.converged) and np.allclose(r.x.cpu().numpy(), x_ref, atol=1e-4)
            and (pc != "none" or int(r.iterations) == k_ref),
            f"{int(r.iterations)} iters (oracle {k_ref})",
        )
    native = _native._load() is not None
    print(f"  [{'ok' if native else '--'}] native fast parser "
          f"({'loaded' if native else 'unavailable; NumPy parser in use'})")
    if failures:
        print(f"FAILED: {failures}")
        return 1
    print("all selftests passed")
    return 0


def cmd_bench(args) -> int:
    import torch

    from tpucg_torch.bench.timing import (
        BenchReport,
        hbm_peak_bytes_per_s,
        nvidia_smi_card,
        profile_table,
        time_fn,
    )
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator

    if not torch.cuda.is_available():
        print("bench measures on the card, and there is no CUDA device", file=sys.stderr)
        return 2
    n = args.n
    t_total0 = time.perf_counter()
    A, b, x0 = generate_spd_system(n, seed=0)
    # Distribution phase: placing the padded operator on the card (the
    # reference's MPI_Scatter phase).
    t0 = time.perf_counter()
    op = DenseOperator.create(A, backend=args.kernel, device="cuda")
    bd = torch.as_tensor(b, device="cuda")
    x0d = torch.as_tensor(x0, device="cuda")
    torch.cuda.synchronize()
    distribute_s = time.perf_counter() - t0

    def solve():
        return cg_solve(op, bd, x0d, kernel=args.kernel, fused=args.fused,
                        precondition=args.precondition, poly_degree=args.poly_degree)

    res = solve()
    solve_t = time_fn(solve, warmup=1, iters=args.repeats)
    v = torch.ones(op.padded_n, device="cuda")
    matvec_t = time_fn(lambda: op.matvec(v), warmup=2, iters=args.repeats, reps=20)
    report = BenchReport(
        n=n,
        iterations=int(res.iterations),
        residual_norm=float(res.residual_norm),
        distribute_s=distribute_s,
        solve=solve_t,
        total_s=time.perf_counter() - t_total0,
        card=nvidia_smi_card(),
        backend=f"{op.backend} fused={args.fused} precondition={args.precondition}",
        padded_n=op.padded_n,
        matvec=matvec_t,
    ).finalize(hbm_peak_bytes_per_s())
    print(report.pretty(), file=sys.stderr)
    if args.profile:
        # A separate traced run: the timed solves above ran with tracing off.
        os.makedirs(args.profile, exist_ok=True)
        print(profile_table(solve, 5, os.path.join(args.profile, "trace.json")),
              file=sys.stderr)
    baseline = BASELINE_S.get(n)
    print(json.dumps({
        "metric": f"dense_cg_solve_time_n{n}",
        "value": round(solve_t.median, 6),
        "unit": "s",
        "vs_baseline": round(baseline / solve_t.median, 2) if baseline else None,
    }))
    return 0


def cmd_info(args) -> int:
    import torch

    import tpucg_torch
    from tpucg_torch.bench.timing import hbm_peak_bytes_per_s
    from tpucg_torch.io import _native
    from tpucg_torch.kernels import _lib
    from tpucg_torch.kernels.dispatch import resolve_backend

    cuda = torch.cuda.is_available()
    peak = "no CUDA device"
    if cuda:
        try:
            peak = hbm_peak_bytes_per_s()
        except ValueError:
            peak = "unknown card"
    lib = _lib.library_path()
    print(json.dumps({
        "tpucg_torch_version": tpucg_torch.__version__,
        "torch_version": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device": torch.cuda.get_device_name() if cuda else "cpu",
        "kernel_backend": resolve_backend("auto"),
        "kernel_library": {"built": lib.exists(), "path": str(lib)},
        "hbm_peak_bytes_per_s": peak,
        "native_parser": _native._load() is not None,
    }, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpucg_torch",
        description="Conjugate-gradient solver on PyTorch and CUDA (dense slice)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="solve A x = b from text / .npy files")
    ps.add_argument("matrix", help="matrix file: one float per line (row-major) or .npy")
    ps.add_argument("rhs", help="right-hand-side vector file")
    ps.add_argument("x0", nargs="?", default=None, help="initial guess (default zeros)")
    ps.add_argument("--n", type=int, default=None, help="system size (default: from file)")
    ps.add_argument("--tol", type=float, default=1.0e-6)
    ps.add_argument("--maxiter", type=int, default=None)
    ps.add_argument("--storage", default="f32", choices=("f32", "bf16"))
    ps.add_argument("--residual-history", action="store_true")
    ps.add_argument("--print-solution", action="store_true")
    ps.add_argument("--output", default=None, help="write the solution to this file")
    ps.set_defaults(fn=cmd_solve)

    pt = sub.add_parser("selftest", help="goldens + oracle checks")
    pt.add_argument("--n", type=int, default=256)
    pt.set_defaults(fn=cmd_selftest)

    pb = sub.add_parser("bench", help="dense solve timing on the card (one JSON line)")
    pb.add_argument("--n", type=int, default=8192)
    pb.add_argument("--repeats", type=int, default=5, help="timed solves (>= 5)")
    pb.add_argument("--profile", default=None, metavar="DIR",
                    help="also trace 5 solves with torch.profiler: per-kernel device "
                         "time and busy share to stderr, DIR/trace.json")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="device / backend / kernel library")
    pi.set_defaults(fn=cmd_info)

    for sp in (ps, pt, pb):
        sp.add_argument("--kernel", default="auto", choices=("auto", "cuda", "torch"))
    for sp in (ps, pb):
        sp.add_argument("--fused", default="auto", choices=("auto", "always", "never"),
                        help="whole-solve kernel K4 for padded n <= 4096 (auto: below the "
                             "card's measured crossover; never: the lap path)")
        sp.add_argument("--precondition", default="none", choices=("none", "jacobi", "poly"))
        sp.add_argument("--poly-degree", type=int, default=3,
                        help="degree for --precondition poly (truncated Neumann)")
    for sp in (ps, pt):
        sp.add_argument("--device", default=None, help="torch device (default: the card if any)")
    return p


def main(argv: Optional[list] = None) -> int:
    from tpucg_torch.kernels.dispatch import strict_f32

    args = build_parser().parse_args(argv)
    strict_f32()  # --kernel torch on the card runs the plain f32 references
    return args.fn(args)
