#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpucg_torch``) once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: CUDA is required; prints the card, torch and CUDA versions and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build: compiles the kernel library from ``tpucg_torch/kernels/csrc``.
3. kernels: K1 (GEMV, f32 and bf16 A), K2 (fused update) and K3 (dot)
   against their plain PyTorch versions on the card, at the main path's
   shapes, with the tolerances printed; repeat launches are bit-identical.
4. goldens: the reference's 2x2 and 4x4 systems in 2 and 4 laps through
   the lap path (``fused="never"``).
5. flagship: the dense n=8192 system of the reference's benchmark through
   ``DenseOperator`` and ``cg_solve`` on the card, at the NumPy oracle's lap
   count; the kernels' launch counters advance and the plain versions' do
   not. Then n=16384.
6. times: the n=8192 solve and each kernel beside its plain version, with
   the card's name and power limit.
7. whole-solve K4: ``cg_solve(fused="always")`` at n=1000 and 4096 with
   precondition none, jacobi and poly runs one K4 launch and nothing else,
   at the plain version's lap count (and the oracle's for none), x within
   a bound scaled to x of the plain version's, repeats bit-identical; the
   goldens in 2 and 4 laps through K4; the crossover table of K4 against
   the lap path, n = 128 ... 4096, medians of 7 solves, each arm run twice
   in turns.
8. batched K5: ``cg_solve_batch`` of 64 systems at n=1000 and 16 at
   n=2048, none and jacobi, runs one K5 launch and nothing else; repeats
   are bit-identical; the last system starts at an exact x0 and stops at
   k=0. Two batches (``tests/_torch_helpers.py``): ``circulant_spd_batch``
   at tol 1e-2, whose lap counts (1 to 6) are set by the spectra, must
   match the plain version's system for system; ``shifted_spd_batch`` at
   tol 1e-6, each system from its own seed and shift, stops where the
   rounding of r is of the order of tol, so K5 and its plain version may
   stop one lap apart: for every system that does, r.r / tol^2 at the two
   laps around the split is printed from K5, the plain version and a
   float64 solve. x is held within a bound scaled to x in both.

The line before last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it, as
does a machine without CUDA or a directory without the package.
"""

import contextlib
import json
import sys
import time
from pathlib import Path


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== {name}: FAILED", flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.2f} s)", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import tpucg_torch

    # The kernels must be built from this checkout's sources, not from a
    # copy of the package found elsewhere on the path.
    pkg_root = Path(tpucg_torch.__file__).resolve().parents[1]
    if pkg_root != Path(__file__).resolve().parent:
        print(f"chip_smoke: tpucg_torch comes from {pkg_root}, not this checkout",
              file=sys.stderr)
        return 1

    # The batch generators of the tests (no counterpart in the package).
    sys.path.insert(0, str(pkg_root / "tests"))
    from _torch_helpers import circulant_spd_batch, scaled_err, shifted_spd_batch

    from tpucg_torch.bench.timing import (
        device_seconds_per_call,
        gemv_bytes,
        hbm_peak_bytes_per_s,
        nvidia_smi_card,
        time_fn,
    )
    from tpucg_torch.io.generator import generate_spd_system, generate_spd_system_f32
    from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
    from tpucg_torch.kernels import _lib
    from tpucg_torch.kernels.blas1 import (
        dot_cuda,
        dot_torch,
        fused_update_cuda,
        fused_update_torch,
    )
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.fused import (
        FUSED_AUTO_MAX_N,
        fused_batch_cg_solve_cuda,
        fused_cg_solve_cuda,
    )
    from tpucg_torch.kernels.matvec import matvec_cuda, matvec_torch
    from tpucg_torch.solver.cg import batch_cg_loop, batch_matvec, cg_solve, cg_solve_batch
    from tpucg_torch.solver.fused import fused_batch_cg_solve_torch, fused_cg_solve_torch
    from tpucg_torch.solver.operators import DenseOperator
    from tpucg_torch.solver.oracle import oracle_cg

    wrappers = (matvec_cuda, matvec_torch, dot_cuda, dot_torch,
                fused_update_cuda, fused_update_torch)
    whole = (fused_cg_solve_cuda, fused_cg_solve_torch, fused_batch_cg_solve_cuda,
             fused_batch_cg_solve_torch)

    def drive(fn):
        """Run one main-path call with every launch count at 0 just before
        it; returns its result and the counts just after."""
        torch.cuda.synchronize()
        for w in wrappers + whole:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {w.__name__: w.launches for w in wrappers + whole}

    def only(launched, name):
        """The counts show one launch of `name` and none of anything else."""
        return all(c == (1 if w == name else 0) for w, c in launched.items())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_f32()  # the plain references run in full f32, no TF32

    with phase("device"):
        name = torch.cuda.get_device_name(0)
        card = nvidia_smi_card()
        peak = hbm_peak_bytes_per_s(name)
        print(f"device: {name} (count {torch.cuda.device_count()})")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(card)
        print(f"HBM peak on record: {peak / 1e12:.2f} TB/s")
    tag = f"[{card}]"

    with phase("build"):
        t0 = time.perf_counter()
        fresh = not _lib.library_path().exists()
        path = _lib.build()
        _lib.load()
        print(f"kernel library {path} ({'compiled' if fresh else 'cached'}) "
              f"in {time.perf_counter() - t0:.2f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print("  " + line.strip())

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {}

    def rnd(*shape):
        return 2 * torch.rand(shape, generator=gen, device=dev) - 1

    with phase("kernels vs plain"):
        # K1: |y - y_plain| <= 1e-5 * max(|A| |x|) (f32 sums in two orders).
        ragged = DenseOperator.create(generate_spd_system(1000, seed=0)[0], device=dev).A
        cases = [("8192x8192", rnd(8192, 8192)), ("1024x8192", rnd(1024, 8192)),
                 ("16384x16384", rnd(16384, 16384)), ("n=1000 padded 1024", ragged)]
        for label, A32 in cases:
            x = rnd(A32.shape[1])
            for A in (A32, A32.to(torch.bfloat16)):
                y = matvec_cuda(A, x)
                y_ref = matvec_torch(A, x)
                scale = float((A.float().abs() @ x.abs()).max())
                e = float((y - y_ref).abs().max())
                require(e <= 1e-5 * scale, f"K1 {label} {A.dtype}: err {e} scale {scale}")
                require(torch.equal(y, matvec_cuda(A, x)), f"K1 {label} repeat")
                print(f"K1 {label} {A.dtype}: max abs err {e:.3e} (tol {1e-5 * scale:.3e}), "
                      "repeat bit-identical")
                if label == "8192x8192" and A.dtype == torch.float32:
                    err["K1"] = e
        for n in (8192, 16384):
            x, r, p, ap = (rnd(n) for _ in range(4))
            alpha = torch.tensor(0.37, device=dev)
            xo, ro, beta = fused_update_cuda(x, r, p, ap, alpha)
            xr, rr, beta_r = fused_update_torch(x, r, p, ap, alpha)
            # x', r': one FMA rounding vs two roundings; beta: f32 sums in
            # two orders.
            ex = float((xo - xr).abs().max())
            er = float((ro - rr).abs().max())
            eb = abs(float(beta) - float(beta_r))
            require(torch.allclose(xo, xr, rtol=1e-5, atol=1e-6), f"K2 x' n={n}: {ex}")
            require(torch.allclose(ro, rr, rtol=1e-5, atol=1e-6), f"K2 r' n={n}: {er}")
            require(eb <= 1e-5 * float(beta_r), f"K2 beta n={n}: {eb}")
            again = fused_update_cuda(x, r, p, ap, alpha)
            require(all(torch.equal(a, b) for a, b in zip((xo, ro, beta), again)),
                    f"K2 n={n} repeat")
            d = dot_cuda(p, ap)
            d_ref = dot_torch(p, ap)
            ed = abs(float(d) - float(d_ref))
            scale = float(torch.dot(p.abs(), ap.abs()))
            require(ed <= 1e-5 * scale, f"K3 n={n}: {ed} scale {scale}")
            require(torch.equal(d, dot_cuda(p, ap)), f"K3 n={n} repeat")
            print(f"K2 n={n}: max abs err x' {ex:.3e} r' {er:.3e} beta {eb:.3e} "
                  f"(rtol 1e-5, atol 1e-6; beta rtol 1e-5), repeat bit-identical")
            print(f"K3 n={n}: abs err {ed:.3e} (tol {1e-5 * scale:.3e}), repeat bit-identical")
            if n == 8192:
                err["K2"] = max(ex, er, eb)
                err["K3"] = ed

    with phase("goldens"):
        for label, g in (("2x2", GOLDEN_2X2), ("4x4", GOLDEN_4X4)):
            before = matvec_cuda.launches
            res = cg_solve(g["A"], g["b"], g["x0"], device=dev, fused="never")
            k = int(res.iterations)
            x = res.x.cpu().numpy()
            require(k == g["iters"] and bool(res.converged), f"golden {label}: {k} laps")
            require(np.allclose(x, g["x_star"], atol=1e-5), f"golden {label}: x {x}")
            require(matvec_cuda.launches > before, f"golden {label} ran no K1")
            print(f"golden {label}: {k} laps, x {x}")

    counts = {}
    with phase("flagship solves"):
        for n, make in ((8192, generate_spd_system), (16384, generate_spd_system_f32)):
            A, b, x0 = make(n, seed=0)
            x_ref, k_ref, _ = oracle_cg(A, b, x0)
            op = DenseOperator.create(A, device=dev)
            bd = torch.as_tensor(b, device=dev)
            x0d = torch.as_tensor(x0, device=dev)
            del A
            torch.cuda.synchronize()
            for fn in wrappers:
                fn.launches = 0
            res = cg_solve(op, bd, x0d, device=dev)
            torch.cuda.synchronize()
            launched = {fn.__name__: fn.launches for fn in wrappers}
            if n == 8192:
                counts = launched
            k = int(res.iterations)
            x = res.x.cpu().numpy()
            rel = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
            print(f"n={n}: {k} laps (oracle {k_ref}), ||r|| {float(res.residual_norm):.3e}, "
                  f"rel err vs oracle {rel:.3e}, launches {launched}")
            require(k == k_ref and bool(res.converged), f"n={n}: {k} laps vs oracle {k_ref}")
            require(np.isfinite(x).all() and x.shape == (n,), f"n={n}: x not finite")
            require(rel <= 1e-5, f"n={n}: rel err {rel}")
            for kern in ("matvec_cuda", "dot_cuda", "fused_update_cuda"):
                require(launched[kern] > 0, f"n={n}: {kern} never launched")
            for plain in ("matvec_torch", "dot_torch", "fused_update_torch"):
                require(launched[plain] == 0, f"n={n}: plain {plain} ran on the main path")
            if n == 8192:
                flagship = (op, bd, x0d, k)
            del op, bd, x0d, res

    times = {}
    with phase("times"):
        op, bd, x0d, k = flagship
        op_plain = DenseOperator(A=op.A, n=op.n, backend="torch")
        t_kernel = time_fn(lambda: cg_solve(op, bd, x0d), warmup=1, iters=7)
        t_plain = time_fn(lambda: cg_solve(op_plain, bd, x0d, kernel="torch"), warmup=1, iters=7)
        for label, t in (("cuda kernels", t_kernel), ("plain torch", t_plain)):
            print(f"solve n=8192 ({k} laps), {label}: median {t.median * 1e3:.4f} ms "
                  f"min {t.min * 1e3:.4f} max {t.max * 1e3:.4f} ({t.samples} solves) {tag}")
        v = torch.ones(op.padded_n, device=dev)
        A16 = op.A.to(torch.bfloat16)
        for label, A in (("f32", op.A), ("bf16", A16)):
            tk = time_fn(lambda: matvec_cuda(A, v), warmup=3, iters=7, reps=20)
            tp = time_fn(lambda: matvec_torch(A, v), warmup=3, iters=7, reps=20)
            nbytes = gemv_bytes(*A.shape, A.element_size())
            for who, t in (("K1", tk), ("plain", tp)):
                rate = nbytes / t.median
                flag = "  ABOVE PEAK: timing fault" if rate > peak else ""
                print(f"{who} gemv {label} 8192x8192: {t.median * 1e6:.2f} us, "
                      f"{rate / 1e9:.1f} GB/s, {100 * rate / peak:.1f}% of HBM peak {tag}{flag}")
            if label == "f32":
                times["K1"] = (tk.median, tp.median)
        x, r, p, ap = (rnd(8192) for _ in range(4))
        alpha = torch.tensor(0.37, device=dev)
        pairs = {
            "K2": (lambda: fused_update_cuda(x, r, p, ap, alpha),
                   lambda: fused_update_torch(x, r, p, ap, alpha)),
            "K3": (lambda: dot_cuda(p, ap), lambda: dot_torch(p, ap)),
        }
        for kname, (fk, fp) in pairs.items():
            # Back-to-back wrapper calls are bound by host overhead at this
            # size; the profiler gives the device time of what each launches.
            tk = time_fn(fk, warmup=3, iters=7, reps=200)
            tp = time_fn(fp, warmup=3, iters=7, reps=200)
            dk, dp = device_seconds_per_call(fk), device_seconds_per_call(fp)
            times[kname] = (dk, dp)
            print(f"{kname} n=8192: device {dk * 1e6:.2f} us per call, plain {dp * 1e6:.2f} us "
                  f"(profiler); back to back {tk.median * 1e6:.2f} us per call, plain "
                  f"{tp.median * 1e6:.2f} us (host-bound) {tag}")

    def pad_to(t, npad):
        return torch.nn.functional.pad(t, (0, npad - t.shape[-1]))

    with phase("whole-solve K4"):
        counts["fused_cg_solve_cuda"] = 0
        err["K4"] = 0.0
        for n in (1000, 4096):
            A, b, x0 = generate_spd_system(n, seed=0)
            k_ref = oracle_cg(A, b, x0)[1]
            op = DenseOperator.create(A, device=dev)
            bd, x0d = torch.as_tensor(b, device=dev), torch.as_tensor(x0, device=dev)
            bp, x0p = pad_to(bd, op.padded_n), pad_to(x0d, op.padded_n)
            d = op.diagonal()
            minv = torch.where(d != 0, 1.0 / d, 1.0)
            for pc in ("none", "jacobi", "poly"):
                res, launched = drive(lambda: cg_solve(op, bd, x0d, fused="always",
                                                       precondition=pc, poly_degree=3))
                counts["fused_cg_solve_cuda"] += launched["fused_cg_solve_cuda"]
                require(only(launched, "fused_cg_solve_cuda"),
                        f"K4 n={n} {pc}: launches {launched}")
                kw = dict(tol=1e-6, maxiter=n, precondition=pc,
                          poly_degree=3 if pc == "poly" else 0,
                          minv=minv if pc == "jacobi" else None)
                x, k, rr = fused_cg_solve_cuda(op.A, bp, x0p, **kw)
                xp, kp, _ = fused_cg_solve_torch(op.A, bp, x0p, **kw)
                laps = int(k)
                require(laps == int(kp) == int(res.iterations) and bool(res.converged),
                        f"K4 n={n} {pc}: {laps} laps, plain {int(kp)}, cg_solve "
                        f"{int(res.iterations)}")
                if pc == "none":
                    require(laps == k_ref, f"K4 n={n}: {laps} laps vs oracle {k_ref}")
                # Relative to x's size (x ~ 1/n here): max |x - x_plain| <=
                # 1e-5 max |x_plain| for none/jacobi (f32 sums in another
                # order), 1e-4 for poly (its power method and Neumann terms
                # sum in other orders too).
                bound = 1e-4 if pc == "poly" else 1e-5
                e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                require(se <= bound, f"K4 n={n} {pc}: err {e}, {se} of max |x|")
                require(torch.equal(res.x, x[:n]), f"K4 n={n} {pc}: cg_solve's x differs")
                again = fused_cg_solve_cuda(op.A, bp, x0p, **kw)
                require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                        f"K4 n={n} {pc} repeat")
                err["K4"] = max(err["K4"], e)
                print(f"K4 n={n} {pc}: {laps} laps (plain {int(kp)}"
                      + (f", oracle {k_ref}" if pc == "none" else "")
                      + f"), ||r|| {float(rr) ** 0.5:.3e}, max abs err vs plain {e:.3e} = "
                      f"{se:.3e} of max |x| (bound {bound}), repeat bit-identical")
            if n == 1000:
                kw = dict(tol=1e-6, maxiter=n)
                times["K4"] = (time_fn(lambda: fused_cg_solve_cuda(op.A, bp, x0p, **kw),
                                       warmup=2, iters=7).median,
                               time_fn(lambda: fused_cg_solve_torch(op.A, bp, x0p, **kw),
                                       warmup=2, iters=7).median)
            del op, A
        for label, g in (("2x2", GOLDEN_2X2), ("4x4", GOLDEN_4X4)):
            res, launched = drive(lambda: cg_solve(g["A"], g["b"], g["x0"], device=dev,
                                                   fused="always"))
            counts["fused_cg_solve_cuda"] += launched["fused_cg_solve_cuda"]
            k = int(res.iterations)
            x = res.x.cpu().numpy()
            require(k == g["iters"] and np.allclose(x, g["x_star"], atol=1e-5),
                    f"golden {label} through K4: {k} laps, x {x}")
            require(only(launched, "fused_cg_solve_cuda"), f"golden {label}: {launched}")
            print(f"golden {label} through K4: {k} laps, x {x}")
        print(f"crossover, solve through cg_solve: K4 (fused='always') vs the lap path "
              f"(fused='never'), generate_spd_system seed 0, medians of 7 (ms), each arm "
              f"twice in turns; FUSED_AUTO_MAX_N = {FUSED_AUTO_MAX_N} {tag}")
        crossover = {}
        for n in (128, 256, 512, 1024, 2048, 4096):
            A, b, x0 = generate_spd_system(n, seed=0)
            op = DenseOperator.create(A, device=dev)
            bd, x0d = torch.as_tensor(b, device=dev), torch.as_tensor(x0, device=dev)
            arms = {}
            for fused in ("never", "always", "always", "never"):
                t = time_fn(lambda: cg_solve(op, bd, x0d, fused=fused), warmup=2, iters=7)
                arms.setdefault(fused, []).append(t.median * 1e3)
            crossover[n] = arms
            lap, k4 = arms["never"], arms["always"]
            print(f"  n={n}: lap path {lap[0]:.4f} / {lap[1]:.4f} ms, K4 {k4[0]:.4f} / "
                  f"{k4[1]:.4f} ms, K4 faster: {max(k4) < min(lap)}")
            del op, A

    def padded_batch(As, bs, X0):
        """The batch as cg_solve_batch pads it (identity tail), with Jacobi's
        minv."""
        nsys, n = bs.shape
        npad = -(-n // 128) * 128
        Ad = torch.zeros((nsys, npad, npad), device=dev)
        Ad[:, :n, :n] = torch.as_tensor(As, device=dev)
        tail = torch.arange(n, npad, device=dev)
        Ad[:, tail, tail] = 1.0
        d = torch.diagonal(Ad, dim1=1, dim2=2)
        return (Ad, pad_to(torch.as_tensor(bs, device=dev), npad),
                pad_to(torch.as_tensor(X0, device=dev), npad), torch.where(d != 0, 1.0 / d, 1.0))

    def split_report(Ad, bp, x0p, kw, k, kp):
        """For each system where K5 and its plain version stop on different
        laps, r.r / tol^2 at the lap before the earlier stop and at it, from
        K5, the plain version and a float64 solve (batch_cg_loop on the same
        A, b, x0 and minv in float64); each run to that lap by maxiter."""
        k, kp = k.tolist(), kp.tolist()
        split = [i for i in range(len(k)) if k[i] != kp[i]]
        tol2 = kw["tol"] ** 2
        at = {}
        A64, b64, x064 = Ad.double(), bp.double(), x0p.double()
        minv64 = None if kw["minv"] is None else kw["minv"].double()
        for j in sorted({min(k[i], kp[i]) + d for i in split for d in (-1, 0)}):
            kwj = dict(kw, maxiter=j)
            s64 = batch_cg_loop(batch_matvec(A64), b64, x064, tol=kw["tol"], maxiter=j,
                                precond=None if minv64 is None else
                                (lambda r, act=None: minv64 * r))
            at[j] = [t.double().cpu() / tol2 for t in (
                fused_batch_cg_solve_cuda(Ad, bp, x0p, **kwj)[2],
                fused_batch_cg_solve_torch(Ad, bp, x0p, **kwj)[2], s64.rslast)]
        del A64
        for i in split:
            m = min(k[i], kp[i])
            cells = "; ".join(f"lap {j}: K5 {float(at[j][0][i]):.6g}, plain "
                              f"{float(at[j][1][i]):.6g}, f64 {float(at[j][2][i]):.6g}"
                              for j in (m - 1, m))
            print(f"  split system {i}: K5 {k[i]} laps, plain {kp[i]}; r.r/tol^2 at {cells}")
        return split

    with phase("batched K5"):
        counts["fused_batch_cg_solve_cuda"] = 0
        err["K5"] = 0.0
        batches = (
            # Lap counts fixed by the spectra (1 + i % 6 levels): tol 1e-2
            # lies far from ||r|| on both sides of the last lap.
            ("circulant", circulant_spd_batch, 1e-2),
            # Stops where the rounding of r is of the order of tol: K5 and
            # the plain version may stop one lap apart (split_report).
            ("shifted", shifted_spd_batch, 1e-6),
        )
        for nsys, n in ((64, 1000), (16, 2048)):
            for kind, make, tol in batches:
                As, bs, X0 = make(nsys, n, seed=100)
                Ad, bp, x0p, minv = padded_batch(As, bs, X0)
                for pc in ("none", "jacobi"):
                    what = f"K5 {kind} {nsys}x{n} {pc}"
                    res, launched = drive(lambda: cg_solve_batch(As, bs, X0, device=dev,
                                                                 precondition=pc, tol=tol))
                    counts["fused_batch_cg_solve_cuda"] += launched["fused_batch_cg_solve_cuda"]
                    require(only(launched, "fused_batch_cg_solve_cuda"),
                            f"{what}: launches {launched}")
                    kw = dict(tol=tol, maxiter=n, precondition=pc,
                              minv=minv if pc == "jacobi" else None)
                    x, k, rr = fused_batch_cg_solve_cuda(Ad, bp, x0p, **kw)
                    xp, kp, _ = fused_batch_cg_solve_torch(Ad, bp, x0p, **kw)
                    laps = k.tolist()
                    require(laps == res.iterations.tolist(), f"{what}: cg_solve_batch's laps")
                    require(bool(res.converged.all()), f"{what}: not converged")
                    require(laps[-1] == 0 and min(laps[:-1]) > 0, f"{what}: laps {laps}")
                    e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                    require(se <= 1e-4, f"{what}: err {e}, {se} of max |x|")
                    require(torch.equal(res.x, x[:, :n]), f"{what}: x differs")
                    again = fused_batch_cg_solve_cuda(Ad, bp, x0p, **kw)
                    require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                            f"{what} repeat")
                    if kind == "circulant":
                        require(laps == kp.tolist() == [1 + i % 6 for i in range(nsys - 1)] + [0],
                                f"{what}: laps {laps} vs plain {kp.tolist()}")
                        require(torch.allclose(x, xp, rtol=1e-5, atol=1e-6), f"{what}: err {e}")
                        agree = "equal to plain"
                    else:
                        require(int((k - kp).abs().max()) <= 1,
                                f"{what}: laps {laps} vs plain {kp.tolist()}")
                        split = split_report(Ad, bp, x0p, kw, k, kp)
                        agree = f"{len(split)} of {nsys} a lap apart from plain, none further"
                    err["K5"] = max(err["K5"], e)
                    print(f"{what} (tol {tol}): laps min {min(laps[:-1])} max {max(laps)} "
                          f"({len(set(laps))} distinct, system {nsys - 1} at 0), {agree}; "
                          f"max abs err {e:.3e} = {se:.3e} of max |x| (bound 1e-4), repeat "
                          f"bit-identical")
                    if (kind, nsys, pc) == ("circulant", 64, "none"):
                        tk = time_fn(lambda: fused_batch_cg_solve_cuda(Ad, bp, x0p, **kw),
                                     warmup=1, iters=5)
                        tp = time_fn(lambda: fused_batch_cg_solve_torch(Ad, bp, x0p, **kw),
                                     warmup=1, iters=5)
                        times["K5"] = (tk.median, tp.median)
                        print(f"K5 64x1000 none: {tk.median * 1e3:.4f} ms (min "
                              f"{tk.min * 1e3:.4f}, max {tk.max * 1e3:.4f}) vs plain "
                              f"{tp.median * 1e3:.4f} ms {tag}")
                del Ad, As, res
        print(f"K4 n=1000 none: {times['K4'][0] * 1e3:.4f} ms vs plain "
              f"{times['K4'][1] * 1e3:.4f} ms {tag}")

    meta = (
        ("K1", "gemv", "matvec_cuda", "blas.cu", "tpucg/kernels/matvec.py:108"),
        ("K2", "fused_update", "fused_update_cuda", "blas.cu", "tpucg/kernels/blas1.py:111"),
        ("K3", "dot", "dot_cuda", "blas.cu", "tpucg/kernels/blas1.py:68"),
        ("K4", "fused_cg_solve", "fused_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:234"),
        ("K5", "fused_batch_cg_solve", "fused_batch_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:610"),
    )
    kernels = [
        {"name": f"{kid} {kname}", "route": "cuda",
         "source": f"tpucg_torch/kernels/csrc/{src}", "replaces": replaces,
         "launches": counts[wrapper], "max_abs_err": err[kid],
         "ms": times[kid][0] * 1e3, "plain_ms": times[kid][1] * 1e3}
        for kid, kname, wrapper, src, replaces in meta
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
