#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpucg_torch``) once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: CUDA is required; prints the card, torch and CUDA versions and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build: compiles the kernel library from ``tpucg_torch/kernels/csrc``.
3. kernels: K1 (GEMV, f32 and bf16 A), K2 (fused update) and K3 (dot)
   against their plain PyTorch versions on the card, at the main path's
   shapes, with the tolerances printed; repeat launches are bit-identical.
4. goldens: the reference's 2x2 and 4x4 systems in 2 and 4 laps.
5. flagship: the dense n=8192 system of the reference's benchmark through
   ``DenseOperator`` and ``cg_solve`` on the card, at the NumPy oracle's lap
   count; the kernels' launch counters advance and the plain versions' do
   not. Then n=16384.
6. times: the n=8192 solve and each kernel beside its plain version, with
   the card's name and power limit.

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
    from tpucg_torch.kernels.matvec import matvec_cuda, matvec_torch
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator
    from tpucg_torch.solver.oracle import oracle_cg

    wrappers = (matvec_cuda, matvec_torch, dot_cuda, dot_torch,
                fused_update_cuda, fused_update_torch)
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
            res = cg_solve(g["A"], g["b"], g["x0"], device=dev)
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

    src = "tpucg_torch/kernels/csrc/blas.cu"
    meta = (
        ("K1", "gemv", "matvec_cuda", "tpucg/kernels/matvec.py:108"),
        ("K2", "fused_update", "fused_update_cuda", "tpucg/kernels/blas1.py:111"),
        ("K3", "dot", "dot_cuda", "tpucg/kernels/blas1.py:68"),
    )
    kernels = [
        {"name": f"{kid} {kname}", "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[wrapper], "max_abs_err": err[kid],
         "ms": times[kid][0] * 1e3, "plain_ms": times[kid][1] * 1e3}
        for kid, kname, wrapper, replaces in meta
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
