"""``python -m tpucg_torch``: solve, selftest, bench and info (the
counterparts of tpucg's ``cmd_solve``, ``cmd_selftest``, ``cmd_bench`` and
``cmd_info``). ``solve`` and ``bench`` take tpucg's ``--fused
{auto,always,never}``: ``always`` runs a solve the whole-solve kernels take
(K4 dense, K10 Poisson stencil, K11 DIA) as one launch, ``never`` the lap
path. ``solve A.mtx b.mtx`` reads a MatrixMarket system, optionally
reorders it (``--rcm``, ``--strength-order``) and promotes it with
``best_sparse_operator`` (DIA, BSR, WELL or ELL), as tpucg's
``_cmd_solve_mtx`` does. ``bench --operator poisson-free|poisson-dia|
poisson-ell|poisson-bsr|poisson-auto --m M`` solves tpucg's sparse
flagship, the 3-D Poisson Laplacian on an m^3 grid, in each of tpucg's
bench forms.

Both take tpucg's method options (``cli.py:41-80``): ``--method
cg|pipelined|ca|chebyshev`` with ``--s-step`` (ca), ``--check-every``
(chebyshev) and ``--interval LAM_LO LAM_HI`` (ca and chebyshev: cached
spectrum bounds), and ``--precondition block_jacobi`` with
``--pc-block-size`` (an irregular ``.mtx`` promoted to WELL carries the
blocks taken from its CSR).

``solve`` also takes tpucg's M12 options, serially: ``--two-level AGG``
(with ``--smooth-degree`` and ``--coarse-max``) on a sparse ``.mtx``, and
``--method minres``.

``solve --strategy allgather|overlap`` and ``bench --strategy ...`` /
``bench --compare-strategies`` (serial, allgather, overlap on the dense
system, as tpucg's ``cli.py:945-976, 1014-1021``) run the distributed
solves over ``torch.distributed``: under ``torchrun --nproc-per-node P`` on
its world, else as a world of one rank. Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from typing import Optional

# The reference's serial CG-phase seconds by n (results.xlsx sheet2; the
# values tpucg's bench.py compares against).
BASELINE_S = {512: 0.005, 1024: 0.016, 2048: 0.039, 4096: 0.186, 8192: 0.562}


def _check_solve_options(args) -> None:
    """tpucg's checks of the solve options, and the ROADMAP item of every
    option this port does not run."""
    if args.method == "minres" and (args.two_level is not None or args.interval is not None):
        # MINRES takes neither: building the cycle and stamping "+2lvl" on a
        # solve without it would misstate the configuration (tpucg's check).
        raise SystemExit("--two-level/--interval do not apply to --method minres (MINRES "
                         "preconditioning is --precondition jacobi/block_jacobi)")
    if args.strategy == "summa":
        raise NotImplementedError("--strategy summa (the 2-D SUMMA decomposition) is ROADMAP M14")
    if args.strategy != "serial" and (args.two_level is not None or args.method == "minres"):
        raise NotImplementedError("distributed --two-level and --method minres (M12 on the mesh) "
                                  "are ROADMAP M14 step 5")
    if args.strategy != "serial" and (args.method != "cg" or args.precondition == "block_jacobi"
                                      or args.interval is not None):
        raise NotImplementedError("the distributed pipelined, CA and Chebyshev methods and "
                                  "block Jacobi are ROADMAP M14")


def _minres(op, b, x0, args):
    """``--method minres``: ``minres_solve`` with tpucg's CLI options (tol,
    maxiter, precondition, pc_block_size)."""
    from tpucg_torch.solver.minres import minres_solve

    return minres_solve(op, b, x0, tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
                        precondition=args.precondition, pc_block_size=args.pc_block_size)


def _two_level(args, csr, op):
    """``--two-level AGG``: tpucg's cycle built from the (possibly reordered)
    CSR for the operator's padding and device, with ``--smooth-degree`` and
    ``--coarse-max``; and the format tag, ``+2lvl<AGG>`` and ``x<levels>lv``
    for a multilevel hierarchy."""
    from tpucg_torch.solver.twolevel import build_two_level

    tl = build_two_level(csr, agg_size=args.two_level, npad=op.padded_n,
                         smooth_degree=args.smooth_degree, coarse_max=args.coarse_max,
                         device=op.device)
    tag = f"+2lvl{args.two_level}" + (f"x{tl.levels}lv" if tl.levels > 1 else "")
    return tl, tag


def _method_kw(args) -> dict:
    """The method options of a solve (tpucg's ``s_step``, ``check_every``,
    ``pc_block_size`` and ``interval=``), as ``cg_solve`` takes them."""
    kw = dict(method=args.method, s_step=args.s_step, check_every=args.check_every,
              pc_block_size=args.pc_block_size)
    if args.interval is not None:
        kw["interval"] = tuple(args.interval)
    return kw


def _mesh(device):
    """The mesh of a distributed solve: torchrun's world, or this process as
    a world of one rank; on ``device`` (default: the card when there is one,
    ``cuda:<LOCAL_RANK>``)."""
    import torch

    from tpucg_torch.comm.mesh import make_mesh

    return make_mesh(device=device or ("cuda" if torch.cuda.is_available() else "cpu"))


@contextlib.contextmanager
def _rank0_prints(mesh):
    """Ranks other than 0 print nothing (their results are rank 0's): a
    command whose every rank runs the same calls."""
    if mesh is None or mesh.rank == 0:
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        yield


def _load_rhs_any(path: str, n: int):
    """A length-n vector from .mtx, .npy or the reference's text format."""
    import numpy as np

    from tpucg_torch.io.textio import load_vector

    if path.endswith(".mtx"):
        from tpucg_torch.io.mmio import load_matrix_market

        v = load_matrix_market(path)
        if not isinstance(v, np.ndarray):
            v = v.to_dense()
        v = np.asarray(v, np.float32).ravel()
        if v.size != n:
            raise ValueError(f"{path!r}: expected {n} values, got {v.size}")
        return v
    return load_vector(path, n=n)


def _bf16_operator(op):
    """``--storage bf16`` for a promoted sparse operator: a DIA slab or the
    WELL values re-cast (tpucg's ``_apply_storage``); other formats refuse."""
    import dataclasses

    import torch

    from tpucg_torch.solver.operators import DiaOperator, WellOperator

    if isinstance(op, DiaOperator):
        return dataclasses.replace(op, data=op.data.to(torch.bfloat16))
    if isinstance(op, WellOperator):
        return dataclasses.replace(op, vals=op.vals.to(torch.bfloat16))
    raise SystemExit("--storage bf16 supports dense systems and banded (DIA) or irregular "
                     f"(WELL) operators; got {type(op).__name__}")


def _cmd_solve_mtx(args, t_total0) -> int:
    """A MatrixMarket system: COO -> CSR, an optional reordering, then
    ``best_sparse_operator`` and ``cg_solve``; x is written in the file's
    numbering (tpucg's ``_cmd_solve_mtx``, ``cli.py:207``)."""
    import numpy as np
    import torch

    from tpucg_torch.io.mmio import load_matrix_market
    from tpucg_torch.kernels.dispatch import canonical_device
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator, best_sparse_operator
    from tpucg_torch.solver.sharded import sharded_cg_solve, sharded_operator_cg_solve

    mesh = None if args.strategy == "serial" else _mesh(args.device)
    device = canonical_device(args.device) if mesh is None else mesh.device
    t0 = time.perf_counter()
    mat = load_matrix_market(args.matrix)
    perm = csr = None
    if isinstance(mat, np.ndarray):
        n, fmt = mat.shape[0], "dense"  # an `array` file: the dense path
    else:
        if mat.shape[0] != mat.shape[1]:
            raise SystemExit(f"matrix is {mat.shape[0]}x{mat.shape[1]}, CG needs square SPD")
        csr = mat.to_csr()
        n = mat.shape[0]
        if args.rcm or args.strength_order is not None:
            # Files in the wild often carry no spatial numbering: RCM (or RCM
            # on the strength-filtered graph) restores locality before the
            # format is chosen; x is un-permuted before it is reported.
            from tpucg_torch.sparse.ordering import permute_csr, rcm_order, strength_order

            perm = (strength_order(csr, theta=args.strength_order)
                    if args.strength_order is not None else rcm_order(csr))
            csr = permute_csr(csr, perm)
    b = _load_rhs_any(args.rhs, n)
    x0 = _load_rhs_any(args.x0, n) if args.x0 else None
    if perm is not None:
        b = b[perm]
        x0 = None if x0 is None else x0[perm]
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if csr is None:
        op = None if mesh else DenseOperator.create(
            mat, backend=args.kernel, device=device,
            dtype=torch.bfloat16 if args.storage == "bf16" else torch.float32)
    else:
        # A distributed solve promotes on the host: each rank places its own
        # block of the operator.
        # A WELL operator carries block Jacobi's blocks, taken from the CSR
        # (its packed slabs are not addressable by (row, column)).
        op = best_sparse_operator(
            csr, backend="auto" if mesh else args.kernel, device="cpu" if mesh else device,
            pc_block_size=args.pc_block_size if args.precondition == "block_jacobi" else None)
        fmt = type(op).__name__
        if mesh is not None and fmt == "WellOperator":
            raise NotImplementedError(
                f"--strategy {args.strategy} on an irregular matrix (promoted to WELL) needs "
                "the WELL shard packers (csr_to_well_sharded), ROADMAP M14")
        if perm is not None:
            fmt += "+strength" if args.strength_order is not None else "+rcm"
        if args.storage == "bf16":
            op = _bf16_operator(op)
            fmt += "+bf16"
    two_level = None
    if args.two_level is not None:
        if csr is None:
            raise SystemExit("--two-level applies to sparse .mtx systems (dense systems "
                             "converge in O(10) laps already)")
        # Contiguous aggregates inherit the ordering's locality (hence --rcm).
        two_level, tag = _two_level(args, csr, op)
        fmt += tag
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
              precondition=args.precondition, poly_degree=args.poly_degree,
              record_residuals=_record(args))
    storage = torch.bfloat16 if args.storage == "bf16" else torch.float32
    if args.method == "minres":  # serial only (_check_solve_options)
        res = _minres(op, b, x0, args)
    elif mesh is None:
        res = cg_solve(op, b, x0, fused=args.fused, two_level=two_level, **kw,
                       **_method_kw(args))
    elif csr is None:
        res = sharded_cg_solve(mat, b, x0, mesh=mesh, strategy=args.strategy,
                               storage_dtype=storage, **kw)
    else:
        res = sharded_operator_cg_solve(op, b, x0, mesh=mesh, storage_dtype=storage, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return 0 if bool(res.converged) else 3  # rank 0 reports and writes x
    print(f"system size          : {n} x {n}  [{fmt}]")
    print(f"device               : {device} [{op.backend}]" if mesh is None else
          f"strategy             : {args.strategy} [{mesh!r}]")
    print(f"data load (s)        : {load_s:.6f}  (parse, reordering)")
    print(f"operator build (s)   : {build_s:.6f}  (promotion, packing, placement"
          + (", two-level set-up)" if two_level is not None else ")"))
    print(f"CG solve (s)         : {solve_s:.6f}")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    return _report(args, res, perm, n)


def _record(args) -> bool:
    """``--residual-history`` records with ``--method cg`` only; elsewhere it
    says so and records none, as tpucg's CLI does."""
    if args.residual_history and args.method != "cg":
        print("note: --residual-history requires --method cg; no history will be recorded")
        return False
    return args.residual_history


def _report(args, res, perm, n) -> int:
    """The iterations, residual, convergence and x of a solve, as tpucg's
    CLI prints them; x un-permuted to the file's numbering."""
    import numpy as np

    from tpucg_torch.io.textio import save_array

    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if res.residual_history is not None:
        hist = res.residual_history.cpu().numpy()
        for i in range(int(res.iterations) + 1):
            print(f"  ||r_{i}||{' ' * (12 - len(str(i)))}: {hist[i]:.6e}")
    x = res.x.cpu().numpy()
    if perm is not None:
        xo = np.empty_like(x[:n])
        xo[perm] = x[:n]
        x = xo
    if args.print_solution:
        np.set_printoptions(threshold=64, precision=7)
        print(f"x                    : {x}")
    if args.output:
        save_array(args.output, x, fmt="%r")
        print(f"solution written     : {args.output}")
    return 0 if bool(res.converged) else 3


def cmd_solve(args) -> int:
    import torch

    from tpucg_torch.io.textio import load_system
    from tpucg_torch.kernels.dispatch import canonical_device
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator
    from tpucg_torch.solver.sharded import sharded_cg_solve

    _check_solve_options(args)
    t_total0 = time.perf_counter()
    if args.matrix.endswith(".mtx"):
        return _cmd_solve_mtx(args, t_total0)
    if args.two_level is not None:
        raise SystemExit("--two-level applies to sparse .mtx systems (dense systems converge in "
                         "O(10) laps already)")
    A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
    n = A.shape[0]
    load_s = time.perf_counter() - t_total0
    mesh = None if args.strategy == "serial" else _mesh(args.device)
    device = canonical_device(args.device) if mesh is None else mesh.device
    storage = torch.bfloat16 if args.storage == "bf16" else torch.float32
    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
              precondition=args.precondition, poly_degree=args.poly_degree,
              record_residuals=_record(args))
    t0 = time.perf_counter()
    if mesh is None:
        op = DenseOperator.create(A, backend=args.kernel, device=device, dtype=storage)
        if args.method == "minres":
            res = _minres(op, b, x0, args)
        else:
            res = cg_solve(op, b, x0, fused=args.fused, **kw, **_method_kw(args))
        where = f"{device} [{op.backend}]"
    else:
        res = sharded_cg_solve(A, b, x0, mesh=mesh, strategy=args.strategy,
                               storage_dtype=storage, **kw)
        where = f"{mesh!r}, strategy {args.strategy}"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return 0 if bool(res.converged) else 3  # rank 0 reports and writes x
    print(f"system size          : {n} x {n}")
    print(f"device               : {where}")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes operator placement)")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    return _report(args, res, None, n)


def cmd_selftest(args) -> int:
    import numpy as np
    import torch

    from tpucg_torch.io import _native
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
    from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
    from tpucg_torch.solver.cg import cg_solve, cg_solve_multi
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
    m = 16
    for route in ("poisson-free", "poisson-dia"):
        for fused in ("never", "always"):
            op, b, _, _ = _poisson_system(route, m, torch.float32, args.kernel, device)
            tol = 1e-5 * float(np.linalg.norm(b))
            r = cg_solve(op, b, tol=tol, maxiter=4 * op.n, kernel=args.kernel, fused=fused)
            rel = float(np.linalg.norm(op.matvec(r.x).cpu().numpy() - b) / np.linalg.norm(b))
            check(f"{route} m={m} fused={fused}", bool(r.converged) and rel < 2e-5,
                  f"{int(r.iterations)} iters, ||b - A x|| / ||b|| = {rel:.2e}")
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
    B = np.stack([b, 0.5 * b], axis=1).astype(np.float32)
    rm = cg_solve_multi(A, B, kernel=args.kernel, device=device)
    check("multi-RHS (k=2)", bool(rm.converged.all())
          and np.allclose(rm.x[:, 0].cpu().numpy(), x_ref, atol=1e-4),
          f"iters {[int(i) for i in rm.iterations]}")
    native = _native._load() is not None
    print(f"  [{'ok' if native else '--'}] native fast parser "
          f"({'loaded' if native else 'unavailable; NumPy parser in use'})")
    if failures:
        print(f"FAILED: {failures}")
        return 1
    print("all selftests passed")
    return 0


def _poisson_system(route: str, m: int, storage, kernel: str, device):
    """tpucg's sparse bench system (``cli.py:_build_bench_system``): the
    m^3 Poisson Laplacian as the stencil operator (``poisson-free``), in DIA
    form (``poisson-dia``, built in O(n) with no CSR), or from its CSR as
    ELLPACK (``poisson-ell``), block-ELL with 8 x 8 blocks (4 x 4 when 8
    does not divide n; ``poisson-bsr``) or what ``best_sparse_operator``
    picks (``poisson-auto``); x_true standard normal from ``default_rng(0)``
    (f32) and b = A x_true on the host. bf16 storage applies to the dense
    and DIA forms. Returns (operator, b, nnz, matvec bytes)."""
    import numpy as np
    import torch

    from tpucg_torch.bench.timing import dia_spmv_bytes, poisson_nnz, stencil_bytes
    from tpucg_torch.io.generator import poisson3d_csr, poisson3d_dia
    from tpucg_torch.solver.operators import (
        BsrOperator,
        DiaOperator,
        EllOperator,
        PoissonOperator,
        best_sparse_operator,
    )
    from tpucg_torch.sparse.formats import csr_to_bsr

    x_true = np.random.default_rng(0).standard_normal(m ** 3).astype(np.float32)
    if route in ("poisson-free", "poisson-dia"):
        dia = poisson3d_dia(m)
        b = dia.matvec(x_true)
        if route == "poisson-free":
            op = PoissonOperator(m=m, backend=kernel, device=device)
            return op, b, poisson_nnz(m), stencil_bytes(op.n)
        op = DiaOperator.from_dia(dia, backend=kernel, storage_dtype=storage, device=device)
        return op, b, poisson_nnz(m), dia_spmv_bytes(op.ndiag, op.padded_n,
                                                     op.data.element_size())
    if storage != torch.float32:
        raise SystemExit(f"--storage bf16 applies to the dense and poisson-dia forms, not {route}")
    csr = poisson3d_csr(m)
    b = csr.matvec(x_true)
    n = csr.shape[0]
    if route == "poisson-ell":
        op = EllOperator.from_csr(csr, backend=kernel, device=device)
        return op, b, csr.nnz, op.values.numel() * 8 + 8 * n
    if route == "poisson-bsr":
        op = BsrOperator.from_bsr(csr_to_bsr(csr, 8 if n % 8 == 0 else 4), backend=kernel,
                                  device=device)
        return op, b, csr.nnz, op.values.numel() * 4 + op.indices.numel() * 4 + 8 * op.padded_n
    op = best_sparse_operator(csr, backend=kernel, device=device)
    if not isinstance(op, DiaOperator):
        raise AssertionError(f"best_sparse_operator picked {type(op).__name__} for Poisson")
    return op, b, csr.nnz, dia_spmv_bytes(op.ndiag, op.padded_n, op.data.element_size())


def cmd_bench(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench measures on the card, and there is no CUDA device", file=sys.stderr)
        return 2
    strategies = ("serial", "allgather", "overlap") if args.compare_strategies else (
        args.strategy,)
    if args.operator != "dense" and strategies != ("serial",):
        raise SystemExit("the distributed bench runs the dense system (--operator dense)")
    mesh = None if strategies == ("serial",) else _mesh("cuda")
    with _rank0_prints(mesh):
        # tpucg's --compare-strategies (cli.py:1014-1021): the reference's
        # question, collective against point-to-point, beside serial; one
        # report each on stderr, the JSON line of the first arm.
        lines = [_bench_one(args, strategy, mesh) for strategy in strategies]
        print(json.dumps(lines[0]))
    return 0


def _bench_one(args, strategy: str, mesh) -> dict:
    """One bench arm: the report on stderr, the JSON line returned."""
    import numpy as np
    import torch

    from tpucg_torch.bench.timing import (
        BenchReport,
        device_timing,
        gemv_bytes,
        hbm_peak_bytes_per_s,
        nvidia_smi_card,
        profile_table,
        time_fn,
    )
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator
    from tpucg_torch.solver.sharded import distribute_system, sharded_cg_solve

    storage = torch.bfloat16 if args.storage == "bf16" else torch.float32
    t_total0 = time.perf_counter()
    kw = dict(kernel=args.kernel, precondition=args.precondition, poly_degree=args.poly_degree)
    if strategy == "serial":
        kw.update(_method_kw(args))
    elif args.method != "cg" or args.precondition == "block_jacobi" or args.interval is not None:
        raise NotImplementedError("the distributed pipelined, CA and Chebyshev methods and "
                                  "block Jacobi are ROADMAP M14")
    if args.operator == "dense":
        n = args.n
        A, b, x0 = generate_spd_system(n, seed=0)
        tol, maxiter, nnz = 1.0e-6, None, None
        # Distribution phase: placing the padded operator, or this rank's
        # block of it, on the card (the reference's MPI_Scatter phase).
        t0 = time.perf_counter()
        if strategy != "serial":
            system = distribute_system(A, b, x0, mesh, strategy=strategy, storage_dtype=storage)
            torch.cuda.synchronize()
            distribute_s = time.perf_counter() - t0

            def solve():
                return sharded_cg_solve(system, mesh=mesh, strategy=strategy,
                                        storage_dtype=storage, tol=tol, **kw)
        else:
            op = DenseOperator.create(A, backend=args.kernel, device="cuda", dtype=storage)
            mv_bytes = gemv_bytes(op.padded_n, op.padded_n, op.A.element_size())
    else:
        t0 = time.perf_counter()  # the slab's generation and placement
        op, b, nnz, mv_bytes = _poisson_system(args.operator, args.m, storage, args.kernel,
                                               "cuda")
        n, x0, maxiter = op.n, None, 4 * op.n
        # Large-norm sparse systems: an absolute 1e-6 is below the f32
        # residual floor (tpucg's choice, cli.py:938-943).
        tol = 1.0e-5 * float(np.linalg.norm(b))
    if strategy == "serial":
        bd = torch.as_tensor(b, device="cuda")
        x0d = None if x0 is None else torch.as_tensor(x0, device="cuda")
        torch.cuda.synchronize()
        distribute_s = time.perf_counter() - t0

        def solve():
            return cg_solve(op, bd, x0d, fused=args.fused, tol=tol, maxiter=maxiter, **kw)

    res = solve()
    solve_t = time_fn(solve, warmup=1, iters=args.repeats)
    matvec_t = None
    if strategy == "serial":
        v = torch.ones(op.padded_n, device="cuda")
        op.matvec(v)
        # The matvec kernel's own device time: back-to-back wrapper calls are
        # bound by host overhead for the sparse kernels (10-30 us of work).
        matvec_t = device_timing(lambda: op.matvec(v), iters=args.repeats)
        where, padded_n = f"{op.backend} fused={args.fused}", op.padded_n
    else:
        where, padded_n = f"{strategy} on {mesh!r}", system.part.n_padded
    report = BenchReport(
        n=n,
        iterations=int(res.iterations),
        residual_norm=float(res.residual_norm),
        distribute_s=distribute_s,
        solve=solve_t,
        total_s=time.perf_counter() - t_total0,
        card=nvidia_smi_card(),
        backend=(f"{args.operator} {args.storage} {where} method={args.method} "
                 f"precondition={args.precondition}"),
        padded_n=padded_n,
        matvec=matvec_t,
        matvec_bytes=None if matvec_t is None else mv_bytes,
        nnz=nnz,
    ).finalize(hbm_peak_bytes_per_s())
    print(report.pretty(), file=sys.stderr)
    if args.profile:
        # A separate traced run: the timed solves above ran with tracing off.
        # Every rank traces (the solves' collectives need them all); rank 0
        # writes the trace.
        path = args.profile if strategy == "serial" else os.path.join(args.profile, strategy)
        if mesh is None or mesh.rank == 0:
            os.makedirs(path, exist_ok=True)
        print(profile_table(solve, 5, os.path.join(path, "trace.json")
                            if mesh is None or mesh.rank == 0 else None), file=sys.stderr)
    if args.operator == "dense":
        baseline = BASELINE_S.get(n)
        return {
            "metric": f"dense_cg_solve_time_n{n}",
            "value": round(solve_t.median, 6),
            "unit": "s",
            "vs_baseline": round(baseline / solve_t.median, 2) if baseline else None,
        }
    # The reference C code has no sparse solve: no vs_baseline.
    return {
        "metric": f"{args.operator.replace('-', '_')}_cg_solve_time_m{args.m}",
        "value": round(solve_t.median, 6),
        "unit": "s",
    }


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
        description="Conjugate-gradient solver on PyTorch and CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="solve A x = b from text / .npy / .mtx files")
    ps.add_argument("matrix", help="matrix file: one float per line (row-major), .npy, or "
                                   "MatrixMarket .mtx (sparse: promoted to DIA/BSR/WELL/ELL)")
    ps.add_argument("rhs", help="right-hand-side vector file (text, .npy or .mtx)")
    ps.add_argument("x0", nargs="?", default=None, help="initial guess (default zeros)")
    ps.add_argument("--n", type=int, default=None, help="system size (default: from file)")
    ps.add_argument("--tol", type=float, default=1.0e-6)
    ps.add_argument("--maxiter", type=int, default=None)
    ps.add_argument("--residual-history", action="store_true")
    ps.add_argument("--print-solution", action="store_true")
    ps.add_argument("--output", default=None, help="write the solution to this file")
    ps.add_argument("--rcm", action="store_true",
                    help=".mtx: reverse Cuthill-McKee reordering before promotion")
    ps.add_argument("--strength-order", type=float, nargs="?", const=0.25, default=None,
                    metavar="THETA", help=".mtx: RCM on the strength-filtered graph "
                                          "(|a_ij| >= THETA sqrt(|a_ii a_jj|), default 0.25)")
    ps.add_argument("--method", default="cg",
                    choices=("cg", "pipelined", "ca", "chebyshev", "minres"),
                    help="pipelined = Ghysels-Vanroose CG (a lap's dots independent of "
                         "its matvec); ca = s-step CG (one Gram product per --s-step "
                         "laps); chebyshev = Chebyshev iteration (no dot inside a lap, a "
                         "check every --check-every laps); minres = Paige-Saunders MINRES "
                         "for symmetric indefinite systems (--precondition none, jacobi or "
                         "block_jacobi; serial)")
    ps.add_argument("--strategy", default="serial",
                    choices=("serial", "allgather", "overlap", "summa"),
                    help="distributed row-block solve over torch.distributed (under "
                         "torchrun, or one rank): allgather or overlap for a dense A, "
                         "the halo or gather decomposition of a DIA, ELL or BSR .mtx; "
                         "summa (2-D) is ROADMAP M14")
    ps.add_argument("--two-level", type=int, default=None, metavar="AGG",
                    help="two-level preconditioning with AGG-row contiguous aggregates (.mtx "
                         "sparse systems, method cg or pipelined, serial): the coarse-space "
                         "correction that cuts FEM-class lap counts where Jacobi cannot "
                         "(pairs with --rcm); stops on the true residual every 16 laps")
    ps.add_argument("--smooth-degree", type=int, default=1, dest="smooth_degree",
                    help="smoother degree for --two-level: 1 = damped Jacobi; l >= 2 = "
                         "l-step Chebyshev smoothing (l - 1 matvecs a half-cycle)")
    ps.add_argument("--coarse-max", type=int, default=None, dest="coarse_max", metavar="NC",
                    help="with --two-level: recurse to a multilevel hierarchy while a coarse "
                         "level exceeds NC rows (sparse coarse operators, recursive cycles)")
    ps.set_defaults(fn=cmd_solve)

    pt = sub.add_parser("selftest", help="goldens + oracle checks")
    pt.add_argument("--n", type=int, default=256)
    pt.set_defaults(fn=cmd_selftest)

    pb = sub.add_parser("bench", help="solve timing on the card (one JSON line)")
    pb.add_argument("--operator", default="dense",
                    choices=("dense", "poisson-free", "poisson-dia", "poisson-ell",
                             "poisson-bsr", "poisson-auto"),
                    help="dense generator system (--n), or the 3-D Poisson Laplacian on "
                         "an m^3 grid (--m) as a stencil, in DIA form, as ELLPACK, as "
                         "block-ELL, or as best_sparse_operator promotes its CSR")
    pb.add_argument("--n", type=int, default=8192)
    pb.add_argument("--m", type=int, default=128, help="Poisson grid edge (n = m^3)")
    pb.add_argument("--repeats", type=int, default=5, help="timed solves (>= 5)")
    pb.add_argument("--profile", default=None, metavar="DIR",
                    help="also trace 5 solves with torch.profiler: per-kernel device "
                         "time and busy share to stderr, DIR/trace.json (a distributed arm's in "
                         "DIR/<strategy>/)")
    pb.add_argument("--strategy", default="serial", choices=("serial", "allgather", "overlap"),
                    help="the dense solve on one card, or distributed over torch.distributed "
                         "(torchrun's world, or one rank)")
    pb.add_argument("--compare-strategies", action="store_true",
                    help="serial, allgather and overlap in turn on the dense system: a "
                         "report each on stderr, the serial arm's JSON line")
    pb.add_argument("--method", default="cg", choices=("cg", "pipelined", "ca", "chebyshev"),
                    help="the serial solve's method (see solve --method)")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="device / backend / kernel library")
    pi.set_defaults(fn=cmd_info)

    for sp in (ps, pt, pb):
        sp.add_argument("--kernel", default="auto", choices=("auto", "cuda", "torch"))
    for sp in (ps, pb):
        sp.add_argument("--storage", default="f32", choices=("f32", "bf16"),
                        help="storage of the dense A, the DIA slab or the WELL values")
        sp.add_argument("--fused", default="auto", choices=("auto", "always", "never"),
                        help="whole-solve kernels K4/K10/K11 (auto: up to the card's "
                             "measured crossovers; never: the lap path)")
    for sp in (ps, pb):
        sp.add_argument("--precondition", default="none",
                        choices=("none", "jacobi", "block_jacobi", "poly"))
        sp.add_argument("--poly-degree", type=int, default=3,
                        help="degree for --precondition poly (truncated Neumann)")
        sp.add_argument("--pc-block-size", type=int, default=64, dest="pc_block_size",
                        help="diagonal-block size for --precondition block_jacobi "
                             "(inverted once, applied as one batched block product a lap)")
        sp.add_argument("--s-step", type=int, default=3, dest="s_step",
                        help="block size s for --method ca (3-4 suit f32)")
        sp.add_argument("--check-every", type=int, default=8, dest="check_every",
                        help="laps between exact residual checks for --method chebyshev")
        sp.add_argument("--interval", type=float, nargs=2, default=None,
                        metavar=("LAM_LO", "LAM_HI"),
                        help="cached spectrum bounds for --method ca/chebyshev (e.g. from "
                             "tpucg_torch.spectral_interval): skips the per-solve "
                             "power-method set-up")
    for sp in (ps, pt):
        sp.add_argument("--device", default=None, help="torch device (default: the card if any)")
    return p


def main(argv: Optional[list] = None) -> int:
    import torch.distributed as dist

    from tpucg_torch.kernels.dispatch import strict_f32

    args = build_parser().parse_args(argv)
    strict_f32()  # --kernel torch on the card runs the plain f32 references
    started = dist.is_initialized()
    try:
        return args.fn(args)
    finally:
        if not started and dist.is_initialized():  # a distributed command's world
            dist.destroy_process_group()
