"""``python -m tpucg_torch``: solve, generate, convert, selftest, bench and
info (the counterparts of tpucg's ``cmd_solve``, ``cmd_generate``,
``cmd_convert``, ``cmd_selftest``, ``cmd_bench`` and ``cmd_info``, with
tpucg's output and refusals). ``solve`` and ``bench`` take tpucg's ``--fused
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

``solve`` also takes tpucg's M12 options: ``--two-level AGG`` (with
``--smooth-degree`` and ``--coarse-max``) on a sparse ``.mtx``, and
``--method minres``; with ``--strategy`` too (two-level on the WELL and DIA
decompositions, tpucg's ``cli.py:374-400``).

``solve --checkpoint PATH --segment-iters N`` runs tpucg's segmented
solve (``cg_solve_checkpointed``) on a dense or ``.mtx`` system: the state
goes to PATH every N laps, a run that stops unconverged (rc 3) leaves the
file, and the same command run again resumes from it. The file is tpucg's,
so either package's CLI resumes the other's. With ``--strategy`` it runs on
the mesh (tpucg's ``cli.py:375-387``): ``sharded_cg_solve_checkpointed``
on the rank's host-sharded dense block (a file per rank on more than one
rank) or ``sharded_operator_cg_solve_checkpointed`` on a sparse ``.mtx``
(the whole-state file).

``solve --strategy allgather|overlap`` and ``bench --strategy ...`` /
``bench --compare-strategies`` (serial, allgather, overlap on the dense
system, as tpucg's ``cli.py:945-976, 1014-1021``) run the distributed
solves over ``torch.distributed``: under ``torchrun --nproc-per-node P`` on
its world, else as a world of one rank; an irregular ``.mtx`` (promoted to
WELL) goes to the ranks as its CSR, packed into row blocks of WELL. A
dense text or ``.npy`` system is loaded host-sharded
(``load_system_sharded``: each rank parses only its own rows, tpucg's
``cli.py:575-600``; ``--storage bf16`` is refused there, as tpucg's CLI
refuses it). They take the method options and block Jacobi as the serial
solve does (ELL and BSR refuse block Jacobi, as tpucg's sharded solve
does). Only rank 0 prints.

``solve --deflate V`` deflates a dense system with the basis V (serial or
on the mesh); ``info --spectrum MATRIX`` prints the bounds that ``solve
--interval`` takes; ``bench --json`` adds each arm's report as a JSON line
before the metric line and ``bench --tol`` sets the solve's tolerance.
``--devices K`` must name the world's size, and ``--debug-nans`` checks the
result once for NaN and Inf (tpucg's flag checks every operation).
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
    if args.checkpoint is not None and args.interval is not None:
        raise SystemExit("--interval does not compose with --checkpoint")


def _checkpoint_left(args, mesh) -> bool:
    """The solve left its file: the whole-state one, or this rank's of a
    per-rank checkpoint."""
    paths = [args.checkpoint] + ([f"{args.checkpoint}.proc{mesh.rank}"] if mesh else [])
    return any(os.path.exists(p) for p in paths)


def _checkpoint_kw(args, mesh=None) -> dict:
    """The checkpointed solves' options from the command line (method and
    precondition forwarded, so their refusals fire; the strategy on a
    mesh), with tpucg's note that no residual history is recorded."""
    if args.residual_history and (mesh is None or mesh.rank == 0):
        print("note: --residual-history is not recorded by checkpointed solves")
    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel, method=args.method,
              precondition=args.precondition, pc_block_size=args.pc_block_size,
              segment_iters=args.segment_iters, checkpoint_path=args.checkpoint)
    if mesh is not None:
        kw["strategy"] = args.strategy
    return kw


def _minres(op, b, x0, args, mesh=None):
    """``--method minres``: ``minres_solve``, or ``sharded_minres_solve`` on
    a mesh, with tpucg's CLI options (tol, maxiter, precondition,
    pc_block_size; the strategy on a mesh)."""
    from tpucg_torch.solver.minres import minres_solve, sharded_minres_solve

    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
              precondition=args.precondition, pc_block_size=args.pc_block_size)
    if mesh is None:
        return minres_solve(op, b, x0, **kw)
    return sharded_minres_solve(op, b, x0, mesh=mesh, strategy=args.strategy, **kw)


def _two_level(args, csr, op, mesh=None):
    """``--two-level AGG``: tpucg's cycle built from the (possibly reordered)
    CSR for the operator's padding and device (on a mesh: the WELL and DIA
    decompositions' padding, round_up(n, 128 P), on the mesh's device; other
    formats refuse, as tpucg's CLI does), with ``--smooth-degree`` and
    ``--coarse-max``; and the format tag, ``+2lvl<AGG>`` and ``x<levels>lv``
    for a multilevel hierarchy."""
    from tpucg_torch.io.partitioner import round_up
    from tpucg_torch.solver.operators import DiaOperator, WellOperator
    from tpucg_torch.solver.twolevel import build_two_level

    if mesh is None:
        npad, device = op.padded_n, op.device
    else:
        if not isinstance(op, (WellOperator, DiaOperator)):
            raise SystemExit("--two-level with sharded strategies supports the WELL/DIA "
                             f"decompositions (this matrix promoted to {type(op).__name__})")
        npad, device = round_up(csr.shape[0], 128 * mesh.size), mesh.device
    tl = build_two_level(csr, agg_size=args.two_level, npad=npad,
                         smooth_degree=args.smooth_degree, coarse_max=args.coarse_max,
                         device=device)
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


def _mesh(device, devices: Optional[int] = None):
    """The mesh of a distributed solve: torchrun's world, or this process as
    a world of one rank; on ``device`` (default: the card,
    ``cuda:<LOCAL_RANK>``, which raises when there is none). ``--devices K``
    is tpucg's ``make_mesh(K)`` (``cli.py:41``) for a world of P ranks: K > P
    raises tpucg's ``ValueError``, K == P is the world, and K < P is
    refused, since the port's mesh spans the whole world as its 2-D mesh
    does (launch K ranks instead)."""
    from tpucg_torch.comm.mesh import make_mesh

    mesh = make_mesh(device=device or "cuda")
    if devices is not None and devices > mesh.size:
        raise ValueError(f"requested {devices} devices, only {mesh.size} present")
    if devices is not None and devices < mesh.size:
        raise ValueError(f"requested {devices} devices of a world of {mesh.size} ranks: the "
                         f"port's mesh spans the whole world (launch {devices} ranks)")
    return mesh


def _check_finite(args, res) -> None:
    """``--debug-nans``: x and the residual norm checked once, after the
    solve, raising ``FloatingPointError`` (the class ``jax_debug_nans``
    raises) that names the non-finite quantity. JAX checks every operation;
    torch has no such mode, and a check each lap would read the host each
    lap. Every rank of a mesh holds the same x and norm, so every rank
    raises or none does."""
    import torch

    if not args.debug_nans:
        return
    bad = [name for name, t in (("x", res.x), ("the residual norm", res.residual_norm))
           if not bool(torch.isfinite(torch.as_tensor(t)).all())]
    if bad:
        raise FloatingPointError(f"--debug-nans: {' and '.join(bad)} not finite after the solve")


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
    from tpucg_torch.solver.checkpoint import (
        cg_solve_checkpointed,
        sharded_cg_solve_checkpointed,
        sharded_operator_cg_solve_checkpointed,
    )
    from tpucg_torch.solver.operators import DenseOperator, best_sparse_operator
    from tpucg_torch.solver.sharded import (
        distribute_system,
        sharded_cg_solve,
        sharded_operator_cg_solve,
    )

    mesh = None if args.strategy == "serial" else _mesh(args.device, args.devices)
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
        two_level, tag = _two_level(args, csr, op, mesh)
        fmt += tag
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
              precondition=args.precondition, poly_degree=args.poly_degree,
              record_residuals=args.checkpoint is None and _record(args))
    storage = torch.bfloat16 if args.storage == "bf16" else torch.float32
    # The sharded WELL decomposition packs each rank's rows against global
    # columns: it takes the source CSR (a serial pack cannot be re-sharded).
    well_mesh = mesh is not None and fmt.startswith("WellOperator")
    sh_target = csr if well_mesh else op
    if args.checkpoint is not None:
        if well_mesh and args.storage == "bf16":
            raise SystemExit("--storage bf16 does not compose with --checkpoint on sharded "
                             "irregular (WELL) systems yet")
        if mesh is None:
            res = cg_solve_checkpointed(op, b, x0, two_level=two_level, device=device,
                                        **_checkpoint_kw(args))
        elif csr is None:
            # A dense .mtx: every rank holds it, each places its own block.
            res = sharded_cg_solve_checkpointed(
                distribute_system(mat, b, x0, mesh, strategy=args.strategy),
                mesh=mesh, **_checkpoint_kw(args, mesh))
        else:
            res = sharded_operator_cg_solve_checkpointed(sh_target, b, x0, mesh=mesh,
                                                         two_level=two_level,
                                                         **_checkpoint_kw(args, mesh))
    elif args.method == "minres":
        if well_mesh and args.storage == "bf16":
            print("note: --storage bf16 is serial-only for MINRES on irregular (WELL) systems; "
                  "solving in f32")
        res = _minres(op if mesh is None else (mat if csr is None else sh_target), b, x0, args,
                      mesh)
    elif mesh is None:
        res = cg_solve(op, b, x0, fused=args.fused, two_level=two_level, **kw,
                       **_method_kw(args))
    elif csr is None:
        res = sharded_cg_solve(mat, b, x0, mesh=mesh, strategy=args.strategy,
                               storage_dtype=storage, **kw, **_method_kw(args))
    else:
        res = sharded_operator_cg_solve(sh_target, b, x0, mesh=mesh, storage_dtype=storage, **kw,
                                        two_level=two_level, **_method_kw(args))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    _check_finite(args, res)
    if mesh is not None and mesh.rank != 0:
        return 0 if bool(res.converged) else 3  # rank 0 reports and writes x
    print(f"system size          : {n} x {n}  [{fmt}]")
    print(f"device               : {device} [{op.backend}]{_ck_note(args)}" if mesh is None
          else f"strategy             : {args.strategy} [{mesh!r}]{_ck_note(args)}")
    print(f"data load (s)        : {load_s:.6f}  (parse, reordering)")
    print(f"operator build (s)   : {build_s:.6f}  (promotion, packing, placement"
          + (", two-level set-up)" if two_level is not None else ")"))
    print(f"CG solve (s)         : {solve_s:.6f}")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    return _report(args, res, perm, n, mesh)


def _ck_note(args) -> str:
    return ("" if args.checkpoint is None
            else f" checkpointed every {args.segment_iters} iters")


def _record(args) -> bool:
    """``--residual-history`` records with ``--method cg`` only; elsewhere it
    says so and records none, as tpucg's CLI does."""
    if args.residual_history and args.method != "cg":
        print("note: --residual-history requires --method cg; no history will be recorded")
        return False
    return args.residual_history


def _report(args, res, perm, n, mesh=None) -> int:
    """The iterations, residual, convergence and x of a solve, as tpucg's
    CLI prints them; x un-permuted to the file's numbering."""
    import numpy as np

    from tpucg_torch.io.textio import save_array

    print(f"iterations           : {int(res.iterations)}")
    print(f"final ||r||          : {float(res.residual_norm):.6e}")
    print(f"converged            : {bool(res.converged)}")
    if args.checkpoint is not None and not bool(res.converged) and _checkpoint_left(
            args, mesh):  # a stagnation stop is done: its file is removed
        print(f"checkpoint retained  : {args.checkpoint} (re-run to resume)")
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
    from tpucg_torch.config import CGConfig
    from tpucg_torch.solver.operators import DenseOperator
    from tpucg_torch.solver.sharded import load_system_sharded, sharded_cg_solve

    _check_solve_options(args)
    t_total0 = time.perf_counter()
    if args.matrix.endswith(".mtx"):
        if args.deflate:
            raise SystemExit("--deflate supports dense (text/.npy) matrices; sparse .mtx "
                             "operators are not deflatable from the CLI")
        return _cmd_solve_mtx(args, t_total0)
    if args.two_level is not None:
        raise SystemExit("--two-level applies to sparse .mtx systems (dense systems converge in "
                         "O(10) laps already)")
    if args.deflate:
        return _cmd_solve_deflated(args, t_total0)
    mesh = None if args.strategy == "serial" else _mesh(args.device, args.devices)
    device = canonical_device(args.device) if mesh is None else mesh.device
    storage = torch.bfloat16 if args.storage == "bf16" else torch.float32
    system = None
    if mesh is not None and (args.method != "minres" or args.checkpoint is not None):
        # Host-sharded loading: each rank parses only its own rows (the
        # reference's rank 0 reads everything, parallel_cg.c:100-108).
        if args.storage == "bf16":
            raise SystemExit("--storage bf16 with sharded dense strategies: cast at distribution "
                             "is not wired through host-sharded loading; use --strategy serial "
                             "or the library API (sharded_cg_solve(..., "
                             "storage_dtype=torch.bfloat16))")
        system = load_system_sharded(args.matrix, args.rhs, args.x0, mesh=mesh,
                                     kernel=args.kernel, strategy=args.strategy,
                                     config=CGConfig(precondition=args.precondition,
                                                     pc_block_size=args.pc_block_size))
        n = system.n
        if args.n is not None and n != args.n:
            raise ValueError(f"--n {args.n} does not match the {n} values in {args.rhs!r}")
    else:
        A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
        n = A.shape[0]
    load_s = time.perf_counter() - t_total0
    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel,
              precondition=args.precondition, poly_degree=args.poly_degree,
              record_residuals=args.checkpoint is None and _record(args))
    t0 = time.perf_counter()
    if mesh is None:
        op = DenseOperator.create(A, backend=args.kernel, device=device, dtype=storage)
        if args.checkpoint is not None:
            # tpucg's _cmd_solve_checkpointed (cli.py:641-703), serially.
            from tpucg_torch.solver.checkpoint import cg_solve_checkpointed

            res = cg_solve_checkpointed(op, b, x0, device=device, **_checkpoint_kw(args))
        elif args.method == "minres":
            res = _minres(op, b, x0, args)
        else:
            res = cg_solve(op, b, x0, fused=args.fused, **kw, **_method_kw(args))
        where = f"{device} [{op.backend}]{_ck_note(args)}"
    else:
        if system is None:  # --method minres: tpucg's CLI loads A whole there
            res = _minres(A, b, x0, args, mesh)
        elif args.checkpoint is not None:
            # tpucg's _cmd_solve_checkpointed on the mesh (cli.py:677-689).
            from tpucg_torch.solver.checkpoint import sharded_cg_solve_checkpointed

            res = sharded_cg_solve_checkpointed(system, mesh=mesh, n=n,
                                                **_checkpoint_kw(args, mesh))
        else:
            res = sharded_cg_solve(system, mesh=mesh, strategy=args.strategy, n=n, **kw,
                                   **_method_kw(args))
        where = f"{mesh!r}, strategy {args.strategy}{_ck_note(args)}"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    _check_finite(args, res)
    if mesh is not None and mesh.rank != 0:
        return 0 if bool(res.converged) else 3  # rank 0 reports and writes x
    print(f"system size          : {n} x {n}")
    print(f"device               : {where}")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes operator placement)")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    return _report(args, res, None, n, mesh)


def _load_deflation_v(path: str, n: int):
    """The deflation basis V (n, m) from .npy or .mtx (tpucg's
    ``_load_deflation_v``, ``cli.py:447``); a vector is one column."""
    import numpy as np

    if path.endswith(".npy"):
        V = np.load(path)
    elif path.endswith(".mtx"):
        from tpucg_torch.io.mmio import load_matrix_market

        V = load_matrix_market(path)
        if not isinstance(V, np.ndarray):
            V = V.to_dense()
    else:
        raise SystemExit("--deflate expects a .npy or .mtx file")
    V = np.asarray(V, np.float32)
    if V.ndim == 1:
        V = V[:, None]
    if V.shape[0] != n:
        raise SystemExit(f"--deflate basis has {V.shape[0]} rows, system has {n}")
    return V


def _cmd_solve_deflated(args, t_total0) -> int:
    """``solve --deflate V`` on a dense system (tpucg's
    ``_cmd_solve_deflated``, ``cli.py:472``): ``cg_solve_deflated``, or with
    ``--strategy`` ``sharded_cg_solve_deflated`` on the CLI's mesh. A, b
    and x0 are loaded whole (``load_system``), on every rank of a mesh too,
    as tpucg's CLI loads them: the deflated solve places each rank's rows
    itself. ``method`` is forwarded, so the solves' method guard fires."""
    import torch

    from tpucg_torch.io.textio import load_system
    from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
    from tpucg_torch.solver.deflation import cg_solve_deflated, sharded_cg_solve_deflated

    if args.checkpoint is not None:
        raise SystemExit("--deflate does not compose with --checkpoint")
    mesh = None if args.strategy == "serial" else _mesh(args.device, args.devices)
    device = canonical_device(args.device) if mesh is None else mesh.device
    A, b, x0 = load_system(args.matrix, args.rhs, args.x0, n=args.n)
    n = A.shape[0]
    V = _load_deflation_v(args.deflate, n)
    load_s = time.perf_counter() - t_total0
    kw = dict(tol=args.tol, maxiter=args.maxiter, kernel=args.kernel, method=args.method,
              precondition=args.precondition, poly_degree=args.poly_degree,
              pc_block_size=args.pc_block_size)
    record = args.residual_history and args.method == "cg" and mesh is None
    if args.residual_history and not record and (mesh is None or mesh.rank == 0):
        print("note: --residual-history requires --method cg --strategy serial with "
              "--deflate; no history will be recorded")
    t0 = time.perf_counter()
    if mesh is None:
        res = cg_solve_deflated(A, b, V, x0=x0, record_residuals=record, device=device, **kw)
    else:
        res = sharded_cg_solve_deflated(A, b, V, x0=x0, mesh=mesh, strategy=args.strategy,
                                        **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    _check_finite(args, res)
    if mesh is not None and mesh.rank != 0:
        return 0 if bool(res.converged) else 3  # rank 0 reports and writes x
    print(f"system size          : {n} x {n}  [deflated m={V.shape[1]}]")
    print(f"device               : {device} [{resolve_backend(args.kernel, device)}]"
          if mesh is None else f"strategy             : {args.strategy} [{mesh!r}]")
    print(f"data load (s)        : {load_s:.6f}")
    print(f"CG solve (s)         : {solve_s:.6f}  (includes operator placement)")
    print(f"total (s)            : {time.perf_counter() - t_total0:.6f}")
    return _report(args, res, None, n, mesh)


def cmd_generate(args) -> int:
    """A random SPD system in the reference's text format (tpucg's
    ``cmd_generate``, ``cli.py:714``): ``generateSPDmatrix.m``'s file names,
    A and b in %.4f, x0 in %.1f."""
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.textio import save_array

    n = args.n
    A, b, x0 = generate_spd_system(n, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    pa = os.path.join(args.out_dir, f"matrix{n}X{n}.txt")
    pb = os.path.join(args.out_dir, f"vector{n}X1.txt")
    px = os.path.join(args.out_dir, f"X{n}X1.txt")
    save_array(pa, A, fmt="%.4f")
    save_array(pb, b, fmt="%.4f")
    save_array(px, x0, fmt="%.1f")
    print(f"wrote {pa}, {pb}, {px}")
    return 0


def cmd_convert(args) -> int:
    """Format conversion (tpucg's ``cmd_convert``, ``cli.py:735``): .mtx ->
    .mtx expands symmetric storage, sorts the rows and writes the byte-offset
    sidecar that host-sharded loading reads (``expand_matrix_market``); a
    COO .mtx -> .npy or text is densified; text or .npy -> .mtx; text <->
    .npy with ``--kind``, ``--n`` and ``--fmt``."""
    import numpy as np

    from tpucg_torch.io.textio import load_matrix, load_vector, save_array

    src, dst = args.src, args.dst
    if src.endswith(".mtx") and dst.endswith(".mtx"):
        from tpucg_torch.io.mmio import expand_matrix_market

        idx = expand_matrix_market(src, dst)
        print(f"wrote {dst} + sidecar {idx} (host-sharded loading ready)")
        return 0
    if src.endswith(".mtx"):
        from tpucg_torch.io.mmio import load_matrix_market

        arr = load_matrix_market(src)
        if not isinstance(arr, np.ndarray):
            arr = arr.to_dense()  # text and .npy are dense formats
        if dst.endswith(".npy"):
            np.save(dst, arr)
        else:
            save_array(dst, arr, fmt=args.fmt)
    elif dst.endswith(".mtx"):
        from tpucg_torch.io.mmio import save_matrix_market

        if src.endswith(".npy"):
            arr = np.load(src)
        elif args.kind == "matrix":
            arr = load_matrix(src, n=args.n)
        else:
            arr = load_vector(src, n=args.n)
        save_matrix_market(dst, arr)
    elif dst.endswith(".npy"):
        arr = load_matrix(src, n=args.n) if args.kind == "matrix" else load_vector(src, n=args.n)
        np.save(dst, arr)
    elif src.endswith(".npy"):
        arr = np.load(src)
        save_array(dst, arr, fmt=args.fmt)
    else:
        raise SystemExit("one of src/dst must be a .npy or .mtx file")
    print(f"wrote {dst} ({arr.size} values, shape {arr.shape})")
    return 0


def cmd_selftest(args) -> int:
    import numpy as np
    import torch

    from tpucg_torch.io import _native
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
    from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
    from tpucg_torch.solver.cg import cg_solve, cg_solve_multi
    from tpucg_torch.solver.oracle import oracle_cg
    from tpucg_torch.solver.sharded import sharded_cg_solve

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
    # tpucg's mesh checks (cli.py:828-844) on the CLI's mesh: torchrun's
    # world, or this process as a world of one rank, on the device.
    mesh = _mesh(device)
    for strategy in ("allgather", "overlap"):
        rs = sharded_cg_solve(A, b, x0, mesh=mesh, strategy=strategy, kernel=args.kernel)
        check(f"sharded[{strategy}] n={n} ({mesh.size} ranks)",
              bool(rs.converged) and np.allclose(rs.x.cpu().numpy(), x_ref, atol=1e-4),
              f"{int(rs.iterations)} iters")
    # Pipelined CG's f32 residual floor lies a little above classic CG's:
    # its check runs at a tolerance scaled to ||b||, as tpucg's does.
    ptol = 1e-5 * float(np.linalg.norm(b))
    rp = cg_solve(A, b, x0, method="pipelined", tol=ptol, kernel=args.kernel, device=device)
    check("pipelined", bool(rp.converged) and np.allclose(rp.x.cpu().numpy(), x_ref, atol=1e-3),
          f"{int(rp.iterations)} iters")
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
    mesh = None if strategies == ("serial",) else _mesh("cuda", args.devices)
    with _rank0_prints(mesh):
        # tpucg's --compare-strategies (cli.py:1014-1021): the reference's
        # question, collective against point-to-point, beside serial; one
        # report each on stderr, the JSON line of the first arm. With --json
        # every arm's report also goes to stdout as a JSON line (tpucg's
        # BenchReport.to_json), before the metric line, which stays last.
        arms = [_bench_one(args, strategy, mesh) for strategy in strategies]
        if args.json:
            for _, report in arms:
                print(report.to_json())
        print(json.dumps(arms[0][0]))
    return 0


def _bench_solve_kw(args, n: int, tol: float) -> dict:
    """The solve keywords of every bench arm, dense serial and sharded and
    Poisson: at most 4 n laps, tpucg's cap (``cli.py:954``, ``:975``), so a
    ``--tol`` the system cannot reach times as many laps as tpucg's bench."""
    return dict(kernel=args.kernel, precondition=args.precondition,
                poly_degree=args.poly_degree, tol=tol, maxiter=4 * n, **_method_kw(args))


def _bench_one(args, strategy: str, mesh):
    """One bench arm: the report on stderr; returns the metric line and the
    report."""
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
    from tpucg_torch.config import CGConfig
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.solver.cg import cg_solve
    from tpucg_torch.solver.operators import DenseOperator
    from tpucg_torch.solver.sharded import distribute_system, sharded_cg_solve

    storage = torch.bfloat16 if args.storage == "bf16" else torch.float32
    t_total0 = time.perf_counter()
    if args.operator == "dense":
        n = args.n
        A, b, x0 = generate_spd_system(n, seed=0)
        kw, nnz = _bench_solve_kw(args, n, 1.0e-6 if args.tol is None else args.tol), None
        # Distribution phase: placing the padded operator, or this rank's
        # block of it, on the card (the reference's MPI_Scatter phase).
        t0 = time.perf_counter()
        if strategy != "serial":
            # Under block Jacobi each rank's rows are whole blocks (pc_align).
            system = distribute_system(A, b, x0, mesh, strategy=strategy, storage_dtype=storage,
                                       config=CGConfig(precondition=args.precondition,
                                                       pc_block_size=args.pc_block_size))
            torch.cuda.synchronize()
            distribute_s = time.perf_counter() - t0

            def solve():
                return sharded_cg_solve(system, mesh=mesh, strategy=strategy,
                                        storage_dtype=storage, **kw)
        else:
            op = DenseOperator.create(A, backend=args.kernel, device="cuda", dtype=storage)
            mv_bytes = gemv_bytes(op.padded_n, op.padded_n, op.A.element_size())
    else:
        t0 = time.perf_counter()  # the slab's generation and placement
        op, b, nnz, mv_bytes = _poisson_system(args.operator, args.m, storage, args.kernel,
                                               "cuda")
        n, x0 = op.n, None
        # Large-norm sparse systems: an absolute 1e-6 is below the f32
        # residual floor (tpucg's choice, cli.py:938-943).
        kw = _bench_solve_kw(args, n, 1.0e-5 * float(np.linalg.norm(b)) if args.tol is None
                             else args.tol)
    if strategy == "serial":
        bd = torch.as_tensor(b, device="cuda")
        x0d = None if x0 is None else torch.as_tensor(x0, device="cuda")
        torch.cuda.synchronize()
        distribute_s = time.perf_counter() - t0

        def solve():
            return cg_solve(op, bd, x0d, fused=args.fused, **kw)

    res = solve()
    _check_finite(args, res)
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
        strategy=strategy,
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
        }, report
    # The reference C code has no sparse solve: no vs_baseline.
    return {
        "metric": f"{args.operator.replace('-', '_')}_cg_solve_time_m{args.m}",
        "value": round(solve_t.median, 6),
        "unit": "s",
    }, report


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
    info = {
        "tpucg_torch_version": tpucg_torch.__version__,
        "torch_version": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device": torch.cuda.get_device_name() if cuda else "cpu",
        "kernel_backend": resolve_backend("auto", "cuda" if cuda else "cpu"),
        "kernel_library": {"built": lib.exists(), "path": str(lib)},
        "hbm_peak_bytes_per_s": peak,
        "native_parser": _native._load() is not None,
    }
    if args.spectrum:
        info["spectrum"] = _spectrum(args.spectrum, args.device)
    print(json.dumps(info, indent=2))
    return 0


def _spectrum(path: str, device) -> dict:
    """``info --spectrum MATRIX`` (tpucg's ``cli.py:1049-1073``): the SPD
    bounds of a matrix loaded by suffix (a sparse .mtx through COO -> CSR ->
    ``best_sparse_operator``; .npy, text and a dense .mtx as dense A) from
    ``spectral_interval`` on ``device``, whose power iterations run on the
    operator's kernel (K1, K6, K13 ... on the card). Feed lam_lo and lam_hi
    to ``solve --interval``."""
    import numpy as np

    from tpucg_torch.kernels.dispatch import canonical_device
    from tpucg_torch.solver.cg import spectral_interval

    device = canonical_device(device)
    if path.endswith(".mtx"):
        from tpucg_torch.io.mmio import load_matrix_market
        from tpucg_torch.solver.operators import best_sparse_operator

        A = load_matrix_market(path)
        if not isinstance(A, np.ndarray):
            A = best_sparse_operator(A.to_csr(), device=device)
    elif path.endswith(".npy"):
        A = np.load(path)
    else:
        from tpucg_torch.io.textio import load_matrix

        A = load_matrix(path)
    lam_lo, lam_hi, kappa = spectral_interval(A, device=device)
    return {"matrix": path, "lam_lo": lam_lo, "lam_hi": lam_hi, "kappa": kappa}


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
    ps.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="segmented solve with resumable .npz checkpoints at PATH (tpucg's "
                         "file format); with --strategy it runs on the mesh: one rank writes "
                         "PATH, more ranks PATH.proc<rank> each for a dense system and PATH "
                         "for a sparse one")
    ps.add_argument("--segment-iters", type=int, default=128, dest="segment_iters",
                    help="laps per checkpoint segment")
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
                         "block_jacobi; with --strategy on the mesh too)")
    ps.add_argument("--strategy", default="serial",
                    choices=("serial", "allgather", "overlap"),
                    help="distributed row-block solve over torch.distributed (under "
                         "torchrun, or one rank), with every --method and --precondition "
                         "of a serial cg solve: allgather or overlap for a dense A, the "
                         "halo or gather decomposition of a DIA, ELL or BSR .mtx, row "
                         "blocks of WELL for an irregular one")
    ps.add_argument("--two-level", type=int, default=None, metavar="AGG",
                    help="two-level preconditioning with AGG-row contiguous aggregates (.mtx "
                         "sparse systems, method cg or pipelined; with --strategy on the WELL "
                         "and DIA decompositions): the coarse-space "
                         "correction that cuts FEM-class lap counts where Jacobi cannot "
                         "(pairs with --rcm); stops on the true residual every 16 laps")
    ps.add_argument("--smooth-degree", type=int, default=1, dest="smooth_degree",
                    help="smoother degree for --two-level: 1 = damped Jacobi; l >= 2 = "
                         "l-step Chebyshev smoothing (l - 1 matvecs a half-cycle)")
    ps.add_argument("--coarse-max", type=int, default=None, dest="coarse_max", metavar="NC",
                    help="with --two-level: recurse to a multilevel hierarchy while a coarse "
                         "level exceeds NC rows (sparse coarse operators, recursive cycles)")
    ps.add_argument("--deflate", default=None, metavar="V",
                    help="deflation basis (.npy or .mtx, n x m columns): Galerkin start and "
                         "the A-orthogonal projection every lap (cg_solve_deflated; serial and "
                         "--strategy, dense text/.npy systems, method cg)")
    ps.set_defaults(fn=cmd_solve)

    pg = sub.add_parser("generate", help="write a random SPD system in the reference's text "
                                         "format (generateSPDmatrix.m's files)")
    pg.add_argument("n", type=int)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--out-dir", default=".")
    pg.set_defaults(fn=cmd_generate)

    pc = sub.add_parser("convert", help="convert between formats; .mtx -> .mtx expands, "
                                        "row-sorts and indexes for host-sharded loading; text "
                                        "<-> .npy (binary loads skip parsing)")
    pc.add_argument("src")
    pc.add_argument("dst")
    pc.add_argument("--kind", default="matrix", choices=("matrix", "vector"))
    pc.add_argument("--n", type=int, default=None)
    pc.add_argument("--fmt", default="%r", help="text format when converting to text")
    pc.set_defaults(fn=cmd_convert)

    pt = sub.add_parser("selftest", help="goldens + oracle + mesh checks")
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
                    help="the solve's method, serial or distributed (see solve --method)")
    pb.add_argument("--tol", type=float, default=None,
                    help="absolute residual tolerance (default: 1e-6 for the dense system, "
                         "1e-5 ||b|| for Poisson)")
    pb.add_argument("--json", action="store_true",
                    help="also print each arm's report to stdout as a JSON line, before the "
                         "metric line")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="device / backend / kernel library")
    pi.add_argument("--spectrum", default=None, metavar="MATRIX",
                    help="also estimate the SPD spectrum bounds of this matrix (text/.npy/.mtx): "
                         "prints lam_lo / lam_hi / kappa; pass lam_lo lam_hi to solve "
                         "--interval to skip the per-solve set-up")
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
    for sp in (ps, pt, pi):
        sp.add_argument("--device", default=None, help="torch device (default: the card)")
    for sp in (ps, pb):
        sp.add_argument("--devices", type=int, default=None,
                        help="ranks of a distributed solve: must be the world's size (torchrun's "
                             "--nproc-per-node, 1 without torchrun); a serial solve ignores it")
        sp.add_argument("--debug-nans", action="store_true", dest="debug_nans",
                        help="raise FloatingPointError when x or the residual norm is NaN or "
                             "Inf; checked once on the result, not on every operation as "
                             "tpucg's jax_debug_nans is")
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
