"""Mixed-precision iterative refinement: bf16-rate inner solves, an f32
result (tpucg's ``solver/ir.py``).

A ``DenseOperator`` stored in bf16 halves the GEMV's bytes but solves the
bf16-rounded system. Refinement removes that (Wilkinson):

    repeat:  r = b - A_f32 x        # the true residual, f32
             solve A_bf16 d ~= r    # inner CG on the cheap operator
             x <- x + d

Each round's inner solve is the port's ``cg_loop`` on the bf16 operator's
lap (K1 with bf16 A, K3, and K2 with the lap's tail on the card), from 0 on
the normalised residual to a relative tolerance; each round ends with one
f32 true residual (K1 with f32 A). The host reads one flag a round, beside
the inner loop's reads once a chunk. Both copies of A stay on the device
(1.5x the f32 bytes).

``sharded_cg_solve_ir`` refines over the mesh's ranks: a bf16 and an f32
copy of each rank's row block, the inner laps on the bf16 block's sharded
matvec (K1's bf16 form) with rank-summed dots, the true residual on the f32
block's (K1's f32 form).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpucg_torch.comm.mesh import make_mesh
from tpucg_torch.config import CGConfig
from tpucg_torch.io.partitioner import RowPartition
from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
from tpucg_torch.solver.cg import CGResult, TorchLap, _configure, cg_loop, lap_ops
from tpucg_torch.solver.operators import DenseOperator
from tpucg_torch.solver.sharded import (
    ROW_ALIGN,
    _check_supported,
    _dense_matvec,
    _gather_rows,
    _host,
    _reductions,
    check_1d,
    distribute_system,
)


class _IRState(NamedTuple):
    """The refinement's state, with tpucg's field names."""

    j: int                    # rounds completed
    x: torch.Tensor
    r: torch.Tensor           # the true residual b - A_f32 x
    rr: torch.Tensor
    inner_total: torch.Tensor  # inner laps over every round
    done: torch.Tensor
    stalled: torch.Tensor     # a round contracted r.r less than 4x: the f32 floor


def ir_loop(mv32: Callable, dot: Callable, inner: Callable, b: torch.Tensor,
            x0: torch.Tensor, *, tol: float, max_refine: int) -> _IRState:
    """Refine until the true r.r < tol^2, a round stalls, or ``max_refine``
    rounds (tpucg's ``ir_loop``). ``mv32(x)`` is the f32 product, ``dot``
    the lap's dot, ``inner(rhs)`` the inner solve of A_bf16 d = rhs from 0
    (a ``cg_loop`` state). A round keeps its iterate only where it lowered
    r.r; it stops the loop when r.r fell by less than 4x."""
    tol2 = torch.tensor(tol, dtype=torch.float32, device=b.device) ** 2

    def true_rr(x):
        r = b - mv32(x)
        return r, dot(r, r, None)

    r, rr = true_rr(x0)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    s = _IRState(j=0, x=x0, r=r, rr=rr,
                 inner_total=torch.zeros((), dtype=torch.int32, device=b.device),
                 done=rr < tol2, stalled=false)
    while s.j < max_refine and not bool(s.done | s.stalled):  # one host read a round
        nrm = s.rr.sqrt() + 1e-30
        # The rhs is normalised, so the inner tolerance is relative.
        st = inner(s.r / nrm)
        x_new = s.x + nrm * st.x
        r_new, rr_new = true_rr(x_new)  # the round's one f32 matvec
        better = rr_new < s.rr
        s = _IRState(
            j=s.j + 1,
            x=torch.where(better, x_new, s.x),
            r=torch.where(better, r_new, s.r),
            rr=torch.where(better, rr_new, s.rr),
            inner_total=s.inner_total + st.k,
            done=torch.minimum(rr_new, s.rr) < tol2,
            stalled=rr_new > 0.25 * s.rr,
        )
    return s


def cg_solve_ir(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    *,
    inner_rtol: float = 3.0e-2,
    inner_maxiter: Optional[int] = None,
    max_refine: int = 6,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve the dense A x = b to the f32 contract with bf16-rate inner
    solves (tpucg's ``cg_solve_ir``). ``A`` is a dense array or tensor: a
    bf16 and an f32 ``DenseOperator`` are made from it. Each round's inner
    CG runs to ``inner_rtol`` of the round's residual, capped at
    ``inner_maxiter`` laps (default ``config.maxiter``, else n); at most
    ``max_refine`` rounds. ``iterations`` counts the inner laps of every
    round; ``residual_norm`` and ``converged`` are the true f32 residual's,
    ``cg_solve``'s contract. ``device`` and ``chunk`` as in ``cg_solve``
    (``chunk`` is the inner loop's)."""
    config = _configure(config, overrides)
    if config.method != "cg" or config.precondition != "none":
        raise ValueError("cg_solve_ir supports method='cg', precondition='none'")
    if config.dtype != torch.float32:
        raise ValueError("cg_solve_ir is the f32-contract mixed-precision path; for f64 use "
                         "cg_solve(dtype=torch.float64)")
    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    device = canonical_device(device)
    backend = resolve_backend(config.kernel, device)
    op16 = DenseOperator.create(A, backend=backend, dtype=torch.bfloat16, device=device)
    op32 = DenseOperator.create(A, backend=backend, dtype=torch.float32, device=device)
    n, npad = op32.n, op32.padded_n
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
    x0 = (torch.zeros(n, dtype=torch.float32, device=device) if x0 is None
          else torch.as_tensor(x0, dtype=torch.float32, device=device))
    if x0.shape != (n,):
        raise ValueError(f"x0 must have shape ({n},), got {tuple(x0.shape)}")
    b, x0 = F.pad(b, (0, npad - n)), F.pad(x0, (0, npad - n))
    # config.maxiter caps each inner solve (tpucg's rule); inner_maxiter
    # overrides it.
    inner_cap = int(inner_maxiter if inner_maxiter is not None
                    else config.maxiter if config.maxiter is not None else n)
    mv16, dot, lap16 = lap_ops(op16, backend)

    def inner(rhs):
        return cg_loop(mv16, dot, lap16, rhs, torch.zeros_like(rhs), tol=float(inner_rtol),
                       maxiter=inner_cap, chunk=chunk)
    s = ir_loop(op32.matvec, dot, inner, b, x0, tol=float(config.tol),
                max_refine=int(max_refine))
    return CGResult(x=s.x[:n], iterations=s.inner_total, residual_norm=s.rr.sqrt(),
                    converged=s.done)


def sharded_cg_solve_ir(
    A,
    b,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    inner_rtol: float = 3.0e-2,
    inner_maxiter: Optional[int] = None,
    max_refine: int = 6,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Mixed-precision refinement with A's rows in blocks over the mesh's
    ranks (tpucg's ``sharded_cg_solve_ir``, ``ir.py:228``): a bf16 and an
    f32 copy of each rank's block (``distribute_system``, rows in multiples
    of ``ROW_ALIGN``, ``strategy`` allgather or overlap), the inner laps of
    ``ir_loop`` on the bf16 block's sharded matvec with rank-summed dots,
    the true residual on the f32 block's. ``cg_solve_ir``'s contract and
    options; method cg and precondition none only, as tpucg's. x whole on
    every rank."""
    config = _configure(config, overrides)
    if config.method != "cg" or config.precondition != "none":
        raise ValueError("sharded_cg_solve_ir supports method='cg', precondition='none'")
    mesh = make_mesh() if mesh is None else mesh
    check_1d(mesh, "sharded_cg_solve_ir runs on 1-D meshes")
    _check_supported(config)
    backend = resolve_backend(config.kernel, mesh.device)
    A = _host(A)
    n = A.shape[0]
    part = RowPartition(n=n, num_shards=mesh.size, align=ROW_ALIGN)
    sys16, sys32 = (distribute_system(A, b, x0, mesh, part, strategy=config.strategy,
                                      storage_dtype=dt)
                    for dt in (torch.bfloat16, torch.float32))
    mv16 = _dense_matvec(sys16.A, config.strategy, mesh, backend)
    mv32 = _dense_matvec(sys32.A, config.strategy, mesh, backend)
    del sys16
    red = _reductions(mesh, backend, sys32.b)
    lap = TorchLap(red.dot, red.update)
    # config.maxiter caps each inner solve (tpucg's rule); inner_maxiter
    # overrides it.
    inner_cap = int(inner_maxiter if inner_maxiter is not None
                    else config.maxiter if config.maxiter is not None else n)

    def inner(rhs):
        return cg_loop(mv16, red.dot, lap, rhs, torch.zeros_like(rhs), tol=float(inner_rtol),
                       maxiter=inner_cap, chunk=chunk)
    s = ir_loop(lambda x: mv32(x, None), red.dot, inner, sys32.b, sys32.x0,
                tol=float(config.tol), max_refine=int(max_refine))
    return CGResult(x=_gather_rows(mesh, s.x)[:n], iterations=s.inner_total,
                    residual_norm=s.rr.sqrt(), converged=s.done)
