"""MINRES for symmetric indefinite systems (the counterpart of
``tpucg.solver.minres``), serial.

CG needs SPD A; MINRES (Paige and Saunders 1975) minimizes ||b - A x|| over
the same Krylov space with a Lanczos three-term recurrence and Givens
rotations, and needs only symmetry. A lap is one matvec, an optional
preconditioner apply (SPD M: ``jacobi`` 1/|diag A|, ``block_jacobi`` the
SPD-ized inverse |B|^-1 of each diagonal block), two dots and vector
updates in torch ops, one masked step of ``run_chunks``.

The stop: the recurrence's phibar (||r|| in exact arithmetic) only
triggers it. A lap whose phibar < tol confirms against the true residual
||b - A x||; tpucg runs that confirmation under ``lax.cond``, the port as one
more flagged pair, the operator's matvec kernel and K3 in sum mode, under a
device flag that is set where the lap ran AND phibar < tol, so an
untriggered lap's pair returns at once on the card; ``done`` is taken from
the confirmation only where that flag is set. ``converged`` is recomputed
from the true residual at the end.

tpucg's ``kernel="auto"`` sends Jacobi-preconditioned dense MINRES to its
XLA GEMV (``tpucg/solver/minres.py:526-535``, a TPU fusion cliff); the port
keeps K1 there (ROADMAP's intended differences).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpucg_torch.config import CGConfig
from tpucg_torch.solver.cg import (
    CGResult,
    _configure,
    _solve_operator,
    lap_ops,
    make_block_precond,
    run_chunks,
)


class _MinresState(NamedTuple):
    """``minres_loop``'s state, with tpucg's field names."""

    k: torch.Tensor
    x: torch.Tensor
    r1: torch.Tensor      # Lanczos history vector (unpreconditioned)
    r2: torch.Tensor
    y: torch.Tensor       # M^-1 r2 (r2 unpreconditioned)
    oldb: torch.Tensor    # beta_{j-1}
    beta: torch.Tensor    # beta_j
    dbar: torch.Tensor
    epsln: torch.Tensor
    phibar: torch.Tensor  # residual-norm estimate (M^-1 norm if preconditioned)
    cs: torch.Tensor
    sn: torch.Tensor
    w: torch.Tensor       # solution-update direction history
    w2: torch.Tensor
    done: torch.Tensor


def minres_loop(matvec: Callable, dot: Callable, b: torch.Tensor, x0: torch.Tensor, *,
                tol: float, maxiter: int, psolve: Optional[Callable] = None,
                chunk: Optional[int] = None) -> _MinresState:
    """tpucg's (optionally preconditioned) MINRES loop on ``lap_ops``'s
    ``matvec(v, act)`` and ``dot(u, v, act)``; ``psolve(r, act)`` applies an
    SPD M^-1. Each lap is a masked step (fields kept where the loop had
    stopped); its matvec and dots run under the lap's flag, the
    confirmation's under its own."""
    dt, dev = b.dtype, b.device
    tolv = torch.tensor(tol, dtype=dt, device=dev)
    tol2 = tolv * tolv
    r1 = b - matvec(x0, None)
    y = r1 if psolve is None else psolve(r1, None)
    # dot(r1, y) = ||r1||^2_{M^-1} >= 0 for SPD M (the clamp guards f32 noise).
    beta1 = torch.sqrt(torch.clamp(dot(r1, y, None), min=0.0))
    zero = torch.zeros_like(b)
    nil = torch.zeros((), dtype=dt, device=dev)
    st = _MinresState(
        k=torch.zeros((), dtype=torch.int32, device=dev), x=x0, r1=r1, r2=r1, y=y,
        oldb=nil, beta=beta1, dbar=nil, epsln=nil, phibar=beta1,
        cs=-torch.ones((), dtype=dt, device=dev), sn=nil, w=zero, w2=zero,
        done=beta1 < tolv,
    )

    def step():
        nonlocal st
        s = st
        ran = (s.k < maxiter) & ~s.done
        act = ran.to(torch.int32)
        safe_beta = torch.where(s.beta > 0, s.beta, 1.0)
        v = s.y / safe_beta
        av = matvec(v, act)
        # Lanczos on the preconditioned operator, carried on r1, r2.
        safe_oldb = torch.where(s.oldb > 0, s.oldb, 1.0)
        av = av - torch.where(s.k > 0, s.beta / safe_oldb, 0.0) * s.r1
        alfa = dot(v, av, act)
        av = av - (alfa / safe_beta) * s.r2
        # The previous rotation's terms in alfa, before the next dot (on the
        # card the flagged dots share one output).
        delta = s.cs * s.dbar + s.sn * alfa
        gbar = s.sn * s.dbar - s.cs * alfa
        r2n = av
        yn = r2n if psolve is None else psolve(r2n, act)
        beta = torch.sqrt(torch.clamp(dot(r2n, yn, act), min=0.0))
        epsln = s.sn * beta
        dbar = -s.cs * beta
        gamma = torch.sqrt(gbar * gbar + beta * beta)
        gamma = torch.where(gamma > 0, gamma, 1.0)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * s.phibar
        phibar = sn * s.phibar
        w_new = (v - s.epsln * s.w2 - delta * s.w) / gamma
        x = s.x + phi * w_new
        # phibar < tol triggers the stop; the true residual confirms it.
        trig = ran & (phibar < tolv)
        tflag = trig.to(torch.int32)
        r = b - matvec(x, tflag)
        done = trig & (dot(r, r, tflag) < tol2)

        def keep(new, old):
            return torch.where(ran, new, old)
        st = _MinresState(
            k=keep(s.k + 1, s.k), x=keep(x, s.x), r1=keep(s.r2, s.r1), r2=keep(r2n, s.r2),
            y=keep(yn, s.y), oldb=keep(s.beta, s.oldb), beta=keep(beta, s.beta),
            dbar=keep(dbar, s.dbar), epsln=keep(epsln, s.epsln), phibar=keep(phibar, s.phibar),
            cs=keep(cs, s.cs), sn=keep(sn, s.sn), w=keep(w_new, s.w), w2=keep(s.w, s.w2),
            done=keep(done, s.done),
        )
    run_chunks(step, lambda: bool((st.k < maxiter) & ~st.done), chunk)
    return st


def abs_inv_blocks(blocks: torch.Tensor, ridge: float = 1e-6) -> torch.Tensor:
    """The SPD-ized inverse |B|^-1 = Q |lambda|^-1 Q^T of a (nb, bs, bs)
    batch of symmetric blocks (tpucg's), by a batched ``torch.linalg.eigh``
    in the blocks' dtype (f32, as tpucg's), eigenvalue magnitudes floored at
    ``ridge`` times each block's largest and at 1e-30. It sets the
    preconditioner's quality, not the solve's contract."""
    sym = 0.5 * (blocks + blocks.transpose(1, 2))
    lam, q = torch.linalg.eigh(sym)
    a = lam.abs()
    floor = ridge * a.max(dim=1, keepdim=True).values
    a = torch.maximum(a, torch.clamp(floor, min=1e-30))
    minv = (q * (1.0 / a)[:, None, :]) @ q.transpose(1, 2)
    return 0.5 * (minv + minv.transpose(1, 2))


def _make_minres_psolve(minv: Optional[torch.Tensor], npad: int) -> Optional[Callable]:
    """``psolve(r, act)`` from a 1-D (point) or 3-D (block) ``minv``; None
    passes through."""
    if minv is None:
        return None
    if minv.dim() == 3:
        return make_block_precond(minv, npad)
    return lambda r, act=None: minv * r


def minres_solve(A, b, x0=None, config: Optional[CGConfig] = None, *, device=None,
                 chunk: Optional[int] = None, **overrides) -> CGResult:
    """Solve the symmetric (possibly indefinite) A x = b by MINRES (tpucg's
    ``minres_solve``): ``cg_solve``'s calling convention and true-residual
    contract (||b - A x|| < tol, confirmed in the loop, at most ``maxiter``
    laps, float32). ``precondition`` "none", "jacobi" (M = |diag A|) or
    "block_jacobi" (M = blockdiag |B_i|, ``pc_block_size`` rows a block,
    ``abs_inv_blocks``). Any operator; the laps run on its matvec kernel
    and K3 (``device`` and ``kernel`` as in ``cg_solve``)."""
    config = _configure(config, overrides)
    if config.method != "cg":
        raise ValueError("minres_solve has no method variants")
    if config.precondition not in ("none", "jacobi", "block_jacobi"):
        raise ValueError("minres_solve supports precondition in {'none', 'jacobi', "
                         "'block_jacobi'} (MINRES needs an SPD M; poly preconditioners of "
                         "indefinite operators are not SPD)")
    if config.dtype != torch.float32:
        raise ValueError("minres_solve is float32-only")
    op, backend, device = _solve_operator(A, config.kernel, device)
    n, npad = op.n, op.padded_n
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
    x0 = (torch.zeros(n, dtype=torch.float32, device=device) if x0 is None
          else torch.as_tensor(x0, dtype=torch.float32, device=device))
    if npad != n:
        b, x0 = F.pad(b, (0, npad - n)), F.pad(x0, (0, npad - n))
    minv = None
    if config.precondition == "jacobi":
        d = op.diagonal().abs()
        minv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), 1.0).to(torch.float32)
    elif config.precondition == "block_jacobi":
        minv = abs_inv_blocks(op.diagonal_blocks(int(config.pc_block_size)))
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    tol = float(config.tol)
    matvec, dot, _ = lap_ops(op, backend)
    s = minres_loop(matvec, dot, b, x0, tol=tol, maxiter=maxiter,
                    psolve=_make_minres_psolve(minv, npad), chunk=chunk)
    # Honest reporting: the true residual once more.
    r = b - matvec(s.x, None)
    rr = dot(r, r, None)
    return CGResult(x=s.x[:n], iterations=s.k, residual_norm=rr.sqrt(),
                    converged=rr < torch.tensor(tol, device=device) ** 2)
