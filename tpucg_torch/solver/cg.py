"""The CG iteration on the device (the dense slice of ``tpucg.solver.cg``).

Contract (reference ``serialConjugate.c:180-259``, as in tpucg):

- float32 recurrence: r = p = b - A x0; rsold = r.r; then per lap
  alpha = rsold / (p.Ap); x += alpha p; r -= alpha Ap; beta = r.r;
  STOP if sqrt(beta) < tol (tested after the x/r update, BEFORE the p
  update, so on convergence p and rsold are left as they were);
  else p = r + (beta/rsold) p; rsold = beta. At most n laps.

tpucg runs the loop as one ``lax.while_loop`` on the device. Here the host
enqueues laps in chunks of 1, 2, 4, ... up to ``CHUNK_MAX`` and reads the 0-d
``active`` flag once per chunk, so a 4-lap solve costs 3 host reads. Every
loop scalar stays a 0-d device tensor. A lap enqueued after the solve has
stopped changes nothing (k, x, r, p, rsold, rslast, done): on the cuda
backend its kernels read ``active`` on the device and return at once, and on
the torch backend ``torch.where`` keeps the old values. Lap counts and
results therefore do not depend on the chunk size.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpucg_torch.config import CGConfig
from tpucg_torch.kernels.blas1 import (
    dot_cuda,
    dot_launch,
    dot_torch,
    fused_update_launch,
    fused_update_torch,
    scratch_for,
)
from tpucg_torch.kernels.dispatch import canonical_device, cuda_stream, resolve_backend
from tpucg_torch.kernels.matvec import check_matvec, gemv_launch, matvec_cuda
from tpucg_torch.solver.operators import LinearOperator, as_operator

CHUNK_MAX = 64  # laps per host read, once the chunks have grown


class CGResult(NamedTuple):
    """Solve outcome; ``iterations`` counts laps (2 for the 2x2 golden
    system, 4 for the 4x4). Fields are tensors on the solve's device."""

    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
    # ||r|| after each lap (entry 0 = initial residual), NaN past the last
    # lap; only filled by record_residuals=True solves.
    residual_history: Optional[torch.Tensor] = None


class _State(NamedTuple):
    """The loop state, with tpucg's ``_State`` field names."""

    k: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rsold: torch.Tensor
    rslast: torch.Tensor  # most recent r.r
    done: torch.Tensor
    hist: Optional[torch.Tensor] = None


def init_state(matvec: Callable, dot: Callable, b: torch.Tensor, x0: torch.Tensor,
               tol: float, precond: Optional[Callable] = None,
               hist_len: Optional[int] = None) -> _State:
    """r = p = b - A x0; rsold = r.r. With ``precond`` (z = M^-1 r) this is
    PCG: p = z0 and ``rsold`` carries r.z, while ``rslast`` carries r.r (the
    stopping test is always on the true residual)."""
    r0 = b - matvec(x0, None)
    tol2 = torch.tensor(tol, dtype=r0.dtype, device=r0.device) ** 2
    rr0 = dot(r0, r0, None)
    if precond is None:
        p0, rs0 = r0, rr0
    else:
        p0 = precond(r0)
        rs0 = dot(r0, p0, None)
    hist = None
    if hist_len is not None:
        hist = torch.full((hist_len + 1,), float("nan"), dtype=r0.dtype, device=r0.device)
        hist[0] = rr0.sqrt()
    return _State(
        k=torch.zeros((), dtype=torch.int32, device=r0.device),
        x=x0, r=r0, p=p0, rsold=rs0, rslast=rr0,
        done=rr0 < tol2,  # exact x0: converged at k=0 (the reference would NaN)
        hist=hist,
    )


def lap_ops(op: LinearOperator, backend: str):
    """The (matvec, dot, update) closures that ``cg_loop`` runs for ``op`` on
    ``backend``. Each takes the lap's ``active`` flag last: a 0-d int32
    tensor, or None (always run) in ``init_state``. The operator's own
    backend must be ``backend``: one choice runs the whole lap, and a
    mismatch raises instead of mixing plain and hand-written kernels.

    On ``"cuda"`` the kernels read the flag on the device and return at once
    when it is 0, leaving their outputs undefined (every consumer in
    ``cg_loop`` is masked by the flag), and the update writes x and r in
    place, so a frozen lap costs launches and nothing else. On ``"torch"``
    the plain versions run and the update keeps x and r with ``torch.where``.
    """
    own = getattr(op, "backend", None)
    if own != backend:
        raise ValueError(
            f"the operator runs kernel backend {own!r} and the solve asked for "
            f"{backend!r}: make the operator with the solve's kernel"
        )
    if backend == "cuda":
        return _cuda_lap_ops(op.A)

    def dot(u, v, act):
        return dot_torch(u, v)

    def update(x, r, p, ap, alpha, act):
        xn, rn, rr = fused_update_torch(x, r, p, ap, alpha)
        keep = act.bool()
        return torch.where(keep, xn, x), torch.where(keep, rn, r), rr
    return op.matvec, dot, update


def _cuda_lap_ops(A: torch.Tensor):
    """K1/K2/K3 for ``cg_loop`` with the per-call host work moved out of the
    lap: A is checked, the stream taken and every buffer allocated once,
    here, and the laps call the launch cores. A lap's outputs (Ap, the dots,
    beta) live in these buffers and the next lap overwrites them; every
    consumer in ``cg_loop`` reads them in the same lap, in stream order.
    Calls without a flag (``init_state``) go through the checked wrappers
    and get fresh outputs, which the state keeps. ``cg_loop`` checks its
    vectors once; K1 checks x's length every lap, so no launch reads past A.
    """
    check_matvec(A)
    rows, cols = A.shape
    if rows != cols:
        raise ValueError(f"the CG lap needs a square A, got {tuple(A.shape)}")
    dev, stream = A.device, cuda_stream(A)
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    d = torch.empty((), dtype=torch.float32, device=dev)
    beta = torch.empty((), dtype=torch.float32, device=dev)
    scratch = scratch_for(y)  # K2 and K3 run one after the other on `stream`

    def matvec(x, act):
        if act is None:
            return matvec_cuda(A, x)
        if x.shape[0] != cols or x.device != dev:
            raise ValueError(
                f"x {tuple(x.shape)} on {x.device} for A {tuple(A.shape)} on {dev}"
            )
        gemv_launch(A, x, y, act.data_ptr(), stream)
        return y

    def dot(u, v, act):
        if act is None:
            return dot_cuda(u, v)
        dot_launch(u, v, scratch, d, act.data_ptr(), stream)
        return d

    def update(x, r, p, ap, alpha, act):
        fused_update_launch(x, r, p, ap, alpha, x, r, scratch, beta, act.data_ptr(), stream)
        return x, r, beta
    return matvec, dot, update


def _check_state(x, r, p, rsold, rslast) -> None:
    """The loop's vectors: f32 of one length, its scalars 0-d f32, all on
    one device (checked once per loop, before any lap)."""
    vecs, scalars = (x, r, p), (rsold, rslast)
    if (
        any(v.dtype != torch.float32 for v in vecs + scalars)
        or x.dim() != 1 or not (x.shape == r.shape == p.shape)
        or any(s.dim() != 0 for s in scalars)
        or any(v.device != x.device for v in vecs + scalars)
    ):
        raise ValueError(
            "CG state needs f32 x, r, p of one length and 0-d f32 rsold, rslast "
            "on one device, got " + ", ".join(
                f"{v.dtype} {tuple(v.shape)} on {v.device}" for v in vecs + scalars)
        )


def cg_loop(
    matvec: Callable,
    dot: Callable,
    update: Callable,
    b: Optional[torch.Tensor],
    x0: Optional[torch.Tensor],
    *,
    tol: float,
    maxiter: int,
    safe_alpha: bool = True,
    state: Optional[_State] = None,
    precond: Optional[Callable] = None,
    hist_len: Optional[int] = None,
    chunk: Optional[int] = None,
    replace_every: Optional[int] = None,
    check_true_every: Optional[int] = None,
) -> _State:
    """Run CG laps until ``sqrt(r.r) < tol`` or k == ``maxiter``.

    ``matvec``/``dot``/``update`` come from ``lap_ops``. ``state`` resumes a
    previous run (``maxiter`` bounds the cumulative k); its tensors are not
    modified. ``precond`` (z = M^-1 r) switches to preconditioned CG with the
    same stopping test on the true residual. ``chunk`` fixes the laps per
    host read (default: 1, 2, 4, ... up to ``CHUNK_MAX``).
    """
    if replace_every or check_true_every:
        raise NotImplementedError(
            "replace_every/check_true_every serve two-level and deflated "
            "solves: ROADMAP M12"
        )
    if chunk is not None and chunk < 1:
        raise ValueError("chunk must be >= 1")
    if state is None:
        state = init_state(matvec, dot, b, x0, tol, precond=precond, hist_len=hist_len)
    k, _, _, p, rsold, rslast, done, hist = state
    # The cuda update writes x and r in place: the loop owns its copies.
    x = state.x.clone(memory_format=torch.contiguous_format)
    r = state.r.clone(memory_format=torch.contiguous_format)
    p = p.contiguous()
    _check_state(x, r, p, rsold, rslast)
    tol2 = torch.tensor(tol, dtype=r.dtype, device=r.device) ** 2
    pos = None if hist is None else torch.arange(hist.numel(), device=r.device)
    active = ~done & (k < maxiter)
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(laps):
            act = active.to(torch.int32)
            ap = matvec(p, act)
            pap = dot(p, ap, act)
            alpha = torch.where(pap != 0, rsold / pap, 0.0) if safe_alpha else rsold / pap
            x, r, rr = update(x, r, p, ap, alpha, act)
            stop = rr < tol2
            if precond is None:
                z, rs_new = r, rr
            else:
                z = precond(r)
                rs_new = dot(r, z, act)
            step = active & ~stop
            p = torch.where(step, z + (rs_new / rsold) * p, p)
            rsold = torch.where(step, rs_new, rsold)
            rslast = torch.where(active, rr, rslast)
            if hist is not None:
                hist = torch.where(active & (pos == k + 1), rr.sqrt(), hist)
            done = done | (active & stop)
            k = k + act
            active = ~done & (k < maxiter)
        if not bool(active):  # the one host read of the chunk
            break
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)
    return _State(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rslast, done=done, hist=hist)


def _check_supported(config: CGConfig, interval, two_level) -> None:
    """Name the ROADMAP item of every configuration this slice does not run."""
    if config.method != "cg":
        raise NotImplementedError(f"method={config.method!r} is ROADMAP M8")
    if config.precondition not in ("none", "jacobi"):
        raise NotImplementedError(f"precondition={config.precondition!r} is ROADMAP M8")
    if config.dtype != torch.float32:
        raise NotImplementedError(f"solve dtype {config.dtype} is ROADMAP M9")
    if config.fused == "always":
        raise NotImplementedError(
            "fused='always' needs the whole-solve kernel K4 (ROADMAP M6)"
        )
    if interval is not None:
        raise NotImplementedError("interval= serves method='ca'/'chebyshev': ROADMAP M8")
    if two_level is not None:
        raise NotImplementedError("two_level= is ROADMAP M12")


def cg_solve(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    record_residuals: bool = False,
    interval=None,
    two_level=None,
    *,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve the SPD system A x = b (tpucg's ``cg_solve`` with the
    classic-CG branch of its ``_cg_jit``).

    ``A`` is a dense array or tensor, or a ``DenseOperator``. ``device``
    defaults to the device of a tensor or operator ``A``, else the card when
    there is one; ``kernel="auto"`` then runs the CUDA kernels on a CUDA
    device and the plain versions elsewhere. ``fused="auto"`` takes the lap
    path (the whole-solve kernel K4 is not ported yet). ``record_residuals``
    returns the per-lap ||r|| in ``residual_history``; ``chunk`` is
    ``cg_loop``'s.
    """
    if config is None:
        config = CGConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    _check_supported(config, interval, two_level)
    if device is None and isinstance(A, (LinearOperator, torch.Tensor)):
        device = A.device
    device = canonical_device(device)
    backend = resolve_backend(config.kernel, device)
    op = as_operator(A, backend=backend, device=device)
    if op.device != device:
        raise ValueError(f"operator lives on {op.device}, solve asked for {device}")
    n, npad = op.n, op.padded_n
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
    x0 = (
        torch.zeros(n, dtype=torch.float32, device=device)
        if x0 is None
        else torch.as_tensor(x0, dtype=torch.float32, device=device)
    )
    if x0.shape != (n,):
        raise ValueError(f"x0 must have shape ({n},), got {tuple(x0.shape)}")
    if npad != n:
        # Identity-tail padding: pad coordinates start at the exact solution 0.
        b = F.pad(b, (0, npad - n))
        x0 = F.pad(x0, (0, npad - n))
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    minv = None
    if config.precondition == "jacobi":
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0)
    tol = float(config.tol)
    s = cg_loop(
        *lap_ops(op, backend), b, x0,
        tol=tol, maxiter=maxiter, safe_alpha=bool(config.safe_alpha),
        precond=None if minv is None else (lambda r: minv * r),
        hist_len=maxiter if record_residuals else None,
        chunk=chunk,
    )
    return CGResult(
        x=s.x[:n],
        iterations=s.k,
        residual_norm=s.rslast.sqrt(),
        converged=s.rslast < torch.tensor(tol, dtype=s.rslast.dtype, device=device) ** 2,
        residual_history=s.hist,
    )
