"""The CG iteration on the device (the dense and structured-sparse slices of
``tpucg.solver.cg``).

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
backend its kernels read ``active`` on the device and return at once (p's
update reads the ``step`` the last running lap's tail set and cleared),
and on the torch backend ``torch.where`` keeps the old values. Lap counts
and results therefore do not depend on the chunk size.

The lap's matvec is the operator's kernel: K1 for a ``DenseOperator``, K6
for a ``DiaOperator``, K8 for a ``PoissonOperator``, K13 for a
``WellOperator`` (and a plain torch product for ``BsrOperator`` and
``EllOperator``, as in tpucg); K3, K2 and p's update do the rest, with the
lap's scalar work (alpha, the stop test, beta, rsold, rslast, the history,
done, k, active) in K3's and K2's last blocks: four launches a lap without
a preconditioner, and no torch op.
A plain f32 solve that ``_fused_eligible`` admits on the cuda backend skips
the lap loop: a whole-solve kernel runs it in one launch, K4 (dense), K10
(Poisson stencil) or K11 (DIA). ``cg_solve_batch`` solves B independent
systems, through the batched kernel K5 where it applies and
``batch_cg_loop`` elsewhere; ``cg_solve_batch_banded`` B banded systems
that share their offsets, through K12 or ``batch_cg_loop``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpucg_torch.config import CGConfig
from tpucg_torch.io.partitioner import round_up
from tpucg_torch.kernels.blas1 import (
    CudaLapTail,
    LapTail,
    alpha_torch,
    dot_alpha_launch,
    dot_cuda,
    dot_launch,
    dot_tail_launch,
    dot_torch,
    fused_update_launch,
    fused_update_tail_launch,
    fused_update_torch,
    lap_tail_torch,
    p_update_launch,
    p_update_torch,
    scratch_for,
)
from tpucg_torch.kernels.dispatch import canonical_device, cuda_stream, resolve_backend
from tpucg_torch.kernels.fused import (
    FUSED_AUTO_MAX_N,
    FUSED_BATCH_MAX_N,
    FUSED_DIA_AUTO_MAX_N,
    FUSED_MAX_N,
    FUSED_STENCIL_AUTO_MAX_M,
    dia_minv,
    fused_batch_cg_solve_cuda,
    fused_batch_dia_cg_solve_cuda,
    fused_batch_dia_supported,
    fused_cg_solve_cuda,
    fused_dia_cg_solve_cuda,
    fused_dia_supported,
    fused_stencil_cg_solve_cuda,
    fused_stencil_supported,
)
from tpucg_torch.kernels.spmv import LANE, batch_dia_spmv_torch
from tpucg_torch.solver.operators import (
    DenseOperator,
    DiaOperator,
    LinearOperator,
    PoissonOperator,
    as_operator,
    padded_size,
)

CHUNK_MAX = 64  # laps per host read, once the chunks have grown
POWER_ITERS = 12  # power iterations of the poly preconditioner's lambda_max


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


def lambda_max_estimate(matvec: Callable, dot: Callable, like: torch.Tensor,
                        power_iters: int = POWER_ITERS) -> torch.Tensor:
    """Fixed-iteration power-method estimate of lambda_max(A) (tpucg's).

    ``matvec``/``dot`` are ``lap_ops``'s closures, called with no flag, or
    batched closures over (B, n) whose dot gives (B,): then each system gets
    its own estimate. The seed is the fixed oscillation cos(0.7 i) + 0.1
    over ``like``'s (padded) length, never derived from the rhs, which can
    vanish or live in the identity-tail pad. No host read: these are
    ``power_iters`` + 1 enqueued matvecs."""
    n = like.shape[-1]
    v = torch.cos(torch.arange(n, dtype=like.dtype, device=like.device) * 0.7) + 0.1
    v = v.expand(like.shape).contiguous()
    for _ in range(power_iters):
        y = matvec(v, None)
        v = y * torch.rsqrt(dot(y, y, None) + 1e-30)[..., None]
    lam = dot(v, matvec(v, None), None) / (dot(v, v, None) + 1e-30)
    return torch.clamp(lam, min=1e-30)


def make_poly_precond(matvec: Callable, dot: Callable, b: torch.Tensor, degree: int,
                      power_iters: int = POWER_ITERS) -> Callable:
    """Truncated-Neumann polynomial preconditioner, M^-1 = w sum_{i<d} (I - wA)^i
    with w = 0.95 / lambda_max (SPD for any degree when 0 < w lambda_max < 1).
    Each apply costs ``degree - 1`` matvecs. The returned ``precond(r, act)``
    passes ``act`` to ``matvec``: on the cuda lap that returns K1's shared
    output buffer, which the lap's Ap also lives in. That is safe because
    ``cg_loop`` consumes Ap in the x/r update before it calls ``precond``,
    and each product here is consumed before the next matvec."""
    if degree < 1:
        raise ValueError("poly degree must be >= 1")
    w = (0.95 / lambda_max_estimate(matvec, dot, b, power_iters))[..., None]

    def precond(r, act=None):
        z = w * r
        for _ in range(degree - 1):
            z = z + w * r - w * matvec(z, act)
        return z
    return precond


def make_precond(precondition: str, minv: Optional[torch.Tensor], matvec: Callable,
                 dot: Callable, b: torch.Tensor, degree: int) -> Optional[Callable]:
    """The ``precond(r, act)`` that ``cg_loop`` and ``batch_cg_loop`` take:
    None for ``"none"``, z = minv r for ``"jacobi"``, and for ``"poly"``
    ``make_poly_precond`` on ``matvec``/``dot`` (one system, or a batch)."""
    if precondition == "jacobi":
        return lambda r, act=None: minv * r
    if precondition == "poly":
        return make_poly_precond(matvec, dot, b, degree)
    return None


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
    """r = p = b - A x0; rsold = r.r. With ``precond`` (``precond(r, act)``
    gives z = M^-1 r) this is PCG: p = z0 and ``rsold`` carries r.z, while
    ``rslast`` carries r.r (the stopping test is always on the true
    residual)."""
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


def _require_backend(op: LinearOperator, backend: str) -> None:
    own = getattr(op, "backend", None)
    if own != backend:
        raise ValueError(
            f"the operator runs kernel backend {own!r} and the solve asked for "
            f"{backend!r}: make the operator with the solve's kernel"
        )


def lap_ops(op: LinearOperator, backend: str):
    """The ``(matvec, dot, lap)`` that ``cg_loop`` runs for ``op`` on
    ``backend``: ``matvec(x, act)`` and ``dot(u, v, act)`` take the lap's
    ``active`` flag last (a 0-d int32 tensor, or None in ``init_state`` and
    the power method: always run), and ``lap`` does the rest of a lap
    (``TorchLap`` or the CUDA lap). The operator's own backend must be
    ``backend``: one choice runs the whole lap, and a mismatch raises
    instead of mixing plain and hand-written kernels.

    On ``"cuda"`` the matvec is the operator's kernel (``op.launcher()``:
    K1, K6, K8 or K13) and the lap's kernels read the flag on the device and
    return at once when it is 0, so a frozen lap costs launches and nothing
    else. On ``"torch"`` the plain versions run and ``torch.where`` keeps
    what a frozen lap would change.
    """
    _require_backend(op, backend)
    if backend == "cuda":
        return _cuda_lap_ops(op)

    def dot(u, v, act):
        return dot_torch(u, v)

    def update(x, r, p, ap, alpha, act):
        xn, rn, rr = fused_update_torch(x, r, p, ap, alpha)
        keep = act.bool()
        return torch.where(keep, xn, x), torch.where(keep, rn, r), rr
    return op.matvec, dot, TorchLap(dot, update)


class TorchLap:
    """A lap after its matvec with the scalar work in plain torch ops, over
    ``dot(u, v, act)`` and ``update(x, r, p, ap, alpha, act) -> (x, r,
    r'.r')``: the plain route's, and the sharded routes' (their dot and
    update sum over the ranks). alpha is ``alpha_torch``, the tail
    ``lap_tail_torch`` (after the update without a preconditioner, else
    after r.z) and p's update ``p_update_torch``; the loop's scalars are the
    ``LapTail`` ``t``, rebound a lap."""

    def __init__(self, dot: Callable, update: Callable):
        self.dot, self._update = dot, update

    def start(self, state: _State, tol2, maxiter: int, safe_alpha: bool,
              preconditioned: bool) -> None:
        self.tol2, self.maxiter, self.safe_alpha = tol2, maxiter, safe_alpha
        self.preconditioned = preconditioned
        self.t = LapTail(k=state.k, rsold=state.rsold, rslast=state.rslast, done=state.done,
                         active=~state.done & (state.k < maxiter), hist=state.hist)

    def flag(self) -> torch.Tensor:
        return self.t.active.to(torch.int32)

    def alpha(self, p, ap, act):
        return alpha_torch(self.dot(p, ap, act), self.t.rsold, self.safe_alpha)

    def update(self, x, r, p, ap, alpha, act):
        x, r, self.rr = self._update(x, r, p, ap, alpha, act)
        if not self.preconditioned:
            self.t = lap_tail_torch(self.t, self.rr, self.rr, self.tol2, self.maxiter)
        return x, r

    def tail(self, r, z, act) -> None:
        self.t = lap_tail_torch(self.t, self.rr, self.dot(r, z, act), self.tol2, self.maxiter)

    def p_update(self, z, p):
        return p_update_torch(z, p, self.t.beta, self.t.step)

    def running(self) -> bool:
        return bool(self.t.active)

    def finish(self) -> LapTail:
        return self.t


def _cuda_lap_ops(op: LinearOperator):
    """The operator's matvec kernel (K1, K6, K8 or K13), K3 and the lap for
    ``cg_loop``, with the per-call host work moved out of the lap: the
    operator is checked (``op.launcher()``), the stream taken and every
    buffer allocated once, here, and the laps call the launch cores. A lap's
    outputs (Ap, the dots) live in these buffers and the next lap overwrites
    them; every consumer reads them in the same lap, in stream order. Calls
    without a flag (``init_state``, the power method) go through the
    checked wrappers and get fresh outputs, which the state keeps.
    ``cg_loop`` checks its vectors once; the matvec checks x's length every
    lap, so no launch reads past the operator.
    """
    launch = op.launcher()
    n, dev = op.padded_n, op.device
    y = torch.empty(n, dtype=torch.float32, device=dev)
    stream = cuda_stream(y)

    def matvec(x, act):
        if act is None:
            return op.matvec(x)
        if x.shape[0] != n or x.device != dev:
            raise ValueError(f"x {tuple(x.shape)} on {x.device} for an operator of {n} on {dev}")
        launch(x, y, act.data_ptr(), stream)
        return y

    def dot(u, v, act):
        if act is None:
            return dot_cuda(u, v)
        dot_launch(u, v, lap.scratch, lap.d, act.data_ptr(), stream)
        return lap.d

    lap = _CudaLap(y, stream)
    return matvec, dot, lap


class _CudaLap:
    """The lap after its matvec on the card, four launches and no torch op
    without a preconditioner: K3 in alpha mode (p.Ap, alpha), K2 with the
    lap's tail (in place on x and r) and p's update (in place on the loop's
    p). With one, K2 stores r'.r', the preconditioner runs, and K3 in tail
    mode takes r'.z and the tail. The loop's scalars live in ``CudaLapTail``
    buffers owned here, with the one scratch (partials and ticket, zeroed
    once) that these launches share in stream order; ``finish`` hands out
    copies, so what a state keeps is never a buffer a later solve
    overwrites."""

    def __init__(self, like: torch.Tensor, stream: int):
        self.stream = stream
        self.scratch = scratch_for(like)
        self.d, self.alpha_out = (torch.empty((), dtype=torch.float32, device=like.device)
                                  for _ in range(2))
        self.s = CudaLapTail(like.device)

    def start(self, state: _State, tol2, maxiter: int, safe_alpha: bool,
              preconditioned: bool) -> None:
        self.safe_alpha, self.preconditioned = safe_alpha, preconditioned
        hist = state.hist
        if hist is not None:
            if hist.dtype != torch.float32 or hist.dim() != 1 or hist.device != tol2.device:
                raise ValueError(f"a residual history the kernels write must be a 1-D f32 "
                                 f"vector on {tol2.device}, got {hist.dtype} "
                                 f"{tuple(hist.shape)} on {hist.device}")
            hist = hist.clone(memory_format=torch.contiguous_format)
        self.s.load(state.k, state.rsold, state.rslast, state.done, tol2, maxiter, hist)

    def flag(self) -> torch.Tensor:
        return self.s.active

    def alpha(self, p, ap, act):
        dot_alpha_launch(p, ap, self.scratch, self.d, self.s.rsold, self.alpha_out,
                         self.safe_alpha, act.data_ptr(), self.stream)
        return self.alpha_out

    def update(self, x, r, p, ap, alpha, act):
        if self.preconditioned:
            fused_update_launch(x, r, p, ap, alpha, x, r, self.scratch, self.s.rr,
                                act.data_ptr(), self.stream)
        else:
            fused_update_tail_launch(x, r, p, ap, alpha, x, r, self.scratch, self.s.rr,
                                     self.s.address, self.stream)
        return x, r

    def tail(self, r, z, act) -> None:
        dot_tail_launch(r, z, self.scratch, self.d, self.s.address, self.stream)

    def p_update(self, z, p):
        p_update_launch(z, p, self.s.beta, self.s.step, self.scratch, self.stream)
        return p

    def running(self) -> bool:
        return bool(self.s.active)

    def finish(self) -> LapTail:
        s = self.s
        return LapTail(k=s.k.clone(), rsold=s.rsold.clone(), rslast=s.rslast.clone(),
                       done=s.done.clone(), active=s.active.bool(), hist=s.hist)


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
    lap,
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

    ``matvec``/``dot``/``lap`` come from ``lap_ops`` (or a sharded route).
    A lap: Ap = matvec(p); alpha from p.Ap; x and r updated, r'.r'; with
    ``precond`` (``precond(r, act)`` gives z = M^-1 r, ``act`` the lap's
    flag as ``matvec`` takes it) z and r'.z; the tail (stop, beta, rsold,
    rslast, hist, done, k, active); then p = z + beta p where the lap
    stepped. ``state`` resumes a previous run (``maxiter`` bounds the
    cumulative k); its tensors are not modified. ``chunk`` fixes the laps
    per host read (default: 1, 2, 4, ... up to ``CHUNK_MAX``).
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
    # The cuda lap updates x, r and p in place: the loop owns its copies.
    x, r, p = (v.clone(memory_format=torch.contiguous_format)
               for v in (state.x, state.r, state.p))
    _check_state(x, r, p, state.rsold, state.rslast)
    tol2 = torch.tensor(tol, dtype=r.dtype, device=r.device) ** 2
    lap.start(state, tol2, maxiter, safe_alpha, precond is not None)
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(laps):
            act = lap.flag()
            ap = matvec(p, act)
            alpha = lap.alpha(p, ap, act)
            x, r = lap.update(x, r, p, ap, alpha, act)  # and the tail, unpreconditioned
            if precond is None:
                z = r
            else:
                z = precond(r, act)
                lap.tail(r, z, act)
            p = lap.p_update(z, p)
        if not lap.running():  # the one host read of the chunk
            break
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)
    t = lap.finish()
    return _State(k=t.k, x=x, r=r, p=p, rsold=t.rsold, rslast=t.rslast, done=t.done,
                  hist=t.hist)


class _BatchState(NamedTuple):
    """``batch_cg_loop``'s state: ``_State``'s fields with a leading batch
    axis, every scalar a (B,) tensor."""

    k: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rsold: torch.Tensor
    rslast: torch.Tensor
    done: torch.Tensor


def batch_matvec(A: torch.Tensor) -> Callable:
    """``matvec(v, act)`` over (B, n) for the (B, n, n) ``A``: one
    ``torch.bmm`` (tpucg's plain batched matvec is a ``jnp.dot``)."""
    return lambda v, act=None: torch.bmm(A, v[:, :, None])[:, :, 0]


def batch_dia_matvec(data: torch.Tensor, offsets) -> Callable:
    """``matvec(v, act)`` over (B, n) for the (B, ndiag, n) DIA slab: the
    batched shift-and-add (tpucg's per-system ``dia_spmv_interleaved_xla``)."""
    offsets = tuple(int(o) for o in offsets)
    return lambda v, act=None: batch_dia_spmv_torch(data, offsets, v)


def _batch_dot(u, v, act=None):
    return (u * v).sum(-1)


def batch_cg_loop(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    safe_alpha: bool = True,
    precond: Optional[Callable] = None,
    chunk: Optional[int] = None,
) -> _BatchState:
    """CG on B independent systems at once (tpucg's vmapped ``cg_loop``):
    ``b`` and ``x0`` are (B, n), ``matvec(v, act)`` maps (B, n) to (B, n)
    and ``precond(r, act)`` likewise. Every loop scalar is a (B,) device
    tensor and each system stops on its own: a lap masks the systems that
    have stopped with ``torch.where``, so they change nothing. As in
    ``cg_loop``, the host reads whether any system is still running once
    per chunk of laps (1, 2, 4, ... up to ``CHUNK_MAX``, or ``chunk``)."""
    if chunk is not None and chunk < 1:
        raise ValueError("chunk must be >= 1")
    dot = _batch_dot
    x = x0.clone()
    r = b - matvec(x, None)
    tol2 = torch.tensor(tol, dtype=r.dtype, device=r.device) ** 2
    rr = dot(r, r)
    if precond is None:
        p, rsold = r, rr
    else:
        p = precond(r, None)
        rsold = dot(r, p)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    rslast, done = rr, rr < tol2
    active = ~done & (k < maxiter)
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(laps):
            ap = matvec(p, None)
            pap = dot(p, ap)
            alpha = torch.where(pap != 0, rsold / pap, 0.0) if safe_alpha else rsold / pap
            on = active[:, None]
            x = torch.where(on, x + alpha[:, None] * p, x)
            r = torch.where(on, r - alpha[:, None] * ap, r)
            rr = dot(r, r)
            stop = rr < tol2
            if precond is None:
                z, rs_new = r, rr
            else:
                z = precond(r, None)
                rs_new = dot(r, z)
            step = active & ~stop
            p = torch.where(step[:, None], z + (rs_new / rsold)[:, None] * p, p)
            rsold = torch.where(step, rs_new, rsold)
            rslast = torch.where(active, rr, rslast)
            done = done | (active & stop)
            k = k + active.to(torch.int32)
            active = ~done & (k < maxiter)
        if not bool(active.any()):  # the one host read of the chunk
            break
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)
    return _BatchState(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rslast, done=done)


def _check_supported(config: CGConfig, interval, two_level) -> None:
    """Name the ROADMAP item of every configuration this slice does not run."""
    if config.method != "cg":
        raise NotImplementedError(f"method={config.method!r} is ROADMAP M8")
    if config.precondition == "block_jacobi":
        raise NotImplementedError("precondition='block_jacobi' is ROADMAP M8")
    if config.dtype != torch.float32:
        raise NotImplementedError(f"solve dtype {config.dtype} is ROADMAP M9")
    if interval is not None:
        raise NotImplementedError("interval= serves method='ca'/'chebyshev': ROADMAP M8")
    if two_level is not None:
        raise NotImplementedError("two_level= is ROADMAP M12")


def _fused_eligible(config: CGConfig, op: LinearOperator, backend: str, dtype,
                    record_residuals: bool) -> Optional[str]:
    """Which whole-solve kernel runs a solve in one launch: ``"dense"``
    (K4), ``"stencil"`` (K10) or ``"dia"`` (K11), else None (the lap path).
    This is tpucg's gate (``cg.py:2489-2542``) with ``"pallas"`` read as
    ``"cuda"``: a plain (``method="cg"``, no residual history) f32 solve on
    the cuda backend, preconditioned by what the kernel runs in-kernel
    (block Jacobi keeps the lap path):

    - ``DenseOperator``, f32 storage, none/jacobi/poly, padded n a multiple
      of 128 and at most ``FUSED_MAX_N`` under ``fused="always"`` or
      ``FUSED_AUTO_MAX_N`` under ``"auto"``; bf16 storage keeps the lap path;
    - ``PoissonOperator``, none/poly (jacobi is an iterate-exact no-op on
      the constant diagonal, so tpucg keeps it on the lap path);
    - ``DiaOperator``, f32 or bf16 slab, none/poly, and jacobi when 0 is
      among the offsets.

    The sparse size caps are the card's own. Where the port's route differs
    from tpucg's (each pinned by ``tests/test_torch_fused_sparse.py``):

    - Poisson grids that are not lane-tileable ((m*m) % 128 != 0, e.g.
      m = 10) and 128 < m <= ``FUSED_STENCIL_AUTO_MAX_M`` run K10 here and
      tpucg's lap path there; ``fused="always"`` runs K10 up to
      ``FUSED_STENCIL_MAX_M``, beyond tpucg's 128;
    - DIA operators whose slab plus solve state exceed tpucg's 100 MiB VMEM
      budget (f32 at m = 128 Poisson, 58.7 MB + 67 MB) run K11 here, up to
      padded n ``FUSED_DIA_AUTO_MAX_N`` (any n K11 takes under "always");
      so do DIA operators whose length is not a multiple of 128 (no main
      diagonal to pad), which tpucg cannot lane-tile;
    - tpucg's ``"xla"`` operators (``PoissonOperator(kernel="xla")``,
      ``DiaOperator.from_dia(backend="xla")``) have no counterpart: a port
      operator's backend is its device's.
    """
    if config.fused == "never" or backend != "cuda":
        return None
    if config.method != "cg" or record_residuals or dtype != torch.float32:
        return None
    pc = config.precondition
    if pc not in ("none", "jacobi", "poly"):
        return None
    always = config.fused == "always"
    if isinstance(op, PoissonOperator):
        if pc == "jacobi" or not fused_stencil_supported(op.m):
            return None
        return "stencil" if always or op.m <= FUSED_STENCIL_AUTO_MAX_M else None
    if isinstance(op, DiaOperator):
        if pc == "jacobi" and 0 not in op.offsets:
            return None
        if op.data.dtype not in (torch.float32, torch.bfloat16):
            return None
        if not fused_dia_supported(op.padded_n, op.offsets):
            return None
        return "dia" if always or op.padded_n <= FUSED_DIA_AUTO_MAX_N else None
    if not isinstance(op, DenseOperator) or op.A.dtype != torch.float32:
        return None
    npad = op.padded_n
    cap = FUSED_MAX_N if config.fused == "always" else FUSED_AUTO_MAX_N
    return "dense" if npad % 128 == 0 and npad <= cap else None


def _configure(config: Optional[CGConfig], overrides) -> CGConfig:
    if config is None:
        return CGConfig(**overrides)
    return dataclasses.replace(config, **overrides) if overrides else config


def _fused_result(x, k, rr, tol: float) -> CGResult:
    """tpucg's result of a whole-solve kernel: ||r|| = sqrt(rr), converged
    when rr < tol^2."""
    return CGResult(x=x, iterations=k, residual_norm=rr.sqrt(),
                    converged=rr < torch.tensor(tol, dtype=rr.dtype, device=rr.device) ** 2)


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

    ``A`` is a dense array or tensor, a sparse container (a ``CSRMatrix``
    becomes an ``EllOperator`` as in tpucg; ``best_sparse_operator`` picks a
    format instead), or an operator (``DenseOperator``, ``DiaOperator``,
    ``PoissonOperator``, ``WellOperator``, ``BsrOperator``,
    ``EllOperator``). ``device``
    defaults to the device of a tensor or operator ``A``, else the card when
    there is one; ``kernel="auto"`` then runs the CUDA kernels on a CUDA
    device and the plain versions elsewhere. On the cuda backend a solve
    ``_fused_eligible`` admits runs as one launch of K4, K10 or K11; every
    other solve, and ``fused="never"``, takes the lap path (``cg_loop`` on
    the operator's matvec kernel, K2 and K3). ``precondition`` is
    ``"none"``, ``"jacobi"`` or ``"poly"`` (degree ``poly_degree``).
    ``record_residuals`` returns the per-lap ||r|| in
    ``residual_history``; ``chunk`` is ``cg_loop``'s.
    """
    config = _configure(config, overrides)
    _check_supported(config, interval, two_level)
    if device is None and isinstance(A, (LinearOperator, torch.Tensor)):
        device = A.device
    device = canonical_device(device)
    backend = resolve_backend(config.kernel, device)
    op = as_operator(A, backend=backend, device=device)
    if op.device != device:
        raise ValueError(f"operator lives on {op.device}, solve asked for {device}")
    _require_backend(op, backend)  # K4 too: one choice runs the whole solve
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
    poly = config.precondition == "poly"
    kind = _fused_eligible(config, op, backend, config.dtype, record_residuals)
    if kind is not None:
        kw = dict(tol=tol, maxiter=maxiter, safe_alpha=bool(config.safe_alpha),
                  precondition=config.precondition,
                  poly_degree=config.poly_degree if poly else 0)
        if kind == "dense":
            x, k, rr = fused_cg_solve_cuda(op.A, b, x0, minv=minv, **kw)
        elif kind == "stencil":
            x, k, rr = fused_stencil_cg_solve_cuda(b, x0, op.m, **kw)
        else:
            x, k, rr = fused_dia_cg_solve_cuda(op.data, op.offsets, b, x0, **kw)
        return _fused_result(x[:n], k, rr, tol)
    matvec, dot, lap = lap_ops(op, backend)
    precond = make_precond(config.precondition, minv, matvec, dot, b, config.poly_degree)
    s = cg_loop(
        matvec, dot, lap, b, x0,
        tol=tol, maxiter=maxiter, safe_alpha=bool(config.safe_alpha), precond=precond,
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


def cg_solve_batch(
    A,
    b,
    X0=None,
    config: Optional[CGConfig] = None,
    *,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve a batch of independent SPD systems A[i] x[i] = b[i] (tpucg's
    ``cg_solve_batch``): ``A`` is (B, n, n), ``b`` and ``X0`` (B, n), as
    arrays or tensors; ``device`` defaults as in ``cg_solve``.

    Each system is padded with an identity tail to a multiple of 128. On the
    cuda backend, unless ``fused="never"``, a batch with precondition none
    or jacobi and padded n <= ``FUSED_BATCH_MAX_N`` runs as one launch of
    K5. Every other batch (larger n, ``"poly"``, the torch backend) runs
    ``batch_cg_loop`` with ``torch.bmm`` as its matvec. The solve is f32.
    Result fields are batched: ``x`` is (B, n); ``iterations``,
    ``residual_norm`` and ``converged`` are (B,).
    """
    config = _configure(config, overrides)
    if config.method != "cg":
        raise ValueError("cg_solve_batch supports method='cg' only")
    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    device = canonical_device(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=device)
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    nsys, n = A.shape[0], A.shape[1]
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (nsys, n):
        raise ValueError(f"b must be ({nsys}, {n}), got {tuple(b.shape)}")
    X0 = (
        torch.zeros((nsys, n), dtype=torch.float32, device=device)
        if X0 is None
        else torch.as_tensor(X0, dtype=torch.float32, device=device)
    )
    if X0.shape != (nsys, n):
        raise ValueError(f"X0 must be ({nsys}, {n}), got {tuple(X0.shape)}")
    npad = padded_size(n)
    if npad != n:
        # Identity-tail padding, batched: tail rows solve 1 x = 0 and stay inert.
        A = F.pad(A, (0, npad - n, 0, npad - n))
        idx = torch.arange(n, npad, device=device)
        A[:, idx, idx] = 1.0
        b = F.pad(b, (0, npad - n))
        X0 = F.pad(X0, (0, npad - n))
    A = A.contiguous()
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    backend = resolve_backend(config.kernel, device)
    if config.precondition == "block_jacobi":
        raise ValueError(
            "cg_solve_batch supports precondition 'none', 'jacobi', or 'poly' "
            "(per-system block inverses are unimplemented)"
        )
    minv = None
    if config.precondition == "jacobi":
        d = torch.diagonal(A, dim1=1, dim2=2)
        minv = torch.where(d != 0, 1.0 / d, 1.0)
    tol, safe_alpha = float(config.tol), bool(config.safe_alpha)
    if (
        backend == "cuda"
        and config.fused != "never"
        and config.precondition in ("none", "jacobi")
        and npad <= FUSED_BATCH_MAX_N
    ):
        x, k, rr = fused_batch_cg_solve_cuda(
            A, b, X0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            precondition=config.precondition, minv=minv,
        )
        res = _fused_result(x, k, rr, tol)
    else:
        matvec = batch_matvec(A)
        precond = make_precond(config.precondition, minv, matvec, _batch_dot, b,
                               config.poly_degree)
        s = batch_cg_loop(matvec, b, X0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                          precond=precond, chunk=chunk)
        res = CGResult(x=s.x, iterations=s.k, residual_norm=s.rslast.sqrt(), converged=s.done)
    if npad != n:
        res = res._replace(x=res.x[:, :n])
    return res


def cg_solve_batch_banded(
    data,
    offsets,
    b,
    X0=None,
    config: Optional[CGConfig] = None,
    storage_dtype=torch.float32,
    *,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve a batch of independent banded SPD systems A[i] x[i] = b[i]
    (tpucg's ``cg_solve_batch_banded``, ``cg.py:1906``): ``data`` is (B,
    ndiag, n) canonical DIA values (``data[i, d, j] = A_i[j, j +
    offsets[d]]``), ``offsets`` one tuple for the batch, ``b`` and ``X0``
    (B, n), as arrays or tensors; ``device`` defaults as in ``cg_solve``.
    ``precondition`` is ``"none"`` or ``"jacobi"``; ``storage_dtype`` f32 or
    bf16 (the slab's storage; f32 sums).

    n is padded to a multiple of 128 with an identity tail on the main
    diagonal (raises without one). On the cuda backend, unless
    ``fused="never"``, a batch of padded n <= ``FUSED_BATCH_DIA_MAX_N`` runs
    as one launch of K12; every other batch runs ``batch_cg_loop`` over the
    batched shift-and-add, as tpucg runs its XLA loop. Result fields are
    batched like ``cg_solve_batch``'s.
    """
    config = _configure(config, overrides)
    if config.method != "cg":
        raise ValueError("cg_solve_batch_banded supports method='cg' only")
    if config.precondition not in ("none", "jacobi"):
        raise ValueError("cg_solve_batch_banded supports precondition 'none' or 'jacobi'")
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    if device is None and isinstance(data, torch.Tensor):
        device = data.device
    device = canonical_device(device)
    data = torch.as_tensor(data, dtype=torch.float32, device=device)
    if data.dim() != 3:
        raise ValueError(f"data must be (B, ndiag, n), got {tuple(data.shape)}")
    offsets = tuple(int(o) for o in offsets)
    nsys, ndiag, n = data.shape
    if ndiag != len(offsets):
        raise ValueError(f"data has {ndiag} diagonals, offsets has {len(offsets)}")
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (nsys, n):
        raise ValueError(f"b must be ({nsys}, {n}), got {tuple(b.shape)}")
    X0 = (
        torch.zeros((nsys, n), dtype=torch.float32, device=device)
        if X0 is None
        else torch.as_tensor(X0, dtype=torch.float32, device=device)
    )
    if X0.shape != (nsys, n):
        raise ValueError(f"X0 must be ({nsys}, {n}), got {tuple(X0.shape)}")
    npad = round_up(n, LANE)
    if npad != n:
        if 0 not in offsets:
            raise ValueError(
                "non-128-multiple n needs a stored main diagonal for the identity padding")
        data = F.pad(data, (0, npad - n))
        data[:, offsets.index(0), n:] = 1.0
        b = F.pad(b, (0, npad - n))
        X0 = F.pad(X0, (0, npad - n))
    data = data.to(storage_dtype).contiguous()
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    backend = resolve_backend(config.kernel, device)
    tol, safe_alpha = float(config.tol), bool(config.safe_alpha)
    if backend == "cuda" and config.fused != "never" and fused_batch_dia_supported(npad, offsets):
        x, k, rr = fused_batch_dia_cg_solve_cuda(
            data, offsets, b.contiguous(), X0.contiguous(), tol=tol, maxiter=maxiter,
            safe_alpha=safe_alpha, precondition=config.precondition,
        )
        res = _fused_result(x, k, rr, tol)
    else:
        matvec = batch_dia_matvec(data, offsets)
        minv = dia_minv(data, offsets) if config.precondition == "jacobi" else None
        precond = make_precond(config.precondition, minv, matvec, _batch_dot, b, 0)
        s = batch_cg_loop(matvec, b, X0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                          precond=precond, chunk=chunk)
        res = CGResult(x=s.x, iterations=s.k, residual_norm=s.rslast.sqrt(), converged=s.done)
    if npad != n:
        res = res._replace(x=res.x[:, :n])
    return res
