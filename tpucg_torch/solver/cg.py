"""The CG iteration on the device (the dense and structured-sparse slices of
``tpucg.solver.cg``).

Contract (reference ``serialConjugate.c:180-259``, as in tpucg):

- float32 recurrence: r = p = b - A x0; rsold = r.r; then per lap
  alpha = rsold / (p.Ap); x += alpha p; r -= alpha Ap; beta = r.r;
  STOP if sqrt(beta) < tol (tested after the x/r update, BEFORE the p
  update, so on convergence p and rsold are left as they were);
  else p = r + (beta/rsold) p; rsold = beta. At most n laps.

tpucg runs each loop as one ``lax.while_loop`` on the device. Here one
chunk runner (``run_chunks``) serves every loop: the host enqueues laps in
chunks of 1, 2, 4, ... up to ``CHUNK_MAX`` and reads the loop's 0-d
``active`` flag once per chunk, so a 4-lap solve costs 3 host reads. Every
loop scalar stays a 0-d device tensor. A lap enqueued after the solve has
stopped changes nothing (k, x, r, p, rsold, rslast, done): on the cuda
backend the classic lap's kernels read ``active`` on the device and return
at once (p's update reads the ``step`` the last running lap's tail set and
cleared), and elsewhere ``torch.where`` keeps the old values. Lap counts
and results therefore do not depend on the chunk size.

Beside the classic loop (``cg_loop``) are tpucg's other methods:
``pipelined_cg_loop`` (Ghysels-Vanroose), ``ca_cg_loop`` (s-step CG on a
Chebyshev basis) and ``chebyshev_loop``, each enqueued in masked steps (a
lap, a block of s laps, a chunk of ``check_every`` laps) through the same
runner; their matvecs and dots are the operator's kernel and K3, called
without a flag, so each product is a fresh tensor. ``run_method`` runs
them for ``cg_solve`` and for the sharded solves, whose closures sum over
the ranks (``solver/sharded.py``). Block Jacobi
(``block_jacobi_minv``, ``make_block_precond``) and the spectral interval
(``spectral_interval_estimate``, ``spectral_interval``) serve them.

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

``cg_solve_multi`` solves k right-hand sides of one system in lockstep
(``multi_cg_loop``) and ``cg_solve_block`` by true block CG
(``block_cg_loop``, ``block_pcg_loop`` and their k x k algebra in torch
ops), both on the operator's ``matvec_multi``: K6 x k, K8 x k or K13 x k
on the card, a GEMM for a dense A. An f64 solve runs the plain route
(``TorchLap``) on the solve's device, since no kernel is f64.

``cg_loop`` also runs tpucg's periodic modes: true-residual stopping every
``check_true_every`` laps with the stagnation exit and the guarded finish
of K3 and K2 (``cg_solve(two_level=)`` and the deflated two-level solve
take it at ``TRUE_CHECK_EVERY``), and residual replacement every
``replace_every`` laps. ``solver/twolevel.py``, ``solver/deflation.py`` and
``solver/minres.py`` build on this module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
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


def run_chunks(step: Callable[[], None], running: Callable[[], bool],
               chunk: Optional[int] = None, laps_per_step: int = 1) -> None:
    """The one chunk runner under every loop: enqueue ``step`` (one masked
    step of ``laps_per_step`` laps: a lap, a CA block, a Chebyshev chunk)
    in chunks of 1, 2, 4, ... up to ``CHUNK_MAX`` laps, or of a fixed
    ``chunk`` laps, each rounded down to whole steps (at least one), and
    read ``running()`` (the loop's device flag) once per chunk. A step
    must read nothing back to the host and must change nothing once the
    loop has stopped, so the chunk size moves no result."""
    if chunk is not None and chunk < 1:
        raise ValueError("chunk must be >= 1")
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(max(1, laps // laps_per_step)):
            step()
        if not running():  # the one host read of the chunk
            return
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)


def lambda_max_estimate(matvec: Callable, dot: Callable, like: torch.Tensor,
                        power_iters: int = POWER_ITERS,
                        absolute: bool = False) -> torch.Tensor:
    """Fixed-iteration power-method estimate of lambda_max(A) (tpucg's).

    ``matvec``/``dot`` are ``lap_ops``'s closures, called with no flag, or
    batched closures over (B, n) whose dot gives (B,): then each system gets
    its own estimate. The seed is the fixed oscillation cos(0.7 i) + 0.1
    over ``like``'s (padded) length, never derived from the rhs, which can
    vanish or live in the identity-tail pad. ``absolute`` estimates the
    spectral radius instead (the Rayleigh quotient's magnitude), for an
    operator whose dominant eigenvalue may be negative. No host read: these
    are ``power_iters`` + 1 enqueued matvecs."""
    n = like.shape[-1]
    v = torch.cos(torch.arange(n, dtype=like.dtype, device=like.device) * 0.7) + 0.1
    v = v.expand(like.shape).contiguous()
    for _ in range(power_iters):
        y = matvec(v, None)
        v = y * torch.rsqrt(dot(y, y, None) + 1e-30)[..., None]
    lam = dot(v, matvec(v, None), None) / (dot(v, v, None) + 1e-30)
    if absolute:
        lam = lam.abs()
    return torch.clamp(lam, min=1e-30)


def spectral_interval_estimate(matvec: Callable, dot: Callable, like: torch.Tensor,
                               power_iters: int = 16):
    """Two-sided power-method bounds ``(lam_lo, lam_hi)`` of an SPD operator
    (tpucg's): ``lam_hi`` from a direct power iteration, ``lam_lo`` from one
    on the reflected operator lam_hi I - A, whose dominant eigenvalue is
    lam_hi - lam_min. Both are estimates: lam_hi is typically a little
    under, lam_lo a little over, so each consumer pads them. ``matvec`` and
    ``dot`` take ``lap_ops``'s ``(v, act)`` form."""
    lam_hi = lambda_max_estimate(matvec, dot, like, power_iters)

    def reflected(v, act=None):
        return lam_hi * v - matvec(v, act)
    refl = lambda_max_estimate(reflected, dot, like, power_iters, absolute=True)
    lam_lo = torch.minimum(torch.clamp(lam_hi - refl, min=0.0), lam_hi)
    return lam_lo, lam_hi


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


def invert_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Block Jacobi's set-up on an extracted (nb, bs, bs) batch (tpucg's):
    each block plus a small trace-relative ridge, inverted once by
    ``torch.linalg.inv`` and symmetrized. Only the preconditioner's quality
    depends on this inverse (PCG needs M fixed and SPD, and the stopping
    test stays on the true residual), so the library's LU is used here as
    tpucg uses XLA's."""
    bs = blocks.shape[1]
    tr = torch.diagonal(blocks, dim1=1, dim2=2).sum(-1) / bs
    ridge = 1e-6 * tr + 1e-30
    eye = torch.eye(bs, dtype=blocks.dtype, device=blocks.device)
    minv = torch.linalg.inv(blocks + ridge[:, None, None] * eye[None])
    return 0.5 * (minv + minv.transpose(1, 2))


def block_jacobi_minv(op: LinearOperator, bs: int) -> torch.Tensor:
    """The (nb, bs, bs) inverted diagonal blocks of A: block Jacobi's
    M^-1, which also absorbs the coupling inside each block (bands,
    per-node blocks) where point Jacobi undoes only the scaling."""
    return invert_blocks(op.diagonal_blocks(bs))


def make_block_apply(S: torch.Tensor, npad: int) -> Callable:
    """Apply the block-diagonal (nb, bs, bs) ``S`` to an (npad, k) block:
    one batched (bs, bs) x (bs, k) product (TF32 off). Rows past npad (bs
    not dividing it) are padded in and cut off, so the tail passes
    through."""
    nb, bs, _ = S.shape
    pad = nb * bs - npad

    def apply(Y):
        Yp = F.pad(Y, (0, 0, 0, pad)) if pad else Y
        Z = torch.bmm(S, Yp.reshape(nb, bs, -1)).reshape(nb * bs, -1)
        return Z[:npad] if pad else Z
    return apply


def make_block_precond(minv: torch.Tensor, npad: int) -> Callable:
    """z = M^-1 r for block Jacobi's ``minv`` (nb, bs, bs): ``make_block_apply``
    on r as a one-column block (a ``torch`` call, full f32 with TF32 off).
    The pad blocks are identity, so pad coordinates pass through."""
    apply = make_block_apply(minv, npad)

    def precond(r, act=None):
        return apply(r[:, None])[:, 0]
    return precond


def sqrt_pair_blocks(blocks: torch.Tensor):
    """Block Jacobi's split pair on an extracted (nb, bs, bs) batch
    (tpucg's): (M^-1/2, M^1/2) of each block from one batched
    ``torch.linalg.eigh`` (set-up, as tpucg's XLA eigh), eigenvalues floored
    at 1e-12 of each block's largest and at 1e-30 so a singular tail block
    cannot NaN the rsqrt, both symmetrized."""
    w, V = torch.linalg.eigh(blocks)
    w = torch.maximum(w, torch.clamp(1e-12 * w[:, -1:], min=1e-30))
    vt = V.transpose(1, 2)
    isq = (V * torch.rsqrt(w)[:, None, :]) @ vt
    sq = (V * torch.sqrt(w)[:, None, :]) @ vt
    return 0.5 * (isq + isq.transpose(1, 2)), 0.5 * (sq + sq.transpose(1, 2))


def block_jacobi_sqrt_pair(op: LinearOperator, bs: int):
    """(M^-1/2, M^1/2) of M = blockdiag(A) in blocks of ``bs``: block CG's
    blockwise equilibration (``cg_solve_block``), from the operator's
    ``diagonal_blocks``."""
    return sqrt_pair_blocks(op.diagonal_blocks(bs))


def make_precond(precondition: str, minv: Optional[torch.Tensor], matvec: Callable,
                 dot: Callable, b: torch.Tensor, degree: int) -> Optional[Callable]:
    """The ``precond(r, act)`` that the loops take: None for ``"none"``,
    z = minv r for ``"jacobi"``, the batched block product of
    ``make_block_precond`` for ``"block_jacobi"`` (``minv`` (nb, bs, bs)),
    and for ``"poly"`` ``make_poly_precond`` on ``matvec``/``dot`` (one
    system, or a batch)."""
    if precondition == "jacobi":
        return lambda r, act=None: minv * r
    if precondition == "block_jacobi":
        return make_block_precond(minv, b.shape[-1])
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


def _solve_operator(A, kernel: str, device):
    """The f32 operator of a solve, its backend and device (default: A's,
    for a tensor or operator, else the card, which raises when there is
    none); the operator's backend must be the solve's."""
    if device is None and isinstance(A, (LinearOperator, torch.Tensor)):
        device = A.device
    device = canonical_device(device)
    backend = resolve_backend(kernel, device)
    op = as_operator(A, backend=backend, device=device)
    if op.device != device:
        raise ValueError(f"operator lives on {op.device}, solve asked for {device}")
    _require_backend(op, backend)
    return op, backend, device


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
    return _torch_lap_ops(op)


def _torch_lap_ops(op: LinearOperator):
    """``lap_ops``'s plain route on any device: the operator's ``matvec``
    and plain dots and updates (float64 vectors included: the route of an
    f64 solve, where the operators take their plain products)."""
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
              preconditioned: bool, guard: bool = False) -> None:
        self.tol2, self.maxiter, self.safe_alpha = tol2, maxiter, safe_alpha
        self.preconditioned, self.guard = preconditioned, guard
        self.t = LapTail(k=state.k, rsold=state.rsold, rslast=state.rslast, done=state.done,
                         active=~state.done & (state.k < maxiter), hist=state.hist)

    def flag(self) -> torch.Tensor:
        return self.t.active.to(torch.int32)

    def alpha(self, p, ap, act):
        return alpha_torch(self.dot(p, ap, act), self.t.rsold, self.safe_alpha, self.guard)

    def update(self, x, r, p, ap, alpha, act):
        x, r, self.rr = self._update(x, r, p, ap, alpha, act)
        if not self.preconditioned:
            self.t = lap_tail_torch(self.t, self.rr, self.rr, self.tol2, self.maxiter,
                                    self.guard)
        return x, r

    def tail(self, r, z, act) -> None:
        self.t = lap_tail_torch(self.t, self.rr, self.dot(r, z, act), self.tol2, self.maxiter,
                                self.guard)

    def scalars(self) -> LapTail:
        """The loop's scalars as they stand (no copy)."""
        return self.t

    def put(self, rsold=None, rslast=None, done=None) -> None:
        """Set scalars between laps (a true-residual check, a residual
        replacement); ``active`` follows ``done`` and k."""
        t = self.t
        done = t.done if done is None else done
        self.t = t._replace(rsold=t.rsold if rsold is None else rsold,
                            rslast=t.rslast if rslast is None else rslast, done=done,
                            active=~done & (t.k < self.maxiter))

    def p_update(self, z, p):
        return p_update_torch(z, p, self.t.beta, self.t.step)

    def running(self) -> bool:
        return bool(self.t.active)

    def finish(self) -> LapTail:
        return self.t


def flagged_matvec(op: LinearOperator, backend: str) -> Callable:
    """``lap_ops``'s ``matvec(x, act)`` alone: on ``"cuda"`` the operator's
    kernel under the flag ``act``, into one output buffer that every flagged
    call overwrites (so each product is consumed before the next flagged
    matvec), and the checked wrapper for ``act`` None; on ``"torch"`` the
    operator's ``matvec``."""
    _require_backend(op, backend)
    if backend != "cuda":
        return op.matvec
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
    matvec.out = y
    return matvec


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
    matvec = flagged_matvec(op, "cuda")
    y = matvec.out
    stream = cuda_stream(y)

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
              preconditioned: bool, guard: bool = False) -> None:
        if state.rsold.dtype != torch.float32:
            raise ValueError(f"the CUDA lap's kernels are f32, the state is {state.rsold.dtype}")
        self.safe_alpha, self.preconditioned = safe_alpha, preconditioned
        self.guard, self.maxiter = guard, maxiter
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
                         self.safe_alpha, act.data_ptr(), self.stream, self.guard)
        return self.alpha_out

    def update(self, x, r, p, ap, alpha, act):
        if self.preconditioned:
            fused_update_launch(x, r, p, ap, alpha, x, r, self.scratch, self.s.rr,
                                act.data_ptr(), self.stream)
        else:
            fused_update_tail_launch(x, r, p, ap, alpha, x, r, self.scratch, self.s.rr,
                                     self.s.address, self.stream, self.guard)
        return x, r

    def tail(self, r, z, act) -> None:
        dot_tail_launch(r, z, self.scratch, self.d, self.s.address, self.stream, self.guard)

    def scalars(self) -> LapTail:
        """The loop's scalar buffers as they stand (no copy)."""
        s = self.s
        return LapTail(k=s.k, rsold=s.rsold, rslast=s.rslast, done=s.done, active=s.active)

    def put(self, rsold=None, rslast=None, done=None) -> None:
        """Set scalars between laps, in place on the device (a true-residual
        check, a residual replacement); ``active`` follows ``done`` and k."""
        s = self.s
        if rsold is not None:
            s.rsold.copy_(rsold)
        if rslast is not None:
            s.rslast.copy_(rslast)
        if done is not None:
            s.done.copy_(done)
            s.active.copy_(~s.done & (s.k < self.maxiter))

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
    """The loop's vectors: f32 (or, on the plain route of an f64 solve,
    f64) of one length, its scalars 0-d of the same dtype, all on one
    device (checked once per loop, before any lap)."""
    vecs, scalars = (x, r, p), (rsold, rslast)
    if (
        x.dtype not in (torch.float32, torch.float64)
        or any(v.dtype != x.dtype for v in vecs + scalars)
        or x.dim() != 1 or not (x.shape == r.shape == p.shape)
        or any(s.dim() != 0 for s in scalars)
        or any(v.device != x.device for v in vecs + scalars)
    ):
        raise ValueError(
            "CG state needs f32 (or f64) x, r, p of one length and 0-d rsold, rslast "
            "of their dtype on one device, got " + ", ".join(
                f"{v.dtype} {tuple(v.shape)} on {v.device}" for v in vecs + scalars)
        )


# True-residual stopping cadence of the strong-preconditioner solves
# (two-level, deflation composed with two-level; tpucg's TRUE_CHECK_EVERY):
# at high condition the f32 recurrence decouples from the true residual in
# both directions, so these solves test ||b - A x|| every 16 laps.
TRUE_CHECK_EVERY = 16


class StagCarry(NamedTuple):
    """The stagnation exit's bookkeeping between ``cg_loop`` calls (tpucg's
    ``(prev_rr, prev_stag)``): the true r.r of the last check boundary and
    whether its window was stagnant, 0-d tensors on the loop's device."""

    prev_rr: torch.Tensor
    prev_stag: torch.Tensor


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
    replace_fn: Optional[Callable] = None,
    check_true_every: Optional[int] = None,
    stag_carry=None,
    return_stag: bool = False,
) -> Union[_State, Tuple[_State, StagCarry]]:
    """Run CG laps until ``sqrt(r.r) < tol`` or k == ``maxiter``.

    ``matvec``/``dot``/``lap`` come from ``lap_ops`` (or a sharded route).
    A lap: Ap = matvec(p); alpha from p.Ap; x and r updated, r'.r'; with
    ``precond`` (``precond(r, act)`` gives z = M^-1 r, ``act`` the lap's
    flag as ``matvec`` takes it) z and r'.z; the tail (stop, beta, rsold,
    rslast, hist, done, k, active); then p = z + beta p where the lap
    stepped. ``state`` resumes a previous run (``maxiter`` bounds the
    cumulative k); its tensors are not modified. ``chunk`` fixes the laps
    per host read (``run_chunks``; default: 1, 2, 4, ... up to
    ``CHUNK_MAX``).

    tpucg's periodic modes (``tpucg/solver/cg.py:280-516``), serial:

    - ``check_true_every`` (needs ``b``): the stop tests the TRUE residual.
      The per-lap recurrence test is off (tol^2 = -1); after every lap that
      lands on k % check_true_every == 0 the loop computes r_t = b - A x and
      rr_t = r_t.r_t, and stops on rr_t < tol^2 or on two stagnant windows
      in a row (rr_t > 0.995 of the last boundary's and > 100 times the
      recurrence's r.r); ``rslast`` takes rr_t at a boundary only, so a
      solve cut by ``maxiter`` mid-window keeps the recurrence's r.r. The
      lap runs the guarded finish (alpha 0 unless p.Ap > 0, beta 0 and
      rsold ``FLT_MIN`` where r.z is not > 0: K3 and K2 with ``guard``).
    - ``replace_every`` (needs ``b``; not with ``check_true_every``): every
      that-many laps a running solve re-anchors r to b - A x (through
      ``replace_fn(x, r_true) -> (x, r)`` where given) and rsold to (r,
      M^-1 r); p is kept.
    - ``stag_carry`` / ``return_stag``: the stagnation bookkeeping lives
      outside the state; ``return_stag=True`` returns ``(state,
      StagCarry)``, which a later call takes as ``stag_carry`` to continue
      the two-window rule (without ``check_true_every`` the carry passes
      through, default (inf, False)).

    The host knows which lap lands on a boundary from the laps it enqueued
    (and, for a resumed state, one read of its k); the check and the
    replacement are masked on the device by a flag that is set only where
    that lap ran (k equals the boundary), through the flagged matvec and K3
    on the card, so a frozen lap's check changes nothing and the chunk size
    moves no result.
    """
    if replace_every and check_true_every:
        raise ValueError("replace_every and check_true_every are mutually exclusive")
    every = check_true_every or replace_every
    if every and b is None:
        raise ValueError("replace_every/check_true_every need b")
    k0 = 0
    if state is None:
        state = init_state(matvec, dot, b, x0, tol, precond=precond, hist_len=hist_len)
    elif every:
        k0 = int(state.k)  # the one host read of a resumed periodic loop
    # The cuda lap updates x, r and p in place: the loop owns its copies.
    x, r, p = (v.clone(memory_format=torch.contiguous_format)
               for v in (state.x, state.r, state.p))
    _check_state(x, r, p, state.rsold, state.rslast)
    dev, dt = r.device, r.dtype
    true_tol2 = torch.tensor(tol, dtype=dt, device=dev) ** 2
    tol2 = torch.full((), -1.0, dtype=dt, device=dev) if check_true_every else true_tol2
    lap.start(state, tol2, maxiter, safe_alpha, precond is not None, bool(check_true_every))
    if stag_carry is None:
        stag = StagCarry(torch.full((), float("inf"), dtype=dt, device=dev),
                         torch.zeros((), dtype=torch.bool, device=dev))
    else:
        stag = StagCarry(torch.as_tensor(stag_carry[0], dtype=dt, device=dev),
                         torch.as_tensor(stag_carry[1], dtype=torch.bool, device=dev))

    def lap_step():
        nonlocal x, r, p
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

    def true_check(at):
        # tpucg's outer_body after its window: the check takes effect only
        # where the boundary's lap ran (`at`).
        nonlocal stag
        flag = at.to(torch.int32)
        r_t = b - matvec(x, flag)
        rr_t = dot(r_t, r_t, flag)
        t = lap.scalars()
        stagnant = (rr_t > 0.995 * stag.prev_rr) & (rr_t > 100.0 * t.rslast)
        stop = at & ((rr_t < true_tol2) | (stagnant & stag.prev_stag))
        lap.put(rslast=torch.where(at, rr_t, t.rslast), done=t.done | stop)
        stag = StagCarry(torch.where(at, rr_t, stag.prev_rr),
                         torch.where(at, stagnant, stag.prev_stag))

    def replace(at):
        nonlocal x, r
        flag = at.to(torch.int32)
        r_true = b - matvec(x, flag)
        x_n, r_n = (x, r_true) if replace_fn is None else replace_fn(x, r_true)
        z_t = r_n if precond is None else precond(r_n, flag)
        rs_t = dot(r_n, z_t, flag)
        lap.put(rsold=torch.where(at, rs_t, lap.scalars().rsold))
        x, r = torch.where(at, x_n, x), torch.where(at, r_n, r)

    laps = 0  # laps enqueued: a lap that runs leaves k = k0 + laps

    def step():
        nonlocal laps
        lap_step()
        laps += 1
        k_b = k0 + laps
        if every and k_b % every == 0 and k_b <= maxiter:
            t = lap.scalars()
            if check_true_every:
                true_check(t.k == k_b)
            else:
                replace((t.k == k_b) & ~t.done)
    run_chunks(step, lap.running, chunk)
    t = lap.finish()
    st = _State(k=t.k, x=x, r=r, p=p, rsold=t.rsold, rslast=t.rslast, done=t.done,
                hist=t.hist)
    return (st, stag) if return_stag else st


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

    def lap():
        nonlocal x, r, p, rsold, rslast, done, k, active
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
    run_chunks(lap, lambda: bool(active.any()), chunk)
    return _BatchState(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rslast, done=done)


# Residual replacement of PRECONDITIONED pipelined CG (tpucg's cadence): its
# r/w recurrences drift as ||M^-1|| grows, so every that-many laps they are
# recomputed from their definitions.
PIPE_REPLACE_EVERY = 25


def _keep(on: torch.Tensor, new, old):
    """``new`` where the 0-d flag ``on`` is set, else ``old`` (None stays)."""
    return None if new is None else torch.where(on, new, old)


class _PipeState(NamedTuple):
    """``pipelined_cg_loop``'s state, with tpucg's field names."""

    k: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    w: torch.Tensor       # A M^-1 r (recurrence-maintained)
    p: torch.Tensor
    s: torch.Tensor       # A p
    z: torch.Tensor       # A M^-1 s
    gamma: torch.Tensor   # r.u of the previous lap (u = M^-1 r; r.r when M = I)
    alpha: torch.Tensor
    rslast: torch.Tensor
    done: torch.Tensor
    u: Optional[torch.Tensor] = None  # M^-1 r (preconditioned only)
    q: Optional[torch.Tensor] = None  # M^-1 s (preconditioned only)


def pipelined_cg_loop(
    matvec: Callable,
    dots: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    safe_alpha: bool = True,
    precond: Optional[Callable] = None,
    replace_every: Optional[int] = None,
    chunk: Optional[int] = None,
) -> _PipeState:
    """Pipelined CG/PCG (Ghysels & Vanroose 2014; tpucg's
    ``pipelined_cg_loop``): classic CG's Krylov iterates with every dot of
    a lap in one ``dots(pairs)`` call whose inputs do not depend on the
    lap's matvec, so a distributed lap can reduce them in one collective
    that overlaps the product. ``matvec(v, act)`` and ``precond(r, act)``
    are called without a flag; ``dots`` maps a list of (u, v) pairs to
    their dots.

    The lap's scalars are breakdown-safe (a gamma <= 0 restarts the
    direction, a denom <= 0 freezes the step), and the conjugation term
    is the measured (p, s) pair, not the recursive gamma/alpha proxy.
    ``replace_every`` (tpucg's serial solve passes ``PIPE_REPLACE_EVERY``
    when preconditioned) recomputes r, u, w, s, q, z from their definitions
    after every lap whose k is a multiple of it or reaches ``maxiter``, as
    tpucg's segmented loop does; the refresh is guarded by ``done`` only
    and is a function of x and p, so it changes nothing on frozen state.
    Convergence is tested at the top of the next lap; ``k`` counts x
    updates, so lap counts match the classic loop's.

    Each lap is one masked step of ``run_chunks``: a lap enqueued after the
    stop (or past ``maxiter``) keeps every field.
    """
    def mv(v):
        return matvec(v, None)

    pc = None if precond is None else (lambda v: precond(v, None))
    r0 = b - mv(x0)
    dev = r0.device
    tol2 = torch.tensor(tol, dtype=r0.dtype, device=dev) ** 2
    u0 = None if pc is None else pc(r0)
    w0 = mv(r0 if pc is None else u0)
    zeros = torch.zeros_like(r0)
    one = torch.ones((), dtype=r0.dtype, device=dev)
    st = _PipeState(
        k=torch.zeros((), dtype=torch.int32, device=dev), x=x0, r=r0, w=w0, p=zeros,
        s=zeros, z=zeros, gamma=one, alpha=one, rslast=one,
        done=torch.zeros((), dtype=torch.bool, device=dev),
        u=u0, q=None if pc is None else zeros,
    )

    def lap(st: _PipeState, ran: torch.Tensor) -> _PipeState:
        # tpucg's body under its while_loop's condition `ran`: the fields
        # move where the lap ran and did not stop (its `done` is tested at
        # the lap's top), rslast and done where it ran.
        if pc is None:
            gamma, delta, ps = dots([(st.r, st.r), (st.w, st.r), (st.p, st.s)])
            rr = gamma
        else:
            gamma, delta, rr, ps = dots([(st.r, st.u), (st.w, st.u), (st.r, st.r),
                                         (st.p, st.s)])
        done = rr < tol2
        m = st.w if pc is None else pc(st.w)
        nv = mv(m)
        restart = (st.k == 0) | (gamma <= 0)
        beta = torch.where(restart, torch.zeros_like(gamma), gamma / st.gamma)
        denom = delta - beta * beta * ps
        if safe_alpha:
            alpha = torch.where(denom > 0, gamma / denom, torch.zeros_like(gamma))
        else:
            alpha = gamma / denom
        ubase = st.r if pc is None else st.u
        p = ubase + beta * st.p
        s = st.w + beta * st.s
        z = nv + beta * st.z
        x = st.x + alpha * p
        r = st.r - alpha * s
        w = st.w - alpha * z
        q = None if pc is None else m + beta * st.q
        u = None if pc is None else st.u - alpha * q
        step = ran & ~done
        return _PipeState(
            k=torch.where(step, st.k + 1, st.k),
            x=_keep(step, x, st.x), r=_keep(step, r, st.r), w=_keep(step, w, st.w),
            p=_keep(step, p, st.p), s=_keep(step, s, st.s), z=_keep(step, z, st.z),
            gamma=_keep(step, gamma, st.gamma), alpha=_keep(step, alpha, st.alpha),
            rslast=_keep(ran, rr, st.rslast), done=_keep(ran, done, st.done),
            u=_keep(step, u, st.u), q=_keep(step, q, st.q),
        )

    def refresh(s2: _PipeState, on: torch.Tensor) -> _PipeState:
        r_ = b - mv(s2.x)
        u_ = None if pc is None else pc(r_)
        w_ = mv(r_ if pc is None else u_)
        s_ = mv(s2.p)
        q_ = None if pc is None else pc(s_)
        z_ = mv(s_ if pc is None else q_)
        return s2._replace(r=_keep(on, r_, s2.r), w=_keep(on, w_, s2.w),
                           s=_keep(on, s_, s2.s), z=_keep(on, z_, s2.z),
                           u=_keep(on, u_, s2.u), q=_keep(on, q_, s2.q))

    laps = 0  # laps enqueued: a lap that runs leaves k = laps (or stops the loop)

    def step():
        nonlocal st, laps
        laps += 1
        ran = (st.k < maxiter) & ~st.done
        st = lap(st, ran)
        if replace_every and laps <= maxiter and (laps % replace_every == 0
                                                   or laps == maxiter):
            # tpucg's segment end: k a multiple of replace_every, or the cap.
            st = refresh(st, ran & ~st.done)
    run_chunks(step, lambda: bool((st.k < maxiter) & ~st.done), chunk)
    return st


# CA-CG's least basis half-width, relative to lam_hi (see ``ca_cg_loop``).
CA_WIDTH_FLOOR = 1e-5


def gram_f32(V: torch.Tensor) -> torch.Tensor:
    """CA-CG's Gram product V^T V of an (n, 2s+1) basis, summed in float64
    and rounded to f32: the f32 Gram of the exact sums (tpucg asks XLA for
    its highest f32 precision). A block's Gram can be singular (the first
    block's towers start from p = r), and there the coordinate laps follow
    its rounding: summed in f32 in MKL's or cuBLAS's order, a padded dense
    solve (n = 1000) diverged where XLA's order converged."""
    return (V.T.to(torch.float64) @ V.to(torch.float64)).to(V.dtype)


def ca_cg_loop(
    matvec: Callable,
    dot: Callable,
    gram: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    s: int,
    tol: float,
    maxiter: int,
    safe_alpha: bool = True,
    power_iters: int = 12,
    interval=None,
    chunk: Optional[int] = None,
) -> _State:
    """Communication-avoiding (s-step) CG on a Chebyshev basis (tpucg's
    ``ca_cg_loop``; Chronopoulos & Gear 1989, Hoemmen 2010). A block builds
    the basis V = [T_0(t(A)) p, ..., T_s p, T_0 r, ..., T_{s-1} r] ((n,
    2s+1), 2s - 1 matvecs) with t(A) = (A - c I)/h on the estimated
    interval padded 5%, takes G = V^T V in one product (``gram``), runs s
    CG laps in (2s+1)-coordinate space through the change of basis B = h S1
    + (h/2) S2 + c D, and rebuilds x, r, p from V. The Gram forms carry an
    f32 floor far above tol^2, so a stop inside the block is tentative:
    an exact ``dot(r, r)`` at the block's end confirms it or refutes it
    (then p restarts at r). ``rslast`` is that exact r.r.

    ``interval=(lam_lo, lam_hi)`` skips the 2 x ``power_iters`` power
    iterations of ``spectral_interval_estimate``; it moves only the
    basis's conditioning, never the result's correctness. Each block is one
    masked step of ``run_chunks``; inside it a lap runs while no stop is
    tentative and k < ``maxiter``.
    """
    if s < 1:
        raise ValueError("ca s-step count must be >= 1")
    m = 2 * s + 1  # p tower degrees 0..s, r tower degrees 0..s-1
    f32, dev = b.dtype, b.device

    def mv(v):
        return matvec(v, None)

    # The change of basis: per tower, A v_0 = h v_1 + c v_0 and A v_i =
    # (h/2) v_{i+1} + c v_i + (h/2) v_{i-1}; each tower's top column is never
    # multiplied by B, so those columns stay zero.
    S1 = np.zeros((m, m), np.float32)
    S2 = np.zeros((m, m), np.float32)
    D = np.zeros((m, m), np.float32)
    for base, depth in ((0, s + 1), (s + 1, s)):  # p tower, r tower
        if depth >= 2:
            S1[base + 1, base] = 1.0
            D[base, base] = 1.0
        for i in range(1, depth - 1):
            S2[base + i + 1, base + i] = 1.0
            S2[base + i - 1, base + i] = 1.0
            D[base + i, base + i] = 1.0
    S1, S2, D = (torch.from_numpy(a).to(dev, f32) for a in (S1, S2, D))
    if interval is None:
        lam_lo, lam_hi = spectral_interval_estimate(matvec, dot, b, power_iters)
    else:
        lam_lo = torch.as_tensor(interval[0], dtype=f32, device=dev)
        lam_hi = torch.as_tensor(interval[1], dtype=f32, device=dev)
    # 5% pad for the power method's under/over-shoot. The width floor keeps
    # a near-scalar A = c I finite: there the f32 Rayleigh quotient puts c a
    # few ulps off the one eigenvalue, and (A - c I) v / h must stay O(v).
    # tpucg's floor, 1e-20 lam_hi, amplifies that rounding 1e20-fold a
    # column (NaN by the third); 1e-5 lam_hi acts only on an interval
    # narrower than 2e-5 lam_hi and leaves every other basis as tpucg's.
    pad = 0.05 * (lam_hi - lam_lo)
    aa = torch.clamp(lam_lo - pad, min=0.0)
    bb = lam_hi + pad
    c = 0.5 * (aa + bb)
    h = torch.maximum(0.5 * (bb - aa), CA_WIDTH_FLOOR * lam_hi)
    inv_h = 1.0 / h
    B = h * S1 + (0.5 * h) * S2 + c * D

    r0 = b - mv(x0)
    tol2 = torch.tensor(tol, dtype=f32, device=dev) ** 2
    rr0 = dot(r0, r0, None)
    st = _State(k=torch.zeros((), dtype=torch.int32, device=dev), x=x0, r=r0, p=r0,
                rsold=rr0, rslast=rr0, done=rr0 < tol2)
    e = torch.eye(m, dtype=f32, device=dev)
    ep, er = e[0], e[s + 1]

    def tower(v0, depth):
        # The Chebyshev three-term column build: depth - 1 matvecs, no dot.
        cols = [v0]
        if depth >= 2:
            cols.append((mv(v0) - c * v0) * inv_h)
        for _ in range(2, depth):
            v = cols[-1]
            cols.append(2.0 * ((mv(v) - c * v) * inv_h) - cols[-2])
        return cols

    def body(st: _State) -> _State:
        V = torch.stack(tower(st.p, s + 1) + tower(st.r, s), dim=1)  # (n, 2s+1)
        G = gram(V)
        rsold, k = st.rsold, st.k
        tentative = torch.zeros((), dtype=torch.bool, device=dev)
        p_hat, r_hat, x_hat = ep, er, torch.zeros(m, dtype=f32, device=dev)
        for _ in range(s):
            active = ~tentative & (k < maxiter)
            Bp = B @ p_hat
            pap = p_hat @ (G @ Bp)
            if safe_alpha:
                alpha = torch.where(pap != 0, rsold / pap, torch.zeros_like(pap))
            else:
                alpha = rsold / pap
            x_new = x_hat + alpha * p_hat
            r_new = r_hat - alpha * Bp
            # The Gram form of a near-converged residual can round below 0.
            rr = torch.clamp(r_new @ (G @ r_new), min=0.0)
            conv = rr < tol2
            x_hat = torch.where(active, x_new, x_hat)
            r_hat = torch.where(active, r_new, r_hat)
            k = k + active.to(torch.int32)
            upd = active & ~conv  # a (tentative) stop leaves p and rsold
            p_hat = torch.where(upd, r_new + (rr / rsold) * p_hat, p_hat)
            rsold = torch.where(upd, rr, rsold)
            tentative = tentative | (active & conv)
        x = st.x + V @ x_hat
        r = V @ r_hat
        p = V @ p_hat
        rr_true = dot(r, r, None)  # the block's exact check
        done = rr_true < tol2
        p = torch.where(tentative & ~done, r, p)  # refuted: restart at p = r
        rsold = torch.where(done, rsold, rr_true)
        return _State(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rr_true, done=done)

    def step():
        nonlocal st
        ran = (st.k < maxiter) & ~st.done
        st = _State(*(_keep(ran, a, o) for a, o in zip(body(st), st)))
    run_chunks(step, lambda: bool((st.k < maxiter) & ~st.done), chunk, laps_per_step=s)
    return st


def chebyshev_loop(
    matvec: Callable,
    dot: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    check_every: int = 8,
    power_iters: int = 16,
    precond: Optional[Callable] = None,
    interval=None,
    chunk: Optional[int] = None,
) -> _State:
    """Chebyshev iteration (Saad, alg. 12.1; tpucg's ``chebyshev_loop``): no
    dot inside a lap, every scalar from a recurrence on the spectral
    interval [a, bnd]; two dots and a true residual every ``check_every``
    laps, so lap counts round up to a multiple of it.

    The interval (``spectral_interval_estimate`` on M^-1 A, or
    ``interval=``) is padded asymmetrically: bnd up 10%, a down 25% (the
    reflected power method overestimates lambda_min). A chunk's recurrence
    stop is confirmed by the true residual, or accepted when the true
    residual has stopped improving since the last refute (the f32 floor);
    a refuted stop or a stalled chunk re-anchors r to b - A x and restarts
    the direction, and a chunk that grew r.r 1.5x also widens the interval
    (a halves, bnd grows 25%). Inside a chunk a lap runs while k <
    ``maxiter``. Each chunk is one masked step of ``run_chunks``. The
    result's ``rslast`` (and ``rsold``) is the loop's carried r.r, its
    ``p`` the direction d.
    """
    f32, dev = b.dtype, b.device

    def mv(v):
        return matvec(v, None)

    pc = None if precond is None else (lambda v: precond(v, None))
    pmv = matvec if pc is None else (lambda v, act=None: pc(mv(v)))
    tol2 = torch.tensor(tol, dtype=f32, device=dev) ** 2
    if interval is None:
        lam_lo, lam_hi = spectral_interval_estimate(pmv, dot, b, power_iters)
    else:
        lam_lo = torch.as_tensor(interval[0], dtype=f32, device=dev)
        lam_hi = torch.as_tensor(interval[1], dtype=f32, device=dev)
    bnd0 = 1.10 * lam_hi
    a0 = torch.maximum(0.75 * lam_lo, 1e-8 * lam_hi)

    def scalars(a, bnd):
        theta = 0.5 * (bnd + a)
        # The width floor keeps A = c I (delta = 0) finite.
        delta = torch.maximum(0.5 * (bnd - a), 1e-20 * bnd)
        return theta, delta, theta / delta

    r0 = b - mv(x0)
    rr0 = dot(r0, r0, None)
    theta0, _, sigma0 = scalars(a0, bnd0)
    z0 = r0 if pc is None else pc(r0)
    st = (torch.zeros((), dtype=torch.int32, device=dev), rr0 < tol2, x0, r0, z0 / theta0,
          1.0 / sigma0, a0, bnd0, rr0, torch.full((), float("inf"), dtype=f32, device=dev))

    def body(s):
        k, done, x, r, d, rho, a, bnd, rr_prev, refute_rr = s
        theta, delta, sigma1 = scalars(a, bnd)
        for _ in range(check_every):
            active = k < maxiter
            xn = x + d
            rn = r - mv(d)
            zn = rn if pc is None else pc(rn)
            rho_n = 1.0 / (2.0 * sigma1 - rho)
            dn = rho_n * rho * d + (2.0 * rho_n / delta) * zn
            x = torch.where(active, xn, x)
            r = torch.where(active, rn, r)
            d = torch.where(active, dn, d)
            rho = torch.where(active, rho_n, rho)
            k = k + active.to(torch.int32)
        # The stop is tested on the recurrence residual (classic CG's
        # contract quantity) and confirmed against the true one.
        rr = dot(r, r, None)
        r_true = b - mv(x)
        rr_true = dot(r_true, r_true, None)
        tentative = rr < tol2
        confirmed = tentative & (rr_true < tol2)
        floor_hit = tentative & (rr_true >= 0.81 * refute_rr)  # (0.9)^2 on squared norms
        done = confirmed | floor_hit
        refuted = tentative & ~done
        stall = ~tentative & (rr >= rr_prev)
        div = ~tentative & (rr > 1.5 * rr_prev)
        a = torch.where(div, 0.5 * a, a)
        bnd = torch.where(div, 1.25 * bnd, bnd)
        reanchor = stall | refuted
        r = torch.where(reanchor, r_true, r)
        theta_r, _, sigma_r = scalars(a, bnd)
        z = r if pc is None else pc(r)
        d = torch.where(reanchor, z / theta_r, d)
        rho = torch.where(reanchor, 1.0 / sigma_r, rho)
        rr_prev = torch.where(reanchor, rr_true, rr)
        refute_rr = torch.where(refuted, rr_true, refute_rr)
        return (k, done, x, r, d, rho, a, bnd, rr_prev, refute_rr)

    def step():
        nonlocal st
        ran = (st[0] < maxiter) & ~st[1]
        st = tuple(torch.where(ran, a, o) for a, o in zip(body(st), st))
    run_chunks(step, lambda: bool((st[0] < maxiter) & ~st[1]), chunk,
               laps_per_step=check_every)
    k, done, x, r, d, _, _, _, rr, _ = st
    return _State(k=k, x=x, r=r, p=d, rsold=rr, rslast=rr, done=done)


def run_method(config: CGConfig, matvec: Callable, dot: Callable, dots: Callable,
               gram: Callable, b: torch.Tensor, x0: torch.Tensor, *, maxiter: int,
               precond: Optional[Callable] = None, interval=None,
               chunk: Optional[int] = None):
    """The loop of ``config.method`` ``"pipelined"``, ``"ca"`` or
    ``"chebyshev"`` -> (x, k, ||r||, converged), tpucg's result tuple
    (``_run_pipelined``, ``_run_ca``, ``_run_chebyshev``), for the serial
    solve and the sharded ones alike: ``matvec(v, act)``, ``dot(u, v, act)``,
    ``dots(pairs)`` (every dot of a pipelined lap at once) and ``gram(V)``
    (CA's V^T V) are the caller's, summed over the ranks on a mesh.

    - pipelined: replaces its residuals every ``PIPE_REPLACE_EVERY`` laps
      when preconditioned; convergence is tested a lap late, so a solve cut
      by maxiter reports its final r.r, recomputed;
    - ca: ``rslast`` is the exact (verified) block-end r.r;
    - chebyshev: the loop's carried r.r."""
    tol, safe_alpha = float(config.tol), bool(config.safe_alpha)
    if config.method == "pipelined":
        s = pipelined_cg_loop(
            matvec, dots, b, x0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
            precond=precond, replace_every=None if precond is None else PIPE_REPLACE_EVERY,
            chunk=chunk)
        rr = torch.where(s.done, s.rslast, dot(s.r, s.r, None))
        tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2
        return s.x, s.k, rr.sqrt(), s.done | (rr < tol2)
    if config.method == "ca":
        s = ca_cg_loop(matvec, dot, gram, b, x0, s=int(config.s_step), tol=tol,
                       maxiter=maxiter, safe_alpha=safe_alpha, interval=interval, chunk=chunk)
        return s.x, s.k, s.rslast.sqrt(), s.done
    if config.method == "chebyshev":
        s = chebyshev_loop(matvec, dot, b, x0, tol=tol, maxiter=maxiter,
                           check_every=int(config.check_every), precond=precond,
                           interval=interval, chunk=chunk)
        return s.x, s.k, s.rslast.sqrt(), s.done
    raise ValueError(f"run_method runs pipelined, ca and chebyshev, got {config.method!r}")


def _keep_if(ran: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """``new`` where the 0-d flag ``ran`` is set, else ``old``, field by
    field: a masked step of a loop whose state is a tuple."""
    return tuple(torch.where(ran, a, o) for a, o in zip(new, old))


class _MultiState(NamedTuple):
    """``multi_cg_loop``'s state, with tpucg's field names: ``k`` the laps
    run (the loop's bound), ``its`` each column's laps, every other scalar
    a (k,) tensor."""

    k: torch.Tensor
    its: torch.Tensor
    X: torch.Tensor
    R: torch.Tensor
    P: torch.Tensor
    rsold: torch.Tensor
    rslast: torch.Tensor
    done: torch.Tensor


def _dot_cols(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Columnwise dots of two (npad, k) blocks -> (k,), in f32 (tpucg's
    HIGHEST-precision einsum)."""
    return (U * V).sum(0)


def multi_cg_loop(
    mvm: Callable,
    B: torch.Tensor,
    X0: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    safe_alpha: bool = True,
    precond: Optional[Callable] = None,
    chunk: Optional[int] = None,
    dot_cols: Callable = _dot_cols,
) -> _MultiState:
    """k independent CG (or PCG) recurrences in lockstep, one batched matvec
    ``mvm(X, act)`` (the operator's ``matvec_multi``) a lap (tpucg's
    ``multi_cg_loop``). Each column's iterates are ``cg_loop``'s: the same
    update order and the stop on r.r after the x/r update; a column that
    has stopped takes alpha = 0 and keeps p and rsold. ``precond(R, act)``
    maps a block to M^-1 times it. Each lap is one masked step of
    ``run_chunks``, running while k < ``maxiter`` and a column is not done:
    a step enqueued after that changes nothing, and its matvec gets the
    flag (0) so a kernel returns at once. ``its`` counts each column's laps,
    as tpucg's vmapped lanes count theirs. ``dot_cols(U, V)`` gives the
    columnwise dots (k,) (a sharded solve passes its rank-summed form)."""
    dev = B.device
    R0 = B - mvm(X0, None)
    tol2 = torch.tensor(tol, dtype=R0.dtype, device=dev) ** 2
    rr0 = dot_cols(R0, R0)
    if precond is None:
        P0, rs0 = R0, rr0
    else:
        P0 = precond(R0, None)
        rs0 = dot_cols(R0, P0)
    st = _MultiState(k=torch.zeros((), dtype=torch.int32, device=dev),
                     its=torch.zeros(B.shape[1], dtype=torch.int32, device=dev),
                     X=X0, R=R0, P=P0, rsold=rs0, rslast=rr0, done=rr0 < tol2)

    def running(s: _MultiState) -> torch.Tensor:
        return (s.k < maxiter) & ~s.done.all()

    def step():
        nonlocal st
        s = st
        ran = running(s)
        act = ran.to(torch.int32)
        AP = mvm(s.P, act)
        pap = dot_cols(s.P, AP)
        alpha = alpha_torch(pap, s.rsold, safe_alpha)
        alpha = torch.where(s.done, 0.0, alpha)
        X = s.X + alpha * s.P
        R = s.R - alpha * AP
        rr = torch.where(s.done, s.rslast, dot_cols(R, R))
        done = s.done | (rr < tol2)
        if precond is None:
            Z, rs_new = R, rr
        else:
            Z = precond(R, act)
            rs_new = dot_cols(R, Z)
        P = torch.where(done, s.P, Z + (rs_new / s.rsold) * s.P)
        rsold = torch.where(done, s.rsold, rs_new)
        its = s.its + (~s.done).to(torch.int32)
        st = _MultiState(*_keep_if(ran, (s.k + 1, its, X, R, P, rsold, rr, done), s))
    run_chunks(step, lambda: bool(running(st)), chunk)
    return st


# The k x k algebra of block CG runs O(k^2) small torch ops a lap; keep
# block widths where that stays cheap (cg_solve_multi serves wide batches).
BLOCK_CG_MAX_K = 32


def _chol_lower(G: torch.Tensor, k: int) -> torch.Tensor:
    """Cholesky factor of the k x k ``G``, by hand in f32 torch ops (tpucg's
    ``_chol_lower``): the diagonal is floored at 1e-30 before its sqrt, so a
    ridged Gram that rounding has pushed to 0 or below never gives NaN (a
    library Cholesky has no such floor)."""
    L = torch.zeros_like(G)
    for j in range(k):
        s = G[j, j]
        if j:
            s = s - L[j, :j] @ L[j, :j]
        ljj = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j, j] = ljj
        if j + 1 < k:
            col = G[j + 1:, j]
            if j:
                col = col - L[j + 1:, :j] @ L[j, :j]
            L[j + 1:, j] = col / ljj
    return L


def _tri_solve_lower(L: torch.Tensor, M: torch.Tensor, k: int) -> torch.Tensor:
    """Z with L Z = M (L (k, k) lower triangular, M (k, m)) by forward
    substitution, a row at a time (tpucg's ``_tri_solve_lower``)."""
    rows = []
    for i in range(k):
        acc = M[i]
        if i:
            acc = acc - L[i, :i] @ torch.stack(rows)
        rows.append(acc / L[i, i])
    return torch.stack(rows)


def _spd_inv(T: torch.Tensor, eyek: torch.Tensor, k: int) -> torch.Tensor:
    """T^-1 = L^-T L^-1 of a ridged k x k SPD ``T`` through ``_chol_lower``."""
    L = _chol_lower(T, k)
    Linv = _tri_solve_lower(L, eyek, k)
    return Linv.T @ Linv


def _col_scale(G: torch.Tensor) -> torch.Tensor:
    """The column norms of a Gram's diagonal, floored at 1e-15 of the largest
    and at 1e-18: a ~zero column (a converged residual, a zero rhs) keeps a
    scale whose square survives f32 (a 1e-30 relative floor squared
    underflowed outer(d, d) to 0, and 0/0 poisoned the block with NaN)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(G), min=0.0))
    return torch.maximum(d, torch.clamp(1e-15 * d.max(), min=1e-18))


def _cholqr(gram: Callable, Y: torch.Tensor, eyek: torch.Tensor, ridge: float):
    """Column-equilibrated Cholesky QR of the (n, k) block ``Y`` through one
    ``gram``: Y = Q R with Q orthonormal (tpucg's ``_cholqr``). The columns
    are scaled to unit norm before the Cholesky, so the f32 Gram factors
    when their norms span orders of magnitude; the floors of ``_col_scale``
    keep a ~zero column finite, with a ~zero entry of R."""
    k = eyek.shape[0]
    G = gram(Y, Y)
    G = 0.5 * (G + G.T)
    d = _col_scale(G)
    Gn = G / torch.outer(d, d) + ridge * eyek
    L = _chol_lower(Gn, k)
    Qt = _tri_solve_lower(L, (Y / d[None, :]).T, k)
    return Qt.T, L.T * d[None, :]


def _cholqr2(gram: Callable, Y: torch.Tensor, eyek: torch.Tensor, ridge: float = 1e-6):
    """CholeskyQR2: a second pass restores Q's orthonormality to O(eps)
    after the ridged first (tpucg's ``_cholqr2``)."""
    Q1, R1 = _cholqr(gram, Y, eyek, ridge)
    Q2, R2 = _cholqr(gram, Q1, eyek, ridge)
    return Q2, R2 @ R1


def _cholqr_pc(gram: Callable, pc: Callable, Y: torch.Tensor, Z: torch.Tensor,
               eyek: torch.Tensor, ridge: float):
    """M^-1-inner-product Cholesky QR of the residual-side block ``Y``, Z =
    M^-1 Y given (tpucg's ``_cholqr_pc``): (U, V, R) with Y = V R, V^T M^-1
    V = I, and U = M^-1 V from a fresh ``pc`` (a transformed Z drifts from
    M^-1 V on a near-rank-deficient block until the pair Gram stops being
    PSD). The Gram Z^T Y is a sum of signed products, so on top of
    ``_col_scale``'s floors its normalized form is clipped to [-1, 1] and
    its diagonal pinned at 1 + ridge."""
    k = eyek.shape[0]
    G = gram(Z, Y)
    G = 0.5 * (G + G.T)
    d = _col_scale(G)
    Gn = torch.clamp(G / torch.outer(d, d), -1.0, 1.0)
    Gn = Gn - torch.diag(torch.diagonal(Gn)) + (1.0 + ridge) * eyek
    L = _chol_lower(Gn, k)
    V = _tri_solve_lower(L, (Y / d[None, :]).T, k).T
    return pc(V), V, L.T * d[None, :]


def _cholqr2_pc(gram: Callable, pc: Callable, Y: torch.Tensor, Z: torch.Tensor,
                eyek: torch.Tensor, ridge: float = 1e-6):
    """Two passes of ``_cholqr_pc``; the second reuses the first's fresh U
    as its Z (tpucg's ``_cholqr2_pc``)."""
    U1, V1, R1 = _cholqr_pc(gram, pc, Y, Z, eyek, ridge)
    U2, V2, R2 = _cholqr_pc(gram, pc, V1, U1, eyek, ridge)
    return U2, V2, R2 @ R1


def _block_alpha(gram: Callable, S: torch.Tensor, AS: torch.Tensor, eyek: torch.Tensor,
                 ridge: float) -> torch.Tensor:
    """The lap's (S^T A S + delta I)^-1, delta = ridge * trace / k + 1e-30."""
    krhs = eyek.shape[0]
    T = gram(S, AS)
    T = 0.5 * (T + T.T)
    delta = ridge * (torch.trace(T) / krhs) + 1e-30
    return _spd_inv(T + delta * eyek, eyek, krhs)


def _block_boundaries(inner_step: Callable, inner_running: Callable, boundary: Callable,
                      maxiter: int, chunk: Optional[int]) -> None:
    """The two loops of block CG: inner laps through ``run_chunks`` (one host
    read a chunk) until the recurrence's stop or ``maxiter``, then the
    confirm/refute ``boundary``, whose ``done`` the host reads once; again
    until done. With ``maxiter`` <= 0 nothing runs."""
    if maxiter <= 0:
        return
    while True:
        run_chunks(inner_step, lambda: bool(inner_running()), chunk)
        if bool(boundary()):
            return


def block_cg_loop(
    mv: Callable,
    gram: Callable,
    B: torch.Tensor,
    X0: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    ridge: float = 1e-6,
    chunk: Optional[int] = None,
):
    """True block CG in the stable BCGrQ form (Dubrulle 2001; tpucg's
    ``block_cg_loop``): the k columns search one block-Krylov space, with the
    residual block kept orthonormal (Q, by ``_cholqr2`` each lap) and its
    magnitudes in the k x k factor C, so a column's recurrence norm is C's
    column norm. A lap is one ``mv(S, act)`` and three Grams.

    The stop is tentative: when every column's C-norm is under tol (or at
    ``maxiter``) the loop computes the true residual B - A X and confirms
    (every column under tol), accepts at the f32 floor (the worst column
    not 10% better than at the last refute) or refutes, re-anchoring Q, C
    and S on the true residual. Returns (laps, X, the last true per-column
    r.r, converged per column)."""
    dev, krhs = B.device, B.shape[1]
    tol2 = torch.tensor(tol, dtype=B.dtype, device=dev) ** 2
    eyek = torch.eye(krhs, dtype=B.dtype, device=dev)
    Q0, C0 = _cholqr2(gram, B - mv(X0, None), eyek, ridge)
    inf = torch.tensor(float("inf"), dtype=B.dtype, device=dev)
    st = [torch.zeros((), dtype=torch.int32, device=dev), X0, Q0, C0, Q0]  # k, X, Q, C, S
    refute_rr, rr = inf, torch.full((krhs,), float("inf"), dtype=B.dtype, device=dev)

    def inner_running():
        k, _, _, C, _ = st
        return (k < maxiter) & ~((C * C).sum(0) < tol2).all()

    def inner_step():
        k, X, Q, C, S = st
        ran = inner_running()
        AS = mv(S, ran.to(torch.int32))
        alpha = _block_alpha(gram, S, AS, eyek, ridge)
        Xn = X + S @ (alpha @ C)
        Qn, rho = _cholqr2(gram, Q - AS @ alpha, eyek, ridge)
        st[:] = _keep_if(ran, (k + 1, Xn, Qn, rho @ C, Qn + S @ rho.T), st)

    def boundary():
        nonlocal refute_rr, rr
        k, X, Q, C, S = st
        Rt = B - mv(X, None)
        rr = torch.diagonal(gram(Rt, Rt))
        worst = rr.max()
        done = (rr < tol2).all() | (worst >= 0.81 * refute_rr) | (k >= maxiter)  # 0.9^2
        Qr, Cr = _cholqr2(gram, Rt, eyek, ridge)
        again = ~done
        st[2:] = _keep_if(again, (Qr, Cr, Qr), (Q, C, S))
        refute_rr = torch.where(again, worst, refute_rr)
        return done

    _block_boundaries(inner_step, inner_running, boundary, maxiter, chunk)
    return st[0], st[1], rr, rr < tol2


def block_pcg_loop(
    mv: Callable,
    gram: Callable,
    pc: Callable,
    B: torch.Tensor,
    X0: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    ridge: float = 1e-6,
    chunk: Optional[int] = None,
):
    """Preconditioned true block CG (tpucg's ``block_pcg_loop``):
    ``block_cg_loop``'s recurrence on M^-1/2 A M^-1/2 carried in the
    original variables, with V (the residual side, M^-1-orthonormal) and
    every M^-1-side block from a fresh ``pc(Y)`` (``_cholqr2_pc``). A
    lap is one ``mv`` and three applications of ``pc``. Its stops,
    ``residual_norm`` and ``converged`` are on the M^-1/2-weighted residual:
    the boundary's rr = diag((M^-1 R)^T R) of the true R = B - A X, clipped
    at 0 (a sum of signed products). Same boundary rules as
    ``block_cg_loop``; same return."""
    dev, krhs = B.device, B.shape[1]
    tol2 = torch.tensor(tol, dtype=B.dtype, device=dev) ** 2
    eyek = torch.eye(krhs, dtype=B.dtype, device=dev)
    R0 = B - mv(X0, None)
    U0, V0, C0 = _cholqr2_pc(gram, pc, R0, pc(R0), eyek, ridge)
    inf = torch.tensor(float("inf"), dtype=B.dtype, device=dev)
    st = [torch.zeros((), dtype=torch.int32, device=dev), X0, V0, C0, U0]  # k, X, V, C, S
    refute_rr, rr = inf, torch.full((krhs,), float("inf"), dtype=B.dtype, device=dev)

    def inner_running():
        k, _, _, C, _ = st
        return (k < maxiter) & ~((C * C).sum(0) < tol2).all()

    def inner_step():
        k, X, V, C, S = st
        ran = inner_running()
        AS = mv(S, ran.to(torch.int32))
        alpha = _block_alpha(gram, S, AS, eyek, ridge)
        Xn = X + S @ (alpha @ C)
        MW = V - AS @ alpha
        Un, Vn, rho = _cholqr2_pc(gram, pc, MW, pc(MW), eyek, ridge)
        st[:] = _keep_if(ran, (k + 1, Xn, Vn, rho @ C, Un + S @ rho.T), st)

    def boundary():
        nonlocal refute_rr, rr
        k, X, V, C, S = st
        Rt = B - mv(X, None)
        Zt = pc(Rt)
        rr = torch.clamp(torch.diagonal(gram(Zt, Rt)), min=0.0)
        worst = rr.max()
        done = (rr < tol2).all() | (worst >= 0.81 * refute_rr) | (k >= maxiter)  # 0.9^2
        Ur, Vr, Cr = _cholqr2_pc(gram, pc, Rt, Zt, eyek, ridge)
        again = ~done
        st[2:] = _keep_if(again, (Vr, Cr, Ur), (V, C, S))
        refute_rr = torch.where(again, worst, refute_rr)
        return done

    _block_boundaries(inner_step, inner_running, boundary, maxiter, chunk)
    return st[0], st[1], rr, rr < tol2


def _check_two_level(two_level, config: CGConfig, dtype, npad: int, device) -> None:
    """tpucg's refusals of a ``two_level`` solve (``cg.py:2416-2440``): the
    cycle is the preconditioner of a method cg or pipelined solve, f32, built
    for the operator's padded size (and, here, on the solve's device)."""
    if config.method not in ("cg", "pipelined") or config.precondition != "none":
        raise ValueError("two_level runs as THE preconditioner of a method='cg' or 'pipelined' "
                         f"solve (got method={config.method!r}, "
                         f"precondition={config.precondition!r})")
    if dtype != torch.float32:
        raise ValueError("two_level preconditioning is float32-only")
    if two_level.npad != npad:
        raise ValueError(f"two_level was built for padded size {two_level.npad}, operator has "
                         f"{npad}: rebuild with build_two_level(csr, npad={npad})")
    if two_level.device != device:
        raise ValueError(f"two_level lives on {two_level.device}, the solve on {device}")


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

    The sparse size caps are the card's own. Where the port's route and
    tpucg's differ (each pinned by ``tests/test_torch_fused_sparse.py``):

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
    """Solve the SPD system A x = b (tpucg's ``cg_solve`` and the serial
    branches of its ``_cg_jit``).

    ``A`` is a dense array or tensor, a sparse container (a ``CSRMatrix``
    becomes an ``EllOperator`` as in tpucg; ``best_sparse_operator`` picks a
    format instead, and ``cg_solve_checkpointed`` promotes a bare CSR through
    it, as tpucg's does), or an operator (``DenseOperator``, ``DiaOperator``,
    ``PoissonOperator``, ``WellOperator``, ``BsrOperator``,
    ``EllOperator``). ``device`` defaults to the device of a tensor or
    operator ``A``, else the card (with no card it raises: a numpy ``A``
    runs on the CPU only where ``device='cpu'`` asks for it);
    ``kernel="auto"`` then runs the CUDA kernels on a CUDA device and the
    plain versions elsewhere. On the cuda backend a solve
    ``_fused_eligible`` admits runs as one launch of K4, K10 or K11; every
    other solve, and ``fused="never"``, takes the lap path (``cg_loop`` on
    the operator's matvec kernel, K2 and K3). ``precondition`` is
    ``"none"``, ``"jacobi"``, ``"block_jacobi"`` (blocks of
    ``pc_block_size``) or ``"poly"`` (degree ``poly_degree``).
    ``method`` ``"pipelined"``, ``"ca"`` (``s_step``) and ``"chebyshev"``
    (``check_every``) run ``pipelined_cg_loop``, ``ca_cg_loop`` and
    ``chebyshev_loop`` on the operator's matvec kernel and K3, each
    reporting ``iterations``, ``residual_norm`` and ``converged`` as
    tpucg's does. ``interval=(lam_lo, lam_hi)`` (ca and chebyshev only;
    e.g. from ``spectral_interval``; for preconditioned Chebyshev the
    bounds of M^-1 A) skips their power-method set-up.
    ``record_residuals`` (cg only) returns the per-lap ||r|| in
    ``residual_history``; ``chunk`` is ``run_chunks``'s.

    ``two_level`` (``build_two_level``, built for the operator's
    ``padded_n`` on the solve's device) is the preconditioner of a
    ``method="cg"`` or ``"pipelined"`` solve with ``precondition="none"``:
    classic CG then tests the true residual every ``TRUE_CHECK_EVERY`` laps
    (``cg_loop(check_true_every=)``, guarded finish; ``converged`` is the
    last check's r.r < tol^2, and a stagnation stop reports unconverged),
    pipelined replaces its residuals every ``PIPE_REPLACE_EVERY`` laps. A
    two-level solve never takes a whole-solve kernel.

    ``dtype=torch.float64`` solves in f64 (tpucg's one extra solve dtype):
    a dense A is stored in f64, b, x0 and every vector of the loop are
    f64, and the lap is ``TorchLap`` over plain f64 products, dots and
    updates on the solve's device (the card unless ``device`` says
    otherwise), as tpucg routes an f64 solve to XLA. No kernel of either
    package is f64, so ``kernel="cuda"`` with f64 raises (tpucg reroutes
    it to XLA silently). tpucg's x64-mode switch is a JAX rule; torch needs
    none.
    """
    config = _configure(config, overrides)
    f64 = config.dtype == torch.float64
    if f64 and config.kernel == "cuda":
        raise ValueError("kernel='cuda' with dtype=float64: no kernel of this package (or of "
                         "tpucg) is f64; an f64 solve runs plain torch ops on its device "
                         "(kernel='auto' or 'torch')")
    if record_residuals and config.method != "cg":
        raise ValueError("record_residuals requires method='cg'")
    if interval is not None and config.method not in ("ca", "chebyshev"):
        raise ValueError("interval=(lam_lo, lam_hi) applies to method='ca'/'chebyshev' "
                         f"(got method={config.method!r})")
    if device is None and isinstance(A, (LinearOperator, torch.Tensor)):
        device = A.device
    device = canonical_device(device)
    backend = resolve_backend(config.kernel, device)
    # An f64 dense A is stored f64 on the "torch" backend; a sparse one
    # keeps its kernel, whose matvec takes the plain product for f64.
    op = as_operator(A, backend="auto" if f64 else backend, dtype=config.dtype, device=device)
    if op.device != device:
        raise ValueError(f"operator lives on {op.device}, solve asked for {device}")
    if f64:
        backend = "torch"  # chosen by the dtype, as tpucg chooses: no kernel is f64
    else:
        _require_backend(op, backend)  # K4 too: one choice runs the whole solve
    dtype = config.dtype
    n, npad = op.n, op.padded_n
    b = torch.as_tensor(b, dtype=dtype, device=device)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
    x0 = (
        torch.zeros(n, dtype=dtype, device=device)
        if x0 is None
        else torch.as_tensor(x0, dtype=dtype, device=device)
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
        minv = torch.where(d != 0, 1.0 / d, 1.0).to(dtype)
    elif config.precondition == "block_jacobi":
        minv = block_jacobi_minv(op, int(config.pc_block_size)).to(dtype)
    tol = float(config.tol)
    poly = config.precondition == "poly"
    if two_level is not None:
        _check_two_level(two_level, config, dtype, npad, device)
    kind = (None if two_level is not None
            else _fused_eligible(config, op, backend, dtype, record_residuals))
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
    matvec, dot, lap = _torch_lap_ops(op) if f64 else lap_ops(op, backend)
    if two_level is not None:
        from tpucg_torch.solver.twolevel import make_two_level_precond

        precond = make_two_level_precond(two_level, matvec, dot, b)
    else:
        precond = make_precond(config.precondition, minv, matvec, dot, b, config.poly_degree)
    if config.method != "cg":
        x, k, rn, done = run_method(
            config, matvec, dot, lambda pairs: tuple(dot(u, v, None) for u, v in pairs),
            gram_f32, b, x0, maxiter=maxiter, precond=precond, interval=interval, chunk=chunk)
        return CGResult(x=x[:n], iterations=k, residual_norm=rn, converged=done)
    tol2 = torch.tensor(tol, dtype=dtype, device=device) ** 2
    s = cg_loop(
        matvec, dot, lap, b, x0,
        tol=tol, maxiter=maxiter, safe_alpha=bool(config.safe_alpha), precond=precond,
        hist_len=maxiter if record_residuals else None,
        chunk=chunk,
        check_true_every=TRUE_CHECK_EVERY if two_level is not None else None,
    )
    return CGResult(
        x=s.x[:n],
        iterations=s.k,
        residual_norm=s.rslast.sqrt(),
        converged=s.rslast < tol2,
        residual_history=s.hist,
    )


def spectral_interval(A, power_iters: int = 16, *, device=None):
    """Estimate an SPD operator's spectrum bounds: ``(lam_lo, lam_hi,
    kappa)`` as floats from ``spectral_interval_estimate`` over the
    operator's padded length (tpucg's ``spectral_interval``). The bounds
    are what CA-CG's basis and the Chebyshev iteration derive their
    scalars from; pass the first two as a solve's ``interval=`` to skip
    their set-up. Estimates: lam_hi is typically a little under, lam_lo a
    little over; an identity-padded operator's tail adds the eigenvalue 1,
    as in the solves' own estimates. ``device`` defaults as in
    ``cg_solve``; the estimate runs on its kernels."""
    if device is None and isinstance(A, (LinearOperator, torch.Tensor)):
        device = A.device
    device = canonical_device(device)
    op = as_operator(A, backend=resolve_backend("auto", device), device=device)
    matvec, dot, _ = lap_ops(op, op.backend)
    like = torch.zeros(op.padded_n, dtype=torch.float32, device=device)
    lam_lo, lam_hi = spectral_interval_estimate(matvec, dot, like, int(power_iters))
    lo, hi = float(lam_lo), float(lam_hi)
    return lo, hi, hi / max(lo, 1e-30)


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


def _block_operands(op: LinearOperator, B, X0, device):
    """B and X0 of a multi-RHS or block solve as f32 (npad, k) blocks on
    ``device``, the rows past n zero (the identity tail's exact solution)."""
    n, npad = op.n, op.padded_n
    B = torch.as_tensor(B, dtype=torch.float32, device=device)
    if B.dim() != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {tuple(B.shape)}")
    k = B.shape[1]
    X0 = (torch.zeros((n, k), dtype=torch.float32, device=device) if X0 is None
          else torch.as_tensor(X0, dtype=torch.float32, device=device))
    if X0.shape != (n, k):
        raise ValueError(f"X0 must have shape ({n}, {k}), got {tuple(X0.shape)}")
    pad = (0, 0, 0, npad - n)
    return F.pad(B, pad).contiguous(), F.pad(X0, pad).contiguous()


def _block_operator(A, config: CGConfig, device):
    """The operator and backend of a multi-RHS or block solve, resolved as
    ``cg_solve`` resolves them (one backend runs the whole solve)."""
    if device is None and isinstance(A, (LinearOperator, torch.Tensor)):
        device = A.device
    device = canonical_device(device)
    backend = resolve_backend(config.kernel, device)
    op = as_operator(A, backend=backend, device=device)
    if op.device != device:
        raise ValueError(f"operator lives on {op.device}, solve asked for {device}")
    _require_backend(op, backend)
    return op, backend, device


def _poly_weight(op: LinearOperator, backend: str, like: torch.Tensor) -> torch.Tensor:
    """0.95 / lambda_max of the poly preconditioner, from the power method on
    the operator's single-column matvec and dot (K1, K6, K8 or K13 and K3 on
    the card). The seed does not depend on the rhs, so every column of
    tpucg's vmapped solve gets this one value."""
    matvec, dot, _ = lap_ops(op, backend)
    return 0.95 / lambda_max_estimate(matvec, dot, like)


def _poly_block(mv: Callable, w: torch.Tensor, degree: int) -> Callable:
    """The truncated-Neumann M^-1 (``make_poly_precond``'s) on an (npad, k)
    block through the k-column matvec ``mv(X, act)``."""
    def pc(R, act=None):
        Z = w * R
        for _ in range(degree - 1):
            Z = Z + w * R - w * mv(Z, act)
        return Z
    return pc


def cg_solve_multi(
    A,
    B,
    X0=None,
    config: Optional[CGConfig] = None,
    *,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B for the k columns of B (n, k) at once: k independent CG
    recurrences in lockstep (tpucg's ``cg_solve_multi``), through
    ``multi_cg_loop`` on the operator's ``matvec_multi``: K6 x k, K8 x k or
    K13 x k on the card (the matrix read once for all k columns), a GEMM
    for a dense A. ``precondition`` none, jacobi and block_jacobi run in the
    matrix form; poly applies each column's Neumann polynomial through the
    same product, with tpucg's lambda_max (its seed does not depend on the
    column, so one estimate serves all). The solve is f32; ``device`` and
    ``chunk`` as in ``cg_solve``. Result fields are batched: ``x`` is (n,
    k); ``iterations``, ``residual_norm`` and ``converged`` are (k,), each
    column's."""
    config = _configure(config, overrides)
    if config.method != "cg":
        raise ValueError("cg_solve_multi supports method='cg' only")
    op, backend, device = _block_operator(A, config, device)
    n = op.n
    B, X0 = _block_operands(op, B, X0, device)
    minv = None
    if config.precondition == "jacobi":
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0)[:, None]
    elif config.precondition == "block_jacobi":
        minv = block_jacobi_minv(op, int(config.pc_block_size))
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    mv = op.matvec_multi
    precond = None
    if config.precondition == "jacobi":
        precond = lambda R, act=None: minv * R  # noqa: E731
    elif config.precondition == "block_jacobi":
        bapp = make_block_apply(minv, op.padded_n)
        precond = lambda R, act=None: bapp(R)  # noqa: E731
    elif config.precondition == "poly":
        precond = _poly_block(mv, _poly_weight(op, backend, B[:, 0]), int(config.poly_degree))
    s = multi_cg_loop(mv, B, X0, tol=float(config.tol), maxiter=maxiter,
                      safe_alpha=bool(config.safe_alpha), precond=precond, chunk=chunk)
    return CGResult(x=s.X[:n], iterations=s.its, residual_norm=s.rslast.sqrt(),
                    converged=s.done)


def cg_solve_block(
    A,
    B,
    X0=None,
    config: Optional[CGConfig] = None,
    *,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B with true block CG (tpucg's ``cg_solve_block``): the k
    columns of B (n, k), k <= ``BLOCK_CG_MAX_K``, share one block-Krylov
    space (``block_cg_loop``, BCGrQ), so related columns converge in fewer
    laps than ``cg_solve_multi``'s independent ones. A lap is one
    ``matvec_multi`` (K6 x k, K8 x k or K13 x k on the card, a GEMM for a
    dense A), three k x k Grams and the k x k algebra in torch ops.

    Preconditioners, by tpucg's routes: ``"jacobi"`` on a dense f32 A
    equilibrates A once (D^-1/2 A D^-1/2 materialised), on any other
    operator wraps its product in the two scalings; ``"block_jacobi"``
    wraps it in the blocks' M^-1/2 (``block_jacobi_sqrt_pair``);
    ``"poly"`` runs ``block_pcg_loop``. Their stops, ``residual_norm`` and
    ``converged`` are on the M^-1/2-weighted residual (||D^-1/2 (B - A
    X)|| per column under Jacobi). ``iterations`` is the shared lap count
    (0-d); ``residual_norm`` and ``converged`` are (k,), from the true
    residual at the last boundary (a column accepted at the f32 floor
    reports converged False). The solve is f32; ``device`` and ``chunk``
    as in ``cg_solve``."""
    config = _configure(config, overrides)
    if config.method != "cg" or config.precondition not in (
            "none", "jacobi", "block_jacobi", "poly"):
        raise ValueError("cg_solve_block supports method='cg' with precondition "
                         "'none', 'jacobi', 'block_jacobi', or 'poly'")
    op, backend, device = _block_operator(A, config, device)
    n, npad = op.n, op.padded_n
    scale = None
    if (config.precondition == "jacobi" and isinstance(op, DenseOperator)
            and op.A.dtype == torch.float32):
        # The exact symmetric equilibration, materialised once: Jacobi-PCG's
        # iterates at no cost a lap.
        d = op.diagonal()
        scale = torch.where(d > 0, torch.rsqrt(d), torch.ones_like(d))
        op = DenseOperator(A=scale[:, None] * op.A * scale[None, :], n=n, backend=op.backend)
    B, X0 = _block_operands(op, B, X0, device)
    k = B.shape[1]
    if k > BLOCK_CG_MAX_K:
        raise ValueError(
            f"block CG supports k <= {BLOCK_CG_MAX_K} right-hand sides (got {k}): its k x k "
            "algebra is O(k^2) small ops a lap; use cg_solve_multi for wide batches")
    if scale is not None:
        B = scale[:, None] * B
        X0 = X0 / scale[:, None]
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    tol = float(config.tol)
    mv = op.matvec_multi

    def gram(U, V):
        return U.T @ V
    loop = dict(tol=tol, maxiter=maxiter, chunk=chunk)
    unscale = None
    if config.precondition == "poly":
        pc = _poly_block(mv, _poly_weight(op, backend, B[:, 0]), int(config.poly_degree))
        k_, X, rr, done = block_pcg_loop(mv, gram, pc, B, X0, **loop)
    elif config.precondition == "block_jacobi":
        isq, sq = block_jacobi_sqrt_pair(op, int(config.pc_block_size))
        sapp, sqapp = make_block_apply(isq, npad), make_block_apply(sq, npad)
        k_, Y, rr, done = block_cg_loop(lambda Y, act=None: sapp(mv(sapp(Y), act)), gram,
                                        sapp(B), sqapp(X0), **loop)
        X = sapp(Y)
    elif config.precondition == "jacobi" and scale is None:
        d = op.diagonal()
        sc = torch.sqrt(torch.where(d > 0, 1.0 / d, torch.ones_like(d)))[:, None]
        k_, Y, rr, done = block_cg_loop(lambda Y, act=None: sc * mv(sc * Y, act), gram,
                                        sc * B, X0 / sc, **loop)
        X = sc * Y
    else:
        k_, X, rr, done = block_cg_loop(mv, gram, B, X0, **loop)
        unscale = scale
    if unscale is not None:
        X = unscale[:, None] * X
    return CGResult(x=X[:n], iterations=k_, residual_norm=rr.sqrt(), converged=done)
