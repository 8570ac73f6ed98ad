"""BLAS-1 kernels of the CG lap: the dot product (K3), the fused x/r update
that also returns r'.r' (K2) and p's update. ``csrc/blas.cu`` holds the
kernels and their design note; beside each is its plain PyTorch version.

Each of K2 and K3 is one launch, and finishes the lap's scalar work in the
block that sums last: K3 can also write alpha (``dot_alpha_torch``), and
the lap's last reduction runs its tail (``lap_tail_torch``), which sets
``beta`` and ``step`` for p's update (``p_update_torch``).

``guard=True`` selects the guarded finish of tpucg's true-residual solves
(``tpucg/solver/cg.py:380-412``): alpha is 0 unless p.Ap > 0, and a lap
whose rs_new is not > 0 steps with beta 0 and rsold ``FLT_MIN``. Legacy
solves keep the unguarded rule, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend


def dot_torch(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    dot_torch.launches += 1
    return torch.dot(u, v)


dot_torch.launches = 0


# rsold of a guarded lap whose rs_new is not > 0 (tpucg's
# np.finfo(np.float32).tiny, the kernels' FLT_MIN).
FLT_MIN = float(np.finfo(np.float32).tiny)


def alpha_torch(pap: torch.Tensor, rsold: torch.Tensor, safe_alpha: bool,
                guard: bool = False) -> torch.Tensor:
    """alpha = rsold / p.Ap; with ``safe_alpha``, 0 where p.Ap is 0, or
    with ``guard`` too, 0 unless p.Ap > 0 (NaN included)."""
    if not safe_alpha:
        return rsold / pap
    return torch.where(pap > 0 if guard else pap != 0, rsold / pap, 0.0)


def dot_alpha_torch(u, v, rsold, safe_alpha: bool = True, guard: bool = False):
    """Plain version of K3's alpha mode: (u.v, rsold / u.v)."""
    dot_alpha_torch.launches += 1
    pap = torch.dot(u, v)
    return pap, alpha_torch(pap, rsold, safe_alpha, guard)


dot_alpha_torch.launches = 0


def fused_update_torch(x, r, p, ap, alpha):
    """Plain version of K2: (x + alpha p, r - alpha ap, r'.r')."""
    fused_update_torch.launches += 1
    xn = x + alpha * p
    rn = r - alpha * ap
    return xn, rn, torch.dot(rn, rn)


fused_update_torch.launches = 0


class LapTail(NamedTuple):
    """The lap's scalars (0-d tensors) that its tail reads and writes: the
    laps run ``k`` (int32), ``rsold`` (r.z, r.r without a preconditioner),
    ``rslast`` (the last r.r), ``done``, ``active`` (bool here; the
    kernels' flag is int32), ``beta`` and ``step`` (p's update: bool here,
    int32 for the kernel) and ``hist`` (||r|| by lap, or None)."""

    k: torch.Tensor
    rsold: torch.Tensor
    rslast: torch.Tensor
    done: torch.Tensor
    active: torch.Tensor
    beta: Optional[torch.Tensor] = None
    step: Optional[torch.Tensor] = None
    hist: Optional[torch.Tensor] = None


def lap_tail_torch(t: LapTail, rr, rs_new, tol2, maxiter: int, guard: bool = False) -> LapTail:
    """Plain version of the tail that K2 (rs_new = r'.r') or K3 (rs_new =
    r'.z') runs: stop when r'.r' < tol^2; a running lap that does not stop
    steps (beta = rs_new / rsold, rsold = rs_new; with ``guard``, beta 0 and
    rsold ``FLT_MIN`` where rs_new is not > 0); rslast, hist[k + 1], done
    and k follow a running lap, and ``active`` is what is left."""
    lap_tail_torch.launches += 1
    stop = rr < tol2
    step = t.active & ~stop
    beta, rs_step = rs_new / t.rsold, rs_new
    if guard:
        healthy = rs_new > 0
        beta = torch.where(healthy, beta, 0.0)
        rs_step = torch.where(healthy, rs_new, FLT_MIN)
    hist = t.hist
    if hist is not None:
        pos = torch.arange(hist.numel(), device=hist.device)
        hist = torch.where(t.active & (pos == t.k + 1), rr.sqrt(), hist)
    done = t.done | (t.active & stop)
    k = t.k + t.active.to(torch.int32)
    return LapTail(
        k=k,
        rsold=torch.where(step, rs_step, t.rsold),
        rslast=torch.where(t.active, rr, t.rslast),
        done=done,
        active=~done & (k < maxiter),
        beta=beta,
        step=step,
        hist=hist,
    )


lap_tail_torch.launches = 0


def p_update_torch(z, p, beta, step):
    """Plain version of p's update: z + beta p where ``step``, else p."""
    p_update_torch.launches += 1
    return torch.where(step, z + beta * p, p)


p_update_torch.launches = 0


def _check_vectors(what: str, *vs: torch.Tensor) -> None:
    """The K2/K3 operands: non-empty contiguous f32 vectors of one length on
    one CUDA device."""
    n = vs[0].shape
    for v in vs:
        if v.dtype != torch.float32 or v.dim() != 1 or v.shape != n or v.numel() == 0:
            raise ValueError(
                f"{what} needs non-empty f32 vectors of one length, got "
                f"{v.dtype} {tuple(v.shape)} beside {tuple(n)}"
            )
        if not v.is_contiguous():
            raise ValueError(f"{what} needs contiguous vectors")
    dev = vs[0].device
    if dev.type != "cuda" or any(v.device != dev for v in vs):
        raise ValueError(f"{what} needs its vectors on one CUDA device, got {dev}")


def _check_scalars(what: str, like: torch.Tensor, *ss: torch.Tensor) -> None:
    for s in ss:
        if not (isinstance(s, torch.Tensor) and s.dtype == torch.float32 and s.dim() == 0
                and s.device == like.device):
            raise ValueError(f"{what} needs its scalars as 0-d f32 tensors on the vectors' device")


def scratch_for(like: torch.Tensor) -> torch.Tensor:
    """The scratch of a K2/K3 reduction over ``like``'s length (and of p's
    update): its partials, then the ticket, zeroed. Launches that share it
    run in stream order; each puts the ticket back to 0."""
    return torch.zeros(
        _lib.reduce_blocks(like.numel()) + 1, dtype=torch.float32, device=like.device
    )


class LapPointers(ctypes.Structure):
    """The device addresses of a lap's scalars, as ``csrc/blas.cuh``'s
    ``LapScalars`` lays them out; the tails' launches pass its address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "k", "rsold", "rslast", "done", "active", "beta", "step", "tol2", "rr", "hist")] + [
        ("hist_n", ctypes.c_longlong), ("maxiter", ctypes.c_longlong)]


class CudaLapTail:
    """A lap's scalars in device buffers, owned here and updated in place by
    K2's and K3's tails: ``k`` and ``active`` int32, ``rsold``, ``rslast``,
    ``beta`` and ``rr`` (the lap's r'.r', which K2 writes) f32, ``done``
    bool, ``step`` int32 (0 at rest). ``load`` copies a state in and points
    the block at the caller's ``tol2`` and ``hist``, which it keeps."""

    def __init__(self, device):
        def buf(dtype):
            return torch.zeros((), dtype=dtype, device=device)
        self.k, self.active, self.step = (buf(torch.int32) for _ in range(3))
        self.rsold, self.rslast, self.beta, self.rr = (buf(torch.float32) for _ in range(4))
        self.done = buf(torch.bool)
        self.tol2 = self.hist = None
        self.pointers = LapPointers(**{name: getattr(self, name).data_ptr() for name in (
            "k", "rsold", "rslast", "done", "active", "beta", "step", "rr")})

    def load(self, k, rsold, rslast, done, tol2, maxiter: int,
             hist: Optional[torch.Tensor] = None) -> None:
        self.k.copy_(k)
        self.rsold.copy_(rsold)
        self.rslast.copy_(rslast)
        self.done.copy_(done)
        self.active.copy_(~self.done & (self.k < maxiter))
        self.step.zero_()
        self.tol2, self.hist = tol2, hist
        ptrs = self.pointers
        ptrs.tol2 = tol2.data_ptr()
        ptrs.hist = None if hist is None else hist.data_ptr()
        ptrs.hist_n = 0 if hist is None else hist.numel()
        ptrs.maxiter = maxiter

    @property
    def address(self) -> int:
        return ctypes.addressof(self.pointers)


# The launch cores below do no checks: the caller has checked the operands as
# the wrappers do and owns outputs and scratch. ``active`` is the flag's
# device pointer or None, ``stream`` a CUDA stream handle, ``lap`` a
# ``CudaLapTail``'s address. They are the one place that counts each
# kernel's launches: every mode of K3 under ``dot_cuda``, of K2 under
# ``fused_update_cuda``.


def _launched(err: int, what: str, counted) -> None:
    if err:
        _lib.check(err, what)
    counted.launches += 1


def dot_launch(u, v, scratch, out, active: Optional[int], stream: int) -> None:
    """Launch K3: out = u . v."""
    _launched(_lib.load().tpucg_dot_f32(
        u.data_ptr(), v.data_ptr(), scratch.data_ptr(), out.data_ptr(), u.numel(),
        active, stream), "dot_cuda", dot_cuda)


def dot_alpha_launch(u, v, scratch, out, rsold, alpha, safe_alpha: bool,
                     active: Optional[int], stream: int, guard: bool = False) -> None:
    """Launch K3 in alpha mode: out = u . v, alpha = rsold / out (guarded
    with ``guard``, which applies with ``safe_alpha`` only, as in tpucg)."""
    rule = 2 if safe_alpha and guard else int(bool(safe_alpha))  # the C ABI's alpha_rule
    _launched(_lib.load().tpucg_dot_alpha_f32(
        u.data_ptr(), v.data_ptr(), scratch.data_ptr(), out.data_ptr(), rsold.data_ptr(),
        alpha.data_ptr(), rule, u.numel(), active, stream), "dot_cuda", dot_cuda)


def dot_tail_launch(u, v, scratch, out, lap: int, stream: int, guard: bool = False) -> None:
    """Launch K3 in tail mode: out = u . v = rs_new, then the lap's tail
    (guarded with ``guard``)."""
    _launched(_lib.load().tpucg_dot_tail_f32(
        u.data_ptr(), v.data_ptr(), scratch.data_ptr(), out.data_ptr(), lap, int(guard),
        u.numel(), stream), "dot_cuda", dot_cuda)


def fused_update_launch(x, r, p, ap, alpha, xo, ro, scratch, rr,
                        active: Optional[int], stream: int) -> None:
    """Launch K2: xo = x + alpha p, ro = r - alpha ap, rr = ro . ro."""
    _launched(_lib.load().tpucg_fused_update_f32(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), alpha.data_ptr(),
        xo.data_ptr(), ro.data_ptr(), scratch.data_ptr(), rr.data_ptr(), x.numel(),
        active, stream), "fused_update_cuda", fused_update_cuda)


def fused_update_tail_launch(x, r, p, ap, alpha, xo, ro, scratch, rr, lap: int,
                             stream: int, guard: bool = False) -> None:
    """Launch K2 in tail mode: K2, then the lap's tail with rs_new = rr
    (guarded with ``guard``)."""
    _launched(_lib.load().tpucg_fused_update_tail_f32(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), alpha.data_ptr(),
        xo.data_ptr(), ro.data_ptr(), scratch.data_ptr(), rr.data_ptr(), lap, int(guard),
        x.numel(), stream), "fused_update_cuda", fused_update_cuda)


def p_update_launch(z, p, beta, step, scratch, stream: int) -> None:
    """Launch p's update: p = z + beta p if step (then step = 0)."""
    _launched(_lib.load().tpucg_p_update_f32(
        z.data_ptr(), p.data_ptr(), beta.data_ptr(), step.data_ptr(), scratch.data_ptr(),
        p.numel(), stream), "p_update_cuda", p_update_cuda)


def dot_cuda(
    u: torch.Tensor, v: torch.Tensor, *, active: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K3 on the card: a 0-d f32 tensor. With ``active`` 0 the result is
    undefined (the kernel returns at once)."""
    _check_vectors("dot_cuda", u, v)
    check_active(active, u)
    out = torch.empty((), dtype=torch.float32, device=u.device)
    dot_launch(u, v, scratch_for(u), out, None if active is None else active.data_ptr(),
               cuda_stream(u))
    return out


dot_cuda.launches = 0


def dot_alpha_cuda(u, v, rsold, safe_alpha: bool = True, guard: bool = False):
    """K3's alpha mode on the card: (u.v, rsold / u.v), 0-d f32 tensors."""
    _check_vectors("dot_alpha_cuda", u, v)
    _check_scalars("dot_alpha_cuda", u, rsold)
    out, alpha = (torch.empty((), dtype=torch.float32, device=u.device) for _ in range(2))
    dot_alpha_launch(u, v, scratch_for(u), out, rsold, alpha, safe_alpha, None, cuda_stream(u),
                     guard)
    return out, alpha


def fused_update_cuda(
    x: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    ap: torch.Tensor,
    alpha: torch.Tensor,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    active: Optional[torch.Tensor] = None,
):
    """K2 on the card: returns (x', r', r'.r'). ``alpha`` is a 0-d f32
    tensor on the device, read there, so the host never waits for it.
    ``out=(x, r)`` updates in place. With ``active`` 0 nothing is written
    and r'.r' is undefined."""
    _check_vectors("fused_update_cuda", x, r, p, ap)
    if not (
        isinstance(alpha, torch.Tensor)
        and alpha.dtype == torch.float32
        and alpha.dim() == 0
        and alpha.device == x.device
    ):
        raise ValueError("fused_update_cuda needs alpha as a 0-d f32 tensor on x's device")
    check_active(active, x)
    if out is None:
        out = (torch.empty_like(x), torch.empty_like(r))
    _check_vectors("fused_update_cuda out", x, *out)
    rr = torch.empty((), dtype=torch.float32, device=x.device)
    fused_update_launch(x, r, p, ap, alpha, *out, scratch_for(x), rr,
                        None if active is None else active.data_ptr(), cuda_stream(x))
    return out[0], out[1], rr


fused_update_cuda.launches = 0


def p_update_cuda(z, p, beta, step):
    """p's update on the card, in place: p = z + beta p where ``step`` (a
    0-d int32 tensor, cleared by the launch) is set. Returns p."""
    _check_vectors("p_update_cuda", z, p)
    _check_scalars("p_update_cuda", z, beta)
    check_active(step, z)
    p_update_launch(z, p, beta, step, scratch_for(z), cuda_stream(z))
    return p


p_update_cuda.launches = 0


def fused_update(x, r, p, ap, alpha, backend: str = "auto"):
    """The fused CG vector update: K2 for CUDA tensors (``"auto"``), the
    plain version for CPU tensors."""
    if resolve_backend(backend, x.device) == "cuda":
        return fused_update_cuda(x, r, p, ap, alpha)
    return fused_update_torch(x, r, p, ap, alpha)
