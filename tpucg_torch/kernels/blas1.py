"""BLAS-1 kernels of the CG lap: the dot product (K3) and the fused x/r
update that also returns beta = r'.r' (K2). ``csrc/blas.cu`` holds both
kernels and their design note; beside each is its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend


def dot_torch(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    dot_torch.launches += 1
    return torch.dot(u, v)


dot_torch.launches = 0


def fused_update_torch(x, r, p, ap, alpha):
    """Plain version of K2: (x + alpha p, r - alpha ap, r'.r')."""
    fused_update_torch.launches += 1
    xn = x + alpha * p
    rn = r - alpha * ap
    return xn, rn, torch.dot(rn, rn)


fused_update_torch.launches = 0


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


def scratch_for(like: torch.Tensor) -> torch.Tensor:
    """The partial-sum scratch of a K2/K3 reduction over ``like``'s length."""
    return torch.empty(
        _lib.reduce_blocks(like.numel()), dtype=torch.float32, device=like.device
    )


# The launch cores below do no checks: the caller has checked the operands as
# the wrappers do and owns outputs and scratch. ``active`` is the flag's
# device pointer or None, ``stream`` a CUDA stream handle. They are the one
# place that counts each kernel's launches.


def dot_launch(u, v, scratch, out, active: Optional[int], stream: int) -> None:
    """Launch K3: out = u . v."""
    err = _lib.load().tpucg_dot_f32(
        u.data_ptr(), v.data_ptr(), scratch.data_ptr(), out.data_ptr(), u.numel(),
        active, stream,
    )
    if err:
        _lib.check(err, "dot_cuda")
    dot_cuda.launches += 1


def fused_update_launch(x, r, p, ap, alpha, xo, ro, scratch, beta,
                        active: Optional[int], stream: int) -> None:
    """Launch K2: xo = x + alpha p, ro = r - alpha ap, beta = ro . ro."""
    err = _lib.load().tpucg_fused_update_f32(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), alpha.data_ptr(),
        xo.data_ptr(), ro.data_ptr(), scratch.data_ptr(), beta.data_ptr(), x.numel(),
        active, stream,
    )
    if err:
        _lib.check(err, "fused_update_cuda")
    fused_update_cuda.launches += 1


def dot_cuda(
    u: torch.Tensor, v: torch.Tensor, *, active: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K3 on the card: a 0-d f32 tensor. With ``active`` 0 the result is
    undefined (the kernels return at once)."""
    _check_vectors("dot_cuda", u, v)
    check_active(active, u)
    out = torch.empty((), dtype=torch.float32, device=u.device)
    dot_launch(u, v, scratch_for(u), out, None if active is None else active.data_ptr(),
               cuda_stream(u))
    return out


dot_cuda.launches = 0


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
    """K2 on the card: returns (x', r', beta). ``alpha`` is a 0-d f32 tensor
    on the device, read there, so the host never waits for it. ``out=(x, r)``
    updates in place. With ``active`` 0 nothing is written and beta is
    undefined."""
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
    beta = torch.empty((), dtype=torch.float32, device=x.device)
    fused_update_launch(x, r, p, ap, alpha, *out, scratch_for(x), beta,
                        None if active is None else active.data_ptr(), cuda_stream(x))
    return out[0], out[1], beta


fused_update_cuda.launches = 0


def fused_update(x, r, p, ap, alpha, backend: str = "auto"):
    """The fused CG vector update: K2 for CUDA tensors (``"auto"``), the
    plain version for CPU tensors."""
    if resolve_backend(backend, x.device) == "cuda":
        return fused_update_cuda(x, r, p, ap, alpha)
    return fused_update_torch(x, r, p, ap, alpha)
