"""The 3-D 7-point Dirichlet Laplacian, y = 6u - sum of in-grid neighbours
on an m^3 grid (flat index x*m^2 + y*m + z): K8 of the port; ``csrc/sparse.cu``
holds the kernel and its design note. tpucg's (m, m^2) layout, its
``(m*m) % 128 == 0`` rule and its m <= 160 cap (``stencil.py:40``) are TPU
lane and VMEM rules: K8 takes any m >= 2.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

STENCIL_MAX_M = 1280  # the kernels index with int32 (csrc/sparse.cuh)


def stencil_supported(m: int) -> bool:
    return 2 <= m <= STENCIL_MAX_M


def poisson3d_torch(u: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version of K8: the concat form of tpucg's
    ``PoissonOperator._matvec_xla`` (``operators.py:584-597``), subtracting
    the neighbours in ``stencil_apply``'s order x+1, x-1, y+1, y-1, z+1, z-1."""
    poisson3d_torch.launches += 1
    v = u.reshape(m, m, m)
    y = 6.0 * v
    for axis in range(3):
        shape = [m, m, m]
        shape[axis] = 1
        zeros = v.new_zeros(shape)
        hi = v.narrow(axis, 1, m - 1)
        lo = v.narrow(axis, 0, m - 1)
        y = y - torch.cat([hi, zeros], dim=axis)
        y = y - torch.cat([zeros, lo], dim=axis)
    return y.reshape(-1)


poisson3d_torch.launches = 0


def check_poisson(u: torch.Tensor, m: int) -> None:
    """K8's operands, as ``poisson3d_cuda`` checks them before a launch."""
    if not stencil_supported(m):
        raise ValueError(f"poisson3d_cuda needs 2 <= m <= {STENCIL_MAX_M}, got m={m}")
    if (
        u.dtype != torch.float32 or u.dim() != 1 or u.shape[0] != m ** 3
        or not u.is_contiguous() or u.device.type != "cuda"
    ):
        raise ValueError(
            f"poisson3d_cuda needs a contiguous f32 u of length {m ** 3} on a CUDA device, "
            f"got {u.dtype} {tuple(u.shape)} on {u.device}"
        )


def poisson3d_launch(u: torch.Tensor, y: torch.Tensor, m: int, active: Optional[int],
                     stream: int) -> None:
    """Launch K8, y = A u, with no checks: the caller has checked u as
    ``poisson3d_cuda`` does and owns y. The one place that counts K8's
    launches."""
    err = _lib.load().tpucg_poisson3d_f32(u.data_ptr(), y.data_ptr(), m, active, stream)
    if err:
        _lib.check(err, "poisson3d_cuda")
    poisson3d_cuda.launches += 1


def poisson3d_cuda(u: torch.Tensor, m: int, *, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined."""
    check_poisson(u, m)
    check_active(active, u)
    y = torch.empty_like(u)
    poisson3d_launch(u, y, m, None if active is None else active.data_ptr(), cuda_stream(u))
    return y


poisson3d_cuda.launches = 0


def poisson3d(u: torch.Tensor, m: int, backend: str = "auto",
              active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stencil matvec: K8 for a CUDA tensor (``"auto"``), the plain
    version for a CPU one; ``active`` is read by K8 only."""
    if resolve_backend(backend, u.device) == "cuda":
        return poisson3d_cuda(u, m, active=active)
    return poisson3d_torch(u, m)
