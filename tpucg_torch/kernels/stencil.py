"""The 3-D 7-point Dirichlet Laplacian, y = 6u - sum of in-grid neighbours
on an m^3 grid (flat index x*m^2 + y*m + z): K8 of the port, and K9, the
same on one slab of x-planes with halo planes from the neighbouring ranks of
a distributed solve; ``csrc/sparse.cu`` holds the kernels and their design
note. tpucg's (m, m^2) layout, its ``(m*m) % 128 == 0`` rule and its m <=
160 cap (``stencil.py:40``) are TPU lane and VMEM rules: K8 takes any m >= 2.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

STENCIL_MAX_M = 1280  # the kernels index with int32 (csrc/sparse.cuh)
_MAX_INT_ROWS = 0x7FFFFFFF - (1 << 22)  # csrc/sparse.cuh kMaxIntRows


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


# K9: the stencil on one rank's slab of a distributed solve. u holds the
# slab's mp x-planes, (mp * m^2,) f32 flat; halo_lo and halo_hi the planes
# just below and above it, (m^2,) f32, from the neighbouring ranks (zeros at
# the grid's edges). tpucg's slab_supported (stencil.py:88) is a VMEM and
# lane rule: K9 takes any m >= 2 and mp >= 1.


def poisson3d_slab_torch(u: torch.Tensor, halo_lo: torch.Tensor, halo_hi: torch.Tensor,
                         m: int) -> torch.Tensor:
    """Plain version of K9: the expressions of tpucg's slab body
    (``_poisson_slab_kernel``, ``stencil.py:94-122``), 6 u minus the
    neighbours in K8's order x+1, x-1, y+1, y-1, z+1, z-1, with the x
    neighbours beyond the slab from the halos. tpucg's XLA slab arm
    (``sharded.py:1187-1198``) subtracts the x neighbours last and rounds
    otherwise; this order keeps the slabs of a grid bit-equal to K8 on the
    whole."""
    poisson3d_slab_torch.launches += 1
    v = u.reshape(-1, m, m)
    y = 6.0 * v
    y = y - torch.cat([v[1:], halo_hi.reshape(1, m, m)], dim=0)
    y = y - torch.cat([halo_lo.reshape(1, m, m), v[:-1]], dim=0)
    for axis in (1, 2):
        shape = list(v.shape)
        shape[axis] = 1
        zeros = v.new_zeros(shape)
        y = y - torch.cat([v.narrow(axis, 1, m - 1), zeros], dim=axis)
        y = y - torch.cat([zeros, v.narrow(axis, 0, m - 1)], dim=axis)
    return y.reshape(-1)


poisson3d_slab_torch.launches = 0


def check_slab(u: torch.Tensor, halo_lo: torch.Tensor, halo_hi: torch.Tensor, m: int) -> int:
    """K9's operands, as ``poisson3d_slab_cuda`` checks them before a launch
    (the device is checked by the caller); returns the slab's plane count
    mp."""
    mm = m * m
    if not stencil_supported(m) or u.dim() != 1 or u.numel() == 0 or u.numel() % mm:
        raise ValueError(f"poisson3d_slab needs 2 <= m <= {STENCIL_MAX_M} and a flat u of whole "
                         f"m^2 planes, got m={m}, u {tuple(u.shape)}")
    for name, h in (("halo_lo", halo_lo), ("halo_hi", halo_hi)):
        if h.dim() != 1 or h.numel() != mm:
            raise ValueError(f"{name} must be one plane of {mm} values, got {tuple(h.shape)}")
    mp = u.numel() // mm
    if mp * mm > _MAX_INT_ROWS:
        raise ValueError(f"poisson3d_slab indexes with int32: {mp} planes of {mm} are too many")
    return mp


def poisson3d_slab_launch(u, halo_lo, halo_hi, y, m: int, mp: int, active: Optional[int],
                          stream: int) -> None:
    """Launch K9, y = the slab's rows of A u, with no checks: the caller has
    checked the operands as ``poisson3d_slab_cuda`` does and owns y. The one
    place that counts K9's launches."""
    err = _lib.load().tpucg_poisson3d_slab_f32(u.data_ptr(), halo_lo.data_ptr(),
                                               halo_hi.data_ptr(), y.data_ptr(), m, mp, active,
                                               stream)
    if err:
        _lib.check(err, "poisson3d_slab_cuda")
    poisson3d_slab_cuda.launches += 1


def poisson3d_slab_cuda(u: torch.Tensor, halo_lo: torch.Tensor, halo_hi: torch.Tensor, m: int,
                        *, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined."""
    mp = check_slab(u, halo_lo, halo_hi, m)
    vs = (u, halo_lo, halo_hi)
    if any(v.dtype != torch.float32 or not v.is_contiguous() or v.device != u.device
           for v in vs) or u.device.type != "cuda":
        raise ValueError("poisson3d_slab_cuda needs contiguous f32 u and halos on one CUDA "
                         f"device, got {[(v.dtype, str(v.device)) for v in vs]}")
    check_active(active, u)
    y = torch.empty_like(u)
    poisson3d_slab_launch(u, halo_lo, halo_hi, y, m, mp,
                          None if active is None else active.data_ptr(), cuda_stream(u))
    return y


poisson3d_slab_cuda.launches = 0


def poisson3d_slab(u: torch.Tensor, halo_lo: torch.Tensor, halo_hi: torch.Tensor, m: int,
                   backend: str = "auto", active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slab stencil: K9 for a CUDA tensor (``"auto"``), the plain version
    for a CPU one; ``active`` is read by K9 only."""
    if resolve_backend(backend, u.device) == "cuda":
        return poisson3d_slab_cuda(u, halo_lo, halo_hi, m, active=active)
    check_slab(u, halo_lo, halo_hi, m)
    return poisson3d_slab_torch(u, halo_lo, halo_hi, m)
