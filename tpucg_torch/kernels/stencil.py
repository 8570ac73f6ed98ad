"""The 3-D 7-point Dirichlet Laplacian, y = 6u - sum of in-grid neighbours
on an m^3 grid (flat index x*m^2 + y*m + z): K8 of the port, and K9, the
same on one slab of x-planes with halo planes from the neighbouring ranks of
a distributed solve. tpucg's (m, m^2) layout, its ``(m*m) % 128 == 0`` rule
and its m <= 160 cap (``stencil.py:40``) are TPU lane and VMEM rules: K8
takes any 2 <= m <= 1280, K9 any slab of mp >= 1 planes.

K8 and K9 are one CUDA template (``csrc/sparse.cu``
``poisson3d_march_kernel``, its source note): a 2.5-D march in which a block
stages each plane of its (y, z) tile, with a one-line halo, once in shared
memory and keeps the planes before and after in registers, over a run of
x-planes. ``stencil_march_plan`` is its plan (tile, run, grid, shared bytes
and the ratio of u's reads to the slab), the kernel's constants mirror it,
and a plan can be forced (``_plan=``) for the card checks and the tile
sweep (``bench/k8_march.py``). Every plan gives the plain version's bits.

K8 x k (``poisson3d_multi``) applies the stencil to the k columns of a
row-major (m^3, k) block at once, a thread 4 columns of a cell (1 where k
% 4 != 0), each column in K8's order, so column j equals K8 on column j
bit for bit: the multi-RHS and block solves' matvec, where tpucg vmaps its
Pallas kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

STENCIL_MAX_M = 1280  # the kernels index with int32 (csrc/sparse.cuh)
_MAX_INT_ROWS = 0x7FFFFFFF - (1 << 22)  # csrc/sparse.cuh kMaxIntRows


def stencil_supported(m: int) -> bool:
    return 2 <= m <= STENCIL_MAX_M


# K8/K9's march (csrc/sparse.cu kMarch*): a thread owns MARCH_CHUNK
# neighbouring z of one line in each plane; a block has at most
# MARCH_THREADS threads, MARCH_LANES of them along a line, and its launch
# bounds keep registers for MARCH_MIN_BLOCKS blocks an SM; the plan aims at
# MARCH_GRID blocks (two on each of an H100's 132 SMs). A staged line has
# MARCH_PAD floats on each side; two staged planes fit MARCH_MAX_SMEM.
MARCH_CHUNK = 4
MARCH_LANES = 32
MARCH_THREADS = 576
MARCH_MIN_BLOCKS = 2
MARCH_GRID = 264
MARCH_AHEAD = 2
MARCH_PAD = 4
MARCH_MAX_SMEM = 48 * 1024


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """How K8/K9 march a slab of ``mp`` x-planes of the m^3 grid (``halo``:
    K9, whose planes -1 and mp are the halo planes lo and hi; K8 is mp = m
    with none). Block (run, j, k) sums the ``ty`` lines from j ty and the
    ``tz`` z from k tz of every plane of the run's ``nx`` planes from run
    nx; its threads are ``tz / MARCH_CHUNK`` along z by ``ty + 2`` lines (the
    tile's and the two beside it)."""

    m: int
    mp: int
    halo: bool
    tz: int
    ty: int
    nx: int

    @property
    def cz(self) -> int:
        return self.tz // MARCH_CHUNK

    @property
    def nz(self) -> int:
        return -(-self.m // self.tz)

    @property
    def ny(self) -> int:
        return -(-self.m // self.ty)

    @property
    def runs(self) -> int:
        return -(-self.mp // self.nx)

    @property
    def grid(self) -> tuple:
        """The launch's grid, CUDA's (x, y, z): runs, y tiles, z tiles."""
        return self.runs, self.ny, self.nz

    @property
    def blocks(self) -> int:
        return self.runs * self.ny * self.nz

    @property
    def threads(self) -> int:
        return self.cz * (self.ty + 2)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: two staged planes of ty + 2
        lines of tz floats and the pads."""
        return 2 * 4 * (self.ty + 2) * (self.tz + 2 * MARCH_PAD)

    @property
    def slab_elements(self) -> int:
        """Elements the function must read: the slab, and the halo planes."""
        return (self.mp + 2 * self.halo) * self.m * self.m

    @property
    def reads(self) -> int:
        """Elements of u (and of lo and hi) the kernel loads: a tile's own
        lines in every plane from the one before its run to the one after
        that exists, with their z halo where the tile is narrower than the
        line; its y-halo lines in the run's own planes; nothing outside the
        grid."""
        m = self.m
        planes = self.mp + 2 * (self.runs - 1) + 2 * self.halo
        return planes * m * (m + 2 * (self.nz - 1)) + self.mp * 2 * (self.ny - 1) * m

    @property
    def ratio(self) -> float:
        return self.reads / self.slab_elements

    def describe(self) -> str:
        return (f"tile {self.ty} lines x {self.tz} z x {self.nx} planes, grid "
                f"{self.runs} x {self.ny} x {self.nz} = {self.blocks} blocks of {self.threads} "
                f"threads, {self.smem_bytes} shared bytes, u read {self.ratio:.4f}x")


def _march_shape(m: int, mp: int) -> bool:
    return stencil_supported(m) and 1 <= mp <= _MAX_INT_ROWS // (m * m)


def stencil_march_plan(m: int, mp: Optional[int] = None, *, halo: bool = False,
                       tz: Optional[int] = None, ty: Optional[int] = None,
                       nx: Optional[int] = None) -> MarchPlan:
    """K8/K9's plan for a slab of ``mp`` planes (K8: mp = m) of the m^3
    grid, as ``csrc/sparse.cu`` ``march_plan`` makes it: a line's chunks of
    MARCH_CHUNK z in the fewest tiles of at most MARCH_LANES, evened; as many
    lines a tile as MARCH_THREADS threads hold beside the two halo lines,
    evened over the m lines; the planes in runs, as many as keep the grid at
    most MARCH_GRID blocks (one at least, mp at most). ``tz``, ``ty`` and
    ``nx`` force those parts. Raises for a slab the kernel cannot index or a
    tile it cannot launch."""
    mp = m if mp is None else mp
    if not _march_shape(m, mp):
        raise ValueError(f"K8/K9 cannot plan m={m}, mp={mp} (2 <= m <= {STENCIL_MAX_M}, "
                         f"mp >= 1, mp * m^2 <= {_MAX_INT_ROWS})")
    chunks = -(-m // MARCH_CHUNK)
    nz = -(-chunks // MARCH_LANES)
    cz = -(-chunks // nz)
    ny = -(-m // min(m, MARCH_THREADS // cz - 2))
    runs = max(1, min(mp, MARCH_GRID // (nz * ny)))
    plan = MarchPlan(m=m, mp=mp, halo=bool(halo), tz=MARCH_CHUNK * cz, ty=-(-m // ny),
                     nx=-(-mp // runs))
    plan = dataclasses.replace(plan, **{k: v for k, v in (("tz", tz), ("ty", ty), ("nx", nx))
                                        if v is not None})
    if not (MARCH_CHUNK <= plan.tz <= MARCH_CHUNK * MARCH_LANES and plan.tz % MARCH_CHUNK == 0
            and 1 <= plan.ty <= MARCH_THREADS and plan.nx >= 1
            and plan.threads <= MARCH_THREADS and plan.smem_bytes <= MARCH_MAX_SMEM):
        raise ValueError(f"K8/K9 cannot launch the tile tz={plan.tz}, ty={plan.ty}, "
                         f"nx={plan.nx}: tz a multiple of {MARCH_CHUNK} up to "
                         f"{MARCH_CHUNK * MARCH_LANES}, at most {MARCH_THREADS} threads and "
                         f"{MARCH_MAX_SMEM} shared bytes a block")
    return plan


def library_march_tile(m: int, mp: int) -> tuple:
    """The (tz, ty, nx) the built kernel library plans for a slab of mp
    planes of the m^3 grid (``tpucg_poisson3d_march_plan``): on the card it
    is held to ``stencil_march_plan``'s."""
    out = (ctypes.c_int * 3)()
    _lib.check(_lib.load().tpucg_poisson3d_march_plan(m, mp, out), "library_march_tile")
    return tuple(out)


def _march_launch(u, lo, hi, y, m: int, mp: int, plan: MarchPlan, active: Optional[int],
                  stream: int, what: str) -> None:
    """Launch K8 (lo = hi = None) or K9 on a forced plan."""
    if (plan.m, plan.mp, plan.halo) != (m, mp, lo is not None):
        raise ValueError(f"{what}: the plan is for m={plan.m}, mp={plan.mp}, halo={plan.halo}, "
                         f"the launch for m={m}, mp={mp}, halo={lo is not None}")
    err = _lib.load().tpucg_poisson3d_march_f32(
        u.data_ptr(), None if lo is None else lo.data_ptr(), None if hi is None else hi.data_ptr(),
        y.data_ptr(), m, mp, plan.tz, plan.ty, plan.nx, active, stream)
    if err:
        _lib.check(err, what)


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
                     stream: int, plan: Optional[MarchPlan] = None) -> None:
    """Launch K8, y = A u, with no checks: the caller has checked u as
    ``poisson3d_cuda`` does and owns y; ``plan`` forces the march's tile
    (``stencil_march_plan``'s otherwise). The one place that counts K8's
    launches."""
    if plan is None:
        err = _lib.load().tpucg_poisson3d_f32(u.data_ptr(), y.data_ptr(), m, active, stream)
        if err:
            _lib.check(err, "poisson3d_cuda")
    else:
        _march_launch(u, None, None, y, m, m, plan, active, stream, "poisson3d_cuda")
    poisson3d_cuda.launches += 1


def poisson3d_cuda(u: torch.Tensor, m: int, *, active: Optional[torch.Tensor] = None,
                   _plan: Optional[MarchPlan] = None) -> torch.Tensor:
    """K8 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined.
    ``_plan`` (``stencil_march_plan(m, tz=, ty=, nx=)``) forces the tile."""
    check_poisson(u, m)
    check_active(active, u)
    y = torch.empty_like(u)
    poisson3d_launch(u, y, m, None if active is None else active.data_ptr(), cuda_stream(u),
                     plan=_plan)
    return y


poisson3d_cuda.launches = 0


def poisson3d(u: torch.Tensor, m: int, backend: str = "auto",
              active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stencil matvec: K8 for a CUDA tensor (``"auto"``), the plain
    version for a CPU one; ``active`` is read by K8 only."""
    if resolve_backend(backend, u.device) == "cuda":
        return poisson3d_cuda(u, m, active=active)
    return poisson3d_torch(u, m)


def poisson3d_multi_torch(U: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version of K8 x k: ``poisson3d_torch`` on the k columns of U
    (m^3, k) at once, in its order, so column j equals it bit for bit."""
    poisson3d_multi_torch.launches += 1
    k = U.shape[1]
    v = U.reshape(m, m, m, k)
    y = 6.0 * v
    for axis in range(3):
        shape = [m, m, m, k]
        shape[axis] = 1
        zeros = v.new_zeros(shape)
        y = y - torch.cat([v.narrow(axis, 1, m - 1), zeros], dim=axis)
        y = y - torch.cat([zeros, v.narrow(axis, 0, m - 1)], dim=axis)
    return y.reshape(m ** 3, k)


poisson3d_multi_torch.launches = 0


def poisson3d_multi_launch(U: torch.Tensor, Y: torch.Tensor, m: int, active: Optional[int],
                           stream: int) -> None:
    """Launch K8 x k, Y = A U, with no checks: the caller has checked U as
    ``poisson3d_multi_cuda`` does and owns Y. The one place that counts
    K8 x k's launches."""
    err = _lib.load().tpucg_poisson3d_multi_f32(U.data_ptr(), Y.data_ptr(), m, U.shape[1],
                                                active, stream)
    if err:
        _lib.check(err, "poisson3d_multi_cuda")
    poisson3d_multi_cuda.launches += 1


def poisson3d_multi_cuda(U: torch.Tensor, m: int, *,
                         active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 x k on the card: Y (m^3, k) = A U. With ``active`` (0-d int32 on
    the device) the kernel does nothing when the flag is 0, and the
    returned block is undefined."""
    if not stencil_supported(m):
        raise ValueError(f"poisson3d_multi_cuda needs 2 <= m <= {STENCIL_MAX_M}, got m={m}")
    if (U.dtype != torch.float32 or U.dim() != 2 or U.shape[0] != m ** 3 or U.shape[1] < 1
            or not U.is_contiguous() or U.device.type != "cuda"):
        raise ValueError(f"poisson3d_multi_cuda needs a contiguous f32 ({m ** 3}, k) block on "
                         f"a CUDA device, got {U.dtype} {tuple(U.shape)} on {U.device}")
    check_active(active, U)
    Y = torch.empty_like(U)
    poisson3d_multi_launch(U, Y, m, None if active is None else active.data_ptr(),
                           cuda_stream(U))
    return Y


poisson3d_multi_cuda.launches = 0


def poisson3d_multi(U: torch.Tensor, m: int, backend: str = "auto",
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k-column stencil: K8 x k for a CUDA tensor (``"auto"``), the
    plain version for a CPU one; ``active`` is read by the kernel only."""
    if resolve_backend(backend, U.device) == "cuda":
        return poisson3d_multi_cuda(U, m, active=active)
    return poisson3d_multi_torch(U, m)


# K9: the stencil on one rank's slab of a distributed solve. u holds the
# slab's mp x-planes, (mp * m^2,) f32 flat; halo_lo and halo_hi the planes
# just below and above it, (m^2,) f32, from the neighbouring ranks (zeros at
# the grid's edges). tpucg's slab_supported (stencil.py:88) is a VMEM and
# lane rule: K9 takes any m >= 2 and mp >= 1 (mp m^2 <= kMaxIntRows).


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
                          stream: int, plan: Optional[MarchPlan] = None) -> None:
    """Launch K9, y = the slab's rows of A u, with no checks: the caller has
    checked the operands as ``poisson3d_slab_cuda`` does and owns y;
    ``plan`` forces the march's tile. The one place that counts K9's
    launches."""
    if plan is None:
        err = _lib.load().tpucg_poisson3d_slab_f32(u.data_ptr(), halo_lo.data_ptr(),
                                                   halo_hi.data_ptr(), y.data_ptr(), m, mp,
                                                   active, stream)
        if err:
            _lib.check(err, "poisson3d_slab_cuda")
    else:
        _march_launch(u, halo_lo, halo_hi, y, m, mp, plan, active, stream,
                      "poisson3d_slab_cuda")
    poisson3d_slab_cuda.launches += 1


def poisson3d_slab_cuda(u: torch.Tensor, halo_lo: torch.Tensor, halo_hi: torch.Tensor, m: int,
                        *, active: Optional[torch.Tensor] = None,
                        _plan: Optional[MarchPlan] = None) -> torch.Tensor:
    """K9 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined.
    ``_plan`` (``stencil_march_plan(m, mp, halo=True, tz=, ty=, nx=)``)
    forces the tile."""
    mp = check_slab(u, halo_lo, halo_hi, m)
    vs = (u, halo_lo, halo_hi)
    if any(v.dtype != torch.float32 or not v.is_contiguous() or v.device != u.device
           for v in vs) or u.device.type != "cuda":
        raise ValueError("poisson3d_slab_cuda needs contiguous f32 u and halos on one CUDA "
                         f"device, got {[(v.dtype, str(v.device)) for v in vs]}")
    check_active(active, u)
    y = torch.empty_like(u)
    poisson3d_slab_launch(u, halo_lo, halo_hi, y, m, mp,
                          None if active is None else active.data_ptr(), cuda_stream(u),
                          plan=_plan)
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
