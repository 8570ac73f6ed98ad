"""Whole-solve CG in one kernel launch (``tpucg.kernels.fused``): K4 for one
dense system, K5 for a batch of independent dense systems, K10 for the
matrix-free 3-D Poisson stencil, K11 for a banded (DIA) matrix and K12 for
a batch of banded systems that share their offsets.
``csrc/fused.cu`` holds the kernels and their design note. Their plain
PyTorch versions run the same recurrence (tpucg's ``_cg_while``) through
the solver's loops, so they live above this layer, in
``tpucg_torch.solver.fused``, with the dispatchers.

All return ``(x, k, rr)`` as tpucg's kernels do: the padded solution, the
lap count (int32) and the last r.r (f32), 0-d for one system and ``(B,)``
for a batch, on the solve's device. Nothing here reads a result back to
the host. tpucg's ``mv_impl`` chose the TPU's vector or matrix unit for the
in-kernel GEMV; it has no counterpart on the card and is dropped.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import cuda_stream
from tpucg_torch.kernels.spmv import DIA_MAX_DIAGS, offsets_array
from tpucg_torch.kernels.stencil import STENCIL_MAX_M

# Largest padded n of K4 and of K5, tpucg's caps (fused.py:55, :75), so that
# the gate means the same in both packages.
FUSED_MAX_N = 4096
FUSED_BATCH_MAX_N = 2048

# Largest padded n that fused="auto" sends to K4. tpucg's 1024 was a TPU
# crossover; this is the card's own: K4 beat the lap path at every padded n
# in {128, ..., 4096} (cg_solve per solve, generate_spd_system seed 0,
# medians of 7, each arm twice in one process; NVIDIA H100 80GB HBM3,
# 700 W): 0.15-0.39 ms against 2.1-4.4 ms. PERF.md keeps the table.
# Being equal to FUSED_MAX_N, it makes fused="auto" and fused="always" take
# the same route for every dense solve.
FUSED_AUTO_MAX_N = 4096

# K10 and K11 keep the solve's vectors in device memory, not in VMEM, so
# tpucg's caps (FUSED_STENCIL_MAX_M = 128 and a 100 MiB slab-plus-state
# budget, fused.py:68, :405) do not apply. What they take: any grid edge
# 2 <= m <= FUSED_STENCIL_MAX_M (int32 indices) and any DIA matrix of
# padded n <= FUSED_DIA_MAX_N with at most 64 diagonals, f32 or bf16.
FUSED_STENCIL_MAX_M = STENCIL_MAX_M
FUSED_DIA_MAX_N = 2 ** 31 - 1 - 2 ** 22  # csrc/sparse.cuh kMaxIntRows

# The largest sizes fused="auto" sends to K10 and K11 (fused="always" runs
# them up to the kernels' own limits above): the largest the card's gate
# table measured, all won by the whole solve. cg_solve(fused="always")
# against fused="never" on tpucg's bench system, medians of 5, each arm
# twice in turns (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the stencil
# at m = 16 ... 192, 0.38-8.93 ms against 12.9-30.6 ms since K10's tiles
# (0.42-13.4 against 15-63 before); DIA f32 and bf16 at m = 32 ... 160,
# 0.74-9.72 ms against 14.9-43.0 ms. PERF.md keeps the table.
FUSED_STENCIL_AUTO_MAX_M = 192
FUSED_DIA_AUTO_MAX_N = 160 ** 3

# K12's cap, the card's own: the largest padded n (a multiple of 128) whose
# four f32 vectors fit the shared memory an H100 grants one block (232,448
# bytes, less the 512 bytes of K12's reduction slots; csrc/blas.cuh
# kFusedBatchDiaMaxN). tpucg's VMEM rule (fused_batch_dia_supported,
# fused.py:680) is a TPU rule and does not apply.
FUSED_BATCH_DIA_MAX_N = 14464

# K12's plan, compiled into its launch (csrc/fused.cu batch_dia_plan:
# kBatchDiaWarps, kBatchDiaBlock, kBatchDiaSlots; kBatchBlock): a system runs
# on W warps (BATCH_DIA_WARPS; BATCH_DIA_DEFAULT_WARPS unless forced, at most
# its virtual warps, of which there are 4 or more), a block of at most
# BATCH_DIA_BLOCK threads holds one or more systems, and a system's scalars
# go through BATCH_DIA_SLOTS floats of slots. W = 1 and 2 ran 2.5-6 times
# slower than W = 8 (PERF.md section 6, K12) and are not built.
BATCH_DIA_WARPS = (4, 8)
BATCH_DIA_DEFAULT_WARPS = 8
BATCH_DIA_BLOCK = 256
BATCH_DIA_SLOTS = 128

# K10's and K11's tile, compiled into the kernels (csrc/fused.cu
# kDiaTileRows, kDiaHalo): the rows go in tiles of DIA_TILE_ROWS, dealt to
# the blocks in turn, and a block stages the matvec's input over each tile's
# rows widened by the near offsets, those within DIA_TILE_HALO (+-m of the
# Poisson matrix up to m = 1024, +-m^2 up to m = 32), in a fixed window of
# DIA_TILE_ROWS + 2 DIA_TILE_HALO floats of shared memory.
DIA_TILE_ROWS = 1024
DIA_TILE_HALO = 1024

# K5's split of a system over a thread-block cluster, compiled into the
# kernel (csrc/fused.cu kBatchBlock, kBatchMaxCluster, kBatchRowChunks): a
# system's BATCH_THREADS virtual threads (32 virtual warps) run on C blocks
# of BATCH_THREADS / C threads, C at most BATCH_MAX_CLUSTER (the portable
# cluster size); a lane keeps 4 (C = 1), 8 (C = 2, 4) or BATCH_ROW_CHUNKS
# (C = 8) 16-byte loads of its row in flight. BATCH_SMS is the H100's SM
# count, the plan's default.
BATCH_THREADS = 1024
BATCH_MAX_CLUSTER = 8
BATCH_ROW_CHUNKS = FUSED_BATCH_MAX_N // 128
BATCH_SMS = 132

_PRECOND_CODE = {"none": 0, "jacobi": 1, "poly": 2}

# K4's resident-A plan, compiled into its launch (csrc/fused.cu dense_plan:
# kSmemPerSm, kSmemPerBlock, kSmemReserved, kDenseStatic,
# kDenseBlocksPerSm, kDenseMaxBlocksPerSm, kDenseMaxSlots; csrc/blas.cuh
# kBlock). The H100's shared memory: 228 KB an SM, at most 227 KB a block,
# 1 KB of each block the runtime's; K4's static shared memory is at most
# DENSE_STATIC_SMEM bytes. A block of DENSE_BLOCK threads runs DENSE_WARPS
# warps, one a row.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
DENSE_STATIC_SMEM = 256
DENSE_BLOCK = 256
DENSE_WARPS = DENSE_BLOCK // 32
DENSE_BLOCKS_PER_SM = 2
DENSE_MAX_BLOCKS_PER_SM = 2048 // DENSE_BLOCK
DENSE_MAX_SLOTS = 64


def dense_smem(npad: int, slots: int) -> int:
    """K4's dynamic shared bytes a block: the resident rows' mbarriers (8
    bytes each, padded to 16), the staged matvec input and ``slots`` rows
    of A, f32."""
    return 16 * ((slots + 1) // 2) + 4 * npad * (1 + slots)


def dense_budget(blocks_per_sm: int) -> int:
    """The dynamic shared bytes a K4 block may take at ``blocks_per_sm``
    blocks an SM."""
    return min(SMEM_PER_SM // blocks_per_sm - SMEM_RESERVED, SMEM_PER_BLOCK) - DENSE_STATIC_SMEM


@dataclasses.dataclass(frozen=True)
class DenseResidentPlan:
    """How K4 keeps A on chip: ``grid`` blocks (``blocks_per_sm`` an SM) of
    ``DENSE_WARPS`` warps; warp w of block b (grid warp g = b DENSE_WARPS +
    w) owns rows g, g + warps, ...; its j-th row is its block's row q = j
    DENSE_WARPS + w, resident in shared memory when q < ``resident`` and
    read through L2 (evict_last) otherwise."""

    npad: int
    sms: int
    blocks_per_sm: int
    grid: int
    resident: int

    @property
    def warps(self) -> int:
        return self.grid * DENSE_WARPS

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block."""
        return dense_smem(self.npad, self.resident)

    @property
    def smem_blocks_per_sm(self) -> int:
        """The blocks an SM's shared memory holds at this plan's bytes."""
        return SMEM_PER_SM // (self.smem_bytes + DENSE_STATIC_SMEM + SMEM_RESERVED)

    @property
    def today(self) -> bool:
        """The grid of the kernel before A was kept on chip, one warp a row:
        the partials sum in its order, so x, k and r.r keep their bits."""
        return self.grid == self.npad // DENSE_WARPS

    def rows_of(self, block: int):
        """The (q, row) block ``block`` owns, q its place in the block."""
        out = []
        for w in range(DENSE_WARPS):
            for j, row in enumerate(range(block * DENSE_WARPS + w, self.npad, self.warps)):
                out.append((j * DENSE_WARPS + w, row))
        return sorted(out)

    @property
    def resident_rows(self) -> int:
        """Rows of A in shared memory, over the grid."""
        return sum(q < self.resident for b in range(self.grid) for q, _ in self.rows_of(b))

    def describe(self) -> str:
        streamed = self.npad - self.resident_rows
        return (f"{self.grid} blocks ({self.blocks_per_sm} an SM) of {DENSE_WARPS} warps, "
                f"{self.resident} resident rows a block, {self.resident_rows} rows in shared "
                f"memory and {streamed} ({4 * streamed * self.npad / 2 ** 20:.2f} MiB) through "
                f"L2, {self.smem_bytes} shared bytes a block, "
                + ("today's grid (bit-equal)" if self.today else "grid changed"))


def dense_resident_plan(npad: int, sms: int = BATCH_SMS, blocks_per_sm: Optional[int] = None,
                        resident: Optional[int] = None) -> DenseResidentPlan:
    """K4's plan at padded length ``npad`` on a card of ``sms`` SMs, as its
    launch takes it (csrc/fused.cu dense_plan). Where the one-warp-a-row
    grid (npad / 8 blocks) holds with all eight rows of each block resident
    (npad <= 2048 on an H100), it is kept: x, k and r.r are the same bits
    as before A was kept on chip. Else ``DENSE_BLOCKS_PER_SM`` blocks an
    SM, each with as many of its rows resident as its share of the SM's
    shared memory holds, the rest read through L2. ``blocks_per_sm`` and
    ``resident`` force the plan (the sweep); raises where it does not
    fit."""
    if npad < 128 or npad % 128 or npad > FUSED_MAX_N:
        raise ValueError(f"K4 cannot plan npad={npad} (128-aligned, <= {FUSED_MAX_N})")
    today = npad // DENSE_WARPS
    if blocks_per_sm is None:
        blocks_per_sm = -(-today // sms)
        if (blocks_per_sm > DENSE_MAX_BLOCKS_PER_SM
                or dense_smem(npad, DENSE_WARPS) > dense_budget(blocks_per_sm)):
            blocks_per_sm = DENSE_BLOCKS_PER_SM
    if not 1 <= blocks_per_sm <= DENSE_MAX_BLOCKS_PER_SM:
        raise ValueError(f"K4 takes 1 to {DENSE_MAX_BLOCKS_PER_SM} blocks an SM, "
                         f"got {blocks_per_sm}")
    grid = min(blocks_per_sm * sms, today)
    most = DENSE_WARPS * -(-npad // (grid * DENSE_WARPS))  # rows block 0 owns
    budget = dense_budget(blocks_per_sm)
    fit = 0
    while fit < most and dense_smem(npad, fit + 1) <= budget:
        fit += 1
    fit = min(fit, DENSE_MAX_SLOTS)
    if resident is None:
        resident = fit
    if not 0 <= resident <= fit:
        raise ValueError(f"K4 at npad={npad}, {blocks_per_sm} blocks an SM holds 0 to {fit} "
                         f"resident rows a block, got {resident}")
    return DenseResidentPlan(npad=int(npad), sms=int(sms), blocks_per_sm=int(blocks_per_sm),
                             grid=int(grid), resident=int(resident))


def dense_resident_plans(npad: int, sms: int = BATCH_SMS) -> list:
    """The sweep's plans at ``npad``: for each distinct grid of 1 to 4
    blocks an SM, no row, half the rows and all the rows a block's share
    of shared memory holds resident."""
    plans, grids = [], set()
    for bps in range(1, 5):
        top = dense_resident_plan(npad, sms, blocks_per_sm=bps)
        if top.grid in grids:
            continue
        grids.add(top.grid)
        for resident in sorted({0, top.resident // 2, top.resident}):
            plans.append(dense_resident_plan(npad, sms, blocks_per_sm=bps, resident=resident))
    return plans


def fused_cg_plan(npad: int, plan: Optional[tuple] = None) -> tuple:
    """K4's plan as the library takes it on the current CUDA device: (blocks
    an SM, grid, resident rows a block, dynamic shared bytes); ``plan``
    (blocks an SM, resident rows) forces one as ``_plan`` does."""
    out = (ctypes.c_int * 4)()
    blocks_per_sm, slots = (0, -1) if plan is None else plan
    _lib.check(_lib.load().tpucg_fused_cg_plan(int(npad), int(blocks_per_sm), int(slots), out),
               "fused_cg_plan")
    return tuple(out)


def _check_vector(name: str, v: torch.Tensor, shape, like: torch.Tensor) -> None:
    if v.dtype != torch.float32 or tuple(v.shape) != tuple(shape) or v.device != like.device:
        raise ValueError(
            f"{name} must be f32 {tuple(shape)} on {like.device}, got {v.dtype} "
            f"{tuple(v.shape)} on {v.device}"
        )


def check_fused(A, b, x0, precondition, poly_degree, minv) -> None:
    """K4's operands, with tpucg's messages (K4's wrapper and its plain
    version both check them, so both refuse the same calls)."""
    npad = A.shape[0]
    if A.dim() != 2 or A.shape != (npad, npad):
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if npad % 128 or npad > FUSED_MAX_N:
        raise ValueError(f"fused solve needs 128-aligned n <= {FUSED_MAX_N}, got {npad}")
    if A.dtype != torch.float32:
        raise ValueError(f"fused solve is f32-only, got {A.dtype}")
    if precondition not in _PRECOND_CODE:
        raise ValueError(f"fused solve runs precondition none/jacobi/poly, got {precondition!r}")
    if precondition == "jacobi" and minv is None:
        raise ValueError("precondition='jacobi' requires minv")
    _check_poly(precondition, poly_degree)
    for name, v in (("b", b), ("x0", x0)) + ((("minv", minv),) if precondition == "jacobi" else ()):
        _check_vector(name, v, (npad,), A)


def check_fused_batch(A, b, x0, precondition, minv) -> None:
    """K5's operands, with tpucg's messages (checked by K5's wrapper and its
    plain version)."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    B, npad = A.shape[0], A.shape[1]
    if npad % 128 or npad > FUSED_BATCH_MAX_N:
        raise ValueError(
            f"batched fused solve needs 128-aligned n <= {FUSED_BATCH_MAX_N}, got {npad}"
        )
    if A.dtype != torch.float32:
        raise ValueError(f"batched fused solve is f32-only, got {A.dtype}")
    if precondition not in ("none", "jacobi"):
        raise ValueError(f"batched fused solve runs precondition none/jacobi, got {precondition!r}")
    if precondition == "jacobi" and minv is None:
        raise ValueError("precondition='jacobi' requires minv")
    for name, v in (("b", b), ("x0", x0)) + ((("minv", minv),) if precondition == "jacobi" else ()):
        _check_vector(name, v, (B, npad), A)


@functools.lru_cache(maxsize=None)
def _fused_cg_scratch(npad: int) -> int:
    """K4's scratch floats at padded length ``npad`` (asked of the library
    once a length)."""
    return int(_lib.load().tpucg_fused_cg_scratch(npad))


def fused_cg_solve_cuda(A, b, x0, *, tol, maxiter, safe_alpha=True, precondition="none",
                        poly_degree=0, minv=None, _plan=None):
    """K4 on the card: one cooperative launch runs the whole solve, with A on
    chip from its first matvec to its last (``dense_resident_plan``).
    ``A`` is (npad, npad) f32, npad % 128 == 0 and npad <= ``FUSED_MAX_N``;
    ``b``, ``x0`` and ``minv`` (jacobi) are (npad,) f32 on A's device.
    ``precondition="poly"`` builds the truncated-Neumann polynomial of
    degree ``poly_degree`` inside the kernel (12 power iterations for
    lambda_max). x, k and rr are views of one allocation. ``_plan``
    (blocks an SM, resident rows a block) forces a plan (the sweep); one
    that does not fit is refused. Raises if the card refuses the
    cooperative launch."""
    check_fused(A, b, x0, precondition, poly_degree, minv)
    if A.device.type != "cuda" or not A.is_contiguous() or A.data_ptr() % 16:
        raise ValueError(f"fused_cg_solve_cuda needs a contiguous 16-byte aligned A on a "
                         f"CUDA device, got {A.device}")
    npad = A.shape[0]
    b, x0 = b.contiguous(), x0.contiguous()
    minv = minv.contiguous() if precondition == "jacobi" else None
    nscratch = _fused_cg_scratch(npad)
    # x | scratch | k | rr: x and the scratch start 16-byte aligned.
    out = torch.empty(npad + nscratch + 2, dtype=torch.float32, device=A.device)
    x, k, rr = out[:npad], out.view(torch.int32)[-2], out[-1]
    blocks_per_sm, slots = (0, -1) if _plan is None else _plan
    err = _lib.load().tpucg_fused_cg_f32(
        A.data_ptr(), b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
        x.data_ptr(), k.data_ptr(), rr.data_ptr(), out.data_ptr() + 4 * npad, npad, float(tol),
        int(maxiter), int(bool(safe_alpha)), _PRECOND_CODE[precondition], int(poly_degree),
        int(blocks_per_sm), int(slots), cuda_stream(A),
    )
    if err:
        _lib.check(err, "fused_cg_solve_cuda")
    fused_cg_solve_cuda.launches += 1
    return x, k, rr


fused_cg_solve_cuda.launches = 0


def fused_batch_cg_solve_cuda(A, b, x0, *, tol, maxiter, safe_alpha=True,
                              precondition="none", minv=None, _cluster=None):
    """K5 on the card: B independent whole solves in one launch, each on a
    cluster of C blocks that stream its rows of A (``batch_cluster_plan``
    on the card's SM count). ``A`` is (B, npad, npad) f32, npad % 128 == 0
    and npad <= ``FUSED_BATCH_MAX_N``; ``b``, ``x0`` and ``minv`` (jacobi)
    are (B, npad) f32. Returns x (B, npad), k and rr (B,), the same bits for
    every C. ``_cluster`` forces C (the card's checks); a cluster the card
    refuses raises."""
    check_fused_batch(A, b, x0, precondition, minv)
    if A.device.type != "cuda" or not A.is_contiguous() or A.data_ptr() % 16:
        raise ValueError(f"fused_batch_cg_solve_cuda needs a contiguous 16-byte aligned A on "
                         f"a CUDA device, got {A.device}")
    B, npad = A.shape[0], A.shape[1]
    plan = batch_cluster_plan(B, npad, torch.cuda.get_device_properties(A.device)
                              .multi_processor_count, cluster=_cluster)
    b, x0 = b.contiguous(), x0.contiguous()
    minv = minv.contiguous() if precondition == "jacobi" else None
    x = torch.empty((B, npad), dtype=torch.float32, device=A.device)
    k = torch.empty(B, dtype=torch.int32, device=A.device)
    rr = torch.empty(B, dtype=torch.float32, device=A.device)
    err = _lib.load().tpucg_fused_batch_cg_f32(
        A.data_ptr(), b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
        x.data_ptr(), k.data_ptr(), rr.data_ptr(), B, npad, float(tol), int(maxiter),
        int(bool(safe_alpha)), int(precondition == "jacobi"), plan.cluster, cuda_stream(A),
    )
    if err:
        _lib.check(err, "fused_batch_cg_solve_cuda")
    fused_batch_cg_solve_cuda.launches += 1
    return x, k, rr


fused_batch_cg_solve_cuda.launches = 0


def _check_poly(precondition, poly_degree) -> None:
    if precondition == "poly" and poly_degree < 1:
        raise ValueError("precondition='poly' requires poly_degree >= 1")


def fused_stencil_supported(m: int) -> bool:
    """K10 runs a grid edge 2 <= m <= ``FUSED_STENCIL_MAX_M``."""
    return 2 <= m <= FUSED_STENCIL_MAX_M


def check_fused_stencil(b, x0, m, precondition, poly_degree) -> None:
    """K10's operands, with tpucg's messages (``fused.py:351-360``; K10's
    wrapper and its plain version both check them). The stencil refuses
    jacobi: its diagonal is the constant 6, so z = r/6 changes no iterate."""
    if not fused_stencil_supported(m):
        raise ValueError(
            f"fused stencil solve needs 2 <= m <= {FUSED_STENCIL_MAX_M}, got m={m}"
        )
    if precondition not in ("none", "poly"):
        raise ValueError(
            f"fused stencil solve supports precondition none/poly, got {precondition!r}"
        )
    _check_poly(precondition, poly_degree)
    for name, v in (("b", b), ("x0", x0)):
        _check_vector(name, v, (m ** 3,), b)


def fused_dia_supported(n: int, offsets) -> bool:
    """K11 runs 1 to 64 diagonals over a padded length n <= ``FUSED_DIA_MAX_N``."""
    return 1 <= n <= FUSED_DIA_MAX_N and 1 <= len(offsets) <= DIA_MAX_DIAGS


def check_fused_dia(data, offsets, b, x0, precondition, poly_degree) -> None:
    """K11's operands, with tpucg's messages (``fused.py:514-524``; K11's
    wrapper and its plain version both check them). Jacobi reads 1/diag from
    the stored main diagonal, so it needs offset 0."""
    offsets = tuple(int(o) for o in offsets)
    if data.dim() != 2 or data.shape[0] != len(offsets):
        raise ValueError(
            f"fused DIA solve needs a (ndiag, n) slab for {len(offsets)} offsets, got "
            f"{tuple(data.shape)}"
        )
    npad = data.shape[1]
    if not fused_dia_supported(npad, offsets):
        raise ValueError(
            f"fused DIA solve unsupported for n={npad}, ndiag={len(offsets)} "
            f"(1 to {DIA_MAX_DIAGS} diagonals, n <= {FUSED_DIA_MAX_N})"
        )
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused DIA solve stores f32 or bf16 slabs, got {data.dtype}")
    if precondition not in _PRECOND_CODE:
        raise ValueError(
            f"fused DIA solve runs precondition none/jacobi/poly, got {precondition!r}"
        )
    if precondition == "jacobi" and 0 not in offsets:
        raise ValueError("jacobi needs a stored main diagonal")
    _check_poly(precondition, poly_degree)
    for name, v in (("b", b), ("x0", x0)):
        _check_vector(name, v, (npad,), data)


@dataclasses.dataclass(frozen=True)
class DiaTilePlan:
    """How K11 reads a DIA matrix: ``near`` (|offset| <= ``halo``) and
    ``far`` split ``offsets``, each in offsets order; a tile of rows [t0, t1)
    stages the matvec's input over [t0 + lo, t1 + hi), lo and hi the least
    and largest near offset or 0, and reads the far columns through L2."""

    npad: int
    offsets: tuple
    near: tuple
    far: tuple
    lo: int
    hi: int
    tile: int = DIA_TILE_ROWS
    halo: int = DIA_TILE_HALO

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the fixed window, f32."""
        return 4 * (self.tile + 2 * self.halo)

    @property
    def ntiles(self) -> int:
        return -(-self.npad // self.tile)

    def tiles(self, grid: int):
        """The kernel's tiles, (block, t0, t1) in row order: tile k = [k tile,
        min((k + 1) tile, npad)) belongs to block k % ``grid``."""
        for k in range(self.ntiles):
            yield k % grid, k * self.tile, min((k + 1) * self.tile, self.npad)


def dia_tile_plan(npad: int, offsets) -> DiaTilePlan:
    """K11's plan for a DIA matrix of padded length ``npad``: the near/far
    split of ``offsets`` and the window. Raises for what K11 cannot run: no
    diagonal or more than 64, a length outside [1, ``FUSED_DIA_MAX_N``]."""
    offsets = tuple(int(o) for o in offsets)
    if not fused_dia_supported(int(npad), offsets):
        raise ValueError(
            f"K11 cannot plan n={npad}, ndiag={len(offsets)} (1 to {DIA_MAX_DIAGS} diagonals, "
            f"1 <= n <= {FUSED_DIA_MAX_N})"
        )
    near = tuple(o for o in offsets if abs(o) <= DIA_TILE_HALO)
    far = tuple(o for o in offsets if abs(o) > DIA_TILE_HALO)
    return DiaTilePlan(npad=int(npad), offsets=offsets, near=near, far=far,
                       lo=min(near + (0,)), hi=max(near + (0,)))


@dataclasses.dataclass(frozen=True)
class BatchClusterPlan:
    """How K5 spreads each of ``batch`` systems of padded length ``npad``
    over a cluster of ``cluster`` blocks: block q runs the virtual threads
    [q threads, (q + 1) threads) of the system's ``BATCH_THREADS``; row r
    belongs to virtual warp r % 32 and element i to virtual thread i %
    ``BATCH_THREADS``."""

    batch: int
    npad: int
    cluster: int

    @property
    def threads(self) -> int:
        """Threads a block."""
        return BATCH_THREADS // self.cluster

    @property
    def warps(self) -> int:
        return self.threads // 32

    @property
    def blocks(self) -> int:
        """The grid: ``cluster`` blocks a system."""
        return self.batch * self.cluster

    @property
    def loads(self) -> int:
        """16-byte loads of A a lane keeps in flight."""
        if self.cluster == 1:
            return 4
        return BATCH_ROW_CHUNKS if self.cluster == BATCH_MAX_CLUSTER else 8

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: x, r, p (whole), Ap and z (whole),
        f32."""
        return 4 * 5 * self.npad

    def row_owner(self, rows):
        """The block of the cluster that computes each row of A (an int or an
        array of them)."""
        return (rows % 32) // self.warps

    def element_owner(self, i):
        """The block that owns each element (x_i, r_i, Ap_i, and writes
        z_i into every block's copy)."""
        return (i % BATCH_THREADS) // self.threads


def batch_cluster_plan(batch: int, npad: int, sms: int = BATCH_SMS,
                       cluster: Optional[int] = None) -> BatchClusterPlan:
    """K5's plan: C = 1 once one block a system holds half the card's
    ``sms`` SMs or more (2 ``batch`` >= ``sms``); else the least power of two
    C with ``batch`` C >= ``sms``, at most ``BATCH_MAX_CLUSTER``, which is 4
    or 8. A cluster of 2, whose two blocks an SM hold 64 registers a thread,
    was never faster than one block a system where the rule would take it
    (PERF.md §6, K5). ``cluster`` forces C (1, 2, 4 or 8). Raises for what
    K5 cannot run."""
    if batch < 1 or npad < 128 or npad % 128 or npad > FUSED_BATCH_MAX_N:
        raise ValueError(f"K5 cannot plan batch={batch}, npad={npad} (batch >= 1, 128-aligned "
                         f"npad <= {FUSED_BATCH_MAX_N})")
    if cluster is None:
        cluster = 1
        if 2 * batch < sms:
            cluster = 4
            while batch * cluster < sms and cluster < BATCH_MAX_CLUSTER:
                cluster *= 2
    elif cluster not in (1, 2, 4, BATCH_MAX_CLUSTER):
        raise ValueError(f"K5's cluster is 1, 2, 4 or {BATCH_MAX_CLUSTER} blocks, got {cluster}")
    return BatchClusterPlan(batch=int(batch), npad=int(npad), cluster=int(cluster))


def stencil_offsets(m: int) -> tuple:
    """The 7-point Laplacian's neighbours on an m^3 grid as DIA offsets (x-1,
    y-1, z-1, the row, z+1, y+1, x+1 of flat index x m^2 + y m + z), as
    ``io.generator.poisson3d_dia`` stores them."""
    return (-m * m, -m, -1, 0, 1, m, m * m)


def stencil_tile_plan(m: int) -> DiaTilePlan:
    """K10's plan for the m^3 grid: ``dia_tile_plan`` of the Poisson
    matrix's offsets. The window is [-hi, hi]: hi = m^2 up to m = 32, m up
    to m = 1024, else 1; the other neighbours are read through L2. Raises
    for an m K10 cannot run."""
    if not fused_stencil_supported(m):
        raise ValueError(f"K10 cannot plan m={m} (2 <= m <= {FUSED_STENCIL_MAX_M})")
    return dia_tile_plan(m ** 3, stencil_offsets(m))


def _grid(grid: int, what: str) -> int:
    if grid < 1:
        _lib.check(-grid, what)
    return grid


def fused_stencil_grid(m: int) -> int:
    """The blocks of K10's cooperative launch for the m^3 grid on the current
    CUDA device: the occupancy calculator's blocks an SM at the window's
    shared memory times the SMs, at most one block per 256 rows and 4096."""
    return _grid(int(_lib.load().tpucg_fused_stencil_grid(int(m))), "fused_stencil_grid")


def fused_dia_grid(npad: int, dtype=torch.float32) -> int:
    """The blocks of K11's cooperative launch at padded length ``npad`` on the
    current CUDA device (``dtype`` the slab's): the occupancy calculator's
    blocks an SM at the window's shared memory times the SMs, at most one
    block per 256 rows and 4096."""
    return _grid(int(_lib.load().tpucg_fused_dia_grid(int(npad), int(dtype == torch.bfloat16))),
                 "fused_dia_grid")


def fused_batch_clusters(npad: int, cluster: int) -> int:
    """K5's clusters of ``cluster`` blocks the current CUDA device holds at
    once at padded length ``npad`` (0: the card refuses that cluster)."""
    got = int(_lib.load().tpucg_fused_batch_clusters(int(npad), int(cluster)))
    if got < 0:
        _lib.check(-got, "fused_batch_clusters")
    return got


def dia_minv(data, offsets) -> torch.Tensor:
    """1/diag from the slab's main diagonal (1 where it is 0), f32: the
    Jacobi inverse K11 and K12 and their plain versions read, as tpucg's
    kernels read it from their resident slab (``fused.py:464-470``,
    ``:707-711``). ``data`` is (ndiag, n), or (B, ndiag, n) for a batch."""
    d = data[..., list(int(o) for o in offsets).index(0), :].to(torch.float32)
    return torch.where(d != 0, 1.0 / d, 1.0)


def fused_batch_dia_supported(n: int, offsets) -> bool:
    """K12 runs 1 to 64 diagonals over a padded length n, a multiple of 128
    up to ``FUSED_BATCH_DIA_MAX_N``."""
    return 1 <= n <= FUSED_BATCH_DIA_MAX_N and n % 128 == 0 and 1 <= len(offsets) <= DIA_MAX_DIAGS


def check_fused_batch_dia(data, offsets, b, x0, precondition) -> None:
    """K12's operands, with tpucg's messages (``fused.py:750-765``; K12's
    wrapper and its plain version both check them)."""
    offsets = tuple(int(o) for o in offsets)
    if data.dim() != 3 or data.shape[1] != len(offsets):
        raise ValueError(
            f"batched fused DIA solve needs a (B, ndiag, n) slab for {len(offsets)} offsets, "
            f"got {tuple(data.shape)}")
    B, npad = data.shape[0], data.shape[2]
    if not fused_batch_dia_supported(npad, offsets):
        raise ValueError(
            f"batched fused DIA solve unsupported for n={npad}, ndiag={len(offsets)} (128-aligned "
            f"n <= {FUSED_BATCH_DIA_MAX_N}, 1 to {DIA_MAX_DIAGS} diagonals)")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"batched DIA solve stores f32 or bf16 slabs, got {data.dtype}")
    if precondition not in ("none", "jacobi"):
        raise ValueError("batched DIA solve supports precondition 'none' or 'jacobi'")
    if precondition == "jacobi" and 0 not in offsets:
        raise ValueError("jacobi needs a stored main diagonal")
    for name, v in (("b", b), ("x0", x0)):
        _check_vector(name, v, (B, npad), data)


def _batch_dia_sys_bytes(npad, ndiag, itemsize, warps, regs, pad, slab) -> int:
    vlen = npad + pad * (npad // 32)
    nbytes = (4 * BATCH_DIA_SLOTS + 4 * vlen * (1 if regs else 4)
              + (itemsize * ndiag * vlen if slab else 0))
    return 16 * -(-nbytes // 16)


@dataclasses.dataclass(frozen=True)
class BatchDiaWarpsPlan:
    """How K12 runs a batch: each system on ``warps`` warps (W), ``systems``
    systems a block of ``threads`` threads, ``grid`` blocks. Today's sums
    are kept through virtual threads: the system's VT = min(npad, 1024)
    virtual threads (thread t sums rows t, t + VT, ...) in VW = VT / 32
    virtual warps, each taken by G = 32 W / VW lanes, lane g of them its
    virtual lanes g, g + G, ... (``lane_rows``). x, r and Ap sit in their
    owner's registers when ``regs`` (npad <= 1024), else in shared
    memory with p; the slab is copied into shared memory when ``slab``; each
    vector is padded by ``pad`` floats after every 32 rows."""

    batch: int
    npad: int
    ndiag: int
    itemsize: int
    warps: int
    regs: bool
    systems: int
    pad: int
    slab: bool

    @property
    def vthreads(self) -> int:
        return min(self.npad, BATCH_THREADS)

    @property
    def vwarps(self) -> int:
        return self.vthreads // 32

    @property
    def group(self) -> int:
        """G: the lanes that take one virtual warp."""
        return 32 * self.warps // self.vwarps

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.systems

    @property
    def grid(self) -> int:
        return -(-self.batch // self.systems)

    @property
    def sys_bytes(self) -> int:
        """Dynamic shared bytes of one system."""
        return _batch_dia_sys_bytes(self.npad, self.ndiag, self.itemsize, self.warps,
                                    self.regs, self.pad, self.slab)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared bytes of a block."""
        return self.systems * self.sys_bytes

    def lane_rows(self, lane: int):
        """The rows system lane ``lane`` (0 <= lane < 32 W) owns, as (j, row)
        in the order it sums them: for each q, its virtual threads j = 0,
        1, ... (virtual thread 32 v + g + G j of virtual warp v = lane // G,
        g = lane % G), row = that virtual thread + VT q."""
        g, vw = lane % self.group, lane // self.group
        out = []
        for q in range(-(-self.npad // self.vthreads)):
            for j in range(32 // self.group):
                row = 32 * vw + g + self.group * j + self.vthreads * q
                if row < self.npad:
                    out.append((j, row))
        return out

    def describe(self) -> str:
        return (f"W = {self.warps} warps a system, {self.systems} a block ({self.grid} blocks "
                f"of {self.threads} threads), G = {self.group} lanes a virtual warp, x/r/Ap in "
                + ("registers" if self.regs else "shared memory")
                + f", slab {'in shared memory' if self.slab else 'streamed'}, pad {self.pad}, "
                f"{self.smem_bytes} shared bytes a block")


def batch_dia_warps_plan(batch: int, npad: int, ndiag: int, dtype=torch.float32,
                         sms: int = BATCH_SMS, warps: Optional[int] = None,
                         slab: Optional[bool] = None) -> BatchDiaWarpsPlan:
    """K12's plan for ``batch`` systems of padded length ``npad`` with
    ``ndiag`` diagonals stored in ``dtype`` (csrc/fused.cu batch_dia_plan):
    W = ``BATCH_DIA_DEFAULT_WARPS`` warps a system (at most its virtual
    warps); x, r and Ap in registers where npad <= 1024; the
    vectors padded by G floats every 32 rows and the slab in shared memory
    where they fit (the slab first, then the padding give way); one system
    a block until the batch would fill the card's 32 blocks an SM, then two,
    four, ... ``warps`` and ``slab`` force W and the slab's place (the sweep);
    raises for a plan K12 cannot run."""
    if batch < 1 or npad < 128 or npad % 128 or npad > FUSED_BATCH_DIA_MAX_N or not (
            1 <= ndiag <= DIA_MAX_DIAGS):
        raise ValueError(f"K12 cannot plan batch={batch}, npad={npad}, ndiag={ndiag}")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    vwarps = min(npad, BATCH_THREADS) // 32
    if warps is None:
        warps = min(BATCH_DIA_DEFAULT_WARPS, vwarps)
    if warps not in BATCH_DIA_WARPS or warps > vwarps:
        raise ValueError(f"K12 runs W in {BATCH_DIA_WARPS} warps a system, at most "
                         f"{vwarps} at npad={npad}, got {warps}")
    regs = npad <= BATCH_THREADS
    group = 32 * warps // vwarps
    choice = None
    for s in ((True, False) if slab is None else (bool(slab),)):
        for pad in (group % 32, 0):  # G = 32: a warp's lanes own 32 rows in a row
            if _batch_dia_sys_bytes(npad, ndiag, itemsize, warps, regs, pad, s) <= SMEM_PER_BLOCK:
                choice = (pad, s)
                break
        if choice:
            break
    if choice is None:
        raise ValueError(f"K12 at npad={npad}, ndiag={ndiag}, W={warps}: the slab does not "
                         f"fit in shared memory")
    nbytes = _batch_dia_sys_bytes(npad, ndiag, itemsize, warps, regs, *choice)
    systems = 1
    while (2 * systems * warps * 32 <= BATCH_DIA_BLOCK and 2 * systems * nbytes <= SMEM_PER_BLOCK
           and batch > 32 * sms * systems):
        systems *= 2
    return BatchDiaWarpsPlan(batch=int(batch), npad=int(npad), ndiag=int(ndiag),
                             itemsize=itemsize, warps=int(warps), regs=regs, systems=systems,
                             pad=choice[0], slab=choice[1])


def fused_batch_dia_plan(batch: int, npad: int, ndiag: int, dtype=torch.float32,
                         plan: Optional[tuple] = None) -> tuple:
    """K12's plan as the library takes it on the current CUDA device: (W,
    regs, systems a block, grid, threads, shared bytes a block, pad, slab
    resident, a system's shared bytes); ``plan`` (W, slab) forces one as
    ``_plan`` does."""
    out = (ctypes.c_int * 9)()
    warps, slab = (0, -1) if plan is None else (plan[0], int(plan[1]))
    itemsize = 2 if dtype == torch.bfloat16 else 4
    _lib.check(_lib.load().tpucg_fused_batch_dia_plan(int(batch), int(npad), int(ndiag), itemsize,
                                                       int(warps), slab, out),
               "fused_batch_dia_plan")
    return tuple(out)


def _solve_outputs(n, like):
    return (torch.empty(n, dtype=torch.float32, device=like.device),
            torch.empty((), dtype=torch.int32, device=like.device),
            torch.empty((), dtype=torch.float32, device=like.device),
            torch.empty(int(_lib.load().tpucg_fused_sparse_scratch(n)), dtype=torch.float32,
                        device=like.device))


def _require_cuda(what, *ts) -> None:
    if any(t.device.type != "cuda" or not t.is_contiguous() for t in ts):
        raise ValueError(f"{what} needs contiguous tensors on a CUDA device, got "
                         f"{[str(t.device) for t in ts]}")


def fused_stencil_cg_solve_cuda(b, x0, m, *, tol, maxiter, safe_alpha=True,
                                precondition="none", poly_degree=0):
    """K10 on the card: one cooperative launch runs the whole matrix-free
    Poisson CG (``"none"``) or poly-PCG (``"poly"``, degree ``poly_degree``,
    12 in-kernel power iterations) solve on an m^3 grid. ``b`` and ``x0``
    are (m^3,) f32 on the card. Rows go in tiles dealt to the blocks in
    turn; each tile stages the matvec's input once per element over the
    near neighbours (``stencil_tile_plan``). Raises if the card refuses the
    launch."""
    check_fused_stencil(b, x0, m, precondition, poly_degree)
    plan = stencil_tile_plan(m)
    _require_cuda("fused_stencil_cg_solve_cuda", b, x0)
    x, k, rr, scratch = _solve_outputs(m ** 3, b)
    err = _lib.load().tpucg_fused_stencil_cg_f32(
        b.data_ptr(), x0.data_ptr(), x.data_ptr(), k.data_ptr(), rr.data_ptr(),
        scratch.data_ptr(), m, plan.lo, plan.hi, float(tol), int(maxiter), int(bool(safe_alpha)),
        _PRECOND_CODE[precondition], int(poly_degree), cuda_stream(b),
    )
    if err:
        _lib.check(err, "fused_stencil_cg_solve_cuda")
    fused_stencil_cg_solve_cuda.launches += 1
    return x, k, rr


fused_stencil_cg_solve_cuda.launches = 0


def fused_dia_cg_solve_cuda(data, offsets, b, x0, *, tol, maxiter, safe_alpha=True,
                            precondition="none", poly_degree=0):
    """K11 on the card: one cooperative launch runs the whole banded CG /
    Jacobi / poly-PCG solve of the DIA matrix (``data`` (ndiag, npad) f32 or
    bf16 on the card, ``offsets`` its ndiag offsets). The slab streams from
    where it lies every lap and is never copied; each block owns a run of
    rows and reads the near offsets' columns from shared memory
    (``dia_tile_plan``). ``b`` and ``x0`` are (npad,) f32. Raises if the
    card refuses the launch."""
    check_fused_dia(data, offsets, b, x0, precondition, poly_degree)
    npad = data.shape[1]
    plan = dia_tile_plan(npad, offsets)
    _require_cuda("fused_dia_cg_solve_cuda", data, b, x0)
    minv = dia_minv(data, offsets) if precondition == "jacobi" else None
    offs = offsets_array(offsets)
    x, k, rr, scratch = _solve_outputs(npad, b)
    lib = _lib.load()
    fn = lib.tpucg_fused_dia_cg_f32 if data.dtype == torch.float32 else lib.tpucg_fused_dia_cg_bf16
    err = fn(
        data.data_ptr(), offs.ctypes.data, offs.size, plan.lo, plan.hi, b.data_ptr(), x0.data_ptr(),
        None if minv is None else minv.data_ptr(), x.data_ptr(), k.data_ptr(), rr.data_ptr(),
        scratch.data_ptr(), npad, float(tol), int(maxiter), int(bool(safe_alpha)),
        _PRECOND_CODE[precondition], int(poly_degree), cuda_stream(b),
    )
    if err:
        _lib.check(err, "fused_dia_cg_solve_cuda")
    fused_dia_cg_solve_cuda.launches += 1
    return x, k, rr


fused_dia_cg_solve_cuda.launches = 0


@functools.lru_cache(maxsize=64)
def _offsets(offsets: tuple):
    """The offsets as the launch takes them (an int64 host array), once a
    tuple."""
    return offsets_array(offsets)


def fused_batch_dia_cg_solve_cuda(data, offsets, b, x0, *, tol, maxiter, safe_alpha=True,
                                  precondition="none", _plan=None):
    """K12 on the card: B independent banded CG (``"none"``) or Jacobi-PCG
    (``"jacobi"``, 1/diag read from each slab's main diagonal) solves in one
    launch, each system on a few warps with its slab in shared memory where
    it fits (``batch_dia_warps_plan``), the sums in today's order. ``data``
    is (B, ndiag, npad) f32 or bf16 on the card, every system with the same
    ``offsets``; ``b`` and ``x0`` (B, npad) f32. Returns x (B, npad), k and
    rr (B,), views of one allocation. ``_plan`` (W, slab in shared memory)
    forces a plan (the sweep); one that cannot run is refused."""
    check_fused_batch_dia(data, offsets, b, x0, precondition)
    _require_cuda("fused_batch_dia_cg_solve_cuda", data, b, x0)
    B, npad = data.shape[0], data.shape[2]
    offsets = tuple(int(o) for o in offsets)
    offs = _offsets(offsets)
    out = torch.empty(B * (npad + 2), dtype=torch.float32, device=data.device)
    x = out[:B * npad].view(B, npad)
    k, rr = out.view(torch.int32)[B * npad:B * (npad + 1)], out[B * (npad + 1):]
    warps, slab = (0, -1) if _plan is None else (_plan[0], int(_plan[1]))
    lib = _lib.load()
    fn = (lib.tpucg_fused_batch_dia_cg_f32 if data.dtype == torch.float32
          else lib.tpucg_fused_batch_dia_cg_bf16)
    err = fn(
        data.data_ptr(), offs.ctypes.data, offs.size,
        offsets.index(0) if precondition == "jacobi" else -1, b.data_ptr(), x0.data_ptr(),
        x.data_ptr(), k.data_ptr(), rr.data_ptr(), B, npad, float(tol), int(maxiter),
        int(bool(safe_alpha)), int(warps), slab, cuda_stream(data),
    )
    if err:
        _lib.check(err, "fused_batch_dia_cg_solve_cuda")
    fused_batch_dia_cg_solve_cuda.launches += 1
    return x, k, rr


fused_batch_dia_cg_solve_cuda.launches = 0
