"""Distributed CG over ``torch.distributed`` (the 1-D slice of
``tpucg.solver.sharded``).

The decomposition is the reference's 1-D row-block striping
(``parallel_cg.c:112-115``, ``MPI_Scatter`` of A): each rank of a ``Mesh``
holds a contiguous block of rows of A and the same rows of b, x, r and p,
and runs the port's ``cg_loop`` on them through closures, as tpucg runs
``cg_loop`` inside ``shard_map`` (``sharded.py:1402``):

- ``matvec``: the exchange, then the kernel on the block;
- ``dot`` and ``update``: K3 or K2 on the block, then the sum over the
  ranks (``Mesh.rank_sum``: the partials gathered and added in rank order,
  the same on every rank; no ``all_reduce``).

Every rank then holds the same scalars, so ``cg_loop``'s one host read a
chunk agrees across ranks with no further collective, and the laps it runs
after the stop (masked, as on one card) call every collective on every
rank, so no rank waits on another.

The exchanges:

- dense ``allgather`` (the reference's collective arm, ``MPI_Allgather``,
  ``parallel_cg.c:290-292``): the blocks of p gathered whole, then K1 on
  the (blk, npad) row block;
- dense ``overlap`` (its point-to-point arm rebuilt as tpucg's ring,
  ``sharded.py:158-197``): the row block is stored as P contiguous (blk,
  blk) tiles; at step s a rank multiplies tile (rank + s) mod P with the p
  block in hand while the next block travels one step down the ring;
- Poisson: the slab decomposition, one x-plane from each neighbour (K9);
- DIA: the band halo, ``halo_length(offsets)`` elements of x from each
  neighbour (K7);
- ELL and BSR: x gathered whole, then tpucg's XLA products as plain torch
  ops (tpucg has no Pallas kernel for them, so none is owed).

``x`` comes back whole on every rank. Methods other than ``"cg"``, block
Jacobi, 2-D meshes, sharded WELL and the two-level preconditioner name
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpucg_torch.comm.mesh import Mesh, make_mesh
from tpucg_torch.config import CGConfig
from tpucg_torch.io.partitioner import RowPartition, round_up
from tpucg_torch.kernels.blas1 import (
    dot_cuda,
    dot_launch,
    dot_torch,
    fused_update_launch,
    fused_update_torch,
    scratch_for,
)
from tpucg_torch.kernels.dispatch import cuda_stream, resolve_backend
from tpucg_torch.kernels.matvec import check_matvec, gemv_launch, matvec_torch
from tpucg_torch.kernels.spmv import (
    LANE,
    bsr_ell_spmv,
    check_dia,
    dia_spmv_halo_launch,
    dia_spmv_halo_torch,
    ell_spmv,
    halo_length,
    offsets_array,
)
from tpucg_torch.kernels.stencil import (
    check_slab,
    poisson3d_slab_launch,
    poisson3d_slab_torch,
)
from tpucg_torch.solver.cg import CGResult, TorchLap, _configure, cg_loop, make_precond
from tpucg_torch.solver.operators import (
    BsrOperator,
    DiaOperator,
    EllOperator,
    PoissonOperator,
)

STRATEGIES = ("allgather", "overlap")
_F32 = torch.float32


# The rows of a dense block are a multiple of 8 (tpucg's row_align,
# sharded.py:57): K1 needs its columns in multiples of 8 (one 16-byte load
# holds 8 bf16), and the ring's tiles are (blk, blk), so blk and npad = P blk
# both must be. tpucg's 256 for its Pallas GEMV is a TPU tile rule.
ROW_ALIGN = 8


def _check_supported(config: CGConfig, interval=None, two_level=None) -> None:
    if config.method != "cg":
        raise NotImplementedError(f"sharded method={config.method!r} is ROADMAP M14 step 2 "
                                  "(M8's loops on the mesh)")
    if config.precondition == "block_jacobi":
        raise NotImplementedError("sharded precondition='block_jacobi' is ROADMAP M14 step 2 "
                                  "(M8's block Jacobi on the mesh)")
    if config.dtype != _F32:
        # tpucg's sharded solves run f32 whatever config.dtype says (they
        # read storage_dtype only); the port refuses instead of solving in
        # another dtype than the one asked for.
        raise ValueError(f"sharded solves are float32 (tpucg's run f32 whatever config.dtype "
                         f"says); got dtype={config.dtype}: use cg_solve for a float64 solve")
    if interval is not None:
        raise NotImplementedError("sharded interval= serves method='ca'/'chebyshev': ROADMAP "
                                  "M14 step 2 (M8's loops on the mesh)")
    if two_level is not None:
        raise NotImplementedError("two_level= (distributed two-level PCG) is ROADMAP M14 step 5")


# --- the lap's closures ------------------------------------------------------


def _reductions(mesh: Mesh, backend: str, like: torch.Tensor):
    """``dot`` and ``update`` for ``cg_loop``'s ``TorchLap``: K3 or K2 on
    this rank's block (their plain versions on the torch backend), one
    launch each, then ``Mesh.rank_sum``; the lap's scalars stay in torch ops
    on the summed values. On cuda the lap's calls write their sums into
    buffers owned here, and K2 updates x and r in place, as the serial cuda
    lap does."""
    if backend == "cuda":
        stream = cuda_stream(like)
        d = torch.empty((), dtype=_F32, device=like.device)
        rr = torch.empty((), dtype=_F32, device=like.device)
        scratch = scratch_for(like)

        def dot(u, v, act):
            if act is None:
                return mesh.rank_sum(dot_cuda(u, v))
            dot_launch(u, v, scratch, d, act.data_ptr(), stream)
            return mesh.rank_sum(d)

        def update(x, r, p, ap, alpha, act):
            fused_update_launch(x, r, p, ap, alpha, x, r, scratch, rr, act.data_ptr(), stream)
            return x, r, mesh.rank_sum(rr)
        return dot, update

    def dot(u, v, act):
        return mesh.rank_sum(dot_torch(u, v))

    def update(x, r, p, ap, alpha, act):
        xn, rn, rr = fused_update_torch(x, r, p, ap, alpha)
        keep = act.bool()
        return torch.where(keep, xn, x), torch.where(keep, rn, r), mesh.rank_sum(rr)
    return dot, update


def _output(y: torch.Tensor, act) -> torch.Tensor:
    """The lap's matvec writes the buffer ``y`` it owns; a call without a
    flag (``init_state``, the power method) gets a fresh vector to keep."""
    return torch.empty_like(y) if act is None else y


def _flag(act) -> Optional[int]:
    return None if act is None else act.data_ptr()


def _halo_exchange(mesh: Mesh, first: torch.Tensor, last: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor) -> None:
    """This rank's ``first`` elements go to the rank below and its ``last``
    to the rank above; ``lo`` receives the rank below's last and ``hi`` the
    rank above's first. At the ends of the chain nothing arrives and the
    halo keeps its zeros (tpucg's unpaired ppermute, ``sharded.py:1150``)."""
    sends, recvs = [], []
    if mesh.rank > 0:
        sends.append((first, mesh.rank - 1))
        recvs.append((lo, mesh.rank - 1))
    if mesh.rank < mesh.size - 1:
        sends.append((last, mesh.rank + 1))
        recvs.append((hi, mesh.rank + 1))
    if sends:
        mesh.sendrecv(sends, recvs).wait()


def _dense_matvec(A_blk: torch.Tensor, strategy: str, mesh: Mesh, backend: str) -> Callable:
    """``matvec(p_blk, act)`` of a dense row block (tpucg's
    ``_make_matvec``, ``sharded.py:164``): ``A_blk`` is (blk, npad) for
    ``allgather`` and (P, blk, blk) tiles for ``overlap``."""
    dev, P = A_blk.device, mesh.size
    blk = A_blk.shape[-2]
    y = torch.empty(blk, dtype=_F32, device=dev)
    if backend == "cuda":
        for tile in (A_blk,) if strategy == "allgather" else tuple(A_blk):
            check_matvec(tile)
        stream = cuda_stream(y)

        def gemv(A, x, out, act):
            gemv_launch(A, x, out, _flag(act), stream)
    else:
        def gemv(A, x, out, act):
            out.copy_(matvec_torch(A, x))

    if strategy == "allgather":
        p_full = torch.empty(blk * P, dtype=_F32, device=dev)

        def matvec(x, act):
            mesh.all_gather(p_full, x)
            out = _output(y, act)
            gemv(A_blk, p_full, out, act)
            return out
        return matvec

    bufs = (torch.empty(blk, dtype=_F32, device=dev), torch.empty(blk, dtype=_F32, device=dev))
    part = torch.empty(blk, dtype=_F32, device=dev)
    down, up = (mesh.rank - 1) % P, (mesh.rank + 1) % P

    def matvec(x, act):
        # The ring (tpucg's _ring_perm): rank j receives the block that rank
        # j + 1 holds, so at step s the block in hand is rank (j + s)'s, and
        # the next one is in flight while K1 multiplies this one.
        out = _output(y, act)
        cur = x
        for s in range(P):
            handle = None
            if s < P - 1:
                nxt = bufs[s % 2]
                handle = mesh.sendrecv([(cur, down)], [(nxt, up)])
            tile = A_blk[(mesh.rank + s) % P]
            if s == 0:
                gemv(tile, cur, out, act)
            else:
                gemv(tile, cur, part, act)
                out.add_(part)
            if handle is not None:
                handle.wait()
                cur = nxt
        return out
    return matvec


@dataclasses.dataclass(frozen=True)
class _ShardedOperator:
    """This rank's share of a sparse operator: its ``kind``, the logical and
    padded sizes, the block's arrays on the mesh's device, the block's
    diagonal for Jacobi (inverted on the device, as the serial solve inverts
    it; None without Jacobi) and the kind's statics."""

    kind: str
    n: int
    npad: int
    arrays: tuple
    diag: Optional[torch.Tensor]
    m: int = 0
    m_padded: int = 0
    offsets: tuple = ()


def _operator_matvec(sop: _ShardedOperator, mesh: Mesh, backend: str) -> Callable:
    """``matvec(x_blk, act)`` of a sharded sparse operator (tpucg's
    ``_operator_matvec``, ``sharded.py:1244``)."""
    dev = mesh.device
    blk = sop.npad // mesh.size
    y = torch.empty(blk, dtype=_F32, device=dev)
    stream = cuda_stream(y) if backend == "cuda" else None
    if sop.kind == "poisson":
        # tpucg's _poisson_halo_matvec (sharded.py:1137): one plane from
        # each neighbour; with m % P != 0 the grid is plane-padded and the
        # pad planes form an identity block (zeroed on input, restored on
        # output), sharded.py:1163-1179.
        m, mm = sop.m, sop.m * sop.m
        mp = blk // mm
        lo = torch.zeros(mm, dtype=_F32, device=dev)
        hi = torch.zeros(mm, dtype=_F32, device=dev)
        plane = mesh.rank * mp + torch.arange(mp, device=dev)
        keep = (plane < m).repeat_interleave(mm)
        padded = sop.m_padded != m

        def matvec(x, act):
            u = x * keep if padded else x
            _halo_exchange(mesh, u[:mm], u[-mm:], lo, hi)
            out = _output(y, act)
            if backend == "cuda":
                poisson3d_slab_launch(u, lo, hi, out, m, mp, _flag(act), stream)
            else:
                out.copy_(poisson3d_slab_torch(u, lo, hi, m))
            return torch.where(keep, out, x) if padded else out
        if backend == "cuda":
            check_slab(y, lo, hi, m)
        return matvec
    if sop.kind == "dia":
        # tpucg's _dia_halo_matvec (sharded.py:1203): the band's reach from
        # each neighbour.
        (data,) = sop.arrays
        offs = sop.offsets
        pad = halo_length(offs)
        lo = torch.zeros(pad, dtype=_F32, device=dev)
        hi = torch.zeros(pad, dtype=_F32, device=dev)
        if backend == "cuda":
            check_dia(data, offs, y)
            offs_np = offsets_array(offs)

        def matvec(x, act):
            _halo_exchange(mesh, x[:pad], x[-pad:], lo, hi)
            out = _output(y, act)
            if backend == "cuda":
                dia_spmv_halo_launch(data, offs_np, x, lo, hi, out, _flag(act), stream)
            else:
                out.copy_(dia_spmv_halo_torch(data, offs, x, lo, hi))
            return out
        return matvec
    # ELL and BSR: x gathered whole, then tpucg's XLA product as plain torch
    # ops (tpucg's _ell_allgather_matvec, sharded.py:1232, and the BSR arm,
    # :1272-1279).
    values, indices = sop.arrays
    product = ell_spmv if sop.kind == "ell" else bsr_ell_spmv
    x_full = torch.empty(sop.npad, dtype=_F32, device=dev)

    def matvec(x, act):
        mesh.all_gather(x_full, x)
        return product(values, indices, x_full)
    return matvec


def _solve(matvec, mesh: Mesh, backend: str, b_blk, x0_blk, diag, config: CGConfig,
           maxiter: int, record_residuals: bool, chunk):
    """``cg_loop`` on this rank's block with the sharded closures; returns
    the loop's final state and x gathered whole (padded length)."""
    dot, update = _reductions(mesh, backend, b_blk)
    minv = None
    if config.precondition == "jacobi":
        minv = torch.where(diag != 0, 1.0 / diag, 1.0)
    precond = make_precond(config.precondition, minv, matvec, dot, b_blk, config.poly_degree)
    s = cg_loop(matvec, dot, TorchLap(dot, update), b_blk, x0_blk, tol=float(config.tol),
                maxiter=maxiter,
                safe_alpha=bool(config.safe_alpha), precond=precond,
                hist_len=maxiter if record_residuals else None, chunk=chunk)
    x_full = torch.empty(b_blk.shape[0] * mesh.size, dtype=_F32, device=b_blk.device)
    mesh.all_gather(x_full, s.x)
    return s, x_full


# --- the dense solve ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistributedSystem:
    """This rank's share of a dense system, placed once by
    ``distribute_system`` (the reference's distribution phase): ``A`` the
    row block in the strategy's layout ((blk, npad) for ``allgather``, (P,
    blk, blk) tiles for ``overlap``), ``b`` and ``x0`` the block's rows, f32;
    ``n`` the logical size, ``part`` the partition, ``rank`` and ``size`` the
    mesh's."""

    A: torch.Tensor
    b: torch.Tensor
    x0: torch.Tensor
    n: int
    part: RowPartition
    strategy: str
    rank: int
    size: int


def _row_block(A: np.ndarray, n: int, npad: int, r0: int, r1: int) -> np.ndarray:
    """Rows [r0, r1) of A padded to npad with its identity tail, without the
    padded whole (tpucg's ``load_system_sharded`` block, ``sharded.py:2473``)."""
    block = np.zeros((r1 - r0, npad), dtype=np.float32)
    top = min(r1, n)
    if top > r0:
        block[: top - r0, :n] = A[r0:top]
    for i in range(max(r0, n), r1):
        block[i - r0, i] = 1.0
    return block


def _host(v, dtype=np.float32) -> np.ndarray:
    """An array or tensor as a host NumPy array of ``dtype``."""
    return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, dtype)


def _host_rhs(b, x0, n: int):
    """b and x0 (or None) as host f32 vectors of length n."""
    b = _host(b)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    if x0 is not None:
        x0 = _host(x0)
        if x0.shape != (n,):
            raise ValueError(f"x0 must have shape ({n},), got {x0.shape}")
    return b, x0


def _padded_block(v, n: int, npad: int, r0: int, r1: int) -> np.ndarray:
    out = np.zeros(npad, dtype=np.float32)
    if v is not None:
        out[:n] = np.asarray(v, np.float32)
    return out[r0:r1]


def distribute_system(A, b, x0=None, mesh: Optional[Mesh] = None,
                      part: Optional[RowPartition] = None, strategy: str = "allgather",
                      storage_dtype=torch.float32) -> DistributedSystem:
    """Pad this rank's rows of (A, b, x0) and place them on the mesh's
    device once (tpucg's ``distribute_system``, ``sharded.py:2409``; the
    bench times it apart). ``part`` defaults to ``RowPartition(n, P,
    ROW_ALIGN)``; ``strategy`` fixes the block's layout;
    ``storage_dtype=torch.bfloat16`` stores A's block in bf16 (f32 sums and
    vectors)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    mesh = make_mesh() if mesh is None else mesh
    A = _host(A)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square, got {A.shape}")
    part = RowPartition(n=n, num_shards=mesh.size, align=ROW_ALIGN) if part is None else part
    if part.n != n or part.num_shards != mesh.size or part.block_rows % ROW_ALIGN:
        raise ValueError(f"{part} does not partition n={n} over {mesh.size} ranks in rows of 8")
    npad, blk = part.n_padded, part.block_rows
    r0, r1 = part.row_range(mesh.rank)
    block = _row_block(A, n, npad, r0, r1)
    if strategy == "overlap":
        block = np.ascontiguousarray(block.reshape(blk, mesh.size, blk).transpose(1, 0, 2))
    b, x0 = _host_rhs(b, x0, n)
    dev = mesh.device
    return DistributedSystem(
        A=torch.from_numpy(block).to(device=dev, dtype=storage_dtype),
        b=torch.from_numpy(_padded_block(b, n, npad, r0, r1)).to(dev),
        x0=torch.from_numpy(_padded_block(x0, n, npad, r0, r1)).to(dev),
        n=n, part=part, strategy=strategy, rank=mesh.rank, size=mesh.size,
    )


def _own_diagonal(system: DistributedSystem) -> torch.Tensor:
    """The block's diagonal entries, which lie in its own column block
    (tpucg's ``_jacobi_minv_blk``, ``sharded.py:629``), widened to f32."""
    A, r = system.A, system.rank
    blk = system.part.block_rows
    own = A[r] if system.strategy == "overlap" else A[:, r * blk:(r + 1) * blk]
    return torch.diagonal(own).to(_F32)


def sharded_cg_solve(
    A,
    b=None,
    x0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    n: Optional[int] = None,
    record_residuals: bool = False,
    storage_dtype=torch.float32,
    interval=None,
    *,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve the dense SPD system A x = b with A's rows in blocks over the
    mesh's ranks (tpucg's ``sharded_cg_solve``, ``sharded.py:2722``, 1-D).

    ``A`` is the whole matrix (each rank takes its rows) or this rank's
    ``DistributedSystem`` (then ``b`` and ``x0`` are not passed: the system
    holds them). ``config.strategy`` is ``"allgather"`` or ``"overlap"``;
    ``precondition`` ``"none"``, ``"jacobi"`` or ``"poly"``;
    ``storage_dtype`` f32 or bf16 (f32 sums and vectors; the solve then
    meets the f32 contract on the bf16-rounded system). ``mesh`` defaults to
    ``make_mesh()``; ``kernel="auto"`` runs K1, K2 and K3 on a CUDA mesh and
    their plain versions on a CPU one. Every rank returns the same result,
    with x whole, trimmed to ``n`` (default: the system's)."""
    config = _configure(config, overrides)
    _check_supported(config, interval)
    mesh = make_mesh() if mesh is None else mesh
    backend = resolve_backend(config.kernel, mesh.device)
    if isinstance(A, DistributedSystem):
        system = A
        if b is not None or x0 is not None:
            raise ValueError("a DistributedSystem holds its b and x0: pass neither")
        if (system.rank, system.size) != (mesh.rank, mesh.size) \
                or system.A.device != mesh.device:
            raise ValueError(f"the system was placed for rank {system.rank} of {system.size} "
                             f"on {system.A.device}, the mesh is {mesh!r}")
        if system.strategy != config.strategy:
            raise ValueError(f"the system was laid out for strategy {system.strategy!r}, the "
                             f"solve asked for {config.strategy!r}: distribute it again")
        if system.A.dtype != storage_dtype:
            raise ValueError(f"the system stores A in {system.A.dtype}, the solve asked for "
                             f"storage_dtype={storage_dtype}: distribute it again")
    else:
        if b is None:
            raise ValueError("b is required")
        system = distribute_system(A, b, x0, mesh, strategy=config.strategy,
                                   storage_dtype=storage_dtype)
    n = system.n if n is None else int(n)
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    matvec = _dense_matvec(system.A, system.strategy, mesh, backend)
    diag = _own_diagonal(system) if config.precondition == "jacobi" else None
    s, x = _solve(matvec, mesh, backend, system.b, system.x0, diag, config, maxiter,
                  record_residuals, chunk)
    return CGResult(x=x[:n], iterations=s.k, residual_norm=s.rslast.sqrt(), converged=s.done,
                    residual_history=s.hist)


# --- the operator solve ------------------------------------------------------


def _dia_canonical(op, device):
    """The canonical (ndiag, len) DIA slab on ``device`` (a ``DiaOperator``'s
    stays where it is when that is the device, f32 or bf16), its offsets and
    n, from a ``DiaOperator`` or a ``DIAMatrix`` (this package's or
    tpucg's)."""
    if isinstance(op, DiaOperator):
        return op.data.detach().to(device), op.offsets, op.n
    return (torch.from_numpy(np.asarray(op.data, np.float32)).to(device),
            tuple(int(o) for o in op.offsets), int(op.shape[0]))


def _prepare_sharded_operator(op, mesh: Mesh, config: CGConfig,
                              storage_dtype=torch.float32) -> _ShardedOperator:
    """Pad the operator for the mesh and place this rank's block on its
    device (tpucg's ``_prepare_sharded_operator``, ``sharded.py:2158``)."""
    P, rank, dev = mesh.size, mesh.rank, mesh.device
    kind_name = type(op).__name__
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    if kind_name in ("CSRMatrix", "WellOperator", "WellMatrix"):
        raise NotImplementedError(
            f"sharded {kind_name} (irregular sparsity: sharded WELL) needs the WELL shard "
            "packers (csr_to_well_sharded), ROADMAP M14")
    if storage_dtype != torch.float32 and not (
            isinstance(op, DiaOperator) or kind_name == "DIAMatrix"):
        raise ValueError("storage_dtype=bfloat16 is supported for DIA operators (the stencil "
                         "is matrix-free; ELL/BSR index arrays dominate their footprint), got "
                         f"{kind_name}")
    jacobi = config.precondition == "jacobi"

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    if isinstance(op, PoissonOperator):
        m = op.m
        m_padded = round_up(m, P)
        npad = m_padded * m * m
        blk = npad // P
        diag = None
        if jacobi:
            d = np.ones(npad, np.float32)
            d[: op.n] = 6.0
            diag = put(d[rank * blk:(rank + 1) * blk])
        return _ShardedOperator("poisson", op.n, npad, (), diag, m=m, m_padded=m_padded)
    if isinstance(op, DiaOperator) or kind_name == "DIAMatrix":
        # On the mesh's device: a slab placed there already is sliced there
        # (bf16 widens exactly, so the storage cast is lossless either way).
        data, offsets, n = _dia_canonical(op, dev)
        if 0 not in offsets:
            raise ValueError("sharded DIA needs a main diagonal to place identity padding")
        npad = round_up(n, P * LANE)
        if npad != data.shape[1]:
            padded = data.new_zeros((data.shape[0], npad))
            padded[:, : data.shape[1]] = data
            padded[offsets.index(0), data.shape[1]:] = 1.0
            data = padded
        blk = npad // P
        maxo = max(abs(o) for o in offsets)
        if maxo > blk:
            raise ValueError(f"band reach {maxo} exceeds the per-rank block {blk}; use fewer "
                             "ranks (the halo exchange covers one neighbour)")
        block = data[:, rank * blk:(rank + 1) * blk]
        diag = block[offsets.index(0)].to(_F32) if jacobi else None
        return _ShardedOperator("dia", n, npad, (block.to(storage_dtype).contiguous(),), diag,
                                offsets=tuple(offsets))
    if isinstance(op, EllOperator) or kind_name == "EllMatrix":
        values, indices = _host(op.values), _host(op.indices, np.int32)
        n = values.shape[0]
        npad = round_up(n, P)
        if npad != n:
            L = values.shape[1]
            vp, ip = np.zeros((npad, L), np.float32), np.zeros((npad, L), np.int32)
            vp[:n], ip[:n] = values, indices
            vp[n:, 0] = 1.0  # identity pad rows
            ip[n:, 0] = np.arange(n, npad)
            values, indices = vp, ip
        blk = npad // P
        rows = slice(rank * blk, (rank + 1) * blk)
        diag = None
        if jacobi:
            own = indices[rows] == np.arange(rank * blk, (rank + 1) * blk)[:, None]
            diag = put(np.where(own, values[rows], 0.0).sum(axis=1).astype(np.float32))
        return _ShardedOperator("ell", n, npad, (put(values[rows]), put(indices[rows])), diag)
    if isinstance(op, BsrOperator) or kind_name == "BSRMatrix":
        if not isinstance(op, BsrOperator):
            op = BsrOperator.from_bsr(op, device="cpu")
        values, indices = _host(op.values), _host(op.indices, np.int32)
        nbr, L, bs, _ = values.shape
        nbr_pad = round_up(nbr, P)
        if nbr_pad != nbr:
            vp = np.zeros((nbr_pad, L, bs, bs), np.float32)
            ip = np.zeros((nbr_pad, L), np.int32)
            vp[:nbr], ip[:nbr] = values, indices
            vp[nbr:, 0] = np.eye(bs, dtype=np.float32)  # identity pad blocks
            ip[nbr:, 0] = np.arange(nbr, nbr_pad)
            values, indices = vp, ip
        nbl = nbr_pad // P
        rows = slice(rank * nbl, (rank + 1) * nbl)
        diag = None
        if jacobi:
            own = (indices[rows] == np.arange(rank * nbl, (rank + 1) * nbl)[:, None])[..., None]
            blocks = np.where(own, np.diagonal(values[rows], axis1=2, axis2=3), 0.0)
            diag = put(blocks.sum(axis=1).reshape(-1).astype(np.float32))
        return _ShardedOperator("bsr", op.n, nbr_pad * bs,
                                (put(values[rows]), put(indices[rows])), diag)
    raise TypeError("sharded_operator_cg_solve supports Poisson, DIA, ELL and BSR operators, "
                    f"got {kind_name}")


def sharded_operator_cg_solve(
    op,
    b,
    x0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    record_residuals: bool = False,
    storage_dtype=torch.float32,
    interval=None,
    two_level=None,
    *,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Distributed CG on a sparse or stencil operator over the mesh's ranks
    (tpucg's ``sharded_operator_cg_solve``, ``sharded.py:1906``):

    - ``PoissonOperator``: x-plane slabs with one plane of halo from each
      neighbour (K9); any m (plane-padded to a multiple of P, the pad planes
      an identity block);
    - ``DiaOperator`` / ``DIAMatrix``: 128-aligned row blocks with the band's
      reach of halo from each neighbour (K7); the slab in f32 or, with
      ``storage_dtype=torch.bfloat16``, bf16;
    - ``EllOperator`` / ``EllMatrix`` and ``BsrOperator`` / ``BSRMatrix``:
      row blocks (identity-padded to P) and x gathered whole.

    Precondition ``"none"``, ``"jacobi"`` or ``"poly"``; every rank returns
    the same result, x whole. ``converged`` is r.r < tol^2, as tpucg's."""
    config = _configure(config, overrides)
    _check_supported(config, interval, two_level)
    mesh = make_mesh() if mesh is None else mesh
    backend = resolve_backend(config.kernel, mesh.device)
    sop = _prepare_sharded_operator(op, mesh, config, storage_dtype)
    n, npad = sop.n, sop.npad
    blk = npad // mesh.size
    b, x0 = _host_rhs(b, x0, n)
    r0, r1 = mesh.rank * blk, (mesh.rank + 1) * blk
    b_blk = torch.from_numpy(_padded_block(b, n, npad, r0, r1)).to(mesh.device)
    x0_blk = torch.from_numpy(_padded_block(x0, n, npad, r0, r1)).to(mesh.device)
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    matvec = _operator_matvec(sop, mesh, backend)
    s, x = _solve(matvec, mesh, backend, b_blk, x0_blk, sop.diag, config, maxiter,
                  record_residuals, chunk)
    tol2 = torch.tensor(float(config.tol), dtype=_F32, device=mesh.device) ** 2
    return CGResult(x=x[:n], iterations=s.k, residual_norm=s.rslast.sqrt(),
                    converged=s.rslast < tol2, residual_history=s.hist)
