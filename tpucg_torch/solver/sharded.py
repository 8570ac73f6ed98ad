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
- WELL (an irregular CSR, ``csr_to_well_sharded``): x gathered whole,
  then K13 for the rank's rows, whose pack addresses global columns;
- ELL and BSR: x gathered whole, then tpucg's XLA products as plain torch
  ops (tpucg has no Pallas kernel for them, so none is owed).

Every method runs on the mesh through the same closures (``cg.run_method``
takes them as the serial solve does): pipelined CG sums a lap's dots in one
``rank_sum`` of their stacked partials (``dots``), CA-CG its basis's Gram in
one (``gram``, summed in float64), Chebyshev only its checks' dots. Block
Jacobi is shard-local: the block grid restarts at every rank's first row, so
each rank inverts its own diagonal blocks once and applies them with no
collective. ``sharded_cg_solve_multi`` and ``sharded_cg_solve_block`` run k
right-hand sides on one (blk, k) product a lap: one gather of the direction
block (or a (halo, k) exchange) and the rank's rows of A times it.

The two-level cycle (``two_level=``) runs on the operator split: the
smoother and the cycle's products on the rank's rows, restriction and
prolongation on its own aggregates, one gather of the coarse residuals a
cycle and the coarse inverse replicated.

Host-sharded loading: ``load_system_sharded`` (a dense text or ``.npy``
matrix) and ``load_well_system_sharded`` (an indexed ``.mtx``) have each
rank read only its own rows and place its block; no rank holds the whole
matrix, where the reference's rank 0 reads it all
(``parallel_cg.c:100-108``).

The 2-D SUMMA decomposition (a ``Mesh2D`` of R x C ranks, tpucg's
``sharded2d`` arms): rank (i, j) keeps the (npad/R, npad/C) block (i, j) of
the column-permuted A (``_colperm_2d``) and chunk r = i C + j of every
vector. A product gathers p's chunks within the column group, runs K1 on
the rectangular block (bf16 under bf16 storage), then sums the row group's
(npad/R,) partials in the group's rank order and keeps its chunk (tpucg's
``psum_scatter``, in a fixed order: no reduce-scatter); the dots are the
world's ``rank_sum``, so the 1-D loops run on it unchanged. Dense only:
the operator solves, block Jacobi, ``interval=`` and IR refuse it in
tpucg's words.

``x`` comes back whole on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpucg_torch.comm.mesh import Mesh, Mesh2D, make_mesh
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
from tpucg_torch.kernels.gather_spmv import (
    check_well,
    check_well_values,
    well_rows,
    well_spmv_launch,
    well_spmv_multi_launch,
    well_spmv_multi_torch,
    well_spmv_torch,
)
from tpucg_torch.kernels.matvec import _COL_ALIGN, check_matvec, gemv_launch, matvec_torch
from tpucg_torch.kernels.spmv import (
    LANE,
    bsr_ell_spmv,
    bsr_ell_spmv_multi,
    check_dia,
    dia_spmv_halo_launch,
    dia_spmv_halo_torch,
    ell_spmv,
    ell_spmv_multi,
    halo_length,
    offsets_array,
)
from tpucg_torch.kernels.stencil import (
    check_slab,
    poisson3d_slab_launch,
    poisson3d_slab_torch,
)
from tpucg_torch.solver.cg import (
    BLOCK_CG_MAX_K,
    TRUE_CHECK_EVERY,
    CGResult,
    TorchLap,
    _configure,
    _poly_block,
    block_cg_loop,
    block_pcg_loop,
    cg_loop,
    invert_blocks,
    lambda_max_estimate,
    make_block_apply,
    make_precond,
    multi_cg_loop,
    run_method,
    sqrt_pair_blocks,
)
from tpucg_torch.solver.operators import (
    BsrOperator,
    DiaOperator,
    EllOperator,
    PoissonOperator,
)
from tpucg_torch.solver.twolevel import build_two_level_from_parts, make_two_level_precond_sharded

STRATEGIES = ("allgather", "overlap")
_F32 = torch.float32


# The rows of a dense block are a multiple of 8 (tpucg's row_align,
# sharded.py:57): K1 needs its columns in multiples of 8 (one 16-byte load
# holds 8 bf16), and the ring's tiles are (blk, blk), so blk and npad = P blk
# both must be. tpucg's 256 for its Pallas GEMV is a TPU tile rule.
ROW_ALIGN = 8


def pc_align(base: int, config: CGConfig) -> int:
    """The dense partition's row alignment (tpucg's ``pc_align``,
    ``sharded.py:63``): under block Jacobi each rank's rows are a multiple
    of ``pc_block_size`` as well, so no block crosses a rank (the identity
    tail's blocks are exact unit diagonals)."""
    if config.precondition != "block_jacobi":
        return base
    return math.lcm(base, int(config.pc_block_size))


def _interval_static(interval, config: CGConfig):
    """A cached spectral interval as host floats (tpucg's
    ``_interval_static``, ``sharded.py:143``); it serves CA and Chebyshev
    only."""
    if interval is None:
        return None
    if config.method not in ("ca", "chebyshev"):
        raise ValueError("interval=(lam_lo, lam_hi) applies to method='ca'/'chebyshev' "
                         f"(got method={config.method!r})")
    return (float(interval[0]), float(interval[1]))


# tpucg's refusal of a sparse operator on a 2-D mesh (sharded.py:357-361).
DENSE_2D = ("sparse operators take the 1-D operator decompositions; the 2-D SUMMA arm is "
            "dense")


def check_mesh(mesh) -> None:
    """A mesh of this package: a 1-D ``Mesh`` or a ``Mesh2D``."""
    if not isinstance(mesh, (Mesh, Mesh2D)):
        raise TypeError(f"expected a Mesh or Mesh2D of tpucg_torch.comm.mesh, got "
                        f"{type(mesh).__name__}")


def check_1d(mesh, refusal: str = "this solve runs on 1-D meshes") -> None:
    """A call that tpucg runs on 1-D meshes only: a ``Mesh2D`` raises its
    ``ValueError`` with ``refusal``, tpucg's words for that call."""
    check_mesh(mesh)
    if isinstance(mesh, Mesh2D):
        raise ValueError(refusal)


def _check_supported(config: CGConfig, interval=None,
                     record_residuals: bool = False) -> None:
    if record_residuals and config.method != "cg":
        raise ValueError("record_residuals requires method='cg'")
    if config.dtype != _F32:
        # tpucg's sharded solves run f32 whatever config.dtype says (they
        # read storage_dtype only); the port refuses instead of solving in
        # another dtype than the one asked for.
        raise ValueError(f"sharded solves are float32 (tpucg's run f32 whatever config.dtype "
                         f"says); got dtype={config.dtype}: use cg_solve for a float64 solve")
    _interval_static(interval, config)


# --- the lap's closures ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Reductions:
    """The sums over the ranks that the loops take (tpucg's
    ``_make_reductions``, ``sharded.py:75``, and its Grams), every one a
    single ``Mesh.rank_sum`` of this rank's partial:

    - ``dot(u, v, act)`` and ``update(x, r, p, ap, alpha, act)``: the
      classic lap's (``TorchLap``);
    - ``dots(pairs)``: every dot of a pipelined lap, stacked, in one sum;
    - ``gram(V)``: CA's basis Gram, the rank's V^T V summed in float64 and
      rounded to f32 once (the serial ``gram_f32`` on the partial sums);
    - ``dot_cols(U, V)``: the multi-RHS loop's columnwise dots (k,);
    - ``gram_kk(U, V)``: block CG's k x k U^T V."""

    dot: Callable
    update: Callable
    dots: Callable
    gram: Callable
    dot_cols: Callable
    gram_kk: Callable


def _reductions(mesh: Mesh, backend: str, like: torch.Tensor) -> _Reductions:
    """The rank-summed closures on ``backend``: K3 or K2 on this rank's
    block (their plain versions on the torch backend), one launch each,
    then ``Mesh.rank_sum``; the lap's scalars stay in torch ops on the
    summed values. On cuda the lap's calls write their sums into buffers
    owned here, and K2 updates x and r in place, as the serial cuda lap
    does. Calls without a flag (the pipelined lap's dots, the power method)
    take K3's checked wrapper."""
    rank_sum = mesh.rank_sum

    def gram(V):
        return rank_sum(V.T.to(torch.float64) @ V.to(torch.float64)).to(V.dtype)

    def dot_cols(U, V):
        return rank_sum((U * V).sum(0))

    def gram_kk(U, V):
        return rank_sum(U.T @ V)

    if backend == "cuda":
        stream = cuda_stream(like)
        d = torch.empty((), dtype=_F32, device=like.device)
        rr = torch.empty((), dtype=_F32, device=like.device)
        scratch = scratch_for(like)
        one = dot_cuda

        def dot(u, v, act):
            if act is None:
                return rank_sum(dot_cuda(u, v))
            dot_launch(u, v, scratch, d, act.data_ptr(), stream)
            return rank_sum(d)

        def update(x, r, p, ap, alpha, act):
            fused_update_launch(x, r, p, ap, alpha, x, r, scratch, rr, act.data_ptr(), stream)
            return x, r, rank_sum(rr)
    else:
        one = dot_torch

        def dot(u, v, act):
            return rank_sum(dot_torch(u, v))

        def update(x, r, p, ap, alpha, act):
            xn, rn, rr_ = fused_update_torch(x, r, p, ap, alpha)
            keep = act.bool()
            return torch.where(keep, xn, x), torch.where(keep, rn, r), rank_sum(rr_)

    def dots(pairs):
        total = rank_sum(torch.stack([one(u, v) for u, v in pairs]))
        return tuple(total[i] for i in range(len(pairs)))
    return _Reductions(dot, update, dots, gram, dot_cols, gram_kk)


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
    it; None without Jacobi) and the kind's statics (for WELL, as tpucg
    keeps them: ``m`` the rows a rank, ``offsets`` (bg, nsg); its arrays
    are the rank's packed arrays and their ``WellRows`` layout), and under
    block Jacobi the rank's raw diagonal blocks."""

    kind: str
    n: int
    npad: int
    arrays: tuple
    diag: Optional[torch.Tensor]
    m: int = 0
    m_padded: int = 0
    offsets: tuple = ()
    blocks: Optional[torch.Tensor] = None  # block Jacobi's (nbl, bs, bs), f32


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
    if sop.kind == "well":
        # tpucg's WELL arm (sharded.py:1252-1271): the direction gathered
        # whole (the pack's windows are global columns), then K13 for this
        # rank's rows alone; the pack was checked against x's length when
        # its layout was built (well_shard_block).
        vals, lidx, gidl, wrow, sgb, rows = sop.arrays
        bg, nsg = sop.offsets
        x_full = torch.empty(sop.npad, dtype=_F32, device=dev)

        def matvec(x, act):
            mesh.all_gather(x_full, x)
            out = _output(y, act)
            if backend == "cuda":
                well_spmv_launch(rows, x_full, out, blk, _flag(act), stream)
            else:
                y2 = well_spmv_torch(vals, lidx, gidl, wrow, sgb, x_full.reshape(-1, LANE), bg,
                                     nsg, index=rows)
                out.copy_(y2.reshape(-1)[:blk])
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


def _poisson_slab_multi(U: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        m: int) -> torch.Tensor:
    """``poisson3d_slab_torch`` on the k columns of U (blk, k) at once, the
    halos (m^2, k): each column equals the single-column plain version bit
    for bit (tpucg forces its XLA slab arm here, ``sharded.py:1318-1319``,
    so no kernel is owed)."""
    k = U.shape[1]
    v = U.reshape(-1, m, m, k)
    y = 6.0 * v
    y = y - torch.cat([v[1:], hi.reshape(1, m, m, k)], dim=0)
    y = y - torch.cat([lo.reshape(1, m, m, k), v[:-1]], dim=0)
    for axis in (1, 2):
        shape = list(v.shape)
        shape[axis] = 1
        zeros = v.new_zeros(shape)
        y = y - torch.cat([v.narrow(axis, 1, m - 1), zeros], dim=axis)
        y = y - torch.cat([zeros, v.narrow(axis, 0, m - 1)], dim=axis)
    return y.reshape(-1, k)


def _dia_halo_multi(data: torch.Tensor, offsets, X: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """``dia_spmv_halo_torch`` on the k columns of X (blk, k) at once, the
    halos (pad, k); each column equals the single-column plain version bit
    for bit."""
    pad, blk = lo.shape[0], X.shape[0]
    X_ext = torch.cat([lo, X, hi])
    Y = torch.zeros_like(X)
    for d, off in enumerate(offsets):
        Y = Y + data[d].to(_F32)[:, None] * X_ext[pad + int(off): pad + int(off) + blk]
    return Y


def _gather_rows(mesh: Mesh, X: torch.Tensor) -> torch.Tensor:
    """Every rank's (blk, k) block of rows, whole: (P blk, k) in rank order,
    one ``Mesh.all_gather``."""
    X = X.contiguous()
    out = torch.empty((X.shape[0] * mesh.size,) + tuple(X.shape[1:]), dtype=X.dtype,
                      device=X.device)
    mesh.all_gather(out.reshape(-1), X.reshape(-1))
    return out


def _dense_matvec_batched(A_blk: torch.Tensor, mesh: Mesh) -> Callable:
    """``mvm(X_blk, act)``, (blk, k) -> (blk, k), of a dense (blk, npad) row
    block (tpucg's ``_sharded_multi_jit``, ``sharded.py:292``): the (blk, k)
    direction block gathered whole in one call, then one product of the
    rank's rows with it (a GEMM, as the serial dense ``matvec_multi``)."""
    def mvm(X, act=None):
        return A_blk @ _gather_rows(mesh, X)
    return mvm


# --- the 2-D SUMMA decomposition ---------------------------------------------


def summa_pad(n: int, rows: int, cols: int) -> int:
    """The padded size of an R x C decomposition: a multiple of R C (the
    vectors' chunks) and of 8 C, so that a block's npad / C columns meet
    K1's column alignment on every backend. tpucg pads to lcm(R C, R align,
    C align) with align 1 on XLA, 128 under Pallas."""
    return round_up(n, math.lcm(rows * cols, cols * _COL_ALIGN))


def _colperm_2d(npad: int, R: int, C: int) -> np.ndarray:
    """A's column order in storage (tpucg's ``_colperm_2d``,
    ``sharded.py:1010``): rank (i, j) holds chunk k = i C + j of every
    vector, and its column group's gather puts chunks (0..R-1, j) in i
    order, so column block j of the stored A holds those chunks' columns
    in that order. Vectors, b and x stay in natural order."""
    cs = npad // (R * C)
    return np.concatenate([np.arange(k * cs, (k + 1) * cs)
                           for j in range(C) for k in (i * C + j for i in range(R))])


class DistributedSystem2D(NamedTuple):
    """This rank's share of a dense system on a ``Mesh2D`` (tpucg's
    ``distribute_system_2d`` result): ``A`` its (npad/R, npad/C) block of
    the padded, column-permuted A in the storage dtype, ``b`` and ``x0`` its
    chunk (npad/(R C),) in f32, and ``npad``."""

    A: torch.Tensor
    b: torch.Tensor
    x0: torch.Tensor
    npad: int


def distribute_system_2d(A, b, x0=None, mesh: Optional[Mesh2D] = None,
                         storage_dtype=torch.float32) -> DistributedSystem2D:
    """Pad (``summa_pad``, the identity tail), column-permute and place this
    rank's block of A and chunk of b and x0 on a 2-D mesh (tpucg's
    ``distribute_system_2d``, ``sharded.py:1105``);
    ``storage_dtype=torch.bfloat16`` stores the block in bf16 (f32 sums and
    vectors). No rank holds more of A on the device than its block."""
    if not isinstance(mesh, Mesh2D):
        raise TypeError(f"distribute_system_2d takes a Mesh2D, got {type(mesh).__name__}")
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    A = _host(A)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square, got {A.shape}")
    R, C = mesh.shape
    npad = summa_pad(n, R, C)
    rb, cb, cs = npad // R, npad // C, npad // (R * C)
    r0 = mesh.i * rb
    rows = _row_block(A[r0:min(r0 + rb, n)], n, npad, r0, r0 + rb)
    block = np.ascontiguousarray(rows[:, _colperm_2d(npad, R, C)[mesh.j * cb:(mesh.j + 1) * cb]])
    del rows
    b, x0 = _host_rhs(b, x0, n)
    c0, dev = mesh.rank * cs, mesh.device
    return DistributedSystem2D(
        A=torch.from_numpy(block).to(device=dev, dtype=storage_dtype),
        b=torch.from_numpy(_padded_block(b, n, npad, c0, c0 + cs)).to(dev),
        x0=torch.from_numpy(_padded_block(x0, n, npad, c0, c0 + cs)).to(dev), npad=npad)


def _row_sum_chunk(mesh: Mesh2D, partial: torch.Tensor) -> torch.Tensor:
    """tpucg's ``psum_scatter`` over the row group, in a fixed order: the
    row group's (npad/R, ...) partials gathered, added left to right in the
    group's rank order, and this rank's chunk j of the sum kept."""
    C = mesh.cols
    cs = partial.shape[0] // C
    parts = _gather_rows(mesh.row, partial).reshape((C,) + tuple(partial.shape))
    chunk = parts[:, mesh.j * cs:(mesh.j + 1) * cs]
    s = chunk[0]
    for c in range(1, C):
        s = s + chunk[c]
    return s


def _summa_matvec(A_blk: torch.Tensor, mesh: Mesh2D, backend: str) -> Callable:
    """``matvec(p_chunk, act)`` of the SUMMA GEMV (tpucg's ``_matvec_2d``,
    ``sharded.py:903``): p's chunks gathered within the column group (npad/C
    values), K1 on the rank's rectangular block (its bf16 form under bf16
    storage), the row group's partials summed in rank order and this rank's
    chunk kept. A group of one exchanges nothing: a 1 x 1 mesh is the 1-D
    one-rank product bit for bit."""
    R, C = mesh.shape
    rb, cb = A_blk.shape
    dev = A_blk.device
    part = torch.empty(rb, dtype=_F32, device=dev)
    y = torch.empty(rb // C, dtype=_F32, device=dev)
    p_cols = torch.empty(cb, dtype=_F32, device=dev)
    if backend == "cuda":
        check_matvec(A_blk)
        stream = cuda_stream(part)

        def gemv(x, out, act):
            gemv_launch(A_blk, x, out, _flag(act), stream)
    else:
        def gemv(x, out, act):
            out.copy_(matvec_torch(A_blk, x))

    def matvec(x, act):
        if R > 1:
            mesh.col.all_gather(p_cols, x)
            x = p_cols
        out = _output(y if C > 1 else part, act)
        if C == 1:
            gemv(x, out, act)
            return out
        gemv(x, part, act)
        out.copy_(_row_sum_chunk(mesh, part))
        return out
    return matvec


def _summa_matvec_batched(A_blk: torch.Tensor, mesh: Mesh2D) -> Callable:
    """``mvm(X_chunk, act)``, (cs, k) -> (cs, k), of the SUMMA product
    (tpucg's ``_matvec_2d_batched``, ``sharded.py:1570``): one (npad/C, k)
    gather in the column group, one (npad/R, npad/C) x (npad/C, k) product
    (a GEMM, as tpucg's ``jnp.matmul`` and the 1-D batched product), one
    fixed-order sum of the row group's (npad/R, k) partials."""
    A32 = A_blk.to(_F32)

    def mvm(X, act=None):
        if mesh.rows > 1:
            X = _gather_rows(mesh.col, X)
        part = A32 @ X
        return part if mesh.cols == 1 else _row_sum_chunk(mesh, part).contiguous()
    return mvm


def _operator_matvec_batched(sop: _ShardedOperator, mesh: Mesh, backend: str) -> Callable:
    """``mvm(X_blk, act)``, (blk, k) -> (blk, k), of a sharded sparse
    operator (tpucg's ``_operator_matvec_batched``, ``sharded.py:1284``): one
    (halo, k) exchange a call for Poisson and DIA, then the plain batched
    product (tpucg forces its XLA arms there, so no kernel is owed); X
    gathered whole for WELL, then K13 x k over the rank's ``WellRows``
    layout for its rows (``well_spmv_multi_torch`` on the CPU), and for ELL
    and BSR, then their plain k-column products."""
    dev = mesh.device
    blk = sop.npad // mesh.size
    if sop.kind == "poisson":
        m, mm = sop.m, sop.m * sop.m
        mp = blk // mm
        plane = mesh.rank * mp + torch.arange(mp, device=dev)
        keep = (plane < m).repeat_interleave(mm)[:, None]
        padded = sop.m_padded != m

        def mvm(X, act=None):
            U = X * keep if padded else X
            lo = U.new_zeros((mm, U.shape[1]))
            hi = U.new_zeros((mm, U.shape[1]))
            _halo_exchange(mesh, U[:mm].contiguous(), U[-mm:].contiguous(), lo, hi)
            Y = _poisson_slab_multi(U, lo, hi, m)
            return torch.where(keep, Y, X) if padded else Y
        return mvm
    if sop.kind == "dia":
        (data,) = sop.arrays
        offs = sop.offsets
        pad = halo_length(offs)

        def mvm(X, act=None):
            lo = X.new_zeros((pad, X.shape[1]))
            hi = X.new_zeros((pad, X.shape[1]))
            _halo_exchange(mesh, X[:pad].contiguous(), X[-pad:].contiguous(), lo, hi)
            return _dia_halo_multi(data, offs, X, lo, hi)
        return mvm
    if sop.kind == "well":
        rows = sop.arrays[5]
        stream = cuda_stream(rows.rvals) if backend == "cuda" else None

        def mvm(X, act=None):
            X_full = _gather_rows(mesh, X)
            if backend != "cuda":
                return well_spmv_multi_torch(rows, X_full, blk)
            Y = torch.empty((blk, X.shape[1]), dtype=_F32, device=dev)
            well_spmv_multi_launch(rows, X_full, Y, blk, _flag(act), stream)
            return Y
        return mvm
    values, indices = sop.arrays
    product = ell_spmv_multi if sop.kind == "ell" else bsr_ell_spmv_multi

    def mvm(X, act=None):
        return product(values, indices, _gather_rows(mesh, X))
    return mvm


def _precond(matvec, mesh: Mesh, backend: str, red: _Reductions, b_blk, diag, blocks,
             config: CGConfig, two_level=None) -> Optional[Callable]:
    """A sharded solve's preconditioner on this rank's block: Jacobi from
    ``diag``, block Jacobi from ``blocks`` (the rank's own), poly through
    the sharded closures, or the two-level cycle of
    ``make_two_level_precond_sharded``."""
    if two_level is not None:
        # The hierarchy's vectors are whole on every rank: its dots are this
        # rank's alone (K3's checked wrapper, or its plain version).
        one = dot_cuda if backend == "cuda" else dot_torch
        return make_two_level_precond_sharded(two_level, matvec, red.dot, b_blk, mesh,
                                              lambda u, v, act=None: one(u, v))
    minv = None
    if config.precondition == "jacobi":
        minv = torch.where(diag != 0, 1.0 / diag, 1.0)
    elif config.precondition == "block_jacobi":
        minv = invert_blocks(blocks)
    return make_precond(config.precondition, minv, matvec, red.dot, b_blk, config.poly_degree)


def _solve(matvec, mesh: Mesh, backend: str, b_blk, x0_blk, diag, blocks, config: CGConfig,
           maxiter: int, record_residuals: bool, chunk, interval, cg_converged: str,
           two_level=None) -> CGResult:
    """The method's loop on this rank's block with the sharded closures
    (``cg_loop`` for ``"cg"``, ``run_method`` for the others, as
    ``cg_solve`` runs them); x gathered whole (padded length). ``diag`` is
    Jacobi's diagonal and ``blocks`` block Jacobi's raw diagonal blocks,
    both this rank's. ``two_level`` is the cycle of
    ``make_two_level_precond_sharded``; classic CG then stops on the true
    residual every ``TRUE_CHECK_EVERY`` laps (tpucg's ``sharded.py:1410``).
    A cg solve's ``converged`` is ``cg_converged``: ``"done"`` (the dense
    solve's, tpucg's loop flag) or ``"rr"`` (the operator solve's, r.r <
    tol^2)."""
    red = _reductions(mesh, backend, b_blk)
    precond = _precond(matvec, mesh, backend, red, b_blk, diag, blocks, config, two_level)
    if config.method != "cg":
        x, k, rn, done = run_method(config, matvec, red.dot, red.dots, red.gram, b_blk, x0_blk,
                                    maxiter=maxiter, precond=precond,
                                    interval=_interval_static(interval, config), chunk=chunk)
        return CGResult(x=_gather_rows(mesh, x), iterations=k, residual_norm=rn,
                        converged=done)
    s = cg_loop(matvec, red.dot, TorchLap(red.dot, red.update), b_blk, x0_blk,
                tol=float(config.tol), maxiter=maxiter,
                safe_alpha=bool(config.safe_alpha), precond=precond,
                hist_len=maxiter if record_residuals else None, chunk=chunk,
                check_true_every=TRUE_CHECK_EVERY if two_level is not None else None)
    if cg_converged == "rr":
        converged = s.rslast < torch.tensor(float(config.tol), dtype=_F32,
                                            device=b_blk.device) ** 2
    else:
        converged = s.done
    return CGResult(x=_gather_rows(mesh, s.x), iterations=s.k, residual_norm=s.rslast.sqrt(),
                    converged=converged, residual_history=s.hist)


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


def _row_block(rows: np.ndarray, n: int, npad: int, r0: int, r1: int) -> np.ndarray:
    """Rows [r0, r1) of A padded to npad with its identity tail, without the
    padded whole (tpucg's ``load_system_sharded`` block, ``sharded.py:2473``);
    ``rows`` are A's rows [r0, min(r1, n))."""
    block = np.zeros((r1 - r0, npad), dtype=np.float32)
    block[: rows.shape[0], :n] = rows
    for i in range(max(r0, n), r1):
        block[i - r0, i] = 1.0
    return block


def _host(v, dtype=np.float32) -> np.ndarray:
    """An array or tensor as a host NumPy array of ``dtype``."""
    return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, dtype)


def _host_vector(v, n: int, name: str):
    """``v`` (or None) as a host f32 vector of length n."""
    if v is None:
        return None
    v = _host(v)
    if v.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {v.shape}")
    return v


def _host_rhs(b, x0, n: int):
    """b and x0 (or None) as host f32 vectors of length n."""
    return _host_vector(b, n, "b"), _host_vector(x0, n, "x0")


def _padded_block(v, n: int, npad: int, r0: int, r1: int) -> np.ndarray:
    out = np.zeros(npad, dtype=np.float32)
    if v is not None:
        out[:n] = np.asarray(v, np.float32)
    return out[r0:r1]


def distribute_system(A, b, x0=None, mesh: Optional[Mesh] = None,
                      part: Optional[RowPartition] = None, strategy: str = "allgather",
                      storage_dtype=torch.float32,
                      config: Optional[CGConfig] = None) -> DistributedSystem:
    """Pad this rank's rows of (A, b, x0) and place them on the mesh's
    device once (tpucg's ``distribute_system``, ``sharded.py:2409``; the
    bench times it apart). ``part`` defaults to ``RowPartition(n, P,
    pc_align(ROW_ALIGN, config))``: a solve under block Jacobi (``config``'s
    precondition) needs each rank's rows in whole blocks; ``strategy`` fixes
    the block's layout; ``storage_dtype=torch.bfloat16`` stores A's block in
    bf16 (f32 sums and vectors)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    mesh = make_mesh() if mesh is None else mesh
    check_1d(mesh, "distribute_system places row blocks of a 1-D mesh: use "
                   "distribute_system_2d on a 2-D mesh")
    A = _host(A)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square, got {A.shape}")
    if part is None:
        align = ROW_ALIGN if config is None else pc_align(ROW_ALIGN, config)
        part = RowPartition(n=n, num_shards=mesh.size, align=align)
    if part.n != n or part.num_shards != mesh.size or part.block_rows % ROW_ALIGN:
        raise ValueError(f"{part} does not partition n={n} over {mesh.size} ranks in rows of 8")
    r0, r1 = part.row_range(mesh.rank)
    b, x0 = _host_rhs(b, x0, n)
    return _place(A[r0:min(r1, n)], b, x0, part, strategy, mesh, storage_dtype)


def _place(rows: np.ndarray, b, x0, part: RowPartition, strategy: str, mesh: Mesh,
           storage_dtype=torch.float32) -> DistributedSystem:
    """This rank's ``DistributedSystem`` from A's rows [r0, min(r1, n)) and
    the whole b and x0 (or None): the block padded with its identity tail,
    laid out for ``strategy``, placed on the mesh's device."""
    n, npad, blk = part.n, part.n_padded, part.block_rows
    r0, r1 = part.row_range(mesh.rank)
    block = _row_block(rows, n, npad, r0, r1)
    if strategy == "overlap":
        block = np.ascontiguousarray(block.reshape(blk, mesh.size, blk).transpose(1, 0, 2))
    dev = mesh.device
    return DistributedSystem(
        A=torch.from_numpy(block).to(device=dev, dtype=storage_dtype),
        b=torch.from_numpy(_padded_block(b, n, npad, r0, r1)).to(dev),
        x0=torch.from_numpy(_padded_block(x0, n, npad, r0, r1)).to(dev),
        n=n, part=part, strategy=strategy, rank=mesh.rank, size=mesh.size,
    )


def load_system_sharded(matrix_path: str, rhs_path: str, x0_path: Optional[str] = None,
                        mesh: Optional[Mesh] = None, kernel: str = "auto",
                        strategy: str = "allgather",
                        config: Optional[CGConfig] = None) -> DistributedSystem:
    """Host-sharded loading of a dense system (tpucg's
    ``load_system_sharded``, ``sharded.py:2441``): this rank parses only its
    own rows of the matrix file (``load_matrix_rows``: the native range
    parser on f32 text, a memory map on ``.npy``) and places its
    ``DistributedSystem``, which ``sharded_cg_solve`` takes as it is. No
    rank holds the whole of A; each holds the O(n) b and x0. The row
    alignment and identity tail are ``distribute_system``'s, so the result
    equals ``distribute_system(*load_system(...))`` bit for bit. Beside
    tpucg's arguments: ``strategy`` (the port lays a block out by strategy,
    tpucg does not) and ``config`` (block Jacobi aligns the partition to
    ``pc_block_size``, as ``distribute_system``'s ``config`` does).
    ``kernel`` is checked and otherwise unused: every backend aligns rows to
    ``ROW_ALIGN``."""
    from tpucg_torch.io.textio import load_matrix_rows, load_vector

    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    mesh = make_mesh() if mesh is None else mesh
    check_1d(mesh, "load_system_sharded takes a 1-D mesh (the 2-D SUMMA arm distributes from "
                   "host arrays)")
    resolve_backend(kernel, mesh.device)
    b = load_vector(rhs_path)
    n = int(b.size)
    x0 = None if x0_path is None else load_vector(x0_path, n=n)
    align = ROW_ALIGN if config is None else pc_align(ROW_ALIGN, config)
    part = RowPartition(n=n, num_shards=mesh.size, align=align)
    r0, r1 = part.row_range(mesh.rank)
    rows = load_matrix_rows(matrix_path, min(r0, n), min(r1, n), n)
    return _place(rows, b, x0, part, strategy, mesh)


def _own_square(system: DistributedSystem) -> torch.Tensor:
    """The (blk, blk) square of the block's own column block, where its
    diagonal lies (tpucg's ``_jacobi_minv_blk``, ``sharded.py:629``), in
    either layout, in A's storage dtype."""
    A, r = system.A, system.rank
    blk = system.part.block_rows
    return A[r] if system.strategy == "overlap" else A[:, r * blk:(r + 1) * blk]


def _square_blocks(sq: torch.Tensor, bs: int) -> torch.Tensor:
    """The (blk / bs, bs, bs) diagonal blocks of a rank's own (blk, blk)
    square (tpucg's ``_local_diag_blocks``, ``sharded.py:613``; the
    partition keeps bs | blk), widened to f32."""
    nb = sq.shape[0] // bs
    blocks = sq.reshape(nb, bs, nb, bs).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    return blocks.to(_F32).contiguous()


def _local_diag_blocks(system: DistributedSystem, bs: int) -> torch.Tensor:
    """This rank's diagonal blocks of a placed dense system, either layout."""
    return _square_blocks(_own_square(system), bs)


def _check_pc_blocks(config: CGConfig, part: RowPartition) -> None:
    """A placed system whose rank blocks are not whole bs-blocks cannot run
    block Jacobi (tpucg's ``ValueError``, ``sharded.py:2816-2826``): it is
    distributed again, never re-padded here."""
    if config.precondition == "block_jacobi" and part.block_rows % config.pc_block_size:
        raise ValueError(f"pre-sharded A's padding is incompatible with pc_block_size="
                         f"{config.pc_block_size} (shard block {part.block_rows} rows); "
                         "redistribute without pre-sharding")


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
    ``precondition`` ``"none"``, ``"jacobi"``, ``"block_jacobi"`` (the
    rank's own diagonal blocks of ``pc_block_size``, inverted once; the
    partition aligns to them, ``pc_align``) or ``"poly"``; ``method``
    ``"cg"``, ``"pipelined"``, ``"ca"`` (``s_step``) or ``"chebyshev"``
    (``check_every``), with ``interval=(lam_lo, lam_hi)`` for the last two,
    each reporting its fields as the serial solve does. ``storage_dtype``
    f32 or bf16 (f32 sums and vectors; the solve then meets the f32
    contract on the bf16-rounded system). ``mesh`` defaults to
    ``make_mesh()``; ``kernel="auto"`` runs K1, K2 and K3 on a CUDA mesh and
    their plain versions on a CPU one. Every rank returns the same result,
    with x whole, trimmed to ``n`` (default: the system's).

    On a ``Mesh2D`` the solve runs the SUMMA decomposition (tpucg's 2-D
    arm, ``sharded.py:2759``): A whole on the host (``distribute_system_2d``
    places each rank's block), every method, precondition none, jacobi (the
    un-permuted A's diagonal) or poly, ``record_residuals`` and bf16
    storage; ``n=``, ``interval=`` and block Jacobi raise tpucg's
    ``ValueError``."""
    config = _configure(config, overrides)
    _check_supported(config, interval, record_residuals=record_residuals)
    mesh = make_mesh() if mesh is None else mesh
    check_mesh(mesh)
    backend = resolve_backend(config.kernel, mesh.device)
    if isinstance(mesh, Mesh2D):
        return _sharded2d_solve(A, b, x0, mesh, config, backend, n, interval, record_residuals,
                                storage_dtype, chunk)
    system, n, diag = _place_dense_1d(A, b, x0, mesh, config, n, storage_dtype)
    _check_pc_blocks(config, system.part)
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    matvec = _dense_matvec(system.A, system.strategy, mesh, backend)
    blocks = _local_diag_blocks(system, int(config.pc_block_size)) \
        if config.precondition == "block_jacobi" else None
    res = _solve(matvec, mesh, backend, system.b, system.x0, diag, blocks, config, maxiter,
                 record_residuals, chunk, interval, "done")
    return res._replace(x=res.x[:n])


def _place_dense_1d(A, b, x0, mesh: Mesh, config: CGConfig, n=None,
                    storage_dtype=torch.float32):
    """This rank's share of a dense system on a 1-D mesh, shared by the
    plain and checkpointed solves: a ``DistributedSystem`` checked against
    the mesh, the strategy and the storage dtype, or host arrays placed by
    ``distribute_system``. Returns (the system, n: the system's unless
    given, Jacobi's diagonal of the rank's own rows or None)."""
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
                                   storage_dtype=storage_dtype, config=config)
    diag = torch.diagonal(_own_square(system)).to(_F32) if config.precondition == "jacobi" \
        else None
    return system, system.n if n is None else int(n), diag


def _prepare_sharded2d(A, b, x0, mesh: Mesh2D, config: CGConfig, storage_dtype=torch.float32):
    """Place a dense host system on a 2-D mesh and this rank's chunk of
    Jacobi's diagonal (tpucg's ``_prepare_sharded2d``, ``sharded.py:2856``:
    the un-permuted A's diagonal, 1 on the identity tail; None without
    Jacobi); shared by the plain, deflated, MINRES and checkpointed 2-D
    solves. Returns (the placed system, the diagonal chunk, n)."""
    if isinstance(A, (DistributedSystem, DistributedSystem2D)):
        raise ValueError("the 2-D SUMMA arm takes host arrays (the column permutation is applied "
                         "at distribution)")
    if b is None:
        raise ValueError("b is required")
    A = _host(A)
    system = distribute_system_2d(A, b, x0, mesh, storage_dtype)
    diag = _diag_chunk(A, system.npad, mesh) if config.precondition == "jacobi" else None
    return system, diag, A.shape[0]


def _diag_chunk(A: np.ndarray, npad: int, mesh: Mesh2D) -> torch.Tensor:
    """This rank's chunk of the padded, un-permuted A's diagonal (1 on the
    identity tail), f32 on the mesh's device."""
    d = np.ones(npad, np.float32)
    d[:A.shape[0]] = np.diag(A)
    cs = npad // mesh.size
    return torch.from_numpy(d[mesh.rank * cs:(mesh.rank + 1) * cs]).to(mesh.device)


def _check_2d_config(config: CGConfig, n=None, interval=None) -> None:
    """tpucg's refusals of its 2-D arm (``sharded.py:2762-2775``)."""
    if n is not None:
        raise ValueError("n override is for pre-padded 1-D inputs")
    if interval is not None:
        raise ValueError("interval caching is implemented for the 1-D decompositions (the 2-D "
                         "SUMMA arm re-estimates per solve)")
    if config.precondition == "block_jacobi":
        raise ValueError("precondition='block_jacobi' is supported on 1-D meshes (the 2-D "
                         "decomposition stores column-permuted blocks)")


def _sharded2d_solve(A, b, x0, mesh: Mesh2D, config: CGConfig, backend: str, n, interval,
                     record_residuals: bool, storage_dtype, chunk) -> CGResult:
    """``sharded_cg_solve``'s 2-D arm (tpucg's ``_sharded2d_solve``,
    ``sharded.py:2888``, and ``_sharded2d_cg_jit``): the 1-D solve's loops
    on the SUMMA product and the world's dots."""
    _check_2d_config(config, n, interval)
    system, diag, n = _prepare_sharded2d(A, b, x0, mesh, config, storage_dtype)
    matvec = _summa_matvec(system.A, mesh, backend)
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    res = _solve(matvec, mesh, backend, system.b, system.x0, diag, None, config, maxiter,
                 record_residuals, chunk, None, "done")
    return res._replace(x=res.x[:n])


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


def _diag_blocks_sharded(offsets, data: np.ndarray, num: int, bs: int) -> np.ndarray:
    """Shard-aligned diagonal blocks of a canonical (ndiag, npad) DIA slab
    (tpucg's ``_diag_blocks_sharded``, ``sharded.py:2103``, host set-up in
    NumPy): the bs-block grid restarts at every shard's first row (npad /
    ``num`` rows a shard), so no block crosses a shard; a shard's grid tail
    (bs not dividing its rows) takes identity rows. Returns the raw (num *
    ceil(blk / bs), bs, bs) blocks, shard by shard."""
    ndiag, npad = data.shape
    blk = npad // num
    if blk * num != npad:
        raise ValueError(f"num={num} must divide the slab's {npad} rows")
    nbl = -(-blk // bs)
    D = np.zeros((ndiag, num, nbl * bs), np.float32)
    D[:, :, :blk] = np.asarray(data, np.float32).reshape(ndiag, num, blk)
    blocks = np.zeros((num, nbl, bs, bs), np.float32)
    for d, off in enumerate(int(o) for o in offsets):
        if abs(off) >= bs:
            continue  # never lands inside a bs-block
        rs = np.arange(max(0, -off), bs - max(0, off))
        blocks[:, :, rs, rs + off] = D[d].reshape(num, nbl, bs)[..., rs]
    if nbl * bs != blk:
        # Cross-shard band entries the slice carried into the tail are cut,
        # then the virtual rows are identity.
        tail = np.arange(nbl * bs).reshape(nbl, bs) >= blk
        cut = tail[None, :, :, None] | tail[None, :, None, :]
        blocks = np.where(cut, 0.0, blocks)
        blocks += np.eye(bs, dtype=np.float32)[None, None] * tail[None, :, :, None]
    return blocks.reshape(num * nbl, bs, bs)


def _poisson_dia_rows(m: int, npad: int):
    """The DIA rows (offsets, (7, npad) f32) of the plane-padded 3-D
    7-point Laplacian that the slab decomposition applies, pad planes
    identity (tpucg's ``_poisson_dia_rows``, ``sharded.py:2137``): block
    Jacobi's set-up input for ``_diag_blocks_sharded``."""
    N = m ** 3
    i = np.arange(npad)
    offsets = [0]
    rows = [np.where(i < N, 6.0, 1.0).astype(np.float32)]
    for off, ok_fwd in ((1, (i % m) != m - 1), (m, ((i // m) % m) != m - 1),
                        (m * m, (i // (m * m)) != m - 1)):
        fwd = np.where(ok_fwd & (i + off < N) & (i < N), -1.0, 0.0)
        bwd = np.zeros(npad, np.float32)
        bwd[off:] = fwd[:-off]
        offsets += [off, -off]
        rows += [fwd.astype(np.float32), bwd]
    return offsets, np.stack(rows)


def _rank_blocks(offsets, data: np.ndarray, mesh: Mesh, bs: int) -> np.ndarray:
    """This rank's share of ``_diag_blocks_sharded(offsets, data, P, bs)``,
    computed from its own rows alone (the grid restarts at its first row,
    so the blocks are the same)."""
    blk = data.shape[1] // mesh.size
    return _diag_blocks_sharded(offsets, data[:, mesh.rank * blk:(mesh.rank + 1) * blk], 1, bs)


def _prepare_sharded_operator(op, mesh: Mesh, config: CGConfig,
                              storage_dtype=torch.float32) -> _ShardedOperator:
    """Pad the operator for the mesh and place this rank's block on its
    device (tpucg's ``_prepare_sharded_operator``, ``sharded.py:2158``)."""
    P, rank, dev = mesh.size, mesh.rank, mesh.device
    kind_name = type(op).__name__
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    jacobi = config.precondition == "jacobi"
    bs = int(config.pc_block_size) if config.precondition == "block_jacobi" else None
    if isinstance(op, WellShardedSystem):
        # Placed by load_well_system_sharded: nothing to pack or place.
        if storage_dtype != torch.float32:
            raise ValueError("storage_dtype=bfloat16 is not supported on pre-sharded WELL systems "
                             "yet (cast at pack time instead)")
        if bs is not None:
            raise ValueError("precondition='block_jacobi' needs the source CSR; pre-sharded WELL "
                             "systems support 'none'/'jacobi'/two_level")
        if (op.rank, op.size) != (rank, P) or op.block.arrays[0].device != dev:
            raise ValueError(f"system was packed for rank {op.rank} of {op.size} shards on "
                             f"{op.block.arrays[0].device}, the mesh is {mesh!r}")
        rps = op.statics["rps"]
        diag = (torch.from_numpy(op.diag[rank * rps:(rank + 1) * rps].copy()).to(dev) if jacobi
                else None)
        return dataclasses.replace(op.block, diag=diag)
    if kind_name in ("WellOperator", "WellMatrix"):
        # tpucg's else branch (sharded.py:2388-2392): a serial pack holds no
        # row blocks against global columns.
        raise TypeError(f"sharded_operator_cg_solve cannot re-shard a serial {kind_name}: pass "
                        "the source CSRMatrix (irregular -> sharded WELL)")
    if storage_dtype != torch.float32 and not (
            isinstance(op, DiaOperator) or kind_name in ("DIAMatrix", "CSRMatrix")):
        raise ValueError("storage_dtype=bfloat16 is supported for DIA and WELL operators (the "
                         "stencil is matrix-free; ELL/BSR index arrays dominate their "
                         f"footprint), got {kind_name}")

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    if isinstance(op, PoissonOperator):
        m = op.m
        m_padded = round_up(m, P)
        npad = m_padded * m * m
        blk = npad // P
        diag = blocks = None
        if jacobi:
            d = np.ones(npad, np.float32)
            d[: op.n] = 6.0
            diag = put(d[rank * blk:(rank + 1) * blk])
        if bs is not None:
            blocks = put(_rank_blocks(*_poisson_dia_rows(m, npad), mesh, bs))
        return _ShardedOperator("poisson", op.n, npad, (), diag, m=m, m_padded=m_padded,
                                blocks=blocks)
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
        blocks = None
        if bs is not None:
            # From the canonical slab as stored (a bf16 slab widened), as
            # tpucg takes them (sharded.py:2301-2304).
            blocks = put(_rank_blocks(offsets, data.to(_F32).cpu().numpy(), mesh, bs))
        return _ShardedOperator("dia", n, npad, (block.to(storage_dtype).contiguous(),), diag,
                                offsets=tuple(offsets), blocks=blocks)
    if kind_name == "CSRMatrix":
        return _well_block(op, mesh, jacobi, storage_dtype, bs)
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
    raise TypeError("sharded_operator_cg_solve supports Poisson, DIA, ELL and BSR operators "
                    f"and CSRMatrix (irregular -> sharded WELL), got {kind_name}")


def well_shard_block(stacked: dict, statics: dict, rank: int, n: int, device,
                     storage_dtype=torch.float32, diag=None) -> _ShardedOperator:
    """Rank ``rank``'s block of a sharded WELL operator of logical size
    ``n`` from ``csr_to_well_sharded``'s ``(stacked, statics)`` (this
    package's or tpucg's): slice [rank] of each stacked array on
    ``device``, the values in ``storage_dtype`` (bf16 runs K13's bf16
    instantiation), checked against x's length, and K13's layout of those
    rows, built once. ``diag`` is the block's diagonal for Jacobi."""
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
    npad, bg, nsg = int(statics["npad"]), int(statics["bg"]), int(statics["nsg"])

    def put(name, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(stacked[name][rank]),
                                                     dtype=dtype)).to(device)

    vals = put("vals", np.float32).to(storage_dtype)
    lidx, gidl, wrow, sgb = (put(k, np.int8 if k == "lidx" else np.int32)
                             for k in ("lidx", "gidl", "wrow", "sgb"))
    check_well(vals, lidx, gidl, wrow, sgb, bg, nsg)
    check_well_values(lidx, gidl, wrow, sgb, bg, nsg, npad // LANE)
    rows = well_rows(vals, lidx, gidl, wrow, sgb, bg, nsg)
    return _ShardedOperator("well", int(n), npad, (vals, lidx, gidl, wrow, sgb, rows), diag,
                            m=int(statics["rps"]), offsets=(bg, nsg))


def _well_block(csr, mesh: Mesh, jacobi: bool, storage_dtype,
                bs: Optional[int] = None) -> _ShardedOperator:
    """tpucg's sharded WELL preparation (``sharded.py:2340-2387``): every
    rank packs the row blocks on the host (``csr_to_well_sharded``) and
    places its own; Jacobi's diagonal is the CSR's, summed in float64, 1
    where it is 0 and on the identity tail; block Jacobi's blocks (``bs``)
    are the CSR's shard-aligned ones (``csr_diagonal_blocks``), this
    rank's share."""
    from tpucg_torch.sparse.formats import csr_diagonal_blocks
    from tpucg_torch.sparse.well import csr_to_well_sharded

    n = int(csr.shape[0])
    stacked, st = csr_to_well_sharded(csr, mesh.size)
    diag = None
    if jacobi:
        coo = csr.to_coo()
        on = coo.row == coo.col
        dv = np.zeros(n, np.float64)
        np.add.at(dv, coo.row[on], coo.data[on].astype(np.float64))
        d = np.ones(st["npad"], np.float32)
        d[:n] = np.where(dv != 0, dv, 1.0).astype(np.float32)
        rps = st["rps"]
        diag = torch.from_numpy(d[mesh.rank * rps:(mesh.rank + 1) * rps]).to(mesh.device)
    sop = well_shard_block(stacked, st, mesh.rank, n, mesh.device, storage_dtype, diag)
    if bs is None:
        return sop
    blocks = csr_diagonal_blocks(csr, bs, npad=st["npad"], shards=mesh.size)
    nbl = blocks.shape[0] // mesh.size
    mine = np.ascontiguousarray(blocks[mesh.rank * nbl:(mesh.rank + 1) * nbl])
    return dataclasses.replace(sop, blocks=torch.from_numpy(mine).to(mesh.device))


@dataclasses.dataclass(frozen=True)
class WellShardedSystem:
    """This rank's share of an irregular system loaded host-sharded
    (tpucg's ``WellShardedSystem``, ``sharded.py:2529``): ``block`` the
    rank's WELL pack on the mesh's device (a ``"well"`` block as
    ``sharded_operator_cg_solve`` runs it), ``statics`` its sizes (rps, npad,
    bg, nsg, and the mesh-wide ``block_sublanes`` and ``n_sublanes``), ``b``
    and ``x0`` the rank's rows (f32, on the device), ``diag`` the (npad,)
    f32 operator diagonal (host, summed over the ranks, 1 on the identity
    tail and where it is 0), ``bytes_read`` the matrix bytes this rank read,
    ``two_level`` the cycle built from the parts (``two_level_agg``) or
    None, and ``rank``/``size`` the mesh's."""

    block: "_ShardedOperator"
    statics: dict
    n: int
    npad: int
    b: torch.Tensor
    x0: torch.Tensor
    diag: np.ndarray
    bytes_read: int
    two_level: Optional[object]
    rank: int
    size: int


def load_well_system_sharded(matrix_path: str, rhs_path: Optional[str] = None,
                             x0_path: Optional[str] = None, mesh: Optional[Mesh] = None,
                             groups_per_super: int = 64, two_level_agg: Optional[int] = None,
                             smooth_degree: int = 1) -> WellShardedSystem:
    """Host-sharded loading of an irregular system (tpucg's
    ``load_well_system_sharded``, ``sharded.py:2545``): this rank reads only
    its rows of an indexed general ``.mtx`` (``load_matrix_market_rows``:
    one byte range; ``build_mm_index`` or ``expand_matrix_market`` index a
    file once) and packs them into WELL against global columns
    (``local_rows_to_well_shard``), ``rps = ceil(n / (P 128)) 128`` rows a
    rank; a rank wholly in the identity tail packs an empty COO. Two
    agreements over the ranks (``Mesh.host_max``): rank 0's adaptive
    stream block governs every rank, and every pack is padded to the
    largest sublane count. The diagonal is each rank's float64 part, summed
    (``Mesh.host_sum``). ``rhs_path``/``x0_path``: ``.npy`` (memory-mapped)
    or MatrixMarket; every rank holds the O(n) vectors, not the O(nnz)
    matrix. ``two_level_agg`` builds the two-level cycle from the same parts
    (``build_two_level_from_parts``), smoother ``smooth_degree``."""
    from tpucg_torch.io.mmio import load_matrix_market, load_matrix_market_rows, mm_index_path
    from tpucg_torch.sparse.formats import COOMatrix
    from tpucg_torch.sparse.well import local_rows_to_well_shard, pad_well_shard

    mesh = make_mesh() if mesh is None else mesh
    check_1d(mesh, "load_well_system_sharded takes a 1-D mesh")
    with np.load(mm_index_path(matrix_path)) as z:
        n, ncol = int(z["nrow"]), int(z["ncol"])
    if n != ncol:
        raise ValueError(f"matrix is {n}x{ncol}, CG needs square SPD")
    P, rank = mesh.size, mesh.rank
    rps = -(-n // (P * LANE)) * LANE
    npad = P * rps
    g0 = rank * rps
    r1 = min(n, g0 + rps)
    bytes_read = 0
    if r1 > g0:
        coo, _, bytes_read = load_matrix_market_rows(matrix_path, g0, r1)
    else:  # the rank lies wholly in the identity tail
        coo = COOMatrix(row=np.empty(0, np.int64), col=np.empty(0, np.int64),
                        data=np.empty(0, np.float32), shape=(rps, npad))
    # Rank 0 picks the stream block adaptively; every rank follows it.
    w = (local_rows_to_well_shard(coo, 0, rps, npad, n, None, groups_per_super)
         if rank == 0 else None)
    BS = int(mesh.host_max(np.asarray([0 if w is None else w.block_sublanes], np.int64))[0])
    if w is None:
        w = local_rows_to_well_shard(coo, rank, rps, npad, n, BS, groups_per_super)
    NS = int(mesh.host_max(np.asarray([w.n_sublanes], np.int64))[0])
    packed = pad_well_shard(w, NS)
    statics = dict(rps=rps, npad=npad, bg=int(groups_per_super), nsg=w.n_supergroups,
                   block_sublanes=BS, n_sublanes=NS)
    block = well_shard_block({k: v[None] for k, v in packed.items()}, statics, 0, n, mesh.device)
    # The diagonal from the rank's rows, summed over the ranks: O(npad)
    # floats, not the O(nnz) matrix.
    diag_part = np.zeros(npad, np.float64)
    on_d = (coo.row + g0) == coo.col
    np.add.at(diag_part, coo.col[on_d], coo.data[on_d].astype(np.float64))
    diag = mesh.host_sum(diag_part)
    diag[n:npad] = 1.0
    diag = np.where(diag != 0, diag, 1.0).astype(np.float32)

    def rows(path):
        v = np.zeros(npad, np.float32)
        if path is not None:
            vals = np.load(path, mmap_mode="r") if path.endswith(".npy") \
                else load_matrix_market(path)
            vals = np.asarray(vals, np.float32).ravel()
            if vals.size != n:
                raise ValueError(f"{path!r}: expected {n} values, got {vals.size}")
            v[:n] = vals
        return torch.from_numpy(v[g0:g0 + rps].copy()).to(mesh.device)

    b, x0 = rows(rhs_path), rows(x0_path)
    tl = None
    if two_level_agg is not None:
        # The coarse build from the same parts: it never sees the whole
        # matrix either.
        if rps % int(two_level_agg):
            raise ValueError(f"two_level_agg={two_level_agg} must divide rows-per-shard ({rps})")
        tl = build_two_level_from_parts([(g0, coo)], n=n, npad=npad, agg_size=int(two_level_agg),
                                        smooth_degree=smooth_degree, diag=diag, mesh=mesh)
    return WellShardedSystem(block=block, statics=statics, n=n, npad=npad, b=b, x0=x0, diag=diag,
                             bytes_read=int(bytes_read), two_level=tl, rank=rank, size=P)


def _check_two_level_sharded(two_level, config: CGConfig, npad: int, mesh: Mesh) -> None:
    """tpucg's refusals of a sharded two-level solve (``sharded.py:1984-2007``):
    the cycle preconditions a cg or pipelined solve, was built for the
    sharded padding, and its aggregates divide a rank's rows (so none
    crosses a rank); here it also lives on the mesh's device."""
    if config.method not in ("cg", "pipelined") or config.precondition != "none":
        raise ValueError("two_level runs as THE preconditioner of a method='cg' or 'pipelined' "
                         f"solve (got method={config.method!r}, "
                         f"precondition={config.precondition!r})")
    if two_level.npad != npad:
        raise ValueError(f"two_level was built for padded size {two_level.npad}, the sharded "
                         f"decomposition pads to {npad} -- rebuild with build_two_level(csr, "
                         f"agg_size={two_level.agg}, npad={npad})")
    if (npad // mesh.size) % two_level.agg:
        raise ValueError(f"agg_size={two_level.agg} must divide rows-per-shard "
                         f"({npad // mesh.size}) so aggregates stay shard-local")
    if two_level.device != mesh.device:
        raise ValueError(f"two_level lives on {two_level.device}, the mesh on {mesh.device}")


def sharded_operator_cg_solve(
    op,
    b=None,
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
    - ``CSRMatrix`` (irregular sparsity): row blocks of WELL
      (``csr_to_well_sharded``: 128-row aligned, identity-padded, columns
      global), x gathered whole, K13 on the rank's rows; the values in f32
      or, with ``storage_dtype=torch.bfloat16``, bf16. A serial
      ``WellOperator`` cannot be re-sharded and raises ``TypeError``: pass
      its CSR;
    - ``EllOperator`` / ``EllMatrix`` and ``BsrOperator`` / ``BSRMatrix``:
      row blocks (identity-padded to P) and x gathered whole;
    - ``WellShardedSystem`` (``load_well_system_sharded``): the rank's
      placed WELL block; ``b`` and ``x0`` default to the loader's.

    Precondition ``"none"``, ``"jacobi"``, ``"block_jacobi"`` (Poisson, DIA
    and WELL: the shard-aligned diagonal blocks, taken on the host, each
    rank inverting its own once; ELL and BSR raise tpucg's ``ValueError``)
    or ``"poly"``; ``method`` and ``interval`` as ``sharded_cg_solve``'s.
    ``two_level`` (``build_two_level`` with ``npad`` the sharded padding, or
    ``build_two_level_from_parts``; on the mesh's device) is the
    preconditioner of a ``method="cg"`` or ``"pipelined"`` solve with
    ``precondition="none"``, its aggregates dividing a rank's rows
    (``make_two_level_precond_sharded``); classic CG then stops on the true
    residual every ``TRUE_CHECK_EVERY`` laps. Every rank returns the same
    result, x whole. A cg solve's ``converged`` is r.r < tol^2, as tpucg's;
    the other methods report their own."""
    config = _configure(config, overrides)
    _check_supported(config, interval, record_residuals)
    mesh = make_mesh() if mesh is None else mesh
    check_1d(mesh, DENSE_2D)
    backend = resolve_backend(config.kernel, mesh.device)
    sop = _prepare_sharded_operator(op, mesh, config, storage_dtype)
    if config.precondition == "block_jacobi" and sop.blocks is None:
        raise ValueError("precondition='block_jacobi' on sharded operators is implemented for "
                         "Poisson/DIA/WELL (shard-local diagonal blocks); ELL/BSR support "
                         "'none', 'jacobi', or 'poly'")
    if two_level is not None:
        _check_two_level_sharded(two_level, config, sop.npad, mesh)
    b_blk, x0_blk = operator_rhs(op, sop, b, x0, mesh)
    maxiter = int(config.maxiter if config.maxiter is not None else sop.n)
    matvec = _operator_matvec(sop, mesh, backend)
    res = _solve(matvec, mesh, backend, b_blk, x0_blk, sop.diag, sop.blocks, config, maxiter,
                 record_residuals, chunk, interval, "rr", two_level)
    return res._replace(x=res.x[:sop.n])


def operator_rhs(op, sop: _ShardedOperator, b, x0, mesh: Mesh):
    """This rank's rows of b and x0 for a sharded operator, padded with the
    identity tail's zeros, f32 on the mesh's device; a
    ``WellShardedSystem``'s own b and x0 where they are not given (tpucg's
    ``sharded.py:2025-2032``)."""
    blk = sop.npad // mesh.size
    r0, r1 = mesh.rank * blk, (mesh.rank + 1) * blk
    placed = isinstance(op, WellShardedSystem)
    if b is None and not placed:
        raise ValueError("b is required (only a WellShardedSystem carries its own)")

    def rows(v):
        return torch.from_numpy(_padded_block(v, sop.n, sop.npad, r0, r1)).to(mesh.device)
    b_blk = op.b if b is None else rows(_host_vector(b, sop.n, "b"))
    if x0 is None and placed:
        return b_blk, op.x0
    return b_blk, rows(_host_vector(x0, sop.n, "x0"))


# --- k right-hand sides: multi-RHS and block CG --------------------------------


_OPERATOR_NAMES = ("PoissonOperator", "DiaOperator", "DIAMatrix", "EllOperator", "EllMatrix",
                   "BsrOperator", "BSRMatrix", "CSRMatrix", "WellOperator", "WellMatrix",
                   "WellShardedSystem")


def is_operator(A) -> bool:
    """A sparse or stencil operator (tpucg's ``_operator_types``, plus the
    serial WELL forms, which ``_prepare_sharded_operator`` refuses by
    name, and a host-sharded ``WellShardedSystem``)."""
    return type(A).__name__ in _OPERATOR_NAMES


def _rhs_blocks(B, X0, n: int, npad: int, mesh: Mesh):
    """This rank's rows of B and X0 (n, k) (X0 None: zeros), padded to
    npad with zero rows (the identity tail's exact solution), as f32 (blk,
    k) blocks on the mesh's device; and k."""
    B = _host(B)
    if B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"B must have shape ({n}, k), got {B.shape}")
    k = B.shape[1]
    X0 = np.zeros((n, k), np.float32) if X0 is None else _host(X0)
    if X0.shape != (n, k):
        raise ValueError(f"X0 must have shape ({n}, {k}), got {X0.shape}")
    blk = npad // mesh.size
    r0, r1 = mesh.rank * blk, (mesh.rank + 1) * blk

    def rows(V):
        out = np.zeros((npad, k), np.float32)
        out[:n] = V
        return torch.from_numpy(np.ascontiguousarray(out[r0:r1])).to(mesh.device)
    return rows(B), rows(X0), k


class _KColumns(NamedTuple):
    """A multi-RHS or block solve's share on this rank: the batched closure
    ``mv``, the (blk, k) B and X0, n, npad and k; its own (blk, blk) square
    of a dense A (Jacobi's diagonal, block Jacobi's blocks), or its
    Jacobi diagonal from the sharded operator (None without Jacobi)."""

    mv: Callable
    B: torch.Tensor
    X0: torch.Tensor
    n: int
    npad: int
    k: int
    square: Optional[torch.Tensor]
    diag: Optional[torch.Tensor]


def _k_columns(A, B, X0, mesh: Mesh, config: CGConfig) -> _KColumns:
    if isinstance(mesh, Mesh2D):
        # tpucg's _sharded2d_multi / _sharded2d_block (sharded.py:1702,
        # :1737): the SUMMA product on k columns, the diagonal un-permuted.
        if is_operator(A):
            raise ValueError(DENSE_2D)
        A = _host(A)
        n = A.shape[0]
        system = distribute_system_2d(A, np.zeros(n, np.float32), None, mesh)
        B_blk, X0_blk, k = _rhs_blocks(B, X0, n, system.npad, mesh)
        return _KColumns(_summa_matvec_batched(system.A, mesh), B_blk, X0_blk, n, system.npad,
                         k, None, _diag_chunk(A, system.npad, mesh))
    if is_operator(A):
        sop = _prepare_sharded_operator(A, mesh, config)
        n, npad, square, diag = sop.n, sop.npad, None, sop.diag
        mv = _operator_matvec_batched(sop, mesh, resolve_backend(config.kernel, mesh.device))
    else:
        A = _host(A)
        n = A.shape[0]
        if A.shape != (n, n):
            raise ValueError(f"A must be square, got {A.shape}")
        rp = RowPartition(n=n, num_shards=mesh.size, align=pc_align(ROW_ALIGN, config))
        npad = rp.n_padded
        r0, r1 = rp.row_range(mesh.rank)
        A_blk = torch.from_numpy(_row_block(A[r0:min(r1, n)], n, npad, r0, r1)).to(mesh.device)
        mv = _dense_matvec_batched(A_blk, mesh)
        square = A_blk[:, r0:r1]
        diag = torch.diagonal(square)
    B_blk, X0_blk, k = _rhs_blocks(B, X0, n, npad, mesh)
    return _KColumns(mv, B_blk, X0_blk, n, npad, k, square, diag)


def sharded_cg_solve_multi(
    A,
    B,
    X0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    *,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B for the k columns of B (n, k) with A's rows in blocks
    over the mesh's ranks (tpucg's ``sharded_cg_solve_multi``,
    ``sharded.py:323``, and its operator arm ``_sharded_operator_multi``,
    ``:1816``): k independent CG recurrences in lockstep (``multi_cg_loop``)
    on one (blk, k) product a lap, their columnwise dots summed over the
    ranks in one ``rank_sum`` each.

    ``A`` is a dense array or tensor (its rank's rows times the (npad, k)
    direction block, gathered whole in one call) or a sparse operator as
    ``sharded_operator_cg_solve`` takes it: Poisson and DIA exchange (halo,
    k) blocks, WELL runs K13 x k on the gathered block, ELL and BSR their
    plain products. On a ``Mesh2D`` a dense ``A`` runs the SUMMA product on
    (cs, k) chunks (``_summa_matvec_batched``); operators raise tpucg's
    ``ValueError``. Method cg with precondition none only (tpucg's
    ``ValueError`` otherwise). Result fields are batched: ``x`` (n, k);
    ``iterations``, ``residual_norm`` and ``converged`` (k,), each
    column's."""
    config = _configure(config, overrides)
    if config.method != "cg" or config.precondition != "none":
        raise ValueError("sharded_cg_solve_multi supports method='cg', precondition='none'")
    _check_supported(config)
    mesh = make_mesh() if mesh is None else mesh
    check_mesh(mesh)
    kc = _k_columns(A, B, X0, mesh, config)
    red = _reductions(mesh, resolve_backend(config.kernel, mesh.device), kc.B[:, 0])
    s = multi_cg_loop(kc.mv, kc.B, kc.X0, tol=float(config.tol),
                      maxiter=int(config.maxiter if config.maxiter is not None else kc.n),
                      safe_alpha=bool(config.safe_alpha), chunk=chunk, dot_cols=red.dot_cols)
    return CGResult(x=_gather_rows(mesh, s.X)[:kc.n], iterations=s.its,
                    residual_norm=s.rslast.sqrt(), converged=s.done)


def sharded_cg_solve_block(
    A,
    B,
    X0=None,
    mesh: Optional[Mesh] = None,
    config: Optional[CGConfig] = None,
    *,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Solve A X = B by true block CG with A's rows in blocks over the
    mesh's ranks (tpucg's ``sharded_cg_solve_block``, ``sharded.py:509``:
    ``_sharded_block_jit``, ``:413``, and the operator arm
    ``_sharded_operator_block``, ``:1841``): ``block_cg_loop`` /
    ``block_pcg_loop`` on the batched closure of
    ``sharded_cg_solve_multi``, every k x k Gram one ``rank_sum`` of the
    rank's U^T V, the k x k algebra on the replicated sums.

    Preconditioners, by tpucg's routes: ``"jacobi"`` as the two scalings
    around the product (the column scale before the gather, the row scale
    after); ``"block_jacobi"`` (dense only: operators raise tpucg's
    ``ValueError``) as the rank's diagonal blocks' M^-1/2 around it
    (``sqrt_pair_blocks``); ``"poly"`` runs ``block_pcg_loop`` with
    lambda_max from the power method on column 0 through the batched
    closure. On a ``Mesh2D`` a dense ``A`` runs the SUMMA product, its Grams
    summed over every rank, with none, jacobi or poly (tpucg's
    ``_sharded2d_block``). k <= ``BLOCK_CG_MAX_K``. Result fields as
    ``cg_solve_block``'s:
    ``iterations`` the shared laps (0-d), ``residual_norm`` and
    ``converged`` (k,)."""
    config = _configure(config, overrides)
    if config.method != "cg" or config.precondition not in (
            "none", "jacobi", "block_jacobi", "poly"):
        raise ValueError("sharded_cg_solve_block supports method='cg' with precondition "
                         "'none', 'jacobi', 'block_jacobi', or 'poly'")
    mesh = make_mesh() if mesh is None else mesh
    check_mesh(mesh)
    if isinstance(mesh, Mesh2D):
        if is_operator(A):
            raise ValueError(DENSE_2D)
        if config.precondition == "block_jacobi":
            raise ValueError("2-D block CG supports precondition in {'none', 'jacobi', 'poly'} "
                             "(block Jacobi is 1-D-only: the 2-D decomposition stores "
                             "column-permuted blocks)")
    if is_operator(A) and config.precondition == "block_jacobi":
        raise ValueError("block CG on sharded sparse operators supports precondition in "
                         "{'none', 'jacobi', 'poly'} (block Jacobi on sharded sparse operators "
                         "is unimplemented, matching sharded_operator_cg_solve)")
    _check_supported(config)
    kc = _k_columns(A, B, X0, mesh, config)
    if kc.k > BLOCK_CG_MAX_K:
        raise ValueError(f"block CG supports k <= {BLOCK_CG_MAX_K} right-hand sides (got "
                         f"{kc.k}); use sharded_cg_solve_multi for wide batches")
    red = _reductions(mesh, resolve_backend(config.kernel, mesh.device), kc.B[:, 0])
    mv, gram = kc.mv, red.gram_kk
    loop = dict(tol=float(config.tol),
                maxiter=int(config.maxiter if config.maxiter is not None else kc.n), chunk=chunk)
    pc = config.precondition
    if pc == "jacobi":
        sc = torch.sqrt(torch.where(kc.diag != 0, 1.0 / kc.diag, 1.0))[:, None]
        k_, Y, rr, done = block_cg_loop(lambda Y, act=None: sc * mv(sc * Y, act), gram,
                                        sc * kc.B, kc.X0 / sc, **loop)
        X = sc * Y
    elif pc == "block_jacobi":
        blk = kc.npad // mesh.size
        isq, sq = sqrt_pair_blocks(_square_blocks(kc.square, int(config.pc_block_size)))
        sapp, sqapp = make_block_apply(isq, blk), make_block_apply(sq, blk)
        k_, Y, rr, done = block_cg_loop(lambda Y, act=None: sapp(mv(sapp(Y), act)), gram,
                                        sapp(kc.B), sqapp(kc.X0), **loop)
        X = sapp(Y)
    elif pc == "poly":
        lam = lambda_max_estimate(lambda p, act=None: mv(p[:, None])[:, 0], red.dot,
                                  kc.B[:, 0])
        pcb = _poly_block(mv, 0.95 / lam, int(config.poly_degree))
        k_, X, rr, done = block_pcg_loop(mv, gram, pcb, kc.B, kc.X0, **loop)
    else:
        k_, X, rr, done = block_cg_loop(mv, gram, kc.B, kc.X0, **loop)
    return CGResult(x=_gather_rows(mesh, X)[:kc.n], iterations=k_, residual_norm=rr.sqrt(),
                    converged=done)
