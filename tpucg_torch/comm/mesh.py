"""Process groups of the distributed solves (the counterpart of
``tpucg.comm.mesh``).

The reference's process model is P MPI ranks (``MPI_Init``/``Comm_size``,
``parallel_cg.c:76-82``); tpucg's multi-process mode runs one JAX process
per host (``comm/mesh.py:23``). The port runs one process per rank under
``torch.distributed``: NCCL between cards, gloo on the CPU. A ``Mesh`` is
the 1-D row axis of a solve: the process group, this process's rank and the
world size, its device and the backend. A world of one rank is a real
process group too, so one rank runs the code of P ranks.

The transport, for what the solves exchange:

- ``all_gather`` and ``rank_sum`` (the dots: each rank's partial gathered,
  then summed in rank order, the same on every rank, so every rank holds
  the bit-identical scalar and runs repeat; no ``all_reduce``);
- ``sendrecv``, the point-to-point halos and the ring, to and from
  neighbouring ranks;
- ``host_sum`` and ``host_max`` of small host arrays (tpucg's
  ``_sum_across_processes`` and ``_max_across_processes``, the agreements
  of host-sharded loading and the distributed two-level build), the same
  bits on every rank.

On NCCL every exchange is ordered on the current CUDA stream: the host
never waits for it. gloo takes CUDA tensors in its collectives but refuses
them in send and receive (on the H100's torch 2.11: "writev ... Bad
address"), so a gloo mesh on a card copies the point-to-point buffers
through pinned host memory; ``repr(mesh)`` says so. That path is chosen by
the backend, which the caller names: gloo on a card is never a fallback for
NCCL. NCCL refuses two ranks on one card: ranks that share a card run gloo.

A ``Mesh2D`` (tpucg's ``make_mesh2d``) lays the world's R x C ranks out
row-major, rank r = i C + j, for the 2-D SUMMA decomposition: beside the
world's ``Mesh`` it holds this rank's column group (ranks i' C + j, the
direction's gather) and its row group (ranks i C + j', the partial
products' sum), each a ``Mesh`` of its own on the world's device and
backend, counting into the world's ``stats``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpucg_torch.kernels.dispatch import require_card

ROWS_AXIS = "rows"
COLS_AXIS = "cols"

# torch 2.13 names the gathering collective all_gather_single; the card's
# torch (2.11) knows it as all_gather_into_tensor only.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def default_device(device=None) -> torch.device:
    """A mesh's device: ``cuda:<LOCAL_RANK>`` unless the caller names one. A
    CUDA device with no card raises."""
    device = torch.device("cuda", _local_rank()) if device is None else torch.device(device)
    if device.type == "cuda":
        require_card("a CUDA mesh")
        if device.index is None:
            device = torch.device("cuda", _local_rank())
    return device


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Start this process's rank (the reference's ``MPI_Init``). No-op when
    the default process group exists.

    Under ``torchrun`` the rank and world come from its environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); otherwise
    pass ``init_method`` (``"file://<path>"`` or ``"tcp://localhost:<free
    port>"``), ``world_size`` and ``rank``; with none of them and no
    torchrun, the process is a world of one rank (an in-process store). The
    backend is NCCL for a CUDA ``device`` (default: the card, which raises
    when there is none) and gloo for ``device='cpu'``, or the one named."""
    given = (init_method, world_size, rank)
    if any(v is not None for v in given) and any(v is None for v in given):
        raise ValueError("pass init_method, world_size and rank together (or none of them)")
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if default_device(device).type == "cuda" else "gloo"
    kw = dict(backend=backend)
    if init_method is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            kw["init_method"] = "env://"
        else:
            kw.update(store=dist.HashStore(), world_size=1, rank=0)
    else:
        kw.update(init_method=init_method, world_size=int(world_size), rank=int(rank))
    if backend == "nccl":
        torch.cuda.set_device(default_device(device))
    dist.init_process_group(**kw)


class _Handle:
    """Exchanges in flight: ``wait()`` orders their completion before what
    the current stream does next (NCCL), or returns once they are done (gloo),
    then copies staged receives back to the card."""

    def __init__(self, works, unstage, keep, mesh, t0):
        self._works, self._unstage, self._keep, self._mesh, self._t0 = (
            works, unstage, keep, mesh, t0)

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        for dst, host in self._unstage:
            dst.copy_(host)
        self._keep = None  # the staged sends' host buffers may go now
        self._mesh._count(self._t0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D row mesh (tpucg's ``ROWS_AXIS``): ``size``
    ranks of ``group`` (None: the world), this process's ``rank``, its
    ``device`` and the group's ``backend``. ``stats`` counts the transport's
    calls and the host seconds spent in them (on NCCL, enqueue time
    only)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str
    stats: dict = dataclasses.field(default_factory=lambda: {"calls": 0, "seconds": 0.0},
                                    compare=False, repr=False)

    @property
    def staged(self) -> bool:
        """Point-to-point buffers go through pinned host memory: gloo on a
        card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        transport = ("gloo, point-to-point through pinned host memory" if self.staged
                     else self.backend)
        return (f"Mesh({ROWS_AXIS}: rank {self.rank} of {self.size} on {self.device}, "
                f"transport {transport})")

    def _count(self, t0: float) -> None:
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """``out`` (size * k,) = every rank's ``inp`` (k,), in rank order."""
        t0 = time.perf_counter()
        _all_gather(out, inp, group=self.group)
        self._count(t0)
        return out

    def rank_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``partial`` (any shape and dtype: a
        dot, a pipelined lap's stacked dots, a Gram): every rank's partial
        gathered into (size, *shape), then the rows added left to right in
        rank order (no all_reduce, whose order of summation is NCCL's), so
        every rank holds the same bits. One rank's sum is its partial, bit
        for bit."""
        parts = torch.empty((self.size,) + tuple(partial.shape), dtype=partial.dtype,
                            device=partial.device)
        self.all_gather(parts.reshape(-1), partial.contiguous().reshape(-1))
        s = parts[0]
        for i in range(1, self.size):
            s = s + parts[i]
        return s

    def host_sum(self, arr: np.ndarray) -> np.ndarray:
        """The sum over the ranks of a host array (tpucg's
        ``_sum_across_processes``): ``rank_sum`` on the mesh's device, in
        the array's dtype (float64 for the two-level build's coarse
        matrix), so every rank holds the same bits. One rank's is its
        array."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return self.rank_sum(t).cpu().numpy()

    def host_max(self, arr: np.ndarray) -> np.ndarray:
        """The elementwise max over the ranks of a host array (tpucg's
        ``_max_across_processes``): every rank's gathered, then the max."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        parts = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        self.all_gather(parts.reshape(-1), t.reshape(-1))
        return parts.amax(dim=0).cpu().numpy()

    def sendrecv(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]) -> _Handle:
        """Post point-to-point sends of (tensor, peer rank) and receives
        into (tensor, peer rank), all at once; ``wait()`` the handle before
        reading a receive or writing a sent tensor. Contiguous tensors."""
        t0 = time.perf_counter()
        ops: List[dist.P2POp] = []
        unstage, keep = [], []
        for t, peer in sends:
            if self.staged:
                t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                keep.append(t)
            ops.append(dist.P2POp(dist.isend, t, peer, group=self.group))
        for t, peer in recvs:
            if self.staged:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                unstage.append((t, host))
                t = host
            ops.append(dist.P2POp(dist.irecv, t, peer, group=self.group))
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Handle(works, unstage, keep, self, t0)


def make_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    """The 1-D mesh of this process's world (started by ``init_distributed``
    when it is not yet). ``device`` defaults to
    ``cuda:<LOCAL_RANK>`` (the card of this rank); pass ``device="cpu"`` for
    a CPU mesh. ``backend``, when given, must be the group's: a mesh never
    runs another transport than the one asked for."""
    device = default_device(device)
    init_distributed(backend=backend, device=device)
    actual = dist.get_backend()
    if backend is not None and actual != backend:
        raise ValueError(f"the process group runs {actual!r}, the mesh asked for {backend!r}")
    if actual == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group=None, rank=dist.get_rank(), size=dist.get_world_size(), device=device,
                backend=actual)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's view of an R x C mesh (tpucg's ``make_mesh2d``, axes
    ``ROWS_AXIS`` and ``COLS_AXIS``): the ``world`` (rank r = i C + j in
    row-major order), the ``col`` group of rank (i, j) (its R ranks i' C +
    j, this rank's place i) and its ``row`` group (its C ranks i C + j',
    place j). The world's collectives (``all_gather``, ``rank_sum`` over
    all R C ranks in rank order, ``host_sum``, ``host_max``) are the mesh's
    own, so the dots and gathers of the 1-D solves run on it unchanged; all
    three groups count into the world's ``stats``."""

    world: Mesh
    rows: int
    cols: int
    col: Mesh
    row: Mesh

    rank = property(lambda self: self.world.rank)
    size = property(lambda self: self.world.size)
    device = property(lambda self: self.world.device)
    backend = property(lambda self: self.world.backend)
    stats = property(lambda self: self.world.stats)
    staged = property(lambda self: self.world.staged)
    shape = property(lambda self: (self.rows, self.cols))

    @property
    def i(self) -> int:
        """This rank's mesh row."""
        return self.rank // self.cols

    @property
    def j(self) -> int:
        """This rank's mesh column."""
        return self.rank % self.cols

    def __repr__(self) -> str:
        transport = ("gloo, point-to-point through pinned host memory" if self.staged
                     else self.backend)
        return (f"Mesh2D({ROWS_AXIS} x {COLS_AXIS} = {self.rows} x {self.cols}: rank "
                f"{self.rank} = ({self.i}, {self.j}) on {self.device}, transport {transport})")

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        return self.world.all_gather(out, inp)

    def rank_sum(self, partial: torch.Tensor) -> torch.Tensor:
        return self.world.rank_sum(partial)

    def host_sum(self, arr: np.ndarray) -> np.ndarray:
        return self.world.host_sum(arr)

    def host_max(self, arr: np.ndarray) -> np.ndarray:
        return self.world.host_max(arr)


def make_mesh2d(rows: int, cols: int, device=None, backend: Optional[str] = None) -> Mesh2D:
    """The rows x cols mesh of this process's world (tpucg's
    ``make_mesh2d``), which must hold rows * cols ranks; device and backend
    as ``make_mesh``'s. Every rank creates the column groups, then the row
    groups, in the same order (``dist.new_group`` is collective)."""
    rows, cols = int(rows), int(cols)
    if rows < 1 or cols < 1:
        raise ValueError(f"a 2-D mesh needs rows, cols >= 1, got {rows}x{cols}")
    world = make_mesh(device, backend)
    if rows * cols > world.size:
        raise ValueError(f"requested {rows}x{cols} mesh, only {world.size} ranks")
    if rows * cols != world.size:
        raise ValueError(f"a {rows}x{cols} mesh spans {rows * cols} ranks; this world has "
                         f"{world.size}: the port's 2-D mesh is the whole world")

    def group(ranks):
        return None if len(ranks) == world.size else dist.new_group(ranks)

    col_groups = [group([i * cols + j for i in range(rows)]) for j in range(cols)]
    row_groups = [group([i * cols + j for j in range(cols)]) for i in range(rows)]
    i, j = world.rank // cols, world.rank % cols

    def sub(g, rank, size):
        return Mesh(group=g, rank=rank, size=size, device=world.device,
                    backend=world.backend, stats=world.stats)
    return Mesh2D(world=world, rows=rows, cols=cols, col=sub(col_groups[j], i, rows),
                  row=sub(row_groups[i], j, cols))
