"""The gather probes of ``benchmarks/probe_gather.py``, P1-P7, as Hopper
kernels; ``csrc/probe.cu`` holds them and their design note.

On the TPU the probes asked which gathers Mosaic lowers inside a kernel
and how fast they run, and their answers chose K13's layout. Here they
measure where a gather should read from on an H100, for K13's redesign. No
solve runs them. All rows are 128 f32 wide and all indices int32:

- P1 ``lane_gather``: ``o[i, j] = v[i, idx[i, j]]`` (a lane gather in
  shared memory); P7 (the script's ``lg_big``) is the same function, and
  kernel, over 8192 rows: a warp a row, 16-byte loads and stores;
  ``lane_gather_plan`` picks the warps a block.
- P2 ``sub_gather``: ``o[i, j] = v[idx[i, j], j]`` (a gather down the
  columns); ``sub_gather_plan`` picks its form by the shape: a block stages
  its 8 columns of v in shared memory where it reuses them over enough
  rows of idx, else each thread gathers an element from L2.
- P3 ``row_gather``: ``o[i, :] = x2[ridx[i], :]`` (whole rows), a warp a
  row in blocks of 8 warps; bound by two dependent round trips to L2 (the
  index, then the row). At its floor: fewer warps a block, several rows a
  warp and L2-only reads tied or lost.
- P4 ``elem_gather``: ``o = xf[eidx]`` (single elements of a flat vector),
  bound by the same two round trips and a 32-byte sector through L2 an
  element. ``elem_gather_plan`` keeps the parent's element a thread below
  2 waves of threads, and from there streams: 2 elements a thread, the
  indices and o evict-first, so the table stays in L2 (FEM 300k 1.5x).
  Smaller blocks, L2-only table reads and more elements a thread at the
  script's shape lost.
- P5 ``dynslice``: ``o = sum_k x2[w[k]:w[k] + 8, :]``, summed in k order
  from 0 (windows at offsets known only at run time); ``dynslice_plan``
  says how its windows are brought in by bulk copies before the first add.
- P6 ``roll_dyn``: ``o[i, j] = x[i, (j - s) mod 128]`` with ``s`` a
  one-element int32 tensor read by the kernel (``pltpu.roll``'s direction,
  which is ``jnp.roll``'s): a warp a row on ``lane_gather_plan``, the row
  rotated by shuffles.

Each probe has a checked ``*_cuda`` wrapper, a plain ``*_torch`` version
(no read back to the host) and a dispatcher that sends CUDA tensors to the
kernel and CPU tensors to the plain version. Every wrapper and plain
version counts its calls in ``.launches``. Indices are not checked, on
the card or off it, as the TPU probes did not check them: an index out of
range reads outside the table on the card and raises in the plain version.
The tensors read or written 16 bytes at a time or by bulk copies (P1's and
P2's v, idx and o, P3's and P5's x2, P6's x and o) must be 16-byte
aligned: a misaligned view is refused, never copied. What each kernel
tried and lost, with its times, is in ``csrc/probe.cu``'s note.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import cuda_stream, resolve_backend

LANE = 128
ROW_BYTES = 4 * LANE
WINDOW = 8          # rows of a P5 window
MAX_WINDOWS = 1024  # P5 windows a launch (csrc/probe.cu kMaxWindows)
SMS = 132           # an H100 SXM's SMs: the plans' default

# P1/P7 (csrc/probe.cu kLgMaxWarps): a warp a row, at most LG_MAX_WARPS
# warps a block; the plan takes LG_WARPS, or half as many for small inputs.
LG_MAX_WARPS = 16
LG_WARPS = 8
# P5's (kDs*): windows a stage, stages in flight, their mbarriers.
DS_STAGE_WINDOWS = 64
DS_MAX_SLOTS = 4
DS_BAR_BYTES = 8 * DS_MAX_SLOTS
# P2's (kSg*): a staged block owns SG_COLS columns of v, so its slab is
# v_rows x 32 bytes and holds at most SG_MAX_ROWS rows within a block's
# BLOCK_SMEM; a block takes up to SG_MAX_THREADS threads.
BLOCK_SMEM = 232_448  # 227 KB (csrc/probe.cu kMaxSmem)
SG_COLS = 8
SG_GROUPS = LANE // SG_COLS
SG_MAX_ROWS = BLOCK_SMEM // (4 * SG_COLS)
SG_MAX_THREADS = 256
# sub_gather_plan's rule, fitted to bench/p2_forms.py's sweep on an H100:
# the staged form where v_rows <= SG_STAGED_RATIO * rows, on a power of two
# of runs near sqrt(SG_RUN_BALANCE * rows / v_rows).
SG_STAGED_RATIO = 0.75
SG_RUN_BALANCE = 17
# P3's and P4's block (kThreads; P3: a warp a row), and the elements a
# thread of P4's streaming walk (kEgStreamPer), which its plan takes from
# EG_STREAM_PER_SM elements an SM (2 waves of 2048 threads).
THREADS = 256
EG_STREAM_PER = 2
EG_STREAM_PER_SM = 2 * 2048


def _check(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """``t`` is a contiguous, non-empty ``dtype`` tensor of ``shape`` (None:
    any extent on that axis)."""
    ok = (t.dtype == dtype and t.dim() == len(shape) and t.is_contiguous() and t.numel() > 0
          and all(want is None or want == got for want, got in zip(shape, t.shape)))
    if not ok:
        want = "(" + ", ".join("*" if s is None else str(s) for s in shape) + ")"
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} of shape {want}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _aligned(fn: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (16-byte
    accesses and bulk copies touch it)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned, got a view "
                             f"{t.data_ptr() % 16} bytes off")


def _on_card(fn: str, tensors, like: torch.Tensor) -> None:
    if any(t.device != like.device for t in tensors) or like.device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _launch(fn: str, entry: str, tensors, args, like: torch.Tensor) -> None:
    """Launch the C entry point ``entry`` on ``tensors`` (pointers, in order)
    and the integers ``args`` on the current stream; raise on a refused
    launch."""
    _on_card(fn, tensors, like)
    err = getattr(_lib.load(), entry)(*(t.data_ptr() for t in tensors), *args, cuda_stream(like))
    if err:
        _lib.check(err, fn)


# ---- P1 (and P7): lane gather ---------------------------------------------------


def lane_gather_torch(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``take_along_axis(v, idx, axis=1)``."""
    lane_gather_torch.launches += 1
    return torch.gather(v, 1, idx.long())


@dataclasses.dataclass(frozen=True)
class LaneGatherPlan:
    """How P1/P7's kernel covers ``rows`` rows: a warp a row, ``warps``
    warps a block, warp w of block b taking row ``b * warps + w``."""

    rows: int
    warps: int

    @property
    def blocks(self) -> int:
        return -(-self.rows // self.warps)

    def row(self, b: int, w: int) -> int:
        """The row of warp w of block b (``rows`` or more: none)."""
        return b * self.warps + w

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block: a 512-byte row a warp."""
        return self.warps * ROW_BYTES

    def __str__(self) -> str:
        return (f"{self.blocks} blocks of {self.warps} warps, a row a warp, "
                f"{self.smem} shared bytes a block")


def lane_gather_plan(rows: int, sms: int = SMS) -> LaneGatherPlan:
    """P1/P7's plan: ``LG_WARPS`` warps a block where that gives every one
    of ``sms`` SMs a block (P7's 8192 rows: 1024 blocks), else half as many
    (P1's 256 rows: 64 blocks of 4 warps, not 32 of 8)."""
    if rows < 1 or sms < 1:
        raise ValueError(f"lane_gather_plan needs rows and sms >= 1, got {rows}, {sms}")
    return LaneGatherPlan(rows, LG_WARPS if rows >= LG_WARPS * sms else LG_WARPS // 2)


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def lane_gather_cuda(v: torch.Tensor, idx: torch.Tensor,
                     _plan: LaneGatherPlan | None = None) -> torch.Tensor:
    """P1 on the card: v f32 and idx int32, both (rows, 128) and 16-byte
    aligned, on ``lane_gather_plan`` (``_plan`` forces one)."""
    _check("lane_gather_cuda", "v", v, torch.float32, (None, LANE))
    _check("lane_gather_cuda", "idx", idx, torch.int32, tuple(v.shape))
    _aligned("lane_gather_cuda", v=v, idx=idx)
    _on_card("lane_gather_cuda", (v, idx), v)
    rows = v.shape[0]
    plan = _plan or lane_gather_plan(rows, _sms(v))
    if plan.rows != rows:
        raise ValueError(f"lane_gather_cuda: a plan for {plan.rows} rows, given {rows}")
    o = torch.empty_like(v)
    _aligned("lane_gather_cuda", o=o)
    _launch("lane_gather_cuda", "tpucg_probe_lane_gather_f32", (v, idx, o), (rows, plan.warps), v)
    lane_gather_cuda.launches += 1
    return o


def lane_gather(v: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P1: the kernel for CUDA tensors (``"auto"``), the plain version for
    CPU ones."""
    if resolve_backend(backend, v.device) == "cuda":
        return lane_gather_cuda(v, idx)
    return lane_gather_torch(v, idx)


# ---- P2: sublane gather ---------------------------------------------------------


def sub_gather_torch(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P2: ``take_along_axis(v, idx, axis=0)``."""
    sub_gather_torch.launches += 1
    return torch.gather(v, 0, idx.long())


@dataclasses.dataclass(frozen=True)
class SubGatherPlan:
    """How P2's kernel covers o (``rows`` x 128) from a v of ``v_rows``
    rows, in blocks of ``threads`` threads (a multiple of 32). ``run > 0``:
    the staged form, block b owning column group ``b % SG_GROUPS``
    (``SG_COLS`` columns) over ``run`` rows of idx from ``(b // SG_GROUPS)
    * run``, its group's slab of v in shared memory. ``run == 0``: the
    direct form, thread t of block b taking o's element ``b * threads +
    t``."""

    v_rows: int
    rows: int
    run: int
    threads: int

    @property
    def staged(self) -> bool:
        return self.run > 0

    @property
    def blocks(self) -> int:
        if self.staged:
            return SG_GROUPS * -(-self.rows // self.run)
        return -(-self.rows * LANE // self.threads)

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block: the staged form's slab."""
        return self.v_rows * 4 * SG_COLS if self.staged else 0

    def quads(self, b: int):
        """(rows, columns) of the runs of 4 elements of o that block b
        writes, o[r, c:c + 4] (a direct block's threads cover whole runs)."""
        if self.staged:
            first = b // SG_GROUPS * self.run
            it = torch.arange(2 * min(self.run, self.rows - first))
            return first + it // 2, SG_COLS * (b % SG_GROUPS) + 4 * (it % 2)
        at = torch.arange(b * self.threads, min((b + 1) * self.threads, self.rows * LANE), 4)
        return at // LANE, at % LANE

    def __str__(self) -> str:
        if self.staged:
            return (f"staged: {self.blocks} blocks of {self.threads} threads, {SG_GROUPS} column "
                    f"groups of {SG_COLS} x {self.blocks // SG_GROUPS} runs of {self.run} idx "
                    f"rows, the group's slab of v in shared memory ({self.v_rows} rows, "
                    f"{self.smem} bytes a block)")
        return (f"direct: {self.blocks} blocks of {self.threads} threads, an element a thread "
                f"gathered from L2; v's {self.v_rows} rows (a slab holds at most "
                f"{SG_MAX_ROWS})")


def sub_gather_plan(v_rows: int, rows: int, sms: int = SMS) -> SubGatherPlan:
    """P2's plan for a v of ``v_rows`` rows and an idx of ``rows`` rows.

    Every staged block reads its group's whole slab of v (v_rows x 32
    bytes) through L2, so the staged form pays where each block reuses its
    slab over enough idx rows: where ``v_rows <= SG_STAGED_RATIO * rows``
    (and the slab fits, ``v_rows <= SG_MAX_ROWS``). Its runs balance the
    slab's reads (16 x runs slabs) against a block's serial share of idx (rows
    / runs): the largest power of two at most sqrt(SG_RUN_BALANCE x rows /
    v_rows), at most ``sms // 16`` (one wave), 256 threads a block. Else
    the direct form, each thread gathering an element from L2, on blocks
    of ``SG_MAX_THREADS``."""
    if v_rows < 1 or rows < 1 or sms < 1:
        raise ValueError(f"sub_gather_plan needs v_rows, rows and sms >= 1, got {v_rows}, "
                         f"{rows}, {sms}")
    if v_rows <= SG_MAX_ROWS and v_rows <= SG_STAGED_RATIO * rows:
        runs, most = 1, max(1, sms // SG_GROUPS)
        while 2 * runs <= most and (2 * runs) ** 2 * v_rows <= SG_RUN_BALANCE * rows:
            runs *= 2
        return SubGatherPlan(v_rows, rows, -(-rows // runs), SG_MAX_THREADS)
    return SubGatherPlan(v_rows, rows, 0, SG_MAX_THREADS)


def sub_gather_cuda(v: torch.Tensor, idx: torch.Tensor,
                    _plan: SubGatherPlan | None = None) -> torch.Tensor:
    """P2 on the card: v f32 (v_rows, 128), idx int32 (m, 128), both
    16-byte aligned, -> (m, 128), on ``sub_gather_plan`` (``_plan`` forces
    one)."""
    _check("sub_gather_cuda", "v", v, torch.float32, (None, LANE))
    _check("sub_gather_cuda", "idx", idx, torch.int32, (None, LANE))
    _aligned("sub_gather_cuda", v=v, idx=idx)
    _on_card("sub_gather_cuda", (v, idx), v)
    plan = _plan or sub_gather_plan(v.shape[0], idx.shape[0], _sms(v))
    if (plan.v_rows, plan.rows) != (v.shape[0], idx.shape[0]):
        raise ValueError(f"sub_gather_cuda: a plan for v of {plan.v_rows} rows and idx of "
                         f"{plan.rows}, given {v.shape[0]} and {idx.shape[0]}")
    o = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _aligned("sub_gather_cuda", o=o)
    _launch("sub_gather_cuda", "tpucg_probe_sub_gather_f32", (v, idx, o),
            (plan.v_rows, plan.rows, plan.run, plan.threads), v)
    sub_gather_cuda.launches += 1
    return o


def sub_gather(v: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P2: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, v.device) == "cuda":
        return sub_gather_cuda(v, idx)
    return sub_gather_torch(v, idx)


# ---- P3: row gather -------------------------------------------------------------


def row_gather_torch(x2: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """Plain version of P3: ``take(x2, ridx, axis=0)``."""
    row_gather_torch.launches += 1
    return x2[ridx.long()]


def row_gather_cuda(x2: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """P3 on the card: x2 f32 (rows, 128), 16-byte aligned, ridx int32 (m,)
    -> (m, 128)."""
    _check("row_gather_cuda", "x2", x2, torch.float32, (None, LANE))
    _check("row_gather_cuda", "ridx", ridx, torch.int32, (None,))
    if x2.data_ptr() % 16:
        raise ValueError("row_gather_cuda: x2 must be 16-byte aligned (float4 row loads)")
    o = torch.empty((ridx.shape[0], LANE), dtype=torch.float32, device=ridx.device)
    _launch("row_gather_cuda", "tpucg_probe_row_gather_f32", (x2, ridx, o), (ridx.shape[0],), x2)
    row_gather_cuda.launches += 1
    return o


def row_gather(x2: torch.Tensor, ridx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P3: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, x2.device) == "cuda":
        return row_gather_cuda(x2, ridx)
    return row_gather_torch(x2, ridx)


# ---- P4: element gather ---------------------------------------------------------


def elem_gather_torch(xf: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """Plain version of P4: ``take(xf, eidx)``, eidx's shape."""
    elem_gather_torch.launches += 1
    return xf[eidx.long()]


@dataclasses.dataclass(frozen=True)
class ElemGatherPlan:
    """How P4's kernel covers ``n`` elements of o: blocks of ``THREADS``
    threads, thread t of block b taking the ``per`` elements ``b * THREADS
    * per + j * THREADS + t`` (their indices loaded, then their gathers
    issued, before the first store); ``stream``: ``EG_STREAM_PER`` elements
    a thread, the indices read and o written evict-first, else one."""

    n: int
    stream: bool = False

    threads = THREADS

    @property
    def per(self) -> int:
        return EG_STREAM_PER if self.stream else 1

    @property
    def blocks(self) -> int:
        return -(-self.n // (self.threads * self.per))

    def taken(self, b: int, t: int) -> list:
        """The elements of thread t of block b (none at ``n`` or past it)."""
        first = b * self.threads * self.per + t
        return [e for e in range(first, first + self.per * self.threads, self.threads)
                if e < self.n]

    def __str__(self) -> str:
        walk = (f"{self.per} elements a thread, indices and o evict-first" if self.stream
                else "1 element a thread")
        return f"{self.blocks} blocks of {self.threads} threads, {walk}"


def elem_gather_plan(n: int, sms: int = SMS) -> ElemGatherPlan:
    """P4's plan for ``n`` elements on ``sms`` SMs: the parent's walk (an
    element a thread) below ``EG_STREAM_PER_SM x sms`` elements (2 waves of
    2048 threads an SM); from there the streaming walk, ``EG_STREAM_PER``
    elements a thread with the indices and o evict-first, which keeps the
    table in L2 while the indices stream through (FEM 300k's CSR columns
    1.5x, 1-2 M random reads 2.5%; it loses at the script's 32,768, where it
    leaves half the warps; PERF.md section 6)."""
    if n < 1 or sms < 1:
        raise ValueError(f"elem_gather_plan needs n and sms >= 1, got {n}, {sms}")
    return ElemGatherPlan(n, n >= EG_STREAM_PER_SM * sms)


def elem_gather_cuda(xf: torch.Tensor, eidx: torch.Tensor,
                     _plan: ElemGatherPlan | None = None) -> torch.Tensor:
    """P4 on the card: xf f32 (n,), eidx int32 of any shape -> eidx's shape,
    on ``elem_gather_plan`` (``_plan`` forces one)."""
    _check("elem_gather_cuda", "xf", xf, torch.float32, (None,))
    _check("elem_gather_cuda", "eidx", eidx, torch.int32, (None,) * eidx.dim())
    _on_card("elem_gather_cuda", (xf, eidx), xf)
    n = eidx.numel()
    plan = _plan or elem_gather_plan(n, _sms(xf))
    if plan.n != n:
        raise ValueError(f"elem_gather_cuda: a plan for {plan.n} elements, given {n}")
    o = torch.empty(eidx.shape, dtype=torch.float32, device=eidx.device)
    _launch("elem_gather_cuda", "tpucg_probe_elem_gather_f32", (xf, eidx, o),
            (n, int(plan.stream)), xf)
    elem_gather_cuda.launches += 1
    return o


def elem_gather(xf: torch.Tensor, eidx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P4: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, xf.device) == "cuda":
        return elem_gather_cuda(xf, eidx)
    return elem_gather_torch(xf, eidx)


# ---- P5: windows at run-time offsets --------------------------------------------


def dynslice_torch(w: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Plain version of P5: the (nw, 8, 128) windows gathered at once, then
    added one window at a time, in k order from 0, as the Pallas body's
    ``fori_loop`` adds them."""
    dynslice_torch.launches += 1
    rows = w.long()[:, None] + torch.arange(WINDOW, device=w.device)
    windows = x2[rows]
    acc = torch.zeros((WINDOW, LANE), dtype=x2.dtype, device=x2.device)
    for k in range(windows.shape[0]):
        acc = acc + windows[k]
    return acc


@dataclasses.dataclass(frozen=True)
class DynslicePlan:
    """How P5's kernel brings in ``nw`` windows: 8 blocks, block r summing
    output row r, one bulk copy a window into shared memory, ``stages``
    stages of ``DS_STAGE_WINDOWS`` windows, ``slots`` of them in flight;
    the adds run in k order."""

    nw: int
    stages: int
    slots: int

    def windows(self, c: int) -> range:
        """The windows of stage c."""
        return range(c * DS_STAGE_WINDOWS, min(self.nw, (c + 1) * DS_STAGE_WINDOWS))

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block: the slots, the offsets and the
        mbarriers."""
        return self.slots * DS_STAGE_WINDOWS * ROW_BYTES + 4 * MAX_WINDOWS + DS_BAR_BYTES

    def __str__(self) -> str:
        return (f"8 blocks, {self.stages} stages of {DS_STAGE_WINDOWS} windows by bulk copies, "
                f"{self.slots} in flight, {self.smem} shared bytes a block")


def dynslice_plan(nw: int) -> DynslicePlan:
    """P5's plan for ``1 <= nw <= MAX_WINDOWS`` windows: up to
    ``DS_MAX_SLOTS`` stages (128 KB) in flight, so 256 windows are
    requested at once and 1024 walk a ring of 4."""
    if not 1 <= nw <= MAX_WINDOWS:
        raise ValueError(f"dynslice_plan takes 1 <= nw <= {MAX_WINDOWS}, got {nw}")
    stages = -(-nw // DS_STAGE_WINDOWS)
    return DynslicePlan(nw, stages, min(stages, DS_MAX_SLOTS))


def dynslice_cuda(w: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """P5 on the card: w int32 (nw,), 1 <= nw <= 1024, x2 f32 (rows, 128)
    and 16-byte aligned -> (8, 128)."""
    _check("dynslice_cuda", "w", w, torch.int32, (None,))
    _check("dynslice_cuda", "x2", x2, torch.float32, (None, LANE))
    if w.shape[0] > MAX_WINDOWS:
        raise ValueError(f"dynslice_cuda takes at most {MAX_WINDOWS} windows, got {w.shape[0]}")
    _aligned("dynslice_cuda", x2=x2)
    plan = dynslice_plan(w.shape[0])
    o = torch.empty((WINDOW, LANE), dtype=torch.float32, device=x2.device)
    _launch("dynslice_cuda", "tpucg_probe_dynslice_f32", (w, x2, o), (plan.nw, plan.slots), x2)
    dynslice_cuda.launches += 1
    return o


def dynslice(w: torch.Tensor, x2: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P5: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, x2.device) == "cuda":
        return dynslice_cuda(w, x2)
    return dynslice_torch(w, x2)


# ---- P6: roll by a shift read at run time ---------------------------------------


def roll_dyn_torch(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of P6: the source lanes ``(j - s) mod 128`` built on
    s's device, so the shift is never read back to the host."""
    roll_dyn_torch.launches += 1
    cols = (torch.arange(LANE, device=x.device) - s.long()) % LANE
    return x[:, cols]


def roll_dyn_cuda(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P6 on the card: s int32 (1,) on the card, x f32 (rows, 128) and
    16-byte aligned, a warp a row on ``lane_gather_plan``."""
    _check("roll_dyn_cuda", "s", s, torch.int32, (1,))
    _check("roll_dyn_cuda", "x", x, torch.float32, (None, LANE))
    _aligned("roll_dyn_cuda", x=x)
    _on_card("roll_dyn_cuda", (s, x), x)
    rows = x.shape[0]
    plan = lane_gather_plan(rows, _sms(x))
    o = torch.empty_like(x)
    _aligned("roll_dyn_cuda", o=o)
    _launch("roll_dyn_cuda", "tpucg_probe_roll_dyn_f32", (s, x, o), (rows, plan.warps), x)
    roll_dyn_cuda.launches += 1
    return o


def roll_dyn(s: torch.Tensor, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P6: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, x.device) == "cuda":
        return roll_dyn_cuda(s, x)
    return roll_dyn_torch(s, x)


for _fn in (lane_gather_torch, lane_gather_cuda, sub_gather_torch, sub_gather_cuda,
            row_gather_torch, row_gather_cuda, elem_gather_torch, elem_gather_cuda,
            dynslice_torch, dynslice_cuda, roll_dyn_torch, roll_dyn_cuda):
    _fn.launches = 0
