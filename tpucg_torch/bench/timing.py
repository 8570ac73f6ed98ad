"""Timing on the card and the three-phase bench report (the counterpart of
``tpucg.bench.timing``).

Times come from CUDA events around the timed calls, never from a host clock
without a synchronize; every measurement path needs a card and fails without
one. A matvec's rate (dense GEMV, DIA SpMV, stencil) is reported against
the card's own HBM peak, looked up by its name, from the bytes it must move;
an unknown card raises instead of getting a guessed peak, and a rate above
100% of the peak is flagged as a timing fault.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import time
from typing import Callable, Optional, Sequence

import torch

# Peak HBM bandwidth in bytes/s by a substring of torch.cuda.get_device_name()
# (NVIDIA data sheets). SXM parts report "H100 80GB HBM3".
_HBM_PEAK = (
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100 80GB HBM3", 3.35e12),
    ("H100 SXM", 3.35e12),
)


def nvidia_smi_card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W": every time kept
    is reported beside it, since a card set below its power limit runs
    slower."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0].strip()


def hbm_peak_bytes_per_s(device_name: Optional[str] = None) -> float:
    """The card's published HBM peak; raises for a card not on record."""
    name = torch.cuda.get_device_name() if device_name is None else device_name
    for key, peak in _HBM_PEAK:
        if key in name:
            return peak
    raise ValueError(f"unknown card {name!r}: no HBM peak on record")


@dataclasses.dataclass(frozen=True)
class Timing:
    """Seconds per call: median, min and max over ``samples`` samples."""

    median: float
    min: float
    max: float
    samples: int


def time_fn(fn: Callable[[], object], warmup: int = 1, iters: int = 5, reps: int = 1) -> Timing:
    """Device time per call of ``fn`` from CUDA events on the current stream.

    Each of ``iters`` (>= 5) samples times ``reps`` back-to-back calls and
    divides by ``reps``: use reps > 1 for kernels of a few microseconds.
    ``fn`` must enqueue its work on the current stream; the samples end in a
    synchronize.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures on the card, and there is no CUDA device")
    if iters < 5 or reps < 1:
        raise ValueError("time_fn needs iters >= 5 and reps >= 1")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ts = [s.elapsed_time(e) / 1e3 / reps for s, e in events]
    return Timing(statistics.median(ts), min(ts), max(ts), len(ts))


def trace_calls(fn: Callable[[], object], reps: int, trace_path: Optional[str] = None):
    """Trace ``reps`` calls of ``fn`` with torch.profiler (and write the
    Chrome trace to ``trace_path``). Returns the host wall seconds of the
    window, which ends in a synchronize, and ``{device op name: (launches,
    device µs)}`` summed over the calls. Device durations are the kernels'
    own; the profiler's host overhead stretches only the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            cnt, us = ops.get(e.name, (0, 0.0))
            ops[e.name] = (cnt + 1, us + e.time_range.elapsed_us())
    return wall, ops


# Cycles a second assumed when sizing the spin kernel of a queued window:
# at least the card's clock (H100: 1.98 GHz at most), so a spin lasts at
# least as long as asked.
_SPIN_HZ = 2.0e9
_SPIN_MAX_S = 2.0


def _queued_window(fn: Callable[[], object], reps: int, spin_s: float) -> Optional[float]:
    """Seconds between two CUDA events around ``reps`` calls of ``fn``, all
    enqueued while a spin kernel holds the stream, so that the card runs
    them back to back without waiting for the host. None when the spin had
    ended before the last call was enqueued: the window then holds host
    gaps and is not kept."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * _SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 if held else None


def device_timing(fn: Callable[[], object], iters: int = 5, reps: int = 100) -> Timing:
    """Device time per call of ``fn`` where back-to-back calls are bound by
    host overhead (a 10-30 us kernel behind a ~20 us wrapper): each of
    ``iters`` windows times ``reps`` calls queued behind a spin kernel
    (``_queued_window``), so host time between calls is hidden and the
    card's own time per call, launch gaps included, remains. ``fn`` must
    enqueue on the current stream and must not synchronize. A window the
    host could not fill in time is taken again with half the calls (a long
    queue blocks the host) and twice the spin; raises when none can be."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_timing measures on the card, and there is no CUDA device")
    if iters < 1 or reps < 1:
        raise ValueError("device_timing needs iters >= 1 and reps >= 1")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    ts = []
    while len(ts) < iters:
        seconds = _queued_window(fn, reps, spin_s)
        if seconds is not None and seconds > 0:
            ts.append(seconds / reps)
            continue
        if reps == 1 and spin_s >= _SPIN_MAX_S:
            raise RuntimeError(
                f"device_timing: one call of {getattr(fn, '__name__', fn)!r} outlasted a "
                f"{spin_s:.1f} s spin on the host (does it synchronize?)"
            )
        reps, spin_s = max(1, reps // 2), min(2 * spin_s, _SPIN_MAX_S)
    return Timing(statistics.median(ts), min(ts), max(ts), len(ts))


def device_seconds_per_call(fn: Callable[[], object], reps: int = 100) -> float:
    """Median device time per call of ``fn`` (``device_timing``)."""
    return device_timing(fn, iters=5, reps=reps).median


def rotating(calls: Sequence[Callable[[], object]]) -> Callable[[], None]:
    """One call of the next of ``calls`` a call, to time operands that are
    not in L2 (one set a call over sets that L2 cannot hold together); each
    keeps its output until its turn comes again, so the outputs do not
    share one buffer either."""
    ring = itertools.cycle(range(len(calls)))
    held = [None] * len(calls)

    def call():
        k = next(ring)
        held[k] = calls[k]()
    return call


def profile_table(fn: Callable[[], object], reps: int, trace_path: Optional[str]) -> str:
    """``trace_calls`` as a table: device time per op name per call, and the
    device's busy share of the window (a lower bound, since the profiler
    stretches the window); the trace goes to ``trace_path`` unless None."""
    wall, ops = trace_calls(fn, reps, trace_path)
    busy_us = sum(us for _, us in ops.values())
    lines = [
        f"profiled window: {wall / reps * 1e3:.4f} ms/call host wall, "
        f"{busy_us / reps / 1e3:.4f} ms/call device busy, busy share "
        f"{busy_us / 1e6 / wall:.3f}, {sum(c for c, _ in ops.values()) / reps:.1f} "
        "device ops/call",
        f"{'us/call':>10} {'launches/call':>14} {'us/launch':>10}  kernel",
    ]
    for name, (cnt, us) in sorted(ops.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{us / reps:10.2f} {cnt / reps:14.1f} {us / cnt:10.2f}  {name[:100]}")
    return "\n".join(lines)


def gemv_bytes(rows: int, cols: int, itemsize: int) -> int:
    """Bytes one GEMV must move: A once, x and y once each (f32)."""
    return rows * cols * itemsize + 4 * (rows + cols)


def dia_spmv_bytes(ndiag: int, npad: int, itemsize: int) -> int:
    """Bytes one DIA SpMV (K6) must move: the slab once, x and y once each."""
    return itemsize * ndiag * npad + 8 * npad


def stencil_bytes(n: int) -> int:
    """Bytes one stencil matvec (K8) must move: u once and y once (f32)."""
    return 8 * n


def well_spmv_bytes(nnz: int, itemsize: int, npad: int) -> int:
    """Bytes one WELL SpMV (K13) must move, the least of the function and
    not of the TPU's slot layout: each stored nonzero's value (``itemsize``)
    and int32 column once, ``npad + 1`` int32 row offsets, x read and y
    written once (f32, ``npad`` each)."""
    return nnz * (itemsize + 4) + 4 * (npad + 1) + 8 * npad


def csr_spmv_bytes(nnz: int, n: int, itemsize: int = 4, index_size: int = 4) -> int:
    """Bytes one CSR SpMV must move: values and column indices once, the row
    pointers once, x read and y written once (f32)."""
    return nnz * (itemsize + index_size) + index_size * (n + 1) + 8 * n


SECTOR = 32  # bytes: the least one read from device memory moves


def gather_bytes(index_bytes: int, out_bytes: int, addresses, itemsize: int = 4) -> int:
    """Least bytes a gather must move: its indices and its output once, and
    each distinct 32-byte sector of the table that holds an element it reads,
    once (a sector read again comes from L2). ``addresses`` are the flat
    indices of the table elements read, of any shape, on any device."""
    flat = torch.as_tensor(addresses).reshape(-1).long()
    return index_bytes + out_bytes + SECTOR * torch.unique(flat * itemsize // SECTOR).numel()


def poisson_nnz(m: int) -> int:
    """Nonzeros of the 7-point Dirichlet Laplacian on an m^3 grid."""
    return 7 * m ** 3 - 6 * m * m


def rate_line(nbytes: int, seconds: float, peak: float, nnz: Optional[int] = None) -> str:
    """A matvec's rate: GB/s, % of the HBM peak (flagged above 100%: a
    timing fault, not a fast kernel) and, with ``nnz``, Gnnz/s."""
    if not seconds > 0:
        raise ValueError(f"rate_line needs a positive time, got {seconds!r} s")
    rate = nbytes / seconds
    out = f"{rate / 1e9:.1f} GB/s, {100 * rate / peak:.1f}% of HBM peak"
    if nnz is not None:
        out += f", {nnz / seconds / 1e9:.2f} Gnnz/s"
    return out + ("  ABOVE PEAK: timing fault" if rate > peak else "")


@dataclasses.dataclass
class BenchReport:
    """Per-run report: the reference's phases (distribution, CG, total) plus
    the operator's matvec rate against the card's HBM peak (from the
    ``matvec_bytes`` it must move) and, for a sparse operator, nnz/s. Times
    in seconds."""

    n: int
    iterations: int
    residual_norm: float
    distribute_s: float
    solve: Timing
    total_s: float
    card: str  # nvidia_smi_card(): name and power limit
    backend: str
    padded_n: int
    matvec: Optional[Timing] = None
    matvec_bytes: Optional[int] = None
    nnz: Optional[int] = None
    matvec_gbps: Optional[float] = None
    roofline_frac: Optional[float] = None
    above_peak: bool = False
    strategy: str = "serial"

    def finalize(self, hbm_peak: float) -> "BenchReport":
        if self.matvec is not None:
            nbytes = self.matvec_bytes
            if nbytes is None:
                nbytes = gemv_bytes(self.padded_n, self.padded_n, 4)
            rate = nbytes / self.matvec.median
            self.matvec_gbps = rate / 1e9
            self.roofline_frac = rate / hbm_peak
            # Faster than the card's HBM peak means the timing is wrong
            # (A cached, or work not waited for), not a fast kernel.
            self.above_peak = self.roofline_frac > 1.0
        return self

    def to_json(self) -> str:
        """The report as one JSON line with tpucg's ``BenchReport`` keys
        (``timing.py:360-399``) where this report has the quantity (solve_s
        and matvec_s are the medians; device_kind is the card's name and
        power limit), then this report's own: the solve's min, max and
        samples, the matvec's bytes and the above-peak flag."""
        mv = None if self.matvec is None else self.matvec.median
        return json.dumps({
            "n": self.n, "iterations": self.iterations, "residual_norm": self.residual_norm,
            "distribute_s": self.distribute_s, "solve_s": self.solve.median,
            "total_s": self.total_s, "matvec_s": mv, "matvec_gbps": self.matvec_gbps,
            "roofline_frac": self.roofline_frac,
            "iters_per_s": self.iterations / self.solve.median if self.solve.median else None,
            "nnz": self.nnz,
            "nnz_per_s": self.nnz / mv if mv and self.nnz is not None else None,
            "padded_n": self.padded_n, "strategy": self.strategy, "backend": self.backend,
            "device_kind": self.card, "solve_min_s": self.solve.min,
            "solve_max_s": self.solve.max, "solve_samples": self.solve.samples,
            "matvec_bytes": self.matvec_bytes, "above_peak": self.above_peak,
        })

    def pretty(self) -> str:
        lines = [
            f"system size          : {self.n} x {self.n} (padded {self.padded_n})",
            f"device               : [{self.card}] backend={self.backend}",
            f"data distribution (s): {self.distribute_s:.6f}",
            f"CG method (s)        : median {self.solve.median:.6f} "
            f"min {self.solve.min:.6f} max {self.solve.max:.6f} "
            f"({self.solve.samples} solves)",
            f"total (s)            : {self.total_s:.6f}",
            f"iterations           : {self.iterations}",
            f"final ||r||          : {self.residual_norm:.3e}",
        ]
        if self.matvec is not None:
            nnz = (f", {self.nnz / self.matvec.median / 1e9:.2f} Gnnz/s"
                   if self.nnz is not None else "")
            lines.append(
                f"matvec, device       : {self.matvec.median * 1e6:.1f} us, "
                f"{self.matvec_gbps:.0f} GB/s "
                f"({100 * self.roofline_frac:.1f}% of HBM peak{nnz})"
                + ("  ABOVE PEAK: timing fault" if self.above_peak else "")
            )
        return "\n".join(lines)
