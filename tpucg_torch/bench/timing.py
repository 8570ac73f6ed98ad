"""Timing on the card and the three-phase bench report (the counterpart of
``tpucg.bench.timing``).

Times come from CUDA events around the timed calls, never from a host clock
without a synchronize; every measurement path needs a card and fails without
one. A GEMV rate is reported against the card's own HBM peak, looked up by
its name; an unknown card raises instead of getting a guessed peak, and a
rate above 100% of the peak is flagged as a timing fault.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time
from typing import Callable, Optional

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


def device_seconds_per_call(fn: Callable[[], object], reps: int = 100) -> float:
    """Summed device time of everything ``fn`` launches, per call: a
    kernel's own time where back-to-back calls are bound by host overhead."""
    _, ops = trace_calls(fn, reps)
    return sum(us for _, us in ops.values()) / reps / 1e6


def profile_table(fn: Callable[[], object], reps: int, trace_path: str) -> str:
    """``trace_calls`` as a table: device time per op name per call, and the
    device's busy share of the window (a lower bound, since the profiler
    stretches the window)."""
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


@dataclasses.dataclass
class BenchReport:
    """Per-run report: the reference's phases (distribution, CG, total) plus
    the GEMV's rate against the card's HBM peak. Times in seconds."""

    n: int
    iterations: int
    residual_norm: float
    distribute_s: float
    solve: Timing
    total_s: float
    card: str  # nvidia_smi_card(): name and power limit
    backend: str
    padded_n: int
    matvec: Optional[Timing] = None  # of the f32 operator
    matvec_gbps: Optional[float] = None
    roofline_frac: Optional[float] = None
    above_peak: bool = False

    def finalize(self, hbm_peak: float) -> "BenchReport":
        if self.matvec is not None:
            rate = gemv_bytes(self.padded_n, self.padded_n, 4) / self.matvec.median
            self.matvec_gbps = rate / 1e9
            self.roofline_frac = rate / hbm_peak
            # Faster than the card's HBM peak means the timing is wrong
            # (A cached, or work not waited for), not a fast kernel.
            self.above_peak = self.roofline_frac > 1.0
        return self

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
            lines.append(
                f"matvec               : {self.matvec.median * 1e6:.1f} us, "
                f"{self.matvec_gbps:.0f} GB/s "
                f"({100 * self.roofline_frac:.1f}% of HBM peak)"
                + ("  ABOVE PEAK: timing fault" if self.above_peak else "")
            )
        return "\n".join(lines)
