"""Benchmark harness: CUDA-event timing and the three-phase report."""

from tpucg_torch.bench.timing import BenchReport, Timing, hbm_peak_bytes_per_s, time_fn

__all__ = ["BenchReport", "Timing", "hbm_peak_bytes_per_s", "time_fn"]
