"""The device trace of a traced run, from ``torch.profiler``.

``Profile`` wraps the first calls of the window (each marked on the host by
``MARK``) and reduces the trace to what the readers and the result line
need: the traced window on the profiler's clock, every device operation in
it (kernels, copies and fills), the union of device activity, the device
time by operation and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

import torch

MARK = "cgbench.call"


def _raw(prof):
    """(name, on the device, start µs, end µs) of every event of a finished
    profile, read from the profiler's own results without building its
    event tree (which takes tens of seconds over 10^5 events)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns() * 1e-3, e.end_ns() * 1e-3)
            for e in prof.profiler.kineto_results.events()]


def _device_events(prof):
    return [(n, s, t) for n, on, s, t in _raw(prof) if on and n != MARK]


def product_kernels(fn) -> list:
    """Names of the device operations one call of ``fn`` runs, longest
    first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = defaultdict(float)
    for name, t0, t1 in _device_events(prof):
        total[name] += t1 - t0
    return sorted(total, key=lambda k: -total[k])


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(prof, top: int = 10) -> dict:
    """The traced window (from the first call's mark to the last's end),
    in seconds: ``window_s``, ``busy_s`` (the union of device activity in
    it), ``events`` [(name, start_us, end_us)] of the device operations in
    it, and the breakdown's two lists."""
    marks, host = [], []
    dev = []
    for name, on_device, s, t in _raw(prof):
        if name == MARK:
            # The mark's host range; its copy on the device timeline (a
            # user annotation) is no device operation.
            if not on_device:
                marks.append((s, t))
        elif on_device:
            dev.append((name, s, t))
        elif t > s:
            host.append((s, t, name))
    if not marks:
        return None
    w0, w1 = min(s for s, _ in marks), max(t for _, t in marks)
    dev = [(n, max(s, w0), min(t, w1)) for n, s, t in dev if t > w0 and s < w1]
    merged = _union([(s, t) for _, s, t in dev])
    busy = sum(t - s for s, t in merged)
    by_op = defaultdict(float)
    for n, s, t in dev:
        by_op[n] += t - s
    # Idle gaps, each named by the innermost host operation that covers its
    # middle (the latest-starting one among the nearby host events).
    host.sort()
    starts = [h[0] for h in host]
    edges = [w0] + [x for se in merged for x in se] + [w1]
    gaps = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host: no traced operation"
        j = bisect.bisect_right(starts, mid) - 1
        for h in host[max(0, j - 256):j + 1][::-1]:
            if h[1] >= mid:
                name = h[2]
                break
        gaps[name] += b - a
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "events": dev,
        "device_ops": [[n, v * 1e-6] for n, v in sorted(by_op.items(), key=lambda kv: -kv[1])][:top],
        "idle_gaps": [[n, v * 1e-6] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])][:top],
    }


def product_seconds(events, names) -> tuple:
    """(device seconds per product, products) of the products whose
    kernels are ``names`` (longest first). A product is a launch of the
    first that ran at least half as long as the median one: a launch on a
    stopped loop returns at once and is no product, and its time is the
    loop's, not the product's. The other names add every launch, but only a
    name launched no more often than the first: one launched more often
    runs outside the product too (a fill or a copy of torch's that the lap
    also runs), and is left out."""
    if not names:
        return None, 0
    count = defaultdict(int)
    for n, _, _ in events:
        count[n] += 1
    main = [t - s for n, s, t in events if n == names[0]]
    if not main:
        return None, 0
    med = statistics.median(main)
    products = [d for d in main if d >= 0.5 * med]
    others = {n for n in names[1:] if count[n] <= len(main)}
    total = sum(products) + sum(t - s for n, s, t in events if n in others)
    return total * 1e-6 / len(products), len(products)
