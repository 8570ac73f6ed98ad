"""One run of one cell: set-up, the measured window, the comparison, the
metrics.

The traffic is a closed loop with one caller and no think time, as a
simulation code calls a solver: a call sends its right-hand sides, waits
for x on the host, and the next call follows. A call's time runs on the
host clock from its start until its result is on the host.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import math
import os
import random
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from cgbench import check, spec, traffic
from cgbench import trace as tr
from cgbench.roofline import dense_product_bytes, least_seconds, product_flops, \
    sparse_product_bytes
from cgbench.solvers import Program, distinct_nnz

CACHE = spec.HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpucg")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(config: dict, seed: int, device) -> dict:
    """The configuration's matrix from its generator (``gen/<name>.py``).
    A generator that does not read the run's seed (``SEEDLESS``) is run
    once per checkout: its arrays are kept under ``cgbench/.cache``, keyed
    by the configuration and the generator's source."""
    gen = importlib.import_module(f"cgbench.gen.{config['generator']}")
    if not getattr(gen, "SEEDLESS", False):
        return gen.make(config, seed, device)
    src = Path(gen.__file__).read_bytes()
    key = hashlib.sha256(repr(sorted(config.items())).encode() + src).hexdigest()[:16]
    path = CACHE / f"{config['name']}-{key}.npz"
    if path.is_file():
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
        out["kind"], out["n"] = str(out["kind"]), int(out["n"])
        return out
    out = gen.make(config, seed, device)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.part.npz")
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def forbidden_modules() -> list:
    """Top-level module names of JAX or the JAX package that this process
    holds (whole names: ``tpucg_torch`` is not ``tpucg``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _least_product_s(workload, inputs, device_name) -> float:
    n, k, nnz = int(inputs["n"]), int(workload["k"]), distinct_nnz(inputs)
    if inputs["kind"] == "dense":
        nbytes = dense_product_bytes(n, k)
    else:
        nbytes = sparse_product_bytes(n, nnz, k)
    return least_seconds(nbytes, product_flops(nnz, k), device_name)


def execute(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            bench: dict = None, config: dict = None, workload: dict = None,
            solver=None) -> dict:
    """Run one cell and return its record (see ``result_line``).
    ``config``, ``workload`` and ``solver`` replace the cell's own (the
    tests' small sizes, the controls and the planted faults)."""
    bench = spec.load_benchmark() if bench is None else bench
    _, cfg0, wl0 = spec.load_cell(bench, cell)
    config = cfg0 if config is None else config
    workload = wl0 if workload is None else workload
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.zeros((), device=device)  # the context, before its memory statistics
        torch.cuda.reset_peak_memory_stats(device)
    k, npool = int(workload["k"]), int(workload["rhs"]["pool"])

    # Set-up: inputs from the seed, every call's right-hand sides and
    # tolerance, the operator placed once, one call warm.
    inputs = make_inputs(config, seed, device)
    n = int(inputs["n"])
    pool = traffic.rhs_pool(workload, n, seed, device)
    norms = torch.linalg.vector_norm(pool, dim=0).tolist()
    sends = []
    for i in range(npool // k):
        cols = traffic.call_columns(i, k, npool)
        sends.append((cols, pool[:, cols].contiguous(),
                      traffic.tolerance(config, [norms[j] for j in cols])))
    solver = Program(config, workload, device) if solver is None else solver
    t0 = time.perf_counter()
    solver.build(inputs)
    _sync(device)
    build_s = time.perf_counter() - t0
    solver.call(sends[0][1], sends[0][2])
    names = None
    if trace and on_card:
        names = tr.product_kernels(solver.probe(sends[0][1]))
    _sync(device)
    # Set-up's objects out of the collector's way: a full collection in the
    # window then scans only what the calls make.
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start

    # The window: back-to-back calls for ``seconds``; the first
    # ``trace_calls`` of a traced run under the profiler.
    ntrace = int(workload["trace_calls"]) if trace else 0
    prof = None
    if ntrace:
        from torch.profiler import ProfilerActivity, profile, record_function

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if on_card else []))
            prof.__enter__()
    rng = random.Random(traffic.seed_words(seed, "sample"))
    nsample = int(workload["sample_calls"])
    calls, sample = [], []
    w0 = time.perf_counter()
    i = 0
    while True:
        cols, B, tol = sends[i % len(sends)]
        if prof is not None and i < ntrace:
            with record_function(tr.MARK):
                a = time.perf_counter()
                X, laps, conv = solver.call(B, tol)
                b = time.perf_counter()
        else:
            a = time.perf_counter()
            X, laps, conv = solver.call(B, tol)
            b = time.perf_counter()
        calls.append({"s": b - a, "k": k, "laps": int(laps.max()),
                      "converged": int(conv.sum())})
        if prof is not None and i == ntrace - 1:
            _sync(device)
            prof.__exit__(None, None, None)
        item = {"i": i, "cols": cols, "X": X}
        if len(sample) < nsample:
            sample.append(item)
        else:
            j = rng.randrange(i + 1)
            if j < nsample:
                sample[j] = item
        i += 1
        if b - w0 >= seconds:
            break
    window_s = b - w0
    gc.unfreeze()
    if prof is not None and i < ntrace:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()

    record = {"cell": cell, "seed": seed, "config": config, "workload": workload,
              "setup_s": setup_s, "build_s": build_s, "window_s": window_s, "calls": calls,
              "memory_peak_bytes": memory_peak, "forbidden": found, "trace": None}
    t0 = time.perf_counter()
    if prof is not None:
        red = tr.reduce_trace(prof)
        prof = None
        if red is not None:
            red["calls"] = min(ntrace, len(calls))
            red["laps"] = sum(c["laps"] for c in calls[:red["calls"]])
            red["product_s"], red["products"] = tr.product_seconds(red["events"], names)
            red["product_kernels"] = names
            if on_card:
                red["least_product_s"] = _least_product_s(
                    workload, inputs, torch.cuda.get_device_name(device))
            record["trace"] = red

    record["trace_s"] = time.perf_counter() - t0

    # The program's state is freed before the reference runs.
    solver.close()
    solver = sends = None
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["numbers"] = check.readings(config, workload, inputs, pool, sample, calls, device)
    _sync(device)
    record["reference_s"] = time.perf_counter() - t0
    record["correct"], record["checks"] = check.judge(record["numbers"], workload["limits"])
    return record


def metric_values(bench: dict, record: dict, trace: bool) -> dict:
    """Each metric of the run's kind, by its reader; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in spec.metrics_for(bench, record["cell"], trace):
        v = spec.load_reader(m["name"]).read(record)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
