"""The one traffic generator: right-hand sides from the seed, and which of
them each call of the closed loop sends.

A workload file (``workloads/<cell>.json``) gives ``k`` (columns a call) and
``rhs``: ``draw`` ("uniform" on [0, 1) or "normal") and ``pool`` (how many
vectors the seed draws). Call i sends the pool's columns (i k + j) mod pool,
j < k: every seed sends the same number of the same kind of vectors in the
same pattern, so the seed changes the values and not the work.
"""

from __future__ import annotations

import numpy as np
import torch

_TAGS = {"matrix": 1, "rhs": 2, "sample": 3}


def seed_words(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (any whole ``seed``)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), _TAGS[tag]])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator_for(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed_words(seed, tag))
    return g


def rhs_pool(workload: dict, n: int, seed: int, device) -> torch.Tensor:
    """(n, pool) float32 on ``device``, one column a right-hand side."""
    spec = workload["rhs"]
    g = generator_for(seed, "rhs", device)
    shape = (int(spec["pool"]), n)
    if spec["draw"] == "uniform":
        pool = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    elif spec["draw"] == "normal":
        pool = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    else:
        raise ValueError(f"unknown draw {spec['draw']!r}")
    return pool.T.contiguous()


def call_columns(i: int, k: int, pool: int) -> list:
    """The pool columns call ``i`` sends."""
    return [(i * k + j) % pool for j in range(k)]


def tolerance(config: dict, norms) -> float:
    """The configuration's stop rule for one call whose columns have the
    2-norms ``norms``: ``absolute`` (the value itself) or ``relative_b``
    (the value times the smallest of them)."""
    rule = config["tol"]
    if rule["rule"] == "absolute":
        return float(rule["value"])
    if rule["rule"] == "relative_b":
        return float(rule["value"]) * min(float(v) for v in norms)
    raise ValueError(f"unknown tolerance rule {rule['rule']!r}")
