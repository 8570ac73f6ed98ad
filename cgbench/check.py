"""What decides ``correct``: the timed calls' own results against the plain
reference, and each compared number against its limit.

Numbers (``workloads/<cell>.json`` gives the limit of each one compared):

- ``unconverged``: right-hand sides of the window whose call reported
  converged false (every call of the window counts);
- ``x_err``: over a sample of the window's calls drawn from the seed, the
  largest ||x - x_ref|| / ||x_ref|| of a column, x_ref the reference's float64
  solve of the same b to ``reference.rtol`` ||b||.

``anorm_err`` (the same in the A-norm), ``true_res`` (||b - A x|| / ||b|| in
float64) and ``ref_laps`` are read beside them and printed, not compared.
"""

from __future__ import annotations

import math

import torch

from cgbench.reference.cg import Operator, cg


def readings(config: dict, workload: dict, inputs: dict, pool: torch.Tensor, sample: list,
             calls: list, device) -> dict:
    """Every number of the comparison, from the window's records and the
    sampled calls' results (their x on the host)."""
    out = {"unconverged": float(sum(c["k"] - c["converged"] for c in calls))}
    cols = sorted({j for s in sample for j in s["cols"]})
    if not cols:
        out["x_err"] = math.nan
        return out
    ref = workload["reference"]
    op = Operator(inputs, torch.float64, device)
    B = pool[:, cols].to(device=device, dtype=torch.float64)
    bnorm = torch.linalg.vector_norm(B, dim=0)
    Xr, laps, conv = cg(op, B, float(ref["rtol"]) * bnorm, int(ref["maxiter"]),
                        config["precondition"])
    if not bool(conv.all()):
        raise RuntimeError(f"the reference did not reach {ref['rtol']} ||b|| in "
                           f"{ref['maxiter']} laps: no comparison")
    AXr = op(Xr)
    at = {c: i for i, c in enumerate(cols)}
    x_err = anorm = true_res = 0.0
    for s in sample:
        idx = [at[c] for c in s["cols"]]
        X = s["X"].to(device=device, dtype=torch.float64)
        E = X - Xr[:, idx]
        x_err = max(x_err, float((torch.linalg.vector_norm(E, dim=0)
                                  / torch.linalg.vector_norm(Xr[:, idx], dim=0)).max()))
        AE = op(E)
        anorm = max(anorm, float(((E * AE).sum(0) / (Xr[:, idx] * AXr[:, idx]).sum(0))
                                 .clamp_min(0).sqrt().max()))
        R = B[:, idx] - op(X)
        true_res = max(true_res, float((torch.linalg.vector_norm(R, dim=0)
                                        / bnorm[idx]).max()))
    out.update(x_err=x_err, anorm_err=anorm, true_res=true_res,
               ref_laps=float(laps.max()), sampled_calls=float(len(sample)),
               sampled_columns=float(len(cols)))
    return out


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the compared numbers: each
    has to be at most its limit (a NaN fails)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and (v <= limit)
    return ok, checks
