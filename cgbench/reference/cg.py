"""Plain CG (and Jacobi PCG) on k columns at once, from the original arrays.

The reference works out again everything the program derives from its
inputs: it sums the CSR's duplicate entries, takes the Jacobi diagonal from
them, and keeps a dense A as given. ``dtype`` is the arithmetic of every
vector and product; ``rounding`` (optional) rounds the operands of each
product, which is how the control computes in TF32.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest even: what a
    TF32 tensor core reads of each operand."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Operator:
    """A @ X in ``dtype`` for a dense A or a CSR (duplicates summed), with
    its diagonal; ``rounding`` (dense A only) rounds A once and X at each
    product."""

    def __init__(self, inputs: dict, dtype: torch.dtype, device,
                 rounding: Optional[Callable] = None):
        self.rounding = rounding
        self.dtype = dtype
        if inputs["kind"] == "dense":
            A = inputs["A"].to(device=device, dtype=dtype)
            self.A = rounding(A) if rounding is not None else A
            self.diag = torch.diagonal(self.A).clone()
            self.n = A.shape[0]
            return
        if rounding is not None:
            raise ValueError("operand rounding (the TF32 control) applies to a dense A")
        n = int(inputs["n"])
        indptr = torch.as_tensor(inputs["indptr"], dtype=torch.int64, device=device)
        cols = torch.as_tensor(inputs["indices"], dtype=torch.int64, device=device)
        vals = torch.as_tensor(inputs["data"], device=device).to(dtype)
        rows = torch.repeat_interleave(torch.arange(n, device=device), torch.diff(indptr))
        on = rows == cols
        self.diag = torch.zeros(n, dtype=dtype, device=device).index_add_(0, rows[on], vals[on])
        with warnings.catch_warnings():
            # torch's notes on sparse tensors being beta and unchecked
            warnings.filterwarnings("ignore", category=UserWarning, message=".*[Ss]parse")
            coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                          check_invariants=False).coalesce()
            self.A = coo.to_sparse_csr()
        self.nnz = int(coo.values().numel())
        self.n = n

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if self.rounding is not None:
            X = self.rounding(X)
        return self.A @ X


def cg(op: Operator, B: torch.Tensor, tol: torch.Tensor, maxiter: int,
       precondition: str = "none", check_every: int = 16):
    """Classic CG (PCG with ``precondition="jacobi"``) on the k columns of B
    (n, k) from X = 0, the reference's recurrence: each column stops when
    its recurrence residual ||r|| < ``tol`` (k,), tested after the x/r
    update, every ``check_every`` laps (a column that has stopped takes
    alpha = 0). Returns (X, laps (k,), converged (k,))."""
    dev, dt = B.device, op.dtype
    B = B.to(dt)
    k = B.shape[1]
    X = torch.zeros_like(B)
    R = B.clone()
    minv = None
    if precondition == "jacobi":
        minv = torch.where(op.diag != 0, 1.0 / op.diag, torch.ones_like(op.diag))[:, None]
    elif precondition != "none":
        raise ValueError(f"the reference runs precondition none or jacobi, not {precondition!r}")
    Z = R if minv is None else minv * R
    P = Z.clone()
    rz = (R * Z).sum(0)
    tol2 = tol.to(device=dev, dtype=dt) ** 2
    done = (R * R).sum(0) < tol2
    laps = torch.zeros(k, dtype=torch.int64, device=dev)
    lap = 0
    while lap < maxiter and not bool(done.all()):
        for _ in range(min(check_every, maxiter - lap)):
            AP = op(P)
            pap = (P * AP).sum(0)
            alpha = torch.where(done | (pap <= 0), torch.zeros_like(pap), rz / pap)
            X += alpha * P
            R -= alpha * AP
            laps += (~done).to(torch.int64)
            done = done | ((R * R).sum(0) < tol2)
            Z = R if minv is None else minv * R
            rz_new = (R * Z).sum(0)
            beta = torch.where(done, torch.zeros_like(rz), rz_new / torch.where(rz == 0, 1, rz))
            P = torch.where(done, P, Z + beta * P)
            rz = torch.where(done, rz, rz_new)
            lap += 1
    return X, laps, done
