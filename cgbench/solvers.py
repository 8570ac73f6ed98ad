"""What a call of the closed loop runs: the program under test, and the
controls that stand in its place when the comparison is shown to fail.

Each solver places its operator once (``build``) and then solves one call's
columns (``call``), returning the result on the host: X (n, k) float32 and,
per column, the laps and whether it converged.
"""

from __future__ import annotations

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """tpucg_torch through its public entry (``cg_solve`` or
    ``cg_solve_multi``) on an operator placed once: ``DenseOperator`` for a
    dense A, ``best_sparse_operator`` for a CSR (``storage`` "bfloat16" asks
    the program's own bf16 WELL storage instead: the FEM control)."""

    def __init__(self, config: dict, workload: dict, device, storage: str = "float32"):
        self.config, self.workload, self.device = config, workload, torch.device(device)
        self.storage = storage
        self.op = None

    def build(self, inputs: dict) -> None:
        import tpucg_torch as tt

        if inputs["kind"] == "dense":
            self.op = tt.DenseOperator.create(inputs["A"], device=self.device)
        else:
            n = int(inputs["n"])
            csr = tt.CSRMatrix(indptr=inputs["indptr"], indices=inputs["indices"],
                               data=inputs["data"], shape=(n, n))
            if self.storage == "bfloat16":
                self.op = tt.WellOperator.from_csr(csr, storage_dtype=torch.bfloat16,
                                                   device=self.device)
            else:
                self.op = tt.best_sparse_operator(csr, device=self.device)
        self.entry = getattr(tt, self.workload["entry"])
        _sync(self.device)

    def call(self, B: torch.Tensor, tol: float):
        cfg = self.config
        b = B[:, 0] if self.workload["entry"] == "cg_solve" else B
        res = self.entry(self.op, b, tol=tol, maxiter=int(cfg["maxiter"]),
                         precondition=cfg["precondition"], method=cfg["method"])
        X = res.x.reshape(B.shape[0], -1).cpu()
        laps = res.iterations.reshape(-1).cpu()
        conv = res.converged.reshape(-1).cpu()
        return X, laps, conv

    def probe(self, like: torch.Tensor):
        """A function that runs one product of the operator, as the solve's
        laps run it, on ``like`` (n, k) padded to the operator's length. The
        padding is done here, so that the function runs the operator's call
        and nothing else."""
        X = torch.nn.functional.pad(like, (0, 0, 0, self.op.padded_n - like.shape[0]))
        if X.shape[1] == 1 and self.workload["entry"] == "cg_solve":
            x = X[:, 0].contiguous()
            fn = lambda: self.op.matvec(x)  # noqa: E731
        else:
            X = X.contiguous()
            fn = lambda: self.op.matvec_multi(X)  # noqa: E731
        _sync(self.device)
        return fn

    def close(self) -> None:
        self.op = self.entry = None


class ReferenceControl:
    """The plain reference in the program's place, its products computed
    in TF32 (A and each vector rounded to 10 mantissa bits, float32 sums):
    the control of a float32 configuration with TF32 off."""

    def __init__(self, config: dict, workload: dict, device):
        self.config, self.workload, self.device = config, workload, torch.device(device)

    def build(self, inputs: dict) -> None:
        from cgbench.reference.cg import Operator, tf32_round

        self.op = Operator(inputs, torch.float32, self.device, rounding=tf32_round)

    def call(self, B: torch.Tensor, tol: float):
        from cgbench.reference.cg import cg

        tols = torch.full((B.shape[1],), tol, dtype=torch.float32, device=self.device)
        X, laps, conv = cg(self.op, B, tols, int(self.config["maxiter"]),
                           self.config["precondition"])
        return X.float().cpu(), laps.cpu(), conv.cpu()

    def close(self) -> None:
        self.op = None


def control_for(config: dict, workload: dict, device):
    """The nearest precision below the configuration's float32: TF32 where
    the configuration states TF32 off (its products could run on tensor
    cores), else the program's own bfloat16 storage."""
    if config.get("tf32") is False:
        return ReferenceControl(config, workload, device)
    return Program(config, workload, device, storage="bfloat16")


def distinct_nnz(inputs: dict) -> int:
    """Entries of the matrix with duplicates summed: n^2 for a dense A, the
    distinct (row, column) pairs of a CSR."""
    n = int(inputs["n"])
    if inputs["kind"] == "dense":
        return n * n
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(inputs["indptr"]))
    return int(np.unique(rows * n + inputs["indices"]).size)
