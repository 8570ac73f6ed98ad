"""Runtime configuration for CG solves (the counterpart of ``tpucg.config``).

The fields are those of tpucg's that the dense slice reads, with tpucg's
validation, so a configuration means the same in both packages. ``kernel``
takes ``"auto"``/``"cuda"``/``"torch"`` (tpucg's ``"auto"``/``"pallas"``/
``"xla"``) and ``dtype`` is a torch dtype. Values this slice does not run yet
pass validation here and raise ``NotImplementedError`` in ``cg_solve``,
naming their ROADMAP item. tpucg's knobs of sharded solves and of the other
methods and preconditioners (``strategy``, ``poly_degree``,
``pc_block_size``, ``s_step``, ``check_every``) return with the slices that
read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CGConfig:
    """Configuration for a conjugate-gradient solve.

    Attributes:
      tol: absolute stopping tolerance on the residual 2-norm; the reference
        contract is ``sqrt(r.r) < 1e-6``, tested after the x/r update and
        before the p update.
      maxiter: iteration cap; ``None`` means n.
      dtype: solve dtype, float32 (the reference contract). bf16 is a storage
        dtype of ``DenseOperator.create``, not a solve dtype.
      kernel: ``"auto"`` runs the CUDA kernels on a CUDA device and their
        plain PyTorch versions elsewhere; ``"cuda"`` / ``"torch"`` force one.
      safe_alpha: treat ``p.Ap == 0`` (exact initial guess) as a zero step
        instead of dividing by zero.
      precondition: ``"none"``, ``"jacobi"``, ``"block_jacobi"`` or ``"poly"``.
      method: ``"cg"``, ``"pipelined"``, ``"ca"`` or ``"chebyshev"``.
      fused: whole-solve-in-one-kernel dispatch: ``"auto"``, ``"always"`` or
        ``"never"``.
    """

    tol: float = 1.0e-6
    maxiter: Optional[int] = None
    dtype: torch.dtype = torch.float32
    kernel: str = "auto"
    safe_alpha: bool = True
    precondition: str = "none"
    method: str = "cg"
    fused: str = "auto"

    def __post_init__(self):
        if self.method not in ("cg", "pipelined", "ca", "chebyshev"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.kernel not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown kernel backend {self.kernel!r}")
        if self.fused not in ("auto", "always", "never"):
            raise ValueError(f"unknown fused mode {self.fused!r}")
        if self.precondition not in ("none", "jacobi", "block_jacobi", "poly"):
            raise ValueError(f"unknown preconditioner {self.precondition!r}")
        if self.tol <= 0:
            raise ValueError("tol must be positive")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"solve dtype must be float32/float64, got {self.dtype}")
