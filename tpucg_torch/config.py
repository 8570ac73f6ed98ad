"""Runtime configuration for CG solves (the counterpart of ``tpucg.config``).

The fields are those of tpucg's that the dense slice reads, with tpucg's
validation, so a configuration means the same in both packages. ``kernel``
takes ``"auto"``/``"cuda"``/``"torch"`` (tpucg's ``"auto"``/``"pallas"``/
``"xla"``) and ``dtype`` is a torch dtype. Values this slice does not run yet
pass validation here and raise ``NotImplementedError`` in ``cg_solve``,
naming their ROADMAP item. ``strategy`` is read by the sharded solves (serial
solves ignore it, as tpucg's do); tpucg's knobs of the other methods and
preconditioners (``pc_block_size``, ``s_step``, ``check_every``) return with
the slices that read them.
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
      strategy: communication of a sharded dense solve: ``"allgather"``
        gathers the direction vector whole every lap (the reference's
        collective arm, ``parallel_cg.c:290-291``), ``"overlap"`` passes its
        blocks around a ring while each rank multiplies the block in hand
        (tpucg's form of the point-to-point arm).
      kernel: ``"auto"`` runs the CUDA kernels on a CUDA device and their
        plain PyTorch versions elsewhere; ``"cuda"`` / ``"torch"`` force one.
      safe_alpha: treat ``p.Ap == 0`` (exact initial guess) as a zero step
        instead of dividing by zero.
      precondition: ``"none"``, ``"jacobi"``, ``"block_jacobi"`` or ``"poly"``
        (truncated-Neumann polynomial of degree ``poly_degree``:
        ``poly_degree - 1`` extra matvecs per lap).
      poly_degree: polynomial degree for ``precondition="poly"`` (>= 1).
      method: ``"cg"``, ``"pipelined"``, ``"ca"`` or ``"chebyshev"``.
      fused: whole-solve-in-one-kernel dispatch: ``"auto"``, ``"always"`` or
        ``"never"``.
    """

    tol: float = 1.0e-6
    maxiter: Optional[int] = None
    dtype: torch.dtype = torch.float32
    strategy: str = "allgather"
    kernel: str = "auto"
    safe_alpha: bool = True
    precondition: str = "none"
    method: str = "cg"
    fused: str = "auto"
    poly_degree: int = 3

    def __post_init__(self):
        if self.strategy not in ("allgather", "overlap"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.method not in ("cg", "pipelined", "ca", "chebyshev"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.kernel not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown kernel backend {self.kernel!r}")
        if self.fused not in ("auto", "always", "never"):
            raise ValueError(f"unknown fused mode {self.fused!r}")
        if self.precondition not in ("none", "jacobi", "block_jacobi", "poly"):
            raise ValueError(f"unknown preconditioner {self.precondition!r}")
        if self.poly_degree < 1:
            raise ValueError("poly_degree must be >= 1")
        if self.tol <= 0:
            raise ValueError("tol must be positive")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"solve dtype must be float32/float64, got {self.dtype}")
