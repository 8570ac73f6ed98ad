"""Runtime configuration for CG solves (the counterpart of ``tpucg.config``).

The fields are those of tpucg's that the dense slice reads, with tpucg's
validation, so a configuration means the same in both packages. ``kernel``
takes ``"auto"``/``"cuda"``/``"torch"`` (tpucg's ``"auto"``/``"pallas"``/
``"xla"``) and ``dtype`` is a torch dtype. Values this port does not run yet
pass validation here and raise ``NotImplementedError`` in ``cg_solve``,
naming their ROADMAP item. ``strategy`` is read by the sharded solves (serial
solves ignore it, as tpucg's do).
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
      dtype: solve dtype, float32 (the reference contract) or float64
        (tpucg's extension: plain torch ops on the solve's device, no
        kernel). bf16 is a storage dtype of ``DenseOperator.create``, not a
        solve dtype.
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
      pc_block_size: diagonal-block size for ``precondition="block_jacobi"``
        (>= 2; set-up inverts ceil(n/bs) bs x bs blocks once, and a lap
        applies them as one batched block product).
      method: ``"cg"`` (the reference recurrence), ``"pipelined"``
        (Ghysels-Vanroose CG: the lap's dots are independent of its
        matvec), ``"ca"`` (s-step CG: one Gram product of a Krylov basis
        per ``s_step`` laps) or ``"chebyshev"`` (Chebyshev iteration: no
        dot inside a lap, checks every ``check_every`` laps).
      s_step: block size s for ``method="ca"`` (>= 1; 3-4 suit f32).
      check_every: laps between the exact residual checks of
        ``method="chebyshev"`` (>= 1); its lap counts round up to a
        multiple of it.
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
    pc_block_size: int = 64
    s_step: int = 3
    check_every: int = 8

    def __post_init__(self):
        if self.strategy not in ("allgather", "overlap"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.method not in ("cg", "pipelined", "ca", "chebyshev"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.s_step < 1:
            raise ValueError("s_step must be >= 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.method == "ca" and self.precondition != "none":
            raise ValueError(
                "method='ca' supports precondition='none' (a preconditioned CA basis "
                "needs split M^-1-weighted towers; use method='pipelined' for "
                "preconditioned latency hiding)"
            )
        if self.kernel not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown kernel backend {self.kernel!r}")
        if self.fused not in ("auto", "always", "never"):
            raise ValueError(f"unknown fused mode {self.fused!r}")
        if self.precondition not in ("none", "jacobi", "block_jacobi", "poly"):
            raise ValueError(f"unknown preconditioner {self.precondition!r}")
        if self.poly_degree < 1:
            raise ValueError("poly_degree must be >= 1")
        if self.pc_block_size < 2:
            raise ValueError("pc_block_size must be >= 2")
        if self.tol <= 0:
            raise ValueError("tol must be positive")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"solve dtype must be float32/float64, got {self.dtype}")
