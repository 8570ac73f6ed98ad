"""Linear operators: what CG needs of A (the dense slice of
``tpucg.solver.operators``).

A ``DenseOperator`` pads once at construction with an identity tail to a
multiple of 128 (``MATVEC_ALIGN``) on every backend, so its ``padded_n``
equals tpucg's ``DenseOperator.create(..., backend="pallas")`` and the hot
matvec never pads again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpucg_torch.io.partitioner import pad_identity_tail, round_up
from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
from tpucg_torch.kernels.matvec import MATVEC_ALIGN, matvec

# Sparse containers of tpucg (and torch's sparse layouts) arrive with the
# ROADMAP's sparse slices; as_operator names them instead of densifying.
_SPARSE_TYPES = ("CSRMatrix", "EllMatrix", "BSRMatrix", "DIAMatrix", "WellMatrix", "COOMatrix")


def padded_size(n: int) -> int:
    """The device-side size of an n x n dense operator."""
    return round_up(n, int(np.lcm(*MATVEC_ALIGN)))


class LinearOperator:
    """Abstract SPD operator: ``matvec`` and the logical size ``n``."""

    n: int

    @property
    def padded_n(self) -> int:
        """Device-side vector length (>= n)."""
        return self.n

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def diagonal(self) -> torch.Tensor:
        """diag(A), padded length, for the Jacobi preconditioner."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a diagonal; "
            "precondition='jacobi' is unavailable for it"
        )


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense SPD matrix, padded with an identity tail, stored f32 or bf16.

    ``backend`` resolves against A's device when the operator is made:
    ``"auto"`` is ``"cuda"`` for a CUDA tensor and ``"torch"`` otherwise, and
    ``"cuda"`` for a CPU tensor raises."""

    A: torch.Tensor
    n: int
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "backend", resolve_backend(self.backend, self.A.device))

    @classmethod
    def create(cls, A, backend: str = "auto", dtype=torch.float32, device=None) -> "DenseOperator":
        """``dtype`` is the device storage dtype of A: float32 (the reference
        contract) or bfloat16 (half the bytes per matvec, f32 accumulation).
        ``device`` defaults to A's device for a tensor, else the card when
        there is one; ``backend`` resolves against it."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"storage dtype {dtype} is ROADMAP M9 (f64); this slice stores f32 or bf16"
            )
        if isinstance(A, torch.Tensor):
            device = A.device if device is None else device
            A = A.detach().to("cpu", torch.float32).numpy()
        device = canonical_device(device)
        A = np.asarray(A, dtype=np.float32)
        n = A.shape[0]
        if A.shape != (n, n):
            raise ValueError(f"A must be square, got {A.shape}")
        A = pad_identity_tail(A, padded_size(n))
        return cls(A=torch.from_numpy(A).to(device=device, dtype=dtype), n=n, backend=backend)

    @property
    def padded_n(self) -> int:
        return self.A.shape[0]

    @property
    def device(self) -> torch.device:
        return self.A.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x; ``active`` is the CUDA kernel's lap flag (see matvec_cuda)."""
        return matvec(self.A, x, backend=self.backend, active=active)

    def diagonal(self) -> torch.Tensor:
        # The identity tail gives 1.0 there, safe to invert; bf16 widened.
        return torch.diagonal(self.A).to(torch.float32)


def as_operator(A, backend: str = "auto", dtype=torch.float32, device=None) -> LinearOperator:
    """A dense array or tensor, or an operator, as a LinearOperator
    (operators are returned unchanged)."""
    if isinstance(A, LinearOperator):
        return A
    if type(A).__name__ in _SPARSE_TYPES or getattr(A, "is_sparse", False):
        raise NotImplementedError(
            f"{type(A).__name__}: sparse operators are ROADMAP slices C and D "
            "(M10 DIA/Poisson/BSR/ELL, M11 WELL); this slice is dense"
        )
    ndim = A.dim() if isinstance(A, torch.Tensor) else np.ndim(A)
    if ndim == 2:
        return DenseOperator.create(A, backend=backend, dtype=dtype, device=device)
    raise TypeError(f"cannot interpret {type(A)!r} as a linear operator")
