"""Linear operators: what CG needs of A (the dense and structured-sparse
parts of ``tpucg.solver.operators``).

A ``DenseOperator`` pads once at construction with an identity tail to a
multiple of 128 (``MATVEC_ALIGN``) on every backend, so its ``padded_n``
equals tpucg's ``DenseOperator.create(..., backend="pallas")`` and the hot
matvec never pads again. A ``DiaOperator`` holds a banded matrix's (ndiag,
npad) slab (K6), padded as tpucg's ``DiaOperator.from_dia`` pads it; a
``PoissonOperator`` applies the 3-D 7-point Laplacian as a stencil (K8),
with no stored matrix.

Each operator's ``launcher()`` checks its stored operands once and returns
its kernel's launch core, ``launch(x, y, active, stream)``, which the CUDA
lap (``cg._cuda_lap_ops``) calls every lap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpucg_torch.io.partitioner import pad_identity_tail, round_up
from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
from tpucg_torch.kernels.matvec import MATVEC_ALIGN, check_matvec, gemv_launch, matvec
from tpucg_torch.kernels.spmv import LANE, check_dia, dia_spmv, dia_spmv_launch, offsets_array
from tpucg_torch.kernels.stencil import (
    STENCIL_MAX_M,
    poisson3d,
    poisson3d_launch,
    stencil_supported,
)

# Sparse containers that arrive with ROADMAP slice D (and torch's sparse
# layouts); as_operator names them instead of densifying.
_SPARSE_TYPES = ("CSRMatrix", "EllMatrix", "BSRMatrix", "WellMatrix", "COOMatrix")


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

    def diagonal_blocks(self, bs: int) -> torch.Tensor:
        """The (nb, bs, bs) diagonal blocks of block Jacobi."""
        raise NotImplementedError(
            f"{type(self).__name__}.diagonal_blocks serves block Jacobi: ROADMAP M8"
        )

    def launcher(self) -> Callable:
        """Check the stored operands once and return the kernel's launch core
        ``launch(x, y, active, stream)`` (cuda backend only)."""
        raise NotImplementedError(f"{type(self).__name__} has no CUDA lap kernel")


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

    def launcher(self) -> Callable:
        A = self.A
        check_matvec(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"the CG lap needs a square A, got {tuple(A.shape)}")
        return lambda x, y, active, stream: gemv_launch(A, x, y, active, stream)


@dataclasses.dataclass(frozen=True)
class DiaOperator(LinearOperator):
    """Banded operator in DIA form: the (ndiag, npad) slab ``data`` (f32 or
    bf16, ``data[d, i] = A[i, i + offsets[d]]``) and its ``offsets``.

    ``from_dia`` pads as tpucg's ``DiaOperator.from_dia`` does: to a multiple
    of 128 with an identity tail on the main diagonal, and only when 0 is
    among the offsets (else the logical n stays), so ``padded_n`` is
    tpucg's. The slab stays in the canonical layout: tpucg's row-interleaved
    packing is a TPU DMA layout (``interop.dia_operator_from_numpy`` carries
    a packed tpucg operator across). ``backend`` resolves against the slab's
    device as ``DenseOperator``'s does."""

    data: torch.Tensor
    offsets: Sequence[int]
    n: int
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "offsets", tuple(int(o) for o in self.offsets))
        object.__setattr__(self, "backend", resolve_backend(self.backend, self.data.device))
        if self.data.dim() != 2 or self.data.shape[0] != len(self.offsets):
            raise ValueError(
                f"DiaOperator needs a (ndiag, npad) slab for {len(self.offsets)} offsets, "
                f"got {tuple(self.data.shape)}"
            )
        if self.backend == "cuda":
            check_dia(self.data, self.offsets)

    @classmethod
    def from_dia(cls, dia, backend: str = "auto", storage_dtype=torch.float32,
                 device=None) -> "DiaOperator":
        """``dia`` is a ``DIAMatrix`` (this package's or tpucg's).
        ``storage_dtype=torch.bfloat16`` stores the slab in bf16: half the
        bytes K6 and K11 stream, f32 sums, and the solve meets the f32
        contract on the bf16-rounded system. ``device`` defaults to the card
        when there is one."""
        if storage_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
        data = np.asarray(dia.data, dtype=np.float32)
        n = int(dia.shape[0])
        offsets = tuple(int(o) for o in dia.offsets)
        npad = round_up(n, LANE)
        if npad != n and 0 in offsets:
            padded = np.zeros((data.shape[0], npad), dtype=np.float32)
            padded[:, :n] = data
            padded[offsets.index(0), n:] = 1.0  # identity tail (partitioner)
            data = padded
        t = torch.from_numpy(np.ascontiguousarray(data))
        t = t.to(device=canonical_device(device), dtype=storage_dtype)
        return cls(data=t, offsets=offsets, n=n, backend=backend)

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def padded_n(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x; ``active`` is the CUDA kernel's lap flag (see dia_spmv_cuda)."""
        return dia_spmv(self.data, self.offsets, x, backend=self.backend, active=active)

    def diagonal(self) -> torch.Tensor:
        if 0 not in self.offsets:
            return torch.zeros(self.padded_n, dtype=torch.float32, device=self.device)
        return self.data[self.offsets.index(0)].to(torch.float32)  # bf16 widened

    def launcher(self) -> Callable:
        data = self.data
        check_dia(data, self.offsets)
        offs = offsets_array(self.offsets)
        return lambda x, y, active, stream: dia_spmv_launch(data, offs, x, y, active, stream)


@dataclasses.dataclass(frozen=True)
class PoissonOperator(LinearOperator):
    """Matrix-free 3-D 7-point Dirichlet Laplacian on an m^3 grid: the same
    operator as ``poisson3d_csr(m)``, applied as 6 u minus the in-grid
    neighbours, with no stored matrix. n = padded_n = m^3. ``device``
    defaults to the card when there is one; ``backend`` resolves against it
    (tpucg's ``kernel`` field)."""

    m: int
    backend: str = "auto"
    device: Optional[torch.device] = None

    def __post_init__(self):
        device = canonical_device(self.device)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "backend", resolve_backend(self.backend, device))
        if not stencil_supported(self.m):
            raise ValueError(f"PoissonOperator needs 2 <= m <= {STENCIL_MAX_M}, got m={self.m}")

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.m ** 3

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x; ``active`` is the CUDA kernel's lap flag (see poisson3d_cuda)."""
        return poisson3d(x, self.m, backend=self.backend, active=active)

    def diagonal(self) -> torch.Tensor:
        return torch.full((self.n,), 6.0, dtype=torch.float32, device=self.device)

    def launcher(self) -> Callable:
        m = self.m
        return lambda x, y, active, stream: poisson3d_launch(x, y, m, active, stream)


def as_operator(A, backend: str = "auto", dtype=torch.float32, device=None) -> LinearOperator:
    """A dense array or tensor, a ``DIAMatrix`` (this package's or tpucg's;
    ``dtype`` is its slab's storage dtype), or an operator, as a
    LinearOperator (operators are returned unchanged)."""
    if isinstance(A, LinearOperator):
        return A
    if type(A).__name__ == "DIAMatrix":
        return DiaOperator.from_dia(A, backend=backend, storage_dtype=dtype, device=device)
    if type(A).__name__ in _SPARSE_TYPES or getattr(A, "is_sparse", False):
        raise NotImplementedError(
            f"{type(A).__name__}: CSR/COO/ELL/BSR/WELL inputs and best_sparse_operator are "
            "ROADMAP slice D (M10's BSR/ELL, M11 WELL); pass a DIAMatrix, a "
            "PoissonOperator or a dense array"
        )
    ndim = A.dim() if isinstance(A, torch.Tensor) else np.ndim(A)
    if ndim == 2:
        return DenseOperator.create(A, backend=backend, dtype=dtype, device=device)
    raise TypeError(f"cannot interpret {type(A)!r} as a linear operator")
