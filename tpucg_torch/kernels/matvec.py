"""Dense GEMV: y = A @ x, the hot kernel of CG (every lap, and the initial
residual). K1 of the port; ``csrc/blas.cu`` holds the kernel and its design
note. Shapes may be rectangular (rows, cols), as row-sharded solves need.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

# Operators pad once at construction to a multiple of 128 in both dimensions
# (tpucg's MATVEC_ALIGN), on every backend, so the CPU tests run the padded
# shapes the card runs. The kernel itself needs only cols % 8 == 0.
MATVEC_ALIGN = (128, 128)
_COL_ALIGN = 8  # one 16-byte load holds 8 bf16 (or 4 f32) of a row


def matvec_torch(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: float32 products and sums (bf16 A widened)."""
    matvec_torch.launches += 1
    return A.to(torch.float32) @ x


matvec_torch.launches = 0


def check_matvec(A: torch.Tensor, x: Optional[torch.Tensor] = None) -> None:
    """K1's operands, as ``matvec_cuda`` checks them before a launch; with no
    ``x``, A alone."""
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matvec_cuda supports f32/bf16 A, got {A.dtype}")
    if x is not None and x.dtype != torch.float32:
        raise ValueError(f"matvec_cuda needs f32 x, got {x.dtype}")
    if A.dim() != 2 or (x is not None and (x.dim() != 1 or x.shape[0] != A.shape[1])):
        raise ValueError(
            f"matvec_cuda needs A (rows, cols) and x (cols,), got "
            f"{tuple(A.shape)} and {None if x is None else tuple(x.shape)}"
        )
    rows, cols = A.shape
    if rows == 0 or cols == 0 or cols % _COL_ALIGN:
        raise ValueError(
            f"matvec_cuda needs rows > 0 and cols % {_COL_ALIGN} == 0, got "
            f"{tuple(A.shape)}; pad via DenseOperator.create"
        )
    vs = (A,) if x is None else (A, x)
    if not all(v.is_contiguous() for v in vs):
        raise ValueError("matvec_cuda needs contiguous A and x")
    if any(v.data_ptr() % 16 for v in vs):
        raise ValueError("matvec_cuda needs 16-byte aligned A and x")
    if A.device.type != "cuda" or any(v.device != A.device for v in vs):
        raise ValueError(
            f"matvec_cuda needs A and x on one CUDA device, got {A.device} "
            f"and {None if x is None else x.device}"
        )


def gemv_launch(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                active: Optional[int], stream: int) -> None:
    """Launch K1, y = A @ x, with no checks: the caller has checked A and x
    as ``matvec_cuda`` does and owns y. ``active`` is the flag's device
    pointer or None; ``stream`` a CUDA stream handle. The one place that
    counts K1's launches."""
    lib = _lib.load()
    fn = lib.tpucg_gemv_f32 if A.dtype == torch.float32 else lib.tpucg_gemv_bf16
    err = fn(A.data_ptr(), x.data_ptr(), y.data_ptr(), A.shape[0], A.shape[1], active, stream)
    if err:
        _lib.check(err, "matvec_cuda")
    matvec_cuda.launches += 1


def matvec_cuda(
    A: torch.Tensor, x: torch.Tensor, *, active: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K1 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined."""
    check_matvec(A, x)
    check_active(active, A)
    y = torch.empty(A.shape[0], dtype=torch.float32, device=A.device)
    gemv_launch(A, x, y, None if active is None else active.data_ptr(), cuda_stream(A))
    return y


matvec_cuda.launches = 0


def matvec(
    A: torch.Tensor,
    x: torch.Tensor,
    backend: str = "auto",
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = A @ x. ``"auto"`` launches K1 for a CUDA tensor and takes the
    plain version for a CPU tensor; ``active`` is read by K1 only."""
    if resolve_backend(backend, A.device) == "cuda":
        return matvec_cuda(A, x, active=active)
    return matvec_torch(A, x)
