"""Kernel backend and device resolution.

Backends: ``"cuda"`` runs the hand-written kernels of ``csrc/`` (the
counterpart of tpucg's ``"pallas"``); ``"torch"`` runs their plain PyTorch
versions (the counterpart of ``"xla"``) on whatever device the tensors are.
"""

from __future__ import annotations

from typing import Optional

import torch

BACKENDS = ("auto", "cuda", "torch")


def require_card(what: str) -> None:
    """Raise unless there is a card: ``what`` runs on the card, and nothing
    carries on on the CPU unless the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a card and there is none: pass device='cpu'")


def canonical_device(device=None) -> torch.device:
    """``device`` as a torch.device with its index: ``"cuda"`` means the
    current CUDA device, as tensors placed there report it (``cuda:0``).
    None means the card; with no card it raises, and the CPU is had only by
    asking for it (``device='cpu'``)."""
    if device is None:
        require_card("device=None")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_backend(kernel: str = "auto", device=None) -> str:
    """Map ``CGConfig.kernel`` to a concrete backend.

    ``"auto"`` gives ``"cuda"`` when the data lives on a CUDA device and
    ``"torch"`` otherwise; with no ``device`` it means the card, and raises
    as ``canonical_device(None)`` does when there is none. Asking for
    ``"cuda"`` where there is no CUDA device raises: nothing falls back.
    """
    if kernel not in BACKENDS:
        raise ValueError(f"unknown kernel backend {kernel!r}")
    if kernel == "auto" and device is None:
        device = canonical_device(None)
    on_cuda = (
        torch.cuda.is_available()
        if device is None
        else torch.device(device).type == "cuda"
    )
    if kernel == "auto":
        return "cuda" if on_cuda else "torch"
    if kernel == "cuda" and not on_cuda:
        where = "CUDA is not available" if device is None else f"device is {device}"
        raise RuntimeError(f"kernel='cuda' needs a CUDA device ({where})")
    return kernel


def strict_f32() -> None:
    """Keep float32 matrix products in full float32 on the card (no TF32):
    the CG contract is float32, and the plain references must be too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def cuda_stream(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device: kernels launch on it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_active(active: Optional[torch.Tensor], like: torch.Tensor) -> None:
    """The kernels' ``active`` flag: a 0-d int32 tensor on ``like``'s device."""
    if active is None:
        return
    if active.dtype != torch.int32 or active.dim() != 0 or active.device != like.device:
        raise ValueError(
            "active must be a 0-d int32 tensor on the kernel's device, got "
            f"{active.dtype} shape {tuple(active.shape)} on {active.device}"
        )
