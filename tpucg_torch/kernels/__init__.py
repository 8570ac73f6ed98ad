"""The CG lap's kernels: hand-written CUDA for Hopper (``csrc/``), each with
its plain PyTorch version beside it.

K1 ``matvec_cuda`` (dense GEMV), K2 ``fused_update_cuda`` (x/r update and
beta = r'.r' in one pass) and K3 ``dot_cuda``. The kernel library is built
by ``nvcc`` at first use (``_lib``); importing this package builds nothing.
"""

from tpucg_torch.kernels.blas1 import (
    dot_cuda,
    dot_torch,
    fused_update,
    fused_update_cuda,
    fused_update_torch,
)
from tpucg_torch.kernels.dispatch import resolve_backend
from tpucg_torch.kernels.matvec import MATVEC_ALIGN, matvec, matvec_cuda, matvec_torch

__all__ = [
    "dot_cuda",
    "dot_torch",
    "fused_update",
    "fused_update_cuda",
    "fused_update_torch",
    "resolve_backend",
    "MATVEC_ALIGN",
    "matvec",
    "matvec_cuda",
    "matvec_torch",
]
