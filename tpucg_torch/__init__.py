"""tpucg_torch — the tpucg conjugate-gradient solver on PyTorch and CUDA.

A port of the JAX package ``tpucg`` (which stays as the reference) to one
NVIDIA H100. This slice carries the dense main path: a dense SPD system
(generated or loaded) goes through ``DenseOperator`` (identity-tail padding,
f32 or bf16 storage) into ``cg_solve``, whose laps run three hand-written
CUDA kernels for Hopper: the GEMV (K1), the fused x/r update with beta (K2)
and the dot (K3). The package imports neither ``jax`` nor ``tpucg``.
"""

from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import generate_spd_system, generate_spd_system_f32
from tpucg_torch.io.textio import load_matrix, load_system, load_vector, save_array
from tpucg_torch.solver.cg import CGResult, cg_solve
from tpucg_torch.solver.operators import DenseOperator, LinearOperator, as_operator
from tpucg_torch.solver.oracle import oracle_cg

__version__ = "0.1.0"

__all__ = [
    "CGConfig",
    "CGResult",
    "cg_solve",
    "DenseOperator",
    "LinearOperator",
    "as_operator",
    "oracle_cg",
    "generate_spd_system",
    "generate_spd_system_f32",
    "load_matrix",
    "load_system",
    "load_vector",
    "save_array",
]
