"""tpucg_torch — the tpucg conjugate-gradient solver on PyTorch and CUDA.

A port of the JAX package ``tpucg`` (which stays as the reference) to one
NVIDIA H100. A dense SPD system (generated or loaded) goes through
``DenseOperator`` (identity-tail padding, f32 or bf16 storage) into
``cg_solve``: classic CG, or tpucg's pipelined, s-step (CA) and Chebyshev
methods, unpreconditioned or with Jacobi, block-Jacobi or polynomial
preconditioning (``spectral_interval`` gives CA and Chebyshev their
interval once). Small solves run whole in one
launch of a hand-written CUDA kernel for Hopper (K4); the others run laps of
three: the GEMV (K1), the fused x/r update with beta (K2) and the dot (K3).
The 3-D Poisson Laplacian runs as a stencil (``PoissonOperator``, K8 on the
lap, K10 for the whole solve) and banded matrices in DIA form
(``DiaOperator``, K6 on the lap, K11 for the whole solve). Sparse systems,
from MatrixMarket files or the generators, go through
``best_sparse_operator``, which picks DIA, BSR, WELL (irregular matrices,
``WellOperator``, K13 on the lap) or ELL as tpucg does.
``cg_solve_batch`` solves B independent systems, in one launch of K5 where
it applies, and ``cg_solve_batch_banded`` B banded ones (K12).
``cg_solve_multi`` solves k right-hand sides of one system in lockstep and
``cg_solve_block`` by true block CG, both on the operators' k-column
products (K6 x k, K8 x k, K13 x k); ``cg_solve(dtype=torch.float64)``
solves in f64 on plain torch ops, and ``cg_solve_ir`` refines a bf16-rate
dense solve to the f32 contract. ``build_two_level`` builds tpucg's
two-level (and, with ``coarse_max``, multilevel) preconditioner for
``cg_solve(two_level=)``, which then stops on the true residual every 16
laps; ``cg_solve_deflated`` and ``RecyclingCG`` deflate with a basis
(``build_deflation_basis``, ``DeflationBasis``) or with a sequence's own
solutions; ``minres_solve`` solves symmetric indefinite systems
(``abs_inv_blocks`` for block Jacobi there). All of these are serial.
``sharded_cg_solve`` and ``sharded_operator_cg_solve`` distribute a solve's
rows over the ranks of a ``torch.distributed`` world (``make_mesh``,
``init_distributed``): dense with the allgather or overlap-ring exchange,
Poisson on slabs with plane halos (K9), DIA on row blocks with band halos
(K7), ELL and BSR. The package imports neither ``jax`` nor ``tpucg``.
"""

from tpucg_torch.comm.mesh import Mesh, init_distributed, make_mesh
from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import (
    fem_p1_system,
    generate_spd_system,
    generate_spd_system_f32,
    poisson3d_csr,
    poisson3d_dia,
    random_geometric_spd,
)
from tpucg_torch.io.mmio import load_matrix_market, save_matrix_market
from tpucg_torch.io.textio import load_matrix, load_system, load_vector, save_array
from tpucg_torch.solver.cg import (
    BLOCK_CG_MAX_K,
    CGResult,
    cg_solve,
    cg_solve_batch,
    cg_solve_batch_banded,
    cg_solve_block,
    cg_solve_multi,
    spectral_interval,
)
from tpucg_torch.solver.deflation import (
    DeflationBasis,
    RecyclingCG,
    build_deflation_basis,
    cg_solve_deflated,
)
from tpucg_torch.solver.ir import cg_solve_ir
from tpucg_torch.solver.minres import abs_inv_blocks, minres_solve
from tpucg_torch.solver.operators import (
    BsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    LinearOperator,
    PoissonOperator,
    WellOperator,
    as_operator,
    best_sparse_operator,
)
from tpucg_torch.solver.oracle import oracle_cg
from tpucg_torch.solver.sharded import (
    DistributedSystem,
    distribute_system,
    sharded_cg_solve,
    sharded_operator_cg_solve,
)
from tpucg_torch.solver.twolevel import TwoLevel, build_two_level
from tpucg_torch.sparse.formats import COOMatrix, CSRMatrix, DIAMatrix, csr_to_dia
from tpucg_torch.sparse.well import WellMatrix, csr_to_well

__version__ = "0.1.0"

__all__ = [
    "CGConfig",
    "CGResult",
    "cg_solve",
    "cg_solve_batch",
    "cg_solve_batch_banded",
    "cg_solve_block",
    "cg_solve_ir",
    "cg_solve_multi",
    "BLOCK_CG_MAX_K",
    "spectral_interval",
    "TwoLevel",
    "build_two_level",
    "DeflationBasis",
    "RecyclingCG",
    "build_deflation_basis",
    "cg_solve_deflated",
    "abs_inv_blocks",
    "minres_solve",
    "DistributedSystem",
    "Mesh",
    "distribute_system",
    "init_distributed",
    "make_mesh",
    "sharded_cg_solve",
    "sharded_operator_cg_solve",
    "BsrOperator",
    "DenseOperator",
    "DiaOperator",
    "EllOperator",
    "LinearOperator",
    "PoissonOperator",
    "WellOperator",
    "as_operator",
    "best_sparse_operator",
    "oracle_cg",
    "COOMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "csr_to_dia",
    "csr_to_well",
    "WellMatrix",
    "fem_p1_system",
    "random_geometric_spd",
    "load_matrix_market",
    "save_matrix_market",
    "generate_spd_system",
    "generate_spd_system_f32",
    "poisson3d_csr",
    "poisson3d_dia",
    "load_matrix",
    "load_system",
    "load_vector",
    "save_array",
]
