"""CG solver: the chunked device loops, the dense, DIA, Poisson, WELL, BSR
and ELL operators, the distributed solves, the NumPy oracle, and the plain
versions of the whole-solve kernels."""

from tpucg_torch.solver.cg import (
    CGResult,
    batch_cg_loop,
    cg_loop,
    cg_solve,
    cg_solve_batch,
    cg_solve_batch_banded,
    init_state,
    lambda_max_estimate,
    lap_ops,
    make_poly_precond,
)
from tpucg_torch.solver.fused import (
    fused_batch_cg_solve,
    fused_batch_cg_solve_torch,
    fused_batch_dia_cg_solve,
    fused_batch_dia_cg_solve_torch,
    fused_cg_solve,
    fused_cg_solve_torch,
    fused_dia_cg_solve,
    fused_dia_cg_solve_torch,
    fused_stencil_cg_solve,
    fused_stencil_cg_solve_torch,
)
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

__all__ = [
    "CGResult",
    "batch_cg_loop",
    "cg_loop",
    "cg_solve",
    "cg_solve_batch",
    "cg_solve_batch_banded",
    "fused_batch_cg_solve",
    "fused_batch_cg_solve_torch",
    "fused_batch_dia_cg_solve",
    "fused_batch_dia_cg_solve_torch",
    "fused_cg_solve",
    "fused_cg_solve_torch",
    "fused_dia_cg_solve",
    "fused_dia_cg_solve_torch",
    "fused_stencil_cg_solve",
    "fused_stencil_cg_solve_torch",
    "init_state",
    "lambda_max_estimate",
    "lap_ops",
    "make_poly_precond",
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
    "DistributedSystem",
    "distribute_system",
    "sharded_cg_solve",
    "sharded_operator_cg_solve",
]
