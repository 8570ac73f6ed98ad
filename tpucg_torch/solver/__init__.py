"""CG solver: the chunked device loops, the dense, DIA and Poisson operators,
the NumPy oracle, and the plain versions of the whole-solve kernels."""

from tpucg_torch.solver.cg import (
    CGResult,
    batch_cg_loop,
    cg_loop,
    cg_solve,
    cg_solve_batch,
    init_state,
    lambda_max_estimate,
    lap_ops,
    make_poly_precond,
)
from tpucg_torch.solver.fused import (
    fused_batch_cg_solve,
    fused_batch_cg_solve_torch,
    fused_cg_solve,
    fused_cg_solve_torch,
    fused_dia_cg_solve,
    fused_dia_cg_solve_torch,
    fused_stencil_cg_solve,
    fused_stencil_cg_solve_torch,
)
from tpucg_torch.solver.operators import (
    DenseOperator,
    DiaOperator,
    LinearOperator,
    PoissonOperator,
    as_operator,
)
from tpucg_torch.solver.oracle import oracle_cg

__all__ = [
    "CGResult",
    "batch_cg_loop",
    "cg_loop",
    "cg_solve",
    "cg_solve_batch",
    "fused_batch_cg_solve",
    "fused_batch_cg_solve_torch",
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
    "DenseOperator",
    "DiaOperator",
    "LinearOperator",
    "PoissonOperator",
    "as_operator",
    "oracle_cg",
]
