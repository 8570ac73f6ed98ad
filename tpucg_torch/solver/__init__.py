"""CG solver: the chunked device loop, the dense operator, the NumPy oracle."""

from tpucg_torch.solver.cg import CGResult, cg_loop, cg_solve, init_state, lap_ops
from tpucg_torch.solver.operators import DenseOperator, LinearOperator, as_operator
from tpucg_torch.solver.oracle import oracle_cg

__all__ = [
    "CGResult",
    "cg_loop",
    "cg_solve",
    "init_state",
    "lap_ops",
    "DenseOperator",
    "LinearOperator",
    "as_operator",
    "oracle_cg",
]
