"""Sparse containers, the WELL packing and locality orderings on the host
(NumPy only)."""

from tpucg_torch.sparse.formats import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    DIAMatrix,
    EllMatrix,
    csr_to_bsr,
    csr_to_dia,
    csr_to_ell,
)
from tpucg_torch.sparse.ordering import permute_csr, rcm_order, strength_order
from tpucg_torch.sparse.well import (
    WellMatrix,
    csr_to_well,
    csr_to_well_sharded,
    local_rows_to_well_shard,
    pad_well_shard,
)

__all__ = [
    "BSRMatrix",
    "COOMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "EllMatrix",
    "WellMatrix",
    "csr_to_bsr",
    "csr_to_dia",
    "csr_to_ell",
    "csr_to_well",
    "csr_to_well_sharded",
    "local_rows_to_well_shard",
    "pad_well_shard",
    "permute_csr",
    "rcm_order",
    "strength_order",
]
