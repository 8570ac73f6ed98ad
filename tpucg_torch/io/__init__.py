"""Host-side I/O: reference text format, MatrixMarket, generators, padding
(NumPy only)."""

from tpucg_torch.io.generator import (
    fem_p1_system,
    generate_spd_system,
    generate_spd_system_f32,
    random_geometric_spd,
)
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.io.mmio import load_matrix_market, save_matrix_market
from tpucg_torch.io.partitioner import RowPartition, pad_identity_tail, pad_system, round_up
from tpucg_torch.io.textio import (
    load_matrix,
    load_matrix_rows,
    load_system,
    load_vector,
    save_array,
)

__all__ = [
    "fem_p1_system",
    "generate_spd_system",
    "generate_spd_system_f32",
    "GOLDEN_2X2",
    "GOLDEN_4X4",
    "load_matrix_market",
    "random_geometric_spd",
    "save_matrix_market",
    "RowPartition",
    "pad_identity_tail",
    "pad_system",
    "round_up",
    "load_matrix",
    "load_matrix_rows",
    "load_system",
    "load_vector",
    "save_array",
]
