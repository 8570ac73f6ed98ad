"""Host-side I/O: reference text format, generators, padding (NumPy only)."""

from tpucg_torch.io.generator import generate_spd_system, generate_spd_system_f32
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.io.partitioner import pad_identity_tail, round_up
from tpucg_torch.io.textio import load_matrix, load_system, load_vector, save_array

__all__ = [
    "generate_spd_system",
    "generate_spd_system_f32",
    "GOLDEN_2X2",
    "GOLDEN_4X4",
    "pad_identity_tail",
    "round_up",
    "load_matrix",
    "load_system",
    "load_vector",
    "save_array",
]
