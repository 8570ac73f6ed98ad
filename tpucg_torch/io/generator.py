"""Dense SPD test systems (a NumPy copy of ``tpucg.io.generator``'s dense
generators; the sparse ones come with their slices).

A = 0.5*(R + R^T) + n*I for uniform random R, as in the reference's
``generateSPDmatrix.m``: symmetric and strictly diagonally dominant, hence
SPD and well-conditioned (CG converges in a handful of laps).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_spd_system(
    n: int,
    seed: int = 0,
    dtype=np.float32,
    x0: str = "zeros",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random dense SPD system (A, b, x0); the same arrays as tpucg's for the
    same seed. x0 is zeros or ``"random"``."""
    rng = np.random.default_rng(seed)
    R = rng.random((n, n), dtype=np.float64)
    A = 0.5 * (R + R.T) + n * np.eye(n)
    b = rng.random(n, dtype=np.float64)
    if x0 == "zeros":
        x = np.zeros(n, dtype=dtype)
    elif x0 == "random":
        x = rng.random(n).astype(dtype)
    else:
        raise ValueError(f"unknown x0 mode {x0!r}")
    return A.astype(dtype), b.astype(dtype), x


def generate_spd_system_f32(
    n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Memory-lean float32 variant for large n: the same construction in
    float32 with in-place updates (peak host memory 2 * n^2 * 4 bytes). Draws
    a different random stream than ``generate_spd_system``."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n), dtype=np.float32)
    A = A + A.T
    A *= np.float32(0.5)
    idx = np.arange(n)
    A[idx, idx] += np.float32(n)
    b = rng.random(n, dtype=np.float32)
    return A, b, np.zeros(n, np.float32)
