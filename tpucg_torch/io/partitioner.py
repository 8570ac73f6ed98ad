"""Identity-tail padding (a NumPy copy of ``tpucg.io.partitioner``).

Padding A with a decoupled identity block and b/x with zeros leaves the
original solution untouched: the pad rows solve 1*x_pad = 0, stay at zero
residual from lap 0 and add nothing to any dot product.
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_identity_tail(A: np.ndarray, npad: int) -> np.ndarray:
    """Embed n x n ``A`` into npad x npad with a decoupled identity tail."""
    n = A.shape[0]
    if npad == n:
        return A
    Ap = np.zeros((npad, npad), dtype=A.dtype)
    Ap[:n, :n] = A
    idx = np.arange(n, npad)
    Ap[idx, idx] = 1.0
    return Ap
