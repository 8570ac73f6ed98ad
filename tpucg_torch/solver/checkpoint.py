"""The operator probe signature of saved solver state (the counterpart of
``tpucg/solver/checkpoint.py:50-107``).

A saved state (``RecyclingCG.save_state``'s ``.npz``) carries random
projections of A applied to a fixed pseudorandom probe, and of b, so state
saved for another system of the same size is refused instead of resumed.
The probe and the projections come from tpucg's rng stream, so a state
saved by either package checks against the other's operator. The
signatures are compared with a relative tolerance per block
(``signatures_match``): kernels that sum in another order perturb the probe
response at ~1e-7, another system by O(1).
"""

from __future__ import annotations

import numpy as np
import torch


def _signature_probe_and_R(npad: int):
    """The probe vector (npad,) f32 and the (4, npad) projection (tpucg's
    rng stream, seed 0xC6)."""
    rng = np.random.default_rng(0xC6)
    probe = rng.standard_normal(npad).astype(np.float32)
    R = rng.standard_normal((4, npad))
    return probe, R


def _project_signature(R: np.ndarray, y: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate([R @ np.asarray(y, np.float64), R @ np.asarray(b, np.float64)])


def system_signature(op, b) -> np.ndarray:
    """Random projections of A applied to the probe, then of b (padded
    length, a NumPy array or a tensor). ``op`` is an operator (its
    ``matvec`` runs on its device) or a bare matvec taking a tensor."""
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    npad = b.shape[0]
    probe, R = _signature_probe_and_R(npad)
    mv = op.matvec if hasattr(op, "matvec") else op
    device = getattr(op, "device", "cpu")
    y = mv(torch.from_numpy(probe).to(device))
    return _project_signature(R, y.detach().cpu().numpy().astype(np.float64),
                              b.astype(np.float64))


def signatures_match(a: np.ndarray, b: np.ndarray, rtol: float = 1e-4) -> bool:
    """Each half (the A block, the b block) within ``rtol`` of its own
    scale: a changed b must not hide under the A block's tolerance."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    half = a.size // 2
    for sl in (slice(0, half), slice(half, None)):
        sa, sb = a[sl], b[sl]
        scale = float(np.max(np.maximum(np.abs(sa), np.abs(sb)))) + 1e-30
        if not np.all(np.abs(sa - sb) <= rtol * scale):
            return False
    return True
