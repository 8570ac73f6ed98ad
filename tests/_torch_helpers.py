"""Shared helpers of the ``test_torch_*`` files (tpucg_torch vs tpucg).

Inputs are made with NumPy from a seed and handed to both packages; JAX runs
on the CPU (tests/conftest.py), its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

# Tier-1 runs six xdist workers: default torch threading on each would
# oversubscribe the machine.
torch.set_num_threads(1)


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def spd_kappa(n: int, kappa: float, seed: int):
    """A = Q diag(lambda) Q^T with lambda spread over [1, kappa], and b."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1.0, kappa, n)
    A = ((Q * lam) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    b = rng.standard_normal(n).astype(np.float32)
    return A, b


@pytest.fixture
def cuda_device():
    """The first CUDA device; tests that need the card skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    from tpucg_torch.kernels.dispatch import strict_f32

    strict_f32()
    return torch.device("cuda", 0)
