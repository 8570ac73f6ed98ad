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


def circulant_spd_batch(nsys: int, n: int, seed: int = 0):
    """A batch of dense SPD systems whose lap counts are fixed by their
    spectra, not by rounding: (A (nsys, n, n), b (nsys, n), X0 (nsys, n)),
    float32.

    System i is P C P^T for a dense symmetric circulant C whose spectrum
    takes m = 1 + i % 6 distinct levels, geometric in [0.2 n, 1.5 n], and a
    random permutation P; its diagonal is constant (the mean eigenvalue), so
    Jacobi only rescales it. CG and Jacobi-PCG on it end in m laps: the
    residual before lap m is a sizeable share of ||b|| and after it near the
    float32 floor, so a tolerance between the two (``tol=1e-2`` for n up to
    a few thousand) stops every correct float32 implementation on the same
    lap. b is uniform in [0, 1). X0 is zero except for the last system,
    which starts at an exact solution (x0 = e0 with b = A e0, column 0 of A,
    exact in any order of summation) and so stops at k = 0.
    """
    A = np.empty((nsys, n, n), np.float32)
    b = np.empty((nsys, n), np.float32)
    k = np.arange(n)
    wrap = (k[None, :] - k[:, None]) % n
    for i in range(nsys):
        rng = np.random.default_rng(seed + i)
        m = 1 + i % 6
        levels = n * np.geomspace(0.2, 1.5, m)
        pick = rng.integers(m, size=n // 2 + 1)
        pick[:m] = np.arange(m)  # every level occurs
        lam = levels[pick[np.minimum(k, n - k)]]  # lam_k = lam_{n-k}: C is real symmetric
        c = np.fft.ifft(lam).real
        p = rng.permutation(n)
        A[i] = c[wrap][p][:, p]
        b[i] = rng.random(n)
    X0 = np.zeros((nsys, n), np.float32)
    X0[-1, 0] = 1.0
    b[-1] = A[-1][:, 0]
    return A, b, X0


def shifted_spd_batch(nsys: int, n: int, seed: int = 0):
    """A batch of ``generate_spd_system``-style systems, each from its own
    seed (seed + i) and with its own shift: A = 0.5 (R + R^T) + s_i I with R
    uniform in [0, 1) and s_i geometric in [0.25 n, n] (the last two
    systems share the last shift), b uniform in [0, 1); float32 (A, b, X0).
    At tol 1e-6 they stop after 4 to 7 laps. X0 is zero except for the last
    system, which starts at the exact solution x0 = e0 (b = A e0) and stops
    at k = 0.

    At tol 1e-6 these stop where ||r|| is near ||b|| times float32's
    epsilon, so the rounding of r is of the order of tol itself: two correct
    float32 orders of summation can stop one lap apart, and their x then
    differ by the last lap's small step."""
    A = np.empty((nsys, n, n), np.float32)
    b = np.empty((nsys, n), np.float32)
    shifts = n * np.geomspace(0.25, 1.0, max(nsys - 1, 1))
    for i in range(nsys):
        rng = np.random.default_rng(seed + i)
        R = rng.random((n, n), dtype=np.float32)
        A[i] = 0.5 * (R + R.T)
        A[i][np.diag_indices(n)] += np.float32(shifts[min(i, len(shifts) - 1)])
        b[i] = rng.random(n, dtype=np.float32)
    X0 = np.zeros((nsys, n), np.float32)
    X0[-1, 0] = 1.0
    b[-1] = A[-1][:, 0]
    return A, b, X0


def random_banded_dia(n: int, offsets, seed: int = 0):
    """A random diagonally dominant SPD banded system in DIA form, built in
    O(ndiag n) (tpucg's ``tests/test_fused.py:_random_banded_system``
    without the dense matrix): for each positive offset k (in the given
    order) a standard normal band v of n - k values sits at +k and its
    mirror at -k; the main diagonal is 1 + the row's absolute off-diagonal
    sum; b is standard normal; float32. ``offsets`` must hold 0 and come in
    +-k pairs. Returns (offsets, data (ndiag, n), b)."""
    rng = np.random.default_rng(seed)
    offsets = tuple(int(o) for o in offsets)
    pos = {o: d for d, o in enumerate(offsets)}
    data = np.zeros((len(offsets), n), np.float32)
    for off in offsets:
        if off <= 0:
            continue
        v = rng.standard_normal(n - off).astype(np.float32)
        data[pos[off], : n - off] = v
        data[pos[-off], off:] = v
    data[pos[0]] = 1.0 + np.abs(np.delete(data, pos[0], axis=0)).sum(axis=0)
    b = rng.standard_normal(n).astype(np.float32)
    return offsets, data, b


# The offset sets of tpucg's fused DIA tests (tests/test_fused.py:307-311).
BAND_SETS = {
    "cross_row": (-130, -128, -3, -1, 0, 1, 3, 128, 130),
    "tridiagonal": (-1, 0, 1),
    "multi_row": (-257, 0, 257),
}


def banded_battery(nsys: int, n: int, seed: int = 0):
    """tpucg's battery of tridiagonal systems (``tests/test_batch.py``
    ``TestBatchBanded._battery``; ``benchmarks/extensions.py:241-254`` at
    256 x 1024): offsets (-1, 0, 1), both off-diagonal rows the same draw
    from U(0.2, 1), the main diagonal 4 + U(0, 1), b standard normal;
    float32. Returns (data (nsys, 3, n), offsets, b)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((nsys, 3, n), np.float32)
    off = rng.uniform(0.2, 1.0, (nsys, n)).astype(np.float32)
    data[:, 0] = off
    data[:, 2] = off
    data[:, 1] = 4.0 + rng.uniform(0, 1, (nsys, n)).astype(np.float32)
    b = rng.standard_normal((nsys, n)).astype(np.float32)
    return data, (-1, 0, 1), b


def scale_banded(data, seed: int = 2):
    """tpucg's badly scaled battery for Jacobi (``test_batch.py``
    ``test_jacobi_and_bf16``): A' = D A D with D = 10^U(-1, 1) per row, on a
    copy of a tridiagonal ``data`` (offsets (-1, 0, 1))."""
    data = data.copy()
    s = 10.0 ** np.random.default_rng(seed).uniform(
        -1, 1, (data.shape[0], data.shape[2])).astype(np.float32)
    data[:, 1] *= s * s
    data[:, 0, 1:] *= s[:, 1:] * s[:, :-1]
    data[:, 2, :-1] *= s[:, :-1] * s[:, 1:]
    return data


def banded_spectrum_battery(nsys: int, n: int, seed: int = 0):
    """A battery of tridiagonal SPD systems whose lap counts are set by
    their spectra: system i is block diagonal in 2 x 2 blocks [[a, c], [c,
    a]] (eigenvalues a -+ c) of t = 1 + i % 3 types, a geometric in [2, 8]
    and c / a in [0.3, 0.6] apart per type, so A has 2 t distinct
    eigenvalues, and so has D^-1 A (1 -+ c / a): CG and Jacobi-PCG end in
    2 t laps, with the residual before the last lap a sizeable share of
    ||b|| and after it near the float32 floor, so tol 1e-2 stops every
    correct float32 solve on the same lap. n is even; offsets (-1, 0, 1); b
    standard normal; float32. Returns (data (nsys, 3, n), offsets, b, laps)."""
    if n % 2:
        raise ValueError("banded_spectrum_battery needs an even n")
    rng = np.random.default_rng(seed)
    data = np.zeros((nsys, 3, n), np.float32)
    laps = []
    for i in range(nsys):
        t = 1 + i % 3
        a = np.geomspace(2.0, 8.0, t) if t > 1 else np.array([4.0])
        rho = np.linspace(0.3, 0.6, t)
        kind = rng.integers(t, size=n // 2)
        kind[:t] = np.arange(t)
        av, cv = a[kind], (a * rho)[kind]
        data[i, 1] = np.repeat(av, 2)
        data[i, 2, 0::2] = cv  # A[2j, 2j + 1]
        data[i, 0, 1::2] = cv  # A[2j + 1, 2j]
        laps.append(2 * t)
    b = rng.standard_normal((nsys, n)).astype(np.float32)
    return data, (-1, 0, 1), b, laps


def scaled_err(x, want) -> float:
    """max |x - want| / max |want| per system (the last axis), the largest
    over the systems: an error measured against the size of the solution."""
    x = np.asarray(x, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(x - want).max(-1) / np.abs(want).max(-1)).max())


@pytest.fixture
def cuda_device():
    """The first CUDA device; tests that need the card skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    from tpucg_torch.kernels.dispatch import strict_f32

    strict_f32()
    return torch.device("cuda", 0)
