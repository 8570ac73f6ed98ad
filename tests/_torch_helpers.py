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


def tpucg_padded_dense(A):
    """tpucg's XLA ``DenseOperator`` of A padded as the port pads it (an
    identity tail to a multiple of 128), so both packages solve the same
    operator: the spectrum (and the interval estimates of CA and
    Chebyshev) includes the tail's eigenvalue 1. Imports tpucg (jax) when
    called."""
    import jax.numpy as jnp

    import tpucg
    from tpucg.io.partitioner import pad_identity_tail

    A = np.asarray(A, np.float32)
    n = A.shape[0]
    npad = -(-n // 128) * 128
    return tpucg.DenseOperator(A=jnp.asarray(pad_identity_tail(A, npad)), n=n, backend="xla")


def held_to(port, ref, laps: int, x_true=None) -> int:
    """Hold a port solve to tpucg's (``CGResult``s): laps within ``laps``,
    the same ``converged``, and where the laps are equal x within 1e-5 of
    max |x|, or, where tpucg's own x is further than that from ``x_true``
    (an ill-conditioned system), within tpucg's distance to it and no
    further from it than twice that: two f32 solves of one system agree
    only to their rounding carried through its condition number (XLA on
    the CPU also fuses each axpy into one FMA, torch does not). Returns the
    port's laps."""
    kp, kr = int(port.iterations), int(ref.iterations)
    assert abs(kp - kr) <= laps, (kp, kr)
    assert bool(port.converged) == bool(ref.converged)
    if kp == kr:
        x, xr = np.asarray(port.x.cpu()), np.asarray(ref.x)
        bound = 1e-5
        if x_true is not None:
            own = scaled_err(xr, x_true)
            bound = max(bound, own)
            assert scaled_err(x, x_true) <= 2 * own
        assert scaled_err(x, xr) <= bound, (scaled_err(x, xr), bound)
    return kp


def laplacian1d(n: int):
    """The 1-D Laplacian tridiag(-1, 2, -1), float32: a constant-diagonal
    band where point Jacobi changes nothing and block Jacobi does."""
    return (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)


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


def padded_batch(As, bs, X0, device):
    """A batch as ``cg_solve_batch`` pads it, on ``device``: A (B, npad, npad)
    with an identity tail to the next multiple of 128, b and x0 (B, npad)
    padded with zeros, and Jacobi's 1/diag (1 where the diagonal is 0)."""
    nsys, n = bs.shape
    npad = -(-n // 128) * 128
    A = torch.zeros((nsys, npad, npad), device=device)
    A[:, :n, :n] = torch.as_tensor(As, device=device)
    tail = torch.arange(n, npad, device=device)
    A[:, tail, tail] = 1.0
    pad = (0, npad - n)
    b = torch.nn.functional.pad(torch.as_tensor(bs, device=device), pad)
    x0 = torch.nn.functional.pad(torch.as_tensor(X0, device=device), pad)
    d = torch.diagonal(A, dim1=1, dim2=2)
    return A, b, x0, torch.where(d != 0, 1.0 / d, 1.0)


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


# A band with far offsets: +-40,000 at n = 100,000 (beyond K11's staged
# window, read through L2) beside the tridiagonal ones (staged).
FAR_BAND = (-40_000, -1, 0, 1, 40_000)
FAR_BAND_N = 100_000


def k11_edge_npads(grid: int, tile: int = 1024) -> tuple:
    """Two padded lengths at which K11's ``grid``-block launch (grid >= 4,
    below the cap of one block per 256 rows) deals its tiles unevenly: the
    first has fewer tiles than blocks (the last blocks own no row), the
    second wraps past the grid twice (blocks own two or three tiles); the
    last tile of each is partial."""
    return 300 * grid + 37, (2 * grid + grid // 2) * tile + 333


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


def arrowhead_spd(n: int, seed: int = 0):
    """An SPD arrowhead CSR: a full first row and column (c ~ U(-1, 1)), a
    diagonal d ~ 2 + U(0, 1), A[0, 0] = sum c^2 / d + 1, float32. Its first
    row holds n entries: K13's long-row case."""
    from tpucg_torch.sparse.formats import COOMatrix

    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, n - 1)
    d = 2.0 + rng.random(n - 1)
    i = np.arange(1, n)
    row = np.r_[np.zeros(n, np.int64), i, i]
    col = np.r_[np.arange(n), np.zeros(n - 1, np.int64), i]
    data = np.r_[float(np.sum(c * c / d)) + 1.0, c, c, d].astype(np.float32)
    return COOMatrix(row=row, col=col, data=data, shape=(n, n)).to_csr()


def scaled_err(x, want) -> float:
    """max |x - want| / max |want| per system (the last axis), the largest
    over the systems: an error measured against the size of the solution."""
    x = np.asarray(x, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(x - want).max(-1) / np.abs(want).max(-1)).max())


def run_world(nprocs: int, target, args=(), rendezvous: str = "", timeout_s: float = 600.0):
    """Run ``target(rank, nprocs, *args)`` in ``nprocs`` spawned processes,
    the ranks of one gloo world, and return rank 0's return value: the
    package's ``tpucg_torch.dryrun.spawn_world`` (a rank that raises, or a
    world that outlasts ``timeout_s``, raises here). The ranks import this
    module, torch and tpucg_torch, no jax."""
    from tpucg_torch.dryrun import spawn_world

    return spawn_world(nprocs, target, args=args, rendezvous=rendezvous, timeout_s=timeout_s)


def cli_world_worker(rank, nprocs, argvs):
    """A rank of a world that runs each of ``argvs`` through the port's CLI,
    as the ranks of ``torchrun -m tpucg_torch`` do; returns, for rank 0,
    each command's exit code (or the ``ValueError``, ``SystemExit`` or
    ``FloatingPointError`` it raised, as "Type: text") and its stdout."""
    import contextlib
    import io

    from tpucg_torch import cli

    out = []
    for argv in argvs:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
        except (ValueError, SystemExit, FloatingPointError) as e:
            rc = f"{type(e).__name__}: {e}"
        out.append((rc, buf.getvalue()))
    return out


def raising_worker(rank, nprocs, label):
    """A rank of a world whose rank 0 fails a check, as a dry-run case that
    misses its oracle does."""
    if rank == 0:
        raise AssertionError((label, "did not converge"))
    return None


# The sharded cases of tests/test_torch_sharded.py: tpucg's own sharded
# tests (tests/test_sharded.py, tests/test_sharded_sparse.py) with their
# systems and seeds, plus a dense system whose laps its spectrum sets.
# name -> (system, solve keyword arguments); each dense case runs with both
# strategies.
DENSE_CASES = {
    "generator_n96": (("generator", 96, 96), {}),
    "generator_n50": (("generator", 50, 50), {}),
    "golden_4x4": (("golden4",), {}),
    "spectrum_n96": (("circulant", 96, 5), {"tol": 1e-2}),
    "jacobi_n96": (("generator", 96, 7), {"precondition": "jacobi"}),
    "poly_n96": (("generator", 96, 7), {"precondition": "poly", "poly_degree": 3}),
    "record_n96": (("shifted", 96, 13), {"record_residuals": True}),
    "bf16_n96": (("generator", 96, 23), {"storage": "bf16", "tol_rel": 1e-5}),
}
OPERATOR_CASES = {
    "poisson_m8": (("poisson", 8, 0), {}),
    "poisson_m9_pad_planes": (("poisson", 9, 6), {}),
    "poisson_m8_jacobi": (("poisson", 8, 0), {"precondition": "jacobi"}),
    "poisson_m8_poly": (("poisson", 8, 0), {"precondition": "poly", "poly_degree": 3}),
    "ell_m7": (("ell", 7, 8), {}),
    "dia_m16": (("dia", 16, 9), {}),
    "dia_m16_bf16": (("dia", 16, 9), {"storage": "bf16"}),
    "banded_n1000_jacobi": (("banded", 1000, 11), {"precondition": "jacobi"}),
    "bsr_m6": (("bsr", 6, 12), {}),
    "bsr_m6_jacobi": (("bsr", 6, 12), {"precondition": "jacobi"}),
    # Irregular CSRs, sharded as row blocks of WELL: tpucg's FEM fixture
    # (test_checkpoint.py) at tpucg's FEM tol 1e-3 ||b||, above its f32 floor
    # of ~4e-4 ||b||, and its shuffled geometric graph (test_sharded_sparse.py).
    "well_fem6000": (("fem", 6000, 1), {"tol_rel": 1e-3}),
    "well_fem6000_jacobi": (("fem", 6000, 1), {"tol_rel": 1e-3, "precondition": "jacobi"}),
    "well_geo3000_shuffled": (("geometric", 3000, 7), {}),
    "well_geo3000_shuffled_jacobi": (("geometric", 3000, 7), {"precondition": "jacobi"}),
}


def sharded_system(spec):
    """The NumPy system of a sharded case: a dict with ``A`` (dense) or
    ``op`` (the port's host container: ``("poisson", m)``, a DIAMatrix, a
    CSRMatrix for ELL, a BSRMatrix, or a CSRMatrix with ``well`` set, which
    both packages shard as WELL), ``b``, ``x0`` (or None), and ``x_true``
    where the case has one."""
    from tpucg_torch.io.generator import (
        fem_p1_system,
        generate_spd_system,
        poisson3d_csr,
        poisson3d_dia,
        random_geometric_spd,
    )
    from tpucg_torch.io.golden import GOLDEN_4X4
    from tpucg_torch.sparse.formats import COOMatrix, csr_to_bsr, csr_to_dia

    kind = spec[0]
    if kind == "generator":
        A, b, _ = generate_spd_system(spec[1], seed=spec[2])
        return {"A": A, "b": b, "x0": None}
    if kind == "laplacian":
        n = spec[1]
        b = (np.ones(n, np.float32) if spec[2] is None
             else np.random.default_rng(spec[2]).standard_normal(n).astype(np.float32))
        return {"A": laplacian1d(n), "b": b, "x0": None}
    if kind == "scaled_tridiag":
        # tpucg's test_sharded_sparse.py:532: a badly block-scaled
        # tridiagonal SPD matrix in DIA form.
        n = spec[1]
        rng = np.random.default_rng(spec[2])
        d = np.exp(rng.uniform(0, 3, n))
        Ad = np.diag(4.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1) + np.diag(-np.ones(n - 1), -1)
        Ad = d[:, None] * Ad * d[None, :]
        ii, jj = np.nonzero(Ad)
        csr = COOMatrix(row=ii, col=jj, data=Ad[ii, jj].astype(np.float32),
                        shape=(n, n)).to_csr()
        b = rng.standard_normal(n).astype(np.float32)
        return {"op": csr_to_dia(csr), "b": b, "x0": None,
                "x_true": np.linalg.solve(Ad, b.astype(np.float64))}
    if kind == "golden4":
        g = GOLDEN_4X4
        return {"A": g["A"], "b": g["b"], "x0": g["x0"], "x_true": g["x_star"]}
    if kind == "circulant":
        A, b, _ = circulant_spd_batch(4, spec[1], seed=spec[2])
        return {"A": A[3], "b": b[3], "x0": None}
    if kind == "shifted":
        n = spec[1]
        A, b, x0 = generate_spd_system(n, seed=spec[2])
        return {"A": (A - (n - n / 8.0) * np.eye(n)).astype(np.float32), "b": b, "x0": x0}
    if kind in ("fem", "geometric"):
        csr, b, _ = (fem_p1_system(spec[1], seed=spec[2]) if kind == "fem" else
                     random_geometric_spd(spec[1], seed=spec[2], avg_degree=10.0, shuffle=True))
        return {"op": csr, "well": True, "b": b.astype(np.float32), "x0": None}
    n_or_m, seed = spec[1], spec[2]
    rng = np.random.default_rng(seed)
    if kind == "banded":
        n, bw = n_or_m, 3
        rows, cols, vals = [], [], []
        for off in range(-bw, bw + 1):
            idx = np.arange(max(0, -off), min(n, n - off))
            rows.append(idx)
            cols.append(idx + off)
            v = rng.random(idx.size).astype(np.float32)
            if off == 0:
                v += 4 * bw
            vals.append(v)
        csr = COOMatrix(row=np.concatenate(rows), col=np.concatenate(cols),
                        data=np.concatenate(vals), shape=(n, n)).to_csr()
        x_true = rng.standard_normal(n).astype(np.float32)
        return {"op": csr_to_dia(csr), "b": csr.matvec(x_true), "x0": None, "x_true": x_true}
    m = n_or_m
    x_true = rng.standard_normal(m ** 3).astype(np.float32)
    csr = poisson3d_csr(m)
    b = csr.matvec(x_true).astype(np.float32)
    if kind == "poisson":
        # tpucg's tests take b from the operator itself (PoissonOperator.matvec).
        b = poisson3d_dia(m).matvec(x_true).astype(np.float32)
        op = ("poisson", m)
    elif kind == "dia":
        op = poisson3d_dia(m)
        b = op.matvec(x_true).astype(np.float32)
    elif kind == "ell":
        op = csr
    else:
        op = csr_to_bsr(csr, 4)
    return {"op": op, "b": b, "x0": None, "x_true": x_true}


def solve_sharded_case(mesh, name: str, strategy: str = "allgather"):
    """Run one case of ``DENSE_CASES`` / ``OPERATOR_CASES`` through the
    port's sharded solve on ``mesh``; returns x, iterations, converged,
    residual_norm and the residual history (or None), as NumPy."""
    from tpucg_torch.solver.operators import BsrOperator, PoissonOperator
    from tpucg_torch.solver.sharded import sharded_cg_solve, sharded_operator_cg_solve

    spec, kw = DENSE_CASES[name] if name in DENSE_CASES else OPERATOR_CASES[name]
    kw = dict(kw)
    s = sharded_system(spec)
    storage = torch.bfloat16 if kw.pop("storage", "f32") == "bf16" else torch.float32
    if "tol_rel" in kw:
        kw["tol"] = kw.pop("tol_rel") * float(np.linalg.norm(s["b"]))
    if "A" in s:
        res = sharded_cg_solve(s["A"], s["b"], s["x0"], mesh=mesh, strategy=strategy,
                               storage_dtype=storage, **kw)
    else:
        op = s["op"]
        if isinstance(op, tuple):
            op = PoissonOperator(op[1], device="cpu")
        elif type(op).__name__ == "BSRMatrix":
            op = BsrOperator.from_bsr(op, device="cpu")
        elif type(op).__name__ == "CSRMatrix" and not s.get("well"):
            from tpucg_torch.solver.operators import EllOperator

            op = EllOperator.from_csr(op, device="cpu")
        n = s["b"].shape[0]
        kw.setdefault("tol", 1e-5 * float(np.linalg.norm(s["b"])))
        kw.setdefault("maxiter", 4 * n)
        res = sharded_operator_cg_solve(op, s["b"], s["x0"], mesh=mesh, storage_dtype=storage,
                                        **kw)
    return {
        "x": res.x.cpu().numpy(), "iterations": int(res.iterations),
        "converged": bool(res.converged), "residual_norm": float(res.residual_norm),
        "hist": None if res.residual_history is None else res.residual_history.cpu().numpy(),
    }


def sharded_cases_worker(rank, nprocs, device="cpu"):
    """A rank of a world that runs every sharded case (dense ones with both
    strategies) on a gloo mesh of ``device``; rank 0's results by case."""
    from tpucg_torch.comm.mesh import make_mesh

    mesh = make_mesh(device=device, backend="gloo")
    out = {}
    for name in DENSE_CASES:
        for strategy in ("allgather", "overlap"):
            out[(name, strategy)] = solve_sharded_case(mesh, name, strategy)
    for name in OPERATOR_CASES:
        out[(name, None)] = solve_sharded_case(mesh, name)
    # Mesh.rank_sum of the partials (1 + rank) / 3, as every rank holds it.
    s = mesh.rank_sum(torch.tensor((1 + rank) / 3, dtype=torch.float32, device=mesh.device))
    sums = torch.empty(nprocs, dtype=torch.float32, device=mesh.device)
    mesh.all_gather(sums, s.reshape(1))
    out["rank_sum"] = sums.tolist()
    return out


# M14 step 2's cases (tests/test_torch_sharded_methods.py): tpucg's own
# tests of its sharded methods and block Jacobi (test_pipelined.py,
# test_ca.py, test_chebyshev.py, test_interval.py, test_precond.py,
# test_sharded_sparse.py) with their systems. name -> (system, solve keyword
# arguments); a dense case runs with allgather, and those of
# ``METHOD_OVERLAP_CASES`` with overlap too. ``tol_rel`` is tol
# over ||b||; ``maxiter_n`` maxiter over n; ``interval`` "exact" is the
# float64 spectrum's bounds, "poisson" the m^3 Laplacian's.
METHOD_DENSE_CASES = {
    "pipelined_n192": (("generator", 192, 2), {"method": "pipelined", "tol_rel": 1e-5}),
    "pipelined_jacobi_n128": (("generator", 128, 3), {"method": "pipelined",
                                                      "precondition": "jacobi", "tol_rel": 1e-5}),
    "ca_n192": (("generator", 192, 2), {"method": "ca", "s_step": 3, "tol_rel": 1e-5}),
    "ca_n67_padded": (("generator", 67, 3), {"method": "ca", "s_step": 3}),
    "chebyshev_n192": (("generator", 192, 2), {"method": "chebyshev", "tol_rel": 1e-5,
                                               "maxiter_n": 8}),
    "ca_interval_n192": (("generator", 192, 3), {"method": "ca", "interval": "exact",
                                                 "maxiter": 800}),
    "chebyshev_interval_n192": (("generator", 192, 3), {"method": "chebyshev",
                                                        "interval": "exact", "maxiter": 800}),
    "block_jacobi_lap1024": (("laplacian", 1024, 3), {"precondition": "block_jacobi",
                                                      "pc_block_size": 32, "tol_rel": 1e-5,
                                                      "maxiter_n": 8}),
    "block_jacobi_bs24_lap256": (("laplacian", 256, 0), {"precondition": "block_jacobi",
                                                         "pc_block_size": 24, "tol_rel": 1e-5,
                                                         "maxiter_n": 8}),
    "pipelined_block_jacobi_n128": (("generator", 128, 3), {
        "method": "pipelined", "precondition": "block_jacobi", "pc_block_size": 32,
        "tol_rel": 1e-5}),
}
# The dense cases that also run with the overlap ring (the methods reach the
# matvec only through its closure; one case of each loop exercises both).
METHOD_OVERLAP_CASES = ("pipelined_n192", "ca_n192", "block_jacobi_lap1024")
METHOD_OPERATOR_CASES = {
    "poisson_m8_pipelined": (("poisson", 8, 0), {"method": "pipelined"}),
    "poisson_m8_pipelined_jacobi": (("poisson", 8, 0), {"method": "pipelined",
                                                        "precondition": "jacobi"}),
    "poisson_m8_ca": (("poisson", 8, 0), {"method": "ca", "s_step": 3}),
    "poisson_m8_chebyshev": (("poisson", 8, 0), {"method": "chebyshev", "maxiter_n": 8}),
    "dia_m6_ca": (("dia", 6, 5), {"method": "ca", "s_step": 3}),
    "dia_m6_chebyshev": (("dia", 6, 5), {"method": "chebyshev", "maxiter_n": 8}),
    "poisson_m12_ca_interval": (("poisson", 12, 5), {"method": "ca", "interval": "poisson"}),
    "poisson_m12_chebyshev_interval": (("poisson", 12, 5), {"method": "chebyshev",
                                                            "interval": "poisson"}),
    "poisson_m6_block_jacobi_bs24": (("poisson", 6, 0), {"precondition": "block_jacobi",
                                                         "pc_block_size": 24}),
    "poisson_m8_pipelined_block_jacobi": (("poisson", 8, 2), {
        "method": "pipelined", "precondition": "block_jacobi", "pc_block_size": 64}),
    "dia_scaled_block_jacobi": (("scaled_tridiag", 1100, 5), {
        "precondition": "block_jacobi", "pc_block_size": 32, "maxiter_n": 8}),
    "well_geo900_block_jacobi": (("geometric", 900, 1), {"precondition": "block_jacobi",
                                                         "pc_block_size": 32}),
    "well_geo900_pipelined_jacobi": (("geometric", 900, 1), {"method": "pipelined",
                                                             "precondition": "jacobi"}),
}


def method_case_kwargs(name: str, s: dict) -> dict:
    """The solve keyword arguments of a case of ``METHOD_DENSE_CASES`` /
    ``METHOD_OPERATOR_CASES`` for its system ``s`` (``sharded_system``),
    the same for both packages: tol (default 1e-6 for dense systems, 1e-5
    ||b|| for operators), maxiter (default n for dense, 4 n for operators)
    and the interval as floats."""
    dense = name in METHOD_DENSE_CASES
    kw = dict((METHOD_DENSE_CASES if dense else METHOD_OPERATOR_CASES)[name][1])
    n = s["b"].shape[0]
    nb = float(np.linalg.norm(s["b"]))
    if "tol_rel" in kw:
        kw["tol"] = kw.pop("tol_rel") * nb
    kw.setdefault("tol", 1e-6 if dense else 1e-5 * nb)
    if "maxiter_n" in kw:
        kw["maxiter"] = kw.pop("maxiter_n") * n
    kw.setdefault("maxiter", n if dense else 4 * n)
    iv = kw.get("interval")
    if iv == "exact":
        w = np.linalg.eigvalsh(np.asarray(s["A"], np.float64))
        kw["interval"] = (float(w[0]), float(w[-1]))
    elif iv == "poisson":
        m = round(n ** (1 / 3))
        c = float(np.cos(np.pi / (m + 1)))
        kw["interval"] = (6.0 - 6.0 * c, 6.0 + 6.0 * c)
    return kw


def method_case_op(s: dict, device="cpu"):
    """The port's operator of an operator case's system: a PoissonOperator,
    the DIAMatrix, or the CSR (sharded WELL)."""
    from tpucg_torch.solver.operators import PoissonOperator

    op = s["op"]
    return PoissonOperator(op[1], device=device) if isinstance(op, tuple) else op


def solve_method_case(mesh, name: str, strategy: str = "allgather"):
    """One case of ``METHOD_DENSE_CASES`` / ``METHOD_OPERATOR_CASES``
    through the port's sharded solve on ``mesh``; x, iterations, converged
    and residual_norm as NumPy."""
    from tpucg_torch.solver.sharded import sharded_cg_solve, sharded_operator_cg_solve

    dense = name in METHOD_DENSE_CASES
    s = sharded_system((METHOD_DENSE_CASES if dense else METHOD_OPERATOR_CASES)[name][0])
    kw = method_case_kwargs(name, s)
    if dense:
        res = sharded_cg_solve(s["A"], s["b"], s["x0"], mesh=mesh, strategy=strategy, **kw)
    else:
        res = sharded_operator_cg_solve(method_case_op(s, mesh.device), s["b"], s["x0"],
                                        mesh=mesh, **kw)
    return {"x": res.x.cpu().numpy(), "iterations": int(res.iterations),
            "converged": bool(res.converged), "residual_norm": float(res.residual_norm)}


def sharded_methods_worker(rank, nprocs, device="cpu"):
    """A rank of a world that runs every method case (the dense ones of
    ``METHOD_OVERLAP_CASES`` with both strategies) on a gloo mesh of
    ``device``, ``Mesh.rank_sum`` on a vector
    and a matrix, and the transport's calls in capped pipelined and classic
    solves; rank 0's results by case."""
    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.solver.sharded import sharded_cg_solve

    mesh = make_mesh(device=device, backend="gloo")
    out = {}
    for name in METHOD_DENSE_CASES:
        for strategy in ("allgather", "overlap")[:2 if name in METHOD_OVERLAP_CASES else 1]:
            out[(name, strategy)] = solve_method_case(mesh, name, strategy)
    for name in METHOD_OPERATOR_CASES:
        out[(name, None)] = solve_method_case(mesh, name)
    # The scaled band with point Jacobi, beside its block-Jacobi case.
    from tpucg_torch.solver.sharded import sharded_operator_cg_solve

    s = sharded_system(METHOD_OPERATOR_CASES["dia_scaled_block_jacobi"][0])
    kw = dict(method_case_kwargs("dia_scaled_block_jacobi", s), precondition="jacobi")
    out["dia_scaled_jacobi_laps"] = int(sharded_operator_cg_solve(
        s["op"], s["b"], mesh=mesh, **kw).iterations)
    # rank_sum of a vector and a matrix: rank r's partials are (r + 1) / 3
    # times (1, 2, ...), every rank's sums gathered to rank 0.
    sums = []
    for shape in ((5,), (3, 4)):
        part = (torch.arange(1, int(np.prod(shape)) + 1, dtype=torch.float32).reshape(shape)
                * torch.tensor((rank + 1) / 3, dtype=torch.float32))
        tot = mesh.rank_sum(part)
        everyone = torch.empty((nprocs,) + shape, dtype=torch.float32)
        mesh.all_gather(everyone.reshape(-1), tot.contiguous().reshape(-1))
        sums.append(everyone.numpy())
    out["rank_sum"] = sums
    # The transport's calls a lap: capped solves (tol 1e-30 never stops them)
    # of 8 and 16 laps, one chunk a lap; the difference is 8 laps' calls.
    A, b, x0 = generate_spd_system(64, seed=1)
    calls = {}
    for method in ("pipelined", "cg"):
        for laps in (8, 16):
            mesh.stats.update(calls=0, seconds=0.0)
            sharded_cg_solve(A, b, x0, mesh=mesh, method=method, tol=1e-30, maxiter=laps,
                             chunk=1)
            calls[(method, laps)] = mesh.stats["calls"]
    out["calls"] = calls
    return out


# M14 step 3's cases (tests/test_torch_sharded_multi.py): tpucg's tests of
# its sharded multi-RHS and block CG (test_multi.py, test_block.py,
# test_sharded_sparse.py) with their systems. name -> (system, B, solve
# keyword arguments): the system as ``sharded_system`` takes it (plus
# "scaled", tpucg's diagonally scaled generator system of
# test_block.py:267), B as (seed, k, "random" uniform | "normal");
# ``tol_rel`` is tol over ||B[:, 0]|| (under Jacobi over ||D^-1/2 B[:, 0]||).
MULTI_CASES = {
    "multi_n96_k5": (("generator", 96, 21), (2, 5, "random"), {}),
    "multi_n50_k3_padded": (("generator", 50, 22), (3, 3, "random"), {}),
    "multi_poisson_m8_k3": (("poisson", 8, 0), (4, 3, "normal"), {"tol_rel": 1e-5}),
    "multi_dia_m6_k2": (("dia", 6, 5), (4, 2, "normal"), {"tol_rel": 1e-5}),
    "multi_well_geo2000_k2": (("geometric", 2000, 9), (10, 2, "normal"), {"tol_rel": 1e-5}),
    "multi_ell_m7_k2": (("ell", 7, 8), (5, 2, "normal"), {"tol_rel": 1e-5}),
    "multi_bsr_m6_k2": (("bsr", 6, 12), (5, 2, "normal"), {"tol_rel": 1e-5}),
}
BLOCK_CASES = {
    "block_n192_k4": (("generator", 192, 7), (8, 4, "normal"), {}),
    "block_n67_k3_padded": (("generator", 67, 9), (10, 3, "normal"), {}),
    "block_n131_jacobi": (("scaled", 131, 14), (14, 3, "normal"), {
        "precondition": "jacobi", "tol_rel": 1e-5, "maxiter_n": 4}),
    "block_n131_poly": (("generator", 131, 14), (15, 3, "normal"), {
        "precondition": "poly", "poly_degree": 2, "tol_rel": 1e-5, "maxiter_n": 4}),
    "block_n128_block_jacobi": (("generator", 128, 3), (5, 3, "normal"), {
        "precondition": "block_jacobi", "pc_block_size": 32}),
    "block_poisson_m8": (("poisson", 8, 0), (6, 3, "normal"), {"tol_rel": 1e-5}),
    "block_poisson_m8_jacobi": (("poisson", 8, 0), (6, 3, "normal"), {
        "precondition": "jacobi", "tol_rel": 1e-5}),
    "block_poisson_m8_poly": (("poisson", 8, 0), (6, 3, "normal"), {
        "precondition": "poly", "poly_degree": 2, "tol_rel": 1e-5}),
    "block_dia_m6": (("dia", 6, 5), (7, 2, "normal"), {"tol_rel": 1e-5}),
    "block_well_geo2000_jacobi": (("geometric", 2000, 9), (10, 2, "normal"), {
        "precondition": "jacobi", "tol_rel": 1e-5}),
}


def multi_case(name: str):
    """(system, B, keyword arguments) of a case of ``MULTI_CASES`` /
    ``BLOCK_CASES``, the same for both packages: tol (default 1e-6 for
    dense systems, 1e-5 ||B[:, 0]|| for operators) and maxiter (default n
    for dense, 4 n for operators)."""
    spec, (seed, k, dist), kw = {**MULTI_CASES, **BLOCK_CASES}[name]
    if spec[0] == "scaled":
        from tpucg_torch.io.generator import generate_spd_system

        n = spec[1]
        rng = np.random.default_rng(spec[2])
        A0 = generate_spd_system(n, seed=spec[2])[0]
        d = np.exp(rng.uniform(0.0, np.log(100.0), n)).astype(np.float32)
        s = {"A": (A0 * d[:, None] * d[None, :]).astype(np.float32)}
    else:
        s = sharded_system(spec)
    dense = "A" in s
    n = (s["A"] if dense else s["b"]).shape[0]
    rng = np.random.default_rng(seed)
    B = (rng.random((n, k)) if dist == "random" else rng.standard_normal((n, k))).astype(np.float32)
    kw = dict(kw)
    if "tol_rel" in kw:
        col = B[:, 0]
        if kw.get("precondition") == "jacobi" and dense:
            col = col / np.sqrt(np.diag(s["A"]))
        kw["tol"] = kw.pop("tol_rel") * float(np.linalg.norm(col))
    kw.setdefault("tol", 1e-6 if dense else 1e-5 * float(np.linalg.norm(B[:, 0])))
    if "maxiter_n" in kw:
        kw["maxiter"] = kw.pop("maxiter_n") * n
    kw.setdefault("maxiter", n if dense else 4 * n)
    return s, B, kw


def multi_case_operator(s: dict, device="cpu"):
    """The port's A of a multi/block case: the dense array, or the operator
    (Poisson, the DIAMatrix, an EllOperator or BsrOperator, or the CSR as
    sharded WELL)."""
    from tpucg_torch.solver.operators import BsrOperator, EllOperator, PoissonOperator

    if "A" in s:
        return s["A"]
    op = s["op"]
    if isinstance(op, tuple):
        return PoissonOperator(op[1], device=device)
    kind = type(op).__name__
    if kind == "BSRMatrix":
        return BsrOperator.from_bsr(op, device=device)
    if kind == "CSRMatrix" and not s.get("well"):
        return EllOperator.from_csr(op, device=device)
    return op


def sharded_multi_worker(rank, nprocs, device="cpu"):
    """A rank of a world that runs every case of ``MULTI_CASES`` through
    ``sharded_cg_solve_multi`` and of ``BLOCK_CASES`` through
    ``sharded_cg_solve_block`` on a gloo mesh of ``device``; rank 0's x,
    iterations, residual_norm and converged as NumPy, by case."""
    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.solver.sharded import sharded_cg_solve_block, sharded_cg_solve_multi

    mesh = make_mesh(device=device, backend="gloo")
    out = {}
    for name in list(MULTI_CASES) + list(BLOCK_CASES):
        s, B, kw = multi_case(name)
        solve = sharded_cg_solve_multi if name in MULTI_CASES else sharded_cg_solve_block
        res = solve(multi_case_operator(s, mesh.device), B, mesh=mesh, **kw)
        out[name] = {k: getattr(res, k).cpu().numpy()
                     for k in ("x", "iterations", "residual_norm", "converged")}
    return out


def laps_run(k: int) -> int:
    """Laps ``cg_loop`` runs for a solve that stops after k: chunks of 1, 2,
    4, ... up to ``CHUNK_MAX`` until one ends past the stop (its last laps
    frozen)."""
    from tpucg_torch.solver.cg import CHUNK_MAX

    total, laps = 0, 1
    while total < max(k, 1):
        total += laps
        laps = min(2 * laps, CHUNK_MAX)
    return total


def card_world_worker(rank, nprocs, cases, m, b_poisson, kw, well=None):
    """A rank of a gloo world on cuda:0 (``chip_smoke.py``): each case,
    ``("dense", strategy)`` on ``generate_spd_system(8192, seed=0)``,
    ``("poisson", None)`` / ``("dia", None)`` on the m^3 Laplacian with
    ``b_poisson`` and ``kw`` (tol, maxiter), or ``(name, None)`` for a name
    of ``well``, which maps it to ``((generator, n, seed), solve keywords)``
    of an irregular CSR (``"fem"``: ``fem_p1_system``; ``"geometric"``:
    ``random_geometric_spd`` at average degree 12) solved as sharded WELL
    with its own b; each solved once to warm up (not WELL, which packs its
    operator in every call) and once timed on the host clock; rank 0's x,
    laps, ms, laps run, and the transport's calls and host seconds in the
    timed solve."""
    import time

    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.io.generator import (
        fem_p1_system,
        generate_spd_system,
        poisson3d_dia,
        random_geometric_spd,
    )
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.solver.operators import PoissonOperator
    from tpucg_torch.solver.sharded import (
        distribute_system,
        sharded_cg_solve,
        sharded_operator_cg_solve,
    )

    strict_f32()
    dev = torch.device("cuda", 0)
    mesh = make_mesh(device=dev, backend="gloo")
    out = {"mesh": repr(mesh)}
    dense = None
    for kind, strategy in cases:
        if kind == "dense":
            dense = generate_spd_system(8192, seed=0) if dense is None else dense
            system = distribute_system(*dense, mesh, strategy=strategy)

            def solve():
                return sharded_cg_solve(system, mesh=mesh, strategy=strategy)
        elif well is not None and kind in well:
            (gen, n, seed), kw_w = well[kind]
            A_w, b_w, _ = (fem_p1_system(n, seed=seed) if gen == "fem" else
                           random_geometric_spd(n, seed=seed, avg_degree=12.0))

            def solve():
                return sharded_operator_cg_solve(A_w, b_w, mesh=mesh, **kw_w)
        else:
            op = PoissonOperator(m, device=dev) if kind == "poisson" else poisson3d_dia(m)

            def solve():
                return sharded_operator_cg_solve(op, b_poisson, mesh=mesh, **kw)
        if kind not in (well or {}):
            solve()  # a warm-up (a WELL solve packs its operator on every call)
        torch.cuda.synchronize()
        mesh.stats.update(calls=0, seconds=0.0)
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        k = int(res.iterations)
        out[(kind, strategy)] = {
            "x": res.x.cpu().numpy() if rank == 0 else None, "laps": k,
            "converged": bool(res.converged), "ms": (time.perf_counter() - t0) * 1e3,
            "laps_run": laps_run(k), "transport_s": mesh.stats["seconds"],
            "transport_calls": mesh.stats["calls"],
        }
    return out


def card_methods_worker(rank, nprocs, cases, B_seed=0, n=8192, n_geo=100_000,
                        device="cuda:0"):
    """A rank of a gloo world on ``device`` (``chip_smoke.py``'s M14 steps
    2-3 phase; on the CPU with small sizes, its rehearsal): each case,
    ``("dense", kw)`` on ``generate_spd_system(n, seed=0)`` through
    ``sharded_cg_solve`` (allgather) with the keyword arguments ``kw``, or
    ``(kind, kw)`` with kind ``"multi"`` or ``"block"`` on the geometric
    graph (``random_geometric_spd(n_geo, seed=0, avg_degree=12.0)``) as
    sharded WELL, B (n_geo, 8) standard normal from
    ``default_rng(B_seed)``, through ``sharded_cg_solve_multi`` /
    ``sharded_cg_solve_block``; each solved once to warm up, then once
    timed on the host clock with the transport's calls and seconds; and
    capped pipelined and classic solves of the dense system (16 and 144
    laps, chunks of 16, after one of 16 to warm up), whose difference gives
    the transport calls and host ms a lap. Rank 0's x,
    laps, converged, ms, transport, and the kernels' launches in each
    solve."""
    import time

    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.io.generator import generate_spd_system, random_geometric_spd
    from tpucg_torch.kernels.blas1 import dot_cuda, fused_update_cuda
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.gather_spmv import well_spmv_cuda, well_spmv_multi_cuda
    from tpucg_torch.kernels.matvec import matvec_cuda
    from tpucg_torch.solver.sharded import (
        distribute_system,
        sharded_cg_solve,
        sharded_cg_solve_block,
        sharded_cg_solve_multi,
    )

    strict_f32()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = make_mesh(device=dev, backend="gloo")
    kernels = (matvec_cuda, dot_cuda, fused_update_cuda, well_spmv_cuda, well_spmv_multi_cuda)
    A, b, x0 = generate_spd_system(n, seed=0)
    systems = {}
    out = {"mesh": repr(mesh)}
    for i, (kind, kw) in enumerate(cases):
        if kind == "dense":
            key = ("dense", kw.get("precondition") == "block_jacobi")
            if key not in systems:
                from tpucg_torch.config import CGConfig

                systems[key] = distribute_system(A, b, x0, mesh, config=CGConfig(**{
                    k: v for k, v in kw.items() if k in ("precondition", "pc_block_size")}))

            def solve():
                return sharded_cg_solve(systems[key], mesh=mesh, **kw)
        else:
            if "geo" not in systems:
                A_g = random_geometric_spd(n_geo, seed=0, avg_degree=12.0)[0]
                B = np.random.default_rng(B_seed).standard_normal(
                    (A_g.shape[0], 8)).astype(np.float32)
                systems["geo"] = (A_g, B)
            A_g, B = systems["geo"]
            fn = sharded_cg_solve_multi if kind == "multi" else sharded_cg_solve_block

            def solve():
                return fn(A_g, B, mesh=mesh, **kw)
        solve()  # a warm-up (the transport's first calls set up its buffers)
        sync()
        mesh.stats.update(calls=0, seconds=0.0)
        before = [w.launches for w in kernels]
        t0 = time.perf_counter()
        res = solve()
        sync()
        out[i] = {
            "x": res.x.cpu().numpy() if rank == 0 else None,
            "laps": res.iterations.cpu().numpy(), "converged": res.converged.cpu().numpy(),
            "ms": (time.perf_counter() - t0) * 1e3, "transport_s": mesh.stats["seconds"],
            "transport_calls": mesh.stats["calls"],
            "launches": {w.__name__: w.launches - c for w, c in zip(kernels, before)},
        }
    system = systems.get(("dense", False)) or distribute_system(A, b, x0, mesh)
    per_lap = {}
    for method in ("pipelined", "cg"):
        seen = {}
        for laps in (16, 16, 144):
            sync()
            mesh.stats.update(calls=0, seconds=0.0)
            sharded_cg_solve(system, mesh=mesh, method=method, tol=1e-30, maxiter=laps, chunk=16)
            sync()
            seen[laps] = (mesh.stats["calls"], mesh.stats["seconds"])
        per_lap[method] = ((seen[144][0] - seen[16][0]) / 128,
                           (seen[144][1] - seen[16][1]) / 128 * 1e3)
    out["per_lap"] = per_lap
    return out


def fma32(a, b, c):
    """float32 a * b + c rounded once (CUDA's FFMA), in NumPy: the product
    is exact in float64, TwoSum keeps the sum's error, and a float64 sum
    that falls on a midpoint between two float32 values is broken by that
    error's sign instead of to even."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # s + err == p + c exactly
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.where(s > r64, np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    tie = (s != r64) & (s == (r64 + other.astype(np.float64)) / 2) & (err != 0)
    broken = np.where(err > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(tie, broken, r).astype(np.float32)


def _tree32(v):
    """The shuffle-down tree over the last axis (32, or a power of two
    below it): lane 0's sum, f32."""
    v = np.asarray(v, np.float32)
    w = v.shape[-1]
    while w > 1:
        w //= 2
        v = (v[..., :w] + v[..., w:2 * w]).astype(np.float32)
    return v[..., 0]


def batch_dia_partials(a, b=None):
    """Today's K12 thread partials over a system's rows (length npad): VT =
    min(npad, 1024) threads, thread t accumulating rows t, t + VT, ... in
    order, each by fma(a_i, b_i, acc) (b given) or acc + a_i. Returns
    (VT,) f32."""
    a = np.asarray(a, np.float32)
    n = a.shape[-1]
    vt = min(n, 1024)
    acc = np.zeros(vt, np.float32)
    for q in range(-(-n // vt)):
        rows = np.arange(vt) + vt * q
        live = rows < n
        i = rows[live]
        acc[live] = (fma32(a[i], b[i], acc[live]) if b is not None
                     else (acc[live] + a[i]).astype(np.float32))
    return acc


def batch_dia_sum(partials):
    """Today's K12 block sum of the thread partials: each warp's
    shuffle-down tree, then the tree over 32 slots (zeros past the warps)."""
    vw = partials.shape[-1] // 32
    slots = np.zeros(32, np.float32)
    slots[:vw] = _tree32(partials.reshape(vw, 32))
    return np.float32(_tree32(slots))


def batch_dia_warps_sum(partials, warps):
    """The same sum the way the W-warp K12 takes it: the G = 32 W / VW lanes
    of a virtual warp take its virtual lanes g, g + G, ... (lane g); each
    lane runs the tree's steps of offset G and more over its own virtual
    lanes, the G lanes then the steps below G, and the virtual warps' sums
    the 32-slot tree."""
    vw = partials.shape[-1] // 32
    g = 32 * warps // vw
    # [virtual warp, lane g, its j-th virtual lane g + G j]
    m = partials.reshape(vw, 32 // g, g).transpose(0, 2, 1)
    own = _tree32(m)        # steps of offset G and more, in a lane's registers
    sums = _tree32(own)     # steps below G, across the G lanes
    slots = np.zeros(32, np.float32)
    slots[:vw] = sums
    return np.float32(_tree32(slots))


def dia_apply32(slab, offsets, v):
    """K12's Ap for one system: row i sums slab[d, i] * v[i + off_d] in
    offsets order, each product and sum rounded on its own, 0 outside."""
    n = v.shape[0]
    acc = np.zeros(n, np.float32)
    rows = np.arange(n)
    for d, off in enumerate(offsets):
        c = rows + off
        xv = np.where((c >= 0) & (c < n), v[np.clip(c, 0, n - 1)], 0).astype(np.float32)
        acc = (acc + (slab[d] * xv).astype(np.float32)).astype(np.float32)
    return acc


def batch_dia_cg_emulated(data, offsets, b, x0, tol, maxiter, jacobi=False, safe_alpha=True):
    """K12 in float32 NumPy, operation for operation as the kernel (and the
    one-block kernel before it) computes: FFMA where it fuses (fma32),
    products and sums rounded on their own elsewhere, IEEE division, the
    sums in today's order (batch_dia_partials, batch_dia_sum). ``data`` is
    (B, ndiag, n) f32 (a bf16 slab widened exactly); returns x (B, n), k and
    rr (B,)."""
    data = np.asarray(data, np.float32)
    B, _, n = data.shape
    tol2 = np.float32(tol) * np.float32(tol)
    X = np.zeros((B, n), np.float32)
    K = np.zeros(B, np.int32)
    RR = np.zeros(B, np.float32)
    one = np.float32(1)

    def total(a, b_=None):
        return batch_dia_sum(batch_dia_partials(a, b_))

    for s in range(B):
        slab = data[s]
        x = np.asarray(x0[s], np.float32).copy()
        minv = None
        if jacobi:
            dg = slab[list(offsets).index(0)]
            minv = np.where(dg != 0, one / np.where(dg != 0, dg, one), one).astype(np.float32)
        ap = dia_apply32(slab, offsets, x)
        r = (np.asarray(b[s], np.float32) - ap).astype(np.float32)
        z = (minv * r).astype(np.float32) if jacobi else r
        p = z
        rr = total(r, r)
        rsold = total(r, z) if jacobi else rr
        k = 0
        done = rr < tol2
        while not done and k < maxiter:
            ap = dia_apply32(slab, offsets, p)
            pap = total(p, ap)
            alpha = np.float32(0) if (safe_alpha and pap == 0) else np.float32(rsold / pap)
            x = fma32(alpha, p, x)
            r = fma32(-alpha, ap, r)
            rr = total(r, r)
            rz = total((r * (minv * r).astype(np.float32)).astype(np.float32)) if jacobi else rr
            k += 1
            done = rr < tol2
            if done:
                break
            beta = np.float32(rz / rsold)
            rsold = rz
            z = (minv * r).astype(np.float32) if jacobi else r
            p = fma32(beta, p, z)
        X[s], K[s], RR[s] = x, k, rr
    return X, K, RR


# K2 and K3's reduction (csrc/blas.cuh, csrc/blas.cu): blocks of BLAS_BLOCK
# threads, at most BLAS_MAX_PARTIALS of them, one per BLAS_PER_BLOCK
# elements (tests/test_torch_lap_tail.py reads the three from the source).
BLAS_BLOCK = 256
BLAS_MAX_PARTIALS = 1024
BLAS_PER_BLOCK = 4 * BLAS_BLOCK


def blas_reduce_blocks(n: int) -> int:
    """``reduce_blocks(n)``: the blocks (and partials) of an n-element sum."""
    return max(1, min(BLAS_MAX_PARTIALS, -(-n // BLAS_PER_BLOCK)))


def blas_block_sum(v):
    """``block_sum`` over the last axis (BLAS_BLOCK threads): each warp's
    shuffle-down tree, then warp 0's tree over the warp sums in its first
    lanes (zeros in the rest)."""
    v = np.asarray(v, np.float32)
    warps = _tree32(v.reshape(v.shape[:-1] + (BLAS_BLOCK // 32, 32)))
    slots = np.zeros(v.shape[:-1] + (32,), np.float32)
    slots[..., :BLAS_BLOCK // 32] = warps
    return _tree32(slots)


def blas_partials(u, v):
    """K2/K3's stage 1: block b's thread t takes elements b BLAS_BLOCK + t,
    + nb BLAS_BLOCK, ... in order, each by fma(u_i, v_i, acc) from 0; each
    block's partial is its block sum. Returns (nb,) f32."""
    u, v = np.asarray(u, np.float32), np.asarray(v, np.float32)
    n = u.shape[0]
    nb = blas_reduce_blocks(n)
    lane = np.arange(nb * BLAS_BLOCK)
    acc = np.zeros(nb * BLAS_BLOCK, np.float32)
    for start in range(0, n, nb * BLAS_BLOCK):
        i = lane + start
        live = i < n
        acc[live] = fma32(u[i[live]], v[i[live]], acc[live])
    return blas_block_sum(acc.reshape(nb, BLAS_BLOCK))


def blas_last_block_sum(partials):
    """Stage 2, in the block that draws the last ticket (and in the second
    launch before it): thread t adds partials t, t + BLAS_BLOCK, ... to 0 in
    order, then the block sum."""
    partials = np.asarray(partials, np.float32)
    acc = np.zeros(BLAS_BLOCK, np.float32)
    for start in range(0, partials.shape[0], BLAS_BLOCK):
        part = partials[start:start + BLAS_BLOCK]
        acc[:part.shape[0]] = (acc[:part.shape[0]] + part).astype(np.float32)
    return np.float32(blas_block_sum(acc))


def dot_emulated(u, v):
    """K3's u . v in float32 NumPy, in the kernel's order."""
    return blas_last_block_sum(blas_partials(u, v))


def fused_update_emulated(x, r, p, ap, alpha):
    """K2 in float32 NumPy: x' = fma(alpha, p, x), r' = fma(-alpha, ap, r)
    and r'.r' in K3's order."""
    a = np.float32(alpha)
    xn = fma32(a, p, x)
    rn = fma32(-a, ap, r)
    return xn, rn, dot_emulated(rn, rn)


def alpha_emulated(pap, rsold, rule: int):
    """K3's alpha in float32 NumPy: rule 0 divides as is, 1 (safe_alpha)
    gives 0 where p.Ap == 0, 2 (the guarded finish) 0 unless p.Ap > 0 (NaN
    included)."""
    pap, rsold = np.float32(pap), np.float32(rsold)
    with np.errstate(all="ignore"):
        q = np.float32(rsold / pap)
    if rule == 2:
        return q if pap > 0 else np.float32(0)
    if rule == 1 and pap == 0:
        return np.float32(0)
    return q


def lap_tail_emulated(k, rsold, done, rr, rs_new, tol2, maxiter, guard: bool):
    """The lap's tail (``csrc/blas.cu`` ``lap_tail``) on a running lap, in
    float32 NumPy: the scalars after it (k, rsold, rslast, done, active,
    beta, step). Guarded, a lap whose rs_new is not > 0 steps with beta 0 and
    rsold FLT_MIN."""
    rsold, rr, rs_new, tol2 = (np.float32(v) for v in (rsold, rr, rs_new, tol2))
    stop = bool(rr < tol2)
    healthy = (not guard) or bool(rs_new > 0)
    with np.errstate(all="ignore"):
        beta = np.float32(rs_new / rsold) if healthy else np.float32(0)
    rs_step = rs_new if healthy else np.float32(np.finfo(np.float32).tiny)
    done = bool(done) or stop
    return dict(k=k + 1, rsold=rsold if stop else rs_step, rslast=rr, done=done,
                active=(not done) and k + 1 < maxiter, beta=beta, step=not stop)


@pytest.fixture
def cuda_device():
    """The first CUDA device; tests that need the card skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    from tpucg_torch.kernels.dispatch import strict_f32

    strict_f32()
    return torch.device("cuda", 0)


# ---- M14 steps 4 and 5 (tests/test_torch_host_sharded.py,
# tests/test_torch_sharded_m12.py) -------------------------------------------


def host_sharded_files(d: str) -> dict:
    """The files of the host-sharded tests under directory ``d``: tpucg's
    dense text and ``.npy`` system (``generate_spd_system(100, seed=1)``,
    n = 100 so that a world of 4 pads into an identity tail) and its FEM
    fixture of ``tests/test_sharded_io_mtx.py`` (``fem_p1_system(6000,
    seed=2)`` written symmetric, expanded to an indexed general ``.mtx``)
    with b as ``.npy``; returns their paths and the ``.mtx``'s size."""
    import os

    from tpucg_torch.io import mmio
    from tpucg_torch.io.generator import fem_p1_system, generate_spd_system
    from tpucg_torch.io.textio import save_array

    p = {k: os.path.join(d, f) for k, f in (
        ("A_txt", "A.txt"), ("A_npy", "A.npy"), ("b_txt", "b.txt"), ("x0_txt", "x0.txt"),
        ("fem_sym", "fem_sym.mtx"), ("fem", "fem.mtx"), ("fem_b", "fem_b.npy"))}
    A, b, _ = generate_spd_system(100, seed=1)
    x0 = np.random.default_rng(2).standard_normal(100).astype(np.float32)
    save_array(p["A_txt"], A, fmt="%r")
    np.save(p["A_npy"], A)
    save_array(p["b_txt"], b, fmt="%r")
    save_array(p["x0_txt"], x0, fmt="%r")
    Af, bf, _ = fem_p1_system(6_000, seed=2)
    mmio.save_matrix_market(p["fem_sym"], Af.to_coo(), symmetric=True)
    mmio.expand_matrix_market(p["fem_sym"], p["fem"])
    np.save(p["fem_b"], bf)
    p["fem_bytes"] = os.path.getsize(p["fem"])
    return p


def _gather_np(mesh, a) -> np.ndarray:
    """Every rank's equally shaped array, stacked in rank order on every
    rank (int8 widened for the transport)."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    wide = t.to(torch.int32) if t.dtype == torch.int8 else t
    out = torch.empty((mesh.size,) + tuple(wide.shape), dtype=wide.dtype)
    mesh.all_gather(out.reshape(-1), wide.reshape(-1))
    return out.numpy().astype(t.numpy().dtype)


def host_sharded_worker(rank, nprocs, paths):
    """A rank of a gloo world that loads the files of ``host_sharded_files``
    host-sharded and solves them; rank 0 returns, stacked in rank order:
    each dense load's blocks (text and ``.npy``, both strategies) and the
    tokens each rank asked of the range parser (and the whole-file parses
    of the matrix: none), whether each equals ``distribute_system`` of the
    whole system bit for bit, and its solve; the WELL loads' packs, BS, NS,
    diag, bytes read and two-level acinv of every rank, and their Jacobi,
    two-level and pipelined two-level solves; ``Mesh.host_sum`` and
    ``host_max`` of per-rank arrays."""
    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.io import _native
    from tpucg_torch.io.textio import load_system
    from tpucg_torch.solver.sharded import (
        distribute_system,
        load_system_sharded,
        load_well_system_sharded,
        sharded_cg_solve,
        sharded_operator_cg_solve,
    )

    mesh = make_mesh(device="cpu", backend="gloo")
    asked, whole = [], []
    ranged, full = _native.parse_floats_range, _native.parse_floats

    def counting_range(path, start, count):
        asked.append((path, int(start), int(count)))
        return ranged(path, start, count)

    def counting_full(path):
        whole.append(path)
        return full(path)
    _native.parse_floats_range, _native.parse_floats = counting_range, counting_full
    out = {}
    try:
        A, b, x0 = load_system(paths["A_txt"], paths["b_txt"], paths["x0_txt"])
        for fmt in ("txt", "npy"):
            for strategy in ("allgather", "overlap"):
                del asked[:]
                del whole[:]
                s = load_system_sharded(paths[f"A_{fmt}"], paths["b_txt"], paths["x0_txt"],
                                        mesh=mesh, strategy=strategy)
                ref = distribute_system(A, b, x0, mesh, strategy=strategy)
                same = all(torch.equal(getattr(s, f), getattr(ref, f)) for f in ("A", "b", "x0"))
                tokens = sum(c for p, _, c in asked if p == paths["A_txt"])
                res = sharded_cg_solve(s, mesh=mesh, strategy=strategy)
                out[("dense", fmt, strategy)] = {
                    "A": _gather_np(mesh, s.A.numpy()), "b": _gather_np(mesh, s.b.numpy()),
                    "x0": _gather_np(mesh, s.x0.numpy()), "same": _gather_np(mesh, [same]),
                    "tokens": _gather_np(mesh, [tokens]), "part": s.part,
                    "whole_matrix_parses": _gather_np(mesh, [whole.count(paths["A_txt"])]),
                    "x": res.x.numpy(), "iterations": int(res.iterations),
                    "converged": bool(res.converged)}
    finally:
        _native.parse_floats_range, _native.parse_floats = ranged, full
    ws = load_well_system_sharded(paths["fem"], paths["fem_b"], mesh=mesh, two_level_agg=64)
    arrays = ws.block.arrays
    out["well"] = {
        "packs": {k: _gather_np(mesh, arrays[i].numpy())
                  for i, k in enumerate(("vals", "lidx", "gidl", "wrow", "sgb"))},
        "statics": ws.statics, "n": ws.n, "npad": ws.npad,
        "diag": _gather_np(mesh, ws.diag), "bytes_read": _gather_np(mesh, [ws.bytes_read]),
        "acinv": _gather_np(mesh, ws.two_level.acinv.numpy()),
        "dinv": _gather_np(mesh, ws.two_level.dinv.numpy()),
        "b": _gather_np(mesh, ws.b.numpy()),
    }
    nb = float(np.linalg.norm(np.load(paths["fem_b"]).astype(np.float64)))
    n = ws.n
    for label, kw in (("jacobi", dict(precondition="jacobi", tol=3e-4 * nb)),
                      ("two_level", dict(two_level=ws.two_level, tol=2e-3 * nb)),
                      ("two_level_pipelined", dict(two_level=ws.two_level, method="pipelined",
                                                   tol=5e-3 * nb))):
        res = sharded_operator_cg_solve(ws, mesh=mesh, maxiter=4 * n, **kw)
        out[("well", label)] = {"x": res.x.numpy(), "iterations": int(res.iterations),
                                "converged": bool(res.converged)}
    part = np.arange(6, dtype=np.float64) * (rank + 1) / 3.0
    out["host_sum"] = _gather_np(mesh, mesh.host_sum(part))
    out["host_max"] = _gather_np(mesh, mesh.host_max(np.asarray([3 * rank, 7 - rank],
                                                                np.int64)))
    return out


def _clustered_spd(n=256, n_small=3, seed=0):
    """tpucg's deflation system (``tests/test_deflation.py:15``): SPD with
    n_small eigenvalues 0.01, 0.02, ... under a bulk in [1, 2], and its
    slow eigenvectors."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([0.01 * (1.0 + np.arange(n_small)),
                          1.0 + rng.uniform(0.0, 1.0, n - n_small)])
    A = (Q * lam) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32), Q[:, :n_small].astype(np.float32)


def sym_indefinite(n=192, seed=0):
    """tpucg's MINRES system (``tests/test_minres.py``): half the spectrum
    in [-2, -1], half in [1, 2]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    half = n // 2
    lam = np.concatenate([-(1.0 + rng.uniform(0.0, 1.0, half)),
                          1.0 + rng.uniform(0.0, 1.0, n - half)])
    A = (Q * lam) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32)


def staggered_band(n, w=64, e=None, seed=3):
    """tpucg's MINRES benchmark band (``benchmarks/minres_bench.py:47``) at
    a stripe of w: offsets +-1, +-w under a +-5 diagonal in stripes of w
    rows, |lambda| in [1, 9] of both signs; with ``e``, scaled S B S by s =
    10^U(-e, e) (plain MINRES stalls on it, Jacobi and block Jacobi undo the
    scaling). Returns (data (5, n) f32, offsets)."""
    data = np.zeros((5, n), np.float32)
    data[0] = data[4] = -1.0
    data[1] = data[3] = -1.0
    data[2] = np.where((np.arange(n) // w) % 2 == 0, 5.0, -5.0)
    offsets = (-w, -1, 0, 1, w)
    if e is not None:
        s = 10.0 ** np.random.default_rng(seed).uniform(-e, e, n)
        for d, off in enumerate(offsets):
            j = np.arange(n) + off
            ok = (j >= 0) & (j < n)
            data[d, ok] = data[d, ok] * s[ok] * s[j[ok]]
    return data.astype(np.float32), offsets


# M14 step 5's cases: name -> (solver, system, keyword arguments). Solvers:
# "two_level" (sharded_operator_cg_solve(two_level=) with the cycle
# ``tl`` = dict(agg, smooth_degree, coarse_max) built by build_two_level for
# the sharded padding), "deflated" (sharded_cg_solve_deflated with ``V``:
# "low" the system's slow eigenvectors, "random" (seed, m), "plain" the
# plain sharded solve's x), "minres", "ir" and "recycling" (RecyclingCG(
# mesh=) over ``steps`` right-hand sides base + 0.05 t drift). Systems as
# ``m12_system`` makes them; ``tol_rel`` is tol over ||b||.
M12_CASES = {
    "tl_geo5000": ("two_level", ("geometric", 5000, 2), {"tl": dict(agg=64), "tol_rel": 1e-5,
                                                          "maxiter": 800}),
    "tl_geo5000_cheb": ("two_level", ("geometric", 5000, 2), {
        "tl": dict(agg=64, smooth_degree=2), "tol_rel": 1e-5, "maxiter": 800}),
    "tl_geo5000_pipelined": ("two_level", ("geometric", 5000, 2), {
        "tl": dict(agg=64), "tol_rel": 1e-5, "method": "pipelined", "maxiter": 800}),
    "ml_geo5000": ("two_level", ("geometric", 5000, 2), {
        "tl": dict(agg=16, coarse_max=64), "tol_rel": 1e-5, "maxiter": 800}),
    "tl_poisson_m12": ("two_level", ("poisson", 12, 5), {"tl": dict(agg=16), "tol_rel": 1e-5,
                                                          "maxiter": 800}),
    "ml_poisson_m16": ("two_level", ("poisson", 16, 5), {
        "tl": dict(agg=8, coarse_max=64), "tol_rel": 1e-5, "maxiter": 800}),
    "tl_dia_m16": ("two_level", ("dia", 16, 7), {"tl": dict(agg=64), "tol_rel": 1e-5,
                                                  "maxiter": 800}),
    "defl_clustered_n256": ("deflated", ("clustered", 256, 30), {
        "V": "low", "tol_rel": 1e-5, "maxiter": 1024}),
    "defl_clustered_n256_overlap": ("deflated", ("clustered", 256, 30), {
        "V": "low", "tol_rel": 1e-5, "maxiter": 1024, "strategy": "overlap"}),
    "defl_generator_n100_padded": ("deflated", ("generator", 100, 32), {"V": (33, 3)}),
    "defl_scaled_n192_jacobi": ("deflated", ("scaled_clustered", 192, 34), {
        "V": "low", "tol_rel_w": 1e-4, "maxiter": 768, "precondition": "jacobi"}),
    "defl_poisson_m8_exact": ("deflated", ("poisson", 8, 30), {"V": "plain", "tol_rel": 1e-5}),
    "defl_dia_m8_jacobi": ("deflated", ("dia", 8, 31), {"V": (31, 3), "tol_rel": 1e-5,
                                                         "precondition": "jacobi"}),
    "defl_well_geo2000_exact": ("deflated", ("geometric", 2000, 9), {"V": "plain",
                                                                      "tol_rel": 1e-5}),
    "recycling_poisson_m8": ("recycling", ("poisson", 8, 33), {"tol": 1e-4, "steps": 3}),
    "minres_n192": ("minres", ("indefinite", 192, 1), {"tol_rel": 1e-5}),
    "minres_band2048_jacobi": ("minres", ("scaled_band_dense", 2048, 1), {
        "tol_rel": 1e-4, "precondition": "jacobi"}),
    "minres_band2048_block_jacobi": ("minres", ("scaled_band_dense", 2048, 1), {
        "tol_rel": 1e-4, "precondition": "block_jacobi", "pc_block_size": 32}),
    "minres_dia_band4096": ("minres", ("band_dia", 4096, 1), {"tol_rel": 1e-4}),
    "minres_poisson_m8": ("minres", ("poisson", 8, 40), {"tol_rel": 1e-5}),
    "ir_n256": ("ir", ("ir_shifted", 256, 4), {"tol_rel": 1e-5}),
    "ir_n50_overlap_padded": ("ir", ("generator", 50, 6), {"tol_rel": 1e-5,
                                                           "strategy": "overlap"}),
}


def m12_system(spec) -> dict:
    """The NumPy system of an ``M12_CASES`` case: ``A`` (dense) or ``op``
    (``("poisson", m)``, a DIAMatrix or a CSRMatrix, which both packages
    shard as WELL), ``b``, and ``low`` (slow eigenvectors) or ``csr`` (the
    two-level build's input) where the case has them."""
    from tpucg_torch.io.generator import (
        generate_spd_system,
        poisson3d_csr,
        poisson3d_dia,
        random_geometric_spd,
    )
    from tpucg_torch.sparse.formats import DIAMatrix

    kind, n, seed = spec
    rng = np.random.default_rng(seed)
    if kind == "geometric":
        A, b, _ = random_geometric_spd(n, seed=seed, avg_degree=12.0, shift=0.05)
        return {"op": A, "csr": A, "b": b.astype(np.float32)}
    if kind in ("poisson", "dia"):
        m = n
        b = rng.standard_normal(m ** 3).astype(np.float32)
        op = ("poisson", m) if kind == "poisson" else poisson3d_dia(m)
        return {"op": op, "csr": poisson3d_csr(m), "b": b}
    if kind == "clustered":
        A, low = _clustered_spd(n=n, seed=seed)
        return {"A": A, "low": low, "b": rng.standard_normal(n).astype(np.float32)}
    if kind == "scaled_clustered":  # tpucg's test_deflation.py test_composes_with_jacobi
        A, low = _clustered_spd(n=n, seed=seed)
        d = np.exp(np.random.default_rng(seed + 1).uniform(0, np.log(10), n))
        As = (A * d[:, None] * d[None, :]).astype(np.float32)
        b = np.random.default_rng(seed + 2).standard_normal(n).astype(np.float32)
        return {"A": As, "low": (low / d[:, None]).astype(np.float32), "b": b}
    if kind == "generator":
        A, b, _ = generate_spd_system(n, seed=seed)
        return {"A": A, "b": b}
    if kind == "ir_shifted":  # tpucg's test_ir.py: A - (n - n/32) I
        A, b, _ = generate_spd_system(n, seed=seed)
        return {"A": (A - (n - n / 32.0) * np.eye(n)).astype(np.float32), "b": b}
    if kind == "indefinite":
        return {"A": sym_indefinite(n, seed=0),
                "b": rng.standard_normal(n).astype(np.float32)}
    data, offsets = staggered_band(n, e=1.0 if kind == "scaled_band_dense" else None)
    dia = DIAMatrix(data=data, offsets=offsets, shape=(n, n))
    b = rng.standard_normal(n).astype(np.float32)
    if kind == "scaled_band_dense":
        A = np.zeros((n, n), np.float32)
        for d, off in enumerate(offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            A[i, i + off] = data[d, i]
        return {"A": A, "b": b}
    return {"op": dia, "b": b}


def m12_kwargs(name: str, s: dict) -> dict:
    """A case's solve keyword arguments (tol from ``tol_rel``, or
    ``tol_rel_w`` over ||D^-1/2 b||; maxiter default 4 n), the same for both
    packages; the solver's own entries (tl, V, steps) removed."""
    kw = {k: v for k, v in M12_CASES[name][2].items() if k not in ("tl", "V", "steps")}
    b = s["b"]
    if "tol_rel" in kw:
        kw["tol"] = kw.pop("tol_rel") * float(np.linalg.norm(b))
    if "tol_rel_w" in kw:
        d = np.diag(s["A"]).astype(np.float64)
        kw["tol"] = kw.pop("tol_rel_w") * float(np.linalg.norm(b / np.sqrt(d)))
    kw.setdefault("maxiter", 4 * b.shape[0])
    return kw


def m12_npad(s: dict, P: int) -> int:
    """The sharded padding of an operator case on P ranks (both packages):
    Poisson's plane-padded slabs, DIA's and WELL's 128 P-aligned rows."""
    op = s["op"]
    if isinstance(op, tuple):
        m = op[1]
        return -(-m // P) * P * m * m
    n = s["b"].shape[0]
    return -(-n // (128 * P)) * 128 * P


def solve_m12_case(mesh, name: str, s: dict = None) -> dict:
    """One case of ``M12_CASES`` through the port on ``mesh`` (its system
    ``s``, default ``m12_system`` of its spec); x, iterations (a list for
    recycling), converged and residual_norm as NumPy."""
    from tpucg_torch.solver.deflation import RecyclingCG, sharded_cg_solve_deflated
    from tpucg_torch.solver.ir import sharded_cg_solve_ir
    from tpucg_torch.solver.minres import sharded_minres_solve
    from tpucg_torch.solver.operators import PoissonOperator
    from tpucg_torch.solver.sharded import sharded_operator_cg_solve
    from tpucg_torch.solver.twolevel import build_two_level

    solver, spec, raw = M12_CASES[name]
    s = m12_system(spec) if s is None else s
    kw = m12_kwargs(name, s)
    A = s.get("A")
    if A is None:
        A = s["op"]
        if isinstance(A, tuple):
            A = PoissonOperator(A[1], device=mesh.device)
    if solver == "two_level":
        t = raw["tl"]
        tl = build_two_level(s["csr"], agg_size=t["agg"], npad=m12_npad(s, mesh.size),
                             smooth_degree=t.get("smooth_degree", 1),
                             coarse_max=t.get("coarse_max"), device=mesh.device)
        res = sharded_operator_cg_solve(A, s["b"], mesh=mesh, two_level=tl, **kw)
    elif solver == "deflated":
        V = raw["V"]
        if V == "low":
            V = s["low"]
        elif V == "plain":
            V = sharded_operator_cg_solve(A, s["b"], mesh=mesh, **kw).x.cpu().numpy()
        else:
            V = np.random.default_rng(V[0]).standard_normal((s["b"].shape[0], V[1]))
        res = sharded_cg_solve_deflated(A, s["b"], V.astype(np.float32), mesh=mesh, **kw)
    elif solver == "minres":
        res = sharded_minres_solve(A, s["b"], mesh=mesh, **kw)
    elif solver == "ir":
        res = sharded_cg_solve_ir(A, s["b"], mesh=mesh, **kw)
    else:
        drift = np.random.default_rng(spec[2] + 100).standard_normal(s["b"].shape[0])
        rec = RecyclingCG(A, max_vectors=4, mesh=mesh, **kw)
        runs = [rec.solve((s["b"] + 0.05 * t * drift).astype(np.float32))
                for t in range(raw["steps"])]
        return {"x": np.stack([r.x.cpu().numpy() for r in runs]),
                "iterations": [int(r.iterations) for r in runs],
                "converged": all(bool(r.converged) for r in runs)}
    return {"x": res.x.cpu().numpy(), "iterations": int(res.iterations),
            "converged": bool(res.converged), "residual_norm": float(res.residual_norm)}


def sharded_m12_worker(rank, nprocs, systems, device="cpu"):
    """A rank of a world that runs the cases of ``M12_CASES`` on a gloo
    mesh of ``device``, each on its system in ``systems`` (made once by the
    caller: the ranks of one machine would contend for its cores making
    them); rank 0's results by case."""
    from tpucg_torch.comm.mesh import make_mesh

    mesh = make_mesh(device=device, backend="gloo")
    return {name: solve_m12_case(mesh, name, systems[name]) for name in M12_CASES}


def card_m14s45_worker(rank, nprocs, paths, fem_kw, n=2048, device="cuda:0"):
    """A rank of a gloo world on ``device`` (``chip_smoke.py``'s M14 steps
    4-5 phase; on the CPU with small sizes, its rehearsal): the indexed
    FEM ``.mtx`` of ``paths`` loaded host-sharded with the two-level cycle
    built from the parts (``fem_kw``: two_level_agg, smooth_degree, tol,
    maxiter), its bytes read, the two-level solve timed with its transport;
    capped two-level and Jacobi solves of 16 and 32 laps (the transport's
    calls and host ms a lap: their difference over 16 laps); MINRES with
    Jacobi on ``generate_spd_system(n, seed=0)`` and IR on tpucg's IR system
    A - (n - n/32) I, allgather. Rank 0's results, with every rank's bytes
    read and the kernels' launches (rank 0)."""
    import time

    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.kernels.blas1 import dot_cuda, fused_update_cuda
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.gather_spmv import well_spmv_cuda
    from tpucg_torch.kernels.matvec import matvec_cuda
    from tpucg_torch.solver.ir import sharded_cg_solve_ir
    from tpucg_torch.solver.minres import sharded_minres_solve
    from tpucg_torch.solver.sharded import load_well_system_sharded, sharded_operator_cg_solve

    strict_f32()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = make_mesh(device=dev, backend="gloo")
    kernels = (matvec_cuda, dot_cuda, fused_update_cuda, well_spmv_cuda)
    out = {"mesh": repr(mesh)}
    t0 = time.perf_counter()
    ws = load_well_system_sharded(paths["fem"], paths["fem_b"], mesh=mesh,
                                  two_level_agg=fem_kw["two_level_agg"],
                                  smooth_degree=fem_kw["smooth_degree"])
    sync()
    out["load_s"] = time.perf_counter() - t0
    out["bytes_read"] = [int(v) for v in mesh.host_max(
        np.eye(nprocs, dtype=np.int64)[rank] * ws.bytes_read)]

    def timed(label, fn):
        sync()
        mesh.stats.update(calls=0, seconds=0.0)
        before = [w.launches for w in kernels]
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[label] = {
            "x": res.x.cpu().numpy() if rank == 0 else None,
            "laps": int(res.iterations), "converged": bool(res.converged),
            "ms": (time.perf_counter() - t0) * 1e3, "transport_s": mesh.stats["seconds"],
            "transport_calls": mesh.stats["calls"],
            "launches": {w.__name__: w.launches - c for w, c in zip(kernels, before)}}
    kw = dict(tol=fem_kw["tol"], maxiter=fem_kw["maxiter"])
    timed("two_level", lambda: sharded_operator_cg_solve(ws, mesh=mesh, two_level=ws.two_level,
                                                         **kw))
    per_lap = {}
    for label, pkw in (("two_level", dict(two_level=ws.two_level)),
                       ("jacobi", dict(precondition="jacobi"))):
        seen = {}
        for laps in (16, 32):
            sync()
            mesh.stats.update(calls=0, seconds=0.0)
            sharded_operator_cg_solve(ws, mesh=mesh, tol=1e-30, maxiter=laps, chunk=16, **pkw)
            sync()
            seen[laps] = (mesh.stats["calls"], mesh.stats["seconds"])
        per_lap[label] = ((seen[32][0] - seen[16][0]) / 16,
                          (seen[32][1] - seen[16][1]) / 16 * 1e3)
    out["per_lap"] = per_lap
    A, b, _ = generate_spd_system(n, seed=0)
    tol = 1e-5 * float(np.linalg.norm(b))
    timed("minres", lambda: sharded_minres_solve(A, b, mesh=mesh, precondition="jacobi",
                                                 tol=tol))
    A_ir = (A - (n - n / 32.0) * np.eye(n, dtype=np.float32)).astype(np.float32)
    timed("ir", lambda: sharded_cg_solve_ir(A_ir, b, mesh=mesh, tol=tol))
    return out


# M14 step 7's cases, tpucg's tests/test_sharded2d.py and the 2-D cases of
# test_ca.py, test_chebyshev.py and test_poly_precond.py with their systems
# and seeds: name -> (solver, system, keyword arguments). Solvers: "cg"
# (sharded_cg_solve), "minres", "deflated" (V "plain": the plain 2-D solve's
# x; (seed, m): a random stack), "multi" and "block" (B (n, k) from seed
# ``B``). Systems: ("gen", n, seed) generate_spd_system, ("shifted", n,
# seed, f) its A - (n - n/f) I, ("scaled", n, seed) tpucg's badly
# diagonal-scaled system, ("indefinite", n, seed) tpucg's 2-D MINRES
# system, ("scaled_band", n, seed) the scaled staggered band of the M12
# cases as a dense A (MINRES with Jacobi there stops in a few laps set by
# the spectrum; on tpucg's indefinite system its laps move 192-195 between
# tpucg's own meshes), ("golden",) the 4x4 golden. ``tol_rel`` is tol over
# ||b||.
SUMMA_SHAPES = ((2, 2), (1, 4), (4, 1))
SUMMA_CASES = {
    "oracle_n96": ("cg", ("gen", 96, 1), {}),
    "padded_n67": ("cg", ("gen", 67, 3), {}),
    "pipelined_n128": ("cg", ("gen", 128, 2), {"method": "pipelined", "tol_rel": 1e-5}),
    "golden_4x4": ("cg", ("golden",), {}),
    "jacobi_scaled_n96": ("cg", ("scaled", 96, 6), {"precondition": "jacobi", "tol_rel": 1e-5,
                                                     "maxiter": 960}),
    "record_n96": ("cg", ("shifted", 96, 19, 8.0), {"record_residuals": True}),
    "ca_n96": ("cg", ("gen", 96, 1), {"method": "ca", "s_step": 3}),
    "chebyshev_n96": ("cg", ("gen", 96, 1), {"method": "chebyshev", "maxiter": 768}),
    "poly_n96": ("cg", ("shifted", 96, 7, 10.0), {"precondition": "poly", "poly_degree": 3,
                                                   "tol_rel": 1e-5, "maxiter": 960}),
    "bf16_n200": ("cg", ("gen", 200, 73), {"storage_dtype": "bf16", "tol_rel": 1e-4}),
    "minres_n192": ("minres", ("indefinite", 192, 70), {"tol_rel": 1e-4, "maxiter": 768}),
    "minres_jacobi_band512": ("minres", ("scaled_band", 512, 1), {
        "tol_rel": 1e-4, "maxiter": 2048, "precondition": "jacobi"}),
    "deflated_plain_n200": ("deflated", ("gen", 200, 71), {"V": "plain", "tol_rel": 1e-5}),
    "deflated_jacobi_n200": ("deflated", ("gen", 200, 71), {"V": (72, 3), "tol_rel": 1e-5,
                                                             "precondition": "jacobi"}),
    "multi_k8_n200": ("multi", ("gen", 200, 80), {"B": 81, "tol": 1e-5}),
    "block_k8_n200": ("block", ("gen", 200, 80), {"B": 81, "tol": 1e-5}),
    "block_jacobi_k8_n200": ("block", ("gen", 200, 80), {"B": 81, "tol": 1e-5,
                                                          "precondition": "jacobi"}),
    "block_poly_k8_n200": ("block", ("gen", 200, 80), {"B": 81, "tol": 1e-5,
                                                        "precondition": "poly",
                                                        "poly_degree": 2}),
}


def summa_system(spec) -> dict:
    """The NumPy system of a ``SUMMA_CASES`` case: A, b, x0 (or None)."""
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.io.golden import GOLDEN_4X4

    kind = spec[0]
    if kind == "golden":
        g = GOLDEN_4X4
        return {"A": np.asarray(g["A"], np.float32), "b": np.asarray(g["b"], np.float32),
                "x0": np.asarray(g["x0"], np.float32)}
    n, seed = spec[1], spec[2]
    if kind == "scaled":  # tpucg's test_2d_jacobi_matches_serial
        rng = np.random.default_rng(seed)
        Rm = rng.random((n, n))
        d = 10.0 ** rng.uniform(-2, 2, n)
        A = (((0.5 * (Rm + Rm.T) + n * np.eye(n)) * d).T * d).astype(np.float32)
        x_true = rng.standard_normal(n)
        return {"A": A, "b": (A @ x_true).astype(np.float32), "x0": None}
    if kind == "indefinite":  # tpucg's test_minres_2d_indefinite
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.concatenate([-(1 + rng.uniform(0, 1, n // 2)),
                              1 + rng.uniform(0, 1, n - n // 2)])
        A = ((Q * lam) @ Q.T).astype(np.float32)
        return {"A": 0.5 * (A + A.T), "b": rng.standard_normal(n).astype(np.float32),
                "x0": None}
    if kind == "scaled_band":
        band = m12_system(("scaled_band_dense", n, seed))
        return {"A": band["A"], "b": band["b"], "x0": None}
    A, b, x0 = generate_spd_system(n, seed=seed)
    if kind == "shifted":
        A = (A - (n - n / spec[3]) * np.eye(n)).astype(np.float32)
    return {"A": A, "b": b, "x0": x0}


def summa_kwargs(name: str, s: dict, torch_dtypes: bool = True) -> dict:
    """A case's solve keyword arguments (tol from ``tol_rel``; bf16 as the
    package's dtype), its own entries (V, B) removed."""
    kw = {k: v for k, v in SUMMA_CASES[name][2].items() if k not in ("V", "B")}
    if "tol_rel" in kw:
        kw["tol"] = kw.pop("tol_rel") * float(np.linalg.norm(s["b"]))
    if kw.get("storage_dtype") == "bf16":
        if torch_dtypes:
            kw["storage_dtype"] = torch.bfloat16
        else:
            import ml_dtypes

            kw["storage_dtype"] = ml_dtypes.bfloat16
    return kw


def summa_rhs(name: str, s: dict) -> np.ndarray:
    """B of a multi or block case: (n, 8) from the case's seed."""
    n = s["A"].shape[0]
    return np.random.default_rng(SUMMA_CASES[name][2]["B"]).standard_normal(
        (n, 8)).astype(np.float32)


def solve_summa_case(mesh, name: str, s: dict = None) -> dict:
    """One case of ``SUMMA_CASES`` through the port on ``mesh``; x,
    iterations (a list for multi), converged, the residual history where
    recorded, as NumPy."""
    from tpucg_torch.solver.deflation import sharded_cg_solve_deflated
    from tpucg_torch.solver.minres import sharded_minres_solve
    from tpucg_torch.solver.sharded import (
        sharded_cg_solve,
        sharded_cg_solve_block,
        sharded_cg_solve_multi,
    )

    solver, spec, raw = SUMMA_CASES[name]
    s = summa_system(spec) if s is None else s
    kw = summa_kwargs(name, s)
    A, b, x0 = s["A"], s["b"], s["x0"]
    if solver == "cg":
        res = sharded_cg_solve(A, b, x0, mesh=mesh, **kw)
    elif solver == "minres":
        res = sharded_minres_solve(A, b, mesh=mesh, **kw)
    elif solver == "deflated":
        V = raw["V"]
        if V == "plain":
            V = sharded_cg_solve(A, b, mesh=mesh, **kw).x.cpu().numpy()
        else:
            V = np.random.default_rng(V[0]).standard_normal((b.shape[0], V[1]))
        res = sharded_cg_solve_deflated(A, b, V.astype(np.float32), mesh=mesh, **kw)
    else:
        fn = sharded_cg_solve_multi if solver == "multi" else sharded_cg_solve_block
        res = fn(A, summa_rhs(name, s), mesh=mesh, **kw)
    hist = getattr(res, "residual_history", None)
    return {"x": res.x.cpu().numpy(), "iterations": res.iterations.cpu().numpy().tolist(),
            "converged": res.converged.cpu().numpy().tolist(),
            "hist": None if hist is None else hist.cpu().numpy()}


def sharded2d_worker(rank, nprocs, systems, shapes, device="cpu"):
    """A rank of a world of R C ranks that runs every case of
    ``SUMMA_CASES`` on each R x C mesh of ``shapes`` (gloo on ``device``),
    each on its system in ``systems``; rank 0's results by (case, shape)."""
    from tpucg_torch.comm.mesh import make_mesh2d

    out = {}
    try:  # a mesh smaller than the world: refused on every rank alike
        make_mesh2d(1, nprocs // 2, device=device, backend="gloo")
    except ValueError as e:
        out["smaller_mesh"] = str(e)
    for shape in shapes:
        mesh = make_mesh2d(*shape, device=device, backend="gloo")
        for name in SUMMA_CASES:
            out[(name, shape)] = solve_summa_case(mesh, name, systems[name])
        out[("stats", shape)] = dict(mesh.stats)
    return out


# M14 step 6's kill-and-resume cases on a mesh: name -> (kind, options).
# "dense" runs sharded_cg_solve_checkpointed on the rank's block of
# tpucg's conditioned checkpoint system shifted further
# (tests/test_checkpoint.py ``_conditioned_system(96)`` is A - (n - n/8) I,
# 8 laps; A - (n - n/16) I takes 13-14) loaded host-sharded;
# "operator" sharded_operator_cg_solve_checkpointed on Poisson m = 8 slabs
# (K9), its DIA form (K7) and the geometric 2000 graph as sharded WELL
# (K13), Jacobi and the two-level cycle (agg 32); "2d" the dense host
# system on the world's 2-D mesh. ``cap`` is the laps of the killed run,
# ``seg`` the segment of both runs.
CKPT_CASES = {
    "dense_allgather": ("dense", {"strategy": "allgather", "seg": 4, "cap": 8}),
    "dense_overlap_jacobi": ("dense", {"strategy": "overlap", "precondition": "jacobi",
                                       "seg": 3, "cap": 6}),
    "poisson_m8": ("operator", {"op": "poisson", "seg": 8, "cap": 16}),
    "dia_m8_jacobi": ("operator", {"op": "dia", "precondition": "jacobi", "seg": 8, "cap": 16}),
    "well_geo2000_jacobi": ("operator", {"op": "well", "precondition": "jacobi", "seg": 8,
                                         "cap": 16}),
    "well_geo2000_two_level": ("operator", {"op": "well", "two_level": 32, "seg": 16,
                                            "cap": 16}),
    "summa": ("2d", {"seg": 4, "cap": 8}),
    "summa_jacobi": ("2d", {"precondition": "jacobi", "seg": 5, "cap": 10}),
}


def ckpt_systems(d: str) -> dict:
    """The checkpoint cases' systems, made once by the caller: the dense
    one written to text files under ``d`` (for load_system_sharded) and
    kept whole (the 2-D cases'), Poisson's b, and the geometric graph."""
    import os

    from tpucg_torch.io.generator import generate_spd_system, random_geometric_spd
    from tpucg_torch.io.textio import save_array

    n = 96
    A, b, x0 = generate_spd_system(n, seed=4)
    A = (A - np.float32(n - n / 16.0) * np.eye(n, dtype=np.float32)).astype(np.float32)
    paths = {k: os.path.join(d, f) for k, f in (("A", "A.txt"), ("b", "b.txt"),
                                                 ("x0", "x0.txt"))}
    save_array(paths["A"], A.ravel(), fmt="%r")
    save_array(paths["b"], b, fmt="%r")
    save_array(paths["x0"], x0, fmt="%r")
    G, bg, _ = random_geometric_spd(2000, seed=9, avg_degree=8.0)
    rng = np.random.default_rng(5)
    return {"dense": (A, b, x0), "paths": paths, "poisson_b": rng.standard_normal(512).astype(
        np.float32), "geo": (G, bg.astype(np.float32))}


def ckpt_case_run(mesh, mesh2d, name, systems):
    """The case's pieces on this rank: (uncheckpointed solve, checkpointed
    solve as a function of its keyword arguments)."""
    from tpucg_torch.io.generator import poisson3d_dia
    from tpucg_torch.solver.checkpoint import (
        sharded_cg_solve_checkpointed,
        sharded_operator_cg_solve_checkpointed,
    )
    from tpucg_torch.solver.operators import PoissonOperator
    from tpucg_torch.solver.sharded import (
        load_system_sharded,
        sharded_cg_solve,
        sharded_operator_cg_solve,
    )
    from tpucg_torch.solver.twolevel import build_two_level

    kind, o = CKPT_CASES[name]
    pc = o.get("precondition", "none")
    if kind == "dense":
        p = systems["paths"]
        from tpucg_torch.config import CGConfig

        system = load_system_sharded(p["A"], p["b"], p["x0"], mesh=mesh, strategy=o["strategy"],
                                     config=CGConfig(precondition=pc))
        kw = dict(strategy=o["strategy"], precondition=pc,
                  tol=1e-5 * float(np.linalg.norm(systems["dense"][1])), maxiter=400)
        return (lambda: sharded_cg_solve(system, mesh=mesh, **kw),
                lambda **k: sharded_cg_solve_checkpointed(system, mesh=mesh, **dict(kw, **k)))
    if kind == "2d":
        A, b, x0 = systems["dense"]
        kw = dict(precondition=pc, tol=1e-5 * float(np.linalg.norm(b)), maxiter=400)
        return (lambda: sharded_cg_solve(A, b, x0, mesh=mesh2d, **kw),
                lambda **k: sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh2d,
                                                          **dict(kw, **k)))
    tl = None
    if o["op"] == "poisson":
        op, b = PoissonOperator(8, device=mesh.device), systems["poisson_b"]
    elif o["op"] == "dia":
        op, b = poisson3d_dia(8), systems["poisson_b"]
    else:
        op, b = systems["geo"]
        if "two_level" in o:
            npad = -(-op.shape[0] // (128 * mesh.size)) * 128 * mesh.size
            tl = build_two_level(op, agg_size=o["two_level"], npad=npad, device=mesh.device)
    kw = dict(precondition=pc, tol=1e-5 * float(np.linalg.norm(b)), maxiter=2000)
    return (lambda: sharded_operator_cg_solve(op, b, mesh=mesh, two_level=tl, **kw),
            lambda **k: sharded_operator_cg_solve_checkpointed(op, b, mesh=mesh, two_level=tl,
                                                               **dict(kw, **k)))


def _files_of(path, size):
    import os

    return [os.path.exists(path)] + [os.path.exists(f"{path}.proc{r}") for r in range(size)]


def _raised_everywhere(mesh, fn) -> dict:
    """Run ``fn`` on every rank; -> the exception's type and message on this
    rank (None if it returned) and how many ranks raised (a gather after
    the call: a rank left waiting inside it would hang the world)."""
    try:
        fn()
        err = None
    except Exception as e:  # noqa: BLE001 - the refusal under test
        err = (type(e).__name__, str(e))
    n_raised = int(mesh.host_sum(np.array([err is not None], np.int64))[0])
    return {"error": err, "ranks_raised": n_raised}


def sharded_checkpoint_worker(rank, nprocs, d, systems, tpucg_2d_file=None, device="cpu"):
    """A rank of a gloo world that runs ``CKPT_CASES``, each killed at a
    segment boundary (``cap`` laps, the file kept) and resumed in a fresh
    call, against the uncheckpointed sharded solve; then the refusals,
    each raised on every rank; then (given) the resume of tpucg's 2 x 2
    whole-state file. Rank 0's results."""
    import os
    import shutil

    from tpucg_torch.comm.mesh import make_mesh, make_mesh2d
    from tpucg_torch.solver.checkpoint import sharded_cg_solve_checkpointed
    from tpucg_torch.solver.sharded import sharded_cg_solve

    mesh = make_mesh(device=device, backend="gloo")
    mesh2d = make_mesh2d(2, nprocs // 2, device=device, backend="gloo")
    out = {}
    for name in CKPT_CASES:
        plain, ck = ckpt_case_run(mesh, mesh2d, name, systems)
        _, o = CKPT_CASES[name]
        path = os.path.join(d, f"{name}.npz")
        ref = plain()
        capped = ck(segment_iters=o["seg"], maxiter=o["cap"], checkpoint_path=path)
        kept = _files_of(path, nprocs)
        mesh.host_max(np.zeros(1))  # every rank has looked before any resumes
        res = ck(segment_iters=o["seg"], checkpoint_path=path)
        out[name] = {
            "ref_laps": int(ref.iterations), "laps": int(res.iterations),
            "capped_laps": int(capped.iterations), "capped_converged": bool(capped.converged),
            "converged": bool(res.converged), "bits": torch.equal(ref.x, res.x),
            "x": res.x.cpu().numpy(), "kept": kept, "left": _files_of(path, nprocs)}
    # Refusals, each decided alike on every rank.
    _, ck = ckpt_case_run(mesh, mesh2d, "dense_allgather", systems)
    path = os.path.join(d, "refuse.npz")
    ck(segment_iters=2, maxiter=2, checkpoint_path=path)
    out["tol"] = _raised_everywhere(mesh, lambda: ck(checkpoint_path=path, tol=1e-3))
    out["precondition"] = _raised_everywhere(
        mesh, lambda: ck(checkpoint_path=path, precondition="jacobi"))
    A, b, x0 = systems["dense"]
    from tpucg_torch.solver.sharded import distribute_system

    other = distribute_system(A, 2.0 * b, x0, mesh)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=400)
    out["signature"] = _raised_everywhere(
        mesh, lambda: sharded_cg_solve_checkpointed(other, mesh=mesh, checkpoint_path=path, **kw))
    small = distribute_system(A[:64, :64], b[:64], None, mesh)
    out["n"] = _raised_everywhere(
        mesh, lambda: sharded_cg_solve_checkpointed(small, mesh=mesh, checkpoint_path=path,
                                                    **kw))
    out["host_arrays"] = _raised_everywhere(
        mesh, lambda: sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh, **kw))
    # A torn generation: rank 1's file from the segment before.
    torn = os.path.join(d, "torn.npz")
    ck(segment_iters=2, maxiter=2, checkpoint_path=torn)
    if rank == 1:
        shutil.copy(f"{torn}.proc1", os.path.join(d, "old.proc1"))
    mesh.host_max(np.zeros(1))
    ck(segment_iters=2, maxiter=4, checkpoint_path=torn)
    if rank == 1:
        shutil.copy(os.path.join(d, "old.proc1"), f"{torn}.proc1")
    mesh.host_max(np.zeros(1))
    out["torn"] = _raised_everywhere(mesh, lambda: ck(checkpoint_path=torn))
    # Files written by a world of another size: this rank's file says so.
    topo = os.path.join(d, "topo.npz")
    ck(segment_iters=2, maxiter=2, checkpoint_path=topo)
    with np.load(f"{topo}.proc{rank}") as z:
        fields = dict(z)
    fields["process_count"] = np.int64(2 * nprocs)
    np.savez(f"{topo}.proc{rank}.npz", **fields)
    os.replace(f"{topo}.proc{rank}.npz", f"{topo}.proc{rank}")
    mesh.host_max(np.zeros(1))
    out["topology"] = _raised_everywhere(mesh, lambda: ck(checkpoint_path=topo))
    # A file on some ranks only.
    some = os.path.join(d, "some.npz")
    ck(segment_iters=2, maxiter=2, checkpoint_path=some)
    mesh.host_max(np.zeros(1))
    if rank == nprocs - 1:
        os.remove(f"{some}.proc{rank}")
    mesh.host_max(np.zeros(1))
    out["missing"] = _raised_everywhere(mesh, lambda: ck(checkpoint_path=some))
    if tpucg_2d_file is not None:
        res = sharded_cg_solve_checkpointed(A, b, x0, mesh=mesh2d, segment_iters=4,
                                            checkpoint_path=tpucg_2d_file, **kw)
        out["tpucg_2d"] = {"laps": int(res.iterations), "converged": bool(res.converged),
                           "x": res.x.cpu().numpy(), "left": os.path.exists(tpucg_2d_file)}
        out["tpucg_2d_plain"] = sharded_cg_solve(A, b, x0, mesh=mesh2d, **kw).x.cpu().numpy()
    return out


def mp_dense_worker(rank, nprocs, workdir):
    """A rank of the port's multi-process battery (tpucg's
    ``tests/_mp_worker.py`` main mode on a gloo world): host-sharded loading
    of the text system with each rank's parsed row ranges recorded, the
    solve under both strategies, the per-rank checkpoint capped and resumed,
    Chebyshev, block CG and block Jacobi; rank 0 writes the results to
    ``workdir`` as tpucg's worker does, every rank its reads."""
    import json
    import os

    import tpucg_torch.io.textio as textio
    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.config import CGConfig
    from tpucg_torch.solver.checkpoint import _mp_path, sharded_cg_solve_checkpointed
    from tpucg_torch.solver.sharded import (
        load_system_sharded,
        sharded_cg_solve,
        sharded_cg_solve_block,
    )

    reads = []
    orig = textio.load_matrix_rows

    def traced(path, r0, r1, ncols):
        reads.append([int(r0), int(r1)])
        return orig(path, r0, r1, ncols)

    textio.load_matrix_rows = traced
    mesh = make_mesh(device="cpu", backend="gloo")
    files = [os.path.join(workdir, f) for f in ("A.txt", "b.txt", "x0.txt")]
    put = (lambda name, v: np.save(os.path.join(workdir, name), v)) if rank == 0 \
        else (lambda name, v: None)

    def meta(name, d):
        if rank == 0:
            with open(os.path.join(workdir, name), "w") as f:
                json.dump(d, f)
    for strategy in ("allgather", "overlap"):
        system = load_system_sharded(*files, mesh=mesh, strategy=strategy)
        n = system.n
        res = sharded_cg_solve(system, mesh=mesh, strategy=strategy)
        put(f"x_{strategy}.npy", res.x.numpy())
        meta(f"meta_{strategy}.json", {"iterations": int(res.iterations),
                                       "converged": bool(res.converged),
                                       "residual_norm": float(res.residual_norm)})
    system = load_system_sharded(*files, mesh=mesh)
    ckpt = os.path.join(workdir, "cg.ckpt")
    res_cap = sharded_cg_solve_checkpointed(system, mesh=mesh, segment_iters=2, maxiter=2,
                                            checkpoint_path=ckpt)
    assert not bool(res_cap.converged), "n=72 system converged in 2 laps?"
    assert os.path.exists(_mp_path(ckpt, rank)), "capped exit left no shard file"
    res_ck = sharded_cg_solve_checkpointed(system, mesh=mesh, segment_iters=3,
                                           checkpoint_path=ckpt)
    assert not os.path.exists(_mp_path(ckpt, rank)), "converged solve must clean up"
    res_plain = sharded_cg_solve(system, mesh=mesh)
    put("x_ckpt.npy", res_ck.x.numpy())
    put("x_ckpt_plain.npy", res_plain.x.numpy())
    meta("meta_ckpt.json", {"iterations": int(res_ck.iterations),
                            "converged": bool(res_ck.converged),
                            "plain_iterations": int(res_plain.iterations)})
    res_ch = sharded_cg_solve(system, mesh=mesh, method="chebyshev", maxiter=8 * n)
    A_full, _, _ = textio.load_system(*files)
    Bk = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    res_blk = sharded_cg_solve_block(np.asarray(A_full), Bk, mesh=mesh)
    # Block Jacobi with shard-local blocks of 8 (the partition aligns to them).
    system_bj = load_system_sharded(*files, mesh=mesh,
                                    config=CGConfig(precondition="block_jacobi",
                                                    pc_block_size=8))
    res_bj = sharded_cg_solve(system_bj, mesh=mesh, precondition="block_jacobi", pc_block_size=8)
    put("x_cheb.npy", res_ch.x.numpy())
    put("x_block.npy", res_blk.x.numpy())
    put("x_bj.npy", res_bj.x.numpy())
    meta("meta_arms.json", {"cheb_converged": bool(res_ch.converged),
                            "cheb_iterations": int(res_ch.iterations),
                            "block_converged": bool(res_blk.converged.all()),
                            "block_iterations": int(res_blk.iterations),
                            "bj_converged": bool(res_bj.converged)})
    with open(os.path.join(workdir, f"reads_{rank}.json"), "w") as f:
        json.dump(sorted(reads), f)
    return True


def mp_operator_worker(rank, nprocs, workdir):
    """A rank of the port's wide operator battery (tpucg's ``_mp_worker.py``
    operator mode on a gloo world): Poisson m = 8 slabs and their DIA form,
    sharded WELL with the two-level cycle, and the indexed ``.mtx`` loaded
    host-sharded with the cycle built from the parts, each rank's bytes
    read written to ``workdir``. The DIA and WELL inputs are tpucg's
    generators' arrays, read from ``workdir/ops.npz``."""
    import json
    import os

    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.solver.operators import PoissonOperator
    from tpucg_torch.solver.sharded import load_well_system_sharded, sharded_operator_cg_solve
    from tpucg_torch.solver.twolevel import build_two_level
    from tpucg_torch.sparse.formats import CSRMatrix, DIAMatrix

    mesh = make_mesh(device="cpu", backend="gloo")
    with np.load(os.path.join(workdir, "ops.npz")) as z:
        m = int(z["m"])
        dia = DIAMatrix(offsets=z["dia_offsets"], data=z["dia_data"], shape=(m ** 3, m ** 3))
        Aw = CSRMatrix(indptr=z["w_indptr"], indices=z["w_indices"], data=z["w_data"],
                       shape=tuple(int(v) for v in z["w_shape"]))
        bw = z["w_b"]
    n = m ** 3
    b = np.ones(n, np.float32)
    tol = 1.0e-5 * float(np.linalg.norm(b))
    res_p = sharded_operator_cg_solve(PoissonOperator(m, device="cpu"), b, mesh=mesh, tol=tol)
    res_d = sharded_operator_cg_solve(dia, b, mesh=mesh, tol=tol)
    tol_w = 1e-5 * float(np.linalg.norm(bw))
    tl = build_two_level(Aw, agg_size=32, npad=1024, device="cpu")
    res_w = sharded_operator_cg_solve(Aw, bw, mesh=mesh, tol=tol_w, two_level=tl)
    sys_mtx = load_well_system_sharded(os.path.join(workdir, "G.mtx"),
                                       os.path.join(workdir, "gb.npy"), mesh=mesh,
                                       two_level_agg=32)
    res_mx = sharded_operator_cg_solve(sys_mtx, mesh=mesh, tol=tol_w,
                                       two_level=sys_mtx.two_level)
    with open(os.path.join(workdir, f"mtx_bytes_{rank}.json"), "w") as f:
        json.dump({"bytes_read": int(sys_mtx.bytes_read)}, f)
    if rank == 0:
        for name, r, k in (("poisson", res_p, n), ("dia", res_d, n), ("well2l", res_w, 1024),
                           ("mtx", res_mx, sys_mtx.n)):
            np.save(os.path.join(workdir, f"x_op_{name}.npy"), r.x.numpy()[:k])
        with open(os.path.join(workdir, "meta_op.json"), "w") as f:
            json.dump({"nproc": nprocs, "poisson_converged": bool(res_p.converged),
                       "poisson_iterations": int(res_p.iterations),
                       "dia_converged": bool(res_d.converged),
                       "dia_iterations": int(res_d.iterations),
                       "well2l_converged": bool(res_w.converged),
                       "well2l_iterations": int(res_w.iterations),
                       "mtx_converged": bool(res_mx.converged),
                       "mtx_iterations": int(res_mx.iterations), "mtx_n": int(sys_mtx.n)}, f)
    return True


def _timed_run(mesh, rank, kernels, fn, sync):
    """One solve with the world's transport counted from 0: its result's
    laps (a list for k columns), x (rank 0), converged, host ms, transport
    calls and seconds, and the kernels' launches on this rank."""
    import time

    sync()
    mesh.stats.update(calls=0, seconds=0.0)
    before = [w.launches for w in kernels]
    t0 = time.perf_counter()
    res = fn()
    sync()
    return {"x": res.x.cpu().numpy() if rank == 0 else None,
            "laps": res.iterations.cpu().numpy().tolist(),
            "converged": bool(res.converged.all()), "ms": (time.perf_counter() - t0) * 1e3,
            "transport_calls": mesh.stats["calls"], "transport_s": mesh.stats["seconds"],
            "launches": {w.__name__: w.launches - c for w, c in zip(kernels, before)}}


def _per_lap(mesh, solve, sync):
    """The transport's calls and host ms a lap of a capped classic solve:
    the difference of 32 and 16 laps over 16."""
    seen = {}
    for laps in (16, 32):
        sync()
        mesh.stats.update(calls=0, seconds=0.0)
        solve(laps)
        sync()
        seen[laps] = (mesh.stats["calls"], mesh.stats["seconds"])
    return ((seen[32][0] - seen[16][0]) / 16, (seen[32][1] - seen[16][1]) / 16 * 1e3)


def ckpt_io_ms(io, path, n, tol, sync):
    """Host ms of one resume (``io.load``) and one save of its state through
    the transport ``io`` (a copy beside ``path``, removed)."""
    import time

    sync()
    t0 = time.perf_counter()
    state, _, _, sig, pre, _ = io.load(path)
    sync()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    io.save(path + ".timed", io.to_host(state), n, tol, sig, pre)
    save_ms = (time.perf_counter() - t0) * 1e3
    io.remove(path + ".timed")
    return save_ms, load_ms


def card_m14s67_worker(rank, nprocs, paths, cfg, device="cuda:0"):
    """A rank of a gloo world of 4 on ``device`` (``chip_smoke.py``'s phase
    25; on the CPU with small sizes, its rehearsal): the dense system of
    ``paths`` (.npy) on the 2 x 2 mesh (cg, pipelined, Jacobi, bf16
    storage, multi-RHS and block CG at k = ``cfg["k"]``, deflated on the
    clustered system of ``paths``, MINRES with Jacobi, the checkpoint killed
    at ``cfg["cap"]`` laps and resumed) and on 1 x 4 (cg, pipelined); the
    transport a lap on each and on the world's 1-D mesh (allgather). Rank
    0's results, with its kernels' launches."""
    import os

    from tpucg_torch.comm.mesh import make_mesh, make_mesh2d
    from tpucg_torch.kernels.blas1 import dot_cuda, fused_update_cuda
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.matvec import matvec_cuda
    from tpucg_torch.solver.checkpoint import _io_for, sharded_cg_solve_checkpointed
    from tpucg_torch.solver.deflation import sharded_cg_solve_deflated
    from tpucg_torch.solver.minres import sharded_minres_solve
    from tpucg_torch.solver.sharded import (
        sharded_cg_solve,
        sharded_cg_solve_block,
        sharded_cg_solve_multi,
    )

    strict_f32()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    A, b, x0 = (np.load(paths[k]) for k in ("A", "b", "x0"))
    Ad, bd, Vd = (np.load(paths[k]) for k in ("A_defl", "b_defl", "V_defl"))
    B = np.random.default_rng(cfg["B_seed"]).standard_normal((A.shape[0], cfg["k"])).astype(
        np.float32)
    tol = 1e-6 * float(np.linalg.norm(b))
    kernels = (matvec_cuda, dot_cuda, fused_update_cuda)
    world = make_mesh(device=dev, backend="gloo")
    out = {"mesh": repr(world)}
    per_lap = {"1-D allgather": _per_lap(world, lambda k: sharded_cg_solve(
        A, b, x0, mesh=world, tol=1e-30, maxiter=k, chunk=16), sync)}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh2d(*shape, device=dev, backend="gloo")
        tag = f"{shape[0]}x{shape[1]}"
        out[("repr", tag)] = repr(mesh)

        def run(label, fn):
            out[(label, tag)] = _timed_run(mesh, rank, kernels, fn, sync)
        base = dict(tol=tol, maxiter=2000)
        run("cg", lambda: sharded_cg_solve(A, b, x0, mesh=mesh, **base))
        run("pipelined", lambda: sharded_cg_solve(A, b, x0, mesh=mesh, method="pipelined",
                                                  **base))
        per_lap[tag] = _per_lap(mesh, lambda k: sharded_cg_solve(
            A, b, x0, mesh=mesh, tol=1e-30, maxiter=k, chunk=16), sync)
        if shape != (2, 2):
            continue
        run("jacobi", lambda: sharded_cg_solve(A, b, x0, mesh=mesh, precondition="jacobi",
                                               **base))
        bf16_before = matvec_cuda.bf16_launches
        run("bf16", lambda: sharded_cg_solve(A, b, x0, mesh=mesh, storage_dtype=torch.bfloat16,
                                             **base))
        out["bf16_launches"] = matvec_cuda.bf16_launches - bf16_before
        run("multi", lambda: sharded_cg_solve_multi(A, B, mesh=mesh, tol=cfg["tol_k"],
                                                    maxiter=2000))
        run("block", lambda: sharded_cg_solve_block(A, B, mesh=mesh, tol=cfg["tol_k"],
                                                    maxiter=2000))
        run("deflated", lambda: sharded_cg_solve_deflated(
            Ad, bd, Vd, mesh=mesh, tol=1e-5 * float(np.linalg.norm(bd)),
            maxiter=4 * Ad.shape[0]))
        run("minres", lambda: sharded_minres_solve(A, b, x0, mesh=mesh, precondition="jacobi",
                                                   tol=1e-5 * float(np.linalg.norm(b))))
        path = os.path.join(paths["dir"], "summa.npz")
        kw = dict(mesh=mesh, segment_iters=cfg["seg"], checkpoint_path=path, **base)
        run("ckpt_plain", lambda: sharded_cg_solve(A, b, x0, mesh=mesh, **base))
        run("ckpt_killed", lambda: sharded_cg_solve_checkpointed(A, b, x0, **dict(
            kw, maxiter=cfg["cap"])))
        out["ckpt_kept"] = os.path.exists(path)
        out["ckpt_io_ms"] = ckpt_io_ms(_io_for(mesh), path, A.shape[0], tol, sync)
        run("ckpt_resumed", lambda: sharded_cg_solve_checkpointed(A, b, x0, **kw))
        out["ckpt_left"] = os.path.exists(path)
        out["ckpt_bits"] = bool(rank != 0 or np.array_equal(out[("ckpt_resumed", tag)]["x"],
                                                            out[("ckpt_plain", tag)]["x"]))
    out["per_lap"] = per_lap
    return out


def card_m14s67_files_worker(rank, nprocs, paths, cfg, device="cuda:0"):
    """A rank of a gloo world of 2 on ``device`` (phase 25): the dense
    system of ``paths`` (.npy) loaded host-sharded, its checkpointed solve
    killed at ``cfg["cap"]`` laps with a file per rank and resumed, against
    the uncheckpointed solve; one save and one resume of the per-rank
    files, timed. Rank 0's results."""
    import os

    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.kernels.blas1 import dot_cuda, fused_update_cuda
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.matvec import matvec_cuda
    from tpucg_torch.solver.checkpoint import _io_for, sharded_cg_solve_checkpointed
    from tpucg_torch.solver.sharded import load_system_sharded, sharded_cg_solve

    strict_f32()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = make_mesh(device=dev, backend="gloo")
    system = load_system_sharded(paths["A"], paths["b"], paths["x0"], mesh=mesh)
    b = np.load(paths["b"])
    kw = dict(tol=1e-6 * float(np.linalg.norm(b)), maxiter=2000)
    kernels = (matvec_cuda, dot_cuda, fused_update_cuda)
    path = os.path.join(paths["dir"], "files.npz")
    out = {"mesh": repr(mesh)}
    out["plain"] = _timed_run(mesh, rank, kernels, lambda: sharded_cg_solve(system, mesh=mesh,
                                                                            **kw), sync)
    out["killed"] = _timed_run(mesh, rank, kernels, lambda: sharded_cg_solve_checkpointed(
        system, mesh=mesh, segment_iters=cfg["seg"], checkpoint_path=path,
        **dict(kw, maxiter=cfg["cap"])), sync)
    out["kept"] = [os.path.exists(f"{path}.proc{r}") for r in range(nprocs)] + [
        os.path.exists(path)]
    out["io_ms"] = ckpt_io_ms(_io_for(mesh, per_rank=True), path, system.n, kw["tol"], sync)
    out["resumed"] = _timed_run(mesh, rank, kernels, lambda: sharded_cg_solve_checkpointed(
        system, mesh=mesh, segment_iters=cfg["seg"], checkpoint_path=path, **kw), sync)
    out["left"] = any(os.path.exists(f"{path}.proc{r}") for r in range(nprocs))
    out["bits"] = bool(rank != 0 or np.array_equal(out["resumed"]["x"], out["plain"]["x"]))
    return out
