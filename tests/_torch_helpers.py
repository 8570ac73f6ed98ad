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
    the ranks of one gloo world (``init_distributed`` through the file
    ``rendezvous``, which must not exist yet), and return rank 0's return
    value. A rank that raises fails the world (the others are ended) and
    raises here with its traceback; so does a world that outlasts
    ``timeout_s``. The ranks import this module, torch and tpucg_torch, no
    jax."""
    import queue as queue_mod
    import time

    import torch.multiprocessing as tmp

    results = tmp.get_context("spawn").Queue()
    ctx = tmp.start_processes(_world_rank, args=(nprocs, rendezvous, target, args, results),
                              nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    out = None
    try:
        while True:
            try:  # drain while waiting: a rank exits only once its result is read
                out = results.get(timeout=0.2)
            except queue_mod.Empty:
                pass
            if ctx.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {nprocs} ranks outlasted {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    if out is None:
        out = results.get(timeout=30)
    return out


def _world_rank(rank, nprocs, rendezvous, target, args, results):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from tpucg_torch.comm.mesh import init_distributed

    init_distributed(init_method=f"file://{rendezvous}", world_size=nprocs, rank=rank,
                     backend="gloo")
    try:
        out = target(rank, nprocs, *args)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


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
}


def sharded_system(spec):
    """The NumPy system of a sharded case: a dict with ``A`` (dense) or
    ``op`` (the port's host container: ``("poisson", m)``, a DIAMatrix, a
    CSRMatrix for ELL, a BSRMatrix), ``b``, ``x0`` (or None), and ``x_true``
    where the case has one."""
    from tpucg_torch.io.generator import generate_spd_system, poisson3d_csr, poisson3d_dia
    from tpucg_torch.io.golden import GOLDEN_4X4
    from tpucg_torch.sparse.formats import COOMatrix, csr_to_bsr, csr_to_dia

    kind = spec[0]
    if kind == "generator":
        A, b, _ = generate_spd_system(spec[1], seed=spec[2])
        return {"A": A, "b": b, "x0": None}
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
        elif type(op).__name__ == "CSRMatrix":
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


def card_world_worker(rank, nprocs, cases, m, b_poisson, kw):
    """A rank of a gloo world on cuda:0 (``chip_smoke.py``): each case,
    ``("dense", strategy)`` on ``generate_spd_system(8192, seed=0)`` or
    ``("poisson", None)`` / ``("dia", None)`` on the m^3 Laplacian with
    ``b_poisson`` and ``kw`` (tol, maxiter), solved once to warm up and once
    timed on the host clock; rank 0's x, laps, ms, laps run, and the
    transport's calls and host seconds in the timed solve."""
    import time

    from tpucg_torch.comm.mesh import make_mesh
    from tpucg_torch.io.generator import generate_spd_system, poisson3d_dia
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
        else:
            op = PoissonOperator(m, device=dev) if kind == "poisson" else poisson3d_dia(m)

            def solve():
                return sharded_operator_cg_solve(op, b_poisson, mesh=mesh, **kw)
        solve()
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
