"""The port's compile-check and dry-run entry points: ``entry()`` and
``dryrun_multichip(n_ranks)``, the counterparts of tpucg's
``__graft_entry__.py``, and ``spawn_world``, the spawn of a gloo world of
ranks that the dry run (and the tests' worlds) run on.

``entry()`` gives the flagship dense CG solve, ``cg_loop`` over K1, K3 and
K2 on the card (their plain versions when the caller asks for the CPU), as a
function and its example arguments.

``dryrun_multichip(n_ranks)`` spawns a gloo world of ``n_ranks`` processes
(on ``cuda:0`` when the device is the card: NCCL refuses two ranks on one
card; on the CPU when asked) and runs tpucg's whole battery of sharded
solves on it, case for case with tpucg's systems, seeds and slack: every
solve runs to convergence and is held against the NumPy oracle (or the
float64 direct solution of an indefinite system). Rank 0 raises
``AssertionError`` with the case's label when a case misses its oracle, and
the world, hence the call, fails with it.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
from typing import Callable

import numpy as np
import torch


def spawn_world(nprocs: int, target: Callable, args=(), rendezvous: str = "",
                timeout_s: float = 600.0):
    """Run ``target(rank, nprocs, *args)`` in ``nprocs`` spawned processes,
    the ranks of one gloo world (``init_distributed`` through the file
    ``rendezvous``, which must not exist yet), and return rank 0's return
    value. ``target`` is a module-level function (the ranks import it). A
    rank that raises fails the world (the others are ended) and raises here
    with its traceback; so does a world that outlasts ``timeout_s``."""
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


def entry(device=None):
    """Returns ``(fn, example_args)``: the flagship dense CG solve (the
    generator's n = 1024 system, seed 0, tol 1e-6, at most n laps) as
    tpucg's ``entry()`` gives it. ``fn(A, b, x0)`` runs ``cg_loop`` on the
    device of its arguments, K1, K3 and K2 on the card and their plain
    versions on the CPU, and returns ``(x, k, ||r||)``. ``device`` defaults
    to the card, which raises when there is none."""
    from tpucg_torch.io.generator import generate_spd_system
    from tpucg_torch.kernels.dispatch import canonical_device

    device = canonical_device(device)
    n = 1024
    A, b, x0 = generate_spd_system(n, seed=0)

    def fn(A, b, x0):
        from tpucg_torch.kernels.dispatch import resolve_backend
        from tpucg_torch.solver.cg import cg_loop, lap_ops
        from tpucg_torch.solver.operators import DenseOperator

        backend = resolve_backend("auto", A.device)
        op = DenseOperator.create(A, backend=backend, device=A.device)
        tail = op.padded_n - b.shape[0]
        s = cg_loop(*lap_ops(op, backend), torch.nn.functional.pad(b, (0, tail)),
                    torch.nn.functional.pad(x0, (0, tail)), tol=1.0e-6, maxiter=b.shape[0])
        return s.x[: b.shape[0]], s.k, torch.sqrt(s.rslast)

    example_args = tuple(torch.as_tensor(v, dtype=torch.float32, device=device)
                         for v in (A, b, x0))
    return fn, example_args


def _check_parity(res, x_ref, k_ref, label, *, x_tol=1e-4, iter_slack=1):
    """A distributed solve agrees with the serial oracle (tpucg's
    ``_check_parity``): converged, laps within ``iter_slack`` of the
    oracle's, x within ``x_tol`` of max |x_ref|. An operator solve's x
    covers its padded rows: the first n are compared."""
    x = res.x.float().cpu().numpy()[: x_ref.shape[0]]
    assert x.shape == x_ref.shape, (label, x.shape, x_ref.shape)
    assert np.all(np.isfinite(x)), label
    assert bool(res.converged), (label, "did not converge")
    k = int(res.iterations)
    assert abs(k - k_ref) <= iter_slack, (label, k, k_ref)
    err = float(np.max(np.abs(x - x_ref)))
    scale = float(np.max(np.abs(x_ref))) + 1e-30
    assert err <= x_tol * scale, (label, err, scale)


def _check_close(x, x_ref, rel, label):
    """x (the first len(x_ref) rows) within ``rel`` of max |x_ref|."""
    x = x.float().cpu().numpy()[: x_ref.shape[0]]
    err = float(np.max(np.abs(x - x_ref)))
    assert err <= rel * (float(np.max(np.abs(x_ref))) + 1e-30), (label, err)


def _battery(rank: int, P: int, device: str, workdir: str) -> str:
    """One rank of ``dryrun_multichip``: tpucg's battery
    (``__graft_entry__.py:65-452``) on this world's mesh, with tpucg's
    systems, seeds, tolerances and slack; rank 0 checks each case. Returns
    the summary line."""
    import torch.distributed as dist

    from tpucg_torch.comm.mesh import make_mesh, make_mesh2d
    from tpucg_torch.config import CGConfig
    from tpucg_torch.io.generator import (
        generate_spd_system,
        poisson3d_csr,
        poisson3d_dia,
        random_geometric_spd,
    )
    from tpucg_torch.io.mmio import expand_matrix_market, save_matrix_market
    from tpucg_torch.solver.deflation import sharded_cg_solve_deflated
    from tpucg_torch.solver.minres import sharded_minres_solve
    from tpucg_torch.solver.operators import EllOperator, PoissonOperator
    from tpucg_torch.solver.oracle import oracle_cg
    from tpucg_torch.solver.sharded import (
        load_well_system_sharded,
        sharded_cg_solve,
        sharded_cg_solve_block,
        sharded_cg_solve_multi,
        sharded_operator_cg_solve,
    )
    from tpucg_torch.solver.twolevel import build_two_level
    from tpucg_torch.sparse.formats import DIAMatrix, csr_to_bsr

    checks = rank == 0

    def parity(res, x_ref, k_ref, label, **kw):
        if checks:
            _check_parity(res, x_ref, k_ref, label, **kw)

    def close(x, x_ref, rel, label):
        if checks:
            _check_close(x, x_ref, rel, label)

    def converged(res, label):
        if checks:
            assert bool(torch.as_tensor(res.converged).all()), (label, "did not converge")

    mesh = make_mesh(device=device, backend="gloo")
    dev = mesh.device
    n = max(16 * P, 64)
    A, b, x0 = generate_spd_system(n, seed=0)
    x_ref, k_ref, _ = oracle_cg(A, b, x0, tol=1.0e-6)
    configs = [
        CGConfig(strategy="allgather"),
        CGConfig(strategy="overlap"),
        CGConfig(strategy="allgather", method="pipelined"),
        CGConfig(strategy="overlap", precondition="jacobi"),
        CGConfig(strategy="allgather", precondition="block_jacobi", pc_block_size=8),
        CGConfig(strategy="allgather", method="ca", s_step=3),
        CGConfig(strategy="overlap", method="ca", s_step=3),
        # Non-minimizing and chunk-rounded: only its x is oracle-comparable.
        CGConfig(strategy="allgather", method="chebyshev", maxiter=2048),
    ]
    for cfg in configs:
        res = sharded_cg_solve(A, b, x0, mesh=mesh, config=cfg)
        if cfg.method == "chebyshev":
            slack = 2048
        elif (cfg.method, cfg.precondition) == ("cg", "none"):
            slack = 1
        else:
            slack = 3
        parity(res, x_ref, k_ref, (cfg.strategy, cfg.method, cfg.precondition),
               iter_slack=slack)

    # MINRES on a symmetric indefinite system, against the f64 direct solve.
    rng_m = np.random.default_rng(13)
    Qm, _ = np.linalg.qr(rng_m.standard_normal((n, n)))
    lam = np.concatenate([-(1.0 + rng_m.uniform(0, 1, n // 2)),
                          1.0 + rng_m.uniform(0, 1, n - n // 2)])
    Am = ((Qm * lam) @ Qm.T).astype(np.float32)
    Am = 0.5 * (Am + Am.T)
    bm = rng_m.standard_normal(n).astype(np.float32)
    tol_m = 1e-4 * float(np.linalg.norm(bm))
    res_m = sharded_minres_solve(Am, bm, mesh=mesh, tol=tol_m, maxiter=4 * n)
    converged(res_m, "minres")
    xm_ref = np.linalg.solve(Am.astype(np.float64), bm.astype(np.float64))
    close(res_m.x, xm_ref, 1e-2, "minres")

    # Deflated CG: one more rank sum of m values a lap.
    Vdefl = np.random.default_rng(7).standard_normal((n, 3)).astype(np.float32)
    res_d = sharded_cg_solve_deflated(A, b, Vdefl, x0=x0, mesh=mesh)
    parity(res_d, x_ref, k_ref, "deflated", iter_slack=3)

    # True block CG, plain and preconditioned (x only: the laps differ).
    Bblk = np.random.default_rng(11).standard_normal((n, 3)).astype(np.float32)
    xb_ref = [oracle_cg(A, Bblk[:, j], np.zeros(n, np.float32), tol=1.0e-6)[0]
              for j in range(Bblk.shape[1])]
    res_b = sharded_cg_solve_block(A, Bblk, mesh=mesh)
    converged(res_b, "block-cg")
    for j in range(Bblk.shape[1]):
        close(res_b.x[:, j], xb_ref[j], 1e-4, ("block-cg", j))
    for pcfg in (dict(precondition="jacobi"), dict(precondition="poly", poly_degree=2)):
        res_p = sharded_cg_solve_block(A, Bblk, mesh=mesh, **pcfg)
        converged(res_p, ("block-pcg", pcfg))
        for j in range(Bblk.shape[1]):
            close(res_p.x[:, j], xb_ref[j], 1e-3, ("block-pcg", pcfg, j))

    # bf16 storage, f32 sums: the bf16-rounded system, a looser x.
    tol_b = 1.0e-5 * float(np.linalg.norm(b))
    res = sharded_cg_solve(A, b, x0, mesh=mesh, tol=tol_b, storage_dtype=torch.bfloat16)
    parity(res, x_ref, k_ref, "bf16-storage", x_tol=1e-2, iter_slack=3)

    # The 2-D SUMMA decomposition (R x C = 2 x P/2) and its MINRES,
    # deflated, bf16, multi-RHS and block arms.
    if P % 2 == 0:
        mesh2 = make_mesh2d(2, P // 2, device=device, backend="gloo")
        parity(sharded_cg_solve(A, b, x0, mesh=mesh2, config=CGConfig()), x_ref, k_ref,
               "block2d")
        res_m2d = sharded_minres_solve(Am, bm, mesh=mesh2, tol=tol_m, maxiter=4 * n)
        converged(res_m2d, "minres-2d")
        close(res_m2d.x, xm_ref, 1e-2, "minres-2d")
        parity(sharded_cg_solve_deflated(A, b, Vdefl, x0=x0, mesh=mesh2), x_ref, k_ref,
               "deflated-2d", iter_slack=3)
        parity(sharded_cg_solve(A, b, x0, mesh=mesh2, tol=tol_b, storage_dtype=torch.bfloat16),
               x_ref, k_ref, "bf16-2d", x_tol=1e-2, iter_slack=3)
        res_m2 = sharded_cg_solve_multi(A, Bblk, mesh=mesh2)
        res_k2 = sharded_cg_solve_block(A, Bblk, mesh=mesh2, precondition="jacobi")
        converged(res_m2, "multi-2d")
        converged(res_k2, "block-2d")
        for j in range(Bblk.shape[1]):
            for tag, xs in (("multi-2d", res_m2.x), ("block-2d", res_k2.x)):
                close(xs[:, j], xb_ref[j], 1e-3, (tag, j))

    # Poisson on x-plane slabs with plane halos (K9), against the dense
    # oracle on the assembled CSR.
    m = 2 * P
    op = PoissonOperator(m=m, device=dev)
    bp = np.ones(m ** 3, np.float32)
    csr = poisson3d_csr(m)
    Ap_dense = csr.to_dense().astype(np.float32)
    tol_p = 1.0e-5 * float(np.linalg.norm(bp))
    xp_ref, kp_ref, _ = oracle_cg(Ap_dense, bp, np.zeros(m ** 3, np.float32), tol=tol_p)
    for cfg in (CGConfig(tol=tol_p), CGConfig(tol=tol_p, precondition="poly", poly_degree=2),
                # Blocks of 24 do not divide a rank's rows: the tail path.
                CGConfig(tol=tol_p, precondition="block_jacobi", pc_block_size=24)):
        parity(sharded_operator_cg_solve(op, bp, mesh=mesh, config=cfg), xp_ref, kp_ref,
               ("poisson-halo", cfg.precondition),
               iter_slack=1 if cfg.precondition == "none" else kp_ref)

    # Row-sharded ELL, band-halo DIA (K7) in f32 and bf16 (Poisson's values
    # are exact in bf16), and block-row BSR.
    parity(sharded_operator_cg_solve(EllOperator.from_csr(csr, device=dev), bp, mesh=mesh,
                                     config=CGConfig(tol=tol_p)), xp_ref, kp_ref, "ell-sharded")
    parity(sharded_operator_cg_solve(poisson3d_dia(m), bp, mesh=mesh, config=CGConfig(tol=tol_p)),
           xp_ref, kp_ref, "dia-sharded")
    parity(sharded_operator_cg_solve(csr_to_bsr(csr, 4), bp, mesh=mesh,
                                     config=CGConfig(tol=tol_p)), xp_ref, kp_ref, "bsr-sharded")
    parity(sharded_operator_cg_solve(poisson3d_dia(m), bp, mesh=mesh, config=CGConfig(tol=tol_p),
                                     storage_dtype=torch.bfloat16),
           xp_ref, kp_ref, "dia-sharded-bf16")

    # Operator MINRES: the band-halo DIA of an indefinite banded system (the
    # 1-D Laplacian shifted into its spectrum), Jacobi (1 / |d|).
    n_ind = max(128, 16 * P)
    dia_ind = DIAMatrix(data=np.stack([np.full(n_ind, -1.0, np.float32),
                                       np.full(n_ind, 2.0 - 1.7, np.float32),
                                       np.full(n_ind, -1.0, np.float32)]),
                        offsets=(-1, 0, 1), shape=(n_ind, n_ind))
    b_ind = np.random.default_rng(17).standard_normal(n_ind).astype(np.float32)
    res_im = sharded_minres_solve(dia_ind, b_ind, mesh=mesh,
                                  tol=1e-4 * float(np.linalg.norm(b_ind)), maxiter=8 * n_ind,
                                  precondition="jacobi")
    converged(res_im, "minres-dia")
    xi_ref = np.linalg.solve(dia_ind.to_dense().astype(np.float64), b_ind.astype(np.float64))
    close(res_im.x, xi_ref, 1e-2, "minres-dia")

    # Operator deflation: deflating with the exact solution starts on x*
    # (the Galerkin start, at most 2 laps).
    res_od = sharded_cg_solve_deflated(op, bp, xp_ref, mesh=mesh, config=CGConfig(tol=tol_p))
    if checks:
        assert bool(res_od.converged) and int(res_od.iterations) <= 2, (
            "deflated-poisson", int(res_od.iterations))
    parity(res_od, xp_ref, kp_ref, "deflated-poisson", iter_slack=kp_ref)

    # Row blocks of WELL (an irregular CSR, K13 on each rank's rows), the
    # two-level cycle on them (classic, pipelined, multilevel).
    Aw, bw, _ = random_geometric_spd(max(1200, 150 * P), seed=23, avg_degree=8.0)
    tol_w = 1e-5 * float(np.linalg.norm(bw))
    xw_ref, kw_ref, _ = oracle_cg(Aw.to_dense().astype(np.float32), bw,
                                  np.zeros(Aw.shape[0], np.float32), tol=tol_w)
    parity(sharded_operator_cg_solve(Aw, bw, mesh=mesh, config=CGConfig(tol=tol_w)), xw_ref,
           kw_ref, "well-sharded")
    npad_w = -(-Aw.shape[0] // (128 * P)) * (128 * P)
    tl_w = build_two_level(Aw, agg_size=64, npad=npad_w, device=dev)
    parity(sharded_operator_cg_solve(Aw, bw, mesh=mesh, config=CGConfig(tol=tol_w),
                                     two_level=tl_w), xw_ref, kw_ref, "well-two-level",
           iter_slack=kw_ref)
    parity(sharded_operator_cg_solve(Aw, bw, mesh=mesh,
                                     config=CGConfig(tol=tol_w, method="pipelined"),
                                     two_level=tl_w), xw_ref, kw_ref,
           "well-two-level-pipelined", iter_slack=kw_ref)
    tl_ml = build_two_level(Aw, agg_size=2, npad=npad_w, coarse_max=8, device=dev)
    if checks:
        assert tl_ml.levels >= 2, ("well-multilevel", tl_ml.levels)
    parity(sharded_operator_cg_solve(Aw, bw, mesh=mesh, config=CGConfig(tol=tol_w),
                                     two_level=tl_ml), xw_ref, kw_ref, "well-multilevel",
           iter_slack=kw_ref)

    # Host-sharded .mtx loading: rank 0 writes the indexed general file,
    # then every rank reads only its rows and builds its part of the cycle.
    sym, gen, pb = (os.path.join(workdir, f) for f in ("A_sym.mtx", "A.mtx", "b.npy"))
    if rank == 0:
        save_matrix_market(sym, Aw.to_coo(), symmetric=True)
        expand_matrix_market(sym, gen)
        np.save(pb, bw)
    dist.barrier()
    sys_mtx = load_well_system_sharded(gen, pb, mesh=mesh, two_level_agg=64)
    parity(sharded_operator_cg_solve(sys_mtx, mesh=mesh, config=CGConfig(tol=tol_w),
                                     two_level=sys_mtx.two_level), xw_ref, kw_ref,
           "well-host-sharded-mtx", iter_slack=kw_ref)

    # Operator multi-RHS and block CG on the band-halo DIA.
    Bop = np.random.default_rng(19).standard_normal((m ** 3, 2)).astype(np.float32)
    res_m2 = sharded_cg_solve_multi(poisson3d_dia(m), Bop, mesh=mesh, tol=tol_p)
    res_b2 = sharded_cg_solve_block(poisson3d_dia(m), Bop, mesh=mesh, tol=tol_p,
                                    precondition="jacobi")
    converged(res_m2, "multi-dia")
    converged(res_b2, "block-dia")
    for j in range(2):
        xj_ref = oracle_cg(Ap_dense, Bop[:, j], np.zeros(m ** 3, np.float32), tol=tol_p)[0]
        for tag, xs in (("multi-dia", res_m2.x), ("block-dia", res_b2.x)):
            close(xs[:, j], xj_ref, 1e-3, (tag, j))

    # A Poisson grid whose planes do not divide over the ranks: the padded
    # planes are an identity block.
    m_odd = 2 * P + 1
    b_odd = np.ones(m_odd ** 3, np.float32)
    tol_odd = 1.0e-5 * float(np.linalg.norm(b_odd))
    xo_ref, ko_ref, _ = oracle_cg(poisson3d_csr(m_odd).to_dense().astype(np.float32), b_odd,
                                  np.zeros(m_odd ** 3, np.float32), tol=tol_odd)
    parity(sharded_operator_cg_solve(PoissonOperator(m=m_odd, device=dev), b_odd, mesh=mesh,
                                     config=CGConfig(tol=tol_odd)), xo_ref, ko_ref,
           "poisson-padded")
    return (f"dryrun_multichip OK: {P} ranks on {dev} (gloo), n={n}, strategies x methods x "
            "preconditioners + block2d (+minres/deflated/bf16/multi/block) + poisson-halo + "
            "ell/dia/bsr/WELL-sharded (+bf16 dia) + two-level/multilevel + host-sharded .mtx + "
            "padded-grid + operator minres/deflated/multi/block: every case held to its oracle")


def dryrun_multichip(n_ranks: int, device=None) -> str:
    """Run tpucg's dry-run battery (``__graft_entry__.py:65``) on a gloo
    world of ``n_ranks`` spawned processes: on ``cuda:0`` when ``device`` is
    the card (the default, which raises when there is none), on the CPU
    when asked. Raises the failing rank's error (an ``AssertionError``
    naming the case) when a case misses its oracle; returns and prints the
    summary line."""
    from tpucg_torch.kernels.dispatch import canonical_device

    device = canonical_device(device)
    with tempfile.TemporaryDirectory() as d:
        line = spawn_world(n_ranks, _battery, args=(str(device), d),
                           rendezvous=os.path.join(d, "rendezvous"))
    print(line)
    return line
