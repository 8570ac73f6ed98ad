#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpucg_torch``) once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: CUDA is required; prints the card, torch and CUDA versions and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build: compiles the kernel library from ``tpucg_torch/kernels/csrc``.
3. kernels: K1 (GEMV, f32 and bf16 A), K2 (fused update) and K3 (dot)
   against their plain PyTorch versions on the card, at the main path's
   shapes, with the tolerances printed; repeat launches are bit-identical.
   K2 and K3 (one launch each) equal the NumPy emulation of their order
   (``tests/_torch_helpers.py`` ``fused_update_emulated``, ``dot_emulated``)
   bit for bit, K3's alpha mode too; p's update equals its plain version.
4. goldens: the reference's 2x2 and 4x4 systems in 2 and 4 laps through
   the lap path (``fused="never"``).
5. flagship: the dense n=8192 system of the reference's benchmark through
   ``DenseOperator`` and ``cg_solve`` on the card, at the NumPy oracle's lap
   count; the kernels' launch counters advance and the plain versions' do
   not. Then n=16384. Then the lap route's device ops a lap at n=8192
   (none, jacobi, poly): two capped solves 32 laps apart, profiled; kernel
   launches and device ops a lap, the busy share, the lap's kernels by
   name. Without a preconditioner a lap is at most 4 launches, all this
   package's kernels (no torch op).
6. times: the n=8192 solve and each kernel beside its plain version, with
   the card's name and power limit; K2 and K3 through their launch cores
   (K2 alone and with the lap's tail and p's update, K3 alone and in alpha
   mode) and ``torch.dot``.
7. whole-solve K4: ``cg_solve(fused="always")`` at n=1000, 2048 and 4096
   with precondition none, jacobi and poly runs one K4 launch and nothing
   else, at the plain version's lap count (and the oracle's for none), x
   within a bound scaled to x of the plain version's, repeats
   bit-identical; at each n the plan (``dense_resident_plan``: A's rows in
   shared memory and L2), µs a lap (the slope of the queued device time
   between tol = 0 runs of 8 and 40 laps) and the solve's wrapper time
   beside its queued device time; the
   goldens in 2 and 4 laps through K4; the crossover table of K4 against
   the lap path, n = 128 ... 4096, medians of 7 solves, each arm run twice
   in turns.
8. batched K5: ``cg_solve_batch`` of 64 systems at n=1000, 16 at n=2048
   and 256 at n=512 (circulant only), none and jacobi, runs one K5 launch
   and nothing else; repeats, and K5 forced onto clusters of 1, 2, 4 and 8
   blocks a system, are bit-identical to the plan's cluster
   (``batch_cluster_plan``); the last system starts at an exact x0 and
   stops at k=0. K5 is timed at the three shapes (circulant, none) at the
   plan's cluster and at each forced one, beside the streaming floor (A
   re-read by every matvec at the HBM peak) and the table's bound (A read
   once). Two batches (``tests/_torch_helpers.py``): ``circulant_spd_batch``
   at tol 1e-2, whose lap counts (1 to 6) are set by the spectra, must
   match the plain version's system for system; ``shifted_spd_batch`` at
   tol 1e-6, each system from its own seed and shift, stops where the
   rounding of r is of the order of tol, so K5 and its plain version may
   stop one lap apart: for every system that does, r.r / tol^2 at the two
   laps around the split is printed from K5, the plain version and a
   float64 solve. x is held within a bound scaled to x in both.

9. sparse kernels vs plain: K6 (DIA SpMV) in f32 and bf16 on the m=128
   Poisson Laplacian in DIA form and on a cross-row band at n=2^20, and K8
   (7-point stencil, the 2.5-D march) at m=128, 100 and 2, each bit-identical
   to its plain version and to its own repeat; µs per launch (device time of
   calls queued behind a spin kernel, ``bench.timing.device_timing``:
   back-to-back wrapper calls are host-bound at these sizes) against the
   bound (bytes at the HBM peak) and a torch CSR sparse product; K8 also
   with its march plan (``stencil_march_plan``: tile, grid, ratio of u's
   reads) and cold (rotating over 8 copies of u, more than L2 holds).
10. Poisson m=128: tpucg's sparse flagship (``bench --operator
   poisson-free|poisson-dia``) through ``cg_solve`` on the stencil operator
   and on DIA in f32 and bf16: the default route (K10 / K11 in one launch,
   nothing else), ``fused="never"`` (K8 / K6 with K2 and K3, no plain
   version), ``kernel="torch"`` (the plain route on the card, no kernel),
   jacobi on DIA and poly (degree 3) on both; every solve converges with a
   float64 true residual ||b - A x|| / ||b|| <= 2e-5 and within a lap of the
   plain route; times per solve. K10 and K11 (rows in tiles dealt to the
   blocks in turn, the matvec's input staged once per element in shared
   memory) at m = 128 f32 without a preconditioner take 71 laps. K10's line
   (``bench.k10_lap``) gives µs a lap, the lap's vector bytes at the HBM peak
   and their share, the tile (T, H, the window), the grid, the shared bytes
   and K8's µs a launch; K11's lines (``bench.k11_lap``) the same with the
   slab's µs a lap at the HBM peak and K6's µs a launch, f32 and bf16. Then
   the gate table:
   ``fused="always"`` against ``"never"`` at m = 16 ... 192 (stencil) and
   32 ... 160 (DIA f32 and bf16), medians of 5, each arm twice in turns.
11. whole-solve K10/K11 vs plain at m = 16, 32, 33, 64 with a nonzero x0
   (m = 32 stages the +-m^2 neighbours in shared memory, m = 33 reads them
   through L2), and
   K11 on a band with far offsets (+-40,000 at n = 100,000, read through L2
   beside the staged +-1), f32 and bf16: laps within one, x within 1e-4 of
   max |x|, repeats bit-identical.
12. irregular K13 vs plain: tpucg's WELL packing of the P1 FEM stiffness
   matrix (``fem_p1_system(300_000, seed=0)``, mesh order), the random
   geometric graph Laplacian (``random_geometric_spd(1_000_000, seed=0,
   avg_degree=12.0)``) and an SPD arrowhead of n = 5000 (its first row longer
   than a tile), values f32 and bf16: the operator's layout (live slots,
   tiles, slots a tile, the longest row, its set-up seconds); K13
   bit-identical to its plain version, to its repeat, to itself with the
   layout built by the wrapper and through the operator's launch core, the
   K14 name the same; µs per launch of the launch core (``device_timing``)
   against the recounted bound (the function's bytes) and the torch CSR
   product timed in the same call; for FEM and geometric f32, µs by tile.
13. FEM .mtx solve: the FEM system written to .mtx and solved through
   ``cli.main(["solve", A.mtx, b.mtx, "--precondition", "jacobi", ...])``
   at tol 1e-5 ||b||: ``best_sparse_operator`` picks ``WellOperator``, K13,
   K2 and K3 run and no plain version; it converges in 1,720 laps, its
   float64 ||b - A x|| / ||b|| is within the bound PERF.md states, its laps
   within 1% of the plain route's on the card; the median of 3 solves, the
   busy share of a profiled 200-lap window and the load, promotion and
   packing seconds.
14. batched banded K12: tpucg's battery of 256 tridiagonal systems of n =
   1024 through ``cg_solve_batch_banded``, none and jacobi, f32 and bf16
   slabs, one K12 launch each; K12 against its plain version (laps within
   one, x within 1e-4 of max |x|, repeats bit-identical) and laps equal on
   a battery whose spectra set them; ms per battery (wrapper, and queued
   device time) against the plain loop, with the plan
   (``batch_dia_warps_plan``); then K12 on 8 x 256, f32 and bf16, none and
   jacobi, at the plan's W and forced to W = 4 and 8: x, k and r.r equal
   bit for bit to its NumPy emulation (``tests/_torch_helpers.py``
   ``batch_dia_cg_emulated``).

15. halo kernels vs plain: K9 (the stencil on a slab with halo planes) at
   m=128 on slabs of mp = 128, 64 and 32 planes (1, 2 and 4 ranks), halos
   cut from a random global u, and K7 (the DIA SpMV on a row block with
   band halos) on the m=128 Poisson slab, f32 and bf16, in 1, 2 and 4
   blocks: each bit-identical to its plain version and to its repeat, the
   blocks concatenated bit-identical to K8 / K6 on the whole; µs per launch
   (``device_timing``) against the bound and a torch CSR product on the
   block with the halos as extra columns; K9 also cold (8 copies of its
   operands) and with its march plan.
16. sharded, one rank (NCCL): a world of one rank on the card runs
   ``sharded_cg_solve`` on the dense n=8192 system with ``allgather`` and
   ``overlap`` (the oracle's 4 laps) and ``sharded_operator_cg_solve`` on
   Poisson m=128 (K9) and its DIA form in f32 (K7), 71 laps: each equal to
   the serial lap path (``fused="never"``) bit for bit in x and in laps;
   K1/K9/K7 with K2 and K3 launched, no plain version; ms per solve (CUDA
   events) beside the serial lap path's, the host µs of a transport call,
   the operator solves' set-up, and one profiled solve of each route.
17. sharded, 2 and 4 ranks on one card (gloo): spawned ranks on cuda:0 (gloo
   on a card copies point-to-point buffers through pinned host memory) run
   the dense n=8192 system (2 ranks, both strategies) and Poisson and DIA
   m=128 (2 and 4 ranks): laps within one of the one-rank solve, x within
   1e-4 of max |x|, Poisson's float64 ||b - A x|| / ||b|| <= 2e-5; the
   host seconds a lap spends in the transport. A failed rank fails the
   phase.
18. gather probes vs plain: the seven probes of ``benchmarks/probe_gather.py``
   (P1-P7, ``tpucg_torch.bench.probe_gather``) on the script's inputs
   (``probe_inputs(0)``), each driven once through its dispatcher with the
   counts at 0 (its kernel launched once, nothing else), bit-identical to
   its plain version and to its repeat, P6 also at shifts 5, 0, 127, 128,
   300, -3, -2^31 and 2^31 - 1 (and equal to ``torch.roll``); µs per
   launch (``device_timing``) against the bound, the plain version and the
   library call. P7 (P1's kernel over 8192 rows) is timed cold, rotating
   over 8 input sets (96 MB), and its rate must stay under the HBM peak; on
   one set it stays in L2 and is printed as the L2-resident rate. Then the
   script's two XLA baselines as library rates, each beside the probe's
   kernel at that shape (P3 at 2048 rows, P4 at 2048 x 128 elements, each
   bit-identical to plain first), the plans of every probe's kernel
   (``lane_gather_plan``, ``sub_gather_plan``: direct at the script's shape
   and at a 16,384-row v, staged at 8192 idx rows of a 2048-row v;
   ``elem_gather_plan`` at the script's shape, the baseline's and its
   first streamed size; ``dynslice_plan``), P1/P7's kernel at 13 row counts from
   1 to 65,536 (random lanes, and every lane 0 or 127), P2's at 9 heights of
   v on both sides of the staged form's cap x 9 counts of idx rows (random
   rows, and every row 0 or the last), P5's at 1 ... 1,024 windows
   (overlapping, the table's last window), P6's at 8 row counts x 11 shifts
   (to the ends of int32, also against ``torch.roll``), P3's at 10 row
   counts from 1 to 8,192 and P4's at 10 element counts from 1 to 262,144
   and on both sides of its first streamed size (random indices, and every
   index 0 or the table's last), each bit-identical to its plain version
   and to its repeat (``bench.probe_gather.edge_checks``, with the walks
   P4 took), P4 at FEM 300k's 5.4 M CSR column indices (the streaming
   walk; ``bench.probe_gather.fem_check``), and one launch's floor: a
   one-element ``fill_`` queued the same way, beside each launch-bound
   probe's time over it.

19. M8: tpucg's pipelined, CA and Chebyshev methods and block Jacobi on
   the lap kernels (no new kernel: their matvecs are K1, K8 or K13 and
   their dots K3, block-Jacobi PCG adds K2 and p's update), each solve
   driven once with the counts at 0 (its kernels launched, no plain
   version), held to the same method on the plain backend on the card
   (laps within a lap, a CA block or a Chebyshev check; x within 1e-4 of
   max |x|) and timed (ms a solve, median of 5 by CUDA events) beside
   its plain route and the classic lap route on the same system, with
   its kernel launches a lap: dense n = 8192 pipelined (tol 1e-6 ||b||),
   ca (s = 3), chebyshev and cg + block_jacobi (bs = 64) at tol 1e-6;
   Poisson m = 128 pipelined (true residual <= 2e-4: no replacement),
   pipelined + jacobi, chebyshev on one ``spectral_interval`` reused and
   cg + block_jacobi, each at tol 1e-5 ||b|| with its float64 true
   residual <= 2e-5; the FEM 300k ``.mtx`` through ``cli.main(["solve",
   ..., "--precondition", "block_jacobi"])``: promoted to WELL with its
   blocks, K13, K2 and K3, its true residual within the FEM bound, laps
   within 1% of the plain route's, timed beside the Jacobi lap route.

20. M9: the k-column kernels K6 x k (DIA, Poisson m = 128), K8 x k (m =
   128, and m = 2 and 33 for the edges) and K13 x k (FEM 300k, geometric
   100k) at k = 1, 3, 8 and 32, each bit-identical to its plain k-column
   version, to its repeat and, column by column, to the single-column
   kernel; µs a launch (queued) beside k single-column launches, the plain
   version, the bound and (k = 8) a torch CSR product on the block. Then
   ``cg_solve_multi`` at k = 8 on dense n = 8192 (none, jacobi; tol 1e-6),
   Poisson m = 128 as a stencil and as DIA and the geometric 100k graph on
   WELL (tol 1e-5 ||B[:, 0]||), each column within a lap of the port's
   single-vector solve and x within 1e-4 of max |x| of it, the k-column
   kernel launched and no plain version; ``cg_solve_block`` at k = 8 on
   dense n = 8192, Poisson m = 128 (none, poly) and geometric 100k, every
   column converged with its float64 true residual within 2 tol (4 tol
   under poly: the weighted norm's contract), the block laps beside
   multi's, and the duplicate-column and zero-column blocks finite;
   ``cg_solve_ir`` on tpucg's conditioned n = 8192 system (tol 1e-5
   ||b||): converged below tol on the true f32 residual, K1 launched with
   bf16 A and with f32 A, its rounds and inner laps (``ir_loop`` run
   directly, equal to the entry point's) beside a plain f32 solve; f64 on
   dense n = 8192 (tol 1e-12) and Poisson m = 128: x float64 on the card,
   its residual below the f32 solve's, no kernel launched, and
   ``kernel="cuda"`` with f64 raising. Times: ms a solve, CUDA events.

21. M12: the guarded finish of K3 and K2 (alpha 0 unless p.Ap > 0; a tail
   whose rs_new is not > 0 steps with beta 0 and rsold FLT_MIN), K3's alpha
   with p.Ap > 0, == 0, < 0 and NaN, K3's tail with r.z > 0, == 0, < 0 and
   K2's with r'.r' > 0 and == 0, each bit-identical to its NumPy emulation
   (``tests/_torch_helpers.py`` ``alpha_emulated``, ``lap_tail_emulated``),
   its plain version and its repeat, and the launch cores' µs guarded and
   unguarded (``bench.lap_ab.lap_cases``); two-level PCG on FEM 300k (mesh
   order, WELL, agg 64, tol 1e-3 ||b||) through ``cli.main(["solve", ...,
   "--two-level", "64"])`` with ``--smooth-degree 2`` and with
   ``--coarse-max 256`` (multilevel), and pipelined through ``cg_solve``
   (pipelined CG has no true-residual check, and below FEM 300k's f32 floor
   its recurrence drifts: its run there is shown, not held, and it is held
   on the geometric 100k graph at 1e-5 ||b||, tpucg's pipelined two-level
   family):
   laps (a multiple of 16 for classic PCG, which stops on the true residual
   every 16 laps), converged or stagnation-stopped, the float64 true
   residual within the FEM bound, K13, K3 and K2 launched and no plain
   version, the plain route's laps within 16, ``build_two_level``'s host
   seconds and ms a solve (median of 3) beside the Jacobi lap route at 1e-5
   and 1e-3 ||b||; ``cg_solve_deflated`` on a clustered dense n = 4096
   system (eigenvalues 0.01, 0.02, 0.03 under a [1, 2] bulk, built on the
   card) with its three slow eigenvectors, fewer laps than the plain solve;
   ``RecyclingCG`` on FEM 300k with the Chebyshev-smoothed two-level over 4
   right-hand sides of a smooth sequence, K13 x k building the basis; MINRES
   on the dense indefinite n = 4096 system, its badly scaled form with
   Jacobi and block Jacobi, and the staggered-sign band in DIA form at n =
   262,144 (K6), each converged, its laps within 1% of the plain route's.

The line before last is a JSON object of the kernels (K1-K14, K6xk, K8xk,
K13xk and P1-P7:
launches on the main path, error against the plain version, times, the
bound and the library call's time); the last line is ``{"ok": true,
"device": {...}}``. Any failure exits non-zero without it, as does a
machine without CUDA or a directory without the package.
"""

import contextlib
import dataclasses
import io
import json
import re
import sys
import tempfile
import time
from pathlib import Path


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== {name}: FAILED", flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.2f} s)", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import tpucg_torch

    # The kernels must be built from this checkout's sources, not from a
    # copy of the package found elsewhere on the path.
    pkg_root = Path(tpucg_torch.__file__).resolve().parents[1]
    if pkg_root != Path(__file__).resolve().parent:
        print(f"chip_smoke: tpucg_torch comes from {pkg_root}, not this checkout",
              file=sys.stderr)
        return 1

    # The batch generators of the tests (no counterpart in the package).
    sys.path.insert(0, str(pkg_root / "tests"))
    from _torch_helpers import (
        circulant_spd_batch,
        padded_batch,
        scaled_err,
        shifted_spd_batch,
    )

    from _torch_helpers import (
        alpha_emulated,
        lap_tail_emulated,
        BAND_SETS,
        batch_dia_cg_emulated,
        dot_emulated,
        fused_update_emulated,
        FAR_BAND,
        FAR_BAND_N,
        arrowhead_spd,
        banded_battery,
        banded_spectrum_battery,
        card_world_worker,
        random_banded_dia,
        run_world,
    )

    from tpucg_torch.bench import k4_resident, k10_lap, k11_lap
    from tpucg_torch.bench.lap_ab import CASES as LAP_CASES, LapOperands, lap_cases
    from tpucg_torch.kernels import blas1 as blas1_module
    from tpucg_torch.bench.k8_march import cold_seconds as stencil_cold_seconds
    from tpucg_torch.bench import probe_gather as pg
    from tpucg_torch.bench.timing import (
        csr_spmv_bytes,
        device_seconds_per_call,
        dia_spmv_bytes,
        gemv_bytes,
        hbm_peak_bytes_per_s,
        nvidia_smi_card,
        poisson_nnz,
        rate_line,
        stencil_bytes,
        time_fn,
        trace_calls,
        well_spmv_bytes,
    )
    from tpucg_torch import cli
    from tpucg_torch.io.generator import (
        fem_p1_system,
        generate_spd_system,
        generate_spd_system_f32,
        poisson3d_dia,
        random_geometric_spd,
    )
    from tpucg_torch.io.mmio import load_matrix_market, save_matrix_market
    from tpucg_torch.io.textio import load_vector
    from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
    from tpucg_torch.kernels import _lib
    from tpucg_torch.kernels.blas1 import (
        alpha_torch,
        CudaLapTail,
        dot_alpha_cuda,
        dot_alpha_torch,
        dot_alpha_launch,
        dot_cuda,
        dot_launch,
        dot_tail_launch,
        dot_torch,
        fused_update_cuda,
        fused_update_launch,
        fused_update_tail_launch,
        fused_update_torch,
        lap_tail_torch,
        LapTail,
        p_update_cuda,
        p_update_launch,
        p_update_torch,
        scratch_for,
    )
    from tpucg_torch.kernels.dispatch import cuda_stream
    from tpucg_torch.kernels.dispatch import strict_f32
    from tpucg_torch.kernels.fused import (
        FUSED_AUTO_MAX_N,
        FUSED_DIA_AUTO_MAX_N,
        FUSED_STENCIL_AUTO_MAX_M,
        batch_cluster_plan,
        batch_dia_warps_plan,
        dense_resident_plan,
        dia_tile_plan,
        fused_batch_cg_solve_cuda,
        fused_batch_clusters,
        fused_batch_dia_cg_solve_cuda,
        fused_cg_solve_cuda,
        fused_dia_cg_solve_cuda,
        fused_stencil_cg_solve_cuda,
    )
    from tpucg_torch.kernels.gather_spmv import (
        well_rows,
        well_spmv_cuda,
        well_spmv_fused_gather,
        well_spmv_multi_cuda,
        well_spmv_multi_torch,
        well_spmv_torch,
    )
    from tpucg_torch.kernels.matvec import matvec_cuda, matvec_torch
    from tpucg_torch.kernels.spmv import (
        dia_spmv_cuda,
        dia_spmv_halo_cuda,
        dia_spmv_halo_torch,
        dia_spmv_multi_cuda,
        dia_spmv_multi_torch,
        dia_spmv_torch,
        halo_length,
    )
    from tpucg_torch.kernels.stencil import (
        poisson3d_cuda,
        poisson3d_multi_cuda,
        poisson3d_multi_torch,
        poisson3d_slab_cuda,
        poisson3d_slab_torch,
        poisson3d_torch,
        stencil_march_plan,
    )
    from tpucg_torch.solver.cg import (
        batch_cg_loop,
        batch_matvec,
        cg_loop,
        cg_solve,
        cg_solve_batch,
        cg_solve_batch_banded,
        cg_solve_block,
        cg_solve_multi,
        lap_ops,
        spectral_interval,
    )
    from tpucg_torch.solver.deflation import RecyclingCG, cg_solve_deflated
    from tpucg_torch.solver.ir import cg_solve_ir, ir_loop
    from tpucg_torch.solver.minres import minres_solve
    from tpucg_torch.solver.twolevel import build_two_level
    from tpucg_torch.solver.fused import (
        fused_batch_cg_solve_torch,
        fused_batch_dia_cg_solve_torch,
        fused_cg_solve_torch,
        fused_dia_cg_solve_torch,
        fused_stencil_cg_solve_torch,
    )
    from tpucg_torch.solver.operators import (
        DenseOperator,
        DiaOperator,
        PoissonOperator,
        WellOperator,
        best_sparse_operator,
    )
    from tpucg_torch.solver.oracle import oracle_cg
    from tpucg_torch.solver.sharded import (
        distribute_system,
        sharded_cg_solve,
        sharded_operator_cg_solve,
    )
    from tpucg_torch.sparse.formats import DIAMatrix
    from tpucg_torch.sparse.well import csr_to_well
    from tpucg_torch.comm.mesh import init_distributed, make_mesh

    wrappers = (matvec_cuda, matvec_torch, dot_cuda, dot_torch, dot_alpha_torch,
                fused_update_cuda, fused_update_torch, p_update_cuda, p_update_torch,
                lap_tail_torch, dia_spmv_cuda, dia_spmv_torch,
                poisson3d_cuda, poisson3d_torch, well_spmv_cuda, well_spmv_torch,
                dia_spmv_halo_cuda, dia_spmv_halo_torch, poisson3d_slab_cuda,
                poisson3d_slab_torch, dia_spmv_multi_cuda, dia_spmv_multi_torch,
                poisson3d_multi_cuda, poisson3d_multi_torch, well_spmv_multi_cuda,
                well_spmv_multi_torch) + tuple(dict.fromkeys(
        w for p in pg.PROBES for w in (getattr(pg.kp, p.kernel), p.plain)))
    whole = (fused_cg_solve_cuda, fused_cg_solve_torch, fused_batch_cg_solve_cuda,
             fused_batch_cg_solve_torch, fused_stencil_cg_solve_cuda,
             fused_stencil_cg_solve_torch, fused_dia_cg_solve_cuda, fused_dia_cg_solve_torch,
             fused_batch_dia_cg_solve_cuda, fused_batch_dia_cg_solve_torch)

    def drive(fn):
        """Run one main-path call with every launch count at 0 just before
        it; returns its result and the counts just after."""
        torch.cuda.synchronize()
        for w in wrappers + whole:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {w.__name__: w.launches for w in wrappers + whole}

    def only(launched, name):
        """The counts show one launch of `name` and none of anything else."""
        return all(c == (1 if w == name else 0) for w, c in launched.items())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_f32()  # the plain references run in full f32, no TF32

    with phase("device"):
        name = torch.cuda.get_device_name(0)
        card = nvidia_smi_card()
        peak = hbm_peak_bytes_per_s(name)
        print(f"device: {name} (count {torch.cuda.device_count()})")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(card)
        print(f"HBM peak on record: {peak / 1e12:.2f} TB/s")
    tag = f"[{card}]"

    with phase("build"):
        t0 = time.perf_counter()
        fresh = not _lib.library_path().exists()
        path = _lib.build()
        _lib.load()
        print(f"kernel library {path} ({'compiled' if fresh else 'cached'}) "
              f"in {time.perf_counter() - t0:.2f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print("  " + line.strip())

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {}

    def rnd(*shape):
        return 2 * torch.rand(shape, generator=gen, device=dev) - 1

    with phase("kernels vs plain"):
        # K1: |y - y_plain| <= 1e-5 * max(|A| |x|) (f32 sums in two orders).
        ragged = DenseOperator.create(generate_spd_system(1000, seed=0)[0], device=dev).A
        cases = [("8192x8192", rnd(8192, 8192)), ("1024x8192", rnd(1024, 8192)),
                 ("16384x16384", rnd(16384, 16384)), ("n=1000 padded 1024", ragged)]
        for label, A32 in cases:
            x = rnd(A32.shape[1])
            for A in (A32, A32.to(torch.bfloat16)):
                y = matvec_cuda(A, x)
                y_ref = matvec_torch(A, x)
                scale = float((A.float().abs() @ x.abs()).max())
                e = float((y - y_ref).abs().max())
                require(e <= 1e-5 * scale, f"K1 {label} {A.dtype}: err {e} scale {scale}")
                require(torch.equal(y, matvec_cuda(A, x)), f"K1 {label} repeat")
                print(f"K1 {label} {A.dtype}: max abs err {e:.3e} (tol {1e-5 * scale:.3e}), "
                      "repeat bit-identical")
                if label == "8192x8192" and A.dtype == torch.float32:
                    err["K1"] = e
        # K2 and K3 (one launch each) against the NumPy emulation of their
        # order (tests/_torch_helpers.py), bit for bit, and against the plain
        # versions (f32 sums in two orders; one FMA rounding against two).
        for n in (8192, 16384):
            vs = [np.random.default_rng(n + s).standard_normal(n).astype(np.float32)
                  for s in range(4)]
            x, r, p, ap = (torch.from_numpy(v).to(dev) for v in vs)
            a32 = np.float32(0.37)
            alpha = torch.tensor(a32, device=dev)
            xo, ro, rr_k = fused_update_cuda(x, r, p, ap, alpha)
            emu = fused_update_emulated(*vs, a32)
            require(all(np.array_equal(t.cpu().numpy().view(np.int32),
                                       np.asarray(e, np.float32).view(np.int32))
                        for t, e in zip((xo, ro, rr_k), emu)),
                    f"K2 n={n}: differs from the emulation of its order")
            xr, rr, beta_r = fused_update_torch(x, r, p, ap, alpha)
            ex = float((xo - xr).abs().max())
            er = float((ro - rr).abs().max())
            eb = abs(float(rr_k) - float(beta_r))
            require(torch.allclose(xo, xr, rtol=1e-5, atol=1e-6), f"K2 x' n={n}: {ex}")
            require(torch.allclose(ro, rr, rtol=1e-5, atol=1e-6), f"K2 r' n={n}: {er}")
            require(eb <= 1e-5 * float(beta_r), f"K2 r'.r' n={n}: {eb}")
            again = fused_update_cuda(x, r, p, ap, alpha)
            require(all(torch.equal(a, b) for a, b in zip((xo, ro, rr_k), again)),
                    f"K2 n={n} repeat")
            d = dot_cuda(p, ap)
            d_emu = dot_emulated(vs[2], vs[3])
            require(np.float32(float(d)).view(np.int32) == d_emu.view(np.int32),
                    f"K3 n={n}: {float(d)!r} against the emulation's {float(d_emu)!r}")
            rsold = torch.tensor(2.5, device=dev)
            pap, al = dot_alpha_cuda(p, ap, rsold)
            pap_p, al_p = dot_alpha_torch(p, ap, rsold)
            require(torch.equal(pap, d) and float(al) == float(np.float32(2.5) / d_emu),
                    f"K3 alpha n={n}: {float(al)!r}")
            d_ref = dot_torch(p, ap)
            ed = abs(float(d) - float(d_ref))
            scale = float(torch.dot(p.abs(), ap.abs()))
            require(ed <= 1e-5 * scale, f"K3 n={n}: {ed} scale {scale}")
            require(abs(float(al) - float(al_p)) <= 1e-5 * abs(float(al_p)), f"alpha n={n}")
            require(torch.equal(d, dot_cuda(p, ap)), f"K3 n={n} repeat")
            beta = torch.tensor(0.61, device=dev)
            step = torch.ones((), dtype=torch.int32, device=dev)
            pp = p_update_cuda(r, p.clone(), beta, step)
            require(torch.equal(pp, p_update_torch(r, p, beta, torch.tensor(True, device=dev)))
                    and int(step) == 0, f"p update n={n}: differs from plain or kept its flag")
            print(f"K2 n={n}: x', r', r'.r' bit-identical to the emulation of its order; "
                  f"against plain: max abs err x' {ex:.3e} r' {er:.3e} r'.r' {eb:.3e} (rtol "
                  "1e-5, atol 1e-6; r'.r' rtol 1e-5), repeat bit-identical")
            print(f"K3 n={n}: bit-identical to the emulation (alpha mode too); against plain "
                  f"abs err {ed:.3e} (tol {1e-5 * scale:.3e}), repeat bit-identical; p update "
                  "bit-identical to plain, its flag cleared")
            if n == 8192:
                err["K2"] = max(ex, er, eb)
                err["K3"] = ed

    with phase("goldens"):
        for label, g in (("2x2", GOLDEN_2X2), ("4x4", GOLDEN_4X4)):
            before = matvec_cuda.launches
            res = cg_solve(g["A"], g["b"], g["x0"], device=dev, fused="never")
            k = int(res.iterations)
            x = res.x.cpu().numpy()
            require(k == g["iters"] and bool(res.converged), f"golden {label}: {k} laps")
            require(np.allclose(x, g["x_star"], atol=1e-5), f"golden {label}: x {x}")
            require(matvec_cuda.launches > before, f"golden {label} ran no K1")
            print(f"golden {label}: {k} laps, x {x}")

    counts = {}
    with phase("flagship solves"):
        for n, make in ((8192, generate_spd_system), (16384, generate_spd_system_f32)):
            A, b, x0 = make(n, seed=0)
            x_ref, k_ref, _ = oracle_cg(A, b, x0)
            op = DenseOperator.create(A, device=dev)
            bd = torch.as_tensor(b, device=dev)
            x0d = torch.as_tensor(x0, device=dev)
            del A
            torch.cuda.synchronize()
            for fn in wrappers:
                fn.launches = 0
            res = cg_solve(op, bd, x0d, device=dev)
            torch.cuda.synchronize()
            launched = {fn.__name__: fn.launches for fn in wrappers}
            if n == 8192:
                counts = launched
            k = int(res.iterations)
            x = res.x.cpu().numpy()
            rel = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
            print(f"n={n}: {k} laps (oracle {k_ref}), ||r|| {float(res.residual_norm):.3e}, "
                  f"rel err vs oracle {rel:.3e}, launches {launched}")
            require(k == k_ref and bool(res.converged), f"n={n}: {k} laps vs oracle {k_ref}")
            require(np.isfinite(x).all() and x.shape == (n,), f"n={n}: x not finite")
            require(rel <= 1e-5, f"n={n}: rel err {rel}")
            for kern in ("matvec_cuda", "dot_cuda", "fused_update_cuda", "p_update_cuda"):
                require(launched[kern] > 0, f"n={n}: {kern} never launched")
            for plain in ("matvec_torch", "dot_torch", "fused_update_torch", "dot_alpha_torch",
                          "lap_tail_torch", "p_update_torch"):
                require(launched[plain] == 0, f"n={n}: plain {plain} ran on the main path")
            if n == 8192:
                flagship = (op, bd, x0d, k)
            del op, bd, x0d, res

        def kernel_counts(ops):
            return {name: c for name, (c, _) in ops.items()
                    if not name.startswith(("Memcpy", "Memset"))}

        # The lap route's device ops a lap: two capped solves (tol = 1e-30,
        # whose square is 0 in f32, and chunks of 8, so every lap enqueued
        # runs) 32 laps apart, each profiled (a
        # trace with no device event is taken again, at most three times).
        op, bd, x0d, k = flagship
        for pc in ("none", "jacobi", "poly"):
            windows = []
            for laps in (16, 48):
                for _ in range(3):
                    wall, ops = trace_calls(lambda: cg_solve(
                        op, bd, x0d, tol=1e-30, maxiter=laps, chunk=8, precondition=pc,
                        poly_degree=3), 1)
                    if ops:
                        break
                require(ops, f"lap ops {pc}: the profiler's trace held no device event")
                windows.append((wall, ops))
            (_, o16), (w48, o48) = windows
            k16, k48 = kernel_counts(o16), kernel_counts(o48)
            lap_kernels = {name: (c - k16.get(name, 0)) / 32 for name, c in k48.items()
                           if c != k16.get(name, 0)}
            kernels_a_lap = sum(lap_kernels.values())
            ops_a_lap = (sum(c for c, _ in o48.values()) - sum(c for c, _ in o16.values())) / 32
            busy = sum(us for _, us in o48.values())
            print(f"lap route n=8192 {pc}: {kernels_a_lap:g} kernel launches a lap, "
                  f"{ops_a_lap:g} device ops a lap (memcpy included), busy share "
                  f"{busy / 1e6 / w48:.3f} of a profiled 48-lap solve ({w48 * 1e3:.3f} ms host "
                  "wall); a lap's kernels: " + "; ".join(
                      f"{name[:60]} x {c:g}" for name, c in sorted(lap_kernels.items()))
                  + f" {tag}")
            if pc == "none":
                require(kernels_a_lap <= 4 and all("tpucg" in name for name in lap_kernels),
                        f"lap route none: {kernels_a_lap} kernels a lap ({lap_kernels})")
        del op, bd, x0d

    times, library, bounds = {}, {}, {}
    f32_peak = 67e12  # FLOP/s outside the tensor cores (H100 SXM data sheet)

    def bound_of(nbytes, flops):
        """(ms, what bounds it): the larger of the bytes at the HBM peak and
        the f32 operations at the f32 peak."""
        tb, tf = nbytes / peak, flops / f32_peak
        return (tb * 1e3, "bytes") if tb >= tf else (tf * 1e3, "operations")

    def cg_flops(n, laps, mv_flops, matvecs=None):
        """Operations of a CG solve: its matvecs (laps + 1 by default) and
        10 n of BLAS-1 a lap (p update, two dots, x and r updates); the
        preconditioners' own elementwise work is left out (a lower bound)."""
        return (laps + 1 if matvecs is None else matvecs) * mv_flops + 10 * n * laps

    n8 = 8192
    bounds["K1"] = bound_of(gemv_bytes(n8, n8, 4), 2 * n8 * n8)
    # K2 with p's update: x, r, p, Ap in, x', r', r'.r' out; then z, p in, p out.
    bounds["K2"] = bound_of(4 * (6 * n8 + 1) + 4 * 3 * n8, 7 * n8)
    bounds["K3"] = bound_of(4 * (2 * n8 + 1), 2 * n8)
    with phase("times"):
        op, bd, x0d, k = flagship
        op_plain = DenseOperator(A=op.A, n=op.n, backend="torch")
        t_kernel = time_fn(lambda: cg_solve(op, bd, x0d), warmup=1, iters=7)
        t_plain = time_fn(lambda: cg_solve(op_plain, bd, x0d, kernel="torch"), warmup=1, iters=7)
        for label, t in (("cuda kernels", t_kernel), ("plain torch", t_plain)):
            print(f"solve n=8192 ({k} laps), {label}: median {t.median * 1e3:.4f} ms "
                  f"min {t.min * 1e3:.4f} max {t.max * 1e3:.4f} ({t.samples} solves) {tag}")
        v = torch.ones(op.padded_n, device=dev)
        A16 = op.A.to(torch.bfloat16)
        for label, A in (("f32", op.A), ("bf16", A16)):
            tk = time_fn(lambda: matvec_cuda(A, v), warmup=3, iters=7, reps=20)
            tp = time_fn(lambda: matvec_torch(A, v), warmup=3, iters=7, reps=20)
            nbytes = gemv_bytes(*A.shape, A.element_size())
            for who, t in (("K1", tk), ("plain", tp)):
                rate = nbytes / t.median
                flag = "  ABOVE PEAK: timing fault" if rate > peak else ""
                print(f"{who} gemv {label} 8192x8192: {t.median * 1e6:.2f} us, "
                      f"{rate / 1e9:.1f} GB/s, {100 * rate / peak:.1f}% of HBM peak {tag}{flag}")
            if label == "f32":
                tl = time_fn(lambda: torch.mv(A, v), warmup=3, iters=7, reps=20)
                times["K1"] = (tk.median, tp.median)
                library["K1"] = tl.median
                print(f"torch.mv (cuBLAS) f32 8192x8192: {tl.median * 1e6:.2f} us {tag}")
        # K2 and K3 through their launch cores, as the lap calls them (one
        # scratch, zeroed once): K2 alone, and K2 with the lap's tail and then
        # p's update, the lap's pair (tol2 = 0, so the tail never stops);
        # K3 alone and in alpha mode. Each beside its plain version.
        x, r, p, ap = (rnd(8192) for _ in range(4))
        p2 = p.clone()
        alpha = torch.tensor(0.37, device=dev)
        rsold = torch.tensor(2.5, device=dev)
        stream = cuda_stream(x)
        scratch = scratch_for(x)
        out, out2, rr_o = (torch.empty((), device=dev) for _ in range(3))
        xo, ro = torch.empty_like(x), torch.empty_like(r)
        big = 2 ** 31 - 1
        tail = CudaLapTail(dev)
        tol2_0 = torch.zeros((), device=dev)
        tail.load(torch.tensor(0), torch.tensor(1.0), torch.tensor(1.0), torch.tensor(False),
                  tol2_0, big)
        plain_tail = LapTail(k=torch.zeros((), dtype=torch.int32, device=dev),
                             rsold=torch.ones((), device=dev), rslast=torch.ones((), device=dev),
                             done=torch.zeros((), dtype=torch.bool, device=dev),
                             active=torch.ones((), dtype=torch.bool, device=dev))

        def k2_lap():
            fused_update_tail_launch(x, r, p2, ap, alpha, xo, ro, scratch, tail.rr,
                                     tail.address, stream)
            p_update_launch(ro, p2, tail.beta, tail.step, scratch, stream)

        def k2_lap_plain():
            _, rn, rr_ = fused_update_torch(x, r, p, ap, alpha)
            t = lap_tail_torch(plain_tail, rr_, rr_, tol2_0, big)
            return p_update_torch(rn, p, t.beta, t.step)

        pairs = {
            "K2": (lambda: fused_update_launch(x, r, p, ap, alpha, xo, ro, scratch, rr_o, None,
                                               stream),
                   lambda: fused_update_torch(x, r, p, ap, alpha)),
            "K2 + tail + p update": (k2_lap, k2_lap_plain),
            "K3": (lambda: dot_launch(p, ap, scratch, out, None, stream),
                   lambda: dot_torch(p, ap)),
            "K3 alpha": (lambda: dot_alpha_launch(p, ap, scratch, out, rsold, out2, True, None,
                                                  stream),
                         lambda: dot_alpha_torch(p, ap, rsold)),
        }
        for kname, (fk, fp) in pairs.items():
            # Back-to-back calls are bound by host overhead at this size;
            # calls queued behind a spin kernel give the device time.
            dk, dp = device_seconds_per_call(fk), device_seconds_per_call(fp)
            if kname == "K3":
                times["K3"] = (dk, dp)
                library["K3"] = device_seconds_per_call(lambda: torch.dot(p, ap))
                print(f"torch.dot n=8192: device {library['K3'] * 1e6:.3f} us per call {tag}")
            if kname == "K2 + tail + p update":
                times["K2"] = (dk, dp)
            print(f"{kname} n=8192: device {dk * 1e6:.3f} us per call, plain {dp * 1e6:.3f} us "
                  f"(queued) {tag}")
        for kname, fk in (("K3 checked wrapper", lambda: dot_cuda(p, ap)),
                          ("K2 checked wrapper", lambda: fused_update_cuda(x, r, p, ap, alpha))):
            print(f"{kname} n=8192 (a zeroed scratch a call): device "
                  f"{device_seconds_per_call(fk) * 1e6:.3f} us per call {tag}")
        del tail

    def pad_to(t, npad):
        return torch.nn.functional.pad(t, (0, npad - t.shape[-1]))

    with phase("whole-solve K4"):
        counts["fused_cg_solve_cuda"] = 0
        err["K4"] = 0.0
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for n in (1000, 2048, 4096):
            A, b, x0 = generate_spd_system(n, seed=0)
            k_ref = oracle_cg(A, b, x0)[1]
            op = DenseOperator.create(A, device=dev)
            bd, x0d = torch.as_tensor(b, device=dev), torch.as_tensor(x0, device=dev)
            bp, x0p = pad_to(bd, op.padded_n), pad_to(x0d, op.padded_n)
            d = op.diagonal()
            minv = torch.where(d != 0, 1.0 / d, 1.0)
            for pc in ("none", "jacobi", "poly"):
                res, launched = drive(lambda: cg_solve(op, bd, x0d, fused="always",
                                                       precondition=pc, poly_degree=3))
                counts["fused_cg_solve_cuda"] += launched["fused_cg_solve_cuda"]
                require(only(launched, "fused_cg_solve_cuda"),
                        f"K4 n={n} {pc}: launches {launched}")
                kw = dict(tol=1e-6, maxiter=n, precondition=pc,
                          poly_degree=3 if pc == "poly" else 0,
                          minv=minv if pc == "jacobi" else None)
                x, k, rr = fused_cg_solve_cuda(op.A, bp, x0p, **kw)
                xp, kp, _ = fused_cg_solve_torch(op.A, bp, x0p, **kw)
                laps = int(k)
                require(laps == int(kp) == int(res.iterations) and bool(res.converged),
                        f"K4 n={n} {pc}: {laps} laps, plain {int(kp)}, cg_solve "
                        f"{int(res.iterations)}")
                if pc == "none":
                    require(laps == k_ref, f"K4 n={n}: {laps} laps vs oracle {k_ref}")
                # Relative to x's size (x ~ 1/n here): max |x - x_plain| <=
                # 1e-5 max |x_plain| for none/jacobi (f32 sums in another
                # order), 1e-4 for poly (its power method and Neumann terms
                # sum in other orders too).
                bound = 1e-4 if pc == "poly" else 1e-5
                e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                require(se <= bound, f"K4 n={n} {pc}: err {e}, {se} of max |x|")
                require(torch.equal(res.x, x[:n]), f"K4 n={n} {pc}: cg_solve's x differs")
                again = fused_cg_solve_cuda(op.A, bp, x0p, **kw)
                require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                        f"K4 n={n} {pc} repeat")
                err["K4"] = max(err["K4"], e)
                print(f"K4 n={n} {pc}: {laps} laps (plain {int(kp)}"
                      + (f", oracle {k_ref}" if pc == "none" else "")
                      + f"), ||r|| {float(rr) ** 0.5:.3e}, max abs err vs plain {e:.3e} = "
                      f"{se:.3e} of max |x| (bound {bound}), repeat bit-identical")
            # µs a lap: the slope of the queued device time between tol = 0
            # runs of 8 and 40 laps (no lap passes the stopping test); the
            # wrapper beside the queued device time of the tol 1e-6 solve.
            kw = dict(tol=1e-6, maxiter=n)
            slope, fixed = k4_resident.lap_slope(lambda m: fused_cg_solve_cuda(
                op.A, bp, x0p, tol=0.0, maxiter=m))
            wrapper = time_fn(lambda: fused_cg_solve_cuda(op.A, bp, x0p, **kw),
                              warmup=2, iters=7).median
            queued = device_seconds_per_call(lambda: fused_cg_solve_cuda(op.A, bp, x0p, **kw),
                                             reps=50)
            print(f"K4 n={n}: plan {dense_resident_plan(op.padded_n, sms).describe()}; "
                  f"{slope:.3f} us a lap, launch + set-up {fixed:.3f} us; solve: wrapper "
                  f"{wrapper * 1e3:.5f} ms, queued device {queued * 1e3:.5f} ms {tag}")
            if n == 1000:
                k4_laps = int(fused_cg_solve_cuda(op.A, bp, x0p, tol=1e-6, maxiter=n)[1])
                npad = op.padded_n
                bounds["K4"] = bound_of(4 * (npad * npad + 3 * npad),
                                     cg_flops(npad, k4_laps, 2 * npad * npad))
                times["K4"] = (wrapper,
                               time_fn(lambda: fused_cg_solve_torch(op.A, bp, x0p, **kw),
                                       warmup=2, iters=7).median)
            del op, A
        for label, g in (("2x2", GOLDEN_2X2), ("4x4", GOLDEN_4X4)):
            res, launched = drive(lambda: cg_solve(g["A"], g["b"], g["x0"], device=dev,
                                                   fused="always"))
            counts["fused_cg_solve_cuda"] += launched["fused_cg_solve_cuda"]
            k = int(res.iterations)
            x = res.x.cpu().numpy()
            require(k == g["iters"] and np.allclose(x, g["x_star"], atol=1e-5),
                    f"golden {label} through K4: {k} laps, x {x}")
            require(only(launched, "fused_cg_solve_cuda"), f"golden {label}: {launched}")
            print(f"golden {label} through K4: {k} laps, x {x}")
        print(f"crossover, solve through cg_solve: K4 (fused='always') vs the lap path "
              f"(fused='never'), generate_spd_system seed 0, medians of 7 (ms), each arm "
              f"twice in turns; FUSED_AUTO_MAX_N = {FUSED_AUTO_MAX_N} {tag}")
        crossover = {}
        for n in (128, 256, 512, 1024, 2048, 4096):
            A, b, x0 = generate_spd_system(n, seed=0)
            op = DenseOperator.create(A, device=dev)
            bd, x0d = torch.as_tensor(b, device=dev), torch.as_tensor(x0, device=dev)
            arms = {}
            for fused in ("never", "always", "always", "never"):
                t = time_fn(lambda: cg_solve(op, bd, x0d, fused=fused), warmup=2, iters=7)
                arms.setdefault(fused, []).append(t.median * 1e3)
            crossover[n] = arms
            lap, k4 = arms["never"], arms["always"]
            print(f"  n={n}: lap path {lap[0]:.4f} / {lap[1]:.4f} ms, K4 {k4[0]:.4f} / "
                  f"{k4[1]:.4f} ms, K4 faster: {max(k4) < min(lap)}")
            del op, A

    def split_report(Ad, bp, x0p, kw, k, kp):
        """For each system where K5 and its plain version stop on different
        laps, r.r / tol^2 at the lap before the earlier stop and at it, from
        K5, the plain version and a float64 solve (batch_cg_loop on the same
        A, b, x0 and minv in float64); each run to that lap by maxiter."""
        k, kp = k.tolist(), kp.tolist()
        split = [i for i in range(len(k)) if k[i] != kp[i]]
        tol2 = kw["tol"] ** 2
        at = {}
        A64, b64, x064 = Ad.double(), bp.double(), x0p.double()
        minv64 = None if kw["minv"] is None else kw["minv"].double()
        for j in sorted({min(k[i], kp[i]) + d for i in split for d in (-1, 0)}):
            kwj = dict(kw, maxiter=j)
            s64 = batch_cg_loop(batch_matvec(A64), b64, x064, tol=kw["tol"], maxiter=j,
                                precond=None if minv64 is None else
                                (lambda r, act=None: minv64 * r))
            at[j] = [t.double().cpu() / tol2 for t in (
                fused_batch_cg_solve_cuda(Ad, bp, x0p, **kwj)[2],
                fused_batch_cg_solve_torch(Ad, bp, x0p, **kwj)[2], s64.rslast)]
        del A64
        for i in split:
            m = min(k[i], kp[i])
            cells = "; ".join(f"lap {j}: K5 {float(at[j][0][i]):.6g}, plain "
                              f"{float(at[j][1][i]):.6g}, f64 {float(at[j][2][i]):.6g}"
                              for j in (m - 1, m))
            print(f"  split system {i}: K5 {k[i]} laps, plain {kp[i]}; r.r/tol^2 at {cells}")
        return split

    with phase("batched K5"):
        counts["fused_batch_cg_solve_cuda"] = 0
        err["K5"] = 0.0
        batches = (
            # Lap counts fixed by the spectra (1 + i % 6 levels): tol 1e-2
            # lies far from ||r|| on both sides of the last lap.
            ("circulant", circulant_spd_batch, 1e-2),
            # Stops where the rounding of r is of the order of tol: K5 and
            # the plain version may stop one lap apart (split_report).
            ("shifted", shifted_spd_batch, 1e-6),
        )
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for nsys, n in ((64, 1000), (16, 2048), (256, 512)):
            for kind, make, tol in batches[:1] if nsys == 256 else batches:
                As, bs, X0 = make(nsys, n, seed=100)
                Ad, bp, x0p, minv = padded_batch(As, bs, X0, dev)
                npad = Ad.shape[1]
                plan = batch_cluster_plan(nsys, npad, sms)
                for pc in ("none", "jacobi"):
                    what = f"K5 {kind} {nsys}x{n} {pc}"
                    res, launched = drive(lambda: cg_solve_batch(As, bs, X0, device=dev,
                                                                 precondition=pc, tol=tol))
                    counts["fused_batch_cg_solve_cuda"] += launched["fused_batch_cg_solve_cuda"]
                    require(only(launched, "fused_batch_cg_solve_cuda"),
                            f"{what}: launches {launched}")
                    kw = dict(tol=tol, maxiter=n, precondition=pc,
                              minv=minv if pc == "jacobi" else None)
                    x, k, rr = fused_batch_cg_solve_cuda(Ad, bp, x0p, **kw)
                    xp, kp, _ = fused_batch_cg_solve_torch(Ad, bp, x0p, **kw)
                    laps = k.tolist()
                    require(laps == res.iterations.tolist(), f"{what}: cg_solve_batch's laps")
                    require(bool(res.converged.all()), f"{what}: not converged")
                    require(laps[-1] == 0 and min(laps[:-1]) > 0, f"{what}: laps {laps}")
                    e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                    require(se <= 1e-4, f"{what}: err {e}, {se} of max |x|")
                    require(torch.equal(res.x, x[:, :n]), f"{what}: x differs")
                    again = fused_batch_cg_solve_cuda(Ad, bp, x0p, **kw)
                    require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                            f"{what} repeat")
                    # Every cluster size gives the plan's bits (the one-block order).
                    for c in (1, 2, 4, 8):
                        forced = fused_batch_cg_solve_cuda(Ad, bp, x0p, _cluster=c, **kw)
                        require(all(torch.equal(u, v) for u, v in zip((x, k, rr), forced)),
                                f"{what}: C = {c} differs from the plan's C = {plan.cluster}")
                    if kind == "circulant":
                        require(laps == kp.tolist() == [1 + i % 6 for i in range(nsys - 1)] + [0],
                                f"{what}: laps {laps} vs plain {kp.tolist()}")
                        require(torch.allclose(x, xp, rtol=1e-5, atol=1e-6), f"{what}: err {e}")
                        agree = "equal to plain"
                    else:
                        require(int((k - kp).abs().max()) <= 1,
                                f"{what}: laps {laps} vs plain {kp.tolist()}")
                        split = split_report(Ad, bp, x0p, kw, k, kp)
                        agree = f"{len(split)} of {nsys} a lap apart from plain, none further"
                    err["K5"] = max(err["K5"], e)
                    print(f"{what} (tol {tol}): laps min {min(laps[:-1])} max {max(laps)} "
                          f"({len(set(laps))} distinct, system {nsys - 1} at 0), {agree}; "
                          f"max abs err {e:.3e} = {se:.3e} of max |x| (bound 1e-4), repeat "
                          f"and C = 1, 2, 4, 8 bit-identical to the plan's C = {plan.cluster}")
                    if (kind, pc) == ("circulant", "none"):
                        # A re-read by every matvec: the streaming floor.
                        floor = 4 * npad * npad * sum(kk + 1 for kk in laps) / peak
                        table = bound_of(4 * nsys * (npad * npad + 3 * npad),
                                         sum(cg_flops(npad, kk, 2 * npad * npad) for kk in laps))
                        tc = {c: time_fn(lambda c=c: fused_batch_cg_solve_cuda(
                            Ad, bp, x0p, _cluster=c, **kw), warmup=1, iters=5).median
                            for c in (1, 2, 4, 8)}
                        tk = time_fn(lambda: fused_batch_cg_solve_cuda(Ad, bp, x0p, **kw),
                                     warmup=1, iters=5)
                        tp = time_fn(lambda: fused_batch_cg_solve_torch(Ad, bp, x0p, **kw),
                                     warmup=1, iters=5)
                        held = {c: fused_batch_clusters(npad, c) for c in (1, 2, 4, 8)}
                        print(f"K5 {nsys}x{n} none: {tk.median * 1e3:.5f} ms (min "
                              f"{tk.min * 1e3:.5f}, max {tk.max * 1e3:.5f}) at the plan's C = "
                              f"{plan.cluster} ({plan.blocks} blocks of {plan.threads}) vs plain "
                              f"{tp.median * 1e3:.5f} ms; streaming floor {floor * 1e3:.5f} ms "
                              f"({floor / tk.median:.1%} of it); the table's bound "
                              f"{table[0]:.5f} ms ({table[1]}); by C "
                              + ", ".join(f"{c}: {t * 1e3:.5f} ms" for c, t in tc.items())
                              + "; clusters the card holds at once by C "
                              + ", ".join(f"{c}: {h}" for c, h in held.items()) + f" {tag}")
                        if nsys == 64:
                            bounds["K5"] = table
                            times["K5"] = (tk.median, tp.median)
                del Ad, As, res
        print(f"K4 n=1000 none: {times['K4'][0] * 1e3:.4f} ms vs plain "
              f"{times['K4'][1] * 1e3:.4f} ms {tag}")

    def torch_csr(data, offsets):
        """The DIA matrix as a torch CSR tensor on the card: the yardstick
        sparse product (library_ms), never used by the port."""
        npad = data.shape[1]
        rows = torch.arange(npad, device=dev)
        ri, ci, vi = [], [], []
        for d, off in enumerate(offsets):
            cols = rows + off
            keep = (cols >= 0) & (cols < npad) & (data[d] != 0)
            ri.append(rows[keep])
            ci.append(cols[keep])
            vi.append(data[d][keep].float())
        coo = torch.sparse_coo_tensor(torch.stack([torch.cat(ri), torch.cat(ci)]),
                                      torch.cat(vi), (npad, npad), check_invariants=True)
        return coo.coalesce().to_sparse_csr()

    def kernel_vs_plain(label, fk, fp, nbytes, nnz, csr, x):
        """One sparse lap kernel against its plain version on the same
        inputs: bit-identical (same products and sums in the same order,
        each rounded on its own) and repeat bit-identical; then the device
        time per call (queued behind a spin kernel: back-to-back wrapper
        calls are bound by host overhead at these sizes) of the kernel, the plain version and
        the CSR product."""
        y, yp = fk(), fp()
        e = float((y - yp).abs().max())
        require(torch.equal(y, yp), f"{label}: max abs err {e} against plain")
        require(torch.equal(y, fk()), f"{label}: repeat differs")
        for f in (fk, fp, lambda: csr @ x):  # warm up
            f()
        tk, tp, tl = (device_seconds_per_call(f) for f in (fk, fp, lambda: csr @ x))
        b_s = nbytes / peak
        print(f"{label}: bit-identical to plain and to its repeat (tol 0); device "
              f"{tk * 1e6:.2f} us per launch, {rate_line(nbytes, tk, peak, nnz)}, "
              f"{100 * b_s / tk:.1f}% of its {b_s * 1e6:.2f} us bound; plain "
              f"{tp * 1e6:.2f} us, torch CSR product {tl * 1e6:.2f} us (queued) {tag}")
        return e, tk, tp, tl

    with phase("sparse kernels vs plain"):
        m = 128
        dia128 = poisson3d_dia(m)
        f32, bf16 = torch.float32, torch.bfloat16
        ops128 = {dt: DiaOperator.from_dia(dia128, storage_dtype=dt, device=dev)
                  for dt in (f32, bf16)}
        csr128 = torch_csr(ops128[f32].data, ops128[f32].offsets)
        x = rnd(m ** 3)
        require(torch.equal(ops128[f32].matvec(x), ops128[bf16].matvec(x)),
                "K6 Poisson m=128: bf16 slab differs from f32")
        print("K6 Poisson m=128: the bf16 slab's y equals the f32 slab's bit for bit")
        k6_us = {}
        for dt, name in ((f32, "f32"), (bf16, "bf16")):
            op = ops128[dt]
            r = kernel_vs_plain(
                f"K6 Poisson m=128 DIA {name} (n={op.padded_n}, 7 diagonals)",
                lambda: dia_spmv_cuda(op.data, op.offsets, x),
                lambda: dia_spmv_torch(op.data, op.offsets, x),
                dia_spmv_bytes(7, op.padded_n, op.data.element_size()), poisson_nnz(m),
                csr128, x)
            k6_us[name] = r[1] * 1e6
            if dt == f32:
                err["K6"], times["K6"], library["K6"] = r[0], r[1:3], r[3]
                bounds["K6"] = bound_of(dia_spmv_bytes(7, op.padded_n, 4), 14 * op.padded_n)
        nb = 2 ** 20
        offsets, data, _ = random_banded_dia(nb, BAND_SETS["cross_row"], seed=0)
        data32 = torch.as_tensor(data, device=dev)
        csrb = torch_csr(data32, offsets)
        xb = rnd(nb)
        for dt, name in ((f32, "f32"), (bf16, "bf16")):
            d = data32.to(dt)
            e = kernel_vs_plain(
                f"K6 cross-row band {offsets} {name} (n=2^20)",
                lambda: dia_spmv_cuda(d, offsets, xb), lambda: dia_spmv_torch(d, offsets, xb),
                dia_spmv_bytes(len(offsets), nb, d.element_size()), int((data != 0).sum()),
                csrb, xb)[0]
            err["K6"] = max(err["K6"], e)
        del csrb, data32
        for mm in (128, 100, 2):
            u = rnd(mm ** 3)
            dm = poisson3d_dia(mm)  # unpadded: the CSR product's length is u's
            csr = csr128 if mm == 128 else torch_csr(torch.as_tensor(dm.data, device=dev),
                                                     dm.offsets)
            r = kernel_vs_plain(f"K8 stencil m={mm} (n={mm ** 3})",
                                lambda: poisson3d_cuda(u, mm), lambda: poisson3d_torch(u, mm),
                                stencil_bytes(mm ** 3), poisson_nnz(mm), csr, u)
            cold = stencil_cold_seconds(lambda v: poisson3d_cuda(v, mm), (u,))
            b_s = stencil_bytes(mm ** 3) / peak
            print(f"K8 m={mm} march: {stencil_march_plan(mm).describe()}; warm "
                  f"{r[1] * 1e6:.3f} us ({b_s / r[1]:.1%} of its bound), cold (8 copies of u) "
                  f"{cold * 1e6:.3f} us ({b_s / cold:.1%}) {tag}")
            if mm == 128:
                err["K8"], times["K8"], library["K8"] = r[0], r[1:3], r[3]
                bounds["K8"] = bound_of(stencil_bytes(mm ** 3), 7 * mm ** 3)
            else:
                err["K8"] = max(err["K8"], r[0])
        del csr128, csr

    def true_residual(op, b, x):
        """||b - A x|| / ||b|| in float64 on the card (plain versions)."""
        x64 = x.double()
        if isinstance(op, PoissonOperator):
            ax = poisson3d_torch(x64, op.m)
        else:
            ax = dia_spmv_torch(op.data.double(), op.offsets, x64)[: op.n]
        b64 = b.double()
        return float((b64 - ax).norm() / b64.norm())

    def poisson_rhs(mm, x0_scale=0.0):
        """tpucg's bench system: x_true standard normal (default_rng(0),
        f32), b = A x_true (the plain stencil on the card); with x0_scale a
        nonzero x0 from the same generator."""
        rng = np.random.default_rng(0)
        xt = torch.as_tensor(rng.standard_normal(mm ** 3).astype(np.float32), device=dev)
        x0 = torch.as_tensor((x0_scale * rng.standard_normal(mm ** 3)).astype(np.float32),
                             device=dev)
        return poisson3d_torch(xt, mm), x0

    def poisson_maxiter(mm):
        # CG on the m^3 Laplacian at tol 1e-5 ||b|| takes ~4 m laps: the
        # clamp is ~2x that, and every solve must converge under it.
        return 8 * mm + 200

    with phase("Poisson m=128"):
        m = 128
        b, _ = poisson_rhs(m)
        tol, maxiter = 1e-5 * float(b.norm()), poisson_maxiter(m)
        print(f"Poisson m={m}: n={m ** 3}, nnz={poisson_nnz(m)}, tol 1e-5 ||b|| = {tol:.6e}, "
              f"maxiter {maxiter}; gate caps: stencil m <= {FUSED_STENCIL_AUTO_MAX_M}, "
              f"DIA n <= {FUSED_DIA_AUTO_MAX_N}")
        routes = {
            "stencil": (PoissonOperator(m, device=dev), PoissonOperator(m, backend="torch",
                                                                        device=dev),
                        "fused_stencil_cg_solve_cuda", "poisson3d_cuda", "poisson3d_torch"),
        }
        for dt, name in ((f32, "f32"), (bf16, "bf16")):
            op = ops128[dt]
            routes[f"DIA {name}"] = (op, DiaOperator(data=op.data, offsets=op.offsets, n=op.n,
                                                     backend="torch"),
                                     "fused_dia_cg_solve_cuda", "dia_spmv_cuda", "dia_spmv_torch")
        main = {k: 0 for k in ("fused_stencil_cg_solve_cuda", "fused_dia_cg_solve_cuda",
                               "poisson3d_cuda", "dia_spmv_cuda")}
        cuda_names = [w.__name__ for w in wrappers + whole if w.__name__.endswith("_cuda")]
        plain_names = [w.__name__ for w in wrappers + whole if w.__name__.endswith("_torch")]
        solve_ms, x_err = {}, {"K10": 0.0, "K11": 0.0}
        for label, (op, op_plain, whole_name, mv, mv_plain) in routes.items():
            for pc in ("none", "jacobi", "poly") if label != "stencil" else ("none", "poly"):
                kw = dict(tol=tol, maxiter=maxiter, precondition=pc, poly_degree=3)
                what = f"{label} {pc}"
                res_p, lp = drive(lambda: cg_solve(op_plain, b, kernel="torch", **kw))
                require(lp[mv_plain] > 0 and all(lp[c] == 0 for c in cuda_names),
                        f"{what} plain route: launches {lp}")
                res_f, lf = drive(lambda: cg_solve(op, b, **kw))
                require(only(lf, whole_name), f"{what} default route: launches {lf}")
                main[whole_name] += lf[whole_name]
                runs = {"default (" + whole_name.split("_cg")[0] + ")": res_f, "plain": res_p}
                if pc == "none":
                    res_n, ln = drive(lambda: cg_solve(op, b, fused="never", **kw))
                    require(all(ln[c] > 0 for c in (mv, "dot_cuda", "fused_update_cuda"))
                            and all(ln[c] == 0 for c in plain_names)
                            and ln[whole_name] == 0, f"{what} lap route: launches {ln}")
                    main[mv] += ln[mv]
                    runs["lap (fused=never)"] = res_n
                kp = int(res_p.iterations)
                cells = []
                for rname, res in runs.items():
                    tr = true_residual(op, b, res.x)
                    laps = int(res.iterations)
                    require(bool(res.converged) and tr <= 2e-5 and abs(laps - kp) <= 1,
                            f"{what} {rname}: {laps} laps (plain {kp}), converged "
                            f"{bool(res.converged)}, true residual {tr:.3e}")
                    cells.append(f"{rname} {laps} laps ({laps - kp:+d} vs plain), "
                                 f"true residual {tr:.3e}")
                kid = "K10" if label == "stencil" else "K11"
                x_err[kid] = max(x_err[kid], float((res_f.x - res_p.x).abs().max()))
                print(f"{what}: " + "; ".join(cells))
                if pc == "none" or label == "stencil":
                    arms = {"default": lambda: cg_solve(op, b, **kw)}
                    if pc == "none":
                        arms["lap"] = lambda: cg_solve(op, b, fused="never", **kw)
                        arms["plain"] = lambda: cg_solve(op_plain, b, kernel="torch", **kw)
                    for arm, fn in arms.items():
                        t = time_fn(fn, warmup=1, iters=5)
                        solve_ms[(what, arm)] = t.median * 1e3
                        print(f"  {what} {arm}: {t.median * 1e3:.4f} ms per solve (min "
                              f"{t.min * 1e3:.4f}, max {t.max * 1e3:.4f}, 5 solves) {tag}")
        for name, c in main.items():
            require(c > 0, f"main path: {name} never launched")
        counts.update(main)
        print(f"main-path launches: {main}")
        # K10 / K11 alone against their plain versions at m = 128 (none);
        # K10 timed by its lap driver, beside K8 (phase 9, this call).
        z = torch.zeros_like(b)
        kw = dict(tol=tol, maxiter=maxiter)
        opf = ops128[f32]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for kid, fk, fp, mvf, nbytes in (
            ("K10", lambda: fused_stencil_cg_solve_cuda(b, z, m, **kw),
             lambda: fused_stencil_cg_solve_torch(b, z, m, **kw), 7 * m ** 3, 12 * m ** 3),
            ("K11", lambda: fused_dia_cg_solve_cuda(opf.data, opf.offsets, b, z, **kw),
             lambda: fused_dia_cg_solve_torch(opf.data, opf.offsets, b, z, **kw),
             14 * m ** 3, 4 * 7 * m ** 3 + 12 * m ** 3),
        ):
            (x, k, _), (xp, kp, _) = fk(), fp()
            e = float((x - xp).abs().max())
            err[kid] = max(x_err[kid], e)
            if kid == "K10":
                r = k10_lap.measure(m, b, z, tol=tol, maxiter=maxiter, peak=peak)
                require(r["laps"] == int(k) == 71, f"K10 m={m} none: {r['laps']} laps, not 71")
                require(torch.equal(r["x"], x), f"K10 m={m} none: repeat differs")
                tk = r["t"]
                print(k10_lap.line(f"K10 m={m} none", r, sms)
                      + f"; K8 {times['K8'][0] * 1e6:.3f} us a launch {tag}")
            else:
                tk = time_fn(fk, warmup=1, iters=5)
            tp = time_fn(fp, warmup=0, iters=5)
            times[kid] = (tk.median, tp.median)
            bounds[kid] = bound_of(nbytes, cg_flops(m ** 3, int(k), mvf))
            print(f"{kid} m={m} none: {int(k)} laps (plain {int(kp)}), max abs err vs plain "
                  f"{e:.3e}; {tk.median * 1e3:.4f} ms per solve, {tk.median / int(k) * 1e6:.2f} "
                  f"us per lap; plain {tp.median * 1e3:.4f} ms; bound {bounds[kid][0]:.4f} ms "
                  f"({bounds[kid][1]}) {tag}")
        # K11's tiles at m = 128, f32 and bf16: its plan and grid, and the lap
        # beside the slab's bytes at the HBM peak and K6 (phase 9, this call).
        for dt, name in ((f32, "f32"), (bf16, "bf16")):
            r = k11_lap.measure(ops128[dt], b, z, tol=tol, maxiter=maxiter, peak=peak)
            require(dt != f32 or r["laps"] == 71, f"K11 m={m} f32 none: {r['laps']} laps, not 71")
            print(k11_lap.line(f"K11 m={m} {name} none", r, sms)
                  + f"; K6 {name} {k6_us[name]:.3f} us a launch {tag}")

    with phase("gate table"):
        print("cg_solve fused='always' (K10 / K11) against fused='never' (lap path), tpucg's "
              "bench system, medians of 5 solves (ms), each arm twice in turns "
              f"(never, always, always, never) {tag}")
        cases = [("stencil", mm, None) for mm in (16, 32, 64, 128, 160, 192)]
        cases += [("DIA", mm, dt) for mm in (32, 64, 128, 160) for dt in (f32, bf16)]
        for kind, mm, dt in cases:
            b, _ = poisson_rhs(mm)
            tol, maxiter = 1e-5 * float(b.norm()), poisson_maxiter(mm)
            if kind == "stencil":
                op = PoissonOperator(mm, device=dev)
            else:
                op = DiaOperator.from_dia(poisson3d_dia(mm), storage_dtype=dt, device=dev)
            arms = {}
            for fused in ("never", "always", "always", "never"):
                res = cg_solve(op, b, tol=tol, maxiter=maxiter, fused=fused)
                require(bool(res.converged), f"gate {kind} m={mm} {fused}: not converged")
                t = time_fn(lambda: cg_solve(op, b, tol=tol, maxiter=maxiter, fused=fused),
                            warmup=1, iters=5)
                arms.setdefault(fused, []).append(t.median * 1e3)
            lap, whole_ = arms["never"], arms["always"]
            label = kind if dt is None else f"{kind} {'f32' if dt == f32 else 'bf16'}"
            print(f"  {label} m={mm} ({int(res.iterations)} laps): lap path {lap[0]:.4f} / "
                  f"{lap[1]:.4f} ms, whole solve {whole_[0]:.4f} / {whole_[1]:.4f} ms, "
                  f"whole solve faster: {max(whole_) < min(lap)}")
            del op

    with phase("whole-solve K10/K11 vs plain"):
        # m = 32 stages +-m^2 in the tiles' windows, m = 33 reads it through L2.
        for mm in (16, 32, 33, 64):
            b, x0 = poisson_rhs(mm, x0_scale=0.1)
            tol, maxiter = 1e-5 * float(b.norm()), poisson_maxiter(mm)
            cases = [("K10", pc, None) for pc in ("none", "poly")]
            cases += [("K11", pc, dt) for pc in ("none", "jacobi", "poly") for dt in (f32, bf16)]
            for kid, pc, dt in cases:
                kw = dict(tol=tol, maxiter=maxiter, precondition=pc,
                          poly_degree=3 if pc == "poly" else 0)
                if kid == "K10":
                    fk = lambda: fused_stencil_cg_solve_cuda(b, x0, mm, **kw)  # noqa: E731
                    fp = lambda: fused_stencil_cg_solve_torch(b, x0, mm, **kw)  # noqa: E731
                    what = f"K10 m={mm} {pc}"
                else:
                    # The slab is padded to a multiple of 128 rows (m = 33),
                    # its tail the identity: b and x0 get zeros there.
                    op = DiaOperator.from_dia(poisson3d_dia(mm), storage_dtype=dt, device=dev)
                    bd, x0d = (pad_to(t, op.padded_n) for t in (b, x0))
                    fk = lambda: fused_dia_cg_solve_cuda(op.data, op.offsets, bd, x0d, **kw)  # noqa: E731,E501
                    fp = lambda: fused_dia_cg_solve_torch(op.data, op.offsets, bd, x0d, **kw)  # noqa: E731,E501
                    what = f"K11 m={mm} {'f32' if dt == f32 else 'bf16'} {pc}"
                (x, k, rr), (xp, kp, _) = fk(), fp()
                e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                require(abs(int(k) - int(kp)) <= 1 and float(rr) < tol ** 2 and se <= 1e-4,
                        f"{what}: {int(k)} laps (plain {int(kp)}), rr {float(rr)}, err {se}")
                again = fk()
                require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                        f"{what}: repeat differs")
                err[kid] = max(err[kid], e)
                print(f"{what}: {int(k)} laps (plain {int(kp)}), max abs err {e:.3e} = {se:.3e} "
                      "of max |x| (bound 1e-4), repeat bit-identical")
        # The far band: +-40,000 read through L2 beside the staged +-1.
        offsets, data, bfar = random_banded_dia(FAR_BAND_N, FAR_BAND, seed=2)
        plan = dia_tile_plan(FAR_BAND_N, offsets)
        b = torch.as_tensor(bfar, device=dev)
        x0 = 0.1 * rnd(FAR_BAND_N)
        for dt in (f32, bf16):
            d = torch.as_tensor(data, device=dev).to(dt)
            for pc in ("none", "jacobi", "poly"):
                kw = dict(tol=1e-6, maxiter=4000, precondition=pc,
                          poly_degree=3 if pc == "poly" else 0)
                fk = lambda: fused_dia_cg_solve_cuda(d, offsets, b, x0, **kw)  # noqa: E731
                what = (f"K11 far band {offsets} n={FAR_BAND_N} {'f32' if dt == f32 else 'bf16'} "
                        f"{pc}")
                (x, k, rr), (xp, kp, _) = fk(), fused_dia_cg_solve_torch(d, offsets, b, x0, **kw)
                e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                require(abs(int(k) - int(kp)) <= 1 and float(rr) < 1e-12 and se <= 1e-4,
                        f"{what}: {int(k)} laps (plain {int(kp)}), rr {float(rr)}, err {se}")
                again = fk()
                require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                        f"{what}: repeat differs")
                err["K11"] = max(err["K11"], e)
                print(f"{what}: near {plan.near}, far {plan.far}; {int(k)} laps (plain {int(kp)}), "
                      f"max abs err {e:.3e} = {se:.3e} of max |x| (bound 1e-4), repeat "
                      "bit-identical")
        del ops128, d

    # The f32 true-residual bound of the FEM solve (PERF.md, written before
    # the first run): FEM's b ~ 1/n makes A x cancel, so the float64
    # ||b - A x|| / ||b|| of an f32 x sits near eps32 |A| |x| / |b|.
    fem_residual_bound = 0.25
    fem_cols = None  # (n, FEM 300k's CSR column indices), kept for phase 18
    fem_laps = 1720  # the kernel route's laps on the card since the FEM path came (PERF.md)

    def torch_csr_of(csr):
        """A host CSR as a torch CSR tensor on the card: the library call
        (library_ms), never used by the port."""
        return torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(csr.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(csr.data, dtype=torch.float32, device=dev), csr.shape)

    with phase("irregular K13 vs plain"):
        t0 = time.perf_counter()
        A_fem, b_fem, _ = fem_p1_system(300_000, seed=0)
        fem_cols = (A_fem.shape[0], A_fem.indices)  # phase 18's P4 at FEM scale
        fem_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        A_geo, _, _ = random_geometric_spd(1_000_000, seed=0, avg_degree=12.0)
        geo_s = time.perf_counter() - t0
        print(f"built FEM n={A_fem.shape[0]} nnz={A_fem.nnz} in {fem_s:.2f} s, geometric "
              f"n={A_geo.shape[0]} nnz={A_geo.nnz} in {geo_s:.2f} s (host)")
        err["K13"] = err["K14"] = 0.0
        stream = torch.cuda.current_stream(dev).cuda_stream
        # The arrowhead's first row (5000 entries) is longer than a tile.
        for label, A in (("FEM 300k", A_fem), ("geometric 1M", A_geo),
                         ("arrowhead 5000", arrowhead_spd(5000, seed=0))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op32 = WellOperator.from_csr(A, device=dev)
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t0
            layout = (op32.vals, op32.lidx, op32.gidl, op32.wrow, op32.sgb, op32.bg, op32.nsg)
            t0 = time.perf_counter()
            well_rows(*layout)
            torch.cuda.synchronize()
            rows_s = time.perf_counter() - t0
            ns, npad, rows = op32.vals.shape[0], op32.padded_n, op32.rows
            live = rows.cols.numel()
            ptr = rows.rowptr.long()
            per_tile = torch.diff(ptr[rows.tptr.long()])
            # How far a tile's columns spread: a 16-bit column form (a base
            # a tile) holds only tiles that span at most 65,535 columns.
            tile_of = torch.repeat_interleave(torch.arange(per_tile.numel(), device=dev),
                                              per_tile)
            cols = rows.cols.long()
            span = (torch.zeros_like(per_tile).scatter_reduce(0, tile_of, cols, "amax")
                    - torch.zeros_like(per_tile).scatter_reduce(0, tile_of, cols, "amin",
                                                                include_self=False))
            per_tile = per_tile.double()
            print(f"{label}: NS={ns} sublanes, BS={op32.gidl.shape[1]}, nsg={op32.nsg}, fill "
                  f"{live / (ns * 128):.4f}; layout: {live} live slots, {per_tile.numel()} tiles "
                  f"of at most {rows.tile}, slots a tile max {int(per_tile.max())} mean "
                  f"{float(per_tile.mean()):.2f}, longest row {int(torch.diff(ptr).max())}, "
                  f"widest column span of a tile {int(span.max())} ({int((span > 65535).sum())} "
                  f"tiles above 65,535); pack + place (the layout included) {pack_s:.2f} s, the "
                  f"layout alone {rows_s:.3f} s")
            csr_t = torch_csr_of(A)
            x2 = rnd(op32.n_groups, 128)
            xv = x2.reshape(-1)[: A.shape[0]].contiguous()
            tl = device_seconds_per_call(lambda: csr_t @ xv)
            ycore = torch.empty(npad, device=dev)
            for dt, dname in ((f32, "f32"), (bf16, "bf16")):
                op = op32 if dt == f32 else dataclasses.replace(op32, vals=op32.vals.to(bf16))
                args = (op.vals, op.lidx, op.gidl, op.wrow, op.sgb, x2, op.bg, op.nsg)
                index = op.rows
                what = f"K13 {label} {dname}"
                y = well_spmv_cuda(*args, index=index)
                yp = well_spmv_torch(*args, index=index)
                e = float((y - yp).abs().max())
                require(torch.equal(y, yp), f"{what}: max abs err {e} against plain")
                require(torch.equal(y, well_spmv_cuda(*args, index=index)), f"{what}: repeat")
                require(torch.equal(y, well_spmv_cuda(*args)), f"{what}: differs when the "
                        "wrapper builds the layout itself")
                require(torch.equal(well_spmv_fused_gather(*args, index=index), y),
                        f"K14 {label} {dname}: differs from K13")
                # The main path's call: the operator's launch core, rows [0, npad).
                core = op.launcher()
                core(x2.reshape(-1), ycore, None, stream)
                require(torch.equal(ycore, y.reshape(-1)[:npad]), f"{what}: launch core differs")
                err["K13"] = max(err["K13"], e)
                err["K14"] = max(err["K14"], e)
                tk = device_seconds_per_call(lambda: core(x2.reshape(-1), ycore, None, stream))
                tp = time_fn(lambda: well_spmv_torch(*args, index=index), warmup=1,
                             iters=5).median
                nbytes = well_spmv_bytes(live, op.vals.element_size(), npad)
                b_ms = bound_of(nbytes, 2 * live)
                print(f"{what}: bit-identical to plain (tol 0) and to its repeat, K14 the same; "
                      f"device {tk * 1e6:.2f} us per launch, {rate_line(nbytes, tk, peak, live)}, "
                      f"{100 * b_ms[0] / 1e3 / tk:.1f}% of its {b_ms[0] * 1e3:.2f} us bound "
                      f"({nbytes} bytes); plain {tp * 1e3:.3f} ms (host-timed, one read back a "
                      f"call); torch CSR product (f32) {tl * 1e6:.2f} us, "
                      f"{rate_line(csr_spmv_bytes(A.nnz, A.shape[0], 4, 8), tl, peak, A.nnz)}; "
                      f"K13 / CSR {tk / tl:.3f} {tag}")
                if (label, dname) == ("FEM 300k", "f32"):
                    times["K13"], library["K13"], bounds["K13"] = (tk, tp), tl, b_ms
                    tk14 = device_seconds_per_call(
                        lambda: well_spmv_fused_gather(*args, index=index))
                    times["K14"], library["K14"], bounds["K14"] = (tk14, tp), tl, b_ms
                    print(f"K14 (K13's kernel under tpucg's second name) {label} f32: device "
                          f"{tk14 * 1e6:.2f} us per launch (the checked wrapper) {tag}")
                if dt == f32 and label != "arrowhead 5000":
                    cells = []
                    for tile in (512, 1024, 2048, 4096, 8192):
                        rt = well_rows(*layout, tile=tile)

                        def by_tile():
                            return well_spmv_cuda(*args, index=rt)

                        require(torch.equal(by_tile(), y), f"{what}: tile {tile} differs")
                        cells.append(f"{tile}: {device_seconds_per_call(by_tile) * 1e6:.2f}")
                    print(f"{what} by tile (slots at most; checked wrapper, all rows), us per "
                          f"launch: " + ", ".join(cells) + f" {tag}")
            del op32, op, csr_t
        del A_geo

    with phase("FEM .mtx solve"):
        with tempfile.TemporaryDirectory() as tmp:
            pa, pb, px = (str(Path(tmp) / f) for f in ("A.mtx", "b.mtx", "x.txt"))
            t0 = time.perf_counter()
            save_matrix_market(pa, A_fem, symmetric=True)
            save_matrix_market(pb, b_fem)
            write_s = time.perf_counter() - t0
            tol = 1e-5 * float(np.linalg.norm(b_fem.astype(np.float64)))
            argv = ["solve", pa, pb, "--precondition", "jacobi", "--tol", repr(tol),
                    "--maxiter", "4000", "--output", px]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc, launched = drive(lambda: cli.main(argv))
            text = out.getvalue()
            print("\n".join("  " + ln for ln in text.splitlines() if "solution written" not in ln))
            fmt = re.search(r"system size\s+: \d+ x \d+\s+\[([^\]]+)\]", text).group(1)
            laps = int(re.search(r"iterations\s+: (\d+)", text).group(1))
            require(rc == 0 and "converged            : True" in text,
                    f"FEM .mtx solve: rc {rc}, not converged")
            require(fmt == "WellOperator", f"FEM .mtx solve promoted to {fmt}")
            # K13 is bit-equal to the kernel before its redesign, and the
            # dots are unchanged: the lap count the card gave before it.
            require(laps == fem_laps, f"FEM .mtx solve: {laps} laps, not {fem_laps}")
            require(all(launched[k] > 0 for k in ("well_spmv_cuda", "dot_cuda",
                                                  "fused_update_cuda"))
                    and all(launched[w.__name__] == 0 for w in wrappers + whole
                            if w.__name__.endswith("_torch")),
                    f"FEM .mtx solve: launches {launched}")
            counts["well_spmv_cuda"] = launched["well_spmv_cuda"]
            x = load_vector(px, n=A_fem.shape[0]).astype(np.float64)
            t0 = time.perf_counter()
            csr = load_matrix_market(pa).to_csr()
            load_s = time.perf_counter() - t0
        b64 = b_fem.astype(np.float64)
        true_rel = float(np.linalg.norm(b64 - csr.matvec(x)) / np.linalg.norm(b64))
        require(true_rel <= fem_residual_bound,
                f"FEM .mtx solve: true residual {true_rel:.3e} > {fem_residual_bound}")
        t0 = time.perf_counter()
        csr_to_well(csr)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        op = best_sparse_operator(csr, device=dev)
        torch.cuda.synchronize()
        promote_s = time.perf_counter() - t0
        bd = torch.as_tensor(b_fem, device=dev)
        kw = dict(tol=tol, maxiter=4000, precondition="jacobi")
        op_plain = dataclasses.replace(op, backend="torch")
        t0 = time.perf_counter()
        res_p = cg_solve(op_plain, bd, kernel="torch", **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        kp = int(res_p.iterations)
        require(bool(res_p.converged) and abs(laps - kp) <= 0.01 * kp,
                f"FEM .mtx solve: {laps} laps, plain route {kp}")
        solves = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = cg_solve(op, bd, **kw)
            end.record()
            torch.cuda.synchronize()
            solves.append(start.elapsed_time(end) / 1e3)
            require(int(res.iterations) == laps, f"FEM repeat: {int(res.iterations)} laps")
        fem_solve_s = sorted(solves)[1]
        # The lap path's busy share: a profiled window of 200 laps (a capped
        # solve; the profiler's trace can come back empty, and then the
        # share is not measured).
        wall, ops = trace_calls(lambda: cg_solve(op, bd, tol=tol, maxiter=200,
                                                 precondition="jacobi"), 1)
        busy = sum(us for _, us in ops.values())
        if busy > 0:
            top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:4]
            print(f"FEM lap path, profiled 200 laps: host wall {wall * 1e3:.3f} ms, device busy "
                  f"{busy / 1e3:.3f} ms, busy share {busy / 1e6 / wall:.3f}, "
                  f"{sum(c for c, _ in ops.values()) / 200:.1f} device ops a lap; "
                  + "; ".join(f"{name[:40]} {us / c:.2f} us x {c}" for name, (c, us) in top)
                  + f" {tag}")
        else:
            print("FEM lap path: the profiler's trace held no device event; busy share not "
                  "measured")
        print(f"FEM .mtx solve n={A_fem.shape[0]} nnz={A_fem.nnz}: {fmt}, {laps} laps (plain "
              f"route on the card {kp}, {laps - kp:+d}), float64 ||b - A x|| / ||b|| "
              f"{true_rel:.4e} (bound {fem_residual_bound}); solve median of 3 "
              f"{fem_solve_s * 1e3:.3f} ms ({', '.join(f'{t * 1e3:.3f}' for t in solves)}; "
              f"{fem_solve_s / laps * 1e6:.2f} us a lap); plain route {plain_s:.3f} s; write "
              f".mtx {write_s:.2f} s, load {load_s:.2f} s, promotion + packing + placement "
              f"{promote_s:.2f} s (packing alone {pack_s:.2f} s) {tag}")
        del op, op_plain, csr  # A_fem and b_fem serve phase 19 too

    with phase("batched banded K12"):
        counts["fused_batch_dia_cg_solve_cuda"] = 0
        err["K12"] = 0.0
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsys, nb = 256, 1024
        # tpucg's battery at its tol (laps within one of the plain version),
        # and one whose spectra set the laps (tol 1e-2: equal laps).
        data_s, offs_s, b_s, laps_s = banded_spectrum_battery(nsys, nb, seed=0)
        batteries = {"tpucg": (*banded_battery(nsys, nb, seed=0), 1e-5, None),
                     "spectrum": (data_s, offs_s, b_s, 1e-2, laps_s)}
        for name, (data, offs, b, tol, want) in batteries.items():
            bd = torch.as_tensor(b, device=dev)
            z = torch.zeros_like(bd)
            for dt, dname in ((f32, "f32"), (bf16, "bf16")):
                d = torch.as_tensor(data, device=dev).to(dt)
                for pc in ("none", "jacobi"):
                    what = f"K12 {name} {nsys}x{nb} {dname} {pc} (tol {tol})"
                    res, launched = drive(lambda: cg_solve_batch_banded(
                        data, offs, b, device=dev, precondition=pc, storage_dtype=dt, tol=tol))
                    require(only(launched, "fused_batch_dia_cg_solve_cuda"),
                            f"{what}: launches {launched}")
                    counts["fused_batch_dia_cg_solve_cuda"] += launched[
                        "fused_batch_dia_cg_solve_cuda"]
                    kw = dict(tol=tol, maxiter=nb, precondition=pc)
                    x, k, rr = fused_batch_dia_cg_solve_cuda(d, offs, bd, z, **kw)
                    xp, kp, _ = fused_batch_dia_cg_solve_torch(d, offs, bd, z, **kw)
                    laps = k.tolist()
                    require(laps == res.iterations.tolist() and bool(res.converged.all()),
                            f"{what}: cg_solve_batch_banded's laps or convergence")
                    require(torch.equal(res.x, x), f"{what}: cg_solve_batch_banded's x")
                    e, se = float((x - xp).abs().max()), scaled_err(x.cpu(), xp.cpu())
                    require(int((k - kp).abs().max()) <= 1 and se <= 1e-4,
                            f"{what}: laps {laps} vs plain {kp.tolist()}, err {se}")
                    if want is not None:
                        require(laps == kp.tolist() == want, f"{what}: laps {laps} vs {want}")
                    again = fused_batch_dia_cg_solve_cuda(d, offs, bd, z, **kw)
                    require(all(torch.equal(u, v) for u, v in zip((x, k, rr), again)),
                            f"{what}: repeat differs")
                    err["K12"] = max(err["K12"], e)
                    split = int((k != kp).sum())
                    tk = time_fn(lambda: fused_batch_dia_cg_solve_cuda(d, offs, bd, z, **kw),
                                 warmup=1, iters=5)
                    tq = device_seconds_per_call(
                        lambda: fused_batch_dia_cg_solve_cuda(d, offs, bd, z, **kw), reps=50)
                    tp = time_fn(lambda: fused_batch_dia_cg_solve_torch(d, offs, bd, z, **kw),
                                 warmup=1, iters=5)
                    print(f"{what}: laps {min(laps)}-{max(laps)}, "
                          + ("equal to plain and to the spectra's" if want is not None else
                             f"{split} of {nsys} a lap apart from plain")
                          + f"; max abs err {e:.3e} = {se:.3e} of max |x|, repeat "
                          f"bit-identical; {tk.median * 1e3:.4f} ms per battery (min "
                          f"{tk.min * 1e3:.4f}), queued device {tq * 1e3:.5f} ms, plain loop "
                          f"{tp.median * 1e3:.4f} ms; plan "
                          f"{batch_dia_warps_plan(nsys, nb, len(offs), dt, sms).describe()} {tag}")
                    if (name, dname, pc) == ("tpucg", "f32", "none"):
                        times["K12"] = (tk.median, tp.median)
                        npad = nb
                        bounds["K12"] = bound_of(
                            nsys * (3 * npad * 4 + 3 * npad * 4 + 8),
                            sum(cg_flops(npad, kk, 2 * 3 * npad) for kk in laps))
        # K12 against its NumPy emulation (tests/_torch_helpers.py: today's
        # operations and sum order, FFMA where the kernel fuses), bit for
        # bit, on a small battery, at the plan's W and at each forced W.
        data_e, offs_e, b_e = banded_battery(8, 256, seed=3)
        be = torch.as_tensor(b_e, device=dev)
        for dt, dname in ((f32, "f32"), (bf16, "bf16")):
            d = torch.as_tensor(data_e, device=dev).to(dt)
            for pc in ("none", "jacobi"):
                want = batch_dia_cg_emulated(d.float().cpu().numpy(), offs_e, b_e,
                                             np.zeros_like(b_e), 1e-5, 256, jacobi=pc == "jacobi")
                for w in (None, 4, 8):
                    got = fused_batch_dia_cg_solve_cuda(
                        d, offs_e, be, torch.zeros_like(be), tol=1e-5, maxiter=256,
                        precondition=pc, **({} if w is None else {"_plan": (w, True)}))
                    require(all(np.array_equal(u.cpu().numpy(), v) for u, v in zip(got, want)),
                            f"K12 8x256 {dname} {pc} W={w}: differs from the NumPy emulation")
                print(f"K12 8x256 {dname} {pc}: x, k, r.r equal to the NumPy emulation bit for "
                      f"bit at the plan's W and at W = 4 and 8 (laps {want[1].tolist()})")

    def halo_csr(data, offsets, pad):
        """A row block of a DIA matrix as a torch CSR tensor on the card over
        x_ext = [halo_lo, x, halo_hi] (the halos as extra columns): the
        library call beside K7 and K9 (library_ms), never used by the port."""
        blk = data.shape[1]
        rows = torch.arange(blk, device=dev)
        ri, ci, vi = [], [], []
        for d, off in enumerate(offsets):
            keep = data[d] != 0
            ri.append(rows[keep])
            ci.append(rows[keep] + off + pad)
            vi.append(data[d][keep].float())
        coo = torch.sparse_coo_tensor(torch.stack([torch.cat(ri), torch.cat(ci)]),
                                      torch.cat(vi), (blk, blk + 2 * pad))
        return coo.coalesce().to_sparse_csr()

    def halos(v, r, blk, pad):
        """Rank r's halos of v cut in blocks of blk: the pad elements below
        and above its block (zeros at the ends)."""
        zero = torch.zeros(pad, device=dev)
        lo = v[r * blk - pad:r * blk].contiguous() if r > 0 else zero
        hi = v[(r + 1) * blk:(r + 1) * blk + pad].contiguous() if (r + 1) * blk < v.numel() \
            else zero
        return lo, hi

    with phase("halo kernels vs plain"):
        m, mm = 128, 128 * 128
        dia128 = poisson3d_dia(m)
        offs128 = tuple(int(o) for o in dia128.offsets)
        slab32 = torch.as_tensor(np.asarray(dia128.data, np.float32), device=dev)
        u = rnd(m ** 3)
        y8 = poisson3d_cuda(u, m)
        err["K9"] = err["K7"] = 0.0
        for P in (1, 2, 4):
            blk, parts = m ** 3 // P, []
            for r in range(P):
                ub = u[r * blk:(r + 1) * blk]
                lo, hi = halos(u, r, blk, mm)
                y, yp = poisson3d_slab_cuda(ub, lo, hi, m), poisson3d_slab_torch(ub, lo, hi, m)
                err["K9"] = max(err["K9"], float((y - yp).abs().max()))
                require(torch.equal(y, yp), f"K9 P={P} rank {r}: differs from plain")
                require(torch.equal(y, poisson3d_slab_cuda(ub, lo, hi, m)), f"K9 P={P} repeat")
                parts.append(y)
            require(torch.equal(torch.cat(parts), y8), f"K9 P={P}: slabs differ from K8")
            lo, hi = halos(u, 0, blk, mm)
            ub = u[:blk]
            csr = halo_csr(slab32[:, :blk], offs128, mm)
            u_ext = torch.cat([lo, ub, hi])
            fk, fp = (lambda: poisson3d_slab_cuda(ub, lo, hi, m),
                      lambda: poisson3d_slab_torch(ub, lo, hi, m))
            tk, tp, tl = (device_seconds_per_call(f) for f in (fk, fp, lambda: csr @ u_ext))
            cold = stencil_cold_seconds(lambda a, b_, c: poisson3d_slab_cuda(a, b_, c, m),
                                        (ub, lo, hi))
            b9 = bound_of(4 * (2 * blk + 2 * mm), 7 * blk)
            print(f"K9 m={m} mp={m // P} ({P} ranks): bit-identical to plain, to its repeat and, "
                  f"concatenated, to K8; rank 0 device {tk * 1e6:.2f} us per launch, "
                  f"{100 * b9[0] / 1e3 / tk:.1f}% of its {b9[0] * 1e3:.2f} us bound, cold (8 "
                  f"copies of its operands) {cold * 1e6:.3f} us ({100 * b9[0] / 1e3 / cold:.1f}%); "
                  f"plain {tp * 1e6:.2f} us, torch CSR product {tl * 1e6:.2f} us (queued); march: "
                  f"{stencil_march_plan(m, m // P, halo=True).describe()} {tag}")
            if P == 1:
                times["K9"], library["K9"], bounds["K9"] = (tk, tp), tl, b9
            del csr
        pad = halo_length(offs128)
        x = rnd(m ** 3)
        for dt, name in ((f32, "f32"), (bf16, "bf16")):
            slab = slab32.to(dt)
            y6 = dia_spmv_cuda(slab, offs128, x)
            for P in (1, 2, 4):
                blk, parts = m ** 3 // P, []
                for r in range(P):
                    d = slab[:, r * blk:(r + 1) * blk].contiguous()
                    xb = x[r * blk:(r + 1) * blk]
                    lo, hi = halos(x, r, blk, pad)
                    y = dia_spmv_halo_cuda(d, offs128, xb, lo, hi)
                    yp = dia_spmv_halo_torch(d, offs128, xb, lo, hi)
                    err["K7"] = max(err["K7"], float((y - yp).abs().max()))
                    require(torch.equal(y, yp), f"K7 {name} P={P} rank {r}: differs from plain")
                    require(torch.equal(y, dia_spmv_halo_cuda(d, offs128, xb, lo, hi)),
                            f"K7 {name} P={P} repeat")
                    parts.append(y)
                require(torch.equal(torch.cat(parts), y6), f"K7 {name} P={P}: blocks differ "
                        "from K6")
                d = slab[:, :blk].contiguous()
                xb = x[:blk]
                lo, hi = halos(x, 0, blk, pad)
                csr = halo_csr(d, offs128, pad)
                x_ext = torch.cat([lo, xb, hi])
                fk, fp = (lambda: dia_spmv_halo_cuda(d, offs128, xb, lo, hi),
                          lambda: dia_spmv_halo_torch(d, offs128, xb, lo, hi))
                tk, tp, tl = (device_seconds_per_call(f) for f in (fk, fp, lambda: csr @ x_ext))
                b7 = bound_of(dia_spmv_bytes(7, blk, d.element_size()) + 8 * pad, 14 * blk)
                print(f"K7 m={m} DIA {name}, {P} blocks of {blk} (halos {pad}): bit-identical to "
                      f"plain, to its repeat and, concatenated, to K6; block 0 device "
                      f"{tk * 1e6:.2f} us per launch, {100 * b7[0] / 1e3 / tk:.1f}% of its "
                      f"{b7[0] * 1e3:.2f} us bound; plain {tp * 1e6:.2f} us, torch CSR product "
                      f"{tl * 1e6:.2f} us (queued) {tag}")
                if (P, dt) == (1, f32):
                    times["K7"], library["K7"], bounds["K7"] = (tk, tp), tl, b7
                del csr
        del slab32, slab

    one_rank = {}
    with phase("sharded, one rank (NCCL)"):
        init_distributed(backend="nccl", device=dev)
        mesh = make_mesh(device=dev, backend="nccl")
        print(f"{mesh!r}")
        plain_names = [w.__name__ for w in wrappers if w.__name__.endswith("_torch")]
        A, b, x0 = generate_spd_system(8192, seed=0)
        k_ref = oracle_cg(A, b, x0)[1]
        op = DenseOperator.create(A, device=dev)
        bd, x0d = torch.as_tensor(b, device=dev), torch.as_tensor(x0, device=dev)
        serial = cg_solve(op, bd, x0d, fused="never")
        runs = {"dense n=8192": (lambda: cg_solve(op, bd, x0d, fused="never"), serial, {})}
        for strategy in ("allgather", "overlap"):
            system = distribute_system(A, b, x0, mesh, strategy=strategy)
            runs[f"dense n=8192 {strategy}"] = (
                lambda system=system, strategy=strategy: sharded_cg_solve(
                    system, mesh=mesh, strategy=strategy), serial, {"matvec_cuda": k_ref})
        del A
        m = 128
        bp, _ = poisson_rhs(m)
        kw = dict(tol=1e-5 * float(bp.norm()), maxiter=poisson_maxiter(m))
        opp = PoissonOperator(m, device=dev)
        opd = DiaOperator.from_dia(poisson3d_dia(m), device=dev)
        for label, o, kern in (("Poisson m=128 slab", opp, "poisson3d_slab_cuda"),
                               ("DIA m=128 f32", opd, "dia_spmv_halo_cuda")):
            ser = cg_solve(o, bp, fused="never", **kw)
            runs[f"{label} serial"] = (lambda o=o: cg_solve(o, bp, fused="never", **kw), ser, {})
            runs[label] = (lambda o=o: sharded_operator_cg_solve(o, bp, mesh=mesh, **kw), ser,
                           {kern: 1})
        for label, (fn, ser, kerns) in runs.items():
            if not kerns:
                continue  # a serial lap path, timed below beside its sharded solves
            res, launched = drive(fn)
            k = int(res.iterations)
            require(bool(res.converged) and k == int(ser.iterations),
                    f"{label}: {k} laps, serial lap path {int(ser.iterations)}")
            require(torch.equal(res.x, ser.x), f"{label}: x differs from the serial lap path")
            for kern in list(kerns) + ["dot_cuda", "fused_update_cuda"]:
                require(launched[kern] > 0, f"{label}: {kern} never launched ({launched})")
            # The sharded lap's scalars come from rank_sum: its tail and p's
            # update stay in torch ops (TorchLap), the only plain ones it runs.
            require(all(launched[c] == 0 for c in plain_names
                        if c not in ("lap_tail_torch", "p_update_torch")),
                    f"{label}: a plain version ran ({launched})")
            if "n=8192" in label:
                require(k == k_ref, f"{label}: {k} laps, oracle {k_ref}")
            for kern in ("poisson3d_slab_cuda", "dia_spmv_halo_cuda"):
                counts[kern] = counts.get(kern, 0) + launched[kern]
            one_rank[label] = (res, k)
            print(f"{label}: {k} laps, x bit-identical to the serial lap path's, launches "
                  f"{ {c: n for c, n in launched.items() if n} }")
        for label, (fn, _, _) in runs.items():
            t = time_fn(fn, warmup=1, iters=5)
            print(f"  {label}: {t.median * 1e3:.4f} ms per solve (min {t.min * 1e3:.4f}, max "
                  f"{t.max * 1e3:.4f}, 5 solves, CUDA events) {tag}")
        # What a sharded lap adds on one rank: the host time of the
        # transport's calls (a dot's rank_sum, the gather of p), and the
        # operator solves' set-up (a maxiter=0 solve: placing the block and
        # the initial residual).
        part, p_blk, p_full = (torch.ones((), device=dev), torch.ones(8192, device=dev),
                               torch.empty(8192, device=dev))
        for what, call in (("rank_sum of a partial", lambda: mesh.rank_sum(part)),
                           ("all_gather of p (8192)", lambda: mesh.all_gather(p_full, p_blk))):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            print(f"  transport, one NCCL rank: {what} {(time.perf_counter() - t0) / 200 * 1e6:.1f} "
                  f"us per call (host clock, 200 calls) {tag}")
        for label, o in (("Poisson m=128 slab", opp), ("DIA m=128 f32", opd)):
            t = time_fn(lambda: sharded_operator_cg_solve(o, bp, mesh=mesh, tol=kw["tol"],
                                                          maxiter=0), warmup=1, iters=5)
            print(f"  {label}: set-up and initial residual (maxiter=0) {t.median * 1e3:.4f} ms "
                  f"{tag}")
        # One profiled solve each, serial lap path and one rank: device busy
        # time against the host's wall (the trace can come back empty, and
        # then nothing is measured).
        for label, fn in (("Poisson serial", lambda: cg_solve(opp, bp, fused="never", **kw)),
                          ("Poisson slab", lambda: sharded_operator_cg_solve(opp, bp, mesh=mesh,
                                                                             **kw)),
                          ("DIA serial", lambda: cg_solve(opd, bp, fused="never", **kw)),
                          ("DIA band halo", lambda: sharded_operator_cg_solve(opd, bp, mesh=mesh,
                                                                              **kw))):
            wall, ops = trace_calls(fn, 1)
            busy = sum(us for _, us in ops.values())
            top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:3]
            print(f"  profiled {label}: host wall {wall * 1e3:.3f} ms, " + (
                f"device busy {busy / 1e3:.3f} ms (share {busy / 1e6 / wall:.3f}), "
                f"{sum(c for c, _ in ops.values())} device ops; " + "; ".join(
                    f"{name[:36]} {us / c:.2f} us x {c}" for name, (c, us) in top)
                if busy > 0 else "no device event in the trace: not measured") + f" {tag}")
        torch.distributed.destroy_process_group()
        del op, opd, runs, system

    with phase("sharded, 2 and 4 ranks on one card (gloo)"):
        worlds = {2: [("dense", "allgather"), ("dense", "overlap"), ("poisson", None),
                      ("dia", None)],
                  4: [("poisson", None), ("dia", None)]}
        refs = {"dense": one_rank["dense n=8192 allgather"],
                "poisson": one_rank["Poisson m=128 slab"], "dia": one_rank["DIA m=128 f32"]}
        with tempfile.TemporaryDirectory() as tmp:
            for P, cases in worlds.items():
                t0 = time.perf_counter()
                got = run_world(P, card_world_worker, args=(cases, m, bp.cpu().numpy(), kw),
                                rendezvous=str(Path(tmp) / f"world{P}"), timeout_s=400)
                print(f"world of {P} ranks on cuda:0 ({got['mesh']}): "
                      f"{time.perf_counter() - t0:.1f} s with start-up")
                for case in cases:
                    r = got[case]
                    ref, k1 = refs[case[0]]
                    x = torch.as_tensor(r["x"], device=dev)
                    se = scaled_err(r["x"], ref.x.cpu().numpy())
                    what = f"{case[0]}{'' if case[1] is None else ' ' + case[1]} P={P}"
                    require(r["converged"] and abs(r["laps"] - k1) <= 1 and se <= 1e-4,
                            f"{what}: {r['laps']} laps (one rank {k1}), x err {se:.3e}")
                    tr = true_residual(opp, bp, x) if case[0] == "poisson" else None
                    require(tr is None or tr <= 2e-5, f"{what}: true residual {tr}")
                    print(f"  {what}: {r['laps']} laps (one rank {k1}), x within {se:.3e} of "
                          f"max |x|" + ("" if tr is None else
                                        f", float64 ||b - A x|| / ||b|| {tr:.3e}")
                          + f"; {r['ms']:.3f} ms per solve (host clock), {r['laps_run']} laps "
                          f"run, transport {r['transport_s'] * 1e3 / r['laps_run']:.4f} ms a "
                          f"lap over {r['transport_calls']} calls {tag}")

    with phase("gather probes vs plain"):
        # No solve runs the probes: each is its own path, driven once
        # through its dispatcher with every count at 0 just before it.
        pa = pg.probe_inputs(0)
        pt = pg.device_inputs(pa, dev)
        print("benchmarks/probe_gather.py's inputs (probe_inputs(0)); device us per launch of "
              f"100 calls queued behind a spin kernel; bounds: bytes at the HBM peak {tag}")
        for p in pg.PROBES:
            out, launched = drive(lambda: p.run(*p.args(pt)))
            require(only(launched, p.kernel), f"{p.pid} {p.name}: launches {launched}")
            counts[p.pid] = launched[p.kernel]
            plain = p.plain(*p.args(pt))
            e = float((out - plain).abs().max())
            require(torch.equal(out, plain), f"{p.pid} {p.name}: max abs err {e} against plain")
            require(torch.equal(out, p.run(*p.args(pt))), f"{p.pid} {p.name}: repeat differs")
            err[p.pid] = e
            m = pg.measure(p, pt)
            times[p.pid], library[p.pid] = (m.kernel, m.plain), m.library
            nbytes = p.least_bytes(pa)
            bounds[p.pid] = bound_of(nbytes, p.elems if p.pid == "P5" else 0)
            require(nbytes / m.kernel <= peak,
                    f"{p.pid} {p.name}: {nbytes / m.kernel / 1e9:.1f} GB/s is above "
                    "the HBM peak: a timing fault")
            print(f"{p.pid}: bit-identical to plain and to its repeat (tol 0), one launch; "
                  f"{pg.probe_line(p, m, nbytes, peak)} {tag}")
        shifts = (5, 0, 127, 128, 300, -3, -2 ** 31, 2 ** 31 - 1)
        for shift in shifts:
            s_dev = torch.tensor([shift], dtype=torch.int32, device=dev)
            got = pg.kp.roll_dyn_cuda(s_dev, pt["V"])
            require(torch.equal(got, pg.kp.roll_dyn_torch(s_dev, pt["V"]))
                    and torch.equal(got, torch.roll(pt["V"], shift, 1)),
                    f"P6 at shift {shift}: differs from plain or torch.roll")
        print(f"P6 at shifts {', '.join(map(str, shifts))}: bit-identical to plain and to "
              "torch.roll")
        for line in pg.baselines(pt, pa):
            print(f"{pg.baseline_line(*line)} {tag}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for line in pg.plan_lines(sms) + pg.edge_checks(dev):
            print(f"{line} {tag}")
        if fem_cols is None:
            A = fem_p1_system(300_000, seed=0)[0]
            fem_cols = (A.shape[0], A.indices)
        print(f"{pg.fem_check(dev, *fem_cols)} {tag}")
        floor_s = pg.launch_floor(dev)
        print(f"one launch's floor (a one-element fill_, queued): {floor_s * 1e6:.3f} us; "
              "P1-P6 over it: " + ", ".join(
                  f"{pid} +{(times[pid][0] - floor_s) * 1e6:.3f}"
                  for pid in ("P1", "P2", "P3", "P4", "P5", "P6")) + f" us {tag}")
        del pt, pa


    def m8_case(what, solve, solve_plain, within, classic, x_tol=1e-4):
        """Drive one solve of M8 (every count at 0 just before it, read just
        after), hold it to the same method on the plain backend on the card
        (laps within `within`, x within `x_tol` of max |x|, no plain version
        in the kernel route and no kernel in the plain one), and time it
        beside the classic lap route on the same system (medians of 5, CUDA
        events). Returns the result and its launch counts."""
        res, launched = drive(solve)
        res_p, lp = drive(solve_plain)
        k, kp = int(res.iterations), int(res_p.iterations)
        require(bool(res.converged) and bool(res_p.converged),
                f"{what}: converged {bool(res.converged)}, plain {bool(res_p.converged)}")
        require(abs(k - kp) <= within, f"{what}: {k} laps, plain route {kp}")
        scale = float(res_p.x.abs().max())
        e = float((res.x - res_p.x).abs().max())
        require(e <= x_tol * scale,
                f"{what}: x {e:.3e} from the plain route's (max {scale:.3e})")
        require(all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                f"{what}: a plain version ran on the kernel route: {launched}")
        require(all(c == 0 for w, c in lp.items() if w.endswith("_cuda")),
                f"{what}: a kernel ran on the plain route: {lp}")
        t, tp, tc = (time_fn(f, warmup=0, iters=5) for f in (solve, solve_plain, classic))
        ran = {w: c for w, c in launched.items() if c}
        total = sum(ran.values())
        print(f"{what}: {k} laps (plain route {kp}), x within {e / scale:.2e} of max |x|; "
              f"{t.median * 1e3:.4f} ms a solve (min {t.min * 1e3:.4f}, max "
              f"{t.max * 1e3:.4f}), plain route {tp.median * 1e3:.4f}, classic lap route "
              f"{tc.median * 1e3:.4f} ms; {total} kernel launches, {total / max(k, 1):.2f} a "
              "lap (" + ", ".join(f"{w} {c}" for w, c in sorted(ran.items())) + f") {tag}")
        return res, launched

    with phase("M8: pipelined, CA, Chebyshev, block Jacobi"):
        # Dense n = 8192 through K1/K3 (block-Jacobi PCG: K1/K2/K3). At the
        # reference's tol 1e-6 pipelined CG sits below its f32 recurrence
        # floor (tpucg's too, n >= 256): it runs at 1e-6 ||b||.
        op, bd, x0d, _ = flagship
        op_plain = DenseOperator(A=op.A, n=op.n, backend="torch")
        bnorm = float(bd.norm())
        for label, kw, within in (
                ("pipelined (tol 1e-6 ||b||)", dict(method="pipelined", tol=1e-6 * bnorm), 1),
                ("ca s=3", dict(method="ca", s_step=3, tol=1e-6), 3),
                ("chebyshev", dict(method="chebyshev", tol=1e-6), 8),
                ("cg + block_jacobi bs=64", dict(precondition="block_jacobi", pc_block_size=64,
                                                 tol=1e-6), 1)):
            res, launched = m8_case(
                f"dense n=8192 {label}", lambda: cg_solve(op, bd, x0d, **kw),
                lambda: cg_solve(op_plain, bd, x0d, kernel="torch", **kw), within,
                lambda: cg_solve(op, bd, x0d, fused="never", tol=kw["tol"]))
            need = ("matvec_cuda", "dot_cuda") + (
                ("fused_update_cuda", "p_update_cuda") if "precondition" in kw else ())
            require(all(launched[w] > 0 for w in need), f"dense {label}: launches {launched}")
        del op_plain
        # Poisson m = 128 through K8. Unpreconditioned pipelined CG has no
        # residual replacement and its recurrence drifts: its true residual
        # lies near 1e-4 ||b|| at tol 1e-5 ||b|| (tpucg's: 7.3e-5 and 8.6e-5 at
        # m = 64 and 48 on the CPU), so it is held to 2e-4, and its x to the
        # plain route's within 1e-3 of max |x| (1.8e-4 apart on an H100);
        # with Jacobi (on the constant diagonal, the same iterates) it
        # replaces every 25 laps.
        mp = 128
        b, _ = poisson_rhs(mp)
        tol = 1e-5 * float(b.norm())
        op = PoissonOperator(mp, device=dev)
        op_plain = PoissonOperator(mp, backend="torch", device=dev)
        t0 = time.perf_counter()
        interval = spectral_interval(op)[:2]
        print(f"Poisson m={mp}: spectral_interval {interval[0]:.6g} .. {interval[1]:.6g} in "
              f"{time.perf_counter() - t0:.3f} s (host wall, once), reused below")
        for label, kw, within, bound, x_tol in (
                ("pipelined", dict(method="pipelined"), 1, 2e-4, 1e-3),
                ("pipelined + jacobi", dict(method="pipelined", precondition="jacobi"), 1, 2e-5,
                 1e-4),
                ("chebyshev, interval reused", dict(method="chebyshev", interval=interval,
                                                    maxiter=20_000), 8, 2e-5, 1e-4),
                ("cg + block_jacobi bs=64", dict(precondition="block_jacobi",
                                                 pc_block_size=64), 1, 2e-5, 1e-4)):
            kw = dict(dict(tol=tol, maxiter=poisson_maxiter(mp)), **kw)
            res, launched = m8_case(
                f"Poisson m={mp} {label}", lambda: cg_solve(op, b, **kw),
                lambda: cg_solve(op_plain, b, kernel="torch", **kw), within,
                lambda: cg_solve(op, b, fused="never", tol=tol, maxiter=poisson_maxiter(mp)),
                x_tol)
            tr = true_residual(op, b, res.x)
            require(tr <= bound, f"Poisson {label}: true residual {tr:.3e} > {bound}")
            need = ("poisson3d_cuda", "dot_cuda") + (
                ("fused_update_cuda",) if "method" not in kw else ())
            require(all(launched[w] > 0 for w in need), f"Poisson {label}: launches {launched}")
            print(f"  float64 ||b - A x|| / ||b|| {tr:.3e} (bound {bound})")
        del op, op_plain, b
        # FEM 300k through the CLI: the .mtx promoted to WELL carries block
        # Jacobi's blocks (K13, K2, K3 and the batched block product).
        with tempfile.TemporaryDirectory() as tmp:
            pa, pb, px = (str(Path(tmp) / f) for f in ("A.mtx", "b.mtx", "x.txt"))
            save_matrix_market(pa, A_fem, symmetric=True)
            save_matrix_market(pb, b_fem)
            tol = 1e-5 * float(np.linalg.norm(b_fem.astype(np.float64)))
            argv = ["solve", pa, pb, "--precondition", "block_jacobi", "--pc-block-size", "64",
                    "--tol", repr(tol), "--maxiter", "4000", "--output", px]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc, launched = drive(lambda: cli.main(argv))
            text = out.getvalue()
            print("\n".join("  " + ln for ln in text.splitlines() if "solution written" not in ln))
            fmt = re.search(r"system size\s+: \d+ x \d+\s+\[([^\]]+)\]", text).group(1)
            laps = int(re.search(r"iterations\s+: (\d+)", text).group(1))
            require(rc == 0 and "converged            : True" in text,
                    f"FEM block Jacobi .mtx solve: rc {rc}, not converged")
            require(fmt == "WellOperator", f"FEM block Jacobi .mtx solve promoted to {fmt}")
            require(all(launched[w] > 0 for w in ("well_spmv_cuda", "dot_cuda",
                                                   "fused_update_cuda", "p_update_cuda"))
                    and all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                    f"FEM block Jacobi .mtx solve: launches {launched}")
            x = load_vector(px, n=A_fem.shape[0]).astype(np.float64)
            csr = load_matrix_market(pa).to_csr()
        b64 = b_fem.astype(np.float64)
        true_rel = float(np.linalg.norm(b64 - csr.matvec(x)) / np.linalg.norm(b64))
        require(true_rel <= fem_residual_bound,
                f"FEM block Jacobi: true residual {true_rel:.3e} > {fem_residual_bound}")
        op = best_sparse_operator(csr, device=dev, pc_block_size=64)
        bd = torch.as_tensor(b_fem, device=dev)
        kw = dict(tol=tol, maxiter=4000, precondition="block_jacobi")
        res_p, lp = drive(lambda: cg_solve(dataclasses.replace(op, backend="torch"), bd,
                                           kernel="torch", **kw))
        kp = int(res_p.iterations)
        require(bool(res_p.converged) and abs(laps - kp) <= 0.01 * kp
                and all(c == 0 for w, c in lp.items() if w.endswith("_cuda")),
                f"FEM block Jacobi: {laps} laps, plain route {kp}, launches {lp}")
        t = time_fn(lambda: cg_solve(op, bd, **kw), warmup=1, iters=5)
        tc = time_fn(lambda: cg_solve(op, bd, tol=tol, maxiter=4000, precondition="jacobi"),
                     warmup=0, iters=5)
        total = sum(launched.values())
        print(f"FEM .mtx n={A_fem.shape[0]} block_jacobi bs=64 through the CLI: {fmt}, {laps} "
              f"laps (plain route on the card {kp}), float64 ||b - A x|| / ||b|| "
              f"{true_rel:.4e} (bound {fem_residual_bound}); {t.median * 1e3:.3f} ms a solve "
              f"(min {t.min * 1e3:.3f}, max {t.max * 1e3:.3f}), classic jacobi lap route "
              f"{tc.median * 1e3:.3f} ms ({fem_laps} laps); {total} kernel launches, "
              f"{total / laps:.2f} a lap (" + ", ".join(
                  f"{w} {c}" for w, c in sorted(launched.items()) if c) + f") {tag}")
        del op, bd, csr, res_p

    # M9's k-column kernels and solves. Every k-column launch a drive makes
    # is added here (the kernels line's launches of K6xk, K8xk and K13xk).
    m9_counts = dict.fromkeys(("dia_spmv_multi_cuda", "poisson3d_multi_cuda",
                               "well_spmv_multi_cuda"), 0)

    def m9_drive(solve):
        """drive() of one M9 solve, its k-column launches added up."""
        res, launched = drive(solve)
        for key in m9_counts:
            m9_counts[key] += launched[key]
        return res, launched

    def multi_vs_plain(label, fk, fp, single, X, nbytes, flops, csr=None, timed=True,
                       plain_synced=False):
        """A k-column kernel against its plain k-column version on the block
        X: bit-identical, repeat bit-identical, and column j bit-identical to
        the single-column kernel on column j; then the device µs a launch
        (queued, ``device_timing``) beside k launches of the single-column
        kernel, the plain version, the bound (bytes at the HBM peak) and the
        torch CSR product on the same block. Returns (err, times)."""
        k = X.shape[1]
        Y, Yp = fk(X), fp(X)
        e = float((Y - Yp).abs().max())
        require(torch.equal(Y, Yp), f"{label}: max abs err {e} against plain")
        require(torch.equal(Y, fk(X)), f"{label}: repeat differs")
        cols = [X[:, j].contiguous() for j in range(k)]
        for j, c in enumerate(cols):
            require(torch.equal(Y[:, j], single(c)),
                    f"{label}: column {j} differs from the single-column kernel")
        if not timed:
            print(f"{label}: bit-identical to plain (tol 0), to its repeat and, column by "
                  "column, to the single-column kernel")
            return e, None
        tk = device_seconds_per_call(lambda: fk(X))
        ts = device_seconds_per_call(lambda: [single(c) for c in cols], reps=max(4, 100 // k))
        tp = (time_fn(lambda: fp(X), warmup=1, iters=5).median if plain_synced
              else device_seconds_per_call(lambda: fp(X), reps=20))
        tl = None if csr is None else device_seconds_per_call(lambda: csr @ X[:csr.shape[1]])
        bms = bound_of(nbytes, flops)[0] * 1e-3
        print(f"{label}: bit-identical to plain (tol 0), to its repeat and, column by column, "
              f"to the single-column kernel; device {tk * 1e6:.2f} us a launch "
              f"({bms / tk:.1%} of its {bms * 1e6:.2f} us bound, {rate_line(nbytes, tk, peak)}), "
              f"{k} single-column launches {ts * 1e6:.2f} us ({ts / tk:.2f}x), plain "
              f"{tp * 1e6:.2f} us" + ("" if tl is None else
                                      f", torch CSR @ the (n, {k}) block {tl * 1e6:.2f} us")
              + f" {tag}")
        return e, (tk, tp, tl, ts)

    def multi_held(label, res, singles, launched, need, within=1, x_tol=1e-4):
        """A multi-RHS solve against the port's single-vector solves of its
        columns: every column converged, laps within `within` (the rounding
        of r at the stop is of the order of tol), x within `x_tol` of max
        |x|, the k-column kernel `need` launched and no plain version."""
        its = res.iterations.tolist()
        kp = [int(s.iterations) for s in singles]
        require(bool(res.converged.all()) and all(bool(s.converged) for s in singles),
                f"{label}: converged {res.converged.tolist()}")
        require(all(abs(a - c) <= within for a, c in zip(its, kp)),
                f"{label}: laps {its}, single solves {kp}")
        xs = torch.stack([s.x for s in singles], 1)
        scale = float(xs.abs().max())
        e = float((res.x - xs).abs().max())
        require(e <= x_tol * scale, f"{label}: x {e:.3e} from the single solves' "
                                    f"(max {scale:.3e})")
        require(all(launched[w] > 0 for w in need)
                and all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                f"{label}: launches {launched}")
        return its, kp, e / scale

    with phase("M9: multi-RHS, block CG, f64, refinement"):
        t_phase = time.perf_counter()
        # The k-column kernels against their plain versions, k = 1, 3, 8, 32.
        op_dia = DiaOperator.from_dia(poisson3d_dia(128), device=dev)
        npd = op_dia.padded_n
        csr_dia = torch_csr(op_dia.data, op_dia.offsets)
        A_geo, _, _ = random_geometric_spd(100_000, seed=0, avg_degree=12.0)
        wells = {"FEM 300k": (A_fem, WellOperator.from_csr(A_fem, device=dev)),
                 "geometric 100k": (A_geo, WellOperator.from_csr(A_geo, device=dev))}
        m9_times = {}
        err["K6xk"] = err["K8xk"] = err["K13xk"] = 0.0
        for k in (1, 3, 8, 32):
            X = rnd(npd, k)
            e, t = multi_vs_plain(
                f"K6 x {k} Poisson m=128 DIA f32 (n={npd})",
                lambda Z: dia_spmv_multi_cuda(op_dia.data, op_dia.offsets, Z),
                lambda Z: dia_spmv_multi_torch(op_dia.data, op_dia.offsets, Z),
                lambda c: dia_spmv_cuda(op_dia.data, op_dia.offsets, c), X,
                4 * 7 * npd + 8 * npd * k, 14 * npd * k, csr=csr_dia if k == 8 else None)
            err["K6xk"] = max(err["K6xk"], e)
            if k == 8:
                m9_times["K6xk"] = t
                bounds["K6xk"] = bound_of(4 * 7 * npd + 8 * npd * k, 14 * npd * k)
            e, t = multi_vs_plain(
                f"K8 x {k} stencil m=128 (n={npd})", lambda Z: poisson3d_multi_cuda(Z, 128),
                lambda Z: poisson3d_multi_torch(Z, 128), lambda c: poisson3d_cuda(c, 128), X,
                8 * npd * k, 7 * npd * k, csr=csr_dia if k == 8 else None)
            err["K8xk"] = max(err["K8xk"], e)
            if k == 8:
                m9_times["K8xk"] = t
                bounds["K8xk"] = bound_of(8 * npd * k, 7 * npd * k)
            for mm in (2, 33):
                e, _ = multi_vs_plain(f"K8 x {k} stencil m={mm}",
                                      lambda Z: poisson3d_multi_cuda(Z, mm),
                                      lambda Z: poisson3d_multi_torch(Z, mm),
                                      lambda c: poisson3d_cuda(c, mm), rnd(mm ** 3, k), 0, 0,
                                      timed=False)
                err["K8xk"] = max(err["K8xk"], e)
            for label, (A, op) in wells.items():
                nnz, nw = op.rows.cols.numel(), op.padded_n
                nbytes = nnz * 8 + 4 * (nw + 1) + 8 * nw * k
                Xw = rnd(nw, k)
                Xw[A.shape[0]:] = 0.0
                e, t = multi_vs_plain(
                    f"K13 x {k} {label} f32 (n={A.shape[0]}, {nnz} live slots)",
                    lambda Z: well_spmv_multi_cuda(op.rows, Z, nw),
                    lambda Z: well_spmv_multi_torch(op.rows, Z, nw), op.matvec, Xw, nbytes,
                    2 * nnz * k, csr=torch_csr_of(A) if k == 8 else None, plain_synced=True)
                err["K13xk"] = max(err["K13xk"], e)
                if k == 8 and label == "FEM 300k":
                    m9_times["K13xk"] = t
                    bounds["K13xk"] = bound_of(nbytes, 2 * nnz * k)
            del X
        for kid, (tk, tp, tl, _) in m9_times.items():
            times[kid], library[kid] = (tk, tp), tl
        del csr_dia
        print(f"k-column kernels: {time.perf_counter() - t_phase:.1f} s so far")

        # Multi-RHS, k = 8: the dense flagship (B's columns U(0, 1), as the
        # generator draws b), Poisson m = 128 as a stencil and as DIA, and the
        # geometric 100k graph on WELL, each against the port's
        # single-vector solves of its columns.
        kk = 8
        rng = np.random.default_rng(0)
        op_d, bd, x0d, _ = flagship
        B_d = torch.as_tensor(rng.random((op_d.n, kk)).astype(np.float32), device=dev)
        B_p = torch.as_tensor(rng.standard_normal((128 ** 3, kk)).astype(np.float32),
                              device=dev)
        n_geo = A_geo.shape[0]
        B_g = torch.as_tensor(rng.standard_normal((n_geo, kk)).astype(np.float32), device=dev)
        op_p = PoissonOperator(128, device=dev)
        op_g = wells["geometric 100k"][1]
        systems = {
            "dense n=8192 none": (op_d, B_d, dict(tol=1e-6), ()),
            "dense n=8192 jacobi": (op_d, B_d, dict(tol=1e-6, precondition="jacobi"), ()),
            "Poisson m=128 stencil": (op_p, B_p, dict(tol=1e-5 * float(B_p[:, 0].norm()),
                                                      maxiter=poisson_maxiter(128)),
                                      ("poisson3d_multi_cuda",)),
            "Poisson m=128 DIA": (op_dia, B_p, dict(tol=1e-5 * float(B_p[:, 0].norm()),
                                                    maxiter=poisson_maxiter(128)),
                                  ("dia_spmv_multi_cuda",)),
            "geometric 100k WELL": (op_g, B_g, dict(tol=1e-5 * float(B_g[:, 0].norm()),
                                                    maxiter=min(4 * n_geo, 4096)),
                                    ("well_spmv_multi_cuda",)),
        }
        multi_laps = {}
        for label, (op, B, kw, need) in systems.items():
            res, launched = m9_drive(lambda: cg_solve_multi(op, B, **kw))
            singles = [cg_solve(op, B[:, j].contiguous(), **kw) for j in range(kk)]
            its, kp, ex = multi_held(f"multi {label}", res, singles, launched, need)
            multi_laps[label] = max(its)
            t = time_fn(lambda: cg_solve_multi(op, B, **kw), warmup=0, iters=5)
            ts = time_fn(lambda: [cg_solve(op, B[:, j].contiguous(), **kw) for j in range(kk)],
                         warmup=0, iters=5)
            total = sum(c for w, c in launched.items() if c)
            print(f"multi k={kk} {label}: laps {its} (single solves {kp}), x within {ex:.2e} "
                  f"of max |x|; {t.median * 1e3:.3f} ms a solve (min {t.min * 1e3:.3f}), "
                  f"{kk} single solves {ts.median * 1e3:.3f} ms; {total} kernel launches ("
                  + ", ".join(f"{w} {c}" for w, c in sorted(launched.items()) if c) + f") {tag}")
        print(f"multi-RHS: {time.perf_counter() - t_phase:.1f} s so far")

        # Block CG, k = 8, on the same B at tol 1e-5 ||B[:, 0]||: its float64
        # true residual by column within the contract (the poly route's is
        # M^-1/2-weighted: the unweighted one lies within ||M^1/2|| < 3.5 of
        # it for degree 3 on the Laplacian, so it is held to 4 tol).
        def residuals64(op, B, X):
            if isinstance(op, DenseOperator):
                AX = op.A[:op.n, :op.n].double() @ X.double()
            elif isinstance(op, PoissonOperator):
                AX = poisson3d_multi_torch(X.double(), op.m)
            else:
                AX = torch.stack([torch.as_tensor(A_geo.matvec(
                    X[:, j].double().cpu().numpy()), device=dev) for j in range(X.shape[1])], 1)
            return (B.double() - AX).norm(dim=0)

        blocks = {
            "dense n=8192": (op_d, B_d, dict(), (), "dense n=8192 none", 2),
            "Poisson m=128 stencil": (op_p, B_p, dict(maxiter=poisson_maxiter(128)),
                                      ("poisson3d_multi_cuda",), "Poisson m=128 stencil", 2),
            "Poisson m=128 stencil poly": (op_p, B_p, dict(maxiter=poisson_maxiter(128),
                                                           precondition="poly"),
                                           ("poisson3d_multi_cuda",), None, 4),
            "geometric 100k WELL": (op_g, B_g, dict(maxiter=min(4 * n_geo, 4096)),
                                    ("well_spmv_multi_cuda",), "geometric 100k WELL", 2),
        }
        for label, (op, B, kw, need, multi_key, factor) in blocks.items():
            tol = 1e-5 * float(B[:, 0].norm())
            kw = dict(kw, tol=tol)
            res, launched = m9_drive(lambda: cg_solve_block(op, B, **kw))
            require(bool(res.converged.all()) and bool(torch.isfinite(res.x).all()),
                    f"block {label}: converged {res.converged.tolist()}")
            require(all(launched[w] > 0 for w in need)
                    and all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                    f"block {label}: launches {launched}")
            rn = residuals64(op, B, res.x)
            require(bool((rn <= factor * tol).all()),
                    f"block {label}: float64 ||B - A X|| by column {rn.tolist()} > {factor} tol")
            t = time_fn(lambda: cg_solve_block(op, B, **kw), warmup=0, iters=5)
            laps = int(res.iterations)
            beside = "" if multi_key is None else f" (multi's {multi_laps[multi_key]})"
            print(f"block k={kk} {label}: {laps} laps{beside}, float64 ||B - A X|| / tol by "
                  f"column max {float(rn.max()) / tol:.3f} (bound {factor}); "
                  f"{t.median * 1e3:.3f} ms a solve (min {t.min * 1e3:.3f}), "
                  f"{t.median * 1e3 / max(laps, 1):.3f} ms a lap {tag}")
        # The rank-deficient block (duplicate columns) and a zero column.
        for label, B2 in (("duplicate columns", torch.stack([bd, bd], 1)),
                          ("a zero column", torch.stack([torch.zeros_like(bd), bd], 1))):
            res = cg_solve_block(op_d, B2, tol=1e-5 * float(bd.norm()))
            require(bool(res.converged.all()) and bool(torch.isfinite(res.x).all()),
                    f"block {label}: converged {res.converged.tolist()}, finite "
                    f"{bool(torch.isfinite(res.x).all())}")
            print(f"block dense n=8192 {label}: {int(res.iterations)} laps, x finite, "
                  f"converged {res.converged.tolist()}")
        del B_p, B_g
        print(f"block CG: {time.perf_counter() - t_phase:.1f} s so far")

        # Refinement on tpucg's conditioned system: the generator's A shifted
        # down by (n - n/32) I, ~25 laps, tol 1e-5 ||b||.
        n = 8192
        A, b, x0 = generate_spd_system(n, seed=0)
        A = (A - (n - n / 32.0) * np.eye(n, dtype=np.float32)).astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b))
        matvec_cuda.bf16_launches = 0
        res, launched = drive(lambda: cg_solve_ir(A, b, x0, tol=tol, device=dev))
        k16 = matvec_cuda.bf16_launches
        require(bool(res.converged) and float(res.residual_norm) < tol,
                f"IR: converged {bool(res.converged)}, ||r|| {float(res.residual_norm):.3e}")
        require(k16 > 0 and launched["matvec_cuda"] > k16 and launched["dot_cuda"] > 0
                and launched["fused_update_cuda"] > 0
                and all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                f"IR: launches {launched}, K1 with bf16 A {k16}")
        r64 = float(np.linalg.norm(b.astype(np.float64) - A.astype(np.float64)
                                   @ res.x.double().cpu().numpy()))
        op16 = DenseOperator.create(A, dtype=torch.bfloat16, device=dev)
        op32 = DenseOperator.create(A, device=dev)
        del A
        b_d, x0_d = torch.as_tensor(b, device=dev), torch.as_tensor(x0, device=dev)
        mv16, dot16, lap16 = lap_ops(op16, "cuda")

        def ir():
            return ir_loop(op32.matvec, dot16,
                           lambda rhs: cg_loop(mv16, dot16, lap16, rhs, torch.zeros_like(rhs),
                                               tol=3e-2, maxiter=n),
                           b_d, x0_d, tol=tol, max_refine=6)
        s = ir()
        require(int(s.inner_total) == int(res.iterations) and torch.equal(s.x, res.x),
                f"IR: ir_loop's {int(s.inner_total)} laps against cg_solve_ir's "
                f"{int(res.iterations)}")
        plain = cg_solve(op32, b_d, x0_d, tol=tol, maxiter=4 * n)
        require(bool(plain.converged), "IR: the plain f32 solve did not converge")
        t_ir = time_fn(ir, warmup=0, iters=5)
        t_f32 = time_fn(lambda: cg_solve(op32, b_d, x0_d, tol=tol, maxiter=4 * n), warmup=0,
                        iters=5)
        print(f"IR n={n} conditioned (A - (n - n/32) I, tol 1e-5 ||b||): {s.j} rounds, "
              f"{int(res.iterations)} inner laps (K1 with bf16 A {k16} launches, with f32 A "
              f"{launched['matvec_cuda'] - k16}); f32 true ||r|| {float(res.residual_norm):.4e} "
              f"(float64 {r64:.4e}) < tol {tol:.4e}; {t_ir.median * 1e3:.3f} ms a solve (min "
              f"{t_ir.min * 1e3:.3f}); plain f32 cg_solve {int(plain.iterations)} laps, "
              f"{t_f32.median * 1e3:.3f} ms {tag}")
        del op16, op32, lap16, mv16

        # f64: dense n = 8192 at tol 1e-12 and Poisson m = 128, on plain
        # torch ops on the card (no kernel is f64).
        A, b, x0 = generate_spd_system(n, seed=0)
        op64 = DenseOperator.create(A, dtype=torch.float64, device=dev)
        b64, x064 = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (b, x0))
        res, launched = drive(lambda: cg_solve(op64, b64, x064, dtype=torch.float64, tol=1e-12))
        require(res.x.dtype == torch.float64 and res.x.device == dev and bool(res.converged),
                f"f64 dense: {res.x.dtype} on {res.x.device}, converged {bool(res.converged)}")
        require(all(c == 0 for w, c in launched.items() if w.endswith("_cuda")),
                f"f64 dense: a kernel launched: {launched}")
        A64 = op64.A[:n, :n]
        r64 = float((b64 - A64 @ res.x).norm())
        x32 = cg_solve(op_d, bd, x0d).x  # the f32 flagship solve (tol 1e-6)
        r32 = float((b64 - A64 @ x32.double()).norm())
        require(r64 < r32, f"f64 dense: ||b - A x|| {r64:.3e} not below the f32 solve's {r32:.3e}")
        try:
            cg_solve(op64, b64, dtype=torch.float64, kernel="cuda")
            require(False, "f64 with kernel='cuda' did not raise")
        except ValueError as exc:
            require("f64" in str(exc), f"f64 with kernel='cuda': {exc}")
        t64 = time_fn(lambda: cg_solve(op64, b64, x064, dtype=torch.float64, tol=1e-12),
                      warmup=0, iters=5)
        print(f"f64 dense n={n} tol 1e-12: {int(res.iterations)} laps, x float64 on {dev}, "
              f"float64 ||b - A x|| {r64:.3e} (the f32 solve's {r32:.3e}), no kernel launched; "
              f"{t64.median * 1e3:.3f} ms a solve; kernel='cuda' raises {tag}")
        del op64, A64, A
        bp, _ = poisson_rhs(128)
        bp64 = bp.double()
        kw64 = dict(dtype=torch.float64, tol=1e-8 * float(bp64.norm()), maxiter=4000)
        res, launched = drive(lambda: cg_solve(op_p, bp64, **kw64))
        require(res.x.dtype == torch.float64 and bool(res.converged)
                and all(c == 0 for w, c in launched.items() if w.endswith("_cuda")),
                f"f64 Poisson: {res.x.dtype}, converged {bool(res.converged)}, {launched}")
        r64 = float((bp64 - poisson3d_torch(res.x, 128)).norm() / bp64.norm())
        res32 = cg_solve(op_p, bp, tol=1e-5 * float(bp.norm()), maxiter=poisson_maxiter(128))
        r32 = true_residual(op_p, bp, res32.x)
        require(r64 < r32, f"f64 Poisson: {r64:.3e} not below the f32 solve's {r32:.3e}")
        t64 = time_fn(lambda: cg_solve(op_p, bp64, **kw64), warmup=0, iters=5)
        print(f"f64 Poisson m=128 tol 1e-8 ||b||: {int(res.iterations)} laps, float64 "
              f"||b - A x|| / ||b|| {r64:.3e} (the f32 solve's {r32:.3e}), no kernel launched; "
              f"{t64.median * 1e3:.3f} ms a solve {tag}")
        del op_dia, wells, op_g, op_p, bp, bp64
        print(f"M9: {time.perf_counter() - t_phase:.1f} s")

    # M12: the guarded finish of K3 and K2, two-level and multilevel
    # PCG, deflated and recycling CG and MINRES; each path driven once with
    # the counts at 0.
    with phase("M12: guarded finish, two-level, deflation, recycling, MINRES"):
        t_phase = time.perf_counter()

        def median3_ms(fn):
            """(median, min, max) ms of 3 solves, each ended by a synchronize
            (host clock; ``time_fn`` takes 5 or more)."""
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            return sorted(walls)[1], min(walls), max(walls)

        def f32_bits(v):
            """The f32 bits of v; every NaN as one (a NaN sum's payload is the
            hardware's, 0x7fffffff on the card, NumPy's 0x7fc00000)."""
            v = np.float32(float(v))
            return np.int32(-1) if np.isnan(v) else v.view(np.int32)

        # (a) The guarded finish: K3's alpha with p.Ap > 0, == 0, < 0 and
        # NaN; K3's tail with rs_new = r.z > 0, == 0, < 0 and K2's with
        # rs_new = r'.r' > 0 and == 0 (r'.r' is never < 0); each bit for bit
        # its NumPy emulation, its plain version and its repeat.
        vg = rnd(8192)
        vnan = vg.clone()
        vnan[17] = float("nan")
        dots_m12 = {"> 0": (vg, vg), "== 0": (torch.zeros_like(vg), vg), "< 0": (-vg, vg),
                    "NaN": (vnan, vg)}
        rs_m12 = torch.tensor(1.7, device=dev)
        for label, (ua, va) in dots_m12.items():
            pap, al = dot_alpha_cuda(ua, va, rs_m12, True, guard=True)
            again = dot_alpha_cuda(ua, va, rs_m12, True, guard=True)
            d_emu = dot_emulated(ua.cpu().numpy(), va.cpu().numpy())
            require(f32_bits(pap) == f32_bits(d_emu)
                    and f32_bits(al) == f32_bits(alpha_emulated(d_emu, 1.7, 2))
                    and f32_bits(al) == f32_bits(alpha_torch(pap, rs_m12, True, True))
                    and f32_bits(again[0]) == f32_bits(pap) and f32_bits(again[1]) == f32_bits(al),
                    f"guarded K3 alpha, p.Ap {label}: {float(pap)!r} -> {float(al)!r}")
            print(f"guarded K3 alpha, p.Ap {label}: alpha {float(al)!r}, bit-identical to the "
                  "emulation, the plain version and its repeat")

        def m12_tail():
            s = CudaLapTail(dev)
            s.load(torch.tensor(3, dtype=torch.int32), torch.tensor(0.8), torch.tensor(0.9),
                   torch.tensor(False), torch.full((), -1.0, device=dev), 100)
            return s

        plain_lap = LapTail(k=torch.tensor(3, dtype=torch.int32), rsold=torch.tensor(0.8),
                            rslast=torch.tensor(0.9), done=torch.tensor(False),
                            active=torch.tensor(True))
        names_m12 = ("k", "rsold", "rslast", "done", "active", "beta", "step")

        def tail_agrees(s, rr_, rs_new):
            want = lap_tail_emulated(3, 0.8, False, rr_, rs_new, -1.0, 100, True)
            plain = lap_tail_torch(plain_lap, torch.tensor(rr_), torch.tensor(rs_new),
                                   torch.tensor(-1.0), 100, True)
            got = {f: getattr(s, f).cpu() for f in names_m12}
            return all(f32_bits(got[f]) == f32_bits(np.float32(want[f])) for f in names_m12) and \
                all(f32_bits(got[f]) == f32_bits(getattr(plain, f)) for f in names_m12)

        for label, (ua, va) in list(dots_m12.items())[:3]:
            runs = []
            for _ in range(2):
                s = m12_tail()
                s.rr.fill_(0.5)
                out = torch.empty((), device=dev)
                dot_tail_launch(ua, va, scratch_for(ua), out, s.address, cuda_stream(ua),
                                guard=True)
                torch.cuda.synchronize()
                runs.append([f32_bits(getattr(s, f)) for f in names_m12])
                rs_new = dot_emulated(ua.cpu().numpy(), va.cpu().numpy())
                require(f32_bits(out) == f32_bits(rs_new) and tail_agrees(s, 0.5, rs_new),
                        f"guarded K3 tail, rs_new {label}")
            require(runs[0] == runs[1], f"guarded K3 tail, rs_new {label}: repeat")
            print(f"guarded K3 tail, rs_new {label}: beta {float(s.beta)!r}, rsold "
                  f"{float(s.rsold)!r}, bit-identical to the emulation, the plain version and "
                  "its repeat")
        xg, pg_, apg = (rnd(8192) for _ in range(3))
        for label, rg in (("> 0", rnd(8192)), ("== 0", 0.5 * apg)):
            runs = []
            for _ in range(2):
                s = m12_tail()
                xo_, ro_ = xg.clone(), rg.clone()
                fused_update_tail_launch(xo_, ro_, pg_, apg, torch.tensor(0.5, device=dev), xo_,
                                         ro_, scratch_for(xg), s.rr, s.address,
                                         cuda_stream(xg), guard=True)
                torch.cuda.synchronize()
                emu = fused_update_emulated(*(t_.cpu().numpy() for t_ in (xg, rg, pg_, apg)),
                                            np.float32(0.5))
                require(np.array_equal(xo_.cpu().numpy().view(np.int32), emu[0].view(np.int32))
                        and np.array_equal(ro_.cpu().numpy().view(np.int32),
                                           emu[1].view(np.int32))
                        and tail_agrees(s, emu[2], emu[2]), f"guarded K2 tail, rs_new {label}")
                runs.append([f32_bits(getattr(s, f)) for f in names_m12])
            require(runs[0] == runs[1], f"guarded K2 tail, rs_new {label}: repeat")
            print(f"guarded K2 tail, rs_new {label}: r'.r' {float(s.rr)!r}, beta "
                  f"{float(s.beta)!r}, rsold {float(s.rsold)!r}, bit-identical to the emulation, "
                  "the plain version and its repeat")
        lap_us, lap_set = {}, LapOperands(dev, 8192)
        for guard in (False, True):
            for label, call in lap_cases(blas1_module, lap_set, guard=guard).items():
                lap_set.reset()
                lap_us[(label, guard)] = device_seconds_per_call(call) * 1e6
        print("K3/K2 launch cores at n = 8192, device µs a call (queued): " + "; ".join(
            f"{label} {lap_us[(label, False)]:.3f} unguarded, {lap_us[(label, True)]:.3f} "
            "guarded" for label in LAP_CASES) + f" {tag}")

        # (b) Two-level on the FEM 300k system (mesh order, WELL) at tol 1e-3
        # ||b||: --smooth-degree 2 and --coarse-max 256 through the CLI,
        # pipelined through cg_solve; each beside the Jacobi lap route.
        op_f = best_sparse_operator(A_fem, device=dev)
        bd_f = torch.as_tensor(b_fem, device=dev)
        b64_f = b_fem.astype(np.float64)
        nb_f = float(np.linalg.norm(b64_f))
        tol_f = 1e-3 * nb_f

        def fem_true(x):
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            return float(np.linalg.norm(b64_f - A_fem.matvec(x.astype(np.float64))) / nb_f)

        def plain_two_level(tl_):
            if tl_.inner is None:
                return tl_
            return dataclasses.replace(
                tl_, coarse_op=dataclasses.replace(tl_.coarse_op, backend="torch"),
                inner=plain_two_level(tl_.inner))

        op_f_plain = dataclasses.replace(op_f, backend="torch")
        res_j5 = cg_solve(op_f, bd_f, tol=1e-5 * nb_f, maxiter=4000, precondition="jacobi")
        t_j5 = median3_ms(lambda: cg_solve(op_f, bd_f, tol=1e-5 * nb_f, maxiter=4000,
                                           precondition="jacobi"))
        res_j3 = cg_solve(op_f, bd_f, tol=tol_f, maxiter=4000, precondition="jacobi")
        t_j3 = median3_ms(lambda: cg_solve(op_f, bd_f, tol=tol_f, maxiter=4000,
                                           precondition="jacobi"))
        print(f"FEM 300k Jacobi lap route: {int(res_j5.iterations)} laps at tol 1e-5 ||b||, "
              f"{t_j5[0]:.3f} ms a solve; {int(res_j3.iterations)} laps at 1e-3 ||b||, "
              f"{t_j3[0]:.3f} ms (medians of 3, host clock) {tag}")
        with tempfile.TemporaryDirectory() as tmp:
            pa, pb, px = (str(Path(tmp) / f) for f in ("A.mtx", "b.mtx", "x.txt"))
            save_matrix_market(pa, A_fem, symmetric=True)
            save_matrix_market(pb, b_fem)
            for label, flags, build_kw in (
                    ("--smooth-degree 2", ["--smooth-degree", "2"], dict(smooth_degree=2)),
                    ("--coarse-max 256", ["--coarse-max", "256"], dict(coarse_max=256))):
                t0 = time.perf_counter()
                tl_f = build_two_level(A_fem, agg_size=64, npad=op_f.padded_n, device=dev,
                                       **build_kw)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                argv = (["solve", pa, pb, "--two-level", "64", "--tol", repr(tol_f),
                         "--maxiter", "4000", "--output", px] + flags)
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc, launched = drive(lambda: cli.main(argv))
                text = out.getvalue()
                fmt = re.search(r"system size\s+: \d+ x \d+\s+\[([^\]]+)\]", text).group(1)
                laps = int(re.search(r"iterations\s+: (\d+)", text).group(1))
                conv = "converged            : True" in text
                tr = fem_true(load_vector(px, n=A_fem.shape[0]))
                require(rc == (0 if conv else 3), f"two-level {label}: rc {rc}")
                require(tr <= fem_residual_bound,
                        f"two-level {label}: true residual {tr:.3e} > {fem_residual_bound}")
                require(laps % 16 == 0 or laps == 4000,
                        f"two-level {label}: {laps} laps, not at a check boundary")
                require(all(launched[w] > 0 for w in ("well_spmv_cuda", "dot_cuda",
                                                       "fused_update_cuda"))
                        and all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                        f"two-level {label}: launches {launched}")
                ref_f = cg_solve(op_f_plain, bd_f, tol=tol_f, maxiter=4000, kernel="torch",
                                 two_level=plain_two_level(tl_f))
                require(abs(laps - int(ref_f.iterations)) <= 16,
                        f"two-level {label}: {laps} laps, plain route {int(ref_f.iterations)}")
                t_f = median3_ms(lambda: cg_solve(op_f, bd_f, tol=tol_f, maxiter=4000,
                                                  two_level=tl_f))
                stop = "converged" if conv else (
                    "stopped on stagnation" if laps < 4000 else "cut at maxiter")
                print(f"FEM 300k two-level agg 64 {label} [{fmt}, {tl_f.levels} level(s), nc "
                      f"{tl_f.nc}], tol 1e-3 ||b||: {laps} laps, {stop}, float64 ||b - A x|| "
                      f"/ ||b|| {tr:.4e} (bound {fem_residual_bound}); plain route on the card "
                      f"{int(ref_f.iterations)} laps; build_two_level {build_s:.3f} s (host); "
                      f"{t_f[0]:.3f} ms a solve (median of 3; min {t_f[1]:.3f}, max "
                      f"{t_f[2]:.3f}) against Jacobi's {t_j5[0]:.3f} ms "
                      f"({int(res_j5.iterations)} laps); launches: "
                      + ", ".join(f"{w} {c}" for w, c in sorted(launched.items()) if c)
                      + f" {tag}")
        # Pipelined two-level: pipelined CG has no true-residual check and no
        # stagnation exit (tpucg's neither), and its f32 floor grows with the
        # condition (tpucg: ~kappa 1e-7 ||b||). On FEM 300k at 1e-3 ||b|| it
        # runs past the floor and x drifts: shown once, capped at 1,000 laps,
        # not held. Held on the geometric 100k graph (WELL) at 1e-5 ||b||,
        # tpucg's pipelined two-level family (RESULTS.md, kappa ~1e2).
        tl_f = build_two_level(A_fem, agg_size=64, npad=op_f.padded_n, smooth_degree=2,
                               device=dev)
        below = cg_solve(op_f, bd_f, tol=tol_f, maxiter=1000, two_level=tl_f,
                         method="pipelined")
        print(f"FEM 300k two-level agg 64 smooth 2, pipelined, tol 1e-3 ||b|| (below its f32 "
              f"floor): {int(below.iterations)} laps, converged {bool(below.converged)}, "
              f"float64 ||b - A x|| / ||b|| {fem_true(below.x):.4e} (shown, not held)")
        A_g, b_g, _ = random_geometric_spd(100_000, seed=0, avg_degree=12.0)
        op_g = WellOperator.from_csr(A_g, device=dev)
        bd_g = torch.as_tensor(b_g, device=dev)
        b64_g = b_g.astype(np.float64)
        tol_g = 1e-5 * float(np.linalg.norm(b64_g))
        t0 = time.perf_counter()
        tl_g = build_two_level(A_g, agg_size=64, npad=op_g.padded_n, smooth_degree=2,
                               device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kw_g = dict(tol=tol_g, maxiter=2000, two_level=tl_g, method="pipelined")
        res_g, launched = drive(lambda: cg_solve(op_g, bd_g, **kw_g))
        tr = float(np.linalg.norm(b64_g - A_g.matvec(res_g.x.cpu().numpy().astype(np.float64)))
                   / np.linalg.norm(b64_g))
        ref_g = cg_solve(dataclasses.replace(op_g, backend="torch"), bd_g, kernel="torch",
                         **kw_g)
        laps = int(res_g.iterations)
        require(bool(res_g.converged) and tr <= 2e-5,
                f"two-level pipelined geometric: converged {bool(res_g.converged)}, true {tr:.3e}")
        require(abs(laps - int(ref_g.iterations)) <= 1,
                f"two-level pipelined geometric: {laps} laps, plain route {int(ref_g.iterations)}")
        require(all(launched[w] > 0 for w in ("well_spmv_cuda", "dot_cuda"))
                and all(c == 0 for w, c in launched.items() if w.endswith("_torch")),
                f"two-level pipelined geometric: launches {launched}")
        t_g = median3_ms(lambda: cg_solve(op_g, bd_g, **kw_g))
        t_gc = median3_ms(lambda: cg_solve(op_g, bd_g, tol=tol_g, maxiter=2000, two_level=tl_g))
        t_gj = median3_ms(lambda: cg_solve(op_g, bd_g, tol=tol_g, maxiter=2000,
                                           precondition="jacobi"))
        res_gj = cg_solve(op_g, bd_g, tol=tol_g, maxiter=2000, precondition="jacobi")
        print(f"geometric 100k two-level agg 64 smooth 2, pipelined, tol 1e-5 ||b||: {laps} "
              f"laps, converged, float64 ||b - A x|| / ||b|| {tr:.4e}; plain route on the card "
              f"{int(ref_g.iterations)} laps; build_two_level {build_s:.3f} s (host); "
              f"{t_g[0]:.3f} ms a solve (median of 3) against classic two-level "
              f"{t_gc[0]:.3f} ms and the Jacobi lap route {t_gj[0]:.3f} ms "
              f"({int(res_gj.iterations)} laps); launches: "
              + ", ".join(f"{w} {c}" for w, c in sorted(launched.items()) if c) + f" {tag}")
        del op_g, tl_g, tl_f
        print(f"M12 two-level: {time.perf_counter() - t_phase:.1f} s so far")

        # (c) Deflation: the clustered dense n = 4096 system (0.01, 0.02,
        # 0.03 under a [1, 2] bulk; built on the card in float64) with its
        # three slow eigenvectors; then RecyclingCG on FEM 300k with the
        # Chebyshev-smoothed two-level over a smooth sequence of 4 b's.
        nd = 4096
        rng_d = np.random.default_rng(0)
        Qd, _ = torch.linalg.qr(torch.from_numpy(rng_d.standard_normal((nd, nd))).to(dev))
        lam_d = torch.from_numpy(np.concatenate([[0.01, 0.02, 0.03],
                                                 1.0 + rng_d.uniform(0, 1, nd - 3)])).to(dev)
        Ad = (Qd * lam_d) @ Qd.T
        op_d = DenseOperator.create((0.5 * (Ad + Ad.T)).float(), device=dev)
        bd_d = torch.from_numpy(rng_d.standard_normal(nd).astype(np.float32)).to(dev)
        tol_d = 1e-5 * float(bd_d.norm())
        Vd = Qd[:, :3].float()
        res_dp, lp_d = drive(lambda: cg_solve(op_d, bd_d, tol=tol_d, maxiter=4 * nd))
        res_dd, ld_d = drive(lambda: cg_solve_deflated(op_d, bd_d, Vd, tol=tol_d,
                                                       maxiter=4 * nd))
        require(bool(res_dd.converged) and bool(res_dp.converged)
                and int(res_dd.iterations) < int(res_dp.iterations),
                f"deflation dense: {int(res_dd.iterations)} laps against plain "
                f"{int(res_dp.iterations)}")
        require(ld_d["matvec_cuda"] > 0 and ld_d["fused_update_cuda"] > 0
                and all(c == 0 for w, c in ld_d.items() if w.endswith("_torch")),
                f"deflation dense: launches {ld_d}")
        t_dd = median3_ms(lambda: cg_solve_deflated(op_d, bd_d, Vd, tol=tol_d,
                                                    maxiter=4 * nd))
        t_dp = median3_ms(lambda: cg_solve(op_d, bd_d, tol=tol_d, maxiter=4 * nd))
        print(f"deflated CG dense n={nd} clustered (3 slow eigenvectors), tol 1e-5 ||b||: "
              f"{int(res_dd.iterations)} laps ({t_dd[0]:.3f} ms a solve, median of 3) against "
              f"the plain solve's {int(res_dp.iterations)} ({t_dp[0]:.3f} ms; launches "
              + ", ".join(f"{w} {c}" for w, c in sorted(lp_d.items()) if c) + "); deflated "
              "launches " + ", ".join(f"{w} {c}" for w, c in sorted(ld_d.items()) if c)
              + f" {tag}")
        del Ad, op_d
        tl_r = build_two_level(A_fem, agg_size=64, npad=op_f.padded_n, smooth_degree=2,
                               device=dev)
        rec = RecyclingCG(op_f, two_level=tl_r, max_vectors=4, tol=tol_f, maxiter=4000)
        wave = np.sin(2 * np.pi * 3 * np.arange(A_fem.shape[0]) / A_fem.shape[0])
        multi_launches, rec_lines = 0, []
        for step_t in range(4):
            b_t = (b_fem * (1 + 0.25 * np.sin(0.5 * step_t))
                   + 0.05 * step_t * np.abs(b_fem).max() * wave).astype(np.float32)
            t0 = time.perf_counter()
            res_r, lr = drive(lambda: rec.solve(b_t))
            wall = time.perf_counter() - t0
            multi_launches += lr["well_spmv_multi_cuda"]
            tr = float(np.linalg.norm(b_t - A_fem.matvec(res_r.x.cpu().numpy().astype(
                np.float64))) / np.linalg.norm(b_t.astype(np.float64)))
            require(tr <= fem_residual_bound and lr["well_spmv_cuda"] > 0,
                    f"recycling solve {step_t}: true residual {tr:.3e}, launches {lr}")
            rec_lines.append(f"b_{step_t}: {int(res_r.iterations)} laps, "
                             f"{'converged' if bool(res_r.converged) else 'not converged'}, "
                             f"true {tr:.4e}, basis {0 if rec._basis is None else rec._basis.m}, "
                             f"{wall * 1e3:.1f} ms (with the basis rebuild)")
        require(multi_launches > 0, "recycling: K13 x k never ran for the basis")
        print(f"RecyclingCG FEM 300k, two-level agg 64 smooth 2, max_vectors 4, tol 1e-3 ||b||: "
              + "; ".join(rec_lines) + f"; K13 x k launches {multi_launches} {tag}")
        del rec, tl_r
        print(f"M12 deflation: {time.perf_counter() - t_phase:.1f} s so far")

        # (d) MINRES: the dense indefinite n = 4096 system (half its spectrum
        # in [-2, -1]) plain, its badly scaled form (10^U(-1.5, 1.5)) with
        # Jacobi and block Jacobi (bs 128), and the staggered-sign band in
        # DIA form at n = 262,144 (K6): each converged on the true residual,
        # its laps within 1% of the plain route's on the card.
        rng_m = np.random.default_rng(1)
        lam_m = torch.from_numpy(np.concatenate([-(1.0 + rng_m.uniform(0, 1, nd // 2)),
                                                 1.0 + rng_m.uniform(0, 1, nd // 2)])).to(dev)
        Am = (Qd * lam_m) @ Qd.T
        sc = torch.from_numpy(10.0 ** rng_m.uniform(-1.5, 1.5, nd)).to(dev)
        Ams = Am * sc[None, :] * sc[:, None]
        w_b, n_b = 512, 262_144
        data_b = np.zeros((5, n_b), np.float32)
        data_b[[0, 1, 3, 4]] = -1.0
        data_b[2] = np.where((np.arange(n_b) // w_b) % 2 == 0, 5.0, -5.0)
        band = DIAMatrix(data=data_b, offsets=(-w_b, -1, 0, 1, w_b), shape=(n_b, n_b))
        mcases = []
        for label, Amat, pc, rel in (("dense n=4096 indefinite", Am, "none", 1e-4),
                                     ("dense n=4096 scaled, jacobi", Ams, "jacobi", 1e-3),
                                     ("dense n=4096 scaled, block_jacobi bs=128", Ams,
                                      "block_jacobi", 1e-3)):
            op_m = DenseOperator.create((0.5 * (Amat + Amat.T)).float(), device=dev)
            mcases.append((label, op_m, DenseOperator(A=op_m.A, n=op_m.n, backend="torch"), pc,
                           rel, "matvec_cuda", 8 * nd))
        mcases.append(("band DIA n=262144 staggered sign", DiaOperator.from_dia(band, device=dev),
                       DiaOperator.from_dia(band, backend="torch", device=dev), "none", 1e-4,
                       "dia_spmv_cuda", 4000))
        for label, op_m, op_mp, pc, rel, kern, cap in mcases:
            bm = torch.from_numpy(rng_m.standard_normal(op_m.n).astype(np.float32)).to(dev)
            kw_m = dict(tol=rel * float(bm.norm()), maxiter=cap, precondition=pc,
                        pc_block_size=128)
            t0 = time.perf_counter()
            res_m, lm = drive(lambda: minres_solve(op_m, bm, **kw_m))
            wall = time.perf_counter() - t0
            res_mp = minres_solve(op_mp, bm, kernel="torch", **kw_m)
            km, kmp = int(res_m.iterations), int(res_mp.iterations)
            xm = res_m.x.double()
            Ad_m = op_m.A[:op_m.n, :op_m.n].double() if hasattr(op_m, "A") else None
            tr = (float((bm.double() - Ad_m @ xm).norm()) if Ad_m is not None else float(
                (bm.double() - torch.from_numpy(band.matvec(xm.cpu().numpy())).to(dev)).norm()))
            # converged: the solver's f32 true residual under tol; the float64
            # one is printed beside it, held within 2 tol (f32 rounding of A x).
            require(bool(res_m.converged) and tr <= 2 * kw_m["tol"],
                    f"MINRES {label}: converged {bool(res_m.converged)}, true {tr:.3e}")
            require(bool(res_mp.converged) and abs(km - kmp) <= max(1, kmp // 100),
                    f"MINRES {label}: {km} laps, plain route {kmp}")
            require(lm[kern] > 0 and all(c == 0 for w, c in lm.items() if w.endswith("_torch")),
                    f"MINRES {label}: launches {lm}")
            print(f"MINRES {label} ({pc}, tol {rel:g} ||b||): {km} laps, float64 ||b - A x|| "
                  f"{tr:.4e} (tol {kw_m['tol']:.4e}); plain route on the card {kmp} laps; "
                  f"{wall * 1e3:.1f} ms (one solve, host clock); launches: " + ", ".join(
                      f"{w} {c}" for w, c in sorted(lm.items()) if c) + f" {tag}")
        del Am, Ams, Qd, mcases
        print(f"M12: {time.perf_counter() - t_phase:.1f} s")

    # (id, name, key of its launch count, source, the TPU kernel it replaces)
    meta = (
        ("K1", "gemv", "matvec_cuda", "blas.cu", "tpucg/kernels/matvec.py:108"),
        ("K2", "fused_update (+ p_update)", "K2", "blas.cu", "tpucg/kernels/blas1.py:111"),
        ("K3", "dot", "dot_cuda", "blas.cu", "tpucg/kernels/blas1.py:68"),
        ("K4", "fused_cg_solve", "fused_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:234"),
        ("K5", "fused_batch_cg_solve", "fused_batch_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:610"),
        ("K6", "dia_spmv", "dia_spmv_cuda", "sparse.cu", "tpucg/kernels/spmv.py:221"),
        ("K7", "dia_spmv_halo", "dia_spmv_halo_cuda", "sparse.cu", "tpucg/kernels/spmv.py:271"),
        ("K8", "poisson3d", "poisson3d_cuda", "sparse.cu", "tpucg/kernels/stencil.py:152"),
        ("K9", "poisson3d_slab", "poisson3d_slab_cuda", "sparse.cu",
         "tpucg/kernels/stencil.py:126"),
        ("K10", "fused_stencil_cg_solve", "fused_stencil_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:335"),
        ("K11", "fused_dia_cg_solve", "fused_dia_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:493"),
        ("K12", "fused_batch_dia_cg_solve", "fused_batch_dia_cg_solve_cuda", "fused.cu",
         "tpucg/kernels/fused.py:729"),
        ("K13", "well_spmv", "well_spmv_cuda", "gather.cu",
         "tpucg/kernels/gather_spmv.py:97"),
        # K14 is K13's kernel under tpucg's second name: K13's launches.
        ("K14", "well_spmv_fused_gather (K13's kernel)", "well_spmv_cuda", "gather.cu",
         "tpucg/kernels/gather_spmv.py:226"),
        # The k-column forms (M9): tpucg vmaps K6, K8 and K13 over the columns.
        ("K6xk", "dia_spmv_multi (K6 x k, k = 8)", "dia_spmv_multi_cuda", "sparse.cu",
         "tpucg/kernels/spmv.py:221"),
        ("K8xk", "poisson3d_multi (K8 x k, k = 8)", "poisson3d_multi_cuda", "sparse.cu",
         "tpucg/kernels/stencil.py:152"),
        ("K13xk", "well_spmv_multi (K13 x k, k = 8)", "well_spmv_multi_cuda", "gather.cu",
         "tpucg/kernels/gather_spmv.py:97"),
    ) + tuple(
        # The probes' launches: their own drives' counts, under their ids
        # (P7 runs P1's kernel).
        (p.pid, p.name + (" (P1's kernel)" if p.pid == "P7" else ""), p.pid, "probe.cu",
         f"benchmarks/probe_gather.py:{p.line}") for p in pg.PROBES
    )
    # K2's row: its launches and p's update's (the lap's pair) on the main path.
    counts["K2"] = counts["fused_update_cuda"] + counts["p_update_cuda"]
    counts.update(m9_counts)  # the k-column forms: phase 20's solves
    kernels = [
        {"name": f"{kid} {kname}", "route": "cuda",
         "source": f"tpucg_torch/kernels/csrc/{src}", "replaces": replaces,
         "launches": counts[count_key], "max_abs_err": err[kid],
         "ms": times[kid][0] * 1e3, "plain_ms": times[kid][1] * 1e3,
         "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1],
         "library_ms": None if library.get(kid) is None else library[kid] * 1e3}
        for kid, kname, count_key, src, replaces in meta
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
