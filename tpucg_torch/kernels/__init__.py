"""The CG kernels: hand-written CUDA for Hopper (``csrc/``). The lap
kernels' plain PyTorch versions sit beside them; the whole-solve kernels'
run the solver's loops and live in ``tpucg_torch.solver.fused``.

The lap: K1 ``matvec_cuda`` (dense GEMV), K6 ``dia_spmv_cuda`` (DIA
SpMV), K8 ``poisson3d_cuda`` (7-point stencil), K7 ``dia_spmv_halo_cuda``
and K9 ``poisson3d_slab_cuda`` (K6 and K8 on one rank's block of a
distributed solve, with halos), K13 ``well_spmv_cuda``
(WELL SpMV; K14 ``well_spmv_fused_gather`` is the same kernel under
tpucg's second name), the k-column forms K6 x k ``dia_spmv_multi_cuda``,
K8 x k ``poisson3d_multi_cuda`` and K13 x k ``well_spmv_multi_cuda`` (the
multi-RHS and block solves' products), K2 ``fused_update_cuda`` (x/r update and r'.r' in
one pass) with ``p_update_cuda`` (p's update), and K3 ``dot_cuda`` (with
``dot_alpha_cuda``, its alpha mode); each of K2 and K3 is one launch that
can also run the lap's scalar tail (``lap_tail_torch`` is its plain
version). The whole solve: K4
``fused_cg_solve_cuda`` (one dense system, one cooperative launch), K5
``fused_batch_cg_solve_cuda`` (B dense systems, one launch), K10
``fused_stencil_cg_solve_cuda`` (Poisson stencil) and K11
``fused_dia_cg_solve_cuda`` (DIA), both cooperative, and K12
``fused_batch_dia_cg_solve_cuda`` (B banded systems, one launch). The gather
probes P1-P7 of ``benchmarks/probe_gather.py`` (no solve runs them) live in
``tpucg_torch.kernels.probe_gather`` and are imported from there. The
kernel library is built by ``nvcc`` at first use (``_lib``); importing this
package builds nothing.
"""

from tpucg_torch.kernels.blas1 import (
    dot_alpha_cuda,
    dot_alpha_torch,
    dot_cuda,
    dot_torch,
    fused_update,
    fused_update_cuda,
    fused_update_torch,
    lap_tail_torch,
    p_update_cuda,
    p_update_torch,
)
from tpucg_torch.kernels.dispatch import resolve_backend
from tpucg_torch.kernels.fused import (
    FUSED_AUTO_MAX_N,
    FUSED_BATCH_DIA_MAX_N,
    FUSED_BATCH_MAX_N,
    FUSED_MAX_N,
    fused_batch_cg_solve_cuda,
    fused_batch_dia_cg_solve_cuda,
    fused_cg_solve_cuda,
    fused_dia_cg_solve_cuda,
    fused_stencil_cg_solve_cuda,
)
from tpucg_torch.kernels.gather_spmv import (
    well_spmv,
    well_spmv_cuda,
    well_spmv_fused_gather,
    well_spmv_multi,
    well_spmv_multi_cuda,
    well_spmv_multi_torch,
    well_spmv_torch,
)
from tpucg_torch.kernels.matvec import MATVEC_ALIGN, matvec, matvec_cuda, matvec_torch
from tpucg_torch.kernels.spmv import (
    bsr_ell_spmv,
    dia_spmv,
    dia_spmv_cuda,
    dia_spmv_halo,
    dia_spmv_halo_cuda,
    dia_spmv_halo_torch,
    dia_spmv_multi,
    dia_spmv_multi_cuda,
    dia_spmv_multi_torch,
    dia_spmv_torch,
    ell_spmv,
)
from tpucg_torch.kernels.stencil import (
    poisson3d,
    poisson3d_cuda,
    poisson3d_multi,
    poisson3d_multi_cuda,
    poisson3d_multi_torch,
    poisson3d_slab,
    poisson3d_slab_cuda,
    poisson3d_slab_torch,
    poisson3d_torch,
)

__all__ = [
    "dot_alpha_cuda",
    "dot_alpha_torch",
    "dot_cuda",
    "dot_torch",
    "fused_update",
    "fused_update_cuda",
    "fused_update_torch",
    "lap_tail_torch",
    "p_update_cuda",
    "p_update_torch",
    "FUSED_AUTO_MAX_N",
    "FUSED_BATCH_DIA_MAX_N",
    "FUSED_BATCH_MAX_N",
    "FUSED_MAX_N",
    "fused_batch_cg_solve_cuda",
    "fused_batch_dia_cg_solve_cuda",
    "fused_cg_solve_cuda",
    "fused_dia_cg_solve_cuda",
    "fused_stencil_cg_solve_cuda",
    "bsr_ell_spmv",
    "dia_spmv",
    "dia_spmv_cuda",
    "dia_spmv_halo",
    "dia_spmv_halo_cuda",
    "dia_spmv_halo_torch",
    "dia_spmv_multi",
    "dia_spmv_multi_cuda",
    "dia_spmv_multi_torch",
    "dia_spmv_torch",
    "ell_spmv",
    "poisson3d",
    "poisson3d_cuda",
    "poisson3d_multi",
    "poisson3d_multi_cuda",
    "poisson3d_multi_torch",
    "poisson3d_slab",
    "poisson3d_slab_cuda",
    "poisson3d_slab_torch",
    "poisson3d_torch",
    "resolve_backend",
    "MATVEC_ALIGN",
    "matvec",
    "matvec_cuda",
    "matvec_torch",
    "well_spmv",
    "well_spmv_cuda",
    "well_spmv_fused_gather",
    "well_spmv_multi",
    "well_spmv_multi_cuda",
    "well_spmv_multi_torch",
    "well_spmv_torch",
]
