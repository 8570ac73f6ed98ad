"""K11's tile plan (``tpucg_torch.kernels.fused.dia_tile_plan``) on the CPU:
the near/far split of a DIA matrix's offsets, the window each tile stages in
shared memory, the tiles each block owns, and the shared bytes; and the plain
K11 against tpucg's Pallas K11 on a band with far offsets. K11 itself runs
only on the card (``tests/test_torch_cuda.py``).

Tolerances of the parity test are ``test_torch_fused_sparse.py``'s (tpucg's
fused-against-lap bounds): laps within one, x within 1e-3 of max |x|, and
r.r below tol^2.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg.sparse.formats as jfmt
from _torch_helpers import BAND_SETS, FAR_BAND, FAR_BAND_N, k11_edge_npads, random_banded_dia
from tpucg.kernels.fused import fused_dia_cg_solve_pallas
from tpucg.kernels.fused import fused_dia_supported as tpucg_fused_dia_supported
from tpucg.solver.operators import DiaOperator as JDiaOperator
from tpucg_torch.io.generator import poisson3d_dia
from tpucg_torch.kernels.fused import (
    DIA_TILE_HALO,
    DIA_TILE_ROWS,
    FUSED_DIA_MAX_N,
    dia_tile_plan,
    fused_dia_cg_solve_cuda,
)
from tpucg_torch.solver.fused import fused_dia_cg_solve_torch
from tpucg_torch.solver.operators import DiaOperator
from tpucg_torch.sparse.formats import DIAMatrix

CPU = torch.device("cpu")
FUSED_CU = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc" / "fused.cu"

# The card's shared memory (hopper-kernels: H100 SXM): 227 KB a block may
# take, 228 KB an SM, 1 KB of it kept by the runtime for each resident
# block; a block takes 48 KB without asking.
BLOCK_SMEM_MAX = 232_448
SM_SMEM = 233_472
SMEM_DEFAULT = 48 * 1024
BLOCK_RESERVED = 1024
THREADS = 256        # K11's block (csrc/blas.cuh kBlock)
SM_THREADS = 2048    # threads an SM holds at once
STATIC_SMEM = 33 * 4  # cg_recurrence's reduction buffer
MAX_GRID = 4096      # csrc/fused.cu kSparseMaxGrid

# (npad, offsets) of each case: the Poisson matrix at m = 16 and 128, tpucg's
# fused DIA band sets, the far band, one diagonal and 64.
CASES = {
    "poisson16": (16 ** 3, tuple(int(o) for o in poisson3d_dia(16).offsets)),
    "poisson128": (128 ** 3, (-16384, -128, -1, 0, 1, 128, 16384)),
    **{name: (1024, offs) for name, offs in BAND_SETS.items()},
    "far": (100_096, FAR_BAND),
    "one_diagonal": (1000, (0,)),
    "one_off_diagonal": (1000, (3,)),
    "64_diagonals": (70_000, tuple(range(-32, 32))),
    "64_wide": (70_000, tuple(range(-2048, 2048, 64))),
}


def _grids(npad):
    """Grids a launch could take: the card's occupancy times 132 SMs (1 to 8
    blocks an SM), a few odd ones, all under the kernel's caps."""
    cap = min(-(-npad // THREADS), MAX_GRID)
    return sorted({min(g, cap) for g in (1, 3, 7, 132, 264, 528, 1056)})


@pytest.mark.parametrize("case", list(CASES))
def test_plan_splits_every_offset_into_near_or_far(case):
    npad, offsets = CASES[case]
    plan = dia_tile_plan(npad, offsets)
    assert plan.tile == DIA_TILE_ROWS and plan.halo == DIA_TILE_HALO
    assert not set(plan.near) & set(plan.far)
    assert sorted(plan.near + plan.far) == sorted(offsets)
    assert plan.near == tuple(o for o in offsets if o in plan.near)  # offsets order
    assert all(abs(o) <= plan.halo for o in plan.near)
    assert all(abs(o) > plan.halo for o in plan.far)
    # The window spans the near offsets and 0, and no far one.
    assert plan.lo == min(plan.near + (0,)) and plan.hi == max(plan.near + (0,))
    assert -plan.halo <= plan.lo <= 0 <= plan.hi <= plan.halo
    assert all(o < plan.lo or o > plan.hi for o in plan.far)


def test_plan_of_the_poisson_matrix_stages_the_grid_neighbours():
    plan = dia_tile_plan(*CASES["poisson128"])
    assert plan.near == (-128, -1, 0, 1, 128) and plan.far == (-16384, 16384)
    assert (plan.lo, plan.hi) == (-128, 128)
    # Up to m = 1024 the window holds +-m, and +-m^2 is far.
    m = 1024
    plan = dia_tile_plan(m ** 3, (-m * m, -m, -1, 0, 1, m, m * m))
    assert (plan.lo, plan.hi) == (-m, m) and plan.far == (-m * m, m * m)


@pytest.mark.parametrize("case", list(CASES))
def test_tiles_partition_the_rows_and_windows_cover_the_near_columns(case):
    npad, offsets = CASES[case]
    plan = dia_tile_plan(npad, offsets)
    for grid in _grids(npad):
        tiles = list(plan.tiles(grid))
        assert len(tiles) == plan.ntiles
        # In row order, contiguous, dealt to the blocks in turn, at most a
        # tile each and all full but the last.
        assert tiles[0][1] == 0 and tiles[-1][2] == npad
        assert all(a[2] == b[1] for a, b in zip(tiles, tiles[1:]))
        for k, (blk, t0, t1) in enumerate(tiles):
            assert blk == k % grid and t0 == k * plan.tile
            assert t1 - t0 == plan.tile or k == len(tiles) - 1
            # Every near column of every row lies in the staged window.
            lo_col = t0 + min(plan.near, default=0)
            hi_col = t1 - 1 + max(plan.near, default=0)
            assert t0 + plan.lo <= lo_col and hi_col < t1 + plan.hi
            assert (t1 - t0) + plan.hi - plan.lo <= plan.smem_bytes // 4


def test_edge_lengths_leave_a_partial_tile_and_blocks_with_no_row_or_three_tiles():
    # The card test's lengths, for any grid the card's occupancy gives.
    for grid in (132 * k for k in range(1, 9)):
        few, wrap = (dia_tile_plan(n, BAND_SETS["cross_row"]) for n in k11_edge_npads(grid))
        for plan in (few, wrap):
            assert min(-(-plan.npad // THREADS), MAX_GRID) >= grid  # the cap leaves the grid
            last = list(plan.tiles(grid))[-1]
            assert last[2] - last[1] < plan.tile  # a partial last tile
        owned = [sum(1 for blk, _, _ in p.tiles(grid) if blk == b) for p in (few, wrap)
                 for b in range(grid)]
        assert min(owned[:grid]) == 0 and max(owned[:grid]) == 1
        assert sorted(set(owned[grid:])) == [2, 3]


def test_shared_bytes_fit_the_block_and_leave_occupancy_to_the_threads():
    plan = dia_tile_plan(*CASES["poisson128"])
    assert plan.smem_bytes == 4 * (DIA_TILE_ROWS + 2 * DIA_TILE_HALO)
    # Under 48 KB (no opt-in needed), under the block's cap, and eight
    # blocks (the SM's thread limit at 256 threads) fit an SM at once.
    block = plan.smem_bytes + STATIC_SMEM
    assert block <= SMEM_DEFAULT <= BLOCK_SMEM_MAX
    assert (SM_THREADS // THREADS) * (block + BLOCK_RESERVED) <= SM_SMEM
    assert DIA_TILE_ROWS % (2 * THREADS) == 0 and DIA_TILE_HALO >= 1024
    # The same for every plan: the window is fixed.
    assert {dia_tile_plan(*c).smem_bytes for c in CASES.values()} == {plan.smem_bytes}


def test_plan_constants_are_the_kernels():
    src = FUSED_CU.read_text()
    assert re.search(rf"constexpr int kDiaTileRows = {DIA_TILE_ROWS};", src)
    assert re.search(rf"constexpr int kDiaHalo = {DIA_TILE_HALO};", src)
    assert "lo < -kDiaHalo || hi > kDiaHalo" in src  # the launch checks the window


# What the plan refuses: no diagonal, more than 64, a length outside
# [1, FUSED_DIA_MAX_N]. The wrapper refuses the same before it needs a card.
REFUSED = {
    "no_diagonal": (512, ()),
    "65_diagonals": (512, tuple(range(65))),
    "empty": (0, (0,)),
    "too_long": (FUSED_DIA_MAX_N + 1, (0,)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_plan_refuses(case):
    npad, offsets = REFUSED[case]
    with pytest.raises(ValueError, match="cannot plan"):
        dia_tile_plan(npad, offsets)
    data = torch.zeros(1, 1).expand(len(offsets), npad)  # a view: nothing allocated
    v = torch.zeros(1).expand(npad)
    with pytest.raises(ValueError, match="unsupported"):
        fused_dia_cg_solve_cuda(data, offsets, v, v, tol=1e-6, maxiter=4)


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_plans_what_the_plan_takes_then_needs_the_card(case):
    npad, offsets = CASES[case]
    if npad > 200_000:
        npad = 4096  # the same offsets; no larger tensor needed on the CPU
    data = torch.zeros(1, 1).expand(len(offsets), npad)
    v = torch.zeros(1).expand(npad)
    dia_tile_plan(npad, offsets)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_dia_cg_solve_cuda(data, offsets, v, v, tol=1e-6, maxiter=4)


def _far_band():
    offsets, data, b = random_banded_dia(FAR_BAND_N, FAR_BAND, seed=7)
    return DIAMatrix(offsets=np.asarray(offsets), data=data,
                     shape=(FAR_BAND_N, FAR_BAND_N)), b


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_k11_matches_tpucg_pallas_on_the_far_band(pc, dtype):
    dia, b = _far_band()
    jop = JDiaOperator.from_dia(
        jfmt.DIAMatrix(offsets=dia.offsets, data=dia.data, shape=dia.shape), backend="pallas",
        storage_dtype=jnp.bfloat16 if dtype == "bf16" else np.float32)
    op = DiaOperator.from_dia(
        dia, storage_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32, device=CPU)
    n, npad = op.n, op.padded_n
    assert tpucg_fused_dia_supported(npad, tuple(int(o) for o in dia.offsets),
                                     2 if dtype == "bf16" else 4)
    assert dia_tile_plan(npad, op.offsets).far == (-40_000, 40_000)
    rng = np.random.default_rng(8)
    x0 = np.zeros(npad, np.float32)
    x0[:n] = 0.1 * rng.standard_normal(n)
    bp = np.zeros(npad, np.float32)
    bp[:n] = b
    tol = 1e-6
    kw = dict(tol=tol, maxiter=4 * npad, precondition=pc, poly_degree=3 if pc == "poly" else 0)
    jx, jk, _ = fused_dia_cg_solve_pallas(jop.data, jop.offsets, jnp.asarray(bp),
                                          jnp.asarray(x0), **kw)
    x, k, rr = fused_dia_cg_solve_torch(op.data, op.offsets, torch.from_numpy(bp),
                                        torch.from_numpy(x0), **kw)
    got, want = x.numpy()[:n].astype(np.float64), np.asarray(jx)[:n].astype(np.float64)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert abs(int(k) - int(jk)) <= 1 and float(rr) < tol ** 2
