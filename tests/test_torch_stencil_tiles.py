"""K10's tile plan (``tpucg_torch.kernels.fused.stencil_tile_plan``) on the
CPU: the near/far split of the 7-point Laplacian's neighbour offsets, the
window each tile stages in shared memory, the tiles each block owns and the
shared bytes; and K10's matvec emulated with NumPy (window and far columns,
summed in K8's order in float32), bit-equal to the plain
stencil and to tpucg's. K10 itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.io.generator import poisson3d_dia
from tpucg_torch.kernels.fused import (
    DIA_TILE_HALO,
    DIA_TILE_ROWS,
    FUSED_STENCIL_MAX_M,
    fused_stencil_cg_solve_cuda,
    stencil_offsets,
    stencil_tile_plan,
)
from tpucg_torch.kernels.stencil import poisson3d_torch

FUSED_CU = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc" / "fused.cu"

# The card's shared memory (hopper-kernels: H100 SXM): 228 KB an SM, 1 KB of
# it kept by the runtime for each resident block; a block takes 48 KB
# without asking.
SM_SMEM = 233_472
SMEM_DEFAULT = 48 * 1024
BLOCK_RESERVED = 1024
THREADS = 256        # K10's block (csrc/blas.cuh kBlock)
MIN_BLOCKS = 4       # csrc/fused.cu kDiaMinBlocks: K10's launch bounds
STATIC_SMEM = 33 * 4  # cg_recurrence's reduction buffer
MAX_GRID = 4096      # csrc/fused.cu kSparseMaxGrid

# Grid edges: the smallest, the card tests' and the gate table's, the
# near/far switch of +-m^2 (32 / 33) and of +-m (1024 / 1025), the largest.
MS = (2, 10, 16, 24, 32, 33, 128, 192, 1024, 1025, 1280)
GRIDS = (1, 2, 3, 7, 132, 264, 528, 1056)


def _grids(n):
    """Grids a launch could take (the card's occupancy times 132 SMs at 1 to
    8 blocks an SM, a few odd ones), under the kernel's caps."""
    cap = min(-(-n // THREADS), MAX_GRID)
    return sorted({min(g, cap) for g in GRIDS})


@pytest.mark.parametrize("m", MS)
def test_plan_splits_every_offset_into_near_or_far(m):
    plan = stencil_tile_plan(m)
    assert plan.npad == m ** 3 and plan.offsets == stencil_offsets(m)
    assert plan.tile == DIA_TILE_ROWS and plan.halo == DIA_TILE_HALO
    assert not set(plan.near) & set(plan.far)
    assert sorted(plan.near + plan.far) == sorted(plan.offsets)
    assert {-1, 0, 1} <= set(plan.near)
    # +-m^2 is near exactly when m <= 32, +-m exactly when m <= 1024.
    assert ({m * m, -m * m} <= set(plan.near)) == (m <= 32)
    assert ({m * m, -m * m} <= set(plan.far)) == (m > 32)
    assert ({m, -m} <= set(plan.near)) == (m <= 1024)
    assert ({m, -m} <= set(plan.far)) == (m > 1024)
    # The window is symmetric and ends at the largest near offset, which
    # the launch checks against 1, m and m^2.
    hi = m * m if m <= 32 else m if m <= 1024 else 1
    assert (plan.lo, plan.hi) == (-hi, hi) and hi <= plan.halo
    assert all(o < plan.lo or o > plan.hi for o in plan.far)


@pytest.mark.parametrize("m", (2, 10, 33))
def test_offsets_are_the_poisson_dia_matrixs(m):
    assert tuple(int(o) for o in poisson3d_dia(m).offsets) == stencil_offsets(m)


@pytest.mark.parametrize("m", MS)
def test_tiles_partition_the_rows_and_windows_cover_every_near_neighbour(m):
    plan = stencil_tile_plan(m)
    n, T = plan.npad, plan.tile
    window = plan.smem_bytes // 4
    for grid in _grids(n):
        # The first tiles one by one, then all of them as arrays.
        first = list(itertools.islice(plan.tiles(grid), 2 * grid + 1))
        for k, (blk, t0, t1) in enumerate(first):
            assert (blk, t0, t1) == (k % grid, k * T, min((k + 1) * T, n))
        tiles = np.array(list(plan.tiles(grid)) if n <= 10 ** 8 else [], dtype=np.int64)
        if n > 10 ** 8:  # 1024^3 and up: the generator's formula, vectorised
            k = np.arange(plan.ntiles, dtype=np.int64)
            tiles = np.stack([k % grid, k * T, np.minimum((k + 1) * T, n)], axis=1)
        blk, t0, t1 = tiles.T
        assert len(tiles) == plan.ntiles == -(-n // T)
        # In row order, contiguous, dealt to the blocks in turn, all full but
        # the last.
        assert t0[0] == 0 and t1[-1] == n and np.array_equal(t1[:-1], t0[1:])
        assert np.array_equal(blk, np.arange(len(tiles)) % grid)
        assert np.all(t1[:-1] - t0[:-1] == T) and 0 < t1[-1] - t0[-1] <= T
        # Every near neighbour of every row of every tile lies in its window
        # [t0 + lo, t1 + hi), and the window fits the fixed buffer.
        assert np.all(t0 + min(plan.near) >= t0 + plan.lo)
        assert np.all(t1 - 1 + max(plan.near) < t1 + plan.hi)
        assert np.all(t1 - t0 + plan.hi - plan.lo <= window)
    # A tile longer than its block's threads has whole pairs of rows.
    assert T % (2 * THREADS) == 0


def test_partial_last_tile_and_blocks_with_no_tile():
    # m = 101: 1,030,301 rows, a partial last tile (the card test's case).
    plan = stencil_tile_plan(101)
    last = list(plan.tiles(528))[-1]
    assert 0 < last[2] - last[1] < plan.tile
    # m = 10: one tile, so every block but the first owns none.
    assert list(stencil_tile_plan(10).tiles(4)) == [(0, 0, 1000)]


def test_shared_bytes_fit_a_block_at_four_blocks_an_sm():
    sizes = {stencil_tile_plan(m).smem_bytes for m in MS}
    assert sizes == {4 * (DIA_TILE_ROWS + 2 * DIA_TILE_HALO)}  # fixed: one occupancy count
    block = sizes.pop() + STATIC_SMEM
    assert block <= SMEM_DEFAULT  # no opt-in needed
    assert MIN_BLOCKS * (block + BLOCK_RESERVED) <= SM_SMEM
    # The thread limit (8 blocks of 256), not shared memory, caps the SM.
    assert (2048 // THREADS) * (block + BLOCK_RESERVED) <= SM_SMEM


def test_plan_constants_are_the_kernels():
    src = FUSED_CU.read_text()
    assert re.search(rf"constexpr int kDiaTileRows = {DIA_TILE_ROWS};", src)
    assert re.search(rf"constexpr int kDiaHalo = {DIA_TILE_HALO};", src)
    assert re.search(rf"constexpr int kDiaMinBlocks = {MIN_BLOCKS};", src)
    assert re.search(rf"constexpr int kSparseMaxGrid = {MAX_GRID};", src)
    assert re.search(r"__launch_bounds__\(kBlock, kDiaMinBlocks\)\s*\n"
                     r"fused_stencil_cg_kernel\(", src)
    # The launch checks the window and gives the occupancy query and the
    # launch the same shared bytes.
    assert "lo != -hi || hi > kDiaHalo" in src
    assert "(hi != 1 && hi != m && hi != m * m)" in src
    assert re.search(r"coop_grid\(\(const void\*\)fused_stencil_cg_kernel, kDiaSmem,", src)
    assert "coop_launch((const void*)fused_stencil_cg_kernel, grid, kDiaSmem," in src
    # The grid-stride policy is gone.
    assert "StrideRows" not in src and "struct StencilOp" not in src


@pytest.mark.parametrize("m", (-3, 0, 1, FUSED_STENCIL_MAX_M + 1))
def test_wrapper_refuses_an_m_it_cannot_run(m):
    with pytest.raises(ValueError, match="cannot plan"):
        stencil_tile_plan(m)
    v = torch.zeros(1).expand(max(m, 0) ** 3)  # a view: nothing allocated
    with pytest.raises(ValueError, match=r"needs 2 <= m <="):
        fused_stencil_cg_solve_cuda(v, v, m, tol=1e-6, maxiter=4)


@pytest.mark.parametrize("m", MS)
def test_wrapper_plans_what_the_plan_takes_then_needs_the_card(m):
    v = torch.zeros(1).expand(m ** 3)
    stencil_tile_plan(m)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_stencil_cg_solve_cuda(v, v, m, tol=1e-6, maxiter=4)


def emulate_k10_matvec(v: np.ndarray, m: int) -> np.ndarray:
    """K10's matvec as ``StencilTileOp`` reads it: for each tile the window
    [t0 + lo, t1 + hi) of v (0 outside [0, n)), near neighbours from the
    window, far ones from v at an index clamped into [0, n), each selected
    as +0 outside the grid, summed in K8's order (x+1, x-1, y+1, y-1, z+1,
    z-1) in float32."""
    plan = stencil_tile_plan(m)
    n, mm, lo, hi = m ** 3, m * m, plan.lo, plan.hi
    y = np.empty(n, np.float32)
    zero = np.float32(0)
    for _, t0, t1 in plan.tiles(1):
        base = t0 + lo
        cols = np.arange(base, t1 + hi)
        win = np.where((cols >= 0) & (cols < n), v[np.clip(cols, 0, n - 1)], zero)
        i = np.arange(t0, t1)
        ix, rem = i // mm, i % mm
        iy, iz = rem // m, rem % m

        def col(off):
            if lo <= off <= hi:
                return win[i + off - base]
            return v[np.clip(i + off, 0, n - 1)]

        acc = np.float32(6) * win[i - base]
        for off, inside in ((mm, ix < m - 1), (-mm, ix > 0), (m, iy < m - 1), (-m, iy > 0),
                            (1, iz < m - 1), (-1, iz > 0)):
            acc = acc - np.where(inside, col(off), zero)
        y[t0:t1] = acc
    return y


@pytest.mark.parametrize("m", (10, 32, 33))
def test_emulated_matvec_equals_the_plain_stencil_bit_for_bit(m):
    rng = np.random.default_rng(m)
    v = rng.standard_normal(m ** 3).astype(np.float32)
    y = emulate_k10_matvec(v, m)
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, poisson3d_torch(torch.from_numpy(v), m).numpy())
    np.testing.assert_array_equal(y, np.asarray(JPoissonOperator(m=m)._matvec_xla(v)))
    # Signed zeros keep their bits: the corner row 0 is -0 with +0 at its
    # three in-grid neighbours, so its sum stays -0 only if each neighbour
    # outside the grid subtracts +0.
    v[rng.integers(0, m ** 3, 64)] = -0.0
    v[0], v[1], v[m], v[m * m] = -0.0, 0.0, 0.0, 0.0
    w = emulate_k10_matvec(v, m)
    want = poisson3d_torch(torch.from_numpy(v), m).numpy()
    assert np.signbit(want[0]) and want[0] == 0
    np.testing.assert_array_equal(w.view(np.uint32), want.view(np.uint32))
