"""K4's resident-A plan (``tpucg_torch.kernels.fused.dense_resident_plan``)
on the CPU: which rows each block owns, which of them it keeps in shared
memory and which it reads through L2, the shared bytes and the grid against
what an H100 holds, and that the plan keeps the one-warp-a-row grid of the
kernel before A was kept on chip wherever it says so. The C launch mirrors
the plan (``csrc/fused.cu`` ``dense_plan``): its constants are read here as
text, and the card test ``test_k4_library_plan_is_dense_resident_plan``
holds the two equal. K4 itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from tpucg_torch.kernels.fused import (
    BATCH_SMS,
    DENSE_BLOCK,
    DENSE_BLOCKS_PER_SM,
    DENSE_MAX_BLOCKS_PER_SM,
    DENSE_MAX_SLOTS,
    DENSE_STATIC_SMEM,
    DENSE_WARPS,
    FUSED_MAX_N,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMEM_RESERVED,
    dense_resident_plan,
    dense_resident_plans,
    fused_cg_solve_cuda,
)

CSRC = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc"
NPADS = list(range(128, FUSED_MAX_N + 1, 128))
# SM counts: the H100 SXM's (the plan's default), the H100 PCIe's, and two
# that cut the grid elsewhere.
SMS = (BATCH_SMS, 114, 80, 16)


def _owners(plan):
    """row -> (block, q) over the grid, each row once."""
    owners = {}
    for b in range(plan.grid):
        for q, row in plan.rows_of(b):
            assert row not in owners, f"row {row} owned twice"
            owners[row] = (b, q)
    return owners


@pytest.mark.parametrize("npad", NPADS)
def test_plan_owns_every_row_once_and_places_it(npad):
    for sms in SMS:
        plans = [dense_resident_plan(npad, sms)] + dense_resident_plans(npad, sms)
        for plan in plans:
            owners = _owners(plan)
            assert sorted(owners) == list(range(npad))
            # Warp w of block b owns rows b 8 + w, + warps, ...; its j-th
            # row is the block's row q = j 8 + w.
            for row, (b, q) in owners.items():
                w, j = q % DENSE_WARPS, q // DENSE_WARPS
                assert row == b * DENSE_WARPS + w + j * plan.warps
            resident = sum(q < plan.resident for _, q in owners.values())
            streamed = sum(q >= plan.resident for _, q in owners.values())
            assert resident == plan.resident_rows and resident + streamed == npad


@pytest.mark.parametrize("npad", NPADS)
def test_plan_fits_the_cards_shared_memory_and_grid(npad):
    for sms in SMS:
        for plan in [dense_resident_plan(npad, sms)] + dense_resident_plans(npad, sms):
            assert plan.smem_bytes + DENSE_STATIC_SMEM <= SMEM_PER_BLOCK
            assert plan.blocks_per_sm <= min(plan.smem_blocks_per_sm, DENSE_MAX_BLOCKS_PER_SM)
            assert plan.grid <= plan.smem_blocks_per_sm * sms
            assert 1 <= plan.grid <= npad // DENSE_WARPS
            assert 0 <= plan.resident <= min(DENSE_MAX_SLOTS, max(len(plan.rows_of(b))
                                                                  for b in range(plan.grid)))
            # One more resident row a block would not fit its share.
            top = dense_resident_plan(npad, sms, blocks_per_sm=plan.blocks_per_sm)
            assert top.resident >= plan.resident
            if top.resident < min(DENSE_MAX_SLOTS, len(top.rows_of(0))):
                with pytest.raises(ValueError, match="resident rows a block"):
                    dense_resident_plan(npad, sms, blocks_per_sm=plan.blocks_per_sm,
                                        resident=top.resident + 1)


@pytest.mark.parametrize("npad", NPADS)
def test_plan_keeps_todays_grid_where_all_rows_fit(npad):
    plan = dense_resident_plan(npad)
    # On an H100 every npad <= 2048 keeps the one-warp-a-row grid with all
    # of each block's rows in shared memory: x, k and r.r keep their bits.
    if npad <= 2048:
        assert plan.today and plan.grid == npad // DENSE_WARPS
        assert plan.resident_rows == npad and plan.resident == DENSE_WARPS
    else:
        assert not plan.today and plan.blocks_per_sm == DENSE_BLOCKS_PER_SM
        assert 0 < plan.resident_rows < npad
    assert plan.today == (plan.grid == npad // DENSE_WARPS)


def test_plan_at_4096_on_an_h100():
    plan = dense_resident_plan(4096)
    assert (plan.blocks_per_sm, plan.grid, plan.resident) == (2, 264, 6)
    assert plan.resident_rows == 1584 and plan.smem_bytes == 114736
    assert "grid changed" in plan.describe()


def test_plan_refuses_what_k4_cannot_run():
    for npad in (0, 64, 200, FUSED_MAX_N + 128):
        with pytest.raises(ValueError, match="K4 cannot plan"):
            dense_resident_plan(npad)
    for bps in (0, DENSE_MAX_BLOCKS_PER_SM + 1):
        with pytest.raises(ValueError, match="blocks an SM"):
            dense_resident_plan(1024, blocks_per_sm=bps)
    with pytest.raises(ValueError, match="resident rows a block"):
        dense_resident_plan(1024, resident=-1)


def test_forced_plan_on_cpu_tensors_needs_the_card():
    v = torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_cg_solve_cuda(torch.eye(128), v, v, tol=1e-6, maxiter=4, _plan=(1, 8))


def test_plan_constants_are_the_kernels():
    src = (CSRC / "fused.cu").read_text()
    header = (CSRC / "blas.cuh").read_text()
    assert re.search(rf"constexpr int kBlock = {DENSE_BLOCK};", header)
    assert re.search(rf"constexpr int kFusedMaxN = {FUSED_MAX_N};", header)
    assert "constexpr int kWarps = kBlock / 32;" in src
    for name, value in (("kSmemPerSm", SMEM_PER_SM), ("kSmemPerBlock", SMEM_PER_BLOCK),
                        ("kSmemReserved", SMEM_RESERVED), ("kDenseStatic", DENSE_STATIC_SMEM),
                        ("kDenseBlocksPerSm", DENSE_BLOCKS_PER_SM),
                        ("kDenseMaxSlots", DENSE_MAX_SLOTS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kDenseMaxBlocksPerSm = 2048 / kBlock;" in src
    assert DENSE_MAX_BLOCKS_PER_SM == 2048 // DENSE_BLOCK
    # The plan's arithmetic, term by term.
    assert "return 16 * ((slots + 1) / 2) + 4 * n * (1 + slots);" in src
    assert "const long long share = kSmemPerSm / blocks_per_sm - kSmemReserved;" in src
    assert "return (share < kSmemPerBlock ? share : kSmemPerBlock) - kDenseStatic;" in src
    assert "long long most = kWarps * ((n + warps - 1) / warps);" in src
    assert "while (fit < most && dense_smem(n, fit + 1) <= budget) ++fit;" in src
    # The kernel's layout: mbarriers, the staged input, the resident rows;
    # row q = j kWarps + warp of a block resident when q < slots.
    assert "float* vs = reinterpret_cast<float*>(dense_smem4 + (slots + 1) / 2);" in src
    assert "for (int row = gwarp, q = warp; row < n; row += nwarps, q += kWarps) {" in src
    assert "if (q < slots) {" in src
    # No setting outlives the launch: no persisting-L2 carve-out, no access
    # policy window; the rows' evict_last lines are put back to normal.
    for banned in ("cudaLimitPersistingL2CacheSize", "accessPolicyWindow",
                   "cudaStreamSetAttribute", "atomicAdd"):
        assert banned not in src, banned
    assert "applypriority.global.L2::evict_normal" in src
