"""K12's warps-a-system layout on the CPU: its plan
(``tpucg_torch.kernels.fused.batch_dia_warps_plan``) and, in float32 NumPy,
its reductions and whole solve.

K12 runs each banded system on W warps and keeps the sums of the one-block
kernel before it through virtual threads: the G = 32 W / VW lanes of a
virtual warp take its virtual lanes g, g + G, ..., run the shuffle-down
tree's steps of offset G and more in registers and the rest across lanes.
Here that order (``batch_dia_warps_sum``) is held bit for bit to the
one-block order (``batch_dia_sum``), for every W and size, and the whole
solve's emulation (``batch_dia_cg_emulated``, which the card test and
``chip_smoke.py`` hold K12 to bit for bit) to the plain version. The C
launch mirrors the plan (``csrc/fused.cu`` ``batch_dia_plan``): its
constants are read here as text; the card test
``test_k12_library_plan_is_batch_dia_warps_plan`` holds the two equal.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import (
    _tree32,
    banded_battery,
    batch_dia_cg_emulated,
    batch_dia_partials,
    batch_dia_sum,
    batch_dia_warps_sum,
    fma32,
    scaled_err,
)
from tpucg_torch.kernels.fused import (
    BATCH_DIA_BLOCK,
    BATCH_DIA_DEFAULT_WARPS,
    BATCH_DIA_SLOTS,
    BATCH_DIA_WARPS,
    FUSED_BATCH_DIA_MAX_N,
    SMEM_PER_BLOCK,
    batch_dia_warps_plan,
    fused_batch_dia_cg_solve_cuda,
)
from tpucg_torch.solver.fused import fused_batch_dia_cg_solve_torch

CSRC = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc"
NPADS = (128, 256, 1024, 2048, 14464)
CASES = [(n, w) for n in NPADS for w in BATCH_DIA_WARPS if w <= min(n, 1024) // 32]


def _terms(n, kind, seed):
    """Row terms as K12 sums them: r.r (fma of r by itself), p.Ap and r.z
    (fma of two vectors) or jacobi's r (m r) added as they are."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    if kind == "square":
        return a, a
    if kind == "product":
        return a, (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    return a, None


@pytest.mark.parametrize("n,warps", CASES)
@pytest.mark.parametrize("kind", ["square", "product", "added"])
def test_warps_order_is_the_one_block_order_bit_for_bit(n, warps, kind):
    for seed in range(3):
        partials = batch_dia_partials(*_terms(n, kind, seed))
        assert batch_dia_warps_sum(partials, warps) == batch_dia_sum(partials)


@pytest.mark.parametrize("n", [1024, 2048])
def test_a_lane_taking_neighbouring_virtual_lanes_would_differ(n):
    """The test above has teeth: a lane that took virtual lanes 4g ... 4g +
    3 (W = 4) would join them first, against the tree's pairs 16 apart, and
    round otherwise on some inputs."""
    differ = 0
    for seed in range(20):
        partials = batch_dia_partials(*_terms(n, "product", seed))
        vw = partials.shape[0] // 32
        own = _tree32(partials.reshape(vw, 4, 8))  # 8 neighbouring virtual lanes a lane
        slots = np.zeros(32, np.float32)
        slots[:vw] = _tree32(own)
        differ += np.float32(_tree32(slots)) != batch_dia_sum(partials)
    assert differ > 0


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    for _ in range(3000):
        a, b, c = (rng.standard_normal(3) * 10.0 ** rng.integers(-4, 4, 3)).astype(np.float32)
        exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        got = fma32(a, b, c)
        lo, hi = np.nextafter(got, np.float32(-np.inf)), np.nextafter(got, np.float32(np.inf))
        err = abs(Fraction(float(got)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact) and err <= abs(Fraction(float(hi)) - exact)
    # 24929 * 673 = 2^24 + 1, the midpoint of 2^24 and 2^24 + 2; + 2^-40 is
    # lost in float64, whose sum is that tie (to even: 2^24), but it breaks
    # the tie for a single rounding (2^24 + 2).
    a, b, c = np.float32(24929), np.float32(673), np.float32(2.0 ** -40)
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(c)) == np.float32(2 ** 24)
    assert fma32(a, b, c) == np.float32(2 ** 24 + 2)
    assert fma32(a, b, -c) == np.float32(2 ** 24)
    assert fma32(np.float32(3), np.float32(0.5), np.float32(-1.5)) == 0


@pytest.mark.parametrize("pc", ["none", "jacobi"])
@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_emulated_solve_agrees_with_the_plain_version(pc, n):
    data, offsets, b = banded_battery(4, n, seed=5)
    x0 = np.zeros_like(b)
    x, k, rr = batch_dia_cg_emulated(data, offsets, b, x0, 1e-5, n, jacobi=pc == "jacobi")
    xp, kp, rp = fused_batch_dia_cg_solve_torch(
        torch.from_numpy(data), offsets, torch.from_numpy(b), torch.from_numpy(x0), tol=1e-5,
        maxiter=n, precondition=pc)
    assert np.abs(k - kp.numpy()).max() <= 1 and bool((rr < np.float32(1e-5) ** 2).all())
    assert scaled_err(torch.from_numpy(x), xp) <= 1e-4


def _lanes_rows(plan):
    return {lane: plan.lane_rows(lane) for lane in range(32 * plan.warps)}


@pytest.mark.parametrize("n,warps", CASES)
def test_plan_gives_every_row_one_lane_in_virtual_thread_order(n, warps):
    plan = batch_dia_warps_plan(256, n, 3, warps=warps)
    assert plan.group * (32 // plan.group) == 32 and plan.group == 32 * warps // plan.vwarps
    seen = {}
    for lane, rows in _lanes_rows(plan).items():
        g, vw = lane % plan.group, lane // plan.group
        last = {}
        for j, row in rows:
            assert row not in seen
            seen[row] = lane
            t = row % plan.vthreads  # its virtual thread: 32 vw + g + G j
            assert t == 32 * vw + g + plan.group * j
            assert row > last.get(j, -1)  # a virtual thread's rows in order
            last[j] = row
    assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 1152, 2048, 4096, 8192, 14464])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fits_the_card_and_places_the_state(n, dtype):
    for ndiag in (1, 3, 7, 27, 64):
        for warps in (None,) + BATCH_DIA_WARPS:
            for slab in (None, True, False):
                try:
                    plan = batch_dia_warps_plan(256, n, ndiag, dtype, warps=warps, slab=slab)
                except ValueError:
                    vw = min(n, 1024) // 32
                    assert (warps or 0) > vw or slab is True
                    continue
                assert plan.sys_bytes <= SMEM_PER_BLOCK and plan.smem_bytes <= SMEM_PER_BLOCK
                assert plan.threads <= BATCH_DIA_BLOCK and plan.sys_bytes % 16 == 0
                assert plan.regs == (n <= 1024)
                assert plan.pad in (0, plan.group % 32)
                if warps is None:
                    assert plan.warps == min(BATCH_DIA_DEFAULT_WARPS, min(n, 1024) // 32)
                if slab is None:
                    # The slab in shared memory wherever it fits.
                    assert plan.slab or batch_dia_warps_plan(
                        256, n, ndiag, dtype, warps=plan.warps, slab=False).sys_bytes + (
                        plan.itemsize * ndiag * n) > SMEM_PER_BLOCK - 16


def test_plan_at_tpucgs_battery_and_at_the_cap():
    plan = batch_dia_warps_plan(256, 1024, 3)
    assert (plan.warps, plan.regs, plan.systems, plan.grid, plan.slab) == (8, True, 1, 256, True)
    assert plan.pad == 8 and plan.sys_bytes == 4 * BATCH_DIA_SLOTS + 4 * 1280 + 4 * 3 * 1280
    cap = batch_dia_warps_plan(8, FUSED_BATCH_DIA_MAX_N, 3)
    assert not cap.regs and not cap.slab and cap.pad == 0
    assert cap.sys_bytes == 4 * BATCH_DIA_SLOTS + 16 * FUSED_BATCH_DIA_MAX_N <= SMEM_PER_BLOCK
    big = batch_dia_warps_plan(100_000, 128, 3)  # 4 virtual warps: W = 4
    assert big.warps == 4 and big.systems == 2 and big.threads == 256 and big.grid == 50_000


def test_plan_refuses_what_k12_cannot_run():
    for args in ((0, 1024, 3), (8, 200, 3), (8, FUSED_BATCH_DIA_MAX_N + 128, 3), (8, 1024, 65)):
        with pytest.raises(ValueError, match="K12 cannot plan"):
            batch_dia_warps_plan(*args)
    for warps in (1, 2, 3, 16):
        with pytest.raises(ValueError, match="warps a system"):
            batch_dia_warps_plan(8, 1024, 3, warps=warps)
    with pytest.raises(ValueError, match="warps a system"):
        batch_dia_warps_plan(8, 128, 3, warps=8)  # 4 virtual warps
    with pytest.raises(ValueError, match="does not fit"):
        batch_dia_warps_plan(8, FUSED_BATCH_DIA_MAX_N, 3, slab=True)


def test_forced_plan_on_cpu_tensors_needs_the_card():
    data, offsets, b = banded_battery(2, 128, seed=0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA device"):
        fused_batch_dia_cg_solve_cuda(t(data), offsets, t(b), t(b), tol=1e-5, maxiter=4,
                                      _plan=(2, True))


def test_plan_constants_are_the_kernels():
    src = (CSRC / "fused.cu").read_text()
    assert re.search(rf"constexpr int kBatchDiaWarps = {BATCH_DIA_DEFAULT_WARPS};", src)
    assert re.search(rf"constexpr int kBatchDiaBlock = {BATCH_DIA_BLOCK};", src)
    assert re.search(rf"constexpr int kBatchDiaSlots = {BATCH_DIA_SLOTS};", src)
    assert re.search(rf"constexpr int kSmemPerBlock = {SMEM_PER_BLOCK};", src)
    # The plan's arithmetic, term by term.
    assert "const long long len = n + pad * (n / 32);" in src
    assert "const long long bytes = 4 * kBatchDiaSlots + 4 * len * (regs ? 1 : 4) +" in src
    assert "return 16 * ((bytes + 15) / 16);" in src
    assert "const bool regs = n <= kBatchBlock;" in src
    assert "const int pads[2] = {g % 32, 0};" in src
    assert ("while (2 * systems * warps * 32 <= kBatchDiaBlock && 2 * systems * bytes <= "
            "kSmemPerBlock &&") in src
    assert "batch > 32LL * sms * systems)" in src
    # The kernel's virtual threads and steps: G lanes a virtual warp, lane g
    # its virtual lanes g + G j; the tree's steps of offset G and more in
    # registers, then the shuffles below G; one instantiation a (W, regs).
    assert "const int G = 32 * W / vwarps;" in src
    assert "const int vbase = 32 * vw + g;" in src
    assert "const int row = vbase + G * j + vt * q;" in src
    assert "for (int off = G / 2; off >= 1; off >>= 1) s = s + __shfl_down_sync(" in src
    for w in BATCH_DIA_WARPS:
        for regs in ("false", "true"):
            assert f"launch_batch_dia_kernel<T, {w}, {regs}>" in src
    assert 'static_assert(W == 4 || W == 8, "K12 runs 4 or 8 warps a system");' in src
    assert "atomicAdd" not in src
