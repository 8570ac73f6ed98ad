"""P1/P7's and P5's kernels on the CPU: their plans (``lane_gather_plan``,
``dynslice_plan``) and NumPy emulations of the kernels' walks in
``csrc/probe.cu``.

P1/P7's plan must give every row to one warp, within a block's shared
memory, and fill the SMs at P7's 8192 rows; the emulation (which warp of
which block takes which row, a thread loading 16 bytes of v and of idx,
gathering 4 lanes from the warp's shared row and storing 16 bytes) equals
``np.take_along_axis``, the plain version and the script's Pallas body in
interpret mode. P5's stages must take every window once, in k order; the
emulation of its staged sum (bulk copies into a ring of slots) equals
``window_sum`` and the plain version bit for bit. The constants are
``csrc/probe.cu``'s, and the wrappers refuse a misaligned view before any
launch. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from test_torch_probe_gather import PALLAS
from tpucg_torch.bench import probe_gather as drv
from tpucg_torch.kernels import probe_gather as kp

PROBE_CU = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc" / "probe.cu"
LANE, WINDOW = kp.LANE, kp.WINDOW
BLOCK_SMEM = 232_448      # 227 KB: shared memory an H100 block may take
MAX_TX = (1 << 20) - 1    # bytes an mbarrier phase may expect
ROWS, NWS = drv.EDGE_ROWS, drv.EDGE_NWS


def _bits_equal(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype == np.float32 and got.shape == want.shape
            and np.array_equal(got.view(np.uint32), want.view(np.uint32)))


def _constants() -> dict:
    """probe.cu's ``constexpr int`` constants, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", PROBE_CU.read_text()):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_constants_are_the_kernels():
    c = _constants()
    assert c["kLane"] == LANE and c["kRowBytes"] == kp.ROW_BYTES and c["kWindow"] == WINDOW
    assert c["kMaxWindows"] == kp.MAX_WINDOWS and c["kLgMaxWarps"] == kp.LG_MAX_WARPS
    assert (c["kDsStageWindows"], c["kDsMaxSlots"], c["kDsBarBytes"]) == (
        kp.DS_STAGE_WINDOWS, kp.DS_MAX_SLOTS, kp.DS_BAR_BYTES)
    assert 1 <= kp.LG_WARPS <= kp.LG_MAX_WARPS


# ---- P1/P7: the plan --------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("rows", ROWS)
def test_lane_plan_covers_every_row_once_within_shared_memory(rows, sms):
    plan = kp.lane_gather_plan(rows, sms)
    assert plan.rows == rows and plan.warps in (kp.LG_WARPS, kp.LG_WARPS // 2)
    taken = [plan.row(b, w) for b in range(plan.blocks) for w in range(plan.warps)]
    assert sorted(r for r in taken if r < rows) == list(range(rows))  # each row once
    assert plan.blocks * plan.warps - rows < plan.warps  # only the last block ragged
    # The wide blocks only where every SM gets one of them.
    assert (plan.warps == kp.LG_WARPS) == (plan.blocks >= sms and rows >= kp.LG_WARPS * sms)
    # Shared memory: a 512-byte row a warp, 16-byte aligned.
    assert plan.smem == plan.warps * kp.ROW_BYTES <= BLOCK_SMEM and kp.ROW_BYTES % 16 == 0


@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
def test_every_forced_block_width_covers_the_rows_once(warps):
    for rows in (1, 37, 8193):
        plan = kp.LaneGatherPlan(rows, warps)
        taken = sorted(plan.row(b, w) for b in range(plan.blocks) for w in range(warps))
        assert taken[:rows] == list(range(rows)) and all(r >= rows for r in taken[rows:])
        assert plan.smem <= BLOCK_SMEM


def test_lane_plan_fills_the_sms_at_p7_and_spreads_p1():
    p7 = kp.lane_gather_plan(8192, 132)
    assert p7.warps == kp.LG_WARPS and p7.blocks == 8192 // kp.LG_WARPS >= 132
    p1 = kp.lane_gather_plan(256, 132)
    assert (p1.warps, p1.blocks) == (kp.LG_WARPS // 2, 64)  # 64 SMs, not 32
    assert kp.lane_gather_plan(1, 132).blocks == 1
    assert f"{8192 // kp.LG_WARPS} blocks of {kp.LG_WARPS} warps" in str(p7)


@pytest.mark.parametrize("bad", [(0, 132), (5, 0)])
def test_lane_plan_refuses(bad):
    with pytest.raises(ValueError, match="lane_gather_plan needs"):
        kp.lane_gather_plan(*bad)


# ---- P1/P7: the kernel's walk -----------------------------------------------


def lane_gather_walk(plan, v, idx):
    """The kernel in NumPy: warp w of block b takes row ``plan.row(b, w)``;
    thread t loads v[row, 4t:4t + 4] and its int4 of indices, puts its 4
    floats in the warp's shared row, gathers its 4 lanes from that row and
    stores them at o[row, 4t:4t + 4]. Returns o (NaN where no warp wrote)
    and the writes an element."""
    o = np.full(v.shape, np.nan, np.float32)
    writes = np.zeros(v.shape, np.int64)
    for b in range(plan.blocks):
        for w in range(plan.warps):
            row = plan.row(b, w)
            if row >= plan.rows:
                continue
            shared = np.empty(LANE, np.float32)
            for t in range(32):  # the float4 stores into the warp's row
                shared[4 * t:4 * t + 4] = v[row, 4 * t:4 * t + 4]
            for t in range(32):  # after __syncwarp: 4 lanes, one float4 store
                l4 = idx[row, 4 * t:4 * t + 4]
                o[row, 4 * t:4 * t + 4] = shared[l4]
                writes[row, 4 * t:4 * t + 4] += 1
    return o, writes


def _lane_inputs(rows, seed, idx_fill=None):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((rows, LANE)).astype(np.float32)
    idx = (rng.integers(0, LANE, (rows, LANE)) if idx_fill is None
           else np.full((rows, LANE), idx_fill)).astype(np.int32)
    return v, idx


@pytest.mark.parametrize("rows,warps,idx_fill", [
    (1, 1, None), (3, 2, None), (37, 4, None), (65, 8, 0), (256, 1, None), (256, 16, 127),
    (1029, 8, None), (8193, 8, None), (8192, 16, None),
])
def test_lane_walk_equals_take_along_axis_and_plain(rows, warps, idx_fill):
    v, idx = _lane_inputs(rows, rows, idx_fill)
    got, writes = lane_gather_walk(kp.LaneGatherPlan(rows, warps), v, idx)
    assert np.all(writes == 1)
    want = np.take_along_axis(v, idx, 1)
    assert _bits_equal(got, want)
    assert _bits_equal(got, kp.lane_gather_torch(torch.from_numpy(v), torch.from_numpy(idx)))


@pytest.mark.parametrize("pid,keys", [("P1", ("V", "LI")), ("P7", ("Vb", "LIb"))])
def test_lane_walk_equals_the_interpreted_pallas_body(pid, keys):
    a = drv.probe_inputs(0)
    v, idx = (a[k] for k in keys)
    got, _ = lane_gather_walk(kp.lane_gather_plan(v.shape[0], kp.SMS), v, idx)
    want = np.asarray(PALLAS[pid](jnp.asarray(v), jnp.asarray(idx)))
    assert _bits_equal(got, want)


# ---- P5: the plan and the staged sum ----------------------------------------


@pytest.mark.parametrize("nw", NWS)
def test_dynslice_plan_takes_every_window_once_in_order(nw):
    plan = kp.dynslice_plan(nw)
    order = [k for c in range(plan.stages) for k in plan.windows(c)]
    assert order == list(range(nw))
    assert all(len(plan.windows(c)) >= 1 for c in range(plan.stages))
    assert plan.slots == min(plan.stages, kp.DS_MAX_SLOTS)
    assert plan.smem <= BLOCK_SMEM
    # One phase's bytes within an mbarrier's count; every window's row on a
    # 128-byte boundary (the slots first), the mbarriers on 8 bytes.
    assert kp.DS_STAGE_WINDOWS * kp.ROW_BYTES <= MAX_TX and kp.ROW_BYTES % 128 == 0
    assert (plan.slots * kp.DS_STAGE_WINDOWS * kp.ROW_BYTES + 4 * kp.MAX_WINDOWS) % 8 == 0


def test_dynslice_plan_at_the_scripts_64_windows_is_one_stage():
    plan = kp.dynslice_plan(64)
    assert (plan.stages, plan.slots) == (1, 1)  # every window issued before the first add
    assert kp.dynslice_plan(256).slots == 4 and kp.dynslice_plan(1024).stages == 16


@pytest.mark.parametrize("nw", [0, kp.MAX_WINDOWS + 1])
def test_dynslice_plan_refuses(nw):
    with pytest.raises(ValueError, match="dynslice_plan takes"):
        kp.dynslice_plan(nw)


def dynslice_walk(plan, w, x2):
    """The kernel in NumPy: block r stages row w[k] + r of each window, the
    stages in a ring of ``slots`` as issued (the first ``slots`` at once, a
    slot refilled after it is read); each stage's values loaded before its
    adds, which run in k order from +0, each rounded to float32."""
    out = np.zeros((WINDOW, LANE), np.float32)
    for r in range(WINDOW):
        ring = [None] * plan.slots

        def issue(c):
            ring[c % plan.slots] = (c, np.stack([x2[w[k] + r] for k in plan.windows(c)]))

        for c in range(min(plan.stages, plan.slots)):
            issue(c)
        acc = np.zeros(LANE, np.float32)
        for c in range(plan.stages):
            tag, rows = ring[c % plan.slots]
            assert tag == c  # the slot holds this stage, not a later one
            for row in rows:
                acc = acc + row
            if c + plan.slots < plan.stages:
                issue(c + plan.slots)
        out[r] = acc
    return out


@pytest.mark.parametrize("nw", NWS)
def test_dynslice_walk_equals_window_sum_bit_for_bit(nw):
    x2 = np.random.default_rng(nw).standard_normal((300, LANE)).astype(np.float32)
    w = drv.edge_windows(nw, 300, nw + 1)
    got = dynslice_walk(kp.dynslice_plan(nw), w, x2)
    assert _bits_equal(got, drv.window_sum(w, x2))
    assert _bits_equal(got, kp.dynslice_torch(torch.from_numpy(w), torch.from_numpy(x2)))


def test_dynslice_walk_on_the_scripts_inputs_equals_the_interpreted_pallas_body():
    a = drv.probe_inputs(0)
    want = np.asarray(PALLAS["P5"](jnp.asarray(a["widx"]), jnp.asarray(a["x2"])))
    assert _bits_equal(dynslice_walk(kp.dynslice_plan(64), a["widx"], a["x2"]), want)


def test_edge_windows_overlap_and_reach_the_last_row():
    w = drv.edge_windows(65, 300, 1)
    assert w.dtype == np.int32 and w.min() == 0 and w.max() == 300 - WINDOW
    assert w[4] == w[3] + 1 and len(set(w[:3])) == 2


# ---- the alignment refusals -------------------------------------------------


def _off(t: torch.Tensor) -> torch.Tensor:
    """A copy of t 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype)
    base = (16 - flat.data_ptr() % 16) % 16 // t.element_size()
    view = flat[base + 1: base + 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("case", ["lane v", "lane idx", "dynslice x2"])
def test_misaligned_views_are_refused_before_any_launch(case):
    v, idx = torch.zeros(4, LANE), torch.zeros(4, LANE, dtype=torch.int32)
    w, x2 = torch.zeros(3, dtype=torch.int32), torch.zeros(16, LANE)
    fn = kp.lane_gather_cuda if case.startswith("lane") else kp.dynslice_cuda
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        if case == "lane v":
            kp.lane_gather_cuda(_off(v), idx)
        elif case == "lane idx":
            kp.lane_gather_cuda(v, _off(idx))
        else:
            kp.dynslice_cuda(w, _off(x2))
    assert fn.launches == before
    # The same tensors aligned pass the check and are refused as off the card.
    with pytest.raises(ValueError, match="CUDA device"):
        kp.lane_gather_cuda(v, idx) if fn is kp.lane_gather_cuda else kp.dynslice_cuda(w, x2)
