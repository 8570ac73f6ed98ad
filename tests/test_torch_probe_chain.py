"""P2's and P6's kernels on the CPU: P2's plan (``sub_gather_plan``) and
NumPy emulations of both kernels' walks in ``csrc/probe.cu``.

P2's plan must write every element of o once, keep a staged block's slab
within a block's shared memory, take the staged form exactly up to
``SG_MAX_ROWS`` rows of v and fill the SMs at the script's shape. The
emulations of its two forms (staged: this block stages these columns of v
and this thread reads this slab slot; direct: this thread gathers this
element) equal ``np.take_along_axis``, the plain version and the
script's Pallas body in interpret mode. The emulation of P6's warp
rotation (a lane's float4 from two source lanes by shuffles) equals
``np.roll``, the plain version, the interpreted ``pltpu.roll`` body within
the row and ``jnp.roll`` past it, to the ends of int32. The constants are
``csrc/probe.cu``'s, and the wrappers refuse a misaligned view before any
launch. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from test_torch_probe_gather import PALLAS, roll_dyn
from test_torch_probe_stage import BLOCK_SMEM, _bits_equal, _constants, _off
from tpucg_torch.bench import probe_gather as drv
from tpucg_torch.bench import whole_solve_ab
from tpucg_torch.kernels import probe_gather as kp

LANE, CAP = kp.LANE, kp.SG_MAX_ROWS
V_ROWS = (1, 2, 255, 256, 257, CAP - 1, CAP, CAP + 1, 16384)
M_ROWS = (1, 3, 31, 32, 33, 255, 256, 257, 8192)
SHIFTS = (0, 1, 3, 4, 5, 127, 128, 300, -3, -2 ** 31, 2 ** 31 - 1)
IN_ROW = (0, 1, 3, 4, 5, 127)  # pltpu.roll's own range; past it, jnp.roll
K_IDX = 8                      # csrc/probe.cu kSgIdx


def test_constants_are_the_kernels():
    c = _constants()
    assert c["kMaxSmem"] == kp.BLOCK_SMEM == BLOCK_SMEM
    assert (c["kSgCols"], c["kSgGroups"], c["kSgMaxRows"], c["kSgMaxThreads"]) == (
        kp.SG_COLS, kp.SG_GROUPS, kp.SG_MAX_ROWS, kp.SG_MAX_THREADS)
    assert c["kSgIdx"] == K_IDX
    # One 32-byte sector a row of v; the cap is the most rows whose slab fits.
    assert kp.SG_COLS * 4 == 32 and CAP == 7264
    assert CAP * 32 <= BLOCK_SMEM < (CAP + 1) * 32


def test_the_edge_sets_are_the_kernels_edges():
    assert drv.SG_EDGE_VROWS == V_ROWS and drv.SG_EDGE_ROWS == M_ROWS
    assert drv.ROLL_SHIFTS == SHIFTS and drv.ROLL_EDGE_ROWS == (1, 3, 31, 32, 33, 256, 8192, 65536)


# ---- P2: the plan -----------------------------------------------------------


def _writes(plan) -> np.ndarray:
    """How often the plan's blocks write each element of o."""
    writes = np.zeros((plan.rows, LANE), np.int64)
    for b in range(plan.blocks):
        rows, cols = (x.numpy() for x in plan.quads(b))
        for k in range(4):
            np.add.at(writes, (rows, cols + k), 1)
    return writes


@pytest.mark.parametrize("m", M_ROWS)
@pytest.mark.parametrize("v_rows", V_ROWS)
def test_sub_gather_plan_writes_every_element_once(v_rows, m):
    plan = kp.sub_gather_plan(v_rows, m, 132)
    assert (plan.v_rows, plan.rows) == (v_rows, m)
    assert np.all(_writes(plan) == 1)
    # The rule on the shape: staged only where its slab fits (both sides of
    # the cap) and each block reuses it over enough idx rows.
    assert plan.staged == (v_rows <= CAP and v_rows <= kp.SG_STAGED_RATIO * m)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= kp.SG_MAX_THREADS
    if plan.staged:
        assert plan.smem == 32 * v_rows <= BLOCK_SMEM
        assert plan.blocks <= 132  # one wave: a slab is staged once a block
        # Runs: the largest power of two within sqrt(17 m / v_rows) and 8.
        runs = max(r for r in (1, 2, 4, 8) if r * r * v_rows <= kp.SG_RUN_BALANCE * m or r == 1)
        assert plan.run == -(-m // runs) and plan.blocks == kp.SG_GROUPS * -(-m // plan.run)
        assert plan.threads == kp.SG_MAX_THREADS and str(plan).startswith("staged:")
    else:
        assert plan.smem == 0 and str(plan).startswith("direct:")
        assert plan.threads == kp.SG_MAX_THREADS
        assert plan.blocks * plan.threads >= m * LANE  # every element of o a thread


def test_sub_gather_plan_at_the_scripts_and_the_ab_shapes():
    # The script's shape: the forms tie on the card (bench/p2_forms.py), and
    # the rule takes the direct form, an element a thread.
    plan = kp.sub_gather_plan(256, 256, 132)
    assert not plan.staged and (plan.blocks, plan.threads) == (128, 256)
    # The rate shape (v 2048 rows, idx 8192): staged over 128 of 132 SMs,
    # a 64 KB slab a block.
    rate = kp.sub_gather_plan(2048, 8192, 132)
    assert rate.staged and (rate.run, rate.threads, rate.blocks) == (1024, 256, 128)
    assert rate.smem == 65536
    # A slab reused over twice as many idx rows: staged on 4 runs.
    assert kp.sub_gather_plan(256, 512, 132).blocks == 64
    tall = kp.sub_gather_plan(16384, 8192, 132)
    assert not tall.staged and tall.blocks == 8192 * LANE // 256
    assert kp.sub_gather_plan(2048, 8192) == rate  # 132 SMs: the default
    assert kp.sub_gather_plan(2048, 8192, 64).blocks == 64  # one wave on a smaller card


@pytest.mark.parametrize("bad", [(0, 1, 132), (1, 0, 132), (1, 1, 0)])
def test_sub_gather_plan_refuses(bad):
    with pytest.raises(ValueError, match="sub_gather_plan needs"):
        kp.sub_gather_plan(*bad)


def test_plan_lines_name_both_forms():
    lines = drv.plan_lines(132)
    p2 = [ln for ln in lines if ln.startswith("plan P2")]
    assert len(p2) == 3 and "direct:" in p2[0] and "staged:" in p2[1] and "direct:" in p2[2]
    assert any(ln.startswith("plan P6") and "64 blocks of 4 warps" in ln for ln in lines)


# ---- P2: the kernels' walks -------------------------------------------------


def staged_walk(plan, v, idx):
    """The staged kernel in NumPy. Block b stages column group g = b % 16
    of v: 16-byte copy k of the slab is v[k // 2, 8g + 4 (k % 2):+4] into
    slab slot 4k. Item it (o's float4 at row first + it // 2, columns 8g +
    4 (it % 2)) goes to thread it % threads at step it // threads, in
    batches of K_IDX steps; the thread reads slab slots 8 idx + 4 (it % 2)
    + k. Returns o (NaN where none wrote) and the writes an element."""
    o = np.full((plan.rows, LANE), np.nan, np.float32)
    writes = np.zeros(o.shape, np.int64)
    t = np.arange(plan.threads)
    for b in range(plan.blocks):
        g, first = b % kp.SG_GROUPS, b // kp.SG_GROUPS * plan.run
        k = np.arange(2 * plan.v_rows)
        slab = np.empty((2 * plan.v_rows, 4), np.float32)
        slab[k] = v[(k >> 1)[:, None], 8 * g + 4 * (k & 1)[:, None] + np.arange(4)]
        slab = slab.reshape(-1)
        items = 2 * min(plan.run, plan.rows - first)
        for base in range(0, items, K_IDX * plan.threads):
            it = (base + t[None, :] + plan.threads * np.arange(K_IDX)[:, None]).reshape(-1)
            it = it[it < items]
            rows, cols = first + (it >> 1), 8 * g + 4 * (it & 1)
            for q in range(4):
                lane = idx[rows, cols + q]
                o[rows, cols + q] = slab[8 * lane + 4 * (it & 1) + q]
                writes[rows, cols + q] += 1
    return o, writes


def direct_walk(plan, v, idx):
    """The direct kernel in NumPy: thread t of block b takes o's element at
    = b * threads + t, loads idx there and gathers v[idx, at % 128]."""
    o = np.full((plan.rows, LANE), np.nan, np.float32)
    writes = np.zeros(o.shape, np.int64)
    for b in range(plan.blocks):
        at = np.arange(b * plan.threads, (b + 1) * plan.threads)
        at = at[at < plan.rows * LANE]
        rows, c = at // LANE, at % LANE
        o[rows, c] = v[idx[rows, c], c]
        writes[rows, c] += 1
    return o, writes


def _walk(plan, v, idx):
    return (staged_walk if plan.staged else direct_walk)(plan, v, idx)


def _p2_inputs(v_rows, m, seed, fill=None):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((v_rows, LANE)).astype(np.float32)
    idx = (rng.integers(0, v_rows, (m, LANE)) if fill is None
           else np.full((m, LANE), fill)).astype(np.int32)
    return v, idx


@pytest.mark.parametrize("v_rows,m,fill,forced", [
    (1, 1, None, None), (2, 3, None, None), (257, 33, None, None), (256, 256, None, None),
    (256, 256, 0, None), (256, 256, 255, None), (2048, 8192, None, None),
    (CAP, 5, CAP - 1, None), (CAP + 1, 31, None, None), (16384, 256, None, None),
    (256, 1024, None, None), (300, 8192, 299, None),
    (300, 1000, None, (600, 64)),    # a staged block of 3 batches of indices
    (300, 257, None, (7, 96)),       # short runs, a block of 3 warps
    (256, 256, None, (0, 64)),       # the direct form below the cap
    (2048, 8192, None, (0, 256)),
])
def test_sub_gather_walks_equal_take_along_axis_and_plain(v_rows, m, fill, forced):
    v, idx = _p2_inputs(v_rows, m, v_rows + m, fill)
    plan = (kp.sub_gather_plan(v_rows, m, 132) if forced is None
            else kp.SubGatherPlan(v_rows, m, *forced))
    got, writes = _walk(plan, v, idx)
    assert np.all(writes == 1)
    want = np.take_along_axis(v, idx, 0)
    assert _bits_equal(got, want)
    assert _bits_equal(got, kp.sub_gather_torch(torch.from_numpy(v), torch.from_numpy(idx)))


@pytest.mark.parametrize("form", ["staged", "direct"])
def test_sub_gather_walks_equal_the_interpreted_pallas_body(form):
    a = drv.probe_inputs(0)
    v, idx = a["V"], a["SI"]
    plan = (kp.SubGatherPlan(256, 256, 64, 256) if form == "staged"
            else kp.sub_gather_plan(256, 256, 132))
    assert plan.staged == (form == "staged")
    want = np.asarray(PALLAS["P2"](jnp.asarray(v), jnp.asarray(idx)))
    assert _bits_equal(_walk(plan, v, idx)[0], want)


# ---- P6: the warp rotation --------------------------------------------------


def c_mod(s: int, n: int) -> int:
    """C's ``s % n`` on int32 (the quotient truncated toward zero)."""
    return s - n * int(s / n) if abs(s) < 2 ** 52 else s % n


def roll_walk(s: int, x: np.ndarray) -> np.ndarray:
    """The kernel in NumPy: lane l of a row's warp holds x[row, 4l:4l + 4];
    r = ((s % 128) + 128) % 128 in int32; d = (4l - r) & 127; lane l takes
    the float4s of lanes d >> 2 and (d >> 2) + 1 (mod 32) by shuffles and
    keeps elements d & 3 ... (d & 3) + 3 of the two."""
    assert -2 ** 31 <= s < 2 ** 31
    r = (c_mod(s, LANE) + LANE) % LANE
    assert 0 <= r < LANE and abs(c_mod(s, LANE) + LANE) < 2 ** 31  # no int32 overflow
    o = np.empty_like(x)
    for row in range(x.shape[0]):
        mine = x[row].reshape(32, 4)
        for lane in range(32):
            d = (4 * lane - r) & (LANE - 1)
            a, b = d >> 2, d & 3
            both = np.concatenate([mine[a], mine[(a + 1) & 31]])
            o[row, 4 * lane:4 * lane + 4] = both[b:b + 4]
    return o


@pytest.mark.parametrize("shift", SHIFTS)
def test_roll_walk_equals_np_roll_the_plain_version_and_the_tpu_roll(shift):
    a = drv.probe_inputs(0)
    x = a["V"]
    got = roll_walk(shift, x)
    s = np.asarray([shift], np.int32)
    assert _bits_equal(got, np.roll(x, shift, 1))
    assert _bits_equal(got, kp.roll_dyn_torch(torch.from_numpy(s), torch.from_numpy(x)))
    if shift in IN_ROW:
        want = np.asarray(roll_dyn(jnp.asarray(s), jnp.asarray(x)))
    else:
        want = np.asarray(jnp.roll(jnp.asarray(x), shift, 1))
    assert _bits_equal(got, want)


@pytest.mark.parametrize("rows", [1, 3, 33])
def test_roll_walk_at_other_row_counts(rows):
    x = np.random.default_rng(rows).standard_normal((rows, LANE)).astype(np.float32)
    for shift in SHIFTS:
        assert _bits_equal(roll_walk(shift, x), np.roll(x, shift, 1)), shift


def test_c_mod_is_cs_remainder():
    assert [c_mod(s, 128) for s in (5, -3, -128, -2 ** 31, 2 ** 31 - 1, -129)] == [
        5, -3, 0, 0, 127, -1]


def test_roll_takes_lane_gather_plan():
    plan = kp.lane_gather_plan(256, 132)
    assert (plan.blocks, plan.warps) == (64, 4)
    assert kp.lane_gather_plan(8192, 132).warps == kp.LG_WARPS


# ---- the alignment refusals -------------------------------------------------


@pytest.mark.parametrize("case", ["sub v", "sub idx", "roll x"])
def test_misaligned_views_are_refused_before_any_launch(case):
    v, idx = torch.zeros(4, LANE), torch.zeros(2, LANE, dtype=torch.int32)
    s = torch.zeros(1, dtype=torch.int32)
    fn = kp.roll_dyn_cuda if case.startswith("roll") else kp.sub_gather_cuda
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        if case == "sub v":
            kp.sub_gather_cuda(_off(v), idx)
        elif case == "sub idx":
            kp.sub_gather_cuda(v, _off(idx))
        else:
            kp.roll_dyn_cuda(s, _off(v))
    assert fn.launches == before
    # The same tensors aligned pass the check and are refused as off the card.
    with pytest.raises(ValueError, match="CUDA device"):
        kp.roll_dyn_cuda(s, v) if fn is kp.roll_dyn_cuda else kp.sub_gather_cuda(v, idx)


# ---- the parent-against-change cases ---------------------------------------


def test_ab_probe_cases_hold_the_p2_and_p6_shapes():
    cases = whole_solve_ab.probe_cases("cpu")
    shapes = {label: [tuple(a.shape) for a in sets[0]] for label, (_, sets) in cases.items()}
    assert shapes["P2 256x128"] == [(256, LANE), (256, LANE)]
    assert shapes["P2 8192x128"] == [(2048, LANE), (8192, LANE)]
    assert shapes["P2 tall"] == [(16384, LANE), (256, LANE)]
    assert not kp.sub_gather_plan(16384, 256).staged and kp.sub_gather_plan(2048, 8192).staged
    assert shapes["P6 256x128"] == [(1,), (256, LANE)]
    assert shapes["P6 8192x128"] == [(1,), (8192, LANE)]
    assert {"P1 256x128", "P3 256 rows", "P4 256x128", "P5 nw=64", "P7 L2 8192x128"} <= set(cases)
    for label, (launch, sets) in cases.items():
        assert launch.__name__.endswith("_cuda"), label
