"""P3's and P4's kernels on the CPU: P3's walk, P4's plan
(``elem_gather_plan``) and NumPy emulations of the kernels' walks in
``csrc/probe.cu``.

P3's fixed walk (a warp a row, ``THREADS`` / 32 warps a block) and each of
P4's two plans must write every row (P3) or element (P4) of o exactly once
at the edge sizes, P4's on 132 SMs and on fewer; P4's plan must keep the
parent's walk up to its streaming threshold and stream past it. The
emulations (this warp reads this row's index, then this float4 of the row;
this thread reads these indices, then these elements, then stores them)
equal ``np.take``, the plain version and the script's Pallas body in
interpret mode. The constants are ``csrc/probe.cu``'s, the plan refuses bad
sizes, the parent-against-change cases hold the second shapes, and
``bench/probe_ab.py`` imports a parent checkout's wrappers beside this
one's. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from test_torch_probe_gather import PALLAS
from test_torch_probe_stage import PROBE_CU, _bits_equal, _constants
from tpucg_torch.bench import probe_ab
from tpucg_torch.bench import probe_gather as drv
from tpucg_torch.bench import whole_solve_ab
from tpucg_torch.kernels import probe_gather as kp

LANE = kp.LANE
WARPS = kp.THREADS // 32  # P3's warps a block, a row each
RG_ROWS = (1, 3, 31, 32, 33, 255, 256, 257, 2048, 8192)
EG_N = (1, 31, 32, 33, 255, 256, 257, 2048, 32768, 262144)
SMS = (1, 7, 66, 132)


def test_constants_are_the_kernels():
    c = _constants()
    assert (c["kThreads"], c["kEgStreamPer"]) == (kp.THREADS, kp.EG_STREAM_PER)
    assert kp.THREADS % 32 == 0 and WARPS == 8  # the parent's 8 warps a P3 block
    assert kp.EG_STREAM_PER_SM == 2 * 2048  # 2 waves of a full SM's threads
    # P4 builds exactly two walks; P3 one, the parent's.
    src = PROBE_CU.read_text()
    assert src.count("elem_gather_kernel<kEgStreamPer><<<") == 1
    assert src.count("elem_gather_kernel<1><<<") == 1
    assert src.count("row_gather_kernel<") == src.count("row_gather_kernel<<<") == 1


def test_the_edge_sets_are_the_kernels_edges():
    assert drv.RG_EDGE_ROWS == RG_ROWS and drv.EG_EDGE_N == EG_N
    assert drv.stream_edges(132) == (540671, 540672, 540673)
    for sms in SMS:
        last, first, ragged = (kp.elem_gather_plan(n, sms) for n in drv.stream_edges(sms))
        assert (last.stream, first.stream, ragged.stream) == (False, True, True)
        assert ragged.n % (kp.THREADS * kp.EG_STREAM_PER) == 1  # one thread with one element


# ---- P3: the walk -----------------------------------------------------------


def row_blocks(rows: int) -> int:
    """P3's grid: ``blocks_for(nrows * kLane, kThreads / 32 * kLane)``."""
    return -(-rows * LANE // (WARPS * LANE))


def rows_written(rows: int) -> np.ndarray:
    """How often P3's warps write each row of o."""
    at = np.arange(row_blocks(rows))[:, None] * WARPS + np.arange(WARPS)
    return np.bincount(at[at < rows], minlength=rows)


@pytest.mark.parametrize("rows", RG_ROWS)
def test_row_gather_writes_every_row_once(rows):
    assert np.all(rows_written(rows) == 1)
    assert row_blocks(rows) * WARPS - rows < WARPS  # only the last block ragged


def test_row_gather_blocks_at_the_scripts_and_the_baselines_shapes():
    assert (row_blocks(256), row_blocks(2048)) == (32, 256)


# ---- P4: the plan -----------------------------------------------------------


def elements_written(plan) -> np.ndarray:
    """How often the plan's threads write each element of o."""
    b = np.arange(plan.blocks)[:, None, None]
    j = np.arange(plan.per)[None, :, None]
    t = np.arange(plan.threads)[None, None, :]
    at = (b * plan.threads * plan.per + j * plan.threads + t).reshape(-1)
    return np.bincount(at[at < plan.n], minlength=plan.n)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", EG_N)
def test_elem_gather_plan_writes_every_element_once(n, sms):
    plan = kp.elem_gather_plan(n, sms)
    assert plan.n == n and plan.threads == kp.THREADS
    assert np.all(elements_written(plan) == 1)
    # The parent's walk up to the threshold, the streaming walk past it.
    streams = n >= kp.EG_STREAM_PER_SM * sms
    assert (plan.per, plan.stream) == ((kp.EG_STREAM_PER, True) if streams else (1, False))
    assert plan.blocks * plan.threads * plan.per - n < plan.threads * plan.per
    # taken() is the same walk, thread by thread.
    for b, t in ((0, 0), (plan.blocks - 1, plan.threads - 1), (plan.blocks // 2, 5)):
        for e in plan.taken(b, t):
            assert e < n and (e // (plan.threads * plan.per), e % plan.threads) == (b, t)


@pytest.mark.parametrize("stream", [False, True])
def test_every_forced_elem_plan_writes_every_element_once(stream):
    for n in (1, 33, 257, 513, 32768, 540673):
        assert np.all(elements_written(kp.ElemGatherPlan(n, stream)) == 1), (n, stream)


def test_elem_gather_plan_at_the_scripts_the_baselines_and_fem_scale():
    # The script's and the baseline's shapes keep the parent's walk.
    assert kp.elem_gather_plan(32768) == kp.ElemGatherPlan(32768, False)
    assert kp.elem_gather_plan(262144).blocks == 1024
    # FEM 300k's 5,398,135 reads stream, 2 elements a thread.
    fem = kp.elem_gather_plan(5398135)
    assert (fem.per, fem.stream, fem.blocks) == (2, True, 10544)
    assert str(fem) == ("10544 blocks of 256 threads, 2 elements a thread, indices and o "
                        "evict-first")
    assert str(kp.elem_gather_plan(32768)) == "128 blocks of 256 threads, 1 element a thread"
    edge = kp.EG_STREAM_PER_SM * kp.SMS
    assert not kp.elem_gather_plan(edge - 1).stream and kp.elem_gather_plan(edge).stream
    assert kp.elem_gather_plan(32768, 1).stream  # a one-SM card streams sooner


@pytest.mark.parametrize("bad", [lambda: kp.elem_gather_plan(0), lambda: kp.elem_gather_plan(-3),
                                 lambda: kp.elem_gather_plan(5, 0),
                                 lambda: kp.elem_gather_plan(5, -1)])
def test_plans_refuse_bad_sizes(bad):
    with pytest.raises(ValueError, match="_gather_plan needs"):
        bad()


def test_plan_lines_name_the_p4_plans():
    lines = drv.plan_lines(132)
    assert "plan P4 (32768 elements): 128 blocks of 256 threads, 1 element a thread" in lines
    assert ("plan P4 (540672 elements): 1056 blocks of 256 threads, 2 elements a thread, "
            "indices and o evict-first") in lines
    assert sum(ln.startswith("plan P4") for ln in lines) == 3
    assert not any(ln.startswith("plan P3") for ln in lines)  # P3 has one walk


# ---- the kernels' walks -----------------------------------------------------


def row_walk(x2, ridx):
    """P3's kernel in NumPy: warp w of block b takes row r = b * WARPS + w;
    each lane reads ridx[r] (a broadcast), then its float4 of x2's row and
    stores it. Returns o (NaN where none wrote) and the writes a row."""
    rows = ridx.size
    o = np.full((rows, LANE), np.nan, np.float32)
    writes = np.zeros(rows, np.int64)
    for b in range(row_blocks(rows)):
        for w in range(WARPS):
            r = b * WARPS + w
            if r >= rows:
                continue
            src = ridx[r]
            for lane in range(32):
                o[r, 4 * lane:4 * lane + 4] = x2[src, 4 * lane:4 * lane + 4]
            writes[r] += 1
    return o, writes


def elem_walk(plan, xf, eidx):
    """P4's kernel in NumPy: thread t of block b takes the elements
    ``plan.taken(b, t)``, reads all their indices, then all their elements
    of xf, then stores them. Returns o (NaN where none wrote) and the writes
    an element."""
    flat = eidx.reshape(-1)
    o = np.full(plan.n, np.nan, np.float32)
    writes = np.zeros(plan.n, np.int64)
    for b in range(plan.blocks):
        for t in range(plan.threads):
            at = plan.taken(b, t)
            e = [flat[a] for a in at]
            v = [xf[i] for i in e]
            for a, x in zip(at, v):
                o[a] = x
                writes[a] += 1
    return o.reshape(eidx.shape), writes


def _p3_inputs(rows, seed, fill=None):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((2048, LANE)).astype(np.float32)
    ridx = (rng.integers(0, 2048, rows) if fill is None else np.full(rows, fill)).astype(np.int32)
    return x2, ridx


@pytest.mark.parametrize("rows,fill", [
    (1, None), (3, None), (31, None), (33, None), (257, None), (256, 0), (256, 2047),
    (2048, None), (255, None), (8, None),
])
def test_row_walk_equals_take_and_plain(rows, fill):
    x2, ridx = _p3_inputs(rows, rows, fill)
    got, writes = row_walk(x2, ridx)
    assert np.all(writes == 1)
    assert _bits_equal(got, np.take(x2, ridx, axis=0))
    assert _bits_equal(got, kp.row_gather_torch(torch.from_numpy(x2), torch.from_numpy(ridx)))


def _p4_inputs(n, seed, fill=None, size=262144):
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal(size).astype(np.float32)
    eidx = (rng.integers(0, size, n) if fill is None else np.full(n, fill)).astype(np.int32)
    return xf, eidx


@pytest.mark.parametrize("n,fill,stream", [
    (1, None, None), (31, None, None), (33, None, None), (257, None, None),
    (2048, 0, None), (2048, 262143, None), (4097, None, True),
    (33, None, True), (257, None, False), (513, None, True),
])
def test_elem_walk_equals_take_and_plain(n, fill, stream):
    xf, eidx = _p4_inputs(n, n, fill)
    plan = kp.elem_gather_plan(n) if stream is None else kp.ElemGatherPlan(n, stream)
    got, writes = elem_walk(plan, xf, eidx)
    assert np.all(writes == 1)
    assert _bits_equal(got, np.take(xf, eidx))
    assert _bits_equal(got, kp.elem_gather_torch(torch.from_numpy(xf), torch.from_numpy(eidx)))


@pytest.mark.parametrize("walk", ["parent", "streaming"])
def test_elem_walk_on_the_scripts_2d_indices_equals_the_interpreted_pallas_body(walk):
    a = drv.probe_inputs(0)
    xf, eidx = a["xf"], a["eidx"]
    n = eidx.size
    plan = kp.elem_gather_plan(n) if walk == "parent" else kp.ElemGatherPlan(n, True)
    assert plan.stream == (walk == "streaming")
    want = np.asarray(PALLAS["P4"](jnp.asarray(xf), jnp.asarray(eidx)))
    assert _bits_equal(elem_walk(plan, xf, eidx)[0], want)


@pytest.mark.parametrize("ridx_of", ["script", "last row"])
def test_row_walk_equals_the_interpreted_pallas_body(ridx_of):
    a = drv.probe_inputs(0)
    x2 = a["x2"]
    ridx = a["ridx"] if ridx_of == "script" else np.full_like(a["ridx"], x2.shape[0] - 1)
    want = np.asarray(PALLAS["P3"](jnp.asarray(x2), jnp.asarray(ridx)))
    assert _bits_equal(row_walk(x2, ridx)[0], want)


def test_index_cases_are_random_first_and_last():
    g = torch.Generator().manual_seed(0)
    cases = drv.index_cases(2048, (5,), g, "cpu")
    assert [c.dtype for c in cases] == [torch.int32] * 3
    assert int(cases[0].min()) >= 0 and int(cases[0].max()) < 2048
    assert torch.equal(cases[1], torch.zeros(5, dtype=torch.int32))
    assert torch.equal(cases[2], torch.full((5,), 2047, dtype=torch.int32))


# ---- the wrappers before any launch -----------------------------------------


def test_row_gather_refuses_a_misaligned_table_before_any_launch():
    x2 = torch.zeros(5 * LANE + 1)[1:].view(5, LANE)
    before = kp.row_gather_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp.row_gather_cuda(x2, torch.zeros(2, dtype=torch.int32))
    assert kp.row_gather_cuda.launches == before


@pytest.mark.parametrize("wrapper", ["row_gather_cuda", "elem_gather_cuda"])
def test_the_card_wrappers_refuse_cpu_tensors_before_any_launch(wrapper):
    fn = getattr(kp, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA device"):
        if wrapper == "row_gather_cuda":
            fn(torch.zeros(4, LANE), torch.zeros(3, dtype=torch.int32))
        else:
            fn(torch.zeros(64), torch.zeros(3, dtype=torch.int32),
               _plan=kp.ElemGatherPlan(3, True))
    assert fn.launches == before


# ---- the parent-against-change cases ----------------------------------------


def test_ab_probe_cases_hold_the_second_shapes():
    cases = whole_solve_ab.probe_cases("cpu")
    shapes = {label: [tuple(a.shape) for a in sets[0]] for label, (_, sets) in cases.items()}
    assert shapes["P3 256 rows"] == [(2048, LANE), (256,)]
    assert shapes["P3 2048 rows"] == [(2048, LANE), (2048,)]
    assert shapes["P4 256x128"] == [(262144,), (256, LANE)]
    assert shapes["P4 2048x128"] == [(262144,), (2048, LANE)]
    assert cases["P3 2048 rows"][0] is kp.row_gather_cuda
    assert cases["P4 2048x128"][0] is kp.elem_gather_cuda
    assert whole_solve_ab.FEM_PROBES == ("P4 FEM 300k CSR", "P4 FEM 300k WELL",
                                         "P4 FEM 300k random")


def test_probe_ab_imports_the_parents_wrappers_beside_these(tmp_path):
    root = tmp_path / "parent"
    shutil.copytree(drv.__file__.rsplit("/bench/", 1)[0], root / "tpucg_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {k: v for k, v in sys.modules.items() if k.startswith("tpucg_torch")}
    parent = probe_ab.parent_probes(str(root))
    assert parent is not kp and parent.__file__.startswith(str(root))
    # This checkout's modules are back, as they were.
    assert {k: v for k, v in sys.modules.items() if k.startswith("tpucg_torch")} == before
    assert sys.modules["tpucg_torch.kernels.probe_gather"] is kp
    # The parent's wrappers are its own, and they run (here, their plain versions).
    assert parent.elem_gather is not kp.elem_gather
    assert parent._lib is not kp._lib and str(parent._lib.BUILD_DIR).startswith(str(root))
    xf, eidx = _p4_inputs(300, 3)
    x2, ridx = _p3_inputs(40, 4)
    assert torch.equal(parent.elem_gather(torch.from_numpy(xf), torch.from_numpy(eidx)),
                       kp.elem_gather(torch.from_numpy(xf), torch.from_numpy(eidx)))
    assert torch.equal(parent.row_gather(torch.from_numpy(x2), torch.from_numpy(ridx)),
                       kp.row_gather(torch.from_numpy(x2), torch.from_numpy(ridx)))
