"""K8/K9's march plan (``tpucg_torch.kernels.stencil.stencil_march_plan``) on
the CPU: the tiles and runs cover every element of the slab once, each
block's staged planes hold every operand of its outputs, the shared bytes
and threads fit the residency the kernel's launch bounds keep, the stated
ratio of u's reads is the one reckoned block by block, and the constants
are ``csrc/sparse.cu``'s. Then the march itself emulated with NumPy as the
kernel runs it (each thread's chunk of each plane loaded under the kernel's
predicates, +0 outside the grid, ``lo``/``hi`` at a slab's x-edges, two
staged tiles that start as NaN, summed in float32 in the order x+1, x-1,
y+1, y-1, z+1, z-1): bit-equal to ``poisson3d_torch``,
``poisson3d_slab_torch`` and tpucg's XLA form, within 1e-6 of sum |a x| of
tpucg's Pallas kernels in interpret mode, and its slabs concatenate to its
whole. K8 and K9 themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from tpucg.kernels.stencil import poisson3d_pallas, poisson3d_slab_pallas
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.kernels.stencil import (
    MARCH_AHEAD,
    MARCH_CHUNK,
    MARCH_GRID,
    MARCH_LANES,
    MARCH_MAX_SMEM,
    MARCH_MIN_BLOCKS,
    MARCH_PAD,
    MARCH_THREADS,
    STENCIL_MAX_M,
    poisson3d_cuda,
    poisson3d_slab_cuda,
    poisson3d_slab_torch,
    poisson3d_torch,
    stencil_march_plan,
)

SPARSE_CU = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc" / "sparse.cu"
MAX_INT_ROWS = 0x7FFFFFFF - (1 << 22)  # csrc/sparse.cuh kMaxIntRows

# The card's residency (hopper-kernels: H100 SXM): 228 KB of shared memory
# an SM, 1 KB of it kept by the runtime for each resident block, 2048
# threads and 65,536 registers an SM.
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
SM_THREADS = 2048
SM_REGISTERS = 65_536

MS = (2, 3, 10, 16, 100, 128, 129, 192, 1024, 1280)


def _mps(m):
    return sorted({mp for mp in (1, 2, m // 4, m) if mp >= 1 and mp * m * m <= MAX_INT_ROWS})


PLANS = [(m, mp, halo) for m in MS for mp in _mps(m) for halo in (False, True)
         if halo or mp == m]


def _axis(n, tile):
    """Tiles of [0, n) of length ``tile``: (start, stop) with stop clipped."""
    return [(a, min(a + tile, n)) for a in range(0, n, tile)]


@pytest.mark.parametrize("m,mp,halo", PLANS)
def test_tiles_cover_the_slab_once_and_stage_every_operand(m, mp, halo):
    plan = stencil_march_plan(m, mp, halo=halo)
    assert (plan.m, plan.mp, plan.halo) == (m, mp, halo)
    assert plan.grid == (plan.runs, plan.ny, plan.nz)
    runs, ys, zs = _axis(mp, plan.nx), _axis(m, plan.ty), _axis(m, plan.tz)
    assert (len(runs), len(ys), len(zs)) == plan.grid
    # Each axis is cut into contiguous pieces, in order, none empty: the
    # blocks (their product) cover every (x, y, z) exactly once. Within a
    # z tile, thread lz owns z0 = zt0 + 4 lz .. z0 + 3: the chunks tile it.
    for cut, n in ((runs, mp), (ys, m), (zs, m)):
        assert cut[0][0] == 0 and cut[-1][1] == n
        assert all(a < b for a, b in cut) and all(p[1] == q[0] for p, q in zip(cut, cut[1:]))
    chunks = np.arange(plan.cz) * MARCH_CHUNK
    assert np.array_equal(np.sort(np.add.outer(chunks, np.arange(MARCH_CHUNK)).ravel()),
                          np.arange(plan.tz))
    # Every operand of an output lies in what its block holds. A block
    # stages lines yt0 - 1 .. yt0 + ty and z zt0 - 1 .. zt0 + tz (its y and
    # z halo) and holds planes x0 - 1 .. x1 in registers; an operand outside
    # those is outside the grid (+0), or one of K9's halo planes -1 and mp.
    first, last = (-1, mp) if halo else (0, mp - 1)
    for x0, x1 in runs:
        held = set(range(max(x0 - 1, first), min(x1, last) + 1))
        for x in range(x0, x1):
            assert {x - 1, x + 1} & set(range(first, last + 1)) <= held
    # The staged lines and z come from the threads' places: line
    # yt0 + ly - 1 for ly < ty + 2, z zt0 + 4 lz + k and the z halo.
    assert plan.threads == plan.cz * (plan.ty + 2)
    for a, b in ys:
        lines = {a + ly - 1 for ly in range(plan.ty + 2)}
        assert set(range(a - 1, b + 1)) <= lines
    for a, b in zs:
        staged = {a + MARCH_CHUNK * lz + k for lz in range(plan.cz) for k in range(MARCH_CHUNK)}
        assert set(range(a - 1, b + 1)) <= staged | {a - 1, a + plan.tz}


@pytest.mark.parametrize("m,mp,halo", PLANS)
def test_shared_bytes_and_threads_fit_two_blocks_an_sm(m, mp, halo):
    plan = stencil_march_plan(m, mp, halo=halo)
    assert 1 <= plan.cz <= MARCH_LANES and plan.tz == MARCH_CHUNK * plan.cz
    assert plan.threads <= MARCH_THREADS
    assert plan.smem_bytes == 2 * 4 * (plan.ty + 2) * (plan.tz + 2 * MARCH_PAD)
    assert plan.smem_bytes <= MARCH_MAX_SMEM  # no opt-in needed
    assert MARCH_MIN_BLOCKS * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SMEM
    assert MARCH_MIN_BLOCKS * MARCH_THREADS <= SM_THREADS
    # __launch_bounds__(576, 2) leaves 56 registers a thread.
    assert SM_REGISTERS // (MARCH_MIN_BLOCKS * MARCH_THREADS) == 56
    # The grid: at most MARCH_GRID blocks, unless a plane alone has more
    # tiles.
    tiles = plan.ny * plan.nz
    if tiles <= MARCH_GRID:
        assert plan.blocks <= MARCH_GRID or plan.runs == 1
    assert plan.runs == -(-mp // plan.nx)


def _reckoned_reads(plan):
    """Elements the kernel loads, block by block under its predicates: a
    tile's own lines in the planes x0 - 1 .. x1 that exist, with the z halo
    where one lies in the grid; its y-halo lines in the planes x0 .. x1 - 1."""
    m, mp = plan.m, plan.mp
    first, last = (-1, mp) if plan.halo else (0, mp - 1)
    total = 0
    for (x0, x1), (y0, y1), (z0, z1) in itertools.product(
            _axis(mp, plan.nx), _axis(m, plan.ty), _axis(m, plan.tz)):
        planes = sum(1 for p in range(x0 - 1, x1 + 1) if first <= p <= last)
        zhalo = (z0 > 0) + (z0 + plan.tz < m)
        yhalo = sum(1 for yy in (y0 - 1, y0 + plan.ty) if 0 <= yy < m)
        total += planes * (y1 - y0) * (z1 - z0 + zhalo) + (x1 - x0) * yhalo * (z1 - z0)
    return total


@pytest.mark.parametrize("m,mp,halo", [p for p in PLANS if p[0] <= 192 or p[1] <= 2])
def test_stated_ratio_is_the_one_reckoned(m, mp, halo):
    plan = stencil_march_plan(m, mp, halo=halo)
    assert plan.slab_elements == (mp + 2 * halo) * m * m
    assert plan.reads == _reckoned_reads(plan)
    assert plan.ratio == plan.reads / plan.slab_elements
    assert f"u read {plan.ratio:.4f}x" in plan.describe()
    assert f"= {plan.blocks} blocks of {plan.threads} threads" in plan.describe()


def test_the_plans_tiles_at_the_main_shapes():
    # m = 128: whole lines of 128 z (no z halo), 16 lines (576 threads), runs
    # of 4 planes: 256 blocks, u read 1.59x; the larger grids keep the z
    # halo and longer runs, so their ratio falls toward (18/16)(130/128).
    p = stencil_march_plan(128)
    assert (p.tz, p.ty, p.nx, p.grid) == (128, 16, 4, (32, 8, 1))
    assert p.ratio == pytest.approx(1.59375)
    p = stencil_march_plan(256)
    assert (p.tz, p.ty, p.nx, p.grid) == (128, 16, 32, (8, 16, 2))
    assert p.ratio < 1.25
    # K9 at one rank: K8's tile; four ranks: runs of one plane.
    assert stencil_march_plan(128, 128, halo=True).nx == 4
    assert stencil_march_plan(128, 32, halo=True).nx == 1
    # m = 100 and 129: lines that are not a multiple of 32 chunks.
    assert stencil_march_plan(100).tz == 100 and stencil_march_plan(129).tz == 68


@pytest.mark.parametrize("m,mp", [(1, 1), (0, 4), (STENCIL_MAX_M + 1, 1), (8, 0), (8, -1),
                                  (2, MAX_INT_ROWS // 4 + 1), (1280, MAX_INT_ROWS // 1280 ** 2 + 1)])
def test_a_slab_out_of_range_raises(m, mp):
    with pytest.raises(ValueError, match="cannot plan"):
        stencil_march_plan(m, mp)


@pytest.mark.parametrize("kw", [dict(tz=6), dict(tz=0), dict(tz=132), dict(ty=0), dict(nx=0),
                                dict(ty=17), dict(tz=128, ty=600)])
def test_a_tile_it_cannot_launch_raises(kw):
    # ty = 17 at tz = 128: 19 lines of 32 threads, above the 576 bound.
    with pytest.raises(ValueError, match="cannot launch"):
        stencil_march_plan(128, **kw)


def test_forced_tiles_keep_what_is_not_forced():
    p = stencil_march_plan(128, tz=64)
    assert (p.tz, p.ty, p.nx) == (64, 16, 4) and p.nz == 2
    p = stencil_march_plan(128, 64, halo=True, ty=8, nx=16)
    assert (p.tz, p.ty, p.nx, p.runs) == (128, 8, 16, 4)


def test_plan_constants_are_the_kernels():
    src = SPARSE_CU.read_text()
    for name, value in (("kMarchChunk", MARCH_CHUNK), ("kMarchLanes", MARCH_LANES),
                        ("kMarchThreads", MARCH_THREADS), ("kMarchMinBlocks", MARCH_MIN_BLOCKS),
                        ("kMarchGrid", MARCH_GRID), ("kMarchAhead", MARCH_AHEAD),
                        ("kMarchPad", MARCH_PAD)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kMarchMaxSmem = 48 * 1024;" in src and MARCH_MAX_SMEM == 48 * 1024
    assert re.search(r"__launch_bounds__\(kMarchThreads, kMarchMinBlocks\)\s*\n"
                     r"poisson3d_march_kernel\(", src)
    # The plan's steps, as stencil_march_plan takes them.
    for step in ("const long long nz = (chunks + kMarchLanes - 1) / kMarchLanes;",
                 "t.cz = static_cast<int>((chunks + nz - 1) / nz);",
                 "std::min<long long>(m, kMarchThreads / t.cz - 2);",
                 "t.ty = static_cast<int>((m + ny - 1) / ny);",
                 "std::min<long long>(mp, kMarchGrid / (nz * ny))",
                 "t.nx = static_cast<int>((mp + runs - 1) / runs);"):
        assert step in src, step
    # Both entry points launch the one march; the grid-stride bodies are gone.
    assert src.count("launch_march<false>(") == 2 and src.count("launch_march<true>(") == 2
    assert "poisson3d_kernel" not in src and "poisson3d_slab_kernel" not in src
    assert "stencil_row" not in (SPARSE_CU.parent / "sparse.cuh").read_text()


def test_forced_plans_are_checked_before_the_card_is_needed():
    u = torch.zeros(8 ** 3)
    z = torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA device"):
        poisson3d_cuda(u, 8, _plan=stencil_march_plan(8, tz=4))
    with pytest.raises(ValueError, match="CUDA device"):
        poisson3d_slab_cuda(u, z, z, 8, _plan=stencil_march_plan(8, 8, halo=True))


def emulate_march(u, lo, hi, m, plan):
    """K8 (lo = hi = None) or K9 on ``plan`` as ``poisson3d_march_kernel``
    runs it, in NumPy float32: each block's threads load their chunks (and
    z halo) of planes x0 - 1, x0, x0 + 1 and MARCH_AHEAD more under the
    kernel's predicates, then for each plane stage the current one in one of
    two tiles (which start as NaN, so a read of a cell no thread wrote shows),
    sum each own element and shift the planes along. Returns y and the count
    of elements loaded."""
    mp, mm, cz, ty, tz = plan.mp, m * m, plan.cz, plan.ty, plan.tz
    assert (lo is None) == (not plan.halo) and u.size == mp * mm
    src = [p.reshape(-1) for p in u.reshape(mp, mm)]
    stride, rows = tz + 2 * MARCH_PAD, ty + 2
    ly, lz = np.divmod(np.arange(plan.threads), cz)
    y = np.full(mp * mm, np.nan, np.float32)
    written = np.zeros(mp * mm, np.int64)
    loaded = 0
    zero = np.float32(0)
    for bx, by, bz in itertools.product(*(range(g) for g in plan.grid)):
        zt0 = bz * tz
        z0 = zt0 + MARCH_CHUNK * lz
        yy = by * ty + ly - 1
        x0 = bx * plan.nx
        x1 = min(x0 + plan.nx, mp)
        line_in = (yy >= 0) & (yy < m)
        own = (ly >= 1) & (ly <= ty)
        zin = np.where(line_in, np.clip(m - z0, 0, MARCH_CHUNK), 0)
        off = np.where(line_in, yy * m + np.minimum(z0, m - 1), 0)
        take_l = own & line_in & (lz == 0) & (zt0 > 0)
        take_r = own & line_in & (lz == cz - 1) & (z0 + MARCH_CHUNK < m)

        def plane(p):
            if p > x1:
                return None
            if p < 0:
                return lo
            if p >= mp:
                return hi
            return src[p]

        def load(pl, all_):
            nonlocal loaded
            v = np.zeros((plan.threads, MARCH_CHUNK), np.float32)
            left = np.zeros(plan.threads, np.float32)
            right = np.zeros(plan.threads, np.float32)
            if pl is None:
                return v, left, right
            line = own | all_
            for k in range(MARCH_CHUNK):
                take = line & (k < zin)
                v[take, k] = pl[off[take] + k]
                loaded += int(take.sum())
            left[take_l] = pl[off[take_l] - 1]
            right[take_r] = pl[off[take_r] + MARCH_CHUNK]
            loaded += int(take_l.sum() + take_r.sum())
            return v, left, right

        prev = load(plane(x0 - 1), False)
        cur = load(plane(x0), True)
        nxt = load(plane(x0 + 1), x0 + 1 < x1)
        ahead = [load(plane(x0 + 2 + d), x0 + 2 + d < x1) for d in range(MARCH_AHEAD)]
        staged = np.full((2, rows * stride), np.nan, np.float32)
        mine = ly * stride + MARCH_PAD + MARCH_CHUNK * lz
        for x in range(x0, x1):
            s = staged[(x - x0) & 1]
            for k in range(MARCH_CHUNK):
                s[mine + k] = cur[0][:, k]
            s[mine[lz == 0] - 1] = cur[1][lz == 0]
            s[mine[lz == cz - 1] + MARCH_CHUNK] = cur[2][lz == cz - 1]
            t = np.flatnonzero(own & (zin > 0))
            for k in range(MARCH_CHUNK):
                at = mine[t] + k
                acc = np.float32(6) * cur[0][t, k]
                for nb in (nxt[0][t, k], prev[0][t, k], s[at + stride], s[at - stride],
                           s[at + 1], s[at - 1]):
                    acc = acc - nb
                assert acc.dtype == np.float32
                keep = k < zin[t]
                idx = x * mm + off[t][keep] + k
                y[idx] = acc[keep]
                written[idx] += 1
            prev, cur, nxt = cur, nxt, ahead[0]
            ahead = ahead[1:] + [load(plane(x + 2 + MARCH_AHEAD), x + 2 + MARCH_AHEAD < x1)]
    assert np.all(written == 1), "an element was summed twice or never"
    return y, loaded


def _u(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _scale(u, m):
    """6 |u| + sum of |neighbours| per point: 12 |u| - A|u|."""
    a = torch.from_numpy(np.abs(u))
    return (12 * a - poisson3d_torch(a, m)).numpy()


# Shapes and forced tiles that reach every part of the march: one tile
# (m = 2, 3, 10), several y tiles and runs with partial last ones, a tile
# narrower than the line (z halo on both sides, a partial last z tile),
# runs of one plane, chunks partly outside the grid (m % 4 != 0).
K8_CASES = [(2, {}), (3, {}), (10, {}), (16, {}), (33, {}), (12, dict(tz=8, ty=5, nx=5)),
            (13, dict(tz=4, ty=3, nx=2)), (18, dict(tz=8, ty=7, nx=1)),
            (20, dict(tz=12, ty=20, nx=20)), (16, dict(tz=8, ty=16, nx=3))]


@pytest.mark.parametrize("m,kw", K8_CASES)
def test_emulated_k8_equals_the_plain_stencil_and_tpucgs_xla_form(m, kw):
    plan = stencil_march_plan(m, **kw)
    u = _u(m ** 3, seed=m)
    y, loaded = emulate_march(u, None, None, m, plan)
    assert loaded == plan.reads
    np.testing.assert_array_equal(y, poisson3d_torch(torch.from_numpy(u), m).numpy())
    np.testing.assert_array_equal(y, np.asarray(JPoissonOperator(m=m)._matvec_xla(u)))


def test_emulated_k8_keeps_signed_zeros():
    # The corner row 0 is -0 with +0 at its three in-grid neighbours: its sum
    # stays -0 only if each neighbour outside the grid subtracts +0.
    m = 12
    u = _u(m ** 3, seed=1)
    u[np.random.default_rng(2).integers(0, m ** 3, 64)] = -0.0
    u[0], u[1], u[m], u[m * m] = -0.0, 0.0, 0.0, 0.0
    want = poisson3d_torch(torch.from_numpy(u), m).numpy()
    assert np.signbit(want[0]) and want[0] == 0
    for kw in ({}, dict(tz=8, ty=5, nx=5)):
        y, _ = emulate_march(u, None, None, m, stencil_march_plan(m, **kw))
        np.testing.assert_array_equal(y.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("m", [16, 32])
def test_emulated_k8_matches_tpucgs_pallas_stencil(m):
    # tpucg's Pallas body in interpret mode rounds otherwise than its XLA
    # form (tests/test_torch_stencil.py): held to 1e-6 of sum |a x|.
    u = _u(m ** 3, seed=m + 1)
    y, _ = emulate_march(u, None, None, m, stencil_march_plan(m))
    pallas = np.asarray(poisson3d_pallas(jnp.asarray(u), m))
    assert np.all(np.abs(y - pallas) <= 1e-6 * _scale(u, m))


def _slabs(m, P):
    """Plane counts of P ranks over m planes, the first m % P one plane more."""
    return [m // P + (r < m % P) for r in range(P)]


@pytest.mark.parametrize("m,P,kw", [(10, 1, {}), (10, 2, {}), (10, 3, {}), (10, 4, {}),
                                    (9, 4, dict(tz=4, ty=4, nx=1)), (16, 3, dict(tz=8, nx=2)),
                                    (7, 4, {}), (12, 4, dict(ty=5, nx=1))])
def test_emulated_k9_equals_plain_and_its_slabs_concatenate_to_k8(m, P, kw):
    mm = m * m
    u = _u(m ** 3, seed=10 * m + P)
    whole, _ = emulate_march(u, None, None, m, stencil_march_plan(m))
    parts, start = [], 0
    for mp in _slabs(m, P):
        ub = u[start * mm:(start + mp) * mm]
        zero = np.zeros(mm, np.float32)
        lo = u[(start - 1) * mm:start * mm] if start > 0 else zero
        hi = u[(start + mp) * mm:(start + mp + 1) * mm] if start + mp < m else zero
        plan = stencil_march_plan(m, mp, halo=True, **kw)
        y, loaded = emulate_march(ub, lo, hi, m, plan)
        assert loaded == plan.reads
        np.testing.assert_array_equal(y, poisson3d_slab_torch(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in (ub, lo, hi)), m).numpy())
        parts.append(y)
        start += mp
    np.testing.assert_array_equal(np.concatenate(parts), whole)


@pytest.mark.parametrize("mp", [1, 3, 5])
def test_emulated_k9_matches_tpucgs_pallas_slab(mp):
    m = 16  # tpucg's slab kernel needs (m*m) % 128 == 0
    rng = np.random.default_rng(mp)
    u, lo, hi = (rng.standard_normal(n).astype(np.float32) for n in (mp * m * m, m * m, m * m))
    y, _ = emulate_march(u, lo, hi, m, stencil_march_plan(m, mp, halo=True))
    want = np.asarray(poisson3d_slab_pallas(jnp.asarray(u).reshape(mp, m * m), jnp.asarray(lo),
                                            jnp.asarray(hi), m)).reshape(-1)
    au, alo, ahi = (torch.from_numpy(np.abs(a)) for a in (u, lo, hi))
    scale = (12 * au - poisson3d_slab_torch(au, alo, ahi, m)).numpy()
    assert np.all(np.abs(y - want) <= 1e-6 * scale)
