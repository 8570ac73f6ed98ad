"""The lap's scalar work folded into K2 and K3, on the CPU.

The loop that ran before it is transcribed here (``reference_cg_loop``,
with the plain lap closures it ran on), and ``cg_loop`` on the plain route
(``lap_ops(op, "torch")``: ``TorchLap``, whose alpha, tail and p update are
the plain versions of K3's alpha mode, K2's and K3's tails and p's update)
is held to it bit for bit: k, x, r, p, rsold, rslast, done and hist. Then
the NumPy emulation of K2's and K3's one-launch order
(``tests/_torch_helpers.py`` ``dot_emulated``, ``fused_update_emulated``),
which the card tests hold the kernels to bit for bit: its constants and
statements are read from ``csrc/``, and it is checked against a scalar
restatement of the order and against exact sums. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_helpers import (
    BLAS_BLOCK,
    BLAS_MAX_PARTIALS,
    BLAS_PER_BLOCK,
    blas_block_sum,
    blas_last_block_sum,
    blas_partials,
    blas_reduce_blocks,
    dot_emulated,
    fma32,
    fused_update_emulated,
    random_banded_dia,
)
from tpucg_torch.io.generator import generate_spd_system, poisson3d_dia
from tpucg_torch.kernels.blas1 import (
    LapTail,
    alpha_torch,
    dot_alpha_torch,
    dot_torch,
    fused_update_torch,
    lap_tail_torch,
    p_update_torch,
)
from tpucg_torch.solver.cg import (
    CHUNK_MAX,
    _State,
    cg_loop,
    cg_solve,
    init_state,
    lap_ops,
    make_precond,
)
from tpucg_torch.solver.operators import DenseOperator, DiaOperator, PoissonOperator

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc"
FIELDS = ("k", "x", "r", "p", "rsold", "rslast", "done", "hist")


# ---- the loop before K2 and K3 took its scalars, transcribed ------------------


def reference_lap_ops(op):
    """The plain route's (matvec, dot, update) closures as they were."""
    def dot(u, v, act):
        return dot_torch(u, v)

    def update(x, r, p, ap, alpha, act):
        xn, rn, rr = fused_update_torch(x, r, p, ap, alpha)
        keep = act.bool()
        return torch.where(keep, xn, x), torch.where(keep, rn, r), rr
    return op.matvec, dot, update


def reference_cg_loop(matvec, dot, update, b, x0, *, tol, maxiter, safe_alpha=True,
                      state=None, precond=None, hist_len=None, chunk=None):
    """``cg_loop``'s body as it was, statement for statement."""
    if state is None:
        state = init_state(matvec, dot, b, x0, tol, precond=precond, hist_len=hist_len)
    k, _, _, p, rsold, rslast, done, hist = state
    x = state.x.clone(memory_format=torch.contiguous_format)
    r = state.r.clone(memory_format=torch.contiguous_format)
    p = p.contiguous()
    tol2 = torch.tensor(tol, dtype=r.dtype, device=r.device) ** 2
    pos = None if hist is None else torch.arange(hist.numel(), device=r.device)
    active = ~done & (k < maxiter)
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(laps):
            act = active.to(torch.int32)
            ap = matvec(p, act)
            pap = dot(p, ap, act)
            alpha = torch.where(pap != 0, rsold / pap, 0.0) if safe_alpha else rsold / pap
            x, r, rr = update(x, r, p, ap, alpha, act)
            stop = rr < tol2
            if precond is None:
                z, rs_new = r, rr
            else:
                z = precond(r, act)
                rs_new = dot(r, z, act)
            step = active & ~stop
            p = torch.where(step, z + (rs_new / rsold) * p, p)
            rsold = torch.where(step, rs_new, rsold)
            rslast = torch.where(active, rr, rslast)
            if hist is not None:
                hist = torch.where(active & (pos == k + 1), rr.sqrt(), hist)
            done = done | (active & stop)
            k = k + act
            active = ~done & (k < maxiter)
        if not bool(active):
            break
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)
    return _State(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rslast, done=done, hist=hist)


def bits(t):
    """A tensor's bits: f32 as int32 (NaNs compare by payload)."""
    if t is None:
        return None
    return t.reshape(-1).view(torch.int32) if t.dtype == torch.float32 else t.reshape(-1)


def assert_same_state(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(bits(a), bits(b)), f


# ---- the systems ----------------------------------------------------------------


def _system(kind):
    """(operator, padded b, tol) on the CPU."""
    if kind == "dense":
        A, b, _ = generate_spd_system(300, seed=3)
        op = DenseOperator.create(A, device=CPU)
        return op, F.pad(torch.from_numpy(b), (0, op.padded_n - 300)), 1e-6
    if kind == "poisson":
        op = PoissonOperator(8, device=CPU)
        b = np.random.default_rng(5).standard_normal(512).astype(np.float32)
        return op, torch.from_numpy(b), 1e-5 * float(np.linalg.norm(b))
    if kind == "dia":
        offsets, data, b = random_banded_dia(1024, (0, -1, 1, -9, 9, -40, 40), seed=7)
        op = DiaOperator(data=torch.from_numpy(data), offsets=offsets, n=1024)
        return op, torch.from_numpy(b), 1e-5 * float(np.linalg.norm(b))
    if kind == "dia poisson":
        op = DiaOperator.from_dia(poisson3d_dia(6), device=CPU)  # 216 padded to 256
        b = np.random.default_rng(6).standard_normal(216).astype(np.float32)
        return op, F.pad(torch.from_numpy(b), (0, op.padded_n - 216)), \
            1e-5 * float(np.linalg.norm(b))
    raise ValueError(kind)


def _precond(pc, op, matvec, dot, b):
    minv = None
    if pc == "jacobi":
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0)
    return make_precond(pc, minv, matvec, dot, b, 3)


def _both(op, b, x0, pc="none", **kw):
    """(the refactored plain route's state, the transcribed loop's) on the
    same inputs, from one preconditioner."""
    matvec, dot, lap = lap_ops(op, "torch")
    precond = _precond(pc, op, matvec, dot, b)
    got = cg_loop(matvec, dot, lap, b, x0, precond=precond, **kw)
    want = reference_cg_loop(*reference_lap_ops(op), b, x0, precond=precond, **kw)
    return got, want


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
@pytest.mark.parametrize("kind", ["dense", "poisson", "dia", "dia poisson"])
def test_plain_lap_is_todays_bit_for_bit(kind, pc):
    op, b, tol = _system(kind)
    got, want = _both(op, b, torch.zeros_like(b), pc, tol=tol, maxiter=op.padded_n)
    assert bool(want.done) and int(want.k) > 2
    assert_same_state(got, want)


@pytest.mark.parametrize("kind", ["dense", "poisson", "dia"])
def test_safe_alpha_false_bit_for_bit(kind):
    op, b, tol = _system(kind)
    got, want = _both(op, b, torch.zeros_like(b), tol=tol, maxiter=op.padded_n,
                      safe_alpha=False)
    assert bool(want.done)
    assert_same_state(got, want)


@pytest.mark.parametrize("safe_alpha", [True, False])
@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_pap_zero_bit_for_bit(pc, safe_alpha):
    # A = 2 I: the first lap takes alpha = 1/2 exactly (1 under jacobi) and
    # leaves r = 0, so at tol = 0 the second lap sees p = 0 and p.Ap = 0:
    # alpha = 0 with safe_alpha, NaN (0 / 0) without.
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(128).astype(np.float32))
    op = DenseOperator.create(2 * np.eye(128, dtype=np.float32), device=CPU)
    got, want = _both(op, b, torch.zeros_like(b), pc, tol=0.0, maxiter=2,
                      safe_alpha=safe_alpha)
    assert int(want.k) == 2 and not bool(want.done)
    assert (float(want.rslast) == 0.0) == safe_alpha
    assert bool(torch.isnan(want.x).any()) != safe_alpha
    assert_same_state(got, want)


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_maxiter_cut_steps_p_on_its_last_lap(pc):
    # The lap that reaches maxiter steps p though it leaves the loop
    # inactive; the doubling chunks then run frozen laps after it.
    op, b, tol = _system("dense")
    got, want = _both(op, b, torch.zeros_like(b), pc, tol=tol * 1e-3, maxiter=3)
    assert int(want.k) == 3 and not bool(want.done)
    before = _both(op, b, torch.zeros_like(b), pc, tol=tol * 1e-3, maxiter=2)[1]
    assert not torch.equal(want.p, before.p)
    assert_same_state(got, want)


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_exact_x0_stops_at_k0(pc):
    op, b, tol = _system("dense")
    eye = DenseOperator.create(np.eye(op.padded_n, dtype=np.float32), device=CPU)
    got, want = _both(eye, b, b.clone(), pc, tol=tol, maxiter=op.padded_n)
    assert int(want.k) == 0 and bool(want.done)
    assert_same_state(got, want)


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_resume_from_a_state_bit_for_bit(pc):
    op, b, tol = _system("poisson")
    first = _both(op, b, torch.zeros_like(b), pc, tol=tol, maxiter=3, hist_len=64)[1]
    kept = [None if t is None else t.clone() for t in first]
    matvec, dot, lap = lap_ops(op, "torch")
    precond = _precond(pc, op, matvec, dot, b)
    got = cg_loop(matvec, dot, lap, None, None, tol=tol, maxiter=64, state=first,
                  precond=precond)
    want = reference_cg_loop(*reference_lap_ops(op), None, None, tol=tol, maxiter=64,
                             state=first, precond=precond)
    assert int(want.k) > 3
    assert_same_state(got, want)
    for t, k in zip(first, kept):  # the state handed in is left as it was
        assert (t is None and k is None) or torch.equal(bits(t), bits(k))


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_record_residuals_bit_for_bit(kind, pc):
    op, b, tol = _system(kind)
    got, want = _both(op, b, torch.zeros_like(b), pc, tol=tol, maxiter=200, hist_len=200)
    assert bool(torch.isfinite(want.hist[:int(want.k) + 1]).all())
    assert bool(torch.isnan(want.hist[int(want.k) + 1:]).all())
    assert_same_state(got, want)


@pytest.mark.parametrize("chunk", [None, 1, 3, 64])
@pytest.mark.parametrize("pc", ["none", "poly"])
def test_chunks_bit_for_bit(chunk, pc):
    op, b, tol = _system("dia poisson")
    got, want = _both(op, b, torch.zeros_like(b), pc, tol=tol, maxiter=200, hist_len=200,
                      chunk=chunk)
    assert_same_state(got, want)
    doubling = _both(op, b, torch.zeros_like(b), pc, tol=tol, maxiter=200, hist_len=200)[0]
    assert_same_state(got, doubling)


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_cg_solve_plain_route_is_todays(pc):
    A, b, x0 = generate_spd_system(300, seed=9)
    res = cg_solve(A, b, x0, device=CPU, precondition=pc, poly_degree=3,
                   record_residuals=True, tol=1e-6)
    op = DenseOperator.create(A, device=CPU)
    pad = op.padded_n - 300
    bp, x0p = (F.pad(torch.from_numpy(v), (0, pad)) for v in (b, x0))
    matvec, dot, update = reference_lap_ops(op)
    want = reference_cg_loop(matvec, dot, update, bp, x0p, tol=1e-6, maxiter=300,
                             precond=_precond(pc, op, matvec, dot, bp), hist_len=300)
    assert torch.equal(bits(res.x), bits(want.x[:300]))
    assert torch.equal(res.iterations, want.k)
    assert torch.equal(bits(res.residual_norm), bits(want.rslast.sqrt()))
    assert torch.equal(bits(res.residual_history), bits(want.hist))


# ---- the plain versions of the folded scalar work --------------------------------


def test_alpha_plain_versions_are_todays():
    rsold = torch.tensor(3.5)
    for pap in (torch.tensor(0.7), torch.tensor(0.0), torch.tensor(-0.0), torch.tensor(1e-40),
                torch.tensor(float("nan"))):
        for safe in (True, False):
            want = torch.where(pap != 0, rsold / pap, 0.0) if safe else rsold / pap
            assert torch.equal(bits(alpha_torch(pap, rsold, safe)), bits(want))
    u, v = (torch.from_numpy(np.random.default_rng(s).standard_normal(300).astype(np.float32))
            for s in (0, 1))
    before = dot_alpha_torch.launches
    pap, alpha = dot_alpha_torch(u, v, rsold)
    assert dot_alpha_torch.launches == before + 1
    assert torch.equal(pap, torch.dot(u, v)) and torch.equal(alpha, rsold / torch.dot(u, v))


def _tail_state(active=True, k=3, hist=True, done=False):
    return LapTail(k=torch.tensor(k, dtype=torch.int32), rsold=torch.tensor(2.0),
                   rslast=torch.tensor(5.0), done=torch.tensor(done),
                   active=torch.tensor(active),
                   hist=torch.full((8,), float("nan")) if hist else None)


@pytest.mark.parametrize("rr, rs_new, want_step", [(0.5, 0.25, True), (1e-9, 1e-9, False)])
def test_lap_tail_plain(rr, rs_new, want_step):
    t = lap_tail_torch(_tail_state(), torch.tensor(rr), torch.tensor(rs_new),
                       torch.tensor(1e-4) ** 2, 5)
    assert bool(t.step) == want_step and bool(t.done) == (not want_step)
    assert int(t.k) == 4 and bool(t.active) == want_step
    assert float(t.rsold) == (rs_new if want_step else 2.0)
    assert float(t.rslast) == np.float32(rr) and float(t.beta) == np.float32(rs_new) / 2
    assert float(t.hist[4]) == float(torch.tensor(rr).sqrt())
    assert int(torch.isnan(t.hist).sum()) == 7


def test_lap_tail_plain_reaching_maxiter_steps_and_stops():
    t = lap_tail_torch(_tail_state(k=4), torch.tensor(0.5), torch.tensor(0.25),
                       torch.tensor(1e-8), 5)
    assert bool(t.step) and not bool(t.active) and not bool(t.done) and int(t.k) == 5


def test_frozen_lap_tail_and_p_update_change_nothing():
    s = _tail_state(active=False, done=True)  # stopped: frozen from here on
    t = lap_tail_torch(s, torch.tensor(0.5), torch.tensor(0.25), torch.tensor(1e-8), 5)
    for f in ("k", "rsold", "rslast", "done", "active", "hist"):
        assert torch.equal(bits(getattr(t, f)), bits(getattr(s, f))), f
    assert not bool(t.step)
    z, p = torch.ones(4), torch.arange(4.0)
    assert torch.equal(p_update_torch(z, p, t.beta, t.step), p)
    assert torch.equal(p_update_torch(z, p, torch.tensor(0.5), torch.tensor(True)),
                       z + 0.5 * p)


# ---- the emulation of K2's and K3's one-launch order ----------------------------


def test_emulation_constants_and_statements_are_the_kernels():
    header = (CSRC / "blas.cuh").read_text()
    src = (CSRC / "blas.cu").read_text()
    assert f"constexpr int kBlock = {BLAS_BLOCK};" in header
    assert f"constexpr int kMaxPartials = {BLAS_MAX_PARTIALS};" in header
    assert BLAS_PER_BLOCK == 4 * BLAS_BLOCK
    assert "long long b = (n + 4LL * kBlock - 1) / (4LL * kBlock);" in header
    # block_sum: each warp's shuffle-down tree, warp 0 over the warp sums.
    assert "for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);" \
        in header
    assert "s = lane < kBlock / 32 ? warp_sums[lane] : 0.f;" in header
    # Stage 1 (K3, K2): a thread's elements b kBlock + t, + stride, ... in
    # order, kLoads of them loaded first; the last block's sum; the update's
    # roundings.
    assert src.count("for (long long i = static_cast<long long>(blockIdx.x) * kBlock + "
                     "threadIdx.x; i < n;\n       i += kLoads * stride) {") == 3
    assert src.count("const long long e = i + j * stride;") == 5
    assert "if (i + j * stride < n) acc = fmaf(a[j], b[j], acc);" in src
    assert "a[j] = e < n ? u[e] : 0.f;" in src and "b[j] = e < n ? v[e] : 0.f;" in src
    assert "const float xn = fmaf(a, ps[j], xs[j]);" in src
    assert "const float rn = fmaf(-a, aps[j], rs[j]);" in src
    assert "acc = fmaf(rn, rn, acc);" in src
    assert re.search(r"for \(int i = threadIdx\.x; i < static_cast<int>\(gridDim\.x\); "
                     r"i \+= kBlock\)\s+acc \+= __ldcg\(partials \+ i\);", src)
    assert src.count("last_block_sum(block_sum(acc), partials, ticket, total)") == 2
    assert "if (e < n) p[e] = __fadd_rn(zs[j], __fmul_rn(b, ps[j]));" in src
    assert "*s.beta = __fdiv_rn(rs_new, in.rsold);" in src
    assert "s.hist[in.k + 1] = __fsqrt_rn(rr);" in src


@pytest.mark.parametrize("n, nb", [(1, 1), (1024, 1), (1025, 2), (8192, 8), (299_964, 293),
                                   (1024 * 1024, 1024), (128 ** 3, 1024)])
def test_reduce_blocks(n, nb):
    assert blas_reduce_blocks(n) == nb
    assert blas_partials(np.ones(n, np.float32), np.ones(n, np.float32)).shape == (nb,)


def _restated_dot(u, v):
    """The one-launch order restated element by element: block b's thread t
    takes b 256 + t, + nb 256, ...; the warps' trees; warp 0's tree over the
    warp sums; then the last block's thread-strided sum and its tree."""
    n = len(u)
    nb = blas_reduce_blocks(n)

    def tree(vals):  # shuffle down: lane i adds lane i + off
        vals = [np.float32(x) for x in vals] + [np.float32(0)] * (32 - len(vals))
        for off in (16, 8, 4, 2, 1):
            vals = [np.float32(vals[i] + vals[i + off]) if i + off < 32 else vals[i]
                    for i in range(32)]
        return vals[0]

    def block(acc):
        return tree([tree(acc[w * 32:(w + 1) * 32]) for w in range(BLAS_BLOCK // 32)])

    partials = []
    for bi in range(nb):
        acc = []
        for t in range(BLAS_BLOCK):
            a = np.float32(0)
            for i in range(bi * BLAS_BLOCK + t, n, nb * BLAS_BLOCK):
                a = fma32(u[i], v[i], a)
            acc.append(np.float32(a))
        partials.append(block(acc))
    acc = [np.float32(0)] * BLAS_BLOCK
    for i, part in enumerate(partials):
        acc[i % BLAS_BLOCK] = np.float32(acc[i % BLAS_BLOCK] + part)
    return block(acc)


@pytest.mark.parametrize("n", [1, 255, 1500, 5000])
def test_emulated_dot_is_the_restated_order(n):
    rng = np.random.default_rng(n)
    u, v = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    assert torch.equal(bits(torch.tensor(dot_emulated(u, v))),
                       bits(torch.tensor(_restated_dot(u, v))))


def test_last_block_sum_is_thread_strided():
    parts = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    acc = [np.float32(0)] * BLAS_BLOCK
    for i, part in enumerate(parts):
        acc[i % BLAS_BLOCK] = np.float32(acc[i % BLAS_BLOCK] + part)
    assert blas_last_block_sum(parts) == blas_block_sum(np.array(acc, np.float32))
    assert blas_last_block_sum(parts[:1]) == parts[0]


N_CARD = [1, 255, 8192, 16384, 128 ** 3, 299_964]


@pytest.mark.parametrize("n", N_CARD)
def test_emulated_dot_is_exact_on_small_integers(n):
    # Every partial sum is an integer below 2^24: exact in any order.
    rng = np.random.default_rng(n)
    u, v = (rng.integers(-1, 2, n).astype(np.float32) for _ in range(2))
    assert dot_emulated(u, v) == np.float32(int(np.dot(u.astype(np.int64), v.astype(np.int64))))


@pytest.mark.parametrize("n", N_CARD)
def test_emulated_update_against_float64(n):
    rng = np.random.default_rng(n + 1)
    x, r, p, ap = (rng.standard_normal(n).astype(np.float32) for _ in range(4))
    alpha = np.float32(0.37)
    xn, rn, rr = fused_update_emulated(x, r, p, ap, alpha)
    x64 = x.astype(np.float64) + np.float64(alpha) * p
    r64 = r.astype(np.float64) - np.float64(alpha) * ap
    # One rounding each (fma): within half an ulp of the exact value (x64
    # and r64 are within 2^-53 of it).
    for got, exact in ((xn, x64), (rn, r64)):
        half_ulp = np.spacing(np.abs(got)).astype(np.float64) / 2
        assert np.all(np.abs(got - exact) <= half_ulp * (1 + 1e-6) + 1e-45)
    rr64 = float(np.dot(rn.astype(np.float64), rn.astype(np.float64)))
    assert abs(float(rr) - rr64) <= 1e-5 * rr64
    assert rr == dot_emulated(rn, rn)
