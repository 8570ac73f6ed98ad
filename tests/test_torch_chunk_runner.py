"""The one chunk runner under every loop (``run_chunks``): its schedule, and
``cg_loop`` and ``batch_cg_loop`` on it bit for bit equal to the loops as
they stood before it (transcribed here), on the CPU."""

import numpy as np
import pytest
import torch

from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.solver.cg import (
    CHUNK_MAX,
    _BatchState,
    _batch_dot,
    _State,
    batch_cg_loop,
    batch_matvec,
    cg_loop,
    init_state,
    lap_ops,
    make_precond,
    run_chunks,
)
from tpucg_torch.solver.operators import DenseOperator
from _torch_helpers import circulant_spd_batch

CPU = torch.device("cpu")


def _schedule(n_true, chunk=None, laps_per_step=1):
    """Steps a chunk, for a loop that stops after ``n_true`` host reads say
    it still runs."""
    chunks, reads = [0], [0]

    def step():
        chunks[-1] += 1

    def running():
        reads[0] += 1
        if reads[0] > n_true:
            return False
        chunks.append(0)
        return True
    run_chunks(step, running, chunk, laps_per_step)
    return chunks


@pytest.mark.parametrize("laps_per_step, chunk, want", [
    (1, None, [1, 2, 4, 8, 16, 32, 64, 64, 64]),
    (3, None, [1, 1, 1, 2, 5, 10, 21, 21, 21]),
    (8, None, [1, 1, 1, 1, 2, 4, 8, 8, 8]),
    (1, 5, [5] * 9),
    (8, 5, [1] * 9),
    (8, 20, [2] * 9),
])
def test_run_chunks_schedule(laps_per_step, chunk, want):
    assert CHUNK_MAX == 64
    assert _schedule(8, chunk, laps_per_step) == want


def test_run_chunks_refuses_a_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        run_chunks(lambda: None, lambda: False, 0)


def _parent_cg_loop(matvec, dot, lap, b, x0, *, tol, maxiter, precond=None, hist_len=None,
                    chunk=None):
    """``cg_loop``'s chunk loop before the runner, transcribed."""
    state = init_state(matvec, dot, b, x0, tol, precond=precond, hist_len=hist_len)
    x, r, p = (v.clone(memory_format=torch.contiguous_format)
               for v in (state.x, state.r, state.p))
    tol2 = torch.tensor(tol, dtype=r.dtype, device=r.device) ** 2
    lap.start(state, tol2, maxiter, True, precond is not None)
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(laps):
            act = lap.flag()
            ap = matvec(p, act)
            alpha = lap.alpha(p, ap, act)
            x, r = lap.update(x, r, p, ap, alpha, act)
            if precond is None:
                z = r
            else:
                z = precond(r, act)
                lap.tail(r, z, act)
            p = lap.p_update(z, p)
        if not lap.running():
            break
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)
    t = lap.finish()
    return _State(k=t.k, x=x, r=r, p=p, rsold=t.rsold, rslast=t.rslast, done=t.done,
                  hist=t.hist)


def _parent_batch_cg_loop(matvec, b, x0, *, tol, maxiter, precond=None, chunk=None):
    """``batch_cg_loop``'s chunk loop before the runner, transcribed."""
    dot = _batch_dot
    x = x0.clone()
    r = b - matvec(x, None)
    tol2 = torch.tensor(tol, dtype=r.dtype, device=r.device) ** 2
    rr = dot(r, r)
    if precond is None:
        p, rsold = r, rr
    else:
        p = precond(r, None)
        rsold = dot(r, p)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    rslast, done = rr, rr < tol2
    active = ~done & (k < maxiter)
    laps = 1 if chunk is None else chunk
    while True:
        for _ in range(laps):
            ap = matvec(p, None)
            pap = dot(p, ap)
            alpha = torch.where(pap != 0, rsold / pap, 0.0)
            on = active[:, None]
            x = torch.where(on, x + alpha[:, None] * p, x)
            r = torch.where(on, r - alpha[:, None] * ap, r)
            rr = dot(r, r)
            stop = rr < tol2
            if precond is None:
                z, rs_new = r, rr
            else:
                z = precond(r, None)
                rs_new = dot(r, z)
            step = active & ~stop
            p = torch.where(step[:, None], z + (rs_new / rsold)[:, None] * p, p)
            rsold = torch.where(step, rs_new, rsold)
            rslast = torch.where(active, rr, rslast)
            done = done | (active & stop)
            k = k + active.to(torch.int32)
            active = ~done & (k < maxiter)
        if not bool(active.any()):
            break
        if chunk is None:
            laps = min(2 * laps, CHUNK_MAX)
    return _BatchState(k=k, x=x, r=r, p=p, rsold=rsold, rslast=rslast, done=done)


def _same(a, b):
    for f, u, v in zip(a._fields, a, b):
        if u is None or v is None:
            assert u is None and v is None, f
        else:
            assert torch.equal(u.nan_to_num(-1.0) if u.is_floating_point() else u,
                               v.nan_to_num(-1.0) if v.is_floating_point() else v), f


@pytest.mark.parametrize("pc", ["none", "jacobi", "block_jacobi", "poly"])
@pytest.mark.parametrize("chunk, maxiter", [(None, 300), (1, 300), (3, 300), (None, 7)])
def test_cg_loop_on_the_runner_is_the_parent_loop(pc, chunk, maxiter):
    n = 300
    A, b, x0 = generate_spd_system(n, seed=4)
    s = (10.0 ** np.linspace(0.0, 1.0, n)).astype(np.float32)
    A, b = (s[:, None] * A * s[None, :]).astype(np.float32), (s * b).astype(np.float32)
    op = DenseOperator.create(A, device=CPU)
    bp = torch.nn.functional.pad(torch.from_numpy(b), (0, op.padded_n - n))
    x0p = torch.nn.functional.pad(torch.from_numpy(x0), (0, op.padded_n - n))
    minv = None
    if pc == "jacobi":
        minv = 1.0 / op.diagonal()
    elif pc == "block_jacobi":
        from tpucg_torch.solver.cg import block_jacobi_minv
        minv = block_jacobi_minv(op, 32)
    runs = []
    for loop in (cg_loop, _parent_cg_loop):
        matvec, dot, lap = lap_ops(op, "torch")
        precond = make_precond(pc, minv, matvec, dot, bp, 3) if pc != "none" else None
        runs.append(loop(matvec, dot, lap, bp, x0p, tol=1e-4 * float(bp.norm()),
                         maxiter=maxiter, precond=precond, hist_len=maxiter, chunk=chunk))
    _same(*runs)
    assert int(runs[0].k) > 2


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
@pytest.mark.parametrize("chunk", [None, 1, 5])
def test_batch_cg_loop_on_the_runner_is_the_parent_loop(pc, chunk):
    A, b, X0 = circulant_spd_batch(6, 256, seed=1)
    A, b, X0 = (torch.from_numpy(a) for a in (A, b, X0))
    matvec = batch_matvec(A)
    minv = 1.0 / torch.diagonal(A, dim1=1, dim2=2) if pc == "jacobi" else None
    precond = make_precond(pc, minv, matvec, _batch_dot, b, 2) if pc != "none" else None
    kw = dict(tol=1e-2, maxiter=256, precond=precond, chunk=chunk)
    _same(batch_cg_loop(matvec, b, X0, **kw), _parent_batch_cg_loop(matvec, b, X0, **kw))
