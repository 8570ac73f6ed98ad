"""Carrying operators and loop state from tpucg into tpucg_torch, and one
lap of each package from the same state."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import rel_err
from tpucg.kernels.blas1 import dot_xla, fused_update
from tpucg.solver.cg import cg_loop as jax_cg_loop
from tpucg_torch.interop import (
    STATE_FIELDS,
    dense_operator_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.solver.cg import cg_loop, lap_ops
from tpucg_torch.solver.operators import DenseOperator


@pytest.mark.parametrize("n, dtype", [(100, "f32"), (256, "f32"), (300, "bf16")])
def test_dense_operator_from_tpucg(n, dtype):
    A, _, _ = generate_spd_system(n, seed=0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    ref = tpucg.DenseOperator.create(A, backend="pallas", dtype=jdt)
    op = dense_operator_from_numpy(np.asarray(ref.A), n)
    own = DenseOperator.create(A, dtype=tdt, device="cpu")
    assert op.n == own.n == n and op.padded_n == own.padded_n == ref.padded_n
    assert op.A.dtype == tdt
    assert torch.equal(op.A, own.A)


def test_dense_operator_from_numpy_checks_padding():
    A, _, _ = generate_spd_system(100, seed=0)
    padded = DenseOperator.create(A, device="cpu").A.numpy()
    with pytest.raises(ValueError, match="expected a"):
        dense_operator_from_numpy(padded[:120, :120], 100)
    bad = padded.copy()
    bad[110, 110] = 2.0
    with pytest.raises(ValueError, match="identity tail"):
        dense_operator_from_numpy(bad, 100)
    bad = padded.copy()
    bad[3, 105] = 1.0
    with pytest.raises(ValueError, match="identity tail"):
        dense_operator_from_numpy(bad, 100)


@pytest.mark.parametrize("k", [1, 2])
def test_one_lap_from_a_tpucg_state(k):
    n, tol = 300, 1e-6
    A, b, x0 = generate_spd_system(n, seed=2)
    op_j = tpucg.DenseOperator.create(A, backend="pallas")
    npad = op_j.padded_n
    bp = jnp.pad(jnp.asarray(b), (0, npad - n))
    x0p = jnp.pad(jnp.asarray(x0), (0, npad - n))
    update = functools.partial(fused_update, backend="pallas")
    s_k = jax_cg_loop(op_j.matvec, dot_xla, update, bp, x0p, tol=tol, maxiter=k)
    s_next = jax_cg_loop(op_j.matvec, dot_xla, update, bp, x0p, tol=tol,
                         maxiter=k + 1, state=s_k)

    d = {f: np.asarray(getattr(s_k, f)) for f in STATE_FIELDS}
    state = state_from_numpy(d)
    op = dense_operator_from_numpy(np.asarray(op_j.A), n)
    got = state_to_numpy(
        cg_loop(*lap_ops(op, "torch"), None, None, tol=tol, maxiter=k + 1, state=state)
    )
    want = {f: np.asarray(getattr(s_next, f)) for f in STATE_FIELDS}
    assert int(got["k"]) == int(want["k"]) == k + 1
    assert bool(got["done"]) == bool(want["done"])
    assert rel_err(got["x"], want["x"]) <= 1e-6
    # r' = r - alpha Ap cancels to ~1e-2 of r each lap, so the GEMV's f32
    # rounding (sums in another order) weighs ~100x more relative to r' (and
    # to p' = r' + beta p): measured ~1.5e-5.
    for f in ("r", "p"):
        assert rel_err(got[f], want[f]) <= 1e-4, f
    assert rel_err(got["rsold"], want["rsold"]) <= 1e-5
    # the state handed in is the caller's: the loop works on copies
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(state_to_numpy(state)[f], d[f])


def test_state_round_trip():
    rng = np.random.default_rng(0)
    d = dict(
        k=np.int32(3), x=rng.random(128, dtype=np.float32),
        r=rng.random(128, dtype=np.float32), p=rng.random(128, dtype=np.float32),
        rsold=np.float32(0.5), rslast=np.float32(0.25), done=np.bool_(False),
        hist=rng.random(9, dtype=np.float32),
    )
    back = state_to_numpy(state_from_numpy(d))
    assert set(back) == set(d)
    for f, v in d.items():
        assert back[f].dtype == np.asarray(v).dtype, f
        np.testing.assert_array_equal(back[f], v)
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy({"k": np.int32(0)})
