"""tpucg_torch's dense CG solve against tpucg (Pallas lap path in interpret
mode, and XLA) and the NumPy oracle, on the CPU."""

import numpy as np
import pytest
import torch

import tpucg
import tpucg.io.generator
import tpucg.io.golden
import tpucg.io.partitioner
import tpucg.solver.oracle
from _torch_helpers import rel_err, spd_kappa
from tpucg.io.generator import poisson3d_csr
from tpucg_torch.config import CGConfig
from tpucg_torch.io import generator, golden, partitioner
from tpucg_torch.io.generator import generate_spd_system
from tpucg_torch.io.golden import GOLDEN_2X2, GOLDEN_4X4
from tpucg_torch.solver import oracle
from tpucg_torch.solver.cg import _State, cg_loop, cg_solve, lap_ops
from tpucg_torch.solver.operators import DenseOperator
from tpucg_torch.solver.oracle import oracle_cg

CPU = torch.device("cpu")


def _jax_lap_path(A, b, x0, **kw):
    # fused="never": at npad <= 1024 tpucg would take the whole-solve kernel
    # K4, not the lap path the port runs.
    return tpucg.cg_solve(A, b, x0, kernel="pallas", fused="never", **kw)


@pytest.mark.parametrize("g", [GOLDEN_2X2, GOLDEN_4X4], ids=["2x2", "4x4"])
def test_goldens(g):
    res = cg_solve(g["A"], g["b"], g["x0"], device=CPU)
    assert int(res.iterations) == g["iters"]
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), g["x_star"], atol=1e-5)


@pytest.mark.parametrize("n", [5, 100, 300, 1000])
def test_generator_systems_match_tpucg_and_oracle(n):
    A, b, x0 = generate_spd_system(n, seed=0)
    port = cg_solve(A, b, x0, device=CPU)
    x = port.x.numpy()
    assert x.shape == (n,)
    x_or, k_or, _ = oracle_cg(A, b, x0)
    for ref in (_jax_lap_path(A, b, x0), tpucg.cg_solve(A, b, x0, kernel="xla")):
        assert int(port.iterations) == int(ref.iterations)
        assert bool(port.converged) == bool(ref.converged)
        assert rel_err(x, ref.x) <= 1e-5
        assert float(ref.residual_norm) < 1e-6
    assert int(port.iterations) == k_or
    assert rel_err(x, x_or) <= 1e-5
    assert float(port.residual_norm) < 1e-6


def test_kappa_100_system_matches_tpucg():
    n = 256
    A, b = spd_kappa(n, 100.0, seed=5)
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=4 * n)
    port = cg_solve(A, b, device=CPU, **kw)
    ref = _jax_lap_path(A, b, None, **kw)
    assert bool(port.converged) and bool(ref.converged)
    # f32 sums in another order (XLA:CPU vs torch) may move the last lap.
    assert abs(int(port.iterations) - int(ref.iterations)) <= 1
    assert rel_err(port.x.numpy(), ref.x) <= 1e-4


def test_exact_initial_guess_stops_at_zero():
    g = GOLDEN_4X4
    res = cg_solve(g["A"], g["b"], g["x_star"], device=CPU)
    ref = tpucg.cg_solve(g["A"], g["b"], g["x_star"], kernel="xla")
    assert int(res.iterations) == int(ref.iterations) == 0
    assert bool(res.converged)
    np.testing.assert_array_equal(res.x.numpy(), g["x_star"])


def test_maxiter_caps_laps():
    A, b, x0 = generate_spd_system(300, seed=0)
    port = cg_solve(A, b, x0, maxiter=2, device=CPU)
    ref = _jax_lap_path(A, b, x0, maxiter=2)
    assert int(port.iterations) == int(ref.iterations) == 2
    assert not bool(port.converged) and not bool(ref.converged)
    assert rel_err(port.x.numpy(), ref.x) <= 1e-5


def test_jacobi_matches_tpucg():
    n = 300
    A, b, x0 = generate_spd_system(n, seed=3)
    s = (10.0 ** np.linspace(0.0, 2.0, n)).astype(np.float32)
    A, b = (s[:, None] * A * s[None, :]).astype(np.float32), (s * b).astype(np.float32)
    kw = dict(tol=1e-5 * float(np.linalg.norm(b)), maxiter=4 * n, precondition="jacobi")
    port = cg_solve(A, b, x0, device=CPU, **kw)
    for ref in (_jax_lap_path(A, b, x0, **kw), tpucg.cg_solve(A, b, x0, kernel="xla", **kw)):
        assert int(port.iterations) == int(ref.iterations)
        assert bool(port.converged) and bool(ref.converged)
        assert rel_err(port.x.numpy(), ref.x) <= 1e-5
    plain = cg_solve(A, b, x0, device=CPU, **{**kw, "precondition": "none"})
    assert int(port.iterations) < int(plain.iterations)


def test_residual_history_matches_tpucg():
    A, b, x0 = generate_spd_system(300, seed=1)
    port = cg_solve(A, b, x0, record_residuals=True, device=CPU)
    ref = tpucg.cg_solve(A, b, x0, record_residuals=True, kernel="xla")
    h, hr = port.residual_history.numpy(), np.asarray(ref.residual_history)
    k = int(port.iterations)
    assert h.shape == hr.shape == (301,) and k == int(ref.iterations)
    assert np.isnan(h[k + 1:]).all() and not np.isnan(h[: k + 1]).any()
    # Late entries sit near the f32 rounding floor of ||r0||, where sums in
    # another order move them: atol is 1e-6 of ||r0||.
    np.testing.assert_allclose(h[: k + 1], hr[: k + 1], rtol=1e-5, atol=1e-6 * hr[0])


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
def test_chunk_sizes_are_bit_identical(precondition):
    A, b, x0 = generate_spd_system(300, seed=4)
    runs = [
        cg_solve(A, b, x0, device=CPU, chunk=c, record_residuals=True,
                 precondition=precondition)
        for c in (None, 1, 3, 64)
    ]
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x)
        assert torch.equal(r.iterations, runs[0].iterations)
        assert torch.equal(r.residual_norm, runs[0].residual_norm)
        assert torch.equal(r.residual_history.nan_to_num(-1.0),
                           runs[0].residual_history.nan_to_num(-1.0))


def test_bf16_storage_solve():
    n = 256
    A, b, x0 = generate_spd_system(n, seed=1)
    op = DenseOperator.create(A, dtype=torch.bfloat16, device=CPU)
    assert op.A.dtype == torch.bfloat16 and op.padded_n == 256
    tol = 1e-5 * float(np.linalg.norm(b))
    res = cg_solve(op, b, x0, tol=tol, maxiter=4 * n)
    assert bool(res.converged) and res.x.dtype == torch.float32
    ref = cg_solve(A, b, x0, tol=tol, maxiter=4 * n, device=CPU)
    # Solves the bf16-rounded system: O(bf16 eps * kappa) away from f32's.
    scale = float(ref.x.abs().max())
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), atol=2e-2 * scale)


@pytest.mark.parametrize("n, npad", [(300, 384), (1000, 1024)])
def test_operator_padding_matches_tpucg(n, npad):
    A, _, _ = generate_spd_system(n, seed=0)
    op = DenseOperator.create(A, device=CPU)
    ref = tpucg.DenseOperator.create(A, backend="pallas")
    assert op.padded_n == ref.padded_n == npad
    np.testing.assert_array_equal(op.A.numpy(), np.asarray(ref.A))
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(ref.diagonal()))


@pytest.mark.parametrize(
    "kw, laps",
    [
        (dict(method="pipelined"), 0),
        (dict(method="ca"), 3),
        (dict(method="chebyshev"), 8),
        (dict(precondition="block_jacobi"), 0),
        (dict(dtype=torch.float64), 0),
        (dict(two_level=object()), None),
        (dict(method="ca", interval=(1.0, 5.0)), 3),
    ],
    ids=["pipelined", "ca", "chebyshev", "block_jacobi", "f64", "two_level", "interval"],
)
def test_unported_options_name_their_roadmap_item(kw, laps):
    # Two-level PCG (M12) still names its ROADMAP item; M8's methods, block
    # Jacobi, cached intervals and f64 solves (M9; tpucg's under its x64
    # mode) solve the 2x2 golden as tpucg does: its laps (within a CA block
    # or a Chebyshev check) and x.
    import contextlib

    import jax
    import jax.numpy as jnp

    g = GOLDEN_2X2
    if laps is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cg_solve(g["A"], g["b"], device=CPU, **kw)
        return
    port = cg_solve(g["A"], g["b"], g["x0"], device=CPU, maxiter=256, **kw)
    f64 = kw.get("dtype") == torch.float64
    jkw = dict(kw, dtype=jnp.float64) if f64 else kw
    with jax.enable_x64() if f64 else contextlib.nullcontext():
        ref = tpucg.cg_solve(g["A"], g["b"], g["x0"], kernel="xla", maxiter=256, **jkw)
        ref = ref._replace(x=np.asarray(ref.x))
    assert bool(port.converged) and bool(ref.converged)
    assert abs(int(port.iterations) - int(ref.iterations)) <= laps
    np.testing.assert_allclose(port.x.numpy(), g["x_star"], atol=2e-3)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=2e-3)


def test_sparse_input_names_its_roadmap_slice():
    # A bare CSR solves through tpucg's ELL operator, which stores no
    # addressable diagonal blocks: block Jacobi meets tpucg's own refusal.
    csr = poisson3d_csr(4)
    res = cg_solve(csr, np.ones(64, np.float32), device=CPU)
    assert bool(res.converged) and res.x.shape == (64,)
    with pytest.raises(NotImplementedError, match="does not expose diagonal blocks"):
        cg_solve(csr, np.ones(64, np.float32), device=CPU, precondition="block_jacobi")


def test_kernel_cuda_on_cpu_raises():
    g = GOLDEN_2X2
    with pytest.raises(RuntimeError, match="CUDA"):
        cg_solve(g["A"], g["b"], kernel="cuda", device=CPU)


@pytest.mark.parametrize("knob", ["strategy", "pc_block_size", "s_step", "check_every"])
def test_knobs_of_unported_slices_are_refused(knob):
    # Each knob is validated as tpucg validates it (tpucg's defaults and
    # bounds: pc_block_size 64 >= 2, s_step 3 >= 1, check_every 8 >= 1); a
    # solve that does not read it ignores it, as tpucg's does (`strategy`:
    # the sharded solves).
    g = GOLDEN_2X2
    bad, good = {"strategy": ("bogus", "overlap"), "pc_block_size": (1, 2), "s_step": (0, 2),
                 "check_every": (0, 2)}[knob]
    assert getattr(CGConfig(), knob) == getattr(tpucg.CGConfig(), knob)
    with pytest.raises(ValueError, match=knob):
        CGConfig(**{knob: bad})
    with pytest.raises(ValueError, match=knob):
        cg_solve(g["A"], g["b"], device=CPU, **{knob: bad})
    assert int(cg_solve(g["A"], g["b"], device=CPU, **{knob: good}).iterations) == 2


def test_operator_backend_resolves_from_its_device():
    A = torch.eye(128)
    assert DenseOperator(A=A, n=128).backend == "torch"
    assert DenseOperator.create(A, device=CPU).backend == "torch"
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseOperator(A=A, n=128, backend="cuda")


def test_operator_and_solve_backends_must_agree():
    g = GOLDEN_2X2
    op = DenseOperator.create(g["A"], device=CPU)
    with pytest.raises(ValueError, match="backend 'torch'.*asked for 'cuda'"):
        lap_ops(op, "cuda")
    # An operator whose backend is not the solve's (made here by hand: on a
    # CPU tensor "cuda" cannot be asked for) is refused before any lap runs.
    object.__setattr__(op, "backend", "cuda")
    before = op.A.clone()
    with pytest.raises(ValueError, match="backend 'cuda'.*asked for 'torch'"):
        cg_solve(op, g["b"], kernel="torch")
    assert torch.equal(op.A, before)


@pytest.mark.parametrize(
    "field, bad",
    [("x", torch.zeros(128, dtype=torch.float64)), ("p", torch.zeros(64)),
     ("rsold", torch.zeros(1))],
)
def test_cg_loop_checks_a_resumed_state(field, bad):
    op = DenseOperator.create(np.eye(128, dtype=np.float32), device=CPU)
    v = torch.ones(128)
    state = _State(k=torch.zeros((), dtype=torch.int32), x=v, r=v, p=v,
                   rsold=torch.tensor(128.0), rslast=torch.tensor(128.0),
                   done=torch.tensor(False))
    with pytest.raises(ValueError, match="CG state needs"):
        cg_loop(*lap_ops(op, "torch"), None, None, tol=1e-6, maxiter=4,
                state=state._replace(**{field: bad}))


# The port's host layer is a NumPy copy of tpucg's: the flagship workload,
# the padding and the oracle must stay the same arrays on the same inputs.

@pytest.mark.parametrize("n, seed, x0", [(5, 0, "zeros"), (100, 3, "random"), (300, 7, "zeros")])
def test_generator_copy_equals_tpucg(n, seed, x0):
    for got, want in zip(generator.generate_spd_system(n, seed=seed, x0=x0),
                         tpucg.io.generator.generate_spd_system(n, seed=seed, x0=x0)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(generator.generate_spd_system_f32(n, seed=seed),
                         tpucg.io.generator.generate_spd_system_f32(n, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, npad", [(5, 128), (128, 128), (300, 384), (1000, 1024)])
def test_padding_copy_equals_tpucg(n, npad):
    assert partitioner.round_up(n, 128) == tpucg.io.partitioner.round_up(n, 128) == npad
    A = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    got = partitioner.pad_identity_tail(A, npad)
    want = tpucg.io.partitioner.pad_identity_tail(A, npad)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["GOLDEN_2X2", "GOLDEN_4X4"])
def test_golden_copy_equals_tpucg(name):
    got, want = getattr(golden, name), getattr(tpucg.io.golden, name)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("n, seed, kw", [(4, 0, {}), (300, 1, {}), (300, 2, dict(maxiter=3)),
                                         (100, 5, dict(tol=1e-3))])
def test_oracle_copy_equals_tpucg(n, seed, kw):
    A, b, x0 = generate_spd_system(n, seed=seed, x0="random")
    x, k, rn = oracle.oracle_cg(A, b, x0, **kw)
    xw, kw_, rnw = tpucg.solver.oracle.oracle_cg(A, b, x0, **kw)
    np.testing.assert_array_equal(x, xw)
    assert (k, rn) == (kw_, rnw)
