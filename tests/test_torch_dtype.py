"""tpucg_torch's dtype extensions against tpucg on the CPU: float64 solves
and bfloat16 matrix storage (tpucg's ``tests/test_dtype.py``).

An f64 solve reaches no kernel in either package: tpucg routes it to XLA
(an f64 dense A is forced onto its XLA operator, the DIA, WELL and stencil
operators take their XLA forms for a non-f32 vector), the port to plain
torch ops (``TorchLap``) on the solve's device, chosen by the dtype. The
one intended difference: ``kernel="cuda"`` with f64 raises in the port,
where tpucg reroutes silently. tpucg needs its x64 mode for f64
(``jax.enable_x64``); torch needs none. Tolerances: the f64 laps equal
tpucg's, x within 1e-10 of max |x| (two f64 solves), the residual below
f32's reach.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import scaled_err, tpucg_padded_dense
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.config import CGConfig
from tpucg_torch.interop import dense_operator_from_numpy
from tpucg_torch.io.generator import generate_spd_system, poisson3d_dia, random_geometric_spd
from tpucg_torch.kernels.matvec import matvec_torch
from tpucg_torch.kernels.stencil import poisson3d_torch
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import (
    DenseOperator,
    DiaOperator,
    PoissonOperator,
    WellOperator,
)

CPU = torch.device("cpu")


def test_f64_needs_no_mode_switch():
    # tpucg refuses f64 outside x64 mode; the port solves it as asked.
    A, b, x0 = generate_spd_system(16, seed=0)
    if not jax.config.jax_enable_x64:
        with pytest.raises(ValueError, match="x64"):
            tpucg.cg_solve(A, b, x0, dtype=jnp.float64)
    r = cg_solve(A, b, x0, dtype=torch.float64, device=CPU)
    assert bool(r.converged) and r.x.dtype == torch.float64


@pytest.mark.parametrize("pc", ["none", "jacobi", "block_jacobi", "poly"])
def test_f64_solve_tighter_than_f32(pc):
    A, b, x0 = generate_spd_system(64, seed=3)
    A64, b64, x064 = (v.astype(np.float64) for v in (A, b, x0))
    kw = dict(tol=1e-12, precondition=pc, pc_block_size=16)
    r = cg_solve(A64, b64, x064, dtype=torch.float64, device=CPU, **kw)
    assert bool(r.converged) and r.x.dtype == torch.float64
    assert r.residual_norm.dtype == torch.float64
    x = r.x.numpy()
    assert np.linalg.norm(b - A64 @ x) < 1e-10  # far beyond f32's reach
    with jax.enable_x64():
        jop = tpucg.DenseOperator.create(tpucg_padded_dense(A64).A[:64, :64], backend="xla",
                                         dtype=jnp.float64)
        ref = tpucg.cg_solve(jop, b64, x064, dtype=jnp.float64, **kw)
        jx, jk = np.asarray(ref.x), int(ref.iterations)
    assert int(r.iterations) == jk
    assert scaled_err(x, jx) <= 1e-10


def test_f64_dense_operator_is_f64_on_the_torch_backend():
    A, _, _ = generate_spd_system(100, seed=1)
    op = DenseOperator.create(A, dtype=torch.float64, device=CPU)
    assert op.A.dtype == torch.float64 and op.backend == "torch" and op.padded_n == 128
    assert op.diagonal().dtype == torch.float64
    assert op.diagonal_blocks(32).dtype == torch.float64
    with jax.enable_x64():
        jop = tpucg.DenseOperator.create(A, backend="pallas", dtype=jnp.float64)
        assert jop.backend == "xla"  # tpucg forces XLA for f64
    with pytest.raises(ValueError, match="float64"):
        DenseOperator(A=op.A, n=100, backend="cuda")
    with pytest.raises(ValueError, match="storage dtype"):
        DenseOperator.create(A, dtype=torch.float16, device=CPU)
    # interop carries an f64 padded array across.
    carried = dense_operator_from_numpy(op.A.numpy(), 100)
    assert carried.A.dtype == torch.float64 and carried.backend == "torch"
    np.testing.assert_array_equal(carried.A.numpy(), op.A.numpy())


def test_kernel_cuda_with_f64_raises_and_names_the_reason():
    A, b, _ = generate_spd_system(16, seed=0)
    with pytest.raises(ValueError, match="f64"):
        cg_solve(A, b, dtype=torch.float64, kernel="cuda", device=CPU)


def test_bf16_storage_solves_perturbed_system():
    n = 128
    A, b, x0 = generate_spd_system(n, seed=1)
    op = DenseOperator.create(A, dtype=torch.bfloat16, device=CPU)
    assert op.A.dtype == torch.bfloat16
    tol = 1e-5 * float(np.linalg.norm(b))
    r = cg_solve(op, b, x0, tol=tol, maxiter=4 * n)
    assert bool(r.converged) and r.x.dtype == torch.float32
    ref = cg_solve(A, b, x0, tol=tol, maxiter=4 * n, device=CPU)
    scale = float(ref.x.abs().max())
    np.testing.assert_allclose(r.x.numpy(), ref.x.numpy(), atol=2e-2 * scale)
    jop = tpucg.DenseOperator.create(A, backend="xla", dtype=jnp.bfloat16)
    jr = tpucg.cg_solve(tpucg_padded_dense(np.asarray(jop.A, np.float32)), b, x0, tol=tol,
                        maxiter=4 * n)
    assert abs(int(r.iterations) - int(jr.iterations)) <= 1


def test_bf16_plain_product_accumulates_f32():
    n = 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    Abf = torch.from_numpy(A).to(torch.bfloat16)
    y = matvec_torch(Abf, torch.from_numpy(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), Abf.float().numpy() @ x, rtol=1e-5, atol=1e-4)


def test_bf16_solve_dtype_rejected():
    with pytest.raises(ValueError, match="solve dtype"):
        CGConfig(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="solve dtype"):
        tpucg.CGConfig(dtype=jnp.bfloat16)


def test_f64_poisson_takes_the_plain_stencil():
    # K8 is f32-only; an f64 vector takes the plain stencil, which is tpucg's
    # XLA form on f64 bit for bit.
    m = 16
    op = PoissonOperator(m, device=CPU)
    u = np.random.default_rng(2).standard_normal(m ** 3)
    before = poisson3d_torch.launches
    y = op.matvec(torch.from_numpy(u))
    assert y.dtype == torch.float64 and poisson3d_torch.launches == before + 1
    with jax.enable_x64():
        ref = np.asarray(JPoissonOperator(m=m, kernel="xla").matvec(jnp.asarray(u)))
    np.testing.assert_array_equal(y.numpy(), ref)


def test_f64_sparse_operators_take_their_plain_products():
    dia = DiaOperator.from_dia(poisson3d_dia(8), device=CPU)
    u = np.random.default_rng(3).standard_normal(dia.padded_n)
    y = dia.matvec(torch.from_numpy(u))
    assert y.dtype == torch.float64
    # The slab's offsets order sums otherwise than the stencil: f64 rounding.
    np.testing.assert_allclose(y.numpy(), PoissonOperator(8, device=CPU).matvec(
        torch.from_numpy(u)).numpy(), rtol=0, atol=1e-13 * np.abs(u).max())
    A, _, _ = random_geometric_spd(300, seed=1)
    well = WellOperator.from_csr(A, device=CPU)
    v = np.random.default_rng(4).standard_normal(well.padded_n)
    yw = well.matvec(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(yw[:300], A.matvec(v[:300]), rtol=1e-6,
                               atol=1e-6 * np.abs(yw).max())


@pytest.mark.parametrize("kind", ["poisson", "dia", "well"])
def test_f64_sparse_solves_match_tpucg(kind):
    if kind == "well":
        A, b, _ = random_geometric_spd(300, seed=5)
        op = WellOperator.from_csr(A, device=CPU)
        jop = tpucg.WellOperator.from_csr(A, backend="xla")
    else:
        op = (PoissonOperator(8, device=CPU) if kind == "poisson"
              else DiaOperator.from_dia(poisson3d_dia(8), device=CPU))
        jop = JPoissonOperator(m=8, kernel="xla")
        b = np.random.default_rng(6).standard_normal(512)
    tol = 1e-10 * float(np.linalg.norm(b))
    r = cg_solve(op, b, dtype=torch.float64, tol=tol, maxiter=4000)
    assert bool(r.converged) and r.x.dtype == torch.float64
    with jax.enable_x64():
        ref = tpucg.cg_solve(jop, np.asarray(b, np.float64), dtype=jnp.float64, tol=tol,
                             maxiter=4000)
        jx, jk = np.asarray(ref.x), int(ref.iterations)
    assert abs(int(r.iterations) - jk) <= 1
    assert scaled_err(r.x.numpy(), jx) <= 1e-8


def test_f64_methods_run_on_the_plain_route():
    A, b, x0 = generate_spd_system(64, seed=8)
    for kw in (dict(method="pipelined"), dict(method="chebyshev"), dict(method="ca")):
        r = cg_solve(A.astype(np.float64), b.astype(np.float64), dtype=torch.float64,
                     device=CPU, tol=1e-9 * float(np.linalg.norm(b)), maxiter=2000, **kw)
        assert bool(r.converged) and r.x.dtype == torch.float64, kw


def test_sharded_solves_refuse_f64_and_say_why():
    # tpucg's sharded solves run f32 whatever config.dtype says (they read
    # storage_dtype only); the port refuses rather than solve in f32. The
    # check comes before any world is made.
    from tpucg_torch.solver.sharded import sharded_cg_solve, sharded_operator_cg_solve

    A, b, _ = generate_spd_system(16, seed=0)
    with pytest.raises(ValueError, match="float32 .*config.dtype"):
        sharded_cg_solve(A, b, dtype=torch.float64)
    with pytest.raises(ValueError, match="cg_solve"):
        sharded_operator_cg_solve(PoissonOperator(4, device=CPU), np.ones(64),
                                  dtype=torch.float64)
