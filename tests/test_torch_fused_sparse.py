"""tpucg_torch's whole-solve sparse path against tpucg on the CPU: the plain
K10 (``fused_stencil_cg_solve_torch``) against ``fused_stencil_cg_solve_pallas``
and the plain K11 (``fused_dia_cg_solve_torch``) against
``fused_dia_cg_solve_pallas``, both in interpret mode; ``cg_solve`` on the
port's Poisson and DIA operators against tpucg's lap path; and the gate
``_fused_eligible`` over tpucg's own cases, with the port's intended
differences spelled out. K10 and K11 themselves run only on the card
(``tests/test_torch_cuda.py``).

Tolerances (tpucg's own fused-against-lap bounds, ``tests/test_fused.py:167,
238-239, 331``): laps within one, since the two sum in other orders; x
within 1e-3 of max |x| (tpucg's rtol 1e-3 taken relative to the solution's
size); and the kernel's r.r below tol^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
import tpucg.io.generator as jgen
import tpucg.sparse.formats as jfmt
from _torch_helpers import BAND_SETS, random_banded_dia
from tpucg.kernels.fused import fused_dia_cg_solve_pallas, fused_stencil_cg_solve_pallas
from tpucg.solver.operators import DiaOperator as JDiaOperator
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.config import CGConfig
from tpucg_torch.io.generator import poisson3d_dia
from tpucg_torch.kernels.fused import (
    FUSED_DIA_AUTO_MAX_N,
    FUSED_DIA_MAX_N,
    FUSED_STENCIL_AUTO_MAX_M,
    FUSED_STENCIL_MAX_M,
    check_fused_dia,
    check_fused_stencil,
    fused_dia_cg_solve_cuda,
    fused_stencil_cg_solve_cuda,
)
from tpucg_torch.kernels.spmv import dia_spmv_torch
from tpucg_torch.kernels.stencil import poisson3d_torch
from tpucg_torch.solver import cg as port_cg
from tpucg_torch.solver.cg import _fused_eligible, cg_solve
from tpucg_torch.solver.fused import (
    fused_dia_cg_solve,
    fused_dia_cg_solve_torch,
    fused_stencil_cg_solve,
    fused_stencil_cg_solve_torch,
)
from tpucg_torch.solver.operators import DiaOperator, PoissonOperator
from tpucg_torch.sparse.formats import DIAMatrix

CPU = torch.device("cpu")


def _close(got, want, tol, k=None, kp=None, rr=None):
    """The module's tolerances on two (x, k) results."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    if k is not None:
        assert abs(int(k) - int(kp)) <= 1
    if rr is not None:
        assert float(rr) < tol ** 2


def _rhs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            (0.1 * rng.standard_normal(n)).astype(np.float32))


# ---- the plain K10 and K11 against tpucg's kernels -------------------------------


@pytest.mark.parametrize("pc", ["none", "poly"])
def test_plain_k10_matches_tpucg_pallas(pc):
    m = 16
    b, x0 = _rhs(m ** 3, seed=3)
    tol = 1e-5 * float(np.linalg.norm(b))
    kw = dict(tol=tol, maxiter=4 * m ** 3, precondition=pc, poly_degree=3 if pc == "poly" else 0)
    jx, jk, _ = fused_stencil_cg_solve_pallas(jnp.asarray(b), jnp.asarray(x0), m, **kw)
    x, k, rr = fused_stencil_cg_solve_torch(torch.from_numpy(b), torch.from_numpy(x0), m, **kw)
    assert x.shape == (m ** 3,) and k.dtype == torch.int32
    _close(x.numpy(), np.asarray(jx), tol, k, jk, rr)


def _dia_case(case):
    """(DIAMatrix, b, tol) of a band set of tpucg's fused DIA tests (n = 512,
    tol 1e-6) or of the m = 16 Poisson Laplacian in DIA form (tol 1e-5 ||b||)."""
    if case == "poisson16":
        dia = poisson3d_dia(16)
        b = _rhs(16 ** 3, seed=4)[0]
        return dia, b, 1e-5 * float(np.linalg.norm(b))
    offsets, data, b = random_banded_dia(512, BAND_SETS[case], seed=5)
    return DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(512, 512)), b, 1e-6


@pytest.mark.parametrize("case", list(BAND_SETS) + ["poisson16"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_k11_matches_tpucg_pallas(case, pc, dtype):
    dia, b, tol = _dia_case(case)
    jop = JDiaOperator.from_dia(
        jfmt.DIAMatrix(offsets=dia.offsets, data=dia.data, shape=dia.shape), backend="pallas",
        storage_dtype=jnp.bfloat16 if dtype == "bf16" else np.float32)
    op = DiaOperator.from_dia(
        dia, storage_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32, device=CPU)
    n, npad = op.n, op.padded_n
    x0 = np.zeros(npad, np.float32)
    x0[:n] = _rhs(n, seed=6)[1]
    bp = np.zeros(npad, np.float32)
    bp[:n] = b
    kw = dict(tol=tol, maxiter=4 * npad, precondition=pc, poly_degree=3 if pc == "poly" else 0)
    jx, jk, _ = fused_dia_cg_solve_pallas(jop.data, jop.offsets, jnp.asarray(bp),
                                          jnp.asarray(x0), **kw)
    x, k, rr = fused_dia_cg_solve_torch(op.data, op.offsets, torch.from_numpy(bp),
                                        torch.from_numpy(x0), **kw)
    _close(x.numpy()[:n], np.asarray(jx)[:n], tol, k, jk, rr)


def test_k10_k11_checks_use_tpucgs_messages():
    v = torch.zeros(512)
    with pytest.raises(ValueError, match="fused stencil solve needs 2 <= m"):
        check_fused_stencil(v, v, 1, "none", 0)
    with pytest.raises(ValueError, match="fused stencil solve supports precondition none/poly"):
        check_fused_stencil(v, v, 8, "jacobi", 0)
    with pytest.raises(ValueError, match="poly_degree >= 1"):
        check_fused_stencil(v, v, 8, "poly", 0)
    with pytest.raises(ValueError, match="b must be f32"):
        check_fused_stencil(torch.zeros(100), v, 8, "none", 0)
    data = torch.ones(2, 512)
    with pytest.raises(ValueError, match="jacobi needs a stored main diagonal"):
        check_fused_dia(data, (-1, 1), v, v, "jacobi", 0)
    with pytest.raises(ValueError, match="fused DIA solve unsupported"):
        check_fused_dia(torch.ones(65, 512), tuple(range(65)), v, v, "none", 0)
    with pytest.raises(ValueError, match="f32 or bf16 slabs"):
        check_fused_dia(data.double(), (-1, 1), v, v, "none", 0)
    with pytest.raises(ValueError, match="none/jacobi/poly"):
        check_fused_dia(data, (-1, 1), v, v, "block_jacobi", 0)
    with pytest.raises(ValueError, match="slab"):
        check_fused_dia(data, (-1, 0, 1), v, v, "none", 0)
    # The kernels' wrappers run the same checks first, then refuse a CPU tensor.
    with pytest.raises(ValueError, match="supports precondition none/poly"):
        fused_stencil_cg_solve_cuda(v, v, 8, tol=1e-6, maxiter=4, precondition="jacobi")
    with pytest.raises(ValueError, match="CUDA device"):
        fused_dia_cg_solve_cuda(data, (-1, 1), v, v, tol=1e-6, maxiter=4)


def test_dispatchers_run_the_plain_versions_for_cpu_tensors():
    b = torch.from_numpy(_rhs(8 ** 3, seed=1)[0])
    z = torch.zeros_like(b)
    before = fused_stencil_cg_solve_torch.launches, fused_dia_cg_solve_torch.launches
    xs, ks, _ = fused_stencil_cg_solve(b, z, 8, tol=1e-4, maxiter=512)
    op = DiaOperator.from_dia(poisson3d_dia(8), device=CPU)
    xd, kd, _ = fused_dia_cg_solve(op.data, op.offsets, b, z, tol=1e-4, maxiter=512)
    assert (fused_stencil_cg_solve_torch.launches, fused_dia_cg_solve_torch.launches) == (
        before[0] + 1, before[1] + 1)
    assert abs(int(ks) - int(kd)) <= 1
    np.testing.assert_allclose(xs.numpy(), xd.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_stencil_cg_solve(b, z, 8, backend="cuda", tol=1e-4, maxiter=4)


# ---- the slice as a whole: cg_solve against tpucg -------------------------------


@pytest.mark.parametrize("kind", ["poisson", "dia_f32", "dia_bf16"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "poly"])
def test_cg_solve_poisson_matches_tpucg(kind, pc):
    m = 16
    n = m ** 3
    b = _rhs(n, seed=9)[0]
    tol = 1e-5 * float(np.linalg.norm(b))
    if kind == "poisson":
        op, jop = PoissonOperator(m, device=CPU), JPoissonOperator(m=m)
    else:
        bf16 = kind == "dia_bf16"
        op = DiaOperator.from_dia(poisson3d_dia(m), device=CPU,
                                  storage_dtype=torch.bfloat16 if bf16 else torch.float32)
        jop = JDiaOperator.from_dia(jgen.poisson3d_dia(m),
                                    storage_dtype=jnp.bfloat16 if bf16 else np.float32)
    kw = dict(tol=tol, maxiter=4 * n, precondition=pc)
    ref = tpucg.cg_solve(jop, b, fused="never", **kw)
    got = cg_solve(op, b, device=CPU, **kw)
    assert bool(got.converged) and bool(ref.converged)
    assert got.x.shape == (n,) and got.iterations.dtype == torch.int32
    _close(got.x.numpy(), np.asarray(ref.x), tol, got.iterations, ref.iterations)
    # the true residual, in float64
    x64 = got.x.double()
    if kind == "poisson":
        ax = poisson3d_torch(x64, m)
    else:
        ax = dia_spmv_torch(op.data.double(), op.offsets, x64)
    assert float((torch.from_numpy(b).double() - ax).norm()) <= 2 * tol


def test_cg_solve_on_a_dia_matrix_with_padding():
    # n = 1000 pads to 1024 with the identity tail: x comes back at n.
    offsets, data, b = random_banded_dia(1000, BAND_SETS["multi_row"], seed=12)
    dia = DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(1000, 1000))
    jdia = jfmt.DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(1000, 1000))
    got = cg_solve(dia, b, device=CPU, tol=1e-6, maxiter=2000, precondition="jacobi")
    ref = tpucg.cg_solve(JDiaOperator.from_dia(jdia), b, tol=1e-6, maxiter=2000,
                         precondition="jacobi", fused="never")
    assert got.x.shape == (1000,) and bool(got.converged)
    _close(got.x.numpy(), np.asarray(ref.x), 1e-6, got.iterations, ref.iterations)


# ---- the gate over tpucg's cases ---------------------------------------------------


def _gate_ops(kind):
    """The same operator in both packages: (tpucg's, the port's)."""
    if kind == "poisson_xla":
        return JPoissonOperator(m=16, kernel="xla"), PoissonOperator(16, device=CPU)
    if kind.startswith("poisson"):
        m = {"poisson16": 16, "poisson10": 10, "poisson144": 144,
             "poisson_above_auto": FUSED_STENCIL_AUTO_MAX_M + 8}[kind]
        return JPoissonOperator(m=m), PoissonOperator(m, device=CPU)
    if kind in ("dia16", "dia16_bf16", "dia16_xla"):
        backend = "xla" if kind == "dia16_xla" else "auto"
        bf16 = kind == "dia16_bf16"
        jop = JDiaOperator.from_dia(jgen.poisson3d_dia(16), backend=backend,
                                    storage_dtype=jnp.bfloat16 if bf16 else np.float32)
        op = DiaOperator.from_dia(poisson3d_dia(16), device=CPU,
                                  storage_dtype=torch.bfloat16 if bf16 else torch.float32)
        return jop, op
    if kind == "dia_no_main":
        offsets = (-1, 1)
        data = np.ones((2, 512), np.float32)
        jop = JDiaOperator.from_dia(jfmt.DIAMatrix(np.asarray(offsets), data, (512, 512)))
        return jop, DiaOperator(data=torch.ones(2, 512), offsets=offsets, n=512)
    if kind == "dia_unaligned_no_main":
        offsets = (-1, 1)
        data = np.ones((2, 1000), np.float32)
        jop = JDiaOperator.from_dia(jfmt.DIAMatrix(np.asarray(offsets), data, (1000, 1000)))
        return jop, DiaOperator(data=torch.ones(2, 1000), offsets=offsets, n=1000)
    # Large slabs of the right shape (zeros: the gate reads shapes and types).
    npad, dtype = {"dia128_f32": (128 ** 3, "f32"), "dia128_bf16": (128 ** 3, "bf16"),
                   "dia_above_auto": (FUSED_DIA_AUTO_MAX_N + 128, "f32")}[kind]
    offsets = (-(128 ** 2), -128, -1, 0, 1, 128, 128 ** 2)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jop = JDiaOperator(data=jnp.zeros((npad // 128, 7 * 128), jdt), offsets=offsets, n=npad,
                       interleaved=True)
    return jop, DiaOperator(data=torch.zeros(7, npad, dtype=tdt), offsets=offsets, n=npad)


# (label, config kwargs, operator kind, backend index, record, dtype index,
# the port's answer where it differs from tpucg's on purpose, else SAME).
# Backend and dtype index 0/1 pick ("pallas", "xla") in tpucg and ("cuda",
# "torch") in the port, and (f32, f64).
SAME = "same as tpucg"
GATE_CASES = [
    ("stencil", {}, "poisson16", 0, False, 0, SAME),
    ("stencil_poly", dict(precondition="poly"), "poisson16", 0, False, 0, SAME),
    ("stencil_jacobi", dict(precondition="jacobi"), "poisson16", 0, False, 0, SAME),
    ("stencil_block_jacobi", dict(precondition="block_jacobi"), "poisson16", 0, False, 0, SAME),
    ("stencil_history", {}, "poisson16", 0, True, 0, SAME),
    ("stencil_never", dict(fused="never"), "poisson16", 0, False, 0, SAME),
    ("stencil_plain_backend", {}, "poisson16", 1, False, 0, SAME),
    ("stencil_f64", {}, "poisson16", 0, False, 1, SAME),
    ("stencil_pipelined", dict(method="pipelined"), "poisson16", 0, False, 0, SAME),
    # tpucg's kernel="xla" operator: the port's operators carry no kernel
    # choice of their own; the solve's backend decides, here "cuda".
    ("stencil_xla_operator", {}, "poisson_xla", 0, False, 0, "stencil"),
    # Not lane-tileable ((m*m) % 128 != 0): a TPU rule, K10 takes any m.
    ("stencil_m10", {}, "poisson10", 0, False, 0, "stencil"),
    # Above tpucg's VMEM cap of m = 128, inside the card's measured one.
    ("stencil_m144", {}, "poisson144", 0, False, 0, "stencil"),
    ("stencil_above_auto", {}, "poisson_above_auto", 0, False, 0, SAME),
    ("stencil_above_auto_always", dict(fused="always"), "poisson_above_auto", 0, False, 0,
     "stencil"),
    ("dia", {}, "dia16", 0, False, 0, SAME),
    ("dia_jacobi", dict(precondition="jacobi"), "dia16", 0, False, 0, SAME),
    ("dia_poly", dict(precondition="poly"), "dia16", 0, False, 0, SAME),
    ("dia_bf16", {}, "dia16_bf16", 0, False, 0, SAME),
    ("dia_bf16_jacobi", dict(precondition="jacobi"), "dia16_bf16", 0, False, 0, SAME),
    ("dia_block_jacobi", dict(precondition="block_jacobi"), "dia16", 0, False, 0, SAME),
    ("dia_history", {}, "dia16", 0, True, 0, SAME),
    ("dia_never", dict(fused="never"), "dia16", 0, False, 0, SAME),
    ("dia_plain_backend", {}, "dia16", 1, False, 0, SAME),
    ("dia_f64", {}, "dia16", 0, False, 1, SAME),
    ("dia_pipelined", dict(method="pipelined"), "dia16", 0, False, 0, SAME),
    ("dia_jacobi_no_main", dict(precondition="jacobi"), "dia_no_main", 0, False, 0, SAME),
    ("dia_no_main", {}, "dia_no_main", 0, False, 0, SAME),
    # tpucg's backend="xla" operator (canonical, not interleaved): no
    # counterpart, the solve's backend decides.
    ("dia_xla_operator", {}, "dia16_xla", 0, False, 0, "dia"),
    # n = 1000 with no main diagonal stays unpadded: tpucg cannot lane-tile
    # it, K11 takes any n.
    ("dia_unaligned_no_main", {}, "dia_unaligned_no_main", 0, False, 0, "dia"),
    # The f32 m = 128 slab plus solve state exceeds tpucg's 100 MiB VMEM
    # budget (58.7 MB + 67 MB); bf16 fits it. K11 runs both.
    ("dia_m128_f32", {}, "dia128_f32", 0, False, 0, "dia"),
    ("dia_m128_bf16", {}, "dia128_bf16", 0, False, 0, SAME),
    ("dia_above_auto", {}, "dia_above_auto", 0, False, 0, SAME),
    ("dia_above_auto_always", dict(fused="always"), "dia_above_auto", 0, False, 0, "dia"),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=lambda c: c[0])
def test_sparse_gate_matches_tpucg(case):
    _, kw, kind, bi, record, di, port = case
    jop, op = _gate_ops(kind)
    want = tpucg.solver.cg._fused_eligible(
        tpucg.CGConfig(kernel="pallas", **kw), jop, ("pallas", "xla")[bi],
        (jnp.float32, jnp.float64)[di], record)
    got = _fused_eligible(CGConfig(**kw), op, ("cuda", "torch")[bi],
                          (torch.float32, torch.float64)[di], record)
    if port == SAME:
        assert got == want
    else:
        assert want != port and got == port


def test_stencil_beyond_the_kernels_reach_is_refused():
    # K10 and K8 index with int32: no PoissonOperator exists past
    # FUSED_STENCIL_MAX_M, so nothing reaches the gate.
    with pytest.raises(ValueError, match="PoissonOperator needs 2 <= m"):
        PoissonOperator(FUSED_STENCIL_MAX_M + 8, device=CPU)


def test_sparse_auto_caps_are_the_cards_own():
    assert port_cg.FUSED_STENCIL_AUTO_MAX_M == FUSED_STENCIL_AUTO_MAX_M <= FUSED_STENCIL_MAX_M
    assert port_cg.FUSED_DIA_AUTO_MAX_N == FUSED_DIA_AUTO_MAX_N <= FUSED_DIA_MAX_N
    # at least tpucg's own reach: m = 128 on both routes
    assert FUSED_STENCIL_AUTO_MAX_M >= 128 and FUSED_DIA_AUTO_MAX_N >= 128 ** 3


@pytest.mark.parametrize("fused", ["always", "auto", "never"])
def test_sparse_solves_on_the_torch_backend_take_the_lap_path(fused):
    b = _rhs(8 ** 3, seed=2)[0]
    before = fused_stencil_cg_solve_torch.launches, fused_dia_cg_solve_torch.launches
    for op in (PoissonOperator(8, device=CPU),
               DiaOperator.from_dia(poisson3d_dia(8), device=CPU)):
        res = cg_solve(op, b, fused=fused, tol=1e-4, maxiter=512)
        assert bool(res.converged)
    assert (fused_stencil_cg_solve_torch.launches, fused_dia_cg_solve_torch.launches) == before
