"""tpucg_torch's batched banded solve against tpucg on the CPU:
``cg_solve_batch_banded`` (torch backend, the plain batched loop) against
tpucg's, and K12's plain version against tpucg's
``fused_batch_dia_cg_solve_pallas`` in interpret mode, on tpucg's
tridiagonal battery and on a battery whose lap counts its spectra set. K12
itself runs only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucg
from _torch_helpers import banded_battery, banded_spectrum_battery, scale_banded, scaled_err
from tpucg.kernels.fused import fused_batch_dia_cg_solve_pallas
from tpucg.kernels.spmv import dia_interleave as j_interleave
from tpucg_torch.kernels.fused import (
    FUSED_BATCH_DIA_MAX_N,
    check_fused_batch_dia,
    fused_batch_dia_supported,
)
from tpucg_torch.solver.cg import cg_solve_batch_banded
from tpucg_torch.solver.fused import fused_batch_dia_cg_solve, fused_batch_dia_cg_solve_torch

CPU = torch.device("cpu")


def _tpucg(data, offsets, b, **kw):
    return tpucg.cg_solve_batch_banded(data, offsets, b, **kw)


def _pallas(data, offsets, b, **kw):
    """tpucg's K12 in interpret mode on the row-interleaved slabs."""
    il = np.stack([np.asarray(j_interleave(d)) for d in data])
    return fused_batch_dia_cg_solve_pallas(jnp.asarray(il), offsets, jnp.asarray(b),
                                           jnp.zeros(b.shape, jnp.float32), **kw)


def _agree(res, jres, laps_equal=False):
    k, jk = res.iterations.numpy(), np.asarray(jres.iterations)
    if laps_equal:
        np.testing.assert_array_equal(k, jk)
    else:
        assert np.abs(k - jk).max() <= 1
    assert scaled_err(res.x.numpy(), np.asarray(jres.x)) <= 1e-4


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_battery_matches_tpucg(pc):
    data, offsets, b = banded_battery(6, 512, seed=0)
    res = cg_solve_batch_banded(data, offsets, b, tol=1e-5, precondition=pc, device=CPU)
    jres = _tpucg(data, offsets, b, tol=1e-5, precondition=pc)
    assert bool(res.converged.all()) and bool(np.asarray(jres.converged).all())
    assert res.x.shape == (6, 512) and res.iterations.dtype == torch.int32
    _agree(res, jres)


@pytest.mark.parametrize("n", [1024, 1000])
@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_spectrum_battery_equal_laps(pc, n):
    data, offsets, b, laps = banded_spectrum_battery(6, n, seed=1)
    res = cg_solve_batch_banded(data, offsets, b, tol=1e-2, precondition=pc, device=CPU)
    jres = _tpucg(data, offsets, b, tol=1e-2, precondition=pc)
    assert res.iterations.tolist() == laps
    _agree(res, jres, laps_equal=True)


@pytest.mark.parametrize("battery", ["tpucg", "spectrum"])
@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_plain_k12_matches_tpucgs_pallas(battery, pc):
    if battery == "tpucg":
        data, offsets, b = banded_battery(3, 512, seed=3)
        tol, laps = 1e-5, None
    else:
        data, offsets, b, laps = banded_spectrum_battery(3, 512, seed=3)
        tol = 1e-2
    z = torch.zeros(b.shape)
    x, k, rr = fused_batch_dia_cg_solve_torch(torch.from_numpy(data), offsets,
                                              torch.from_numpy(b), z, tol=tol, maxiter=512,
                                              precondition=pc)
    jx, jk, jrr = _pallas(data, offsets, b, tol=tol, maxiter=512, precondition=pc)
    if laps is None:
        assert np.abs(k.numpy() - np.asarray(jk)).max() <= 1
    else:
        assert k.tolist() == list(np.asarray(jk)) == laps
    assert scaled_err(x.numpy(), np.asarray(jx)) <= 1e-4
    assert (rr.numpy() < tol ** 2).all() and (np.asarray(jrr) < tol ** 2).all()
    # The dispatcher runs the plain version for CPU tensors.
    before = fused_batch_dia_cg_solve_torch.launches
    x2, _, _ = fused_batch_dia_cg_solve(torch.from_numpy(data), offsets, torch.from_numpy(b), z,
                                       tol=tol, maxiter=512, precondition=pc)
    assert fused_batch_dia_cg_solve_torch.launches == before + 1 and torch.equal(x, x2)


def test_jacobi_on_the_scaled_battery():
    data, offsets, b = banded_battery(6, 500, seed=1)
    data = scale_banded(data)
    kw = dict(tol=1e-4, precondition="jacobi", maxiter=4 * 500)
    res = cg_solve_batch_banded(data, offsets, b, device=CPU, **kw)
    jres = _tpucg(data, offsets, b, **kw)
    assert bool(res.converged.all())
    _agree(res, jres)
    plain = cg_solve_batch_banded(data, offsets, b, device=CPU, tol=1e-4, maxiter=4 * 500)
    assert (res.iterations < plain.iterations).all()


def test_bf16_slab_matches_tpucg():
    data, offsets, b = banded_battery(6, 500, seed=1)
    data = scale_banded(data)
    kw = dict(tol=1e-3, precondition="jacobi", maxiter=4 * 500)
    res = cg_solve_batch_banded(data, offsets, b, storage_dtype=torch.bfloat16, device=CPU, **kw)
    jres = _tpucg(data, offsets, b, storage_dtype=jnp.bfloat16, **kw)
    assert bool(res.converged.all())
    _agree(res, jres)


def test_unpadded_n_solves_the_identity_tail():
    data, offsets, b = banded_battery(4, 1000, seed=5)
    x0 = np.random.default_rng(6).standard_normal(b.shape).astype(np.float32)
    res = cg_solve_batch_banded(data, offsets, b, x0, tol=1e-5, device=CPU)
    jres = tpucg.cg_solve_batch_banded(data, offsets, b, x0, tol=1e-5)
    assert res.x.shape == (4, 1000)
    _agree(res, jres)


def test_errors_are_tpucgs():
    data, offsets, b = banded_battery(2, 200, seed=0)
    with pytest.raises(ValueError, match="stored main diagonal"):
        cg_solve_batch_banded(data[:, [0, 2]], (-1, 1), b, device=CPU)
    with pytest.raises(ValueError, match="'none' or 'jacobi'"):
        cg_solve_batch_banded(data, offsets, b, precondition="poly", device=CPU)
    with pytest.raises(ValueError, match="3 diagonals, offsets has 2"):
        cg_solve_batch_banded(data, (0, 1), b, device=CPU)
    with pytest.raises(ValueError, match="method='cg'"):
        cg_solve_batch_banded(data, offsets, b, method="ca", device=CPU)
    with pytest.raises(ValueError, match="storage_dtype"):
        cg_solve_batch_banded(data, offsets, b, storage_dtype=torch.float16, device=CPU)
    with pytest.raises(ValueError, match=r"b must be \(2, 200\)"):
        cg_solve_batch_banded(data, offsets, b[:, :100], device=CPU)
    with pytest.raises(ValueError, match=r"data must be \(B, ndiag, n\)"):
        cg_solve_batch_banded(data[0], offsets, b, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        cg_solve_batch_banded(data, offsets, b, kernel="cuda", device=CPU)


def test_k12_checks_its_operands():
    t = torch.zeros(2, 3, 256)
    v = torch.zeros(2, 256)
    check_fused_batch_dia(t, (-1, 0, 1), v, v, "jacobi")
    assert fused_batch_dia_supported(FUSED_BATCH_DIA_MAX_N, (0,))
    assert not fused_batch_dia_supported(FUSED_BATCH_DIA_MAX_N + 128, (0,))
    assert not fused_batch_dia_supported(200, (0,))
    with pytest.raises(ValueError, match="unsupported"):
        check_fused_batch_dia(torch.zeros(2, 3, 200), (-1, 0, 1), v[:, :200], v[:, :200], "none")
    with pytest.raises(ValueError, match="f32 or bf16"):
        check_fused_batch_dia(t.double(), (-1, 0, 1), v, v, "none")
    with pytest.raises(ValueError, match="main diagonal"):
        check_fused_batch_dia(t[:, :2], (-1, 1), v, v, "jacobi")
    with pytest.raises(ValueError, match="'none' or 'jacobi'"):
        check_fused_batch_dia(t, (-1, 0, 1), v, v, "poly")
    with pytest.raises(ValueError, match="x0 must be f32"):
        check_fused_batch_dia(t, (-1, 0, 1), v, v[:1], "none")
