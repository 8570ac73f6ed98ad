"""tpucg_torch's sparse host layer and DIA path against tpucg on the CPU: the
NumPy copies of the formats and the Poisson generators (array-equal), the
plain DIA SpMV (K6's plain version) against tpucg's Pallas DIA kernel in
interpret mode, ``DiaOperator``'s padding and diagonal, and carrying a tpucg
``DiaOperator`` across (``interop.dia_operator_from_numpy``). K6 itself runs
only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpucg.io.generator as jgen
import tpucg.sparse.formats as jfmt
from _torch_helpers import BAND_SETS, random_banded_dia
from tpucg.kernels.spmv import dia_interleave as j_interleave
from tpucg.kernels.spmv import dia_spmv as j_dia_spmv
from tpucg.kernels.spmv import dia_spmv_pallas
from tpucg.solver.operators import DiaOperator as JDiaOperator
from tpucg_torch.interop import dia_operator_from_numpy
from tpucg_torch.io.generator import poisson3d_csr, poisson3d_dia
from tpucg_torch.kernels.spmv import (
    DIA_MAX_DIAGS,
    dia_deinterleave,
    dia_interleave,
    dia_spmv,
    dia_spmv_torch,
    dia_supported,
)
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import DiaOperator, as_operator
from tpucg_torch.sparse.formats import COOMatrix, CSRMatrix, DIAMatrix, csr_to_dia

CPU = torch.device("cpu")


def _fields_equal(a, b):
    for name in ("offsets", "data", "indptr", "indices", "row", "col"):
        if hasattr(b, name):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert getattr(a, name).dtype == getattr(b, name).dtype, name
    assert tuple(a.shape) == tuple(b.shape)


# ---- the NumPy copies ---------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4, 8])
def test_poisson_generators_equal_tpucgs(m):
    _fields_equal(poisson3d_csr(m), jgen.poisson3d_csr(m))
    _fields_equal(poisson3d_dia(m), jgen.poisson3d_dia(m))
    assert poisson3d_csr(m).nnz == 7 * m ** 3 - 6 * m * m


@pytest.mark.parametrize("m", [4, 8])
def test_dia_form_is_the_csr_form(m):
    _fields_equal(csr_to_dia(poisson3d_csr(m)), poisson3d_dia(m))
    np.testing.assert_array_equal(poisson3d_dia(m).to_dense(), poisson3d_csr(m).to_dense())


def _coo(duplicates: bool):
    """A small COO with shuffled entries; with ``duplicates`` some (row, col)
    pairs repeat (CSR permits them, and they sum)."""
    rng = np.random.default_rng(5)
    n = 40
    row = rng.integers(0, n, 300)
    col = np.clip(row + rng.integers(-3, 4, 300), 0, n - 1)
    if not duplicates:
        key = np.unique(row * n + col)
        row, col = key // n, key % n
        perm = rng.permutation(row.size)
        row, col = row[perm], col[perm]
    data = rng.standard_normal(row.size).astype(np.float32)
    return row.astype(np.int64), col.astype(np.int64), data, (n, n)


@pytest.mark.parametrize("duplicates", [False, True], ids=["unique", "duplicates"])
def test_formats_equal_tpucgs(duplicates):
    row, col, data, shape = _coo(duplicates)
    mine = COOMatrix(row=row, col=col, data=data, shape=shape)
    ref = jfmt.COOMatrix(row=row, col=col, data=data, shape=shape)
    csr, jcsr = mine.to_csr(), ref.to_csr()
    _fields_equal(csr, jcsr)
    _fields_equal(csr.to_coo(), jcsr.to_coo())
    np.testing.assert_array_equal(mine.to_dense(), ref.to_dense())
    x = np.random.default_rng(1).standard_normal(shape[0]).astype(np.float32)
    np.testing.assert_array_equal(csr.matvec(x), jcsr.matvec(x))
    dia, jdia = csr_to_dia(csr), jfmt.csr_to_dia(jcsr)
    _fields_equal(dia, jdia)
    assert dia.nnz == jdia.nnz and dia.ndiag == jdia.ndiag
    np.testing.assert_array_equal(dia.to_dense(), jdia.to_dense())
    np.testing.assert_array_equal(dia.matvec(x), jdia.matvec(x))
    np.testing.assert_allclose(dia.to_dense(), mine.to_dense(), rtol=1e-6, atol=1e-6)


def test_csr_to_dia_refuses_what_tpucg_refuses():
    row, col, data, shape = _coo(False)
    csr = COOMatrix(row=row, col=col, data=data, shape=shape).to_csr()
    with pytest.raises(ValueError, match="distinct diagonals"):
        csr_to_dia(csr, max_diags=3)


def test_interleave_is_tpucgs_and_inverts():
    data = np.random.default_rng(0).standard_normal((5, 512)).astype(np.float32)
    packed = dia_interleave(data)
    np.testing.assert_array_equal(packed, j_interleave(data))
    np.testing.assert_array_equal(dia_deinterleave(packed), data)


# ---- the plain DIA SpMV against tpucg's kernel ----------------------------------


def _storage(data, dtype):
    """The slab in ``dtype`` for both packages: a torch tensor and the
    interleaved jax array tpucg's kernel takes."""
    if dtype == "bf16":
        j = jnp.asarray(j_interleave(data).astype(ml_dtypes.bfloat16))
        return torch.from_numpy(data).to(torch.bfloat16), j
    return torch.from_numpy(data), jnp.asarray(j_interleave(data))


@pytest.mark.parametrize("band", list(BAND_SETS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dia_spmv_plain_matches_tpucg(band, dtype):
    # tpucg's XLA dia_spmv adds the same products in the same order from
    # zero, each rounded on its own: bit for bit. Its Pallas kernel in
    # interpret mode rounds otherwise on ~40% of the rows (measured), so it
    # is held to 1e-6 of sum_d |data[d, i] x[i + off_d]| per row, as is the
    # float64 host oracle.
    offsets, data, _ = random_banded_dia(512, BAND_SETS[band], seed=7)
    x = np.random.default_rng(8).standard_normal(512).astype(np.float32)
    t, j = _storage(data, dtype)
    got = dia_spmv_torch(t, offsets, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_dia_spmv(jnp.asarray(t.float().numpy()), offsets, jnp.asarray(x))))
    wide = t.float().numpy().astype(np.float64)
    oracle = DIAMatrix(offsets=np.asarray(offsets), data=wide, shape=(512, 512)).matvec(
        x.astype(np.float64))
    scale = DIAMatrix(offsets=np.asarray(offsets), data=np.abs(wide), shape=(512, 512)).matvec(
        np.abs(x).astype(np.float64))
    pallas = np.asarray(dia_spmv_pallas(j, offsets, jnp.asarray(x)))
    assert np.all(np.abs(got - pallas) <= 1e-6 * scale)
    assert np.all(np.abs(got - oracle) <= 1e-6 * scale)


def test_dia_spmv_dispatch_and_limits():
    offsets, data, _ = random_banded_dia(256, (-1, 0, 1), seed=1)
    x = torch.ones(256)
    before = dia_spmv_torch.launches
    y = dia_spmv(torch.from_numpy(data), offsets, x)
    assert dia_spmv_torch.launches == before + 1
    np.testing.assert_array_equal(y.numpy(), dia_spmv_torch(torch.from_numpy(data), offsets, x))
    assert dia_supported(10, (0,)) and dia_supported(1000, tuple(range(DIA_MAX_DIAGS)))
    assert not dia_supported(1000, tuple(range(DIA_MAX_DIAGS + 1)))
    assert not dia_supported(1000, ())
    with pytest.raises(RuntimeError, match="CUDA"):
        dia_spmv(torch.from_numpy(data), offsets, x, backend="cuda")


def test_shift_reaching_past_the_vector_gives_zero():
    data = np.ones((2, 4), np.float32)
    y = dia_spmv_torch(torch.from_numpy(data), (-7, 9), torch.arange(4.0))
    assert torch.equal(y, torch.zeros(4))


# ---- DiaOperator against tpucg's ------------------------------------------------


def _banded(n, offsets, seed=0):
    if 0 in offsets:
        offs, data, _ = random_banded_dia(n, offsets, seed=seed)
    else:
        offs = tuple(offsets)
        data = np.random.default_rng(seed).standard_normal((len(offs), n)).astype(np.float32)
        for d, off in enumerate(offs):  # zero the entries outside the matrix
            i = np.arange(n)
            data[d, (i + off < 0) | (i + off >= n)] = 0.0
    return DIAMatrix(offsets=np.asarray(offs, np.int64), data=data, shape=(n, n))


@pytest.mark.parametrize("n", [512, 1000])
@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-3, -1, 1, 3)], ids=["main", "no_main"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dia_operator_pads_as_tpucg(n, offsets, dtype):
    dia = _banded(n, offsets)
    jdia = jfmt.DIAMatrix(offsets=dia.offsets, data=dia.data, shape=dia.shape)
    jop = JDiaOperator.from_dia(
        jdia, storage_dtype=jnp.bfloat16 if dtype == "bf16" else np.float32)
    op = DiaOperator.from_dia(
        dia, storage_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32, device=CPU)
    assert op.padded_n == jop.padded_n and op.n == jop.n == n
    assert op.offsets == jop.offsets and op.backend == "torch"
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    assert op.diagonal().dtype == torch.float32
    x = np.random.default_rng(2).standard_normal(op.padded_n).astype(np.float32)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))), rtol=1e-6, atol=1e-5)


def test_dia_operator_refuses_bad_input():
    dia = _banded(256, (-1, 0, 1))
    with pytest.raises(ValueError, match="storage_dtype"):
        DiaOperator.from_dia(dia, storage_dtype=torch.float16, device=CPU)
    with pytest.raises(ValueError, match="slab"):
        DiaOperator(data=torch.zeros(2, 256), offsets=(-1, 0, 1), n=256)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiaOperator.from_dia(dia, backend="cuda", device=CPU)
    with pytest.raises(NotImplementedError, match="M8"):
        DiaOperator.from_dia(dia, device=CPU).diagonal_blocks(8)


def test_as_operator_takes_both_packages_dia():
    dia = poisson3d_dia(4)
    jdia = jgen.poisson3d_dia(4)
    for A in (dia, jdia):
        op = as_operator(A, device=CPU)
        assert isinstance(op, DiaOperator) and op.padded_n == 128 and op.n == 64
    # A bare CSR becomes tpucg's ELL operator (best_sparse_operator picks DIA).
    assert type(as_operator(poisson3d_csr(4), device=CPU)).__name__ == "EllOperator"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [512, 1000])
def test_interop_carries_an_interleaved_tpucg_operator(dtype, n):
    dia = _banded(n, BAND_SETS["cross_row"], seed=3)
    jdia = jfmt.DIAMatrix(offsets=dia.offsets, data=dia.data, shape=dia.shape)
    jop = JDiaOperator.from_dia(
        jdia, backend="pallas", storage_dtype=jnp.bfloat16 if dtype == "bf16" else np.float32)
    assert jop.interleaved
    op = dia_operator_from_numpy(np.asarray(jop.data), jop.offsets, jop.n,
                                 interleaved=jop.interleaved)
    assert op.padded_n == jop.padded_n and op.data.dtype == (
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    x = np.random.default_rng(4).standard_normal(op.padded_n).astype(np.float32)
    x[n:] = 0.0
    got = op.matvec(torch.from_numpy(x)).numpy()
    # The same matvec: bit for bit against tpucg's XLA form of the carried
    # slab, and within 1e-6 of sum |a_ij x_j| per row against its Pallas
    # kernel (which rounds otherwise, test_dia_spmv_plain_matches_tpucg).
    wide = op.data.float()
    np.testing.assert_array_equal(got, np.asarray(j_dia_spmv(
        jnp.asarray(wide.numpy()), jop.offsets, jnp.asarray(x))))
    scale = dia_spmv_torch(wide.abs(), op.offsets, torch.from_numpy(np.abs(x))).numpy()
    assert np.all(np.abs(got - np.asarray(jop.matvec(jnp.asarray(x)))) <= 1e-6 * scale)


def test_interop_refuses_a_slab_without_tpucgs_tail():
    dia = _banded(1000, (-1, 0, 1))
    op = DiaOperator.from_dia(dia, device=CPU)
    good = op.data.numpy()
    assert dia_operator_from_numpy(good, op.offsets, 1000).padded_n == 1024
    bad = good.copy()
    bad[1, 1010] = 2.0  # a tail entry that is not 1
    with pytest.raises(ValueError, match="identity tail"):
        dia_operator_from_numpy(bad, op.offsets, 1000)
    bad = good.copy()
    bad[2, 999] = 1.0  # row 999 reaching into the tail
    with pytest.raises(ValueError, match="identity tail"):
        dia_operator_from_numpy(bad, op.offsets, 1000)
    with pytest.raises(ValueError, match="slab"):
        dia_operator_from_numpy(good[:, :1000], op.offsets, 1000)


def test_dia_solve_matches_tpucg_on_a_banded_system():
    # cg_solve on a DIAMatrix (the lap path on the CPU) against tpucg's
    # lap path on the same system: laps within one, x within 1e-3 max |x|.
    import tpucg

    offsets, data, b = random_banded_dia(1000, BAND_SETS["cross_row"], seed=11)
    dia = DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(1000, 1000))
    jdia = jfmt.DIAMatrix(offsets=np.asarray(offsets), data=data, shape=(1000, 1000))
    mine = cg_solve(dia, b, device=CPU, tol=1e-6, maxiter=1000)
    ref = tpucg.cg_solve(JDiaOperator.from_dia(jdia), b, tol=1e-6, maxiter=1000, fused="never")
    assert bool(mine.converged) and bool(ref.converged)
    assert abs(int(mine.iterations) - int(ref.iterations)) <= 1
    want = np.asarray(ref.x)
    assert np.abs(mine.x.numpy() - want).max() <= 1e-3 * np.abs(want).max()
