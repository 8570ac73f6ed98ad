"""tpucg_torch's WELL path against tpucg on the CPU: ``csr_to_well``'s
arrays (array-equal), K13's plain version against tpucg's ``well_spmv_xla``
(bit for bit: both sum each group's sublanes in ascending order) and its
Pallas ``well_spmv`` in interpret mode (within 1e-6 of sum |a_ij x_j|), the
K14 name, ``WellOperator`` (diagonal, padding, carried across from tpucg)
and CG solves on it. K13 itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.well as jwell
from _torch_helpers import rel_err, scaled_err
from tpucg.kernels.gather_spmv import well_spmv as j_well_spmv
from tpucg.kernels.gather_spmv import well_spmv_fused_gather as j_well_spmv_fused_gather
from tpucg.kernels.gather_spmv import well_spmv_xla
from tpucg.solver.operators import WellOperator as JWellOperator
from tpucg_torch.interop import well_operator_from_numpy
from tpucg_torch.io.generator import fem_p1_system, random_geometric_spd
from tpucg_torch.kernels.gather_spmv import (
    group_index,
    well_spmv,
    well_spmv_fused_gather,
    well_spmv_torch,
)
from tpucg_torch.solver.cg import cg_solve
from tpucg_torch.solver.operators import WellOperator
from tpucg_torch.sparse.formats import COOMatrix, CSRMatrix
from tpucg_torch.sparse.well import _auto_block_sublanes, csr_to_well

CPU = torch.device("cpu")
FIELDS = ("vals", "lidx", "wrow", "gidl", "sgb")


def _shuffled(n, seed):
    A, _, _ = random_geometric_spd(n, seed=seed, avg_degree=8.0, shuffle=True)
    return A


def _random_csr(n, density, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < density
    m |= m.T
    np.fill_diagonal(m, True)
    r, c = np.nonzero(m)
    return COOMatrix(row=r, col=c, data=rng.standard_normal(r.size).astype(np.float32),
                     shape=(n, n)).to_csr()


CASES = {
    "geometric": lambda: random_geometric_spd(3000, seed=7, avg_degree=9.0)[0],
    "fem": lambda: fem_p1_system(2000, seed=0)[0],
    "shuffled": lambda: _shuffled(1500, seed=2),
    "random": lambda: _random_csr(777, 0.01, seed=7),
    "tiny": lambda: CSRMatrix(indptr=np.array([0, 1]), indices=np.array([0], np.int32),
                              data=np.array([3.0], np.float32), shape=(1, 1)),
    "empty": lambda: CSRMatrix(indptr=np.zeros(6, np.int64), indices=np.zeros(0, np.int32),
                               data=np.zeros(0, np.float32), shape=(5, 5)),
    "duplicates": lambda: COOMatrix(row=np.array([0, 0, 1]), col=np.array([1, 1, 0]),
                                    data=np.array([2.0, 3.0, 4.0], np.float32),
                                    shape=(2, 2)).to_csr(),
}


def _args(w, x):
    """The packed arrays and x2 as torch tensors, and as jax arrays."""
    x2 = x.reshape(-1, 128)
    arrays = [getattr(w, f) for f in ("vals", "lidx", "gidl", "wrow", "sgb")] + [x2]
    statics = (w.groups_per_super, w.n_supergroups)
    return (tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays) + statics,
            tuple(jnp.asarray(a) for a in arrays) + statics)


def _abs_sum(w, x):
    """sum_j |a_ij x_j| per output slot (nsg * bg, 128), float64."""
    cols = np.repeat(w.wrow, 8)[:, None].astype(np.int64) * 128 + w.lidx.astype(np.int64)
    g = w.group_of_sublane()
    out = np.zeros((w.n_supergroups * w.groups_per_super, 128))
    np.add.at(out, g, np.abs(w.vals.astype(np.float64) * x[cols]))
    return out


def _x(w, seed=8):
    npad = -(-w.shape[1] // 128) * 128
    return np.random.default_rng(seed).standard_normal(npad).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_to_well_equals_tpucgs(case):
    A = CASES[case]()
    w, jw = csr_to_well(A), jwell.csr_to_well(A)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(w, f), getattr(jw, f))
        assert getattr(w, f).dtype == getattr(jw, f).dtype, f
    assert (w.block_sublanes, w.groups_per_super, w.shape) == (
        jw.block_sublanes, jw.groups_per_super, jw.shape)
    assert (w.n_supergroups, w.nnz, w.fill) == (jw.n_supergroups, jw.nnz, jw.fill)
    np.testing.assert_array_equal(w.diagonal(), jw.diagonal())


@pytest.mark.parametrize("bs,bg", [(64, 8), (256, 64), (2048, 4)])
def test_csr_to_well_explicit_layout_equals_tpucgs(bs, bg):
    A = CASES["geometric"]()
    w = csr_to_well(A, block_sublanes=bs, groups_per_super=bg)
    jw = jwell.csr_to_well(A, block_sublanes=bs, groups_per_super=bg)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(w, f), getattr(jw, f))
    with pytest.raises(ValueError, match="multiple of 8"):
        csr_to_well(A, block_sublanes=12)
    with pytest.raises(ValueError, match="groups_per_super"):
        csr_to_well(A, groups_per_super=0)


def test_auto_block_sublanes_is_tpucgs():
    rng = np.random.default_rng(0)
    for _ in range(20):
        sg = rng.integers(0, 9000, size=rng.integers(1, 40))
        assert _auto_block_sublanes(int(sg.sum()), sg.size, sg) == \
            jwell._auto_block_sublanes(int(sg.sum()), sg.size, sg)
    for total, nsg in ((100, 1), (5000, 2), (90000, 3)):
        assert _auto_block_sublanes(total, nsg) == jwell._auto_block_sublanes(total, nsg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_well_spmv_is_tpucgs_xla_bit_for_bit(case):
    w = csr_to_well(CASES[case]())
    x = _x(w)
    targs, jargs = _args(w, x)
    y = well_spmv_torch(*targs).numpy()
    np.testing.assert_array_equal(y, np.asarray(well_spmv_xla(*jargs)))
    # And the host oracle (float64 sums) on the logical rows.
    np.testing.assert_allclose(y.reshape(-1)[: w.shape[0]], w.matvec(x[: w.shape[1]]),
                               rtol=1e-5, atol=1e-5 * float(np.abs(y).max() + 1))


@pytest.mark.parametrize("case", ["geometric", "fem", "shuffled"])
@pytest.mark.parametrize("kernel", ["well_spmv", "well_spmv_fused_gather"])
def test_plain_well_spmv_matches_tpucgs_pallas(case, kernel):
    # tpucg's Pallas kernels (interpret mode) route sublanes through a
    # one-hot product and round otherwise: held to 1e-6 of sum |a_ij x_j|.
    w = csr_to_well(CASES[case]())
    x = _x(w)
    targs, jargs = _args(w, x)
    jfn = j_well_spmv if kernel == "well_spmv" else j_well_spmv_fused_gather
    fn = well_spmv if kernel == "well_spmv" else well_spmv_fused_gather
    y = fn(*targs).numpy()  # the dispatch: a CPU tensor runs the plain version
    err = np.abs(y - np.asarray(jfn(*jargs))) / np.maximum(_abs_sum(w, x), 1e-30)
    assert err.max() <= 1e-6


def test_plain_well_spmv_propagates_a_nan_through_padding():
    # Padding sublanes read x[0] (window 0, lane 0): 0 * NaN poisons their
    # group as tpucg's scatter-add does.
    w = csr_to_well(CASES["geometric"]())
    x = _x(w)
    x[0] = np.nan
    targs, jargs = _args(w, x)
    y = well_spmv_torch(*targs).numpy()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(np.asarray(well_spmv_xla(*jargs))))
    assert np.isnan(y).any()


def test_bf16_values_widen_exactly():
    w = csr_to_well(CASES["fem"]())
    x = _x(w)
    targs, jargs = _args(w, x)
    v16 = targs[0].to(torch.bfloat16)
    y = well_spmv_torch(v16, *targs[1:]).numpy()
    jv16 = jnp.asarray(np.asarray(v16.float()).astype(ml_dtypes.bfloat16))
    np.testing.assert_array_equal(y, np.asarray(well_spmv_xla(jv16, *jargs[1:])))


def test_group_index_lists_every_sublane_in_order():
    w = csr_to_well(CASES["fem"]())
    gptr, gsub = group_index(torch.from_numpy(w.gidl), torch.from_numpy(w.sgb),
                             w.groups_per_super, w.n_supergroups)
    assert gptr.dtype == gsub.dtype == torch.int32
    g = w.group_of_sublane()
    gptr, gsub = gptr.numpy(), gsub.numpy()
    assert gptr[0] == 0 and gptr[-1] == w.n_sublanes
    assert sorted(gsub.tolist()) == list(range(w.n_sublanes))
    for grp in range(gptr.size - 1):
        subs = gsub[gptr[grp]:gptr[grp + 1]]
        assert (g[subs] == grp).all() and (np.diff(subs) > 0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_well_operator_matches_tpucgs(dtype):
    A, b, _ = random_geometric_spd(1000, seed=6, avg_degree=9.0)
    storage = torch.bfloat16 if dtype == "bf16" else torch.float32
    op = WellOperator.from_csr(A, storage_dtype=storage, device=CPU)
    jop = JWellOperator.from_csr(A, backend="xla",
                                 storage_dtype=jnp.bfloat16 if dtype == "bf16" else np.float32)
    assert (op.n, op.padded_n, op.bg, op.nsg, op.backend) == (
        jop.n, jop.padded_n, jop.bg, jop.nsg, "torch")
    assert op.vals.dtype == storage
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    x = np.random.default_rng(2).standard_normal(op.padded_n).astype(np.float32)
    np.testing.assert_array_equal(op.matvec(torch.from_numpy(x)).numpy(),
                                  np.asarray(jop.matvec(jnp.asarray(x))))
    carried = well_operator_from_numpy(*(np.asarray(getattr(jop, f)) for f in (
        "vals", "lidx", "gidl", "wrow", "sgb", "dvec")), jop.n, jop.bg, jop.nsg)
    assert carried.vals.dtype == storage
    np.testing.assert_array_equal(carried.matvec(torch.from_numpy(x)).numpy(),
                                  op.matvec(torch.from_numpy(x)).numpy())


def test_well_operator_diagonal_and_tail():
    A = _random_csr(300, 0.03, seed=9)
    op = WellOperator.from_csr(A, device=CPU)
    d = op.diagonal().numpy()
    np.testing.assert_allclose(d[:300], np.diag(A.to_dense()), rtol=1e-6, atol=1e-6)
    assert (d[300:] == 1.0).all() and d.shape == (384,)


def test_well_operator_refuses_what_later_slices_bring():
    A = _random_csr(200, 0.03, seed=1)
    with pytest.raises(NotImplementedError, match="M8"):
        WellOperator.from_csr(A, pc_block_size=16, device=CPU)
    op = WellOperator.from_csr(A, device=CPU)
    with pytest.raises(NotImplementedError, match="M9"):
        op.matvec_multi(torch.zeros(op.padded_n, 2))
    with pytest.raises(NotImplementedError, match="M8"):
        op.diagonal_blocks(16)
    with pytest.raises(ValueError, match="square"):
        WellOperator.from_csr(CSRMatrix(indptr=np.zeros(3, np.int64),
                                        indices=np.zeros(0, np.int32),
                                        data=np.zeros(0, np.float32), shape=(2, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        WellOperator.from_csr(A, backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="storage_dtype"):
        WellOperator.from_csr(A, storage_dtype=torch.float16, device=CPU)


def test_well_operator_checks_its_arrays():
    op = WellOperator.from_csr(_random_csr(200, 0.03, seed=1), device=CPU)
    bad = op.wrow.clone()
    bad[0] = 99
    import dataclasses

    with pytest.raises(ValueError, match="wrow"):
        dataclasses.replace(op, wrow=bad)
    with pytest.raises(ValueError, match="dvec"):
        dataclasses.replace(op, dvec=op.dvec[:-1])


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_cg_solve_on_well_matches_tpucg(pc):
    A, b, _ = random_geometric_spd(1500, seed=4, avg_degree=8.0, shift=0.3)
    tol = 1e-5 * float(np.linalg.norm(b))
    op = WellOperator.from_csr(A, device=CPU)
    res = cg_solve(op, b, tol=tol, precondition=pc)
    jres = tpucg.cg_solve(JWellOperator.from_csr(A, backend="xla"), b, tol=tol, precondition=pc)
    assert bool(res.converged) and bool(jres.converged)
    assert abs(int(res.iterations) - int(jres.iterations)) <= 1
    assert scaled_err(res.x.numpy(), np.asarray(jres.x)) <= 1e-4
    assert rel_err(A.matvec(res.x.numpy().astype(np.float64)), b) <= 1.1e-5


@pytest.mark.parametrize("pc,laps", [("none", 8), ("jacobi", 7)])
def test_cg_solve_on_well_equal_laps_when_the_spectrum_sets_them(pc, laps):
    # A block-diagonal matrix of 4 x 4 blocks of two types (eigenvalues 1, 2,
    # 4, 8 and 1.4 times those): 8 distinct eigenvalues, so CG ends in 8 laps
    # (7 for Jacobi, whose D^-1 A has fewer), the residual before the last
    # lap 7-16 times tol 1e-2 and after it 5-40 times below. WELL packs it
    # like any irregular matrix.
    rng = np.random.default_rng(0)
    n, bsz = 1000, 4
    types = []
    for scale in (1.0, 1.4):
        Q, _ = np.linalg.qr(rng.standard_normal((bsz, bsz)))
        types.append((Q * (scale * np.array([1.0, 2.0, 4.0, 8.0]))) @ Q.T)
    pick = rng.integers(2, size=n // bsz)
    pick[:2] = (0, 1)
    r, c = np.meshgrid(np.arange(bsz), np.arange(bsz), indexing="ij")
    base = np.repeat(np.arange(n // bsz) * bsz, bsz * bsz)
    A = COOMatrix(row=base + np.tile(r.ravel(), n // bsz),
                  col=base + np.tile(c.ravel(), n // bsz),
                  data=np.concatenate([types[t].ravel() for t in pick]).astype(np.float32),
                  shape=(n, n)).to_csr()
    b = rng.standard_normal(n).astype(np.float32)
    op = WellOperator.from_csr(A, device=CPU)
    res = cg_solve(op, b, tol=1e-2, precondition=pc, maxiter=50)
    jres = tpucg.cg_solve(JWellOperator.from_csr(A, backend="xla"), b, tol=1e-2,
                          precondition=pc, maxiter=50)
    assert int(res.iterations) == int(jres.iterations) == laps
    assert scaled_err(res.x.numpy(), np.asarray(jres.x)) <= 1e-4
