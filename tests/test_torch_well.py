"""tpucg_torch's WELL path against tpucg on the CPU: ``csr_to_well``'s
arrays (array-equal), K13's plain version over its ``WellRows`` layout
against tpucg's ``well_spmv_xla`` (bit for bit on finite x: both sum each
row in ascending sublane order, and the layout's dropped zero slots add +-0
to a sum that is never -0) and its Pallas ``well_spmv`` in interpret mode
(within 1e-6 of sum |a_ij x_j|), the layout itself, the K14 name,
``WellOperator`` (diagonal, padding, carried across from tpucg) and CG
solves on it. K13 itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpucg
import tpucg.sparse.well as jwell
from _torch_helpers import arrowhead_spd, rel_err, scaled_err
from tpucg.kernels.gather_spmv import well_spmv as j_well_spmv
from tpucg.kernels.gather_spmv import well_spmv_fused_gather as j_well_spmv_fused_gather
from tpucg.kernels.gather_spmv import well_spmv_xla
from tpucg.solver.operators import WellOperator as JWellOperator
from tpucg_torch.interop import well_operator_from_numpy
from tpucg_torch.io.generator import fem_p1_system, random_geometric_spd
from tpucg_torch.kernels.gather_spmv import (
    TILE,
    well_rows,
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


def _bf16(targs, jargs):
    """The arrays with their values rounded to bf16, in both packages."""
    v16 = targs[0].to(torch.bfloat16)
    jv16 = jnp.asarray(np.asarray(v16.float()).astype(ml_dtypes.bfloat16))
    return (v16, *targs[1:]), (jv16, *jargs[1:])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_well_spmv_is_tpucgs_xla_bit_for_bit(case, dtype):
    w = csr_to_well(CASES[case]())
    x = _x(w)
    targs, jargs = _args(w, x)
    if dtype == "bf16":
        targs, jargs = _bf16(targs, jargs)
    y = well_spmv_torch(*targs).numpy()
    np.testing.assert_array_equal(y, np.asarray(well_spmv_xla(*jargs)))
    if dtype == "f32":
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


def test_plain_well_spmv_propagates_a_nan_to_the_rows_that_read_it():
    # The intended difference from tpucg (ROADMAP §3): tpucg's padding
    # slots read x at lane 0 of their window (window 0 for the block
    # padding), so x[0] = NaN poisons rows that store nothing in column 0.
    # The layout reads live slots only: the NaN reaches exactly the rows
    # with a stored nonzero in column 0, as a CSR product does, and every
    # other row equals tpucg's bit for bit.
    A = CASES["geometric"]()
    w = csr_to_well(A)
    x = _x(w)
    x[0] = np.nan
    targs, jargs = _args(w, x)
    y = well_spmv_torch(*targs).numpy().reshape(-1)
    jy = np.asarray(well_spmv_xla(*jargs)).reshape(-1)
    coo = A.to_coo()
    readers = np.zeros(y.size, bool)
    readers[coo.row[(coo.col == 0) & (coo.data != 0)]] = True
    np.testing.assert_array_equal(np.isnan(y), readers)
    assert readers.any() and np.isnan(jy).sum() > readers.sum()
    assert not (np.isnan(y) & ~np.isnan(jy)).any()
    np.testing.assert_array_equal(y[~np.isnan(jy)], jy[~np.isnan(jy)])


def test_bf16_values_widen_exactly():
    w = csr_to_well(CASES["fem"]())
    x = _x(w)
    targs, jargs = _bf16(*_args(w, x))
    y = well_spmv_torch(*targs).numpy()
    np.testing.assert_array_equal(y, np.asarray(well_spmv_xla(*jargs)))


def _live_slots(w):
    """(row, sublane, column, value) of every live slot, by NumPy, in the
    layout's order: by row, each row's in ascending sublane."""
    s, lane = np.nonzero(w.vals)
    row = w.group_of_sublane()[s] * 128 + lane
    col = w.wrow_per_sublane()[s].astype(np.int64) * 128 + w.lidx[s, lane]
    order = np.lexsort((s, row))
    return row[order], s[order], col[order], w.vals[s, lane][order]


def _rows_of(w, tile=TILE):
    t = [torch.from_numpy(getattr(w, f)) for f in ("vals", "lidx", "gidl", "wrow", "sgb")]
    return well_rows(*t, w.groups_per_super, w.n_supergroups, tile=tile)


@pytest.mark.parametrize("tile", [2, 64, TILE])
@pytest.mark.parametrize("case", ["fem", "shuffled", "random", "empty", "duplicates"])
def test_well_rows_layout(case, tile):
    w = csr_to_well(CASES[case]())
    rows = _rows_of(w, tile)
    nrows = w.n_supergroups * w.groups_per_super * 128
    assert rows.tile == tile and rows.rvals.dtype == torch.float32
    assert all(t.dtype == torch.int32 for t in (rows.rowptr, rows.cols, rows.tptr))
    ptr = rows.rowptr.numpy().astype(np.int64)
    assert ptr.shape == (nrows + 1,) and ptr[0] == 0 and (np.diff(ptr) >= 0).all()
    assert ptr[-1] == np.count_nonzero(w.vals) == rows.cols.numel()
    row, s, col, val = _live_slots(w)
    np.testing.assert_array_equal(np.repeat(np.arange(nrows), np.diff(ptr)), row)
    # Each row's slots in ascending sublane: the order tpucg's scatter-add
    # and the kernel before the redesign summed in.
    same_row = row[1:] == row[:-1]
    assert (s[1:][same_row] > s[:-1][same_row]).all()
    np.testing.assert_array_equal(rows.cols.numpy(), col)
    np.testing.assert_array_equal(rows.rvals.numpy(), val)
    tp = rows.tptr.numpy().astype(np.int64)
    assert tp[0] == 0 and tp[-1] == nrows and (np.diff(tp) > 0).all()
    slots = ptr[tp[1:]] - ptr[tp[:-1]]
    single = np.diff(tp) == 1
    assert ((slots <= tile) | single).all() and (np.diff(tp) <= tile).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_well_rows_builder_refuses_what_does_not_fit(dtype):
    w = csr_to_well(CASES["tiny"]())
    with pytest.raises(ValueError, match="tile"):
        _rows_of(w, tile=1)
    with pytest.raises(ValueError, match="tile"):
        _rows_of(w, tile=12289)
    t = [torch.from_numpy(getattr(w, f)) for f in ("vals", "lidx", "gidl", "wrow", "sgb")]
    if dtype == "bf16":
        t[0] = t[0].to(torch.bfloat16)
    assert well_rows(*t, 1, 1).rvals.dtype == t[0].dtype
    with pytest.raises(ValueError, match="int32"):
        well_rows(*t, 1, 2 ** 24)


def test_explicitly_stored_zeros_change_no_bit():
    # +0 and -0 stored in the CSR: WELL packs them as zero slots, the layout
    # drops them, tpucg adds their +-0 * x. Bit for bit all the same.
    A = CASES["geometric"]()
    data = A.data.copy()
    rng = np.random.default_rng(3)
    pick = rng.choice(data.size, size=data.size // 5, replace=False)
    data[pick[::2]] = 0.0
    data[pick[1::2]] = -0.0
    Z = CSRMatrix(indptr=A.indptr, indices=A.indices, data=data, shape=A.shape)
    w = csr_to_well(Z)
    assert w.nnz == np.count_nonzero(data) + (w.n_groups * 128 - A.shape[0])
    x = _x(w)
    targs, jargs = _args(w, x)
    assert _rows_of(w).cols.numel() == w.nnz
    y = well_spmv_torch(*targs).numpy()
    np.testing.assert_array_equal(y, np.asarray(well_spmv_xla(*jargs)))
    np.testing.assert_array_equal(y.reshape(-1)[: A.shape[0]] == 0,
                                  np.diff(np.r_[0, np.cumsum(data != 0)][A.indptr]) == 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_long_row_arrowhead(dtype):
    A = arrowhead_spd(TILE + 900)
    w = csr_to_well(A)
    rows = _rows_of(w)
    ptr, tp = rows.rowptr.numpy(), rows.tptr.numpy()
    assert ptr[1] - ptr[0] == A.shape[0] > TILE and tp[1] == 1  # row 0: a tile of its own
    x = _x(w)
    targs, jargs = _args(w, x)
    if dtype == "bf16":
        targs, jargs = _bf16(targs, jargs)
    y = well_spmv_torch(*targs).numpy()
    np.testing.assert_array_equal(y, np.asarray(well_spmv_xla(*jargs)))
    if dtype == "f32":
        # Within the float32 rounding of a sum of len + 1 roundings.
        lens = np.diff(ptr)[: A.shape[0]]
        ref = w.matvec(x[: A.shape[1]].astype(np.float64))
        bound = 1.01 * (lens + 1) * 2.0 ** -24 * _abs_sum(w, x).reshape(-1)[: A.shape[0]]
        assert (np.abs(y.reshape(-1)[: A.shape[0]] - ref) <= bound + 1e-30).all()


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
    # Block Jacobi's blocks (once refused as M8) come from the CSR, as
    # tpucg's do; an operator built without them refuses with tpucg's
    # message. The multi-RHS product (once refused as M9) is the
    # single-column product on each column, bit for bit.
    A = _random_csr(200, 0.03, seed=1)
    blocked = WellOperator.from_csr(A, pc_block_size=16, device=CPU)
    np.testing.assert_array_equal(blocked.diagonal_blocks(16).numpy(), np.asarray(
        JWellOperator.from_csr(A, backend="xla", pc_block_size=16).dblk))
    op = WellOperator.from_csr(A, device=CPU)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (op.padded_n, 2)).astype(np.float32))
    Y = op.matvec_multi(X)
    for j in range(2):
        assert torch.equal(Y[:, j], op.matvec(X[:, j].contiguous()))
    with pytest.raises(NotImplementedError, match="pc_block_size=bs"):
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
