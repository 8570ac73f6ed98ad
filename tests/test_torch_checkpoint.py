"""The port's checkpointed solve (``solver/checkpoint.py``) against tpucg's,
on the CPU: the serial cases of tpucg's ``tests/test_checkpoint.py``, the
file read and written across the two packages, and ``RecyclingCG``'s
checkpointed solve.

The port runs its plain versions, tpucg its XLA route. Within the port a
segmented or killed-and-resumed solve equals the solve run through bit for
bit (and, dense and WELL, the port's own ``cg_solve``: on the CPU neither
fuses). Against tpucg: laps equal, x within 1e-5 of max |x|; a file
written by one package and resumed in the other: laps within one, x within
1e-4 of max |x| (the other package's rounding takes over mid-solve). The
cross-package files use n = 128, where both packages pad alike."""

import os

import numpy as np
import pytest
import torch

import tpucg
import tpucg.solver.checkpoint as jck
from _torch_helpers import scaled_err, tpucg_padded_dense
from tpucg_torch.interop import deflation_basis_from_numpy, two_level_from_numpy
from tpucg_torch.io.generator import fem_p1_system, generate_spd_system
from tpucg_torch.io.golden import GOLDEN_4X4
from tpucg_torch.solver.cg import TRUE_CHECK_EVERY, cg_solve
from tpucg_torch.solver.checkpoint import (
    _basis_identity,
    _state_to_host,
    _two_level_identity,
    cg_solve_checkpointed,
    load_checkpoint,
    save_checkpoint,
    signatures_match,
)
from tpucg_torch.solver.deflation import RecyclingCG, build_deflation_basis
from tpucg_torch.solver.operators import WellOperator, best_sparse_operator
from tpucg_torch.solver.twolevel import build_two_level

CPU = torch.device("cpu")
FILE_KEYS = {"x": (np.float32, 1), "r": (np.float32, 1), "p": (np.float32, 1),
             "rsold": (np.float32, 0), "rslast": (np.float32, 0), "k": (np.int32, 0),
             "done": (np.bool_, 0), "n": (np.int64, 0), "tol": (np.float64, 0),
             "signature": (np.float64, 1)}


def _conditioned(n, seed=4):
    """tpucg's fixture: the generator's system with its shift cut from n to
    n/8, so CG takes a healthy number of laps."""
    A, b, x0 = generate_spd_system(n, seed=seed)
    return (A - np.float32(n - n / 8.0) * np.eye(n, dtype=np.float32)).astype(np.float32), b, x0


@pytest.fixture
def system():
    return _conditioned(96)


def _ck(A, b, x0=None, **kw):
    return cg_solve_checkpointed(A, b, x0, device=CPU, **kw)


def test_checkpointed_matches_plain_and_tpucg(system):
    A, b, x0 = system
    res = _ck(A, b, x0, segment_iters=3)
    ref = cg_solve(A, b, x0, device=CPU)
    jres = jck.cg_solve_checkpointed(A, b, x0, segment_iters=3)
    assert bool(res.converged) and bool(jres.converged)
    assert int(res.iterations) == int(ref.iterations) == int(jres.iterations)
    assert torch.equal(res.x, ref.x)
    assert scaled_err(res.x.numpy(), np.asarray(jres.x)) <= 1e-5


@pytest.mark.parametrize("pc", ["jacobi", "block_jacobi"])
def test_checkpointed_preconditioned_matches_plain(system, pc):
    A, b, x0 = system
    kw = dict(precondition=pc, pc_block_size=32)
    res = _ck(A, b, x0, segment_iters=2, **kw)
    ref = cg_solve(A, b, x0, device=CPU, **kw)
    assert bool(res.converged) and int(res.iterations) == int(ref.iterations)
    assert torch.equal(res.x, ref.x)


def test_resume_is_bit_identical(system, tmp_path):
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    ref = _ck(A, b, x0, segment_iters=4)
    k_total = int(ref.iterations)
    assert k_total > 8, "the fixture must need several segments"
    partial = _ck(A, b, x0, segment_iters=4, maxiter=8, checkpoint_path=ck,
                  keep_checkpoint=True)
    assert int(partial.iterations) == 8 and os.path.exists(ck)
    res = _ck(A, b, x0, segment_iters=4, checkpoint_path=ck)
    assert int(res.iterations) == k_total and bool(res.converged)
    assert torch.equal(res.x, ref.x)
    assert not os.path.exists(ck), "the file is removed on convergence"


def test_checkpoint_roundtrip_exact(tmp_path):
    n = 32
    A, b, x0 = generate_spd_system(n, seed=1)
    ck = str(tmp_path / "s.npz")
    _ck(A, b, x0, segment_iters=1, maxiter=1, checkpoint_path=ck, keep_checkpoint=True)
    state, n_ck, tol, sig, pre = load_checkpoint(ck, device=CPU)
    assert sig.size and pre == "none" and n_ck == n and tol == 1.0e-6
    assert int(state.k) == 1 and state.x.device == CPU
    save_checkpoint(ck, state, n_ck, tol)
    state2, _, _, sig2, _ = load_checkpoint(ck, device=CPU)
    assert sig2.size == 0
    for f in ("k", "x", "r", "p", "rsold", "rslast", "done"):
        assert torch.equal(getattr(state, f), getattr(state2, f)), f
    # The one-transfer host copy of a segment's state holds the same bits.
    host = _state_to_host(state)
    for f in ("x", "r", "p", "rsold", "rslast", "k", "done"):
        np.testing.assert_array_equal(host[f], getattr(state, f).numpy(), err_msg=f)
        assert np.asarray(host[f]).dtype == getattr(state, f).numpy().dtype, f


def test_refusals_size_tol_precondition_signature(system, tmp_path):
    # tpucg's :81 (size, tol), :338 (preconditioner), :131 (another system
    # of the same size, A or b).
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    _ck(A, b, x0, segment_iters=2, maxiter=2, checkpoint_path=ck, keep_checkpoint=True)
    A2, b2, x02 = generate_spd_system(48, seed=0)
    with pytest.raises(ValueError, match="checkpoint"):
        _ck(A2, b2, x02, checkpoint_path=ck)
    with pytest.raises(ValueError, match="tol"):
        _ck(A, b, x0, checkpoint_path=ck, tol=1e-4)
    with pytest.raises(ValueError, match="precondition"):
        _ck(A, b, x0, checkpoint_path=ck, precondition="jacobi")
    with pytest.raises(ValueError, match="precondition"):
        _ck(A, b, x0, checkpoint_path=ck, precondition="block_jacobi", pc_block_size=32)
    with pytest.raises(ValueError, match="signature"):
        _ck(A + np.float32(0.5) * np.eye(96, dtype=np.float32), b, x0, checkpoint_path=ck)
    with pytest.raises(ValueError, match="signature"):
        _ck(A, b + 1.0, x0, checkpoint_path=ck)
    ckb = str(tmp_path / "bj.npz")
    _ck(A, b, x0, segment_iters=2, maxiter=2, checkpoint_path=ckb, keep_checkpoint=True,
        precondition="block_jacobi", pc_block_size=32)
    with pytest.raises(ValueError, match="precondition"):
        _ck(A, b, x0, checkpoint_path=ckb, precondition="block_jacobi", pc_block_size=16)


def test_golden_through_checkpointing():
    g = GOLDEN_4X4
    res = _ck(g["A"], g["b"], g["x0"], segment_iters=1)
    assert int(res.iterations) == g["iters"] == 4
    np.testing.assert_allclose(res.x.numpy(), g["x_star"], atol=2e-3)


def test_checkpoint_survives_maxiter_cap(system, tmp_path):
    A, b, x0 = system
    ck = str(tmp_path / "cg.npz")
    partial = _ck(A, b, x0, segment_iters=3, maxiter=6, checkpoint_path=ck)
    assert not bool(partial.converged)
    assert os.path.exists(ck), "a capped exit keeps the file"
    full = _ck(A, b, x0, segment_iters=3, checkpoint_path=ck)
    assert bool(full.converged) and not os.path.exists(ck)
    assert torch.equal(full.x, cg_solve(A, b, x0, device=CPU).x)


def test_checkpoint_rejects_pipelined_poly_f64_and_bad_segments(system):
    A, b, x0 = system
    with pytest.raises(ValueError, match="pipelined"):
        _ck(A, b, x0, method="pipelined")
    with pytest.raises(ValueError, match="lambda_max"):
        _ck(A, b, x0, precondition="poly")
    with pytest.raises(ValueError, match="float32"):
        _ck(A, b, x0, dtype=torch.float64)
    with pytest.raises(ValueError, match="segment_iters"):
        _ck(A, b, x0, segment_iters=0)


def test_signature_blocks_compared_on_own_scales():
    a = np.array([1e6, -2e6, 1.5e6, 9e5, 1.0, 2.0, -1.5, 0.5])
    b = a.copy()
    b[5] += 0.5  # a change of the b block, tiny against the A block's scale
    assert not signatures_match(a, b)
    assert signatures_match(a, a * (1 + 1e-7))
    assert signatures_match(a, b) == jck.signatures_match(a, b)


# ---- WELL and two-level (FEM 6000) -------------------------------------------


@pytest.fixture(scope="module")
def irregular():
    A, b, _ = fem_p1_system(6_000, seed=1)
    op = best_sparse_operator(A, device=CPU)
    return A, b, op, build_two_level(A, agg_size=32, npad=op.padded_n, device=CPU)


def test_checkpointed_well_two_level_resume_bit_identical(irregular, tmp_path):
    A, b, op, tl = irregular
    assert isinstance(op, WellOperator)
    n = A.shape[0]
    tol = 1e-3 * float(np.linalg.norm(b))  # above FEM's f32 floor
    ck = str(tmp_path / "well.npz")
    ref = _ck(op, b, tol=tol, segment_iters=8, two_level=tl, maxiter=4 * n)
    k_total = int(ref.iterations)
    assert bool(ref.converged) and k_total >= 16 and k_total % TRUE_CHECK_EVERY == 0
    plain = cg_solve(op, b, tol=tol, two_level=tl, maxiter=4 * n)
    assert int(plain.iterations) == k_total and torch.equal(ref.x, plain.x)
    partial = _ck(op, b, tol=tol, segment_iters=8, maxiter=16, two_level=tl,
                  checkpoint_path=ck, keep_checkpoint=True)
    assert int(partial.iterations) == 16 and os.path.exists(ck)
    res = _ck(op, b, tol=tol, segment_iters=8, two_level=tl, checkpoint_path=ck,
              maxiter=4 * n)
    assert int(res.iterations) == k_total and torch.equal(res.x, ref.x)
    assert not os.path.exists(ck)
    jop = tpucg.best_sparse_operator(A)
    jtl = tpucg.build_two_level(A, agg_size=32, npad=jop.padded_n)
    jres = jck.cg_solve_checkpointed(jop, b, tol=tol, segment_iters=8, two_level=jtl,
                                     maxiter=4 * n)
    assert int(jres.iterations) == k_total
    assert scaled_err(res.x.numpy(), np.asarray(jres.x)) <= 1e-5


def test_checkpoint_rejects_two_level_identity_mismatch(irregular, tmp_path):
    # tpucg's :469.
    A, b, op, tl = irregular
    tol = 1e-5 * float(np.linalg.norm(b))
    ck = str(tmp_path / "tl.npz")
    _ck(op, b, tol=tol, segment_iters=4, maxiter=4, two_level=tl, checkpoint_path=ck,
        keep_checkpoint=True)
    tl2 = build_two_level(A, agg_size=64, npad=op.padded_n, device=CPU)
    with pytest.raises(ValueError, match="precondition"):
        _ck(op, b, tol=tol, two_level=tl2, checkpoint_path=ck)
    with pytest.raises(ValueError, match="precondition"):
        _ck(op, b, tol=tol, checkpoint_path=ck)
    bad = build_two_level(A, agg_size=32, npad=op.padded_n + 128, device=CPU)
    with pytest.raises(ValueError, match="padded size"):
        _ck(op, b, tol=tol, two_level=bad)
    with pytest.raises(ValueError, match="THE preconditioner"):
        _ck(op, b, tol=tol, two_level=tl, precondition="jacobi")


def test_checkpointed_stagnation_stop_matches_plain(irregular, tmp_path):
    # tpucg's :492: below the f32 floor the two-level solve stops on
    # stagnation; 24-lap segments end mid check window, and the carry keeps
    # the stop at the unsegmented lap. Killed and resumed, the carry
    # restarts at (inf, False): the stop comes within two windows.
    A, b, op, tl = irregular
    n = A.shape[0]
    tol = 1e-7 * float(np.linalg.norm(b))
    cap = 4 * n
    plain = cg_solve(op, b, tol=tol, two_level=tl, maxiter=cap)
    k_plain = int(plain.iterations)
    assert not bool(plain.converged) and k_plain < cap, "the fixture must stagnate"
    seg = _ck(op, b, tol=tol, segment_iters=24, two_level=tl, maxiter=cap)
    assert not bool(seg.converged) and int(seg.iterations) == k_plain
    assert torch.equal(seg.x, plain.x)
    ck = str(tmp_path / "stag.npz")
    _ck(op, b, tol=tol, segment_iters=24, two_level=tl, maxiter=k_plain - 8,
        checkpoint_path=ck)
    assert os.path.exists(ck)
    res = _ck(op, b, tol=tol, segment_iters=24, two_level=tl, maxiter=cap, checkpoint_path=ck)
    k = int(res.iterations)
    assert not bool(res.converged) and k_plain <= k <= k_plain + 2 * TRUE_CHECK_EVERY
    # tpucg removes the file once the solve is done, a stagnation stop too
    # (checkpoint.py:477-483): so does the port.
    assert not os.path.exists(ck)


def test_checkpointed_bare_csr_promotes_to_well(irregular):
    # tpucg's :517, and ADVICE #1: the checkpointed entry point promotes a
    # bare CSR (WELL here), cg_solve maps it to ELL.
    A, b, op, tl = irregular
    n = A.shape[0]
    tol = 1e-3 * float(np.linalg.norm(b))
    res = _ck(A, b, tol=tol, segment_iters=64, two_level=tl, maxiter=4 * n)
    ref = _ck(op, b, tol=tol, segment_iters=64, two_level=tl, maxiter=4 * n)
    assert bool(res.converged) and int(res.iterations) == int(ref.iterations)
    assert torch.equal(res.x, ref.x)
    with pytest.raises(ValueError, match="padded size"):
        cg_solve(A, b, tol=tol, two_level=tl, maxiter=4 * n, device=CPU)  # ELL: npad = n


def test_identities_equal_tpucgs_strings(irregular):
    A, b, op, tl = irregular
    jtl = tpucg.build_two_level(A, agg_size=32, npad=op.padded_n)
    assert _two_level_identity(tl) == jck._two_level_identity(jtl)
    assert _two_level_identity(tl).startswith(f"two_level[agg=32,om=0.7,sd=1,sa=4,npad="
                                              f"{op.padded_n},")
    # The multilevel form keeps tpucg's (1, 1) zero in acinv: another
    # coarse_max gives the same string (a known fault of the reference,
    # kept so that files interoperate).
    ml = [build_two_level(A, agg_size=4, npad=op.padded_n, coarse_max=cm, device=CPU)
          for cm in (64, 256)]
    assert ml[0].levels > 1 and _two_level_identity(ml[0]) == _two_level_identity(ml[1])
    jml = tpucg.build_two_level(A, agg_size=4, npad=op.padded_n, coarse_max=64)
    assert _two_level_identity(ml[0]) == jck._two_level_identity(jml)
    V = np.random.default_rng(2).standard_normal((A.shape[0], 2)).astype(np.float32)
    jbasis = tpucg.build_deflation_basis(tpucg.best_sparse_operator(A), V)
    basis = deflation_basis_from_numpy(np.asarray(jbasis.W), np.asarray(jbasis.AW),
                                       np.asarray(jbasis.Ginv))
    assert _basis_identity(basis) == jck._basis_identity(jbasis)
    assert _basis_identity(build_deflation_basis(op, V, device=CPU)).startswith("deflated[m=2,")


# ---- files across the packages (n = 128: both pad alike) ---------------------


def _files_system():
    return _conditioned(128)


def test_file_keys_dtypes_shapes_match_tpucgs(tmp_path):
    A, b, x0 = _files_system()
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    _ck(A, b, x0, segment_iters=8, maxiter=8, checkpoint_path=ours)
    jck.cg_solve_checkpointed(A, b, x0, segment_iters=8, maxiter=8, checkpoint_path=theirs)
    with np.load(ours) as zo, np.load(theirs) as zt:
        assert sorted(zo.files) == sorted(zt.files) == sorted(list(FILE_KEYS) + ["precondition"])
        for key in zo.files:
            assert zo[key].dtype == zt[key].dtype and zo[key].shape == zt[key].shape, key
        for key, (dtype, ndim) in FILE_KEYS.items():
            assert zo[key].dtype == dtype and zo[key].ndim == ndim, key
        assert zo["x"].shape == (128,) and int(zo["k"]) == int(zt["k"]) == 8
        assert bytes(zo["precondition"]) == bytes(zt["precondition"]) == b"none"
        np.testing.assert_allclose(zo["signature"], zt["signature"], rtol=1e-5)


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_tpucg_file_resumes_in_the_port(tmp_path, pc):
    A, b, x0 = _files_system()
    ck = str(tmp_path / "cg.npz")
    full = jck.cg_solve_checkpointed(A, b, x0, segment_iters=4, precondition=pc)
    jck.cg_solve_checkpointed(A, b, x0, segment_iters=4, maxiter=8, precondition=pc,
                              checkpoint_path=ck)
    assert os.path.exists(ck)
    res = _ck(A, b, x0, segment_iters=4, precondition=pc, checkpoint_path=ck)
    assert bool(res.converged) and not os.path.exists(ck)
    assert abs(int(res.iterations) - int(full.iterations)) <= 1
    assert scaled_err(res.x.numpy(), np.asarray(full.x)) <= 1e-4


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_port_file_resumes_in_tpucg(tmp_path, pc):
    A, b, x0 = _files_system()
    ck = str(tmp_path / "cg.npz")
    full = _ck(A, b, x0, segment_iters=4, precondition=pc)
    _ck(A, b, x0, segment_iters=4, maxiter=8, precondition=pc, checkpoint_path=ck)
    assert os.path.exists(ck)
    res = jck.cg_solve_checkpointed(A, b, x0, segment_iters=4, precondition=pc,
                                    checkpoint_path=ck)
    assert bool(res.converged) and not os.path.exists(ck)
    assert abs(int(res.iterations) - int(full.iterations)) <= 1
    assert scaled_err(np.asarray(res.x), full.x.numpy()) <= 1e-4


def test_cross_package_refusals(tmp_path):
    # The guard holds across the packages: a tpucg file for another tol,
    # preconditioner or system is refused by the port, and the reverse.
    A, b, x0 = _files_system()
    theirs, ours = str(tmp_path / "theirs.npz"), str(tmp_path / "ours.npz")
    jck.cg_solve_checkpointed(A, b, x0, segment_iters=4, maxiter=4, checkpoint_path=theirs)
    _ck(A, b, x0, segment_iters=4, maxiter=4, checkpoint_path=ours)
    with pytest.raises(ValueError, match="precondition"):
        _ck(A, b, x0, precondition="jacobi", checkpoint_path=theirs)
    with pytest.raises(ValueError, match="signature"):
        _ck(A, b + 1.0, x0, checkpoint_path=theirs)
    with pytest.raises(ValueError, match="tol"):
        jck.cg_solve_checkpointed(A, b, x0, tol=1e-4, checkpoint_path=ours)
    with pytest.raises(ValueError, match="signature"):
        jck.cg_solve_checkpointed(A + np.float32(0.5) * np.eye(128, dtype=np.float32), b, x0,
                                  checkpoint_path=ours)


def test_two_level_file_resumes_across_packages(irregular, tmp_path):
    # The same cycle on both sides (tpucg's, converted): its identity string
    # matches, so a tpucg WELL + two-level file resumes in the port.
    A, b, op, _ = irregular
    n = A.shape[0]
    tol = 1e-3 * float(np.linalg.norm(b))
    jop = tpucg.best_sparse_operator(A)
    jtl = tpucg.build_two_level(A, agg_size=32, npad=jop.padded_n)
    tl = two_level_from_numpy({f: np.asarray(getattr(jtl, f)) for f in (
        "acinv", "dinv", "agg", "npad", "omega", "smooth_degree", "smooth_alpha",
        "coarse_cycles")})
    full = jck.cg_solve_checkpointed(jop, b, tol=tol, segment_iters=16, two_level=jtl,
                                     maxiter=4 * n)
    ck = str(tmp_path / "tl.npz")
    jck.cg_solve_checkpointed(jop, b, tol=tol, segment_iters=16, maxiter=16, two_level=jtl,
                              checkpoint_path=ck)
    res = _ck(op, b, tol=tol, segment_iters=16, two_level=tl, maxiter=4 * n,
              checkpoint_path=ck)
    assert bool(res.converged) and int(res.iterations) == int(full.iterations)
    assert scaled_err(res.x.numpy(), np.asarray(full.x)) <= 1e-4


# ---- RecyclingCG's checkpointed solve ----------------------------------------


def _clustered_spd(n=128, n_small=3, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([0.01 * (1.0 + np.arange(n_small)),
                          1.0 + rng.uniform(0.0, 1.0, n - n_small)])
    A = (Q * lam) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32)


def test_recycling_checkpointed_solve_matches_tpucg(tmp_path):
    A = _clustered_spd()
    rng = np.random.default_rng(5)
    b0 = rng.standard_normal(128).astype(np.float32)
    rhs = [b0, (b0 + 0.05 * rng.standard_normal(128)).astype(np.float32)]
    tol = 1e-5 * float(np.linalg.norm(b0))
    kw = dict(max_vectors=2, tol=tol, maxiter=1024)
    port = RecyclingCG(A, device=CPU, **kw)
    ref = tpucg.RecyclingCG(tpucg_padded_dense(A), kernel="xla", **kw)
    whole = RecyclingCG(A, device=CPU, **kw)
    for t, b in enumerate(rhs):
        ck = str(tmp_path / f"rec{t}.npz")
        if t == 1:
            # The deflated solve killed after 4 laps, then resumed from its file
            # by the sequence.
            part = cg_solve_checkpointed(port.op, b, config=port.config, checkpoint_path=ck,
                                         segment_iters=2, basis=port._basis, device=CPU,
                                         maxiter=4)
            assert int(part.iterations) == 4 and os.path.exists(ck)
        r = port.solve(b, checkpoint_path=ck, segment_iters=2)
        j = ref.solve(b, checkpoint_path=str(tmp_path / f"j{t}.npz"), segment_iters=2)
        w = whole.solve(b)
        assert bool(r.converged) and bool(j.converged)
        assert int(r.iterations) == int(j.iterations) == int(w.iterations)
        assert torch.equal(r.x, w.x)
        assert scaled_err(r.x.numpy(), np.asarray(j.x)) <= 1e-4
        assert not os.path.exists(ck)
    assert port._basis is not None and port._basis.m == 2
