"""tpucg_torch's orderings and irregular generators (NumPy copies of
``tpucg.sparse.ordering`` and ``tpucg.io.generator``) against tpucg's: the
same arrays for the same inputs and seeds."""

import numpy as np
import pytest

import tpucg.io.generator as jgen
import tpucg.sparse.formats as jfmt
import tpucg.sparse.ordering as jord
from tpucg_torch.io.generator import (
    aniso_grid_system,
    fem_p1_aniso_system,
    fem_p1_system,
    random_geometric_graph_csr,
    random_geometric_spd,
)
from tpucg_torch.sparse.formats import COOMatrix
from tpucg_torch.sparse.ordering import permute_csr, rcm_order, strength_order


def _csr_equal(a, b):
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert tuple(a.shape) == tuple(b.shape)


GENERATORS = {
    "graph": (random_geometric_graph_csr, jgen.random_geometric_graph_csr,
              dict(n=600, seed=1, avg_degree=8.0)),
    "graph_3d_shuffled": (random_geometric_graph_csr, jgen.random_geometric_graph_csr,
                          dict(n=500, seed=2, dim=3, avg_degree=10.0, shuffle=True)),
    "geometric_spd": (random_geometric_spd, jgen.random_geometric_spd,
                      dict(n=700, seed=0, avg_degree=12.0)),
    "geometric_spd_shuffled": (random_geometric_spd, jgen.random_geometric_spd,
                               dict(n=500, seed=4, shift=0.3, shuffle=True)),
    "fem": (fem_p1_system, jgen.fem_p1_system, dict(n_points=1500, seed=0)),
    "fem_shuffled": (fem_p1_system, jgen.fem_p1_system, dict(n_points=800, seed=3, shuffle=True)),
    "fem_aniso": (fem_p1_aniso_system, jgen.fem_p1_aniso_system,
                  dict(n_points=800, eps=1e-2, seed=1)),
    "fem_aniso_rotating": (fem_p1_aniso_system, jgen.fem_p1_aniso_system,
                           dict(n_points=600, eps=0.1, rotating=True, seed=2, shuffle=True)),
    "aniso_grid": (aniso_grid_system, jgen.aniso_grid_system, dict(m=20, eps=1e-2, seed=0)),
    "aniso_grid_shuffled": (aniso_grid_system, jgen.aniso_grid_system,
                            dict(m=17, eps=0.05, seed=3, shuffle=True)),
}


@pytest.mark.parametrize("case", sorted(GENERATORS))
def test_generators_equal_tpucgs(case):
    ours, theirs, kw = GENERATORS[case]
    got, want = ours(**kw), theirs(**kw)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    _csr_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_generators_refuse_what_tpucgs_refuse():
    for fn, kw, msg in ((random_geometric_graph_csr, dict(n=10, dim=4), "dim"),
                        (fem_p1_aniso_system, dict(n_points=50, eps=0.0), "eps"),
                        (aniso_grid_system, dict(m=1), "m must be"),
                        (aniso_grid_system, dict(m=4, eps=-1.0), "eps")):
        with pytest.raises(ValueError, match=msg):
            fn(**kw)


def _systems():
    A, _, _ = random_geometric_spd(900, seed=5, avg_degree=7.0, shuffle=True)
    F, _, _ = fem_p1_system(700, seed=2, shuffle=True)
    G, _, _ = aniso_grid_system(15, eps=1e-2, seed=1, shuffle=True)
    return {"geometric": A, "fem": F, "aniso_grid": G}


@pytest.mark.parametrize("case", ["geometric", "fem", "aniso_grid"])
def test_orderings_equal_tpucgs(case):
    A = _systems()[case]
    perm = rcm_order(A)
    np.testing.assert_array_equal(perm, jord.rcm_order(A))
    assert sorted(perm.tolist()) == list(range(A.shape[0]))
    for theta in (0.25, 0.6):
        np.testing.assert_array_equal(strength_order(A, theta=theta),
                                      jord.strength_order(A, theta=theta))
    _csr_equal(permute_csr(A, perm), jord.permute_csr(A, perm))


def test_ordering_of_a_disconnected_graph_and_empty_strong_graph():
    n = 50
    rows = np.concatenate([np.arange(n), np.arange(0, 20), np.arange(1, 21)])
    cols = np.concatenate([np.arange(n), np.arange(1, 21), np.arange(0, 20)])
    vals = np.concatenate([np.full(n, 4.0), np.full(40, -1e-3)]).astype(np.float32)
    A = COOMatrix(row=rows, col=cols, data=vals, shape=(n, n)).to_csr()
    np.testing.assert_array_equal(rcm_order(A), jord.rcm_order(A))
    # theta above every off-diagonal: no strong edge, one component each.
    np.testing.assert_array_equal(strength_order(A, theta=0.9), jord.strength_order(A, theta=0.9))
    with pytest.raises(ValueError, match="square"):
        permute_csr(jfmt.CSRMatrix(indptr=np.zeros(3, np.int64), indices=np.zeros(0, np.int32),
                                   data=np.zeros(0, np.float32), shape=(2, 3)), np.arange(2))


def test_rcm_shrinks_the_bandwidth_of_a_shuffled_mesh():
    A = _systems()["geometric"]
    B = permute_csr(A, rcm_order(A))
    bw = [int(np.abs(M.to_coo().col - M.to_coo().row).max()) for M in (A, B)]
    assert bw[1] < bw[0]
