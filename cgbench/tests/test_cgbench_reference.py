"""The plain reference against a direct float64 solve on tiny systems of
both generators: the yardstick is right before it judges the program."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from cgbench import traffic
from cgbench.gen.fem_p1 import fem_p1_csr
from cgbench.gen.ref_dense import dense_spd
from cgbench.reference.cg import Operator, cg, tf32_round


def _dense(n, seed):
    return {"kind": "dense", "n": n,
            "A": dense_spd(n, traffic.generator_for(seed, "matrix", "cpu"), "cpu")}


def _fem(n_points, seed):
    indptr, indices, data, n = fem_p1_csr(n_points, seed)
    return {"kind": "csr", "n": n, "indptr": indptr, "indices": indices, "data": data}


def _scipy(inputs):
    if inputs["kind"] == "dense":
        return inputs["A"].double().numpy()
    n = inputs["n"]
    # Duplicates summed, as the reference must sum them.
    M = sp.csr_matrix((inputs["data"].astype(np.float64), inputs["indices"],
                       inputs["indptr"]), shape=(n, n))
    M.sum_duplicates()
    return M


@pytest.mark.parametrize("make,arg,seed,pc", [
    (_dense, 64, 0, "none"), (_dense, 300, 2**31 + 9, "none"), (_dense, 300, 4, "jacobi"),
    (_fem, 400, 0, "jacobi"), (_fem, 2500, 5, "jacobi"), (_fem, 2500, 6, "none"),
])
def test_reference_agrees_with_a_direct_solve(make, arg, seed, pc):
    inputs = make(arg, seed)
    n = inputs["n"]
    B = torch.randn((n, 5), generator=traffic.generator_for(seed, "rhs", "cpu"),
                    dtype=torch.float64)
    op = Operator(inputs, torch.float64, "cpu")
    X, laps, conv = cg(op, B, 1e-11 * torch.linalg.vector_norm(B, dim=0), 20 * n, pc)
    assert bool(conv.all()) and int(laps.min()) > 0
    M = _scipy(inputs)
    for j in range(B.shape[1]):
        b = B[:, j].numpy()
        x = spla.spsolve(M.tocsc(), b) if sp.issparse(M) else np.linalg.solve(M, b)
        err = np.linalg.norm(X[:, j].numpy() - x) / np.linalg.norm(x)
        assert err < 1e-7, err


def test_reference_sums_duplicates_and_its_diagonal():
    inputs = _fem(600, 1)
    op = Operator(inputs, torch.float64, "cpu")
    M = _scipy(inputs)
    assert op.nnz == M.nnz < len(inputs["data"])  # FEM assembly repeats entries
    assert np.allclose(op.diag.numpy(), M.diagonal(), rtol=1e-12, atol=0)
    x = np.random.default_rng(0).standard_normal(inputs["n"])
    y = op(torch.from_numpy(x)[:, None])[:, 0].numpy()
    assert np.allclose(y, M @ x, rtol=1e-12, atol=1e-12)


def test_reference_stops_as_the_reference_code_does():
    # serialConjugate.c's 4 x 4 system (SURVEY.md 3.5): 4 laps from x0 = 0.
    A = torch.tensor([[4, 1, 0, 0], [1, 4, 1, 0], [0, 1, 4, 1], [0, 0, 1, 4]],
                     dtype=torch.float32)
    b = A @ torch.tensor([-1.0, 1.0, -1.0, 1.0])
    op = Operator({"kind": "dense", "n": 4, "A": A}, torch.float32, "cpu")
    X, laps, conv = cg(op, b[:, None], torch.tensor([1e-6]), 4)
    assert bool(conv.all()) and int(laps[0]) <= 4
    assert torch.allclose(X[:, 0], torch.tensor([-1.0, 1.0, -1.0, 1.0]), atol=1e-5)


def test_tf32_rounding():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one, one + ulp / 4, one + ulp * 3 / 4, one + ulp / 2,
                      one + ulp * 3 / 2, -(one + ulp * 3 / 4), 3.0e-20, 0.0])
    y = tf32_round(x)
    want = torch.tensor([one, one, one + ulp, one, one + 2 * ulp, -(one + ulp)])
    assert torch.equal(y[:6], want)
    assert abs(float(y[6]) - 3.0e-20) <= 3.0e-20 * 2.0 ** -11 and float(y[7]) == 0.0
    z = torch.randn(10000)
    rel = ((tf32_round(z) - z).abs() / z.abs()).max()
    assert 0 < float(rel) <= 2.0 ** -11
    assert torch.equal(tf32_round(tf32_round(z)), tf32_round(z))
