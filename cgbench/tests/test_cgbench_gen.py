"""The frozen copies under cgbench/ against the program's originals, at this
commit: the FEM generator, the dense construction, the byte arithmetic and
the peak table. (These tests import the program; the harness's reference
does not.)"""

import numpy as np
import pytest
import torch

from cgbench import traffic
from cgbench.gen.fem_p1 import fem_p1_csr
from cgbench.gen.ref_dense import dense_spd
from cgbench.roofline import dense_product_bytes, peaks, product_flops, sparse_product_bytes
from tpucg_torch.bench import timing
from tpucg_torch.io.generator import fem_p1_system


@pytest.mark.parametrize("n_points,seed", [(300, 0), (2000, 0), (2000, 7), (5000, 2**31 + 5)])
def test_fem_copy_gives_the_programs_arrays(n_points, seed):
    A, _, _ = fem_p1_system(n_points, seed=seed)
    indptr, indices, data, n = fem_p1_csr(n_points, seed)
    assert n == A.shape[0] == A.shape[1]
    assert indptr.dtype == A.indptr.dtype and np.array_equal(indptr, A.indptr)
    assert indices.dtype == A.indices.dtype and np.array_equal(indices, A.indices)
    assert data.dtype == A.data.dtype and np.array_equal(data, A.data)


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 2**31 + 11), (513, 3)])
def test_dense_keeps_the_references_construction(n, seed):
    A = dense_spd(n, traffic.generator_for(seed, "matrix", "cpu"), "cpu")
    assert A.dtype == torch.float32 and A.shape == (n, n)
    assert torch.equal(A, A.T)
    d = torch.diagonal(A)
    assert bool(((d >= n) & (d < n + 1)).all())
    off = A[~torch.eye(n, dtype=torch.bool)]
    assert bool(((off >= 0) & (off < 1)).all())
    assert off.std() > 0.1  # (R + R^T) / 2 of uniforms: spread, not constant
    again = dense_spd(n, traffic.generator_for(seed, "matrix", "cpu"), "cpu")
    assert torch.equal(A, again)
    other = dense_spd(n, traffic.generator_for(seed + 1, "matrix", "cpu"), "cpu")
    assert not torch.equal(A, other)


@pytest.mark.parametrize("n,nnz", [(8192, 8192 * 8192), (299_964, 2_098_000), (1000, 1)])
def test_bytes_equal_the_programs_counts(n, nnz):
    assert dense_product_bytes(n, 1) == timing.gemv_bytes(n, n, 4)
    assert sparse_product_bytes(n, nnz, 1) == timing.csr_spmv_bytes(nnz, n)
    assert sparse_product_bytes(n, nnz, 1) == timing.well_spmv_bytes(nnz, 4, n)
    for k in (1, 3, 8, 16, 32):
        # tpucg_torch/bench/k13_multi_ab.py's count of a k-column WELL product
        assert sparse_product_bytes(n, nnz, k) == nnz * (4 + 4) + 4 * (n + 1) + 8 * n * k
        assert dense_product_bytes(n, k) == n * n * 4 + 4 * (n * k + n * k)
        assert product_flops(nnz, k) == 2 * nnz * k


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "H100 NVL"])
def test_peaks_equal_the_programs_table(name):
    assert peaks(name)[0] == timing.hbm_peak_bytes_per_s(name)
    with pytest.raises(ValueError):
        peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3, 2**40, -5])
def test_traffic_is_a_function_of_the_seed(seed):
    wl = {"k": 8, "rhs": {"draw": "normal", "pool": 16}}
    a = traffic.rhs_pool(wl, 100, seed, "cpu")
    b = traffic.rhs_pool(wl, 100, seed, "cpu")
    c = traffic.rhs_pool(wl, 100, seed + 1, "cpu")
    assert a.shape == (100, 16) and torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= traffic.seed_words(seed, "rhs") < 2**63
    u = traffic.rhs_pool({"k": 1, "rhs": {"draw": "uniform", "pool": 4}}, 50, seed, "cpu")
    assert bool(((u >= 0) & (u < 1)).all())


def test_every_call_sends_the_same_pattern():
    assert traffic.call_columns(0, 8, 64) == list(range(8))
    assert traffic.call_columns(8, 8, 64) == list(range(8))
    assert traffic.call_columns(3, 16, 64) == list(range(48, 64))
    assert traffic.tolerance({"tol": {"rule": "absolute", "value": 1e-6}}, [3.0]) == 1e-6
    assert traffic.tolerance({"tol": {"rule": "relative_b", "value": 1e-5}},
                             [4.0, 2.0]) == pytest.approx(2e-5)
