"""tpucg_torch's 7-point stencil (K8's plain version, ``PoissonOperator``)
against tpucg on the CPU: ``poisson3d_pallas`` in interpret mode on the
lane-tileable grids, ``PoissonOperator._matvec_xla`` on one that is not
(m = 10), and the CSR form. K8 itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from tpucg.kernels.stencil import poisson3d_pallas
from tpucg.solver.operators import PoissonOperator as JPoissonOperator
from tpucg_torch.interop import poisson_operator
from tpucg_torch.io.generator import poisson3d_csr
from tpucg_torch.kernels.stencil import (
    STENCIL_MAX_M,
    poisson3d,
    poisson3d_torch,
    stencil_supported,
)
from tpucg_torch.solver.operators import PoissonOperator

CPU = torch.device("cpu")


def _u(m, seed=0):
    return np.random.default_rng(seed).standard_normal(m ** 3).astype(np.float32)


@pytest.mark.parametrize("m", [16, 32])
def test_plain_stencil_matches_tpucg_pallas(m):
    # Bit equality was expected (6 u, then the six neighbours in
    # stencil_apply's order) and is not met: XLA:CPU rounds tpucg's Pallas
    # body in interpret mode otherwise on ~16% of the points (measured, up
    # to 3.8e-6 absolute). So it is held to 1e-6 of 6|u| + sum |neighbours|
    # per point; tpucg's concat form (below, and m = 16 and 32 here) is met
    # bit for bit.
    u = _u(m, seed=m)
    got = poisson3d_torch(torch.from_numpy(u), m).numpy()
    scale = 12 * np.abs(u) - poisson3d_torch(torch.from_numpy(np.abs(u)), m).numpy()
    pallas = np.asarray(poisson3d_pallas(jnp.asarray(u), m))
    assert np.all(np.abs(got - pallas) <= 1e-6 * scale)
    np.testing.assert_array_equal(got, np.asarray(JPoissonOperator(m=m)._matvec_xla(
        jnp.asarray(u))))


@pytest.mark.parametrize("m", [2, 3, 10])
def test_plain_stencil_equals_tpucg_xla_form(m):
    # m = 10 is not lane-tileable ((m*m) % 128 != 0): tpucg runs its concat
    # form there, and the port's K8 takes any m >= 2.
    u = _u(m, seed=m)
    got = poisson3d_torch(torch.from_numpy(u), m).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPoissonOperator(m=m)._matvec_xla(
        jnp.asarray(u))))


@pytest.mark.parametrize("m", [4, 10])
def test_stencil_is_the_csr_operator(m):
    u = _u(m, seed=1)
    want = poisson3d_csr(m).matvec(u.astype(np.float64))
    got = PoissonOperator(m, device=CPU).matvec(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_poisson_operator_surface():
    op = PoissonOperator(10, device=CPU)
    assert (op.n, op.padded_n, op.backend, op.device) == (1000, 1000, "torch", CPU)
    assert torch.equal(op.diagonal(), torch.full((1000,), 6.0))
    assert np.array_equal(np.asarray(JPoissonOperator(m=10).diagonal()), op.diagonal().numpy())
    with pytest.raises(NotImplementedError, match="M8"):
        op.diagonal_blocks(8)
    with pytest.raises(ValueError, match="2 <= m"):
        PoissonOperator(1, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoissonOperator(8, backend="cuda", device=CPU)
    assert poisson_operator(6) == PoissonOperator(6, device=CPU)


def test_stencil_dispatch_and_limits():
    u = torch.from_numpy(_u(8))
    before = poisson3d_torch.launches
    y = poisson3d(u, 8)
    assert poisson3d_torch.launches == before + 1
    assert torch.equal(y, poisson3d_torch(u, 8))
    assert stencil_supported(2) and stencil_supported(STENCIL_MAX_M)
    assert not stencil_supported(1) and not stencil_supported(STENCIL_MAX_M + 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        poisson3d(u, 8, backend="cuda")


def test_stencil_works_in_float64():
    # The plain version is dtype-generic, as tpucg's concat form is: the
    # float64 true residual of the card's checks uses it.
    u = _u(6).astype(np.float64)
    got = poisson3d_torch(torch.from_numpy(u), 6).numpy()
    np.testing.assert_allclose(got, poisson3d_csr(6, dtype=np.float64).matvec(u), rtol=1e-12,
                               atol=1e-12)
