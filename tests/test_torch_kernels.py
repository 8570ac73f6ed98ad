"""tpucg_torch's kernel layer against tpucg's Pallas kernels (interpret mode
on the CPU): the plain versions, the dispatch, and the CUDA wrappers'
argument checks, which run before anything is launched."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from tpucg.kernels.blas1 import dot_pallas, fused_update_pallas
from tpucg.kernels.matvec import matvec_pallas
from tpucg_torch.bench.timing import BenchReport, Timing, hbm_peak_bytes_per_s, time_fn
from tpucg_torch.kernels import dispatch
from tpucg_torch.kernels.blas1 import (
    dot_cuda,
    dot_torch,
    fused_update,
    fused_update_cuda,
    fused_update_torch,
)
from tpucg_torch.kernels.matvec import matvec, matvec_cuda, matvec_torch


@pytest.mark.parametrize("shape", [(128, 128), (256, 512), (512, 1024)])
def test_matvec_torch_matches_pallas(shape):
    rng = np.random.default_rng(0)
    A = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(matvec_pallas(jnp.asarray(A), jnp.asarray(x)))
    got = matvec_torch(torch.from_numpy(A), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_matvec_torch_bf16_matches_pallas():
    n = 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(matvec_pallas(jnp.asarray(A, jnp.bfloat16), jnp.asarray(x)))
    # Both round f32 -> bf16 to nearest even, so the stored A is the same.
    got = matvec_torch(torch.from_numpy(A).to(torch.bfloat16), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_fused_update_torch_matches_pallas():
    n = 512
    rng = np.random.default_rng(3)
    x, r, p, ap = (rng.standard_normal(n).astype(np.float32) for _ in range(4))
    alpha = np.float32(0.37)
    xj, rj, bj = fused_update_pallas(
        *(jnp.asarray(v) for v in (x, r, p, ap)), jnp.float32(alpha)
    )
    xt, rt, bt = fused_update_torch(
        *(torch.from_numpy(v) for v in (x, r, p, ap)), torch.tensor(alpha)
    )
    # The kernel may fuse multiply-add (one rounding) where torch rounds twice.
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-5)


@pytest.mark.parametrize("n", [128, 1024])
def test_dot_torch_matches_pallas(n):
    rng = np.random.default_rng(2)
    u = rng.standard_normal(n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    want = float(dot_pallas(jnp.asarray(u), jnp.asarray(v)))
    got = float(dot_torch(torch.from_numpy(u), torch.from_numpy(v)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_dispatch_takes_plain_version_for_cpu_tensors():
    A = torch.ones(128, 128)
    x = torch.ones(128)
    counts = (matvec_torch.launches, fused_update_torch.launches)
    cuda_counts = (matvec_cuda.launches, fused_update_cuda.launches)
    assert float(matvec(A, x)[0]) == 128.0
    xn, rn, beta = fused_update(x, x, x, x, torch.tensor(0.5))
    assert float(xn[0]) == 1.5 and float(rn[0]) == 0.5 and float(beta) == 32.0
    after = (matvec_torch.launches, fused_update_torch.launches)
    assert [b - a for a, b in zip(counts, after)] == [1, 1]
    assert (matvec_cuda.launches, fused_update_cuda.launches) == cuda_counts


def test_backend_cuda_on_cpu_tensor_raises():
    x = torch.ones(128)
    with pytest.raises(RuntimeError, match="CUDA"):
        matvec(torch.ones(128, 128), x, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_update(x, x, x, x, torch.tensor(0.5), backend="cuda")


def _misaligned(rows, cols):
    base = torch.zeros(rows * cols + 1)
    return base[1:].view(rows, cols)  # 4 bytes past a 16-byte boundary


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda: (torch.zeros(128, 12), torch.zeros(12)), "cols % 8"),
        (lambda: (torch.zeros(0, 128), torch.zeros(128)), "rows > 0"),
        (lambda: (torch.zeros(128, 128, dtype=torch.float64), torch.zeros(128)), "f32/bf16"),
        (lambda: (torch.zeros(128, 128), torch.zeros(128, dtype=torch.float64)), "f32 x"),
        (lambda: (torch.zeros(128, 128), torch.zeros(64)), r"\(cols,\)"),
        (lambda: (torch.zeros(128, 256)[:, :128], torch.zeros(128)), "contiguous"),
        (lambda: (_misaligned(128, 128), torch.zeros(128)), "aligned"),
        (lambda: (torch.zeros(128, 128), torch.zeros(128)), "CUDA device"),
    ],
)
def test_matvec_cuda_rejects(make, match):
    A, x = make()
    with pytest.raises(ValueError, match=match):
        matvec_cuda(A, x)


@pytest.mark.parametrize(
    "vs, match",
    [
        ((torch.zeros(128), torch.zeros(64)), "one length"),
        ((torch.zeros(128), torch.zeros(128, dtype=torch.float64)), "f32"),
        ((torch.zeros(0), torch.zeros(0)), "non-empty"),
        ((torch.zeros(256)[::2], torch.zeros(128)), "contiguous"),
        ((torch.zeros(128), torch.zeros(128)), "CUDA device"),
    ],
)
def test_blas1_cuda_rejects(vs, match):
    with pytest.raises(ValueError, match=match):
        dot_cuda(*vs)
    with pytest.raises(ValueError, match=match):
        fused_update_cuda(vs[0], vs[1], vs[0], vs[1], torch.tensor(0.5))


def test_resolve_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dispatch.resolve_backend("auto") == "torch"
    assert dispatch.resolve_backend("torch") == "torch"
    assert dispatch.resolve_backend("auto", "cuda") == "cuda"
    assert dispatch.resolve_backend("auto", "cpu") == "torch"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.resolve_backend("cuda")
    with pytest.raises(RuntimeError, match="device is cpu"):
        dispatch.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError):
        dispatch.resolve_backend("pallas")
    assert dispatch.canonical_device("cpu") == torch.device("cpu")
    assert dispatch.canonical_device(None) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert dispatch.resolve_backend("auto") == "cuda"
    assert dispatch.canonical_device("cuda") == torch.device("cuda", 0)
    assert dispatch.canonical_device(None) == torch.device("cuda", 0)


def test_hbm_peak_by_card_name():
    assert hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert hbm_peak_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert hbm_peak_bytes_per_s("NVIDIA H100 NVL") == 3.9e12
    with pytest.raises(ValueError, match="unknown card"):
        hbm_peak_bytes_per_s("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("matvec_s, above", [(100e-6, False), (50e-6, True)])
def test_bench_report_flags_rates_above_peak(matvec_s, above):
    t = Timing(matvec_s, matvec_s, matvec_s, 5)
    rep = BenchReport(
        n=8192, iterations=4, residual_norm=1e-7, distribute_s=0.1,
        solve=Timing(2e-3, 2e-3, 2e-3, 5), total_s=1.0,
        card="NVIDIA H100 80GB HBM3, 700.00 W", backend="cuda", padded_n=8192,
        matvec=t,
    ).finalize(3.35e12)
    # 8192^2 f32 is 268 MB: 100 us is 2.68 TB/s (80%), 50 us twice that.
    assert rep.above_peak is above
    assert ("ABOVE PEAK" in rep.pretty()) is above
    assert abs(rep.matvec_gbps - (8192 * 8192 * 4 + 8 * 8192) / matvec_s / 1e9) < 1e-6


def test_time_fn_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_fn(lambda: None)
