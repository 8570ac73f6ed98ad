"""The row-block kernels of the distributed solves against tpucg on the CPU:
K9's plain version (``poisson3d_slab_torch``) and K7's
(``dia_spmv_halo_torch``). K7 and K9 themselves run only on the card
(``tests/test_torch_cuda.py``).

- K9's plain version is tpucg's slab body (``_poisson_slab_kernel``) in K8's
  order, and equals its expressions run as XLA ops bit for bit; tpucg's XLA
  slab arm (``sharded.py:1187-1198``) subtracts the x neighbours last and
  is held, like tpucg's Pallas kernels in interpret mode (which round
  otherwise than its XLA forms, PR 3), within 1e-6 of sum |a_ij x_j|.
- K7's plain version equals tpucg's ``dia_spmv_halo_xla`` bit for bit and
  its ``dia_spmv_halo_pallas`` within 1e-6 of sum |a_ij x_j|.
- The blocks of a vector, each with its neighbours' halos, concatenate to
  the whole operator's plain product (K8's, K6's) bit for bit.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import BAND_SETS, random_banded_dia
from tpucg.kernels.spmv import dia_interleave as j_interleave
from tpucg.kernels.spmv import dia_spmv_halo_pallas, dia_spmv_halo_xla
from tpucg.kernels.stencil import _poisson_slab_kernel, poisson3d_slab_pallas
from tpucg_torch.io.generator import poisson3d_dia
from tpucg_torch.kernels.spmv import (
    dia_spmv_halo,
    dia_spmv_halo_torch,
    dia_spmv_torch,
    halo_length,
)
from tpucg_torch.kernels.stencil import (
    poisson3d_slab,
    poisson3d_slab_torch,
    poisson3d_torch,
)


class _Ref:
    """A stand-in for a Pallas ref around a jnp array: ``ref[...]`` reads
    it, ``ref[...] = v`` replaces it."""

    def __init__(self, a=None):
        self.a = a

    def __getitem__(self, idx):
        return self.a

    def __setitem__(self, idx, v):
        self.a = v


def _slab(m, mp, halos, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(mp * m * m).astype(np.float32)
    if halos == "zero":
        lo = hi = np.zeros(m * m, np.float32)
    else:
        lo, hi = (rng.standard_normal(m * m).astype(np.float32) for _ in range(2))
    return u, lo, hi


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _slab_scale(u, lo, hi, m):
    """6 |u| + sum of |neighbours| per point: 12 |u| - A|u| on the slab."""
    au, alo, ahi = _t(np.abs(u), np.abs(lo), np.abs(hi))
    return (12 * au - poisson3d_slab_torch(au, alo, ahi, m)).numpy()


@pytest.mark.parametrize("halos", ["random", "zero"])
@pytest.mark.parametrize("mp", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("m", [8, 16])
def test_plain_slab_equals_tpucgs_slab_body(m, mp, halos):
    u, lo, hi = _slab(m, mp, halos, seed=10 * m + mp)
    got = poisson3d_slab_torch(*_t(u, lo, hi), m).numpy()
    out = _Ref()
    mm = m * m
    _poisson_slab_kernel(m, _Ref(jnp.asarray(lo).reshape(1, mm)),
                         _Ref(jnp.asarray(u).reshape(mp, mm)),
                         _Ref(jnp.asarray(hi).reshape(1, mm)), out)
    np.testing.assert_array_equal(got, np.asarray(out.a).reshape(-1))


@pytest.mark.parametrize("mp", [1, 3, 5])
def test_plain_slab_matches_tpucgs_pallas_slab(mp):
    m = 16  # tpucg's slab kernel needs (m*m) % 128 == 0
    u, lo, hi = _slab(m, mp, "random", seed=mp)
    got = poisson3d_slab_torch(*_t(u, lo, hi), m).numpy()
    want = np.asarray(poisson3d_slab_pallas(jnp.asarray(u).reshape(mp, m * m),
                                            jnp.asarray(lo), jnp.asarray(hi), m)).reshape(-1)
    assert np.all(np.abs(got - want) <= 1e-6 * _slab_scale(u, lo, hi, m))


def _xla_slab_arm(u, lo, hi, m):
    """tpucg's XLA slab arm (sharded.py:1187-1198) on one slab: the y and z
    neighbours first, then the x neighbours from the extended slab."""
    u = jnp.asarray(u).reshape(-1, m, m)
    lo, hi = jnp.asarray(lo).reshape(1, m, m), jnp.asarray(hi).reshape(1, m, m)
    y = 6.0 * u
    zeros = jnp.zeros_like(u[:, :1])
    y = y - jnp.concatenate([u[:, 1:], zeros], axis=1)
    y = y - jnp.concatenate([zeros, u[:, :-1]], axis=1)
    zeros = jnp.zeros_like(u[:, :, :1])
    y = y - jnp.concatenate([u[:, :, 1:], zeros], axis=2)
    y = y - jnp.concatenate([zeros, u[:, :, :-1]], axis=2)
    u_ext = jnp.concatenate([lo, u, hi], axis=0)
    return np.asarray(y - u_ext[2:] - u_ext[:-2]).reshape(-1)


@pytest.mark.parametrize("m,mp", [(8, 1), (8, 4), (9, 3), (10, 5)])
def test_plain_slab_matches_tpucgs_xla_slab_arm(m, mp):
    u, lo, hi = _slab(m, mp, "random", seed=m + mp)
    got = poisson3d_slab_torch(*_t(u, lo, hi), m).numpy()
    want = _xla_slab_arm(u, lo, hi, m)
    assert np.all(np.abs(got - want) <= 1e-6 * _slab_scale(u, lo, hi, m))


@pytest.mark.parametrize("m,P", [(8, 1), (8, 2), (8, 4), (9, 3), (6, 6)])
def test_slabs_concatenate_to_the_whole_stencil(m, P):
    mm, mp = m * m, m // P
    u = torch.from_numpy(np.random.default_rng(m * P).standard_normal(m ** 3).astype(np.float32))
    zero = torch.zeros(mm)
    parts = []
    for r in range(P):
        lo = u[(r * mp - 1) * mm: r * mp * mm] if r > 0 else zero
        hi = u[(r + 1) * mp * mm: ((r + 1) * mp + 1) * mm] if r < P - 1 else zero
        parts.append(poisson3d_slab_torch(u[r * mp * mm:(r + 1) * mp * mm], lo, hi, m))
    assert torch.equal(torch.cat(parts), poisson3d_torch(u, m))


def test_slab_dispatch_and_checks():
    u, lo, hi = _t(*_slab(4, 2, "random"))
    before = poisson3d_slab_torch.launches
    y = poisson3d_slab(u, lo, hi, 4)
    assert poisson3d_slab_torch.launches == before + 1
    assert torch.equal(y, poisson3d_slab_torch(u, lo, hi, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        poisson3d_slab(u, lo, hi, 4, backend="cuda")
    with pytest.raises(ValueError, match="halo_hi"):
        poisson3d_slab(u, lo, hi[:-1], 4)
    with pytest.raises(ValueError, match="planes"):
        poisson3d_slab(u[:-1], lo, hi, 4)
    with pytest.raises(ValueError, match="2 <= m"):
        poisson3d_slab(u[:2], lo[:1], hi[:1], 1)


# ---- K7 -------------------------------------------------------------------------


def _dia_system(kind):
    """(offsets, canonical data (ndiag, n) f32, n): the m = 16 Poisson
    Laplacian in DIA form, or a random band crossing 128-element rows."""
    if kind == "poisson16":
        dia = poisson3d_dia(16)
        return tuple(int(o) for o in dia.offsets), np.asarray(dia.data, np.float32), 16 ** 3
    offsets, data, _ = random_banded_dia(1024, BAND_SETS["cross_row"], seed=3)
    return offsets, data, 1024


def _blocks(kind, P, storage, halos, seed=0):
    """Each rank's (slab block, x block, halo_lo, halo_hi) as NumPy, the
    halos cut from the neighbours' blocks (or zeros), and the whole x."""
    offsets, data, n = _dia_system(kind)
    pad, blk = halo_length(offsets), n // P
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if storage == "bf16":
        data = data.astype(ml_dtypes.bfloat16)
    out = []
    for r in range(P):
        zero = np.zeros(pad, np.float32)
        lo = x[r * blk - pad: r * blk] if r > 0 and halos == "neighbours" else zero
        hi = x[(r + 1) * blk:(r + 1) * blk + pad] if r < P - 1 and halos == "neighbours" \
            else zero
        out.append((np.ascontiguousarray(data[:, r * blk:(r + 1) * blk]),
                    x[r * blk:(r + 1) * blk], lo, hi))
    return offsets, out, data, x


def _torch_slab(a):
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return t.to(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 else t


@pytest.mark.parametrize("halos", ["neighbours", "zero"])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("kind", ["poisson16", "cross_row"])
def test_plain_dia_halo_equals_tpucgs_xla_form(kind, P, storage, halos):
    offsets, blocks, _, _ = _blocks(kind, P, storage, halos, seed=P)
    for data, x, lo, hi in blocks:
        got = dia_spmv_halo_torch(_torch_slab(data), offsets, *_t(x, lo, hi)).numpy()
        want = dia_spmv_halo_xla(jnp.asarray(j_interleave(data)), offsets, jnp.asarray(x),
                                 jnp.asarray(lo), jnp.asarray(hi))
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["poisson16", "cross_row"])
def test_plain_dia_halo_matches_tpucgs_pallas(kind, storage):
    offsets, blocks, _, _ = _blocks(kind, 2, storage, "neighbours", seed=7)
    for data, x, lo, hi in blocks:
        slab = _torch_slab(data)
        got = dia_spmv_halo_torch(slab, offsets, *_t(x, lo, hi)).numpy()
        scale = dia_spmv_halo_torch(slab.float().abs(), offsets,
                                    *_t(np.abs(x), np.abs(lo), np.abs(hi))).numpy()
        want = np.asarray(dia_spmv_halo_pallas(jnp.asarray(j_interleave(data)), offsets,
                                               jnp.asarray(x), jnp.asarray(lo),
                                               jnp.asarray(hi)))
        assert np.all(np.abs(got - want) <= 1e-6 * scale)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("kind,P", [("poisson16", 1), ("poisson16", 2), ("poisson16", 8),
                                    ("cross_row", 2), ("cross_row", 4)])
def test_dia_blocks_concatenate_to_the_whole_product(kind, P, storage):
    # Blocks at least as long as a halo: a rank's halo is its neighbour's
    # edge (the solve refuses a band reaching past one block).
    offsets, blocks, data, x = _blocks(kind, P, storage, "neighbours", seed=11)
    parts = [dia_spmv_halo_torch(_torch_slab(d), offsets, *_t(xb, lo, hi))
             for d, xb, lo, hi in blocks]
    whole = dia_spmv_torch(_torch_slab(data), offsets, torch.from_numpy(x))
    assert torch.equal(torch.cat(parts), whole)


def test_halo_length_is_tpucgs_and_checked():
    assert halo_length((-1, 0, 1)) == 128
    assert halo_length((-256, 0, 256)) == 256
    assert halo_length((-257, 0, 257)) == 384
    assert halo_length((0,)) == 128
    offsets, blocks, _, _ = _blocks("poisson16", 2, "f32", "neighbours")
    data, x, lo, hi = blocks[0]
    short = lo[:-128]
    with pytest.raises(ValueError, match="halos must be 256 elements"):
        dia_spmv_halo_torch(torch.from_numpy(data), offsets, *_t(x, short, hi))
    with pytest.raises(ValueError, match="halos must be 256 elements"):
        dia_spmv_halo_pallas(jnp.asarray(j_interleave(data)), offsets, jnp.asarray(x),
                             jnp.asarray(short), jnp.asarray(hi))


def test_dia_halo_dispatch():
    offsets, blocks, _, _ = _blocks("cross_row", 2, "f32", "neighbours")
    data, x, lo, hi = (torch.from_numpy(np.ascontiguousarray(a)) for a in blocks[1])
    before = dia_spmv_halo_torch.launches
    y = dia_spmv_halo(data, offsets, x, lo, hi)
    assert dia_spmv_halo_torch.launches == before + 1
    assert torch.equal(y, dia_spmv_halo_torch(data, offsets, x, lo, hi))
    with pytest.raises(RuntimeError, match="CUDA"):
        dia_spmv_halo(data, offsets, x, lo, hi, backend="cuda")
