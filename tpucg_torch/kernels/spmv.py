"""Sparse matrix-vector products.

DIA SpMV, y[i] = sum_d data[d, i] * x[i + offsets[d]] with zero fill
outside [0, n): K6 of the port, and K7, the same on one row block of a
distributed solve with the columns past the block from the neighbours'
halos; ``csrc/sparse.cu`` holds the kernels and their design note. The slab
is the canonical (ndiag, npad) layout in f32 or bf16, with f32 sums. tpucg's row-interleaved packing (``dia_interleave``) was a
TPU DMA layout; it is kept here, in NumPy, for carrying tpucg's operators
across only.

K6 x k (``dia_spmv_multi``) is the same product on the k columns of a
row-major (npad, k) block X at once, each stored value read once for all k
columns and each column summed in K6's order, so column j equals K6 on
column j bit for bit: the multi-RHS and block solves' matvec, where tpucg
vmaps its Pallas kernel.

ELLPACK (``ell_spmv``) and block-ELL (``bsr_ell_spmv``) products are plain
torch ops on any device, as tpucg computes them in XLA outside any Pallas
kernel: a gather, a product and a row sum (a batched block product for BSR).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

LANE = 128  # tpucg's lane width: the interleaved layout's block
DIA_MAX_DIAGS = 64  # K6 takes the offsets by value (tpucg's cap, spmv.py:102)


def dia_supported(n: int, offsets: Sequence[int]) -> bool:
    """The port's own limits on a DIA operator: 1 to ``DIA_MAX_DIAGS``
    diagonals and n >= 1. tpucg's lane tiling and VMEM budget
    (``spmv.py:91``) are TPU rules and do not apply."""
    return n >= 1 and 1 <= len(offsets) <= DIA_MAX_DIAGS


def offsets_array(offsets: Sequence[int]) -> np.ndarray:
    """The offsets as the contiguous int64 host array the kernels copy."""
    return np.ascontiguousarray(np.asarray(offsets, dtype=np.int64).reshape(-1))


def ell_spmv(values: torch.Tensor, indices: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k values[i, k] * x[indices[i, k]] (tpucg's ``ell_spmv``,
    ``spmv.py:23``); padded entries hold value 0 at index 0."""
    return (values.to(torch.float32) * x[indices.long()]).sum(1)


def ell_spmv_multi(values: torch.Tensor, indices: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``ell_spmv`` on the k columns of X (n, k) at once."""
    return (values.to(torch.float32)[:, :, None] * X[indices.long()]).sum(1)


def bsr_ell_spmv(values: torch.Tensor, indices: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV (tpucg's ``bsr_ell_spmv``, ``spmv.py:359``): values
    (nbr, L, bs, bs), indices (nbr, L) block-column ids, x (ncols,). Each
    block row gathers its L x-blocks and does L dense (bs x bs) products, in
    full f32 (no TF32: ``dispatch.strict_f32``)."""
    nbr, L, bs, _ = values.shape
    gathered = x.reshape(-1, bs)[indices.reshape(-1).long()].reshape(nbr, L, bs)
    return torch.einsum("rlij,rlj->ri", values.to(torch.float32), gathered).reshape(nbr * bs)


def bsr_ell_spmv_multi(values: torch.Tensor, indices: torch.Tensor,
                       X: torch.Tensor) -> torch.Tensor:
    """``bsr_ell_spmv`` on the k columns of X (ncols, k) at once."""
    nbr, L, bs, _ = values.shape
    k = X.shape[1]
    gathered = X.reshape(-1, bs, k)[indices.reshape(-1).long()].reshape(nbr, L, bs, k)
    return torch.einsum("rlij,rljc->ric", values.to(torch.float32),
                        gathered).reshape(nbr * bs, k)


def _shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """result[..., i] = x[..., i + off], 0 outside [0, n) along the last
    axis (tpucg's ``_shift_flat``)."""
    n = x.shape[-1]
    if off == 0:
        return x
    if abs(off) >= n:
        return torch.zeros_like(x)
    if off > 0:
        return torch.cat([x[..., off:], x.new_zeros(x.shape[:-1] + (off,))], -1)
    return torch.cat([x.new_zeros(x.shape[:-1] + (-off,)), x[..., : n + off]], -1)


def dia_spmv_torch(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 (tpucg's ``dia_spmv``, ``spmv.py:43-56``): one
    shifted product per diagonal, added in offsets order from zero; bf16
    slabs widened to f32."""
    dia_spmv_torch.launches += 1
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + data[d].to(torch.float32) * _shift(x, int(off))
    return y


dia_spmv_torch.launches = 0


def batch_dia_spmv_torch(data: torch.Tensor, offsets: Sequence[int],
                         x: torch.Tensor) -> torch.Tensor:
    """The plain DIA SpMV of B systems at once: ``data`` (B, ndiag, n), x
    (B, n); each system's sum is ``dia_spmv_torch``'s, in the same order."""
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + data[:, d].to(torch.float32) * _shift(x, int(off))
    return y


def check_dia(data: torch.Tensor, offsets: Sequence[int], x: Optional[torch.Tensor] = None) -> None:
    """K6's operands, as ``dia_spmv_cuda`` checks them before a launch; with
    no ``x``, the slab alone."""
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dia_spmv_cuda supports f32/bf16 slabs, got {data.dtype}")
    if data.dim() != 2 or data.shape[0] != len(offsets):
        raise ValueError(
            f"dia_spmv_cuda needs a (ndiag, npad) slab for {len(offsets)} offsets, got "
            f"{tuple(data.shape)}"
        )
    if not dia_supported(data.shape[1], offsets):
        raise ValueError(
            f"dia_spmv_cuda takes 1 to {DIA_MAX_DIAGS} diagonals, got {len(offsets)}"
        )
    if not data.is_contiguous() or data.device.type != "cuda":
        raise ValueError(f"dia_spmv_cuda needs a contiguous slab on a CUDA device, got {data.device}")
    if x is not None and (
        x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] != data.shape[1]
        or not x.is_contiguous() or x.device != data.device
    ):
        raise ValueError(
            f"dia_spmv_cuda needs a contiguous f32 x of length {data.shape[1]} on "
            f"{data.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def dia_spmv_launch(data: torch.Tensor, offs: np.ndarray, x: torch.Tensor, y: torch.Tensor,
                    active: Optional[int], stream: int) -> None:
    """Launch K6, y = A x, with no checks: the caller has checked the slab
    and x as ``dia_spmv_cuda`` does and owns y; ``offs`` is
    ``offsets_array(offsets)``. The one place that counts K6's launches."""
    lib = _lib.load()
    fn = lib.tpucg_dia_spmv_f32 if data.dtype == torch.float32 else lib.tpucg_dia_spmv_bf16
    err = fn(data.data_ptr(), offs.ctypes.data, offs.size, x.data_ptr(), y.data_ptr(),
             data.shape[1], active, stream)
    if err:
        _lib.check(err, "dia_spmv_cuda")
    dia_spmv_cuda.launches += 1


def dia_spmv_cuda(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor, *,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined."""
    check_dia(data, offsets, x)
    check_active(active, data)
    y = torch.empty_like(x)
    dia_spmv_launch(data, offsets_array(offsets), x, y,
                    None if active is None else active.data_ptr(), cuda_stream(x))
    return y


dia_spmv_cuda.launches = 0


def dia_spmv(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor, backend: str = "auto",
             active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DIA SpMV: K6 for a CUDA slab (``"auto"``), the plain version for a
    CPU one; ``active`` is read by K6 only."""
    if resolve_backend(backend, data.device) == "cuda":
        return dia_spmv_cuda(data, offsets, x, active=active)
    return dia_spmv_torch(data, offsets, x)


def _shift_rows(X: torch.Tensor, off: int) -> torch.Tensor:
    """result[i] = X[i + off], 0 outside [0, n) along the first axis."""
    n = X.shape[0]
    if off == 0:
        return X
    if abs(off) >= n:
        return torch.zeros_like(X)
    if off > 0:
        return torch.cat([X[off:], X.new_zeros((off,) + X.shape[1:])], 0)
    return torch.cat([X.new_zeros((-off,) + X.shape[1:]), X[: n + off]], 0)


def dia_spmv_multi_torch(data: torch.Tensor, offsets: Sequence[int],
                         X: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 x k: ``dia_spmv_torch`` on the k columns of X
    (npad, k) at once, the same products added in the same order, so column
    j equals ``dia_spmv_torch`` on column j bit for bit."""
    dia_spmv_multi_torch.launches += 1
    Y = torch.zeros_like(X)
    for d, off in enumerate(offsets):
        Y = Y + data[d].to(torch.float32)[:, None] * _shift_rows(X, int(off))
    return Y


dia_spmv_multi_torch.launches = 0


def check_block(what: str, X: torch.Tensor, rows: int, device: torch.device) -> None:
    """A k-column kernel's X: a contiguous f32 (rows, k) block, k >= 1, on
    ``device``."""
    if (X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != rows or X.shape[1] < 1
            or not X.is_contiguous() or X.device != device):
        raise ValueError(f"{what} needs a contiguous f32 ({rows}, k) block on {device}, got "
                         f"{X.dtype} {tuple(X.shape)} on {X.device}")


def dia_spmv_multi_launch(data: torch.Tensor, offs: np.ndarray, X: torch.Tensor,
                          Y: torch.Tensor, active: Optional[int], stream: int) -> None:
    """Launch K6 x k, Y = A X, with no checks: the caller has checked the
    slab and X as ``dia_spmv_multi_cuda`` does and owns Y. The one place
    that counts K6 x k's launches."""
    lib = _lib.load()
    fn = (lib.tpucg_dia_spmv_multi_f32 if data.dtype == torch.float32
          else lib.tpucg_dia_spmv_multi_bf16)
    err = fn(data.data_ptr(), offs.ctypes.data, offs.size, X.data_ptr(), Y.data_ptr(),
             data.shape[1], X.shape[1], active, stream)
    if err:
        _lib.check(err, "dia_spmv_multi_cuda")
    dia_spmv_multi_cuda.launches += 1


def dia_spmv_multi_cuda(data: torch.Tensor, offsets: Sequence[int], X: torch.Tensor, *,
                        active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 x k on the card: Y (npad, k) = A X. With ``active`` (0-d int32 on
    the device) the kernel does nothing when the flag is 0, and the
    returned block is undefined."""
    check_dia(data, offsets)
    check_block("dia_spmv_multi_cuda", X, data.shape[1], data.device)
    check_active(active, data)
    Y = torch.empty_like(X)
    dia_spmv_multi_launch(data, offsets_array(offsets), X, Y,
                          None if active is None else active.data_ptr(), cuda_stream(X))
    return Y


dia_spmv_multi_cuda.launches = 0


def dia_spmv_multi(data: torch.Tensor, offsets: Sequence[int], X: torch.Tensor,
                   backend: str = "auto", active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k-column DIA SpMV: K6 x k for a CUDA slab (``"auto"``), the plain
    version for a CPU one; ``active`` is read by the kernel only."""
    if resolve_backend(backend, data.device) == "cuda":
        return dia_spmv_multi_cuda(data, offsets, X, active=active)
    return dia_spmv_multi_torch(data, offsets, X)


# K7: K6 on one rank's row block of a distributed banded solve. The block's
# rows reach up to max |offset| columns past either end; those come from the
# neighbouring ranks' halos, ``halo_length(offsets)`` elements each: the
# last of the rank below (halo_lo) and the first of the rank above
# (halo_hi), zeros at the ends of the chain.


def halo_length(offsets: Sequence[int]) -> int:
    """Elements of each halo of a DIA row block: max |offset| rounded up to
    a multiple of 128, at least 128 (tpucg's ``spmv.py:294-300``)."""
    maxo = max(abs(int(o)) for o in offsets)
    return max(1, -(-maxo // LANE)) * LANE


def _check_halos(offsets: Sequence[int], halo_lo: torch.Tensor, halo_hi: torch.Tensor) -> int:
    pad = halo_length(offsets)
    if halo_lo.dim() != 1 or halo_hi.dim() != 1 or halo_lo.numel() != pad \
            or halo_hi.numel() != pad:
        raise ValueError(f"halos must be {pad} elements, got "
                         f"{halo_lo.numel()}/{halo_hi.numel()}")
    return pad


def dia_spmv_halo_torch(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor,
                        halo_lo: torch.Tensor, halo_hi: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (tpucg's ``dia_spmv_halo_xla``, ``spmv.py:336``,
    on the canonical slab): x extended by the halos once, then one slice and
    product per diagonal, added in offsets order from zero; bf16 slabs
    widened to f32."""
    dia_spmv_halo_torch.launches += 1
    pad = _check_halos(offsets, halo_lo, halo_hi)
    blk = x.shape[0]
    x_ext = torch.cat([halo_lo, x, halo_hi])
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + data[d].to(torch.float32) * x_ext[pad + int(off): pad + int(off) + blk]
    return y


dia_spmv_halo_torch.launches = 0


def dia_spmv_halo_launch(data: torch.Tensor, offs: np.ndarray, x: torch.Tensor,
                         halo_lo: torch.Tensor, halo_hi: torch.Tensor, y: torch.Tensor,
                         active: Optional[int], stream: int) -> None:
    """Launch K7 with no checks: the caller has checked the operands as
    ``dia_spmv_halo_cuda`` does and owns y; ``offs`` is
    ``offsets_array(offsets)``. The one place that counts K7's launches."""
    lib = _lib.load()
    fn = lib.tpucg_dia_spmv_halo_f32 if data.dtype == torch.float32 else lib.tpucg_dia_spmv_halo_bf16
    err = fn(data.data_ptr(), offs.ctypes.data, offs.size, x.data_ptr(), halo_lo.data_ptr(),
             halo_hi.data_ptr(), y.data_ptr(), data.shape[1], halo_lo.numel(), active, stream)
    if err:
        _lib.check(err, "dia_spmv_halo_cuda")
    dia_spmv_halo_cuda.launches += 1


def check_dia_halo(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor,
                   halo_lo: torch.Tensor, halo_hi: torch.Tensor) -> None:
    """K7's operands, as ``dia_spmv_halo_cuda`` checks them: K6's slab and x,
    and two contiguous f32 halos of ``halo_length(offsets)`` on x's
    device."""
    check_dia(data, offsets, x)
    _check_halos(offsets, halo_lo, halo_hi)
    for h in (halo_lo, halo_hi):
        if h.dtype != torch.float32 or not h.is_contiguous() or h.device != x.device:
            raise ValueError(f"dia_spmv_halo_cuda needs contiguous f32 halos on {x.device}, "
                             f"got {h.dtype} on {h.device}")


def dia_spmv_halo_cuda(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor,
                       halo_lo: torch.Tensor, halo_hi: torch.Tensor, *,
                       active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 on the card. With ``active`` (0-d int32 on the device) the kernel
    does nothing when the flag is 0, and the returned vector is undefined."""
    check_dia_halo(data, offsets, x, halo_lo, halo_hi)
    check_active(active, data)
    y = torch.empty_like(x)
    dia_spmv_halo_launch(data, offsets_array(offsets), x, halo_lo, halo_hi, y,
                         None if active is None else active.data_ptr(), cuda_stream(x))
    return y


dia_spmv_halo_cuda.launches = 0


def dia_spmv_halo(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor,
                  halo_lo: torch.Tensor, halo_hi: torch.Tensor, backend: str = "auto",
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DIA row-block SpMV with halos: K7 for a CUDA slab (``"auto"``),
    the plain version for a CPU one; ``active`` is read by K7 only."""
    if resolve_backend(backend, data.device) == "cuda":
        return dia_spmv_halo_cuda(data, offsets, x, halo_lo, halo_hi, active=active)
    return dia_spmv_halo_torch(data, offsets, x, halo_lo, halo_hi)


def dia_interleave(data) -> np.ndarray:
    """tpucg's (n//128, ndiag*128) packing of an (ndiag, n) slab: row r holds
    diagonal d's lanes at columns [d*128, (d+1)*128) (``spmv.py:105``)."""
    data = np.asarray(data)
    ndiag, n = data.shape
    rows = n // LANE
    return np.ascontiguousarray(
        np.transpose(data.reshape(ndiag, rows, LANE), (1, 0, 2)).reshape(rows, ndiag * LANE)
    )


def dia_deinterleave(data_il) -> np.ndarray:
    """Inverse of ``dia_interleave``: (n//128, ndiag*128) back to the
    canonical (ndiag, n) (``spmv.py:120``)."""
    data_il = np.asarray(data_il)
    rows = data_il.shape[0]
    ndiag = data_il.shape[1] // LANE
    return np.ascontiguousarray(
        np.transpose(data_il.reshape(rows, ndiag, LANE), (1, 0, 2)).reshape(ndiag, rows * LANE)
    )
