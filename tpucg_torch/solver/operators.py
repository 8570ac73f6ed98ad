"""Linear operators: what CG needs of A (the counterpart of
``tpucg.solver.operators``).

A ``DenseOperator`` pads once at construction with an identity tail to a
multiple of 128 (``MATVEC_ALIGN``) on every backend, so its ``padded_n``
equals tpucg's ``DenseOperator.create(..., backend="pallas")`` and the hot
matvec never pads again. A ``DiaOperator`` holds a banded matrix's (ndiag,
npad) slab (K6), padded as tpucg's ``DiaOperator.from_dia`` pads it; a
``PoissonOperator`` applies the 3-D 7-point Laplacian as a stencil (K8),
with no stored matrix. A ``WellOperator`` holds an irregular matrix in
tpucg's WELL packing (K13). ``BsrOperator`` (block-ELL) and ``EllOperator``
(ELLPACK) compute their products with plain torch ops on either device, as
tpucg computes them in XLA: tpucg has no Pallas kernel for them, so none is
owed. ``best_sparse_operator`` picks among DIA, BSR, WELL and ELL as tpucg's
does.

Each operator's ``launcher()`` checks its stored operands once and returns
its matvec's launch core, ``launch(x, y, active, stream)``, which the CUDA
lap (``cg._cuda_lap_ops``) calls every lap.

``matvec_multi(X)`` applies the operator to the k columns of a row-major
(padded_n, k) f32 block at once, for the multi-RHS and block solves: K6 x
k, K8 x k and K13 x k for the DIA, Poisson and WELL operators on the card
(their plain versions on the CPU), each column bit for bit the
single-column kernel's; ``torch.matmul`` for a dense A, as tpucg runs that
GEMM in XLA; plain products for ELL and BSR.

A float64 solve (``CGConfig(dtype=torch.float64)``) reaches no kernel, as
in tpucg: ``DenseOperator.create(dtype=torch.float64)`` stores A in f64 on
the ``"torch"`` backend, and every operator's ``matvec`` takes its plain
product for a vector that is not f32 (a DIA slab or WELL values stay f32
and widen exactly).

``diagonal_blocks(bs)`` gives block Jacobi its (nb, bs, bs) diagonal blocks
where the format stores them addressably, as tpucg's operators do: dense,
DIA and Poisson extract theirs, a ``WellOperator`` carries the blocks taken
from its source CSR at construction (``from_csr(pc_block_size=)``), and
ELL and BSR refuse with tpucg's message.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.io.partitioner import pad_identity_tail, round_up
from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
from tpucg_torch.kernels.gather_spmv import (
    WellRows,
    check_well,
    check_well_values,
    well_rows,
    well_spmv_cuda,
    well_spmv_launch,
    well_spmv_multi,
    well_spmv_torch,
)
from tpucg_torch.kernels.matvec import (
    MATVEC_ALIGN,
    check_matvec,
    gemv_launch,
    matvec,
    matvec_torch,
)
from tpucg_torch.kernels.spmv import (
    LANE,
    bsr_ell_spmv,
    bsr_ell_spmv_multi,
    check_dia,
    dia_spmv,
    dia_spmv_launch,
    dia_spmv_multi,
    dia_spmv_torch,
    ell_spmv,
    ell_spmv_multi,
    offsets_array,
)
from tpucg_torch.kernels.stencil import (
    STENCIL_MAX_M,
    poisson3d,
    poisson3d_launch,
    poisson3d_multi,
    poisson3d_torch,
    stencil_supported,
)

def padded_size(n: int) -> int:
    """The device-side size of an n x n dense operator."""
    return round_up(n, int(np.lcm(*MATVEC_ALIGN)))


class LinearOperator:
    """Abstract SPD operator: ``matvec`` and the logical size ``n``."""

    n: int

    @property
    def padded_n(self) -> int:
        """Device-side vector length (>= n)."""
        return self.n

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ X for X (padded_n, k), the multi-RHS and block solves'
        batched matvec; ``active`` is the k-column kernel's flag."""
        raise NotImplementedError

    def diagonal(self) -> torch.Tensor:
        """diag(A), padded length, for the Jacobi preconditioner."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a diagonal; "
            "precondition='jacobi' is unavailable for it"
        )

    def diagonal_blocks(self, bs: int) -> torch.Tensor:
        """The (ceil(padded_n/bs), bs, bs) diagonal blocks of A, for block
        Jacobi; rows past padded_n (when bs does not divide it) are
        identity. Only formats that store their diagonal-block entries
        addressably implement it (probing with strided basis vectors would
        alias off-block entries)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose diagonal blocks; "
            "precondition='block_jacobi' is unavailable for it"
        )

    def launcher(self) -> Callable:
        """Check the stored operands once and return the kernel's launch core
        ``launch(x, y, active, stream)`` (cuda backend only)."""
        raise NotImplementedError(f"{type(self).__name__} has no CUDA lap kernel")


def _blocks_from_diag_data(offsets, data: torch.Tensor, bs: int) -> torch.Tensor:
    """(nb, bs, bs) diagonal blocks from canonical DIA storage ``data[d, i] =
    A[i, i + offsets[d]]`` (ndiag, N), as tpucg assembles them: an entry
    lands in a block iff its row and column share the block, so offsets
    with |off| >= bs never contribute; rows in the bs-alignment tail (>= N)
    get identity. bf16 storage is widened to f32."""
    N = data.shape[1]
    nb = -(-N // bs)
    data = data.to(torch.float32)
    if nb * bs != N:
        data = F.pad(data, (0, nb * bs - N))
    blocks = torch.zeros((nb, bs, bs), dtype=torch.float32, device=data.device)
    for d, off in enumerate(int(o) for o in offsets):
        if abs(off) >= bs:
            continue
        rs = torch.arange(max(0, -off), bs - max(0, off), device=data.device)
        blocks[:, rs, rs + off] = data[d].reshape(nb, bs)[:, rs]
    if nb * bs != N:
        tail = torch.arange(nb * bs, device=data.device).reshape(nb, bs) >= N
        eye = torch.eye(bs, dtype=torch.float32, device=data.device)
        blocks = (torch.where(tail[:, :, None] | tail[:, None, :], 0.0, blocks)
                  + eye[None] * tail[:, :, None])
    return blocks


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense SPD matrix, padded with an identity tail, stored f32 or bf16.

    ``backend`` resolves against A's device when the operator is made:
    ``"auto"`` is ``"cuda"`` for a CUDA tensor and ``"torch"`` otherwise, and
    ``"cuda"`` for a CPU tensor raises. A float64 A takes ``"torch"`` on
    any device (tpucg forces its f64 operators onto XLA): no kernel is
    f64, so ``"cuda"`` with an f64 A raises."""

    A: torch.Tensor
    n: int
    backend: str = "auto"

    def __post_init__(self):
        backend = self.backend
        if self.A.dtype == torch.float64:
            if backend == "cuda":
                raise ValueError("a float64 DenseOperator has no CUDA kernel (K1 is f32/bf16): "
                                 "use backend 'torch' or 'auto'")
            backend = "torch"
        object.__setattr__(self, "backend", resolve_backend(backend, self.A.device))

    @classmethod
    def create(cls, A, backend: str = "auto", dtype=torch.float32, device=None) -> "DenseOperator":
        """``dtype`` is the device storage dtype of A: float32 (the reference
        contract), bfloat16 (half the bytes per matvec, f32 accumulation) or
        float64 (for f64 solves, on the ``"torch"`` backend). ``device``
        defaults to A's device for a tensor, else the card when there is
        one; ``backend`` resolves against it."""
        if dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"storage dtype must be float32, bfloat16 or float64, got {dtype}")
        host = np.float64 if dtype == torch.float64 else np.float32
        if isinstance(A, torch.Tensor):
            device = A.device if device is None else device
            A = A.detach().to("cpu", torch.float64 if host is np.float64 else torch.float32)
            A = A.numpy()
        device = canonical_device(device)
        A = np.asarray(A, dtype=host)
        n = A.shape[0]
        if A.shape != (n, n):
            raise ValueError(f"A must be square, got {A.shape}")
        A = pad_identity_tail(A, padded_size(n))
        return cls(A=torch.from_numpy(A).to(device=device, dtype=dtype), n=n, backend=backend)

    @property
    def padded_n(self) -> int:
        return self.A.shape[0]

    @property
    def device(self) -> torch.device:
        return self.A.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x; ``active`` is the CUDA kernel's lap flag (see matvec_cuda).
        A vector that is not f32 takes the plain product."""
        if x.dtype != torch.float32:
            return matvec_torch(self.A, x)
        return matvec(self.A, x, backend=self.backend, active=active)

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ X by ``torch.matmul`` (tpucg's XLA GEMM; TF32 off), bf16 A
        widened as ``matvec_torch`` widens it."""
        return torch.matmul(self.A.to(torch.promote_types(self.A.dtype, X.dtype)), X)

    def diagonal(self) -> torch.Tensor:
        # The identity tail gives 1.0 there, safe to invert; bf16 widened,
        # f64 kept.
        return torch.diagonal(self.A).to(torch.promote_types(self.A.dtype, torch.float32))

    def diagonal_blocks(self, bs: int) -> torch.Tensor:
        # One gather of (nb, bs, bs) entries; tail indices (bs not dividing
        # padded_n) clamp, are zeroed by the validity mask and take identity
        # diagonals.
        N, dev = self.padded_n, self.device
        nb = -(-N // bs)
        idx = torch.arange(nb * bs, device=dev)
        valid = (idx < N).reshape(nb, bs)
        idxc = idx.clamp(max=N - 1).reshape(nb, bs)
        dt = torch.promote_types(self.A.dtype, torch.float32)
        blocks = self.A[idxc[:, :, None], idxc[:, None, :]].to(dt)
        blocks = torch.where(valid[:, :, None] & valid[:, None, :], blocks, 0.0)
        return blocks + torch.eye(bs, dtype=dt, device=dev)[None] * (~valid[:, :, None])

    def launcher(self) -> Callable:
        A = self.A
        check_matvec(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"the CG lap needs a square A, got {tuple(A.shape)}")
        return lambda x, y, active, stream: gemv_launch(A, x, y, active, stream)


@dataclasses.dataclass(frozen=True)
class DiaOperator(LinearOperator):
    """Banded operator in DIA form: the (ndiag, npad) slab ``data`` (f32 or
    bf16, ``data[d, i] = A[i, i + offsets[d]]``) and its ``offsets``.

    ``from_dia`` pads as tpucg's ``DiaOperator.from_dia`` does: to a multiple
    of 128 with an identity tail on the main diagonal, and only when 0 is
    among the offsets (else the logical n stays), so ``padded_n`` is
    tpucg's. The slab stays in the canonical layout: tpucg's row-interleaved
    packing is a TPU DMA layout (``interop.dia_operator_from_numpy`` carries
    a packed tpucg operator across). ``backend`` resolves against the slab's
    device as ``DenseOperator``'s does."""

    data: torch.Tensor
    offsets: Sequence[int]
    n: int
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "offsets", tuple(int(o) for o in self.offsets))
        object.__setattr__(self, "backend", resolve_backend(self.backend, self.data.device))
        if self.data.dim() != 2 or self.data.shape[0] != len(self.offsets):
            raise ValueError(
                f"DiaOperator needs a (ndiag, npad) slab for {len(self.offsets)} offsets, "
                f"got {tuple(self.data.shape)}"
            )
        if self.backend == "cuda":
            check_dia(self.data, self.offsets)

    @classmethod
    def from_dia(cls, dia, backend: str = "auto", storage_dtype=torch.float32,
                 device=None) -> "DiaOperator":
        """``dia`` is a ``DIAMatrix`` (this package's or tpucg's).
        ``storage_dtype=torch.bfloat16`` stores the slab in bf16: half the
        bytes K6 and K11 stream, f32 sums, and the solve meets the f32
        contract on the bf16-rounded system. ``device`` defaults to the card,
        which raises when there is none."""
        if storage_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
        data = np.asarray(dia.data, dtype=np.float32)
        n = int(dia.shape[0])
        offsets = tuple(int(o) for o in dia.offsets)
        npad = round_up(n, LANE)
        if npad != n and 0 in offsets:
            padded = np.zeros((data.shape[0], npad), dtype=np.float32)
            padded[:, :n] = data
            padded[offsets.index(0), n:] = 1.0  # identity tail (partitioner)
            data = padded
        t = torch.from_numpy(np.ascontiguousarray(data))
        t = t.to(device=canonical_device(device), dtype=storage_dtype)
        return cls(data=t, offsets=offsets, n=n, backend=backend)

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def padded_n(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x; ``active`` is the CUDA kernel's lap flag (see dia_spmv_cuda).
        A vector that is not f32 takes the plain product, as tpucg's does."""
        if x.dtype != torch.float32:
            return dia_spmv_torch(self.data, self.offsets, x)
        return dia_spmv(self.data, self.offsets, x, backend=self.backend, active=active)

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ X: K6 x k on the card, its plain version on the CPU."""
        return dia_spmv_multi(self.data, self.offsets, X.contiguous(), backend=self.backend,
                              active=active)

    def diagonal(self) -> torch.Tensor:
        if 0 not in self.offsets:
            return torch.zeros(self.padded_n, dtype=torch.float32, device=self.device)
        return self.data[self.offsets.index(0)].to(torch.float32)  # bf16 widened

    def diagonal_blocks(self, bs: int) -> torch.Tensor:
        # The slab is canonical (tpucg de-interleaves its packed slab first).
        return _blocks_from_diag_data(self.offsets, self.data, bs)

    def launcher(self) -> Callable:
        data = self.data
        check_dia(data, self.offsets)
        offs = offsets_array(self.offsets)
        return lambda x, y, active, stream: dia_spmv_launch(data, offs, x, y, active, stream)


@dataclasses.dataclass(frozen=True)
class PoissonOperator(LinearOperator):
    """Matrix-free 3-D 7-point Dirichlet Laplacian on an m^3 grid: the same
    operator as ``poisson3d_csr(m)``, applied as 6 u minus the in-grid
    neighbours, with no stored matrix. n = padded_n = m^3. ``device``
    defaults to the card, which raises when there is none; ``backend``
    resolves against it (tpucg's ``kernel`` field)."""

    m: int
    backend: str = "auto"
    device: Optional[torch.device] = None

    def __post_init__(self):
        device = canonical_device(self.device)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "backend", resolve_backend(self.backend, device))
        if not stencil_supported(self.m):
            raise ValueError(f"PoissonOperator needs 2 <= m <= {STENCIL_MAX_M}, got m={self.m}")

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.m ** 3

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x; ``active`` is the CUDA kernel's lap flag (see poisson3d_cuda).
        A vector that is not f32 takes the plain product, as tpucg's does."""
        if x.dtype != torch.float32:
            return poisson3d_torch(x, self.m)
        return poisson3d(x, self.m, backend=self.backend, active=active)

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ X: K8 x k on the card, its plain version on the CPU."""
        return poisson3d_multi(X.contiguous(), self.m, backend=self.backend, active=active)

    def diagonal(self) -> torch.Tensor:
        return torch.full((self.n,), 6.0, dtype=torch.float32, device=self.device)

    def diagonal_blocks(self, bs: int) -> torch.Tensor:
        # The stencil's offsets are +-1 (x, broken at each x-line end), +-m (y,
        # broken at slab ends) and +-m^2 (z): their DIA rows with the grid's
        # boundary masks, assembled like any banded operator's.
        m, N = self.m, self.n
        i = torch.arange(N, device=self.device)
        offsets, rows = [0], [torch.full((N,), 6.0, dtype=torch.float32, device=self.device)]
        for off, ok_fwd in ((1, (i % m) != m - 1), (m, ((i // m) % m) != m - 1),
                            (m * m, (i // (m * m)) != m - 1)):
            if off >= bs:
                continue  # never lands inside a bs-block
            fwd = torch.where(ok_fwd & (i + off < N), -1.0, 0.0)
            bwd = torch.where((i >= off) & torch.roll(ok_fwd, off), -1.0, 0.0)
            offsets += [off, -off]
            rows += [fwd, bwd]
        return _blocks_from_diag_data(offsets, torch.stack(rows), bs)

    def launcher(self) -> Callable:
        m = self.m
        return lambda x, y, active, stream: poisson3d_launch(x, y, m, active, stream)


def _plain_launcher(product: Callable) -> Callable:
    """The launch core of an operator whose matvec is a plain torch op: the
    product is written into the lap's y buffer on the current stream (the
    lap's own); a frozen lap computes it too, and every consumer masks it."""
    return lambda x, y, active, stream: y.copy_(product(x))


@dataclasses.dataclass(frozen=True)
class EllOperator(LinearOperator):
    """ELLPACK operator (tpucg's device form of CSR): ``values`` (n, L) f32
    and ``indices`` (n, L) int32, padded entries 0 at column 0. No padding
    of n. Its product is a plain torch op on either device (tpucg's XLA
    ``ell_spmv``); ``backend`` resolves against the device, so on the card
    the lap runs K2 and K3 around it."""

    values: torch.Tensor
    indices: torch.Tensor
    n: int
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "backend", resolve_backend(self.backend, self.values.device))
        if (self.values.dim() != 2 or self.values.shape != self.indices.shape
                or self.values.shape[0] != self.n or self.indices.device != self.values.device):
            raise ValueError(
                f"EllOperator needs (n, L) values and indices on one device for n={self.n}, "
                f"got {tuple(self.values.shape)} and {tuple(self.indices.shape)}")

    @classmethod
    def from_csr(cls, csr, backend: str = "auto", device=None) -> "EllOperator":
        from tpucg_torch.sparse.formats import csr_to_ell

        return cls.from_ell(csr_to_ell(csr), backend=backend, device=device)

    @classmethod
    def from_ell(cls, ell, backend: str = "auto", device=None) -> "EllOperator":
        """``ell`` is an ``EllMatrix`` (this package's or tpucg's); ``device``
        defaults to the card, which raises when there is none."""
        device = canonical_device(device)
        return cls(values=torch.as_tensor(np.asarray(ell.values, np.float32), device=device),
                   indices=torch.as_tensor(np.asarray(ell.indices, np.int32), device=device),
                   n=int(ell.shape[0]), backend=backend)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ell_spmv(self.values, self.indices, x)

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ell_spmv_multi(self.values, self.indices, X)

    def diagonal(self) -> torch.Tensor:
        rows = torch.arange(self.n, device=self.device)[:, None]
        return torch.where(self.indices == rows, self.values, 0.0).sum(1)

    def launcher(self) -> Callable:
        values, indices = self.values, self.indices
        return _plain_launcher(lambda x: ell_spmv(values, indices, x))


@dataclasses.dataclass(frozen=True)
class BsrOperator(LinearOperator):
    """Block-ELL operator (tpucg's device form of BSR): ``values`` (nbr, L,
    bs, bs) f32, ``indices`` (nbr, L) int32 block-column ids, padded blocks
    all zero at block column 0. ``n`` may be below ``padded_n = nbr * bs``
    when the skeleton was padded with an identity tail
    (``best_sparse_operator``). Its product is a plain torch op on either
    device (tpucg's XLA ``bsr_ell_spmv``)."""

    values: torch.Tensor
    indices: torch.Tensor
    n: int
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "backend", resolve_backend(self.backend, self.values.device))
        v, i = self.values, self.indices
        if (v.dim() != 4 or v.shape[2] != v.shape[3] or tuple(i.shape) != tuple(v.shape[:2])
                or i.device != v.device or not 0 < self.n <= v.shape[0] * v.shape[2]):
            raise ValueError(
                f"BsrOperator needs (nbr, L, bs, bs) values and (nbr, L) indices on one device "
                f"covering n={self.n}, got {tuple(v.shape)} and {tuple(i.shape)}")

    @classmethod
    def from_bsr(cls, bsr, backend: str = "auto", device=None) -> "BsrOperator":
        """``bsr`` is a ``BSRMatrix`` (this package's or tpucg's), packed
        into block rows of one width as tpucg packs it."""
        bs = bsr.blocksize
        nbr = bsr.shape[0] // bs
        lengths = bsr.block_row_lengths
        L = max(1, int(lengths.max()) if nbr else 1)
        values = np.zeros((nbr, L, bs, bs), dtype=np.float32)
        indices = np.zeros((nbr, L), dtype=np.int32)
        within = np.arange(bsr.nnzb, dtype=np.int64) - np.repeat(bsr.indptr[:-1], lengths)
        rows = np.repeat(np.arange(nbr, dtype=np.int64), lengths)
        values[rows, within] = bsr.data
        indices[rows, within] = bsr.indices
        device = canonical_device(device)
        return cls(values=torch.from_numpy(values).to(device),
                   indices=torch.from_numpy(indices).to(device), n=int(bsr.shape[0]),
                   backend=backend)

    @property
    def padded_n(self) -> int:
        return self.values.shape[0] * self.values.shape[2]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        return bsr_ell_spmv(self.values, self.indices, x)

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        return bsr_ell_spmv_multi(self.values, self.indices, X)

    def diagonal(self) -> torch.Tensor:
        nbr, L = self.indices.shape
        rows = torch.arange(nbr, device=self.device)[:, None]
        on_diag = (self.indices == rows)[..., None]
        blocks = torch.where(on_diag, torch.diagonal(self.values, dim1=2, dim2=3), 0.0)
        return blocks.sum(1).reshape(-1)

    def launcher(self) -> Callable:
        values, indices = self.values, self.indices
        return _plain_launcher(lambda x: bsr_ell_spmv(values, indices, x))


@dataclasses.dataclass(frozen=True)
class WellOperator(LinearOperator):
    """tpucg's windowed gather-ELL operator (``tpucg_torch.sparse.well``):
    the irregular-sparse path, on K13. ``vals`` (NS, 128) f32 or bf16,
    ``lidx`` (NS, 128) int8, ``gidl`` (NB, BS), ``wrow`` (NS/8,) and ``sgb``
    (NB,) int32, ``dvec`` (padded_n,) f32 = diag(A), built on the host at
    set-up as tpucg builds it; ``n`` the logical size, ``bg``/``nsg``
    groups per super-group and super-groups; ``dblk`` the optional (nb, bs,
    bs) f32 diagonal blocks of block Jacobi, taken from the source CSR
    (``from_csr(pc_block_size=)``: the packed slabs are not addressable by
    (row, column)). These are the form both packages share. K13's layout (``rows``, ``well_rows``: the live slots
    repacked row by row, in tiles) is built here, once, on the arrays'
    device, after the arrays' values are checked (reads back to the host).
    On a CUDA device the matvec is K13 or raises; on the CPU its plain
    version, over the same layout."""

    vals: torch.Tensor
    lidx: torch.Tensor
    gidl: torch.Tensor
    wrow: torch.Tensor
    sgb: torch.Tensor
    dvec: torch.Tensor
    n: int
    bg: int
    nsg: int
    backend: str = "auto"
    dblk: Optional[torch.Tensor] = None
    rows: WellRows = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "backend", resolve_backend(self.backend, self.vals.device))
        check_well(self.vals, self.lidx, self.gidl, self.wrow, self.sgb, self.bg, self.nsg)
        if (self.dvec.dtype != torch.float32 or tuple(self.dvec.shape) != (self.padded_n,)
                or self.dvec.device != self.vals.device):
            raise ValueError(f"dvec must be f32 ({self.padded_n},) on {self.vals.device}, got "
                             f"{self.dvec.dtype} {tuple(self.dvec.shape)} on {self.dvec.device}")
        if self.nsg * self.bg < self.n_groups:
            raise ValueError(f"{self.nsg} super-groups of {self.bg} groups do not cover "
                             f"n={self.n}")
        if self.dblk is not None and (
                self.dblk.dtype != torch.float32 or self.dblk.dim() != 3
                or self.dblk.shape[1] != self.dblk.shape[2]
                or self.dblk.shape[0] * self.dblk.shape[1] < self.padded_n
                or self.dblk.device != self.vals.device):
            raise ValueError(f"dblk must be f32 (nb, bs, bs) blocks covering {self.padded_n} "
                             f"rows on {self.vals.device}, got {self.dblk.dtype} "
                             f"{tuple(self.dblk.shape)} on {self.dblk.device}")
        check_well_values(self.lidx, self.gidl, self.wrow, self.sgb, self.bg, self.nsg,
                          self.n_groups)
        object.__setattr__(self, "rows", well_rows(self.vals, self.lidx, self.gidl, self.wrow,
                                                   self.sgb, self.bg, self.nsg))

    @classmethod
    def from_csr(cls, csr, backend: str = "auto", storage_dtype=torch.float32, device=None,
                 pc_block_size=None, **well_kwargs) -> "WellOperator":
        """Pack a square CSR (``csr_to_well``, keyword arguments forwarded).
        ``pc_block_size`` takes the (nb, bs, bs) diagonal blocks from the CSR
        (``csr_diagonal_blocks``) so that block Jacobi runs on it."""
        from tpucg_torch.sparse.formats import csr_diagonal_blocks
        from tpucg_torch.sparse.well import csr_to_well

        if csr.shape[0] != csr.shape[1]:
            raise ValueError(f"WellOperator needs a square matrix, got {csr.shape}")
        dblk = None
        if pc_block_size is not None:
            dblk = csr_diagonal_blocks(csr, int(pc_block_size), npad=round_up(csr.shape[0], LANE))
        return cls.from_well(csr_to_well(csr, **well_kwargs), backend=backend,
                             storage_dtype=storage_dtype, device=device, dblk=dblk)

    @classmethod
    def from_well(cls, well, backend: str = "auto", storage_dtype=torch.float32,
                  device=None, dblk=None) -> "WellOperator":
        """``well`` is a ``WellMatrix`` (this package's or tpucg's).
        ``storage_dtype=torch.bfloat16`` stores the values in bf16 (3.5
        streamed bytes a slot instead of 5.5; f32 products and sums; the
        solve meets the f32 contract on the bf16-rounded system). ``device``
        defaults to the card, which raises when there is none; ``dblk`` (an
        array) the diagonal blocks of block Jacobi."""
        if storage_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
        device = canonical_device(device)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        return cls(
            vals=put(well.vals, np.float32).to(storage_dtype),
            lidx=put(well.lidx, np.int8), gidl=put(well.gidl, np.int32),
            wrow=put(well.wrow, np.int32), sgb=put(well.sgb, np.int32),
            dvec=put(well.diagonal(), np.float32), n=int(well.shape[0]),
            bg=int(well.groups_per_super), nsg=int(well.n_supergroups), backend=backend,
            dblk=None if dblk is None else put(dblk, np.float32),
        )

    @property
    def padded_n(self) -> int:
        return round_up(self.n, LANE)  # rows [n, padded_n) hold the identity tail

    @property
    def n_groups(self) -> int:
        return self.padded_n // LANE

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def matvec(self, x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ x over the padded length; ``active`` is K13's lap flag. A
        vector that is not f32 takes the plain product, as tpucg's does."""
        x2 = x.reshape(self.n_groups, LANE)
        arrays = (self.vals, self.lidx, self.gidl, self.wrow, self.sgb, x2, self.bg, self.nsg)
        if self.backend == "cuda" and x.dtype == torch.float32:
            y2 = well_spmv_cuda(*arrays, index=self.rows, active=active)
        else:
            y2 = well_spmv_torch(*arrays, index=self.rows)
        return y2.reshape(-1)[: self.padded_n]

    def matvec_multi(self, X: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A @ X over the padded length: K13 x k on the card over the
        operator's layout (the packed matrix read once for all k columns,
        where tpucg's vmap re-runs its kernel per column), its plain version
        on the CPU."""
        return well_spmv_multi(self.rows, X.contiguous(), self.padded_n, backend=self.backend,
                               active=active)

    def diagonal(self) -> torch.Tensor:
        return self.dvec

    def diagonal_blocks(self, bs: int) -> torch.Tensor:
        if self.dblk is None:
            raise NotImplementedError(
                "block Jacobi on a WellOperator needs the diagonal blocks extracted from the "
                "source CSR at construction: use WellOperator.from_csr(csr, pc_block_size=bs) "
                "(or best_sparse_operator(csr, pc_block_size=bs))"
            )
        if self.dblk.shape[1] != bs:
            raise ValueError(f"this WellOperator was built with pc_block_size="
                             f"{self.dblk.shape[1]}, solve requested {bs}")
        return self.dblk

    def launcher(self) -> Callable:
        rows, nrows = self.rows, self.padded_n
        return lambda x, y, active, stream: well_spmv_launch(rows, x, y, nrows, active, stream)


def best_sparse_operator(csr, backend: str = "auto", max_diags: int = 64,
                         dia_fill_cap: float = 4.0, blocksize: int = 8,
                         bsr_fill_cap: float = 3.0, fallback: str = "well", pc_block_size=None,
                         device=None) -> LinearOperator:
    """Promote a CSR matrix to a device format with tpucg's rules and
    thresholds (``operators.py:625``), in tpucg's order:

    1. DIA when the matrix is banded: at most ``max_diags`` distinct
       diagonals, and ndiag * n within ``dia_fill_cap`` times nnz;
    2. BSR when re-blocking into (blocksize x blocksize) tiles stores at most
       ``bsr_fill_cap`` times nnz (n identity-padded to the blocksize);
    3. WELL otherwise, for a square matrix (``fallback="ell"``: ELLPACK).

    ``device`` defaults to the card, which raises when there is none; every
    operator's backend resolves against it (tpucg's "xla" operators have no
    counterpart). ``pc_block_size`` has a WELL operator carry the diagonal
    blocks of block Jacobi, taken from the CSR (DIA, BSR and dense extract
    theirs from addressable storage)."""
    from tpucg_torch.sparse.formats import CSRMatrix, csr_to_bsr, csr_to_dia

    n = csr.shape[0]
    nnz = max(csr.nnz, 1)
    offs = np.unique(csr.indices.astype(np.int64) - csr.to_coo().row)
    if offs.size <= max_diags and offs.size * n <= dia_fill_cap * nnz:
        return DiaOperator.from_dia(csr_to_dia(csr, max_diags=max_diags), backend=backend,
                                    device=device)
    bs = blocksize
    csr_b = csr
    if n % bs:
        npad = round_up(n, bs)
        pad_rows = np.arange(n, npad)
        csr_b = CSRMatrix(
            indptr=np.concatenate([csr.indptr, csr.indptr[-1] + np.arange(1, npad - n + 1)]),
            indices=np.concatenate([csr.indices, pad_rows.astype(np.int32)]),
            data=np.concatenate([csr.data, np.ones(npad - n, dtype=csr.data.dtype)]),
            shape=(npad, npad),
        )
    brow = csr_b.to_coo().row // bs
    bcol = csr_b.indices.astype(np.int64) // bs
    nnzb = np.unique(brow * (csr_b.shape[1] // bs) + bcol).size
    if nnzb * bs * bs <= bsr_fill_cap * nnz:
        op = BsrOperator.from_bsr(csr_to_bsr(csr_b, bs), backend=backend, device=device)
        if csr_b.shape[0] != n:
            # The logical size: solves pad b and x0 to padded_n.
            op = dataclasses.replace(op, n=n)
        return op
    if fallback == "well" and n == csr.shape[1]:
        return WellOperator.from_csr(csr, backend=backend, device=device,
                                     pc_block_size=pc_block_size)
    return EllOperator.from_csr(csr, backend=backend, device=device)


def as_operator(A, backend: str = "auto", dtype=torch.float32, device=None) -> LinearOperator:
    """A dense array or tensor, a sparse container of this package or
    tpucg's, or an operator, as a LinearOperator (operators are returned
    unchanged). As in tpucg, a ``CSRMatrix`` becomes an ``EllOperator`` and
    an ``EllMatrix``, ``BSRMatrix``, ``WellMatrix`` or ``DIAMatrix`` its own
    operator (``best_sparse_operator`` picks a format instead). ``dtype`` is
    the storage dtype of a dense A, a DIA slab or WELL values; float64
    applies to a dense A only (a sparse container keeps f32, as tpucg's
    keeps its own dtype)."""
    if isinstance(A, LinearOperator):
        return A
    sparse_dtype = torch.float32 if dtype == torch.float64 else dtype
    kind = type(A).__name__
    if kind == "CSRMatrix":
        return EllOperator.from_csr(A, backend=backend, device=device)
    if kind == "EllMatrix":
        return EllOperator.from_ell(A, backend=backend, device=device)
    if kind == "BSRMatrix":
        return BsrOperator.from_bsr(A, backend=backend, device=device)
    if kind == "WellMatrix":
        return WellOperator.from_well(A, backend=backend, storage_dtype=sparse_dtype,
                                      device=device)
    if kind == "DIAMatrix":
        return DiaOperator.from_dia(A, backend=backend, storage_dtype=sparse_dtype,
                                    device=device)
    if kind == "COOMatrix" or getattr(A, "is_sparse", False) or (
            isinstance(A, torch.Tensor) and A.layout != torch.strided):
        raise TypeError(f"cannot interpret {kind} as a linear operator: convert it to a "
                        "CSRMatrix (COOMatrix.to_csr())")
    ndim = A.dim() if isinstance(A, torch.Tensor) else np.ndim(A)
    if ndim == 2:
        return DenseOperator.create(A, backend=backend, dtype=dtype, device=device)
    raise TypeError(f"cannot interpret {type(A)!r} as a linear operator")
