"""Carry CG state between tpucg and the port.

CG has no weights: what a solve carries is the padded operator and the loop
state. These functions take both from NumPy arrays, as a ``tpucg``
``DenseOperator``, ``DiaOperator``, ``WellOperator``, ``EllOperator``,
``BsrOperator`` and ``_State`` hold them (``np.asarray`` of each field), and
give the port's state back in the same form, so a lap of either package can
start where the other stopped. A ``PoissonOperator`` holds only its grid
edge. A built two-level preconditioner (``TwoLevel``, recursively) and a
deflation basis (``DeflationBasis``) come over the same way, so both
packages can be held to the same preconditioner and basis.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpucg_torch.io.partitioner import round_up
from tpucg_torch.kernels.spmv import LANE, dia_deinterleave
from tpucg_torch.solver.cg import _State
from tpucg_torch.solver.deflation import DeflationBasis
from tpucg_torch.solver.operators import (
    BsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    PoissonOperator,
    WellOperator,
    LinearOperator,
    padded_size,
)
from tpucg_torch.solver.twolevel import TwoLevel

STATE_FIELDS = ("k", "x", "r", "p", "rsold", "rslast", "done")


def dense_operator_from_numpy(A_padded: np.ndarray, n: int, device="cpu") -> DenseOperator:
    """The port's DenseOperator for an already padded (npad, npad) f32, bf16
    or f64 array of logical size ``n``. The padding must be the port's: npad
    the multiple of 128 above n, identity on the tail, zeros beside it."""
    A = np.asarray(A_padded)
    npad = padded_size(n)
    if A.shape != (npad, npad):
        raise ValueError(f"expected a ({npad}, {npad}) array for n={n}, got {A.shape}")
    tail = A[n:, n:].astype(np.float32)
    if (
        not np.array_equal(tail, np.eye(npad - n, dtype=np.float32))
        or np.any(A[:n, n:].astype(np.float32))
        or np.any(A[n:, :n].astype(np.float32))
    ):
        raise ValueError("A_padded does not end in a decoupled identity tail")
    if A.dtype == np.float64:
        # An f64 A (tpucg's x64 operator) stays f64, on the "torch" backend.
        return DenseOperator(A=torch.from_numpy(np.ascontiguousarray(A)).to(device), n=n)
    dtype = torch.bfloat16 if A.dtype.name == "bfloat16" else torch.float32
    t = torch.from_numpy(A.astype(np.float32)).to(device=device, dtype=dtype)
    return DenseOperator(A=t, n=n)


def dia_operator_from_numpy(data: np.ndarray, offsets, n: int, interleaved: bool = False,
                            device="cpu") -> DiaOperator:
    """The port's DiaOperator for a tpucg ``DiaOperator``'s fields: its slab
    (f32 or bf16; tpucg's row-interleaved (npad//128, ndiag*128) packing
    when ``interleaved``, else the canonical (ndiag, npad)), its offsets and
    its logical size ``n``. The padding must be tpucg's: npad the multiple
    of 128 above n when 0 is among the offsets (else n), the main diagonal
    1 on the tail, and nothing else on the tail rows or coupling to them."""
    data = np.asarray(data)
    if interleaved:
        data = dia_deinterleave(data)
    offsets = tuple(int(o) for o in offsets)
    npad = round_up(n, LANE) if 0 in offsets else n
    if data.shape != (len(offsets), npad):
        raise ValueError(
            f"expected a ({len(offsets)}, {npad}) slab for n={n} and {len(offsets)} offsets, "
            f"got {data.shape}"
        )
    wide = data.astype(np.float32)
    if npad != n:
        d0 = offsets.index(0)
        rows = np.arange(npad)
        cols = rows[None, :] + np.asarray(offsets)[:, None]
        # Entries of a tail row, or of a row < n reaching a tail column.
        tail = (rows[None, :] >= n) | ((cols >= n) & (cols < npad))
        tail[d0, n:] = False
        if not np.all(wide[d0, n:] == 1.0) or np.any(wide[tail]):
            raise ValueError("the slab does not end in a decoupled identity tail")
    dtype = torch.bfloat16 if data.dtype.name == "bfloat16" else torch.float32
    t = torch.from_numpy(np.ascontiguousarray(wide)).to(device=device, dtype=dtype)
    return DiaOperator(data=t, offsets=offsets, n=n)


def well_operator_from_numpy(vals, lidx, gidl, wrow, sgb, dvec, n: int, bg: int, nsg: int,
                             device="cpu", dblk=None) -> WellOperator:
    """The port's WellOperator for a tpucg ``WellOperator``'s fields: its
    packed arrays (``vals`` f32 or bf16), ``dvec`` (diag(A) over the padded
    length), ``n``, ``bg``, ``nsg`` and, when it has them, its ``dblk``
    (the (nb, bs, bs) diagonal blocks of block Jacobi)."""
    vals = np.asarray(vals)
    dtype = torch.bfloat16 if vals.dtype.name == "bfloat16" else torch.float32

    def put(a, np_dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np_dtype))).to(device)

    return WellOperator(vals=put(vals, np.float32).to(dtype), lidx=put(lidx, np.int8),
                        gidl=put(gidl, np.int32), wrow=put(wrow, np.int32),
                        sgb=put(sgb, np.int32), dvec=put(dvec, np.float32), n=int(n),
                        bg=int(bg), nsg=int(nsg),
                        dblk=None if dblk is None else put(dblk, np.float32))


def ell_operator_from_numpy(values, indices, n: int, device="cpu") -> EllOperator:
    """The port's EllOperator for a tpucg ``EllOperator``'s (n, L) values and
    indices."""
    return EllOperator(values=torch.tensor(np.asarray(values, np.float32), device=device),
                       indices=torch.tensor(np.asarray(indices, np.int32), device=device),
                       n=int(n))


def bsr_operator_from_numpy(values, indices, n: int, device="cpu") -> BsrOperator:
    """The port's BsrOperator for a tpucg ``BsrOperator``'s (nbr, L, bs, bs)
    values, (nbr, L) block-column ids and logical size ``n``."""
    return BsrOperator(values=torch.tensor(np.asarray(values, np.float32), device=device),
                       indices=torch.tensor(np.asarray(indices, np.int32), device=device),
                       n=int(n))


def poisson_operator(m: int, device="cpu") -> PoissonOperator:
    """The port's counterpart of tpucg's ``PoissonOperator(m)``."""
    return PoissonOperator(m=m, device=device)


def state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> _State:
    """A ``_State`` from tpucg's field names (``k``, ``x``, ``r``, ``p``,
    ``rsold``, ``rslast``, ``done``, optional ``hist``)."""
    missing = [f for f in STATE_FIELDS if f not in d]
    if missing:
        raise ValueError(f"state is missing {missing}")

    def t(name, dtype):
        return torch.tensor(np.array(d[name]), dtype=dtype, device=device)

    f32 = torch.float32
    return _State(
        k=t("k", torch.int32), x=t("x", f32), r=t("r", f32), p=t("p", f32),
        rsold=t("rsold", f32), rslast=t("rslast", f32), done=t("done", torch.bool),
        hist=None if d.get("hist") is None else t("hist", f32),
    )


def state_to_numpy(state: _State) -> Dict[str, np.ndarray]:
    """The port's ``_State`` as a dict of NumPy arrays under tpucg's names."""
    out = {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}
    if state.hist is not None:
        out["hist"] = state.hist.cpu().numpy()
    return out


TWO_LEVEL_FIELDS = ("acinv", "dinv", "agg", "npad", "omega", "smooth_degree", "smooth_alpha",
                    "coarse_cycles")


def two_level_from_numpy(fields: Dict, device="cpu") -> TwoLevel:
    """The port's ``TwoLevel`` for a tpucg ``TwoLevel``'s fields under its
    names (``acinv`` and ``dinv`` as NumPy arrays, the rest scalars). The
    multilevel form also carries ``coarse_op``, the coarse operator already
    made with one of the functions above (a port ``LinearOperator``), and
    ``inner``, the next level's fields as such a dict, converted in turn."""
    missing = [f for f in TWO_LEVEL_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"two-level fields are missing {missing}")
    inner, cop = fields.get("inner"), fields.get("coarse_op")
    if (inner is None) != (cop is None):
        raise ValueError("a multilevel TwoLevel carries both coarse_op and inner")
    if cop is not None and not isinstance(cop, LinearOperator):
        raise TypeError(f"coarse_op must be a port operator, got {type(cop).__name__}")

    def put(name):
        return torch.tensor(np.asarray(fields[name], np.float32), device=device)

    return TwoLevel(
        acinv=put("acinv"), dinv=put("dinv"), agg=int(fields["agg"]), npad=int(fields["npad"]),
        omega=float(fields["omega"]), smooth_degree=int(fields["smooth_degree"]),
        smooth_alpha=float(fields["smooth_alpha"]), coarse_op=cop,
        inner=None if inner is None else two_level_from_numpy(inner, device),
        coarse_cycles=int(fields["coarse_cycles"]),
    )


def deflation_basis_from_numpy(W, AW, Ginv, device="cpu") -> DeflationBasis:
    """The port's ``DeflationBasis`` for a tpucg ``DeflationBasis``'s W
    (npad, m), AW (npad, m) and Ginv (m, m)."""
    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    W, AW, Ginv = put(W), put(AW), put(Ginv)
    m = W.shape[1]
    if W.dim() != 2 or AW.shape != W.shape or Ginv.shape != (m, m):
        raise ValueError(f"expected W and AW (npad, m) and Ginv (m, m), got "
                         f"{tuple(W.shape)}, {tuple(AW.shape)}, {tuple(Ginv.shape)}")
    return DeflationBasis(W=W, AW=AW, Ginv=Ginv)
