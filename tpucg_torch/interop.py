"""Carry CG state between tpucg and the port.

CG has no weights: what a solve carries is the padded operator and the loop
state. These functions take both from NumPy arrays, as a ``tpucg``
``DenseOperator`` and ``_State`` hold them (``np.asarray`` of each field),
and give the port's state back in the same form, so a lap of either package
can start where the other stopped.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpucg_torch.solver.cg import _State
from tpucg_torch.solver.operators import DenseOperator, padded_size

STATE_FIELDS = ("k", "x", "r", "p", "rsold", "rslast", "done")


def dense_operator_from_numpy(A_padded: np.ndarray, n: int, device="cpu") -> DenseOperator:
    """The port's DenseOperator for an already padded (npad, npad) f32 or
    bf16 array of logical size ``n``. The padding must be the port's: npad
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
    dtype = torch.bfloat16 if A.dtype.name == "bfloat16" else torch.float32
    t = torch.from_numpy(A.astype(np.float32)).to(device=device, dtype=dtype)
    return DenseOperator(A=t, n=n)


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
