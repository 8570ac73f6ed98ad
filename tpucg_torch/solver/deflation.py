"""Deflated and recycling CG (the counterpart of ``tpucg.solver.deflation``),
serial.

Deflated CG (Saad, Yeung, Erhel and Guyomarc'h 2000): from a basis W (n,
m), start at the Galerkin-corrected guess x0 + W (W^T A W)^-1 W^T r0 (so
W^T r0 = 0) and keep every search direction A-orthogonal to range(W):
z' = P M^-1 r with P = I - W (W^T A W)^-1 (AW)^T, folded into ``cg_loop``'s
``precond``. The projection is two tall-skinny ``torch.mv`` products a lap
(full f32: no TF32 in a matrix-vector product) around the base
preconditioner: none, Jacobi, block Jacobi, poly or a ``TwoLevel`` cycle;
composed with two-level, the solve stops on the true residual every
``TRUE_CHECK_EVERY`` laps, as tpucg's does.

``build_deflation_basis`` makes the basis A-orthonormal (W^T A W = I) on the
host in float64 (an SVD of V, then the eigen-fold of W^T A W), around one
batched product A W through the operator's ``matvec_multi``: K6 x k, K8 x k
or K13 x k on the card, a GEMM for a dense A, as tpucg's vmap runs it.

``RecyclingCG`` solves a sequence of systems with one operator and
recycles each admitted solution into the basis; its state saves to and
loads from tpucg's ``.npz`` format under the probe-signature guard
(``solver/checkpoint.py``), and a solve of the sequence can be checkpointed
(``solve(checkpoint_path=)``). Its distributed form is ROADMAP M14 step 5.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.config import CGConfig
from tpucg_torch.solver.cg import (
    TRUE_CHECK_EVERY,
    CGResult,
    _configure,
    _solve_operator,
    block_jacobi_minv,
    cg_loop,
    cg_solve,
    lap_ops,
    make_block_precond,
    make_poly_precond,
)
from tpucg_torch.solver.checkpoint import signatures_match, system_signature

# Residual replacement in the deflation x two-level recurrence: off, as in
# tpucg (measured there to grow the iterate exponentially past the f32
# floor).
DEFLATED_REPLACE_EVERY = None


class DeflationBasis(NamedTuple):
    """A deflation space, reusable across solves: ``W`` (npad, m), A-
    orthonormal when ``build_deflation_basis`` made it; ``AW`` = A W;
    ``Ginv`` (m, m) = (W^T A W)^-1, the identity for an A-orthonormal W.
    f32 tensors on the solve's device."""

    W: torch.Tensor
    AW: torch.Tensor
    Ginv: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.W.shape[1])


def build_deflation_basis(A, V, kernel: str = "auto", *, device=None) -> DeflationBasis:
    """A-orthonormalize the columns of ``V`` (n, m) into a ``DeflationBasis``
    for ``A`` (tpucg's): a host float64 SVD of V (directions below 1e-6 of
    the largest singular value pruned), one batched product A W on the
    operator's ``matvec_multi`` (f32), then G = W^T A W eigendecomposed in
    float64 and folded in (W <- W G^-1/2, eigendirections below 1e-12 of
    the largest pruned). The basis may have fewer columns than V."""
    op, _, device = _solve_operator(A, kernel, device)
    V = V.detach().cpu().numpy() if isinstance(V, torch.Tensor) else V
    V = np.asarray(V, np.float64)
    if V.ndim == 1:
        V = V[:, None]
    if V.shape[0] != op.n:
        raise ValueError(f"V must have {op.n} rows, got {V.shape}")
    U, s, _ = np.linalg.svd(V, full_matrices=False)
    keep = s > max(1e-6 * (s[0] if s.size else 0.0), 1e-30)
    if not keep.any():
        raise ValueError("V has no usable directions (all ~zero)")
    W = np.ascontiguousarray(U[:, keep], dtype=np.float32)
    npad = op.padded_n
    if npad != op.n:
        W = np.pad(W, ((0, npad - op.n), (0, 0)))
    AW = op.matvec_multi(torch.from_numpy(W).to(device)).cpu().numpy().astype(np.float64)
    W64 = W.astype(np.float64)
    G = W64.T @ AW
    G = 0.5 * (G + G.T)
    ew, E = np.linalg.eigh(G)
    keep2 = ew > max(1e-12 * float(ew.max()), 1e-300)
    if not keep2.any():
        raise ValueError("V has no A-positive directions (W^T A W ~ 0)")
    S = E[:, keep2] / np.sqrt(ew[keep2])  # W @ S is A-orthonormal

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return DeflationBasis(W=put(W64 @ S), AW=put(AW @ S),
                          Ginv=torch.eye(int(keep2.sum()), dtype=torch.float32, device=device))


def _galerkin_refresh(basis: DeflationBasis) -> Callable:
    """The residual replacement's x/r refresh inside the deflated
    recurrence: the Galerkin correction re-applied, so the replaced residual
    stays orthogonal to span(W)."""
    W, AW, Ginv = basis

    def refresh(x, r_true):
        y = torch.mv(Ginv, torch.mv(W.T, r_true))
        return x + torch.mv(W, y), r_true - torch.mv(AW, y)
    return refresh


def _deflate_precond(basis: DeflationBasis, base: Optional[Callable]) -> Callable:
    """z = P (M^-1 r): the projection after the base ``precond(r, act)``
    (the identity when None)."""
    W, AW, Ginv = basis

    def apply(r, act=None):
        z = r if base is None else base(r, act)
        return z - torch.mv(W, torch.mv(Ginv, torch.mv(AW.T, z)))
    return apply


def _deflated_run(op, backend, b, x0, basis, minv, *, tol, maxiter, safe_alpha, poly_degree,
                  record, two_level, chunk):
    """tpucg's ``_deflated_jit`` as a plain function: the base
    preconditioner, the Galerkin warm start and ``cg_loop`` (check-true
    every ``TRUE_CHECK_EVERY`` laps under two-level)."""
    matvec, dot, lap = lap_ops(op, backend)
    if two_level is not None:
        from tpucg_torch.solver.twolevel import make_two_level_precond

        base = make_two_level_precond(two_level, matvec, dot, b)
    elif poly_degree:
        base = make_poly_precond(matvec, dot, b, poly_degree)
    elif minv is not None:
        base = (make_block_precond(minv, b.shape[0]) if minv.dim() == 3
                else (lambda r, act=None: minv * r))
    else:
        base = None
    r0 = b - matvec(x0, None)
    x0 = x0 + torch.mv(basis.W, torch.mv(basis.Ginv, torch.mv(basis.W.T, r0)))
    s = cg_loop(
        matvec, dot, lap, b, x0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
        precond=_deflate_precond(basis, base), hist_len=maxiter if record else None,
        chunk=chunk,
        replace_every=DEFLATED_REPLACE_EVERY if two_level is not None else None,
        replace_fn=_galerkin_refresh(basis) if DEFLATED_REPLACE_EVERY else None,
        check_true_every=TRUE_CHECK_EVERY if two_level is not None else None,
    )
    tol2 = torch.tensor(tol, dtype=s.rslast.dtype, device=s.rslast.device) ** 2
    return CGResult(x=s.x, iterations=s.k, residual_norm=s.rslast.sqrt(),
                    converged=s.rslast < tol2, residual_history=s.hist)


def cg_solve_deflated(
    A,
    b,
    V=None,
    x0=None,
    basis: Optional[DeflationBasis] = None,
    config: Optional[CGConfig] = None,
    record_residuals: bool = False,
    two_level=None,
    *,
    device=None,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Deflated CG (tpucg's ``cg_solve_deflated``): solve A x = b with the
    subspace ``V`` (n, m), or a prebuilt ``basis``, projected out of the
    iteration. ``precondition`` none, jacobi, block_jacobi or poly; or a
    prebuilt ``two_level`` (with ``precondition="none"``), then the solve
    tests the true residual every ``TRUE_CHECK_EVERY`` laps. ``method``
    must be "cg" and the dtype float32. ``device`` and ``kernel`` resolve
    as in ``cg_solve``; the laps run on the operator's kernels."""
    config = _configure(config, overrides)
    if config.method != "cg":
        raise ValueError(f"cg_solve_deflated supports method='cg' (got {config.method!r})")
    if config.dtype != torch.float32:
        raise ValueError("cg_solve_deflated is float32-only")
    if (V is None) == (basis is None):
        raise ValueError("pass exactly one of V or basis")
    op, backend, device = _solve_operator(A, config.kernel, device)
    n, npad = op.n, op.padded_n
    if basis is None:
        basis = build_deflation_basis(op, V, kernel=backend, device=device)
    if basis.W.shape[0] != npad:
        raise ValueError(f"basis was built for padded size {basis.W.shape[0]}, "
                         f"operator has {npad}")
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
    x0 = (torch.zeros(n, dtype=torch.float32, device=device) if x0 is None
          else torch.as_tensor(x0, dtype=torch.float32, device=device))
    if npad != n:
        b, x0 = F.pad(b, (0, npad - n)), F.pad(x0, (0, npad - n))
    if two_level is not None:
        if config.precondition != "none":
            raise ValueError("two_level runs as THE base preconditioner "
                             f"(got precondition={config.precondition!r})")
        if two_level.npad != npad:
            raise ValueError(f"two_level was built for padded size {two_level.npad}, "
                             f"operator has {npad}")
    minv = None
    if config.precondition == "jacobi":
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0).to(torch.float32)
    elif config.precondition == "block_jacobi":
        minv = block_jacobi_minv(op, int(config.pc_block_size))
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    res = _deflated_run(
        op, backend, b, x0, basis, minv, tol=float(config.tol), maxiter=maxiter,
        safe_alpha=bool(config.safe_alpha),
        poly_degree=config.poly_degree if config.precondition == "poly" else 0,
        record=bool(record_residuals), two_level=two_level, chunk=chunk,
    )
    return res._replace(x=res.x[:n])


class RecyclingCG:
    """Solve a sequence of systems with one operator, recycling solutions
    (tpucg's ``RecyclingCG``, serial). Each solution that converged, or that
    got below 0.1 ||b|| (an honest stop at the f32 floor), joins the basis
    (FIFO, at most ``max_vectors``); later solves deflate with it. The basis
    is rebuilt (``build_deflation_basis``) when a vector is admitted.
    ``two_level`` is the base preconditioner of every solve. ``device`` and
    the config's ``kernel`` resolve as in ``cg_solve``.

    >>> rec = RecyclingCG(A, max_vectors=4)
    >>> for b in rhs_sequence:
    ...     res = rec.solve(b)      # laps drop after the first solves
    """

    def __init__(self, A, max_vectors: int = 8, mesh=None,
                 config: Optional[CGConfig] = None, two_level=None, *, device=None,
                 **overrides):
        if mesh is not None:
            raise NotImplementedError("RecyclingCG(mesh=...) (distributed recycling) is ROADMAP "
                                      "M14 step 5")
        self.config = _configure(config, overrides)
        self.op, _, self.device = _solve_operator(A, self.config.kernel, device)
        self.A = A
        self.two_level = two_level
        self.max_vectors = int(max_vectors)
        self._vectors: list = []
        self._basis: Optional[DeflationBasis] = None

    def _rebuild(self) -> None:
        self._basis = None
        if self._vectors:
            self._basis = build_deflation_basis(self.op, np.stack(self._vectors, axis=1),
                                                kernel=self.config.kernel, device=self.device)

    def solve(self, b, x0=None, *, checkpoint_path=None, segment_iters: int = 128) -> CGResult:
        """Solve the next system of the sequence and admit its solution.
        ``checkpoint_path`` runs this solve through ``cg_solve_checkpointed``
        (segments of ``segment_iters`` laps, resumable from the file) with
        the sequence's basis and ``two_level``: the recurrence of the solve
        without it. With ``save_state``/``load_state`` an interrupted
        sequence resumes warm: the stack restores the deflation space, the
        file the solve in flight."""
        if checkpoint_path is not None:
            from tpucg_torch.solver.checkpoint import cg_solve_checkpointed

            res = cg_solve_checkpointed(self.op, b, x0, config=self.config,
                                        checkpoint_path=checkpoint_path,
                                        segment_iters=segment_iters, two_level=self.two_level,
                                        basis=self._basis, device=self.device)
        elif self._basis is not None:
            res = cg_solve_deflated(self.op, b, basis=self._basis, x0=x0, config=self.config,
                                    two_level=self.two_level, device=self.device)
        else:
            res = cg_solve(self.op, b, x0, config=self.config, two_level=self.two_level,
                           device=self.device)
        bn = b.detach().cpu().double().numpy() if isinstance(b, torch.Tensor) else b
        b_norm = float(np.linalg.norm(np.asarray(bn, np.float64)))
        if bool(res.converged) or float(res.residual_norm) < 0.1 * max(b_norm, 1e-30):
            self._vectors.append(res.x.cpu().numpy().astype(np.float32))
            self._vectors = self._vectors[-self.max_vectors:]
            self._rebuild()
        return res

    def _signature(self) -> np.ndarray:
        return system_signature(self.op, np.zeros(self.op.padded_n, np.float32))

    def save_state(self, path: str) -> None:
        """The recycled stack as an atomic ``.npz`` (tpucg's format: ``V``
        (n, m), ``max_vectors``, ``signature``)."""
        V = (np.stack(self._vectors, axis=1) if self._vectors
             else np.zeros((0, 0), np.float32))
        tmp = path + ".tmp"
        np.savez(tmp, V=V, max_vectors=np.int64(self.max_vectors), signature=self._signature())
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)

    def load_state(self, path: str) -> int:
        """Restore a saved stack (of either package), newest ``max_vectors``
        columns; refuses a state saved for another operator. Returns the
        vectors restored."""
        with np.load(path) as z:
            V = np.asarray(z["V"], np.float32)
            sig = np.asarray(z["signature"])
        if not signatures_match(sig, self._signature()):
            raise ValueError(f"recycling state at {path!r} was saved for a DIFFERENT operator "
                             "(probe signature mismatch): refusing to deflate with a foreign "
                             "basis")
        Vk = V[:, -self.max_vectors:] if V.shape[1] else V
        self._vectors = [np.ascontiguousarray(Vk[:, j]) for j in range(Vk.shape[1])]
        self._rebuild()
        return len(self._vectors)
