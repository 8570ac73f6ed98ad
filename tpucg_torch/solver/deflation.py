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
(``solve(checkpoint_path=)``).

``sharded_cg_solve_deflated`` runs deflated CG over the mesh's ranks:
W and AW split by rows beside A's rows, the m x m inverse replicated, and
one ``rank_sum`` of the (m,) coefficients a lap beyond classic sharded CG's
sums. The dense arm builds the basis on the host in float64 against the
identity-padded matrix (tpucg's ``_host_basis``); the operator arm
orthonormalizes V on the host and forms AW with the sharded operator's own
matvec, one column at a time. ``RecyclingCG(mesh=)`` runs every solve of
its sequence that way (``solve(checkpoint_path=)`` is serial-only, as
tpucg's). On a ``Mesh2D`` the dense arm runs the SUMMA decomposition
(tpucg's ``_sharded2d_deflated``).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.comm.mesh import Mesh2D, make_mesh
from tpucg_torch.config import CGConfig
from tpucg_torch.io.partitioner import RowPartition, pad_identity_tail
from tpucg_torch.kernels.dispatch import resolve_backend
from tpucg_torch.solver.cg import (
    TRUE_CHECK_EVERY,
    CGResult,
    TorchLap,
    _configure,
    _solve_operator,
    block_jacobi_minv,
    cg_loop,
    cg_solve,
    invert_blocks,
    lap_ops,
    make_block_precond,
    make_poly_precond,
    make_precond,
)
from tpucg_torch.solver.checkpoint import signatures_match, system_signature
from tpucg_torch.solver.sharded import (
    ROW_ALIGN,
    _check_supported,
    _dense_matvec,
    _gather_rows,
    _host,
    _local_diag_blocks,
    _operator_matvec,
    _own_square,
    _prepare_sharded_operator,
    DENSE_2D,
    _check_2d_config,
    _prepare_sharded2d,
    _reductions,
    _summa_matvec,
    check_mesh,
    distribute_system,
    is_operator,
    operator_rhs,
    pc_align,
    sharded_cg_solve,
    sharded_operator_cg_solve,
)

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


def _orthonormal(V) -> np.ndarray:
    """An orthonormal float64 basis of the columns of V (n, m) by a float64
    SVD, directions below 1e-6 of the largest singular value pruned
    (tpucg's rank-revealing step)."""
    U, s, _ = np.linalg.svd(np.asarray(V, np.float64), full_matrices=False)
    keep = s > max(1e-6 * (s[0] if s.size else 0.0), 1e-30)
    if not keep.any():
        raise ValueError("V has no usable directions (all ~zero)")
    return U[:, keep]


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
    W = np.ascontiguousarray(_orthonormal(V), dtype=np.float32)
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


def _host_basis(Apad: np.ndarray, Vpad: np.ndarray):
    """The dense arm's basis on the host (tpucg's ``_host_basis``): V
    orthonormalized by a float64 SVD (directions below 1e-6 of the largest
    singular value pruned), AW = A W and (W^T A W)^-1 in float64 against
    the identity-padded A, each cast to f32 once."""
    W = _orthonormal(Vpad)
    AW = np.asarray(Apad, np.float64) @ W
    G = W.T @ AW
    Ginv = np.linalg.inv(0.5 * (G + G.T))
    return W.astype(np.float32), AW.astype(np.float32), Ginv.astype(np.float32)


def _host_stack(V, n: int) -> np.ndarray:
    """V (n,) or (n, m) as a host f32 (n, m) stack."""
    V = _host(V)
    if V.ndim == 1:
        V = V[:, None]
    if V.shape[0] != n:
        raise ValueError(f"V must have {n} rows, got {V.shape}")
    return V


def _sharded_deflated_run(matvec, mesh, backend, b_blk, x0_blk, W, AW, Ginv, minv,
                          config: CGConfig, maxiter: int, chunk) -> CGResult:
    """tpucg's ``_sharded_deflated_jit`` body on this rank's rows: the base
    preconditioner, the Galerkin warm start and ``cg_loop`` with the
    deflation folded into ``precond``; ``W`` and ``AW`` are the rank's rows
    (f32 (blk, m) on its device), ``Ginv`` the replicated (m, m). A
    projection is one ``rank_sum`` of the rank's (m,) product AW^T z.
    ``converged`` is the loop's flag, as tpucg's."""
    red = _reductions(mesh, backend, b_blk)
    base = make_precond(config.precondition, minv, matvec, red.dot, b_blk, config.poly_degree)

    def deflate(z):
        c = mesh.rank_sum(torch.mv(AW.T, z))
        return z - torch.mv(W, torch.mv(Ginv, c))

    def precond(r, act=None):
        return deflate(r if base is None else base(r, act))
    r0 = b_blk - matvec(x0_blk, None)
    x0_blk = x0_blk + torch.mv(W, torch.mv(Ginv, mesh.rank_sum(torch.mv(W.T, r0))))
    s = cg_loop(matvec, red.dot, TorchLap(red.dot, red.update), b_blk, x0_blk,
                tol=float(config.tol), maxiter=maxiter, safe_alpha=bool(config.safe_alpha),
                precond=precond, chunk=chunk)
    return CGResult(x=_gather_rows(mesh, s.x), iterations=s.k, residual_norm=s.rslast.sqrt(),
                    converged=s.done)


def sharded_cg_solve_deflated(
    A,
    b,
    V,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    chunk: Optional[int] = None,
    **overrides,
) -> CGResult:
    """Deflated CG with A's rows in blocks over the mesh's ranks (tpucg's
    ``sharded_cg_solve_deflated``, ``deflation.py:727``): W and AW split by
    rows beside A's, the m x m inverse replicated, one extra ``rank_sum``
    of m values a lap.

    A dense ``A`` (whole, on the host) takes ``sharded_cg_solve``'s
    strategies and preconditioners (none, jacobi, block_jacobi, poly); its
    basis is built on the host in float64 against the identity-padded A
    (``_host_basis``). A sparse or stencil operator (Poisson slabs, DIA band
    halos, ELL, BSR, a CSR as sharded WELL, a ``WellShardedSystem``) takes
    ``sharded_operator_cg_solve``'s decompositions with precondition none,
    jacobi or poly; V is orthonormalized on the host, AW formed by the
    sharded matvec (one column at a time) and (W^T A W)^-1 inverted in
    float64. On a ``Mesh2D`` a dense ``A`` runs the SUMMA decomposition
    with precondition none, jacobi or poly (``_sharded2d_deflated``).
    Method cg, float32; x whole on every rank."""
    config = _configure(config, overrides)
    if config.method != "cg":
        raise ValueError(f"sharded_cg_solve_deflated supports method='cg' (got {config.method!r})")
    mesh = make_mesh() if mesh is None else mesh
    check_mesh(mesh)
    _check_supported(config)
    backend = resolve_backend(config.kernel, mesh.device)
    if isinstance(mesh, Mesh2D):
        if is_operator(A):
            raise ValueError(DENSE_2D)
        return _sharded2d_deflated(A, b, V, x0, mesh, config, backend, chunk)
    if is_operator(A):
        return _sharded_operator_deflated(A, b, V, x0, mesh, config, backend, chunk)
    A = _host(A)
    n = A.shape[0]
    part = RowPartition(n=n, num_shards=mesh.size, align=pc_align(ROW_ALIGN, config))
    npad, blk = part.n_padded, part.block_rows
    V = _host_stack(V, n)
    Vpad = np.pad(V, ((0, npad - n), (0, 0))) if npad != n else V
    W, AW, Ginv = _host_basis(pad_identity_tail(A, npad), Vpad)
    system = distribute_system(A, b, x0, mesh, part, strategy=config.strategy)
    matvec = _dense_matvec(system.A, system.strategy, mesh, backend)
    minv = None
    if config.precondition == "jacobi":
        d = torch.diagonal(_own_square(system)).to(torch.float32)
        minv = torch.where(d != 0, 1.0 / d, 1.0)
    elif config.precondition == "block_jacobi":
        minv = invert_blocks(_local_diag_blocks(system, int(config.pc_block_size)))
    r0 = mesh.rank * blk

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[r0:r0 + blk])).to(mesh.device)
    res = _sharded_deflated_run(
        matvec, mesh, backend, system.b, system.x0, rows(W), rows(AW),
        torch.from_numpy(Ginv).to(mesh.device), minv, config,
        int(config.maxiter if config.maxiter is not None else n), chunk)
    return res._replace(x=res.x[:n])


def _sharded2d_deflated(A, b, V, x0, mesh, config: CGConfig, backend: str, chunk) -> CGResult:
    """The 2-D SUMMA arm of ``sharded_cg_solve_deflated`` (tpucg's
    ``_sharded2d_deflated``, ``deflation.py:576``): the basis built on the
    host in float64 against the padded, un-permuted A (the permutation is
    the stored A's alone, so W and AW are in the vectors' order), each rank
    keeping its chunk of their rows; the projections summed over every
    rank."""
    if config.precondition not in ("none", "jacobi", "poly"):
        raise ValueError("2-D deflated CG supports precondition in {'none', 'jacobi', 'poly'} "
                         "(block Jacobi is 1-D-only: the 2-D decomposition stores "
                         "column-permuted blocks)")
    _check_2d_config(config)
    system, diag, n = _prepare_sharded2d(A, b, x0, mesh, config)
    npad, cs = system.npad, system.b.shape[0]
    V = _host_stack(V, n)
    Vpad = np.pad(V, ((0, npad - n), (0, 0))) if npad != n else V
    W, AW, Ginv = _host_basis(pad_identity_tail(_host(A), npad), Vpad)
    r0 = mesh.rank * cs

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[r0:r0 + cs])).to(mesh.device)
    minv = None if diag is None else torch.where(diag != 0, 1.0 / diag, 1.0)
    res = _sharded_deflated_run(
        _summa_matvec(system.A, mesh, backend), mesh, backend, system.b, system.x0, rows(W),
        rows(AW), torch.from_numpy(Ginv).to(mesh.device), minv, config,
        int(config.maxiter if config.maxiter is not None else n), chunk)
    return res._replace(x=res.x[:n])


def _sharded_operator_deflated(op, b, V, x0, mesh, config: CGConfig, backend: str,
                               chunk) -> CGResult:
    """The operator arm of ``sharded_cg_solve_deflated`` (tpucg's
    ``_sharded_operator_deflated``, ``deflation.py:631``): W from a float64
    SVD of the padded V on the host, AW from the sharded matvec of each
    column of the rank's rows of W, gathered whole, then G = W^T AW and its
    inverse in float64 (tpucg's explicit-inverse scheme)."""
    if config.precondition not in ("none", "jacobi", "poly"):
        raise ValueError("deflated CG on sharded sparse operators supports precondition in "
                         "{'none', 'jacobi', 'poly'} (block Jacobi on sharded sparse operators "
                         "is unimplemented, matching sharded_operator_cg_solve)")
    sop = _prepare_sharded_operator(op, mesh, config)
    n, npad = sop.n, sop.npad
    blk = npad // mesh.size
    V = _host_stack(V, n)
    Vpad = np.pad(V, ((0, npad - n), (0, 0))) if npad != n else V
    W = np.ascontiguousarray(_orthonormal(Vpad), dtype=np.float32)
    b_blk, x0_blk = operator_rhs(op, sop, b, x0, mesh)
    matvec = _operator_matvec(sop, mesh, backend)
    r0 = mesh.rank * blk
    W_blk = torch.from_numpy(np.ascontiguousarray(W[r0:r0 + blk])).to(mesh.device)
    AW_blk = torch.stack([matvec(W_blk[:, j].contiguous(), None)
                          for j in range(W.shape[1])], dim=1)
    AW = _gather_rows(mesh, AW_blk).cpu().numpy()
    G = W.astype(np.float64).T @ AW.astype(np.float64)
    Ginv = np.linalg.inv(0.5 * (G + G.T)).astype(np.float32)
    minv = None
    if config.precondition == "jacobi":
        minv = torch.where(sop.diag != 0, 1.0 / sop.diag, 1.0)
    res = _sharded_deflated_run(
        matvec, mesh, backend, b_blk, x0_blk, W_blk, AW_blk,
        torch.from_numpy(Ginv).to(mesh.device), minv, config,
        int(config.maxiter if config.maxiter is not None else n), chunk)
    return res._replace(x=res.x[:n])


class RecyclingCG:
    """Solve a sequence of systems with one operator, recycling solutions
    (tpucg's ``RecyclingCG``). Each solution that converged, or that got
    below 0.1 ||b|| (an honest stop at the f32 floor), joins the basis
    (FIFO, at most ``max_vectors``); later solves deflate with it. The basis
    is rebuilt (``build_deflation_basis``) when a vector is admitted.
    ``two_level`` is the base preconditioner of every solve. ``device`` and
    the config's ``kernel`` resolve as in ``cg_solve``.

    With ``mesh`` every solve runs distributed (tpucg's ``_solve_sharded``):
    ``sharded_cg_solve_deflated`` on the stack once it holds a vector,
    before that ``sharded_operator_cg_solve`` (an operator) or
    ``sharded_cg_solve`` (a dense A), the basis rebuilt by each deflated
    solve from the stack; ``two_level`` with ``mesh`` is tpucg's
    ``ValueError``, as ``solve(checkpoint_path=)`` on a mesh is (a 1-D
    ``Mesh`` or a ``Mesh2D``, whose solves take the SUMMA arms).

    >>> rec = RecyclingCG(A, max_vectors=4)
    >>> for b in rhs_sequence:
    ...     res = rec.solve(b)      # laps drop after the first solves
    """

    def __init__(self, A, max_vectors: int = 8, mesh=None,
                 config: Optional[CGConfig] = None, two_level=None, *, device=None,
                 **overrides):
        if two_level is not None and mesh is not None:
            raise ValueError("RecyclingCG(two_level=...) is serial-only (compose the sharded arms "
                             "explicitly via sharded_operator_cg_solve)")
        self.config = _configure(config, overrides)
        self.mesh = mesh
        if mesh is None:
            self.op, _, self.device = _solve_operator(A, self.config.kernel, device)
        else:
            check_mesh(mesh)
            self.op, self.device = None, mesh.device
        self.A = A
        self.two_level = two_level
        self.max_vectors = int(max_vectors)
        self._vectors: list = []
        self._basis: Optional[DeflationBasis] = None

    def _rebuild(self) -> None:
        self._basis = None
        if self._vectors and self.mesh is None:
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
        if checkpoint_path is not None and self.mesh is not None:
            raise ValueError("RecyclingCG checkpoint_path is serial-only")
        if checkpoint_path is not None:
            from tpucg_torch.solver.checkpoint import cg_solve_checkpointed

            res = cg_solve_checkpointed(self.op, b, x0, config=self.config,
                                        checkpoint_path=checkpoint_path,
                                        segment_iters=segment_iters, two_level=self.two_level,
                                        basis=self._basis, device=self.device)
        elif self.mesh is not None:
            res = self._solve_sharded(b, x0)
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

    def _solve_sharded(self, b, x0) -> CGResult:
        if self._vectors:
            return sharded_cg_solve_deflated(self.A, b, np.stack(self._vectors, axis=1), x0=x0,
                                             mesh=self.mesh, config=self.config)
        if is_operator(self.A):
            return sharded_operator_cg_solve(self.A, b, x0, mesh=self.mesh, config=self.config)
        return sharded_cg_solve(self.A, b, x0, mesh=self.mesh, config=self.config)

    def _signature(self) -> np.ndarray:
        op = self.op if self.op is not None else _solve_operator(self.A, "auto", "cpu")[0]
        return system_signature(op, np.zeros(op.padded_n, np.float32))

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
