"""Two-level and multilevel preconditioning (the counterpart of
``tpucg.solver.twolevel``): a coarse-space correction for FEM-class systems,
whose lap counts Jacobi cannot cut.

Aggregates are fixed-size contiguous index blocks of ``agg`` rows, so after
a locality-keeping ordering (mesh numbering, RCM) they are spatial
aggregates and the transfers are layout: restriction sums each block
(``reshape(nc, agg).sum(1)``), prolongation broadcasts. The Galerkin coarse
matrix Ac = P^T A P is assembled on the host in float64 from the CSR and
inverted once; a cycle's coarse solve is then one (nc, nc) f32 GEMV
(``torch.mv``: tpucg runs that product in XLA, outside any Pallas kernel).
With ``coarse_max`` the coarse matrix is assembled sparse and the build
recurses: the coarse solve is ``coarse_cycles`` V(1,1) cycles on a sparse
coarse operator (``best_sparse_operator``), down to a level of at most
``coarse_max`` rows, which gets the dense inverse.

The cycle (symmetric V(1,1)), with S the smoother:

    z1 = S r
    z2 = z1 + P Ac^-1 P^T (r - A z1)
    z  = z2 + S (r - A z2)

is a fixed SPD operator, so PCG's contract is unchanged. S is damped Jacobi
(``smooth_degree`` 1: (omega / lam) D^-1) or an l-step Chebyshev smoother
on [lam / alpha, 1.5 lam] of D^-1 A (l - 1 matvecs), lam the 24-step power
estimate of lambda_max(D^-1 A).

The cycle's matvecs are the solve's flagged ``matvec(v, act)`` (``lap_ops``):
on the card the operator's kernel under the lap's ``active`` flag, into the
one output buffer the lap's Ap also lives in, so each product is consumed
before the next matvec (as in ``make_poly_precond``); the coarse levels'
operators get their own flagged matvecs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.io.partitioner import round_up
from tpucg_torch.kernels.dispatch import canonical_device
from tpucg_torch.solver.cg import flagged_matvec, lambda_max_estimate
from tpucg_torch.solver.operators import LinearOperator, best_sparse_operator

# The power iterations of the smoother's lambda_max(D^-1 A) (tpucg's: 12
# underestimated by 1.39x on a flat-spectrum geometric graph).
SMOOTH_POWER_ITERS = 24
# The recursion's floor: coarse operators pad to 128 rows, so a smaller
# coarse_max could cycle (tpucg's 2 * LANE).
COARSE_FLOOR = 256


@dataclasses.dataclass(frozen=True)
class TwoLevel:
    """A built two-level (or multilevel) preconditioner, tpucg's fields:

    - ``acinv`` (nc, nc) f32: the symmetrized inverse of the Galerkin coarse
      matrix (f64 at set-up); a (1, 1) placeholder where ``inner`` is set;
    - ``dinv`` (npad,) f32: 1 / diag(A), 1 on the identity tail;
    - ``agg``: rows an aggregate; ``npad``: the operator's padded size;
    - ``omega``, ``smooth_degree``, ``smooth_alpha``: the smoother's;
    - ``coarse_op``, ``inner``, ``coarse_cycles``: the multilevel form's
      sparse coarse operator, its own preconditioner and the cycles of the
      coarse solve.
    """

    acinv: torch.Tensor
    dinv: torch.Tensor
    agg: int
    npad: int
    omega: float = 0.7
    smooth_degree: int = 1
    smooth_alpha: float = 4.0
    coarse_op: Optional[LinearOperator] = None
    inner: Optional["TwoLevel"] = None
    coarse_cycles: int = 2

    @property
    def nc(self) -> int:
        """ceil(npad / agg) (not acinv's size: the multilevel form's is 1)."""
        return -(-int(self.npad) // int(self.agg))

    @property
    def levels(self) -> int:
        return 1 + (0 if self.inner is None else self.inner.levels)

    @property
    def device(self) -> torch.device:
        return self.dinv.device


def build_two_level(
    csr,
    agg_size: int = 64,
    omega: float = 0.7,
    npad: Optional[int] = None,
    ridge: float = 0.0,
    smooth_degree: int = 1,
    smooth_alpha: float = 4.0,
    coarse_max: Optional[int] = None,
    *,
    device=None,
) -> TwoLevel:
    """A ``TwoLevel`` from a square SPD CSR (this package's or tpucg's), as
    tpucg builds it: host float64, one COO pass, the dense (nc, nc) inverse
    (nc = ceil(npad / agg_size)); ``npad`` defaults to round_up(n, 128), the
    WELL and DIA padding: pass the operator's ``padded_n``. The tail rows
    [n, npad) add identity to their aggregates. ``ridge`` adds a
    trace-relative diagonal before the inverse. With ``coarse_max`` and nc
    above it (floored at ``COARSE_FLOOR``), the coarse matrix is assembled
    sparse and the build recurses with the inner aggregate size ceil(nc /
    coarse_max), so the deepest level has at most ``coarse_max`` rows.
    ``device`` defaults to the card when there is one."""
    n, ncols = csr.shape
    if n != ncols:
        raise ValueError(f"two-level needs a square matrix, got {csr.shape}")
    agg = int(agg_size)
    if agg < 2:
        raise ValueError(f"agg_size must be >= 2, got {agg_size}")
    if npad is None:
        npad = round_up(n, 128)
    if npad < n:
        raise ValueError(f"npad {npad} < n {n}")
    device = canonical_device(device)
    nc = -(-npad // agg)

    coo = csr.to_coo()
    rows = np.asarray(coo.row).astype(np.int64)
    cols = np.asarray(coo.col).astype(np.int64)
    vals = np.asarray(coo.data).astype(np.float64)

    on_d = rows == cols
    dv = np.zeros(n, np.float64)
    np.add.at(dv, rows[on_d], vals[on_d])
    d = np.ones(npad, np.float32)
    d[:n] = np.where(dv != 0, dv, 1.0).astype(np.float32)
    dinv = torch.from_numpy((1.0 / d).astype(np.float32)).to(device)
    if smooth_degree < 1:
        raise ValueError(f"smooth_degree must be >= 1, got {smooth_degree}")

    cm_eff = None if coarse_max is None else max(int(coarse_max), COARSE_FLOOR)
    if cm_eff is not None and nc > cm_eff:
        # Sparse assembly (aggregate-pair keys pooled), then the recursion.
        from tpucg_torch.sparse.formats import COOMatrix

        keys = (rows // agg) * nc + (cols // agg)
        tailagg = np.arange(n, npad, dtype=np.int64) // agg
        keys = np.concatenate([keys, tailagg * nc + tailagg])
        kvals = np.concatenate([vals, np.ones(tailagg.size, np.float64)])
        uk, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros(uk.size, np.float64)
        np.add.at(acc, inv, kvals)
        if ridge:
            cdiag = (uk // nc) == (uk % nc)
            acc[cdiag] += ridge * (acc[cdiag].sum() / nc)
        csr_c = COOMatrix(row=uk // nc, col=uk % nc, data=acc.astype(np.float32),
                          shape=(nc, nc)).to_csr()
        cop = best_sparse_operator(csr_c, device=device)
        inner = build_two_level(
            csr_c, agg_size=max(2, -(-nc // cm_eff)), omega=omega, npad=cop.padded_n,
            ridge=ridge, smooth_degree=smooth_degree, smooth_alpha=smooth_alpha,
            coarse_max=cm_eff, device=device,
        )
        return TwoLevel(
            acinv=torch.zeros((1, 1), dtype=torch.float32, device=device), dinv=dinv,
            agg=agg, npad=int(npad), omega=float(omega), smooth_degree=int(smooth_degree),
            smooth_alpha=float(smooth_alpha), coarse_op=cop, inner=inner,
        )

    Ac = np.zeros((nc, nc), np.float64)
    np.add.at(Ac, (rows // agg, cols // agg), vals)
    tail_counts = np.bincount(np.arange(n, npad, dtype=np.int64) // agg, minlength=nc)
    idx = np.arange(nc)
    Ac[idx, idx] += tail_counts
    Ac = 0.5 * (Ac + Ac.T)
    if ridge:
        Ac[idx, idx] += ridge * (np.trace(Ac) / nc)
    acinv = np.linalg.inv(Ac)
    acinv = (0.5 * (acinv + acinv.T)).astype(np.float32)
    return TwoLevel(
        acinv=torch.from_numpy(acinv).to(device), dinv=dinv, agg=agg, npad=int(npad),
        omega=float(omega), smooth_degree=int(smooth_degree), smooth_alpha=float(smooth_alpha),
    )


def _make_smoother(matvec: Callable, dinv: torch.Tensor, lam: torch.Tensor, omega: float,
                   degree: int, alpha: float) -> Callable:
    """The cycle's smoother ``smooth(r, act)`` (tpucg's): degree 1 is one
    damped-Jacobi step (omega / lam) D^-1 r; degree l >= 2 the l-step
    Chebyshev smoother on [lam / alpha, 1.5 lam] of D^-1 A (the 1.5 pads
    the power method's underestimate), l - 1 matvecs."""
    if degree == 1:
        w = omega / lam

        def smooth(r, act=None):
            return (w * dinv) * r
        return smooth

    a = lam / alpha
    b = 1.5 * lam
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    def smooth(r, act=None):
        d = (dinv * r) / theta
        z = d
        rho = 1.0 / sigma1
        for _ in range(degree - 1):
            rr = r - matvec(z, act)
            rho_n = 1.0 / (2.0 * sigma1 - rho)
            d = rho_n * rho * d + (2.0 * rho_n / delta) * (dinv * rr)
            z = z + d
            rho = rho_n
        return z
    return smooth


def _coarse_solve_fn(tl: TwoLevel, dot: Callable) -> Callable:
    """The cycle's coarse solve ``solve(rc, act)``: the dense inverse as one
    f32 ``torch.mv`` at the deepest level; otherwise ``coarse_cycles``
    cycles of the inner preconditioner on the sparse coarse operator (its
    own flagged matvec, on its own backend), e = B rc + B (rc - Ac e) ...,
    which stays a fixed SPD operator."""
    if tl.inner is None:
        acinv = tl.acinv
        return lambda rc, act=None: torch.mv(acinv, rc)
    cop, nc = tl.coarse_op, tl.nc
    cmv = flagged_matvec(cop, cop.backend)
    pad = cop.padded_n - nc
    like = torch.zeros(cop.padded_n, dtype=torch.float32, device=tl.device)
    B = make_two_level_precond(tl.inner, cmv, dot, like)
    cycles = int(tl.coarse_cycles)

    def solve(rc, act=None):
        rcp = F.pad(rc, (0, pad)) if pad else rc
        e = B(rcp, act)
        for _ in range(cycles - 1):
            e = e + B(rcp - cmv(e, act), act)
        return e[:nc] if pad else e
    return solve


def make_two_level_precond(tl: TwoLevel, matvec: Callable, dot: Callable,
                           like: torch.Tensor) -> Callable:
    """The cycle as the loops' ``precond(r, act)``, on the solve's
    ``matvec(v, act)`` and ``dot(u, v, act)`` (``lap_ops``'s). Set-up: the
    24-step power estimate of lambda_max(D^-1 A) at each level (enqueued,
    no host read) and, for the multilevel form, the inner cycles, once."""
    if like.shape[-1] != tl.npad:
        raise ValueError(f"two_level was built for padded size {tl.npad}, the solve's vectors "
                         f"have {like.shape[-1]}")
    dinv = tl.dinv
    lam = lambda_max_estimate(lambda v, act=None: dinv * matvec(v, act), dot, like,
                              power_iters=SMOOTH_POWER_ITERS)
    S = _make_smoother(matvec, dinv, lam, tl.omega, tl.smooth_degree, tl.smooth_alpha)
    nc, agg, npad = tl.nc, tl.agg, tl.npad
    pad = nc * agg - npad
    coarse_solve = _coarse_solve_fn(tl, dot)

    def restrict(v):
        vp = F.pad(v, (0, pad)) if pad else v
        return vp.reshape(nc, agg).sum(dim=1)

    def prolong(u):
        z = u[:, None].expand(nc, agg).reshape(-1)
        return z[:npad] if pad else z

    def precond(r, act=None):
        z = S(r, act)
        e = coarse_solve(restrict(r - matvec(z, act)), act)
        z = z + prolong(e)
        return z + S(r - matvec(z, act), act)
    return precond
