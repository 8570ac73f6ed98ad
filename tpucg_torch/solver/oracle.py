"""Pure-NumPy CG oracle (a copy of ``tpucg.solver.oracle``).

Implements the reference C contract exactly: float32 arithmetic, the
absolute stopping rule ``sqrt(r.r) < tol`` tested after the x/r update and
before the p update, at most n iterations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def oracle_cg(
    A: np.ndarray,
    b: np.ndarray,
    x0: np.ndarray,
    tol: float = 1.0e-6,
    maxiter: int | None = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, int, float]:
    """Solve A x = b. Returns (x, iterations, final residual 2-norm)."""
    A = np.asarray(A, dtype=dtype)
    b = np.asarray(b, dtype=dtype)
    x = np.array(x0, dtype=dtype, copy=True)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n
    r = b - A @ x
    p = r.copy()
    rsold = dtype(r @ r)
    rnorm = float(np.sqrt(rsold))
    if rnorm < tol:  # exact x0; the reference would divide 0/0 here
        return x, 0, rnorm
    k = 0
    for k in range(1, maxiter + 1):
        Ap = A @ p
        alpha = rsold / dtype(p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        beta = dtype(r @ r)
        rnorm = float(np.sqrt(beta))
        if rnorm < tol:
            break
        p = r + (beta / rsold) * p
        rsold = beta
    return x, k, rnorm
