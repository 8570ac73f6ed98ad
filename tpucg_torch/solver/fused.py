"""The plain versions of the whole-solve kernels K4, K5, K10, K11 and K12,
and the dispatchers that pick kernel or plain version by the tensors'
device.

The kernels' wrappers (``tpucg_torch.kernels.fused``) check the operands
and launch one kernel; the plain versions check the same operands, with the
same messages, and run the same recurrence (tpucg's ``_cg_while``) through
this package's loops on plain torch ops: ``cg_loop`` on the plain lap
kernels for one system (the dense GEMV, the DIA SpMV or the stencil),
``batch_cg_loop`` with ``torch.bmm`` for a dense batch and the batched
shift-and-add for a banded one; poly comes through
``make_poly_precond`` (the kernels' power method, from the same seed over
the padded length). They return what the kernels return, ``(x, k, rr)``,
and read nothing back to the host beyond the loops' one flag per chunk of
laps. ``cg_solve``, ``cg_solve_batch`` and ``cg_solve_batch_banded`` never
call them: they serve the tests and the card's checks of the kernels.
"""

from __future__ import annotations

from tpucg_torch.kernels.dispatch import resolve_backend
from tpucg_torch.kernels.fused import (
    check_fused,
    check_fused_batch,
    check_fused_batch_dia,
    check_fused_dia,
    check_fused_stencil,
    dia_minv,
    fused_batch_cg_solve_cuda,
    fused_batch_dia_cg_solve_cuda,
    fused_cg_solve_cuda,
    fused_dia_cg_solve_cuda,
    fused_stencil_cg_solve_cuda,
)
from tpucg_torch.solver.cg import (
    batch_cg_loop,
    batch_dia_matvec,
    batch_matvec,
    cg_loop,
    lap_ops,
    make_precond,
)
from tpucg_torch.solver.operators import DenseOperator, DiaOperator, PoissonOperator


def fused_cg_solve_torch(A, b, x0, *, tol, maxiter, safe_alpha=True, precondition="none",
                         poly_degree=0, minv=None):
    """Plain version of K4: ``cg_loop`` on the plain lap kernels, with the
    polynomial preconditioner of ``make_poly_precond`` (the same power
    method from the same seed as the kernel's)."""
    fused_cg_solve_torch.launches += 1
    check_fused(A, b, x0, precondition, poly_degree, minv)
    return _plain_solve(DenseOperator(A=A, n=A.shape[0], backend="torch"), b, x0, minv,
                        tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                        precondition=precondition, poly_degree=poly_degree)


def _plain_solve(op, b, x0, minv, *, tol, maxiter, safe_alpha, precondition, poly_degree):
    """``cg_loop`` on ``op``'s plain lap kernels: the plain K4/K10/K11."""
    matvec, dot, lap = lap_ops(op, "torch")
    precond = make_precond(precondition, minv, matvec, dot, b, poly_degree)
    s = cg_loop(matvec, dot, lap, b, x0, tol=tol, maxiter=maxiter,
                safe_alpha=safe_alpha, precond=precond)
    return s.x, s.k, s.rslast


fused_cg_solve_torch.launches = 0


def fused_batch_cg_solve_torch(A, b, x0, *, tol, maxiter, safe_alpha=True,
                               precondition="none", minv=None):
    """Plain version of K5: ``batch_cg_loop`` with ``torch.bmm`` as the
    matvec (tpucg's non-fused batch matvec is a plain ``jnp.dot``)."""
    fused_batch_cg_solve_torch.launches += 1
    check_fused_batch(A, b, x0, precondition, minv)
    precond = None if precondition == "none" else (lambda r, act=None: minv * r)
    s = batch_cg_loop(batch_matvec(A), b, x0, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                      precond=precond)
    return s.x, s.k, s.rslast


fused_batch_cg_solve_torch.launches = 0


def fused_stencil_cg_solve_torch(b, x0, m, *, tol, maxiter, safe_alpha=True,
                                 precondition="none", poly_degree=0):
    """Plain version of K10: ``cg_loop`` on the plain stencil (a plain
    ``PoissonOperator`` on b's device)."""
    fused_stencil_cg_solve_torch.launches += 1
    check_fused_stencil(b, x0, m, precondition, poly_degree)
    op = PoissonOperator(m=m, backend="torch", device=b.device)
    return _plain_solve(op, b, x0, None, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                        precondition=precondition, poly_degree=poly_degree)


fused_stencil_cg_solve_torch.launches = 0


def fused_dia_cg_solve_torch(data, offsets, b, x0, *, tol, maxiter, safe_alpha=True,
                             precondition="none", poly_degree=0):
    """Plain version of K11: ``cg_loop`` on the plain DIA SpMV of the slab,
    jacobi's 1/diag read from its main diagonal as K11 reads it."""
    fused_dia_cg_solve_torch.launches += 1
    check_fused_dia(data, offsets, b, x0, precondition, poly_degree)
    op = DiaOperator(data=data, offsets=offsets, n=data.shape[1], backend="torch")
    minv = dia_minv(data, offsets) if precondition == "jacobi" else None
    return _plain_solve(op, b, x0, minv, tol=tol, maxiter=maxiter, safe_alpha=safe_alpha,
                        precondition=precondition, poly_degree=poly_degree)


fused_dia_cg_solve_torch.launches = 0


def fused_batch_dia_cg_solve_torch(data, offsets, b, x0, *, tol, maxiter, safe_alpha=True,
                                   precondition="none"):
    """Plain version of K12: ``batch_cg_loop`` over the batched shift-and-add
    (tpucg's ``_cg_batch_dia_xla_jit``, ``cg.py:1878``), jacobi's 1/diag read
    from each slab's main diagonal as K12 reads it."""
    fused_batch_dia_cg_solve_torch.launches += 1
    check_fused_batch_dia(data, offsets, b, x0, precondition)
    minv = dia_minv(data, offsets) if precondition == "jacobi" else None
    precond = None if minv is None else (lambda r, act=None: minv * r)
    s = batch_cg_loop(batch_dia_matvec(data, offsets), b, x0, tol=tol, maxiter=maxiter,
                      safe_alpha=safe_alpha, precond=precond)
    return s.x, s.k, s.rslast


fused_batch_dia_cg_solve_torch.launches = 0


def fused_cg_solve(A, b, x0, *, backend: str = "auto", **kw):
    """K4 for a CUDA tensor (``"auto"``), its plain version for a CPU one."""
    if resolve_backend(backend, A.device) == "cuda":
        return fused_cg_solve_cuda(A, b, x0, **kw)
    return fused_cg_solve_torch(A, b, x0, **kw)


def fused_batch_cg_solve(A, b, x0, *, backend: str = "auto", **kw):
    """K5 for a CUDA tensor (``"auto"``), its plain version for a CPU one."""
    if resolve_backend(backend, A.device) == "cuda":
        return fused_batch_cg_solve_cuda(A, b, x0, **kw)
    return fused_batch_cg_solve_torch(A, b, x0, **kw)


def fused_stencil_cg_solve(b, x0, m, *, backend: str = "auto", **kw):
    """K10 for a CUDA tensor (``"auto"``), its plain version for a CPU one."""
    if resolve_backend(backend, b.device) == "cuda":
        return fused_stencil_cg_solve_cuda(b, x0, m, **kw)
    return fused_stencil_cg_solve_torch(b, x0, m, **kw)


def fused_dia_cg_solve(data, offsets, b, x0, *, backend: str = "auto", **kw):
    """K11 for a CUDA slab (``"auto"``), its plain version for a CPU one."""
    if resolve_backend(backend, data.device) == "cuda":
        return fused_dia_cg_solve_cuda(data, offsets, b, x0, **kw)
    return fused_dia_cg_solve_torch(data, offsets, b, x0, **kw)


def fused_batch_dia_cg_solve(data, offsets, b, x0, *, backend: str = "auto", **kw):
    """K12 for a CUDA slab (``"auto"``), its plain version for a CPU one."""
    if resolve_backend(backend, data.device) == "cuda":
        return fused_batch_dia_cg_solve_cuda(data, offsets, b, x0, **kw)
    return fused_batch_dia_cg_solve_torch(data, offsets, b, x0, **kw)
