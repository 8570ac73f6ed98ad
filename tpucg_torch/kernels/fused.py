"""Whole-solve dense CG in one kernel launch: K4 for one system and K5 for a
batch of independent systems (the dense part of ``tpucg.kernels.fused``).
``csrc/fused.cu`` holds both kernels and their design note. Their plain
PyTorch versions run the same recurrence (tpucg's ``_cg_while``) through
the solver's loops, so they live above this layer, in
``tpucg_torch.solver.fused``, with the dispatchers.

Both return ``(x, k, rr)`` as tpucg's kernels do: the padded solution, the
lap count (int32) and the last r.r (f32), 0-d for one system and ``(B,)``
for a batch, on the solve's device. Nothing here reads a result back to
the host. tpucg's ``mv_impl`` chose the TPU's vector or matrix unit for the
in-kernel GEMV; it has no counterpart on the card and is dropped.
"""

from __future__ import annotations

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import cuda_stream

# Largest padded n of K4 and of K5, tpucg's caps (fused.py:55, :75), so that
# the gate means the same in both packages.
FUSED_MAX_N = 4096
FUSED_BATCH_MAX_N = 2048

# Largest padded n that fused="auto" sends to K4. tpucg's 1024 was a TPU
# crossover; this is the card's own: K4 beat the lap path at every padded n
# in {128, ..., 4096} (cg_solve per solve, generate_spd_system seed 0,
# medians of 7, each arm twice in one process; NVIDIA H100 80GB HBM3,
# 700 W): 0.15-0.39 ms against 2.1-4.4 ms. PERF.md keeps the table.
# Being equal to FUSED_MAX_N, it makes fused="auto" and fused="always" take
# the same route for every dense solve.
FUSED_AUTO_MAX_N = 4096

_PRECOND_CODE = {"none": 0, "jacobi": 1, "poly": 2}


def _check_vector(name: str, v: torch.Tensor, shape, like: torch.Tensor) -> None:
    if v.dtype != torch.float32 or tuple(v.shape) != tuple(shape) or v.device != like.device:
        raise ValueError(
            f"{name} must be f32 {tuple(shape)} on {like.device}, got {v.dtype} "
            f"{tuple(v.shape)} on {v.device}"
        )


def check_fused(A, b, x0, precondition, poly_degree, minv) -> None:
    """K4's operands, with tpucg's messages (K4's wrapper and its plain
    version both check them, so both refuse the same calls)."""
    npad = A.shape[0]
    if A.dim() != 2 or A.shape != (npad, npad):
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if npad % 128 or npad > FUSED_MAX_N:
        raise ValueError(f"fused solve needs 128-aligned n <= {FUSED_MAX_N}, got {npad}")
    if A.dtype != torch.float32:
        raise ValueError(f"fused solve is f32-only, got {A.dtype}")
    if precondition not in _PRECOND_CODE:
        raise ValueError(f"fused solve runs precondition none/jacobi/poly, got {precondition!r}")
    if precondition == "jacobi" and minv is None:
        raise ValueError("precondition='jacobi' requires minv")
    if precondition == "poly" and poly_degree < 1:
        raise ValueError("precondition='poly' requires poly_degree >= 1")
    for name, v in (("b", b), ("x0", x0)) + ((("minv", minv),) if precondition == "jacobi" else ()):
        _check_vector(name, v, (npad,), A)


def check_fused_batch(A, b, x0, precondition, minv) -> None:
    """K5's operands, with tpucg's messages (checked by K5's wrapper and its
    plain version)."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    B, npad = A.shape[0], A.shape[1]
    if npad % 128 or npad > FUSED_BATCH_MAX_N:
        raise ValueError(
            f"batched fused solve needs 128-aligned n <= {FUSED_BATCH_MAX_N}, got {npad}"
        )
    if A.dtype != torch.float32:
        raise ValueError(f"batched fused solve is f32-only, got {A.dtype}")
    if precondition not in ("none", "jacobi"):
        raise ValueError(f"batched fused solve runs precondition none/jacobi, got {precondition!r}")
    if precondition == "jacobi" and minv is None:
        raise ValueError("precondition='jacobi' requires minv")
    for name, v in (("b", b), ("x0", x0)) + ((("minv", minv),) if precondition == "jacobi" else ()):
        _check_vector(name, v, (B, npad), A)


def fused_cg_solve_cuda(A, b, x0, *, tol, maxiter, safe_alpha=True, precondition="none",
                        poly_degree=0, minv=None):
    """K4 on the card: one cooperative launch runs the whole solve.
    ``A`` is (npad, npad) f32, npad % 128 == 0 and npad <= ``FUSED_MAX_N``;
    ``b``, ``x0`` and ``minv`` (jacobi) are (npad,) f32 on A's device.
    ``precondition="poly"`` builds the truncated-Neumann polynomial of
    degree ``poly_degree`` inside the kernel (12 power iterations for
    lambda_max). Raises if the card refuses the cooperative launch."""
    check_fused(A, b, x0, precondition, poly_degree, minv)
    if A.device.type != "cuda" or not A.is_contiguous() or A.data_ptr() % 16:
        raise ValueError(f"fused_cg_solve_cuda needs a contiguous 16-byte aligned A on a "
                         f"CUDA device, got {A.device}")
    npad = A.shape[0]
    b, x0 = b.contiguous(), x0.contiguous()
    minv = minv.contiguous() if precondition == "jacobi" else None
    x = torch.empty(npad, dtype=torch.float32, device=A.device)
    k = torch.empty((), dtype=torch.int32, device=A.device)
    rr = torch.empty((), dtype=torch.float32, device=A.device)
    lib = _lib.load()
    scratch = torch.empty(int(lib.tpucg_fused_cg_scratch(npad)), dtype=torch.float32,
                          device=A.device)
    err = lib.tpucg_fused_cg_f32(
        A.data_ptr(), b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
        x.data_ptr(), k.data_ptr(), rr.data_ptr(), scratch.data_ptr(), npad, float(tol),
        int(maxiter), int(bool(safe_alpha)), _PRECOND_CODE[precondition], int(poly_degree),
        cuda_stream(A),
    )
    if err:
        _lib.check(err, "fused_cg_solve_cuda")
    fused_cg_solve_cuda.launches += 1
    return x, k, rr


fused_cg_solve_cuda.launches = 0


def fused_batch_cg_solve_cuda(A, b, x0, *, tol, maxiter, safe_alpha=True,
                              precondition="none", minv=None):
    """K5 on the card: B independent whole solves in one launch, one block
    per system. ``A`` is (B, npad, npad) f32, npad % 128 == 0 and npad <=
    ``FUSED_BATCH_MAX_N``; ``b``, ``x0`` and ``minv`` (jacobi) are (B, npad)
    f32. Returns x (B, npad), k and rr (B,)."""
    check_fused_batch(A, b, x0, precondition, minv)
    if A.device.type != "cuda" or not A.is_contiguous() or A.data_ptr() % 16:
        raise ValueError(f"fused_batch_cg_solve_cuda needs a contiguous 16-byte aligned A on "
                         f"a CUDA device, got {A.device}")
    B, npad = A.shape[0], A.shape[1]
    b, x0 = b.contiguous(), x0.contiguous()
    minv = minv.contiguous() if precondition == "jacobi" else None
    x = torch.empty((B, npad), dtype=torch.float32, device=A.device)
    k = torch.empty(B, dtype=torch.int32, device=A.device)
    rr = torch.empty(B, dtype=torch.float32, device=A.device)
    err = _lib.load().tpucg_fused_batch_cg_f32(
        A.data_ptr(), b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
        x.data_ptr(), k.data_ptr(), rr.data_ptr(), B, npad, float(tol), int(maxiter),
        int(bool(safe_alpha)), int(precondition == "jacobi"), cuda_stream(A),
    )
    if err:
        _lib.check(err, "fused_batch_cg_solve_cuda")
    fused_batch_cg_solve_cuda.launches += 1
    return x, k, rr


fused_batch_cg_solve_cuda.launches = 0
