"""Checkpoint and resume for long CG solves (the serial part of
``tpucg.solver.checkpoint``).

The whole state of a classic CG solve is small and explicit: (k, x, r, p,
rsold, rslast, done). ``cg_solve_checkpointed`` runs the solve in segments
of ``segment_iters`` laps, each one ``cg_loop`` call on the state the last
one left (the chunk runner reads the device once a chunk, never a lap),
and after each segment copies the state to the host in one transfer and
writes it as an atomic ``.npz``. Run again with the same file, it resumes
from the recorded lap. The resumed trajectory is the uninterrupted one bit
for bit: f32 state is saved exactly, and every preconditioner it takes is
deterministic.

The file is tpucg's, key for key, dtype for dtype and shape for shape
(``save_checkpoint``), so a file written by either package resumes in the
other. It records n, tol, the preconditioner's identity and random
projections of A applied to a fixed pseudorandom probe, and of b
(``system_signature``); a resume refuses a mismatch in any of them (a
Jacobi state's rsold carries r.z, not r.r, so a resume under another
preconditioner would corrupt the recurrence). The probe and the
projections come from tpucg's rng stream, and the signatures are compared
with a relative tolerance per block (``signatures_match``): kernels that
sum in another order perturb the probe response at ~1e-7, another system
by O(1).

A bare ``CSRMatrix`` is promoted by ``best_sparse_operator`` (DIA, BSR or
WELL), as tpucg's checkpointed solve promotes it, while ``cg_solve`` and
``as_operator`` map a CSR to ELL; a file tpucg wrote for a bare CSR
therefore resumes here. The multi-process checkpoint is ROADMAP M14 step 6.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.config import CGConfig
from tpucg_torch.kernels.dispatch import canonical_device, resolve_backend
from tpucg_torch.solver.cg import (
    CHUNK_MAX,
    TRUE_CHECK_EVERY,
    CGResult,
    _check_two_level,
    _configure,
    _require_backend,
    _solve_operator,
    _State,
    block_jacobi_minv,
    cg_loop,
    init_state,
    lap_ops,
    make_precond,
)


def _signature_probe_and_R(npad: int):
    """The probe vector (npad,) f32 and the (4, npad) projection (tpucg's
    rng stream, seed 0xC6)."""
    rng = np.random.default_rng(0xC6)
    probe = rng.standard_normal(npad).astype(np.float32)
    R = rng.standard_normal((4, npad))
    return probe, R


def _project_signature(R: np.ndarray, y: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate([R @ np.asarray(y, np.float64), R @ np.asarray(b, np.float64)])


def system_signature(op, b) -> np.ndarray:
    """Random projections of A applied to the probe, then of b (padded
    length, a NumPy array or a tensor). ``op`` is an operator (its
    ``matvec`` runs on its device) or a bare matvec taking a tensor."""
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    npad = b.shape[0]
    probe, R = _signature_probe_and_R(npad)
    mv = op.matvec if hasattr(op, "matvec") else op
    device = getattr(op, "device", "cpu")
    y = mv(torch.from_numpy(probe).to(device))
    return _project_signature(R, y.detach().cpu().numpy().astype(np.float64),
                              b.astype(np.float64))


def signatures_match(a: np.ndarray, b: np.ndarray, rtol: float = 1e-4) -> bool:
    """Each half (the A block, the b block) within ``rtol`` of its own
    scale: a changed b must not hide under the A block's tolerance."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    half = a.size // 2
    for sl in (slice(0, half), slice(half, None)):
        sa, sb = a[sl], b[sl]
        scale = float(np.max(np.maximum(np.abs(sa), np.abs(sb)))) + 1e-30
        if not np.all(np.abs(sa - sb) <= rtol * scale):
            return False
    return True


# --- the file ----------------------------------------------------------------


_FILE_DTYPES = dict(x=np.float32, r=np.float32, p=np.float32, rsold=np.float32,
                   rslast=np.float32, k=np.int32, done=np.bool_)


def _host_state(state) -> dict:
    """The seven fields of a ``_State`` (or a dict of them) as NumPy arrays
    in the file's dtypes."""
    def host(name):
        v = state[name] if isinstance(state, dict) else getattr(state, name)
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.asarray(v, _FILE_DTYPES[name])

    return {name: host(name) for name in _FILE_DTYPES}


def save_checkpoint(path: str, state, n: int, tol: float,
                    signature: Optional[np.ndarray] = None,
                    precondition: str = "none") -> None:
    """Write the state (tensors on any device, or NumPy arrays) as tpucg's
    ``.npz``: x, r, p f32 (npad,), rsold and rslast f32 0-d, k int32 0-d,
    done bool 0-d, n int64, tol float64, the signature (empty when None)
    and the preconditioner's identity as bytes. Atomic: written to
    ``path + ".tmp"`` and renamed, so a crash mid-write leaves no torn
    file."""
    tmp = path + ".tmp"
    np.savez(tmp, **_host_state(state), n=np.int64(n), tol=np.float64(tol),
             signature=np.zeros(0) if signature is None else np.asarray(signature),
             precondition=np.bytes_(precondition.encode()))
    # np.savez appends .npz to a path without it.
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str, device=None):
    """Read a file of either package -> (state, n, tol, signature,
    precondition), the state's tensors on ``device`` (default: the card
    when there is one)."""
    device = canonical_device(device)
    with np.load(path) as z:
        def put(name, dtype):
            return torch.from_numpy(np.array(z[name], dtype=dtype)).to(device)

        state = _State(k=put("k", np.int32), x=put("x", np.float32), r=put("r", np.float32),
                       p=put("p", np.float32), rsold=put("rsold", np.float32),
                       rslast=put("rslast", np.float32), done=put("done", np.bool_))
        sig = np.asarray(z["signature"]) if "signature" in z else np.zeros(0)
        pre = bytes(z["precondition"]).decode() if "precondition" in z else "none"
        return state, int(z["n"]), float(z["tol"]), sig, pre


def _state_to_host(state: _State) -> dict:
    """A segment's state on the host: the seven fields packed into one f32
    buffer on the device (k and done by their bits), copied in one transfer
    once the stream has done the segment, and unpacked."""
    x = state.x
    npad = x.shape[0]
    # k rides as its raw int32 bits (a denormal f32): the packed buffer may
    # only be copied, never computed on, or k is lost.
    packed = torch.cat([x, state.r, state.p, state.rsold.reshape(1), state.rslast.reshape(1),
                        state.k.to(torch.int32).reshape(1).view(torch.float32),
                        state.done.to(torch.float32).reshape(1)])
    h = packed.cpu().numpy()  # synchronizes with the segment's stream
    return dict(x=h[:npad], r=h[npad:2 * npad], p=h[2 * npad:3 * npad],
                rsold=np.float32(h[3 * npad]), rslast=np.float32(h[3 * npad + 1]),
                k=np.int32(h[3 * npad + 2:3 * npad + 3].view(np.int32)[0]),
                done=np.bool_(h[3 * npad + 3] != 0))


# --- the segment driver --------------------------------------------------------


def _resume_or_none(checkpoint_path: Optional[str], *, n: int, npad: int, tol: float,
                    precondition: str, sig_fn: Callable[[], np.ndarray], device):
    """Load and check an existing file -> (state or None, its signature or
    None). Refuses another size or padding, another tol, another
    preconditioner identity and another system (the probe signature)."""
    if checkpoint_path is None or not os.path.exists(checkpoint_path):
        return None, None
    state, n_ck, tol_ck, sig_ck, pre_ck = load_checkpoint(checkpoint_path, device)
    if n_ck != n or tuple(state.x.shape) != (npad,):
        raise ValueError(f"checkpoint {checkpoint_path!r} is for n={n_ck} (padded "
                         f"{tuple(state.x.shape)}); this system is n={n} (padded ({npad},))")
    if tol_ck != tol:
        raise ValueError(f"checkpoint tol {tol_ck} != requested tol {tol}")
    if pre_ck != precondition:
        raise ValueError(f"checkpoint {checkpoint_path!r} was written under "
                         f"precondition={pre_ck!r}; resuming with {precondition!r} would corrupt "
                         "the recurrence (rsold carries r.z under Jacobi, r.r without)")
    sig = sig_fn()
    if sig_ck.size and not signatures_match(sig_ck, sig):
        raise ValueError(f"checkpoint {checkpoint_path!r} was written for a DIFFERENT system "
                         "(A/b probe-signature mismatch beyond tolerance); refusing to resume")
    return state, sig


def _drive_segments(state: _State, segment_fn: Callable, *, n: int, tol: float, maxiter: int,
                    segment_iters: int, precondition: str, checkpoint_path: Optional[str],
                    keep_checkpoint: bool, sig: Optional[np.ndarray],
                    sig_fn: Callable[[], np.ndarray]) -> CGResult:
    """Run ``segment_fn(state, k_now, k_target) -> state`` until the solve
    stops or reaches ``maxiter``, writing the file after every segment; the
    file is removed once the solve is done (converged, or stopped on
    stagnation, as tpucg's), so a capped exit leaves it for a later resume.
    The host reads k and done once a segment, with the file's copy when
    there is a file."""
    k_now, done = int(state.k), bool(state.done)
    while not done and k_now < maxiter:
        k_target = min(k_now + segment_iters, maxiter)
        state = segment_fn(state, k_now, k_target)
        if checkpoint_path is not None:
            host = _state_to_host(state)
            if sig is None:
                sig = sig_fn()
            save_checkpoint(checkpoint_path, host, n, tol, signature=sig,
                            precondition=precondition)
            k_now, done = int(host["k"]), bool(host["done"])
        else:
            k_now, done = (int(v) for v in torch.stack(
                [state.k.to(torch.int32), state.done.to(torch.int32)]).cpu())
    if (checkpoint_path is not None and not keep_checkpoint and done
            and os.path.exists(checkpoint_path)):
        os.remove(checkpoint_path)
    tol2 = torch.tensor(tol, dtype=torch.float32, device=state.rslast.device) ** 2
    # Under the true-residual check done also fires on stagnation: converged
    # is the last r.r (the last check's there) against tol.
    return CGResult(x=state.x[:n], iterations=state.k, residual_norm=state.rslast.sqrt(),
                    converged=state.done & (state.rslast < tol2))


# The serial preconditioners a segment can resume under (the two-level
# cycle runs with precondition="none").
CHECKPOINT_PRECONDITIONERS = ("none", "jacobi", "block_jacobi")


def _validate_checkpoint_config(config: CGConfig, segment_iters: int) -> None:
    if segment_iters < 1:
        raise ValueError("segment_iters must be >= 1")
    if config.method != "cg":
        raise ValueError("checkpointed solves support method='cg' only (the pipelined state "
                         "is not checkpointable)")
    if config.precondition not in CHECKPOINT_PRECONDITIONERS:
        raise ValueError("this checkpointed solver supports precondition in "
                         f"{CHECKPOINT_PRECONDITIONERS} (a "
                         "resumed poly preconditioner would re-estimate lambda_max and diverge "
                         "from the saved trajectory; block_jacobi is serial-only so far)")
    if config.dtype != torch.float32:
        raise ValueError("checkpointed solves are float32-only (checkpoints store f32 state "
                         "exactly)")


def _two_level_identity(tl) -> str:
    """The preconditioner identity of a two-level cycle (tpucg's string,
    byte for byte): its layout and low-precision random projections of
    ``acinv`` and ``dinv``. The multilevel form holds a (1, 1) zero there,
    so its ``coarse_max`` does not show (a known fault of the reference,
    kept so that files interoperate)."""
    acinv = tl.acinv.detach().cpu().numpy().astype(np.float64)
    dinv = tl.dinv.detach().cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(0x2F)
    u = rng.standard_normal(acinv.shape[0])
    v = rng.standard_normal(acinv.shape[0])
    w = rng.standard_normal(dinv.shape[0])
    return (f"two_level[agg={tl.agg},om={tl.omega:g},sd={tl.smooth_degree},"
            f"sa={tl.smooth_alpha:g},npad={tl.npad},"
            f"a={float(u @ acinv @ v):.3e},d={float(w @ dinv):.3e}]")


def _basis_identity(basis) -> str:
    """A deflation basis's low-precision content digest (tpucg's string):
    a resume under another recycled stack would run another recurrence."""
    W = basis.W.detach().cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(0x5D)
    u = rng.standard_normal(W.shape[0])
    v = rng.standard_normal(W.shape[1])
    return f"deflated[m={W.shape[1]},w={float(u @ W @ v):.3e}]"


def _serial_precond(precondition, minv, matvec, dot, b, two_level,
                    basis=None) -> Optional[Callable]:
    """The segments' preconditioner: the two-level cycle (deterministic: its
    power estimates start from a fixed oscillation), else ``make_precond``'s
    Jacobi or block Jacobi, with the deflation projection around it when
    ``basis`` is given."""
    if two_level is not None:
        from tpucg_torch.solver.twolevel import make_two_level_precond

        base = make_two_level_precond(two_level, matvec, dot, b)
    else:
        base = make_precond(precondition, minv, matvec, dot, b, 0)
    if basis is not None:
        from tpucg_torch.solver.deflation import _deflate_precond

        return _deflate_precond(basis, base)
    return base


def _checkpoint_operator(A, kernel: str, device):
    """A bare CSR through ``best_sparse_operator`` (tpucg's checkpointed
    route), anything else as ``cg_solve`` takes it."""
    if type(A).__name__ != "CSRMatrix":
        return _solve_operator(A, kernel, device)
    from tpucg_torch.solver.operators import best_sparse_operator

    device = canonical_device(device)
    backend = resolve_backend(kernel, device)
    op = best_sparse_operator(A, backend=backend, device=device)
    _require_backend(op, backend)
    return op, backend, device


def cg_solve_checkpointed(
    A,
    b,
    x0=None,
    config: Optional[CGConfig] = None,
    *,
    segment_iters: int = 128,
    checkpoint_path: Optional[str] = None,
    keep_checkpoint: bool = False,
    two_level=None,
    basis=None,
    device=None,
    **overrides,
) -> CGResult:
    """Solve A x = b (tpucg's ``cg_solve_checkpointed``), writing the state
    to ``checkpoint_path`` every ``segment_iters`` laps.

    If the file exists, the solve resumes from it (size, tol,
    preconditioner and A/b probe signature must match); it is removed on
    convergence unless ``keep_checkpoint``. Otherwise as ``cg_solve`` with
    ``fused="never"``: method cg, f32, precondition none, jacobi or
    block_jacobi, the lap path (no whole-solve kernel), with the same laps
    and x bit for bit. ``A`` is what ``cg_solve`` takes, except that a bare
    ``CSRMatrix`` is promoted by ``best_sparse_operator`` (DIA, BSR or
    WELL; ``cg_solve`` maps it to ELL). ``two_level`` (``build_two_level``
    for the operator's padded size, ``precondition="none"``) runs the
    segments under the cycle with the true-residual check every
    ``TRUE_CHECK_EVERY`` laps; the stagnation carry passes from segment to
    segment in memory, not in the file, so a killed and resumed solve
    restarts it and may stop up to two check windows later than one run
    through. ``basis`` (``build_deflation_basis``) runs the deflated
    recurrence (``cg_solve_deflated``): the Galerkin warm start on a fresh
    start only, the projection around the base preconditioner. Each
    segment is one ``cg_loop`` call (a chunk the segment, at most
    ``CHUNK_MAX`` laps a host read), and the host reads the state once a
    segment."""
    config = _configure(config, overrides)
    _validate_checkpoint_config(config, segment_iters)
    op, backend, device = _checkpoint_operator(A, config.kernel, device)
    n, npad = op.n, op.padded_n
    maxiter = int(config.maxiter if config.maxiter is not None else n)
    tol = float(config.tol)
    minv = None
    pre_id = config.precondition
    if two_level is not None:
        _check_two_level(two_level, config, torch.float32, npad, device)
    elif config.precondition == "jacobi":
        d = op.diagonal()
        minv = torch.where(d != 0, 1.0 / d, 1.0).to(torch.float32)
    elif config.precondition == "block_jacobi":
        # The block size is part of the identity: a resume across sizes would
        # run another recurrence.
        minv = block_jacobi_minv(op, int(config.pc_block_size))
        pre_id = f"block_jacobi[bs={int(config.pc_block_size)}]"
    if basis is not None and basis.W.shape[0] != npad:
        raise ValueError(f"basis was built for padded size {basis.W.shape[0]}, operator has "
                         f"{npad}")
    if checkpoint_path is not None:
        # The digests read the cycle's and the basis's contents on the host
        # (tens of MB for a two-level acinv): only a file needs them.
        if two_level is not None:
            pre_id = _two_level_identity(two_level)
        if basis is not None:
            pre_id = _basis_identity(basis) + "+" + pre_id

    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
    if npad != n:
        b = F.pad(b, (0, npad - n))

    def sig_fn():
        return system_signature(op, b)

    state, sig = _resume_or_none(checkpoint_path, n=n, npad=npad, tol=tol,
                                 precondition=pre_id, sig_fn=sig_fn, device=device)
    matvec, dot, lap = lap_ops(op, backend)
    precond = _serial_precond(config.precondition, minv, matvec, dot, b, two_level, basis)
    if state is None:
        x0 = (torch.zeros(n, dtype=torch.float32, device=device) if x0 is None
              else torch.as_tensor(x0, dtype=torch.float32, device=device))
        if x0.shape != (n,):
            raise ValueError(f"x0 must have shape ({n},), got {tuple(x0.shape)}")
        if npad != n:
            x0 = F.pad(x0, (0, npad - n))
        if basis is not None:
            # The Galerkin warm start, x0 += W Ginv W^T r0: fresh starts only
            # (a resumed state carries its own trajectory).
            r0 = b - matvec(x0, None)
            x0 = x0 + torch.mv(basis.W, torch.mv(basis.Ginv, torch.mv(basis.W.T, r0)))
        state = init_state(matvec, dot, b, x0, tol, precond=precond)

    replace_every = replace_fn = None
    if basis is not None and two_level is not None:
        # The deflation x two-level recurrence as cg_solve_deflated runs it.
        from tpucg_torch.solver.deflation import DEFLATED_REPLACE_EVERY, _galerkin_refresh

        replace_every = DEFLATED_REPLACE_EVERY
        if DEFLATED_REPLACE_EVERY:
            replace_fn = _galerkin_refresh(basis)
    stag = [None]  # the stagnation carry, in memory: (inf, False) on every call

    def segment_fn(st, k_now, k_target):
        st, stag[0] = cg_loop(
            matvec, dot, lap, b, None, tol=tol, maxiter=k_target,
            safe_alpha=bool(config.safe_alpha), state=st, precond=precond,
            chunk=min(k_target - k_now, CHUNK_MAX),
            replace_every=replace_every, replace_fn=replace_fn,
            check_true_every=TRUE_CHECK_EVERY if two_level is not None else None,
            stag_carry=stag[0], return_stag=True)
        return st

    return _drive_segments(state, segment_fn, n=n, tol=tol, maxiter=maxiter,
                           segment_iters=segment_iters, precondition=pre_id,
                           checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
                           sig=sig, sig_fn=sig_fn)
