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
therefore resumes here.

On a mesh (``sharded_cg_solve_checkpointed``,
``sharded_operator_cg_solve_checkpointed``) every rank is a process, and the
file a solve writes follows from how it was started:

- one rank: tpucg's single-process whole-state file (``_CkptIO``), so a
  file written by either package resumes in the other;
- more than one rank, the 1-D dense solve: a file per rank,
  ``<path>.proc<rank>``, tpucg's ``save_checkpoint_mp`` key for key (the
  rank's rows of x, r and p, ``row_start``, ``npad``, the replicated
  scalars, ``process_index`` and ``process_count``; ``_MpCkptIO``). It takes
  a placed ``DistributedSystem`` (``load_system_sharded``), as tpucg's
  multi-process path takes pre-sharded arrays, and refuses host arrays;
- more than one rank, the 2-D and operator solves (tpucg has only the
  single-process form of these, and every rank holds the host system):
  the whole-state file, written by rank 0 after a gather of x, r and p;
  on resume every rank reads it and keeps its own rows
  (``_GatheredCkptIO``).

Every refusal on a mesh is decided on values that every rank holds (one
gather of each rank's view: whether its file exists, the topology, the
generation), so no rank raises while another waits at a collective.
tpucg's torn-write guard (``multihost_utils.assert_equal`` of k, rsold and
rslast) is that gather, compared on every rank.
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.comm.mesh import Mesh, Mesh2D, make_mesh
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
    TorchLap,
    lap_ops,
    make_precond,
)
from tpucg_torch.solver.sharded import (
    DistributedSystem,
    DistributedSystem2D,
    _check_2d_config,
    _check_two_level_sharded,
    _dense_matvec,
    _gather_rows,
    _operator_matvec,
    _place_dense_1d,
    _precond,
    _prepare_sharded2d,
    _prepare_sharded_operator,
    _reductions,
    _summa_matvec,
    check_1d,
    check_mesh,
    operator_rhs,
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
    precondition), the state's tensors on ``device`` (default: the card,
    which raises when there is none)."""
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


# --- the multi-process file and the transports ---------------------------------


def _mp_path(path: str, rank: int) -> str:
    """Rank ``rank``'s file of a per-rank checkpoint (tpucg's ``_mp_path``)."""
    return f"{path}.proc{rank}"


def save_checkpoint_mp(path: str, state, n: int, tol: float,
                       signature: Optional[np.ndarray] = None, precondition: str = "none", *,
                       mesh: Mesh) -> None:
    """Write this rank's rows of the state (``state``'s x, r, p are the
    rank's block, tensors or NumPy arrays; the scalars replicated) to
    ``<path>.proc<rank>``, tpucg's ``save_checkpoint_mp`` key for key: x, r,
    p f32 (blk,), ``row_start`` and ``npad`` int64, rsold and rslast f32
    0-d, k int32 0-d, done bool 0-d, n int64, tol float64, the signature,
    the preconditioner's identity as bytes, ``process_index`` (the rank)
    and ``process_count`` (the world) int64. Atomic, as ``save_checkpoint``."""
    h = _host_state(state)
    blk = h["x"].shape[0]
    real = _mp_path(path, mesh.rank)
    tmp = real + ".tmp"
    np.savez(tmp, x=h["x"], r=h["r"], p=h["p"], row_start=np.int64(mesh.rank * blk),
             npad=np.int64(mesh.size * blk), rsold=h["rsold"], rslast=h["rslast"], k=h["k"],
             done=h["done"], n=np.int64(n), tol=np.float64(tol),
             signature=np.zeros(0) if signature is None else np.asarray(signature),
             precondition=np.bytes_(precondition.encode()),
             process_index=np.int64(mesh.rank), process_count=np.int64(mesh.size))
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", real)


def _gather_host(mesh: Mesh, vals) -> np.ndarray:
    """Every rank's int64 ``vals`` -> (size, len) on every rank, one gather."""
    t = torch.tensor(np.asarray(vals, np.int64), device=mesh.device)
    out = torch.empty(mesh.size * t.numel(), dtype=torch.int64, device=mesh.device)
    mesh.all_gather(out, t)
    return out.cpu().numpy().reshape(mesh.size, -1)


def _bits(v, dtype) -> int:
    """A scalar's bits as an int (NaN payloads and -0 kept apart)."""
    return int(np.asarray(v, dtype).reshape(1).view(np.int32 if dtype == np.float32
                                                    else np.int64)[0])


def load_checkpoint_mp(path: str, mesh: Mesh):
    """Read this rank's file of a per-rank checkpoint -> (state, n, tol,
    signature, precondition), the state's x, r, p the rank's rows on the
    mesh's device. Every rank gathers every rank's view of its file, then
    refuses the same way (tpucg's ``load_checkpoint_mp`` checks and its
    torn-write guard): a file missing on some ranks, another world size,
    a file of another rank or row block, or files of different generations
    (k, rsold, rslast, or the solve's identity differing)."""
    own = _mp_path(path, mesh.rank)
    meta = None
    if os.path.exists(own):
        with np.load(own) as z:
            blocks = {key: np.array(z[key], np.float32) for key in ("x", "r", "p")}
            sc = {key: np.asarray(z[key]) for key in ("k", "rsold", "rslast", "done")}
            meta = (int(z["n"]), float(z["tol"]), np.asarray(z["signature"]),
                    bytes(z["precondition"]).decode())
            view = [1, int(z["process_count"]), int(z["process_index"]), int(z["row_start"]),
                    int(z["npad"]), int(sc["k"]), _bits(sc["rsold"], np.float32),
                    _bits(sc["rslast"], np.float32), int(bool(sc["done"])), meta[0],
                    _bits(meta[1], np.float64), zlib.crc32(meta[3].encode()),
                    zlib.crc32(np.asarray(meta[2], np.float64).tobytes())]
    if meta is None:
        view = [0] * 13
    views = _gather_host(mesh, view)
    have = views[:, 0] == 1
    counts = sorted({int(c) for c in views[have, 1]})
    if any(c != mesh.size for c in counts):
        raise ValueError(f"checkpoint {path!r} was written by {counts[-1]} processes; this run "
                         f"has {mesh.size} — resume on the same topology")
    if not have.all():
        raise ValueError(f"checkpoint {path!r} is torn across processes (no file for ranks "
                         f"{np.flatnonzero(~have).tolist()}); delete and restart")
    if (views[:, 2] != np.arange(mesh.size)).any():
        bad = int(np.flatnonzero(views[:, 2] != np.arange(mesh.size))[0])
        raise ValueError(f"{_mp_path(path, bad)!r} belongs to process {int(views[bad, 2])}, "
                         f"not {bad}")
    blk = views[0, 4] // mesh.size
    if (views[:, 3] != np.arange(mesh.size) * blk).any() or (views[:, 4] != views[0, 4]).any():
        raise ValueError(f"checkpoint {path!r}'s row blocks do not cover this mesh's ranks "
                         "— mesh layout changed")
    if (views[:, 5:] != views[0, 5:]).any():
        raise ValueError(f"checkpoint {path!r} is torn across processes (per-process files "
                         "carry different iteration states); delete and restart")
    dev = mesh.device

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
    state = _State(k=put(sc["k"], np.int32), x=put(blocks["x"], np.float32),
                   r=put(blocks["r"], np.float32), p=put(blocks["p"], np.float32),
                   rsold=put(sc["rsold"], np.float32), rslast=put(sc["rslast"], np.float32),
                   done=put(sc["done"], np.bool_))
    return (state,) + meta


def _agreed(mesh: Mesh, flag: bool, what: str) -> bool:
    """A flag every rank must hold alike, gathered: the same on every rank,
    or the same ``ValueError`` on every rank."""
    flags = _gather_host(mesh, [int(bool(flag))])[:, 0]
    if flags.min() != flags.max():
        raise ValueError(f"{what} on ranks {np.flatnonzero(flags).tolist()} only; every rank "
                         "must see the same checkpoint")
    return bool(flags[0])


def _barrier(mesh: Mesh) -> None:
    _gather_host(mesh, [0])


class _CkptIO:
    """One process: tpucg's whole-state file (``save_checkpoint``). ``load``
    returns the file's state, n, tol, signature, identity and padded
    size."""

    def __init__(self, device):
        self.device = device

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def to_host(self, state: _State) -> dict:
        return _state_to_host(state)

    def save(self, path: str, host: dict, n: int, tol: float, signature, precondition) -> None:
        save_checkpoint(path, host, n, tol, signature=signature, precondition=precondition)

    def load(self, path: str):
        state, n, tol, sig, pre = load_checkpoint(path, self.device)
        return state, n, tol, sig, pre, int(state.x.shape[0])

    def remove(self, path: str) -> None:
        if os.path.exists(path):
            os.remove(path)


class _MpCkptIO(_CkptIO):
    """More than one rank, the 1-D dense solve: a file per rank
    (``save_checkpoint_mp``); the state's vectors are the rank's rows."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh.device)
        self.mesh = mesh

    def exists(self, path: str) -> bool:
        # A file on some ranks only is decided by the load's gather.
        flags = _gather_host(self.mesh, [int(os.path.exists(_mp_path(path, self.mesh.rank)))])
        return bool(flags.max())

    def save(self, path, host, n, tol, signature, precondition) -> None:
        save_checkpoint_mp(path, host, n, tol, signature, precondition, mesh=self.mesh)
        _barrier(self.mesh)

    def load(self, path: str):
        state, n, tol, sig, pre = load_checkpoint_mp(path, self.mesh)
        return state, n, tol, sig, pre, int(state.x.shape[0]) * self.mesh.size

    def remove(self, path: str) -> None:
        super().remove(_mp_path(path, self.mesh.rank))
        _barrier(self.mesh)


class _GatheredCkptIO(_CkptIO):
    """More than one rank, the 2-D and operator solves: the whole-state file,
    written by rank 0 after a gather of x, r and p; on resume every rank
    reads it and keeps its own rows (a chunk of npad / size)."""

    def __init__(self, mesh):
        super().__init__(mesh.device)
        self.mesh = mesh

    def exists(self, path: str) -> bool:
        return _agreed(self.mesh, os.path.exists(path), f"checkpoint {path!r} exists")

    def to_host(self, state: _State) -> dict:
        g = lambda v: _gather_rows(self.mesh, v)  # noqa: E731
        return _state_to_host(state._replace(x=g(state.x), r=g(state.r), p=g(state.p)))

    def save(self, path, host, n, tol, signature, precondition) -> None:
        if self.mesh.rank == 0:
            super().save(path, host, n, tol, signature, precondition)
        _barrier(self.mesh)

    def load(self, path: str):
        state, n, tol, sig, pre, npad = super().load(path)
        if npad % self.mesh.size == 0:
            blk = npad // self.mesh.size
            rows = slice(self.mesh.rank * blk, (self.mesh.rank + 1) * blk)
            state = state._replace(x=state.x[rows].clone(), r=state.r[rows].clone(),
                                   p=state.p[rows].clone())
        return state, n, tol, sig, pre, npad

    def remove(self, path: str) -> None:
        if self.mesh.rank == 0:
            super().remove(path)
        _barrier(self.mesh)


def _io_for(mesh, per_rank: bool = False) -> _CkptIO:
    """The transport of a solve on ``mesh`` (the module docstring's rule)."""
    if mesh.size == 1:
        return _CkptIO(mesh.device)
    return _MpCkptIO(mesh) if per_rank else _GatheredCkptIO(mesh)


# --- the segment driver --------------------------------------------------------


def _resume_or_none(checkpoint_path: Optional[str], *, n: int, npad: int, tol: float,
                    precondition: str, sig_fn: Callable[[], np.ndarray], io: _CkptIO):
    """Load and check an existing file through the transport ``io`` ->
    (state or None, its signature or None). Refuses another size or
    padding, another tol, another preconditioner identity and another
    system (the probe signature). On a mesh every rank holds the same
    file's values (``io.load`` refuses otherwise), so every rank decides
    alike."""
    if checkpoint_path is None or not io.exists(checkpoint_path):
        return None, None
    state, n_ck, tol_ck, sig_ck, pre_ck, npad_ck = io.load(checkpoint_path)
    if n_ck != n or npad_ck != npad:
        raise ValueError(f"checkpoint {checkpoint_path!r} is for n={n_ck} (padded "
                         f"({npad_ck},)); this system is n={n} (padded ({npad},))")
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
                    sig_fn: Callable[[], np.ndarray], io: _CkptIO,
                    whole: Callable = lambda v: v) -> CGResult:
    """Run ``segment_fn(state, k_now, k_target) -> state`` until the solve
    stops or reaches ``maxiter``, writing the file through ``io`` after
    every segment; the file is removed once the solve is done (converged,
    or stopped on stagnation, as tpucg's), so a capped exit leaves it for a
    later resume. The host reads k and done once a segment, with the file's
    copy when there is a file. ``whole`` gathers a sharded x whole."""
    k_now, done = int(state.k), bool(state.done)
    while not done and k_now < maxiter:
        k_target = min(k_now + segment_iters, maxiter)
        state = segment_fn(state, k_now, k_target)
        if checkpoint_path is not None:
            host = io.to_host(state)
            if sig is None:
                sig = sig_fn()
            io.save(checkpoint_path, host, n, tol, sig, precondition)
            k_now, done = int(host["k"]), bool(host["done"])
        else:
            k_now, done = (int(v) for v in torch.stack(
                [state.k.to(torch.int32), state.done.to(torch.int32)]).cpu())
    if checkpoint_path is not None and not keep_checkpoint and done:
        io.remove(checkpoint_path)
    tol2 = torch.tensor(tol, dtype=torch.float32, device=state.rslast.device) ** 2
    # Under the true-residual check done also fires on stagnation: converged
    # is the last r.r (the last check's there) against tol.
    return CGResult(x=whole(state.x)[:n], iterations=state.k, residual_norm=state.rslast.sqrt(),
                    converged=state.done & (state.rslast < tol2))


# The serial preconditioners a segment can resume under (the two-level
# cycle runs with precondition="none").
CHECKPOINT_PRECONDITIONERS = ("none", "jacobi", "block_jacobi")


def _validate_checkpoint_config(config: CGConfig, segment_iters: int,
                                allowed=CHECKPOINT_PRECONDITIONERS) -> None:
    if segment_iters < 1:
        raise ValueError("segment_iters must be >= 1")
    if config.method != "cg":
        raise ValueError("checkpointed solves support method='cg' only (the pipelined state "
                         "is not checkpointable)")
    if config.precondition not in allowed:
        raise ValueError("this checkpointed solver supports precondition in "
                         f"{allowed} (a "
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

    io = _CkptIO(device)
    state, sig = _resume_or_none(checkpoint_path, n=n, npad=npad, tol=tol,
                                 precondition=pre_id, sig_fn=sig_fn, io=io)
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
                           sig=sig, sig_fn=sig_fn, io=io)


# --- the checkpoint on a mesh -------------------------------------------------


def _sharded_signature(matvec, mesh, b_blk: torch.Tensor) -> np.ndarray:
    """``system_signature`` through a sharded matvec (tpucg's probe under
    several processes, ``checkpoint.py:925-936``): this rank's rows of the
    probe through the product, the response and b gathered whole, then
    projected; the same bits on every rank."""
    blk = b_blk.shape[0]
    npad = blk * mesh.size
    probe, R = _signature_probe_and_R(npad)
    y = matvec(torch.from_numpy(probe[mesh.rank * blk:(mesh.rank + 1) * blk]).to(b_blk.device),
               None)
    y_full = _gather_rows(mesh, y).cpu().numpy().astype(np.float64)
    b_full = _gather_rows(mesh, b_blk).cpu().numpy().astype(np.float64)
    return _project_signature(R, y_full, b_full)


def _sharded_segments(matvec, mesh, backend: str, b_blk, x0_blk, diag, config: CGConfig, *,
                      n: int, pre_id: str, segment_iters: int, checkpoint_path, keep_checkpoint,
                      io: _CkptIO, two_level=None) -> CGResult:
    """The segmented solve on this rank's rows with the sharded closures (the
    counterparts of tpucg's ``_sharded_init_jit`` and
    ``_sharded_segment_jit``): ``init_state`` on a fresh start, then
    ``cg_loop`` a segment at a time with the stagnation carry in memory
    (under ``two_level`` the true-residual check every
    ``TRUE_CHECK_EVERY`` laps), x gathered whole at the end."""
    red = _reductions(mesh, backend, b_blk)
    precond = _precond(matvec, mesh, backend, red, b_blk, diag, None, config, two_level)
    tol = float(config.tol)
    npad = b_blk.shape[0] * mesh.size
    maxiter = int(config.maxiter if config.maxiter is not None else n)

    def sig_fn():
        return _sharded_signature(matvec, mesh, b_blk)

    state, sig = _resume_or_none(checkpoint_path, n=n, npad=npad, tol=tol, precondition=pre_id,
                                 sig_fn=sig_fn, io=io)
    if state is None:
        state = init_state(matvec, red.dot, b_blk, x0_blk, tol, precond=precond)
    lap = TorchLap(red.dot, red.update)
    stag = [None]

    def segment_fn(st, k_now, k_target):
        st, stag[0] = cg_loop(
            matvec, red.dot, lap, b_blk, None, tol=tol, maxiter=k_target,
            safe_alpha=bool(config.safe_alpha), state=st, precond=precond,
            chunk=min(k_target - k_now, CHUNK_MAX),
            check_true_every=TRUE_CHECK_EVERY if two_level is not None else None,
            stag_carry=stag[0], return_stag=True)
        return st

    return _drive_segments(state, segment_fn, n=n, tol=tol, maxiter=maxiter,
                           segment_iters=segment_iters, precondition=pre_id,
                           checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
                           sig=sig, sig_fn=sig_fn, io=io,
                           whole=lambda v: _gather_rows(mesh, v))


def sharded_cg_solve_checkpointed(
    A,
    b=None,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    segment_iters: int = 128,
    checkpoint_path: Optional[str] = None,
    keep_checkpoint: bool = False,
    n: Optional[int] = None,
    **overrides,
) -> CGResult:
    """The distributed dense solve in segments with a resumable file
    (tpucg's ``sharded_cg_solve_checkpointed``, ``checkpoint.py:794``): the
    semantics of ``cg_solve_checkpointed`` (method cg, f32, precondition
    none or jacobi; a resume equals the uninterrupted solve bit for bit),
    the laps of ``sharded_cg_solve`` and its x bit for bit, the identity
    probe through the distributed product.

    On a 1-D ``Mesh`` ``A`` is the host matrix (one rank only) or the
    rank's ``DistributedSystem`` (``load_system_sharded`` or
    ``distribute_system``; ``b`` and ``x0`` then not passed, ``n`` the
    logical size to trim x to). One rank writes the whole-state file, more
    ranks a file each (the module docstring's rule) and refuse host arrays
    in tpucg's words. On a ``Mesh2D`` ``A``, ``b`` and ``x0`` are host
    arrays (tpucg's 2-D arm, ``checkpoint.py:1121``); the file is the
    whole-state one."""
    config = _configure(config, overrides)
    _validate_checkpoint_config(config, segment_iters, allowed=("none", "jacobi"))
    mesh = make_mesh() if mesh is None else mesh
    check_mesh(mesh)
    backend = resolve_backend(config.kernel, mesh.device)
    if isinstance(mesh, Mesh2D):
        if n is not None or isinstance(A, (DistributedSystem, DistributedSystem2D)):
            raise ValueError("2-D checkpointing takes host arrays (the column permutation is "
                             "applied at distribution)")
        _check_2d_config(config)
        system, diag, n = _prepare_sharded2d(A, b, x0, mesh, config)
        return _sharded_segments(
            _summa_matvec(system.A, mesh, backend), mesh, backend, system.b, system.x0, diag,
            config, n=n, pre_id=config.precondition, segment_iters=segment_iters,
            checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
            io=_io_for(mesh))
    if not isinstance(A, DistributedSystem):
        if mesh.size > 1:
            raise ValueError("multi-process checkpointing takes pre-sharded device arrays (use "
                             "load_system_sharded); a host-array input would make every host "
                             "materialize all of A")
        if n is not None and n != np.shape(A)[0]:
            raise ValueError("n override is for pre-sharded device inputs")
    system, n, diag = _place_dense_1d(A, b, x0, mesh, config, n)
    return _sharded_segments(
        _dense_matvec(system.A, system.strategy, mesh, backend), mesh, backend, system.b,
        system.x0, diag, config, n=n, pre_id=config.precondition, segment_iters=segment_iters,
        checkpoint_path=checkpoint_path, keep_checkpoint=keep_checkpoint,
        io=_io_for(mesh, per_rank=True))


def sharded_operator_cg_solve_checkpointed(
    op,
    b=None,
    x0=None,
    mesh=None,
    config: Optional[CGConfig] = None,
    *,
    segment_iters: int = 128,
    checkpoint_path: Optional[str] = None,
    keep_checkpoint: bool = False,
    two_level=None,
    **overrides,
) -> CGResult:
    """The distributed sparse and stencil solves in segments with a
    resumable file (tpucg's ``sharded_operator_cg_solve_checkpointed``,
    ``checkpoint.py:973``): the operators and padding of
    ``sharded_operator_cg_solve`` (Poisson slab halos, K9; DIA band halos,
    K7; ELL; BSR; a CSR or a ``WellShardedSystem`` as sharded WELL, K13),
    precondition none or jacobi, or ``two_level`` (built for the sharded
    padding, its aggregates dividing a rank's rows) with the true-residual
    check every ``TRUE_CHECK_EVERY`` laps and the stagnation carry passed
    from segment to segment in memory (a killed and resumed solve restarts
    it and may stop up to two check windows later). 1-D meshes only; the
    file is the whole-state one (the module docstring's rule)."""
    config = _configure(config, overrides)
    _validate_checkpoint_config(config, segment_iters, allowed=("none", "jacobi"))
    mesh = make_mesh() if mesh is None else mesh
    check_1d(mesh, "operator checkpointing runs on 1-D meshes")
    backend = resolve_backend(config.kernel, mesh.device)
    sop = _prepare_sharded_operator(op, mesh, config)
    pre_id = config.precondition
    if two_level is not None:
        if config.precondition != "none":
            raise ValueError(f"two_level runs as THE preconditioner (got "
                             f"precondition={config.precondition!r})")
        _check_two_level_sharded(two_level, config, sop.npad, mesh)
        if checkpoint_path is not None:
            pre_id = _two_level_identity(two_level)
    b_blk, x0_blk = operator_rhs(op, sop, b, x0, mesh)
    return _sharded_segments(
        _operator_matvec(sop, mesh, backend), mesh, backend, b_blk, x0_blk, sop.diag, config,
        n=sop.n, pre_id=pre_id, segment_iters=segment_iters, checkpoint_path=checkpoint_path,
        keep_checkpoint=keep_checkpoint, io=_io_for(mesh), two_level=two_level)
