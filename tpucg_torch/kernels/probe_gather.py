"""The gather probes of ``benchmarks/probe_gather.py``, P1-P7, as Hopper
kernels; ``csrc/probe.cu`` holds them and their design note.

On the TPU the probes asked which gathers Mosaic lowers inside a kernel
and how fast they run, and their answers chose K13's layout. Here they
measure where a gather should read from on an H100, for K13's redesign. No
solve runs them. All rows are 128 f32 wide and all indices int32:

- P1 ``lane_gather``: ``o[i, j] = v[i, idx[i, j]]`` (a lane gather in
  shared memory); P7 (the script's ``lg_big``) is the same function, and
  kernel, over 8192 rows.
- P2 ``sub_gather``: ``o[i, j] = v[idx[i, j], j]`` (a gather down the
  columns).
- P3 ``row_gather``: ``o[i, :] = x2[ridx[i], :]`` (whole rows).
- P4 ``elem_gather``: ``o = xf[eidx]`` (single elements of a flat vector).
- P5 ``dynslice``: ``o = sum_k x2[w[k]:w[k] + 8, :]``, summed in k order
  from 0 (windows at offsets known only at run time).
- P6 ``roll_dyn``: ``o[i, j] = x[i, (j - s) mod 128]`` with ``s`` a
  one-element int32 tensor read by the kernel (``pltpu.roll``'s direction,
  which is ``jnp.roll``'s).

Each probe has a checked ``*_cuda`` wrapper, a plain ``*_torch`` version
(no read back to the host) and a dispatcher that sends CUDA tensors to the
kernel and CPU tensors to the plain version. Every wrapper and plain
version counts its calls in ``.launches``. Indices are not checked, on
the card or off it, as the TPU probes did not check them: an index out of
range reads outside the table on the card and raises in the plain version.
"""

from __future__ import annotations

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import cuda_stream, resolve_backend

LANE = 128
WINDOW = 8          # rows of a P5 window
MAX_WINDOWS = 1024  # P5 windows a launch (csrc/probe.cu kMaxWindows)


def _check(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """``t`` is a contiguous, non-empty ``dtype`` tensor of ``shape`` (None:
    any extent on that axis)."""
    ok = (t.dtype == dtype and t.dim() == len(shape) and t.is_contiguous() and t.numel() > 0
          and all(want is None or want == got for want, got in zip(shape, t.shape)))
    if not ok:
        want = "(" + ", ".join("*" if s is None else str(s) for s in shape) + ")"
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} of shape {want}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _launch(fn: str, entry: str, tensors, count: int, like: torch.Tensor) -> None:
    """Launch the C entry point ``entry`` on ``tensors`` (pointers, in order)
    and ``count`` on the current stream; raise on a refused launch."""
    if any(t.device != like.device for t in tensors) or like.device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    err = getattr(_lib.load(), entry)(*(t.data_ptr() for t in tensors), count, cuda_stream(like))
    if err:
        _lib.check(err, fn)


# ---- P1 (and P7): lane gather ---------------------------------------------------


def lane_gather_torch(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``take_along_axis(v, idx, axis=1)``."""
    lane_gather_torch.launches += 1
    return torch.gather(v, 1, idx.long())


def lane_gather_cuda(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1 on the card: v f32 and idx int32, both (rows, 128)."""
    _check("lane_gather_cuda", "v", v, torch.float32, (None, LANE))
    _check("lane_gather_cuda", "idx", idx, torch.int32, tuple(v.shape))
    o = torch.empty_like(v)
    _launch("lane_gather_cuda", "tpucg_probe_lane_gather_f32", (v, idx, o), v.shape[0], v)
    lane_gather_cuda.launches += 1
    return o


def lane_gather(v: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P1: the kernel for CUDA tensors (``"auto"``), the plain version for
    CPU ones."""
    if resolve_backend(backend, v.device) == "cuda":
        return lane_gather_cuda(v, idx)
    return lane_gather_torch(v, idx)


# ---- P2: sublane gather ---------------------------------------------------------


def sub_gather_torch(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P2: ``take_along_axis(v, idx, axis=0)``."""
    sub_gather_torch.launches += 1
    return torch.gather(v, 0, idx.long())


def sub_gather_cuda(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2 on the card: v f32 (rows, 128), idx int32 (m, 128) -> (m, 128)."""
    _check("sub_gather_cuda", "v", v, torch.float32, (None, LANE))
    _check("sub_gather_cuda", "idx", idx, torch.int32, (None, LANE))
    o = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _launch("sub_gather_cuda", "tpucg_probe_sub_gather_f32", (v, idx, o), idx.shape[0], v)
    sub_gather_cuda.launches += 1
    return o


def sub_gather(v: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P2: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, v.device) == "cuda":
        return sub_gather_cuda(v, idx)
    return sub_gather_torch(v, idx)


# ---- P3: row gather -------------------------------------------------------------


def row_gather_torch(x2: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """Plain version of P3: ``take(x2, ridx, axis=0)``."""
    row_gather_torch.launches += 1
    return x2[ridx.long()]


def row_gather_cuda(x2: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """P3 on the card: x2 f32 (rows, 128), 16-byte aligned, ridx int32 (m,)
    -> (m, 128)."""
    _check("row_gather_cuda", "x2", x2, torch.float32, (None, LANE))
    _check("row_gather_cuda", "ridx", ridx, torch.int32, (None,))
    if x2.data_ptr() % 16:
        raise ValueError("row_gather_cuda: x2 must be 16-byte aligned (float4 row loads)")
    o = torch.empty((ridx.shape[0], LANE), dtype=torch.float32, device=ridx.device)
    _launch("row_gather_cuda", "tpucg_probe_row_gather_f32", (x2, ridx, o), ridx.shape[0], x2)
    row_gather_cuda.launches += 1
    return o


def row_gather(x2: torch.Tensor, ridx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P3: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, x2.device) == "cuda":
        return row_gather_cuda(x2, ridx)
    return row_gather_torch(x2, ridx)


# ---- P4: element gather ---------------------------------------------------------


def elem_gather_torch(xf: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """Plain version of P4: ``take(xf, eidx)``, eidx's shape."""
    elem_gather_torch.launches += 1
    return xf[eidx.long()]


def elem_gather_cuda(xf: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """P4 on the card: xf f32 (n,), eidx int32 of any shape -> eidx's shape."""
    _check("elem_gather_cuda", "xf", xf, torch.float32, (None,))
    _check("elem_gather_cuda", "eidx", eidx, torch.int32, (None,) * eidx.dim())
    o = torch.empty(eidx.shape, dtype=torch.float32, device=eidx.device)
    _launch("elem_gather_cuda", "tpucg_probe_elem_gather_f32", (xf, eidx, o), eidx.numel(), xf)
    elem_gather_cuda.launches += 1
    return o


def elem_gather(xf: torch.Tensor, eidx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P4: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, xf.device) == "cuda":
        return elem_gather_cuda(xf, eidx)
    return elem_gather_torch(xf, eidx)


# ---- P5: windows at run-time offsets --------------------------------------------


def dynslice_torch(w: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Plain version of P5: the (nw, 8, 128) windows gathered at once, then
    added one window at a time, in k order from 0, as the Pallas body's
    ``fori_loop`` adds them."""
    dynslice_torch.launches += 1
    rows = w.long()[:, None] + torch.arange(WINDOW, device=w.device)
    windows = x2[rows]
    acc = torch.zeros((WINDOW, LANE), dtype=x2.dtype, device=x2.device)
    for k in range(windows.shape[0]):
        acc = acc + windows[k]
    return acc


def dynslice_cuda(w: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """P5 on the card: w int32 (nw,), 1 <= nw <= 1024, x2 f32 (rows, 128)
    -> (8, 128)."""
    _check("dynslice_cuda", "w", w, torch.int32, (None,))
    _check("dynslice_cuda", "x2", x2, torch.float32, (None, LANE))
    if w.shape[0] > MAX_WINDOWS:
        raise ValueError(f"dynslice_cuda takes at most {MAX_WINDOWS} windows, got {w.shape[0]}")
    o = torch.empty((WINDOW, LANE), dtype=torch.float32, device=x2.device)
    _launch("dynslice_cuda", "tpucg_probe_dynslice_f32", (w, x2, o), w.shape[0], x2)
    dynslice_cuda.launches += 1
    return o


def dynslice(w: torch.Tensor, x2: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P5: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, x2.device) == "cuda":
        return dynslice_cuda(w, x2)
    return dynslice_torch(w, x2)


# ---- P6: roll by a shift read at run time ---------------------------------------


def roll_dyn_torch(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of P6: the source lanes ``(j - s) mod 128`` built on
    s's device, so the shift is never read back to the host."""
    roll_dyn_torch.launches += 1
    cols = (torch.arange(LANE, device=x.device) - s.long()) % LANE
    return x[:, cols]


def roll_dyn_cuda(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P6 on the card: s int32 (1,) on the card, x f32 (rows, 128)."""
    _check("roll_dyn_cuda", "s", s, torch.int32, (1,))
    _check("roll_dyn_cuda", "x", x, torch.float32, (None, LANE))
    o = torch.empty_like(x)
    _launch("roll_dyn_cuda", "tpucg_probe_roll_dyn_f32", (s, x, o), x.shape[0], x)
    roll_dyn_cuda.launches += 1
    return o


def roll_dyn(s: torch.Tensor, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """P6: the kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_backend(backend, x.device) == "cuda":
        return roll_dyn_cuda(s, x)
    return roll_dyn_torch(s, x)


for _fn in (lane_gather_torch, lane_gather_cuda, sub_gather_torch, sub_gather_cuda,
            row_gather_torch, row_gather_cuda, elem_gather_torch, elem_gather_cuda,
            dynslice_torch, dynslice_cuda, roll_dyn_torch, roll_dyn_cuda):
    _fn.launches = 0
