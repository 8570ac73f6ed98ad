"""The gather probes P1-P7 on the card: the counterpart of ``main()`` in
``benchmarks/probe_gather.py``, at the script's shapes and on its inputs.

    python -m tpucg_torch.bench.probe_gather [--device cuda|cpu]

For each probe it holds the kernel against its plain version (bit for bit)
and prints one line: µs per launch (``bench.timing.device_timing``: calls
queued behind a spin kernel), Gelem/s, GB/s of the least bytes it must
move on these inputs (``Probe.least_bytes``: indices and output once, each
distinct 32-byte sector it reads from its table once), the least time for
those bytes at the HBM peak, the plain version's µs and the library
call's. P7 is timed twice:
rotating over ``COLD_SETS`` copies of its inputs (96 MB with the outputs,
above the 50 MB L2), the rate held against the HBM peak, and on one set,
which stays in L2 (its rate may pass the HBM peak). P4's kernel is also
timed at K13's scale, on tpucg's FEM 300k system (``fem_scale_lines``).
Then the script's two XLA baselines (:197-205) as library rates:
``index_select`` of 2048 rows and ``torch.take`` of 2048 x 128 elements.
Then the plans of P1/P7, P2, P5 and P6 (``lane_gather_plan``,
``sub_gather_plan`` at the script's shape, at 8192 idx rows of a 2048-row
v and at a tall v, ``dynslice_plan``),
P5 at 1,024 windows, P1 and P7 (cold and L2-resident) on 1 … 16 warps a
block beside a streaming reference at P7's bytes (``torch.add`` of two
(8192, 128) f32 tensors, cold), the edge shapes of P1/P7's, P2's, P5's and
P6's kernels bit for bit (``edge_checks``), and one launch's floor
(``launch_floor``: a one-element ``fill_`` queued the same way), which no
launch-bound probe can beat.

Unlike the script, which printed FAIL for a probe Mosaic could not lower
(:31-33) and ran P7 only after P1 passed (:172), any failure raises and the
command exits non-zero: a CUDA kernel that fails is a bug. With ``--device
cpu`` it runs the plain versions, holds them against NumPy indexing, prints
each probe's least bytes and their time at an H100 SXM's HBM peak, and
times nothing: there is no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpucg_torch.bench.timing import (
    device_seconds_per_call,
    gather_bytes,
    hbm_peak_bytes_per_s,
    nvidia_smi_card,
    rotating,
)
from tpucg_torch.kernels import probe_gather as kp

# The script's shapes: (R, 128) tiles, a (XR, 128) table, NW windows of
# WINDOW rows, P7's (RB, 128) stream.
R, XR, NW, RB = 256, 2048, 64, 8192
LANE, WINDOW = kp.LANE, kp.WINDOW
SHIFT = 5         # the script's roll shift
BASE_ROWS = 2048  # rows of the script's two XLA baselines
COLD_SETS = 8     # P7 input sets that rotate in its cold timing (12 MB each)
# The edge shapes of P1/P7's kernel (row counts: one row, a ragged last
# block, more blocks than fit the card at once) and of P5's (window
# counts: a ragged stage, a ring from 257).
EDGE_ROWS = (1, 3, 4, 37, 63, 64, 65, 255, 256, 8191, 8192, 8193, 65536)
EDGE_NWS = (1, 2, 63, 64, 65, 511, 1024)
# P2's (v's rows on both sides of the staged form's cap, idx's rows: a
# ragged run, more runs than rows) and P6's (rows; shifts within the row,
# past it, negative, and the ends of int32).
SG_EDGE_VROWS = (1, 2, 255, 256, 257, kp.SG_MAX_ROWS - 1, kp.SG_MAX_ROWS, kp.SG_MAX_ROWS + 1,
                 16384)
SG_EDGE_ROWS = (1, 3, 31, 32, 33, 255, 256, 257, 8192)
ROLL_EDGE_ROWS = (1, 3, 31, 32, 33, 256, 8192, 65536)
ROLL_SHIFTS = (0, 1, 3, 4, 5, 127, 128, 300, -3, -2 ** 31, 2 ** 31 - 1)
TALL_ROWS = 16384  # v's rows in the direct form's case


def row_addresses(rows) -> np.ndarray:
    """Flat addresses of every element of ``rows`` (any shape) of a 128-wide
    table: what a gather of whole rows reads."""
    return np.asarray(rows, np.int64)[..., None] * LANE + np.arange(LANE)


def window_sum(w: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """P5 by NumPy: the windows ``x2[w[k]:w[k] + 8]`` added in k order from 0."""
    acc = np.zeros((WINDOW, LANE), np.float32)
    for k in w:
        acc = acc + x2[k:k + WINDOW]
    return acc


def edge_windows(nw: int, xr: int, seed: int) -> np.ndarray:
    """``nw`` window offsets into a table of ``xr`` rows: random, with
    overlaps (a repeat, and a neighbour one row on), the first row and the
    last window the table holds."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, xr - WINDOW + 1, nw).astype(np.int32)
    w[: min(nw, 3)] = [xr - WINDOW, 0, xr - WINDOW][: min(nw, 3)]
    if nw > 4:
        w[4] = w[3] + 1
    return w


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe. ``reference``, ``library`` and ``moved`` take the probe's
    inputs in ``keys`` order: ``reference`` (NumPy arrays) is NumPy
    indexing, the CPU run's yardstick; ``library`` (tensors) gives one
    PyTorch call computing the same function as (function, args, kwargs),
    the timed yardstick and never the port; ``moved`` (NumPy arrays) is the
    least bytes the probe must move on these inputs (``gather_bytes``)."""

    pid: str                     # "P1" ... "P7"
    name: str                    # the script's function name
    line: int                    # its pl.pallas_call in benchmarks/probe_gather.py
    keys: tuple                  # the inputs it takes (probe_inputs' names), in order
    run: Callable                # dispatcher: kernel on the card, plain on the CPU
    plain: Callable              # plain PyTorch version
    kernel: str                  # the wrapper that counts its kernel's launches
    elems: int                   # elements it gathers (the script's count)
    reference: Callable
    library: Callable
    moved: Callable

    def args(self, t: Dict[str, object]) -> tuple:
        return tuple(t[k] for k in self.keys)

    def least_bytes(self, a: Dict[str, np.ndarray]) -> int:
        return self.moved(*self.args(a))

    def library_call(self, t: Dict[str, torch.Tensor]):
        """(label, call): the library call on ``t``, its int64 indices made
        beforehand where it needs them."""
        fn, args, kw = self.library(*self.args(t))
        label = f"{fn.__module__}.{fn.__name__}" + "".join(f"({k}={v!r})" for k, v in kw.items())
        return label, functools.partial(fn, *args, **kw)


def _lane_gather(pid: str, name: str, line: int, keys: tuple, rows: int) -> Probe:
    """P1, and P7 over more rows: the same function and kernel."""
    return Probe(
        pid, name, line, keys, kp.lane_gather, kp.lane_gather_torch, "lane_gather_cuda",
        rows * LANE,
        reference=lambda v, i: np.take_along_axis(v, i, 1),
        library=lambda v, i: (torch.gather, (v, 1, i.long()), {}),
        moved=lambda v, i: gather_bytes(i.nbytes, 4 * i.size,
                                        np.arange(len(i))[:, None] * LANE + i))


PROBES = (
    _lane_gather("P1", "lane_gather", 70, ("V", "LI"), R),
    Probe("P2", "sub_gather", 83, ("V", "SI"), kp.sub_gather, kp.sub_gather_torch,
          "sub_gather_cuda", R * LANE,
          reference=lambda v, i: np.take_along_axis(v, i, 0),
          library=lambda v, i: (torch.gather, (v, 0, i.long()), {}),
          moved=lambda v, i: gather_bytes(i.nbytes, 4 * i.size, i * LANE + np.arange(LANE))),
    Probe("P3", "row_gather", 101, ("x2", "ridx"), kp.row_gather, kp.row_gather_torch,
          "row_gather_cuda", R * LANE,
          reference=lambda x2, r: x2[r],
          library=lambda x2, r: (torch.index_select, (x2, 0, r), {}),
          moved=lambda x2, r: gather_bytes(r.nbytes, 4 * LANE * r.size, row_addresses(r))),
    Probe("P4", "elem_gather", 117, ("xf", "eidx"), kp.elem_gather, kp.elem_gather_torch,
          "elem_gather_cuda", R * LANE,
          reference=lambda xf, e: xf[e],
          library=lambda xf, e: (torch.take, (xf, e.long()), {}),
          moved=lambda xf, e: gather_bytes(e.nbytes, 4 * e.size, e)),
    # The library call sums bag r = rows w[k] + r over the windows k.
    Probe("P5", "dynslice", 138, ("widx", "x2"), kp.dynslice, kp.dynslice_torch,
          "dynslice_cuda", NW * WINDOW * LANE,
          reference=window_sum,
          library=lambda w, x2: (F.embedding_bag, (
              torch.arange(WINDOW, device=w.device)[:, None] + w.long()[None, :], x2),
              {"mode": "sum"}),
          moved=lambda w, x2: gather_bytes(w.nbytes, 4 * WINDOW * LANE,
                                           row_addresses(w[:, None] + np.arange(WINDOW)))),
    Probe("P6", "roll_dyn", 157, ("shift", "V"), kp.roll_dyn, kp.roll_dyn_torch,
          "roll_dyn_cuda", R * LANE,
          reference=lambda s, x: np.roll(x, int(s[0]), 1),
          library=lambda s, x: (torch.roll, (x, int(s[0]), 1), {}),
          moved=lambda s, x: gather_bytes(s.nbytes, x.nbytes, np.arange(x.size))),
    # The script's lg_big: P1's function streamed over (8192, 128) in
    # 512-row blocks on the TPU. The blocks were tiling; here it is P1's
    # kernel over all the rows.
    _lane_gather("P7", "lg_big", 184, ("Vb", "LIb"), RB),
)


def probe_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    """The script's inputs, drawn from one ``np.random.default_rng(seed)`` in
    its order (V, LI :63-64; P2's indices :89; x2, ridx :94-95; xf, eidx
    :110-111; widx :127; Vb, LIb :175-176; the baselines' indices :199,
    :203), ``standard_normal`` cast to f32 and ``integers`` to int32, as
    ``jnp.asarray`` cast them: at seed 0 the arrays of the TPU run."""
    rng = np.random.default_rng(seed)

    def normal(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def integers(hi, shape):
        return rng.integers(0, hi, shape).astype(np.int32)

    a = {}
    a["V"], a["LI"] = normal((R, LANE)), integers(LANE, (R, LANE))
    a["SI"] = integers(R, (R, LANE))
    a["x2"], a["ridx"] = normal((XR, LANE)), integers(XR, (R,))
    a["xf"], a["eidx"] = normal((XR * LANE,)), integers(XR * LANE, (R, LANE))
    a["widx"] = integers(XR - WINDOW, (NW,))
    a["Vb"], a["LIb"] = normal((RB, LANE)), integers(LANE, (RB, LANE))
    a["base_ridx"] = integers(XR, (BASE_ROWS,))
    a["base_eidx"] = integers(XR * LANE, (BASE_ROWS, LANE))
    a["shift"] = np.asarray([SHIFT], np.int32)
    return a


def device_inputs(a: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in a.items()}


@dataclasses.dataclass
class Measured:
    """Device seconds per call of a probe's kernel, plain version and library
    call (``library_label``); for P7 these rotate over cold input sets, and
    ``l2`` is the kernel on one set (L2-resident)."""

    kernel: float
    plain: float
    library: float
    library_label: str
    l2: Optional[float] = None


def cold_sets(p: Probe, t: Dict[str, torch.Tensor]) -> list:
    """``t`` and ``COLD_SETS - 1`` copies of the probe's inputs."""
    return [t] + [{k: t[k].clone() for k in p.keys} for _ in range(COLD_SETS - 1)]


def measure(p: Probe, t: Dict[str, torch.Tensor]) -> Measured:
    """Time one probe on the card (``device_seconds_per_call``)."""
    args = p.args(t)
    label, lib = p.library_call(t)
    if p.pid != "P7":
        return Measured(*(device_seconds_per_call(f) for f in (
            lambda: p.run(*args), lambda: p.plain(*args), lib)), label)
    sets = cold_sets(p, t)
    cold = [rotating([lambda s=s, f=f: f(*p.args(s)) for s in sets])
            for f in (p.run, p.plain)]
    lib = rotating([p.library_call(s)[1] for s in sets])
    m = Measured(*(device_seconds_per_call(f) for f in (*cold, lib)), label)
    m.l2 = device_seconds_per_call(lambda: p.run(*args))
    return m


def baselines(t: Dict[str, torch.Tensor], a: Dict[str, np.ndarray]) -> list:
    """The script's XLA baselines as library calls: (label, seconds, elements,
    least bytes moved, ``gather_bytes`` on the inputs ``a`` that ``t``
    holds)."""
    ridx, eidx64 = t["base_ridx"], t["base_eidx"].long()
    out = 4 * BASE_ROWS * LANE
    return [
        ("torch.index_select of 2048 rows of x2 (2048, 128)",
         device_seconds_per_call(lambda: torch.index_select(t["x2"], 0, ridx)),
         BASE_ROWS * LANE,
         gather_bytes(a["base_ridx"].nbytes, out, row_addresses(a["base_ridx"]))),
        ("torch.take of 2048 x 128 elements of xf (262144,)",
         device_seconds_per_call(lambda: torch.take(t["xf"], eidx64)),
         BASE_ROWS * LANE, gather_bytes(a["base_eidx"].nbytes, out, a["base_eidx"])),
    ]


FEM_POINTS = 300_000  # tpucg's FEM P1 system: fem_p1_system(300_000, seed=0)
FEM_SETS = 3          # index sets that rotate (43 MB each with the output at 300k)


def fem_scale(dev, n: int, cols: np.ndarray):
    """P4's kernel at K13's scale: reads of an n-element x (1.2 MB at FEM
    300k, which stays in L2) at ``cols``, rotating over FEM_SETS copies of
    them so the indices stream from device memory as K13's do. Returns
    (kernel s, torch.take s, bytes it must move)."""
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    first = torch.as_tensor(np.asarray(cols, np.int32), device=dev)
    idx = [first] + [first.clone() for _ in range(FEM_SETS - 1)]
    check_equal("P4 at FEM scale against plain", kp.elem_gather(x, first),
                kp.elem_gather_torch(x, first))
    idx64 = [i.long() for i in idx]
    tk = device_seconds_per_call(rotating([lambda i=i: kp.elem_gather(x, i) for i in idx]))
    tl = device_seconds_per_call(rotating([lambda i=i: torch.take(x, i) for i in idx64]))
    m = first.numel()
    return tk, tl, gather_bytes(4 * m, 4 * m, first)


def well_slot_columns(A) -> tuple:
    """(columns, padded n): the columns of x that the live slots (value != 0)
    of ``A``'s WELL packing read, in slot order (sublane-major: a chunk of 8
    sublanes reads one 512-byte window of x), the identity tail included."""
    from tpucg_torch.sparse.well import LANE, csr_to_well

    w = csr_to_well(A)
    s, lane = np.nonzero(w.vals)
    cols = w.wrow_per_sublane()[s].astype(np.int64) * LANE + w.lidx[s, lane]
    return cols, w.n_groups * LANE


def fem_scale_lines(dev, peak: float) -> list:
    """P4 at FEM 300k: x read at the matrix's own column indices (CSR order:
    the x reads of one CSR product, with the mesh's locality, and of K13's
    row layout), at the WELL packing's live slots in slot order (the TPU
    layout's order, 512-byte windows), and at as many uniformly random
    indices (no locality)."""
    from tpucg_torch.io.generator import fem_p1_system

    A = fem_p1_system(FEM_POINTS, seed=0)[0]
    n = A.shape[0]
    well_cols, npad = well_slot_columns(A)
    rand = np.random.default_rng(0).integers(0, n, A.nnz)
    lines = []
    for label, size, cols in (("its CSR column indices", n, A.indices),
                              ("WELL's live slots in slot order", npad, well_cols),
                              ("as many random indices", n, rand)):
        tk, tl, nbytes = fem_scale(dev, size, cols)
        m = len(cols)
        lines.append(
            f"P4 at FEM 300k, {m} reads of x ({size},) at {label}, rotating over {FEM_SETS} "
            f"index sets: {tk * 1e6:.3f} us, {m / tk / 1e9:.2f} Gelem/s, "
            f"{nbytes / tk / 1e9:.1f} GB/s ({100 * nbytes / tk / peak:.1f}% of HBM peak); "
            f"bound {nbytes / peak * 1e6:.3f} us ({nbytes} bytes); torch.take(x, idx64) "
            f"{tl * 1e6:.3f} us")
    return lines


def check_equal(what: str, got: torch.Tensor, want) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit."""
    want = torch.as_tensor(want, device=got.device)
    if got.shape != want.shape or not torch.equal(got, want):
        diff = float((got - want).abs().max()) if got.shape == want.shape else float("nan")
        raise RuntimeError(f"{what}: differs (shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                           f"max abs diff {diff})")


def probe_line(p: Probe, m: Measured, nbytes: int, peak: float) -> str:
    """The probe's line: its times against ``nbytes``, the least bytes it
    must move, at the HBM ``peak``."""
    bound = nbytes / peak
    cold = f" cold, rotating over {COLD_SETS} input sets" if m.l2 is not None else ""
    line = (f"{p.pid} {p.name}{cold}: {m.kernel * 1e6:.3f} us, {p.elems / m.kernel / 1e9:.2f} "
            f"Gelem/s, {nbytes / m.kernel / 1e9:.1f} GB/s ({100 * nbytes / m.kernel / peak:.1f}% "
            f"of HBM peak); bound {bound * 1e6:.3f} us ({nbytes} bytes); plain "
            f"{m.plain * 1e6:.3f} us; {m.library_label} {m.library * 1e6:.3f} us")
    if nbytes / m.kernel > peak:
        line += "  ABOVE PEAK: timing fault"
    if m.l2 is not None:
        line += (f"\n{p.pid} {p.name} on one set (L2-resident rate): {m.l2 * 1e6:.3f} us, "
                 f"{nbytes / m.l2 / 1e9:.1f} GB/s")
    return line


def launch_floor(dev) -> float:
    """Device seconds of a launch that moves next to nothing: a one-element
    ``fill_``, queued behind the spin kernel as the probes are."""
    one = torch.empty(1, device=dev)
    return device_seconds_per_call(lambda: one.fill_(1.0))


def plan_lines(sms: int) -> list:
    """The plans of P1/P7's, P2's, P5's and P6's kernels at the script's
    shapes, and P2's at 8192 idx rows of the script's 2048-row ``x2`` and at
    a tall v."""
    return [f"plan P1 ({R} rows): {kp.lane_gather_plan(R, sms)}",
            f"plan P7 ({RB} rows): {kp.lane_gather_plan(RB, sms)}",
            f"plan P2 (v {R} rows, idx {R} rows): {kp.sub_gather_plan(R, R, sms)}",
            f"plan P2 (v {XR} rows, idx {RB} rows): {kp.sub_gather_plan(XR, RB, sms)}",
            f"plan P2 (v {TALL_ROWS} rows, idx {R} rows): {kp.sub_gather_plan(TALL_ROWS, R, sms)}",
            f"plan P5 ({NW} windows): {kp.dynslice_plan(NW)}",
            f"plan P6 ({R} rows): {kp.lane_gather_plan(R, sms)}"]


def edge_checks(dev) -> list:
    """P1/P7's kernel at ``EDGE_ROWS`` (random lanes, and every lane 0 or
    127: one bank a warp), P2's at every pair of ``SG_EDGE_VROWS`` and
    ``SG_EDGE_ROWS`` (random rows, and every index 0 or v_rows - 1 at 256
    and 8192 idx rows), P5's at ``EDGE_NWS`` and P6's at ``ROLL_EDGE_ROWS``
    x ``ROLL_SHIFTS`` (also equal to ``torch.roll``), each held to its plain
    version and to its repeat bit for bit; raises on a difference. Returns
    one line for each."""
    g = torch.Generator(device=dev).manual_seed(15)
    for rows in EDGE_ROWS:
        v = torch.randn(rows, LANE, generator=g, device=dev)
        for fill in (None, 0, LANE - 1):
            idx = (torch.randint(0, LANE, (rows, LANE), generator=g, device=dev,
                                 dtype=torch.int32) if fill is None
                   else torch.full((rows, LANE), fill, dtype=torch.int32, device=dev))
            got = kp.lane_gather_cuda(v, idx)
            check_equal(f"P1/P7 at {rows} rows, lanes {fill}", got, kp.lane_gather_torch(v, idx))
            check_equal(f"P1/P7 at {rows} rows, lanes {fill}: repeat", got,
                        kp.lane_gather_cuda(v, idx))
    lines = [f"P1/P7's kernel at {len(EDGE_ROWS)} row counts ({EDGE_ROWS[0]} ... "
             f"{EDGE_ROWS[-1]}), random lanes and every lane 0 or 127: bit-identical to plain "
             "and to its repeat"]
    forms = set()
    for vr in SG_EDGE_VROWS:
        v = torch.randn(vr, LANE, generator=g, device=dev)
        for m in SG_EDGE_ROWS:
            for fill in (None, 0, vr - 1) if m in (R, RB) else (None,):
                idx = (torch.randint(0, vr, (m, LANE), generator=g, device=dev,
                                     dtype=torch.int32) if fill is None
                       else torch.full((m, LANE), fill, dtype=torch.int32, device=dev))
                what = f"P2 at v {vr} rows, idx {m} rows, rows {fill}"
                got = kp.sub_gather_cuda(v, idx)
                check_equal(what, got, kp.sub_gather_torch(v, idx))
                check_equal(f"{what}: repeat", got, kp.sub_gather_cuda(v, idx))
            forms.add("staged" if kp.sub_gather_plan(vr, m, kp._sms(v)).staged else "direct")
    lines.append(f"P2 at v {', '.join(map(str, SG_EDGE_VROWS))} rows x idx "
                 f"{', '.join(map(str, SG_EDGE_ROWS))} rows ({' and '.join(sorted(forms))} "
                 "forms), random rows and every row 0 or v_rows - 1: bit-identical to plain and "
                 "to its repeat")
    x2 = torch.randn(2 * XR, LANE, generator=g, device=dev)
    for nw in EDGE_NWS:
        w = torch.as_tensor(edge_windows(nw, 2 * XR, nw), device=dev)
        got = kp.dynslice_cuda(w, x2)
        check_equal(f"P5 at {nw} windows", got, kp.dynslice_torch(w, x2))
        check_equal(f"P5 at {nw} windows: repeat", got, kp.dynslice_cuda(w, x2))
    lines.append(f"P5 at {', '.join(map(str, EDGE_NWS))} windows (overlapping, the last "
                 "window of the table): bit-identical to plain and to its repeat")
    for rows in ROLL_EDGE_ROWS:
        x = torch.randn(rows, LANE, generator=g, device=dev)
        for shift in ROLL_SHIFTS:
            s = torch.tensor([shift], dtype=torch.int32, device=dev)
            got = kp.roll_dyn_cuda(s, x)
            check_equal(f"P6 at {rows} rows, shift {shift}", got, kp.roll_dyn_torch(s, x))
            check_equal(f"P6 at {rows} rows, shift {shift}: torch.roll", got,
                        torch.roll(x, shift, 1))
            check_equal(f"P6 at {rows} rows, shift {shift}: repeat", got, kp.roll_dyn_cuda(s, x))
    lines.append(f"P6 at {', '.join(map(str, ROLL_EDGE_ROWS))} rows x shifts "
                 f"{', '.join(map(str, ROLL_SHIFTS))}: bit-identical to plain, to torch.roll and "
                 "to its repeat")
    return lines


def staged_lines(t: Dict[str, torch.Tensor], a: Dict[str, np.ndarray], peak: float) -> list:
    """P5 at 1,024 windows; P1, P7 cold and P7 on one set (L2-resident) on
    1, 2, 4, 8 and 16 warps a block; and ``torch.add`` of two (8192, 128)
    f32 tensors, cold: the library's streaming rate at P7's bytes. µs per
    launch, queued."""
    p1, p7 = (next(p for p in PROBES if p.pid == pid) for pid in ("P1", "P7"))
    w = torch.as_tensor(edge_windows(kp.MAX_WINDOWS, 2 * XR, 0), device=t["x2"].device)
    x2 = torch.cat([t["x2"], t["x2"]])
    check_equal("P5 at 1024 windows", kp.dynslice_cuda(w, x2), kp.dynslice_torch(w, x2))
    s = device_seconds_per_call(lambda: kp.dynslice_cuda(w, x2))
    lines = [f"P5 at {w.shape[0]} windows ({kp.dynslice_plan(w.shape[0])}): {s * 1e6:.3f} us"]
    nbytes = p7.least_bytes(a)
    sets = cold_sets(p7, t)
    for warps in (1, 2, 4, 8, 16):
        plans = [kp.LaneGatherPlan(rows, warps) for rows in (R, RB)]
        p1_at, p7_at = (lambda u, p=p, q=q: kp.lane_gather_cuda(*p.args(u), _plan=q)
                        for p, q in ((p1, plans[0]), (p7, plans[1])))
        check_equal(f"P7 on {warps} warps a block", p7_at(t), kp.lane_gather_torch(*p7.args(t)))
        small = device_seconds_per_call(lambda: p1_at(t))
        cold = device_seconds_per_call(rotating([lambda u=u: p7_at(u) for u in sets]))
        l2 = device_seconds_per_call(lambda: p7_at(t))
        lines.append(f"{warps} warps a block: P1 {small * 1e6:.3f} us; P7 cold "
                     f"{cold * 1e6:.3f} us, {100 * nbytes / cold / peak:.1f}% of HBM peak; "
                     f"P7 L2-resident {l2 * 1e6:.3f} us")
    g = torch.Generator(device=t["Vb"].device).manual_seed(7)
    pairs = [tuple(torch.randn(RB, LANE, generator=g, device=t["Vb"].device) for _ in range(2))
             for _ in range(COLD_SETS)]
    s = device_seconds_per_call(rotating([lambda q=q: torch.add(*q) for q in pairs]))
    lines.append(f"streaming reference at P7's bytes, torch.add of two ({RB}, {LANE}) f32, cold: "
                 f"{s * 1e6:.3f} us, {100 * 3 * RB * LANE * 4 / s / peak:.1f}% of HBM peak")
    return lines


def run_cpu() -> None:
    a = probe_inputs(0)
    t = device_inputs(a, "cpu")
    peak = hbm_peak_bytes_per_s("H100 SXM")
    for p in PROBES:
        check_equal(f"{p.pid} {p.name} (plain, cpu)", p.run(*p.args(t)), p.reference(*p.args(a)))
        nbytes = p.least_bytes(a)
        print(f"{p.pid} {p.name}: plain version equals NumPy indexing bit for bit on the CPU; "
              f"least bytes {nbytes}, bound {nbytes / peak * 1e6:.3f} us at the H100 SXM's "
              f"{peak / 1e12:.2f} TB/s")
    print("no time is taken off the card: the probes' times come from --device cuda")


def run_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_gather measures on the card, and there is no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = nvidia_smi_card()
    peak = hbm_peak_bytes_per_s()
    print(f"device: {torch.cuda.get_device_name(dev)} [{card}], HBM peak on record "
          f"{peak / 1e12:.2f} TB/s; inputs probe_inputs(0)")
    a = probe_inputs(0)
    t = device_inputs(a, dev)
    for p in PROBES:
        args = p.args(t)
        got = p.run(*args)
        check_equal(f"{p.pid} {p.name} against plain", got, p.plain(*args))
        check_equal(f"{p.pid} {p.name} repeat", got, p.run(*args))
        print(probe_line(p, measure(p, t), p.least_bytes(a), peak), flush=True)
    for line in fem_scale_lines(dev, peak):
        print(line, flush=True)
    for label, s, elems, nbytes in baselines(t, a):
        print(f"library rate, {label}: {s * 1e6:.3f} us, {elems / s / 1e9:.2f} Gelem/s, "
              f"{nbytes / s / 1e9:.1f} GB/s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for line in plan_lines(sms) + staged_lines(t, a, peak) + edge_checks(dev):
        print(line, flush=True)
    print(f"launch floor (a one-element fill_, queued): {launch_floor(dev) * 1e6:.3f} us")
    print(card)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.probe_gather",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        run_cpu()
    else:
        run_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main())
