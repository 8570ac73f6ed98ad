"""The WELL SpMV: K13 of the port, and K14 under its second name.
``csrc/gather.cu`` holds the kernel and its design note;
``tpucg_torch.sparse.well`` the format.

All take tpucg's packed arrays and return what tpucg's ``well_spmv`` does,
y2 (nsg * bg, 128) f32: for each slot (s, l), ``vals[s, l] * x2.flat[wrow[s
// 8] * 128 + lidx[s, l]]`` added into row ``(sgb[s // BS] * bg + gidl[s]) *
128 + l``.

K13 reads a layout built once per operator from those arrays
(``well_rows``): the live slots (``vals != 0``) alone, row by row, each
row's in ascending sublane s, and the rows cut into tiles. A row's sum is
taken over its live slots in that order, from 0, each product and sum
rounded on its own, so the kernel and its plain version
``well_spmv_torch`` agree bit for bit. tpucg's ``well_spmv_xla`` sums
every slot of a row, zeros too, in the same ascending s. On finite x the
two agree bit for bit all the same: the running sum starts at +0, and under
round-to-nearest +0 + (-0) and a + (-a) are +0, so it is never -0; adding
+-0 to anything but -0 is exact, so skipping a slot's 0 * x changes no
bit. A NaN or Inf x_j reaches exactly the rows whose stored entries read
column j, as in a CSR product (tpucg's padding slots read x at lane 0 of
their window and carry it to rows that store nothing in that column).

K13 x k (``well_spmv_multi``) is the same product on the k columns of a
row-major block X (padded n, k) over the same layout, each column summed in
K13's order, so column j equals K13 on column j bit for bit: the multi-RHS
and block solves' matvec (``WellOperator.matvec_multi``), where tpucg vmaps
its Pallas kernel. On the card a thread takes a row's group of 4 columns
(or 1), with several of the row's gathers of X in flight; the rows of more
than half a tile (``WellRows.long_rows``) are taken by a block each.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

LANE = 128
CHUNK = 8  # sublanes that share one window
TILE = 2048  # live slots a tile of several rows holds at most (8 KB of products)
TILE_MAX = 12288  # 48 KB of products: the shared memory a block takes without opting in
INT32_MAX = 2 ** 31 - 1


class WellRows(NamedTuple):
    """K13's layout of one operator (``well_rows``): row r's live slots are
    ``[rowptr[r], rowptr[r + 1])`` of ``cols`` (their columns of x) and
    ``rvals`` (their values, in the storage dtype), in ascending sublane
    order; tile t's rows are ``[tptr[t], tptr[t + 1])``. A tile of several
    rows holds at most ``tile`` live slots; a longer row is a tile of its
    own. ``long_rows`` are the rows of more than ``tile // 2`` slots, in
    ascending order: K13 x k takes each with a block of its own."""

    rowptr: torch.Tensor     # int32 (nsg * bg * 128 + 1,)
    cols: torch.Tensor       # int32 (live slots,)
    rvals: torch.Tensor      # f32 or bf16 (live slots,)
    tptr: torch.Tensor       # int32 (tiles + 1,)
    tile: int
    long_rows: torch.Tensor  # int32 (rows of more than tile // 2 slots,)


def well_rows(vals, lidx, gidl, wrow, sgb, bg: int, nsg: int, tile: int = TILE) -> WellRows:
    """Build K13's layout on the arrays' device with torch ops (one read of a
    count and of the largest column back to the host). Slot (s, l) with
    ``vals[s, l] != 0`` goes to row ``(sgb[s // BS] * bg + gidl[s]) * 128 + l``
    with column ``wrow[s // 8] * 128 + lidx[s, l]``; a stable sort by row of
    the slots in ``torch.nonzero`` order keeps each row's in ascending s.

    Tiles: with h = tile // 2, a tile starts at row 0, at every row whose
    first slot lies in another run of h slots than its predecessor's, at
    every row of more than h slots and at the row after it, and every
    ``tile`` rows. A tile of several rows then holds rows of at most h slots
    that all start within one run of h, so fewer than 2 h <= ``tile`` slots,
    and at most ``tile`` rows; its mean is about h. The rows of more than h
    slots are also listed (``long_rows``). Raises where a count or a column
    would not fit int32."""
    check_well(vals, lidx, gidl, wrow, sgb, bg, nsg)
    if not 2 <= tile <= TILE_MAX:
        raise ValueError(f"tile must be in [2, {TILE_MAX}], got {tile}")
    nrows = nsg * bg * LANE
    if nrows >= INT32_MAX:
        raise ValueError(f"{nrows} output rows do not fit the layout's int32 row offsets")
    live = torch.nonzero(vals.reshape(-1) != 0).reshape(-1)
    if live.numel() > INT32_MAX:
        raise ValueError(f"{live.numel()} live slots do not fit the layout's int32 offsets")
    s = live // LANE
    row = ((sgb.long()[s // gidl.shape[1]] * bg + gidl.reshape(-1).long()[s]) * LANE
           + live % LANE)
    col = wrow.long()[s // CHUNK] * LANE + lidx.reshape(-1)[live].long()
    if live.numel() and int(col.max()) > INT32_MAX:
        raise ValueError("a WELL column does not fit the layout's int32 columns")
    row, order = torch.sort(row, stable=True)
    rowptr = torch.zeros(nrows + 1, dtype=torch.int64, device=vals.device)
    rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=nrows), 0)

    starts, lens = rowptr[:-1], torch.diff(rowptr)
    h = tile // 2
    idx = torch.arange(nrows, device=vals.device)
    new = idx % tile == 0
    new[1:] |= (starts[1:] // h) != (starts[:-1] // h)
    big = lens > h
    new |= big
    new[1:] |= big[:-1]
    tptr = torch.cat([torch.nonzero(new).reshape(-1), idx.new_full((1,), nrows)])
    return WellRows(rowptr=rowptr.to(torch.int32), cols=col[order].to(torch.int32),
                    rvals=vals.reshape(-1)[live][order].contiguous(),
                    tptr=tptr.to(torch.int32), tile=int(tile),
                    long_rows=torch.nonzero(big).reshape(-1).to(torch.int32))


def check_well(vals, lidx, gidl, wrow, sgb, bg: int, nsg: int,
               x2: Optional[torch.Tensor] = None) -> None:
    """The packed arrays' types and shapes (and x2's, when given), with no
    read of their values."""
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"WELL values are f32 or bf16, got {vals.dtype}")
    if vals.dim() != 2 or vals.shape[1] != LANE or vals.shape[0] % CHUNK:
        raise ValueError(f"WELL values must be (NS, 128) with NS % 8 == 0, got "
                         f"{tuple(vals.shape)}")
    ns = vals.shape[0]
    want = {"lidx": (lidx, torch.int8, (ns, LANE)), "wrow": (wrow, torch.int32, (ns // CHUNK,)),
            "sgb": (sgb, torch.int32, (gidl.shape[0],) if gidl.dim() == 2 else None),
            "gidl": (gidl, torch.int32, None)}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"WELL {name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if gidl.dim() != 2 or gidl.shape[0] * gidl.shape[1] != ns:
        raise ValueError(f"WELL gidl must be (NB, BS) with NB * BS = {ns}, got "
                         f"{tuple(gidl.shape)}")
    if bg < 1 or nsg < 1:
        raise ValueError(f"WELL needs bg >= 1 and nsg >= 1, got {bg}, {nsg}")
    ts = (vals, lidx, gidl, wrow, sgb) + (() if x2 is None else (x2,))
    if any(t.device != vals.device or not t.is_contiguous() for t in ts):
        raise ValueError("WELL arrays must be contiguous and on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if x2 is not None and (x2.dtype != torch.float32 or x2.dim() != 2 or x2.shape[1] != LANE):
        raise ValueError(f"x2 must be f32 (G, 128), got {x2.dtype} {tuple(x2.shape)}")


def check_well_values(lidx, gidl, wrow, sgb, bg: int, nsg: int, ngroups_x: int) -> None:
    """The packed arrays' values (one read back to the host): lane indices in
    [0, 128), windows in [0, ``ngroups_x``), group ids in [0, bg), super-group
    ids in [0, nsg). The kernel reads x at these indices unchecked."""
    bad = []
    for name, t, hi in (("lidx", lidx, LANE), ("wrow", wrow, ngroups_x), ("gidl", gidl, bg),
                        ("sgb", sgb, nsg)):
        t = t.int()  # int8 cannot hold 128
        if t.numel() and bool(((t < 0) | (t >= hi)).any()):
            bad.append(f"{name} outside [0, {hi})")
    if bad:
        raise ValueError("WELL arrays out of range: " + ", ".join(bad))


def check_rows(rows: WellRows, nrows: int, vals: torch.Tensor) -> None:
    """A layout's types and shapes for ``nrows`` output rows and values like
    ``vals``, with no read of its values."""
    t = (rows.rowptr, rows.cols, rows.tptr, rows.long_rows)
    if (any(a.dtype != torch.int32 or a.dim() != 1 for a in t)
            or rows.rowptr.numel() != nrows + 1 or rows.tptr.numel() < 2
            or rows.rvals.dtype != vals.dtype or rows.rvals.shape != rows.cols.shape
            or not 2 <= rows.tile <= TILE_MAX):
        raise ValueError(f"a WellRows layout for {nrows} rows of {vals.dtype} values, got "
                         f"rowptr {tuple(rows.rowptr.shape)}, cols {tuple(rows.cols.shape)}, "
                         f"rvals {rows.rvals.dtype} {tuple(rows.rvals.shape)}, tptr "
                         f"{tuple(rows.tptr.shape)}, tile {rows.tile}, long_rows "
                         f"{rows.long_rows.dtype} {tuple(rows.long_rows.shape)}")
    if any(a.device != vals.device or not a.is_contiguous() for a in t + (rows.rvals,)):
        raise ValueError(f"a WellRows layout must be contiguous and on {vals.device}")


def well_spmv_torch(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int, *,
                    index: Optional[WellRows] = None) -> torch.Tensor:
    """Plain version of K13 (tpucg's ``well_spmv_xla``, ``gather_spmv.py:276``)
    over the same layout (built here when ``index`` is None), summing as the
    kernel does: the products, then each row's in slot order from 0, one
    rank of all rows at a time (one read of the longest row back a call)."""
    well_spmv_torch.launches += 1
    rows = well_rows(vals, lidx, gidl, wrow, sgb, bg, nsg) if index is None else index
    prod = rows.rvals.float() * x2.reshape(-1)[rows.cols.long()]
    ptr = rows.rowptr.long()
    start, lens = ptr[:-1], torch.diff(ptr)
    acc = torch.zeros(nsg * bg * LANE, dtype=torch.float32, device=x2.device)
    last = max(prod.numel() - 1, 0)
    for j in range(int(lens.max())):
        acc = acc + torch.where(lens > j, prod[(start + j).clamp_max(last)], 0.0)
    return acc.reshape(nsg * bg, LANE)


well_spmv_torch.launches = 0


def well_spmv_launch(rows: WellRows, x, y, nrows: int, active: Optional[int],
                     stream: int) -> None:
    """Launch K13 for output rows [0, ``nrows``) into y (``nrows`` floats),
    with no checks: the caller has checked the layout and x as
    ``well_spmv_cuda`` does and owns y. The one place that counts K13's
    launches."""
    lib = _lib.load()
    fn = lib.tpucg_well_spmv_f32 if rows.rvals.dtype == torch.float32 else lib.tpucg_well_spmv_bf16
    err = fn(rows.rvals.data_ptr(), rows.cols.data_ptr(), rows.rowptr.data_ptr(),
             rows.tptr.data_ptr(), x.data_ptr(), y.data_ptr(), nrows, rows.tptr.numel() - 1,
             rows.tile, active, stream)
    if err:
        _lib.check(err, "well_spmv_cuda")
    well_spmv_cuda.launches += 1


def well_spmv_cuda(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int, *,
                   index: Optional[WellRows] = None,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13 on the card. ``index`` is the arrays' ``well_rows`` layout when
    the caller holds it, and then only the layout is read; without it the
    arrays' values are checked (a read back to the host) and the layout is
    built. With ``active`` (0-d int32 on the device) the kernel does
    nothing when the flag is 0, and the returned array is undefined."""
    check_well(vals, lidx, gidl, wrow, sgb, bg, nsg, x2)
    check_active(active, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"well_spmv_cuda needs the arrays on a CUDA device, got {vals.device}")
    if x2.numel() > INT32_MAX:
        raise ValueError(f"x2 of {x2.numel()} elements: K13 indexes x with int32")
    if index is None:
        check_well_values(lidx, gidl, wrow, sgb, bg, nsg, x2.shape[0])
        index = well_rows(vals, lidx, gidl, wrow, sgb, bg, nsg)
    nrows = nsg * bg * LANE
    check_rows(index, nrows, vals)
    y = torch.empty((nsg * bg, LANE), dtype=torch.float32, device=vals.device)
    well_spmv_launch(index, x2, y, nrows, None if active is None else active.data_ptr(),
                     cuda_stream(x2))
    return y


well_spmv_cuda.launches = 0


def well_spmv(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int, backend: str = "auto",
              index: Optional[WellRows] = None, **kw) -> torch.Tensor:
    """WELL SpMV: K13 for CUDA arrays (``"auto"``), the plain version for
    CPU ones; both read ``index`` (a ``well_rows`` layout) when given,
    ``active`` is read by K13 only."""
    if resolve_backend(backend, vals.device) == "cuda":
        return well_spmv_cuda(vals, lidx, gidl, wrow, sgb, x2, bg, nsg, index=index, **kw)
    return well_spmv_torch(vals, lidx, gidl, wrow, sgb, x2, bg, nsg, index=index)


def well_spmv_multi_torch(rows: WellRows, X: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain version of K13 x k: ``well_spmv_torch``'s products and sums over
    the layout ``rows`` on the k columns of X (columns of A, k) at once, for
    output rows [0, ``nrows``): column j equals ``well_spmv_torch`` on
    column j bit for bit (one read of the longest row back a call)."""
    well_spmv_multi_torch.launches += 1
    prod = rows.rvals.float()[:, None] * X[rows.cols.long()]
    ptr = rows.rowptr[: nrows + 1].long()
    start, lens = ptr[:-1], torch.diff(ptr)
    acc = torch.zeros((nrows, X.shape[1]), dtype=torch.float32, device=X.device)
    last = max(prod.shape[0] - 1, 0)
    on = lens[:, None]
    for j in range(int(lens.max()) if nrows else 0):
        acc = acc + torch.where(on > j, prod[(start + j).clamp_max(last)], 0.0)
    return acc


well_spmv_multi_torch.launches = 0


def well_spmv_multi_launch(rows: WellRows, X, Y, nrows: int, active: Optional[int],
                           stream: int) -> None:
    """Launch K13 x k for output rows [0, ``nrows``) into Y (``nrows``, k),
    with no checks: the caller has checked the layout and X as
    ``well_spmv_multi_cuda`` does and owns Y. The one place that counts
    K13 x k's launches."""
    lib = _lib.load()
    fn = (lib.tpucg_well_spmv_multi_f32 if rows.rvals.dtype == torch.float32
          else lib.tpucg_well_spmv_multi_bf16)
    err = fn(rows.rvals.data_ptr(), rows.cols.data_ptr(), rows.rowptr.data_ptr(),
             rows.long_rows.data_ptr(), X.data_ptr(), Y.data_ptr(), nrows,
             rows.long_rows.numel(), rows.tile, X.shape[1], active, stream)
    if err:
        _lib.check(err, "well_spmv_multi_cuda")
    well_spmv_multi_cuda.launches += 1


def well_spmv_multi_cuda(rows: WellRows, X: torch.Tensor, nrows: int, *,
                         active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13 x k on the card over a square operator's layout ``rows``: Y
    (``nrows``, k) = A X for X a contiguous f32 (``nrows``, k) block; the
    operator checked the layout's columns against its length when it built
    it. With
    ``active`` (0-d int32 on the device) the kernel does nothing when the
    flag is 0, and the returned block is undefined."""
    dev = rows.rvals.device
    if dev.type != "cuda":
        raise ValueError(f"well_spmv_multi_cuda needs the layout on a CUDA device, got {dev}")
    if not 0 < nrows < rows.rowptr.numel():
        raise ValueError(f"nrows must be in [1, {rows.rowptr.numel() - 1}], got {nrows}")
    check_rows(rows, rows.rowptr.numel() - 1, rows.rvals)
    if (X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != nrows or X.shape[1] < 1
            or not X.is_contiguous() or X.device != dev):
        raise ValueError(f"well_spmv_multi_cuda needs a contiguous f32 ({nrows}, k) block "
                         f"on {dev}, got {X.dtype} {tuple(X.shape)} on {X.device}")
    check_active(active, rows.rvals)
    Y = torch.empty((nrows, X.shape[1]), dtype=torch.float32, device=dev)
    well_spmv_multi_launch(rows, X, Y, nrows, None if active is None else active.data_ptr(),
                           cuda_stream(X))
    return Y


well_spmv_multi_cuda.launches = 0


def well_spmv_multi(rows: WellRows, X: torch.Tensor, nrows: int, backend: str = "auto",
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k-column WELL SpMV over the layout ``rows``: K13 x k for a CUDA
    layout (``"auto"``), the plain version for a CPU one; ``active`` is read
    by the kernel only."""
    if resolve_backend(backend, rows.rvals.device) == "cuda":
        return well_spmv_multi_cuda(rows, X, nrows, active=active)
    return well_spmv_multi_torch(rows, X, nrows)


def well_spmv_fused_gather(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int,
                           backend: str = "auto", **kw) -> torch.Tensor:
    """K14's name (tpucg's ``well_spmv_fused_gather``, ``gather_spmv.py:226``):
    tpucg's variant of K13 that gathers the x windows inside the kernel,
    with K13's semantics. K13 reads x inside its kernel already, so this is
    K13."""
    return well_spmv(vals, lidx, gidl, wrow, sgb, x2, bg, nsg, backend=backend, **kw)
