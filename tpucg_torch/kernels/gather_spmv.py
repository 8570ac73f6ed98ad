"""The WELL SpMV: K13 of the port, and K14 under its second name.
``csrc/gather.cu`` holds the kernel and its design note;
``tpucg_torch.sparse.well`` the format.

All take tpucg's packed arrays and return what tpucg's ``well_spmv`` does,
y2 (nsg * bg, 128) f32: for each slot (s, l), ``vals[s, l] * x2.flat[wrow[s
// 8] * 128 + lidx[s, l]]`` added into row ``(sgb[s // BS] * bg + gidl[s]) *
128 + l``. The sums of an output row are taken over its group's sublanes in
ascending s, from 0, each product and sum rounded on its own: the kernel and
its plain version ``well_spmv_torch`` agree bit for bit. ``group_index``
lists each group's sublanes in that order; an operator builds it once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpucg_torch.kernels import _lib
from tpucg_torch.kernels.dispatch import check_active, cuda_stream, resolve_backend

LANE = 128
CHUNK = 8  # sublanes that share one window


def group_of_sublane(gidl: torch.Tensor, sgb: torch.Tensor, bg: int) -> torch.Tensor:
    """Output group of every sublane, int64 (NS,), on gidl's device."""
    bs = gidl.shape[1]
    return sgb.long().repeat_interleave(bs) * bg + gidl.reshape(-1).long()


def group_index(gidl: torch.Tensor, sgb: torch.Tensor, bg: int,
                nsg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gptr, gsub), int32 on gidl's device: ``gsub`` holds the sublanes
    sorted by output group, ascending within a group, and group g's are
    ``gsub[gptr[g]:gptr[g + 1]]`` (``nsg * bg`` groups). Padding sublanes
    stay in (tpucg adds their 0 * x too)."""
    g = group_of_sublane(gidl, sgb, bg)
    gsub = torch.sort(g, stable=True).indices
    gptr = torch.zeros(nsg * bg + 1, dtype=torch.int64, device=g.device)
    gptr[1:] = torch.cumsum(torch.bincount(g, minlength=nsg * bg), 0)
    return gptr.to(torch.int32), gsub.to(torch.int32)


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


def well_spmv_torch(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int) -> torch.Tensor:
    """Plain version of K13 (tpucg's ``well_spmv_xla``, ``gather_spmv.py:276``),
    summing as the kernel does: each group's sublanes in ascending order,
    from 0. Sublanes whose values are all 0 (padding) add +-0, or NaN from a
    non-finite x, so they change no running sum but a NaN: they are summed
    apart, in any order, and added last. The others are summed one sublane
    rank at a time over all groups at once."""
    well_spmv_torch.launches += 1
    ngroups = nsg * bg
    x = x2.reshape(-1)
    cols = wrow.long().repeat_interleave(CHUNK)[:, None] * LANE + lidx.long()
    prod = vals.float() * x[cols]
    g = group_of_sublane(gidl, sgb, bg)
    live = (vals != 0).any(1)
    zeros = torch.zeros(ngroups, LANE, dtype=torch.float32, device=x.device)
    nan_or_zero = zeros.index_add(0, g[~live], prod[~live])
    subs = torch.nonzero(live).reshape(-1)
    order = torch.sort(g[subs], stable=True).indices
    subs, gs = subs[order], g[subs][order]
    counts = torch.bincount(gs, minlength=ngroups)
    rank = torch.arange(subs.numel(), device=x.device) - (torch.cumsum(counts, 0) - counts)[gs]
    depth = int(counts.max()) if subs.numel() else 0
    # table[j, g]: group g's j-th live sublane, or the zero row past its end.
    table = torch.full((depth, ngroups), prod.shape[0], dtype=torch.int64, device=x.device)
    table[rank, gs] = subs
    prod = torch.cat([prod, zeros[:1]])
    acc = zeros
    for j in range(depth):
        acc = acc + prod[table[j]]
    return acc + nan_or_zero


well_spmv_torch.launches = 0


def well_spmv_launch(vals, lidx, wrow, gptr, gsub, x, y, ngroups: int, active: Optional[int],
                     stream: int) -> None:
    """Launch K13 for groups [0, ``ngroups``) into y (``ngroups * 128``
    floats), with no checks: the caller has checked the arrays as
    ``well_spmv_cuda`` does and owns y. The one place that counts K13's
    launches."""
    lib = _lib.load()
    fn = lib.tpucg_well_spmv_f32 if vals.dtype == torch.float32 else lib.tpucg_well_spmv_bf16
    err = fn(vals.data_ptr(), lidx.data_ptr(), wrow.data_ptr(), gptr.data_ptr(), gsub.data_ptr(),
             x.data_ptr(), y.data_ptr(), ngroups, active, stream)
    if err:
        _lib.check(err, "well_spmv_cuda")
    well_spmv_cuda.launches += 1


def well_spmv_cuda(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int, *,
                   index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13 on the card. ``index`` is ``group_index``'s (gptr, gsub) when the
    caller holds it; without it the index is built and the arrays' values
    are checked (a read back to the host). With ``active`` (0-d int32 on
    the device) the kernel does nothing when the flag is 0, and the
    returned array is undefined."""
    check_well(vals, lidx, gidl, wrow, sgb, bg, nsg, x2)
    check_active(active, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"well_spmv_cuda needs the arrays on a CUDA device, got {vals.device}")
    if index is None:
        check_well_values(lidx, gidl, wrow, sgb, bg, nsg, x2.shape[0])
        index = group_index(gidl, sgb, bg, nsg)
    gptr, gsub = index
    if gptr.numel() != nsg * bg + 1 or gsub.numel() != vals.shape[0]:
        raise ValueError(f"index of {gptr.numel() - 1} groups and {gsub.numel()} sublanes for "
                         f"{nsg * bg} groups and {vals.shape[0]} sublanes")
    y = torch.empty((nsg * bg, LANE), dtype=torch.float32, device=vals.device)
    well_spmv_launch(vals, lidx, wrow, gptr, gsub, x2, y, nsg * bg,
                     None if active is None else active.data_ptr(), cuda_stream(x2))
    return y


well_spmv_cuda.launches = 0


def well_spmv(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int, backend: str = "auto",
              **kw) -> torch.Tensor:
    """WELL SpMV: K13 for CUDA arrays (``"auto"``), the plain version for
    CPU ones; ``index`` and ``active`` are read by K13 only."""
    if resolve_backend(backend, vals.device) == "cuda":
        return well_spmv_cuda(vals, lidx, gidl, wrow, sgb, x2, bg, nsg, **kw)
    return well_spmv_torch(vals, lidx, gidl, wrow, sgb, x2, bg, nsg)


def well_spmv_fused_gather(vals, lidx, gidl, wrow, sgb, x2, bg: int, nsg: int,
                           backend: str = "auto", **kw) -> torch.Tensor:
    """K14's name (tpucg's ``well_spmv_fused_gather``, ``gather_spmv.py:226``):
    tpucg's variant of K13 that gathers the x windows inside the kernel,
    with K13's semantics. K13 reads x inside its kernel already, so this is
    K13."""
    return well_spmv(vals, lidx, gidl, wrow, sgb, x2, bg, nsg, backend=backend, **kw)
