"""WELL, windowed gather-ELLPACK: tpucg's irregular-sparse format (a NumPy
copy of ``tpucg.sparse.well``'s ``WellMatrix``, ``_auto_block_sublanes`` and
``csr_to_well``, and its shard packers ``pad_well_shard``,
``csr_to_well_sharded`` and ``local_rows_to_well_shard``).

The layout was chosen for the TPU, whose only fast data-dependent reads
are whole-row DMA and the in-register lane shuffle. The port keeps it
unchanged, so that an operator packed by either package is the same
operator; on the card K13 reads a layout repacked from it once per
operator, its live slots row by row (``kernels.gather_spmv.well_rows``):

- x is seen as ``x2 = x.reshape(G, 128)``; row w is the 128-wide window of
  columns [128 w, 128 (w + 1)).
- Nonzeros sit in sublane rows of 128 slots. Every entry of a sublane has
  its column in ONE window and its row in ONE output group of 128 rows, at
  lane ``row % 128``.
- Every aligned chunk of 8 sublanes shares one window (``wrow`` holds one
  window per chunk).
- Within a super-group of ``BG`` output groups, tiles (group, window pairs,
  S sublanes for the row with most entries in the window) are sorted by
  window; each (super-group, window) run is padded to a multiple of 8
  sublanes and each super-group to a multiple of the ``BS``-sublane stream
  block. Padding slots hold value 0 and lane index 0; padding sublanes of a
  super-group route to its group 0.

The product is, for each slot (s, l), ``vals[s, l] * x[wrow[s // 8] * 128 +
lidx[s, l]]`` added into output row ``(sgb[s // BS] * BG + gidl[s]) * 128 +
l``. Fill (nnz / slots) depends on how well a group's entries cluster into
shared windows: orderings that keep locality (mesh order, RCM,
``tpucg_torch.sparse.ordering``) keep it high.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

LANE = 128
CHUNK = 8  # sublanes per shared-window chunk


@dataclasses.dataclass(frozen=True)
class WellMatrix:
    """Windowed gather-ELL storage (host arrays; the device form is
    ``WellOperator``).

    vals  (NS, 128)  float32 -- packed nonzero values (0 = padding slot)
    lidx  (NS, 128)  int8    -- column % 128 of each slot (0 for padding)
    wrow  (NS/8,)    int32   -- window id (column // 128) per 8-sublane chunk
    gidl  (NB, BS)   int32   -- group id within the super-group per sublane
    sgb   (NB,)      int32   -- super-group id per stream block (nondecreasing)
    shape             logical (rows, cols)
    block_sublanes    BS -- sublanes per stream block
    groups_per_super  BG -- output groups (of 128 rows) per super-group
    """

    vals: np.ndarray
    lidx: np.ndarray
    wrow: np.ndarray
    gidl: np.ndarray
    sgb: np.ndarray
    shape: Tuple[int, int]
    block_sublanes: int
    groups_per_super: int

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    @property
    def n_sublanes(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.sgb.size)

    @property
    def n_groups(self) -> int:
        """Output groups covering the (row-padded) system: ceil(rows/128)."""
        return -(-self.shape[0] // LANE)

    @property
    def n_supergroups(self) -> int:
        return int(self.sgb.max()) + 1 if self.sgb.size else 0

    @property
    def fill(self) -> float:
        """Useful fraction of the stored slots (1.0 = no padding)."""
        slots = self.vals.size
        return self.nnz / slots if slots else 1.0

    def wrow_per_sublane(self) -> np.ndarray:
        """The per-chunk window ids expanded to one per sublane."""
        return np.repeat(self.wrow, CHUNK)

    def group_of_sublane(self) -> np.ndarray:
        """Output group (of 128 rows) of every sublane, int64 (NS,)."""
        return (np.repeat(self.sgb.astype(np.int64), self.block_sublanes)
                * self.groups_per_super + self.gidl.reshape(-1))

    def diagonal(self) -> np.ndarray:
        """diag(A) over the padded rows [0, n_groups*128), float32: the sum
        of the entries whose column equals their row (padding slots hold 0)."""
        g_of_sub = self.group_of_sublane()
        lanes = np.arange(LANE, dtype=np.int64)[None, :]
        row = g_of_sub[:, None] * LANE + lanes
        col = self.wrow_per_sublane()[:, None].astype(np.int64) * LANE + (
            self.lidx.astype(np.int64))
        contrib = np.where(col == row, self.vals, 0.0).astype(np.float32)
        d2 = np.zeros((self.n_supergroups * self.groups_per_super, LANE), np.float32)
        np.add.at(d2, g_of_sub, contrib)
        npad = -(-self.shape[0] // LANE) * LANE
        return d2.reshape(-1)[:npad]

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference SpMV (oracle for kernel tests)."""
        ncol_pad = -(-self.shape[1] // LANE) * LANE
        x2 = np.zeros(ncol_pad, dtype=np.result_type(x, np.float32))
        x2[: self.shape[1]] = x
        x2 = x2.reshape(-1, LANE)
        xg = x2[self.wrow_per_sublane()]
        P = self.vals * np.take_along_axis(xg, self.lidx.astype(np.int64), axis=1)
        y2 = np.zeros((self.n_supergroups * self.groups_per_super, LANE), P.dtype)
        np.add.at(y2, self.group_of_sublane(), P)
        return y2.reshape(-1)[: self.shape[0]]


def _auto_block_sublanes(total_sublanes: int, n_supergroups: int, sg_tot=None) -> int:
    """tpucg's stream-block size (BS): with ``sg_tot`` (the exact chunk-padded
    sublane counts of the super-groups) the power of two in [256, 4096]
    minimising ``padded_slots(bs) * (4096/bs)**0.263`` (ties to the larger
    block: the exponent is tpucg's measured TPU cost of halving a block);
    without it, the average-content rule. The port keeps the rule so that
    both packages pack the same arrays."""
    if sg_tot is not None and len(sg_tot) > 0:
        sg = np.asarray(sg_tot, np.int64)
        best_bs, best_score = None, None
        bs = 4096
        while bs >= 256:
            padded = int(np.where(sg == 0, bs, -(-sg // bs) * bs).sum())
            score = padded * (4096.0 / bs) ** 0.263
            if best_score is None or score < best_score:
                best_bs, best_score = bs, score
            bs //= 2
        return best_bs
    per_sg = max(int(total_sublanes) // max(int(n_supergroups), 1), 1)
    bs = 256
    while bs * 2 <= min(per_sg + per_sg // 4, 4096):
        bs *= 2
    return bs


def csr_to_well(csr, block_sublanes=None, groups_per_super: int = 64) -> WellMatrix:
    """Pack a CSR matrix into WELL form (vectorised NumPy).

    Square matrices get an identity tail on rows [n, ceil(n/128)*128), so
    the padded operator stays SPD and Jacobi sees unit diagonals there.
    ``block_sublanes=None`` picks the stream-block size as tpucg does
    (:func:`_auto_block_sublanes`).
    """
    BS = None if block_sublanes is None else int(block_sublanes)
    BG = int(groups_per_super)
    if BS is not None and (BS % CHUNK or BS <= 0):
        raise ValueError(f"block_sublanes must be a positive multiple of {CHUNK}, got {BS}")
    if BG <= 0:
        raise ValueError(f"groups_per_super must be positive, got {BG}")
    n_rows, n_cols = csr.shape
    G = -(-n_rows // LANE)
    NSG = -(-G // BG)

    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    vals = csr.data.astype(np.float32)
    if n_rows == n_cols and G * LANE != n_rows:
        tail = np.arange(n_rows, G * LANE, dtype=np.int64)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, np.float32)])

    nnz = vals.size
    if nnz == 0:
        # An all-zero matrix: one zero block per super-group, so every
        # output row is still written.
        if BS is None:
            BS = 256
        NS = max(NSG, 1) * BS
        NB = NS // BS
        return WellMatrix(
            vals=np.zeros((NS, LANE), np.float32),
            lidx=np.zeros((NS, LANE), np.int8),
            wrow=np.zeros(NS // CHUNK, np.int32),
            gidl=np.zeros((NB, BS), np.int32),
            sgb=np.arange(NB, dtype=np.int32) % max(NSG, 1),
            shape=(n_rows, n_cols),
            block_sublanes=BS,
            groups_per_super=BG,
        )

    g = rows // LANE
    w = cols // LANE
    lane = (rows % LANE).astype(np.int64)
    li = (cols % LANE).astype(np.int8)
    NW = -(-max(n_cols, 1) // LANE)

    order = np.lexsort((rows, w, g))
    g, w, lane, li, vals = (a[order] for a in (g, w, lane, li, vals))
    rows_s = rows[order]

    # Slot k within each (row, window) run: the sort keeps a row's entries
    # of one window together.
    key_rw = rows_s * NW + w
    new_rw = np.r_[True, key_rw[1:] != key_rw[:-1]]
    starts = np.flatnonzero(new_rw)
    run_len = np.diff(np.r_[starts, nnz])
    k = np.arange(nnz, dtype=np.int64) - np.repeat(starts, run_len)

    # Tiles = (group, window) pairs; a tile takes S = the largest per-row
    # count sublanes (rows with fewer entries pad within their lanes).
    key_t = g * NW + w
    new_t = np.r_[True, key_t[1:] != key_t[:-1]]
    tstarts = np.flatnonzero(new_t)
    tid = np.cumsum(new_t) - 1
    S = np.maximum.reduceat(k + 1, tstarts)
    tg = g[tstarts]
    tw = w[tstarts]
    tsg = tg // BG

    # Window-major super-group layout: tiles sort by (super-group, window,
    # group); each (super-group, window) run pads to a CHUNK multiple and
    # each super-group to a BS multiple (an empty one gets one zero block).
    torder = np.lexsort((tg, tw, tsg))
    tsg_s, tw_s, S_s = tsg[torder], tw[torder], S[torder]
    runkey = tsg_s * NW + tw_s
    new_run = np.r_[True, runkey[1:] != runkey[:-1]]
    ridx = np.cumsum(new_run) - 1
    rstarts = np.flatnonzero(new_run)
    runS = np.add.reduceat(S_s, rstarts)
    runS_pad = -(-runS // CHUNK) * CHUNK
    run_sg = tsg_s[rstarts]
    run_w = tw_s[rstarts]

    sg_tot = np.bincount(run_sg, weights=runS_pad.astype(np.float64),
                         minlength=NSG).astype(np.int64)
    if BS is None:
        BS = _auto_block_sublanes(int(runS_pad.sum()), NSG, sg_tot=sg_tot)
    sg_pad = np.where(sg_tot == 0, BS, -(-sg_tot // BS) * BS)
    sg_base = np.concatenate([[0], np.cumsum(sg_pad)])
    NS = int(sg_base[-1])
    NB = NS // BS

    # Run bases: exclusive cumsum of the padded run lengths, rebased per
    # super-group onto sg_base.
    crp = np.cumsum(runS_pad) - runS_pad
    new_sg_run = np.r_[True, run_sg[1:] != run_sg[:-1]]
    first_run = np.flatnonzero(new_sg_run)
    run_to_first = first_run[np.cumsum(new_sg_run) - 1]
    run_base = sg_base[run_sg] + (crp - crp[run_to_first])

    # Tile bases: exclusive cumsum of S within each run.
    ctp = np.cumsum(S_s) - S_s
    tbase_sorted = run_base[ridx] + (ctp - ctp[rstarts][ridx])
    tbase = np.empty_like(tbase_sorted)
    tbase[torder] = tbase_sorted
    sub = tbase[tid] + k

    vals_a = np.zeros((NS, LANE), np.float32)
    lidx_a = np.zeros((NS, LANE), np.int8)
    gid_a = np.zeros(NS, np.int32)
    vals_a[sub, lane] = vals
    lidx_a[sub, lane] = li
    gid_a[sub] = (g % BG).astype(np.int32)

    # Per-sublane window ids (run-uniform, padding included), checked
    # chunk-uniform and stored per chunk. The BS-padding gaps of a
    # super-group keep window 0 (zero values: they add nothing).
    wrow_sub = np.zeros(NS, np.int32)
    tot = int(runS_pad.sum())
    within = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(runS_pad) - runS_pad, runS_pad)
    pos = np.repeat(run_base, runS_pad) + within
    wrow_sub[pos] = np.repeat(run_w, runS_pad).astype(np.int32)
    wrow8 = wrow_sub.reshape(-1, CHUNK)
    if not (wrow8 == wrow8[:, :1]).all():
        raise AssertionError("chunks must be window-uniform")

    sgb = (np.searchsorted(sg_base, np.arange(NB, dtype=np.int64) * BS, "right") - 1
           ).astype(np.int32)
    # Padding sublanes keep group 0 of their super-group: their zero values
    # add nothing there.
    return WellMatrix(
        vals=vals_a,
        lidx=lidx_a,
        wrow=wrow8[:, 0].copy(),
        gidl=gid_a.reshape(NB, BS),
        sgb=sgb,
        shape=(n_rows, n_cols),
        block_sublanes=BS,
        groups_per_super=BG,
    )


def local_rows_to_well_shard(coo_local, shard: int, rps: int, npad: int, n: int,
                             block_sublanes, groups_per_super: int = 64) -> WellMatrix:
    """ONE shard's WELL pack from only its own rows (tpucg's): the
    host-sharded form of ``csr_to_well_sharded``, which needs the whole CSR
    on every rank. ``coo_local`` holds the rows in local numbering [0, rps)
    against global columns (``io.mmio.load_matrix_market_rows``); the
    shard's global rows in [n, npad) get the identity tail here.
    ``block_sublanes`` is the mesh-wide BS (None: this shard's adaptive
    pick); the caller pads the pack to the mesh-wide sublane count with
    ``pad_well_shard``."""
    from tpucg_torch.sparse.formats import COOMatrix

    rows = coo_local.row.astype(np.int64)
    cols = coo_local.col.astype(np.int64)
    vals = coo_local.data.astype(np.float32)
    g0 = shard * rps
    t0, t1 = max(n, g0), min(npad, g0 + rps)
    if t1 > t0:
        tail = np.arange(t0, t1, dtype=np.int64)
        rows = np.concatenate([rows, tail - g0])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, np.float32)])
    return csr_to_well(
        COOMatrix(row=rows, col=cols, data=vals, shape=(rps, npad)).to_csr(),
        block_sublanes=None if block_sublanes is None else int(block_sublanes),
        groups_per_super=groups_per_super)


def pad_well_shard(w: WellMatrix, NS: int) -> dict:
    """One shard's pack zero-padded to the mesh-wide sublane count ``NS``
    (tpucg's): the padding stream blocks hold value 0 and the last
    super-group id, so they add exact zeros. Returns the arrays of one
    shard in ``csr_to_well_sharded``'s stacked layout, without the shard
    axis."""
    BS = w.block_sublanes
    NB = NS // BS
    nsg = w.n_supergroups

    def pad(a, shape, dtype, fill=0):
        out = np.full(shape, fill, dtype)
        out[: a.shape[0]] = a
        return out

    return dict(
        vals=pad(w.vals, (NS, LANE), np.float32),
        lidx=pad(w.lidx, (NS, LANE), np.int8),
        gidl=pad(w.gidl, (NB, BS), np.int32),
        wrow=pad(w.wrow, (NS // CHUNK,), np.int32),
        sgb=pad(w.sgb, (NB,), np.int32, fill=nsg - 1),
    )


def csr_to_well_sharded(csr, num_shards: int, block_sublanes=None,
                        groups_per_super: int = 64):
    """Row blocks of a square CSR as WELL packs of one shape, stacked on a
    leading shard axis (tpucg's; rank s takes slice [s] of each array).

    Each shard owns ``rps = ceil(n / (P * 128)) * 128`` contiguous rows;
    rows past n get the identity tail at their global diagonal, so the
    padded operator is blockdiag(A, I). Columns stay global: the sharded
    matvec gathers x whole. The packs are zero-padded to the largest
    shard's sublane count. ``block_sublanes=None`` lets shard 0's pick
    (``_auto_block_sublanes``) govern every shard. Returns ``(stacked,
    statics)``: ``stacked`` a dict of (P, ...) host arrays (vals f32, lidx
    int8, gidl, wrow, sgb int32), ``statics`` rps, npad, bg and nsg."""
    from tpucg_torch.sparse.formats import COOMatrix

    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError(f"sharded WELL needs a square matrix, got {csr.shape}")
    P = int(num_shards)
    rps = -(-n_rows // (P * LANE)) * LANE
    npad = P * rps

    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    vals = csr.data.astype(np.float32)
    if npad != n_rows:  # the identity tail at the global diagonal
        tail = np.arange(n_rows, npad, dtype=np.int64)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, np.float32)])

    shard_of = rows // rps
    wells = []
    for s in range(P):
        sel = shard_of == s
        wells.append(csr_to_well(
            COOMatrix(row=rows[sel] - s * rps, col=cols[sel], data=vals[sel],
                      shape=(rps, npad)).to_csr(),
            block_sublanes=block_sublanes, groups_per_super=groups_per_super))
        if block_sublanes is None:
            # One BS for every shard (the stacked shapes agree): shard 0's.
            block_sublanes = wells[0].block_sublanes
    nsg = wells[0].n_supergroups
    if any(w.n_supergroups != nsg for w in wells):
        raise AssertionError("the shards' super-group counts differ")
    NS = max(w.n_sublanes for w in wells)
    stacked = {name: np.stack([pad_well_shard(w, NS)[name] for w in wells])
               for name in ("vals", "lidx", "gidl", "wrow", "sgb")}
    statics = dict(rps=rps, npad=npad, bg=groups_per_super, nsg=nsg)
    return stacked, statics
