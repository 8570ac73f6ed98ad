"""MatrixMarket (.mtx) I/O (a NumPy copy of ``tpucg.io.mmio``).

The reference reads only its own one-float-per-line dense text format;
real sparse SPD systems (SuiteSparse, NIST) ship as MatrixMarket files.
This loader covers the formats a CG library meets in practice:

- ``coordinate`` ``real | integer | pattern``, ``general | symmetric``
  (symmetric files store the lower triangle only; off-diagonal entries are
  mirrored on load so the in-memory matrix is the full operator);
- ``array`` (dense column-major) ``real | integer``, ``general | symmetric``.

``complex``/``hermitian``/``skew-symmetric`` qualifiers are rejected: CG
needs a real SPD operator, and silently dropping imaginary parts or signs
would corrupt the system.

Parsing is vectorised NumPy (one whitespace split and one bulk float
conversion over the comment-stripped body). ``build_mm_index``,
``expand_matrix_market`` and ``load_matrix_market_rows`` (the byte-range
loading of one row block) are copied as tpucg has them: the first two
still read the whole file into one host's memory.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from tpucg_torch.sparse.formats import COOMatrix, CSRMatrix

_BANNER = "%%MatrixMarket"
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric")


def _parse_header(path: str, first: str) -> tuple:
    toks = first.strip().split()
    if len(toks) != 5 or toks[0].lower() != _BANNER.lower():
        raise ValueError(
            f"{path!r}: not a MatrixMarket file (header {first.strip()!r}; "
            f"expected '%%MatrixMarket matrix <format> <field> <symmetry>')"
        )
    obj, fmt, field, sym = (t.lower() for t in toks[1:])
    if obj != "matrix":
        raise ValueError(f"{path!r}: unsupported object {obj!r}")
    if fmt not in _FORMATS:
        raise ValueError(f"{path!r}: unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise ValueError(
            f"{path!r}: unsupported field {field!r} — CG needs a real "
            "operator (complex/hermitian files are out of scope)"
        )
    if sym not in _SYMMETRIES:
        raise ValueError(
            f"{path!r}: unsupported symmetry {sym!r} — only general/"
            "symmetric (skew-symmetric cannot be SPD)"
        )
    if fmt == "array" and field == "pattern":
        raise ValueError(f"{path!r}: array format cannot be pattern")
    return fmt, field, sym


def _body_lines(path: str) -> tuple:
    """(header_line, size_line, joined_data_body) with comments stripped."""
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.decode("ascii", errors="replace").splitlines()
    if not lines:
        raise ValueError(f"{path!r}: empty file")
    header, rest = lines[0], lines[1:]
    body = [ln for ln in rest if ln.strip() and not ln.lstrip().startswith("%")]
    if not body:
        raise ValueError(f"{path!r}: missing size line")
    return header, body[0], "\n".join(body[1:])


def _parse_floats(path: str, data: str) -> np.ndarray:
    """Bulk-parse whitespace-separated floats; Fortran 'D' exponents OK."""
    toks = data.split()
    try:
        return np.array(toks, dtype=np.float64)
    except ValueError:
        # Retry with Fortran double-precision exponents (1.5D+03), then
        # point at the offending token.
        try:
            return np.array([t.replace("D", "E").replace("d", "e")
                             for t in toks], dtype=np.float64)
        except ValueError:
            for t in toks:
                try:
                    float(t.replace("D", "E").replace("d", "e"))
                except ValueError:
                    raise ValueError(
                        f"{path!r}: unparsable numeric token {t!r}"
                    ) from None
            raise


def load_matrix_market(
    path: str, dtype=np.float32
) -> Union[COOMatrix, np.ndarray]:
    """Load a MatrixMarket file.

    Returns a host-side ``COOMatrix`` for ``coordinate`` files (chain
    ``.to_csr()`` / ``best_sparse_operator`` for a device operator) and
    a dense ``np.ndarray`` for ``array`` files. Symmetric storage is expanded
    to the full matrix in both cases.
    """
    header, size_line, data = _body_lines(path)
    fmt, field, sym = _parse_header(path, header)
    dims = size_line.split()

    if fmt == "array":
        if len(dims) != 2:
            raise ValueError(f"{path!r}: array size line {size_line!r}")
        nrow, ncol = int(dims[0]), int(dims[1])
        # split() tolerates any whitespace layout (the spec says one value
        # per line; files in the wild sometimes wrap) and raises a clear
        # ValueError on the first unparsable token.
        vals = _parse_floats(path, data)
        if sym == "symmetric":
            if nrow != ncol:
                raise ValueError(f"{path!r}: symmetric but {nrow}x{ncol}")
            want = nrow * (nrow + 1) // 2
            if vals.size != want:
                raise ValueError(
                    f"{path!r}: symmetric array needs {want} values "
                    f"(lower triangle, column-major), found {vals.size}"
                )
            A = np.zeros((nrow, ncol), dtype=np.float64)
            il, jl = np.tril_indices(nrow)
            # MM array data is column-major: sort (col, row).
            order = np.lexsort((il, jl))
            A[il[order], jl[order]] = vals
            A = A + A.T - np.diag(np.diag(A))
        else:
            if vals.size != nrow * ncol:
                raise ValueError(
                    f"{path!r}: expected {nrow * ncol} values, "
                    f"found {vals.size}"
                )
            A = vals.reshape((ncol, nrow)).T  # column-major on disk
        return np.ascontiguousarray(A.astype(dtype))

    # coordinate
    if len(dims) != 3:
        raise ValueError(f"{path!r}: coordinate size line {size_line!r}")
    nrow, ncol, nnz = int(dims[0]), int(dims[1]), int(dims[2])
    per_line = 2 if field == "pattern" else 3
    toks = _parse_floats(path, data)
    if toks.size != nnz * per_line:
        raise ValueError(
            f"{path!r}: expected {nnz} entries x {per_line} tokens = "
            f"{nnz * per_line}, found {toks.size}"
        )
    toks = toks.reshape((nnz, per_line))
    row = toks[:, 0].astype(np.int64) - 1  # 1-based on disk
    col = toks[:, 1].astype(np.int64) - 1
    if nnz and (
        row.min() < 0 or col.min() < 0
        or row.max() >= nrow or col.max() >= ncol
    ):
        raise ValueError(f"{path!r}: index out of range for {nrow}x{ncol}")
    val = (
        np.ones(nnz, dtype=np.float64) if field == "pattern" else toks[:, 2]
    )
    if sym == "symmetric":
        if nrow != ncol:
            raise ValueError(f"{path!r}: symmetric but {nrow}x{ncol}")
        off = row != col
        row = np.concatenate([row, col[off]])
        col = np.concatenate([col, toks[:, 0].astype(np.int64)[off] - 1])
        val = np.concatenate([val, val[off]])
    return COOMatrix(row=row, col=col, data=val.astype(dtype),
                     shape=(nrow, ncol))


# --- Host-sharded (byte-range) loading -------------------------------------
#
# The reference's rank 0 reads ALL of A and scatters it. These primitives
# let each process read only its rows of a sparse .mtx file: a one-time sidecar index records the byte offset where
# each row's entries begin in a ROW-SORTED general coordinate file, after
# which any process can read EXACTLY its row-block's bytes — per-process
# bytes-read ~ nnz_shard/nnz of the file, no full parse anywhere.
#
# Symmetric-storage files cannot be row-range-read (the mirrored entry
# (j, i) of a stored (i, j) lives in row i's byte range, not row j's), so
# the ETL step `expand_matrix_market` rewrites them general + row-sorted +
# indexed once.


def mm_index_path(path: str) -> str:
    return path + ".mmidx.npz"


def build_mm_index(path: str) -> str:
    """Build the byte-offset sidecar for a ROW-SORTED general coordinate
    .mtx file (one streaming pass; validates sortedness). Returns the
    sidecar path. Symmetric or unsorted files raise, pointing at
    :func:`expand_matrix_market`."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.isascii():
        # char offsets into the decoded text double as BYTE offsets only
        # for pure-ASCII files (the MatrixMarket spec's charset).
        raise ValueError(
            f"{path!r}: non-ASCII bytes — cannot build a byte-offset "
            "index; re-write the file with expand_matrix_market"
        )
    text = raw.decode("ascii")
    fmt, field, sym = _parse_header(path, text.splitlines()[0])
    if fmt != "coordinate":
        raise ValueError(f"{path!r}: row index applies to coordinate files")
    if sym != "general":
        raise ValueError(
            f"{path!r}: symmetric storage cannot be row-range-read "
            "(mirrored entries live in other rows' bytes) — run "
            "expand_matrix_market first"
        )
    nrow = ncol = nnz = None
    # find the size line (first non-comment line after the header)
    line_start = text.index("\n") + 1
    while True:
        nl = text.find("\n", line_start)
        line = text[line_start: nl if nl >= 0 else len(text)]
        ls = line.strip()
        if ls and not ls.startswith("%"):
            nrow, ncol, nnz = (int(t) for t in ls.split())
            data_start = (nl + 1) if nl >= 0 else len(text)
            break
        if nl < 0:
            raise ValueError(f"{path!r}: missing size line")
        line_start = nl + 1
    # Record the first byte of each row's run. Fast path (vectorised): every
    # data-region line is an entry, true for the files save_matrix_market
    # writes and virtually all files in the wild. Falls back to a
    # per-line scan when comments/blank lines interleave the data.
    offsets = np.full(nrow + 1, -1, dtype=np.int64)
    body_u8 = np.frombuffer(raw[data_start:], np.uint8)
    nl_pos = np.flatnonzero(body_u8 == 0x0A)
    line_starts = np.concatenate(([0], nl_pos + 1))
    if line_starts.size and line_starts[-1] >= body_u8.size:
        line_starts = line_starts[:-1]  # trailing newline
    count = None
    if line_starts.size == nnz:
        toks = _parse_floats(path, text[data_start:])
        if toks.size == nnz * 3:
            rows0 = toks.reshape(-1, 3)[:, 0].astype(np.int64) - 1
            if rows0.size and (rows0.min() < 0 or rows0.max() >= nrow):
                raise ValueError(f"{path!r}: row index out of range")
            if np.any(np.diff(rows0) < 0):
                raise ValueError(
                    f"{path!r}: entries are not row-sorted — run "
                    "expand_matrix_market first"
                )
            uniq, first = np.unique(rows0, return_index=True)
            offsets[uniq] = data_start + line_starts[first]
            count = nnz
    if count is None:
        # slow path: comment/blank lines inside the data region
        pos = data_start
        prev_row = -1
        count = 0
        while pos < len(text):
            nl = text.find("\n", pos)
            end = nl if nl >= 0 else len(text)
            ls = text[pos:end].strip()
            if ls and not ls.startswith("%"):
                r = int(ls.split(None, 1)[0]) - 1
                if r < prev_row:
                    raise ValueError(
                        f"{path!r}: entries are not row-sorted (row "
                        f"{r + 1} after {prev_row + 1}) — run "
                        "expand_matrix_market first"
                    )
                if r >= nrow:
                    raise ValueError(f"{path!r}: row {r + 1} > {nrow}")
                if r != prev_row:
                    offsets[r] = pos
                    prev_row = r
                count += 1
            if nl < 0:
                break
            pos = nl + 1
    if count != nnz:
        raise ValueError(f"{path!r}: size line says {nnz} entries, "
                         f"found {count}")
    offsets[nrow] = len(raw)
    # empty rows (and rows before the first entry) inherit the NEXT
    # starting offset so [off[r0], off[r1]) is always exactly row-block
    # bytes.
    for r in range(nrow - 1, -1, -1):
        if offsets[r] < 0:
            offsets[r] = offsets[r + 1]
    out = mm_index_path(path)
    tmp = f"{out}.tmp.{os.getpid()}"
    np.savez(tmp, row_offsets=offsets, nrow=np.int64(nrow),
             ncol=np.int64(ncol), nnz=np.int64(nnz),
             file_bytes=np.int64(len(raw)))
    tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(tmp_real, out)
    return out


def expand_matrix_market(src: str, dst: str) -> str:
    """One-time ETL for host-sharded loading: load ``src`` (any supported
    coordinate variant incl. symmetric), expand to the full operator,
    row-sort, write ``dst`` as general coordinate, and build its sidecar
    index. Returns the sidecar path."""
    mat = load_matrix_market(src, dtype=np.float64)
    if not isinstance(mat, COOMatrix):
        raise ValueError(f"{src!r}: expand applies to coordinate files")
    order = np.lexsort((mat.col, mat.row))
    mat = COOMatrix(row=mat.row[order], col=mat.col[order],
                    data=mat.data[order], shape=mat.shape)
    save_matrix_market(dst, mat, symmetric=False)
    return build_mm_index(dst)


def load_matrix_market_rows(
    path: str, r0: int, r1: int, dtype=np.float32
) -> tuple:
    """Read ONLY rows [r0, r1) of an indexed general coordinate file.

    Returns (COOMatrix with LOCAL row numbering [0, r1-r0) and GLOBAL
    columns, global_shape, bytes_read). ``bytes_read`` counts the data
    bytes actually fetched: about the rows' share of the file, not the whole
    file."""
    idx_path = mm_index_path(path)
    if not os.path.exists(idx_path):
        raise FileNotFoundError(
            f"{idx_path!r} missing — build it once with build_mm_index() "
            "or expand_matrix_market()"
        )
    with np.load(idx_path) as z:
        offsets = z["row_offsets"]
        nrow, ncol = int(z["nrow"]), int(z["ncol"])
    if not (0 <= r0 <= r1 <= nrow):
        raise ValueError(f"rows [{r0}, {r1}) out of range for {nrow}")
    lo, hi = int(offsets[r0]), int(offsets[r1])
    with open(path, "rb") as f:
        f.seek(lo)
        chunk = f.read(hi - lo)
    body = "\n".join(
        ln for ln in chunk.decode("ascii", errors="replace").splitlines()
        if ln.strip() and not ln.lstrip().startswith("%")
    )
    toks = _parse_floats(path, body) if body else np.empty(0, np.float64)
    if toks.size % 3:
        raise ValueError(f"{path!r}: byte range [{lo}, {hi}) held "
                         f"{toks.size} tokens (not triples)")
    toks = toks.reshape((-1, 3))
    row = toks[:, 0].astype(np.int64) - 1
    col = toks[:, 1].astype(np.int64) - 1
    if row.size and (row.min() < r0 or row.max() >= r1):
        raise ValueError(
            f"{path!r}: stale index — rows outside [{r0}, {r1}) in range"
        )
    return (
        COOMatrix(row=row - r0, col=col, data=toks[:, 2].astype(dtype),
                  shape=(r1 - r0, ncol)),
        (nrow, ncol),
        hi - lo,
    )


def save_matrix_market(
    path: str,
    mat: Union[COOMatrix, CSRMatrix, np.ndarray],
    symmetric: bool = False,
    comment: str = "",
) -> None:
    """Write ``mat`` as MatrixMarket coordinate (sparse) or array (dense).

    ``symmetric=True`` stores only the lower triangle (the file declares
    ``symmetric``); the caller asserts the matrix IS symmetric — entries
    above the diagonal are dropped, not checked, matching the format's
    storage contract.
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    if isinstance(mat, CSRMatrix):
        mat = mat.to_coo()
    with open(tmp, "w") as f:
        if isinstance(mat, COOMatrix):
            sym = "symmetric" if symmetric else "general"
            f.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
            if comment:
                f.write(f"% {comment}\n")
            row, col, val = mat.row, mat.col, mat.data
            if symmetric:
                keep = row >= col
                row, col, val = row[keep], col[keep], val[keep]
            f.write(f"{mat.shape[0]} {mat.shape[1]} {row.size}\n")
            np.savetxt(
                f,
                np.column_stack([row + 1, col + 1, val]),
                fmt=("%d", "%d", "%.9g"),
            )
        else:
            A = np.asarray(mat)
            if A.ndim == 1:
                A = A[:, None]
            sym = "symmetric" if symmetric else "general"
            f.write(f"%%MatrixMarket matrix array real {sym}\n")
            if comment:
                f.write(f"% {comment}\n")
            f.write(f"{A.shape[0]} {A.shape[1]}\n")
            if symmetric:
                il, jl = np.tril_indices(A.shape[0])
                order = np.lexsort((il, jl))  # column-major
                np.savetxt(f, A[il[order], jl[order]], fmt="%.9g")
            else:
                np.savetxt(f, A.T.reshape(-1), fmt="%.9g")  # column-major
    os.replace(tmp, path)
