"""The frozen byte and operation arithmetic of the products, and the card's
published peaks.

Bytes are the least a product must move, counted from the matrix's own n,
nnz and the k columns, never from a layout: each matrix entry and, for a
sparse matrix, its int32 column once, the int32 row offsets once, X read and
Y written once (float32). ``nnz`` is the caller's: the harness passes the
number of distinct (row, column) entries, so that a layout that sums a
matrix's duplicates cannot read above the bound. The formulas are those of
``tpucg_torch.bench.timing`` (``gemv_bytes``, ``csr_spmv_bytes``,
``well_spmv_bytes`` over n rather than the padded length) and of the k-column
count in ``tpucg_torch.bench.k13_multi_ab``; the copy here does not move when
they do.
"""

from __future__ import annotations

import subprocess
from typing import Optional

# Published HBM bandwidth and float32 (non-tensor-core) rate of one card,
# by a substring of torch.cuda.get_device_name() (NVIDIA data sheets, at the
# card's full power limit).
PEAKS = (
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 80GB HBM3", 3.35e12, 67e12),
    ("H100 SXM", 3.35e12, 67e12),
)


def peaks(device_name: str):
    """(HBM bytes/s, f32 FLOP/s) of the card; raises for a card not on record."""
    for key, bw, flops in PEAKS:
        if key in device_name:
            return bw, flops
    raise ValueError(f"unknown card {device_name!r}: no peak on record")


def dense_product_bytes(n: int, k: int = 1, itemsize: int = 4) -> int:
    """A (n x n) once, X (n x k) read and Y (n x k) written once."""
    return n * n * itemsize + 8 * n * k


def sparse_product_bytes(n: int, nnz: int, k: int = 1, itemsize: int = 4) -> int:
    """Each entry's value and int32 column once, n + 1 int32 row offsets,
    X (n x k) read and Y (n x k) written once."""
    return nnz * (itemsize + 4) + 4 * (n + 1) + 8 * n * k


def product_flops(nnz: int, k: int = 1) -> int:
    """A multiply and an add per entry and column."""
    return 2 * nnz * k


def least_seconds(nbytes: int, flops: int, device_name: str) -> float:
    """The least time of one product: the larger of its bytes at the HBM
    peak and its operations at the float32 peak."""
    bw, fl = peaks(device_name)
    return max(nbytes / bw, flops / fl)


def card_power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card ("NVIDIA H100
    80GB HBM3, 700.00 W"), or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None
