"""Reference text-format and ``.npy`` I/O (a copy of ``tpucg.io.textio``).

The reference stores systems as one ASCII float per line, row-major, parsed
with ``fscanf("%f%*c")``: the ``%*c`` eats one separator, so stray bytes (a
UTF-8 BOM) are tolerated. Missing files and wrong counts fail loudly. The C++
fast parser (``native/fastio.cpp``) is used when its library is available.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from tpucg_torch.io import _native

# One float token (or inf/nan in any case, as fscanf %f accepts); anything
# else on a line is separator noise and is skipped.
_FLOAT_RE = re.compile(
    rb"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
    rb"|(?i:[-+]?(?:inf(?:inity)?|nan))"
)


def _parse_floats(path: str, dtype: np.dtype) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(f"input file {path!r} does not exist")
    if np.dtype(dtype) == np.float32:
        # The native parser emits float32; wider dtypes take the Python
        # tokenizer so no precision is lost to an f32 round trip.
        arr = _native.parse_floats(path)
        if arr is not None:
            return arr
    with open(path, "rb") as f:
        data = f.read()
    return np.array([float(t) for t in _FLOAT_RE.findall(data)], dtype=dtype)


def _read_values(path: str, dtype) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).reshape(-1).astype(dtype, copy=False)
    return _parse_floats(path, np.dtype(dtype))


def load_vector(path: str, n: Optional[int] = None, dtype=np.float32) -> np.ndarray:
    """Load a vector from the reference text format or a ``.npy`` file; with
    ``n``, the file must hold exactly n values."""
    vals = _read_values(path, dtype)
    if n is not None and vals.size != n:
        raise ValueError(f"{path!r}: expected {n} values, found {vals.size}")
    return vals


def load_matrix(path: str, n: Optional[int] = None, dtype=np.float32) -> np.ndarray:
    """Load a square row-major matrix; without ``n`` the file must hold a
    perfect-square number of values."""
    vals = _read_values(path, dtype)
    if n is None:
        n = int(round(np.sqrt(vals.size)))
        if n * n != vals.size:
            raise ValueError(
                f"{path!r}: {vals.size} values is not a square matrix; pass n"
            )
    elif vals.size != n * n:
        raise ValueError(f"{path!r}: expected {n * n} values, found {vals.size}")
    return vals.reshape(n, n)


def save_array(path: str, arr: np.ndarray, fmt: str = "%.4f") -> None:
    """Write an array one value per line, row-major; ``"%r"`` round-trips."""
    flat = np.asarray(arr).reshape(-1)
    with open(path, "w") as f:
        if fmt == "%r":
            f.writelines(f"{repr(float(v))}\n" for v in flat)
        else:
            f.writelines((fmt % v) + "\n" for v in flat)


def load_system(
    matrix_path: str,
    rhs_path: str,
    x0_path: Optional[str] = None,
    n: Optional[int] = None,
    dtype=np.float32,
):
    """Load (A, b, x0); x0 defaults to zeros when no path is given."""
    A = load_matrix(matrix_path, n=n, dtype=dtype)
    n = A.shape[0]
    b = load_vector(rhs_path, n=n, dtype=dtype)
    x0 = np.zeros(n, dtype=dtype) if x0_path is None else load_vector(x0_path, n=n, dtype=dtype)
    return A, b, x0
