"""ctypes bridge to the optional C++ fast text parser (``native/fastio.cpp``),
a copy of ``tpucg.io._native`` over the same ``native/libfastio.so``.

If the shared library is not built and cannot be, ``parse_floats`` returns
None and callers parse with NumPy; ``parse_floats_range`` (host-sharded
loading: a rank parses only its rows) returns None too when the library, or
its range symbol, is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _native_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native")


def _try_build() -> bool:
    """Build libfastio.so with make/g++, best-effort (make is a no-op when the
    library is fresh). Opt out with TPUCG_NO_NATIVE_BUILD=1."""
    if os.environ.get("TPUCG_NO_NATIVE_BUILD", "") == "1":
        return False
    if not os.path.exists(os.path.join(_native_dir(), "fastio.cpp")):
        return False
    try:
        proc = subprocess.run(
            ["make", "-C", _native_dir(), "libfastio.so"],
            capture_output=True,
            timeout=120,
        )
        return proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    _try_build()
    path = os.path.join(_native_dir(), "libfastio.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.fastio_parse_floats.restype = ctypes.c_longlong
        lib.fastio_parse_floats.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        try:
            lib.fastio_parse_floats_range.restype = ctypes.c_longlong
            lib.fastio_parse_floats_range.argtypes = [
                ctypes.c_char_p,
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
            ]
        except AttributeError:  # a stale library built before the range parser
            pass
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def parse_floats(path: str) -> Optional[np.ndarray]:
    """Parse all float tokens in ``path`` with the native library, or None.

    The buffer is an upper bound (a token needs >= 2 bytes with its
    separator), so no separate counting pass is needed.
    """
    lib = _load()
    if lib is None:
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        raise IOError(f"native parser failed to open {path!r}")
    cap = size // 2 + 1
    out = np.empty(cap, dtype=np.float32)
    got = lib.fastio_parse_floats(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap
    )
    if got < 0:
        raise IOError(f"native parser failed to open {path!r}")
    return out[:got].copy()


def parse_floats_range(path: str, start: int, count: int) -> Optional[np.ndarray]:
    """Parse the float tokens [start, start + count) of ``path`` with the
    native library (tpucg's), or None when the library or its range symbol
    is unavailable. ``IOError`` when the file cannot be opened,
    ``ValueError`` when it yields fewer tokens than asked."""
    lib = _load()
    if lib is None or not hasattr(lib, "fastio_parse_floats_range"):
        return None
    out = np.empty(count, dtype=np.float32)
    got = lib.fastio_parse_floats_range(
        os.fsencode(path), int(start), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(count))
    if got < 0:
        raise IOError(f"native parser failed to open {path!r}")
    if got != count:
        raise ValueError(f"{path!r}: requested tokens [{start}, {start + count}), file only "
                         f"yielded {got}")
    return out
