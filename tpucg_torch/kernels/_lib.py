"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (``csrc/blas.cuh``) and bound with ctypes. The
build happens at first use, from the sources in this package and nothing
else, into ``build/tpucg_torch/`` at the root of the checkout. The library's
file name carries a hash of the sources and flags, so a stale build is never
loaded; the compiler writes to a temporary file that is renamed into place,
so concurrent processes never load a half-written library. A failed build
or load raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpucg_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_PTR = ctypes.c_void_p  # every pointer and the stream: a c_int would cut them
_LEN = ctypes.c_longlong

# name -> (restype, argtypes) of every C entry point this package calls.
SIGNATURES = {
    "tpucg_gemv_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_gemv_bf16": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_dot_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _PTR, _LEN, _PTR, _PTR]),
    "tpucg_fused_update_f32": (
        ctypes.c_int,
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _LEN, _PTR, _PTR],
    ),
    "tpucg_reduce_blocks": (ctypes.c_int, [_LEN]),
    "tpucg_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

_LIB = None


def sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpucg_kernels_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> Path:
    """Compile the library if this source hash has none yet; returns its path.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    it as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [
        str(s) for s in sources() if s.suffix == ".cu"
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, binding every entry point."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def reduce_blocks(n: int) -> int:
    """Length of the partial-sum scratch of an n-element K2/K3 reduction."""
    return int(load().tpucg_reduce_blocks(n))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        msg = load().tpucg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
