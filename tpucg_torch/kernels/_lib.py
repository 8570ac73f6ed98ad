"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (``csrc/blas.cuh``) and bound with ctypes. The
build happens at first use, from the sources in this package and nothing
else, into ``build/tpucg_torch/`` at the root of the checkout: one ``nvcc``
per ``.cu`` file, all started together, then one link. The library's file
name carries a hash of the sources and flags, so a stale build is never
loaded; the linker writes to a temporary file that is renamed into place,
so concurrent processes never load a half-written library. A failed build
or load raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpucg_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p  # every pointer and the stream: a c_int would cut them
_LEN = ctypes.c_longlong

# name -> (restype, argtypes) of every C entry point this package calls.
SIGNATURES = {
    "tpucg_gemv_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_gemv_bf16": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_dot_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _PTR, _LEN, _PTR, _PTR]),
    "tpucg_dot_alpha_f32": (
        ctypes.c_int, [_PTR] * 6 + [ctypes.c_int, _LEN, _PTR, _PTR]),
    "tpucg_dot_tail_f32": (ctypes.c_int, [_PTR] * 5 + [_LEN, _PTR]),
    "tpucg_fused_update_f32": (
        ctypes.c_int,
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _LEN, _PTR, _PTR],
    ),
    "tpucg_fused_update_tail_f32": (ctypes.c_int, [_PTR] * 10 + [_LEN, _PTR]),
    "tpucg_p_update_f32": (ctypes.c_int, [_PTR] * 5 + [_LEN, _PTR]),
    "tpucg_reduce_blocks": (ctypes.c_int, [_LEN]),
    "tpucg_fused_cg_f32": (
        ctypes.c_int,
        [_PTR] * 8 + [_LEN, ctypes.c_float, _LEN] + [ctypes.c_int] * 5 + [_PTR],
    ),
    "tpucg_fused_cg_plan": (ctypes.c_int, [_LEN, ctypes.c_int, ctypes.c_int, _PTR]),
    "tpucg_fused_cg_scratch": (ctypes.c_longlong, [_LEN]),
    "tpucg_fused_batch_cg_f32": (
        ctypes.c_int,
        [_PTR] * 7 + [_LEN, _LEN, ctypes.c_float, _LEN, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _PTR],
    ),
    "tpucg_fused_batch_clusters": (ctypes.c_int, [_LEN, ctypes.c_int]),
    "tpucg_dia_spmv_f32": (ctypes.c_int, [_PTR, _PTR, ctypes.c_int, _PTR, _PTR, _LEN, _PTR, _PTR]),
    "tpucg_dia_spmv_bf16": (ctypes.c_int, [_PTR, _PTR, ctypes.c_int, _PTR, _PTR, _LEN, _PTR, _PTR]),
    "tpucg_dia_spmv_halo_f32": (
        ctypes.c_int, [_PTR, _PTR, ctypes.c_int] + [_PTR] * 4 + [_LEN, _LEN, _PTR, _PTR]),
    "tpucg_dia_spmv_halo_bf16": (
        ctypes.c_int, [_PTR, _PTR, ctypes.c_int] + [_PTR] * 4 + [_LEN, _LEN, _PTR, _PTR]),
    "tpucg_dia_spmv_multi_f32": (
        ctypes.c_int, [_PTR, _PTR, ctypes.c_int, _PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_dia_spmv_multi_bf16": (
        ctypes.c_int, [_PTR, _PTR, ctypes.c_int, _PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_poisson3d_f32": (ctypes.c_int, [_PTR, _PTR, _LEN, _PTR, _PTR]),
    "tpucg_poisson3d_multi_f32": (ctypes.c_int, [_PTR, _PTR, _LEN, _LEN, _PTR, _PTR]),
    "tpucg_poisson3d_slab_f32": (ctypes.c_int, [_PTR] * 4 + [_LEN, _LEN, _PTR, _PTR]),
    "tpucg_poisson3d_march_f32": (
        ctypes.c_int, [_PTR] * 4 + [_LEN, _LEN] + [ctypes.c_int] * 3 + [_PTR, _PTR]),
    "tpucg_poisson3d_march_plan": (ctypes.c_int, [_LEN, _LEN, _PTR]),
    "tpucg_fused_stencil_cg_f32": (
        ctypes.c_int,
        [_PTR] * 6 + [_LEN, ctypes.c_int, ctypes.c_int, ctypes.c_float, _LEN, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, _PTR],
    ),
    "tpucg_fused_stencil_grid": (ctypes.c_int, [_LEN]),
    "tpucg_fused_dia_cg_f32": (
        ctypes.c_int,
        [_PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [_PTR] * 7
        + [_LEN, ctypes.c_float, _LEN, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PTR],
    ),
    "tpucg_fused_dia_cg_bf16": (
        ctypes.c_int,
        [_PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [_PTR] * 7
        + [_LEN, ctypes.c_float, _LEN, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PTR],
    ),
    "tpucg_fused_dia_grid": (ctypes.c_int, [_LEN, ctypes.c_int]),
    "tpucg_fused_sparse_scratch": (ctypes.c_longlong, [_LEN]),
    "tpucg_fused_batch_dia_cg_f32": (
        ctypes.c_int,
        [_PTR, _PTR, ctypes.c_int, ctypes.c_int] + [_PTR] * 5
        + [_LEN, _LEN, ctypes.c_float, _LEN] + [ctypes.c_int] * 3 + [_PTR],
    ),
    "tpucg_fused_batch_dia_cg_bf16": (
        ctypes.c_int,
        [_PTR, _PTR, ctypes.c_int, ctypes.c_int] + [_PTR] * 5
        + [_LEN, _LEN, ctypes.c_float, _LEN] + [ctypes.c_int] * 3 + [_PTR],
    ),
    "tpucg_fused_batch_dia_plan": (
        ctypes.c_int, [_LEN, _LEN] + [ctypes.c_int] * 4 + [_PTR]),
    "tpucg_well_spmv_f32": (ctypes.c_int, [_PTR] * 6 + [_LEN, _LEN, ctypes.c_int, _PTR, _PTR]),
    "tpucg_well_spmv_bf16": (ctypes.c_int, [_PTR] * 6 + [_LEN, _LEN, ctypes.c_int, _PTR, _PTR]),
    "tpucg_well_spmv_multi_f32": (
        ctypes.c_int, [_PTR] * 6 + [_LEN, _LEN, ctypes.c_int, _LEN, _PTR, _PTR]),
    "tpucg_well_spmv_multi_bf16": (
        ctypes.c_int, [_PTR] * 6 + [_LEN, _LEN, ctypes.c_int, _LEN, _PTR, _PTR]),
    "tpucg_probe_lane_gather_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, ctypes.c_int, _PTR]),
    "tpucg_probe_sub_gather_f32": (
        ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, _LEN, ctypes.c_int, ctypes.c_int, _PTR]),
    "tpucg_probe_row_gather_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, _PTR]),
    "tpucg_probe_elem_gather_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, ctypes.c_int, _PTR]),
    "tpucg_probe_dynslice_f32": (
        ctypes.c_int, [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, _PTR]),
    "tpucg_probe_roll_dyn_f32": (ctypes.c_int, [_PTR, _PTR, _PTR, _LEN, ctypes.c_int, _PTR]),
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
    it as ``.log``. Processes that start together (the ranks of a
    distributed solve) build one at a time under a file lock beside the
    build directory: the first builds, the others find its library."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR.with_name(BUILD_DIR.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _compile(path)
    return path


def _compile(path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objdir = Path(tempfile.mkdtemp(prefix=".objs.", dir=BUILD_DIR))
    try:
        exe = nvcc()
        cus = [s for s in sources() if s.suffix == ".cu"]
        objs = [objdir / f"{s.stem}.o" for s in cus]
        compiles = [[exe, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        steps = [(c, p.communicate()[0], p.returncode) for c, p in zip(compiles, procs)]
        if all(rc == 0 for _, _, rc in steps):
            link = [exe, ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            steps.append((link, proc.stdout, proc.returncode))
        log = "".join(f"$ {' '.join(c)}\n{out}" for c, out, _ in steps)
        bad = [rc for _, _, rc in steps if rc != 0]
        if bad:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit {bad[0]}):\n{log}")
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


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
    """Partials of an n-element K2/K3 reduction (their scratch holds one int
    more: the ticket)."""
    return int(load().tpucg_reduce_blocks(n))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        msg = load().tpucg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
