"""tpucg_torch as a package: its import boundary, its kernel build, its CLI."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from tpucg_torch.io.golden import GOLDEN_2X2
from tpucg_torch.io.textio import save_array
from tpucg_torch.kernels import _lib

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpucg_torch"


def _run(*args, **kw):
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
        timeout=300, **kw,
    )


def test_import_pulls_in_no_jax_or_tpucg():
    code = (
        "import sys, json\n"
        "before = set(sys.modules)\n"
        "import tpucg_torch, tpucg_torch.kernels, tpucg_torch.solver.cg\n"
        "import tpucg_torch.interop, tpucg_torch.cli, tpucg_torch.bench\n"
        "import tpucg_torch.sparse, tpucg_torch.kernels.spmv, tpucg_torch.kernels.stencil\n"
        "import tpucg_torch.solver.fused, tpucg_torch.kernels.gather_spmv\n"
        "import tpucg_torch.io.mmio, tpucg_torch.sparse.well, tpucg_torch.sparse.ordering\n"
        "import tpucg_torch.comm, tpucg_torch.solver.sharded\n"
        "import tpucg_torch.kernels.probe_gather, tpucg_torch.bench.probe_gather\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'tpucg', 'triton')]\n"
        "print(json.dumps(bad))\n"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imports(tree):
    """(module name, at module level?) of every import in a parsed file."""
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, id(node) in top


def test_sources_import_no_jax_tpucg_or_module_level_triton():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        for mod, top in _imports(ast.parse(text)):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpucg"), f"{path}: imports {mod}"
            assert not (root == "triton" and top), f"{path}: imports triton at module level"
        assert "torch.compile" not in text, path


def test_kernels_import_nothing_above_them():
    # The kernels layer sits under the solver: no import of it reaches up,
    # not even one made at call time.
    above = ("solver", "io", "bench", "cli", "interop", "config")
    for path in sorted((PKG / "kernels").glob("*.py")):
        for mod, _ in _imports(ast.parse(path.read_text())):
            parts = mod.split(".")
            assert not (parts[0] == "tpucg_torch" and len(parts) > 1 and parts[1] in above), (
                f"{path}: imports {mod}")


def test_bound_entry_points_exist_in_csrc():
    csrc = "\n".join(p.read_text() for p in _lib.sources())
    header = (PKG / "kernels" / "csrc" / "blas.cuh").read_text()
    block = header[header.index('extern "C" {'):]
    declared = set(re.findall(r"\b(tpucg_\w+)\s*\(", block))
    defined = set(re.findall(r'extern "C" [\w\s\*]+?\b(tpucg_\w+)\s*\(', csrc))
    assert set(_lib.SIGNATURES) == declared == defined
    # Reductions are fixed-order: the only atomics draw integer tickets (K2,
    # K3 and p's update finish in the block that draws the last), never a
    # float sum.
    atomics = re.findall(r"\batomic\w*\(([^,]*),\s*([^)]*)\)", csrc)
    assert atomics and all(a == ("ticket", "1") for a in atomics), atomics
    ptx_atoms = re.findall(r"\batom\.[\w.]+", csrc)
    assert ptx_atoms and all(a.endswith(".add.s32") for a in ptx_atoms), ptx_atoms
    assert len(re.findall(r"\bint\* ticket\b", csrc)) >= 3
    assert not re.search(r"float\* ticket", csrc)
    assert "sm_90a" in " ".join(_lib.NVCC_FLAGS)
    assert "use_fast_math" not in " ".join(_lib.NVCC_FLAGS)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n{body}\n")
    path.chmod(0o755)
    return str(path)


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "nvcc", lambda: _fake_nvcc(
        tmp_path, "print('blas.cu(1): error: no such thing'); sys.exit(2)"))
    with pytest.raises(RuntimeError, match="no such thing"):
        _lib.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_build_renames_into_a_source_keyed_path(tmp_path, monkeypatch):
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "nvcc", lambda: _fake_nvcc(
        tmp_path, "open(args[args.index('-o') + 1], 'w').write('lib')\n"
                  "print('ptxas info    : Used 32 registers')"))
    path = _lib.build()
    assert path == _lib.library_path() and path.read_text() == "lib"
    assert re.fullmatch(r"libtpucg_kernels_[0-9a-f]{16}\.so", path.name)
    assert "Used 32 registers" in path.with_suffix(".log").read_text()
    assert sorted(p.name for p in path.parent.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])
    assert _lib.build() == path  # built once per source hash


def test_nvcc_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.nvcc()


def test_cli_selftest_passes_on_cpu():
    proc = _run("-m", "tpucg_torch", "selftest", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all selftests passed" in proc.stdout


def test_cli_info_reports_backend_library_and_peak():
    proc = _run("-m", "tpucg_torch", "info")
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout)
    assert info["kernel_backend"] in ("cuda", "torch")
    assert info["kernel_library"]["path"].endswith(".so")
    assert isinstance(info["kernel_library"]["built"], bool)
    assert "hbm_peak_bytes_per_s" in info


@pytest.mark.parametrize("fmt", ["text", "npy"])
def test_cli_solve_golden(tmp_path, fmt):
    g = GOLDEN_2X2
    paths = []
    for name in ("A", "b"):
        if fmt == "npy":
            p = tmp_path / f"{name}.npy"
            np.save(p, g[name])
        else:
            p = tmp_path / f"{name}.txt"
            save_array(str(p), g[name], fmt="%r")
        paths.append(str(p))
    out = tmp_path / "x.txt"
    proc = _run("-m", "tpucg_torch", "solve", *paths, "--device", "cpu",
                "--residual-history", "--output", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"iterations\s+:\s+2\b", proc.stdout)
    assert "||r_2||" in proc.stdout
    np.testing.assert_allclose(np.loadtxt(out), g["x_star"], atol=1e-6)


@pytest.mark.parametrize("operator", ["dense", "poisson-free", "poisson-dia", "poisson-ell",
                                      "poisson-bsr", "poisson-auto"])
def test_cli_bench_needs_the_card(operator):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _run("-m", "tpucg_torch", "bench", "--operator", operator, "--n", "128", "--m", "8",
                env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


def test_chip_smoke_fails_without_the_card():
    proc = _run("chip_smoke.py", env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
