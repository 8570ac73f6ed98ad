"""BENCHMARK.json against the rules for its fields, every piece found by
name, the import guard, and the command's refusals without a card or
without the program."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from cgbench import harness, spec
from cgbench.tests._small import small_config

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
FILE_RE = re.compile(r"^[A-Za-z0-9_.\-/]+$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    cmd = BENCH["command"]
    assert isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    for w in cmd:
        if "/" in w or w.endswith(".py"):
            assert not w.startswith("/") and ".." not in w.split("/")
            assert any(Path(w).parts[:len(Path(p).parts)] == Path(p).parts for p in paths)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells, 14 runs each, fits in 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert spec.NAME_RE.match(w["config"]) and spec.NAME_RE.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert spec.NAME_RE.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert spec.UNIT_RE.match(e["unit"]) and e["better"] in ("lower", "higher")
            for cell in e.get("workloads", []):
                assert cell in CELLS
    for f in spec.HERE.rglob("*"):
        if "__pycache__" not in f.parts and ".cache" not in f.parts:
            assert FILE_RE.match(f.relative_to(ROOT).as_posix()), f


def test_every_piece_is_found_by_name():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert Path(c["file"]).parts[0] in BENCH["paths"]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
        assert (spec.HERE / "gen" / f"{cfg['generator']}.py").is_file()
    for cell in CELLS:
        entry, cfg, wl = spec.load_cell(BENCH, cell)
        assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())
        assert wl["entry"] in ("cg_solve", "cg_solve_multi")
        assert (wl["k"] == 1) == (wl["entry"] == "cg_solve")
        assert wl["rhs"]["pool"] % wl["k"] == 0 and _line(wl["who"])
    readers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.load_reader(m["name"]).read)
        readers.add(spec.reader_path(m["name"]).name)
    assert readers == {f.name for f in (spec.HERE / "metrics").glob("*.py")}


def test_a_split_metric_falls_back_to_its_base_reader():
    assert spec.reader_path("laps_per_solve.dense") == spec.HERE / "metrics" / "laps_per_solve.py"
    assert spec.reader_path("solve_ms_p95") == spec.HERE / "metrics" / "solve_ms_p95.py"
    with pytest.raises(FileNotFoundError):
        spec.reader_path("no_such_metric.dense")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in spec.metrics_for(BENCH, cell, False)}
    layer = spec.metrics_for(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_names_split_by_what_they_move():
    by_base = {}
    for m in BENCH["per_layer"]:
        by_base.setdefault(m["name"].split(".")[0], set()).add(m["moves"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert "tpucg_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "tpucg_torch_fake_probe", sys)
    assert harness.forbidden_modules() == [] or "tpucg" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpucg", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    found = harness.forbidden_modules()
    assert "tpucg" in found and "jaxlib" in found and "tpucg_torch" not in found


_RUN_MODULES = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from cgbench import spec, harness
from cgbench.tests._small import small_config
bench = spec.load_benchmark()
for cell in [w["name"] for w in bench["workloads"]]:
    _, cfg, wl = spec.load_cell(bench, cell)
    wl = dict(wl, sample_calls=2)
    rec = harness.execute(cell, 5, 0.05, False, "cpu", time.time(), bench=bench,
                          config=small_config(cfg), workload=wl)
    assert rec["forbidden"] == [], rec["forbidden"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_imports_neither_jax_nor_tpucg():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN_MODULES, str(ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, env=dict(env, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpucg_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpucg"}, tops & {"jax", "jaxlib", "flax", "tpucg"}


def test_the_reference_imports_nothing_of_the_program():
    for f in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("tpucg_torch", "tpucg", "jax", "jaxlib"), \
                    (f.name, name)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import cgbench.reference.cg; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "tpucg" not in out.stdout, out.stdout + out.stderr


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "cgbench/run.py", "--workload", CELLS[0], "--seed", "3",
         "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    assert "card" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "cgbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys_and_checks_last(cell):
    sys.path.insert(0, str(spec.HERE))
    import run as run_cli  # cgbench/run.py

    _, cfg, wl = spec.load_cell(BENCH, cell)
    rec = harness.execute(cell, 2**31 + 1, 0.05, False, "cpu", time.time(), bench=BENCH,
                          config=small_config(cfg), workload=dict(wl, sample_calls=2))
    line = run_cli.result_line(BENCH, rec, False, "cpu-test", 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(wl["limits"])
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in spec.metrics_for(BENCH, cell, False)}
    assert set(line["metrics"]) == want
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_without_a_card_reads_no_device_metric(cell):
    """The traced path runs end to end on the CPU; with no device operation
    in its trace, every device metric is left out, never read as 0."""
    _, cfg, wl = spec.load_cell(BENCH, cell)
    rec = harness.execute(cell, 9, 0.05, True, "cpu", time.time(), bench=BENCH,
                          config=small_config(cfg), workload=dict(wl, sample_calls=2,
                                                                  trace_calls=1))
    assert rec["correct"] and rec["trace"] is not None and rec["trace"]["events"] == []
    got = harness.metric_values(BENCH, rec, True)
    device = {m["name"] for m in spec.metrics_for(BENCH, cell, True)
              if m["source"] == "device_trace"}
    assert device and not device & set(got)
    assert {"operator_build_s"} <= set(got) and any(k.startswith("laps_per_solve") for k in got)
