"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` and
``workloads/<cell>.json``; a metric ``<name>`` reads
``metrics/<name>.py``, a module with ``read(record) -> float or None``, or,
where there is none, ``metrics/<base>.py`` for the name before its first
dot: the splits of one quantity by what it moves (``laps_per_solve.single``,
``laps_per_solve.dense``) share their base's reader.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def load_cell(bench: dict, cell: str):
    """(the cell's entry, its configuration, its workload file) by name."""
    entry = _by_name(bench["workloads"], cell, "workload")
    cfg_entry = _by_name(bench["configs"], entry["config"], "configuration")
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    workload = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    if workload["config"] != entry["config"]:
        raise ValueError(f"workloads/{cell}.json names configuration {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    return entry, config, workload


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on. An entry without a
    ``workloads`` key belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py`` where it exists, else ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader metrics/{name}.py or {path.relative_to(HERE)}")
    return path


def load_reader(name: str):
    """The reader module of metric ``name`` (see ``reader_path``)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"cgbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
