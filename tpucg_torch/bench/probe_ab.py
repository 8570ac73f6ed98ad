"""The probes' kernels of a parent checkout against this checkout's, in one
process:

    python -m tpucg_torch.bench.probe_ab PARENT_ROOT [--only P3 P4] [--reps 3]

``PARENT_ROOT`` is a checkout of the parent (``git archive`` of it unpacked
into an ignored directory, as for ``whole_solve_ab.py``). Its
``tpucg_torch.kernels.probe_gather`` is imported beside this checkout's, so
each side launches through its own wrappers, plans and C entry points, and
builds its own kernel library under its own root. The cases are
``whole_solve_ab.py``'s probe cases (and, for a prefix that names them, its
FEM 300k P4 cases), kept to the labels that start with a word of
``--only``; the parent's wrapper is the one of the change's name. Each case
runs on ``--copies`` copies of its operands at other addresses: parent and
change are held to each other bit for bit, then timed ``--reps`` times in
turns (parent first, then change first), µs a call queued behind a spin
kernel, rotating over the case's operand sets. Separate processes carry
offsets of their own of up to 0.1 µs; this is the comparison that sees
less. Then one launch's floor and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.probe_gather import launch_floor
from tpucg_torch.bench.timing import device_seconds_per_call, nvidia_smi_card, rotating
from tpucg_torch.bench.whole_solve_ab import FEM_PROBES, fem_probe_cases, probe_cases

PACKAGE = "tpucg_torch"


def _ours(name: str) -> bool:
    return name == PACKAGE or name.startswith(PACKAGE + ".")


def parent_probes(root: str):
    """The parent checkout's ``tpucg_torch.kernels.probe_gather``."""
    return parent_module(root, "kernels.probe_gather")


def parent_module(root: str, name: str):
    """The parent checkout's ``tpucg_torch.<name>`` (``parent_modules``)."""
    return parent_modules(root, name)[0]


def parent_modules(root: str, *names: str) -> tuple:
    """The parent checkout's ``tpucg_torch.<name>`` for each of ``names``,
    imported together from ``root`` (so they share one copy of the parent's
    package) with this checkout's package set aside, which is put back after
    (the parent's functions keep their own module globals, and its kernels'
    library builds under its own root)."""
    saved = {k: v for k, v in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(Path(root).resolve()))
    try:
        modules = tuple(importlib.import_module(f"{PACKAGE}.{name}") for name in names)
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    for module in modules:
        if Path(module.__file__).resolve().parents[2] != Path(root).resolve():
            raise RuntimeError(f"probe_ab: imported {module.__file__}, not the parent at {root}")
    return modules


def ab_lines(parent, cases: dict, reps: int, copies: int) -> list:
    """For each case, on each copy of its operands: the parent's and the
    change's µs a call, in turns; raises where the two differ."""
    lines = []
    for label, (launch, sets) in cases.items():
        mine = getattr(parent, launch.__name__)
        for c in range(copies):
            at = sets if c == 0 else [tuple(a.clone() for a in s) for s in sets]
            pair = {"parent": mine, "change": launch}
            if not torch.equal(mine(*at[0]), launch(*at[0])):
                raise RuntimeError(f"{label}: the parent's kernel and the change's differ")
            us = {k: [] for k in pair}
            for rep in range(reps):
                for k in (("parent", "change") if rep % 2 == 0 else ("change", "parent")):
                    calls = [lambda f=pair[k], a=a: f(*a) for a in at]
                    call = calls[0] if len(calls) == 1 else rotating(calls)
                    us[k].append(device_seconds_per_call(call) * 1e6)
            lines.append(f"{label}, operand copy {c} (0x{at[0][0].data_ptr():x}): " + "; ".join(
                f"{k} " + "/".join(f"{x:.3f}" for x in v) for k, v in us.items()))
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.probe_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", metavar="PARENT_ROOT", help="a checkout of the parent")
    ap.add_argument("--only", nargs="+", default=(), metavar="PREFIX")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--copies", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_ab measures on the card, and there is no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    parent = parent_probes(args.parent)
    card = nvidia_smi_card()
    print(f"device: {torch.cuda.get_device_name(dev)} [{card}]; parent {args.parent}; "
          "µs a call, queued", flush=True)
    def wanted(label: str) -> bool:
        return not args.only or any(label.startswith(w) for w in args.only)

    cases = {k: v for k, v in probe_cases(dev).items() if wanted(k)}
    if any(wanted(label) for label in FEM_PROBES):
        cases.update((k, v) for k, v in fem_probe_cases(dev).items() if wanted(k))
    for line in ab_lines(parent, cases, args.reps, args.copies):
        print(line, flush=True)
    print(f"launch floor (a one-element fill_, queued): {launch_floor(dev) * 1e6:.3f} us")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
