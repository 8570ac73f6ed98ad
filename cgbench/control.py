"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size: the program's numbers over many seeds (the lower
reading is their largest) and the control's over a few (the upper reading
is their smallest). The control stands in the program's place: the plain
reference in TF32 for a configuration that states float32 with TF32 off,
else the program's own bfloat16 storage. The benchmark's runs never run
this.

    python3 cgbench/control.py --workload <cell> --seconds 4 \\
        --program-seeds 12 --control-seeds 3 [--first-seed N] [--out FILE]

Every seed runs the cell's set-up and a short window at the cell's own load
in this one process, then the comparison, exactly as a run does.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from cgbench import spec
    from cgbench.harness import execute
    from cgbench.solvers import control_for

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    _, config, workload = spec.load_cell(bench, args.workload)
    rows = []
    plan = [("program", args.first_seed + i) for i in range(args.program_seeds)]
    plan += [("control", args.first_seed + 1000 + i) for i in range(args.control_seeds)]
    for side, seed in plan:
        solver = control_for(config, workload, dev) if side == "control" else None
        t0 = time.time()
        try:
            rec = execute(args.workload, seed, args.seconds, False, dev, t0, bench=bench,
                          solver=solver)
            row = {"side": side, "seed": seed, "calls": len(rec["calls"]),
                   "laps_mean": sum(c["laps"] for c in rec["calls"]) / len(rec["calls"]),
                   "ms_mean": 1e3 * rec["window_s"] / len(rec["calls"]),
                   "correct": rec["correct"], **rec["numbers"]}
        except Exception as e:  # a control that crashes gives no number
            traceback.print_exc()
            row = {"side": side, "seed": seed, "error": f"{type(e).__name__}: {e}"}
        row["wall_s"] = time.time() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = [k for k in workload["limits"]]
    for name in names + ["anorm_err", "true_res"]:
        prog = [r[name] for r in rows if r["side"] == "program" and name in r]
        ctrl = [r[name] for r in rows if r["side"] == "control" and name in r]
        print(f"{args.workload} {name}: program max {max(prog) if prog else None!r} over "
              f"{len(prog)} seeds; control min {min(ctrl) if ctrl else None!r} over "
              f"{len(ctrl)} seeds", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
