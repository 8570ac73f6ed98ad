"""The benchmark's command: one run of one cell on one card.

    python3 cgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``tpucg_torch``. With ``--trace
0`` the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a device trace of the window's first calls. The last
line of standard output is the result (JSON); the last lines of standard
error give each compared number beside its limit. With no card, with fewer
cards than the cell asks for, without the program beside this folder, or
with JAX or the JAX package loaded by the time the window closes, it prints
no result and exits non-zero.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def result_line(bench: dict, record: dict, trace: bool, device_kind: str, count: int) -> dict:
    from cgbench.harness import metric_values

    calls = record["calls"]
    attempted = sum(c["k"] for c in calls)
    line = {
        "correct": bool(record["correct"]),
        "attempted": attempted,
        "failed": attempted - sum(c["converged"] for c in calls),
        "metrics": metric_values(bench, record, trace),
        "device": {"platform": "gpu", "kind": device_kind, "count": count,
                   "memory_peak_bytes": int(record["memory_peak_bytes"])},
    }
    red = record["trace"]
    if trace and red is not None:
        line["device"].update(busy_s=red["busy_s"], window_s=red["window_s"])
        line["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    line["checks"] = record["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    try:
        import tpucg_torch
    except ImportError as e:
        print(f"cgbench: the program is not beside this folder ({e})", file=sys.stderr)
        return 3
    if ROOT not in Path(tpucg_torch.__file__).resolve().parents:
        print(f"cgbench: tpucg_torch was loaded from {tpucg_torch.__file__}, not from the "
              f"checkout {ROOT}", file=sys.stderr)
        return 3
    from cgbench import spec
    from cgbench.harness import execute
    from cgbench.roofline import card_power_limit

    bench = spec.load_benchmark()
    entry, _, _ = spec.load_cell(bench, args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cgbench: {args.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    record = execute(args.workload, args.seed, args.seconds, bool(args.trace), device, T_START,
                     bench=bench)
    if record["forbidden"]:
        print(f"cgbench: the process holds {', '.join(record['forbidden'])}: no result",
              file=sys.stderr)
        return 4
    line = result_line(bench, record, bool(args.trace), torch.cuda.get_device_name(device),
                       chips)
    print(f"card: {card_power_limit()}", file=sys.stderr)
    times = sorted(1e3 * c["s"] for c in record["calls"])
    half = len(record["calls"]) // 2
    if half:
        first = sum(c["s"] for c in record["calls"][:half]) / half
        second = sum(c["s"] for c in record["calls"][half:]) / (len(record["calls"]) - half)
        print(f"calls: ms p10 {times[len(times) // 10]:.4f} p50 {times[len(times) // 2]:.4f} "
              f"p90 {times[9 * len(times) // 10]:.4f}; mean of the first half "
              f"{1e3 * first:.4f}, of the second {1e3 * second:.4f}", file=sys.stderr)
    red = record["trace"]
    if red is not None and red.get("product_s") and red.get("least_product_s"):
        print(f"product: {red['products']} products of {red['calls']} traced calls, "
              f"{1e6 * red['product_s']:.3f} us each, least {1e6 * red['least_product_s']:.3f} us "
              f"({red['product_kernels'][0][:60]})", file=sys.stderr)
    extra = {k: v for k, v in record["numbers"].items() if k not in record["checks"]}
    print(f"phases: setup {record['setup_s']:.3f} s, window {record['window_s']:.3f} s, "
          f"{len(record['calls'])} calls, trace reduction {record['trace_s']:.3f} s, "
          f"reference {record['reference_s']:.3f} s", file=sys.stderr)
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in extra.items()), file=sys.stderr)
    for name, c in record["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
