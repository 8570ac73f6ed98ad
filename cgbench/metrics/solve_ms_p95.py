"""solve_ms_p95: the 95th percentile (nearest rank) of every call's time in
the window, in ms."""

import math


def read(record):
    times = sorted(c["s"] for c in record["calls"])
    if not times:
        return None
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
