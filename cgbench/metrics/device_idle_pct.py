"""device_idle_pct: the share of the traced window in which no device
operation ran, in %."""


def read(record):
    t = record["trace"]
    if not t or not t["events"] or not t["window_s"] > 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
