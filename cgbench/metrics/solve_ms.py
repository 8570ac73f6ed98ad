"""solve_ms: the window's wall time over the calls completed in it, in ms."""


def read(record):
    calls = record["calls"]
    return 1e3 * record["window_s"] / len(calls) if calls else None
