"""laps_per_solve: the mean over the window's calls of the laps a call ran
(its result's ``iterations``; the most of its columns for k columns)."""


def read(record):
    calls = record["calls"]
    return sum(c["laps"] for c in calls) / len(calls) if calls else None
