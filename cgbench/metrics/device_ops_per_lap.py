"""device_ops_per_lap: device operations (kernels, copies, fills) in the
traced calls over the laps those calls ran: a lap's launches, torch ops and
the frozen laps the chunks enqueue, whatever the kernels are named."""


def read(record):
    t = record["trace"]
    if not t or not t["events"] or not t["laps"]:
        return None
    return len(t["events"]) / t["laps"]
