"""operator_build_s: host seconds, synchronised, from the harness's arrays to
the placed operator (promotion, packing, upload), once a run."""


def read(record):
    return record["build_s"]
