"""setup_s: from the start of the process to the first timed call: imports,
the card's start, the inputs, the operator's placement and the warm call
(the first run in a checkout also builds the kernels)."""


def read(record):
    return record["setup_s"]
