"""Host ms a step inside the batch stream's ``next()`` (the data path:
producer queue, upload, kernel 4's program, the EDT launches), from the
benchmark's own spans."""


def read(record):
    steps = record.counters["steps"]
    return 1e3 * record.span_s("batch") / steps if steps else None
