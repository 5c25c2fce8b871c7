"""Batches ready in the producer's queue just before a get (at most
``prefetch + 1``), the mean over the window's gets: the port's
``data.queue_depth`` counter."""

from port_bench.harness.program_spans import counter_mean


def read(record):
    return counter_mean(record, "data.queue_depth")
