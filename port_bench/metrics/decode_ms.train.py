"""Host ms a decoded batch on the producer's thread (materialize, stack,
pin): the mean of the port's ``data.decode`` spans."""

from port_bench.harness.program_spans import mean_ms


def read(record):
    return mean_ms(record, "data.decode")
