"""Device ms a step in kernels launched inside the data module's call of
the distance maps (``batch_one_hot2dist``)."""

from port_bench.harness.layers import busy_s, launched_in


def read(record):
    s = busy_s(record, launched_in("edt"))
    return None if s is None else 1e3 * s / record.counters["steps"]
