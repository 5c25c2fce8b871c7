"""Device busy ms a step in kernels launched by ``train_step``: the model
step, outside the EDT, kernel 4 and the copies."""

from port_bench.harness.layers import busy_s, launched_in


def read(record):
    s = busy_s(record, launched_in("step"))
    return None if s is None else 1e3 * s / record.counters["steps"]
