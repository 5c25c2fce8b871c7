"""Device ms a dispatch in kernels: the chunk program's replay, the
blocks, stitching and the 2-bit pack."""

from port_bench.harness.layers import busy_s


def read(record):
    s = busy_s(record, lambda e: e.kind == "kernel")
    return None if s is None else 1e3 * s / record.counters["dispatches"]
