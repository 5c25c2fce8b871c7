"""Share of the traced window outside the union of kernel, copy and
memset intervals."""

from port_bench.harness.layers import idle_pct


def read(record):
    return idle_pct(record)
