"""Host ms a step in the data module's call of kernel 4's program: the
port's ``data.augment`` spans."""

from port_bench.harness.program_spans import ms_a


def read(record):
    return ms_a(record, ("data.augment",), "steps")
