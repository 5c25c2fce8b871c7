"""Host ms a step in the data module's call of the distance maps (the
EDT's launches): the port's ``data.edt`` spans."""

from port_bench.harness.program_spans import ms_a


def read(record):
    return ms_a(record, ("data.edt",), "steps")
