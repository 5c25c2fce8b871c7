"""Host ms a step that the thread calling ``next()`` spent blocked on the
batch producer's queue: the port's ``data.wait`` spans."""

from port_bench.harness.program_spans import ms_a


def read(record):
    return ms_a(record, ("data.wait",), "steps")
