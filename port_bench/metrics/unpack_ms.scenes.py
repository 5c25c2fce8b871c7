"""Host ms a dispatch of the 2-bit unpack and stitching into each scene's
map, after the copy back: the port's ``scenes.unpack`` spans."""

from port_bench.harness.program_spans import ms_a


def read(record):
    return ms_a(record, ("scenes.unpack",), "dispatches")
