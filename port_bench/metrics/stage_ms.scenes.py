"""Host ms a dispatch of ``predict_scenes``'s staging (Tilers, the
validity stack, the pinned staging and the upload, with its wait for the
slot's previous upload): the port's ``scenes.stage`` spans."""

from port_bench.harness.program_spans import ms_a


def read(record):
    return ms_a(record, ("scenes.stage",), "dispatches")
