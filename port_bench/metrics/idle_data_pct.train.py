"""Share of the traced window in which the device ran nothing while the
thread calling ``next()`` was inside one of the port's data-path spans
(``data.wait``, ``data.upload``, ``data.augment``, ``data.edt``)."""

from port_bench.harness.program_spans import DATA, idle_within_pct


def read(record):
    return idle_within_pct(record, DATA)
