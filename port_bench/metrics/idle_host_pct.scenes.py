"""Share of the traced window in which the device ran nothing while the
caller was inside ``scenes.stage`` or ``scenes.unpack``."""

from port_bench.harness.program_spans import SCENES_HOST, idle_within_pct


def read(record):
    return idle_within_pct(record, SCENES_HOST)
