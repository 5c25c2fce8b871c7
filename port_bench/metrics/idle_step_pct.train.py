"""Share of the traced window in which the device ran nothing while the
host was inside ``train_step``'s spans (``train.forward``,
``train.backward``, ``train.update``)."""

from port_bench.harness.program_spans import STEP, idle_within_pct


def read(record):
    return idle_within_pct(record, STEP)
