"""Host ms a step inside ``train_step``: the port's ``train.forward``,
``train.backward`` and ``train.update`` spans."""

from port_bench.harness.program_spans import STEP, ms_a


def read(record):
    return ms_a(record, STEP, "steps")
