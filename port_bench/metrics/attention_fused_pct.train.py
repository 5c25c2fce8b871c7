"""Share of the window's attention calls that took the fused path: the
mean of the port's ``model.attention_fused`` counter (1 a fused call, 0
a plain one) × 100."""

from port_bench.harness.program_spans import counter_mean


def read(record):
    v = counter_mean(record, "model.attention_fused")
    return None if v is None else 100.0 * v
