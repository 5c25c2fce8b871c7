"""The model's FLOPs a sample (forward and backward, counted on the
reference at the tile), times the samples of the traced window, over the
window and the card's bf16 dense peak."""

from port_bench.harness.peaks import BF16_FLOP_PER_S


def read(record):
    if record.trace is None:
        return None
    flops = record.facts["flops_per_sample"] * record.counters["samples"]
    return 100.0 * flops / record.trace.window_s / BF16_FLOP_PER_S
