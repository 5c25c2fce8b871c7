"""Kernel 4's share of its roofline: its bound at the batch's shape
(``peaks.augment_bound_s``) over its mean device time a launch."""

from port_bench.harness.peaks import augment_bound_s

KERNEL = "augment_vec_kernel"


def read(record):
    if record.trace is None:
        return None
    runs = [e.dur_us for e in record.trace.in_window() if e.kind == "kernel" and KERNEL in e.name]
    if not runs:
        return None
    return 100.0 * augment_bound_s(record.facts["augment_shape"]) / (sum(runs) / len(runs) / 1e6)
