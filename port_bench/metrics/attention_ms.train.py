"""Device ms a step in attention kernels (the naming rule of
``harness/attention.py``: ``flash``, ``fmha``, ``attention`` or ``sdpa``
in the kernel's name, case folded)."""

from port_bench.harness import attention


def read(record):
    s = attention.device_s_a_step(record)
    return None if s is None else 1e3 * s
