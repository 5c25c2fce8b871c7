"""The attention's share of its roofline: the bound of a step's attention
at the traffic's tile and batch (``harness/attention.py``: each block's
FLOPs at the bf16 peak or its bytes at the memory bandwidth, whichever
takes longer) over the device time a step in attention kernels."""

from port_bench.harness import attention, spec


def read(record):
    s = attention.device_s_a_step(record)
    if s is None:
        return None
    cell = spec.cell(record.cell)
    return 100.0 * attention.step_bound_s(cell.config, cell.traffic) / s
