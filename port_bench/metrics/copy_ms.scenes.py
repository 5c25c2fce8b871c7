"""Device ms a dispatch of host-to-device and device-to-host copies."""


def read(record):
    if record.trace is None:
        return None
    runs = [e.dur_us for e in record.trace.in_window() if e.kind in ("H2D", "D2H")]
    return 1e-3 * sum(runs) / record.counters["dispatches"] if runs else None
