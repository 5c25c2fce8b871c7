"""Subtiles of every scene whose class map came back to the host in the
window, over the window; host clock."""


def read(record):
    return record.counters["tiles"] / record.window_s
