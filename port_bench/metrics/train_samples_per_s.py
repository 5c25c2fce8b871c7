"""Samples of every step launched in the window over the window, which
ends with a synchronise, so every one of them has finished; host clock."""


def read(record):
    return record.counters["samples"] / record.window_s
