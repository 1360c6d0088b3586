"""Seconds from the process's start to the window's: imports, the
inputs made from the seed, the weights loaded, the warm-up of every shape
the window uses (and, in a checkout's first run, the builds)."""


def value(record: dict, cell):
    return record["setup_s"]
