"""The window's seconds over the optimizer steps it completed (host clock,
the device synchronized at the end; the loader's batches inside)."""


def value(record: dict, cell):
    steps = record.get("steps")
    return record["window_s"] / steps if steps else None
