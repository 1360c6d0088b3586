"""``torch.cuda.max_memory_allocated`` over the window, in GiB (the peak is
reset when the window opens)."""


def value(record: dict, cell):
    b = record.get("peak_bytes")
    return b / 2 ** 30 if b else None
