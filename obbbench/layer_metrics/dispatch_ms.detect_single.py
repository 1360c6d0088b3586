"""Host milliseconds a map of the program's ``detect/dispatch`` stage: the
time to enqueue every scale's device work (no synchronization inside)."""


def value(trace, record, cell):
    s = trace.stages.get("detect/dispatch")
    return 1e3 * s / record["units"] if s and record["units"] else None
