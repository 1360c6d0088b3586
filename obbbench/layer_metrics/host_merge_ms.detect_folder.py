"""Host milliseconds of the program's per-tile merges and fusion (the
stage timers ``detect/merge_<tile>`` and ``detect/fusion``), a megapixel
of the traced sheets."""


def value(trace, record, cell):
    mpix = sum(record.get("mpix", []))
    s = sum(v for k, v in trace.stages.items()
            if k.startswith("detect/merge_") or k == "detect/fusion")
    return 1e3 * s / mpix if mpix and s > 0 else None
