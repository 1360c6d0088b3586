"""Share of the traced window in which no operation ran on the device."""


def value(trace, record, cell):
    w = trace.window_s
    return 100.0 * (1.0 - trace.busy_s / w) if w > 0 and trace.kernels \
        else None
