"""Share of the stream's steady window (``harness/steady.py``: from the end
of the first group's wait on the card to the start of the last group's)
in which no operation ran on the device."""

from obbbench.harness import steady as ST


def value(trace, record, cell):
    st = ST.steady(trace, record, cell)
    if st is None or not trace.kernels:
        return None
    return 100.0 * ST.length(st.idle(trace)) / st.seconds
