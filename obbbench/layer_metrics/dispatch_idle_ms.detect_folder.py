"""Device idle milliseconds, a megapixel of the steady window's groups,
while the host is inside a ``detect/dispatch`` span (its children
included): the refill of the queue after each wait."""

from obbbench.harness import steady as ST


def value(trace, record, cell):
    st = ST.steady(trace, record, cell)
    if st is None or not trace.kernels:
        return None
    return 1e3 * st.idle_while(trace, lambda n: n == ST.DISPATCH) \
        / st.group_mpix
