"""Device idle milliseconds, a megapixel of the steady window's groups,
while the host is inside a ``detect/merge_<tile>`` or ``detect/fusion``
span: the queue ran out before the host merges ended."""

from obbbench.harness import steady as ST


def is_merge(name: str) -> bool:
    return (name.startswith("obb/stage/detect/merge_")
            or name == "obb/stage/detect/fusion")


def value(trace, record, cell):
    st = ST.steady(trace, record, cell)
    if st is None or not trace.kernels:
        return None
    return 1e3 * st.idle_while(trace, is_merge) / st.group_mpix
