"""Host milliseconds in the ``detect/wait`` spans that lie wholly in the
stream's steady window, a megapixel of their groups: large when the card
sets the pace."""

from obbbench.harness import steady as ST


def value(trace, record, cell):
    st = ST.steady(trace, record, cell)
    if st is None or not st.waits:
        return None
    mpix = sum(st.mpix[k] for k, _ in st.waits)
    return 1e3 * sum(s for _, s in st.waits) / mpix if mpix else None
