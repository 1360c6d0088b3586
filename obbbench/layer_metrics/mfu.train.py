"""The whole step's share of the card's peak: the FLOPs of the traced
window's work (the reference model's count) over the window's seconds,
against the dense peak of the compute dtype."""

from obbbench.harness import flops as FL


def value(trace, record, cell):
    w = trace.window_s
    if w <= 0 or not record.get("flops") or not trace.kernels:
        return None
    return 100.0 * record["flops"] / w / FL.PEAK_FLOPS[
        cell.config["compute_dtype"]]
