"""Share of the roofline of the scale models' forwards: the forward FLOPs
of the traced sheets' tiles (the reference model's count) at the bf16
peak, over the device seconds of the kernels launched inside the
``forward_<tile>`` spans. The forward is compute bound: its bytes (the
tiles in, the weights, the head outputs) take under a tenth of that."""

from obbbench.harness import flops as FL


def value(trace, record, cell):
    dev = trace.kernel_seconds("obb/forward_")
    if dev <= 0:
        return None
    peak = FL.PEAK_FLOPS[cell.config["compute_dtype"]]
    return 100.0 * record["flops"] / peak / dev
