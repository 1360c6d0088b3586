"""Share of the roofline of the CSPNeXt blocks' depthwise ConvBNs: the
larger of their FLOPs at the bf16 peak and their bytes at the memory
bandwidth (``archs/<model>.py::depthwise_work``, counted on the
reference's depthwise ConvBNs, times the traced sheets' tiles) over the
device seconds of the kernels launched inside the program's
``forward_depthwise`` spans. Nothing to read where the architecture counts
no depthwise work or the program has no such span."""

from obbbench.harness import flops as FL


def value(trace, record, cell):
    dev = trace.kernel_seconds("obb/forward_depthwise")
    work = getattr(cell.arch, "depthwise_work", None)
    if dev <= 0 or work is None or not record.get("flops"):
        return None
    cfg = cell.config
    ts = [s["tile_size"] for s in cfg["scales"]]
    if len(ts) != 1:
        return None
    flops, nbytes = work(cfg, ts[0])
    tiles = record["flops"] / cell.arch.forward_flops(cfg, ts[0])
    seconds = max(tiles * flops / FL.PEAK_FLOPS[cfg["compute_dtype"]],
                  tiles * nbytes / FL.PEAK_BYTES_PER_S)
    return 100.0 * seconds / dev
