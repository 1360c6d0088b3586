"""Device milliseconds of the kernels launched inside the program's
``forward_depthwise`` spans (each CSPNeXt block's depthwise 5x5 ConvBN: its
convolution and its epilogue), a megapixel of the traced sheets. Nothing
to read where the architecture counts no depthwise work or the program has
no such span."""


def value(trace, record, cell):
    if getattr(cell.arch, "depthwise_work", None) is None:
        return None
    mpix = sum(record.get("mpix", []))
    ms = 1e3 * trace.kernel_seconds("obb/forward_depthwise")
    return ms / mpix if mpix and ms > 0 else None
