"""Device milliseconds of the kernels launched inside the program's
``forward_area_attn`` spans (each ``AAttn`` forward: qkv, the attention
core, the gather of v, pe, proj and their epilogues), a megapixel of the
traced sheets. Nothing to read where the program has no such span."""


def value(trace, record, cell):
    mpix = sum(record.get("mpix", []))
    ms = 1e3 * trace.kernel_seconds("obb/forward_area_attn")
    return ms / mpix if mpix and ms > 0 else None
