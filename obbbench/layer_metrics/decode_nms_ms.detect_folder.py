"""Device milliseconds of the kernels launched inside the ``decode_raw``
and ``postprocess_batch`` spans, a megapixel of the traced sheets."""


def value(trace, record, cell):
    mpix = sum(record.get("mpix", []))
    if not mpix:
        return None
    ms = 1e3 * (trace.kernel_seconds("obb/decode_raw")
                + trace.kernel_seconds("obb/postprocess_batch"))
    return ms / mpix if ms > 0 else None
