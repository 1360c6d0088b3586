"""Device milliseconds a step of the kernels launched inside the
``train_step`` spans that are not of the conv/gemm kind (the frozen kind
table): BatchNorm, activations, casts, the loss, the optimizer, the EMA."""


def value(trace, record, cell):
    steps = record.get("steps")
    if not steps:
        return None
    s = trace.kernel_seconds("obb/train_step", kind_not="conv_matmul")
    return 1e3 * s / steps if s > 0 else None
