"""95th percentile of the latency of every map in the window, from the
call to its fused rows (host clock), linear between order statistics."""

import numpy as np


def value(record: dict, cell):
    lat = record.get("latency_s")
    return float(np.percentile(lat, 95)) if lat else None
