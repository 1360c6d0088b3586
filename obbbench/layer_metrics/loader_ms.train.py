"""Host milliseconds of ``TileDataset.batches`` a step: the wall time of
drawing one batch (labels, draws, the device mosaic, flip and HSV
queued) in the traced window."""


def value(trace, record, cell):
    ls = record.get("loader_s")
    return 1e3 * sum(ls) / len(ls) if ls else None
