"""Megapixels of the maps completed in the window over the window's
seconds (host clock, from the first call to the last completion)."""


def value(record: dict, cell):
    if "mpix" not in record or not record["window_s"]:
        return None
    return sum(record["mpix"]) / record["window_s"]
