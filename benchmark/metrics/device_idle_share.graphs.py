"""``device_idle_share.graphs``: the idle share of the traced stretch of a
training cell measured in graphs a second (``device_idle_share.idle_share``)."""

from benchmark.metrics.device_idle_share import idle_share


def read(record):
    return idle_share(record, "train")
