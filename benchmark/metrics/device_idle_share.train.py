"""``device_idle_share.train``: the idle share of the traced stretch of a
training cell (``device_idle_share.idle_share``)."""

from benchmark.metrics.device_idle_share import idle_share


def read(record):
    return idle_share(record, "train")
