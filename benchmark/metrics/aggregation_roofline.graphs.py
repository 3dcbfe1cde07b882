"""``aggregation_roofline.graphs``: the aggregation kernels' share of their
roofline in a training cell measured in graphs a second
(``aggregation_roofline.roofline_share``)."""

from benchmark.metrics.aggregation_roofline import roofline_share


def read(record):
    return roofline_share(record, "train")
