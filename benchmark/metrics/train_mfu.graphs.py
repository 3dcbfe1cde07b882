"""``train_mfu.graphs``: ``train_mfu`` in a training cell measured in graphs
a second."""

from benchmark.metrics.train_mfu import read  # noqa: F401
