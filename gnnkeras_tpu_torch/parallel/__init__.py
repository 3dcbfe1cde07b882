"""Distribution of the port over ``torch.distributed`` process groups, one
rank per process: ``mesh`` (groups, sub-groups by axis, each rank's device),
``collectives`` (differentiable all-gather and all-reduce), ``launch``
(starting the ranks of a run) and ``partition`` (the edge-partitioned
engine for one large graph)."""
