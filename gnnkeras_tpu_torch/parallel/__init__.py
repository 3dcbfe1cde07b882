"""Distribution of the port over ``torch.distributed`` process groups, one
rank per process: ``mesh`` (groups, sub-groups by axis, each rank's device),
``collectives`` (differentiable all-gather and all-reduce), ``launch``
(starting the ranks of a run), ``partition`` (the edge-partitioned engine
for one large graph), ``data_parallel`` (one batch a rank, gradients
averaged over the real batches), ``packed`` (a merged molecule batch split
into whole graphs, no halo), ``tensor_parallel`` (the state net's features
sharded), ``hybrid`` (data × graph (× model) steps), ``multihost``
(meshes whose rows are hosts, the communication-volume model), ``expert``
(a composite GNN's per-type state nets sharded over the ranks) and
``pipeline`` (GPipe over an LGNN's layers, one a rank).

The names below are the JAX package's ``parallel`` names that the port has,
imported on first access.  ``stack_batches`` / ``shard_batches`` have no
counterpart (a rank picks its own batch of every group), nor has
``make_dp_epoch_step`` (the epoch runs one step a group):
``data_parallel``'s docstring says why.
"""

import importlib

_EXPORTS = {
    "device_count": "gnnkeras_tpu_torch.parallel.mesh",
    "make_mesh": "gnnkeras_tpu_torch.parallel.mesh",
    "make_dp_train_step": "gnnkeras_tpu_torch.parallel.data_parallel",
    "DataParallelTrainer": "gnnkeras_tpu_torch.parallel.data_parallel",
    "partition_graph": "gnnkeras_tpu_torch.parallel.partition",
    "PartitionedGraph": "gnnkeras_tpu_torch.parallel.partition",
    "PartitionedGNN": "gnnkeras_tpu_torch.parallel.partition",
    "partition_packed": "gnnkeras_tpu_torch.parallel.packed",
    "PackedPartitionedGNN": "gnnkeras_tpu_torch.parallel.packed",
    "PackedPartitionedLGNN": "gnnkeras_tpu_torch.parallel.packed",
    "split_merged_by_graph": "gnnkeras_tpu_torch.parallel.packed",
    "make_hybrid_train_step": "gnnkeras_tpu_torch.parallel.hybrid",
    "stack_partitioned": "gnnkeras_tpu_torch.parallel.hybrid",
    "TensorParallelGNN": "gnnkeras_tpu_torch.parallel.tensor_parallel",
    "TensorParallelMLP": "gnnkeras_tpu_torch.parallel.tensor_parallel",
    "initialize_multihost": "gnnkeras_tpu_torch.parallel.multihost",
    "make_multihost_mesh": "gnnkeras_tpu_torch.parallel.multihost",
    "comm_volume": "gnnkeras_tpu_torch.parallel.multihost",
    "ExpertParallelCompositeGNN": "gnnkeras_tpu_torch.parallel.expert",
    "PipelineLGNN": "gnnkeras_tpu_torch.parallel.pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'gnnkeras_tpu_torch.parallel' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
