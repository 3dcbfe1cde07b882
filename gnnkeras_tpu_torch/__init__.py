"""gnnkeras_tpu_torch: the PyTorch/CUDA port of gnnkeras_tpu for NVIDIA Hopper.

It imports neither JAX nor the ``gnnkeras_tpu`` package.  Entry points take
``device=`` (default ``"cuda"``) and raise when no card is present instead of
running on the CPU; pass ``device="cpu"`` to run the plain PyTorch versions
of the kernels.  Kernels are hand-written CUDA in ``csrc/``, built at first
use (``gnnkeras_tpu_torch.kernels``).

The names below are imported on first access, so that a process that only
runs an exported artifact (``load_exported``) never imports the model
classes.
"""

import importlib

import torch

# float32 products in true float32: the JAX reference on the CPU computes in
# f32, and TF32 (cuDNN's default for convolutions) keeps ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_EXPORTS = {
    "GraphBatch": "gnnkeras_tpu_torch.graph.batch",
    "from_graph_object": "gnnkeras_tpu_torch.graph.batch",
    "graphs_to_batch": "gnnkeras_tpu_torch.graph.batch",
    "GraphObject": "gnnkeras_tpu_torch.graph.graph",
    "CompositeGraphObject": "gnnkeras_tpu_torch.graph.graph",
    "CompositeGNNarcBased": "gnnkeras_tpu_torch.models.composite",
    "CompositeGNNgraphBased": "gnnkeras_tpu_torch.models.composite",
    "CompositeGNNnodeBased": "gnnkeras_tpu_torch.models.composite",
    "LGNN": "gnnkeras_tpu_torch.models.lgnn",
    "CompositeLGNN": "gnnkeras_tpu_torch.models.lgnn",
    "GNNarcBased": "gnnkeras_tpu_torch.models.gnn",
    "GNNgraphBased": "gnnkeras_tpu_torch.models.gnn",
    "GNNnodeBased": "gnnkeras_tpu_torch.models.gnn",
    "MLP": "gnnkeras_tpu_torch.models.mlp",
    "get_inout_dims": "gnnkeras_tpu_torch.models.mlp",
    "MultiGraphSequencer": "gnnkeras_tpu_torch.data.sequencers",
    "SingleGraphSequencer": "gnnkeras_tpu_torch.data.sequencers",
    "CompositeMultiGraphSequencer": "gnnkeras_tpu_torch.data.sequencers",
    "CompositeSingleGraphSequencer": "gnnkeras_tpu_torch.data.sequencers",
    "PrefetchSequencer": "gnnkeras_tpu_torch.data.prefetch",
    "TransductiveMultiGraphSequencer": "gnnkeras_tpu_torch.data.transductive",
    "TransductiveSingleGraphSequencer": "gnnkeras_tpu_torch.data.transductive",
    "load_mutag": "gnnkeras_tpu_torch.data.mutag",
    "load_tu_dataset": "gnnkeras_tpu_torch.data.mutag",
    "MicroBatcher": "gnnkeras_tpu_torch.serving",
    "Predictor": "gnnkeras_tpu_torch.serving",
    "export_forward": "gnnkeras_tpu_torch.serving",
    "load_exported": "gnnkeras_tpu_torch.serving",
    "DataParallelTrainer": "gnnkeras_tpu_torch.parallel.data_parallel",
    "PartitionedGNN": "gnnkeras_tpu_torch.parallel.partition",
    "partition_graph": "gnnkeras_tpu_torch.parallel.partition",
    "PackedPartitionedGNN": "gnnkeras_tpu_torch.parallel.packed",
    "PackedPartitionedLGNN": "gnnkeras_tpu_torch.parallel.packed",
    "partition_packed": "gnnkeras_tpu_torch.parallel.packed",
    "TensorParallelGNN": "gnnkeras_tpu_torch.parallel.tensor_parallel",
    "make_hybrid_train_step": "gnnkeras_tpu_torch.parallel.hybrid",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'gnnkeras_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
