"""The data pipeline of the port: sequencers, transductive sequencers, the
CUDA-stream prefetcher and the TU-format loaders."""

from gnnkeras_tpu_torch.data.mutag import dataset_splits, load_mutag, load_tu_dataset, mutag_splits
from gnnkeras_tpu_torch.data.prefetch import PrefetchSequencer
from gnnkeras_tpu_torch.data.sequencers import (
    CompositeMultiGraphSequencer,
    CompositeSingleGraphSequencer,
    MultiGraphSequencer,
    SingleGraphSequencer,
)
from gnnkeras_tpu_torch.data.transductive import (
    TransductiveMultiGraphSequencer,
    TransductiveSingleGraphSequencer,
    get_transduction,
)

__all__ = [
    "MultiGraphSequencer",
    "SingleGraphSequencer",
    "CompositeMultiGraphSequencer",
    "CompositeSingleGraphSequencer",
    "TransductiveMultiGraphSequencer",
    "TransductiveSingleGraphSequencer",
    "PrefetchSequencer",
    "get_transduction",
    "load_mutag",
    "load_tu_dataset",
    "mutag_splits",
    "dataset_splits",
]
