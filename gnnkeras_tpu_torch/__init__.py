"""gnnkeras_tpu_torch: the PyTorch/CUDA port of gnnkeras_tpu for NVIDIA Hopper.

It imports neither JAX nor the ``gnnkeras_tpu`` package.  Entry points take
``device=`` (default ``"cuda"``) and raise when no card is present instead of
running on the CPU; pass ``device="cpu"`` to run the plain PyTorch versions
of the kernels.  Kernels are hand-written CUDA in ``csrc/``, built at first
use (``gnnkeras_tpu_torch.kernels``).
"""

import torch

# float32 products in true float32: the JAX reference on the CPU computes in
# f32, and TF32 (cuDNN's default for convolutions) keeps ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gnnkeras_tpu_torch.graph.batch import GraphBatch, from_graph_object, graphs_to_batch  # noqa: E402
from gnnkeras_tpu_torch.graph.graph import GraphObject  # noqa: E402
from gnnkeras_tpu_torch.models.gnn import GNNarcBased, GNNgraphBased, GNNnodeBased  # noqa: E402
from gnnkeras_tpu_torch.models.mlp import MLP, get_inout_dims  # noqa: E402
from gnnkeras_tpu_torch.serving import Predictor  # noqa: E402

__all__ = [
    "GraphBatch",
    "GraphObject",
    "GNNarcBased",
    "GNNgraphBased",
    "GNNnodeBased",
    "MLP",
    "Predictor",
    "from_graph_object",
    "get_inout_dims",
    "graphs_to_batch",
]
