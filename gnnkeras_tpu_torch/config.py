"""Typed configuration of an experiment (``GNNConfig``), the port's copy of
``gnnkeras_tpu.config``: the reference starters' options (graph, nets,
GNN, LGNN and learning parameters), the JAX package's engine options
(slot packing, strip and operator storage, the feature-major engine, the
distributed engine), validation, a JSON round trip readable by either
package, and factories for the port's models and sequencers on a device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple, Union


@dataclasses.dataclass
class GNNConfig:
    """All knobs of a (composite/layered) GNN experiment."""

    # graph options (starter.py:16-20)
    aggregation_mode: str = "average"
    focus: str = "g"

    # net state parameters (starter.py:23-25)
    activations_net_state: str = "selu"
    kernel_init_net_state: str = "lecun_normal"
    bias_init_net_state: str = "lecun_normal"

    # net output parameters (starter.py:28-30)
    activations_net_output: str = "softmax"
    kernel_init_net_output: str = "glorot_normal"
    bias_init_net_output: str = "glorot_normal"

    # gnn parameters (starter.py:33-35)
    dim_state: int = 0
    max_iter: int = 5
    state_threshold: float = 0.01

    # lgnn parameters (starter.py:38-41)
    layers: int = 1
    get_state: bool = True
    get_output: bool = True
    training_mode: str = "parallel"

    # learning parameters (starter.py:44-47)
    epochs: int = 10
    batch_size: int = 1000
    loss: str = "categorical_crossentropy"
    optimizer: str = "adam:0.01"
    metrics: Tuple[str, ...] = ("accuracy",)
    average_st_grads: bool = False

    # mlp extras (MLP.py:12-15 surface)
    hidden_units: Optional[Union[int, List[int]]] = None
    dropout_rate: Optional[float] = None
    dropout_pos: Optional[Union[int, List[int]]] = None
    alphadropout: bool = False
    batch_normalization: bool = True
    # beyond-reference: per-unfolding-iteration BatchNorm statistics
    # (Recurrent BatchNorm; see models/gnn.py) — off = reference semantics
    per_iteration_bn: bool = False

    # beyond-reference: single-device engine selection (the flagship's
    # feature-major strip engine).
    # slot_pack: None = auto (128 for every multi-graph sequencer focus),
    # 0 = off, 128 = force on.  Controls whether sequencer batches carry the
    # compact-strip operator that routes the feature-major unfold engine.
    slot_pack: Optional[int] = None
    # strip operator storage: 'int8' (mask+scale factorization, half the
    # bytes of bf16) | 'bfloat16' | 'float32'.  Non-factorable merges
    # degrade to bf16 with a RuntimeWarning (graph/batch.py).
    strip_dtype: str = "int8"
    # transposed (feature-major) unfold engine: None = the model's auto rule
    # (on for strip-carrying batches), True/False = force
    transposed: Optional[bool] = None
    # single-graph aggregation-operator storage (graph/batch.py agg_dtype):
    # 'auto' (default) takes the banded int8 mask+scale decomposition ONLY
    # when the factorization is numerically exact (no numerics change) and
    # keeps the plain float operator otherwise.  'int8' forces
    # quantization (bf16 degrade with a RuntimeWarning when non-factorable);
    # 'bfloat16'/'float32' cast; None leaves the operator float.  Applies to
    # the single-graph sequencer route; multi-graph batches quantize via
    # slot_pack strips (strip_dtype) instead.
    agg_dtype: Optional[str] = "auto"

    # beyond-reference: distributed execution engine (parallel/ tier).
    # none | dp (data parallel) | partitioned (range-sharded halo engine) |
    # packed (molecule-granular, graph focus) | pipeline (GPipe over LGNN
    # layers, needs layers>1 and dim_state>0) | expert (per-type experts,
    # composite models)
    parallel: str = "none"
    parallel_devices: int = 0  # 0 = all visible devices

    def __post_init__(self):
        # ValueError, not assert: validation must survive ``python -O``
        if self.focus not in ("a", "n", "g"):
            raise ValueError(f"bad focus {self.focus!r} (want 'a' | 'n' | 'g')")
        if self.training_mode not in ("serial", "parallel", "residual"):
            raise ValueError(f"bad training_mode {self.training_mode!r}")
        if not (self.dim_state >= 0 and self.max_iter >= 0 and self.state_threshold >= 0):
            raise ValueError("dim_state, max_iter and state_threshold must be >= 0")
        if self.layers < 1:
            raise ValueError(f"layers must be >= 1, got {self.layers}")
        if self.slot_pack not in (None, 0, 128):
            raise ValueError(
                f"bad slot_pack {self.slot_pack!r} (None = auto | 0 = off | 128); "
                "sub-128 mixed-format slots are a graph.batch.from_graph_object "
                "surface, not a sequencer one"
            )
        if self.strip_dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(
                f"bad strip_dtype {self.strip_dtype!r} (int8 | bfloat16 | float32)"
            )
        if self.transposed not in (None, True, False):
            raise ValueError(f"bad transposed {self.transposed!r} (None = auto | bool)")
        if self.agg_dtype not in (None, "auto", "int8", "bfloat16", "float32"):
            raise ValueError(
                f"bad agg_dtype {self.agg_dtype!r} "
                "(None | auto | int8 | bfloat16 | float32)"
            )
        if self.parallel not in ("none", "dp", "partitioned", "packed", "pipeline", "expert"):
            raise ValueError(
                f"bad parallel {self.parallel!r} "
                "(none | dp | partitioned | packed | pipeline | expert)"
            )
        if self.parallel == "pipeline" and (self.layers < 2 or self.dim_state <= 0):
            raise ValueError("parallel='pipeline' needs layers >= 2 and dim_state > 0")
        if self.parallel == "packed" and self.focus != "g":
            raise ValueError("parallel='packed' is graph-focused (focus='g') only")
        if self.parallel == "packed" and self.layers > 1 and self.training_mode == "serial":
            raise ValueError(
                "parallel='packed' with an LGNN stack needs training_mode "
                "'parallel' or 'residual' (serial is the reference's outer "
                "per-layer orchestration, LGNN.py:290-359)"
            )
        if self.parallel_devices < 0:
            raise ValueError("parallel_devices must be >= 0 (0 = all devices)")

    # -- persistence ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, payload: str) -> "GNNConfig":
        data = json.loads(payload)
        if "metrics" in data:
            data["metrics"] = tuple(data["metrics"])
        return cls(**data)

    # -- factories -----------------------------------------------------------
    def _mlp_pair(self, dim_node_label, dim_arc_label: int, dim_target: int, layer: int):
        from gnnkeras_tpu_torch.models.mlp import MLP, get_inout_dims

        inp_s, layers_s = get_inout_dims(
            "state", dim_node_label, dim_arc_label, dim_target, self.focus, self.dim_state,
            self.hidden_units, layer=layer, get_state=self.get_state, get_output=self.get_output,
        )
        nets_state = [
            MLP(
                input_dim=shape,
                layers=layers_s,
                activations=self.activations_net_state,
                kernel_initializer=self.kernel_init_net_state,
                bias_initializer=self.bias_init_net_state,
                dropout_rate=self.dropout_rate,
                dropout_pos=self.dropout_pos,
                alphadropout=self.alphadropout,
                batch_normalization=self.batch_normalization,
                name=f"state_{layer}_{t}",
            )
            for t, shape in enumerate(inp_s)
        ]

        import numpy as np

        if np.ndim(dim_node_label) > 0:
            # composite (any type count, incl. the reference's single-type
            # starter_composite): the shared output MLP reads the converged
            # state only (CompositeGNN.py:237-239 apply_filters) — dims
            # follow the model, not the reference's (broken for this case)
            # output formula.  At dim_state==0 the state IS the full node
            # matrix, whose width is the widest type's label.
            dims = [int(d) for d in np.atleast_1d(dim_node_label)]
            out_in = (self.dim_state,) if self.dim_state > 0 else (max(dims),)
        else:
            inp_o, _ = get_inout_dims(
                "output", dim_node_label, dim_arc_label, dim_target, self.focus, self.dim_state,
                layer=layer, get_state=self.get_state, get_output=self.get_output,
            )
            out_in = inp_o[0]
        net_output = MLP(
            input_dim=out_in,
            layers=[dim_target],
            activations=self.activations_net_output,
            kernel_initializer=self.kernel_init_net_output,
            bias_initializer=self.bias_init_net_output,
            batch_normalization=self.batch_normalization,
            name=f"out_{layer}",
        )
        return nets_state, net_output

    def build_model(self, dim_node_label, dim_arc_label: int, dim_target: int, device="cuda", seed: int = 0):
        """Construct, build (parameters from ``seed`` on ``device``) and
        compile the model this config describes."""
        import numpy as np

        from gnnkeras_tpu_torch.models.composite import (
            CompositeGNNarcBased,
            CompositeGNNgraphBased,
            CompositeGNNnodeBased,
        )
        from gnnkeras_tpu_torch.models.gnn import GNNarcBased, GNNgraphBased, GNNnodeBased
        from gnnkeras_tpu_torch.models.lgnn import LGNN, CompositeLGNN

        # ANY tuple dim (composite data, even single-type) builds the
        # composite model — the reference's own composite starter wraps
        # single-type MUTAG in CompositeGraphObjects and builds the composite
        # model for it (starter_composite.py:57-59)
        composite = np.ndim(dim_node_label) > 0
        homo_cls = {"n": GNNnodeBased, "a": GNNarcBased, "g": GNNgraphBased}[self.focus]
        comp_cls = {"n": CompositeGNNnodeBased, "a": CompositeGNNarcBased, "g": CompositeGNNgraphBased}[self.focus]

        gnns = []
        for layer in range(self.layers):
            nets_state, net_output = self._mlp_pair(dim_node_label, dim_arc_label, dim_target, layer)
            if composite:
                gnns.append(comp_cls(nets_state, net_output, self.dim_state, self.max_iter,
                                     self.state_threshold, per_iteration_bn=self.per_iteration_bn))
            else:
                gnns.append(homo_cls(nets_state[0], net_output, self.dim_state, self.max_iter,
                                     self.state_threshold, per_iteration_bn=self.per_iteration_bn))
            if self.transposed is not None:
                gnns[-1].transposed = self.transposed

        if self.layers == 1:
            model = gnns[0].build(seed=seed, device=device)
            model.compile(
                optimizer=self.optimizer, loss=self.loss, metrics=list(self.metrics),
                average_st_grads=self.average_st_grads,
            )
        else:
            model = (CompositeLGNN if composite else LGNN)(gnns, self.get_state, self.get_output)
            model.build(seed=seed, device=device)
            model.compile(
                optimizer=self.optimizer, loss=self.loss, metrics=list(self.metrics),
                average_st_grads=self.average_st_grads, training_mode=self.training_mode,
            )
        return model

    def build_sequencer(self, graphs, shuffle: bool = True, transductive_rate: Optional[float] = None,
                        device="cuda"):
        """Sequencer factory: multi-graph by default, single-graph when one
        GraphObject is passed, transductive when a rate is given; its
        batches are built on ``device``."""
        from gnnkeras_tpu_torch.data.sequencers import (
            CompositeMultiGraphSequencer,
            CompositeSingleGraphSequencer,
            MultiGraphSequencer,
            SingleGraphSequencer,
        )
        from gnnkeras_tpu_torch.data.transductive import (
            TransductiveMultiGraphSequencer,
            TransductiveSingleGraphSequencer,
        )
        from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject

        single = isinstance(graphs, GraphObject)
        if transductive_rate is not None:
            # transduction starts from HOMOGENEOUS graphs and rebuilds them as
            # fresh 2-type composites (data/transductive.py get_transduction);
            # composite inputs would silently lose their type structure here
            # and only fail much later at fit time with a type-count mismatch
            probe = graphs if single else graphs[0]
            if isinstance(probe, CompositeGraphObject):
                raise ValueError(
                    "transductive sequencers take homogeneous GraphObjects "
                    "(the transduction builds its own 2-type composite); got "
                    "CompositeGraphObject input"
                )
            if single:
                # the re-transduced graph keeps the SAME arcs every epoch, so
                # the auto-quantized operator structure is epoch-stable and
                # agg_dtype threads through like the inductive route
                # (reference TransductiveGraphSequencers.py:100-153)
                return TransductiveSingleGraphSequencer(
                    graphs, self.focus, transductive_rate, self.batch_size, shuffle,
                    agg_dtype=self.agg_dtype, device=device,
                )
            # the per-epoch resampled 2-type merges run the strip engine too
            # (the uniformity latches persist across resamples); same auto
            # rule as the inductive multi-graph sequencer
            slot = self.slot_pack
            if slot is None:
                slot = 128
            return TransductiveMultiGraphSequencer(
                graphs, self.focus, self.aggregation_mode, transductive_rate,
                self.batch_size, shuffle,
                slot_pack=slot or None, strip_dtype=self.strip_dtype, device=device,
            )
        if single:
            cls = (
                CompositeSingleGraphSequencer
                if isinstance(graphs, CompositeGraphObject)
                else SingleGraphSequencer
            )
            # agg_dtype='auto' (the default): exact-only banded int8 storage
            # for the shared single-graph operator
            return cls(
                graphs, self.focus, self.batch_size, shuffle,
                agg_dtype=self.agg_dtype, device=device,
            )
        cls = (
            CompositeMultiGraphSequencer
            if isinstance(graphs[0], CompositeGraphObject)
            else MultiGraphSequencer
        )
        # flagship engine routing: slot-packed strip batches drive the
        # feature-major unfold engine, auto = on for every focus
        slot = self.slot_pack
        if slot is None:
            slot = 128
        return cls(
            graphs, self.focus, self.aggregation_mode, self.batch_size, shuffle,
            slot_pack=slot or None, strip_dtype=self.strip_dtype, device=device,
        )
