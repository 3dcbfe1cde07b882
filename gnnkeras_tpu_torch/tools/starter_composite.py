"""Composite starter: graph classification with a composite GNN and a layered
CLGNN over heterogeneous graphs, the port of the repository's
``examples/starter_composite.py``.

    python -m gnnkeras_tpu_torch.tools.starter_composite [--epochs N] [--fit gnn|lgnn|none] [--device cuda]

``main`` loads Mutagenicity as single-type composite graphs from a
``MUTAG_raw`` dump in the working directory (``FileNotFoundError`` without
one); ``run(graphs, device=...)`` (``build`` then ``starter.train``) is the
body for any list of composite graph-focused graphs
(``data/synthetic.composite_of`` molecules).
"""

from __future__ import annotations

import argparse
from typing import Optional

# SCRIPT OPTIONS: the reference composite starter's surface
aggregation_mode = "average"
focus = "g"

activations_net_state = "selu"
kernel_init_net_state = "lecun_normal"
bias_init_net_state = "lecun_normal"
activations_net_output = "softmax"
kernel_init_net_output = "glorot_normal"
bias_init_net_output = "glorot_normal"

dim_state = 10
max_iter = 5
state_threshold = 0.01

layers = 5
get_state = True
get_output = True
training_mode = "parallel"

epochs = 5
batch_size = 500
loss_function = "categorical_crossentropy"
optimizer = "adam:0.01"


def build(graphs, device="cuda", mode: str = training_mode, seed: Optional[int] = None) -> dict:
    """Split ``graphs`` as the starter does and build its composite GNN and
    CLGNN on ``device`` (weights from ``seed``, 0 when None).  Returns the
    models, the (train, test, validation) graph lists and the starter's
    sequencer for a list of graphs."""
    from gnnkeras_tpu_torch import (MLP, CompositeGNNgraphBased, CompositeLGNN, CompositeMultiGraphSequencer,
                                    get_inout_dims)
    from gnnkeras_tpu_torch.data.mutag import dataset_splits

    for g in graphs:
        g.setAggregation(aggregation_mode)
    gTr, gTe, gVa = dataset_splits(graphs, seed=seed)
    gGen = gTr[0]

    def nets_state(i):
        """Layer ``i``'s state MLPs, one per node type."""
        inp_s, layers_s = get_inout_dims("state", gGen.DIM_NODE_LABEL, gGen.DIM_ARC_LABEL, gGen.DIM_TARGET,
                                         focus, dim_state, layer=i, get_state=get_state, get_output=get_output)
        return [MLP(input_dim=shape, layers=layers_s, activations=activations_net_state,
                    kernel_initializer=kernel_init_net_state, bias_initializer=bias_init_net_state,
                    name=f"state_{i}_{t}") for t, shape in enumerate(inp_s)]

    def net_out(i):
        """The composite readout reads the converged state only: input
        width dim_state."""
        return MLP(input_dim=(dim_state,), layers=[gGen.DIM_TARGET], activations=activations_net_output,
                   kernel_initializer=kernel_init_net_output, bias_initializer=bias_init_net_output, name=f"out_{i}")

    build_seed = 0 if seed is None else int(seed)
    gnn = CompositeGNNgraphBased(nets_state(0), net_out(0), dim_state, max_iter, state_threshold)
    gnn.build(seed=build_seed, device=device)
    gnn.compile(optimizer=optimizer, loss=loss_function, average_st_grads=False, metrics=["accuracy", "mse"])
    lgnn = CompositeLGNN([CompositeGNNgraphBased(nets_state(i), net_out(i), dim_state, max_iter, state_threshold)
                          for i in range(layers)], get_state, get_output)
    lgnn.build(seed=build_seed, device=device)
    lgnn.compile(optimizer=optimizer, loss=loss_function, average_st_grads=True, metrics=["accuracy", "mse"],
                 training_mode=mode)

    def sequencer(gs, shuffle=True):
        return CompositeMultiGraphSequencer(gs, focus, aggregation_mode, batch_size, shuffle=shuffle, device=device)

    return {"gnn": gnn, "lgnn": lgnn, "splits": (gTr, gTe, gVa), "sequencer": sequencer}


def run(graphs, device="cuda", epochs: int = epochs, fit: str = "gnn", mode: str = training_mode,
        seed: Optional[int] = None, verbose: int = 1) -> dict:
    """The starter's body: ``build`` then ``starter.train`` (fit the model
    ``fit`` names, evaluate it on the test split)."""
    from gnnkeras_tpu_torch.tools.starter import train

    return train(build(graphs, device=device, mode=mode, seed=seed), fit=fit, epochs=epochs, verbose=verbose)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=epochs)
    parser.add_argument("--fit", choices=["gnn", "lgnn", "none"], default="gnn")
    parser.add_argument("--mode", choices=["serial", "parallel", "residual"], default=training_mode)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    from gnnkeras_tpu_torch.data.mutag import load_mutag

    run(load_mutag(composite=True, verbose=True), device=args.device, epochs=args.epochs, fit=args.fit,
        mode=args.mode, seed=args.seed)


if __name__ == "__main__":
    main()
