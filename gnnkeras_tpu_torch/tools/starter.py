"""Homogeneous starter: graph classification with a GNN and an LGNN, the port
of the repository's ``examples/starter.py`` (the reference starter's script
options, model wiring and split).

    python -m gnnkeras_tpu_torch.tools.starter [--epochs N] [--fit gnn|lgnn|none] [--device cuda]

``main`` loads Mutagenicity from a ``MUTAG_raw`` dump in the working
directory (``FileNotFoundError`` without one); ``run(graphs, device=...)``
(``build`` then ``train``) is the body for any list of one-hot
graph-focused graphs (``data/synthetic.random_molecules``, a
``load_tu_dataset`` dump).
"""

from __future__ import annotations

import argparse
from typing import Optional

#######################################################################################################################
# SCRIPT OPTIONS: the reference starter's surface
#######################################################################################################################

aggregation_mode = "average"
addressed_problem = "c"
focus = "g"

activations_net_state = "selu"
kernel_init_net_state = "lecun_normal"
bias_init_net_state = "lecun_normal"

activations_net_output = "softmax"
kernel_init_net_output = "glorot_normal"
bias_init_net_output = "glorot_normal"

dim_state = 0
max_iter = 5
state_threshold = 0.01

layers = 3
get_state = True
get_output = True
training_mode = "serial"

epochs = 10
batch_size = 1000
loss_function = "categorical_crossentropy"
optimizer = "adam:0.01"


def build(graphs, device="cuda", mode: str = training_mode, seed: Optional[int] = None) -> dict:
    """Split ``graphs`` as the starter does (shuffle with ``seed``, then
    750 / 750 of 4,337 for test and validation, in proportion for other
    sizes) and build its GNN and LGNN on ``device`` (weights from ``seed``,
    0 when None).  Returns the models, the (train, test, validation) graph
    lists and the starter's sequencer for a list of graphs."""
    from gnnkeras_tpu_torch import LGNN, MLP, GNNgraphBased, MultiGraphSequencer, get_inout_dims
    from gnnkeras_tpu_torch.data.mutag import dataset_splits

    for g in graphs:
        g.setAggregation(aggregation_mode)
    gTr, gTe, gVa = dataset_splits(graphs, seed=seed)
    gGen = gTr[0]

    nets_st, nets_out = [], []
    for i in range(layers):
        inp_s, layers_s = get_inout_dims("state", gGen.DIM_NODE_LABEL, gGen.DIM_ARC_LABEL, gGen.DIM_TARGET,
                                         focus, dim_state, layer=i, get_state=get_state, get_output=get_output)
        inp_o, layers_o = get_inout_dims("output", gGen.DIM_NODE_LABEL, gGen.DIM_ARC_LABEL, gGen.DIM_TARGET,
                                         focus, dim_state, layer=i, get_state=get_state, get_output=get_output)
        nets_st.append(MLP(input_dim=inp_s[0], layers=layers_s, activations=activations_net_state,
                           kernel_initializer=kernel_init_net_state, bias_initializer=bias_init_net_state,
                           name=f"state_{i}"))
        nets_out.append(MLP(input_dim=inp_o[0], layers=layers_o, activations=activations_net_output,
                            kernel_initializer=kernel_init_net_output, bias_initializer=bias_init_net_output,
                            name=f"out_{i}"))

    build_seed = 0 if seed is None else int(seed)
    gnn = GNNgraphBased(nets_st[0], nets_out[0], dim_state, max_iter, state_threshold).build(seed=build_seed,
                                                                                              device=device)
    gnn.compile(optimizer=optimizer, loss=loss_function, average_st_grads=False, metrics=["accuracy"])
    lgnn = LGNN([GNNgraphBased(s, o, dim_state, max_iter, state_threshold)
                 for s, o in zip(_fresh_copies(nets_st), _fresh_copies(nets_out))], get_state, get_output)
    lgnn.build(seed=build_seed, device=device)
    lgnn.compile(optimizer=optimizer, loss=loss_function, average_st_grads=True, metrics=["accuracy"],
                 training_mode=mode)

    def sequencer(gs, shuffle=True):
        return MultiGraphSequencer(gs, focus, aggregation_mode, batch_size, shuffle=shuffle, device=device)

    return {"gnn": gnn, "lgnn": lgnn, "splits": (gTr, gTe, gVa), "sequencer": sequencer}


def train(built: dict, fit: str = "gnn", epochs: int = epochs, verbose: int = 1) -> dict:
    """Fit the model of ``build``'s result that ``fit`` names (none for
    ``"none"``) on its train split, validating on its validation split,
    and evaluate it on its test split: ``built`` with the History and the
    test logs added."""
    model = {"gnn": built["gnn"], "lgnn": built["lgnn"]}.get(fit)
    if model is not None:
        gTr, gTe, gVa = built["splits"]
        seq = built["sequencer"]
        built["history"] = model.fit(seq(gTr), epochs=epochs, validation_data=seq(gVa, False), verbose=verbose)
        built["test"] = model.evaluate(seq(gTe, False), verbose=verbose)
        if verbose:
            print("test:", built["test"])
    return built


def run(graphs, device="cuda", epochs: int = epochs, fit: str = "gnn", mode: str = training_mode,
        seed: Optional[int] = None, verbose: int = 1) -> dict:
    """The starter's body: ``build`` then ``train``."""
    return train(build(graphs, device=device, mode=mode, seed=seed), fit=fit, epochs=epochs, verbose=verbose)


def _fresh_copies(nets):
    """Fresh MLPs of the same configuration: the GNN and the LGNN's first
    layer hold parameters of their own (the reference's Keras nets are
    rebuilt per model)."""
    return [type(n).from_config(n.get_config()) for n in nets]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=epochs)
    parser.add_argument("--fit", choices=["gnn", "lgnn", "none"], default="gnn")
    parser.add_argument("--mode", choices=["serial", "parallel", "residual"], default=training_mode)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    from gnnkeras_tpu_torch.data.mutag import load_mutag

    run(load_mutag(verbose=True), device=args.device, epochs=args.epochs, fit=args.fit, mode=args.mode,
        seed=args.seed)


if __name__ == "__main__":
    main()
