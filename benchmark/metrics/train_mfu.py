"""``train_mfu``: the model FLOPs of the train steps in the traced stretch
over the stretch's wall time and the H100's float32 peak, in %.

The FLOPs are the model's, counted from the configuration and each batch's
real nodes and arcs (no padding, no work a kernel repeats): at dim_state 0
an iteration's state net is a Dense of ``2·d + d_arc`` inputs to ``d``
outputs over every node (2 FLOPs a multiply-add), every iteration past the
first aggregates the state (2 FLOPs an arc and feature: iteration 0 reads
the constant sum of the labels), and the output net is a Dense of ``d`` to
``c`` over every node.  A train step is the forward at ``max_iter``
iterations plus twice that for the backward (the remat the program may do
is not counted).  BatchNorm, activations, the loss and Adam are elementwise
and not counted.
"""

from benchmark.peaks import F32_FLOPS
from benchmark.weights import net_widths


def forward_flops(cfg: dict, nodes: int, arcs: int, iterations: int) -> float:
    widths = net_widths(cfg)
    (s_in, s_out), (o_in, o_out) = widths["state"], widths["output"]
    state = s_out
    return (iterations * 2.0 * nodes * s_in * s_out + max(iterations - 1, 0) * 2.0 * arcs * state
            + 2.0 * nodes * o_in * o_out)


def train_step_flops(cfg: dict, nodes: int, arcs: int) -> float:
    return 3.0 * forward_flops(cfg, nodes, arcs, cfg["max_iter"])


def read(record):
    if record["kind"] != "train" or not record.get("trace") or record["stretch_s"] <= 0:
        return None
    flops = sum(train_step_flops(record["config"], n, a) for w in record["work"] for n, a in w["train_steps"])
    return 100.0 * flops / (record["stretch_s"] * F32_FLOPS)
