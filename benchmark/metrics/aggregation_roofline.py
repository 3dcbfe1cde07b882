"""The aggregation kernels' share of their roofline, in %: the least time
the aggregations of the traced stretch need on an H100, over the device
time of the kernels that do them.

The least time of one aggregation ``Σ_{arcs into v} w · x[src]`` of a
``d``-wide state is counted from the graph, never from the program's
storage, so that any storage format meets the same yardstick: the larger
of the bytes (12 an arc: two int32 indices and an f32 weight; the state
read and the result written, 4 a node and feature each) over 3.35 TB/s and
the FLOPs (2 an arc and feature) over 67 TFLOP/s.

How many a call needs: at dim_state 0 a forward of k iterations aggregates
the state k − 1 times (iteration 0 reads the constant sum of the labels),
and a train step's backward aggregates as many times again (the transposed
operator, for the gradient of the state); a train step runs ``max_iter``
iterations.  The kernels: the strip kernel (slot
128 strips and the banded diagonals, both directions) and kernel row 8
(``QuantBcsr``, both directions), by the names they have in the trace.
"""

from benchmark.peaks import F32_FLOPS, HBM_BYTES_PER_S

KERNELS = ("strip_kernel", "qbcsr_list_kernel", "qbcsr_list_t_kernel")
ARC_BYTES = 12  # two int32 indices and an f32 weight
STATE_BYTES = 4  # f32


def least_seconds(nodes: int, arcs: int, d: int) -> float:
    bytes_ = arcs * ARC_BYTES + 2 * nodes * d * STATE_BYTES
    return max(bytes_ / HBM_BYTES_PER_S, 2.0 * arcs * d / F32_FLOPS)


def aggregations(work: dict, cfg: dict):
    """(nodes, arcs, times) of every aggregation one call needs."""
    return [(n, a, 2 * (cfg["max_iter"] - 1)) for n, a in work["train_steps"]]


def kernel_seconds(device_ops: dict) -> float:
    return sum(s for name, s in device_ops.items() if any(k in name for k in KERNELS))


def roofline_share(record, kind: str):
    trace = record.get("trace")
    if record["kind"] != kind or not trace:
        return None
    spent = kernel_seconds(trace["device_ops"])
    if spent <= 0:
        return None
    d = record["config"]["dim_node_label"]
    least = sum(times * least_seconds(n, a, d)
                for w in record["work"] for n, a, times in aggregations(w, record["config"]))
    return 100.0 * least / spent
