"""One large banded graph, drawn from a seed: the workload of
``scripts/bench_large_graph.py`` (``data/synthetic.large_banded_graph`` of
both packages), with the node count, the band and the seed as parameters,
drawn on the device in a few large calls (the same seed gives the same
graph on the same kind of device) and returned as NumPy arrays.

Every node draws 8 arcs to nodes at most ``band`` away (wrapping around;
an arc to itself may be drawn), duplicates removed and the arcs sorted by
(src, dst); 8 normal node-label features, 2 normal arc-label features and
2 normal targets a node.  At band 64 a node keeps 7.786 arcs on average
(129 · (1 − (128/129)⁸)), at band 384 7.964.
"""

from __future__ import annotations

import torch

PER_NODE = 8


def banded_graph(seed: int, nodes: int, band: int, node_label: int = 8, arc_label: int = 2,
                 targets: int = 2, device="cpu") -> dict:
    g = torch.Generator(device=device).manual_seed(int(seed))
    src = torch.arange(nodes, dtype=torch.int64, device=device).repeat_interleave(PER_NODE)
    offset = torch.randint(-band, band + 1, (len(src),), generator=g, device=device)
    key = torch.unique(src * nodes + (src + offset) % nodes)  # sorted
    normal = lambda *shape: torch.randn(shape, generator=g, device=device, dtype=torch.float32).cpu().numpy()
    key = key.cpu().numpy()
    return {
        "nodes": normal(nodes, node_label),
        "src": key // nodes,
        "dst": key % nodes,
        "arc_label": normal(len(key), arc_label),
        "targets": normal(nodes, targets),
    }
