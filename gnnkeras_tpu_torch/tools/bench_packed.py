"""The packed-partitioned flagship forward against the plain engine.

    python -m gnnkeras_tpu_torch.tools.bench_packed [--parts P] [--repeats R] [--graphs G] [--device cuda|cpu]
    torchrun --nproc-per-node P -m gnnkeras_tpu_torch.tools.bench_packed ...

The port of the JAX package's ``scripts/bench_packed.py``.  It times the
flagship graph-focused GNN (``data/synthetic.flagship_gnn``, 5 iterations)
on one merged molecule batch two ways: the packed-partitioned engine
(``parallel/packed.py``: the batch split into P groups of whole molecules,
one a rank, BatchNorm moments and the convergence flag over the group) and
the plain single-device engine on the whole batch, on rank 0 while the
other ranks wait.  Both run the training-mode forward without gradients,
as the JAX script times them (BatchNorm's batch moments, every iteration
run).  The batch is the bench batch (``data/synthetic.bench_graph``, the
synthetic stand-in for merged Mutagenicity; ``--graphs G`` merges G
``random_molecules`` instead, for a small run), packed at slot 128 with
int8 strips (bf16 where its parallel arcs forbid int8, in both engines).

Each forward is timed between CUDA events on the card (the host clock on
the CPU), after a warm-up, and the median of ``--repeats`` is kept; the
packed time is the slowest rank's.  The tool prints, from rank 0, one line
with each engine's ms and edges/s (5 iterations times the batch's real
arcs, per second) and the ratio packed / plain.  The tool starts the
ranks itself (``parallel/launch.spawn``, gloo; all ranks share the card,
rank r on card r mod the count), or joins the group ``torchrun`` made.
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np
import torch

ITERS = 5


def build_graph(n_graphs=None):
    """The bench batch, or ``n_graphs`` merged ``random_molecules``."""
    from gnnkeras_tpu_torch.data.synthetic import bench_graph, random_molecules
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    if n_graphs is None:
        return bench_graph()
    return GraphObject.merge(random_molecules(n_graphs, seed=0), focus="g", aggregation_mode="average")


def _median_ms(fn, device, repeats: int, barrier: bool = True) -> float:
    """Median ms of ``fn`` over ``repeats`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU; with ``barrier`` the
    ranks meet before each call."""
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(repeats):
        if barrier:
            dist.barrier()
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def run_rank(rank: int, world: int, part, whole, n_arcs: int, repeats: int, device="cuda") -> dict:
    """One rank: the packed forward on its ``part`` (a CPU batch of
    ``partition_packed``), then on rank 0 the plain forward on ``whole``
    (the merged batch; None on the other ranks).  Returns the times and,
    on rank 0, the printed line."""
    import torch.distributed as dist

    from gnnkeras_tpu_torch.data.synthetic import flagship_gnn
    from gnnkeras_tpu_torch.parallel.collectives import pmax
    from gnnkeras_tpu_torch.parallel.mesh import rank_device
    from gnnkeras_tpu_torch.parallel.packed import PackedPartitionedGNN

    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model = flagship_gnn(device, seed=0)
    engine = PackedPartitionedGNN(model)
    part = part.to(device)
    packed_ms = _median_ms(lambda: engine.forward(part, training=True), device, repeats)
    packed_ms = float(pmax(torch.tensor([packed_ms], dtype=torch.float64), None)[0])  # the slowest rank's
    out = {"packed_ms": packed_ms, "ranks": world}
    if rank == 0:
        whole = whole.to(device)
        gen = model.device_generator(0)

        def plain():
            with torch.no_grad():
                model.forward(whole, training=True, generator=gen)

        out["plain_ms"] = _median_ms(plain, device, repeats, barrier=False)
        edges = ITERS * n_arcs
        out["plain_edges_per_s"] = edges / (out["plain_ms"] / 1e3)
        out["packed_edges_per_s"] = edges / (packed_ms / 1e3)
        out["ratio"] = packed_ms / out["plain_ms"]
        out["line"] = (f"ranks={world} plain {out['plain_ms']:.3f} ms ({out['plain_edges_per_s'] / 1e9:.4f}B edges/s)"
                       f"   packed-partitioned {packed_ms:.3f} ms ({out['packed_edges_per_s'] / 1e9:.4f}B edges/s)"
                       f"   ratio {out['ratio']:.2f}x")
        print(out["line"], flush=True)
    dist.barrier()
    return out


def build_inputs(g, parts: int):
    """(the parts' CPU batches, the whole batch on the CPU, the real arc
    count)."""
    from gnnkeras_tpu_torch.graph.batch import from_graph_object
    from gnnkeras_tpu_torch.parallel.packed import partition_packed

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strips, in both engines
        batches, _ = partition_packed(g, parts, slot_pack=128, strip_dtype="int8", device="cpu")
        whole = from_graph_object(g, slot_pack=128, strip_dtype="int8", device="cpu")
    return batches, whole, int(g.arcs.shape[0])


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", type=int, default=4, help="ranks to start (ignored under torchrun)")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--graphs", type=int, default=None, help="merge this many random molecules instead of the bench "
                                                             "batch")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if "RANK" in os.environ:  # under torchrun: join its group, build the inputs here
        import torch.distributed as dist

        from gnnkeras_tpu_torch.parallel.mesh import init_process_group

        rank, world = init_process_group()
        batches, whole, n_arcs = build_inputs(build_graph(args.graphs), world)
        run_rank(rank, world, batches[rank], whole if rank == 0 else None, n_arcs, args.repeats, args.device)
        dist.destroy_process_group()
        return 0
    from gnnkeras_tpu_torch.parallel.launch import spawn

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_packed: no NVIDIA card; pass --device cpu")
    batches, whole, n_arcs = build_inputs(build_graph(args.graphs), args.parts)
    threads = max(1, (os.cpu_count() or 1) // args.parts)
    spawn(run_rank, args.parts, [(batches[r], whole if r == 0 else None, n_arcs, args.repeats, args.device)
                                 for r in range(args.parts)], threads=threads)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
