"""Command-line entry point of the port: train / evaluate / predict / export /
bench a GNN experiment from a ``GNNConfig`` JSON file and a dataset spec,
with the subcommands, flags and JSON lines of ``gnnkeras_tpu.cli``:

    python -m gnnkeras_tpu_torch.cli train --dataset mutag --save model_dir/ --epochs 10
    python -m gnnkeras_tpu_torch.cli train --config exp.json --dataset tu:/data:PROTEINS \\
        --checkpoint-dir ck/ --resume
    python -m gnnkeras_tpu_torch.cli evaluate --model model_dir/ --config exp.json --dataset mutag
    python -m gnnkeras_tpu_torch.cli predict --model model_dir/ --config exp.json --dataset mutag \\
        --out preds.npy
    python -m gnnkeras_tpu_torch.cli export --model model_dir/ --config exp.json --dataset mutag \\
        --out artifact/
    python -m gnnkeras_tpu_torch.cli bench

Every subcommand runs on the card (``--device cuda``, the default) and
raises when there is none; ``--device cpu`` runs the kernels' plain
versions on the CPU.  Dataset specs: ``mutag`` (a ``MUTAG_raw`` dump in the
working directory), ``mutag-composite``, ``tu:<path>:<prefix>[:composite]``
for any TU-format dump, or ``npz:<folder>[:composite]`` for a dataset
saved by ``GraphObject.save_dataset`` (the reference's ``g{i}.npz``
files), read in the config's focus: the spec for node- and arc-focused
targets.  Splits follow the reference starters (shuffle, then
2837/750/750 on Mutagenicity, proportional elsewhere; ``--split-seed``).  A model folder written by ``train --save`` loads in
either package's CLI; ``export`` writes the port's ``torch.export``
artifact.  ``train --parallel`` runs one of the distributed engines on
``--parallel-devices`` ranks (default: one a card), started as processes
(``parallel/launch.spawn``; several ranks share a card when there are
fewer cards), and takes the trained weights back into the single-device
model before it evaluates and saves.  ``bench`` runs ``tools/bench.py``
(``GNNK_BENCH_SCALE`` < 1 shrinks its workload, as for ``bench.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

PARALLEL_ENGINES = ("dp", "partitioned", "packed", "pipeline", "expert")


def _model_classes() -> dict:
    """model_class (as ``config.json`` records it) → the port's class."""
    from gnnkeras_tpu_torch.models.composite import (CompositeGNNarcBased, CompositeGNNgraphBased,
                                                     CompositeGNNnodeBased)
    from gnnkeras_tpu_torch.models.gnn import GNNarcBased, GNNgraphBased, GNNnodeBased
    from gnnkeras_tpu_torch.models.lgnn import LGNN, CompositeLGNN

    classes = (GNNnodeBased, GNNarcBased, GNNgraphBased, CompositeGNNnodeBased, CompositeGNNarcBased,
               CompositeGNNgraphBased, LGNN, CompositeLGNN)
    return {cls.__name__: cls for cls in classes}


def _load_dataset(spec: str, cfg, verbose: bool = True):
    from gnnkeras_tpu_torch.data.mutag import load_mutag, load_tu_dataset

    if spec in ("mutag", "mutag-composite"):
        return load_mutag(composite=spec.endswith("composite"), verbose=verbose)
    if spec.startswith("tu:"):
        parts = spec.split(":")
        if len(parts) not in (3, 4) or (len(parts) == 4 and parts[3] != "composite"):
            raise SystemExit(f"bad dataset spec {spec!r} (want tu:<path>:<prefix>[:composite])")
        return load_tu_dataset(parts[1], parts[2], composite=len(parts) == 4, verbose=verbose)
    if spec.startswith("npz:"):
        from gnnkeras_tpu_torch.graph.graph import CompositeGraphObject, GraphObject

        parts = spec.split(":")
        if len(parts) not in (2, 3) or (len(parts) == 3 and parts[2] != "composite"):
            raise SystemExit(f"bad dataset spec {spec!r} (want npz:<folder>[:composite])")
        cls = CompositeGraphObject if len(parts) == 3 else GraphObject
        graphs = cls.load_dataset(parts[1], cfg.focus, cfg.aggregation_mode)
        if verbose:
            print(f"Loaded {len(graphs)} graphs from {parts[1]}")
        return graphs
    raise SystemExit(f"unknown dataset {spec!r} (mutag | mutag-composite | tu:<path>:<prefix> | npz:<folder>)")


def _config(args):
    from gnnkeras_tpu_torch.config import GNNConfig

    if args.config:
        with open(args.config) as f:
            cfg = GNNConfig.from_json(f.read())
    else:
        cfg = GNNConfig()
    if getattr(args, "epochs", None) is not None:
        cfg.epochs = args.epochs
    if getattr(args, "slot_pack", None) is not None:
        cfg.slot_pack = args.slot_pack
    if getattr(args, "strip_dtype", None) is not None:
        cfg.strip_dtype = args.strip_dtype
    if getattr(args, "transposed", None) is not None:
        cfg.transposed = {"auto": None, "on": True, "off": False}[args.transposed]
    if getattr(args, "agg_dtype", None) is not None:
        cfg.agg_dtype = None if args.agg_dtype == "none" else args.agg_dtype
    cfg.__post_init__()  # re-validate after the overrides
    return cfg


def _splits(graphs, cfg, args):
    from gnnkeras_tpu_torch.data.mutag import dataset_splits, mutag_splits

    for g in graphs:
        g.setAggregation(cfg.aggregation_mode)
    # the reference's fixed 750/750 tail slices fit Mutagenicity only; any
    # other dataset gets proportional splits
    explicit = args.test_frac is not None or args.val_frac is not None
    if args.dataset.startswith("mutag") and not explicit:
        return mutag_splits(graphs, seed=args.split_seed)
    return dataset_splits(
        graphs, seed=args.split_seed,
        test_frac=args.test_frac if args.test_frac is not None else 750 / 4337,
        val_frac=args.val_frac if args.val_frac is not None else 750 / 4337,
    )


def _dims(graphs):
    g = graphs[0]
    dims = tuple(int(d) for d in g.DIM_NODE_LABEL)
    node_dim = dims if len(dims) > 1 or hasattr(g, "type_mask") else dims[0]
    return node_dim, int(g.DIM_ARC_LABEL), int(g.DIM_TARGET)


def _load_model(model_dir: str, device):
    """A saved model, its class from the ``model_class`` of its
    ``config.json`` (either package's folder)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        name = json.load(f).get("model_class")
    cls = _model_classes().get(name)
    if cls is None:
        raise SystemExit(f"unknown model_class {name!r} in {model_dir}/config.json")
    return cls.load(model_dir, device=device)


def _last(history) -> dict:
    return {k: v[-1] for k, v in getattr(history, "history", history).items()}


def _parallel_rank(rank: int, world: int, job: dict):
    """One rank of ``train --parallel``: the model rebuilt from the config
    and the parent's initial weights, the engine's fit on this rank's part,
    and (rank 0) the trained weights and the last epoch's logs."""
    from gnnkeras_tpu_torch.config import GNNConfig
    from gnnkeras_tpu_torch.parallel.mesh import rank_device

    dev = rank_device(job["device"])
    cfg = GNNConfig.from_json(job["config"])
    model = cfg.build_model(*job["dims"], device=dev)
    model.load_state_dict(job["state"])
    tr, va, par = job["train"], job["val"], job["engine"]
    fit_kw = dict(epochs=cfg.epochs, verbose=job["verbose"], checkpoint_dir=job["checkpoint_dir"],
                  resume=job["resume"], class_weight=job["class_weight"])
    val_seq = (lambda: cfg.build_sequencer(va, shuffle=False, device=dev)) if va else (lambda: None)

    if par == "dp":
        from gnnkeras_tpu_torch.parallel.data_parallel import DataParallelTrainer

        history = DataParallelTrainer(model).fit(cfg.build_sequencer(tr, device=dev), validation_data=val_seq(),
                                                 **fit_kw)
    elif par == "partitioned":
        from gnnkeras_tpu_torch.parallel.partition import PartitionedGNN

        history = PartitionedGNN(model).fit(job["parts"][rank].to(dev), validation_data=val_seq(), **fit_kw)
    elif par == "packed":
        from gnnkeras_tpu_torch.parallel.packed import PackedPartitionedGNN, PackedPartitionedLGNN

        engine = (PackedPartitionedLGNN if hasattr(model, "gnns") else PackedPartitionedGNN)(model)
        val = job["val_parts"][rank].to(dev) if job["val_parts"] is not None else None
        history = engine.fit(job["parts"][rank].to(dev), validation_data=val, **fit_kw)
    elif par == "pipeline":
        from gnnkeras_tpu_torch.graph.batch import graphs_to_batch
        from gnnkeras_tpu_torch.parallel.pipeline import PipelineLGNN

        # two microbatches of one padded shape (GPipe needs two in flight)
        n_pad = max(sum(g.nodes.shape[0] for g in tr[i::2]) for i in range(2))
        a_pad = max(sum(g.arcs.shape[0] for g in tr[i::2]) for i in range(2))
        mbs = [graphs_to_batch(tr[i::2], cfg.focus, cfg.aggregation_mode, pad_nodes=-(-n_pad // 8) * 8,
                               pad_arcs=-(-a_pad // 8) * 8, device=dev) for i in range(2)]
        history = PipelineLGNN(model).fit([mbs], validation_data=val_seq(), **fit_kw)
    elif par == "expert":
        from gnnkeras_tpu_torch.parallel.expert import ExpertParallelCompositeGNN

        history = ExpertParallelCompositeGNN(model).fit(cfg.build_sequencer(tr, device=dev),
                                                        validation_data=val_seq(), **fit_kw)
    else:
        raise ValueError(f"unknown engine {par!r}")
    if rank != 0:
        return None
    return _last(history), {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _train_parallel(cfg, model, tr, va, args, class_weight, dims):
    """Run ``cfg.parallel`` on its ranks and load rank 0's trained weights
    into ``model``; returns the last epoch's logs."""
    from gnnkeras_tpu_torch.parallel.launch import spawn
    from gnnkeras_tpu_torch.parallel.mesh import device_count

    n_dev = cfg.parallel_devices or (device_count() if model.device.type == "cuda" else 0)
    if n_dev < 1:
        raise SystemExit("--parallel on the CPU needs --parallel-devices (the number of ranks)")
    job = dict(engine=cfg.parallel, config=cfg.to_json(), dims=dims, device=str(model.device.type),
               state={k: v.detach().cpu() for k, v in model.state_dict().items()}, train=list(tr),
               val=list(va), verbose=args.verbose, checkpoint_dir=args.checkpoint_dir, resume=args.resume,
               class_weight=class_weight, parts=None, val_parts=None)
    if cfg.parallel == "partitioned":
        from gnnkeras_tpu_torch.parallel.partition import partition_graph

        merged = type(tr[0]).merge(list(tr), focus=cfg.focus, aggregation_mode=cfg.aggregation_mode)
        pg = partition_graph(merged, n_dev, dense_blocks=True, agg_dtype=cfg.agg_dtype)
        job["parts"] = [pg.shard(r, "cpu") for r in range(n_dev)]
    elif cfg.parallel == "packed":
        from gnnkeras_tpu_torch.parallel.packed import partition_packed

        merged = type(tr[0]).merge(list(tr), focus="g", aggregation_mode=cfg.aggregation_mode)
        job["parts"], _ = partition_packed(merged, n_dev, strip_dtype=cfg.strip_dtype, device="cpu")
        # a validation split too small to fill the ranks is skipped
        if len(va) >= n_dev:
            merged_va = type(va[0]).merge(list(va), focus="g", aggregation_mode=cfg.aggregation_mode)
            job["val_parts"], _ = partition_packed(merged_va, n_dev, strip_dtype=cfg.strip_dtype, device="cpu")
    if cfg.parallel in ("partitioned", "packed"):  # the ranks take their parts, not the graphs
        job["train"] = []
    if cfg.parallel == "packed":  # validation: the packed parts
        job["val"] = []
    logs, state = spawn(_parallel_rank, n_dev, [(job,)] * n_dev)[0]
    model.load_state_dict(state)
    return logs


def cmd_train(args) -> int:
    cfg = _config(args)
    if args.parallel is not None:
        cfg.parallel = args.parallel
    if args.parallel_devices is not None:
        cfg.parallel_devices = args.parallel_devices
    cfg.__post_init__()  # re-validate the overrides
    class_weight = None
    if args.class_weight:
        class_weight = {int(k): float(v) for k, v in json.loads(args.class_weight).items()}
    graphs = _load_dataset(args.dataset, cfg, verbose=args.verbose > 0)
    tr, te, va = _splits(graphs, cfg, args)
    dims = _dims(graphs)
    model = cfg.build_model(*dims, device=args.device)
    if cfg.parallel != "none":
        final_train = _train_parallel(cfg, model, tr, va, args, class_weight, dims)
    else:
        history = model.fit(
            cfg.build_sequencer(tr, device=args.device),
            epochs=cfg.epochs,
            validation_data=cfg.build_sequencer(va, shuffle=False, device=args.device) if va else None,
            verbose=args.verbose,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            class_weight=class_weight,
        )
        final_train = _last(history)
    logs = model.evaluate(cfg.build_sequencer(te, shuffle=False, device=args.device), verbose=args.verbose)
    print(json.dumps({"test": logs, "final_train": final_train}))
    if args.save:
        model.save(args.save)
        print(f"saved model to {args.save}", file=sys.stderr)
    return 0


def _restore(args):
    cfg = _config(args)
    graphs = _load_dataset(args.dataset, cfg, verbose=args.verbose > 0)
    tr, te, va = _splits(graphs, cfg, args)
    model = _load_model(args.model, args.device)
    # loaded models bypass build_model: apply the engine override here
    if cfg.transposed is not None:
        for g in (model.gnns if hasattr(model, "gnns") else [model]):
            g.transposed = cfg.transposed
    model.compile(optimizer=cfg.optimizer, loss=cfg.loss, metrics=list(cfg.metrics))
    return cfg, model, (tr, te, va)


def cmd_evaluate(args) -> int:
    cfg, model, (_, te, _) = _restore(args)
    seq = cfg.build_sequencer(te, shuffle=False, device=args.device)
    print(json.dumps(model.evaluate(seq, verbose=args.verbose)))
    return 0


def cmd_predict(args) -> int:
    cfg, model, (_, te, _) = _restore(args)
    preds = model.predict(cfg.build_sequencer(te, shuffle=False, device=args.device))
    if args.out:
        np.save(args.out, preds)
        print(f"wrote {preds.shape} predictions to {args.out}", file=sys.stderr)
    else:
        np.savetxt(sys.stdout, preds, fmt="%.6g")
    return 0


def cmd_export(args) -> int:
    from gnnkeras_tpu_torch.serving import export_forward

    cfg, model, (tr, _, _) = _restore(args)
    seq = cfg.build_sequencer(tr[: cfg.batch_size], shuffle=False, device=args.device)
    export_forward(model, seq[0], args.out)
    print(f"exported torch.export artifact to {args.out}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from gnnkeras_tpu_torch.tools import bench

    bench.main(device=args.device)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from gnnkeras_tpu_torch.utils.dtypes import resolve_device

    parser = argparse.ArgumentParser(prog="python -m gnnkeras_tpu_torch.cli", description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda", help="cuda (default: the card) | cpu")

    def common(p, model=False, needs_out=False):
        p.add_argument("--config", help="GNNConfig JSON file (defaults: starter surface)")
        p.add_argument("--dataset", default="mutag", help="mutag | mutag-composite | tu:<path>:<prefix>[:composite] | npz:<folder>[:composite]")
        p.add_argument("--split-seed", type=int, default=42, help="reference starter split shuffle seed")
        p.add_argument("--test-frac", type=float, default=None,
                       help="test split fraction (default: reference proportions; mutag uses the exact "
                            "750-graph slices)")
        p.add_argument("--val-frac", type=float, default=None, help="validation split fraction (see --test-frac)")
        p.add_argument("--verbose", type=int, default=1)
        p.add_argument("--slot-pack", type=int, default=None, choices=[0, 128],
                       help="sequencer slot packing (0 = off, 128 = strip engine; default: auto, 128)")
        p.add_argument("--strip-dtype", default=None, choices=["int8", "bfloat16", "float32"],
                       help="strip operator storage (default: config, int8)")
        p.add_argument("--transposed", default=None, choices=["auto", "on", "off"],
                       help="feature-major unfold engine (default: auto)")
        p.add_argument("--agg-dtype", default=None, choices=["auto", "int8", "bfloat16", "float32", "none"],
                       help="single-graph aggregation-operator storage (default: auto, banded int8 only when "
                            "the factorization is exact; 'none' = plain float)")
        device_flag(p)
        if model:
            p.add_argument("--model", required=True, help="saved model directory")
        if needs_out:
            p.add_argument("--out", required=needs_out == "required", help="output path")

    p = sub.add_parser("train", help="train from a config, print test metrics as JSON")
    common(p)
    p.add_argument("--epochs", type=int, default=None, help="override config epochs")
    p.add_argument("--save", help="save the trained model to this directory")
    p.add_argument("--checkpoint-dir", help="resumable checkpoints")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint-dir")
    p.add_argument("--parallel", default=None, choices=["none", *PARALLEL_ENGINES],
                   help="distributed engine (overrides config.parallel)")
    p.add_argument("--parallel-devices", type=int, default=None,
                   help="ranks for --parallel (default: one a visible card)")
    p.add_argument("--class-weight", default=None,
                   help='JSON {class index: weight}, e.g. \'{"0": 2.0}\' (Keras fit semantics)')
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate a saved model on the test split")
    common(p, model=True)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict", help="predictions for the test split (npy or stdout)")
    common(p, model=True, needs_out=True)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("export", help="export a torch.export serving artifact")
    common(p, model=True, needs_out="required")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="the flagship forward's edges/s (one JSON line)")
    device_flag(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
