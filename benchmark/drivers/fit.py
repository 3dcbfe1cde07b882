"""Training cells: ``model.fit`` through the program's user surface.

Set-up builds the data from the seed, the sequencers (the span
``host_build_s``), the model with the benchmark's weights, and runs the
first ``first_epochs`` epochs through the same ``fit`` and sequencers the
window uses (they compile, build kernels and capture); a callback keeps the
logged loss of every epoch, the state after it (the parameters and Adam's
moments and step count) and the order in which the sequencer served the
batches.  The window is one more ``fit`` whose callback ends each call (an
epoch) and stops training once the window's time has passed.

The reference then takes the same steps from the same inputs, in the
workload's ``reference`` precision.  Where each epoch is one step (the
full-batch cells) it runs every step from the seeded weights.  Where an
epoch is several steps replayed at once (a captured epoch), nothing is
observable before the epoch's last step, and after a first Adam step (± the
learning rate wherever a gradient is at rounding distance from 0) the two
sides can part by as much as a lower precision makes them; so the
reference runs the first epoch from the seeded weights and checks its loss
alone (``first_loss``), then follows the program: from the program's state
after the first epoch it runs the later epochs, in the order the program
took the batches, and is compared on them.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import compare, weights
from benchmark.data.banded import banded_graph
from benchmark.data.molecules import molecules, split, subset
from benchmark.drivers import program as P
from benchmark.reference import gnn as R

WINDOW_EPOCHS = 10**9  # the window's fit runs until its callback stops it


class Cell:
    kind = "train"

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), torch.device(device)
        self.weights = weights.draw(cfg, seed, self.device)
        data = cfg["data"]
        if data["kind"] == "banded":
            self.graph = banded_graph(seed, cfg["n_nodes"], wl["graph"]["band"], cfg["dim_node_label"],
                                      cfg["dim_arc_label"], cfg["dim_target"], self.device)
            self.train_parts = [self.graph]
            self.steps_per_epoch = 1
        else:
            mols = molecules(seed, data["graphs"], data["atoms"], data["bonds"])
            train = subset(mols, split(seed, data["graphs"], data["test"], data["validation"])[0])
            bs, n = cfg["batch_size"], len(train["targets"])
            self.train = train
            self.train_parts = [subset(train, np.arange(i, min(i + bs, n))) for i in range(0, n, bs)]
            self.steps_per_epoch = len(self.train_parts)
        self.first_epochs = int(wl["first_epochs"])

    # -- the program ------------------------------------------------------------
    def setup(self, spans: dict, clock: Callable[[], float]) -> None:
        cfg, wl = self.cfg, self.wl
        np.random.seed(self.seed % 2**32)  # the sequencers shuffle from NumPy's global stream
        t0 = clock()
        if cfg["data"]["kind"] == "banded":
            from gnnkeras_tpu_torch.data.sequencers import SingleGraphSequencer

            g = P.banded_graph_object(self.graph, cfg)
            self.seq = SingleGraphSequencer(g, cfg["focus"], batch_size=g.nodes.shape[0], shuffle=wl["shuffle"],
                                            agg_dtype=wl["agg_dtype"], device=self.device)
        else:
            from gnnkeras_tpu_torch.data.sequencers import MultiGraphSequencer

            self.seq = MultiGraphSequencer(P.molecule_graph_objects(self.train, cfg), cfg["focus"],
                                           cfg["aggregation_mode"], cfg["batch_size"], wl["shuffle"],
                                           shuffle_mode=wl.get("shuffle_mode", "graphs"), slot_pack=cfg["slot_pack"],
                                           strip_dtype=cfg["strip_dtype"], device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        spans["host_build_s"] = clock() - t0

        self.model = P.build_model(cfg, self.weights, self.device)
        snap = _snapshot(self.model, self.seq, cfg)
        self._fit(snap, self.first_epochs)
        self.readings = snap.readings
        self.readings["orders"] = self.readings["orders"][:self.first_epochs]

    def _fit(self, callback, epochs: int) -> None:
        self.model.fit(self.seq, epochs=epochs, callbacks=[callback], verbose=0)

    def run_window(self, on_call: Callable[[], bool]) -> None:
        Base = P.callback_base()

        class Window(Base):
            def on_epoch_end(self, epoch, logs=None):
                self._stop = on_call()

        self._fit(Window(), WINDOW_EPOCHS)

    def program_readings(self) -> dict:
        return self.readings

    def free(self) -> None:
        self.model = self.seq = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------------
    def _reference(self, orders, mode: Optional[str] = None, start: Optional[dict] = None,
                   dtype: torch.dtype = torch.float32) -> dict:
        """The reference's epochs over the batches in ``orders`` (one list
        of batch indices an epoch), from the seeded weights or from
        ``start`` (a state as ``_snapshot`` keeps it), in ``dtype`` or as
        ``mode`` says (``tf32``; the faults ``half_batch``, ``altered``,
        ``unchanged``).  Readings as the program's, and the first step's
        gradients."""
        R.set_strict_float32()
        graphs = self._graphs(self.train_parts, dtype)
        batches = [graphs[i] for order in orders for i in order]
        spe = self.steps_per_epoch
        cast = lambda leaves: {k: v.to(dtype) for k, v in leaves.items()}
        params = cast(self.weights if start is None else {**self.weights, **start["params"]})
        adam = None if start is None else {"t": start["t"], "mu": cast(start["mu"]), "nu": cast(start["nu"])}
        fault = None if mode in (None, "tf32") else mode
        out = R.train(params, batches, self.cfg, self.cfg["learning_rate"],
                      R.Matmul("tf32" if mode == "tf32" else "float32"),
                      tuple(spe * (e + 1) for e in range(len(orders))), fault, adam)
        return {"losses": compare.epoch_losses(out["losses"], out["rows"], spe),
                "states": [out["states"][spe * (e + 1)] for e in range(len(orders))],
                "orders": [list(o) for o in orders], "first_grads": out["first_grads"]}

    def as_program(self, mode: Optional[str]) -> dict:
        """The reference in the program's place (calibration): the first
        epochs in ``mode``, the batches in order and then in an order drawn
        from the seed."""
        n = len(self.train_parts)
        rng = np.random.default_rng(self.seed)
        orders = [list(range(n))] + [list(rng.permutation(n)) if self.wl["shuffle"] else list(range(n))
                                     for _ in range(self.first_epochs - 1)]
        return self._reference(orders, mode)

    def judge(self, program: dict) -> dict:
        """The numbers that decide ``correct`` for the program's readings,
        against the reference in the workload's ``reference`` precision."""
        dtype = getattr(torch, self.wl.get("reference", "float32"))
        leaf = self.wl.get("leaf", "worst")
        keys = R.trainable(self.weights)
        zero = {"params": {k: self.weights[k] for k in keys},
                "mu": {k: torch.zeros_like(self.weights[k]) for k in keys}}
        if self.steps_per_epoch == 1:
            reference = self._reference(program["orders"], dtype=dtype)
            return compare.training_numbers(program, reference, zero, self.steps_per_epoch, leaf)
        first = self._reference(program["orders"][:1], dtype=dtype)
        reference = self._reference(program["orders"][1:], start=program["states"][0], dtype=dtype)
        later = {k: v[1:] for k, v in program.items() if k in ("losses", "states", "orders")}
        numbers = compare.training_numbers(later, reference, program["states"][0], self.steps_per_epoch, leaf)
        return {"first_loss": compare.relative_gap(program["losses"][0], first["losses"][0]), **numbers}

    def _graphs(self, parts, dtype=torch.float32):
        return [R.make_graph(p["nodes"], p["src"], p["dst"], p["arc_label"], p["targets"], p.get("node_start"),
                             self.device, dtype) for p in parts]

    # -- the work of a call -----------------------------------------------------
    def call_work(self, index: int) -> dict:
        """What one epoch computes: its train steps' (nodes, arcs), the
        edges the throughput counts (every train step's arcs × max_iter)
        and the graphs it trains on (molecules; a single graph is one)."""
        train = [(int(p["nodes"].shape[0]), int(p["src"].shape[0])) for p in self.train_parts]
        graphs = sum(len(p["node_start"]) - 1 if "node_start" in p else 1 for p in self.train_parts)
        return {"train_steps": train, "edges": sum(a for _, a in train) * self.cfg["max_iter"], "graphs": graphs}


def _snapshot(model, seq, cfg: dict):
    """A callback that keeps, for every epoch, the logged loss, the state
    after it (the parameters and Adam's ``mu``, ``nu`` and step count) and
    the order in which the sequencer served the batches (indices into its
    first order)."""
    Base = P.callback_base()
    leaves = P.trainable_leaves(model, cfg)
    served = lambda: [id(seq[i]) for i in range(len(seq))]
    first = served()

    class Snapshot(Base):
        def __init__(self):
            self.readings = {"losses": [], "states": [], "orders": [list(range(len(first)))]}

        def on_epoch_end(self, epoch, logs=None):
            state = model._opt.state
            self.readings["losses"].append(float(logs["loss"]))
            self.readings["states"].append({
                "params": {k: p.detach().clone() for k, p in leaves.items()},
                "mu": {k: state[p]["mu"].detach().clone() for k, p in leaves.items()},
                "nu": {k: state[p]["nu"].detach().clone() for k, p in leaves.items()},
                "t": int(next(iter(state.values()))["step"].item())})
            # the sequencer's epoch end has run: this is the next epoch's order
            self.readings["orders"].append([first.index(i) for i in served()])

    return Snapshot()
