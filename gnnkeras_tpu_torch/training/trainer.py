"""Training runtime, counterpart of ``gnnkeras_tpu.training.trainer``.

``train_step`` is the one training-step body: the training forward (the
fixed-length unfolding with its device-side running flag), the masked,
sample-weighted loss plus the regularisation loss, the backward through the
unfolding (the strip aggregation's backward is the ``strip_matmul_t``
kernel on the card), the optional ``average_st_grads`` division of the
state net's gradients by max(k, 1), the optimizer step, the new BatchNorm
moving statistics and the step's log sums.  Nothing in it reads a device
value on the host; the logs stay on the device until ``_reduce_logs``.

An LGNN stack (``models/lgnn.py``) trains on the mean of its per-layer
losses (``parallel``) or on the loss of its layers' mean output
(``residual``); evaluation and ``predict`` read its last layer, and
``average_st_grads`` divides each layer's state nets by that layer's k.

``fit`` trains over a sequencer (``data/``: ``len``, ``[i]`` yielding
``GraphBatch``es on the model's device, ``on_epoch_end``) through
``training/fit_loop.run_fit_loop``: validation every ``validation_freq``
epochs, callbacks, checkpoints and resume, as the JAX package's ``fit``.

The scanned epoch (``fit(scan_batches=None|True)``, the JAX package's
one-launch ``lax.scan`` epoch) engages when the sequencer serves at least
two batches of one static structure (``utils/pytree.static_signature`` and
every tensor's shape, dtype and device) and does not opt out
(``scan_stack_ok = False``: the single-graph sequencers, whose batches share
one topology); otherwise the epoch runs one ``train_step`` per batch, as
JAX's ``_try_stack`` falls back.  On the card the epoch's steps are
recorded once into a ``torch.cuda.CUDAGraph`` over static per-step copies
of the batches and replayed once per epoch (``_ScannedEpoch``); each step
draws from a generator of its own, registered with the graph and seeded
before every replay from the model's stream, one seed a batch as the
per-step fit draws them.  The copies are refreshed when the sequencer
serves other batch objects (after a rebuild), and the graph is captured
again only when the structure changes (the pads grow, the dtype latches
move) or when the parameters', buffers' or optimizer state's tensors were
replaced.  On the CPU the same steps run eagerly: the plain version, bit
for bit the per-step fit.  ``evaluate(scan_batches=...)`` scans the same
way with the fixed-length inference loop (``forward(fixed_length=True)``,
no host read inside the loop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from gnnkeras_tpu_torch.training.callbacks import History
from gnnkeras_tpu_torch.training.losses import masked_mean
from gnnkeras_tpu_torch.training.metrics import get_metric
from gnnkeras_tpu_torch.utils.pytree import static_signature


def _objective(model, batch, generator: Optional[torch.Generator], training: bool, fixed_length: bool = False):
    """(loss, aux) for one batch: the masked mean of the per-row loss plus
    the regularisation loss; aux holds ``y_pred``, ``k`` (an LGNN's: one
    per layer) and ``new_state`` (the new moving statistics).  An LGNN in
    training takes its ``training_mode``'s loss; in evaluation the last
    layer's.  ``fixed_length`` runs inference in the exportable loop."""
    y, mask, sw = batch.targets, batch.target_mask, batch.sample_weight
    k, _, outs, _, new_state = model.forward(batch, training=training, generator=generator,
                                             fixed_length=fixed_length)
    out = model.served_output(outs)
    mode = model.training_mode if training else None
    if mode == "parallel":
        data_loss = sum(masked_mean(model.loss(y, o), mask, sw) for o in outs) / len(outs)
    elif mode == "residual":
        data_loss = masked_mean(model.loss(y, sum(outs) / len(outs)), mask, sw)
    else:
        data_loss = masked_mean(model.loss(y, out), mask, sw)
    loss = data_loss + model.regularization_loss()
    return loss, {"y_pred": out, "k": k, "new_state": new_state}


def _metric_sums(model, y_pred, batch) -> dict:
    sums = {}
    for spec in model.metrics:
        name, fn = get_metric(spec)
        sums[name] = fn(batch.targets, y_pred, batch.target_mask, batch.sample_weight)
    return sums


def _step_logs(model, loss, y_pred, batch) -> dict:
    count = torch.clamp_min(torch.sum(batch.target_mask.to(torch.float32)), 1.0)
    logs = {"loss_sum": loss.detach() * count, "count": count}
    with torch.no_grad():
        for name, (s, c) in _metric_sums(model, y_pred.detach(), batch).items():
            logs[f"{name}_sum"] = s
            logs[f"{name}_count"] = c
    return logs


def _load_bn_state(model, new_state: dict) -> None:
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for key, value in new_state.items():
            buffers[key].copy_(value)


def _optimizer(model) -> torch.optim.Optimizer:
    if model._opt is None:
        model._opt = model.optimizer(model.parameters())
    return model._opt


def train_step(model, batch, generator: Optional[torch.Generator] = None):
    """One training step on a compiled, built model.  Returns (logs, aux):
    the log sums (0-dim device tensors) and the objective's aux.  The
    parameters' ``.grad`` hold the step's (scaled) gradients afterwards."""
    opt = _optimizer(model)
    opt.zero_grad(set_to_none=True)
    loss, aux = _objective(model, batch, generator, training=True)
    loss.backward()
    if model.average_st_grads:
        model.scale_state_grads(aux["k"])
    opt.step()
    _load_bn_state(model, aux["new_state"])
    return _step_logs(model, loss, aux["y_pred"], batch), aux


def _eval_logs(model, batch, generator: Optional[torch.Generator], fixed_length: bool = False) -> dict:
    with torch.no_grad():
        loss, aux = _objective(model, batch, generator, training=False, fixed_length=fixed_length)
    return _step_logs(model, loss, aux["y_pred"], batch)


def eval_step(model, batch) -> dict:
    # the generator draws a dim_state > 0 model's random initial state
    return _eval_logs(model, batch, model.next_rng())


def _reduce_logs(accum: list, prefix: str = "") -> dict:
    total = {}
    for logs in accum:
        for key, value in logs.items():
            total[key] = total.get(key, 0.0) + float(value)
    out = {prefix + "loss": total.get("loss_sum", 0.0) / max(total.get("count", 1.0), 1.0)}
    for key in list(total):
        if key.endswith("_sum") and key != "loss_sum":
            name = key[:-4]
            out[prefix + name] = total[key] / max(total.get(f"{name}_count", 1.0), 1e-9)
    return out


def _class_weight_vector(class_weight: dict, device) -> torch.Tensor:
    """{class index: weight} → dense lookup vector (missing classes weigh 1)."""
    n = max(int(k) for k in class_weight) + 1
    vec = torch.ones(n, dtype=torch.float32)
    for k, v in class_weight.items():
        vec[int(k)] = float(v)
    return vec.to(device)


def _apply_class_weight(batch, cw_vec: torch.Tensor):
    """Scale each row's sample weight by the weight of its true class
    (argmax of the one-hot target row)."""
    cls = torch.clamp(torch.argmax(batch.targets, dim=-1), 0, cw_vec.shape[0] - 1)
    return batch.replace(sample_weight=batch.sample_weight * cw_vec[cls])


# -- the scanned epoch -----------------------------------------------------------

_EVAL_CAPTURES_KEPT = 2  # scanned evaluations kept per model (validation and test sequencers)


def _scan_structure(batches: list, sequencer) -> Optional[str]:
    """The one static structure of ``batches`` (static signature, every
    tensor's shape, dtype and device), or None when the epoch cannot scan:
    fewer than two batches, a sequencer that opts out (``scan_stack_ok``),
    or batches of more than one structure."""
    if len(batches) < 2 or not getattr(sequencer, "scan_stack_ok", True):
        return None
    structures = set()
    for batch in batches:
        leaves, spec = pytree.tree_flatten(batch)
        structures.add(repr((static_signature(spec), [(tuple(t.shape), str(t.dtype), str(t.device))
                                                      for t in leaves])))
    return structures.pop() if len(structures) == 1 else None


def _addresses(model) -> tuple:
    """What a captured epoch reads and writes in place: the optimizer and
    the addresses of the parameters, buffers and optimizer tensors."""
    tensors = [*model.parameters(), *model.buffers()]
    opt = model._opt
    if opt is not None:
        for group in opt.param_groups:
            tensors += [v for k, v in group.items() if k != "params" and isinstance(v, torch.Tensor)]
        for state in opt.state.values():
            tensors += [v for v in state.values() if isinstance(v, torch.Tensor)]
    return id(opt), tuple(t.data_ptr() for t in tensors)


class _ScannedEpoch:
    """One sequencer epoch's steps, train or evaluation, over one static
    structure.  ``run`` returns the per-step log sums.  On a CUDA device
    the steps are captured once into a CUDA graph over static copies of the
    batches (and of the class weights), each step with a generator
    registered with the graph, and replayed; a capture or replay error
    propagates.  On the CPU they run eagerly on the batches themselves."""

    def __init__(self, model, key: tuple, train: bool):
        self.key, self.train = key, train
        self.cuda = model.device.type == "cuda"
        self.graph = None
        self.static = self.ids = self.sources = self.cw = None
        self.addresses = None

    def current(self, model) -> bool:
        """Still valid: nothing it captured was replaced."""
        return self.graph is None or self.addresses == _addresses(model)

    def _step(self, model, batch, generator, cw_vec) -> dict:
        if not self.train:
            return _eval_logs(model, batch, generator, fixed_length=True)
        if cw_vec is not None:
            batch = _apply_class_weight(batch, cw_vec)
        return train_step(model, batch, generator)[0]

    def run(self, model, batches: list, seeds: list, cw_vec: Optional[torch.Tensor]) -> list:
        if not self.cuda:
            return [self._step(model, b, model.device_generator(s), cw_vec) for b, s in zip(batches, seeds)]
        self._load(batches, cw_vec)
        if self.graph is None:
            self._capture(model)
        for generator, seed in zip(self.generators, seeds):
            generator.manual_seed(seed)
        self.graph.replay()
        return self.logs

    def _load(self, batches: list, cw_vec: Optional[torch.Tensor]) -> None:
        """Copy the batches into the static buffers, unless they are the
        ones copied last (the sequencer has not rebuilt since); the sources
        are kept so that their ids stay theirs."""
        ids = tuple(id(b) for b in batches)
        if self.static is None:
            self.static = [pytree.tree_map(torch.clone, b) for b in batches]
            self.cw = None if cw_vec is None else cw_vec.clone()
        else:
            if ids != self.ids:
                with torch.no_grad():
                    for buffers, batch in zip(self.static, batches):
                        for x, y in zip(pytree.tree_leaves(buffers), pytree.tree_leaves(batch)):
                            x.copy_(y)
            if cw_vec is not None:
                self.cw.copy_(cw_vec)
        self.ids, self.sources = ids, list(batches)

    def _capture(self, model) -> None:
        device = model.device
        _optimizer(model)  # its state exists from construction: nothing lazy is left for the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            # warm-up outside the capture (library handles, first launches):
            # a forward and backward whose gradients are dropped, so nothing
            # lands in the weights, the statistics or the optimizer state
            warm = torch.Generator(device=device).manual_seed(0)
            if self.train:
                loss, _ = _objective(model, self.static[0], warm, training=True)
                loss.backward()
                _optimizer(model).zero_grad(set_to_none=True)
            else:
                _eval_logs(model, self.static[0], warm, fixed_length=True)
        torch.cuda.current_stream(device).wait_stream(side)
        self.generators = [torch.Generator(device=device) for _ in self.static]
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.logs = [self._step(model, b, g, self.cw) for b, g in zip(self.static, self.generators)]
        self.graph = graph
        self.addresses = _addresses(model)


def _scanned(model, train: bool, structure: str, n: int, cw_vec: Optional[torch.Tensor]) -> _ScannedEpoch:
    """The model's scanned epoch for this structure, made anew when there
    is none or what it captured was replaced."""
    key = (structure, n, None if cw_vec is None else tuple(cw_vec.shape))
    cache = model._scan.setdefault("train" if train else "eval", {})
    entry = cache.get(key)
    if entry is None or not entry.current(model):
        cache.pop(key, None)
        if train:
            cache.clear()  # one training capture a model
        elif len(cache) >= _EVAL_CAPTURES_KEPT:
            cache.pop(next(iter(cache)))
        entry = cache[key] = _ScannedEpoch(model, key, train)
    return entry


def drop_stale_captures(model) -> None:
    """Forget the scanned epochs whose captured tensors were replaced (a
    restore that swapped the optimizer's state, ...); the next epoch
    captures again."""
    for cache in model._scan.values():
        for key in [k for k, entry in cache.items() if not entry.current(model)]:
            del cache[key]


def fit(
    model,
    sequencer,
    epochs: int = 1,
    validation_data=None,
    callbacks: Optional[list] = None,
    verbose: int = 1,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    scan_batches: Optional[bool] = None,
    class_weight: Optional[dict] = None,
    validation_freq: int = 1,
) -> History:
    """Keras-like fit loop over a sequencer of ``GraphBatch``es.  Returns a
    ``History`` of the per-epoch mean logs.

    ``class_weight`` ({class index: weight}) scales each supervised row's
    training loss by the weight of its true class; validation is unaffected.
    ``validation_data`` (a sequencer) is evaluated every ``validation_freq``
    epochs (1-based: when ``(epoch + 1) % validation_freq == 0``) into
    ``val_*`` logs.  With ``checkpoint_dir`` a resumable checkpoint
    (``training/checkpoint.py``) is written every ``checkpoint_every``
    epochs; ``resume=True`` restores the latest one and continues from the
    epoch after it.  ``scan_batches`` (default: auto; True behaves the
    same) runs the epoch as one scanned launch when the sequencer's batches
    share one structure and falls back to one step a batch otherwise
    (module docstring); False always steps a batch at a time, fetching each
    batch just before its step.  A sequencer's background rebuild, which the
    last epoch's end starts, is joined before ``fit`` returns."""
    from gnnkeras_tpu_torch.training.fit_loop import run_fit_loop

    if model.optimizer is None:
        raise RuntimeError("call compile() before fit()")
    model.build(seed=seed)
    cw_vec = _class_weight_vector(class_weight, model.device) if class_weight else None

    def per_step(batch):
        if cw_vec is not None:
            batch = _apply_class_weight(batch, cw_vec)
        return train_step(model, batch, model.next_rng())[0]

    def run_epoch(epoch, n):
        if scan_batches is False:
            accum = [per_step(sequencer[i]) for i in range(len(sequencer))]
        else:
            batches = [sequencer[i] for i in range(len(sequencer))]
            structure = _scan_structure(batches, sequencer)
            if structure is None:
                accum = [per_step(batch) for batch in batches]
            else:
                seeds = [model.next_seed() for _ in batches]
                accum = _scanned(model, True, structure, len(batches), cw_vec).run(model, batches, seeds, cw_vec)
        sequencer.on_epoch_end()
        return [_reduce_logs(accum)]

    validate = None
    if validation_data is not None:
        validate = lambda: evaluate(model, validation_data, verbose=0, prefix="val_", scan_batches=scan_batches)

    try:
        return run_fit_loop(
            model, epochs=epochs, run_chunk=run_epoch, validate=validate, callbacks=callbacks, verbose=verbose,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
            validation_freq=validation_freq, on_resume=lambda: drop_stale_captures(model),
            on_weights_mutated=lambda: drop_stale_captures(model),
        )
    finally:
        # the last epoch's end started the next epoch's rebuild in a thread:
        # it must not outlive the fit
        wait = getattr(sequencer, "wait_for_rebuild", None)
        if wait is not None:
            wait()


def evaluate(model, sequencer, verbose: int = 0, prefix: str = "", scan_batches: Optional[bool] = None) -> dict:
    """Loss and metrics over a sequencer (the reference's ``evaluate``).
    ``scan_batches`` as in ``fit``: the batches in one scanned launch
    (the fixed-length inference loop) when they share one structure."""
    if model.loss is None:
        raise RuntimeError("call compile() before evaluate() (loaded models need recompiling, as in the reference)")
    model.build()
    batches = [sequencer[i] for i in range(len(sequencer))]
    structure = None if scan_batches is False else _scan_structure(batches, sequencer)
    if structure is not None:
        seeds = [model.next_seed() for _ in batches]
        accum = _scanned(model, False, structure, len(batches), None).run(model, batches, seeds, None)
    else:
        accum = [eval_step(model, batch) for batch in batches]
    logs = _reduce_logs(accum, prefix=prefix)
    if verbose:
        print(" - ".join(f"{k}: {v:.4f}" for k, v in logs.items()))
    return logs


def predict(model, sequencer, seed: Optional[int] = None) -> np.ndarray:
    """Model outputs for every supervised row, concatenated over batches in
    the caller's (graph, entity) order (``host_pred_rows`` undoes tile
    packing; arc rows keep the merged graph's arc order).  With ``seed``
    the random draws (a dim_state > 0 model's initial state) come from a
    local stream seeded with it: reproducible from call to call, and the
    model's own stream does not move."""
    model.build()
    local = torch.Generator().manual_seed(int(seed)) if seed is not None else None
    outs = []
    for i in range(len(sequencer)):
        batch = sequencer[i]
        generator = model.next_rng() if local is None else model.device_generator(model.next_seed(local))
        _, _, out, _, _ = model.forward(batch, training=False, generator=generator)
        out = model.served_output(out).cpu().numpy()
        rows = batch.host_pred_rows
        outs.append(out[rows] if rows is not None else out[batch.target_mask.cpu().numpy()])
    return np.concatenate(outs, axis=0)
