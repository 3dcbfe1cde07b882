"""BatchNorm-statistics recalibration, counterpart of
``gnnkeras_tpu.training.calibrate``.

The models apply BatchNorm inside the convergence loop and evaluate with
the momentum-0.99 moving statistics, which a short training leaves near
their initial values.  ``recalibrate_batchnorm`` converges those statistics
without touching the weights: it replays training-mode forwards over a
sequencer and commits only the new moving statistics, as ``fit`` does.
Opt-in; parity with the reference holds when it is not called.
"""

from __future__ import annotations

import torch


def recalibrate_batchnorm(model, sequencer, passes: int = 50, seed: int = 0):
    """Replay ``passes`` epochs of training-mode forwards (no gradients),
    committing the BatchNorm moving statistics after each batch (momentum
    0.99, as in training).  Weights, optimizer state and the model's random
    stream are untouched: a generator of its own, seeded by ``seed``, draws
    any random initial state or dropout mask.  Returns the model."""
    from gnnkeras_tpu_torch.training.trainer import _load_bn_state

    model.build()
    generator = torch.Generator(device=model.device).manual_seed(int(seed))
    batches = [sequencer[i] for i in range(len(sequencer))]
    with torch.no_grad():
        for _ in range(passes):
            for batch in batches:
                new_state = model.forward(batch, training=True, generator=generator)[-1]
                _load_bn_state(model, new_state)
    return model
