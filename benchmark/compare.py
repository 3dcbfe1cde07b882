"""The numbers that decide ``correct`` in a training cell: gaps between
what the program produced and what the reference computes from the same
inputs, over the epochs set-up runs through the window's own ``fit``
(all of them, or those after the first where the reference follows the
program; ``drivers/fit.py``).  ``start`` is the state the compared epochs
start from (the seeded weights with Adam at zero, or the program's state).

- ``loss``: the largest relative gap of an epoch's logged loss;
- ``grad``: what Adam's first moment gained over the first compared epoch
  (``mu − b1^steps · mu_start``: for one step from zero, 0.1 × the first
  gradient as the optimizer got it), by the worst leaf: the gap between
  the program's norm of the leaf and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``change``: the parameters' change over the compared epochs, by the worst
  leaf as ``grad``; a leaf whose first reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone under Adam) is
  left out.

A workload whose worst leaf swings with rounding from seed to seed (the
near-cancelling gradients that BatchNorm makes) takes ``grad`` and
``change`` by the median of the leaves' gaps instead (``"leaf": "median"``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's first gradient norm
ADAM_B1 = 0.9


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], keys: Sequence[str],
             leaf: str = "worst") -> float:
    """The gap between the program's and the reference's norm of each leaf,
    over the larger of the reference's norm of that leaf and of the median
    leaf; of the worst leaf, or the median of the leaves' gaps."""
    p, r = _norms({k: program[k] for k in keys}), _norms({k: reference[k] for k in keys})
    median = float(np.median(list(r.values())))
    gaps = []
    for k in keys:
        denom = max(r[k], median)
        gaps.append(abs(p[k] - r[k]) / denom if denom > 0 else (0.0 if p[k] == 0 else math.inf))
    if any(math.isnan(g) for g in gaps):
        return math.inf
    return max(gaps) if leaf == "worst" else float(np.median(gaps))


def relative_gap(program: float, reference: float) -> float:
    gap = abs(program - reference) / abs(reference)
    return gap if math.isfinite(gap) else math.inf


def epoch_losses(step_losses: List[float], step_rows: List[int], steps_per_epoch: int) -> List[float]:
    """The fit's logged loss of each epoch: the mean of its steps' losses
    weighted by their supervised rows."""
    out = []
    for e in range(len(step_losses) // steps_per_epoch):
        part = slice(e * steps_per_epoch, (e + 1) * steps_per_epoch)
        rows = step_rows[part]
        out.append(sum(l * n for l, n in zip(step_losses[part], rows)) / sum(rows))
    return out


def training_numbers(program: dict, reference: dict, start: dict, steps_per_epoch: int,
                     leaf: str = "worst") -> Dict[str, float]:
    """``program`` / ``reference``: ``losses`` and ``states`` (``params``,
    ``mu``) of the compared epochs; ``reference`` also ``first_grads``.
    ``leaf``: ``grad`` and ``change`` by the worst leaf or the median one."""
    keys = list(reference["first_grads"])
    pairs = list(zip(program["losses"], reference["losses"]))
    loss = (max(relative_gap(p, r) for p, r in pairs) if len(program["losses"]) == len(reference["losses"]) > 0
            else math.inf)
    decay = ADAM_B1 ** steps_per_epoch
    gained = lambda side: {k: side["states"][0]["mu"][k] - decay * start["mu"][k] for k in keys}
    grad_norms = _norms(reference["first_grads"])
    floor = NEGLIGIBLE_GRAD * float(np.median(list(grad_norms.values())))
    moved = [k for k in keys if grad_norms[k] >= floor]
    change = lambda side: {k: side["states"][-1]["params"][k] - start["params"][k] for k in moved}
    return {"loss": loss, "grad": leaf_gap(gained(program), gained(reference), keys, leaf),
            "change": leaf_gap(change(program), change(reference), moved, leaf)}
