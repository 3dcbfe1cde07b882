"""Process groups and meshes, the counterpart of ``gnnkeras_tpu.parallel.mesh``.

The JAX package lays devices out on a named mesh and runs ``shard_map`` over
it.  The port runs one rank per process (the PyTorch idiom): a rank joins
the world group, and ``make_mesh`` lays the world's ranks out row-major on
named axes and gives each rank the process group of its line along every
axis.  A ``("data", "graph")`` mesh of shape 2×2 gives two ``graph`` groups
({0, 1} and {2, 3}), each a ring of its own, and two ``data`` groups.

Axis conventions are the JAX package's: ``data`` for data parallelism over
merged batches, ``graph`` for the edge partition of one large graph.

Backend: gloo, on the CPU and on the card.  On one card several ranks share
the device, which NCCL refuses ("Duplicate GPU"); gloo moves only CPU
tensors, so ``parallel/collectives.py`` stages CUDA tensors through host
memory, and the ring kernel (``ops/ring.py``) moves them card-side.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_process_group(rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: Optional[str] = None, timeout_s: float = 600.0) -> Tuple[int, int]:
    """Join the world group over gloo.  With no arguments the rank, world
    size and address come from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise
    pass all three (``init_method`` like ``tcp://localhost:29500``).
    Returns (rank, world size)."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if rank is None:
        dist.init_process_group("gloo", timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or the card ``LOCAL_RANK`` (else the
    rank) modulo the cards present, so several ranks share one card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no NVIDIA card is available; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def fold_in(seed: int, index: int) -> int:
    """A seed for stream ``index`` derived from ``seed`` (the counterpart of
    ``jax.random.fold_in``): ranks that share a model's seed draw their
    own dropout masks and initial states from ``fold_in(seed, rank)``."""
    g = torch.Generator().manual_seed(int(seed))
    offset = int(torch.randint(0, 2**62, (1,), generator=g))
    return (offset + 0x9E3779B97F4A7C15 * (int(index) + 1)) % 2**62


def axis_group(mesh: Optional["Mesh"], axis: str):
    """The process group of ``axis``: this rank's line of ``mesh`` along
    ``axis``, or the world without a mesh."""
    return dist.group.WORLD if mesh is None else mesh.group(axis)


def rank_generator(model, rank: int) -> torch.Generator:
    """Rank ``rank``'s generator on ``model``'s device: the model stream's
    next seed folded with the rank, as the JAX package folds the device
    index into a step's key.  Every rank draws the same seed, so the ranks'
    streams stay in step."""
    return model.device_generator(fold_in(model.next_seed(), rank))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh of the world's ranks: the axes, their
    sizes, its coordinate on each, and the group of its line along each."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, object]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(axes: Sequence[str] = ("graph",), shape: Optional[Sequence[int]] = None) -> Mesh:
    """Lay the world's ranks out row-major on ``axes`` (``shape`` must
    multiply out to the world size; one axis takes every rank) and create
    the groups of every line along every axis.  A collective: every rank
    calls it with the same arguments."""
    axes = tuple(str(a) for a in axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        if len(axes) != 1:
            raise ValueError("shape is required for multi-axis meshes")
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != world size {world}")
    grid = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = {}
    for k, axis in enumerate(axes):
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in lines:  # every rank creates every group, in the same order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(axis_names=axes, shape=shape, coords=coords, groups=groups)
