"""Multi-host layout: joining the world, host-aware meshes and the
communication-volume model, the counterpart of
``gnnkeras_tpu.parallel.multihost``.

The design rule is the JAX package's: the per-iteration halo exchange of the
partitioned unfolding stays inside a host (the ``graph`` axis, NVLink
between the cards of one machine), and only the per-step gradient reduction
crosses hosts (the ``data`` axis).  That is the hybrid data × graph step of
``parallel/hybrid.py`` with the data axis across hosts; this module gives
the mesh whose rows are hosts (``make_multihost_mesh``), the join of the
world group from the environment ``torchrun`` sets (``initialize_multihost``)
and the per-step volume model (``comm_volume``).

A rank's host is ``GROUP_RANK`` (torchrun's node rank) when set, else the
order of first appearance of its host name among the ranks; a row of the
mesh must hold the ranks of one host (``LOCAL_WORLD_SIZE`` of them, when
set).  ``tools/multihost_sim.py`` simulates 2 hosts on one machine by
setting that environment per rank.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import numpy as np
import torch.distributed as dist


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join the world group over gloo: from ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` when given, else
    from the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  A no-op when the group is already
    joined, or when neither is there (one process).  Returns the world
    size."""
    from gnnkeras_tpu_torch.parallel.mesh import init_process_group

    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes is not None and num_processes > 1:
        init_process_group(process_id, num_processes, f"tcp://{coordinator_address}")
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1 and "MASTER_ADDR" in os.environ:
        init_process_group()
    else:
        return 1
    return dist.get_world_size()


def _host_ids():
    """(every rank's host index in rank order, every rank's (GROUP_RANK,
    host name, LOCAL_WORLD_SIZE)), through an all-gather: the index is
    ``GROUP_RANK`` when every rank has it, else the host names numbered in
    order of first appearance."""
    mine = (os.environ.get("GROUP_RANK"), socket.gethostname(), os.environ.get("LOCAL_WORLD_SIZE"))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    if all(g is not None for g, _, _ in everyone):
        return [int(g) for g, _, _ in everyone], everyone
    names = {}
    return [names.setdefault(h, len(names)) for _, h, _ in everyone], everyone


def make_multihost_mesh(n_hosts: int, devices_per_host: int, dcn_axis: str = "data", ici_axis: str = "graph"):
    """A (``n_hosts`` × ``devices_per_host``) mesh of the world's ranks,
    one row a host, so the outer axis crosses hosts and the inner one stays
    inside each (a collective: every rank calls it).  Raises when the world
    is not that size, or when a row would straddle hosts (it would put the
    per-iteration halo of the inner axis on the inter-host link)."""
    from gnnkeras_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    if world != n_hosts * devices_per_host:
        raise ValueError(f"need {n_hosts * devices_per_host} ranks, have {world}")
    hosts, everyone = _host_ids()
    rows = np.asarray(hosts).reshape(n_hosts, devices_per_host)
    if len(set(hosts)) != n_hosts or any(len(set(row.tolist())) != 1 for row in rows):
        raise ValueError(f"n_hosts={n_hosts} must equal the number of hosts ({len(set(hosts))}) with each mesh row "
                         f"on one host (ranks' hosts {hosts}), so each row stays on one host")
    local_sizes = {int(s) for _, _, s in everyone if s is not None}
    if local_sizes and local_sizes != {devices_per_host}:
        raise ValueError(f"devices_per_host={devices_per_host} but LOCAL_WORLD_SIZE is {sorted(local_sizes)}: "
                         "the mesh rows must align with the hosts")
    return make_mesh((dcn_axis, ici_axis), (n_hosts, devices_per_host))


@dataclasses.dataclass
class CommVolume:
    """Per-training-step communication volumes (bytes) of the hybrid
    data (across hosts) × graph (inside a host) step for one replica."""

    ici_halo_bytes_per_iteration: int  # the boundary-state exchange, every unfolding iteration
    ici_bytes_per_step: int  # halo · k plus the graph axis's gradient reduction
    dcn_bytes_per_step: int  # the data axis's gradient reduction only
    n_iterations: int

    def scaling_efficiency_estimate(self, step_compute_seconds: float,
                                    dcn_bandwidth_bytes_per_s: float = 25e9) -> float:
        """Projected 1→N-host scaling efficiency, everything but the
        inter-host reduction overlapped: compute / (compute + dcn_time)."""
        dcn_time = self.dcn_bytes_per_step / dcn_bandwidth_bytes_per_s
        return step_compute_seconds / (step_compute_seconds + dcn_time)


def _n_params(params) -> int:
    if hasattr(params, "parameters"):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    return sum(int(np.prod(tuple(x.shape))) for x in params)


def comm_volume(pg, params, state_width: int, n_iterations: Optional[int] = None,
                dtype_bytes: int = 4) -> CommVolume:
    """Per-step volumes of a ``PartitionedGraph`` ``pg`` trained under the
    hybrid data × graph step with ``params`` (a model, whose parameters
    count, or a dict or list of arrays): every rank gathers the published
    halo rows (H·d from each of the D parts, or the whole state without a
    halo) each iteration; the gradient all-reduce moves about twice the
    parameters."""
    D = pg.n_parts
    rows_moved = (int(pg.publish_local.shape[1]) if pg.publish_local is not None else int(pg.nodes_per_part)) * D
    halo = rows_moved * state_width * dtype_bytes
    grad_bytes = 2 * _n_params(params) * dtype_bytes
    k = n_iterations if n_iterations is not None else 1
    return CommVolume(ici_halo_bytes_per_iteration=halo, ici_bytes_per_step=halo * k + grad_bytes,
                      dcn_bytes_per_step=grad_bytes, n_iterations=k)
