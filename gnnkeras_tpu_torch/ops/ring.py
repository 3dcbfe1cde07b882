"""Ring all-gather over the ranks of a process group, the counterpart of
``gnnkeras_tpu.ops.ring`` (kernel row 9: the ``pallas_ring`` transport of
the edge-partitioned engine, ``parallel/partition.py``).

``ring_all_gather(x, group)`` takes each rank's ``x`` (rows, d), the same
shape and dtype on every rank, and returns (P·rows, d) holding every rank's
block in rank order.

- On CUDA tensors it runs ``csrc/ring.cu``: a push kernel stores the rank's
  block into a receive slot of every peer, the rank waits for the peers'
  pushes off the device (a host wait on counters the ranks share in host
  memory, then the stream's wait on the peer's interprocess CUDA event),
  and a copy-out kernel moves the received blocks into the output.  Each
  rank's receive region lives in device memory that the group's ranks map
  into each other's address space through CUDA IPC; the regions' and
  events' handles are exchanged once per group (and again when a larger
  buffer is needed) through ``all_gather_object`` on the group, and the
  counters live in a file of the build directory that every rank maps and
  that is unlinked once they have.  Every wait for a peer is a host wait of
  at most ``TIMEOUT_S``; one that runs out raises.  No call synchronises
  with the card.  A peer's queued push can still fail to finish (its
  process died after it posted): ``ring_wait(group)`` waits, again for at
  most ``TIMEOUT_S``, until the last call has completed on the card, and a
  caller runs it before it synchronises with the card itself.  The ranks of
  the group must share one node (CUDA IPC).
- On CPU tensors it runs the plain version: the JAX kernel's P − 1 ring
  steps with ``dist.isend`` / ``dist.irecv`` on the group (at step i rank r
  sends the block of rank (r − i) mod P to its right neighbour and receives
  the block of rank (r − i − 1) mod P from its left).  Given CUDA tensors
  (``_ring_all_gather_plain`` is also the card's reference in
  ``chip_smoke.py``) it moves them through host memory, since the gloo
  backend sends only CPU tensors.

The TPU kernel pads the feature dim to 128 lanes; that is a TPU mechanism
and is not carried over.  The function is not differentiable, as in the JAX
package, whose ring has no VJP.
"""

from __future__ import annotations

import ctypes
import dataclasses
import mmap
import os
import uuid
from typing import Dict

import torch
import torch.distributed as dist

# a host wait for a peer gives up after this long: the peer did not call, or
# is that far behind
TIMEOUT_S = 60.0
_MIN_CAP = 1 << 20
_HANDLES = 3 * 64  # a rank's region and its two events
_TIMED_OUT = -1  # gnn_ring_all_gather: a host wait ran out


def _ring_order(group) -> tuple:
    """(this rank's index in the group, group size, global ranks of the left
    and right neighbours)."""
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    glob = lambda i: dist.get_global_rank(group, i) if group is not None else i
    return r, p, glob((r - 1) % p), glob((r + 1) % p)


def _ring_all_gather_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The JAX kernel's P − 1 ring steps with point-to-point sends on the
    group; CUDA tensors travel through host memory."""
    r, p, left, right = _ring_order(group)
    rows = x.shape[0]
    cur = x.detach().cpu().contiguous()
    out = torch.empty((p * rows,) + tuple(x.shape[1:]), dtype=x.dtype)
    out[r * rows:(r + 1) * rows] = cur
    for i in range(p - 1):
        recv = torch.empty_like(cur)
        reqs = [dist.isend(cur, right, group=group, tag=i), dist.irecv(recv, left, group=group, tag=i)]
        for req in reqs:
            req.wait()
        q = (r - i - 1) % p
        out[q * rows:(q + 1) * rows] = recv
        cur = recv
    return out.to(x.device)


@dataclasses.dataclass
class _RingState:
    """One group's ring on this rank: the C state (``gnn_ring_create``), the
    mapped counters, and whether a wait ran out (the ring is then broken)."""

    cap: int
    ring: int
    counters: mmap.mmap
    counters_view: object
    broken: bool = False


_STATES: Dict[int, _RingState] = {}


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring all-gather: {what} failed: cudaError {err}")


def _shared_counters(group, r: int, p: int) -> mmap.mmap:
    """2·P zeroed cache lines of host memory that every rank of the group
    maps: rank 0 creates the file, the others map it, rank 0 unlinks it."""
    from gnnkeras_tpu_torch import kernels

    size = 2 * p * 64
    path = None
    if r == 0:
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        path = os.path.join(kernels.BUILD_DIR, f"ring-{os.getpid()}-{uuid.uuid4().hex}")
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        os.ftruncate(fd, size)
        os.close(fd)
    paths = [None] * p
    dist.all_gather_object(paths, path, group=group)
    fd = os.open(paths[0], os.O_RDWR)
    try:
        counters = mmap.mmap(fd, size)
    finally:
        os.close(fd)
    dist.barrier(group=group)
    if r == 0:
        os.unlink(path)
    return counters


def _setup(group, cap: int, device) -> _RingState:
    """This rank's region and events, the shared counters, and every peer's
    region and events mapped here (collective: every rank calls it)."""
    from gnnkeras_tpu_torch import kernels

    lib = kernels.load("ring")
    r, p, _, _ = _ring_order(group)
    counters = _shared_counters(group, r, p)
    view = ctypes.c_char.from_buffer(counters)
    with torch.cuda.device(device):
        ring = ctypes.c_void_p()
        handles = ctypes.create_string_buffer(_HANDLES)
        _check(lib.gnn_ring_create(r, p, cap, ctypes.addressof(view), ctypes.byref(ring), handles),
               "cudaMalloc / cudaIpcGetMemHandle / cudaIpcGetEventHandle")
        st = _RingState(cap=cap, ring=ring.value, counters=counters, counters_view=view)
        every = [None] * p
        dist.all_gather_object(every, handles.raw, group=group)
        _check(lib.gnn_ring_connect(ring, b"".join(every)), "cudaIpcOpenMemHandle / cudaIpcOpenEventHandle")
    return st


def _teardown(group, st: _RingState, device) -> None:
    """Unmap and free a group's regions and events once every rank is done
    with them."""
    from gnnkeras_tpu_torch import kernels

    lib = kernels.load("ring")
    torch.cuda.synchronize(device)
    dist.barrier(group=group)
    with torch.cuda.device(device):
        _check(lib.gnn_ring_destroy(ctypes.c_void_p(st.ring)), "cudaIpcCloseMemHandle / cudaFree")
    del st.counters_view
    st.counters.close()


def _state(group, nbytes: int, device) -> _RingState:
    key = id(group) if group is not None else 0
    st = _STATES.get(key)
    if st is not None and st.broken:
        raise RuntimeError("ring_all_gather: an earlier call on this group timed out; its ring is broken")
    if st is None or st.cap < nbytes:
        if st is not None:
            _teardown(group, st, device)
        cap = max(_MIN_CAP, -(-nbytes // 256) * 256)
        if st is not None:
            cap = max(cap, 2 * st.cap)
        st = _STATES[key] = _setup(group, cap, device)
    return st


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather ``x`` (rows, d) over the group → (P·rows, d), every rank's
    block in rank order.  A collective: every rank of ``group`` (default:
    the world) calls it with the same shape and dtype.  On a CUDA tensor it
    launches the push and the copy-out kernel (each counted in
    ``kernels.LAUNCHES["ring_all_gather"]``) and raises if a peer did not
    push within ``TIMEOUT_S``."""
    if x.device.type == "cpu":
        return _ring_all_gather_plain(x, group)
    if x.device.type != "cuda":
        raise ValueError(f"ring_all_gather: no kernel for device {x.device}")
    from gnnkeras_tpu_torch import kernels

    _, p, _, _ = _ring_order(group)
    x = x.detach()
    if not x.is_contiguous():
        raise ValueError("ring_all_gather: x must be contiguous")
    if p == 1:
        return x.clone()
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return x.new_empty((p * x.shape[0],) + tuple(x.shape[1:]))
    st = _state(group, nbytes, x.device)
    out = x.new_empty((p * x.shape[0],) + tuple(x.shape[1:]))
    lib = kernels.load("ring")
    with torch.cuda.device(x.device):
        err = lib.gnn_ring_all_gather(st.ring, x.data_ptr(), out.data_ptr(), nbytes, int(TIMEOUT_S * 1e9),
                                      kernels.stream_of(x))
    if err == _TIMED_OUT:
        st.broken = True
        raise RuntimeError(
            f"ring_all_gather: a wait for a peer ran out after {TIMEOUT_S} s (a rank of the group did not take part, "
            "or the ring's counters disagree after an earlier failure); the group's ring is broken"
        )
    kernels.check(err, "ring_all_gather")
    kernels.LAUNCHES["ring_all_gather"] += 2  # the push and the copy-out
    return out


def ring_wait(group=None) -> None:
    """Wait until this rank's last ``ring_all_gather`` on the group has
    completed on the card, the peers' pushes it read included; raise if that
    takes longer than ``TIMEOUT_S`` (a peer's queued push never finished).
    Nothing to do before the first call on a CUDA tensor."""
    st = _STATES.get(id(group) if group is not None else 0)
    if st is None:
        return
    from gnnkeras_tpu_torch import kernels

    err = kernels.load("ring").gnn_ring_settle(st.ring, int(TIMEOUT_S * 1e9))
    if err == _TIMED_OUT:
        st.broken = True
        raise RuntimeError(
            f"ring_all_gather: the last call did not complete on the card within {TIMEOUT_S} s (a peer's push "
            "never finished); the group's ring is broken"
        )
    kernels.check(err, "ring_wait")
