"""Ring all-gather over the ranks of a process group, the counterpart of
``gnnkeras_tpu.ops.ring`` (kernel row 9: the ``pallas_ring`` transport of
the edge-partitioned engine, ``parallel/partition.py``).

``ring_all_gather(x, group)`` takes each rank's ``x`` (rows, d), the same
shape and dtype on every rank, and returns (P·rows, d) holding every rank's
block in rank order.  It runs P − 1 ring steps: at step i rank r sends the
block of rank (r − i) mod P to its right neighbour and receives the block of
rank (r − i − 1) mod P from its left neighbour.

- On CUDA tensors it launches the kernel of ``csrc/ring.cu``.  Each rank's
  two receive slots and flag words live in device memory that the group's
  ranks map into each other's address space through CUDA IPC; the handles
  are exchanged once per group (and again when a larger buffer is needed)
  through ``all_gather_object`` on the group, and the kernel stores straight
  into the right neighbour's slot.  Every wait in the kernel is bounded; a
  wait that runs out sets an error word and the wrapper raises.  The ranks
  of the group must share one node (CUDA IPC).
- On CPU tensors it runs the plain version: the same P − 1 steps with
  ``dist.isend`` / ``dist.irecv`` on the group, in the kernel's order.
  Given CUDA tensors (``_ring_all_gather_plain`` is also the card's
  reference in ``chip_smoke.py``) it moves them through host memory, since
  the gloo backend sends only CPU tensors.

The TPU kernel pads the feature dim to 128 lanes; that is a TPU mechanism
and is not carried over.  The function is not differentiable, as in the JAX
package, whose ring has no VJP.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

# a wait in the kernel gives up after this long (the GPU's global timer): on
# one card without MPS the ranks' kernels are time-sliced, so a neighbour
# may take many scheduler slices to arrive
TIMEOUT_S = 60.0
_MIN_CAP = 1 << 20


def _ring_order(group) -> tuple:
    """(this rank's index in the group, group size, global ranks of the left
    and right neighbours)."""
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    glob = lambda i: dist.get_global_rank(group, i) if group is not None else i
    return r, p, glob((r - 1) % p), glob((r + 1) % p)


def _ring_all_gather_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring's P − 1 steps with point-to-point sends on the group, in the
    kernel's order; CUDA tensors travel through host memory."""
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
    """One group's mapped regions on this rank: its own, and its left and
    right neighbours' (the same mapping when P = 2)."""

    cap: int
    my: int
    left: int
    right: int
    opened: tuple
    err: torch.Tensor


_STATES: Dict[int, _RingState] = {}


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring all-gather: {what} failed: cudaError {err}")


def _setup(group, cap: int, device) -> _RingState:
    """Allocate this rank's region, exchange the IPC handles over the group
    and map the neighbours' regions (collective: every rank calls it)."""
    from gnnkeras_tpu_torch import kernels

    lib = kernels.load("ring")
    r, p, _, _ = _ring_order(group)
    with torch.cuda.device(device):
        my = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(64)
        _check(lib.gnn_ring_alloc(cap, ctypes.byref(my), handle), "cudaMalloc / cudaIpcGetMemHandle")
        handles = [None] * p
        dist.all_gather_object(handles, handle.raw, group=group)
        mapped = {}
        for q in {(r - 1) % p, (r + 1) % p}:
            ptr = ctypes.c_void_p()
            _check(lib.gnn_ring_open(handles[q], ctypes.byref(ptr)), "cudaIpcOpenMemHandle")
            mapped[q] = ptr.value
        err = torch.zeros(1, dtype=torch.int32, device=device)
    return _RingState(cap=cap, my=my.value, left=mapped[(r - 1) % p], right=mapped[(r + 1) % p],
                      opened=tuple(mapped.values()), err=err)


def _teardown(group, st: _RingState, device) -> None:
    """Unmap and free a group's regions once every rank is done with them."""
    from gnnkeras_tpu_torch import kernels

    lib = kernels.load("ring")
    torch.cuda.synchronize(device)
    dist.barrier(group=group)
    with torch.cuda.device(device):
        for ptr in st.opened:
            _check(lib.gnn_ring_close(ctypes.c_void_p(ptr)), "cudaIpcCloseMemHandle")
        _check(lib.gnn_ring_free(ctypes.c_void_p(st.my)), "cudaFree")


def _state(group, nbytes: int, device) -> _RingState:
    key = id(group) if group is not None else 0
    st = _STATES.get(key)
    if st is None or st.cap < nbytes:
        if st is not None:
            _teardown(group, st, device)
        cap = max(_MIN_CAP, -(-nbytes // 256) * 256)
        if st is not None:
            cap = max(cap, 2 * st.cap)
        st = _STATES[key] = _setup(group, cap, device)
    return st


def ring_all_gather(x: torch.Tensor, group=None, check: bool = True) -> torch.Tensor:
    """All-gather ``x`` (rows, d) over the group's ring → (P·rows, d), every
    rank's block in rank order.  A collective: every rank of ``group``
    (default: the world) calls it with the same shape and dtype.  On a CUDA
    tensor it launches the ring kernel (counted in
    ``kernels.LAUNCHES["ring_all_gather"]``) and, with ``check``, waits for it
    and raises if a wait in the kernel ran out; ``check=False`` leaves that
    to ``ring_error``."""
    if x.device.type == "cpu":
        return _ring_all_gather_plain(x, group)
    if x.device.type != "cuda":
        raise ValueError(f"ring_all_gather: no kernel for device {x.device}")
    from gnnkeras_tpu_torch import kernels

    r, p, _, _ = _ring_order(group)
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
        err = lib.gnn_ring_all_gather(x.data_ptr(), out.data_ptr(), st.my, st.left, st.right, r, p, nbytes, st.cap,
                                      int(TIMEOUT_S * 1e9), st.err.data_ptr(), kernels.stream_of(x))
    kernels.check(err, "ring_all_gather")
    kernels.LAUNCHES["ring_all_gather"] += 1
    if check:
        ring_error(group)
    return out


def ring_error(group=None) -> None:
    """Raise if a ring kernel of ``group`` on this rank ran out of time in a
    wait (synchronises with the card)."""
    st = _STATES.get(id(group) if group is not None else 0)
    if st is not None and int(st.err.item()) != 0:
        raise RuntimeError(
            f"ring_all_gather: a wait for a neighbour ran out after {TIMEOUT_S} s (a rank of the group did not "
            "take part, or the ring's counters disagree after an earlier failure); the group's ring is broken"
        )

