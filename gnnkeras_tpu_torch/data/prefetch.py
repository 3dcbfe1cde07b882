"""Device prefetch for the fit / evaluate loops on CUDA streams,
counterpart of ``gnnkeras_tpu.data.prefetch``.

The sequencers overlap the host's batch build with training (the epoch
rebuild runs in a background thread).  This wrapper overlaps the
host-to-card copy: the inner sequencer builds its batches on the CPU in
pinned memory (``pin_memory=True``: pinned once, by the build, which runs in
the background rebuild thread), and the next ``lookahead`` batches are
copied to the card on a side stream (``non_blocking``) while the step of
the current one runs.  A batch not built pinned is pinned here, on the
calling thread, at every copy.  Each copy records an event on the side
stream; ``__getitem__`` makes the current stream wait on it and marks every
copied tensor as used by the current stream (``record_stream``), so the
caching allocator does not hand its memory out again before the step has
read it.

Same protocol as a sequencer (``len``, ``[i]``, ``on_epoch_end``)::

    inner = MultiGraphSequencer(graphs, "g", "average", device="cpu", pin_memory=True)
    gnn.fit(PrefetchSequencer(inner), epochs=10)

On a CPU ``device`` it hands the inner batches out as they are.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from gnnkeras_tpu_torch.utils.dtypes import resolve_device


class PrefetchSequencer:
    """Wraps a sequencer built on the CPU; batches come back on ``device``,
    copied ``lookahead`` steps ahead of use."""

    def __init__(self, sequencer, lookahead: int = 2, device="cuda"):
        if lookahead < 1:
            raise ValueError(f"lookahead {lookahead} must be at least 1")
        self.inner = sequencer
        self.lookahead = int(lookahead)
        self.device = resolve_device(device)
        self._cache: dict = {}
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __len__(self) -> int:
        return len(self.inner)

    def _transfer(self, j: int):
        """Batch ``j`` copied to the card on the side stream, and the event
        recorded after its copies."""
        pinned = pytree.tree_map(lambda t: t if t.is_pinned() else t.pin_memory(), self.inner[j])
        with torch.cuda.stream(self._stream):
            moved = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return moved, event

    def __getitem__(self, i: int):
        if self._stream is None:
            return self.inner[i]
        n = len(self.inner)
        for j in range(i, min(i + 1 + self.lookahead, n)):
            if j not in self._cache:
                self._cache[j] = self._transfer(j)
        batch, event = self._cache.pop(i)
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in pytree.tree_leaves(batch):
            t.record_stream(current)
        return batch

    def on_epoch_end(self) -> None:
        # the shuffle rebuilds the batches: anything copied ahead is stale
        self._cache.clear()
        self.inner.on_epoch_end()

    def copy(self) -> "PrefetchSequencer":
        return PrefetchSequencer(self.inner.copy(), self.lookahead, self.device)

    def with_graphs(self, graphs) -> "PrefetchSequencer":
        return PrefetchSequencer(self.inner.with_graphs(graphs), self.lookahead, self.device)

    # inner methods that rebuild the inner batches: what was copied ahead is
    # of the old batches and must be dropped
    _MUTATORS = frozenset({"set_batch_size", "build_batches"})

    def __getattr__(self, name):
        # passthrough for the sequencer's attributes (focus, data, get_config, ...)
        attr = getattr(self.inner, name)
        if name in PrefetchSequencer._MUTATORS:
            def invalidating(*args, **kwargs):
                self._cache.clear()
                return attr(*args, **kwargs)

            return invalidating
        return attr
