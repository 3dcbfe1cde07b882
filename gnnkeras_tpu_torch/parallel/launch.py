"""Start the ranks of a run: ``spawn(fn, nprocs, rank_args)`` runs
``fn(rank, world_size, *rank_args[rank])`` in ``nprocs`` new processes
(``torch.multiprocessing``, start method "spawn", so a rank imports only
what ``fn``'s module imports), each joined to a gloo world group on
``tcp://127.0.0.1:<a free port>``, and returns the ranks' results in rank
order.  Arguments and results travel pickled by value (no shared memory);
keep them to NumPy arrays, tensors and plain Python objects.  A rank that
raises makes ``spawn`` stop the others and raise with its traceback; one
that dies without a result, too.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, init_method, payload, results, threads):
    import torch.distributed as dist

    from gnnkeras_tpu_torch.parallel.mesh import init_process_group

    torch.set_num_threads(threads)
    try:
        init_process_group(rank, world, init_method)
        out = fn(rank, world, *pickle.loads(payload))
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, rank_args: Optional[Sequence[tuple]] = None, threads: int = 1,
          timeout_s: float = 900.0) -> List:
    """Run ``fn(rank, nprocs, *rank_args[rank])`` on ``nprocs`` ranks (``fn``
    a module-level function); returns the results in rank order."""
    rank_args = [()] * nprocs if rank_args is None else list(rank_args)
    if len(rank_args) != nprocs:
        raise ValueError(f"{len(rank_args)} argument tuples for {nprocs} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, init_method, pickle.dumps(tuple(a)), results,
                                                  threads), daemon=True)
             for r, a in enumerate(rank_args)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < nprocs:
            try:
                rank, ok, data = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} died without a result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish within {timeout_s} s")
                continue
            if ok:
                got[rank] = pickle.loads(data)
            else:  # the others may wait on it in a collective: stop them
                errors.append(f"--- rank {rank} ---\n{data}")
                break
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        return [got[r] for r in range(nprocs)]
    finally:
        done = len(got) == nprocs
        for p in procs:
            if not done:  # a rank failed or hung: the rest may wait on it forever
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
