"""Spawned ranks that run functions together.

``RankPool(n, init_method)`` starts n processes (``spawn``), each of which
joins the default process group as one rank (``init_process_group``) and
then waits for work.  ``pool.run(fn, *args)`` calls ``fn(*args)`` on every
rank at once, as one SPMD program, and returns the ranks' results in rank
order.  ``fn`` and its arguments and results cross process boundaries by
pickling: ``fn`` is found by its module and name, so it must be defined at
a module's top level (in a module whose import is cheap: every rank
imports it), and results should be host data.

A rank whose ``fn`` raises reports its traceback, and ``run`` raises
``RankError`` with every failed rank's; a rank that dies, or a call that
outlasts ``timeout_s``, ends the pool and raises as well.  The process
group's own timeout makes a collective that a failed rank never joins fail
on the others instead of hanging.  A rank waiting for work looks every
``_POLL_S`` seconds whether its parent still lives, and leaves the process
group and exits when it does not: a parent that dies without ``close()``
(an abort skips the exit handlers that reap daemon processes) leaves no
rank behind.
"""

from __future__ import annotations

import multiprocessing
import queue
import time
import traceback
from typing import Any, List, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch.parallel.mesh import init_process_group


#: seconds a rank waits for a task before it looks for its parent
_POLL_S = 1.0


class RankError(RuntimeError):
    """A rank of a ``RankPool`` failed."""


def _rank_main(rank, world_size, init_method, backend, device, timeout_s,
               tasks, results):
    try:
        init_process_group(init_method, world_size, rank, backend, device,
                           timeout_s)
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    parent = multiprocessing.parent_process()
    try:
        while True:
            try:
                item = tasks.get(timeout=_POLL_S)
            except queue.Empty:
                if parent.is_alive():
                    continue
                # nobody reads the results any more: exit without waiting
                # for the queue's feeder
                results.cancel_join_thread()
                break
            if item is None:
                break
            fn, args = item
            try:
                out = (rank, True, fn(*args))
            except Exception:  # noqa: BLE001 - reported to the parent
                out = (rank, False, traceback.format_exc())
            results.put(out)
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` spawned ranks of one process group (see the module
    docstring).  ``backend`` defaults as ``init_process_group`` does
    (``nccl`` on CUDA, ``gloo`` on the CPU); ranks on one card need
    ``"gloo"``.  ``device`` is each rank's device (``"cuda"``: rank %
    device count).  ``timeout_s`` bounds the start, every ``run`` and
    every collective of the ranks."""

    def __init__(self, world_size: int, init_method: str,
                 backend: Optional[str] = None, device="cuda",
                 timeout_s: float = 300.0):
        self.world_size = world_size
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world_size, init_method, backend, str(device), timeout_s,
                self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self._collect(timeout_s)

    def run(self, fn, *args, timeout_s: Optional[float] = None) -> List[Any]:
        """``fn(*args)`` on every rank at once; the results in rank
        order."""
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(timeout_s or self.timeout_s)

    def _collect(self, timeout_s):
        out: List[Any] = [None] * self.world_size
        errors = {}
        deadline = time.monotonic() + timeout_s
        for _ in range(self.world_size):
            while True:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close()
                        raise RankError(
                            f"ranks {dead} died" if dead else
                            f"ranks did not answer within {timeout_s} s")
            if ok:
                out[rank] = value
            else:
                errors[rank] = value
        if errors:
            raise RankError("\n".join(f"rank {r}:\n{tb}"
                                      for r, tb in sorted(errors.items())))
        return out

    def close(self, timeout_s: float = 30.0):
        """Stop the ranks: each leaves its loop and the process group; one
        still alive after ``timeout_s`` is killed."""
        for p, q in zip(self._procs, self._tasks):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
