"""Worker-side training session.

Reference analogue: `python/ray/train/_internal/session.py:84` — the user's
``train_loop_per_worker`` runs in a daemon thread; ``report(metrics,
checkpoint)`` hands results to the driver through a rendezvous queue (the
training thread blocks until the driver consumes, keeping workers in
lockstep the way the reference's result queue does at `session.py:147,287`).
"""

from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

REPORT = "report"
FINISHED = "finished"
ERROR = "error"


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_id: str = ""


class _TrainSession:
    def __init__(self, train_fn: Callable[[Optional[dict]], None],
                 config: Optional[dict], context: TrainContext,
                 checkpoint: Optional[Checkpoint]):
        self.context = context
        self.checkpoint = checkpoint
        self._result_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._consumed = threading.Event()
        self._dataset_shards: Dict[str, Any] = {}
        self._thread = threading.Thread(
            target=self._run, args=(train_fn, config),
            name=f"train-session-rank{context.world_rank}", daemon=True,
        )

    def start(self):
        self._thread.start()

    def _run(self, train_fn, config):
        try:
            # Reference semantics (`construct_train_func`): a loop that
            # accepts a parameter receives the config dict ({} if none given).
            import inspect

            takes_config = False
            try:
                takes_config = len(inspect.signature(
                    train_fn).parameters) >= 1
            except (TypeError, ValueError):
                pass
            if takes_config:
                train_fn(config if config is not None else {})
            else:
                train_fn()
        except BaseException as e:  # noqa: BLE001
            self._result_q.put((ERROR, (e, traceback.format_exc())))
            return
        self._result_q.put((FINISHED, None))

    # ---------------------------------------------------------------- worker API

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self._consumed.clear()
        self._result_q.put((REPORT, (metrics, checkpoint)))
        # Lockstep: wait until the driver drained this round before
        # producing the next (reference blocks on a bounded queue too).
        self._consumed.wait()

    # ---------------------------------------------------------------- driver side

    def get_next(self):
        """Blocks until the next report/finish/error event."""
        kind, payload = self._result_q.get()
        if kind == REPORT:
            self._consumed.set()
        return kind, payload

    def finish(self, timeout: Optional[float] = 10):
        self._consumed.set()
        self._thread.join(timeout=timeout)


_session: Optional[_TrainSession] = None
_session_lock = threading.Lock()


def _init_session(session: _TrainSession):
    global _session
    with _session_lock:
        _session = session


def _shutdown_session():
    global _session
    with _session_lock:
        _session = None


def get_session() -> Optional[_TrainSession]:
    return _session


# ------------------------------------------------------------------ public API
# (reference: ``ray.air.session`` / ``ray.train`` free functions)


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None,
           **_):
    """Report metrics (and optionally a checkpoint) to the trainer driver."""
    s = get_session()
    if s is None:
        raise RuntimeError("session.report() called outside a train session")
    if checkpoint is not None and not isinstance(checkpoint, Checkpoint):
        checkpoint = Checkpoint.from_dict(dict(checkpoint))
    s.report(dict(metrics), checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from (None on a fresh start)."""
    s = get_session()
    return s.checkpoint if s else None


def get_context() -> TrainContext:
    s = get_session()
    return s.context if s else TrainContext()


def get_world_rank() -> int:
    return get_context().world_rank


def get_world_size() -> int:
    return get_context().world_size


def get_local_rank() -> int:
    return get_context().local_rank


def get_dataset_shard(name: str = "train"):
    """The per-worker shard of a dataset passed to the trainer
    (reference: `session.get_dataset_shard`)."""
    s = get_session()
    if s is None:
        return None
    return s._dataset_shards.get(name)
