"""Burst mode's gate for lease-reused tasks in the port's direct transport
(``ray_tpu_torch/core/direct.py``, ``_submit_task`` and ``_fast_turnover``).

A call is pipelined onto a busy lease channel only where the channel's
turnover EWMA is under ``direct_lease_turnover_ms``, its oldest call in
flight has been out for less than that, and the call's function has
completed a direct call on that lease shape before.  Otherwise it goes to
the raylet, which spreads it over the pool.  The unit tests drive the gate
with a stub channel under a held clock (``frozen_clock``: ``direct`` and
the stub read one instant, so a call's age is exactly the one a test
gives it, however long the host takes between two statements); the
cluster test shows that a fan-out of no-op tasks is still pipelined, read
from the channels' own pending tables, on the real clock.
"""

import os
import shutil
import time
import types
from collections import OrderedDict

import pytest
from test_torch_runtime_parity import assert_port_left_nothing

from ray_tpu_torch.core import direct
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import FunctionID, TaskID
from ray_tpu_torch.core.task_spec import TaskSpec

KEY = ("lease", (("CPU", 1.0),))


class _StubChannel:
    """A lease channel with calls in flight: records what the client asks
    of it."""

    def __init__(self, ewma, ages, task_ids=None):
        now = direct.time.time()
        self.key = KEY
        self.alive = True
        self.turnover_ewma = ewma
        self.pending = OrderedDict()
        for age, tid in zip(ages, task_ids or [TaskID.from_random()
                                               for _ in ages]):
            entry = direct._Pending(_spec(), None)
            entry.t_sent = now - age
            self.pending[tid] = entry
        self.submitted, self.polls = [], 0

    def idle(self):
        return not self.pending

    def poll(self):
        self.polls += 1

    def submit(self, spec, ctx):
        self.submitted.append(spec.task_id)
        self.pending[spec.task_id] = direct._Pending(spec, ctx)
        self.pending[spec.task_id].t_sent = direct.time.time()
        return True


FN = FunctionID.from_random()


def _spec(fn=None):
    return TaskSpec(task_id=TaskID.from_random(), name="f",
                    function_id=fn or FN, resources={"CPU": 1.0})


def _client(ch, st):
    worker = types.SimpleNamespace(worker_id=types.SimpleNamespace(
        hex=lambda: "00" * 16))
    client = direct.DirectCallClient(worker, broker=lambda aid: None,
                                     resubmit=lambda spec: None,
                                     lease=lambda spec: None)
    client._channels[KEY] = ch
    client._actors[KEY] = st
    return client


def _state(fast=()):
    """The client's state for the lease shape, with the functions in
    ``fast`` proven (their probes resolved)."""
    return {"last": None, "completed": 1, "next_try": 0.0,
            "probes": dict.fromkeys(fast)}


LIMIT_S = config.direct_lease_turnover_ms / 1000.0


class _FrozenClock:
    """The ``time`` module as ``direct`` sees it, with ``time()`` held at
    one instant."""

    def __init__(self):
        self.now = time.time()

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(autouse=True)
def frozen_clock(request, monkeypatch):
    """Every stub-channel test runs on a held clock; the cluster test
    (``port_cluster``) on the real one."""
    if "port_cluster" in request.fixturenames:
        return None
    clock = _FrozenClock()
    monkeypatch.setattr(direct, "time", clock)
    return clock


def test_threshold_is_the_config_default():
    assert config.direct_lease_turnover_ms == 2.0
    assert config.direct_burst is True


@pytest.mark.parametrize("oldest_age, pipelined", [
    (0.0, True), (LIMIT_S * 0.25, True), (LIMIT_S * 5, False), (5.0, False)])
def test_oldest_call_in_flight_gates_pipelining(oldest_age, pipelined):
    """A fast channel (EWMA far under the threshold) whose oldest call in
    flight is older than the threshold (plus two turnovers, the calls in
    flight) takes no further call: the call is relayed (False) and the
    channel polled; a younger oldest call lets the call be pipelined."""
    ch = _StubChannel(ewma=LIMIT_S / 100, ages=[oldest_age, 0.0])
    client = _client(ch, _state(fast=[FN]))
    spec = _spec()
    assert client._submit_task(spec) is pipelined
    assert ch.submitted == ([spec.task_id] if pipelined else [])
    assert ch.polls == (0 if pipelined else 1)


@pytest.mark.parametrize("oldest_age, pipelined", [
    (LIMIT_S * 2.5, True), (LIMIT_S * 8, False)])
def test_deep_train_is_allowed_its_turnover(oldest_age, pipelined):
    """With 64 calls in flight at an EWMA of a tenth of the threshold, the
    oldest may be out for the threshold plus 64 turnovers (the callee
    returns a train's results together), and no longer."""
    ch = _StubChannel(ewma=LIMIT_S / 10, ages=[oldest_age] + [0.0] * 63)
    client = _client(ch, _state(fast=[FN]))
    assert client._submit_task(_spec()) is pipelined


@pytest.mark.parametrize("ewma, pipelined", [
    (None, False), (LIMIT_S * 2, False), (LIMIT_S / 2, True)])
def test_channel_turnover_ewma_gates_pipelining(ewma, pipelined):
    ch = _StubChannel(ewma=ewma, ages=[0.0])
    client = _client(ch, _state(fast=[FN]))
    assert client._submit_task(_spec()) is pipelined


def test_unproven_function_is_relayed_until_its_probe_completes():
    """A function's first direct call is its probe: while it is in flight
    no further call of that function is pipelined, whatever the channel's
    EWMA; once it has left the pending table the function is proven."""
    ch = _StubChannel(ewma=LIMIT_S / 100, ages=[])
    st = _state()
    client = _client(ch, st)
    first = _spec()
    assert client._submit_task(first)          # idle channel: direct
    assert st["probes"] == {FN: first.task_id}
    assert not client._submit_task(_spec())    # probe in flight: relayed
    assert ch.polls == 1
    ch.pending.pop(first.task_id)              # the probe resolved
    ch.pending[TaskID.from_random()] = direct._Pending(_spec(), None)
    next(iter(ch.pending.values())).t_sent = direct.time.time()
    assert client._submit_task(_spec())        # pipelined behind others
    assert st["probes"] == {FN: None}          # proven


def test_other_function_does_not_ride_a_proven_one():
    ch = _StubChannel(ewma=LIMIT_S / 100, ages=[0.0])
    client = _client(ch, _state(fast=[FN]))
    assert not client._submit_task(_spec(FunctionID.from_random()))
    assert client._submit_task(_spec())


def test_kill_switch_keeps_serial_reuse(monkeypatch):
    """RAY_TPU_DIRECT_BURST=0: a busy lease channel never takes a call."""
    monkeypatch.setattr(config, "direct_burst", False)
    ch = _StubChannel(ewma=LIMIT_S / 100, ages=[0.0])
    client = _client(ch, _state(fast=[FN]))
    assert not client._submit_task(_spec())
    assert ch.submitted == [] and ch.polls == 1


@pytest.fixture(scope="module")
def port_cluster():
    import ray_tpu_torch
    from ray_tpu_torch.session_root import new_session_root

    default, config.temp_dir = config.temp_dir, new_session_root()
    try:
        ray_tpu_torch.init(num_cpus=4)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(config.temp_dir, ignore_errors=True)
        config.temp_dir = default


def test_noop_fan_out_is_still_pipelined(port_cluster, monkeypatch):
    """Fan-outs of 200 no-op tasks: some of their submits land on a lease
    channel that already has calls in flight (pipelined), read from the
    channel's pending table at each submit.  The first fan-outs lease the
    worker and prove the function; the later ones pipeline."""
    rt = port_cluster
    depths = []
    submit = direct._Channel.submit

    def spy(self, spec, ctx):
        if isinstance(self.key, tuple):
            depths.append(len(self.pending))  # unguarded-ok: a test's read
        return submit(self, spec, ctx)

    monkeypatch.setattr(direct._Channel, "submit", spy)

    @rt.remote
    def noop(i):
        return i

    for _ in range(4):
        assert rt.get([noop.remote(i) for i in range(200)],
                      timeout=60) == list(range(200))
    pipelined = sum(1 for d in depths if d > 0)
    assert pipelined > 0, f"no submit found the channel busy: {depths[:50]}"
