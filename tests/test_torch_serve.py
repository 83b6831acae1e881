"""ray_tpu_torch.serve.Replica hosting chip_smoke's GPT-2 Generator at
GPT2_TINY on the CPU: requests, streams, backpressure, stats."""

import pickle

import pytest
import torch

from chip_smoke import Generator
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import BackPressureError, RayTpuError
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.serve import Replica, get_multiplexed_model_id

PROMPT = [5, 17, 301, 42, 7]


@pytest.fixture(scope="module")
def replica():
    return Replica(Generator, ("tiny", "cpu", 0), {})


def _greedy(gen, prompt, n):
    tokens = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            logits = gpt2.forward(gen.params, torch.tensor([tokens]), gen.cfg)
            tokens.append(int(logits[0, -1].argmax()))
    return tokens


def test_handle_request_generates_greedy_tokens(replica):
    out = replica.handle_request({"prompt": PROMPT, "max_tokens": 6})
    gen = replica._callable
    assert out["tokens"] == _greedy(gen, PROMPT, 6)
    assert all(0 <= t < gen.cfg.vocab_size for t in out["tokens"])
    assert replica.stats()["ongoing"] == 0


def test_handle_request_stream_yields_each_token(replica):
    items = list(replica.handle_request_stream(
        {"prompt": PROMPT, "max_tokens": 4}, method="stream"))
    assert [i["token"] for i in items] == \
        _greedy(replica._callable, PROMPT, 4)[len(PROMPT):]


def test_sequence_beyond_block_size_raises(replica):
    block = replica._callable.cfg.block_size
    with pytest.raises(ValueError, match="block_size"):
        replica.handle_request({"prompt": [1] * block, "max_tokens": 2})
    assert replica.stats()["ongoing"] == 0


def test_backpressure_rejects_beyond_max_ongoing():
    r = Replica(Generator, ("tiny", "cpu", 0), {}, max_ongoing_requests=1)
    stream = r.handle_request_stream({"prompt": PROMPT, "max_tokens": 3},
                                     method="stream")
    first = next(stream)           # admitted: one request in flight
    assert r.stats()["ongoing"] == 1
    with pytest.raises(BackPressureError) as ei:
        r.handle_request({"prompt": PROMPT, "max_tokens": 1})
    assert isinstance(ei.value, RayTpuError)
    rest = list(stream)
    assert len([first] + rest) == 3
    st = r.stats()
    assert (st["ongoing"], st["total"], st["rejected"],
            st["max_ongoing_requests"]) == (0, 1, 1, 1)
    assert st["uptime_s"] >= 0
    r.handle_request({"prompt": PROMPT, "max_tokens": 1})  # admits again
    assert r.stats()["total"] == 2


def test_backpressure_flag_off_queues(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_BACKPRESSURE", "0")
    config.reload("serve_backpressure")
    try:
        r = Replica(Generator, ("tiny", "cpu", 0), {},
                    max_ongoing_requests=1)
        stream = r.handle_request_stream({"prompt": PROMPT, "max_tokens": 2},
                                         method="stream")
        next(stream)
        r.handle_request({"prompt": PROMPT, "max_tokens": 1})
        list(stream)
        assert r.stats()["rejected"] == 0
    finally:
        monkeypatch.delenv("RAY_TPU_SERVE_BACKPRESSURE")
        config.reload("serve_backpressure")
    assert config.serve_backpressure is True


class _Echo:
    def __init__(self, tag):
        self.tag = tag
        self.cfg = None

    def __call__(self, request):
        return (self.tag, request, get_multiplexed_model_id())

    def reconfigure(self, user_config):
        self.cfg = user_config

    def check_health(self):
        return self.cfg != {"healthy": False}


def test_pickled_definition_user_config_and_health():
    r = Replica(pickle.dumps(_Echo), ("a",), None, user_config={"x": 1})
    assert r._callable.cfg == {"x": 1}
    assert r.handle_request(3, multiplexed_model_id="m1") == ("a", 3, "m1")
    assert get_multiplexed_model_id() == ""  # reset after the request
    assert r.check_health()
    assert r.reconfigure({"healthy": False})
    assert not r.check_health()
    fn = Replica(lambda req: req * 2)
    assert fn.handle_request(21) == 42
    assert fn.get_queue_len() == 0


# ---------------------------------------------------------------------------
# the port's Replica against the JAX package's, on the same sequence of calls
# ---------------------------------------------------------------------------

class _Det:
    """A deterministic deployment: every answer is a function of the
    request, the init tag, the user config and the current model id."""

    def __init__(self, tag, package):
        self.tag = tag
        self.model_id = _Side.model_ids[package]
        self.cfg = None

    def __call__(self, request):
        return (self.tag, request, self.cfg, self.model_id())

    def double(self, request):
        return 2 * request

    def fail(self, request):
        raise ValueError(f"bad request {request}")

    def stream(self, n):
        for i in range(n):
            yield (self.tag, i, self.model_id())

    def reconfigure(self, user_config):
        self.cfg = user_config

    def check_health(self):
        return self.cfg != {"healthy": False}


def _count(n):
    return iter(range(n))


class _Side:
    """One package's Replica, model-id getter and config registry."""

    model_ids = {"torch": get_multiplexed_model_id}

    def __init__(self, package):
        if package == "jax":
            import cloudpickle

            from ray_tpu.core.config import config as cfg
            from ray_tpu.serve.multiplex import get_multiplexed_model_id as mid
            from ray_tpu.serve.replica import Replica as cls
            self.dumps = cloudpickle.dumps
            _Side.model_ids["jax"] = mid
        else:
            cfg, mid, cls = config, get_multiplexed_model_id, Replica
            self.dumps = pickle.dumps
        self.package = package
        self.config, self.model_id, self.cls = cfg, mid, cls

    def replica(self, d, init_args=(), init_kwargs=None, **kw):
        return self.cls(self.dumps(d), init_args, init_kwargs, **kw)


def _call(log, fn, *args, **kwargs):
    """Append fn's result, or the exception's class chain and message."""
    try:
        out = fn(*args, **kwargs)
        if hasattr(out, "__next__"):
            out = list(out)
        log.append(("ok", out))
    except Exception as e:  # noqa: BLE001 - the exception is the record
        log.append(("raise", [c.__name__ for c in type(e).__mro__],
                    str(e)))


def _stats(log, r):
    st = r.stats()
    assert st.pop("uptime_s") >= 0
    log.append(("stats", st, r.get_queue_len()))


def _requests(side, log):
    r = side.replica(_Det, ("a", side.package), {})
    _call(log, r.handle_request, 3)
    _call(log, r.handle_request, 4, multiplexed_model_id="m1")
    log.append(("model_id_after", side.model_id()))
    _call(log, r.handle_request, 5, method="double")
    _call(log, r.handle_request, 6, method="fail")
    _call(log, r.handle_request, 7, method="missing")
    _stats(log, r)


def _streams(side, log):
    r = side.replica(_Det, ("s", side.package), None)
    _call(log, r.handle_request_stream, 3, method="stream",
          multiplexed_model_id="m2")
    log.append(("model_id_after", side.model_id()))
    s = r.handle_request_stream(5, method="stream")
    log.append(("first", next(s)))
    _stats(log, r)
    s.close()                   # a stream closed early releases its slot
    _stats(log, r)
    _call(log, r.handle_request_stream, 2, method="fail")
    _stats(log, r)


def _backpressure(side, log):
    r = side.replica(_Det, ("b", side.package), None,
                     max_ongoing_requests=1)
    s = r.handle_request_stream(3, method="stream")
    log.append(("first", next(s)))
    _stats(log, r)
    _call(log, r.handle_request, 1)
    _call(log, r.handle_request_stream, 1, method="stream")
    log.append(("rest", list(s)))
    _stats(log, r)
    _call(log, r.handle_request, 2)
    _stats(log, r)


def _backpressure_off(side, log, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_BACKPRESSURE", "0")
    side.config.reload("serve_backpressure")
    try:
        log.append(("flag", side.config.serve_backpressure))
        r = side.replica(_Det, ("q", side.package), None,
                         max_ongoing_requests=1)
        s = r.handle_request_stream(2, method="stream")
        next(s)
        _call(log, r.handle_request, 1)
        s.close()
        _stats(log, r)
    finally:
        monkeypatch.delenv("RAY_TPU_SERVE_BACKPRESSURE")
        side.config.reload("serve_backpressure")
    log.append(("flag", side.config.serve_backpressure))


def _user_config(side, log):
    r = side.replica(_Det, ("u", side.package), None, user_config={"x": 1})
    _call(log, r.handle_request, 1)
    log.append(("health", r.check_health()))
    log.append(("reconfigure", r.reconfigure({"healthy": False})))
    log.append(("health", r.check_health()))
    _call(log, r.handle_request, 2)
    log.append(("reconfigure", r.reconfigure({"x": 2})))
    log.append(("health", r.check_health()))
    _stats(log, r)


def _function(side, log):
    r = side.replica(_count, (), None)
    _call(log, r.handle_request, 3)
    _call(log, r.handle_request_stream, 3)
    _call(log, r.handle_request, 3, method="double")
    log.append(("reconfigure", r.reconfigure({"x": 1})))
    log.append(("health", r.check_health()))
    _stats(log, r)


@pytest.mark.parametrize("scenario", [
    _requests, _streams, _backpressure, _backpressure_off, _user_config,
    _function], ids=lambda f: f.__name__.strip("_"))
def test_replica_matches_jax_replica(scenario, monkeypatch):
    """Results, exception classes and messages, and stats() other than
    uptime_s are equal, call for call, to the JAX package's Replica."""
    logs = {}
    for package in ("jax", "torch"):
        logs[package] = []
        args = (monkeypatch,) if scenario is _backpressure_off else ()
        scenario(_Side(package), logs[package], *args)
    assert logs["torch"] == logs["jax"]
    assert logs["torch"]   # the scenario recorded something
