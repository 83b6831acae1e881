"""ray_tpu_torch.serve.Replica hosting chip_smoke's GPT-2 Generator at
GPT2_TINY on the CPU: requests, streams, backpressure, stats.  A replica
takes its deployment as the vendored cloudpickle's bytes and positional
``init_args, init_kwargs``, as the JAX package's does."""

import pytest
import torch

from chip_smoke import Generator
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import BackPressureError, RayTpuError
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.serve import get_multiplexed_model_id
from ray_tpu_torch.serve.replica import Replica

PROMPT = [5, 17, 301, 42, 7]


@pytest.fixture(scope="module")
def replica():
    return Replica(cloudpickle.dumps(Generator), ("tiny", "cpu", 0), {})


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
    r = Replica(cloudpickle.dumps(Generator), ("tiny", "cpu", 0), {},
                max_ongoing_requests=1)
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
        r = Replica(cloudpickle.dumps(Generator), ("tiny", "cpu", 0), {},
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
    r = Replica(cloudpickle.dumps(_Echo), ("a",), None, user_config={"x": 1})
    assert r._callable.cfg == {"x": 1}
    assert r.handle_request(3, multiplexed_model_id="m1") == ("a", 3, "m1")
    assert get_multiplexed_model_id() == ""  # reset after the request
    assert r.check_health()
    assert r.reconfigure({"healthy": False})
    assert not r.check_health()
    fn = Replica(cloudpickle.dumps(lambda req: req * 2), (), None)
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
            import cloudpickle as installed

            from ray_tpu.core.config import config as cfg
            from ray_tpu.serve.multiplex import get_multiplexed_model_id as mid
            from ray_tpu.serve.replica import Replica as cls
            self.dumps = installed.dumps
            _Side.model_ids["jax"] = mid
        else:
            cfg, mid, cls = config, get_multiplexed_model_id, Replica
            self.dumps = cloudpickle.dumps
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


# ---------------------------------------------------------------------------
# the Llama deployment, @multiplexed and @batch against the JAX package
# ---------------------------------------------------------------------------

def test_llama_server_returns_jax_generate_tokens():
    """chip_smoke's LlamaServer in the port's Replica (LLAMA_TINY on the
    CPU, the JAX parameters in f32) returns the greedy tokens of the JAX
    ``generate``, as the deployment of tests/test_serve.py serves them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import LlamaServer
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl

    jcfg = jl.LlamaConfig(**{**jl.LLAMA_TINY.__dict__,
                             "compute_dtype": jnp.float32})
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    r = Replica(cloudpickle.dumps(LlamaServer), ("tiny", "cpu", 0), {})
    srv = r._callable
    assert srv.cfg == tl.LLAMA_TINY
    srv.cfg = tl.LlamaConfig(**{**jcfg.__dict__,
                                "compute_dtype": torch.float32})
    srv.params = tl.serving_params(tl.params_from_numpy(
        jax.tree.map(np.asarray, jparams), srv.cfg, device="cpu"), srv.cfg)
    for prompt in ([1, 2, 3], [7, 30, 200, 5, 91, 17]):
        want = jl.generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                           max_new_tokens=4)
        out = r.handle_request({"prompt_tokens": prompt,
                                "max_new_tokens": 4})
        assert out["tokens"] == [int(t) for t in np.asarray(want)[0]]
    req = {"prompt_tokens": [1, 2, 3], "max_new_tokens": 6,
           "temperature": 0.8, "seed": 3}
    a, b = r.handle_request(req), r.handle_request(req)
    assert a == b and a["tokens"][:3] == [1, 2, 3] and len(a["tokens"]) == 9
    assert r.stats()["total"] == 4


class _Model:
    """A loaded model that records its unload in its replica's log."""

    def __init__(self, model_id, log):
        self.model_id, self.log = model_id, log

    def unload(self):
        self.log.append(("unload", self.model_id))
        if self.model_id.startswith("bad"):
            raise RuntimeError("unload failed")


class _Plain:
    """A loaded model without ``unload``."""

    def __init__(self, model_id):
        self.model_id = model_id


def _mux_deployment(multiplexed):
    class Mux:
        def __init__(self):
            self.log = []

        @multiplexed(max_num_models_per_replica=2)
        def load(self, model_id):
            self.log.append(("load", model_id))
            if model_id.startswith("plain"):
                return _Plain(model_id)
            return _Model(model_id, self.log)

        @multiplexed(max_num_models_per_replica=1)
        def load_other(self, model_id):
            self.log.append(("load_other", model_id))
            return _Plain(model_id)

        def __call__(self, request):
            return (self.load().model_id, request)

        def explicit(self, model_id):
            return self.load(model_id).model_id

        def other(self, request):
            return self.load_other().model_id

        def events(self, _):
            return list(self.log)

    return Mux


def _mux_side(package):
    if package == "jax":
        import cloudpickle as installed

        from ray_tpu.serve.multiplex import multiplexed as mux
        from ray_tpu.serve.replica import Replica as cls
        return mux, lambda d: cls(installed.dumps(d), (), None)
    from ray_tpu_torch.serve import multiplexed as mux
    return mux, lambda d: Replica(cloudpickle.dumps(d), (), None)


def _mux_calls(package):
    mux, make = _mux_side(package)
    r = make(_mux_deployment(mux))
    log = []
    for mid, req in (("a", 1), ("b", 2), ("a", 3), ("c", 4), ("b", 5),
                     ("plain1", 6), ("bad1", 7), ("d", 8), ("e", 9)):
        _call(log, r.handle_request, req, multiplexed_model_id=mid)
        log.append(("ids", r.multiplexed_model_ids()))
    _call(log, r.handle_request, 10)               # no model id
    _call(log, r.handle_request, "f", method="explicit")
    _call(log, r.handle_request, 0, method="other",
          multiplexed_model_id="o1")
    _call(log, r.handle_request, 0, method="other",
          multiplexed_model_id="o2")
    log.append(("ids", sorted(r.multiplexed_model_ids())))
    _call(log, r.handle_request, None, method="events")
    _call(log, mux, 0)
    plain = make(_count)  # no multiplexed method
    log.append(("ids", plain.multiplexed_model_ids()))
    return log


def test_multiplexed_matches_jax():
    """@multiplexed loads, LRU eviction with ``unload()`` (an unload that
    raises is swallowed), the current request's id, the error without
    one, two loaders with their own caches, and
    ``Replica.multiplexed_model_ids``: equal, call for call, to the JAX
    package's modules."""
    logs = {p: _mux_calls(p) for p in ("jax", "torch")}
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][6:8] == [("ok", ("c", 4)), ("ids", ["a", "c"])]
    assert logs["torch"][-3][1][:4] == [("load", "a"), ("load", "b"),
                                        ("load", "c"), ("unload", "b")]


def _batch_deployment(batch, batch_sizes_of, max_batch_size, wait_s):
    class Batched:
        @batch(max_batch_size=max_batch_size, batch_wait_timeout_s=wait_s)
        def __call__(self, requests):
            if "boom" in requests:
                raise ValueError(f"boom in a batch of {len(requests)}")
            if "short" in requests:
                return requests[:-1]
            return [(r, len(requests)) for r in requests]

        def sizes(self, _):
            return batch_sizes_of(type(self).__call__)

    return Batched


def _batch_side(package):
    if package == "jax":
        import cloudpickle as installed

        from ray_tpu.serve.batching import batch as b, batch_sizes_of as s
        from ray_tpu.serve.replica import Replica as cls
        return b, s, lambda d: cls(installed.dumps(d), (), None)
    from ray_tpu_torch.serve import batch as b, batch_sizes_of as s
    return b, s, lambda d: Replica(cloudpickle.dumps(d), (), None)


def _feed(r, requests, timeout=30):
    """Send each request from its own thread, all released at once;
    returns each caller's result (or its exception) in request order."""
    import threading

    out = [None] * len(requests)
    gate = threading.Barrier(len(requests))

    def caller(i):
        gate.wait()
        try:
            out[i] = ("ok", r.handle_request(requests[i]))
        except Exception as e:  # noqa: BLE001 - the exception is the record
            out[i] = ("raise", type(e).__name__, str(e))

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    return out


def _batch_calls(package):
    batch, sizes_of, make = _batch_side(package)
    log = []
    # 10 callers released together into batches of at most 4 that wait
    # up to 1 s to fill: 4, 4, 2
    # (which caller lands in which batch is the threads' order: the log
    # keeps each caller's own request and the sizes its callers saw)
    r = make(_batch_deployment(batch, sizes_of, 4, 1.0))
    feed = _feed(r, list(range(10)))
    log.append(("feed", [res[1][0] for res in feed],
                sorted(res[1][1] for res in feed)))
    sizes = r.handle_request(None, method="sizes")
    log.append(("sizes", sizes))
    assert max(sizes) <= 4 and sum(sizes) == 10
    # 4 callers, one of them "boom": the batch's error reaches all four
    r = make(_batch_deployment(batch, sizes_of, 4, 1.0))
    log.append(("feed", _feed(r, [0, "boom", 2, 3])))
    # single callers, short wait: a batch that raises, one that returns
    # too few results, and a plain function
    r = make(_batch_deployment(batch, sizes_of, 4, 0.01))
    for req in ("boom", "short", "x"):
        _call(log, r.handle_request, req)
    log.append(("sizes", r.handle_request(None, method="sizes")))

    @batch(max_batch_size=2, batch_wait_timeout_s=0.01)
    def double(requests):
        return [2 * x for x in requests]

    log.append(("plain", double(21), sizes_of(double),
                double._batch_config))
    log.append(("unknown", sizes_of(lambda: None)))
    return log


def test_batch_matches_jax():
    """@batch: each caller gets its own request's result, batches hold at
    most max_batch_size, ``batch_sizes_of`` reports them, and errors reach
    every caller of the batch: equal to the JAX package's module on the
    same concurrent feed."""
    logs = {p: _batch_calls(p) for p in ("jax", "torch")}
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][0] == ("feed", list(range(10)), [2] * 2 + [4] * 8)
    assert logs["torch"][1] == ("sizes", [4, 4, 2])
    assert logs["torch"][2] == ("feed", [(
        "raise", "ValueError", "boom in a batch of 4")] * 4)
