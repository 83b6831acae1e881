"""The port's counterparts of ``tests/test_serve.py``: ``ray_tpu_torch.serve``
— deployments, handles, HTTP ingress, autoscaling — in its order and with
its assertions, on one port cluster for the module (8 CPUs, under a
session root of its own), and a CPU replica kept off the card.

Reference test analogues: `python/ray/serve/tests/test_standalone.py`
(deploy/call/delete), `test_autoscaling_policy.py` (scale up under load),
`test_proxy.py` (HTTP routing).  The Llama case serves the port's
``LLAMA_TINY`` on parameters carried over from the JAX package's, and holds
its tokens to the JAX ``generate``.  The deployments are defined inside the
tests and ship by value through the vendored cloudpickle; the YAML case's
import target, ``app``, is defined here and ships by reference.  The module
ends with the port's leak audit.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import pytest
from test_torch_runtime_parity import assert_port_left_nothing

import ray_tpu_torch as rt
from ray_tpu_torch import serve


@serve.deployment(num_replicas=1)
class Echo:
    def __call__(self, request):
        return {"echo": request}


app = Echo.bind()


@pytest.fixture(scope="module")
def served():
    from ray_tpu_torch.session_root import new_session_root

    default, rt.config.temp_dir = rt.config.temp_dir, new_session_root()
    try:
        rt.init(num_cpus=8)
        serve.start()
        yield rt
        serve.shutdown()
        rt.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(rt.config.temp_dir, ignore_errors=True)
        rt.config.temp_dir = default


def _http(path, body=None, port=None):
    port = port or serve.http_port()
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_function_deployment_handle(served):
    @serve.deployment
    def echo(req):
        return {"echo": req}

    h = serve.run(echo.bind(), route_prefix="/echo")
    out = rt.get(h.remote({"x": 1}), timeout=30)
    assert out == {"echo": {"x": 1}}
    serve.delete("echo")


def test_class_deployment_http_and_methods(served):
    @serve.deployment(name="adder")
    class Adder:
        def __init__(self, base):
            self.base = base

        def __call__(self, req):
            return {"sum": self.base + req["v"]}

        def peek(self, req):
            return {"base": self.base}

    h = serve.run(Adder.bind(10), route_prefix="/adder")
    assert rt.get(h.remote({"v": 5}), timeout=30) == {"sum": 15}
    # method routing
    assert rt.get(h.method.peek.remote(None), timeout=30) == {"base": 10}
    # HTTP ingress
    code, out = _http("/adder", {"v": 32})
    assert code == 200 and out == {"sum": 42}
    code, routes = _http("/-/routes")
    assert routes.get("/adder") == "adder"
    serve.delete("adder")


def test_http_404_and_healthz(served):
    code, _ = _http("/-/healthz")
    assert code == 200
    try:
        code, _ = _http("/nonexistent-route-xyz", {"a": 1})
    except urllib.error.HTTPError as e:
        code = e.code
    assert code in (404, 500)


def test_composition_nested_bind(served):
    @serve.deployment(name="tokenizer")
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment(name="pipeline")
    class Pipeline:
        def __init__(self, tok_handle):
            self.tok = tok_handle

        def __call__(self, req):
            toks = rt.get(self.tok.remote(req["text"]), timeout=30)
            return {"n_tokens": len(toks)}

    h = serve.run(Pipeline.bind(Tokenizer.bind()), route_prefix="/pipe")
    out = rt.get(h.remote({"text": "a b c d"}), timeout=60)
    assert out == {"n_tokens": 4}
    serve.delete("pipeline")
    serve.delete("tokenizer")


def test_multiple_replicas_share_load(served):
    @serve.deployment(name="slowid", num_replicas=2)
    class SlowId:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, req):
            time.sleep(0.3)
            return self.pid

    h = serve.run(SlowId.bind(), route_prefix="/slowid")
    t0 = time.perf_counter()
    refs = [h.remote(None) for _ in range(4)]
    pids = set(rt.get(refs, timeout=60))
    dt = time.perf_counter() - t0
    assert len(pids) == 2, "requests did not spread over both replicas"
    assert dt < 4 * 0.3, f"replicas did not serve concurrently: {dt:.2f}s"
    serve.delete("slowid")


def test_autoscaling_up_and_down(served):
    @serve.deployment(
        name="burst", num_replicas=1,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
            upscale_delay_s=0.0, downscale_delay_s=1.0,
            smoothing_factor=1.0))
    class Burst:
        def __call__(self, req):
            time.sleep(0.4)
            return "done"

    serve.run(Burst.bind(), route_prefix="/burst")
    assert serve.status()["burst"]["running"] == 1

    stop = threading.Event()

    def flood():
        h = serve.get_deployment_handle("burst")
        while not stop.is_set():
            try:
                refs = [h.remote(None) for _ in range(4)]
                rt.get(refs, timeout=30)
            except Exception:
                return

    threads = [threading.Thread(target=flood, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 30
        scaled_up = False
        while time.time() < deadline:
            if serve.status()["burst"]["running"] >= 2:
                scaled_up = True
                break
            time.sleep(0.3)
        assert scaled_up, f"never scaled up: {serve.status()}"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    # idle -> back toward min after downscale_delay
    deadline = time.time() + 30
    scaled_down = False
    while time.time() < deadline:
        if serve.status()["burst"]["target"] == 1:
            scaled_down = True
            break
        time.sleep(0.3)
    assert scaled_down, f"never scaled down: {serve.status()}"
    serve.delete("burst")


def test_redeploy_in_place(served):
    @serve.deployment(name="ver")
    def v1(req):
        return 1

    @serve.deployment(name="ver")
    def v2(req):
        return 2

    h = serve.run(v1.bind(), route_prefix="/ver")
    assert rt.get(h.remote(None), timeout=30) == 1
    h = serve.run(v2.bind(), route_prefix="/ver")
    assert rt.get(h.remote(None), timeout=30) == 2
    serve.delete("ver")


def test_llama_generate_deployment(served):
    """The serving flagship: tiny-llama generate behind serve
    (BASELINE.json 'Ray Serve Llama-2-7B JAX inference deployment' shape,
    tiny config on CPU).  The port's ``LLAMA_TINY`` in f32 on parameters
    carried over from the JAX package's by ``llama.params_from_numpy``:
    the tokens served over HTTP are ``ray_tpu.models.llama.generate``'s
    at temperature 0."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tpu.models import llama as jl

    jcfg = jl.LlamaConfig(**{**jl.LLAMA_TINY.__dict__,
                             "compute_dtype": jnp.float32})
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    host_params = jax.tree.map(np.asarray, jparams)

    @serve.deployment(name="llama")
    class LlamaServer:
        def __init__(self, numpy_params):
            import torch

            from ray_tpu_torch.models import llama

            self.cfg = llama.LlamaConfig(**{**llama.LLAMA_TINY.__dict__,
                                            "compute_dtype": torch.float32})
            self.params = llama.serving_params(llama.params_from_numpy(
                numpy_params, self.cfg, device="cpu"), self.cfg)
            self.llama = llama

        def __call__(self, req):
            import torch

            prompt = torch.tensor([req["prompt_tokens"]], dtype=torch.long)
            toks = self.llama.generate(
                self.params, prompt, self.cfg,
                max_new_tokens=int(req.get("max_new_tokens", 4)),
                temperature=0.0)
            return {"tokens": [int(t) for t in toks[0]]}

    h = serve.run(LlamaServer.bind(host_params), route_prefix="/llama")
    code, out = _http("/llama", {"prompt_tokens": [1, 2, 3],
                                 "max_new_tokens": 4})
    assert code == 200
    assert len(out["tokens"]) >= 4
    want = jl.generate(jparams, jnp.asarray([[1, 2, 3]], jnp.int32), jcfg,
                       max_new_tokens=4, temperature=0.0)
    assert out["tokens"] == [int(t) for t in np.asarray(want)[0]]
    prompt = [7, 30, 200, 5, 91, 17]
    want = jl.generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                       max_new_tokens=4, temperature=0.0)
    got = rt.get(h.remote({"prompt_tokens": prompt, "max_new_tokens": 4}),
                 timeout=60)
    assert got["tokens"] == [int(t) for t in np.asarray(want)[0]]
    serve.delete("llama")


def test_failing_constructor_surfaces_error(served):
    @serve.deployment(name="broken")
    class Broken:
        def __init__(self):
            raise RuntimeError("boom at init")

        def __call__(self, req):
            return "unreachable"

    with pytest.raises((RuntimeError, TimeoutError)):
        serve.run(Broken.bind(), route_prefix="/broken", timeout=30)
    st = serve.status().get("broken", {})
    assert st.get("unhealthy"), f"deployment not marked unhealthy: {st}"
    serve.delete("broken")


def test_dead_replica_is_replaced(served):
    @serve.deployment(name="fragile")
    class Fragile:
        def __call__(self, req):
            if req == "die":
                import os

                os._exit(1)
            return "alive"

    h = serve.run(Fragile.bind(), route_prefix="/fragile")
    assert rt.get(h.remote("ok"), timeout=30) == "alive"
    try:
        rt.get(h.remote("die"), timeout=30)
    except Exception:
        pass
    # controller must detect the death and respawn a replacement
    deadline = time.time() + 30
    recovered = False
    while time.time() < deadline:
        try:
            if rt.get(h.remote("ok"), timeout=10) == "alive":
                recovered = True
                break
        except Exception:
            time.sleep(0.3)
    assert recovered, f"replica never replaced: {serve.status()}"
    serve.delete("fragile")


def test_longpoll_no_staleness_after_redeploy(served):
    """Redeploy must switch handle traffic with no staleness window: once a
    v2 response is seen, no later response may be v1, and no request may
    error (reference: long-poll config push, `_private/long_poll.py:187`)."""

    def make(version):
        @serve.deployment(name="lp")
        class V:
            def __call__(self, req):
                return {"version": version}

        return V

    h = serve.run(make(1).bind(), route_prefix="/lp")
    assert rt.get(h.remote({}), timeout=30)["version"] == 1

    errors = []
    versions = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                versions.append(
                    rt.get(h.remote({}), timeout=30)["version"])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    time.sleep(0.3)
    serve.run(make(2).bind(), route_prefix="/lp")  # in-place redeploy
    deadline = time.time() + 15
    while time.time() < deadline and (not versions or versions[-1] != 2):
        time.sleep(0.1)
    time.sleep(0.5)  # a few more requests at v2
    stop.set()
    t.join(timeout=10)
    assert not errors, errors[:3]
    assert 2 in versions
    first_v2 = versions.index(2)
    assert all(v == 2 for v in versions[first_v2:]), \
        f"stale v1 after v2 at {first_v2}: {versions[first_v2:first_v2+20]}"
    serve.delete("lp")


def test_serve_batch_groups_requests(served):
    """@serve.batch groups concurrent requests (>1 per batch under load)."""

    @serve.deployment(name="batched", max_ongoing_requests=32)
    class Batched:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def __call__(self, reqs):
            return [{"n": len(reqs), "v": r["v"] * 2} for r in reqs]

        def batch_stats(self, _req):
            return serve.batch_sizes_of(type(self).__call__)

    h = serve.run(Batched.bind(), route_prefix="/batched")
    refs = [h.remote({"v": i}) for i in range(16)]
    outs = rt.get(refs, timeout=60)
    assert [o["v"] for o in outs] == [i * 2 for i in range(16)]
    sizes = rt.get(h.options(method_name="batch_stats").remote({}),
                        timeout=30)
    assert max(sizes) > 1, sizes  # grouping actually happened
    assert sum(sizes) >= 16
    serve.delete("batched")


def test_http_streaming_response(served):
    """?stream=1 returns chunked NDJSON, items flushed as produced."""

    @serve.deployment(name="streamer")
    class Streamer:
        def __call__(self, req):
            for i in range((req or {}).get("n", 3)):
                time.sleep(0.15)
                yield {"i": i}

    serve.run(Streamer.bind(), route_prefix="/streamer")
    port = serve.http_port()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/streamer?stream=1",
        data=json.dumps({"n": 4}).encode(), method="POST")
    req.add_header("Content-Type", "application/json")
    t0 = time.perf_counter()
    arrivals = []
    items = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        for line in resp:
            items.append(json.loads(line))
            arrivals.append(time.perf_counter() - t0)
    assert items == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]
    # first item must arrive before the full 0.6s production time
    assert arrivals[0] < arrivals[-1] - 0.2, arrivals
    serve.delete("streamer")


def test_handle_streaming(served):
    @serve.deployment(name="hstream")
    def gen(req):
        for i in range(req["n"]):
            yield i * 10

    h = serve.run(gen.bind(), route_prefix="/hstream")
    vals = [rt.get(r, timeout=30)
            for r in h.options(stream=True).remote({"n": 3})]
    assert vals == [0, 10, 20]
    serve.delete("hstream")


class TestMultiplexing:
    """Model multiplexing (reference: `python/ray/serve/multiplex.py`):
    @serve.multiplexed LRU loading, per-request model id, replica
    affinity."""

    def test_multiplexed_lru_and_model_id(self, served):
        @serve.deployment(num_replicas=1)
        class MultiModel:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return {"id": model_id, "scale": float(len(model_id))}

            def __call__(self, request):
                model = self.get_model()
                return {"model": model["id"],
                        "y": model["scale"] * (request or {}).get("x", 1)}

        serve.run(MultiModel.bind(), name="mux", route_prefix="/mux")
        port = serve.http_port()

        def post(model_id, x):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/mux",
                data=json.dumps({"x": x}).encode(),
                headers={"serve_multiplexed_model_id": model_id,
                         "Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        assert post("aa", 3) == {"model": "aa", "y": 6.0}
        assert post("bbb", 2) == {"model": "bbb", "y": 6.0}
        assert post("aa", 1) == {"model": "aa", "y": 2.0}  # cache hit
        assert post("cccc", 1)["model"] == "cccc"  # evicts LRU ("bbb")
        handle = serve.get_deployment_handle("MultiModel")
        replica = handle._pick_replica()
        ids = rt.get(replica.multiplexed_model_ids.remote(), timeout=30)
        # capacity 2: "bbb" was least-recently-used and evicted
        assert sorted(ids) == ["aa", "cccc"]
        serve.delete("mux")

    def test_handle_options_model_id_affinity(self, served):
        @serve.deployment(num_replicas=2)
        class M:
            @serve.multiplexed(max_num_models_per_replica=1)
            def load(self, model_id: str):
                import os

                return {"pid": os.getpid(), "id": model_id}

            def __call__(self, request):
                m = self.load()
                return {"pid": m["pid"], "model": m["id"]}

        serve.run(M.bind(), name="mux2", route_prefix="/mux2")
        handle = serve.get_deployment_handle("M")
        h = handle.options(multiplexed_model_id="modelA")
        first = rt.get(h.remote({}), timeout=60)
        assert first["model"] == "modelA"
        # affinity: repeat requests for the same model hit the SAME replica
        pids = {rt.get(h.remote({}), timeout=60)["pid"]
                for _ in range(6)}
        assert pids == {first["pid"]}
        # get_multiplexed_model_id() outside a request context is empty
        assert serve.get_multiplexed_model_id() == ""
        serve.delete("mux2")


def test_run_config_yaml(served, tmp_path):
    """Declarative YAML deploy (reference: `serve deploy` +
    `python/ray/serve/schema.py`).  The import target is this module's
    ``app``, the port's counterpart of ``serve_assets/yaml_app.py``."""
    cfg = tmp_path / "app.yaml"
    cfg.write_text(
        "applications:\n"
        "  - name: yamlapp\n"
        "    route_prefix: /yaml\n"
        "    import_path: test_torch_serve_runtime:app\n")
    serve.run_config(str(cfg))
    status, body = _http("/yaml", {"x": 1})
    assert status == 200 and body == {"echo": {"x": 1}}
    serve.delete("yamlapp")


def test_cpu_replica_sees_no_card(served):
    """A replica asked for no chip runs in a worker kept off the card
    (``CUDA_VISIBLE_DEVICES=""``): torch in it sees no CUDA device."""

    @serve.deployment(name="cardless")
    class Cardless:
        def __call__(self, req):
            import os

            import torch

            return {"cuda": torch.cuda.is_available(),
                    "devices": torch.cuda.device_count(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    h = serve.run(Cardless.bind(), route_prefix="/cardless")
    assert rt.get(h.remote(None), timeout=60) == {
        "cuda": False, "devices": 0, "visible": ""}
    serve.delete("cardless")


def test_chip_deployment_waits_without_a_card(served):
    """A replica that asks for the chip (``num_tpus``, the key ``"TPU"``)
    does not fall back to the CPU on a cluster without one: the deployment
    waits, and ``serve.run`` times out with nothing running."""
    assert served.cluster_resources().get("TPU", 0.0) == 0.0

    @serve.deployment(name="oncard", ray_actor_options={"num_tpus": 1})
    def oncard(req):
        return "ran"

    with pytest.raises(TimeoutError):
        serve.run(oncard.bind(), route_prefix="/oncard", timeout=3)
    st = serve.status()["oncard"]
    assert st["running"] == 0 and st["target"] == 1, st
    serve.delete("oncard")
    assert "oncard" not in serve.status()


def test_nothing_left_after_shutdown(served):
    """Last: ``serve.shutdown()`` and the runtime's ``shutdown()`` leave
    no port process and no ``rtt_store_`` segment of this driver."""
    serve.shutdown()
    served.shutdown()
    assert_port_left_nothing([os.getpid()])
