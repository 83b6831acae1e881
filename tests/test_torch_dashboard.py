"""The port's counterparts of ``tests/test_dashboard.py``'s 8 cases (the
dashboard's HTTP API, the user metrics API and the Prometheus export), on
one port ``Cluster`` for the module under a session root of its own, held
to the port's leak audit after it shuts down.

``ray_tpu_torch/dashboard/`` is a copy of the reference's (hunk (a) alone,
``tests/test_torch_runtime_copy.py``).  The module's head declares one chip
besides the reference's 3 CPUs, and ``/api/cluster_resources`` counts it
under the key ``"TPU"``, one card a unit, as the port's runtime does (f).
The Prometheus series keep the reference's names (``ray_tpu_nodes_alive``,
``ray_tpu_internal_*``): a name that begins with ``ray_tpu_`` is not the
package's name, and the rename leaves it.
"""

import json
import time
import urllib.request

import pytest
from test_torch_cluster import port_cluster

import ray_tpu_torch
from ray_tpu_torch.dashboard import DashboardHead
from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram,
                                        flush_metrics)


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(initialize_head=True,
                      head_resources={"num_cpus": 3, "num_tpus": 1}) as c:
        c.wait_for_nodes(1)
        c.connect()
        yield c


@pytest.fixture(scope="module")
def dashboard(cluster):
    d = DashboardHead(cluster.address)
    yield d
    d.shutdown()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def test_api_nodes_and_resources(cluster, dashboard):
    nodes = json.loads(_get(dashboard.url + "/api/nodes"))
    assert len([n for n in nodes if n["alive"]]) == 1
    res = json.loads(_get(dashboard.url + "/api/cluster_resources"))
    assert res["total"]["CPU"] == 3.0
    assert res["total"]["TPU"] == 1.0


def test_api_actors_lists_named_actor(cluster, dashboard):
    @ray_tpu_torch.remote
    class Marker:
        def ping(self):
            return "pong"

    a = Marker.options(name="dashboard_marker").remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    actors = json.loads(_get(dashboard.url + "/api/actors"))
    assert any(x.get("name") == "dashboard_marker" for x in actors)
    ray_tpu_torch.kill(a)


def test_api_jobs_visible(cluster, dashboard):
    import sys

    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(cluster.address)
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('dash')\"",
        submission_id="job-dash")
    client.wait_until_finished(job_id, timeout=60)
    jobs = json.loads(_get(dashboard.url + "/api/jobs"))
    assert any(j["submission_id"] == "job-dash" for j in jobs)


def test_index_page_renders(cluster, dashboard):
    html = _get(dashboard.url + "/")
    assert "ray_tpu_torch" in html and "nodes" in html


def test_load_metrics_endpoint(cluster, dashboard):
    load = json.loads(_get(dashboard.url + "/api/load"))
    assert load and "resources_total" in load[0]


def test_user_metrics_prometheus_roundtrip(cluster, dashboard):
    c = Counter("test_requests_total", "requests", tag_keys=("route",))
    c.inc(3, tags={"route": "/a"})
    c.inc(2, tags={"route": "/b"})
    g = Gauge("test_queue_depth", "depth")
    g.set(7)
    h = Histogram("test_latency_s", "latency",
                  boundaries=[0.1, 1.0], tag_keys=())
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    flush_metrics()
    deadline = time.monotonic() + 10
    text = ""
    while time.monotonic() < deadline:
        text = _get(dashboard.url + "/metrics")
        if "test_requests_total" in text:
            break
        flush_metrics()
        time.sleep(0.2)
    assert 'test_requests_total{route="/a"} 3' in text
    assert 'test_requests_total{route="/b"} 2' in text
    assert "test_queue_depth 7" in text
    assert 'test_latency_s_bucket{le="0.1"} 1' in text
    assert 'test_latency_s_bucket{le="1.0"} 2' in text
    assert 'test_latency_s_bucket{le="+Inf"} 3' in text
    assert "test_latency_s_count 3" in text
    # system gauges present too
    assert "ray_tpu_nodes_alive 1" in text


def test_metrics_tag_validation():
    c = Counter("test_tags", tag_keys=("a",))
    with pytest.raises(ValueError):
        c.inc(1, tags={"b": "x"})
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        Histogram("test_bad_bounds", boundaries=[-1.0])


def test_job_logs_endpoint(cluster, dashboard):
    import sys

    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(cluster.address)
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('dash-log-marker')\"",
        submission_id="job-dashlogs")
    client.wait_until_finished(job_id, timeout=60)
    text = _get(dashboard.url + "/api/jobs/job-dashlogs/logs")
    assert "dash-log-marker" in text
    # unknown job -> 404
    import urllib.error

    with pytest.raises(urllib.error.HTTPError):
        _get(dashboard.url + "/api/jobs/nosuch/logs")
