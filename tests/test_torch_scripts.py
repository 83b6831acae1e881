"""The port's CLI, ``python -m ray_tpu_torch.scripts`` (a copy of
``ray_tpu/scripts.py``, hunk (a) alone), against a two-node port
``Cluster`` for the module under a session root of its own, held to the
port's leak audit after it shuts down.

The counterparts of the reference's CLI cases: ``logs`` list and tail
(``tests/test_logs.py``'s ``test_logs_cli_list_and_tail``, slow there and
here) and ``stack <actor-prefix>`` on a busy remote actor
(``tests/test_profiling.py``'s ``test_remote_actor_stack_dump``), each run
with ``CUDA_VISIBLE_DEVICES=""`` where the reference sets
``JAX_PLATFORMS=cpu``.  Two cases are the port's own: ``status`` counts
the head's chip under ``"TPU"``, and ``stop`` of one package signals none
of the other package's processes (the port keeps its pid files under
``<temp dir>/ray_tpu_torch/pids``, the reference under ``/tmp/ray_tpu/pids``).
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import pytest
from test_torch_runtime_parity import port_session_root

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED = {"RAY_TPU_TRACE": "1", "RAY_TPU_TRACE_SAMPLE": "1.0",
            "RAY_TPU_PROFILE": "1"}


@pytest.fixture(scope="module")
def cli_cluster():
    """A head with 2 CPUs and one chip, and a node with 2 CPUs and the
    resource ``remote_res``, their processes profiled."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    with port_session_root() as root:
        c = Cluster(initialize_head=True,
                    head_resources={"num_cpus": 2, "num_tpus": 1},
                    env=dict(PROFILED, RAY_TPU_TEMP_DIR=root))
        try:
            c.add_node(num_cpus=2, resources={"remote_res": 4})
            c.wait_for_nodes(2)
            c.connect()
            yield c
        finally:
            c.shutdown()


def _cli(*args, env=None, timeout=60):
    env = dict(env or os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
        capture_output=True, text=True, env=env, timeout=timeout)


@ray_tpu_torch.remote
def _chatty(i):
    print(f"chatty-line-{i}")
    sys.stdout.flush()
    return i


@ray_tpu_torch.remote(resources={"remote_res": 1})
class _Spinner:
    def ping(self):
        return os.getpid()

    def spin_marker_method(self, secs):
        t_end = time.time() + secs
        n = 0
        while time.time() < t_end:
            n += sum(i for i in range(400))
        return n


@pytest.mark.slow
def test_logs_cli_list_and_tail(cli_cluster):
    ray_tpu_torch.get(_chatty.remote(7), timeout=60)
    time.sleep(1.0)
    r = _cli("logs", "--address", cli_cluster.address)
    assert r.returncode == 0, r.stderr
    assert "worker-" in r.stdout and ".log" in r.stdout
    name = next(tok for tok in r.stdout.split()
                if tok.startswith("worker-") and tok.endswith(".log"))
    r = _cli("logs", name, "--address", cli_cluster.address, "--lines",
             "200")
    assert r.returncode == 0, r.stderr


def test_stack_cli_of_a_busy_remote_actor(cli_cluster):
    """``stack <actor-prefix>`` prints the all-thread stacks of a remote
    actor's worker while it runs a method, the spinning frame among
    them."""
    a = _Spinner.remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=60)
    ref = a.spin_marker_method.remote(12.0)
    aid = a.actor_id.hex()
    assert aid in [r["actor_id"] for r in state.list_actors()]
    # the dump may land before the call dispatches on a loaded host
    deadline = time.monotonic() + 30.0
    while True:
        r = _cli("stack", aid[:12], "--address", cli_cluster.address)
        assert r.returncode == 0, r.stderr
        if "spin_marker_method" in r.stdout or \
                time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert "spin_marker_method" in r.stdout
    ray_tpu_torch.kill(a)
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=60)


def test_status_cli_counts_the_chip(cli_cluster):
    r = _cli("status", "--address", cli_cluster.address)
    assert r.returncode == 0, r.stderr
    assert "nodes: 2 alive / 2 total" in r.stdout
    total = json.loads(r.stdout.split("resources:", 1)[1].splitlines()[0])
    assert total["TPU"] == 1.0 and total["CPU"] == 4.0
    assert total["remote_res"] == 4.0


def _started(pid_dir):
    """{kind: pid} of the pid files that ``start`` wrote into ``pid_dir``."""
    out = {}
    for name in os.listdir(pid_dir):
        kind, pid = name[:-len(".pid")].split("_")
        out[kind] = int(pid)
    return out


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:  # a zombie is gone
        return f.read().rsplit(")", 1)[1].split()[0] != "Z"


def test_stop_leaves_the_other_packages_processes(tmp_path, monkeypatch):
    """The port's ``start --head``, a process recorded by the reference's
    own ``_save_pid`` in the reference's layout under the same temp dir,
    then the port's ``stop``: the port's GCS and raylet end, the other
    process runs on.  The CLI runs with ``TMPDIR`` set to a directory of
    the test's own, so every pid file it reads is this test's, and the
    reference's real pid directory is not touched.  (The reference's side
    is a sleeper, not its GCS: the reference's leak audits count every
    ``ray_tpu.core`` process on the host, so a real one would fail the JAX
    package's tests that run meanwhile.)"""
    from ray_tpu import scripts as jscripts

    from ray_tpu_torch import scripts

    assert scripts._PID_DIR == os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "pids")
    assert scripts._CLUSTER_DIR == os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "clusters")
    assert scripts._PID_DIR != jscripts._PID_DIR
    tmp = tmp_path / "tmp"
    pid_dir = tmp / "ray_tpu_torch" / "pids"
    monkeypatch.setattr(jscripts, "_PID_DIR", str(tmp / "ray_tpu" / "pids"))
    other = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"])
    jscripts._save_pid("gcs", other.pid)
    started = {}
    try:
        with port_session_root() as root:
            env = dict(os.environ, RAY_TPU_TEMP_DIR=root, PYTHONPATH=ROOT,
                       TMPDIR=str(tmp))
            # the GCS and raylet that start leaves running inherit its
            # stderr: a file, so that nothing waits on a pipe they hold
            log = tmp_path / "start.log"
            with open(log, "w") as out:
                rc = subprocess.run(
                    [sys.executable, "-m", "ray_tpu_torch.scripts", "start",
                     "--head", "--port", "0"], stdout=out, stderr=out,
                    stdin=subprocess.DEVNULL, env=env, timeout=120,
                    cwd=str(tmp_path)).returncode
            assert rc == 0, log.read_text()
            started = _started(pid_dir)
            assert set(started) == {"gcs", "raylet"}, started
            r = _cli("stop", env=env)
            assert r.returncode == 0, r.stderr
            assert "stopped 2 process(es)" in r.stdout, r.stdout
            deadline = time.monotonic() + 15
            while any(_alive(p) for p in started.values()):
                assert time.monotonic() < deadline, started
                time.sleep(0.1)
            assert other.poll() is None
            assert os.listdir(tmp / "ray_tpu" / "pids") == [
                f"gcs_{other.pid}.pid"]
    finally:
        for pid in started.values():
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        other.kill()
        other.wait()
