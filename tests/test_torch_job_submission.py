"""The port's counterparts of ``tests/test_job_submission.py``'s 7 cases
(submit, status, logs, stop, list, tail, delete), on one port ``Cluster``
for the module under a session root of its own, held to the port's leak
audit after it shuts down.

``ray_tpu_torch/job_submission/`` is a copy of the reference's with hunk
(e) in its docstring alone.  Two cases are the port's own: the entrypoint
inherits its supervisor's environment, and the supervisor is a CPU actor,
so the entrypoint sees no card (``CUDA_VISIBLE_DEVICES=""``) and reaches
one only through the tasks it submits with ``num_tpus``; and an entrypoint
run from a directory outside the repo imports ``ray_tpu_torch`` through
the import path the raylet hands its workers.
"""

import shlex
import sys
import time

import pytest
from test_torch_cluster import port_cluster

import ray_tpu_torch
from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(initialize_head=True,
                      head_resources={"num_cpus": 4}) as c:
        c.wait_for_nodes(1)
        yield c
        # JobSubmissionClient attached the module's driver; detach it
        # before the cluster goes away
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    return JobSubmissionClient(cluster.address)


def test_job_succeeds_and_logs(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job')\"")
    status = client.wait_until_finished(job_id, timeout=60)
    assert status == JobStatus.SUCCEEDED
    assert "hello from job" in client.get_job_logs(job_id)
    info = client.get_job_info(job_id)
    assert info.entrypoint.endswith("\"print('hello from job')\"")
    assert info.end_time is not None


def test_job_entrypoint_attaches_to_cluster(client):
    """The entrypoint's ray_tpu_torch.init() auto-attaches via
    RAY_TPU_ADDRESS and can run tasks on the SAME cluster that runs the
    supervisor."""
    script = (
        "import ray_tpu_torch; ray_tpu_torch.init()\n"
        "@ray_tpu_torch.remote\n"
        "def f(x):\n"
        "    return x * 2\n"
        "print('task says', ray_tpu_torch.get(f.remote(21)))\n"
    )
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c " + shlex.quote(script))
    assert client.wait_until_finished(job_id, timeout=90) == \
        JobStatus.SUCCEEDED
    assert "task says 42" in client.get_job_logs(job_id)


def test_job_failure_reported(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import sys; "
        f"print('about to fail'); sys.exit(3)\"")
    assert client.wait_until_finished(job_id, timeout=60) == JobStatus.FAILED
    info = client.get_job_info(job_id)
    assert "code 3" in info.message
    assert "about to fail" in client.get_job_logs(job_id)


def test_job_stop(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; "
        f"print('sleeping', flush=True); time.sleep(60)\"")
    # Wait for the subprocess to actually start before stopping it.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if "sleeping" in client.get_job_logs(job_id):
            break
        time.sleep(0.1)
    assert client.stop_job(job_id)
    assert client.wait_until_finished(job_id, timeout=30) == JobStatus.STOPPED


def test_job_env_vars_and_metadata(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import os; "
        f"print('tag=' + os.environ['MY_TAG'])\"",
        runtime_env={"env_vars": {"MY_TAG": "xyzzy"}},
        metadata={"owner": "tests"})
    assert client.wait_until_finished(job_id, timeout=60) == \
        JobStatus.SUCCEEDED
    assert "tag=xyzzy" in client.get_job_logs(job_id)
    assert client.get_job_info(job_id).metadata == {"owner": "tests"}


def test_list_and_tail_and_delete(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('A'); print('B')\"",
        submission_id="job-listme")
    ids = [j.submission_id for j in client.list_jobs()]
    assert "job-listme" in ids
    chunks = "".join(client.tail_job_logs(job_id))
    assert "A" in chunks and "B" in chunks
    assert client.get_job_status(job_id) in JobStatus.TERMINAL
    assert client.delete_job(job_id)
    with pytest.raises(ValueError):
        client.get_job_info(job_id)


def test_duplicate_submission_id_rejected(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('x')\"")
    client.wait_until_finished(job_id, timeout=60)
    with pytest.raises(ValueError):
        client.submit_job(entrypoint="echo hi", submission_id=job_id)


# ------------------------------------------------------------ the port's


def test_entrypoint_sees_no_card(client, tmp_path):
    """The entrypoint, run from a directory outside the repo, imports the
    port, finds ``CUDA_VISIBLE_DEVICES=""`` (its supervisor is a CPU
    worker) and counts 0 cards; a task it submits with ``num_tpus`` waits
    for a chip this cluster does not have."""
    script = (
        "import os, torch, ray_tpu_torch as rt\n"
        "print('visible', repr(os.environ.get('CUDA_VISIBLE_DEVICES')))\n"
        "print('cards', torch.cuda.device_count())\n"
        "rt.init()\n"
        "print('chips', rt.cluster_resources().get('TPU', 0.0))\n"
        "ref = rt.remote(num_tpus=1)(lambda: 1).remote()\n"
        "print('waits', rt.wait([ref], timeout=1.0)[0] == [])\n")
    job_id = client.submit_job(
        entrypoint=f"cd {shlex.quote(str(tmp_path))} && {sys.executable} "
        f"-c " + shlex.quote(script))
    assert client.wait_until_finished(job_id, timeout=90) == \
        JobStatus.SUCCEEDED, client.get_job_logs(job_id)
    lines = client.get_job_logs(job_id).splitlines()
    for want in ("visible ''", "cards 0", "chips 0.0", "waits True"):
        assert want in lines, lines
