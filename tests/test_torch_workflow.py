"""The port's counterparts of ``tests/test_workflow.py``'s 7 cases (DAG
bind/execute and durable workflows with checkpoint/resume), on one port
runtime for the module (8 CPUs, under a session root of its own), ending
with the port's leak audit; the reference's slow mark is kept.

``ray_tpu_torch/workflow/`` is a copy of ``ray_tpu/workflow/`` with hunk
(b), the stored DAG pickled with the vendored cloudpickle.  Two cases are
the port's own: a step's bf16 tensor is checkpointed as a bf16 CPU tensor,
and the default store is another directory than the reference's.
"""

import os
import pickle
import shutil

import pytest
import torch
from test_torch_runtime_parity import assert_port_left_nothing

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode


@pytest.fixture(scope="module")
def ray():
    """One port runtime for the module, under a session root of its own."""
    from ray_tpu_torch.session_root import new_session_root

    config = ray_tpu_torch.config
    default, config.temp_dir = config.temp_dir, new_session_root()
    try:
        ray_tpu_torch.init(num_cpus=8)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(config.temp_dir, ignore_errors=True)
        config.temp_dir = default


@pytest.fixture(autouse=True)
def storage(tmp_path):
    workflow.init_storage(str(tmp_path / "wf"))
    yield


@ray_tpu_torch.remote
def _add(a, b):
    return a + b


@ray_tpu_torch.remote
def _mul(a, b):
    return a * b


@ray_tpu_torch.remote
def _record_and_double(x, touch_path=None):
    if touch_path:
        with open(touch_path, "a") as f:
            f.write("ran\n")
    return x * 2


# ------------------------------------------------------------------- DAG


@pytest.mark.slow
def test_dag_bind_execute(ray):
    dag = _add.bind(_mul.bind(2, 3), _mul.bind(4, 5))
    assert ray_tpu_torch.get(dag.execute()) == 26


def test_dag_diamond_executes_shared_node_once(ray):
    shared = _mul.bind(3, 3)
    dag = _add.bind(shared, shared)
    assert ray_tpu_torch.get(dag.execute()) == 18


def test_dag_input_node(ray):
    x = InputNode()
    dag = _add.bind(_mul.bind(x, 10), 1)
    assert ray_tpu_torch.get(dag.execute(4)) == 41


# -------------------------------------------------------------- workflow


def test_workflow_run_and_output(ray):
    dag = _add.bind(_mul.bind(2, 3), 4)
    assert workflow.run(dag, workflow_id="w1") == 10
    assert workflow.get_status("w1") == "SUCCESSFUL"
    assert workflow.get_output("w1") == 10
    assert any(m["workflow_id"] == "w1" for m in workflow.list_all())


def test_workflow_rerun_uses_checkpoints(ray, tmp_path):
    touch = tmp_path / "touch.txt"
    dag = _add.bind(_record_and_double.bind(5, str(touch)), 1)
    assert workflow.run(dag, workflow_id="w2") == 11
    runs_before = touch.read_text().count("ran")
    # a completed workflow returns its stored output without re-executing
    assert workflow.run(dag, workflow_id="w2") == 11
    assert touch.read_text().count("ran") == runs_before


def test_workflow_resume_after_failure(ray, tmp_path):
    """A failing step fails the workflow; after the cause is fixed,
    resume() skips the already-checkpointed steps and completes."""
    flag = tmp_path / "ok"
    touch = tmp_path / "touch2.txt"

    @ray_tpu_torch.remote(max_retries=0)
    def flaky(x, flag_path):
        import os

        if not os.path.exists(flag_path):
            raise RuntimeError("flaky failure")
        return x + 100

    dag = flaky.bind(_record_and_double.bind(7, str(touch)), str(flag))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w3")
    assert workflow.get_status("w3") == "FAILED"
    first_runs = touch.read_text().count("ran")
    assert first_runs >= 1  # the upstream step committed before the crash

    flag.write_text("go")
    assert workflow.resume("w3") == 114
    assert workflow.get_status("w3") == "SUCCESSFUL"
    # upstream step was NOT re-executed on resume
    assert touch.read_text().count("ran") == first_runs


def test_workflow_delete(ray):
    dag = _add.bind(1, 2)
    workflow.run(dag, workflow_id="w4")
    workflow.delete("w4")
    with pytest.raises(ValueError):
        workflow.get_status("w4")


# ------------------------------------------------------------ the port's


@ray_tpu_torch.remote
def _bf16_logits(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"logits": torch.randn(3, 5, generator=gen).to(torch.bfloat16)}


@ray_tpu_torch.remote
def _rows(d):
    return d["logits"].shape[0]


def test_workflow_checkpoints_bf16_tensor_on_the_host(ray, tmp_path):
    """A step's bf16 tensor comes back from the runtime as a CPU tensor of
    its dtype (the serializer takes a card tensor to the host, hunk (c)),
    so the step's checkpoint, stdlib ``pickle``, holds a bf16 CPU tensor
    bit-equal to the step's value, and resume reads it back as that."""
    want = torch.randn(3, 5, generator=torch.Generator().manual_seed(4))
    want = want.to(torch.bfloat16)
    dag = _rows.bind(_bf16_logits.bind(4))
    assert workflow.run(dag, workflow_id="bf16") == 3
    step = os.path.join(str(tmp_path / "wf"), "bf16", "000__bf16_logits.pkl")
    with open(step, "rb") as f:
        value = pickle.load(f)
    got = value["logits"]
    assert type(got) is torch.Tensor
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    ids = workflow._step_ids(dag)
    assert workflow._load_ckpt("bf16", ids[id(dag._args[0])])[
        "logits"].dtype == torch.bfloat16


def test_default_store_is_not_the_references(monkeypatch, tmp_path):
    """The rename moves the default store from ``~/.ray_tpu/workflows`` to
    ``~/.ray_tpu_torch/workflows`` (not a hunk), so the two packages'
    workflows never share a directory."""
    from ray_tpu import workflow as jworkflow

    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (workflow, jworkflow):
        monkeypatch.setattr(mod, "_storage_dir", None)
        monkeypatch.setattr(mod.config, "workflow_dir", "", raising=False)
    assert workflow._storage() == str(tmp_path / ".ray_tpu_torch" /
                                      "workflows")
    assert jworkflow._storage() == str(tmp_path / ".ray_tpu" / "workflows")
