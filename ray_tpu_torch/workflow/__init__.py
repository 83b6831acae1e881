"""Durable workflows: DAG execution with per-step checkpoints + resume.

Reference analogue: `python/ray/workflow/` (``workflow.run`` executes a
DAG of steps with storage-backed checkpoints; a crashed workflow resumes
from the last completed step; `workflow/api.py`).

TPU-first simplifications vs the reference: storage is a filesystem
directory (fsspec/cloud mounts work the same way), step identity is the
node's position in the deterministic topological order plus the function
name, and execution drives the existing task runtime — each step runs as
a normal task, its result is checkpointed before dependents run (the
"commit point"; reference `workflow/workflow_executor.py`).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.dag import DAGNode, FunctionNode, InputNode

config.define("workflow_dir", str, "",
              "Durable workflow storage root (default "
              "~/.ray_tpu_torch/workflows).", live=True)

__all__ = ["run", "resume", "get_output", "get_status", "list_all",
           "delete", "init_storage"]

_storage_dir: Optional[str] = None


def init_storage(path: str):
    """Set the workflow storage root (reference: ``workflow.init``)."""
    global _storage_dir
    _storage_dir = path
    os.makedirs(path, exist_ok=True)


def _storage() -> str:
    global _storage_dir
    if _storage_dir is None:
        _storage_dir = (config.workflow_dir
                        or os.path.expanduser("~/.ray_tpu_torch/workflows"))
        os.makedirs(_storage_dir, exist_ok=True)
    return _storage_dir


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


def _write_meta(workflow_id: str, meta: dict):
    path = os.path.join(_wf_dir(workflow_id), "meta.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def _read_meta(workflow_id: str) -> Optional[dict]:
    try:
        with open(os.path.join(_wf_dir(workflow_id), "meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic step ids: topo position + function name."""
    ids = {}
    for i, node in enumerate(dag.topo_order()):
        name = node.name if isinstance(node, FunctionNode) else "input"
        ids[id(node)] = f"{i:03d}_{name}"
    return ids


def _ckpt_path(workflow_id: str, step_id: str) -> str:
    return os.path.join(_wf_dir(workflow_id), step_id + ".pkl")


def _save_ckpt(workflow_id: str, step_id: str, value: Any):
    path = _ckpt_path(workflow_id, step_id)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(value, f, protocol=5)
    os.replace(tmp, path)  # atomic commit point


def _load_ckpt(workflow_id: str, step_id: str):
    with open(_ckpt_path(workflow_id, step_id), "rb") as f:
        return pickle.load(f)


def _execute(workflow_id: str, dag: DAGNode, dag_blob: bytes) -> Any:
    """Run the DAG step-by-step, checkpointing each result; completed
    steps (from a prior attempt) are skipped."""
    import ray_tpu_torch

    ids = _step_ids(dag)
    os.makedirs(_wf_dir(workflow_id), exist_ok=True)
    with open(os.path.join(_wf_dir(workflow_id), "dag.pkl"), "wb") as f:
        f.write(dag_blob)
    _write_meta(workflow_id, {"workflow_id": workflow_id,
                              "status": "RUNNING",
                              "start_time": time.time()})
    results: Dict[int, Any] = {}
    try:
        for node in dag.topo_order():
            if not isinstance(node, FunctionNode):
                if isinstance(node, InputNode):
                    raise ValueError(
                        "workflow DAGs must be fully bound (no InputNode)")
                continue
            step_id = ids[id(node)]
            if os.path.exists(_ckpt_path(workflow_id, step_id)):
                results[id(node)] = _load_ckpt(workflow_id, step_id)
                continue
            args = [results[id(a)] if isinstance(a, DAGNode) else a
                    for a in node._args]
            kwargs = {k: results[id(v)] if isinstance(v, DAGNode) else v
                      for k, v in node._kwargs.items()}
            value = ray_tpu_torch.get(node._fn.remote(*args, **kwargs))
            _save_ckpt(workflow_id, step_id, value)
            results[id(node)] = value
        out = results[id(dag.topo_order()[-1])]
        _save_ckpt(workflow_id, "__output__", out)
        _write_meta(workflow_id, {"workflow_id": workflow_id,
                                  "status": "SUCCESSFUL",
                                  "end_time": time.time()})
        return out
    except Exception as e:
        _write_meta(workflow_id, {"workflow_id": workflow_id,
                                  "status": "FAILED", "error": repr(e),
                                  "end_time": time.time()})
        raise


def run(dag: DAGNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a DAG durably; returns the final result (reference:
    ``workflow.run``).  Re-running a workflow_id whose steps partially
    completed skips the checkpointed steps."""
    from ray_tpu_torch._vendor import cloudpickle

    if workflow_id is None:
        workflow_id = f"wf-{int(time.time() * 1000):x}"
    meta = _read_meta(workflow_id)
    if meta and meta["status"] == "SUCCESSFUL":
        return _load_ckpt(workflow_id, "__output__")
    return _execute(workflow_id, dag, cloudpickle.dumps(dag))


def resume(workflow_id: str) -> Any:
    """Resume a crashed/failed workflow from its last checkpoint using the
    stored DAG (reference: ``workflow.resume``)."""
    from ray_tpu_torch._vendor import cloudpickle

    meta = _read_meta(workflow_id)
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    if meta["status"] == "SUCCESSFUL":
        return _load_ckpt(workflow_id, "__output__")
    with open(os.path.join(_wf_dir(workflow_id), "dag.pkl"), "rb") as f:
        blob = f.read()
    dag = cloudpickle.loads(blob)
    return _execute(workflow_id, dag, blob)


def get_output(workflow_id: str) -> Any:
    meta = _read_meta(workflow_id)
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    if meta["status"] != "SUCCESSFUL":
        raise RuntimeError(f"workflow {workflow_id!r} is {meta['status']}")
    return _load_ckpt(workflow_id, "__output__")


def get_status(workflow_id: str) -> str:
    meta = _read_meta(workflow_id)
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    return meta["status"]


def list_all() -> List[Dict[str, Any]]:
    out = []
    root = _storage()
    for name in sorted(os.listdir(root)):
        meta = _read_meta(name)
        if meta:
            out.append(meta)
    return out


def delete(workflow_id: str):
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
