"""Job submission: run driver scripts ON the cluster, track them, tail logs.

Reference analogue: `dashboard/modules/job/job_manager.py:516` (JobManager),
`:140` (JobSupervisor actor), SDK `python/ray/job_submission/`.  Same shape
here: ``submit_job`` starts a named JobSupervisor actor that execs the
entrypoint as a subprocess with ``RAY_TPU_ADDRESS`` exported (so the
entrypoint's ``ray_tpu_torch.init()`` auto-attaches to this cluster); status and
logs persist in the GCS KV so they outlive both the client and the
supervisor.

The supervisor is a CPU actor (no chip), so the raylet starts its worker
with ``CUDA_VISIBLE_DEVICES=""``, and the entrypoint inherits that
environment: it sees no card, and reaches one only through the tasks and
actors it submits with ``num_tpus``.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

__all__ = ["JobStatus", "JobSubmissionClient", "JobInfo"]

_NS = "jobs"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


class JobInfo(dict):
    """Dict with attribute access: status, entrypoint, submission_id,
    start_time, end_time, metadata, message."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


class _JobSupervisor:
    """Actor running ONE job entrypoint as a child process (reference:
    `job_manager.py:140`).  Runs on the cluster; writes status + log
    transitions to the GCS KV under ``jobs/<id>``."""

    def __init__(self, submission_id: str, entrypoint: str,
                 gcs_address: str, env_vars: Optional[Dict[str, str]],
                 metadata: Optional[Dict[str, str]]):
        import subprocess
        import threading

        from ray_tpu_torch.core.worker import global_worker

        self._id = submission_id
        self._worker = global_worker()
        self._log_chunks: List[str] = []
        self._stopped = False
        env = dict(os.environ)
        env["RAY_TPU_ADDRESS"] = gcs_address
        env["RAY_TPU_JOB_ID"] = submission_id
        env.update(env_vars or {})
        self._put_info({
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": JobStatus.RUNNING,
            "start_time": time.time(),
            "end_time": None,
            "metadata": metadata or {},
            "message": "",
        })
        # Own process group so stop() can kill the whole entrypoint tree
        # (shell + grandchildren), like the reference supervisor does.
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env, start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._pump = threading.Thread(target=self._pump_logs,
                                      name="job-log-pump", daemon=True)
        self._pump.start()

    def _put_info(self, info: dict):
        self._worker.kv_put(self._id.encode(),
                            json.dumps(info).encode(), namespace=_NS)

    def _get_info(self) -> dict:
        raw = self._worker.kv_get(self._id.encode(), namespace=_NS)
        return json.loads(raw) if raw else {}

    def _pump_logs(self):
        import time as _time

        last_flush = 0.0
        for line in self._proc.stdout:
            self._log_chunks.append(line)
            # Periodic partial flush: the dashboard's logs endpoint reads
            # the KV, so live jobs are tail-able over HTTP too.
            now = _time.monotonic()
            if now - last_flush > 2.0:
                last_flush = now
                try:
                    self._worker.kv_put(
                        (self._id + "/logs").encode(),
                        "".join(self._log_chunks).encode(), namespace=_NS)
                except Exception:  # noqa: BLE001
                    pass
        rc = self._proc.wait()
        info = self._get_info()
        info["end_time"] = time.time()
        if self._stopped:
            info["status"] = JobStatus.STOPPED
            info["message"] = "stopped by user"
        elif rc == 0:
            info["status"] = JobStatus.SUCCEEDED
        else:
            info["status"] = JobStatus.FAILED
            info["message"] = f"entrypoint exited with code {rc}"
        self._put_info(info)
        # Persist full logs so they survive this actor.
        self._worker.kv_put((self._id + "/logs").encode(),
                            "".join(self._log_chunks).encode(), namespace=_NS)

    def logs(self, offset: int = 0) -> str:
        return "".join(self._log_chunks[offset:])

    def logs_since(self, offset: int):
        """Atomic (text, next_offset) — the tail cursor and the text come
        from one snapshot, so concurrent appends are never skipped."""
        chunks = self._log_chunks[offset:]
        return "".join(chunks), offset + len(chunks)

    def log_chunk_count(self) -> int:
        return len(self._log_chunks)

    def running(self) -> bool:
        return self._proc.poll() is None

    def stop(self) -> bool:
        import signal

        if self._proc.poll() is None:
            self._stopped = True
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                try:
                    os.killpg(os.getpgid(self._proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    self._proc.kill()
            return True
        return False

    def pid(self) -> int:
        return self._proc.pid


class JobSubmissionClient:
    """SDK + CLI backend (reference: `python/ray/job_submission/sdk.py`).
    Connects as a driver to the cluster at ``address``."""

    def __init__(self, address: str):
        import ray_tpu_torch

        self._address = address
        ray_tpu_torch.init(address=address, ignore_reinit_error=True)
        self._ray = ray_tpu_torch

    # ------------------------------------------------------------- submit

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   num_cpus: float = 0) -> str:
        submission_id = submission_id or f"job-{uuid.uuid4().hex[:10]}"
        existing = self._kv_info(submission_id)
        if existing is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        env_vars = (runtime_env or {}).get("env_vars")
        supervisor = (
            self._ray.remote(_JobSupervisor)
            .options(name=f"_job_supervisor:{submission_id}",
                     num_cpus=num_cpus, max_restarts=0)
            .remote(submission_id, entrypoint, self._address,
                    env_vars, metadata))
        # Block until the supervisor is up and the KV record exists — after
        # this, status/logs work even if this client goes away.
        self._ray.get(supervisor.pid.remote())
        return submission_id

    # -------------------------------------------------------------- query

    def _kv_info(self, submission_id: str) -> Optional[dict]:
        from ray_tpu_torch.core.worker import global_worker

        raw = global_worker().kv_get(submission_id.encode(), namespace=_NS)
        return json.loads(raw) if raw else None

    def _supervisor(self, submission_id: str):
        try:
            return self._ray.get_actor(f"_job_supervisor:{submission_id}")
        except ValueError:
            return None

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = self._kv_info(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return JobInfo(info)

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id)["status"]

    def list_jobs(self) -> List[JobInfo]:
        from ray_tpu_torch.core.worker import global_worker

        w = global_worker()
        out = []
        for key in w.kv_keys(b"", namespace=_NS):
            if key.endswith(b"/logs"):
                continue
            raw = w.kv_get(key, namespace=_NS)
            if raw:
                out.append(JobInfo(json.loads(raw)))
        return sorted(out, key=lambda j: j.get("start_time") or 0)

    def get_job_logs(self, submission_id: str) -> str:
        from ray_tpu_torch.core.worker import global_worker

        raw = global_worker().kv_get((submission_id + "/logs").encode(),
                                     namespace=_NS)
        if raw is not None:
            return raw.decode()
        sup = self._supervisor(submission_id)
        if sup is not None:
            try:
                return self._ray.get(sup.logs.remote())
            except Exception:  # noqa: BLE001
                pass
        self.get_job_info(submission_id)  # raises if unknown job
        return ""

    def tail_job_logs(self, submission_id: str, poll_s: float = 0.2):
        """Generator of log text chunks until the job reaches a terminal
        state (reference SDK ``tail_job_logs``)."""
        offset = 0
        while True:
            sup = self._supervisor(submission_id)
            if sup is not None:
                try:
                    chunk, offset = self._ray.get(
                        sup.logs_since.remote(offset))
                    if chunk:
                        yield chunk
                except Exception:  # noqa: BLE001
                    pass
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                full = self.get_job_logs(submission_id)
                rest = "".join(full.splitlines(keepends=True)[offset:])
                if rest:
                    yield rest
                return
            time.sleep(poll_s)

    # ------------------------------------------------------------ control

    def stop_job(self, submission_id: str) -> bool:
        sup = self._supervisor(submission_id)
        if sup is None:
            return False
        return self._ray.get(sup.stop.remote())

    def delete_job(self, submission_id: str) -> bool:
        from ray_tpu_torch.core.worker import global_worker

        info = self._kv_info(submission_id)
        if info is None:
            return False
        if info["status"] not in JobStatus.TERMINAL:
            raise RuntimeError(
                f"job {submission_id!r} is {info['status']}; stop it first")
        w = global_worker()
        w.kv_del(submission_id.encode(), namespace=_NS)
        w.kv_del((submission_id + "/logs").encode(), namespace=_NS)
        return True

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 60.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.1)
        raise TimeoutError(
            f"job {submission_id!r} still "
            f"{self.get_job_status(submission_id)} after {timeout}s")
