"""GCE / TPU-VM node provider — launches real cloud workers for the
autoscaler and ``ray_tpu_torch up``.

Reference analogue: `python/ray/autoscaler/_private/gcp/node_provider.py:1`
(+ `_private/gcp/node.py`'s compute/tpu split) and SURVEY §7 item 13 (a
TPU-pod-slice provider as a first-class target).

Two instance kinds per node type:

* ``kind: compute`` — a GCE VM (``machine_type``), created via the
  Compute Engine instances API;
* ``kind: tpu`` — a Cloud TPU VM or pod slice (``accelerator_type`` like
  "v5litepod-8"), created via the TPU API.  Every created TPU node gets
  RAY_TPU_SLICE_ID / RAY_TPU_ACCELERATOR_TYPE / RAY_TPU_TOPOLOGY in its
  startup env, so its raylet registers with the topology labels the
  scheduler's same-slice STRICT_PACK packing keys on.

The cloud API surface is an injectable transport (``GceApi``): four
methods over instances.  Tests inject a fake; production uses
:class:`RestGceApi`, which signs requests with the VM's metadata-server
token (no SDK dependency).  Every created instance runs a startup script
that joins the cluster by GCS address.
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler import NodeProvider

__all__ = ["GceApi", "RestGceApi", "GceNodeProvider"]


class GceApi:
    """The injectable cloud transport: what GceNodeProvider needs from
    GCP, and nothing more.  ``instance`` dicts carry at least
    {"name", "kind", "status", "labels"}."""

    def create_instance(self, name: str, kind: str, spec: Dict[str, Any],
                        metadata: Dict[str, str]) -> None:
        raise NotImplementedError

    def delete_instance(self, name: str, kind: str) -> None:
        raise NotImplementedError

    def list_instances(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class RestGceApi(GceApi):
    """Direct REST calls to the Compute Engine and Cloud TPU APIs using
    the GCE metadata-server token (runs on the head VM; no gcloud SDK).
    Constructed lazily — importable and testable without credentials."""

    _COMPUTE = "https://compute.googleapis.com/compute/v1"
    _TPU = "https://tpu.googleapis.com/v2"

    def __init__(self, project: str, zone: str):
        self.project = project
        self.zone = zone

    # -- auth ---------------------------------------------------------------

    def _token(self) -> str:
        import urllib.request

        req = urllib.request.Request(
            "http://metadata.google.internal/computeMetadata/v1/instance/"
            "service-accounts/default/token",
            headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())["access_token"]

    def _call(self, method: str, url: str, body: Optional[dict] = None):
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Authorization": f"Bearer {self._token()}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    # -- GceApi -------------------------------------------------------------

    def create_instance(self, name, kind, spec, metadata):
        if kind == "tpu":
            body = {
                "acceleratorType": spec["accelerator_type"],
                "runtimeVersion": spec.get("runtime_version",
                                           "tpu-ubuntu2204-base"),
                "metadata": {"startup-script":
                             metadata.get("startup_script", "")},
                "labels": metadata.get("labels", {}),
            }
            self._call(
                "POST",
                f"{self._TPU}/projects/{self.project}/locations/{self.zone}"
                f"/nodes?nodeId={name}", body)
        else:
            body = {
                "name": name,
                "machineType": (f"zones/{self.zone}/machineTypes/"
                                f"{spec.get('machine_type', 'n2-standard-8')}"),
                "disks": [{"boot": True, "initializeParams": {
                    "sourceImage": spec.get(
                        "source_image",
                        "projects/debian-cloud/global/images/family/"
                        "debian-12")}}],
                "networkInterfaces": [{"network": "global/networks/default"}],
                "metadata": {"items": [
                    {"key": "startup-script",
                     "value": metadata.get("startup_script", "")}]},
                "labels": metadata.get("labels", {}),
            }
            self._call(
                "POST",
                f"{self._COMPUTE}/projects/{self.project}/zones/{self.zone}"
                "/instances", body)

    def delete_instance(self, name, kind):
        if kind == "tpu":
            self._call(
                "DELETE",
                f"{self._TPU}/projects/{self.project}/locations/{self.zone}"
                f"/nodes/{name}")
        else:
            self._call(
                "DELETE",
                f"{self._COMPUTE}/projects/{self.project}/zones/{self.zone}"
                f"/instances/{name}")

    def list_instances(self):
        out: List[Dict[str, Any]] = []
        vms = self._call(
            "GET",
            f"{self._COMPUTE}/projects/{self.project}/zones/{self.zone}"
            "/instances?filter=labels.ray-tpu-cluster:*")
        for item in vms.get("items", []):
            out.append({"name": item["name"], "kind": "compute",
                        "status": item.get("status", "RUNNING"),
                        "labels": item.get("labels", {})})
        tpus = self._call(
            "GET",
            f"{self._TPU}/projects/{self.project}/locations/{self.zone}"
            "/nodes")
        for item in tpus.get("nodes", []):
            labels = item.get("labels", {})
            if "ray-tpu-cluster" not in labels:
                continue
            out.append({"name": item["name"].rsplit("/", 1)[-1],
                        "kind": "tpu",
                        "status": item.get("state", "READY"),
                        "labels": labels})
        return out


class GceNodeProvider(NodeProvider):
    """NodeProvider over a GceApi transport.

    node_types entries::

        worker_tpu:
          kind: tpu                       # or "compute"
          accelerator_type: v5litepod-8
          topology: "2x4"
          resources: {CPU: 8, TPU: 8}
        worker_cpu:
          kind: compute
          machine_type: n2-standard-8
          resources: {CPU: 8}

    A created TPU node's startup env carries its slice identity
    (RAY_TPU_SLICE_ID = instance name), so all hosts of a pod slice
    register ICI-adjacent under one ``tpu_slice`` label."""

    def __init__(self, gcs_address: str, node_types: Dict[str, dict],
                 api: GceApi, cluster_name: str = "default"):
        self._gcs_address = gcs_address
        self._node_types = node_types
        self._api = api
        self._cluster = cluster_name
        self._lock = threading.Lock()
        # instance name -> (node_type, created_at).  Instance names double
        # as provisional node ids; the autoscaler joins them to runtime
        # GCS node ids through the registered hostname (a GCE VM's
        # hostname leads with its instance name).
        self._created: Dict[str, tuple] = {}
        # grace for the eventually-consistent cloud list: a just-created
        # instance may not appear for a while and must not be declared
        # gone (the autoscaler would double-launch and leak the original)
        self._list_grace_s = 120.0

    # -- helpers ------------------------------------------------------------

    def _startup_script(self, node_type: str, name: str,
                        spec: Dict[str, Any]) -> str:
        env_lines = [
            f"export RAY_TPU_GCS_ADDRESS={self._gcs_address}",
            f"export RAY_TPU_NODE_TYPE={node_type}",
        ]
        if spec.get("kind") == "tpu":
            env_lines += [
                f"export RAY_TPU_SLICE_ID={name}",
                f"export RAY_TPU_ACCELERATOR_TYPE="
                f"{spec.get('accelerator_type', '')}",
                f"export RAY_TPU_TOPOLOGY={spec.get('topology', '')}",
            ]
        res = json.dumps(spec.get("resources", {}))
        return "\n".join([
            "#!/bin/bash",
            *env_lines,
            # the VM's reachable address, NOT the default 127.0.0.1 — the
            # head and peers dial what the raylet registers
            "NODE_IP=$(hostname -I | awk '{print $1}')",
            f"python -m ray_tpu_torch.core.raylet_main "
            f"--gcs {self._gcs_address} --ip \"$NODE_IP\" "
            f"--resources '{res}'",
        ])

    # -- NodeProvider -------------------------------------------------------

    def create_node(self, node_type: str, count: int) -> None:
        spec = self._node_types[node_type]
        kind = spec.get("kind", "compute")
        for _ in range(count):
            # GCE/TPU resource names must match [a-z]([-a-z0-9]*[a-z0-9])?
            safe_type = re.sub(r"[^a-z0-9-]", "-", node_type.lower())
            safe_cluster = re.sub(r"[^a-z0-9-]", "-", self._cluster.lower())
            name = f"ray-tpu-{safe_cluster}-{safe_type}-" \
                   f"{uuid.uuid4().hex[:8]}"
            self._api.create_instance(
                name, kind, spec,
                {"startup_script": self._startup_script(node_type, name,
                                                        spec),
                 "labels": {"ray-tpu-cluster": self._cluster,
                            "ray-tpu-node-type": node_type}})
            with self._lock:
                self._created[name] = (node_type, time.monotonic())

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            entry = self._created.pop(node_id, None)
        if entry is not None:
            node_type = entry[0]
        else:
            # not created by THIS process (monitor restart / separate
            # teardown): recover the type from the cloud-side label so the
            # instance still gets deleted instead of leaking
            inst = next((i for i in self._api.list_instances()
                         if i["name"] == node_id), None)
            if inst is None:
                return
            node_type = inst.get("labels", {}).get("ray-tpu-node-type", "")
        kind = self._node_types.get(node_type, {}).get("kind", "compute")
        self._api.delete_instance(node_id, kind)

    def non_terminated_nodes(self) -> Dict[str, str]:
        live: Dict[str, str] = {}
        for inst in self._api.list_instances():
            if inst.get("labels", {}).get("ray-tpu-cluster") != self._cluster:
                continue
            if inst.get("status") in ("STOPPING", "TERMINATED", "DELETING"):
                continue
            node_type = inst.get("labels", {}).get("ray-tpu-node-type", "")
            live[inst["name"]] = node_type
        now = time.monotonic()
        with self._lock:
            for name, (node_type, created) in list(self._created.items()):
                if name in live:
                    continue
                if now - created < self._list_grace_s:
                    # eventual consistency: still provisioning — count it
                    # so the scheduler doesn't double-launch
                    live[name] = node_type
                else:
                    self._created.pop(name)
        return live

    def shutdown(self) -> None:
        for name in list(self.non_terminated_nodes()):
            self.terminate_node(name)
