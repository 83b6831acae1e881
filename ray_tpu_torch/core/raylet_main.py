"""Standalone raylet (node) process (reference: `src/ray/raylet/main.cc:109`).

One process per node: owns the node's shm object store, worker pool, local
scheduler, and the TCP listener peers/drivers connect to.  Registers with
the GCS given by ``--gcs`` and heartbeats until terminated.

Prints ``RAYLET node_id=<hex> port=<port>`` on stdout once up.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import uuid


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True, help="GCS host:port")
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="{}",
                        help='JSON, e.g. {"CPU": 4, "TPU": 1}')
    parser.add_argument("--session-dir", default=None)
    parser.add_argument("--store-mb", type=int, default=None)
    args = parser.parse_args()

    # Crash forensics: fatal-signal stack dumps on stderr for the node
    # daemon too (the raylet hosts no user code, but a native-codec or
    # shm-store segfault should leave a trace, not a silent exit).
    import faulthandler

    faulthandler.enable()

    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.object_store import create_store_file
    from ray_tpu_torch.core.raylet import Raylet

    resources = {k: float(v) for k, v in json.loads(args.resources).items()}
    resources.setdefault("CPU", float(os.cpu_count() or 1))

    session_dir = args.session_dir or os.path.join(
        config.temp_dir, f"node_{os.getpid()}_{uuid.uuid4().hex[:6]}")
    os.makedirs(session_dir, exist_ok=True)

    store_mb = args.store_mb or config.object_store_memory_mb
    shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else session_dir
    # Reclaim segments left by SIGKILLed/crashed raylets before adding
    # our own — otherwise every hard node kill leaks store_mb of shm
    # until reboot.
    from ray_tpu_torch.core.object_store import sweep_dead_store_files

    sweep_dead_store_files(shm_dir)
    store_path = os.path.join(
        shm_dir, f"rtt_store_{os.getpid()}_{uuid.uuid4().hex[:6]}")
    create_store_file(store_path, store_mb << 20)

    raylet = Raylet(
        session_dir, resources, store_path,
        worker_env={"RAY_TPU_SESSION_DIR": session_dir},
        gcs_address=args.gcs,
        node_ip=args.ip,
        listen_port=args.port,
    )
    print(f"RAYLET node_id={raylet.node_id} port={raylet.tcp_port}",
          flush=True)

    stop = threading.Event()
    raylet.on_fatal = stop.set  # GCS lost -> exit instead of lingering

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    raylet.shutdown()
    try:
        os.unlink(store_path)
    except OSError:
        pass
    import shutil

    shutil.rmtree(store_path + ".spill", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
