"""Standalone GCS server process (reference:
`src/ray/gcs/gcs_server/gcs_server_main.cc`).

Prints ``GCS_ADDRESS host:port`` on stdout once listening so launchers
(`ray_tpu_torch/cluster_utils.py`, the CLI) can read the bound ephemeral port.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--persist", default=None,
                        help="snapshot file for GCS fault tolerance "
                        "(reference: Redis-backed GCS persistence)")
    args = parser.parse_args()

    # Crash forensics: fatal-signal stack dumps for the control plane.
    import faulthandler

    faulthandler.enable()

    from ray_tpu_torch.core.gcs import GcsServer
    from ray_tpu_torch.util import profiling

    server = GcsServer(host=args.host, port=args.port,
                       persist_path=args.persist)
    print(f"GCS_ADDRESS {server.address}", flush=True)

    # Continuous profiling of the GCS process itself (where do control-
    # plane microseconds go?): samples flush straight into the local
    # profile table under the reserved "gcs" producer key — no raylet in
    # this process to relay through.
    profiling.ensure_profiler("gcs")
    profiling.set_flush_target(
        lambda samples, dropped: server.core.add_profile_samples(
            "gcs", samples, dropped))

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
