"""The program's runtime for one run: a session root of its own, a small
object store, and a shutdown that leaves nothing behind.

The runtime puts its sessions under ``/tmp/ray_tpu_torch`` unless
``RAY_TPU_TEMP_DIR`` says otherwise; a run gives it a new directory under
``TMPDIR`` (``ray_tpu_torch.session_root``), and removes it after
``shutdown``.  The raylet's object-store segment is the program's own
(``rtt_store_*`` in ``/dev/shm``); the audit waits until no runtime process
and no such segment made by the run is left, and raises otherwise.
"""

from __future__ import annotations

import contextlib
import os
import shutil

#: the object store of a run: blocks of a few hundred KB pass through it
STORE_BYTES = 256 << 20
#: seconds the audit waits for the runtime's processes to end
LEFTOVER_GRACE_S = 60.0


@contextlib.contextmanager
def port_runtime(num_tpus: int):
    """``ray_tpu_torch.init`` with ``num_tpus`` chips and a session root of
    the run's own; yields the root.  Raises ``HostLeakError`` where a
    runtime process or store segment outlives ``shutdown``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.session_root import new_session_root
    from ray_tpu_torch.util import chaos

    root = new_session_root(prefix="bench_")
    os.environ["RAY_TPU_TEMP_DIR"] = root
    rt.config.temp_dir = root
    baseline = chaos.snapshot_host()
    rt.init(num_tpus=num_tpus, object_store_memory=STORE_BYTES,
            log_to_driver=False)
    try:
        yield root
    finally:
        rt.shutdown()
        chaos.assert_clean_host(baseline, grace_s=LEFTOVER_GRACE_S)
        shutil.rmtree(root, ignore_errors=True)
