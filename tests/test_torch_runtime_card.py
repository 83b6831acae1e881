"""What the port's runtime changes for the card, on the CPU: the chip count
comes from ``torch.cuda.device_count()`` (hunk d), CPU workers get
``CUDA_VISIBLE_DEVICES=""`` (hunk e), and ``num_gpus=`` asks for the key
``"TPU"``, one chip (f).  The driver program fakes one card by replacing
``torch.cuda.device_count``; the workers never touch CUDA."""

import json
import os
import sys

from test_torch_runtime_parity import run_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = """
import json, os, sys
import ray_tpu_torch as rt
out = {}

rt.init(num_cpus=2)  # torch not loaded: the count is not asked
out["no_torch"] = rt.cluster_resources()
rt.shutdown()

import torch
torch.cuda.device_count = lambda: 1
rt.init(num_cpus=2)
out["one_card"] = rt.cluster_resources()


def seen():
    return [os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get("RAY_TPU_WORKER_PROFILE")]


out["cpu_task"] = rt.get(rt.remote(seen).remote(), timeout=60)
out["gpu_task"] = rt.get(rt.remote(num_gpus=1)(seen).remote(), timeout=60)


@rt.remote(num_gpus=1)
class OnCard:
    def seen(self):
        return seen()


actor = OnCard.remote()
out["gpu_actor"] = rt.get(actor.seen.remote(), timeout=60)
out["while_actor"] = rt.available_resources().get("TPU")
rt.kill(actor)
rt.shutdown()

os.environ["RAY_TPU_NUM_CHIPS"] = "2"
rt.init(num_cpus=2)
out["num_chips_flag"] = rt.cluster_resources()
rt.shutdown()
print("RESULT " + json.dumps(out))
"""


def test_chip_count_and_worker_env(tmp_path):
    main = tmp_path / "main.py"
    main.write_text(PROGRAM)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES", "RAY_TPU_NUM_CHIPS")}
    env["PYTHONPATH"] = ROOT
    proc, stdout, stderr = run_driver([sys.executable, str(main)],
                                      str(tmp_path), env)
    assert proc.returncode == 0, stderr
    line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    out = json.loads(line[-1][len("RESULT "):])
    assert out == {
        "no_torch": {"CPU": 2.0},
        "one_card": {"CPU": 2.0, "TPU": 1.0},
        "cpu_task": ["", "cpu"],
        "gpu_task": [None, "tpu"],
        "gpu_actor": [None, "tpu"],
        "while_actor": 0.0,
        "num_chips_flag": {"CPU": 2.0, "TPU": 2.0},
    }
