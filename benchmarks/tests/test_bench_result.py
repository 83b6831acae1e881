"""The last line's keys, and the run path with no card."""

import json
import os
import subprocess
import sys

import pytest

from benchmarks.harness import cell, result

FIELDS = dict(attempted=3, failed=0,
              metrics={"setup_s": {"value": 1.5, "unit": "s"}},
              device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                      "count": 1, "memory_peak_bytes": 1 << 30})


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    checks = [result.check("loss", 1e-4, 1e-3),
              result.check("grad", float("inf"), 0.1)]
    extra = {"breakdown": {"device_ops": [["k", 0.1]],
                           "idle_gaps": [["step", 0.01]]}} if traced else {}
    out = json.loads(result.line(correct=False, checks=checks, **FIELDS,
                                 **extra))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == want + (["breakdown"] if traced else []) + ["checks"]
    assert out["checks"] == {"loss": {"value": 1e-4, "limit": 1e-3},
                             "grad": {"value": "inf", "limit": 0.1}}
    assert [c["ok"] for c in checks] == [True, False]


def test_no_card_no_result(tmp_path):
    """Where no CUDA device is visible the command fails and prints nothing
    on its standard output: no fallback to the CPU."""
    cellname = cell.benchmark()["workloads"][0]["name"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(cell.ROOT, "benchmarks", "run.py"),
         "--workload", cellname, "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no result" in p.stderr
