"""Every piece that BENCHMARK.json names is found by name and complete, and
the file keeps to the contract's shape."""

import json
import os
import re

import pytest

from benchmarks.harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cell.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cell.ROOT, "BENCHMARK.json")) \
        <= 64 << 10


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["file"].startswith("benchmarks/")
    with open(os.path.join(cell.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in cfg["published"] and cfg[key] != cfg["published"][key]
        assert not key.endswith(("_dim", "_rank")) and "n_embd" not in key
    # what the program departs from (it has no dropout) is assumed, not cut
    for key in ("attn_pdrop", "embd_pdrop", "resid_pdrop"):
        assert cfg[key] == 0.1 and key not in c["reduced"]
    assert "dropout" in cfg["assumed"]
    for key in ("n_embd", "n_head", "n_layer", "n_positions", "vocab_size"):
        assert isinstance(cfg[key], int)
    assert cfg["vocab_size"] == 50257
    assert {"compute_dtype", "remat", "optimizer"} <= set(cfg["assumed"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_pieces(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    run = cell.load(w["name"], 1, 1.0, False, "cpu", "/nonexistent", 0.0)
    driver = cell.driver(run.traffic["driver"])
    assert driver.run
    assert set(run.workload["limits"]) == set(driver.CHECKS)
    reported = [m["name"] for m in cell.end_to_end(BENCH, w["name"])]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer(BENCH, w["name"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert callable(cell.reader(m["name"]))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for name in m.get("workloads", []):
        cell.entry(BENCH, name)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    assert "Kernels" in layers and "Device" in layers
