"""A cell and its pieces, found by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration, traffic and chips, and which metrics it reports.  Beside
it, under ``benchmarks/``:

- ``configs/<config>.json``: the model configuration (published keys,
  ``source``, ``reduced``, ``assumed``, the deployment);
- ``traffic/<traffic>.json``: the traffic mix, read by one general
  generator, and ``driver``, the way it drives the program;
- ``workloads/<cell>.json``: what belongs to the cell alone: the limits
  of the numbers that decide ``correct`` and the reference's block size;
- ``drivers/<driver>.py``: ``run(run) -> dict``;
- ``metrics/<metric>.py``: ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List

#: the checkout's root: ``benchmarks/`` lies in it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmarks")


def _json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT, "BENCHMARK.json")


def entry(bench: Dict, cell: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


@dataclasses.dataclass
class Run:
    """One run of one cell: what a driver gets."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    config: Dict
    traffic: Dict
    workload: Dict
    run_dir: str
    t_start: float
    #: host-clock marks of the set-up before the driver (``torch``,
    #: ``program``: the imports done)
    marks: Dict = dataclasses.field(default_factory=dict)


def load(cell: str, seed: int, seconds: float, trace: bool, device: str,
         run_dir: str, t_start: float) -> Run:
    """The run of ``cell``, from its entry in ``BENCHMARK.json``."""
    e = entry(benchmark(), cell)
    return Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
               device=device, chips=int(e["chips"]),
               config=_json(BENCH, "configs", f"{e['config']}.json"),
               traffic=_json(BENCH, "traffic", f"{e['traffic']}.json"),
               workload=_json(BENCH, "workloads", f"{cell}.json"),
               run_dir=run_dir, t_start=t_start)


def driver(name: str):
    return importlib.import_module(f"benchmarks.drivers.{name}")


def applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is read in ``cell``: listed under its
    ``workloads``, or, without that key, everywhere its moved end-to-end
    metric (for an end-to-end metric: every cell) is reported, as the
    contract asks of an entry that a later cell or metric adds."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell, [])]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    reported = [m["name"] for m in end_to_end(bench, cell)]
    return [m for m in bench["per_layer"] if applies(m, cell, reported)]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read`` (a name may hold dots, so the
    file is loaded by path)."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmarks.metrics._{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
