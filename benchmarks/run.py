"""The benchmark of ray_tpu_torch on NVIDIA GPUs.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process, one run of one cell of ``BENCHMARK.json``: it starts the
program's runtime with a session root of its own under ``TMPDIR``, builds
the cell and warms its shapes (set-up), measures for ``--seconds``, checks
what the window produced against the plain reference, shuts the runtime
down, and prints one JSON line last (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and ``breakdown``; ``checks`` last).  It exits non-zero and prints
no result where no CUDA device is visible or fewer than the cell asks
for, and where ``jax``, ``jaxlib``, ``flax`` or ``ray_tpu`` is loaded.
"""

import time

T_START = time.monotonic()  # set-up runs from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package is imported from the checkout's root, not from its own folder
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        not in (ROOT, os.path.join(ROOT, "benchmarks"))]

#: the program's kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, config=None, traffic=None,
             workload=None, marks=None):
    """One run: (the result line's fields, the checks, blocked modules the
    worker saw).  ``config``, ``traffic`` and ``workload`` replace the
    cell's files where given (the tests' small sizes); ``marks`` are the
    set-up's host-clock marks so far."""
    import shutil

    from benchmarks.harness import cell, trace as tr

    run_dir = tempfile.mkdtemp(prefix="bench_run_")
    try:
        run = cell.load(cell_name, seed, seconds, trace, device, run_dir,
                        t_start)
        run.config = config or run.config
        run.traffic = traffic or run.traffic
        run.workload = workload or run.workload
        run.marks = dict(marks or {})
        out = cell.driver(run.traffic["driver"]).run(run)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    print("setup (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["setup_parts"].items()),
        file=sys.stderr, flush=True)
    bench = cell.benchmark()
    record = dict(out["record"], config=run.config, traffic=run.traffic,
                  e2e=out["e2e"])
    metrics, fields = {}, {}
    if trace:
        for m in cell.per_layer(bench, cell_name):
            value = cell.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = out["record"]["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        fields["breakdown"] = tr.breakdown(t)
    else:
        for m in cell.end_to_end(bench, cell_name):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    fields.update(attempted=out["attempted"], failed=out["failed"],
                  metrics=metrics, device=out["device"])
    return fields, out["checks"], out.get("forbidden", [])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmarks.harness import bytecode

    bytecode.keep_in(ROOT)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    import torch

    marks = {"torch": time.monotonic()}
    from benchmarks.harness import cell, result

    chips = int(cell.entry(cell.benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell asks for {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401  (the program: nothing runs without it)
    marks["program"] = time.monotonic()

    found = result.forbidden_modules()
    print(f"isolation: blocked modules loaded after importing the program: "
          f"{found or 'none'}", file=sys.stderr, flush=True)
    if found:
        return 3
    fields, checks, in_worker = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        T_START, marks=marks)
    found = result.forbidden_modules()
    if found or in_worker:
        print(f"no result: blocked modules loaded: here {found}, in the "
              f"worker {in_worker}", file=sys.stderr)
        return 3
    correct = (all(c["ok"] for c in checks) and fields["failed"] == 0
               and fields["attempted"] > 0)
    result.print_checks(checks)
    print(result.line(correct=correct, checks=checks, **fields), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
