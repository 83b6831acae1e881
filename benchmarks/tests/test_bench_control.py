"""The control: the reference with every product in float8 must read
well above the program (bf16) on the numbers that decide ``correct``.
On the CPU at a small size; on the card (marked ``cuda``) at the cell's
own size against the cell's limits."""

import tempfile
import time

import pytest

from benchmarks import control
from benchmarks.harness import cell

SMALL = {"n_embd": 64, "n_head": 2, "n_layer": 2, "vocab_size": 512,
         "n_positions": 128}
TRAIN = "gpt2-124m.train-b16-s1024"


def _small_run(name, seed, run_dir):
    run = cell.load(name, seed, 1.0, False, "cpu", run_dir, time.monotonic())
    run.config.update(SMALL)
    run.traffic.update(batch=4, seq_len=128, blocks=64, report_every=2)
    run.workload.update(reference_rows=2)
    return run


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3])
def test_control_separates_from_the_program_small(seed, tmp_path):
    out = control.train_readings(_small_run(TRAIN, seed, str(tmp_path)),
                                 faults=True)
    # the control fails the loss or the first gradient by 3x the program
    assert any(out["control"][k][0] >= 3 * out["program"][k][0]
               for k in ("loss", "grad"))
    assert out["window_steps"] >= 2 and out["window_steps"] % 2 == 0
    assert out["unchanged"]["change"][0] == pytest.approx(1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [TRAIN, "gpt2-xl.train-remat-b16-s1024"])
def test_control_fails_the_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with tempfile.TemporaryDirectory() as d:
        run = cell.load(name, 2 ** 31 + 5, 5.0, False, "cuda", d,
                        time.monotonic())
        out = control.train_readings(run)
    limits = run.workload["limits"]
    compared = [k for k in out["program"] if k in limits]
    assert all(out["program"][k][0] <= limits[k] for k in compared)
    assert any(out["control"][k][0] > limits[k] for k in compared)
