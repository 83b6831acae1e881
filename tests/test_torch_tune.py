"""The port's counterparts of ``tests/test_tune.py``'s 15 cases, on one port
runtime for the module (8 CPUs, under a session root of its own), ending
with the port's leak audit.

``ray_tpu_torch/tune/`` is a copy of ``ray_tpu/tune/`` (hunk (a) alone,
``tests/test_torch_runtime_copy.py``), so each case is the reference's with
the package renamed; ``test_tuner_runs_jax_trainer``'s counterpart runs a
``DataParallelTrainer`` and a ``TorchTrainer`` (gloo, two CPU workers) through
the ``Tuner``.  A reference case marked slow keeps its mark here unless its
counterpart runs in under 10 s on this host: the Train-under-Tune cases
(~5 and ~8 s), the basic variant searcher (~1 s), the median stopping rule
(~3 s) and the URI storage (~3 s) run unmarked.  Every case's results go
under ``tmp_path``.  Two cases are the port's own: a trial that asks for no chip
does not see the card (``CUDA_VISIBLE_DEVICES=""``), and the searchers'
suggestions are the reference's, value for value.
"""

import os
import shutil
import time

import pytest
from test_torch_runtime_parity import assert_port_left_nothing

import ray_tpu_torch
from ray_tpu_torch import tune


@pytest.fixture(scope="module")
def ray():
    """One port runtime for the module, under a session root of its own."""
    from ray_tpu_torch.session_root import new_session_root

    config = ray_tpu_torch.config
    default, config.temp_dir = config.temp_dir, new_session_root()
    try:
        ray_tpu_torch.init(num_cpus=8)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(config.temp_dir, ignore_errors=True)
        config.temp_dir = default


def test_generate_variants_grid_and_sample():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0, 1),
        "arch": {"depth": tune.grid_search([2, 4]), "act": "relu"},
    }
    variants = tune.generate_variants(space, num_samples=3, seed=0)
    assert len(variants) == 2 * 2 * 3
    assert {v["lr"] for v in variants} == {0.1, 0.01}
    assert {v["arch"]["depth"] for v in variants} == {2, 4}
    assert all(v["arch"]["act"] == "relu" for v in variants)
    assert all(0 <= v["wd"] <= 1 for v in variants)
    # deterministic under seed
    again = tune.generate_variants(space, num_samples=3, seed=0)
    assert variants == again


def test_variants_and_searchers_are_the_references():
    """The same seeds give the reference's variants and the searchers'
    suggestions, value for value (both are pure Python on
    ``random.Random``)."""
    from ray_tpu import tune as jtune

    def space(t):
        return {"lr": t.loguniform(1e-4, 1e-1), "n": t.randint(1, 9),
                "act": t.choice(["relu", "tanh"]),
                "x": t.grid_search([1, 2])}

    assert tune.generate_variants(space(tune), num_samples=4, seed=3) == \
        jtune.generate_variants(space(jtune), num_samples=4, seed=3)
    for name in ("BasicVariantGenerator", "TPESearcher"):
        ours, ref = getattr(tune, name)(seed=5), getattr(jtune, name)(seed=5)
        flat = {k: v for k, v in space(tune).items() if k != "x"}
        jflat = {k: v for k, v in space(jtune).items() if k != "x"}
        ours.set_search_properties("s", "max", flat)
        ref.set_search_properties("s", "max", jflat)
        for i in range(12):
            a, b = ours.suggest(f"t{i}"), ref.suggest(f"t{i}")
            assert a == b, (name, i)
            ours.on_trial_complete(f"t{i}", {"s": a["lr"] * a["n"]})
            ref.on_trial_complete(f"t{i}", {"s": b["lr"] * b["n"]})


def test_fn_trainable_grid(ray, tmp_path):
    def objective(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="grid", storage_path=str(tmp_path)),
    ).fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.metrics["score"] == 9
    assert best.config["x"] == 3
    df = grid.get_dataframe()
    assert len(df) == 3 and "config/x" in df.columns


def test_class_trainable_and_stop_criteria(ray, tmp_path):
    class Quad(tune.Trainable):
        def step(self):
            return {"score": self.config["a"] * self.iteration}

    grid = tune.run(
        Quad, config={"a": tune.grid_search([1, 5])},
        metric="score", mode="max",
        stop={"training_iteration": 4},
        storage_path=str(tmp_path), name="quad",
    )
    for r in grid:
        assert r.metrics["training_iteration"] == 4
    assert grid.get_best_result().config["a"] == 5


def test_trainable_error_is_captured(ray, tmp_path):
    def bad(config):
        tune.report({"score": 1})
        raise RuntimeError("exploded")

    grid = tune.run(bad, config={}, num_samples=2, metric="score",
                    storage_path=str(tmp_path), name="bad")
    assert len(grid.errors) == 2


def test_trial_without_a_chip_does_not_see_the_card(ray, tmp_path):
    """A trial asking for CPUs only runs in a CPU worker, which the raylet
    keeps off the card (``CUDA_VISIBLE_DEVICES=""``, hunk (e))."""
    def probe(config):
        import torch

        tune.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "cuda": torch.cuda.is_available()})

    grid = tune.run(probe, config={}, metric="cuda",
                    storage_path=str(tmp_path), name="cpu_trial")
    assert grid[0].metrics["visible"] == ""
    assert grid[0].metrics["cuda"] is False


# slow as in the reference: the cohort must run concurrently, and in 1 of
# 4 runs of this file the worst trial finished before the others reached
# its rung
@pytest.mark.slow
def test_asha_stops_bad_trials_early(ray, tmp_path):
    """Bad trials (low asymptote) must be stopped before max_t while the
    best trial runs to completion."""

    def warmup(config):
        tune.report({"s": 1})

    # Warm 4 workers first: ASHA is async — a solo front-runner that
    # finishes before competitors record any rung can never be judged
    # retroactively, so the test needs all trials actually concurrent
    # (cold worker spawns take seconds and serialize the cohort).
    tune.run(warmup, num_samples=4, metric="s",
             storage_path=str(tmp_path), name="warm")

    def objective(config):
        for i in range(20):
            tune.report({"score": config["cap"] * (i + 1) / 20})
            time.sleep(0.01)

    sched = tune.ASHAScheduler(metric="score", mode="max", max_t=20,
                               grace_period=2, reduction_factor=2)
    grid = tune.Tuner(
        objective,
        param_space={"cap": tune.grid_search([1, 2, 4, 8])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
        run_config=tune.RunConfig(name="asha", storage_path=str(tmp_path)),
    ).fit()
    iters = {r.config["cap"]: r.metrics["training_iteration"] for r in grid}
    assert iters[8] >= 19, f"best trial stopped early: {iters}"
    assert iters[1] < 20, f"worst trial never stopped: {iters}"
    assert grid.get_best_result().config["cap"] == 8


# slow as in the reference (~25 s here)
@pytest.mark.slow
def test_pbt_perturbs_and_exploits(ray, tmp_path):
    """8 trials; only high-lr trials improve. PBT must clone winners into
    losers (checkpoint exploit) and perturb lr."""

    def objective(config):
        ckpt = tune.get_checkpoint()
        total = ckpt.to_dict()["total"] if ckpt is not None else 0.0
        lr = config["lr"]
        for _ in range(40):
            total += lr
            tune.report({"score": total},
                        checkpoint={"total": total, "lr_seen": lr})

    # quantile 0.5: under the controller's lockstep event order a trial's
    # cohort siblings sit at t-1 (lower score) at its own check, so a
    # narrow bottom-quantile would be order-dependent in this synthetic
    # setup (real workloads have timing noise).
    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=5,
        hyperparam_mutations={"lr": tune.uniform(0.1, 10.0)},
        quantile_fraction=0.5, seed=7,
    )
    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search(
            [0.1, 0.1, 0.1, 0.1, 5.0, 5.0, 5.0, 5.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    stop={"training_iteration": 30},
                                    max_concurrent_trials=8),
        run_config=tune.RunConfig(name="pbt", storage_path=str(tmp_path)),
    ).fit()
    assert sched.num_perturbations >= 1, "PBT never exploited"
    final_scores = [r.metrics["score"] for r in grid]
    assert max(final_scores) > 100  # 5.0-ish lr for 30 steps
    # exploited trials restarted from donor checkpoints with perturbed
    # configs: their final lr must have moved off the 0.1 floor and their
    # totals reflect the donor's high-lr history
    exploited = [r for r in grid
                 if abs(r.config.get("lr", 0) - 0.1) > 1e-9
                 and r.metrics["score"] > 30 * 0.1 * 2]
    assert len(exploited) >= 5, (
        f"exploitation did not spread: "
        f"{[(r.config, r.metrics['score']) for r in grid]}")


def test_experiment_state_and_restore(ray, tmp_path):
    def objective(config):
        for i in range(5):
            tune.report({"score": config["x"] * (i + 1)},
                        checkpoint={"i": i})

    path = str(tmp_path / "exp")
    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="exp", storage_path=str(tmp_path)),
    ).fit()
    assert len(grid) == 2
    assert tune.Tuner.can_restore(path)
    state_file = os.path.join(path, "experiment_state.json")
    assert os.path.exists(state_file)
    # restore: everything terminated -> results preserved without re-running
    grid2 = tune.Tuner.restore(path, objective).fit()
    assert len(grid2) == 2
    assert grid2.get_best_result("score", "max").metrics["score"] == 10


def _loop_without_a_group(config):
    from ray_tpu_torch.train import session

    lr = config.get("lr", 0.1)
    loss = 10.0
    for _ in range(3):
        loss *= (1 - lr / 10)
        session.report({"loss": loss})


def _torch_loop(config):
    """One gloo rank: a least-squares step of size ``lr`` a report, its
    gradient all-reduced over the process group."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import get_device

    w = torch.zeros(2, device=get_device())
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    y = torch.tensor([1.0, 1.0])
    for _ in range(3):
        w.requires_grad_(True)
        loss = ((x @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, w)
        dist.all_reduce(g)
        w = (w - config["lr"] * g / dist.get_world_size()).detach()
        session.report({"loss": loss.item(),
                        "backend": dist.get_backend()})


@pytest.mark.parametrize("trainer", ["DataParallelTrainer", "TorchTrainer"])
def test_tuner_runs_jax_trainer(ray, tmp_path, trainer):
    """Train-under-Tune: a trainer's ``as_trainable()`` through the Tuner —
    the reference's ``DataParallelTrainer`` case as it stands, and
    ``TorchTrainer`` in ``JaxTrainer``'s place on two CPU workers (gloo)."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import RunConfig, TorchTrainer
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    run_config = RunConfig(name="inner", storage_path=str(tmp_path))
    if trainer == "TorchTrainer":
        trainer = TorchTrainer(
            _torch_loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=run_config)
        space = [0.005, 0.01]
    else:
        trainer = DataParallelTrainer(
            _loop_without_a_group,
            scaling_config=ScalingConfig(num_workers=1),
            run_config=run_config)
        space = [0.5, 1.0]
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search(space)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
        run_config=tune.RunConfig(name="t_under_t",
                                  storage_path=str(tmp_path)),
    ).fit()
    assert not grid.errors
    best = grid.get_best_result()
    assert best.config["lr"] == space[1]
    assert best.metrics["loss"] < 10
    if isinstance(trainer, TorchTrainer):
        assert best.metrics["backend"] == "gloo"
    assert not os.path.exists(os.path.expanduser(
        "~/ray_tpu_torch_results/t_under_t"))


def test_class_trainable_checkpoints_collected(ray, tmp_path):
    """Class trainables' save_checkpoint must flow into trial state (PBT
    exploitation and Result.checkpoint depend on it)."""

    class Counting(tune.Trainable):
        def setup(self, config):
            self.total = 0

        def step(self):
            self.total += 1
            return {"score": self.total}

        def save_checkpoint(self):
            return {"total": self.total}

        def load_checkpoint(self, data):
            self.total = data["total"]

    grid = tune.run(Counting, config={}, metric="score", mode="max",
                    stop={"training_iteration": 3},
                    storage_path=str(tmp_path), name="ckpt_cls")
    r = grid[0]
    assert r.checkpoint is not None
    assert r.checkpoint.to_dict()["total"] == 3


def test_class_trainable_iteration_survives_restart(ray, tmp_path):
    """training_iteration must continue across a failure restart (it
    travels with the checkpoint)."""

    class Flaky(tune.Trainable):
        def setup(self, config):
            self.total = 0
            self.restored = False

        def step(self):
            self.total += 1
            if self.total == 3 and not self.restored:
                raise RuntimeError("transient failure at step 3")
            return {"score": self.total}

        def save_checkpoint(self):
            return {"total": self.total}

        def load_checkpoint(self, data):
            self.total = data["total"]
            self.restored = True

    from ray_tpu_torch.air.config import FailureConfig

    grid = tune.Tuner(
        Flaky, param_space={},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    stop={"training_iteration": 5}),
        run_config=tune.RunConfig(
            name="flaky", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=2)),
    ).fit()
    r = grid[0]
    assert r.error is None, f"trial errored: {r.error}"
    assert r.metrics["training_iteration"] == 5
    assert r.metrics["score"] == 5


# slow as in the reference (~18 s here)
@pytest.mark.slow
def test_tpe_searcher_improves_over_random(ray, tmp_path):
    """TPESearcher (reference: the hyperopt/BOHB model family in
    `tune/search/`): later suggestions concentrate near the optimum of a
    1-D quadratic once the model kicks in."""

    def objective(config):
        x = config["x"]
        tune.report({"score": -(x - 3.0) ** 2})

    searcher = tune.TPESearcher(n_initial_points=6, seed=0)
    grid = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(-10.0, 10.0)},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    num_samples=24, search_alg=searcher,
                                    max_concurrent_trials=1),
        run_config=tune.RunConfig(name="tpe", storage_path=str(tmp_path)),
    ).fit()
    assert len(grid) == 24
    xs = [r.config["x"] for r in grid]
    early = xs[:6]
    late = xs[-8:]
    err = lambda vals: sum(abs(v - 3.0) for v in vals) / len(vals)  # noqa: E731
    assert err(late) < err(early), (early, late)
    assert grid.get_best_result().metrics["score"] > -1.0


def test_basic_variant_searcher(ray, tmp_path):
    def objective(config):
        tune.report({"score": config["x"]})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=5,
            search_alg=tune.BasicVariantGenerator(seed=1)),
        run_config=tune.RunConfig(name="bv", storage_path=str(tmp_path)),
    ).fit()
    assert len(grid) == 5
    assert all(0 <= r.config["x"] <= 1 for r in grid)


def test_median_stopping_rule(ray, tmp_path):
    """Bad trials stop early; good ones run to completion (reference:
    `tune/schedulers/median_stopping_rule.py`)."""

    def objective(config):
        for i in range(12):
            tune.report({"score": config["level"] + i * 0.01})

    grid = tune.Tuner(
        objective,
        param_space={"level": tune.grid_search(
            [10.0, 10.0, 10.0, 0.0, 0.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.MedianStoppingRule(
                metric="score", grace_period=3, min_samples_required=2)),
        run_config=tune.RunConfig(name="msr", storage_path=str(tmp_path)),
    ).fit()
    # the two level-0 trials stopped before the 10s finished
    low = [r.metrics["training_iteration"] for r in grid
           if r.config["level"] == 0.0]
    high = [r.metrics["training_iteration"] for r in grid
            if r.config["level"] == 10.0]
    assert max(low) < 12
    assert max(high) == 12


def test_uri_storage_sync_and_restore(ray, tmp_path, monkeypatch):
    """A file:// storage_path mirrors the experiment dir through the
    Syncer (reference: `tune/syncer.py:24-115`), and Tuner.restore(uri)
    syncs it back down (under ``~/ray_tpu_torch_results/_synced``, hunk
    (a); ``HOME`` is the test's) and resumes."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))

    def objective(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)},
                        checkpoint={"i": i})

    bucket = tmp_path / "bucket"
    uri = f"file://{bucket}"
    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="synced", storage_path=uri),
    ).fit()
    assert len(grid) == 2
    # the remote mirror holds the full experiment state
    assert (bucket / "synced" / "experiment_state.json").exists()
    trial_dirs = [p for p in (bucket / "synced").iterdir() if p.is_dir()]
    assert len(trial_dirs) == 2
    # restore FROM THE URI (local staging dir, then normal restore)
    grid2 = tune.Tuner.restore(f"{uri}/synced", objective).fit()
    assert len(grid2) == 2
    assert grid2.get_best_result("score", "max").metrics["score"] == 6
    staged = tmp_path / "home" / "ray_tpu_torch_results" / "_synced"
    # the run's local mirror and the restore's staging, both under HOME
    assert {p.name.split("-")[0] for p in staged.iterdir()} == {"synced"}
    assert any("-" in p.name for p in staged.iterdir())


class _HillClimbOptimizer:
    """Deterministic ask/tell optimizer: random warmup, then gaussian
    refinement around the best seen — the duck-typed 'plain' protocol of
    AskTellSearcher."""

    def __init__(self, seed=0, warmup=4):
        import random as _random

        self._rng = _random.Random(seed)
        self._warmup = warmup
        self._seen = []  # (score, config)

    def ask(self, space):
        if len(self._seen) < self._warmup or not self._seen:
            return {k: dom.sample(self._rng) for k, dom in space.items()}
        best = max(self._seen)[1]
        out = {}
        for k, dom in space.items():
            if hasattr(dom, "lower") and isinstance(best.get(k), float):
                span = (dom.upper - dom.lower) * 0.15
                v = best[k] + self._rng.gauss(0.0, span)
                out[k] = min(dom.upper, max(dom.lower, v))
            else:
                out[k] = dom.sample(self._rng)
        return out

    def tell(self, config, score):
        self._seen.append((score, dict(config)))


# slow as in the reference: ~9 s here, and the guided run's order
# depends on which of its 4 concurrent trials report first
@pytest.mark.slow
def test_ask_tell_searcher_beats_random(ray, tmp_path):
    """The ask/tell adapter (reference: optuna_search.py integration
    seam) feeds results back into the optimizer; on a seeded quadratic
    surface the model-guided search beats pure random at equal budget."""

    def objective(config):
        x = config["x"]
        tune.report({"score": -(x - 0.7) ** 2})

    space = {"x": tune.uniform(0.0, 1.0)}
    budget = 24

    guided = tune.Tuner(
        objective, param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=budget,
            max_concurrent_trials=4,
            search_alg=tune.AskTellSearcher(_HillClimbOptimizer(seed=5))),
        run_config=tune.RunConfig(name="guided",
                                  storage_path=str(tmp_path)),
    ).fit()
    random_grid = tune.Tuner(
        objective, param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=budget, seed=5,
            search_alg=tune.BasicVariantGenerator(seed=5)),
        run_config=tune.RunConfig(name="rand",
                                  storage_path=str(tmp_path)),
    ).fit()
    best_guided = guided.get_best_result().metrics["score"]
    best_random = random_grid.get_best_result().metrics["score"]
    assert best_guided >= best_random, (best_guided, best_random)
    assert best_guided > -0.003  # converged near the optimum
