"""The port's counterparts of ``tests/test_train.py`` (6 cases) and
``tests/test_torch_trainer.py`` (3), on the CPU over gloo, on one port
runtime for the module (8 CPUs, under a session root of its own), ending
with the port's leak audit.

``TorchTrainer`` takes ``JaxTrainer``'s role (hunk (l) of
``tests/test_torch_runtime_copy.py``), so each ``JaxTrainer`` case of the
reference runs through it: the workers join one gloo process group
(``parallel.mesh.init_process_group``) where the reference's start
``jax.distributed`` over virtual CPU devices.  The global-mesh bootstrap
becomes a port ``create_mesh({"dp": 2})`` over the two ranks with a
``c10d`` all-reduce; the MNIST loop runs ``models/mnist.py`` with the
port's Adam and averages its gradients with ``torch.distributed``; GPT-2
runs at ``GPT2_TINY`` with fsdp = 2 over the two workers.  Every run writes
its results under ``tmp_path``.  The reference marks its MNIST, GPT-2, DDP
and sklearn cases slow; their counterparts run here.
"""

import os
import shutil

import numpy as np
import pytest
from test_torch_runtime_parity import assert_port_left_nothing

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import ScalingConfig, TorchTrainer

# the fsdp = 2 run's first loss against the unsharded model's, f32 on both
# sides, summed in another order
GPT2_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ray_train():
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


def _mnist_dp_loop(config):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import mnist
    from ray_tpu_torch.rllib import optim
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    params = mnist.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = optim.adam(params, 1e-3)

    start_step = 0
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_dict()
        with torch.no_grad():
            for t, x in zip(optim.tree_leaves(params),
                            optim.tree_leaves(state["params"])):
                t.copy_(x)
        opt.load_state_dict(state["opt_state"])
        start_step = state["step"]

    # Fixed held-out batch for the learning assertion (the reference's
    # reason: per-step train losses are on different random batches)
    eval_batch = mnist.synthetic_batch(torch.Generator().manual_seed(10**6),
                                       batch_size=256, device="cpu")

    for step in range(start_step, config["num_steps"]):
        # Per-worker shard of the global batch (data parallel over workers).
        batch = mnist.synthetic_batch(
            torch.Generator().manual_seed(step * ctx.world_size
                                          + ctx.world_rank),
            batch_size=config["batch_size"] // ctx.world_size, device="cpu")
        loss, acc = mnist.loss_fn(params, batch)
        grads = optim.grads_of(loss, params)
        for g in optim.tree_leaves(grads):
            dist.all_reduce(g)
            g /= ctx.world_size
        optim.apply_gradients(opt, params, grads)
        with torch.no_grad():
            eval_loss = mnist.loss_fn(params, eval_batch)[0].item()
        session.report(
            {"step": step + 1, "loss": eval_loss,
             "train_loss": loss.item(), "acc": acc.item(),
             "rank": ctx.world_rank},
            checkpoint=session.Checkpoint.from_dict({
                "params": params, "opt_state": opt.state_dict(),
                "step": step + 1,
            }) if (step + 1) % config.get("ckpt_every", 10**9) == 0 else None,
        )


def _global_mesh_loop(config):
    """Joins the two workers' ranks into one mesh and runs a c10d
    all-reduce over it."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import c10d
    from ray_tpu_torch.parallel.context import use_mesh
    from ray_tpu_torch.parallel.mesh import create_mesh, mesh_shape
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import get_device

    ctx = session.get_context()
    mesh = create_mesh({"dp": 2}, device_type=get_device().type)
    local = torch.full((4, 8), ctx.world_rank + 1.0)
    with use_mesh(mesh):
        total = c10d.allreduce(local, "dp").sum()
    session.report({
        "world_size": dist.get_world_size(),
        "backend": dist.get_backend(),
        "mesh": mesh_shape(mesh),
        "device": get_device().type,
        "sum": float(total),
    })


def _gpt2_sharded_loop(config):
    """GPT-2 tiny with its parameters cut over fsdp = 2 across the two
    workers."""
    import hashlib
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.context import use_mesh
    from ray_tpu_torch.parallel.sharding import (ShardingConfig, batch_shard,
                                                 gather_params, shard_params)
    from ray_tpu_torch.train import session

    cfg = replace(gpt2.GPT2_TINY, compute_dtype=torch.float32)
    scfg = ShardingConfig(fsdp=2)
    mesh = scfg.build_mesh(device_type="cpu")
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    params = shard_params(params, scfg, mesh)
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    opt = torch.optim.AdamW(gpt2.param_leaves(params), lr=1e-3)
    step_fn = gpt2.make_train_step(cfg, opt)
    with use_mesh(mesh):
        for step in range(config["num_steps"]):
            tokens = torch.randint(0, cfg.vocab_size, (4, 65),
                                   generator=torch.Generator().manual_seed(
                                       step))
            # the global batch's mean on every rank (gpt2.loss_fn)
            loss = step_fn(params, {"tokens": batch_shard(tokens, mesh)})[
                "loss"]
            session.report({"step": step + 1, "loss": loss.item()})
        whole = gather_params(params, scfg, mesh)
    digest = hashlib.sha256(b"".join(
        t.detach().numpy().tobytes() for t in gpt2.param_leaves(whole)
    )).hexdigest()
    digests = [None, None]
    dist.all_gather_object(digests, digest)
    session.report({"step": config["num_steps"], "loss": None,
                    "same_params": digests[0] == digests[1]})


def test_global_mesh_bootstrap(ray_train, tmp_path):
    """2 worker processes join one gloo process group; a mesh over both
    ranks and a collective across it."""
    from ray_tpu_torch.train import RunConfig

    trainer = TorchTrainer(
        _global_mesh_loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mesh", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["world_size"] == 2
    assert result.metrics["backend"] == "gloo"  # no card: gloo
    assert result.metrics["mesh"] == {"dp": 2}
    assert result.metrics["device"] == "cpu"
    # sum of (4x8 of 1.0) + (4x8 of 2.0) = 32 + 64
    assert result.metrics["sum"] == 96.0


def test_mnist_dp_two_workers(ray_train, tmp_path):
    from ray_tpu_torch.train import RunConfig

    trainer = TorchTrainer(
        _mnist_dp_loop,
        train_loop_config={"num_steps": 5, "batch_size": 64, "ckpt_every": 5},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mnist", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 5
    assert len(result.metrics_history) == 5
    assert result.checkpoint is not None
    state = result.checkpoint.to_dict()
    assert state["step"] == 5
    # loss should drop on the synthetic separable data
    assert result.metrics_history[-1]["loss"] < result.metrics_history[0]["loss"]


def test_gpt2_sharded_two_workers(ray_train, tmp_path):
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import RunConfig

    trainer = TorchTrainer(
        _gpt2_sharded_loop,
        train_loop_config={"num_steps": 2},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="gpt2", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["same_params"]  # gathered leaves equal on both
    losses = [m["loss"] for m in result.metrics_history[:2]]
    assert all(np.isfinite(losses))
    # the first step's loss is the unsharded model's on the global batch
    cfg = replace(gpt2.GPT2_TINY, compute_dtype=torch.float32)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 65),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = gpt2.loss_fn(params, {"tokens": tokens}, cfg).item()
    np.testing.assert_allclose(losses[0], want, rtol=GPT2_LOSS_RTOL)


def _crashy_loop(config):
    """Crashes rank 0 once at step 3 (before reporting it); after restart it
    resumes from the checkpoint and completes."""
    import os

    from ray_tpu_torch.train import session

    ctx = session.get_context()
    start = 0
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"]
    marker = config["marker_file"]
    for step in range(start, config["num_steps"]):
        if (step == 3 and ctx.world_rank == 0
                and not os.path.exists(marker)):
            with open(marker, "w") as f:
                f.write("crashed")
            os._exit(1)
        session.report(
            {"step": step + 1, "resumed_from": start},
            checkpoint=session.Checkpoint.from_dict({"step": step + 1}),
        )


def test_worker_crash_restart_from_checkpoint(ray_train, tmp_path):
    from ray_tpu_torch.train import FailureConfig, RunConfig

    marker = str(tmp_path / "crash_marker")
    trainer = TorchTrainer(
        _crashy_loop,
        train_loop_config={"num_steps": 6, "marker_file": marker},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="crashy", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.error is None
    assert os.path.exists(marker), "the crash leg must have run"
    assert result.metrics["step"] == 6
    # restarted leg resumed from the step-2 (or later) checkpoint, not 0
    assert result.metrics["resumed_from"] >= 2
    assert result.checkpoint.to_dict()["step"] == 6


def test_max_failures_exhausted(ray_train, tmp_path):
    from ray_tpu_torch.train import (
        FailureConfig,
        RunConfig,
        TrainingFailedError,
    )

    def always_crash(config):
        import os

        os._exit(1)

    trainer = TorchTrainer(
        always_crash,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="dead", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert isinstance(result.error, TrainingFailedError)


def test_user_error_propagates(ray_train, tmp_path):
    from ray_tpu_torch.train import RunConfig

    def bad_loop(config):
        raise ValueError("boom in train loop")

    trainer = TorchTrainer(
        bad_loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="err", storage_path=str(tmp_path)),
    )
    with pytest.raises(Exception, match="boom in train loop"):
        trainer.fit()


def test_devices_per_worker_raises(ray_train, tmp_path):
    """XLA's virtual devices have no counterpart: the trainer refuses
    ``devices_per_worker`` rather than ignoring it (hunk (l))."""
    from ray_tpu_torch.train import RunConfig

    trainer = TorchTrainer(
        lambda config: None,
        scaling_config=ScalingConfig(num_workers=1, devices_per_worker=4),
        run_config=RunConfig(name="dpw", storage_path=str(tmp_path)),
    )
    with pytest.raises(ValueError, match="devices_per_worker"):
        trainer.fit()


# ---------------------------------------------------------------------------
# tests/test_torch_trainer.py


def _torch_loop(config):
    import torch
    import torch.distributed as dist
    from torch.utils.data import DataLoader, TensorDataset

    from ray_tpu_torch.train.torch import (get_device, prepare_data_loader,
                                           prepare_model)

    torch.manual_seed(0)
    # y = 3x + 1 regression
    xs = torch.linspace(-1, 1, 256).unsqueeze(1)
    ys = 3 * xs + 1
    loader = DataLoader(TensorDataset(xs, ys), batch_size=32, shuffle=False)
    loader = prepare_data_loader(loader)

    model = prepare_model(torch.nn.Linear(1, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss_fn = torch.nn.MSELoss()
    world = dist.get_world_size() if dist.is_initialized() else 1
    for epoch in range(config.get("epochs", 20)):
        if hasattr(loader, "sampler") and hasattr(loader.sampler,
                                                  "set_epoch"):
            loader.sampler.set_epoch(epoch)
        total = 0.0
        for bx, by in loader:
            opt.zero_grad()
            loss = loss_fn(model(bx), by)
            loss.backward()  # DDP all-reduces grads across ranks
            opt.step()
            total += float(loss)
        train.report({"loss": total, "world_size": world,
                      "ddp": type(model).__name__,
                      "device": get_device().type})


def test_torch_trainer_ddp_two_workers(ray_train, tmp_path):
    trainer = TorchTrainer(
        _torch_loop,
        train_loop_config={"epochs": 25},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=train.RunConfig(name="torch_ddp",
                                   storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["world_size"] == 2
    assert result.metrics["ddp"] == "DistributedDataParallel"
    assert result.metrics["device"] == "cpu"  # no chip asked for
    assert result.metrics["loss"] < 0.05


def test_prepare_helpers_no_process_group():
    """Outside a process group the helpers are passthroughs."""
    import torch
    from torch.utils.data import DataLoader, TensorDataset

    from ray_tpu_torch.train.torch import prepare_data_loader, prepare_model

    m = prepare_model(torch.nn.Linear(2, 2))
    assert isinstance(m, torch.nn.Linear)  # no DDP wrap
    dl = DataLoader(TensorDataset(torch.zeros(4, 2)), batch_size=2)
    assert prepare_data_loader(dl) is dl


def test_sklearn_trainer(ray_train, tmp_path):
    """SklearnTrainer fits an estimator on Dataset rows and checkpoints it
    (reference: `python/ray/train/sklearn/sklearn_trainer.py`)."""
    import pandas as pd
    from sklearn.linear_model import LogisticRegression

    from ray_tpu_torch import data
    from ray_tpu_torch.train.sklearn import SklearnTrainer

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    df = pd.DataFrame({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "label": y})
    ds = data.from_pandas(df, parallelism=2)

    result = SklearnTrainer(
        LogisticRegression(),
        label_column="label",
        datasets={"train": ds, "valid": ds},
        cv=3,
    ).fit()
    assert result.metrics["train/score"] > 0.9
    assert result.metrics["cv/mean_test_score"] > 0.85
    model = SklearnTrainer.get_model(result.checkpoint)
    assert model.predict(X[:5]).shape == (5,)


def test_checkpoint_to_host_keeps_host_values():
    """(j) on the host: a ``state_dict``'s tensors are copied with their
    dtype and its ``_metadata`` kept, so an in-place update after
    ``from_dict`` (an optimizer's step counter) does not reach the
    checkpoint; lists and tuples keep their form; numpy arrays pass as
    they are."""
    import torch

    from ray_tpu_torch.air.checkpoint import Checkpoint

    sd = torch.nn.Linear(3, 2).to(torch.bfloat16).state_dict()
    want = {k: v.clone() for k, v in sd.items()}
    step = torch.tensor(5.0)
    arr = np.arange(4)
    state = Checkpoint.from_dict({"model": sd, "seq": [1, (2, step)],
                                  "arr": arr}).to_dict()
    step += 1
    sd["weight"].add_(1)
    assert type(state["model"]) is type(sd)
    assert state["model"]._metadata == sd._metadata
    assert state["model"]["weight"].dtype == torch.bfloat16
    assert all(torch.equal(state["model"][k], v) for k, v in want.items())
    assert state["seq"] == [1, (2, torch.tensor(5.0))]
    assert state["arr"] is arr
