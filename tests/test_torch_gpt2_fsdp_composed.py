"""GPT-2 under fsdp composed with data, tensor, sequence and pipeline
parallelism and with the MoE's experts on ep, in ray_tpu_torch against
ray_tpu at GPT2_TINY with 4 heads and 4 layers: dp=2 x fsdp=2, fsdp=2 x
tp=2, fsdp=2 x sp=2 with ring attention, pp=2 x fsdp=2 (M=2, against JAX's
pipelined model placed on the same mesh), the MoE at fsdp=2 x ep=2, and
the 8 ranks of dp=2 x fsdp=2 x tp=2, the mesh of JAX's
``test_gpt2_sharded_train_step``, also against JAX's model placed on that
mesh (its ``shard_params``, GSPMD under ``jit``).

JAX's function is the unsharded model's whatever the fsdp, tp and ep
placement, so each case but the pipeline is held against JAX's model on
the other axes (tests/test_torch_gpt2_tp.py's ``_run``), with the
tolerances of tests/test_torch_gpt2_pp.py.
"""

import numpy as np
import pytest

from test_torch_gpt2_ep import _run_moe
from test_torch_gpt2_pp import (_cfgs, _check, _jax_train, _np_tree,
                                _rank_train, _tokens, STEPS)
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture
from test_torch_gpt2_tp import _run

COMPOSED = [({"dp": 2, "fsdp": 2}, "dense"), ({"fsdp": 2, "tp": 2}, "dense"),
            ({"fsdp": 2, "sp": 2}, "ring")]


@pytest.mark.parametrize("axes,attention", COMPOSED,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              + f"-{t}" for a, t in COMPOSED])
def test_fsdp_composed_matches_jax(pool, axes, attention):
    """Each rank's logits (its rows and positions, the whole vocabulary),
    the loss, every gradient (gathered over fsdp and tp) and 3 AdamW steps
    against JAX, f32."""
    _run(pool, axes, "f32", attention)


def test_pp_fsdp_matches_jax_pipeline(pool):
    """pp=2 x fsdp=2, M=2: each stage's layers cut on fsdp and gathered
    once a step before the schedule; each rank's logits (its stage's part
    of its fsdp block of rows), the loss, every gradient (the rank's stage,
    gathered over fsdp) and 3 AdamW steps against JAX's pipelined model
    with its parameters placed on the same (fsdp, pp) mesh, f32."""
    import jax

    from ray_tpu.models import gpt2 as jg

    axes, M = {"fsdp": 2, "pp": 2}, 2
    jc, tc = _cfgs("f32", n_head=4)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    want = _jax_train(params, jc, M, 0, axes)
    results = pool(4).run(_rank_train, tc, _np_tree(params), _tokens(), axes,
                          M, 0, STEPS)
    _check(results, want, axes, M, "f32", adam=True)


def test_fsdp_moe_with_experts_on_ep_matches_jax(pool):
    """The MoE (4 experts, capacity factor 0.75) at fsdp=2 x ep=2: each
    rank's 2 experts cut on their embed dims too, the tokens spread over
    the fsdp ranks' rows; against JAX's unsharded MoE with choices dropped
    at the global capacity on every rank."""
    _run_moe(pool, {"fsdp": 2, "ep": 2})


def test_dp_fsdp_tp_matches_jax_and_jax_on_the_mesh(pool):
    """dp=2 x fsdp=2 x tp=2: as above against JAX's model over the whole
    batch, and the port's loss and gradients also against JAX's model with
    its parameters placed on the same mesh, f32 (tests/test_torch_gpt2_tp.py's
    tolerances for that)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    params, jc, results = _run(pool, axes, "f32")
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:8])
    batch = {"tokens": jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                                      jcfg.named_sharding(mesh, "batch",
                                                          None))}
    with jax_use_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jg.loss_fn(p, batch, jc)))(jshard(params, jcfg, mesh))
    grads = [np.asarray(g) for g in jax.tree.leaves(grads)]
    for r in results:
        assert r["loss"] == pytest.approx(float(loss), rel=1e-5)
        for name, g, ref in zip(r["names"], r["grads"], grads):
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)
