"""GPT-2's mixture of experts on the 8-rank meshes of the reference's own
multi-device MoE checks, in ray_tpu_torch against ray_tpu at GPT2_TINY with
4 experts, 4 heads and 4 layers: pp=2 x ep=2 x tp=2 (config B of
``__graft_entry__.py``, the mesh of JAX's
``test_pipeline_moe_train_step_learns``) and ep=2 x tp=2 x dp=2 (that of
``test_moe_ep_sharded_matches_single_device``), each held against JAX as
tests/test_torch_gpt2_ep.py holds the smaller meshes (``_run_moe``: the
capacity binds on every rank), the latter also against JAX's model placed
on the same mesh.
"""

import numpy as np
import pytest

from test_torch_gpt2_ep import _run_moe
from test_torch_gpt2_pp import _tokens
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture


def test_moe_config_b_matches_jax_pipeline(pool):
    """pp=2 x ep=2 x tp=2, M=2: each rank's logits, the loss with its aux,
    every gradient (the rank's stage, gathered over ep and tp) and 3 AdamW
    steps against JAX's pipelined MoE, f32."""
    _run_moe(pool, {"pp": 2, "ep": 2, "tp": 2})


def test_moe_ep_tp_dp_matches_jax_and_jax_on_the_mesh(pool):
    """ep=2 x tp=2 x dp=2: as above against JAX's model over the whole
    batch, and the port's loss and gradients also against JAX's model with
    its parameters placed on the same mesh (its ``shard_params``, GSPMD
    under ``jit``), f32 (tests/test_torch_gpt2_tp.py's tolerances for
    that)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    axes = {"dp": 2, "ep": 2, "tp": 2}
    params, jc, results = _run_moe(pool, axes)
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:8])
    batch = {"tokens": jnp.asarray(_tokens(), jnp.int32)}
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
