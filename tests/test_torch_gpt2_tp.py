"""GPT-2 under tensor parallelism in ray_tpu_torch against ray_tpu at
GPT2_TINY with 4 heads and 4 layers: tp alone (2 and 4 ranks, dense f32,
flash bf16, the chunked head, remat).

The port runs as gloo ranks on the CPU (``RankPool``, the pools of
tests/test_torch_gpt2_pp.py), each holding its ``shard_params`` shard of
the heads, the FFN and the vocabulary; its logits (gathered over tp), loss,
every gradient and the leaves after 3 AdamW steps (whole again through
``gather_params``) are held against JAX's unsharded model: GSPMD computes
the unsharded model's function whatever the placement.  bf16 with flash
attention runs JAX's Pallas kernels in interpret mode, as its own tests do
on the CPU.  One case also holds the port against JAX's model placed on the
same tp mesh (``shard_params`` and ``jit``).  The ranks, the JAX runs and
the checks (every replicated leaf and gradient bit-equal across the ranks)
are those of tests/test_torch_gpt2_pp.py, with their tolerances.
"""

import numpy as np
import pytest

from test_torch_gpt2_pp import (_cfgs, _check, _jax_train, _np_tree,
                                _rank_train, _tokens, STEPS)
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture


def _run(pool, axes, dtype, attention="dense", M=2, chunks=0,
         jax_axes=None, rank_fn=_rank_train, **cfg):
    """The port on ``axes`` (each rank running ``rank_fn``, ``_rank_train``
    or one that returns what it does) against JAX's model on ``jax_axes``
    (the axes without tp and ep by default: JAX's function is the
    unsharded model's)."""
    import jax

    from ray_tpu.models import gpt2 as jg

    jc, tc = _cfgs(dtype, attention, n_head=4, **cfg)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    if jax_axes is None:
        jax_axes = {a: n for a, n in axes.items() if a not in ("tp", "ep")}
    pipelined = "pp" in jax_axes and cfg.get("moe_experts", 0) > 0
    want = _jax_train(params, jc, M, chunks, jax_axes, pipelined)
    n = int(np.prod(list(axes.values())))
    results = pool(n).run(rank_fn, tc, _np_tree(params), _tokens(), axes,
                          M, chunks, STEPS)
    _check(results, want, axes, M, dtype, adam=True)
    return params, jc, results


TP_CASES = [({"tp": 4}, "f32", "dense", 0, False),
            ({"tp": 2}, "bf16", "flash", 0, False),
            ({"tp": 2}, "f32", "dense", 4, False),
            ({"tp": 2}, "f32", "dense", 0, True)]


@pytest.mark.parametrize(
    "axes,dtype,attention,chunks,remat", TP_CASES,
    ids=[f"tp{a['tp']}-{t}-{d}" + (f"-xent{c}" if c else "")
         + ("-remat" if r else "") for a, d, t, c, r in TP_CASES])
def test_tensor_parallel_matches_jax(pool, axes, dtype, attention, chunks,
                                     remat):
    """Each rank's logits (the whole vocabulary), the loss, every gradient
    (gathered over tp) and 3 AdamW steps against JAX's unsharded model and
    optax; the heads, FFN columns and vocabulary rows cut over tp."""
    _run(pool, axes, dtype, attention, chunks=chunks, remat=remat)


def test_tensor_parallel_matches_jax_and_jax_on_the_tp_mesh(pool):
    """tp = 2, dense, f32, as the cases above, and the port's loss and
    gradients also against JAX's model with its parameters placed on the
    same tp mesh (its ``shard_params``, GSPMD under ``jit``)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    params, jc, results = _run(pool, {"tp": 2}, "f32")
    jcfg = JConfig(tp=2)
    mesh = jcfg.build_mesh(devices=jax.devices()[:2])
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
