"""GPT-2's pipeline in ray_tpu_torch against ray_tpu's sequential GPT-2,
where JAX's own pipeline cannot run on the CPU: in bf16 (XLA aborts
compiling the pipelined model: "Invalid binary instruction opcode copy",
hlo_instruction.cc, jax 0.9) and with flash attention (the Pallas forward
inside the pipeline's ``shard_map`` raises a ``check_vma`` error).  The
port's ranks, the JAX runs and the checks are those of
tests/test_torch_gpt2_pp.py; JAX's gradients and parameters are stacked as
the pipeline's (``to_pipeline_params``).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt2 as tg
from test_torch_gpt2_pp import (B, LOGITS_TOL, LOSS_TOL, _cfgs, _check,
                                _jax_train, _np_tree, _rank_rows,
                                _rank_train, _stage_slice, _tokens, STEPS)
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture

# the port's pipelined flash model against JAX's sequential flash model:
# the same per-row arithmetic, and in bf16 each stacked weight's gradient a
# sum of M = 4 bf16 microbatch gradients against one bf16 product over the
# batch (a few bf16 ulps of the largest entry)
FLASH_GRAD_REL = {"f32": 1e-5, "bf16": 5e-2}


BF16_CASES = [({"pp": 2}, 4, 0), ({"pp": 4}, 2, 0),
              ({"dp": 2, "pp": 2}, 2, 4)]


@pytest.mark.parametrize(
    "axes,M,chunks", BF16_CASES,
    ids=["-".join(f"{k}{v}" for k, v in a.items()) + f"-M{m}"
         + (f"-xent{c}" if c else "") for a, m, c in BF16_CASES])
def test_pipelined_bf16_model_matches_jax(pool, axes, M, chunks):
    """bf16, dense attention: as the f32 cases, against JAX's sequential
    model and optax (its gradients and parameters stacked as the
    pipeline's).  JAX's pipelined model does not compile in bf16 on the CPU
    with jax 0.9 (XLA aborts: "Invalid binary instruction opcode copy",
    hlo_instruction.cc); the per-microbatch bf16 sums of the stacked
    weights' gradients stay within GRAD_REL's bf16 bound."""
    import jax

    from ray_tpu.models import gpt2 as jg

    jc, tc = _cfgs("bf16")
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    want = _jax_train(params, jc, M, chunks, axes, pipelined=False)
    n = int(np.prod(list(axes.values())))
    results = pool(n).run(_rank_train, tc, _np_tree(params), _tokens(), axes,
                          M, chunks, STEPS)
    _check(results, want, axes, M, "bf16")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pipelined_flash_matches_jax_sequential_flash(pool, dtype):
    """attention="flash" under pp=2 M=4, which JAX's pipeline cannot run:
    each rank's logits, the loss and every gradient against JAX's
    sequential flash model (Pallas in interpret mode), and against the
    port's own sequential flash model."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    jc, tc = _cfgs(dtype, "flash")
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    tokens = _tokens()
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jloss, jgrads = jax.value_and_grad(lambda p: jg.loss_fn(
        jg._cast_weights(p, jc.compute_dtype), batch, jc))(params)
    want = {"logits": np.asarray(jg.forward(params, batch["tokens"][:, :-1],
                                            jc)),
            "loss": float(jloss),
            "grads": [np.asarray(g, np.float32) for g in jax.tree.leaves(
                jg.to_pipeline_params(jgrads, jc))]}
    # the port's sequential flash model on one rank (this process)
    seq = tg.params_from_numpy(_np_tree(params), tc, device="cpu")
    for leaf in tg.param_leaves(seq):
        leaf.requires_grad_(True)
    with torch.no_grad():
        seq_logits = tg.forward(seq, torch.from_numpy(tokens[:, :-1]),
                                tc).numpy()
    seq_loss = tg.loss_fn(tg._cast_weights(seq, tc.compute_dtype),
                          {"tokens": torch.from_numpy(tokens)}, tc)
    seq_loss.backward()
    seq_grads = [t.numpy() for t in tg.param_leaves(
        tg.to_pipeline_params(_grad_tree(seq), tc))]
    axes, M = {"pp": 2}, 4
    results = pool(2).run(_rank_train, tc, _np_tree(params), tokens, axes,
                          M, 0, 0)
    for r in results:
        rows = _rank_rows(r["where"], axes, M, B)
        for ref_logits, ref_loss, ref_grads in (
                (want["logits"], want["loss"], want["grads"]),
                (seq_logits, seq_loss.item(), seq_grads)):
            np.testing.assert_allclose(r["logits"], ref_logits[rows], rtol=0,
                                       atol=LOGITS_TOL[dtype])
            assert r["loss"] == pytest.approx(ref_loss, rel=LOSS_TOL[dtype])
            for name, g, ref in zip(r["names"], r["grads"], ref_grads):
                ref = _stage_slice(name, ref, r["where"], axes)
                np.testing.assert_allclose(
                    g, ref, rtol=0,
                    atol=FLASH_GRAD_REL[dtype] * np.abs(ref).max(),
                    err_msg=name)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad.float()
