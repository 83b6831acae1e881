"""GPT-2 under data parallelism in ray_tpu_torch against ray_tpu at
GPT2_TINY with 4 layers: ``ShardingConfig(dp=2)`` alone and composed with
ring sequence parallelism (dp=2 x sp=2), each rank its rows of the batch
(``batch_shard``; under sp also its sequence chunk), held against JAX's
single program over the whole batch (under sp, its model on a (dp, sp)
mesh).  The ranks, the JAX runs and the checks are those of
tests/test_torch_gpt2_pp.py, with their tolerances.
"""

import numpy as np
import pytest

from test_torch_gpt2_pp import (_cfgs, _check, _jax_train, _np_tree,
                                _rank_train, _tokens, STEPS)
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture


DP_CASES = [({"dp": 2}, "dense", "f32"), ({"dp": 4}, "dense", "f32"),
            ({"dp": 2}, "flash", "bf16"), ({"dp": 2, "sp": 2}, "ring", "f32")]


@pytest.mark.parametrize("axes,attention,dtype", DP_CASES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              + f"-{t}-{d}" for a, t, d in DP_CASES])
def test_data_parallel_matches_jax(pool, axes, attention, dtype):
    """Data parallelism alone and composed with ring sp: each rank's logits
    (its rows, its chunk), the loss, every gradient summed over dp (and sp)
    and 3 AdamW steps against JAX's single program over the whole batch
    (ring under sp: JAX's model on a (dp, sp) mesh)."""
    import jax

    from ray_tpu.models import gpt2 as jg

    jc, tc = _cfgs(dtype, attention)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    want = _jax_train(params, jc, 2, 0, axes)
    n = int(np.prod(list(axes.values())))
    results = pool(n).run(_rank_train, tc, _np_tree(params), _tokens(), axes,
                          2, 0, STEPS)
    _check(results, want, axes, 2, dtype)
