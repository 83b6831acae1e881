"""GPT-2 under tensor parallelism composed with data, sequence and pipeline
parallelism in ray_tpu_torch against ray_tpu at GPT2_TINY with 4 heads and
4 layers: dp=2 x tp=2, tp=2 x sp=2 with ring attention (the shape of
``__graft_entry__.py``'s config A, n_head = tp * sp), pp=2 x tp=2 and the
8 ranks of pp=2 x tp=2 x dp=2 (the mesh of JAX's
``test_pipeline_matches_sequential``), and the MoE (4 experts, the experts'
hidden dim on tp) at tp=2 and pp=2 x tp=2.

JAX's function is the unsharded model's whatever the tp placement, so each
case is held against JAX's model on the other axes
(tests/test_torch_gpt2_tp.py, ``_run``): its ring on an sp mesh, its
single program for dp, its sequential model for the dense pipeline (the
microbatches only reorder the work), and its pipelined model for the MoE
(each microbatch routes with its own capacity).
"""

import pytest

from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture
from test_torch_gpt2_tp import _run

COMPOSED = [({"dp": 2, "tp": 2}, "dense", 2), ({"sp": 2, "tp": 2}, "ring", 2),
            ({"pp": 2, "tp": 2}, "dense", 2),
            ({"dp": 2, "pp": 2, "tp": 2}, "dense", 2)]


@pytest.mark.parametrize("axes,attention,M", COMPOSED,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              + f"-{t}" for a, t, _ in COMPOSED])
def test_tensor_parallel_composed_matches_jax(pool, axes, attention, M):
    """Each rank's logits (its rows and positions, the whole vocabulary),
    the loss, every gradient (stage leaves: the rank's layers, gathered
    over tp) and 3 AdamW steps against JAX, f32."""
    _run(pool, axes, "f32", attention, M)


@pytest.mark.parametrize("axes", [{"tp": 2}, {"pp": 2, "tp": 2}],
                         ids=["tp2", "pp2-tp2"])
def test_tensor_parallel_moe_matches_jax(pool, axes):
    """The MoE (4 experts, aux weight 0.5) with the experts' hidden dim on
    tp: every tp rank routes the same tokens, the expert outputs are summed
    over tp before the combine; against JAX's unsharded MoE at tp=2 and its
    pipelined MoE (M=4) at pp=2 x tp=2."""
    _run(pool, axes, "f32", M=4 if "pp" in axes else 2, moe_experts=4,
         moe_aux_weight=0.5)
