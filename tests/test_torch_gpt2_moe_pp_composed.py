"""GPT-2's mixture of experts under pipeline parallelism with data
parallelism on 8 ranks, in ray_tpu_torch against ray_tpu at GPT2_TINY with
4 experts, 4 heads and 4 layers: pp=2 x dp=2 with the experts on ep=2, with
tensor parallelism tp=2, and with fsdp=2.  Each case is held as
tests/test_torch_gpt2_moe_pp.py holds pp x dp (``_run_moe_pp``: against
JAX's pipelined model placed on the same mesh, the capacity binding on
every rank, the refused grouping's loss at least 100 loss tolerances
away), with its data: the ep and tp ranks of a stage route the same
tokens, the (dp, fsdp) ranks each their block of every global
microbatch.
"""

import pytest

from test_torch_gpt2_moe_pp import _run_moe_pp
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture

MESHES = [{"dp": 2, "pp": 2, "ep": 2}, {"dp": 2, "pp": 2, "tp": 2},
          {"dp": 2, "fsdp": 2, "pp": 2}]


@pytest.mark.parametrize("axes", MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              for a in MESHES])
def test_pipelined_moe_on_8_ranks_matches_jax_pipeline(pool, axes):
    """Each rank's logits, the loss with its aux, every gradient (the
    rank's stage, gathered over ep, tp and fsdp) and 3 AdamW steps against
    JAX's pipelined MoE on the same mesh, M=2, f32."""
    _run_moe_pp(pool, axes, 2)
