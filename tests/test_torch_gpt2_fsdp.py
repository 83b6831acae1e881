"""GPT-2 under fsdp in ray_tpu_torch against ray_tpu at GPT2_TINY with 4
heads and 4 layers: fsdp alone (2 and 4 ranks, dense f32, flash bf16, remat,
the chunked head) and the MoE at fsdp = 2 and dp = 2 x fsdp = 2.

The port runs as gloo ranks on the CPU (``RankPool``, the pools of
tests/test_torch_gpt2_pp.py), each holding its ``shard_params`` block of
every leaf's "embed" dim (JAX's "embed" → fsdp rule) and its rows of the
batch (the "batch" rule on (dp, fsdp)); each leaf is gathered whole over
fsdp for its use and its gradient reduce-scattered.  Its logits (its rows),
loss, every gradient and the leaves after 3 AdamW steps (whole again
through ``gather_params``) are held against JAX's unsharded model, whose
function GSPMD computes whatever the placement (tests/test_torch_gpt2_tp.py's
``_run``, with its tolerances: ``adam=True``, since the gradients of a cut
leaf are sums over the ranks' rows in another order than JAX's).  bf16
with flash attention runs JAX's Pallas kernels in interpret mode; there the
gathered weights are bf16 and their cotangents are reduce-scattered in
bf16, as the step does on the card.  The MoE cases hold the capacity
binding on every rank (tests/test_torch_gpt2_ep.py's ``_run_moe``) and
``_moe_route``'s choices, positions, keeps and capacity against JAX's
global ones exactly.
"""

import pytest

from test_torch_gpt2_ep import _route_positions_match_jax, _run_moe
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture
from test_torch_gpt2_tp import _run

FSDP_CASES = [({"fsdp": 2}, "f32", "dense", 0, False),
              ({"fsdp": 4}, "f32", "dense", 0, False),
              ({"fsdp": 2}, "bf16", "flash", 0, False),
              ({"fsdp": 2}, "f32", "dense", 0, True),
              ({"fsdp": 2}, "f32", "dense", 4, False)]


@pytest.mark.parametrize(
    "axes,dtype,attention,chunks,remat", FSDP_CASES,
    ids=[f"fsdp{a['fsdp']}-{t}-{d}" + (f"-xent{c}" if c else "")
         + ("-remat" if r else "") for a, d, t, c, r in FSDP_CASES])
def test_fsdp_matches_jax(pool, axes, dtype, attention, chunks, remat):
    """Each rank's logits (its rows), the loss, every gradient (gathered
    over fsdp) and 3 AdamW steps against JAX's unsharded model and optax;
    every leaf's "embed" dim cut over fsdp."""
    _run(pool, axes, dtype, attention, chunks=chunks, remat=remat)


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"dp": 2, "fsdp": 2}],
                         ids=["fsdp2", "dp2-fsdp2"])
def test_fsdp_moe_matches_jax(pool, axes):
    """The MoE (4 experts, tests/test_torch_gpt2_ep.py's capacity factor
    ``CF``, 0.75) with the router and the experts' embed dims on fsdp and
    the tokens spread over the fsdp ranks' rows: against JAX's unsharded
    MoE, f32, with choices dropped at the global capacity on every rank and
    a capacity over a rank's own tokens keeping others."""
    _run_moe(pool, axes)


@pytest.mark.parametrize("case", ["tied_columns", "all_tied"])
@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"dp": 2, "fsdp": 2}],
                         ids=["fsdp2", "dp2-fsdp2"])
def test_fsdp_moe_route_positions_are_jax_global_ones(pool, axes, case,
                                                      monkeypatch):
    """``_moe_route`` on each fsdp rank's rows (its block of the (dp, fsdp)
    blocks, dp major) against JAX's global choices, positions, keeps and
    capacity exactly, with ties forced, as tests/test_torch_gpt2_ep.py holds
    dp and sp (``_route_positions_match_jax``); a rank alone routes
    otherwise."""
    _route_positions_match_jax(pool, axes, case, monkeypatch)
