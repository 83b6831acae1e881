"""GPT-2's mixture of experts under pipeline parallelism with data
parallelism and fsdp, in ray_tpu_torch against ray_tpu at GPT2_TINY with 4
experts, 4 heads and 4 layers: pp=2 x dp=2 (M = 2 and 4) and pp=2 x fsdp=2
here, the 8 ranks of pp x dp x ep, pp x dp x tp and pp x dp x fsdp in
tests/test_torch_gpt2_moe_pp_composed.py.

The reference's pipeline (ray_tpu/parallel/pipeline.py:103) cuts the
global batch into M microbatches of contiguous rows, and its ``_moe_mlp``
routes each over every dp and fsdp rank's share of it: the capacity counts
the microbatch's B/M S tokens, the slots run in its token order.  The
port's ranks hold ``batch_shard``'s blocks of rows; a pipelined MoE first
takes its block of each global microbatch (``gpt2._to_microbatch_blocks``)
and ``forward`` puts the rows back.  Each case holds the port against JAX's
pipelined model placed on the same mesh (``to_pipeline_params`` +
``shard_params``), f32 with dense attention (tests/test_torch_gpt2_pp.py's
``_jax_train``, ``_check`` and tolerances: loss 1e-5 relative, gradients
1e-5 of their largest, logits on each rank's rows, 3 AdamW steps), with the
capacity factor of tests/test_torch_gpt2_ep.py binding on every rank; and
JAX's loss of the batch reordered so that its microbatches are the
grouping the port refused before (microbatch m = every rank's m-th block of
its own rows) lies at least 100x the loss tolerance away: the test tells
the groupings apart.

To tell them apart the data must make the grouping matter.  At JAX's init
the router's probabilities lie within a few percent of uniform and random
tokens make every grouping of rows alike (the refused grouping's loss lay
6-8x the tolerance away), so each half of the batch draws its tokens from
8 ids of its own (two documents: a microbatch of contiguous rows holds one,
the refused grouping mixes them) and the router's kernel is scaled by 10
(700x).  The bf16 flash case runs JAX's sequential model microbatch by
microbatch (its pipeline aborts in bf16 on the CPU), held by route
agreement and norms as tests/test_torch_gpt2_ep.py holds bf16.  Last, the
reference's own refusal of pp x sp, which the port keeps.

JAX is imported inside the tests: the ranks import this module to find
their functions and must not import JAX.
"""

import numpy as np
import pytest

from test_torch_gpt2_ep import (_jax_routes, _rank_train_routes,
                                GRAD_NORM_REL_BF16, LOGITS_NORM_REL_BF16,
                                LOGITS_TOL_BF16, MOE, ROUTE_AGREE)
from test_torch_gpt2_pp import (_cfgs, _check, _jax_train, _np_tree,
                                _rank_rows, _stage_slice, B, LOSS_TOL, S,
                                STEPS)
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture

#: the router's kernel a multiple of JAX's init (module docstring)
ROUTER_SCALE = 10.0
#: token ids each half of the batch draws from
TOPIC_IDS = 8
#: the refused grouping's loss lies at least this many loss tolerances
#: from JAX's
APART = 100


def _tokens():
    """(B, S+1) tokens: rows [0, B/2) from ids [0, 8), the rest from [256,
    264)."""
    rng = np.random.default_rng(1)
    return np.concatenate([rng.integers(lo, lo + TOPIC_IDS, (B // 2, S + 1))
                           for lo in (0, 256)])


def _params(jc):
    """JAX's init with every router kernel scaled by ROUTER_SCALE."""
    import jax

    from ray_tpu.models import gpt2 as jg

    params = jg.init_params(jax.random.PRNGKey(0), jc)
    for i in range(jc.n_layer):
        router = params[f"h_{i}"]["moe"]["router"]
        router["kernel"] = router["kernel"] * ROUTER_SCALE
    return params


def _refused_order(axes, M):
    """The global rows reordered so that JAX's microbatch m holds every
    (dp, fsdp) rank's m-th block of its own ``batch_shard`` rows."""
    n = axes.get("dp", 1) * axes.get("fsdp", 1)
    return np.arange(B).reshape(n, M, -1).transpose(1, 0, 2).reshape(-1)


def _jax_pipeline_loss(params, jc, M, axes, tokens):
    """JAX's pipelined loss of ``tokens`` on a mesh of ``axes``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:int(np.prod(list(
        axes.values())))])
    staged = jshard(jg.to_pipeline_params(params, jc), jcfg, mesh)
    with jax_use_mesh(mesh):
        return float(jax.jit(lambda p, t: jg.loss_fn(
            p, {"tokens": t}, jc, M))(staged, jnp.asarray(tokens, jnp.int32)))


def _run_moe_pp(pool, axes, M):
    """The MoE on ``axes`` (with pp) against JAX's pipelined model on the
    same mesh, f32: ``_check``'s logits, loss, gradients and steps; every
    rank dropped choices; the refused grouping's loss APART tolerances
    away."""
    jc, tc = _cfgs("f32", n_head=4, **MOE)
    params, tokens = _params(jc), _tokens()
    want = _jax_train(params, jc, M, 0, axes, tokens=tokens)
    results = pool(int(np.prod(list(axes.values())))).run(
        _rank_train_routes, tc, _np_tree(params), tokens, axes, M, 0, STEPS)
    _check(results, want, axes, M, "f32")
    assert all(r["dropped"] > 0 for r in results), [
        r["dropped"] for r in results]
    mine = _jax_pipeline_loss(params, jc, M, axes, tokens)
    assert mine == pytest.approx(want["loss"], rel=LOSS_TOL["f32"])
    refused = _jax_pipeline_loss(params, jc, M, axes,
                                 tokens[_refused_order(axes, M)])
    assert abs(refused - mine) >= APART * LOSS_TOL["f32"] * abs(mine), (
        refused, mine)


MESHES = [({"dp": 2, "pp": 2}, 2), ({"dp": 2, "pp": 2}, 4),
          ({"fsdp": 2, "pp": 2}, 2)]


@pytest.mark.parametrize("axes,M", MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              + f"-M{m}" for a, m in MESHES])
def test_pipelined_moe_over_dp_and_fsdp_matches_jax_pipeline(pool, axes, M):
    """Each rank's logits (its ``batch_shard`` rows, its stage's part), the
    loss with its aux, every gradient (the rank's stage, gathered over
    fsdp) and 3 AdamW steps against JAX's pipelined MoE on the same mesh,
    each global microbatch routed with its own capacity over the ranks."""
    _run_moe_pp(pool, axes, M)


def _jax_by_microbatch(params, jc, tokens, M):
    """JAX's sequential model run microbatch by microbatch, the function of
    its pipeline: the loss (the microbatches' mean, each routed alone),
    its gradients stacked as the pipeline's, the logits of every row, and
    each microbatch's (layer, B/M S, k) expert choices."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    mbs = [jnp.asarray(t, jnp.int32) for t in np.split(tokens, M)]

    def loss(p):
        cast = jg._cast_weights(p, jc.compute_dtype)
        return sum(jg.loss_fn(cast, {"tokens": t}, jc) for t in mbs) / M

    value, grads = jax.value_and_grad(loss)(params)
    logits = np.concatenate([np.asarray(jg.forward(params, t[:, :-1], jc))
                             for t in mbs])
    routes = [_jax_routes(params, np.asarray(t), jc) for t in mbs]
    return {"loss": float(value), "logits": logits, "routes": routes,
            "grads": [np.asarray(g, np.float32) for g in jax.tree.leaves(
                jg.to_pipeline_params(grads, jc))]}


def test_pipelined_moe_bf16_flash_over_dp_matches_jax_by_microbatch(pool):
    """bf16 with flash attention at pp=2 x dp=2, M=2, against JAX's
    sequential model microbatch by microbatch (Pallas interpreted): the
    share of tokens whose choices agree in each (microbatch, stage layer)
    on the rank's block of the microbatch's rows, the logits by norm and by
    the share of tokens within LOGITS_TOL_BF16, the loss as
    tests/test_torch_gpt2_pp.py holds bf16, the gradients per leaf by norm;
    falling losses over the steps and the ranks agreeing bit for bit."""
    axes, M = {"dp": 2, "pp": 2}, 2
    jc, tc = _cfgs("bf16", "flash", n_head=4, **MOE)
    params, tokens = _params(jc), _tokens()
    want = _jax_by_microbatch(params, jc, tokens, M)
    results = pool(4).run(_rank_train_routes, tc, _np_tree(params), tokens,
                          axes, M, 0, STEPS)
    c = jc.n_layer // axes["pp"]
    for r in results:
        rows = _rank_rows(r["where"], axes, M, B)
        ref = want["logits"][rows]
        near = np.abs(r["logits"] - ref).max(-1) <= LOGITS_TOL_BF16
        assert near.mean() >= ROUTE_AGREE
        assert (np.linalg.norm(r["logits"] - ref)
                <= LOGITS_NORM_REL_BF16 * np.linalg.norm(ref))
        assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL["bf16"])
        assert r["losses"][-1] < r["losses"][0] and r["dropped"] > 0
        stage, block = r["where"]["pp"], r["where"]["dp"]
        for m in range(M):
            for j in range(c):
                mine = r["idx"][m * c + j]
                ref = want["routes"][m][stage * c + j].reshape(
                    axes["dp"], -1, mine.shape[-1])[block]
                assert (mine == ref).all(-1).mean() >= ROUTE_AGREE, (m, j)
        for name, g, ref in zip(r["names"], r["grads"], want["grads"]):
            ref = _stage_slice(name, ref, r["where"], axes)
            assert (np.linalg.norm(g - ref)
                    <= GRAD_NORM_REL_BF16 * np.linalg.norm(ref)), name
    for r in results[1:]:
        assert r["loss"] == results[0]["loss"]
        assert r["losses"] == results[0]["losses"]
        if r["where"]["pp"] == results[0]["where"]["pp"]:
            for a, b in zip(r["grads"] + r["params"],
                            results[0]["grads"] + results[0]["params"]):
                np.testing.assert_array_equal(a, b)


SP_MESHES = [{"pp": 2, "sp": 2}, {"dp": 2, "pp": 2, "sp": 2}]


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
@pytest.mark.parametrize("axes", SP_MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              for a in SP_MESHES])
def test_jax_pipeline_refuses_sp(axes, attention):
    """JAX's pipelined GPT2_TINY with ring or Ulysses attention at pp x sp
    raises: the ring's ``shard_map`` nested in the pipeline's is refused
    ("The context mesh ... should match the mesh passed to shard_map"), so
    the port's refusal of pp x sp (tests/test_torch_gpt2_pp.py's
    ``RAISES``) has no reference function to port.  A JAX that computes it
    (or lacks the pipeline's ``jax.lax.pcast``) skips this test, and the
    item reopens."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    if not hasattr(jax.lax, "pcast"):
        pytest.skip("pipeline parallelism needs jax.lax.pcast (newer jax)")
    jc, _ = _cfgs("f32", attention)
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:int(np.prod(list(
        axes.values())))])
    params = jshard(jg.to_pipeline_params(
        jg.init_params(jax.random.PRNGKey(0), jc), jc), jcfg, mesh)
    tokens = jnp.asarray(_tokens(), jnp.int32)
    with jax_use_mesh(mesh):
        try:
            jax.jit(lambda p, t: jg.loss_fn(p, {"tokens": t}, jc, 2))(
                params, tokens)
        except ValueError as e:
            assert "should match the mesh passed to shard_map" in str(e)
            return
    pytest.skip("this JAX computes pipelined GPT-2 under pp x sp: the port "
                "can port it (ROADMAP.md §A11)")
