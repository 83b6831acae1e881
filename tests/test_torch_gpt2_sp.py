"""GPT-2 under sequence parallelism (``attention="ring"|"ulysses"``) in
ray_tpu_torch against ray_tpu at GPT2_TINY.

The port runs as gloo ranks on the CPU (``RankPool``, one pool per world
size, kept for the module): rank r holds the r-th chunk of every sequence
(``seq_shard``; a train batch's chunks overlap by the one token that is
both a chunk's last target and the next chunk's first input), runs the
model under ``use_mesh`` on ``ShardingConfig(sp=n).build_mesh()``, and the
train step sums the gradients over the ranks.  The JAX model runs as one
program on a mesh of n virtual CPU devices under its ``use_mesh``: its
forward with the tokens sharded on sp (as tests/test_models.py runs it),
its loss and train step with the batch replicated (a (B, S+1) batch has
no even split; the ring's ``shard_map`` splits the sequence).  Parameters
come from the JAX ``init_params`` and cross as numpy arrays.  The JAX
chunks (S/n = 64 or 32 rows) run the Pallas kernels in interpret mode,
whole-chunk blocks; the port's CPU path runs the kernels' plain versions.

JAX is imported inside the tests: the ranks import this module to find
their functions and must not import JAX.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.parallel.context import use_mesh
from ray_tpu_torch.parallel.launch import RankPool
from ray_tpu_torch.parallel.sharding import ShardingConfig, seq_shard

# the tolerances of tests/test_torch_gpt2.py (logits) and
# tests/test_torch_gpt2_train.py (loss, gradients, AdamW steps), which
# state what each side rounds; the ring's merge of chunk partials adds f32
# rounding only.  Measured on logits of magnitude 1.3-1.9: f32 <= 7.2e-7
# from JAX's; bf16 4.8e-3 from JAX's, and 3.6e-3 between the ring and the
# port's single-rank path (Ulysses equals that path bit for bit here)
LOGITS_TOL = {"f32": 1e-4, "bf16": 2e-2}
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-3}
GRAD_REL = {"f32": 1e-5, "bf16": 5e-2}
STEPS, LR = 3, 1e-3
PARAM_ATOL = {"f32": 5e-5, "bf16": 2 * LR * STEPS}

B, S = 2, 128          # GPT2_TINY's block_size: chunks of 64 or 32
# Ulysses at sp = 4 needs 4 heads: GPT2_TINY's widths with n_head = 4
CFGS = {"tiny": {}, "tiny4h": {"n_head": 4, "n_embd": 128}}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    pools = {}

    def get(n):
        if n not in pools:
            init = tmp_path_factory.mktemp(f"rendezvous{n}") / "init"
            pools[n] = RankPool(n, f"file://{init}", backend="gloo",
                                device="cpu", timeout_s=120.0)
            pools[n].run(_rank_threads, 1)
        return pools[n]

    yield get
    for p in pools.values():
        p.close()


def _tokens(extra=0, seed=0):
    return np.random.default_rng(seed).integers(
        0, tg.GPT2_TINY.vocab_size, (B, S + extra))


def _jax_setup(cfg_name, dtype, attention, n, **kw):
    """(JAX params, JAX config, JAX mesh) and the port's config."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig

    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    fields = {**CFGS[cfg_name], "attention": attention, **kw}
    jc = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, "compute_dtype": jdt,
                          **fields})
    tc = replace(tg.GPT2_TINY, compute_dtype=tdt, **fields)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    mesh = JConfig(sp=n).build_mesh(devices=jax.devices()[:n])
    return params, jc, mesh, tc


def _np_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# rank functions (run in the ranks)
# ---------------------------------------------------------------------------

def _rank_threads(n):
    torch.set_num_threads(n)


def _rank_setup(tc, np_params):
    import torch.distributed as dist

    mesh = ShardingConfig(sp=dist.get_world_size()).build_mesh(
        device_type="cpu")
    params = tg.params_from_numpy(np_params, tc, device="cpu")
    for leaf in tg.param_leaves(params):
        leaf.requires_grad_(True)
    return mesh, params


def _rank_logits(tc, np_params, tokens):
    mesh, params = _rank_setup(tc, np_params)
    chunk = seq_shard(torch.from_numpy(tokens), mesh)
    with use_mesh(mesh), torch.no_grad():
        return tg.forward(params, chunk, tc).numpy()


def _rank_train(tc, np_params, tokens, xent_chunks, steps):
    """(loss, every leaf's gradient summed over the ranks, the losses of
    ``steps`` AdamW steps, every leaf after them)."""
    mesh, params = _rank_setup(tc, np_params)
    batch = {"tokens": seq_shard(torch.from_numpy(tokens), mesh,
                                 overlap=1)}
    with use_mesh(mesh):
        loss = tg.loss_fn(tg._cast_weights(params, tc.compute_dtype), batch,
                          tc, xent_chunks=xent_chunks)
        loss.backward()
        tg._sum_grads(params, tc)
        grads = [t.grad.numpy().copy() for t in tg.param_leaves(params)]
        for t in tg.param_leaves(params):
            t.grad = None
        opt = torch.optim.AdamW(tg.param_leaves(params), lr=LR,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = tg.make_train_step(tc, opt, xent_chunks=xent_chunks)
        losses = [step(params, batch)["loss"].item() for _ in range(steps)]
    return (loss.item(), grads, losses,
            [t.detach().numpy() for t in tg.param_leaves(params)])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

LOGITS_CASES = [("ring", 2, "tiny", "f32"), ("ring", 4, "tiny", "f32"),
                ("ulysses", 2, "tiny", "f32"),
                ("ulysses", 4, "tiny4h", "f32"),
                ("ring", 2, "tiny", "bf16"), ("ulysses", 2, "tiny", "bf16")]


@pytest.mark.parametrize("attention,n,cfg_name,dtype", LOGITS_CASES)
def test_logits_match_jax(pool, attention, n, cfg_name, dtype):
    """Each rank's logits, concatenated along the sequence, against the JAX
    forward under use_mesh with the tokens sharded on sp, and against the
    port's own single-rank flash path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh

    params, jc, mesh, tc = _jax_setup(cfg_name, dtype, attention, n)
    tokens = _tokens()
    spec = NamedSharding(mesh, P(None, "sp"))
    with jax_use_mesh(mesh):
        want = np.asarray(jax.jit(lambda p, t: jg.forward(p, t, jc),
                                  in_shardings=(None, spec))(
            params, jax.device_put(jnp.asarray(tokens, jnp.int32), spec)))
    got = np.concatenate(pool(n).run(_rank_logits, tc, _np_tree(params),
                                     tokens), axis=1)
    assert got.shape == (B, S, tc.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL[dtype])
    flash = tg.forward(tg.params_from_numpy(_np_tree(params), tc, "cpu"),
                       torch.from_numpy(tokens), replace(tc,
                                                         attention="flash"))
    np.testing.assert_allclose(got, flash.numpy(), rtol=0,
                               atol=LOGITS_TOL[dtype])


TRAIN_CASES = [("ring", 2, "tiny", "f32", {}),
               ("ulysses", 2, "tiny", "f32", {}),
               ("ulysses", 4, "tiny4h", "bf16", {}),
               ("ring", 2, "tiny", "f32", {"remat": True}),
               ("ring", 4, "tiny", "bf16", {"xent_chunks": 4})]


@pytest.mark.parametrize(
    "attention,n,cfg_name,dtype,kw", TRAIN_CASES,
    ids=[f"{a}-{n}-{c}-{d}" + "".join(f"-{k}" for k in kw)
         for a, n, c, d, kw in TRAIN_CASES])
def test_loss_grads_and_adamw_steps_match_jax(pool, attention, n, cfg_name,
                                              dtype, kw):
    """loss_fn through _cast_weights and every leaf's gradient summed over
    the ranks against the JAX train step's first loss and gradients (its
    jax.value_and_grad); then 3 AdamW steps of make_train_step against the
    JAX train step with optax.adamw, the ranks' parameters equal bit for
    bit after them.
    ``remat`` and ``xent_chunks`` are set on both sides."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh

    chunks = kw.get("xent_chunks", 0)
    params, jc, mesh, tc = _jax_setup(cfg_name, dtype, attention, n,
                                      remat=kw.get("remat", False))
    tokens = _tokens(extra=1, seed=1)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    adamw = optax.adamw(LR)

    def update(grads, state, p=None):
        updates, inner = adamw.update(grads, state[0], p)
        return updates, (inner, grads)

    # adamw that also keeps the step's gradients in its state, so one
    # compiled JAX train step gives the first loss and gradients (at the
    # initial parameters) and the steps
    opt = optax.GradientTransformation(
        lambda p: (adamw.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    with jax_use_mesh(mesh):
        jstep = jax.jit(jg.make_train_step(jc, opt, xent_chunks=chunks))
        jp, state, jlosses = params, opt.init(params), []
        for i in range(STEPS):
            jp, state, m = jstep(jp, state, batch)
            jlosses.append(float(m["loss"]))
            if i == 0:
                jloss, jgrads = jlosses[0], state[1]

    results = pool(n).run(_rank_train, tc, _np_tree(params), tokens, chunks,
                          STEPS)
    loss, grads, losses, leaves = results[0]
    for other in results[1:]:  # every rank took the same steps
        assert other[0] == loss and other[2] == losses
        for a, b in zip(other[1] + other[3], grads + leaves):
            np.testing.assert_array_equal(a, b)
    assert loss == pytest.approx(float(jloss), rel=LOSS_TOL[dtype])
    names = [n for n, _ in tg.named_leaves(
        tg.params_from_numpy(_np_tree(params), tc, "cpu"))]
    for name, g, ref in zip(names, grads, jax.tree.leaves(jgrads)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=GRAD_REL[dtype] * np.abs(ref).max(),
                                   err_msg=name)
    assert losses == pytest.approx(jlosses, rel=LOSS_TOL[dtype])
    assert losses[-1] < losses[0]
    for name, leaf, ref in zip(names, leaves, jax.tree.leaves(jp)):
        np.testing.assert_allclose(leaf, np.asarray(ref), rtol=0,
                                   atol=PARAM_ATOL[dtype], err_msg=name)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_moe_under_sp_matches_jax(pool, attention):
    """The MoE (4 experts, 4 heads, 4 layers) at sp = 2: each rank routes
    its chunk of every sequence with the capacity, slot positions and aux
    of the global batch; logits, loss, every gradient and 3 AdamW steps
    against JAX's model on an sp mesh, f32, with choices dropped at
    capacity on both ranks (tests/test_torch_gpt2_ep.py's ``_run_moe``)."""
    from test_torch_gpt2_ep import _run_moe

    _run_moe(pool, {"sp": 2}, attention)


def test_sp_attention_needs_a_bound_mesh():
    params = tg.init_params(torch.Generator().manual_seed(0), tg.GPT2_TINY,
                            "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for attention in ("ring", "ulysses"):
        with pytest.raises(RuntimeError, match="no mesh bound"):
            tg.forward(params, tokens, replace(tg.GPT2_TINY,
                                               attention=attention))
