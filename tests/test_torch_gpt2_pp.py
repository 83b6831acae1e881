"""GPT-2 under pipeline and data parallelism in ray_tpu_torch against
ray_tpu at GPT2_TINY with 4 layers.

The port runs as gloo ranks on the CPU (``RankPool``, one pool per world
size, kept for the module) on a mesh of ``ShardingConfig(dp=, pp=, sp=)``:
each rank takes its rows of the batch (``batch_shard``; under sp also its
sequence chunk, ``seq_shard``), and under pp its stage of
``to_pipeline_params``'s tree (``shard_params``).  The JAX model runs as
one program on as many virtual CPU devices: its pipelined model
(``to_pipeline_params`` + ``shard_params`` on a ``ShardingConfig(dp=, pp=)``
mesh, ``pp_microbatches``) with dense attention, the only attention its
pipeline runs on jax 0.9 (the Pallas forward inside ``shard_map`` raises a
``check_vma`` error); its sequential model for data parallelism alone and
for the port's pipeline with flash attention, which JAX's pipeline cannot
run.  Parameters come from the JAX ``init_params`` and cross as numpy
arrays; the JAX train step records its first gradients in the optimizer's
state, as tests/test_torch_gpt2_sp.py does.

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
from ray_tpu_torch.parallel.sharding import (ShardingConfig, batch_shard,
                                             gather_params, seq_shard,
                                             shard_params)

# the tolerances of tests/test_torch_gpt2_sp.py (which states what each side
# rounds): the pipeline only reorders the work per microbatch.  In bf16 the
# stacked weights' gradients are sums of the microbatches' bf16 gradients on
# both sides (JAX's scan over ticks, the port's reverse schedule).
LOGITS_TOL = {"f32": 1e-4, "bf16": 2e-2}
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-3}
GRAD_REL = {"f32": 1e-5, "bf16": 5e-2}
STEPS, LR = 3, 1e-3
PARAM_ATOL = {"f32": 5e-5, "bf16": 2 * LR * STEPS}
#: AdamW's eps (torch's and optax's default)
ADAM_EPS = 1e-8
B, S = 8, 64


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


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(
        0, tg.GPT2_TINY.vocab_size, (B, S + 1))


def _cfgs(dtype, attention="dense", **kw):
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    fields = {"n_layer": 4, "attention": attention, **kw}
    jc = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, "compute_dtype": jdt,
                          **fields})
    return jc, replace(tg.GPT2_TINY, compute_dtype=tdt, **fields)


def _np_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


def _recording_adamw():
    """optax.adamw that also keeps the step's gradients in its state, so
    one compiled JAX train step gives the first loss and gradients (at the
    initial parameters) and the steps."""
    import jax
    import jax.numpy as jnp
    import optax

    adamw = optax.adamw(LR)

    def update(grads, state, p=None):
        updates, inner = adamw.update(grads, state[0], p)
        return updates, (inner, grads)

    return optax.GradientTransformation(
        lambda p: (adamw.init(p), jax.tree.map(jnp.zeros_like, p)), update)


def _jax_train(params, jc, M, xent_chunks, axes, pipelined=True,
               tokens=None):
    """JAX's first loss and gradients, the losses of STEPS steps and the
    parameters after them, and its logits: pipelined on a (dp, pp) mesh
    when ``axes`` has pp and ``pipelined``, else one program over the whole
    batch (its gradients and parameters then stacked as the pipeline's).
    ``tokens``: the (B, S+1) batch, ``_tokens()`` by default."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.context import use_mesh as jax_use_mesh
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    tokens = _tokens() if tokens is None else tokens
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    opt = _recording_adamw()
    n = int(np.prod(list(axes.values())))
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:n])
    stack = "pp" in axes and not pipelined
    if "pp" in axes and pipelined:
        params = jshard(jg.to_pipeline_params(params, jc), jcfg, mesh)
    elif stack:
        mesh = JConfig().build_mesh(devices=jax.devices()[:1])
    with jax_use_mesh(mesh):
        logits = np.asarray(jax.jit(lambda p, t: jg.forward(
            p, t, jc, None, M))(params, batch["tokens"][:, :-1]))
        jstep = jax.jit(jg.make_train_step(jc, opt, M, xent_chunks))
        jp, state, losses = params, opt.init(params), []
        for i in range(STEPS):
            jp, state, m = jstep(jp, state, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = state[1]
    if stack:
        grads, jp = (jg.to_pipeline_params(t, jc) for t in (grads, jp))
    return {"logits": logits, "loss": losses[0], "losses": losses,
            "grads": [np.asarray(g, np.float32)
                      for g in jax.tree.leaves(grads)],
            "params": [np.asarray(p) for p in jax.tree.leaves(jp)]}


# ---------------------------------------------------------------------------
# rank functions (run in the ranks)
# ---------------------------------------------------------------------------

def _rank_threads(n):
    torch.set_num_threads(n)


def _rank_setup(tc, np_params, axes, tokens):
    """The rank's mesh, master parameters (its stage under pp, its shards
    under tp) and batch, and its (dp, pp, sp, tp) indices."""
    config = ShardingConfig(**axes)
    mesh = config.build_mesh(device_type="cpu")
    params = tg.params_from_numpy(np_params, tc, device="cpu")
    if "pp" in axes:
        params = tg.to_pipeline_params(params, tc)
    params = shard_params(params, config, mesh)
    for leaf in tg.param_leaves(params):
        leaf.requires_grad_(True)
    batch = batch_shard(torch.from_numpy(tokens), mesh)
    if "sp" in axes:
        batch = seq_shard(batch, mesh, overlap=1)
    where = {a: mesh.get_local_rank(a) for a in axes}
    return mesh, params, {"tokens": batch}, where


def _grad_tree(params):
    if isinstance(params, dict):
        return {k: _grad_tree(v) for k, v in params.items()}
    return params.grad


def _rank_train(tc, np_params, tokens, axes, M, xent_chunks, steps):
    """The rank's logits, loss, every leaf's gradient summed as the train
    step sums them, the losses of ``steps`` AdamW steps, every leaf after
    them (gradients and leaves whole over tp: ``gather_params``), and where
    the rank sits on the mesh."""
    mesh, params, batch, where = _rank_setup(tc, np_params, axes, tokens)
    config = ShardingConfig(**axes)
    with use_mesh(mesh):
        with torch.no_grad():
            logits = tg.forward(params, batch["tokens"][:, :-1], tc, None,
                                M).numpy()
        loss = tg.loss_fn(tg._cast_weights(params, tc.compute_dtype), batch,
                          tc, M, xent_chunks)
        loss.backward()
        tg._sum_grads(params, tc)
        grads = [t.numpy().copy() for t in tg.param_leaves(
            gather_params(_grad_tree(params), config, mesh))]
        for t in tg.param_leaves(params):
            t.grad = None
        opt = torch.optim.AdamW(tg.param_leaves(params), lr=LR,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = tg.make_train_step(tc, opt, M, xent_chunks)
        losses = [step(params, batch)["loss"].item() for _ in range(steps)]
        whole = gather_params(params, config, mesh)
    return {"logits": logits, "loss": loss.item(), "grads": grads,
            "losses": losses, "where": where,
            "params": [t.detach().numpy() for t in tg.param_leaves(whole)],
            "names": [n for n, _ in tg.named_leaves(params)]}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _rank_rows(where, axes, M, n_rows):
    """The global rows a rank's logits hold: its block of the "batch" rule's
    (dp, fsdp) blocks, dp major, and under pp its stage's part of them."""
    n_fsdp = axes.get("fsdp", 1)
    block = where.get("dp", 0) * n_fsdp + where.get("fsdp", 0)
    rows = np.arange(n_rows).reshape(axes.get("dp", 1) * n_fsdp, -1)[block]
    n_pp = axes.get("pp", 1)
    if n_pp > 1 and M % n_pp == 0:
        rows = rows.reshape(n_pp, -1)[where["pp"]]
    return rows


def _stage_slice(name, ref, where, axes):
    """The rank's part of a global (stacked) leaf."""
    n_pp = axes.get("pp", 1)
    if name.startswith("blocks/") and n_pp > 1:
        return ref.reshape(n_pp, -1, *ref.shape[1:])[where["pp"]]
    return ref


def _param_atol(dtype, ref_grad, grad_atol, adam):
    """The tolerance of the leaves after the steps.  With ``adam``, each
    element's also takes AdamW's amplification of the gradient's
    tolerance: a gradient error d at an element whose gradient is g moves
    its step by up to LR d / (|g| + eps), 2 LR at most, so where |g| is
    near eps the step is set by the rounding of g on either side.  For
    summation orders that differ from JAX's (tp's partial products)."""
    if not adam:
        return PARAM_ATOL[dtype]
    return PARAM_ATOL[dtype] + STEPS * LR * np.minimum(
        2.0, grad_atol / (np.abs(ref_grad) + ADAM_EPS))


def _check(results, want, axes, M, dtype, grad_rel=None, adam=False):
    """Each rank against JAX (``want``, global), and the ranks against one
    another: one loss on every rank, each leaf and its gradient (whole over
    tp) equal bit for bit on every rank that holds it.  ``adam``: the
    leaves after the steps within ``_param_atol``'s AdamW term too."""
    grad_rel = grad_rel or GRAD_REL[dtype]
    for r in results:
        cols = slice(None)
        if axes.get("sp", 1) > 1:
            c = S // axes["sp"]
            cols = slice(r["where"]["sp"] * c, (r["where"]["sp"] + 1) * c)
        rows = _rank_rows(r["where"], axes, M, B)
        np.testing.assert_allclose(r["logits"], want["logits"][rows][:, cols],
                                   rtol=0, atol=LOGITS_TOL[dtype])
        assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL[dtype])
        assert r["losses"] == pytest.approx(want["losses"],
                                            rel=LOSS_TOL[dtype])
        assert r["losses"][-1] < r["losses"][0]
        for name, g, ref, leaf, p in zip(r["names"], r["grads"],
                                         want["grads"], r["params"],
                                         want["params"]):
            ref = _stage_slice(name, ref, r["where"], axes)
            grad_atol = grad_rel * np.abs(ref).max()
            np.testing.assert_allclose(g, ref, rtol=0, atol=grad_atol,
                                       err_msg=name)
            diff = np.abs(leaf - _stage_slice(name, p, r["where"], axes))
            over = diff - _param_atol(dtype, ref, grad_atol, adam)
            assert (over <= 0).all(), (name, diff.max(), over.max())
    for r0 in results:
        for r in results:
            assert r["loss"] == r0["loss"] and r["losses"] == r0["losses"]
            same_stage = r["where"].get("pp") == r0["where"].get("pp")
            for name, a, b, ga, gb in zip(r["names"], r["params"],
                                          r0["params"], r["grads"],
                                          r0["grads"]):
                if same_stage or not name.startswith("blocks/"):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                    np.testing.assert_array_equal(ga, gb, err_msg=name)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

PP_CASES = [({"pp": 2}, 4, "f32", 0), ({"pp": 4}, 2, "f32", 0),
            ({"pp": 4}, 8, "f32", 0), ({"dp": 2, "pp": 2}, 2, "f32", 0),
            ({"pp": 2}, 4, "f32", 4)]


@pytest.mark.parametrize(
    "axes,M,dtype,chunks", PP_CASES,
    ids=["-".join(f"{k}{v}" for k, v in a.items()) + f"-M{m}-{d}"
         + (f"-xent{c}" if c else "") for a, m, d, c in PP_CASES])
def test_pipelined_model_matches_jax_pipeline(pool, axes, M, dtype, chunks):
    """Each rank's logits (its rows; all rows of its replica when M % pp !=
    0), the loss, every leaf's gradient (stage leaves: the rank's layers)
    and 3 AdamW steps against JAX's pipelined model and optax, dense
    attention."""
    import jax

    from ray_tpu.models import gpt2 as jg

    jc, tc = _cfgs(dtype)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    want = _jax_train(params, jc, M, chunks, axes)
    n = int(np.prod(list(axes.values())))
    results = pool(n).run(_rank_train, tc, _np_tree(params), _tokens(), axes,
                          M, chunks, STEPS)
    _check(results, want, axes, M, dtype)


def test_pipelined_moe_matches_jax_pipeline(pool):
    """MoE (4 experts, aux weight 0.5) at pp=2 M=4: each microbatch routes
    with the capacity of its own tokens on both sides, and the aux rides
    the stage handoff; the loss with its aux, every gradient and 3 steps
    against JAX's pipelined MoE (not the sequential model, which routes
    over the whole batch)."""
    import jax

    from ray_tpu.models import gpt2 as jg

    jc, tc = _cfgs("f32", moe_experts=4, moe_aux_weight=0.5)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    axes, M = {"pp": 2}, 4
    want = _jax_train(params, jc, M, 0, axes)
    results = pool(2).run(_rank_train, tc, _np_tree(params), _tokens(), axes,
                          M, 0, STEPS)
    _check(results, want, axes, M, "f32")


#: the mesh of each case of ``_rank_raises``
RAISE_AXES = {"pp_ring": {"pp": 2}, "pp_ulysses": {"pp": 2},
              "fsdp_whole": {"fsdp": 2},
              "tp_heads": {"tp": 2}, "tp_whole": {"tp": 2},
              "ep_experts": {"ep": 2}, "ep_whole": {"ep": 2},
              "batch_vs_M": {"pp": 2}, "layers_vs_pp": {"pp": 2},
              "whole_stack": {"pp": 2}}


def _rank_raises(case):
    """The exception a case raises on its mesh: (type name, message)."""
    tokens = torch.zeros((4, 9), dtype=torch.long)
    cfg = replace(tg.GPT2_TINY, n_layer=4)
    axes = RAISE_AXES[case]
    config = ShardingConfig(**axes)
    mesh = config.build_mesh(device_type="cpu")
    if case == "ep_whole":
        cfg = replace(cfg, moe_experts=4)
    if case == "ep_experts":
        cfg = replace(cfg, moe_experts=3)
    if case == "pp_ring":
        cfg = replace(cfg, attention="ring")
    if case == "pp_ulysses":
        cfg = replace(cfg, attention="ulysses")
    if case == "layers_vs_pp":
        cfg = replace(cfg, n_layer=3)
    if case == "tp_heads":
        cfg = replace(cfg, n_head=1)
    params = tg.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    try:
        if "pp" in axes:
            params = tg.to_pipeline_params(params, cfg)
        if case not in ("whole_stack", "tp_whole", "fsdp_whole",
                        "ep_experts", "ep_whole"):
            params = shard_params(params, config, mesh)
        with use_mesh(mesh):
            tg.loss_fn(params, {"tokens": tokens}, cfg,
                       3 if case == "batch_vs_M" else 2)
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


#: pp x sp: the reference's pipelined GPT-2 raises too
#: (tests/test_torch_gpt2_moe_pp.py::test_jax_pipeline_refuses_sp)
SP_REFUSED = "the reference's pipelined GPT-2 raises for pp composed with sp"
RAISES = {"pp_ring": ("NotImplementedError", SP_REFUSED),
          "pp_ulysses": ("NotImplementedError", SP_REFUSED),
          "fsdp_whole": ("ValueError", "shard_params"),
          "tp_heads": ("ValueError", "n_head 1 does not divide by the tp"),
          "tp_whole": ("ValueError", "shard_params"),
          "ep_experts": ("ValueError",
                         "moe_experts 3 does not divide by the ep axis"),
          "ep_whole": ("ValueError", "shard_params"),
          "batch_vs_M": ("ValueError", "num_microbatches 3"),
          "layers_vs_pp": ("ValueError", "do not divide by the pp axis"),
          "whole_stack": ("ValueError", "shard_params")}


@pytest.mark.parametrize("case", list(RAISES))
def test_what_is_not_ported_raises(pool, case):
    kind, match = RAISES[case]
    n = int(np.prod(list(RAISE_AXES[case].values())))
    for got in pool(n).run(_rank_raises, case):
        assert got is not None and got[0] == kind and match in got[1], got


def test_blocks_need_a_bound_mesh():
    cfg = replace(tg.GPT2_TINY, n_layer=4)
    params = tg.to_pipeline_params(
        tg.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    with pytest.raises(RuntimeError, match="no mesh bound"):
        tg.forward(params, torch.zeros((2, 4), dtype=torch.long), cfg)
