"""GPT-2's mixture of experts across ranks in ray_tpu_torch against ray_tpu
at GPT2_TINY with 4 experts, 4 heads and 4 layers: the experts on ep
(ep = 2, 4; with tp, dp, ring sp and pp) and routing with the global
capacity under dp (the reference's ``_moe_mlp`` counts every token of the
global batch: ray_tpu/models/gpt2.py:161-205).

The port runs as gloo ranks on the CPU (``RankPool``, the pools of
tests/test_torch_gpt2_pp.py), each holding its ``shard_params`` shard: on
ep its n / ep experts.  Its logits, loss, every gradient (gathered over ep
and tp) and 3 AdamW steps are held against JAX's unsharded model (GSPMD
computes it whatever the placement; tests/test_torch_gpt2_tp.py's
``_run``), with the capacity factor low enough (``CF``) that choices are
dropped on both sides of every rank boundary: each case asserts that every
rank dropped choices, and where tokens are spread over ranks, that a
capacity over a rank's own tokens would have kept other choices.  The
MoE under ring and Ulysses sp alone is in tests/test_torch_gpt2_sp.py,
the 8-rank meshes in tests/test_torch_gpt2_ep_composed.py.  Below those:
``_moe_route``'s positions on each rank against JAX's global ones, and the
aux loss and the router's gradient of one MoE FFN under dp and ep.

JAX is imported inside the tests: the ranks import this module to find
their functions and must not import JAX.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ray_tpu_torch.collective import c10d
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.parallel.context import use_mesh
from ray_tpu_torch.parallel.sharding import (ShardingConfig, batch_shard,
                                             gather_params, seq_shard,
                                             shard_params)
from test_torch_gpt2_pp import (_cfgs, _jax_train, _np_tree, _rank_train,
                                _tokens, B, LOSS_TOL, PARAM_ATOL, S, STEPS)
from test_torch_gpt2_pp import pool  # noqa: F401 - the ranks' fixture
from test_torch_gpt2_tp import _run

#: capacity factor of every case: at B=8, S=64 (512 tokens, top-2 of 4
#: experts) an expert takes 192 choices, so choice 1 of later tokens is
#: dropped, on every rank
CF = 0.75
MOE = {"moe_experts": 4, "moe_capacity_factor": CF, "moe_aux_weight": 0.5}
# bf16 with flash attention, each side with its own routes: as
# tests/test_torch_gpt2_moe.py holds them (a token whose top-2 router
# probabilities lie within bf16 rounding of each other routes otherwise on
# one side, and its residual carries that on), gradients per leaf by norm
# (measured <= 0.132) and the share of tokens whose choices agree per
# layer.  With the capacity binding, a choice routed otherwise also moves
# the slots of the later choices of both experts, so another token's
# choice may be dropped on one side only: its logits then part by a whole
# expert's output (measured up to 0.13 at 3 and 4 of a rank's 256 tokens).
# So the logits are held, as the routes, by the share of tokens within
# tests/test_torch_gpt2_moe.py's bf16 tolerance (measured >= 0.984), and
# by norm (measured <= 0.024; 2x room).
# The losses after AdamW steps: where the gradients part so, Adam still
# moves every element by about LR a step, however small its gradient, and
# the two sides' steps part where the gradient's sign does (measured 1.3e-3
# relative after two steps, against 1.7e-5 at the first loss): held to
# 5e-3, and the leaves to Adam's bound.
GRAD_NORM_REL_BF16 = 0.15
ROUTE_AGREE = 0.95
LOGITS_TOL_BF16 = 2e-2
LOGITS_NORM_REL_BF16 = 0.05
STEP_LOSS_REL_BF16 = 5e-3


# ---------------------------------------------------------------------------
# rank functions (run in the ranks)
# ---------------------------------------------------------------------------

def _rank_train_routes(tc, np_params, tokens, axes, M, chunks, steps):
    """``_rank_train``, with every MoE call's routing recorded: the first
    forward's expert choices (a (T, k) array a layer; under pp one a
    microbatch and stage layer, microbatch major), the choices dropped
    at the global capacity over the whole run, and the choices whose keep
    a capacity over the rank's own tokens would have decided otherwise."""
    rec = {"idx": [], "dropped": 0, "per_rank": 0}
    routes = tg._routes

    def spy(xt, router, cfg, rows):
        r = routes(xt, router, cfg, rows)
        k, n = cfg.moe_top_k, cfg.moe_experts
        alone = max(k, int(cfg.moe_capacity_factor * xt.shape[0] * k / n))
        keep = r.pos < r.capacity
        rec["idx"].append(r.idx.numpy().copy())
        rec["dropped"] += int((~keep).sum())
        rec["per_rank"] += int(((r.local < alone) != keep).sum())
        return r

    tg._routes = spy
    try:
        out = _rank_train(tc, np_params, tokens, axes, M, chunks, steps)
    finally:
        tg._routes = routes
    first = tc.n_layer * M // axes["pp"] if "pp" in axes else tc.n_layer
    out.update(idx=rec["idx"][:first], dropped=rec["dropped"],
               per_rank=rec["per_rank"])
    return out


def _rank_route(axes, x, router, cfg):
    """The rank's coordinates and ``_moe_route``'s (pos, keep, capacity) on
    its rows and positions of x, over the mesh and with the rank alone."""
    mesh = ShardingConfig(**axes).build_mesh(device_type="cpu")
    xl = batch_shard(torch.from_numpy(x), mesh)
    if "sp" in axes:
        xl = seq_shard(xl, mesh)
    xt, w = xl.reshape(-1, xl.shape[-1]), torch.from_numpy(router)
    out = {"where": {a: mesh.get_local_rank(a) for a in axes}}
    for name, bound in (("ranks", mesh), ("alone", None)):
        with use_mesh(bound):
            _, _, idx, pos, C = tg._moe_route(xt, w, cfg, xl.shape[0])
        out[name] = (idx.numpy(), pos.numpy(), (pos < C).numpy(), C)
    return out


def _rank_moe_layer(axes, x, p, w, cfg):
    """One MoE FFN on the rank's rows of x with its ``shard_params`` shard
    of p: for the loss aux alone and for sum(y w) + aux, the aux, the loss
    and the gradients summed over dp as the train step sums them, gathered
    over ep."""
    config = ShardingConfig(**axes)
    mesh = config.build_mesh(device_type="cpu")
    tree = {"moe": {"router": {"kernel": torch.from_numpy(p["router"])},
                    "wi": torch.from_numpy(p["wi"]),
                    "wo": torch.from_numpy(p["wo"])}}
    local = shard_params(tree, config, mesh)
    leaves = tg.param_leaves(local)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xl = batch_shard(torch.from_numpy(x), mesh)
    wl = batch_shard(torch.from_numpy(w), mesh)
    out = {}
    with use_mesh(mesh):
        for name, y_weight in (("aux", 0.0), ("both", 1.0)):
            y, aux = tg._moe_mlp(xl, local["moe"], cfg)
            share = (y * wl).sum() * y_weight
            if "dp" in axes:
                share = c10d.allreduce(share, "dp")
            loss = share + aux
            loss.backward()
            grads = {"moe": {"router": {"kernel": local["moe"]["router"][
                "kernel"].grad}, "wi": local["moe"]["wi"].grad,
                "wo": local["moe"]["wo"].grad}}
            if "dp" in axes:
                with torch.no_grad():
                    for g in tg.param_leaves(grads):
                        g.copy_(c10d.allreduce(g, "dp"))
            whole = gather_params(grads, config, mesh)["moe"]
            out[name] = (aux.item(), loss.item(),
                         whole["router"]["kernel"].numpy().copy(),
                         whole["wi"].numpy().copy(),
                         whole["wo"].numpy().copy())
            for leaf in leaves:
                leaf.grad = None
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _run_moe(pool, axes, attention="dense", M=2):
    """The MoE on ``axes`` against JAX (``_run``, f32), then the capacity's
    binding: every rank dropped choices, and where the tokens are spread,
    a capacity over the rank's own tokens keeps others on some rank."""
    params, jc, results = _run(pool, axes, "f32", attention, M,
                               rank_fn=_rank_train_routes, **MOE)
    assert all(r["dropped"] > 0 for r in results), [
        r["dropped"] for r in results]
    if {"dp", "fsdp", "sp"} & set(axes):  # tokens spread over ranks
        assert any(r["per_rank"] > 0 for r in results)
    return params, jc, results


MESHES = [({"ep": 2}, "dense", 2), ({"ep": 4}, "dense", 2),
          ({"dp": 2}, "dense", 2), ({"ep": 2, "tp": 2}, "dense", 2),
          ({"dp": 2, "ep": 2}, "dense", 2), ({"sp": 2, "ep": 2}, "ring", 2),
          ({"pp": 2, "ep": 2}, "dense", 2)]


@pytest.mark.parametrize("axes,attention,M", MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              + f"-{t}" for a, t, _ in MESHES])
def test_moe_over_ranks_matches_jax(pool, axes, attention, M):
    """Each rank's logits (its rows and positions), the loss with its aux,
    every gradient (gathered over ep and tp) and 3 AdamW steps against
    JAX's unsharded MoE (under pp: its pipelined MoE, each microbatch
    routed with its own capacity), f32, with choices dropped at capacity
    on every rank."""
    _run_moe(pool, axes, attention, M)


def _jax_routes(params, tokens, jc):
    """Each layer's (T, k) expert choices in a JAX forward of the whole
    batch."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    got, moe = [], jg._moe_mlp

    def spy(x, p, cfg):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ p["router"]["kernel"].astype(x.dtype)).astype(
            jnp.float32)
        got.append(np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                            cfg.moe_top_k)[1]))
        return moe(x, p, cfg)

    jg._moe_mlp = spy
    try:
        jg.forward(params, jnp.asarray(tokens[:, :-1], jnp.int32), jc)
    finally:
        jg._moe_mlp = moe
    return got


def test_moe_bf16_flash_over_dp_and_ep_matches_jax(pool):
    """bf16 with flash attention (JAX's Pallas kernels interpreted) at
    dp = 2 x ep = 2 against JAX's model over the whole batch on a dp mesh:
    each side routes with its own choices, so the share of tokens whose
    choices agree is held per layer (ROUTE_AGREE), the gradients per leaf
    and the logits by norm, the logits also by the share of tokens within
    LOGITS_TOL_BF16, the first loss as tests/test_torch_gpt2_pp.py holds
    bf16, the losses after AdamW steps to STEP_LOSS_REL_BF16 and the leaves
    to Adam's bound; the ranks agree bit for bit."""
    import jax

    from ray_tpu.models import gpt2 as jg

    axes = {"dp": 2, "ep": 2}
    jc, tc = _cfgs("bf16", "flash", n_head=4, **MOE)
    params = jg.init_params(jax.random.PRNGKey(0), jc)
    want = _jax_train(params, jc, 2, 0, {"dp": 2})
    jroutes = _jax_routes(params, _tokens(), jc)
    results = pool(4).run(_rank_train_routes, tc, _np_tree(params),
                          _tokens(), axes, 2, 0, STEPS)
    for r in results:
        rows = np.arange(B).reshape(2, -1)[r["where"]["dp"]]
        ref = want["logits"][rows]
        near = np.abs(r["logits"] - ref).max(-1) <= LOGITS_TOL_BF16
        assert near.mean() >= ROUTE_AGREE
        assert (np.linalg.norm(r["logits"] - ref)
                <= LOGITS_NORM_REL_BF16 * np.linalg.norm(ref))
        assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL["bf16"])
        assert r["losses"] == pytest.approx(want["losses"],
                                            rel=STEP_LOSS_REL_BF16)
        assert r["losses"][-1] < r["losses"][0] and r["dropped"] > 0
        for mine, ref in zip(r["idx"], jroutes):
            ref = ref.reshape(B, S, -1)[rows].reshape(mine.shape)
            assert (mine == ref).all(-1).mean() >= ROUTE_AGREE
        for name, g, ref, leaf, p in zip(r["names"], r["grads"],
                                         want["grads"], r["params"],
                                         want["params"]):
            assert (np.linalg.norm(g - ref)
                    <= GRAD_NORM_REL_BF16 * np.linalg.norm(ref)), name
            np.testing.assert_allclose(leaf, p, rtol=0,
                                       atol=PARAM_ATOL["bf16"], err_msg=name)
    assert any(r["per_rank"] > 0 for r in results)
    for r in results[1:]:
        assert r["loss"] == results[0]["loss"]
        assert r["losses"] == results[0]["losses"]
        for a, b in zip(r["grads"] + r["params"],
                        results[0]["grads"] + results[0]["params"]):
            np.testing.assert_array_equal(a, b)


def _jax_positions(x, router, jc, monkeypatch):
    """JAX's (T, k) expert choices, slot positions and capacity for x (B,
    S, E), as its ``_moe_mlp`` forms them: the positions and capacity its
    one-hot slot tensor is built from."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    seen, one_hot = [], jax.nn.one_hot

    def spy(a, n, **kw):
        seen.append((np.asarray(a), n))
        return one_hot(a, n, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax.nn, "one_hot", spy)
        jg._moe_mlp(jnp.asarray(x), {"router": {"kernel": jnp.asarray(
            router)}, "wi": jnp.zeros((jc.moe_experts, x.shape[-1], 4)),
            "wo": jnp.zeros((jc.moe_experts, 4, x.shape[-1]))}, jc)
    (idx, _), (pos, capacity) = seen
    pos = np.take_along_axis(pos, idx[..., None], -1)[..., 0]
    return idx, pos, capacity


ROUTE_MESHES = [{"dp": 2}, {"sp": 2}, {"dp": 2, "sp": 2}]


def _route_positions_match_jax(pool, axes, case, monkeypatch):
    """``_moe_route`` on each rank's rows and positions (x of (4, 16, 64),
    capacity factor ``CF``, ties forced: experts 0 and 3 tie for every token,
    or all four do) against JAX's global choices, positions and keeps,
    exactly (a rank's rows are its block of the (dp, fsdp) blocks, dp
    major, its positions its sp chunk); the same routing on a rank alone (a
    capacity over its own tokens) gives other positions and keeps."""
    from ray_tpu.models import gpt2 as jg

    x = np.random.default_rng(3).standard_normal((4, 16, 64)).astype(
        np.float32)
    router = (np.random.default_rng(4).standard_normal((64, 4)) * 0.02
              ).astype(np.float32)
    if case == "tied_columns":
        router[:, 3] = router[:, 0]
    else:
        router[:] = router[:, :1]
    kw = {"moe_experts": 4, "moe_capacity_factor": CF}
    jc = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, **kw})
    tc = replace(tg.GPT2_TINY, compute_dtype=torch.float32,
                 attention="ring" if "sp" in axes else "dense", **kw)
    idx, pos, capacity = _jax_positions(x, router, jc, monkeypatch)
    keep = pos < capacity
    assert (~keep).any() and keep.any()
    grid = lambda a: a.reshape(4, 16, -1)  # noqa: E731
    n = int(np.prod(list(axes.values())))
    n_fsdp = axes.get("fsdp", 1)
    differs = []
    for r in pool(n).run(_rank_route, axes, x, router, tc):
        block = r["where"].get("dp", 0) * n_fsdp + r["where"].get("fsdp", 0)
        rows = np.arange(4).reshape(axes.get("dp", 1) * n_fsdp, -1)[block]
        c = 16 // axes.get("sp", 1)
        cols = slice(r["where"].get("sp", 0) * c,
                     (r["where"].get("sp", 0) + 1) * c)
        mine_idx, mine_pos, mine_keep, C = r["ranks"]
        assert C == capacity
        for got, ref in ((mine_idx, idx), (mine_pos, pos),
                         (mine_keep, keep)):
            np.testing.assert_array_equal(
                got, grid(ref)[rows][:, cols].reshape(got.shape))
        _, alone_pos, alone_keep, _ = r["alone"]
        differs.append(((alone_pos != mine_pos).any(),
                        (alone_keep != mine_keep).any()))
    assert any(p for p, _ in differs) and any(k for _, k in differs)


@pytest.mark.parametrize("case", ["tied_columns", "all_tied"])
@pytest.mark.parametrize("axes", ROUTE_MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              for a in ROUTE_MESHES])
def test_moe_route_positions_are_jax_global_ones(pool, axes, case,
                                                 monkeypatch):
    """``_route_positions_match_jax`` at dp = 2, sp = 2 and dp x sp."""
    _route_positions_match_jax(pool, axes, case, monkeypatch)


AUX_MESHES = [{"dp": 2}, {"ep": 2}, {"dp": 2, "ep": 2}]


@pytest.mark.parametrize("axes", AUX_MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              for a in AUX_MESHES])
def test_moe_aux_and_router_gradient_match_jax(pool, axes):
    """One MoE FFN (f32, capacity factor 0.5, x of (4, 16, 64)) under dp
    and ep: the aux loss, and the gradients of the router, ``wi`` and
    ``wo`` for the loss aux alone and sum(y w) + aux, summed over dp as the
    train step sums them and gathered over ep, against ``jax.grad`` of
    JAX's ``_moe_mlp`` over the whole batch: the aux's router gradient is
    each rank's share once, not counted dp or ep times.  f32: the same
    arithmetic in another order (tests/test_torch_gpt2_moe.py's Y_TOL and
    AUX_REL; gradients 1e-5 of the largest)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    rng = np.random.default_rng(5)
    E, n = 64, 4
    x = rng.standard_normal((4, 16, E)).astype(np.float32)
    w = rng.standard_normal((4, 16, E)).astype(np.float32)
    p = {"router": (rng.standard_normal((E, n)) * 0.02).astype(np.float32),
         "wi": (rng.standard_normal((n, E, 4 * E)) * 0.02).astype(
             np.float32),
         "wo": (rng.standard_normal((n, 4 * E, E)) * 0.02).astype(
             np.float32)}
    kw = {"moe_experts": n, "moe_capacity_factor": 0.5}
    jc = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, **kw,
                          "compute_dtype": jnp.float32})
    tc = replace(tg.GPT2_TINY, compute_dtype=torch.float32, **kw)
    jp = {"router": {"kernel": jnp.asarray(p["router"])},
          "wi": jnp.asarray(p["wi"]), "wo": jnp.asarray(p["wo"])}

    def jloss(params, y_weight):
        y, aux = jg._moe_mlp(jnp.asarray(x), params, jc)
        return jnp.sum(y * jnp.asarray(w)) * y_weight + aux, aux

    n_ranks = int(np.prod(list(axes.values())))
    results = pool(n_ranks).run(_rank_moe_layer, axes, x, p, w, tc)
    for name, y_weight in (("aux", 0.0), ("both", 1.0)):
        (loss, aux), grads = jax.value_and_grad(jloss, has_aux=True)(
            jp, y_weight)
        refs = [np.asarray(grads["router"]["kernel"]),
                np.asarray(grads["wi"]), np.asarray(grads["wo"])]
        for r in results:
            got_aux, got_loss, *got = r[name]
            assert got_aux == pytest.approx(float(aux), rel=1e-6)
            assert got_loss == pytest.approx(float(loss), rel=1e-5,
                                             abs=1e-6)
            for leaf, g, ref in zip(("router", "wi", "wo"), got, refs):
                np.testing.assert_allclose(
                    g, ref, rtol=0, atol=1e-5 * np.abs(ref).max() + 1e-12,
                    err_msg=f"{name} {leaf}")
