"""ray_tpu_torch.parallel and ray_tpu_torch.collective against the JAX
package's ``parallel`` and ``collective.xla``.

The port's sequence parallelism runs as ranks: processes of one gloo
process group on the CPU (``RankPool``, spawned; one pool per world size,
kept for the module), each holding its sequence chunk.  The JAX package
runs the same function as one program over a mesh of as many virtual CPU
devices (``create_mesh({"sp": n}, devices=jax.devices()[:n])``).  The same
numpy inputs from a seed go to both.  At B=1, H=4, S=256, D=32 the JAX
ring's chunks (128 or 64 rows) go through the Pallas kernels in interpret
mode (each chunk one whole-S block: ``_pallas_forward`` and the fused
``_pallas_backward``, asserted by a spy); the port's CPU path runs the
kernels' plain versions.

JAX is imported inside the tests: the ranks import this module to find
their functions and must not import JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import collective
from ray_tpu_torch.collective import c10d
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.parallel import context, ring_attention as tra
from ray_tpu_torch.parallel.launch import RankError, RankPool
from ray_tpu_torch.parallel.mesh import create_mesh, mesh_shape
from ray_tpu_torch.parallel.sharding import (ShardingConfig, batch_shard,
                                             gather_params,
                                             infer_param_logical_dims,
                                             param_shardings, seq_shard,
                                             shard_params)

# f32: the ring merges the chunks' partials in another order than one
# softmax, exp2 against exp in the JAX kernels; measured <= 3.4e-6 on
# outputs and gradients up to ~4 (tests/test_torch_flash_bwd.py's F32_TOL)
F32_TOL = 1e-4
B, H, S, D = 1, 4, 256, 32
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """pool(n): n gloo ranks on the CPU, started at first use."""
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


def _arrays(shape, count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _jax_mesh(n, **axes):
    import jax

    from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh

    return jax_create_mesh(axes or {"sp": n}, devices=jax.devices()[:n])


# ---------------------------------------------------------------------------
# rank functions (run in the ranks)
# ---------------------------------------------------------------------------

def _rank_threads(n):
    torch.set_num_threads(n)


def _sp_mesh():
    import torch.distributed as dist

    return ShardingConfig(sp=dist.get_world_size()).build_mesh(
        device_type="cpu")


def _rank_mesh(axes):
    mesh = create_mesh(axes, device_type="cpu")
    return mesh_shape(mesh), list(mesh.mesh_dim_names)


def _rank_specs(config, queries):
    mesh = config.build_mesh(device_type="cpu")
    return [config.spec(mesh, *dims) for dims in queries]


def _rank_placement(axes, np_params):
    """The rank's coordinates on the mesh, its local leaves
    (``shard_params``), every leaf's spec (``param_shardings``) and the
    leaves whole again (``gather_params``), or the NotImplementedError or
    ValueError either raises."""
    config = ShardingConfig(**axes)
    mesh = config.build_mesh(device_type="cpu")
    params = _map_np(torch.from_numpy, np_params)
    try:
        local = shard_params(params, config, mesh)
        specs = param_shardings(params, config, mesh)
    except (NotImplementedError, ValueError) as e:
        return "raised", type(e).__name__, str(e)
    whole = gather_params(local, config, mesh)
    return ({a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names},
            _map_np(lambda t: t.numpy(), local), specs,
            _map_np(lambda t: t.numpy(), whole))


def _rank_batch_rows(axes, x):
    mesh = ShardingConfig(**axes).build_mesh(device_type="cpu")
    return ({a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names},
            batch_shard(torch.from_numpy(x), mesh).numpy())


def _map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_np(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rank_collective(op, x, cot, kwargs):
    """(output, gradient of <output, cotangent>) of one collective on this
    rank's block of x; dim 0 of x and of the cotangent (the global output's
    shape, or None) is split over the ranks."""
    mesh = _sp_mesh()
    with context.use_mesh(mesh):
        xr = seq_shard(torch.from_numpy(x), mesh, dim=0).clone()
        xr.requires_grad_(True)
        out = getattr(c10d, op)(xr, "sp", **kwargs)
        grad = None
        if cot is not None:
            ct = seq_shard(torch.from_numpy(cot), mesh, dim=0)
            (grad,) = torch.autograd.grad(out, xr, ct)
            grad = grad.numpy()
    return out.detach().numpy(), grad


def _rank_attention(variant, causal, arrays, staged=False):
    """(o, dq, dk, dv) of this rank's chunks, the flash calls it made, and
    the host-staged hops.  ``staged`` sends the ring's hops through the
    host-staging buffers as gloo needs them for CUDA tensors."""
    mesh = _sp_mesh()
    q, k, v, do = (seq_shard(torch.from_numpy(a), mesh, dim=2).clone()
                   for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    calls = {"fwd": 0, "bwd": 0}
    real = tra._flash_fwd, tra._flash_bwd, collective._p2p_through_host

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real[0](*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real[1](*a, **kw)

    tra._flash_fwd, tra._flash_bwd = fwd, bwd
    if staged:
        collective._p2p_through_host = lambda group, device: True
    staged0 = collective.HOST_STAGED_HOPS
    try:
        o = tra.ring_attention_sharded(q, k, v, mesh, causal=causal,
                                       variant=variant)
        o.backward(do)
    finally:
        tra._flash_fwd, tra._flash_bwd, collective._p2p_through_host = real
    return ([t.numpy() for t in (o.detach(), q.grad, k.grad, v.grad)],
            calls, collective.HOST_STAGED_HOPS - staged0)


def _rank_ulysses_heads(h):
    mesh = _sp_mesh()
    x = torch.zeros((1, h, 8, 32))
    with context.use_mesh(mesh):
        try:
            tra.ulysses_attention(x, x, x, "sp")
        except ValueError as e:
            return str(e)
    return None


def _rank_raise_on(rank):
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise KeyError("raised on purpose")
    return dist.get_rank()


# ---------------------------------------------------------------------------
# mesh, context, sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"dp": -1, "tp": -1}, {"dp": 3, "tp": -1},
                                  {"dp": 2, "tp": 2}])
def test_create_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as jax_err:
        _jax_mesh(8, **axes)
    with pytest.raises(ValueError) as err:
        create_mesh(axes, ranks=range(8), device_type="cpu")
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("axes", [{"sp": 2, "dp": 2}, {"dp": -1, "tp": 2},
                                  {"tp": 2, "fsdp": 2}, {"sp": -1}])
def test_create_mesh_matches_jax(pool, axes):
    jmesh = _jax_mesh(4, **axes)
    shape, names = pool(4).run(_rank_mesh, axes)[0]
    assert shape == dict(jmesh.shape)
    assert names == list(jmesh.axis_names)


def test_use_mesh_and_require_mesh():
    from ray_tpu.parallel import context as jctx

    with pytest.raises(RuntimeError) as jax_err:
        jctx.require_mesh()
    with pytest.raises(RuntimeError) as err:
        context.require_mesh()
    assert str(err.value) == str(jax_err.value)
    outer, inner = object(), object()
    with context.use_mesh(outer):
        assert context.require_mesh() is outer
        with context.use_mesh(inner) as m:
            assert m is inner and context.get_mesh() is inner
        assert context.get_mesh() is outer
    assert context.get_mesh() is None


SPEC_QUERIES = [("batch", "seq", "embed"), ("embed", "mlp"),
                ("vocab", "embed"), ("batch", "embed"), ("heads", "kv"),
                ("expert", "embed", "mlp"), ("stage", "embed", "heads"),
                (None, "seq")]


@pytest.mark.parametrize("axes", [{"sp": 4}, {"dp": 2, "sp": 2},
                                  {"fsdp": 2, "tp": 2}, {"dp": 4}])
def test_sharding_spec_matches_jax(pool, axes):
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig

    jcfg = JConfig(**axes)
    jmesh = jcfg.build_mesh(devices=__import__("jax").devices()[:4])
    want = [tuple(jcfg.spec(jmesh, *q)) for q in SPEC_QUERIES]
    config = ShardingConfig(**axes)
    assert config.axes() == jcfg.axes()
    got = pool(4).run(_rank_specs, config, SPEC_QUERIES)
    assert all(g == want for g in got)


@pytest.mark.parametrize("moe", [0, 4])
def test_infer_param_logical_dims_matches_jax(moe):
    import jax

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.sharding import (
        infer_param_logical_dims as jax_infer)

    cfg = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, "moe_experts": moe})
    params = jg.init_params(jax.random.PRNGKey(0), cfg)
    trees = [params, jg.to_pipeline_params(params, cfg)]
    n = 0
    for tree in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = tuple(getattr(k, "key", getattr(k, "idx", str(k)))
                         for k in path)
            assert (infer_param_logical_dims(keys, leaf.shape)
                    == jax_infer(keys, leaf.shape)), keys
            n += 1
    assert n > 30


def test_named_sharding_and_constraint_are_not_ported():
    """named_sharding and constraint raise, pointing at ROADMAP: nothing of
    the port places a tensor by them."""
    config = ShardingConfig(fsdp=2)
    for call in (lambda: config.named_sharding(None, "embed"),
                 lambda: config.constraint(None, None, "embed")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


@pytest.mark.parametrize("axes", [{"pp": 2}, {"pp": 4}, {"dp": 2, "pp": 2}])
@pytest.mark.parametrize("moe", [0, 4])
def test_pipeline_placement_matches_jax(pool, axes, moe):
    """``to_pipeline_params`` then ``shard_params`` on GPT2_TINY (4 layers,
    dense and MoE): each rank's local leaves against the shard JAX's
    ``shard_params`` puts on the device at the same mesh coordinates, and
    ``param_shardings`` against JAX's specs."""
    import jax

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import param_shardings as jspecs
    from ray_tpu.parallel.sharding import shard_params as jshard
    from ray_tpu_torch.models import gpt2 as tg

    cfg = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, "n_layer": 4,
                           "moe_experts": moe})
    seq = jg.init_params(jax.random.PRNGKey(0), cfg)
    tree = jg.to_pipeline_params(seq, cfg)
    ported = tg.to_pipeline_params(
        _map_np(lambda a: torch.from_numpy(np.array(a)), seq),
        tg.GPT2Config(n_layer=4))
    for (_, a), b in zip(tg.named_leaves(ported), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n = int(np.prod(list(axes.values())))
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:n])
    placed = jshard(tree, jcfg, mesh)
    want_specs = jax.tree.map(lambda ns: tuple(ns.spec),
                              jspecs(tree, jcfg, mesh))
    results = pool(n).run(_rank_placement, axes,
                          jax.tree.map(np.asarray, tree))
    for where, local, specs, _ in results:
        dev = mesh.devices[tuple(where[a] for a in mesh.axis_names)]
        flat = jax.tree_util.tree_flatten_with_path(placed)[0]
        got = dict(tg.named_leaves(_map_np(torch.from_numpy, local)))
        assert len(got) == len(flat)
        for path, leaf in flat:
            name = "/".join(k.key for k in path)
            shard = [x.data for x in leaf.addressable_shards
                     if x.device == dev][0]
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(shard), err_msg=name)
        assert specs == want_specs


def _placement_matches_jax(pool, axes, moe):
    """``shard_params`` (with pp: of ``to_pipeline_params``'s tree) for
    GPT2_TINY with 4 layers: ``param_shardings`` against JAX's specs, every
    local leaf but the fused ``c_attn`` kernel under tp against the shard
    JAX puts on the device at the same mesh coordinates, that kernel
    against the rank's head group's q, k and v columns (under fsdp, of
    the rank's block of its rows), and every leaf
    after ``gather_params`` against the whole leaf (under pp: the rank's
    stage of it).  Returns the count of ``c_attn`` kernels cut by heads."""
    import jax

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import param_shardings as jspecs
    from ray_tpu.parallel.sharding import shard_params as jshard
    from ray_tpu_torch.models import gpt2 as tg

    cfg = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, "n_layer": 4,
                           "moe_experts": moe})
    tree = jg.init_params(jax.random.PRNGKey(0), cfg)
    if "pp" in axes:
        tree = jg.to_pipeline_params(tree, cfg)
    n = int(np.prod(list(axes.values())))
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:n])
    placed = jshard(tree, jcfg, mesh)
    want_specs = jax.tree.map(lambda ns: tuple(ns.spec),
                              jspecs(tree, jcfg, mesh))
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    cut = 0
    for where, local, specs, whole in pool(n).run(
            _rank_placement, axes, jax.tree.map(np.asarray, tree)):
        assert specs == want_specs
        dev = mesh.devices[tuple(where[a] for a in mesh.axis_names)]
        got = dict(tg.named_leaves(_map_np(torch.from_numpy, local)))
        back = dict(tg.named_leaves(_map_np(torch.from_numpy, whole)))
        assert len(got) == len(back) == len(flat)
        for path, leaf in flat:
            name = "/".join(k.key for k in path)
            full = np.asarray(leaf)
            shard = [x.data for x in leaf.addressable_shards
                     if x.device == dev][0]
            if name.endswith("c_attn/kernel") and "tp" in axes:
                if "pp" in axes:
                    c = full.shape[0] // axes["pp"]
                    full = full[where["pp"] * c:(where["pp"] + 1) * c]
                # q, k, v blocks of E columns; the rank's heads are
                # columns [t e, (t + 1) e) of each, e = E / tp
                E, t = full.shape[-1] // 3, where["tp"]
                e = E // axes["tp"]
                heads = np.concatenate(
                    [full[..., j * E + t * e:j * E + (t + 1) * e]
                     for j in range(3)], -1)
                if "fsdp" in axes:
                    c = heads.shape[-2] // axes["fsdp"]
                    heads = heads[..., where["fsdp"] * c:
                                  (where["fsdp"] + 1) * c, :]
                np.testing.assert_array_equal(got[name].numpy(), heads,
                                              err_msg=name)
                assert got[name].shape == np.asarray(shard).shape
                cut += 1
            else:
                np.testing.assert_array_equal(got[name].numpy(),
                                              np.asarray(shard),
                                              err_msg=name)
            if "pp" in axes and name.startswith("blocks/"):
                c = np.asarray(leaf).shape[0] // axes["pp"]
                full = np.asarray(leaf)[where["pp"] * c:
                                        (where["pp"] + 1) * c]
            np.testing.assert_array_equal(back[name].numpy(), full,
                                          err_msg=name)
    return cut


@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 4}, {"pp": 2, "tp": 2}])
@pytest.mark.parametrize("moe", [0, 4])
def test_tp_placement_matches_jax(pool, axes, moe):
    """``shard_params`` on tp, dense and MoE, against JAX's shards and
    specs (``_placement_matches_jax``); the fused ``c_attn`` kernel cut by
    heads."""
    assert _placement_matches_jax(pool, axes, moe) > 0


@pytest.mark.parametrize("axes", [{"ep": 2}, {"ep": 4}, {"ep": 2, "tp": 2},
                                  {"pp": 2, "ep": 2}])
@pytest.mark.parametrize("moe", [0, 4])
def test_ep_placement_matches_jax(pool, axes, moe):
    """``shard_params`` on ep (the MoE ``wi``/``wo`` expert dim: the rank's
    n / ep consecutive experts; nothing of the dense model), alone, with tp
    and with pp, against JAX's shards and specs (``_placement_matches_jax``);
    ``gather_params`` gives the whole experts back."""
    _placement_matches_jax(pool, axes, moe)


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"fsdp": 2, "tp": 4},
                                  {"pp": 2, "fsdp": 2}, {"fsdp": 2, "ep": 2}])
@pytest.mark.parametrize("moe", [0, 4])
def test_fsdp_placement_matches_jax(pool, axes, moe):
    """``shard_params`` on fsdp (every leaf's "embed" dim: the rank's
    contiguous block of it; biases and LN scales whole), alone, with tp
    (the mesh of JAX's ``test_shard_params_places_leaves``), pp and ep,
    dense and MoE, against JAX's shards and specs
    (``_placement_matches_jax``); ``gather_params`` gives the whole leaves
    back."""
    cut = _placement_matches_jax(pool, axes, moe)
    assert (cut > 0) == ("tp" in axes)


TP_DIVIDES = {"wte rows": ({"tp": 4}, {"wte": {"embedding": (10, 8)}}),
              "c_fc columns": ({"tp": 4},
                               {"mlp": {"c_fc": {"kernel": (8, 10)}}}),
              "stacked layers": ({"pp": 2, "tp": 2}, {"blocks": {
                  "attn": {"c_attn": {"kernel": (3, 8, 24)}}}}),
              "experts on ep": ({"ep": 4}, {"moe": {"wi": (6, 8, 32)}}),
              "wte columns on fsdp": ({"fsdp": 4},
                                      {"wte": {"embedding": (8, 10)}}),
              "c_attn rows on fsdp": ({"fsdp": 2, "tp": 2}, {"attn": {
                  "c_attn": {"kernel": (7, 24)}}}),
              "expert embed on fsdp": ({"fsdp": 4},
                                       {"moe": {"wo": (2, 8, 6)}})}


@pytest.mark.parametrize("case", list(TP_DIVIDES))
def test_tp_placement_dims_must_divide_like_jax(pool, case):
    """A dim that does not divide by its axis raises ValueError in the
    port's ``shard_params`` on every rank, as JAX's ``device_put`` does."""
    import jax

    from ray_tpu.parallel.sharding import ShardingConfig as JConfig
    from ray_tpu.parallel.sharding import shard_params as jshard

    axes, shapes = TP_DIVIDES[case]
    tree = _map_np(lambda shape: np.zeros(shape, np.float32), shapes)
    jcfg = JConfig(**axes)
    with pytest.raises(ValueError, match="divisible"):
        jshard(tree, jcfg, jcfg.build_mesh(devices=jax.devices()[:4]))
    for got in pool(4).run(_rank_placement, axes, tree):
        assert got[:2] == ("raised", "ValueError"), got
        assert "divi" in got[2], got


@pytest.mark.parametrize("axes", [{"dp": 4}, {"dp": 2, "fsdp": 2},
                                  {"dp": 2, "pp": 2}, {"dp": 2, "sp": 2}])
def test_batch_shard_matches_jax(pool, axes):
    """Each rank's rows (``batch_shard``) against the shard that
    ``device_put(x, named_sharding(mesh, "batch", None))`` puts on the
    device at the same mesh coordinates."""
    import jax

    from ray_tpu.parallel.sharding import ShardingConfig as JConfig

    (x,) = _arrays((8, 3), 1, seed=4)
    jcfg = JConfig(**axes)
    mesh = jcfg.build_mesh(devices=jax.devices()[:4])
    placed = jax.device_put(x, jcfg.named_sharding(mesh, "batch", None))
    for where, rows in pool(4).run(_rank_batch_rows, axes, x):
        dev = mesh.devices[tuple(where[a] for a in mesh.axis_names)]
        shard = [s.data for s in placed.addressable_shards
                 if s.device == dev][0]
        np.testing.assert_array_equal(rows, np.asarray(shard))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

COLLECTIVES = [
    ("allreduce", {"op": "sum"}), ("allreduce", {"op": "max"}),
    ("allreduce", {"op": "min"}), ("allreduce", {"op": "mean"}),
    ("allgather", {"axis": 0, "tiled": True}),
    ("allgather", {"axis": 1, "tiled": False}),
    ("reducescatter", {"axis": 2}), ("broadcast", {"root": 2}),
    ("permute", {"perm": [(0, 1), (1, 2), (2, 3), (3, 0)]}),
    ("permute", {"perm": [(0, 2), (3, 1)]}),
    ("alltoall", {"split_axis": 1, "concat_axis": 2}),
    ("alltoall", {"split_axis": 0, "concat_axis": 1}),
]


@pytest.mark.parametrize("op,kwargs", COLLECTIVES,
                         ids=[f"{o}-{i}" for i, (o, _) in
                              enumerate(COLLECTIVES)])
def test_collective_matches_jax_xla(pool, op, kwargs):
    """Each rank's output against ``ray_tpu.collective.xla`` under
    ``shard_map`` (out_specs concatenate the ranks' outputs along dim 0),
    and the gradients of ``permute``, ``alltoall``, ``allgather`` and
    ``reducescatter`` against JAX's transposes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.collective import xla

    (x,) = _arrays((16, 4, 8), 1, seed=1)
    mesh = _jax_mesh(4)
    fn = jax.shard_map(lambda t: getattr(xla, op)(t, "sp", **kwargs),
                       mesh=mesh, in_specs=P("sp"), out_specs=P("sp"),
                       check_vma=False)
    want = np.asarray(fn(jnp.asarray(x)))
    cot = None
    if op in ("permute", "alltoall", "allgather", "reducescatter"):
        (cot,) = _arrays(want.shape, 1, seed=2)
        _, vjp = jax.vjp(fn, jnp.asarray(x))
    results = pool(4).run(_rank_collective, op, x, cot, kwargs)
    got = np.concatenate([out for out, _ in results])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if cot is not None:
        (want_grad,) = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(
            np.concatenate([g for _, g in results]), np.asarray(want_grad),
            rtol=0, atol=1e-5)


def _rank_allreduce_share(x):
    mesh = _sp_mesh()
    with context.use_mesh(mesh):
        xr = seq_shard(torch.from_numpy(x), mesh, dim=0).clone()
        xr.requires_grad_(True)
        loss = c10d.allreduce((xr ** 2).sum(), "sp")
        loss.backward()
    return loss.item(), xr.grad.numpy()


def test_allreduce_gradient_is_each_ranks_share(pool):
    """A loss all-reduced into a value every rank holds: its gradient on
    each rank is that of the rank's own terms (no second sum), so the
    ranks' gradients together are the global one."""
    (x,) = _arrays((8, 3), 1, seed=2)
    results = pool(4).run(_rank_allreduce_share, x)
    assert all(abs(loss - (x ** 2).sum()) < 1e-4 for loss, _ in results)
    np.testing.assert_allclose(np.concatenate([g for _, g in results]),
                               2 * x, rtol=1e-6)


def _rank_identity_grad(x, w):
    """The gradient of a replicated x through ``c10d.identity`` into the
    rank's columns of w (a column-parallel product), the loss summed over
    the ranks; the host seconds the transport recorded, by kind."""
    mesh = _sp_mesh()
    with context.use_mesh(mesh):
        xr = torch.from_numpy(x).clone().requires_grad_(True)
        wr = seq_shard(torch.from_numpy(w), mesh, dim=1)
        with collective.timing() as comm:
            y = c10d.identity(xr, "sp") @ wr
            loss = c10d.allreduce((torch.tanh(y) ** 2).sum(), "sp")
            loss.backward()
    return loss.item(), xr.grad.numpy(), sorted(comm.blocked_s)


def test_identity_gradient_is_summed_over_the_axis(pool):
    """``c10d.identity`` (Megatron's "f", the transpose of ``allreduce``'s
    sum): a replicated input consumed by work cut over the axis gets, on
    every rank, the whole gradient, as ``jax.grad`` gives it through
    ``shard_map`` with the input replicated (P()) and the weight's columns
    sharded; its backward is an all-reduce in ``collective.timing()``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    x, w = _arrays((6, 5), 1, seed=5)[0], _arrays((5, 8), 1, seed=6)[0]

    def sharded_loss(x, w):
        def body(x, w):
            return jax.lax.psum(jnp.sum(jnp.tanh(x @ w) ** 2), "sp")

        return jax.shard_map(body, mesh=_jax_mesh(4),
                             in_specs=(P(), P(None, "sp")),
                             out_specs=P())(x, w)

    want = np.asarray(jax.grad(sharded_loss)(jnp.asarray(x), jnp.asarray(w)))
    whole = np.asarray(jax.grad(lambda x: jnp.sum(
        jnp.tanh(x @ jnp.asarray(w)) ** 2))(jnp.asarray(x)))
    np.testing.assert_allclose(want, whole, rtol=0, atol=1e-5)
    for loss, grad, kinds in pool(4).run(_rank_identity_grad, x, w):
        assert loss == pytest.approx(float(np.sum(np.tanh(x @ w) ** 2)),
                                     rel=1e-5)
        np.testing.assert_allclose(grad, want, rtol=0, atol=1e-5)
        assert kinds == ["all_reduce"]


# ---------------------------------------------------------------------------
# ring and Ulysses attention
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_calls(monkeypatch):
    """Calls of the JAX Pallas forward and backward, counted by a spy."""
    from ray_tpu.ops import flash_attention as jfa

    calls = {}
    for name in ("_pallas_forward", "_pallas_backward"):
        real = getattr(jfa, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            assert kwargs.get("interpret", args[7] if len(args) > 7
                              else None) is True
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(jfa, name, spy)
    return calls


def _jax_attention(n, variant, causal, arrays):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.ring_attention import ring_attention_sharded

    q, k, v, do = (jnp.asarray(a) for a in arrays)
    mesh = _jax_mesh(n)
    o, vjp = jax.vjp(lambda q, k, v: ring_attention_sharded(
        q, k, v, mesh, causal=causal, variant=variant), q, k, v)
    return [np.asarray(t) for t in (o, *vjp(do))]


def _dense(causal, arrays):
    q, k, v, do = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    o, _ = tfa._reference_attention(q, k, v, D ** -0.5, causal)
    o.backward(do)
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("variant", ["ring", "ulysses"])
def test_sp_attention_matches_jax_and_dense(pool, pallas_calls, variant, n,
                                            causal):
    arrays = _arrays((B, H, S, D), 4)
    want = _jax_attention(n, variant, causal, arrays)
    # the JAX chunks went through the Pallas kernels in interpret mode
    assert pallas_calls.get("_pallas_forward") and pallas_calls.get(
        "_pallas_backward")
    results = pool(n).run(_rank_attention, variant, causal, arrays)
    got = [np.concatenate([r[0][i] for r in results], axis=2)
           for i in range(4)]
    dense = _dense(causal, arrays)
    for name, g, w, d in zip(("o", "dq", "dk", "dv"), got, want, dense):
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL,
                                   err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(g, d, rtol=0, atol=F32_TOL,
                                   err_msg=f"{name} vs dense")
    for rank, (_, calls, _) in enumerate(results):
        if variant == "ulysses":
            assert calls == {"fwd": 0, "bwd": 0}  # flash_attention direct
        else:
            steps = rank + 1 if causal else n  # future chunks skipped
            assert calls == {"fwd": steps, "bwd": steps}, (rank, calls)


def _rank_ulysses_under_tp():
    """The error GPT-2 with Ulysses attention raises on a tp = 2 x sp = 2
    mesh when its 2 heads give each tp rank 1, fewer than sp."""
    from dataclasses import replace

    from ray_tpu_torch.models import gpt2 as tg

    config = ShardingConfig(sp=2, tp=2)
    mesh = config.build_mesh(device_type="cpu")
    cfg = replace(tg.GPT2_TINY, attention="ulysses", n_layer=1)
    params = shard_params(tg.init_params(torch.Generator().manual_seed(0),
                                         cfg, "cpu"), config, mesh)
    with context.use_mesh(mesh):
        try:
            tg.forward(params, torch.zeros((1, 8), dtype=torch.long), cfg)
        except ValueError as e:
            return str(e)
    return None


def test_ulysses_needs_the_heads_of_a_tp_rank_to_divide_by_sp(pool):
    """Under tp each rank's Ulysses all-to-all splits its n_head / tp heads
    over sp, so (n_head / tp) % sp must be 0; it raises as Ulysses does for
    n_head % sp."""
    assert pool(4).run(_rank_ulysses_under_tp) == [
        "num heads 1 must divide by sp axis size 2"] * 4


def test_ulysses_heads_must_divide_like_jax(pool):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel.ring_attention import ulysses_attention

    x = jnp.zeros((1, 2, 32, 32))
    spec = P(None, None, "sp", None)
    with pytest.raises(ValueError) as jax_err:
        jax.shard_map(lambda q: ulysses_attention(q, q, q, "sp"),
                      mesh=_jax_mesh(4), in_specs=spec, out_specs=spec,
                      check_vma=False)(x)
    assert pool(4).run(_rank_ulysses_heads, 2) == [str(jax_err.value)] * 4


@pytest.mark.parametrize("n", WORLDS)
def test_host_staged_hops_match_direct(pool, n):
    """The ring with every hop staged through host buffers (the gloo
    transport of CUDA tensors) gives the direct hops' results bit for bit;
    a rank makes n - 1 K/V hops each way and n dk/dv hops."""
    arrays = _arrays((B, H, S, D), 4, seed=3)
    direct = pool(n).run(_rank_attention, "ring", True, arrays)
    staged = pool(n).run(_rank_attention, "ring", True, arrays, True)
    for (d, _, d_hops), (s, _, s_hops) in zip(direct, staged):
        assert d_hops == 0 and s_hops == 2 * (n - 1) + n
        for a, b in zip(d, s):
            np.testing.assert_array_equal(a, b)


def test_host_staged_buffers_copy_and_count():
    before = (collective.HOST_STAGED_HOPS, collective.HOST_STAGED_BYTES)
    a, like = torch.arange(6.0).reshape(2, 3), torch.zeros(4, dtype=torch.int64)
    (sent,), (buf,) = collective._host_staged_buffers([a], [like])
    assert torch.equal(sent, a) and sent.data_ptr() != a.data_ptr()
    assert buf.shape == like.shape and buf.dtype == like.dtype
    assert (collective.HOST_STAGED_HOPS - before[0],
            collective.HOST_STAGED_BYTES - before[1]) == (1, 24)


def test_merge_guards_skipped_and_first_steps():
    gen = torch.Generator().manual_seed(0)
    o0 = torch.randn((1, 2, 4, 8), generator=gen)
    lse0 = torch.randn((1, 2, 4), generator=gen)
    num = torch.zeros_like(o0)
    m = torch.full((1, 2, 4, 1), tra._NEG_INF)
    den = torch.zeros((1, 2, 4, 1))
    # the first partial enters with weight 1 whatever the -inf state
    num, m, den = tra._merge(num, m, den, o0, lse0)
    assert torch.equal(num, o0) and torch.equal(den, torch.ones_like(den))
    assert torch.equal(m[..., 0], lse0)
    # a skipped step (o = 0, lse = -inf) leaves the state as it was
    skipped = tra._merge(num, m, den, torch.zeros_like(o0),
                         torch.full_like(lse0, tra._NEG_INF))
    for a, b in zip(skipped, (num, m, den)):
        assert torch.equal(a, b)


_ABORTING_PARENT = """
import os, sys
from ray_tpu_torch.parallel.launch import RankPool
pool = RankPool(2, "file://" + sys.argv[1], backend="gloo", device="cpu",
                timeout_s=60.0)
print(" ".join(str(p.pid) for p in pool._procs), flush=True)
os.abort()
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:  # a zombie has exited
        return f.read().split(") ")[-1][0] != "Z"


def test_rank_pool_ranks_exit_when_their_parent_aborts(tmp_path):
    """A parent that aborts runs no exit handler, so nothing closes its
    pool: its ranks see that it is gone and exit within a few seconds."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _ABORTING_PARENT, str(tmp_path / "init")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == -6, proc.stderr  # SIGABRT
    pids = [int(p) for p in proc.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 15.0
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not [p for p in pids if _alive(p)]


def test_rank_pool_reports_a_failed_rank(pool):
    with pytest.raises(RankError, match="(?s)rank 1:.*raised on purpose"):
        pool(2).run(_rank_raise_on, 1)
    assert pool(2).run(_rank_raise_on, -1) == [0, 1]


class _FakeEvent:
    """A CUDA event's timing interface at a fixed time (ms)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_comm_times_split_is_the_union_of_overlapping_spans(monkeypatch):
    """A hop in flight across a kernel overlaps the next hop and an
    all-reduce: each kind's time is the union of its spans, and "all"
    the union of every span, with the host's blocked time beside it."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    times = collective.CommTimes()
    for kind, a, b in (("hop", 0, 4), ("hop", 3, 6), ("all_reduce", 5, 9),
                       ("hop", 10, 11)):
        times.spans.append((kind, _FakeEvent(a), _FakeEvent(b)))
    times.blocked_s = {"hop": 0.002, "all_reduce": 0.001}
    split = times.split_ms()
    assert split["hop"] == pytest.approx((7.0, 2.0))
    assert split["all_reduce"] == pytest.approx((4.0, 1.0))
    assert split["all"] == pytest.approx((10.0, 3.0))
    assert collective.CommTimes().split_ms() == {"all": (0.0, 0.0)}
