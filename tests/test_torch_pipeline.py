"""ray_tpu_torch.parallel.pipeline against ray_tpu.parallel.pipeline.

The port's pipeline runs as gloo ranks on the CPU (``RankPool``, one pool
per world size, kept for the module), each rank one stage holding its
slice of the layer-stacked params (``shard_params``).  The JAX pipeline
runs as one program on a mesh of as many virtual CPU devices.  The block is
JAX's toy block of ``tests/test_parallel.py`` (a matrix product, aux
``w[0, 0]``) with random matrices from a seed; the same numpy inputs go to
both sides, and each rank's output rows, the aux total and the gradients
of ``sum(out**2) + aux`` with respect to its stage slice and x are held
against JAX's ``jax.grad``.

The loss a rank differentiates is its share (the port's convention,
``collective._AllReduce``): its own rows when the output is scattered, and
1/n of the whole when every stage holds every row.

JAX is imported inside the tests: the ranks import this module to find
their functions and must not import JAX.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import pipeline as tpp
from ray_tpu_torch.parallel.launch import RankPool
from ray_tpu_torch.parallel.sharding import ShardingConfig, shard_params

# f32 on both sides: the same matrix products, grouped per microbatch on
# both; measured <= 1.2e-6 on outputs of magnitude <= 5.8, and <= 3.4e-7
# of the largest entry on the gradients (up to ~830); held to TOL absolute
# on outputs and TOL x the largest entry on gradients
TOL = 1e-5
L, B, T, W = 8, 8, 4, 8  # layers, rows, tokens a row, width


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


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, W, W)) / np.sqrt(W)).astype(np.float32)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    return w, x


def _torch_block(p, h):
    return h @ p["w"], p["w"][0, 0]


# ---------------------------------------------------------------------------
# rank functions (run in the ranks)
# ---------------------------------------------------------------------------

def _rank_threads(n):
    torch.set_num_threads(n)


def _rank_pipeline(w, x, M, remat):
    """(out, aux_total, gradient of the rank's stage slice, gradient of x
    or None) of the rank's share of sum(out**2) + aux."""
    import torch.distributed as dist

    n = dist.get_world_size()
    config = ShardingConfig(pp=n)
    mesh = config.build_mesh(device_type="cpu")
    local = shard_params({"blocks": {"w": torch.from_numpy(w)}}, config,
                         mesh)["blocks"]
    local["w"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tpp.pipeline_apply(_torch_block, local, xt, mesh, M,
                                  remat=remat)
    share = 1 if M % n == 0 else n
    ((out ** 2).sum() / share + aux).backward()
    return (out.detach().numpy(), aux.item(), local["w"].grad.numpy(),
            None if xt.grad is None else xt.grad.numpy())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
@pytest.mark.parametrize("M", [1, 2, 4, 8, 16])
def test_schedule_info_matches_jax(M, n_stages):
    from ray_tpu.parallel.pipeline import schedule_info

    assert tpp.schedule_info(M, n_stages) == schedule_info(M, n_stages)


def test_stack_layer_params_matches_jax():
    import jax

    from ray_tpu.parallel.pipeline import stack_layer_params

    rng = np.random.default_rng(3)
    layers = [{"a": {"k": rng.standard_normal((3, 2)).astype(np.float32)},
               "b": rng.standard_normal(5).astype(np.float32)}
              for _ in range(4)]
    want = stack_layer_params(layers)
    got = tpp.stack_layer_params(
        [jax.tree.map(torch.from_numpy, lp) for lp in layers])
    assert got["a"]["k"].shape == (4, 3, 2) and got["b"].shape == (4, 5)
    np.testing.assert_array_equal(got["a"]["k"].numpy(), want["a"]["k"])
    np.testing.assert_array_equal(got["b"].numpy(), want["b"])


CASES = [(2, 2, True), (2, 4, True), (2, 8, False), (4, 2, True),
         (4, 4, False), (4, 8, True)]


@pytest.mark.parametrize("n,M,remat", CASES,
                         ids=[f"pp{n}-M{M}-{'remat' if r else 'graph'}"
                              for n, M, r in CASES])
def test_pipeline_apply_matches_jax(pool, n, M, remat):
    """Each rank's rows of the output (all rows when M % n != 0), the aux
    total, and the gradients with respect to the rank's stage slice and x
    (stage 0's) against JAX's pipeline_apply and jax.grad."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.mesh import create_mesh
    from ray_tpu.parallel.pipeline import pipeline_apply

    w, x = _inputs()
    mesh = create_mesh({"pp": n}, devices=jax.devices()[:n])

    def run(p, xx):
        return pipeline_apply(lambda q, h: (h @ q["w"], q["w"][0, 0]), p,
                              xx, mesh, num_microbatches=M)

    out, aux = run({"w": jnp.asarray(w)}, jnp.asarray(x))
    gw, gx = jax.grad(lambda p, xx: (lambda o, a: jnp.sum(o ** 2) + a)(
        *run(p, xx)), argnums=(0, 1))({"w": jnp.asarray(w)}, jnp.asarray(x))
    out, gw, gx = np.asarray(out), np.asarray(gw["w"]), np.asarray(gx)

    results = pool(n).run(_rank_pipeline, w, x, M, remat)
    c = L // n
    for r, (o, a, g, dx) in enumerate(results):
        rows = out.reshape(n, -1, T, W)[r] if M % n == 0 else out
        np.testing.assert_allclose(o, rows, rtol=0, atol=TOL)
        assert a == pytest.approx(float(aux), abs=TOL)
        np.testing.assert_allclose(g, gw[r * c:(r + 1) * c], rtol=0,
                                   atol=TOL * np.abs(gw).max())
        if r == 0:
            np.testing.assert_allclose(dx, gx, rtol=0,
                                       atol=TOL * np.abs(gx).max())
        else:
            assert dx is None  # only stage 0 reads x


def test_batch_must_divide_by_microbatches_like_jax():
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.mesh import create_mesh
    from ray_tpu.parallel.pipeline import pipeline_apply

    w, x = _inputs()
    mesh = create_mesh({"pp": 1}, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as jax_err:
        pipeline_apply(lambda q, h: (h @ q["w"], q["w"][0, 0]),
                       {"w": jnp.asarray(w)}, jnp.asarray(x), mesh, 3)
    with pytest.raises(ValueError) as err:
        tpp.pipeline_apply(_torch_block, {"w": torch.from_numpy(w)},
                           torch.from_numpy(x), None, 3)
    assert str(err.value) == str(jax_err.value)


def _rank_one_stage(w, x):
    import torch.distributed as dist

    mesh = ShardingConfig(dp=dist.get_world_size()).build_mesh(
        device_type="cpu")
    out, aux = tpp.pipeline_apply(_torch_block, {"w": torch.from_numpy(w)},
                                  torch.from_numpy(x), mesh, 4)
    return out.numpy(), aux.item()


def test_one_stage_runs_the_layers_in_order(pool):
    """On a mesh with no pp axis over 1 the pipeline is the layers applied
    to each microbatch in turn on the rank, with no hop."""
    w, x = _inputs(1)
    want = x
    for i in range(L):
        want = want @ w[i]
    for out, aux in pool(2).run(_rank_one_stage, w, x):
        np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
        assert aux == pytest.approx(float(w[:, 0, 0].sum()), abs=TOL)
