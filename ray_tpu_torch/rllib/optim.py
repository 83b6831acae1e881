"""The learners' optimizer steps, as optax computes them, and the tree
helpers they work over.

The JAX learners take ``optax.adam`` (PPO, DQN, SAC, BC) and
``optax.rmsprop(lr, decay=0.99, eps=0.1)`` (IMPALA), and clip by the
global norm themselves (``ray_tpu/rllib/ppo.py:103-107``,
``impala.py:138-142``).

- Adam: optax's arithmetic (eps outside the square root of the
  bias-corrected second moment, ``eps_root`` = 0) is
  ``torch.optim.Adam``'s, so ``adam`` builds one.
- RMSprop: optax divides by sqrt(nu + eps), nu starting at 0, with no
  momentum and no centering; ``torch.optim.RMSprop`` divides by
  sqrt(nu) + eps, which at eps = 0.1 is another step by a large factor.
  ``RMSprop`` here is optax's.
- The global-norm clip scales by min(1, clip / (||g|| + 1e-8));
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6.

Parameters are nested dicts of leaf tensors with the JAX package's names;
gradients come back as trees of the same structure.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, keys in sorted order at every level
    (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in
    ``tree_leaves``' order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def grads_of(loss, params) -> Dict[str, Any]:
    """d loss / d every leaf of ``params``, as a tree; zeros for a leaf the
    loss does not use (DQN's value head), as ``jax.grad`` gives."""
    return tree_unflatten(params, torch.autograd.grad(
        loss, tree_leaves(params), allow_unused=True, materialize_grads=True))


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by min(1, max_norm / (||grads|| + 1e-8)), computed
    on the leaves' device (no host sync)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-8), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def apply_gradients(optimizer: torch.optim.Optimizer, params, grads):
    """One step of ``optimizer`` (built over ``tree_leaves(params)``) with
    ``grads`` as the leaves' gradients; the leaves change in place."""
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)`` over the leaves of ``params``."""
    return torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)`` with its defaults otherwise
    (``eps_in_sqrt=True``, ``initial_scale=0``, no centering, no momentum,
    no bias correction): nu <- (1 - decay) g^2 + decay nu, then
    p <- p - lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - decay) * torch.square(g) + decay * nu)
                p.sub_(lr * (torch.rsqrt(nu + eps) * g))
