"""Policy/value networks — counterpart of ``ray_tpu/rllib/models.py``.

Functional init/apply pairs over parameter dicts with the JAX package's
names: an MLP (shared tanh torso, categorical policy head, value head)
and the Nature-CNN torso for pixel observations.  Dense weights are
(in, out) as in JAX; conv weights are OIHW, torch's layout, where JAX's
are HWIO (``params_from_numpy`` carries them across).  The CNN takes
NHWC observations as JAX does and permutes its last conv's output back to
NHWC before flattening, so ``fc.w``'s rows keep JAX's order.

Initialisers draw from an explicit ``torch.Generator`` with the JAX
initialisers' distributions (not their values: JAX's parameters come
across through ``params_from_numpy``); every leaf requires grad, as a
learner's parameters do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

#: the Nature-CNN's stride for each kernel size (``models.py:100``)
_STRIDE_FOR_KERNEL = {8: 4, 4: 2, 3: 1}


def _normal(generator, shape, scale, device):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return x.to(device).requires_grad_(True)


def _zeros(n, device):
    return torch.zeros(n, dtype=torch.float32, device=device,
                       requires_grad=True)


def init_mlp_policy(generator: torch.Generator, obs_dim: int,
                    num_actions: int, hidden: Sequence[int] = (64, 64),
                    device="cuda") -> Dict[str, Any]:
    """Shared torso (He-scaled normal), categorical policy head (std
    0.01) + value head (std 1), zero biases."""
    params = {}
    sizes = [obs_dim, *hidden]
    for i in range(len(hidden)):
        params[f"fc_{i}"] = {
            "w": _normal(generator, (sizes[i], sizes[i + 1]),
                         math.sqrt(2.0 / sizes[i]), device),
            "b": _zeros(sizes[i + 1], device),
        }
    params["pi"] = {"w": _normal(generator, (sizes[-1], num_actions), 0.01,
                                 device),
                    "b": _zeros(num_actions, device)}
    params["vf"] = {"w": _normal(generator, (sizes[-1], 1), 1.0, device),
                    "b": _zeros(1, device)}
    return params


def mlp_forward(params, obs):
    """obs (B, ...) -> (logits (B, A), value (B,)); trailing dims flatten.
    Integer observations enter as their f32 values (JAX's promotion)."""
    x = obs.reshape(obs.shape[0], -1).to(torch.float32)
    i = 0
    while f"fc_{i}" in params:
        p = params[f"fc_{i}"]
        x = torch.tanh(x @ p["w"] + p["b"])
        i += 1
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def init_cnn_policy(generator: torch.Generator, obs_shape, num_actions: int,
                    channels=(32, 64, 64), dense: int = 512,
                    device="cuda") -> Dict[str, Any]:
    """Nature-CNN torso: conv 8x8/4, 4x4/2, 3x3/1 -> dense -> categorical
    + value heads, He-scaled normal weights.  obs_shape = (H, W, C)."""
    H, W, C = obs_shape
    specs = [(8, 4, C, channels[0]), (4, 2, channels[0], channels[1]),
             (3, 1, channels[1], channels[2])]
    params = {}
    h, w = H, W
    for i, (k, s, cin, cout) in enumerate(specs):
        params[f"conv_{i}"] = {
            "w": _normal(generator, (cout, cin, k, k),
                         math.sqrt(2.0 / (k * k * cin)), device),
            "b": _zeros(cout, device),
        }
        h = (h - k) // s + 1
        w = (w - k) // s + 1
    flat = h * w * channels[-1]
    params["fc"] = {"w": _normal(generator, (flat, dense),
                                 math.sqrt(2.0 / flat), device),
                    "b": _zeros(dense, device)}
    params["pi"] = {"w": _normal(generator, (dense, num_actions), 0.01,
                                 device),
                    "b": _zeros(num_actions, device)}
    params["vf"] = {"w": _normal(generator, (dense, 1), 1.0, device),
                    "b": _zeros(1, device)}
    return params


def cnn_forward(params, obs):
    """obs (B, H, W, C) uint8 or float -> (logits, value); uint8 frames
    are scaled by 1/255.  VALID convolutions (no padding) with the stride
    of each kernel size."""
    x = obs.to(torch.float32)
    if obs.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    i = 0
    while f"conv_{i}" in params:
        p = params[f"conv_{i}"]
        s = _STRIDE_FOR_KERNEL[p["w"].shape[-1]]
        x = F.relu(F.conv2d(x, p["w"], p["b"], stride=s))
        i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc"]["w"] + params["fc"]["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def policy_forward(params, obs):
    """Dispatch on the param structure: CNN torso when conv layers are
    present, MLP otherwise."""
    if "conv_0" in params:
        return cnn_forward(params, obs)
    return mlp_forward(params, obs)


def _gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1),
    as ``jax.random.gumbel`` draws it, on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


@torch.no_grad()
def sample_action(params, obs, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
    """(action, logp, value) for a batch of observations: the action by
    Gumbel-max over the logits (``jax.random.categorical``), the noise
    drawn from ``generator`` or given as ``noise`` (B, A)."""
    logits, value = policy_forward(params, obs)
    if noise is None:
        noise = _gumbel(logits.shape, generator).to(logits.device)
    action = torch.argmax(logits + noise, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, action[:, None])[:, 0]
    return action, logp, value


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """A JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's parameters on ``device``, same names: f32
    leaves that require grad, 4-d conv weights HWIO -> OIHW."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = torch.tensor(node, dtype=torch.float32)
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device).requires_grad_(True)

    return conv(tree)


def params_to_numpy(params):
    """The port's parameters -> the JAX package's host tree
    (``jax.tree.map(np.asarray, params)``): f32 numpy arrays of the same
    names, 4-d conv weights OIHW -> HWIO; the inverse of
    ``params_from_numpy``.  Leaves that are not tensors pass unchanged."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        t = node.detach()
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return t.to("cpu", copy=True).contiguous().numpy()

    return conv(params)


@torch.no_grad()
def load_params(params, tree) -> None:
    """Copy a host tree of ``params_to_numpy``'s form into the leaves of
    ``params`` in place (an optimizer built over them keeps its state)."""
    for name, node in tree.items():
        if isinstance(node, dict):
            load_params(params[name], node)
        else:
            src = torch.as_tensor(node, dtype=torch.float32)
            if src.ndim == 4:
                src = src.permute(3, 2, 0, 1)
            params[name].copy_(src)
