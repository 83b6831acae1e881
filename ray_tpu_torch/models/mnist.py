"""The MNIST CNN — counterpart of ``ray_tpu/models/mnist.py``.

conv 3x3 (32) -> relu -> max-pool 2 -> conv 3x3 (64) -> relu -> max-pool
2 -> dense 128 -> relu -> dense 10, on NHWC images as in JAX.  Parameters
keep JAX's names; conv kernels are OIHW, torch's layout, where JAX's are
HWIO (``params_from_numpy`` carries them across), and the last pool's
NCHW output is permuted to NHWC before flattening, so ``fc1.kernel``'s
rows keep JAX's order.  SAME 3x3 convolutions are ``padding=1``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

# params_from_numpy: JAX's tree as numpy -> f32 leaves on a device that
# require grad, conv kernels HWIO -> OIHW; the policy nets' conversion and
# initialisers serve this model too
from ray_tpu_torch.rllib.models import (  # noqa: F401
    _normal, _zeros, params_from_numpy)


def init_params(generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """He-scaled normal kernels, zero biases (JAX's distributions); every
    leaf f32 on ``device`` and requiring grad."""
    def he(shape, fan_in):
        return _normal(generator, shape, (2.0 / fan_in) ** 0.5, device)

    def zeros(n):
        return _zeros(n, device)

    return {
        "conv1": {"kernel": he((32, 1, 3, 3), 9), "bias": zeros(32)},
        "conv2": {"kernel": he((64, 32, 3, 3), 9 * 32), "bias": zeros(64)},
        "fc1": {"kernel": he((7 * 7 * 64, 128), 7 * 7 * 64),
                "bias": zeros(128)},
        "fc2": {"kernel": he((128, 10), 128), "bias": zeros(10)},
    }


def forward(params, x):
    """x: (B, 28, 28, 1) -> logits (B, 10)."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, params["conv1"]["kernel"], params["conv1"]["bias"],
                        padding=1))
    x = F.max_pool2d(x, 2)
    x = F.relu(F.conv2d(x, params["conv2"]["kernel"], params["conv2"]["bias"],
                        padding=1))
    x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["kernel"] + params["fc1"]["bias"])
    return x @ params["fc2"]["kernel"] + params["fc2"]["bias"]


def loss_fn(params, batch):
    """(mean cross-entropy, accuracy) of a batch {image, label}."""
    logits = forward(params, batch["image"])
    labels = batch["label"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(logp.gather(-1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc


def synthetic_batch(generator: torch.Generator, batch_size=64,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic synthetic MNIST-shaped data (class-dependent means),
    as JAX builds it: labels uniform in [0, 10), images N(0, 0.1^2) plus
    label / 10 times a ramp from 0 to 1 over the 784 pixels."""
    dev = generator.device
    labels = torch.randint(0, 10, (batch_size,), generator=generator,
                           device=dev)
    base = torch.randn((batch_size, 28, 28, 1), generator=generator,
                       device=dev) * 0.1
    pattern = torch.linspace(0, 1, 28 * 28, device=dev).reshape(28, 28, 1)
    x = base + (labels[:, None, None, None] / 10.0) * pattern[None]
    return {"image": x.to(device), "label": labels.to(device)}

