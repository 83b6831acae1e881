"""GPT-2 in plain PyTorch, float32 with TF32 off: the reference that the
benchmark holds the program to.

It follows the published model (Radford et al. 2019; the Hugging Face
``GPT2LMHeadModel``): learned positions added to the token embedding,
pre-norm blocks (layer norm with eps 1e-5, causal softmax attention over
fused q, k, v, the tanh-approximated GELU of ``gelu_new`` in a 4E MLP), a
final layer norm and the lm head tied to the token embedding.  Departures:
no dropout (the program has none; the configuration files keep the
published rates and say so under ``assumed``), and AdamW applies its
weight decay to every leaf, as one parameter group does.

The weights come from ``init_weights``, the benchmark's own initializer,
drawn from the seed on the device in one call; the program is handed the
same values.  Nothing here imports the program.

``matmul`` is every product of the model (the projections, the two of
attention and the lm head): ``torch.matmul`` for the reference, and
``fp8_matmul`` for the control, the same model with each product's
operands rounded to float8 (e4m3 forward, e5m2 for the gradients, one
scale per tensor), the precision below the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping

import torch
import torch.nn.functional as F

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def set_precision():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dims(config: Mapping):
    return (int(config["n_layer"]), int(config["n_embd"]),
            int(config["n_head"]), int(config["vocab_size"]),
            int(config["n_positions"]))


def leaf_shapes(config: Mapping) -> Dict[str, tuple]:
    """Every leaf's name and shape, in the order ``init_weights`` draws
    them.  Kernels are (in, out), as GPT-2's Conv1D keeps them."""
    L, E, _, V, P = _dims(config)
    shapes = {"wte": (V, E), "wpe": (P, E)}
    for i in range(L):
        shapes.update({
            f"h{i}.ln_1.g": (E,), f"h{i}.ln_1.b": (E,),
            f"h{i}.attn.c_attn.w": (E, 3 * E), f"h{i}.attn.c_attn.b": (3 * E,),
            f"h{i}.attn.c_proj.w": (E, E), f"h{i}.attn.c_proj.b": (E,),
            f"h{i}.ln_2.g": (E,), f"h{i}.ln_2.b": (E,),
            f"h{i}.mlp.c_fc.w": (E, 4 * E), f"h{i}.mlp.c_fc.b": (4 * E,),
            f"h{i}.mlp.c_proj.w": (4 * E, E), f"h{i}.mlp.c_proj.b": (E,)})
    shapes.update({"ln_f.g": (E,), "ln_f.b": (E,)})
    return shapes


def _std(name: str, L: int) -> float:
    """GPT-2's scheme: normal 0.02, positions 0.01, the residual
    projections 0.02 / sqrt(2 L)."""
    if name == "wpe":
        return 0.01
    if name.endswith("c_proj.w"):
        return 0.02 / math.sqrt(2 * L)
    return 0.02


def init_weights(seed: int, config: Mapping, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed``: one normal draw on ``device`` for
    every matrix, cut into views and scaled; biases 0, layer-norm gains 1.
    The same seed gives the same values on the same device."""
    L = _dims(config)[0]
    shapes = leaf_shapes(config)
    drawn = [n for n, s in shapes.items() if len(s) == 2]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(math.prod(shapes[n]) for n in drawn),
                       generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    with torch.no_grad():
        for n in drawn:
            k = math.prod(shapes[n])
            out[n] = flat[at:at + k].view(shapes[n]).mul_(_std(n, L))
            at += k
        for n, s in shapes.items():
            if len(s) == 1:
                fill = 1.0 if n.endswith(".g") else 0.0
                out[n] = torch.full(s, fill, dtype=torch.float32,
                                    device=device)
    return {n: out[n] for n in shapes}


# --------------------------------------------------------------------------
# the model


def _layer_norm(x, g, b):
    return F.layer_norm(x, x.shape[-1:], g, b, eps=1e-5)


def _linear(x, w, b, mm: MatMul):
    return mm(x, w) + b


def _attention(x, w, i, H, mm: MatMul):
    B, S, E = x.shape
    D = E // H
    qkv = _linear(x, w[f"h{i}.attn.c_attn.w"], w[f"h{i}.attn.c_attn.b"], mm)
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(B, S, E)
    return _linear(o, w[f"h{i}.attn.c_proj.w"], w[f"h{i}.attn.c_proj.b"], mm)


def _mlp(x, w, i, mm: MatMul):
    h = F.gelu(_linear(x, w[f"h{i}.mlp.c_fc.w"], w[f"h{i}.mlp.c_fc.b"], mm),
               approximate="tanh")
    return _linear(h, w[f"h{i}.mlp.c_proj.w"], w[f"h{i}.mlp.c_proj.b"], mm)


def forward(w: Mapping[str, torch.Tensor], tokens: torch.Tensor,
            config: Mapping, mm: MatMul = torch.matmul) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), float32."""
    L, _, H, _, P = _dims(config)
    S = tokens.shape[1]
    if S > P:
        raise ValueError(f"{S} tokens exceed n_positions {P}")
    x = w["wte"][tokens] + w["wpe"][:S][None]
    for i in range(L):
        x = x + _attention(_layer_norm(x, w[f"h{i}.ln_1.g"],
                                       w[f"h{i}.ln_1.b"]), w, i, H, mm)
        x = x + _mlp(_layer_norm(x, w[f"h{i}.ln_2.g"], w[f"h{i}.ln_2.b"]),
                     w, i, mm)
    x = _layer_norm(x, w["ln_f.g"], w["ln_f.b"])
    return mm(x, w["wte"].T)


def mean_loss(w, tokens, config, rows: int = 1,
              mm: MatMul = torch.matmul) -> float:
    """The mean next-token cross-entropy of tokens (B, S+1), no gradient,
    ``rows`` rows at a time."""
    total = 0.0
    with torch.no_grad():
        for part in tokens.split(rows):
            logits = forward(w, part[:, :-1], config, mm)
            total += F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     part[:, 1:].reshape(-1),
                                     reduction="sum").item()
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))


def loss_and_grads(w, tokens, config, mm: MatMul = torch.matmul,
                   rows: int = 1):
    """(mean next-token cross-entropy over the batch, its gradient by leaf)
    for tokens (B, S+1), ``rows`` rows at a time."""
    names = list(w)
    leaves = [w[n].detach().requires_grad_(True) for n in names]
    tied = dict(zip(names, leaves))
    total = 0.0
    grads = [torch.zeros_like(t) for t in leaves]
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    for part in tokens.split(rows):
        logits = forward(tied, part[:, :-1], config, mm)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               part[:, 1:].reshape(-1), reduction="sum")
        for g, d in zip(grads, torch.autograd.grad(loss, leaves)):
            g.add_(d)
        total += loss.item()
        del logits, loss
    return total / count, {n: g.div_(count) for n, g in zip(names, grads)}


class AdamW:
    """Decoupled weight decay Adam (Loshchilov and Hutter), written out:
    p <- p (1 - lr wd); m, v moments; p <- p - lr m^ / (sqrt(v^) + eps)."""

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.t, self.m, self.v = 0, {}, {}

    @torch.no_grad()
    def step(self, w, grads):
        self.t += 1
        b1, b2 = self.betas
        for n, g in grads.items():
            m = self.m.setdefault(n, torch.zeros_like(g))
            v = self.v.setdefault(n, torch.zeros_like(g))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = m / (1 - b1 ** self.t)
            vh = v / (1 - b2 ** self.t)
            w[n].mul_(1 - self.lr * self.wd)
            w[n].sub_(self.lr * mh / (vh.sqrt() + self.eps))


def leaf_parts(name: str, t: torch.Tensor):
    """(name, view) of each part of a leaf whose norm is compared: the
    leaf whole, but the fused attention bias in its q, k and v thirds.
    The key third has no gradient in exact arithmetic (softmax ignores a
    shift of each row's scores), so its change under Adam is round-off on
    either side; cut apart, the rule on the reference's first gradient
    (``moved_leaves``) leaves it out and keeps the other two."""
    if name.endswith(".attn.c_attn.b"):
        return [(f"{name}.{p}", x) for p, x in zip("qkv", t.chunk(3))]
    return [(name, t)]


def leaf_norms(leaves) -> Dict[str, float]:
    """The norm of every part (``leaf_parts``) of each (name, tensor) of
    ``leaves``, read back in one transfer.  A tensor made for the call (a
    difference) is freed once its norms are taken."""
    names, norms = [], []
    with torch.no_grad():
        for n, t in leaves:
            for part, x in leaf_parts(n, t):
                names.append(part)
                norms.append(x.float().norm())
    return dict(zip(names, torch.stack(norms).tolist()))


def follow_steps(seed: int, config: Mapping, train: Mapping, batches,
                 device, mm: MatMul = torch.matmul, rows: int = 1) -> Dict:
    """The reference's first steps from the seed's weights on ``batches``
    (each (B, S+1) tokens): each step's loss, the first gradient's norm
    and, after the last step, the change's norm, by leaf part
    (``leaf_norms``)."""
    w = init_weights(seed, config, device)
    w0 = {n: t.clone() for n, t in w.items()}
    opt = AdamW(float(train["lr"]), tuple(train["betas"]),
                float(train["eps"]), float(train["weight_decay"]))
    losses: List[float] = []
    grad1 = None
    for tokens in batches:
        loss, grads = loss_and_grads(w, tokens.to(device), config, mm, rows)
        losses.append(loss)
        if grad1 is None:
            grad1 = leaf_norms(grads.items())
        opt.step(w, grads)
        del grads
    change = leaf_norms((n, w[n] - w0[n]) for n in w)
    return {"losses": losses, "grad1": grad1, "change": change}


# --------------------------------------------------------------------------
# the control: the same model with every product in float8


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under one scale that maps its largest
    magnitude to the format's largest finite value; back in float32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = _fp8(a, torch.float8_e4m3fn)
        bq = _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        gb = torch.matmul(aq.transpose(-1, -2), gq)
        if bq.dim() == 2 and gb.dim() > 2:
            gb = gb.reshape(-1, *gb.shape[-2:]).sum(0)
        if aq.dim() == 2 and ga.dim() > 2:
            ga = ga.reshape(-1, *ga.shape[-2:]).sum(0)
        return ga, gb


def fp8_matmul(a, b):
    """``torch.matmul`` with both operands rounded to float8 e4m3 and the
    incoming gradient to e5m2, products accumulated in float32."""
    return _FP8MatMul.apply(a, b)
