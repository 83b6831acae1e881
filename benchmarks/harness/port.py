"""How the benchmark hands a configuration and its weights to the program.

The program's GPT-2 (``ray_tpu_torch.models.gpt2``) takes a
``GPT2Config`` and a nested dict of float32 tensors under the JAX
package's names.  ``model_config`` builds the config from a configuration
file (published widths; the file's ``assumed`` says how it is trained),
and ``port_params`` arranges the benchmark's own weights
(``reference.gpt2.init_weights``) under the program's names, the same
tensors, no copy.
"""

from __future__ import annotations

from typing import Dict, Mapping


def model_config(config: Mapping):
    """The program's ``GPT2Config`` at the file's widths: bf16 compute,
    flash attention, remat as ``assumed`` says."""
    import torch

    from ray_tpu_torch.models import gpt2

    assumed = config["assumed"]
    if assumed["compute_dtype"] != "bfloat16":
        raise ValueError(f"compute dtype {assumed['compute_dtype']!r}")
    return gpt2.GPT2Config(
        vocab_size=int(config["vocab_size"]),
        block_size=int(config["n_positions"]),
        n_layer=int(config["n_layer"]), n_head=int(config["n_head"]),
        n_embd=int(config["n_embd"]), compute_dtype=torch.bfloat16,
        attention="flash", remat=bool(assumed["remat"]))


def leaf_names(n_layer: int) -> Dict[str, str]:
    """The program's leaf path (``named_leaves``) -> the reference's leaf
    name."""
    out = {"wte/embedding": "wte", "wpe/embedding": "wpe",
           "ln_f/scale": "ln_f.g", "ln_f/bias": "ln_f.b"}
    for i in range(n_layer):
        p, r = f"h_{i}/", f"h{i}."
        for ln in ("ln_1", "ln_2"):
            out[f"{p}{ln}/scale"] = f"{r}{ln}.g"
            out[f"{p}{ln}/bias"] = f"{r}{ln}.b"
        for mod in ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj"):
            dotted = mod.replace("/", ".")
            out[f"{p}{mod}/kernel"] = f"{r}{dotted}.w"
            out[f"{p}{mod}/bias"] = f"{r}{dotted}.b"
    return out


def port_params(weights: Mapping, n_layer: int) -> Dict:
    """The reference's weights as the program's parameter tree."""
    tree: Dict = {}
    for path, name in leaf_names(n_layer).items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = weights[name]
    return tree
