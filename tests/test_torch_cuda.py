"""The CUDA flash-attention kernel on the card, against its plain version.

Marked ``cuda``: every test skips where there is no CUDA device.  On a
machine with one (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

from dataclasses import replace

import pytest
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# o, as in chip_smoke.py: both round o to bf16 (<= 2^-8 |o| apart), and the
# kernel rounds p to bf16 before p@v (<= 2^-9 P@|v|, which can exceed |o|
# where the terms of a row cancel); each held with 2x room
O_RTOL, O_PTOL = 1e-2, 2.0 ** -8
# lse: f32 on both sides from exact bf16 products; summation order only
LSE_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _plain(q, k, v, causal, layout):
    """The plain version's (o, lse) and its o tolerance per element."""
    tr = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
    scale = q.shape[-1] ** -0.5
    o, lse = fa._reference_attention(tr(q), tr(k), tr(v), scale, causal)
    o_mag, _ = fa._reference_attention(tr(q), tr(k), tr(v).abs(), scale,
                                       causal)
    tol = O_RTOL * o.float().abs() + O_PTOL * o_mag.float()
    return tr(o), lse, tr(tol)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 65, 200])
def test_kernel_matches_plain(cuda, S, D, causal, layout):
    B, H = 2, 3
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    fwd = fa._flash_fwd_bshd if layout == "bshd" else fa._flash_fwd
    before = fa.KERNEL_LAUNCHES
    o, (_, _, _, _, lse) = fwd(q, k, v, causal, None, None, None)
    torch.cuda.synchronize()
    assert fa.KERNEL_LAUNCHES == before + 1
    o_ref, lse_ref, o_tol = _plain(q, k, v, causal, layout)
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, S)
    assert ((o.float() - o_ref.float()).abs() <= o_tol).all()
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_strided_and_misaligned_inputs(cuda):
    base = torch.randn((1, 70, 4, 65), generator=cuda, device="cuda",
                       dtype=torch.bfloat16)
    q = base[..., 1:]  # rows not 16-byte aligned: the wrapper copies
    k, v = (torch.randn((1, 4, 70, 64), generator=cuda, device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)  # bhsd memory
            for _ in range(2))
    o = fa.flash_attention_bshd(q, k, v, True)
    ref = fa.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), True)
    torch.testing.assert_close(o, ref, atol=0, rtol=0)


def test_unsupported_inputs_raise(cuda):
    x = torch.zeros((1, 8, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_bshd(x, x, x)
    y = torch.zeros((1, 8, 2, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_bshd(y, y, y)


def test_gpt2_tiny_flash_matches_dense(cuda):
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(cuda, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=cuda,
                           device="cuda")
    before = fa.KERNEL_LAUNCHES
    flash = gpt2.forward(params, tokens, cfg)
    assert fa.KERNEL_LAUNCHES == before + cfg.n_layer
    dense = gpt2.forward(params, tokens, replace(cfg, attention="dense"))
    # bf16 activations: ~1 ulp of attention output per layer (chip_smoke.py)
    assert (flash - dense).abs().max().item() <= 0.1
