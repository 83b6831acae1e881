"""ray_tpu_torch.ops.flash_attention against ray_tpu.ops.flash_attention.

The same numpy inputs (fixed seed) go through the JAX forward — the Pallas
kernels in interpret mode, as tests/test_parallel.py runs them on the CPU
(``q.size <= 65536``) — and through the port, whose CPU path is the plain
version of the CUDA kernel.  The kernel itself runs only on the card
(chip_smoke.py holds it against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

# f32: both sides compute in f32 and differ only in summation order and
# exp2-vs-exp (measured ~1e-6 on these shapes).
F32_TOL = 1e-4
# bf16 o: one bf16 ulp at |o| < 2 is 2^-7 = 0.0078; the suite's TOL.
BF16_O_TOL = 2e-2
# bf16 lse: the JAX kernel rounds q*sm_scale*log2(e) to bf16 (2^-9
# relative on base-2 scores up to ~10) and exponentiates in bf16, the
# port's plain version works in f32; measured 1.2e-2 to 1.5e-2.
BF16_LSE_TOL = 3e-2

# (name, shape, layout): the lane kernel (_fwd_kernel_lanes, S % 128 == 0,
# two 64-dim heads per 128-lane block) and the bhsd kernel (_fwd_kernel,
# whole-S block of 100).
CASES = [
    ("lanes", (1, 256, 2, 64), "bshd"),
    ("bhsd", (1, 4, 100, 32), "bhsd"),
]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_fwd(qkv, layout, causal, dtype):
    q, k, v = (jnp.asarray(x, dtype) for x in qkv)
    S = q.shape[1] if layout == "bshd" else q.shape[2]
    # the Pallas kernel, not the reference, must be what JAX runs here
    assert jfa._use_pallas(q, S, S, S) is False  # interpret mode
    if layout == "bshd":
        assert jfa._bshd_lanes_ok(q, S, S, S)
        o, (_, _, _, _, lse) = jfa._flash_fwd_bshd(q, k, v, causal, None,
                                                   None, None)
    else:
        o, (_, _, _, _, lse) = jfa._flash_fwd(q, k, v, causal, None, None,
                                              None)
    return np.asarray(o, np.float32), np.asarray(lse)


def _torch_fwd(qkv, layout, causal, dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in qkv)
    fwd = tfa._flash_fwd_bshd if layout == "bshd" else tfa._flash_fwd
    o, (_, _, _, _, lse) = fwd(q, k, v, causal, None, None, None)
    public = tfa.flash_attention_bshd if layout == "bshd" \
        else tfa.flash_attention
    assert torch.equal(public(q, k, v, causal), o)
    assert lse.dtype == torch.float32
    assert lse.shape == (q.shape[0], q.shape[2] if layout == "bshd"
                         else q.shape[1], q.shape[1] if layout == "bshd"
                         else q.shape[2])
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name,shape,layout", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax_f32(name, shape, layout, causal):
    qkv = _inputs(shape)
    jo, jl = _jax_fwd(qkv, layout, causal, jnp.float32)
    to, tl = _torch_fwd(qkv, layout, causal, torch.float32)
    np.testing.assert_allclose(to, jo, atol=F32_TOL)
    np.testing.assert_allclose(tl, jl, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name,shape,layout", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax_bf16(name, shape, layout, causal):
    qkv = _inputs(shape, seed=1)
    jo, jl = _jax_fwd(qkv, layout, causal, jnp.bfloat16)
    to, tl = _torch_fwd(qkv, layout, causal, torch.bfloat16)
    np.testing.assert_allclose(to, jo, atol=BF16_O_TOL)
    np.testing.assert_allclose(tl, jl, atol=BF16_LSE_TOL)


def test_mha_alias_and_default_scale():
    q, k, v = (torch.from_numpy(x) for x in _inputs((2, 37, 3, 32), seed=2))
    o = tfa.mha(q, k, v, causal=True)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    ref, _ = tfa._reference_attention(tr(q), tr(k), tr(v), 32 ** -0.5, True)
    torch.testing.assert_close(o, tr(ref))
    # block sizes are hints: any values give the same result
    torch.testing.assert_close(
        tfa.flash_attention_bshd(q, k, v, True, None, 16, 8), o)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_requires_grad_inputs_get_gradients(layout):
    """Inputs that require grad get the plain backward's gradients on the
    CPU, also from ``o.sum()``, whose do autograd hands over expanded (zero
    strides)."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs((1, 2, 16, 32), seed=3))
    fn = tfa.flash_attention if layout == "bhsd" else tfa.flash_attention_bshd
    o = fn(q, k, v, True)
    o.sum().backward()
    tr = (lambda x: x) if layout == "bhsd" else (  # noqa: E731
        lambda x: x.transpose(1, 2))
    qd, kd, vd = (tr(x.detach()) for x in (q, k, v))
    o_ref, lse = tfa._reference_attention(qd, kd, vd, 32 ** -0.5, True)
    ref = tfa._reference_attention_bwd(qd, kd, vd, o_ref, lse,
                                       torch.ones_like(o_ref), 32 ** -0.5,
                                       True)
    for x, g in zip((q, k, v), ref):
        torch.testing.assert_close(x.grad, tr(g))


def test_kernel_ready_takes_strides_and_copies_what_it_must():
    """The kernels read an input through its strides when D has unit
    stride and rows are 16-byte aligned; a zero leading stride (a
    broadcast do) is read as it is; anything else is copied."""
    x = torch.zeros((2, 8, 3, 64))
    assert tfa._kernel_ready(x) is x
    view = x.transpose(1, 2)                         # other layout's memory
    assert tfa._kernel_ready(view) is view
    bcast = torch.zeros((1, 8, 3, 64)).expand(4, 8, 3, 64)
    assert bcast.stride(0) == 0 and tfa._kernel_ready(bcast) is bcast
    ones = torch.ones(()).expand(2, 8, 3, 64)          # o.sum()'s do
    ready = tfa._kernel_ready(ones)
    assert ready.stride(-1) == 1 and ready.is_contiguous()
    odd = torch.zeros((2, 8, 3, 65))[..., 1:]          # rows misaligned
    assert tfa._kernel_ready(odd).is_contiguous()
    strided = torch.zeros((2, 8, 3, 128))[..., ::2]    # D stride 2
    assert tfa._kernel_ready(strided).stride(-1) == 1


def test_backward_kernel_path_rejects_what_it_does_not_take():
    """The backward's CUDA path validates before it touches the card."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt,  # noqa: E731
                                         device="meta")
    x = meta((1, 8, 2, 64), torch.bfloat16)
    lse = meta((1, 2, 8), torch.float32)
    before = (tfa.BWD_DQ_LAUNCHES, tfa.BWD_DKV_LAUNCHES)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa._kernel_backward(x, x, x, meta((1, 8, 2, 64), torch.float32), lse,
                             x, True, 1.0, "bshd")
    with pytest.raises(ValueError, match="head dim 48"):
        y = meta((1, 8, 2, 48), torch.bfloat16)
        tfa._kernel_backward(y, y, y, y, lse, y, True, 1.0, "bshd")
    with pytest.raises(TypeError, match="lse must be float32"):
        tfa._kernel_backward(x, x, x, x, lse.to(torch.bfloat16), x, True,
                             1.0, "bshd")
    with pytest.raises(ValueError, match="delta must be"):
        tfa._kernel_backward(x, x, x, x, lse, x, True, 1.0, "bshd",
                             delta=meta((1, 8, 2), torch.float32))
    with pytest.raises(ValueError, match="no flash-attention path"):
        tfa._flash_bwd_bshd(True, None, None, None, (x, x, x, x, lse), x)
    assert (tfa.BWD_DQ_LAUNCHES, tfa.BWD_DKV_LAUNCHES) == before


def test_kernel_path_rejects_what_it_does_not_take():
    """The CUDA path validates before it touches the card: a dtype or head
    dim the kernel lacks raises; nothing falls back to the plain version."""
    meta = lambda shape, dt: [torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
                              for _ in range(3)]
    with pytest.raises(TypeError, match="bfloat16"):
        tfa._kernel_forward(*meta((1, 8, 2, 64), torch.float32), True, 1.0,
                            "bshd")
    with pytest.raises(ValueError, match="head dim 48"):
        tfa._kernel_forward(*meta((1, 8, 2, 48), torch.bfloat16), True, 1.0,
                            "bshd")
    # a device that is neither the CPU nor CUDA has no path at all
    before = tfa.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="no flash-attention path"):
        tfa.flash_attention_bshd(*meta((1, 8, 2, 64), torch.bfloat16), True)
    assert tfa.KERNEL_LAUNCHES == before


def test_cuda_request_raises_without_cuda():
    """Asked for the card where there is none, the port raises; it never
    moves quietly to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 8, 2, 64)))
    with pytest.raises((RuntimeError, AssertionError)):
        tfa.flash_attention_bshd(q.to("cuda"), k.to("cuda"), v.to("cuda"))


def test_backward_cuda_request_raises_without_cuda():
    """The backward, asked for the card where there is none, raises too."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 8, 2, 64)))
    o, res = tfa._flash_fwd_bshd(q, k, v, True, None, None, None)
    with pytest.raises((RuntimeError, AssertionError)):
        tfa._flash_bwd_bshd(True, None, None, None,
                            tuple(x.to("cuda") for x in res), o.to("cuda"))
