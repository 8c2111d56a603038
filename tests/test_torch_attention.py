"""The port's packed attention (ot_vae_tpu_torch/ops/attention.py) against the
JAX package's Pallas kernel in interpret mode, on the CPU.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against ``attention_packed_reference`` at the main path's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.ops.attention_pallas import _packed_fwd_call, fused_attention_packed
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.ops.attention import attention_packed, attention_packed_reference

# f32 on both sides, same products and softmax; only the summation order
# differs, which stays far below 1e-5 at these sizes
ATOL = 1e-5

SHAPES = [(2, 64, 2, 16), (1, 37, 3, 8)]  # (B, T, H, C); T=37 is ragged


def _qkv(b, t, h, c, seed):
    return np.random.default_rng(seed).standard_normal((b, t, 3 * h * c)).astype(np.float32)


@pytest.mark.parametrize("b,t,h,c", SHAPES)
def test_reference_matches_pallas_packed(b, t, h, c):
    qkv = _qkv(b, t, h, c, seed=t)
    scale = 1.0 / np.sqrt(c)
    want = np.asarray(fused_attention_packed(jnp.asarray(qkv), h, scale, interpret=True))
    out, _ = attention_packed_reference(torch.from_numpy(qkv), h, scale)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,t,h,c", SHAPES)
def test_reference_lse_matches_pallas_packed(b, t, h, c):
    qkv = _qkv(b, t, h, c, seed=100 + t)
    scale = 1.0 / np.sqrt(c)
    want_out, want_lse = _packed_fwd_call(jnp.asarray(qkv), h, scale, True)
    out, lse = attention_packed_reference(torch.from_numpy(qkv), h, scale)
    assert lse.shape == (b, t, h) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL, rtol=0)


def test_bf16_reference_matches_pallas_packed():
    """bf16 inputs: both round P to bf16 before P·V and the output to bf16;
    allow 2 bf16 ulps at |out| < 1 (2 · 2^-8)."""
    b, t, h, c = 2, 64, 2, 16
    qkv = _qkv(b, t, h, c, seed=7)
    scale = 1.0 / np.sqrt(c)
    want_out, want_lse = _packed_fwd_call(jnp.asarray(qkv, jnp.bfloat16), h, scale, True)
    out, lse = attention_packed_reference(torch.from_numpy(qkv).bfloat16(), h, scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out, np.float32),
                               atol=2 * 2.0**-8, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=0)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    qkv = torch.from_numpy(_qkv(1, 16, 2, 8, seed=3))
    before = attention.launch_count
    out, lse = attention_packed(qkv, 2)
    ref_out, ref_lse = attention_packed_reference(qkv, 2, 1.0 / np.sqrt(8))
    assert attention.launch_count == before
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        attention_packed(torch.zeros(1, 4, 10), 2)  # 10 not divisible by 3·2
    with pytest.raises(ValueError):
        attention_packed(torch.zeros(4, 30), 1)  # not [B, T, 3·H·C]
    with pytest.raises(ValueError):
        attention_packed(torch.zeros(1, 4, 24, device="meta"), 1)  # no kernel there
