"""The port's packed-attention backward (ot_vae_tpu_torch/ops/attention.py)
against the JAX package's Pallas backward in interpret mode, on the CPU.

The CUDA backward kernel runs only on the card: chip_smoke.py holds it
against ``attention_packed_backward_reference`` at the training path's
shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.ops.attention_pallas import fused_attention_packed as jax_fused_attention_packed
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.ops.attention import (
    attention_packed_backward,
    attention_packed_backward_reference,
    attention_packed_reference,
    fused_attention_packed,
)

SHAPES = [(2, 64, 2, 16), (1, 37, 3, 8)]  # (B, T, H, C); T=37 is ragged
# the bf16 tensor-core kernels' tile and alignment edges: T one row past a
# 64-row tile at C = 48, and T two rows past two tiles at C = 13 with H = 3,
# where the k and v column blocks of qkv and dqkv start off 16 bytes
TILE_SHAPES = [(1, 65, 2, 48), (1, 130, 3, 13)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the same f32 products on both sides, summed in another order over at
# most 130 keys: measured ≤ 8.4e-7 at gradients up to 1.5. bf16: both round P
# and dS to bf16 before their products and dqkv to bf16; a one-ulp split of
# one rounding moves an entry by at most 2^-7 at |dqkv| < 2 (measured 1e-3;
# 1.2e-4 at the tile edges).
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


def _inputs(b, t, h, c, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, t, 3 * h * c)).astype(np.float32)
    dout = rng.standard_normal((b, t, h * c)).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,t,h,c", SHAPES + TILE_SHAPES)
def test_plain_backward_matches_pallas_vjp(b, t, h, c, dtype):
    jdt, tdt = DTYPES[dtype]
    qkv, dout = _inputs(b, t, h, c, seed=t)
    scale = 1.0 / np.sqrt(c)
    _, vjp = jax.vjp(lambda x: jax_fused_attention_packed(x, h, scale, interpret=True),
                     jnp.asarray(qkv, jdt))
    (want,) = vjp(jnp.asarray(dout, jdt))
    q = torch.from_numpy(qkv).to(tdt)
    out, lse = attention_packed_reference(q, h, scale)
    got = attention_packed_backward_reference(q, out, lse, torch.from_numpy(dout).to(tdt),
                                              h, scale)
    assert got.dtype == tdt and got.shape == qkv.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


def test_function_gradcheck_float64():
    """The autograd Function's backward is the derivative of its forward."""
    qkv = torch.randn(1, 5, 3 * 2 * 8, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0), requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: fused_attention_packed(x, 2), (qkv,))


def test_function_on_cpu_takes_the_plain_versions():
    qkv, dout = _inputs(2, 16, 2, 8, seed=5)
    x = torch.from_numpy(qkv).requires_grad_()
    fwd, bwd = attention.launch_count, attention.backward_launch_count
    out = fused_attention_packed(x, 2)
    out.backward(torch.from_numpy(dout))
    ref_out, lse = attention_packed_reference(x.detach(), 2, 1.0 / np.sqrt(8))
    assert torch.equal(out.detach(), ref_out)
    want = attention_packed_backward_reference(x.detach(), ref_out, lse,
                                               torch.from_numpy(dout), 2, 1.0 / np.sqrt(8))
    assert torch.equal(x.grad, want)
    assert (attention.launch_count, attention.backward_launch_count) == (fwd, bwd)


def test_non_contiguous_dout_is_copied_and_counted():
    """The Function hands the backward a contiguous dout and counts the copy;
    the gradient is that of the contiguous one."""
    qkv, dout = _inputs(1, 16, 2, 8, seed=6)
    grads = []
    for transposed in (False, True):
        x = torch.from_numpy(qkv).requires_grad_()
        out = fused_attention_packed(x, 2)
        d = torch.from_numpy(dout)
        if transposed:  # same values, [B, T, H·C] seen through a transpose
            d = d.transpose(1, 2).contiguous().transpose(1, 2)
            assert not d.is_contiguous()
        before = attention.dout_copies
        out.backward(d)
        assert attention.dout_copies - before == int(transposed)
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def test_function_under_inference_mode_runs_the_forward_only():
    qkv, _ = _inputs(1, 8, 1, 8, seed=7)
    with torch.inference_mode():
        out = fused_attention_packed(torch.from_numpy(qkv), 1)
    assert out.shape == (1, 8, 8) and not out.requires_grad


def test_backward_wrapper_rejects_other_devices():
    meta = torch.zeros(1, 4, 24, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        attention_packed_backward(meta, meta[..., :8], meta[..., :1], meta[..., :8], 1)
