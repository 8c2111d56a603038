"""The port's packed attention (ot_vae_tpu_torch/ops/attention.py) against the
JAX package's Pallas kernel in interpret mode, on the CPU.

The CUDA kernels themselves run only on the card: chip_smoke.py holds them
against ``attention_packed_reference`` at the main path's shapes. Here a
recorded (not run) C call shows that both dtypes reach the kernels' C
symbols with the dtype code that picks the bf16 tensor-core or the f32
CUDA-core kernels.
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
# where the bf16 tensor-core kernels' 64-row tiles, padded head dims and
# 16-byte copies can break: T one row past a tile at C = 48 (padded to no
# other width, copied in 16-byte chunks), and T two rows past two tiles at
# C = 13 with H = 3, where H·C = 39 is no multiple of 8, so the k and v
# column blocks start off 16 bytes and every copy is scalar
TILE_SHAPES = [(1, 65, 2, 48), (1, 130, 3, 13)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: ATOL above (measured 4.2e-7 at these shapes). bf16: both round P to
# bf16 before P·V and the output to bf16, so an entry |out| < 2 may land one
# bf16 ulp (2^-7) apart (measured 0); lse is f32 from exactly converted
# inputs on both sides, summed in another order (measured 4.8e-7)
TILE_OUT_TOL = {"float32": ATOL, "bfloat16": 2.0**-7}
TILE_LSE_TOL = {"float32": ATOL, "bfloat16": 1e-4}


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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,t,h,c", TILE_SHAPES)
def test_reference_matches_pallas_packed_at_tile_edges(b, t, h, c, dtype):
    jdt, tdt = DTYPES[dtype]
    qkv = _qkv(b, t, h, c, seed=200 + t)
    scale = 1.0 / np.sqrt(c)
    want_out, want_lse = _packed_fwd_call(jnp.asarray(qkv, jdt), h, scale, True)
    out, lse = attention_packed_reference(torch.from_numpy(qkv).to(tdt), h, scale)
    assert out.dtype == tdt and out.shape == (b, t, h * c)
    assert lse.shape == (b, t, h) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out, np.float32),
                               atol=TILE_OUT_TOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TILE_LSE_TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_calls_reach_the_kernel_symbol(monkeypatch, dtype):
    """On a CUDA tensor the packed forward and backward call their
    libraries' C symbols with the dtype code that picks the kernels (1: bf16,
    the tensor-core kernels; 0: f32, the CUDA-core ones), fresh outputs, an
    f32 lse [B, T, H] and an f32 D scratch [B, T, H]; no call reaches a plain
    version. The C calls are recorded, not run."""
    calls, made = [], {}

    def record(library, symbol, argtypes, args, device):
        assert len(argtypes) == len(args)
        calls.append((library, symbol, args))

    def tracked(make):
        def wrapper(*args, **kwargs):
            x = make(*args, **kwargs)
            made[x.data_ptr()] = (tuple(x.shape), x.dtype)
            return x
        return wrapper

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(attention, "_call", record)
    monkeypatch.setattr(torch, "empty", tracked(torch.empty))
    monkeypatch.setattr(torch, "empty_like", tracked(torch.empty_like))
    for name in ("attention_packed_reference", "attention_packed_backward_reference"):
        monkeypatch.setattr(attention, name, refuse)

    b, t, h, c = 2, 70, 3, 16
    tdt = DTYPES[dtype][1]
    qkv = torch.from_numpy(_qkv(b, t, h, c, seed=9)).to(tdt)
    dout = torch.from_numpy(_qkv(b, t, h, c, seed=10)[..., :h * c]).to(tdt).contiguous()
    out, lse = attention_packed(qkv, h)
    dqkv = attention.attention_packed_backward(qkv, out, lse, dout, h)
    code = {"bfloat16": 1, "float32": 0}[dtype]
    (lib_f, sym_f, fwd), (lib_b, sym_b, bwd) = calls
    assert (lib_f, sym_f) == ("attention_packed", "attention_packed_fwd")
    assert (lib_b, sym_b) == ("attention_packed_bwd", "attention_packed_bwd")
    assert fwd[-1] == code and bwd[-1] == code
    assert fwd[0] == qkv.data_ptr() and fwd[3:7] == [b, t, h, c]
    out_p, lse_p = fwd[1], fwd[2]
    assert made[out_p] == ((b, t, h * c), tdt) and out_p == out.data_ptr()
    assert made[lse_p] == ((b, t, h), torch.float32) and lse_p == lse.data_ptr()
    assert bwd[:4] == [qkv.data_ptr(), out_p, lse_p, dout.data_ptr()]
    assert bwd[6:10] == [b, t, h, c]
    dqkv_p, delta_p = bwd[4], bwd[5]
    assert made[dqkv_p] == (tuple(qkv.shape), tdt) and dqkv_p == dqkv.data_ptr()
    assert made[delta_p] == ((b, t, h), torch.float32)
    assert len({qkv.data_ptr(), out_p, lse_p, dqkv_p, delta_p}) == 5


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
