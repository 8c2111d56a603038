"""The port's BTHD (row 7) and BHTC (row 3) attention against the JAX
package's Pallas kernels in interpret mode, on the CPU.

The CUDA kernels (``ot_vae_tpu_torch/ops/csrc/attention_bthd.cu`` and
``attention_bthd_bwd.cu``) run only on the card: chip_smoke.py holds them
against the plain versions tested here. On the CPU the entry points run the
plain forward and backward through the same autograd Functions; on a CUDA
tensor their backward launches the backward kernel (rows 8 and 4), which a
mocked launch shows here, and every call reaches its C symbol with the dtype
code that picks the bf16 tensor-core or the f32 CUDA-core kernels (a
recorded, not run, C call).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.ops.attention_pallas import (
    _bthd_fwd_call,
    _fwd_call,
    fused_attention,
    fused_attention_bthd,
    fused_attention_bthd_dropout,
)
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.ops.attention import (
    attention_bhtc,
    attention_bhtc_reference,
    attention_bthd,
    attention_bthd_reference,
)

# f32 on both sides, the same products and softmax summed in another order
# over at most 130 keys: measured below 1e-6, held at 1e-5
ATOL = 1e-5
# bf16 inputs: both round P to bf16 before P·V and the output to bf16, so an
# entry |out| < 4 may land one bf16 ulp (2^-6 there) apart (the tile-edge
# cases measured 0)
BF16_ATOL = 2.0**-6

# (B, Tq, Tk, H, d, causal, mult): self-attention at the conditional ViT's
# width, cross lengths, ragged T with an odd d, causal, the multiplier, and
# causal with the multiplier
CASES = [
    (2, 19, 19, 4, 8, False, False),
    (2, 7, 11, 2, 16, False, False),
    (1, 37, 37, 3, 5, False, False),
    (2, 24, 24, 2, 8, True, False),
    (2, 13, 9, 2, 8, False, True),
    (1, 21, 21, 2, 12, True, True),
]
IDS = ["self", "cross", "ragged_odd_d", "causal", "mult", "causal_mult"]
# where the bf16 kernel's 64-row tiles and padded head dims can break: T one
# row past a tile at d = 48 (padded to no width), two rows past two tiles at
# d = 13 (padded to 16, scalar copies) with causal and the multiplier, and
# cross lengths across tiles with the multiplier
TILE_CASES = [
    (1, 65, 65, 2, 48, False, False),
    (1, 130, 130, 1, 13, True, True),
    (2, 65, 130, 2, 16, False, True),
]
TILE_IDS = ["t65_d48", "t130_d13_causal_mult", "cross_65_130_mult"]
CASES += TILE_CASES
IDS += TILE_IDS


def _inputs(b, tq, tk, h, d, mult, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h * d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h * d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h * d)).astype(np.float32)
    m = None
    if mult:  # dropout's keep mask over the keep probability 0.8
        m = ((rng.random((tq, tk)) < 0.8) / 0.8).astype(np.float32)
    return q, k, v, m


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mult", CASES, ids=IDS)
def test_bthd_reference_matches_pallas(b, tq, tk, h, d, causal, mult):
    """out through the JAX entry points and lse through ``_bthd_fwd_call``."""
    q, k, v, m = _inputs(b, tq, tk, h, d, mult, seed=tq * tk + d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if mult:
        want = fused_attention_bthd_dropout(jq, jk, jv, jnp.asarray(m), h, scale,
                                            interpret=True, causal=causal)
    else:
        want = fused_attention_bthd(jq, jk, jv, h, scale, interpret=True, causal=causal)
    _, want_lse = _bthd_fwd_call(jq, jk, jv, None if m is None else jnp.asarray(m), h,
                                 scale, causal, True)
    out, lse = attention_bthd_reference(_t(q), _t(k), _t(v), h, scale, causal, _t(m))
    assert out.shape == (b, tq, h * d) and lse.shape == (b, h, tq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=ATOL, rtol=0)


def test_bthd_bf16_reference_matches_pallas():
    b, tq, tk, h, d = 2, 19, 19, 4, 8
    q, k, v, _ = _inputs(b, tq, tk, h, d, False, seed=3)
    scale = 1.0 / np.sqrt(d)
    want, want_lse = _bthd_fwd_call(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                    None, h, scale, False, True)
    out, lse = attention_bthd_reference(*(_t(x).bfloat16() for x in (q, k, v)), h, scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mult", TILE_CASES, ids=TILE_IDS)
def test_bthd_bf16_tile_edges_match_pallas(b, tq, tk, h, d, causal, mult):
    """bf16 out and lse at the tile and padding edges against
    ``_bthd_fwd_call`` in bf16, interpret mode."""
    q, k, v, m = _inputs(b, tq, tk, h, d, mult, seed=tq + tk + d)
    scale = 1.0 / np.sqrt(d)
    jm = None if m is None else jnp.asarray(m, jnp.bfloat16)
    want, want_lse = _bthd_fwd_call(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jm,
                                    h, scale, causal, True)
    tm = None if m is None else _t(m).bfloat16()
    out, lse = attention_bthd_reference(*(_t(x).bfloat16() for x in (q, k, v)), h, scale,
                                        causal, tm)
    assert out.dtype == torch.bfloat16 and out.shape == (b, tq, h * d)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,h,t,d", [(2, 4, 19, 32), (1, 3, 37, 5)], ids=["vit", "ragged"])
def test_bhtc_reference_matches_pallas(b, h, t, d):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    want = fused_attention(*(jnp.asarray(x) for x in (q, k, v)), scale, interpret=True)
    _, want_lse = _fwd_call(*(jnp.asarray(x.reshape(b * h, t, d)) for x in (q, k, v)),
                            scale, True)
    out, lse = attention_bhtc_reference(_t(q), _t(k), _t(v), scale)
    assert lse.shape == (b * h, t)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(attention.fused_attention(_t(q), _t(k), _t(v)).numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,mult", [(False, False), (True, True)], ids=["plain", "causal_mult"])
def test_cpu_entry_backward_matches_pallas_backward(causal, mult):
    """On the CPU the entries' gradient runs the plain row-8 backward; it
    agrees with the gradient of the JAX entry, whose backward is the row-8
    Pallas kernel in interpret mode (f32, products summed in another order:
    1e-5 of the largest gradient)."""
    b, t, h, d = 2, 16, 2, 8
    q, k, v, m = _inputs(b, t, t, h, d, mult, seed=11)
    g = np.random.default_rng(12).standard_normal((b, t, h * d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)

    def jax_loss(q, k, v):
        if mult:
            out = fused_attention_bthd_dropout(q, k, v, jnp.asarray(m), h, scale,
                                               interpret=True, causal=causal)
        else:
            out = fused_attention_bthd(q, k, v, h, scale, interpret=True, causal=causal)
        return jnp.sum(out * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    if mult:
        out = attention.fused_attention_bthd_dropout(tq, tk, tv, _t(m), h, scale, causal)
    else:
        out = attention.fused_attention_bthd(tq, tk, tv, h, scale, causal)
    (out * _t(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v, m = _inputs(1, 9, 5, 2, 4, True, seed=5)
    before = (attention.bthd_launch_count, attention.bhtc_launch_count)
    out, lse = attention_bthd(_t(q), _t(k), _t(v), 2, mult=_t(m))
    ref_out, ref_lse = attention_bthd_reference(_t(q), _t(k), _t(v), 2, 0.5, mult=_t(m))
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    x = _t(q).view(1, 9, 2, 4).transpose(1, 2).contiguous()
    assert torch.equal(attention_bhtc(x, x, x)[0], attention_bhtc_reference(x, x, x, 0.5)[0])
    assert (attention.bthd_launch_count, attention.bhtc_launch_count) == before
    with pytest.raises(ValueError, match="causal"):
        attention_bthd(_t(q), _t(k), _t(v), 2, causal=True)


@pytest.fixture
def mocked_card(monkeypatch):
    """Every tensor counts as a CUDA tensor; the forward "launches" compute
    the plain forward and the backward "launches" the plain backward, each
    recorded, while the plain backward versions themselves raise if an entry
    calls them directly."""
    launched = []
    plain = {"bthd": attention.attention_bthd_backward_reference,
             "bhtc": attention.attention_bhtc_backward_reference}

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain backward")

    def bthd_bwd(q, k, v, out, lse, dout, h, s, c, m):
        launched.append("bthd_bwd")
        return plain["bthd"](q, k, v, out, lse, dout, h, s, c, m)

    def bhtc_bwd(q, k, v, out, lse, dout, s):
        launched.append("bhtc_bwd")
        return plain["bhtc"](q, k, v, out, lse, dout, s)

    monkeypatch.setattr(attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(attention, "_launch_bthd",
                        lambda q, k, v, h, s, c, m: attention_bthd_reference(q, k, v, h, s, c, m))
    monkeypatch.setattr(attention, "_launch_bhtc",
                        lambda q, k, v, s: attention_bhtc_reference(q, k, v, s))
    monkeypatch.setattr(attention, "_launch_bthd_backward", bthd_bwd)
    monkeypatch.setattr(attention, "_launch_bhtc_backward", bhtc_bwd)
    monkeypatch.setattr(attention, "attention_bthd_backward_reference", refuse)
    monkeypatch.setattr(attention, "attention_bhtc_backward_reference", refuse)
    return launched


@pytest.mark.parametrize("entry", ["bthd", "bthd_dropout", "bhtc"])
def test_cuda_backward_raises_not_a_fallback(mocked_card, monkeypatch, entry):
    """On a CUDA tensor each entry's backward launches its backward kernel
    (row 8, or row 4 for ``fused_attention``) once and never runs a plain
    version; when the launch fails, the error reaches the caller."""
    q, k, v, m = _inputs(1, 8, 8, 2, 4, True, seed=6)
    kind = "bhtc" if entry == "bhtc" else "bthd"

    def run():
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        if entry == "bthd":
            out = attention.fused_attention_bthd(tq, tk, tv, 2)
        elif entry == "bthd_dropout":
            out = attention.fused_attention_bthd_dropout(tq, tk, tv, _t(m), 2)
        else:
            out = attention.fused_attention(*(x.view(1, 8, 2, 4).transpose(1, 2) for x in
                                              (tq, tk, tv)))
        out.sum().backward()
        return tq.grad

    assert run() is not None
    assert mocked_card == [f"{kind}_bwd"]

    def fail(*args):
        raise RuntimeError("launch failed: cudaError 1")

    monkeypatch.setattr(attention, f"_launch_{kind}_backward", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        run()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["bthd", "bhtc"])
def test_cuda_calls_reach_the_kernel_symbol(monkeypatch, layout, dtype):
    """On a CUDA tensor the forward and backward entries of both layouts call
    their library's C symbol with the dtype code that picks the kernel (1:
    bf16, the tensor-core kernels; 0: f32, the CUDA-core ones), fresh
    outputs of the expected shapes, an f32 lse and, for the backward, an f32
    D scratch of [B, H, Tq]; no call reaches a plain version. The C calls
    are recorded, not run."""
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
    for name in ("_attention_heads", "_attention_heads_backward", "attention_bthd_reference",
                 "attention_bthd_backward_reference", "attention_bhtc_reference",
                 "attention_bhtc_backward_reference"):
        monkeypatch.setattr(attention, name, refuse)

    b, t, h, d = 2, 70, 2, 16
    q, k, v, m = _inputs(b, t, t, h, d, layout == "bthd", seed=8)
    x = [_t(a).to(getattr(torch, dtype)) for a in (q, k, v, q)]
    if layout == "bthd":
        mult = _t(m).to(x[0].dtype)
        out, lse = attention_bthd(*x[:3], h, None, False, mult)
        attention.attention_bthd_backward(*x[:3], out, lse, x[3], h, None, False, mult)
    else:
        x = [a.view(b, t, h, d).transpose(1, 2).contiguous() for a in x]
        out, lse = attention_bhtc(*x[:3])
        attention.attention_bhtc_backward(*x[:3], out, lse, x[3])
    code = {"bfloat16": 1, "float32": 0}[dtype]
    (lib_f, sym_f, fwd), (lib_b, sym_b, bwd) = calls
    assert (lib_f, sym_f) == ("attention_bthd", f"attention_{layout}_fwd")
    assert (lib_b, sym_b) == ("attention_bthd_bwd", f"attention_{layout}_bwd")
    assert fwd[-1] == code and bwd[-1] == code
    stat = (b, h, t) if layout == "bthd" else (b * h, t)
    like_q = (tuple(x[0].shape), x[0].dtype)
    if layout == "bthd":
        assert fwd[3] == mult.data_ptr() and bwd[3] == mult.data_ptr()
        out_p, lse_p = fwd[4], fwd[5]
        dq_p, dk_p, dv_p, delta_p = bwd[7:11]
    else:
        out_p, lse_p = fwd[3], fwd[4]
        dq_p, dk_p, dv_p, delta_p = bwd[6:10]
    assert made[out_p] == like_q and out_p == out.data_ptr()
    assert made[lse_p] == (stat, torch.float32) and lse_p == lse.data_ptr()
    assert made[dq_p] == made[dk_p] == made[dv_p] == like_q
    assert made[delta_p] == (stat, torch.float32)
    assert len({out_p, lse_p, dq_p, dk_p, dv_p, delta_p}) == 6
