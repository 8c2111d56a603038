"""The port's fused attention block (rows 5 and 6) against the JAX package's
``fused_attention_block`` in interpret mode, on the CPU.

The CUDA kernels (``ot_vae_tpu_torch/ops/csrc/attention_block.cu`` and
``attention_block_bwd.cu``) run only on the card: chip_smoke.py holds them
against the plain versions tested here. On the CPU the entry runs the plain
forward and backward through the same autograd Function; on a CUDA tensor it
launches the kernels, which a mocked launch shows here. The JAX side runs
its block kernels with ``interpret=True``, and its ``AttentionBlock`` under
``OT_VAE_FUSED_ATTN_BLOCK=interpret``, set with monkeypatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import CNN as JaxCNN
from ot_vae_tpu.networks.cnn import AttentionBlock as JaxAttentionBlock
from ot_vae_tpu.ops.attention_pallas import _block_fwd_call, fused_attention_block
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu_torch.convert import load_jax_variables, state_dict_to_jax_variables
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import CNN
from ot_vae_tpu_torch.networks.cnn import AttentionBlock
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.ops.attention import (
    attention_block,
    attention_block_backward_reference,
    attention_block_reference,
)
from ot_vae_tpu_torch.priors import GaussianPrior

# f32 on both sides, the same products in another summation order over at
# most 32 keys and 24 channels: measured below 1e-6, held at the JAX test's
# 1e-5 (tests/test_attention_pallas.py:222). The tile-edge shapes (up to 130
# keys and 40 channels) read up to 0.57 of it (out at t65_h3_ch13). The
# bound is absolute: at C = H·ch = 48 and T = 130 the outputs reach 7 and
# another summation order moved out by 1.8e-5, so the ch = 48 shape takes
# C = 16 here. The kernels' C = 48 edge is held on the card in bf16,
# against their plain versions: chip_smoke.py phase 22 runs this shape with
# C = H·ch = C_out = 48 among its BLOCK_TILE_SHAPES
ATOL = 1e-5
# gradients, f32: the JAX test's tolerances (atol 5e-5, rtol 1e-4)
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4
# bf16: both sides round qkv, P, the attention output, dAttn, dS, dqkv and
# the outputs to bf16 at the same points; a sum taken in another order can
# round an entry the other way, which moves an output by up to one bf16 ulp
# of its scale (2^-8 of its largest entry). The JAX test's f32 tolerances do
# not hold there: the gradients' largest error measured 0.37 of that ulp (dx
# at h2_ch8), the outputs' less; at the tile-edge shapes 0.61 (dx at
# t130_ch48), the outputs 0.31
BF16_ULP = 2.0**-8

# (b, t, c, h, ch, c_out): the JAX test's shapes (C = 24 with H·ch = 16)
# and one with C_out != C; then the edges of the bf16 tensor-core kernels
# (64-row attention tiles, 128 x 128 GEMM tiles 32 deep, head dims padded to
# a multiple of 16, 16-byte copies only where rows start on 16 bytes): T =
# 65 with ch = 13 and H = 3 (H·ch = 39) and C = 40, C_out = 24, neither a
# multiple of 16; T = 130 with ch = 48
SHAPES = [(2, 32, 24, 1, 16, 24), (2, 32, 24, 2, 8, 24), (2, 20, 12, 3, 4, 40),
          (1, 65, 40, 3, 13, 24), (1, 130, 16, 1, 48, 16)]
IDS = ["h1_ch16", "h2_ch8", "c_out40", "t65_h3_ch13", "t130_ch48"]


def _inputs(b, t, c, h, ch, c_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    wq = (rng.standard_normal((c, 3 * h * ch)) * 0.3).astype(np.float32)
    wo = (rng.standard_normal((h * ch, c_out)) * 0.3).astype(np.float32)
    dout = rng.standard_normal((b, t, c_out)).astype(np.float32)
    return x, wq, wo, dout


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas(shape, dtype):
    """Row 5's plain version: out against ``fused_attention_block`` and
    ``_block_fwd_call`` in interpret mode; lse against the Pallas kernel's
    and a numpy logsumexp of the scaled logits."""
    b, t, c, h, ch, c_out = shape
    x, wq, wo, _ = _inputs(*shape, seed=sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x).astype(jdt)
    scale = 1.0 / np.sqrt(ch)
    want = fused_attention_block(jx, jnp.asarray(wq), jnp.asarray(wo), h, scale,
                                 interpret=True)
    want_out, want_lse = _block_fwd_call(jx, jnp.asarray(wq), jnp.asarray(wo), h, scale, True)
    out, lse = attention_block_reference(_t(x, tdt), _t(wq), _t(wo), h, scale)
    assert out.dtype == tdt and out.shape == (b, t, c_out) and lse.dtype == torch.float32
    atol = ATOL if dtype == "float32" else BF16_ULP * np.abs(_np(want)).max()
    for ref in (want, want_out):
        np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _np(want_lse), atol=ATOL, rtol=0)
    # the lse of the logits of the rounded qkv, in f64
    xr = _np(jx).astype(np.float64)
    wqr = _np(jnp.asarray(wq).astype(jdt)).astype(np.float64)
    qkv = _np(jnp.asarray(xr @ wqr, jnp.float32).astype(jdt)).astype(np.float64)
    q = qkv[..., :h * ch].reshape(b, t, h, ch)
    k = qkv[..., h * ch:2 * h * ch].reshape(b, t, h, ch)
    s = np.einsum("bqhd,bkhd->bqhk", q, k) * scale
    m = s.max(-1)
    ref_lse = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_vjp(shape, dtype):
    """Row 6's plain version against ``jax.vjp`` of the interpret-mode
    entry (``_block_bwd_kernel``), from the forward's own lse."""
    b, t, c, h, ch, c_out = shape
    x, wq, wo, dout = _inputs(*shape, seed=10 + sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    scale = 1.0 / np.sqrt(ch)
    jx = jnp.asarray(x).astype(jdt)
    _, vjp = jax.vjp(lambda a, w1, w2: fused_attention_block(a, w1, w2, h, scale,
                                                             interpret=True),
                     jx, jnp.asarray(wq), jnp.asarray(wo))
    want = vjp(jnp.asarray(dout).astype(jdt))
    _, lse = attention_block_reference(_t(x, tdt), _t(wq), _t(wo), h, scale)
    got = attention_block_backward_reference(_t(x, tdt), _t(wq), _t(wo), lse, _t(dout, tdt),
                                             h, scale)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(("dx", "dw_qkv", "dw_out"), got, want):
        w = _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=0, err_msg=name,
                                       atol=BF16_ULP * np.abs(w).max())


def test_plain_bf16_qkv_is_the_exact_sum_rounded():
    """In bf16 the plain versions take qkv from the exact sum of the
    products, rounded once to f32 and then to bf16, as the row-5 and row-6
    kernels do on the FP64 tensor cores: the same bits in any order of the
    sum. f32 and f64 inputs keep their own accumulation."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((3, 50, 96)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((96, 72)) / np.sqrt(96)).astype(np.float32))
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16).float()
    got = attention._project_qkv(xb, wb, torch.float32)
    x64, w64 = xb.double().numpy(), wb.double().numpy()
    for exact in (x64 @ w64, x64[..., ::-1] @ w64[::-1]):
        assert torch.equal(got, torch.from_numpy(exact.astype(np.float32)).to(torch.bfloat16))
    assert torch.equal(attention._project_qkv(x, w, torch.float32), torch.matmul(x, w))
    assert attention._project_qkv(x.double(), w.double(), torch.float64).dtype == torch.float64


def test_function_gradcheck_f64():
    """The autograd Function's backward (the plain row 6 on the CPU) is the
    exact VJP of its forward in f64."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 5))).requires_grad_()
    wq = torch.from_numpy(rng.standard_normal((5, 12)) * 0.5).requires_grad_()
    wo = torch.from_numpy(rng.standard_normal((4, 6)) * 0.5).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, w1, w2: attention.fused_attention_block(a, w1, w2, 2), (x, wq, wo))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, wq, wo, dout = _inputs(*SHAPES[1], seed=4)
    before = (attention.block_launch_count, attention.block_bwd_launch_count,
              attention.launch_count, attention.backward_launch_count)
    out, lse = attention_block(_t(x), _t(wq), _t(wo), 2)
    ref_out, ref_lse = attention_block_reference(_t(x), _t(wq), _t(wo), 2, 1.0 / np.sqrt(8))
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    tx, twq, two = (_t(a).requires_grad_() for a in (x, wq, wo))
    (attention.fused_attention_block(tx, twq, two, 2) * _t(dout)).sum().backward()
    want = attention_block_backward_reference(_t(x), _t(wq), _t(wo), ref_lse, _t(dout), 2,
                                              1.0 / np.sqrt(8))
    for got, ref in zip((tx.grad, twq.grad, two.grad), want):
        assert torch.equal(got, ref)
    with torch.inference_mode():
        assert torch.equal(attention.fused_attention_block(_t(x), _t(wq), _t(wo), 2), ref_out)
    assert (attention.block_launch_count, attention.block_bwd_launch_count,
            attention.launch_count, attention.backward_launch_count) == before
    with pytest.raises(ValueError, match="w_out"):
        attention_block(_t(x), _t(wq), _t(wo)[:-1], 2)
    with pytest.raises(ValueError, match="divisible"):
        attention_block(_t(x), _t(wq), _t(wo), 5)


@pytest.fixture
def mocked_card(monkeypatch):
    """Every tensor counts as a CUDA tensor; the "launches" compute the plain
    forward and backward, each recorded, while the plain versions themselves
    raise if the entry calls them directly."""
    launched = []
    plain = (attention.attention_block_reference, attention.attention_block_backward_reference)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def fwd(*args):
        launched.append("block_fwd")
        return plain[0](*args)

    def bwd(*args):
        launched.append("block_bwd")
        return plain[1](*args)

    monkeypatch.setattr(attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(attention, "_launch_block", fwd)
    monkeypatch.setattr(attention, "_launch_block_backward", bwd)
    monkeypatch.setattr(attention, "attention_block_reference", refuse)
    monkeypatch.setattr(attention, "attention_block_backward_reference", refuse)
    return launched


@pytest.mark.parametrize("failing", ["_launch_block", "_launch_block_backward"])
def test_cuda_launches_each_kernel_once_and_raises_not_a_fallback(mocked_card, monkeypatch,
                                                                  failing):
    """On a CUDA tensor the Function launches row 5 once and row 6 once and
    never runs a plain version; a failing launch reaches the caller."""
    x, wq, wo, dout = _inputs(*SHAPES[2], seed=5)

    def run():
        tx, twq, two = (_t(a).requires_grad_() for a in (x, wq, wo))
        (attention.fused_attention_block(tx, twq, two, 3) * _t(dout)).sum().backward()
        return tx.grad, twq.grad, two.grad

    grads = run()
    assert all(g is not None for g in grads) and grads[1].dtype == torch.float32
    assert mocked_card == ["block_fwd", "block_bwd"]

    def fail(*args):
        raise RuntimeError("launch failed: cudaError 1")

    monkeypatch.setattr(attention, failing, fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        run()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_calls_reach_the_kernel_symbol(monkeypatch, dtype):
    """On a CUDA tensor rows 5 and 6 call their libraries' C symbols with
    the dtype code that picks the kernels (1: bf16, the tensor-core kernels;
    0: f32, the CUDA-core ones), the weights' own strides, fresh outputs and
    workspaces of the stated shapes (qkv and dqkv [B·T, 3·H·ch], attn and
    dAttn [B·T, H·ch], an f32 lse [B, T, H] and D [B·T, H], the f32 split-K
    workspace, and for bf16 alone the bf16 copy of both weights with rows
    padded to 8), weight gradients in the weights' layouts, and K splits
    from the shape and the card's SM count; no call reaches a plain
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

    class Card:
        multi_processor_count = 132

    monkeypatch.setattr(attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(attention, "_call", record)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Card())
    monkeypatch.setattr(torch, "empty", tracked(torch.empty))
    monkeypatch.setattr(torch, "empty_like", tracked(torch.empty_like))
    for name in ("attention_block_reference", "attention_block_backward_reference"):
        monkeypatch.setattr(attention, name, refuse)

    # B·T = 520 rows: two K splits of at least 256 rows each
    b, t, c, h, ch, c_out = 4, 130, 40, 3, 16, 20
    width = h * ch
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x_np, wq_np, wo_np, dout_np = _inputs(b, t, c, h, ch, c_out, seed=6)
    x, dout = _t(x_np, tdt), _t(dout_np, tdt)
    wq = _t(wq_np.T).contiguous().t()  # the model's layout: an [out, in] weight viewed
    wo = _t(wo_np)
    code = {"bfloat16": 1, "float32": 0}[dtype]
    # the forward's workspaces are freed on return, and the backward's may
    # take their addresses: each call is checked before the next is made
    out, lse = attention_block(x, wq, wo, h)
    (lib_f, sym_f, fwd), = calls
    assert (lib_f, sym_f) == ("attention_block", "attention_block_fwd")
    assert fwd[-1] == code and fwd[-2] == pytest.approx(1.0 / np.sqrt(ch))
    assert fwd[:7] == [x.data_ptr(), wq.data_ptr(), *wq.stride(), wo.data_ptr(), *wo.stride()]
    assert fwd[12:18] == [b, t, c, h, ch, c_out]
    out_p, lse_p, qkv_p, attn_p, wws_p = fwd[7:12]
    assert made[out_p] == ((b, t, c_out), tdt) and out_p == out.data_ptr()
    assert made[lse_p] == ((b, t, h), torch.float32) and lse_p == lse.data_ptr()
    assert made[qkv_p] == ((b, t, 3 * width), tdt) and made[attn_p] == ((b, t, width), tdt)
    # bf16 weights: [C, pad8(3·H·ch)] then [H·ch, pad8(C_out)]
    w_ws = ((c * 144 + width * 24,), torch.bfloat16)
    assert (made[wws_p] == w_ws) if dtype == "bfloat16" else wws_p is None
    fresh = [out_p, lse_p, qkv_p, attn_p] + ([wws_p] if dtype == "bfloat16" else [])
    assert len(set(fresh)) == len(fresh)
    assert not set(fresh) & {x.data_ptr(), wq.data_ptr(), wo.data_ptr()}

    made.clear()
    grads = attention.attention_block_backward(x, wq, wo, lse, dout, h)
    (lib_b, sym_b, bwd), = calls[1:]
    assert (lib_b, sym_b) == ("attention_block_bwd", "attention_block_bwd")
    assert bwd[-1] == code and bwd[-2] == fwd[-2]
    assert bwd[:9] == [x.data_ptr(), wq.data_ptr(), *wq.stride(), wo.data_ptr(), *wo.stride(),
                       lse_p, dout.data_ptr()]
    dx_p, dwq_p, dwq_s, dwo_p, dwo_s = bwd[9], bwd[10], bwd[11:13], bwd[13], bwd[14:16]
    assert made[dx_p] == ((b, t, c), tdt) and dx_p == grads[0].data_ptr()
    assert dwq_p == grads[1].data_ptr() and tuple(dwq_s) == wq.stride() == grads[1].stride()
    assert dwo_p == grads[2].data_ptr() and tuple(dwo_s) == wo.stride() == grads[2].stride()
    assert grads[1].dtype == grads[2].dtype == torch.float32
    qkv_b, attn_b, dattn_b, dqkv_b, delta_b, split_b, wws_b = bwd[16:23]
    assert made[qkv_b] == made[dqkv_b] == ((b * t, 3 * width), tdt)
    assert made[attn_b] == made[dattn_b] == ((b * t, width), tdt)
    assert made[delta_b] == ((b * t, h), torch.float32)
    assert bwd[23:25] == [2, 2]  # K splits of dW_qkv and dW_out
    assert made[split_b] == ((2 * c * 3 * width,), torch.float32)
    assert (made[wws_b] == w_ws) if dtype == "bfloat16" else wws_b is None
    assert bwd[25:31] == [b, t, c, h, ch, c_out]
    fresh = [dx_p, dwq_p, dwo_p, qkv_b, attn_b, dattn_b, dqkv_b, delta_b, split_b] + (
        [wws_b] if dtype == "bfloat16" else [])
    assert len(set(fresh)) == len(fresh)
    assert not set(fresh) & {x.data_ptr(), dout.data_ptr(), wq.data_ptr(), wo.data_ptr(),
                             lse.data_ptr()}


# ------------------------------------------------------------------ modules


def _jax_block_pair(equalized_lr, seed):
    blk = JaxAttentionBlock(channels=16, heads=2, normalization="batchnorm",
                            equalized_lr=equalized_lr)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 4, 4, 16)) * 1.5 + 0.5).astype(np.float32)
    co = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    variables = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return blk, variables, x, co


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("equalized_lr", [None, 1.0], ids=["plain", "equalized_lr"])
def test_attention_block_module_matches_jax_fused(monkeypatch, equalized_lr):
    """``AttentionBlock(fused_block=True)`` against the JAX block under
    ``OT_VAE_FUSED_ATTN_BLOCK=interpret`` in train mode: output, every
    parameter gradient and the batch norm's running statistics; the same
    state dict loads strict into a fused and an unfused port block, which
    agree with each other."""
    monkeypatch.setenv("OT_VAE_FUSED_ATTN_BLOCK", "interpret")
    blk, variables, x, co = _jax_block_pair(equalized_lr, 7 + int(bool(equalized_lr)))

    def loss(params):
        out, mutated = blk.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return jnp.sum(out * co), (out, mutated)

    (_, (want, mutated)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])

    fused = AttentionBlock(16, 2, "batchnorm", equalized_lr, fused_block=True)
    unfused = AttentionBlock(16, 2, "batchnorm", equalized_lr)
    load_jax_variables(fused, variables)
    unfused.load_state_dict(fused.state_dict(), strict=True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC → channels_last NCHW
    outs = {}
    for name, module in (("fused", fused), ("unfused", unfused)):
        out = module.train()(tx).permute(0, 2, 3, 1)
        (out * torch.from_numpy(co)).sum().backward()
        outs[name] = out.detach().numpy()
    # f32, the same function summed in another order (measured below 1e-6)
    np.testing.assert_allclose(outs["fused"], np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(outs["unfused"], outs["fused"], atol=ATOL, rtol=0)
    got = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in fused.named_parameters()})["params"])
    other = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in unfused.named_parameters()})["params"])
    jgrads = _flat(grads)
    assert set(got) == set(jgrads)
    for path, w in jgrads.items():
        np.testing.assert_allclose(got[path], w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=path)
        np.testing.assert_allclose(other[path], got[path], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=path)
    stats = _flat(state_dict_to_jax_variables(fused.state_dict())["batch_stats"])
    for path, w in _flat(mutated["batch_stats"]).items():
        # f32 statistics in another summation order
        np.testing.assert_allclose(stats[path], w, atol=1e-6, rtol=1e-6, err_msg=path)


# -------------------------------------------------- the slice as a whole

# the FFHQ128 CNN VAE's architecture (configs/vae/ffhq128.yaml: residual add,
# attention at head dim 64, 4² latent) at resolution 32 and capacity 4, so
# that its attention blocks run at T = 256, 64 and 16 with widths 4, 8 and
# 32 at head dim 4
ENCODER = dict(in_features=3, out_features=32, in_resolution=32, out_resolution=4,
               capacity=4, down_sample=True, residual="add", attn_head_dim=4)
DECODER = dict(in_features=16, out_features=3, in_resolution=4, out_resolution=32,
               capacity=4, up_sample=True, residual="add", attn_head_dim=4)
LATENT = (4, 4, 16)
# f32 through about thirty layers: reconstruct over max(1, max|out|), and
# each gradient leaf over max(1e-3, max|leaf|) as tests/test_torch_vit_training.py.
# Leaves with no gradient in exact arithmetic (a per-channel constant that
# meets a batch norm through linear layers alone, as the biases of the 1×1
# skips' norms: JAX's whole leaf below 1e-5 of the model's largest gradient)
# hold rounding noise on both sides and must stay under 1e-5 of the largest
# (tests/test_torch_training.py draws the same line)
RECON_TOL = 1e-4
VAE_GRAD_TOL = 1e-4
NOISE_TOL = 1e-5


@pytest.fixture(scope="module")
def vae_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OT_VAE_FUSED_ATTN_BLOCK", "interpret")
        jm = JaxVAE(encoder=JaxCNN(**ENCODER), decoder=JaxCNN(**DECODER),
                    prior=JaxGaussianPrior(loss_coeff=0.1))
        images = np.random.default_rng(20).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        batch = (jnp.asarray(images), jnp.zeros((2,), jnp.int32))
        variables = jax.jit(jm.init_variables)(jax.random.PRNGKey(21), batch)
        key = jax.random.PRNGKey(22)
        eps = np.array(jax.random.normal(key, (2, *LATENT), jnp.float32))
        recon = np.asarray(jax.jit(lambda v, x, k: jm.net.apply(v, x, 0, k, False))(
            variables, batch[0], key))
        pbatch = jm.batch_preprocess(batch, None, train=True)
        rest = {k: v for k, v in variables.items() if k != "params"}

        def jax_loss(params):
            return jm.loss_fn({"params": params, **rest}, pbatch, 3,
                              {"prior": key, "dropout": key})

        (loss, (logs, _, _)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            variables["params"])
    pm = VAE(CNN(**ENCODER, fused_block=True), CNN(**DECODER, fused_block=True),
             GaussianPrior(loss_coeff=0.1))
    load_jax_variables(pm.net, variables)
    return pm, images, eps, recon, float(loss), _flat(grads)


def test_fused_vae_reconstruct_matches_jax(vae_pair):
    pm, images, eps, recon, _, _ = vae_pair
    n_blocks = sum(isinstance(m, AttentionBlock) and m.fused_block for m in pm.net.modules())
    assert n_blocks == 6
    with torch.inference_mode():
        got = pm.net.eval()(torch.from_numpy(images), noise=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), recon, rtol=0,
                               atol=RECON_TOL * max(1.0, np.abs(recon).max()))


def test_fused_vae_train_step_matches_jax(vae_pair):
    pm, images, eps, _, loss, jgrads = vae_pair
    x = torch.from_numpy(images)
    got, _, _ = pm.train().loss_fn({"samples": x, "target": x, "kwargs": {}}, 3,
                                   noise=torch.from_numpy(eps))
    got.backward()
    assert abs(got.item() - loss) <= 1e-5 * max(1.0, abs(loss))
    pgrads = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in pm.net.named_parameters()})["params"])
    assert set(pgrads) == set(jgrads)
    scale = max(np.abs(g).max() for g in jgrads.values())
    n_noise = 0
    for path, want in jgrads.items():
        if np.abs(want).max() <= NOISE_TOL * scale:
            n_noise += 1
            assert np.abs(pgrads[path]).max() <= NOISE_TOL * scale, path
            continue
        np.testing.assert_allclose(pgrads[path], want, rtol=0, err_msg=path,
                                   atol=VAE_GRAD_TOL * max(1e-3, np.abs(want).max()))
    assert n_noise < len(jgrads) // 4
