"""The port's CNN (ot_vae_tpu_torch/networks) against the JAX package's CNN:
JAX init → convert.py → port, eval mode, same NHWC inputs, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.networks import CNN as JaxCNN
from ot_vae_tpu_torch.convert import load_jax_variables
from ot_vae_tpu_torch.networks import CNN
from ot_vae_tpu_torch.networks.cnn import _plan_cnn as port_plan
from ot_vae_tpu.networks.cnn import _plan_cnn as jax_plan

ENCODER = dict(in_features=3, out_features=16, in_resolution=16, out_resolution=4,
               capacity=8, down_sample=True, residual="add", attn_head_dim=8,
               max_attn_res=8)
DECODER = dict(in_features=8, out_features=3, in_resolution=4, out_resolution=16,
               capacity=8, up_sample=True, residual="add", attn_head_dim=8,
               max_attn_res=8)
CASES = {
    "encoder-downsample": ENCODER,  # 4×4 stride-2 convs padded (1, 2), skips too
    "decoder-upsample": DECODER,    # nearest ×2 then 3×3 conv, and 1×1 skips
    "decoder-equalized-lr": dict(DECODER, equalized_lr=2.0),
    "encoder-cat-equalized-lr": dict(ENCODER, residual="cat", equalized_lr=0.5,
                                     activation="leaky_relu"),
}

# f32 on both sides; XLA and oneDNN sum the convs in different orders
# (measured ≤ 3.4e-6 at outputs up to 9)
F32_TOL = 1e-4


def _random_variables(shapes, seed, equalized_lr=None):
    """Variables of the given shape tree, drawn with numpy: conv kernels at
    std 1/sqrt(fan_in) (raw equalized-LR kernels at their init std, since
    the fan-in scale is applied at run time), random batch-norm statistics,
    scales and biases, so that no layer is the identity a fresh init makes
    of it. No JAX init is traced or compiled."""
    rng = np.random.default_rng(seed)

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = visit(v, path + (k,))
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                std = 1.0 / equalized_lr if equalized_lr else fan_in**-0.5
                draw = rng.normal(0.0, std, shape)
            elif k in ("var", "scale"):
                draw = rng.uniform(0.5, 1.5, shape)
            else:  # mean, bias
                draw = rng.normal(0.0, 0.2, shape)
            out[k] = draw.astype(np.float32)
        return out

    return visit(shapes, ())


def jax_and_port_cnn(cfg, seed=0, dtype=None):
    """A JAX CNN with random variables, and the port's CNN loaded from them."""
    jax_kw = {} if dtype is None else {"dtype": jnp.bfloat16}
    port_kw = {} if dtype is None else {"dtype": torch.bfloat16}
    jnet = JaxCNN(**cfg, **jax_kw)
    res = cfg["in_resolution"]
    x0 = jnp.zeros((1, res, res, cfg["in_features"]), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(seed), x0)
    variables = _random_variables(shapes, seed, cfg.get("equalized_lr"))
    net = load_jax_variables(CNN(**cfg, **port_kw), variables).eval()
    return jnet, variables, net


def _jax_apply(jnet, variables, x):
    return jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, jnp.asarray(x))


def _inputs(cfg, b=2, seed=1):
    res = cfg["in_resolution"]
    return np.random.default_rng(seed).standard_normal(
        (b, res, res, cfg["in_features"])).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_cnn_matches_jax_f32(name):
    cfg = CASES[name]
    jnet, variables, net = jax_and_port_cnn(cfg)
    x = _inputs(cfg)
    want = np.asarray(_jax_apply(jnet, variables, x))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *net.out_size)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_cnn_matches_jax_bf16():
    """bf16 activations with f32 parameters on both sides. Each layer rounds
    to bf16 (2^-8 relative) in its own places, so allow 4 bf16 ulps of the
    largest output (measured: 1 ulp)."""
    cfg = CASES["decoder-upsample"]
    jnet, variables, net = jax_and_port_cnn(cfg, dtype="bf16")
    x = _inputs(cfg, seed=2)
    want = np.asarray(_jax_apply(jnet, variables, x), np.float32)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=4 * 2.0**-8 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", ["encoder-downsample", "decoder-upsample"])
def test_block_plan_and_heads_match_jax(name):
    cfg = CASES[name]
    args = [cfg["in_features"], cfg["out_features"], cfg["in_resolution"],
            cfg["out_resolution"], None, cfg["capacity"], cfg["max_attn_res"],
            cfg.get("down_sample", False), cfg.get("up_sample", False)]
    assert port_plan(*args) == jax_plan(*args)
    res = cfg["in_resolution"]
    shapes = jax.eval_shape(JaxCNN(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, res, res, cfg["in_features"])))
    net = CNN(**cfg)
    for bi in range(net.n_blocks):
        jax_block = shapes["params"][f"ConvBlock_{bi}"]
        attn = getattr(net, f"ConvBlock_{bi}").AttentionBlock_0
        assert (attn is not None) == ("AttentionBlock_0" in jax_block)
        if attn is not None:
            qkv = jax_block["AttentionBlock_0"]["Conv1x1_0"]["ConvLayer_0"]
            assert qkv["EqualConv_0"]["Conv_0"]["kernel"].shape[-1] == \
                attn.Conv1x1_0.ConvLayer_0.EqualConv_0.Conv_0.weight.shape[0]


def test_qkv_projection_is_the_packed_layout_without_copy():
    """channels_last NCHW: the qkv conv output viewed as [B, T, 3·C] shares
    its storage, so the attention kernel reads it in place."""
    blk = CNN(**ENCODER).ConvBlock_0.AttentionBlock_0
    x = torch.randn(2, 8, 8, 8).permute(0, 3, 1, 2)  # NHWC memory, NCHW view
    qkv = blk.Conv1x1_0(x)
    packed = qkv.permute(0, 2, 3, 1).reshape(2, 64, -1)
    assert packed.is_contiguous() and packed.data_ptr() == qkv.data_ptr()
