"""The port's ViT path against the JAX package's, on the CPU: the flax layers
and ``mha_attention_fn``, ``ViT`` for the encoder and decoder plans of
configs/vae/vit.yaml and configs/vae/vit_ffhq128.yaml (at a small size), the
Gaussian priors with ``reparam_dim``, the conditional CIFAR10 ViT VAE of
configs/vae/vit.yaml at its full width, and ``InferenceEngine`` with labels.

JAX modules are initialised from a seed and carried across with convert.py;
ε and the labels are handed across as arrays. On the CPU the JAX ViT takes
flax's stock attention (its kernels are TPU-only) and the port the plain
version of the BTHD kernel; both compute the same f32 function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.linen.attention import dot_product_attention as flax_attention

from ot_vae_tpu.data.transforms import Normalize as JaxNormalize
from ot_vae_tpu.data.transforms import UnNormalize as JaxUnNormalize
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import ViT as JaxViT
from ot_vae_tpu.priors import ConditionalGaussianPrior as JaxConditionalGaussianPrior
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu.serving import InferenceEngine as JaxEngine
from ot_vae_tpu_torch.convert import (
    jax_variables_to_state_dict,
    load_jax_variables,
    state_dict_to_jax_variables,
)
from ot_vae_tpu_torch.data import CIFAR10, CIFAR10_MEAN, CIFAR10_STD, cifar10_transforms
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import nets_utils
from ot_vae_tpu_torch.networks.vit import AutoRegressive, ViT
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.priors import ConditionalGaussianPrior, GaussianPrior
from ot_vae_tpu_torch.serving import InferenceEngine

# f32 on both sides, the same function; XLA and torch sum the products and
# the layer-norm statistics in other orders. Errors against
# max(1, max|output|): measured below 7e-7 through the full-width VAE
TOL = 1e-5

# configs/vae/vit.yaml, full width (the model is small)
CIFAR_ENCODER = dict(image_size=32, patch_size=8, dim=128, depth=3, heads=4, channels=3,
                     num_classes=10, n_embed_tokens=2, output_tokens="embed",
                     patch_to_embed=True, embed_to_patch=False)
CIFAR_DECODER = dict(image_size=32, patch_size=8, dim=128, depth=3, heads=4, channels=3,
                     num_classes=10, n_embed_tokens=None, n_input_tokens=1,
                     output_tokens="embed", patch_to_embed=False, embed_to_patch=True)
CIFAR_PRIOR = dict(dim=(1, 128), num_classes=10, loss_coeff=0.1, reparam_dim=-2,
                   annealing_steps=1000)
CIFAR_LATENT = (1, 128)

# the ViT plans at a small size: (config, input shape, labels?)
PLANS = {
    "cifar_encoder": ({**CIFAR_ENCODER, "dim": 32, "depth": 1}, (2, 32, 32, 3), True),
    "cifar_decoder": ({**CIFAR_DECODER, "dim": 32, "depth": 1}, (2, 1, 32), True),
    # configs/vae/vit_ffhq128.yaml's plans at image 16, patch 4 (16 tokens)
    "ffhq_encoder": (dict(image_size=16, patch_size=4, dim=32, depth=1, head_dim=16,
                          channels=3, dropout=0.0, n_embed_tokens=0, output_tokens="input",
                          patch_to_embed=True), (2, 16, 16, 3), False),
    "ffhq_decoder": (dict(image_size=16, patch_size=4, dim=16, depth=1, head_dim=8,
                          channels=3, dropout=0.0, n_embed_tokens=0, n_input_tokens=16,
                          output_tokens="input", patch_to_embed=False,
                          embed_to_patch=True), (2, 16, 16), False),
    # the cross-attention stage: Tq = 5 embed tokens against 3 memory tokens
    "cross": (dict(image_size=8, patch_size=4, dim=16, depth=1, preprocess_depth=1,
                   heads=2, n_embed_tokens=5, n_input_tokens=2, num_classes=3,
                   output_tokens="embed", patch_to_embed=False), (2, 2, 16), True),
}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ flax layers


def _port_layer(layer, variables):
    return load_jax_variables(layer, variables).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_layernorm_embed_match_flax(dtype):
    """bf16: flax and the port cast to bf16 at the same places; the layer
    norm's f32 statistics and a bf16 Dense product may round one bf16 ulp
    apart (2^-7 of an entry near 1)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else 2.0**-7
    x = _rng(0).standard_normal((2, 5, 12)).astype(np.float32) * 3 + 1
    for jmod, tmod, inp in (
            (fnn.Dense(7, dtype=jdt), nets_utils.Dense(12, 7, tdt), x),
            (fnn.LayerNorm(dtype=jdt), nets_utils.LayerNorm(12, tdt), x),
            (fnn.Embed(9, 6, dtype=jdt), nets_utils.Embed(9, 6, tdt),
             np.array([[0, 8, 3], [1, 1, 5]], np.int32))):
        variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(inp))
        variables = jax.tree_util.tree_map(
            lambda a: a + _rng(2).standard_normal(a.shape).astype(np.float32) * 0.3,
            variables)  # LayerNorm's scale 1 and bias 0 would hide a swap
        want = jmod.apply(variables, jnp.asarray(inp))
        got = _port_layer(tmod, variables)(torch.from_numpy(inp))
        assert got.dtype == tdt
        _close(got.float().detach(), np.asarray(want, np.float32), tol)


def test_layernorm_fast_variance_against_two_pass():
    """flax's E[x²] − E[x]² (which the port keeps) against the two-pass
    variance in f32. The fast variance loses about mean²/var ulps of the
    variance: at unit-variance rows it agrees to 2e-6 of the output's range,
    at rows whose mean is 8 standard deviations off zero (mean²/var = 64) it
    measured 1.3e-5, held at 5e-5."""
    ln = nets_utils.LayerNorm(128)
    for offset, tol in ((0.0, 2e-6), (8.0, 5e-5)):
        x = torch.from_numpy(_rng(3).standard_normal((64, 128)).astype(np.float32) + offset)
        two_pass = torch.nn.functional.layer_norm(x, (128,), eps=1e-6)
        _close(ln(x).detach(), two_pass.numpy(), tol)


def test_multi_head_attention_matches_flax():
    """The projections' shapes and names, and the kernel route of
    mha_attention_fn, against flax's MHA with its stock attention; cross
    lengths as well."""
    q_in = _rng(4).standard_normal((2, 7, 16)).astype(np.float32)
    kv_in = _rng(5).standard_normal((2, 11, 16)).astype(np.float32)
    jmod = fnn.MultiHeadDotProductAttention(num_heads=4, deterministic=True)
    variables = jmod.init(jax.random.PRNGKey(6), jnp.asarray(q_in), jnp.asarray(kv_in))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, variables["params"])
    assert shapes["query"] == {"kernel": (16, 4, 4), "bias": (4, 4)}
    assert shapes["out"] == {"kernel": (4, 4, 16), "bias": (16,)}
    port = _port_layer(nets_utils.MultiHeadDotProductAttention(16, 4), variables)
    for kv in (q_in, kv_in):
        want = jmod.apply(variables, jnp.asarray(q_in), jnp.asarray(kv))
        before = attention.bthd_launch_count
        got = port(torch.from_numpy(q_in), torch.from_numpy(kv))
        assert attention.bthd_launch_count == before  # a CPU tensor launches nothing
        _close(got.detach(), want)


def test_mha_attention_fn_routes_as_the_jax_package(monkeypatch):
    """Mask-free, causal-hinted and broadcast-dropout calls reach the BTHD
    entries; a bias, an arbitrary mask and per-element dropout take the plain
    path. Each agrees with flax's stock attention (dropout: the two routes
    draw the same [Tq, Tk] mask from one seed)."""
    rng = _rng(7)
    q, k, v = (rng.standard_normal((2, 8, 2, 4)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    tril = np.tril(np.ones((8, 8), bool))[None, None]
    mask = rng.random((2, 1, 8, 8)) < 0.7
    mask[..., 0] = True
    routed = []
    for name in ("fused_attention_bthd", "fused_attention_bthd_dropout"):
        entry = getattr(nets_utils, name)
        monkeypatch.setattr(nets_utils, name,
                            lambda *a, _e=entry, _n=name, **kw: routed.append(_n) or _e(*a, **kw))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    cases = [  # (port kwargs, flax kwargs, expected route)
        ({}, {}, "fused_attention_bthd"),
        ({"mask": torch.from_numpy(tril), "causal_hint": True}, {"mask": jnp.asarray(tril)},
         "fused_attention_bthd"),
        ({"mask": torch.from_numpy(tril)}, {"mask": jnp.asarray(tril)}, None),
        ({"mask": torch.from_numpy(mask)}, {"mask": jnp.asarray(mask)}, None),
        ({"bias": torch.from_numpy(bias)}, {"bias": jnp.asarray(bias)}, None),
    ]
    for port_kw, flax_kw, route in cases:
        routed.clear()
        got = nets_utils.mha_attention_fn(tq, tk, tv, deterministic=True, **port_kw)
        _close(got, flax_attention(jq, jk, jv, deterministic=True, **flax_kw))
        assert routed == ([route] if route else [])
    drop = dict(dropout_rate=0.25, deterministic=False)
    outs = {}
    for broadcast in (True, False):
        for route in ("kernel", "plain"):
            routed.clear()
            gen = torch.Generator().manual_seed(8)
            fn = (nets_utils.mha_attention_fn if route == "kernel"
                  else nets_utils.dot_product_attention)
            outs[broadcast, route] = fn(tq, tk, tv, broadcast_dropout=broadcast,
                                        dropout_rng=gen, **drop)
            if route == "kernel":
                assert routed == (["fused_attention_bthd_dropout"] if broadcast else [])
    _close(outs[True, "kernel"], outs[True, "plain"].numpy())
    _close(outs[False, "kernel"], outs[False, "plain"].numpy())


# ------------------------------------------------------------ ViT


@pytest.mark.parametrize("plan", list(PLANS))
def test_vit_matches_jax(plan):
    cfg, shape, with_labels = PLANS[plan]
    x = _rng(9).standard_normal(shape).astype(np.float32)
    n_cls = cfg.get("num_classes")
    labels = np.array([1, n_cls - 1], np.int32) if with_labels else None
    jvit = JaxViT(**cfg)
    jkw = {} if labels is None else {"labels": jnp.asarray(labels)}
    variables = jax.jit(jvit.init)(jax.random.PRNGKey(10), jnp.asarray(x), **jkw)
    want = jax.jit(jvit.apply)(variables, jnp.asarray(x), **jkw)
    port = load_jax_variables(ViT(**cfg), variables).eval()
    assert port.out_size == tuple(jvit.out_size)
    assert port.total_num_tokens == jvit.total_num_tokens
    pkw = {} if labels is None else {"labels": torch.from_numpy(labels)}
    with torch.inference_mode():
        got = port(torch.from_numpy(x), **pkw)
    _close(got, want)


def test_vit_later_slices_raise():
    """Since slice 7 the time-dependent and causal ViTs and AutoRegressive
    construct (their parity is in tests/test_torch_dad.py); what still
    raises is what the JAX ViT refuses: an AutoRegressive without a
    vocabulary and the cached decode path off a causal token stack."""
    assert ViT(8, 16, patch_size=4, time_dependant=True).total_num_tokens == 6
    assert ViT(8, 16, patch_size=4, causal_mask=True).causal_mask
    with pytest.raises(ValueError, match="vocab_size"):
        AutoRegressive(8, 16, patch_size=4)
    vit = ViT(8, 16, patch_size=4, heads=2, depth=1)
    with pytest.raises(ValueError, match="causal_mask"):
        vit.eval()(torch.zeros(1, 8, 8, 3), decode=True)
    with pytest.raises(ValueError, match="token embeddings"):
        ViT(8, 16, patch_size=4, heads=2, depth=1, causal_mask=True).eval()(
            torch.zeros(1, 8, 8, 3), decode=True)
    # dropout 0.1 in train mode draws from the generator it is handed, and
    # raises without one (never from torch's global generator)
    with pytest.raises(ValueError, match="generator"):
        vit.train()(torch.zeros(1, 8, 8, 3))
    out = vit.train()(torch.zeros(1, 8, 8, 3), dropout_rng=torch.Generator().manual_seed(0))
    assert out.shape == (1, 1, 16) and bool(torch.isfinite(out).all())


# ------------------------------------------------------------ priors


def test_gaussian_prior_reparam_dim_matches_jax():
    x = _rng(11).standard_normal((3, 2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jp = JaxGaussianPrior(loss_coeff=0.1, reparam_dim=-2)
    want_z, want_loss, _ = jp.apply({}, jnp.asarray(x), 0, key)
    eps = np.array(jax.random.normal(key, (3, 1, 8), jnp.float32))
    port = GaussianPrior(loss_coeff=0.1, reparam_dim=-2)
    z, loss, _ = port(torch.from_numpy(x), 0, noise=torch.from_numpy(eps))
    assert port.out_size((2, 8)) == tuple(jp.out_size((2, 8))) == (1, 8)
    _close(z, want_z)
    _close(loss, want_loss)


def test_conditional_gaussian_prior_matches_jax():
    x = _rng(13).standard_normal((4, 2, 6)).astype(np.float32) * 0.5
    labels = np.array([0, 3, 3, 1], np.int32)
    key = jax.random.PRNGKey(14)
    jp = JaxConditionalGaussianPrior(dim=(1, 6), num_classes=4, loss_coeff=0.1,
                                     reparam_dim=-2, annealing_steps=10)
    variables = jp.init(jax.random.PRNGKey(15), jnp.asarray(x), 0, key,
                        labels=jnp.asarray(labels))
    port = load_jax_variables(ConditionalGaussianPrior((1, 6), 4, loss_coeff=0.1,
                                                      reparam_dim=-2, annealing_steps=10),
                              variables)
    for step in (3, 20):
        want_z, want_loss, want_art = jp.apply(variables, jnp.asarray(x), step, key,
                                               labels=jnp.asarray(labels))
        eps = np.array(jax.random.normal(key, (4, 1, 6), jnp.float32))
        z, loss, art = port(torch.from_numpy(x), step, noise=torch.from_numpy(eps),
                            labels=torch.from_numpy(labels))
        _close(z.detach(), want_z)
        _close(loss.detach(), want_loss)
        for got, want in zip(art["prior"], want_art["prior"]):
            _close(got.detach(), want)
    want_s = jp.apply(variables, key, (4, 1, 6), labels=jnp.asarray(labels),
                      method=jp.sample)
    mean, scale = port.p(torch.from_numpy(labels))
    _close((mean + scale * torch.from_numpy(eps)).detach(), want_s)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ConditionalGaussianPrior((1, 6), 4, ema_decay=0.9)


# ------------------------------------------------------------ the conditional VAE


@pytest.fixture(scope="module")
def cifar_pair():
    """(JAX VAE of configs/vae/vit.yaml with variables, the port's, loaded)."""
    jm = JaxVAE(encoder=JaxViT(**CIFAR_ENCODER), decoder=JaxViT(**CIFAR_DECODER),
                prior=JaxConditionalGaussianPrior(**CIFAR_PRIOR), conditional=True)
    batch = (np.zeros((2, 32, 32, 3), np.float32), np.zeros((2,), np.int32))
    jm.variables = jax.jit(jm.init_variables)(jax.random.PRNGKey(16), batch)
    pm = VAE(ViT(**CIFAR_ENCODER), ViT(**CIFAR_DECODER),
             ConditionalGaussianPrior(**CIFAR_PRIOR), conditional=True)
    load_jax_variables(pm.net, jm.variables)
    jm.inference_preprocess = JaxNormalize(CIFAR10_MEAN, CIFAR10_STD)
    jm.inference_postprocess = JaxUnNormalize(CIFAR10_MEAN, CIFAR10_STD)
    pm.inference_preprocess, pm.inference_postprocess = cifar10_transforms()
    return jm, pm.eval()


def _cifar_batch(n, seed):
    dm = CIFAR10(seed=42)
    dm.setup()
    idx = _rng(seed).choice(len(dm.test_dataset), n, replace=False)
    return dm.test_dataset.images[idx], dm.test_dataset.labels[idx]


def _eps(key, n):
    return np.array(jax.random.normal(key, (n, *CIFAR_LATENT), jnp.float32))


def test_conditional_vae_matches_jax(cifar_pair):
    jm, pm = cifar_pair
    assert pm.latent_size == tuple(jm.latent_size) == CIFAR_LATENT
    images, labels = _cifar_batch(4, 17)
    x = np.asarray(JaxNormalize(CIFAR10_MEAN, CIFAR10_STD)(images))
    key = jax.random.PRNGKey(18)
    tl = torch.from_numpy(labels)
    eps = torch.from_numpy(_eps(key, 4))

    @jax.jit  # one compile for the four calls
    def jax_calls(v, x, key, labels):
        z = jm.encode_fn(v, x, key, labels=labels)
        return (z, jm.decode_fn(v, z, labels=labels),
                jm.net.apply(v, x, 0, key, False, labels=labels),
                jm.sample_fn(v, key, 4, {"labels": labels}))

    want = jax_calls(jm.variables, jnp.asarray(x), key, jnp.asarray(labels))
    with torch.inference_mode():
        z = pm.net.encode(torch.from_numpy(x), noise=eps, labels=tl)
        mean, scale = pm.net.prior.p(tl)
        got = (z, pm.net.decode(torch.from_numpy(np.array(want[0])), labels=tl),
               pm.net(torch.from_numpy(x), noise=eps, labels=tl),
               pm.net.decode(mean + scale * eps, labels=tl))
    for g, w in zip(got, want):
        _close(g, w)
    pbatch = pm.batch_preprocess((torch.from_numpy(x), tl))
    assert set(pbatch["kwargs"]) == {"labels"} and pbatch["kwargs"]["labels"] is tl


def test_engines_agree_with_labels_and_bucket_padding(cifar_pair):
    """A request of 3 is padded into bucket 8 on both sides, labels with
    zeros; the request's rows do not depend on the padding."""
    jm, pm = cifar_pair
    jeng = JaxEngine(jm, batch_sizes=(1, 8, 64))
    peng = InferenceEngine(pm, batch_sizes=(1, 8, 64), device="cpu")
    images, labels = _cifar_batch(3, 19)
    key = jax.random.PRNGKey(20)
    eps = _eps(key, 8)  # JAX draws ε for the whole bucket

    got = peng.reconstruct(images, noise=eps[:3], labels=labels)
    assert got.shape == (3, 32, 32, 3)
    _close(got, jeng.reconstruct(images, key=key, labels=labels))
    got_z = peng.encode(images, noise=eps[:3], labels=labels)
    _close(got_z, jeng.encode(images, key=key, labels=labels))
    _close(peng.decode(got_z, labels=labels), jeng.decode(got_z, labels=labels))
    alone = peng.reconstruct(images[:1], noise=eps[:1], labels=labels[:1])
    _close(alone, got[:1])

    gen = torch.Generator().manual_seed(21)
    got_s = peng.sample(3, generator=gen, labels=labels)
    z = pm.net.sample_latents(3, torch.Generator().manual_seed(21),
                              labels=torch.from_numpy(labels))
    _close(got_s, jeng.decode(z.detach().numpy(), labels=labels))


# ------------------------------------------------------------ converter


def test_converter_round_trip(cifar_pair):
    """JAX variables → state dict → JAX variables is the identity, leaf by
    leaf, with flax's layouts kept for Dense (2-D) and attention (3-D)
    kernels, layer norms, embeddings, the raw embed_token and the prior's
    tables; an unknown leaf or a 4-D kernel outside a conv raises."""
    jm, pm = cifar_pair
    flat = jax.tree_util.tree_leaves_with_path(jm.variables["params"])
    state = jax_variables_to_state_dict(jm.variables)
    assert set(state) == set(pm.net.state_dict())
    back = state_dict_to_jax_variables(state)
    assert back["batch_stats"] == {}
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(back_flat) == len(flat)
    for path, value in flat:
        np.testing.assert_array_equal(back_flat[path], np.asarray(value))
    assert state["encoder.TransformerLayer_0.Dense_0.kernel"].shape == (128, 512)
    assert state["decoder.embed_token"].shape == (1, 16, 128)
    assert state["prior.mu"].shape == (10, 128)
    with pytest.raises(ValueError, match="Dense or attention kernel"):
        jax_variables_to_state_dict({"params": {"Dense_0": {"kernel": np.zeros((1, 1, 1, 1))}}})
    # (``weight`` maps since the Gaussian Fourier projection's does)
    with pytest.raises(ValueError, match="no mapping"):
        jax_variables_to_state_dict({"params": {"Dense_0": {"gain": np.zeros(1)}}})
