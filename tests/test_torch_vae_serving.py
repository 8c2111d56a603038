"""The port's VAE and InferenceEngine against the JAX package's, on the CPU.

The same small encoder/decoder pair (capacity 8, 16² ↔ 4², attention with
head dim 8) is built in JAX, carried across with convert.py, and both sides
get the same inputs and the same noise: JAX's ε is handed to the port.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.data.transforms import Normalize as JaxNormalize
from ot_vae_tpu.data.transforms import UnNormalize as JaxUnNormalize
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import CNN as JaxCNN
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu.serving import InferenceEngine as JaxEngine
from ot_vae_tpu_torch.convert import jax_variables_to_state_dict, load_jax_variables
from ot_vae_tpu_torch.data import FFHQ128_MEAN, FFHQ128_STD, ffhq128_transforms
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.models.base import seeded_generator
from ot_vae_tpu_torch.networks import CNN
from ot_vae_tpu_torch.priors import GaussianPrior
from ot_vae_tpu_torch.serving import InferenceEngine

ENCODER = dict(in_features=3, out_features=16, in_resolution=16, out_resolution=4,
               capacity=8, down_sample=True, residual="add", attn_head_dim=8,
               max_attn_res=8)
DECODER = dict(in_features=8, out_features=3, in_resolution=4, out_resolution=16,
               capacity=8, up_sample=True, residual="add", attn_head_dim=8,
               max_attn_res=8)
LATENT = (4, 4, 8)

# f32 on both sides; encoder and decoder together are about twenty conv
# layers whose sums XLA and oneDNN order differently. Errors are taken
# against max(1, max|output|): measured ≤ 6e-6 at outputs up to 12
TOL = 1e-4


def _random_variables(shapes, seed):
    """Variables of the given shape tree, drawn with numpy (no JAX init is
    compiled): conv kernels at std 1/sqrt(fan_in), random batch-norm
    statistics, scales and biases."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = visit(v)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                draw = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
            elif k in ("var", "scale"):
                draw = rng.uniform(0.5, 1.5, shape)
            else:  # mean, bias
                draw = rng.normal(0.0, 0.2, shape)
            out[k] = draw.astype(np.float32)
        return out

    return visit(shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX VAE with variables, the port's VAE loaded from them)."""
    jm = JaxVAE(encoder=JaxCNN(**ENCODER), decoder=JaxCNN(**DECODER),
                prior=JaxGaussianPrior())
    batch = (jnp.zeros((2, 16, 16, 3), jnp.float32), jnp.zeros((2,), jnp.int32))
    shapes = jax.eval_shape(lambda key: jm.init_variables(key, batch), jax.random.PRNGKey(0))
    jm.variables = _random_variables(shapes, 0)
    pm = VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior())
    load_jax_variables(pm.net, jm.variables)
    return jm, pm.eval()


@pytest.fixture(scope="module")
def jax_fns(pair):
    """Jitted JAX calls: one compile each, reused across the tests at batch 8."""
    jm, _ = pair
    return {
        "encode": jax.jit(lambda v, x, k: jm.encode_fn(v, x, k)),
        "encode_expand2": jax.jit(lambda v, x, k: jm.net.apply(
            v, x, 0, k, False, expand=2, method="encode")),
        "decode": jax.jit(lambda v, z: jm.decode_fn(v, z)),
        "reconstruct": jax.jit(lambda v, x, k: jm.net.apply(v, x, 0, k, False)),
    }


def _images(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 16, 16, 3)).astype(np.float32)


def _eps(key, n):
    return np.array(jax.random.normal(key, (n, *LATENT), jnp.float32))


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, np.abs(want).max()), rtol=0)


def test_latent_size_matches(pair):
    jm, pm = pair
    assert pm.latent_size == tuple(jm.latent_size) == LATENT


def test_encode_with_jax_noise(pair, jax_fns):
    jm, pm = pair
    x, key = _images(8, 0), jax.random.PRNGKey(3)
    want = jax_fns["encode"](jm.variables, jnp.asarray(x), key)
    with torch.inference_mode():
        got = pm.net.encode(torch.from_numpy(x), noise=torch.from_numpy(_eps(key, 8)))
    _assert_close(got, want)


def test_encode_expand_replicates_before_the_draw(pair, jax_fns):
    jm, pm = pair
    x, key = _images(4, 1), jax.random.PRNGKey(4)
    want = jax_fns["encode_expand2"](jm.variables, jnp.asarray(x), key)
    with torch.inference_mode():
        got = pm.net.encode(torch.from_numpy(x), noise=torch.from_numpy(_eps(key, 8)),
                            expand=2)
    _assert_close(got, want)


def test_decode(pair, jax_fns):
    jm, pm = pair
    z = np.random.default_rng(5).standard_normal((8, *LATENT)).astype(np.float32)
    want = jax_fns["decode"](jm.variables, jnp.asarray(z))
    with torch.inference_mode():
        got = pm.net.decode(torch.from_numpy(z))
    _assert_close(got, want)


def test_reconstruct_with_jax_noise(pair, jax_fns):
    jm, pm = pair
    x, key = _images(8, 6), jax.random.PRNGKey(7)
    want = jax_fns["reconstruct"](jm.variables, jnp.asarray(x), key)
    with torch.inference_mode():
        got = pm.net(torch.from_numpy(x), noise=torch.from_numpy(_eps(key, 8)))
    _assert_close(got, want)


def test_sample_decodes_the_prior_draw(pair, jax_fns):
    """sample(n, g) is decode of the latents the same generator draws; the
    draw itself differs from JAX's, so its z is handed to JAX's decode."""
    jm, pm = pair
    with torch.inference_mode():
        z = pm.net.sample_latents(8, seeded_generator(11, "cpu"))
        got = pm.net.sample(8, seeded_generator(11, "cpu"))
    assert z.shape == (8, *LATENT)
    _assert_close(got, jax_fns["decode"](jm.variables, jnp.asarray(z.numpy())))


@pytest.mark.parametrize("fixed_var", [False, True])
def test_gaussian_prior_matches_jax(fixed_var):
    """z = μ + σ·ε with σ = exp(log σ²/2) split on the channel axis; with
    ``fixed_var`` unit variance scaled by the time temperature."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    time = rng.uniform(0.1, 1.0, 3).astype(np.float32)
    key = jax.random.PRNGKey(13)
    cond = {"time": jnp.asarray(time)} if fixed_var else {}
    z, _, _ = JaxGaussianPrior(fixed_var=fixed_var).apply(
        {}, jnp.asarray(x), 0, key, False, **cond)
    latent = x.shape if fixed_var else (3, 2, 2, 4)
    eps = np.array(jax.random.normal(key, latent, jnp.float32))
    got, _, _ = GaussianPrior(fixed_var=fixed_var)(
        torch.from_numpy(x), noise=torch.from_numpy(eps),
        time=torch.from_numpy(time) if fixed_var else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(z), atol=1e-6, rtol=1e-6)


def test_vae_api_applies_the_inference_transforms(pair):
    """VAE.forward/encode/decode/sample wrap VAENet with the transforms when
    ``inference`` is on, as the engine's endpoints do."""
    _, pm = pair
    pre, post = ffhq128_transforms()
    pm.inference_preprocess, pm.inference_postprocess = pre, post
    x = torch.from_numpy(_images(8, 14))
    eps = torch.from_numpy(_eps(jax.random.PRNGKey(15), 8))
    with torch.inference_mode():
        pm.inference = False
        raw = pm(x, noise=eps)
        pm.inference = True
        np.testing.assert_array_equal(pm(x, noise=eps).numpy(),
                                      post(pm.net(pre(x), noise=eps)).numpy())
        np.testing.assert_array_equal(raw.numpy(), pm.net(x, noise=eps).numpy())
        z = pm.encode(x, noise=eps)
        np.testing.assert_array_equal(z.numpy(), pm.net.encode(pre(x), noise=eps).numpy())
        np.testing.assert_array_equal(pm.decode(z).numpy(), post(pm.net.decode(z)).numpy())
        np.testing.assert_array_equal(
            pm.sample(8, seeded_generator(3, "cpu")).numpy(),
            post(pm.net.sample(8, seeded_generator(3, "cpu"))).numpy())
    pm.inference = False


def _engines(pair):
    jm, pm = pair
    jm.inference_preprocess = JaxNormalize(FFHQ128_MEAN, FFHQ128_STD)
    jm.inference_postprocess = JaxUnNormalize(FFHQ128_MEAN, FFHQ128_STD)
    pm.inference_preprocess, pm.inference_postprocess = ffhq128_transforms()
    return JaxEngine(jm, batch_sizes=(1, 8, 64)), InferenceEngine(
        pm, batch_sizes=(1, 8, 64), device="cpu")


def test_engines_agree_with_bucket_padding(pair):
    """A request of 3 is padded into bucket 8 on both sides; the FFHQ128
    transforms wrap every endpoint."""
    jeng, peng = _engines(pair)
    x, key = _images(3, 8), jax.random.PRNGKey(9)
    eps = _eps(key, 8)  # JAX draws ε for the whole bucket

    got = peng.reconstruct(x, noise=eps[:3])
    assert got.shape == (3, 16, 16, 3)
    _assert_close(got, jeng.reconstruct(x, key=key))

    got_z = peng.encode(x, noise=eps[:3])
    assert got_z.shape == (3, *LATENT)
    _assert_close(got_z, jeng.encode(x, key=key))

    _assert_close(peng.decode(got_z), jeng.decode(got_z))

    got_s = peng.sample(8, generator=seeded_generator(2, "cpu"))
    z = pair[1].net.sample_latents(8, seeded_generator(2, "cpu")).numpy()
    _assert_close(got_s, jeng.decode(z))


def test_engine_default_draws_follow_a_per_engine_counter(pair):
    _, pm = pair
    pm.inference_preprocess, pm.inference_postprocess = ffhq128_transforms()
    x = _images(2, 10)
    a = InferenceEngine(pm, device="cpu")
    first, second = a.reconstruct(x), a.reconstruct(x)
    b = InferenceEngine(pm, device="cpu")
    np.testing.assert_array_equal(b.reconstruct(x), first)
    assert not np.array_equal(first, second)


def test_engine_later_slices_raise(pair):
    _, pm = pair
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        InferenceEngine(pm, mesh=object(), device="cpu")
    # restore is served now (tests/test_torch_transport.py); without a fitted
    # operator it raises as the JAX engine does
    with pytest.raises(ValueError, match="no fitted state"):
        InferenceEngine(pm, device="cpu").restore(_images(1, 0),
                                                  types.SimpleNamespace(state=None))


def test_forward_and_encode_without_a_generator_agree(pair):
    """With neither a generator nor ε, forward and encode draw ε from a fresh
    generator seeded 0 on every call, as the JAX package uses PRNGKey(0):
    two calls on one input agree."""
    _, pm = pair
    x = torch.from_numpy(_images(2, 16))
    with torch.inference_mode():
        assert torch.equal(pm(x), pm(x))
        z = pm.encode(x)
        assert torch.equal(z, pm.encode(x))
        assert torch.equal(z, pm.encode(x, seeded_generator(0, "cpu")))
        assert not torch.equal(z, pm.encode(x, seeded_generator(1, "cpu")))


def test_converter_is_strict(pair):
    jm, pm = pair
    state = jax_variables_to_state_dict(jm.variables)
    assert set(state) == set(pm.net.state_dict())
    missing = dict(jm.variables["params"])
    missing["decoder"] = {k: v for k, v in missing["decoder"].items()
                          if k != "ConvBlock_0"}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_variables(VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior()).net,
                           {**jm.variables, "params": missing})
    extra = {**jm.variables, "params": {**jm.variables["params"],
                                        "extra": {"Conv_0": {"bias": np.zeros(3)}}}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_variables(VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior()).net,
                           extra)
    # (prior_stats maps since the codebook prior's k-means state does)
    with pytest.raises(ValueError, match="no mapping"):
        jax_variables_to_state_dict({**jm.variables, "intermediates": {}})
