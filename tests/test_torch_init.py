"""Initial weights, on the CPU. The port draws its Dense, attention-projection
and conv kernels as flax draws them: ``lecun_normal``, a normal truncated at
2 standard deviations with std 1/sqrt(fan in), held against
``jax.nn.initializers.lecun_normal``. JAX keys and torch generators draw
different numbers, so those tests compare distributions: the truncation
bound, the standard deviation and the percentiles of the fan-in-scaled
kernels. ``jax_init`` draws the JAX package's own initial weights of a
seed, held to the JAX package's draws value by value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.models import AutoDiffusion as JaxAutoDiffusion
from ot_vae_tpu.networks import AutoEncoder as JaxAutoEncoder
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu_torch import jax_init
from ot_vae_tpu_torch.convert import state_dict_to_jax_variables
from ot_vae_tpu_torch.models import AutoDiffusion
from ot_vae_tpu_torch.networks import AutoEncoder
from ot_vae_tpu_torch.networks.nets_utils import Dense, EqualConv, MultiHeadDotProductAttention
from ot_vae_tpu_torch.priors import GaussianPrior

# the standard deviation of a unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978
# the percentiles of 262k–295k draws a side, fan-in-scaled (unit std): the
# two packages' draws differed by at most 0.0080 at seed 0, held at 0.02 (a
# percentile's standard error is at most about 0.004 a side)
QUANTILE_TOL = 0.02
QUANTILES = np.linspace(0.01, 0.99, 99)
# jax_init's normal and truncated-normal draws against JAX's, over
# max(1, |draw|): the inverse error function is torch's in f64 against XLA's
# f32 polynomial; measured at most 5.4e-6 (normal) and 5.2e-7 (truncated)
# over 20 keys of 4096 draws (an AutoEncoder's initial weights 5.2e-6), held at 2e-5
DRAW_TOL = 2e-5
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _kernels(kind):
    """(the port's kernels of ``kind`` drawn from torch seed 0, their fan
    in): a 1024 → 256 Dense, the four projections of 256-wide 4-head
    attention, a 3 × 3 conv from 128 to 256 channels."""
    torch.manual_seed(0)
    if kind == "dense":
        return Dense(1024, 256).kernel.detach().numpy(), 1024
    if kind == "attention":
        mha = MultiHeadDotProductAttention(256, 4)
        ws = [getattr(mha, n).kernel.detach().numpy() for n in ("query", "key", "value", "out")]
        return np.concatenate([w.ravel() for w in ws]), 256
    conv = EqualConv(128, 256, 3)
    return conv.Conv_0.weight.detach().numpy(), 128 * 3 * 3


@pytest.mark.parametrize("kind", ["dense", "attention", "conv"])
def test_kernels_drawn_as_flax_draws_them(kind):
    w, fan_in = _kernels(kind)
    unit = np.asarray(w, np.float64).ravel() * np.sqrt(fan_in)
    want = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, unit.size // fan_in), jnp.float32),
        np.float64).ravel() * np.sqrt(fan_in)
    bound = 2.0 / TRUNCATED_STD
    assert np.abs(want).max() <= bound * (1 + 1e-6)
    assert np.abs(unit).max() <= bound * (1 + 1e-6), np.abs(unit).max()
    assert abs(unit.std() - 1.0) < 0.01, unit.std()
    diff = np.abs(np.quantile(unit, QUANTILES) - np.quantile(want, QUANTILES)).max()
    assert diff < QUANTILE_TOL, diff


# ------------------------------------------------ the JAX package's weights


def test_jax_draws_match_jax_random():
    """The numpy copy of JAX's PRNG: keys bit for bit, uniform draws bit for
    bit, normal and truncated-normal draws to a few f32 ulps (torch's f64
    erfinv against XLA's f32 polynomial)."""
    key = jax.random.PRNGKey(42)
    port_key = jax_init.prng_key(42)
    assert np.array_equal(np.asarray(jax.random.key_data(key)), np.array(port_key))
    key, port_key = jax.random.fold_in(key, 7), jax_init.fold_in(port_key, 7)
    assert np.array_equal(np.asarray(key), np.array(port_key))
    for k, pk in zip(jax.random.split(key, 3), jax_init.split(port_key, 3)):
        assert np.array_equal(np.asarray(k), np.array(pk))
    np.testing.assert_array_equal(jax_init.uniform(port_key, (5, 7)),
                                  np.asarray(jax.random.uniform(key, (5, 7), jnp.float32)))
    for got, want in ((jax_init.normal(port_key, (64, 64)),
                       jax.random.normal(key, (64, 64), jnp.float32)),
                      (jax_init.truncated_normal(port_key, (64, 64)),
                       jax.random.truncated_normal(key, -2.0, 2.0, (64, 64), jnp.float32))):
        want = np.asarray(want)
        assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= DRAW_TOL


def test_jax_trainer_init_matches_the_jax_package():
    """``load_jax_trainer_init`` against the JAX ``VAE.init_variables`` with
    ``Trainer(seed=3)``'s key (``fold_in(PRNGKey(3), 0)``), leaf by leaf, for
    an AutoDiffusion AutoEncoder with class and time embeddings (flax's
    Conv and Dense kernels, ``EqualDense``, the Fourier projection,
    ``Embed``)."""
    ae = dict(in_features=1, latent_features=4, in_resolution=16, latent_resolution=2,
              capacity=4, down_up_sample=True, residual="add", double_encoded_features=True,
              num_classes=10, time_embed_dim=8)
    jm = JaxAutoDiffusion(autoencoder=JaxAutoEncoder(**ae), conditional=True,
                          prior=JaxGaussianPrior(loss_coeff=0.1), n_steps=2)
    batch = (jnp.zeros((4, 16, 16, 1), jnp.float32), jnp.zeros((4,), jnp.int32))
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    want = jax.jit(jm.init_variables).lower(key, batch).compile(
        compiler_options=_FAST_COMPILE)(key, batch)
    torch.manual_seed(0)
    pm = AutoDiffusion(autoencoder=AutoEncoder(**ae), conditional=True,
                       prior=GaussianPrior(loss_coeff=0.1), n_steps=2)
    jax_init.load_jax_trainer_init(pm.net, 3)
    got = state_dict_to_jax_variables(pm.net.state_dict())

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, prefix + (key,)).items()}
        return {"/".join(prefix): np.asarray(tree, np.float32)}

    got, want = flat(got), flat(jax.device_get(want))
    assert set(got) == set(want)
    for path, w in want.items():
        err = (np.abs(got[path] - w) / np.maximum(1.0, np.abs(w))).max()
        assert err <= DRAW_TOL, (path, err)
