"""The port's MNIST32 pieces against the JAX package's, on the CPU: the
datamodule's synthetic batches, the Pad, CenterCrop and GaussianBlur
transforms, the AutoEncoder (narrow, carried across with convert.py),
``Trainer.test`` and both attention kernels' plain versions at the small
head dims the MNIST32 models use (the Pallas kernels in interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.data import MNIST32 as JaxMNIST32
from ot_vae_tpu.data.transforms import CenterCrop as JaxCenterCrop
from ot_vae_tpu.data.transforms import GaussianBlur as JaxGaussianBlur
from ot_vae_tpu.data.transforms import Pad as JaxPad
from ot_vae_tpu.metrics import PSNR as JaxPSNR
from ot_vae_tpu.metrics import MetricCollection as JaxMetricCollection
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import AutoEncoder as JaxAutoEncoder
from ot_vae_tpu.ops.attention_pallas import _fused_packed, _packed_fwd_call
from ot_vae_tpu.trainer import Trainer as JaxTrainer
from ot_vae_tpu_torch.convert import load_jax_variables
from ot_vae_tpu_torch.data import MNIST32, CenterCrop, GaussianBlur, Pad, from_spec, to_spec
from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import AutoEncoder
from ot_vae_tpu_torch.ops.attention import (
    attention_packed_backward_reference,
    attention_packed_reference,
)
from ot_vae_tpu_torch.trainer import Trainer

# a narrow MNIST32 AutoEncoder: 32² ↔ 4², capacity 2, so its attention
# blocks run at head dims 1 and 2 (heads by div_sqrt, as at full width)
AE = dict(in_features=1, latent_features=8, in_resolution=32, latent_resolution=4,
          capacity=2, down_up_sample=True, residual="add")
# the tiny model of the Trainer checks: one one-layer block each way, 32² ↔ 16²,
# no attention (the attention blocks are held to JAX above and below)
TINY_AE = dict(in_features=1, latent_features=4, in_resolution=32, latent_resolution=16,
               capacity=2, n_layers=1, down_up_sample=True, residual="add", max_attn_res=8)
DATA = dict(train_batch_size=10, val_batch_size=10, test_batch_size=10,
            predict_batch_size=16, seed=42, synthetic_train=20, synthetic_test=40,
            test_val_split=0.5)
# f32 on both sides; about twenty conv layers whose sums XLA and oneDNN order
# differently, errors against max(1, max|output|): measured below 1e-6
TOL = 1e-4


def _random_variables(shapes, seed):
    """Variables of the shape tree, drawn with numpy: conv kernels at std
    1/sqrt(fan_in), batch-norm statistics, scales and biases near theirs."""
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
            else:
                draw = rng.normal(0.0, 0.2, shape)
            out[k] = draw.astype(np.float32)
        return out

    return visit(shapes)


def _pair(ae):
    """(JAX VAE around a JAX AutoEncoder, the port's VAE loaded from it)."""
    jm = JaxVAE(metrics=JaxMetricCollection({"psnr": JaxPSNR()}),
                autoencoder=JaxAutoEncoder(**ae), prior=None)
    batch = (jnp.zeros((2, 32, 32, 1), jnp.float32), jnp.zeros((2,), jnp.int32))
    shapes = jax.eval_shape(lambda key: jm.init_variables(key, batch), jax.random.PRNGKey(0))
    jm.variables = _random_variables(shapes, 0)
    pm = VAE(metrics=MetricCollection({"psnr": PSNR()}), autoencoder=AutoEncoder(**ae),
             prior=None)
    load_jax_variables(pm.net, jm.variables)
    return jm, pm.eval()


def test_mnist32_batches_match():
    ours, theirs = MNIST32(**DATA), JaxMNIST32(**DATA)
    for split in ("train", "val", "test", "predict"):
        for epoch in (0, 1) if split == "train" else (0,):
            args = (epoch,) if split == "train" else ()
            got = list(getattr(ours, f"{split}_batches")(*args))
            want = list(getattr(theirs, f"{split}_batches")(*args))
            assert len(got) == len(want) > 0
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, np.asarray(wx))
                np.testing.assert_array_equal(gy, np.asarray(wy))
    assert ours.img_size == theirs.img_size == (32, 32)
    for t in (ours.inference_preprocess, ours.inference_postprocess):
        assert from_spec(to_spec(t)) == t


def test_pad_and_center_crop_match():
    x = np.random.default_rng(1).uniform(0, 1, (3, 28, 28, 1)).astype(np.float32)
    padded = JaxPad(2)(x)
    np.testing.assert_array_equal(Pad(2)(x), padded)
    np.testing.assert_array_equal(Pad(2)(torch.from_numpy(x)).numpy(), padded)
    np.testing.assert_array_equal(CenterCrop(28)(torch.from_numpy(padded)).numpy(),
                                  JaxCenterCrop(28)(padded))
    np.testing.assert_array_equal(CenterCrop(28)(padded), x)


@pytest.mark.parametrize("batched", [True, False])
def test_gaussian_blur_matches(batched):
    """A 5-tap depthwise blur, f32 sums in another order: within 1e-6."""
    shape = (2, 32, 32, 3) if batched else (32, 32, 3)
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(JaxGaussianBlur(5, sigma=1.5)(jnp.asarray(x), jax.random.PRNGKey(0)))
    got = GaussianBlur(5, sigma=1.5)(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(GaussianBlur(5, sigma=1.5)(x), want, atol=1e-6, rtol=0)


def test_autoencoder_matches():
    jm, pm = _pair(AE)
    assert pm.latent_size == tuple(jm.latent_size) == (4, 4, 8)
    x = np.random.default_rng(3).standard_normal((4, 32, 32, 1)).astype(np.float32)
    z_want = np.array(jax.jit(jm.encode_fn)(jm.variables, jnp.asarray(x)))
    out_want = np.array(jax.jit(jm.decode_fn)(jm.variables, jnp.asarray(z_want)))
    with torch.no_grad():
        z = pm.net.encode(torch.from_numpy(x))
        out = pm.net.decode(torch.from_numpy(z_want))
    for got, want in ((z, z_want), (out, out_want)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=TOL * max(1.0, np.abs(want).max()),
                                   rtol=0)


def test_trainer_test_and_predict_match_jax():
    """Trainer.test of a tiny model without a fit: the test split's PSNR,
    within 1e-3 dB. Trainer.predict: the forward of each raw predict batch
    with the inference transforms (normalise and pad in, crop out), as the
    JAX trainer's predict calls the model."""
    jm, pm = _pair(TINY_AE)
    ttr = Trainer(seed=42, device="cpu")
    want = JaxTrainer(seed=42).test(jm, JaxMNIST32(**DATA))
    got = ttr.test(pm, MNIST32(**DATA))
    assert set(got) == set(want) == {"test/metrics/psnr"}
    np.testing.assert_allclose(got["test/metrics/psnr"], want["test/metrics/psnr"],
                               atol=1e-3, rtol=0)
    dm = MNIST32(**DATA)
    preds = ttr.predict(pm, dm)
    raw = [torch.from_numpy(x) for x, _ in dm.predict_batches()]
    assert len(preds) == len(raw) == 2 and not pm.inference
    pm.inference = True
    with torch.no_grad():
        for got_pred, x in zip(preds, raw):
            assert got_pred.shape == (16, 28, 28, 1)
            assert torch.equal(got_pred, pm(x))
    pm.inference = False
    assert np.isfinite(ttr.validate(pm, dm)["val/metrics/psnr"])


def _qkv(t, h, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 3 * h * c)).astype(np.float32),
            rng.standard_normal((2, t, h * c)).astype(np.float32))


@pytest.mark.parametrize("t,h,c", [(16, 2, 1), (64, 4, 2), (16, 8, 4)])
def test_small_head_forward_matches_pallas(t, h, c):
    """f32, the same products summed in another order over at most 64 keys:
    within 1e-5 (out) and 1e-5 (lse)."""
    qkv, _ = _qkv(t, h, c, seed=t * h + c)
    scale = 1.0 / np.sqrt(c)
    out_want, lse_want = _packed_fwd_call(jnp.asarray(qkv), h, scale, True)
    out, lse = attention_packed_reference(torch.from_numpy(qkv), h, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want).reshape(lse.shape),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,h,c", [(16, 2, 1), (64, 4, 2)])
def test_small_head_backward_matches_pallas(t, h, c):
    """The gradient of the Pallas forward (its VJP is the Pallas backward):
    f32 within 1e-5, as at the wide head dims."""
    qkv, dout = _qkv(t, h, c, seed=t + h + c)
    scale = 1.0 / np.sqrt(c)
    _, vjp = jax.vjp(lambda x: _fused_packed(x, h, scale, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(dout))
    q = torch.from_numpy(qkv)
    out, lse = attention_packed_reference(q, h, scale)
    got = attention_packed_backward_reference(q, out, lse, torch.from_numpy(dout), h, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
