"""The port's ViT training path against the JAX package's, on the CPU:
train-mode ``Dropout``, ``PositionalEmbedding`` and ``TransformerLayer``
against flax, ``RandomHorizontalFlip`` against the JAX transform, the
conditional CIFAR10 ViT VAE of configs/vae/vit.yaml at its full width (with
dropout 0.1) and a reduced FFHQ128-shaped ViT VAE: their gradients leaf by
leaf and one Adam step against the JAX ``loss_fn`` under
``jax.value_and_grad``; and ``Trainer.fit`` of a small conditional ViT VAE.

JAX keys and torch generators draw different numbers, so nothing random is
drawn twice: JAX modules are initialised from a seed and carried across with
convert.py, ε and the labels are handed across as arrays, and the dropout
masks flax draws are recorded in call order (``jax.random.bernoulli``
wrapped while the JAX function is traced, the masks returned from the
jitted function as outputs) and fed to the port's one mask function,
``nets_utils.dropout_keep``. On the CPU the JAX ViT takes flax's stock
attention and the port the plain row-7 and row-8 versions; both compute the
same f32 function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ot_vae_tpu.data.transforms import RandomHorizontalFlip as JaxRandomHorizontalFlip
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import ViT as JaxViT
from ot_vae_tpu.networks.vit import PositionalEmbedding as JaxPositionalEmbedding
from ot_vae_tpu.networks.vit import TransformerLayer as JaxTransformerLayer
from ot_vae_tpu.priors import ConditionalGaussianPrior as JaxConditionalGaussianPrior
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu_torch.convert import load_jax_variables, state_dict_to_jax_variables
from ot_vae_tpu_torch.data import CIFAR10, RandomHorizontalFlip
from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import nets_utils
from ot_vae_tpu_torch.networks.vit import PositionalEmbedding, TransformerLayer, ViT
from ot_vae_tpu_torch.priors import ConditionalGaussianPrior, GaussianPrior
from ot_vae_tpu_torch.trainer import Trainer

# f32 on both sides, the same function with sums in other orders (XLA's and
# torch's); errors over max(1, max|output|): measured below 1e-6 for the
# layers, held at 1e-5
TOL = 1e-5

# configs/vae/vit.yaml at full width (the ViT's default dropout, 0.1)
CIFAR_ENCODER = dict(image_size=32, patch_size=8, dim=128, depth=3, heads=4, channels=3,
                     num_classes=10, n_embed_tokens=2, output_tokens="embed",
                     patch_to_embed=True, embed_to_patch=False)
CIFAR_DECODER = dict(image_size=32, patch_size=8, dim=128, depth=3, heads=4, channels=3,
                     num_classes=10, n_embed_tokens=None, n_input_tokens=1,
                     output_tokens="embed", patch_to_embed=False, embed_to_patch=True)
CIFAR_PRIOR = dict(dim=(1, 128), num_classes=10, loss_coeff=0.1, reparam_dim=-2,
                   annealing_steps=1000)
# configs/vae/vit_ffhq128.yaml's plans at image 16, patch 4 (16 tokens),
# widths 32 and 16, head dims 16 and 8, depth 1, dropout 0
FFHQ_ENCODER = dict(image_size=16, patch_size=4, dim=32, depth=1, head_dim=16, channels=3,
                    dropout=0.0, n_embed_tokens=0, output_tokens="input", patch_to_embed=True)
FFHQ_DECODER = dict(image_size=16, patch_size=4, dim=16, depth=1, head_dim=8, channels=3,
                    dropout=0.0, n_embed_tokens=0, n_input_tokens=16, output_tokens="input",
                    patch_to_embed=False, embed_to_patch=True)
LR = 1e-3  # Adam's default learning rate in both packages


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0,
                               err_msg=what)


@pytest.fixture
def flax_masks(monkeypatch):
    """``run(fn, *args)``: ``fn(*args)`` jitted, and the masks its dropout
    sites draw, [(mask, keep probability)] in call order."""
    drawn = []
    bernoulli = jax.random.bernoulli

    def record(key, p=0.5, shape=None, **kwargs):
        keep = bernoulli(key, p, shape, **kwargs)
        drawn.append((keep, float(p)))
        return keep

    monkeypatch.setattr(jax.random, "bernoulli", record)

    def run(fn, *args):
        def traced(*a):
            drawn.clear()
            return fn(*a), [keep for keep, _ in drawn]

        out, masks = jax.jit(traced)(*args)
        return out, [(np.asarray(m), p) for m, (_, p) in zip(masks, drawn)]

    return run


def _hand_masks(monkeypatch, drawn):
    """The port's mask function returns the recorded masks in order (the
    attention weights' [1, 1, Tq, Tk] mask as the [Tq, Tk] the kernel path
    asks for), checking that each site asks for the same keep probability
    and size, and has a generator."""
    queue = list(drawn)

    def replay(shape, keep_prob, generator, device):
        assert generator is not None
        keep, p = queue.pop(0)
        assert keep.size == int(np.prod(shape)) and abs(p - keep_prob) < 1e-12, (shape, p)
        return torch.from_numpy(np.array(keep).reshape(tuple(shape))).to(device)

    monkeypatch.setattr(nets_utils, "dropout_keep", replay)
    return queue


# ------------------------------------------------------------ layers in train mode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_flax(monkeypatch, flax_masks, dtype):
    """where(keep, x / keep_prob, 0) in x's dtype; the identity in eval mode
    and at rate 0; train mode without a generator raises. Jitted, XLA
    multiplies by the reciprocal instead of dividing, which may round an
    entry one ulp the other way: 1e-5 in f32, 2^-7 (one bf16 step at the
    largest entries, 1 to 2) in bf16."""
    x = _rng(0).standard_normal((3, 5, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    want, masks = flax_masks(lambda x: fnn.Dropout(0.3).apply(
        {}, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)}), jx)
    assert len(masks) == 1 and 0 < masks[0][0].mean() < 1
    with pytest.raises(ValueError, match="generator"):
        nets_utils.Dropout(0.3).train()(tx)
    left = _hand_masks(monkeypatch, masks)
    got = nets_utils.Dropout(0.3).train()(tx, torch.Generator())
    assert got.dtype == tx.dtype and not left
    _close(got.float(), want, TOL if dtype == "float32" else 2.0**-7)
    assert nets_utils.Dropout(0.3).eval()(tx) is tx
    assert nets_utils.Dropout(0.0).train()(tx) is tx


def test_positional_embedding_train_matches_flax(monkeypatch, flax_masks):
    x = _rng(1).standard_normal((2, 7, 16)).astype(np.float32)
    jmod = JaxPositionalEmbedding(9, 16, dropout=0.2)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    want, masks = flax_masks(lambda v, x: jmod.apply(
        v, x, train=True, rngs={"dropout": jax.random.PRNGKey(3)}), variables, jnp.asarray(x))
    assert [m.shape for m, _ in masks] == [(2, 7, 16)]
    port = load_jax_variables(PositionalEmbedding(9, 16, dropout=0.2), variables).train()
    with pytest.raises(ValueError, match="generator"):
        port(torch.from_numpy(x))
    left = _hand_masks(monkeypatch, masks)
    _close(port(torch.from_numpy(x), torch.Generator()), want)
    assert not left


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_transformer_layer_train_matches_flax(monkeypatch, flax_masks, cross):
    """flax draws the attention weights' mask, then the attention output's,
    [the cross-attention's two], the ReLU output's and the MLP output's; the
    port draws the same sites in the same order (shapes checked)."""
    x = _rng(4).standard_normal((2, 5, 16)).astype(np.float32)
    memory = _rng(5).standard_normal((2, 3, 16)).astype(np.float32)
    jmod = JaxTransformerLayer(16, 2, 32, dropout=0.25, cross=cross)
    kw = {"memory": jnp.asarray(memory)} if cross else {}
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(6), jnp.asarray(x), **kw)
    want, masks = flax_masks(lambda v, x, kw: jmod.apply(
        v, x, train=True, rngs={"dropout": jax.random.PRNGKey(7)}, **kw),
        variables, jnp.asarray(x), kw)
    shapes = [(1, 1, 5, 5), (2, 5, 16)] + ([(1, 1, 5, 3), (2, 5, 16)] if cross else [])
    assert [m.shape for m, _ in masks] == shapes + [(2, 5, 32), (2, 5, 16)]
    left = _hand_masks(monkeypatch, masks)
    port = load_jax_variables(TransformerLayer(16, 2, 32, dropout=0.25, cross=cross),
                              variables).train()
    pkw = {"memory": torch.from_numpy(memory)} if cross else {}
    got = port(torch.from_numpy(x), dropout_rng=torch.Generator(), **pkw)
    _close(got, want)
    assert not left


# ------------------------------------------------------------ data


def test_random_horizontal_flip_matches_jax(monkeypatch):
    """The same flip decisions (the port's draws handed to the JAX host
    path's np.random.random) give the same images, batched (per element)
    and unbatched, numpy and torch."""
    images = _rng(8).uniform(0, 1, (6, 4, 5, 3)).astype(np.float32)
    flip = RandomHorizontalFlip(0.5)
    uniforms = torch.rand(6, generator=torch.Generator().manual_seed(9))
    monkeypatch.setattr(np.random, "random", lambda size: uniforms.numpy()[:max(1, int(
        np.prod(size)))].reshape(size).astype(np.float64))
    want = JaxRandomHorizontalFlip(0.5)(images)
    got = flip(images, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(got, want)
    assert 0 < int((uniforms < 0.5).sum()) < 6  # both outcomes occur
    got_t = flip(torch.from_numpy(images), torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(got_t.numpy(), want)
    want_one = JaxRandomHorizontalFlip(0.5)(images[0])
    np.testing.assert_array_equal(flip(images[0], torch.Generator().manual_seed(9)), want_one)
    with pytest.raises(ValueError, match="generator"):
        flip(images)


def test_cifar10_train_split_flips_from_its_seed():
    """Each train image is the normalised image or its mirror; the flips
    repeat for a seed and epoch, and change with the epoch."""
    kw = dict(synthetic_train=16, synthetic_test=10, train_batch_size=8, seed=3)
    plain = [b[0] for b in CIFAR10(random_flip=False, **kw).train_batches(0)]
    dm = CIFAR10(**kw)
    runs = {e: [b[0] for b in dm.train_batches(e)] for e in (0, 0, 1)}
    again = [b[0] for b in dm.train_batches(0)]
    for got, ref in zip(runs[0], plain):
        same = np.all(got == ref, axis=(1, 2, 3))
        mirrored = np.all(got == ref[:, :, ::-1], axis=(1, 2, 3))
        assert np.all(same | mirrored) and 0 < mirrored.sum()
    for a, b in zip(runs[0], again):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in
               zip(runs[1], [b[0] for b in CIFAR10(random_flip=False, **kw).train_batches(1)]))
    val = [b[0] for b in dm.val_batches()]
    np.testing.assert_array_equal(val[0], [b[0] for b in CIFAR10(random_flip=False, **kw)
                                           .val_batches()][0])


# ------------------------------------------------------------ the VAEs


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree, np.float32)}


def _vae_pair(encoder, decoder, jax_prior, port_prior, conditional, batch):
    jm = JaxVAE(encoder=JaxViT(**encoder), decoder=JaxViT(**decoder), prior=jax_prior,
                conditional=conditional)
    variables = jax.jit(jm.init_variables)(jax.random.PRNGKey(11), batch)
    pm = VAE(ViT(**encoder), ViT(**decoder), port_prior, conditional=conditional)
    load_jax_variables(pm.net, variables)
    return jm, variables, pm


# (config, prior kwargs, conditional, ε shape, expected masks, gradient tol):
# gradients in f32 through 6 (CIFAR10) and 2 (FFHQ128-shaped) post-LN
# blocks, leaf by leaf over max(1e-3, max|leaf|); measured 3e-6 and 1e-6,
# held at 1e-4
VAES = {
    "cifar10_vit": (CIFAR_ENCODER, CIFAR_DECODER, "conditional", (1, 128), 24),
    "ffhq128_shaped_vit": (FFHQ_ENCODER, FFHQ_DECODER, "gaussian", (16, 16), 0),
}
GRAD_TOL = 1e-4


@pytest.mark.parametrize("name", list(VAES))
def test_vit_vae_gradients_and_adam_step_match_jax(monkeypatch, flax_masks, name):
    """loss_fn in train mode at step 5 with labels, handed ε and handed
    masks: the logs, every gradient leaf, and the parameters after one Adam
    step (lr 1e-3) against the JAX ``loss_fn`` under ``jax.value_and_grad``
    and optax's Adam."""
    enc, dec, prior, eps_shape, n_masks = VAES[name]
    conditional = prior == "conditional"
    if conditional:
        priors = (JaxConditionalGaussianPrior(**CIFAR_PRIOR),
                  ConditionalGaussianPrior(**CIFAR_PRIOR))
    else:
        priors = (JaxGaussianPrior(loss_coeff=0.1, reparam_dim=-1),
                  GaussianPrior(loss_coeff=0.1, reparam_dim=-1))
    size = enc["image_size"]
    images = _rng(12).standard_normal((4, size, size, 3)).astype(np.float32)
    labels = np.array([0, 3, 3, 9], np.int32)
    jm, variables, pm = _vae_pair(enc, dec, *priors, conditional, (images, labels))
    rngs = {"prior": jax.random.PRNGKey(13), "dropout": jax.random.PRNGKey(14)}
    eps = np.array(jax.random.normal(rngs["prior"], (4, *eps_shape), jnp.float32))
    pbatch = jm.batch_preprocess((jnp.asarray(images), jnp.asarray(labels)), None, train=True)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def jax_loss(params):
        return jm.loss_fn({"params": params, **rest}, pbatch, 5, rngs)

    ((_, (logs, _, _)), grads), masks = flax_masks(
        jax.value_and_grad(jax_loss, has_aux=True), variables["params"])
    assert len(masks) == n_masks
    left = _hand_masks(monkeypatch, masks)

    x = torch.from_numpy(images)
    kwargs = {"labels": torch.from_numpy(labels)} if conditional else {}
    loss, plogs, _ = pm.loss_fn({"samples": x, "target": x, "kwargs": kwargs}, 5,
                                noise=torch.from_numpy(eps), dropout_rng=torch.Generator())
    assert not left
    loss.backward()
    for key in logs:
        _close(plogs[key], logs[key], 1e-5, key)
    pgrads = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in pm.net.named_parameters()})["params"])
    jgrads = _flat(grads)
    assert set(pgrads) == set(jgrads)
    for path, want in jgrads.items():
        np.testing.assert_allclose(pgrads[path], want, rtol=0, err_msg=path,
                                   atol=GRAD_TOL * max(1e-3, np.abs(want).max()))

    opt = jm.optimizer()

    @jax.jit
    def adam(grads, params):  # one optax Adam step from its initial state
        updates, _ = opt.update(grads, opt.init(params), params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    want_params = _flat(adam(grads, variables["params"]))
    pm.optimizer().step()
    got_params = _flat(state_dict_to_jax_variables(pm.net.state_dict())["params"])
    for path, want in want_params.items():
        # Adam's first step moves an entry by lr·g/(|g| + 1e-8): the same
        # f32 formula, a few ulps of lr apart, wherever |g| is well above
        # 1e-8; an entry whose gradient is near 1e-8 or below (rounding
        # noise, or exactly 0 on one side) may move by up to lr differently
        noise = np.abs(jgrads[path]) < 1e-6
        tol = np.where(noise, LR, 1e-6)
        assert np.all(np.abs(got_params[path] - want) <= tol), path


# ------------------------------------------------------------ Trainer.fit


class _Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def _small_fit(trainer_seed):
    torch.manual_seed(0)
    enc = {**CIFAR_ENCODER, "dim": 32, "depth": 1}
    dec = {**CIFAR_DECODER, "dim": 32, "depth": 1}
    model = VAE(ViT(**enc), ViT(**dec), ConditionalGaussianPrior(
        **{**CIFAR_PRIOR, "dim": (1, 32)}), metrics=MetricCollection({"psnr": PSNR()}),
        conditional=True)
    dm = CIFAR10(synthetic_train=8, synthetic_test=10, train_batch_size=4, val_batch_size=8,
                 seed=0)
    logger = _Recorder()
    trainer = Trainer(max_epochs=1, limit_batches=2, logger=logger, log_every_n_steps=1,
                      device="cpu", seed=trainer_seed).fit(model, dm)
    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    return model, trainer, losses


def test_fit_small_conditional_vit_vae_on_the_cpu():
    """Two steps with dropout 0.1, flips and labels, then a validation:
    finite losses and PSNR; the same seeds give the same parameters, another
    trainer seed (other ε and dropout draws) other ones."""
    model, trainer, losses = _small_fit(0)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert np.isfinite(trainer.logged_metrics["val/metrics/psnr"])
    again, _, losses_again = _small_fit(0)
    assert losses_again == losses
    other, _, _ = _small_fit(1)
    params = dict(model.net.named_parameters())
    assert all(torch.equal(p, params[k]) for k, p in again.net.named_parameters())
    assert not all(torch.equal(p, params[k]) for k, p in other.net.named_parameters())
