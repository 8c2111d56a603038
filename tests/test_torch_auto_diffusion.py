"""The port's AutoDiffusion path against the JAX package's, on the CPU: the
Gaussian Fourier projection and ``EqualDense``, the ``AutoEncoder`` with its
class and time embeddings (the FiLM path, attention blocks included) in
eval and train mode, AutoDiffusion's β_t weighting, time preprocessing, one
``loss_fn`` with its gradients leaf by leaf, and ``diffusion_sample`` with
both algorithms; then, within the port, the eval loop's preprocessing
generator, ``predict`` with the batch's kwargs, and ``VAE.sample`` and
``InferenceEngine.sample`` through the model's sampler.

JAX keys and torch generators draw different numbers, so nothing random is
drawn twice: JAX modules are initialised from a seed and carried across with
convert.py, t and ε are handed across as arrays (the sampler's draws
recorded from ``jax.random.normal`` while the JAX sampler is traced). Each
JAX function is compiled once with XLA's CPU optimisations off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.models import AutoDiffusion as JaxAutoDiffusion
from ot_vae_tpu.models.auto_diffusion import AutoDiffusionNet as JaxAutoDiffusionNet
from ot_vae_tpu.networks import AutoEncoder as JaxAutoEncoder
from ot_vae_tpu.networks import EqualDense as JaxEqualDense
from ot_vae_tpu.networks import GaussianFourierProjection as JaxFourier
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu_torch.convert import load_jax_variables, state_dict_to_jax_variables
from ot_vae_tpu_torch.data import ArrayDataset, BaseDatamodule
from ot_vae_tpu_torch.models import VAE, AutoDiffusion, auto_diffusion
from ot_vae_tpu_torch.networks import AutoEncoder, EqualDense, GaussianFourierProjection
from ot_vae_tpu_torch.priors import GaussianPrior
from ot_vae_tpu_torch.serving import InferenceEngine
from ot_vae_tpu_torch.trainer import Callback, Trainer

# f32 on both sides, the same function with sums in other orders; errors
# over max(1, max|output|), the sampler's two decode/encode rounds
# included (its JAX initial latents are drawn in f64, x64 being on in the
# tests, and cast to f32 here): measured at most 8.4e-7, held at 1e-5
TOL = 1e-5
# gradients leaf by leaf over max(1e-3, max|leaf|): measured 1.7e-5, held
# at 1e-4 as the ViT VAEs' (tests/test_torch_vit_training.py). A conv bias
# in front of a train-mode batch norm has a zero gradient in exact
# arithmetic: both sides read rounding noise there (up to 6.8e-7 measured),
# held to GRAD_NOISE absolute
GRAD_TOL = 1e-4
GRAD_NOISE = 2e-6
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
# the JAX gate's AutoEncoder (tests/test_auto_diffusion.py) at resolution
# 16 and capacity 4: attention at 8² and 4² in both CNNs
AE = dict(in_features=1, latent_features=4, in_resolution=16, latent_resolution=2,
          capacity=4, down_up_sample=True, residual="add", double_encoded_features=True)
EMBEDS = {"time": dict(time_embed_dim=8), "classes": dict(num_classes=10),
          "both": dict(num_classes=10, time_embed_dim=8)}


def _jit(fn, **kwargs):
    """``jax.jit(fn)`` compiled once, with :data:`_FAST_COMPILE`."""
    jitted, compiled = jax.jit(fn, **kwargs), {}

    def run(*args):
        if "c" not in compiled:
            compiled["c"] = jitted.lower(*args).compile(compiler_options=_FAST_COMPILE)
        return compiled["c"](*args)
    return run


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0,
                               err_msg=what)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree, np.float32)}


def _carried(port: torch.nn.Module, jax_init) -> dict:
    """The port module's seeded variables in the JAX layout, after checking
    that they are exactly the tree ``jax_init()`` makes (paths, shapes;
    traced with ``jax.eval_shape``, nothing compiled)."""
    variables = state_dict_to_jax_variables(port.state_dict())
    shapes = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), jax.eval_shape(jax_init))).items()}
    got = {k: v.shape for k, v in _flat(variables).items()}
    assert got == shapes
    return variables


def _grads_close(port_module, jax_grads, tol=GRAD_TOL):
    """Every gradient leaf of ``port_module`` against the JAX gradients; a
    parameter without a gradient counts as zeros."""
    got = _flat(state_dict_to_jax_variables(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in port_module.named_parameters()})["params"])
    want = _flat(jax_grads)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, err_msg=path,
                                   atol=max(tol * max(1e-3, np.abs(w).max()), GRAD_NOISE))


# ------------------------------------------------------------ layers


@pytest.mark.parametrize("trainable,out_dim", [(False, 16), (True, None)],
                         ids=["fixed_3_layers", "trainable"])
def test_gaussian_fourier_projection_matches_flax(trainable, out_dim):
    """Values, the gradient of a fixed cotangent with respect to t and every
    parameter; without ``trainable`` no gradient reaches ``weight`` (JAX:
    zeros)."""
    t = _rng(0).uniform(0, 1, (5,)).astype(np.float32)
    jmod = JaxFourier(16, out_dim=out_dim, trainable=trainable)
    torch.manual_seed(1)
    port = GaussianFourierProjection(16, out_dim, trainable=trainable)
    variables = _carried(port, lambda: jmod.init(jax.random.PRNGKey(1), jnp.asarray(t)))
    cot = _rng(2).standard_normal((5, out_dim or 16)).astype(np.float32)

    def loss(v, t):
        out = jmod.apply(v, t)
        return jnp.sum(out * cot), out

    (_, want), (gv, gt) = _jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables, jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_()
    out = port(tt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want)
    _close(tt.grad, gt, what="dt")
    assert (port.weight.grad is None) == (not trainable)
    assert trainable or not np.abs(np.asarray(gv["params"]["weight"])).max()
    _grads_close(port, gv["params"])
    with pytest.raises(ValueError, match="1-dimensional"):
        port(tt[:, None])


def test_equal_dense_matches_flax():
    x = _rng(3).standard_normal((4, 6)).astype(np.float32)
    jmod = JaxEqualDense(5, lr_mult=2.0)
    torch.manual_seed(4)
    port = EqualDense(6, 5, lr_mult=2.0)
    variables = _carried(port, lambda: jmod.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    cot = _rng(5).standard_normal((4, 5)).astype(np.float32)
    (_, want), (gv, gx) = _jit(jax.value_and_grad(
        lambda v, x: (jnp.sum(jmod.apply(v, x) * cot), jmod.apply(v, x)),
        argnums=(0, 1), has_aux=True))(variables, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want)
    _close(tx.grad, gx, what="dx")
    _grads_close(port, gv["params"])


@pytest.mark.parametrize("embed", list(EMBEDS))
def test_autoencoder_embeddings_match_jax(embed):
    """The AutoEncoder's forward in eval mode (running statistics) and in
    train mode (batch statistics), and the running statistics a train
    forward leaves, with labels, t or both."""
    kw = {**AE, **EMBEDS[embed]}
    x = _rng(6).standard_normal((4, 16, 16, 1)).astype(np.float32)
    labels = np.array([0, 3, 9, 3], np.int32)
    t = _rng(7).uniform(0, 1, (4,)).astype(np.float32)
    cond = {}
    if "num_classes" in kw:
        cond["labels"] = labels
    if "time_embed_dim" in kw:
        cond["time"] = t
    jmod = JaxAutoEncoder(**kw)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    torch.manual_seed(8)
    port = AutoEncoder(**kw)
    variables = _carried(port, lambda: jmod.init(jax.random.PRNGKey(8), jnp.asarray(x),
                                                 **jcond))

    def both(v, x, c):
        train, mutated = jmod.apply(v, x, **c, train=True, mutable=["batch_stats"])
        return jmod.apply(v, x, **c, train=False), train, mutated["batch_stats"]

    want_eval, want_train, want_stats = _jit(both)(variables, jnp.asarray(x), jcond)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(x), **tcond), want_eval, what="eval")
        _close(port.train()(torch.from_numpy(x), **tcond), want_train, what="train")
    got_stats = _flat(state_dict_to_jax_variables(port.state_dict())["batch_stats"])
    for path, w in _flat(want_stats).items():
        _close(got_stats[path], w, what=path)
    missing = "labels" if "num_classes" in kw else "time"
    with pytest.raises(ValueError, match=missing):
        port(torch.from_numpy(x), **{k: v for k, v in tcond.items() if k != missing})


# ------------------------------------------------------------ AutoDiffusion


AD_AE = {**AE, "time_embed_dim": 8}


def _port_model(seed=9):
    torch.manual_seed(seed)
    return AutoDiffusion(autoencoder=AutoEncoder(**AD_AE), prior=GaussianPrior(loss_coeff=0.1),
                         n_steps=2)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX AutoDiffusion (2 sampler steps) and the port model's seeded
    variables in its layout."""
    jm = JaxAutoDiffusion(autoencoder=JaxAutoEncoder(**AD_AE),
                          prior=JaxGaussianPrior(loss_coeff=0.1), n_steps=2)
    batch = (jnp.zeros((4, 16, 16, 1), jnp.float32), jnp.zeros((4,), jnp.int32))
    variables = _carried(_port_model().net,
                         lambda: jm.init_variables(jax.random.PRNGKey(9), batch))
    return jm, variables


def _models(jax_model):
    """The JAX model, its variables and the port's model holding them."""
    jm, variables = jax_model
    pm = _port_model()
    load_jax_variables(pm.net, variables)
    return jm, variables, pm


def test_beta_t_weighting_and_time_preprocess(jax_model):
    """β_t weights the prior loss (≈0 at t = 0, ≈1 at t = 1, 1/2 at 1/2) as
    the JAX model's; t ~ U[0, 1) per image from the generator, 0.5 without
    one, as tests/test_auto_diffusion.py holds the JAX package."""
    jm, _, pm = _models(jax_model)
    ploss = _rng(10).uniform(0, 2, (4,)).astype(np.float32)
    for t in (np.zeros(4), np.ones(4), np.full(4, 0.5), _rng(11).uniform(0, 1, 4)):
        t = t.astype(np.float32)
        want = jm.prior_loss(jnp.asarray(ploss), {}, time=jnp.asarray(t))
        got = pm.prior_loss(torch.from_numpy(ploss), {}, time=torch.from_numpy(t))
        _close(got, want)
    ones = torch.ones(4)
    assert float(pm.prior_loss(ones, {}, time=torch.zeros(4))) < 0.01
    assert float(pm.prior_loss(ones, {}, time=torch.ones(4))) > 0.99
    batch = (torch.zeros(16, 32, 32, 1), torch.zeros(16, dtype=torch.int32))
    for train in (True, False):
        t = pm.batch_preprocess(batch, train, torch.Generator().manual_seed(0))["kwargs"]["time"]
        assert t.shape == (16,) and 0 <= t.min() and t.max() < 1 and t.std() > 0.05
        assert torch.equal(t, torch.rand(16, generator=torch.Generator().manual_seed(0)))
        t0 = pm.batch_preprocess(batch, train)["kwargs"]["time"]
        assert torch.equal(t0, torch.full((16,), 0.5))


def test_auto_diffusion_loss_and_gradients_match_jax(jax_model):
    """One ``loss_fn`` in train mode at step 5 with the JAX t and ε handed
    across: the logs, every gradient leaf and the running statistics."""
    jm, variables, pm = _models(jax_model)
    images = _rng(12).standard_normal((4, 16, 16, 1)).astype(np.float32)
    pbatch = jm.batch_preprocess((jnp.asarray(images), jnp.zeros(4, jnp.int32)),
                                 jax.random.PRNGKey(13), train=True)
    rngs = {"prior": jax.random.PRNGKey(14), "dropout": jax.random.PRNGKey(15)}
    eps = np.array(jax.random.normal(rngs["prior"], (4, 2, 2, 4), jnp.float32))
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        return jm.loss_fn({"params": params, **rest}, pbatch, 5, rngs)

    (_, (logs, _, mutated)), grads = _jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    t = torch.from_numpy(np.array(pbatch["kwargs"]["time"]))
    x = torch.from_numpy(images)
    ploss, plogs, _ = pm.loss_fn({"samples": x, "target": x, "kwargs": {"time": t}}, 5,
                                 noise=torch.from_numpy(eps))
    ploss.backward()
    for key in logs:
        _close(plogs[key], logs[key], what=key)
    _grads_close(pm.net, grads)
    got_stats = _flat(state_dict_to_jax_variables(pm.net.state_dict())["batch_stats"])
    for path, w in _flat(mutated["batch_stats"]).items():
        _close(got_stats[path], w, what=path)


@pytest.fixture
def jax_normals(monkeypatch):
    """``run(fn, *args)``: ``fn(*args)`` jitted, and the ``jax.random.normal``
    draws it makes, in call order."""
    drawn = []
    normal = jax.random.normal

    def record(key, shape=(), dtype=None):
        out = normal(key, shape) if dtype is None else normal(key, shape, dtype)
        drawn.append(out)
        return out

    monkeypatch.setattr(jax.random, "normal", record)

    def run(fn, *args):
        def traced(*a):
            drawn.clear()
            return fn(*a), list(drawn)

        out, draws = _jit(traced)(*args)
        return out, [np.asarray(d, np.float32) for d in draws]

    return run


@pytest.mark.parametrize("improved", [False, True], ids=["standard", "improved"])
def test_diffusion_sample_matches_jax(jax_model, jax_normals, monkeypatch, improved):
    """``diffusion_sample`` with ``return_steps``: every step's image, with
    the JAX initial latents (the prior's draw) and each step's ε
    (``standard_normal``) handed across; the improved algorithm's two
    encodes of a step draw the same ε."""
    jm, variables, pm = _models(jax_model)
    steps, draws = jax_normals(lambda v, k: jm.net.apply(
        v, k, 3, improved_algorithm=improved, return_steps=True,
        method=JaxAutoDiffusionNet.diffusion_sample), variables, jax.random.PRNGKey(16))
    per_step = 2 if improved else 1
    assert len(draws) == 1 + per_step * 2 and len(steps) == 2
    if improved:
        assert all(np.array_equal(a, b) for a, b in zip(draws[1::2], draws[2::2]))

    def sample(return_steps):
        latents = torch.from_numpy(draws[0].copy())
        eps = iter([torch.from_numpy(d.copy()) for d in draws[1::per_step]])
        monkeypatch.setattr(pm.net.prior, "sample", lambda *a, **k: latents)
        monkeypatch.setattr(auto_diffusion, "standard_normal", lambda shape, *a: next(eps))
        return pm.eval().net.diffusion_sample(3, improved_algorithm=improved,
                                              return_steps=return_steps)

    got = sample(True)
    for i, (g, w) in enumerate(zip(got, steps)):
        _close(g, w, what=f"step {i}")
    assert torch.equal(sample(False), got[-1])


# ------------------------------------------------------------ within the port


class _Outputs(Callback):
    def __init__(self):
        self.rows = []

    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx):
        self.rows.append(outputs)

    on_test_batch_end = on_validation_batch_end


def _datamodule(n=8, size=16, seed=17):
    images = _rng(seed).uniform(0, 1, (n, size, size, 1)).astype(np.float32)
    ds = ArrayDataset(images, np.zeros(n, np.int32))
    dm = BaseDatamodule()
    dm.train_dataset = dm.val_dataset = dm.test_dataset = dm.predict_dataset = ds
    dm.val_batch_size = dm.test_batch_size = dm.predict_batch_size = 4
    return dm


def test_eval_loop_draws_the_time_from_its_generator():
    """Validation and test hand ``batch_preprocess`` the generator of (salt,
    epoch, batch, 2), salt 2 for validation and 3 for test, as the JAX eval
    step hands its ``k_pre``: AutoDiffusion's t is drawn from it, per image,
    not the keyless 0.5."""
    model = _port_model()
    rec = _Outputs()
    trainer = Trainer(device="cpu", seed=3, callbacks=[rec])
    trainer.validate(model, _datamodule())
    trainer.test(model, _datamodule())
    assert len(rec.rows) == 4
    for i, (salt, batch_idx) in enumerate([(2, 0), (2, 1), (3, 0), (3, 1)]):
        t = rec.rows[i]["kwargs"]["time"]
        want = torch.rand(4, generator=trainer.generator(salt, 0, batch_idx, 2))
        assert torch.equal(t, want) and t.std() > 0
    # predict preprocesses without a generator, as the JAX predict passes no
    # key (t = 0.5), and hands the batch's kwargs to the model
    out = trainer.predict(model, _datamodule())
    x = torch.from_numpy(_datamodule().predict_dataset.images[:4])
    with torch.no_grad():
        assert torch.equal(out[0], model(x, time=torch.full((4,), 0.5)))


def test_plain_vae_eval_and_sample_are_unchanged():
    """A plain VAE: the eval loop's outputs are the eval step's on the
    keyless preprocessing (the generator it now takes goes unused), and
    ``VAE.sample`` and ``InferenceEngine.sample`` are ``net.sample``'s draws,
    bit for bit."""
    torch.manual_seed(0)
    model = VAE(autoencoder=AutoEncoder(**{**AE, "latent_resolution": 4}),
                prior=GaussianPrior(loss_coeff=0.1))
    rec = _Outputs()
    dm = _datamodule()
    trainer = Trainer(device="cpu", seed=5, callbacks=[rec])
    trainer.validate(model, dm)
    for batch_idx, batch in enumerate(dm.val_batches()):
        pbatch = model.batch_preprocess(trainer._put(batch), train=False)
        preds, latents = model.eval_outputs(pbatch, trainer.generator(2, 0, batch_idx),
                                            trainer.generator(2, 0, batch_idx, 1))
        assert torch.equal(rec.rows[batch_idx]["preds"], preds)
        assert torch.equal(rec.rows[batch_idx]["latents"], latents)
        assert torch.equal(rec.rows[batch_idx]["samples"], pbatch["samples"])
    model.eval()
    with torch.no_grad():
        want = model.net.sample(3, torch.Generator().manual_seed(6))
        assert torch.equal(model.sample(3, torch.Generator().manual_seed(6)), want)
        # the engine moves the model to channels_last, where the convs may
        # round differently: its reference is drawn after the move
        engine = InferenceEngine(model, device="cpu")
        want = model.net.sample(3, torch.Generator().manual_seed(6))
        got = engine.sample(3, torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(got, want.numpy())


def test_samplers_go_through_the_model():
    """``VAE.sample`` and ``InferenceEngine.sample`` of an AutoDiffusion
    return its diffusion sampler's images for the same generator, not prior
    draws decoded."""
    model = _port_model().eval()
    with torch.no_grad():
        want = model.net.diffusion_sample(3, torch.Generator().manual_seed(7))
        prior_draws = model.net.sample(3, torch.Generator().manual_seed(7),
                                       time=torch.ones(3))
        got = model.sample(3, torch.Generator().manual_seed(7))
        engine = InferenceEngine(model, device="cpu")  # channels_last from here
        want_served = model.net.diffusion_sample(3, torch.Generator().manual_seed(7))
        served = engine.sample(3, torch.Generator().manual_seed(7))
    assert torch.equal(got, want) and not torch.equal(got, prior_draws)
    np.testing.assert_array_equal(served, want_served.numpy())
