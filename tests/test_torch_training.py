"""The port's training path against the JAX package's, on the CPU.

The small encoder/decoder pair of the serving tests (capacity 8, 16² ↔ 4²,
attention with head dim 8) is built in JAX with variables drawn by numpy
and carried across with convert.py. Both sides see the same batches and the
same ε: JAX's draw is rebuilt from the JAX trainer's key and handed to the
port. On the CPU, JAX's attention takes its einsum path and the port's its
plain versions, all in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ot_vae_tpu.data.datasets import FFHQ128 as JaxFFHQ128
from ot_vae_tpu.metrics import PSNR as JaxPSNR
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import CNN as JaxCNN
from ot_vae_tpu.networks.nets_utils import Normalization as JaxNormalization
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu.priors.base import annealing_coeff as jax_annealing_coeff
from ot_vae_tpu.trainer.trainer import Trainer as JaxTrainer
from ot_vae_tpu.utils import mean_replicated_batch as jax_mean_replicated
from ot_vae_tpu.utils import std_replicated_batch as jax_std_replicated
from ot_vae_tpu_torch.convert import (
    jax_variables_to_state_dict,
    load_jax_variables,
    state_dict_to_jax_variables,
)
from ot_vae_tpu_torch.data import (
    FFHQ128,
    ArrayDataset,
    BaseDatamodule,
    Compose,
    Identity,
    Normalize,
    UnNormalize,
    from_spec,
    to_spec,
)
from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import CNN
from ot_vae_tpu_torch.networks.nets_utils import Normalization
from ot_vae_tpu_torch.priors import GaussianPrior
from ot_vae_tpu_torch.priors.base import annealing_coeff
from ot_vae_tpu_torch.serving import InferenceEngine
from ot_vae_tpu_torch.trainer import ModelCheckpointCallback, Trainer
from ot_vae_tpu_torch.utils import ema, mean_replicated_batch, std_replicated_batch

ENCODER = dict(in_features=3, out_features=16, in_resolution=16, out_resolution=4,
               capacity=8, down_sample=True, residual="add", attn_head_dim=8,
               max_attn_res=8)
DECODER = dict(in_features=8, out_features=3, in_resolution=4, out_resolution=16,
               capacity=8, up_sample=True, residual="add", attn_head_dim=8,
               max_attn_res=8)
LATENT = (4, 4, 8)
BATCH = 8
SEED = 3
PRIOR = dict(loss_coeff=0.1, annealing_steps=2)  # the warm-up reads the step counter
LR = 1e-3


def _random_variables(shapes, seed):
    """Variables of the given shape tree, drawn with numpy: conv kernels at
    std 1/sqrt(fan_in), batch-norm scales and biases around flax's init,
    running statistics at flax's init (mean 0, var 1)."""
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
            elif k == "scale":
                draw = rng.uniform(0.5, 1.5, shape)
            elif k == "var":
                draw = np.ones(shape)
            elif k == "mean":
                draw = np.zeros(shape)
            else:  # bias
                draw = rng.normal(0.0, 0.2, shape)
            out[k] = draw.astype(np.float32)
        return out

    return visit(shapes)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _images(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 16, 16, 3)).astype(np.float32)


def _port_model(variables, **kw):
    pm = VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior(**PRIOR),
             metrics=MetricCollection({"psnr": PSNR()}), learning_rate=LR, **kw)
    load_jax_variables(pm.net, variables)
    return pm


def _rounding_noise(grads):
    """Masks of the gradient entries that are zero in exact arithmetic, and
    the model's largest gradient. A per-channel constant that reaches a
    batch norm through linear layers alone is removed by the norm's mean:
    the conv biases before a norm, the norm biases of the 1×1 skips, and at
    step 0 (prior warm-up coefficient 0) the biases of μ, which meet the
    decoder's first norm. In floating point such a gradient is rounding
    noise, below 1e-6 of the largest here; the gradient test asserts that
    under 1% of the entries fall below the 1e-5 split."""
    scale = max(np.abs(g).max() for g in grads.values())
    return {k: np.abs(g) <= 1e-5 * scale for k, g in grads.items()}, scale


def _close_masked(got, want, tol, what):
    """|got − want| ≤ tol entry by entry (tol an array of want's shape)."""
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{what}: {bad.sum()} entries off, worst "
                           f"{np.abs(got - want).max():.3e}")


@pytest.fixture(scope="module")
def setup():
    """The JAX model with numpy-drawn variables, its jitted value-and-grad of
    ``loss_fn``, and the batches of three train steps."""
    jm = JaxVAE(encoder=JaxCNN(**ENCODER), decoder=JaxCNN(**DECODER),
                prior=JaxGaussianPrior(**PRIOR), learning_rate=LR)
    batch = (jnp.zeros((BATCH, 16, 16, 3), jnp.float32), jnp.zeros((BATCH,), jnp.int32))
    shapes = jax.eval_shape(lambda key: jm.init_variables(key, batch), jax.random.PRNGKey(0))
    variables = _random_variables(shapes, 0)

    def lf(params, mutable, samples, step, key):
        pbatch = {"samples": samples, "target": samples, "kwargs": {}}
        loss, (logs, _, mutated) = jm.loss_fn({"params": params, **mutable}, pbatch, step,
                                              {"prior": key, "dropout": key})
        return loss, (logs, mutated)

    grad_fn = jax.jit(jax.value_and_grad(lf, has_aux=True))
    batches = [_images(BATCH, 10 + i) for i in range(3)]
    return jm, variables, grad_fn, batches


def _jax_prior_key(trainer_seed, epoch, batch_idx):
    """k_prior of the JAX trainer's step (trainer.py:146-151, 180)."""
    key = JaxTrainer(seed=trainer_seed)._key(1, epoch, batch_idx)
    return jax.random.split(key, 3)[1]


def _eps(key):
    return np.array(jax.random.normal(key, (BATCH, *LATENT), jnp.float32))


def _close(got, want, atol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= atol, f"{what}: max abs err {err:.3e} > {atol:.3e}"


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batch_norm_matches_flax(dtype):
    """Output from batch statistics (f32, fast variance) and the running
    statistics moved by 0.1 towards the biased batch statistics."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 5, 6, 8)) * 2 + 1).astype(np.float32)
    mean0 = rng.normal(0, 0.5, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.2, 8).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    want, mutated = JaxNormalization("batchnorm", 8, dtype=jdt).apply(
        variables, jnp.asarray(x, jdt), train=True, mutable=["batch_stats"])
    norm = Normalization("batchnorm", 8, tdt)
    load_jax_variables(norm, variables)
    got = norm.train()(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    # f32: the same f32 statistics in another summation order (≤ 1e-6 here);
    # bf16: one bf16 rounding of outputs up to 8 (2^-5)
    tol = 1e-5 if dtype == "float32" else 2.0**-5
    _close(got.permute(0, 2, 3, 1).float(), np.asarray(want, np.float32), tol, "output")
    stats = mutated["batch_stats"]["BatchNorm_0"]
    # f32 statistics of bf16-rounded or f32 inputs, summation order only
    _close(norm.BatchNorm_0.running_mean, stats["mean"], 1e-6, "running mean")
    _close(norm.BatchNorm_0.running_var, stats["var"], 1e-5, "running var")


@pytest.mark.parametrize("empirical_kl", [False, True])
def test_prior_loss_matches_jax(empirical_kl):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(key, (3, 2, 2, 4), jnp.float32))
    kw = dict(loss_coeff=0.1, annealing_steps=10, empirical_kl=empirical_kl)
    for step in (0, 3, 12):
        z, loss, art = JaxGaussianPrior(**kw).apply({}, jnp.asarray(x), step, key, True)
        gz, gloss, gart = GaussianPrior(**kw)(torch.from_numpy(x), step,
                                              noise=torch.from_numpy(eps))
        # f32 on both sides: exp, log and a sum of 16 terms
        _close(gz, z, 1e-6, f"z at step {step}")
        _close(gloss, loss, 1e-5, f"loss at step {step}")
        for name in ("prior", "distribution"):
            for g, w in zip(gart[name], art[name]):
                _close(g, w, 1e-6, f"{name} at step {step}")


def test_annealing_coeff_matches_jax():
    for steps in (0, 10):
        for step in (0, 1, 5, 9, 10, 20):
            # one f32 cosine on each side
            _close(annealing_coeff(step, steps), jax_annealing_coeff(step, steps), 1e-6,
                   f"step {step} of {steps}")


def test_replicated_batch_reductions_and_ema_match_jax():
    x = np.random.default_rng(3).standard_normal((6, 2, 3)).astype(np.float32)
    for n in (1, 2, 3):
        _close(mean_replicated_batch(torch.from_numpy(x), n),
               jax_mean_replicated(jnp.asarray(x), n), 1e-6, f"mean n={n}")
        _close(std_replicated_batch(torch.from_numpy(x), n),
               jax_std_replicated(jnp.asarray(x), n), 1e-6, f"std n={n}")
    a, b = torch.ones(3), torch.full((3,), 3.0)
    assert torch.equal(ema(a, b, 0.75), torch.full((3,), 1.5))
    assert torch.equal(ema(a, b, None), torch.full((3,), 4.0))


def test_transform_specs_round_trip_in_the_jax_format():
    from ot_vae_tpu.data.transforms import from_spec as jax_from_spec
    from ot_vae_tpu.data.transforms import to_spec as jax_to_spec
    from ot_vae_tpu.data.transforms import Normalize as JaxNormalize

    t = Compose([Identity(), Normalize((0.5, 0.4, 0.3), (0.2, 0.2, 0.1))])
    assert from_spec(to_spec(t)) == t
    assert to_spec(Normalize((0.5,), (0.2,))) == jax_to_spec(JaxNormalize((0.5,), (0.2,)))
    u = UnNormalize((0.5,), (0.2,))
    assert jax_to_spec(jax_from_spec(to_spec(u))) == to_spec(u)
    x = np.random.default_rng(4).uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(t(x), jax_from_spec(jax_to_spec(
        JaxNormalize((0.5, 0.4, 0.3), (0.2, 0.2, 0.1))))(x))


def test_psnr_matches_jax():
    rng = np.random.default_rng(5)
    preds = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2)]
    targets = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2)]
    jm, pm = JaxPSNR(), PSNR()
    js, ps = jm.init(), pm.init()
    for p, t in zip(preds, targets):
        js = jm.update(js, preds=jnp.asarray(p), target=jnp.asarray(t))
        ps = pm.update(ps, preds=torch.from_numpy(p), target=torch.from_numpy(t))
    _close(pm.compute(ps), jm.compute(js), 1e-4, "psnr")


# ---------------------------------------------------------------- loss, Adam


def test_loss_and_gradients_match_jax(setup):
    jm, variables, grad_fn, batches = setup
    key = _jax_prior_key(SEED, 0, 0)
    (loss, (logs, mutated)), grads = grad_fn(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        jnp.asarray(batches[0]), 0, key)
    pm = _port_model(variables)
    x = torch.from_numpy(batches[0])
    ploss, plogs, _ = pm.loss_fn({"samples": x, "target": x}, 0,
                                 noise=torch.from_numpy(_eps(key)))
    ploss.backward()
    # f32 on both sides through ~20 conv layers and 6 batch norms
    for name in logs:
        _close(plogs[name], logs[name], 1e-5 * max(1.0, abs(float(logs[name]))), name)
    pgrads = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in pm.net.named_parameters()})["params"])
    jgrads = _flat(grads)
    assert set(pgrads) == set(jgrads)
    noise, scale = _rounding_noise(jgrads)
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert 0 < n_noise < sum(m.size for m in noise.values()) // 100
    for path, want in jgrads.items():
        # real gradients: f32 through ~20 convs and 6 norms, 1e-4 of their
        # leaf's range; rounding noise around 0 on both sides: 1e-5 of the
        # largest gradient
        tol = np.where(noise[path], 1e-5 * scale, 1e-4 * np.abs(want).max())
        _close_masked(pgrads[path], want, tol, path)
    stats = _flat(state_dict_to_jax_variables(dict(pm.net.named_buffers()))["batch_stats"])
    for path, want in _flat(mutated["batch_stats"]).items():
        _close(stats[path], want, 1e-5 * max(1.0, np.abs(want).max()), path)


def test_adam_with_clipping_matches_optax_on_the_same_gradients():
    """Three steps of the port's optimizer and clip against optax's chain,
    fed identical gradients (half of them past the clip)."""
    rng = np.random.default_rng(6)
    params = [rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * s for p in params]
             for s in (0.1, 10.0, 1e-3)]
    from ot_vae_tpu_torch.models.base import clip_by_global_norm

    class Holder(VAE):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.net = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy()))
                                               for p in params])
            self.learning_rate = LR

    holder = Holder()
    opt = holder.optimizer()
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.inject_hyperparams(optax.adam)(learning_rate=LR, b1=0.9,
                                                            b2=0.999))
    jparams = [jnp.asarray(p) for p in params]
    jstate = jax.jit(jopt.init)(jparams)

    @jax.jit
    def jstep(g, state, p):
        updates, state = jopt.update(g, state, p)
        return optax.apply_updates(p, updates), state

    for g in grads:
        for p, gi in zip(holder.net, g):
            p.grad = torch.from_numpy(gi.copy())
        clip_by_global_norm([p.grad for p in holder.net], 1.0)
        opt.step()
        jparams, jstate = jstep([jnp.asarray(gi) for gi in g], jstate, jparams)
        for p, w in zip(holder.net, jparams):
            # the same f32 formula, rounded in another order: a few ulps of lr
            _close(p.detach(), w, 1e-6, "params")


# ---------------------------------------------------------------- trainer


def test_three_train_steps_match_the_jax_trainer(setup):
    """Losses per step, the first step's gradients (checked in
    test_loss_and_gradients_match_jax), running statistics and parameters
    after three steps of Adam at lr 1e-3 with the prior's warm-up over 2
    steps. ε of each step is the JAX trainer's draw."""
    jm, variables, grad_fn, batches = setup
    noise = None
    opt = jm.optimizer()

    @jax.jit
    def adam(grads, opt_state, params):  # trainer.py:191-192, jitted as there
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, mutable = variables["params"], {"batch_stats": variables["batch_stats"]}
    opt_state = jax.jit(opt.init)(params)
    pm = _port_model(variables)
    dm = BaseDatamodule(train_dataset=ArrayDataset(batches[0], np.zeros(BATCH, np.int32)))
    trainer = Trainer(device="cpu", seed=SEED)
    trainer.setup_fit(pm, dm)
    for step, images in enumerate(batches):
        key = _jax_prior_key(SEED, 0, step)
        # trainer.py:179-203: loss, grads, Adam, mutable collections
        (loss, (logs, mutated)), grads = grad_fn(params, mutable, jnp.asarray(images),
                                                 step, key)
        if noise is None:
            noise, _ = _rounding_noise(_flat(grads))
        params, opt_state = adam(grads, opt_state, params)
        mutable = {**mutable, **mutated}
        plogs, _ = trainer.train_step(pm, (images, np.zeros(BATCH, np.int32)),
                                      noise=_eps(key))
        for name in logs:  # f32 losses, as in the single-step test
            _close(plogs[name], logs[name], 1e-5 * max(1.0, abs(float(logs[name]))),
                   f"step {step} {name}")
    assert trainer.state.step == trainer.global_step == 3
    got = state_dict_to_jax_variables(pm.net.state_dict())
    want_params = _flat(params)
    for path, value in _flat(got["params"]).items():
        # Adam moves each parameter by about lr a step whatever the gradient's
        # size. A leaf with no gradient in exact arithmetic follows the sign
        # of its rounding noise, which differs between the two sides, so
        # three steps may part it by up to 2·lr each; every other parameter
        # follows a real gradient and agrees to 1e-5 (1% of one step)
        tol = np.where(noise[path], 6 * LR, 1e-5)
        _close_masked(value, want_params[path], tol, path)
    want_stats = _flat(mutable["batch_stats"])
    for path, value in _flat(got["batch_stats"]).items():
        # a running mean takes 0.1 of each batch mean, which includes the
        # drift of a constant that has no gradient: under 0.1·3·6·lr
        tol = 2e-3 if path.endswith("mean") else 1e-5 * max(1.0, np.abs(want_stats[path]).max())
        _close(value, want_stats[path], tol, path)


def test_datamodule_batches_match_jax(monkeypatch):
    """FFHQ128 on its seeded synthetic fallback: train batches of two epochs
    and the validation batches, element for element (JAX on its numpy
    batching path)."""
    monkeypatch.setenv("OT_VAE_NATIVE_LOADER", "0")
    kw = dict(root=("/nonexistent/train", "/nonexistent/test"), synthetic_train=12,
              synthetic_test=10, train_batch_size=4, val_batch_size=3, seed=7)
    jdm, pdm = JaxFFHQ128(**kw), FFHQ128(**kw)
    for epoch in (0, 1):
        jb, pb = list(jdm.train_batches(epoch)), list(pdm.train_batches(epoch))
        assert len(pb) == len(jb) == 3
        for (ji, jl), (pi, pl) in zip(jb, pb):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pl, jl)
    jv, pv = list(jdm.val_batches()), list(pdm.val_batches())
    assert len(pv) == len(jv) == 3
    for (ji, jl), (pi, pl) in zip(jv, pv):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
    assert pdm.steps_per_epoch("train") == jdm.steps_per_epoch("train")
    assert pi.shape == (3, 128, 128, 3)


class _Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def test_lr_plateau_sequence_matches_jax():
    """The same monitored values drive both plateaus to the same lr sequence."""
    values = [10.0, 10.05, 10.02, 11.0, 10.9, 10.95, 10.99, 11.05, 11.0]
    rates = []
    for trainer in (JaxTrainer(lr_patience=2, lr_factor=0.5, min_lr=2e-4),
                    Trainer(lr_patience=2, lr_factor=0.5, min_lr=2e-4, device="cpu")):
        trainer.monitor = "val/metrics/psnr"
        trainer._monitor_mode = "max"
        trainer._lr, trainer._plateau_best, trainer._plateau_count = 1e-3, None, 0
        if isinstance(trainer, Trainer):
            trainer.state = type("S", (), {"optimizer": torch.optim.Adam(
                [torch.nn.Parameter(torch.zeros(1))], lr=1e-3)})()
        else:
            trainer.state = type("S", (), {"opt_state": None,
                                           "replace": lambda self, **kw: self})()
        seq = []
        for v in values:
            trainer.logged_metrics["val/metrics/psnr"] = v
            trainer._maybe_reduce_lr()
            seq.append(trainer._lr)
        rates.append(seq)
        if isinstance(trainer, Trainer):
            assert trainer.state.optimizer.param_groups[0]["lr"] == seq[-1]
    assert rates[0] == rates[1]
    assert rates[1][-1] < 1e-3


def test_fit_checkpoint_serves_the_trained_model(tmp_path):
    """fit on the synthetic fallback, one validation with PSNR, the best
    checkpoint served by InferenceEngine(checkpoint_path=...): the same
    reconstructions as the in-memory model, with the datamodule's transforms."""
    torch.manual_seed(0)
    pm = VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior(**PRIOR),
             metrics=MetricCollection({"psnr": PSNR()}), ema_decay=0.9)
    dm = FFHQ128(root=(str(tmp_path / "none"), str(tmp_path / "none")), size=16,
                 synthetic_train=32, synthetic_test=16, train_batch_size=8,
                 val_batch_size=8, seed=0)
    ckpt = ModelCheckpointCallback(dirpath=str(tmp_path / "ckpt"))
    logger = _Recorder()
    trainer = Trainer(max_epochs=1, callbacks=[ckpt], logger=logger, log_every_n_steps=1,
                      device="cpu", seed=0).fit(pm, dm)
    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert np.isfinite(trainer.logged_metrics["val/metrics/psnr"])
    assert ckpt.best_path is not None

    torch.manual_seed(1)  # other random weights: everything must come from the file
    fresh = VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior(**PRIOR))
    served = InferenceEngine(fresh, checkpoint_path=ckpt.best_path, device="cpu")
    assert served.model.inference_preprocess == dm.inference_preprocess
    x = _images(3, 20)
    eps = np.random.default_rng(21).standard_normal((3, *LATENT)).astype(np.float32)
    np.testing.assert_array_equal(served.reconstruct(x, noise=eps),
                                  InferenceEngine(pm, device="cpu").reconstruct(x, noise=eps))
    ema_engine = InferenceEngine(VAE(CNN(**ENCODER), CNN(**DECODER), GaussianPrior(**PRIOR)),
                                 checkpoint_path=ckpt.best_path, use_ema=True, device="cpu")
    for name, p in ema_engine.model.net.named_parameters():
        assert torch.equal(p, trainer.state.ema_params[name])


def test_eval_outputs_encode_once(setup):
    """The eval step's preds and latents come from one encoder pass, with ε
    from their own generators: the same tensors as the full forward and a
    separate encode in eval mode (the JAX eval step's ``eval_forward`` and
    ``encode_fn``, which XLA computes from one encoder pass too)."""
    _, variables, _, _ = setup
    pm = _port_model(variables)
    x = torch.from_numpy(_images(BATCH, 30))
    calls = []
    pm.net.encoder.register_forward_hook(lambda *_: calls.append(1))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    preds, latents = pm.eval_outputs({"samples": x, "target": x, "kwargs": {}},
                                     gen(5), gen(6))
    assert len(calls) == 1
    with torch.no_grad():
        assert torch.equal(preds, pm.net(x, gen(5)))
        assert torch.equal(latents, pm.net.encode(x, gen(6)))
    assert not torch.equal(preds, pm.net.decode(latents))  # ε drawn twice


def test_state_dict_round_trips_through_the_jax_layout(setup):
    _, variables, _, _ = setup
    pm = _port_model(variables)
    state = pm.net.state_dict()
    back = jax_variables_to_state_dict(state_dict_to_jax_variables(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v)


def test_later_slices_raise():
    with pytest.raises(NotImplementedError, match="slice 9"):
        Trainer(accumulate_grad_batches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        Trainer(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        Trainer(profile_dir="x", device="cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        Trainer(device="cpu").fit(None, None, resume_from="x")
    with pytest.raises(NotImplementedError, match="slice 9"):
        VAE(CNN(**ENCODER), CNN(**DECODER), checkpoints={"encoder": object()})
    with pytest.raises(NotImplementedError, match="slice 9"):
        CNN(**ENCODER, dropout=0.1)
