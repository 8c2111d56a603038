"""The port's discrete latent transport against the JAX package's, on the
CPU: CodebookModel, DiscreteTransport, the LatentTransport hooks on a tiny
AutoEncoder, the state files, and InferenceEngine.restore.

JAX keys and torch generators draw different numbers, so both sides start
from the same carried-over state (initialised codebooks need no seeding
draw) and run the deterministic modes ("mean" training assignments, "mean"
transport, argmax inference assignments). Every JAX LatentTransport here
logs no collage (num_samples_to_log=0) and files go under tmp_path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.data.transforms import GaussianBlur as JaxGaussianBlur
from ot_vae_tpu.data.transforms import Normalize as JaxNormalize
from ot_vae_tpu.data.transforms import UnNormalize as JaxUnNormalize
from ot_vae_tpu.distributions.codebook import CodebookModel as JaxCodebookModel
from ot_vae_tpu.distributions.codebook import CodebookState as JaxCodebookState
from ot_vae_tpu.metrics import PSNR as JaxPSNR
from ot_vae_tpu.metrics import MetricCollection as JaxMetricCollection
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import AutoEncoder as JaxAutoEncoder
from ot_vae_tpu.serving import InferenceEngine as JaxEngine
from ot_vae_tpu.transport import DiscreteTransport as JaxDiscreteTransport
from ot_vae_tpu.transport import DiscreteTransportState as JaxDiscreteTransportState
from ot_vae_tpu.transport import LatentTransport as JaxLatentTransport
from ot_vae_tpu_torch.convert import discrete_transport_state, load_jax_variables
from ot_vae_tpu_torch.data import GaussianBlur, Normalize, UnNormalize
from ot_vae_tpu_torch.distributions import CodebookModel, CodebookState
from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import AutoEncoder
from ot_vae_tpu_torch.serving import InferenceEngine
from ot_vae_tpu_torch.transport import DiscreteTransport, LatentTransport

K, D = 8, 16
# f32 on both sides: codebook sums and small matrix products in another
# order, measured below 1e-6; held at 1e-5 of the largest entry
TOL = 1e-5
# a well-conditioned Sinkhorn for entry-by-entry checks (costs of a few
# units, so |Cr| stays near 100 and f32 keeps six digits)
WELL = dict(sinkhorn_reg=0.05, sinkhorn_threshold=1e-4)
OPERATOR = dict(n_components=K, transport_type="mean", training_mode="mean",
                temperature=1e-2, kmeans_iter=0)
# a tiny AutoEncoder, 8² ↔ 4², latent 4 x 4 x 2; transport_dims (1, 2) makes
# each channel's 4 x 4 map (D = 16) one sample
AE = dict(in_features=1, latent_features=2, in_resolution=8, latent_resolution=4,
          capacity=2, down_up_sample=True, residual="add")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


def _codebook_arrays(seed, k=K, d=D, lead=()):
    rng = np.random.default_rng(seed)
    codebook = rng.standard_normal((*lead, k, d)).astype(np.float32)
    n_obs = rng.uniform(1.0, 5.0, (*lead, k)).astype(np.float32)
    return {"codebook": codebook, "n_obs": n_obs,
            "s1": (codebook * n_obs[..., None]).astype(np.float32), "initialized": True}


def _jax_codebook(arrays):
    return JaxCodebookState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _torch_codebook(arrays):
    return CodebookState(**{k: v if k == "initialized" else torch.from_numpy(v)
                            for k, v in arrays.items()})


def _assert_codebooks_close(got, want):
    for name in ("codebook", "n_obs", "s1"):
        _close(getattr(got, name).numpy(), getattr(want, name))
    assert got.initialized == bool(want.initialized)


@pytest.mark.parametrize("mode", ["mean", "argmax"])
def test_codebook_update_fit_assign_match(mode):
    cfg = dict(leading_shape=(2,), dim=D, n_components=K, temperature=0.5,
               training_mode=mode, inference_mode="argmax", kmeans_iter=2)
    jm, tm = JaxCodebookModel(**cfg), CodebookModel(**cfg)
    arrays = _codebook_arrays(0, lead=(2,))
    samples = np.random.default_rng(1).standard_normal((2, 24, D)).astype(np.float32)
    x = torch.from_numpy(samples)

    @jax.jit  # one JAX compile for the whole chain
    def jax_chain(state, xs):
        assignment = jm.assign(state.codebook, xs, training=False)
        updated = jm.update(state, xs, jax.random.PRNGKey(0))
        return (assignment, updated, jm.fit(updated),
                jm.fit(updated, xs, jax.random.PRNGKey(1)), jm.weights(updated))

    want, want_updated, want_final, want_refit, want_weights = jax_chain(
        _jax_codebook(arrays), jnp.asarray(samples))
    got = tm.assign(_torch_codebook(arrays).codebook, x, training=False)
    _close(got.probs, want.probs)
    _close(got.weights, want.weights)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))

    gen = torch.Generator().manual_seed(0)
    updated = tm.update(_torch_codebook(arrays), x, gen)
    _assert_codebooks_close(updated, want_updated)
    _assert_codebooks_close(tm.fit(updated), want_final)
    _assert_codebooks_close(tm.fit(updated, x, gen), want_refit)
    _close(tm.weights(updated), want_weights)


@pytest.mark.parametrize("metric,p,topk", [("euclidean", 1.0, None), ("cosine", 2.0, None),
                                            ("euclidean", 2.0, 3)])
def test_codebook_energy_variants_match(metric, p, topk):
    """The energies and assignments the gate does not use: euclidean with
    p ≠ 2, cosine, top-k masking."""
    cfg = dict(dim=D, n_components=K, metric=metric, p=p, topk=topk, temperature=0.5,
               inference_mode="argmax")
    codebook = _codebook_arrays(11)["codebook"]
    samples = np.random.default_rng(12).standard_normal((10, D)).astype(np.float32)
    want = JaxCodebookModel(**cfg).assign(jnp.asarray(codebook), jnp.asarray(samples),
                                          training=False)
    got = CodebookModel(**cfg).assign(torch.from_numpy(codebook), torch.from_numpy(samples),
                                      training=False)
    _close(got.probs, want.probs)
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))


def _operator_pair(**extra):
    cfg = dict(OPERATOR, dim=D, **extra)
    return JaxDiscreteTransport(**cfg), DiscreteTransport(**cfg)


def _state_arrays(seed):
    """A transport state as the converter takes it: two initialised
    codebooks (the target spread wider), an empty plan, not fitted."""
    target = _codebook_arrays(seed + 1)
    target["codebook"] *= 1.5
    target["s1"] *= 1.5
    return {"source": _codebook_arrays(seed), "target": target,
            "plan": np.zeros((K, K), np.float32), "fitted": False}


def _jax_state(arrays):
    return JaxDiscreteTransportState(
        source=_jax_codebook(arrays["source"]), target=_jax_codebook(arrays["target"]),
        plan=jnp.asarray(arrays["plan"]), fitted=jnp.asarray(arrays["fitted"]))


def _numpy_state(state):
    """A JAX DiscreteTransportState as nested numpy arrays."""
    def side(s):
        return {f: np.asarray(getattr(s, f)) for f in ("codebook", "n_obs", "s1", "initialized")}
    return {"source": side(state.source), "target": side(state.target),
            "plan": np.asarray(state.plan), "fitted": np.asarray(state.fitted)}


def test_discrete_compute_and_transport_match():
    """compute (fit from the streaming sums, cost, Sinkhorn) and the three
    transport types, at a well-conditioned reg entry by entry."""
    jop, top = _operator_pair(**WELL)
    arrays = _state_arrays(2)
    want_state, want_cost = jax.jit(jop.compute)(_jax_state(arrays))
    state, cost = top.compute(discrete_transport_state(arrays, top))
    _close(state.plan, want_state.plan)
    _close(cost, want_cost)
    _assert_codebooks_close(state.source, want_state.source)
    assert state.fitted and bool(want_state.fitted)
    inputs = np.random.default_rng(3).standard_normal((20, D)).astype(np.float32)
    for kind in ("mean", "argmax"):
        jop_k, top_k = _operator_pair(**WELL, transport_type=kind)
        _close(top_k.transport(state, torch.from_numpy(inputs)),
               jop_k.transport(want_state, jnp.asarray(inputs), jax.random.PRNGKey(0)))
    _, top_s = _operator_pair(**WELL, transport_type="sample")
    drawn = top_s.transport(state, torch.from_numpy(inputs), torch.Generator().manual_seed(0))
    # each draw is one target atom
    dist = torch.cdist(drawn, state.target.codebook).min(dim=-1).values
    assert drawn.shape == (20, D) and float(dist.max()) < 1e-5


def test_compute_and_transport_at_the_path_reg():
    """At the path's Sinkhorn settings (reg 1e-5, 1000 iterations, threshold
    1e-6), where |Cr| reaches 5e5 and an f32 ulp of the exponent is 0.03.

    - A JAX-fitted operator carried across as numpy arrays transports the
      same latents as the JAX package: inference assignments are argmax, so
      each output is a normalised row of plan @ target codebook, the same f32
      arithmetic, within 1e-5.
    - The port's own fit from the same codebooks, against the JAX fit
      compiled as the JAX callback compiles it. XLA fuses the iteration and
      rounds other sums, which at this reg moves plan entries by up to 3%
      of the largest (measured 2.0% to 3.0% over four seeds; eager JAX
      matched the port to 1e-7). So the transport cost is held at 3e-2
      relative (measured up to 1.2e-2), the transported latents at 3e-2 of
      the largest (measured up to 6.9e-3), and the plan's distance from the
      marginals to 1.25 times the JAX plan's, plus 1e-3."""
    jop, top = _operator_pair()
    arrays = _state_arrays(4)
    fitted, want_cost = jax.jit(jop.compute)(_jax_state(arrays))
    state = discrete_transport_state(_numpy_state(fitted), top)
    np.testing.assert_array_equal(state.plan.numpy(), np.asarray(fitted.plan))
    inputs = np.random.default_rng(5).standard_normal((20, D)).astype(np.float32)
    want = jop.transport(fitted, jnp.asarray(inputs), jax.random.PRNGKey(0))
    _close(top.transport(state, torch.from_numpy(inputs)), want)
    own, cost = top.compute(discrete_transport_state(arrays, top))
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=3e-2)
    _close(top.transport(own, torch.from_numpy(inputs)), want, tol=3e-2)
    model = jop.source_model
    for axis, side in ((1, fitted.source), (0, fitted.target)):
        weights = np.asarray(model.weights(side))
        err = np.abs(own.plan.numpy().sum(axis) - weights).max()
        err_jax = np.abs(np.asarray(fitted.plan).sum(axis) - weights).max()
        assert err <= 1.25 * err_jax + 1e-3, (axis, err, err_jax)


class _Logger:
    def log_metrics(self, metrics, step):
        pass


class _JaxTrainer:
    logged_metrics, global_step, first_val_batch, logger = {}, 0, None, _Logger()

    def print(self, *args):
        pass


class _TorchTrainer(_JaxTrainer):
    device = torch.device("cpu")


def _random_variables(shapes, seed):
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


@pytest.fixture(scope="module")
def models():
    """(JAX VAE around the tiny AutoEncoder, the port's VAE loaded from it),
    both with the (0.5, 0.25) inference transforms."""
    jm = JaxVAE(metrics=JaxMetricCollection({"psnr": JaxPSNR()}),
                autoencoder=JaxAutoEncoder(**AE), prior=None)
    batch = (jnp.zeros((2, 8, 8, 1), jnp.float32), jnp.zeros((2,), jnp.int32))
    shapes = jax.eval_shape(lambda key: jm.init_variables(key, batch), jax.random.PRNGKey(0))
    jm.variables = _random_variables(shapes, 0)
    jm.inference_preprocess = JaxNormalize((0.5,), (0.25,))
    jm.inference_postprocess = JaxUnNormalize((0.5,), (0.25,))
    pm = VAE(metrics=MetricCollection({"psnr": PSNR()}), autoencoder=AutoEncoder(**AE),
             prior=None)
    load_jax_variables(pm.net, jm.variables)
    # the JAX callback calls these eagerly; one compile each instead
    jm.encode_fn, jm.decode_fn = jax.jit(jm.encode_fn), jax.jit(jm.decode_fn)
    pm.inference_preprocess = Normalize((0.5,), (0.25,))
    pm.inference_postprocess = UnNormalize((0.5,), (0.25,))
    return jm, pm.eval()


def _callbacks(size, **operator):
    common = dict(size=size, transport_dims=(1, 2), common_operator=True,
                  num_samples_to_log=0, operator_kwargs=dict(OPERATOR, **operator))
    return (JaxLatentTransport(transport_operator=JaxDiscreteTransport,
                               transformations=JaxGaussianBlur(3, sigma=1.0), **common),
            LatentTransport(transport_operator=DiscreteTransport,
                            transformations=GaussianBlur(3, sigma=1.0), device="cpu", **common))


def test_latent_transport_hooks_match(models):
    """One validation epoch (even batch → target, odd → source, then the
    fit) and one test epoch (blur, encode, transport, decode, PSNR), from
    the same carried-over state."""
    jm, pm = models
    jcb, tcb = _callbacks(pm.latent_size, **WELL)
    jtr, ttr = _JaxTrainer(), _TorchTrainer()
    jcb.on_fit_start(jtr, jm)
    tcb.on_fit_start(ttr, pm)
    arrays = {**_state_arrays(6), "plan": np.zeros((K, K), np.float32)}
    jcb.state, tcb.state = _jax_state(arrays), discrete_transport_state(arrays, tcb.operator)
    rng = np.random.default_rng(7)
    images = [rng.uniform(0, 1, (6, 8, 8, 1)).astype(np.float32) for _ in range(2)]
    for idx, x in enumerate(images):
        latents = jm.encode_fn(jm.variables, jnp.asarray(x))
        jcb.on_validation_batch_end(jtr, jm, {"samples": jnp.asarray(x), "latents": latents,
                                              "kwargs": {}}, None, idx)
        with torch.no_grad():
            t_latents = pm.eval_encode(torch.from_numpy(x))
        tcb.on_validation_batch_end(ttr, pm, {"samples": torch.from_numpy(x),
                                              "latents": t_latents, "kwargs": {}}, None, idx)
    for side in ("source", "target"):
        _assert_codebooks_close(getattr(tcb.state, side), getattr(jcb.state, side))
    jcb.on_validation_epoch_end(jtr, jm)
    tcb.on_validation_epoch_end(ttr, pm)
    _close(tcb.state.plan, jcb.state.plan)
    np.testing.assert_allclose(tcb._last_cost, jcb._last_cost, rtol=1e-5)
    for cb, tr, model in ((jcb, jtr, jm), (tcb, ttr, pm)):
        cb.on_test_epoch_start(tr, model)
    for idx, x in enumerate(images):
        jcb.on_test_batch_end(jtr, jm, {"samples": jnp.asarray(x), "kwargs": {}}, None, idx)
        tcb.on_test_batch_end(ttr, pm, {"samples": torch.from_numpy(x), "kwargs": {}}, None, idx)
    jcb.on_test_epoch_end(jtr, jm)
    tcb.on_test_epoch_end(ttr, pm)
    got, want = tcb.compute_test_metrics(), jcb.compute_test_metrics()
    assert set(got) == set(want) == {"transport/discrete/psnr"}
    np.testing.assert_allclose(got["transport/discrete/psnr"], want["transport/discrete/psnr"],
                               atol=1e-3, rtol=0)


def test_state_file_round_trip(models, tmp_path):
    """save_state → load_state transports bit for bit; a file of another
    configuration (16 atoms) fails loudly."""
    _, pm = models
    _, cb = _callbacks(pm.latent_size, **WELL)
    cb.state, _ = cb.operator.compute(discrete_transport_state(_state_arrays(8), cb.operator))
    path = tmp_path / "operator.npz"
    cb.save_state(path)
    _, loaded = _callbacks(pm.latent_size, **WELL)
    loaded.load_state(path)
    z = torch.randn((5, *pm.latent_size), generator=torch.Generator().manual_seed(0))
    assert torch.equal(loaded.transport(z), cb.transport(z))
    _, other = _callbacks(pm.latent_size, n_components=16)
    with pytest.raises(ValueError, match="structure does not match"):
        other.load_state(path)


def test_restore_matches_jax(models):
    """InferenceEngine.restore of raw images through a fitted operator
    carried over from JAX, against the JAX engine's restore: bucket padding,
    transforms, encode, transport, decode; f32 within 1e-4."""
    jm, pm = models
    jcb, tcb = _callbacks(pm.latent_size, **WELL)
    jcb.state, _ = jcb.operator.compute(_jax_state(_state_arrays(9)))
    tcb.state = discrete_transport_state(_numpy_state(jcb.state), tcb.operator)
    images = np.random.default_rng(10).uniform(0, 1, (3, 8, 8, 1)).astype(np.float32)
    want = JaxEngine(jm, batch_sizes=(4,)).restore(images, jcb, jax.random.PRNGKey(0))
    engine = InferenceEngine(pm, batch_sizes=(4,), device="cpu")
    got = engine.restore(images, tcb, torch.Generator().manual_seed(0))
    _close(got, want, tol=1e-4)
    with pytest.raises(ValueError, match="no fitted state"):
        engine.restore(images, _callbacks(pm.latent_size)[1])
