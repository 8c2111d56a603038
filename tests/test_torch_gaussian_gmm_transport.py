"""The port's Gaussian and GMM latent transport against the JAX package's, on
the CPU: both operators' compute and transport from handed-across states,
the state converters and files, the LatentTransport hooks and six-panel
collage on a tiny AutoEncoder, list_to_collage, ProgressiveTransform on
batch_preprocess, and the callback on a conditional model.

JAX keys and torch generators draw different numbers, so both sides start
from the same carried-over state (initialised mixtures need no seeding
draw) and run the deterministic modes (argmax assignments, eq. 17's noiseless
operator); the collage's rows of draws are checked for shape only. Every
file goes under tmp_path, and the loggers here take the collage through
``log_image``, so nothing is written under collages/.

Tolerances, against the largest entry of the JAX result (at least 1):
F64_TOL in float64; F32_TOL in float32, where XLA and torch sum in other
orders (the polar path's 20 f32 iterations: ITER_F32_TOL); the restored
PSNR within PSNR_ATOL dB. The GMM coupling runs Sinkhorn at the operator's
reg of 1e-5 on costs scaled to [0, 1], so |Cr| reaches 1e5, where an f32
ulp is 0.008: its f32 plan and cost are held to SINKHORN_F32_TOL.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.data.progressive import PgCompose as JaxPgCompose
from ot_vae_tpu.data.progressive import PgTransform as JaxPgTransform
from ot_vae_tpu.data.progressive import ProgressiveTransform as JaxProgressiveTransform
from ot_vae_tpu.data.transforms import GaussianBlur as JaxGaussianBlur
from ot_vae_tpu.data.transforms import Normalize as JaxNormalize
from ot_vae_tpu.metrics import PSNR as JaxPSNR
from ot_vae_tpu.metrics import MetricCollection as JaxMetricCollection
from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import AutoEncoder as JaxAutoEncoder
from ot_vae_tpu.trainer.callbacks import list_to_collage as jax_list_to_collage
from ot_vae_tpu.transport import GaussianTransport as JaxGaussianTransport
from ot_vae_tpu.transport import GMMTransport as JaxGMMTransport
from ot_vae_tpu.transport import LatentTransport as JaxLatentTransport
from ot_vae_tpu_torch.convert import (
    discrete_transport_state,
    gaussian_transport_state,
    gmm_transport_state,
    load_jax_variables,
)
from ot_vae_tpu_torch.data import GaussianBlur, Normalize
from ot_vae_tpu_torch.data.progressive import PgCompose, PgTransform, ProgressiveTransform
from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import AutoEncoder
from ot_vae_tpu_torch.networks.vit import ViT
from ot_vae_tpu_torch.priors import ConditionalGaussianPrior
from ot_vae_tpu_torch.trainer import list_to_collage
from ot_vae_tpu_torch.transport import (
    DiscreteTransport,
    GaussianTransport,
    GMMTransport,
    LatentTransport,
)

F64_TOL = 1e-9
F32_TOL = 1e-4
ITER_F32_TOL = 5e-4
PSNR_ATOL = 1e-3
SINKHORN_F32_TOL = 1e-2
DTYPES = {"float64": (np.float64, torch.float64, F64_TOL),
          "float32": (np.float32, torch.float32, F32_TOL)}
# XLA's CPU optimisations off: each JAX program here runs once, so its
# compile time is all that counts
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
# a tiny AutoEncoder, 8² ↔ 4², latent 4 x 4 x 2
AE = dict(in_features=1, latent_features=2, in_resolution=8, latent_resolution=4,
          capacity=2, down_up_sample=True, residual="add")


def _jit(fn):
    """``jax.jit(fn)`` compiled with :data:`_FAST_COMPILE`, once per
    structure, array shapes and dtypes, and Python values of the arguments."""
    jitted, compiled = jax.jit(fn), {}

    def run(*args, **kwargs):
        leaves, tree = jax.tree_util.tree_flatten((args, kwargs))
        key = (tree, tuple((np.shape(x), np.result_type(x)) if hasattr(x, "shape") else x
                           for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args, **kwargs).compile(
                compiler_options=_FAST_COMPILE)
        return compiled[key](*args, **kwargs)
    return run


class _FastOperator:
    """A JAX transport operator whose compute, transport, update and sample
    run as :func:`_jit` programs (the JAX callback calls compute and sample
    eagerly, one compile per op)."""

    def __init__(self, operator):
        self._operator = operator
        self.compute = _jit(operator.compute)
        self._samplers = {}

    def sample(self, state, key, batch_size, source=True):
        if (batch_size, source) not in self._samplers:
            self._samplers[batch_size, source] = _jit(functools.partial(
                self._operator.sample, batch_size=batch_size, source=source))
        return self._samplers[batch_size, source](state, key)

    def __getattr__(self, name):
        return getattr(self._operator, name)


def _fast_callback(cb):
    """The JAX callback with its operator's programs from :func:`_jit`."""
    cb._jit_update = _jit(cb.operator.update)
    cb._jit_transport = _jit(cb.operator.transport)
    cb.operator = _FastOperator(cb.operator)
    return cb


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


def _numpy_state(state):
    """A JAX state (flax dataclasses) as nested mappings of numpy arrays."""
    if dataclasses.is_dataclass(state):
        return {f.name: _numpy_state(getattr(state, f.name)) for f in dataclasses.fields(state)}
    return None if state is None else np.asarray(state)


def _jax_state(template, arrays):
    """``template`` (a JAX state) with its leaves taken from nested arrays."""
    if dataclasses.is_dataclass(template):
        return template.replace(**{f.name: _jax_state(getattr(template, f.name), arrays[f.name])
                                   for f in dataclasses.fields(template)})
    return None if template is None else jnp.asarray(arrays, dtype=template.dtype)


def _gaussian_sums(rng, lead, n, d, scale, shift, diag, compensated, np_dtype):
    x = rng.standard_normal((*lead, n, d)) * scale + shift
    s2 = (x ** 2).sum(-2) if diag else np.swapaxes(x, -1, -2) @ x
    sums = {"n": np.full(lead, float(n)), "s1": x.sum(-2), "s2": s2,
            "c1": np.zeros((*lead, d)) if compensated else None,
            "c2": np.zeros_like(s2) if compensated else None}
    return {k: None if v is None else v.astype(np_dtype) for k, v in sums.items()}


def _gaussian_arrays(seed, lead, d, diag, compensated, np_dtype):
    """An unfitted GaussianTransportState: streaming sums of two clouds."""
    rng = np.random.default_rng(seed)
    op = (*lead, d) if diag else (*lead, d, d)
    return {"source": _gaussian_sums(rng, lead, 40, d, 1.0, 0.0, diag, compensated, np_dtype),
            "target": _gaussian_sums(rng, lead, 40, d, rng.uniform(0.5, 2.0, d), 1.0, diag,
                                     compensated, np_dtype),
            "mean_source": np.zeros((*lead, d), np_dtype),
            "mean_target": np.zeros((*lead, d), np_dtype),
            "T": np.zeros(op, np_dtype), "Cw": np.zeros(op, np_dtype), "fitted": False}


def _gmm_side(rng, lead, k, d, diag, shift, np_dtype):
    mean = rng.standard_normal((*lead, k, d)) * 2.0 + shift
    if diag:
        cov = rng.uniform(0.3, 1.5, (*lead, k, d))
    else:
        a = rng.standard_normal((*lead, k, d, 2 * d))
        cov = a @ np.swapaxes(a, -1, -2) / (2 * d) + 0.3 * np.eye(d)
    n_obs = rng.uniform(1.0, 4.0, (*lead, k))
    if diag:
        s2 = (cov + mean ** 2) * n_obs[..., None]
    else:
        s2 = (cov + mean[..., :, None] * mean[..., None, :]) * n_obs[..., None, None]
    side = dict(mean=mean, cov=cov, n_obs=n_obs, s1=mean * n_obs[..., None], s2=s2)
    return {**{k_: v.astype(np_dtype) for k_, v in side.items()}, "initialized": True}


def _gmm_arrays(seed, lead, k, d, diag, np_dtype):
    """An unfitted GMMTransportState: two initialised mixtures."""
    rng = np.random.default_rng(seed)
    return {"source": _gmm_side(rng, lead, k, d, diag, 0.0, np_dtype),
            "target": _gmm_side(rng, lead, k, d, diag, 1.0, np_dtype),
            "plan": np.zeros((*lead, k, k), np_dtype), "fitted": False}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("diag", [False, True])
def test_gaussian_transport_matches(dtype, diag):
    """compute (fit with shrinkage, W2, operators) and transport of a batch
    [L, B, D] under eigh and polar, and the stochastic operator under eigh."""
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    configs = [dict(method="eigh"), dict(method="polar"), dict(method="eigh", stochastic=True)]
    kw = dict(leading_shape=(2,), dim=5, diag=diag, pg_star=0.1)
    jops = [JaxGaussianTransport(**kw, **c, dtype=np_dtype) for c in configs]
    arrays = _gaussian_arrays(0, (2,), 5, diag, True, np_dtype)
    jstate = _jax_state(jops[0].init(), arrays)
    x = np.random.default_rng(1).standard_normal((2, 7, 5)).astype(np_dtype)

    @_jit
    def want(jstate, x):
        out = []
        for jop in jops:
            fitted, cost = jop.compute(jstate)
            out.append((fitted, cost, jop.transport(fitted, x)))
        return out

    for c, (jfitted, jcost, jmoved) in zip(configs, want(jstate, jnp.asarray(x))):
        op = GaussianTransport(**kw, **c, dtype=torch_dtype)
        case_tol = ITER_F32_TOL if (c["method"] == "polar" and dtype == "float32"
                                    and not diag) else tol
        fitted, cost = op.compute(gaussian_transport_state(arrays, op))
        for name in ("mean_source", "mean_target", "T", "Cw"):
            _close(getattr(fitted, name), getattr(jfitted, name), case_tol)
        _close(cost, jcost, case_tol)
        assert fitted.fitted
        _close(op.transport(fitted, torch.from_numpy(x)), jmoved, case_tol)
        draws = op.sample(fitted, torch.Generator().manual_seed(0), 3, source=False)
        assert draws.shape == (2, 3, 5) and bool(torch.isfinite(draws).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("diag", [False, True])
def test_gmm_transport_matches(dtype, diag):
    """compute (the mixtures from their buffers, the coupling by the plain
    Sinkhorn) and transport by "argmax", and by "barycenter" for diagonal
    components (the full barycenter is held in test_torch_ot_core.py)."""
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    types = ["argmax", "barycenter"] if diag else ["argmax"]
    kw = dict(leading_shape=(2,), dim=4, n_components=3, diag=diag, kmeans_iter=0)
    jops = [JaxGMMTransport(**kw, transport_type=t, dtype=np_dtype) for t in types]
    arrays = _gmm_arrays(2, (2,), 3, 4, diag, np_dtype)
    jstate = _jax_state(jops[0].init(jax.random.PRNGKey(0)), arrays)
    x = (np.random.default_rng(3).standard_normal((2, 6, 4)) * 2.0).astype(np_dtype)

    @_jit
    def want(jstate, x):
        fitted, cost = jops[0].compute(jstate)
        return fitted, cost, [jop.transport(fitted, x) for jop in jops]

    jfitted, jcost, jmoved = want(jstate, jnp.asarray(x))
    for t, jm in zip(types, jmoved):
        op = GMMTransport(**kw, transport_type=t, dtype=torch_dtype)
        fitted, cost = op.compute(gmm_transport_state(arrays, op))
        plan_tol = SINKHORN_F32_TOL if dtype == "float32" else tol
        _close(fitted.plan, jfitted.plan, plan_tol)
        for side in ("source", "target"):
            for name in ("mean", "cov", "n_obs", "s1", "s2"):
                _close(getattr(getattr(fitted, side), name),
                       getattr(getattr(jfitted, side), name), tol)
        _close(cost, jcost, plan_tol)
        _close(op.transport(fitted, torch.from_numpy(x)), jm, tol)
    draws = op.sample(fitted, torch.Generator().manual_seed(0), 5)
    assert draws.shape == (2, 5, 4) and bool(torch.isfinite(draws).all())
    with pytest.raises(ValueError, match="requires a generator"):
        GMMTransport(**kw, transport_type="sample").transport(fitted, torch.from_numpy(x))


def test_converters_check_structure():
    """The converters take the JAX layout, compensated or not; a leaf of
    another shape, a missing or an extra leaf raises."""
    jop = JaxGaussianTransport(dim=3, compensated=False)
    jstate = _numpy_state(jop.init())
    assert jstate["source"]["c1"] is None
    state = gaussian_transport_state(jstate, GaussianTransport(dim=3, compensated=False))
    assert state.source.c1 is None and state.T.shape == (3, 3)
    with pytest.raises(ValueError, match="do not match"):
        gaussian_transport_state(jstate, GaussianTransport(dim=3))  # needs c1, c2
    with pytest.raises(ValueError, match="has shape"):
        gaussian_transport_state(jstate, GaussianTransport(dim=4, compensated=False))
    gmm = _gmm_arrays(0, (), 3, 2, True, np.float32)
    assert gmm_transport_state(gmm, GMMTransport(dim=2, n_components=3)).source.initialized
    with pytest.raises(ValueError, match="has shape"):
        gmm_transport_state(gmm, GMMTransport(dim=2, n_components=4))


class _Logger:
    def __init__(self):
        self.images = []

    def log_metrics(self, metrics, step):
        pass

    def log_image(self, name, grid, step):
        self.images.append((name, np.asarray(grid)))


class _JaxTrainer:
    global_step, current_epoch = 0, 0

    def __init__(self, first_val_batch=None):
        self.logged_metrics, self.logger = {}, _Logger()
        self.first_val_batch = first_val_batch

    def print(self, *args):
        raise AssertionError(f"the JAX collage failed: {args}")


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
    """(JAX VAE around the tiny AutoEncoder, the port's VAE loaded from it)."""
    jm = JaxVAE(metrics=JaxMetricCollection({"psnr": JaxPSNR()}),
                autoencoder=JaxAutoEncoder(**AE), prior=None)
    batch = (jnp.zeros((2, 8, 8, 1), jnp.float32), jnp.zeros((2,), jnp.int32))
    shapes = jax.eval_shape(lambda key: jm.init_variables(key, batch), jax.random.PRNGKey(0))
    jm.variables = _random_variables(shapes, 0)
    pm = VAE(metrics=MetricCollection({"psnr": PSNR()}), autoencoder=AutoEncoder(**AE),
             prior=None)
    load_jax_variables(pm.net, jm.variables)
    jm.encode_fn, jm.decode_fn = _jit(jm.encode_fn), _jit(jm.decode_fn)
    return jm, pm.eval()


# the two gates' operators at the tiny latent: the whole tensor (D = 32) and
# each pixel's channel vector (D = 2, 3 diagonal components)
OPERATORS = {
    "gaussian": ((1, 2, 3), JaxGaussianTransport, GaussianTransport,
                 dict(diag=False, make_pd=True), gaussian_transport_state,
                 lambda: _gaussian_arrays(4, (), 32, False, True, np.float32)),
    "gmm": ((3,), JaxGMMTransport, GMMTransport,
            dict(diag=True, n_components=3, transport_type="argmax", kmeans_iter=0),
            gmm_transport_state, lambda: _gmm_arrays(5, (), 3, 2, True, np.float32)),
}


def _callbacks(size, operator, num_samples_to_log=0, **extra):
    dims, jax_cls, cls, kwargs, _, _ = OPERATORS[operator]
    common = dict(size=size, transport_dims=dims, common_operator=True,
                  num_samples_to_log=num_samples_to_log, operator_kwargs={**kwargs, **extra})
    return (_fast_callback(JaxLatentTransport(
                transport_operator=jax_cls, transformations=JaxGaussianBlur(3, sigma=1.0),
                **common)),
            LatentTransport(transport_operator=cls, transformations=GaussianBlur(3, sigma=1.0),
                            device="cpu", **common))


def _assert_states_close(state, jax_state, tol=F32_TOL):
    want = _numpy_state(jax_state)
    for name, value in state.to_arrays().items():
        side, _, leaf = name.partition(".")
        expected = want[side][leaf] if leaf else want[side]
        if value.dtype == bool:
            assert value == expected, name
        else:
            _close(value, expected, tol)


@pytest.mark.parametrize("operator", OPERATORS)
def test_latent_transport_hooks_and_collage_match(models, operator):
    """One validation epoch (even batch → target, odd → source, then the fit
    and the collage of 3 images) and one test epoch (blur, encode,
    transport, decode, PSNR), from the same carried-over state. The
    collage's rows 2–5 (degraded, reconstructed, transported, clean) agree;
    rows 1 and 6 are decoded draws."""
    jm, pm = models
    jcb, tcb = _callbacks(pm.latent_size, operator, num_samples_to_log=3)
    rng = np.random.default_rng(7)
    images = [rng.uniform(0, 1, (6, 8, 8, 1)).astype(np.float32) for _ in range(2)]
    first = (images[0], np.zeros(6, np.int32))
    jtr, ttr = _JaxTrainer(first), _TorchTrainer(first)
    jcb.on_fit_start(jtr, jm)
    tcb.on_fit_start(ttr, pm)
    convert, arrays = OPERATORS[operator][4], OPERATORS[operator][5]()
    tcb.state = convert(arrays, tcb.operator)
    jcb.state = _jax_state(jcb.state, arrays)
    for idx, x in enumerate(images):
        latents = jm.encode_fn(jm.variables, jnp.asarray(x))
        jcb.on_validation_batch_end(jtr, jm, {"samples": jnp.asarray(x), "latents": latents,
                                              "kwargs": {}}, None, idx)
        t_latents = pm.eval_encode(torch.from_numpy(x))
        tcb.on_validation_batch_end(ttr, pm, {"samples": torch.from_numpy(x),
                                              "latents": t_latents, "kwargs": {}}, None, idx)
    _assert_states_close(tcb.state, jcb.state)
    jcb.on_validation_epoch_end(jtr, jm)
    tcb.on_validation_epoch_end(ttr, pm)
    _assert_states_close(tcb.state, jcb.state)
    np.testing.assert_allclose(tcb._last_cost, jcb._last_cost,
                               rtol=SINKHORN_F32_TOL if operator == "gmm" else F32_TOL)
    (jname, jgrid), = jtr.logger.images
    (tname, tgrid), = ttr.logger.images
    assert tname == jname == tcb.logging_prefix_full
    assert tgrid.shape == jgrid.shape == (6 * 8, 3 * 8, 1) and np.isfinite(tgrid).all()
    _close(tgrid[8:40], jgrid[8:40], F32_TOL)
    for cb, tr, model in ((jcb, jtr, jm), (tcb, ttr, pm)):
        cb.on_test_epoch_start(tr, model)
    for idx, x in enumerate(images):
        jcb.on_test_batch_end(jtr, jm, {"samples": jnp.asarray(x), "kwargs": {}}, None, idx)
        tcb.on_test_batch_end(ttr, pm, {"samples": torch.from_numpy(x), "kwargs": {}}, None, idx)
    jcb.on_test_epoch_end(jtr, jm)
    tcb.on_test_epoch_end(ttr, pm)
    got, want = tcb.compute_test_metrics(), jcb.compute_test_metrics()
    key = tcb.logging_prefix_full + "psnr"
    assert set(got) == set(want) == {key}
    np.testing.assert_allclose(got[key], want[key], atol=PSNR_ATOL, rtol=0)


@pytest.mark.parametrize("operator", [*OPERATORS, "discrete"])
def test_state_files_round_trip(models, operator, tmp_path):
    """save_state → load_state transports bit for bit for the three
    operators; a file of another configuration fails loudly."""
    _, pm = models
    if operator == "discrete":
        kw = dict(n_components=4, kmeans_iter=0, sinkhorn_reg=0.05, sinkhorn_threshold=1e-4)

        def make(**extra):
            return LatentTransport(size=pm.latent_size, transport_dims=(1, 2),
                                   transport_operator=DiscreteTransport,
                                   transformations=GaussianBlur(3, sigma=1.0),
                                   common_operator=True, num_samples_to_log=0, device="cpu",
                                   operator_kwargs={**kw, **extra})
        cb = make()
        rng = np.random.default_rng(0)
        side = {"codebook": rng.standard_normal((4, 16)).astype(np.float32),
                "n_obs": np.ones(4, np.float32), "initialized": True}
        side["s1"] = side["codebook"].copy()
        state = discrete_transport_state({"source": side, "target": side,
                                          "plan": np.zeros((4, 4), np.float32),
                                          "fitted": False}, cb.operator)
        other = make(n_components=5)
    else:
        cb = _callbacks(pm.latent_size, operator)[1]
        state = OPERATORS[operator][4](OPERATORS[operator][5](), cb.operator)
        other = _callbacks(pm.latent_size, operator, **(
            {"compensated": False} if operator == "gaussian" else {"n_components": 4}))[1]
    cb.state, _ = cb.operator.compute(state)
    path = tmp_path / "operator.npz"
    cb.save_state(path)
    loaded = type(cb)(**{f.name: getattr(cb, f.name) for f in dataclasses.fields(cb)})
    loaded.load_state(path)
    z = torch.randn((5, *pm.latent_size), generator=torch.Generator().manual_seed(0))
    assert torch.equal(loaded.transport(z), cb.transport(z))
    for name, value in cb.state.to_arrays().items():
        np.testing.assert_array_equal(loaded.state.to_arrays()[name], value)
    with pytest.raises(ValueError, match="structure does not match"):
        other.load_state(path)


def test_list_to_collage_matches():
    rng = np.random.default_rng(8)
    images = [rng.uniform(0, 1, (5, 4, 3, 2)).astype(np.float32) for _ in range(6)]
    got = list_to_collage(images, 3)
    assert got.shape == (24, 9, 2)
    np.testing.assert_array_equal(got, jax_list_to_collage(images, 3))


def test_collage_writes_a_png_without_log_image(models, tmp_path, monkeypatch):
    """Without a logger's ``log_image`` the collage goes to
    collages/<prefix>epoch<N>.png in the working directory."""
    _, pm = models
    cb = _callbacks(pm.latent_size, "gaussian", num_samples_to_log=2)[1]
    cb.state, _ = cb.operator.compute(gaussian_transport_state(OPERATORS["gaussian"][5](),
                                                               cb.operator))
    trainer = _TorchTrainer((np.random.default_rng(9).uniform(0, 1, (3, 8, 8, 1)),
                             np.zeros(3, np.int32)))
    trainer.logger = type("NoImages", (), {"log_metrics": lambda self, m, s: None})()
    trainer.current_epoch = 2
    monkeypatch.chdir(tmp_path)
    cb._log_images(trainer, pm)
    assert (tmp_path / "collages" / "transport_gaussian_epoch2.png").is_file()


def test_progressive_transform_on_batch_preprocess(models):
    """The curriculum's transform of each epoch (the schedule's last entry
    past its end) on training batches, and none in evaluation."""
    jm, pm = models
    schedule = [(3, 1.0), (3, 0.5)]
    x = np.random.default_rng(10).uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    batch = (x, np.zeros(2, np.int32))
    tbatch = tuple(map(torch.from_numpy, batch))
    for jschedule, schedule_ in (
            (JaxPgTransform(JaxGaussianBlur, schedule), PgTransform(GaussianBlur, schedule)),
            (JaxPgCompose([JaxPgTransform(JaxGaussianBlur, schedule),
                           JaxPgTransform(JaxNormalize, [((0.5,), (0.25,))])]),
             PgCompose([PgTransform(GaussianBlur, schedule),
                        PgTransform(Normalize, [((0.5,), (0.25,))])]))):
        for epoch in (0, 1, 5):
            trainer = _JaxTrainer()
            trainer.current_epoch = epoch
            JaxProgressiveTransform(jschedule).on_train_epoch_start(trainer, jm)
            ProgressiveTransform(schedule_).on_train_epoch_start(trainer, pm)
            want = jm.batch_preprocess(batch, jax.random.PRNGKey(0), train=True)
            got = pm.batch_preprocess(tbatch, train=True,
                                      generator=torch.Generator().manual_seed(0))
            _close(got["samples"], want["samples"], F32_TOL)
            _close(got["target"], want["target"], F32_TOL)
            assert not np.allclose(got["samples"].numpy(), x)
            assert torch.equal(pm.batch_preprocess(tbatch, train=False)["samples"], tbatch[0])
    jm.progressive_transform = pm.progressive_transform = None


def test_latent_transport_routes_labels_to_a_conditional_model():
    """A conditional model's encoder and decoder get each batch's labels
    from ``kwargs`` in the callback's encodes and decodes: the restored
    PSNR is that of blur → encode → transport → decode with the labels."""
    vit = dict(image_size=8, patch_size=4, dim=16, depth=1, heads=2, channels=1, num_classes=3,
               dropout=0.0)
    torch.manual_seed(0)
    model = VAE(ViT(**vit, n_embed_tokens=2, output_tokens="embed", patch_to_embed=True,
                    embed_to_patch=False),
                ViT(**vit, n_embed_tokens=None, n_input_tokens=1, output_tokens="embed",
                    patch_to_embed=False, embed_to_patch=True),
                ConditionalGaussianPrior(dim=(1, 16), num_classes=3, reparam_dim=-2),
                metrics=MetricCollection({"psnr": PSNR()}), conditional=True).eval()
    cb = LatentTransport(size=model.latent_size, transport_dims=(2,),
                         transport_operator=GaussianTransport,
                         transformations=GaussianBlur(3, sigma=1.0), common_operator=True,
                         num_samples_to_log=2, device="cpu",
                         operator_kwargs=dict(diag=False, make_pd=True))
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 1, (6, 8, 8, 1)).astype(np.float32)
    labels = np.array([0, 1, 2, 0, 1, 2])
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    trainer = _TorchTrainer((images, labels))
    cb.on_fit_start(trainer, model)
    cb.on_validation_epoch_start(trainer, model)
    for idx in range(4):
        outputs = {"samples": x, "kwargs": {"labels": y}}
        cb.on_validation_batch_end(trainer, model, outputs, None, idx)
    cb.on_validation_epoch_end(trainer, model)
    assert trainer.logger.images[0][1].shape == (6 * 8, 2 * 8, 1)
    cb._generator = None  # the test epoch's draws from a fresh stream
    cb.on_test_epoch_start(trainer, model)
    cb.on_test_batch_end(trainer, model, {"samples": x, "kwargs": {"labels": y}}, None, 0)
    got = cb.compute_test_metrics()["transport/gaussian/psnr"]
    g = torch.Generator().manual_seed(cb.seed)
    z = model.eval_encode(GaussianBlur(3, sigma=1.0)(x), g, labels=y)
    restored = model.eval_decode(cb.transport(z, g), labels=y)
    metrics = model.test_metrics.clone("")
    want = metrics.compute(metrics.update(metrics.init("cpu"), preds=restored, target=x))
    np.testing.assert_allclose(got, float(want["psnr"]), atol=PSNR_ATOL, rtol=0)
