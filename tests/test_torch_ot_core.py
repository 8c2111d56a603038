"""The port's OT core against the JAX package's, on the CPU: the matrix
functions (ops/matrix.py), the W2 functions and transport operators
(ops/w2.py), the value checks (ops/validate.py) and the Gaussian and GMM
distribution models, on the same numpy-seeded inputs in float64 and float32.

Tolerances, each against the largest entry of the JAX result (at least 1):
- float64 (LAPACK's eigh on both sides, the same iterations): F64_TOL;
- float32: F32_TOL for the eigh and matmul paths, whose sums XLA and torch
  order differently; the Newton–Schulz and polar iterations run 30 and 20
  steps of f32 products and are held to ITER_F32_TOL.
JAX keys and torch generators draw different numbers, so draws are handed
across (ε of a sample) or avoided (deterministic assignment modes, states
already initialised). Each test compiles its JAX calls into one program
(:func:`_jit`): one compile instead of one per eager op.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.distributions.gaussian import GaussianModel as JaxGaussianModel
from ot_vae_tpu.distributions.gaussian import GaussianParams as JaxGaussianParams
from ot_vae_tpu.distributions.gmm import GMMModel as JaxGMMModel
from ot_vae_tpu.distributions.gmm import GMMState as JaxGMMState
from ot_vae_tpu.ops import matrix as jm
from ot_vae_tpu.ops import validate as jv
from ot_vae_tpu.ops import w2 as jw
from ot_vae_tpu_torch.distributions import (
    GaussianModel,
    GaussianParams,
    GMMModel,
    GMMState,
)
from ot_vae_tpu_torch.ops import matrix as pm
from ot_vae_tpu_torch.ops import validate as pv
from ot_vae_tpu_torch.ops import w2 as pw

# XLA's CPU optimisations off: each JAX program here runs once, so its
# compile time is all that counts (measured 2.1 s -> 0.5 s for the W2 calls)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _jit(fn):
    """``jax.jit(fn)``, compiled with :data:`_FAST_COMPILE` at each call."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(compiler_options=_FAST_COMPILE)(*args)
    return run


F64_TOL = 1e-9
F32_TOL = 1e-4
ITER_F32_TOL = 5e-4
DTYPES = {"float64": (np.float64, torch.float64, F64_TOL),
          "float32": (np.float32, torch.float32, F32_TOL)}


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


def _spd(rng, lead, d, np_dtype, ridge=0.1):
    """SPD matrices X·Xᵀ/(2d) + ridge·I [*lead, d, d]."""
    x = rng.standard_normal((*lead, d, 2 * d))
    return (x @ np.swapaxes(x, -1, -2) / (2 * d) + ridge * np.eye(d)).astype(np_dtype)


def _pair(a):
    """(JAX array, torch tensor) of one numpy array."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["eigh", "ns"])
def test_roots_match(dtype, method):
    np_dtype, _, tol = DTYPES[dtype]
    if method == "ns" and dtype == "float32":
        tol = ITER_F32_TOL
    a = _spd(np.random.default_rng(0), (3,), 8, np_dtype)
    ja, ta = _pair(a)

    @_jit
    def want(a):
        return (jm.sqrtm(a, method), jm.invsqrtm(a, method), *jm.sqrtm_and_invsqrtm(a, method),
                jm.sqrtm_ns(a), jm.invsqrtm_ns(a), jm.sqrtm(a, "eigh"))

    got = (pm.sqrtm(ta, method), pm.invsqrtm(ta, method), *pm.sqrtm_and_invsqrtm(ta, method),
           pm.sqrtm_ns(ta), pm.invsqrtm_ns(ta))
    want = want(ja)
    for g, w in zip(got, want):
        _close(g, w, tol)
    # "auto" is eigh off the TPU, in both packages
    _close(pm.sqrtm(ta, "auto"), want[-1], DTYPES[dtype][2])
    with pytest.raises(ValueError, match="unknown sqrtm method"):
        pm.sqrtm(ta, "polar")


@pytest.mark.parametrize("dtype", DTYPES)
def test_polar_psd_and_checks_match(dtype):
    np_dtype, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    m = rng.standard_normal((2, 6, 6)).astype(np_dtype)
    sym = (m + np.swapaxes(m, -1, -2)).astype(np_dtype)  # indefinite
    jmat, tmat = _pair(m)
    jsym, tsym = _pair(sym)
    iter_tol = tol if dtype == "float64" else ITER_F32_TOL
    var = rng.standard_normal((3, 5)).astype(np_dtype)
    cases = [(method, strict) for method in ("eigh", "polar") for strict in (False, True)]

    @_jit
    def want(m, sym, var):
        return (jm.polar(m), jm.psd_projection(sym), jm.make_psd(var, diag=True),
                jm.min_eig(sym), [jm.make_psd(sym, strict=strict, return_correction=True,
                                              method=method) for method, strict in cases])

    polar, proj, var_psd, min_eig, shifted = want(jmat, jsym, jnp.asarray(var))
    _close(pm.polar(tmat), polar, iter_tol)
    _close(pm.psd_projection(tsym), proj, iter_tol)
    for (method, strict), pair in zip(cases, shifted):
        got = pm.make_psd(tsym, strict=strict, return_correction=True, method=method)
        for g, w in zip(got, pair):
            _close(g, w, tol if method == "eigh" else iter_tol)
    _close(pm.make_psd(torch.from_numpy(var), diag=True), var_psd, tol)
    _close(pm.min_eig(tsym), min_eig, tol)
    spd = _spd(rng, (2,), 6, np_dtype)
    both = np.stack([spd[0], sym[0]])
    assert pm.is_spd(torch.from_numpy(both)).tolist() == np.asarray(
        jm.is_spd(jnp.asarray(both))).tolist() == [True, False]
    assert pm.is_symmetric(tmat).tolist() == np.asarray(jm.is_symmetric(jmat)).tolist()
    with pytest.raises(ValueError, match="polar expects square"):
        pm.polar(torch.zeros(3, 4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("diag", [False, True])
def test_mean_cov_matches(dtype, diag):
    np_dtype, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 5)).astype(np_dtype)
    s1 = x.sum(-2)
    s2 = (x ** 2).sum(-2) if diag else np.swapaxes(x, -1, -2) @ x
    n = np.array([40.0, 40.0], np_dtype)
    for got, want in zip(pm.mean_cov(*map(torch.from_numpy, (s1, s2, n)), diag=diag),
                         jm.mean_cov(*map(jnp.asarray, (s1, s2, n)), diag=diag)):
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_validate_matches(dtype):
    np_dtype, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    m = rng.standard_normal((3, 5, 5)).astype(np_dtype)
    p = np.array([[0.2, 0.8], [0.5, 0.6], [-0.1, 1.1]], np_dtype)
    jmat, tmat = _pair(m)

    @_jit
    def want(m, p):
        return (jv.check_spd(m), jv.sanitize_spd(m)[0], jv.check_prob(p),
                jv.sanitize_prob(p))

    diagnostics, fixed, prob_ok, prob = want(jmat, jnp.asarray(p))
    for got, want_ in zip(pv.check_spd(tmat), diagnostics):
        _close(got, want_, tol)
    got_fixed, got_diags = pv.sanitize_spd(tmat)
    _close(got_fixed, fixed, tol)
    assert bool(got_diags.all_pd) is False
    assert pv.check_prob(torch.from_numpy(p)).tolist() == np.asarray(prob_ok).tolist()
    _close(pv.sanitize_prob(torch.from_numpy(p)), prob, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["eigh", "polar"])
def test_w2_functions_match(dtype, method):
    np_dtype, _, tol = DTYPES[dtype]
    if method == "polar" and dtype == "float32":
        tol = ITER_F32_TOL
    rng = np.random.default_rng(4)
    ms, mt = (rng.standard_normal((2, 3, 6)).astype(np_dtype) for _ in range(2))
    cs, ct = _spd(rng, (2, 3), 6, np_dtype), _spd(rng, (2, 4), 6, np_dtype)
    mt = np.concatenate([mt, ms[:, :1]], 1)
    vs, vt = (rng.uniform(0.1, 2.0, s).astype(np_dtype) for s in ((2, 3, 6), (2, 4, 6)))
    ws = rng.dirichlet(np.ones(3), 2).astype(np_dtype)
    wt = rng.dirichlet(np.ones(4), 2).astype(np_dtype)
    sinkhorn = dict(reg=0.05, max_iter=200, threshold=1e-6)

    def calls(w2, ms, mt, cs, ct, vs, vt, ws, wt):
        """Every W2 function of one package (``w2``) on the same inputs."""
        return [*(w2.w2_gaussian(ms, mt[:, :3], cs, ct[:, :3], make_pd=make_pd, method=method)
                  for make_pd in (False, True)),
                w2.bures_sqrt_trace(cs, ct[:, :3], method),
                w2.batch_w2_dissimilarity_gaussian(ms, mt, cs, ct, make_pd=True, method=method),
                w2.batch_w2_dissimilarity_gaussian_diag(ms, mt, vs, vt),
                *w2.batch_ot_gmm(ms, mt, vs, vt, True, ws, wt, method=method, **sinkhorn),
                *w2.batch_ot_gmm(ms, mt, cs, ct, False, ws, wt, method=method, **sinkhorn),
                *w2.gaussian_barycenter(ms, vs, ws, True, n_iter=10, method=method),
                *w2.gaussian_barycenter(ms, cs, ws, False, n_iter=10, method=method)]

    inputs = (ms, mt, cs, ct, vs, vt, ws, wt)
    want = _jit(functools.partial(calls, jw))(*map(jnp.asarray, inputs))
    got = calls(pw, *map(torch.from_numpy, inputs))
    for g, w in zip(got, want):
        _close(g, w, tol)
    tms, tcs = torch.from_numpy(ms), torch.from_numpy(cs)
    with pytest.raises(ValueError, match="unknown W2 method"):
        pw.w2_gaussian(tms, tms, tcs, tcs, method="ns")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["eigh", "polar"])
def test_transport_operators_match(dtype, method):
    """(T, Σw) of eq. 17 and eq. 19, diagonal and full, then T·(x − μs) + μt;
    with Σw and a generator the noise is √Σw·ε with ε from that generator
    (the port's own roots, held above). The first row's variances are equal
    on both sides: Σw = 0 there, a valid transport."""
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    covs = {True: [rng.uniform(0.2, 2.0, (3, 6)).astype(np_dtype) for _ in range(2)],
            False: [_spd(rng, (3,), 6, np_dtype), _spd(rng, (3,), 6, np_dtype, ridge=0.5)]}
    for cs, ct in covs.values():
        ct[0] = cs[0]
    x, ms, mt = (rng.standard_normal((3, 6)).astype(np_dtype) for _ in range(3))
    cases = [(stochastic, diag) for stochastic in (False, True) for diag in (False, True)]

    def kw(stochastic, diag):
        return dict(stochastic=stochastic, diag=diag, pg_star=0.2, make_pd=True, method=method)

    @_jit
    def want(covs, x, ms, mt):
        out = []
        for stochastic, diag in cases:
            T, Cw = jw.compute_transport_operators(*covs[diag], **kw(stochastic, diag))
            out.append((T, Cw, jw.apply_transport(x, ms, mt, T, diag=diag, method=method)))
        return out

    jcovs = {diag: [jnp.asarray(c) for c in pair] for diag, pair in covs.items()}
    tx, tms, tmt = map(torch.from_numpy, (x, ms, mt))
    for (stochastic, diag), (jT, jCw, jmoved) in zip(
            cases, want(jcovs, *map(jnp.asarray, (x, ms, mt)))):
        case_tol = ITER_F32_TOL if (method == "polar" and dtype == "float32"
                                    and not diag) else tol
        T, Cw = pw.compute_transport_operators(*map(torch.from_numpy, covs[diag]),
                                               **kw(stochastic, diag))
        _close(T, jT, case_tol)
        _close(Cw, jCw, case_tol)
        moved = pw.apply_transport(tx, tms, tmt, T, diag=diag, method=method)
        _close(moved, jmoved, case_tol)
        if not stochastic:
            continue
        noisy = pw.apply_transport(tx, tms, tmt, T, Cw, diag=diag, method=method,
                                   generator=torch.Generator().manual_seed(9))
        eps = torch.randn((3, 6), generator=torch.Generator().manual_seed(9), dtype=torch_dtype)
        if diag:
            noise = torch.sqrt(torch.clamp_min(Cw, 0.0)) * eps
        elif method == "polar":
            scale = pm.sqrtm(pm.make_psd(pm.symmetrize(Cw), method="polar"), method="ns")
            noise = (scale @ eps[..., None])[..., 0]
        else:
            noise = (pm.sqrtm(pm.symmetrize(Cw)) @ eps[..., None])[..., 0]
        _close(noisy, moved + noise, case_tol)


def test_full_f32_restores_the_caller_setting():
    """Inside the OT core TF32 is off; the caller's setting comes back."""
    seen = []
    probe = pm.full_f32(lambda: seen.append(torch.backends.cuda.matmul.allow_tf32))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            probe()
            pw.w2_gaussian(torch.zeros(2), torch.ones(2), torch.eye(2), torch.eye(2))
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False, False]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("diag", [False, True])
def test_gaussian_model_matches(dtype, diag):
    """Streaming updates, plain, Kahan-compensated and EMA, one batch with
    sample weights; fit; then log_prob, w2 and a sample given the same ε."""
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    modes = {"plain": dict(), "compensated": dict(compensated=True),
             "decay": dict(update_decay=0.9)}
    cfg = dict(leading_shape=(2,), dim=5, diag=diag)
    jmodels = {m: JaxGaussianModel(**cfg, **kw, dtype=np_dtype) for m, kw in modes.items()}
    rng = np.random.default_rng(6)
    xs = (rng.standard_normal((4, 2, 30, 5)) * [1.0, 2.0, 0.5, 1.5, 3.0] + 1.0).astype(np_dtype)
    w = rng.uniform(0.0, 1.0, (2, 30)).astype(np_dtype)  # the third batch's weights
    x = rng.standard_normal((2, 7, 5)).astype(np_dtype)
    eps = torch.randn((2, 4, 5), generator=torch.Generator().manual_seed(3), dtype=torch_dtype)

    @_jit
    def want(xs, w, x, eps):
        fits = {}
        for mode, jmodel in jmodels.items():
            jstate = jmodel.init()
            for i in range(4):
                jstate = jmodel.update(jstate, xs[i], sample_weights=w if i == 2 else None)
            fits[mode] = (jstate, jmodel.fit(jstate))
        jmodel, jparams = jmodels["plain"], fits["plain"][1]
        jother = JaxGaussianParams(jparams.mean + 1.0, jparams.cov * 2.0)
        if diag:
            draws = jparams.mean[..., None, :] + eps * jnp.sqrt(jparams.cov)[..., None, :]
        else:
            chol = jnp.linalg.cholesky(jm.make_psd(jm.symmetrize(jparams.cov), strict=True))
            draws = jparams.mean[..., None, :] + jnp.einsum("...ij,...bj->...bi", chol, eps)
        return fits, jmodel.log_prob(jparams, x), jmodel.w2(jparams, jother), draws

    fits, log_prob, w2, jdraws = want(*map(jnp.asarray, (xs, w, x, eps.numpy())))
    for mode, kw in modes.items():
        model = GaussianModel(**cfg, **kw, dtype=torch_dtype)
        state = model.init("cpu")
        for i in range(4):
            state = model.update(state, torch.from_numpy(xs[i]),
                                 torch.from_numpy(w) if i == 2 else None)
        jstate, jparams = fits[mode]
        for name in ("n", "s1", "s2", "c1", "c2"):
            got, want_ = getattr(state, name), getattr(jstate, name)
            assert (got is None) == (want_ is None) == (name in ("c1", "c2")
                                                        and mode != "compensated")
            if got is not None:
                _close(got, want_, tol)
        params = model.fit(state)
        for got, want_ in zip(params, jparams):
            _close(got, want_, tol)
    # the evaluation functions on the same (handed-across) parameters
    model = GaussianModel(**cfg, dtype=torch_dtype)
    params = GaussianParams(*(torch.from_numpy(np.array(v)) for v in fits["plain"][1]))
    _close(model.log_prob(params, torch.from_numpy(x)), log_prob, tol)
    other = GaussianParams(params.mean + 1.0, params.cov * 2.0)
    _close(model.w2(params, other), w2, tol)
    _close(model.sample(params, torch.Generator().manual_seed(3), 4), jdraws, tol)


@pytest.mark.parametrize("diag", [False, True])
def test_gaussian_trainable_matches(diag):
    """constrain and nll of the same unconstrained parameters (float64)."""
    rng = np.random.default_rng(7)
    shape = (2, 4) if diag else (2, 4, 4)
    trainable = {"mean": rng.standard_normal((2, 4)), "scale_raw": 0.3 * rng.standard_normal(shape)}
    model = GaussianModel((2,), 4, diag=diag, dtype=torch.float64)
    jmodel = JaxGaussianModel((2,), 4, diag=diag, dtype=np.float64)
    t = {k: torch.from_numpy(v) for k, v in trainable.items()}
    j = {k: jnp.asarray(v) for k, v in trainable.items()}
    x = rng.standard_normal((2, 9, 4))
    params, nll = _jit(lambda j, x: (jmodel.constrain(j), jmodel.nll(j, x)))(
        j, jnp.asarray(x))
    for got, want in zip(model.constrain(t), params):
        _close(got, want, F64_TOL)
    _close(model.nll(t, torch.from_numpy(x)), nll, F64_TOL)
    fresh = model.init_trainable(torch.Generator().manual_seed(0))
    assert fresh["mean"].shape == (2, 4) and fresh["scale_raw"].shape == shape


def _gmm_state_arrays(rng, lead, k, d, diag, np_dtype):
    mean = rng.standard_normal((*lead, k, d)) * 2.0
    cov = (rng.uniform(0.3, 1.5, (*lead, k, d)) if diag
           else _spd(rng, (*lead, k), d, np.float64, ridge=0.3))
    n_obs = rng.uniform(1.0, 4.0, (*lead, k))
    s1 = mean * n_obs[..., None]
    if diag:
        s2 = (cov + mean ** 2) * n_obs[..., None]
    else:
        s2 = (cov + mean[..., :, None] * mean[..., None, :]) * n_obs[..., None, None]
    return {k_: v.astype(np_dtype) for k_, v in dict(mean=mean, cov=cov, n_obs=n_obs, s1=s1,
                                                     s2=s2).items()}


def _gmm_pair(arrays):
    return (GMMState(**{k: torch.from_numpy(v) for k, v in arrays.items()}, initialized=True),
            JaxGMMState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                        initialized=jnp.asarray(True)))


def _assert_gmm_close(got: GMMState, want, tol):
    for name in ("mean", "cov", "n_obs", "s1", "s2"):
        _close(getattr(got, name), getattr(want, name), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("diag", [False, True])
def test_gmm_model_matches(dtype, diag):
    """From a handed-across initialised state: a streaming update with
    sample weights (argmax assignments), a 3-iteration fit, the fit from
    buffers, energy, log_prob, predict_mean_var, barycenter and w2."""
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    cfg = dict(leading_shape=(2,), dim=4, n_components=3, diag=diag, kmeans_iter=3,
               update_decay=0.8)
    model, jmodel = GMMModel(**cfg, dtype=torch_dtype), JaxGMMModel(**cfg, dtype=np_dtype)
    rng = np.random.default_rng(8)
    state, jstate = _gmm_pair(_gmm_state_arrays(rng, (2,), 3, 4, diag, np_dtype))
    centers = rng.standard_normal((3, 4)) * 3.0
    x = (centers[rng.integers(0, 3, (2, 60))] + rng.standard_normal((2, 60, 4))).astype(np_dtype)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    w = rng.uniform(0.5, 1.0, (2, 60)).astype(np_dtype)
    a = rng.dirichlet(np.ones(3), (2, 5)).astype(np_dtype)

    @_jit
    def want(jstate, jx, w, a):
        jfitted = jmodel.fit(jstate, jx)
        jparams = jmodel.params(jfitted)
        return (jmodel.update(jstate, jx, sample_weights=w), jfitted, jmodel.fit(jstate),
                jparams.weights, jmodel.energy(jparams, jx[:, :9]),
                jmodel.log_prob(jparams, jx[:, :9]), jmodel.predict_mean_var(jparams, a),
                # the full-covariance barycenter and MW2 are held in
                # test_w2_functions_match
                jmodel.barycenter(jparams, a, n_iter=8) if diag else None,
                jmodel.w2(jparams, jmodel.params(jstate), reg=0.05) if diag else None)

    (updated, jfitted, from_buffers, weights, energy, log_prob, mean_var, bary,
     w2) = want(jstate, jx, jnp.asarray(w), jnp.asarray(a))
    _assert_gmm_close(model.update(state, tx, sample_weights=torch.from_numpy(w)), updated, tol)
    fitted = model.fit(state, tx)
    _assert_gmm_close(fitted, jfitted, tol)
    _assert_gmm_close(model.fit(state), from_buffers, tol)
    _close(model.params(fitted).weights, weights, tol)
    # the evaluation functions on the JAX fit's components, handed across:
    # far samples' energies reach 1e4 in f32, where the fits' own last-digit
    # differences would show amplified
    params = model.params(GMMState(**{k: torch.from_numpy(np.array(getattr(jfitted, k)))
                                      for k in ("mean", "cov", "n_obs", "s1", "s2")},
                                   initialized=True))
    _close(model.energy(params, tx[:, :9]), energy, tol)
    _close(model.log_prob(params, tx[:, :9]), log_prob, tol)
    for got, want_ in zip(model.predict_mean_var(params, torch.from_numpy(a)), mean_var):
        _close(got, want_, tol)
    if diag:
        for got, want_ in zip(model.barycenter(params, torch.from_numpy(a), n_iter=8), bary):
            _close(got, want_, tol)
        _close(model.w2(params, model.params(state), reg=0.05), w2, tol)
    draws = model.sample(params, torch.Generator().manual_seed(0), 6)
    assert draws.shape == (2, 6, 4) and bool(torch.isfinite(draws).all())


def test_gmm_first_batch_seeds_the_means():
    """An uninitialised state takes k-means++ seeds from its first batch:
    every mean is one of the batch's samples."""
    model = GMMModel(dim=3, n_components=4, diag=True, kmeans_iter=0)
    state = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(1))
    seeded = model._maybe_init(state, x, torch.Generator().manual_seed(2))
    assert seeded.initialized and not state.initialized
    assert all(bool((x == m).all(-1).any()) for m in seeded.mean)
    trainable = model.init_trainable(torch.Generator().manual_seed(0))
    assert model.nll(trainable, x).shape == ()
