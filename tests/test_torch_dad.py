"""The port's DAD path against the JAX package's, on the CPU: the Gumbel
assignment modes, ``CodebookPrior`` (learned and k-means codebooks, shared
and per token, every loss, the annealed temperature, ``sample``), the
causal and the time-dependent ViT, ``AutoRegressive``, the KV-cached decode
under teacher forcing, DAD's loss and gradients with dropout, and
``decode_tokens``; then, within the port, the KV-cached sampler against the
unrolled oracle, and ``VAE.sample`` and ``InferenceEngine.sample`` through
DAD's sampler.

JAX keys and torch generators draw different numbers, so nothing random is
drawn twice: the port's seeded weights are carried into the JAX layout
(after checking them against the JAX tree, traced with
``jax.eval_shape``), and the draws JAX makes while a function is traced
(``jax.random.gumbel``, ``categorical`` and ``bernoulli``, recorded in call
order and returned from the jitted function) are handed to the port's draw
functions (``distributions.codebook.gumbel_noise`` and ``_categorical``,
``nets_utils.dropout_keep``). The model is tests/test_dad.py's ``_tiny_dad``:
dim 32, depth 2, 16 tokens, a vocabulary of 32. Each JAX function is
compiled once with XLA's CPU optimisations off; on the CPU the JAX ViT
takes flax's stock attention and the port the plain row-7 and row-8
versions, the same f32 function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.distributions.codebook import CodebookState as JaxCodebookState
from ot_vae_tpu.distributions.codebook import assign_from_energy as jax_assign
from ot_vae_tpu.models import DAD as JaxDAD
from ot_vae_tpu.models.dad import DADNet as JaxDADNet
from ot_vae_tpu.networks import AutoRegressive as JaxAutoRegressive
from ot_vae_tpu.networks import ViT as JaxViT
from ot_vae_tpu.priors import CodebookPrior as JaxCodebookPrior
from ot_vae_tpu_torch.convert import load_jax_variables, state_dict_to_jax_variables
from ot_vae_tpu_torch.distributions import codebook as codebook_mod
from ot_vae_tpu_torch.distributions.codebook import assign_from_energy
from ot_vae_tpu_torch.models import DAD
from ot_vae_tpu_torch.models import dad as dad_mod
from ot_vae_tpu_torch.networks import AutoRegressive, ViT, nets_utils
from ot_vae_tpu_torch.priors import CodebookPrior
from ot_vae_tpu_torch.serving import InferenceEngine

# f32 on both sides, the same function with sums in other orders; errors
# over max(1, max|output|): measured at most 5.7e-7, held at 1e-5
TOL = 1e-5
# gradients leaf by leaf over max(1e-3, max|leaf|): measured 9.4e-7, held
# at 1e-4 as the ViT VAEs' (tests/test_torch_vit_training.py)
GRAD_TOL = 1e-4
# the cached sampler against the oracle, as tests/test_dad.py holds JAX's
SAMPLER_ATOL = 1e-5
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
VOCAB = 32
CFG = dict(image_size=28, patch_size=7, dim=32, depth=2, heads=4, mlp_dim=64, channels=1,
           emb_dropout=0.0)
N_TOKENS = 16


def _jit(fn):
    """``jax.jit(fn)`` compiled once, with :data:`_FAST_COMPILE`."""
    jitted, compiled = jax.jit(fn), {}

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
    that they are exactly the tree ``jax_init()`` makes (paths and shapes,
    traced with ``jax.eval_shape``, nothing compiled)."""
    variables = state_dict_to_jax_variables(port.state_dict())
    want = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), jax.eval_shape(jax_init))).items()}
    assert {k: v.shape for k, v in _flat(variables).items()} == want
    return {k: v for k, v in variables.items() if v}


def _grads_close(port_module, jax_grads, tol=GRAD_TOL):
    got = _flat(state_dict_to_jax_variables(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in port_module.named_parameters()})["params"])
    want = _flat(jax_grads)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, err_msg=path,
                                   atol=tol * max(1e-3, np.abs(w).max()))


@pytest.fixture
def jax_draws(monkeypatch):
    """``run(fn, *args)``: ``fn(*args)`` jitted, and the draws of
    ``jax.random.gumbel``, ``categorical`` and ``bernoulli`` it makes, each
    in call order."""
    drawn = {"gumbel": [], "categorical": [], "bernoulli": []}
    for name in drawn:
        original = getattr(jax.random, name)

        def record(*args, _name=name, _original=original, **kwargs):
            out = _original(*args, **kwargs)
            drawn[_name].append(out)
            return out

        monkeypatch.setattr(jax.random, name, record)

    def run(fn, *args):
        def traced(*a):
            for v in drawn.values():
                v.clear()
            return fn(*a), {k: list(v) for k, v in drawn.items()}

        out, draws = _jit(traced)(*args)
        return out, {k: [np.asarray(d) for d in v] for k, v in draws.items()}

    return run


def _hand_draws(monkeypatch, draws):
    """The port's draw functions return the recorded JAX draws in order;
    the queues are returned so a test can check that all were used."""
    queues = {k: list(v) for k, v in draws.items()}

    def gumbel(shape, generator, device, dtype=torch.float32):
        g = queues["gumbel"].pop(0)
        assert generator is not None and g.shape == tuple(shape), (g.shape, shape)
        return torch.from_numpy(np.array(g, np.float32)).to(device, dtype)

    def categorical(probs, generator, n=None):
        idx = queues["categorical"].pop(0)
        want = (*probs.shape[:-1], n) if n else tuple(probs.shape[:-1])
        assert generator is not None and idx.shape == want, (idx.shape, want)
        return torch.from_numpy(np.array(idx, np.int64)).to(probs.device)

    def keep(shape, keep_prob, generator, device):
        mask = queues["bernoulli"].pop(0)
        assert generator is not None and mask.size == int(np.prod(shape))
        return torch.from_numpy(np.array(mask).reshape(tuple(shape))).to(device)

    monkeypatch.setattr(codebook_mod, "gumbel_noise", gumbel)
    monkeypatch.setattr(codebook_mod, "_categorical", categorical)
    monkeypatch.setattr(nets_utils, "dropout_keep", keep)
    return queues


# ------------------------------------------------------------ the Gumbel modes


@pytest.mark.parametrize("mode", ["gumbel-softmax", "gumbel-hardmax"])
def test_gumbel_assignment_matches_jax(monkeypatch, jax_draws, mode):
    """Weights, indices and probabilities, and the gradient of a fixed
    cotangent of the weights with respect to the energy (hardmax: the soft
    gradient through the straight-through estimator)."""
    energy = _rng(0).standard_normal((2, 5, 7)).astype(np.float32)
    cot = _rng(1).standard_normal((2, 5, 7)).astype(np.float32)

    def fn(e, key):
        def loss(e):
            a = jax_assign(e, mode, 7, temperature=0.7, key=key)
            return jnp.sum(a.weights * cot), a
        return jax.value_and_grad(loss, has_aux=True)(e)

    ((_, want), grad), draws = jax_draws(fn, jnp.asarray(energy), jax.random.PRNGKey(2))
    assert [len(draws["categorical"]), len(draws["gumbel"])] == [1, 1]
    queues = _hand_draws(monkeypatch, draws)
    e = torch.from_numpy(energy).requires_grad_()
    got = assign_from_energy(e, mode, 7, temperature=0.7, generator=torch.Generator())
    (got.weights * torch.from_numpy(cot)).sum().backward()
    assert not queues["gumbel"] and not queues["categorical"]
    _close(got.weights, want.weights, what="weights")
    _close(got.probs, want.probs, what="probs")
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _close(e.grad, grad, what="d energy")
    if "hard" in mode:
        assert set(np.unique(got.weights.detach().numpy())) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="generator"):
        assign_from_energy(e, mode, 7)


# ------------------------------------------------------------ CodebookPrior

# (learned codebook?, per token?, training mode, loss, step): the DAD's
# prior (learned, shared, gumbel-softmax, no loss) and the other branches;
# steps 0, 1000 and 2000 of a 2000-step temperature annealing
PRIORS = {
    "dad_prior_step0": (True, False, "gumbel-softmax", None, 0),
    "kmeans_shared_argmax_l2_step1000": (False, False, "argmax", "l2", 1000),
    "kmeans_per_token_sample_kl_step2000": (False, True, "sample", "kl", 2000),
    "learned_per_token_hardmax_first_kl_step5": (True, True, "gumbel-hardmax", "first_kl", 5),
}
LATENT = (4, 6)  # 4 tokens of 6 dims (embed_dims=(2,))


@pytest.mark.parametrize("case", list(PRIORS))
def test_codebook_prior_matches_jax(monkeypatch, jax_draws, case):
    """A train-mode forward: z, the per-sample loss, the token-major
    distribution and indices, the gradients with respect to x (and the
    learned codebook), the k-means state it leaves; then ``sample`` and
    ``codebook()``."""
    learned, per_token, mode, loss, step = PRIORS[case]
    kw = dict(latent_size=LATENT, embed_dims=(2,), loss=loss, temperature_annealing=2000,
              n_components=8, temperature=0.3, training_mode=mode, inference_mode="sample",
              update_with_autograd=learned, per_token_codebook=per_token, loss_coeff=0.5)
    torch.manual_seed(3)
    port = CodebookPrior(**kw)
    lead = LATENT[0] if per_token else 1
    rng = _rng(4)
    if learned:
        variables = {"params": {"codebook": np.asarray(port.atoms.detach())}}
    else:  # an initialised k-means state (the seeding draw is not handed across)
        state = JaxCodebookState(
            codebook=rng.standard_normal((lead, 8, 6)).astype(np.float32),
            n_obs=rng.uniform(0.5, 2, (lead, 8)).astype(np.float32),
            s1=rng.standard_normal((lead, 8, 6)).astype(np.float32),
            initialized=np.asarray(True))
        variables = {"prior_stats": {"codebook": state}}
        load_jax_variables(port, variables)
    x = rng.standard_normal((3, *LATENT)).astype(np.float32)
    cot = rng.standard_normal((3, *LATENT)).astype(np.float32)
    jprior = JaxCodebookPrior(**kw)

    def fn(v, x, key):
        def f(params, x):
            (z, ploss, art), mutated = jprior.apply(
                {**v, **({"params": params} if learned else {})}, x, step, key,
                train=True, mutable=["prior_stats"])
            return jnp.sum(z * cot) + jnp.sum(ploss), (z, ploss, art, mutated)
        (_, aux), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            v.get("params", {}), x)
        sample = jprior.apply({**v, **aux[3]}, jax.random.PRNGKey(6), (2, *LATENT),
                              method=JaxCodebookPrior.sample)
        return aux, grads, sample

    ((z, ploss, art, mutated), grads, sample), draws = jax_draws(
        fn, variables, jnp.asarray(x), jax.random.PRNGKey(5))
    queues = _hand_draws(monkeypatch, draws)
    tx = torch.from_numpy(x).requires_grad_()
    gz, gloss, gart = port.train()(tx, step, torch.Generator())
    ((gz * torch.from_numpy(cot)).sum() + gloss.sum()).backward()
    _close(gz, z, what="z")
    _close(gloss, ploss, what="loss")
    _close(gart["distribution"], art["distribution"], what="distribution")
    np.testing.assert_array_equal(gart["indices"].numpy(), np.asarray(art["indices"]))
    _close(tx.grad, grads[1], what="dx")
    if learned:
        _close(port.atoms.grad, grads[0]["codebook"], what="d codebook")
    else:
        got_state = state_dict_to_jax_variables(port.state_dict())["prior_stats"]["codebook"]
        for field in ("codebook", "n_obs", "s1"):
            _close(got_state[field], getattr(mutated["prior_stats"]["codebook"], field),
                   what=field)
    with torch.no_grad():
        _close(port.sample((2, *LATENT), torch.Generator()), sample, what="sample")
    assert not any(queues.values())
    _close(port.codebook(), variables["params"]["codebook"] if learned
           else got_state["codebook"], what="codebook()")
    # the JAX prior's schedule (ot_vae_tpu/priors/codebook.py), in f32
    want_temp = 0.3 * 0.5 * jnp.cos(np.pi * jnp.asarray(step, jnp.float32) / 2000) + 0.5
    _close(port.temperature_at(step), want_temp, 1e-7, "temperature")


# ------------------------------------------------------------ the ViTs


VITS = {
    # a causal stack on token embeddings (the AR trunk) at dropout 0
    "causal_tokens": (dict(n_embed_tokens=0, n_input_tokens=N_TOKENS, output_tokens="input",
                           patch_to_embed=False, causal_mask=True, dropout=0.0),
                      (2, N_TOKENS, 32), False),
    # images in, with class and time tokens after the embed token, causal
    # with a cross-attention stage
    "time_class_cross_causal": (dict(n_embed_tokens=1, num_classes=3, time_dependant=True,
                                     preprocess_depth=1, causal_mask=True,
                                     output_tokens="input", dropout=0.0),
                                (2, 28, 28, 1), True),
}


@pytest.mark.parametrize("name", list(VITS))
def test_causal_and_time_dependent_vit_match_jax(name):
    extra, shape, conditioned = VITS[name]
    cfg = {**CFG, **extra}
    x = _rng(7).standard_normal(shape).astype(np.float32)
    jkw = ({"labels": jnp.array([0, 2]), "time": jnp.array([0.25, 0.8], jnp.float32)}
           if conditioned else {})
    jvit = JaxViT(**cfg)
    torch.manual_seed(8)
    port = ViT(**cfg)
    variables = _carried(port, lambda: jvit.init(jax.random.PRNGKey(8), jnp.asarray(x), **jkw))
    want = _jit(lambda v, x, kw: jvit.apply(v, x, **kw))(variables, jnp.asarray(x), jkw)
    pkw = {k: torch.from_numpy(np.array(v)) for k, v in jkw.items()}
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(x), **pkw), want)
    if conditioned:
        with pytest.raises(ValueError, match="time"):
            port(torch.from_numpy(x), labels=pkw["labels"])


@pytest.fixture(scope="module")
def autoregressive():
    """The AR decoder of ``_tiny_dad`` (dropout 0), the port's seeded one and
    its variables in the JAX layout."""
    cfg = dict(vocab_size=VOCAB, n_embed_tokens=0, n_input_tokens=N_TOKENS,
               output_tokens="input", patch_to_embed=False, causal_mask=True, dropout=0.0,
               **CFG)
    jar = JaxAutoRegressive(**cfg)
    torch.manual_seed(9)
    port = AutoRegressive(**cfg).eval()
    tokens = _rng(10).integers(0, VOCAB, (3, N_TOKENS)).astype(np.int32)
    variables = _carried(port, lambda: jar.init(jax.random.PRNGKey(9), jnp.asarray(tokens)))
    return jar, port, variables, tokens


def test_autoregressive_logits_match_jax(autoregressive):
    jar, port, variables, tokens = autoregressive
    want = _jit(jar.apply)(variables, jnp.asarray(tokens))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long())
    assert got.shape == (3, N_TOKENS, VOCAB)
    _close(got, want)


def test_cached_decode_teacher_forced_matches_jax_and_the_full_forward(autoregressive):
    """A full-length decode call (zeroed caches, index 0) then one
    single-token call a position with the true tokens: the logits of each
    position against flax's cached decode and against the port's own full
    forward; the caches given are not changed."""
    jar, port, variables, tokens = autoregressive
    jt = jnp.asarray(tokens)
    _, cache = _jit(lambda v, t: jar.apply(v, t, decode=True, positions=jnp.arange(N_TOKENS),
                                           mutable=["cache"]))(variables, jt)
    step = _jit(lambda v, c, tok, i: jar.apply({**v, **c}, tok, decode=True,
                                               positions=i[None], mutable=["cache"]))
    want = []
    for i in range(N_TOKENS):
        logits, cache = step(variables, cache, jt[:, i:i + 1], jnp.asarray(i))
        want.append(np.asarray(logits[:, 0]))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        full = port(tt)
        first, caches = port(tt, decode=True, positions=torch.arange(N_TOKENS))
        _close(first, full, what="full-length decode call")
        assert all(c.index == 0 and not c.key.any() for c in caches)
        for i in range(N_TOKENS):
            before = [c.key.clone() for c in caches]
            logits, new = port(tt[:, i:i + 1], decode=True, positions=torch.tensor([i]),
                               caches=caches)
            assert all(torch.equal(c.key, b) for c, b in zip(caches, before))
            assert [c.index for c in new] == [i + 1] * len(new)
            caches = new
            _close(logits[:, 0], want[i], what=f"position {i} vs JAX")
            _close(logits[:, 0], full[:, i], what=f"position {i} vs the full forward")
        with pytest.raises(ValueError, match="one token"):
            port(tt[:, :2], decode=True, positions=torch.arange(2), caches=caches)


# ------------------------------------------------------------ DAD


def _tiny_dad(dropout):
    """tests/test_dad.py's ``_tiny_dad`` in both packages (the JAX model,
    the port's seeded one), dropout as given."""
    out = []
    for vit, ar, prior, dad in ((JaxViT, JaxAutoRegressive, JaxCodebookPrior, JaxDAD),
                                (ViT, AutoRegressive, CodebookPrior, DAD)):
        torch.manual_seed(11)
        cfg = {**CFG, "dropout": dropout}
        encoder = vit(n_embed_tokens=0, output_tokens="input", patch_to_embed=True,
                      embed_to_patch=False, **cfg)
        decoder = vit(n_embed_tokens=None, n_input_tokens=N_TOKENS, output_tokens="input",
                      patch_to_embed=False, embed_to_patch=True, **cfg)
        codebook = prior(latent_size=tuple(encoder.out_size), embed_dims=(2,), loss=None,
                         temperature_annealing=2000, n_components=VOCAB, temperature=1e-5,
                         training_mode="gumbel-softmax", inference_mode="sample",
                         update_with_autograd=True)
        decoder_ar = ar(vocab_size=VOCAB, n_embed_tokens=0, n_input_tokens=N_TOKENS,
                        output_tokens="input", patch_to_embed=False, causal_mask=True, **cfg)
        out.append(dad(encoder=encoder, decoder=decoder, autoregressive_decoder=decoder_ar,
                       prior=codebook))
    jm, pm = out
    batch = (jnp.zeros((2, 28, 28, 1), jnp.float32), jnp.zeros((2,), jnp.int32))
    variables = _carried(pm.net, lambda: jm.init_variables(jax.random.PRNGKey(0), batch))
    return jm, variables, pm


def test_dad_loss_and_gradients_match_jax(monkeypatch, jax_draws):
    """``loss_fn`` in train mode at step 5 with dropout 0.1: the logs and
    every gradient leaf, with the JAX dropout masks, Gumbel noise and
    sampled indices (the AR decoder's input) handed across. The encoder,
    decoder and AR stacks draw 8 masks each (4 a layer), the prior one
    categorical and one Gumbel draw."""
    jm, variables, pm = _tiny_dad(0.1)
    images = _rng(12).uniform(0, 1, (4, 28, 28, 1)).astype(np.float32)
    pbatch = jm.batch_preprocess((jnp.asarray(images), jnp.zeros(4, jnp.int32)), None)
    rngs = {"prior": jax.random.PRNGKey(13), "dropout": jax.random.PRNGKey(14)}

    def fn(params):
        return jax.value_and_grad(lambda p: jm.loss_fn({"params": p}, pbatch, 5, rngs),
                                  has_aux=True)(params)

    ((_, (logs, outputs, _)), grads), draws = jax_draws(fn, variables["params"])
    assert [len(draws[k]) for k in ("bernoulli", "categorical", "gumbel")] == [24, 1, 1]
    queues = _hand_draws(monkeypatch, draws)
    x = torch.from_numpy(images)
    loss, plogs, pout = pm.loss_fn({"samples": x, "target": x, "kwargs": {}}, 5,
                                   torch.Generator(), dropout_rng=torch.Generator())
    loss.backward()
    assert not any(queues.values())
    for key in logs:
        _close(plogs[key], logs[key], what=key)
    np.testing.assert_array_equal(pout["indices"].numpy(), np.asarray(outputs["indices"]))
    _close(pout["distribution"], outputs["distribution"], what="distribution")
    _grads_close(pm.net, grads)


def test_decode_tokens_matches_jax():
    jm, variables, pm = _tiny_dad(0.0)
    tokens = _rng(15).integers(0, VOCAB, (3, N_TOKENS)).astype(np.int32)
    want = _jit(lambda v, t: jm.net.apply(v, t, method=JaxDADNet.decode_tokens))(
        variables, jnp.asarray(tokens))
    with torch.no_grad():
        got = pm.eval().net.decode_tokens(torch.from_numpy(tokens).long())
    assert got.shape == (3, 28, 28, 1)
    _close(got, want)


def test_cached_sampler_equals_the_oracle_and_serves(monkeypatch):
    """For one generator the KV-cached sampler gives the oracle's samples
    (atol 1e-5, as tests/test_dad.py); both draw the initial tokens and then
    one token a step. ``sample_fn`` (so ``VAE.sample`` and
    ``InferenceEngine.sample``) takes the cached sampler, or the oracle
    without ``kv_cache``."""
    _, _, model = _tiny_dad(0.0)
    model.eval()
    calls = []
    draw = dad_mod.draw_tokens
    monkeypatch.setattr(dad_mod, "draw_tokens", lambda logits, g: calls.append(
        tuple(logits.shape)) or draw(logits, g))
    with torch.no_grad():
        fast = model.net.cached_sample(4, torch.Generator().manual_seed(7))
        slow = model.net.ancestral_sample(4, torch.Generator().manual_seed(7))
        assert calls == [(4, VOCAB)] * (2 * (N_TOKENS - 1))
        np.testing.assert_allclose(fast.numpy(), slow.numpy(), atol=SAMPLER_ATOL, rtol=1e-5)
        assert fast.shape == (4, 28, 28, 1)
        assert torch.equal(model.sample(4, torch.Generator().manual_seed(7)), fast)
        model.kv_cache = False
        assert torch.equal(model.sample(4, torch.Generator().manual_seed(7)), slow)
        model.kv_cache = True
        engine = InferenceEngine(model, device="cpu")
        want = model.net.cached_sample(4, torch.Generator().manual_seed(7))
        served = engine.sample(4, torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(served, want.numpy())
