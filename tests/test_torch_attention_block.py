"""The port's fused attention block (rows 5 and 6) against the JAX package's
``fused_attention_block`` in interpret mode, on the CPU.

The CUDA kernels (``ot_vae_tpu_torch/ops/csrc/attention_block.cu`` and
``attention_block_bwd.cu``) run only on the card: chip_smoke.py holds them
against the plain versions tested here. On the CPU the entry runs the plain
forward and backward through the same autograd Function; on a CUDA tensor it
launches the kernels, which a mocked launch shows here. The JAX side runs
its block kernels with ``interpret=True``, and its ``AttentionBlock`` under
``OT_VAE_FUSED_ATTN_BLOCK=interpret``, set with monkeypatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.models import VAE as JaxVAE
from ot_vae_tpu.networks import CNN as JaxCNN
from ot_vae_tpu.networks.cnn import AttentionBlock as JaxAttentionBlock
from ot_vae_tpu.ops.attention_pallas import _block_fwd_call, fused_attention_block
from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
from ot_vae_tpu_torch.convert import load_jax_variables, state_dict_to_jax_variables
from ot_vae_tpu_torch.models import VAE
from ot_vae_tpu_torch.networks import CNN
from ot_vae_tpu_torch.networks.cnn import AttentionBlock
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.ops.attention import (
    attention_block,
    attention_block_backward_reference,
    attention_block_reference,
)
from ot_vae_tpu_torch.priors import GaussianPrior

# f32 on both sides, the same products in another summation order over at
# most 32 keys and 24 channels: measured below 1e-6, held at the JAX test's
# 1e-5 (tests/test_attention_pallas.py:222)
ATOL = 1e-5
# gradients, f32: the JAX test's tolerances (atol 5e-5, rtol 1e-4)
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4
# bf16: both sides round qkv, P, the attention output, dAttn, dS, dqkv and
# the outputs to bf16 at the same points; a sum taken in another order can
# round an entry the other way, which moves an output by up to one bf16 ulp
# of its scale (2^-8 of its largest entry). The JAX test's f32 tolerances do
# not hold there: the gradients' largest error measured 0.37 of that ulp (dx
# at h2_ch8), the outputs' less
BF16_ULP = 2.0**-8

# (b, t, c, h, ch, c_out): the JAX test's shapes (C = 24 with H·ch = 16)
# and one with C_out != C
SHAPES = [(2, 32, 24, 1, 16, 24), (2, 32, 24, 2, 8, 24), (2, 20, 12, 3, 4, 40)]
IDS = ["h1_ch16", "h2_ch8", "c_out40"]


def _inputs(b, t, c, h, ch, c_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    wq = (rng.standard_normal((c, 3 * h * ch)) * 0.3).astype(np.float32)
    wo = (rng.standard_normal((h * ch, c_out)) * 0.3).astype(np.float32)
    dout = rng.standard_normal((b, t, c_out)).astype(np.float32)
    return x, wq, wo, dout


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas(shape, dtype):
    """Row 5's plain version: out against ``fused_attention_block`` and
    ``_block_fwd_call`` in interpret mode; lse against the Pallas kernel's
    and a numpy logsumexp of the scaled logits."""
    b, t, c, h, ch, c_out = shape
    x, wq, wo, _ = _inputs(*shape, seed=sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x).astype(jdt)
    scale = 1.0 / np.sqrt(ch)
    want = fused_attention_block(jx, jnp.asarray(wq), jnp.asarray(wo), h, scale,
                                 interpret=True)
    want_out, want_lse = _block_fwd_call(jx, jnp.asarray(wq), jnp.asarray(wo), h, scale, True)
    out, lse = attention_block_reference(_t(x, tdt), _t(wq), _t(wo), h, scale)
    assert out.dtype == tdt and out.shape == (b, t, c_out) and lse.dtype == torch.float32
    atol = ATOL if dtype == "float32" else BF16_ULP * np.abs(_np(want)).max()
    for ref in (want, want_out):
        np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _np(want_lse), atol=ATOL, rtol=0)
    # the lse of the logits of the rounded qkv, in f64
    xr = _np(jx).astype(np.float64)
    wqr = _np(jnp.asarray(wq).astype(jdt)).astype(np.float64)
    qkv = _np(jnp.asarray(xr @ wqr, jnp.float32).astype(jdt)).astype(np.float64)
    q = qkv[..., :h * ch].reshape(b, t, h, ch)
    k = qkv[..., h * ch:2 * h * ch].reshape(b, t, h, ch)
    s = np.einsum("bqhd,bkhd->bqhk", q, k) * scale
    m = s.max(-1)
    ref_lse = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_vjp(shape, dtype):
    """Row 6's plain version against ``jax.vjp`` of the interpret-mode
    entry (``_block_bwd_kernel``), from the forward's own lse."""
    b, t, c, h, ch, c_out = shape
    x, wq, wo, dout = _inputs(*shape, seed=10 + sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    scale = 1.0 / np.sqrt(ch)
    jx = jnp.asarray(x).astype(jdt)
    _, vjp = jax.vjp(lambda a, w1, w2: fused_attention_block(a, w1, w2, h, scale,
                                                             interpret=True),
                     jx, jnp.asarray(wq), jnp.asarray(wo))
    want = vjp(jnp.asarray(dout).astype(jdt))
    _, lse = attention_block_reference(_t(x, tdt), _t(wq), _t(wo), h, scale)
    got = attention_block_backward_reference(_t(x, tdt), _t(wq), _t(wo), lse, _t(dout, tdt),
                                             h, scale)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(("dx", "dw_qkv", "dw_out"), got, want):
        w = _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=0, err_msg=name,
                                       atol=BF16_ULP * np.abs(w).max())


def test_function_gradcheck_f64():
    """The autograd Function's backward (the plain row 6 on the CPU) is the
    exact VJP of its forward in f64."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 5))).requires_grad_()
    wq = torch.from_numpy(rng.standard_normal((5, 12)) * 0.5).requires_grad_()
    wo = torch.from_numpy(rng.standard_normal((4, 6)) * 0.5).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, w1, w2: attention.fused_attention_block(a, w1, w2, 2), (x, wq, wo))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, wq, wo, dout = _inputs(*SHAPES[1], seed=4)
    before = (attention.block_launch_count, attention.block_bwd_launch_count,
              attention.launch_count, attention.backward_launch_count)
    out, lse = attention_block(_t(x), _t(wq), _t(wo), 2)
    ref_out, ref_lse = attention_block_reference(_t(x), _t(wq), _t(wo), 2, 1.0 / np.sqrt(8))
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    tx, twq, two = (_t(a).requires_grad_() for a in (x, wq, wo))
    (attention.fused_attention_block(tx, twq, two, 2) * _t(dout)).sum().backward()
    want = attention_block_backward_reference(_t(x), _t(wq), _t(wo), ref_lse, _t(dout), 2,
                                              1.0 / np.sqrt(8))
    for got, ref in zip((tx.grad, twq.grad, two.grad), want):
        assert torch.equal(got, ref)
    with torch.inference_mode():
        assert torch.equal(attention.fused_attention_block(_t(x), _t(wq), _t(wo), 2), ref_out)
    assert (attention.block_launch_count, attention.block_bwd_launch_count,
            attention.launch_count, attention.backward_launch_count) == before
    with pytest.raises(ValueError, match="w_out"):
        attention_block(_t(x), _t(wq), _t(wo)[:-1], 2)
    with pytest.raises(ValueError, match="divisible"):
        attention_block(_t(x), _t(wq), _t(wo), 5)


@pytest.fixture
def mocked_card(monkeypatch):
    """Every tensor counts as a CUDA tensor; the "launches" compute the plain
    forward and backward, each recorded, while the plain versions themselves
    raise if the entry calls them directly."""
    launched = []
    plain = (attention.attention_block_reference, attention.attention_block_backward_reference)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def fwd(*args):
        launched.append("block_fwd")
        return plain[0](*args)

    def bwd(*args):
        launched.append("block_bwd")
        return plain[1](*args)

    monkeypatch.setattr(attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(attention, "_launch_block", fwd)
    monkeypatch.setattr(attention, "_launch_block_backward", bwd)
    monkeypatch.setattr(attention, "attention_block_reference", refuse)
    monkeypatch.setattr(attention, "attention_block_backward_reference", refuse)
    return launched


@pytest.mark.parametrize("failing", ["_launch_block", "_launch_block_backward"])
def test_cuda_launches_each_kernel_once_and_raises_not_a_fallback(mocked_card, monkeypatch,
                                                                  failing):
    """On a CUDA tensor the Function launches row 5 once and row 6 once and
    never runs a plain version; a failing launch reaches the caller."""
    x, wq, wo, dout = _inputs(*SHAPES[2], seed=5)

    def run():
        tx, twq, two = (_t(a).requires_grad_() for a in (x, wq, wo))
        (attention.fused_attention_block(tx, twq, two, 3) * _t(dout)).sum().backward()
        return tx.grad, twq.grad, two.grad

    grads = run()
    assert all(g is not None for g in grads) and grads[1].dtype == torch.float32
    assert mocked_card == ["block_fwd", "block_bwd"]

    def fail(*args):
        raise RuntimeError("launch failed: cudaError 1")

    monkeypatch.setattr(attention, failing, fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        run()


# ------------------------------------------------------------------ modules


def _jax_block_pair(equalized_lr, seed):
    blk = JaxAttentionBlock(channels=16, heads=2, normalization="batchnorm",
                            equalized_lr=equalized_lr)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 4, 4, 16)) * 1.5 + 0.5).astype(np.float32)
    co = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    variables = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return blk, variables, x, co


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("equalized_lr", [None, 1.0], ids=["plain", "equalized_lr"])
def test_attention_block_module_matches_jax_fused(monkeypatch, equalized_lr):
    """``AttentionBlock(fused_block=True)`` against the JAX block under
    ``OT_VAE_FUSED_ATTN_BLOCK=interpret`` in train mode: output, every
    parameter gradient and the batch norm's running statistics; the same
    state dict loads strict into a fused and an unfused port block, which
    agree with each other."""
    monkeypatch.setenv("OT_VAE_FUSED_ATTN_BLOCK", "interpret")
    blk, variables, x, co = _jax_block_pair(equalized_lr, 7 + int(bool(equalized_lr)))

    def loss(params):
        out, mutated = blk.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return jnp.sum(out * co), (out, mutated)

    (_, (want, mutated)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])

    fused = AttentionBlock(16, 2, "batchnorm", equalized_lr, fused_block=True)
    unfused = AttentionBlock(16, 2, "batchnorm", equalized_lr)
    load_jax_variables(fused, variables)
    unfused.load_state_dict(fused.state_dict(), strict=True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC → channels_last NCHW
    outs = {}
    for name, module in (("fused", fused), ("unfused", unfused)):
        out = module.train()(tx).permute(0, 2, 3, 1)
        (out * torch.from_numpy(co)).sum().backward()
        outs[name] = out.detach().numpy()
    # f32, the same function summed in another order (measured below 1e-6)
    np.testing.assert_allclose(outs["fused"], np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(outs["unfused"], outs["fused"], atol=ATOL, rtol=0)
    got = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in fused.named_parameters()})["params"])
    other = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in unfused.named_parameters()})["params"])
    jgrads = _flat(grads)
    assert set(got) == set(jgrads)
    for path, w in jgrads.items():
        np.testing.assert_allclose(got[path], w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=path)
        np.testing.assert_allclose(other[path], got[path], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=path)
    stats = _flat(state_dict_to_jax_variables(fused.state_dict())["batch_stats"])
    for path, w in _flat(mutated["batch_stats"]).items():
        # f32 statistics in another summation order
        np.testing.assert_allclose(stats[path], w, atol=1e-6, rtol=1e-6, err_msg=path)


# -------------------------------------------------- the slice as a whole

# the FFHQ128 CNN VAE's architecture (configs/vae/ffhq128.yaml: residual add,
# attention at head dim 64, 4² latent) at resolution 32 and capacity 4, so
# that its attention blocks run at T = 256, 64 and 16 with widths 4, 8 and
# 32 at head dim 4
ENCODER = dict(in_features=3, out_features=32, in_resolution=32, out_resolution=4,
               capacity=4, down_sample=True, residual="add", attn_head_dim=4)
DECODER = dict(in_features=16, out_features=3, in_resolution=4, out_resolution=32,
               capacity=4, up_sample=True, residual="add", attn_head_dim=4)
LATENT = (4, 4, 16)
# f32 through about thirty layers: reconstruct over max(1, max|out|), and
# each gradient leaf over max(1e-3, max|leaf|) as tests/test_torch_vit_training.py.
# Leaves with no gradient in exact arithmetic (a per-channel constant that
# meets a batch norm through linear layers alone, as the biases of the 1×1
# skips' norms: JAX's whole leaf below 1e-5 of the model's largest gradient)
# hold rounding noise on both sides and must stay under 1e-5 of the largest
# (tests/test_torch_training.py draws the same line)
RECON_TOL = 1e-4
VAE_GRAD_TOL = 1e-4
NOISE_TOL = 1e-5


@pytest.fixture(scope="module")
def vae_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OT_VAE_FUSED_ATTN_BLOCK", "interpret")
        jm = JaxVAE(encoder=JaxCNN(**ENCODER), decoder=JaxCNN(**DECODER),
                    prior=JaxGaussianPrior(loss_coeff=0.1))
        images = np.random.default_rng(20).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        batch = (jnp.asarray(images), jnp.zeros((2,), jnp.int32))
        variables = jax.jit(jm.init_variables)(jax.random.PRNGKey(21), batch)
        key = jax.random.PRNGKey(22)
        eps = np.array(jax.random.normal(key, (2, *LATENT), jnp.float32))
        recon = np.asarray(jax.jit(lambda v, x, k: jm.net.apply(v, x, 0, k, False))(
            variables, batch[0], key))
        pbatch = jm.batch_preprocess(batch, None, train=True)
        rest = {k: v for k, v in variables.items() if k != "params"}

        def jax_loss(params):
            return jm.loss_fn({"params": params, **rest}, pbatch, 3,
                              {"prior": key, "dropout": key})

        (loss, (logs, _, _)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            variables["params"])
    pm = VAE(CNN(**ENCODER, fused_block=True), CNN(**DECODER, fused_block=True),
             GaussianPrior(loss_coeff=0.1))
    load_jax_variables(pm.net, variables)
    return pm, images, eps, recon, float(loss), _flat(grads)


def test_fused_vae_reconstruct_matches_jax(vae_pair):
    pm, images, eps, recon, _, _ = vae_pair
    n_blocks = sum(isinstance(m, AttentionBlock) and m.fused_block for m in pm.net.modules())
    assert n_blocks == 6
    with torch.inference_mode():
        got = pm.net.eval()(torch.from_numpy(images), noise=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), recon, rtol=0,
                               atol=RECON_TOL * max(1.0, np.abs(recon).max()))


def test_fused_vae_train_step_matches_jax(vae_pair):
    pm, images, eps, _, loss, jgrads = vae_pair
    x = torch.from_numpy(images)
    got, _, _ = pm.train().loss_fn({"samples": x, "target": x, "kwargs": {}}, 3,
                                   noise=torch.from_numpy(eps))
    got.backward()
    assert abs(got.item() - loss) <= 1e-5 * max(1.0, abs(loss))
    pgrads = _flat(state_dict_to_jax_variables(
        {k: p.grad for k, p in pm.net.named_parameters()})["params"])
    assert set(pgrads) == set(jgrads)
    scale = max(np.abs(g).max() for g in jgrads.values())
    n_noise = 0
    for path, want in jgrads.items():
        if np.abs(want).max() <= NOISE_TOL * scale:
            n_noise += 1
            assert np.abs(pgrads[path]).max() <= NOISE_TOL * scale, path
            continue
        np.testing.assert_allclose(pgrads[path], want, rtol=0, err_msg=path,
                                   atol=VAE_GRAD_TOL * max(1e-3, np.abs(want).max()))
    assert n_noise < len(jgrads) // 4
