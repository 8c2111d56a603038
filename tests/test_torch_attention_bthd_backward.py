"""The plain versions of the port's BTHD (row 8) and BHTC (row 4) attention
backward kernels against the JAX package's Pallas kernels in interpret
mode, on the CPU, in f32 and bf16.

Both sides start from the same forward residuals (out and lse), so each
backward is compared alone: for row 8 the port's plain forward's, which
tests/test_torch_attention_bthd.py holds to the Pallas forward, and for
row 4 the JAX forward's. The CUDA kernel
(``ot_vae_tpu_torch/ops/csrc/attention_bthd_bwd.cu``) runs only on the card,
where chip_smoke.py holds it against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.ops.attention_pallas import _bthd_bwd_call, fused_attention
from ot_vae_tpu_torch.ops import attention
from ot_vae_tpu_torch.ops.attention import (
    attention_bhtc_backward_reference,
    attention_bthd_backward_reference,
)

# f32: the same products, summed in another order over at most 130 keys or
# queries; measured below 7e-7 of max(1, max|grad|), held at 1e-5
ATOL = 1e-5
# bf16: both round P∘mult and dS to bf16 before their products and round the
# gradients to bf16; an entry of P or dS that a sum in another order rounds
# the other way moves a gradient by about one bf16 step (2^-8 relative) of a
# product. Measured 1e-6 of max(1, max|grad|) at most over the first six
# cases and 4.3e-4 over the tile-edge cases, held at 2^-8
BF16_ATOL = 2.0**-8

# (B, Tq, Tk, H, d, causal, mult): self-attention at the conditional ViT's
# head count, cross lengths, ragged T with an odd d, causal, the multiplier,
# and causal with the multiplier
CASES = [
    (2, 19, 19, 4, 8, False, False),
    (2, 7, 11, 2, 16, False, False),
    (1, 37, 37, 3, 5, False, False),
    (2, 24, 24, 2, 8, True, False),
    (2, 13, 9, 2, 8, False, True),
    (1, 21, 21, 2, 12, True, True),
]
IDS = ["self", "cross", "ragged_odd_d", "causal", "mult", "causal_mult"]
# where the bf16 kernels' 64-row tiles and padded head dims can break: T one
# row past a tile at d = 48, two rows past two tiles at d = 13 (padded to 16,
# scalar copies) with causal and the multiplier, and cross lengths across
# tiles with the multiplier
CASES += [
    (1, 65, 65, 2, 48, False, False),
    (1, 130, 130, 1, 13, True, True),
    (2, 65, 130, 2, 16, False, True),
]
IDS += ["t65_d48", "t130_d13_causal_mult", "cross_65_130_mult"]
DTYPES = ["float32", "bfloat16"]


def _torch(x, dtype):
    """A JAX or numpy array as a torch tensor of ``dtype`` (bf16 values
    carried exactly through f32)."""
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _jax(x):
    """A torch tensor as a JAX array of its dtype."""
    if x is None:
        return None
    return jnp.asarray(x.float().numpy(), str(x.dtype).replace("torch.", ""))


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = (ATOL if dtype == "float32" else BF16_ATOL) * max(1.0, np.abs(want).max())
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,tq,tk,h,d,causal,mult", CASES, ids=IDS)
def test_bthd_backward_reference_matches_pallas(b, tq, tk, h, d, causal, mult, dtype):
    """dq, dk, dv against ``_bthd_bwd_call(..., interpret=True)``."""
    rng = np.random.default_rng(tq * tk + d)
    q, dout = (rng.standard_normal((b, tq, h * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, tk, h * d)).astype(np.float32) for _ in range(2))
    m = ((rng.random((tq, tk)) < 0.8) / 0.8).astype(np.float32) if mult else None
    scale = 1.0 / np.sqrt(d)
    pq, pk, pv, pdo = (_torch(x, dtype) for x in (q, k, v, dout))
    pm = None if m is None else _torch(m, dtype)
    out, lse = attention.attention_bthd_reference(pq, pk, pv, h, scale, causal, pm)
    want = _bthd_bwd_call(*(_jax(x) for x in (pq, pk, pv, pm, out)), _jax(lse)[..., None],
                          _jax(pdo), h, scale, causal, True)
    got = attention_bthd_backward_reference(pq, pk, pv, out, lse, pdo, h, scale, causal, pm)
    assert [g.shape for g in got] == [(b, tq, h * d), (b, tk, h * d), (b, tk, h * d)]
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,t,d", [(2, 4, 19, 32), (1, 3, 37, 5)], ids=["vit", "ragged"])
def test_bhtc_backward_reference_matches_pallas(b, h, t, d, dtype):
    """dq, dk, dv against the gradient of ``fused_attention(interpret=True)``,
    whose backward is ``_fused_bwd`` (row 4); the CPU entry's gradient runs
    the same plain backward."""
    rng = np.random.default_rng(t + d)
    q, k, v, dout = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, dout))
    out, vjp = jax.vjp(lambda q, k, v: fused_attention(q, k, v, scale, interpret=True),
                       jq, jk, jv)
    want = vjp(jdo)
    _, lse = attention.attention_bhtc_reference(*(_torch(x, dtype) for x in (jq, jk, jv)),
                                                scale)
    got = attention_bhtc_backward_reference(*(_torch(x, dtype) for x in (jq, jk, jv, out)),
                                            lse, _torch(jdo, dtype), scale)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    tq, tk, tv = (_torch(x, dtype).requires_grad_() for x in (jq, jk, jv))
    attention.fused_attention(tq, tk, tv, scale).backward(_torch(jdo, dtype))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, w, dtype)


def test_cpu_backward_launches_nothing_and_copies_a_strided_dout():
    """A CPU tensor's backward runs the plain version (no launch); a
    non-contiguous dout is copied once and counted, as on the card."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 6, 8)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    counts = (attention.bthd_bwd_launch_count, attention.bhtc_bwd_launch_count)
    copies = attention.dout_copies
    out = attention.fused_attention_bthd(q, k, v, 2)
    dout = torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(np.float32)).transpose(1, 2)
    out.backward(dout)
    assert attention.dout_copies == copies + 1
    assert (attention.bthd_bwd_launch_count, attention.bhtc_bwd_launch_count) == counts
    o, lse = attention.attention_bthd_reference(q.detach(), k.detach(), v.detach(), 2, 0.5)
    want = attention_bthd_backward_reference(q.detach(), k.detach(), v.detach(), o, lse,
                                             dout.contiguous(), 2, 0.5)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)
