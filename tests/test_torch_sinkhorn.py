"""The port's Sinkhorn (ot_vae_tpu_torch/ops/sinkhorn.py, ops/w2.py) against
the JAX package's on the CPU.

The plain per-instance version stands in for the CUDA kernel on CPU tensors
and is held to the Pallas kernel in interpret mode; the batch path is held
to the XLA ``sinkhorn_log``. chip_smoke.py holds the CUDA kernel to the
plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ot_vae_tpu.distributions.codebook import CodebookModel as JaxCodebookModel
from ot_vae_tpu.ops.sinkhorn_pallas import sinkhorn_log_pallas
from ot_vae_tpu.ops.w2 import sinkhorn_log as jax_sinkhorn_log
from ot_vae_tpu_torch.ops import sinkhorn
from ot_vae_tpu_torch.ops.sinkhorn import (
    sinkhorn_log_auto,
    sinkhorn_log_kernel,
    sinkhorn_log_kernel_reference,
)
from ot_vae_tpu_torch.ops.w2 import sinkhorn_log

# f32 on both sides, the same update order; logsumexp sums in another order
# over at most 20 terms per step, iterated: plan entries measured within
# 5e-8 of each other at a largest entry of 0.18. Held at 1e-5 of the
# largest entry.
PLAN_RTOL = 1e-5


def _problem(batch, n, m, seed, scales=None):
    """Normalised weights and costs in [0, 1], scaled per instance (smaller
    costs converge in fewer iterations)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 1.0, (batch, n)).astype(np.float32)
    b = rng.uniform(0.1, 1.0, (batch, m)).astype(np.float32)
    cost = rng.uniform(0.0, 1.0, (batch, n, m)).astype(np.float32)
    if scales is not None:
        cost *= np.asarray(scales, np.float32)[:, None, None]
    return a / a.sum(-1, keepdims=True), b / b.sum(-1, keepdims=True), cost


def _assert_plan_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PLAN_RTOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n,m", [(9, 9), (12, 20)])
def test_plain_per_instance_matches_pallas_interpret(n, m):
    """A batch of 2 whose instances stop at different iterations, square and
    ragged (N ≠ M)."""
    a, b, cost = _problem(2, n, m, seed=n + m, scales=[1.0, 0.2])
    kw = dict(reg=0.05, max_iter=300, threshold=1e-4)
    want = sinkhorn_log_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cost),
                               interpret=True, **kw)
    got = sinkhorn_log_kernel_reference(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(cost), return_extra=True, **kw)
    iters = got.num_iters.tolist()
    assert iters[0] != iters[1] and max(iters) < 300, iters
    _assert_plan_close(got.plan.numpy(), want)


@pytest.mark.parametrize("batch_shape", [(), (3,)])
def test_batch_sinkhorn_matches_xla(batch_shape):
    """The batch path stops on the batch's worst instance, as the XLA one."""
    batch = int(np.prod(batch_shape))
    a, b, cost = _problem(batch, 10, 14, seed=batch, scales=[1.0, 0.5, 0.1][:batch])
    a, b, cost = (x.reshape(*batch_shape, *x.shape[1:]) for x in (a, b, cost))
    kw = dict(reg=0.05, max_iter=300, threshold=1e-4)
    want = jax_sinkhorn_log(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cost),
                            return_extra=True, **kw)
    got = sinkhorn_log(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(cost),
                       return_extra=True, **kw)
    assert int(got.num_iters) == int(want.num_iters)
    _assert_plan_close(got.plan.numpy(), want.plan)


def test_marginals_at_the_path_reg():
    """At reg 1e-5 on codebook costs, |Cr| reaches 1e5, where an f32 ulp is
    about 0.008: exp(u + v + Cr) carries percent-level error in either
    package and the entries are not compared. Both run all 1000 iterations
    (err stays far above 1e-6), and the port's plan is as close to the
    marginals a and b as the JAX package's, within a quarter of the JAX
    error, and its total cost within 1e-3."""
    rng = np.random.default_rng(7)
    model = JaxCodebookModel(dim=16, n_components=32)
    src = rng.standard_normal((32, 16)).astype(np.float32)
    tgt = 1.3 * rng.standard_normal((32, 16)).astype(np.float32)
    cost = np.array(1.0 / (model.energy(jnp.asarray(tgt), jnp.asarray(src)) + 1e-8))
    a = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    b = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    a, b = a / a.sum(), b / b.sum()
    kw = dict(reg=1e-5, max_iter=1000, threshold=1e-6)
    want = jax_sinkhorn_log(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cost),
                            return_extra=True, **kw)
    got = sinkhorn_log_auto(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(cost),
                            return_extra=True, **kw)
    assert int(want.num_iters) == 1000 and int(got.num_iters) == 1000
    plan_j, plan_t = np.asarray(want.plan), got.plan.numpy()
    for axis, marginal in ((1, a), (0, b)):
        err_j = np.abs(plan_j.sum(axis) - marginal).max()
        err_t = np.abs(plan_t.sum(axis) - marginal).max()
        assert err_t <= 1.25 * err_j + 1e-7, (axis, err_t, err_j)
    np.testing.assert_allclose((cost * plan_t).sum(), (cost * plan_j).sum(), rtol=1e-3)


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    a, b, cost = (torch.from_numpy(x) for x in _problem(2, 6, 7, seed=3))
    before = sinkhorn.launch_count
    got = sinkhorn_log_auto(a, b, cost, reg=0.05, max_iter=50, threshold=1e-4)
    want = sinkhorn_log_kernel_reference(a, b, cost, reg=0.05, max_iter=50, threshold=1e-4)
    assert torch.equal(got, want) and sinkhorn.launch_count == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        sinkhorn_log_kernel(a, b, cost)


# Dynamic shared memory a CTA, as the kernel report printed it on an H100.
SMEM_ON_THE_CARD = {(256, 256): 38592, (1024, 1024): 231168}


@pytest.mark.parametrize("n,m,resident,streamed,slices", [
    (256, 256, 32, 0, 2),  # the path's shape: every row in shared memory
    (1024, 1024, 53, 75, 1),  # Cr is 4 MB: part of each band streamed from L2
    (5, 300, 1, 0, 1),  # fewer rows than CTAs: CTAs 5 to 7 hold empty bands
    (37, 200, 5, 0, 2),
])
def test_launch_plan(n, m, resident, streamed, slices):
    """Bands of ceil(N / CLUSTER) rows, as many of them resident as fit beside
    v, u and the row-pass partials, within the shared memory a block may
    have."""
    lp = sinkhorn._launch_plan(n, m)
    rows = -(-n // sinkhorn.CLUSTER)
    assert lp.cluster == sinkhorn.CLUSTER >= 8
    assert (lp.rows, lp.resident, lp.streamed, lp.slices) == (rows, resident, streamed, slices)
    assert lp.resident + lp.streamed == lp.rows and lp.cluster * lp.rows >= n
    assert lp.smem_bytes <= sinkhorn.MAX_SHARED_BYTES
    if (n, m) in SMEM_ON_THE_CARD:
        assert lp.smem_bytes == SMEM_ON_THE_CARD[n, m]
    if streamed:  # one more resident row would not fit
        assert lp.smem_bytes + 4 * m > sinkhorn.MAX_SHARED_BYTES
    bands = [range(min(r * rows, n), min((r + 1) * rows, n)) for r in range(lp.cluster)]
    assert sum(map(len, bands)) == n
    assert (n >= lp.cluster) == all(bands)


def test_launch_plan_limit():
    """The fixed part grows by about 12.5 bytes a column (v, the inbox of
    partials and the column slice's log b) and 8 bytes a band row: M =
    18,572 is the widest an N = 1 instance may be; N = M = 14,000 (N + M =
    28,000, the limit of the single-block kernel before) plans with every
    row streamed, and N = 1,000, M = 27,000, within that old limit, now
    raises."""
    assert sinkhorn._launch_plan(1, 18572).resident == 0
    with pytest.raises(ValueError, match="shared memory"):
        sinkhorn._launch_plan(1, 18573)
    assert sinkhorn._launch_plan(14000, 14000)[1:4] == (1750, 0, 1750)
    with pytest.raises(ValueError, match="shared memory"):
        sinkhorn._launch_plan(1000, 27000)


def test_cuda_call_reaches_the_kernel_symbol(monkeypatch):
    """On a CUDA tensor the dispatcher calls the library's ``sinkhorn_log``
    with the launch plan's arguments, f32 inputs flattened to [B, …], and
    fresh outputs: a plan [B, N, M], int32 iters [B] and f32 err [B]; no call
    reaches the plain version. The C call is recorded, not run."""
    calls, made = [], {}

    def record(symbol, argtypes, args, device):
        assert len(argtypes) == len(args)
        calls.append((symbol, args))

    def tracked(make):
        def wrapper(*args, **kwargs):
            x = make(*args, **kwargs)
            made[x.data_ptr()] = (tuple(x.shape), x.dtype)
            return x
        return wrapper

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(sinkhorn, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(sinkhorn, "_call", record)
    monkeypatch.setattr(sinkhorn, "sinkhorn_log_kernel_reference", refuse)
    monkeypatch.setattr(torch, "empty", tracked(torch.empty))
    monkeypatch.setattr(torch, "empty_like", tracked(torch.empty_like))
    a, b, cost = (torch.from_numpy(x) for x in _problem(2, 5, 300, seed=11))
    before = sinkhorn.launch_count
    got = sinkhorn_log_auto(a, b, cost, reg=0.05, max_iter=77, threshold=1e-4,
                            return_extra=True)
    assert sinkhorn.launch_count == before + 1
    (symbol, args), = calls
    assert symbol == "sinkhorn_log"
    lp = sinkhorn._launch_plan(5, 300)
    assert args[6:] == [2, 5, 300, lp.cluster, lp.rows, lp.resident, lp.slices, lp.smem_bytes,
                        0.05, 77, 1e-4]
    assert args[:3] == [a.data_ptr(), b.data_ptr(), cost.data_ptr()]
    plan_p, iters_p, err_p = args[3:6]
    assert made[plan_p] == ((2, 5, 300), torch.float32) and plan_p == got.plan.data_ptr()
    assert made[iters_p] == ((2,), torch.int32) and iters_p == got.num_iters.data_ptr()
    assert made[err_p] == ((2,), torch.float32) and err_p == got.err.data_ptr()
    assert got.plan.shape == (2, 5, 300)
