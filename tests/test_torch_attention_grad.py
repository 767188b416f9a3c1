"""The port's attention backward (ray_tpu_torch/ops) against the JAX
package: gradients through ``attention`` on CPU tensors (the ``_Flash``
autograd Function with its plain bodies) and through
``flash_attention_bwd_reference`` directly, against ``jax.grad`` through
``ray_tpu.ops.attention.flash_attention(..., interpret=True)`` (the
Pallas K1/K2/K3 kernels in interpret mode); the forward's lse against
the Pallas forward's.

Inputs and the output cotangent are made from a seed with numpy and fed
to both. f32 tolerance 5e-5: XLA-CPU and torch-CPU reduce in different
orders, and the gradients sum over up to 128 keys and 4 query heads of
values up to ~10 (observed differences stay below 3e-6). The CUDA
kernels cannot run here; chip_smoke.py and tests/test_torch_cuda.py hold
them against these plain versions on the card.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as _jax_attention_pkg  # noqa: F401
from ray_tpu.ops.pallas import flash_attention as JF
JA = sys.modules["ray_tpu.ops.attention"]

from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.ops import flash_attention as TF

GRAD_TOL = 5e-5
F32_TOL = 2e-5


def _inputs(seed, b=1, sq=64, sk=None, h=4, kvh=4, d=64):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    w = rng.normal(size=(b, sq, h, d)).astype(np.float32)   # cotangent
    return q, k, v, w


CASES = [
    # name, shape kwargs, attention kwargs
    ("causal", dict(sq=128), dict(causal=True)),
    ("full", dict(sq=96), dict(causal=False)),
    ("gqa", dict(sq=64, h=8, kvh=2), dict(causal=True)),
    ("ragged", dict(sq=100, h=4, kvh=2), dict(causal=True)),
    ("batch2_scale", dict(b=2, sq=72), dict(causal=True, sm_scale=0.2)),
    ("sq_gt_sk", dict(sq=96, sk=48, h=4, kvh=2), dict(causal=True)),
]
IDS = [c[0] for c in CASES]


def _jax_grads(q, k, v, w, kw):
    def f(q, k, v):
        return jnp.sum(JA.flash_attention(q, k, v, interpret=True, **kw) * w)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_attention_grad_matches_jax_flash_interpret(name, shape, kw):
    q, k, v, w = _inputs(sum(map(ord, name)), **shape)
    want = _jax_grads(q, k, v, w, kw)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = TA.attention(qt, kt, vt, impl="auto", **kw)
    assert out.grad_fn is not None and "_Flash" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_bwd_reference_matches_jax_flash_interpret(name, shape, kw):
    q, k, v, w = _inputs(3 + sum(map(ord, name)), **shape)
    want = _jax_grads(q, k, v, w, kw)
    qt, kt, vt, wt = (torch.from_numpy(x) for x in (q, k, v, w))
    o, lse = TF.flash_attention_fwd_reference(qt, kt, vt, **kw)
    got = TF.flash_attention_bwd_reference(qt, kt, vt, o, wt, lse, **kw)
    for g, ref in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), ref, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_forward_lse_matches_jax_kernel(name, shape, kw):
    """lse (b, h, sq) f32 against the Pallas forward's lane-broadcast lse
    column 0; o against its output. Fully masked rows (sq > sk) give
    -1e30 on both sides."""
    q, k, v, _ = _inputs(5 + sum(map(ord, name)), **shape)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = kw.get("sm_scale") or d ** -0.5
    kr = np.repeat(k, h // k.shape[2], axis=2)
    vr = np.repeat(v, h // v.shape[2], axis=2)
    flat = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, d))
            for x in (q, kr, vr)]
    o_j, lse_j = JF.flash_attention_fwd(*flat, sm_scale=scale,
                                        causal=kw["causal"], interpret=True)
    o_j = np.asarray(o_j).reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j)[:, :, 0].reshape(b, h, sq)
    o, lse = TF.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                    with_lse=True, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(o.numpy(), o_j, atol=F32_TOL, rtol=F32_TOL)
    if sq > sk:
        assert np.all(lse.numpy()[:, :, :sq - sk] == -1e30)


def test_fully_masked_rows_get_zero_gradient():
    """sq > sk: the first sq - sk query rows keep no key; their dq is 0
    and they add nothing to dk/dv."""
    q, k, v, w = _inputs(9, sq=40, sk=24, h=2, kvh=1)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (TA.attention(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    assert torch.all(qt.grad[:, :16] == 0)
    assert torch.all(qt.grad[:, 16:].abs().sum(-1) > 0)


def test_reference_impl_grad_matches_jax_reference():
    """impl='reference' is plain autograd through ``mha_reference``."""
    q, k, v, w = _inputs(11, sq=48, h=4, kvh=2)

    def f(q, k, v):
        return jnp.sum(JA.mha_reference(q, k, v, causal=True) * w)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = TA.attention(qt, kt, vt, impl="reference")
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_kernel_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors K2's and K3's wrappers are their plain versions and
    count no launch; together they give flash_attention_bwd."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(13, sq=32, h=4,
                                                       kvh=2))
    o, lse = TF.flash_attention_fwd(q, k, v, with_lse=True)
    delta = TF.attention_delta(o, w)
    assert delta.shape == (1, 4, 32)
    before = (TF.flash_attention_bwd_dkv.launches,
              TF.flash_attention_bwd_dq.launches,
              TF.flash_attention_fwd.launches)
    dk, dv = TF.flash_attention_bwd_dkv(q, k, v, w, lse, delta)
    dq = TF.flash_attention_bwd_dq(q, k, v, w, lse, delta)
    ref = TF.flash_attention_bwd_reference(q, k, v, o, w, lse)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
    assert (TF.flash_attention_bwd_dkv.launches,
            TF.flash_attention_bwd_dq.launches,
            TF.flash_attention_fwd.launches) == before


def test_q_offset_with_grad_raises():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, sq=8, d=64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        TA.attention(q, k, v, q_offset=0)
    with torch.no_grad():
        assert TA.attention(q, k, v, q_offset=0).shape == q.shape


def test_work_bwd_counts_causal_pairs():
    """K2 does 8*d and K3 6*d flops per kept pair (a causal square of s
    rows keeps s(s+1)/2); bytes count q, dO, k, v, lse, delta once and
    the outputs once."""
    w = TF.work_bwd(1, 8, 8, 2, 1, 64, 2)
    pairs = 2 * 36
    assert w["dkv"]["flops"] == 8 * 64 * pairs
    assert w["dq"]["flops"] == 6 * 64 * pairs
    rows = 2 * 64 * 2 * 8 * 2 + 2 * 4 * 2 * 8
    kv = 2 * 64 * 2 * 8 * 1
    assert w["dkv"]["bytes"] == rows + 2 * kv
    assert w["dq"]["bytes"] == rows + kv + 2 * 64 * 8 * 2
    full = TF.work_bwd(2, 4, 16, 2, 2, 64, 4, causal=False)
    assert full["dq"]["flops"] == 6 * 64 * 2 * 2 * 4 * 16
