"""The port's flash-attention path (ray_tpu_torch/ops) against the JAX
package: ``attention``/``mha_reference`` on CPU tensors (the kernel's
plain version) vs ``flash_attention(interpret=True)`` and
``mha_reference``.

Inputs are made from a seed with numpy and fed to both. f32 tolerance
2e-5: XLA-CPU and torch-CPU reduce in different orders (the JAX
package's own flash tests use the same bound). The CUDA kernel cannot
run here; chip_smoke.py holds it against this plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import sys

from ray_tpu.ops import attention as _jax_attention_pkg  # noqa: F401
JA = sys.modules["ray_tpu.ops.attention"]

from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.ops import flash_attention as TF

F32_TOL = 2e-5


def _qkv(seed, b=1, sq=40, sk=None, h=4, kvh=4, d=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    q = rng.normal(size=(b, sq, h, d)).astype(dtype)
    k = rng.normal(size=(b, sk, kvh, d)).astype(dtype)
    v = rng.normal(size=(b, sk, kvh, d)).astype(dtype)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


CASES = [
    # name, shape kwargs, attention kwargs
    ("causal", dict(sq=128), dict(causal=True)),
    ("full", dict(sq=96), dict(causal=False)),
    ("gqa", dict(sq=64, h=8, kvh=2), dict(causal=True)),
    ("ragged", dict(sq=100, h=4, kvh=2), dict(causal=True)),
    ("sq_lt_sk", dict(sq=32, sk=160, h=4, kvh=2), dict(causal=True)),
    ("q_offset", dict(sq=64, sk=256, h=4, kvh=2),
     dict(causal=True, q_offset=64)),
    ("q_offset_ragged", dict(sq=48, sk=200, h=8, kvh=2),
     dict(causal=True, q_offset=120)),
    ("batch2", dict(b=2, sq=72), dict(causal=True, sm_scale=0.2)),
]


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_attention_matches_jax_flash_interpret(name, shape, kw):
    q, k, v = _qkv(sum(map(ord, name)), **shape)
    want = np.asarray(JA.flash_attention(*_j(q, k, v), interpret=True,
                                         **kw))
    got = TA.attention(*_t(q, k, v), impl="auto", **kw).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_mha_reference_matches_jax_reference(name, shape, kw):
    q, k, v = _qkv(7 + sum(map(ord, name)), **shape)
    want = np.asarray(JA.mha_reference(*_j(q, k, v), **kw))
    got = TA.mha_reference(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_fully_masked_rows_give_zero():
    """q_offset < 0 leaves the first rows with no key: both packages
    give exactly 0 there."""
    q, k, v = _qkv(3, sq=16, sk=16, h=2, kvh=1, d=64)
    got = TA.attention(*_t(q, k, v), causal=True, q_offset=-4).numpy()
    want = np.asarray(JA.mha_reference(*_j(q, k, v), causal=True,
                                       q_offset=-4))
    assert np.all(got[:, :4] == 0) and np.all(want[:, :4] == 0)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_matches_jax():
    """bf16 inputs: both sides compute the softmax in f32 and round the
    output to bf16, which is 2^-8 relative; outputs here are below ~3 in
    magnitude, so 2e-2 absolute covers a one-ulp disagreement after
    different f32 summation orders."""
    q, k, v = _qkv(11, sq=64, h=4, kvh=2)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(JA.mha_reference(qj, kj, vj, causal=True),
                      np.float32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = TA.attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_attention_rejects_unknown_impl():
    q, k, v = _t(*_qkv(0, sq=4, d=64))
    with pytest.raises(ValueError, match="unknown attention impl"):
        TA.attention(q, k, v, impl="flash_interpret")


def test_work_counts_causal_pairs():
    """The bound's operation count: a causal square of s rows keeps
    s(s+1)/2 (query, key) pairs; q_offset shifts the diagonal."""
    w = TF.work(1, 8, 8, 2, 1, 64, 2)
    assert w["flops"] == 4 * 64 * 2 * 36
    assert w["bytes"] == 2 * 64 * (2 * 8 * 2 + 2 * 8 * 1)
    w = TF.work(1, 4, 16, 1, 1, 64, 2, q_offset=8)
    assert w["flops"] == 4 * 64 * (9 + 10 + 11 + 12)
    assert w["bytes"] == 2 * 64 * (2 * 4 + 2 * 12)
