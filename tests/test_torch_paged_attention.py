"""The port's paged decode attention (ray_tpu_torch/ops/paged_attention)
against the JAX package's Pallas kernel run in interpret mode.

On CPU tensors the port's ``paged_attention`` runs its plain version
(gather-then-softmax); the JAX kernel runs an online softmax through the
Pallas interpreter. They agree to f32 rounding (tolerance 2e-6, the JAX
package's own kernel-vs-reference bound), and bitwise on the
power-of-two integer construction where both summation orders are exact.
The CUDA kernel cannot run here; chip_smoke.py holds it against the
plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops.pallas import paged_attention as jpa

from ray_tpu_torch.ops import paged_attention as tpa

F32_TOL = 2e-6


def _case(seed, *, b, w, bs, kvh, g, hd, nb=None, int_v=False,
          const_k=False):
    rng = np.random.default_rng(seed)
    nb = 1 + b * w if nb is None else nb
    q = rng.normal(size=(b, kvh, g, hd)).astype(np.float32)
    k = (np.ones((nb, bs, kvh, hd), np.float32) if const_k else
         rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32))
    v = (rng.integers(-8, 8, size=(nb, bs, kvh, hd)).astype(np.float32)
         if int_v else rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32))
    tables = (1 + np.arange(b * w)).reshape(b, w).astype(np.int32)
    return q, k, v, tables


def _both(q, k, v, tables, lengths):
    lengths = np.asarray(lengths, np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True))
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("bs,g,hd", [(8, 2, 16), (16, 4, 32)])
def test_uneven_lengths_match_jax_kernel(bs, g, hd):
    """Uneven lengths including a single-position slot and a full-table
    slot."""
    b, w, kvh = 4, 4, 2
    q, k, v, tables = _case(0, b=b, w=w, bs=bs, kvh=kvh, g=g, hd=hd)
    got, want = _both(q, k, v, tables, [1, bs - 1, bs + 3, w * bs])
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_trash_rows_for_empty_slots():
    """Empty slots carry length 1 and a table of trash (block 0), as the
    engine sets them: the row reads only trash position 0."""
    b, w, bs, kvh, g, hd = 3, 4, 8, 2, 2, 16
    q, k, v, tables = _case(1, b=b, w=w, bs=bs, kvh=kvh, g=g, hd=hd)
    tables[1] = 0
    got, want = _both(q, k, v, tables, [5, 1, 20])
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[0, 0][:, None, :], (kvh, g, hd)), rtol=1e-6, atol=1e-6)


def test_bitwise_on_integer_pow2_construction():
    """Constant K makes every score equal (weights exactly 1/count),
    integer V makes the weighted sums exact, and power-of-two lengths
    make 1/count exact: the kernel's divide-after and the reference's
    divide-before orders then agree bitwise."""
    b, w, bs, kvh, g, hd = 4, 4, 8, 2, 2, 16
    q, k, v, tables = _case(2, b=b, w=w, bs=bs, kvh=kvh, g=g, hd=hd,
                            int_v=True, const_k=True)
    got, want = _both(q, k, v, tables, [1, 4, 16, 32])
    assert np.array_equal(got, want)


def test_cow_forked_tables_diverge():
    """Two slots share every block (a fork); the fork then copies its
    last block and diverges one position. The parent's row is unchanged,
    the fork's follows its private block, in both packages."""
    b, w, bs, kvh, g, hd = 2, 4, 8, 2, 2, 16
    rng = np.random.default_rng(3)
    q = np.broadcast_to(rng.normal(size=(1, kvh, g, hd)).astype(np.float32),
                        (b, kvh, g, hd)).copy()
    k = rng.normal(size=(8, bs, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(8, bs, kvh, hd)).astype(np.float32)
    shared = np.asarray([[1, 2, 3, 0]] * 2, np.int32)
    before, want_before = _both(q, k, v, shared, [20, 20])
    assert np.array_equal(before[0], before[1])
    k[4], v[4] = k[3], v[3]
    k[4, 19 % bs] += 1.0
    v[4, 19 % bs] -= 1.0
    forked = shared.copy()
    forked[1, 2] = 4
    after, want_after = _both(q, k, v, forked, [20, 20])
    assert np.array_equal(after[0], before[0])
    assert not np.array_equal(after[1], before[1])
    np.testing.assert_allclose(after, want_after, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(before, want_before, rtol=F32_TOL,
                               atol=F32_TOL)


def test_bf16_pool_matches_jax_reference():
    """A bf16 pool: both sides upcast the same bf16 values to f32, so
    only f32 summation order differs (same 2e-6 bound)."""
    b, w, bs, kvh, g, hd = 3, 4, 16, 2, 4, 32
    q, k, v, tables = _case(4, b=b, w=w, bs=bs, kvh=kvh, g=g, hd=hd)
    lengths = np.asarray([1, 33, 64], np.int32)
    kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    got = tpa.paged_attention(torch.from_numpy(q), kb, vb,
                              torch.from_numpy(tables),
                              torch.from_numpy(lengths)).numpy()
    want = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(tables),
        jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_work_counts_live_positions():
    w = tpa.work([1, 16, 3], kvh=2, g=4, hd=32, pool_itemsize=2,
                 q_itemsize=2)
    assert w["flops"] == 4 * 32 * 2 * 4 * 20
    assert w["bytes"] == 2 * 20 * 2 * 32 * 2 + 3 * 2 * 4 * 32 * (2 + 4)
