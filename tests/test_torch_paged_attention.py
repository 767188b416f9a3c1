"""The port's paged decode attention (ray_tpu_torch/ops/paged_attention)
against the JAX package's Pallas kernel run in interpret mode.

On CPU tensors the port's ``paged_attention`` runs its plain version
(gather-then-softmax); the JAX kernel runs an online softmax through the
Pallas interpreter. They agree to f32 rounding (tolerance 2e-6, the JAX
package's own kernel-vs-reference bound), and bitwise on the
power-of-two integer construction where both summation orders are exact.
The CUDA kernel cannot run here; chip_smoke.py holds it against the
plain version on the card. Its split-and-combine arithmetic (each slot's
walk cut across blocks, the partials added in split order) is written
out in torch here and held against both at the same tolerance.
"""

import math

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


def _split_combine(q, k_pool, v_pool, tables, lengths, span):
    """The CUDA kernel's arithmetic written out in torch: each slot's walk
    cut into splits of ``span`` table entries; every split that holds a
    live position keeps its own max m_s, sum l_s and unnormalised acc_s
    (f32); a slot with one such split divides acc by l (l == 0 -> 1), and
    otherwise the splits are rescaled to their common max and added in
    split order."""
    b, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    out = torch.zeros((b, kvh, g, hd), dtype=torch.float32)
    for slot in range(b):
        length = int(lengths[slot])
        live = -(-length // bs) if length > 0 else 0
        n_live = max(1, -(-live // span))
        parts = []
        for sp in range(n_live):
            ents = tables[slot, sp * span:min((sp + 1) * span, live)].long()
            k = k_pool[ents].reshape(-1, kvh, hd).float()
            v = v_pool[ents].reshape(-1, kvh, hd).float()
            pos = sp * span * bs + torch.arange(k.shape[0])
            s = torch.einsum("kgd,tkd->kgt", q[slot].float(), k) / math.sqrt(hd)
            s = torch.where(pos < length, s, torch.full_like(s, -1e30))
            m = s.max(-1, keepdim=True).values if k.shape[0] else \
                torch.full((kvh, g, 1), -1e30)
            p = torch.where(pos < length, torch.exp(s - m),
                            torch.zeros_like(s))
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgt,tkd->kgd", p, v)))
        if n_live == 1:
            _, l, acc = parts[0]
            out[slot] = acc / torch.where(l == 0, torch.ones_like(l), l)
            continue
        top = torch.stack([m for m, _, _ in parts]).max(0).values
        num = torch.zeros((kvh, g, hd))
        den = torch.zeros((kvh, g, 1))
        for m, l, acc in parts:
            w = torch.exp(m - top)
            num, den = num + w * acc, den + w * l
        out[slot] = num * (1.0 / den)
    return out


@pytest.fixture(scope="module")
def split_case():
    """8 slots at hd 128, bs 16, g 4, table width 64 (1024 positions):
    lengths on both sides of split edges for spans of 1, 4 and 13
    entries, length 1, a full table, and a trash row (table all block 0,
    length 1); the JAX kernel's output in interpret mode, once."""
    b, w, bs, kvh, g, hd = 8, 64, 16, 2, 4, 128
    q, k, v, tables = _case(5, b=b, w=w, bs=bs, kvh=kvh, g=g, hd=hd)
    tables[3] = 0
    lengths = np.asarray([1, 1024, 63, 1, 65, 208, 209, 833], np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True))
    ref = tpa.paged_attention_reference(*(torch.from_numpy(x) for x in
                                          (q, k, v, tables, lengths)))
    return q, k, v, tables, lengths, want, ref.numpy()


@pytest.mark.parametrize("span", [1, 4, 13])
def test_split_combine_matches_jax_kernel_and_reference(split_case, span):
    """The split-and-combine arithmetic of the CUDA kernel (spans of 1, 4
    and 13 entries: 16, 64 and 208 positions, the last split of a slot
    ragged) against the Pallas kernel's single online softmax and the
    gather reference: the same f32 math summed in another order."""
    q, k, v, tables, lengths, want, ref = split_case
    got = _split_combine(*(torch.from_numpy(x) for x in
                           (q, k, v, tables, lengths)), span).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got[3], np.broadcast_to(
        v[0, 0][:, None, :], got[3].shape), rtol=1e-6, atol=1e-6)


def test_split_span_fills_the_card_from_the_width_alone():
    """8 slots x 8 kv heads on 132 SMs get at least 2 x 132 split blocks;
    a split never exceeds the width nor three 64-position stages; one
    slot on a narrow table gets one entry per split; the span depends on
    no length."""
    span = tpa.split_span(8, 8, 64, 16, 132)
    assert 8 * 8 * -(-64 // span) >= 2 * 132
    for slots, kvh, width, bs in ((1, 8, 64, 16), (64, 8, 64, 16),
                                  (5, 2, 6, 8), (8, 8, 2048, 16),
                                  (8, 8, 384, 8), (8, 8, 96, 32),
                                  (1, 1, 1, 32), (1, 1, 3072, 16)):
        sp = tpa.split_span(slots, kvh, width, bs, 132)
        assert 1 <= sp <= width and sp * bs <= 192
        assert -(-width // sp) <= tpa._MAX_SPLITS
    assert tpa.split_span(1, 2, 16, 16, 132) == 1
    # max_len 2048 / 4096 / 32768 at 8 slots: two stages, then three (the
    # cap)
    assert [tpa.split_span(8, 8, w, 16, 132) for w in (128, 256, 2048)] \
        == [8, 12, 12]


def test_arrival_counters_are_kept_per_stream_and_grown():
    """The split blocks' counters start at zero, are the same tensor on
    the next call on the same stream (the kernel leaves them zero), are
    another tensor on another stream, and grow when a launch needs
    more."""
    dev = torch.device("cpu")
    first = tpa._counters(dev, 11, 10)
    assert first.dtype == torch.int32 and first.numel() >= 10
    assert not first.any()
    assert tpa._counters(dev, 11, 10) is first
    assert tpa._counters(dev, 12, 10) is not first
    grown = tpa._counters(dev, 11, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any()
    assert tpa._counters(dev, 11, 10) is grown


def test_work_counts_live_positions():
    w = tpa.work([1, 16, 3], kvh=2, g=4, hd=32, pool_itemsize=2,
                 q_itemsize=2)
    assert w["flops"] == 4 * 32 * 2 * 4 * 20
    assert w["bytes"] == 2 * 20 * 2 * 32 * 2 + 3 * 2 * 4 * 32 * (2 + 4)
