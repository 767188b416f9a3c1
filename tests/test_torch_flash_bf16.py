"""The bf16 numerics of the port's flash kernels K1, K2 and K3 against
the Pallas TPU kernels, on the CPU.

On the card, the bf16 K1, K2 and K3 (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) round P (K1, K2) and dS (K2, K3) to
bf16 before their second product, as the TPU kernels ``_fwd_kernel``,
``_dkv_kernel`` and ``_dq_kernel`` do; the plain versions they are held
against keep P and dS in f32. These tests show that the tolerance the
card holds them to (worst per-row relative L2 error 1e-2,
chip_smoke.py) covers those roundings: K1's plain version in bf16
against the Pallas forward in interpret mode, in bf16, on the same
seeded inputs, at that tolerance; K2's and K3's plain versions against
the same arithmetic with the kernel's roundings at that tolerance, and
against the Pallas ``_dkv_kernel`` and ``_dq_kernel``, which also round
exp's argument to bf16, at 2.5e-2.
The wrappers fold sm_scale into q as the JAX wrapper does; ``fold_scale``
is that fold bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops.pallas import flash_attention as JF

from ray_tpu_torch.ops import flash_attention as TF

ROW_REL_TOL = 1e-2     # chip_smoke.py's K1_ROW_REL_TOL and BWD_ROW_REL_TOL
# lse: both sides fold q' identically and take the max of the same bf16
# products; the Pallas kernel sums exp rounded to bf16 (2^-9 relative per
# term), the plain version sums f32 exp: ~1e-3 of lse's log-sum at most.
LSE_ABS_TOL = 2e-3
# K2 and K3 against the Pallas _dkv_kernel and _dq_kernel: see K2's test
PALLAS_DKV_ROW_REL_TOL = 2.5e-2


def _row_rel(got, want) -> float:
    """Worst |got - want|_2 / |want|_2 over the last dim, a row's norm
    floored at 1e-3 of the mean row norm (chip_smoke.row_rel)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    diff = np.linalg.norm(got - want, axis=-1)
    ref = np.linalg.norm(want, axis=-1)
    return float((diff / np.maximum(ref, 1e-3 * ref.mean() + 1e-30)).max())


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 and back to f32 numpy, so both sides read the same
    values."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    q, do = (_bf16(rng.normal(size=(b, s, h, d))) for _ in range(2))
    k, v = (_bf16(rng.normal(size=(b, s, kvh, d))) for _ in range(2))
    return q, k, v, do


def _flat(x, h):
    """(b, s, heads, d) -> (b * h, s, d) bf16 with kv heads repeated per
    query head, the Pallas kernels' layout."""
    b, s, n, d = x.shape
    x = np.repeat(x, h // n, axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d)
                       ).astype(jnp.bfloat16)


def _unflat(x, b, h):
    x = np.asarray(jnp.asarray(x).astype(jnp.float32))
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


CASES = [
    # b, s, h, kvh, d, causal
    (1, 128, 4, 2, 64, True),
    (1, 256, 2, 1, 128, True),
    (2, 128, 4, 4, 128, False),
    (1, 200, 4, 1, 64, True),     # ragged: the Pallas wrapper pads to 128
]
IDS = ["gqa2_d64", "gqa2_d128_two_tiles", "b2_full", "ragged_gqa4"]


def _torch(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,h,kvh,d,causal", CASES, ids=IDS)
def test_bf16_fwd_plain_matches_pallas_fwd_kernel(b, s, h, kvh, d, causal):
    """K1 with lse: the plain version (P in f32) against ``_fwd_kernel``
    (P in bf16), both in bf16."""
    q, k, v, _ = _inputs(b + s + d, b, s, h, kvh, d)
    scale = d ** -0.5
    o_j, lse_j = JF.flash_attention_fwd(_flat(q, h), _flat(k, h),
                                        _flat(v, h), sm_scale=scale,
                                        causal=causal, interpret=True)
    o_j = _unflat(o_j, b, h)
    lse_j = np.asarray(lse_j)[:, :, 0].reshape(b, h, s)
    o, lse = TF.flash_attention_fwd_reference(_torch(q), _torch(k),
                                              _torch(v), causal=causal)
    assert o.dtype == torch.bfloat16
    assert _row_rel(o.float().numpy(), o_j) <= ROW_REL_TOL
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=LSE_ABS_TOL, rtol=0)


def _dkv_with_kernel_rounding(q, k, v, do, lse, delta, scale, causal):
    """K2's arithmetic as the bf16 kernel rounds it: p = exp(s - lse) in
    f32 rounded to bf16, dS = p (dp - delta) from the rounded p rounded to
    bf16, f32 sums, each output rounded once."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    keep = TF._keep_mask(sq, sk, causal, sk - sq, q.device)
    qs = TF._scaled_q(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, TF._repeat_kv(k, h).float())
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s)).bfloat16().float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      TF._repeat_kv(v, h).float())
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    dv = TF._group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do.float()), kvh)
    dk = TF._group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, qs), kvh)
    return dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("b,s,h,kvh,d,causal", CASES, ids=IDS)
def test_bf16_dkv_plain_against_kernel_rounding_and_pallas(b, s, h, kvh, d,
                                                           causal):
    """K2 on the Pallas forward's o and lse. (1) The card kernel's
    roundings of P and dS to bf16 move dK/dV from the plain version (P,
    dS in f32) by ~4-6e-3 per row: inside the card's 1e-2. (2) The Pallas
    ``_dkv_kernel`` also takes exp of an argument rounded to bf16 (the
    TPU's vector-unit speed trick: at |s - lse| ~ 10 a 2^-9 rounding of
    the argument is ~2e-2 of p), which moves it 1.1-2.0e-2 per row from the plain version and
    from the card's roundings alike: held at PALLAS_DKV_ROW_REL_TOL. The
    Pallas dK/dV per query head are summed over each kv head's group."""
    q, k, v, do = _inputs(7 + b + s + d, b, s, h, kvh, d)
    scale = d ** -0.5
    flat = [_flat(x, h) for x in (q, k, v)]
    o_j, lse_j = JF.flash_attention_fwd(*flat, sm_scale=scale, causal=causal,
                                        interpret=True)
    _, dk_j, dv_j = JF.flash_attention_bwd(*flat, o_j, _flat(do, h), lse_j,
                                           sm_scale=scale, causal=causal,
                                           interpret=True)
    g = h // kvh
    dk_j, dv_j = (_unflat(x, b, h).reshape(b, s, kvh, g, d).sum(3)
                  for x in (dk_j, dv_j))
    o = _torch(_unflat(o_j, b, h))
    lse = torch.from_numpy(np.asarray(lse_j)[:, :, 0].reshape(b, h, s).copy())
    args = [_torch(x) for x in (q, k, v, do)]
    delta = TF.attention_delta(o, args[3])
    dk, dv = TF.flash_attention_bwd_dkv_reference(*args, lse, delta,
                                                  causal=causal)
    assert dk.dtype == dv.dtype == torch.bfloat16
    dk_r, dv_r = _dkv_with_kernel_rounding(*args, lse, delta, scale, causal)
    for got, want in ((dk_r, dk), (dv_r, dv)):
        assert _row_rel(got.float().numpy(), want.float().numpy()) \
            <= ROW_REL_TOL
    assert _row_rel(dv.float().numpy(), dv_j) <= PALLAS_DKV_ROW_REL_TOL
    assert _row_rel(dk.float().numpy(), dk_j) <= PALLAS_DKV_ROW_REL_TOL


def _dq_with_kernel_rounding(q, k, v, do, lse, delta, scale, causal):
    """K3's arithmetic as the bf16 kernel rounds it: q' folded (rounded
    to bf16), p = exp(s - lse) in f32, dS = p (dp - delta) rounded to
    bf16, dQ' = dS k summed in f32, then sm_scale and one rounding."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    keep = TF._keep_mask(sq, sk, causal, sk - sq, q.device)
    kf = TF._repeat_kv(k, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", TF.fold_scale(q, scale).float(), kf)
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      TF._repeat_kv(v, h).float())
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).bfloat16()


@pytest.mark.parametrize("b,s,h,kvh,d,causal", CASES, ids=IDS)
def test_bf16_dq_plain_against_kernel_rounding_and_pallas(b, s, h, kvh, d,
                                                         causal):
    """K3 on the Pallas forward's o and lse. (1) The card kernel rounds dS
    to bf16 before dS k, as the TPU's ``_dq_kernel`` does, and dQ once
    after the scale; the plain version keeps dS in f32: the roundings
    move dQ by a few 1e-3 per row, inside the card's 1e-2. (2) The Pallas
    ``_dq_kernel`` (through ``flash_attention_bwd``) also takes exp of an
    argument rounded to bf16, and rounds dQ' before the scale: held at
    PALLAS_DKV_ROW_REL_TOL, for the reason K2's test gives."""
    q, k, v, do = _inputs(11 + b + s + d, b, s, h, kvh, d)
    scale = d ** -0.5
    flat = [_flat(x, h) for x in (q, k, v)]
    o_j, lse_j = JF.flash_attention_fwd(*flat, sm_scale=scale, causal=causal,
                                        interpret=True)
    dq_j, _, _ = JF.flash_attention_bwd(*flat, o_j, _flat(do, h), lse_j,
                                        sm_scale=scale, causal=causal,
                                        interpret=True)
    dq_j = _unflat(dq_j, b, h)
    o = _torch(_unflat(o_j, b, h))
    lse = torch.from_numpy(np.asarray(lse_j)[:, :, 0].reshape(b, h, s).copy())
    args = [_torch(x) for x in (q, k, v, do)]
    delta = TF.attention_delta(o, args[3])
    dq = TF.flash_attention_bwd_dq_reference(*args, lse, delta, causal=causal)
    assert dq.dtype == torch.bfloat16
    dq_k = _dq_with_kernel_rounding(*args, lse, delta, scale, causal)
    assert dq_k.dtype == torch.bfloat16 and dq_k.shape == dq.shape
    assert _row_rel(dq_k.float().numpy(), dq.float().numpy()) <= ROW_REL_TOL
    assert _row_rel(dq_k.float().numpy(), dq_j) <= PALLAS_DKV_ROW_REL_TOL
    assert _row_rel(dq.float().numpy(), dq_j) <= PALLAS_DKV_ROW_REL_TOL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fold_scale_is_the_jax_wrappers_fold_bitwise(dtype):
    """q' = q * sm_scale rounded to q's dtype, as
    ``ray_tpu/ops/pallas/flash_attention.py:160`` folds it, and as the
    plain versions' ``_scaled_q`` does."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 37, 4, 64)) * 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for scale in (64 ** -0.5, 128 ** -0.5, 0.2, 1.0):
        xj = jnp.asarray(x).astype(jdt)
        want = np.asarray((xj.astype(jnp.float32) * scale).astype(jdt)
                          .astype(jnp.float32))
        xt = torch.from_numpy(x).to(tdt)
        got = TF.fold_scale(xt, scale)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
        np.testing.assert_array_equal(TF._scaled_q(xt, scale).numpy(), want)
