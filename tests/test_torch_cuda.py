"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax, which the port's
machine need not have). They cover what chip_smoke.py does not: f32
inputs, head_dim 64, block sizes 8/16/32, group sizes 1-8, and masking
edge cases. Tolerances: f32 2e-5 (summation order only; TF32 is off);
bf16 2e-2 absolute + 2e-2 relative (q*scale and the output are rounded
to bf16 once each). The backward kernels sum up to g * s products per
dK/dV entry, so their f32 tolerance is 1e-4; in bf16 each output is
rounded once on both sides (one bf16 ulp, 2^-8 relative), and the bf16
K1, K2 and K3 (wgmma kernels) also round P (K1, K2) and dS (K2, K3) to
bf16 before their second product (~5e-3 per row). The bf16 edge cases
below hold K1, K2 and K3 to chip_smoke.py's worst per-row relative L2
error of 1e-2, a row's norm floored at 1e-3 of the mean row norm (of dK
and dV together for K2, so that a dK that is zero in exact arithmetic is
measured against the gradients' scale; of dQ itself for K3). A query row
that keeps one key has a dQ that is zero in exact arithmetic; K3 there is
held to chip_smoke.py's ONE_KEY_ULPS of the f32 terms' size instead. K4
(split across blocks, partials added in split order) is held to 2e-5 in
both pool dtypes: f32 math on the same values, summed in another order.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FLASH_CASES = [
    # b, sq, sk, h, kvh, causal, q_offset
    (1, 64, 64, 4, 4, True, None),
    (2, 100, 100, 8, 2, True, None),
    (1, 37, 200, 4, 1, True, None),
    (1, 96, 96, 4, 2, False, None),
    (1, 64, 300, 8, 2, True, 128),
    (1, 16, 16, 2, 1, True, -5),        # first rows keep no key -> 0
    (1, 130, 70, 4, 4, True, None),     # sq > sk: negative default offset
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_kernel_matches_plain(dev, dtype, d, case):
    b, sq, sk, h, kvh, causal, off = case
    g = torch.Generator(device=dev).manual_seed(sq * 7 + sk)
    q = torch.randn((b, sq, h, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=dtype)
    v = torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=dtype)
    before = fa.flash_attention_fwd.launches
    got = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    want = fa.mha_reference(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,bs,g", [(64, 8, 1), (64, 16, 2), (64, 32, 8),
                                     (128, 8, 4), (128, 16, 4),
                                     (128, 32, 3)])
def test_paged_kernel_matches_plain(dev, dtype, hd, bs, g):
    slots, kvh, w = 5, 2, 6
    gen = torch.Generator(device=dev).manual_seed(hd + bs + g)
    nb = 1 + slots * w
    q = torch.randn((slots, kvh, g, hd), generator=gen, device=dev,
                    dtype=dtype)
    kp = torch.randn((nb, bs, kvh, hd), generator=gen, device=dev,
                     dtype=dtype)
    vp = torch.randn((nb, bs, kvh, hd), generator=gen, device=dev,
                     dtype=dtype)
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[:slots * w]
    tables = (1 + perm).to(torch.int32).reshape(slots, w)
    tables[3] = 0                                   # an empty slot: trash
    lengths = torch.tensor([1, bs, bs + 1, 1, w * bs], dtype=torch.int32,
                           device=dev)
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    want = pa.paged_attention_reference(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_paged_kernel_bitwise_on_pow2_integer_construction(dev):
    slots, kvh, g, hd, bs, w = 4, 2, 4, 128, 16, 4
    nb = 1 + slots * w
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((slots, kvh, g, hd), generator=gen, device=dev)
    kp = torch.ones((nb, bs, kvh, hd), device=dev)
    vp = torch.randint(-8, 8, (nb, bs, kvh, hd), generator=gen,
                       device=dev).float()
    tables = (1 + torch.arange(slots * w, device=dev)).to(
        torch.int32).reshape(slots, w)
    lengths = torch.tensor([1, 4, 16, 64], dtype=torch.int32, device=dev)
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    want = pa.paged_attention_reference(q, kp, vp, tables, lengths)
    assert torch.equal(got, want)


def _paged_inputs(dev, seed, slots, kvh, g, hd, bs, w, dtype,
                  q_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = 1 + slots * w
    q = torch.randn((slots, kvh, g, hd), generator=gen, device=dev,
                    dtype=q_dtype or dtype)
    kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen, device=dev,
                          dtype=dtype) for _ in range(2))
    tables = (1 + torch.randperm(nb - 1, generator=gen, device=dev)).to(
        torch.int32).reshape(slots, w)
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)], ids=["bf16", "f32", "bf16_pool_f32_q"])
@pytest.mark.parametrize("slots", [1, 5, 16, 64])
def test_paged_kernel_at_split_boundaries(dev, dtype, q_dtype, slots):
    """K4 at lengths on both sides of every split boundary (the span the
    wrapper picks for this grid), plus 1 and a full table, spread over
    ``slots`` slots per call."""
    kvh, g, hd, bs, w = 2, 4, 128, 16, 16
    q, kp, vp, tables = _paged_inputs(dev, slots, slots, kvh, g, hd, bs, w,
                                      dtype, q_dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    span = pa.split_span(slots, kvh, w, bs, sms) * bs
    want_lens = [1, w * bs]
    for edge in range(span, w * bs, span):
        want_lens += [edge - 1, edge, edge + 1]
    for i in range(0, len(want_lens), slots):
        chunk = want_lens[i:i + slots]
        chunk += [1 + (j * 37) % (w * bs) for j in range(slots - len(chunk))]
        lengths = torch.tensor(chunk, dtype=torch.int32, device=dev)
        before = pa.paged_attention.launches
        got = pa.paged_attention(q, kp, vp, tables, lengths)
        want = pa.paged_attention_reference(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        assert pa.paged_attention.launches == before + 1
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# (block size, table width) that give 8 slots x 8 kv heads on an H100's
# 132 SMs splits of two 64-position stages (16, 128: max_len 2048) and of
# three (16, 192), split spans capped at three stages (16, 256 and 2048:
# max_len 4096 and 32768, 22 and 171 splits), and three stages of 8 and
# 2 pool blocks (8, 384 and 32, 96)
MULTI_STAGE = [(16, 128), (16, 192), (16, 256), (16, 2048), (8, 384),
               (32, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs,w", MULTI_STAGE,
                         ids=[f"bs{b}_w{w}" for b, w in MULTI_STAGE])
def test_paged_kernel_multi_stage_splits(dev, dtype, hd, bs, w):
    """K4 with splits of two and three stages, all in flight at once, at
    lengths on both sides of the stage edges of a split and of its split
    edges (all of them up to 24 splits, else the first two, the middle
    and the last), plus 1 and a full table; each call launched twice:
    bitwise equal."""
    slots, kvh, g = 8, 8, 4
    q, kp, vp, tables = _paged_inputs(dev, bs * w + hd, slots, kvh, g, hd,
                                      bs, w, dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    span = pa.split_span(slots, kvh, w, bs, sms) * bs
    assert 128 <= span <= 192
    nsplit = -(-w * bs // span)
    firsts = list(range(nsplit)) if nsplit <= 24 else [
        0, 1, nsplit // 2, nsplit - 1]
    want_lens = {1, w * bs}
    for first in firsts:
        for edge in (0, 64, 128, span):
            at = first * span + edge
            want_lens |= {x for x in (at - 1, at, at + 1) if
                          1 <= x <= w * bs}
    want_lens = sorted(want_lens)
    for i in range(0, len(want_lens), slots):
        chunk = want_lens[i:i + slots]
        chunk += [w * bs - 7 * j for j in range(slots - len(chunk))]
        lengths = torch.tensor(chunk, dtype=torch.int32, device=dev)
        got = pa.paged_attention(q, kp, vp, tables, lengths)
        again = pa.paged_attention(q, kp, vp, tables, lengths)
        want = pa.paged_attention_reference(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        assert torch.equal(got, again), chunk


def test_paged_kernel_is_bitwise_deterministic(dev):
    """The splits' partials are added in split order: two launches give
    the same bits."""
    q, kp, vp, tables = _paged_inputs(dev, 9, 8, 8, 4, 128, 16, 64,
                                      torch.bfloat16)
    lengths = torch.tensor([1, 1024, 17, 300, 511, 64, 999, 128],
                           dtype=torch.int32, device=dev)
    first = pa.paged_attention(q, kp, vp, tables, lengths)
    second = pa.paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_tiny_engine_on_card_matches_cpu(dev):
    """The whole engine on the card (both kernels, flash chunked prefill,
    a prefix hit) against the same engine on the CPU's plain versions:
    f32 weights, so greedy streams agree."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.models import llama
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="float32")
    cpu = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = llama.empty_model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, 255, 48)]
    reqs = [([int(t) for t in rng.integers(1, 255, n)], 6)
            for n in (5, 70, 20)] + [(shared, 4)]

    async def run(model, device):
        eng = LLMEngine(cfg, model, max_slots=2, max_len=128,
                        prefill_buckets=(16, 32), cache_dtype="float32",
                        device=device)
        outs = await asyncio.gather(*[eng.generate(p, max_new_tokens=n)
                                      for p, n in reqs])
        hit = await eng.generate(shared + [7, 9], max_new_tokens=4)
        await eng.stop()
        return [o["tokens"] for o in outs + [hit]], hit["prefix_hit_tokens"]

    flash0 = fa.flash_attention_fwd.launches
    paged0 = pa.paged_attention.launches
    on_gpu, hit_gpu = asyncio.run(run(gpu, dev))
    assert fa.flash_attention_fwd.launches > flash0
    assert pa.paged_attention.launches > paged0
    on_cpu, hit_cpu = asyncio.run(run(cpu, "cpu"))
    assert on_gpu == on_cpu
    assert hit_gpu == hit_cpu > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("wq", [2, 3, 5])
def test_paged_attention_verify_matches_k4_per_row(dev, dtype, wq):
    """paged_attention_verify (plain PyTorch on the card) against K4: row
    j at cached lengths on both sides of block and split edges equals K4
    with row j's query at lengths + j + 1."""
    slots, kvh, g, hd, bs, w = 8, 8, 4, 128, 16, 64
    _, kp, vp, tables = _paged_inputs(dev, 40 + wq, slots, kvh, g, hd, bs,
                                      w, dtype)
    gen = torch.Generator(device=dev).manual_seed(wq)
    q = torch.randn((slots, wq, kvh, g, hd), generator=gen, device=dev,
                    dtype=dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    span = pa.split_span(slots, kvh, w, bs, sms) * bs
    cached = [0, bs - wq, bs - 1, bs, span - wq, span - 1, span + 1,
              w * bs - wq]
    lens = torch.tensor(cached, dtype=torch.int32, device=dev)
    steps = torch.arange(1, wq + 1, dtype=torch.int32, device=dev)
    got = pa.paged_attention_verify(q, kp, vp, tables,
                                    lens[:, None] + steps[None])
    assert got.dtype == torch.float32
    for j in range(wq):
        want = pa.paged_attention(q[:, j].contiguous(), kp, vp, tables,
                                  lens + j + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[:, j], want, atol=2e-5, rtol=2e-5)


def _tiny_streams(model, device, mode, reqs, mesh=None):
    """Greedy streams of the tiny engine in one of the serving modes:
    paged, speculative (periodic prompts draft), monolithic, or
    prefill/decode handoff (PrefillEngine payloads admitted by a paged
    engine: host arrays, or with "pd_handle" TensorRef handles to the KV
    parked on ``device``); tensor-parallel over ``mesh`` where given."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.llm.pd import PrefillEngine
    cfg = model.cfg
    kw = dict(max_slots=2, max_len=128, prefill_buckets=(16, 32),
              cache_dtype="float32", device=device, mesh=mesh)
    if mode == "spec":
        kw["spec"] = True
    if mode == "monolithic":
        kw["kv_block_size"] = 0
    payloads = [None] * len(reqs)
    if mode in ("pd", "pd_handle"):
        pre = PrefillEngine(cfg, model, prefill_buckets=(16, 32),
                            max_len=128, cache_dtype="float32",
                            device=device)
        payloads = [pre.prefill(p, device=mode == "pd_handle")
                    for p, _ in reqs]

    async def run():
        eng = LLMEngine(cfg, model, **kw)
        outs = await asyncio.gather(*[
            eng.generate(p, max_new_tokens=n, prefilled=pl)
            for (p, n), pl in zip(reqs, payloads)])
        await eng.stop()
        return [o["tokens"] for o in outs]

    return asyncio.run(run())


@pytest.mark.parametrize("mode", ["spec", "monolithic", "pd",
                                  "pd_handle"])
def test_tiny_serving_modes_on_card_match_cpu(dev, mode):
    """Speculative decoding, the monolithic cache and the prefill/decode
    handoff on the card (K1, K4 where the mode runs it, the verify
    forward) against the same engines on the CPU's plain versions: f32
    weights, so greedy streams agree."""
    from ray_tpu_torch.llm import kvcache
    from ray_tpu_torch.models import llama
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="float32")
    cpu = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = llama.empty_model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pat = [int(t) for t in rng.integers(1, 255, 12)]
    reqs = [((pat * 6)[:60], 24), ([int(t) for t in
                                    rng.integers(1, 255, 70)], 12),
            ([int(t) for t in rng.integers(1, 255, 9)], 8)]
    counts0 = (fa.flash_attention_fwd.launches, pa.paged_attention.launches,
               kvcache.paged_verify_steps.launches)
    on_gpu = _tiny_streams(gpu, dev, mode, reqs)
    k1, k4, verify = (a - b for a, b in zip(
        (fa.flash_attention_fwd.launches, pa.paged_attention.launches,
         kvcache.paged_verify_steps.launches), counts0))
    assert k1 > 0
    if mode != "spec":      # spec decodes through K4 when no slot drafts
        assert (k4 == 0) == (mode == "monolithic")
    assert (verify > 0) == (mode == "spec")
    assert on_gpu == _tiny_streams(cpu, "cpu", mode, reqs)


@pytest.mark.parametrize("mode", ["paged", "spec", "monolithic", "pd"])
def test_tiny_tp2_engine_on_card_matches_tp1(dev, mode):
    """Tensor-parallel serving on one card: the tiny engine at tp 2, both
    shards on the card (``TensorMesh(("cuda:0",) * 2)``), gives the tp-1
    engine's greedy streams, with the engine's K1 and K4 launched exactly
    twice as often (once per shard on its heads)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.tp import TensorMesh
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="float32")
    model = llama.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, dev)
    rng = np.random.default_rng(2)
    pat = [int(t) for t in rng.integers(1, 255, 12)]
    reqs = [((pat * 6)[:60], 24), ([int(t) for t in
                                    rng.integers(1, 255, 70)], 12),
            ([int(t) for t in rng.integers(1, 255, 9)], 8)]
    counts = []
    streams = []
    for mesh in (None, TensorMesh(("cuda:0",) * 2)):
        before = (fa.flash_attention_fwd.launches,
                  pa.paged_attention.launches)
        streams.append(_tiny_streams(model, dev, mode, reqs, mesh=mesh))
        counts.append((fa.flash_attention_fwd.launches - before[0],
                       pa.paged_attention.launches - before[1]))
    assert streams[1] == streams[0]
    # the PD payloads come from an unsharded PrefillEngine: its K1
    # launches are the same in both runs
    k1_per = 1 if mode == "pd" else 2
    assert counts[1] == (k1_per * counts[0][0], 2 * counts[0][1])
    assert counts[0][0] > 0 and (counts[0][1] > 0) == (mode != "monolithic")


LSE_CASES = [
    # b, sq, sk, h, kvh, causal
    (1, 64, 64, 4, 4, True),
    (2, 100, 100, 8, 2, True),
    (1, 96, 96, 4, 1, False),
    (1, 130, 70, 4, 4, True),    # sq > sk: the first rows keep no key
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", LSE_CASES,
                         ids=[str(i) for i in range(len(LSE_CASES))])
def test_flash_lse_matches_plain(dev, dtype, d, case):
    """K1 with the lse output against the plain forward with lse: o as
    above; lse (f32) to 1e-4 absolute (scores of magnitude ~10 summed
    in another order; q' is rounded the same way on both sides)."""
    b, sq, sk, h, kvh, causal = case
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=dtype)
    v = torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=dtype)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.lse_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.lse_launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL[dtype])
    if sq > sk:
        assert torch.all(lse[:, :, :sq - sk] == -1e30)
        assert torch.all(o[:, :sq - sk] == 0)


BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
BWD_CASES = [
    # b, sq, sk, h, kvh, causal
    (1, 64, 64, 8, 8, True),      # group 1
    (2, 100, 100, 8, 4, True),    # group 2, ragged
    (1, 200, 200, 8, 2, False),   # group 4, non-causal, ragged
    (1, 128, 128, 8, 1, True),    # group 8
    (1, 96, 40, 4, 2, True),      # sq > sk: fully masked rows
    (1, 40, 96, 4, 2, True),      # sq < sk
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[str(i) for i in range(len(BWD_CASES))])
def test_flash_bwd_kernels_match_plain(dev, dtype, d, case):
    """K2 (dk, dv) and K3 (dq) against their plain versions on the same
    q, k, v, dO and the same lse/delta (from K1)."""
    b, sq, sk, h, kvh, causal = case
    g = torch.Generator(device=dev).manual_seed(3 * sq + sk + h + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=dtype)
    v = torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=dtype)
    do = torch.randn((b, sq, h, d), generator=g, device=dev, dtype=dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
    delta = fa.attention_delta(o, do)
    before = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                      delta, causal=causal)
    dq_r = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                               causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == (before[0] + 1,
                                                    before[1] + 1)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **BWD_TOL[dtype])
    if sq > sk:
        assert torch.all(dq[:, :sq - sk] == 0)


def test_tiny_train_step_on_card_matches_cpu(dev):
    """Three steps of make_train_step on the card (K1 with lse, K2, K3
    under full remat) against the same steps on the CPU's plain
    versions: f32 weights, so losses and grad norms agree to 1e-4."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import default_optimizer, make_train_step
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="float32")
    opt = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                            total_steps=10)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 96)).astype(np.int64)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    hist = {}
    for device in ("cpu", dev):
        init_fn, step_fn = make_train_step(cfg, device=device, optimizer=opt)
        cpu = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                                trainable=True)
        model = llama.empty_model(cfg, device)
        model.load_state_dict(cpu.state_dict())
        state = init_fn(params=llama.finish(model, True))
        counts = (fa.flash_attention_fwd.lse_launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches)
        hist[str(device)] = []
        for _ in range(3):
            state, m = step_fn(state, batch)
            hist[str(device)].append((m["loss"].item(),
                                      m["grad_norm"].item()))
        launched = (fa.flash_attention_fwd.lse_launches - counts[0],
                    fa.flash_attention_bwd_dkv.launches - counts[1],
                    fa.flash_attention_bwd_dq.launches - counts[2])
        want = (12, 6, 6) if device != "cpu" else (0, 0, 0)
        assert launched == want, (device, launched)
    np.testing.assert_allclose(np.array(hist[str(dev)]),
                               np.array(hist["cpu"]), rtol=1e-4)


ROW_REL_TOL = 1e-2


def _row_rel(got, want, floor_of=None) -> float:
    """Worst |got - want|_2 / |want|_2 over the last dim; a row's norm is
    floored at 1e-3 of the mean row norm of ``floor_of`` (default
    ``want``)."""
    diff = torch.linalg.vector_norm(got.float() - want.float(), dim=-1)
    ref = torch.linalg.vector_norm(want.float(), dim=-1)
    base = ref if floor_of is None else torch.linalg.vector_norm(
        floor_of.float(), dim=-1)
    return (diff / ref.clamp_min(1e-3 * base.mean().item() + 1e-30)
            ).max().item()


# chip_smoke.py's bound for K3's rows that keep one key, in units of
# 2^-24 sm_scale |dO_i| |v_j| |k_j|: both sides hold the f32 rounding of
# dp - delta there, zero in exact arithmetic
ONE_KEY_ULPS = 64


def _one_key_ulps(dq, dq_r, q, k, v, do, rows, keys) -> float:
    """Worst |dq - dq_r|_2 over query rows ``rows``, row rows[i] keeping
    the one key keys[i], in units of 2^-24 sm_scale |dO_i| |v_j| |k_j|
    (head h reads kv head h // g)."""
    g = q.shape[2] // k.shape[2]

    def norm(x, at):
        return torch.linalg.vector_norm(x[:, at].float(), dim=-1)

    diff = torch.linalg.vector_norm(
        dq[:, rows].float() - dq_r[:, rows].float(), dim=-1)
    unit = (2.0 ** -24 * q.shape[-1] ** -0.5 * norm(do, rows)
            * (norm(v, keys) * norm(k, keys)).repeat_interleave(g, dim=-1))
    return (diff / unit).max().item()


def _bf16_inputs(dev, seed, b, sq, sk, h, kvh, d):
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q, do = (torch.randn((b, sq, h, d), generator=g, device=dev, dtype=bf)
             for _ in range(2))
    k, v = (torch.randn((b, sk, kvh, d), generator=g, device=dev, dtype=bf)
            for _ in range(2))
    return q, k, v, do


def _check_bf16_fwd_dkv(q, k, v, do, causal=True, q_offset=None):
    """K1 with lse against its plain version, and (when q_offset is the
    default) K2 and K3 against their plain versions on the plain
    forward's o and lse; one launch each."""
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.lse_launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                    q_offset=q_offset, with_lse=True)
    o_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, causal=causal,
                                                  q_offset=q_offset)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert _row_rel(o, o_r) <= ROW_REL_TOL
    torch.testing.assert_close(lse, lse_r, atol=1e-3, rtol=0)
    kept = fa._keep_mask(q.shape[1], k.shape[1], causal,
                         (k.shape[1] - q.shape[1]) if q_offset is None
                         else q_offset, q.device).any(-1)
    assert torch.all(o[:, ~kept] == 0)
    assert torch.all(lse[:, :, ~kept] == -1e30)
    dkv = None
    if q_offset is None:
        delta = fa.attention_delta(o_r, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta,
                                            causal=causal)
        dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(
            q, k, v, do, lse_r, delta, causal=causal)
        torch.cuda.synchronize()
        both = torch.cat([dk_r, dv_r], dim=-1)
        assert _row_rel(dk, dk_r, both) <= ROW_REL_TOL
        assert _row_rel(dv, dv_r, both) <= ROW_REL_TOL
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta,
                                       causal=causal)
        dq_r = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_r, delta,
                                                   causal=causal)
        torch.cuda.synchronize()
        assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
        # a row that keeps one key has dQ = 0 in exact arithmetic (dS = 0)
        keep = fa._keep_mask(q.shape[1], k.shape[1], causal,
                             k.shape[1] - q.shape[1], q.device)
        one = keep.sum(-1) == 1
        if (~one).any():
            assert _row_rel(dq[:, ~one], dq_r[:, ~one], dq_r) <= ROW_REL_TOL
        if one.any():
            assert _one_key_ulps(dq, dq_r, q, k, v, do, one.nonzero()[:, 0],
                                 keep[one].float().argmax(-1)) <= ONE_KEY_ULPS
        dkv = (dk, dv, lse_r, delta)
    bwd = int(q_offset is None)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.lse_launches,
            fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == (
                before[0] + 1, before[1] + 1, before[2] + bwd, before[3] + bwd)
    return dkv


EDGES = [1, 63, 64, 65, 127, 128, 129, 1000]
# (sq, sk) on the diagonal and off it (sq > sk and sq < sk), a group size
# of 1, 2, 4 or 8 each, causal on the diagonal, alternating off it
EDGE_CASES = [(s, s, 1 << (i % 4), True) for i, s in enumerate(EDGES)] + [
    (s, EDGES[(i + 3) % 8], 1 << ((i + 1) % 4), bool(i % 2))
    for i, s in enumerate(EDGES)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,group,causal", EDGE_CASES,
                         ids=[f"{a}x{b}_g{g}_{'c' if c else 'f'}"
                              for a, b, g, c in EDGE_CASES])
def test_bf16_kernels_at_tile_edges(dev, d, sq, sk, group, causal):
    """The wgmma K1 (BQ = BK = 128), K2 (BK = 128, BQ = 64) and K3
    (BQ = 128, BK = 64) at lengths on both sides of their tile edges."""
    kvh = 2
    q, k, v, do = _bf16_inputs(dev, sq * 31 + sk + d + group, 1, sq, sk,
                               kvh * group, kvh, d)
    _check_bf16_fwd_dkv(q, k, v, do, causal=causal)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (512, 1536, 512, True),     # a chunked-prefill piece
    (16, 300, -5, True),        # the first 5 rows keep no key
    (200, 700, None, False),    # non-causal, ragged
    (300, 130, None, True),     # sq > sk: the first 170 rows keep no key
], ids=["chunk", "neg_offset", "full", "sq_gt_sk"])
def test_bf16_kernels_special_cases(dev, d, sq, sk, q_offset, causal):
    q, k, v, do = _bf16_inputs(dev, sq + sk + d, 2, sq, sk, 8, 2, d)
    dkv = _check_bf16_fwd_dkv(q, k, v, do, causal=causal, q_offset=q_offset)
    if sq > sk:
        _, _, lse, delta = dkv
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        assert torch.all(dq[:, :sq - sk] == 0)
        # row sq - sk keeps one key, so its dS = p (dp - delta) is 0 too
        assert torch.all(dq[:, sq - sk + 1:].float().abs().sum(-1) > 0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal", [
    (512, 1536, True),          # a chunked-prefill piece's shape
    (16, 300, True),            # sq < sk, one q tile
    (200, 700, False),          # non-causal, ragged
    (300, 130, True),           # sq > sk: the first 170 rows keep no key
], ids=["chunk", "short", "full", "sq_gt_sk"])
def test_bf16_backward_special_cases(dev, d, sq, sk, causal):
    """K2 and K3 at the special cases' shapes, with the backward's own
    causal diagonal (sk - sq; the backward takes no q_offset)."""
    q, k, v, do = _bf16_inputs(dev, 2 * sq + sk + d, 2, sq, sk, 8, 2, d)
    _check_bf16_fwd_dkv(q, k, v, do, causal=causal)


def test_bf16_dq_is_bitwise_deterministic(dev):
    """K3 keeps dQ in registers over the whole kv loop (no atomics): two
    launches on the same inputs give the same bits."""
    q, k, v, do = _bf16_inputs(dev, 6, 2, 1000, 1000, 32, 8, 128)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    delta = fa.attention_delta(o, do)
    first = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    second = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_bf16_dkv_is_bitwise_deterministic(dev):
    """K2 sums the GQA group in registers in a fixed order (no atomics):
    two launches on the same inputs give the same bits."""
    q, k, v, do = _bf16_inputs(dev, 5, 2, 1000, 1000, 32, 8, 128)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    delta = fa.attention_delta(o, do)
    first = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bf16_kernels_at_the_training_shape(dev):
    """K1 with lse, K2 and K3 at b 2, s 4096, Llama-3-8B heads (32/8,
    d 128), causal: the train step's shape."""
    q, k, v, do = _bf16_inputs(dev, 7, 2, 4096, 4096, 32, 8, 128)
    _check_bf16_fwd_dkv(q, k, v, do)


@pytest.mark.parametrize("s,causal", [(4096, True), (1000, True),
                                      (1000, False)])
def test_bf16_kernels_at_the_tensor_shard_shape(dev, s, causal):
    """K1 with lse, K2 and K3 at one tensor shard's heads under a mesh
    with tensor 2 (16 query, 4 kv heads, d 128) and one fsdp shard's
    batch row: the sharded train step's shape."""
    q, k, v, do = _bf16_inputs(dev, 11, 1, s, s, 16, 4, 128)
    _check_bf16_fwd_dkv(q, k, v, do, causal=causal)


def test_dtype_picks_the_kernel(dev):
    """A bf16 CUDA tensor runs the wgmma kernels, an f32 one the FMA
    kernels, as the profiler names them."""
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.to(dtype) for x in
                       _bf16_inputs(dev, 3, 1, 256, 256, 4, 2, 128))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            delta = fa.attention_delta(o, do)
            fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
            fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.name for e in prof.events())
    assert "flash_fwd_kernel_wgmma" in names[torch.bfloat16]
    assert "flash_dkv_kernel_wgmma" in names[torch.bfloat16]
    assert "flash_dq_kernel_wgmma" in names[torch.bfloat16]
    assert "wgmma" not in names[torch.float32]
    assert "flash_fwd_kernel" in names[torch.float32]
    assert "flash_dkv_kernel" in names[torch.float32]
    assert "flash_dq_kernel" in names[torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_fold_scale_on_card_matches_cpu(dev, dtype):
    """The wrappers' q' fold gives the same bits on the card as on the
    CPU, where tests/test_torch_flash_bf16.py holds it to the JAX fold."""
    x = torch.randn((2, 300, 8, 128), generator=torch.Generator()
                    .manual_seed(0)).mul(8).to(dtype)
    for scale in (128 ** -0.5, 0.2):
        assert torch.equal(fa.fold_scale(x.to(dev), scale).cpu(),
                           fa.fold_scale(x, scale))


def _tiny_series(model, device, mode, reqs):
    """{(name, labels): value} of the llm_* counters and gauges, and
    {(name + "_count", labels): count} of the llm_* histograms, that one
    tiny drive leaves in an empty registry of its own: the serving modes
    of ``_tiny_streams`` plus the paged engine and a bf16 PD handoff; the
    paged modes run K4 (``kv_impl="paged_flash"``, its plain version on
    the CPU)."""
    from unittest import mock

    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.llm.pd import PrefillEngine
    from ray_tpu_torch.util import metrics
    cdt = "bfloat16" if mode == "pd_bf16" else "float32"
    kw = dict(max_slots=2, max_len=128, prefill_buckets=(16, 32),
              cache_dtype=cdt, device=device, kv_impl="paged_flash",
              spec=mode == "spec", kv_block_size=0 if mode == "monolithic"
              else 16)
    payloads = [None] * len(reqs)
    if mode.startswith("pd"):
        pre = PrefillEngine(model.cfg, model, prefill_buckets=(16, 32),
                            max_len=128, cache_dtype=cdt, device=device)
        payloads = [pre.prefill(p) for p, _ in reqs]

    async def run():
        eng = LLMEngine(model.cfg, model, **kw)
        await asyncio.gather(*[
            eng.generate(p, max_new_tokens=n, prefilled=pl)
            for (p, n), pl in zip(reqs, payloads)])
        await eng.stop()

    out = {}
    with mock.patch.object(metrics, "_REGISTRY", {}):
        asyncio.run(run())
        for m in metrics._REGISTRY.values():
            if m.kind == "histogram":
                out.update({(m.name + "_count", k): sum(c)
                            for k, c in m._counts.items()})
            elif m.name.startswith("llm_"):
                out.update({(m.name, k): v for k, v in m._values.items()})
    return out


@pytest.mark.parametrize("mode", ["paged", "spec", "monolithic", "pd",
                                  "pd_bf16"])
def test_tiny_engine_metrics_on_card_match_cpu(dev, mode):
    """The engine's llm_* counters, gauges and histogram counts from a
    tiny drive on the card equal the same drive's on the CPU (f32
    weights: the same greedy streams, so the same drafts, steps, blocks
    and bytes)."""
    from ray_tpu_torch.models import llama
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="float32")
    cpu = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = llama.empty_model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pat = [int(t) for t in rng.integers(1, 255, 12)]
    reqs = [((pat * 6)[:60], 24), ([int(t) for t in
                                    rng.integers(1, 255, 70)], 12),
            ([int(t) for t in rng.integers(1, 255, 9)], 8)]
    on_gpu = _tiny_series(gpu, dev, mode, reqs)
    assert on_gpu == _tiny_series(cpu, "cpu", mode, reqs)
    steps = on_gpu.get(("llm_paged_attn_steps_total",
                        (("impl", "paged_flash"),)), 0)
    assert (steps > 0) == (mode != "monolithic")
    assert on_gpu[("llm_ttft_wall_s_count", ())] == len(reqs)


def test_hbm_snapshot_rows_match_torch_cuda(dev):
    from ray_tpu_torch.util import devmon
    keep = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = devmon.hbm_snapshot(record=False)
    assert [r["device"] for r in rows] == \
        [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    for i, r in enumerate(rows):
        assert r["used"] == torch.cuda.memory_allocated(i)
        assert r["limit"] == torch.cuda.mem_get_info(i)[1]
        assert r["used"] <= r["peak"] <= r["limit"]
        assert r["peak"] >= torch.cuda.max_memory_allocated(i)
        assert r["source"] == "memory_stats" and 0 <= r["duty"] <= 1
    assert rows[dev.index or 0]["used"] >= keep.numel()


def test_forced_rebuild_records_exactly_one_compile(dev, tmp_path,
                                                    monkeypatch):
    """nvcc building paged_attention.cu into an empty build directory is
    one compile of that source; loading it again reuses the build."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util import devmon

    def compiles():
        return devmon.devmon_metrics()["compiles"]._values.get(
            (("fn", "paged_attention.cu"),), 0.0)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    before = compiles()
    loader = _build._Loader()
    loader.build(["paged_attention"])
    assert compiles() == before + 1
    loader.load("paged_attention")
    loader.build(["paged_attention"])
    assert compiles() == before + 1


def test_device_store_same_process_identity_on_card(dev):
    """A handle to a CUDA tensor resolves to that very tensor (no host
    copy); asking for the CPU gives a copy with the same values."""
    from ray_tpu_torch.runtime.device_store import get_device, put_device
    t = torch.randn((4, 33, 2, 16), device=dev).to(torch.bfloat16)
    ref = put_device(t)
    assert ref.dtype == "bfloat16" and ref.shape == tuple(t.shape)
    assert get_device(ref) is t and get_device(ref, dev) is t
    assert get_device(ref, None) is t
    host = get_device(ref, "cpu")
    assert host.device.type == "cpu"
    assert torch.equal(host.view(torch.int16), t.cpu().view(torch.int16))
    ref.free()
    with pytest.raises(KeyError):
        get_device(ref)


def test_device_store_cross_process_bf16_fetch_on_card(dev):
    """An actor parks bf16 and f32 CUDA tensors made from a seed; the
    driver resolves the handles onto its card (device=None: the card)
    through one fetch each, bit for bit, and frees them at the owner."""
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Holder:
            def park(self, seed):
                import torch
                from ray_tpu_torch.runtime.device_store import put_device
                g = torch.Generator(device="cuda").manual_seed(seed)
                self.parked = [
                    torch.randn((3, 70, 2, 128), generator=g,
                                device="cuda").to(torch.bfloat16),
                    torch.randn((5000,), generator=g, device="cuda")]
                return [put_device(t) for t in self.parked]

            def live(self):
                from ray_tpu_torch.runtime.device_store import _store
                return _store().live_count()

        h = Holder.remote()
        refs = ray_tpu_torch.get(h.park.remote(11), timeout=180)
        g = torch.Generator(device=dev).manual_seed(11)
        want = [torch.randn((3, 70, 2, 128), generator=g,
                            device=dev).to(torch.bfloat16),
                torch.randn((5000,), generator=g, device=dev)]
        got = [r.resolve() for r in refs]
        assert [t.device.type for t in got] == ["cuda", "cuda"]
        assert got[0].dtype == torch.bfloat16
        assert torch.equal(got[0].view(torch.int16),
                           want[0].view(torch.int16))
        assert torch.equal(got[1], want[1])
        assert ray_tpu_torch.get(h.live.remote(), timeout=60) == 2
        for r in refs:
            r.free()
        assert ray_tpu_torch.get(h.live.remote(), timeout=60) == 0
    finally:
        ray_tpu_torch.shutdown()


def _card_train(dev, policy, seed=0):
    """A 2-layer bf16 Llama (head_dim 128, the wgmma kernels) under
    ``policy`` on the card, and one batch of 2 x 128 tokens."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import default_optimizer, make_train_step
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=2,
                     n_kv_heads=1, ffn_dim=512, dtype="bfloat16",
                     remat_policy=policy)
    init_fn, step_fn = make_train_step(cfg, device=dev,
                                       optimizer=default_optimizer(
                                           1e-2, warmup_steps=1,
                                           total_steps=10))
    state = init_fn(torch.Generator(device=dev).manual_seed(seed))
    toks = np.random.default_rng(seed).integers(0, 256, (2, 129))
    return state, step_fn, {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("policy,k1", [("full", 4), ("attn", 2),
                                       ("dots", 2), ("none", 2)])
def test_remat_policy_launches_on_card(dev, policy, k1):
    """One train step: K1 (all with lse) runs 2L times under "full" and L
    under the others (the saved (o, lse) spares the recompute's K1); K2
    and K3 L times each."""
    state, step_fn, batch = _card_train(dev, policy)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.lse_launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    after = (fa.flash_attention_fwd.launches,
             fa.flash_attention_fwd.lse_launches,
             fa.flash_attention_bwd_dkv.launches,
             fa.flash_attention_bwd_dq.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (k1, k1, 2, 2)
    assert torch.isfinite(m["loss"])


def test_remat_policies_agree_on_card(dev):
    """The same weights and batch under "full", "attn" and "dots": equal
    losses and gradients, bit for bit (the recompute runs the same
    kernels on the same values; a saved output is what it would give)."""
    from ray_tpu_torch.models import llama
    runs = {}
    for policy in ("full", "attn", "dots"):
        state, _, batch = _card_train(dev, policy)
        model = state.params
        loss = llama.loss_fn(model, {k: torch.as_tensor(v, device=dev)
                                     for k, v in batch.items()})
        loss.backward()
        runs[policy] = (loss.item(),
                        [p.grad.clone() for p in model.parameters()])
    for policy in ("attn", "dots"):
        assert runs[policy][0] == runs["full"][0]
        for a, b in zip(runs[policy][1], runs["full"][1]):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


MESH_A = dict(fsdp=2, tensor=2, context=1)
MESH_B = dict(fsdp=1, tensor=2, context=2)


def _mesh_run(dev, kw, devices=("cuda:0",) * 4):
    """3 steps of a 2-layer bf16 Llama (head_dim 128) under "dots" over
    the mesh ``kw`` (None: the single-device step) from seed 0's weights
    on one batch of 2 x 256 tokens: ((loss, grad norm) per step, (K1 with
    lse, K2, K3) launches per step)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import (MeshSpec, default_optimizer,
                                        make_mesh, make_train_step)
    cfg = llama.tiny(vocab_size=256, dim=512, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="bfloat16",
                     remat_policy="dots")
    toks = np.random.default_rng(0).integers(0, 256, (2, 257))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    mesh = None if kw is None else make_mesh(MeshSpec(**kw), devices=devices)
    init_fn, step_fn = make_train_step(
        cfg, mesh, device=dev if mesh is None else None,
        optimizer=default_optimizer(1e-3, warmup_steps=1, total_steps=10))
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    hist, launches = [], []
    for _ in range(3):
        before = (fa.flash_attention_fwd.lse_launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches)
        state, m = step_fn(state, batch)
        hist.append((m["loss"].item(), m["grad_norm"].item()))
        launches.append((fa.flash_attention_fwd.lse_launches - before[0],
                         fa.flash_attention_bwd_dkv.launches - before[1],
                         fa.flash_attention_bwd_dq.launches - before[2]))
    return np.array(hist), launches


def test_mesh_train_step_on_card_matches_single_device(dev):
    """Mesh A (fsdp 2, tensor 2) with all four shards on the card against
    the single-device step from the same weights on the same batch: 3
    steps' losses and grad norms within chip_smoke.py's
    TRAIN_LOSS_REL_TOL/TRAIN_GNORM_REL_TOL (bf16 partial sums over the
    tensor shards round apart from one GEMM), and K1 (with lse), K2 and
    K3 once per shard and layer under "dots"; over mesh B (tensor 2,
    context 2) the ring runs instead, with no kernel launch."""
    single, launches = _mesh_run(dev, None)
    assert launches == [(2, 2, 2)] * 3
    for kw, want in ((MESH_A, (8, 8, 8)), (MESH_B, (0, 0, 0))):
        hist, launches = _mesh_run(dev, kw)
        assert launches == [want] * 3, (kw, launches)
        np.testing.assert_allclose(hist[:, 0], single[:, 0], rtol=2e-3)
        np.testing.assert_allclose(hist[:, 1], single[:, 1], rtol=2e-2)


def _moe_card_run(dev, impl, kw=None, devices=("cuda:0",) * 4):
    """3 steps of a 2-layer bf16 MoE (head_dim 128, 4 experts, top 2)
    under "full" with ``attn_impl=impl`` from seed 0's weights on one
    batch of 2 x 256 tokens, on one device or over the mesh ``kw``:
    ((loss, grad norm) per step, (K1 with lse, K2, K3) launches per
    step)."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import (MeshSpec, default_optimizer,
                                        make_mesh, make_train_step)
    cfg = moe.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=2,
                   n_kv_heads=1, ffn_dim=256, dtype="bfloat16",
                   attn_impl=impl)
    toks = np.random.default_rng(0).integers(0, 256, (2, 257))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    mesh = None if kw is None else make_mesh(MeshSpec(**kw), devices=devices)
    init_fn, step_fn = make_train_step(
        cfg, mesh, device=dev if mesh is None else None, model=moe,
        optimizer=default_optimizer(1e-3, warmup_steps=1, total_steps=10))
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    hist, launches = [], []
    for _ in range(3):
        before = (fa.flash_attention_fwd.lse_launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches)
        state, m = step_fn(state, batch)
        hist.append((m["loss"].item(), m["grad_norm"].item()))
        launches.append((fa.flash_attention_fwd.lse_launches - before[0],
                         fa.flash_attention_bwd_dkv.launches - before[1],
                         fa.flash_attention_bwd_dq.launches - before[2]))
    return np.array(hist), launches


def test_moe_train_step_on_card_matches_plain_attention(dev):
    """The MoE family's step with K1-K3 on the card (2L/L/L a step under
    "full") against the same step with the plain attention, from the
    same weights on the same batch: the first step's loss and grad norm
    within chip_smoke.py's TRAIN_LOSS_REL_TOL/TRAIN_GNORM_REL_TOL; and
    over an expert mesh (fsdp 2, expert 2, all on the card), the
    attention once per row block (2 x 2L/L/L) and the losses and grad
    norms of the single-device kernel step."""
    hist, launches = _moe_card_run(dev, "auto")
    assert launches == [(4, 2, 2)] * 3
    plain, none = _moe_card_run(dev, "reference")
    assert none == [(0, 0, 0)] * 3
    np.testing.assert_allclose(hist[0, 0], plain[0, 0], rtol=2e-3)
    np.testing.assert_allclose(hist[0, 1], plain[0, 1], rtol=2e-2)
    assert hist[-1, 0] < hist[0, 0]
    mesh, launches = _moe_card_run(dev, "auto", dict(data=1, fsdp=2, tensor=1,
                                                     context=1, expert=2))
    assert launches == [(8, 4, 4)] * 3
    np.testing.assert_allclose(mesh[:, 0], hist[:, 0], rtol=2e-3)
    np.testing.assert_allclose(mesh[:, 1], hist[:, 1], rtol=2e-2)


def _cards(n: int) -> list:
    """The first n cards, or a skip where fewer are visible: these tests
    put each shard on its own card (the one-card machine runs the
    stand-in meshes above)."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (shards on distinct cards)")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("kw", [MESH_A, MESH_B], ids=["mesh_a", "mesh_b"])
def test_mesh_over_distinct_cards_matches_one_card(dev, kw):
    """The same meshes with each shard on its own card: every collective
    is a copy between cards and each kernel launches with its shard's card
    current. The launch counts are the one-card run's; the losses and
    grad norms are held to the single-device step at the one-card mesh's
    bars: the autograd engine runs each card's backward on its own thread,
    so a bf16 block's gradient sums its users' contributions in the order
    the threads finish (1e-4 apart from the one-card run, one bf16
    rounding), not in one fixed order."""
    cards = _cards(4)
    single, _ = _mesh_run(dev, None)
    _, launches_one = _mesh_run(dev, kw)
    many, launches_many = _mesh_run(dev, kw, devices=cards)
    assert launches_many == launches_one
    np.testing.assert_allclose(many[:, 0], single[:, 0], rtol=2e-3)
    np.testing.assert_allclose(many[:, 1], single[:, 1], rtol=2e-2)


@pytest.mark.parametrize("mode", ["paged", "spec"])
def test_tiny_tp2_engine_over_two_cards_matches_one_card(dev, mode):
    """Tensor-parallel serving with each shard on its own card: the
    greedy streams and K1/K4 launch counts of the same engine with both
    shards on one card."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.tp import TensorMesh
    cards = _cards(2)
    cfg = llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=512, dtype="float32")
    model = llama.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, dev)
    rng = np.random.default_rng(2)
    pat = [int(t) for t in rng.integers(1, 255, 12)]
    reqs = [((pat * 6)[:60], 24), ([int(t) for t in
                                    rng.integers(1, 255, 70)], 12)]
    runs = []
    for mesh in (TensorMesh(("cuda:0",) * 2), TensorMesh(cards)):
        before = (fa.flash_attention_fwd.launches,
                  pa.paged_attention.launches)
        streams = _tiny_streams(model, dev, mode, reqs, mesh=mesh)
        runs.append((streams, fa.flash_attention_fwd.launches - before[0],
                     pa.paged_attention.launches - before[1]))
    assert runs[1] == runs[0]


def test_train_state_checkpoint_round_trip_on_card(dev, tmp_path):
    """A bf16 TrainState on the card through state_to_numpy, an async
    ckptio save, restore into a differently seeded state and
    state_from_numpy: parameters, moments, count and step bit for bit,
    and the next steps equal."""
    import os

    from ray_tpu_torch.parallel import mesh
    from ray_tpu_torch.train import ckptio
    state, step_fn, batch = _card_train(dev, "dots")
    for _ in range(2):
        state, _ = step_fn(state, batch)
    ck = ckptio.AsyncCheckpointer(str(tmp_path), rank=0, world=1)
    try:
        assert ck.save(state.step, *mesh.state_to_numpy(state))
        assert ck.flush(timeout_s=60)
    finally:
        ck.close()
    other, _, _ = _card_train(dev, "dots", seed=1)
    params, opt, step = ckptio.restore(
        *mesh.numpy_template(other), rank=0, world=1,
        checkpoint=os.path.join(str(tmp_path), ckptio.ckpt_dirname(2)))
    mesh.state_from_numpy(other, params, opt)
    assert (step, other.step, other.opt_state.count) == (2, 2, 2)
    mine = list(state.params.parameters()) + state.opt_state.mu + \
        state.opt_state.nu
    theirs = list(other.params.parameters()) + other.opt_state.mu + \
        other.opt_state.nu
    for a, b in zip(mine, theirs):
        assert b.device.type == "cuda" and b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    _, m1 = step_fn(state, batch)
    _, m2 = step_fn(other, batch)
    assert (m1["loss"].item(), m1["grad_norm"].item()) == \
        (m2["loss"].item(), m2["grad_norm"].item())


def test_tiny_llm_app_on_card_matches_cpu(dev):
    """``build_llm_deployment`` with ``device=None`` serves on the card:
    its replica draws the weights from the seed on the card (so does
    this process, and copies them to the CPU), and its greedy streams
    through the handle equal a CPU engine's over those weights; one
    server-sent-events request through the proxy equals the handle."""
    import http.client
    import json

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import llm as tllm
    cfg = tllm.LLMConfig(
        model="tiny", model_overrides=dict(vocab_size=256, dim=256,
                                           n_layers=2, n_heads=4,
                                           n_kv_heads=2, ffn_dim=512,
                                           dtype="float32"),
        max_slots=4, max_len=128, prefill_buckets=(16, 64),
        cache_dtype="float32")
    model_cfg, on_card = tllm._load_model(cfg)
    assert on_card.device.type == "cuda"
    cpu = llama.empty_model(model_cfg, "cpu")
    cpu.load_state_dict(on_card.state_dict())
    del on_card
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 255, n)]
               for n in (5, 20, 70, 9)]

    async def on_cpu():
        eng = LLMEngine(model_cfg, cpu, max_slots=cfg.max_slots,
                        max_len=cfg.max_len,
                        prefill_buckets=cfg.prefill_buckets,
                        cache_dtype="float32", device="cpu")
        outs = await asyncio.gather(*[eng.generate(p, max_new_tokens=12)
                                      for p in prompts])
        await eng.stop()
        return [o["tokens"] for o in outs]
    want = asyncio.run(on_cpu())

    ray_tpu_torch.init(num_cpus=4)
    try:
        h = serve.run(tllm.build_llm_deployment(cfg), name="card",
                      ready_timeout_s=300.0)
        got = [o["tokens"] for o in ray_tpu_torch.get(
            [h.generate.remote(p, max_new_tokens=12) for p in prompts],
            timeout=300)]
        stats = ray_tpu_torch.get(h.stats.remote(), timeout=60)
        addr = serve.proxy_address()
        conn = http.client.HTTPConnection(addr["host"], addr["port"],
                                          timeout=300)
        conn.request("POST", "/LLMServer",
                     body=json.dumps({"tokens": prompts[2],
                                      "max_new_tokens": 12}),
                     headers={"Content-Type": "application/json",
                              "Accept": "text/event-stream"})
        raw = conn.getresponse().read().decode()
        conn.close()
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    assert stats["device"].startswith("cuda")
    assert stats["kv_impl"] == "paged_flash"
    assert got == want
    sse = [json.loads(line[len("data: "):])["token"]
           for line in raw.splitlines()
           if line.startswith("data: ") and "token" in line]
    assert "event: done" in raw and sse == got[2]


def test_dag_stages_cuda_bf16_leaves_to_host(dev):
    """A compiled DAG between two actors on the card: the first stage
    returns CUDA tensors (bf16 and f32, bare in a dict and inside a
    list) and an int; the second receives CPU tensors of the same dtype
    and shape, bit for bit the tensors this process draws from the same
    seed."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, compile
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Make:
            def f(self, seed):
                import torch
                g = torch.Generator(device="cuda").manual_seed(seed)
                x = torch.randn((300, 129), generator=g, device="cuda")
                return {"x": x.to(torch.bfloat16),
                        "more": [torch.randn((77,), generator=g,
                                             device="cuda")], "n": seed}

        @ray_tpu_torch.remote
        class Take:
            def g(self, d):
                return {"devs": [d["x"].device.type,
                                 d["more"][0].device.type],
                        "x": d["x"], "y": d["more"][0], "n": d["n"]}

        a, b = Make.remote(), Take.remote()
        with InputNode() as inp:
            out = b.g.bind(a.f.bind(inp))
        cd = compile(out)
        try:
            got = [cd.execute(s).get(timeout=300) for s in (5, 6)]
        finally:
            cd.teardown()
    finally:
        ray_tpu_torch.shutdown()
    for seed, v in zip((5, 6), got):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((300, 129), generator=g, device=dev)
        y = torch.randn((77,), generator=g, device=dev)
        assert v["devs"] == ["cpu", "cpu"] and v["n"] == seed
        assert v["x"].dtype == torch.bfloat16 and v["x"].shape == x.shape
        assert torch.equal(v["x"].view(torch.int16),
                           x.to(torch.bfloat16).cpu().view(torch.int16))
        assert torch.equal(v["y"], y.cpu())


def test_tensor_ref_over_dag_between_card_actors(dev):
    """A stage that parks a CUDA tensor returns its TensorRef: only the
    handle rides the shm ring; the next stage, another process on the
    card, resolves it onto its card (one fetch, bf16 bit for bit) and
    frees it, so the producer's store ends empty."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, compile
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Park:
            def f(self, seed):
                import torch

                from ray_tpu_torch.runtime.device_store import put_device
                g = torch.Generator(device="cuda").manual_seed(seed)
                return put_device(torch.randn(
                    (4, 1024), generator=g,
                    device="cuda").to(torch.bfloat16))

            def live(self):
                from ray_tpu_torch.runtime.device_store import _store
                return _store().live_count()

        @ray_tpu_torch.remote
        class Use:
            def g(self, ref):
                t = ref.resolve()
                ref.free()
                return t.device.type, t.cpu()

        a, b = Park.remote(), Use.remote()
        with InputNode() as inp:
            out = b.g.bind(a.f.bind(inp))
        cd = compile(out)
        try:
            got = [cd.execute(s).get(timeout=300) for s in (1, 2)]
        finally:
            cd.teardown()
        live = ray_tpu_torch.get(a.live.remote(), timeout=60)
    finally:
        ray_tpu_torch.shutdown()
    assert live == 0
    for seed, (where, t) in zip((1, 2), got):
        g = torch.Generator(device=dev).manual_seed(seed)
        want = torch.randn((4, 1024), generator=g,
                           device=dev).to(torch.bfloat16).cpu()
        assert where == "cuda"
        assert torch.equal(t.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_iter_device_batches_on_card(dev, prefetch):
    """``iter_device_batches`` (device=None: the card) yields CUDA
    tensors bit for bit the host batches of ``iter_batches``, with the
    copies of up to ``prefetch`` later batches in flight."""
    from ray_tpu_torch import data
    toks = np.random.default_rng(0).integers(
        0, 128256, (12, 4096)).astype(np.int32)
    ds = data.from_numpy(toks)
    host = list(ds.iter_batches(batch_size=2, drop_last=True))
    got = list(ds.iter_device_batches(batch_size=2, prefetch=prefetch))
    assert len(got) == len(host) == 6
    for g, h in zip(got, host):
        assert set(g) == set(h)
        for k in g:
            assert g[k].device.type == "cuda" and g[k].dtype == torch.int32
            assert np.array_equal(g[k].cpu().numpy(), h[k])


def test_iter_device_batches_consumer_waits_for_copy(dev, monkeypatch):
    """Each batch is summed on the consumer's stream as soon as it is
    yielded, before any synchronize, while ``torch.cuda._sleep`` queued
    ahead of every column's copy (``torch.from_numpy`` runs in the copy
    stream's context) holds the copies back: the sums equal the host's
    only if the consumer's stream waits on each copy's event."""
    from ray_tpu_torch import data
    toks = np.random.default_rng(1).integers(
        0, 128256, (16, 4096)).astype(np.int32)
    ds = data.from_numpy(toks)
    want = [int(b["data"].astype(np.int64).sum())
            for b in ds.iter_batches(batch_size=2)]
    keep = list(ds.iter_device_batches(batch_size=2))  # no stale right rows
    real = torch.from_numpy

    def slowed(a):
        torch.cuda._sleep(20_000_000)
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", slowed)
    sums = [b["data"].to(torch.int64).sum()
            for b in ds.iter_device_batches(batch_size=2, prefetch=1)]
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert [int(s) for s in sums] == want and len(keep) == len(want)


def _zero_cfg(llama):
    """_card_train's model: 2 bf16 layers at head_dim 128 (the wgmma
    kernels take head_dim 64 or 128)."""
    return llama.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_dim=512, dtype="bfloat16",
                      remat_policy="dots")


def _zero_card_fn(config):
    """Two use_gpu workers, each on its own card: a tiny bf16 Llama from
    the same seed, its half of each batch, ZeRO-1 (ShardedOptimizer over
    ShardAdamW on the worker's card); rank 0 reports the ranks' mean loss,
    the global grad norm and whether both ranks hold the same norm and
    bitwise the same parameters (read through the ring)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import ShardAdamW, mesh
    from ray_tpu_torch.train.zero import ShardedOptimizer
    dev = torch.device("cuda")
    cfg = _zero_cfg(llama)
    opt = mesh.default_optimizer(1e-2, warmup_steps=1, total_steps=10)
    init_fn, _ = mesh.make_train_step(cfg, device=dev, optimizer=opt)
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    params = list(state.params.parameters())
    so = ShardedOptimizer(ShardAdamW(opt, device=dev))
    zstate = so.init([p.detach() for p in params])
    rank = train.get_context().get_world_rank()
    for step, batch in enumerate(config["batches"]):
        mine = {k: torch.as_tensor(v[2 * rank:2 * rank + 2], device=dev)
                for k, v in batch.items()}
        for p in params:
            p.grad = None
        loss = llama.loss_fn(state.params, mine, cfg)
        loss.backward()
        new, zstate = so.update([p.grad for p in params], zstate,
                                [p.detach() for p in params])
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        flat = torch.cat([p.detach().float().reshape(-1) for p in params])
        seen = np.array([loss.item(), so.grad_norm], np.float64)
        hi = train.allreduce_gradients([seen, flat], op="max")
        lo = train.allreduce_gradients([seen, flat], op="min")
        train.report({"step": step, "grad_norm": so.grad_norm,
                      "loss": float(train.allreduce_gradients(
                          seen, op="mean")[0]),
                      "same": bool(hi[0][1] == lo[0][1]
                                   and torch.equal(hi[1], lo[1])),
                      "card": str(torch.cuda.get_device_name(0)),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def test_zero_trainer_over_two_cards_matches_one_process(dev):
    """ZeRO-1 (mode B of chip_smoke.py's run_dp) through
    TorchTrainer(num_workers=2, use_gpu=True), one card per worker: each
    step's loss (the ranks' mean) and grad norm within the mesh bars of
    one process's steps on the whole batch on card 0, and the ranks'
    parameters bitwise equal."""
    import sys

    import cloudpickle

    import ray_tpu_torch
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    _cards(2)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, 256, (4, 129))
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    cfg = _zero_cfg(llama)
    init_fn, step_fn = mesh.make_train_step(
        cfg, device=dev, optimizer=mesh.default_optimizer(
            1e-2, warmup_steps=1, total_steps=10))
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    want = []
    for b in batches:
        state, m = step_fn(state, b)
        want.append((m["loss"].item(), m["grad_norm"].item()))
    ray_tpu_torch.init(num_cpus=4, resources={
        "GPU": float(torch.cuda.device_count())})
    try:
        res = TorchTrainer(
            _zero_card_fn, train_loop_config={"batches": batches},
            scaling_config=ScalingConfig(num_workers=2,
                                         use_gpu=True)).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert res.error is None, res.error
    rows = res.metrics_history
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(r["same"] for r in rows)
    assert rows[0]["visible"] is not None and "," not in rows[0]["visible"]
    np.testing.assert_allclose([r["loss"] for r in rows],
                               [w[0] for w in want], rtol=2e-3)
    np.testing.assert_allclose([r["grad_norm"] for r in rows],
                               [w[1] for w in want], rtol=2e-2)


def _elastic_card_fn(config):
    """Two workers sharing the card: _card_train's model from the same
    seed, this rank's slice of each batch at the current world size,
    ZeRO-1 with a peer mirror every step; rank 1 dies after its backward
    at step 1, once its step-0 mirror has landed, and rank 0 reshards to
    world 1 and retries the step on the whole batch."""
    import signal

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import ShardAdamW, mesh
    from ray_tpu_torch.train.zero import ShardedOptimizer
    dev = torch.device("cuda")
    cfg = _zero_cfg(llama)
    opt = mesh.default_optimizer(1e-2, warmup_steps=1, total_steps=10)
    init_fn, _ = mesh.make_train_step(cfg, device=dev, optimizer=opt)
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    params = list(state.params.parameters())
    so = ShardedOptimizer(ShardAdamW(opt, device=dev),
                          mirror_interval_steps=1)
    zstate = so.init([p.detach() for p in params])
    ctx = train.get_context()
    step = 0
    while step < len(config["batches"]):
        world, rank = ctx.get_world_size(), ctx.get_world_rank()
        rows = 4 // world
        mine = {k: torch.as_tensor(v[rank * rows:(rank + 1) * rows],
                                   device=dev)
                for k, v in config["batches"][step].items()}
        for p in params:
            p.grad = None
        loss = llama.loss_fn(state.params, mine, cfg)
        loss.backward()
        if step == 1 and rank == 1 and ctx.generation == 0:
            if not ctx.wait_mirror(timeout_s=60):
                raise RuntimeError("the step-0 mirror never landed")
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            new, zstate = so.update([p.grad for p in params], zstate,
                                    [p.detach() for p in params])
        except train.PeerLostError:
            train.await_regroup(timeout_s=60)
            zstate = so.reshard(zstate)
            continue
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        seen = np.array([loss.item()], np.float64)
        if world > 1:
            seen = train.allreduce_gradients(seen, op="mean")
        train.report({"step": step, "loss": float(seen[0]),
                      "grad_norm": so.grad_norm, "world": world,
                      "generation": ctx.generation,
                      "moments_on": str(zstate.mu.device)})
        step += 1


def test_elastic_zero_workers_on_one_card_match_one_process(dev):
    """The in-place elastic reshape with the moments on the card: two
    workers share it, rank 1 is SIGKILLed mid-step 1, rank 0 reshards
    its ShardAdamW moments with rank 1's peer mirror to world 1 and
    finishes. Each step's loss and grad norm within the ZeRO card bars of
    one process's steps on the whole batch; worlds [2, 1, 1], generation
    1, the moments back on the card."""
    import sys

    import cloudpickle

    import ray_tpu_torch
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, 256, (4, 129))
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    cfg = _zero_cfg(llama)
    init_fn, step_fn = mesh.make_train_step(
        cfg, device=dev, optimizer=mesh.default_optimizer(
            1e-2, warmup_steps=1, total_steps=10))
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    want = []
    for b in batches:
        state, m = step_fn(state, b)
        want.append((m["loss"].item(), m["grad_norm"].item()))
    del state
    ray_tpu_torch.init(num_cpus=4)
    try:
        res = TorchTrainer(
            _elastic_card_fn, train_loop_config={"batches": batches},
            scaling_config=ScalingConfig(num_workers=(1, 2),
                                         resources_per_worker={"CPU": 1},
                                         sync_timeout_s=60.0,
                                         elastic_grow_interval_s=0.0),
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=1))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert res.error is None, res.error
    rows = res.metrics_history
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert [r["world"] for r in rows] == [2, 1, 1]
    assert rows[-1]["generation"] == 1
    assert all(r["moments_on"].startswith("cuda") for r in rows)
    np.testing.assert_allclose([r["loss"] for r in rows],
                               [w[0] for w in want], rtol=2e-3)
    np.testing.assert_allclose([r["grad_norm"] for r in rows],
                               [w[1] for w in want], rtol=2e-2)


def _pipeline_run(stages, mbs, steps, actors=None, device=None):
    """``steps`` pipeline steps over ``Pipeline`` (``actors``: two stage
    actors on the runtime; ``device``: the transport) or, with no
    actors, the stage loops on threads over ``wire_local`` on the CPU.
    Returns the losses and both stages' parameters on the CPU."""
    import threading

    import ray_tpu_torch
    from _torch_pipeline_stages import SGD
    from ray_tpu_torch.dag.channel import DATA, STOP
    from ray_tpu_torch.dag.runtime import pipe_exec_loop
    from ray_tpu_torch.runtime.serialization import loads_oob, serialize
    from ray_tpu_torch.train import pipeline as pl
    if actors is not None:
        pipe = pl.Pipeline(actors, num_microbatches=len(mbs),
                           device=device, slot_bytes=1 << 20,
                           timeout_s=120.0)
        try:
            losses = [pipe.step(mbs).loss for _ in range(steps)]
            params = ray_tpu_torch.get(
                [a.get_params.remote() for a in actors], timeout=120)
        finally:
            pipe.teardown()
        return losses, [{k: v.cpu() for k, v in p.items()}
                        for p in params]
    specs, ins, res, chans = pl.wire_local(2, len(mbs))
    cpu = [pl.PipelineStageActor(f, p, optimizer=SGD(0.5),
                                 is_last=k == 1, device="cpu")
           for k, (f, p) in enumerate(stages)]
    ts = [threading.Thread(target=pipe_exec_loop, args=(a, sp[0]))
          for a, sp in zip(cpu, specs)]
    for t in ts:
        t.start()
    losses = []
    try:
        for _ in range(steps):
            for mb in mbs:
                ins[0].write(serialize(mb), DATA, timeout=30)
            reps = [loads_oob(r[0].read_bytes(120)[1]) for r in res]
            losses.append(reps[1]["result"]["loss"])
    finally:
        ins[0].write(b"", STOP, timeout=30)
        for r in res:
            r[0].read_bytes(60)
        for t in ts:
            t.join(60)
        for c in chans:
            c.close()
            c.unlink()
    return losses, [a.params for a in cpu]


def test_tiny_pipeline_on_card_matches_cpu(dev):
    """A tiny two-stage Llama (f32, 2 + 2 layers, head_dim 64, s 128, 4
    microbatches) through ``Pipeline`` over two stage actors on the
    card, over the device transport and over the host transport, against
    the same steps on the CPU: losses within 1e-4 relative and every
    parameter within 1e-4 after 2 steps (f32 on both sides, TF32 off:
    the card's kernels sum in other orders)."""
    import functools
    import sys

    import cloudpickle

    import ray_tpu_torch
    from _torch_pipeline_stages import SGD, llama_stage_fn, \
        llama_stage_params
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import pipeline as pl
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    cfg = llama.tiny(dtype="float32", n_layers=4, vocab_size=256, dim=256,
                     ffn_dim=512)       # head_dim 64: the kernels' least
    model = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    stages = [(functools.partial(llama_stage_fn, cfg, 2, k == 0, k == 1),
               llama_stage_params(model, 2 * k, 2 * k + 2, k == 0, k == 1))
              for k in range(2)]
    rng = np.random.default_rng(4)
    toks = [torch.from_numpy(rng.integers(0, 256, (1, 129)))
            for _ in range(4)]
    mbs = [(t[:, :-1], t[:, 1:]) for t in toks]
    want, want_p = _pipeline_run(stages, mbs, 2)
    ray_tpu_torch.init(num_cpus=4)
    try:
        Stage = ray_tpu_torch.remote(max_concurrency=2)(
            pl.PipelineStageActor)
        for transport in (True, False):
            actors = [Stage.remote(f, p, optimizer=SGD(0.5),
                                   is_last=k == 1, device="cuda")
                      for k, (f, p) in enumerate(stages)]
            got, got_p = _pipeline_run(stages, mbs, 2, actors, transport)
            np.testing.assert_allclose(got, want, rtol=1e-4)
            for a, b in zip(got_p, want_p):
                assert a.keys() == b.keys()
                for k in a:
                    torch.testing.assert_close(a[k], b[k], rtol=1e-4,
                                               atol=1e-4)
            for a in actors:
                ray_tpu_torch.kill(a)
    finally:
        ray_tpu_torch.shutdown()


def test_rllib_updates_on_card_match_cpu(dev):
    """``ppo_update`` (4 epochs x 4 minibatches of a 64 x 8 fragment) and
    ``sac_update`` (8 minibatches of 64) at hidden (64, 64) on the card
    against the same update on the CPU, from the same parameters and
    batch and the same host draws (permutations, normals): every
    parameter within 1e-4 of its tensor's largest entry and the losses
    within 1e-4 relative (f32 on both sides, TF32 off: cuBLAS and MKL sum
    in other orders). Then one ``PPO.train()`` with the learner on the
    card: its policy and Adam state stay there."""
    import copy

    import ray_tpu_torch
    from ray_tpu_torch.rllib import PPO, PPOConfig, nets, ppo, sac

    def gap(a, b):
        return float((a.detach().cpu() - b.detach()).abs().max()
                     / b.detach().abs().max().clamp_min(1e-6))

    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    pol = ppo.init_policy(torch.Generator().manual_seed(0), 4, 2)
    rew, val, last = f(64, 8), f(64, 8), f(8)
    dones = torch.from_numpy((rng.random((64, 8)) < 0.05)
                             .astype(np.float32))
    advs, rets = ppo._gae(rew, val, dones, last, 0.99, 0.95)
    batch = {"obs": f(64, 8, 4),
             "actions": torch.from_numpy(rng.integers(0, 2, (64, 8))),
             "logp": np.log(0.5) + 0.1 * f(64, 8), "advantages": advs,
             "returns": rets}
    perms = ppo.draw_perms(torch.Generator().manual_seed(1), 4, 512)
    card = copy.deepcopy(pol).to(dev)
    want = ppo.ppo_update(pol, nets.adam(pol.parameters(), 3e-4), batch,
                          perms)
    got = ppo.ppo_update(card, nets.adam(card.parameters(), 3e-4),
                         {k: v.to(dev) for k, v in batch.items()},
                         perms.to(dev))
    assert got.device.type == "cuda"
    assert gap(got, want) <= 1e-4
    for a, b in zip(card.parameters(), pol.parameters()):
        assert gap(a, b) <= 1e-4

    g = torch.Generator().manual_seed(2)
    actor, critic = sac.init_actor(g, 3, 1), sac.init_critic(g, 3, 1)
    mbs = {"obs": f(8, 64, 3), "next_obs": f(8, 64, 3),
           "actions": 2 * torch.tanh(f(8, 64, 1)), "rewards": -f(8, 64).abs(),
           "dones": torch.zeros(8, 64)}
    noise = f(8, 2, 64, 1)
    runs = []
    for d in ("cpu", dev):
        a, c = copy.deepcopy(actor).to(d), copy.deepcopy(critic).to(d)
        tc = copy.deepcopy(c).requires_grad_(False)
        la = torch.tensor(np.log(0.1), dtype=torch.float32, device=d,
                          requires_grad=True)
        opts = (nets.adam(a.parameters(), 1e-3),
                nets.adam(c.parameters(), 1e-3), nets.adam([la], 1e-3))
        ls = sac.sac_update(a, c, tc, la, opts,
                            {k: v.to(d) for k, v in mbs.items()},
                            noise.to(d), action_high=2.0)
        runs.append((ls, la, [*a.parameters(), *c.parameters(),
                              *tc.parameters()]))
    (want, wla, wps), (got, gla, gps) = runs
    assert gap(got, want) <= 1e-4 and gap(gla, wla) <= 1e-4
    for a, b in zip(gps, wps):
        assert a.device.type == "cuda" and gap(a, b) <= 1e-4

    ray_tpu_torch.init(num_cpus=2)
    try:
        algo = PPO(PPOConfig(num_env_runners=1, num_envs_per_runner=4,
                             rollout_len=32))
        res = algo.train()
        assert res["timesteps_this_iter"] == 128
        assert np.isfinite(res["loss"])
        for t in [*algo.policy.parameters(), algo.opt.flat, algo.opt.m,
                  algo.opt.v]:
            assert t.device.type == "cuda"
    finally:
        ray_tpu_torch.shutdown()
