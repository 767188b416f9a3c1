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


def _tiny_streams(model, device, mode, reqs):
    """Greedy streams of the tiny engine in one of the serving modes:
    speculative (periodic prompts draft), monolithic, or prefill/decode
    handoff (PrefillEngine payloads admitted by a paged engine)."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.llm.pd import PrefillEngine
    cfg = model.cfg
    kw = dict(max_slots=2, max_len=128, prefill_buckets=(16, 32),
              cache_dtype="float32", device=device)
    if mode == "spec":
        kw["spec"] = True
    if mode == "monolithic":
        kw["kv_block_size"] = 0
    payloads = [None] * len(reqs)
    if mode == "pd":
        pre = PrefillEngine(cfg, model, prefill_buckets=(16, 32),
                            max_len=128, cache_dtype="float32",
                            device=device)
        payloads = [pre.prefill(p) for p, _ in reqs]

    async def run():
        eng = LLMEngine(cfg, model, **kw)
        outs = await asyncio.gather(*[
            eng.generate(p, max_new_tokens=n, prefilled=pl)
            for (p, n), pl in zip(reqs, payloads)])
        await eng.stop()
        return [o["tokens"] for o in outs]

    return asyncio.run(run())


@pytest.mark.parametrize("mode", ["spec", "monolithic", "pd"])
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
