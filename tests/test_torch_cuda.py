"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax, which the port's
machine need not have). They cover what chip_smoke.py does not: f32
inputs, head_dim 64, block sizes 8/16/32, group sizes 1-8, and masking
edge cases. Tolerances: f32 2e-5 (summation order only; TF32 is off);
bf16 2e-2 absolute + 2e-2 relative (q*scale and the output are rounded
to bf16 once each).
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
