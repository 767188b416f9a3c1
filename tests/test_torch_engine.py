"""The port's LLMEngine against ray_tpu's LLMEngine on the same bridged
weights: four concurrent greedy requests (one longer than the largest
prefill bucket, so chunked; one repeating an earlier prompt's prefix, so
a prefix hit) give equal token streams and equal prefix-hit counts.

The JAX engine decodes through its Pallas paged kernel in interpret mode
(kv_impl="paged_flash"); the port runs on device="cpu", which takes its
plain versions. Both engines are deterministic schedulers, so the
admission order, block reservations and cache hits line up.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.llm.engine import DeadlineExceeded, LLMEngine
from ray_tpu_torch.models import llama as tllama

ENGINE_KW = dict(max_slots=2, max_len=64, prefill_buckets=(16,),
                 cache_dtype="float32", kv_block_size=8, prefix_cache=True)


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


A = _prompt(10, 20)
REQUESTS = [                       # (prompt, max_new_tokens)
    (A, 4),                        # two full blocks cached at finish
    (_prompt(11, 40), 8),          # > largest bucket: chunked prefill
    (_prompt(12, 6), 6),
    (A + _prompt(13, 6), 5),       # repeats A's prefix: prefix hit
]


@pytest.fixture(scope="module")
def models():
    args = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, ffn_dim=128, dtype="float32",
                attn_impl="reference")
    jcfg, tcfg = jllama.tiny(**args), tllama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, params, tcfg, bridge.params_from_numpy(tree, tcfg, "cpu")


async def _run(eng, requests):
    outs = await asyncio.gather(*[
        eng.generate(p, max_new_tokens=n) for p, n in requests])
    stats = eng.stats
    await eng.stop()
    return outs, stats


@pytest.fixture(scope="module")
def jax_run(models):
    jcfg, params, _, _ = models
    return asyncio.run(_run(
        JaxEngine(jcfg, params, kv_impl="paged_flash", **ENGINE_KW),
        REQUESTS))


def test_streams_and_prefix_hits_match_jax_engine(models, jax_run):
    _, _, tcfg, model = models
    want, want_stats = jax_run
    got, stats = asyncio.run(_run(
        LLMEngine(tcfg, model, device="cpu", **ENGINE_KW), REQUESTS))
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert [o["prefix_hit_tokens"] for o in got] == \
        [o["prefix_hit_tokens"] for o in want]
    assert got[3]["prefix_hit_tokens"] >= 16
    assert stats["prefix_hit_tokens"] == want_stats["prefix_hit_tokens"]
    assert stats["tokens_generated"] == sum(n for _, n in REQUESTS)
    assert stats["blocks_used"] == 0 and stats["kv_impl"] == "gather"


def test_paged_flash_impl_on_cpu_matches(models, jax_run):
    """kv_impl="paged_flash" on the CPU runs the paged kernel's plain
    version through the same attend hook the CUDA kernel uses."""
    _, _, tcfg, model = models
    want, _ = jax_run
    got, stats = asyncio.run(_run(
        LLMEngine(tcfg, model, device="cpu", kv_impl="paged_flash",
                  **ENGINE_KW), REQUESTS))
    assert stats["kv_impl"] == "paged_flash"
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]


def _engine(models, **kw):
    _, _, tcfg, model = models
    args = dict(ENGINE_KW, device="cpu")
    args.update(kw)
    return LLMEngine(tcfg, model, **args)


def test_eos_stop_and_stream(models, jax_run):
    want = jax_run[0][2]["tokens"]          # greedy stream of request 2
    prompt = REQUESTS[2][0]

    async def go():
        eng = _engine(models)
        eos = await eng.generate(prompt, max_new_tokens=6, eos_id=want[2])
        stop = await eng.generate(prompt, max_new_tokens=6,
                                  stop=[want[3:5]])
        streamed = [t async for t in eng.generate_stream(
            prompt, max_new_tokens=6)]
        await eng.stop()
        return eos, stop, streamed

    eos, stop, streamed = asyncio.run(go())
    first_eos = want.index(want[2])
    assert eos["tokens"] == want[:first_eos + 1]
    assert stop["tokens"] == want[:3]
    assert streamed == want


def test_sampling_filters_stay_in_top_k(models):
    async def go():
        eng = _engine(models, seed=3)
        out = await eng.generate(REQUESTS[0][0], max_new_tokens=8,
                                 temperature=1.0, top_k=1)
        greedy = await eng.generate(REQUESTS[0][0], max_new_tokens=8)
        await eng.stop()
        return out, greedy

    out, greedy = asyncio.run(go())
    assert out["tokens"] == greedy["tokens"]   # top_k=1 is greedy


def test_deadline_exceeded(models):
    async def go():
        eng = _engine(models)
        with pytest.raises(DeadlineExceeded):
            await eng.generate([1, 2, 3], deadline_ts=time.time() - 1)
        with pytest.raises(DeadlineExceeded):
            await eng.generate([1, 2, 3], max_new_tokens=40,
                               deadline_ts=time.time() + 1e-3)
        ok = await eng.generate([1, 2, 3], max_new_tokens=2)
        await eng.stop()
        return ok

    assert len(asyncio.run(go())["tokens"]) == 2


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "tensor-parallel"),
])
def test_unported_options_raise(models, kw, match):
    """``mesh=`` takes a ``TensorMesh``; anything else is refused before
    the engine builds anything (tensor-parallel serving itself is held to
    the JAX engine in ``test_torch_llm_sharded.py``)."""
    with pytest.raises(TypeError, match=match):
        _engine(models, **kw)


def test_prefilled_and_bad_requests_raise(models):
    async def go():
        eng = _engine(models)
        with pytest.raises(ValueError, match="prefilled payload missing"):
            await eng.generate([1, 2], max_new_tokens=4,
                               prefilled={"k": None})
        with pytest.raises(ValueError, match="max_len"):
            await eng.generate([1] * 60, max_new_tokens=8)
        with pytest.raises(ValueError, match="empty prompt"):
            await eng.generate([])
        await eng.stop()

    asyncio.run(go())


def test_params_on_another_device_raise(models):
    _, _, tcfg, _ = models
    meta = tllama.Llama(tcfg)
    with pytest.raises(ValueError, match="move them first"):
        LLMEngine(tcfg, meta, device="cpu", **ENGINE_KW)
    assert torch.device("meta") == meta.device
