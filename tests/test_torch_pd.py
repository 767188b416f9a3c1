"""The port's prefill/decode handoff (ray_tpu_torch/llm/pd.py's
PrefillEngine and LLMEngine's ``prefilled=`` admits) against the JAX
package's, on the JAX package's own seeded weights carried through the
bridge.

Payloads (KV, logits) agree with the JAX PrefillEngine's within 1e-5
relative to their scale and ship the same block-granular length; greedy
streams of a decode engine that admits them equal the unified engine's,
paged and monolithic, and the JAX package's own payload (f32 or ml_dtypes
bf16) gives the JAX engine's stream in the port.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import pd as jpd
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import pd as tpd
from ray_tpu_torch.llm.engine import KVHandoffError, LLMEngine
from ray_tpu_torch.models import llama as tllama

TOL = 1e-5
KW = dict(prefill_buckets=(16, 32), max_len=128)
ENGINE_KW = dict(KW, max_slots=2, kv_block_size=16)


@pytest.fixture(scope="module")
def models():
    args = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, ffn_dim=128, dtype="float32",
                attn_impl="reference")
    jcfg, tcfg = jllama.tiny(**args), tllama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, params, tcfg, bridge.params_from_numpy(tree, tcfg, "cpu")


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=TOL)


# (prompt, max_new_tokens): one bucket, block-granular slicing inside a
# bucket (20 tokens ship 32 positions of bucket 32), and a prompt past the
# largest bucket (chunked prefill, 70 tokens ship 80)
PROMPTS = [([3, 7, 11, 19, 2], 12), (_prompt(1, 20), 10),
           (_prompt(2, 70), 8)]


def _prefill(mod, model, cfg, dtype, prompts=PROMPTS, **kw):
    eng = mod.PrefillEngine(cfg, model, cache_dtype=dtype, **dict(KW, **kw))
    return [eng.prefill(p) for p, _ in prompts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payloads_match_jax(models, dtype):
    jcfg, params, tcfg, model = models
    want = _prefill(jpd, params, jcfg, dtype)
    got = _prefill(tpd, model, tcfg, dtype, device="cpu")
    for (p, _), g, w in zip(PROMPTS, got, want):
        assert g["length"] == w["length"] == len(p)
        assert g["k"].shape == w["k"].shape
        assert g["k"].shape[1] == -(-len(p) // 16) * 16
        assert g["k"].dtype == np.float32 and g["logits"].shape == (128,)
        for key in ("k", "v", "logits"):
            _close(g[key], w[key])
        if dtype == "bfloat16":     # bf16 values carried exactly in f32
            assert np.array_equal(
                g["k"], torch.from_numpy(g["k"]).bfloat16().float().numpy())


def test_block_size_follows_the_engine_gcd_and_zero_ships_buckets(models):
    _, _, tcfg, model = models
    eng = tpd.PrefillEngine(tcfg, model, prefill_buckets=(24, 48),
                            max_len=96, device="cpu")
    assert eng.block_size == 8
    assert eng.prefill(_prompt(3, 10))["k"].shape[1] == 16
    whole = tpd.PrefillEngine(tcfg, model, block_size=0, device="cpu", **KW)
    assert whole.prefill(_prompt(3, 10))["k"].shape[1] == 16
    assert whole.prefill(_prompt(3, 20))["k"].shape[1] == 32
    with pytest.raises(NotImplementedError, match="item 8.5"):
        whole.prefill([1, 2], device=True)
    with pytest.raises(ValueError, match="empty prompt"):
        whole.prefill([])
    with pytest.raises(ValueError, match="max_len"):
        whole.prefill([1] * 129)


def _drive(eng, prompts, payloads=None):
    async def go():
        outs = await asyncio.gather(*[
            eng.generate_prefilled(p, payloads[i], max_new_tokens=n)
            if payloads is not None else eng.generate(p, max_new_tokens=n)
            for i, (p, n) in enumerate(prompts)])
        st = eng.stats
        await eng.stop()
        return [o["tokens"] for o in outs], st
    return asyncio.run(go())


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_prefilled_streams_equal_unified(models, kv_block_size):
    _, _, tcfg, model = models
    kw = dict(ENGINE_KW, kv_block_size=kv_block_size, device="cpu",
              cache_dtype="float32")
    want, _ = _drive(LLMEngine(tcfg, model, **kw), PROMPTS)
    payloads = _prefill(tpd, model, tcfg, "float32", device="cpu")
    got, st = _drive(LLMEngine(tcfg, model, **kw), PROMPTS, payloads)
    assert got == want
    assert st["handoff_bytes"] == sum(p["k"].nbytes + p["v"].nbytes
                                      for p in payloads)


def test_stream_prefilled(models):
    _, _, tcfg, model = models
    payload = _prefill(tpd, model, tcfg, "float32", device="cpu")[0]
    want, _ = _drive(LLMEngine(tcfg, model, device="cpu",
                               cache_dtype="float32", **ENGINE_KW),
                     PROMPTS[:1])

    async def go():
        eng = LLMEngine(tcfg, model, device="cpu", cache_dtype="float32",
                        **ENGINE_KW)
        toks = [t async for t in eng.generate_stream_prefilled(
            PROMPTS[0][0], payload, max_new_tokens=PROMPTS[0][1])]
        await eng.stop()
        return toks

    assert asyncio.run(go()) == want[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_jax_payload_gives_the_jax_stream(models, dtype, kv_block_size):
    """The JAX PrefillEngine's payload (ml_dtypes bf16 numpy when the
    cache is bf16) admitted by the port's engine and by the JAX engine:
    the same greedy streams."""
    jcfg, params, tcfg, model = models
    payloads = _prefill(jpd, params, jcfg, dtype)
    kw = dict(ENGINE_KW, kv_block_size=kv_block_size, cache_dtype=dtype)
    want, _ = _drive(JaxEngine(jcfg, params, **kw), PROMPTS, payloads)
    got, st = _drive(LLMEngine(tcfg, model, device="cpu", **kw), PROMPTS,
                     payloads)
    assert got == want
    assert st["handoff_bytes"] == sum(p["k"].nbytes + p["v"].nbytes
                                      for p in payloads)


def test_malformed_payload_raises(models):
    _, _, tcfg, model = models
    good = _prefill(tpd, model, tcfg, "float32", device="cpu")[0]
    prompt = PROMPTS[0][0]

    async def go():
        eng = LLMEngine(tcfg, model, device="cpu", **ENGINE_KW)
        with pytest.raises(ValueError, match="prefilled payload missing"):
            await eng.generate(prompt, prefilled={"k": good["k"]})
        with pytest.raises(ValueError, match="prefilled length"):
            await eng.generate(prompt + [5], prefilled=good)
        long = dict(good, k=np.zeros((2, 144, 2, 16), np.float32))
        with pytest.raises(ValueError, match="decode max_len"):
            await eng.generate(prompt, prefilled=long)
        await eng.stop()

    asyncio.run(go())


class _Handle:
    """A KV handle that is not a plain array (a device-resident
    TensorRef has a shape, and no array behind it here)."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_handle_fails_only_its_own_request(models, kv_block_size):
    _, _, tcfg, model = models
    payload = _prefill(tpd, model, tcfg, "float32", device="cpu")[0]
    bad = dict(payload, k=_Handle(payload["k"].shape))
    kw = dict(ENGINE_KW, kv_block_size=kv_block_size, device="cpu",
              cache_dtype="float32")
    want, _ = _drive(LLMEngine(tcfg, model, **kw), PROMPTS[1:2])

    async def go():
        eng = LLMEngine(tcfg, model, **kw)
        results = await asyncio.gather(
            eng.generate_prefilled(PROMPTS[0][0], bad, max_new_tokens=4),
            eng.generate(*PROMPTS[1][:1], max_new_tokens=PROMPTS[1][1]),
            return_exceptions=True)
        after = await eng.generate(PROMPTS[1][0],
                                   max_new_tokens=PROMPTS[1][1])
        st = eng.stats
        await eng.stop()
        return results, after, st

    (err, ok), after, st = asyncio.run(go())
    assert isinstance(err, KVHandoffError) and "item 8.5" in str(err)
    assert ok["tokens"] == after["tokens"] == want[0]
    if kv_block_size:
        assert st["blocks_used"] == 0
