"""The port's prefill/decode handoff (ray_tpu_torch/llm/pd.py's
PrefillEngine and LLMEngine's ``prefilled=`` admits) against the JAX
package's, on the JAX package's own seeded weights carried through the
bridge.

Payloads (KV, logits) agree with the JAX PrefillEngine's within 1e-5
relative to their scale and ship the same block-granular length, in the
cache dtype: a bf16 payload's bits (uint16) are the JAX payload's; greedy
streams of a decode engine that admits them equal the unified engine's,
paged and monolithic, and the JAX package's own payload (f32 or ml_dtypes
bf16) gives the JAX engine's stream in the port.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import pd as jpd
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import pd as tpd
from ray_tpu_torch.llm.engine import KVHandoffError, LLMEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.runtime.device_store import _store

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
        assert g["logits"].shape == (128,) and g["kv_dtype"] == dtype
        # bf16 ships as its raw bits, the same bytes as JAX's ml_dtypes
        assert g["k"].dtype == (np.uint16 if dtype == "bfloat16"
                                else np.float32)
        assert g["k"].nbytes == w["k"].nbytes
        for key in ("k", "v"):
            _close(tpd.kv_to_torch(g[key], g["kv_dtype"]).float().numpy(),
                   np.asarray(w[key], np.float32))
        _close(g["logits"], w["logits"])


def _bf16_bits(x):
    """The JAX package's cast of f32 values to bf16, as uint16 bits."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      ).view(np.uint16)


def test_bf16_payload_bits_equal_jax(models):
    """The port's bf16 payload is the JAX package's byte format: uint16
    bits, bit for bit the JAX payload's ``.view(np.uint16)`` wherever the
    two packages' f32 forwards agree. A one-bucket prompt's payload is
    the bf16 cast of its f32 KV (the same prompt at cache float32) in
    both packages, so each element that differs is one whose f32 values
    differ (XLA and torch round a few to neighbouring ulps): the encoding
    never differs, only its input. The chunked prompt's later pieces
    attend to bf16 KV, so it is held to the same small share of flips."""
    jcfg, params, tcfg, model = models
    want = _prefill(jpd, params, jcfg, "bfloat16")
    want32 = _prefill(jpd, params, jcfg, "float32")
    got = _prefill(tpd, model, tcfg, "bfloat16", device="cpu")
    got32 = _prefill(tpd, model, tcfg, "float32", device="cpu")
    flips = total = 0
    for (p, _), g, w, g32, w32 in zip(PROMPTS, got, want, got32, want32):
        assert w["k"].dtype.name == "bfloat16"
        for key in ("k", "v"):
            bits, jbits = g[key], w[key].view(np.uint16)
            assert bits.dtype == np.uint16 and bits.shape == jbits.shape
            differ = bits != jbits
            if len(p) <= KW["prefill_buckets"][-1]:
                assert np.array_equal(bits, _bf16_bits(g32[key]))
                assert np.array_equal(jbits, _bf16_bits(w32[key]))
                assert np.all(g32[key][differ] != w32[key][differ])
            flips += int(differ.sum())
            total += bits.size
    assert flips <= total // 1000, (flips, total)


def test_block_size_follows_the_engine_gcd_and_zero_ships_buckets(models):
    _, _, tcfg, model = models
    eng = tpd.PrefillEngine(tcfg, model, prefill_buckets=(24, 48),
                            max_len=96, device="cpu")
    assert eng.block_size == 8
    assert eng.prefill(_prompt(3, 10))["k"].shape[1] == 16
    whole = tpd.PrefillEngine(tcfg, model, block_size=0, device="cpu", **KW)
    assert whole.prefill(_prompt(3, 10))["k"].shape[1] == 16
    assert whole.prefill(_prompt(3, 20))["k"].shape[1] == 32
    # handles park the same bucket-granular span
    handles = whole.prefill([1, 2], device=True)
    assert handles["k"].shape[1] == handles["v"].shape[1] == 16
    for key in ("k", "v"):
        handles[key].free()
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


def _retag(p, case):
    """A payload whose KV arrays and ``"kv_dtype"`` tag disagree."""
    bits = {key: p[key].astype(np.float32).view(np.uint32).astype(
        np.uint16) for key in ("k", "v")}
    return {
        "untagged_bits": dict(p, kv_dtype=None, **bits),
        "bits_tagged_float32": dict(p, kv_dtype="float32", **bits),
        "floats_tagged_bfloat16": dict(p, kv_dtype="bfloat16"),
        "untagged_int32": dict(p, k=p["k"].astype(np.int32),
                               v=p["v"].astype(np.int32)),
    }[case]


@pytest.mark.parametrize("case", ["untagged_bits", "bits_tagged_float32",
                                  "floats_tagged_bfloat16",
                                  "untagged_int32"])
def test_mistagged_payload_raises(models, case):
    """KV arrays that do not hold what the payload's tag says (integer
    bits without the bf16 tag, a tag naming another dtype) fail their
    request at submit, before any cache write, and the engine serves on."""
    _, _, tcfg, model = models
    good = _prefill(tpd, model, tcfg, "float32", device="cpu")[0]
    prompt = PROMPTS[0][0]

    async def go():
        eng = LLMEngine(tcfg, model, device="cpu", cache_dtype="float32",
                        **ENGINE_KW)
        with pytest.raises(ValueError, match="kv_dtype"):
            await eng.generate(prompt, prefilled=_retag(good, case))
        out = await eng.generate_prefilled(prompt, good, max_new_tokens=4)
        await eng.stop()
        return out

    assert len(asyncio.run(go())["tokens"]) == 4


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_bf16_payload_streams_equal_unified(models, kv_block_size):
    """The port's own tagged bf16 payload, admitted by a bf16-cache
    engine, gives the unified engine's greedy streams."""
    _, _, tcfg, model = models
    kw = dict(ENGINE_KW, kv_block_size=kv_block_size, device="cpu",
              cache_dtype="bfloat16")
    want, _ = _drive(LLMEngine(tcfg, model, **kw), PROMPTS)
    payloads = _prefill(tpd, model, tcfg, "bfloat16", device="cpu")
    got, st = _drive(LLMEngine(tcfg, model, **kw), PROMPTS, payloads)
    assert got == want
    assert st["handoff_bytes"] == sum(p["k"].nbytes + p["v"].nbytes
                                      for p in payloads)


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_handle_fails_only_its_own_request(models, kv_block_size):
    """A device-resident handle freed before its admit (a dead handoff)
    fails that request with KVHandoffError; the request beside it and
    the next one are served, no block stays reserved, and the engine
    freed the payload's live handle too: nothing stays parked."""
    _, _, tcfg, model = models
    pre = tpd.PrefillEngine(tcfg, model, cache_dtype="float32",
                            device="cpu", **KW)
    live0 = _store().live_count()
    bad = pre.prefill(PROMPTS[0][0], device=True)
    bad["k"].free()
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
    assert isinstance(err, KVHandoffError) and "unresolvable" in str(err)
    assert _store().live_count() == live0
    assert ok["tokens"] == after["tokens"] == want[0]
    if kv_block_size:
        assert st["blocks_used"] == 0


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_handles_freed_when_the_cache_write_fails(models, kv_block_size,
                                                  monkeypatch):
    """A cache write that raises after both handles resolved fails the
    request, and the engine frees both handles all the same."""
    _, _, tcfg, model = models
    pre = tpd.PrefillEngine(tcfg, model, cache_dtype="float32",
                            device="cpu", **KW)
    live0 = _store().live_count()
    payload = pre.prefill(PROMPTS[0][0], device=True)
    assert _store().live_count() == live0 + 2

    def boom(*a, **k):
        raise RuntimeError("cache write failed")
    from ray_tpu_torch.llm import engine as teng
    monkeypatch.setattr(teng.kvcache, "scatter_table", boom)
    monkeypatch.setattr(teng.lm, "write_prefill_to_cache", boom)
    eng = LLMEngine(tcfg, model, **dict(ENGINE_KW, device="cpu",
                                        kv_block_size=kv_block_size,
                                        cache_dtype="float32"))

    async def go():
        with pytest.raises(RuntimeError, match="cache write failed"):
            await eng.generate_prefilled(PROMPTS[0][0], payload,
                                         max_new_tokens=4)
        await eng.stop()

    asyncio.run(go())
    assert _store().live_count() == live0
