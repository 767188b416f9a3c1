"""The port's monolithic KV cache (init_cache, write_prefill_to_cache,
decode_steps in llm/model.py, and LLMEngine(kv_block_size=0)) against the
JAX package's, on the JAX package's own seeded weights carried through
the bridge.

Pure data movement (the cache's layout, the prefill write) agrees bit for
bit; cache contents after decode to 1e-5 relative to their scale; greedy
token streams exactly. The engine's monolithic streams also equal the
port's paged streams (the same prefill at the same bucket, then decode
attention in another layout).
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import model as jlm
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import model as tlm
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import llama as tllama

TOL = 1e-5
ENGINE_KW = dict(max_slots=2, max_len=64, prefill_buckets=(16,),
                 cache_dtype="float32", kv_block_size=0)


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
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=TOL)


def _filled_caches(models, prompts, L):
    """Both packages' slot caches of length L with prompt i prefilled
    into slot i (bucket 16); returns (jcache, tcache, first tokens)."""
    jcfg, params, tcfg, model = models
    jc = jlm.init_cache(jcfg, len(prompts), L, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, len(prompts), L, torch.float32, "cpu")
    first = []
    for slot, p in enumerate(prompts):
        padded = tlm.pad_prompt(p, 16)
        jl, jkv = jlm.prefill(params, jnp.asarray(padded),
                              jnp.int32(len(p)), jcfg, L)
        _, tkv = tlm.prefill(model, torch.from_numpy(padded), len(p), tcfg,
                             L)
        jc = jlm.write_prefill_to_cache(jc, jkv, jnp.int32(slot),
                                        jnp.int32(len(p)))
        tlm.write_prefill_to_cache(tc, tkv, slot, len(p))
        first.append(int(np.argmax(np.asarray(jl))))
    return jc, tc, first


def test_init_cache_matches_jax(models):
    jcfg, _, tcfg, _ = models
    jc = jlm.init_cache(jcfg, 3, 40, dtype=jnp.bfloat16)
    tc = tlm.init_cache(tcfg, 3, 40, torch.bfloat16, "cpu")
    for key in ("k", "v", "length"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert not tc[key].any()
    assert tc["k"].dtype == torch.bfloat16
    assert tc["length"].dtype == torch.int32
    with pytest.raises(NotImplementedError, match="item 11"):
        tlm.init_cache(tcfg, 3, 40, torch.float32, "cpu", mesh=object())


def test_write_prefill_to_cache_matches_jax(models):
    """Random KV into slot 1 of 3 (shorter than the cache, so its tail
    keeps what was there), then slot 0 over it: bitwise equal, in place."""
    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(0)
    jc = jlm.init_cache(jcfg, 3, 32, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, 3, 32, torch.float32, "cpu")
    k_before = tc["k"]
    for slot, n, length in ((1, 32, 7), (0, 24, 20), (1, 16, 9)):
        shape = (tcfg.n_layers, n, tcfg.n_kv_heads, tcfg.head_dim)
        kv = {k: rng.normal(size=shape).astype(np.float32)
              for k in ("k", "v")}
        jc = jlm.write_prefill_to_cache(
            jc, {k: jnp.asarray(v) for k, v in kv.items()},
            jnp.int32(slot), jnp.int32(length))
        tlm.write_prefill_to_cache(
            tc, {k: torch.from_numpy(v) for k, v in kv.items()}, slot,
            length)
    assert tc["k"] is k_before
    for key in ("k", "v", "length"):
        assert np.array_equal(tc[key].numpy(), np.asarray(jc[key]))


def test_decode_steps_greedy_match_jax(models):
    """Six chained greedy steps over three slots: the same tokens, the
    same cache contents and lengths."""
    jcfg, params, tcfg, model = models
    prompts = [_prompt(1, 5), _prompt(2, 13), _prompt(3, 9)]
    jc, tc, first = _filled_caches(models, prompts, 32)
    toks = np.asarray(first, np.int32)
    temps = np.zeros((3,), np.float32)
    jout, jc = jlm.decode_steps(params, jc, jnp.asarray(toks),
                               jnp.asarray(temps), jax.random.PRNGKey(0),
                               jcfg, 6)
    tout, tc = tlm.decode_steps(model, tc, torch.from_numpy(toks),
                                torch.from_numpy(temps), None, tcfg, 6)
    assert tout.dtype == torch.int32 and tout.shape == (6, 3)
    assert np.array_equal(tout.numpy(), np.asarray(jout))
    assert np.array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    # decode_step is one step of the same loop
    one, _ = tlm.decode_step(model, tc, tout[-1], None, None, tcfg)
    assert one.shape == (3,) and int(tc["length"][0]) == 5 + 7


def test_decode_past_the_cache_writes_its_last_position(models):
    """An empty slot whose length counter ran past the cache (JAX drops
    such a write) writes the last position instead of raising; the other
    slots decode as in JAX."""
    jcfg, params, tcfg, model = models
    jc, tc, first = _filled_caches(models, [_prompt(4, 6), _prompt(5, 6)],
                                   16)
    jc["length"] = jc["length"].at[1].set(15)
    tc["length"][1] = 15
    toks = np.asarray(first, np.int32)
    jout, _ = jlm.decode_steps(params, jc, jnp.asarray(toks),
                              jnp.zeros((2,), jnp.float32),
                              jax.random.PRNGKey(0), jcfg, 4)
    tout, tc = tlm.decode_steps(model, tc, torch.from_numpy(toks), None,
                                None, tcfg, 4)
    assert np.array_equal(tout[:, 0].numpy(), np.asarray(jout)[:, 0])
    assert tc["length"].tolist() == [10, 19]


def _run(eng, requests):
    async def go():
        outs = await asyncio.gather(*[eng.generate(p, max_new_tokens=n)
                                      for p, n in requests])
        st = eng.stats
        await eng.stop()
        return outs, st
    return asyncio.run(go())


A = _prompt(10, 20)
REQUESTS = [                       # (prompt, max_new_tokens)
    (A, 4),
    (_prompt(11, 40), 8),          # > largest bucket: chunked prefill
    (_prompt(12, 6), 6),
    (A + _prompt(13, 6), 5),       # shares A's prefix (paged: a hit)
]


def test_engine_streams_match_jax_and_paged(models):
    jcfg, params, tcfg, model = models
    want, jst = _run(JaxEngine(jcfg, params, **ENGINE_KW), REQUESTS)
    got, st = _run(LLMEngine(tcfg, model, device="cpu", **ENGINE_KW),
                   REQUESTS)
    paged, _ = _run(LLMEngine(tcfg, model, device="cpu",
                              **dict(ENGINE_KW, kv_block_size=8)), REQUESTS)
    tokens = [o["tokens"] for o in got]
    assert tokens == [o["tokens"] for o in want]
    assert tokens == [o["tokens"] for o in paged]
    # the JAX engine's keys: no prefix hits and no pool off the pool path
    assert all(set(o) == set(w) == {"tokens", "ttft_s"}
               for o, w in zip(got, want))
    assert {k: st[k] for k in jst} == {**jst, "ttft_sum": st["ttft_sum"]}
    assert st["paged"] is False and st["cache_len"] == 64
    assert st["tokens_generated"] == sum(n for _, n in REQUESTS)


def test_engine_grows_the_cache_like_jax(models):
    """max_len 2048: the cache starts at 1024 and doubles when a
    1010-token prompt (chunked over eight 128-token pieces) with 40 new
    tokens is admitted beside a short request already holding a slot,
    whose KV the growth keeps."""
    jcfg, params, tcfg, model = models
    kw = dict(ENGINE_KW, max_len=2048, prefill_buckets=(64, 128))
    reqs = [(_prompt(20, 30), 40), (_prompt(21, 1010), 40)]
    want, jst = _run(JaxEngine(jcfg, params, **kw), reqs)
    eng = LLMEngine(tcfg, model, device="cpu", **kw)
    assert eng.stats["cache_len"] == 1024
    got, st = _run(eng, reqs)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert st["cache_len"] == jst["cache_len"] == 2048
    assert tuple(eng._cache["k"].shape[2:3]) == (2048,)
