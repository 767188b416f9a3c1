"""The port's speculative decoding (ray_tpu_torch/llm/spec.py, the verify
forward in llm/model.py and llm/kvcache.py, paged_attention_verify, and
the engine's spec mode) against the JAX package's, on the JAX package's
own seeded weights carried through the bridge.

The host pieces (width buckets, the drafter, acceptance, host_probs) are
numpy on both sides and agree exactly (host_probs within 1e-6).
paged_attention_verify agrees within 1e-6; verify logits within 1e-5
relative to their scale (XLA-CPU and torch-CPU reduce in different
orders). Greedy speculative streams equal the port's vanilla streams and
the JAX engine's speculative streams token for token (tiny widths, f32).
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import kvcache as jkv
from ray_tpu.llm import model as jlm
from ray_tpu.llm import spec as jspec
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu.ops.pallas import paged_attention as jpa

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import kvcache as tkv
from ray_tpu_torch.llm import model as tlm
from ray_tpu_torch.llm import spec as tspec
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import paged_attention as tpa

TOL = 1e-5
ENGINE_KW = dict(max_slots=4, max_len=128, prefill_buckets=(32, 64),
                 cache_dtype="float32", kv_block_size=16)


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


def _periodic(seed, n=48, period=16):
    return (_prompt(seed, period) * (n // period + 1))[:n]


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=TOL)


# --- host pieces ------------------------------------------------------


@pytest.mark.parametrize("k", range(1, 10))
def test_width_buckets_and_bucket_width_match_jax(k):
    b = tspec.width_buckets(k)
    assert b == jspec.width_buckets(k)
    assert [tspec.bucket_width(b, w) for w in range(1, k + 3)] == \
        [jspec.bucket_width(b, w) for w in range(1, k + 3)]


def test_width_buckets_reject_zero():
    with pytest.raises(ValueError):
        tspec.width_buckets(0)


def _drafter_script(mod):
    """One scripted propose/record sequence over periodic, constant and
    unique histories, with backoff, re-probe and escalation; returns
    every proposal and the drafter's state after each step."""
    d = mod.PromptLookupDrafter(k=4, ngram_max=3, window=8)
    rng = np.random.default_rng(0)
    hists = [[1, 2, 3, 4] * 5, [7] * 20, list(range(40)),
             [int(x) for x in rng.integers(0, 6, 50)]]
    out = []
    for step in range(24):
        hist = hists[step % len(hists)]
        out.append(d.propose(hist, (step % 5) or None))
        if step % 3 == 0:
            d.record(4, step % 2 * 4)
        out.append((d._cooldown, d._backoff, d.drafted, d.accepted,
                    list(d._recent), d.accept_rate))
    return out


def test_drafter_sequences_match_jax():
    assert _drafter_script(tspec) == _drafter_script(jspec)


def _rows(seed, argmaxes, v=16):
    out = np.random.default_rng(seed).normal(size=(len(argmaxes), v))
    out = out.astype(np.float32)
    for j, t in enumerate(argmaxes):
        out[j, t] = out[j].max() + 2.0
    return out


@pytest.mark.parametrize("draft", [[3, 5, 7], [3, 6, 7], [], [4]])
def test_accept_greedy_matches_jax(draft):
    logits = _rows(0, [3, 5, 7, 9])[:len(draft) + 1]
    kw = dict(temperature=0.0, top_k=0, top_p=1.0)
    got = tspec.accept_tokens(logits, draft, rng=np.random.default_rng(0),
                              **kw)
    assert got == jspec.accept_tokens(
        logits, draft, rng=np.random.default_rng(0), **kw)


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6), (0.9, 3, 0.8)])
def test_host_probs_match_jax(temp, top_k, top_p):
    logits = np.random.default_rng(4).normal(size=(48,)).astype(
        np.float32) * 2
    got = tspec.host_probs(logits, temp, top_k, top_p)
    want = jspec.host_probs(logits, temp, top_k, top_p)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.sum() == pytest.approx(1.0)


def test_rejection_sampling_matches_jax_on_one_rng():
    """The same logits and drafts, one seeded default_rng per side: the
    same emitted tokens and accept counts, round after round."""
    logits = np.random.default_rng(5).normal(size=(5, 24)).astype(
        np.float32) * 2
    drafts = [[1, 2, 3, 4], [int(np.argmax(logits[0])), 0], [7], []]
    kw = dict(temperature=0.8, top_k=10, top_p=0.9)
    trng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    got, want = [], []
    for _ in range(20):
        for d in drafts:
            rows = logits[:len(d) + 1]
            got.append(tspec.accept_tokens(rows, d, rng=trng, **kw))
            want.append(jspec.accept_tokens(rows, d, rng=jrng, **kw))
    assert got == want


# --- verify attention and the verify forward --------------------------


def test_paged_attention_verify_matches_jax():
    rng = np.random.default_rng(0)
    b, wq, kvh, g, hd, bs, w, nb = 3, 5, 2, 2, 16, 8, 4, 14
    q = rng.normal(size=(b, wq, kvh, g, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    tables = (1 + rng.permutation(nb - 1)[:b * w]).reshape(b, w).astype(
        np.int32)
    cached = np.asarray([1, 13, 26], np.int32)     # w*bs = 32 positions
    lengths = (cached[:, None] + np.arange(1, wq + 1)[None]).clip(
        max=w * bs).astype(np.int32)
    want = jpa.paged_attention_verify(*map(jnp.asarray, (q, kp, vp, tables,
                                                         lengths)))
    got = tpa.paged_attention_verify(*map(torch.from_numpy,
                                          (q, kp, vp, tables, lengths)))
    assert got.dtype == torch.float32 and got.shape == (b, wq, kvh, g, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _pools(models, prompts, bs=8, nb=16, w=4):
    """Both packages' pools with each prompt prefilled into disjoint
    blocks (bucket 16); returns (jpool, tpool, tables, lengths, first)."""
    jcfg, params, tcfg, model = models
    jpool = jkv.init_pool(jcfg, nb, bs, jnp.float32)
    tpool = tkv.init_pool(tcfg, nb, bs, torch.float32, "cpu")
    tables = np.zeros((len(prompts), w), np.int32)
    lengths, first, nxt = [], [], 1
    for i, p in enumerate(prompts):
        padded = tlm.pad_prompt(p, 16)
        jl, jkvs = jlm.prefill(params, jnp.asarray(padded),
                               jnp.int32(len(p)), jcfg, 16)
        _, tkvs = tlm.prefill(model, torch.from_numpy(padded), len(p),
                              tcfg, 16)
        phys = np.arange(nxt, nxt + 2, dtype=np.int32)
        tables[i, :2] = phys
        tables[i, 2:] = nxt + 2 + np.arange(w - 2)
        nxt += w
        jpool = jkv.scatter_bucket(jpool, jkvs, jnp.asarray(phys), 2)
        tkv.scatter_bucket(tpool, tkvs, phys, 2)
        lengths.append(len(p))
        first.append(int(np.argmax(np.asarray(jl))))
    return jpool, tpool, tables, np.asarray(lengths, np.int32), first


@pytest.mark.parametrize("impl", ["gather", "paged_flash"])
def test_paged_verify_steps_match_jax(models, impl):
    """w = 5 in-flight tokens at lengths 5, 13 and 30 of a 32-position
    table: the last slot's tail columns run past its table and clip into
    its last row, as JAX clips. The port's one verify path (through
    paged_attention_verify) against both of the JAX package's impls."""
    jcfg, params, tcfg, model = models
    prompts = [_prompt(1, 5), _prompt(2, 13), _prompt(3, 16)]
    jpool, tpool, tables, lengths, first = _pools(models, prompts)
    lengths[2] = 30
    toks = np.asarray(_prompt(7, 15), np.int32).reshape(3, 5)
    toks[:, 0] = first
    jl, jpool = jkv.paged_verify_steps(
        params, jpool, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(toks), jcfg, impl=impl)
    before = tkv.paged_verify_steps.launches
    tl, tpool = tkv.paged_verify_steps(
        model, tpool, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(toks), tcfg)
    assert tkv.paged_verify_steps.launches == before + 1
    assert tl.dtype == torch.float32 and tl.shape == (3, 5, 128)
    _close(tl, jl)
    for key in ("k", "v"):      # block 0 (trash) is never read
        _close(tpool[key][:, 1:], np.asarray(jpool[key])[:, 1:])


@pytest.mark.parametrize("impl", ["gather", "paged_flash"])
def test_verify_rows_equal_sequential_decode(models, impl):
    """Feed verify the tokens sequential greedy decode (through either
    decode attention) produced: row j's argmax is decode's token j+1 and
    the KV written is decode's."""
    _, _, tcfg, model = models
    prompts = [_prompt(4, 7), _prompt(5, 12), _prompt(6, 3)]
    _, pool_d, tables, lengths, first = _pools(models, prompts)
    pool_v = {k: v.clone() for k, v in pool_d.items()}
    tab, ln = torch.from_numpy(tables), torch.from_numpy(lengths)
    toks0 = torch.tensor(first, dtype=torch.int32)
    seq, _ = tkv.paged_decode_steps(model, pool_d, tab, ln, toks0, None,
                                    None, tcfg, 5, impl=impl)
    row = torch.cat([toks0[:, None], seq[:4].T], dim=1)     # (3, 5)
    logits, _ = tkv.paged_verify_steps(model, pool_v, tab, ln, row, tcfg)
    assert torch.equal(logits.argmax(-1).int(), seq.T)
    for key in ("k", "v"):
        _close(pool_v[key][:, 1:], pool_d[key][:, 1:].numpy())


# --- the engine in spec mode -------------------------------------------


def _count_drafts(monkeypatch):
    """Wrap the port's accept_tokens to count drafted tokens."""
    seen = {"drafted": 0, "rounds": 0}
    real = tspec.accept_tokens

    def counting(logits, draft, **kw):
        seen["drafted"] += len(draft)
        seen["rounds"] += 1
        return real(logits, draft, **kw)

    monkeypatch.setattr(tspec, "accept_tokens", counting)
    return seen


def _run(eng, prompts, **gen):
    async def go():
        outs = await asyncio.gather(*[eng.generate(p, **gen)
                                      for p in prompts])
        st = eng.stats
        await eng.stop()
        return [o["tokens"] for o in outs], st
    return asyncio.run(go())


def _port(models, spec, **kw):
    return LLMEngine(models[2], models[3], device="cpu", spec=spec,
                     **dict(ENGINE_KW, **kw))


def _jax(models, **kw):
    return JaxEngine(models[0], models[1], spec=True, kv_impl="gather",
                     **dict(ENGINE_KW, **kw))


# two high-hit periodic prompts co-batched with two low-hit ones that
# seldom draft (their rows verify at width 1 beside the drafting slots)
COBATCH = [_periodic(9), _prompt(5, 40), _periodic(4), _prompt(11, 30)]


@pytest.fixture(scope="module")
def jax_cobatch(models):
    return _run(_jax(models), COBATCH, max_new_tokens=32)


def test_spec_engine_greedy_matches_vanilla_and_jax(models, jax_cobatch,
                                                    monkeypatch):
    seen = _count_drafts(monkeypatch)
    verify0 = tkv.paged_verify_steps.launches
    spec, st = _run(_port(models, True), COBATCH, max_new_tokens=32)
    vanilla, st_off = _run(_port(models, False), COBATCH,
                           max_new_tokens=32)
    assert spec == vanilla
    assert spec == jax_cobatch[0]
    assert st["spec"] is True and st_off["spec"] is False
    assert seen["drafted"] > 0
    assert tkv.paged_verify_steps.launches > verify0


@pytest.mark.parametrize("case", ["eos", "max_new"])
def test_spec_ends_mid_accept_like_vanilla_and_jax(models, case):
    """eos emitted, or max_new reached, inside an accepted draft ends the
    request there and drops the rest of the draft."""
    prompt = _periodic(9)
    if case == "eos":
        full, _ = _run(_port(models, False), [prompt], max_new_tokens=32)
        gen = dict(max_new_tokens=32, eos_id=full[0][10])
    else:
        gen = dict(max_new_tokens=5)
    want, _ = _run(_port(models, False), [prompt], **gen)
    got, _ = _run(_port(models, True), [prompt], **gen)
    jgot, _ = _run(_jax(models), [prompt], **gen)
    assert got == want == jgot
    if case == "eos":
        assert got[0][-1] == gen["eos_id"] and len(got[0]) <= 11
    else:
        assert len(got[0]) == 5


def test_spec_low_hit_prompt_backs_off_and_matches(models, monkeypatch):
    """A non-periodic prompt drafts little; its drafter's accept window
    trips the cooldown, and the stream still equals vanilla's and the JAX
    engine's."""
    seen = _count_drafts(monkeypatch)
    prompt = _prompt(5, 64)
    want, _ = _run(_port(models, False), [prompt], max_new_tokens=48)
    jgot, _ = _run(_jax(models), [prompt], max_new_tokens=48)
    eng = _port(models, True)
    got, _ = _run(eng, [prompt], max_new_tokens=48)
    assert got == want == jgot
    # some rounds fell through to plain decode blocks
    assert seen["rounds"] < 48


def test_spec_sampling_run_completes_beside_greedy(models):
    """A temperature > 0 request (rejection-sampling acceptance) co-batched
    with a greedy one: the sampled stream completes inside the vocab, the
    greedy stream equals its solo vanilla stream."""
    greedy = _periodic(9)
    want, _ = _run(_port(models, False), [greedy], max_new_tokens=40)

    async def go():
        eng = _port(models, True, seed=3)
        a, b = await asyncio.gather(
            eng.generate(greedy, max_new_tokens=40),
            eng.generate(_periodic(4), max_new_tokens=40, temperature=0.9,
                         top_k=12))
        await eng.stop()
        return a["tokens"], b["tokens"]

    a, b = asyncio.run(go())
    assert a == want[0]
    assert len(b) == 40 and all(0 <= t < 128 for t in b)


def test_spec_paged_flash_impl_on_cpu_matches_gather(models):
    """kv_impl="paged_flash" on the CPU: decode blocks run the paged
    kernel's plain version (verify rounds take paged_attention_verify
    under either kv_impl)."""
    prompt = [_periodic(9)]
    gather, _ = _run(_port(models, True), prompt, max_new_tokens=24)
    flash, st = _run(_port(models, True, kv_impl="paged_flash"), prompt,
                     max_new_tokens=24)
    assert st["kv_impl"] == "paged_flash"
    assert flash == gather


def test_spec_is_ignored_on_the_monolithic_cache(models):
    eng = _port(models, True, kv_block_size=0)
    assert eng.stats["paged"] is False and "spec" not in eng.stats
    out, _ = _run(eng, [_periodic(9)], max_new_tokens=8)
    want, _ = _run(_port(models, False), [_periodic(9)], max_new_tokens=8)
    assert out == want
