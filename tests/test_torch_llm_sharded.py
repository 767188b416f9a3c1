"""Tensor-parallel serving on the port, held to the JAX package.

Part one is ``tests/test_llm_sharded.py`` on the port's engine: its 12
tests under the same names with the same assertions (the sharded ones
over ``TensorMesh(("cpu",) * 2)``, the port's stand-in for the JAX
tests' virtual CPU devices). They build JAX models, so they are
rewritten here rather than adopted through ``_torch_ported.py``.

Part two holds tensor parallelism at tp 2 to the JAX package's, on the
same tiny f32 config and the same weights (``bridge.py``): the JAX side
runs over ``Mesh(jax.devices()[:2], ("tensor",))`` with its paged decode
as ``impl="paged_flash"`` in interpret mode (its K4 under
``shard_map``); the port runs its plain versions on the CPU. Tolerance
TOL (1e-5) is relative to the largest magnitude of the compared array:
XLA-CPU and torch-CPU reduce in different orders. Greedy token streams
are compared exactly. Part three pins the single-device path as it was
before meshes existed, bit for bit, and part four the serve plane.
"""

import asyncio
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.llm import kvcache as jkv
from ray_tpu.llm import model as jlm
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.llm.pd import PrefillEngine as JaxPrefill
from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import kvcache, model as lm
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.pd import PrefillEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import _rmsnorm, _rope, _rope_tables
from ray_tpu_torch.parallel.tp import TensorMesh

TOL = 1e-5
# bf16 weights, activations and cache: each framework rounds every op
# to bf16 (8 bits of mantissa) in its own order, so logits agree to a
# few bf16 ulps of the largest logit, not to f32 precision
BF16_TOL = 2e-2
TINY = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, dtype="float32", logits_dtype="float32",
            attn_impl="reference")


def _models(dtype="float32"):
    args = dict(TINY, dtype=dtype)
    jcfg, tcfg = jllama.tiny(**args), llama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, params, tcfg, bridge.params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def tiny_model():
    _, _, cfg, model = _models()
    return cfg, model


@pytest.fixture(scope="module")
def both():
    return _models()


def _ref_greedy(cfg, model, prompt, n):
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = llama.forward(model, torch.tensor([toks]), cfg)
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _tp_mesh(size):
    return TensorMesh(("cpu",) * size)


def _jax_mesh(size):
    return Mesh(np.asarray(jax.devices()[:size]), ("tensor",))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- part one: tests/test_llm_sharded.py on the port --------------------


def test_sharded_engine_matches_unsharded_greedy(tiny_model):
    """tp=2 over the CPU stand-in mesh: params sharded Megatron-style,
    KV cache sharded on its kv-head dim — greedy decode must reproduce
    the single-device engine token for token."""
    cfg, model = tiny_model
    prompts = [[3, 7, 11], [9, 1], [5, 5, 5, 5]]
    refs = [_ref_greedy(cfg, model, p, 8) for p in prompts]

    async def go():
        eng = LLMEngine(cfg, model, max_slots=2, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        mesh=_tp_mesh(2), device="cpu")
        outs = await asyncio.gather(*[
            eng.generate(p, max_new_tokens=8) for p in prompts])
        await eng.stop()
        return outs

    outs = asyncio.run(go())
    for o, ref in zip(outs, refs):
        assert o["tokens"] == ref


def test_sharded_params_and_cache_are_actually_sharded(tiny_model):
    """The mesh isn't decorative: one shard per mesh device, each with
    the per-shard shapes split over the tensor axis, in storage of its
    own that holds 1/tp of the bytes (no view into the full weights)."""
    cfg, model = tiny_model
    mesh = _tp_mesh(2)
    sharded = lm.shard_params_for_serving(model, mesh, cfg)
    wq = [s.layers[0].wq.weight for s in sharded.shards]
    full = model.layers[0].wq.weight
    assert len(wq) == 2
    assert [s.device for s in sharded.shards] == list(mesh.devices)
    assert all(w.shape[0] == full.shape[0] // 2 for w in wq)
    assert all(w.untyped_storage().nbytes() == full.nbytes // 2
               for w in wq)
    assert wq[0].data_ptr() != wq[1].data_ptr()
    for name, spec_dim in (("wo", 1), ("w_down", 1), ("w_gate", 0)):
        w = getattr(sharded.shards[1].layers[1], name).weight
        f = getattr(model.layers[1], name).weight
        assert w.shape[spec_dim] == f.shape[spec_dim] // 2
        assert torch.equal(w, f.chunk(2, spec_dim)[1])
    assert sharded.shards[0].lm_head.weight.shape[0] == cfg.vocab_size // 2
    assert torch.equal(sharded.shards[1].embed.weight, model.embed.weight)
    cache = lm.init_cache(cfg, 2, 64, torch.float32, "cpu", mesh=mesh)
    assert all(c.shape[3] == cfg.n_kv_heads // 2 for c in cache["k"])
    pool = kvcache.init_pool(cfg, 5, 8, torch.float32, "cpu", mesh)
    assert all(p.shape[3] == cfg.n_kv_heads // 2 for p in pool["v"])
    assert kvcache.pool_block_bytes(pool) == \
        2 * cfg.n_layers * 8 * cfg.n_kv_heads * cfg.head_dim * 4


def test_sharding_divisibility_validated(tiny_model):
    cfg, model = tiny_model   # n_kv_heads=2, not divisible by 8
    with pytest.raises(ValueError, match="not divisible"):
        lm.shard_params_for_serving(model, _tp_mesh(8), cfg)


def _np_filter_support(logits, temp, top_p=1.0, top_k=0):
    """Numpy reference: the SET of tokens the filtered distribution may
    emit (temperature -> top-k -> top-p order)."""
    z = logits.astype(np.float64) / max(temp, 1e-6)
    if top_k > 0:
        kth = np.sort(z)[::-1][min(top_k, len(z)) - 1]
        z = np.where(z < kth, -np.inf, z)
    if top_p < 1.0:
        zm = z - z[np.isfinite(z)].max()
        p = np.exp(zm)
        p /= p.sum()
        order = np.argsort(p)[::-1]
        sp = p[order]
        keep = (np.cumsum(sp) - sp) < top_p
        thresh = sp[keep].min()
        z = np.where(p < thresh, -np.inf, z)
    return set(np.nonzero(np.isfinite(z))[0].tolist())


def test_sample_topk_topp_parity_with_numpy():
    """Device sampler vs numpy reference: every drawn token must come
    from the reference's support set, and the full support must be
    reachable (1000 draws, 16-token vocab)."""
    rng = np.random.default_rng(0)
    logits_np = rng.normal(size=(3, 16)).astype(np.float32) * 2.0
    cases = [dict(top_p=1.0, top_k=3), dict(top_p=0.6, top_k=0),
             dict(top_p=0.7, top_k=5)]
    for case in cases:
        supports = [_np_filter_support(logits_np[i], 0.8, **case)
                    for i in range(3)]
        drawn = [set() for _ in range(3)]
        logits = torch.tensor(logits_np)
        temps = torch.full((3,), 0.8)
        tp = torch.full((3,), case["top_p"])
        tk = torch.full((3,), case["top_k"], dtype=torch.int32)
        for it in range(1000):
            out = lm.sample(logits, temps, torch.Generator().manual_seed(it),
                            tp, tk)
            for i in range(3):
                drawn[i].add(int(out[i]))
        for i in range(3):
            assert drawn[i] <= supports[i], \
                (case, i, drawn[i] - supports[i])
            assert drawn[i] == supports[i], \
                (case, i, supports[i] - drawn[i])


def test_sample_disabled_filters_match_plain():
    """top_p=1.0 / top_k=0 must be byte-identical to the unfiltered
    sampler (same key, same draw)."""
    rng = np.random.default_rng(1)
    logits = torch.tensor(rng.normal(size=(4, 32)).astype(np.float32))
    temps = torch.full((4,), 1.0)
    plain = lm.sample(logits, temps, torch.Generator().manual_seed(7))
    filtered = lm.sample(logits, temps, torch.Generator().manual_seed(7),
                         torch.ones((4,)),
                         torch.zeros((4,), dtype=torch.int32))
    assert plain.tolist() == filtered.tolist()


def test_greedy_unaffected_by_filters():
    rng = np.random.default_rng(2)
    logits = torch.tensor(rng.normal(size=(2, 16)).astype(np.float32))
    temps = torch.zeros((2,))
    out = lm.sample(logits, temps, torch.Generator().manual_seed(0),
                    torch.full((2,), 0.3),
                    torch.full((2,), 2, dtype=torch.int32))
    assert out.tolist() == torch.argmax(logits, -1).tolist()


def test_engine_topk_restricts_outputs(tiny_model):
    """Engine-level: with top_k=2 every generated token is one of the
    two highest-logit continuations of its step (checked via the
    step-by-step full forward)."""
    cfg, model = tiny_model

    async def go():
        eng = LLMEngine(cfg, model, max_slots=1, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        seed=3, device="cpu")
        out = await eng.generate([3, 1, 4], max_new_tokens=10,
                                 temperature=1.0, top_k=2)
        await eng.stop()
        return out

    out = asyncio.run(go())
    toks = [3, 1, 4]
    for t in out["tokens"]:
        with torch.no_grad():
            logits = llama.forward(model, torch.tensor([toks]), cfg)
        top2 = set(np.argsort(logits[0, -1].numpy())[-2:].tolist())
        assert t in top2, (t, top2)
        toks.append(t)


def test_stop_sequence_trims_and_finishes(tiny_model):
    cfg, model = tiny_model
    ref = _ref_greedy(cfg, model, [4, 8], 10)
    # stop on a 2-token subsequence of the greedy continuation
    stop = [ref[2:4]]

    async def go():
        eng = LLMEngine(cfg, model, max_slots=2, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        device="cpu")
        stopped = await eng.generate([4, 8], max_new_tokens=10,
                                     stop=stop)
        plain = await eng.generate([4, 8], max_new_tokens=10)
        await eng.stop()
        return stopped, plain

    stopped, plain = asyncio.run(go())
    assert plain["tokens"] == ref
    assert stopped["tokens"] == ref[:2]   # matched suffix trimmed


def test_chunked_prefill_matches_full_forward(tiny_model):
    """A prompt longer than the largest bucket (3.5 buckets here) must
    produce exactly the same greedy continuation as the step-by-step
    full forward — chunk boundaries are invisible."""
    cfg, model = tiny_model
    prompt = [int(x) for x in
              np.random.default_rng(5).integers(1, 100, size=28)]
    ref = _ref_greedy(cfg, model, prompt, 6)

    async def go():
        eng = LLMEngine(cfg, model, max_slots=2, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        device="cpu")
        out = await eng.generate(prompt, max_new_tokens=6)
        await eng.stop()
        return out

    out = asyncio.run(go())
    assert out["tokens"] == ref


def test_chunked_prefill_sharded(tiny_model):
    """Chunked prefill under tensor parallelism: the accumulator is
    sharded on its kv-head dim and the result still matches."""
    cfg, model = tiny_model
    prompt = list(range(1, 21))
    ref = _ref_greedy(cfg, model, prompt, 5)

    async def go():
        eng = LLMEngine(cfg, model, max_slots=1, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        mesh=_tp_mesh(2), device="cpu")
        out = await eng.generate(prompt, max_new_tokens=5)
        await eng.stop()
        return out

    assert asyncio.run(go())["tokens"] == ref


def test_chunked_prefill_non_aligned_max_len(tiny_model):
    """max_len NOT a multiple of the largest bucket + a prompt close to
    max_len: the padded final chunk must not overrun the accumulator."""
    cfg, model = tiny_model
    prompt = [int(x) for x in
              np.random.default_rng(11).integers(1, 100, size=26)]
    ref = _ref_greedy(cfg, model, prompt, 4)

    async def go():
        eng = LLMEngine(cfg, model, max_slots=1, max_len=30,
                        prefill_buckets=(8,), cache_dtype="float32",
                        device="cpu")
        out = await eng.generate(prompt, max_new_tokens=4)
        await eng.stop()
        return out

    assert asyncio.run(go())["tokens"] == ref


def test_pd_chunked_non_aligned_max_len(tiny_model):
    """Same overrun guard on the disaggregated prefill tier."""
    cfg, model = tiny_model
    prompt = list(range(1, 27))
    ref = _ref_greedy(cfg, model, prompt, 4)

    async def go():
        pre = PrefillEngine(cfg, model, prefill_buckets=(8,),
                            max_len=30, cache_dtype="float32", device="cpu")
        shipped = pre.prefill(prompt)
        assert shipped["k"].shape[1] <= 30
        eng = LLMEngine(cfg, model, max_slots=1, max_len=30,
                        prefill_buckets=(8,), cache_dtype="float32",
                        device="cpu")
        out = await eng.generate_prefilled(prompt, shipped,
                                           max_new_tokens=4)
        await eng.stop()
        return out

    assert asyncio.run(go())["tokens"] == ref


# --- part two: tp 2 against the JAX package's tp 2 ----------------------


def _jax_sharded(jcfg, params):
    return jlm.shard_params_for_serving(params, _jax_mesh(2), jcfg)


def _head_slices(x, tp=2):
    """A full-head (..., kvh, hd) array cut into its tp head shards."""
    n = x.shape[-2] // tp
    return [x[..., j * n:(j + 1) * n, :] for j in range(tp)]


def _prefill_both(jcfg, params, tcfg, model):
    prompt = np.random.default_rng(3).integers(1, 127, 13)
    padded = lm.pad_prompt(prompt, 16)
    jl, jkv_ = jlm.prefill(_jax_sharded(jcfg, params), jnp.asarray(padded),
                           jnp.int32(13), jcfg, 32)
    sharded = lm.shard_params_for_serving(model, _tp_mesh(2), tcfg)
    tl, tkv = lm.prefill(sharded, torch.tensor(padded), 13, tcfg, 32)
    return (np.asarray(jl, np.float32), jkv_,
            tl.numpy(), tkv)


def test_tp2_prefill_logits_and_kv_match_jax(both):
    """Prefill at tp 2: logits within TOL of the JAX package's sharded
    prefill, and each shard's KV within TOL of the JAX KV's head slice
    of that shard."""
    jcfg, params, tcfg, model = both
    jl, jkv_, tl, tkv = _prefill_both(jcfg, params, tcfg, model)
    assert _rel(tl, jl) <= TOL
    for key in ("k", "v"):
        want = _head_slices(np.asarray(jkv_[key], np.float32))
        assert len(tkv[key]) == 2
        for got, w in zip(tkv[key], want):
            assert tuple(got.shape) == w.shape
            assert _rel(got.numpy(), w) <= TOL


def test_tp2_bf16_prefill_matches_jax():
    """The same at bf16 weights and activations, at BF16_TOL."""
    jcfg, params, tcfg, model = _models("bfloat16")
    jl, jkv_, tl, tkv = _prefill_both(jcfg, params, tcfg, model)
    assert _rel(tl, jl) <= BF16_TOL
    for key in ("k", "v"):
        for got, w in zip(tkv[key],
                          _head_slices(np.asarray(jkv_[key], np.float32))):
            assert _rel(got.float().numpy(), w) <= BF16_TOL


def _pools(tcfg, nb=12, bs=8, seed=4):
    """A random f32 pool (numpy, full heads), the same bytes on both
    sides: the JAX pool sharded on kv heads, the port's split per shard."""
    rng = np.random.default_rng(seed)
    shape = (tcfg.n_layers, nb, bs, tcfg.n_kv_heads, tcfg.head_dim)
    full = {key: rng.normal(size=shape).astype(np.float32)
            for key in ("k", "v")}
    s = NamedSharding(_jax_mesh(2), P(None, None, None, "tensor", None))
    jpool = {key: jax.device_put(jnp.asarray(x), s)
             for key, x in full.items()}
    tpool = {key: [torch.tensor(np.ascontiguousarray(h))
                   for h in _head_slices(x)] for key, x in full.items()}
    return jpool, tpool


TABLES = np.array([[3, 1, 7, 0], [5, 9, 2, 11]], np.int32)
LENGTHS = np.array([19, 9], np.int32)


def test_tp2_paged_decode_matches_jax_k4_under_shard_map(both):
    """Two paged decode steps at tp 2: the JAX package's K4 runs under
    shard_map in interpret mode, the port's once per shard (its plain
    version here). Tokens equal; each shard's pool after the steps
    within TOL of the JAX pool's head slice."""
    jcfg, params, tcfg, model = both
    mesh = _tp_mesh(2)
    jpool, tpool = _pools(tcfg)
    toks = np.array([5, 77], np.int32)
    jout, jpool = jkv.paged_decode_steps(
        _jax_sharded(jcfg, params), jpool, jnp.asarray(TABLES),
        jnp.asarray(LENGTHS), jnp.asarray(toks), jnp.zeros((2,)),
        jax.random.PRNGKey(0), jcfg, 2, impl="paged_flash", interpret=True,
        mesh=_jax_mesh(2))
    sharded = lm.shard_params_for_serving(model, mesh, tcfg)
    tout, tpool = kvcache.paged_decode_steps(
        sharded, tpool, torch.tensor(TABLES), torch.tensor(LENGTHS),
        torch.tensor(toks), None, None, tcfg, 2, impl="paged_flash")
    assert tout.tolist() == np.asarray(jout).tolist()
    for key in ("k", "v"):
        for got, w in zip(tpool[key],
                          _head_slices(np.asarray(jpool[key]))):
            assert _rel(got.numpy(), w) <= TOL


def test_tp2_verify_logits_match_jax(both):
    """One verify round of width 3 at tp 2: logits within TOL of the JAX
    package's sharded verify."""
    jcfg, params, tcfg, model = both
    mesh = _tp_mesh(2)
    jpool, tpool = _pools(tcfg, seed=5)
    toks = np.array([[5, 6, 7], [77, 3, 9]], np.int32)
    jl, _ = jkv.paged_verify_steps(
        _jax_sharded(jcfg, params), jpool, jnp.asarray(TABLES),
        jnp.asarray(LENGTHS), jnp.asarray(toks), jcfg, impl="paged_flash",
        interpret=True, mesh=_jax_mesh(2))
    sharded = lm.shard_params_for_serving(model, mesh, tcfg)
    tl, _ = kvcache.paged_verify_steps(
        sharded, tpool, torch.tensor(TABLES), torch.tensor(LENGTHS),
        torch.tensor(toks), tcfg)
    assert _rel(tl.numpy(), np.asarray(jl)) <= TOL


def test_tp2_per_shard_kernel_calls(both, monkeypatch):
    """K4 runs once per shard per layer and step on that shard's kv
    heads with the replicated tables, and K1 (prefill attention) once per
    shard per layer on its q and kv heads: counted at the wrappers the
    card launches, whose plain versions answer here."""
    _, _, tcfg, model = both
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.ops import paged_attention as tpa
    calls = {"k1": [], "k4": []}
    k1, k4 = ta.attention, tpa.paged_attention

    def count_k1(q, k, v, **kw):
        calls["k1"].append((q.shape[2], k.shape[2]))
        return k1(q, k, v, **kw)

    def count_k4(q, kp, vp, tables, lengths, **kw):
        calls["k4"].append((q.shape[1], q.shape[2], kp.shape[2],
                            tables.data_ptr()))
        return k4(q, kp, vp, tables, lengths, **kw)
    monkeypatch.setattr(ta, "attention", count_k1)
    monkeypatch.setattr(tpa, "paged_attention", count_k4)
    mesh = _tp_mesh(2)
    sharded = lm.shard_params_for_serving(model, mesh, tcfg)
    lm.prefill(sharded, torch.arange(1, 17), 16, tcfg, 32)
    _, tpool = _pools(tcfg)
    tables = torch.tensor(TABLES)
    kvcache.paged_decode_steps(
        sharded, tpool, tables, torch.tensor(LENGTHS),
        torch.tensor([5, 77], dtype=torch.int32), None, None, tcfg, 3,
        impl="paged_flash")
    h, kvh = tcfg.n_heads // 2, tcfg.n_kv_heads // 2
    assert calls["k1"] == [(h, kvh)] * (2 * tcfg.n_layers)
    assert calls["k4"] == [(kvh, h // kvh, kvh, tables.data_ptr())] \
        * (2 * tcfg.n_layers * 3)


ENGINE_KW = dict(max_slots=2, max_len=64, prefill_buckets=(16,),
                 cache_dtype="float32", kv_block_size=8, prefix_cache=True)


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


A = _prompt(10, 20)
REQUESTS = [                       # (prompt, max_new_tokens)
    (A, 4),
    (_prompt(11, 40), 8),          # > largest bucket: chunked prefill
    (_prompt(12, 6), 6),
    (A + _prompt(13, 6), 5),       # repeats A's prefix: prefix hit
]


async def _serve(eng, requests, prefilled=None):
    outs = await asyncio.gather(*[
        eng.generate(p, max_new_tokens=n,
                     prefilled=None if prefilled is None else prefilled[i])
        for i, (p, n) in enumerate(requests)])
    stats = eng.stats
    await eng.stop()
    return [o["tokens"] for o in outs], stats


@pytest.fixture(scope="module")
def jax_tp2_streams(both):
    jcfg, params, _, _ = both
    return asyncio.run(_serve(
        JaxEngine(jcfg, params, mesh=_jax_mesh(2), kv_impl="paged_flash",
                  **ENGINE_KW), REQUESTS))[0]


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_impl="paged_flash"), dict(kv_block_size=0),
    dict(spec=True)], ids=["gather", "paged_flash", "monolithic", "spec"])
def test_tp2_engine_streams_match_jax_tp2(both, jax_tp2_streams, kw):
    """Concurrent greedy requests (a chunked prompt and a prefix hit
    among them) through the port's engine at tp 2 give the JAX engine's
    tp-2 streams exactly, paged (both attention impls), monolithic and
    speculative."""
    _, _, tcfg, model = both
    args = dict(ENGINE_KW, **kw)
    got, stats = asyncio.run(_serve(
        LLMEngine(tcfg, model, mesh=_tp_mesh(2), device="cpu", **args),
        REQUESTS))
    assert got == jax_tp2_streams
    assert stats["tensor_parallel"] == 2
    if kw.get("kv_block_size", 8):
        assert stats["prefix_hit_tokens"] >= 16


def test_tp2_spec_drafts_and_verifies(both, monkeypatch):
    """A periodic prompt makes the drafter propose, so the spec engine
    at tp 2 runs verify forwards, and its stream is the tp-1 engine's."""
    _, _, tcfg, model = both
    prompt = [7, 8, 9, 10] * 5
    before = kvcache.paged_verify_steps.launches
    got, _ = asyncio.run(_serve(LLMEngine(
        tcfg, model, mesh=_tp_mesh(2), device="cpu", spec=True,
        **ENGINE_KW), [(prompt, 12)]))
    assert kvcache.paged_verify_steps.launches > before
    want, _ = asyncio.run(_serve(LLMEngine(
        tcfg, model, device="cpu", **ENGINE_KW), [(prompt, 12)]))
    assert got == want


@pytest.mark.parametrize("kv_block_size", [8, 0],
                         ids=["paged", "monolithic"])
def test_tp2_prefilled_admission_matches_jax(both, kv_block_size):
    """``prefilled=`` under the mesh: JAX payloads (a short and a chunked
    prompt) admitted by the port's tp-2 engine, their full-head KV split
    onto the shards, give the streams the JAX tp-2 engine gives on the
    same payloads."""
    jcfg, params, tcfg, model = both
    reqs = REQUESTS[1:3]
    args = dict(ENGINE_KW, kv_block_size=kv_block_size)
    pre = JaxPrefill(jcfg, params, prefill_buckets=(16,), max_len=64,
                     cache_dtype="float32", block_size=kv_block_size or 8)
    payloads = [pre.prefill(p) for p, _ in reqs]
    want, _ = asyncio.run(_serve(JaxEngine(
        jcfg, params, mesh=_jax_mesh(2), kv_impl="paged_flash", **args),
        reqs, payloads))
    got, stats = asyncio.run(_serve(LLMEngine(
        tcfg, model, mesh=_tp_mesh(2), device="cpu", **args),
        reqs, [pre.prefill(p) for p, _ in reqs]))
    assert got == want
    assert stats["handoff_bytes"] > 0


def test_kv_accounting_sums_the_shards(both):
    """``llm_kv_cache_bytes`` under the mesh is the JAX engine's global
    array bytes: the sum over the shards, the tp-1 figure."""
    _, _, tcfg, model = both
    from ray_tpu_torch.llm.engine import engine_metrics

    def published(**kw):
        LLMEngine(tcfg, model, device="cpu", **dict(ENGINE_KW,
                                                  kv_block_size=0), **kw)
        return engine_metrics()["kv_bytes"]._values[()]
    assert published(mesh=_tp_mesh(2)) == published()


# --- part three: the single-device path, bit for bit --------------------


def _frozen_prefill(model, tokens, length, cfg, max_len):
    """``lm.prefill`` as it stood before meshes existed."""
    from ray_tpu_torch.ops.attention import attention
    s = tokens.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    x = model.embed(tokens[None].long())
    positions = torch.arange(s, dtype=torch.int32)
    rc, rs = _rope_tables(positions[None], hd, cfg.rope_theta)
    ks, vs = [], []
    for lyr in model.layers:
        y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
        q = lyr.wq(y).view(1, s, h, hd)
        k = lyr.wk(y).view(1, s, cfg.n_kv_heads, hd)
        v = lyr.wv(y).view(1, s, cfg.n_kv_heads, hd)
        q, k = _rope(q, rc, rs), _rope(k, rc, rs)
        o = attention(q, k, v, causal=True, sm_scale=hd ** -0.5,
                      impl="reference")
        x = x + lyr.wo(o.reshape(1, s, h * hd).to(x.dtype))
        x = x + lyr.mlp(x, cfg.norm_eps)
        ks.append(k[0])
        vs.append(v[0])
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = model.lm_head(x[0, length - 1]).float()
    pad = (0, 0, 0, 0, 0, max_len - s)
    return logits, {"k": F.pad(torch.stack(ks), pad),
                    "v": F.pad(torch.stack(vs), pad)}


def _frozen_decode(model, cache, tokens, cfg):
    """One greedy monolithic decode step as it stood before meshes."""
    b = tokens.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = cache["length"]
    rows = torch.arange(b)
    at = positions.long()
    x = model.embed(tokens[:, None].long())
    rc, rs = _rope_tables(positions[:, None], hd, cfg.rope_theta)
    for i, lyr in enumerate(model.layers):
        ck, cv = cache["k"][i], cache["v"][i]
        y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
        q = _rope(lyr.wq(y).view(b, 1, h, hd), rc, rs)
        k = _rope(lyr.wk(y).view(b, 1, kvh, hd), rc, rs)
        v = lyr.wv(y).view(b, 1, kvh, hd)
        ck.index_put_((rows, at), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, at), v[:, 0].to(cv.dtype))
        qg = q[:, 0].reshape(b, kvh, h // kvh, hd).float()
        scores = torch.einsum("bkgd,blkd->bkgl", qg, ck.float()) \
            / math.sqrt(hd)
        mask = torch.arange(ck.shape[1])[None] < (positions + 1)[:, None]
        scores = torch.where(mask[:, None, None, :], scores,
                             torch.full_like(scores, -1e30))
        o = torch.einsum("bkgl,blkd->bkgd", torch.softmax(scores, -1),
                         cv.float()).reshape(b, 1, h * hd)
        x = x + lyr.wo(o.to(x.dtype))
        x = x + lyr.mlp(x, cfg.norm_eps)
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    cache["length"] += 1
    return torch.argmax(model.lm_head(x[:, 0]).float(), -1).to(torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp1_is_bitwise_the_single_device_path(dtype):
    """Without a mesh the forwards compute what they computed before
    tensor parallelism, bit for bit: prefill logits and KV, and three
    monolithic decode steps (tokens and cache)."""
    cfg = llama.tiny(**dict(TINY, dtype=dtype))
    model = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(1, 127, 16),
                        dtype=torch.int32)
    with torch.no_grad():
        want_l, want_kv = _frozen_prefill(model, toks, 13, cfg, 32)
        got_l, got_kv = lm.prefill(model, toks, 13, cfg, 32)
        assert torch.equal(got_l, want_l)
        for key in ("k", "v"):
            assert torch.equal(got_kv[key], want_kv[key])
        caches = []
        for _ in range(2):
            c = lm.init_cache(cfg, 2, 32, cfg.torch_dtype, "cpu")
            lm.write_prefill_to_cache(c, want_kv, 1, 13)
            caches.append(c)
        step = torch.tensor([5, 7], dtype=torch.int32)
        want_t = [_frozen_decode(model, caches[0], step, cfg)]
        for _ in range(2):
            want_t.append(_frozen_decode(model, caches[0], want_t[-1], cfg))
        got_t, _ = lm.decode_steps(model, caches[1], step, None, None, cfg,
                                   3)
    assert got_t.tolist() == [t.tolist() for t in want_t]
    for key in ("k", "v", "length"):
        assert torch.equal(caches[1][key], caches[0][key])


# --- part four: the serve plane -----------------------------------------


def test_serving_mesh_cpu_stand_in_and_too_few_cards(monkeypatch):
    from ray_tpu_torch.serve import llm as tllm
    assert tllm._serving_mesh(1, "cpu") is None
    mesh = tllm._serving_mesh(2, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.shape["tensor"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only 2 local devices"):
        tllm._serving_mesh(4, "cuda")


def test_llm_app_tensor_parallel_matches_tp1_app():
    """``build_llm_deployment`` with ``tensor_parallel=2`` on the CPU
    answers greedy requests with the tp-1 app's tokens."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMConfig, build_llm_deployment
    cfg = LLMConfig(model="tiny", model_overrides=dict(TINY), max_slots=2,
                    max_len=64, prefill_buckets=(8, 16),
                    cache_dtype="float32", device="cpu")
    prompts = [[3, 7, 11], list(range(1, 21))]
    rt.init(num_cpus=4)
    try:
        outs = {}
        for tp in (1, 2):
            h = serve.run(build_llm_deployment(
                LLMConfig(**{**cfg.__dict__, "tensor_parallel": tp}),
                name=f"LLMServer{tp}"), name=f"tp{tp}")
            outs[tp] = [rt.get(h.generate.remote(p, max_new_tokens=6),
                               timeout=120)["tokens"] for p in prompts]
            assert rt.get(h.stats.remote(),
                          timeout=60)["tensor_parallel"] == tp
            serve.delete(f"tp{tp}")
        assert outs[2] == outs[1]
    finally:
        serve.shutdown()
        rt.shutdown()
