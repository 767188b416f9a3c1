"""The port's serving model functions (ray_tpu_torch/llm/model.py and
llm/kvcache.py) against the JAX package's, on the JAX package's own
seeded weights carried through the bridge.

Tiny widths, two layers, f32. Logits and KV agree to 1e-5 relative to
their scale (XLA-CPU and torch-CPU reduce in different orders); greedy
token streams agree exactly. The JAX paged kernel runs through the
Pallas interpreter; the port runs its plain versions on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import kvcache as jkv
from ray_tpu.llm import model as jlm
from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import kvcache as tkv
from ray_tpu_torch.llm import model as tlm
from ray_tpu_torch.models import llama as tllama

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    args = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, ffn_dim=128, dtype="float32",
                attn_impl="reference")
    jcfg, tcfg = jllama.tiny(**args), tllama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    model = bridge.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, params, tcfg, model


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=TOL)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 127, n).astype(np.int32)


@pytest.mark.parametrize("n,bucket", [(5, 16), (16, 16), (20, 32)])
def test_prefill_logits_and_kv_match_jax(models, n, bucket):
    jcfg, params, tcfg, model = models
    padded = tlm.pad_prompt(_prompt(n, n), bucket)
    assert np.array_equal(padded, jlm.pad_prompt(_prompt(n, n), bucket))
    jl, jkvs = jlm.prefill(params, jnp.asarray(padded), jnp.int32(n), jcfg,
                           48)
    tl, tkvs = tlm.prefill(model, torch.from_numpy(padded), n, tcfg, 48)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tuple(tkvs[key].shape) == jkvs[key].shape
        _close(tkvs[key], jkvs[key])


@pytest.mark.parametrize("flash", [False, True], ids=["dynamic", "q_offset"])
def test_prefill_chunk_matches_jax(models, flash):
    """Two chunks of a 28-token prompt into a 64-long accumulator: the
    port's dynamic-offset path and its flash (q_offset) path, each against
    the JAX path of the same kind (reference -> dynamic, flash_interpret
    -> the Pallas kernel at q_offset)."""
    jcfg, params, tcfg, model = models
    if flash:
        jcfg = dataclasses.replace(jcfg, attn_impl="flash_interpret")
    prompt = _prompt(99, 28)
    shape = (tcfg.n_layers, 64, tcfg.n_kv_heads, tcfg.head_dim)
    jacc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tacc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for off in (0, 16):
        part = prompt[off:off + 16]
        padded = tlm.pad_prompt(part, 16)
        jl, jacc = jlm.prefill_chunk(params, jnp.asarray(padded),
                                     jnp.int32(len(part)), off, jacc, jcfg)
        tl, tacc = tlm._prefill_chunk(model, torch.from_numpy(padded),
                                      len(part), off, tacc, tcfg, flash)
        _close(tl, jl)
    for key in ("k", "v"):
        _close(tacc[key][:, :28], np.asarray(jacc[key])[:, :28])


def test_prefill_chunk_public_dispatch_on_cpu_is_dynamic(models):
    """On the CPU ``prefill_chunk`` takes the dynamic path and matches
    the reference-config JAX call."""
    jcfg, params, tcfg, model = models
    assert not tlm.flash_capable(tcfg, torch.device("cpu"))
    shape = (tcfg.n_layers, 32, tcfg.n_kv_heads, tcfg.head_dim)
    padded = tlm.pad_prompt(_prompt(5, 10), 16)
    jl, _ = jlm.prefill_chunk(params, jnp.asarray(padded), jnp.int32(10), 8,
                              {"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
                              jcfg)
    tl, _ = tlm.prefill_chunk(model, torch.from_numpy(padded), 10, 8,
                              {"k": torch.zeros(shape),
                               "v": torch.zeros(shape)}, tcfg)
    _close(tl, jl)
    with pytest.raises(ValueError, match="overruns"):
        tlm.prefill_chunk(model, torch.from_numpy(padded), 10, 24,
                          {"k": torch.zeros(shape),
                           "v": torch.zeros(shape)}, tcfg)


def _filled_pools(models, prompts, bs, nb, w):
    """Both packages' pools with each prompt prefilled and scattered into
    disjoint blocks; returns (jpool, tpool, tables, lengths, first)."""
    jcfg, params, tcfg, model = models
    shape = (tcfg.n_layers, nb, bs, tcfg.n_kv_heads, tcfg.head_dim)
    jpool = jkv.init_pool(jcfg, nb, bs, jnp.float32)
    tpool = tkv.init_pool(tcfg, nb, bs, torch.float32, "cpu")
    assert tuple(tpool["k"].shape) == shape
    tables = np.zeros((len(prompts), w), np.int32)
    lengths, first = [], []
    nxt = 1
    for i, p in enumerate(prompts):
        bucket = 16
        padded = tlm.pad_prompt(p, bucket)
        jl, jkvs = jlm.prefill(params, jnp.asarray(padded),
                               jnp.int32(len(p)), jcfg, bucket)
        _, tkvs = tlm.prefill(model, torch.from_numpy(padded), len(p),
                              tcfg, bucket)
        nblk = bucket // bs
        phys = np.arange(nxt, nxt + nblk, dtype=np.int32)
        tables[i, :nblk] = phys
        tables[i, nblk:nblk + 2] = nxt + nblk + np.arange(2)
        nxt += nblk + 2
        jpool = jkv.scatter_bucket(jpool, jkvs, jnp.asarray(phys), nblk)
        tkv.scatter_bucket(tpool, tkvs, phys, nblk)
        lengths.append(len(p))
        first.append(int(np.argmax(np.asarray(jl))))
    return jpool, tpool, tables, np.asarray(lengths, np.int32), first


@pytest.mark.parametrize("impl", ["gather", "paged_flash"])
def test_paged_decode_steps_greedy_matches_jax(models, impl):
    jcfg, params, tcfg, model = models
    bs, nb, w, n = 8, 16, 4, 6
    prompts = [_prompt(1, 5), _prompt(2, 13), _prompt(3, 9)]
    jpool, tpool, tables, lengths, first = _filled_pools(
        models, prompts, bs, nb, w)
    toks = np.asarray(first, np.int32)
    temps = np.zeros((len(prompts),), np.float32)
    # decode writes the previous token's KV at position len(prompt)
    jout, jpool = jkv.paged_decode_steps(
        params, jpool, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(toks), jnp.asarray(temps), jax.random.PRNGKey(0), jcfg,
        n, impl=impl, interpret=True)
    tout, tpool = tkv.paged_decode_steps(
        model, tpool, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(toks), torch.from_numpy(temps), None, tcfg, n,
        impl=impl)
    assert tout.dtype == torch.int32
    assert np.array_equal(tout.numpy(), np.asarray(jout))
    for key in ("k", "v"):
        _close(tpool[key][:, 1:], np.asarray(jpool[key])[:, 1:])


def test_pool_ops_match_jax(models):
    """gather_table, scatter_table and copy_block move the same bytes as
    the JAX ops (bitwise: they are pure data movement)."""
    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(0)
    shape = (2, 10, 4, tcfg.n_kv_heads, tcfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jpool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tpool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    table = np.asarray([3, 7, 1, 0], np.int32)
    jacc = jkv.gather_table(jpool, jnp.asarray(table), 24)
    tacc = tkv.gather_table(tpool, table, 24)
    for key in ("k", "v"):
        assert np.array_equal(tacc[key].numpy(), np.asarray(jacc[key]))
    targets = np.asarray([5, 0, 6, 0], np.int32)
    jpool = jkv.scatter_table(jpool, jacc, jnp.asarray(targets))
    tkv.scatter_table(tpool, tacc, targets)
    jpool = jkv.copy_block(jpool, 5, 9)
    tkv.copy_block(tpool, 5, 9)
    for key in ("k", "v"):
        # block 0 (trash) takes duplicate writes with no defined winner
        assert np.array_equal(tpool[key][:, 1:].numpy(),
                              np.asarray(jpool[key])[:, 1:])
    assert tkv.pool_block_bytes(tpool) == jkv.pool_block_bytes(jpool)


def test_filter_logits_numpy_equals_jax_and_torch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    top_ks = np.asarray([0, 1, 5, 20, 0], np.int32)
    top_ps = np.asarray([1.0, 0.9, 0.5, 0.95, 0.2], np.float32)
    for tk, tp in ((top_ks, top_ps), (top_ks, None), (None, top_ps)):
        want = jlm.filter_logits(x, tk, tp)
        got = tlm.filter_logits(x, tk, tp)
        assert np.array_equal(got, want)
        got_t = tlm.filter_logits(
            torch.from_numpy(x),
            None if tk is None else torch.from_numpy(tk),
            None if tp is None else torch.from_numpy(tp))
        assert np.array_equal(got_t.numpy(), want)


def test_sample_greedy_and_seeded():
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(size=(3, 32)).astype(np.float32))
    greedy = torch.argmax(logits, -1).int()
    assert torch.equal(tlm.sample(logits, None, None), greedy)
    assert torch.equal(tlm.sample(logits, torch.zeros(3),
                                  torch.Generator().manual_seed(0)), greedy)
    temps = torch.tensor([0.0, 1.0, 0.7])
    a = tlm.sample(logits, temps, torch.Generator().manual_seed(3),
                   top_ks=torch.tensor([0, 4, 0]),
                   top_ps=torch.tensor([1.0, 1.0, 0.5]))
    b = tlm.sample(logits, temps, torch.Generator().manual_seed(3),
                   top_ks=torch.tensor([0, 4, 0]),
                   top_ps=torch.tensor([1.0, 1.0, 0.5]))
    assert torch.equal(a, b) and int(a[0]) == int(logits[0].argmax())
    top4 = set(torch.topk(logits[1], 4).indices.tolist())
    assert int(a[1]) in top4


def _script(m, kv):
    """One scripted alloc/hit/free/evict/fork sequence; returns every
    observable result."""
    out = []
    a = list(range(1, 25))
    out.append(m.alloc_seq("a", a, 8))
    m.free_seq("a", a + [90, 91, 92])
    out.append((m.used_blocks(), m.cached_blocks(), m.free_blocks()))
    out.append(m.lookup(a + [5]))
    out.append(m.alloc_seq("b", a[:17] + [77], 4))
    out.append(m.alloc_seq("c", [200] * 30, 20))
    out.append(m.fork_seq("b", "b2"))
    out.append(m.ensure_writable("b2", 0))
    out.append(m.truncate_seq("b2", 9))
    out.append(m.alloc_seq("d", [300] * 40, 20))   # pool pressure
    m.free_seq("c", [200] * 30, cache=False)
    out.append(m.alloc_seq("d", [300] * 40, 20))
    out.append(m.evict(3))
    try:
        m.alloc_seq("e", [1] * 300, 1)
    except kv.BlockPoolExhausted as e:
        out.append(("exhausted", str(e)))
    out.append((m.used_blocks(), m.cached_blocks(), m.free_blocks(),
                m.hit_tokens_total, m.evicted_total))
    out.append(kv.chain_hashes(a, 8, start_block=1))
    return [_plain(o) for o in out]


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    return o


def test_block_manager_matches_reference():
    kw = dict(table_width=8, prefix_cache=True)
    want = _script(jkv.KVBlockManager(14, 8, **kw), jkv)
    got = _script(tkv.KVBlockManager(14, 8, **kw), tkv)
    assert got == want
    assert tkv.TRASH == jkv.TRASH == 0


def test_resolve_attn_impl_by_device():
    assert tkv.resolve_attn_impl("auto", "cpu") == "gather"
    assert tkv.resolve_attn_impl("auto", torch.device("cuda")) == \
        "paged_flash"
    assert tkv.resolve_attn_impl("gather", "cuda") == "gather"
    with pytest.raises(ValueError, match="auto|paged_flash|gather"):
        tkv.resolve_attn_impl("flash", "cpu")


def test_auto_pool_blocks_cpu_sizing():
    """Worst case plus one chain of prefix headroom plus trash; the knob
    wins. (The CUDA cap on free memory is exercised by chip_smoke.py.)"""
    assert tkv.auto_pool_blocks(4, 8, 1024, device="cpu") == 4 * 8 + 8 + 1
    assert tkv.auto_pool_blocks(4, 8, 1024, configured=7) == 7
