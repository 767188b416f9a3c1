"""``ray_tpu_torch.serve.llm`` (``LLMConfig``, ``build_llm_deployment``,
``stream_generate``, ``build_pd_llm_deployment``) over the port's engine,
held to the JAX package's ``LLMEngine`` on the same weights.

The weights are the port's ``_load_model(cfg)`` in this process (a
replica draws the same ones from ``cfg.seed`` on the CPU), crossed to the
JAX package's tree through ``bridge.params_to_numpy``. Greedy streams of
four concurrent requests (one past the largest prefill bucket, so
chunked) through a handle, through ``stream_generate``, through the
proxy's server-sent events and through the prefill/decode app all equal
the JAX engine's. The port's engine reads the same eight Config knobs as
the JAX engine when an argument is left ``None``. The counterparts of
``tests/test_llm.py:280-352`` and ``tests/test_llm_pd.py:82-168``.
"""

import asyncio
import dataclasses
import http.client
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import config as jconfig
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm

import ray_tpu_torch
from ray_tpu_torch import bridge, serve
from ray_tpu_torch import config as tconfig
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.llm import (LLMConfig, build_llm_deployment,
                                     build_pd_llm_deployment,
                                     stream_generate)

# The proxy binds an ephemeral port here: the JAX package's serve tests,
# which may run at the same time in another test worker, bind 8000.
serve_api.DEFAULT_HTTP_PORT = 0

TINY = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, dtype="float32", logits_dtype="float32",
            attn_impl="reference")
CFG = LLMConfig(model="tiny", model_overrides=TINY, max_slots=4,
                max_len=64, prefill_buckets=(8, 16), cache_dtype="float32",
                device="cpu")
NEW = 8


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


PROMPTS = [_prompt(20, 5), _prompt(21, 12), _prompt(22, 21),   # chunked
           _prompt(23, 3)]


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's engine over the port's weights, as the JAX
    package's ``_LLMServer`` would build it from ``CFG``."""
    model_cfg, model = tllm._load_model(CFG)
    jcfg = jllama.tiny(**TINY)
    params = jax.tree.map(jnp.asarray, bridge.params_to_numpy(model))

    async def go():
        eng = JaxEngine(jcfg, params, max_slots=CFG.max_slots,
                        max_len=CFG.max_len,
                        prefill_buckets=CFG.prefill_buckets,
                        cache_dtype=CFG.cache_dtype,
                        steps_per_sync=CFG.steps_per_sync, seed=CFG.seed)
        outs = await asyncio.gather(*[
            eng.generate(p, max_new_tokens=NEW) for p in PROMPTS])
        await eng.stop()
        return [o["tokens"] for o in outs]
    return asyncio.run(go())


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def unified(cluster):
    """The unified app, deployed once for the tests that read it; its
    deployment's own route is ``/LLMServer``."""
    return serve.run(build_llm_deployment(CFG), name="uni")


def _sse(path, payload):
    addr = serve.proxy_address()
    conn = http.client.HTTPConnection(addr["host"], addr["port"],
                                      timeout=120)
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          "Accept": "text/event-stream"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read().decode()   # the connection closes at stream end
    conn.close()
    assert "event: done" in raw
    return [json.loads(line[len("data: "):])["token"]
            for line in raw.splitlines()
            if line.startswith("data: ") and "token" in line]


def test_unified_app_matches_jax_engine(unified, jax_streams):
    """(a) Four concurrent greedy requests through the handle equal the
    JAX engine's streams; the replica's engine counted them."""
    refs = [unified.generate.remote(p, max_new_tokens=NEW)
            for p in PROMPTS]
    got = [r["tokens"] for r in ray_tpu_torch.get(refs, timeout=180)]
    assert got == jax_streams
    stats = ray_tpu_torch.get(unified.stats.remote(), timeout=60)
    assert stats["device"] == "cpu" and stats["paged"]
    assert stats["requests"] >= len(PROMPTS)
    assert stats["tokens_generated"] >= NEW * len(PROMPTS)


def test_stream_generate_matches_generate(unified, jax_streams):
    """(b) ``stream_generate`` yields the handle's tokens, one by one."""
    for p, want in zip(PROMPTS, jax_streams):
        assert list(stream_generate(unified, p, max_new_tokens=NEW)) == want


def test_sse_through_proxy_matches_handle(unified, jax_streams):
    """(d) The proxy's server-sent events (one ``data:`` per token, then
    ``event: done``) equal the handle's streams, and so does the unary
    JSON entry (``__call__``)."""
    for p, want in zip(PROMPTS, jax_streams):
        assert _sse("/LLMServer", {"tokens": p, "max_new_tokens": NEW}) \
            == want
    addr = serve.proxy_address()
    conn = http.client.HTTPConnection(addr["host"], addr["port"],
                                      timeout=120)
    conn.request("POST", "/LLMServer",
                 body=json.dumps({"tokens": PROMPTS[0],
                                  "max_new_tokens": NEW}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read())["tokens"] == jax_streams[0]
    conn.close()


def test_pd_app_matches_unified(cluster, jax_streams):
    """(c) ingress -> 2 prefill replicas -> 1 decode replica: the KV
    crosses by TensorRef handle from a prefill replica to the decode
    replica, and the streams equal the JAX engine's (and so the unified
    app's); the decode replica counted every handed-off byte."""
    h = serve.run(build_pd_llm_deployment(CFG, num_prefill_replicas=2,
                                          num_decode_replicas=1),
                  name="pd", route_prefix=None, ready_timeout_s=300.0)
    refs = [h.generate.remote(p, max_new_tokens=NEW) for p in PROMPTS]
    got = [r["tokens"] for r in ray_tpu_torch.get(refs, timeout=180)]
    assert got == jax_streams
    stats = ray_tpu_torch.get(
        serve.get_deployment_handle("LLMDecode").stats.remote(), timeout=60)
    # block-granular ship lengths (block 16 by the Config, gcd'd to 8 by
    # the bucket 8) x layers x kv heads x head_dim x 4 bytes x (k, v)
    ship = sum(-(-len(p) // 8) * 8 for p in PROMPTS)
    head_dim = TINY["dim"] // TINY["n_heads"]
    assert stats["handoff_bytes"] == \
        ship * TINY["n_layers"] * TINY["n_kv_heads"] * head_dim * 4 * 2
    serve.delete("pd")


def test_llm_config_is_the_jax_config_plus_device():
    """(e) The JAX ``LLMConfig``'s fields, in order, with its defaults,
    and ``device`` (None: the CUDA device) after them."""
    def fields(cls):
        return [(f.name, f.default if f.default_factory is
                 dataclasses.MISSING else f.default_factory())
                for f in dataclasses.fields(cls)]
    assert fields(LLMConfig) == fields(jllm.LLMConfig) + [("device", None)]


@pytest.mark.parametrize("kw, exc, match", [
    pytest.param(dict(tensor_parallel=2, device="cuda"), ValueError,
                 "only 1 local devices", id="kw0-item 11"),
    pytest.param(dict(checkpoint="/nonexistent/params"),
                 ValueError, "not a committed ray_tpu_torch.ckpt/1",
                 id="kw1-item 17"),
])
def test_unported_options_raise_before_drawing_weights(monkeypatch, kw,
                                                       exc, match):
    """(f) A ``checkpoint=`` that is no committed checkpoint of the
    port's ``train/ckptio.py`` format raises, and ``tensor_parallel``
    beyond the visible cards raises as the JAX package's
    ``_serving_mesh`` does, both before any weights are drawn (one card
    visible here)."""
    from ray_tpu_torch.models import llama

    def drawn(*a, **k):
        raise AssertionError("weights drawn")
    monkeypatch.setattr(llama, "init_params", drawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(exc, match=match):
        tllm._load_model(dataclasses.replace(CFG, **kw))


KNOBS = [                            # (env var, value, needs spec on)
    ("RAY_TPU_KVCACHE_BLOCK_SIZE", "8", False),
    ("RAY_TPU_KVCACHE_POOL_BLOCKS", "40", False),
    ("RAY_TPU_KVCACHE_PREFIX_CACHE", "0", False),
    ("RAY_TPU_PAGED_ATTN_IMPL", "paged_flash", False),
    ("RAY_TPU_SPEC_DECODE", "1", False),
    ("RAY_TPU_SPEC_DRAFT_TOKENS", "6", True),
    ("RAY_TPU_SPEC_NGRAM_MAX", "2", True),
    ("RAY_TPU_SPEC_BACKOFF_WINDOW", "9", True),
]


def _effective(eng, drafter):
    return dict(block=eng._block, pool_blocks=eng._kv.num_blocks,
                prefix_cache=eng._kv.prefix_cache, impl=eng._kv_impl,
                spec=eng._spec, spec_buckets=tuple(eng._spec_buckets),
                draft=None if drafter is None else
                (drafter.k, drafter.ngram_max, drafter.window))


@pytest.mark.parametrize("env, value, spec", KNOBS,
                         ids=[k[0].removeprefix("RAY_TPU_").lower()
                              for k in KNOBS])
def test_engine_reads_config_knobs_as_jax_engine(monkeypatch, env, value,
                                                 spec):
    """(g) Each of the eight Config knobs, overridden alone (the three
    drafter knobs with spec_decode on), gives the port's engine the same
    effective block size, pool blocks, prefix cache, decode impl, spec
    switch, verify widths and drafter as the JAX engine under the same
    override, and differs from the default where the knob is read."""
    args = dict(TINY, n_layers=1)
    jcfg, tcfg = jllama.tiny(**args), tllama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params), tcfg,
        "cpu")
    kw = dict(max_slots=2, max_len=64, prefill_buckets=(16,),
              cache_dtype="float32")

    async def build(make):
        eng = make()
        r = eng._submit([1, 2, 3, 1, 2], 4, 0.0, None)
        out = _effective(eng, r.drafter)
        await eng.stop()
        return out

    def both():
        for mod in (jconfig, tconfig):
            monkeypatch.setattr(mod, "_global_config", None)
        return (asyncio.run(build(lambda: JaxEngine(jcfg, params, **kw))),
                asyncio.run(build(lambda: LLMEngine(tcfg, model,
                                                    device="cpu", **kw))))

    if spec:
        monkeypatch.setenv("RAY_TPU_SPEC_DECODE", "1")
    default_j, default_t = both()
    monkeypatch.setenv(env, value)
    want, got = both()
    assert got == want
    assert default_t == default_j and got != default_t
