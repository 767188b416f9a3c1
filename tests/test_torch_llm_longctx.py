"""Long-context serving on the port, held to the JAX package.

``tests/test_llm_longctx.py``'s four properties on the port's Llama and
``LLMEngine`` (on the CPU: its kernels' plain versions), under the same
names: the monolithic cache's bucketed growth, the chunked prefill of a
1.3k-token prompt equal to one big-bucket prefill, the flash path in the
serving prefill equal to the reference attention (chunked too, with its
absolute causal offset), and the long-context serving defaults. The
original builds JAX models, so it is rewritten here rather than adopted
through ``_torch_ported.py``.

Where the original compares two paths, both of the port's are also held
to the JAX package's engine on the same tiny f32 config and the same
weights (``bridge.py``), and the flash path to the JAX engine over its
Pallas kernel in interpret mode. Greedy token streams are compared
exactly; the defaults field by field.
"""

import asyncio

import numpy as np

import jax

from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMConfig as JaxLLMConfig

from ray_tpu_torch import bridge
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.llm import LLMConfig

TINY = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, dtype="float32", logits_dtype="float32",
            attn_impl="reference")


def _models(seed=0):
    """(JAX params, the port's model) of the same weights, for the
    port's config at any ``attn_impl``."""
    params = jllama.init_params(jax.random.PRNGKey(seed),
                                jllama.tiny(**TINY))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return params, bridge.params_from_numpy(tree, llama.tiny(**TINY), "cpu")


def _kw(kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("cache_dtype", "float32")
    kw.setdefault("steps_per_sync", 4)
    return kw


def _generate(model, prompt, n, attn_impl="reference", **kw):
    """The port's engine's greedy stream for ``prompt``."""
    cfg = llama.tiny(**dict(TINY, attn_impl=attn_impl))

    async def go():
        eng = LLMEngine(cfg, model, device="cpu", **_kw(kw))
        try:
            return (await eng.generate(prompt, max_new_tokens=n,
                                       temperature=0.0))["tokens"]
        finally:
            await eng.stop()
    return asyncio.run(go())


def _jax_generate(params, prompt, n, attn_impl="reference", **kw):
    """The JAX package's engine's greedy stream for ``prompt``."""
    eng = JaxEngine(jllama.tiny(**dict(TINY, attn_impl=attn_impl)), params,
                    **_kw(kw))

    async def go():
        return (await eng.generate(prompt, max_new_tokens=n,
                                   temperature=0.0))["tokens"]
    return asyncio.run(go())


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


def test_cache_starts_small_and_grows_in_buckets():
    """The monolithic cache's bucketed growth (kv_block_size=0): 1024
    positions up front of an 8192 max_len, no growth for a short
    request, one doubling for a request needing 1500 positions."""
    _, model = _models()
    cfg = llama.tiny(**TINY)

    async def go():
        eng = LLMEngine(cfg, model, device="cpu", max_len=8192,
                        prefill_buckets=(64, 128, 256), kv_block_size=0,
                        **_kw({}))
        try:
            seen = [(eng._cache_len, eng.stats["cache_len"])]
            for n_prompt, n_new in ((16, 8), (1400, 100)):
                out = await eng.generate(_prompt(0, n_prompt),
                                         max_new_tokens=n_new,
                                         temperature=0.0)
                assert len(out["tokens"]) == n_new
                seen.append((eng._cache_len, eng.stats["cache_len"]))
            return seen
        finally:
            await eng.stop()

    assert asyncio.run(go()) == [(1024, 1024), (1024, 1024), (2048, 2048)]


def test_long_prompt_chunked_equals_single_bucket():
    """A 1.3k-token prompt streamed through 256-sized chunks decodes the
    same greedy tokens as one 2048-bucket prefill, and both equal the
    JAX engine's chunked stream."""
    params, model = _models()
    prompt = _prompt(1, 1300)
    chunked = _generate(model, prompt, 24, max_len=2048,
                        prefill_buckets=(256,))
    direct = _generate(model, prompt, 24, max_len=2048,
                       prefill_buckets=(2048,))
    want = _jax_generate(params, prompt, 24, max_len=2048,
                         prefill_buckets=(256,))
    assert chunked == direct, (chunked, direct)
    assert chunked == want, (chunked, want)


def test_flash_serving_prefill_matches_reference():
    """The flash path in the serving prefill (K1's plain version on the
    CPU, with the chunked path's absolute causal offset) gives the same
    greedy decode as the reference attention, single and chunked, and
    both equal the JAX engine's over its Pallas kernel in interpret
    mode."""
    params, model = _models()
    prompt = _prompt(2, 200)
    runs = {(impl, buckets): _generate(model, prompt, 16, impl,
                                       max_len=512, prefill_buckets=buckets)
            for impl in ("reference", "flash") for buckets in ((256,),
                                                               (128,))}
    want = _jax_generate(params, prompt, 16, "flash_interpret",
                         max_len=512, prefill_buckets=(256,))
    for key, got in runs.items():
        assert got == want, (key, got, want)


def test_default_serve_config_is_long_context():
    """The serving defaults are long-context, and equal the JAX
    package's."""
    cfg, ref = LLMConfig(), JaxLLMConfig()
    assert cfg.max_len >= 8192
    assert max(cfg.prefill_buckets) >= 2048
    assert (cfg.max_len, tuple(cfg.prefill_buckets)) == \
        (ref.max_len, tuple(ref.prefill_buckets))
