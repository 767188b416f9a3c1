"""Batch LLM inference over the port's datasets
(``ray_tpu_torch.data.llm.build_llm_processor``) held to the JAX
package's engine on the same weights.

The config is ``tests/test_data_llm.py``'s tiny one with
``device="cpu"``. The weights are the port's ``_load_model(cfg)`` in this
process (the processor's engine actor draws the same ones from
``cfg.seed`` on the CPU), crossed to the JAX package's tree through
``bridge.params_to_numpy``. The JAX side drives its ``LLMEngine`` as the
JAX processor's ``_EngineActor.generate_many`` does: each map batch's
prompts gathered at once on one engine. The counterpart of
``tests/test_data_llm.py``, whose processor draws JAX weights of its own.
"""

import asyncio

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama

import ray_tpu_torch
from ray_tpu_torch import bridge
from ray_tpu_torch import data as rt_data
from ray_tpu_torch.data.llm import build_llm_processor
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.llm import LLMConfig

TINY = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, dtype="float32", logits_dtype="float32",
            attn_impl="reference")
CFG = LLMConfig(model="tiny", model_overrides=TINY, max_slots=4,
                max_len=64, prefill_buckets=(8,), cache_dtype="float32",
                device="cpu")
NEW, BATCH = 5, 8


def _rows():
    """test_data_llm.py's 16 rows, then 8 random prompts of 2-20 tokens
    (some past the one prefill bucket, so chunked)."""
    rows = [{"id": i, "tokens": np.array([i % 7 + 1, 5, 9], np.int32)}
            for i in range(16)]
    rng = np.random.default_rng(3)
    rows += [{"id": 16 + i, "tokens": rng.integers(1, 127, n)
              .astype(np.int32)}
             for i, n in enumerate(rng.integers(2, 21, 8))]
    return rows


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _jax_generations(rows):
    model_cfg, model = tllm._load_model(CFG)
    params = jax.tree.map(jnp.asarray, bridge.params_to_numpy(model))

    async def go():
        eng = JaxEngine(jllama.tiny(**TINY), params,
                        max_slots=CFG.max_slots, max_len=CFG.max_len,
                        prefill_buckets=CFG.prefill_buckets,
                        cache_dtype=CFG.cache_dtype,
                        steps_per_sync=CFG.steps_per_sync, seed=CFG.seed)
        out = []
        for i in range(0, len(rows), BATCH):
            outs = await asyncio.gather(*[
                eng.generate([int(t) for t in r["tokens"]],
                             max_new_tokens=NEW)
                for r in rows[i:i + BATCH]])
            out += [o["tokens"] for o in outs]
        await eng.stop()
        return out
    return asyncio.run(go())


def test_batch_inference_matches_jax_engine(cluster):
    """Every row, in input order, carries the JAX engine's greedy
    generation on the same weights; duplicated prompts generate alike;
    killing the engine actor ends its process."""
    rows = _rows()
    want = _jax_generations(rows)
    proc = build_llm_processor(CFG, max_new_tokens=NEW, concurrency=1,
                               batch_size=BATCH)
    out = proc(rt_data.from_items(rows)).take_all()
    assert [r["id"] for r in out] == [r["id"] for r in rows]
    got = [np.asarray(r["generated_tokens"]).tolist() for r in out]
    assert got == want
    assert all(len(g) == NEW and all(0 <= t < TINY["vocab_size"]
                                     for t in g) for g in got)
    by_prompt = {}
    for r, g in zip(out, got):
        key = tuple(np.asarray(r["tokens"]).tolist())
        assert by_prompt.setdefault(key, g) == g
    for h in proc.engines:
        ray_tpu_torch.kill(h)
