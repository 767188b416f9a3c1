"""data.llm: batch LLM inference over Datasets.

Analog of the reference's `ray.data.llm` (reference:
python/ray/llm/_internal/batch/processor/* build_llm_processor — a
vLLM-backed stage in a data pipeline): prompts stream through shared
continuous-batching engine actors (ray_tpu_torch.llm), so a Dataset map stage
gets the same token-level batching the online path has. Engines are
long-lived actors shared across all map tasks — model weights load once
per replica, not once per block.

    from ray_tpu_torch.serve.llm import LLMConfig
    from ray_tpu_torch.data.llm import build_llm_processor
    proc = build_llm_processor(LLMConfig(model="tiny"), concurrency=2,
                               max_new_tokens=32)
    out_ds = proc(ds)   # adds a "generated_tokens" column

The port's copy of ``ray_tpu/data/llm.py``, over the port's
``serve.llm._LLMServer``: each engine actor builds an ``LLMEngine`` on
``LLMConfig.device`` (None is the card; "cpu" runs the kernels' plain
versions); killing an engine actor (``apply.engines``) frees its
card memory with its process.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class _EngineActor:
    """One LLM engine behind an actor; map tasks call generate_many."""

    def __init__(self, cfg):
        from ray_tpu_torch.serve.llm import _LLMServer
        self._server = _LLMServer(cfg)

    async def generate_many(self, prompts, max_new_tokens: int,
                            temperature: float, eos_id):
        import asyncio
        outs = await asyncio.gather(*[
            self._server.engine.generate(
                list(map(int, p)), max_new_tokens=max_new_tokens,
                temperature=temperature, eos_id=eos_id)
            for p in prompts])
        return [o["tokens"] for o in outs]


def build_llm_processor(cfg, *, input_column: str = "tokens",
                        output_column: str = "generated_tokens",
                        max_new_tokens: int = 64,
                        temperature: float = 0.0,
                        eos_id: Optional[int] = None,
                        concurrency: int = 1,
                        batch_size: Optional[int] = 64,
                        engine_options: Optional[dict] = None
                        ) -> Callable:
    """Returns Dataset -> Dataset adding `output_column` (object array of
    token-id lists). `concurrency` = engine replicas (model copies)."""
    import ray_tpu_torch

    engines = [
        ray_tpu_torch.remote(_EngineActor).options(
            max_concurrency=64, **(engine_options or {})).remote(cfg)
        for _ in range(concurrency)]

    def infer(batch: dict) -> dict:
        prompts = [list(map(int, np.asarray(p).tolist()))
                   for p in batch[input_column]]
        # Shard the batch's prompts ACROSS all engine replicas so they
        # run concurrently (the map stage itself is sequential per
        # batch; intra-batch sharding is where replica parallelism
        # comes from), then reassemble in order.
        shards = np.array_split(np.arange(len(prompts)), len(engines))
        refs, order = [], []
        for eng, idx in zip(engines, shards):
            if len(idx) == 0:
                continue
            refs.append(eng.generate_many.remote(
                [prompts[i] for i in idx], max_new_tokens,
                temperature, eos_id))
            order.append(idx)
        toks = [None] * len(prompts)
        for idx, part in zip(order, ray_tpu_torch.get(refs, timeout=3600)):
            for i, t in zip(idx, part):
                toks[i] = t
        out = dict(batch)
        out[output_column] = np.array([np.array(t, np.int32)
                                       for t in toks], dtype=object)
        return out

    def apply(ds):
        return ds.map_batches(infer, batch_size=batch_size)

    apply.engines = engines  # exposed so callers can kill them
    return apply
