"""serve.llm: deploy a continuous-batching LLM engine as a deployment.

Analog of the reference's `ray.serve.llm` entry point (reference:
python/ray/llm/_internal/serve/builders/application_builders.py
`build_llm_deployment`, deployments/llm/llm_server.py LLMServer) with
the vLLM engine replaced by the port's engine in ray_tpu_torch.llm.

    from ray_tpu_torch.serve.llm import LLMConfig, build_llm_deployment
    app = build_llm_deployment(LLMConfig(model="tiny", max_slots=4))
    h = serve.run(app, name="llm")
    out = h.generate.remote([1, 2, 3], max_new_tokens=16).result()

The port's copy of ``ray_tpu/serve/llm.py``. ``LLMConfig.device`` is the
one field the JAX package's lacks: ``None`` serves on the CUDA device (and
a replica raises without one), ``"cpu"`` runs the kernels' plain
versions. Weights are drawn from ``seed`` on that device
(``llama.init_params``); a ``checkpoint`` raises until the port has it.
``tensor_parallel > 1`` serves each replica's engine over a
``TensorMesh`` (``_serving_mesh``): the first ``tensor_parallel`` visible
cards, or on ``device="cpu"`` that many CPU entries, which stand in for
the JAX package's virtual CPU devices. Nothing here imports torch until a
replica's ``__init__`` builds its engine, so the controller and the proxy
never load it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch.serve.api import Application, deployment


@dataclass
class LLMConfig:
    """What to serve and how to batch it.

    `model` names a config constructor in ray_tpu_torch.models.llama (e.g.
    "tiny", "llama3_8b") or is a LlamaConfig; `checkpoint` would point at
    a directory of params (not ported yet: it raises) — absent, params
    are randomly initialized from `seed` (useful for shape/perf work and
    tests). `device` is where each replica's engine runs: None is the
    CUDA device, "cpu" the plain versions.
    """
    model: object = "tiny"
    model_overrides: dict = field(default_factory=dict)
    checkpoint: Optional[str] = None
    max_slots: int = 8
    # long-context by default: the engine's KV cache starts small and
    # grows in buckets, so 8k max_len costs 8k-sized HBM only when an
    # 8k request actually arrives; prompts past the largest bucket
    # stream through chunked prefill
    max_len: int = 8192
    prefill_buckets: tuple = (64, 128, 256, 512, 1024, 2048)
    cache_dtype: str = "bfloat16"
    steps_per_sync: int = 8
    seed: int = 0
    num_replicas: object = 1
    max_ongoing_requests: int = 64
    # >1: each replica runs its engine tensor-parallel over this many
    # local devices (Megatron sharding via lm.serve_param_specs) — how
    # models larger than one chip's HBM serve (reference:
    # llm_config.py:181-186 tensor_parallel_size)
    tensor_parallel: int = 1
    # Paged KV cache (llm/kvcache.py): None = the Config knobs
    # (kvcache_block_size / kvcache_pool_blocks /
    # kvcache_prefix_cache); 0 blocks = monolithic cache. Prefix reuse
    # is what makes a shared system prompt cheap: requests sharing
    # cached prefix blocks skip prefill for them.
    kv_block_size: Optional[int] = None
    kv_pool_blocks: Optional[int] = None
    prefix_cache: Optional[bool] = None
    device: Optional[str] = None


def _serving_mesh(tensor_parallel: int, device: Optional[str] = None):
    """A ("tensor",)-axis ``TensorMesh`` over the replica's local
    devices, or None when tensor_parallel == 1 (single-device engine).
    On the CPU it repeats the CPU ``tensor_parallel`` times; otherwise
    it takes the first ``tensor_parallel`` visible cards and raises when
    fewer are visible."""
    if tensor_parallel <= 1:
        return None
    import torch

    from ray_tpu_torch.parallel.tp import TensorMesh
    if device is not None and torch.device(device).type == "cpu":
        return TensorMesh(("cpu",) * tensor_parallel)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < tensor_parallel:
        raise ValueError(
            f"tensor_parallel={tensor_parallel} but only {n} local "
            "devices are visible")
    return TensorMesh([f"cuda:{i}" for i in range(tensor_parallel)])


def _load_model(cfg: LLMConfig):
    """Resolve (model_cfg, params) from an LLMConfig — shared by the
    decode, prefill, and unified servers so every replica holds
    identical weights. The weights are drawn on ``cfg.device`` from a
    generator on that device seeded with ``cfg.seed``."""
    if cfg.checkpoint:
        raise NotImplementedError(
            "LLMConfig.checkpoint: restoring served weights from a "
            "checkpoint directory is not ported to ray_tpu_torch yet "
            "(ROADMAP Queue 1 item 17)")
    _serving_mesh(cfg.tensor_parallel, cfg.device)   # before any weights
    import torch

    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models import llama
    model_cfg = cfg.model
    if isinstance(model_cfg, str):
        model_cfg = getattr(llama, model_cfg)(**cfg.model_overrides)
    dev = resolve_device(cfg.device)
    params = llama.init_params(
        torch.Generator(device=dev).manual_seed(cfg.seed), model_cfg, dev)
    return model_cfg, params


class _LLMServer:
    """One engine per replica; requests ride serve's router + the
    engine's own continuous batching."""

    def __init__(self, cfg: LLMConfig):
        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.llm.model import shard_params_for_serving
        model_cfg, params = _load_model(cfg)
        mesh = _serving_mesh(cfg.tensor_parallel, cfg.device)
        if mesh is not None:
            # split here, so the whole weights are gone before the engine
            # sizes its pool from the cards' free memory
            params = shard_params_for_serving(params, mesh, model_cfg)
            if mesh.devices[0].type == "cuda":
                import torch
                torch.cuda.empty_cache()
        self.engine = LLMEngine(
            model_cfg, params, max_slots=cfg.max_slots,
            max_len=cfg.max_len, prefill_buckets=cfg.prefill_buckets,
            cache_dtype=cfg.cache_dtype,
            steps_per_sync=cfg.steps_per_sync, seed=cfg.seed,
            mesh=mesh,
            kv_block_size=cfg.kv_block_size,
            kv_pool_blocks=cfg.kv_pool_blocks,
            prefix_cache=cfg.prefix_cache, device=params.device)

    async def generate(self, tokens, max_new_tokens: int = 64,
                       temperature: float = 0.0,
                       eos_id: Optional[int] = None,
                       top_p: float = 1.0, top_k: int = 0,
                       stop=None) -> dict:
        # the serve-propagated deadline (replica bound it to this
        # request's context) rides into the engine, which cancels the
        # generation — and frees its batch slot — when the budget ends
        from ray_tpu_torch.serve.fault import current_deadline_ts
        return await self.engine.generate(
            tokens, max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id,
            top_p=top_p, top_k=top_k, stop=stop,
            deadline_ts=current_deadline_ts())

    # --- streaming (push-based core streaming generator) --------------
    # Tokens flow replica -> caller through num_returns="streaming"
    # (api.ObjectRefGenerator) as the engine produces them — no polling
    # RPCs; time-to-first-token is one decode block (reference: serve
    # streams LLM responses the same push-based way, router.py:689).

    async def generate_stream(self, tokens, max_new_tokens: int = 64,
                              temperature: float = 0.0,
                              eos_id: Optional[int] = None):
        from ray_tpu_torch.serve.fault import current_deadline_ts
        async for tok in self.engine.generate_stream(
                tokens, max_new_tokens=max_new_tokens,
                temperature=temperature, eos_id=eos_id,
                deadline_ts=current_deadline_ts()):
            yield int(tok)

    async def stats(self) -> dict:
        return dict(self.engine.stats)

    async def __call__(self, request: dict) -> dict:
        """HTTP/JSON entry: {"tokens": [...], "max_new_tokens": N,
        "temperature", "top_p", "top_k", "stop", "eos_id"}."""
        return await self.generate(
            request["tokens"],
            max_new_tokens=int(request.get("max_new_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
            top_p=float(request.get("top_p", 1.0)),
            top_k=int(request.get("top_k", 0)),
            stop=request.get("stop"))


def stream_generate(handle, tokens, **kw):
    """Client-side generator: yields token ids as the replica produces
    them, push-based over the core streaming-return path (one streaming
    call; every ref is already resolved locally when it is yielded).

        for tok in stream_generate(h, prompt_ids, max_new_tokens=128):
            ...
    """
    import ray_tpu_torch
    gen = handle.options(stream=True).generate_stream.remote(tokens, **kw)
    try:
        for ref in gen:
            tok = ray_tpu_torch.get(ref)
            ray_tpu_torch.free([ref])  # consumed — don't accumulate per token
            yield tok
    finally:
        gen.close()  # early caller exit must stop the replica's stream


def build_llm_deployment(cfg: LLMConfig,
                         name: str = "LLMServer") -> Application:
    dep = deployment(
        _LLMServer, name=name, num_replicas=cfg.num_replicas,
        max_ongoing_requests=cfg.max_ongoing_requests,
        route_prefix=f"/{name}")
    return dep.bind(cfg)


# --- prefill/decode disaggregation ------------------------------------
# Reference pattern: llm/_internal/serve/serving_patterns/prefill_decode/
# builder.py:184 (separate prefill + decode deployments, KV handed off
# between them). The KV stays on the prefill replica's device behind
# TensorRef handles (runtime/device_store.py) until the decode replica
# fetches it (ray_tpu_torch/llm/pd.py).
#
# Neither build_llm_deployment nor build_pd_llm_deployment asks for a GPU
# in ray_actor_options, as the reference's ask for no accelerator: a card
# host may run both tiers on its one card (two engines on one H100, as
# the runtime's PD handoff does), and a replica's engine finds the card
# through LLMConfig.device.

class _PrefillServer:
    """Stateless prompt prefill replicas (compute-bound tier)."""

    def __init__(self, cfg: LLMConfig):
        from ray_tpu_torch.llm.pd import PrefillEngine
        model_cfg, params = _load_model(cfg)
        self.engine = PrefillEngine(
            model_cfg, params, prefill_buckets=cfg.prefill_buckets,
            max_len=cfg.max_len, cache_dtype=cfg.cache_dtype,
            block_size=cfg.kv_block_size, device=params.device)

    async def prefill(self, tokens) -> dict:
        import asyncio
        loop = asyncio.get_running_loop()
        # device=True: KV stays in this replica's device memory behind
        # TensorRef handles; the decode replica fetches it in ONE hop (or zero,
        # same-process) instead of host->shm->host staging
        return await loop.run_in_executor(
            None, lambda: self.engine.prefill(tokens, device=True))


class _DecodeServer(_LLMServer):
    """Decode tier: same engine, plus KV-handoff admission."""

    async def generate_prefilled(self, tokens, prefilled,
                                 max_new_tokens: int = 64,
                                 temperature: float = 0.0,
                                 eos_id: Optional[int] = None) -> dict:
        import ray_tpu_torch
        from ray_tpu_torch.runtime.core import ObjectRef
        if isinstance(prefilled, ObjectRef):
            # the ingress forwards the prefill result by REFERENCE: the
            # KV bytes move prefill-node -> decode-node over the object
            # plane exactly once, never through the ingress
            prefilled = await ray_tpu_torch.get_async(prefilled)
        return await self.engine.generate_prefilled(
            tokens, prefilled, max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id)


class _PDIngress:
    """Routes each request through the two tiers: prefill replicas
    compute the prompt KV, decode replicas stream tokens from it."""

    def __init__(self, cfg: LLMConfig, prefill_handle, decode_handle):
        self.cfg = cfg
        self.prefill = prefill_handle
        self.decode = decode_handle

    async def generate(self, tokens, max_new_tokens: int = 64,
                       temperature: float = 0.0,
                       eos_id: Optional[int] = None) -> dict:
        import asyncio

        import ray_tpu_torch
        # Handle SUBMISSION (blocking routing-table work) hops to the
        # executor for milliseconds; the generation itself is awaited on
        # the loop so one thread is never held for a whole request.
        # The prefill ObjectRef is forwarded, not its value: the KV
        # payload flows prefill-replica -> decode-replica directly.
        loop = asyncio.get_running_loop()
        pre_ref = await loop.run_in_executor(
            None, lambda: self.prefill.prefill.remote(tokens))
        ref = await loop.run_in_executor(
            None, lambda: self.decode.generate_prefilled.remote(
                tokens, pre_ref, max_new_tokens=max_new_tokens,
                temperature=temperature, eos_id=eos_id))
        return await ray_tpu_torch.get_async(ref, timeout=300)

    async def __call__(self, request: dict) -> dict:
        return await self.generate(
            request["tokens"],
            max_new_tokens=int(request.get("max_new_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"))


def build_pd_llm_deployment(cfg: LLMConfig,
                            num_prefill_replicas: int = 1,
                            num_decode_replicas: int = 1,
                            name: str = "LLM") -> Application:
    """Disaggregated app: ingress -> prefill tier -> decode tier.

        app = build_pd_llm_deployment(LLMConfig(model="tiny"), 2, 1)
        h = serve.run(app, name="pd")
        out = h.generate.remote([1, 2, 3], max_new_tokens=16).result()
    """
    prefill = deployment(
        _PrefillServer, name=f"{name}Prefill",
        num_replicas=num_prefill_replicas,
        max_ongoing_requests=cfg.max_ongoing_requests).bind(cfg)
    decode = deployment(
        _DecodeServer, name=f"{name}Decode",
        num_replicas=num_decode_replicas,
        max_ongoing_requests=cfg.max_ongoing_requests).bind(cfg)
    ingress = deployment(
        _PDIngress, name=f"{name}Ingress",
        num_replicas=1,
        max_ongoing_requests=cfg.max_ongoing_requests,
        route_prefix=f"/{name}")
    return ingress.bind(cfg, prefill, decode)
