"""Continuous-batching LLM engine.

Counterpart of ``ray_tpu/llm/engine.py``: requests join and leave a fixed
set of decode SLOTS at token granularity; prompts prefill through shape
buckets (prompts past the largest bucket through chunked prefill); every
decode block runs ``steps_per_sync`` chained steps on the device with one
host sync. The KV lives in one of two caches:

- the paged pool (``kv_block_size > 0``, the default): fixed-size token
  blocks, a block table per request reserved for its whole horizon at
  admission, prefix reuse across requests, decode attention through the
  paged kernel;
- the monolithic slot cache (``kv_block_size=0``): (layers, slots, L,
  kvh, hd), L starting at min(max_len, max(1024, largest bucket)) and
  doubling up to max_len when an admitted request needs the room; decode
  attends the whole slot view with plain PyTorch, as the JAX package's
  einsum does.

``spec=True`` (paged only) adds speculative decoding: each round, slots
whose prompt-lookup drafter proposes a continuation are scored in one
verify forward and accept their longest agreeing prefix (``llm/spec.py``);
when no slot drafts, the round is an ordinary decode block.
``generate(..., prefilled=payload)`` admits KV that a ``PrefillEngine``
(``llm/pd.py``) computed, with no prompt forward of its own.

The engine is asyncio-native; device work runs on executor threads, one
admit, decode block or verify round at a time, so cache mutation stays
serialized. Each thread launches on its own current CUDA stream, and the
host syncs only where it needs the tokens (and after a shipped payload's
cache write, to bound its device time).

Observability, as in the JAX engine: the request-phase histograms
(``engine_metrics``), the pool's and the drafter's series
(``kvcache_metrics``, ``spec_metrics``), the KV bytes attributed in
device memory (``_kv_account``), one ``queue``, ``prefill`` and
``generate`` span per traced request and one batch span per decode block
or verify round (``util/tracing.py``), a device window per prefill and
per block (``util/devmon.py``), the engine's deadline counter
(``serve/fault.py``) and a forensics state provider holding ``stats``.
A request is traced when a ``tracing.TraceContext`` is bound where it is
submitted.

A ``prefilled`` payload's k/v may be host arrays or device-resident
``TensorRef`` handles (``PrefillEngine.prefill(device=True)``): a handle
resolves onto the engine's device (the parked tensor itself in the same
process, one fetch from another) and is freed once the cache holds its
KV, or when its request fails.

``mesh=`` (a ``parallel.tp.TensorMesh``) serves tensor-parallel, as the
JAX engine does over a ``("tensor",)`` mesh: the weights are split
Megatron-style (``model.shard_params_for_serving``), the pool or the
slot cache on its kv-head dim, and every forward runs each shard on its
own heads, K1 and K4 included, with the two reductions of each layer and
the logits gather done by the mesh. One process drives every shard; the
pool is sized once for all of them, and a shipped payload's full-head KV
is split onto the shards at admission.
"""

from __future__ import annotations

import asyncio
import contextlib
import math
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.config import get_config
from ray_tpu_torch.llm import kvcache, model as lm, pd, spec as specdec
from ray_tpu_torch.models.llama import Llama, LlamaConfig
from ray_tpu_torch.runtime.device_store import TensorRef
from ray_tpu_torch.serve.fault import DeadlineExceeded, fault_metrics
from ray_tpu_torch.util import devmon, forensics, tracing


class KVHandoffError(RuntimeError):
    """A prefilled request's shipped KV could not be taken (a handle
    that no longer resolves, or an entry that is neither a host array
    nor a handle). Fails only its own request, never the shared
    scheduler loop."""


def engine_metrics() -> dict:
    """Get-or-create the engine's request-phase series (the JAX engine's
    names; every engine in the process observes into the same series).
    Catalog:

      llm_queue_s        submit -> slot admission (waiting for a slot)
      llm_ttft_device_s  prefill device compute (launch to host sync)
      llm_ttft_wall_s    submit -> first token, wall clock
      llm_tpot_s         decode wall time per output token
      llm_batch_size     active decode slots per step block

    Device-memory attribution:

      llm_kv_cache_bytes           live KV cache bytes on device
      llm_kv_cache_headroom_bytes  growth left before max_len capacity
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "queue": m.Histogram(
            "llm_queue_s",
            "Wait from request submission to slot admission"),
        "ttft_device": m.Histogram(
            "llm_ttft_device_s",
            "Device compute time producing the first token (prefill "
            "forward + cache write, block_until_ready-bounded)"),
        "ttft_wall": m.Histogram(
            "llm_ttft_wall_s",
            "Wall time from submission to first token"),
        "tpot": m.Histogram(
            "llm_tpot_s", "Decode wall time per output token",
            boundaries=(.0005, .001, .0025, .005, .01, .025, .05, .1,
                        .25, .5, 1, 2.5)),
        "batch": m.Histogram(
            "llm_batch_size", "Active decode slots per step block",
            boundaries=(1, 2, 4, 8, 16, 32, 64, 128, 256)),
        "kv_bytes": m.Gauge(
            "llm_kv_cache_bytes",
            "Bytes of the engine's static KV cache currently on device"),
        "kv_headroom": m.Gauge(
            "llm_kv_cache_headroom_bytes",
            "Bytes of bucketed KV growth left before the cache reaches "
            "its max_len capacity (0 = fully grown; watch next to "
            "device_hbm_used_bytes for OOM creep)"),
    }


@dataclass
class _Request:
    tokens: List[int]                       # prompt (token ids)
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    top_p: float = 1.0                      # 1.0 = disabled
    top_k: int = 0                          # 0 = disabled
    # stop sequences (token-id lists); on a suffix match generation ends
    # and the matched suffix is trimmed from the result
    stop: Optional[List[List[int]]] = None
    out: List[int] = field(default_factory=list)
    fut: Optional[asyncio.Future] = None
    stream: Optional[asyncio.Queue] = None
    submitted: float = field(default_factory=time.monotonic)
    # absolute wall-clock deadline: an expired request is refused at
    # admission and an active one is cancelled at the next block boundary
    deadline_ts: Optional[float] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    prefill_device_s: float = 0.0           # launch to host sync
    # trace context bound where the request was submitted: its queue,
    # prefill and generate spans parent to it; cleared once the
    # terminal "generate" span is recorded (one per request)
    trace: Optional[tracing.TraceContext] = None
    t_submit_wall: float = field(default_factory=time.time)
    # paged-KV state: engine-unique sequence id, the block allocation
    # handed out at admission, and the prompt tokens served from cached
    # prefix blocks
    seq: int = 0
    kv_alloc: Optional[dict] = None
    prefix_hit: int = 0
    kv_written: bool = False    # prefill scatter reached the pool
    # KV a PrefillEngine computed for this prompt: {"k", "v": (layers,
    # ship, kvh, hd), "logits": (vocab,), "length": n}, dropped once
    # written; handoff_bytes counts the KV bytes as shipped
    prefilled: Optional[dict] = None
    handoff_bytes: int = 0
    # speculative decoding: the request's prompt-lookup drafter (its
    # history is tokens + out) and its drafted/accepted totals
    drafter: Optional[specdec.PromptLookupDrafter] = None
    spec_drafted: int = 0
    spec_accepted: int = 0


class LLMEngine:
    def __init__(self, cfg: LlamaConfig, params: Llama, *,
                 max_slots: int = 8, max_len: int = 1024,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512),
                 cache_dtype="bfloat16", seed: int = 0,
                 steps_per_sync: int = 8,
                 kv_block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_impl: Optional[str] = None,
                 spec: Optional[bool] = None,
                 device=None,
                 mesh=None,
                 detokenize: Optional[Callable[[List[int]], str]] = None):
        """``params`` is the port's ``Llama`` module, already on
        ``device``. ``device=None`` means the CUDA device and raises when
        none is available; tests pass ``device="cpu"`` explicitly, which
        runs every kernel's plain version. ``kv_block_size=0`` selects
        the monolithic cache; ``spec`` (paged only, ignored on the
        monolithic cache as in the JAX package) drafts through
        ``spec.PromptLookupDrafter``. As in the JAX engine, a knob left
        ``None`` reads its Config field (``kvcache_block_size``,
        ``kvcache_pool_blocks``, ``kvcache_prefix_cache``,
        ``paged_attn_impl``, ``spec_decode``), and the drafter takes its
        draft length, n-gram size and accept window from
        ``spec_draft_tokens``, ``spec_ngram_max`` and
        ``spec_backoff_window``.

        With ``mesh`` (a ``TensorMesh``), ``params`` is the whole model on
        any device (or already a ``ShardedLlama`` over this mesh); the
        engine splits it over the mesh and runs on the mesh's devices, the
        first of which is ``device`` (left None, it is taken from the
        mesh). The pool is sized here from the cards' free memory, so
        whole weights the caller still holds count against it:
        ``serve.llm`` shards and drops them before building the engine."""
        if mesh is not None:
            from ray_tpu_torch.parallel.tp import TensorMesh
            if not isinstance(mesh, TensorMesh):
                raise TypeError(
                    "mesh= takes a parallel.tp.TensorMesh (tensor-parallel "
                    f"serving), got {type(mesh).__name__}")
            self.device = mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device={device} is not the mesh's first "
                                 f"device {self.device}")
            if not (isinstance(params, lm.ShardedLlama)
                    and params.mesh is mesh):
                params = lm.shard_params_for_serving(params, mesh, cfg)
        else:
            self.device = resolve_device(device)
            if params.device != self.device:
                raise ValueError(f"params live on {params.device}, the "
                                 f"engine on {self.device}: move them first")
        self.mesh = mesh
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len)) or (max_len,)
        self.detokenize = detokenize
        cdt = getattr(torch, cache_dtype) if isinstance(cache_dtype, str) \
            else cache_dtype
        self._cdt = cdt
        _cfg = get_config()
        if kv_block_size is None:
            kv_block_size = int(_cfg.kvcache_block_size)
        if kv_pool_blocks is None:
            kv_pool_blocks = int(_cfg.kvcache_pool_blocks)
        if prefix_cache is None:
            prefix_cache = bool(_cfg.kvcache_prefix_cache)
        if kv_impl is None:
            kv_impl = str(_cfg.paged_attn_impl)
        if spec is None:
            spec = bool(_cfg.spec_decode)
        self._paged = kv_block_size > 0
        self._spec = bool(spec) and self._paged
        self._spec_k = max(1, int(_cfg.spec_draft_tokens))
        self._spec_ngram = max(1, int(_cfg.spec_ngram_max))
        self._spec_window = max(1, int(_cfg.spec_backoff_window))
        self._spec_buckets = specdec.width_buckets(self._spec_k)
        self._specm = specdec.spec_metrics() if self._spec else None
        self._kvm = kvcache.kvcache_metrics()
        self._kv_impl = kvcache.resolve_attn_impl(kv_impl, self.device)
        self._blocked: deque = deque()   # admits parked on the pool
        self._seq_counter = 0
        if self._paged:
            # the effective block size divides every prefill bucket and
            # max_len (prefill writes land block-aligned)
            b = kv_block_size
            for v in (*self.buckets, max_len):
                b = math.gcd(b, v)
            self._block = max(1, b)
            self._table_w = max_len // self._block
            itemsize = torch.empty((), dtype=cdt).element_size()
            per_tok = (cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
                       * itemsize)
            # sized once, for every shard, before any is allocated
            nb = kvcache.auto_pool_blocks(
                max_slots, self._table_w, per_tok * self._block,
                kv_pool_blocks,
                self.device if mesh is None else list(mesh.devices))
            self._cache_len = max_len     # no growth: tables span it
            self._pool = kvcache.init_pool(cfg, nb, self._block, cdt,
                                           self.device, mesh)
            # what one decode step would copy materialising the gathered
            # (slots, table_w * block) view: the bytes K4 keeps out of
            # device memory
            self._gather_step_bytes = (
                max_slots * self._table_w
                * kvcache.pool_block_bytes(self._pool))
            self._kv = kvcache.KVBlockManager(
                nb, self._block, table_width=self._table_w,
                prefix_cache=prefix_cache, metrics=self._kvm)
            self._tables = np.full((max_slots, self._table_w),
                                   kvcache.TRASH, np.int32)
            self._cache = None
        else:
            # the cache starts small and doubles, up to max_len, only when
            # an admitted request needs the room (_grow_cache)
            self._cache_len = min(max_len, max(1024, self.buckets[-1]))
            self._cache = lm.init_cache(cfg, max_slots, self._cache_len,
                                        cdt, self.device, mesh)
        self._slots: List[Optional[_Request]] = [None] * max_slots
        self._waiting: "asyncio.Queue[_Request]" = asyncio.Queue()
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps_per_sync = max(1, steps_per_sync)
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = False
        self._requests = 0
        self._tokens_generated = 0
        self._ttft_sum = 0.0
        self._ttft_count = 0
        self._handoff_bytes = 0
        self._m = engine_metrics()
        self._kv_account()
        # postmortem state through a weakref: the provider must not keep
        # a dead engine (and its KV cache) alive
        ref = weakref.ref(self)

        def provider():
            eng = ref()
            return eng.stats if eng is not None else None
        forensics.register_state_provider(self._provider_name, provider)

    @property
    def _provider_name(self) -> str:
        return f"llm_engine:{id(self):x}"

    @property
    def stats(self) -> dict:
        """Scalar engine counters, with the JAX engine's keys (paged-only
        keys only when paged), plus ``handoff_bytes`` (KV bytes admitted
        through ``prefilled=``, as shipped) and ``device``."""
        out = {"requests": self._requests,
               "tokens_generated": self._tokens_generated,
               "ttft_sum": self._ttft_sum,
               "ttft_count": self._ttft_count,
               "cache_len": self._cache_len,
               "paged": self._paged,
               "handoff_bytes": self._handoff_bytes,
               "device": str(self.device),
               "tensor_parallel": 1 if self.mesh is None else self.mesh.size}
        if self._paged:
            out.update(block_size=self._block,
                       blocks_used=self._kv.used_blocks(),
                       blocks_cached=self._kv.cached_blocks(),
                       blocks_free=self._kv.free_blocks(),
                       prefix_hit_tokens=self._kv.hit_tokens_total,
                       kv_impl=self._kv_impl,
                       spec=self._spec)
        return out

    def _cache_bytes(self) -> int:
        """The monolithic cache's k/v bytes, over every shard."""
        return sum(x.nbytes for key in ("k", "v")
                   for x in lm.parts(self._cache[key]))

    def _kv_per_token_bytes(self) -> float:
        """Device bytes one KV position of one slot costs (k and v, all
        layers, all shards): the unit a request's device memory is priced
        in."""
        if self._paged:
            return kvcache.pool_block_bytes(self._pool) / self._block
        return self._cache_bytes() / float(self.max_slots * self._cache_len)

    def _kv_account(self) -> None:
        """Publish the KV bytes held in device memory. Paged: live bytes
        are the blocks live requests reference plus the resident
        prefix-cache blocks; headroom is the free blocks. Monolithic: the
        cache's bytes, and the growth left before max_len. Under a mesh
        both sum over the shards (the JAX engine's global array bytes)."""
        if self._paged:
            bb = kvcache.pool_block_bytes(self._pool)
            live = self._kv.used_blocks() + self._kv.cached_blocks()
            self._m["kv_bytes"].set(bb * live)
            self._m["kv_headroom"].set(bb * self._kv.free_blocks())
            return
        cur = self._cache_bytes()
        per_tok = self._kv_per_token_bytes()
        headroom = per_tok * self.max_slots \
            * (self.max_len - self._cache_len)
        self._m["kv_bytes"].set(cur)
        self._m["kv_headroom"].set(headroom)

    def _grow_cache(self, need: int) -> None:
        """Double the monolithic cache's per-slot length until >= need,
        capped at max_len; active slots' KV is kept (zero-padded on the
        length axis, into new tensors: the old ones are held until the
        copy is made; every shard under a mesh)."""
        new_len = self._cache_len
        while new_len < need:
            new_len *= 2
        new_len = min(new_len, self.max_len)
        pad = new_len - self._cache_len
        if pad <= 0:
            return
        c = self._cache
        widths = (0, 0, 0, 0, 0, pad)
        self._cache = {"k": lm.map_parts(lambda x: F.pad(x, widths), c["k"]),
                       "v": lm.map_parts(lambda x: F.pad(x, widths), c["v"]),
                       "length": c["length"]}
        self._cache_len = new_len
        self._kv_account()

    # --- public API -----------------------------------------------------

    async def generate(self, tokens: Sequence[int], *,
                       max_new_tokens: int = 64,
                       temperature: float = 0.0,
                       eos_id: Optional[int] = None,
                       top_p: float = 1.0, top_k: int = 0,
                       stop: Optional[Sequence[Sequence[int]]] = None,
                       prefilled: Optional[dict] = None,
                       deadline_ts: Optional[float] = None) -> dict:
        """Generate up to ``max_new_tokens`` after ``tokens``. ``top_p``/
        ``top_k`` filter the sampler (1.0/0 disable); ``stop`` is a list
        of token-id sequences that end generation (matched suffix
        trimmed); ``prefilled`` is a ``PrefillEngine`` payload for these
        tokens, admitted with no prompt forward; ``deadline_ts``
        (absolute wall clock) cancels the request, freeing its slot,
        with ``DeadlineExceeded``."""
        r = self._submit(tokens, max_new_tokens, temperature, eos_id,
                         top_p=top_p, top_k=top_k, stop=stop,
                         prefilled=prefilled, deadline_ts=deadline_ts)
        r.fut = asyncio.get_running_loop().create_future()
        await r.fut
        return self._result(r)

    async def generate_stream(self, tokens: Sequence[int], *,
                              max_new_tokens: int = 64,
                              temperature: float = 0.0,
                              eos_id: Optional[int] = None,
                              top_p: float = 1.0, top_k: int = 0,
                              stop: Optional[Sequence[Sequence[int]]] = None,
                              prefilled: Optional[dict] = None,
                              deadline_ts: Optional[float] = None):
        """Async generator of token ids as they are produced. Tokens of a
        stop sequence may be yielded before the match completes."""
        r = self._submit(tokens, max_new_tokens, temperature, eos_id,
                         top_p=top_p, top_k=top_k, stop=stop,
                         prefilled=prefilled, deadline_ts=deadline_ts)
        r.stream = asyncio.Queue()
        while True:
            t = await r.stream.get()
            if t is None:
                return
            if isinstance(t, BaseException):
                raise t
            yield t

    async def generate_prefilled(self, tokens, prefilled: dict,
                                 **kw) -> dict:
        return await self.generate(tokens, prefilled=prefilled, **kw)

    def generate_stream_prefilled(self, tokens, prefilled: dict, **kw):
        return self.generate_stream(tokens, prefilled=prefilled, **kw)

    def _submit(self, tokens, max_new_tokens, temperature, eos_id,
                top_p=1.0, top_k=0, stop=None, prefilled=None,
                deadline_ts=None):
        if self._stopped:
            raise RuntimeError("engine is stopped")
        if deadline_ts is not None and time.time() > deadline_ts:
            raise DeadlineExceeded("budget spent before submission")
        tokens = list(map(int, tokens))
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if len(tokens) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+generation ({len(tokens)}+{max_new_tokens}) "
                f"exceeds max_len {self.max_len}")
        stop = [list(map(int, s)) for s in stop] if stop else None
        if stop and any(not s for s in stop):
            raise ValueError("empty stop sequence")
        if prefilled is not None:
            # a malformed payload fails this request here, never the
            # shared scheduler loop mid-admit
            for k in ("k", "v", "logits", "length"):
                if k not in prefilled:
                    raise ValueError(f"prefilled payload missing {k!r}")
            if int(prefilled["length"]) != len(tokens):
                raise ValueError(
                    f"prefilled length {prefilled['length']} != prompt "
                    f"length {len(tokens)}")
            if prefilled["k"].shape[1] > self.max_len:
                raise ValueError(
                    f"prefilled KV spans {prefilled['k'].shape[1]} "
                    f"positions > decode max_len {self.max_len} "
                    "(prefill/decode bucket configs disagree)")
            for k in ("k", "v"):
                if isinstance(prefilled[k], np.ndarray):
                    pd.kv_dtype_of(prefilled[k], prefilled.get("kv_dtype"))
        r = _Request(tokens, max_new_tokens, temperature, eos_id,
                     top_p=float(top_p), top_k=int(top_k), stop=stop,
                     deadline_ts=deadline_ts, prefilled=prefilled,
                     trace=tracing.current_context())
        if self._paged:
            self._seq_counter += 1
            r.seq = self._seq_counter
        if self._spec:
            r.drafter = specdec.PromptLookupDrafter(
                k=self._spec_k, ngram_max=self._spec_ngram,
                window=self._spec_window)
        self._waiting.put_nowait(r)
        self._requests += 1
        self._ensure_loop()
        return r

    def _result(self, r: _Request) -> dict:
        out = {"tokens": r.out,
               "ttft_s": (r.first_token_at or 0) - r.submitted}
        if self._paged:
            out["prefix_hit_tokens"] = r.prefix_hit
        if self.detokenize is not None:
            out["text"] = self.detokenize(r.out)
        return out

    async def stop(self):
        self._stopped = True
        forensics.unregister_state_provider(self._provider_name)
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    # --- scheduler loop -------------------------------------------------

    def _ensure_loop(self):
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._run())

    def _bucket_for(self, n: int) -> int:
        return lm.bucket_for(self.buckets, n)

    def _pop_candidate(self) -> Optional[_Request]:
        """Next admissible request: pool-parked admits first (FIFO), then
        the waiting queue. Deadline-expired candidates fail fast here."""
        while self._blocked:
            cand = self._blocked.popleft()
            if cand.deadline_ts is not None and \
                    time.time() > cand.deadline_ts:
                self._expire(cand, None)
                continue
            return cand
        while not self._waiting.empty():
            cand = self._waiting.get_nowait()
            if cand.deadline_ts is not None and \
                    time.time() > cand.deadline_ts:
                self._expire(cand, None)
                continue
            return cand
        return None

    async def _run(self):
        loop = asyncio.get_running_loop()
        try:
            while not self._stopped:
                # 1) admit waiting requests into free slots (prefill)
                #    before the decode block, for low TTFT
                for slot in range(self.max_slots):
                    if self._slots[slot] is not None:
                        continue
                    r = self._pop_candidate()
                    if r is None:
                        continue
                    if self._paged and r.kv_alloc is None:
                        # full-horizon block reservation at admission:
                        # decode never fails mid-flight on pool pressure;
                        # overload parks the admit (FIFO) instead
                        try:
                            alloc = self._kv.alloc_seq(
                                r.seq, r.tokens, r.max_new_tokens)
                        except kvcache.BlockPoolExhausted as e:
                            self._fail(r, None, e)
                            continue
                        if alloc is None:
                            self._blocked.appendleft(r)
                            break
                        r.kv_alloc = alloc
                        r.prefix_hit = alloc["hit_tokens"]
                        # publish the reservation now, not at the first
                        # finish: the overload window is what the gauges
                        # are for
                        self._kv_account()
                    try:
                        tok = await loop.run_in_executor(
                            None, self._in_context, r.trace,
                            self._admit_impl, slot, r)
                    except KVHandoffError as e:
                        # an unusable KV handle fails its own request
                        # only; it was taken before any cache write
                        self._fail(r, slot, e)
                        continue
                    except BaseException as e:  # noqa: BLE001
                        # the candidate is in no queue and no slot yet:
                        # fail it here or its caller waits forever
                        self._fail(r, slot, e)
                        raise
                    self._emit_token(r, tok, slot)
                # deadline-cancel active slots at the block boundary
                now = time.time()
                for i, r in enumerate(self._slots):
                    if r is not None and r.deadline_ts is not None \
                            and now > r.deadline_ts:
                        self._expire(r, i)
                active = [i for i, r in enumerate(self._slots)
                          if r is not None]
                if not active:
                    if self._blocked:
                        # parked admits with nothing running wait only on
                        # eviction: re-try shortly
                        await asyncio.sleep(0.01)
                        continue
                    if self._waiting.empty():
                        r = await self._waiting.get()
                        self._waiting.put_nowait(r)
                    continue
                # 2a) speculative round: ask each active slot's drafter
                #     for a continuation; if any slot drafts, one verify
                #     forward scores every slot (non-drafting ones at
                #     width 1); if none does, fall through to a decode
                #     block
                drafts: dict = {}
                if self._spec:
                    for i in active:
                        r = self._slots[i]
                        # leave room for the bonus token; never draft
                        # past the request's horizon
                        budget = min(r.drafter.k,
                                     r.max_new_tokens - len(r.out) - 1,
                                     self._cache_len - len(r.tokens)
                                     - len(r.out) - 1)
                        if budget < 1:
                            continue
                        d = r.drafter.propose(r.tokens + r.out, budget)
                        if d:
                            drafts[i] = d
                if drafts:
                    await self._spec_round(loop, active, drafts)
                    await asyncio.sleep(0)
                    continue
                # 2) a block of decode steps for every active slot, one
                #    host sync per block, bounded by each slot's budget
                block = self.steps_per_sync
                for i in active:
                    r = self._slots[i]
                    block = min(block, r.max_new_tokens - len(r.out),
                                self._cache_len - len(r.tokens)
                                - len(r.out))
                block = 1 << (max(1, block).bit_length() - 1)  # pow2 down
                tokens = np.zeros((self.max_slots,), np.int32)
                temps = np.zeros((self.max_slots,), np.float32)
                top_ps = np.ones((self.max_slots,), np.float32)
                top_ks = np.zeros((self.max_slots,), np.int32)
                for i in active:
                    tokens[i] = self._slots[i].out[-1]
                    temps[i] = self._slots[i].temperature
                    top_ps[i] = self._slots[i].top_p
                    top_ks[i] = self._slots[i].top_k
                member_traces, first_ctx = self._member_traces(active)
                t_dec = time.monotonic()
                t_dec_wall = time.time()
                out = await loop.run_in_executor(
                    None, self._in_context, first_ctx, self._decode_impl,
                    tokens, temps, top_ps, top_ks, block)
                avoided = (block * self._gather_step_bytes
                           if self._paged and self._kv_impl == "paged_flash"
                           else 0)
                self._record_round(
                    active, member_traces, first_ctx, t_dec, t_dec_wall,
                    block, block=block, gather_bytes_avoided=avoided,
                    kv_impl=self._kv_impl if self._paged else "monolithic")
                for step in range(block):
                    for i in active:
                        r = self._slots[i]
                        if r is None:   # finished earlier in this block
                            continue
                        self._emit_token(r, int(out[step, i]), i)
                await asyncio.sleep(0)
        except BaseException as e:  # noqa: BLE001 — fail all requests
            for i, r in enumerate(self._slots):
                if r is not None:
                    self._fail(r, i, e)
            while self._blocked:
                self._fail(self._blocked.popleft(), None, e)
            while not self._waiting.empty():
                self._fail(self._waiting.get_nowait(), None, e)
            raise
        finally:
            for i, r in enumerate(self._slots):
                if r is not None:
                    self._finish(r, i)

    def _member_traces(self, active: List[int]):
        """The sorted trace ids of the active slots' requests (a decode
        block's or verify round's span links to each) and the first
        active request's context (bound while the block runs, and named
        by the block's exemplar)."""
        ctxs = [self._slots[i].trace for i in active
                if self._slots[i] is not None
                and self._slots[i].trace is not None]
        return sorted({c.trace_id for c in ctxs}), \
            (ctxs[0] if ctxs else None)

    def _record_round(self, active, member_traces, first_ctx, t_dec: float,
                      t_dec_wall: float, per_slot: float, **span) -> None:
        """A decode block's or verify round's batch-size histogram, its
        wall per emitted token (over ``per_slot`` tokens a slot), its
        batch span linked to every member trace (``span``: the tokens,
        the attention impl, the gather bytes K4 avoided, the verify
        width) and its device window, which ends at the host sync; the
        exemplars name the first member's trace."""
        ex = first_ctx.trace_id if first_ctx is not None else None
        self._m["batch"].observe(len(active), exemplar=ex)
        self._m["tpot"].observe((time.monotonic() - t_dec) / per_slot,
                                exemplar=ex)
        tracing.record_batch_span("engine", "decode", member_traces,
                                  t_dec_wall, time.time(),
                                  slots=len(active), **span)
        devmon.record_device_window("decode", t_dec_wall, time.time(),
                                    trace=ex or "")

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device (never a view
        of host state the scheduler goes on mutating)."""
        return torch.tensor(x, device=self.device)

    def _acc_len(self) -> int:
        """Accumulator length for block-table prefill: the table span
        rounded up to a chunk multiple plus one slack chunk, so a padded
        piece never overruns it."""
        chunk = self.buckets[-1]
        span = self._table_w * self._block
        return ((span + chunk - 1) // chunk) * chunk + chunk

    def _prefill_start(self, hit: int) -> int:
        """First position the suffix prefill computes for a ``hit``-token
        prefix hit. Where the flash kernel runs, the start rounds down to
        the chunk grid, so cold and hit requests compute every suffix row
        on the same grid; the recomputed rows land in full hit blocks,
        whose scatter targets are trash."""
        if hit == 0 or not lm.flash_capable(self.cfg, self.device):
            return hit
        chunk = self.buckets[-1]
        return (hit // chunk) * chunk

    def _take_handoff(self, x):
        """A shipped payload entry: a host array passes through; a
        ``TensorRef`` resolves onto the engine's device (reference: RDT
        tensor_transport_manager.py:37 — the parked tensor itself in the
        same process, one fetch across processes). Anything that cannot
        be taken fails its own request with ``KVHandoffError``."""
        if isinstance(x, np.ndarray):
            return x
        if not isinstance(x, TensorRef):
            raise KVHandoffError(
                f"prefilled KV entry of type {type(x).__name__}: ship "
                "host arrays or TensorRef handles")
        try:
            return x.resolve(self.device)
        except Exception as e:
            raise KVHandoffError(
                f"prefilled KV handle unresolvable: {e}") from e

    @contextlib.contextmanager
    def _take_prefilled(self, r: _Request):
        """Yields the request's shipped KV on the device in the cache
        dtype, {"k", "v": (layers, ship, kvh, hd)} (under a mesh, split
        on the kv-head dim into per-shard lists on the shards' devices),
        and its logits on the host. A host array arrives in its shipped dtype (the port's
        ``uint16`` bf16 bits, the JAX package's ml_dtypes bf16, or a
        float dtype) and is widened or cast on the device; a handle
        arrives as the tensor it parks. Counts the KV bytes as shipped;
        drops the payload. The handoff is single-use: on exit, after the
        body's cache write has been waited for, or when taking or writing
        fails, every KV handle of the payload is freed, so a failed
        request leaves nothing parked."""
        p = r.prefilled
        r.prefilled = None
        handles = [p[key] for key in ("k", "v")
                   if isinstance(p[key], TensorRef)]
        try:
            k, v, logits = (self._take_handoff(p[key])
                            for key in ("k", "v", "logits"))
            r.handoff_bytes = int(k.nbytes + v.nbytes)
            self._handoff_bytes += r.handoff_bytes
            self._kvm["handoff_bytes"].inc(r.handoff_bytes)
            tag = p.get("kv_dtype")
            # kv_to_torch copies: the device copy never aliases the payload
            kv = {key: (pd.kv_to_torch(x, tag) if isinstance(x, np.ndarray)
                        else x).to(self.device).to(self._cdt)
                  for key, x in (("k", k), ("v", v))}
            if self.mesh is not None:
                kv = {key: lm.split_kv_heads(x, self.mesh)
                      for key, x in kv.items()}
            yield kv, np.asarray(logits, np.float32)
            self._sync()          # the cache holds the KV now
        finally:
            for h in handles:
                h.free()

    def _sync(self) -> None:
        """Wait for the work this thread launched (a shipped payload's
        cache write has no host copy of its own to wait on)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _in_context(ctx: Optional[tracing.TraceContext], fn, *args):
        """``fn(*args)`` on the executor thread with ``ctx`` bound as the
        request context when it is not None: context variables do not
        cross into ``run_in_executor``, and a kernel build that the call
        triggers is stamped with the bound trace id. The admit binds its
        own request; a decode block or a verify round its first member."""
        if ctx is None:
            return fn(*args)
        tok = tracing.set_request_context(ctx)
        try:
            return fn(*args)
        finally:
            tracing.reset_request_context(tok)

    def _admit_impl(self, slot: int, r: _Request) -> int:
        """The paged or the monolithic admit, after the request's queue
        wait is observed (and spanned, if traced). Returns the first
        sampled token."""
        r.admitted_at = time.monotonic()
        self._m["queue"].observe(r.admitted_at - r.submitted)
        if r.trace is not None:
            tracing.record_request_span(
                "engine", "queue", r.trace, r.trace.span_id,
                r.t_submit_wall,
                r.t_submit_wall + (r.admitted_at - r.submitted))
        if self._paged:
            return self._admit_paged(slot, r)
        return self._admit_monolithic(slot, r)

    @torch.no_grad()
    def _admit_monolithic(self, slot: int, r: _Request) -> int:
        """Monolithic prefill: grow the cache if the request needs the
        room, then fill the slot with the prompt's KV, from one bucketed
        ``prefill``, chunked prefill (long prompts) or the shipped
        payload re-padded to a bucket multiple (as the JAX engine pads
        it, so the cache grows to the same length)."""
        n = len(r.tokens)
        need = n + r.max_new_tokens
        pad_to = 0
        if r.prefilled is not None:
            length = int(r.prefilled["k"].shape[1])
            big = self.buckets[-1]
            pad_to = (self._bucket_for(length) if length <= big
                      else -(-length // big) * big)
            pad_to = min(pad_to, self.max_len)
            need = max(need, pad_to)
        if need > self._cache_len:
            self._grow_cache(need)
        t0 = time.monotonic()
        if r.prefilled is not None:
            with self._take_prefilled(r) as (kv, logits_np):
                kv = self._pad_kv(kv, pad_to)
                lm.write_prefill_to_cache(self._cache, kv, slot, n)
        else:
            if n <= self.buckets[-1]:
                padded = self._to_dev(lm.pad_prompt(
                    r.tokens, self._bucket_for(n)))
                logits, kv = lm.prefill(self.params, padded, n, self.cfg,
                                        self._cache_len)
            else:
                # accumulate into a bucket multiple >= the cache length,
                # so a padded last piece never overruns it, then slice
                # back to the cache length
                chunk = self.buckets[-1]
                acc = lm.zero_acc(self.cfg, -(-self._cache_len // chunk)
                                  * chunk, self._cdt, self.device, self.mesh)
                logits, acc = lm.chunked_prefill(self.params, r.tokens,
                                                 self.buckets, acc, self.cfg)
                kv = {k: lm.map_parts(lambda a: a[:, :self._cache_len], x)
                      for k, x in acc.items()}
            lm.write_prefill_to_cache(self._cache, kv, slot, n)
            logits_np = logits.float().cpu().numpy()   # host sync
        r.prefill_device_s = time.monotonic() - t0
        self._record_prefill_span(r)
        self._slots[slot] = r
        return self._sample_one(logits_np, r)

    @torch.no_grad()
    def _admit_paged(self, slot: int, r: _Request) -> int:
        """Paged prefill (executor thread): the scheduler already reserved
        the block table; write the prompt's KV through it. A shipped
        payload is padded to the accumulator and scattered; cold short
        prompts take one bucketed ``prefill`` and a scatter; prefix hits
        and long prompts take chunked prefill over a gathered
        accumulator. Prefix-hit blocks are never written (their targets
        are trash). Returns the first sampled token."""
        n = len(r.tokens)
        table = r.kv_alloc["table"]
        hit = r.prefix_hit
        B = self._block
        self._tables[slot] = table
        t0 = time.monotonic()
        if r.prefilled is not None:
            with self._take_prefilled(r) as (kv, logits_np):
                acc = self._pad_kv(kv, self._acc_len())
                targets = table.copy()
                targets[:hit // B] = kvcache.TRASH
                kvcache.scatter_table(self._pool, acc, targets)
        else:
            if hit == 0 and n <= self.buckets[-1]:
                b = self._bucket_for(n)
                padded = self._to_dev(lm.pad_prompt(r.tokens, b))
                logits, kv = lm.prefill(self.params, padded, n, self.cfg, b)
                nb = b // B
                phys = np.full((nb,), kvcache.TRASH, np.int32)
                phys[:min(nb, self._table_w)] = \
                    table[:min(nb, self._table_w)]
                kvcache.scatter_bucket(self._pool, kv, phys, nb)
            else:
                logits = self._prefill_into_blocks(r, table, hit)
            logits_np = logits.float().cpu().numpy()   # host sync
        r.kv_written = True
        r.prefill_device_s = time.monotonic() - t0
        self._record_prefill_span(r)
        self._slots[slot] = r
        return self._sample_one(logits_np, r)

    @staticmethod
    def _pad_kv(kv: dict, length: int) -> dict:
        """Shipped KV (layers, ship, kvh, hd), each shard's, zero-padded on
        the position axis to ``length`` (left as it is when longer)."""
        def pad(x):
            n = length - x.shape[1]
            return F.pad(x, (0, 0, 0, 0, 0, n)) if n > 0 else x
        return {k: lm.map_parts(pad, v) for k, v in kv.items()}

    @staticmethod
    def _record_prefill_span(r: _Request) -> None:
        """The prefill's device window (launch to host sync, ending now)
        and, for a traced request, its ``prefill`` span: the device share
        of TTFT."""
        now = time.time()
        devmon.record_device_window(
            "prefill", now - r.prefill_device_s, now,
            trace=r.trace.trace_id if r.trace is not None else "")
        if r.trace is None:
            return
        tracing.record_request_span(
            "engine", "prefill", r.trace, r.trace.span_id,
            now - r.prefill_device_s, now, tokens=len(r.tokens))

    def _prefill_into_blocks(self, r: _Request, table: np.ndarray,
                             hit: int) -> torch.Tensor:
        """Prefix-hit (and long-prompt) prefill: gather the table's cached
        blocks into a contiguous accumulator, run the suffix through
        ``chunked_prefill`` from ``_prefill_start``, then scatter the new positions' KV back into the request's own
        blocks (shared prefix blocks target trash)."""
        acc = kvcache.gather_table(self._pool, table, self._acc_len())
        logits, acc = lm.chunked_prefill(self.params, r.tokens, self.buckets,
                                         acc, self.cfg,
                                         self._prefill_start(hit))
        targets = table.copy()
        targets[:hit // self._block] = kvcache.TRASH
        kvcache.scatter_table(self._pool, acc, targets)
        return logits

    @torch.no_grad()
    def _decode_impl(self, tokens: np.ndarray, temps: np.ndarray,
                     top_ps: np.ndarray, top_ks: np.ndarray,
                     block: int) -> np.ndarray:
        """Returns (block, slots) int32 sampled tokens. Paged: per-slot
        write positions are host-derived (prompt + emitted - 1: the last
        emitted token's KV lands this step), and empty slots write into
        the trash block. Monolithic: the cache's length counters are the
        write positions."""
        # decided on the host, so the device loop never syncs to branch:
        # all-greedy blocks skip the sampler, filters cost sorts only when
        # some active request enabled one
        sampled = bool((temps > 0).any())
        filters_on = bool((top_ps < 1.0).any() or (top_ks > 0).any())
        tv = self._to_dev(temps) if sampled else None
        tp = self._to_dev(top_ps) if filters_on else None
        tk = self._to_dev(top_ks) if filters_on else None
        if not self._paged:
            # write positions are the cache's own length counters
            out, self._cache = lm.decode_steps(
                self.params, self._cache, self._to_dev(tokens), tv,
                self._gen, self.cfg, block, tp, tk)
            return out.cpu().numpy()   # the block's one host sync
        lengths = np.zeros((self.max_slots,), np.int32)
        for i, r in enumerate(self._slots):
            if r is not None:
                lengths[i] = len(r.tokens) + len(r.out) - 1
        out, self._pool = kvcache.paged_decode_steps(
            self.params, self._pool, self._to_dev(self._tables),
            self._to_dev(lengths), self._to_dev(tokens),
            tv, self._gen, self.cfg, block, tp, tk,
            impl=self._kv_impl)
        self._kvm["attn_steps"].inc(block, tags={"impl": self._kv_impl})
        if self._kv_impl == "paged_flash":
            self._kvm["gather_avoided"].inc(block * self._gather_step_bytes)
        return out.cpu().numpy()   # the block's one host sync

    async def _spec_round(self, loop, active: List[int],
                          drafts: dict) -> None:
        """One draft-and-verify round: pad every active slot's
        [last token, draft...] row to a verify-width bucket (repeating
        the last token: pad columns write KV beyond the slot's logical
        length, masked out of every attention and overwritten by the
        next real write), score all positions in one forward, accept per
        slot (``spec.accept_tokens``), roll back the host block
        accounting of rejected tails, and emit 1..k+1 tokens per slot."""
        w = specdec.bucket_width(
            self._spec_buckets, 1 + max(len(d) for d in drafts.values()))
        tokens_bw = np.zeros((self.max_slots, w), np.int32)
        lengths = np.zeros((self.max_slots,), np.int32)
        for i in active:
            r = self._slots[i]
            row = [r.out[-1]] + drafts.get(i, [])
            row += [row[-1]] * (w - len(row))
            tokens_bw[i] = row
            lengths[i] = len(r.tokens) + len(r.out) - 1
        member_traces, first_ctx = self._member_traces(active)
        t_dec = time.monotonic()
        t_dec_wall = time.time()
        logits = await loop.run_in_executor(
            None, self._in_context, first_ctx, self._verify_impl,
            tokens_bw, lengths)
        emitted_total = 0
        for i in active:
            r = self._slots[i]
            if r is None:
                continue
            d = drafts.get(i, [])
            emitted, n_acc = specdec.accept_tokens(
                logits[i, :len(d) + 1], d, temperature=r.temperature,
                top_k=r.top_k, top_p=r.top_p, rng=self._rng)
            if d:
                r.drafter.record(len(d), n_acc)
                r.spec_drafted += len(d)
                r.spec_accepted += n_acc
                self._specm["tokens"].inc(len(d), tags={"kind": "drafted"})
                if n_acc:
                    self._specm["tokens"].inc(n_acc,
                                              tags={"kind": "accepted"})
                if len(d) > n_acc:
                    self._specm["tokens"].inc(len(d) - n_acc,
                                              tags={"kind": "rejected"})
                    # host rollback of the rejected tail: under the
                    # full-horizon reservation (min_blocks) it frees no
                    # block, and it keeps the hash chain honest
                    self._kv.truncate_seq(
                        r.seq, len(r.tokens) + len(r.out) + len(emitted),
                        min_blocks=self._kv.blocks_needed(
                            len(r.tokens), r.max_new_tokens))
            emitted_total += len(emitted)
            for t in emitted:
                if self._slots[i] is not r:
                    break   # finished mid-accept (eos/stop/max_new): the
                            # tail of an accepted draft is dropped
                self._emit_token(r, int(t), i)
        self._record_round(
            active, member_traces, first_ctx, t_dec, t_dec_wall,
            max(1.0, emitted_total / max(1, len(active))),
            block=emitted_total, kv_impl=self._kv_impl,
            gather_bytes_avoided=0, spec_k=w - 1)

    @torch.no_grad()
    def _verify_impl(self, tokens_bw: np.ndarray,
                     lengths: np.ndarray) -> np.ndarray:
        """Returns (slots, w, vocab) f32 verify logits on the host (the
        round's one host sync)."""
        logits, self._pool = kvcache.paged_verify_steps(
            self.params, self._pool, self._to_dev(self._tables),
            self._to_dev(lengths), self._to_dev(tokens_bw), self.cfg)
        self._kvm["attn_steps"].inc(1, tags={"impl": self._kv_impl})
        return logits.cpu().numpy()

    def _sample_one(self, logits: np.ndarray, r: _Request) -> int:
        """Host-side sampling of the first token (prefill output is one
        logits vector), through ``spec.host_probs``: the temperature ->
        top-k -> top-p transform the device sampler and the speculative
        acceptance share."""
        if r.temperature <= 0:
            return int(np.argmax(logits))
        p = specdec.host_probs(np.asarray(logits), r.temperature, r.top_k,
                               r.top_p)
        return int(self._rng.choice(len(p), p=p))

    def _emit_token(self, r: _Request, tok: int, slot: int):
        """Append one sampled token; finish the request if done."""
        if r.first_token_at is None:
            r.first_token_at = time.monotonic()
            wall = r.first_token_at - r.submitted
            self._ttft_sum += wall
            self._ttft_count += 1
            self._m["ttft_wall"].observe(wall)
            # the device time is a sub-interval of the wall interval
            self._m["ttft_device"].observe(
                min(r.prefill_device_s, wall),
                exemplar=r.trace.trace_id if r.trace else None)
        r.out.append(tok)
        self._tokens_generated += 1
        if r.stream is not None:
            r.stream.put_nowait(tok)
        if r.stop:
            for seq in r.stop:
                if len(r.out) >= len(seq) and r.out[-len(seq):] == seq:
                    del r.out[-len(seq):]   # trim the stop sequence
                    self._finish(r, slot)
                    return
        if (len(r.out) >= r.max_new_tokens
                or (r.eos_id is not None and tok == r.eos_id)):
            self._finish(r, slot)

    def _record_done(self, r: _Request, error: bool) -> None:
        """The request's terminal ``generate`` span (submit to done, its
        token count and its KV high-watermark priced at the cache's
        per-token bytes), at most once; and, for a speculative request,
        the accept-rate gauge, traced or not."""
        if r.spec_drafted and self._specm is not None:
            self._specm["accept_rate"].set(r.spec_accepted / r.spec_drafted)
        if r.trace is None:
            return
        extra = {}
        if self._paged:
            extra["prefix_hit_tokens"] = r.prefix_hit
        if r.handoff_bytes:
            extra["kv_handoff_bytes"] = r.handoff_bytes
        if r.spec_drafted:
            extra["spec_accept_rate"] = round(
                r.spec_accepted / r.spec_drafted, 4)
        tracing.record_request_span(
            "engine", "generate", r.trace, r.trace.span_id,
            r.t_submit_wall, time.time(), error=error,
            tokens=len(r.out),
            kv_bytes=int(self._kv_per_token_bytes()
                         * (len(r.tokens) + len(r.out))), **extra)
        r.trace = None

    def _free_kv(self, r: _Request, slot: Optional[int]) -> None:
        """Return a finished/failed request's blocks to the pool; its
        prompt+output block chain enters the prefix index, except the
        final sampled token, whose KV was never written. A request that
        failed before its prefill scatter caches nothing. The slot's
        table row reverts to trash."""
        if r.kv_alloc is None:
            return
        stream = list(r.tokens) + list(r.out)
        if r.out:
            stream = stream[:-1]
        self._kv.free_seq(r.seq, stream, cache=r.kv_written)
        r.kv_alloc = None
        if slot is not None:
            self._tables[slot] = kvcache.TRASH
        self._kv_account()

    def _finish(self, r: _Request, slot: Optional[int]):
        self._record_done(r, error=False)
        self._free_kv(r, slot)
        if slot is not None and self._slots[slot] is r:
            self._slots[slot] = None
        if r.stream is not None:
            r.stream.put_nowait(None)
        if r.fut is not None and not r.fut.done():
            r.fut.set_result(True)

    def _expire(self, r: _Request, slot: Optional[int]):
        """Cancel a request whose deadline passed (queued or mid-
        generation), counting it at the engine's enforcement point."""
        fault_metrics()["deadline"].inc(tags={"where": "engine"})
        self._fail(r, slot, DeadlineExceeded(
            f"generation cancelled at the deadline after "
            f"{len(r.out)} token(s)"))

    def _fail(self, r: _Request, slot: Optional[int], e: BaseException):
        self._record_done(r, error=True)
        self._free_kv(r, slot)
        err = e if isinstance(e, (DeadlineExceeded, KVHandoffError)) \
            else RuntimeError(f"llm engine failed: {e}")
        if slot is not None and self._slots[slot] is r:
            self._slots[slot] = None
        if r.stream is not None:
            r.stream.put_nowait(err)
        if r.fut is not None and not r.fut.done():
            r.fut.set_exception(err)
