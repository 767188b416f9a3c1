"""Central config table for the runtime.

The port's copy of ``ray_tpu/config.py``, cut to the fields the port's
code reads, each with the reference's default. Equivalent in spirit to
the reference's ``RAY_CONFIG`` X-macro table (reference:
src/ray/common/ray_config_def.h) — every tunable has a typed default and
is overridable from the environment as ``RAY_TPU_<NAME>`` or from the
``system_config`` dict handed to :func:`ray_tpu_torch.init`. A field of
the reference comes here with the port's code that reads it, so no
knob is accepted and then ignored; a ``system_config`` key that names no field
lands in ``extra``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any


def _env(name: str, default: Any, typ: type) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if typ in (dict, list):
        return json.loads(raw)
    return typ(raw)


@dataclass
class Config:
    # --- control service (head) ---
    head_host: str = "127.0.0.1"
    head_port: int = 0                      # 0 = pick a free port
    health_check_period_s: float = 1.0      # head -> agent liveness probes
    health_check_failure_threshold: int = 5
    # Cluster-view snapshot staleness bound: heartbeat replies ship a
    # cached pickled view rebuilt at most this often (O(nodes) to build,
    # so per-beat rebuilds are O(nodes^2)/s cluster-wide — see
    # SCALE_BENCH_STRETCH.json for the measured collapse at 1k nodes).
    view_snapshot_interval_s: float = 0.5

    # --- node agent / workers ---
    num_workers_prestart: int = 2           # warm pool per node
    worker_start_timeout_s: float = 60.0
    max_workers_per_node: int = 64

    # --- scheduling ---
    scheduler_policy: str = "hybrid"        # hybrid | spread | random
    lease_timeout_s: float = 30.0
    infeasible_wait_window_s: float = 10.0  # grace for joining/scaled nodes

    # --- object plane ---
    inline_object_max_bytes: int = 100 * 1024   # small objects ride RPC replies
    shm_store_bytes: int = 2 * 1024 * 1024 * 1024
    object_transfer_chunk_bytes: int = 4 * 1024 * 1024
    object_spill_dir: str = ""              # "" = <session>/spill
    stream_backpressure_window: int = 64    # unconsumed items per stream
    stream_producer_inflight: int = 8       # unacked pushes per producer
    # Collective plane: dag allreduce(impl="auto") picks the star reduce
    # for payloads at or below this and the chunked ring above it — the
    # crossover the JAX package measured on shm channels (its
    # ALLREDUCE_BENCH.json: the star wins under ~4 MB because a ring
    # round is 3(N-1) sequential hops and hop latency dominates small
    # frames; above it the root's O(N*S) ingress/egress collapses).
    allreduce_star_max_bytes: int = 4 * 1024 * 1024
    # Collective auto-tuner (dag/tuner.py): a one-shot in-situ
    # micro-bench on each tuning-enabled ring (run lazily at the first
    # collective, cached per ring generation) replaces the static
    # crossover above — impl (star / flat ring / hierarchical) and
    # chunk size are picked per payload band from the measured
    # alpha/beta fit; the static knob stays the fallback for rings
    # that never probed. The probe costs two tiny fused rounds.
    collective_tuner: bool = True
    collective_tuner_probe_bytes: int = 1 << 20   # largest probe round
    collective_tuner_min_chunk_bytes: int = 64 * 1024
    # Topology-aware hierarchical collectives (dag/ring.py
    # HierarchicalReducer): "auto" wires the train gradient sync as a
    # ring-of-rings (per-node shm intra rings, one TCP ring over node
    # leaders, intra broadcast) whenever the worker group spans more
    # than one node with at least one multi-rank node — cross-node
    # wire traffic drops to ~1/ranks-per-node; "flat" keeps the
    # one-level ring regardless of topology.
    collective_hierarchy: str = "auto"
    # Wire codec auto-selection + error-feedback (train/collective.py,
    # dag/tuner.py codec band): allreduce_gradients(codec="auto") picks
    # the cheapest probed codec (int4 < int8 < bf16 < fp32) whose
    # observed ``allreduce_quant_error`` bound stays at or below this —
    # a lossy codec whose bound trips backs off to bf16/fp32 on the
    # next round.
    collective_codec_error_bound: float = 1e-2
    # Payloads below this many bytes always ship fp32 under
    # codec="auto": per-block scale framing plus quant error buy
    # nothing when the whole gradient fits a few channel slots.
    collective_codec_min_bytes: int = 64 * 1024
    # Error-feedback accumulation: each rank carries the quantization
    # residual (sent-minus-shipped, reconstructed from the local codec
    # round-trip — no extra wire) into the next round's gradients, the
    # EF-SGD trick that makes int8/int4 gradient sync convergence-safe
    # (the JAX package's ZERO_BENCH.json, codec_convergence: int4+EF
    # within 1e-3 relative of the fp32 trajectory; no-EF int8 is NOT).
    # With this off, codec="auto" never picks a lossy codec.
    codec_error_feedback: bool = True

    # --- pipeline parallelism (train/pipeline.py) ---
    # Default microbatch schedule for train.Pipeline: "1f1b" keeps
    # in-flight activations at O(stages) with the same bubble as
    # GPipe; "gpipe" is the simple fill/drain reference.
    pipeline_schedule: str = "1f1b"
    # Ship activations/gradients across stage edges as device-path
    # TensorRef handles (runtime/device_store.py: only the handle rides
    # the channel; across processes the tensor is staged through the
    # owner's host memory on the consumer's fetch) instead of
    # host-staged tensors in the channel's frames. The runtime loop
    # frees every ref the moment the consumer materializes it.
    pipeline_device_transport: bool = True
    # TTL backstop on schedule-owned activation refs: a consumer that
    # dies before resolving cannot pin the producer's memory past this
    # bound (the normal path frees refs at materialization). Keep it
    # ABOVE pipeline_step_timeout_s: a ref must outlive any stall the
    # pipeline itself tolerates, or a slow-but-healthy consumer
    # resolves an already-expired tensor.
    pipeline_activation_ttl_s: float = 600.0
    # Bound on one schedule step's MID-step channel waits (recv of a
    # microbatch / backpressured send): a stage dead mid-step surfaces
    # as PeerLostError within this instead of hanging the pipeline.
    # The wait for a NEW step's first microbatch is exempt (driver
    # cadence: eval/checkpoint pauses between steps are healthy); a
    # peer dead at a step boundary is detected by the driver's report
    # read, and Pipeline.teardown() injects STOP directly on
    # inter-stage edges when a dead stage can't relay it.
    pipeline_step_timeout_s: float = 300.0

    # --- rpc ---
    rpc_connect_timeout_s: float = 10.0
    rpc_retry_max_attempts: int = 5
    rpc_retry_backoff_s: float = 0.1
    # Deterministic fault injection, reference: src/ray/rpc/rpc_chaos.h.
    # Format: "Method=max_failures:deadline_ms,Method2=..."
    testing_rpc_failure: str = ""
    # Deterministic fault injection on the compiled-DAG channels (shm
    # rings and TCP edges), the channel-layer sibling of
    # testing_rpc_failure. Comma-separated rules
    # "<op>:<action>:<nth>[:<param>]": op in {write, read}; action in
    # {delay (sleep <param> s before the op), drop (writes: silently
    # discard the frame; reads: raise ChannelTimeout), kill (SIGKILL
    # this process)}; nth = 1-based index of the matching op counted
    # process-wide. See dag/channel.py ChannelChaos.
    testing_channel_failure: str = ""

    # --- paged KV cache (llm/kvcache.py) ---
    # Token-block size of the engine's paged KV cache. The serving
    # default: fixed-size blocks from a preallocated pool, per-request
    # block tables, ref-counted prefix reuse for shared system
    # prompts — tensor-parallel engines included (the pool shards its
    # kv-head dim over the mesh). 0 selects the legacy monolithic slot
    # cache (bucketed doubling growth). The effective size is
    # gcd-adjusted to divide every prefill bucket and max_len.
    kvcache_block_size: int = 16
    # Pool size in blocks (0 = auto: worst case — every slot at
    # max_len — plus one chain of prefix-cache headroom, capped at
    # half the free device memory).
    kvcache_pool_blocks: int = 0
    # Prefix reuse: hash-chained full prompt blocks enter a cached
    # index at request finish; a later request sharing the prefix
    # adopts those blocks ref-counted and prefills only its suffix.
    # Off: blocks free immediately at request finish.
    kvcache_prefix_cache: bool = True
    # Paged decode attention impl: "paged_flash" walks each slot's
    # block table directly in the decode kernel
    # (ops/paged_attention.py — no gathered (slots, max_len) view, no
    # O(slots x max_len x layers) copy per token); "gather"
    # materializes the view per layer (the debug/parity path); "auto"
    # = paged_flash on a CUDA device, gather on the CPU. Engines also
    # take this per-instance via LLMEngine(kv_impl=...).
    paged_attn_impl: str = "auto"

    # --- speculative decoding (llm/spec.py) ---
    # Draft-and-verify generation in the paged engine (speculative
    # sampling, arxiv 2211.17192): a model-free prompt-lookup drafter
    # proposes up to spec_draft_tokens tokens by matching the
    # request's recent suffix against its own prompt+output history;
    # the engine scores all k+1 positions in one batched forward and
    # accepts the longest agreeing prefix (exact greedy match at
    # temperature<=0, rejection sampling otherwise so the output
    # distribution is unchanged). Off by default; engines also take
    # this per-instance via LLMEngine(spec=...).
    spec_decode: bool = False
    # Max draft tokens per verify round (the k in draft-and-verify).
    # Verify widths are padded to a small bucket set derived from
    # this, so distinct accepted lengths share a few shapes.
    spec_draft_tokens: int = 4
    # Longest suffix n-gram the prompt-lookup drafter tries to match
    # (it backs down to 1-grams before giving up).
    spec_ngram_max: int = 3
    # Accept-rate backoff: the drafter tracks acceptance over a
    # sliding window of this many drafted tokens and stops proposing
    # when the windowed accept rate drops below ~25%, re-probing
    # periodically — adversarial low-hit prompts degrade to vanilla
    # decode instead of paying verify overhead forever.
    spec_backoff_window: int = 16

    # --- serve fault tolerance ---
    # Default per-request deadline budget (seconds) when the client
    # sends no X-Request-Deadline header. The budget is spent across
    # queueing, routing, retries, and the replica call; once spent the
    # proxy answers 504 and downstream work is cancelled.
    serve_default_deadline_s: float = 120.0
    # Proxy admission control: requests beyond the deployment's live
    # capacity (running replicas x max_ongoing_requests) wait in a
    # bounded queue; past this depth — or when the predicted queue wait
    # exceeds the request's remaining deadline budget — the proxy sheds
    # with a fast 503 + Retry-After instead of letting the request ride
    # to its full deadline.
    serve_queue_limit: int = 128
    # Budgeted retry policy (route refresh, reroute-on-submit-failure):
    # attempts are jittered-exponential-backoff spaced and always capped
    # by the request's remaining deadline.
    serve_retry_max_attempts: int = 3
    # Replica circuit breaker (caller-side routing table): eject a
    # replica after this many CONSECUTIVE infrastructure failures;
    # half-open recovery probes admit one trial request after the
    # cooldown (ping probes can shortcut or extend it).
    serve_cb_failure_threshold: int = 3
    serve_cb_cooldown_s: float = 2.0
    # Latency ejection: >0 arms it — this many consecutive calls slower
    # than the threshold eject the replica like failures do. 0 = off.
    serve_cb_latency_threshold_s: float = 0.0
    serve_cb_latency_count: int = 3
    # Graceful draining: a DRAINING replica (scale-down / redeploy)
    # finishes its in-flight requests (incl. streams) and accepts no
    # new ones; after this many seconds the controller stops waiting.
    serve_drain_timeout_s: float = 30.0
    # --- SLO-driven replica autoscaling (serve/autoscale.py) ---
    # A deployment opts in with autoscaling_config={"policy": "slo",
    # ...}; the controller then scales it from the health plane's
    # burn_advice (page-tier burn -> scale up; the proxy's
    # shed-while-burning hint is the fast path) instead of the legacy
    # target_ongoing_requests loop. Seconds between burn-advice
    # fetches / per-deployment decision ticks:
    serve_autoscale_interval_s: float = 2.0
    # Minimum seconds between two scale changes of one deployment
    # (hysteresis: a flapping alert cannot thrash replica counts).
    serve_autoscale_cooldown_s: float = 15.0
    # Replicas added per scale-up decision.
    serve_autoscale_step: int = 1
    # Utilization deadband: below low (sustained for the window, and
    # only while no budget is burning) scale down one replica — the
    # victim DRAINS, in-flight streams finish; above high with a
    # warn-tier burn, scale up before the page tier fires. Between
    # the thresholds the target holds.
    serve_autoscale_low_util: float = 0.25
    serve_autoscale_low_util_window_s: float = 30.0
    serve_autoscale_high_util: float = 0.85

    # Deterministic fault injection for the SERVE data path, the
    # serving sibling of testing_rpc_failure / testing_channel_failure
    # (reference: src/ray/rpc/rpc_chaos.h + serve.proto health checks).
    # Comma-separated rules "<site>:<action>:<nth>[:<param>]": site in
    # {proxy (handle -> replica submission), replica (replica -> user
    # code / engine)}; action in {error (raise an injected failure),
    # delay (sleep <param> s), drop (replica only: never respond — the
    # caller's deadline fires), kill (SIGKILL this process)}; nth =
    # 1-based index of the matching site's requests, counted
    # process-wide. See serve/chaos.py ServeChaos.
    testing_serve_failure: str = ""

    # --- tasks / actors ---
    default_max_task_retries: int = 3
    # how long an actor's __init__ may run (model-loading actors — an
    # LLM replica binding hundreds of MB of weights over a slow device
    # link — legitimately take minutes)
    actor_init_timeout_s: float = 600.0

    # --- memory monitor (0 = disabled) ---
    memory_monitor_interval_s: float = 0.0
    memory_usage_threshold: float = 0.95    # node-wide usage fraction
    worker_rss_limit_bytes: int = 0         # per-worker soft cap (monitor)
    worker_cgroup_memory_bytes: int = 0     # per-worker KERNEL cap (cgroup)

    # --- observability ---
    event_buffer_size: int = 65536
    # Collective tracing (dag/ring.py): span granularity recorded into
    # the "collective" event category. "off" = no timing at all (hot
    # path untouched); "round" = one span + recv-wait/straggler
    # attribution per collective round (default — a round moves MBs,
    # the extra clock reads are noise); "chunk" = additionally one
    # span per chunk send / recv-wait / reduce (post-mortem depth;
    # bounded by the category's event-buffer sub-budget).
    collective_trace_level: str = "round"
    # Flight recorder: per-rank ring of the last K rounds' timing
    # records, dumped to JSON when a collective raises (peer death,
    # ERROR relay, protocol desync) — the dump path is attached to the
    # raised exception. 0 disables.
    collective_flight_rounds: int = 8
    collective_flight_dir: str = ""         # "" = <tmp>/ray_tpu_flight
    metrics_export_interval_s: float = 5.0
    metrics_port: int = -1                  # -1 off, 0 ephemeral, >0 fixed
    log_dir: str = ""                       # "" = workers inherit stdio
    # Request tracing (util/tracing.py request layer): tail-based
    # sampling at the proxy when a request FINISHES. Error /
    # deadline-exceeded traces and traces slower than
    # trace_slow_threshold_s are always kept; healthy ones keep with
    # this probability (deterministic on the trace id). 1.0 = keep
    # everything (small clusters), 0.0 = only errors/slow survive
    # (high-QPS production). Segment spans are budget-capped in the
    # "request" event category either way; sampling gates which traces
    # SURFACE (root span recorded), not which record.
    trace_sample_rate: float = 1.0
    trace_slow_threshold_s: float = 1.0
    # Device-plane observability (util/devmon.py; master switch is the
    # RAY_TPU_DEVMON env var, read at process start like the tracing
    # flags). A function compiled >= devmon_recompile_threshold times
    # within devmon_recompile_window_s seconds flags a recompile STORM
    # (xla_recompile_storms_total counter + a log naming the function)
    # — the silent mid-serving recompile loop no host profiler can
    # see. 0 disables the gate.
    # The default sits above the engine's LEGITIMATE warmup variants
    # (one compile per prefill bucket; log2(steps_per_sync)+1 decode
    # block variants x2 filter modes) so healthy cold starts don't
    # flag; a real storm — an unbucketed shape reaching a jit boundary
    # on the request path — blows past it within a few requests.
    devmon_recompile_threshold: int = 10
    devmon_recompile_window_s: float = 60.0
    # HBM snapshot cadence (per-device used/limit/peak gauges + the
    # "device" events behind `/devices` and `ray-tpu devices`), and
    # the trailing horizon the device_duty_cycle gauge integrates
    # device-compute windows over.
    devmon_hbm_interval_s: float = 5.0
    devmon_duty_horizon_s: float = 30.0
    # Goodput ledger (util/goodput.py): per-rank, per-step wall-time
    # anatomy (compute / comm_exposed / bubble / ckpt_stall / compile
    # / idle, summing exactly to step wall). "off" = every clock read
    # removed (same discipline as collective_trace_level); "step" =
    # one row per training step (default — a handful of perf_counter
    # reads per step is noise against a step that moves MBs).
    goodput_level: str = "step"
    # Online straggler detection (train controller): robust z-score a
    # rank's p50 (compute - comm_exposed) must clear against the
    # ring's median/MAD before it is named in a "goodput"/"straggler"
    # event + the goodput_straggler_rank gauge, and the rolling
    # per-rank step window the p50s are taken over.
    goodput_straggler_z: float = 6.0
    goodput_straggler_window_steps: int = 32
    # Hang & desync forensics (util/forensics.py): the bounded
    # per-rank collective ledger (group/seq/kind/codec/options-sig,
    # enqueued|in_flight|done|aborted). On by default — recording is
    # two dict writes per round riding the clock reads the round-level
    # trace already pays (the JAX package's FORENSICS_BENCH.json: within
    # noise). Off = no ledger, no watchdog signal, autopsy bundles carry
    # no ledgers.
    forensics_ledger: bool = True
    forensics_ledger_size: int = 256
    # Controller watchdog: a collective in_flight on any rank past
    # this deadline (or a persistent straggler signal) triggers the
    # cross-rank ledger audit — pull every rank's ledger, diff, name
    # the culprit as a collective_stall/collective_desync event + the
    # forensics_stall_rank health sentinel + a postmortem bundle.
    forensics_stall_timeout_s: float = 60.0
    # Opt-in pre-flight desync guard (train/collective.py): "step"
    # agrees the options-signature across ranks once per train step,
    # "round" before every collective — turning a codec/options
    # desync into a typed, named CollectiveDesyncError instead of a
    # ring hang. Costs one rendezvous-actor round trip per check, so
    # it is off by default (a debugging lever, per PERF_JAX.md's
    # runbook).
    forensics_verify_level: str = "off"
    # Where postmortem-<step>.json bundles land
    # ("" = <tmp>/ray_tpu_torch_forensics).
    forensics_dir: str = ""

    # --- durable checkpoint plane (train/ckptio.py) ---
    # How long the rank-0 commit coordinator waits for every rank's
    # shard (payload + per-shard meta) of one step to become visible
    # in storage before abandoning the commit. An abandoned save is
    # INVISIBLE to restore by construction (no manifest = no
    # checkpoint) — the previous committed step keeps resolving.
    ckpt_commit_timeout_s: float = 60.0
    # Verify each shard's recorded content hash at restore. A corrupt
    # shard then fails loudly (and the controller's auto-resume falls
    # back to the previous complete checkpoint) instead of loading
    # silently-wrong optimizer state. Off trades the sha256 pass for
    # restore speed on storage you trust end-to-end.
    ckpt_verify_hash: bool = True
    # Host staging slots for the async writer's double buffering: the
    # step path only pays the snapshot copy while a free slot exists;
    # when the background writer falls this many saves behind, save()
    # blocks until a slot frees (backpressure, never silent drops).
    ckpt_stage_buffers: int = 2
    # Deterministic fault injection for the CHECKPOINT plane, sibling
    # of testing_channel_failure / testing_serve_failure. Rules
    # "<site>:<action>:<nth>[:<param>]" (comma-separated): site in
    # {shard (the per-rank payload write), commit (the manifest
    # marker write)}; action in {kill (SIGKILL this process — a
    # deterministic crash mid-save / mid-commit), error, delay
    # (sleep <param> s), torn (corrupt the write: truncated payload /
    # truncated manifest reaches the FINAL name, exercising hash and
    # parse validation)}; nth = 1-based per-site op index counted
    # process-wide. See train/ckptio.py.
    testing_ckpt_failure: str = ""

    # --- preemption-aware shutdown (runtime/worker.py + ckptio) ---
    # Grace window a worker gets on SIGTERM before the exit backstop
    # fires: preemption hooks run inside it — finish flushing the
    # in-flight async checkpoint save (+ rank-0 manifest commit),
    # mirror the ZeRO shard to the ring successor, drain metrics.
    # TPU preemption delivers SIGTERM with advance notice; this is
    # how much of that notice the worker spends saving work instead
    # of dying with it. 0 restores die-now semantics.
    preempt_grace_s: float = 5.0

    # --- cluster health plane (util/timeseries.py + util/health.py) ---
    # Master runtime off-switch for the head-side metrics time-series
    # store + SLO engine (the RAY_TPU_HEALTH env var is the process-
    # start master switch, same pattern as RAY_TPU_DEVMON). Off: no
    # store, no evaluation loop, report_metrics keeps only the latest
    # snapshot as before.
    health_enabled: bool = True
    # Raw-resolution window width and retention. Rollups derive from
    # these (timeseries.RESOLUTION_SCALES): 10s raw for 15 min, 1-min
    # for 2 h, 10-min for 24 h by default.
    health_window_s: float = 10.0
    health_retention_s: float = 900.0
    # Memory bound: max labelled series tracked; past it the least-
    # recently-updated series is evicted (health_series_dropped_total).
    health_max_series: int = 4096
    # Pinned regression baselines for the sentinels ("" = look for
    # HEALTH_BASELINE.json in the working directory).
    health_baseline_path: str = ""
    # SLO engine (Google-SRE multi-window multi-burn-rate): the "page"
    # tier fires when the error-budget burn rate exceeds slo_fast_burn
    # over BOTH fast windows ("short,long" seconds — short detects
    # fast, long stops one bad scrape from paging); the "warn" tier
    # uses the slow windows at slo_slow_burn. Defaults scale the SRE
    # workbook's 5m/1h page pair down to the store's 15-min raw
    # retention.
    slo_eval_interval_s: float = 10.0
    slo_fast_burn: float = 14.4
    slo_fast_windows_s: str = "60,300"
    slo_slow_burn: float = 3.0
    slo_slow_windows_s: str = "300,1800"
    # Derived default objectives (per-deployment ingress latency +
    # availability, collective straggler, HBM headroom) and their
    # shared latency bound / target. False = only objectives user code
    # registered via health.add_objective().
    slo_default_objectives: bool = True
    slo_latency_threshold_s: float = 1.0
    slo_target: float = 0.99

    # --- control-plane fault tolerance ---
    # Directory for durable control tables (GCS-persistence analog,
    # runtime/persistence.py). "" = in-memory only.
    control_persist_dir: str = ""

    extra: dict = field(default_factory=dict)

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Defaults <- RAY_TPU_* environment <- explicit overrides.
        Explicit kwargs always beat the environment, even when their value
        equals the class default."""
        kw = {}
        for f in fields(cls):
            if f.name == "extra":
                continue
            kw[f.name] = _env(f.name, f.default, _FIELD_TYPES.get(f.name, str))
        kw.update(overrides)
        return cls(**kw)

    def update(self, overrides: dict[str, Any] | None) -> "Config":
        for k, v in (overrides or {}).items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self


# dataclasses.fields gives string annotations under future-annotations;
# resolve each field's concrete type once so _env can coerce env overrides.
_TYPES = {"str": str, "int": int, "float": float, "bool": bool,
          "dict": dict, "list": list}
_FIELD_TYPES = {
    f.name: _TYPES.get(str(f.type).replace("builtins.", ""), str)
    for f in fields(Config)
}


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.from_env()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
