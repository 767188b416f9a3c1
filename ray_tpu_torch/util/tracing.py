"""Distributed task spans: submit edges + exec spans -> chrome trace.

The port's copy of ``ray_tpu/util/tracing.py``, on the port's own
``util/events.py`` and ``config.py``: the task spans of its runtime and
the request spans of its ``LLMEngine`` record through it.

The framework's analog of the reference's two tracing layers (reference:
util/tracing/tracing_helper.py — OTel spans propagated caller->worker
around submit/execute; core_worker/profile_event.h + task_event_buffer.h
— per-task profile events batched to the GCS and surfaced as
ray.timeline(), _private/state.py:1010).

Design: every process records into its local ring buffer (util/events):
  - the SUBMITTER records a "submit" edge {child, parent} where parent is
    the task this process is currently executing (contextvar), giving the
    caller->callee tree without widening any RPC payload;
  - the EXECUTOR records an "exec" span {task, name, ts, dur}.
``ray_tpu_torch.timeline(all_nodes=True)`` collects buffers cluster-wide
(control -> agents -> workers) and ``chrome_path=`` writes a
chrome://tracing / Perfetto-loadable JSON file.

RAY_TPU_TRACE_TASKS=0 disables the submit->exec flow EDGES only; exec
records double as always-on task events (`ray-tpu list tasks`) and need
RAY_TPU_TASK_EVENTS=0 as well to stop entirely (recording costs
~1us/event).

REQUEST TRACING (third layer; reference: the OTel trace context
util/tracing/tracing_helper.py propagates caller->worker): one W3C-style
trace context — 128-bit trace id + 64-bit span id, carried in a
contextvar and minted/parsed at the serve proxy's HTTP boundary from the
``traceparent`` header — follows ONE request proxy -> handle -> replica
-> engine, and rides task specs so nested tasks join the trace. Each hop
records segment spans into the budget-capped "request" event category;
the PROXY makes a tail-based sampling decision when the request
finishes: error / deadline-exceeded / slow-over-threshold traces are
always kept, healthy ones keep with probability
``Config.trace_sample_rate`` (deterministic on the trace id, so the
decision is reproducible anywhere). "Kept" means the root span is
recorded — `ray-tpu trace` / the dashboard /traces page list only
traces with a root; unkept traces' segment spans age out of the bounded
buffers without ever surfacing. RAY_TPU_TRACE_REQUESTS=0 disables the
layer entirely (nothing minted, every record path no-ops).
"""

from __future__ import annotations

import contextvars
import json
import os
import re
import time
from typing import List, Optional

from ray_tpu_torch.util import events

_OFF = ("0", "false", "off")
_ENABLED = os.environ.get("RAY_TPU_TRACE_TASKS", "1").lower() not in _OFF
# Task events (exec records: name/start/duration/error) are ALWAYS-ON
# independently of the tracing flag (reference: GCS task events,
# src/ray/gcs/gcs_task_manager.h, feed `ray list tasks` regardless of
# OTel tracing) — `ray-tpu list tasks` must not come back empty just
# because span tracing was off when the work ran. Disable explicitly
# with RAY_TPU_TASK_EVENTS=0; recording costs ~1us/event.
_EVENTS = os.environ.get("RAY_TPU_TASK_EVENTS", "1").lower() not in _OFF

# hex id of the task/actor-call this process is currently executing
current_span: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_span", default="")


def enabled() -> bool:
    return _ENABLED


def record_submit(child_hex: str, kind: str, name: str) -> None:
    """Called where a task/actor call is created (core.py submit paths)."""
    if not _ENABLED:
        return
    events.record("trace", "submit", child=child_hex, kind=kind,
                  target=name, parent=current_span.get())


def record_exec(task_hex: str, kind: str, name: str,
                t0: float, t1: float, *, error: bool = False,
                batch: int = 1, trace: str = "") -> None:
    """Called by the worker executor around user code. Doubles as the
    always-on task-event record: recorded when EITHER flag is on — both
    RAY_TPU_TRACE_TASKS=0 and RAY_TPU_TASK_EVENTS=0 are needed to stop
    it (only the submit->exec flow EDGES are tracing-only). ``trace``
    is the REQUEST trace id the submitter stamped into the task spec
    (runtime/core.py) — nested tasks join their request's trace."""
    if not (_ENABLED or _EVENTS):
        return
    events.record("trace", "exec", ph="X", task=task_hex, kind=kind,
                  target=name, ts=t0, dur=t1 - t0, error=error,
                  batch=batch, pid=os.getpid(),
                  **({"trace": trace} if trace else {}))


# --- request tracing (W3C-style trace context) -------------------------

_REQ = os.environ.get("RAY_TPU_TRACE_REQUESTS", "1").lower() not in _OFF

# (trace_id 32-hex, span_id 16-hex) of the request the current code is
# serving; None outside any traced request. The serve replica binds it
# before user code, so the engine and nested task submissions inherit.
current_request: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_request", default=None)

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext(tuple):
    """(trace_id, span_id) with named access; immutable and picklable."""
    __slots__ = ()

    def __new__(cls, trace_id: str, span_id: str):
        return tuple.__new__(cls, (trace_id, span_id))

    def __getnewargs__(self):
        return (self[0], self[1])

    @property
    def trace_id(self) -> str:
        return self[0]

    @property
    def span_id(self) -> str:
        return self[1]


def requests_enabled() -> bool:
    return _REQ


def new_span_id() -> str:
    return os.urandom(8).hex()


def mint_context() -> Optional[TraceContext]:
    """Fresh root context (the proxy calls this at ingress when the
    client sent no traceparent); None when request tracing is off."""
    if not _REQ:
        return None
    return TraceContext(os.urandom(16).hex(), new_span_id())


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """W3C traceparent ``00-<32hex trace>-<16hex span>-<2hex flags>``;
    None for anything malformed or all-zero ids (per spec those are
    invalid and a fresh trace is minted instead)."""
    if not header or not _REQ:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def set_request_context(ctx: Optional[TraceContext]):
    """Bind the trace context for the current execution context;
    returns the reset token."""
    return current_request.set(ctx)


def reset_request_context(token) -> None:
    try:
        current_request.reset(token)
    except ValueError:
        # async-generator finally blocks can run in a different task
        # context than the set (streaming drivers) — clearing suffices
        current_request.set(None)


def current_context() -> Optional[TraceContext]:
    return current_request.get()


def current_trace_id() -> str:
    """Trace id of the active request ("" outside one) — histogram
    exemplars and exec-span stamping read this."""
    ctx = current_request.get()
    return ctx.trace_id if ctx is not None else ""


def wire_context() -> Optional[str]:
    """The ambient context as a traceparent string for RPC metadata /
    task specs (None outside a traced request)."""
    ctx = current_request.get()
    return format_traceparent(ctx) if ctx is not None else None


def record_request_span(component: str, seg: str, ctx: TraceContext,
                        parent_id: str, t0: float, t1: float, *,
                        span_id: Optional[str] = None,
                        error: bool = False, **attrs) -> str:
    """One segment span of a request at one hop. ``ctx`` names the
    trace; ``parent_id`` is the upstream hop's span id ("" for the
    root). Returns the span id so a caller can parent further spans to
    this one. Timestamps are wall-clock (time.time() base) like every
    other event — collect_timeline's clock offsets correct them."""
    if not _REQ:
        return ""
    sid = span_id or new_span_id()
    events.record("request", "span", trace=ctx.trace_id, span=sid,
                  parent=parent_id, component=component, seg=seg,
                  ts=t0, dur=t1 - t0, error=error, pid=os.getpid(),
                  **attrs)
    return sid


def record_batch_span(component: str, seg: str, links: List[str],
                      t0: float, t1: float, **attrs) -> None:
    """One span covering a BATCHED execution (e.g. an engine decode
    block), linked to every member trace id instead of belonging to one
    trace — the waterfall of any member pulls it in via ``links``."""
    if not _REQ or not links:
        return
    events.record("request", "batch", span=new_span_id(), links=links,
                  component=component, seg=seg, ts=t0, dur=t1 - t0,
                  pid=os.getpid(), **attrs)


def sample_keep(trace_id: str, *, error: bool = False,
                slow: bool = False, rate: Optional[float] = None) -> bool:
    """Tail-based sampling decision for a finished trace: errors,
    deadline violations, and slow requests are ALWAYS kept; healthy
    traces keep deterministically by hashing the trace id against
    ``rate`` (Config.trace_sample_rate when not given) — the same trace
    id always gets the same verdict, on any node."""
    if error or slow:
        return True
    if rate is None:
        from ray_tpu_torch.config import get_config
        rate = float(getattr(get_config(), "trace_sample_rate", 1.0))
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        frac = int(trace_id[-8:], 16) / float(0xFFFFFFFF)
    except ValueError:
        return True
    return frac < rate


def finish_request(ctx: TraceContext, t0: float, t1: float, *,
                   status: str = "ok", error: bool = False,
                   **attrs) -> bool:
    """The request's TAIL (proxy-side): decide keep/drop and, when
    kept, record the ROOT span that makes the trace visible to the
    /traces surfaces. Segment spans recorded along the way are not
    retracted on drop — they age out of the bounded "request" buffers
    without a root to surface them. Returns the keep decision."""
    if not _REQ:
        return False
    from ray_tpu_torch.config import get_config
    cfg = get_config()
    dur = t1 - t0
    slow = dur > float(getattr(cfg, "trace_slow_threshold_s", 1.0))
    err = error or status in ("error", "deadline")
    if not sample_keep(ctx.trace_id, error=err, slow=slow):
        return False
    reason = ("error" if err else "slow" if slow else "sampled")
    events.record("request", "span", trace=ctx.trace_id,
                  span=ctx.span_id, parent="", component="proxy",
                  seg="request", root=True, status=status, keep=reason,
                  ts=t0, dur=dur, error=err, pid=os.getpid(), **attrs)
    return True


def filter_trace(evs: List[dict], trace_id: str) -> List[dict]:
    """Events belonging to ONE trace: request/exec spans stamped with
    the trace id, batch spans LINKED to it, and — when the trace
    contains train-step spans tagged with a collective step — the
    collective rounds AND pipeline stage spans of those steps
    (TrainContext.collective_step tags let a train-step trace reference
    its ring rounds; a pipeline step bumps the same counter). A step
    span that also carries its ring ``group`` id matches only that
    group's rounds (prefix match: hierarchical sub-rings derive
    ``<group>.n<i>`` / ``<group>.x`` names) — two jobs that happen to
    share a step index must not cross-wire their waterfalls; pipeline
    spans match the step span's ``pgroup`` tag the same way (per-stage
    ZeRO rings derive ``<pgroup>.z<k>`` collective group names, so the
    pgroup prefix also pulls those rounds in); group-less step spans
    fall back to step-only matching."""
    step_keys = [(e.get("step"), e.get("group") or None,
                  e.get("pgroup") or None, e.get("pstep"))
                 for e in evs
                 if e.get("cat") == "request"
                 and e.get("trace") == trace_id
                 and e.get("step") is not None]
    out = []
    for e in evs:
        cat = e.get("cat")
        if e.get("trace") == trace_id:
            out.append(e)
        elif cat == "request" and trace_id in (e.get("links") or ()):
            out.append(e)
        elif cat == "collective" and step_keys:
            grp = str(e.get("group") or "")
            if any(e.get("step") == s
                   and ((g is None and pg is None)
                        or (g is not None
                            and (grp == g or grp.startswith(f"{g}.")))
                        or (pg is not None
                            and (grp == pg or grp.startswith(f"{pg}."))))
                   for s, g, pg, _ps in step_keys):
                out.append(e)
        elif cat == "pipeline" and step_keys:
            grp = str(e.get("group") or "")
            # pgroup scoping mirrors the collective group rule: a step
            # span that names its pipeline matches only that group —
            # and matches by the step span's PSTEP tag (the pipeline's
            # own counter, immune to auxiliary-collective bumps of
            # collective_step); a fully group-less step (no ring AND
            # no pipeline) falls back to step-only matching
            if any(((pg is not None and grp == pg
                     and e.get("step") == (ps if ps is not None else s))
                    or (pg is None and g is None
                        and e.get("step") == s))
                   for s, g, pg, ps in step_keys):
                out.append(e)
    return out


_COLLECTIVE_ROUND_ARGS = ("op", "codec", "cid", "step", "bytes",
                          "send_s", "recv_wait_s", "headers_s",
                          "straggler", "error", "group")


_REQUEST_SPAN_ARGS = ("trace", "span", "parent", "seg", "status",
                      "keep", "deployment", "method", "http_status",
                      "error", "links", "step", "block", "slots",
                      "tokens", "attempt", "replica", "kv_bytes")


_DEVICE_SPAN_ARGS = ("fn", "cache_hit", "trace", "seg", "device",
                     "count", "window_s")


_PIPE_SPAN_ARGS = ("stage", "chain", "mb", "kind", "step", "group",
                   "wait_s", "bubble_s", "update_s")


_HEALTH_ARGS = ("objective", "tier", "state", "kind", "metric",
                "burn_short", "burn_long", "deployment", "trace",
                "sentinel", "stat", "live", "baseline", "tolerance")

_SERVE_ARGS = ("deployment", "direction", "reason", "target",
               "prev_target", "running", "ongoing", "util")


def to_chrome(evs: List[dict], path: Optional[str] = None,
              clock_offsets: Optional[dict] = None,
              trace_id: Optional[str] = None) -> List[dict]:
    """Convert collected events into chrome-trace records. Exec spans
    become "X" (complete) events laned by (node, pid); submit edges
    become flow events when both ends are present. Collective spans
    (dag/ring.py "collective" category) become per-rank ring lanes
    (``tid=ring:r<rank>`` under the node's pid group) with flow edges
    from each rank's round span to its ring-successor's — the wire the
    data actually took. Request spans (the "request" category) become
    per-component lanes (``tid=req:<component>``) with parent->child
    flow edges — the cross-process waterfall of one served request.
    Device spans (the "device" category, util/devmon.py) become a
    ``dev:compile`` lane (XLA compile spans + recompile-storm
    instants) and per-device ``dev:<device>`` duty-window lanes; a
    compile span stamped with a request's trace id rides that
    request's filtered waterfall.

    ``trace_id`` filters the input to ONE request trace before
    rendering (filter_trace: the trace's own spans, batch spans linked
    to it, and — for train-step traces — the collective rounds its
    step tags name); `ray-tpu trace <id>` rides this instead of
    forking the renderer.

    ``clock_offsets`` maps node-id hex -> estimated wall-clock offset
    vs the collecting head (seconds; see control.collect_timeline).
    Each event's timestamp is corrected by its node's offset before
    laning — without this, merged cross-node lanes are skewed by clock
    drift and flow arrows can point backwards in time. Events without
    a node tag (the head's own) are taken as offset 0."""
    if trace_id is not None:
        evs = filter_trace(evs, trace_id)
    out = []
    offs = {str(k): float(v)
            for k, v in (clock_offsets or {}).items()}

    def adj_us(e, ts: float) -> float:
        return (ts - offs.get(str(e.get("node", "")), 0.0)) * 1e6

    starts = {}        # task hex -> (ts_us, pid, tid)
    req_spans = {}     # request span id -> (start_us, end_us, pid, tid)
    req_parents = []   # (child span id, parent span id)
    # (group, chain, step, mb, kind) -> {stage: (s_us, e_us, pid, tid)}
    pipe_ops: dict = {}
    # (group, cid) -> {rank: (start_us, end_us, pid, tid, size)}
    rounds: dict = {}
    for e in evs:
        cat = e.get("cat")
        node = str(e.get("node", ""))[:8]
        node_pid = f"node:{node}" if node else "node"
        if cat == "trace" and e.get("name") == "exec":
            ts_us = adj_us(e, e["ts"])
            args = {"task": e.get("task", ""),
                    "batch": e.get("batch", 1),
                    "error": e.get("error", False)}
            if e.get("trace"):
                args["trace"] = e["trace"]
            rec = {"ph": "X", "cat": e.get("kind", "task"),
                   "name": e.get("target", "?"),
                   "ts": ts_us, "dur": e.get("dur", 0.0) * 1e6,
                   "pid": node_pid,
                   "tid": f"worker:{e.get('pid', 0)}",
                   "args": args}
            out.append(rec)
            if e.get("task"):  # "" (no return oids) is not an identity
                starts[e["task"]] = (ts_us, rec["pid"], rec["tid"])
        elif cat == "request":
            ts_us = adj_us(e, e["ts"])
            dur_us = e.get("dur", 0.0) * 1e6
            comp = e.get("component", "?")
            tid = f"req:{comp}"
            rec = {"ph": "X", "cat": "request",
                   "name": f"{comp}:{e.get('seg', '?')}",
                   "ts": ts_us, "dur": dur_us,
                   "pid": node_pid, "tid": tid,
                   "args": {k: e[k] for k in _REQUEST_SPAN_ARGS
                            if e.get(k) is not None}}
            out.append(rec)
            if e.get("span"):
                req_spans[e["span"]] = (ts_us, ts_us + dur_us,
                                        node_pid, tid)
                if e.get("parent"):
                    req_parents.append((e["span"], e["parent"]))
        elif cat == "pipeline":
            # pipeline-parallel stage lanes (dag/runtime.py
            # pipe_exec_loop): one pipe:stage<k> lane per stage actor
            # with per-microbatch F/B op spans and per-step bubble
            # spans; forward flow edges stage p -> p+1 (and gradient
            # edges p+1 -> p) show each microbatch's path through the
            # pipeline
            ts_us = adj_us(e, e["ts"])
            dur_us = e.get("dur", 0.0) * 1e6
            k = e.get("stage", "?")
            ch = e.get("chain", 0)
            tid = f"pipe:stage{k}" + (f".{ch}" if ch else "")
            if e.get("name") == "op":
                rec = {"ph": "X", "cat": "pipeline",
                       "name": f"{e.get('kind', '?')}{e.get('mb', '?')}",
                       "ts": ts_us, "dur": dur_us,
                       "pid": node_pid, "tid": tid,
                       "args": {a: e[a] for a in _PIPE_SPAN_ARGS
                                if e.get(a) is not None}}
                out.append(rec)
                key = (e.get("group", ""), ch, e.get("step"),
                       e.get("mb"), e.get("kind"))
                pipe_ops.setdefault(key, {})[e.get("stage")] = (
                    ts_us, ts_us + dur_us, node_pid, tid)
            else:               # per-step span
                out.append({"ph": "X", "cat": "pipeline",
                            "name": f"step{e.get('step', '?')}",
                            "ts": ts_us, "dur": dur_us,
                            "pid": node_pid, "tid": tid,
                            "args": {a: e[a] for a in _PIPE_SPAN_ARGS
                                     if e.get(a) is not None}})
        elif cat in ("device", "device_window"):
            # accelerator-plane lanes (util/devmon.py): XLA compile
            # spans on a dev:compile lane (a traced request's compile
            # rides its waterfall — "slow because it compiled"),
            # device-compute duty windows (their own budget category)
            # on a per-device lane, and recompile-storm flags as
            # instants on the compile lane. hbm snapshots are gauges,
            # not spans — skipped here.
            ts_us = adj_us(e, e["ts"])
            name = e.get("name")
            if name == "compile":
                out.append({"ph": "X", "cat": "device",
                            "name": f"xla:{e.get('fn', '?')}",
                            "ts": ts_us, "dur": e.get("dur", 0.0) * 1e6,
                            "pid": node_pid, "tid": "dev:compile",
                            "args": {k: e[k] for k in _DEVICE_SPAN_ARGS
                                     if e.get(k) is not None}})
            elif name == "window":
                out.append({"ph": "X", "cat": "device",
                            "name": e.get("seg", "device"),
                            "ts": ts_us, "dur": e.get("dur", 0.0) * 1e6,
                            "pid": node_pid,
                            "tid": f"dev:{e.get('device', '0')}",
                            "args": {k: e[k] for k in _DEVICE_SPAN_ARGS
                                     if e.get(k) is not None}})
            elif name == "recompile_storm":
                out.append({"ph": "I", "cat": "device",
                            "name": f"storm:{e.get('fn', '?')}",
                            "ts": ts_us, "s": "p",
                            "pid": node_pid, "tid": "dev:compile",
                            "args": {k: e[k] for k in _DEVICE_SPAN_ARGS
                                     if e.get(k) is not None}})
        elif cat == "health":
            # SLO alert / sentinel transitions (util/health.py) as
            # instants on a "health" lane — a page-tier firing sits in
            # the same timeline as the traces that explain it (its
            # exemplar trace id is in args; `ray-tpu trace <id>` opens
            # the offending request's waterfall)
            which = (e.get("objective") or e.get("sentinel") or "?")
            out.append({"ph": "I", "cat": "health",
                        "name": f"{e.get('tier', e.get('name', '?'))}:"
                                f"{which}:{e.get('state', '?')}",
                        "ts": adj_us(e, e["ts"]), "s": "g",
                        "pid": node_pid, "tid": "health",
                        "args": {k: e[k] for k in _HEALTH_ARGS
                                 if e.get(k) is not None}})
        elif cat == "serve":
            # autoscale actuation instants (serve/autoscale.py) on a
            # "serve" lane — a scale-up sits in the same timeline as
            # the page-tier alert (health lane) that triggered it
            out.append({"ph": "I", "cat": "serve",
                        "name": f"autoscale:{e.get('deployment', '?')}"
                                f":{e.get('direction', '?')}"
                                f"->{e.get('target', '?')}",
                        "ts": adj_us(e, e["ts"]), "s": "g",
                        "pid": node_pid, "tid": "serve",
                        "args": {k: e[k] for k in _SERVE_ARGS
                                 if e.get(k) is not None}})
        elif cat == "collective":
            ts_us = adj_us(e, e["ts"])
            dur_us = e.get("dur", 0.0) * 1e6
            tid = f"ring:r{e.get('rank', '?')}"
            if e.get("name") == "round":
                rec = {"ph": "X", "cat": "collective",
                       "name": e.get("kind", "round"),
                       "ts": ts_us, "dur": dur_us,
                       "pid": node_pid, "tid": tid,
                       "args": {k: e[k] for k in _COLLECTIVE_ROUND_ARGS
                                if e.get(k) is not None}}
                out.append(rec)
                key = (e.get("group", ""), e.get("cid"))
                rounds.setdefault(key, {})[e.get("rank")] = (
                    ts_us, ts_us + dur_us, node_pid, tid,
                    int(e.get("size") or 0))
            else:              # chunk-level span (send/recv)
                out.append({"ph": "X", "cat": "collective",
                            "name": f"{e.get('phase', '?')}:"
                                    f"{e.get('name')}",
                            "ts": ts_us, "dur": dur_us,
                            "pid": node_pid, "tid": tid,
                            "args": {"seg": e.get("seg"),
                                     "bytes": e.get("bytes"),
                                     "cid": e.get("cid")}})
    flow = 0
    for e in evs:
        if e.get("cat") != "trace" or e.get("name") != "submit":
            continue
        if not e.get("child") or not e.get("parent"):
            continue  # root tasks (parent "") draw no flow arrow
        child = starts.get(e["child"])
        parent = starts.get(e["parent"])
        if child is None or parent is None:
            continue
        flow += 1
        out.append({"ph": "s", "id": flow, "cat": "flow", "name": "spawn",
                    "ts": parent[0], "pid": parent[1], "tid": parent[2]})
        out.append({"ph": "f", "id": flow, "cat": "flow", "name": "spawn",
                    "ts": child[0], "pid": child[1], "tid": child[2],
                    "bp": "e"})
    # ring flow edges: rank r's round feeds rank (r+1)%N's — drawn
    # from the producer's round START (first chunk leaves immediately)
    # to the consumer's round END (its last frame arrives last). With
    # clock-corrected lanes the arrow can never run backwards: the
    # consumer cannot finish before the producer started feeding it.
    for lanes in rounds.values():
        for rank, (s_us, _e_us, pid, tid, size) in lanes.items():
            if not isinstance(rank, int) or size < 2:
                continue
            nxt = lanes.get((rank + 1) % size)
            if nxt is None:
                continue
            flow += 1
            out.append({"ph": "s", "id": flow, "cat": "flow",
                        "name": "ring", "ts": s_us,
                        "pid": pid, "tid": tid})
            out.append({"ph": "f", "id": flow, "cat": "flow",
                        "name": "ring", "ts": nxt[1],
                        "pid": nxt[2], "tid": nxt[3], "bp": "e"})
    # request flow edges: parent hop -> child hop (proxy -> handle ->
    # replica -> engine), drawn parent-span START -> child-span END.
    # Same reasoning as the ring edges: a child segment cannot FINISH
    # before the hop that dispatched it started, so with clock-corrected
    # lanes the arrow can never run backwards even when offset
    # estimation error exceeds the (sub-ms) hop gap.
    for child_sid, parent_sid in req_parents:
        parent = req_spans.get(parent_sid)
        child = req_spans.get(child_sid)
        if parent is None or child is None:
            continue
        flow += 1
        out.append({"ph": "s", "id": flow, "cat": "flow",
                    "name": "request", "ts": parent[0],
                    "pid": parent[2], "tid": parent[3]})
        out.append({"ph": "f", "id": flow, "cat": "flow",
                    "name": "request", "ts": max(child[1], parent[0]),
                    "pid": child[2], "tid": child[3], "bp": "e"})
    # pipeline flow edges: each microbatch's forward op at stage p
    # feeds its op at stage p+1 (gradients: p+1 feeds p). Drawn
    # producer-start -> consumer-end, clamped forward like the request
    # edges — a consumer cannot finish before its producer started, so
    # under clock correction the arrows never run backwards.
    for (_g, _c, _s, _mb, kind), lanes in pipe_ops.items():
        for stage, (s_us, _e_us, pid, tid) in lanes.items():
            if not isinstance(stage, int):
                continue
            nxt = lanes.get(stage + 1 if kind == "F" else stage - 1)
            if nxt is None:
                continue
            flow += 1
            out.append({"ph": "s", "id": flow, "cat": "flow",
                        "name": "pipe", "ts": s_us,
                        "pid": pid, "tid": tid})
            out.append({"ph": "f", "id": flow, "cat": "flow",
                        "name": "pipe", "ts": max(nxt[1], s_us),
                        "pid": nxt[2], "tid": nxt[3], "bp": "e"})
    if path is not None:
        with open(path, "w") as f:
            json.dump({"traceEvents": out,
                       "displayTimeUnit": "ms"}, f)
    return out
