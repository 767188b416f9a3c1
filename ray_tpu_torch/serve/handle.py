"""DeploymentHandle: the caller-side router to a deployment's replicas.

Reference: python/ray/serve/handle.py (DeploymentHandle) +
serve/_private/request_router/pow_2_router.py:27 — replica choice is
power-of-two-choices on in-flight request counts: sample two replicas,
send to the less-loaded one. Counts are tracked caller-side (incremented
on send, decremented when the result object is ready) so the router needs
no synchronous coordination.

Fault tolerance (serve/fault.py): each replica carries a caller-side
CIRCUIT BREAKER — consecutive infrastructure failures (or, when armed,
consecutive slow calls) eject it from pick(); background ping probes
drive half-open recovery, and one trial request closes the breaker.
Submission failures reroute under a BUDGETED retry policy (jittered
backoff, capped by the request's propagated deadline) instead of the
old immediate one-shot, and the discovery loop spends the caller's
deadline instead of stacking fresh 30 s timeouts per attempt.

The port's copy of ``ray_tpu/serve/handle.py``, over the port's runtime
(``_peek_outcome`` reads ``ray_tpu_torch.runtime.core``).
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import api
from ray_tpu_torch.api import ActorHandle
from ray_tpu_torch.runtime.ids import ActorID
from ray_tpu_torch.serve import fault
from ray_tpu_torch.serve.chaos import apply_sync as _chaos_apply, chaos_fire
from ray_tpu_torch.util import tracing

CONTROLLER_NAME = "SERVE_CONTROLLER"
SERVE_NAMESPACE = "serve"

_ROUTE_TTL_S = 0.5


class _HandleRef:
    """Pickle-safe placeholder for a DeploymentHandle inside deployment
    init args (composition): resolved to a live handle in the replica."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name


def _api_loop():
    if api._g.elt is not None:
        return api._g.elt.loop
    return api._g.ctx_loop


class _Router:
    """Per-process routing state for one deployment."""

    def __init__(self, deployment_name: str):
        self.name = deployment_name
        self.replicas: List[bytes] = []     # actor id bytes
        self.model_ids: Dict[bytes, set] = {}   # multiplexed models loaded
        self.version = -1
        self.max_ongoing = 16               # per-replica, from the table
        self.fetched_at = 0.0
        self.inflight: Dict[bytes, int] = {}
        # per-replica smoothed call latency (seconds): the p2c score
        # weights in-flight counts by it, so a slow replica sheds load
        # to fast peers instead of just to idle ones
        self.ewma_s: Dict[bytes, float] = {}
        self.breakers: Dict[bytes, fault.CircuitBreaker] = {}
        self._probing: set = set()          # rids with a live probe task
        self.lock = threading.Lock()
        self._fm = fault.fault_metrics()

    def _controller(self) -> ActorHandle:
        return api.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)

    def refresh(self, block_until_nonempty: bool = True,
                timeout: float = 30.0,
                deadline_ts: Optional[float] = None):
        """Fetch the routing table. With a caller deadline, every
        attempt spends from THAT budget — a controller mid-restart must
        not stack a fresh 30 s timeout per retry on top of a request
        that promised its client an answer sooner."""
        now = time.monotonic()
        if self.replicas and now - self.fetched_at < _ROUTE_TTL_S:
            return
        deadline = now + timeout

        def _budget() -> float:
            # DeadlineExceeded is reserved for the CLIENT's budget (it
            # maps to 504); exhausting the refresh window itself stays
            # a RuntimeError below ("no running replicas" -> 500)
            r2 = fault.remaining_s(deadline_ts)
            if r2 is not None and r2 <= 0:
                raise fault.DeadlineExceeded(
                    f"deadline spent refreshing routes for {self.name!r}")
            rem = deadline - time.monotonic()
            if r2 is not None:
                rem = min(rem, r2)
            return max(0.05, rem)
        while True:
            table = api.get(self._controller().get_routing_table.remote(
                self.name), timeout=_budget())
            with self.lock:
                self.replicas = [bytes(r) for r in table["replicas"]]
                mids = table.get("model_ids") or []
                self.model_ids = {
                    rid: set(mids[i]) if i < len(mids) else set()
                    for i, rid in enumerate(self.replicas)}
                self.version = table["version"]
                self.max_ongoing = int(table.get("max_ongoing", 16))
                self.fetched_at = time.monotonic()
                live = set(self.replicas)
                for gone in [r for r in self.breakers if r not in live]:
                    del self.breakers[gone]
                    self._fm["ejected"].set(
                        0, tags={"replica": gone.hex()})
                for gone in [r for r in self.ewma_s if r not in live]:
                    del self.ewma_s[gone]
            if self.replicas or not block_until_nonempty:
                return
            _budget()   # raises DeadlineExceeded if the CLIENT budget died
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"deployment {self.name!r} has no running replicas")
            time.sleep(0.1)

    def capacity(self) -> Optional[int]:
        """Live capacity (running replicas x per-replica concurrency)
        for proxy admission control; None before the first fetch."""
        with self.lock:
            if self.version < 0:
                return None
            return len(self.replicas) * max(1, self.max_ongoing)

    # -- circuit breakers ---------------------------------------------------

    def _breaker(self, rid: bytes) -> fault.CircuitBreaker:
        b = self.breakers.get(rid)
        if b is None:
            from ray_tpu_torch.config import get_config
            cfg = get_config()
            b = fault.CircuitBreaker(
                failure_threshold=cfg.serve_cb_failure_threshold,
                cooldown_s=cfg.serve_cb_cooldown_s,
                latency_threshold_s=cfg.serve_cb_latency_threshold_s,
                latency_count=cfg.serve_cb_latency_count)
            self.breakers[rid] = b
        return b

    def record(self, rid: bytes, ok: bool,
               latency_s: Optional[float] = None,
               infra: bool = True) -> None:
        """Feed one call outcome to the replica's breaker. User-level
        errors count as success for HEALTH (the replica answered);
        only infrastructure failures and slow calls eject."""
        with self.lock:
            b = self._breaker(rid)
            was = b.state
            if ok or not infra:
                b.record_success(latency_s)
            else:
                b.record_failure()
            now_state = b.state
            if latency_s is not None and ok:
                # load-aware routing input: smoothed per-replica call
                # latency (failures excluded — the breaker handles
                # sick replicas; this steers load among healthy ones)
                e = self.ewma_s.get(rid)
                self.ewma_s[rid] = (latency_s if e is None
                                    else e + 0.2 * (latency_s - e))
        if now_state == was:
            return
        tags = {"replica": rid.hex()}
        if now_state == fault.OPEN:
            self._fm["ejected"].set(1, tags=tags)
            self._spawn_probe(rid)
        elif now_state == fault.CLOSED:
            self._fm["ejected"].set(0, tags=tags)

    def _spawn_probe(self, rid: bytes) -> None:
        """Proactive half-open recovery: while the breaker is OPEN,
        ping the replica directly (layered on the controller's health
        loop — the controller replaces DEAD replicas; the probe brings
        back ALIVE-but-was-flaky ones early and keeps a silent one
        ejected by pushing the cooldown forward)."""
        with self.lock:
            if rid in self._probing:
                return
            self._probing.add(rid)
        from ray_tpu_torch.config import get_config
        interval = max(0.05, get_config().serve_cb_cooldown_s / 2.0)

        async def _probe():
            ctx = api._g.ctx
            try:
                while True:
                    await asyncio.sleep(interval)
                    with self.lock:
                        b = self.breakers.get(rid)
                        if b is None or b.state != fault.OPEN or \
                                rid not in self.replicas:
                            return
                    try:
                        refs = await ctx.submit_actor_call(
                            ActorID(rid), "ping", (), {})
                        await ctx.get(refs[0], 2.0)
                        with self.lock:
                            b.force_half_open()
                        self._fm["ejected"].set(
                            0.5, tags={"replica": rid.hex()})
                        return        # one trial request decides
                    except Exception:
                        with self.lock:
                            b.extend_open()
            finally:
                with self.lock:
                    self._probing.discard(rid)

        try:
            asyncio.run_coroutine_threadsafe(_probe(), _api_loop())
        except Exception:
            # no live runtime loop (unit tests): cooldown-based
            # half-open in allow() still recovers the replica
            with self.lock:
                self._probing.discard(rid)

    def _score(self, rid: bytes) -> float:
        """Expected queued work on one replica: (in-flight + 1) x its
        EWMA call latency. A replica with no latency sample yet scores
        at the mean of known peers — a fresh autoscaled replica is
        then the cheapest choice at in-flight 0 and actually absorbs
        load, instead of competing on counts alone against warmed-up
        peers. Callers hold self.lock."""
        e = self.ewma_s.get(rid)
        if e is None:
            e = (sum(self.ewma_s.values()) / len(self.ewma_s)
                 if self.ewma_s else 1.0)
        return (self.inflight.get(rid, 0) + 1) * e

    def pick(self, model_id: Optional[str] = None) -> bytes:
        """Power-of-two-choices over expected work — in-flight counts
        weighted by per-replica EWMA latency (_score). With a
        multiplexed model id, replicas that already hold the model are
        preferred (p2c among them); a cold model falls through to plain
        p2c and the chosen replica loads it. Breaker-ejected replicas
        are skipped (half-open ones admit one trial); if EVERY replica
        is ejected the full set is used — routing somewhere beats
        manufacturing an outage out of a tripped breaker."""
        with self.lock:
            reps = list(self.replicas)
            if model_id is not None:
                warm = [r for r in reps
                        if model_id in self.model_ids.get(r, ())]
                if warm:
                    reps = warm
            # Recovery first: a HALF_OPEN (or cooldown-elapsed OPEN)
            # breaker needs exactly ONE trial request to decide — give
            # it priority over healthy replicas, else a closed majority
            # starves the trial and the replica stays ejected forever.
            # allow() admits at most one in-flight trial per breaker,
            # so this claims one request per recovery attempt, and it
            # returns False for OPEN breakers still cooling down.
            for r in reps:
                b = self.breakers.get(r)
                if b is not None and b.state != fault.CLOSED \
                        and b.allow():
                    return r
            closed = [r for r in reps
                      if self.breakers.get(r) is None
                      or self.breakers[r].state == fault.CLOSED]
            if closed:
                reps = closed
            # no closed replica and no admissible trial: fall through
            # to the full set — routing somewhere beats an outage
        if not reps:
            raise RuntimeError(f"no replicas for {self.name!r}")
        if len(reps) == 1:
            return reps[0]
        a, b = random.sample(reps, 2)
        with self.lock:
            sa, sb = self._score(a), self._score(b)
        return a if sa <= sb else b

    def track(self, rid: bytes, ref) -> None:
        with self.lock:
            self.inflight[rid] = self.inflight.get(rid, 0) + 1
        t_sent = time.monotonic()

        async def _untrack():
            try:
                await api._g.ctx.wait([ref], 1, None)
            except Exception:
                pass
            with self.lock:
                self.inflight[rid] = max(0, self.inflight.get(rid, 1) - 1)
            ok, infra = _peek_outcome(ref)
            self.record(rid, ok, time.monotonic() - t_sent, infra)

        loop = _api_loop()
        asyncio.run_coroutine_threadsafe(_untrack(), loop)

    def track_stream(self, rid: bytes, gen) -> None:
        """Streaming requests count as in-flight until the stream
        terminates — without this, p2c would route all (long-lived) LLM
        generations as if every replica were idle."""
        with self.lock:
            self.inflight[rid] = self.inflight.get(rid, 0) + 1

        async def _untrack():
            try:
                await api._g.ctx.stream_done(gen._stream_id)
            except Exception:
                pass
            with self.lock:
                self.inflight[rid] = max(0, self.inflight.get(rid, 1) - 1)

        loop = _api_loop()
        asyncio.run_coroutine_threadsafe(_untrack(), loop)

    def drop(self, rid: bytes) -> None:
        """Remove a replica the caller observed dead and force a refresh."""
        with self.lock:
            if rid in self.replicas:
                self.replicas.remove(rid)
            self.fetched_at = 0.0


def _peek_outcome(ref) -> tuple:
    """(ok, infra) for a READY result WITHOUT fetching its value: the
    caller owns refs it submitted, so the local store entry's status is
    authoritative. Errors are deserialized (rare) to separate replica
    health failures from user/flow-control exceptions — a request with
    bad input must not eject a healthy replica."""
    from ray_tpu_torch.runtime import core
    try:
        e = api._g.ctx.store.get_entry(ref.oid)
        if e is None or e.status != core.ERROR:
            return True, False
        err = api._g.ctx._loads_error(e.error_frame)
    except Exception:
        return False, True
    kind = fault.classify_error(err)
    return False, kind == "infra"


_routers: Dict[str, _Router] = {}
_routers_lock = threading.Lock()


def _router_for(name: str) -> _Router:
    with _routers_lock:
        r = _routers.get(name)
        if r is None:
            r = _Router(name)
            _routers[name] = r
        return r


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._route(self._method, args, kwargs)


class DeploymentHandle:
    """Routes calls to a deployment's replicas (p2c). Picklable — ships
    across actors as a name reference.

    Deadlines: ``options(deadline_s=...)`` gives every call routed
    through the handle that much budget (minted at submission);
    ``_deadline_ts`` pins an ABSOLUTE wall-clock deadline (the proxy
    mints one per request at ingress so queue wait spends the same
    budget). The deadline rides request metadata to the replica and on
    into the engine, and caps routing, discovery, and retry time."""

    def __init__(self, deployment_name: str, _pin: bytes = None,
                 _model_id: str = None, _stream: bool = False,
                 _deadline_s: float = None, _deadline_ts: float = None,
                 _trace: str = None):
        self.deployment_name = deployment_name
        self._pin = _pin
        self._model_id = _model_id
        self._stream = _stream
        self._deadline_s = _deadline_s
        self._deadline_ts = _deadline_ts
        # traceparent string pinned by the proxy at ingress (rides next
        # to _deadline_ts); without it the AMBIENT request context is
        # inherited — composed deployments join their caller's trace
        self._trace = _trace

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self._pin, self._model_id,
                 self._stream, self._deadline_s, self._deadline_ts,
                 self._trace))

    def pinned(self) -> "DeploymentHandle":
        """A handle bound to ONE replica (picked now) — for stateful
        call sequences like token streaming, where every call must land
        on the replica holding the stream."""
        router = _router_for(self.deployment_name)
        router.refresh()
        return DeploymentHandle(self.deployment_name,
                                router.pick(self._model_id),
                                self._model_id, self._stream,
                                self._deadline_s, self._deadline_ts,
                                self._trace)

    def __getattr__(self, name):
        if name.startswith("_") or name in ("deployment_name",):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def remote(self, *args, **kwargs):
        return self._route("__call__", args, kwargs)

    def _request_deadline_ts(self) -> Optional[float]:
        """Absolute deadline for ONE call: the pinned absolute deadline
        if set, else a fresh budget minted now from deadline_s, else
        the AMBIENT request deadline — a composed deployment (replica
        calling another deployment through a nested handle, e.g. the
        PD ingress -> decode tier) inherits its caller's budget."""
        if self._deadline_ts is not None:
            return self._deadline_ts
        if self._deadline_s is not None:
            return time.time() + float(self._deadline_s)
        return fault.current_deadline_ts()

    def _request_trace_ctx(self) -> Optional[tracing.TraceContext]:
        """Trace context for ONE call: the proxy-pinned traceparent if
        set, else the AMBIENT request context (a composed deployment —
        replica calling another deployment through a nested handle —
        joins its caller's trace the way it inherits its deadline)."""
        if self._trace is not None:
            return tracing.parse_traceparent(self._trace)
        return tracing.current_context()

    def _route(self, method: str, args: tuple, kwargs: dict,
               _policy: fault.RetryPolicy = None,
               _deadline_ts: float = None, _attempt: int = 0,
               _tctx=None):
        router = _router_for(self.deployment_name)
        if _attempt == 0:
            _deadline_ts = self._request_deadline_ts()
            _tctx = self._request_trace_ctx()
        t0_wall = time.time()
        # the submit span id is minted BEFORE the call so the replica's
        # spans can parent to it through the shipped traceparent
        sid = tracing.new_span_id() if _tctx is not None else ""
        if self._pin is not None:
            # Pinned: no table refresh — the stream lives or dies with
            # its replica, and a mid-rescale empty routing table must
            # not kill a healthy pinned call.
            rid = self._pin
        else:
            router.refresh(deadline_ts=_deadline_ts)
            rid = router.pick(self._model_id)
        replica = ActorHandle(ActorID(rid))
        meta = {}
        if self._model_id:
            meta["multiplexed_model_id"] = self._model_id
        if _deadline_ts is not None:
            meta["deadline_ts"] = _deadline_ts
        if _tctx is not None:
            meta["traceparent"] = tracing.format_traceparent(
                tracing.TraceContext(_tctx.trace_id, sid))
        meta = meta or None
        try:
            # proxy->replica chaos boundary (Config.testing_serve_failure)
            _chaos_apply(chaos_fire("proxy"), "proxy")
            if self._stream:
                # Push-based response streaming (reference:
                # serve/_private/router.py:689 streaming path): one
                # streaming actor call on the replica's generator
                # wrapper; tokens flow replica -> caller through the
                # object plane with no polling RPCs.
                gen = replica.handle_request_stream.options(
                    num_returns="streaming").remote(
                    method, args, kwargs, meta)
                router.track_stream(rid, gen)
                # streams never report a unary outcome — settle a
                # half-open trial on submission so the breaker can't
                # stay stuck holding a phantom in-flight trial
                b = router.breakers.get(rid)
                if b is not None and b.state == fault.HALF_OPEN:
                    router.record(rid, ok=True)
                if _tctx is not None:
                    tracing.record_request_span(
                        "handle", "submit", _tctx, _tctx.span_id,
                        t0_wall, time.time(), span_id=sid,
                        deployment=self.deployment_name,
                        attempt=_attempt, method=method,
                        replica=rid.hex()[:12])
                return gen
            if meta is None:
                ref = replica.handle_request.remote(method, args, kwargs)
            else:
                ref = replica.handle_request.remote(
                    method, args, kwargs, meta)
        except api.RayTpuError:
            # The submission itself failed (never reached a replica) —
            # idempotent by construction, so reroute under the budgeted
            # policy: jittered backoff, attempt- and deadline-capped.
            router.record(rid, ok=False, infra=True)
            if _tctx is not None:
                tracing.record_request_span(
                    "handle", "submit", _tctx, _tctx.span_id,
                    t0_wall, time.time(), span_id=sid, error=True,
                    deployment=self.deployment_name, attempt=_attempt,
                    method=method, replica=rid.hex()[:12])
            if self._pin is not None:
                raise  # pinned state died with its replica — no rerouting
            if _policy is None:
                _policy = fault.RetryPolicy.from_config("reroute")
            pause = _policy._sleepable(_attempt, _deadline_ts)
            if pause is None:
                raise
            router.drop(rid)
            fault.fault_metrics()["retries"].inc(
                tags={"reason": "reroute"})
            time.sleep(pause)
            return self._route(method, args, kwargs, _policy,
                               _deadline_ts, _attempt + 1, _tctx)
        router.track(rid, ref)
        if _tctx is not None:
            tracing.record_request_span(
                "handle", "submit", _tctx, _tctx.span_id,
                t0_wall, time.time(), span_id=sid,
                deployment=self.deployment_name, attempt=_attempt,
                method=method, replica=rid.hex()[:12])
        return ref

    def options(self, multiplexed_model_id: str = None,
                stream: bool = None, deadline_s: float = None,
                **_opts) -> "DeploymentHandle":
        mid = (str(multiplexed_model_id)
               if multiplexed_model_id is not None else self._model_id)
        st = self._stream if stream is None else bool(stream)
        dl = self._deadline_s if deadline_s is None else float(deadline_s)
        if mid == self._model_id and st == self._stream \
                and dl == self._deadline_s:
            return self
        return DeploymentHandle(self.deployment_name, self._pin, mid, st,
                                dl, self._deadline_ts, self._trace)
