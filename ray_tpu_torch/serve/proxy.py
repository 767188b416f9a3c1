"""HTTP ingress proxy: one actor per cluster (per node when scaled out).

Reference: python/ray/serve/_private/proxy.py — the reference embeds a
starlette ASGI app; here a dependency-free asyncio HTTP/1.1 server is
enough for the framework's JSON-in/JSON-out serving surface. Routing is
longest-prefix over the controller's ingress table; the request body
(JSON when the content-type says so, raw bytes otherwise) becomes the
deployment's argument.

HTTP/1.1 surface: persistent connections (1.1 default-on, 1.0 opt-in
via Connection: keep-alive) with an idle timeout, chunked
transfer-encoded request bodies, Expect: 100-continue, bounded header/
body sizes (431/413), and malformed-request 400s. HTTP/2 and gRPC
ingress are out of scope by design (the image carries no h2/grpc deps;
the reference gets both from uvicorn/grpcio).

Fault tolerance (serve/fault.py): each request gets ONE deadline
budget (X-Request-Deadline header, default
Config.serve_default_deadline_s) spent across admission queueing,
routing, retries, and the replica call — 504 when it runs out, with
downstream work cancelled. Per-deployment admission control sheds
overload with fast 503 + Retry-After once the bounded queue is full or
the predicted queue wait exceeds the budget (_Admission). Route
refreshes and reroutes retry under a budgeted jittered-backoff policy
instead of one-shot immediate retries and fixed 120 s timeouts.

The port's copy of ``ray_tpu/serve/proxy.py``; the process imports no
torch.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
from collections import deque
from typing import Dict, Optional, Tuple

from ray_tpu_torch import api
from ray_tpu_torch.serve import fault
from ray_tpu_torch.util import tracing

_log = logging.getLogger("ray_tpu_torch.serve.proxy")


class _BadRequest(Exception):
    def __init__(self, msg: str, code: int = 400):
        super().__init__(msg)
        self.code = code


class _Shed(Exception):
    """Admission control rejected the request: fast 503 + Retry-After
    instead of parking it until its (possibly 120 s) deadline."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = max(1.0, retry_after_s)


def _cfg():
    ctx = getattr(api._g, "ctx", None)
    if ctx is not None:
        return ctx.config
    from ray_tpu_torch.config import get_config
    return get_config()


class _Admission:
    """Per-deployment admission control + backpressure in the proxy.

    Requests within live capacity (running replicas x per-replica
    max_ongoing_requests, read off the handle router's table) dispatch
    immediately; the rest wait in a BOUNDED queue. A request is shed
    (503 + Retry-After) when the queue is full, when its predicted
    queue wait (EWMA service time) exceeds its remaining deadline
    budget, or when its budget runs out while queued — overload
    produces fast, retryable rejections instead of a cliff of slow
    timeouts (reference capability: serve's max_queued_requests +
    backoff; the SLO-aware shed is the deadline-propagation dividend).
    """

    def __init__(self, deployment: str):
        self.deployment = deployment
        self.inflight = 0
        self.waiters: deque = deque()      # asyncio futures, FIFO
        self.ewma_s = 0.1                  # smoothed per-call service time

    def observe_service(self, seconds: float) -> None:
        self.ewma_s += 0.2 * (seconds - self.ewma_s)

    def _capacity(self) -> int:
        from ray_tpu_torch.serve.handle import _router_for
        cap = _router_for(self.deployment).capacity()
        if not cap:
            # table not fetched yet (first request) or zero replicas
            # mid-rescale: stay optimistic — the bounded queue still
            # protects the proxy, and the next refresh corrects it
            return max(self.inflight + 1, 16)
        return cap

    def predicted_wait_s(self, queue_len: int) -> float:
        cap = self._capacity()
        return (queue_len + 1) * self.ewma_s / max(1, cap)

    async def acquire(self, deadline_ts: Optional[float]) -> float:
        """Admit or raise _Shed; returns seconds spent queued."""
        cap = self._capacity()
        if self.inflight < cap and not self.waiters:
            self.inflight += 1
            return 0.0
        limit = int(getattr(_cfg(), "serve_queue_limit", 128))
        if len(self.waiters) >= limit:
            raise _Shed(
                f"{self.deployment}: queue full "
                f"({len(self.waiters)}/{limit})",
                self.predicted_wait_s(len(self.waiters)))
        rem = fault.remaining_s(deadline_ts)
        est = self.predicted_wait_s(len(self.waiters))
        if rem is not None and est > rem:
            raise _Shed(
                f"{self.deployment}: predicted queue wait {est:.2f}s "
                f"exceeds remaining deadline {rem:.2f}s", est)
        fut = asyncio.get_running_loop().create_future()
        self.waiters.append(fut)
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(fut, rem)
        except asyncio.TimeoutError:
            # budget spent while queued: shed (wait_for cancelled fut,
            # so release() skips it; remove eagerly to free the depth)
            try:
                self.waiters.remove(fut)
            except ValueError:
                pass
            raise _Shed(
                f"{self.deployment}: queue wait exceeded the deadline "
                f"budget", self.predicted_wait_s(len(self.waiters)))
        return time.monotonic() - t0

    def release(self) -> None:
        """Finish one in-flight request: hand the slot to the oldest
        live waiter (inflight count transfers), else decrement."""
        while self.waiters:
            fut = self.waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return
        self.inflight = max(0, self.inflight - 1)


def proxy_metrics() -> dict:
    """Get-or-create the proxy's request-phase histograms (same queue/
    handler split the llm engine records — see engine_metrics())."""
    from ray_tpu_torch.util import metrics as m
    return {
        "queue": m.Histogram(
            "serve_proxy_queue_s",
            "Route refresh + handle submission time before the "
            "deployment call is in flight", tag_keys=("deployment",)),
        "handler": m.Histogram(
            "serve_proxy_handler_s",
            "Time awaiting the deployment handler's result",
            tag_keys=("deployment",)),
        # the availability SLI: the health plane's per-deployment
        # availability objective reads code="5xx" increments off this
        # (util/health.py derived objectives)
        "requests": m.Counter(
            "serve_requests_total",
            "Ingress requests by final HTTP status code",
            tag_keys=("deployment", "code")),
    }


class HTTPProxy:
    """Actor. Call ``start(host, port)`` once; serves until killed."""

    def __init__(self):
        self._server: Optional[asyncio.AbstractServer] = None
        self._routes = []                 # [{route_prefix, deployment}]
        self._routes_fetched = 0.0
        self._requests = 0
        self._errors = 0
        self._shed = 0
        self._m = proxy_metrics()
        self._fm = fault.fault_metrics()
        self._adm: Dict[str, _Admission] = {}
        # cached head health snapshot for the shed advisory — the
        # autoscaler's FAST PATH: a shed while the budget burns fires
        # an autoscale_hint RPC at the controller (serve/autoscale.py)
        self._health_advice = {"ts": 0.0, "state": None}

    def _admission(self, dep: str) -> _Admission:
        a = self._adm.get(dep)
        if a is None:
            a = _Admission(dep)
            self._adm[dep] = a
        return a

    async def start(self, host: str = "127.0.0.1", port: int = 8000) -> dict:
        self._server = await asyncio.start_server(self._on_conn, host, port)
        addr = self._server.sockets[0].getsockname()
        return {"host": addr[0], "port": addr[1]}

    async def ping(self) -> str:
        return "ok"

    async def metrics(self) -> dict:
        return {"requests": self._requests, "errors": self._errors,
                "shed": self._shed}

    # -- routing table -----------------------------------------------------

    async def _refresh_routes(self, deadline_ts: Optional[float] = None):
        if time.monotonic() - self._routes_fetched < 1.0 and self._routes:
            return
        from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE
        ctx = api._g.ctx
        info = await ctx.pool.call(ctx.head_addr, "get_named_actor",
                                   name=CONTROLLER_NAME,
                                   namespace=SERVE_NAMESPACE)
        if not info or info.get("state") == "DEAD":
            return

        async def _fetch():
            # each attempt spends from the request's deadline (a
            # crashed-and-restarted controller leaves a stale actor
            # address one call deep; the first failure invalidates it)
            rem = fault.remaining_s(deadline_ts)
            if rem is not None and rem <= 0:
                raise fault.DeadlineExceeded("route refresh")
            refs = await ctx.submit_actor_call(
                info["actor_id"], "get_ingress_routes", (), {})
            return await ctx.get(
                refs[0], min(10.0, rem) if rem is not None else 10.0)

        policy = fault.RetryPolicy.from_config("route_refresh", _cfg())
        self._routes = await policy.run_async(
            _fetch, deadline_ts,
            retryable=lambda e: not isinstance(e, fault.DeadlineExceeded))
        self._routes_fetched = time.monotonic()

    def _match(self, path: str) -> Optional[str]:
        for r in self._routes:
            p = r["route_prefix"]
            if path == p or path.startswith(p.rstrip("/") + "/") or p == "/":
                return r["deployment"]
        return None

    # -- http --------------------------------------------------------------

    IDLE_TIMEOUT_S = 75.0          # keep-alive connections reap after
    MAX_HEADER_BYTES = 64 * 1024
    MAX_BODY_BYTES = 64 * 1024 * 1024

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    req = await asyncio.wait_for(
                        self._read_request(reader, writer),
                        self.IDLE_TIMEOUT_S)
                except asyncio.TimeoutError:
                    return            # idle keep-alive connection
                except _BadRequest as e:
                    self._respond(writer, e.code, {"error": str(e)},
                                  close=True)
                    await writer.drain()
                    return
                if req is None:
                    return
                method, path, headers, body, version = req
                conn = headers.get("connection", "").lower()
                # RFC 7230: 1.1 persists unless 'close'; 1.0 only with
                # an explicit keep-alive
                keep = (conn != "close") if version == "HTTP/1.1" \
                    else (conn == "keep-alive")
                r = await self._dispatch(writer, method, path, headers,
                                         body)
                await writer.drain()
                if r == "close" or not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    async def _line(reader) -> bytes:
        """readline that maps an over-long line (StreamReader limit)
        to a protocol error instead of an unhandled ValueError."""
        try:
            return await reader.readline()
        except (ValueError, asyncio.LimitOverrunError):
            raise _BadRequest("line too long", 431)

    async def _read_request(self, reader, writer):
        line = await self._line(reader)
        if not line:
            return None
        try:
            method, target, version = line.decode().split()
        except (ValueError, UnicodeDecodeError):
            raise _BadRequest("malformed request line")
        headers: Dict[str, str] = {}
        hdr_bytes = 0
        while True:
            h = await self._line(reader)
            if h in (b"\r\n", b"\n", b""):
                break
            hdr_bytes += len(h)
            if hdr_bytes > self.MAX_HEADER_BYTES:
                raise _BadRequest("header section too large", 431)
            k, sep, v = h.decode(errors="replace").partition(":")
            if not sep:
                raise _BadRequest("malformed header line")
            headers[k.strip().lower()] = v.strip()
        chunked = "chunked" in headers.get("transfer-encoding",
                                           "").lower()
        n = 0
        if not chunked:
            try:
                n = int(headers.get("content-length", 0))
            except ValueError:
                raise _BadRequest("bad Content-Length")
            if n < 0:
                raise _BadRequest("bad Content-Length")
            # validate BEFORE any 100 Continue: the interim response
            # exists precisely so oversized uploads are rejected
            # without transferring the body
            if n > self.MAX_BODY_BYTES:
                raise _BadRequest("body too large", 413)
        if headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if chunked:
            body = await self._read_chunked(reader)
        else:
            body = await reader.readexactly(n) if n else b""
        path = target.split("?", 1)[0]
        return method, path, headers, body, version

    async def _read_chunked(self, reader) -> bytes:
        """RFC 7230 §4.1 chunked request body (clients that stream
        uploads don't know Content-Length up front)."""
        out = bytearray()
        while True:
            size_line = await self._line(reader)
            if not size_line.strip():
                # EOF / blank where a chunk size belongs: the body is
                # TRUNCATED — reject rather than accept a partial
                # payload as complete
                raise _BadRequest("truncated chunked body")
            try:
                # chunk extensions (';...') are tolerated and ignored
                n = int(size_line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise _BadRequest("bad chunk size")
            if n < 0:
                raise _BadRequest("bad chunk size")
            if len(out) + n > self.MAX_BODY_BYTES:
                raise _BadRequest("body too large", 413)
            if n == 0:
                # trailers (ignored) up to the final blank line
                while True:
                    t = await self._line(reader)
                    if t in (b"\r\n", b"\n", b""):
                        return bytes(out)
            out += await reader.readexactly(n)
            crlf = await self._line(reader)
            if crlf not in (b"\r\n", b"\n"):
                raise _BadRequest("bad chunk terminator")

    def _deadline_from_headers(self, headers) -> float:
        """Absolute wall-clock deadline for this request: the client's
        X-Request-Deadline budget (seconds), else the configured
        default. Every downstream stage — queueing, routing, retries,
        the replica call, the engine — spends from this ONE budget."""
        raw = headers.get("x-request-deadline")
        if raw is None:
            budget = float(getattr(_cfg(), "serve_default_deadline_s",
                                   120.0))
        else:
            try:
                budget = float(raw)
            except ValueError:
                raise _BadRequest(f"bad X-Request-Deadline: {raw!r}")
            if budget <= 0:
                raise _BadRequest(
                    f"X-Request-Deadline must be > 0, got {budget}")
        return time.time() + budget

    def _trace_headers(self, tctx) -> Optional[Dict[str, str]]:
        """Response headers naming the request's trace — the client-
        side handle into `ray-tpu trace <id>` / the /traces page."""
        if tctx is None:
            return None
        return {"X-Trace-Id": tctx.trace_id}

    def _error_response(self, writer, e: BaseException,
                        deadline_ts: float, where: str,
                        tctx=None, t0_wall: Optional[float] = None,
                        dep: Optional[str] = None):
        """Map a dispatch failure to HTTP: shed -> 503 + Retry-After,
        spent budget -> 504, anything else -> 500. When the request
        carries a trace, its TAIL lands here: failed requests always
        survive sampling (finish_request keeps every error)."""
        self._errors += 1
        hdrs = self._trace_headers(tctx) or {}

        def finish(status: str, code: int):
            if tctx is not None and t0_wall is not None:
                tracing.finish_request(
                    tctx, t0_wall, time.time(), status=status,
                    error=True, http_status=code,
                    **({"deployment": dep} if dep else {}))
        if isinstance(e, _Shed):
            self._shed += 1
            finish("shed", 503)
            if dep:
                self._m["requests"].inc(
                    tags={"deployment": dep, "code": "503"})
                # Health-plane actuation: a shed while the deployment's
                # availability/latency budget is already burning is
                # exactly the moment SLO-driven replica autoscaling
                # scales out — _consult_health fires the controller's
                # autoscale_hint RPC (the fast path; the controller's
                # own burn-advice fetch is the slow path).
                try:
                    asyncio.ensure_future(self._consult_health(dep))
                except RuntimeError:
                    pass       # no running loop (unit-test contexts)
            hdrs["Retry-After"] = str(int(math.ceil(e.retry_after_s)))
            return self._respond(
                writer, 503, {"error": f"overloaded: {e}"},
                headers=hdrs)
        kind = fault.classify_error(e)
        rem = fault.remaining_s(deadline_ts)
        if kind == "deadline" or \
                (kind == "timeout" and rem is not None and rem <= 0.05):
            self._fm["deadline"].inc(tags={"where": where})
            finish("deadline", 504)
            if dep:
                self._m["requests"].inc(
                    tags={"deployment": dep, "code": "504"})
            return self._respond(writer, 504,
                                 {"error": f"deadline exceeded: {e}"},
                                 headers=hdrs or None)
        finish("error", 500)
        if dep:
            self._m["requests"].inc(
                tags={"deployment": dep, "code": "500"})
        return self._respond(writer, 500,
                             {"error": f"{type(e).__name__}: {e}"},
                             headers=hdrs or None)

    async def _consult_health(self, dep: str) -> None:
        """The autoscaler's fast-path signal off the cluster health
        plane: fetch (and briefly cache) the head's SLO snapshot; when
        the deployment's availability or latency budget is burning,
        fire ONE autoscale_hint RPC at the serve controller per cache
        window (serve/autoscale.py treats it as a page-tier signal —
        the scale-up doesn't wait for the controller's own advice
        fetch) and log next to the shed decision. Never raises — an
        unreachable head/controller or a disabled plane silently skips
        the actuation; the controller's slow path still scales."""
        try:
            cache = self._health_advice
            now = time.monotonic()
            if now - cache["ts"] > 5.0:
                # stamp BEFORE awaiting: a shed storm must not
                # stampede the (already overloaded) head with one
                # health_state RPC per shed — concurrent callers and
                # post-timeout retries all see a fresh stamp
                cache["ts"] = now
                ctx = api._g.ctx
                cache["state"] = await ctx.pool.call(
                    ctx.head_addr, "health_state", timeout=2.0)
            st = cache["state"] or {}
            adv = (st.get("burn_advice") or {}).get(dep)
            if adv and (adv.get("availability_burning")
                        or adv.get("latency_burning")) \
                    and now - cache.get("logged_ts", 0.0) > 5.0:
                # one hint + one log line per cache window, not one
                # per shed — a shed storm must not also be a hint/log
                # storm (the hint is level-triggered at the receiver)
                cache["logged_ts"] = now
                # log BEFORE the hint RPC: when the controller is the
                # thing that's down, the operator's only
                # shedding-while-burning signal must still appear
                _log.warning(
                    "serve[%s]: shedding while the %s-tier SLO budget "
                    "is burning (availability=%s latency=%s) — "
                    "sending autoscale_hint (serve/autoscale.py "
                    "scales out within its cooldown)", dep,
                    adv.get("tier") or "?",
                    adv.get("availability_burning"),
                    adv.get("latency_burning"))
                await self._send_autoscale_hint(
                    dep, adv.get("tier") or "page")
        except Exception:  # noqa: BLE001 — advisory only
            pass

    async def _send_autoscale_hint(self, dep: str, tier: str) -> None:
        """One scale-up hint to the serve controller. The result ref
        is awaited and freed — a long-lived proxy must not accumulate
        one un-fetched store entry per hint window (same rule as the
        streaming path's per-token free)."""
        from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE
        ctx = api._g.ctx
        info = await ctx.pool.call(ctx.head_addr, "get_named_actor",
                                   name=CONTROLLER_NAME,
                                   namespace=SERVE_NAMESPACE)
        if not info or info.get("state") == "DEAD":
            return
        refs = await ctx.submit_actor_call(
            info["actor_id"], "autoscale_hint", (dep, tier), {})
        try:
            await ctx.get(refs[0], 2.0)
        finally:
            try:
                await ctx.free(refs)
            except Exception:
                pass

    async def _dispatch(self, writer, method, path, headers, body):
        self._requests += 1
        t_arrive = time.monotonic()
        t_arrive_wall = time.time()
        if path == "/-/healthz":
            return self._respond(writer, 200, {"status": "ok"})
        try:
            deadline_ts = self._deadline_from_headers(headers)
        except _BadRequest as e:
            self._errors += 1
            return self._respond(writer, e.code, {"error": str(e)})
        # One trace per request: join the client's traceparent (W3C) or
        # mint a fresh root; threaded alongside the deadline budget
        # through handle -> replica -> engine. None = tracing disabled.
        client_ctx = tracing.parse_traceparent(headers.get("traceparent"))
        if client_ctx is not None:
            tctx = tracing.TraceContext(client_ctx.trace_id,
                                        tracing.new_span_id())
        else:
            tctx = tracing.mint_context()
        try:
            await self._refresh_routes(deadline_ts)
        except Exception as e:
            # A refresh can fail transiently (controller just crashed
            # and restarted; its old address is still cached one call
            # deep). With a previously-fetched table, serve THAT —
            # stale routes beat a 500, and the failed call already
            # invalidated the stale cache for the next refresh.
            if not self._routes:
                self._errors += 1
                # pre-dispatch failure, but the trace was already
                # minted: root it so "errors are always kept" holds
                # for routing outages too, not just replica failures
                if tctx is not None:
                    tracing.finish_request(
                        tctx, t_arrive_wall, time.time(),
                        status="error", error=True, http_status=500)
                return self._respond(
                    writer, 500, {"error": f"route refresh: {e}"},
                    headers=self._trace_headers(tctx))
            # stamp NOW: stale routes keep serving and the (expensive)
            # failing refresh re-runs at most once per second, not on
            # every request during a controller outage
            self._routes_fetched = time.monotonic()
        if path == "/-/routes":
            return self._respond(writer, 200, {"routes": self._routes})
        dep = self._match(path)
        if dep is None:
            self._errors += 1
            if tctx is not None:
                tracing.finish_request(
                    tctx, t_arrive_wall, time.time(),
                    status="error", error=True, http_status=404)
            return self._respond(writer, 404,
                                 {"error": f"no route for {path}"},
                                 headers=self._trace_headers(tctx))
        ctype = headers.get("content-type", "")
        if body and "json" in ctype:
            arg = json.loads(body)
        elif body:
            arg = body
        else:
            arg = None
        tags = {"deployment": dep}
        adm = self._admission(dep)
        tq0_wall = time.time()
        try:
            queued_s = await adm.acquire(deadline_ts)
        except _Shed as e:
            self._fm["shed"].inc(tags=tags)
            return self._error_response(writer, e, deadline_ts, "proxy",
                                        tctx, t_arrive_wall, dep)
        if tctx is not None and queued_s > 0:
            # admission queueing gets its own segment only when the
            # request actually waited (zero-wait spans are noise)
            tracing.record_request_span(
                "proxy", "queue", tctx, tctx.span_id, tq0_wall,
                tq0_wall + queued_s, deployment=dep)
        try:
            if "text/event-stream" in headers.get("accept", ""):
                # SSE token streaming (reference: serve streams LLM
                # responses over HTTP; the stream rides the core
                # streaming-return path, one `data:` event per token)
                return await self._dispatch_stream(
                    writer, dep, arg, t_arrive, deadline_ts,
                    tctx, t_arrive_wall)
            return await self._dispatch_unary(
                writer, dep, arg, t_arrive, deadline_ts, tags,
                tctx, t_arrive_wall)
        finally:
            adm.release()

    async def _dispatch_unary(self, writer, dep, arg, t_arrive,
                              deadline_ts, tags, tctx=None,
                              t_arrive_wall=None):
        loop = asyncio.get_running_loop()
        from ray_tpu_torch.serve.handle import DeploymentHandle
        wire = (tracing.format_traceparent(tctx)
                if tctx is not None else None)

        # A DRAINING replica rejects before starting (the request never
        # ran), so rerouting it once is always safe; any other failure
        # surfaces — the handle layer already did budgeted rerouting
        # for submissions that failed to send.
        for attempt in (0, 1):
            t_sent = None
            try:
                # Handle routing + submission is the sync caller API —
                # run it on a thread; await the result on this loop.
                h = DeploymentHandle(dep, _deadline_ts=deadline_ts,
                                     _trace=wire)
                ref = await loop.run_in_executor(
                    None, lambda: h.remote(arg) if arg is not None
                    else h.remote())
                t_sent = time.monotonic()
                t_sent_wall = time.time()
                # queue: parse+admission+routing; handler: replica
                # time. One sample per REQUEST: the draining retry's
                # second pass would otherwise re-observe a span that
                # contains attempt 0's whole replica round-trip
                if attempt == 0:
                    self._m["queue"].observe(t_sent - t_arrive, tags)
                rem = fault.remaining_s(deadline_ts)
                if rem is None or rem <= 0:
                    raise fault.DeadlineExceeded(
                        "budget spent before the replica call")
                failed = True
                try:
                    result = await api.get_async(ref, timeout=rem)
                    failed = False
                finally:
                    # failures and deadline timeouts are the tail the
                    # histogram exists to show — record, then surface.
                    # The exemplar links the bucket this sample lands
                    # in to its concrete trace (`ray-tpu trace <id>`).
                    dt = time.monotonic() - t_sent
                    self._m["handler"].observe(
                        dt, tags,
                        exemplar=tctx.trace_id if tctx else None)
                    self._admission(dep).observe_service(dt)
                    if tctx is not None:
                        tracing.record_request_span(
                            "proxy", "handler", tctx, tctx.span_id,
                            t_sent_wall, time.time(), deployment=dep,
                            attempt=attempt, error=failed)
            except BaseException as e:  # noqa: BLE001
                if attempt == 0 and \
                        fault.classify_error(e) == "draining" and \
                        (fault.remaining_s(deadline_ts) or 0) > 0:
                    # invalidate the route cache: the retry must see a
                    # fresh table (the controller already dropped the
                    # draining replica from it — a <=0.5s-old cached
                    # copy could re-pick the same replica)
                    from ray_tpu_torch.serve.handle import _router_for
                    _router_for(dep).fetched_at = 0.0
                    self._fm["retries"].inc(tags={"reason": "draining"})
                    continue
                return self._error_response(writer, e, deadline_ts,
                                            "proxy", tctx,
                                            t_arrive_wall, dep)
            if tctx is not None and t_arrive_wall is not None:
                tracing.finish_request(
                    tctx, t_arrive_wall, time.time(), status="ok",
                    http_status=200, deployment=dep)
            self._m["requests"].inc(
                tags={"deployment": dep, "code": "200"})
            return self._respond(writer, 200, result,
                                 headers=self._trace_headers(tctx))

    async def _dispatch_stream(self, writer, dep: str, arg,
                               t_arrive: Optional[float] = None,
                               deadline_ts: Optional[float] = None,
                               tctx=None,
                               t_arrive_wall: Optional[float] = None
                               ) -> str:
        """Server-sent events over the core streaming-return path: one
        streaming call on the deployment's generate_stream generator;
        each produced token is pushed replica -> proxy through the
        object plane and written as a `data:` event (no polling RPCs —
        reference: serve streams LLM responses push-based the same way).
        The request deadline bounds the WHOLE stream: each token wait
        spends the remaining budget, and the replica/engine cancels its
        side when the budget runs out. Returns "close" — an SSE
        response ends with the connection."""
        from ray_tpu_torch.serve.handle import DeploymentHandle
        loop = asyncio.get_running_loop()

        def _bad_stream(msg: str) -> str:
            # validation 500s are still failed requests: the
            # availability SLI counts them and the trace (errors are
            # always kept) finishes, same as the unary error paths
            self._errors += 1
            self._m["requests"].inc(
                tags={"deployment": dep, "code": "500"})
            if tctx is not None and t_arrive_wall is not None:
                tracing.finish_request(
                    tctx, t_arrive_wall, time.time(), status="error",
                    error=True, http_status=500, deployment=dep)
            self._respond(writer, 500, {"error": msg},
                          headers=self._trace_headers(tctx))
            return "close"

        if arg is not None and not isinstance(arg, dict):
            return _bad_stream("stream requests take a JSON object "
                               "body with a 'tokens' field")
        kw = dict(arg or {})
        tokens = kw.pop("tokens", None)
        if tokens is None:
            return _bad_stream("stream request needs 'tokens'")
        try:
            h = DeploymentHandle(
                dep, _deadline_ts=deadline_ts,
                _trace=(tracing.format_traceparent(tctx)
                        if tctx is not None else None))
            # submission is the sync caller API — keep it off the loop
            gen = await loop.run_in_executor(
                None, lambda: h.options(
                    stream=True).generate_stream.remote(tokens, **kw))
        except BaseException as e:  # noqa: BLE001
            return self._error_response(writer, e, deadline_ts, "proxy",
                                        tctx, t_arrive_wall, dep)
        tags = {"deployment": dep}
        t_sent = time.monotonic()
        t_sent_wall = time.time()
        status = "ok"
        self._m["queue"].observe(t_sent - (t_arrive or t_sent), tags)
        tid_hdr = (f"X-Trace-Id: {tctx.trace_id}\r\n".encode()
                   if tctx is not None else b"")
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n" + tid_hdr +
                     b"Connection: close\r\n\r\n")
        try:
            async for ref in gen:
                rem = fault.remaining_s(deadline_ts)
                if rem is not None and rem <= 0:
                    raise fault.DeadlineExceeded("mid-stream")
                t = await api.get_async(
                    ref, timeout=rem if rem is not None else 120.0)
                await api._g.ctx.free([ref])  # long-lived proxy process
                writer.write(
                    f"data: {json.dumps({'token': t})}\n\n".encode())
                await writer.drain()
            writer.write(b"event: done\ndata: {}\n\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            gen.close()  # client went away: stop the replica's stream
        except BaseException as e:  # noqa: BLE001 — replica died mid-stream
            # surface the failure as the protocol's error frame instead of
            # killing the connection handler with an unhandled exception
            self._errors += 1
            kind = fault.classify_error(e)
            status = "deadline" if kind == "deadline" or (
                kind == "timeout" and deadline_ts is not None) \
                else "error"
            if status == "deadline":
                self._fm["deadline"].inc(tags={"where": "proxy"})
            gen.close()     # budget spent: stop the replica's stream
            try:
                writer.write(
                    b"event: error\ndata: "
                    + json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n\n")
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            # a stream's handler span covers the whole generation —
            # recorded in the histogram but NOT fed to the admission
            # EWMA (a 60s generation would poison the per-call queue-
            # wait prediction unary sheds are computed from)
            self._m["handler"].observe(
                time.monotonic() - t_sent, tags,
                exemplar=tctx.trace_id if tctx else None)
            # stream availability: headers already went out 200, but a
            # cut/errored stream is a failed request to the client —
            # the SLI counts it like the unary 5xx it would have been
            self._m["requests"].inc(tags={
                "deployment": dep,
                "code": {"ok": "200",
                         "deadline": "504"}.get(status, "500")})
            if tctx is not None:
                tracing.record_request_span(
                    "proxy", "handler", tctx, tctx.span_id,
                    t_sent_wall, time.time(), deployment=dep,
                    error=status != "ok")
                tracing.finish_request(
                    tctx, t_arrive_wall or t_sent_wall, time.time(),
                    status=status, deployment=dep)
        return "close"

    def _respond(self, writer, code: int, payload, close: bool = False,
                 headers: Optional[Dict[str, str]] = None):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large",
                  431: "Request Header Fields Too Large",
                  500: "Internal Server Error",
                  503: "Service Unavailable", 504: "Gateway Timeout"}
        if isinstance(payload, (bytes, bytearray)):
            body = bytes(payload)
            ctype = "application/octet-stream"
        else:
            # JSON-in/JSON-out surface: strings too ride as JSON so
            # clients can round-trip any handler return value.
            body = json.dumps(payload).encode()
            ctype = "application/json"
        conn = "Connection: close\r\n" if close else ""
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (headers or {}).items())
        head = (f"HTTP/1.1 {code} {reason.get(code, 'OK')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n{conn}{extra}"
                f"\r\n").encode()
        writer.write(head + body)
