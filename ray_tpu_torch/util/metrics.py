"""Metrics: user-facing Counter/Gauge/Histogram + Prometheus export.

Analog of the reference's metrics pipeline (reference:
python/ray/util/metrics.py for the user API, _private/metrics_agent.py +
OpenCensus export for the scrape path), collapsed to one dependency-free
layer: metrics live in a process-global registry; an asyncio HTTP
endpoint renders the Prometheus text format on demand. Components can
also register scrape-time collectors (e.g. the node agent contributes
live lease/object-store gauges without bookkeeping on the hot path).

The port's copy of ``ray_tpu/util/metrics.py``, unchanged but for
import paths.
"""

from __future__ import annotations

import asyncio
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}
_COLLECTORS: List[Callable[[], str]] = []
# Remote snapshots pushed by worker processes (push_loop -> control
# "report_metrics" -> merge_remote): source -> (received_at, text).
_REMOTE: Dict[str, Tuple[float, str]] = {}
_REMOTE_TTL_S = 60.0   # a dead worker's last snapshot ages out


def _labels_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{str(v).replace(chr(34), chr(39))}"'
                     for k, v in key)
    return "{" + inner + "}"


def _fmt_val(v: float) -> str:
    """Full-precision sample rendering. %g's 6 significant digits
    silently drop counter increments past ~1e6 — a worker-pushed
    serve_requests_total at 1e7 renders '1e+07' before AND after 40
    more requests, so the head's time-series deltas (and the
    availability burn rates on them) would read 0. Integral floats
    render as integers, everything else via repr (shortest exact)."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[tuple, float] = {}
        with _LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None:
                if type(existing) is not type(self):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}")
                # Same name+type from another module: share storage so
                # neither instance's increments are lost.
                self._values = existing._values
            _REGISTRY[name] = self

    def _set(self, key: tuple, value: float):
        with _LOCK:
            self._values[key] = value

    def _add(self, key: tuple, delta: float):
        with _LOCK:
            self._values[key] = self._values.get(key, 0.0) + delta

    def render(self, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        """Prometheus text. ``extra`` label pairs are merged into every
        sample (the push path stamps node/worker identity this way)."""
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} {self.kind}"]
        with _LOCK:
            items = list(self._values.items())
        for key, v in items:
            lines.append(
                f"{self.name}{_fmt_labels(extra + key)} {_fmt_val(v)}")
        return "\n".join(lines)


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        self._add(_labels_key(tags), value)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[dict] = None):
        self._set(_labels_key(tags), float(value))

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        self._add(_labels_key(tags), value)

    def dec(self, value: float = 1.0, tags: Optional[dict] = None):
        self._add(_labels_key(tags), -value)


class Histogram(Metric):
    """Fixed-boundary histogram rendered in Prometheus cumulative form.

    Exemplars: ``observe(..., exemplar=<trace id>)`` keeps the LAST
    exemplar per bucket and rendering appends it OpenMetrics-style
    (``... # {trace_id="..."} <value> <ts>``) — a p99 bucket links to a
    concrete request trace (`ray-tpu trace <id>`) instead of being an
    anonymous count. Exemplar tails are not legal in the classic
    Prometheus text format, so the /metrics endpoint strips them
    unless the caller opts in with ``?exemplars=1`` (see
    strip_exemplars / MetricsServer) — internally they always render,
    which is how the worker push path carries them to the head."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (.005, .01, .025, .05, .1,
                                                .25, .5, 1, 2.5, 5, 10),
                 tag_keys: Sequence[str] = ()):
        with _LOCK:
            existing = _REGISTRY.get(name)
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(sorted(boundaries))
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        # labels key -> {bucket index: (exemplar id, value, ts)}
        self._exemplars: Dict[tuple, Dict[int, tuple]] = {}
        if isinstance(existing, Histogram) \
                and existing.boundaries == self.boundaries:
            self._counts = existing._counts
            self._sums = existing._sums
            self._exemplars = existing._exemplars

    def observe(self, value: float, tags: Optional[dict] = None,
                exemplar: Optional[str] = None):
        key = _labels_key(tags)
        with _LOCK:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            if exemplar:
                self._exemplars.setdefault(key, {})[i] = (
                    str(exemplar), value, time.time())

    def render(self, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} histogram"]
        with _LOCK:
            items = [(k, list(c), self._sums.get(k, 0.0),
                      dict(self._exemplars.get(k) or ()))
                     for k, c in self._counts.items()]
        for key, counts, total, exemplars in items:
            key = extra + key
            cum = 0
            for i, (b, c) in enumerate(zip(self.boundaries, counts)):
                cum += c
                lk = key + (("le", f"{b:g}"),)
                ex = exemplars.get(i)
                tail = (f' # {{trace_id="{ex[0]}"}} {ex[1]:g} '
                        f"{ex[2]:.3f}") if ex else ""
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(lk)} {cum}{tail}")
            cum += counts[-1]
            lk = key + (("le", "+Inf"),)
            ex = exemplars.get(len(self.boundaries))
            tail = (f' # {{trace_id="{ex[0]}"}} {ex[1]:g} '
                    f"{ex[2]:.3f}") if ex else ""
            lines.append(
                f"{self.name}_bucket{_fmt_labels(lk)} {cum}{tail}")
            lines.append(
                f"{self.name}_sum{_fmt_labels(key)} {_fmt_val(total)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {cum}")
        return "\n".join(lines)


_STATE_FETCHERS: List[Callable] = []


def register_state_fetcher(fn: Callable) -> None:
    """Register an async `fetch(method, **kw)` that proxies control
    RPCs to the head — the dashboard's data source (the node agent
    registers one; any agent in the process can serve every page)."""
    with _LOCK:
        _STATE_FETCHERS.append(fn)


def unregister_state_fetcher(fn: Callable) -> None:
    with _LOCK:
        try:
            _STATE_FETCHERS.remove(fn)
        except ValueError:
            pass


def _state_fetchers() -> List[Callable]:
    """Newest first: a prior test/session's dead agent may not have
    unregistered; the most recently registered fetcher is the one whose
    cluster is actually alive."""
    with _LOCK:
        return list(reversed(_STATE_FETCHERS))


def register_collector(fn: Callable[[], str]) -> None:
    """Add a scrape-time text producer (already Prometheus-formatted)."""
    with _LOCK:
        _COLLECTORS.append(fn)


def unregister_collector(fn: Callable[[], str]) -> None:
    with _LOCK:
        try:
            _COLLECTORS.remove(fn)
        except ValueError:
            pass


# An exemplar tail as Histogram.render emits it: ` # {labels} value
# [ts]`. The classic Prometheus text format (0.0.4) permits only an
# optional timestamp after the value — a stock scraper REJECTS the
# whole scrape on the '#'. The serving endpoint strips these unless
# the client negotiated OpenMetrics; stripping at the ONE serving
# boundary also covers worker-pushed snapshot text, which is rendered
# remotely (with exemplars) before the scraper's Accept is known.
_EXEMPLAR_TAIL_RE = re.compile(
    r" # \{[^}]*\} \S+( \d+(\.\d+)?)?$", re.MULTILINE)


def strip_exemplars(text: str) -> str:
    """Drop exemplar tails from rendered metric text (classic
    Prometheus text-format compatibility)."""
    return _EXEMPLAR_TAIL_RE.sub("", text)


def render_all() -> str:
    with _LOCK:
        metrics = list(_REGISTRY.values())
        collectors = list(_COLLECTORS)
        now = time.time()
        remote = [(src, text) for src, (ts, text) in
                  sorted(_REMOTE.items()) if now - ts < _REMOTE_TTL_S]
    parts = [m.render() for m in metrics]
    for fn in collectors:
        try:
            parts.append(fn())
        except Exception as e:  # noqa: BLE001 — one bad collector
            parts.append(f"# collector error: {e!r}")
    for src, text in remote:
        parts.append(f"# pushed from {src}\n{text}")
    return "\n".join(p for p in parts if p) + "\n"


# --- head aggregation (push path) -------------------------------------
# Worker processes have no scrape endpoint of their own; instead each
# runs push_loop, periodically shipping its registry (samples labelled
# with node/worker identity) to the control service, which stores the
# text via merge_remote — the head /metrics endpoint then serves
# cluster-wide series (the reference ships OpenCensus points from every
# worker to the per-node metrics agent the same way,
# _private/metrics_agent.py).


def render_labeled(labels: Optional[dict]) -> str:
    """This process's registry rendered with ``labels`` merged into
    every sample. Samples only — no HELP/TYPE comment lines and no
    collectors: the receiving head renders its own comments, and
    collector text already carries node identity."""
    extra = _labels_key(labels)
    with _LOCK:
        metrics = list(_REGISTRY.values())
    parts = []
    for m in metrics:
        body = "\n".join(line for line in m.render(extra).splitlines()
                         if not line.startswith("#"))
        if body:
            parts.append(body)
    return "\n".join(parts)


def merge_remote(source: str, text: str) -> None:
    """Store one pushed snapshot (latest wins per source). Called by
    the control service's ``report_metrics`` handler. Expired sources
    are evicted here so worker churn can't grow the head's map
    unboundedly (render only filters; this is the reclaim)."""
    now = time.time()
    with _LOCK:
        _REMOTE[source] = (now, text)
        dead = [s for s, (ts, _) in _REMOTE.items()
                if now - ts >= _REMOTE_TTL_S]
        for s in dead:
            del _REMOTE[s]


async def push_once(call, source: str,
                    labels: Optional[dict]) -> bool:
    """Render-and-push one snapshot (the push_loop body, and the FINAL
    flush a worker's graceful shutdown performs so a short-lived
    worker's last counters aren't silently lost from head aggregation
    — see runtime/worker.py shutdown_worker). Returns True when a
    snapshot was actually sent."""
    text = render_labeled(labels)
    if not text:
        return False
    await call("report_metrics", source=source, text=text)
    return True


async def push_loop(call, source: str, labels: Optional[dict],
                    interval_s: float = 5.0) -> None:
    """Periodically push this process's metric samples to the head.
    ``call`` is an async fn(method, **kw) that issues a control RPC
    (workers pass a pool.call closure bound to the head address)."""
    interval_s = max(0.25, float(interval_s))
    while True:
        await asyncio.sleep(interval_s)
        try:
            await push_once(call, source, labels)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass  # head briefly unreachable: next tick retries


def snapshot() -> Dict[str, float]:
    """Current scalar value per metric name (values summed over label
    sets) — the dashboard's history sampler reads this."""
    out: Dict[str, float] = {}
    with _LOCK:
        for m in _REGISTRY.values():
            if getattr(m, "kind", "") == "histogram":
                continue  # no single scalar value
            try:
                out[m.name] = float(sum(m._values.values()))
            except (AttributeError, TypeError):
                continue
    return out


def reset() -> None:
    """Test hook: drop all metrics, collectors, and dashboard history."""
    with _LOCK:
        _REGISTRY.clear()
        _COLLECTORS.clear()
        _REMOTE.clear()
    from ray_tpu_torch.util import dashboard
    dashboard.clear_history()


_DASH_HTML = b"""<!doctype html><html><head><title>ray-tpu</title>
<style>body{font-family:monospace;margin:2em;background:#111;color:#ddd}
h1{font-size:1.2em}table{border-collapse:collapse;margin-top:1em}
td,th{border:1px solid #444;padding:4px 10px;text-align:left}
th{background:#222}.num{text-align:right}</style></head><body>
<h1>ray-tpu cluster</h1><div id=t>loading...</div>
<script>
async function tick(){
  const r = await fetch('/metrics'); const text = await r.text();
  const rows = [];
  for (const line of text.split('\\n')) {
    if (!line || line.startsWith('#')) continue;
    const i = line.lastIndexOf(' ');
    rows.push([line.slice(0, i), line.slice(i + 1)]);
  }
  rows.sort((a, b) => a[0] < b[0] ? -1 : 1);
  const esc = s => s.replace(/&/g, '&amp;').replace(/</g, '&lt;')
                    .replace(/>/g, '&gt;');
  document.getElementById('t').innerHTML =
    '<table><tr><th>metric</th><th>value</th></tr>' +
    rows.map(r => `<tr><td>${esc(r[0])}</td>` +
                  `<td class=num>${esc(r[1])}</td></tr>`)
        .join('') + '</table>';
}
tick(); setInterval(tick, 2000);
</script></body></html>"""


def _wants_param(query: Optional[str], name: str) -> bool:
    """True for an actually-truthy query parameter (?name=1) —
    substring matching would misroute ?name=0 or params that merely
    contain the name (?dropexemplars=1)."""
    from urllib.parse import parse_qs
    v = parse_qs(query or "").get(name, [""])[0]
    return v.lower() not in ("", "0", "false", "no")


def _wants_json(query: Optional[str]) -> bool:
    return _wants_param(query, "json")


class MetricsServer:
    """Minimal asyncio HTTP endpoint serving /metrics, /healthz, and a
    live dashboard at /."""

    def __init__(self):
        self._server: Optional[asyncio.AbstractServer] = None
        self.addr: Optional[Tuple[str, int]] = None
        self._sampler: Optional[asyncio.Task] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._server = await asyncio.start_server(self._on_conn, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        if self._sampler is None:
            self._sampler = asyncio.ensure_future(self._history_loop())
        return self.addr

    async def _history_loop(self):
        """Feed the dashboard's time-series ring: one cluster-state +
        metric-snapshot sample per export interval (the reference
        provisions Prometheus/Grafana for history; here a bounded
        in-process ring serves /history directly)."""
        from ray_tpu_torch.config import get_config
        from ray_tpu_torch.util import dashboard
        interval = max(0.25, get_config().metrics_export_interval_s)
        while True:
            await asyncio.sleep(interval)
            try:
                await dashboard.record_sample(_state_fetchers())
            except Exception:
                pass  # sampling must never kill the server

    async def stop(self):
        if self._sampler is not None:
            self._sampler.cancel()
            try:
                await self._sampler
            except (asyncio.CancelledError, Exception):
                pass
            self._sampler = None
            # this server's cluster is going away: a later cluster in
            # the same process must not inherit its history or its
            # workers' pushed snapshots
            from ray_tpu_torch.util import dashboard
            dashboard.clear_history()
            with _LOCK:
                _REMOTE.clear()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except Exception:
                pass

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter):
        try:
            req = await asyncio.wait_for(reader.readline(), 10.0)
            path = req.split()[1].decode() if len(req.split()) > 1 else "/"
            path, _, query = path.partition("?")
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), 10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            if path.startswith("/metrics"):
                # exemplar tails use OpenMetrics syntax the classic
                # text format does not permit — a stock Prometheus
                # scrape would reject EVERY sample over the '#'. The
                # default scrape is therefore always stripped;
                # ?exemplars=1 is the explicit human/tooling opt-in
                # (we deliberately do NOT negotiate on Accept: stock
                # Prometheus advertises openmetrics-text by default,
                # and this endpoint's counter naming — family name ==
                # sample name, lint-suffixed `_total` — is not strict
                # OpenMetrics, so claiming that content type would
                # break the scrape we just protected).
                text = render_all()
                if not _wants_param(query, "exemplars"):
                    text = strip_exemplars(text)
                body = text.encode()
                ctype = "text/plain; version=0.0.4"
                code = "200 OK"
            elif path.startswith("/healthz"):
                body, ctype, code = b"ok\n", "text/plain", "200 OK"
            elif path.rstrip("/") == "/health" \
                    and _wants_json(query):
                # machine-readable health snapshot (?json=1): the SLO
                # engine's full state — objectives, burn rates, active
                # alerts, sentinels, and the per-deployment
                # ``burn_advice`` map that is the input contract for
                # SLO-driven replica autoscaling (ROADMAP item 3).
                # Bare /health (below) renders the human dashboard.
                import json as _json
                from ray_tpu_torch.util import health as _health
                state = None
                for fetch in _state_fetchers():
                    try:
                        state = await fetch("health_state")
                        break
                    except Exception:
                        continue
                if state is None:    # no agent in this process: local
                    state = _health.local_state()
                body = (_json.dumps(state, default=str) + "\n").encode()
                ctype, code = "application/json", "200 OK"
            elif path.startswith("/raw"):
                # the original metric-table page, kept at /raw
                body, ctype, code = _DASH_HTML, "text/html", "200 OK"
            else:
                # server-rendered cluster dashboard (nodes/actors/jobs/
                # pgs/serve/tasks off the control-plane state API)
                from ray_tpu_torch.util import dashboard
                page = await dashboard.render(path, _state_fetchers(),
                                              query)
                if page is not None:
                    body, ctype, code = page, "text/html", "200 OK"
                else:
                    body, ctype, code = b"not found\n", "text/plain", \
                        "404 Not Found"
            writer.write(
                f"HTTP/1.1 {code}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n".encode() + body)
            await writer.drain()
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass


# One MetricsServer per process: render_all() serves the process-global
# registry, so control service + agent(s) sharing a process share one
# endpoint (a fixed port would otherwise EADDRINUSE on the head node).
_SRV: Optional[MetricsServer] = None
_SRV_REFS = 0


async def acquire_shared_server(host: str, port: int) -> Tuple[str, int]:
    global _SRV, _SRV_REFS
    if _SRV is None:
        srv = MetricsServer()
        await srv.start(host, port)
        _SRV = srv
    _SRV_REFS += 1
    return _SRV.addr


async def release_shared_server() -> None:
    global _SRV, _SRV_REFS
    _SRV_REFS -= 1
    if _SRV_REFS <= 0 and _SRV is not None:
        srv, _SRV, _SRV_REFS = _SRV, None, 0
        await srv.stop()


def core_metric(kind: str, name: str, desc: str) -> Metric:
    """Get-or-create a runtime-internal metric (idempotent across
    re-inits, safe after a test `reset()`)."""
    m = _REGISTRY.get(name)
    if m is None:
        cls = {"counter": Counter, "gauge": Gauge,
               "histogram": Histogram}[kind]
        m = cls(name, desc)
    return m
