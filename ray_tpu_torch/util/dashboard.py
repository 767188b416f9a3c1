"""Server-rendered cluster dashboard.

The capability analog of the reference's dashboard (reference:
python/ray/dashboard/head.py:49 module system +
dashboard/modules/{node,actor,job,serve,state} + a React client),
collapsed TPU-first: the cluster state already lives in the control
service's tables, so the dashboard is a handful of HTML renderers over
the same RPCs the state API uses — no build step, no JS framework, one
process. Pages: / (overview), /nodes, /actors, /jobs, /pgs, /serve,
/tasks (recent spans off the tracing archive), /traces (sampled
request traces), /devices (per-device HBM / duty cycle / XLA compile
aggregates off util/devmon.py's device events).

Served by util.metrics.MetricsServer on every node's metrics port; the
node agent registers a `fetch` callable that proxies to the head.

The port's copy of ``ray_tpu/util/dashboard.py``, unchanged but for
import paths; /devices reads the device events the port's
``util/devmon.py`` records from ``torch.cuda`` (the compile rows are
its nvcc builds).
"""

from __future__ import annotations

import html
import time
from typing import Awaitable, Callable, List, Optional, Sequence

Fetch = Callable[..., Awaitable]

_STYLE = """
body{font-family:system-ui,sans-serif;margin:2em;background:#14161a;
     color:#d7dae0}
h1{font-size:1.3em} h2{font-size:1.05em;margin-top:1.4em}
a{color:#7ab7ff;text-decoration:none} a:hover{text-decoration:underline}
nav a{margin-right:1.2em}
table{border-collapse:collapse;margin-top:.6em;font-size:.92em}
td,th{border:1px solid #3a3f46;padding:4px 10px;text-align:left}
th{background:#20242a} .num{text-align:right}
.ok{color:#7dd87d} .bad{color:#ff7a7a} .dim{color:#8a8f98}
.pill{padding:1px 8px;border-radius:9px;background:#2a2f36}
"""

_NAV = ("<nav><a href='/'>overview</a><a href='/nodes'>nodes</a>"
        "<a href='/actors'>actors</a><a href='/jobs'>jobs</a>"
        "<a href='/pgs'>placement groups</a><a href='/serve'>serve</a>"
        "<a href='/tasks'>tasks</a><a href='/traces'>traces</a>"
        "<a href='/devices'>devices</a>"
        "<a href='/goodput'>goodput</a>"
        "<a href='/health'>health</a>"
        "<a href='/history'>history</a>"
        "<a href='/profile'>profile</a>"
        "<a href='/autopsy'>autopsy</a>"
        "<a href='/metrics'>metrics</a></nav>")


def _esc(v) -> str:
    return html.escape(str(v))


def _page(title: str, body: str, refresh: bool = True) -> bytes:
    # refresh=False for pages whose render has side effects (a profile
    # sample) — a forgotten tab must not re-trigger them every 5s
    meta = "<meta http-equiv='refresh' content='5'>" if refresh else ""
    return (f"<!doctype html><html><head><title>ray-tpu: {_esc(title)}"
            f"</title><style>{_STYLE}</style>"
            f"{meta}</head>"
            f"<body><h1>ray-tpu &mdash; {_esc(title)}</h1>{_NAV}"
            f"{body}</body></html>").encode()


def _table(headers: Sequence[str], rows: List[Sequence]) -> str:
    if not rows:
        return "<p class=dim>(none)</p>"
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _res(r: dict) -> str:
    return _esc(", ".join(f"{k}={v:g}" for k, v in sorted(
        (r or {}).items()))) or "<span class=dim>-</span>"


def _hex(v) -> str:
    return v.hex() if hasattr(v, "hex") else str(v)


def _state(s, good=("ALIVE", "CREATED", "RUNNING", "SUCCEEDED")) -> str:
    cls = "ok" if s in good else ("dim" if s in ("PENDING",) else "bad")
    return f"<span class={cls}>{_esc(s)}</span>"


# --- pages -------------------------------------------------------------


async def _overview(fetch: Fetch, query: str = "") -> bytes:
    nodes = await fetch("get_nodes")
    actors = await fetch("list_actors")
    jobs = await fetch("list_jobs")
    pgs = await fetch("list_pgs")
    alive, total, avail = _aggregate_resources(nodes)
    by_state: dict = {}
    for a in actors:
        if a:
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    res_rows = [(_esc(k), f"{avail.get(k, 0):g}", f"{total[k]:g}")
                for k in sorted(total)]
    body = (
        f"<h2>cluster</h2>"
        f"<p><span class=pill>{len(alive)} / {len(nodes)} nodes alive"
        f"</span> <span class=pill>{len(actors)} actors</span> "
        f"<span class=pill>{len(jobs)} jobs</span> "
        f"<span class=pill>{len(pgs)} placement groups</span></p>"
        f"<h2>resources (available / total)</h2>"
        + _table(("resource", "available", "total"), res_rows)
        + "<h2>actors by state</h2>"
        + _table(("state", "count"),
                 [(_state(s), str(c))
                  for s, c in sorted(by_state.items())]))
    return _page("overview", body)


async def _nodes(fetch: Fetch, query: str = "") -> bytes:
    nodes = await fetch("get_nodes")
    rows = []
    for n in sorted(nodes, key=lambda x: not x["alive"]):
        rows.append((
            _esc(_hex(n["node_id"])[:12]),
            _esc(f"{n['addr'][0]}:{n['addr'][1]}"
                 if isinstance(n.get("addr"), (tuple, list))
                 else n.get("addr", "-")),
            _state("ALIVE" if n["alive"] else "DEAD"),
            _res(n.get("resources_available")),
            _res(n.get("resources_total")),
            _esc(", ".join(f"{k}={v}" for k, v in
                           (n.get("labels") or {}).items()) or "-"),
        ))
    return _page("nodes", _table(
        ("node", "address", "state", "available", "total", "labels"),
        rows))


async def _actors(fetch: Fetch, query: str = "") -> bytes:
    actors = [a for a in await fetch("list_actors") if a]
    rows = []
    order = {"ALIVE": 0, "RESTARTING": 1, "PENDING": 2, "DEAD": 3}
    for a in sorted(actors, key=lambda x: order.get(x["state"], 9)):
        rows.append((
            _esc(_hex(a["actor_id"])[:12]),
            _esc(a.get("name") or "-"),
            _esc(a.get("class_name") or "-"),
            _state(a["state"]),
            _esc(_hex(a["node_id"])[:12] if a.get("node_id") else "-"),
            str(a.get("num_restarts", 0)),
            _esc(a.get("death_cause") or ""),
        ))
    return _page("actors", _table(
        ("actor", "name", "class", "state", "node", "restarts",
         "death cause"), rows))


async def _jobs(fetch: Fetch, query: str = "") -> bytes:
    jobs = await fetch("list_jobs")
    sub = await fetch("list_submitted_jobs")
    rows = [(_esc(_hex(j["job_id"])[:12]), _state(j["state"]),
             _esc(time.strftime("%H:%M:%S",
                                time.localtime(j.get("start_time", 0)))))
            for j in jobs]
    srows = [(_esc(j["submission_id"]), _esc(j.get("entrypoint", ""))[:80],
              _state(j.get("status", "?")),
              _esc(j.get("log_path", "")))
             for j in sub]
    body = ("<h2>driver jobs</h2>"
            + _table(("job", "state", "started"), rows)
            + "<h2>submitted jobs</h2>"
            + _table(("submission", "entrypoint", "status", "log"),
                     srows))
    return _page("jobs", body)


async def _pgs(fetch: Fetch, query: str = "") -> bytes:
    pgs = await fetch("list_pgs")
    rows = []
    for p in pgs:
        if not p:
            continue
        nodes = {_hex(n)[:12] for n in (p.get("bundle_nodes") or [])
                 if n is not None}
        rows.append((
            _esc(_hex(p["pg_id"])[:12]),
            _esc(p.get("name") or "-"),
            _state(p["state"]),
            _esc(p.get("strategy", "")),
            str(len(p.get("bundles") or [])),
            _esc(", ".join(sorted(nodes)) or "-"),
        ))
    return _page("placement groups", _table(
        ("pg", "name", "state", "strategy", "bundles", "nodes"), rows))


async def _serve(fetch: Fetch, query: str = "") -> bytes:
    """Serve view derived from the actor table: deployments are the
    SERVE_REPLICA:<dep>:<rid> groups, the control plane is the
    SERVE_CONTROLLER/SERVE_PROXY actors."""
    actors = [a for a in await fetch("list_actors") if a]
    deps: dict = {}
    plane = []
    for a in actors:
        name = a.get("name") or ""
        if name.startswith("SERVE_REPLICA:"):
            _, dep, rid = name.split(":", 2)
            deps.setdefault(dep, []).append((rid, a))
        elif name.startswith("SERVE_"):
            plane.append((name, a))
    rows = []
    for dep, reps in sorted(deps.items()):
        n_alive = sum(1 for _, a in reps if a["state"] == "ALIVE")
        rows.append((
            _esc(dep), f"{n_alive} / {len(reps)}",
            ", ".join(
                f"{_esc(rid)}&nbsp;{_state(a['state'])}"
                for rid, a in sorted(reps)),
        ))
    prows = [(_esc(n), _state(a["state"]),
              _esc(_hex(a["node_id"])[:12] if a.get("node_id") else "-"))
             for n, a in sorted(plane)]
    body = ("<h2>deployments</h2>"
            + _table(("deployment", "alive replicas", "replicas"), rows)
            + "<h2>control plane</h2>"
            + _table(("actor", "state", "node"), prows))
    # SLO autoscaler actuation (serve/autoscale.py): last replica
    # target + recent decisions per deployment off the head
    # time-series store (absent when the health plane is off or
    # nothing autoscales)
    try:
        arows = []
        for dep in sorted(deps):
            sel = {"deployment": dep}
            reps = await fetch("query_series",
                               name="serve_autoscale_replicas",
                               since_s=900.0, labels=sel)
            pts = (reps or {}).get("points") or []
            if not pts:
                continue
            decs = await fetch("query_series",
                               name="serve_autoscale_decisions_total",
                               since_s=900.0, labels=sel)
            n_dec = sum(p.get("inc", 0)
                        for p in (decs or {}).get("points") or [])
            arows.append((_esc(dep), str(int(pts[-1].get("value", 0))),
                          str(int(n_dec))))
        if arows:
            body += ("<h2>slo autoscaler</h2>"
                     + _table(("deployment", "target replicas",
                               "decisions (15m)"), arows))
    except Exception:
        pass
    return _page("serve", body)


async def _tasks(fetch: Fetch, query: str = "") -> bytes:
    """Recent task/actor spans from the cluster timeline (tracing
    archive + live node buffers) — the `ray list tasks` analog."""
    from ray_tpu_torch.util.state import tasks_from_events
    r = await fetch("collect_timeline")
    tasks = tasks_from_events(r.get("events", []), limit=200)
    rows = []
    for t in tasks:
        where = f"{str(t['node_id'] or '')[:8]}/pid {t['pid'] or '?'}"
        rows.append((
            _esc(t["name"]),
            _esc(t["kind"]),
            _esc(where),
            f"{(t['duration_s'] or 0.0) * 1e3:.2f}",
            _esc(time.strftime("%H:%M:%S",
                               time.localtime(t["start_time"] or 0))),
            _state("ok" if not t["error"] else "ERROR", good=("ok",)),
        ))
    body = (f"<p class=dim>newest {len(rows)} task executions. "
            f"Full chrome trace: <code>ray-tpu timeline</code></p>"
            + _table(("task", "kind", "where", "duration (ms)",
                      "started", "status"), rows))
    # collective-plane rounds off the same timeline collection (the
    # `ray-tpu collectives` summary, rendered next to the task lanes)
    from ray_tpu_torch.util.state import collectives_from_events
    crows = []
    for t in collectives_from_events(r.get("events", []), limit=50):
        strag = t["straggler"] if t["straggler"] is not None else "-"
        crows.append((
            _esc(t["kind"]),
            _esc(f"{t['op'] or '-'}/{t['codec'] or 'fp'}"),
            _esc(f"r{t['rank']}/{t['size']}"),
            f"{(t['bytes'] or 0) / 1e6:.2f}",
            f"{(t['duration_s'] or 0.0) * 1e3:.2f}",
            f"{(t['recv_wait_s'] or 0.0) * 1e3:.2f}",
            _esc(strag),
            _esc(t["step"] if t["step"] is not None else "-"),
            _state("ok" if not t["error"] else "ERROR", good=("ok",)),
        ))
    if crows:
        body += ("<h2>collectives</h2>"
                 "<p class=dim>newest ring rounds (dag/ring.py); "
                 "CLI: <code>ray-tpu collectives</code>, per-rank "
                 "lanes: <code>ray-tpu timeline</code></p>"
                 + _table(("round", "op/codec", "rank", "MB",
                           "round (ms)", "recv-wait (ms)", "straggler",
                           "step", "status"), crows))
    return _page("tasks", body)


async def _traces(fetch: Fetch, query: str = "") -> bytes:
    """Recent SAMPLED request traces (tail-based keep at the proxy:
    every error/deadline/slow trace plus a trace_sample_rate fraction
    of healthy ones), errors first then slowest first — the entry
    point into `ray-tpu trace <id>` waterfalls."""
    from urllib.parse import parse_qs

    from ray_tpu_torch.util.state import summarize_traces, traces_from_events
    r = await fetch("collect_timeline")
    evs = r.get("events", [])
    q = parse_qs(query or "")
    tid = (q.get("trace") or [""])[0]
    if tid:
        # one trace drilled open: its spans, oldest first
        from ray_tpu_torch.util.tracing import filter_trace
        spans = sorted(
            (e for e in filter_trace(evs, tid)
             if e.get("cat") == "request"),
            key=lambda e: e.get("ts", 0.0))
        rows = []
        for e in spans:
            rows.append((
                _esc(e.get("component", "?")),
                _esc(e.get("seg", "?")),
                f"{(e.get('dur') or 0.0) * 1e3:.2f}",
                _esc(time.strftime("%H:%M:%S",
                                   time.localtime(e.get("ts") or 0))),
                _esc(f"{str(e.get('node', ''))[:8]}/pid "
                     f"{e.get('pid', '?')}"),
                _state("ok" if not e.get("error") else "ERROR",
                       good=("ok",)),
            ))
        body = (f"<p class=dim>trace <code>{_esc(tid)}</code> — "
                f"{len(rows)} spans; waterfall: <code>ray-tpu trace "
                f"{_esc(tid)}</code></p>"
                + _table(("component", "segment", "duration (ms)",
                          "started", "where", "status"), rows))
        return _page(f"trace {tid[:12]}", body)
    rows_in = traces_from_events(evs, limit=100)
    s = summarize_traces(rows_in)
    rows = []
    for t in rows_in:
        rows.append((
            f"<a href='/traces?trace={_esc(t['trace_id'])}'>"
            f"{_esc(t['trace_id'][:16])}</a>",
            _state(t.get("status") or "?", good=("ok",)),
            _esc(t.get("keep") or "-"),
            _esc(t.get("deployment") or "-"),
            f"{(t['duration_s'] or 0.0) * 1e3:.1f}",
            str(t["spans"]),
            _esc(",".join(t["components"])),
            _esc(time.strftime(
                "%H:%M:%S", time.localtime(t["start_time"] or 0))),
        ))
    body = (f"<p class=dim>{s['traces']} sampled traces "
            f"({s['errors']} errors; errors first, then slowest; "
            f"mean {s['mean_duration_s'] * 1e3:.1f} ms, max "
            f"{s['max_duration_s'] * 1e3:.1f} ms). Waterfall: "
            f"<code>ray-tpu trace &lt;id&gt;</code></p>"
            + _table(("trace", "status", "kept", "deployment",
                      "duration (ms)", "spans", "components",
                      "started"), rows))
    return _page("traces", body)


async def _devices(fetch: Fetch, query: str = "") -> bytes:
    """Device-plane view (util/devmon.py events off the cluster
    timeline): per-device HBM occupancy + duty cycle, XLA compile
    aggregates per function, and recompile-storm flags — the
    accelerator lane the host profiler and request traces can't see."""
    from ray_tpu_torch.util.state import devices_from_events, summarize_devices
    r = await fetch("collect_timeline")
    s = summarize_devices(devices_from_events(r.get("events", [])))
    body = ""
    if s["storms"]:
        flags = "; ".join(
            f"{_esc(st['fn'])}: {st['count']} compiles in "
            f"{st['window_s']:g}s" for st in s["storms"][:5])
        body += (f"<p class=bad>recompile storm(s) flagged &mdash; "
                 f"{flags}</p>")
    drows = []
    for d in s["devices"]:
        lim = f"{(d['limit'] or 0) / 1e9:.2f}" if d["limit"] else "?"
        drows.append((
            _esc(d["device"]),
            _esc(f"{str(d['node_id'] or '')[:8]}/pid "
                 f"{d['pid'] or '?'}"),
            f"{(d['used'] or 0) / 1e6:.2f}",
            lim,
            f"{(d['peak'] or 0) / 1e6:.2f}",
            f"{(d['duty'] or 0.0) * 100:.1f}%",
            _esc(d["source"] or "-"),
            _esc(time.strftime("%H:%M:%S",
                               time.localtime(d["start_time"] or 0))),
        ))
    body += ("<h2>devices</h2>"
             "<p class=dim>latest per-device snapshot; CLI: "
             "<code>ray-tpu devices</code></p>"
             + _table(("device", "where", "HBM used (MB)",
                       "limit (GB)", "peak (MB)", "duty cycle",
                       "source", "sampled"), drows))
    crows = []
    for c in s["compiles"]:
        crows.append((
            _esc(c["fn"])[:60],
            str(c["compiles"]),
            str(c["recompiles"]),
            str(c["cache_hits"]),
            f"{c['mean_s'] * 1e3:.2f}",
            f"{c['max_s'] * 1e3:.2f}",
            _esc(time.strftime("%H:%M:%S",
                               time.localtime(c["last_time"] or 0))),
        ))
    body += ("<h2>XLA compiles</h2>"
             "<p class=dim>per jitted function; a traced request's "
             "compile shows as a <code>dev:compile</code> lane in "
             "<code>ray-tpu trace &lt;id&gt;</code></p>"
             + _table(("function", "compiles", "recompiles",
                       "cache hits", "mean (ms)", "max (ms)", "last"),
                      crows))
    return _page("devices", body)


async def _goodput(fetch: Fetch, query: str = "") -> bytes:
    """Goodput ledger view (util/goodput.py events off the cluster
    timeline): one stacked per-rank step-anatomy bar (compute /
    comm_exposed / bubble / ckpt_stall / compile / idle — categories
    sum to step wall by the ledger's identity), the derived goodput
    fraction, the train_mfu trend, and the straggler verdict."""
    from ray_tpu_torch.util.state import goodput_from_events
    r = await fetch("collect_timeline")
    rows = goodput_from_events(r.get("events", []))
    body = ""
    straggler = None
    mfu_vals: list = []
    try:
        qs = await fetch("query_series", name="goodput_straggler_rank",
                         since_s=900.0)
        pts = qs.get("points") or []
        if pts:
            # newest sample, not the window mean — see cmd_goodput
            v = pts[-1].get("last", pts[-1].get("value"))
            if v is not None:
                straggler = int(v)
        qm = await fetch("query_series", name="train_mfu",
                         since_s=900.0)
        mfu_vals = [p.get("value") for p in (qm.get("points") or [])]
    except Exception:   # noqa: BLE001 — anatomy renders without trends
        pass
    if straggler is not None and straggler >= 0:
        body += (f"<p class=bad>straggler flagged &mdash; rank "
                 f"{straggler}'s p50 step anatomy diverges beyond "
                 f"goodput_straggler_z</p>")
    if not rows:
        body += ("<p class=dim>no goodput events yet (is "
                 "<code>goodput_level=off</code>, or has no "
                 "<code>trace_step</code>-wrapped train loop run?)"
                 "</p>")
        return _page("goodput", body)
    cats = ("compute", "comm_exposed", "bubble", "ckpt_stall",
            "compile", "idle")
    colors = {"compute": "#2a4", "comm_exposed": "#e63",
              "bubble": "#fa0", "ckpt_stall": "#a4e",
              "compile": "#49e", "idle": "#bbb"}
    grows = []
    for row in rows:
        wall = row["mean_wall_s"]
        bar = "<span style='display:inline-block;width:240px'>"
        for c in cats:
            frac = (row[f"mean_{c}_s"] / wall) if wall > 0 else 0.0
            w = int(round(frac * 240))
            if w > 0:
                bar += (f"<span title='{_esc(c)}' style='display:"
                        f"inline-block;height:12px;width:{w}px;"
                        f"background:{colors[c]}'></span>")
        bar += "</span>"
        grows.append((
            _esc(str(row["rank"])), str(row["steps"]),
            f"{wall * 1e3:.1f}",
            f"{row['goodput_fraction'] * 100:.1f}%",
            bar,
            f"{row['mean_comm_exposed_s'] * 1e3:.1f}",
            f"{row['mean_bubble_s'] * 1e3:.1f}",
            f"{(row['mfu'] * 100):.1f}%" if row.get("mfu") is not None
            else "-",
        ))
    legend = " ".join(
        f"<span style='background:{colors[c]};padding:0 6px'>"
        f"&nbsp;</span> {c}" for c in cats)
    body += ("<h2>per-rank step anatomy</h2>"
             f"<p class=dim>{legend} &mdash; categories sum to step "
             "wall (the ledger identity); CLI: "
             "<code>ray-tpu goodput</code></p>"
             + _table(("rank", "steps", "wall (ms)", "goodput",
                       "anatomy", "comm exposed (ms)", "bubble (ms)",
                       "MFU"), grows))
    if any(v is not None for v in mfu_vals):
        body += "<h2>train_mfu (15m)</h2>" + _spark(mfu_vals)
    return _page("goodput", body)


async def _health(fetch: Fetch, query: str = "") -> bytes:
    """Cluster health plane (util/health.py off the head's time-series
    store): SLO objectives with multi-window burn rates, active
    page/warn alerts (exemplar trace ids link straight into /traces),
    regression sentinels vs HEALTH_BASELINE.json, and sparklines for
    the breaching series. Machine-readable twin: /health?json=1."""
    s = await fetch("health_state")
    if not s.get("enabled"):
        return _page("health",
                     f"<p class=dim>{_esc(s.get('reason', 'health plane disabled'))}</p>")
    tiers = s.get("tiers", {})
    head = (f"<p><span class=pill>{s.get('series', 0)} series</span> "
            f"<span class=pill>{s.get('points_total', 0)} points"
            f"</span> <span class=pill>eval #"
            f"{s.get('eval_count', 0)}</span> "
            + " ".join(
                f"<span class=pill>{_esc(t)}: burn&ge;"
                f"{v['burn_threshold']:g} over {v['windows_s'][0]:g}s"
                f"+{v['windows_s'][1]:g}s</span>"
                for t, v in tiers.items())
            + " <a href='/health?json=1'>json</a></p>")
    body = head
    alerts = s.get("alerts", [])
    if alerts:
        arows = []
        for a in alerts:
            ex = a.get("exemplar")
            arows.append((
                f"<span class=bad>{_esc(a['tier'].upper())}</span>",
                _esc(a["objective"]),
                _esc(time.strftime("%H:%M:%S",
                                   time.localtime(a.get("since") or 0))),
                (f"<a href='/traces?trace={_esc(ex)}'>{_esc(ex[:16])}"
                 f"</a>" if ex else "<span class=dim>-</span>"),
            ))
        body += ("<h2>active alerts</h2>"
                 + _table(("tier", "objective", "since",
                           "exemplar trace"), arows))
    else:
        body += "<p class=ok>no active alerts</p>"

    def _fb(v):
        return ("<span class=dim>-</span>" if v is None
                else ("inf" if v == -1.0 else f"{v:g}"))
    orows = []
    for o in s.get("objectives", []):
        page = (o.get("tiers") or {}).get("page", {})
        warn = (o.get("tiers") or {}).get("warn", {})
        alert = o.get("alert")
        st = ("<span class=bad>PAGE</span>" if alert == "page" else
              "<span class=bad>warn</span>" if alert == "warn" else
              "<span class=ok>ok</span>")
        orows.append((
            st, _esc(o["name"]), _esc(o["kind"]),
            f"<code>{_esc(o.get('metric'))}</code>",
            f"{_fb(page.get('burn_short'))} / "
            f"{_fb(page.get('burn_long'))}",
            f"{_fb(warn.get('burn_short'))} / "
            f"{_fb(warn.get('burn_long'))}",
            _esc(o.get("description") or "-"),
        ))
    body += ("<h2>objectives</h2>"
             "<p class=dim>burn = error-budget consumption rate "
             "(1.0 sustains the SLO exactly); an alert needs BOTH of "
             "its tier's windows over threshold. CLI: "
             "<code>ray-tpu health</code></p>"
             + _table(("state", "objective", "kind", "metric",
                       "page burn (short/long)",
                       "warn burn (short/long)", "description"), orows))
    srows = []
    for t in s.get("sentinels", []):
        srows.append((
            "<span class=bad>REGRESSION</span>" if t.get("breached")
            else "<span class=ok>ok</span>",
            _esc(t["name"]), _esc(t.get("metric")),
            _esc(t.get("stat")),
            "-" if t.get("live") is None else f"{t['live']:g}",
            f"{t.get('baseline', 0):g}",
            "-" if t.get("ratio") is None else f"{t['ratio']:.2f}x",
            f"{t.get('tolerance', 0):g}x",
        ))
    if srows:
        body += ("<h2>regression sentinels</h2>"
                 "<p class=dim>live windows vs the pinned "
                 "HEALTH_BASELINE.json (seeded from the committed "
                 "BENCH_* trajectory)</p>"
                 + _table(("state", "sentinel", "metric", "stat",
                           "live", "baseline", "ratio", "tolerance"),
                          srows))
    # sparklines for the objectives' metrics (history off the head
    # store; reuses the /history SVG renderer)
    seen = []
    for o in s.get("objectives", []):
        m = o.get("metric")
        if m and m not in seen:
            seen.append(m)
    import asyncio as _aio

    from ray_tpu_torch.util.timeseries import DISPLAY_FIELD
    queries = await _aio.gather(
        *[fetch("query_series", name=m, since_s=900.0)
          for m in seen[:6]], return_exceptions=True)
    charts = ""
    for m, q in zip(seen[:6], queries):
        if isinstance(q, BaseException):
            continue    # one transient fetch failure skips ONE chart
        pts = q.get("points") or []
        field = DISPLAY_FIELD.get(q.get("kind"), "value")
        vals = [p.get(field) for p in pts]
        if any(v is not None for v in vals):
            charts += (f"<h2>{_esc(m)} ({_esc(field)}, 15m)</h2>"
                       + _spark(vals))
    if charts:
        body += charts
    return _page("health", body)


# --- time-series history ----------------------------------------------
# The reference provisions Prometheus + Grafana for dashboard history
# (dashboard/modules/metrics/); here a bounded in-process ring sampled
# by MetricsServer._history_loop renders SVG sparklines directly — no
# external TSDB, history depth = maxlen * export interval (~1h at 5s).

from collections import deque as _deque

_HISTORY: "_deque" = _deque(maxlen=720)


def clear_history() -> None:
    """Drop the ring (server stop / metrics.reset): a later cluster in
    this process must not inherit a dead cluster's series."""
    _HISTORY.clear()


def _aggregate_resources(nodes):
    """(alive_nodes, total, available) summed over alive nodes —
    shared by /overview and the history sampler."""
    alive = [n for n in nodes if n["alive"]]
    total: dict = {}
    avail: dict = {}
    for n in alive:
        for k, v in (n.get("resources_total") or {}).items():
            total[k] = total.get(k, 0.0) + v
        for k, v in (n.get("resources_available") or {}).items():
            avail[k] = avail.get(k, 0.0) + v
    return alive, total, avail


async def record_sample(fetchers) -> None:
    """Append one sample of cluster state + local metric counters."""
    from ray_tpu_torch.util import metrics as _m
    sample = {"ts": time.time(), "metrics": _m.snapshot()}
    if callable(fetchers):
        fetchers = [fetchers]
    for fetch in fetchers or []:
        try:
            nodes = await fetch("get_nodes")
            actors = await fetch("list_actors")
        except Exception:
            continue
        alive, total, avail = _aggregate_resources(nodes)
        sample.update(
            nodes_alive=len(alive),
            actors_alive=sum(1 for a in actors
                             if a and a["state"] == "ALIVE"),
            cpu_avail=avail.get("CPU", 0.0),
            cpu_total=total.get("CPU", 0.0))
        break
    _HISTORY.append(sample)


def _spark(points: List[float], w: int = 640, h: int = 90) -> str:
    pts = [p for p in points if p is not None]
    if len(pts) < 2:
        return "<p class=dim>(collecting&hellip;)</p>"
    lo, hi = min(pts), max(pts)
    span = (hi - lo) or 1.0
    n = len(pts)
    poly = " ".join(
        f"{i * (w - 2) / (n - 1) + 1:.1f},"
        f"{h - 8 - (p - lo) * (h - 16) / span:.1f}"
        for i, p in enumerate(pts))
    return (f"<svg width={w} height={h} viewBox='0 0 {w} {h}'>"
            f"<polyline points='{poly}' fill='none' stroke='#7ab7ff' "
            f"stroke-width='1.5'/>"
            f"<text x='2' y='12' fill='#8a8f98' font-size='11'>"
            f"max {hi:g}</text>"
            f"<text x='2' y='{h - 1}' fill='#8a8f98' font-size='11'>"
            f"min {lo:g}</text></svg>")


def _rate(samples: List[dict], name: str) -> List[Optional[float]]:
    """Per-second rate of a cumulative counter between samples."""
    out: List[Optional[float]] = []
    prev = None
    for s in samples:
        cur = (s.get("metrics") or {}).get(name)
        if prev is None or cur is None or prev[1] is None \
                or cur < prev[1] or s["ts"] <= prev[0]:
            out.append(None)
        else:
            out.append((cur - prev[1]) / (s["ts"] - prev[0]))
        prev = (s["ts"], cur)
    return out[1:]


async def _history(fetch: Fetch, query: str = "") -> bytes:
    samples = list(_HISTORY)
    if len(samples) >= 2:
        mins = (samples[-1]["ts"] - samples[0]["ts"]) / 60.0
        head = (f"<p class=dim>{len(samples)} samples spanning "
                f"{mins:.1f} min (newest right)</p>")
    else:
        head = "<p class=dim>collecting&hellip;</p>"
    series = [
        ("nodes alive", [s.get("nodes_alive") for s in samples]),
        ("actors alive", [s.get("actors_alive") for s in samples]),
        ("CPU available", [s.get("cpu_avail") for s in samples]),
        ("tasks submitted /s",
         _rate(samples, "ray_tpu_tasks_submitted_total")),
    ]
    body = head + "".join(
        f"<h2>{_esc(name)}</h2>{_spark(vals)}" for name, vals in series)
    return _page("history", body)


# --- autopsy (hang & desync forensics) ---------------------------------


async def _autopsy(fetch: Fetch, query: str = "") -> bytes:
    """One-click postmortem: ?run=1 triggers the head's autopsy RPC
    (every agent pulls its workers' stacks + collective ledgers, the
    cross-rank audit names the culprit, one bundle lands on the head)
    and renders the findings. The index page just explains + links —
    an autopsy is a cluster-wide fan-out, not something to fire on
    every 5s auto-refresh."""
    from urllib.parse import parse_qs
    q = parse_qs(query or "")
    if (q.get("run") or ["0"])[0] not in ("1", "true"):
        body = (
            "<p>Pulls every rank's thread stacks, collective ledger, "
            "engine state and recent events in one fan-out, runs the "
            "cross-rank stall/desync audit, and writes an atomic "
            "<code>postmortem-&lt;step&gt;.json</code> bundle on the "
            "head.</p>"
            "<p><a href='/autopsy?run=1'><b>run autopsy now</b></a> "
            "&mdash; CLI: <code>ray-tpu autopsy</code></p>"
            "<p class=dim>Tune with <code>forensics_stall_timeout_s"
            "</code> / <code>forensics_dir</code>; the stall watchdog "
            "fires this automatically when a rank's ledger shows a "
            "collective in flight past the timeout. On a badly hung "
            "cluster prefer the CLI &mdash; dashboard fetches carry a "
            "10s RPC timeout.</p>")
        return _page("autopsy", body, refresh=False)
    r = await fetch("autopsy")
    if not isinstance(r, dict):
        return _page("autopsy",
                     f"<p class=bad>autopsy failed: {_esc(repr(r))}"
                     "</p>", refresh=False)
    findings = r.get("findings") or []
    rows = [(f"<span class=bad>{_esc(f.get('kind'))}</span>",
             _esc(f.get("group")), _esc(f.get("seq")),
             _esc(f.get("culprits")), _esc(f.get("detail")))
            for f in findings]
    body = (f"<p>{len(r.get('nodes') or [])} node(s), "
            f"{len(r.get('ranks') or [])} ranked worker(s) audited "
            f"&mdash; bundle: <code>{_esc(r.get('path') or '?')}"
            f"</code></p>")
    if rows:
        body += _table(("finding", "group", "seq", "culprits",
                        "diagnosis"), rows)
    else:
        body += ("<p class=ok>no stall/desync findings &mdash; the "
                 "bundle still holds every rank's stacks and ledger"
                 "</p>")
    body += "<p><a href='/autopsy?run=1'>run again</a></p>"
    return _page("autopsy", body, refresh=False)


# --- live profiler -----------------------------------------------------


async def _profile(fetch: Fetch, query: str = "") -> bytes:
    """Stack-sampling profiler UI: the index lists live actors with
    profile/stack links; with ?target=... the page runs the sample over
    the control plane (head profile_target -> worker profile RPC,
    util/profiling.py) and renders the folded stacks."""
    from urllib.parse import parse_qs
    q = parse_qs(query or "")
    target = (q.get("target") or [""])[0]
    if target:
        op = (q.get("op") or ["profile"])[0]
        # dashboard fetches carry a fixed 10s RPC timeout: keep the
        # sample window safely inside it (long profiles go via the CLI)
        duration = min(max(float((q.get("duration") or ["1.0"])[0]),
                           0.1), 5.0)
        hz = min(max(int((q.get("hz") or ["100"])[0]), 1), 1000)
        if op == "stack":
            r = await fetch("profile_target", target=target,
                            op="dump_stacks")
        else:
            r = await fetch("profile_target", target=target, op="profile",
                            duration_s=duration, hz=hz)
        if not isinstance(r, dict) or r.get("error"):
            err = r.get("error") if isinstance(r, dict) else repr(r)
            return _page(f"profile: {target}",
                         f"<p class=bad>{_esc(err)}</p>",
                         refresh=False)
        tgt = r.get("target") or {}
        who = (f"pid {r.get('pid', '?')}"
               + (f" &middot; actor {_esc(str(tgt.get('name') or tgt.get('actor_id', ''))[:16])}"
                  f" ({_esc(tgt.get('class_name') or '?')})" if tgt else ""))
        if op == "stack":
            from ray_tpu_torch.util.profiling import format_stacks
            body = (f"<p class=dim>{who} &mdash; one-shot thread dump"
                    f"</p><pre>{_esc(format_stacks(r.get('stacks', [])))}"
                    f"</pre>")
        else:
            folded = sorted((r.get("folded") or {}).items(),
                            key=lambda kv: (-kv[1], kv[0]))
            rows = "\n".join(f"{c:8d}  {_esc(s)}" for s, c in folded)
            body = (f"<p class=dim>{who} &mdash; {r.get('samples', 0)} "
                    f"samples over {duration:g}s at {hz} Hz (folded "
                    f"stacks, heaviest first; `ray-tpu profile` writes "
                    f"speedscope JSON)</p><pre>{rows or '(no samples)'}"
                    f"</pre>")
        return _page(f"profile: {target}", body, refresh=False)
    actors = [a for a in await fetch("list_actors")
              if a and a["state"] == "ALIVE"]
    rows = []
    for a in sorted(actors, key=lambda x: (x.get("name") or "",
                                           _hex(x["actor_id"]))):
        aid = _hex(a["actor_id"])
        rows.append((
            f"<a href='/profile?target={aid}&duration=1'>{_esc(aid[:12])}"
            f"</a>",
            _esc(a.get("name") or "-"),
            _esc(a.get("class_name") or "-"),
            _esc(_hex(a["node_id"])[:12] if a.get("node_id") else "-"),
            f"<a href='/profile?target={aid}&op=stack'>stack</a> "
            f"<a href='/profile?target={aid}&duration=1'>1s</a> "
            f"<a href='/profile?target={aid}&duration=5'>5s</a>",
        ))
    body = ("<p class=dim>sample a live actor's stacks over the "
            "control plane; CLI: <code>ray-tpu stack &lt;actor|pid&gt;"
            "</code> / <code>ray-tpu profile &lt;actor|pid&gt;</code>"
            "</p>"
            + _table(("actor", "name", "class", "node", "profile"),
                     rows))
    return _page("profile", body)


_PAGES = {"/": _overview, "/overview": _overview, "/nodes": _nodes,
          "/actors": _actors, "/jobs": _jobs, "/pgs": _pgs,
          "/serve": _serve, "/tasks": _tasks, "/traces": _traces,
          "/devices": _devices, "/goodput": _goodput,
          "/health": _health,
          "/history": _history, "/profile": _profile,
          "/autopsy": _autopsy}


async def render(path: str, fetchers, query: str = "") -> Optional[bytes]:
    """Render a dashboard page, or None if `path` isn't one.
    `fetchers`: candidate fetch callables, preferred first (a stale one
    from a dead agent is skipped when a later candidate works). With
    none registered (no agent in this process) pages explain that
    instead of 404ing."""
    page = _PAGES.get(path.rstrip("/") or "/")
    if page is None:
        return None
    if callable(fetchers):
        fetchers = [fetchers]
    if not fetchers:
        return _page("unavailable",
                     "<p class=bad>no cluster connection in this "
                     "process</p>")
    err: Optional[Exception] = None
    for fetch in fetchers:
        try:
            return await page(fetch, query)
        except Exception as e:  # noqa: BLE001 — try the next candidate
            err = e
    return _page("error", f"<p class=bad>{_esc(type(err).__name__)}: "
                          f"{_esc(err)}</p>")
