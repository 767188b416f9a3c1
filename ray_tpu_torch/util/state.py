"""State API: programmatic cluster introspection.

Analog of the reference's state API (reference:
python/ray/util/state/api.py list_actors/list_nodes/list_jobs/
list_placement_groups + summarize helpers): thin typed views over the
control service's RPCs, usable from any initialized driver/worker.

The port's copy of ``ray_tpu/util/state.py``, unchanged but for import
paths; the device rows read the events of the port's
``util/devmon.py`` (``torch.cuda``).
"""

from __future__ import annotations

from typing import List, Optional


def _call(method: str, **kw):
    from ray_tpu_torch import api
    ctx = api._require_init()
    return api._run(ctx.pool.call(ctx.head_addr, method, **kw))


def list_nodes() -> List[dict]:
    out = []
    for n in _call("get_nodes"):
        out.append({
            "node_id": n["node_id"].hex(),
            "alive": n["alive"],
            "address": f"{n['addr'][0]}:{n['addr'][1]}",
            "resources_total": n["resources_total"],
            "resources_available": n["resources_available"],
            "pending_demand": n.get("pending_demand", []),
            "labels": n.get("labels", {}),
        })
    return out


def list_actors(state: Optional[str] = None) -> List[dict]:
    out = []
    for a in _call("list_actors"):
        row = {
            "actor_id": a["actor_id"].hex(),
            "state": a.get("state"),
            "name": a.get("name"),
            "class_name": a.get("class_name"),
            "node_id": a["node_id"].hex()
            if a.get("node_id") is not None else None,
            "num_restarts": a.get("num_restarts", 0),
            "death_cause": a.get("death_cause"),
        }
        if state is None or row["state"] == state:
            out.append(row)
    return out


def tasks_from_events(events, limit: int = 200,
                      name_filter: Optional[str] = None) -> List[dict]:
    """Timeline 'exec' spans -> task rows, newest first. The ONE place
    the span-record shape is interpreted — the state API, the CLI
    (`ray-tpu list tasks`), and the dashboard /tasks page all render
    these rows."""
    rows = []
    for e in events:
        if e.get("name") != "exec":
            continue
        if name_filter and name_filter not in str(e.get("target", "")):
            continue
        rows.append({
            "name": e.get("target", "?"),
            "kind": e.get("kind", "task"),
            "task_id": e.get("task"),
            "node_id": str(e.get("node", ""))[:16] or None,
            "pid": e.get("pid"),
            "start_time": e.get("ts"),
            "duration_s": e.get("dur", 0.0),
            "error": e.get("error"),
            "batch": e.get("batch", 1),
        })
    rows.sort(key=lambda x: -(x["start_time"] or 0))
    return rows[:limit]


def collectives_from_events(events, limit: int = 50) -> List[dict]:
    """Timeline "collective" round spans -> summary rows, newest
    first. The ONE place the collective round-span shape is
    interpreted — `ray-tpu collectives` and the dashboard /tasks page
    both render these rows (chunk-level spans are a chrome-trace
    concern and are skipped here)."""
    rows = []
    for e in events:
        if e.get("cat") != "collective" or e.get("name") != "round":
            continue
        rows.append({
            "kind": e.get("kind", "?"),
            "op": e.get("op"),
            # hierarchy level of the sub-ring that recorded the span
            # (intra/inter/bcast; None for a flat ring) — keeps the
            # table and straggler reads from cross-wiring the levels
            "level": e.get("level"),
            "group": e.get("group"),
            "cid": e.get("cid"),
            "rank": e.get("rank"),
            "size": e.get("size"),
            "step": e.get("step"),
            "node_id": str(e.get("node", ""))[:16] or None,
            "pid": e.get("pid"),
            "start_time": e.get("ts"),
            "duration_s": e.get("dur", 0.0),
            "bytes": e.get("bytes", 0),
            "codec": e.get("codec"),
            "recv_wait_s": e.get("recv_wait_s", 0.0),
            "straggler": e.get("straggler"),
            "error": e.get("error", False),
        })
    rows.sort(key=lambda x: -(x["start_time"] or 0))
    return rows[:limit]


def pipeline_from_events(events, limit: int = 50) -> List[dict]:
    """Timeline "pipeline" STEP spans -> per (group, stage, chain)
    summary rows, newest first. The ONE place the pipeline step-span
    shape is interpreted: steps seen, mean step wall time, mean
    measured bubble, and the resulting bubble fraction — the number to
    hold against the analytic (S-1)/(M+S-1) bound (per-microbatch op
    spans are a chrome-trace concern and are skipped here)."""
    acc: dict = {}
    for e in events:
        if e.get("cat") != "pipeline" or e.get("name") != "step":
            continue
        key = (e.get("group"), e.get("stage"), e.get("chain", 0))
        row = acc.setdefault(key, {
            "group": key[0], "stage": key[1], "chain": key[2],
            "steps": 0, "step_s_sum": 0.0, "bubble_s_sum": 0.0,
            "last_ts": 0.0})
        row["steps"] += 1
        row["step_s_sum"] += float(e.get("dur", 0.0))
        row["bubble_s_sum"] += float(e.get("bubble_s", 0.0))
        row["last_ts"] = max(row["last_ts"], e.get("ts", 0.0))
    rows = []
    for row in acc.values():
        n = max(1, row["steps"])
        step_s = row.pop("step_s_sum") / n
        bubble_s = row.pop("bubble_s_sum") / n
        rows.append({**row, "mean_step_s": step_s,
                     "mean_bubble_s": bubble_s,
                     "bubble_fraction": (bubble_s / step_s)
                     if step_s > 0 else 0.0})
    rows.sort(key=lambda x: (-(x["last_ts"] or 0), x["stage"] or 0))
    return rows[:limit]


def goodput_from_events(events, limit: int = 64) -> List[dict]:
    """Timeline "goodput" STEP spans -> one anatomy row per rank,
    newest-window means. The ONE place the goodput step-span shape is
    interpreted: steps seen, mean wall, mean seconds per category
    (compute/comm_exposed/bubble/ckpt_stall/compile/idle — they sum to
    wall by the ledger's identity), the derived goodput fraction
    (compute / wall), and the last reported MFU."""
    cats = ("compute", "comm_exposed", "bubble", "ckpt_stall",
            "compile", "idle")
    acc: dict = {}
    for e in events:
        if e.get("cat") != "goodput" or e.get("name") != "step":
            continue
        r = e.get("rank", -1)
        row = acc.setdefault(r, {
            "rank": r, "steps": 0, "wall_sum": 0.0, "last_ts": 0.0,
            "last_step": 0, "mfu": None,
            **{f"{c}_sum": 0.0 for c in cats}})
        row["steps"] += 1
        row["wall_sum"] += float(e.get("wall_s", e.get("dur", 0.0)))
        for c in cats:
            row[f"{c}_sum"] += float(e.get(f"{c}_s", 0.0))
        ts = float(e.get("ts", 0.0))
        if ts >= row["last_ts"]:
            row["last_ts"] = ts
            row["last_step"] = e.get("step", 0)
            if e.get("mfu") is not None:
                row["mfu"] = float(e["mfu"])
    rows = []
    for row in acc.values():
        n = max(1, row["steps"])
        wall = row.pop("wall_sum") / n
        out = {"rank": row["rank"], "steps": row["steps"],
               "last_step": row["last_step"],
               "last_ts": row["last_ts"], "mfu": row["mfu"],
               "mean_wall_s": wall}
        for c in cats:
            out[f"mean_{c}_s"] = row.pop(f"{c}_sum") / n
        out["goodput_fraction"] = (out["mean_compute_s"] / wall) \
            if wall > 0 else 0.0
        rows.append(out)
    rows.sort(key=lambda x: (x["rank"] if isinstance(x["rank"], int)
                             else 1 << 30))
    return rows[:limit]


def traces_from_events(events, limit: int = 100) -> List[dict]:
    """Timeline "request" spans -> one row per SAMPLED trace (a trace
    is sampled iff its proxy-side ROOT span was recorded — util/tracing
    finish_request's tail-based keep decision; rootless segment spans
    age out without surfacing). The ONE place the request-span shape is
    aggregated — `ray-tpu trace` and the dashboard /traces page both
    render these rows. Sorted errors first, then by duration."""
    traces: dict = {}
    for e in events:
        if e.get("cat") != "request":
            continue
        tid = e.get("trace")
        if not tid:
            continue            # batch spans belong to many traces
        t = traces.setdefault(tid, {
            "trace_id": tid, "root": False, "status": None,
            "keep": None, "deployment": None, "start_time": None,
            "duration_s": 0.0, "error": False, "spans": 0,
            "components": set(), "nodes": set()})
        t["spans"] += 1
        t["components"].add(e.get("component", "?"))
        node = str(e.get("node", ""))[:8]
        if node:
            t["nodes"].add(node)
        if e.get("error"):
            t["error"] = True
        if e.get("root"):
            t["root"] = True
            t["status"] = e.get("status")
            t["keep"] = e.get("keep")
            t["start_time"] = e.get("ts")
            t["duration_s"] = e.get("dur", 0.0)
            t["deployment"] = e.get("deployment")
    rows = [dict(t, components=sorted(t["components"]),
                 nodes=sorted(t["nodes"]))
            for t in traces.values() if t["root"]]
    rows.sort(key=lambda x: (not x["error"], -(x["duration_s"] or 0)))
    return rows[:limit]


def summarize_traces(rows: List[dict]) -> dict:
    """Roll-up over sampled-trace rows: counts by status/keep reason
    and latency extremes — the /traces page header and the CLI
    footer."""
    out = {"traces": len(rows), "errors": 0,
           "by_status": {}, "by_keep": {},
           "max_duration_s": 0.0, "mean_duration_s": 0.0}
    total = 0.0
    for r in rows:
        if r["error"]:
            out["errors"] += 1
        s = r.get("status") or "?"
        out["by_status"][s] = out["by_status"].get(s, 0) + 1
        k = r.get("keep") or "?"
        out["by_keep"][k] = out["by_keep"].get(k, 0) + 1
        d = r.get("duration_s") or 0.0
        total += d
        out["max_duration_s"] = max(out["max_duration_s"], d)
    out["mean_duration_s"] = total / max(1, len(rows))
    return out


def list_traces(limit: int = 100) -> List[dict]:
    """Recent sampled request traces off the cluster timeline
    (`ray-tpu trace` with no id, from Python)."""
    r = _call("collect_timeline")
    return traces_from_events(r.get("events", []), limit)


def devices_from_events(events, limit: int = 500) -> List[dict]:
    """Timeline "device" events (util/devmon.py) -> rows, newest
    first. The ONE place the device-event shape is interpreted —
    `ray-tpu devices` and the dashboard /devices page both render
    these rows. Three row kinds share the list, discriminated by
    ``kind``: "hbm" (per-device memory snapshot + duty cycle),
    "compile" (one XLA compile span), "storm" (a recompile-storm
    flag). Duty windows are a chrome-trace concern and are skipped.
    ``limit`` applies PER KIND: steady hbm snapshots (one per device
    per devmon_hbm_interval_s) must not age the rare compile/storm
    rows out of the summary while those still sit in the buffer."""
    rows = []
    for e in events:
        if e.get("cat") != "device":
            continue
        name = e.get("name")
        base = {"node_id": str(e.get("node", ""))[:16] or None,
                "pid": e.get("pid"), "start_time": e.get("ts")}
        if name == "hbm":
            rows.append({"kind": "hbm", "device": e.get("device"),
                         "used": e.get("used", 0),
                         "limit": e.get("limit", 0),
                         "peak": e.get("peak", 0),
                         "duty": e.get("duty", 0.0),
                         "source": e.get("source"), **base})
        elif name == "compile":
            rows.append({"kind": "compile", "fn": e.get("fn", "?"),
                         "duration_s": e.get("dur", 0.0),
                         "cache_hit": bool(e.get("cache_hit")),
                         "trace": e.get("trace"), **base})
        elif name == "recompile_storm":
            rows.append({"kind": "storm", "fn": e.get("fn", "?"),
                         "count": e.get("count"),
                         "window_s": e.get("window_s"), **base})
    rows.sort(key=lambda x: -(x["start_time"] or 0))
    out: List[dict] = []
    counts: dict = {}
    for r in rows:
        n = counts.get(r["kind"], 0)
        if n < limit:
            counts[r["kind"]] = n + 1
            out.append(r)
    return out


def summarize_devices(rows: List[dict]) -> dict:
    """Roll-up over device rows: the LATEST hbm snapshot per
    (node, pid, device), compile aggregates per function (count,
    recompiles, cache hits, total/max seconds), and the storm flags —
    the /devices page and the `ray-tpu devices` footer."""
    devices: dict = {}
    compiles: dict = {}
    storms = []
    for r in rows:                  # rows arrive newest first
        if r["kind"] == "hbm":
            key = (r["node_id"], r["pid"], r["device"])
            if key not in devices:  # first seen == newest snapshot
                devices[key] = r
        elif r["kind"] == "compile":
            a = compiles.setdefault(r["fn"], {
                "fn": r["fn"], "compiles": 0, "cache_hits": 0,
                "total_s": 0.0, "max_s": 0.0, "last_time": None,
                "_procs": {}})
            if r["cache_hit"]:
                a["cache_hits"] += 1
            else:
                a["compiles"] += 1
                a["total_s"] += r["duration_s"] or 0.0
                a["max_s"] = max(a["max_s"], r["duration_s"] or 0.0)
                # per-process counts: a RECOMPILE is a process
                # compiling the same fn AGAIN — eight workers each
                # cold-compiling once is a healthy cluster, not 7
                # recompiles
                pk = (r["node_id"], r["pid"])
                a["_procs"][pk] = a["_procs"].get(pk, 0) + 1
            if a["last_time"] is None:
                a["last_time"] = r["start_time"]
        elif r["kind"] == "storm":
            storms.append(r)
    dev_rows = sorted(devices.values(),
                      key=lambda d: (str(d["node_id"] or ""),
                                     str(d["device"] or "")))
    comp_rows = sorted(compiles.values(),
                       key=lambda c: (-c["compiles"], c["fn"]))
    for c in comp_rows:
        procs = c.pop("_procs")
        c["recompiles"] = sum(max(0, n - 1) for n in procs.values())
        c["mean_s"] = c["total_s"] / max(1, c["compiles"])
    return {"devices": dev_rows, "compiles": comp_rows,
            "storms": storms,
            "hbm_used_bytes": sum(d["used"] or 0 for d in dev_rows),
            "compile_total_s": sum(c["total_s"] for c in comp_rows)}


def list_devices(limit: int = 500) -> List[dict]:
    """Recent device-plane rows (HBM snapshots, compile spans, storm
    flags) off the cluster timeline (`ray-tpu devices` from Python)."""
    r = _call("collect_timeline")
    return devices_from_events(r.get("events", []), limit)


def health_state() -> dict:
    """The head health plane's machine-readable snapshot (objectives,
    burn rates, active alerts, regression sentinels — util/health.py).
    Same shape `ray-tpu health --json`, the dashboard /health page,
    and the /health?json=1 endpoint serve; its ``burn_advice`` map is
    the autoscaler input contract (ROADMAP item 3)."""
    return _call("health_state")


def query_metric(name: str, since_s: float = 900.0,
                 labels: Optional[dict] = None) -> dict:
    """Windowed history for one metric off the head time-series store
    (`ray-tpu metrics <name> --since 15m` from Python): counters as
    per-window rates, gauges as mean/min/max, histograms as
    count-rate + p50/p99 per window."""
    return _call("query_series", name=name, since_s=float(since_s),
                 labels=labels)


def summarize_collectives(rows: List[dict]) -> List[dict]:
    """Aggregate collective rows per (kind, op, codec): round count,
    mean/max round time, bytes per round, and the modal straggler rank
    (the one to go look at first)."""
    agg: dict = {}
    for r in rows:
        lv = r.get("level")
        a = agg.setdefault((r["kind"], r["op"], r["codec"], lv), {
            "kind": r["kind"], "op": r["op"], "codec": r["codec"],
            "level": lv,
            "rounds": 0, "total_s": 0.0, "max_s": 0.0, "bytes": 0,
            "errors": 0, "stragglers": {}})
        a["rounds"] += 1
        a["total_s"] += r["duration_s"] or 0.0
        a["max_s"] = max(a["max_s"], r["duration_s"] or 0.0)
        a["bytes"] = max(a["bytes"], r["bytes"] or 0)
        if r["error"]:
            a["errors"] += 1
        s = r.get("straggler")
        if s is not None:
            a["stragglers"][s] = a["stragglers"].get(s, 0) + 1
    out = []
    for a in agg.values():
        strag = a.pop("stragglers")
        a["mean_s"] = a["total_s"] / max(1, a["rounds"])
        a["top_straggler"] = (max(strag, key=lambda k: strag[k])
                              if strag else None)
        out.append(a)
    out.sort(key=lambda x: -x["rounds"])
    return out


def list_collectives(limit: int = 50) -> List[dict]:
    """Recent collective rounds, newest first, off the cluster
    timeline (`ray-tpu collectives` from Python)."""
    r = _call("collect_timeline")
    return collectives_from_events(r.get("events", []), limit)


def list_tasks(limit: int = 200,
               name_filter: Optional[str] = None) -> List[dict]:
    """Recent task/actor-call executions, newest first, off the cluster
    tracing archive (reference: `ray list tasks` over the GCS task
    events, gcs/gcs_task_manager.h; util/state/api.py list_tasks)."""
    r = _call("collect_timeline")
    return tasks_from_events(r.get("events", []), limit, name_filter)


def summarize_tasks() -> dict:
    """name -> {count, total_s, mean_s, errors} (reference:
    `ray summary tasks`)."""
    agg: dict = {}
    for t in list_tasks(limit=100000):
        a = agg.setdefault(t["name"], {"count": 0, "total_s": 0.0,
                                       "errors": 0})
        a["count"] += 1
        a["total_s"] += t["duration_s"] or 0.0
        if t["error"]:
            a["errors"] += 1
    for a in agg.values():
        a["mean_s"] = a["total_s"] / max(a["count"], 1)
    return agg


def list_jobs() -> List[dict]:
    return [{"job_id": j["job_id"].hex(), "state": j.get("state"),
             "start_time": j.get("start_time"),
             "end_time": j.get("end_time")}
            for j in _call("list_jobs")]


def list_placement_groups() -> List[dict]:
    out = []
    for pg in _call("list_pgs"):
        out.append({
            "pg_id": pg["pg_id"].hex()
            if hasattr(pg.get("pg_id"), "hex") else str(pg.get("pg_id")),
            "state": pg.get("state"),
            "strategy": pg.get("strategy"),
            "bundles": pg.get("bundles"),
            "name": pg.get("name"),
        })
    return out


def cluster_summary() -> dict:
    """One-call roll-up (reference: `ray summary` CLI shape)."""
    nodes = list_nodes()
    actors = list_actors()
    alive = [n for n in nodes if n["alive"]]
    totals: dict = {}
    avail: dict = {}
    for n in alive:
        for k, v in n["resources_total"].items():
            totals[k] = totals.get(k, 0) + v
        for k, v in n["resources_available"].items():
            avail[k] = avail.get(k, 0) + v
    by_state: dict = {}
    for a in actors:
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    return {"nodes_alive": len(alive), "nodes_total": len(nodes),
            "resources_total": totals, "resources_available": avail,
            "actors_by_state": by_state,
            "placement_groups": len(list_placement_groups())}
