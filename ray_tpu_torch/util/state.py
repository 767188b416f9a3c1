"""State API: the task view of programmatic cluster introspection.

Analog of the reference's state API (reference:
python/ray/util/state/api.py list_tasks + ``ray summary tasks``): a thin
typed view over the control service's timeline RPC, usable from any
initialized driver/worker. The port's copy of ``ray_tpu/util/state.py``
cut to the task rows, which read the runtime's always-on task events
(``util/tracing.record_exec``), the actor rows (the serve plane's
tests read replicas' states from them) and the collective rows (the
ring's round spans, dag/ring.py) and the pipeline summary (the stage
loops' step spans, dag/runtime.py pipe_exec_loop); the node, goodput,
trace, device, health, job and placement-group views come with the CLI
that renders them (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

from typing import List, Optional


def _call(method: str, **kw):
    from ray_tpu_torch import api
    ctx = api._require_init()
    return api._run(ctx.pool.call(ctx.head_addr, method, **kw))


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
