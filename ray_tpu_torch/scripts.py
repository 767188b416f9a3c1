"""``ray-tpu-torch`` command line: start/stop nodes, inspect a live cluster.

The port's copy of ``ray_tpu/scripts.py``, the deployment analog of the
reference's CLI (reference: python/ray/scripts/scripts.py `ray
start/stop/status`, and python/ray/util/state/state_cli.py for `list`):
`start` daemonizes a `ray_tpu_torch.node` process and records it in a
per-host session dir; `stop` signals every recorded process;
`status`/`list` and the inspection commands are thin views over the
control service's existing RPCs. Run it as ``python -m
ray_tpu_torch.scripts <command>`` or through the ``ray-tpu-torch``
console script.

The port keeps its records under a session directory of its own
(``RAY_TPU_TORCH_SESSION_DIR``, default ``<tmp>/ray_tpu_torch_sessions``),
so a port driver never attaches to a node of the JAX package on the
same host, nor the other way round (``init(address=...)`` reads these
records through ``api._local_cli_node``). ``up``/``down`` run the
cluster launcher (``ray_tpu_torch.launcher``, with TPU slices through
``ray_tpu_torch.providers.gcp``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

def session_dir() -> str:
    return (os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_sessions"))


def _call_head(address: str, method: str, timeout: float = 10.0, **kw):
    """One-shot RPC from a short-lived CLI process."""
    import asyncio

    from ray_tpu_torch.runtime import rpc

    async def go():
        pool = rpc.ConnectionPool()
        try:
            host, port = address.rsplit(":", 1)
            return await pool.call((host, int(port)), method,
                                   timeout=timeout, **kw)
        finally:
            await pool.close()

    return asyncio.run(go())


def _node_files():
    sd = session_dir()
    if not os.path.isdir(sd):
        return []
    return sorted(os.path.join(sd, f)
                  for f in os.listdir(sd) if f.endswith(".json"))


def _node_cmd(info_file: str, *, head: bool, address=None,
              host: str = "127.0.0.1", port: int = 0, node_host=None,
              num_cpus=None, resources=None, labels=None,
              system_config=None, metrics_port=None) -> list:
    cmd = [sys.executable, "-m", "ray_tpu_torch.node",
           "--info-file", info_file]
    if head:
        cmd += ["--head", "--host", host, "--port", str(port)]
    else:
        cmd += ["--address", address]
    if node_host:
        cmd += ["--node-host", node_host]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if resources:
        cmd += ["--resources",
                resources if isinstance(resources, str)
                else json.dumps(resources)]
    if labels:
        cmd += ["--labels",
                labels if isinstance(labels, str) else json.dumps(labels)]
    if system_config:
        cmd += ["--system-config", system_config]
    if metrics_port is not None:
        cmd += ["--metrics-port", str(metrics_port)]
    return cmd


def start_node(*, head: bool, address=None, host: str = "127.0.0.1",
               port: int = 0, node_host=None, num_cpus=None,
               resources=None, labels=None, system_config=None,
               metrics_port=None, timeout_s: float = 60.0) -> dict:
    """Spawn one detached ``ray_tpu_torch.node`` process and wait for its
    info file (the session-dir protocol the whole CLI shares). Returns
    the node info dict plus ``info_file``/``log_file`` paths. Used by
    ``ray-tpu start`` AND the cluster launcher (`ray-tpu up`)."""
    sd = session_dir()
    os.makedirs(sd, exist_ok=True)
    info_file = os.path.join(
        sd, f"node-{int(time.time()*1000)}-{os.getpid()}.json")
    cmd = _node_cmd(info_file, head=head, address=address, host=host,
                    port=port, node_host=node_host, num_cpus=num_cpus,
                    resources=resources, labels=labels,
                    system_config=system_config,
                    metrics_port=metrics_port)
    log_path = info_file[:-5] + ".log"
    with open(log_path, "ab") as log:
        # the child holds its own copies of the fd; keeping ours open
        # would leak one per node in long-lived callers (launcher.up)
        proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                start_new_session=True)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(info_file):
            with open(info_file) as f:
                info = json.load(f)
            info["info_file"] = info_file
            info["log_file"] = log_path
            return info
        if proc.poll() is not None:
            raise RuntimeError(
                f"node process exited rc={proc.returncode}; "
                f"see {log_path}")
        time.sleep(0.1)
    proc.terminate()
    raise RuntimeError("timed out waiting for node to come up")


def cmd_start(args) -> int:
    if args.block:
        sd = session_dir()
        os.makedirs(sd, exist_ok=True)
        info_file = os.path.join(
            sd, f"node-{int(time.time()*1000)}-{os.getpid()}.json")
        return subprocess.call(_node_cmd(
            info_file, head=args.head, address=args.address,
            host=args.host, port=args.port, node_host=args.node_host,
            num_cpus=args.num_cpus, resources=args.resources,
            labels=args.labels, system_config=args.system_config,
            metrics_port=args.metrics_port))
    try:
        info = start_node(
            head=args.head, address=args.address, host=args.host,
            port=args.port, node_host=args.node_host,
            num_cpus=args.num_cpus, resources=args.resources,
            labels=args.labels, system_config=args.system_config,
            metrics_port=args.metrics_port,
            timeout_s=args.start_timeout)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"node up: address={info['address']} "
          f"node_id={info['node_id']} pid={info['pid']}")
    if args.head:
        print("connect other nodes with:\n  "
              f"ray-tpu start --address={info['address']}\n"
              "or from Python:\n  "
              f"ray_tpu_torch.init(address=\"{info['address']}\")")
    return 0


def cmd_stop(args) -> int:
    n = 0
    for f in _node_files():
        try:
            with open(f) as fh:
                info = json.load(fh)
            os.kill(info["pid"], signal.SIGTERM)
            n += 1
        except (OSError, ValueError, KeyError):
            pass
        if not args.keep_files:
            try:
                os.unlink(f)
            except OSError:
                pass
    print(f"signalled {n} node process(es)")
    return 0


def _default_address() -> Optional[str]:
    for f in reversed(_node_files()):
        try:
            with open(f) as fh:
                return json.load(fh)["address"]
        except (OSError, ValueError, KeyError):
            continue
    return None


def _resolve_address(args) -> str:
    addr = args.address or os.environ.get(
        "RAY_TPU_ADDRESS") or _default_address()
    if not addr:
        print("no --address given and no local session found",
              file=sys.stderr)
        raise SystemExit(2)
    return addr


def cmd_up(args) -> int:
    """One-command bring-up (reference: `ray up` —
    autoscaler/_private/commands.py)."""
    from ray_tpu_torch import launcher
    cfg = launcher.load_config(args.config)
    state = launcher.up(cfg)
    print(f"cluster {cfg['cluster_name']!r} up: "
          f"address={state['address']} "
          f"nodes={len(state['nodes'])} "
          f"slices={len(state['slice_handles'])}")
    print(f"connect: ray_tpu_torch.init(address=\"{state['address']}\")")
    return 0


def cmd_down(args) -> int:
    from ray_tpu_torch import launcher
    cfg = launcher.load_config(args.config)
    errors = launcher.down(cfg)
    for e in errors:
        print(f"warning: {e}", file=sys.stderr)
    print(f"cluster {cfg['cluster_name']!r} down")
    return 0


def cmd_status(args) -> int:
    addr = _resolve_address(args)
    nodes = _call_head(addr, "get_nodes")
    alive = [n for n in nodes if n.get("alive")]
    print(f"cluster at {addr}: {len(alive)}/{len(nodes)} nodes alive")
    totals, avail = {}, {}
    for n in alive:
        for k, v in (n.get("resources_total") or {}).items():
            totals[k] = totals.get(k, 0) + v
        for k, v in (n.get("resources_available") or {}).items():
            avail[k] = avail.get(k, 0) + v
    for k in sorted(totals):
        print(f"  {k}: {avail.get(k, 0):g}/{totals[k]:g} available")
    return 0


def cmd_list(args) -> int:
    addr = _resolve_address(args)
    if args.what == "tasks":
        # recent executions off the tracing archive (reference:
        # `ray list tasks` over GCS task events)
        import time as _time

        from ray_tpu_torch.util.state import tasks_from_events
        r = _call_head(addr, "collect_timeline")
        rows = tasks_from_events(r.get("events", []),
                                 limit=int(getattr(args, "limit", 200)
                                           or 200))
        if args.json:
            print(json.dumps(rows, default=str, indent=2))
            return 0
        for t in rows:
            started = _time.strftime(
                "%H:%M:%S", _time.localtime(t["start_time"] or 0))
            status = "ERROR" if t["error"] else "ok"
            print(f"{started}  {t['kind']:15s} {str(t['name']):32s} "
                  f"{(t['duration_s'] or 0.0) * 1e3:9.2f} ms  "
                  f"node={str(t['node_id'] or '')[:8]}  {status}")
        return 0
    method = {"nodes": "get_nodes", "actors": "list_actors",
              "jobs": "list_jobs", "pgs": "list_pgs"}[args.what]
    rows = _call_head(addr, method)
    if args.json:
        print(json.dumps(rows, default=str, indent=2))
        return 0
    for r in rows:
        if args.what == "nodes":
            print(f"{r['node_id']}  alive={r['alive']}  addr={r['addr']}  "
                  f"resources={r.get('resources_total')}")
        elif args.what == "actors":
            print(f"{r.get('actor_id')}  state={r.get('state')}  "
                  f"name={r.get('name') or '-'}  node={r.get('node_id')}")
        else:
            print(json.dumps(r, default=str))
    return 0


def cmd_logs(args) -> int:
    """Show worker logs from nodes started on this host."""
    files = []
    for f in _node_files():
        try:
            with open(f) as fh:
                info = json.load(fh)
            ld = info.get("log_dir")
            if ld and os.path.isdir(ld):
                files += [os.path.join(ld, x) for x in sorted(os.listdir(ld))]
        except (OSError, ValueError):
            continue
    if args.filename:
        matches = [f for f in files if args.filename in f]
        if not matches:
            print(f"no log file matching {args.filename!r}",
                  file=sys.stderr)
            return 1
        for m in matches:
            with open(m, errors="replace") as fh:
                if args.tail:
                    from collections import deque
                    sys.stdout.writelines(deque(fh, maxlen=args.tail))
                else:
                    for line in fh:
                        sys.stdout.write(line)
        return 0
    for f in files:
        print(f)
    return 0


def cmd_metrics(args) -> int:
    """Without a name: dump /metrics from a node's Prometheus
    endpoint (the latest snapshot). With a name: query the HEAD's
    time-series store for that metric's history (`ray-tpu metrics
    serve_proxy_handler_s --since 15m`) and render a sparkline +
    per-window stats — degradation over minutes, not a moment."""
    if getattr(args, "name", None):
        from ray_tpu_torch.util.health import parse_since, spark
        addr = _resolve_address(args)
        labels = None
        if getattr(args, "labels", None):
            labels = dict(kv.split("=", 1)
                          for kv in args.labels.split(",") if "=" in kv)
        since_s = parse_since(args.since, 900.0)
        r = _call_head(addr, "query_series", name=args.name,
                       since_s=since_s, labels=labels)
        if r.get("error"):
            print(r["error"], file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(r, default=str, indent=2))
            return 0
        pts = r.get("points", [])
        kind = r.get("kind")
        if not pts:
            print(f"no stored points for {args.name!r} in the last "
                  f"{since_s:g}s (is the health plane on — "
                  f"RAY_TPU_HEALTH / Config.health_enabled — and has "
                  f"the series been pushed yet?)")
            return 0
        from ray_tpu_torch.util.timeseries import DISPLAY_FIELD
        field = DISPLAY_FIELD.get(kind, "value")
        vals = [p.get(field) for p in pts]
        nums = [v for v in vals if v is not None]
        unit = "/s" if field == "rate" else \
            (" s" if args.name.endswith("_s") else "")
        print(f"{args.name} [{kind}] — {len(pts)} windows of "
              f"{r.get('window_s', 0):g}s over {since_s:g}s, "
              f"{r.get('series', 0)} series merged ({field})")
        print(f"  {spark(vals)}")
        if nums:
            print(f"  min {min(nums):g}{unit}  "
                  f"mean {sum(nums) / len(nums):g}{unit}  "
                  f"max {max(nums):g}{unit}  last {nums[-1]:g}{unit}")
        if kind == "histogram":
            last = pts[-1]
            print(f"  last window: n={last.get('count', 0):g} "
                  f"p50={last.get('p50', 0):g}s "
                  f"p99={last.get('p99', 0):g}s "
                  f"mean={last.get('mean', 0):g}s")
        return 0
    if getattr(args, "json", False):
        print("--json applies to the named-metric history query "
              "(ray-tpu metrics <name> --json); the bare form dumps "
              "raw Prometheus text", file=sys.stderr)
        return 2
    import urllib.request
    addr = args.endpoint
    if not addr:
        for f in reversed(_node_files()):
            try:
                with open(f) as fh:
                    addr = json.load(fh).get("metrics_addr")
                if addr:
                    break
            except (OSError, ValueError):
                continue
    if not addr:
        print("no metrics endpoint (start nodes with --metrics-port)",
              file=sys.stderr)
        return 1
    with urllib.request.urlopen(f"http://{addr}/metrics",
                                timeout=10) as r:
        sys.stdout.write(r.read().decode())
    return 0


def cmd_health(args) -> int:
    """Cluster health plane summary (util/health.py): SLO objectives
    with their multi-window burn rates, active page/warn alerts (with
    exemplar trace ids — `ray-tpu trace <id>` opens the offending
    request), and regression sentinels vs the pinned
    HEALTH_BASELINE.json."""
    import time as _time
    addr = _resolve_address(args)
    s = _call_head(addr, "health_state")
    if args.json:
        print(json.dumps(s, default=str, indent=2))
        return 0
    if not s.get("enabled"):
        print(s.get("reason", "health plane disabled"))
        return 0
    tiers = s.get("tiers", {})
    tdesc = ", ".join(
        f"{t}: burn>={v['burn_threshold']:g} over "
        f"{v['windows_s'][0]:g}s+{v['windows_s'][1]:g}s"
        for t, v in tiers.items())
    print(f"health plane: {s.get('series', 0)} series, "
          f"{s.get('points_total', 0)} points, eval #"
          f"{s.get('eval_count', 0)}  ({tdesc})")
    alerts = s.get("alerts", [])
    for a in alerts:
        since = _time.strftime("%H:%M:%S",
                               _time.localtime(a.get("since") or 0))
        ex = a.get("exemplar")
        print(f"  ALERT [{a['tier'].upper()}] {a['objective']} "
              f"firing since {since}"
              + (f"  exemplar trace {ex}  (ray-tpu trace {ex})"
                 if ex else ""))
    if not alerts:
        print("  no active alerts")
    print()
    for o in s.get("objectives", []):
        page = (o.get("tiers") or {}).get("page", {})
        warn = (o.get("tiers") or {}).get("warn", {})

        def fb(v):
            return "-" if v is None else \
                ("inf" if v == -1.0 else f"{v:g}")
        mark = {"page": "PAGE ", "warn": "warn "}.get(
            o.get("alert"), "ok   ")
        print(f"  {mark} {o['name']:28s} [{o['kind']:12s}] "
              f"page burn {fb(page.get('burn_short'))}/"
              f"{fb(page.get('burn_long'))} "
              f"warn {fb(warn.get('burn_short'))}/"
              f"{fb(warn.get('burn_long'))}  {o.get('metric')}")
    sents = s.get("sentinels", [])
    if sents:
        print()
        for t in sents:
            live = "-" if t.get("live") is None else f"{t['live']:g}"
            ratio = "-" if t.get("ratio") is None \
                else f"{t['ratio']:.2f}x"
            flag = "REGRESSION" if t.get("breached") else "ok"
            print(f"  {flag:10s} {t['name']:28s} live {live} vs "
                  f"baseline {t['baseline']:g} ({ratio}, "
                  f"tolerance {t['tolerance']:g}x, "
                  f"{t['stat']} over {t['window_s']:g}s)")
    print("\nhistory: ray-tpu metrics <name> --since 15m; "
          "machine-readable: GET /health?json=1 on the metrics port")
    return 0


def cmd_stack(args) -> int:
    """One-shot thread dump of a live worker/actor (py-spy-dump
    analog): resolves the target on the head (actor name, actor-id hex
    prefix, or worker/agent pid) and prints every thread's stack."""
    addr = _resolve_address(args)
    r = _call_head(addr, "profile_target", target=args.target,
                   op="dump_stacks", timeout=30.0)
    if not isinstance(r, dict) or r.get("error"):
        err = r.get("error") if isinstance(r, dict) else repr(r)
        print(f"stack dump failed: {err}", file=sys.stderr)
        return 1
    from ray_tpu_torch.util.profiling import format_stacks
    tgt = r.get("target") or {}
    desc = f"pid {r.get('pid', '?')}"
    if tgt.get("actor_id"):
        desc += (f"  actor={tgt.get('name') or tgt['actor_id'][:12]}"
                 f"  class={tgt.get('class_name') or '?'}")
    print(f"target: {args.target}  ({desc})\n")
    print(format_stacks(r.get("stacks", [])))
    return 0


def cmd_autopsy(args) -> int:
    """One-command postmortem (`ray-tpu autopsy`): the head fans a
    forensics pull out to every agent, each agent pulls its workers,
    the cross-rank ledger audit names the culprit, and one atomic
    postmortem-*.json bundle lands on the head. Prints the diagnosis
    and the bundle path."""
    addr = _resolve_address(args)
    r = _call_head(addr, "autopsy",
                   stall_timeout_s=args.stall_timeout, timeout=90.0)
    if not isinstance(r, dict):
        print(f"autopsy failed: {r!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(r, indent=2, default=str))
        return 0
    findings = r.get("findings") or []
    ranks = r.get("ranks") or []
    print(f"autopsy: {len(r.get('nodes') or [])} node(s), "
          f"{len(ranks)} ranked worker(s) audited")
    if findings:
        for f in findings:
            print(f"  {f.get('kind')}: {f.get('detail')} "
                  f"(culprits: {f.get('culprits')})")
    else:
        print("  no stall/desync findings — see bundle for stacks "
              "and ledgers")
    if r.get("path"):
        print(f"bundle: {r['path']}")
    return 0


def cmd_profile(args) -> int:
    """Sample a live worker/actor's stacks over the control plane and
    write folded stacks (flamegraph.pl input) or speedscope JSON."""
    addr = _resolve_address(args)
    r = _call_head(addr, "profile_target", target=args.target,
                   op="profile", duration_s=args.duration, hz=args.hz,
                   timeout=args.duration + 60.0)
    if not isinstance(r, dict) or r.get("error"):
        err = r.get("error") if isinstance(r, dict) else repr(r)
        print(f"profile failed: {err}", file=sys.stderr)
        return 1
    from ray_tpu_torch.util import profiling
    if args.format == "speedscope":
        doc = profiling.to_speedscope(
            r, name=f"ray-tpu {args.target} ({args.duration:g}s)")
        out = json.dumps(doc)
    else:
        out = profiling.folded_text(r)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out + "\n")
        print(f"wrote {args.output}: {r.get('samples', 0)} samples, "
              f"{len(r.get('folded', {}))} unique stacks "
              f"(pid {r.get('pid', '?')})")
    else:
        print(out)
    return 0


def cmd_timeline(args) -> int:
    """Collect the cluster-wide task/span timeline; write a
    chrome://tracing / Perfetto JSON file (reference: `ray timeline`).
    Cross-node timestamps are corrected by the head's per-node
    clock-offset estimates shipped with the collection."""
    from ray_tpu_torch.util.tracing import to_chrome
    addr = _resolve_address(args)
    r = _call_head(addr, "collect_timeline")
    evs = r.get("events", [])
    offs = r.get("clock_offsets") or {}
    recs = to_chrome(evs, args.output, clock_offsets=offs)
    spans = sum(1 for x in recs if x.get("ph") == "X")
    flows = sum(1 for x in recs if x.get("ph") == "s")
    skew = max((abs(v) for v in offs.values()), default=0.0)
    print(f"wrote {args.output}: {spans} spans, {flows} flow edges "
          f"({len(evs)} raw events, {len(offs)} node clocks, "
          f"max |offset| {skew * 1e3:.2f} ms)")
    return 0


def cmd_trace(args) -> int:
    """Request tracing surface. Without an id: list recent SAMPLED
    traces (the dashboard /traces table, errors first then slowest).
    With an id: write that ONE request's clock-offset-corrected
    cross-node waterfall (request lanes proxy/handle/replica/engine +
    flow edges, nested task exec spans, linked engine decode blocks,
    and — for train-step traces — their collective rounds) as a
    chrome://tracing / Perfetto JSON file, plus a per-hop summary."""
    import time as _time

    from ray_tpu_torch.util.state import summarize_traces, traces_from_events
    from ray_tpu_torch.util.tracing import filter_trace, to_chrome
    addr = _resolve_address(args)
    r = _call_head(addr, "collect_timeline")
    evs = r.get("events", [])
    if not args.trace_id:
        rows = traces_from_events(evs, limit=args.limit)
        if args.json:
            print(json.dumps({"traces": rows,
                              "summary": summarize_traces(rows)},
                             default=str, indent=2))
            return 0
        if not rows:
            print("no sampled traces in the timeline (is "
                  "RAY_TPU_TRACE_REQUESTS=0, or trace_sample_rate 0 "
                  "with only healthy traffic?)")
            return 0
        for t in rows:
            started = _time.strftime(
                "%H:%M:%S", _time.localtime(t["start_time"] or 0))
            status = t.get("status") or "?"
            print(f"{started}  {t['trace_id']}  {status:8s} "
                  f"kept={t.get('keep') or '-':7s} "
                  f"{(t['duration_s'] or 0.0) * 1e3:9.2f} ms  "
                  f"{t['spans']:3d} spans  "
                  f"[{','.join(t['components'])}]  "
                  f"{t.get('deployment') or '-'}")
        s = summarize_traces(rows)
        print(f"\n{s['traces']} sampled traces, {s['errors']} errors; "
              f"mean {s['mean_duration_s'] * 1e3:.2f} ms, max "
              f"{s['max_duration_s'] * 1e3:.2f} ms. Waterfall: "
              f"ray-tpu trace <id>")
        return 0
    tid = args.trace_id
    mine = filter_trace(evs, tid)
    if not mine:
        print(f"trace {tid!r} not found in the timeline (buffers are "
              "bounded — old traces age out)", file=sys.stderr)
        return 1
    offs = r.get("clock_offsets") or {}
    recs = to_chrome(evs, args.output, clock_offsets=offs,
                     trace_id=tid)
    spans = [x for x in recs if x.get("ph") == "X"]
    flows = sum(1 for x in recs if x.get("ph") == "s")
    procs = {(e.get("node"), e.get("pid")) for e in mine
             if e.get("cat") == "request"}
    for e in sorted((e for e in mine if e.get("cat") == "request"),
                    key=lambda e: e.get("ts", 0.0)):
        status = "ERROR" if e.get("error") else "ok"
        extra = ""
        if e.get("root"):
            extra = (f"  [root: {e.get('status')}, "
                     f"kept={e.get('keep')}]")
        elif e.get("links"):
            extra = f"  [batch x{len(e['links'])}]"
        print(f"{e.get('component', '?'):8s} {e.get('seg', '?'):10s} "
              f"{(e.get('dur') or 0.0) * 1e3:9.2f} ms  "
              f"node={str(e.get('node', ''))[:8] or '-':8s} "
              f"pid={e.get('pid', '?')}  {status}{extra}")
    print(f"\nwrote {args.output}: {len(spans)} spans, {flows} flow "
          f"edges across {len(procs)} process(es) "
          f"({len(offs)} node clocks)")
    return 0


def cmd_collectives(args) -> int:
    """Summarize recent collective-plane rounds off the cluster
    timeline: op, payload bytes, round time, recv-wait, straggler rank
    — the `ray-tpu timeline` companion for the ring plane (same rows
    the dashboard /tasks page renders)."""
    import time as _time

    from ray_tpu_torch.util.state import (collectives_from_events,
                                          summarize_collectives)
    addr = _resolve_address(args)
    r = _call_head(addr, "collect_timeline")
    rows = collectives_from_events(r.get("events", []),
                                   limit=args.limit)
    if args.json:
        print(json.dumps({"rounds": rows,
                          "summary": summarize_collectives(rows)},
                         default=str, indent=2))
        return 0
    if not rows:
        print("no collective rounds in the timeline (is "
              "collective_trace_level 'off'?)")
        return 0
    for t in rows:
        started = _time.strftime(
            "%H:%M:%S", _time.localtime(t["start_time"] or 0))
        strag = t["straggler"] if t["straggler"] is not None else "-"
        step = f"step {t['step']}" if t["step"] is not None else "-"
        status = "ERROR" if t["error"] else "ok"
        level = t.get("level") or "flat"
        print(f"{started}  {t['kind']:15s} {str(t['op'] or '-'):5s} "
              f"{level:5s} "
              f"r{t['rank']}/{t['size']}  "
              f"{(t['bytes'] or 0) / 1e6:8.2f} MB  "
              f"{(t['duration_s'] or 0.0) * 1e3:9.2f} ms  "
              f"wait {(t['recv_wait_s'] or 0.0) * 1e3:8.2f} ms  "
              f"straggler={strag}  {step}  "
              f"{t['codec'] or 'fp'}  {status}")
    print()
    for a in summarize_collectives(rows):
        strag = (f"  top straggler rank {a['top_straggler']}"
                 if a["top_straggler"] is not None else "")
        print(f"{a['kind']}[{a.get('level') or 'flat'}] "
              f"({a['op']}, {a['codec'] or 'fp'}): "
              f"{a['rounds']} rounds, mean "
              f"{a['mean_s'] * 1e3:.2f} ms, max {a['max_s'] * 1e3:.2f} "
              f"ms, {a['bytes'] / 1e6:.2f} MB/round, "
              f"{a['errors']} errors{strag}")
    return 0


def cmd_devices(args) -> int:
    """Device-plane summary off the cluster timeline (util/devmon.py
    events): per-device HBM occupancy + duty cycle, XLA compile
    aggregates per function, and recompile-storm flags — the
    accelerator companion to `ray-tpu collectives` / `ray-tpu trace`
    (same rows the dashboard /devices page renders)."""
    import time as _time

    from ray_tpu_torch.util.state import devices_from_events, summarize_devices
    addr = _resolve_address(args)
    r = _call_head(addr, "collect_timeline")
    rows = devices_from_events(r.get("events", []), limit=args.limit)
    s = summarize_devices(rows)
    if args.json:
        print(json.dumps({"rows": rows, "summary": s},
                         default=str, indent=2))
        return 0
    if not rows:
        print("no device events in the timeline (is RAY_TPU_DEVMON=0, "
              "or has no jax-using worker run yet?)")
        return 0
    for d in s["devices"]:
        seen = _time.strftime("%H:%M:%S",
                              _time.localtime(d["start_time"] or 0))
        lim = (f"{(d['limit'] or 0) / 1e9:8.2f} GB"
               if d["limit"] else "       ? GB")
        print(f"{seen}  {str(d['device']):10s} "
              f"node={str(d['node_id'] or '')[:8]:8s} "
              f"pid={d['pid'] or '?':<7} "
              f"used {(d['used'] or 0) / 1e6:10.2f} MB / {lim}  "
              f"peak {(d['peak'] or 0) / 1e6:10.2f} MB  "
              f"duty {(d['duty'] or 0.0) * 100:5.1f}%  "
              f"[{d['source']}]")
    if s["compiles"]:
        print()
        for c in s["compiles"]:
            print(f"compile  {c['fn'][:40]:40s} x{c['compiles']:<4d} "
                  f"(+{c['cache_hits']} cache hits)  "
                  f"mean {c['mean_s'] * 1e3:9.2f} ms  "
                  f"max {c['max_s'] * 1e3:9.2f} ms")
    for st in s["storms"]:
        print(f"RECOMPILE STORM  {st['fn']!r}: {st['count']} compiles "
              f"in {st['window_s']:g}s window "
              f"(node={str(st['node_id'] or '')[:8]})")
    print(f"\n{len(s['devices'])} device(s), "
          f"{s['hbm_used_bytes'] / 1e6:.2f} MB HBM in use, "
          f"{s['compile_total_s']:.2f} s total compile time, "
          f"{len(s['storms'])} storm flag(s). Waterfall with compile "
          f"lanes: ray-tpu trace <id>")
    return 0


def cmd_goodput(args) -> int:
    """Per-rank step-time anatomy off the goodput ledger
    (util/goodput.py events in the cluster timeline): one stacked
    breakdown bar per rank (compute / comm_exposed / bubble /
    ckpt_stall / compile / idle — the categories sum to step wall by
    the ledger's identity), the derived goodput fraction, plus the
    train_mfu trend and the straggler verdict from the head's
    time-series store. Same rows as the dashboard /goodput page."""
    from ray_tpu_torch.util.health import parse_since, spark
    from ray_tpu_torch.util.state import goodput_from_events
    addr = _resolve_address(args)
    r = _call_head(addr, "collect_timeline")
    rows = goodput_from_events(r.get("events", []), limit=args.limit)
    since_s = parse_since(args.since, 900.0)
    mfu_vals = []
    straggler = None
    try:
        q = _call_head(addr, "query_series", name="train_mfu",
                       since_s=since_s)
        mfu_vals = [p.get("value") for p in q.get("points", [])
                    if p.get("value") is not None]
        qs = _call_head(addr, "query_series",
                        name="goodput_straggler_rank", since_s=since_s)
        pts = qs.get("points", [])
        if pts:
            # a rank id: read the newest SAMPLE, not the window mean
            # (a window that saw both -1/healthy and rank N averages
            # to garbage)
            v = pts[-1].get("last", pts[-1].get("value"))
            if v is not None:
                straggler = int(v)
    except Exception:   # noqa: BLE001 — anatomy renders without trends
        pass
    if args.json:
        print(json.dumps({"rows": rows, "mfu_trend": mfu_vals,
                          "straggler_rank": straggler},
                         default=str, indent=2))
        return 0
    if not rows:
        print("no goodput events in the timeline (is "
              "goodput_level=off, or has no trace_step-wrapped train "
              "loop run yet?)")
        return 0
    cats = (("compute", "#"), ("comm_exposed", "x"), ("bubble", "~"),
            ("ckpt_stall", "k"), ("compile", "c"), ("idle", "."))
    width = 40
    print(f"{'rank':>4}  {'steps':>5}  {'wall':>9}  "
          f"{'goodput':>7}  anatomy "
          + " ".join(f"{sym}={name}" for name, sym in cats))
    for row in rows:
        wall = row["mean_wall_s"]
        bar = ""
        for name, sym in cats:
            frac = row[f"mean_{name}_s"] / wall if wall > 0 else 0.0
            bar += sym * int(round(frac * width))
        bar = (bar + "." * width)[:width]
        print(f"{str(row['rank']):>4}  {row['steps']:>5}  "
              f"{wall * 1e3:7.1f}ms  "
              f"{row['goodput_fraction'] * 100:6.1f}%  [{bar}]"
              + (f"  mfu={row['mfu'] * 100:.1f}%"
                 if row.get("mfu") is not None else ""))
    if mfu_vals:
        print(f"train_mfu ({args.since}): {spark(mfu_vals)} "
              f"last={mfu_vals[-1] * 100:.1f}%")
    if straggler is not None and straggler >= 0:
        print(f"STRAGGLER: rank {straggler} p50 anatomy diverges "
              f"beyond goodput_straggler_z")
    return 0


def cmd_job(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient
    addr = _resolve_address(args)
    with JobSubmissionClient(addr) as client:
        if args.job_cmd == "submit":
            runtime_env = json.loads(args.runtime_env) \
                if args.runtime_env else None
            sid = client.submit_job(entrypoint=" ".join(args.entrypoint),
                                    runtime_env=runtime_env,
                                    submission_id=args.submission_id)
            print(sid)
            if args.wait:
                st = client.wait_until_finish(sid, timeout=args.timeout)
                print(st)
                sys.stdout.write(client.get_job_logs(sid))
                return 0 if st == "SUCCEEDED" else 1
            return 0
        if args.job_cmd == "status":
            print(client.get_job_status(args.submission_id))
            return 0
        if args.job_cmd == "logs":
            sys.stdout.write(client.get_job_logs(args.submission_id))
            return 0
        if args.job_cmd == "stop":
            ok = client.stop_job(args.submission_id)
            print("stopped" if ok else "failed")
            return 0 if ok else 1
        for j in client.list_jobs():
            print(f"{j['submission_id']}  {j['status']}  "
                  f"{j['entrypoint']!r}")
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("start", help="start a head or worker node")
    ps.add_argument("--head", action="store_true")
    ps.add_argument("--address", help="head host:port to join")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--node-host", default=None)
    ps.add_argument("--port", type=int, default=6379)
    ps.add_argument("--num-cpus", type=float, default=None)
    ps.add_argument("--resources")
    ps.add_argument("--labels")
    ps.add_argument("--system-config")
    ps.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (0 = ephemeral port)")
    ps.add_argument("--block", action="store_true",
                    help="run in the foreground")
    ps.add_argument("--start-timeout", type=float, default=30.0)
    ps.set_defaults(fn=cmd_start)

    pt = sub.add_parser("stop", help="stop nodes started on this host")
    pt.add_argument("--keep-files", action="store_true")
    pt.set_defaults(fn=cmd_stop)

    pup = sub.add_parser(
        "up", help="bring up a whole cluster from a YAML config "
                   "(head + local nodes + cloud TPU slices)")
    pup.add_argument("config", help="cluster YAML path")
    pup.set_defaults(fn=cmd_up)

    pdn = sub.add_parser("down",
                         help="tear down a cluster brought up with `up`")
    pdn.add_argument("config", help="cluster YAML path")
    pdn.set_defaults(fn=cmd_down)

    pu = sub.add_parser("status", help="cluster resource summary")
    pu.add_argument("--address")
    pu.set_defaults(fn=cmd_status)

    pl = sub.add_parser("list", help="list cluster state")
    pl.add_argument("what",
                    choices=["nodes", "actors", "jobs", "pgs", "tasks"])
    pl.add_argument("--address")
    pl.add_argument("--json", action="store_true")
    pl.add_argument("--limit", type=int, default=200)
    pl.set_defaults(fn=cmd_list)

    pg = sub.add_parser("logs", help="list / show worker logs on this host")
    pg.add_argument("filename", nargs="?",
                    help="substring of a log file to print")
    pg.add_argument("--tail", type=int, default=0,
                    help="print only the last N lines")
    pg.set_defaults(fn=cmd_logs)

    pm = sub.add_parser(
        "metrics",
        help="dump a node's /metrics, or (with a name) query the "
             "head's time-series history for one metric")
    pm.add_argument("name", nargs="?",
                    help="metric name to query from the head store "
                         "(e.g. serve_proxy_handler_s); omit to dump "
                         "the raw /metrics snapshot")
    pm.add_argument("--since", default="15m",
                    help="history window, e.g. 90s / 15m / 2h "
                         "(default 15m)")
    pm.add_argument("--labels",
                    help="label selector, e.g. deployment=app1")
    pm.add_argument("--json", action="store_true")
    pm.add_argument("--address")
    pm.add_argument("--endpoint", help="host:port (default: latest local)")
    pm.set_defaults(fn=cmd_metrics)

    ph = sub.add_parser(
        "health",
        help="SLO objectives, burn-rate alerts (page/warn tiers), and "
             "regression sentinels off the head health plane")
    ph.add_argument("--address")
    ph.add_argument("--json", action="store_true")
    ph.set_defaults(fn=cmd_health)

    pk = sub.add_parser("stack",
                        help="dump a live worker/actor's thread stacks "
                             "(actor name, actor-id prefix, or pid)")
    pk.add_argument("target", help="actor name / actor-id hex prefix / "
                                   "worker pid")
    pk.add_argument("--address")
    pk.set_defaults(fn=cmd_stack)

    pp = sub.add_parser("profile",
                        help="stack-sample a live worker/actor; write "
                             "folded stacks or speedscope JSON")
    pp.add_argument("target", help="actor name / actor-id hex prefix / "
                                   "worker pid")
    pp.add_argument("--address")
    pp.add_argument("--duration", type=float, default=5.0,
                    help="sampling window in seconds")
    pp.add_argument("--hz", type=int, default=100,
                    help="samples per second")
    pp.add_argument("--format", choices=["folded", "speedscope"],
                    default="folded")
    pp.add_argument("-o", "--output",
                    help="write to a file instead of stdout")
    pp.set_defaults(fn=cmd_profile)

    pt = sub.add_parser("timeline",
                        help="dump the cluster task timeline "
                             "(chrome://tracing JSON, clock-offset "
                             "corrected)")
    pt.add_argument("--address")
    pt.add_argument("-o", "--output", default="timeline.json")
    pt.set_defaults(fn=cmd_timeline)

    ptr = sub.add_parser(
        "trace",
        help="list recent sampled request traces, or render one "
             "trace's cross-node waterfall (chrome://tracing JSON)")
    ptr.add_argument("trace_id", nargs="?",
                     help="32-hex trace id (from an X-Trace-Id "
                          "response header, a histogram exemplar, or "
                          "the list form)")
    ptr.add_argument("--address")
    ptr.add_argument("--json", action="store_true")
    ptr.add_argument("--limit", type=int, default=50)
    ptr.add_argument("-o", "--output", default="trace.json")
    ptr.set_defaults(fn=cmd_trace)

    pdv = sub.add_parser(
        "devices",
        help="per-device HBM / duty cycle / XLA compile summary "
             "(recompile storms flagged)")
    pdv.add_argument("--address")
    pdv.add_argument("--json", action="store_true")
    pdv.add_argument("--limit", type=int, default=500)
    pdv.set_defaults(fn=cmd_devices)

    pgp = sub.add_parser(
        "goodput",
        help="per-rank step-time anatomy (compute / exposed comm / "
             "bubble / ckpt stall / compile / idle) + MFU trend")
    pgp.add_argument("--address")
    pgp.add_argument("--json", action="store_true")
    pgp.add_argument("--limit", type=int, default=64)
    pgp.add_argument("--since", default="15m",
                     help="trend window for train_mfu (e.g. 15m, 2h)")
    pgp.set_defaults(fn=cmd_goodput)

    pc = sub.add_parser("collectives",
                        help="summarize recent ring collective rounds "
                             "(op, bytes, round time, straggler rank)")
    pc.add_argument("--address")
    pc.add_argument("--json", action="store_true")
    pc.add_argument("--limit", type=int, default=50)
    pc.set_defaults(fn=cmd_collectives)

    pa = sub.add_parser(
        "autopsy",
        help="one-command postmortem: pull every rank's stacks + "
             "collective ledger, audit for stalls/desyncs, write a "
             "postmortem-*.json bundle")
    pa.add_argument("--address")
    pa.add_argument("--json", action="store_true")
    pa.add_argument("--stall-timeout", type=float, default=0.0,
                    help="in-flight age (s) that counts as stalled in "
                         "the audit (default: forensics_stall_timeout_s)")
    pa.set_defaults(fn=cmd_autopsy)

    pj = sub.add_parser("job", help="submit / inspect entrypoint jobs")
    jsub = pj.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("entrypoint", nargs="+",
                    help="shell command, e.g. -- python train.py")
    js.add_argument("--address")
    js.add_argument("--runtime-env", dest="runtime_env",
                    help="JSON: env_vars / working_dir")
    js.add_argument("--submission-id", dest="submission_id")
    js.add_argument("--wait", action="store_true",
                    help="block until the job finishes; print logs")
    js.add_argument("--timeout", type=float, default=600.0)
    js.set_defaults(fn=cmd_job)
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("submission_id")
        jp.add_argument("--address")
        jp.set_defaults(fn=cmd_job)
    jl = jsub.add_parser("list")
    jl.add_argument("--address")
    jl.set_defaults(fn=cmd_job)

    args = p.parse_args(argv)
    if args.cmd == "start" and not args.head and not args.address:
        p.error("one of --head / --address is required")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
