"""Node agent: per-host worker pool, lease scheduler, object plane owner.

The raylet analog (reference: src/ray/raylet/node_manager.h, worker_pool.h,
scheduling/cluster_lease_manager.h, local_lease_manager.h,
local_object_manager.h, object_manager/object_manager.h). One agent runs per
host; it spawns worker processes, grants worker leases with
HYBRID/SPREAD/affinity policies (spilling back to peer agents using the
cluster view gossiped via heartbeats), reserves placement-group bundles in
the 2-phase protocol, owns the node's shared-memory object store, and serves
chunked object pulls to peer agents.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.config import Config
from ray_tpu_torch.runtime import rpc
from ray_tpu_torch.runtime.ids import (ActorID, NodeID, ObjectID,
                                 PlacementGroupID, WorkerID)
from ray_tpu_torch.runtime.object_store import SharedObjectStore, _attach

IDLE, LEASED, ACTOR, STARTING, DEAD = (
    "idle", "leased", "actor", "starting", "dead")


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    proc: Optional[asyncio.subprocess.Process]
    addr: Optional[Tuple[str, int]] = None
    state: str = STARTING
    actor_id: Optional[ActorID] = None
    actor_resources: Optional[dict] = None
    actor_pg: Optional[tuple] = None           # (pg_id, bundle_index)
    lease_id: Optional[str] = None
    env_hash: str = ""                         # runtime-env pool key
    cgroup: Optional[object] = None            # WorkerCgroup when caged
    ready: asyncio.Event = field(default_factory=asyncio.Event)


@dataclass
class _Lease:
    lease_id: str
    worker: WorkerHandle
    resources: Dict[str, float]
    pg_id: Optional[PlacementGroupID] = None
    bundle_index: Optional[int] = None
    acked: bool = False                      # client confirmed receipt
    granted_at: float = field(default_factory=time.monotonic)
    # Tokens of blocking get()/wait() episodes parked on this lease:
    # pipelined tasks share one lease, so two may block concurrently;
    # resources release on empty->nonempty and re-acquire on
    # nonempty->empty. A SET (not a counter) so that RPC retries of
    # worker_blocked/worker_unblocked are idempotent — the ConnectionPool
    # retries on timeout, and a double-applied counter mutation would
    # leave the node's resources permanently inflated.
    blocked: set = field(default_factory=set)


class NodeAgent:
    def __init__(self, head_addr: Tuple[str, int],
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 config: Optional[Config] = None,
                 session_id: str = "default0",
                 node_id: Optional[NodeID] = None,
                 env_extra: Optional[Dict[str, str]] = None):
        self.config = config or Config.from_env()
        self.env_extra = dict(env_extra or {})
        self.head_addr = tuple(head_addr)
        self.node_id = node_id or NodeID.generate()
        self.session_id = session_id
        self.labels = dict(labels or {})
        if resources is None:
            resources = {"CPU": float(os.cpu_count() or 1)}
        self.resources_total = dict(resources)
        self.available = dict(resources)
        # pg_id -> bundle_index -> (resources, committed)
        self.bundles: Dict[PlacementGroupID, Dict[int, Tuple[dict, bool]]] = {}
        self.bundle_avail: Dict[Tuple[PlacementGroupID, int], dict] = {}
        self.workers: Dict[WorkerID, WorkerHandle] = {}
        self.leases: Dict[str, _Lease] = {}
        # env_hash -> last venv setup failure (surfaced in lease errors)
        self._venv_errors: Dict[str, str] = {}
        self._lease_seq = 0
        self._worker_claims: Dict[str, int] = {}  # env_hash -> claims
        self._wait_queue: List[Tuple[dict, asyncio.Future]] = []
        from ray_tpu_torch.util.events import CategoryBuffer
        # spans pushed by this node's workers (report_events);
        # per-category budgets so a chunk-level collective flood can't
        # evict task exec spans at this aggregation point either
        self._worker_events = CategoryBuffer(
            maxlen=self.config.event_buffer_size)
        self.cluster_view: Dict[NodeID, dict] = {}
        self._view_version = 0
        self._known_cluster_view = -1   # last view version applied
        self._pulls: Dict[ObjectID, asyncio.Future] = {}
        self.store = SharedObjectStore(
            session_id,
            capacity_bytes=self.config.shm_store_bytes,
            spill_dir=self.config.object_spill_dir or None,
            node_uid=self.node_id.hex(),
            head_addr=self.head_addr)
        self.pool = rpc.ConnectionPool()
        self.server = rpc.RpcServer(
            self._handlers(),
            chaos=rpc.ChaosPlan(self.config.testing_rpc_failure))
        self.addr: Optional[Tuple[str, int]] = None
        self._hb_task: Optional[asyncio.Task] = None
        self._stopping = False

    def _handlers(self):
        return {
            "request_lease": self.request_lease,
            "ack_lease": self.ack_lease,
            "release_lease": self.release_lease,
            "worker_blocked": self.worker_blocked,
            "worker_unblocked": self.worker_unblocked,
            "start_actor": self.start_actor,
            "kill_actor_worker": self.kill_actor_worker,
            "prepare_bundle": self.prepare_bundle,
            "commit_bundle": self.commit_bundle,
            "return_bundle": self.return_bundle,
            "worker_ready": self.worker_ready,
            "alloc_object": self.alloc_object,
            "seal_object": self.seal_object,
            "abort_object": self.abort_object,
            "resolve_object": self.resolve_object,
            "fetch_chunk": self.fetch_chunk,
            "free_objects": self.free_objects,
            "node_stats": self.node_stats,
            "node_timeline": self.node_timeline,
            "clock_probe": self.clock_probe,
            "report_events": self.report_events,
            "profile_worker": self.profile_worker,
            "node_forensics": self.node_forensics,
            "ping": self.ping,
        }

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self.addr = await self.server.start(host, port)
        r = await self.pool.call(
            self.head_addr, "register_node", node_id=self.node_id,
            addr=self.addr, resources_total=self.resources_total,
            labels=self.labels)
        assert r.get("ok"), r
        self._hb_task = asyncio.ensure_future(self._heartbeat_loop())
        from ray_tpu_torch.util import metrics as _m
        self._collector = self._render_metrics

        async def _dash_fetch(method, **kw):
            # dashboard pages proxy control RPCs to the head
            return await self.pool.call(self.head_addr, method,
                                        timeout=10.0, **kw)

        self._dash_fetch = _dash_fetch
        _m.register_collector(self._collector)
        _m.register_state_fetcher(self._dash_fetch)
        if self.config.metrics_port >= 0:
            self.metrics_addr = await _m.acquire_shared_server(
                host, self.config.metrics_port)
            self._metrics_held = True
        for _ in range(self.config.num_workers_prestart):
            asyncio.ensure_future(self._spawn_worker())
        if self.config.memory_monitor_interval_s > 0:
            self._mem_task = asyncio.ensure_future(
                self._memory_monitor_loop())
        if self.config.worker_cgroup_memory_bytes > 0:
            from ray_tpu_torch.runtime.cgroup import detect, sweep_stale
            self._cgroup_version = detect()  # once; spawns reuse it
            sweep_stale(self._cgroup_version)
        return self.addr

    async def stop(self):
        self._stopping = True
        try:
            # archive this node's spans at the head so the cluster
            # timeline survives the node (e.g. a driver session ending);
            # node_timeline turns empty afterwards so a concurrent
            # collect_timeline can't double-count this node
            tl = await self.node_timeline()
            self._events_archived = True
            if tl["events"]:
                try:
                    await self.pool.call(
                        self.head_addr, "report_node_events",
                        events=tl["events"], timeout=5.0)
                except Exception:
                    # head didn't ack (briefly down?): keep serving the
                    # local buffers so the spans aren't silently dropped
                    # from future collect_timeline calls — a possible
                    # applied-but-unacked duplicate beats losing them
                    self._events_archived = False
        except Exception:
            pass
        if self._hb_task:
            self._hb_task.cancel()
        if getattr(self, "_mem_task", None):
            self._mem_task.cancel()
        from ray_tpu_torch.util import metrics as _m
        if getattr(self, "_collector", None) is not None:
            _m.unregister_collector(self._collector)
        if getattr(self, "_dash_fetch", None) is not None:
            _m.unregister_state_fetcher(self._dash_fetch)
        if getattr(self, "_metrics_held", False):
            self._metrics_held = False
            await _m.release_shared_server()
        killed = [w for w in list(self.workers.values())
                  if w.proc is not None]
        for w in killed:
            await self._kill_worker(w)
        # Stop returns only once every worker process has exited (and a
        # caged one's cgroup, whose rmdir fails while the dying process
        # is still a member, is gone): the next owner of the node's
        # devices and memory finds them free. The _reap_worker tasks may
        # be cancelled when the loop closes right after this, so wait
        # here, with one shared bound, not one per worker.
        await self._wait_exited(killed)
        for w in killed:
            if w.cgroup is not None:
                w.cgroup.remove()
        await self.server.stop()
        await self.pool.close()
        self.store.shutdown()

    def _render_metrics(self) -> str:
        """Scrape-time node gauges in Prometheus text (reference exports
        the raylet's equivalents via stats/metric_defs.h)."""
        from ray_tpu_torch.util.metrics import _fmt_labels, _labels_key
        nid = self.node_id.hex()[:12]
        out = []

        def g(name, val, **labels):
            labels["node"] = nid
            out.append(f"ray_tpu_{name}"
                       f"{_fmt_labels(_labels_key(labels))} {val:g}")

        for k, v in self.resources_total.items():
            g("node_resource_total", v, resource=k)
        for k, v in self.available.items():
            g("node_resource_available", v, resource=k)
        by_state: Dict[str, int] = {}
        for w in self.workers.values():
            by_state[w.state] = by_state.get(w.state, 0) + 1
        for st, n in by_state.items():
            g("node_workers", n, state=st)
        g("node_lease_queue_depth", len(self._wait_queue))
        st = self.store.stats()
        g("object_store_objects", st["objects"])
        g("object_store_bytes_used", st["used_bytes"])
        g("object_store_bytes_capacity", st["capacity_bytes"])
        return "\n".join(out)

    # --- memory monitor (OOM killer) ------------------------------------
    # Analog of the reference's memory_monitor + worker killing policy
    # (reference: src/ray/common/memory_monitor.h,
    # raylet/worker_killing_policy.cc): sample worker RSS from /proc;
    # enforce an optional per-worker cap, and under node-wide memory
    # pressure kill the largest retriable consumer instead of letting
    # the kernel OOM-killer take down the agent.

    @staticmethod
    def _rss_bytes(pid: int) -> int:
        """Private resident memory: statm resident minus shared pages,
        so zero-copy reads of the shared object store don't count
        against the worker (the reference's killing policy likewise
        excludes shm, memory_monitor.h)."""
        try:
            with open(f"/proc/{pid}/statm") as f:
                parts = f.read().split()
            return (int(parts[1]) - int(parts[2])) * \
                os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            return 0

    @staticmethod
    def _node_memory_usage() -> float:
        """Usage fraction against the tighter of the host and the
        cgroup limit — inside a memory-limited container the host
        numbers never trip while the cgroup OOM killer would (the
        reference reads cgroup limits first for the same reason)."""
        best = 0.0
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0]) * 1024
            best = 1.0 - info["MemAvailable"] / info["MemTotal"]
        except (OSError, KeyError, ValueError, ZeroDivisionError):
            pass
        for cur_p, max_p in (
                ("/sys/fs/cgroup/memory.current",
                 "/sys/fs/cgroup/memory.max"),
                ("/sys/fs/cgroup/memory/memory.usage_in_bytes",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes")):
            try:
                with open(max_p) as f:
                    raw = f.read().strip()
                if raw == "max":
                    continue
                limit = int(raw)
                with open(cur_p) as f:
                    cur = int(f.read().strip())
                if 0 < limit < (1 << 60):
                    best = max(best, cur / limit)
                break
            except (OSError, ValueError, ZeroDivisionError):
                continue
        return best

    async def _memory_monitor_loop(self):
        from ray_tpu_torch.util import events
        while not self._stopping:
            await asyncio.sleep(self.config.memory_monitor_interval_s)
            try:
                victims = []
                cap = self.config.worker_rss_limit_bytes
                live = [(w, self._rss_bytes(w.proc.pid))
                        for w in self.workers.values()
                        if w.proc is not None and w.state != DEAD]
                if cap > 0:
                    victims += [(w, r) for w, r in live if r > cap]
                thr = self.config.memory_usage_threshold
                if not victims and 0 < thr < 1 \
                        and self._node_memory_usage() > thr:
                    # Prefer killing LEASED task workers (retriable)
                    # over actors; largest RSS first.
                    ranked = sorted(
                        (x for x in live if x[0].state in (LEASED, IDLE)),
                        key=lambda x: -x[1]) or sorted(
                        live, key=lambda x: -x[1])
                    if ranked:
                        victims = ranked[:1]
                for w, rss in victims:
                    events.record(
                        "memory", "oom_kill", worker=w.worker_id.hex(),
                        rss=rss, node=self.node_id.hex())
                    await self._kill_worker(w)
            except Exception:
                pass

    async def ping(self):
        return "pong"

    async def profile_worker(self, pid=None, worker_id=None,
                             op: str = "profile", duration_s: float = 2.0,
                             hz: int = 100):
        """Profile one of this node's processes by pid or worker id —
        the head fans a pid-targeted profile_target out here (it only
        knows actors' addresses; agents own the pid -> worker mapping).
        The agent process itself is profilable by its own pid (where a
        stuck lease queue or object pull would show up)."""
        raise NotImplementedError(
            "profile_worker: util/profiling.py is not ported to "
            "ray_tpu_torch yet (ROADMAP Queue 1 item 17)")

    async def node_forensics(self, timeout_s: float = 10.0):
        """The autopsy fan-out's node leg: this agent's own forensics
        dump plus one ``forensics_dump`` pull per live worker process
        on this node (concurrently — one wedged worker must not
        serialize the others). Per-worker failures degrade to error
        rows: on a hung node the absence of an answer is itself
        evidence."""
        raise NotImplementedError(
            "node_forensics: the postmortem half of util/forensics.py is "
            "not ported to ray_tpu_torch yet (ROADMAP Queue 1 item 17)")

    async def node_stats(self):
        return {"node_id": self.node_id,
                "resources_total": self.resources_total,
                "available": self.available,
                "workers": len([w for w in self.workers.values()
                                if w.state != DEAD]),
                "store": self.store.stats()}

    async def report_events(self, events: list) -> dict:
        """Workers push their span buffers here every second and at
        shutdown (worker.py flush_events), so spans survive worker exit
        — the reference's TaskEventBuffer -> GCS push, node-local."""
        self._worker_events.extend(events)
        return {"ok": True, "count": len(events)}

    async def clock_probe(self):
        """This node's wall clock, read inside the RPC handler: the
        head brackets the call with its own clock and estimates the
        per-node offset as remote - midpoint (NTP-style; the probe
        with the smallest RTT wins). collect_timeline ships the
        offsets with the events so to_chrome can de-skew cross-node
        lanes — workers share their node's clock, so node granularity
        covers their spans too."""
        return {"t": time.time()}

    async def node_timeline(self):
        """This node's event/span buffers: the agent's own plus
        everything its workers pushed (util/tracing.py; the control
        service fans out to all agents for the cluster view)."""
        if getattr(self, "_events_archived", False):
            return {"events": []}  # already handed to the head (stop())
        from ray_tpu_torch.util import events
        nid = self.node_id.hex()
        out = [{**e, "node": nid} for e in events.dump()]
        out.extend(self._worker_events.dump())
        return {"events": out}

    # --- heartbeats / cluster view ------------------------------------------

    async def _heartbeat_loop(self):
        period = self.config.health_check_period_s
        while not self._stopping:
            # Local reaping must run even when the head is unreachable —
            # partitions are exactly when orphaned grants/allocations
            # appear.
            try:
                self.store.sweep_unsealed(ttl_s=60.0)
                self._reap_unacked_leases()
            except Exception:
                pass
            try:
                self._view_version += 1
                r = await self.pool.call(
                    self.head_addr, "heartbeat", node_id=self.node_id,
                    resources_available=self.available,
                    version=self._view_version,
                    pending_demand=[req["resources"]
                                    for req, _ in self._wait_queue],
                    known_view=self._known_cluster_view,
                    timeout=10.0)
                if r.get("drained"):
                    # deliberately removed: stop beating — the node is
                    # mid-teardown and must not be resurrected
                    return
                if r.get("unknown"):
                    # Control service restarted (or we were GC'd): rejoin
                    # with the same node id and rebuild what the head lost
                    # — the reference's NotifyGCSRestart flow inverted
                    # (node_manager.proto:457); here the head's "unknown"
                    # reply is the restart signal.
                    await self._rejoin_head()
                elif r.get("view_blob") is not None:
                    # view rides pre-pickled (control caches one blob
                    # per version instead of re-encoding per node)
                    import pickle
                    self.cluster_view = pickle.loads(r["view_blob"])
                    self._known_cluster_view = r.get("view_version", -1)
            except Exception:
                pass
            await asyncio.sleep(period)

    async def _rejoin_head(self):
        # a restarted control has fresh view versions: re-fetch
        self._known_cluster_view = -1
        r = await self.pool.call(
            self.head_addr, "register_node", node_id=self.node_id,
            addr=self.addr, resources_total=self.resources_total,
            labels=self.labels)
        if not r.get("ok"):
            return  # drained across the restart: stay out
        # re-confirm hosted actors (their table rows survived in the
        # persisted store; the addr refresh makes them routable again)
        for w in list(self.workers.values()):
            if w.actor_id is not None:
                try:
                    r = await self.pool.call(
                        self.head_addr, "actor_started",
                        actor_id=w.actor_id, addr=w.addr,
                        node_id=self.node_id)
                    if r.get("dead"):
                        # the table says this actor was killed (the kill
                        # RPC may have been lost): reap the orphan
                        w.actor_id = None
                        await self._kill_worker(w)
                except Exception:
                    pass
        # re-publish the object directory in one bulk RPC
        objs = self.store.sealed_objects()
        if objs:
            try:
                await self.pool.call(self.head_addr, "report_objects",
                                     node_id=self.node_id, objects=objs)
            except Exception:
                pass

    # --- worker pool ---------------------------------------------------------

    async def _resolve_env_packages(self, runtime_env: dict) -> dict:
        """Swap pkg:// working_dir/py_modules uris for locally-extracted
        paths: uncached package zips are fetched from the control KV
        (async, off the spawn path's critical RPCs), extraction runs in
        an executor (reference: runtime env agent downloading packages
        per node before worker start)."""
        from ray_tpu_torch.runtime import runtime_env as rt
        uris = []
        wd = runtime_env.get("working_dir")
        if wd and wd.startswith(rt.PKG_PREFIX):
            uris.append(wd)
        uris += [m for m in runtime_env.get("py_modules") or []
                 if m.startswith(rt.PKG_PREFIX)]
        if not uris:
            return runtime_env
        blobs = {}
        for uri in uris:
            key = rt.PKG_KV_PREFIX + rt.pkg_digest(uri)
            if key not in blobs and not rt.pkg_is_cached(uri):
                # only uncached digests hit the head — spawn churn on a
                # warm node must not re-download multi-MB zips
                blobs[key] = await self.pool.call(
                    self.head_addr, "kv_get", key=key, timeout=60.0)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, rt.resolve_packages, runtime_env, blobs.get)

    def _no_worker_error(self, env_hash: str) -> str:
        """'no worker available' is kept as the transient-retry marker
        (core._lease_err_transient matches on it); a venv setup failure
        for this env is appended so the user can tell a broken
        runtime_env from cluster saturation."""
        ve = self._venv_errors.get(env_hash)
        if ve:
            return f"no worker available (runtime_env setup failed: {ve})"
        return "no worker available"

    async def _spawn_worker(self, runtime_env: Optional[dict] = None,
                            env_hash: str = "") -> Optional[WorkerHandle]:
        from ray_tpu_torch.runtime.runtime_env import apply_to_env, venv_python
        wid = WorkerID.generate()
        orig_runtime_env = runtime_env   # pkg:// form — what children
        if runtime_env:                  # must inherit (local paths are
            try:                         # only valid on THIS node)
                runtime_env = await self._resolve_env_packages(
                    runtime_env)
            except Exception as e:  # noqa: BLE001 — env broken
                from ray_tpu_torch.util import events
                events.record("worker", "pkg_failed", error=str(e))
                self._venv_errors[env_hash] = f"package fetch: {e}"[:500]
                return None
        env = dict(os.environ)
        env.update(self.env_extra)
        env = apply_to_env(runtime_env, env)
        python = sys.executable
        if runtime_env and (runtime_env.get("pip")
                            or runtime_env.get("uv")):
            # cached per-requirements venv; creation (first use only)
            # runs off-loop — it may pip-install for minutes
            loop = asyncio.get_running_loop()
            try:
                python = await loop.run_in_executor(
                    None, venv_python, runtime_env) or sys.executable
            except Exception as e:  # noqa: BLE001 — env broken, not agent
                from ray_tpu_torch.util import events
                events.record("worker", "venv_failed", error=str(e))
                # remembered per env so the lease reply can tell the
                # caller WHY no worker appeared (vs mere saturation)
                self._venv_errors[env_hash] = str(e)[:500]
                return None
        if runtime_env:
            # Nested tasks submitted FROM this worker inherit its env
            # (reference: runtime_env inheritance parent -> child) —
            # in pkg:// form, portable to whatever node runs the child.
            import json as _json
            env["RAY_TPU_RT_ENV"] = _json.dumps(orig_runtime_env)
        env.update({
            "RAY_TPU_AGENT_HOST": self.addr[0],
            "RAY_TPU_AGENT_PORT": str(self.addr[1]),
            "RAY_TPU_HEAD_HOST": self.head_addr[0],
            "RAY_TPU_HEAD_PORT": str(self.head_addr[1]),
            "RAY_TPU_WORKER_ID": wid.hex(),
            "RAY_TPU_NODE_ID": self.node_id.hex(),
            "RAY_TPU_SESSION": self.session_id,
        })
        stdout = stderr = None
        if self.config.log_dir:
            # Worker stdio goes to per-worker files (reference: workers
            # log under the session dir, tailed by log_monitor.py). The
            # fd is handed to the child and closed here after spawn.
            os.makedirs(self.config.log_dir, exist_ok=True)
            logpath = os.path.join(self.config.log_dir,
                                   f"worker-{wid.hex()[:12]}.log")
            stdout = stderr = open(logpath, "ab", buffering=0)
        try:
            proc = await asyncio.create_subprocess_exec(
                python, "-m", "ray_tpu_torch.runtime.worker", env=env,
                stdout=stdout, stderr=stderr)
        finally:
            if stdout is not None:
                stdout.close()
        # env materialized fine: clear any stale setup-failure note so
        # later saturation isn't misreported as a broken runtime_env
        self._venv_errors.pop(env_hash, None)
        w = WorkerHandle(worker_id=wid, proc=proc, env_hash=env_hash)
        if self.config.worker_cgroup_memory_bytes > 0:
            from ray_tpu_torch.runtime.cgroup import WorkerCgroup
            from ray_tpu_torch.util import events
            w.cgroup = WorkerCgroup.create(
                f"{self.session_id[:8]}-{wid.hex()[:12]}",
                self.config.worker_cgroup_memory_bytes,
                getattr(self, "_cgroup_version", None))
            if w.cgroup is None:
                events.record("cgroup", "unavailable", worker=wid.hex())
            elif not w.cgroup.add_pid(proc.pid):
                # worker runs UNCONFINED — surface it, don't hide it
                events.record("cgroup", "attach_failed",
                              worker=wid.hex(), path=w.cgroup.path)
                w.cgroup.remove()
                w.cgroup = None
        self.workers[wid] = w
        asyncio.ensure_future(self._reap_worker(w))
        try:
            await asyncio.wait_for(
                w.ready.wait(), self.config.worker_start_timeout_s)
        except asyncio.TimeoutError:
            await self._kill_worker(w)
            return None
        return w

    async def _reap_worker(self, w: WorkerHandle):
        if w.proc is None:
            return
        await w.proc.wait()
        if w.cgroup is not None:
            w.cgroup.remove()
        dead_actor = w.actor_id
        was = w.state
        w.state = DEAD
        self.workers.pop(w.worker_id, None)
        if w.lease_id:
            await self.release_lease(w.lease_id, worker_died=True)
        if w.actor_resources is not None:
            pg = w.actor_pg or (None, None)
            self._release_res(w.actor_resources, pg[0], pg[1])
            w.actor_resources = None
            self._drain_queue()
        if dead_actor is not None and not self._stopping:
            try:
                await self.pool.call(
                    self.head_addr, "actor_failed", actor_id=dead_actor,
                    reason=f"worker process exited (rc="
                           f"{w.proc.returncode}, state={was})")
            except Exception:
                pass

    async def _wait_exited(self, workers: List[WorkerHandle]) -> None:
        """Wait for the terminated ``workers``' processes to exit, all
        under one bound: the workers' own exit backstop after SIGTERM
        (``preempt_grace_s`` + 3 s, ``worker.py``) and a second more;
        then SIGKILL whatever is left and wait for it."""
        procs = [w.proc for w in workers if w.proc.returncode is None]
        if not procs:
            return
        bound = float(getattr(self.config, "preempt_grace_s", 0.0)
                      or 0.0) + 4.0
        await asyncio.wait([asyncio.ensure_future(p.wait()) for p in procs],
                           timeout=bound)
        left = [p for p in procs if p.returncode is None]
        for p in left:
            try:
                p.kill()
            except ProcessLookupError:
                pass
        if left:
            await asyncio.wait([asyncio.ensure_future(p.wait())
                                for p in left], timeout=5.0)

    async def _kill_worker(self, w: WorkerHandle):
        w.state = DEAD
        if w.proc is not None and w.proc.returncode is None:
            try:
                w.proc.terminate()
            except ProcessLookupError:
                pass

    async def worker_ready(self, worker_id: WorkerID, addr):
        w = self.workers.get(worker_id)
        if w is None:
            return {"ok": False}
        w.addr = tuple(addr)
        if w.state == STARTING:
            w.state = IDLE
        w.ready.set()
        return {"ok": True}

    def _pop_idle(self, env_hash: str = "") -> Optional[WorkerHandle]:
        for w in self.workers.values():
            if w.state == IDLE and w.addr is not None \
                    and w.env_hash == env_hash:
                return w
        return None

    async def _get_worker(self, runtime_env: Optional[dict] = None,
                          env_hash: str = "") -> Optional[WorkerHandle]:
        """Pop an idle worker (from this runtime env's pool), else spawn
        — but claim a worker already mid-boot before spawning an (n+1)th:
        process startup pays a ~2s interpreter+plugin import, and
        concurrent spawns contend on CPU (the reference's worker pool
        likewise prefers its starting workers and keys pools by
        runtime_env_hash, raylet/worker_pool.cc PopWorker)."""
        self._worker_claims[env_hash] = \
            self._worker_claims.get(env_hash, 0) + 1
        try:
            loop = asyncio.get_running_loop()
            deadline = loop.time() + self.config.worker_start_timeout_s
            while True:
                w = self._pop_idle(env_hash)
                if w is not None:
                    return w
                live = [x for x in self.workers.values()
                        if x.state != DEAD]
                if len(live) >= self.config.max_workers_per_node:
                    # Pool saturated: evict an idle worker of ANOTHER
                    # runtime env — otherwise an env-A-full node could
                    # never serve env-B work (the reference's pool kills
                    # idle workers to make room the same way).
                    victim = next(
                        (x for x in live if x.state == IDLE
                         and x.env_hash != env_hash), None)
                    if victim is None:
                        return None
                    await self._kill_worker(victim)
                    continue
                starting = sum(1 for x in live if x.state == STARTING
                               and x.env_hash == env_hash)
                if starting < self._worker_claims.get(env_hash, 0):
                    return await self._spawn_worker(runtime_env, env_hash)
                if loop.time() > deadline:
                    return None
                await asyncio.sleep(0.02)
        finally:
            self._worker_claims[env_hash] -= 1

    # --- leases (task scheduling) --------------------------------------------

    def _avail_for(self, pg_id, bundle_index) -> dict:
        if pg_id is not None:
            key = (pg_id, bundle_index)
            return self.bundle_avail.get(key, {})
        return self.available

    def _try_acquire(self, resources: dict, pg_id, bundle_index) -> bool:
        pool = self._avail_for(pg_id, bundle_index)
        if not _fits(resources, pool):
            return False
        for k, v in resources.items():
            pool[k] = pool.get(k, 0.0) - v
        return True

    def _release_res(self, resources: dict, pg_id, bundle_index):
        pool = self._avail_for(pg_id, bundle_index)
        for k, v in resources.items():
            pool[k] = pool.get(k, 0.0) + v

    _spread_counter = 0

    def _spread_target(self, resources: dict) -> Optional[Tuple[str, int]]:
        """Round-robin over capacity-feasible nodes (self included)."""
        nodes = []
        if _fits(resources, self.resources_total):
            nodes.append((self.node_id.hex(), tuple(self.addr)))
        for nid, info in self.cluster_view.items():
            if nid == self.node_id or not info.get("alive"):
                continue
            if _fits(resources, info.get("total", {})):
                nodes.append((nid.hex(), tuple(info["addr"])))
        if not nodes:
            return None
        nodes.sort()
        NodeAgent._spread_counter += 1
        return nodes[NodeAgent._spread_counter % len(nodes)][1]

    def _capacity_target(self, resources: dict) -> Optional[Tuple[str, int]]:
        for nid, info in self.cluster_view.items():
            if nid == self.node_id or not info.get("alive"):
                continue
            if _fits(resources, info.get("total", {})):
                return tuple(info["addr"])
        return None

    def _spillback_target(self, resources: dict) -> Optional[Tuple[str, int]]:
        """Pick a peer whose AVAILABLE resources fit, preferring the most
        loaded feasible node under HYBRID (pack) or least loaded under
        SPREAD (reference: hybrid_scheduling_policy.h)."""
        cands = []
        for nid, info in self.cluster_view.items():
            if nid == self.node_id or not info.get("alive"):
                continue
            if _fits(resources, info.get("available", {})):
                free = sum(info["available"].values())
                cands.append((free, tuple(info["addr"])))
        if not cands:
            return None
        if self.config.scheduler_policy == "spread":
            return max(cands)[1]
        return min(cands)[1]

    async def request_lease(self, resources: dict, pg_id=None,
                            bundle_index=None, policy: str = "default",
                            allow_spillback: bool = True,
                            timeout: Optional[float] = None,
                            runtime_env: Optional[dict] = None):
        """Grant a worker lease (reference: NodeManager::
        HandleRequestWorkerLease -> ClusterLeaseManager). Reply is one of
        {granted, spillback, error}."""
        resources = dict(resources or {})
        # SPREAD: rotate leases round-robin over all capacity-feasible nodes
        # regardless of local room (reference: SPREAD policy in
        # scheduling/policy/scheduling_options.h).
        if pg_id is None and allow_spillback and policy == "spread":
            target = self._spread_target(resources)
            if target is not None and tuple(target) != tuple(self.addr):
                return {"spillback": target}
        local_ok = self._try_acquire(resources, pg_id, bundle_index)
        if not local_ok:
            if pg_id is None and allow_spillback \
                    and not _fits(resources, self.resources_total):
                # Never feasible here. Prefer a peer with room now; else a
                # peer whose total capacity fits (request queues there).
                # An empty view may just be membership lag (fresh node, or
                # a peer about to join) — poll briefly before declaring the
                # demand infeasible cluster-wide.
                target = (self._spillback_target(resources)
                          or self._capacity_target(resources))
                if target is None:
                    target = await self._await_feasible_peer(resources)
                if target is not None:
                    return {"spillback": target}
                return {"error": f"infeasible resources {resources}"}
            # queue until resources free up locally
            fut = asyncio.get_running_loop().create_future()
            self._wait_queue.append(
                ({"resources": resources, "pg_id": pg_id,
                  "bundle_index": bundle_index}, fut))
            try:
                await asyncio.wait_for(
                    fut, timeout or self.config.lease_timeout_s)
            except asyncio.TimeoutError:
                return {"error": "lease timeout"}
        from ray_tpu_torch.runtime.runtime_env import env_hash as _ehash
        eh = _ehash(runtime_env)
        w = await self._get_worker(runtime_env, eh)
        if w is None:
            self._release_res(resources, pg_id, bundle_index)
            self._drain_queue()
            return {"error": self._no_worker_error(eh)}
        self._lease_seq += 1
        lease_id = f"{self.node_id.hex()[:8]}:{self._lease_seq}"
        w.state = LEASED
        w.lease_id = lease_id
        self.leases[lease_id] = _Lease(
            lease_id=lease_id, worker=w, resources=resources,
            pg_id=pg_id, bundle_index=bundle_index)
        return {"granted": {"lease_id": lease_id, "worker_addr": w.addr,
                            "worker_id": w.worker_id}}

    async def _await_feasible_peer(self, resources: dict,
                                   window_s: Optional[float] = None):
        """Poll the synced cluster view for a capacity-feasible peer; the
        view refreshes via heartbeat piggyback, so a fresh node sees peers
        within one heartbeat period. While polling, the shape rides the
        heartbeat's pending_demand so an autoscaler can see demand no
        current node can fit and launch capacity into the window."""
        entry = ({"resources": resources}, None)
        self._wait_queue.append(entry)
        try:
            if window_s is None:
                window_s = self.config.infeasible_wait_window_s
            deadline = asyncio.get_running_loop().time() + min(
                window_s, self.config.lease_timeout_s)
            while asyncio.get_running_loop().time() < deadline:
                await asyncio.sleep(0.2)
                target = (self._spillback_target(resources)
                          or self._capacity_target(resources))
                if target is not None:
                    return target
            return None
        finally:
            try:
                self._wait_queue.remove(entry)
            except ValueError:
                pass

    async def ack_lease(self, lease_id: str):
        """Client confirms it received the grant. Un-acked leases are
        reaped: if the grant REPLY is lost in transit (connection drop,
        injected chaos), the client retries and takes a fresh lease — the
        orphaned grant would otherwise pin its resources forever
        (reference: raylet reclaims leases when the owning client
        disconnects; the RPC plane here has no per-client connection
        identity, so an explicit ack carries the same information)."""
        lease = self.leases.get(lease_id)
        if lease is None:
            return {"ok": False}  # already reaped — caller re-leases
        lease.acked = True
        return {"ok": True}

    def _reap_unacked_leases(self, grace_s: float = 60.0):
        """grace_s must exceed the client's worst-case ack envelope
        (5s timeout x 5 transport retries + backoff ~= 30s) so only
        truly orphaned grants are reaped. Reaped workers are KILLED,
        not returned to the pool: the client may believe it owns the
        lease and be mid-dispatch — termination is the fence."""
        now = time.monotonic()
        stale = [l for l in self.leases.values()
                 if not l.acked and now - l.granted_at > grace_s]
        for l in stale:
            async def _fence(lease=l):
                await self.release_lease(lease.lease_id,
                                         worker_died=True)
                await self._kill_worker(lease.worker)
            asyncio.ensure_future(_fence())

    async def release_lease(self, lease_id: str, worker_died: bool = False):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return {"ok": False}
        if not lease.blocked:  # blocked leases already gave back resources
            self._release_res(lease.resources, lease.pg_id,
                              lease.bundle_index)
        w = lease.worker
        if not worker_died and w.state == LEASED:
            w.state = IDLE
            w.lease_id = None
        self._drain_queue()
        return {"ok": True}

    async def worker_blocked(self, worker_id: WorkerID, token: str = ""):
        """The worker is parked in a blocking get()/wait() inside its
        task: release the lease's resources so the tasks it is waiting ON
        can take leases here — without this, a parent task on a saturated
        node deadlocks against its own children (the reference releases a
        blocked worker's CPU the same way, raylet/node_manager.cc
        HandleWorkerBlocked). `token` identifies one blocking episode so
        that RPC-level retries are idempotent (re-adding a present token
        is a no-op)."""
        for lease in self.leases.values():
            if lease.worker.worker_id == worker_id:
                if token in lease.blocked:  # retried RPC — already applied
                    return {"ok": True}
                was_empty = not lease.blocked
                lease.blocked.add(token)
                if was_empty:
                    self._release_res(lease.resources, lease.pg_id,
                                      lease.bundle_index)
                    self._drain_queue()
                return {"ok": True}
        return {"ok": False}

    async def worker_unblocked(self, worker_id: WorkerID, token: str = ""):
        for lease in self.leases.values():
            if lease.worker.worker_id == worker_id \
                    and token in lease.blocked:
                lease.blocked.discard(token)
                if not lease.blocked and not self._try_acquire(
                        lease.resources, lease.pg_id, lease.bundle_index):
                    # the freed capacity went to children while we were
                    # blocked: run temporarily oversubscribed (available
                    # goes negative) rather than deadlock on re-acquire —
                    # it self-corrects as leases release
                    pool = self._avail_for(lease.pg_id, lease.bundle_index)
                    for k, v in lease.resources.items():
                        pool[k] = pool.get(k, 0.0) - v
                return {"ok": True}
        # Unknown token: either the matching worker_blocked never applied
        # (request lost before reaching us) or the lease already released.
        # Both are safe no-ops — callers send unblock unconditionally after
        # an *attempted* block precisely so an applied-but-unacked block
        # can't leak.
        return {"ok": False}

    def _drain_queue(self):
        still = []
        for req, fut in self._wait_queue:
            if fut is None:  # demand marker (feasibility poll), not a waiter
                still.append((req, fut))
                continue
            if fut.done():
                continue
            if self._try_acquire(req["resources"], req["pg_id"],
                                 req["bundle_index"]):
                fut.set_result(True)
            else:
                still.append((req, fut))
        self._wait_queue = still

    # --- actors ---------------------------------------------------------------

    async def start_actor(self, actor_id: ActorID, creation_spec: bytes,
                          resources: dict,
                          runtime_env: Optional[dict] = None):
        resources = dict(resources or {})
        pg_id = None
        bundle_index = None
        # placement-group constraint rides inside resources as pseudo-keys
        if "_pg" in resources:
            pg_id = resources.pop("_pg")
            bundle_index = resources.pop("_pg_bundle", None)
        if not self._try_acquire(resources, pg_id, bundle_index):
            # queue until capacity frees (the reference keeps actor creation
            # pending in the GCS scheduler; here we park on the agent)
            fut = asyncio.get_running_loop().create_future()
            self._wait_queue.append(
                ({"resources": resources, "pg_id": pg_id,
                  "bundle_index": bundle_index}, fut))
            try:
                await asyncio.wait_for(fut, self.config.lease_timeout_s)
            except asyncio.TimeoutError:
                return {"ok": False,
                        "error": f"insufficient resources for actor "
                                 f"{resources} (timed out queued)"}
        from ray_tpu_torch.runtime.runtime_env import env_hash as _ehash
        eh = _ehash(runtime_env)
        w = await self._get_worker(runtime_env, eh)
        if w is None:
            self._release_res(resources, pg_id, bundle_index)
            return {"ok": False, "error": self._no_worker_error(eh)}
        w.state = ACTOR
        w.actor_id = actor_id
        w.actor_resources = dict(resources)
        w.actor_pg = (pg_id, bundle_index) if pg_id is not None else None
        try:
            r = await self.pool.call(
                w.addr, "host_actor", actor_id=actor_id,
                creation_spec=creation_spec,
                timeout=self.config.actor_init_timeout_s)
            if not r.get("ok"):
                raise RuntimeError(r.get("error", "host_actor failed"))
        except Exception as e:  # noqa: BLE001
            self._release_res(resources, pg_id, bundle_index)
            await self._kill_worker(w)
            return {"ok": False, "error": f"{e}"}
        await self.pool.call(
            self.head_addr, "actor_started", actor_id=actor_id,
            addr=w.addr, node_id=self.node_id)
        return {"ok": True, "addr": w.addr}

    async def kill_actor_worker(self, actor_id: ActorID):
        for w in list(self.workers.values()):
            if w.actor_id == actor_id:
                w.actor_id = None  # suppress actor_failed report
                await self._kill_worker(w)  # _reap_worker frees resources
                return {"ok": True}
        return {"ok": False}

    # --- placement group bundles ----------------------------------------------

    async def prepare_bundle(self, pg_id: PlacementGroupID, bundle_index: int,
                             resources: dict):
        resources = dict(resources)
        if not self._try_acquire(resources, None, None):
            return {"ok": False, "error": "insufficient resources"}
        self.bundles.setdefault(pg_id, {})[bundle_index] = (resources, False)
        return {"ok": True}

    async def commit_bundle(self, pg_id: PlacementGroupID, bundle_index: int):
        ent = self.bundles.get(pg_id, {}).get(bundle_index)
        if ent is None:
            return {"ok": False}
        resources, _ = ent
        self.bundles[pg_id][bundle_index] = (resources, True)
        self.bundle_avail[(pg_id, bundle_index)] = dict(resources)
        return {"ok": True}

    async def return_bundle(self, pg_id: PlacementGroupID, bundle_index: int):
        ent = self.bundles.get(pg_id, {}).pop(bundle_index, None)
        if ent is None:
            return {"ok": False}
        resources, _ = ent
        self.bundle_avail.pop((pg_id, bundle_index), None)
        self._release_res(resources, None, None)
        self._drain_queue()
        return {"ok": True}

    # --- object plane -----------------------------------------------------------

    async def alloc_object(self, oid: ObjectID, size: int):
        """Reserve store space for a local producer; it writes the frame
        into (segname, offset) then calls seal_object (plasma's
        Create/Seal split, reference: plasma/store.h)."""
        segname, offset = self.store.allocate(oid, size)
        return {"segname": segname, "offset": offset}

    async def seal_object(self, oid: ObjectID):
        self.store.seal(oid)
        size = self.store.size_of(oid)
        await self.pool.call(self.head_addr, "add_object_location",
                             oid=oid, node_id=self.node_id, size=size)
        return {"ok": True}

    async def abort_object(self, oid: ObjectID):
        self.store.abort(oid)
        return {"ok": True}

    async def resolve_object(self, oid: ObjectID, pull: bool = True):
        """Local (segname, offset) for oid, pulling from a remote node if
        needed (reference: PullManager + ObjectManager chunked transfer)."""
        loc = self.store.location(oid)
        if loc is not None:
            return {"segname": loc[0], "offset": loc[1], "size": loc[2]}
        if not pull:
            return {"segname": None}
        # Dedup concurrent pulls of the same object (reference:
        # pull_manager.h tracks active pulls per object).
        inflight = self._pulls.get(oid)
        if inflight is None:
            inflight = asyncio.ensure_future(self._pull_from_any(oid))
            self._pulls[oid] = inflight
            inflight.add_done_callback(
                lambda _f: self._pulls.pop(oid, None))
        ok = await asyncio.shield(inflight)
        if not ok:
            return {"segname": None}
        loc = self.store.location(oid)
        if loc is None:
            return {"segname": None}
        return {"segname": loc[0], "offset": loc[1], "size": loc[2]}

    async def _pull_from_any(self, oid: ObjectID) -> bool:
        locs = await self.pool.call(self.head_addr, "get_object_locations",
                                    oid=oid)
        for loc in locs:
            if loc["node_id"] == self.node_id:
                continue
            try:
                await self._pull(oid, tuple(loc["addr"]), loc["size"])
                return True
            except Exception:
                continue
        return False

    async def _pull(self, oid: ObjectID, addr: Tuple[str, int], size: int):
        chunk = self.config.object_transfer_chunk_bytes
        mv = self.store.create(oid, size)
        try:
            off = 0
            while off < size:
                n = min(chunk, size - off)
                data = await self.pool.call(
                    addr, "fetch_chunk", oid=oid, offset=off, size=n)
                if data is None:
                    raise IOError(f"chunk fetch failed for {oid}")
                mv[off:off + len(data)] = data
                off += len(data)
        except Exception:
            self.store.delete(oid)
            raise
        self.store.seal(oid)
        await self.pool.call(self.head_addr, "add_object_location",
                             oid=oid, node_id=self.node_id, size=size)

    async def fetch_chunk(self, oid: ObjectID, offset: int, size: int):
        mv = self.store.get(oid)
        if mv is None:
            return None
        return bytes(mv[offset:offset + size])

    async def free_objects(self, oids: List[ObjectID]):
        for oid in oids:
            self.store.delete(oid)
            try:
                await self.pool.call(self.head_addr, "remove_object_location",
                                     oid=oid, node_id=self.node_id)
            except Exception:
                pass
        return {"ok": True}


def _fits(demand: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())
