"""Control service: cluster-global state on the head node.

The GCS analog (reference: src/ray/gcs/gcs_server.h, gcs_node_manager.h,
gcs/actor/gcs_actor_manager.h, gcs_placement_group_manager.h,
gcs_kv_manager.h, gcs_health_check_manager.h, pubsub/publisher.h). Holds:
node membership + health, the actor directory (with restart FSM), the
object-location directory, a KV store, the job table, placement groups
(2-phase reserve across agents), and a long-poll pubsub used to broadcast
node/actor events.

Storage is in-memory (the reference's default; its Redis persistence is a
pluggable StoreClient — same seam exists here via `self._tables`).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.config import Config
from ray_tpu_torch.runtime import rpc
from ray_tpu_torch.runtime.ids import (ActorID, JobID, NodeID, ObjectID,
                                       PlacementGroupID)

# Actor lifecycle states (reference: gcs/actor/gcs_actor_manager.h FSM).
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


@dataclass
class NodeInfo:
    node_id: NodeID
    addr: Tuple[str, int]              # agent RPC address
    resources_total: Dict[str, float]
    resources_available: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    version: int = 0                   # resource-view version (syncer)
    pending_demand: List[dict] = field(default_factory=list)
    drained: bool = False              # deliberate removal: never resurrect


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    state: str = PENDING
    addr: Optional[Tuple[str, int]] = None     # hosting worker RPC addr
    node_id: Optional[NodeID] = None
    max_restarts: int = 0
    num_restarts: int = 0
    class_name: str = ""
    resources: Dict[str, float] = field(default_factory=dict)
    creation_spec: Optional[bytes] = None      # re-spawn payload for restart
    death_cause: Optional[str] = None
    namespace: str = "default"
    pg: Optional[tuple] = None                 # (pg_id, bundle_index)
    max_concurrency: int = 1                   # callers batch iff == 1
    runtime_env: Optional[dict] = None


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str
    state: str = "PENDING"             # PENDING | CREATED | REMOVED
    bundle_nodes: List[Optional[NodeID]] = field(default_factory=list)
    name: Optional[str] = None


class Pubsub:
    """Per-channel event logs consumed by long-poll (reference:
    pubsub/publisher.h long-poll protocol)."""

    def __init__(self, maxlen: int = 65536):
        self._events: Dict[str, List[Tuple[int, Any]]] = {}
        self._next: Dict[str, int] = {}
        self._cond = asyncio.Condition()
        self._maxlen = maxlen

    async def publish(self, channel: str, event: Any) -> None:
        async with self._cond:
            seq = self._next.get(channel, 0)
            self._next[channel] = seq + 1
            log = self._events.setdefault(channel, [])
            log.append((seq, event))
            if len(log) > self._maxlen:
                del log[: len(log) // 2]
            self._cond.notify_all()

    async def poll(self, channel: str, cursor: int,
                   timeout: float = 30.0) -> Tuple[int, List[Any]]:
        deadline = time.monotonic() + timeout
        async with self._cond:
            while True:
                log = self._events.get(channel, [])
                fresh = [e for seq, e in log if seq >= cursor]
                if fresh:
                    return self._next.get(channel, 0), fresh
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._next.get(channel, 0), []
                try:
                    await asyncio.wait_for(self._cond.wait(), remaining)
                except asyncio.TimeoutError:
                    return self._next.get(channel, 0), []


class ControlService:
    def __init__(self, config: Optional[Config] = None,
                 persist_dir: Optional[str] = None):
        self.config = config or Config.from_env()
        # Durable tables (GCS-persistence analog, see runtime/persistence.py):
        # set RAY_TPU_CONTROL_PERSIST_DIR or pass persist_dir to survive
        # control-service restarts; nodes reconnect via heartbeats.
        self._store = None
        persist_dir = persist_dir or self.config.control_persist_dir
        if persist_dir:
            from ray_tpu_torch.runtime.persistence import FileStore
            self._store = FileStore(persist_dir)
        self._recover_deadline = 0.0
        self._drained: set = set()         # node ids removed for good
        from ray_tpu_torch.util.events import CategoryBuffer
        # span buffers archived by departing nodes (collect_timeline);
        # per-category budgets, same rule as the node-local buffers
        self._archived_events = CategoryBuffer(
            maxlen=self.config.event_buffer_size)
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.kv: Dict[str, bytes] = {}
        self.jobs: Dict[JobID, dict] = {}
        self.submitted_jobs: Dict[str, dict] = {}
        self.pgs: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        # object directory: oid -> {node_id: size}
        self.object_locations: Dict[ObjectID, Dict[NodeID, int]] = {}
        self.pubsub = Pubsub()
        # Epoch-seeded so a restarted control never hands out a version
        # an old incarnation already used (agents gate view refresh on
        # equality; rejoin also resets, this is belt-and-braces).
        self._view_version = int(time.time() * 1000) << 8
        self._view_blob_cache = (0, 0.0, None)   # (version, built_at, blob)
        self.pool = rpc.ConnectionPool()
        self.server = rpc.RpcServer(
            self._handlers(),
            chaos=rpc.ChaosPlan(self.config.testing_rpc_failure))
        self.addr: Optional[Tuple[str, int]] = None
        self._health_task: Optional[asyncio.Task] = None

    def _handlers(self):
        return {
            "register_node": self.register_node,
            "heartbeat": self.heartbeat,
            "drain_node": self.drain_node,
            "get_nodes": self.get_nodes,
            "kv_put": self.kv_put, "kv_get": self.kv_get,
            "kv_del": self.kv_del, "kv_keys": self.kv_keys,
            "register_actor": self.register_actor,
            "actor_started": self.actor_started,
            "actor_failed": self.actor_failed,
            "kill_actor": self.kill_actor,
            "get_actor": self.get_actor,
            "wait_actor_alive": self.wait_actor_alive,
            "get_named_actor": self.get_named_actor,
            "list_actors": self.list_actors,
            "register_job": self.register_job,
            "finish_job": self.finish_job,
            "list_jobs": self.list_jobs,
            "submit_job": self.submit_job,
            "get_submitted_job": self.get_submitted_job,
            "list_submitted_jobs": self.list_submitted_jobs,
            "stop_submitted_job": self.stop_submitted_job,
            "submitted_job_logs": self.submitted_job_logs,
            "create_pg": self.create_pg,
            "remove_pg": self.remove_pg,
            "get_pg": self.get_pg,
            "list_pgs": self.list_pgs,
            "add_object_location": self.add_object_location,
            "report_objects": self.report_objects,
            "collect_timeline": self.collect_timeline,
            "report_node_events": self.report_node_events,
            "remove_object_location": self.remove_object_location,
            "get_object_locations": self.get_object_locations,
            "poll_events": self.poll_events,
            "cluster_view": self.cluster_view,
            "report_metrics": self.report_metrics,
            "profile_target": self.profile_target,
            "autopsy": self.autopsy,
            "health_state": self.health_state,
            "query_series": self.query_series,
            "ping": self.ping,
        }

    # --- persistence --------------------------------------------------------

    def _persist(self, table: str, key, value) -> None:
        if self._store is not None:
            self._store.put(table, key, value)
            self._maybe_compact(table)

    def _persist_del(self, table: str, key) -> None:
        if self._store is not None:
            self._store.delete(table, key)
            self._maybe_compact(table)

    def _live_table(self, table: str):
        """The authoritative in-memory state for a persisted table, used
        to rewrite its log during online compaction."""
        if table == "kv":
            return self.kv
        if table == "actors":
            return self.actors
        if table == "jobs":
            return self.jobs
        if table == "submitted_jobs":
            return self.submitted_jobs
        if table == "pgs":
            # REMOVED pgs stay in self.pgs for status queries but have a
            # "del" record in the log — compacting them back in as "put"s
            # would resurrect them across a restart
            return {pid: info for pid, info in self.pgs.items()
                    if getattr(info, "state", None) != "REMOVED"}
        if table == "drained":
            return {nid: True for nid in self._drained}
        return None

    def _maybe_compact(self, table: str) -> None:
        """Online compaction: rewrite a log that outgrew its live state
        by FileStore.COMPACT_GROWTH_FACTOR (without this, logs only
        compact on restart and grow unboundedly in long-lived clusters)."""
        if not self._store.should_compact(table):
            return
        state = self._live_table(table)
        if state is not None:
            self._store.compact(table, state)

    def _persist_actor(self, a: ActorInfo) -> None:
        self._persist("actors", a.actor_id, a)

    def _recover(self) -> None:
        """Replay persisted tables (reference: gcs/gcs_init_data.h rebuilds
        GCS state from the store on restart). Nodes are NOT persisted —
        agents re-register on their next heartbeat ("unknown" reply) and
        re-confirm hosted actors + object locations."""
        t = self._store.load_all()
        self.kv = t.get("kv", {})
        self.actors = t.get("actors", {})
        for a in self.actors.values():
            if a.name and a.state != DEAD:
                self.named_actors[(a.namespace, a.name)] = a.actor_id
        self.jobs = t.get("jobs", {})
        self.submitted_jobs = t.get("submitted_jobs", {})
        for j in self.submitted_jobs.values():
            if j.get("status") in ("PENDING", "RUNNING"):
                # the watcher subprocess handle died with the old control
                # process; the job may still run but is no longer tracked
                j["status"] = "FAILED"
                j["error"] = "control service restarted; job untracked"
        self.pgs = t.get("pgs", {})
        self._drained = set(t.get("drained", {}))
        for table, state in t.items():
            self._store.compact(table, state)
        # Give agents a grace window to reconnect before declaring their
        # actors dead (they heartbeat every health_check_period_s).
        grace = self.config.health_check_period_s * \
            self.config.health_check_failure_threshold * 2
        self._recover_deadline = time.monotonic() + max(grace, 5.0)

    def _after_recovery_sweep(self) -> None:
        """One-shot: actors whose node never re-registered are dead."""
        self._recover_deadline = 0.0
        lost = [a for a in self.actors.values()
                if a.state in (ALIVE, PENDING, RESTARTING)
                and (a.node_id is None or a.node_id not in self.nodes
                     or not self.nodes[a.node_id].alive)]
        for a in lost:
            asyncio.ensure_future(self._on_actor_death(
                a, "node lost across control-service restart"))

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        if self._store is not None:
            self._recover()
        self.addr = await self.server.start(host, port)
        self._health_task = asyncio.ensure_future(self._health_loop())
        # Cluster health plane (util/health.py): the head-side metrics
        # time-series store + SLO burn-rate evaluation loop. Gated by
        # RAY_TPU_HEALTH / Config.health_enabled; report_metrics feeds
        # the store from the same pushes merge_remote keeps.
        from ray_tpu_torch.util import health as _health
        self._healthplane_task = None
        if _health.enabled() and self.config.health_enabled:
            _health.activate(self.config)
            self._healthplane_task = asyncio.ensure_future(
                _health.head_loop(self.config))
        from ray_tpu_torch.util import metrics as _m
        self._collector = self._render_metrics
        _m.register_collector(self._collector)
        if self.config.metrics_port >= 0:
            self.metrics_addr = await _m.acquire_shared_server(
                host, self.config.metrics_port)
            self._metrics_held = True
        return self.addr

    async def stop(self):
        if self._health_task:
            self._health_task.cancel()
        if getattr(self, "_healthplane_task", None) is not None:
            self._healthplane_task.cancel()
            self._healthplane_task = None
            from ray_tpu_torch.util import health as _health
            _health.deactivate()   # a later cluster in this process
            # must not inherit this one's series or alert state
        from ray_tpu_torch.util import metrics as _m
        if getattr(self, "_collector", None) is not None:
            _m.unregister_collector(self._collector)
        if getattr(self, "_metrics_held", False):
            self._metrics_held = False
            await _m.release_shared_server()
        await self.server.stop()
        await self.pool.close()
        if self._store is not None:
            self._store.close()

    def _render_metrics(self) -> str:
        """Cluster-level gauges (reference: gcs metrics in
        stats/metric_defs.h, surfaced on the dashboard)."""
        from ray_tpu_torch.util.metrics import _fmt_labels, _labels_key
        out = []
        alive = sum(1 for n in self.nodes.values() if n.alive)
        out.append(f"ray_tpu_cluster_nodes_alive {alive}")
        out.append(f"ray_tpu_cluster_nodes_total {len(self.nodes)}")
        by_state: Dict[str, int] = {}
        for a in self.actors.values():
            by_state[a.state] = by_state.get(a.state, 0) + 1
        for st, n in by_state.items():
            lbl = _fmt_labels(_labels_key({"state": st}))
            out.append(f"ray_tpu_cluster_actors{lbl} {n}")
        out.append(f"ray_tpu_cluster_placement_groups {len(self.pgs)}")
        running = sum(1 for j in self.jobs.values()
                      if j.get("state") == "RUNNING")
        out.append(f"ray_tpu_cluster_jobs_running {running}")
        return "\n".join(out)

    async def ping(self):
        return "pong"

    # --- nodes / health ----------------------------------------------------

    async def register_node(self, node_id: NodeID, addr, resources_total,
                            labels=None):
        if node_id in self._drained:
            # deliberately removed; a re-register (e.g. rejoin after a
            # control restart) must not resurrect it
            return {"ok": False, "drained": True}
        self.nodes[node_id] = NodeInfo(
            node_id=node_id, addr=tuple(addr),
            resources_total=dict(resources_total),
            resources_available=dict(resources_total),
            labels=dict(labels or {}))
        self._bump_view()
        await self.pubsub.publish(
            "nodes", {"event": "node_added", "node_id": node_id,
                      "addr": tuple(addr)})
        return {"ok": True}

    async def heartbeat(self, node_id: NodeID, resources_available=None,
                        version: int = 0, pending_demand=None,
                        known_view: int = -1):
        """Liveness + resource-view sync in one beat (reference splits these
        across GcsHealthCheckManager and ray_syncer; one RPC suffices at
        TPU-pod node counts). The reply carries the cluster resource view
        (for local spillback decisions) ONLY when the agent's copy is
        stale: a naive view-per-beat reply is O(nodes^2)/s cluster-wide
        and measurably collapses the control core near 1,000 nodes
        (SCALE_BENCH_STRETCH.json) — the reference's ray_syncer exists
        for the same reason."""
        if node_id in self._drained:
            # covers the restart case too: the node isn't in self.nodes
            # (nodes aren't persisted) but the drain intent is — reply
            # "drained", not "unknown", so the agent stands down instead
            # of retrying _rejoin_head every period
            return {"ok": False, "drained": True}
        n = self.nodes.get(node_id)
        if n is None:
            return {"ok": False, "unknown": True}
        if n.drained:
            # Deliberately removed (scale-down / remove_node): a late
            # heartbeat from the dying process must not resurrect it.
            return {"ok": False, "drained": True}
        n.last_heartbeat = time.monotonic()
        if not n.alive:
            n.alive = True  # node came back before we GC'd it
            self._bump_view()
        if resources_available is not None:
            if resources_available != n.resources_available:
                n.resources_available = dict(resources_available)
                self._bump_view()
            n.version = version
        # pending_demand feeds the autoscaler via get_nodes, NOT _view():
        # no bump — it would only churn the snapshot cache.
        n.pending_demand = list(pending_demand or [])
        # Gate on the SNAPSHOT's version (what agents can actually hold),
        # not the live counter: under churn the live counter always leads
        # the throttled snapshot, and gating on it would re-ship the same
        # blob to every agent every beat — the O(nodes^2)/s this exists
        # to kill.
        ver, blob = self._view_snapshot()
        reply = {"ok": True, "view_version": ver}
        if known_view != ver:
            reply["view_blob"] = blob
        return reply

    def _bump_view(self) -> None:
        self._view_version += 1

    def _view_snapshot(self):
        """(version, pickled view), rebuilt at most every
        view_snapshot_interval_s: under churn every beat would otherwise
        rebuild + re-pickle an O(nodes) view per node per second. Agents
        tolerate sub-second staleness by design (they already act on
        views one heartbeat period old)."""
        import pickle
        ver, t, blob = self._view_blob_cache
        now = time.monotonic()
        if blob is None or (
                ver != self._view_version and
                now - t >= self.config.view_snapshot_interval_s):
            ver = self._view_version
            blob = pickle.dumps(self._view(), protocol=5)
            self._view_blob_cache = (ver, now, blob)
        return self._view_blob_cache[0], self._view_blob_cache[2]

    def _view(self):
        return {
            n.node_id: {
                "addr": n.addr, "alive": n.alive,
                "total": n.resources_total,
                "available": n.resources_available,
                "labels": n.labels,
            } for n in self.nodes.values() if n.alive
        }

    async def cluster_view(self):
        return self._view()

    async def get_nodes(self):
        return [
            {"node_id": n.node_id, "addr": n.addr, "alive": n.alive,
             "resources_total": n.resources_total,
             "resources_available": n.resources_available,
             "pending_demand": n.pending_demand,
             "labels": n.labels}
            for n in self.nodes.values()
        ]

    async def drain_node(self, node_id: NodeID):
        n = self.nodes.get(node_id)
        if n is not None:
            n.drained = True
        self._drained.add(node_id)
        # drain intent must survive a control restart, or the dying
        # node's agent would rejoin as a fresh healthy node
        self._persist("drained", node_id, True)
        await self._mark_node_dead(node_id, "drained")
        return {"ok": True}

    async def _health_loop(self):
        period = self.config.health_check_period_s
        threshold = period * self.config.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            if self._recover_deadline and now > self._recover_deadline:
                self._after_recovery_sweep()
            for n in list(self.nodes.values()):
                if n.alive and now - n.last_heartbeat > threshold:
                    await self._mark_node_dead(n.node_id, "heartbeat timeout")
            if self._store is not None:
                self._store.flush()   # bound the fsync-batching window

    async def _mark_node_dead(self, node_id: NodeID, reason: str):
        n = self.nodes.get(node_id)
        if n is None or not n.alive:
            return
        n.alive = False
        self._bump_view()
        await self.pubsub.publish(
            "nodes", {"event": "node_dead", "node_id": node_id,
                      "reason": reason})
        # Objects on the dead node are gone.
        for oid, locs in list(self.object_locations.items()):
            locs.pop(node_id, None)
            if not locs:
                del self.object_locations[oid]
        # Actors hosted there die (and maybe restart).
        for a in list(self.actors.values()):
            if a.node_id == node_id and a.state in (ALIVE, PENDING,
                                                    RESTARTING):
                await self._on_actor_death(a, f"node {node_id} died: {reason}")

    # --- kv ----------------------------------------------------------------

    # runtime_env package blobs (__rtpkg:*) are capped: without
    # eviction, every distinct working_dir version ever submitted lives
    # in head memory forever. LRU by insertion order (dict order, with
    # re-put moving a hit to the back); agents cache extractions
    # locally, and a driver's publish re-checks existence and
    # re-uploads an evicted package before use.
    PKG_KV_CAP_BYTES = 1024 * 1024 * 1024

    async def kv_put(self, key: str, value: bytes, overwrite: bool = True):
        if not overwrite and key in self.kv:
            if key.startswith("__rtpkg:"):
                self.kv[key] = self.kv.pop(key)    # LRU touch
            return {"ok": False, "exists": True}
        self.kv[key] = value
        self._persist("kv", key, value)
        if key.startswith("__rtpkg:"):
            pkgs = [(k, len(v)) for k, v in self.kv.items()
                    if k.startswith("__rtpkg:")]
            total = sum(n for _, n in pkgs)
            for k, n in pkgs:
                if total <= self.PKG_KV_CAP_BYTES or k == key:
                    break
                del self.kv[k]
                self._persist_del("kv", k)
                total -= n
        return {"ok": True}

    async def kv_get(self, key: str):
        return self.kv.get(key)

    async def kv_del(self, key: str):
        deleted = self.kv.pop(key, None) is not None
        if deleted:
            self._persist_del("kv", key)
        return {"deleted": deleted}

    async def kv_keys(self, prefix: str = ""):
        return [k for k in self.kv if k.startswith(prefix)]

    # --- actors ------------------------------------------------------------

    async def register_actor(self, actor_id: ActorID, name, class_name,
                             resources, max_restarts: int,
                             creation_spec: bytes, namespace: str = "default",
                             scheduling: Optional[dict] = None,
                             pg: Optional[tuple] = None,
                             max_concurrency: int = 1,
                             runtime_env: Optional[dict] = None):
        if name:
            key = (namespace, name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing and existing.state != DEAD:
                    return {"ok": False,
                            "error": f"actor name {name!r} taken"}
            self.named_actors[key] = actor_id
        info = ActorInfo(actor_id=actor_id, name=name, class_name=class_name,
                         resources=dict(resources),
                         max_restarts=max_restarts,
                         creation_spec=creation_spec, namespace=namespace,
                         pg=tuple(pg) if pg else None,
                         max_concurrency=int(max_concurrency),
                         runtime_env=runtime_env)
        self.actors[actor_id] = info
        node = await self._schedule_actor(info, scheduling or {})
        if node is None:
            info.state = DEAD
            info.death_cause = "no feasible node"
            self._persist_actor(info)
            return {"ok": False, "error": "no feasible node for actor"}
        self._persist_actor(info)
        return {"ok": True, "node_id": node.node_id}

    async def _schedule_actor(self, info: ActorInfo,
                              scheduling: dict) -> Optional[NodeInfo]:
        """Pick a node and ask its agent to start the actor (reference:
        gcs/actor/gcs_actor_scheduler.h — lease-based; here the agent owns
        its own worker pool so one RPC does lease+spawn)."""
        if info.pg is not None:
            # PG-constrained: the bundle's node is the only candidate.
            pg_info = self.pgs.get(info.pg[0])
            idx = info.pg[1]
            if pg_info is None or pg_info.state != "CREATED" or \
                    idx >= len(pg_info.bundle_nodes):
                return None
            node = self.nodes.get(pg_info.bundle_nodes[idx])
            if node is None or not node.alive:
                return None
        else:
            node = self._pick_node(info.resources, scheduling)
        if node is None:
            return None
        info.node_id = node.node_id
        asyncio.ensure_future(self._request_start(info, node))
        return node

    def _pick_node(self, resources: Dict[str, float],
                   scheduling: dict) -> Optional[NodeInfo]:
        cands = [n for n in self.nodes.values() if n.alive]
        nid = scheduling.get("node_id")
        if nid is not None:
            cands = [n for n in cands if n.node_id == nid]
        labels = scheduling.get("labels") or {}
        for k, v in labels.items():
            cands = [n for n in cands if n.labels.get(k) == v]
        feasible = [n for n in cands
                    if _fits(resources, n.resources_available)]
        if not feasible:
            # fall back to total-capacity feasibility (queue on the agent)
            feasible = [n for n in cands
                        if _fits(resources, n.resources_total)]
        if not feasible:
            return None
        # most-available-first spread for actors
        return max(feasible, key=lambda n: sum(
            n.resources_available.get(k, 0) - v
            for k, v in resources.items()) if resources else
            sum(n.resources_available.values()))

    async def _request_start(self, info: ActorInfo, node: NodeInfo):
        try:
            resources = dict(info.resources)
            if info.pg is not None:
                # agent-side pseudo-keys select the bundle's reservation
                resources["_pg"] = info.pg[0]
                resources["_pg_bundle"] = info.pg[1]
            r = await self.pool.call(
                node.addr, "start_actor",
                timeout=self.config.actor_init_timeout_s + 30.0,
                actor_id=info.actor_id, creation_spec=info.creation_spec,
                resources=resources, runtime_env=info.runtime_env)
            if not r.get("ok"):
                await self._on_actor_death(
                    info, r.get("error", "agent failed to start actor"))
        except Exception as e:  # noqa: BLE001
            await self._on_actor_death(info, f"start_actor rpc failed: {e}")

    async def actor_started(self, actor_id: ActorID, addr, node_id: NodeID):
        a = self.actors.get(actor_id)
        if a is None:
            return {"ok": False}
        if a.state == DEAD:
            # e.g. killed while the kill RPC to its agent was lost, then
            # the agent re-reports it after a control restart: the table
            # is authoritative — tell the agent to reap the worker.
            return {"ok": False, "dead": True}
        a.state = ALIVE
        a.addr = tuple(addr)
        a.node_id = node_id
        self._persist_actor(a)
        await self.pubsub.publish(
            f"actor:{actor_id.hex()}",
            {"event": "alive", "addr": a.addr})
        await self.pubsub.publish(
            "actors", {"event": "alive", "actor_id": actor_id})
        return {"ok": True}

    async def actor_failed(self, actor_id: ActorID, reason: str):
        a = self.actors.get(actor_id)
        if a is None:
            return {"ok": False}
        await self._on_actor_death(a, reason)
        return {"ok": True}

    async def _on_actor_death(self, a: ActorInfo, reason: str):
        if a.state == DEAD:
            return
        if a.num_restarts < a.max_restarts:
            a.num_restarts += 1
            a.state = RESTARTING
            a.addr = None
            self._persist_actor(a)
            await self.pubsub.publish(
                f"actor:{a.actor_id.hex()}",
                {"event": "restarting", "restarts": a.num_restarts})
            node = await self._schedule_actor(a, {})
            if node is not None:
                return
            reason = f"{reason}; restart found no feasible node"
        a.state = DEAD
        a.death_cause = reason
        a.addr = None
        self._persist_actor(a)
        await self.pubsub.publish(
            f"actor:{a.actor_id.hex()}", {"event": "dead", "reason": reason})
        await self.pubsub.publish(
            "actors", {"event": "dead", "actor_id": a.actor_id,
                       "reason": reason})

    async def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        a = self.actors.get(actor_id)
        if a is None:
            return {"ok": False}
        if no_restart:
            a.max_restarts = a.num_restarts  # exhaust budget
        node = self.nodes.get(a.node_id) if a.node_id else None
        if a.addr is not None and node is not None:
            try:
                await self.pool.call(node.addr, "kill_actor_worker",
                                     actor_id=actor_id)
            except Exception:
                pass
        await self._on_actor_death(a, "killed via kill_actor")
        return {"ok": True}

    async def get_actor(self, actor_id: ActorID):
        a = self.actors.get(actor_id)
        if a is None:
            return None
        return {"actor_id": a.actor_id, "state": a.state, "addr": a.addr,
                "name": a.name, "class_name": a.class_name,
                "node_id": a.node_id, "num_restarts": a.num_restarts,
                "death_cause": a.death_cause}

    async def wait_actor_alive(self, actor_id: ActorID,
                               wait_timeout: float = 60.0):
        """Park until the actor is ALIVE (or DEAD). Used by handles to
        resolve the actor's direct-call address."""
        deadline = time.monotonic() + wait_timeout
        cursor = 0
        chan = f"actor:{actor_id.hex()}"
        while True:
            a = self.actors.get(actor_id)
            if a is None:
                return {"state": "UNKNOWN"}
            if a.state == ALIVE:
                return {"state": ALIVE, "addr": a.addr,
                        "num_restarts": a.num_restarts,
                        "max_concurrency": a.max_concurrency}
            if a.state == DEAD:
                return {"state": DEAD, "reason": a.death_cause}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"state": a.state, "timeout": True}
            cursor, _ = await self.pubsub.poll(
                chan, cursor, timeout=min(remaining, 5.0))

    async def get_named_actor(self, name: str, namespace: str = "default"):
        aid = self.named_actors.get((namespace, name))
        if aid is None:
            return None
        return await self.get_actor(aid)

    async def list_actors(self):
        return [await self.get_actor(aid) for aid in list(self.actors)]

    # --- jobs --------------------------------------------------------------

    async def register_job(self, job_id: JobID, metadata=None):
        self.jobs[job_id] = {"job_id": job_id, "state": "RUNNING",
                             "start_time": time.time(),
                             "metadata": metadata or {}}
        self._persist("jobs", job_id, self.jobs[job_id])
        return {"ok": True}

    async def finish_job(self, job_id: JobID, state: str = "SUCCEEDED"):
        j = self.jobs.get(job_id)
        if j:
            j["state"] = state
            j["end_time"] = time.time()
            self._persist("jobs", job_id, j)
        return {"ok": True}

    async def list_jobs(self):
        return list(self.jobs.values())

    # --- job submission (entrypoint jobs) -----------------------------------
    # The head runs submitted entrypoints as driver subprocesses, tracks
    # their lifecycle, and captures logs (reference:
    # dashboard/modules/job/job_manager.py:62 JobManager.submit_job —
    # REST replaced by the same RPC plane everything else uses).

    async def submit_job(self, entrypoint: str, submission_id=None,
                         runtime_env: Optional[dict] = None):
        import os
        import tempfile
        import uuid as _uuid

        from ray_tpu_torch.runtime.runtime_env import apply_to_env
        sub_id = submission_id or f"rtjob-{_uuid.uuid4().hex[:10]}"
        if sub_id in self.submitted_jobs and \
                self.submitted_jobs[sub_id]["status"] in (
                    "PENDING", "RUNNING"):
            return {"ok": False, "error": f"job {sub_id!r} already active"}
        log_dir = self.config.log_dir or tempfile.gettempdir()
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"job-{sub_id}.log")
        env = apply_to_env(runtime_env, dict(os.environ))
        # Entrypoints can import what the head can (ray_tpu_torch itself,
        # notably) — python puts the SCRIPT's dir on sys.path, not cwd.
        import sys
        entries = [p if p else os.getcwd() for p in sys.path]
        prev = env.get("PYTHONPATH", "")  # user py_modules stay first
        env["PYTHONPATH"] = os.pathsep.join(
            dict.fromkeys(([prev] if prev else []) + entries))
        env["RAY_TPU_ADDRESS"] = f"{self.addr[0]}:{self.addr[1]}"
        env["RAY_TPU_SUBMISSION_ID"] = sub_id
        cwd = (runtime_env or {}).get("working_dir")
        logf = open(log_path, "ab", buffering=0)
        try:
            proc = await asyncio.create_subprocess_shell(
                entrypoint, env=env, cwd=cwd or None,
                stdout=logf, stderr=logf,
                start_new_session=True)
        except OSError as e:
            logf.close()
            return {"ok": False, "error": f"spawn failed: {e}"}
        finally:
            logf.close()
        job = {"submission_id": sub_id, "entrypoint": entrypoint,
               "status": "RUNNING", "pid": proc.pid,
               "log_path": log_path, "start_time": time.time()}
        self.submitted_jobs[sub_id] = job
        self._persist("submitted_jobs", sub_id, job)
        asyncio.ensure_future(self._watch_job(job, proc))
        return {"ok": True, "submission_id": sub_id}

    async def _watch_job(self, job: dict, proc):
        rc = await proc.wait()
        # The watcher is the single writer of terminal states: a stop
        # request only marks intent, so a job that happened to exit 0
        # before the signal landed still reports SUCCEEDED.
        if rc == 0:
            job["status"] = "SUCCEEDED"
        elif job.get("stop_requested"):
            job["status"] = "STOPPED"
        else:
            job["status"] = "FAILED"
        job["returncode"] = rc
        job["end_time"] = time.time()
        self._persist("submitted_jobs", job["submission_id"], job)

    async def get_submitted_job(self, submission_id: str):
        return self.submitted_jobs.get(submission_id)

    async def list_submitted_jobs(self):
        return list(self.submitted_jobs.values())

    async def stop_submitted_job(self, submission_id: str):
        import signal
        job = self.submitted_jobs.get(submission_id)
        if job is None:
            return {"ok": False, "error": "no such job"}
        if job["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
            return {"ok": True, "status": job["status"]}
        job["stop_requested"] = True
        try:
            import os
            os.killpg(job["pid"], signal.SIGTERM)
        except (OSError, ProcessLookupError):
            pass
        return {"ok": True, "status": "STOPPING"}

    async def submitted_job_logs(self, submission_id: str,
                                 tail_bytes: int = 1 << 20):
        job = self.submitted_jobs.get(submission_id)
        if job is None:
            return None
        try:
            with open(job["log_path"], "rb") as f:
                f.seek(0, 2)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    # --- placement groups ---------------------------------------------------

    async def create_pg(self, pg_id: PlacementGroupID, bundles, strategy,
                        name=None):
        """Two-phase gang reserve (reference:
        gcs/gcs_placement_group_scheduler.h Prepare/Commit protocol;
        bundle policies raylet/scheduling/policy/bundle_scheduling_policy.h).
        """
        info = PlacementGroupInfo(
            pg_id=pg_id, bundles=[dict(b) for b in bundles],
            strategy=strategy, name=name,
            bundle_nodes=[None] * len(bundles))
        self.pgs[pg_id] = info
        # Stay PENDING while the cluster is busy: resource views refresh on
        # heartbeats, so placement that is infeasible *now* may fit in a
        # moment (reference: PGs queue in GcsPlacementGroupManager). Even
        # exceeding TOTAL cluster capacity is only terminal after the
        # infeasibility window: a PENDING gang's bundles are autoscaler
        # demand (autoscaler.py _collect_demand), so capacity may be on
        # its way — this is SURVEY section 7's "slice reservation races
        # autoscaling" hard part, resolved by making the reservation
        # patient instead of fail-fast. A prepare-phase race (two PGs
        # placed on the same stale view) also retries within the
        # deadline. Concurrent remove_pg aborts the wait.
        deadline = time.monotonic() + max(
            30.0, self.config.infeasible_wait_window_s)
        while True:
            if info.state == "REMOVED":
                return {"ok": False, "error": "placement group removed"}
            placement = self._place_bundles(info)
            if placement is None:
                if time.monotonic() >= deadline:
                    info.state = "INFEASIBLE"
                    reason = "exceeds total cluster capacity" \
                        if not self._feasible_by_total(info) \
                        else "timed out pending"
                    return {"ok": False,
                            "error": f"placement group {reason}"}
                await asyncio.sleep(0.25)
                continue
            # Phase 1: prepare on every node (all-or-nothing).
            prepared = []
            ok = True
            for idx, node in enumerate(placement):
                try:
                    r = await self.pool.call(
                        node.addr, "prepare_bundle", pg_id=pg_id,
                        bundle_index=idx, resources=info.bundles[idx])
                    if r.get("ok"):
                        prepared.append((idx, node))
                    else:
                        ok = False
                        break
                except Exception:
                    ok = False
                    break
            if ok and info.state == "REMOVED":
                ok = False  # removed while preparing: roll back
            if not ok:
                for idx, node in prepared:
                    try:
                        await self.pool.call(node.addr, "return_bundle",
                                             pg_id=pg_id, bundle_index=idx)
                    except Exception:
                        pass
                if info.state == "REMOVED":
                    return {"ok": False, "error": "placement group removed"}
                if time.monotonic() >= deadline:
                    info.state = "INFEASIBLE"
                    return {"ok": False,
                            "error": "bundle reservation failed"}
                await asyncio.sleep(0.25)
                continue
            # Phase 2: commit.
            for idx, node in prepared:
                await self.pool.call(node.addr, "commit_bundle", pg_id=pg_id,
                                     bundle_index=idx)
                info.bundle_nodes[idx] = node.node_id
            info.state = "CREATED"
            self._persist("pgs", pg_id, info)
            await self.pubsub.publish("pgs",
                                      {"event": "created", "pg_id": pg_id})
            return {"ok": True, "bundle_nodes": info.bundle_nodes}

    def _feasible_by_total(self, info: PlacementGroupInfo) -> bool:
        """Could the bundles EVER fit, given total capacities?"""
        saved = [dict(n.resources_available) for n in self.nodes.values()]
        nodes = list(self.nodes.values())
        try:
            for n in nodes:
                n.resources_available = dict(n.resources_total)
            return self._place_bundles(info) is not None
        finally:
            for n, s in zip(nodes, saved):
                n.resources_available = s

    def _place_bundles(self, info: PlacementGroupInfo
                       ) -> Optional[List[NodeInfo]]:
        alive = [n for n in self.nodes.values() if n.alive]
        if not alive:
            return None
        avail = {n.node_id: dict(n.resources_available) for n in alive}
        strategy = info.strategy.upper()
        out: List[NodeInfo] = []

        def take(node: NodeInfo, bundle) -> bool:
            a = avail[node.node_id]
            if not _fits(bundle, a):
                return False
            for k, v in bundle.items():
                a[k] = a.get(k, 0) - v
            return True

        if strategy in ("PACK", "STRICT_PACK"):
            order = sorted(alive, key=lambda n: -sum(
                n.resources_available.values()))
            for b in info.bundles:
                placed = False
                pool = out[:1] if (strategy == "STRICT_PACK" and out) else order
                for n in pool:
                    if take(n, b):
                        out.append(n)
                        placed = True
                        break
                if not placed:
                    return None
            if strategy == "STRICT_PACK" and len({n.node_id for n in out}) > 1:
                return None
            return out
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            used: set = set()
            for b in info.bundles:
                cands = sorted(alive, key=lambda n: (
                    n.node_id in used, -sum(avail[n.node_id].values())))
                placed = False
                for n in cands:
                    if strategy == "STRICT_SPREAD" and n.node_id in used:
                        continue
                    if take(n, b):
                        out.append(n)
                        used.add(n.node_id)
                        placed = True
                        break
                if not placed:
                    return None
            return out
        raise ValueError(f"unknown strategy {info.strategy}")

    async def remove_pg(self, pg_id: PlacementGroupID):
        info = self.pgs.get(pg_id)
        if info is None:
            return {"ok": False}
        for idx, nid in enumerate(info.bundle_nodes):
            if nid is None:
                continue
            node = self.nodes.get(nid)
            if node is None:
                continue
            try:
                await self.pool.call(node.addr, "return_bundle",
                                     pg_id=pg_id, bundle_index=idx)
            except Exception:
                pass
        info.state = "REMOVED"
        self._persist_del("pgs", pg_id)
        return {"ok": True}

    async def get_pg(self, pg_id: PlacementGroupID):
        info = self.pgs.get(pg_id)
        if info is None:
            return None
        return {"pg_id": info.pg_id, "state": info.state,
                "bundles": info.bundles, "strategy": info.strategy,
                "bundle_nodes": info.bundle_nodes, "name": info.name}

    async def list_pgs(self):
        return [await self.get_pg(p) for p in list(self.pgs)]

    # --- object directory ----------------------------------------------------

    async def add_object_location(self, oid: ObjectID, node_id: NodeID,
                                  size: int):
        self.object_locations.setdefault(oid, {})[node_id] = size
        return {"ok": True}

    async def report_metrics(self, source: str, text: str) -> dict:
        """Workers push labelled metric snapshots here (util/metrics.py
        push_loop); merged into this process's /metrics endpoint so the
        head serves cluster-wide series — and, when the health plane is
        on, ingested into the head time-series store so the same push
        builds queryable history (util/timeseries.py)."""
        from ray_tpu_torch.util import metrics as _m
        _m.merge_remote(str(source), str(text))
        from ray_tpu_torch.util import health as _health
        try:
            _health.ingest_push(str(source), str(text))
        except Exception:  # noqa: BLE001 — history must not fail pushes
            pass
        return {"ok": True}

    async def health_state(self) -> dict:
        """The health plane's machine-readable snapshot (objectives,
        burn rates, active alerts, sentinels) — the /health endpoint,
        `ray-tpu health`, and the dashboard all serve this; its
        ``burn_advice`` map is the input contract for SLO-driven
        replica autoscaling (serve/autoscale.py)."""
        from ray_tpu_torch.util import health as _health
        return _health.local_state()

    async def query_series(self, name: str, since_s: float = 900.0,
                           labels: Optional[dict] = None) -> dict:
        """Windowed points for one stored metric series (`ray-tpu
        metrics <name> --since 15m` and the dashboard sparklines)."""
        from ray_tpu_torch.util import health as _health
        return _health.local_query(str(name), float(since_s),
                                   labels if isinstance(labels, dict)
                                   else None)

    # --- cluster-wide profiling -------------------------------------------

    def _resolve_profile_actor(self, target: str):
        """An actor by name (any namespace) or id-hex prefix. Returns
        (actor_or_None, error_or_None) — ambiguity is an error, never a
        silent first-match (profiling the wrong actor misattributes a
        perf problem)."""
        named = [self.actors.get(aid)
                 for (_ns, name), aid in self.named_actors.items()
                 if name == target]
        named = [a for a in named if a is not None]
        if len(named) > 1:
            return None, (f"actor name {target!r} exists in multiple "
                          "namespaces — profile by actor id instead")
        if named:
            return named[0], None
        t = target.lower()
        hits = [a for aid, a in self.actors.items()
                if t and aid.hex().startswith(t)]
        if len(hits) > 1:
            ids = ", ".join(a.actor_id.hex()[:12] for a in hits[:4])
            return None, (f"actor id prefix {target!r} is ambiguous "
                          f"({ids}) — use a longer prefix")
        return (hits[0] if hits else None), None

    async def profile_target(self, target, op: str = "profile",
                             duration_s: float = 2.0, hz: int = 100):
        """Profile any live worker/actor from the driver (reference
        capability: the dashboard's py-spy stack/flamegraph buttons,
        dashboard/modules/reporter/reporter_agent.py). ``target`` is an
        actor name, an actor-id hex prefix, or a worker/agent pid;
        ``op`` is "profile" (sampled folded stacks, util/profiling.py)
        or "dump_stacks" (one-shot thread dump). The request routes
        head -> hosting worker directly for actors, head -> every agent
        for pids."""
        import math
        target = str(target)
        if op not in ("profile", "dump_stacks"):
            # op becomes the worker RPC method name — never let the
            # profiling entry point invoke arbitrary handlers
            return {"error": f"unknown profile op {op!r}"}
        duration_s = float(duration_s)
        if not math.isfinite(duration_s):
            return {"error": f"bad duration {duration_s!r}"}
        duration_s = min(max(duration_s, 0.0), 120.0)
        a, amb_err = self._resolve_profile_actor(target)
        if amb_err is not None:
            return {"error": amb_err}
        if a is not None:
            if a.state != ALIVE or not a.addr:
                return {"error": f"actor {target!r} is {a.state}, "
                                 "not profilable"}
            kw = {} if op == "dump_stacks" else \
                {"duration_s": duration_s, "hz": hz}
            try:
                r = await self.pool.call(tuple(a.addr), op,
                                         timeout=duration_s + 30.0, **kw)
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                return {"error": f"profile RPC to actor failed: {e}"}
            r["target"] = {
                "actor_id": a.actor_id.hex(), "name": a.name,
                "class_name": a.class_name,
                "node_id": a.node_id.hex() if a.node_id else None}
            return r
        try:
            pid = int(target)
        except ValueError:
            return {"error": f"no live actor named {target!r} (and not "
                             "a pid)"}

        # Concurrent fan-out to every agent: pids are per-host, so the
        # same number can exist on several nodes (containers restart
        # pids low) — an ambiguous match must error, not silently
        # profile whichever node answered first.
        async def probe(n):
            try:
                return n, await self.pool.call(
                    n.addr, "profile_worker", pid=pid, op=op,
                    duration_s=duration_s, hz=hz,
                    timeout=duration_s + 30.0)
            except Exception:
                return n, {"found": False}

        alive = [n for n in self.nodes.values() if n.alive]
        results = await asyncio.gather(*[probe(n) for n in alive])
        hits = [(n, r) for n, r in results if r.get("found")]
        if not hits:
            return {"error": f"no live worker or agent with pid {pid}"}
        if len(hits) > 1:
            nodes = ", ".join(n.node_id.hex()[:12] for n, _ in hits)
            return {"error": f"pid {pid} exists on multiple nodes "
                             f"({nodes}) — profile by actor id instead"}
        n, r = hits[0]
        r.pop("found", None)
        r.setdefault("target", {"pid": pid, "node_id": n.node_id.hex()})
        return r

    async def autopsy(self, stall_timeout_s: float = 0.0) -> dict:
        """One-command postmortem: fan ``node_forensics`` out to every
        alive agent (each agent pulls stacks + collective ledgers +
        engine state from its own workers), run the cross-rank ledger
        audit over whatever came back, and write one atomic
        ``postmortem-*.json`` bundle on the head. Nodes that fail to
        answer are recorded as error rows — on a hung cluster the
        silence IS the finding. Returns the bundle path plus the
        audit's findings so the CLI can print a diagnosis without
        re-opening the file."""
        from ray_tpu_torch.util import events as _ev
        from ray_tpu_torch.util import forensics

        async def pull(n):
            try:
                return n.node_id.hex(), await self.pool.call(
                    n.addr, "node_forensics", timeout=30.0)
            except Exception as e:  # noqa: BLE001 — evidence, not fatal
                return n.node_id.hex(), \
                    {"error": f"{type(e).__name__}: {e}"}

        alive = [n for n in list(self.nodes.values()) if n.alive]
        results = await asyncio.gather(*[pull(n) for n in alive])
        nodes = {nid: dump for nid, dump in results}

        # Cross-rank audit over every worker dump that carries a rank
        # (train workers stamp one; bare task workers stay rank -1 and
        # only contribute stacks).
        ledgers: Dict[int, dict] = {}
        for dump in nodes.values():
            if not isinstance(dump, dict):
                continue
            for w in (dump.get("workers") or {}).values():
                r = w.get("rank", -1) if isinstance(w, dict) else -1
                snap = w.get("ledger") if isinstance(w, dict) else None
                if isinstance(r, int) and r >= 0 \
                        and isinstance(snap, dict) and "entries" in snap:
                    ledgers[r] = snap
        tmo = float(stall_timeout_s) if stall_timeout_s else \
            float(self.config.forensics_stall_timeout_s)
        findings = forensics.audit(ledgers, stall_timeout_s=tmo) \
            if ledgers else []
        payload = {
            "trigger": "autopsy",
            "findings": [dict(f) for f in findings],
            "nodes": nodes,
            "head_events": _ev.dump()[-512:],
        }
        try:
            path = forensics.write_bundle(payload)
        except Exception as e:  # noqa: BLE001 — diagnosis beats bundle
            path = None
            payload["bundle_error"] = f"{type(e).__name__}: {e}"
        _ev.record("forensics", "bundle", trigger="autopsy", path=path,
                   findings=len(findings))
        return {"path": path, "findings": payload["findings"],
                "nodes": sorted(nodes), "ranks": sorted(ledgers)}

    async def report_node_events(self, events: list) -> dict:
        """A stopping node archives its span buffer here so the cluster
        timeline outlives it (reference: task events live in the GCS,
        gcs/gcs_task_manager.h)."""
        self._archived_events.extend(events)
        return {"ok": True, "count": len(events)}

    async def _clock_offset(self, addr) -> Optional[Tuple[float, float]]:
        """Estimate a node's wall-clock offset vs this head: bracket a
        clock_probe RPC with local clock reads, offset = remote -
        midpoint; of 3 probes the one with the smallest RTT wins (its
        midpoint assumption — symmetric network halves — is tightest).
        Returns (offset_s, rtt_s), or None when the agent predates the
        probe RPC / is unreachable."""
        best = None
        try:
            for _ in range(3):
                t0 = time.time()
                r = await self.pool.call(addr, "clock_probe", timeout=5.0)
                t1 = time.time()
                rtt = t1 - t0
                off = float(r["t"]) - (t0 + t1) / 2.0
                if best is None or rtt < best[1]:
                    best = (off, rtt)
        except Exception:
            return best
        return best

    async def collect_timeline(self) -> dict:
        """Cluster-wide event/span collection: archived buffers from
        departed nodes + a fan-out to every alive agent (reference
        surface: ray.timeline via gcs_task_manager). Alongside the
        events, each alive node's wall-clock offset vs this head is
        estimated (ping-style midpoint over the same control-plane
        RPCs) and returned as ``clock_offsets`` — to_chrome subtracts
        them so merged cross-node lanes line up and collective flow
        arrows cannot point backwards."""
        async def pull(n):
            evs: list = []
            try:
                r = await self.pool.call(n.addr, "node_timeline",
                                         timeout=10.0)
                evs = r.get("events", [])
            except Exception:
                pass
            off = await self._clock_offset(n.addr)
            return n.node_id.hex(), evs, off

        results = await asyncio.gather(*[
            pull(n) for n in list(self.nodes.values()) if n.alive])
        out = self._archived_events.dump()
        offsets: Dict[str, float] = {}
        rtts: Dict[str, float] = {}
        for nid, evs, off in results:
            out.extend(evs)
            if off is not None:
                offsets[nid], rtts[nid] = off
        return {"events": out, "clock_offsets": offsets,
                "clock_rtts": rtts}

    async def report_objects(self, node_id: NodeID, objects) -> dict:
        """Bulk object-directory refresh: an agent re-registering after a
        control-service restart re-publishes every sealed object it holds
        as [(oid, size), ...] in one RPC."""
        for oid, size in objects:
            self.object_locations.setdefault(oid, {})[node_id] = int(size)
        return {"ok": True, "count": len(objects)}

    async def remove_object_location(self, oid: ObjectID, node_id: NodeID):
        locs = self.object_locations.get(oid)
        if locs:
            locs.pop(node_id, None)
            if not locs:
                del self.object_locations[oid]
        return {"ok": True}

    async def get_object_locations(self, oid: ObjectID):
        locs = self.object_locations.get(oid, {})
        return [{"node_id": nid, "addr": self.nodes[nid].addr, "size": sz}
                for nid, sz in locs.items()
                if nid in self.nodes and self.nodes[nid].alive]

    # --- pubsub ---------------------------------------------------------------

    async def poll_events(self, channel: str, cursor: int = 0,
                          poll_timeout: float = 30.0):
        nxt, events = await self.pubsub.poll(channel, cursor, poll_timeout)
        return {"cursor": nxt, "events": events}


def _fits(demand: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())
