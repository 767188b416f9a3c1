"""ServeController: the serving control plane, one detached actor per
cluster.

Reference: python/ray/serve/_private/controller.py:127 (ServeController),
deployment_state.py:2645 (DeploymentState FSM), autoscaling_state.py
(queue-length autoscaling). The shape here: a declarative target table
(deployment -> spec) and an async reconcile loop that converges actual
replicas to target — create missing, stop excess, replace dead (health
pings), and resize targets from replica queue metrics when autoscaling is
configured.

Runs inside a worker's event loop, so all cluster operations use the async
CoreContext API directly (the sync facade would deadlock the loop).

The port's copy of ``ray_tpu/serve/controller.py``.
"""

from __future__ import annotations

import asyncio
import math
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch import api
from ray_tpu_torch.runtime.ids import ActorID

RECONCILE_INTERVAL_S = 0.25
HEALTH_CHECK_INTERVAL_S = 1.0
HEALTH_CHECK_TIMEOUT_S = 10.0


class _ReplicaInfo:
    __slots__ = ("actor_id", "state", "name", "started_at",
                 "last_healthy", "ongoing", "model_ids", "bundle_index",
                 "drain_started", "drain_notified", "drain_poll_fails")

    def __init__(self, actor_id: ActorID, name: str):
        self.actor_id = actor_id
        self.name = name
        # STARTING | RUNNING | DRAINING | STOPPING — DRAINING replicas
        # (scale-down / redeploy) are out of the routing table, reject
        # new requests, and finish their in-flight ones before stop
        self.state = "STARTING"
        self.started_at = time.time()
        self.last_healthy = time.time()
        self.ongoing = 0
        self.model_ids: List[str] = []   # multiplexed models loaded here
        self.bundle_index: Optional[int] = None   # gang PG slot
        self.drain_started = 0.0
        self.drain_notified = False
        self.drain_poll_fails = 0


class _DeploymentState:
    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = spec
        self.replicas: Dict[str, _ReplicaInfo] = {}
        self.version = 0
        self.target = self._initial_target()
        self.last_scale_up_signal = time.time()
        self.last_scale_change = 0.0
        self.creating = 0     # replica create_actor calls in flight
        # gang scheduling (spec["gang"]): one PG, one bundle per replica
        self.pg_id = None
        self.pg_creating = False
        self.pg_error: Optional[str] = None
        self.pg_error_at = 0.0
        self.pg_checked_at = 0.0
        self.pg_gen = 0       # bumped on redeploy: stale creates discard

    def _initial_target(self) -> int:
        auto = self.spec.get("autoscaling_config")
        if auto:
            return int(auto.get("initial_replicas",
                                auto.get("min_replicas", 1)))
        return int(self.spec.get("num_replicas", 1))

    def running(self) -> List[_ReplicaInfo]:
        return [r for r in self.replicas.values() if r.state == "RUNNING"]

    def retire(self, r: _ReplicaInfo) -> None:
        """Take one replica out of service: RUNNING non-gang replicas
        DRAIN (finish in-flight, reject new, stop when empty); anything
        else — STARTING, gang members (all-or-nothing groups can't
        shrink one at a time), already-draining — stops hard."""
        if r.state == "RUNNING" and not self.spec.get("gang"):
            r.state = "DRAINING"
            r.drain_started = time.time()
            r.drain_notified = False
        elif r.state != "DRAINING":
            r.state = "STOPPING"
        self.version += 1


class ServeController:
    """Deploy with max_concurrency > 1; call ``start()`` once after
    creation to launch the reconcile loop."""

    def __init__(self):
        self.deployments: Dict[str, _DeploymentState] = {}
        self.apps: Dict[str, List[str]] = {}       # app -> deployment names
        self._loop_task: Optional[asyncio.Task] = None
        self._proxy_started = False
        # while recovering, reconcile must not start replacement replicas
        # for deployments whose survivors are about to be adopted
        self._recovering = False
        # recovery must SUCCEED once (KV read or legitimately empty)
        # before the orphan sweep may kill anything — otherwise a head
        # outage during recovery would turn survivors into "orphans"
        self._recover_done = False
        self._next_recover_retry = 0.0
        self._creating: set = set()    # replica names mid-create_actor
        self._gang_slots_creating: Dict[str, set] = {}
        self._last_orphan_sweep = 0.0
        # SLO-driven autoscaling (serve/autoscale.py): created lazily
        # at the first SLO-policy deployment or proxy hint; the burn
        # advice cache bounds health_state fetches to one per interval
        self._autoscaler = None
        self._burn_advice_cache: Dict[str, Any] = {"ts": 0.0,
                                                   "advice": {}}

    # -- internal async cluster ops ---------------------------------------

    def _ctx(self):
        return api._g.ctx

    def _starting_timeout_s(self) -> float:
        try:
            return float(self._ctx().config.actor_init_timeout_s) + 60.0
        except Exception:
            return 660.0

    async def _acall(self, actor_id: ActorID, method: str, *args,
                     timeout: Optional[float] = 30.0, **kwargs):
        ctx = self._ctx()
        refs = await ctx.submit_actor_call(actor_id, method, args, kwargs)
        return await ctx.get(refs[0], timeout)

    # -- lifecycle ---------------------------------------------------------

    APPS_KV_KEY = "serve:apps"

    async def start(self) -> bool:
        if self._loop_task is None:
            # loop first, recovery second: _recover() re-enters
            # deploy_app, whose _ensure_started must see the loop set
            # (not recurse back into start)
            self._loop_task = asyncio.ensure_future(self._reconcile_loop())
            await self._recover()
        return True

    async def _ensure_started(self):
        """Every RPC path self-starts the reconcile loop: after a
        crash-restart, nobody calls start() again — the first routed
        request (or deploy) triggers recovery."""
        if self._loop_task is None:
            await self.start()

    async def _persist_apps(self):
        import cloudpickle
        ctx = self._ctx()
        try:
            payload = cloudpickle.dumps(
                {app: [self.deployments[n].spec for n in names
                       if n in self.deployments]
                 for app, names in self.apps.items()}, protocol=5)
            await ctx.pool.call(ctx.head_addr, "kv_put",
                                key=self.APPS_KV_KEY, value=payload)
        except Exception:
            pass  # next mutation retries

    async def _recover(self):
        """Crash-restart: reload app specs from the control KV, redeploy,
        and RE-ADOPT live replica actors from the previous incarnation
        instead of restarting them — a controller crash must not cause a
        serving outage (reference: serve controller recovers running
        replicas from its checkpoint, deployment_state.py
        _recover_from_checkpoint). Replicas whose deployment no longer
        exists are killed as orphans. Gang deployments are the
        exception: bundle assignments aren't recoverable from the actor
        table, and the gang is all-or-nothing, so those replicas are
        restarted on a fresh reservation."""
        import cloudpickle
        ctx = self._ctx()
        self._recovering = True
        try:
            # Bounded retries: recovery often runs in the same disruption
            # window that crashed the controller (head briefly
            # unreachable); one transient RPC failure must not leave the
            # controller permanently amnesiac about its replicas.
            blob = None
            actors = None
            for attempt in range(5):
                try:
                    if blob is None:
                        blob = await ctx.pool.call(
                            ctx.head_addr, "kv_get", key=self.APPS_KV_KEY)
                        if not blob:
                            # genuinely nothing deployed
                            self._recover_done = True
                            return
                    actors = await ctx.pool.call(ctx.head_addr,
                                                 "list_actors")
                    break
                except Exception:
                    if attempt == 4:
                        # head unreachable for the whole window: leave
                        # _recover_done False — the reconcile loop
                        # re-runs recovery until the KV is readable, and
                        # the orphan sweep stays disarmed so survivors
                        # keep serving in the meantime
                        self._next_recover_retry = time.time() + 5.0
                        return
                    await asyncio.sleep(0.5 * (attempt + 1))
            try:
                apps = cloudpickle.loads(blob)
            except Exception:
                # corrupt blob: retrying cannot help; arm the sweep so
                # the cluster at least converges on explicit redeploys
                self._recover_done = True
                return
            # name -> (rid, actor_id) of live replicas left behind
            survivors: Dict[str, List] = {}
            for a in actors or []:
                name = a.get("name") or ""
                if name.startswith("SERVE_REPLICA:") and \
                        a.get("state") not in ("DEAD",):
                    _, dep_name, rid = name.split(":", 2)
                    survivors.setdefault(dep_name, []).append(
                        (rid, a["actor_id"], name))
            # The previous incarnation's gang PGs are orphans: the fresh
            # deployment states start with pg_id=None and re-reserve, so
            # an unremoved old PG would hold its committed bundles
            # forever (and starve the new reservation on a tight
            # cluster). Remove them all; reconcile re-creates as needed.
            try:
                for pg in await ctx.pool.call(ctx.head_addr, "list_pgs"):
                    nm = pg.get("name") or ""
                    if nm.startswith("serve_gang:") and \
                            pg.get("state") != "REMOVED":
                        await self._remove_pg(pg["pg_id"])
            except Exception:
                pass
            for app_name, specs in apps.items():
                for spec in specs:
                    spec.pop("_deleted", None)
                if specs:
                    await self.deploy_app(app_name, specs, _persist=False)
            for dep_name, infos in survivors.items():
                dep = self.deployments.get(dep_name)
                adopt = dep is not None and not dep.spec.get("gang")
                for rid, actor_id, name in infos:
                    if adopt:
                        info = _ReplicaInfo(actor_id, name)
                        # STARTING: the next reconcile's ping promotes a
                        # healthy survivor to RUNNING; a dead one is
                        # reaped by the 120s STARTING timeout
                        dep.replicas[rid] = info
                    else:
                        try:
                            await ctx.kill_actor(actor_id, no_restart=True)
                        except Exception:
                            pass
            self._recover_done = True
        finally:
            self._recovering = False

    async def ping(self) -> str:
        return "ok"

    # -- deploy API --------------------------------------------------------

    async def deploy_app(self, app_name: str,
                         deployments: List[dict],
                         _persist: bool = True) -> bool:
        """deployments: list of specs {name, cls_payload, init_args,
        init_kwargs, num_replicas|autoscaling_config, max_ongoing_requests,
        route_prefix, actor_options, user_config}."""
        names = []
        for spec in deployments:
            name = spec["name"]
            names.append(name)
            existing = self.deployments.get(name)
            if existing is None:
                self.deployments[name] = _DeploymentState(name, spec)
            else:
                # In-place upgrade: replace spec; old replicas DRAIN
                # (finish in-flight requests, take no new ones) while
                # the reconcile loop starts their replacements — a
                # redeploy is not allowed to abort live requests.
                existing.spec = spec
                existing.target = existing._initial_target()
                for r in existing.replicas.values():
                    existing.retire(r)
                existing.version += 1
                # a gang PG reflects the OLD spec's size/resources:
                # release it and let the reconcile loop re-reserve. The
                # generation bump makes any still-in-flight create for
                # the old spec discard (and remove) its PG on completion
                # instead of adopting it.
                existing.pg_gen += 1
                if existing.pg_id is not None:
                    asyncio.ensure_future(self._remove_pg(existing.pg_id))
                existing.pg_id = None
                existing.pg_error = None
        # Deployments removed from the app spec are torn down (drained
        # first — removal must not abort in-flight requests either).
        for old in self.apps.get(app_name, []):
            if old not in names and old in self.deployments:
                for r in self.deployments[old].replicas.values():
                    self.deployments[old].retire(r)
                self.deployments[old].target = 0
                self.deployments[old].spec["_deleted"] = True
        self.apps[app_name] = names
        await self._ensure_started()
        if _persist:
            await self._persist_apps()
        return True

    async def list_apps(self) -> List[str]:
        return list(self.apps)

    async def delete_app(self, app_name: str) -> bool:
        await self._ensure_started()
        for name in self.apps.pop(app_name, []):
            dep = self.deployments.get(name)
            if dep is not None:
                dep.target = 0
                dep.spec["_deleted"] = True
                for r in dep.replicas.values():
                    dep.retire(r)
        await self._persist_apps()
        return True

    async def wait_ready(self, app_name: str, timeout: float = 120.0) -> dict:
        deadline = time.monotonic() + timeout
        names = self.apps.get(app_name, [])
        while time.monotonic() < deadline:
            # Every deployment must reach its full target before run()
            # returns — returning at the first replica lets callers cache
            # a partial routing table and pile onto one replica.
            ready = all(
                len(self.deployments[n].running()) >=
                max(self.deployments[n].target, 1)
                for n in names if n in self.deployments)
            if names and ready:
                return {"ok": True}
            await asyncio.sleep(0.1)
        return {"ok": False,
                "error": f"app {app_name!r} not ready in {timeout}s"}

    # -- routing -----------------------------------------------------------

    async def get_routing_table(self, deployment_name: str) -> dict:
        await self._ensure_started()
        dep = self.deployments.get(deployment_name)
        if dep is None:
            return {"replicas": [], "version": -1, "model_ids": []}
        running = dep.running()
        return {"replicas": [r.actor_id.binary() for r in running],
                "model_ids": [list(r.model_ids) for r in running],
                "version": dep.version,
                # per-replica concurrency: the proxy's admission
                # control derives live capacity from it
                "max_ongoing": int(
                    dep.spec.get("max_ongoing_requests", 16))}

    async def report_model_ids(self, deployment_name: str,
                               replica_id: str, ids: list) -> bool:
        """Replicas push their loaded multiplexed-model sets here
        (serve/multiplex.py); handles read them off the routing table."""
        dep = self.deployments.get(deployment_name)
        if dep is None:
            return False
        info = dep.replicas.get(replica_id)
        if info is None:
            return False
        info.model_ids = [str(i) for i in ids]
        return True

    async def get_ingress_routes(self) -> List[dict]:
        """[{route_prefix, deployment}] sorted longest-prefix-first."""
        routes = []
        for name, dep in self.deployments.items():
            prefix = dep.spec.get("route_prefix")
            if prefix and not dep.spec.get("_deleted"):
                routes.append({"route_prefix": prefix, "deployment": name})
        routes.sort(key=lambda r: -len(r["route_prefix"]))
        return routes

    async def status(self) -> dict:
        out = {}
        for name, dep in self.deployments.items():
            out[name] = {
                "target": dep.target,
                "version": dep.version,
                "replicas": {
                    rid: {"state": r.state, "ongoing": r.ongoing}
                    for rid, r in dep.replicas.items()
                },
            }
            if dep.spec.get("gang"):
                out[name]["gang"] = {
                    "pg_id": dep.pg_id.hex() if dep.pg_id else None,
                    "error": dep.pg_error,
                }
            auto = dep.spec.get("autoscaling_config")
            if auto:
                from ray_tpu_torch.serve import autoscale as _asc
                if _asc.is_slo(auto):
                    out[name]["autoscale"] = \
                        self._get_autoscaler().describe(name)
                else:
                    out[name]["autoscale"] = {"policy": "ongoing"}
        return out

    # -- reconcile ---------------------------------------------------------

    async def _reconcile_loop(self):
        while True:
            try:
                await self._reconcile_once()
            except asyncio.CancelledError:
                return
            except Exception:
                import traceback
                traceback.print_exc()
            await asyncio.sleep(RECONCILE_INTERVAL_S)

    ORPHAN_SWEEP_INTERVAL_S = 10.0

    async def _sweep_orphans(self):
        """Kill SERVE_REPLICA actors no deployment tracks (left behind
        when recovery couldn't adopt, or by a crashed deploy path).
        Belt-and-braces: detached replicas otherwise leak forever."""
        try:
            ctx = self._ctx()
            actors = await ctx.pool.call(ctx.head_addr, "list_actors")
        except Exception:
            return
        for a in actors:
            name = a.get("name") or ""
            if not name.startswith("SERVE_REPLICA:") or \
                    a.get("state") in ("DEAD",):
                continue
            if name in self._creating:   # registration still in flight
                continue
            _, dep_name, rid = name.split(":", 2)
            dep = self.deployments.get(dep_name)
            if dep is None or rid not in dep.replicas:
                try:
                    await self._ctx().kill_actor(a["actor_id"],
                                                 no_restart=True)
                except Exception:
                    pass

    async def _reconcile_once(self):
        if self._recovering:
            return
        now = time.time()
        if not self._recover_done:
            # recovery gave up on a transient head outage: keep
            # retrying until the KV is readable; replicas are neither
            # adopted nor reaped until then
            if now >= self._next_recover_retry:
                self._next_recover_retry = now + 5.0
                await self._recover()
            return
        if now - getattr(self, "_last_orphan_sweep", 0.0) > \
                self.ORPHAN_SWEEP_INTERVAL_S:
            self._last_orphan_sweep = now
            await self._sweep_orphans()
        for name in list(self.deployments):
            dep = self.deployments[name]
            await self._autoscale(dep)
            await self._converge(dep)
            if dep.spec.get("_deleted") and not dep.replicas \
                    and not dep.pg_creating:
                if dep.pg_id is not None:
                    await self._remove_pg(dep.pg_id)
                    dep.pg_id = None
                if self._autoscaler is not None:
                    self._autoscaler.forget(name)
                del self.deployments[name]

    async def _converge(self, dep: _DeploymentState):
        # 0. graceful drain: notify once, then wait for in-flight
        #    requests (incl. streams) to finish — bounded by
        #    serve_drain_timeout_s — before the replica stops. DRAINING
        #    replicas left the routing table at retire() time.
        drain_timeout = float(getattr(
            api._g.ctx.config, "serve_drain_timeout_s", 30.0))
        for rid in list(dep.replicas):
            r = dep.replicas[rid]
            if r.state != "DRAINING":
                continue
            ongoing = None
            try:
                if not r.drain_notified:
                    await self._acall(r.actor_id, "set_draining", True,
                                      timeout=5.0)
                    r.drain_notified = True
                m = await self._acall(r.actor_id, "metrics", timeout=5.0)
                ongoing = int(m["ongoing"])
                r.drain_poll_fails = 0
            except Exception:
                # ONE transient RPC failure (busy loop, control hiccup)
                # must not hard-stop a replica with live requests —
                # only a consistently unreachable replica is dead
                r.drain_poll_fails += 1
            waited = time.time() - r.drain_started
            if (ongoing == 0 and r.drain_notified) or \
                    r.drain_poll_fails >= 3 or \
                    waited > drain_timeout:
                from ray_tpu_torch.serve.fault import fault_metrics
                fault_metrics()["drain_wait"].observe(
                    waited, tags={"deployment": dep.name})
                r.state = "STOPPING"
        # 1. reap STOPPING replicas
        for rid in list(dep.replicas):
            r = dep.replicas[rid]
            if r.state == "STOPPING":
                try:
                    await self._ctx().kill_actor(r.actor_id, no_restart=True)
                except Exception:
                    pass
                del dep.replicas[rid]
                dep.version += 1
        # 2. health: STARTING -> RUNNING on first ping; RUNNING -> replaced
        #    on ping failure
        for rid in list(dep.replicas):
            r = dep.replicas[rid]
            if r.state == "STARTING":
                try:
                    await self._acall(r.actor_id, "ping", timeout=1.0)
                    r.state = "RUNNING"
                    r.last_healthy = time.time()
                    dep.version += 1
                except Exception:
                    # budget tracks the cluster's actor-init allowance:
                    # create_actor returns at registration, so a
                    # model-loading __init__ spends its minutes HERE in
                    # STARTING — a short hardcoded cap would churn
                    # replicas forever
                    if time.time() - r.started_at > \
                            self._starting_timeout_s():
                        r.state = "STOPPING"
            elif r.state == "RUNNING" and \
                    time.time() - r.last_healthy > HEALTH_CHECK_INTERVAL_S:
                try:
                    await self._acall(r.actor_id, "ping",
                                      timeout=HEALTH_CHECK_TIMEOUT_S)
                    r.last_healthy = time.time()
                except Exception:
                    r.state = "STOPPING"
                    dep.version += 1
        # 3. gang deployments reserve their placement group first:
        #    replicas only start once every bundle is committed
        #    (all-or-nothing, reference: serve/gang.py)
        if dep.spec.get("gang") and not dep.spec.get("_deleted"):
            now = time.time()
            if dep.pg_id is not None and now - dep.pg_checked_at > 2.0:
                # gang health: a bundle on a dead node invalidates the
                # whole reservation (all-or-nothing) — tear down and
                # re-reserve so the gang moves to healthy capacity
                dep.pg_checked_at = now
                if not await self._gang_pg_healthy(dep):
                    await self._remove_pg(dep.pg_id)
                    dep.pg_id = None
                    for r in dep.replicas.values():
                        r.state = "STOPPING"
                    dep.version += 1
            if dep.pg_id is None:
                if dep.pg_error is not None and \
                        now - dep.pg_error_at > 5.0:
                    dep.pg_error = None      # retry after backoff
                if not dep.pg_creating and dep.pg_error is None:
                    dep.pg_creating = True
                    asyncio.ensure_future(self._create_gang_pg(dep))
                return
        # 3b. scale toward target (in-flight creations count: actor
        # __init__ may load a model for minutes and must not be
        # double-started — or stall this loop — meanwhile)
        alive = [r for r in dep.replicas.values()
                 if r.state in ("STARTING", "RUNNING")]
        missing = dep.target - len(alive) - dep.creating
        for _ in range(max(0, missing)):
            self._start_replica(dep)
        # Excess is judged against LIVE replicas only: an in-flight
        # create can't serve traffic and can't be cancelled, so it must
        # never cause a healthy replica to be stopped in its place.
        excess_n = len(alive) - dep.target
        if excess_n > 0:
            # retire the youngest excess replicas (oldest keep
            # serving); RUNNING ones drain — an autoscale-down must
            # not abort the in-flight requests that triggered it
            excess = sorted(alive,
                            key=lambda r: r.started_at)[-excess_n:]
            for r in excess:
                dep.retire(r)

    @staticmethod
    def _replica_resources(spec: dict) -> dict:
        opts = dict(spec.get("actor_options") or {})
        resources = dict(opts.get("resources") or {})
        if opts.get("num_cpus") is not None:
            resources["CPU"] = float(opts["num_cpus"])
        if opts.get("num_tpus") is not None:
            resources["TPU"] = float(opts["num_tpus"])
        if "CPU" not in resources and "TPU" not in resources:
            resources["CPU"] = 1.0
        return resources

    async def _create_gang_pg(self, dep: _DeploymentState):
        """Reserve the gang: num_replicas bundles of the replica's
        resources in ONE placement group (all-or-nothing)."""
        from ray_tpu_torch.runtime.ids import PlacementGroupID
        ctx = self._ctx()
        gen = dep.pg_gen
        res = self._replica_resources(dep.spec)
        pg_id = PlacementGroupID.generate()
        try:
            r = await ctx.pool.call(
                ctx.head_addr, "create_pg", pg_id=pg_id,
                bundles=[dict(res) for _ in range(dep.target)],
                strategy=str(dep.spec["gang"]),
                name=f"serve_gang:{dep.name}", timeout=120.0)
            if r.get("ok"):
                if dep.spec.get("_deleted") or dep.pg_gen != gen or \
                        self.deployments.get(dep.name) is not dep:
                    # deleted/redeployed while reserving: don't leak the
                    # committed bundles on a stale reservation
                    await self._remove_pg(pg_id)
                else:
                    dep.pg_id = pg_id
                    dep.pg_error = None
            else:
                dep.pg_error = r.get("error", "gang reserve failed")
                dep.pg_error_at = time.time()
        except Exception as e:  # noqa: BLE001
            dep.pg_error = f"{type(e).__name__}: {e}"
            dep.pg_error_at = time.time()
        finally:
            dep.pg_creating = False

    async def _remove_pg(self, pg_id) -> None:
        try:
            ctx = self._ctx()
            await ctx.pool.call(ctx.head_addr, "remove_pg", pg_id=pg_id)
        except Exception:
            pass

    async def _gang_pg_healthy(self, dep: _DeploymentState) -> bool:
        try:
            ctx = self._ctx()
            info = await ctx.pool.call(ctx.head_addr, "get_pg",
                                       pg_id=dep.pg_id, timeout=10.0)
            if info is None or info["state"] != "CREATED":
                return False
            nodes = await ctx.pool.call(ctx.head_addr, "get_nodes",
                                        timeout=10.0)
            alive = {n["node_id"] for n in nodes if n["alive"]}
            return all(nid in alive for nid in info["bundle_nodes"])
        except Exception:
            return True  # can't tell; don't churn on a control hiccup

    def _start_replica(self, dep: _DeploymentState):
        """Schedule one replica creation WITHOUT blocking the reconcile
        loop: an actor __init__ that loads a model can legitimately run
        for minutes (config.actor_init_timeout_s), during which health
        checks and other deployments must keep converging."""
        from ray_tpu_torch.serve.replica import Replica
        rid = uuid.uuid4().hex[:8]
        name = f"SERVE_REPLICA:{dep.name}:{rid}"
        spec = dep.spec
        resources = self._replica_resources(spec)
        pg = None
        bundle_index = None
        if dep.pg_id is not None:
            used = {r.bundle_index for r in dep.replicas.values()
                    if r.bundle_index is not None}
            used |= {i for i in self._gang_slots_creating.get(dep.name,
                                                             set())}
            free = [i for i in range(dep.target) if i not in used]
            if not free:
                return  # every gang slot is occupied
            bundle_index = free[0]
            pg = (dep.pg_id, bundle_index)
            self._gang_slots_creating.setdefault(
                dep.name, set()).add(bundle_index)
        self._creating.add(name)
        dep.creating += 1
        gen = dep.pg_gen

        async def create():
            try:
                actor_id = await self._ctx().create_actor(
                    Replica,
                    (dep.name, rid, spec["cls_payload"],
                     tuple(spec.get("init_args") or ()),
                     dict(spec.get("init_kwargs") or {}),
                     spec.get("user_config")),
                    {},
                    name=name, namespace="serve",
                    resources=resources,
                    pg=pg,
                    max_concurrency=int(
                        spec.get("max_ongoing_requests", 16)),
                    lifetime="detached")
                info = _ReplicaInfo(actor_id, name)
                info.bundle_index = bundle_index
                if self.deployments.get(dep.name) is dep and \
                        dep.pg_gen == gen and \
                        not dep.spec.get("_deleted"):
                    dep.replicas[rid] = info
                else:
                    # redeployed/deleted while creating: don't adopt
                    # into stale state — the orphan sweep would race
                    try:
                        await self._ctx().kill_actor(actor_id,
                                                     no_restart=True)
                    except Exception:
                        pass
            except Exception:
                pass
            finally:
                dep.creating -= 1
                self._creating.discard(name)
                if bundle_index is not None:
                    self._gang_slots_creating.get(
                        dep.name, set()).discard(bundle_index)

        asyncio.ensure_future(create())

    # -- autoscaling -------------------------------------------------------

    def _get_autoscaler(self):
        if self._autoscaler is None:
            from ray_tpu_torch.serve.autoscale import SLOAutoscaler
            self._autoscaler = SLOAutoscaler()
        return self._autoscaler

    async def autoscale_hint(self, deployment: str,
                             tier: str = "page") -> bool:
        """Proxy fast path (serve/proxy.py shed advisory): a request
        was shed while the deployment's SLO budget was burning. The
        hint counts as a page-tier signal at the autoscaler's next
        tick — the scale-up doesn't wait for the controller's own
        burn-advice fetch."""
        self._get_autoscaler().note_hint(str(deployment), str(tier))
        return True

    async def _poll_ongoing(self, running: List[_ReplicaInfo]) -> int:
        """Refresh per-replica in-flight counts; both actuator
        policies read them."""
        total = 0
        for r in running:
            try:
                m = await self._acall(r.actor_id, "metrics", timeout=2.0)
                r.ongoing = int(m["ongoing"])
            except Exception:
                continue
            total += r.ongoing
        return total

    async def _fetch_burn_advice(self) -> dict:
        """The head health plane's per-deployment burn_advice map,
        cached one autoscale interval (a reconcile loop at 4 Hz must
        not stampede the head). Stale advice beats none on a fetch
        failure."""
        cache = self._burn_advice_cache
        now = time.time()
        if now - cache["ts"] < self._get_autoscaler().interval_s:
            return cache["advice"]
        cache["ts"] = now
        try:
            ctx = self._ctx()
            st = await ctx.pool.call(ctx.head_addr, "health_state",
                                     timeout=2.0)
            cache["advice"] = (st or {}).get("burn_advice") or {}
        except Exception:
            pass
        return cache["advice"]

    async def _autoscale(self, dep: _DeploymentState):
        """Exactly ONE actuator per deployment: an SLO policy config
        ({"policy": "slo", ...}) routes to serve/autoscale.py; plain
        configs keep the legacy target_ongoing_requests loop as the
        fallback. Running both would have them fight over dep.target
        (tests/test_zz_autoscale.py pins the dispatch)."""
        auto = dep.spec.get("autoscaling_config")
        if not auto or dep.spec.get("_deleted"):
            return
        running = dep.running()
        if not running:
            return
        from ray_tpu_torch.serve import autoscale as _asc
        if _asc.is_slo(auto):
            await self._autoscale_slo(dep, auto, running)
        else:
            await self._autoscale_legacy(dep, auto, running)

    async def _autoscale_slo(self, dep: _DeploymentState, auto: dict,
                             running: List[_ReplicaInfo]):
        from ray_tpu_torch.serve import autoscale as _asc
        asc = self._get_autoscaler()
        st = asc.state(dep.name)
        now = time.time()
        if now - getattr(st, "last_eval", 0.0) < asc.interval_s:
            return
        st.last_eval = now
        total = await self._poll_ongoing(running)
        advice = await self._fetch_burn_advice()
        inp = _asc.Inputs(
            running=len(running), target=dep.target, ongoing=total,
            max_ongoing=int(dep.spec.get("max_ongoing_requests", 16)),
            burn=advice.get(dep.name))
        d = asc.apply(dep.name, inp, auto)
        if d.target != dep.target:
            dep.target = d.target
            dep.last_scale_change = now
            # scale-down victims DRAIN via _converge's retire() path —
            # the in-flight streams that were running when utilization
            # dropped finish before their replica stops

    async def _autoscale_legacy(self, dep: _DeploymentState,
                                auto: dict,
                                running: List[_ReplicaInfo]):
        total_ongoing = await self._poll_ongoing(running)
        target_per = float(auto.get("target_ongoing_requests", 2.0))
        lo = int(auto.get("min_replicas", 1))
        hi = int(auto.get("max_replicas", 8))
        desired = max(lo, min(hi, math.ceil(total_ongoing / target_per)))
        now = time.time()
        if desired > dep.target:
            # scale up immediately (but not more than once per interval)
            if now - dep.last_scale_change > float(
                    auto.get("upscale_delay_s", 0.5)):
                dep.target = desired
                dep.last_scale_change = now
            dep.last_scale_up_signal = now
        elif desired < dep.target:
            # scale down only after a sustained quiet period
            delay = float(auto.get("downscale_delay_s", 5.0))
            if now - dep.last_scale_up_signal > delay:
                dep.target = max(desired, lo)
                dep.last_scale_change = now
        else:
            dep.last_scale_up_signal = now
