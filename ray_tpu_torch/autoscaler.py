"""Autoscaler: reconcile cluster size against resource demand.

The v2-reconciler analog (reference:
python/ray/autoscaler/v2/instance_manager/reconciler.py:56 Reconciler,
autoscaler/v2/sdk.py request_resources): a loop reads the head's view —
per-node pending lease demand (piggybacked on heartbeats), PENDING
placement groups, and explicit `request_resources` asks from the KV —
decides how many nodes to add or drain, and drives a pluggable
NodeProvider. `LocalNodeProvider` launches real `ray_tpu_torch.node` OS
processes, which is both the dev story and the test story; cloud
providers implement the same three methods against their instance APIs.

The port's copy of ``ray_tpu/autoscaler.py``, unchanged but for import
paths.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.runtime import rpc

REQUEST_KV_KEY = "__autoscaler_request"


@dataclass
class AutoscalerConfig:
    min_nodes: int = 0
    max_nodes: int = 8
    node_resources: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0})
    idle_timeout_s: float = 30.0
    reconcile_interval_s: float = 2.0
    # nodes the autoscaler must never touch (e.g. the head's)
    protected_node_ids: tuple = ()


class NodeProvider:
    """Implement these three against your instance API."""

    async def launch(self, resources: Dict[str, float],
                     labels: Dict[str, str]) -> str:
        raise NotImplementedError

    async def terminate(self, handle: str) -> None:
        raise NotImplementedError

    async def alive_handles(self) -> List[str]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Nodes as local `ray_tpu_torch.node` subprocesses."""

    def __init__(self, head_address: str):
        self.head_address = head_address
        self._procs: Dict[str, object] = {}
        self._n = 0

    async def launch(self, resources, labels) -> str:
        import sys
        self._n += 1
        handle = f"local-{self._n}"
        cmd = [sys.executable, "-m", "ray_tpu_torch.node",
               "--address", self.head_address,
               "--num-cpus", str(resources.get("CPU", 1.0)),
               "--labels", json.dumps(
                   {**labels, "autoscaler_handle": handle})]
        extra = {k: v for k, v in resources.items() if k != "CPU"}
        if extra:
            cmd += ["--resources", json.dumps(extra)]
        proc = await asyncio.create_subprocess_exec(
            *cmd, start_new_session=True,
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.DEVNULL)
        self._procs[handle] = proc
        return handle

    async def terminate(self, handle: str) -> None:
        proc = self._procs.pop(handle, None)
        if proc is None:
            return
        try:
            proc.terminate()
            await asyncio.wait_for(proc.wait(), 15)
        except (ProcessLookupError, asyncio.TimeoutError):
            try:
                proc.kill()
            except ProcessLookupError:
                pass

    async def alive_handles(self) -> List[str]:
        return [h for h, p in self._procs.items()
                if p.returncode is None]


def request_resources(bundles: List[Dict[str, float]],
                      address: Optional[str] = None) -> None:
    """Explicit scale ask (reference: autoscaler/v2/sdk.py
    request_resources): the autoscaler keeps the cluster able to fit
    these bundles regardless of current load."""
    from ray_tpu_torch import api
    ctx = api._require_init()
    api._run(ctx.pool.call(ctx.head_addr, "kv_put", key=REQUEST_KV_KEY,
                           value=json.dumps(bundles).encode()))


class Autoscaler:
    def __init__(self, head_address: str, provider: NodeProvider,
                 config: Optional[AutoscalerConfig] = None):
        host, port = head_address.rsplit(":", 1)
        self.head_addr = (host, int(port))
        self.provider = provider
        self.config = config or AutoscalerConfig()
        self.pool = rpc.ConnectionPool()
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        # handle -> node_id hex once matched; node_id -> idle_since
        self._handle_nodes: Dict[str, str] = {}
        self._idle_since: Dict[str, float] = {}

    async def start(self):
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self):
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self.pool.close()

    async def _loop(self):
        while not self._stopped:
            try:
                await self.reconcile_once()
            except Exception:
                pass
            await asyncio.sleep(self.config.reconcile_interval_s)

    # --- one reconcile pass --------------------------------------------

    async def reconcile_once(self) -> dict:
        nodes = await self.pool.call(self.head_addr, "get_nodes",
                                     timeout=10.0)
        alive = [n for n in nodes if n["alive"]]
        self._match_handles(alive)
        demand = await self._collect_demand(alive)
        actions = {"launched": 0, "terminated": 0,
                   "nodes": len(alive), "demand": len(demand)}

        handles = set(await self.provider.alive_handles())
        alive_ids = {_nid(n) for n in alive}
        booting = sum(1 for h in handles
                      if self._handle_nodes.get(h) not in alive_ids)

        # Scale up: first-fit demand into current availability PLUS
        # capacity already booting (launched but not yet registered) —
        # without the offset every reconcile pass would re-launch for
        # the same pending task until it lands. Nodes that standing
        # demand fits into are RESERVED: scale-down must not terminate
        # the capacity a request_resources ask is being held by.
        unfit, reserved = self._unfit_demand(demand, alive, booting)
        want = 0
        if unfit:
            per_node = self.config.node_resources
            pool: List[Dict[str, float]] = []
            for shape in unfit:
                for avail in pool:
                    if _fits(shape, avail):
                        _take(shape, avail)
                        break
                else:
                    fresh = dict(per_node)
                    if not _fits(shape, fresh):
                        continue  # a single node can never fit it
                    _take(shape, fresh)
                    pool.append(fresh)
                    want += 1
        managed = len(handles)
        if managed + want > self.config.max_nodes:
            want = max(0, self.config.max_nodes - managed)
        for _ in range(want):
            await self.provider.launch(self.config.node_resources, {})
            actions["launched"] += 1

        # scale down: managed nodes idle past the timeout, above min
        if not unfit:
            await self._scale_down(alive, actions, reserved)
        return actions

    def _match_handles(self, alive):
        for n in alive:
            h = (n.get("labels") or {}).get("autoscaler_handle")
            if h:
                self._handle_nodes[h] = n["node_id"].hex() \
                    if hasattr(n["node_id"], "hex") else str(n["node_id"])

    async def _collect_demand(self, alive) -> List[Dict[str, float]]:
        demand: List[Dict[str, float]] = []
        for n in alive:
            demand.extend(n.get("pending_demand") or [])
        # PENDING placement groups
        pgs = await self.pool.call(self.head_addr, "list_pgs",
                                   timeout=10.0)
        for pg in pgs:
            if pg.get("state") == "PENDING":
                demand.extend(pg.get("bundles") or [])
        # explicit request_resources bundles
        blob = await self.pool.call(self.head_addr, "kv_get",
                                    key=REQUEST_KV_KEY, timeout=10.0)
        if blob:
            demand.extend(json.loads(blob.decode()))
        return demand

    def _unfit_demand(self, demand, alive, booting: int = 0):
        """First-fit the demand into current availability (+ booting
        capacity); returns (unfit shapes, node ids holding demand)."""
        avails = [(_nid(n), dict(n["resources_available"]))
                  for n in alive]
        avails += [(None, dict(self.config.node_resources))
                   for _ in range(booting)]
        unfit, reserved = [], set()
        for shape in demand:
            shape = {k: float(v) for k, v in shape.items()
                     if not str(k).startswith("_")}
            for nid, avail in avails:
                if _fits(shape, avail):
                    _take(shape, avail)
                    if nid is not None:
                        reserved.add(nid)
                    break
            else:
                unfit.append(shape)
        return unfit, reserved

    async def _scale_down(self, alive, actions, reserved=()):
        handles = set(await self.provider.alive_handles())
        now = time.monotonic()
        by_node = {v: k for k, v in self._handle_nodes.items()}
        n_managed_alive = sum(
            1 for n in alive
            if _nid(n) in by_node and by_node[_nid(n)] in handles)
        actor_nodes = await self._nodes_hosting_actors()
        if actor_nodes is None:
            return  # can't see actors: don't terminate anything
        for n in alive:
            nid = _nid(n)
            handle = by_node.get(nid)
            if handle is None or handle not in handles:
                continue
            if nid in self.config.protected_node_ids:
                continue
            busy = any(n["resources_available"].get(k, 0) != v
                       for k, v in n["resources_total"].items()) \
                or (n.get("pending_demand") or []) \
                or nid in reserved \
                or nid in actor_nodes
            if busy:
                self._idle_since.pop(nid, None)
                continue
            since = self._idle_since.setdefault(nid, now)
            if now - since < self.config.idle_timeout_s:
                continue
            if n_managed_alive <= self.config.min_nodes:
                break
            await self.pool.call(self.head_addr, "drain_node",
                                 node_id=n["node_id"], timeout=10.0)
            await self.provider.terminate(handle)
            self._idle_since.pop(nid, None)
            n_managed_alive -= 1
            actions["terminated"] += 1


    async def _nodes_hosting_actors(self):
        """Nodes with live actors must not be drained — zero-resource
        actors are invisible to the availability check. Returns None
        when the view is unavailable (caller skips scale-down)."""
        try:
            actors = await self.pool.call(self.head_addr, "list_actors",
                                          timeout=10.0)
        except Exception:  # noqa: BLE001
            return None
        out = set()
        for a in actors:
            if a.get("state") in ("PENDING", "ALIVE", "RESTARTING") \
                    and a.get("node_id") is not None:
                v = a["node_id"]
                out.add(v.hex() if hasattr(v, "hex") else str(v))
        return out


def _nid(n) -> str:
    v = n["node_id"]
    return v.hex() if hasattr(v, "hex") else str(v)


# Shared fit predicate (same float tolerance as the scheduler's).
from ray_tpu_torch.runtime.agent import _fits  # noqa: E402


def _take(shape: Dict[str, float], avail: Dict[str, float]) -> None:
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v
