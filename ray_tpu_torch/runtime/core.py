"""Per-process core client: object model, task submission, actor calls.

The CoreWorker analog (reference: src/ray/core_worker/core_worker.h,
task_submission/normal_task_submitter.h, actor_task_submitter.h,
store_provider/memory_store/memory_store.h). Every participating process —
the driver and each worker — owns one CoreContext: an RPC server (it serves
object fetches to borrowers; workers add task-execution handlers), an
in-process memory store for small objects and pending results, a lease pool
that acquires/caches worker leases from node agents (with spillback), and
direct push of tasks/actor-calls to leased workers (no agent on the hot
path — reference: PushNormalTask at normal_task_submitter.cc:518).

Ownership model: the submitting process owns task results and puts; borrowers
resolve objects from the owner (inline) or via the node agents' shared-memory
stores (large objects) — reference: reference_counter.h ownership design,
scoped here to owner-resident metadata.
"""

from __future__ import annotations

import asyncio
import os as _os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.config import Config
from ray_tpu_torch.runtime import rpc
from ray_tpu_torch.runtime.ids import (ActorID, NodeID, ObjectID, TaskID, WorkerID)
from ray_tpu_torch.runtime.object_store import SharedStoreReader
from ray_tpu_torch.util import tracing
from ray_tpu_torch.runtime.serialization import (FunctionCache, Serialized,
                                           dumps_oob, loads_oob)

def _M_TASKS():
    from ray_tpu_torch.util.metrics import core_metric
    return core_metric("counter", "ray_tpu_tasks_submitted_total",
                       "Tasks submitted by this process")


PIPELINE_DEPTH = 2          # in-flight tasks per leased worker
MAX_SPILLBACK_HOPS = 4
LEASE_IDLE_RETURN_S = 2.0
ACTOR_BATCH_MAX = 64        # calls coalesced into one actor RPC
ACTOR_MAX_INFLIGHT_BATCHES = 8  # pipelined un-acked batches per actor
TASK_BATCH_MAX = 32         # tasks coalesced into one worker RPC
MAX_TASK_PUMPS = 32         # concurrent batch senders per resource shape
LINEAGE_MAX_BYTES = 256 * 1024 * 1024  # owner-side recoverability budget


# --- public value types -----------------------------------------------------

class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """User task/actor-method raised; carries the remote traceback."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


class WorkerCrashedError(RayTpuError):
    pass


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


@dataclass(frozen=True)
class ObjectRef:
    """Handle to a (possibly pending) object. Owner is the process that
    created it (reference: ObjectRef + ownership in core_worker.h)."""
    oid: ObjectID
    owner_addr: Tuple[str, int]
    size_hint: int = 0

    def hex(self) -> str:
        return self.oid.hex()

    def __repr__(self):
        return f"ObjectRef({self.oid.hex()[:12]})"

    # Allow `await ref` inside async actors/drivers.
    def __await__(self):
        from ray_tpu_torch import api
        return api.get_async(self).__await__()


# --- memory store -----------------------------------------------------------

PENDING, READY, IN_SHM, ERROR = "pending", "ready", "in_shm", "error"


@dataclass
class _Entry:
    status: str = PENDING
    frame: Optional[bytes] = None          # Serialized frame (READY)
    shm_size: int = 0                      # IN_SHM
    error_frame: Optional[bytes] = None    # ERROR: serialized exception
    event: asyncio.Event = field(default_factory=asyncio.Event)
    executing_on: Optional[Tuple[str, int]] = None  # for cancel


class MemoryStore:
    """Owner-resident object states + waiters (reference:
    core_worker/store_provider/memory_store/memory_store.h)."""

    def __init__(self):
        self._entries: Dict[ObjectID, _Entry] = {}

    def create_pending(self, oid: ObjectID) -> _Entry:
        e = self._entries.get(oid)
        if e is None:
            e = _Entry()
            self._entries[oid] = e
        return e

    def get_entry(self, oid: ObjectID) -> Optional[_Entry]:
        return self._entries.get(oid)

    def resolve(self, oid: ObjectID, *, frame=None, shm_size=None,
                error_frame=None):
        e = self.create_pending(oid)
        if error_frame is not None:
            e.status, e.error_frame = ERROR, error_frame
        elif shm_size is not None:
            e.status, e.shm_size = IN_SHM, shm_size
        else:
            e.status, e.frame = READY, frame
        e.event.set()

    async def wait_ready(self, oid: ObjectID,
                         timeout: Optional[float]) -> _Entry:
        e = self.create_pending(oid)
        if not e.event.is_set():
            if timeout is None:
                await e.event.wait()
            else:
                await asyncio.wait_for(e.event.wait(), timeout)
        return e

    def delete(self, oid: ObjectID):
        self._entries.pop(oid, None)

    def reset_pending(self, oid: ObjectID) -> _Entry:
        """Back to PENDING in place — parked waiters keep their event and
        wake on the next resolve (used by object recovery)."""
        e = self._entries.get(oid)
        if e is None:
            return self.create_pending(oid)
        e.status = PENDING
        e.frame = e.error_frame = None
        e.shm_size = 0
        e.event.clear()
        return e

    def __contains__(self, oid: ObjectID):
        e = self._entries.get(oid)
        return e is not None and e.status != PENDING


def _scan_ref_deps(args, kwargs) -> List["ObjectRef"]:
    """Top-level ObjectRef args a task must wait on before leasing."""
    deps = [a for a in args if isinstance(a, ObjectRef)]
    deps += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
    return deps


def _lease_err_transient(e: BaseException) -> bool:
    """Scheduling errors that resolve themselves as the cluster churns
    (saturation, worker spawn lag, agent restart) vs. ones every retry
    would hit identically (infeasible shape, refusal, hop limit)."""
    if isinstance(e, rpc.RpcError):
        return True
    msg = str(e)
    return "lease timeout" in msg or "no worker available" in msg


@dataclass
class _TaskSpec:
    task_id: TaskID
    digest: bytes
    args_frame: bytes
    oids: List[ObjectID]
    retries: int
    attempt: int = 0
    stream_id: Optional[ObjectID] = None
    # traceparent of the REQUEST trace ambient at submission (None
    # outside one): shipped with the exec RPC so the executor's exec
    # span joins the request's trace (util/tracing.py request layer)
    trace: Optional[str] = None


class _StreamState:
    """Owner-side state of one streaming-generator return (the
    ObjectRefGenerator analog — reference:
    python/ray/_private/object_ref_generator.py:32, with the C++ stream
    bookkeeping of task_manager.cc HandleReportGeneratorItemReturns
    collapsed into this owner-resident object).

    Items arrive as `stream_item` RPCs from the producing worker and are
    delivered to the consumer in index order. Backpressure: once
    `window` items sit unconsumed, arriving handlers PARK (delaying
    their RPC replies) until the consumer drains — the producer's
    bounded-inflight push loop then stalls, so an unread stream never
    grows past window + producer_inflight items."""

    __slots__ = ("ready", "buffer", "next_index", "ended", "end_error",
                 "event", "closed", "window", "gate", "peak_unconsumed",
                 "done")

    def __init__(self, window: int):
        from collections import deque
        self.ready: "deque" = deque()   # ObjectRefs, delivery order
        self.buffer: Dict[int, ObjectRef] = {}  # out-of-order arrivals
        self.next_index = 0
        self.ended = False
        self.end_error: Optional[bytes] = None
        self.event = asyncio.Event()    # consumer wakeup
        self.closed = False             # consumer abandoned the stream
        self.window = window
        self.gate = asyncio.Event()     # producer-side backpressure
        self.gate.set()
        self.peak_unconsumed = 0        # observability (tests assert it)
        self.done = asyncio.Event()     # terminated (ended/closed/failed)

    @property
    def unconsumed(self) -> int:
        return len(self.ready) + len(self.buffer)


# --- lease pool -------------------------------------------------------------

@dataclass
class _LeasedWorker:
    lease_id: str
    agent_addr: Tuple[str, int]
    worker_addr: Tuple[str, int]
    worker_id: WorkerID
    key: Optional[tuple] = None
    inflight: int = 0
    last_used: float = field(default_factory=time.monotonic)
    dead: bool = False


class _ShapePool:
    """Per-resource-shape lease state: workers, parked waiters, and the
    number of lease requests in flight to the agents."""

    __slots__ = ("workers", "waiters", "pending_leases")

    def __init__(self):
        self.workers: List[_LeasedWorker] = []
        from collections import deque
        self.waiters: "deque[asyncio.Future]" = deque()
        self.pending_leases = 0


class LeasePool:
    """Submitter-side cache of leased workers keyed by resource shape
    (reference: normal_task_submitter.h lease caching/pipelining).

    Freed slots are handed directly to the oldest parked waiter (O(1) per
    release) instead of notify_all on a shared condition — with thousands
    of queued tasks the broadcast wakeups were O(n^2) and dominated task
    throughput. Lease requests scale with demand (ceil(waiters/depth),
    capped) rather than one at a time."""

    MAX_PENDING_LEASES = 16

    def __init__(self, ctx: "CoreContext"):
        self.ctx = ctx
        self._pools: Dict[tuple, _ShapePool] = {}
        self._reaper: Optional[asyncio.Task] = None

    @staticmethod
    def shape_key(resources: dict, pg, policy: str = "default",
                  env_key=None) -> tuple:
        pg_part = (pg[0], pg[1]) if pg else None
        return (tuple(sorted(resources.items())), pg_part, policy,
                env_key)

    async def acquire(self, resources: dict,
                      pg: Optional[tuple] = None,
                      policy: str = "default",
                      env_key=None) -> _LeasedWorker:
        if self._reaper is None:
            self._reaper = asyncio.ensure_future(self._reap_loop())
        key = self.shape_key(resources, pg, policy, env_key)
        sp = self._pools.setdefault(key, _ShapePool())
        if policy == "spread":
            # True spreading: one fresh lease per task, rotated by the
            # agents' round-robin — no reuse that would pin one node.
            lw = await self._lease_now(resources, pg, policy, env_key)
            lw.key = key
            lw.inflight = 1
            sp.workers.append(lw)
            return lw
        best = None
        for lw in sp.workers:
            if not lw.dead and lw.inflight < PIPELINE_DEPTH:
                if best is None or lw.inflight < best.inflight:
                    best = lw
        if best is not None:
            best.inflight += 1
            best.last_used = time.monotonic()
            return best
        fut = asyncio.get_running_loop().create_future()
        sp.waiters.append(fut)
        self._maybe_request_leases(key, sp)
        return await fut

    async def _lease_now(self, resources, pg, policy,
                         env_key=None) -> _LeasedWorker:
        from ray_tpu_torch.runtime.runtime_env import from_key
        addr = self.ctx.agent_addr
        pg_id = pg[0] if pg else None
        bundle_index = pg[1] if pg else None
        for hop in range(MAX_SPILLBACK_HOPS):
            r = await self.ctx.pool.call(
                addr, "request_lease", resources=resources,
                pg_id=pg_id, bundle_index=bundle_index, policy=policy,
                allow_spillback=(hop == 0),
                runtime_env=from_key(env_key),
                timeout=self.ctx.config.lease_timeout_s + 30.0)
            if "spillback" in r:
                addr = tuple(r["spillback"])
                continue
            if "granted" in r:
                g = r["granted"]
                lw = _LeasedWorker(
                    lease_id=g["lease_id"], agent_addr=addr,
                    worker_addr=tuple(g["worker_addr"]),
                    worker_id=g["worker_id"])
                # Confirm receipt so the agent won't reap this grant as
                # orphaned (fire-and-forget; the pool retries transport
                # failures, and a lost ack just re-leases later).
                asyncio.ensure_future(self._ack_lease(lw))
                return lw
            raise RayTpuError(r.get("error", "lease refused"))
        raise RayTpuError("spillback loop exceeded hop limit")

    async def _ack_lease(self, lw: "_LeasedWorker"):
        ok = False
        try:
            r = await self.ctx.pool.call(lw.agent_addr, "ack_lease",
                                         lease_id=lw.lease_id,
                                         timeout=5.0)
            ok = bool(r.get("ok"))
        except Exception:
            ok = False
        if not ok:
            # The agent either reaped this grant or is unreachable: the
            # lease is (or will be) fenced off agent-side, so retire the
            # worker here too — otherwise parked waiters could still be
            # handed slots on it.
            lw.dead = True
            sp = self._pools.get(lw.key)
            if sp is not None and lw in sp.workers:
                sp.workers.remove(lw)
            if sp is not None and sp.waiters:
                self._maybe_request_leases(lw.key, sp)

    def _maybe_request_leases(self, key: tuple, sp: _ShapePool):
        import math
        demand = math.ceil(len(sp.waiters) / PIPELINE_DEPTH)
        want = min(demand, self.MAX_PENDING_LEASES) - sp.pending_leases
        for _ in range(want):
            sp.pending_leases += 1
            asyncio.ensure_future(self._request_lease(key, sp))

    async def _request_lease(self, key: tuple, sp: _ShapePool):
        resources, pg, policy = dict(key[0]), key[1], key[2]
        env_key = key[3] if len(key) > 3 else None
        try:
            lw = await self._lease_now(resources, pg, policy, env_key)
            lw.key = key
            # Demand may have drained while this request was queued at the
            # agent: a surplus lease would sit idle holding resources until
            # the reaper — hand it straight back instead.
            if not sp.waiters and any(
                    w for w in sp.workers
                    if not w.dead and w.inflight < PIPELINE_DEPTH):
                try:
                    await self.ctx.pool.call(
                        lw.agent_addr, "release_lease",
                        lease_id=lw.lease_id, timeout=5.0)
                except Exception:
                    pass
                return
            sp.workers.append(lw)
            for _ in range(PIPELINE_DEPTH):
                if not self._hand_slot(sp, lw):
                    break
        except Exception as e:  # noqa: BLE001 — propagate to parked waiters
            if _lease_err_transient(e):
                # Transient (lease timeout / no worker yet / agent
                # hiccup): queued tasks wait for resources indefinitely —
                # matching the reference, where a pending lease request
                # never turns into a task failure (raylet keeps it
                # queued). Pause so a saturated agent isn't hammered,
                # then the finally block re-requests for the remaining
                # waiters.
                await asyncio.sleep(1.0)
            else:
                # Terminal for this shape (infeasible / lease refused /
                # spillback hop limit): every waiter would fail the same
                # way — surface instead of looping forever.
                while sp.waiters:
                    fut = sp.waiters.popleft()
                    if not fut.done():
                        fut.set_exception(e)
        finally:
            sp.pending_leases -= 1
            if sp.waiters:
                self._maybe_request_leases(key, sp)

    def _hand_slot(self, sp: _ShapePool, lw: _LeasedWorker) -> bool:
        """Give one execution slot on lw to the oldest live waiter."""
        if lw.dead:
            return False
        while sp.waiters:
            fut = sp.waiters.popleft()
            if fut.done():  # cancelled waiter
                continue
            lw.inflight += 1
            lw.last_used = time.monotonic()
            fut.set_result(lw)
            return True
        return False

    async def release_slot(self, lw: _LeasedWorker, dead: bool = False):
        sp = self._pools.get(lw.key)
        lw.inflight -= 1
        lw.last_used = time.monotonic()
        if not dead and lw.key is not None and lw.key[2] == "spread" \
                and lw.inflight == 0 and not lw.dead:
            # Spread leases are one-shot by design: return the resources
            # immediately rather than letting an idle lease pin a node.
            lw.dead = True
            if sp is not None and lw in sp.workers:
                sp.workers.remove(lw)
            try:
                await self.ctx.pool.call(lw.agent_addr, "release_lease",
                                         lease_id=lw.lease_id, timeout=5.0)
            except Exception:
                pass
            return
        if dead:
            if not lw.dead:
                lw.dead = True
                if sp is not None and lw in sp.workers:
                    sp.workers.remove(lw)
                try:
                    await self.ctx.pool.call(
                        lw.agent_addr, "release_lease",
                        lease_id=lw.lease_id, worker_died=True)
                except Exception:
                    pass
            if sp is not None and sp.waiters:
                self._maybe_request_leases(lw.key, sp)
            return
        if sp is not None and sp.waiters and lw.inflight < PIPELINE_DEPTH:
            # Hand the freed slot straight to a parked waiter.
            self._hand_slot(sp, lw)

    async def _reap_loop(self):
        while True:
            await asyncio.sleep(LEASE_IDLE_RETURN_S / 2)
            now = time.monotonic()
            for key, sp in self._pools.items():
                keep = []
                for lw in sp.workers:
                    if (not lw.dead and lw.inflight == 0
                            and now - lw.last_used > LEASE_IDLE_RETURN_S):
                        lw.dead = True
                        asyncio.ensure_future(self.ctx.pool.call(
                            lw.agent_addr, "release_lease",
                            lease_id=lw.lease_id))
                    elif not lw.dead:
                        keep.append(lw)
                sp.workers[:] = keep

    async def shutdown(self):
        if self._reaper:
            self._reaper.cancel()
        for sp in self._pools.values():
            for lw in sp.workers:
                if not lw.dead:
                    try:
                        await self.ctx.pool.call(
                            lw.agent_addr, "release_lease",
                            lease_id=lw.lease_id, timeout=2.0)
                    except Exception:
                        pass
        self._pools.clear()


# --- core context -----------------------------------------------------------

class CoreContext:
    """One per process (driver or worker). All methods are async and run on
    the process's event loop."""

    def __init__(self, head_addr, agent_addr, node_id: NodeID,
                 session_id: str, config: Optional[Config] = None,
                 is_driver: bool = True):
        self.config = config or Config.from_env()
        self.head_addr = tuple(head_addr)
        self.agent_addr = tuple(agent_addr)
        self.node_id = node_id
        self.session_id = session_id
        self.is_driver = is_driver
        self.store = MemoryStore()
        self.pool = rpc.ConnectionPool(
            retry_attempts=self.config.rpc_retry_max_attempts,
            retry_backoff_s=self.config.rpc_retry_backoff_s)
        self.server = rpc.RpcServer({
            "fetch_object": self._handle_fetch_object,
            "reconstruct_object": self._handle_reconstruct_object,
            "stream_item": self._handle_stream_item,
            "stream_end": self._handle_stream_end,
            "fetch_tensor": self._handle_fetch_tensor,
            "free_tensor": self._handle_free_tensor,
            "ping": self._handle_ping,
        })
        self._streams: Dict[ObjectID, _StreamState] = {}
        self.addr: Optional[Tuple[str, int]] = None
        self.leases = LeasePool(self)
        self.fn_cache = FunctionCache()
        self._shipped_digests: Dict[Tuple[str, int], set] = {}
        self.shm_reader = SharedStoreReader()
        self._actor_addr_cache: Dict[ActorID, Tuple[str, int]] = {}
        self._actor_pending: Dict[ActorID, Any] = {}
        # Coalesced cross-thread submission stage: producers append and
        # wake the loop ONLY if no drain is already scheduled — without
        # this every small call pays a self-pipe write + epoll wakeup,
        # which dominates sync submission cost under pipelining.
        from collections import deque as _deque
        self._stage: Any = _deque()
        self._stage_scheduled = False
        self._actor_pump_live: Dict[ActorID, bool] = {}
        self._actor_inflight: Dict[ActorID, set] = {}
        self._actor_mc: Dict[ActorID, int] = {}
        from collections import OrderedDict
        self._lineage: "OrderedDict[ObjectID, tuple]" = OrderedDict()
        self._lineage_task_bytes: Dict[tuple, int] = {}
        self._lineage_bytes = 0
        self._recovering: Dict[ObjectID, asyncio.Future] = {}
        self._task_queues: Dict[tuple, dict] = {}

    async def start(self, host: str = "127.0.0.1"):
        self.loop = asyncio.get_running_loop()
        self.addr = await self.server.start(host, 0)
        return self.addr

    async def stop(self):
        await self.leases.shutdown()
        await self.server.stop()
        await self.pool.close()
        self.shm_reader.close()

    async def _handle_ping(self):
        return "pong"

    async def _handle_fetch_tensor(self, tid: str):
        """Cross-process TensorRef resolution (runtime/device_store.py):
        host-stage the parked device array off-loop and ship it."""
        from ray_tpu_torch.runtime.device_store import _store
        return await asyncio.get_running_loop().run_in_executor(
            None, _store().host_bytes, tid)

    async def _handle_free_tensor(self, tid: str):
        from ray_tpu_torch.runtime.device_store import _store
        _store().drop(tid)
        return {"ok": True}

    # --- object plane: put/get/wait ---------------------------------------

    async def put_shm(self, oid: ObjectID, ser: Serialized) -> int:
        """Write a Serialized frame into the node's shared store: ask the
        agent for (segment, offset) in a pre-faulted arena, write the frame
        directly into the cached mapping (no intermediate copy, no fresh
        mmap page faults), then seal."""
        size = ser.frame_nbytes
        r = await self.pool.call(self.agent_addr, "alloc_object",
                                 oid=oid, size=size)
        try:
            mv = self.shm_reader.read(r["segname"], size, r["offset"])
            ser.write_into(mv)
            del mv
        except BaseException:
            try:
                await self.pool.call(self.agent_addr, "abort_object",
                                     oid=oid)
            except Exception:
                pass
            raise
        await self.pool.call(self.agent_addr, "seal_object", oid=oid)
        return size

    async def put_serialized(self, ser: Serialized) -> ObjectRef:
        oid = ObjectID.generate()
        if ser.total_bytes <= self.config.inline_object_max_bytes:
            self.store.resolve(oid, frame=ser.to_bytes())
            return ObjectRef(oid, self.addr, ser.total_bytes)
        size = await self.put_shm(oid, ser)
        self.store.resolve(oid, shm_size=size)
        return ObjectRef(oid, self.addr, size)

    async def put(self, value: Any) -> ObjectRef:
        from ray_tpu_torch.runtime.serialization import serialize
        return await self.put_serialized(serialize(value))

    def try_get_local(self, ref: ObjectRef):
        """Caller-thread fast path: returns (True, value) iff the object is
        resolved in this process's memory store as an inline value (or a
        cached error, which raises). shm-resident objects need the agent
        RPC and fall through. Thread-safe: dict reads under the GIL on
        entries only mutated monotonically PENDING->final."""
        e = self.store.get_entry(ref.oid)
        if e is None:
            return False, None
        if e.status == READY:
            return True, self._loads_value(e.frame)
        if e.status == ERROR:
            raise self._loads_error(e.error_frame)
        return False, None

    def _refs_locally_ready(self, refs) -> bool:
        for r in refs:
            e = self.store.get_entry(r.oid)
            if e is None or e.status == PENDING:
                return False
        return True

    async def _notify_block_state(self, method: str, token: str) -> bool:
        """Tell the local agent this worker is entering/leaving a blocking
        get/wait inside a task, so the lease's resources free up for the
        children it waits on (reference: blocked workers release their
        CPU, raylet HandleWorkerBlocked). `token` names this blocking
        episode: the agent tracks blocked state as a token set, so
        retried or duplicated RPCs are idempotent, and the caller sends
        worker_unblocked whenever it *attempted* worker_blocked (even on
        an error/timeout reply) so an applied-but-unacked block can't
        inflate the node's resources forever."""
        import os
        wid = os.environ.get("RAY_TPU_WORKER_ID")
        if not wid:
            return False
        try:
            r = await self.pool.call(
                self.agent_addr, method,
                worker_id=WorkerID.from_hex(wid), token=token,
                timeout=5.0)
            return bool(r.get("ok"))
        except Exception:
            return False

    async def get(self, refs, timeout: Optional[float] = None,
                  in_task: bool = False):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        from ray_tpu_torch.util import tracing
        if not in_task and not self.is_driver \
                and tracing.current_span.get():
            in_task = True  # async actor methods run in exec context
        block_token = None
        if in_task and not self._refs_locally_ready(refs):
            block_token = _os.urandom(8).hex()
            await self._notify_block_state("worker_blocked", block_token)
        try:
            # The outer wait_for bounds the WHOLE path — resolve, pull,
            # and any lineage recovery — by the caller's budget.
            coro = asyncio.gather(
                *[self._get_one(r, timeout) for r in refs])
            if timeout is not None:
                values = await asyncio.wait_for(coro, timeout)
            else:
                values = await coro
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"get() timed out after {timeout}s")
        finally:
            if block_token is not None:
                # unconditional: the block may have applied even if its
                # reply was lost; unknown tokens are a no-op agent-side
                await self._notify_block_state(
                    "worker_unblocked", block_token)
        return values[0] if single else values

    async def _get_one(self, ref: ObjectRef, timeout: Optional[float]):
        e = self.store.get_entry(ref.oid)
        if e is not None and e.status != PENDING:
            return await self._load_entry(ref, e)
        if self._is_owner(ref):
            e = await self.store.wait_ready(ref.oid, timeout)
            return await self._load_entry(ref, e)
        # Borrower: ask the owner (parks until ready owner-side).
        r = await self.pool.call(
            ref.owner_addr, "fetch_object", oid=ref.oid,
            timeout=(timeout + 5.0) if timeout is not None else 3610.0,
            wait_timeout=timeout)
        kind = r.get("kind")
        if kind == "inline":
            return self._loads_value(r["frame"])
        if kind == "error":
            raise self._loads_error(r["frame"])
        if kind == "shm":
            return await self._read_shm(ref.oid, ref.owner_addr)
        if kind == "timeout":
            raise GetTimeoutError(f"object {ref.oid} not ready")
        raise ObjectLostError(f"{ref.oid}: owner replied {r}")

    def _is_owner(self, ref: ObjectRef) -> bool:
        return tuple(ref.owner_addr) == self.addr

    async def _load_entry(self, ref: ObjectRef, e: _Entry):
        if e.status == READY:
            return self._loads_value(e.frame)
        if e.status == ERROR:
            raise self._loads_error(e.error_frame)
        if e.status == IN_SHM:
            return await self._read_shm(ref.oid, ref.owner_addr)
        raise ObjectLostError(f"{ref.oid} in unexpected state {e.status}")

    def _loads_value(self, frame: bytes):
        return loads_oob(frame)

    def _loads_error(self, frame: bytes) -> BaseException:
        payload = loads_oob(frame)
        if isinstance(payload, BaseException):
            return payload
        return TaskError(str(payload))

    async def _read_shm(self, oid: ObjectID, owner_addr=None):
        for _attempt in range(3):
            r = await self.pool.call(self.agent_addr, "resolve_object",
                                     oid=oid, timeout=120.0)
            seg = r.get("segname")
            if seg is not None:
                # Read-only view: deserialized numpy arrays alias the
                # node-wide object store; a writable view would let any
                # consumer silently corrupt the sealed object for every
                # other reader (the reference makes plasma buffers
                # read-only for the same reason).
                mv = self.shm_reader.read(
                    seg, r["size"], r.get("offset", 0)).toreadonly()
                return loads_oob(mv)
            # Lost (producing node died): recover via lineage — owner
            # re-executes the producing task (reference:
            # object_recovery_manager.h:41); borrowers ask the owner.
            if oid in self._lineage:
                await self._recover_object(oid)
                # Re-execution may have resolved inline, or with the
                # task's real error — surface those instead of looping
                # (and re-running a deterministically failing task).
                e = self.store.get_entry(oid)
                if e is not None and e.status == READY:
                    return self._loads_value(e.frame)
                if e is not None and e.status == ERROR:
                    raise self._loads_error(e.error_frame)
                continue
            if owner_addr is not None and tuple(owner_addr) != self.addr:
                try:
                    rr = await self.pool.call(
                        tuple(owner_addr), "reconstruct_object",
                        oid=oid, timeout=300.0)
                except rpc.RpcError:
                    break
                if rr.get("ok"):
                    kind = rr.get("kind")
                    if kind == "ready":
                        return self._loads_value(rr["frame"])
                    if kind == "error":
                        raise self._loads_error(rr["frame"])
                    continue
            break
        raise ObjectLostError(f"{oid} not found in any object store")

    async def _recover_object(self, oid: ObjectID):
        """Re-execute the producing task (deduped across concurrent
        readers) and wait until the owner-side entry resolves again."""
        fut = self._recovering.get(oid)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._recovering[oid] = fut
            asyncio.ensure_future(self._drive_recovery(oid, fut))
        await asyncio.shield(fut)

    async def _drive_recovery(self, oid: ObjectID, fut: asyncio.Future):
        try:
            key, s = self._lineage[oid]
            for o in s.oids:
                e = self.store.get_entry(o)
                # Only shm-resident outputs lost their backing store;
                # inline siblings stay final — resetting them would break
                # try_get_local's lock-free monotonic-state fast path.
                if e is None or e.status in (PENDING, IN_SHM):
                    self.store.reset_pending(o)
            spec = _TaskSpec(TaskID.generate(), s.digest, s.args_frame,
                             s.oids, s.retries)
            # Same dependency gating as the submission path: re-executed
            # tasks must not take a lease while blocked on arg refs.
            try:
                args, kwargs = loads_oob(s.args_frame)
                deps = _scan_ref_deps(args, kwargs)
            except Exception:
                deps = []
            if deps:
                await self._enqueue_after_deps(key, spec, deps)
            else:
                self._enqueue_task(key, spec)
            await self.store.wait_ready(oid, 300.0)
            fut.set_result(True)
        except BaseException as e:  # noqa: BLE001 — surface to readers
            if not fut.done():
                fut.set_exception(
                    ObjectLostError(f"recovery of {oid} failed: {e}"))
        finally:
            self._recovering.pop(oid, None)

    def _register_lineage(self, key: tuple, s: "_TaskSpec"):
        """Byte accounting is keyed by the task's oid tuple — stable
        across recoveries (which re-execute under a fresh spec object
        but the same return oids) — so re-registration never
        double-counts."""
        tkey = tuple(s.oids)
        if tkey not in self._lineage_task_bytes:
            self._lineage_task_bytes[tkey] = len(s.args_frame)
            self._lineage_bytes += len(s.args_frame)
        for oid in s.oids:
            self._lineage[oid] = (key, s)
        self._evict_lineage()

    def _drop_lineage(self, oid: ObjectID):
        """Per-oid: freeing one return ref must not destroy
        recoverability of still-live sibling refs; the task's bytes are
        released when its last oid goes."""
        ent = self._lineage.pop(oid, None)
        if ent is None:
            return
        _key, s = ent
        if not any(o in self._lineage for o in s.oids):
            self._lineage_bytes -= self._lineage_task_bytes.pop(
                tuple(s.oids), 0)

    def _evict_lineage(self):
        """Bound owner-side lineage memory (the reference bounds lineage
        by bytes too, task_manager.h max_lineage_bytes); evicted objects
        simply lose recoverability."""
        while self._lineage_bytes > LINEAGE_MAX_BYTES and self._lineage:
            self._drop_lineage(next(iter(self._lineage)))

    async def _handle_reconstruct_object(self, oid: ObjectID):
        if oid not in self._lineage:
            return {"ok": False, "error": "no lineage for object"}
        try:
            await self._recover_object(oid)
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": str(e)}
        # Tell the borrower how the re-execution resolved so it can
        # surface an inline value / the task's real error directly.
        e = self.store.get_entry(oid)
        if e is not None and e.status == READY:
            return {"ok": True, "kind": "ready", "frame": e.frame}
        if e is not None and e.status == ERROR:
            return {"ok": True, "kind": "error", "frame": e.error_frame}
        return {"ok": True, "kind": "shm"}

    async def _handle_fetch_object(self, oid: ObjectID,
                                   wait_timeout: Optional[float] = None):
        try:
            e = await self.store.wait_ready(
                oid, wait_timeout if wait_timeout is not None else 3600.0)
        except asyncio.TimeoutError:
            return {"kind": "timeout"}
        if e.status == READY:
            return {"kind": "inline", "frame": e.frame}
        if e.status == ERROR:
            return {"kind": "error", "frame": e.error_frame}
        if e.status == IN_SHM:
            return {"kind": "shm", "size": e.shm_size}
        return {"kind": "lost"}

    # --- streaming generator returns ---------------------------------------

    def create_stream(self, window: Optional[int] = None) -> ObjectID:
        """Register owner-side state for a new streaming return and hand
        back its stream id (an ObjectID so worker->owner RPCs reuse the
        id plumbing)."""
        sid = ObjectID.generate()
        self._streams[sid] = _StreamState(
            window or self.config.stream_backpressure_window)
        return sid

    async def _handle_stream_item(self, stream_id: ObjectID, index: int,
                                  oid: ObjectID, frame=None,
                                  shm_size=None):
        """Producer pushed one yielded object. Parks (delaying the RPC
        reply, which stalls the producer's bounded-inflight loop) while
        the consumer is `window` items behind."""
        st = self._streams.get(stream_id)
        if st is None or st.closed:
            return {"closed": True}
        while st.unconsumed >= st.window and not st.closed:
            st.gate.clear()
            await st.gate.wait()
        st = self._streams.get(stream_id)  # may have closed while parked
        if st is None or st.closed:
            return {"closed": True}
        if frame is not None:
            self.store.resolve(oid, frame=frame)
        else:
            self.store.resolve(oid, shm_size=shm_size)
        st.buffer[index] = ObjectRef(oid, self.addr,
                                     shm_size or len(frame or b""))
        while st.next_index in st.buffer:
            st.ready.append(st.buffer.pop(st.next_index))
            st.next_index += 1
        st.peak_unconsumed = max(st.peak_unconsumed, st.unconsumed)
        st.event.set()
        return {"ok": True}

    async def _handle_stream_end(self, stream_id: ObjectID,
                                 error_frame=None):
        st = self._streams.get(stream_id)
        if st is None:
            return {"closed": True}
        st.ended = True
        st.end_error = error_frame
        st.event.set()
        st.done.set()
        return {"ok": True}

    def fail_stream(self, stream_id: ObjectID, err: Exception):
        """Owner-side termination: the producer died before sending
        stream_end (connection lost / lease failure / dep failure)."""
        st = self._streams.get(stream_id)
        if st is None or st.ended:
            return
        st.ended = True
        st.end_error = dumps_oob(err)
        st.event.set()
        st.done.set()

    async def stream_done(self, stream_id: ObjectID):
        """Resolves when the stream terminates (ended, failed, or
        closed) — the load-tracking signal for routers."""
        st = self._streams.get(stream_id)
        if st is None:
            return
        await st.done.wait()

    def close_stream(self, stream_id: ObjectID):
        """Consumer abandoned the stream: drop state and unblock any
        parked producer handlers (their replies say closed -> the
        producer stops the generator). Later stream_item RPCs find no
        state and also get closed=True."""
        st = self._streams.pop(stream_id, None)
        if st is None:
            return
        st.closed = True
        st.gate.set()
        st.event.set()
        st.done.set()
        for ref in st.ready:
            self.store.delete(ref.oid)
        for ref in st.buffer.values():
            self.store.delete(ref.oid)

    async def stream_next(self, stream_id: ObjectID,
                          timeout: Optional[float] = None) -> ObjectRef:
        """Next ready ObjectRef in the stream, in yield order. Raises
        StopAsyncIteration at a clean end, the producer's error at a
        failed end (the partial prefix is still delivered first)."""
        st = self._streams.get(stream_id)
        if st is None:
            raise StopAsyncIteration
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            if st.ready:
                ref = st.ready.popleft()
                if st.unconsumed < st.window:
                    st.gate.set()
                return ref
            if st.ended:
                del self._streams[stream_id]
                # an error-terminated stream can hold undelivered
                # out-of-order items (a gap index never arrived): their
                # store entries would otherwise leak, unreachable
                for ref in st.buffer.values():
                    self.store.delete(ref.oid)
                if st.end_error is not None:
                    raise self._loads_error(st.end_error)
                raise StopAsyncIteration
            st.event.clear()
            if deadline is None:
                await st.event.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(
                        f"stream item not ready after {timeout}s")
                try:
                    await asyncio.wait_for(st.event.wait(), remaining)
                except asyncio.TimeoutError:
                    raise GetTimeoutError(
                        f"stream item not ready after {timeout}s")

    async def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
                   timeout: Optional[float] = None,
                   in_task: bool = False):
        """Park one subscription per pending ref (owner-side event wait; for
        borrowed refs a long-poll parked on the owner) and return once
        `num_returns` are ready — no polling loop (reference:
        raylet/wait_manager.h parks waiters on object-ready callbacks)."""
        refs = list(refs)
        num_returns = min(num_returns, len(refs))
        block_token = None
        if in_task and sum(
                1 for r in refs
                if (e := self.store.get_entry(r.oid)) is not None
                and e.status != PENDING) < num_returns:
            # same deadlock-avoidance as get(): a task parked in wait()
            # must give its lease's resources back to its children
            block_token = _os.urandom(8).hex()
            await self._notify_block_state("worker_blocked", block_token)
        tasks: Dict[asyncio.Task, ObjectRef] = {
            asyncio.ensure_future(self._await_ready(r)): r for r in refs}
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        ready_set: set = set()
        try:
            while tasks and len(ready_set) < num_returns:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                done, _ = await asyncio.wait(
                    tasks.keys(), timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    break
                for t in done:
                    ready_set.add(id(tasks.pop(t)))
        finally:
            for t in tasks:
                t.cancel()
            if block_token is not None:
                await self._notify_block_state(
                    "worker_unblocked", block_token)
        # Exactly num_returns in `ready` even when more resolved in the
        # same wakeup — callers rely on the reference's contract that
        # len(ready) <= num_returns; surplus completions stay "pending"
        # and return instantly on the next wait().
        ready = [r for r in refs if id(r) in ready_set][:num_returns]
        ready_ids = {id(r) for r in ready}
        pending = [r for r in refs if id(r) not in ready_ids]
        return ready, pending

    async def _await_ready(self, ref: ObjectRef) -> None:
        """Resolves when the ref is ready; caches the result locally so the
        subsequent get() is a memory-store hit."""
        e = self.store.get_entry(ref.oid)
        if e is not None and e.status != PENDING:
            return
        if self._is_owner(ref):
            await self.store.wait_ready(ref.oid, None)
            return
        while True:
            try:
                r = await self.pool.call(ref.owner_addr, "fetch_object",
                                         oid=ref.oid, wait_timeout=30.0,
                                         timeout=40.0)
            except rpc.RpcError:
                await asyncio.sleep(0.2)
                continue
            kind = r.get("kind")
            if kind == "inline":
                self.store.resolve(ref.oid, frame=r["frame"])
                return
            if kind == "error":
                self.store.resolve(ref.oid, error_frame=r["frame"])
                return
            if kind == "shm":
                self.store.resolve(ref.oid, shm_size=r["size"])
                return
            # "timeout": owner hasn't produced it yet — park again.

    # --- task submission ---------------------------------------------------

    def submit_task_sync(self, fn: Callable, args: tuple, kwargs: dict,
                         *, num_returns: int = 1,
                         resources: Optional[dict] = None,
                         max_retries: Optional[int] = None,
                         pg: Optional[tuple] = None,
                         policy: str = "default",
                         runtime_env: Optional[dict] = None
                         ) -> List[ObjectRef]:
        """Thread-safe submission from the sync API: serialization runs on
        the caller's thread (off the event loop), then scheduling hops to
        the loop with one call_soon_threadsafe — no per-call round trip
        (the reference's equivalent split is the Cython submit path feeding
        the C++ io_service, _raylet.pyx submit_task)."""
        resources = dict(resources or {"CPU": 1.0})
        retries = (max_retries if max_retries is not None
                   else self.config.default_max_task_retries)
        task_id = TaskID.generate()
        _M_TASKS().inc()
        tracing.record_submit(task_id.hex(), "task",
                              getattr(fn, "__name__", "?"))
        streaming = num_returns == "streaming"
        if streaming:
            # Re-executing a generator would replay already-delivered
            # items; producer death error-terminates the stream instead
            # (reference: streaming generators are retried only with
            # replay suppression — out of scope here).
            num_returns, retries = 0, 0
            stream_id = self.create_stream()
        oids = [ObjectID.generate() for _ in range(num_returns)]
        for oid in oids:
            self.store.create_pending(oid)
        refs = [ObjectRef(oid, self.addr) for oid in oids]
        digest = self.fn_cache.digest_for(fn)
        args_frame = dumps_oob((args, kwargs))
        spec = _TaskSpec(task_id, digest, args_frame, oids, retries,
                         stream_id=stream_id if streaming else None,
                         trace=tracing.wire_context())
        from ray_tpu_torch.runtime.runtime_env import to_key
        key = LeasePool.shape_key(resources, pg, policy,
                                  to_key(runtime_env))
        # Dependency resolution happens owner-side BEFORE the task takes a
        # lease (reference: task dependency manager gates scheduling,
        # raylet/dependency_manager.h). Otherwise a task blocking on its
        # args inside a worker pins the lease its producer needs —
        # deadlock under load.
        deps = _scan_ref_deps(args, kwargs)
        if deps:
            self._stage_put(self._spawn,
                            self._enqueue_after_deps(key, spec, deps))
        else:
            self._stage_put(self._enqueue_task, key, spec)
        return spec.stream_id if streaming else refs

    async def _enqueue_after_deps(self, key: tuple, spec: "_TaskSpec",
                                  deps: List[ObjectRef]):
        try:
            await asyncio.gather(*[self._await_ready(r) for r in deps])
        except Exception as e:  # noqa: BLE001 — dep fetch failed
            self._fail_spec(spec, RayTpuError(
                f"task dependency resolution failed: {e}"))
            return
        self._enqueue_task(key, spec)

    @staticmethod
    def _spawn(coro):
        asyncio.ensure_future(coro)

    def _stage_put(self, fn, *args):
        """Thread-safe handoff to the loop with wakeup coalescing: deque
        append is atomic under the GIL; the drain re-checks after
        clearing its flag so a racing append is never lost (at worst a
        second, empty drain runs)."""
        self._stage.append((fn, args))
        if not self._stage_scheduled:
            self._stage_scheduled = True
            self.loop.call_soon_threadsafe(self._stage_drain)

    def _stage_drain(self):
        self._stage_scheduled = False
        while True:
            try:
                fn, args = self._stage.popleft()
            except IndexError:
                break
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — keep draining
                import traceback
                traceback.print_exc()
        if self._stage:
            # items raced in after the flag cleared: re-arm via the
            # loop (NOT an inline re-loop) so sustained cross-thread
            # submission can't starve the loop's IO poll
            self._stage_scheduled = True
            self.loop.call_soon(self._stage_drain)

    async def submit_task(self, fn: Callable, args: tuple, kwargs: dict,
                          *, num_returns: int = 1,
                          resources: Optional[dict] = None,
                          max_retries: Optional[int] = None,
                          pg: Optional[tuple] = None,
                          policy: str = "default") -> List[ObjectRef]:
        return self.submit_task_sync(
            fn, args, kwargs, num_returns=num_returns, resources=resources,
            max_retries=max_retries, pg=pg, policy=policy)

    # Stateless tasks flow through per-shape pumps, like actor calls: each
    # pump holds one lease slot at a time and drains whatever queued into
    # one exec_task_batch RPC, so frame/task/executor-hop costs amortize
    # while distinct pumps still spread batches across workers.

    def _enqueue_task(self, key: tuple, spec: "_TaskSpec"):
        st = self._task_queues.get(key)
        if st is None:
            from collections import deque
            st = self._task_queues[key] = {"q": deque(), "pumps": 0,
                                           "sending": 0}
        st["q"].append(spec)
        self._kick_task_pumps(key, st)

    def _kick_task_pumps(self, key: tuple, st: dict):
        # Pumps busy mid-send don't count toward coverage: a queued task
        # must never wait behind an in-flight batch while capacity is idle.
        idle_pumps = st["pumps"] - st["sending"]
        if st["pumps"] < MAX_TASK_PUMPS and len(st["q"]) > idle_pumps:
            st["pumps"] += 1
            asyncio.ensure_future(self._task_pump(key, st))

    async def _task_pump(self, key: tuple, st: dict):
        q = st["q"]
        resources, pg, policy = dict(key[0]), key[1], key[2]
        env_key = key[3] if len(key) > 3 else None
        try:
            while q:
                if policy == "spread":
                    # Claim the spec BEFORE leasing: each spread lease is
                    # round-robin over nodes, so leases must map 1:1 to
                    # tasks — a surplus lease acquired after the queue
                    # drained would waste its rotation slot and skew the
                    # spread.
                    spec = q.popleft()
                    try:
                        lw = await self.leases.acquire(
                            resources, pg, policy, env_key)
                    except Exception as e:  # noqa: BLE001
                        if _lease_err_transient(e):
                            # Same wait-indefinitely semantics as the
                            # pooled path: spread tasks queue through
                            # saturation rather than fail.
                            q.append(spec)
                            await asyncio.sleep(1.0)
                            continue
                        self._fail_spec(spec, e if isinstance(
                            e, RayTpuError) else WorkerCrashedError(
                            f"lease failed: {e}"))
                        continue
                    st["sending"] += 1
                    try:
                        await self._send_task_batch(key, st, lw, [spec])
                    finally:
                        st["sending"] -= 1
                    continue
                try:
                    lw = await self.leases.acquire(resources, pg, policy,
                                                   env_key)
                except Exception as e:  # noqa: BLE001 — scheduling failure
                    # The lease pool absorbs transient errors internally
                    # (waiting tasks stay queued); anything surfacing
                    # here is terminal for the whole shape.
                    err = (e if isinstance(e, RayTpuError)
                           else WorkerCrashedError(f"lease failed: {e}"))
                    while q:
                        self._fail_spec(q.popleft(), err)
                    return
                if not q:
                    await self.leases.release_slot(lw)
                    return
                # Share the queue across live pumps: fan out to idle
                # workers before coalescing (no head-of-line blocking of a
                # fast task behind a slow one when capacity is free);
                # batch only once the backlog exceeds the pump count.
                # Streaming tasks always go ALONE: their batch reply is
                # held open for the stream's whole (consumer-paced)
                # lifetime, and co-batched tasks would be head-of-line
                # blocked behind it indefinitely.
                width = min(TASK_BATCH_MAX,
                            -(-len(q) // max(st["pumps"], 1)))
                batch = []
                while q and len(batch) < width:
                    if q[0].stream_id is not None:
                        if not batch:
                            batch.append(q.popleft())
                        break
                    batch.append(q.popleft())
                st["sending"] += 1
                try:
                    await self._send_task_batch(key, st, lw, batch)
                finally:
                    st["sending"] -= 1
        finally:
            st["pumps"] -= 1
            if q:
                self._kick_task_pumps(key, st)

    async def _send_task_batch(self, key, st, lw, batch,
                               force_payload: bool = False):
        shipped = self._shipped_digests.setdefault(lw.worker_addr, set())
        calls = []
        for s in batch:
            payload = (self.fn_cache.payload_for(s.digest)
                       if force_payload or s.digest not in shipped
                       else None)
            calls.append({
                "task_id": s.task_id, "fn_digest": s.digest,
                "fn_payload": payload, "args_frame": s.args_frame,
                "return_oids": s.oids, "stream_id": s.stream_id,
                "trace": s.trace})
        try:
            r = await self.pool.call(
                lw.worker_addr, "exec_task_batch", calls=calls,
                owner_addr=self.addr, timeout=None)
        except rpc.RemoteError as e:
            # Handler-level failure from a live worker: the worker is
            # fine — return it to the idle pool (marking it dead would
            # leave it stuck in LEASED forever, leaking slots).
            await self.leases.release_slot(lw)
            for s in batch:
                self._fail_spec(s, TaskError(str(e)))
            return
        except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
            await self.leases.release_slot(lw, dead=True)
            for s in batch:
                s.attempt += 1
                if s.attempt > s.retries:
                    self._fail_spec(s, WorkerCrashedError(
                        f"task {s.task_id} failed after {s.attempt} "
                        f"attempts: {e}"))
                else:
                    st["q"].append(s)
            return
        for s in batch:
            shipped.add(s.digest)
        redo = []
        for res, s in zip(r["batch"], batch):
            if isinstance(res, dict) and res.get("need_payload"):
                redo.append(s)
            else:
                self._apply_result(s.oids, res)
                # Lineage: shm-resident results can be regenerated by
                # re-executing the producing task if their node dies
                # (reference: object_recovery_manager.h:41 +
                # task_manager lineage pinning). Only tasks with a retry
                # budget are recoverable, matching max_retries semantics.
                if s.retries > 0 and any(
                        rr.get("kind") == "shm"
                        for rr in res.get("results", [])):
                    self._register_lineage(key, s)
        if redo:
            # Worker restarted behind a reused address: re-ship payloads.
            await self._send_task_batch(key, st, lw, redo,
                                        force_payload=True)
            return
        await self.leases.release_slot(lw)

    def _apply_result(self, oids: List[ObjectID], r: dict):
        results = r["results"]  # list aligned with oids
        for oid, res in zip(oids, results):
            kind = res["kind"]
            if kind == "inline":
                self.store.resolve(oid, frame=res["frame"])
            elif kind == "shm":
                self.store.resolve(oid, shm_size=res["size"])
            elif kind == "error":
                self.store.resolve(oid, error_frame=res["frame"])

    def _fail_all(self, oids, err: Exception):
        frame = dumps_oob(err)
        for oid in oids:
            self.store.resolve(oid, error_frame=frame)

    def _fail_spec(self, spec: "_TaskSpec", err: Exception):
        """Fail a task at the spec level: regular returns get error
        frames; a streaming task's stream is error-terminated (producer
        death must surface to the consumer, not hang it)."""
        self._fail_all(spec.oids, err)
        if spec.stream_id is not None:
            self.fail_stream(spec.stream_id, err)

    # --- actors -------------------------------------------------------------

    async def create_actor(self, cls, args, kwargs, *, name=None,
                           namespace: str = "default",
                           resources: Optional[dict] = None,
                           max_restarts: int = 0,
                           max_concurrency: int = 1,
                           concurrency_groups: Optional[dict] = None,
                           pg: Optional[tuple] = None,
                           scheduling: Optional[dict] = None,
                           lifetime: Optional[str] = None,
                           runtime_env: Optional[dict] = None
                           ) -> "ActorID":
        import cloudpickle
        actor_id = ActorID.generate()
        resources = dict(resources if resources is not None else {"CPU": 1.0})
        if pg is not None:
            pg = (pg[0], pg[1] if pg[1] is not None else 0)
        creation_spec = cloudpickle.dumps({
            "cls": cls, "args": args, "kwargs": kwargs,
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups)
            if concurrency_groups else None,
            "actor_id": actor_id,
        }, protocol=5)
        r = await self.pool.call(
            self.head_addr, "register_actor", actor_id=actor_id,
            name=name, class_name=getattr(cls, "__name__", str(cls)),
            resources=resources, max_restarts=max_restarts,
            creation_spec=creation_spec, namespace=namespace,
            scheduling=scheduling, pg=pg,
            max_concurrency=max_concurrency, runtime_env=runtime_env)
        self._actor_mc[actor_id] = max_concurrency
        if not r.get("ok"):
            raise ActorError(r.get("error", "actor registration failed"))
        return actor_id

    async def resolve_actor_addr(self, actor_id: ActorID,
                                 timeout: float = 60.0) -> Tuple[str, int]:
        addr = self._actor_addr_cache.get(actor_id)
        if addr is not None:
            return addr
        r = await self.pool.call(self.head_addr, "wait_actor_alive",
                                 actor_id=actor_id, wait_timeout=timeout,
                                 timeout=timeout + 5.0)
        if r.get("state") == "ALIVE":
            addr = tuple(r["addr"])
            self._actor_addr_cache[actor_id] = addr
            self._actor_mc[actor_id] = int(r.get("max_concurrency", 1))
            return addr
        if r.get("state") == "DEAD":
            raise ActorDiedError(
                f"actor {actor_id} is dead: {r.get('reason')}")
        raise ActorError(f"actor {actor_id} not alive: {r}")

    def submit_actor_call_sync(self, actor_id: ActorID, method: str,
                               args: tuple, kwargs: dict,
                               num_returns: int = 1,
                               max_task_retries: int = 0,
                               concurrency_group: Optional[str] = None
                               ) -> List[ObjectRef]:
        """Thread-safe actor-call submission (see submit_task_sync)."""
        streaming = num_returns == "streaming"
        stream_id = None
        if streaming:
            # no re-execution for streams (see submit_task_sync)
            num_returns, max_task_retries = 0, 0
            stream_id = self.create_stream()
        oids = [ObjectID.generate() for _ in range(num_returns)]
        if oids:
            tracing.record_submit(oids[0].hex(), "actor", method)
        for oid in oids:
            self.store.create_pending(oid)
        refs = [ObjectRef(oid, self.addr) for oid in oids]
        args_frame = dumps_oob((args, kwargs))
        self._stage_put(self._enqueue_actor_call, actor_id,
                        (method, args_frame, oids, max_task_retries, 0,
                         stream_id, concurrency_group,
                         tracing.wire_context()))
        return stream_id if streaming else refs

    async def submit_actor_call(self, actor_id: ActorID, method: str,
                                args: tuple, kwargs: dict,
                                num_returns: int = 1,
                                max_task_retries: int = 0) -> List[ObjectRef]:
        return self.submit_actor_call_sync(
            actor_id, method, args, kwargs, num_returns, max_task_retries)

    # Calls to one actor flow through a per-actor pump that coalesces
    # whatever is queued into one RPC (up to ACTOR_BATCH_MAX): the per-call
    # costs — frame, event-loop task, executor hop on the worker — amortize
    # across the batch, which is where the async actor-call throughput
    # comes from. One pump per actor keeps per-caller submission order,
    # matching the reference's actor task ordering guarantee
    # (actor_task_submitter.h sequence numbers).

    def _enqueue_actor_call(self, actor_id: ActorID, call: tuple):
        from collections import deque
        q = self._actor_pending.get(actor_id)
        if q is None:
            q = self._actor_pending[actor_id] = deque()
        q.append(call)
        if not self._actor_pump_live.get(actor_id):
            self._actor_pump_live[actor_id] = True
            asyncio.ensure_future(self._actor_pump(actor_id))

    async def _actor_pump(self, actor_id: ActorID):
        """Drains the queue into batches, PIPELINED: batches are sent in
        order but replies are awaited off-pump, so a long-running call
        never blocks later submissions (max_concurrency and async actors
        depend on requests continuing to arrive)."""
        q = self._actor_pending[actor_id]
        inflight = self._actor_inflight.setdefault(actor_id, set())
        try:
            while q:
                # Establish addr+connection first so concurrent batch
                # tasks can't reorder their sends during setup.
                try:
                    addr = await self.resolve_actor_addr(actor_id)
                    await self.pool.get(addr)
                except Exception:
                    pass  # the batch task surfaces the error per-call
                mc = self._actor_mc.get(actor_id, 0)
                cap = (ACTOR_MAX_INFLIGHT_BATCHES if mc <= 1
                       else max(mc, ACTOR_MAX_INFLIGHT_BATCHES))
                while len(inflight) >= cap:
                    await asyncio.wait(
                        inflight, return_when=asyncio.FIRST_COMPLETED)
                if not q:
                    break
                # Batch ONLY when execution is serialized anyway
                # (max_concurrency == 1): a batch gets one reply, so in a
                # concurrent actor a fast call's result would wait on the
                # slowest call in its batch. Streaming calls always go
                # alone — their reply is held for the stream's whole
                # consumer-paced lifetime.
                if mc == 1 and q[0][5] is None:
                    batch = []
                    while q and len(batch) < ACTOR_BATCH_MAX \
                            and q[0][5] is None:
                        batch.append(q.popleft())
                else:
                    batch = [q.popleft()]
                fut = asyncio.ensure_future(
                    self._drive_actor_batch(actor_id, batch))
                inflight.add(fut)
                fut.add_done_callback(inflight.discard)
        finally:
            self._actor_pump_live[actor_id] = False
            if q:  # raced with an enqueue that saw the pump still live
                self._actor_pump_live[actor_id] = True
                asyncio.ensure_future(self._actor_pump(actor_id))

    async def _drive_actor_batch(self, actor_id: ActorID, batch: list):
        if len(batch) == 1:
            (method, args_frame, oids, retries, _att, stream_id,
             cgroup, trace) = batch[0]
            await self._drive_actor_call(
                actor_id, method, args_frame, oids, retries, stream_id,
                cgroup, trace)
            return
        calls = [{"method": m, "args_frame": af, "return_oids": oids,
                  "stream_id": sid, "concurrency_group": cg,
                  "trace": tr}
                 for (m, af, oids, _r, _a, sid, cg, tr) in batch]
        try:
            addr = await self.resolve_actor_addr(actor_id)
            r = await self.pool.call(
                addr, "actor_call_batch", actor_id=actor_id,
                calls=calls, owner_addr=self.addr, timeout=None)
            for res, (_m, _af, oids, _r2, _a, _s, _c, _t) in zip(
                    r["batch"], batch):
                self._apply_result(oids, res)
        except (rpc.ConnectionLost, OSError) as e:
            # Per-call retry budgets: a call with max_task_retries=0 must
            # never re-execute (it may not be idempotent); the rest go
            # back through the pump individually.
            self._actor_addr_cache.pop(actor_id, None)
            retryable = []
            for (m, af, oids, retries, attempt, sid, cg, tr) in batch:
                if attempt + 1 > retries:
                    self._fail_all(oids, ActorDiedError(
                        f"actor {actor_id} connection lost: {e}"))
                    if sid is not None:
                        self.fail_stream(sid, ActorDiedError(
                            f"actor {actor_id} connection lost: {e}"))
                else:
                    retryable.append(
                        (m, af, oids, retries, attempt + 1, sid, cg,
                         tr))
            if retryable:
                await asyncio.sleep(0.2)
                for call in retryable:
                    self._enqueue_actor_call(actor_id, call)
        except (rpc.RemoteError, ActorError) as e:
            err = (TaskError(str(e))
                   if isinstance(e, rpc.RemoteError) else e)
            for (_m, _af, oids, _r2, _a, sid, _c, _t) in batch:
                self._fail_all(oids, err)
                if sid is not None:
                    self.fail_stream(sid, err)

    async def _drive_actor_call(self, actor_id, method, args_frame, oids,
                                retries, stream_id=None,
                                concurrency_group=None, trace=None):
        attempt = 0
        while True:
            try:
                addr = await self.resolve_actor_addr(actor_id)
                r = await self.pool.call(
                    addr, "actor_call", actor_id=actor_id, method=method,
                    args_frame=args_frame, return_oids=oids,
                    owner_addr=self.addr, stream_id=stream_id,
                    concurrency_group=concurrency_group, trace=trace,
                    timeout=None)
                self._apply_result(oids, r)
                return
            except (rpc.ConnectionLost, OSError) as e:
                self._actor_addr_cache.pop(actor_id, None)
                attempt += 1
                if attempt > retries:
                    err = ActorDiedError(
                        f"actor {actor_id} connection lost: {e}")
                    self._fail_all(oids, err)
                    if stream_id is not None:
                        self.fail_stream(stream_id, err)
                    return
                await asyncio.sleep(0.2 * attempt)
            except rpc.RemoteError as e:
                self._fail_all(oids, TaskError(str(e)))
                if stream_id is not None:
                    self.fail_stream(stream_id, TaskError(str(e)))
                return
            except ActorError as e:
                self._fail_all(oids, e)
                if stream_id is not None:
                    self.fail_stream(stream_id, e)
                return

    async def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self._actor_addr_cache.pop(actor_id, None)
        await self.pool.call(self.head_addr, "kill_actor",
                             actor_id=actor_id, no_restart=no_restart)

    # --- misc ----------------------------------------------------------------

    async def free(self, refs: Sequence[ObjectRef]):
        oids = [r.oid for r in refs]
        for oid in oids:
            self.store.delete(oid)
            self._drop_lineage(oid)
        try:
            await self.pool.call(self.agent_addr, "free_objects", oids=oids)
        except Exception:
            pass
