"""Public API: init/remote/get/put/wait, actors, placement groups.

The port's copy of ``ray_tpu/api.py``: the same calls run the port's
runtime (``ray_tpu_torch.runtime``), whose processes import neither jax
nor ``ray_tpu``.

The analog of the reference's Python core API (reference:
python/ray/_private/worker.py:1406 init, :3494 remote, :2835 get,
:3018 put, :3089 wait; actor.py:1445 ActorClass; util/placement_group.py).
A driver `init()` starts an in-process head (control service) + node agent
on a dedicated IO thread and spawns worker subprocesses; `init(address=)`
joins an existing cluster. Worker processes attach through
`_attach_existing` so tasks can submit subtasks and use objects.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.config import Config, set_config
from ray_tpu_torch.runtime import rpc
from ray_tpu_torch.runtime.core import (ActorDiedError, ActorError, CoreContext,
                                  GetTimeoutError, ObjectLostError,
                                  ObjectRef, RayTpuError, TaskError,
                                  WorkerCrashedError)
from ray_tpu_torch.runtime.ids import ActorID, JobID, NodeID, PlacementGroupID

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "timeline", "ObjectRef", "ObjectRefGenerator",
    "ActorHandle",
    "placement_group", "remove_placement_group", "PlacementGroup",
    "get_async", "free", "RayTpuError", "TaskError", "ActorError",
    "ActorDiedError", "WorkerCrashedError", "ObjectLostError",
    "GetTimeoutError",
]


def _driver_pythonpath() -> str:
    """Workers can import what the driver can (the reference propagates
    driver code paths through the job config / runtime envs)."""
    import sys
    entries = [p if p else os.getcwd() for p in sys.path]
    return ":".join(dict.fromkeys(entries))


class _Global:
    def __init__(self):
        self.ctx: Optional[CoreContext] = None
        self.elt: Optional[rpc.EventLoopThread] = None
        self.head = None            # in-process ControlService (head driver)
        self.agent = None           # in-process NodeAgent
        self.owns_loop = False      # driver owns elt; workers reuse theirs
        self.job_id: Optional[JobID] = None
        self.namespace = "default"
        self.job_runtime_env = None  # init(runtime_env=...) job default
        self.ctx_loop = None        # worker mode: the process's asyncio loop

    @property
    def initialized(self):
        return self.ctx is not None


_g = _Global()


def _run(coro, timeout=None):
    """Bridge sync API -> runtime event loop."""
    if _g.elt is not None:
        return _g.elt.run(coro, timeout)
    # Worker process: the runtime loop is the process's asyncio loop.
    loop = _g.ctx_loop
    cur = None
    try:
        cur = asyncio.get_running_loop()
    except RuntimeError:
        pass
    if cur is loop:
        raise RuntimeError(
            "blocking ray_tpu_torch API called from the event loop; use the "
            "async variants (await ref / ray_tpu_torch.get_async) in async actors")
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def is_initialized() -> bool:
    return _g.initialized


def _norm_addr(address: str) -> tuple:
    """(resolved-ip, port) so 'localhost:6379' == '127.0.0.1:6379'."""
    import socket
    host, port = address.rsplit(":", 1)
    try:
        host = socket.gethostbyname(host)
    except OSError:
        pass
    return (host, port)


def _local_cli_node(address: str) -> Optional[dict]:
    """Info for a `ray-tpu start`ed node on this host joined to the
    cluster at `address`, or None. The session dir is this host's record
    of its own node processes, so a hit proves same-machine shm access."""
    import json

    from ray_tpu_torch.scripts import _node_files
    target = _norm_addr(address)
    for f in reversed(_node_files()):
        try:
            with open(f) as fh:
                info = json.load(fh)
            if (_norm_addr(info.get("address", "")) == target
                    and "agent_addr" in info):
                os.kill(info["pid"], 0)  # still running?
                return info
        except (OSError, ValueError, KeyError):
            continue
    return None


def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         labels: Optional[Dict[str, str]] = None,
         runtime_env: Optional[dict] = None,
         namespace: str = "default",
         config: Optional[Config] = None,
         system_config: Optional[dict] = None,
         ignore_reinit_error: bool = False) -> dict:
    """Start a local cluster (head + one agent + workers) or join an
    existing one via ``address="host:port"``."""
    if _g.initialized:
        if ignore_reinit_error:
            return {"address": f"{_g.ctx.head_addr[0]}:{_g.ctx.head_addr[1]}"}
        raise RuntimeError("ray_tpu_torch.init() called twice")
    cfg = config or Config.from_env()
    cfg.update(system_config)
    set_config(cfg)
    _g.namespace = namespace
    from ray_tpu_torch.runtime import runtime_env as _rt
    _g.job_runtime_env = _rt.validate(runtime_env)
    _g.elt = rpc.EventLoopThread()
    _g.owns_loop = True
    session_id = uuid.uuid4().hex[:16]

    async def _boot():
        from ray_tpu_torch.runtime.agent import NodeAgent
        from ray_tpu_torch.runtime.control import ControlService
        if address is None:
            head = ControlService(cfg)
            head_addr = await head.start(cfg.head_host, cfg.head_port)
            _g.head = head
        else:
            host, port = address.rsplit(":", 1)
            head_addr = (host, int(port))
            # verify reachable
            pool = rpc.ConnectionPool()
            await pool.call(head_addr, "ping", timeout=cfg.rpc_connect_timeout_s)
            await pool.close()
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if "CPU" not in res:
            res["CPU"] = float(os.cpu_count() or 1)
        sid = session_id
        if address is not None:
            # join: session id is cluster-wide (head KV)
            pool = rpc.ConnectionPool()
            existing = await pool.call(head_addr, "kv_get",
                                       key="__session_id")
            if existing:
                sid = existing.decode()
            await pool.close()
            # A `ray-tpu start`ed node on THIS host serving this cluster?
            # Attach to its agent (the reference driver attaches to the
            # local raylet) instead of booting a second agent that would
            # double-count the machine's resources. Only when the caller
            # didn't ask for specific node resources — those need an
            # agent of our own to advertise them.
            local = None
            if num_cpus is None and not resources and not labels:
                local = _local_cli_node(address)
            if local is not None:
                try:
                    pool = rpc.ConnectionPool()
                    try:
                        host, port = local["agent_addr"].rsplit(":", 1)
                        agent_addr = (host, int(port))
                        await pool.call(agent_addr, "ping",
                                        timeout=cfg.rpc_connect_timeout_s)
                    finally:
                        await pool.close()
                    from ray_tpu_torch.runtime.ids import NodeID
                    ctx = CoreContext(
                        head_addr, agent_addr,
                        NodeID(bytes.fromhex(local["node_id"])),
                        sid, config=cfg, is_driver=True)
                    await ctx.start()
                    job_id = JobID.generate()
                    await ctx.pool.call(head_addr, "register_job",
                                        job_id=job_id,
                                        metadata={"driver_pid": os.getpid()})
                    _g.job_id = job_id
                    return ctx
                except Exception:
                    # Stale session record (killed node, recycled pid):
                    # fall through to booting our own agent, the
                    # pre-attach behavior.
                    pass
        agent = NodeAgent(head_addr, resources=res, labels=labels,
                          config=cfg, session_id=sid,
                          env_extra={"PYTHONPATH": _driver_pythonpath()})
        agent_addr = await agent.start()
        _g.agent = agent
        if address is None:
            await agent.pool.call(head_addr, "kv_put", key="__session_id",
                                  value=sid.encode())
        ctx = CoreContext(head_addr, agent_addr, agent.node_id, sid,
                          config=cfg, is_driver=True)
        await ctx.start()
        job_id = JobID.generate()
        await ctx.pool.call(head_addr, "register_job", job_id=job_id,
                            metadata={"driver_pid": os.getpid()})
        _g.job_id = job_id
        return ctx

    _g.ctx = _g.elt.run(_boot(), timeout=120)
    atexit.register(shutdown)
    return {"address": f"{_g.ctx.head_addr[0]}:{_g.ctx.head_addr[1]}",
            "session_id": _g.ctx.session_id, "node_id": _g.ctx.node_id}


def _attach_existing(ctx: CoreContext) -> None:
    """Called inside worker processes: adopt the worker's CoreContext and
    its running loop as this process's API backend."""
    _g.ctx = ctx
    _g.elt = None
    _g.ctx_loop = asyncio.get_running_loop()


def shutdown() -> None:
    if not _g.initialized:
        return
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass
    ctx, elt = _g.ctx, _g.elt
    _g.ctx = None
    if elt is None:
        return
    try:
        if _g.job_id is not None:
            elt.run(ctx.pool.call(ctx.head_addr, "finish_job",
                                  job_id=_g.job_id), timeout=5)
    except Exception:
        pass
    try:
        elt.run(ctx.stop(), timeout=10)
    except Exception:
        pass
    for svc in (_g.agent, _g.head):
        if svc is not None:
            try:
                # the agent's stop returns once its workers have exited
                # (terminated, then killed after their grace: well
                # inside this bound)
                elt.run(svc.stop(), timeout=30)
            except Exception:
                pass
    _g.agent = _g.head = None
    elt.stop()
    _g.elt = None


def _require_init():
    if not _g.initialized:
        init()
    return _g.ctx


# --- objects ----------------------------------------------------------------

def put(value: Any) -> ObjectRef:
    ctx = _require_init()
    from ray_tpu_torch.runtime.ids import ObjectID
    from ray_tpu_torch.runtime.serialization import serialize
    ser = serialize(value)
    if ser.total_bytes <= ctx.config.inline_object_max_bytes:
        # Inline object: resolve in the caller's thread; nobody can be
        # awaiting a ref that hasn't been returned yet, so no loop hop.
        oid = ObjectID.generate()
        ctx.store.resolve(oid, frame=ser.to_bytes())
        return ObjectRef(oid, ctx.addr, ser.total_bytes)
    return _run(ctx.put_serialized(ser))


def get(refs, timeout: Optional[float] = None):
    ctx = _require_init()
    single = isinstance(refs, ObjectRef)
    # Materialize once: generator inputs must not be consumed twice.
    ref_list = [refs] if single else list(refs)
    if not ref_list:
        return []
    # Fast path: every ref already resolved inline in this process — load
    # on the caller's thread, no event-loop round trip.
    values = []
    for r in ref_list:
        hit, v = ctx.try_get_local(r)
        if not hit:
            break
        values.append(v)
    else:
        return values[0] if single else values
    wait_budget = None if timeout is None else timeout + 10
    # Capture task-context HERE: run_coroutine_threadsafe runs the
    # coroutine in a fresh context on the loop, so the executing-task
    # contextvar (tracing.current_span) is only visible on this thread.
    from ray_tpu_torch.util import tracing
    in_task = not ctx.is_driver and bool(tracing.current_span.get())
    return _run(ctx.get(refs if single else ref_list, timeout,
                        in_task=in_task),
                timeout=wait_budget)


async def get_async(refs, timeout: Optional[float] = None):
    return await _g.ctx.get(refs, timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    ctx = _require_init()
    if num_returns > len(refs):
        raise ValueError("num_returns > len(refs)")
    from ray_tpu_torch.util import tracing
    in_task = not ctx.is_driver and bool(tracing.current_span.get())
    return _run(ctx.wait(refs, num_returns, timeout, in_task=in_task))


def free(refs: Sequence[ObjectRef]) -> None:
    ctx = _require_init()
    _run(ctx.free(list(refs)))


class ObjectRefGenerator:
    """Consumer side of a ``num_returns="streaming"`` call (reference:
    python/ray/_private/object_ref_generator.py:32 ObjectRefGenerator).

    Iterating (sync ``for`` or ``async for``) yields ObjectRefs in the
    order the producer yielded values, as they are produced — each ref
    is already resolved in this process, so ``ray_tpu_torch.get(ref)`` on it
    is a local memory-store hit. A producer error terminates the stream
    by raising AFTER all previously-yielded items are delivered.

    Consumption is owner-process-only: the generator is not picklable
    (pass the deployment/actor handle and stream there instead)."""

    def __init__(self, stream_id):
        self._stream_id = stream_id
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        # Only genuine termination marks the generator done: a transient
        # failure (timeout, wrong-thread RuntimeError) must leave close()
        # able to release the stream. Producer errors delete the owner
        # state themselves, so close() after them is already a no-op.
        try:
            return _run(_g.ctx.stream_next(self._stream_id))
        except StopAsyncIteration:
            self._done = True
            raise StopIteration

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        try:
            return await _g.ctx.stream_next(self._stream_id)
        except StopAsyncIteration:
            self._done = True
            raise

    def next_ready(self, timeout: float) -> ObjectRef:
        """__next__ with a timeout (raises GetTimeoutError)."""
        try:
            return _run(_g.ctx.stream_next(self._stream_id, timeout))
        except StopAsyncIteration:
            self._done = True
            raise StopIteration

    def close(self):
        """Abandon the stream: the producer observes the closure on its
        next push and stops the generator."""
        if self._done:
            return
        self._done = True
        ctx, loop = _g.ctx, (_g.elt.loop if _g.elt else _g.ctx_loop)
        if ctx is not None and loop is not None:
            try:
                loop.call_soon_threadsafe(ctx.close_stream,
                                          self._stream_id)
            except RuntimeError:
                pass  # loop already gone (shutdown)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is not picklable: streams are consumed "
            "in the owner process")


# --- tasks ------------------------------------------------------------------

def _resolve_runtime_env(opts: dict):
    """Task/actor env over the inherited default (the reference layers
    job -> parent -> child the same way). Validation does filesystem
    checks and working_dir/py_modules paths are PACKAGED into the
    cluster KV here (content-addressed pkg:// uris — worker nodes don't
    share the driver's filesystem), so callers cache the result per
    RemoteFunction/ActorClass instead of re-resolving on the hot
    path."""
    from ray_tpu_torch.runtime import runtime_env as rt
    override = rt.validate(opts.get("runtime_env"))
    env = rt.merge(_inherited_runtime_env(), override)
    if env and (env.get("working_dir") or env.get("py_modules")):
        ctx = _require_init()

        def kv_put(key, value):
            _run(ctx.pool.call(ctx.head_addr, "kv_put", key=key,
                               value=value, overwrite=False))

        def kv_has(key):
            return bool(_run(ctx.pool.call(ctx.head_addr, "kv_keys",
                                           prefix=key)))

        env = rt.publish_packages(env, kv_put, kv_has)
    return env


def _inherited_runtime_env():
    """Driver: init(runtime_env=...). Worker: the env it was spawned
    with (RAY_TPU_RT_ENV), so nested tasks inherit the parent's env."""
    if _g.job_runtime_env is not None:
        return _g.job_runtime_env
    blob = os.environ.get("RAY_TPU_RT_ENV")
    if blob:
        import json
        _g.job_runtime_env = json.loads(blob)
        return _g.job_runtime_env
    return None


def _norm_resources(opts: dict) -> dict:
    res = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_tpus") is not None:
        res["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus") is not None:
        res["GPU"] = float(opts["num_gpus"])
    if "CPU" not in res:
        res["CPU"] = 1.0
    return res


def _pg_tuple(opts: dict) -> Optional[tuple]:
    pg = opts.get("placement_group")
    if pg is None:
        return None
    idx = opts.get("placement_group_bundle_index", 0)
    pg_id = pg.id if isinstance(pg, PlacementGroup) else pg
    return (pg_id, idx)


class RemoteFunction:
    def __init__(self, fn: Callable, **default_opts):
        self._fn = fn
        self._opts = default_opts
        self._rt_env, self._rt_resolved = None, False
        self.__name__ = getattr(fn, "__name__", "remote_fn")

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(opts)
        return RemoteFunction(self._fn, **merged)

    def remote(self, *args, **kwargs):
        ctx = _require_init()
        opts = self._opts
        num_returns = opts.get("num_returns", 1)
        refs = ctx.submit_task_sync(
            self._fn, args, kwargs,
            num_returns=num_returns,
            resources=_norm_resources(opts),
            max_retries=opts.get("max_retries"),
            pg=_pg_tuple(opts),
            policy=opts.get("scheduling_strategy", "default"),
            runtime_env=self._cached_runtime_env())
        if num_returns == "streaming":
            return ObjectRefGenerator(refs)  # refs IS the stream id
        return refs[0] if num_returns == 1 else refs

    def _cached_runtime_env(self):
        # validate() hits the filesystem; resolve once per instance,
        # not per .remote() (hot path). A plain flag, not an identity
        # sentinel — these objects cross pickling into workers.
        if not self._rt_resolved:
            self._rt_env = _resolve_runtime_env(self._opts)
            self._rt_resolved = True
        return self._rt_env

    def __call__(self, *a, **kw):
        raise TypeError(
            f"remote function {self.__name__} must be invoked with "
            f"`.remote()` (direct call would run locally)")


# --- actors -----------------------------------------------------------------

class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, **opts):
        self._handle = handle
        self._name = name
        self._opts = opts

    def options(self, **opts):
        merged = dict(self._opts)
        merged.update(opts)
        return ActorMethod(self._handle, self._name, **merged)

    def remote(self, *args, **kwargs):
        ctx = _require_init()
        num_returns = self._opts.get("num_returns", 1)
        refs = ctx.submit_actor_call_sync(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=num_returns,
            max_task_retries=self._opts.get(
                "max_task_retries", self._handle._max_task_retries),
            concurrency_group=self._opts.get("concurrency_group"))
        if num_returns == "streaming":
            return ObjectRefGenerator(refs)  # refs IS the stream id
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args):
        """Add this actor method as a node in a (to-be-compiled) DAG;
        see ray_tpu_torch.dag (reference: dag/class_node.py bind API)."""
        from ray_tpu_torch.dag import MethodNode
        return MethodNode(self._handle, self._name, args)


class ActorHandle:
    def __init__(self, actor_id: ActorID, max_task_retries: int = 0):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._max_task_retries))

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id


class ActorClass:
    def __init__(self, cls, **default_opts):
        self._cls = cls
        self._opts = default_opts
        self._rt_env, self._rt_resolved = None, False
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(opts)
        return ActorClass(self._cls, **merged)

    def _cached_runtime_env(self):
        if not self._rt_resolved:
            self._rt_env = _resolve_runtime_env(self._opts)
            self._rt_resolved = True
        return self._rt_env

    def remote(self, *args, **kwargs) -> ActorHandle:
        ctx = _require_init()
        opts = self._opts
        retries = opts.get("max_task_retries", 0)
        if opts.get("get_if_exists") and opts.get("name"):
            try:
                h = get_actor(opts["name"], opts.get("namespace"))
                h._max_task_retries = retries
                return h
            except ValueError:
                pass  # not there yet — create it below
        resources = dict(opts.get("resources") or {})
        if opts.get("num_cpus") is not None:
            resources["CPU"] = float(opts["num_cpus"])
        if opts.get("num_tpus") is not None:
            resources["TPU"] = float(opts["num_tpus"])
        if opts.get("num_gpus") is not None:
            resources["GPU"] = float(opts["num_gpus"])
        # an actor that holds an accelerator (a TPU host, or a card: a
        # TorchTrainer worker with use_gpu) takes no default CPU, so it
        # fits a placement bundle of just that accelerator
        if not {"CPU", "TPU", "GPU"} & set(resources):
            resources["CPU"] = 1.0
        scheduling = {}
        if opts.get("labels"):
            scheduling["labels"] = opts["labels"]
        groups = opts.get("concurrency_groups")
        mc = opts.get("max_concurrency", 1)
        if groups and "max_concurrency" not in opts:
            # declaring groups implies a concurrent actor: the caller
            # pipeline must admit at least as many in-flight calls as
            # the groups can execute (reference: concurrency_groups
            # actors are concurrent by construction)
            mc = max(1, sum(int(v) for v in groups.values()))
        try:
            actor_id = _run(ctx.create_actor(
                self._cls, args, kwargs,
                name=opts.get("name"),
                namespace=opts.get("namespace", _g.namespace),
                resources=resources,
                max_restarts=opts.get("max_restarts", 0),
                max_concurrency=mc,
                concurrency_groups=groups,
                pg=_pg_tuple(opts),
                scheduling=scheduling or None,
                lifetime=opts.get("lifetime"),
                runtime_env=self._cached_runtime_env()))
        except Exception as e:
            # get_if_exists race: another creator won between our lookup
            # miss and this create — adopt theirs.
            if (opts.get("get_if_exists") and opts.get("name")
                    and "taken" in str(e)):
                h = get_actor(opts["name"], opts.get("namespace"))
                h._max_task_retries = retries
                return h
            raise
        return ActorHandle(actor_id, max_task_retries=retries)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"actor class {self.__name__} must be instantiated with "
            f"`.remote()`")


def remote(*args, **options):
    """``@remote`` / ``@remote(num_cpus=2, ...)`` for functions and
    classes (reference: worker.py:3494)."""
    def wrap(obj):
        if isinstance(obj, type):
            return ActorClass(obj, **options)
        return RemoteFunction(obj, **options)
    if len(args) == 1 and not options and callable(args[0]):
        return wrap(args[0])
    assert not args, "use @remote or @remote(**options)"
    return wrap


def method(**opts):
    """Decorator kept for API parity; options are applied at call sites via
    ``handle.method.options(...)`` (reference: actor.py method decorator)."""
    def wrap(fn):
        fn._method_opts = opts
        return fn
    return wrap


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    ctx = _require_init()
    info = _run(ctx.pool.call(ctx.head_addr, "get_named_actor",
                              name=name,
                              namespace=namespace or _g.namespace))
    if info is None or info.get("state") == "DEAD":
        raise ValueError(f"no live actor named {name!r}")
    return ActorHandle(info["actor_id"])


def kill(target, *, no_restart: bool = True) -> None:
    ctx = _require_init()
    if isinstance(target, ActorHandle):
        _run(ctx.kill_actor(target._actor_id, no_restart=no_restart))
    else:
        raise TypeError("kill() takes an ActorHandle")


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Best-effort cancel of a pending task (running tasks are not
    interrupted — cooperative only)."""
    # v1: cancellation marks are worker-side; a task not yet started on a
    # worker will fail with 'task cancelled'.
    ctx = _require_init()
    e = ctx.store.get_entry(ref.oid)
    if e is not None and e.status == "pending":
        from ray_tpu_torch.runtime.serialization import dumps_oob
        ctx.store.resolve(
            ref.oid, error_frame=dumps_oob(TaskError("task cancelled")))


# --- cluster info -----------------------------------------------------------

def nodes() -> List[dict]:
    ctx = _require_init()
    return _run(ctx.pool.call(ctx.head_addr, "get_nodes"))


def cluster_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if not n["alive"]:
            continue
        for k, v in n["resources_total"].items():
            out[k] = out.get(k, 0) + v
    return out


def available_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if not n["alive"]:
            continue
        for k, v in n["resources_available"].items():
            out[k] = out.get(k, 0) + v
    return out


def timeline(all_nodes: bool = False,
             chrome_path: Optional[str] = None,
             trace_id: Optional[str] = None) -> List[dict]:
    """Task/actor event timeline (reference: _private/state.py:1010).

    ``all_nodes=True`` collects every node's worker span buffers through
    the control service (submit edges + exec spans from
    util/tracing.py, plus collective ring spans from dag/ring.py and
    request spans from the serve path) and the head's per-node
    clock-offset estimates; ``chrome_path=`` additionally writes a
    chrome://tracing / Perfetto JSON file — with cross-node timestamps
    corrected by the offsets — and the returned records are the
    chrome-trace events. ``trace_id=`` narrows either form to ONE
    request trace (its spans, exec spans of its nested tasks, batch
    spans linked to it, and — for train-step traces — its steps'
    collective rounds)."""
    from ray_tpu_torch.util import events
    offsets = None
    if all_nodes:
        ctx = _require_init()
        r = _run(ctx.pool.call(ctx.head_addr, "collect_timeline",
                               timeout=45.0))
        evs = list(r.get("events", []))
        offsets = r.get("clock_offsets")
        if _g.agent is None:
            # driver attached to an externally-started node: its local
            # buffer isn't behind any agent — append it. (With an
            # in-process agent the buffer is process-global and
            # node_timeline already returned it, tagged.)
            evs += events.dump()
    else:
        evs = events.dump()
    from ray_tpu_torch.util import tracing
    if chrome_path is not None:
        return tracing.to_chrome(evs, chrome_path,
                                 clock_offsets=offsets,
                                 trace_id=trace_id)
    if trace_id is not None:
        evs = tracing.filter_trace(evs, trace_id)
    return evs


# --- placement groups --------------------------------------------------------

@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str

    def ready(self, timeout: float = 60.0) -> bool:
        ctx = _require_init()
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = _run(ctx.pool.call(ctx.head_addr, "get_pg",
                                      pg_id=self.id))
            if info and info["state"] == "CREATED":
                return True
            if info and info["state"] in ("INFEASIBLE", "REMOVED"):
                return False
            import time as _t
            _t.sleep(0.05)
        return False

    def bundle_specs(self):
        return self.bundles


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: Optional[str] = None) -> PlacementGroup:
    """Gang-reserve resource bundles (reference: util/placement_group.py:22;
    2-phase protocol in control.py create_pg)."""
    ctx = _require_init()
    pg_id = PlacementGroupID.generate()
    r = _run(ctx.pool.call(ctx.head_addr, "create_pg", pg_id=pg_id,
                           bundles=bundles, strategy=strategy, name=name,
                           timeout=120.0))
    if not r.get("ok"):
        raise RayTpuError(r.get("error", "placement group failed"))
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    ctx = _require_init()
    _run(ctx.pool.call(ctx.head_addr, "remove_pg", pg_id=pg.id))
