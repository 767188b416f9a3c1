"""Worker process: executes tasks and hosts actors.

The worker-side of the reference's core worker (reference:
core_worker/task_execution/task_receiver.h, concurrency_group_manager.h;
python callback at python/ray/_raylet.pyx:2061 execute_task_with_
cancellation_handler). A worker embeds the same CoreContext as the driver
(it can submit subtasks, put/get objects) and adds execution handlers:
``exec_task`` for stateless tasks, ``host_actor``/``actor_call`` for actors
with per-actor ordered execution (or a thread pool when max_concurrency>1),
and async-actor support (coroutine methods run on the event loop).

Results follow the reference's small/large split: small results ride the
RPC reply inline into the owner's memory store; large results are written
to the node's shared-memory store and fetched by location.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import inspect
import os
import pickle
import sys
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.config import Config
from ray_tpu_torch.runtime.core import CoreContext, ObjectRef, TaskError
from ray_tpu_torch.runtime.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.runtime.serialization import dumps_oob, loads_oob, serialize
from ray_tpu_torch.util import tracing


def _task_error_frame(exc: BaseException) -> bytes:
    """Serialized TaskError carrying the remote traceback (cause dropped
    when it doesn't pickle)."""
    import traceback
    tb = "".join(traceback.format_exception(exc))
    try:
        return dumps_oob(TaskError(tb, cause=exc))
    except Exception:
        return dumps_oob(TaskError(tb))


class _BatchError:
    """Marks a per-call failure inside a batch executed on the worker
    thread (exceptions can't be raised per-slot there)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _HostedActor:
    def __init__(self, instance, max_concurrency: int,
                 concurrency_groups: Optional[dict] = None):
        self.instance = instance
        self.max_concurrency = max_concurrency
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_concurrency)
        # Named concurrency groups (reference: core_worker/
        # task_execution/concurrency_group_manager.h + the
        # concurrency_groups actor option): each named group bounds its
        # methods with its own semaphore + thread pool, so e.g. an "io"
        # group keeps serving health checks while "compute" is
        # saturated. Declaring groups implies a concurrent actor — the
        # serialized-execution lock applies only to group-less actors
        # with max_concurrency == 1.
        self.groups: Dict[str, tuple] = {}
        if concurrency_groups:
            for name, n in concurrency_groups.items():
                n = max(1, int(n))
                self.groups[name] = (
                    asyncio.Semaphore(n),
                    concurrent.futures.ThreadPoolExecutor(max_workers=n))
            self.groups.setdefault("_default", (
                asyncio.Semaphore(max_concurrency), self.executor))
        self.lock = (asyncio.Lock()
                     if max_concurrency == 1 and not self.groups else None)


class WorkerExecutor:
    def __init__(self, ctx: CoreContext):
        self.ctx = ctx
        self.actors: Dict[ActorID, _HostedActor] = {}
        self.task_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
        self.running: Dict[TaskID, asyncio.Future] = {}
        self.cancelled: set = set()
        ctx.server.add_handler("exec_task", self.exec_task)
        ctx.server.add_handler("exec_task_batch", self.exec_task_batch)
        ctx.server.add_handler("host_actor", self.host_actor)
        ctx.server.add_handler("actor_call", self.actor_call)
        ctx.server.add_handler("actor_call_batch", self.actor_call_batch)
        ctx.server.add_handler("cancel_task", self.cancel_task)
        ctx.server.add_handler("shutdown_worker", self.shutdown_worker)
        ctx.server.add_handler("dump_stacks", self.dump_stacks)
        ctx.server.add_handler("profile", self.profile)
        ctx.server.add_handler("forensics_dump", self.forensics_dump)

    # --- live profiling (util/profiling.py over the control plane) ----

    async def dump_stacks(self):
        """One-shot thread dump of this worker process (the driver
        reaches it via the head's profile_target; reference capability:
        py-spy dump through dashboard/modules/reporter/)."""
        from ray_tpu_torch.util import profiling
        return {"pid": os.getpid(), "stacks": profiling.dump_stacks()}

    async def forensics_dump(self):
        """This process's postmortem contribution (util/forensics.py):
        collective ledger + stacks + goodput rows + HBM snapshot +
        registered engine state. Served off the control-plane loop, so
        it answers while hosted actors are wedged in a hung
        collective — the property the autopsy fan-out relies on."""
        from ray_tpu_torch.util import forensics
        return forensics.local_dump()

    async def profile(self, duration_s: float = 2.0, hz: int = 100):
        """Sample this process's stacks for duration_s at hz; returns
        folded stacks. Runs on an executor thread so the event loop
        (and the actors it hosts) keeps serving while being observed."""
        from ray_tpu_torch.util import profiling
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(
            None, lambda: profiling.profile(duration_s, hz))
        return {"pid": os.getpid(), **res}

    # --- common result packaging -----------------------------------------

    async def _package(self, value, oids: List[ObjectID]) -> dict:
        if len(oids) > 1:
            if not isinstance(value, (tuple, list)) or len(value) != len(oids):
                err = TaskError(
                    f"task declared num_returns={len(oids)} but returned "
                    f"{type(value).__name__}")
                frame = dumps_oob(err)
                return {"results": [
                    {"kind": "error", "frame": frame} for _ in oids]}
            values = list(value)
        else:
            values = [value]
        out = []
        for oid, v in zip(oids, values):
            ser = serialize(v)
            if ser.total_bytes <= self.ctx.config.inline_object_max_bytes:
                out.append({"kind": "inline", "frame": ser.to_bytes()})
            else:
                size = await self.ctx.put_shm(oid, ser)
                out.append({"kind": "shm", "size": size})
        return {"results": out}

    # --- streaming generator returns -----------------------------------

    async def _drive_stream(self, fn, args, kwargs, stream_id,
                            owner_addr, pool=None) -> dict:
        """Execute a generator task/method and push each yielded object
        to the owner as it is produced (reference: the task_manager
        HandleReportGeneratorItemReturns protocol, collapsed onto the
        existing object plane: small items ride the stream_item RPC
        inline, large ones go through the node's shm store first).

        Pushes are pipelined up to `stream_producer_inflight` unacked
        RPCs; the owner delays acks while its unconsumed window is full,
        so that bound IS the producer-side backpressure. A {"closed"}
        ack (consumer abandoned the stream) stops the generator."""
        from ray_tpu_torch.runtime.serialization import serialize as _ser
        owner_addr = tuple(owner_addr)
        max_inflight = self.ctx.config.stream_producer_inflight
        inflight: set = set()
        closed = False

        async def push(index, item):
            oid = ObjectID.generate()
            ser = _ser(item)
            if ser.total_bytes <= self.ctx.config.inline_object_max_bytes:
                r = await self.ctx.pool.call(
                    owner_addr, "stream_item", stream_id=stream_id,
                    index=index, oid=oid, frame=ser.to_bytes(),
                    timeout=None)
            else:
                size = await self.ctx.put_shm(oid, ser)
                r = await self.ctx.pool.call(
                    owner_addr, "stream_item", stream_id=stream_id,
                    index=index, oid=oid, shm_size=size, timeout=None)
            return bool(r.get("closed"))

        push_err = None

        async def admit():
            """Cap unacked pushes; a closed-stream ack stops production
            cleanly, a failed push (lost item) stops it and is re-raised
            after the loop so the stream error-terminates instead of
            silently truncating."""
            nonlocal closed, push_err
            while len(inflight) >= max_inflight:
                done, _ = await asyncio.wait(
                    inflight, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    inflight.discard(t)
                    try:
                        if t.result():
                            closed = True
                    except Exception as e:
                        closed = True
                        if push_err is None:
                            push_err = e

        gen = None
        try:
            if inspect.isasyncgenfunction(fn):
                gen = fn(*args, **kwargs)
            elif inspect.isgeneratorfunction(fn):
                # user code runs off-loop: one executor hop per item
                from ray_tpu_torch.util.aio import drive_sync_gen
                gen = drive_sync_gen(fn(*args, **kwargs),
                                     pool or self.task_pool)
            elif inspect.iscoroutinefunction(fn):
                raise TaskError(
                    "num_returns='streaming' requires a generator "
                    "function (got a coroutine function; make it an "
                    "async generator with `yield`)")
            else:
                raise TaskError(
                    "num_returns='streaming' requires a (sync or "
                    f"async) generator function, got "
                    f"{getattr(fn, '__name__', fn)!r}")
            index = 0
            async for item in gen:
                await admit()
                if closed:
                    break
                inflight.add(asyncio.ensure_future(push(index, item)))
                index += 1
            if push_err is not None:
                raise push_err
            if inflight:
                acks = await asyncio.gather(*inflight,
                                            return_exceptions=True)
                for a in acks:
                    if isinstance(a, BaseException):
                        # A lost push would silently truncate the stream
                        # (the owner delivers in index order): surface it
                        # so the stream terminates with an error instead.
                        raise a
                    if a:
                        closed = True
            if not closed:
                await self.ctx.pool.call(
                    owner_addr, "stream_end", stream_id=stream_id,
                    timeout=None)
        except BaseException as e:  # noqa: BLE001 — error-terminate
            if inflight:
                await asyncio.gather(*inflight, return_exceptions=True)
            try:
                await self.ctx.pool.call(
                    owner_addr, "stream_end", stream_id=stream_id,
                    error_frame=_task_error_frame(e), timeout=None)
            except Exception:
                pass  # owner gone: nobody left to tell
        finally:
            if closed and gen is not None:
                # consumer walked away mid-stream: stop the generator so
                # its finally blocks run now, not at GC time
                try:
                    if hasattr(gen, "aclose"):
                        await gen.aclose()
                    else:
                        gen.close()
                except Exception:
                    pass
        return {"results": []}

    async def _fail_stream_remote(self, stream_id, owner_addr,
                                  exc: BaseException):
        """Error-terminate a stream whose drive never started."""
        try:
            await self.ctx.pool.call(
                tuple(owner_addr), "stream_end", stream_id=stream_id,
                error_frame=_task_error_frame(exc), timeout=None)
        except Exception:
            pass  # owner gone

    def _package_error(self, exc: BaseException, oids) -> dict:
        frame = _task_error_frame(exc)
        return {"results": [{"kind": "error", "frame": frame}
                            for _ in oids]}

    async def _resolve_args(self, args_frame: bytes):
        args, kwargs = loads_oob(args_frame)
        # Top-level ObjectRef args are resolved to values (reference
        # semantics: nested refs are passed through untouched).
        async def rv(v):
            return await self.ctx.get(v) if isinstance(v, ObjectRef) else v
        args = [await rv(a) for a in args]
        kwargs = {k: await rv(v) for k, v in kwargs.items()}
        return args, kwargs

    async def _run_callable(self, fn, args, kwargs, pool=None):
        if inspect.iscoroutinefunction(fn):
            return await fn(*args, **kwargs)
        loop = asyncio.get_running_loop()
        # copy_context: the tracing current_span contextvar must follow
        # user code into the executor thread so nested submissions from
        # sync tasks record their parent edge (util/tracing.py)
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(
            pool or self.task_pool, lambda: ctx.run(fn, *args, **kwargs))

    # --- stateless tasks ----------------------------------------------------

    async def exec_task(self, task_id: TaskID, fn_digest: bytes,
                        fn_payload: Optional[bytes], args_frame: bytes,
                        return_oids: List[ObjectID], owner_addr,
                        stream_id=None, trace=None):
        if task_id in self.cancelled:
            self.cancelled.discard(task_id)
            e0 = TaskError("task cancelled")
            if stream_id is not None:
                await self._fail_stream_remote(stream_id, owner_addr, e0)
                return {"results": []}
            return self._package_error(e0, return_oids)
        fn = self.ctx.fn_cache.resolve(fn_digest, fn_payload)
        t0, err = time.time(), False
        tok = tracing.current_span.set(task_id.hex())
        # bind the submitter's request trace so this task's exec span —
        # and anything the task submits in turn — joins the trace
        tctx = tracing.parse_traceparent(trace)
        rtok = tracing.set_request_context(tctx)
        try:
            args, kwargs = await self._resolve_args(args_frame)
            if stream_id is not None:
                return await self._drive_stream(
                    fn, args, kwargs, stream_id, owner_addr)
            value = await self._run_callable(fn, args, kwargs)
            return await self._package(value, return_oids)
        except BaseException as e:  # noqa: BLE001
            err = True
            if stream_id is not None:
                # pre-drive failure (arg resolution): the consumer is
                # parked on the stream, not on a return ref
                await self._fail_stream_remote(stream_id, owner_addr, e)
                return {"results": []}
            return self._package_error(e, return_oids)
        finally:
            tracing.reset_request_context(rtok)
            tracing.current_span.reset(tok)
            tracing.record_exec(task_id.hex(), "task",
                                getattr(fn, "__name__", "?"),
                                t0, time.time(), error=err,
                                trace=tctx.trace_id if tctx else "")

    async def exec_task_batch(self, calls: list, owner_addr):
        """Coalesced stateless tasks (see core.py _task_pump). Sync
        functions in the batch share ONE executor hop; async ones run on
        the loop. Unknown digests come back as need_payload slots so the
        owner can re-ship the function (worker restarts behind a reused
        address)."""
        out = [None] * len(calls)
        sync_items = []
        for i, c in enumerate(calls):
            if c["task_id"] in self.cancelled:
                self.cancelled.discard(c["task_id"])
                e0 = TaskError("task cancelled")
                if c.get("stream_id") is not None:
                    await self._fail_stream_remote(
                        c["stream_id"], owner_addr, e0)
                    out[i] = {"results": []}
                else:
                    out[i] = self._package_error(e0, c["return_oids"])
                continue
            try:
                fn = self.ctx.fn_cache.resolve(
                    c["fn_digest"], c.get("fn_payload"))
            except KeyError:
                out[i] = {"need_payload": True}
                continue
            try:
                args, kwargs = await self._resolve_args(c["args_frame"])
            except BaseException as e:  # noqa: BLE001
                if c.get("stream_id") is not None:
                    # consumer waits on the stream, not a return ref
                    await self._fail_stream_remote(
                        c["stream_id"], owner_addr, e)
                    out[i] = {"results": []}
                else:
                    out[i] = self._package_error(e, c["return_oids"])
                continue
            if c.get("stream_id") is not None:
                span = c["task_id"].hex()
                t0 = time.time()
                tok = tracing.current_span.set(span)
                tctx = tracing.parse_traceparent(c.get("trace"))
                rtok = tracing.set_request_context(tctx)
                try:
                    out[i] = await self._drive_stream(
                        fn, args, kwargs, c["stream_id"], owner_addr)
                finally:
                    tracing.reset_request_context(rtok)
                    tracing.current_span.reset(tok)
                    tracing.record_exec(
                        span, "task", getattr(fn, "__name__", "?"),
                        t0, time.time(),
                        trace=tctx.trace_id if tctx else "")
                continue
            if inspect.iscoroutinefunction(fn):
                span = c["task_id"].hex()
                t0, failed = time.time(), False
                tok = tracing.current_span.set(span)
                tctx = tracing.parse_traceparent(c.get("trace"))
                rtok = tracing.set_request_context(tctx)
                try:
                    value = await fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001
                    failed = True
                    out[i] = self._package_error(e, c["return_oids"])
                else:
                    out[i] = await self._package_slot(
                        value, c["return_oids"])
                finally:
                    tracing.reset_request_context(rtok)
                    tracing.current_span.reset(tok)
                    tracing.record_exec(
                        span, "task", getattr(fn, "__name__", "?"),
                        t0, time.time(), error=failed,
                        trace=tctx.trace_id if tctx else "")
            else:
                sync_items.append((i, fn, args, kwargs,
                                   c["task_id"].hex(),
                                   c.get("trace")))
        if sync_items:
            loop = asyncio.get_running_loop()
            vals = await loop.run_in_executor(
                self.task_pool, self._run_task_batch_sync, sync_items)
            for (i, _fn, _a, _k, _s, _t), v in zip(sync_items, vals):
                c = calls[i]
                out[i] = await self._package_slot(v, c["return_oids"])
        return {"batch": out}

    async def _package_slot(self, v, return_oids):
        """Package one batched call's result; a per-call failure (e.g. an
        unpicklable return) must not poison the rest of the batch."""
        if isinstance(v, _BatchError):
            return self._package_error(v.exc, return_oids)
        try:
            return await self._package(v, return_oids)
        except BaseException as e:  # noqa: BLE001
            return self._package_error(e, return_oids)

    @staticmethod
    def _run_task_batch_sync(items):
        vals = []
        for _i, fn, args, kwargs, span, trace in items:
            tok = tracing.current_span.set(span)
            tctx = tracing.parse_traceparent(trace)
            rtok = tracing.set_request_context(tctx)
            t0, failed = time.time(), False
            try:
                vals.append(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — per-task error
                failed = True
                vals.append(_BatchError(e))
            finally:
                tracing.reset_request_context(rtok)
                tracing.current_span.reset(tok)
                tracing.record_exec(span, "task",
                                    getattr(fn, "__name__", "?"),
                                    t0, time.time(), batch=len(items),
                                    error=failed,
                                    trace=tctx.trace_id if tctx else "")
        return vals

    async def cancel_task(self, task_id: TaskID):
        self.cancelled.add(task_id)
        return {"ok": True}

    async def flush_events(self) -> int:
        """Ship this worker's span buffer to the agent (the reference
        pushes worker task events to the GCS the same way,
        task_event_buffer.h). Runs every second and at shutdown so spans
        survive the worker process."""
        from ray_tpu_torch.util import events
        evs = events.drain()
        if not evs:
            return 0
        nid = self.ctx.node_id.hex()
        try:
            await self.ctx.pool.call(
                self.ctx.agent_addr, "report_events",
                events=[{**e, "node": nid} for e in evs], timeout=10.0)
        except Exception:
            # transient agent hiccup: put the batch back so the next
            # tick retries instead of dropping this window's spans
            events.requeue(evs)
            return 0
        return len(evs)

    async def _event_flush_loop(self):
        import asyncio as _a
        while True:
            await _a.sleep(1.0)
            await self.flush_events()

    # --- actors -------------------------------------------------------------

    async def host_actor(self, actor_id: ActorID, creation_spec: bytes):
        try:
            spec = pickle.loads(creation_spec)
            cls = spec["cls"]
            args, kwargs = spec["args"], spec["kwargs"]
            instance = await self._run_callable(
                cls, list(args), dict(kwargs))
            try:
                # actors can learn their own id (self-kill, logging) —
                # the reference exposes this via get_runtime_context()
                instance._ray_tpu_actor_id = actor_id
            except (AttributeError, TypeError):
                pass  # __slots__ etc.
            self.actors[actor_id] = _HostedActor(
                instance, spec.get("max_concurrency", 1),
                spec.get("concurrency_groups"))
            return {"ok": True}
        except BaseException as e:  # noqa: BLE001
            import traceback
            return {"ok": False,
                    "error": "".join(traceback.format_exception(e))}

    async def actor_call(self, actor_id: ActorID, method: str,
                         args_frame: bytes, return_oids: List[ObjectID],
                         owner_addr, stream_id=None,
                         concurrency_group=None, trace=None):
        hosted = self.actors.get(actor_id)
        if hosted is None:
            err0 = TaskError(f"actor {actor_id} not hosted here")
            if stream_id is not None:
                await self._fail_stream_remote(stream_id, owner_addr,
                                               err0)
                return {"results": []}
            return self._package_error(err0, return_oids)
        span = return_oids[0].hex() if return_oids else ""
        t0, err = time.time(), False
        tok = tracing.current_span.set(span)
        tctx = tracing.parse_traceparent(trace)
        rtok = tracing.set_request_context(tctx)
        try:
            if stream_id is not None:
                args, kwargs = await self._resolve_args(args_frame)
                fn = getattr(hosted.instance, method)
                # Concurrency-grouped actors: the stream counts against
                # its group's limit for its WHOLE lifetime (a streaming
                # call is still one call of that group).
                if hosted.groups:
                    grp = concurrency_group or getattr(
                        fn, "_method_opts", {}).get("concurrency_group")
                    sem, pool = hosted.groups.get(
                        grp or "_default", hosted.groups["_default"])
                    async with sem:
                        return await self._drive_stream(
                            fn, args, kwargs, stream_id, owner_addr,
                            pool)
                # Sync generators on a serialized (max_concurrency==1)
                # actor hold the actor lock for the whole stream — the
                # stream IS the call. Async generators interleave on the
                # loop like other async methods.
                if hosted.lock is not None and \
                        inspect.isgeneratorfunction(fn):
                    async with hosted.lock:
                        return await self._drive_stream(
                            fn, args, kwargs, stream_id, owner_addr,
                            hosted.executor)
                return await self._drive_stream(
                    fn, args, kwargs, stream_id, owner_addr,
                    hosted.executor)
            args, kwargs = await self._resolve_args(args_frame)
            if method == "__dag_exec_loop__":
                # Compiled-dag pinned loop (see ray_tpu_torch/dag/
                # runtime.py): a long-running sync loop over shm
                # channels, dispatched specially so user classes need no
                # dag-specific methods.
                from functools import partial

                from ray_tpu_torch.dag.runtime import exec_loop
                fn = partial(exec_loop, hosted.instance)
            elif method == "__pipe_exec_loop__":
                # Pipeline-stage pinned loop (train/pipeline.py
                # schedules executed by dag/runtime.py pipe_exec_loop)
                # — dispatched like the dag loop, duck-typed against
                # the instance's pipe_forward/pipe_backward/pipe_step.
                from functools import partial

                from ray_tpu_torch.dag.runtime import pipe_exec_loop
                fn = partial(pipe_exec_loop, hosted.instance)
            else:
                fn = getattr(hosted.instance, method)
            if hosted.groups:
                # call-site options(concurrency_group=...) beats the
                # method-decorator default (reference: .options routing)
                grp = concurrency_group or getattr(
                    fn, "_method_opts", {}).get("concurrency_group")
                sem, pool = hosted.groups.get(
                    grp or "_default", hosted.groups["_default"])
                async with sem:
                    value = await self._run_callable(
                        fn, args, kwargs, pool)
            elif hosted.lock is not None and not \
                    inspect.iscoroutinefunction(fn):
                async with hosted.lock:
                    value = await self._run_callable(
                        fn, args, kwargs, hosted.executor)
            else:
                value = await self._run_callable(
                    fn, args, kwargs, hosted.executor)
            return await self._package(value, return_oids)
        except BaseException as e:  # noqa: BLE001
            err = True
            if stream_id is not None:
                # pre-drive failure (bad method name, arg resolution):
                # the consumer is parked on the stream, not the reply
                await self._fail_stream_remote(stream_id, owner_addr, e)
                return {"results": []}
            return self._package_error(e, return_oids)
        finally:
            tracing.reset_request_context(rtok)
            tracing.current_span.reset(tok)
            if method not in ("__dag_exec_loop__", "__pipe_exec_loop__"):
                # pinned dag/pipeline loops live for the whole graph
                # lifetime — a span covering one would occlude every
                # real slice
                tracing.record_exec(span, "actor", method, t0, time.time(),
                                    error=err,
                                    trace=tctx.trace_id if tctx else "")

    async def actor_call_batch(self, actor_id: ActorID, calls: list,
                               owner_addr):
        """Coalesced actor calls from one caller (see core.py _actor_pump).
        When every method in the batch is a plain sync function, the whole
        batch runs in ONE executor hop — the per-call thread handoff is the
        dominant cost it eliminates."""
        hosted = self.actors.get(actor_id)
        if hosted is None:
            err = TaskError(f"actor {actor_id} not hosted here")
            return {"batch": [self._package_error(err, c["return_oids"])
                              for c in calls]}
        methods = [getattr(hosted.instance, c["method"], None)
                   for c in calls]
        all_sync = all(m is not None and callable(m)
                       and not inspect.iscoroutinefunction(m)
                       and not inspect.isgeneratorfunction(m)
                       for m in methods) and \
            not any(c.get("stream_id") for c in calls) and \
            not hosted.groups  # grouped calls dispatch per-group
        if all_sync and hosted.lock is not None:
            resolved = []
            for c in calls:
                try:
                    resolved.append(await self._resolve_args(
                        c["args_frame"]))
                except BaseException as e:  # noqa: BLE001 — isolate call
                    resolved.append(_BatchError(e))
            spans = [c["return_oids"][0].hex() if c["return_oids"] else ""
                     for c in calls]
            names = [c["method"] for c in calls]
            traces = [c.get("trace") for c in calls]
            async with hosted.lock:
                loop = asyncio.get_running_loop()
                values = await loop.run_in_executor(
                    hosted.executor, self._run_batch_sync, methods,
                    resolved, spans, names, traces)
            out = []
            for v, c in zip(values, calls):
                out.append(await self._package_slot(v, c["return_oids"]))
            return {"batch": out}
        # Mixed/async batch: run per-call handlers CONCURRENTLY — async
        # actor methods rely on interleaving on the loop (e.g. serve's
        # @batch coalescing and max_concurrency semantics).
        out = await asyncio.gather(*[
            self.actor_call(actor_id, c["method"], c["args_frame"],
                            c["return_oids"], owner_addr,
                            c.get("stream_id"),
                            c.get("concurrency_group"),
                            c.get("trace"))
            for c in calls])
        return {"batch": list(out)}

    @staticmethod
    def _run_batch_sync(methods, resolved, spans=None, names=None,
                        traces=None):
        vals = []
        for i, (m, r) in enumerate(zip(methods, resolved)):
            if isinstance(r, _BatchError):  # arg resolution failed
                vals.append(r)
                continue
            args, kwargs = r
            tok = tracing.current_span.set(spans[i]) if spans else None
            tctx = tracing.parse_traceparent(traces[i]) if traces \
                else None
            rtok = tracing.set_request_context(tctx)
            t0, failed = time.time(), False
            try:
                vals.append(m(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — per-call error
                failed = True
                vals.append(_BatchError(e))
            finally:
                tracing.reset_request_context(rtok)
                if tok is not None:
                    tracing.current_span.reset(tok)
                    tracing.record_exec(
                        spans[i], "actor",
                        names[i] if names else getattr(m, "__name__", "?"),
                        t0, time.time(), batch=len(methods), error=failed,
                        trace=tctx.trace_id if tctx else "")
        return vals

    async def shutdown_worker(self):
        await self.flush_events()     # spans must outlive the worker
        # Final metrics snapshot: the push loop ticks every export
        # interval, so a worker reaped seconds after its last task
        # would otherwise take up to a full interval's counters to the
        # grave — head aggregation silently undercounts short-lived
        # workers. Bounded so a dead head can't stall the shutdown.
        flush = getattr(self, "_final_metrics_push", None)
        if flush is not None:
            try:
                await asyncio.wait_for(flush(), 2.0)
            except Exception:  # noqa: BLE001 — best effort on exit
                pass
        asyncio.get_running_loop().call_later(0.05, sys.exit, 0)
        return {"ok": True}


async def _amain():
    wd = os.environ.get("RAY_TPU_RT_WORKING_DIR")
    if wd:
        # The agent resolved this path (package-cache extraction for
        # pkg:// envs, local path otherwise) BEFORE spawning us — a
        # missing dir is a real bug and must fail loudly, not run the
        # task in a silently-empty directory.
        if os.environ.get("RAY_TPU_RT_WD_COPY") == "1":
            # cache entries are immutable + shared across jobs: give
            # this worker a private mutable copy so cwd writes can't
            # poison the content-addressed cache
            import atexit
            import shutil
            import tempfile
            priv = tempfile.mkdtemp(prefix="rtwd-")
            shutil.copytree(wd, priv, dirs_exist_ok=True)
            atexit.register(shutil.rmtree, priv, ignore_errors=True)
            wd = priv
        os.chdir(wd)
    head = (os.environ["RAY_TPU_HEAD_HOST"],
            int(os.environ["RAY_TPU_HEAD_PORT"]))
    agent = (os.environ["RAY_TPU_AGENT_HOST"],
             int(os.environ["RAY_TPU_AGENT_PORT"]))
    wid = WorkerID.from_hex(os.environ["RAY_TPU_WORKER_ID"])
    node_id = NodeID.from_hex(os.environ["RAY_TPU_NODE_ID"])
    session = os.environ["RAY_TPU_SESSION"]

    ctx = CoreContext(head, agent, node_id, session, is_driver=False)
    executor = WorkerExecutor(ctx)
    asyncio.ensure_future(executor._event_flush_loop())
    await ctx.start()

    # Make the worker-side public API work inside tasks (subtask submission,
    # ray_tpu_torch.get/put from user code).
    from ray_tpu_torch import api
    api._attach_existing(ctx)

    # Head-aggregated metrics: ship this worker's registry (llm/serve
    # request histograms etc.) to the control service every export
    # interval, labelled with node/worker identity, so the head
    # /metrics endpoint serves cluster-wide series (util/metrics.py
    # push_loop -> control report_metrics -> merge_remote).
    from ray_tpu_torch.util import metrics as _metrics

    async def _head_call(method, **kw):
        return await ctx.pool.call(head, method, timeout=10.0, **kw)

    _push_source = f"worker:{wid.hex()[:12]}"
    _push_labels = {"node": node_id.hex()[:12],
                    "worker": wid.hex()[:12]}
    asyncio.ensure_future(_metrics.push_loop(
        _head_call, source=_push_source, labels=_push_labels,
        interval_s=ctx.config.metrics_export_interval_s))
    # graceful shutdown drains one FINAL snapshot through the same
    # path (shutdown_worker) so the last interval's counters survive
    executor._final_metrics_push = lambda: _metrics.push_once(
        _head_call, _push_source, _push_labels)

    # SIGTERM is how the agent actually reaps workers (_kill_worker
    # -> proc.terminate()) AND how TPU preemption announces itself:
    # without this handler the process dies instantly and neither the
    # span flush nor the final metrics push ever runs — the
    # graceful-shutdown drain would be dead code on the production
    # reap path. When the durable checkpoint plane is live in this
    # process (train/ckptio.py imported — never imported just for
    # this), the signal FIRST runs the preemption hooks inside a
    # Config.preempt_grace_s window on a side thread (finish the
    # in-flight async checkpoint save + rank-0 manifest commit,
    # mirror the ZeRO shard to the ring successor) and only then the
    # normal drain; hooks are deadline-bounded and the hard
    # daemon-timer backstop moves out by exactly the grace, so a
    # dead head or a wedged hook can't turn termination into a hang.
    import signal as _signal
    import sys as _sys
    import threading as _threading
    _terming = {"v": False}

    def _graceful_term():
        if _terming["v"]:
            return
        _terming["v"] = True
        _ckptio = _sys.modules.get("ray_tpu_torch.train.ckptio")
        grace = float(getattr(ctx.config, "preempt_grace_s", 0.0)
                      or 0.0) if _ckptio is not None else 0.0
        t = _threading.Timer(grace + 3.0, os._exit, args=(0,))
        t.daemon = True
        t.start()
        if grace > 0:
            loop = asyncio.get_running_loop()

            def _drain():
                try:
                    _ckptio.fire_preemption(grace)
                except Exception:   # noqa: BLE001 — exit path
                    pass
                loop.call_soon_threadsafe(
                    lambda: asyncio.ensure_future(
                        executor.shutdown_worker()))
            th = _threading.Thread(target=_drain, daemon=True)
            th.start()
        else:
            asyncio.ensure_future(executor.shutdown_worker())

    try:
        asyncio.get_running_loop().add_signal_handler(
            _signal.SIGTERM, _graceful_term)
    except (NotImplementedError, RuntimeError, ValueError):
        pass     # non-unix: keep default die-now semantics

    # Device-plane observability (util/devmon.py): the monitor loop
    # snapshots per-device HBM + duty cycle once a task has initialised
    # CUDA in this process (it never imports torch itself — workers that
    # never touch the card pay nothing); the gauges ride the metrics
    # push above, the "device" events ride the event flush to the
    # agent. RAY_TPU_DEVMON=0 disables it all.
    from ray_tpu_torch.util import devmon as _devmon
    if _devmon.enabled():
        asyncio.ensure_future(_devmon.monitor_loop(
            ctx.config.devmon_hbm_interval_s))

    await ctx.pool.call(agent, "worker_ready", worker_id=wid, addr=ctx.addr)
    await asyncio.Event().wait()  # serve forever; agent kills us


def main():
    # No platform pin and no device import here: every worker would pay
    # torch's import time. A task that wants the card imports torch and
    # takes it through the port's resolve_device.
    from ray_tpu_torch.runtime.rpc import new_event_loop
    loop = new_event_loop()
    asyncio.set_event_loop(loop)
    try:
        loop.run_until_complete(_amain())
    except (KeyboardInterrupt, SystemExit):
        pass


if __name__ == "__main__":
    main()
