"""Serve replica actor: hosts one instance of a deployment's user class.

Reference: python/ray/serve/_private/replica.py (UserCallableWrapper) —
the replica tracks ongoing-request counts (the router's p2c signal and the
autoscaler's input), runs user methods sync-or-async, and exposes
health/reconfigure hooks. This implementation targets async single-loop
actors (max_concurrency > 1) so a jitted-model replica can batch requests
with ``@serve.batch``.

The port's copy of ``ray_tpu/serve/replica.py``, without the JAX
package's compile-listener hook (see ``Replica.__init__``).
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.serve import fault
from ray_tpu_torch.serve.chaos import apply_async as _chaos_apply, chaos_fire
from ray_tpu_torch.util import tracing


def replica_metrics() -> dict:
    """Get-or-create the replica-side request-phase histograms: queue
    (arrival at the replica -> user code starts, i.e. event-loop /
    thread-pool scheduling delay) vs handler (user code execution) —
    the replica half of the proxy's queue/handler split."""
    from ray_tpu_torch.util import metrics as m
    return {
        "queue": m.Histogram(
            "serve_replica_queue_s",
            "Delay from request arrival at the replica to user-code "
            "start", tag_keys=("deployment",)),
        "handler": m.Histogram(
            "serve_replica_handler_s",
            "User handler execution time", tag_keys=("deployment",)),
    }


class Replica:
    """Created by the ServeController with max_concurrency > 1."""

    def __init__(self, deployment_name: str, replica_id: str,
                 cls_payload: bytes, init_args: tuple, init_kwargs: dict,
                 user_config: Optional[dict] = None):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        cls = cloudpickle.loads(cls_payload)
        # Resolve handle placeholders (composed deployments) lazily at
        # replica construction: the controller ships _HandleRef markers.
        from ray_tpu_torch.serve.handle import DeploymentHandle, _HandleRef
        def resolve(v):
            if isinstance(v, _HandleRef):
                return DeploymentHandle(v.deployment_name)
            return v
        init_args = tuple(resolve(a) for a in init_args)
        init_kwargs = {k: resolve(v) for k, v in init_kwargs.items()}
        self.instance = cls(*init_args, **init_kwargs)
        # The JAX package hooks jax's compile listeners here, after the
        # user __init__ bound the model. The port has no such hook: its
        # only compiles are the nvcc kernel builds, which ops/_build.py
        # records as devmon compile events at first use, in whatever
        # process builds them.
        self._ongoing = 0
        self._processed = 0
        self._errors = 0
        self._draining = False
        self._started_at = time.time()
        self._m = replica_metrics()
        self._fm = fault.fault_metrics()
        # multiplexed-model loaders push loaded-set changes to the
        # controller so handles can route model-affine (serve/multiplex.py);
        # classes that reject new attributes (__slots__ etc.) just serve
        # without the routing hint
        self._model_active: Dict[str, int] = {}
        try:
            self.instance.__serve_multiplex_notify__ = self._notify_model_ids
            self.instance.__serve_multiplex_active__ = self._model_active
        except (AttributeError, TypeError):
            pass
        self._model_ids_dirty = False
        if user_config is not None and hasattr(self.instance, "reconfigure"):
            self.instance.reconfigure(user_config)

    # -- data path ---------------------------------------------------------

    async def _admit(self, meta: Optional[dict]):
        """Entry gate shared by the unary and streaming paths: serve
        chaos (replica->engine boundary), drain rejection, the deadline
        pre-check + context bind, and the TRACE context bind. Returns
        (deadline token, deadline, incoming trace ctx, trace token,
        handler span id): the handler span id is minted HERE and bound
        as the ambient context so the engine — and anything user code
        submits — parents its spans to this replica's handler span."""
        await _chaos_apply(chaos_fire("replica"), "replica")
        if self._draining:
            # reject BEFORE any user code: the caller can reroute this
            # safely because nothing started here
            raise fault.ReplicaDraining(
                f"replica {self.replica_id} of {self.deployment_name} "
                "is draining")
        dl = (meta or {}).get("deadline_ts")
        if dl is not None and time.time() > dl:
            self._fm["deadline"].inc(tags={"where": "replica"})
            raise fault.DeadlineExceeded(
                f"budget spent before replica {self.replica_id} "
                "started the request")
        pctx = tracing.parse_traceparent((meta or {}).get("traceparent"))
        hid = tracing.new_span_id() if pctx is not None else ""
        tr_token = tracing.set_request_context(
            tracing.TraceContext(pctx.trace_id, hid)) \
            if pctx is not None else None
        return fault.set_request_deadline(dl), dl, pctx, tr_token, hid

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             meta: Optional[dict] = None):
        """Run a user method. Coroutine methods run on the actor's event
        loop (enables @serve.batch coalescing); sync methods run on the
        actor's thread pool via the worker's executor. ``meta`` carries
        request metadata (the multiplexed model id and the propagated
        deadline — coroutine methods are cancelled when the deadline
        passes; sync methods can't be interrupted mid-thread, but read
        fault.current_deadline_ts() to cooperate)."""
        import contextvars

        from ray_tpu_torch.serve.multiplex import _current_model_id
        dl_token, dl, pctx, tr_token, hid = await self._admit(meta)
        self._ongoing += 1
        t_arrive = time.monotonic()
        t_arrive_wall = time.time()
        qdur = [0.0]             # set where the queue phase ends
        ok = False
        tags = {"deployment": self.deployment_name}
        token = None
        mid = (meta or {}).get("multiplexed_model_id")
        if mid:
            token = _current_model_id.set(mid)
            # in-use count: deferred eviction waits for this to drain
            # before shutting a model down (serve/multiplex.py _evict_lru)
            self._model_active[mid] = self._model_active.get(mid, 0) + 1
        try:
            fn = getattr(self.instance, method)
            if inspect.iscoroutinefunction(fn):
                t_run = time.monotonic()
                qdur[0] = t_run - t_arrive
                self._m["queue"].observe(qdur[0], tags)
                try:
                    if dl is not None:
                        try:
                            out = await asyncio.wait_for(
                                fn(*args, **kwargs),
                                max(0.001, dl - time.time()))
                        except asyncio.TimeoutError:
                            self._fm["deadline"].inc(
                                tags={"where": "replica"})
                            raise fault.DeadlineExceeded(
                                f"{method} cancelled at the deadline "
                                f"on replica {self.replica_id}")
                    else:
                        out = await fn(*args, **kwargs)
                finally:
                    # errored/timed-out requests are exactly the
                    # latencies worth keeping (the sync path's finally
                    # below keeps them too)
                    self._m["handler"].observe(
                        time.monotonic() - t_run, tags)
            else:
                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()

                def _run():
                    # queue includes the thread-pool hop; timed on the
                    # worker thread so a saturated pool shows up here
                    t_run = time.monotonic()
                    qdur[0] = t_run - t_arrive
                    self._m["queue"].observe(qdur[0], tags)
                    try:
                        return ctx.run(fn, *args, **kwargs)
                    finally:
                        self._m["handler"].observe(
                            time.monotonic() - t_run, tags)

                out = await loop.run_in_executor(None, _run)
            self._processed += 1
            ok = True
            return out
        except BaseException:
            self._errors += 1
            raise
        finally:
            if tr_token is not None:
                tracing.reset_request_context(tr_token)
            if pctx is not None:
                # replica hop segments: queue (arrival -> user-code
                # start) then handler (user code; the span the engine's
                # spans parent to via the bound context)
                tracing.record_request_span(
                    "replica", "queue", pctx, pctx.span_id,
                    t_arrive_wall, t_arrive_wall + qdur[0],
                    deployment=self.deployment_name)
                tracing.record_request_span(
                    "replica", "handler", pctx, pctx.span_id,
                    t_arrive_wall + qdur[0], time.time(), span_id=hid,
                    error=not ok, deployment=self.deployment_name,
                    method=method, replica=self.replica_id)
            fault.reset_request_deadline(dl_token)
            if token is not None:
                _current_model_id.reset(token)
                n = self._model_active.get(mid, 1) - 1
                if n <= 0:
                    self._model_active.pop(mid, None)
                else:
                    self._model_active[mid] = n
            self._ongoing -= 1

    async def handle_request_stream(self, method: str, args: tuple,
                                    kwargs: dict,
                                    meta: Optional[dict] = None):
        """Streaming twin of handle_request: the user method must be a
        (sync or async) generator; its items are re-yielded, so a
        caller invoking this with num_returns="streaming" receives them
        push-based through the object plane (reference:
        serve/_private/replica.py streaming call path). The propagated
        deadline is bound to the request context (the engine cancels at
        it, reclaiming its slot); the stream itself is cut the moment
        the budget is spent."""
        from ray_tpu_torch.serve.multiplex import _current_model_id
        dl_token, dl, pctx, tr_token, hid = await self._admit(meta)
        self._ongoing += 1
        t_run = time.monotonic()
        t_run_wall = time.time()
        ok = False
        tags = {"deployment": self.deployment_name}
        token = None
        mid = (meta or {}).get("multiplexed_model_id")
        if mid:
            token = _current_model_id.set(mid)
            self._model_active[mid] = self._model_active.get(mid, 0) + 1
        try:
            fn = getattr(self.instance, method)
            if inspect.isasyncgenfunction(fn):
                async for item in fn(*args, **kwargs):
                    if dl is not None and time.time() > dl:
                        self._fm["deadline"].inc(
                            tags={"where": "replica"})
                        raise fault.DeadlineExceeded(
                            f"stream {method} cut at the deadline on "
                            f"replica {self.replica_id}")
                    yield item
            elif inspect.isgeneratorfunction(fn):
                from ray_tpu_torch.util.aio import drive_sync_gen
                async for item in drive_sync_gen(fn(*args, **kwargs)):
                    if dl is not None and time.time() > dl:
                        self._fm["deadline"].inc(
                            tags={"where": "replica"})
                        raise fault.DeadlineExceeded(
                            f"stream {method} cut at the deadline on "
                            f"replica {self.replica_id}")
                    yield item
            else:
                raise TypeError(
                    f"streaming call to {method!r}, which is not a "
                    "generator method")
            self._processed += 1
            ok = True
        except GeneratorExit:
            # client walked away mid-stream (gen.close()): a routine
            # disconnect, not a replica failure — don't count it
            ok = True
            raise
        except BaseException:
            self._errors += 1
            raise
        finally:
            # a stream's "handler" span covers the whole generation —
            # the stream IS the call
            self._m["handler"].observe(time.monotonic() - t_run, tags)
            if tr_token is not None:
                tracing.reset_request_context(tr_token)
            if pctx is not None:
                tracing.record_request_span(
                    "replica", "handler", pctx, pctx.span_id,
                    t_run_wall, time.time(), span_id=hid,
                    error=not ok, deployment=self.deployment_name,
                    method=method, replica=self.replica_id)
            fault.reset_request_deadline(dl_token)
            if token is not None:
                _current_model_id.reset(token)
                n = self._model_active.get(mid, 1) - 1
                if n <= 0:
                    self._model_active.pop(mid, None)
                else:
                    self._model_active[mid] = n
            self._ongoing -= 1

    # -- control path ------------------------------------------------------

    def _notify_model_ids(self):
        """Push the loaded-model set to the controller (debounced); the
        routing tables handles fetch then steer model-tagged requests to
        replicas already holding the model."""
        if self._model_ids_dirty:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._model_ids_dirty = True

        async def push():
            await asyncio.sleep(0.05)          # coalesce load bursts
            self._model_ids_dirty = False
            from ray_tpu_torch.serve.multiplex import instance_model_ids
            ids = instance_model_ids(self.instance)

            def report():
                from ray_tpu_torch import api
                from ray_tpu_torch.serve.handle import CONTROLLER_NAME, \
                    SERVE_NAMESPACE
                c = api.get_actor(CONTROLLER_NAME,
                                  namespace=SERVE_NAMESPACE)
                c.report_model_ids.remote(
                    self.deployment_name, self.replica_id, ids)

            try:
                # api calls can block; keep them off the actor loop
                await loop.run_in_executor(None, report)
            except Exception:
                pass        # routing hint only — next change retries

        self._push_task = loop.create_task(push())

    def model_ids(self) -> list:
        from ray_tpu_torch.serve.multiplex import instance_model_ids
        return instance_model_ids(self.instance)

    def ping(self) -> str:
        """Health check; also honors a user-defined check_health()."""
        if hasattr(self.instance, "check_health"):
            self.instance.check_health()
        return "ok"

    def set_draining(self, draining: bool = True) -> int:
        """Graceful drain (controller-driven on scale-down/redeploy):
        a DRAINING replica rejects NEW requests with ReplicaDraining
        (callers reroute — the request never started) while in-flight
        ones, including streams, run to completion. Returns the current
        in-flight count so the controller can decide when to stop."""
        self._draining = bool(draining)
        return self._ongoing

    def metrics(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "deployment": self.deployment_name,
            "ongoing": self._ongoing,
            "processed": self._processed,
            "errors": self._errors,
            "draining": self._draining,
            "uptime_s": time.time() - self._started_at,
        }

    def reconfigure(self, user_config: dict) -> bool:
        if hasattr(self.instance, "reconfigure"):
            self.instance.reconfigure(user_config)
        return True

    def prepare_shutdown(self) -> bool:
        if hasattr(self.instance, "shutdown"):
            self.instance.shutdown()
        return True
