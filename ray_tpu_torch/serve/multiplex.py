"""Model multiplexing: many models served by few replicas.

Capability analog of the reference's ``@serve.multiplexed`` /
``serve.get_multiplexed_model_id`` (reference: python/ray/serve/multiplex.py
``_ModelMultiplexWrapper``, serve/api.py:1001). A replica holds an LRU
cache of loaded models; the handle routes a request tagged with a model id
preferentially to a replica that already has that model loaded (model-aware
power-of-two-choices), falling back to the least-loaded replica which then
loads it — the pattern for serving many LoRA-style variants from one
base model without rebuilding it per request. The port's copy of
``ray_tpu/serve/multiplex.py``.

    @serve.deployment(num_replicas=2)
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=4)
        async def get_model(self, model_id: str):
            return load_params(model_id)          # evicted LRU beyond 4

        async def __call__(self, req):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return run(model, req)

    h = serve.run(Multi.bind())
    h.options(multiplexed_model_id="adapter-7").remote(x)
"""

from __future__ import annotations

import asyncio
import contextvars
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the request currently being handled (set by the
    replica from the handle's ``multiplexed_model_id`` option)."""
    return _current_model_id.get()


class _PerInstanceCache:
    """LRU model cache living on one replica instance."""

    def __init__(self, func: Callable, owner: Any, max_models: int):
        self.func = func
        self.owner = owner
        self.max_models = max_models
        self.models: "OrderedDict[str, Any]" = OrderedDict()
        self.loading: dict = {}          # model_id -> asyncio.Future

    def model_ids(self) -> list:
        return list(self.models.keys())

    def _notify(self):
        cb = getattr(self.owner, "__serve_multiplex_notify__", None)
        if cb is not None:
            cb()

    def _evict_lru(self):
        """Drop the LRU model from the table now (no new requests can get
        it) and shut it down once in-flight requests on it drain — the
        replica maintains the per-model in-use counts
        (__serve_multiplex_active__ in serve/replica.py)."""
        model_id, model = self.models.popitem(last=False)
        active = getattr(self.owner, "__serve_multiplex_active__", None)

        async def drain_then_shutdown():
            if active is not None:
                deadline = asyncio.get_running_loop().time() + 60.0
                while active.get(model_id, 0) > 0 and \
                        asyncio.get_running_loop().time() < deadline:
                    await asyncio.sleep(0.01)
            shutdown = getattr(model, "shutdown", None)
            if shutdown is not None:
                out = shutdown()
                if asyncio.iscoroutine(out):
                    await out

        task = asyncio.get_running_loop().create_task(drain_then_shutdown())
        self._evictions = [t for t in getattr(self, "_evictions", [])
                           if not t.done()] + [task]

    async def load(self, model_id: str) -> Any:
        if model_id in self.models:
            self.models.move_to_end(model_id)          # LRU touch
            return self.models[model_id]
        if model_id in self.loading:                   # coalesce dup loads
            return await asyncio.shield(self.loading[model_id])
        fut = asyncio.get_running_loop().create_future()
        self.loading[model_id] = fut
        try:
            # capacity accounting includes loads in flight, so concurrent
            # cold loads can't overshoot max_models between them
            while self.models and \
                    len(self.models) + len(self.loading) > self.max_models:
                self._evict_lru()
            model = await self.func(self.owner, model_id)
            self.models[model_id] = model
            while len(self.models) > self.max_models:  # belt and braces
                self._evict_lru()
            fut.set_result(model)
            return model
        except BaseException as e:
            fut.set_exception(e)
            # a consumer awaiting the shared future retrieves it; if none
            # does, don't warn about an unretrieved exception
            fut.exception()
            raise
        finally:
            del self.loading[model_id]
            self._notify()


class _MultiplexedMethod:
    """Descriptor so each replica instance gets its own model cache."""

    def __init__(self, func: Callable, max_models: int):
        if not asyncio.iscoroutinefunction(func):
            raise TypeError("@serve.multiplexed requires an async method")
        self.func = func
        self.max_models = max_models
        self.attr = f"__serve_multiplex_{func.__name__}__"

    def __set_name__(self, owner, name):
        self.attr = f"__serve_multiplex_{name}__"

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        cache = getattr(instance, self.attr, None)
        if cache is None:
            cache = _PerInstanceCache(self.func, instance, self.max_models)
            setattr(instance, self.attr, cache)
            caches = getattr(instance, "__serve_multiplex_caches__", None)
            if caches is None:
                caches = []
                setattr(instance, "__serve_multiplex_caches__", caches)
            caches.append(cache)

        async def bound(model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or call via "
                    "handle.options(multiplexed_model_id=...)")
            return await cache.load(str(model_id))

        return bound


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator marking an async ``(self, model_id) -> model`` loader.

    The wrapped method becomes ``await self.loader(model_id=None)`` with a
    per-replica LRU cache of ``max_num_models_per_replica`` entries;
    evicted models get their ``shutdown()`` called when they define one.
    """
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def wrap(f: Callable) -> _MultiplexedMethod:
        return _MultiplexedMethod(f, max_num_models_per_replica)

    return wrap(func) if func is not None else wrap


def instance_model_ids(instance: Any) -> list:
    """All model ids currently loaded across an instance's multiplexed
    loaders (the replica's routing advertisement)."""
    ids: list = []
    for cache in getattr(instance, "__serve_multiplex_caches__", []):
        ids.extend(cache.model_ids())
    return ids
