"""ActorPool: schedule a stream of work over a fixed set of actors.

API parity with the reference (reference: python/ray/util/actor_pool.py
ActorPool.map/map_unordered/submit/get_next) on this runtime's handles.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        import ray_tpu_torch  # noqa: F401 — handles need an initialized runtime
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0      # next submit gets this index
        self._next_return_index = 0    # next ordered get_next returns this
        self._pending_submits = []

    # -- submission ------------------------------------------------------

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef; queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def _maybe_drain(self):
        while self._idle and self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    # -- retrieval -------------------------------------------------------

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in SUBMISSION order."""
        import ray_tpu_torch
        if not self.has_next():
            raise StopIteration("no more results to get")
        i = self._next_return_index
        if i not in self._index_to_future:
            self._maybe_drain()  # the ref may still be queued
        if i not in self._index_to_future:
            if self._index_to_future:
                # Earlier indexes were consumed by get_next_unordered;
                # resume ordering from the oldest outstanding one.
                i = min(self._index_to_future)
            else:
                raise RuntimeError("ActorPool has no actors to run work")
        self._next_return_index = i
        ref = self._index_to_future.pop(i)
        self._next_return_index += 1
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            self._return_actor(ref)

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in COMPLETION order."""
        import ray_tpu_torch
        if not self.has_next():
            raise StopIteration("no more results to get")
        self._maybe_drain()
        done, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                               num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("get_next_unordered timed out")
        ref = done[0]
        for idx, f in list(self._index_to_future.items()):
            if f is ref or f == ref:
                del self._index_to_future[idx]
                break
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            self._return_actor(ref)

    def _return_actor(self, ref):
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)
        self._maybe_drain()

    # -- bulk helpers ----------------------------------------------------

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- pool management -------------------------------------------------

    def push(self, actor: Any):
        self._idle.append(actor)
        self._maybe_drain()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
