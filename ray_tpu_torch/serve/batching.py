"""Dynamic request batching for serve replicas.

``@serve.batch`` coalesces concurrent calls to an async method into one
call on a list of inputs — the mechanism behind high-throughput jitted
inference replicas (one model call per batch, not per request).

The port's copy of ``ray_tpu/serve/batching.py``.

Reference capability: python/ray/serve/batching.py (the `@serve.batch`
decorator); implementation here is a fresh asyncio design sized to this
framework's single-loop replicas.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.items: List[tuple] = []          # (arg, future)
        self._flush_task: Optional[asyncio.Task] = None

    async def submit(self, arg: Any) -> Any:
        fut = asyncio.get_running_loop().create_future()
        self.items.append((arg, fut))
        if len(self.items) >= self.max_batch_size:
            self._do_flush()
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.ensure_future(self._delayed_flush())
        try:
            return await fut
        except asyncio.CancelledError:
            # deadline-cancelled caller (replica wait_for): pull the
            # item back out so the batch doesn't spend model compute on
            # a request nobody is waiting for
            for i, (a, f) in enumerate(self.items):
                if f is fut:
                    del self.items[i]
                    break
            raise

    async def _delayed_flush(self):
        await asyncio.sleep(self.timeout)
        self._do_flush()

    def _do_flush(self):
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
        self._flush_task = None
        batch, self.items = self.items, []
        if batch:
            asyncio.ensure_future(self._run_batch(batch))

    async def _run_batch(self, batch: List[tuple]):
        # drop entries whose waiter is already gone (deadline-cancelled
        # between enqueue and flush): their batch slots are reclaimed
        # for live requests instead of computing discarded results
        batch = [(a, f) for a, f in batch if not f.done()]
        if not batch:
            return
        args = [a for a, _ in batch]
        futs = [f for _, f in batch]
        try:
            results = await self.fn(args)
            if not isinstance(results, (list, tuple)) or \
                    len(results) != len(args):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"len {len(args)}, got {type(results).__name__}")
            for fut, r in zip(futs, results):
                if not fut.done():
                    fut.set_result(r)
        except BaseException as e:  # noqa: BLE001
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: ``async def method(self, item)`` calls are coalesced and
    dispatched to the wrapped function as ``await method(self, [items])``.

    The wrapped function receives a list and must return a list of equal
    length. Per-instance queues (the decorator is applied to unbound class
    methods; state is stored on the instance).
    """
    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async function")
        qattr = f"__batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def method(self, arg):
            q = getattr(self, qattr, None)
            if q is None:
                async def call(items):
                    return await fn(self, items)
                q = _BatchQueue(call, max_batch_size, batch_wait_timeout_s)
                setattr(self, qattr, q)
            return await q.submit(arg)

        method._is_serve_batch = True
        return method

    if _fn is not None:
        return wrap(_fn)
    return wrap
