"""Distributed FIFO queue backed by an actor.

API parity with the reference (reference: python/ray/util/queue.py
Queue/Empty/Full over a _QueueActor wrapping asyncio.Queue): any worker
or driver holding the handle can put/get across the cluster.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item):
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return (True, await self._q.get())
        try:
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def get_nowait(self):
        try:
            return (True, self._q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    async def qsize(self):
        return self._q.qsize()

    async def empty(self):
        return self._q.empty()

    async def full(self):
        return self._q.full()


class Queue:
    """Create on any process; pass the object (it pickles by name) to
    tasks/actors to share one FIFO."""

    def __init__(self, maxsize: int = 0, *, actor_options: dict = None):
        import ray_tpu_torch
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        opts.setdefault("max_concurrency", 1000)
        self.maxsize = maxsize
        self.actor = ray_tpu_torch.remote(_QueueActor).options(**opts) \
            .remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch
        if not block:
            ok = ray_tpu_torch.get(self.actor.put_nowait.remote(item))
        else:
            ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full("queue is full")

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        else:
            ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("queue is empty")
        return item

    async def put_async(self, item: Any,
                        timeout: Optional[float] = None) -> None:
        import ray_tpu_torch
        ok = await ray_tpu_torch.get_async(
            self.actor.put.remote(item, timeout))
        if not ok:
            raise Full("queue is full")

    async def get_async(self, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch
        ok, item = await ray_tpu_torch.get_async(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("queue is empty")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        for it in items:
            self.put_nowait(it)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return [self.get_nowait() for _ in range(num_items)]

    def qsize(self) -> int:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self) -> None:
        import ray_tpu_torch
        ray_tpu_torch.kill(self.actor)
