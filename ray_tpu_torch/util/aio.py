"""Small asyncio adapters shared across the runtime and libraries."""

from __future__ import annotations

import asyncio


async def drive_sync_gen(gen, pool=None):
    """Async-iterate a SYNC generator without blocking the event loop:
    each next() (user code — may compute or block) runs in `pool` (or
    the loop's default executor). Closing the returned async generator
    closes the underlying sync generator."""
    loop = asyncio.get_running_loop()
    _END = object()

    def _next():
        try:
            return next(gen)
        except StopIteration:
            return _END

    try:
        while True:
            item = await loop.run_in_executor(pool, _next)
            if item is _END:
                return
            yield item
    finally:
        gen.close()
