"""Asyncio RPC: length-prefixed pickle frames, multiplexed calls, retries,
deterministic chaos injection.

The coordination-plane analog of the reference's gRPC wrappers
(reference: src/ray/rpc/grpc_server.h, rpc/retryable_grpc_client.h,
rpc/rpc_chaos.h). Control traffic here is low-rate (leases, heartbeats,
directory lookups) — the data plane (tensors) never touches this layer on
TPU; it belongs to ICI/XLA or the shared-memory object store.
"""

from __future__ import annotations

import asyncio
import itertools
import pickle
import random
import struct
import threading
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

import cloudpickle

_LEN = struct.Struct("<Q")

REQUEST, REPLY_OK, REPLY_ERR, ONEWAY = 0, 1, 2, 3

MAX_FRAME = 1 << 34


class RpcError(Exception):
    pass


class RemoteError(RpcError):
    """The handler raised; carries the remote traceback string."""

    def __init__(self, message, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


class ConnectionLost(RpcError):
    pass


class ChaosDropped(RpcError):
    """Injected transport-level failure: the request or reply was dropped by
    the chaos plan. Retryable — ConnectionPool.call retries it, so enabling
    chaos exercises the retry paths instead of failing tasks outright (the
    reference's chaos likewise produces retryable transport errors,
    rpc/rpc_chaos.h)."""


_CHAOS_MARK = "__chaos__:"


# --- chaos -----------------------------------------------------------------
# Deterministic fault injection for tests (reference: src/ray/rpc/rpc_chaos.h
# and the RAY_testing_rpc_failure env). Spec: "Method=N:p_req:p_rep,..." —
# inject up to N failures for Method, dropping the request with probability
# p_req or the reply with p_rep.

class ChaosPlan:
    def __init__(self, spec: str = "", seed: int = 0):
        self._budget: Dict[str, int] = {}
        self._p: Dict[str, Tuple[float, float]] = {}
        self._rng = random.Random(seed)
        for part in filter(None, (spec or "").split(",")):
            name, rest = part.split("=")
            bits = rest.split(":")
            self._budget[name] = int(bits[0])
            p_req = float(bits[1]) if len(bits) > 1 else 0.5
            p_rep = float(bits[2]) if len(bits) > 2 else 0.5
            self._p[name] = (p_req, p_rep)

    def should_fail(self, method: str) -> Optional[str]:
        """Returns None, 'request' (drop before handler runs) or 'reply'
        (handler runs, caller sees failure) — the two observable failure
        points of an RPC."""
        left = self._budget.get(method, 0)
        if left <= 0:
            return None
        p_req, p_rep = self._p[method]
        r = self._rng.random()
        if r < p_req:
            self._budget[method] = left - 1
            return "request"
        if r < p_req + p_rep:
            self._budget[method] = left - 1
            return "reply"
        return None


def _dumps(obj) -> bytes:
    try:
        return pickle.dumps(obj, protocol=5)
    except Exception:
        return cloudpickle.dumps(obj, protocol=5)


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    head = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return pickle.loads(body)


def _write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    body = _dumps(obj)
    if len(body) < (1 << 16):
        # one write(): header+body concatenation beats a second pass
        # through the transport write path for small control frames
        writer.write(_LEN.pack(len(body)) + body)
    else:  # big frame: never copy the body
        writer.write(_LEN.pack(len(body)))
        writer.write(body)


def new_event_loop() -> asyncio.AbstractEventLoop:
    """Event loop for every runtime component (EventLoopThread, workers,
    node processes). With eager tasks (3.12+) a spawned task runs
    synchronously until its first real await, skipping a loop round-trip
    per task — measured +15-25% on the RPC echo benchmark, and most
    runtime tasks (batched calls, pump kicks, reply writes) complete
    eagerly. Older Pythons fall back to the default factory."""
    loop = asyncio.new_event_loop()
    eager = getattr(asyncio, "eager_task_factory", None)
    if eager is not None:
        loop.set_task_factory(eager)
    return loop


Handler = Callable[..., Awaitable[Any]]


class RpcServer:
    """Serves `async def handler(**payload)` functions by method name."""

    def __init__(self, handlers: Dict[str, Handler],
                 chaos: Optional[ChaosPlan] = None):
        self._handlers = dict(handlers)
        self._chaos = chaos or ChaosPlan()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    def add_handler(self, name: str, fn: Handler) -> None:
        self._handlers[name] = fn

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._on_conn, host, port)
        sock = self._server.sockets[0]
        addr = sock.getsockname()
        return addr[0], addr[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                # 3.12's wait_closed also waits for in-flight handlers
                # (which may be parked in long polls) — bound it.
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except Exception:
                pass
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter):
        self._conns.add(writer)
        try:
            while True:
                try:
                    msg = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                kind, msg_id, method, payload = msg
                if kind == ONEWAY:
                    asyncio.ensure_future(
                        self._run(method, payload, None, None, None))
                else:
                    asyncio.ensure_future(
                        self._run(method, payload, writer, msg_id, method))
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _run(self, method, payload, writer, msg_id, _name):
        fail = self._chaos.should_fail(method)
        if fail == "request":
            if writer is not None:
                _write_frame(writer, (REPLY_ERR, msg_id,
                                      _CHAOS_MARK + "request dropped", None))
            return
        try:
            handler = self._handlers[method]
            result = await handler(**payload)
            err = None
        except BaseException as e:  # noqa: BLE001 — shipped to caller
            import traceback
            result = None
            err = (f"{type(e).__name__}: {e}\n"
                   + "".join(traceback.format_exception(e)), e)
        if writer is None:
            return
        if fail == "reply":
            _write_frame(writer, (REPLY_ERR, msg_id,
                                  _CHAOS_MARK + "reply dropped", None))
            return
        try:
            if err is None:
                _write_frame(writer, (REPLY_OK, msg_id, None, result))
            else:
                msg, exc = err
                try:  # exceptions may not pickle; fall back to message-only
                    _dumps(exc)
                except Exception:
                    exc = None
                _write_frame(writer, (REPLY_ERR, msg_id, msg, exc))
            await writer.drain()
        except (ConnectionResetError, RuntimeError, BrokenPipeError):
            pass


class RpcClient:
    """One connection; concurrent calls multiplexed by msg id."""

    def __init__(self, host: str, port: int):
        self.addr = (host, port)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._ids = itertools.count(1)
        self._recv_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        self.closed = False

    async def connect(self, timeout: float = 10.0) -> "RpcClient":
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(*self.addr), timeout)
        self._recv_task = asyncio.ensure_future(self._recv_loop())
        return self

    async def _recv_loop(self):
        try:
            while True:
                msg = await _read_frame(self._reader)
                kind, msg_id, err, payload = msg
                fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue
                if kind == REPLY_OK:
                    fut.set_result(payload)
                elif isinstance(err, str) and err.startswith(_CHAOS_MARK):
                    fut.set_exception(ChaosDropped(err))
                else:
                    fut.set_exception(RemoteError(err, payload))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError, BrokenPipeError, OSError):
            pass
        finally:
            self.closed = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost(f"to {self.addr}"))
            self._pending.clear()

    async def call(self, method: str, /, timeout: Optional[float] = None,
                   **payload) -> Any:
        if self.closed:
            raise ConnectionLost(f"to {self.addr}")
        msg_id = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        _write_frame(self._writer, (REQUEST, msg_id, method, payload))
        await self._writer.drain()
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    async def oneway(self, method: str, /, **payload) -> None:
        if self.closed:
            raise ConnectionLost(f"to {self.addr}")
        _write_frame(self._writer, (ONEWAY, 0, method, payload))
        await self._writer.drain()

    async def close(self):
        self.closed = True
        if self._recv_task is not None:
            self._recv_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass


class ConnectionPool:
    """Shared clients keyed by address, with retrying call helper
    (reference: rpc/retryable_grpc_client.h)."""

    def __init__(self, retry_attempts: int = 5, retry_backoff_s: float = 0.05):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._locks: Dict[Tuple[str, int], asyncio.Lock] = {}
        self._retries = retry_attempts
        self._backoff = retry_backoff_s

    async def get(self, addr: Tuple[str, int]) -> RpcClient:
        addr = tuple(addr)
        c = self._clients.get(addr)
        if c is not None and not c.closed:
            return c
        lock = self._locks.setdefault(addr, asyncio.Lock())
        async with lock:
            c = self._clients.get(addr)
            if c is not None and not c.closed:
                return c
            c = await RpcClient(*addr).connect()
            self._clients[addr] = c
            return c

    async def call(self, addr: Tuple[str, int], method: str, /,
                   timeout: Optional[float] = 30.0, **payload) -> Any:
        last = None
        for attempt in range(self._retries):
            try:
                c = await self.get(addr)
                return await c.call(method, timeout=timeout, **payload)
            except (ConnectionLost, ChaosDropped, ConnectionRefusedError,
                    OSError, asyncio.TimeoutError) as e:
                last = e
                await asyncio.sleep(self._backoff * (2 ** attempt))
        raise ConnectionLost(f"{method} to {addr} failed: {last}")

    async def close(self):
        for c in self._clients.values():
            await c.close()
        self._clients.clear()


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread — the sync Python API's
    bridge into the async runtime (the reference's equivalent boundary is
    Cython releasing the GIL into the C++ event loops)."""

    def __init__(self, name: str = "ray_tpu_io"):
        self.loop = new_event_loop()
        self._thread = threading.Thread(
            target=self._main, name=name, daemon=True)
        self._thread.start()

    def _main(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        # Cancel-and-await everything still parked on the loop (server
        # conn handlers, client recv loops, long polls) BEFORE stopping
        # it: stopping with pending tasks leaves them to be GC'd at
        # interpreter exit with "Task was destroyed" / "coroutine
        # ignored GeneratorExit" noise.
        async def _drain():
            me = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not me]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            asyncio.run_coroutine_threadsafe(
                _drain(), self.loop).result(timeout=3)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
