"""Single-producer/single-consumer shared-memory ring channel.

Transport for compiled actor DAGs (reference:
python/ray/experimental/channel/shared_memory_channel.py — which
round-trips through plasma; here slots live in one pre-allocated POSIX
shm segment, so steady-state transfers are two memcpys and no RPC).

Layout: [128B header | nslots * (8B len+kind | slot_bytes payload)].
Header holds write_seq (offset 0) and read_seq (offset 64) on separate
cache lines. SPSC with monotonic sequence counters needs no locks on
x86-64 (TSO: the payload store is visible before the seq increment;
aligned 8-byte stores are atomic). Readers/writers poll with a short
adaptive sleep — the microsecond-scale cost only matters at rest.

Frames are tagged DATA / ERROR / STOP so exceptions and teardown ride
the same path as values.

The port's copy of ``ray_tpu/dag/channel.py``: the same wire layout,
chaos plane and TCP credit protocol, over the port's runtime, config and
native ring library (``ray_tpu_torch/_native``).
"""

from __future__ import annotations

import threading
import time
import uuid
from multiprocessing import shared_memory
from typing import Optional

HDR = 128
SLOT_HDR = 8  # u32 length + u8 kind + 3B pad

DATA, ERROR, STOP = 0, 1, 2


class ChannelClosed(Exception):
    pass


class ChannelTimeout(Exception):
    pass


class ChannelAttachRefused(ChannelClosed):
    """A producer's connect was refused for the whole per-call budget
    BEFORE any connection existed. Still a ChannelClosed for ordinary
    callers (dag teardown reads it as "consumer stage is gone"), but
    sliced ring waits retry it up to the ring timeout: during elastic
    re-formation a consumer mid-restart refuses connects for longer
    than one 0.25 s abort slice, and giving up on the first slice
    would frame a live peer as dead and collapse the reshard into a
    full restart. Resets on an ESTABLISHED connection stay instantly
    fatal — only the attach phase is ambiguous."""


class ChaosInjectedTimeout(ChannelTimeout):
    """A testing_channel_failure read-drop. Subclasses ChannelTimeout
    so ordinary timeout handling applies, but sliced-wait retry loops
    (RingReducer._op_sliced) re-raise it instead of retrying — an
    injected fault fires exactly once, so retrying would silently
    nullify it (the counter is already past nth)."""
    chaos_injected = True


# --- deterministic chaos plane ------------------------------------------
#
# The channel-layer sibling of the RPC plane's fault injection
# (runtime/rpc.py ChaosPlan, reference: src/ray/rpc/rpc_chaos.h):
# Config.testing_channel_failure arms repeatable faults on the DAG
# transports so elastic-training recovery is exercised by injection,
# not by hand-timed process kills. Rules fire on the Nth matching op
# counted PROCESS-WIDE — in a ring collective each participant's op
# sequence is deterministic, so "write:kill:17" dies at the same
# pipeline position every run.

class ChannelChaos:
    """Parsed testing_channel_failure rules + per-op trigger counters.

    Spec: comma-separated ``<op>:<action>:<nth>[:<param>]`` —
      op      "write" | "read" (both channel flavors)
      action  "delay" (sleep ``param`` seconds, then proceed)
              "drop"  (write: silently discard the frame — the peer
                       starves and times out, a lossy-link simulation;
                       read: raise ChannelTimeout once)
              "kill"  (SIGKILL this process: a deterministic
                       mid-collective worker death)
      nth     1-based index of the matching op in this process
      param   seconds (delay only; default 0.1)
    """

    _ACTIONS = ("delay", "drop", "kill")

    def __init__(self, spec: str):
        self.rules = []
        for part in filter(None, (spec or "").split(",")):
            bits = part.strip().split(":")
            if len(bits) < 3:
                raise ValueError(
                    f"testing_channel_failure rule {part!r}: expected "
                    f"<op>:<action>:<nth>[:<param>]")
            op, action, nth = bits[0], bits[1], int(bits[2])
            if op not in ("write", "read"):
                raise ValueError(
                    f"testing_channel_failure op must be write|read, "
                    f"got {op!r}")
            if action not in self._ACTIONS:
                raise ValueError(
                    f"testing_channel_failure action must be one of "
                    f"{self._ACTIONS}, got {action!r}")
            if nth < 1:
                raise ValueError(
                    f"testing_channel_failure nth must be >= 1, "
                    f"got {nth}")
            param = float(bits[3]) if len(bits) > 3 else 0.1
            self.rules.append(
                {"op": op, "action": action, "nth": nth,
                 "param": param, "count": 0})

    def fire(self, op: str) -> Optional[str]:
        """Advance counters for ``op``; returns the action to apply at
        this call site ("drop") after executing side-effectful ones
        (delay sleeps here, kill never returns)."""
        out = None
        for r in self.rules:
            if r["op"] != op:
                continue
            r["count"] += 1
            if r["count"] != r["nth"]:
                continue
            if r["action"] == "delay":
                time.sleep(r["param"])
            elif r["action"] == "kill":
                import os
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            else:
                out = "drop"
        return out


_chaos: Optional[ChannelChaos] = None
_chaos_loaded = False
_chaos_tl = threading.local()


def chaos_mark_retry(flag: bool) -> None:
    """Nth-op counters are per LOGICAL op: a sliced wait that re-enters
    the same channel op after a ChannelTimeout (RingReducer._op_sliced
    retries every abort slice) marks itself here so retries don't
    advance the counters — otherwise a stall anywhere in the ring would
    turn the op index into a wall-clock count and "kill at op 17" would
    fire at a different pipeline position per run."""
    _chaos_tl.retry = flag


def _chaos_op(op: str) -> Optional[str]:
    """Per-op chaos hook for both channel flavors; near-zero cost when
    testing_channel_failure is empty (one module-global check)."""
    global _chaos, _chaos_loaded
    if not _chaos_loaded:
        from ray_tpu_torch.config import get_config
        spec = getattr(get_config(), "testing_channel_failure", "")
        _chaos = ChannelChaos(spec) if spec else None
        _chaos_loaded = True
    if _chaos is None or getattr(_chaos_tl, "retry", False):
        return None
    return _chaos.fire(op)


def reset_channel_chaos() -> None:
    """Re-read testing_channel_failure on the next channel op (tests
    flip the config mid-process; counters restart from zero)."""
    global _chaos, _chaos_loaded
    _chaos = None
    _chaos_loaded = False


def _as_u8(payload) -> memoryview:
    """A flat uint8 memoryview of any bytes-like / buffer-protocol
    payload, without copying when the buffer is C-contiguous (numpy
    array views, bytearrays, bytes)."""
    mv = payload if isinstance(payload, memoryview) \
        else memoryview(payload)
    if mv.ndim != 1 or mv.format != "B":
        try:
            mv = mv.cast("B")
        except TypeError:            # non-contiguous: pay one copy
            mv = memoryview(bytes(mv))
    return mv


class ShmRingChannel:
    """One direction, one producer process, one consumer process."""

    def __init__(self, name: Optional[str] = None, *, nslots: int = 8,
                 slot_bytes: int = 1 << 20, create: bool = False):
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        size = HDR + nslots * (SLOT_HDR + slot_bytes)
        if create:
            name = name or f"rtch-{uuid.uuid4().hex[:16]}"
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=size)
            self._shm.buf[:HDR] = b"\x00" * HDR
        else:
            assert name is not None
            self._shm = shared_memory.SharedMemory(name=name)
        self.name = name
        self._seqs = self._shm.buf.cast("Q")  # [0]=write_seq, [8]=read_seq
        # Native fast path (portable atomics + GIL-free waits + C memcpy);
        # None -> pure-Python fallback below.
        from ray_tpu_torch._native import load_ringbuf
        self._lib = load_ringbuf()
        self._cbase = None
        if self._lib is not None:
            import ctypes
            self._cbase = ctypes.cast(
                (ctypes.c_uint8 * size).from_buffer(self._shm.buf),
                ctypes.POINTER(ctypes.c_uint8))

    # seq accessors -----------------------------------------------------
    @property
    def _wseq(self) -> int:
        return self._seqs[0]

    @_wseq.setter
    def _wseq(self, v: int):
        self._seqs[0] = v

    @property
    def _rseq(self) -> int:
        return self._seqs[8]

    @_rseq.setter
    def _rseq(self, v: int):
        self._seqs[8] = v

    def _slot(self, seq: int):
        off = HDR + (seq % self.nslots) * (SLOT_HDR + self.slot_bytes)
        return off

    # producer ----------------------------------------------------------
    def has_space(self) -> bool:
        """True if a write would not block. Only the consumer can change
        this from False to True, so a single producer may rely on it."""
        if self._lib is not None and self._cbase is not None:
            return bool(self._lib.rb_has_space(self._cbase, self.nslots))
        return self._wseq - self._rseq < self.nslots

    def write(self, payload, kind: int = DATA,
              timeout: Optional[float] = None):
        """payload: bytes-like / any C-contiguous buffer (numpy views —
        e.g. ring-allreduce chunk slices — are written without an
        intermediate bytes() copy), or an object with (frame_nbytes,
        write_into) — ray_tpu_torch Serialized — written zero-copy."""
        if _chaos is not None or not _chaos_loaded:
            if _chaos_op("write") == "drop":
                return              # injected lossy link: frame vanishes
        mv = None
        if hasattr(payload, "write_into"):
            n = payload.frame_nbytes
        else:
            mv = _as_u8(payload)
            n = mv.nbytes
        if n > self.slot_bytes:
            raise ValueError(
                f"frame of {n} B exceeds channel slot size "
                f"{self.slot_bytes} B; compile the dag with a larger "
                f"slot_bytes")
        native = self._lib is not None and self._cbase is not None
        if native and mv is not None:
            import ctypes
            if isinstance(payload, bytes):
                data = payload           # ctypes takes bytes directly
            elif mv.readonly:
                # from_buffer refuses readonly views (e.g. arrays
                # deserialized from a frame); borrow the raw pointer via numpy — mv
                # stays referenced across the synchronous rb_write, so
                # the buffer cannot move or be freed under the copy
                import numpy as _np
                data = ctypes.cast(ctypes.c_void_p(
                    _np.frombuffer(mv, dtype=_np.uint8).ctypes.data
                    if n else 0), ctypes.c_char_p)
            else:
                data = ctypes.cast((ctypes.c_char * n).from_buffer(mv),
                                   ctypes.c_char_p)
            rc = self._lib.rb_write(
                self._cbase, self.nslots, self.slot_bytes,
                data, n, kind,
                -1.0 if timeout is None else float(timeout))
            if rc == -1:
                raise ChannelTimeout("channel full")
            return
        seq = self._wseq
        if native:
            # Zero-copy (Serialized) path: block for space in native
            # code (GIL-free), fill the slot from Python, then publish
            # WITH a futex wake — a sleeping native reader would
            # otherwise only notice at its re-check cap.
            rc = self._lib.rb_wait_space(
                self._cbase, self.nslots,
                -1.0 if timeout is None else float(timeout))
            if rc == -1:
                raise ChannelTimeout("channel full")
        else:
            self._wait(lambda: seq - self._rseq < self.nslots, timeout,
                       "channel full")
        off = self._slot(seq)
        buf = self._shm.buf
        if hasattr(payload, "write_into"):
            payload.write_into(buf[off + SLOT_HDR:off + SLOT_HDR + n])
        else:
            buf[off + SLOT_HDR:off + SLOT_HDR + n] = mv
        buf[off:off + 4] = n.to_bytes(4, "little")
        buf[off + 4] = kind
        if native:
            self._lib.rb_publish_write(self._cbase)
        else:
            self._wseq = seq + 1  # release: makes the slot visible

    # consumer ----------------------------------------------------------
    def read_with(self, fn, timeout: Optional[float] = None):
        """Run fn(kind, memoryview-of-frame) on the next frame WITHOUT
        copying; the slot is released only after fn returns, so the view
        (and anything deserialized zero-copy from it) must not escape."""
        if _chaos is not None or not _chaos_loaded:
            if _chaos_op("read") == "drop":
                raise ChaosInjectedTimeout("chaos: injected read drop")
        if self._lib is not None and self._cbase is not None:
            off = self._lib.rb_wait_readable(  # GIL-free wait
                self._cbase, self.nslots, self.slot_bytes,
                -1.0 if timeout is None else float(timeout))
            if off < 0:
                raise ChannelTimeout("channel empty")
            buf = self._shm.buf
            n = int.from_bytes(buf[off:off + 4], "little")
            kind = buf[off + 4]
            try:
                return fn(kind, buf[off + SLOT_HDR:off + SLOT_HDR + n])
            finally:
                self._lib.rb_release(self._cbase)
        seq = self._rseq
        self._wait(lambda: self._wseq > seq, timeout, "channel empty")
        off = self._slot(seq)
        buf = self._shm.buf
        n = int.from_bytes(buf[off:off + 4], "little")
        kind = buf[off + 4]
        try:
            return fn(kind, buf[off + SLOT_HDR:off + SLOT_HDR + n])
        finally:
            self._rseq = seq + 1  # release the slot for the producer

    def read_bytes(self, timeout: Optional[float] = None):
        # read_with already uses the native GIL-free wait when available
        # and copies exactly once.
        return self.read_with(lambda k, mv: (k, bytes(mv)), timeout)

    @staticmethod
    def _wait(cond, timeout, what):
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 20e-6
        while not cond():
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeout(what)
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    # lifecycle ---------------------------------------------------------
    def close(self):
        self._cbase = None  # drop the ctypes buffer export first
        try:
            self._seqs.release()
        except Exception:
            pass
        self._seqs = None
        # tolerant close: a reader may still hold a zero-copy payload
        # view; leak the mapping rather than arm a raising finalizer
        from ray_tpu_torch.runtime.object_store import _safe_close
        _safe_close(self._shm)

    def unlink(self):
        try:
            self._shm.unlink()
        except Exception:
            pass

    def spec(self) -> dict:
        return {"name": self.name, "nslots": self.nslots,
                "slot_bytes": self.slot_bytes}

    @classmethod
    def attach(cls, spec: dict) -> "ShmRingChannel":
        return cls(spec["name"], nslots=spec["nslots"],
                   slot_bytes=spec["slot_bytes"])


# --- cross-host channel ------------------------------------------------

_FRAME_HDR = 5          # u32 length (LE) + u8 kind
_ACK = b"\x06"


def _kv(method, **kw):
    from ray_tpu_torch import api
    ctx = api._require_init()
    return api._run(ctx.pool.call(ctx.head_addr, method, **kw))


def _advertise_host() -> str:
    """The address peers on OTHER hosts can reach this process at: the
    node agent's bind host (workers carry it in RAY_TPU_AGENT_HOST;
    real multi-host deployments start nodes with --node-host <ip>).
    The listener itself binds 0.0.0.0, so any routable name works."""
    import os
    h = os.environ.get("RAY_TPU_AGENT_HOST")
    if h and h != "0.0.0.0":
        return h
    from ray_tpu_torch import api
    ctx = api._require_init()
    if getattr(api._g, "agent", None) is not None and \
            api._g.agent.addr and api._g.agent.addr[0] != "0.0.0.0":
        return api._g.agent.addr[0]
    return ctx.addr[0] if ctx.addr else "127.0.0.1"


class TcpChannel:
    """SPSC channel across HOSTS: the DCN substrate compiled graphs
    need for pipeline-parallel inference across slices (reference:
    experimental/channel/shared_memory_channel.py crosses nodes by
    round-tripping plasma; here frames flow producer -> consumer over
    one TCP connection with credit-based flow control that preserves
    the shm ring's bounded-buffer semantics: at most `nslots` frames
    in flight, each ACKed when the consumer releases its slot).

    Endpoint negotiation rides the control KV — the one address every
    participant already shares: the consumer binds an ephemeral port on
    its host and publishes ``host:port`` under the channel id; the
    producer polls the key and connects. Same duck-type as
    ShmRingChannel (write / read_with / read_bytes / has_space /
    close / unlink / spec), so the dag runtime treats edges uniformly.
    """

    KV_PREFIX = "__dagch:"
    CONNECT_TIMEOUT_S = 120.0   # bound for "consumer never came up"

    def __init__(self, spec: dict, role: str,
                 nonblocking_writes: bool = False):
        """``nonblocking_writes``: write() ENQUEUES the frame (credit
        permitting) and flushes opportunistically instead of blocking
        on the kernel send buffer. The DRIVER's input channels use this
        — the driver is the sink's only drainer, so a write that blocks
        on a stalled pipeline would deadlock it (stage channels keep
        blocking writes: a stage SHOULD stall when downstream is
        full)."""
        assert role in ("producer", "consumer"), role
        self.id = spec["id"]
        self.nslots = spec["nslots"]
        self.slot_bytes = spec["slot_bytes"]
        self.role = role
        self.nonblocking_writes = nonblocking_writes
        self._sock = None
        self._listener = None
        self._inflight = 0          # producer: un-ACKed frames
        self._rbuf = bytearray()    # consumer: partial-read resume
        self._wbuf = bytearray()    # producer: unflushed frame bytes
        self._ident_left = 0        # consumer: handshake bytes pending
        self._pending_hdr = None    # consumer: parsed frame header
        if role == "consumer":
            import socket
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(("0.0.0.0", 0))
            self._listener.listen(1)
            port = self._listener.getsockname()[1]
            _kv("kv_put", key=self.KV_PREFIX + self.id,
                value=f"{_advertise_host()}:{port}".encode())

    # --- connection ----------------------------------------------------

    def _ensure_conn(self, timeout: Optional[float]):
        if self._sock is not None:
            if self._ident_left:     # resume a half-done handshake
                self._check_ident(timeout)
            return
        import socket
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        if self.role == "consumer":
            self._listener.settimeout(timeout)
            try:
                self._sock, _ = self._listener.accept()
            except (socket.timeout, BlockingIOError):
                # BlockingIOError: timeout == 0.0 puts the socket in
                # non-blocking mode (driver-side opportunistic polls)
                raise ChannelTimeout("no producer connected")
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._ident_left = len(self.id)
            self._check_ident(timeout)
            return
        else:
            # never poll forever: a consumer that died before attaching
            # would otherwise hang the producer with no diagnosis.
            # Endpoint polling AND refused connects retry with jittered
            # exponential backoff bounded by the caller's deadline: a
            # peer mid-restart during elastic re-formation (endpoint
            # not yet republished, or listener not yet accepting) must
            # neither burn a CPU in a tight loop nor flake the attach —
            # the KV is re-read each attempt, so a consumer that
            # rebinds a fresh port under the same channel id is picked
            # up as soon as it publishes.
            if deadline is None:
                deadline = time.monotonic() + self.CONNECT_TIMEOUT_S
            import random
            attempt = 0
            last_err: Optional[str] = None
            while True:
                blob = _kv("kv_get", key=self.KV_PREFIX + self.id)
                if blob:
                    host, port = blob.decode().rsplit(":", 1)
                    try:
                        self._sock = socket.create_connection(
                            (host, int(port)),
                            timeout=max(1.0,
                                        deadline - time.monotonic()))
                        self._sock.sendall(self.id.encode())
                        break
                    except socket.timeout:
                        self._sock = None
                        raise ChannelTimeout(
                            "connect to consumer timed out")
                    except OSError as e:
                        # refused/reset: the consumer may be restarting
                        # — back off and retry until the deadline
                        self._sock = None
                        last_err = str(e)
                if time.monotonic() >= deadline:
                    if last_err is not None:
                        raise ChannelAttachRefused(
                            f"connect failed: {last_err}")
                    raise ChannelTimeout(
                        f"consumer endpoint for channel {self.id} not "
                        f"published (peer dead before attach?)")
                delay = min(1.0, 0.02 * (2 ** min(attempt, 10))) \
                    * (0.5 + random.random())
                attempt += 1
                time.sleep(min(delay,
                               max(0.0,
                                   deadline - time.monotonic())))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _check_ident(self, timeout: Optional[float]):
        """Finish the producer's channel-id handshake; resumable — a
        0-timeout poll that catches the connection mid-handshake keeps
        its progress instead of desynchronizing the frame stream."""
        while self._ident_left > 0:
            got = self._fill(self._ident_left, timeout)
            self._ident_left -= got
        ident = bytes(self._rbuf[:len(self.id)])
        del self._rbuf[:len(self.id)]
        if ident.decode(errors="replace") != self.id:
            self._sock.close()
            self._sock = None
            raise ChannelClosed("wrong channel id from producer")

    def _fill(self, want: int, timeout: Optional[float]) -> int:
        """recv up to `want` bytes into the resume buffer; returns the
        count (>=1) or raises ChannelTimeout with progress KEPT."""
        import socket
        self._sock.settimeout(timeout)
        try:
            chunk = self._sock.recv(max(want, 1))
        except (socket.timeout, BlockingIOError):
            raise ChannelTimeout("channel recv timed out")
        except OSError as e:           # reset/aborted: channel-typed
            raise ChannelClosed(f"peer connection lost: {e}")
        if not chunk:
            raise ChannelClosed("peer closed")
        self._rbuf += chunk
        return len(chunk)

    def _recv_exact(self, n: int, timeout: Optional[float]) -> bytes:
        """Read exactly n bytes honoring the caller's TOTAL budget;
        partial progress survives a timeout in self._rbuf, so the next
        call resumes the same frame instead of tearing the protocol."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while len(self._rbuf) < n:
            left = None
            if deadline is not None:
                left = deadline - time.monotonic()
                if len(self._rbuf) < n and left <= 0 \
                        and timeout != 0.0:
                    raise ChannelTimeout("channel recv timed out")
                left = max(left, 0.0)
            self._fill(n - len(self._rbuf), left)
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    # --- producer ------------------------------------------------------

    def _drain_acks(self, block_timeout: Optional[float] = 0.0):
        """Consume pending ACK bytes; with a timeout, wait for at least
        one (credit recovery when the window is full)."""
        import select
        import socket
        if self._sock is None or self._inflight == 0:
            return
        want_block = block_timeout != 0.0
        while self._inflight > 0:
            r, _, _ = select.select([self._sock], [], [],
                                    block_timeout if want_block else 0.0)
            if not r:
                if want_block:
                    raise ChannelTimeout("channel full (no ACK)")
                return
            self._sock.settimeout(0.0)
            try:
                data = self._sock.recv(self._inflight)
            except (BlockingIOError, socket.timeout):
                return
            except OSError as e:
                raise ChannelClosed(f"peer connection lost: {e}")
            if not data:
                raise ChannelClosed("peer closed")
            self._inflight -= len(data)
            want_block = False   # got credit; opportunistic from here

    def has_space(self) -> bool:
        # ChannelClosed propagates: reporting space on a dead peer
        # would let a fan-in driver write the other inputs first and
        # skew the streams permanently (the invariant execute() keeps)
        if self._sock is None:
            return True          # connection not yet up: first write ok
        self.flush(0.0)
        self._drain_acks(0.0)
        return self._inflight < self.nslots

    def flush(self, timeout: Optional[float] = 0.0):
        """Push enqueued frame bytes to the socket. 0.0 = best-effort
        non-blocking (the driver calls this from its sink pump); None /
        >0 = block for full drain within the budget."""
        import socket
        if not self._wbuf or self._sock is None:
            return
        self._sock.settimeout(timeout)
        while self._wbuf:
            try:
                sent = self._sock.send(self._wbuf)
            except (socket.timeout, BlockingIOError):
                if timeout == 0.0:
                    return
                raise ChannelTimeout("channel flush timed out")
            except OSError as e:
                raise ChannelClosed(f"peer connection lost: {e}")
            del self._wbuf[:sent]

    def write(self, payload, kind: int = DATA,
              timeout: Optional[float] = None):
        """Blocking-mode (stages): the whole frame is on the wire when
        this returns — a frame is never abandoned mid-send, so the
        length-prefixed stream cannot desynchronize (the timeout covers
        connect + credit; transmission completes unconditionally).
        Nonblocking-mode (driver inputs): the frame is ENQUEUED once
        credit allows and flushed opportunistically — the driver can
        always return to draining the sink, which is what ultimately
        frees the pipeline."""
        if _chaos is not None or not _chaos_loaded:
            if _chaos_op("write") == "drop":
                return              # injected lossy link: frame vanishes
        if hasattr(payload, "write_into"):
            n = payload.frame_nbytes
            data = bytearray(n)
            payload.write_into(memoryview(data))
        elif isinstance(payload, (bytes, bytearray)):
            data = payload
            n = len(data)
        else:
            # buffer-protocol payloads (numpy chunk views) go to
            # sendmsg/enqueue without an intermediate bytes() copy
            data = _as_u8(payload)
            n = data.nbytes
        if n > self.slot_bytes:
            raise ValueError(
                f"frame of {n} B exceeds channel slot size "
                f"{self.slot_bytes} B; compile the dag with a larger "
                f"slot_bytes")
        self._ensure_conn(timeout)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while self._inflight >= self.nslots:
            self.flush(0.0)
            left = None
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ChannelTimeout("channel full (no ACK)")
            self._drain_acks(left)
        hdr = n.to_bytes(4, "little") + bytes([kind])
        self._inflight += 1
        if self.nonblocking_writes:
            self._wbuf += hdr
            self._wbuf += data
            self.flush(0.0)
            return
        import socket
        # one gathered syscall, zero concatenation copies; completion
        # is unconditional (see docstring)
        self._sock.settimeout(None)
        try:
            sent = self._sock.sendmsg([hdr, data])
            want = len(hdr) + n
            if sent < want:      # short gathered send: finish the rest
                rest = (hdr + bytes(data))[sent:] if sent < len(hdr) \
                    else memoryview(data)[sent - len(hdr):]
                self._sock.sendall(rest)
        except OSError as e:
            raise ChannelClosed(f"peer connection lost: {e}")

    # --- consumer ------------------------------------------------------

    def read_with(self, fn, timeout: Optional[float] = None):
        """Resumable frame read: a timeout mid-header or mid-payload
        keeps all progress (buffered bytes + parsed header) for the
        next call — driver-side 0-timeout polls interleave safely with
        blocking gets on the same channel."""
        if _chaos is not None or not _chaos_loaded:
            if _chaos_op("read") == "drop":
                raise ChaosInjectedTimeout("chaos: injected read drop")
        self._ensure_conn(timeout)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        if self._pending_hdr is None:
            hdr = self._recv_exact(_FRAME_HDR, timeout)
            self._pending_hdr = (int.from_bytes(hdr[:4], "little"),
                                 hdr[4])
        n, kind = self._pending_hdr
        left = timeout
        if deadline is not None and timeout != 0.0:
            left = max(deadline - time.monotonic(), 0.0)
        payload = self._recv_exact(n, left) if n else b""
        self._pending_hdr = None
        try:
            return fn(kind, memoryview(payload))
        finally:
            try:
                self._sock.sendall(_ACK)   # slot released: return credit
            except OSError:
                pass

    def read_bytes(self, timeout: Optional[float] = None):
        return self.read_with(lambda k, mv: (k, bytes(mv)), timeout)

    # --- lifecycle ------------------------------------------------------

    def close(self):
        try:
            self.flush(1.0)      # best-effort: don't strand a frame
        except Exception:
            pass
        for s in (self._sock, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._sock = self._listener = None
        if self.role == "consumer":
            try:
                _kv("kv_del", key=self.KV_PREFIX + self.id)
            except Exception:
                pass

    def unlink(self):
        pass                     # no named OS resource beyond the socket

    def spec(self) -> dict:
        return {"type": "tcp", "id": self.id, "nslots": self.nslots,
                "slot_bytes": self.slot_bytes}


def new_tcp_spec(nslots: int, slot_bytes: int) -> dict:
    return {"type": "tcp", "id": uuid.uuid4().hex[:16],
            "nslots": nslots, "slot_bytes": slot_bytes}


def spec_transport(spec: dict) -> str:
    """"tcp" or "shm" for an edge spec — the transport label
    ``RingReducer.from_spec`` stamps onto its flight-recorder summary,
    so a collective post-mortem says whether the hung/slow edge was a
    cross-host TCP link or same-host shm without the spec in hand."""
    return "tcp" if spec.get("type") == "tcp" else "shm"


def attach_channel(spec: dict, role: str, timeout: float = 60.0,
                   abort=None):
    """Attach either channel flavor: shm specs are role-agnostic, tcp
    specs bind/connect per role ('producer' | 'consumer').

    ``abort``: optional zero-arg predicate polled by the lazy-shm
    producer wait (the only attach path that blocks); returning True
    raises ChannelTimeout immediately — elastic training points this
    at its regroup event so a group rewire can interrupt an attach
    against a dead incarnation's specs instead of waiting it out.

    ``lazy`` shm specs cover co-located NON-driver stages: the driver
    can't create a segment on a remote host, so the consumer creates it
    at attach (and owns the unlink) while the producer polls for the
    name — same-host peers still get the two-memcpy ring instead of
    paying the TCP path."""
    if spec.get("type") == "tcp":
        return TcpChannel(spec, role)
    if spec.get("lazy"):
        if role == "consumer":
            try:
                ch = ShmRingChannel(spec["name"], nslots=spec["nslots"],
                                    slot_bytes=spec["slot_bytes"],
                                    create=True)
            except FileExistsError:
                # The consumer OWNS this name; an existing segment is a
                # stale leak from a crashed previous incarnation (names
                # are incarnation-unique) — reclaim it, don't fail.
                from multiprocessing import shared_memory as _shm
                _shm.SharedMemory(name=spec["name"]).unlink()
                ch = ShmRingChannel(spec["name"], nslots=spec["nslots"],
                                    slot_bytes=spec["slot_bytes"],
                                    create=True)
            ch._lazy_owner = True
            return ch
        deadline = time.monotonic() + timeout
        while True:
            try:
                return ShmRingChannel.attach(spec)
            except (FileNotFoundError, ValueError):
                # ValueError ("cannot mmap an empty file"): the
                # consumer is mid-create — shm_open done, ftruncate
                # not yet — so the name exists at 0 bytes for a
                # moment; the same transient as not-yet-created
                if abort is not None and abort():
                    raise ChannelTimeout(
                        f"attach of lazy shm channel {spec['name']} "
                        f"aborted (group reshaped)")
                if time.monotonic() > deadline:
                    raise ChannelTimeout(
                        f"lazy shm channel {spec['name']} never "
                        f"created by its consumer")
                time.sleep(0.01)
    return ShmRingChannel.attach(spec)
