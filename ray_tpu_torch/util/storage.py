"""Pluggable storage backends for checkpoints and object spill.

Reference: python/ray/train/_internal/storage.py (checkpoints go to any
pyarrow-filesystem URI) and _private/external_storage.py:399 (objects
spill to S3 via smart_open). On TPU pods the VMs are ephemeral, so
"storage_path is a local directory" is not enough — checkpoint/spill
must be able to leave the machine.

Backends, selected by URI scheme:

- plain path / ``file://``  -> local filesystem (the default)
- ``memory://`` / ``kv://`` -> the cluster control service's KV store:
  durable as the head (which persists its KV via runtime/persistence),
  reachable from every node — the in-cluster "remote storage" used by
  tests and small runs. Implemented over a tiny SYNC frame client so it
  also works from inside event-loop threads (the agent's spill path).
- ``gs://`` / ``s3://`` / ``gcs://`` -> fsspec, when installed; a clear
  error otherwise (the image has no cloud SDKs — gated, not stubbed).

Only five primitives (put/get/exists/list/delete) — directory
upload/download are generic walks over them.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import List, Optional, Tuple

_LEN = struct.Struct("<Q")
_REQUEST = 0  # mirrors runtime/rpc.py framing
_KV_PREFIX = "__storage:"


def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename into it is durable — on a crash
    right after os.replace the new directory entry may otherwise never
    reach disk (POSIX renames are atomic but not durable without it).
    Best-effort on filesystems that refuse O_DIRECTORY fsync."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-consistent local file write: tmp + flush + fsync +
    rename + directory fsync. After this returns the file is durably
    either the OLD content or the NEW content — never a torn mix and
    never an empty rename that a crash mid-write could leave behind.
    The write-side half of every commit-marker contract (checkpoint
    manifests, the ``_latest_checkpoint.json`` resume pointer)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def atomic_write_json(path: str, obj) -> None:
    import json
    atomic_write_bytes(path, json.dumps(obj).encode())


def parse_uri(uri: str) -> Tuple[Optional[str], str]:
    """("gs", "bucket/x") for "gs://bucket/x"; (None, path) otherwise."""
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme.lower(), rest
    return None, uri


def is_remote(uri: Optional[str]) -> bool:
    if not uri:
        return False
    scheme, _ = parse_uri(uri)
    return scheme not in (None, "file")


class Storage:
    """Five primitives; everything else is generic."""

    def put_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, path: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    # -- generic directory ops ------------------------------------------

    def delete_prefix(self, prefix: str) -> None:
        for p in self.list(prefix):
            self.delete(p)

    def upload_dir(self, local_dir: str, remote_prefix: str) -> None:
        local_dir = os.path.abspath(local_dir)
        for root, _dirs, files in os.walk(local_dir):
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, local_dir)
                with open(full, "rb") as fh:
                    self.put_bytes(
                        f"{remote_prefix.rstrip('/')}/{rel}", fh.read())

    def download_dir(self, remote_prefix: str, local_dir: str) -> int:
        remote_prefix = remote_prefix.rstrip("/")
        n = 0
        for p in self.list(remote_prefix + "/"):
            rel = p[len(remote_prefix) + 1:]
            dst = os.path.join(local_dir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            data = self.get_bytes(p)
            if data is None:
                continue
            with open(dst, "wb") as fh:
                fh.write(data)
            n += 1
        return n


class LocalStorage(Storage):
    def put_bytes(self, path: str, data: bytes) -> None:
        # atomic AND durable (fsync file + dir): checkpoint shards and
        # commit markers ride this primitive, and a marker that can
        # evaporate in a crash right after the rename defeats the
        # two-phase commit it exists to anchor
        atomic_write_bytes(path, data)

    def get_bytes(self, path: str) -> Optional[bytes]:
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def list(self, prefix: str) -> List[str]:
        out = []
        base = prefix if os.path.isdir(prefix) else os.path.dirname(prefix)
        for root, _d, files in os.walk(base):
            for f in files:
                full = os.path.join(root, f)
                if full.startswith(prefix):
                    out.append(full)
        return out

    def delete(self, path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


class _SyncFrameClient:
    """Minimal blocking client for the runtime's length-prefixed pickle
    RPC (runtime/rpc.py framing). Unlike ConnectionPool it needs no
    event loop, so spill can call it from the agent's loop thread and
    train workers from arbitrary threads. One connection, serialized by
    a lock — storage traffic is coarse (whole files)."""

    def __init__(self, addr: Tuple[str, int]):
        self.addr = (addr[0], int(addr[1]))
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._next_id = 0

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=30.0)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self._sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("storage control connection closed")
            buf += part
        return buf

    def call(self, method: str, **payload):
        with self._lock:
            for attempt in (0, 1):
                try:
                    self._connect()
                    self._next_id += 1
                    body = pickle.dumps(
                        (_REQUEST, self._next_id, method, payload),
                        protocol=5)
                    self._sock.sendall(_LEN.pack(len(body)) + body)
                    (n,) = _LEN.unpack(self._read_exact(_LEN.size))
                    kind, _mid, err, result = pickle.loads(
                        self._read_exact(n))
                    if kind == 2:  # REPLY_ERR
                        raise RuntimeError(f"storage rpc failed: {err}")
                    return result
                except (OSError, ConnectionError):
                    # stale connection (head restart): reconnect once
                    try:
                        if self._sock is not None:
                            self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                    if attempt:
                        raise


class KVStorage(Storage):
    """Cluster-KV-backed storage (memory:// or kv://): every node can
    read it, and it survives anything the head survives."""

    def __init__(self, head_addr: Tuple[str, int]):
        self._client = _SyncFrameClient(head_addr)

    def _key(self, path: str) -> str:
        return _KV_PREFIX + path

    def put_bytes(self, path: str, data: bytes) -> None:
        self._client.call("kv_put", key=self._key(path), value=data,
                          overwrite=True)

    def get_bytes(self, path: str) -> Optional[bytes]:
        return self._client.call("kv_get", key=self._key(path))

    def exists(self, path: str) -> bool:
        return self.get_bytes(path) is not None

    def list(self, prefix: str) -> List[str]:
        keys = self._client.call("kv_keys", prefix=self._key(prefix))
        return [k[len(_KV_PREFIX):] for k in keys or []]

    def delete(self, path: str) -> None:
        self._client.call("kv_del", key=self._key(path))


class FsspecStorage(Storage):
    """gs:// s3:// etc. through fsspec, when the image provides it."""

    def __init__(self, scheme: str):
        try:
            import fsspec
        except ImportError as e:
            raise RuntimeError(
                f"{scheme}:// storage needs fsspec (+ the {scheme} "
                "driver), which this image does not provide; use "
                "memory:// (cluster KV) or a shared mount") from e
        self._fs = fsspec.filesystem(scheme)
        self._scheme = scheme

    def put_bytes(self, path: str, data: bytes) -> None:
        with self._fs.open(path, "wb") as f:
            f.write(data)

    def get_bytes(self, path: str) -> Optional[bytes]:
        try:
            with self._fs.open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def list(self, prefix: str) -> List[str]:
        try:
            return [p for p in self._fs.find(os.path.dirname(prefix))
                    if p.startswith(prefix)]
        except FileNotFoundError:
            return []

    def delete(self, path: str) -> None:
        try:
            self._fs.rm(path)
        except FileNotFoundError:
            pass


def _head_addr() -> Optional[Tuple[str, int]]:
    """This process's control-service address: the api context when
    initialized, else the worker-spawn env."""
    try:
        from ray_tpu_torch import api
        if api._g.ctx is not None:
            return tuple(api._g.ctx.head_addr)
    except Exception:
        pass
    host = os.environ.get("RAY_TPU_HEAD_HOST")
    port = os.environ.get("RAY_TPU_HEAD_PORT")
    if host and port:
        return (host, int(port))
    return None


_BACKENDS: dict = {}
_BACKENDS_LOCK = threading.Lock()


def get_storage(uri: str,
                head_addr: Optional[Tuple[str, int]] = None
                ) -> Tuple[Storage, str]:
    """(backend, path-inside-backend) for a storage URI. Backends are
    cached per (scheme, address) so repeated calls — report() every
    step, spill, retention — reuse one connection instead of opening a
    socket per call."""
    scheme, path = parse_uri(uri)
    if scheme in (None, "file"):
        key = ("local",)
    elif scheme in ("memory", "kv"):
        addr = head_addr or _head_addr()
        if addr is None:
            raise RuntimeError(
                "memory:// storage needs a running cluster (no control "
                "service address in this process)")
        key = ("kv", addr[0], int(addr[1]))
    else:
        key = ("fsspec", scheme)
    with _BACKENDS_LOCK:
        backend = _BACKENDS.get(key)
        if backend is None:
            if key[0] == "local":
                backend = LocalStorage()
            elif key[0] == "kv":
                backend = KVStorage((key[1], key[2]))
            else:
                backend = FsspecStorage(scheme)
            _BACKENDS[key] = backend
    return backend, path
