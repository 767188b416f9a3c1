"""Durable control-plane state: append-only table logs + replay.

The framework's analog of GCS persistence (reference:
src/ray/gcs/store_client/redis_store_client.h:126 and gcs/gcs_init_data.h —
the reference persists GCS tables to Redis so a restarted GCS rebuilds its
state and raylets reconnect). Here the control service appends every table
mutation to a per-table log under ``persist_dir``; a restarting control
service replays the logs, then nodes re-register on their next heartbeat
(the inverse of the reference's NotifyGCSRestart push).

Format per record: 4-byte LE length + pickled ``(op, key, value)`` where op
is "put" or "del". Logs are compacted on load (rewritten from the replayed
state) and again online whenever a table's log grows past a multiple of its
last-compacted size, so they stay proportional to live state, not mutation
count.

Durability: ``fsync`` batching. Every append is written to the OS
immediately (survives a *process* crash unconditionally); fsync — which is
what makes an acked write survive a *host/power* failure — runs at most
once per ``fsync_interval_s`` per table, amortising the ~ms device flush
across bursts while bounding the at-risk window. ``fsync=True`` keeps the
old sync-every-record behavior; ``flush()`` forces pending syncs (the
control service calls it from its health loop).
"""

from __future__ import annotations

import os
import pickle
import struct
import time
from typing import Any, Dict, Optional

_LEN = struct.Struct("<I")


class FileStore:
    """Append-only per-table logs under one directory."""

    # a table's log may grow to this multiple of its last-compacted size
    # (floored at _COMPACT_MIN_BYTES) before an online compaction
    COMPACT_GROWTH_FACTOR = 8
    _COMPACT_MIN_BYTES = 1 << 20

    def __init__(self, root: str, fsync: bool = False,
                 fsync_interval_s: float = 0.05):
        self.root = root
        self.fsync = fsync                      # sync EVERY record
        self.fsync_interval_s = fsync_interval_s
        os.makedirs(root, exist_ok=True)
        self._files: Dict[str, Any] = {}
        self._last_sync: Dict[str, float] = {}  # table -> last fsync time
        self._dirty: Dict[str, bool] = {}       # appended since last fsync
        self._log_bytes: Dict[str, int] = {}    # current log size
        self._base_bytes: Dict[str, int] = {}   # size at last compaction

    def _path(self, table: str) -> str:
        return os.path.join(self.root, f"{table}.log")

    def _file(self, table: str):
        f = self._files.get(table)
        if f is None:
            f = open(self._path(table), "ab", buffering=0)
            self._files[table] = f
            self._log_bytes[table] = f.tell()
            self._base_bytes.setdefault(table, f.tell())
        return f

    def _append(self, table: str, rec: tuple) -> None:
        payload = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
        f = self._file(table)
        f.write(_LEN.pack(len(payload)) + payload)
        self._log_bytes[table] = self._log_bytes.get(table, 0) \
            + _LEN.size + len(payload)
        if self.fsync:
            os.fsync(f.fileno())
            return
        now = time.monotonic()
        if now - self._last_sync.get(table, 0.0) >= self.fsync_interval_s:
            os.fsync(f.fileno())
            self._last_sync[table] = now
            self._dirty[table] = False
        else:
            self._dirty[table] = True

    def flush(self) -> None:
        """fsync every table with appends newer than its last sync."""
        for table, dirty in list(self._dirty.items()):
            if dirty and table in self._files:
                try:
                    os.fsync(self._files[table].fileno())
                    self._last_sync[table] = time.monotonic()
                    self._dirty[table] = False
                except OSError:
                    pass

    def should_compact(self, table: str) -> bool:
        """True when the table's log has grown past
        COMPACT_GROWTH_FACTOR x its last-compacted size — the caller
        (who owns the live state) then calls :meth:`compact`."""
        size = self._log_bytes.get(table)
        if size is None:
            return False
        base = max(self._base_bytes.get(table, 0), self._COMPACT_MIN_BYTES)
        return size > base * self.COMPACT_GROWTH_FACTOR

    def put(self, table: str, key: Any, value: Any) -> None:
        self._append(table, ("put", key, value))

    def delete(self, table: str, key: Any) -> None:
        self._append(table, ("del", key, None))

    def load_table(self, table: str) -> Dict[Any, Any]:
        """Replay one table's log; truncated tails (crash mid-append) are
        dropped."""
        state: Dict[Any, Any] = {}
        path = self._path(table)
        if not os.path.exists(path):
            return state
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _LEN.size <= len(data):
            (n,) = _LEN.unpack_from(data, off)
            if off + _LEN.size + n > len(data):
                break                      # torn tail record
            try:
                op, key, value = pickle.loads(
                    data[off + _LEN.size: off + _LEN.size + n])
            except Exception:
                break                      # corrupt tail
            if op == "put":
                state[key] = value
            else:
                state.pop(key, None)
            off += _LEN.size + n
        return state

    def load_all(self) -> Dict[str, Dict[Any, Any]]:
        tables = {}
        for fn in os.listdir(self.root):
            if fn.endswith(".log"):
                name = fn[:-4]
                tables[name] = self.load_table(name)
        return tables

    def compact(self, table: str, state: Dict[Any, Any]) -> None:
        """Rewrite a table's log to exactly the given state."""
        f = self._files.pop(table, None)
        if f is not None:
            f.close()
        tmp = self._path(table) + ".tmp"
        size = 0
        with open(tmp, "wb") as out:
            for key, value in state.items():
                payload = pickle.dumps(("put", key, value),
                                       protocol=pickle.HIGHEST_PROTOCOL)
                out.write(_LEN.pack(len(payload)) + payload)
            out.flush()
            os.fsync(out.fileno())
            size = out.tell()
        os.replace(tmp, self._path(table))
        self._log_bytes[table] = size
        self._base_bytes[table] = size
        self._dirty[table] = False

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()
