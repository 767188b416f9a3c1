"""Forensics: the per-rank collective ledger and the engine/queue state
providers.

The port's copy of the parts of ``ray_tpu/util/forensics.py`` that the
port's code calls:

  * ``CollectiveLedger`` — a bounded per-rank ring of collective
    descriptors (group, seq, kind, bytes, codec, options-signature
    hash, enter/exit stamps, state enqueued|in_flight|done|aborted),
    fed from dag/ring.py's round lifecycle and train/collective.py's
    enqueue points; process-global (``ledger()``), namespaced by group.
  * the typed errors (``CollectiveDesyncError`` /
    ``CollectiveStallError``) the opt-in pre-flight guard
    (Config.forensics_verify_level, train/collective.py) raises.
  * the state-provider registry: components register a zero-argument
    callable whose value a postmortem bundle would carry under
    ``state.<name>`` (the ``LLMEngine`` registers its ``stats``).

The cross-rank audit, the bundle writer and the postmortem wait for
ROADMAP.md's Queue 1 item 17.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

_STATES = ("enqueued", "in_flight", "done", "aborted")
_TERMINAL = ("done", "aborted")


class CollectiveDesyncError(RuntimeError):
    """Ranks disagreed on a collective's options signature — the bug
    class that otherwise decodes garbage frames or hangs the ring.
    Carries ``group``/``seq``/``culprits`` for programmatic triage."""

    def __init__(self, detail: str, *, group: str = "", seq: int = -1,
                 culprits: Optional[List[int]] = None):
        super().__init__(detail)
        self.group, self.seq = group, int(seq)
        self.culprits = list(culprits or [])


class CollectiveStallError(RuntimeError):
    """A rank never arrived at a collective every peer entered (parked
    before the call, or issuing a different sequence)."""

    def __init__(self, detail: str, *, group: str = "", seq: int = -1,
                 culprits: Optional[List[int]] = None):
        super().__init__(detail)
        self.group, self.seq = group, int(seq)
        self.culprits = list(culprits or [])


def sig_hash(sig: Any) -> str:
    """Stable short hash of an options signature (any repr-able value):
    what rides the ledger and the pre-flight agreement instead of the
    full layout tuple."""
    if sig is None:
        return ""
    return hashlib.blake2s(repr(sig).encode(), digest_size=4).hexdigest()


class CollectiveLedger:
    """Bounded ring of collective descriptors for ONE process."""

    def __init__(self, size: int = 256):
        self._buf: deque = deque(maxlen=max(8, int(size)))
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}       # per-group issue counter
        self._next = 0                       # token allocator

    def next_seq(self, group: str) -> int:
        with self._lock:
            s = self._seq.get(group, 0) + 1
            self._seq[group] = s
            return s

    def enter(self, *, group: str, kind: str, seq: int,
              op: Optional[str] = None, codec: Optional[str] = None,
              step: Optional[int] = None, size: int = 0,
              gen: Optional[int] = None, nbytes: int = 0,
              state: str = "in_flight") -> int:
        """Open a descriptor; returns a token for note()/exit()."""
        e = {"group": group, "kind": kind, "seq": int(seq),
             "op": op, "codec": codec, "sig": "", "bytes": int(nbytes),
             "step": step, "size": int(size), "gen": gen,
             "state": state, "t_enter": time.time(), "t_exit": None,
             "err": None}
        with self._lock:
            e["tok"] = self._next
            self._next += 1
            self._buf.append(e)
        return e["tok"]

    def record(self, **kw) -> int:
        """One-shot record (the 'enqueued' intent rows train-plane call
        sites add before the ring round opens its own in_flight row)."""
        kw.setdefault("state", "enqueued")
        return self.enter(**kw)

    def _find(self, tok: int) -> Optional[dict]:
        for e in reversed(self._buf):
            if e["tok"] == tok:
                return e
        return None

    def note(self, tok: int, **kw) -> None:
        """Update open-descriptor fields (sig discovered at header
        time, codec after option resolution)."""
        with self._lock:
            e = self._find(tok)
            if e is not None and e["state"] not in _TERMINAL:
                e.update(kw)

    def exit(self, tok: int, state: str = "done",
             err: Optional[str] = None, nbytes: Optional[int] = None) \
            -> None:
        """Close a descriptor. Idempotent: the FIRST terminal state
        wins — abort() stamping 'aborted' from another thread must not
        be overwritten by the op's own finally-path exit (and a
        post-abort audit must never see a phantom in-flight row)."""
        if state not in _TERMINAL:
            raise ValueError(f"exit state must be one of {_TERMINAL}")
        with self._lock:
            e = self._find(tok)
            if e is None or e["state"] in _TERMINAL:
                return
            e["state"] = state
            e["t_exit"] = time.time()
            if err is not None:
                e["err"] = str(err)[:240]
            if nbytes is not None:
                e["bytes"] = int(nbytes)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._buf]

    def max_seq(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._seq)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seq.clear()


# --- process-global state -------------------------------------------------

_ledger: Optional[CollectiveLedger] = None
_ledger_lock = threading.Lock()
_rank = -1
_meta: Dict[str, Any] = {}


def enabled() -> bool:
    """Ledger on/off (Config.forensics_ledger / RAY_TPU_FORENSICS_LEDGER
    — the JAX package's FORENSICS_BENCH.json off arm). Checked once
    per ring construction, not per round."""
    try:
        from ray_tpu_torch.config import get_config
        return bool(getattr(get_config(), "forensics_ledger", True))
    except Exception:   # noqa: BLE001 — forensics must never break init
        return True


def ledger() -> CollectiveLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            size = 256
            try:
                from ray_tpu_torch.config import get_config
                size = int(getattr(get_config(),
                                   "forensics_ledger_size", 256))
            except Exception:   # noqa: BLE001
                pass
            _ledger = CollectiveLedger(size)
    return _ledger


def set_rank(rank: int) -> None:
    global _rank
    _rank = int(rank)


def get_rank() -> int:
    return _rank


def set_meta(**kw) -> None:
    """Process-level tags stamped on every snapshot/summary (train
    group id, incarnation generation)."""
    _meta.update(kw)


def record_enqueued(*, group: str, kind: str, step=None,
                    detail: Optional[str] = None) -> None:
    """Train-plane intent row: 'this rank is about to issue a
    collective on this group' — written BEFORE the ring round opens,
    so a rank that parks between enqueue and enter still shows intent
    in the audit."""
    try:
        if not enabled():
            return
        led = ledger()
        led.record(group=group, kind=kind, seq=led.next_seq(f"q:{group}"),
                   op=detail, step=step)
    except Exception:   # noqa: BLE001 — bookkeeping must never raise
        pass



# --- engine/queue state providers ----------------------------------------

_providers: Dict[str, Callable[[], Any]] = {}
_providers_lock = threading.Lock()


def register_state_provider(name: str, fn: Callable[[], Any]) -> None:
    """Register a zero-argument callable whose return value rides every
    postmortem bundle under ``state.<name>`` (LLM engines register
    their queue/admission stats here). Use a weakref-closing closure
    for owner-bound state so registration never extends a lifetime."""
    with _providers_lock:
        _providers[name] = fn


def unregister_state_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


def provider_states() -> Dict[str, Any]:
    with _providers_lock:
        items = list(_providers.items())
    out: Dict[str, Any] = {}
    for name, fn in items:
        try:
            v = fn()
            if v is not None:
                out[name] = v
        except Exception as e:   # noqa: BLE001 — one bad provider
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out
