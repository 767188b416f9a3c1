"""Hang & desync forensics: the cross-rank collective ledger.

The framework's worst failure mode is the silent distributed hang:
ranks disagree on the next collective (seq, kind, codec options) and
the ring blocks until a wall-clock timeout with zero diagnosis. Every
other observability plane (ring trace, devmon, goodput) is per-rank;
this module holds the pieces that compare ledgers ACROSS ranks:

  * ``CollectiveLedger`` — a bounded per-rank ring of collective
    descriptors (group, seq, kind, bytes, codec, options-signature
    hash, enter/exit stamps, state enqueued|in_flight|done|aborted),
    fed from dag/ring.py's round lifecycle and train/collective.py's
    enqueue points. Recording is two dict writes per round — the
    clock reads piggyback on the ones the round-level trace already
    pays, so the default-level overhead stays within noise
    (FORENSICS_BENCH.json).
  * ``audit`` — the pure cross-rank diff: given every rank's ledger
    snapshot it names the culprit — "rank 3 never entered seq 141 of
    group zero/g7", or "seq 141 options-signature mismatch: rank 0
    int4 vs rank 2 fp32".
  * ``write_bundle`` — the one-command postmortem: stacks + ledgers +
    engine state + recent events + HBM + goodput anatomy, atomically
    written as ``postmortem-<step>.json`` (CLI: ``ray-tpu autopsy``).
  * typed errors (``CollectiveDesyncError`` / ``CollectiveStallError``)
    the opt-in pre-flight guard (Config.forensics_verify_level) raises
    instead of letting the ring hang.

The ledger is process-global (one per worker process, like goodput):
every ring instance in the process appends to it, namespaced by its
group id, so a single RPC pull sees the whole rank's collective
history in issue order.

The port's copy of ``ray_tpu/util/forensics.py``, unchanged but for
import paths; ``local_dump``'s HBM rows come from the port's
``util/devmon.hbm_snapshot`` (``torch.cuda``), and bundles land under
``<tmp>/ray_tpu_torch_forensics`` unless ``Config.forensics_dir`` says
otherwise.
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
    — the FORENSICS_BENCH off arm). Checked once per ring construction,
    not per round."""
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


def reset() -> None:
    global _ledger, _rank
    with _ledger_lock:
        _ledger = None
    _rank = -1
    _meta.clear()


def snapshot() -> dict:
    """The full per-rank ledger view the cross-rank audit diffs."""
    led = ledger()
    return {"rank": _rank, "now": time.time(), "meta": dict(_meta),
            "entries": led.snapshot(), "max_seq": led.max_seq()}


def poll_summary() -> Optional[dict]:
    """The tiny never-raise summary that rides the train worker's
    poll() payload: just the in-flight rows (with ages) and per-group
    issue counters — enough for the controller watchdog to decide
    whether to pull full ledgers."""
    try:
        if not enabled():
            return None
        led = ledger()
        now = time.time()
        inflight = [{"group": e["group"], "seq": e["seq"],
                     "kind": e["kind"], "codec": e["codec"],
                     "step": e["step"], "age_s": now - e["t_enter"]}
                    for e in led.snapshot()
                    if e["state"] == "in_flight"]
        return {"rank": _rank, "inflight": inflight,
                "max_seq": led.max_seq()}
    except Exception:   # noqa: BLE001 — poll must never raise
        return None


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


# --- the cross-rank audit -------------------------------------------------


def audit(ledgers: Dict[int, dict],
          stall_timeout_s: float = 60.0) -> List[dict]:
    """Diff every rank's ledger snapshot and name the culprit.

    ``ledgers`` maps rank -> ``snapshot()`` dicts. Findings (newest
    collective first):

      * ``collective_desync`` — two ranks hold the same (group, seq)
        with different options signatures (a codec or option that one
        rank changed alone). The culprits are the minority side (or
        all, on an even split).
      * ``collective_stall`` — some ranks are in_flight at (group,
        seq) past the timeout while others never issued that seq
        ("rank 3 never entered seq 141 of group zero/g7"), or every
        rank entered and a subset is stuck while peers finished.

    Pure function — no clock reads besides each snapshot's own ``now``
    stamp, so it is unit-testable with synthetic ledgers."""
    findings: List[dict] = []
    ranks = sorted(ledgers)
    # index: (group, seq) -> {rank: entry}
    by_cs: Dict[tuple, Dict[int, dict]] = {}
    for r in ranks:
        for e in ledgers[r].get("entries", ()):
            if e.get("kind") is None or e.get("group") is None:
                continue
            if e.get("state") == "enqueued":
                continue             # intent rows have their own seqs
            by_cs.setdefault((e["group"], e["seq"]), {})[r] = e
    seen_stall: set = set()
    for (group, seq) in sorted(by_cs, key=lambda k: (k[0], -k[1])):
        ents = by_cs[(group, seq)]
        # -- desync: differing options signature at the same slot
        sigs = {}
        for r, e in ents.items():
            tag = (e.get("sig") or "", e.get("codec"), e.get("op"))
            sigs.setdefault(tag, []).append(r)
        if len(sigs) > 1:
            groups = sorted(sigs.items(),
                            key=lambda kv: (len(kv[1]), kv[1]))
            culprits = sorted(groups[0][1]) if \
                len(groups[0][1]) < len(groups[-1][1]) else \
                sorted(r for _, rs in groups for r in rs)
            detail = (f"seq {seq} options-signature mismatch on group "
                      f"{group}: " + " vs ".join(
                          f"rank {rs[0]} "
                          f"{ents[rs[0]].get('codec') or ents[rs[0]].get('sig') or 'fp32'}"
                          for _, rs in groups))
            findings.append({"kind": "collective_desync", "group": group,
                             "seq": seq, "culprits": culprits,
                             "detail": detail})
            continue
        # -- stall: someone is in_flight past the timeout at this slot
        stuck = [r for r, e in ents.items()
                 if e.get("state") == "in_flight" and
                 ledgers[r].get("now", 0) - e.get("t_enter", 0)
                 >= stall_timeout_s]
        if not stuck or group in seen_stall:
            continue
        seen_stall.add(group)
        absent = []
        for r in ranks:
            if r in ents:
                continue
            if ledgers[r].get("max_seq", {}).get(group, 0) < seq:
                absent.append(r)
        e0 = ents[stuck[0]]
        kind = e0.get("kind", "collective")
        if absent:
            who = ", ".join(f"rank {r}" for r in absent)
            detail = (f"{who} never entered seq {seq} of group {group} "
                      f"({kind}); {len(stuck)} rank(s) blocked in it "
                      f"for >= {stall_timeout_s:.0f}s")
            culprits = absent
        else:
            done = sorted(r for r, e in ents.items()
                          if e.get("state") in _TERMINAL)
            who = ", ".join(f"rank {r}" for r in sorted(stuck))
            detail = (f"{who} stuck in seq {seq} of group {group} "
                      f"({kind}) while "
                      f"{'ranks ' + str(done) if done else 'no peer'} "
                      f"finished it")
            culprits = sorted(stuck)
        findings.append({"kind": "collective_stall", "group": group,
                         "seq": seq, "culprits": culprits,
                         "detail": detail})
    return findings


# --- postmortem bundles ---------------------------------------------------


def bundle_dir() -> str:
    """Config.forensics_dir, or <tmp>/ray_tpu_torch_forensics."""
    import os
    import tempfile
    d = ""
    try:
        from ray_tpu_torch.config import get_config
        d = str(getattr(get_config(), "forensics_dir", "") or "")
    except Exception:   # noqa: BLE001
        pass
    return d or os.path.join(tempfile.gettempdir(),
                             "ray_tpu_torch_forensics")


def local_dump() -> dict:
    """Everything THIS process can contribute to a bundle: its ledger,
    stacks, goodput anatomy, HBM snapshot, and registered engine
    state. Never raises — each section degrades to an error string."""
    import os
    out: Dict[str, Any] = {"pid": os.getpid(), "rank": _rank,
                           "meta": dict(_meta), "now": time.time()}
    try:
        out["ledger"] = snapshot()
    except Exception as e:   # noqa: BLE001
        out["ledger"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ray_tpu_torch.util import profiling
        out["stacks"] = profiling.dump_stacks()
    except Exception as e:   # noqa: BLE001
        out["stacks"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from ray_tpu_torch.util import goodput
        rows = goodput.recent_rows()
        out["goodput"] = rows[-8:] if rows else []
    except Exception:   # noqa: BLE001
        out["goodput"] = []
    try:
        from ray_tpu_torch.util import devmon
        out["hbm"] = devmon.hbm_snapshot(record=False)
    except Exception:   # noqa: BLE001
        out["hbm"] = None
    try:
        out["state"] = provider_states()
    except Exception:   # noqa: BLE001
        out["state"] = {}
    return out


def write_bundle(payload: dict, *, step: Optional[int] = None,
                 directory: Optional[str] = None) -> str:
    """Atomically write one postmortem bundle; returns the path. The
    name is ``postmortem-<step>.json`` per the runbook — on-demand
    autopsies with no step context get a millisecond stamp instead so
    repeated pulls never clobber each other."""
    import os
    from ray_tpu_torch.util import storage
    d = directory or bundle_dir()
    os.makedirs(d, exist_ok=True)
    tag = str(step) if step is not None else f"t{int(time.time() * 1e3)}"
    path = os.path.join(d, f"postmortem-{tag}.json")
    payload = dict(payload)
    payload.setdefault("written_at", time.time())
    payload.setdefault("step", step)
    storage.atomic_write_json(path, payload)
    try:
        forensics_metrics()["bundles"].inc()
    except Exception:   # noqa: BLE001
        pass
    return path


# --- metrics --------------------------------------------------------------

_metrics: Optional[Dict[str, Any]] = None


def forensics_metrics() -> Dict[str, Any]:
    """Lazy singleton registry, mirroring goodput_metrics():
    ``forensics_stall_rank`` (the health sentinel: -1 healthy, else
    the culprit rank of the last audit finding),
    ``forensics_audits_total``, ``forensics_bundles_total``."""
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.util import metrics as m
        _metrics = {
            "stall_rank": m.Gauge(
                "forensics_stall_rank",
                "Culprit rank named by the last collective audit "
                "finding (-1 = healthy)"),
            "audits": m.Counter(
                "forensics_audits_total",
                "Cross-rank collective ledger audits run"),
            "bundles": m.Counter(
                "forensics_bundles_total",
                "Postmortem bundles written"),
        }
        _metrics["stall_rank"].set(-1.0)
    return _metrics
