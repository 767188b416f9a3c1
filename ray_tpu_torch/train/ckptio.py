"""Durable async sharded checkpointing + the preemption plane.

The port's copy of ``ray_tpu/train/ckptio.py``, on numpy pytrees as the
JAX package's: a torch train state crosses through
``parallel/mesh.state_to_numpy``/``state_from_numpy``, and torch leaves
handed to ``save`` (a ``ShardedOptimizer``'s state on the card) are
staged to the host as the train plane stages them (dag/ring.py
``to_host``).

The train plane's answer to whole-pod preemption — the failure mode
PR 6's in-memory peer mirrors cannot survive (a correlated loss wipes
every mirror at once). Every rank saves its OWN slice of the job:

  * the owned segment of the flat parameter space (the ZeRO-1
    ownership map — ``TrainContext.shard_bounds`` /
    ``ShardedOptimizer.shard_bounds``), and
  * its shard-local optimizer state (the per-element moments that
    exist ONLY on this rank under ZeRO-1, plus the replicated
    scalar leaves).

Save is asynchronous and crash-consistent:

  1. **snapshot** (the only step-path cost): device→host copies into
     one of ``ckpt_stage_buffers`` staging slots — double-buffered,
     so the background writer can still be shipping step k while the
     step-path snapshots k+1; when the writer falls behind, ``save``
     blocks (backpressure, never a silent drop);
  2. **shard write** (background thread): the payload lands as
     ``<space>.shard-NNNNN-of-MMMMM.npz`` followed by a per-shard
     meta JSON carrying a sha256 content hash — both atomic at the
     storage layer (tmp+fsync+rename locally, single-put on KV);
  3. **manifest commit** (rank 0's writer): waits for every rank's
     shard meta, then writes ``MANIFEST.json`` — step, per-rank
     shard_bounds, group topology, per-shard hashes — via the same
     atomic primitive, and only THEN advances the
     ``_latest_checkpoint.json`` resume pointer.

A checkpoint without its manifest is invisible to restore: any crash
mid-save or mid-commit leaves either the previous complete checkpoint
or nothing — never a torn mix (the chaos suite SIGKILLs both windows
and asserts exactly that).

Restore is world-size independent: the manifest records the OLD
split, ``restore`` re-slices the flat space to the CURRENT rank/world
(or pipeline stage-group layout) — resuming 8 ranks' state on 6, or
growing to 12, is the same code path as resuming in place (the
portable-collectives redistribution argument of arxiv 2112.01075,
applied to storage instead of the wire).

The preemption plane rides the runtime worker's SIGTERM hook: a
preempted worker gets ``Config.preempt_grace_s`` to run the hooks
registered here — the checkpointer flushes its in-flight save (and a
watched-but-unsaved final delta), the ZeRO optimizer mirrors its
shard to the ring successor, metrics drain — before the exit
backstop. ``TrainWorker.poll`` surfaces the ``preempted()`` flag so
the controller treats advance-notice preemption as "reshape or
restore proactively", not as a crash.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST_NAME = "MANIFEST.json"
POINTER_NAME = "_latest_checkpoint.json"
FORMAT = "ray_tpu_torch.ckpt/1"
DEFAULT_SPACE = "zero"

_CKPT_RE = re.compile(r"ckpt-(\d{8})$")


class CkptError(RuntimeError):
    """A checkpoint cannot be saved/validated/restored as asked
    (incomplete manifest, hash mismatch, layout mismatch). Restore
    callers fall back to an older complete checkpoint; save callers
    surface it off the step path via ``flush``."""


def ckpt_metrics() -> dict:
    """Get-or-create the checkpoint plane's series (process-global
    registry, head-aggregated like every other pushed metric)."""
    from ray_tpu_torch.util import metrics as m
    return {
        "snapshot": m.Histogram(
            "ckpt_snapshot_s",
            "Step-path cost of one async checkpoint save: the "
            "device->host snapshot copy into a staging slot (plus "
            "any backpressure wait when the background writer is "
            "ckpt_stage_buffers saves behind)"),
        "save": m.Histogram(
            "ckpt_save_s",
            "Background wall time writing one rank's shard (payload "
            "+ per-shard meta) to storage — off the step path"),
        "commit": m.Histogram(
            "ckpt_commit_s",
            "Rank-0 manifest commit wall time: wait for every "
            "rank's shard meta, write MANIFEST.json atomically, "
            "advance the resume pointer"),
        "restore": m.Histogram(
            "ckpt_restore_s",
            "Wall time of one sharded restore on this rank: read "
            "the manifest + overlapping shards, re-slice to the "
            "current world size"),
        "shard_bytes": m.Gauge(
            "ckpt_shard_bytes",
            "Payload bytes of this rank's last written checkpoint "
            "shard (owned param segment + shard-local optimizer "
            "state)"),
        "last_step": m.Gauge(
            "ckpt_last_step",
            "Last step whose checkpoint this process committed "
            "(rank-0 coordinator) — the step a restart would resume "
            "from"),
        "preempt_flush": m.Counter(
            "ckpt_preempt_flush_total",
            "Final checkpoint flushes performed inside the SIGTERM "
            "preemption grace window (Config.preempt_grace_s) — "
            "saves that would have died with the worker"),
    }


# --------------------------------------------------------------------------
# deterministic chaos (Config.testing_ckpt_failure)
# --------------------------------------------------------------------------

_SITES = ("shard", "commit")
_ACTIONS = ("kill", "error", "delay", "torn")


class _CkptChaos:
    """Parsed testing_ckpt_failure rules + per-site counters (the
    checkpoint sibling of dag/channel.py ChannelChaos and
    serve/chaos.py ServeChaos)."""

    def __init__(self, spec: str):
        self.rules = []
        for part in filter(None, (spec or "").split(",")):
            bits = part.strip().split(":")
            if len(bits) < 3:
                raise ValueError(
                    f"testing_ckpt_failure rule {part!r}: expected "
                    f"<site>:<action>:<nth>[:<param>]")
            site, action, nth = bits[0], bits[1], int(bits[2])
            if site not in _SITES:
                raise ValueError(
                    f"testing_ckpt_failure site must be one of "
                    f"{_SITES}, got {site!r}")
            if action not in _ACTIONS:
                raise ValueError(
                    f"testing_ckpt_failure action must be one of "
                    f"{_ACTIONS}, got {action!r}")
            if nth < 1:
                raise ValueError(
                    f"testing_ckpt_failure nth must be >= 1, got {nth}")
            param = float(bits[3]) if len(bits) > 3 else 0.1
            self.rules.append({"site": site, "action": action,
                               "nth": nth, "param": param, "count": 0})

    def fire(self, site: str) -> Optional[Tuple[str, float]]:
        out = None
        for r in self.rules:
            if r["site"] != site:
                continue
            r["count"] += 1
            if r["count"] != r["nth"]:
                continue
            if r["action"] == "kill":
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            if r["action"] == "delay":
                time.sleep(r["param"])
                continue
            if r["action"] == "error":
                raise CkptError(
                    f"ckpt chaos: injected {site} error")
            out = (r["action"], r["param"])
        return out


_chaos: Optional[_CkptChaos] = None
_chaos_loaded = False


def _chaos_fire(site: str) -> Optional[Tuple[str, float]]:
    global _chaos, _chaos_loaded
    if not _chaos_loaded:
        from ray_tpu_torch.config import get_config
        spec = getattr(get_config(), "testing_ckpt_failure", "")
        _chaos = _CkptChaos(spec) if spec else None
        _chaos_loaded = True
    if _chaos is None:
        return None
    return _chaos.fire(site)


def reset_ckpt_chaos() -> None:
    """Re-read testing_ckpt_failure on the next save (tests flip the
    config mid-process; counters restart from zero)."""
    global _chaos, _chaos_loaded
    _chaos = None
    _chaos_loaded = False


# --------------------------------------------------------------------------
# preemption plane (the SIGTERM grace window's hook registry)
# --------------------------------------------------------------------------

_PREEMPT = threading.Event()
_HOOKS: List = []
_HOOK_LOCK = threading.Lock()


def preempted() -> bool:
    """True once this process received preemption notice (SIGTERM
    routed through the runtime worker's graceful-term handler, or a
    standalone script's ``install_sigterm_hook``). Long-running train
    loops can poll it to save-and-exit at a clean step boundary
    inside the grace window."""
    return _PREEMPT.is_set()


def on_preempt(fn) -> None:
    """Register ``fn(deadline_monotonic)`` to run inside the SIGTERM
    grace window (``Config.preempt_grace_s``), in registration order.
    Hooks must be bounded by the deadline they receive; exceptions
    are swallowed (a failing hook must not eat the others' grace)."""
    with _HOOK_LOCK:
        if fn not in _HOOKS:
            _HOOKS.append(fn)


def remove_preempt_hook(fn) -> None:
    with _HOOK_LOCK:
        if fn in _HOOKS:
            _HOOKS.remove(fn)


def reset_preemption() -> None:
    """Clear the preemption flag + hook registry (tests only — a real
    process never un-preempts)."""
    _PREEMPT.clear()
    with _HOOK_LOCK:
        _HOOKS.clear()


def fire_preemption(grace_s: float) -> int:
    """Deliver preemption notice to this process: set the flag (polls
    surface it to the controller) and run every registered hook with
    a shared ``now + grace_s`` deadline. Returns the number of hooks
    that ran. Called from the runtime worker's SIGTERM thread — never
    from the event loop (hooks block on storage writes)."""
    _PREEMPT.set()
    deadline = time.monotonic() + max(0.0, float(grace_s))
    with _HOOK_LOCK:
        hooks = list(_HOOKS)
    n = 0
    for fn in hooks:
        if time.monotonic() >= deadline:
            break
        try:
            fn(deadline)
            n += 1
        except Exception as e:     # noqa: BLE001 — grace is shared
            print(f"[ckptio] preempt hook {fn!r} failed: {e}")
    try:
        from ray_tpu_torch.util import events
        events.record("ckpt", "preempt", ph="i", ts=time.time(),
                      hooks=n, grace_s=float(grace_s),
                      pid=os.getpid())
    except Exception:              # noqa: BLE001 — best effort on exit
        pass
    return n


def install_sigterm_hook(grace_s: Optional[float] = None) -> None:
    """Standalone-script variant of the runtime worker's graceful
    SIGTERM path: route SIGTERM through ``fire_preemption`` (bounded
    by ``grace_s``/``Config.preempt_grace_s``) and then exit. Worker
    processes spawned by the runtime get this wiring automatically —
    this is for bare ``python train.py`` runs."""
    import signal

    if grace_s is None:
        from ray_tpu_torch.config import get_config
        grace_s = float(getattr(get_config(), "preempt_grace_s", 5.0))
    fired = {"v": False}

    def _handler(signum, frame):
        if fired["v"]:
            return
        fired["v"] = True

        def _drain():
            fire_preemption(grace_s)
            os._exit(0)
        t = threading.Thread(target=_drain, daemon=True)
        t.start()
        # hard backstop: a wedged hook cannot hold the process past
        # the grace the preemptor promised
        bk = threading.Timer(grace_s + 3.0, os._exit, args=(0,))
        bk.daemon = True
        bk.start()

    signal.signal(signal.SIGTERM, _handler)


# --------------------------------------------------------------------------
# shard / manifest primitives (shared by the async writer, the
# pipeline driver's sync path, and the controller's recovery scan)
# --------------------------------------------------------------------------

def _hash(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


class _Hasher(threading.Thread):
    """``_hash(data)`` on a thread of its own, started at construction:
    hashlib releases the GIL over a large buffer, so a shard's hash
    overlaps its write (``write_shard``) or its parse (``_load_shard``)
    instead of adding to it. ``result()`` waits for the digest."""

    def __init__(self, data) -> None:
        super().__init__(daemon=True)
        self._data = data
        self._digest: Optional[str] = None
        self.start()

    def run(self) -> None:
        self._digest = _hash(self._data)

    def result(self) -> str:
        self.join()
        return self._digest


def _shard_base(space: str, rank: int, world: int) -> str:
    return f"{space}.shard-{rank:05d}-of-{world:05d}"


def ckpt_dirname(step: int) -> str:
    return f"ckpt-{int(step):08d}"


def _storage(path_or_uri: str):
    from ray_tpu_torch.util import storage as _st
    return _st.get_storage(path_or_uri)


def _snapshot_arrays(params, state, lo: int, hi: int) -> Tuple[dict, int]:
    """The host-copied payload arrays for one rank's shard: the owned
    ``[lo, hi)`` slice of the flat parameter space, each shard-local
    elementwise optimizer leaf, and the replicated non-elementwise
    leaves (optax counters) verbatim. Returns (arrays, total)."""
    from ray_tpu_torch.dag.ring import _flatten, to_host
    from ray_tpu_torch.train.zero import ShardedOptimizer, _slice_leaves
    params, state = to_host(params)[0], to_host(state)[0]
    leaves, _, _ = _flatten(params)
    total = int(sum(l.size for l in leaves))
    wire = ShardedOptimizer._wire_of(leaves)
    arrays: Dict[str, np.ndarray] = {
        "param_seg": _slice_leaves(leaves, wire, lo, hi)}
    n_elem = n_other = 0
    if state is not None:
        sleaves, _, _ = _flatten(state)
        shard_len = hi - lo
        for l in sleaves:
            a = np.asarray(l)
            if a.ndim >= 1 and a.size == shard_len:
                arrays[f"elem_{n_elem}"] = np.array(
                    a.reshape(-1), copy=True)
                n_elem += 1
            else:
                arrays[f"other_{n_other}"] = np.array(a, copy=True)
                n_other += 1
    arrays["_counts"] = np.array([n_elem, n_other], np.int64)
    return arrays, total


def write_shard(storage_path: str, ckpt: str, *, space: str, rank: int,
                world: int, bounds: Tuple[int, int], total: int,
                arrays: Dict[str, np.ndarray], step: int,
                attempt: Optional[str] = None) -> dict:
    """Phase 1 of the two-phase save: write one rank's payload, then
    its meta JSON (content hash, bounds) — both atomic at the storage
    layer, meta strictly AFTER payload so a visible meta implies a
    complete payload. Returns the meta dict (the coordinator folds it
    into the manifest).

    ``attempt`` tags the meta with this save attempt's identity (the
    train-group incarnation id): a step directory left behind by a
    CRASHED earlier attempt still holds that attempt's valid-looking
    shard metas, and a coordinator re-saving the same step must not
    commit those stale shards as if they were this attempt's — the
    attempt gate in ``_await_shards`` is what makes re-saving into a
    dirty directory safe."""
    st, root = _storage(storage_path)
    base = _shard_base(space, rank, world)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    digest = _Hasher(data)
    act = _chaos_fire("shard")
    if act is not None and act[0] == "torn":
        # simulate a non-atomic writer crashing mid-payload: truncated
        # bytes reach the FINAL name, but the meta/manifest hash is
        # computed from the intended content — restore-side hash
        # verification is what must catch it
        st.put_bytes(f"{root}/{ckpt}/{base}.npz", data[:len(data) // 2])
    else:
        st.put_bytes(f"{root}/{ckpt}/{base}.npz", data)
    meta = {"space": space, "rank": int(rank), "world": int(world),
            "bounds": [int(bounds[0]), int(bounds[1])],
            "total": int(total), "step": int(step),
            "file": f"{base}.npz", "bytes": len(data),
            "hash": digest.result()}
    if attempt:
        meta["attempt"] = str(attempt)
    st.put_bytes(f"{root}/{ckpt}/{base}.json",
                 json.dumps(meta).encode())
    return meta


def _await_shards(st, root: str, ckpt: str, space: str, world: int,
                  deadline: float,
                  attempt: Optional[str] = None) -> List[dict]:
    """Coordinator wait: poll storage until every rank's shard meta
    for ``space`` is visible (or the deadline passes — CkptError, the
    save is abandoned and stays invisible). When ``attempt`` is given,
    a meta tagged with a DIFFERENT attempt is a leftover of an earlier
    crashed save of this step — keep polling until the live rank
    overwrites it, never commit it (a committed stale shard would be
    hash-valid but from another trajectory)."""
    metas: Dict[int, dict] = {}
    while True:
        for r in range(world):
            if r in metas:
                continue
            raw = st.get_bytes(
                f"{root}/{ckpt}/{_shard_base(space, r, world)}.json")
            if raw is not None:
                try:
                    m = json.loads(raw)
                except Exception as e:   # noqa: BLE001 — torn meta
                    raise CkptError(
                        f"shard meta for rank {r} of {ckpt} is "
                        f"unreadable: {e}") from e
                if attempt is not None and \
                        m.get("attempt") != attempt:
                    continue          # stale attempt: poll on
                metas[r] = m
        if len(metas) == world:
            return [metas[r] for r in range(world)]
        if time.monotonic() >= deadline:
            raise CkptError(
                f"commit of {ckpt} abandoned: only "
                f"{sorted(metas)} of {world} shard(s) for space "
                f"{space!r} arrived before ckpt_commit_timeout_s — "
                f"the checkpoint stays invisible to restore")
        time.sleep(0.05)


def commit_manifest(storage_path: str, ckpt: str, *, step: int,
                    spaces: Dict[str, dict], group: Optional[dict] = None,
                    user_meta: Optional[dict] = None,
                    timeout_s: Optional[float] = None,
                    update_pointer: bool = True) -> dict:
    """Phase 2: the single commit marker. ``spaces`` maps space name
    -> either {"world": N} (coordinator polls storage for the N shard
    metas) or {"shards": [meta, ...]} (pre-collected, e.g. the
    pipeline driver's sync path). Writes ``MANIFEST.json`` atomically
    (tmp+fsync+rename locally; single-put on KV) and only then
    advances the ``_latest_checkpoint.json`` pointer. Until the
    manifest lands the checkpoint does not exist to any reader."""
    from ray_tpu_torch.config import get_config
    t0 = time.monotonic()
    if timeout_s is None:
        timeout_s = float(getattr(get_config(),
                                  "ckpt_commit_timeout_s", 60.0))
    st, root = _storage(storage_path)
    deadline = t0 + timeout_s
    man_spaces: Dict[str, dict] = {}
    for space, spec in spaces.items():
        metas = spec.get("shards")
        if metas is None:
            metas = _await_shards(st, root, ckpt, space,
                                  int(spec["world"]), deadline,
                                  attempt=spec.get("attempt"))
        world = len(metas)
        totals = {int(m["total"]) for m in metas}
        if len(totals) != 1:
            raise CkptError(
                f"shards of space {space!r} disagree on the flat "
                f"space size: {sorted(totals)}")
        man_spaces[space] = {
            "total": totals.pop(), "world": world,
            "bounds": [list(m["bounds"]) for m in metas],
            "shards": [{"rank": int(m["rank"]), "file": m["file"],
                        "hash": m["hash"], "bytes": int(m["bytes"]),
                        "bounds": list(m["bounds"])} for m in metas]}
    manifest = {"format": FORMAT, "step": int(step),
                "ts": time.time(), "spaces": man_spaces,
                "group": dict(group or {}),
                "user_meta": dict(user_meta or {})}
    payload = json.dumps(manifest, indent=1).encode()
    act = _chaos_fire("commit")
    if act is not None and act[0] == "torn":
        # a torn marker (non-atomic writer's crash) must parse-fail
        # closed: readers treat unparseable manifests as absent
        st.put_bytes(f"{root}/{ckpt}/{MANIFEST_NAME}",
                     payload[:len(payload) // 2])
        raise CkptError(f"ckpt chaos: torn manifest for {ckpt}")
    st.put_bytes(f"{root}/{ckpt}/{MANIFEST_NAME}", payload)
    if update_pointer:
        # pointer strictly AFTER the commit marker: a crash between
        # the two leaves the pointer at the previous complete
        # checkpoint, and the scan-side fallback still finds this one
        st.put_bytes(
            f"{root}/{POINTER_NAME}",
            json.dumps({
                "path": f"{storage_path.rstrip('/')}/{ckpt}",
                "step": int(step), "kind": "manifest",
                "metrics": dict((user_meta or {}).get("metrics")
                                or {})}).encode())
    try:
        ckpt_metrics()["commit"].observe(time.monotonic() - t0)
        ckpt_metrics()["last_step"].set(int(step))
        from ray_tpu_torch.util import events
        events.record("ckpt", "commit", ph="X",
                      ts=time.time() - (time.monotonic() - t0),
                      dur=time.monotonic() - t0, step=int(step),
                      path=f"{storage_path.rstrip('/')}/{ckpt}",
                      spaces=sorted(man_spaces))
    except Exception:              # noqa: BLE001 — observability only
        pass
    return manifest


def manifest_of(path: str) -> Optional[dict]:
    """The parsed manifest of a checkpoint directory/URI, or None when
    absent or unreadable (a torn commit parses as 'no checkpoint' —
    that is the two-phase contract, not an error)."""
    try:
        st, root = _storage(path)
        raw = st.get_bytes(f"{root}/{MANIFEST_NAME}")
        if raw is None:
            return None
        man = json.loads(raw)
        if not isinstance(man, dict) or man.get("format") != FORMAT:
            return None
        return man
    except Exception:              # noqa: BLE001 — fail closed
        return None


def is_manifest_dir(path: str) -> bool:
    return manifest_of(path) is not None


def validate_checkpoint(path: str, deep: bool = False) -> bool:
    """True when the checkpoint at ``path`` is COMPLETE: a parseable
    manifest whose every named shard file exists (``deep``
    additionally re-hashes each payload against the manifest)."""
    man = manifest_of(path)
    if man is None:
        return False
    try:
        st, root = _storage(path)
        for space in man.get("spaces", {}).values():
            for srec in space["shards"]:
                if not deep:
                    if not st.exists(f"{root}/{srec['file']}"):
                        return False
                    continue
                data = st.get_bytes(f"{root}/{srec['file']}")
                if data is None or _hash(data) != srec["hash"]:
                    return False
        return True
    except Exception:              # noqa: BLE001 — fail closed
        return False


def find_latest_complete(storage_path: str,
                         below_step: Optional[int] = None,
                         deep: bool = False
                         ) -> Optional[Tuple[str, dict]]:
    """Scan ``storage_path`` for the newest COMPLETE ``ckpt-*``
    checkpoint (manifest parses, shards exist; ``deep`` additionally
    re-hashes payloads), optionally below a step bound — the restore
    fallback when the resume pointer is torn, missing, or names a
    checkpoint whose shards are gone or corrupt."""
    try:
        st, root = _storage(storage_path)
        files = st.list(f"{root.rstrip('/')}/")
    except Exception:              # noqa: BLE001 — no storage = none
        return None
    steps: List[int] = []
    for p in files:
        if not p.endswith(f"/{MANIFEST_NAME}"):
            continue
        m = _CKPT_RE.search(p[:-(len(MANIFEST_NAME) + 1)])
        if m:
            steps.append(int(m.group(1)))
    for step in sorted(set(steps), reverse=True):
        if below_step is not None and step >= below_step:
            continue
        path = f"{storage_path.rstrip('/')}/{ckpt_dirname(step)}"
        man = manifest_of(path)
        if man is not None and validate_checkpoint(path, deep=deep):
            return path, man
    return None


# --------------------------------------------------------------------------
# restore (world-size independent re-slicing)
# --------------------------------------------------------------------------

def reslice_segments(total: int,
                     pieces: Sequence[Tuple[int, int, np.ndarray]],
                     new_lo: int, new_hi: int,
                     dtype=np.float32) -> np.ndarray:
    """Assemble the ``[new_lo, new_hi)`` slice of a flat
    length-``total`` space from stored segments ``(lo, hi, arr)`` —
    the storage-side analog of ``reshard.exchange``. Raises CkptError
    on any uncovered gap (a torn or truncated shard set must never
    materialize silent zeros)."""
    if not 0 <= new_lo <= new_hi <= total:
        raise CkptError(
            f"slice [{new_lo}, {new_hi}) outside [0, {total})")
    out = np.zeros(max(0, new_hi - new_lo), dtype)
    covered: List[Tuple[int, int]] = []
    for lo, hi, arr in pieces:
        a, b = max(lo, new_lo), min(hi, new_hi)
        if a >= b:
            continue
        seg = np.asarray(arr).reshape(-1)
        if seg.size != hi - lo:
            raise CkptError(
                f"segment [{lo}, {hi}) does not match its data "
                f"({seg.size} elements)")
        out[a - new_lo:b - new_lo] = seg[a - lo:b - lo]
        covered.append((a, b))
    from ray_tpu_torch.train.reshard import coverage_gaps
    gaps = coverage_gaps(new_hi - new_lo,
                         [(a - new_lo, b - new_lo) for a, b in covered])
    if gaps and new_hi > new_lo:
        raise CkptError(
            f"restore slice [{new_lo}, {new_hi}) has uncovered "
            f"gaps {gaps} — the shard set is incomplete")
    return out


def _load_shard(st, root: str, srec: dict, verify: bool):
    data = st.get_bytes(f"{root}/{srec['file']}")
    if data is None:
        raise CkptError(f"shard file {srec['file']} is missing")
    # the hash runs beside the parse; a mismatch wins over whatever the
    # parse made of the payload, as when the hash was checked first
    digest = _Hasher(data) if verify else None
    try:
        # eager member read: np.load is lazy, and a torn zip must
        # surface HERE as a typed CkptError the restore fallback
        # understands — not as a BadZipFile at first member access
        with np.load(io.BytesIO(data)) as npz:
            arrays, err = {k: npz[k] for k in npz.files}, None
    except Exception as e:             # noqa: BLE001 — fail closed
        arrays, err = None, e
    if digest is not None and digest.result() != srec["hash"]:
        raise CkptError(
            f"shard file {srec['file']} content hash mismatch "
            f"(torn or corrupted payload)")
    if err is not None:
        raise CkptError(
            f"shard file {srec['file']} is unreadable "
            f"(corrupted payload): {err}") from err
    return arrays


def _assemble_space(st, root: str, sp: dict, verify: bool,
                    dtype=None) -> Tuple[np.ndarray, List[list], list]:
    """Load EVERY shard of one manifest space and assemble: the full
    flat parameter array (the stored wire dtype unless ``dtype`` is
    given), per-elementwise-leaf ``(lo, hi, arr)`` piece lists ready
    for ``reslice_segments``, and the replicated 'other' leaves (from
    the first shard — they are identical on every rank). The shared
    protocol under both the ZeRO ``restore`` and the pipeline's
    per-stage restore; raises CkptError on any inconsistency
    (mismatched leaf counts, a segment that does not match its
    recorded bounds, incomplete coverage of the flat space)."""
    total = int(sp["total"])
    full = None
    filled = 0
    covered: List[Tuple[int, int]] = []
    elem_pieces: Optional[List[list]] = None
    others: Optional[list] = None
    for srec in sp["shards"]:
        olo, ohi = int(srec["bounds"][0]), int(srec["bounds"][1])
        npz = _load_shard(st, root, srec, verify)
        ne, no = (int(x) for x in npz["_counts"])
        if elem_pieces is None:
            elem_pieces = [[] for _ in range(ne)]
        elif ne != len(elem_pieces):
            raise CkptError(
                f"shards disagree on elementwise leaf count "
                f"({ne} vs {len(elem_pieces)})")
        seg = np.asarray(npz["param_seg"]).reshape(-1)
        if seg.size != ohi - olo:
            raise CkptError(
                f"shard {srec['file']} param segment has {seg.size} "
                f"elements, bounds say {ohi - olo}")
        if full is None:
            full = np.empty(total,
                            seg.dtype if dtype is None else dtype)
        full[olo:ohi] = seg
        filled += ohi - olo
        covered.append((olo, ohi))
        for j in range(ne):
            elem_pieces[j].append(
                (olo, ohi, np.asarray(npz[f"elem_{j}"])))
        if others is None:
            others = [np.asarray(npz[f"other_{j}"]) for j in range(no)]
    if filled != total or full is None:
        from ray_tpu_torch.train.reshard import coverage_gaps
        raise CkptError(
            f"shard set covers only {filled} of {total} elements "
            f"(gaps {coverage_gaps(total, covered)})")
    return full, elem_pieces or [], others or []


def _rebuild_state(template, shard_len: int, elem_arrays: list,
                   other_arrays: list):
    """Rebuild an optimizer-state pytree from a same-structure
    template: elementwise leaves (size == the CURRENT shard length)
    come from ``elem_arrays``, every other leaf from
    ``other_arrays`` — both in the template's depth-first order, both
    cast to the template leaf's dtype (optax counters keep their
    exact int32 array type)."""
    it_e, it_o = iter(elem_arrays), iter(other_arrays)

    def take(it, kind):
        try:
            return next(it)
        except StopIteration:
            # typed, not a bare StopIteration: fallback-to-older-
            # checkpoint callers catch CkptError, nothing else
            raise CkptError(
                f"optimizer-state layout mismatch: the template "
                f"needs more {kind} leaves than the checkpoint "
                f"stored (different optimizer than the one "
                f"checkpointed, or a params-only save?)") from None

    def walk(v):
        if isinstance(v, dict):
            t = type(v)
            out = {k: walk(x) for k, x in v.items()}
            return out if t is dict else t(out)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(walk(x) for x in v))
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        a = np.asarray(v)
        if a.ndim >= 1 and a.size == shard_len:
            return np.asarray(take(it_e, "elementwise"), dtype=a.dtype)
        o = take(it_o, "replicated")
        return np.asarray(o, dtype=a.dtype).reshape(a.shape)
    rebuilt = walk(template)
    for it, kind in ((it_e, "elementwise"), (it_o, "replicated")):
        leftover = sum(1 for _ in it)
        if leftover:
            raise CkptError(
                f"optimizer-state layout mismatch: {leftover} stored "
                f"{kind} leaf/leaves have no slot in the template "
                f"(different optimizer than the one checkpointed?)")
    return rebuilt


def restore(params_template, state_template=None, *,
            checkpoint, space: str = DEFAULT_SPACE,
            rank: Optional[int] = None, world: Optional[int] = None,
            bounds: Optional[Tuple[int, int]] = None,
            verify: Optional[bool] = None):
    """Restore ``(params, state, step)`` from a committed checkpoint,
    re-sliced to the CURRENT world size / shard layout.

    ``params_template`` supplies the pytree structure (the train_fn
    rebuilds its model; values are overwritten); ``state_template``
    likewise for optimizer state — pass ``opt.init(params)`` of the
    CURRENT incarnation so elementwise leaves are already shaped to
    the new shard, or None to restore parameters only.

    The new ownership slice defaults to the ambient train context's
    ``shard_bounds`` (so an N'-rank group restoring an N-rank
    checkpoint just works); override with ``rank``/``world`` or
    explicit ``bounds`` outside a train_fn. ``checkpoint`` is a
    directory path / storage URI or a ``train.Checkpoint``."""
    from ray_tpu_torch.dag.ring import _flatten, rebuild_from_layout
    from ray_tpu_torch.train.zero import ShardedOptimizer
    t0 = time.monotonic()
    if verify is None:
        from ray_tpu_torch.config import get_config
        verify = bool(getattr(get_config(), "ckpt_verify_hash", True))
    path = getattr(checkpoint, "path", checkpoint)
    man = manifest_of(path)
    if man is None:
        raise CkptError(
            f"{path} has no committed manifest — not a complete "
            f"checkpoint (crashed mid-save?)")
    sp = man.get("spaces", {}).get(space)
    if sp is None:
        raise CkptError(
            f"checkpoint {path} has no space {space!r} "
            f"(has {sorted(man.get('spaces', {}))})")
    total = int(sp["total"])
    leaves, rebuild, _ = _flatten(params_template)
    wire = ShardedOptimizer._wire_of(leaves)
    if int(sum(l.size for l in leaves)) != total:
        raise CkptError(
            f"parameter template has {sum(l.size for l in leaves)} "
            f"elements; checkpoint space {space!r} has {total}")
    if bounds is not None:
        new_lo, new_hi = int(bounds[0]), int(bounds[1])
    elif rank is not None and world is not None:
        from ray_tpu_torch.train.reshard import shard_bounds
        new_lo, new_hi = shard_bounds(total, int(world), int(rank))
    else:
        ctx = _try_context()
        if ctx is not None:
            new_lo, new_hi = ctx.shard_bounds(total)
        else:
            new_lo, new_hi = 0, total
    st, root = _storage(path)
    full, elem_pieces, others = _assemble_space(st, root, sp, verify,
                                                dtype=wire)
    params = rebuild_from_layout(full, {
        "rebuild": rebuild,
        "leaves": [(l.shape, l.size, l.dtype) for l in leaves]})
    state = None
    if state_template is not None:
        new_elems = [
            reslice_segments(total, pieces, new_lo, new_hi, wire)
            for pieces in elem_pieces]
        state = _rebuild_state(state_template, new_hi - new_lo,
                               new_elems, others)
    dur = time.monotonic() - t0
    try:
        ckpt_metrics()["restore"].observe(dur)
        from ray_tpu_torch.util import events
        events.record("ckpt", "restore", ph="X", ts=time.time() - dur,
                      dur=dur, step=int(man["step"]), space=space,
                      old_world=int(sp["world"]),
                      new_bounds=[new_lo, new_hi])
    except Exception:              # noqa: BLE001 — observability only
        pass
    return params, state, int(man["step"])


def _try_context():
    from ray_tpu_torch.train.api import get_context
    try:
        return get_context()
    except RuntimeError:
        return None


# --------------------------------------------------------------------------
# the async double-buffered writer
# --------------------------------------------------------------------------

class AsyncCheckpointer:
    """Per-rank async sharded checkpoint writer.

    Usage inside a train_fn (rank 0 is the commit coordinator)::

        ck = ckptio.AsyncCheckpointer()     # ctx supplies path/rank
        resume = ctx.get_checkpoint()
        if resume is not None:
            params, state, last = ckptio.restore(
                params, state_template=opt.init(params),
                checkpoint=resume)
            start = last + 1
        for step in range(start, n):
            ...
            params, state = opt.update(grads, state, params)
            ck.save(step, params, state, opt, every=K)
            train.report({...}, checkpoint=ck.last_committed())
        ck.flush(); ck.close()

    ``save`` pays only the snapshot copy on the step path (double
    buffering: ``Config.ckpt_stage_buffers`` staging slots; a writer
    that falls behind backpressures instead of dropping). Steps where
    ``step % every != 0`` are WATCHED, not saved — the preemption
    hook flushes the watched delta synchronously inside the SIGTERM
    grace window, so a preempted worker loses at most the in-flight
    step rather than ``every`` steps."""

    def __init__(self, storage_path: Optional[str] = None, *,
                 space: str = DEFAULT_SPACE,
                 rank: Optional[int] = None,
                 world: Optional[int] = None,
                 coordinator: Optional[bool] = None,
                 group: Optional[dict] = None,
                 attempt: Optional[str] = None):
        ctx = _try_context()
        if storage_path is None and ctx is not None:
            storage_path = ctx._storage_path
        if not storage_path:
            raise ValueError(
                "AsyncCheckpointer needs a storage path (pass one, or "
                "set RunConfig.storage_path so the train context "
                "carries it)")
        self.storage_path = str(storage_path)
        self.space = space
        # ctx-bound topology is re-resolved at every save: an elastic
        # reshape swaps the ambient context's rank/world/group_id in
        # place, and a checkpointer frozen at construction would keep
        # committing (and awaiting) the DEAD incarnation's shard count
        self._ctx_bound = (rank is None and world is None
                           and coordinator is None)
        self.rank = int(rank if rank is not None
                        else (ctx.get_world_rank() if ctx else 0))
        self.world = int(world if world is not None
                         else (ctx.get_world_size() if ctx else 1))
        self.coordinator = bool(self.rank == 0 if coordinator is None
                                else coordinator)
        # save-attempt identity: the group incarnation id when ctx-
        # bound (shared by every rank of THIS incarnation, fresh per
        # restart) — write_shard tags metas with it so the coordinator
        # never commits a crashed earlier attempt's leftover shards of
        # the same step. None (no gating) for explicit rank/world
        # construction, where ranks have no shared nonce to agree on
        # unless the caller passes ``attempt`` itself.
        if attempt is not None:
            self._attempt: Optional[str] = str(attempt)
        elif self._ctx_bound and ctx is not None:
            self._attempt = getattr(ctx, "group_id", "") or None
        else:
            self._attempt = None
        if group is None and ctx is not None:
            gs = getattr(ctx, "_grad_sync", None) or {}
            group = {"group_id": getattr(ctx, "group_id", ""),
                     "world": self.world,
                     "kind": gs.get("role") or "flat"}
            if gs.get("nodes"):
                group["nodes"] = list(gs["nodes"])
        self.group = dict(group or {"world": self.world,
                                    "kind": "flat"})
        from ray_tpu_torch.config import get_config
        cfg = get_config()
        self._slots = threading.Semaphore(
            max(1, int(getattr(cfg, "ckpt_stage_buffers", 2))))
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._m = ckpt_metrics()
        self._last_error: Optional[BaseException] = None
        self._last_committed_ckpt: Optional[Tuple[str, int, dict]] = None
        self._last_enqueued_step = -1
        self._watched: Optional[tuple] = None
        self._closed = False
        on_preempt(self._on_preempt)

    # -- context resolution ------------------------------------------------

    def _refresh_topology(self) -> None:
        """Re-resolve rank/world/coordinator/group/attempt from the
        ambient context (ctx-bound checkpointers only): after an
        in-place elastic reshape the survivors keep their processes —
        and this object — but the incarnation's topology changed."""
        if not self._ctx_bound:
            return
        ctx = _try_context()
        if ctx is None:
            return
        r, w = int(ctx.get_world_rank()), int(ctx.get_world_size())
        gid = getattr(ctx, "group_id", "") or ""
        if (r, w) != (self.rank, self.world) or (
                gid and gid != self.group.get("group_id")):
            self.rank, self.world = r, w
            self.coordinator = r == 0
            gs = getattr(ctx, "_grad_sync", None) or {}
            self.group = {"group_id": gid, "world": w,
                          "kind": gs.get("role") or "flat"}
            if gs.get("nodes"):
                self.group["nodes"] = list(gs["nodes"])
        if gid:
            self._attempt = gid

    def _bounds_of(self, total: int, opt=None) -> Tuple[int, int]:
        if opt is not None:
            return opt.shard_bounds(total)
        ctx = _try_context()
        if ctx is not None:
            return ctx.shard_bounds(total)
        from ray_tpu_torch.train.reshard import shard_bounds
        return shard_bounds(total, self.world, self.rank)

    # -- save --------------------------------------------------------------

    def save(self, step: int, params, state=None, opt=None, *,
             metrics: Optional[dict] = None, every: int = 1,
             block: bool = False,
             timeout_s: Optional[float] = None) -> bool:
        """Snapshot + enqueue one save. Returns True when a save was
        enqueued, False when the step was only watched (``step %
        every != 0``). ``block=True`` waits for durability (shard
        written; manifest committed on the coordinator) before
        returning — the sync path the preemption flush and tests
        use. ``timeout_s`` bounds BOTH waits this call can make (the
        backpressure slot acquire and the ``block`` durability wait)
        with one shared deadline, raising CkptError when it passes —
        the preemption hook's grace window must never hang on a
        wedged storage backend."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise CkptError(
                f"previous async checkpoint save failed: {err}") \
                from err
        if every > 1 and step % every:
            # cheap: functional updates mean these refs stay frozen —
            # the preemption hook can snapshot them at SIGTERM time
            self._watched = (int(step), params, state, opt, metrics)
            return False
        self._watched = None
        t0 = time.monotonic()
        self._refresh_topology()
        total_probe = None
        if opt is not None:
            total_probe = getattr(opt, "_total", None)
        from ray_tpu_torch.dag.ring import _flatten
        if total_probe is None:
            leaves, _, _ = _flatten(params)
            total_probe = int(sum(l.size for l in leaves))
        lo, hi = self._bounds_of(int(total_probe), opt)
        deadline = None if timeout_s is None \
            else time.monotonic() + max(0.0, float(timeout_s))
        # backpressure: at most ckpt_stage_buffers snapshots may be
        # in flight; the step path blocks here only when the writer
        # has fallen that far behind
        if deadline is None:
            self._slots.acquire()
        elif not self._slots.acquire(
                timeout=max(0.0, deadline - time.monotonic())):
            raise CkptError(
                f"no staging slot freed within {timeout_s}s — the "
                f"background writer is wedged; save at step {step} "
                f"abandoned (invisible to restore)")
        try:
            arrays, total = _snapshot_arrays(params, state, lo, hi)
        except BaseException:
            self._slots.release()
            raise
        # topology rides the job: a reshape between enqueue and the
        # background write must not retag an in-flight shard
        job = {"step": int(step), "arrays": arrays, "total": total,
               "bounds": (lo, hi), "metrics": dict(metrics or {}),
               "rank": self.rank, "world": self.world,
               "coordinator": self.coordinator,
               "group": dict(self.group), "attempt": self._attempt,
               "done": threading.Event(), "error": None}
        self._last_enqueued_step = int(step)
        self._ensure_thread()
        self._q.put(job)
        stall_s = time.monotonic() - t0
        self._m["snapshot"].observe(stall_s)
        try:
            # the step path paid this much for the save (backpressure
            # wait + host snapshot copy) — the goodput ledger's
            # ckpt_stall category, same measured span as the
            # ckpt_snapshot_s histogram above
            from ray_tpu_torch.util import goodput
            goodput.add("ckpt_stall", stall_s)
        except Exception:   # noqa: BLE001 — observability must not raise
            pass
        if block:
            if deadline is None:
                job["done"].wait()
            elif not job["done"].wait(
                    max(0.0, deadline - time.monotonic())):
                raise CkptError(
                    f"save at step {step} not durable within "
                    f"{timeout_s}s (writer wedged on storage?)")
            if job["error"] is not None:
                # this raise IS the surfacing: the writer also parked
                # the same exception in _last_error for the async
                # case, and leaving it there would spuriously fail
                # the NEXT save for an error the caller just handled
                if self._last_error is job["error"]:
                    self._last_error = None
                raise CkptError(
                    f"checkpoint save at step {step} failed: "
                    f"{job['error']}") from job["error"]
        return True

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._writer_loop,
                    name=f"ckptio-writer-r{self.rank}", daemon=True)
                self._thread.start()

    def _writer_loop(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._write_one(job)
            except BaseException as e:   # noqa: BLE001 — surfaced via
                job["error"] = e          # flush()/next save()
                self._last_error = e
            finally:
                self._slots.release()
                job["done"].set()
                self._q.task_done()

    def _write_one(self, job: dict):
        t0 = time.monotonic()
        step = job["step"]
        ckpt = ckpt_dirname(step)
        meta = write_shard(
            self.storage_path, ckpt, space=self.space,
            rank=job["rank"], world=job["world"],
            bounds=job["bounds"], total=job["total"],
            arrays=job["arrays"], step=step, attempt=job["attempt"])
        self._m["save"].observe(time.monotonic() - t0)
        self._m["shard_bytes"].set(meta["bytes"])
        if job["coordinator"]:
            man = commit_manifest(
                self.storage_path, ckpt, step=step,
                spaces={self.space: {"world": job["world"],
                                     "attempt": job["attempt"]}},
                group=job["group"],
                user_meta={"metrics": job["metrics"]})
            self._last_committed_ckpt = (
                f"{self.storage_path.rstrip('/')}/{ckpt}", step, man)

    # -- read side ---------------------------------------------------------

    def last_committed(self):
        """The newest checkpoint THIS coordinator committed, as a
        managed ``train.Checkpoint`` (the plane already persisted it
        and advanced the pointer, so ``report()`` must not re-upload
        it). None on non-coordinator ranks and before the first
        commit — report a checkpoint from rank 0 only, the same rule
        the metrics plane uses."""
        if self._last_committed_ckpt is None:
            return None
        path, step, _man = self._last_committed_ckpt
        from ray_tpu_torch.train.api import Checkpoint
        return Checkpoint(path=path,
                          metrics={"step": step}, managed=True)

    def flush(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every enqueued save is durable (written; and
        committed when this rank coordinates). Returns False on
        timeout; raises CkptError when a background save failed."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while not self._q.unfinished_tasks == 0:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.02)
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise CkptError(
                f"async checkpoint save failed: {err}") from err
        return True

    def close(self):
        if self._closed:
            return
        self._closed = True
        remove_preempt_hook(self._on_preempt)
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=5.0)

    # -- preemption --------------------------------------------------------

    def _on_preempt(self, deadline: float):
        """SIGTERM grace-window flush: finish in-flight saves, then
        save the watched-but-unsaved final delta synchronously — the
        'checkpoint we would have written at the next interval',
        written NOW because there is no next interval."""
        watched, self._watched = self._watched, None
        flushed = self._q.unfinished_tasks > 0   # in-flight async save
        if watched is not None and watched[0] > self._last_enqueued_step:
            step, params, state, opt, metrics = watched
            try:
                # deadline-bounded end to end: a wedged storage
                # backend must not hold this hook past the grace the
                # preemptor promised (runtime/worker.py's backstop
                # would skip the metrics drain for every later hook)
                self.save(step, params, state, opt, metrics=metrics,
                          block=True,
                          timeout_s=max(
                              0.1, deadline - time.monotonic()))
                flushed = True
            except Exception as e:     # noqa: BLE001 — grace is shared
                print(f"[ckptio] preempt final save failed: {e}")
        left = max(0.1, deadline - time.monotonic())
        self.flush(timeout_s=left)
        if flushed:
            self._m["preempt_flush"].inc()
