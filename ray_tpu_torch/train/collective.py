"""Collectives for train_fn user code: barrier, broadcast, and
host-plane gradient allreduce.

Reference: train/collective/collectives.py:16,59 — barrier/broadcast are
CONTROL collectives (rendezvous, config exchange) riding the actor
plane. WITHIN one jax.distributed process group, tensor collectives
belong to XLA over ICI inside jit (ray_tpu_torch.parallel). Between that and
the actor plane sits allreduce_gradients: a chunked ring reduce-scatter
+ allgather over shm/TCP channels (dag/ring.py) for host-resident
gradient pytrees — data-parallel groups that do NOT share a jax
process group (CPU data-parallel, per-worker independent meshes,
sklearn/torch backends) sync gradients at O(S) per worker instead of
shipping full tensors through the rendezvous actor.

The port's copy of ``ray_tpu/train/collective.py``. A gradient leaf may
be a torch tensor on any device (a bf16 CUDA tensor on the card): it is
staged by casting it to the float32 wire dtype on its device, then
copying it to the host (``_stage``, dag/ring.py ``stage_leaf``), and
every result leaf whose input was a tensor comes back as a tensor of
that leaf's dtype on that leaf's device (a numpy leaf comes back as the
reference returns it).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.train.api import get_context


class PeerLostError(RuntimeError):
    """A gradient-sync ring peer stopped responding (worker death,
    injected channel death, or a controller-driven abort while the
    group reshapes). RuntimeError subclass for back-compat; elastic
    train_fns catch THIS and call ``train.await_regroup()`` +
    ``ShardedOptimizer.reshard()`` to continue at the new world size
    instead of dying into a checkpoint-restore restart. Carries
    ``flight_recorder_path`` / ``flight_recorder_summary`` when the
    collective plane dumped one."""


def peer_lost_error(e) -> PeerLostError:
    """The one conversion from a ring-plane ``RingPeerDead`` to the
    typed error train_fns catch, flight-recorder attributes carried
    over (shared by ``_ring_call`` and ``ShardedOptimizer`` so the two
    paths can never drift apart in message or attribute shape)."""
    err = PeerLostError(
        f"gradient sync peer lost (worker died mid-ring?): "
        f"{e.cause}")
    err.flight_recorder_path = getattr(
        e, "flight_recorder_path", None)
    err.flight_recorder_summary = getattr(
        e, "flight_recorder_summary", None)
    return err


class _Rendezvous:
    """Named actor holding per-epoch barrier/broadcast state, plus the
    pre-flight desync guard's per-collective options-signature posts
    (forensics_verify_level): tiny descriptors, bounded keys."""

    _DESC_KEYS = 512    # oldest verify keys age out (opt-in debugging
    #                     lever — long "round"-level runs must not grow
    #                     the actor without bound)

    def __init__(self):
        self._barriers: dict = {}
        self._values: dict = {}
        self._descs: dict = {}

    def arrive(self, key: str, rank: int, world: int) -> bool:
        s = self._barriers.setdefault(key, set())
        s.add(rank)
        return len(s) >= world

    def arrived(self, key: str, world: int) -> bool:
        return len(self._barriers.get(key, ())) >= world

    def put_value(self, key: str, value: Any) -> bool:
        self._values[key] = value
        return True

    def get_value(self, key: str):
        return ("ok", self._values[key]) if key in self._values \
            else ("pending", None)

    def put_desc(self, key: str, rank: int, desc: str) -> bool:
        self._descs.setdefault(key, {})[int(rank)] = str(desc)
        while len(self._descs) > self._DESC_KEYS:
            self._descs.pop(next(iter(self._descs)))
        return True

    def get_descs(self, key: str) -> dict:
        return dict(self._descs.get(key, {}))


def _rendezvous_handle():
    name = "__train_rendezvous"
    try:
        return ray_tpu_torch.get_actor(name)
    except ValueError:
        pass
    try:
        return ray_tpu_torch.remote(_Rendezvous).options(
            name=name, lifetime="detached").remote()
    except Exception:
        return ray_tpu_torch.get_actor(name)


_epochs: dict = {}


def _validate_codec_opts(value: Any, op: str, quantize: Optional[str],
                         wire_dtype) -> None:
    """The single-worker paths still validate like the ring would: a
    bad op/quantize/wire_dtype (or a codec over non-float leaves) must
    not pass on 1 worker and only explode at scale."""
    from ray_tpu_torch.dag.ring import (_QUANTIZE_MODES, _wire_dtype,
                                        resolve_wire_dtype)
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown op {op!r}")
    if quantize not in _QUANTIZE_MODES:
        raise ValueError(f"quantize must be one of {_QUANTIZE_MODES}, "
                         f"got {quantize!r}")
    wdt = resolve_wire_dtype(wire_dtype)
    if quantize is not None and wdt is not None:
        raise ValueError("quantize and wire_dtype are both wire codecs "
                         "— pass at most one")
    if quantize is not None or wdt is not None:
        name = (f"{quantize} block quantization" if quantize
                else f"wire_dtype={wire_dtype!r}")
        for leaf in _raw_leaves(value):
            w = _wire_dtype([_np_dtype(leaf)], op)
            if w.kind != "f":
                raise TypeError(
                    f"{name} requires floating-point values "
                    f"(wire dtype would be {w})")


# --- error-feedback compression ------------------------------------------
#
# Lossy wire codecs (int8/int4 block quantization) drop part of every
# gradient on the floor. Plain quantized SGD compounds that bias step
# over step; error-feedback (EF-SGD / 1-bit Adam lineage) carries the
# dropped part forward instead: each rank keeps a per-element fp32
# residual r, ships roundtrip(g + r), and sets
# r <- (g + r) - roundtrip(g + r). The residual is reconstructed
# LOCALLY from the codec round-trip — no extra wire — and the
# compensated stream's time-average equals the true gradient stream,
# which is what makes int4 gradient sync convergence-safe
# (the JAX package's ZERO_BENCH.json: its codec_convergence rows pair
# every codec with its loss trajectory vs fp32).


class ErrorFeedback:
    """Per-rank error-feedback accumulator for lossy gradient codecs.

    The residual lives over the FULL flat gradient space (every rank
    compensates what IT contributes; reduce-scatter/allreduce then mix
    the compensated streams). It is keyed by (generation, layout,
    codec): ANY change — elastic reshard, a different pytree, a codec
    switch — re-zeroes it, the "provably zeroed, never silently stale"
    contract. Bucketed syncs own per-bucket slices: bucket cuts are
    leaf-aligned flat offsets, so ``compensate``/``absorb`` take an
    ``offset`` and each bucket round-trips exactly the slice it ships.
    """

    def __init__(self):
        self.residual: Optional[np.ndarray] = None
        self.key = None             # (generation, total, codec tag)

    def ensure(self, *, gen, total: int, tag: str) -> bool:
        """(Re)key the residual buffer for one (generation, layout,
        codec); returns True when it was (re)zeroed."""
        key = (gen, int(total), tag)
        if self.key != key or self.residual is None:
            self.residual = np.zeros(int(total), np.float32)
            self.key = key
            return True
        return False

    def compensate(self, flat: np.ndarray, offset: int = 0) -> np.ndarray:
        """gradient + carried residual for the ``[offset, offset+n)``
        slice of the flat space (a fresh fp32 array — the caller's
        input is never mutated)."""
        r = self.residual[offset:offset + flat.size]
        return np.asarray(flat, np.float32).reshape(-1) + r

    def pending(self, comp: np.ndarray,
                quantize: Optional[str]) -> np.ndarray:
        """What the residual WILL become once this round ships:
        compensated - what the codec ships, from the LOCAL
        encode/decode round-trip (``ring.codec_roundtrip``) — the wire
        never carries residuals. Computed BEFORE the collective,
        committed (``commit``) only after it returns: a round that
        raises leaves the residual untouched, so a retry at the same
        key re-compensates the identical stream instead of
        double-compensating a round that never shipped."""
        from ray_tpu_torch.dag.ring import QUANT_BLOCK, codec_roundtrip
        flat = np.asarray(comp, np.float32).reshape(-1)
        # in spans of whole quantization blocks, so the codec's
        # temporaries stay a span's size: the same blocks as one
        # round-trip of the whole vector, so the same values
        out = np.empty_like(flat)
        step = QUANT_BLOCK << 14
        for a in range(0, flat.size, step):
            seg = flat[a:a + step]
            out[a:a + step] = seg - codec_roundtrip(seg, quantize)
        return out

    def commit(self, pend: np.ndarray, offset: int = 0) -> None:
        """Install a ``pending`` residual slice — call after the ring
        round that shipped its frames came back successfully."""
        self.residual[offset:offset + pend.size] = pend

    def absorb(self, comp: np.ndarray, quantize: Optional[str],
               offset: int = 0) -> None:
        """``pending`` + ``commit`` in one step, for call sites that
        already sit after the collective (and the unit tests)."""
        self.commit(self.pending(comp, quantize), offset)

    def invalidate(self) -> None:
        self.residual = None
        self.key = None


def _grad_ef(ctx) -> ErrorFeedback:
    """The context-scoped accumulator ``allreduce_gradients(codec=...)``
    uses (one per train context — re-keyed, not shared, across
    incarnations via the (group_id, generation) in its key)."""
    ef = getattr(ctx, "_grad_ef", None)
    if not isinstance(ef, ErrorFeedback):
        ef = ErrorFeedback()
        ctx._grad_ef = ef
    return ef


# --- bucketed gradient sync ----------------------------------------------
#
# Splitting a gradient pytree into leaf buckets lets the ring start
# reducing EARLY buckets while LATER leaves are still being staged to
# host (np.asarray of a jax leaf is a device->host transfer): the
# caller's thread stages bucket k+1 while a single worker thread runs
# the (order-preserving) ring rounds for buckets <= k — host staging
# hides under ring I/O through the channels' existing per-item
# send/recv windows. Bucket cuts are derived from the layout alone
# (leaf order + nbytes), so every rank cuts identical buckets and the
# ring's per-round layout validation still applies per bucket.


def _raw_leaves(value) -> list:
    """The pytree's leaves in ``dag.ring._flatten`` order WITHOUT
    staging them (no np.asarray): bucketed sync must not pay the
    device->host copy before the bucket that ships the leaf."""
    out: list = []

    def walk(v):
        if isinstance(v, dict):
            for k in v:
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        else:
            out.append(v)
    walk(value)
    return out


def _rebuild_like(value, it):
    """Reassemble a pytree shaped like ``value`` from an iterator of
    reduced arrays (same leaf order as ``_raw_leaves``), applying
    ``_flatten``'s scalar policy: a non-ndarray 0-d leaf comes back as
    a Python scalar."""
    if isinstance(value, dict):
        t = type(value)
        out = {k: _rebuild_like(v, it) for k, v in value.items()}
        return out if t is dict else t(out)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_rebuild_like(x, it) for x in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_rebuild_like(x, it) for x in value)
    arr = next(it)
    if not isinstance(value, np.ndarray) and np.ndim(value) == 0:
        return arr.item() if hasattr(arr, "item") else arr
    return arr


def _leaf_nbytes(leaf) -> int:
    nb = getattr(leaf, "nbytes", None)
    return int(nb) if nb is not None else int(np.asarray(leaf).nbytes)


def _bucket_parts(leaves: list, bucket_bytes: int) -> List[Tuple[int, int]]:
    """Order-preserving leaf index ranges whose summed nbytes stay at
    or under ``bucket_bytes`` (every bucket gets at least one leaf, an
    oversized leaf rides alone). Deterministic from the layout, so all
    ranks cut the same buckets."""
    if bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be > 0")
    parts: List[Tuple[int, int]] = []
    a, acc = 0, 0
    for i, leaf in enumerate(leaves):
        nb = _leaf_nbytes(leaf)
        if i > a and acc + nb > bucket_bytes:
            parts.append((a, i))
            a, acc = i, 0
        acc += nb
    parts.append((a, max(a + 1, len(leaves))) if leaves else (0, 0))
    return parts if leaves else []


def _pipeline_buckets(nparts: int, stage_fn: Callable[[int], Any],
                      ring_fn: Callable[[int, Any], Any]):
    """Run ``stage_fn(i)`` on the calling thread while ONE worker
    thread runs ``ring_fn(i, staged)`` strictly in bucket order (ring
    rounds must stay ordered — every rank issues the same sequence).
    Returns ``(results, overlap_s)``: overlap_s is the staging wall
    time that ran while a ring round was in flight — the comm/compute
    overlap the bucketing buys, exported as
    ``allreduce_bucket_overlap_s``."""
    from concurrent.futures import ThreadPoolExecutor
    ring_windows: List[Tuple[float, float]] = []
    stage_windows: List[Tuple[float, float]] = []
    failed: List[BaseException] = []

    def run(i, staged):
        # once a bucket's round has failed, every LATER queued bucket
        # short-circuits instead of issuing another collective: an
        # agreed error fails the same bucket on every rank (so all
        # ranks skip the same tail — lockstep preserved), and a dead
        # peer is terminal for the group anyway. Without this, a
        # large model's remaining buckets would each wait out the
        # ring timeout against the dead peer — hours, not the one
        # timeout the elastic recovery deadline budgets for.
        if failed:
            raise failed[0]
        t0 = time.monotonic()
        try:
            return ring_fn(i, staged)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            failed.append(e)
            raise
        finally:
            ring_windows.append((t0, time.monotonic()))

    from ray_tpu_torch.dag.ring import _PoisonValue
    with ThreadPoolExecutor(1) as ex:
        futs = []
        for i in range(nparts):
            t0 = time.monotonic()
            try:
                staged = stage_fn(i)
            except BaseException as e:  # noqa: BLE001 — must not stall
                # a rank-local staging failure still ENTERS the ring
                # round (the poison ships as an error frame every peer
                # agrees on in one header relay) — peers must never be
                # left blocking because this rank's device->host copy
                # died; the same contract the unbucketed path gets
                # from flattening inside the ring's try
                staged = _PoisonValue(e)
            stage_windows.append((t0, time.monotonic()))
            futs.append(ex.submit(run, i, staged))
        results = [f.result() for f in futs]
    overlap = 0.0
    for s0, s1 in stage_windows:
        for r0, r1 in ring_windows:
            overlap += max(0.0, min(s1, r1) - max(s0, r0))
    try:
        from ray_tpu_torch.dag.ring import allreduce_metrics
        allreduce_metrics()["bucket_overlap"].observe(overlap)
    except Exception:   # noqa: BLE001 — telemetry must never break
        pass
    return results, overlap


def _stage(leaf) -> np.ndarray:
    """One leaf on the host: a torch tensor cast to float32 on its device
    when narrower (numpy has no bfloat16), then copied to host memory;
    any other leaf through np.asarray."""
    from ray_tpu_torch.dag.ring import stage_leaf
    return np.ascontiguousarray(stage_leaf(leaf))


def _np_dtype(leaf) -> np.dtype:
    """The numpy dtype ``_stage`` gives ``leaf`` — without staging it."""
    from ray_tpu_torch.dag.ring import _tensor_type
    t_type = _tensor_type()
    if t_type is not None and isinstance(leaf, t_type):
        if leaf.is_floating_point() and leaf.element_size() < 4:
            return np.dtype(np.float32)
        import torch
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _tensor_like(value):
    """``value`` when any of its leaves is a torch tensor (its results
    then come back as tensors, dag/ring.py ``from_host``), else None."""
    from ray_tpu_torch.dag.ring import _tensor_type
    t_type = _tensor_type()
    if t_type is None or not any(isinstance(l, t_type)
                                 for l in _raw_leaves(value)):
        return None
    return value


def _restore(out, like):
    """A host result given back in ``like``'s tensors: ``from_host`` when
    ``out`` is shaped like ``like``, ``unflat`` when it is the flat vector
    of ``like``'s values (what a ring fed by ``stage_flat`` returns);
    ``out`` as it is otherwise (an allgather whose cached layout did not
    match)."""
    from ray_tpu_torch.dag.ring import _numel, from_host, unflat
    if like is None:
        return out
    got, want = _raw_leaves(out), _raw_leaves(like)
    if len(got) == len(want) and all(
            tuple(np.shape(g)) == tuple(w.shape)
            for g, w in zip(got, want)):
        return from_host(out, like)
    if isinstance(out, np.ndarray) and out.ndim == 1 and \
            out.size == sum(_numel(w) for w in want):
        return unflat(out, like)
    return out


def _to_host(value):
    """``(host value, like)`` for one unbucketed collective: a pytree of
    floating torch leaves as ONE flat float32 vector (``stage_flat``),
    other torch leaves staged one by one (``to_host``), a numpy pytree
    as it is (like None)."""
    from ray_tpu_torch.dag.ring import stage_flat, to_host
    flat, like = stage_flat(value)
    if flat is not None:
        return flat, like
    return to_host(value)


def _bucketed_allreduce(ring, value, op: str, quantize, wire_dtype,
                        bucket_bytes: int):
    from ray_tpu_torch.dag.ring import _UNSET
    leaves = _raw_leaves(value)
    parts = _bucket_parts(leaves, bucket_bytes)
    q = quantize if quantize is not None else _UNSET
    w = wire_dtype if wire_dtype is not None else _UNSET
    if len(parts) <= 1:
        return ring.reduce(value, op=op, quantize=q, wire_dtype=w)
    outs, _ = _pipeline_buckets(
        len(parts),
        lambda i: [_stage(l) for l in leaves[parts[i][0]:parts[i][1]]],
        lambda i, staged: ring.reduce(staged, op=op, quantize=q,
                                      wire_dtype=w))
    flat = [arr for out in outs for arr in out]
    return _restore(_rebuild_like(value, iter(flat)), _tensor_like(value))


def _bucketed_reduce_scatter(ctx, ring, value, op: str, quantize,
                             bucket_bytes: int):
    """Per-bucket ring reduce-scatter with the staging/ring pipeline.
    Returns the concatenation of this rank's owned per-bucket shards
    (each bucket's flat space split by ``ring.seg_bounds``, mean
    already divided) and caches the bucket layout on the context so
    ``allgather_params`` can reassemble the full pytree."""
    from ray_tpu_torch.dag.ring import _UNSET
    leaves = _raw_leaves(value)
    parts = _bucket_parts(leaves, bucket_bytes)
    q = quantize if quantize is not None else _UNSET
    meta = {"bucket_bytes": int(bucket_bytes), "totals": [],
            "wires": [], "leaves": [], "template": value}

    def rs(i, staged):
        shard = ring.reduce_scatter(staged, op=op, quantize=q)
        # the ring thread runs buckets sequentially, so the cached
        # layout read here is bucket i's (not a later bucket's)
        return shard, ring._layout

    outs, _ = _pipeline_buckets(
        len(parts),
        lambda i: [_stage(l) for l in leaves[parts[i][0]:parts[i][1]]],
        rs)
    shards = []
    for shard, layout in outs:
        meta["totals"].append(layout["total"])
        meta["wires"].append(layout["wire"])
        meta["leaves"].append(layout["leaves"])   # per-bucket metas
        shards.append(shard)
    meta["total"] = int(sum(meta["totals"]))
    ctx._bucketed_rs = meta
    return np.concatenate(shards) if shards else np.empty(0, np.float32)


def _bucketed_allgather(ctx, ring, shard, wire_dtype, meta):
    """Reassemble the full pytree from a concatenated bucketed shard:
    split by per-bucket owned lengths, allgather each bucket (flat),
    stitch the flat buckets (bucket cuts are leaf-aligned, so their
    concatenation IS the flat value space) and rebuild with each
    leaf's cast-back dtype."""
    from ray_tpu_torch.dag.ring import _UNSET
    w = wire_dtype if wire_dtype is not None else _UNSET
    flat = _stage(shard).reshape(-1)
    lens, offs = [], [0]
    for t in meta["totals"]:
        lo, hi = ring.seg_bounds(t)
        lens.append(hi - lo)
        offs.append(offs[-1] + (hi - lo))
    if offs[-1] != flat.size:
        raise ValueError(
            f"bucketed shard has {flat.size} elements, the cached "
            f"bucket layout owns {offs[-1]} — pass exactly what the "
            f"bucketed reduce-scatter returned")
    pieces = [np.ascontiguousarray(flat[offs[i]:offs[i] + lens[i]],
                                   dtype=meta["wires"][i])
              for i in range(len(lens))]
    outs, _ = _pipeline_buckets(
        len(pieces), lambda i: pieces[i],
        lambda i, p: ring.allgather(p, wire_dtype=w, rebuild=False))
    # per-bucket rebuild (no cross-bucket concatenation: buckets may
    # carry different wire dtypes, and promotion would corrupt values)
    leaves_out = []
    for bi, out in enumerate(outs):
        fb = np.asarray(out).reshape(-1)
        off = 0
        for shape, size, od in meta["leaves"][bi]:
            leaves_out.append(
                fb[off:off + size].reshape(shape).astype(od, copy=False))
            off += size
    return _restore(_rebuild_like(meta["template"], iter(leaves_out)),
                    _tensor_like(meta["template"]))


def _ring_call(ctx, timeout_s: Optional[float], fn,
               bump_step: bool = False):
    """Run one collective on the controller-wired ring with an optional
    per-call timeout override; RingPeerDead surfaces as RuntimeError
    (carrying the collective flight-recorder dump path when one was
    written — the ring's cause message already names it). The train
    step tag rides every span; ``bump_step`` advances it AFTER a
    successful round (one gradient sync == one step; the allgather
    half of a ZeRO step keeps the same tag)."""
    from ray_tpu_torch.dag.ring import RingPeerDead
    try:
        ring = ctx.gradient_sync_ring()
        ring.step = getattr(ctx, "collective_step", None)
        saved = ring.timeout_s
        if timeout_s is not None:
            ring.timeout_s = float(timeout_s)
        try:
            out = fn(ring)
        finally:
            ring.timeout_s = saved      # per-call override, not sticky
        if bump_step:
            ctx.collective_step = getattr(ctx, "collective_step", 0) + 1
        return out
    except RingPeerDead as e:
        raise peer_lost_error(e) from e


# --- pre-flight desync guard (util/forensics.py) -------------------------


def preflight_verify(ctx, desc: str,
                     timeout_s: Optional[float] = None) -> None:
    """Opt-in options-signature agreement BEFORE entering a collective
    (Config.forensics_verify_level: "off" | "step" | "round").

    The ring's own header relay already catches same-round option
    mismatches — but only once every rank has ENTERED the round, which
    is exactly what a conditional desync (ranks issuing different
    collective sequences, the PR 19 ``codec="auto"`` bug class)
    prevents: the ring hangs to its full timeout instead. This guard
    rides the rendezvous ACTOR plane, not the ring: every rank posts a
    descriptor of the collective it is about to issue under a
    lockstep-counted key and polls for the group with a deadline, so
    both failure shapes get a typed, named diagnosis in seconds —
    ``CollectiveDesyncError`` ("rank 0 int4 vs rank 2 fp32") when the
    descriptors differ, ``CollectiveStallError`` ("rank 3 never posted
    ...") when a rank never arrives.

    "step" verifies once per collective_step (first collective of the
    step); "round" verifies every call. Each check is one actor round
    trip — a debugging lever, not a default (see PERF_JAX.md's runbook).
    """
    from ray_tpu_torch.config import get_config
    from ray_tpu_torch.util import events, forensics
    cfg = get_config()
    level = str(getattr(cfg, "forensics_verify_level", "off") or "off")
    if level not in ("step", "round"):
        if level != "off":
            raise ValueError(
                f"forensics_verify_level must be 'off', 'step' or "
                f"'round', got {level!r}")
        return
    if ctx.get_world_size() == 1:
        return
    step = int(getattr(ctx, "collective_step", 0) or 0)
    if level == "step" and getattr(ctx, "_fx_verified_step", None) == step:
        return
    # the verify sequence counts CHECKS, not collectives: lockstep as
    # long as every rank issues the same call sequence — which is the
    # invariant being verified
    seq = int(getattr(ctx, "_fx_verify_seq", 0))
    ctx._fx_verify_seq = seq + 1
    key = f"{ctx.group_id}:fxv:{step if level == 'step' else seq}"
    world, rank = ctx.get_world_size(), ctx.get_world_rank()
    tmo = float(timeout_s if timeout_s is not None else
                getattr(cfg, "forensics_stall_timeout_s", 60.0))
    h = _rendezvous_handle()
    ray_tpu_torch.get(h.put_desc.remote(key, rank, desc), timeout=tmo)
    deadline = time.monotonic() + tmo
    descs: dict = {}
    while True:
        descs = {int(r): d for r, d in ray_tpu_torch.get(
            h.get_descs.remote(key), timeout=tmo).items()}
        if len(descs) >= world or time.monotonic() >= deadline:
            break
        time.sleep(0.02)
    group = f"verify:{ctx.group_id[:8]}"
    if len(descs) < world:
        missing = sorted(set(range(world)) - set(descs))
        who = ", ".join(f"rank {r}" for r in missing)
        detail = (f"{who} never entered seq {seq} of group {group} "
                  f"within {tmo:.0f}s (parked before the collective, "
                  f"or issuing a different collective sequence); "
                  f"this rank was about to issue: {desc}")
        events.record("forensics", "collective_stall", group=group,
                      seq=seq, step=step, culprits=missing,
                      detail=detail, rank=rank)
        raise forensics.CollectiveStallError(
            f"pre-flight verify: {detail}", group=group, seq=seq,
            culprits=missing)
    if len(set(descs.values())) > 1:
        variants: dict = {}
        for r in sorted(descs):
            variants.setdefault(descs[r], []).append(r)
        culprits = sorted(min(variants.values(), key=len)) \
            if len(variants) == 2 and \
            len(set(map(len, variants.values()))) > 1 \
            else sorted(descs)
        detail = (f"seq {seq} options-signature mismatch on group "
                  f"{group}: " + " vs ".join(
                      f"rank {rs[0]} {d}" for d, rs in variants.items()))
        events.record("forensics", "collective_desync", group=group,
                      seq=seq, step=step, culprits=culprits,
                      detail=detail, rank=rank)
        raise forensics.CollectiveDesyncError(
            f"pre-flight verify: {detail}", group=group, seq=seq,
            culprits=culprits)
    if level == "step":
        ctx._fx_verified_step = step


def _pre_collective(ctx, kind: str, desc: str,
                    timeout_s: Optional[float] = None) -> None:
    """The forensics front door every train-plane collective passes:
    an ``enqueued`` intent row on this rank's ledger (written BEFORE
    the ring round opens its own in_flight row — a rank that parks
    between enqueue and enter still shows intent in the audit), then
    the opt-in pre-flight verify."""
    try:
        from ray_tpu_torch.util import forensics
        forensics.record_enqueued(
            group=f"train:{getattr(ctx, 'group_id', '')[:8]}",
            kind=kind, step=getattr(ctx, "collective_step", None),
            detail=desc)
    except Exception:   # noqa: BLE001 — bookkeeping must never block
        pass
    preflight_verify(ctx, desc, timeout_s=timeout_s)


# codec= names the WHOLE wire policy in one arg; each concrete tag
# maps to the (quantize, wire_dtype) pair the ring understands
_CODEC_NAMES = ("auto", "int4", "int8", "bf16", "fp32")
_CODEC_WIRE = {"int4": ("int4", None), "int8": ("int8", None),
               "bf16": (None, "bfloat16"), "fp32": (None, None)}


def _resolve_codec(ctx, value, codec: str, ef_enabled: bool,
                   timeout_s: Optional[float]) -> str:
    """``codec="auto"`` → a concrete tag for THIS payload, AGREED
    across ranks. The inputs to the choice are rank-local — the live
    ``allreduce_quant_error`` gauge reflects only the frames THIS rank
    cut (each rank quantizes different partial sums), and the tuner's
    codec band can be evicted on one rank but not another — so a
    per-rank choice could hand different wire options to the same
    collective round (frames decoding as garbage, or a hang).
    Resolution is therefore itself a tiny collective: ranks max-reduce
    [band-missing, live int8 err, live int4 err] on the ring, probe
    the band in lockstep when ANY rank lacks it, and feed the agreed
    (worst-case) errors to ``choose_codec`` — every input is then
    bitwise identical on every rank, so every rank resolves the same
    tag. Payloads under Config.collective_codec_min_bytes short out to
    fp32 from layout+config alone, with no agreement round."""
    if codec != "auto":
        return codec
    from ray_tpu_torch.config import get_config
    from ray_tpu_torch.dag import tuner
    from ray_tpu_torch.dag import ring as ring_mod
    cfg = get_config()
    payload = int(sum(_leaf_nbytes(l) for l in _raw_leaves(value)))
    ring = ctx.gradient_sync_ring()
    key, size = getattr(ring, "group", ""), ring.size
    if payload < int(getattr(cfg, "collective_codec_min_bytes",
                             64 * 1024)):
        return "fp32"
    if not getattr(cfg, "collective_tuner", True):
        # no probe/agreement machinery without the tuner: consult only
        # the (identically injected, if at all) band — never the
        # rank-local live gauge, which could split the choice
        return tuner.choose_codec(payload, size, key=key,
                                  ef_enabled=ef_enabled)
    vote = np.array(
        [1.0 if tuner.codec_profile_for(key, size) is None else 0.0,
         ring_mod.last_quant_error("int8") or 0.0,
         ring_mod.last_quant_error("int4") or 0.0], np.float64)
    agreed = _ring_call(ctx, timeout_s,
                        lambda r: r.reduce(vote, op="max"))
    if agreed[0] > 0:
        _ring_call(ctx, timeout_s, tuner.probe_codecs)
    live = {t: float(e) for t, e in
            (("int8", agreed[1]), ("int4", agreed[2])) if e > 0}
    return tuner.choose_codec(payload, size, key=key,
                              ef_enabled=ef_enabled, live_err=live)


def _ef_allreduce(ctx, value, op: str, quantize: str,
                  bucket_bytes: Optional[int],
                  timeout_s: Optional[float]):
    """Lossy-codec allreduce with error-feedback: flatten to fp32, add
    the carried residual, ship the compensated flat vector, keep
    (compensated - local codec round-trip) for the next round. The
    bucketed variant cuts the SAME leaf-aligned parts as the plain
    bucketed sync and each bucket absorbs exactly its own residual
    slice (per-bucket round-trip, so block boundaries match what that
    bucket's frames actually shipped)."""
    if op not in ("sum", "mean"):
        raise ValueError(
            f"error-feedback gradient sync carries a linear residual — "
            f"op must be 'sum' or 'mean', got {op!r}")
    _validate_codec_opts(value, op, quantize, None)
    from ray_tpu_torch.dag.ring import rebuild_from_layout
    from ray_tpu_torch.train.zero import _flat
    value, like = _to_host(value)
    flat, rebuild, total, leaves = _flat(value, np.dtype(np.float32))
    layout = {"rebuild": rebuild,
              "leaves": [(l.shape, l.size, l.dtype) for l in leaves]}
    ef = _grad_ef(ctx)
    ef.ensure(gen=(ctx.group_id, getattr(ctx, "generation", 0)),
              total=total, tag=quantize)
    comp = ef.compensate(flat)
    if bucket_bytes is None:
        # residual commits only AFTER the round ships: a raise leaves
        # it untouched, so a same-key retry re-compensates the exact
        # same stream (nothing reached the wire that round)
        pend = ef.pending(comp, quantize)
        out = _ring_call(
            ctx, timeout_s,
            lambda ring: ring.reduce(comp, op=op, quantize=quantize),
            bump_step=True)
        ef.commit(pend)
        return _restore(rebuild_from_layout(
            np.asarray(out, np.float32).reshape(-1), layout), like)
    offs, cum = [], 0
    for a, b in _bucket_parts(leaves, bucket_bytes):
        n = int(sum(l.size for l in leaves[a:b]))
        offs.append((cum, cum + n))
        cum += n
    pend: dict = {}

    def stage(i):
        a, b = offs[i]
        seg = comp[a:b]
        pend[i] = ef.pending(seg, quantize)
        return seg

    def run(ring):
        def rf(i, seg):
            o = ring.reduce(seg, op=op, quantize=quantize)
            # this bucket's frames shipped — its residual slice is real
            ef.commit(pend.pop(i), offset=offs[i][0])
            return o

        outs, _ = _pipeline_buckets(len(offs), stage, rf)
        return np.concatenate(
            [np.asarray(o, np.float32).reshape(-1) for o in outs]) \
            if outs else np.empty(0, np.float32)

    try:
        out = _ring_call(ctx, timeout_s, run, bump_step=True)
    except BaseException:
        # some buckets shipped, some did not: the residual's slices
        # now describe different rounds — zero it rather than let a
        # retry double-compensate the committed part
        ef.invalidate()
        raise
    return _restore(rebuild_from_layout(out, layout), like)


def allreduce_gradients(value: Any, op: str = "mean", *,
                        quantize: Optional[str] = None,
                        wire_dtype: Optional[str] = None,
                        codec: Optional[str] = None,
                        bucket_bytes: Optional[int] = None,
                        timeout_s: Optional[float] = None) -> Any:
    """Elementwise allreduce of a host gradient pytree (dict / list /
    tuple / NamedTuple of numpy-compatible arrays) across the train
    worker group, over the controller-wired chunked ring (dag/ring.py:
    per-worker traffic is O(S) independent of group size, segments
    pipeline around the ring, accumulation is float32-or-wider).

    ``quantize="int8"`` ships chunks block-quantized — ~26% of the fp32
    wire bytes (``"int4"``: two values per byte, ~13%, coarse enough
    that it should only run under error-feedback — see ``codec``
    below); the per-round elementwise error bound
    (world_size * max_block_scale / 2) is exported as the
    ``allreduce_quant_error`` gauge, labelled by codec.
    ``wire_dtype="bfloat16"`` instead
    ships chunks cast to bfloat16 — half the fp32 bytes, ~2^-8 relative
    rounding per hop, still accumulating in float32 per the
    accumulation_dtype rules (bf16 gradient sync for groups that do not
    shard the optimizer — ZeRO users get the same lever per phase via
    ShardedOptimizer). All results are bitwise identical across
    workers, so SPMD state cannot diverge.

    ``bucket_bytes`` splits the pytree into leaf buckets of about that
    size and PIPELINES them: the ring starts reducing early buckets
    while later leaves are still being staged to host, hiding staging
    under ring I/O (the hidden time lands in the
    ``allreduce_bucket_overlap_s`` histogram). Results stay bitwise
    identical ACROSS RANKS (the per-bucket rounds keep the ring's
    guarantee); vs the unbucketed sync they are numerically
    equivalent — each element's contributions may associate in a
    different ring order, the same reduction-order rounding any ring
    reshape implies (bitwise equal whenever sums are exact). All
    ranks must pass the same ``bucket_bytes``.

    ``codec`` names the whole wire policy in one arg — "int4", "int8",
    "bf16", "fp32", or "auto" — and is mutually exclusive with
    ``quantize``/``wire_dtype``. Lossy codecs chosen this way run with
    **error-feedback accumulation** (Config.codec_error_feedback, on
    by default): each rank carries the quantization residual into the
    next round, which is what makes int8/int4 convergence-safe
    (the JAX package's ZERO_BENCH.json, codec_convergence).
    ``codec="auto"`` picks the cheapest codec whose observed
    ``allreduce_quant_error`` stays
    under Config.collective_codec_error_bound — payloads under
    Config.collective_codec_min_bytes stay fp32, and with EF off the
    lossy codecs are never chosen. The resolution is itself a tiny
    agreed collective (one max-reduce of the live error gauges, plus
    the dag/tuner.py codec-band probe once per generation): the inputs
    to the choice are rank-local, and the chosen tag sets the round's
    wire options, so ranks must agree on it or the ring would decode
    mismatched frames.

    Every worker must call this the same number of times with matching
    layouts and options; a worker that dies mid-ring surfaces as a
    RuntimeError on every survivor within the ring timeout."""
    ctx = get_context()
    if bucket_bytes is not None and bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be > 0")
    _pre_collective(
        ctx, "allreduce",
        f"allreduce:op={op}:quantize={quantize}:wire={wire_dtype}:"
        f"codec={codec}:bucket={bucket_bytes}", timeout_s)
    if codec is not None:
        if quantize is not None or wire_dtype is not None:
            raise ValueError(
                "codec and quantize/wire_dtype are competing wire "
                "selectors — pass at most one")
        if codec not in _CODEC_NAMES:
            raise ValueError(
                f"codec must be one of {_CODEC_NAMES}, got {codec!r}")
        from ray_tpu_torch.config import get_config
        ef_on = bool(getattr(get_config(), "codec_error_feedback", True))
        if ctx.get_world_size() == 1:
            tag = "fp32" if codec == "auto" else codec
            q, w = _CODEC_WIRE[tag]
            _validate_codec_opts(value, op, q, w)
            return value
        tag = _resolve_codec(ctx, value, codec, ef_on, timeout_s)
        quantize, wire_dtype = _CODEC_WIRE[tag]
        if quantize is not None and ef_on:
            return _ef_allreduce(ctx, value, op, quantize,
                                 bucket_bytes, timeout_s)
        # lossless/cast resolution falls through to the plain path
    if ctx.get_world_size() == 1:
        _validate_codec_opts(value, op, quantize, wire_dtype)
        return value
    from ray_tpu_torch.dag.ring import _UNSET
    if bucket_bytes is not None:
        return _ring_call(
            ctx, timeout_s, lambda ring: _bucketed_allreduce(
                ring, value, op, quantize, wire_dtype, bucket_bytes),
            bump_step=True)
    host, like = _to_host(value)
    return _restore(_ring_call(ctx, timeout_s, lambda ring: ring.reduce(
        host, op=op,
        quantize=quantize if quantize is not None else _UNSET,
        wire_dtype=wire_dtype if wire_dtype is not None else _UNSET),
        bump_step=True), like)


def reduce_scatter_gradients(value: Any, op: str = "mean", *,
                             quantize: Optional[str] = None,
                             bucket_bytes: Optional[int] = None,
                             timeout_s: Optional[float] = None):
    """Reduce-scatter a host gradient pytree across the train worker
    group: each worker receives ONLY its owned contiguous shard of the
    flat elementwise reduction (``get_context().shard_bounds(total)``
    of the flattened value space, mean already divided) — half an
    allreduce's wire bytes, and the input to a sharded (ZeRO-1)
    optimizer update (train/zero.py wraps this + allgather_params into
    ``ShardedOptimizer``). The flat layout is cached ring-side so a
    following ``allgather_params`` reassembles the full pytree.

    ``bucket_bytes`` splits the pytree into leaf buckets and pipelines
    staging against the ring (see ``allreduce_gradients``); the return
    value is then the CONCATENATION of this rank's per-bucket owned
    shards (each bucket's flat space split by ``seg_bounds``) — pass
    it back to ``allgather_params`` unchanged, which reassembles via
    the cached bucket layout. All ranks must pass the same
    ``bucket_bytes``.

    world_size == 1 returns the whole flattened vector (the "shard" is
    everything)."""
    ctx = get_context()
    if bucket_bytes is not None and bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be > 0")
    _pre_collective(
        ctx, "reduce_scatter",
        f"reduce_scatter:op={op}:quantize={quantize}:"
        f"bucket={bucket_bytes}", timeout_s)
    if ctx.get_world_size() == 1:
        _validate_codec_opts(value, op, quantize, None)
        from ray_tpu_torch.dag.ring import (_flatten, _keeps_wide,
                                            _wire_dtype, to_host)
        from ray_tpu_torch.train.zero import _flat
        value, ctx._rs_like = to_host(value)
        leaves0, _, _ = _flatten(value)
        wire = _wire_dtype([l.dtype for l in leaves0], op) \
            if leaves0 else np.dtype(np.float32)
        flat, rebuild, total, leaves = _flat(value, wire)
        # same cast-back policy as the ring: integer MEANS stay in the
        # wide wire dtype (a cast back to int would truncate)
        ctx._local_rs_layout = {
            "rebuild": rebuild, "total": total, "wire": wire,
            "leaves": [(l.shape, l.size,
                        wire if _keeps_wide(l.dtype, op) else l.dtype)
                       for l in leaves]}
        return flat
    from ray_tpu_torch.dag.ring import _UNSET
    if bucket_bytes is not None:
        # no bump: the ZeRO step's allgather half must share this tag
        return _ring_call(
            ctx, timeout_s, lambda ring: _bucketed_reduce_scatter(
                ctx, ring, value, op, quantize, bucket_bytes))
    ctx._bucketed_rs = None      # an unbucketed RS retires stale meta
    host, ctx._rs_like = _to_host(value)
    # no bump: the ZeRO step's allgather half must share this tag
    return _ring_call(ctx, timeout_s, lambda ring: ring.reduce_scatter(
        host, op=op,
        quantize=quantize if quantize is not None else _UNSET))


def allgather_params(shard, *, wire_dtype: Optional[str] = None,
                     timeout_s: Optional[float] = None,
                     total_hint: Optional[int] = None,
                     bucket_bytes: Optional[int] = None):
    """Allgather each worker's owned flat shard back into the full
    value: the ZeRO-1 parameter reassembly. When the ring holds a
    layout cached by a previous ``reduce_scatter_gradients``, the full
    PYTREE comes back (leaves cast to their input dtypes); otherwise
    the flat vector. The cached layout is matched by owned-slice
    length — pass ``total_hint`` (the flat element count you expect to
    reassemble) to pin the match exactly when gathering something
    other than the last reduce-scatter's result.
    ``wire_dtype="bfloat16"`` ships frames in bf16 —
    half the fp32 wire bytes, one rounding event, bitwise identical on
    every rank (the shard owner round-trips its own copy).

    After a BUCKETED ``reduce_scatter_gradients`` (matching
    ``bucket_bytes``, or the shard length matching the cached bucket
    layout), the concatenated per-bucket shards are split back, each
    bucket allgathers (pipelined), and the full pytree reassembles —
    bitwise identical to the unbucketed path.

    world_size == 1 rebuilds locally — applying the same single
    wire-dtype rounding, so 1-worker runs reproduce the sharded
    numerics."""
    ctx = get_context()
    if bucket_bytes is not None and bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be > 0")
    # the descriptor names OPTIONS only, never per-rank values (shard
    # lengths legitimately differ across ranks)
    _pre_collective(
        ctx, "allgather",
        f"allgather:wire={wire_dtype}:bucket={bucket_bytes}", timeout_s)
    if ctx.get_world_size() == 1:
        from ray_tpu_torch.dag.ring import resolve_wire_dtype, wire_roundtrip
        wdt = resolve_wire_dtype(wire_dtype)
        flat = _stage(shard).reshape(-1)
        layout = getattr(ctx, "_local_rs_layout", None)
        if layout is not None and (
                layout["total"] != total_hint if total_hint is not None
                else layout["total"] != flat.size):
            layout = None
        if layout is not None:
            flat = np.asarray(flat, dtype=layout["wire"])
        if wdt is not None and flat.dtype.kind != "f":
            # same refusal the ring's _check_codec_wire issues: a bf16
            # cast of integers must not pass on 1 worker and only
            # explode at scale
            raise TypeError(
                f"wire_dtype={wire_dtype!r} requires floating-point "
                f"values (wire dtype would be {flat.dtype})")
        if wdt is not None:
            flat = wire_roundtrip(flat, wdt)
        if layout is None or layout["total"] != flat.size:
            return flat
        from ray_tpu_torch.dag.ring import rebuild_from_layout
        return _restore(rebuild_from_layout(flat, layout),
                        getattr(ctx, "_rs_like", None))
    from ray_tpu_torch.dag.ring import _UNSET
    meta = getattr(ctx, "_bucketed_rs", None)
    if meta is not None:
        n_el = int(shard.numel()) if hasattr(shard, "numel") \
            else int(np.asarray(shard).size)
        if bucket_bytes is not None:
            use = meta["bucket_bytes"] == bucket_bytes
        elif total_hint is not None:
            use = total_hint == meta["total"]
        else:
            # no explicit pin: match by this rank's summed per-bucket
            # owned length (same stale-layout guard as the flat path)
            owned = 0
            try:
                ring = ctx.gradient_sync_ring()
                owned = sum((lambda b: b[1] - b[0])(ring.seg_bounds(t))
                            for t in meta["totals"])
            except Exception:   # noqa: BLE001 — fall through unmatched
                pass
            use = owned == n_el and owned > 0
        if use:
            return _ring_call(
                ctx, timeout_s, lambda ring: _bucketed_allgather(
                    ctx, ring, shard, wire_dtype, meta),
                bump_step=True)
    return _restore(_ring_call(ctx, timeout_s, lambda ring: ring.allgather(
        _stage(shard),
        wire_dtype=wire_dtype if wire_dtype is not None else _UNSET,
        total_hint=total_hint), bump_step=True),
        getattr(ctx, "_rs_like", None))


def barrier(tag: str = "default", timeout: float = 120.0) -> None:
    """Block until every worker in the group reaches the same barrier
    (reference: collectives.py:59)."""
    ctx = get_context()
    gen = ctx.group_id  # per-incarnation namespace (see TrainContext)
    epoch = _epochs.get(("b", gen, tag), 0)
    _epochs[("b", gen, tag)] = epoch + 1
    key = f"{gen}:barrier:{tag}:{epoch}"
    h = _rendezvous_handle()
    ray_tpu_torch.get(h.arrive.remote(key, ctx.get_world_rank(),
                                ctx.get_world_size()), timeout=timeout)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if ray_tpu_torch.get(h.arrived.remote(key, ctx.get_world_size()),
                       timeout=timeout):
            return
        time.sleep(0.02)
    raise TimeoutError(f"barrier {tag!r} timed out")


def broadcast_from_rank_zero(data: Any = None, tag: str = "default",
                             timeout: float = 120.0) -> Any:
    """Rank 0's value to everyone (reference: collectives.py:16)."""
    ctx = get_context()
    gen = ctx.group_id
    epoch = _epochs.get(("bc", gen, tag), 0)
    _epochs[("bc", gen, tag)] = epoch + 1
    key = f"{gen}:bcast:{tag}:{epoch}"
    h = _rendezvous_handle()
    if ctx.get_world_rank() == 0:
        ray_tpu_torch.get(h.put_value.remote(key, data), timeout=timeout)
        return data
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, value = ray_tpu_torch.get(h.get_value.remote(key),
                                          timeout=timeout)
        if status == "ok":
            return value
        time.sleep(0.02)
    raise TimeoutError(f"broadcast {tag!r} timed out")
