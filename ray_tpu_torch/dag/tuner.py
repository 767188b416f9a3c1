"""In-situ auto-tuner for the collective plane: impl + chunk size per
payload band, from a one-shot micro-bench on the LIVE ring.

Replaces the static ``Config.allreduce_star_max_bytes`` crossover with
a measured one ("The Big Send-off", arxiv 2504.18658: the winning
collective regime switches with payload size, and the switch point is
a property of the deployment — hop latency and link bandwidth — not a
constant). The first collective op on a tuning-enabled ring runs two
tiny fused probe rounds (probes ARE collectives, so every rank reaches
them in lockstep and the group stays aligned), fits the classic
latency/bandwidth model ``t(S) = alpha + beta * S`` to the ring round,
and derives:

  * the star/ring crossover — the star pays ~4 hop latencies against
    the ring's 3(N-1), but its root moves O(N*S) bytes against the
    ring's O(S) per rank; equate and solve for S;
  * the hierarchical band — when the group spans nodes, cross-node
    bytes dominate large payloads and the ring-of-rings moves
    ~1/ranks-per-node of them, so payloads above a multiple of the
    star crossover go hierarchical;
  * a chunk size per payload — large enough that per-chunk framing
    costs less than the hop latency it hides, small enough that
    (4*(N-1)) chunks still pipeline around the ring.

Results are cached PER RING GENERATION: the cache key is the ring's
group id, which the train controller regenerates for every group
incarnation — a rewired (elastic) group re-probes instead of trusting
a dead topology's numbers. ``invalidate()`` drops entries explicitly.

The last probed profile doubles as the process default that
``dag.allreduce(impl="auto")`` consults at compile time (with the
static 4 MB knob as the fallback when nothing was ever probed), and
every decision lands in the ``collective_tuner_regime`` gauge
(0 = star, 1 = flat ring, 2 = hierarchical).

The port's copy of ``ray_tpu/dag/tuner.py`` (only import paths differ):
its bands and probes are the port's own, measured on the port's rings.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

REGIMES = {"star": 0, "ring": 1, "hier": 2}

_LOCK = threading.Lock()
_CACHE: Dict[str, dict] = {}     # group id -> profile entry
_DEFAULT: Optional[str] = None   # last probed group (compile-time table)
_MAX_ENTRIES = 64                # rings come and go with incarnations

# The codec band rides beside the impl/chunk profile: per ring
# generation, per wire codec, the probed round time and the observed
# quant-error bound. Separate cache because codec probes are optional
# (``allreduce_gradients(codec="auto")`` triggers them lazily) and a
# generation bump must drop BOTH — invalidate() clears this too.
_CODEC_CACHE: Dict[str, dict] = {}   # group id -> codec band entry

# Probe preference order, cheapest wire first: auto selection walks
# this list and takes the first codec whose probed error bound clears
# Config.collective_codec_error_bound (lossy codecs additionally
# require error-feedback to be on).
CODEC_ORDER = ("int4", "int8", "bf16", "fp32")
_LOSSY = ("int4", "int8")


def _cfg():
    from ray_tpu_torch.config import get_config
    return get_config()


def profile_for(group: str, size: int) -> Optional[dict]:
    """The cached profile for a ring generation, or None (the signal
    to probe). A same-named group with a different world size is a
    different ring — never reuse its numbers."""
    with _LOCK:
        e = _CACHE.get(group or "")
        return e if e is not None and e["size"] == int(size) else None


def register_profile(group: str, size: int, alpha_s: float,
                     beta_s_per_b: float, *,
                     hierarchical: bool = False) -> dict:
    """Install a profile (the probe path, and the hook benches/tests
    use to inject known numbers). Becomes the process default table."""
    global _DEFAULT
    entry = {"group": group or "", "size": int(size),
             "alpha_s": max(1e-7, float(alpha_s)),
             "beta_s_per_b": max(1e-12, float(beta_s_per_b)),
             "hierarchical": bool(hierarchical),
             "probed_at": time.time()}
    with _LOCK:
        if len(_CACHE) >= _MAX_ENTRIES:
            oldest = min(_CACHE, key=lambda k: _CACHE[k]["probed_at"])
            del _CACHE[oldest]
        _CACHE[entry["group"]] = entry
        _DEFAULT = entry["group"]
    return entry


def invalidate(group: Optional[str] = None) -> None:
    """Drop one ring generation's profile (or all of them): the next
    collective on a tuning ring re-probes. Clears the codec band for
    the same generation too — an elastic reshape changes the wire
    (different size, possibly different hosts), so a cached codec
    choice from the dead topology must not survive the bump."""
    global _DEFAULT
    with _LOCK:
        if group is None:
            _CACHE.clear()
            _CODEC_CACHE.clear()
            _DEFAULT = None
        else:
            _CACHE.pop(group, None)
            _CODEC_CACHE.pop(group, None)
            if _DEFAULT == group:
                _DEFAULT = None


def probe_ring(ring) -> dict:
    """The one-shot in-situ micro-bench: two fused sum rounds on the
    live ring (small + large payload, min of 2 reps each), linear fit,
    cache per the ring's group id. The caller (RingReducer) guards
    reentrancy — the probe rounds themselves must not re-probe."""
    import numpy as np
    big = max(64 * 1024,
              int(getattr(_cfg(), "collective_tuner_probe_bytes",
                          1 << 20)))
    small = max(16 * 1024, big // 8)
    times: List[float] = []
    for nbytes in (small, big):
        best = None
        v = np.zeros(max(1, nbytes // 4), np.float32)
        for _ in range(2):
            t0 = time.perf_counter()
            ring.reduce(v, op="sum")
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        times.append(best)
    ts, tb = times
    if tb > ts:
        beta = (tb - ts) / float(big - small)
        alpha = max(ts - beta * small, 0.05 * ts)
    else:
        # noise inverted the slope: split the big round half fixed
        # cost, half wire — keeps the derived crossover finite
        beta = tb / (2.0 * big)
        alpha = tb / 2.0
    # AGREE on the profile: each rank measured its own wall clock, and
    # the derived chunk size is part of the ring's wire contract (the
    # sender chunks by it, the receiver expects it) — one more tiny
    # collective makes every rank register the bitwise-identical mean
    # profile instead of its private one
    agreed = ring.reduce(np.array([alpha, beta], np.float64), op="mean")
    alpha, beta = float(agreed[0]), float(agreed[1])
    hier = bool(getattr(ring, "level", None) == "inter"
                or getattr(ring, "nnodes", 1) > 1)
    return register_profile(getattr(ring, "group", ""), ring.size,
                            alpha, beta, hierarchical=hier)


# --- the decision surface -------------------------------------------------


def star_crossover(size: int, alpha_s: float,
                   beta_s_per_b: float) -> int:
    """Payload at/below which the star beats the flat ring. From the
    alpha/beta decomposition of a ring round (3(N-1) hops, 2S(N-1)/N
    wire per rank) vs a star round (~4 hops, 2(N-1)S at the root):
    S* = N(3N-7)h / (2(N-1)^2 w) with h the per-hop latency and w the
    per-byte cost. N <= 2 keeps the static knob (the two topologies
    move the same bytes and the model degenerates)."""
    n = int(size)
    static = int(getattr(_cfg(), "allreduce_star_max_bytes",
                         4 * 1024 * 1024))
    if n <= 2 or (3 * n - 7) <= 0:
        return static
    h = alpha_s / (3.0 * (n - 1))
    w = beta_s_per_b * n / (2.0 * (n - 1))
    s = n * (3 * n - 7) * h / (2.0 * (n - 1) ** 2 * w)
    return int(min(max(s, 64 * 1024), 64 << 20))


def hier_crossover(size: int, alpha_s: float,
                   beta_s_per_b: float) -> int:
    """Payload at/above which the hierarchical path wins, when a
    two-level topology exists: the ring-of-rings pays ~2 extra rounds
    of (cheap, shm) hops but moves ~1/ranks-per-node of the cross-node
    bytes — so it takes over once wire bytes dominate, a few multiples
    of the star crossover, floored at 8 MB."""
    s = star_crossover(size, alpha_s, beta_s_per_b)
    return int(min(max(4 * s, 8 << 20), 256 << 20))


def _entry(key: Optional[str], size: int) -> Optional[dict]:
    with _LOCK:
        if key:
            e = _CACHE.get(key)
        elif _DEFAULT is not None:      # "" is a legal default key
            e = _CACHE.get(_DEFAULT)
        else:
            e = None
    return e if e is not None and e["size"] == int(size) else None


def _gauge(regime: str) -> None:
    try:
        from ray_tpu_torch.dag.ring import allreduce_metrics
        allreduce_metrics()["tuner_regime"].set(REGIMES[regime])
    except Exception:   # noqa: BLE001 — telemetry must never break
        pass


def choose_impl(payload_bytes: Optional[int], size: int, *,
                hierarchical: bool = False,
                key: Optional[str] = None) -> Optional[str]:
    """The tuned impl for one payload band, or None when no profile
    exists for ``key`` (nor a process default) — the caller falls back
    to the static crossover. ``hierarchical`` gates the "hier" regime
    (the topology must actually span nodes)."""
    e = _entry(key, size)
    if e is None or payload_bytes is None:
        return None
    a, b = e["alpha_s"], e["beta_s_per_b"]
    if payload_bytes <= star_crossover(size, a, b):
        impl = "star"
    elif hierarchical and payload_bytes >= hier_crossover(size, a, b):
        impl = "hier"
    else:
        impl = "ring"
    _gauge(impl)
    return impl


def tuned_chunk(group: str, size: int, payload_bytes: int,
                slot_bytes: int) -> Optional[int]:
    """Chunk size for one round from the ring's profile: at least the
    configured floor AND the bytes whose wire time equals one hop
    latency (smaller chunks pay more framing than they hide), at most
    the channel slot, aiming for ~4 in-flight chunks per ring step.
    None when this ring generation has no profile yet."""
    e = _entry(group, size)
    if e is None:
        return None
    n = max(2, int(size))
    h = e["alpha_s"] / (3.0 * (n - 1))
    w = e["beta_s_per_b"] * n / (2.0 * (n - 1))
    floor_b = int(h / w)
    target = int(payload_bytes) // (4 * (n - 1))
    lo = int(getattr(_cfg(), "collective_tuner_min_chunk_bytes",
                     64 * 1024))
    chunk = max(lo, floor_b, target)
    return int(max(4096, min(chunk, int(slot_bytes))))


def table(key: Optional[str], size: int,
          hierarchical: bool = False) -> Optional[List[dict]]:
    """The tuned payload-band table for reporting (benches, the CLI):
    [{"max_bytes": upper-bound-or-None, "impl": ...}, ...]."""
    e = _entry(key, size)
    if e is None:
        return None
    a, b = e["alpha_s"], e["beta_s_per_b"]
    s_star = star_crossover(size, a, b)
    rows = [{"max_bytes": s_star, "impl": "star"}]
    if hierarchical or e["hierarchical"]:
        s_h = hier_crossover(size, a, b)
        rows.append({"max_bytes": s_h, "impl": "ring"})
        rows.append({"max_bytes": None, "impl": "hier"})
    else:
        rows.append({"max_bytes": None, "impl": "ring"})
    return rows


# --- the codec band -------------------------------------------------------


def codec_profile_for(group: str, size: int) -> Optional[dict]:
    """The cached codec band for a ring generation, or None (the
    signal to probe): {"size": N, "codecs": {tag: {"round_s", "err"}}}.
    Same generation discipline as the impl profile — a same-named
    group at a different world size never reuses the band."""
    with _LOCK:
        e = _CODEC_CACHE.get(group or "")
        return e if e is not None and e["size"] == int(size) else None


def register_codec_profile(group: str, size: int, codec: str,
                           round_s: float, err: float) -> dict:
    """Record one codec's probed round time + observed quant-error
    bound for a ring generation (the probe path, and the injection
    hook benches/tests use). Eviction here is per-process and may
    leave RANKS disagreeing about what is cached — safe only because
    the probe decision is AGREED on the ring (_resolve_codec
    max-reduces the cache-miss bit, so one rank's eviction re-probes
    on all ranks in lockstep, never a lone collective)."""
    with _LOCK:
        if len(_CODEC_CACHE) >= _MAX_ENTRIES:
            oldest = min(_CODEC_CACHE,
                         key=lambda k: _CODEC_CACHE[k]["probed_at"])
            del _CODEC_CACHE[oldest]
        e = _CODEC_CACHE.setdefault(
            group or "", {"group": group or "", "size": int(size),
                          "codecs": {}, "probed_at": time.time()})
        if e["size"] != int(size):      # stale generation — replace
            e = {"group": group or "", "size": int(size),
                 "codecs": {}, "probed_at": time.time()}
            _CODEC_CACHE[group or ""] = e
        e["codecs"][codec] = {"round_s": float(round_s),
                              "err": float(err)}
        e["probed_at"] = time.time()
        return e


_CODEC_KW = {"int4": {"quantize": "int4"},
             "int8": {"quantize": "int8"},
             "bf16": {"wire_dtype": "bfloat16"},
             "fp32": {}}


def codec_wire_available(tag: str) -> bool:
    """LOCAL availability of one wire codec's prerequisites (bf16
    needs ml_dtypes; the lossy codecs need their frame cutters). No
    collectives here — a per-rank availability check must never be a
    round some peers skip."""
    import numpy as np
    from ray_tpu_torch.dag import ring as ring_mod
    try:
        if tag == "bf16":
            ring_mod.resolve_wire_dtype("bfloat16")
        elif tag in _LOSSY:
            ring_mod.codec_roundtrip(np.ones(2, np.float32), tag)
        return True
    except Exception:   # noqa: BLE001 — "missing" is the answer
        return False


def probe_codecs(ring) -> Optional[dict]:
    """One timed small round per wire codec on the live ring,
    recording wall time and the ``allreduce_quant_error`` bound the
    round observed. Probes are collectives, so the probe LIST must be
    identical on every rank: availability is checked locally first
    (``codec_wire_available`` — no collective can fail on a subset of
    hosts without stranding the rest), then min-agreed on the ring so
    a codec probes only where EVERY rank has its prerequisites. A
    genuine collective failure mid-probe (peer death, timeout) is
    terminal for the group and PROPAGATES — swallowing it would leave
    peers blocked in a round this rank skipped. The payload is
    rank-seeded noise (rank-skewed values exercise the error bound the
    way real gradients do), and the recorded band is itself max-agreed
    — per-rank clocks and quant errors differ, but every rank must
    register the bitwise-identical band for ``choose_codec`` to
    resolve the same tag everywhere."""
    import numpy as np
    from ray_tpu_torch.dag import ring as ring_mod
    avail = np.array([1.0 if codec_wire_available(t) else 0.0
                      for t in CODEC_ORDER], np.float64)
    agreed_avail = ring.reduce(avail, op="min")
    tags = [t for t, a in zip(CODEC_ORDER, agreed_avail) if a > 0]
    n = max(1, int(getattr(_cfg(), "collective_tuner_probe_bytes",
                           1 << 20)) // 32)
    v = np.random.default_rng(1 + getattr(ring, "rank", 0)) \
        .standard_normal(n).astype(np.float32)
    stats: List[float] = []
    for tag in tags:
        t0 = time.perf_counter()
        ring.reduce(v, op="mean", **_CODEC_KW[tag])
        stats.append(time.perf_counter() - t0)
        err = ring_mod.last_quant_error(tag)
        stats.append(0.0 if err is None else float(err))
    # max over ranks: the ring is as slow as its slowest rank, and the
    # error bound must cover every rank's frames
    agreed = ring.reduce(np.array(stats, np.float64), op="max")
    out = None
    for i, tag in enumerate(tags):
        out = register_codec_profile(getattr(ring, "group", ""),
                                     ring.size, tag,
                                     float(agreed[2 * i]),
                                     float(agreed[2 * i + 1]))
    return out


def choose_codec(payload_bytes: Optional[int], size: int, *,
                 key: Optional[str] = None,
                 ef_enabled: bool = True,
                 live_err: Optional[Dict[str, float]] = None) -> str:
    """Resolve ``codec="auto"`` for one payload: the cheapest wire
    codec that is SAFE for this round. Small payloads (below
    Config.collective_codec_min_bytes) stay fp32 — framing overhead
    and quant error buy nothing on a wire that cheap. Lossy codecs
    (int4/int8) require error-feedback; with EF off they are never
    chosen (bf16 is the floor). A codec is rejected when its probed
    error bound OR its live ``allreduce_quant_error`` reading (pass
    ``live_err={tag: bound}``) exceeds
    Config.collective_codec_error_bound. No codec band probed yet →
    bf16 when that state is transient (EF on, the tuner enabled to
    probe on the next round, ml_dtypes importable), fp32 otherwise —
    with the tuner off nothing will ever probe, so "auto" must not
    park forever on a codec whose prerequisites may not even import."""
    cfg = _cfg()
    bound = float(getattr(cfg, "collective_codec_error_bound", 1e-2))
    min_b = int(getattr(cfg, "collective_codec_min_bytes", 64 * 1024))
    if payload_bytes is not None and int(payload_bytes) < min_b:
        return "fp32"
    band = codec_profile_for(key or "", size)
    if band is None:
        if not ef_enabled \
                or not getattr(cfg, "collective_tuner", True) \
                or not codec_wire_available("bf16"):
            return "fp32"
        return "bf16"
    codecs = band["codecs"]
    for tag in CODEC_ORDER:
        if tag == "fp32":
            break               # the unconditional floor
        if tag in _LOSSY and not ef_enabled:
            continue
        if tag not in codecs:
            continue            # not probed (or probe failed) here
        err = codecs[tag]["err"]
        if live_err and tag in live_err:
            err = max(err, live_err[tag])
        if tag in _LOSSY and err > bound:
            continue            # the bound tripped — back off
        return tag
    return "fp32"
