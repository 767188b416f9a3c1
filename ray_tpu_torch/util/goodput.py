"""Goodput ledger: per-rank, per-step wall-time anatomy.

The port's copy of ``ray_tpu/util/goodput.py``; the peak for
``train_mfu`` comes from the CUDA device's name (``_peak``), and the
compile category from the port's device monitor, whose compiles are the
``nvcc`` builds of the kernel sources at first use.

Partitions every training step's wall clock into named categories so
"where did the step time go?" has a measured answer, continuously:

  compute       time inside explicitly stamped compute intervals (the
                ZeRO optimizer math, pipeline fwd/bwd, or the user's
                own ``goodput.interval("compute")`` blocks)
  comm_exposed  collective wait that was NOT hidden under compute —
                the ring tracer's per-round recv-wait spans
                (``dag/ring.py``), exported here round by round
  bubble        pipeline schedule idle (stage waiting on an activation
                that is not yet in flight — ``dag/runtime.py``)
  ckpt_stall    checkpoint snapshot + backpressure time on the step
                path (``train/ckptio.py``)
  compile       kernel build spans (``util/devmon.py``; builds found
                already on disk excluded)
  idle          the residual — wall time no subsystem claimed

Hard invariant: the categories sum EXACTLY to the step's wall time
(pinned in tests/test_zz_goodput.py). Stamped intervals nest — an
``add()`` inside an open ``interval()`` is carved OUT of the enclosing
category, so overlap never double-counts.

Discipline (same as ``collective_trace_level``): ``goodput_level="off"``
removes every clock read — each public call is one global compare and
an early return, no allocation, no ``perf_counter``.

Rows flow three ways:
  * ``goodput_*`` counters + the ``train_mfu`` gauge into the pushed
    metric stream (and the head's time-series store),
  * one "goodput"/"step" event per step into the flight buffer (the
    timeline/CLI/dashboard read these for per-rank anatomy),
  * a rolling per-rank anatomy summary over ``anatomy()`` that rides
    ``TrainWorker.poll()`` to the controller, where a
    :class:`StragglerDetector` compares ranks and names the outlier.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.util import events

CATEGORIES = ("compute", "comm_exposed", "bubble", "ckpt_stall",
              "compile", "idle")
#: categories that are stamped (idle is always the residual)
STAMPED = CATEGORIES[:-1]

_LEVEL: Optional[str] = None        # resolved lazily from Config
_RANK: int = -1
_FLOPS_PER_STEP: float = 0.0
_PEAK_TFLOPS: Optional[float] = None
_PEAK_RESOLVED = False
_TLS = threading.local()
_LOCK = threading.Lock()
_ROWS: Any = None                   # deque of closed step rows (shared)


def goodput_metrics() -> dict:
    """Get-or-create the goodput series (process-global registry,
    pushed to the head like every other worker metric). Catalog:

      goodput_seconds_total{category,rank}  wall seconds attributed to
                                            each step-anatomy category
      goodput_steps_total{rank}             steps closed by the ledger
      train_mfu{rank}                       model-FLOPs utilization:
                                            registered FLOPs/step over
                                            measured step wall against
                                            the generation's peak
                                            TFLOPs (accelerators.py)
      goodput_straggler_rank                controller-set: -1 healthy,
                                            else the rank whose p50
                                            step anatomy diverged past
                                            goodput_straggler_z
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "seconds": m.Counter(
            "goodput_seconds_total",
            "Step wall seconds attributed per anatomy category "
            "(compute / comm_exposed / bubble / ckpt_stall / compile "
            "/ idle; categories sum to step wall time)",
            tag_keys=("category", "rank")),
        "steps": m.Counter(
            "goodput_steps_total",
            "Training steps closed by the goodput ledger",
            tag_keys=("rank",)),
        "mfu": m.Gauge(
            "train_mfu",
            "Model FLOPs utilization: registered model FLOPs per step "
            "over measured step wall time, against the device "
            "generation's peak TFLOPs", tag_keys=("rank",)),
        "straggler": m.Gauge(
            "goodput_straggler_rank",
            "Rank whose p50 step anatomy diverges from the ring "
            "beyond goodput_straggler_z (-1 = healthy; set by the "
            "train controller's online straggler detector)"),
    }


# --- level / identity --------------------------------------------------


def _resolve_level() -> str:
    global _LEVEL
    try:
        from ray_tpu_torch.config import get_config
        lvl = str(getattr(get_config(), "goodput_level", "step"))
    except Exception:   # noqa: BLE001 — observability must not raise
        lvl = "step"
    _LEVEL = "off" if lvl == "off" else "step"
    return _LEVEL


def level() -> str:
    return _LEVEL if _LEVEL is not None else _resolve_level()


def set_level(lvl: str) -> None:
    """Override the ledger level for this process (tests; production
    uses the ``goodput_level`` config knob / RAY_TPU_GOODPUT_LEVEL)."""
    global _LEVEL
    _LEVEL = "off" if str(lvl) == "off" else "step"


def enabled() -> bool:
    return level() != "off"


def set_rank(rank: int) -> None:
    global _RANK
    _RANK = int(rank)


def set_model_flops(flops_per_step: float, *,
                    device_kind: Optional[str] = None,
                    peak_tflops: Optional[float] = None) -> None:
    """Register the model cost so step_end can derive ``train_mfu``:
    ``flops_per_step`` from the model config (e.g.
    ``cfg.flops_per_token(seq) * tokens_per_step``), peak from
    ``accelerators.peak_tflops`` (explicit override wins)."""
    global _FLOPS_PER_STEP, _PEAK_TFLOPS, _PEAK_RESOLVED
    _FLOPS_PER_STEP = float(flops_per_step)
    if peak_tflops is not None:
        _PEAK_TFLOPS, _PEAK_RESOLVED = float(peak_tflops), True
    elif device_kind is not None:
        from ray_tpu_torch.util.accelerators import peak_tflops as _pt
        _PEAK_TFLOPS, _PEAK_RESOLVED = _pt(device_kind), True


def _peak() -> Optional[float]:
    """Peak TFLOPs, resolved once: explicit registration wins, else the
    name of this process's CUDA device (``torch.cuda.get_device_name``;
    a process that never imported torch, or sees no card, has no MFU
    gauge)."""
    global _PEAK_TFLOPS, _PEAK_RESOLVED
    if _PEAK_RESOLVED:
        return _PEAK_TFLOPS
    _PEAK_RESOLVED = True
    try:
        import sys
        torch = sys.modules.get("torch")
        from ray_tpu_torch.util.accelerators import peak_tflops as _pt
        kind = (torch.cuda.get_device_name()
                if torch is not None and torch.cuda.is_available() else "")
        _PEAK_TFLOPS = _pt(kind) if kind else None
    except Exception:   # noqa: BLE001
        _PEAK_TFLOPS = None
    return _PEAK_TFLOPS


# --- the ledger --------------------------------------------------------


class _Interval:
    """Reusable per-(thread, category) stamped interval. Nesting-aware:
    time claimed by inner intervals / ``add()`` calls is carved out of
    this one, so the step's category sums never double-count. Same-
    category re-entrance times only the outermost entry."""

    __slots__ = ("_st", "_cat", "_t0", "_carve", "_depth")

    def __init__(self, st: "_StepState", cat: str):
        self._st, self._cat = st, cat
        self._t0 = 0.0
        self._carve = 0.0
        self._depth = 0

    def __enter__(self):
        st = self._st
        if not st.open or self._depth:
            self._depth += 1
            return self
        self._depth = 1
        self._carve = 0.0
        st.stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._depth -= 1
        st = self._st
        if self._depth or not st.open:
            return False
        elapsed = time.perf_counter() - self._t0
        if st.stack and st.stack[-1] is self:
            st.stack.pop()
        own = elapsed - self._carve
        if own > 0.0:
            st.acc[self._cat] = st.acc.get(self._cat, 0.0) + own
        if st.stack:            # the whole span belongs to my parent's
            st.stack[-1]._carve += elapsed      # carve, not just `own`
        return False


class _NoopInterval:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopInterval()


class _StepState:
    __slots__ = ("open", "depth", "step", "rank", "t0", "acc", "stack",
                 "ivs")

    def __init__(self):
        self.open = False
        self.depth = 0
        self.step = 0
        self.rank = -1
        self.t0 = 0.0
        self.acc: Dict[str, float] = {}
        self.stack: list = []
        self.ivs: Dict[str, _Interval] = {}


def _state() -> _StepState:
    st = getattr(_TLS, "st", None)
    if st is None:
        st = _TLS.st = _StepState()
    return st


def _rows_deque():
    global _ROWS
    if _ROWS is None:
        import collections
        try:
            from ray_tpu_torch.config import get_config
            n = int(getattr(get_config(),
                            "goodput_straggler_window_steps", 32))
        except Exception:   # noqa: BLE001
            n = 32
        _ROWS = collections.deque(maxlen=max(4, n))
    return _ROWS


def step_begin(step: int, rank: Optional[int] = None) -> None:
    """Open this thread's step window (re-entrant: a nested
    ``trace_step`` inside an open step is depth-counted, not a new
    row)."""
    if level() == "off":
        return
    st = _state()
    if st.open:
        st.depth += 1
        return
    st.open = True
    st.depth = 0
    st.step = int(step)
    st.rank = _RANK if rank is None else int(rank)
    st.acc = dict.fromkeys(STAMPED, 0.0)
    st.stack.clear()
    st.t0 = time.perf_counter()


def step_end() -> None:
    """Close the window: compute the residual, pin the sum-to-wall
    identity, and commit the row (metrics + event + anatomy window)."""
    if level() == "off":
        return
    st = _state()
    if not st.open:
        return
    if st.depth:
        st.depth -= 1
        return
    wall = time.perf_counter() - st.t0
    st.open = False
    st.stack.clear()
    if wall <= 0.0:
        return
    _commit(st.step, st.rank, wall, st.acc)


def interval(category: str):
    """Zero-alloc stamped interval: ``with goodput.interval("compute")``
    around a block attributes its exclusive time to ``category``."""
    if level() == "off":
        return _NOOP
    st = _state()
    iv = st.ivs.get(category)
    if iv is None:
        iv = st.ivs[category] = _Interval(st, category)
    return iv


def add(category: str, seconds: float) -> None:
    """Attribute a pre-measured duration (a ring round's recv wait, a
    snapshot stall, a compile span). Inside an open stamped interval
    the seconds are carved out of the enclosing category; outside any
    step window they still reach the counters (truthful totals) but
    join no step row."""
    if level() == "off" or seconds <= 0.0:
        return
    st = _state()
    if not st.open:
        try:
            goodput_metrics()["seconds"].inc(
                seconds, tags={"category": category,
                               "rank": str(_RANK)})
        except Exception:   # noqa: BLE001
            pass
        return
    st.acc[category] = st.acc.get(category, 0.0) + seconds
    if st.stack:
        st.stack[-1]._carve += seconds


def record_step(step: int, wall_s: float, rank: Optional[int] = None,
                **cats: float) -> None:
    """Commit one pre-aggregated step row directly (the pipeline exec
    loop accounts bubble/compute itself — no interval stamping)."""
    if level() == "off" or wall_s <= 0.0:
        return
    acc = dict.fromkeys(STAMPED, 0.0)
    for k, v in cats.items():
        if k in acc and v > 0.0:
            acc[k] += float(v)
    _commit(int(step), _RANK if rank is None else int(rank),
            float(wall_s), acc)


def _commit(step: int, rank: int, wall: float,
            acc: Dict[str, float]) -> None:
    stamped = sum(acc.values())
    if stamped > wall > 0.0:
        # clock skew / overlapping stamps: scale so the identity is
        # exact rather than letting idle go negative
        scale = wall / stamped
        for k in acc:
            acc[k] *= scale
        idle = 0.0
    else:
        idle = wall - stamped
    row = {"step": step, "rank": rank, "wall_s": wall, "idle": idle}
    for c in STAMPED:
        row[c] = acc.get(c, 0.0)
    with _LOCK:
        _rows_deque().append(row)
    try:
        m = goodput_metrics()
        rs = str(rank)
        for c in STAMPED:
            if row[c] > 0.0:
                m["seconds"].inc(row[c],
                                 tags={"category": c, "rank": rs})
        if idle > 0.0:
            m["seconds"].inc(idle, tags={"category": "idle",
                                         "rank": rs})
        m["steps"].inc(tags={"rank": rs})
        mfu = None
        if _FLOPS_PER_STEP > 0.0:
            peak = _peak()
            if peak:
                mfu = _FLOPS_PER_STEP / wall / (peak * 1e12)
                m["mfu"].set(mfu, tags={"rank": rs})
        events.record(
            "goodput", "step", ph="X", ts=time.time() - wall,
            dur=wall, step=step, rank=rank,
            wall_s=round(wall, 6), idle_s=round(idle, 6),
            **{f"{c}_s": round(row[c], 6) for c in STAMPED},
            **({"mfu": round(mfu, 4)} if mfu is not None else {}))
    except Exception:   # noqa: BLE001 — observability must not raise
        pass


def anatomy() -> Optional[Dict[str, Any]]:
    """Rolling per-rank step-anatomy summary (p50 per category over
    the window) — rides ``TrainWorker.poll()`` to the controller's
    straggler detector."""
    if level() == "off":
        return None
    with _LOCK:
        rows = list(_ROWS) if _ROWS else []
    if not rows:
        return None
    import statistics
    p50 = {c: statistics.median(r[c] for r in rows)
           for c in STAMPED + ("idle",)}
    return {"rank": rows[-1]["rank"], "steps": len(rows),
            "wall_p50": statistics.median(r["wall_s"] for r in rows),
            "p50": p50}


def recent_rows() -> list:
    """Closed step rows currently in the anatomy window (tests/CLI)."""
    with _LOCK:
        return list(_ROWS) if _ROWS else []


def reset() -> None:
    """Drop ledger state (NOT the registered metrics — those keep
    their monotone totals, same as every plane's reset)."""
    global _ROWS, _FLOPS_PER_STEP, _PEAK_TFLOPS, _PEAK_RESOLVED, _LEVEL
    with _LOCK:
        _ROWS = None
    _TLS.st = None
    _FLOPS_PER_STEP = 0.0
    _PEAK_TFLOPS = None
    _PEAK_RESOLVED = False
    _LEVEL = None


# --- online straggler detection ---------------------------------------


class StragglerDetector:
    """Names the rank whose p50 step anatomy diverges from the ring.

    The signal is ``d_r = p50(compute) - p50(comm_exposed + idle)``
    per rank: on a healthy ring every rank computes and waits about
    the same, so ``d`` clusters; the straggler computes LONGER and
    waits LESS (its peers absorb the wait), pushing its ``d`` above
    the pack. Idle counts as wait: WHERE a peer's absorbed wait lands
    depends on its ring position (a rank behind the straggler blocks
    on recv -> comm_exposed; a rank ahead of it backs up on send ->
    idle residual), and subtracting only comm_exposed would spread the
    healthy ranks' ``d`` and inflate the MAD denominator. A robust
    z-score (median/MAD) over ``d`` flags the top rank when it clears
    ``z_threshold`` AND an absolute gap floor (``min_gap_s`` — quiet
    on uniform ranks where MAD ~ 0 would otherwise amplify noise)."""

    def __init__(self, z_threshold: float = 6.0, min_steps: int = 8,
                 min_gap_s: float = 0.005):
        self.z_threshold = float(z_threshold)
        self.min_steps = int(min_steps)
        self.min_gap_s = float(min_gap_s)
        self._an: Dict[int, dict] = {}

    def observe(self, rank: int, anatomy: Optional[dict]) -> None:
        if anatomy and int(anatomy.get("steps", 0)) >= self.min_steps:
            self._an[int(rank)] = anatomy

    def check(self) -> Dict[str, Any]:
        """One detection pass over the latest per-rank summaries.
        Returns ``{"rank": -1}`` when healthy, else the flagged rank
        with its z-score and absolute gap."""
        import statistics
        if len(self._an) < 3:
            return {"rank": -1, "z": 0.0, "gap_s": 0.0}
        d = {r: a["p50"].get("compute", 0.0)
             - a["p50"].get("comm_exposed", 0.0)
             - a["p50"].get("idle", 0.0)
             for r, a in self._an.items()}
        med = statistics.median(d.values())
        mad = statistics.median(abs(v - med) for v in d.values())
        denom = 1.4826 * mad + 1e-4
        top = max(d, key=lambda r: d[r])
        gap = d[top] - med
        z = gap / denom
        if z >= self.z_threshold and gap >= self.min_gap_s:
            return {"rank": top, "z": z, "gap_s": gap}
        return {"rank": -1, "z": z, "gap_s": gap}
