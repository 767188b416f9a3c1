"""Device-plane observability on ``torch.cuda``: compile records, HBM
accounting and the device duty cycle.

Counterpart of ``ray_tpu/util/devmon.py``, with its series names and
event shapes:

- **Compile records**: :func:`record_compile` records one compile as a
  span in the budget-capped "device" event category (function name,
  duration, the ambient request trace) and counts it in the ``xla_*``
  series, with the same recompile-storm gate
  (``Config.devmon_recompile_threshold`` compiles of one function inside
  ``Config.devmon_recompile_window_s``). Eager PyTorch compiles nothing
  per shape, so the reference's ``jax.monitoring`` listener and its log
  correlator have no counterpart here: the port's one compile is the
  ``nvcc`` build of a kernel source at first use, which ``ops/_build.py``
  reports through :func:`record_compile`. The reference's call into the
  goodput ledger waits for the port's ``util/goodput.py``.
- **HBM accounting**: :func:`hbm_snapshot` reads every visible CUDA
  device's allocator (``torch.cuda.memory_allocated``,
  ``max_memory_allocated``) and its capacity (``torch.cuda.mem_get_info``)
  into the ``device_hbm_*{device="cuda:<i>"}`` gauges. It returns ``[]``
  while CUDA is not initialised in the process, as the reference does
  while jax is not imported. The reference's CPU estimate over
  ``jax.live_arrays()`` has no torch counterpart: a CPU tensor is not in
  device memory, so there is nothing to count.
- **Duty cycle**: callers that bracket device work with a host sync
  report the interval through :func:`record_device_window` (or the
  :func:`device_window` context manager); :func:`duty_cycle` is the
  union of those windows over ``Config.devmon_duty_horizon_s``.

``RAY_TPU_DEVMON=0`` turns the whole plane off at process start (every
record path no-ops), as in the reference. The periodic ``monitor_loop``
waits for the port's worker runtime.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from ray_tpu_torch.util import events

logger = logging.getLogger("ray_tpu_torch.devmon")

_OFF = ("0", "false", "off")
_ENABLED = os.environ.get("RAY_TPU_DEVMON", "1").lower() not in _OFF

_LOCK = threading.Lock()

# per-function compile timestamps inside the storm window, the last
# time a storm was flagged for that function (one flag per window),
# and whether the function ever compiled (compile #2+ is a RECOMPILE)
_COMPILE_HIST: Dict[str, deque] = {}
_STORM_FLAGGED: Dict[str, float] = {}
_EVER_COMPILED: Dict[str, bool] = {}

# duty-cycle windows: (t0, t1) wall-clock intervals of device work in
# this process, bounded (old windows age past any plausible horizon)
_WINDOWS: deque = deque(maxlen=4096)

# device label -> the highest used/peak bytes ever snapshotted
_PEAK: Dict[str, int] = {}

_DEVICE_LABEL: Optional[str] = None


def enabled() -> bool:
    return _ENABLED


def devmon_metrics() -> dict:
    """Get-or-create the device-plane metrics (the reference's names, so
    one dashboard reads both packages). Catalog:

      xla_compiles_total{fn}          compiles (here: nvcc kernel builds)
      xla_recompiles_total{fn}        compiles beyond the first per fn
      xla_recompile_storms_total{fn}  storm flags
      xla_cache_hits_total            compiles answered from a cache
      xla_compile_s                   compile duration distribution,
                                      exemplar-linked to the request
                                      trace that triggered it
      device_hbm_used_bytes{device}   device memory allocated by torch
      device_hbm_limit_bytes{device}  device memory capacity
      device_hbm_peak_bytes{device}   high watermark
      device_duty_cycle{device}       fraction of wall time inside
                                      device windows over the horizon
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "compiles": m.Counter(
            "xla_compiles_total", "Backend XLA compiles in this process",
            tag_keys=("fn",)),
        "recompiles": m.Counter(
            "xla_recompiles_total",
            "XLA compiles beyond the first per function (recompile "
            "signal; persistent-cache hits are suppressed)",
            tag_keys=("fn",)),
        "storms": m.Counter(
            "xla_recompile_storms_total",
            "Recompile storms flagged (devmon_recompile_threshold "
            "compiles of one function inside "
            "devmon_recompile_window_s)", tag_keys=("fn",)),
        "cache_hits": m.Counter(
            "xla_cache_hits_total",
            "Persistent compilation cache hits"),
        "compile_s": m.Histogram(
            "xla_compile_s", "Backend XLA compile duration",
            boundaries=(.01, .05, .1, .25, .5, 1, 2.5, 5, 10, 30, 60)),
        "hbm_used": m.Gauge(
            "device_hbm_used_bytes", "Device HBM in use",
            tag_keys=("device",)),
        "hbm_limit": m.Gauge(
            "device_hbm_limit_bytes",
            "Device HBM capacity (0 when the backend reports none)",
            tag_keys=("device",)),
        "hbm_peak": m.Gauge(
            "device_hbm_peak_bytes", "Device HBM high watermark",
            tag_keys=("device",)),
        "duty": m.Gauge(
            "device_duty_cycle",
            "Fraction of wall time inside device-compute windows over "
            "devmon_duty_horizon_s", tag_keys=("device",)),
    }


# --- compile records ---------------------------------------------------


def _ambient_trace() -> str:
    from ray_tpu_torch.util import tracing
    return tracing.current_trace_id()


def record_compile(fn: str, dur_s: float, *,
                   cache_hit: bool = False) -> None:
    """One compile (or cache retrieval) as a "device" span + metrics +
    storm check."""
    if not _ENABLED:
        return
    now = time.time()
    trace = _ambient_trace()
    events.record("device", "compile", fn=fn, ts=now - dur_s, dur=dur_s,
                  cache_hit=cache_hit, pid=os.getpid(),
                  **({"trace": trace} if trace else {}))
    m = devmon_metrics()
    if cache_hit:
        m["cache_hits"].inc()
        return
    m["compiles"].inc(tags={"fn": fn})
    m["compile_s"].observe(dur_s, exemplar=trace or None)
    _note_compile(fn, now, m)


def _note_compile(fn: str, now: float, m: dict) -> None:
    """Recompile bookkeeping + the storm gate. Deterministic: with
    threshold T and window W, the Nth compile of ``fn`` increments
    ``xla_recompiles_total`` for N >= 2, and a storm is flagged exactly
    once per window the moment the in-window count reaches T."""
    from ray_tpu_torch.config import get_config
    cfg = get_config()
    thr = int(getattr(cfg, "devmon_recompile_threshold", 3))
    win = float(getattr(cfg, "devmon_recompile_window_s", 60.0))
    with _LOCK:
        dq = _COMPILE_HIST.setdefault(fn, deque(maxlen=1024))
        ever = _EVER_COMPILED.get(fn, False)
        _EVER_COMPILED[fn] = True
        dq.append(now)
        while dq and dq[0] < now - win:
            dq.popleft()
        in_window = len(dq)
        storm = (thr > 0 and in_window >= thr
                 and now - _STORM_FLAGGED.get(fn, -math.inf) >= win)
        if storm:
            _STORM_FLAGGED[fn] = now
    if ever:
        m["recompiles"].inc(tags={"fn": fn})
    if storm:
        m["storms"].inc(tags={"fn": fn})
        events.record("device", "recompile_storm", fn=fn,
                      count=in_window, window_s=win, pid=os.getpid())
        logger.warning(
            "devmon: recompile storm: %r compiled %d times in the last "
            "%.0fs (threshold %d)", fn, in_window, win, thr)


# --- HBM accounting ----------------------------------------------------


def _device_label(index: int) -> str:
    return f"cuda:{index}"


def hbm_snapshot(record: bool = True) -> List[dict]:
    """One snapshot of every visible CUDA device's memory: sets the
    device_hbm_* gauges and (by default) records a "device"/"hbm" event
    per device. Returns the rows, with the reference's keys: ``used`` is
    what torch's allocator holds for tensors, ``peak`` its high
    watermark, ``limit`` the device's capacity. Empty when devmon is off
    or CUDA is not initialised in this process."""
    if not _ENABLED or not torch.cuda.is_initialized():
        return []
    m = devmon_metrics()
    duty = duty_cycle()
    rows: List[dict] = []
    for d in range(torch.cuda.device_count()):
        label = _device_label(d)
        used = int(torch.cuda.memory_allocated(d))
        peak = int(torch.cuda.max_memory_allocated(d))
        limit = int(torch.cuda.mem_get_info(d)[1])
        _PEAK[label] = max(_PEAK.get(label, 0), used, peak)
        peak = _PEAK[label]
        tags = {"device": label}
        m["hbm_used"].set(used, tags)
        m["hbm_limit"].set(limit, tags)
        m["hbm_peak"].set(peak, tags)
        m["duty"].set(duty, tags)
        row = {"device": label, "used": used, "limit": limit,
               "peak": peak, "duty": duty, "source": "memory_stats"}
        rows.append(row)
        if record:
            events.record("device", "hbm", pid=os.getpid(), **row)
    return rows


# --- duty cycle --------------------------------------------------------


def _default_device_label() -> str:
    """The current CUDA device once CUDA is initialised, else the CPU
    (where the port's plain versions then ran the work)."""
    global _DEVICE_LABEL
    if _DEVICE_LABEL is None:
        if not torch.cuda.is_initialized():
            return "cpu:0"
        _DEVICE_LABEL = _device_label(torch.cuda.current_device())
    return _DEVICE_LABEL


def record_device_window(seg: str, t0: float, t1: float, *,
                         device: Optional[str] = None,
                         trace: str = "") -> None:
    """One completed device-compute window (bounded by the caller's host
    sync): feeds the duty-cycle estimator and records a
    "device_window"/"window" span (the per-node device lane in
    ``tracing.to_chrome``)."""
    if not _ENABLED or t1 <= t0:
        return
    with _LOCK:
        _WINDOWS.append((t0, t1))
    # windows are HIGH RATE (one per decode block): they live in their
    # own budget bucket so a steady serving load can't age the rare
    # compile/storm/hbm events out of "device"
    events.record("device_window", "window", seg=seg, ts=t0,
                  dur=t1 - t0,
                  device=device or _default_device_label(),
                  pid=os.getpid(),
                  **({"trace": trace} if trace else {}))


@contextlib.contextmanager
def device_window(seg: str, device: Optional[str] = None):
    """Context manager form: ``with devmon.device_window("decode"): ...``
    around a device section that ends in a host sync."""
    t0 = time.time()
    try:
        yield
    finally:
        record_device_window(seg, t0, time.time(), device=device,
                             trace=_ambient_trace())


def duty_cycle(horizon_s: Optional[float] = None,
               now: Optional[float] = None) -> float:
    """Fraction of the trailing ``horizon_s`` wall-clock seconds spent
    inside device windows (overlapping windows union'd — concurrent
    prefill + decode must not report > 1.0). Per process, as in the
    reference."""
    if horizon_s is None:
        from ray_tpu_torch.config import get_config
        horizon_s = float(getattr(get_config(),
                                  "devmon_duty_horizon_s", 30.0))
    horizon_s = max(1e-3, float(horizon_s))
    now = time.time() if now is None else now
    lo = now - horizon_s
    with _LOCK:
        spans = sorted((max(t0, lo), min(t1, now))
                       for t0, t1 in _WINDOWS if t1 > lo and t0 < now)
    busy, cur_lo, cur_hi = 0.0, None, None
    for t0, t1 in spans:
        if cur_hi is None or t0 > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = t0, t1
        else:
            cur_hi = max(cur_hi, t1)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return min(1.0, busy / horizon_s)


def _reset_for_tests() -> None:
    """Drop detector/duty/peak state."""
    with _LOCK:
        _COMPILE_HIST.clear()
        _STORM_FLAGGED.clear()
        _EVER_COMPILED.clear()
        _WINDOWS.clear()
        _PEAK.clear()
