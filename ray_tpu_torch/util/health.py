"""Cluster health plane: SLO burn-rate alerting + regression sentinels.

Sits on the head-side time-series store (util/timeseries.py) that the
metrics aggregation path feeds (control report_metrics -> ingest_push,
plus the head's own registry each evaluation tick). Three layers:

  objectives  declarative SLOs — per-deployment latency ("99% of
              requests under 1s") and availability ("99% non-5xx")
              from the serve histograms/counters, plus gauge health
              bounds (allreduce straggler rank, device HBM headroom).
              Defaults are DERIVED from the series the store has
              actually seen (Config.slo_default_objectives); user code
              can add/override via add_objective().
  alerts      each objective is evaluated as Google-SRE multi-window
              multi-burn-rate alerts: a "page"-tier alert fires when
              the error-budget burn rate exceeds Config.slo_fast_burn
              over BOTH fast windows (short AND long — the short
              window makes detection quick, the long window stops a
              single bad scrape from paging); a "warn" tier does the
              same over the slow windows at Config.slo_slow_burn.
              State transitions are recorded as budget-capped "health"
              events — they land in the chrome timeline next to the
              traces that explain them, with an exemplar trace id from
              the breaching histogram window attached.
  sentinels   live windows compared against pinned baselines
              (HEALTH_BASELINE.json, seeded from the committed BENCH_*
              trajectory): a p99 that drifts past baseline*tolerance
              flags a regression without anyone re-running the bench.

``RAY_TPU_HEALTH=0`` disables the whole plane at process start (the
same master-switch pattern as RAY_TPU_DEVMON); ``Config.health_enabled``
is the runtime off-switch the control service checks before starting
the loop. The engine's ``snapshot()`` is the machine-readable /health
contract — per-deployment burn state is exactly the input the
SLO-driven replica autoscaler (serve/autoscale.py) reads, and
serve/proxy.py consults it at shed time.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.util import events
from ray_tpu_torch.util.timeseries import TimeSeriesStore

_OFF = ("0", "false", "off")
_ENABLED = os.environ.get("RAY_TPU_HEALTH", "1").lower() not in _OFF


def enabled() -> bool:
    """Master switch (read at process start, like RAY_TPU_DEVMON);
    Config.health_enabled additionally gates the head loop."""
    return _ENABLED


_MCACHE: Optional[dict] = None


def health_metrics() -> dict:
    """Get-or-create the health plane's own catalog (lint-registered;
    the store/evaluator watch themselves like every other plane).
    Cached: this runs on EVERY worker push at the head, so it must not
    re-instantiate 8 metrics per call — the identity check re-builds
    only after a test `metrics.reset()` swapped the registry out."""
    global _MCACHE
    from ray_tpu_torch.util import metrics as m
    if _MCACHE is not None \
            and m._REGISTRY.get("health_series") is _MCACHE["series"]:
        return _MCACHE
    _MCACHE = _build_health_metrics(m)
    return _MCACHE


def _build_health_metrics(m) -> dict:
    return {
        "series": m.Gauge(
            "health_series",
            "Live labelled time-series tracked by the head store"),
        "points": m.Counter(
            "health_points_total",
            "Samples ingested into the head time-series store"),
        "dropped": m.Counter(
            "health_series_dropped_total",
            "Series evicted by the store's max-series memory bound"),
        "eval": m.Histogram(
            "health_eval_s",
            "One SLO evaluation pass over every objective",
            boundaries=(.001, .005, .01, .05, .1, .5, 1)),
        "sentinel": m.Gauge(
            "health_sentinel_ratio",
            "Live-over-baseline ratio per regression sentinel",
            tag_keys=("sentinel",)),
        "burn": m.Gauge(
            "slo_burn_rate",
            "Error-budget burn rate per objective over the tier's "
            "short window (-1 = boolean gauge-objective breach, "
            "0 = no traffic in the window)",
            tag_keys=("objective", "tier")),
        "alerts": m.Counter(
            "slo_alerts_total",
            "Alert state transitions (firing / resolved)",
            tag_keys=("objective", "tier", "state")),
        "active": m.Gauge(
            "slo_alert_active",
            "1 while the objective's tier alert is firing",
            tag_keys=("objective", "tier")),
    }


@dataclass
class Objective:
    """One declarative SLO.

    kind "latency":       ``metric`` is a seconds histogram; a request
                          is good when it lands at or under
                          ``threshold_s``; the objective is
                          ``target`` (e.g. 0.99 = 99% good).
    kind "availability":  ``metric`` is a counter; ``bad_labels`` is a
                          list of exact label selectors counted as bad
                          (e.g. [{"code": "500"}]); target as above.
    kind "gauge":         breach while the value is sustained past
                          ``threshold`` in ``direction`` over the
                          whole window (no budget math — burn is
                          reported as 0/inf so the same multi-window
                          logic applies).
    kind "gauge_ratio":   like "gauge" on metric/divisor_metric (e.g.
                          HBM used over limit).
    """

    name: str
    kind: str
    metric: str
    labels: Optional[dict] = None
    target: float = 0.99
    threshold_s: float = 1.0
    bad_labels: List[dict] = field(default_factory=list)
    threshold: float = 0.0
    direction: str = "above"
    divisor_metric: str = ""
    deployment: str = ""
    description: str = ""

    def describe(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "metric": self.metric, "labels": self.labels,
                "target": self.target, "threshold_s": self.threshold_s,
                "threshold": self.threshold,
                "direction": self.direction,
                "deployment": self.deployment or None,
                "description": self.description}


# proxy ingress outcome codes counted against availability: shed 503s
# ARE client-visible unavailability (and exactly the signal replica
# autoscaling must react to), 4xx are the client's fault
_BAD_CODES = ("500", "503", "504")


def _enc_burn(v):
    """Wire encoding of a burn rate: None stays None, inf becomes -1
    (gauge-objective boolean breach) — every snapshot/event surface
    uses this so /health JSON stays RFC-8259 parseable."""
    if v is None:
        return None
    return -1.0 if v == float("inf") else round(float(v), 3)


def _parse_windows(spec: str, default: tuple) -> tuple:
    try:
        short, long_ = (float(x) for x in str(spec).split(",")[:2])
        if short > 0 and long_ >= short:
            return (short, long_)
    except (ValueError, TypeError):
        pass
    return default


def load_baseline(path: str = "") -> Optional[dict]:
    """Pinned regression baselines (HEALTH_BASELINE.json). "" looks in
    the working directory — the committed repo layout; deployments can
    point Config.health_baseline_path anywhere."""
    path = path or "HEALTH_BASELINE.json"
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class HealthEngine:
    """Evaluates objectives + sentinels over a TimeSeriesStore.

    Deterministic: the clock is injectable and evaluate(now=...) does
    no sleeping — burn-rate window tests drive it with a fake clock."""

    def __init__(self, store: TimeSeriesStore, cfg=None,
                 clock: Optional[Callable[[], float]] = None,
                 objectives: Optional[List[Objective]] = None,
                 baseline: Optional[dict] = None):
        if cfg is None:
            from ray_tpu_torch.config import get_config
            cfg = get_config()
        self.store = store
        self.cfg = cfg
        self.clock = clock or store.clock
        self.objectives: List[Objective] = list(objectives or [])
        self.baseline = baseline
        self.tiers = {
            "page": {"windows": _parse_windows(
                getattr(cfg, "slo_fast_windows_s", "60,300"),
                (60.0, 300.0)),
                "burn": float(getattr(cfg, "slo_fast_burn", 14.4))},
            "warn": {"windows": _parse_windows(
                getattr(cfg, "slo_slow_windows_s", "300,1800"),
                (300.0, 1800.0)),
                "burn": float(getattr(cfg, "slo_slow_burn", 3.0))},
        }
        # (objective, tier) -> {"state", "since", "exemplar"}
        self._alerts: Dict[tuple, dict] = {}
        self._sentinel_state: Dict[str, bool] = {}
        self._m = health_metrics()
        self.eval_count = 0
        self.last_snapshot: Optional[dict] = None

    # --- objectives -----------------------------------------------------

    def add_objective(self, obj: Objective) -> None:
        self.objectives = [o for o in self.objectives
                           if o.name != obj.name] + [obj]

    def _derived_objectives(self) -> List[Objective]:
        """Default objectives for the series the store has actually
        seen — per-deployment ingress latency + availability off the
        proxy's histograms/counters, collective straggler health, and
        device HBM headroom. User objectives (add_objective) win on
        name collisions."""
        if not getattr(self.cfg, "slo_default_objectives", True):
            return []
        out: List[Objective] = []
        thr = float(getattr(self.cfg, "slo_latency_threshold_s", 1.0))
        target = float(getattr(self.cfg, "slo_target", 0.99))
        with self.store._lock:
            keys = list(self.store._series)
        deployments = sorted({dict(k)["deployment"]
                              for n, k in keys
                              if n == "serve_proxy_handler_s"
                              and "deployment" in dict(k)})
        names = {n for n, _k in keys}
        for dep in deployments:
            out.append(Objective(
                name=f"latency:{dep}", kind="latency",
                metric="serve_proxy_handler_s",
                labels={"deployment": dep}, threshold_s=thr,
                target=target, deployment=dep,
                description=f"{target:.0%} of {dep} requests under "
                            f"{thr:g}s (proxy handler time)"))
        if "serve_requests_total" in names:
            for dep in sorted({dict(k)["deployment"]
                               for n, k in keys
                               if n == "serve_requests_total"
                               and "deployment" in dict(k)}):
                out.append(Objective(
                    name=f"availability:{dep}", kind="availability",
                    metric="serve_requests_total",
                    labels={"deployment": dep}, target=target,
                    bad_labels=[{"deployment": dep, "code": c}
                                for c in _BAD_CODES],
                    deployment=dep,
                    description=f"{target:.0%} of {dep} requests "
                                "answered without a 5xx"))
        if "llm_ttft_wall_s" in names:
            out.append(Objective(
                name="llm_ttft", kind="latency",
                metric="llm_ttft_wall_s", threshold_s=thr,
                target=target,
                description=f"{target:.0%} of LLM requests reach "
                            f"first token under {thr:g}s"))
        if "allreduce_straggler_rank" in names:
            out.append(Objective(
                name="collective_straggler", kind="gauge",
                metric="allreduce_straggler_rank", threshold=-0.5,
                direction="above",
                description="a rank is persistently flagged as the "
                            "gradient-sync straggler (-1 = healthy)"))
        if "goodput_straggler_rank" in names:
            out.append(Objective(
                name="goodput_straggler", kind="gauge",
                metric="goodput_straggler_rank", threshold=-0.5,
                direction="above",
                description="a rank's p50 step anatomy diverges from "
                            "the ring beyond goodput_straggler_z "
                            "(-1 = healthy)"))
        if "forensics_stall_rank" in names:
            out.append(Objective(
                name="collective_stall", kind="gauge",
                metric="forensics_stall_rank", threshold=-0.5,
                direction="above",
                description="the forensics watchdog named a culprit "
                            "rank for a stalled/desynced collective "
                            "(-1 = healthy); run `ray-tpu autopsy`"))
        if "device_hbm_used_bytes" in names \
                and "device_hbm_limit_bytes" in names:
            out.append(Objective(
                name="hbm_headroom", kind="gauge_ratio",
                metric="device_hbm_used_bytes",
                divisor_metric="device_hbm_limit_bytes",
                threshold=0.92, direction="above",
                description="device HBM occupancy sustained above 92% "
                            "of capacity"))
        return out

    def active_objectives(self) -> List[Objective]:
        have = {o.name for o in self.objectives}
        return self.objectives + [o for o in self._derived_objectives()
                                  if o.name not in have]

    # --- burn math ------------------------------------------------------

    def _bad_fraction(self, obj: Objective, window_s: float,
                      now: float):
        """(bad_fraction, total, exemplar) over the trailing window;
        (None, 0, None) when the window saw no traffic."""
        if obj.kind == "latency":
            w = self.store.window(obj.metric, window_s, obj.labels,
                                  now=now)
            if not w or w["kind"] != "histogram" or not w["count"]:
                return None, 0.0, None
            bounds = w["boundaries"]
            counts = w["counts"]
            good = 0.0
            cut = -1
            for i, b in enumerate(bounds):
                if b <= obj.threshold_s * (1 + 1e-9):
                    good += counts[i]
                    cut = i
                else:
                    break
            total = w["count"]
            bad = total - good
            # exemplar: the latest one from a bucket PAST the
            # threshold — it names a concrete breaching request
            ex = None
            for i, e in sorted((w.get("exemplars") or {}).items()):
                if i > cut and (ex is None or e[2] >= ex[2]):
                    ex = e
            return bad / total, total, (ex[0] if ex else None)
        if obj.kind == "availability":
            w = self.store.window(obj.metric, window_s, obj.labels,
                                  now=now)
            if not w or w["kind"] != "counter" or w["inc"] <= 0:
                return None, 0.0, None
            bad = 0.0
            for sel in obj.bad_labels:
                bw = self.store.window(obj.metric, window_s, sel,
                                       now=now)
                if bw and bw["kind"] == "counter":
                    bad += bw["inc"]
            return min(1.0, bad / w["inc"]), w["inc"], None
        if obj.kind == "gauge_ratio":
            # Per-SERIES ratios, worst one decides: merging used bytes
            # across devices before dividing would let seven idle
            # devices hide the one at 97% — exactly the saturation the
            # objective exists to catch. Each numerator series divides
            # by ITS OWN labels' divisor window.
            with self.store._lock:
                keys = [dict(k) for k, _s in
                        self.store._matching(obj.metric, obj.labels)]
            worst = None
            for labels in keys:
                w = self.store.window(obj.metric, window_s, labels,
                                      now=now)
                dw = self.store.window(obj.divisor_metric, window_s,
                                       labels, now=now)
                if not w or w["kind"] != "gauge" or not dw \
                        or dw["kind"] != "gauge" or not dw.get("mean"):
                    continue
                sustained = (w["min"] if obj.direction == "above"
                             else w["max"])
                ratio = sustained / dw["mean"]
                if worst is None or \
                        (ratio > worst if obj.direction == "above"
                         else ratio < worst):
                    worst = ratio
            if worst is None:
                return None, 0.0, None
            breached = (worst > obj.threshold
                        if obj.direction == "above"
                        else worst < obj.threshold)
            return (1.0 if breached else 0.0), 1.0, None
        # plain gauge: sustained-threshold breach, burn 0/inf.
        # Evaluated PER SERIES, worst one decides (same rule as
        # gauge_ratio): merging first would let node A's healthy
        # straggler gauge (-1) mask node B's stuck rank 3.
        with self.store._lock:
            keys = [dict(k) for k, _s in
                    self.store._matching(obj.metric, obj.labels)]
        breached = None
        for labels in keys:
            w = self.store.window(obj.metric, window_s, labels,
                                  now=now)
            if not w or w["kind"] != "gauge":
                continue
            val = w["min"] if obj.direction == "above" else w["max"]
            hit = (val > obj.threshold if obj.direction == "above"
                   else val < obj.threshold)
            breached = hit if breached is None else (breached or hit)
        if breached is None:
            return None, 0.0, None
        return (1.0 if breached else 0.0), 1.0, None

    def _burn(self, obj: Objective, window_s: float, now: float,
              cache: Optional[dict] = None):
        """Error-budget burn rate over one window: bad_fraction /
        (1 - target). 1.0 = burning exactly the sustainable rate;
        gauge objectives report 0/inf (breach is boolean). ``cache``
        (one evaluate() pass) dedupes the store scans: with default
        windows the 300s window is both the page tier's long and the
        warn tier's short, so every objective would otherwise scan it
        twice per tick."""
        key = (obj.name, window_s)
        if cache is not None and key in cache:
            frac, total, ex = cache[key]
        else:
            frac, total, ex = self._bad_fraction(obj, window_s, now)
            if cache is not None:
                cache[key] = (frac, total, ex)
        if frac is None:
            return None, ex
        if obj.kind in ("gauge", "gauge_ratio"):
            return (float("inf") if frac else 0.0), ex
        budget = max(1e-9, 1.0 - obj.target)
        return frac / budget, ex

    # --- evaluation -----------------------------------------------------

    def _transition(self, obj: Objective, tier: str, firing: bool,
                    now: float, burn_short, burn_long,
                    exemplar: Optional[str], transitions: list):
        key = (obj.name, tier)
        cur = self._alerts.get(key)
        if firing:
            if cur is None or cur["state"] != "firing":
                # burns stored SANITIZED (-1 encodes inf, like the
                # event records): the alert dict is copied verbatim
                # into the /health?json=1 snapshot, and a raw
                # float('inf') would serialize as the non-RFC token
                # `Infinity` — breaking strict JSON consumers of the
                # autoscaler contract exactly while a page is active
                self._alerts[key] = {"state": "firing", "since": now,
                                     "exemplar": exemplar,
                                     "burn_short": _enc_burn(burn_short),
                                     "burn_long": _enc_burn(burn_long)}
                self._record_event(obj, tier, "firing", burn_short,
                                   burn_long, exemplar)
                transitions.append((obj.name, tier, "firing"))
            elif exemplar and not cur.get("exemplar"):
                cur["exemplar"] = exemplar
        elif cur is not None and cur["state"] == "firing":
            self._alerts[key] = {"state": "resolved", "since": now,
                                 "exemplar": cur.get("exemplar")}
            self._record_event(obj, tier, "resolved", burn_short,
                               burn_long, cur.get("exemplar"))
            transitions.append((obj.name, tier, "resolved"))
        tags = {"objective": obj.name, "tier": tier}
        self._m["active"].set(1.0 if firing else 0.0, tags=tags)
        # ALWAYS updated, or the gauge freezes at its last finite
        # value while slo_alert_active says firing: -1 encodes a
        # boolean (gauge-objective) breach, 0 means no traffic
        self._m["burn"].set(
            0.0 if burn_short is None
            else (-1.0 if burn_short == float("inf")
                  else burn_short), tags=tags)

    def _record_event(self, obj: Objective, tier: str, state: str,
                      burn_short, burn_long, exemplar):
        events.record(
            "health", "alert", objective=obj.name, tier=tier,
            state=state, kind=obj.kind, metric=obj.metric,
            burn_short=_enc_burn(burn_short),
            burn_long=_enc_burn(burn_long),
            **({"deployment": obj.deployment} if obj.deployment
               else {}),
            **({"trace": exemplar} if exemplar else {}))
        self._m["alerts"].inc(tags={"objective": obj.name,
                                    "tier": tier, "state": state})

    def _eval_sentinels(self, now: float, transitions: list) -> list:
        rows = []
        for s in ((self.baseline or {}).get("sentinels") or []):
            name = s.get("name", "?")
            metric = s.get("metric", "")
            stat = s.get("stat", "p99")
            window_s = float(s.get("window_s", 300.0))
            base = float(s.get("baseline", 0.0))
            tol = float(s.get("tolerance", 2.0))
            labels = s.get("labels") or None
            live = None
            if stat in ("p50", "p95", "p99"):
                live = self.store.quantile(
                    metric, float(stat[1:]) / 100.0, window_s, labels,
                    now=now)
            else:
                w = self.store.window(metric, window_s, labels,
                                      now=now)
                if w is not None:
                    live = w.get(stat)
            row = {"name": name, "metric": metric, "stat": stat,
                   "window_s": window_s, "baseline": base,
                   "tolerance": tol, "unit": s.get("unit", "s"),
                   "live": live, "ratio": None, "breached": False,
                   "source": s.get("source")}
            if live is not None and base > 0:
                row["ratio"] = live / base
                row["breached"] = row["ratio"] > tol
            # ALWAYS updated (the _transition frozen-gauge rule): a
            # sentinel whose metric went quiet must export 0, not its
            # last breach ratio forever
            self._m["sentinel"].set(row["ratio"] or 0.0,
                                    tags={"sentinel": name})
            was = self._sentinel_state.get(name, False)
            if row["breached"] != was:
                self._sentinel_state[name] = row["breached"]
                events.record(
                    "health", "sentinel", sentinel=name,
                    metric=metric, stat=stat,
                    state="firing" if row["breached"] else "resolved",
                    live=live, baseline=base, tolerance=tol)
                transitions.append((name, "sentinel",
                                    "firing" if row["breached"]
                                    else "resolved"))
            rows.append(row)
        return rows

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One pass: burn rates for every objective x tier, alert
        state transitions (events + metrics), sentinel checks. Returns
        the machine-readable snapshot (the /health contract)."""
        t_wall0 = time.monotonic()
        now = self.clock() if now is None else now
        self.eval_count += 1
        transitions: list = []
        obj_rows = []
        burn_advice: Dict[str, dict] = {}
        for obj in self.active_objectives():
            tiers = {}
            exemplar = None
            burn_cache: dict = {}
            for tier, spec in self.tiers.items():
                short_s, long_s = spec["windows"]
                thr = spec["burn"]
                b_short, ex_s = self._burn(obj, short_s, now,
                                           cache=burn_cache)
                b_long, ex_l = self._burn(obj, long_s, now,
                                          cache=burn_cache)
                ex = ex_s or ex_l
                exemplar = exemplar or ex
                firing = (b_short is not None and b_long is not None
                          and b_short >= thr and b_long >= thr)
                self._transition(obj, tier, firing, now, b_short,
                                 b_long, ex, transitions)
                tiers[tier] = {
                    "short_s": short_s, "long_s": long_s,
                    "burn_threshold": thr,
                    "burn_short": _enc_burn(b_short),
                    "burn_long": _enc_burn(b_long),
                    "firing": firing}
            alert = ("page" if tiers.get("page", {}).get("firing")
                     else "warn" if tiers.get("warn", {}).get("firing")
                     else None)
            row = obj.describe()
            row.update(tiers=tiers, alert=alert,
                       exemplar=self._alerts.get(
                           (obj.name, "page"), {}).get("exemplar")
                       or self._alerts.get(
                           (obj.name, "warn"), {}).get("exemplar")
                       or exemplar)
            obj_rows.append(row)
            if obj.deployment:
                adv = burn_advice.setdefault(
                    obj.deployment, {"availability_burning": False,
                                     "latency_burning": False,
                                     "tier": None})
                if alert:
                    which = ("availability_burning"
                             if obj.kind == "availability"
                             else "latency_burning")
                    adv[which] = True
                    if adv["tier"] != "page":
                        adv["tier"] = alert
        # An alert whose OBJECTIVE vanished (deployment deleted, its
        # series LRU-evicted under label churn) must resolve, not burn
        # forever with no evaluation path left to clear it.
        live_names = {o["name"] for o in obj_rows}
        for (oname, tier), st in list(self._alerts.items()):
            if oname not in live_names and st["state"] != "firing":
                # resolved entry for a gone objective: prune, or
                # deployment churn grows _alerts without bound
                del self._alerts[(oname, tier)]
                continue
            if st["state"] == "firing" and oname not in live_names:
                self._alerts[(oname, tier)] = {
                    "state": "resolved", "since": now,
                    "exemplar": st.get("exemplar")}
                events.record("health", "alert", objective=oname,
                              tier=tier, state="resolved",
                              reason="objective gone")
                self._m["alerts"].inc(tags={"objective": oname,
                                            "tier": tier,
                                            "state": "resolved"})
                gone_tags = {"objective": oname, "tier": tier}
                self._m["active"].set(0.0, tags=gone_tags)
                # also un-freeze the burn gauge (same hazard
                # _transition guards against): a deleted deployment
                # must not export a phantom 20x burn forever
                self._m["burn"].set(0.0, tags=gone_tags)
                transitions.append((oname, tier, "resolved"))
        sentinels = self._eval_sentinels(now, transitions)
        self._m["series"].set(self.store.series_count())
        self._m["eval"].observe(time.monotonic() - t_wall0)
        active = [
            {"objective": o, "tier": t, **st}
            for (o, t), st in sorted(self._alerts.items())
            if st["state"] == "firing"]
        snap = {
            "ts": now, "enabled": True,
            "eval_count": self.eval_count,
            "series": self.store.series_count(),
            "points_total": self.store.points_total,
            "tiers": {t: {"windows_s": list(s["windows"]),
                          "burn_threshold": s["burn"]}
                      for t, s in self.tiers.items()},
            "objectives": obj_rows,
            "alerts": active,
            "sentinels": sentinels,
            "burn_advice": burn_advice,
            "transitions": transitions,
        }
        self.last_snapshot = snap
        return snap


# --- process-global plane (the head owns one) --------------------------

_store: Optional[TimeSeriesStore] = None
_engine: Optional[HealthEngine] = None


def activate(cfg=None) -> Optional[HealthEngine]:
    """Create (or return) this process's store + engine. The control
    service calls this at start; no-op (None) when the plane is off."""
    global _store, _engine
    if cfg is None:
        from ray_tpu_torch.config import get_config
        cfg = get_config()
    if not enabled() or not getattr(cfg, "health_enabled", True):
        return None
    if _engine is None:
        _store = TimeSeriesStore(
            window_s=float(getattr(cfg, "health_window_s", 10.0)),
            retention_s=float(getattr(cfg, "health_retention_s",
                                      900.0)),
            max_series=int(getattr(cfg, "health_max_series", 4096)))
        _engine = HealthEngine(
            _store, cfg,
            baseline=load_baseline(
                getattr(cfg, "health_baseline_path", "")))
    return _engine


def deactivate() -> None:
    """Drop the plane (control stop / tests): a later cluster in this
    process must not inherit a dead cluster's series or alert state —
    including the alert/burn GAUGES, which live in the process-global
    metrics registry and would otherwise keep reporting a dead
    cluster's page as firing."""
    global _store, _engine
    _store = None
    _engine = None
    try:
        m = health_metrics()
        for key in ("active", "burn", "sentinel", "series"):
            with_lock = m[key]
            from ray_tpu_torch.util import metrics as _m
            with _m._LOCK:
                with_lock._values.clear()
    except Exception:  # noqa: BLE001 — cleanup must never raise
        pass


def get_engine() -> Optional[HealthEngine]:
    return _engine


def get_store() -> Optional[TimeSeriesStore]:
    return _store


def ingest_push(source: str, text: str) -> None:
    """Feed one worker-pushed metrics snapshot into the store (called
    by control report_metrics, right next to metrics.merge_remote —
    the history store rides the EXISTING aggregation path)."""
    store = _store
    if store is not None:
        store.ingest_text(source, text)
        _sync_store_counters(store)


def _sync_store_counters(store: TimeSeriesStore) -> None:
    m = health_metrics()
    # gauges mirror the store's own monotonic tallies
    m["series"].set(store.series_count())
    mp = m["points"]
    prev = getattr(store, "_points_reported", 0)
    if store.points_total > prev:
        mp.inc(store.points_total - prev)
        store._points_reported = store.points_total
    md = m["dropped"]
    prevd = getattr(store, "_dropped_reported", 0)
    if store.dropped_series_total > prevd:
        md.inc(store.dropped_series_total - prevd)
        store._dropped_reported = store.dropped_series_total


async def head_loop(cfg=None) -> None:
    """The head's evaluation loop: sample the local registry into the
    store and run one SLO evaluation every slo_eval_interval_s. Started
    by the control service when the plane is enabled."""
    engine = activate(cfg)
    if engine is None:
        return
    interval = max(0.25, float(getattr(engine.cfg,
                                       "slo_eval_interval_s", 10.0)))
    while True:
        await asyncio.sleep(interval)
        try:
            engine.store.ingest_registry()
            _sync_store_counters(engine.store)
            engine.evaluate()
        except asyncio.CancelledError:
            raise
        except Exception:
            pass        # evaluation must never kill the head


def local_state() -> dict:
    """This process's health snapshot (the control RPC handler and the
    /health JSON endpoint both serve this shape)."""
    if _engine is None:
        return {"enabled": False,
                "reason": "health plane inactive in this process "
                          "(RAY_TPU_HEALTH=0 / health_enabled=False, "
                          "or not the head)"}
    return _engine.last_snapshot or _engine.evaluate()


def local_query(name: str, since_s: float = 900.0,
                labels: Optional[dict] = None) -> dict:
    if _store is None:
        return {"error": "health plane inactive in this process"}
    return _store.query(name, float(since_s), labels)


def parse_since(text: str, default_s: float = 900.0) -> float:
    """'90s' / '15m' / '2h' / bare seconds -> seconds (CLI --since)."""
    text = (text or "").strip().lower()
    if not text:
        return default_s
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    try:
        if text[-1] in mult:
            return float(text[:-1]) * mult[text[-1]]
        return float(text)
    except ValueError:
        return default_s


def spark(values: List[float], width: int = 48) -> str:
    """Unicode sparkline for the CLI (`ray-tpu metrics <name>`)."""
    blocks = "▁▂▃▄▅▆▇█"
    vals = [v for v in values if v is not None]
    if not vals:
        return "(no data)"
    if len(vals) > width:
        # MAX-aggregate each group so the line fits a terminal
        # without dropping the spike the alert fired on (every-Nth
        # decimation could skip exactly the breaching window)
        group = -(-len(vals) // width)      # ceil
        vals = [max(vals[i:i + group])
                for i in range(0, len(vals), group)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(blocks[min(len(blocks) - 1,
                              int((v - lo) / span * (len(blocks) - 1)))]
                   for v in vals)
