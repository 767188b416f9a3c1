"""Head-side metrics time-series store: bounded, multi-resolution.

The head already aggregates every worker's metric snapshot
(util/metrics.py push_loop -> control report_metrics -> merge_remote)
but keeps only the LATEST text per source — "TTFT p99 has been
degrading for 20 minutes" is invisible unless a human scrapes /metrics
at the right moment. This module retains pushed series as ring-buffered
windows at several resolutions (raw ~10s points for minutes, 1-min and
10-min rollups for hours) with bounded memory, so the SLO engine
(util/health.py), `ray-tpu metrics <name> --since 15m`, and the
dashboard /health page can ask questions about *windows*, not moments.

Storage forms (the downsample-safety contract the tests pin):

  counter    per-window non-negative INCREMENTS (deltas between
             cumulative pushes, per source; the store's FIRST sight of
             a series is a baseline — never an increment, so a head
             restart or series re-creation can't dump a lifetime count
             into one window; a true source reset — worker restart —
             contributes the post-reset value, never a negative).
             Summing a rollup window's increments equals summing the
             raw increments it covers, so reconstructed cumulative
             series stay monotone at every resolution.
  gauge      per-window last/min/max/sum/n — rollups keep the envelope,
             not just a decimated point.
  histogram  per-window PER-BUCKET count deltas + sum/count deltas
             (prometheus cumulative-le form is unstacked at ingest).
             Bucket deltas are mergeable: the quantile over any window
             equals the quantile of the merged buckets, at any
             resolution. The latest exemplar per bucket rides along so
             a breaching window can name a concrete trace id.

One store instance lives in the head process (util/health.py owns it);
the class itself is dependency-free and takes an injectable ``clock``
so window/burn-rate math is testable without wall-clock sleeps.
"""

from __future__ import annotations

import bisect
import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# (width_multiplier, span_multiplier) applied to the configured raw
# (window_s, retention_s): raw 10s/15min by default, rollups 60s/2h and
# 600s/24h — minutes of full detail, hours of trend.
RESOLUTION_SCALES = ((1, 1), (6, 8), (60, 96))

# The headline field of a query() point per metric kind — the ONE
# contract the CLI sparkline and the dashboard charts both render, so
# changing what query() surfaces changes every consumer together.
DISPLAY_FIELD = {"counter": "rate", "gauge": "value",
                 "histogram": "p99"}


# the ONE label-key normalization, shared with the metrics plane:
# series keys produced by both must stay byte-identical for
# subset-label queries to merge pushed series correctly
from ray_tpu_torch.util.metrics import _labels_key  # noqa: E402


def _match(key: Tuple[Tuple[str, str], ...],
           want: Optional[dict]) -> bool:
    """True when ``want`` is a subset of the series' label set (None
    matches everything) — queries select e.g. deployment="x" and merge
    across the node/worker identity labels the push path stamped."""
    if not want:
        return True
    have = dict(key)
    return all(have.get(k) == str(v) for k, v in want.items())


class _Series:
    """One labelled series: per-resolution rings of aligned windows."""

    __slots__ = ("kind", "boundaries", "rings", "widths", "_cum",
                 "last_ts")

    def __init__(self, kind: str, widths: Sequence[float],
                 spans: Sequence[float],
                 boundaries: Optional[Tuple[float, ...]] = None):
        self.kind = kind
        self.boundaries = boundaries
        self.widths = tuple(widths)
        # each ring: deque of {"t": aligned_start, ...} oldest-first,
        # bounded — eviction is strictly oldest-window-first
        self.rings: List[deque] = [
            deque(maxlen=max(2, int(span / w)))
            for w, span in zip(widths, spans)]
        self._cum: Dict[str, object] = {}   # source -> last cumulative
        self.last_ts = 0.0

    def _bucket(self, ring: deque, width: float, ts: float) \
            -> Optional[dict]:
        t = int(ts // width) * width
        if ring and ring[-1]["t"] == t:
            return ring[-1]
        if ring and ring[-1]["t"] > t:
            # late sample for an already-rolled window: merge into it if
            # it still exists, else drop (pushes are near-ordered; this
            # keeps ingest O(1) instead of re-sorting rings)
            for b in reversed(ring):
                if b["t"] == t:
                    return b
            return None
        b = {"t": t}
        ring.append(b)
        return b

    def add_counter(self, source: str, cumulative: float, ts: float):
        prev = self._cum.get(source)
        if prev is None:
            # FIRST sight by the STORE is a baseline, never an
            # increment: the source may be long-lived (head restart,
            # series LRU-evicted and re-created) and dumping its
            # lifetime count into one window would fire phantom
            # burn-rate alerts. The cost is bounded and tiny — a
            # genuinely fresh worker only loses what it counted
            # before its first export-interval push.
            inc = 0.0
        elif cumulative < prev:
            # true source reset (worker restart): the post-reset
            # value IS the increment
            inc = cumulative
        else:
            inc = cumulative - prev
        self._cum[source] = cumulative
        self.last_ts = max(self.last_ts, ts)
        if inc <= 0:
            return
        for ring, w in zip(self.rings, self.widths):
            b = self._bucket(ring, w, ts)
            if b is not None:
                b["inc"] = b.get("inc", 0.0) + inc

    def add_gauge(self, value: float, ts: float):
        self.last_ts = max(self.last_ts, ts)
        for ring, w in zip(self.rings, self.widths):
            b = self._bucket(ring, w, ts)
            if b is None:
                continue
            b["last"] = value
            b["min"] = min(b.get("min", value), value)
            b["max"] = max(b.get("max", value), value)
            b["sum"] = b.get("sum", 0.0) + value
            b["n"] = b.get("n", 0) + 1

    def add_hist(self, source: str, counts: Sequence[float], hsum: float,
                 ts: float,
                 exemplars: Optional[Dict[int, tuple]] = None):
        """``counts`` are PER-BUCKET (already unstacked) cumulative-
        over-time counts; deltas vs the previous push are stored."""
        prev = self._cum.get(source)
        counts = list(counts)
        if prev is None:
            # baseline, not an increment — same rule (and rationale)
            # as add_counter's first sight
            dc, ds = [0.0] * len(counts), 0.0
        elif len(prev[0]) != len(counts) \
                or any(c < p for c, p in zip(counts, prev[0])):
            dc, ds = counts, hsum                     # source reset
        else:
            dc = [c - p for c, p in zip(counts, prev[0])]
            ds = max(0.0, hsum - prev[1])
        self._cum[source] = (counts, hsum)
        self.last_ts = max(self.last_ts, ts)
        if not any(dc):
            return
        for ring, w in zip(self.rings, self.widths):
            b = self._bucket(ring, w, ts)
            if b is None:
                continue
            cur = b.get("counts")
            if cur is None:
                b["counts"] = list(dc)
            else:
                for i, d in enumerate(dc):
                    cur[i] += d
            b["sum"] = b.get("sum", 0.0) + ds
            if exemplars:
                b.setdefault("ex", {}).update(exemplars)

    def points(self, res: int) -> List[dict]:
        return list(self.rings[res])


class TimeSeriesStore:
    """Bounded store of labelled series at multiple resolutions."""

    def __init__(self, *, window_s: float = 10.0,
                 retention_s: float = 900.0, max_series: int = 4096,
                 clock: Callable[[], float] = None):
        import time as _time
        self.clock = clock or _time.time
        window_s = max(0.25, float(window_s))
        retention_s = max(window_s * 4, float(retention_s))
        self.widths = tuple(window_s * wm
                            for wm, _ in RESOLUTION_SCALES)
        self.spans = tuple(retention_s * sm
                           for _, sm in RESOLUTION_SCALES)
        self.max_series = int(max_series)
        self._series: Dict[tuple, _Series] = {}
        self._lock = threading.Lock()
        self.points_total = 0
        self.dropped_series_total = 0

    # --- ingest ---------------------------------------------------------

    def _get(self, name: str, key, kind: str,
             boundaries=None) -> Optional[_Series]:
        s = self._series.get((name, key))
        if s is None:
            if len(self._series) >= self.max_series:
                self._evict_one()
                if len(self._series) >= self.max_series:
                    return None
            s = _Series(kind, self.widths, self.spans, boundaries)
            self._series[(name, key)] = s
        return s

    def _evict_one(self):
        """Drop the least-recently-updated series (bounded memory: a
        label-churning workload ages out its own dead series)."""
        if not self._series:
            return
        victim = min(self._series, key=lambda k:
                     self._series[k].last_ts)
        del self._series[victim]
        self.dropped_series_total += 1

    def ingest_counter(self, name: str, labels: Optional[dict],
                       cumulative: float, *, source: str = "local",
                       ts: Optional[float] = None):
        ts = self.clock() if ts is None else ts
        with self._lock:
            s = self._get(name, _labels_key(labels), "counter")
            if s is not None:
                s.add_counter(source, float(cumulative), ts)
                self.points_total += 1

    def ingest_gauge(self, name: str, labels: Optional[dict],
                     value: float, *, ts: Optional[float] = None):
        ts = self.clock() if ts is None else ts
        with self._lock:
            s = self._get(name, _labels_key(labels), "gauge")
            if s is not None:
                s.add_gauge(float(value), ts)
                self.points_total += 1

    def ingest_hist(self, name: str, labels: Optional[dict],
                    boundaries: Sequence[float],
                    counts: Sequence[float], hsum: float, *,
                    source: str = "local", ts: Optional[float] = None,
                    exemplars: Optional[Dict[int, tuple]] = None):
        ts = self.clock() if ts is None else ts
        with self._lock:
            s = self._get(name, _labels_key(labels), "histogram",
                          tuple(boundaries))
            if s is not None:
                s.add_hist(source, counts, float(hsum), ts,
                           exemplars=exemplars)
                self.points_total += 1

    def ingest_registry(self, *, source: str = "local",
                        ts: Optional[float] = None):
        """Sample this process's own metric registry (the head's
        counters/gauges/histograms — workers' arrive as pushed text)."""
        from ray_tpu_torch.util import metrics as m
        with m._LOCK:
            items = list(m._REGISTRY.items())
        for name, metric in items:
            kind = getattr(metric, "kind", "")
            if kind == "histogram":
                with m._LOCK:
                    snap = [(k, list(c),
                             metric._sums.get(k, 0.0),
                             dict(metric._exemplars.get(k) or ()))
                            for k, c in metric._counts.items()]
                for key, counts, hsum, ex in snap:
                    self.ingest_hist(name, dict(key),
                                     metric.boundaries, counts, hsum,
                                     source=source, ts=ts,
                                     exemplars=ex or None)
            elif kind in ("counter", "gauge"):
                with m._LOCK:
                    vals = list(metric._values.items())
                for key, v in vals:
                    if kind == "counter":
                        self.ingest_counter(name, dict(key), v,
                                            source=source, ts=ts)
                    else:
                        self.ingest_gauge(name, dict(key), v, ts=ts)

    # One pushed sample line: name{labels} value [# {trace_id="…"} v ts]
    _LINE_RE = re.compile(
        r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
        r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<val>[^\s#]+)"
        r"(?:\s+#\s+\{trace_id=\"(?P<ex>[^\"]*)\"\}\s+"
        r"(?P<exv>\S+)(?:\s+(?P<exts>\S+))?)?\s*$")
    _LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')

    def ingest_text(self, source: str, text: str,
                    ts: Optional[float] = None):
        """Parse one pushed prometheus-text snapshot (render_labeled
        output: samples only, exemplar tails possible) into the store.
        Kinds are inferred from the catalog's naming contract the lint
        enforces: ``*_bucket{le=}``/``*_sum``/``*_count`` families are
        histograms, ``*_total`` counters, everything else gauges."""
        ts = self.clock() if ts is None else ts
        # family -> {labels_key: {"le": {bound: count}, "sum": x}}
        hists: Dict[str, dict] = {}
        flat: List[tuple] = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = self._LINE_RE.match(line)
            if m is None:
                continue
            name = m.group("name")
            try:
                val = float(m.group("val"))
            except ValueError:
                continue
            labels = dict(self._LABEL_RE.findall(m.group("labels") or ""))
            if name.endswith("_bucket") and "le" in labels:
                fam = name[:-len("_bucket")]
                le = labels.pop("le")
                bound = float("inf") if le in ("+Inf", "inf") \
                    else float(le)
                ent = hists.setdefault(fam, {}).setdefault(
                    _labels_key(labels), {"le": {}, "sum": 0.0,
                                          "ex": {}})
                ent["le"][bound] = val
                if m.group("ex"):
                    try:
                        ent["ex"][bound] = (
                            m.group("ex"), float(m.group("exv") or 0),
                            float(m.group("exts") or ts))
                    except ValueError:
                        pass
            else:
                flat.append((name, labels, val))
        for name, labels, val in flat:
            for suffix in ("_sum", "_count"):
                fam = name[:-len(suffix)] if name.endswith(suffix) \
                    else None
                if fam in hists:
                    if suffix == "_sum":
                        ent = hists[fam].get(_labels_key(labels))
                        if ent is not None:
                            ent["sum"] = val
                    break
            else:
                if name.endswith("_total"):
                    self.ingest_counter(name, labels, val,
                                        source=source, ts=ts)
                else:
                    self.ingest_gauge(name, labels, val, ts=ts)
        for fam, per_labels in hists.items():
            for key, ent in per_labels.items():
                bounds = sorted(ent["le"])
                if not bounds:
                    continue
                # unstack prometheus cumulative-le into per-bucket
                cum = [ent["le"][b] for b in bounds]
                counts = [cum[0]] + [cum[i] - cum[i - 1]
                                     for i in range(1, len(cum))]
                finite = tuple(b for b in bounds if b != float("inf"))
                ex = {}
                for b, e in ent["ex"].items():
                    i = bisect.bisect_left(bounds, b)
                    if i < len(counts):
                        ex[i] = e
                self.ingest_hist(fam, dict(key), finite, counts,
                                 ent["sum"], source=source, ts=ts,
                                 exemplars=ex or None)

    # --- query ----------------------------------------------------------

    def _pick_res(self, since_s: float) -> int:
        for i, (w, span) in enumerate(zip(self.widths, self.spans)):
            if since_s <= span:
                return i
        return len(self.widths) - 1

    def _matching(self, name: str, labels: Optional[dict]):
        return [(k, s) for (n, k), s in self._series.items()
                if n == name and _match(k, labels)]

    def names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def kind_of(self, name: str) -> Optional[str]:
        with self._lock:
            for (n, _k), s in self._series.items():
                if n == name:
                    return s.kind
        return None

    def query(self, name: str, since_s: float,
              labels: Optional[dict] = None,
              now: Optional[float] = None) -> dict:
        """Merged per-window points for one metric name, oldest first:
        counters as per-second rates, gauges as per-window means (with
        min/max envelope), histograms as per-window count rate + p50/
        p99. The CLI sparkline and the dashboard both render this."""
        now = self.clock() if now is None else now
        res = self._pick_res(since_s)
        width = self.widths[res]
        t_lo = now - since_s
        with self._lock:
            matched = self._matching(name, labels)
            if not matched:
                return {"name": name, "kind": None, "points": [],
                        "series": 0, "window_s": width}
            kind = matched[0][1].kind
            merged: Dict[float, dict] = {}
            for _k, s in matched:
                for b in s.points(res):
                    if b["t"] < t_lo - width:
                        continue
                    mb = merged.setdefault(b["t"], {"t": b["t"]})
                    if kind == "counter":
                        mb["inc"] = mb.get("inc", 0.0) \
                            + b.get("inc", 0.0)
                    elif kind == "gauge":
                        if "n" in b:
                            mb["sum"] = mb.get("sum", 0.0) + b["sum"]
                            mb["n"] = mb.get("n", 0) + b["n"]
                            mb["min"] = min(mb.get("min", b["min"]),
                                            b["min"])
                            mb["max"] = max(mb.get("max", b["max"]),
                                            b["max"])
                            if "last" in b:
                                mb["last"] = b["last"]
                    else:
                        cs = b.get("counts")
                        if cs:
                            cur = mb.setdefault("counts",
                                                [0.0] * len(cs))
                            if len(cur) == len(cs):
                                for i, c in enumerate(cs):
                                    cur[i] += c
                            mb["sum"] = mb.get("sum", 0.0) \
                                + b.get("sum", 0.0)
            bounds = matched[0][1].boundaries
        points = []
        for t in sorted(merged):
            b = merged[t]
            if kind == "counter":
                points.append({"t": t, "rate":
                               b.get("inc", 0.0) / width,
                               "inc": b.get("inc", 0.0)})
            elif kind == "gauge":
                if b.get("n"):
                    # "value" is the window mean (trend surfaces);
                    # "last" is the newest sample — enum-ish gauges
                    # (e.g. a straggler RANK id) are meaningless
                    # averaged across a window that saw both -1 and N
                    pt = {"t": t, "value": b["sum"] / b["n"],
                          "min": b["min"], "max": b["max"]}
                    if "last" in b:
                        pt["last"] = b["last"]
                    points.append(pt)
            else:
                cs = b.get("counts")
                if cs:
                    n = sum(cs)
                    points.append({
                        "t": t, "count": n, "rate": n / width,
                        "mean": (b.get("sum", 0.0) / n) if n else 0.0,
                        "p50": _bucket_quantile(bounds, cs, 0.5),
                        "p99": _bucket_quantile(bounds, cs, 0.99)})
        return {"name": name, "kind": kind, "points": points,
                "series": len(matched), "window_s": width,
                "boundaries": list(bounds) if bounds else None}

    def window(self, name: str, window_s: float,
               labels: Optional[dict] = None,
               now: Optional[float] = None) -> Optional[dict]:
        """Everything that happened to a metric in the trailing window,
        merged across matching series — the SLO engine's one read.
        Counter: {inc, rate}; gauge: {last, min, max, mean}; histogram:
        {count, sum, counts, boundaries, exemplars}."""
        now = self.clock() if now is None else now
        res = self._pick_res(window_s)
        t_lo = now - window_s
        with self._lock:
            matched = self._matching(name, labels)
            if not matched:
                return None
            kind = matched[0][1].kind
            out: dict = {"kind": kind, "window_s": window_s,
                         "series": len(matched)}
            if kind == "counter":
                inc = sum(b.get("inc", 0.0)
                          for _k, s in matched
                          for b in s.points(res) if b["t"] >= t_lo)
                out.update(inc=inc, rate=inc / window_s)
            elif kind == "gauge":
                mn = mx = None
                total = n = 0.0
                last = (0.0, None)
                for _k, s in matched:
                    for b in s.points(res):
                        if b["t"] < t_lo or "n" not in b:
                            continue
                        mn = b["min"] if mn is None \
                            else min(mn, b["min"])
                        mx = b["max"] if mx is None \
                            else max(mx, b["max"])
                        total += b["sum"]
                        n += b["n"]
                        if b["t"] >= last[0]:
                            last = (b["t"], b["last"])
                if n == 0:
                    return None
                out.update(min=mn, max=mx, mean=total / n,
                           last=last[1])
            else:
                bounds = matched[0][1].boundaries or ()
                counts = [0.0] * (len(bounds) + 1)
                hsum = 0.0
                exemplars: Dict[int, tuple] = {}
                for _k, s in matched:
                    for b in s.points(res):
                        if b["t"] < t_lo:
                            continue
                        cs = b.get("counts")
                        if cs and len(cs) == len(counts):
                            for i, c in enumerate(cs):
                                counts[i] += c
                            hsum += b.get("sum", 0.0)
                        for i, e in (b.get("ex") or {}).items():
                            old = exemplars.get(i)
                            if old is None or e[2] >= old[2]:
                                exemplars[i] = e
                total = sum(counts)
                out.update(count=total, sum=hsum,
                           counts=counts, boundaries=list(bounds),
                           exemplars=exemplars,
                           mean=(hsum / total) if total else 0.0)
            return out

    def quantile(self, name: str, q: float, window_s: float,
                 labels: Optional[dict] = None,
                 now: Optional[float] = None) -> Optional[float]:
        w = self.window(name, window_s, labels, now=now)
        if not w or w["kind"] != "histogram" or not w["count"]:
            return None
        return _bucket_quantile(tuple(w["boundaries"]), w["counts"], q)


def _bucket_quantile(boundaries: Tuple[float, ...],
                     counts: Sequence[float], q: float) -> float:
    """Prometheus-style histogram quantile over per-bucket counts:
    linear interpolation inside the bucket the rank falls in; the
    overflow bucket clamps to the largest boundary."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            if i >= len(boundaries):
                return boundaries[-1] if boundaries else 0.0
            lo = boundaries[i - 1] if i > 0 else 0.0
            hi = boundaries[i]
            if c <= 0:
                return hi
            return lo + (hi - lo) * (rank - (cum - c)) / c
    return boundaries[-1] if boundaries else 0.0
