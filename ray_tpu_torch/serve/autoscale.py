"""SLO-driven replica autoscaling: error-budget burn -> replica count.

The port's copy of ``ray_tpu/serve/autoscale.py``. The health plane
(util/health.py) already evaluates Google-SRE multi-window
multi-burn-rate alerts per deployment and publishes a ``burn_advice``
map on the head's ``health_state`` snapshot; the serve proxy consults
it at shed time.
This module turns that signal into ACTUATION:

- page-tier burn (availability or latency budget burning fast) scales
  the deployment up by ``serve_autoscale_step`` within
  ``[min_replicas, max_replicas]``;
- the proxy's shed-while-burning advisory — previously log-only — is
  the FAST PATH: it arrives as a hint RPC and counts as a page-tier
  signal without waiting for the controller's next advice fetch;
- sustained low utilization (ongoing / capacity below
  ``serve_autoscale_low_util`` for ``serve_autoscale_low_util_window_s``
  with no budget burning) scales down by one; the controller's
  ``retire()`` path DRAINS the victim, so in-flight streams finish;
- ``serve_autoscale_cooldown_s`` between changes plus the
  low/high-utilization deadband give the loop hysteresis: a flapping
  alert cannot thrash replica counts.

Selection: a deployment opts in with ``autoscaling_config={"policy":
"slo", ...}`` (or any config carrying an ``"slo"`` key). The
controller's legacy ``target_ongoing_requests`` loop stays the
fallback for plain configs — exactly ONE actuator ever runs per
deployment (unit-tested in tests/test_zz_autoscale.py).

The decision core (``SLOAutoscaler.decide``) is pure host logic over
injected inputs and an injected clock — fake-clock unit tests drive
scale-up, cooldown, deadband, and drain-based scale-down without a
cluster.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ray_tpu_torch.util import events


def autoscale_metrics() -> dict:
    """Get-or-create the autoscaler's series (shared process registry;
    the controller's worker pushes them to the head). Catalog:

      serve_autoscale_decisions_total  scale decisions by deployment x
                                       direction (up/down) x reason
      serve_autoscale_replicas         current replica target per
                                       deployment (the actuator's
                                       output, next to the health
                                       plane's burn advice input)
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "decisions": m.Counter(
            "serve_autoscale_decisions_total",
            "Autoscale decisions by deployment, direction (up/down), "
            "and reason (page_burn/shed_hint/warn_burn/low_util/"
            "bounds)",
            tag_keys=("deployment", "direction", "reason")),
        "replicas": m.Gauge(
            "serve_autoscale_replicas",
            "Replica target the SLO autoscaler last set per "
            "deployment", tag_keys=("deployment",)),
    }


def is_slo(auto: Optional[dict]) -> bool:
    """Does this autoscaling_config select the SLO actuator?"""
    if not auto:
        return False
    return auto.get("policy") == "slo" or "slo" in auto


@dataclass
class Inputs:
    """One deployment's observed state for one decision tick."""
    running: int                    # RUNNING replicas
    target: int                     # current controller target
    ongoing: int                    # in-flight requests across running
    max_ongoing: int                # per-replica concurrency
    burn: Optional[dict] = None     # health burn_advice entry, if any
    hint: bool = False              # proxy shed-while-burning fast path


@dataclass
class _DepState:
    last_change: float = 0.0
    low_since: Optional[float] = None
    hint_ts: float = -1e18          # last fast-path hint arrival
    hint_tier: str = "page"         # tier the hint reported
    last_reason: str = ""
    last_direction: str = ""


@dataclass
class Decision:
    target: int
    direction: str = ""
    reason: Optional[str] = None    # None = hold


class SLOAutoscaler:
    """One per serve controller. ``clock`` is injectable for tests."""

    def __init__(self, cfg=None, clock=time.time):
        if cfg is None:
            from ray_tpu_torch.config import get_config
            cfg = get_config()
        self.clock = clock
        self.interval_s = float(getattr(
            cfg, "serve_autoscale_interval_s", 2.0))
        self.cooldown_s = float(getattr(
            cfg, "serve_autoscale_cooldown_s", 15.0))
        self.step = max(1, int(getattr(cfg, "serve_autoscale_step", 1)))
        self.low_util = float(getattr(
            cfg, "serve_autoscale_low_util", 0.25))
        self.low_window_s = float(getattr(
            cfg, "serve_autoscale_low_util_window_s", 30.0))
        self.high_util = float(getattr(
            cfg, "serve_autoscale_high_util", 0.85))
        self._m = autoscale_metrics()
        self._state: Dict[str, _DepState] = {}

    def state(self, name: str) -> _DepState:
        st = self._state.get(name)
        if st is None:
            st = self._state[name] = _DepState()
        return st

    def note_hint(self, name: str, tier: str = "page") -> None:
        """Proxy fast path: a request was shed while the deployment's
        SLO budget was burning. A page-tier hint counts as a page
        signal at the next decision tick (no waiting for the advice
        fetch); a warn-tier hint only feeds the hot-utilization
        warn path — the deadband still gates it."""
        st = self.state(name)
        st.hint_ts = self.clock()
        st.hint_tier = str(tier or "page")

    def forget(self, name: str) -> None:
        self._state.pop(name, None)

    # -- the decision core (pure; fake-clock tested) ---------------------

    def decide(self, name: str, inp: Inputs, auto: dict) -> Decision:
        now = self.clock()
        st = self.state(name)
        lo = max(1, int(auto.get("min_replicas", 1)))
        hi = max(lo, int(auto.get("max_replicas", 8)))
        # bounds are enforced every tick, cooldown-exempt (the legacy
        # actuator clamps the same way): a target outside
        # [min_replicas, max_replicas] — initial deploy below min, a
        # config change shrinking max — converges immediately
        bounded = min(hi, max(lo, inp.target))
        if bounded != inp.target:
            st.low_since = None
            return Decision(bounded,
                            "up" if bounded > inp.target else "down",
                            "bounds")
        cap = max(1, inp.running * max(1, inp.max_ongoing))
        util = inp.ongoing / cap
        burn = inp.burn or {}
        burning = bool(burn.get("availability_burning")
                       or burn.get("latency_burning"))
        page = burning and burn.get("tier") == "page"
        hint = inp.hint or (now - st.hint_ts) < self.interval_s * 2
        # a warn-tier hint is NOT a page signal: it joins the warn
        # path below, where the utilization deadband still gates it
        hint_page = hint and st.hint_tier != "warn"
        in_cooldown = (now - st.last_change) < self.cooldown_s
        # -- scale up: the SLO is the trigger, not a queue heuristic --
        if (page or hint_page) and inp.target < hi:
            if in_cooldown:
                return Decision(inp.target)     # hysteresis holds
            st.low_since = None
            st.hint_ts = -1e18      # one hint buys one scale-up
            return Decision(min(hi, inp.target + self.step), "up",
                            "page_burn" if page else "shed_hint")
        if (burning or hint) and util >= self.high_util \
                and inp.target < hi:
            # warn-tier burn (or warn hint) with hot replicas: scale
            # before the page tier fires (the deadband's upper edge)
            if in_cooldown:
                return Decision(inp.target)
            st.low_since = None
            st.hint_ts = -1e18
            return Decision(min(hi, inp.target + self.step), "up",
                            "warn_burn")
        # -- scale down: sustained quiet, and never while burning ----
        if not burning and util < self.low_util and inp.target > lo \
                and inp.running >= inp.target:
            if st.low_since is None:
                st.low_since = now
            elif (now - st.low_since) >= self.low_window_s \
                    and not in_cooldown:
                return Decision(inp.target - 1, "down", "low_util")
            return Decision(inp.target)
        # deadband: anything between the thresholds holds steady (and
        # resets the low-utilization streak)
        st.low_since = None
        return Decision(inp.target)

    def apply(self, name: str, inp: Inputs, auto: dict) -> Decision:
        """decide() + bookkeeping: metrics, the "serve" timeline event,
        cooldown stamp. The caller (controller) writes the returned
        target into the deployment state — scale-down victims then
        DRAIN via the normal retire() path."""
        d = self.decide(name, inp, auto)
        st = self.state(name)
        self._m["replicas"].set(d.target, tags={"deployment": name})
        if d.reason is None:
            return d
        if d.reason != "bounds":
            # a bounds clamp is bookkeeping, not a scaling judgment —
            # it must not start a cooldown that would then hold back
            # the first REAL burn-driven scale-up
            st.last_change = self.clock()
        st.last_reason = d.reason
        st.last_direction = d.direction
        self._m["decisions"].inc(tags={
            "deployment": name, "direction": d.direction,
            "reason": d.reason})
        events.record(
            "serve", "autoscale", deployment=name,
            direction=d.direction, reason=d.reason,
            target=d.target, prev_target=inp.target,
            running=inp.running, ongoing=inp.ongoing,
            util=round(inp.ongoing
                       / max(1, inp.running * max(1, inp.max_ongoing)),
                       4))
        return d

    def describe(self, name: str) -> dict:
        """Status-surface row (controller.status() / dashboard)."""
        st = self.state(name)
        return {"policy": "slo",
                "last_change": st.last_change,
                "last_decision": (f"{st.last_direction}:"
                                  f"{st.last_reason}"
                                  if st.last_reason else None),
                "cooldown_s": self.cooldown_s}
