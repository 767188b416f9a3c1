"""Serve-plane fault-tolerance primitives: deadlines, budgeted retries,
and replica circuit breakers.

The port's copy of ``ray_tpu/serve/fault.py``; ``classify_error`` reads
the port's runtime errors (``ray_tpu_torch.runtime.core``).

Reference capabilities: python/ray/serve/_private/router.py (deadline-
aware request routing), request_router health policies, and the
gRPC-style deadline propagation the reference gets from its transport.
This module is dependency-light on purpose (config + metrics only) so
the proxy, the handle layer, the replica, and the LLM engine can all
import it without pulling model/torch code into the ingress process.

The deadline model: one absolute wall-clock timestamp (``time.time()``
based, so it crosses process boundaries on a node) minted at ingress
from the client's ``X-Request-Deadline`` budget and threaded
proxy -> handle -> replica -> engine. Every stage spends from the SAME
budget — queue wait, routing, retries, replica execution — instead of
stacking fresh per-hop timeouts (the old fixed 120 s ``get_async`` and
the 30 s-per-attempt discovery loop).
"""

from __future__ import annotations

import random
import time
from contextvars import ContextVar
from typing import Callable, Optional


class DeadlineExceeded(RuntimeError):
    """The request's deadline budget was spent. Raised wherever the
    budget runs out — proxy queue, replica entry, or mid-generation in
    the engine (which reclaims the batch slot) — and mapped to HTTP 504
    at the proxy."""


class ReplicaDraining(RuntimeError):
    """The target replica is DRAINING (scale-down / redeploy) and
    accepts no new requests. The request never started, so rerouting to
    another replica is always safe (idempotent by construction)."""


# -- request deadline context ------------------------------------------------

_request_deadline: ContextVar[Optional[float]] = ContextVar(
    "serve_request_deadline", default=None)


def set_request_deadline(deadline_ts: Optional[float]):
    """Bind the absolute wall-clock deadline for the current request
    context (the replica does this before invoking user code); returns
    the reset token."""
    return _request_deadline.set(deadline_ts)


def reset_request_deadline(token) -> None:
    try:
        _request_deadline.reset(token)
    except ValueError:
        # async-generator finally blocks can run in a different task
        # context than the set (streaming driver) — clearing is enough
        _request_deadline.set(None)


def current_deadline_ts() -> Optional[float]:
    """The active request's absolute deadline (``time.time()`` base),
    or None when the caller supplied no budget. User code and the LLM
    engine read this to cancel work the moment the budget is spent."""
    return _request_deadline.get()


def remaining_s(deadline_ts: Optional[float],
                now: Optional[float] = None) -> Optional[float]:
    """Seconds of budget left (may be <= 0); None for no deadline."""
    if deadline_ts is None:
        return None
    return deadline_ts - (time.time() if now is None else now)


def classify_error(e: BaseException) -> str:
    """Bucket a serve-path failure for retry/breaker/HTTP decisions:

      "deadline" — the budget was spent (proxy maps to 504);
      "draining" — the replica rejected before starting (always safe
                    to reroute);
      "timeout"  — a get() timed out (load or budget, NOT proof the
                    replica is broken — doesn't trip the breaker);
      "infra"    — replica/worker/object-plane failure (trips the
                    breaker, reroutable when the send failed);
      "user"     — the handler raised (the replica is healthy).

    Remote user exceptions arrive wrapped as TaskError with ``cause``
    set to the original — both layers are inspected."""
    from ray_tpu_torch.runtime.core import (GetTimeoutError, RayTpuError,
                                      TaskError)
    cause = getattr(e, "cause", None)
    for x in (e, cause):
        if isinstance(x, DeadlineExceeded):
            return "deadline"
        if isinstance(x, ReplicaDraining):
            return "draining"
    if isinstance(e, GetTimeoutError):
        return "timeout"
    if isinstance(e, TaskError):
        return "user"
    if isinstance(e, RayTpuError):
        return "infra"
    return "user"


# -- metrics -----------------------------------------------------------------

def fault_metrics() -> dict:
    """Get-or-create the serve fault-tolerance series (the reference's
    names and tags; head-aggregated like every other registry metric,
    worker processes push them)."""
    from ray_tpu_torch.util import metrics as m
    return {
        "shed": m.Counter(
            "serve_shed_total",
            "Requests shed by proxy admission control (fast 503 + "
            "Retry-After): queue full or predicted queue wait past the "
            "deadline budget", tag_keys=("deployment",)),
        "retries": m.Counter(
            "serve_retries_total",
            "Budgeted serve-path retries by reason (route_refresh, "
            "reroute, draining)", tag_keys=("reason",)),
        "deadline": m.Counter(
            "serve_deadline_exceeded_total",
            "Requests cancelled because their deadline budget was "
            "spent, by enforcement point (proxy, replica, engine)",
            tag_keys=("where",)),
        "ejected": m.Gauge(
            "serve_replica_ejected",
            "1 while the replica is ejected by its circuit breaker "
            "(0.5 = half-open trial, 0 = closed/restored)",
            tag_keys=("replica",)),
        "drain_wait": m.Histogram(
            "serve_drain_wait_s",
            "Time a DRAINING replica spent finishing its in-flight "
            "requests before stop", tag_keys=("deployment",)),
    }


# -- budgeted retries --------------------------------------------------------

class RetryPolicy:
    """Budgeted retry for IDEMPOTENT work only: jittered exponential
    backoff, capped by both an attempt count and the request's
    remaining deadline. Replaces the serve plane's ad-hoc one-shot
    immediate retries (a thundering herd against a restarting
    controller) and its stacked fixed timeouts.

    Idempotency is the caller's contract: route-table refreshes and
    submissions that FAILED TO SEND are always safe; a request that may
    have already executed must not be fed back through this."""

    def __init__(self, max_attempts: int = 3, base_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0, reason: str = "retry",
                 rng: Optional[random.Random] = None):
        self.max_attempts = max(1, int(max_attempts))
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.reason = reason
        self._rng = rng or random.Random()

    @classmethod
    def from_config(cls, reason: str, cfg=None) -> "RetryPolicy":
        if cfg is None:
            from ray_tpu_torch.config import get_config
            cfg = get_config()
        return cls(
            max_attempts=int(getattr(cfg, "serve_retry_max_attempts", 3)),
            base_backoff_s=float(getattr(cfg, "rpc_retry_backoff_s", 0.1)),
            reason=reason)

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter exponential: uniform in (0, base * 2^attempt],
        capped — concurrent retriers decorrelate instead of
        re-colliding on the same beat."""
        hi = min(self.max_backoff_s,
                 self.base_backoff_s * (2 ** max(0, attempt)))
        return self._rng.uniform(0.0, hi) if hi > 0 else 0.0

    def _sleepable(self, attempt: int,
                   deadline_ts: Optional[float]) -> Optional[float]:
        """Backoff before attempt+1, or None when the budget (attempts
        or deadline) is spent and the caller must surface the error."""
        if attempt + 1 >= self.max_attempts:
            return None
        pause = self.backoff_s(attempt)
        rem = remaining_s(deadline_ts)
        if rem is not None:
            if rem <= 0:
                return None
            pause = min(pause, max(0.0, rem - 0.001))
        return pause

    def run(self, fn: Callable, deadline_ts: Optional[float] = None,
            retryable: Callable[[BaseException], bool] = None):
        """Sync retry loop. ``retryable(e)`` (default: everything)
        gates which failures are retried at all."""
        metrics = fault_metrics()
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001
                if retryable is not None and not retryable(e):
                    raise
                pause = self._sleepable(attempt, deadline_ts)
                if pause is None:
                    raise
                metrics["retries"].inc(tags={"reason": self.reason})
                time.sleep(pause)
                attempt += 1

    async def run_async(self, fn: Callable,
                        deadline_ts: Optional[float] = None,
                        retryable: Callable[[BaseException], bool] = None):
        """Async twin of run(); ``fn`` is an async callable."""
        import asyncio
        metrics = fault_metrics()
        attempt = 0
        while True:
            try:
                return await fn()
            except BaseException as e:  # noqa: BLE001
                if retryable is not None and not retryable(e):
                    raise
                pause = self._sleepable(attempt, deadline_ts)
                if pause is None:
                    raise
                metrics["retries"].inc(tags={"reason": self.reason})
                await asyncio.sleep(pause)
                attempt += 1


# -- replica circuit breaker -------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-replica breaker in the caller-side routing table.

    CLOSED -> OPEN after ``failure_threshold`` CONSECUTIVE
    infrastructure failures (or, when armed, ``latency_count``
    consecutive calls slower than ``latency_threshold_s`` — a stuck
    replica that still answers pings). OPEN -> HALF_OPEN after
    ``cooldown_s`` (or immediately via a successful recovery probe:
    :meth:`force_half_open`); HALF_OPEN admits exactly ONE trial
    request — success closes, failure re-opens with a fresh cooldown.
    A failing probe pushes the cooldown forward (:meth:`extend_open`)
    so a dead replica never half-opens on a timer.

    ``clock`` is injectable for deterministic tests."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 2.0,
                 latency_threshold_s: float = 0.0, latency_count: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self.latency_threshold_s = float(latency_threshold_s)
        self.latency_count = max(1, int(latency_count))
        self._clock = clock
        self.state = CLOSED
        self._fails = 0
        self._slow = 0
        self._opened_at = 0.0
        self._trial_inflight = False

    def _open(self) -> None:
        self.state = OPEN
        self._opened_at = self._clock()
        self._trial_inflight = False

    def allow(self) -> bool:
        """May the next request be routed to this replica? OPEN flips
        to HALF_OPEN when the cooldown has elapsed; HALF_OPEN admits
        one trial at a time."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self._opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
            else:
                return False
        if self._trial_inflight:
            return False
        self._trial_inflight = True
        return True

    def record_success(self, latency_s: Optional[float] = None) -> None:
        if self.state == OPEN:
            # a late result from a call sent BEFORE ejection: ignoring
            # it keeps the cooldown honest — only a half-open TRIAL
            # (admitted by allow()/force_half_open) may close
            return
        if latency_s is not None and self.latency_threshold_s > 0:
            if latency_s > self.latency_threshold_s:
                self._slow += 1
                if self._slow >= self.latency_count:
                    self._slow = 0
                    self._open()
                    return
            else:
                self._slow = 0
        self._fails = 0
        self.state = CLOSED
        self._trial_inflight = False

    def record_failure(self) -> None:
        self._trial_inflight = False
        if self.state == HALF_OPEN:
            self._open()            # the trial failed: fresh cooldown
            return
        self._fails += 1
        if self._fails >= self.failure_threshold:
            self._fails = 0
            self._open()

    def force_half_open(self) -> None:
        """A recovery probe (ping) succeeded: skip the remaining
        cooldown and admit a trial request now."""
        if self.state == OPEN:
            self.state = HALF_OPEN
            self._trial_inflight = False

    def extend_open(self) -> None:
        """A recovery probe failed: restart the cooldown so the timer
        alone can't half-open a replica that still doesn't answer."""
        if self.state in (OPEN, HALF_OPEN):
            self._open()
