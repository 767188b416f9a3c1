"""Serve-plane fault tolerance: the deadline error and its counters.

The port's copy of the parts of ``ray_tpu/serve/fault.py`` that the
engine uses: ``DeadlineExceeded``, which crosses the serve boundary typed
(a proxy answers 504 for it), and ``fault_metrics``, the five series the
serve plane and the engine count into. Retries, circuit breakers and the
request deadline context wait for the port's serve plane.
"""

from __future__ import annotations


class DeadlineExceeded(RuntimeError):
    """The request's deadline budget was spent. Raised wherever the
    budget runs out — proxy queue, replica entry, or mid-generation in
    the engine (which reclaims the batch slot) — and mapped to HTTP 504
    at the proxy."""


def fault_metrics() -> dict:
    """Get-or-create the serve fault-tolerance series (the reference's
    names and tags)."""
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
