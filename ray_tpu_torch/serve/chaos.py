"""Deterministic fault injection for the serve data path.

The serving sibling of ``Config.testing_rpc_failure`` (rpc_chaos.h) and
``Config.testing_channel_failure`` (dag/channel.py ChannelChaos):
repeatable injected faults by REQUEST INDEX instead of hand-timed
process kills, so circuit breakers, deadline rescue, shedding, and
drain paths are exercised by tests and the chaos bench the same way
every run.

Spec (``Config.testing_serve_failure``): comma-separated rules
``<site>:<action>:<nth>[:<param>]`` —

  site    "proxy"   — the handle -> replica submission boundary
                      (DeploymentHandle._route; the proxy routes
                      through it, so this is the proxy->replica hop)
          "replica" — the replica -> user-code/engine boundary
                      (Replica.handle_request / handle_request_stream)
  action  "error"   — raise an injected failure (proxy site: a
                      routable RayTpuError, exercising the budgeted
                      reroute; replica site: a user-level RuntimeError)
          "delay"   — sleep ``param`` seconds (default 0.1) before
                      proceeding (latency-ejection food)
          "drop"    — replica site only: never respond; the caller's
                      propagated deadline is the only rescue
          "kill"    — SIGKILL this process (a deterministic replica
                      death mid-request)
  nth     1-based index of the matching site's requests, counted
          process-wide
  param   seconds (delay only)

Counters advance once per ROUTED CALL: a budgeted reroute after an
injected proxy-site error is a new call and advances the counter —
"proxy:error:1,proxy:error:2" fails the first request's first two
routing attempts deterministically.

The port's copy of ``ray_tpu/serve/chaos.py``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

SITES = ("proxy", "replica")
ACTIONS = ("error", "delay", "drop", "kill")


class ServeChaos:
    """Parsed testing_serve_failure rules + per-site trigger counters."""

    def __init__(self, spec: str):
        self.rules = []
        for part in filter(None, (spec or "").split(",")):
            bits = part.strip().split(":")
            if len(bits) < 3:
                raise ValueError(
                    f"testing_serve_failure rule {part!r}: expected "
                    f"<site>:<action>:<nth>[:<param>]")
            site, action, nth = bits[0], bits[1], int(bits[2])
            if site not in SITES:
                raise ValueError(
                    f"testing_serve_failure site must be one of "
                    f"{SITES}, got {site!r}")
            if action not in ACTIONS:
                raise ValueError(
                    f"testing_serve_failure action must be one of "
                    f"{ACTIONS}, got {action!r}")
            if action == "drop" and site != "replica":
                raise ValueError(
                    "testing_serve_failure: drop is replica-site only "
                    "(a lost response frame; the proxy boundary "
                    "injects error/delay/kill)")
            if nth < 1:
                raise ValueError(
                    f"testing_serve_failure nth must be >= 1, got {nth}")
            param = float(bits[3]) if len(bits) > 3 else 0.1
            self.rules.append(
                {"site": site, "action": action, "nth": nth,
                 "param": param, "count": 0})

    def fire(self, site: str) -> Optional[Tuple[str, float]]:
        """Advance counters for ``site``; returns ``(action, param)``
        for the call site to apply — kill is executed HERE (it never
        returns), every other action is returned so async call sites
        can apply it without blocking their event loop."""
        out = None
        for r in self.rules:
            if r["site"] != site:
                continue
            r["count"] += 1
            if r["count"] != r["nth"]:
                continue
            if r["action"] == "kill":
                import os
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            out = (r["action"], r["param"])
        return out


_chaos: Optional[ServeChaos] = None
_chaos_loaded = False


def chaos_fire(site: str) -> Optional[Tuple[str, float]]:
    """Per-request chaos hook; near-zero cost when
    testing_serve_failure is empty (one module-global check)."""
    global _chaos, _chaos_loaded
    if not _chaos_loaded:
        from ray_tpu_torch.config import get_config
        spec = getattr(get_config(), "testing_serve_failure", "")
        _chaos = ServeChaos(spec) if spec else None
        _chaos_loaded = True
    if _chaos is None:
        return None
    return _chaos.fire(site)


def apply_sync(act: Optional[Tuple[str, float]], where: str) -> None:
    """Apply a fired action from a SYNC context (the handle's routing
    path runs on caller threads): delay sleeps, error raises a
    routable infrastructure failure so the budgeted reroute/circuit
    breaker paths see exactly what a flaky replica link produces."""
    if act is None:
        return
    action, param = act
    if action == "delay":
        time.sleep(param)
    elif action == "error":
        from ray_tpu_torch.api import RayTpuError
        raise RayTpuError(f"serve chaos: injected {where} error")


async def apply_async(act: Optional[Tuple[str, float]],
                      where: str) -> None:
    """Apply a fired action from the replica's event loop: delay
    yields, drop parks forever (the response frame is 'lost' — only
    the caller's propagated deadline rescues it), error raises."""
    if act is None:
        return
    import asyncio
    action, param = act
    if action == "delay":
        await asyncio.sleep(param)
    elif action == "drop":
        await asyncio.Event().wait()      # never set: response lost
    elif action == "error":
        raise RuntimeError(f"serve chaos: injected {where} error")


def reset_serve_chaos() -> None:
    """Re-read testing_serve_failure on the next request (tests flip
    the config mid-process; counters restart from zero)."""
    global _chaos, _chaos_loaded
    _chaos = None
    _chaos_loaded = False
