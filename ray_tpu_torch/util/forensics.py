"""Forensics: the engine/queue state providers.

The port's copy of the state-provider registry of
``ray_tpu/util/forensics.py``: components register a zero-argument
callable whose value a postmortem bundle would carry under
``state.<name>`` (the ``LLMEngine`` registers its ``stats``). The
collective ledger, the cross-rank audit and the bundle writer wait for
the port's runtime.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict

_providers: Dict[str, Callable[[], Any]] = {}
_providers_lock = threading.Lock()


def register_state_provider(name: str, fn: Callable[[], Any]) -> None:
    """Register a zero-argument callable whose return value rides every
    postmortem bundle under ``state.<name>`` (LLM engines register
    their queue/admission stats here). Use a weakref-closing closure
    for owner-bound state so registration never extends a lifetime."""
    with _providers_lock:
        _providers[name] = fn


def unregister_state_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


def provider_states() -> Dict[str, Any]:
    with _providers_lock:
        items = list(_providers.items())
    out: Dict[str, Any] = {}
    for name, fn in items:
        try:
            v = fn()
            if v is not None:
                out[name] = v
        except Exception as e:   # noqa: BLE001 — one bad provider
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out
