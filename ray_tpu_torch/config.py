"""The knobs the port's modules read.

A subset of ``ray_tpu/config.py``: the fields that ``util/tracing.py`` and
``util/devmon.py`` read, with the reference's defaults and its
``RAY_TPU_<NAME>`` environment overrides. A field comes in with the first
port module that reads it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _env(name: str, default, typ: type):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    return default if raw is None else typ(raw)


@dataclass
class Config:
    # Request tracing (util/tracing.py): tail-based sampling when a
    # request FINISHES. Error / deadline-exceeded traces and traces
    # slower than trace_slow_threshold_s are always kept; healthy ones
    # keep with this probability (deterministic on the trace id).
    trace_sample_rate: float = 1.0
    trace_slow_threshold_s: float = 1.0
    # Device-plane observability (util/devmon.py; master switch is the
    # RAY_TPU_DEVMON env var). A source built >= devmon_recompile_threshold
    # times within devmon_recompile_window_s seconds flags a recompile
    # STORM. 0 disables the gate.
    devmon_recompile_threshold: int = 10
    devmon_recompile_window_s: float = 60.0
    # The trailing horizon the device_duty_cycle gauge integrates
    # device-compute windows over.
    devmon_duty_horizon_s: float = 30.0

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Defaults <- RAY_TPU_* environment <- explicit overrides."""
        kw = {f.name: _env(f.name, f.default, type(f.default))
              for f in fields(cls)}
        kw.update(overrides)
        return cls(**kw)


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.from_env()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
