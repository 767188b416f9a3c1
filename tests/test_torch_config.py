"""The port's Config (ray_tpu_torch/config.py) against the JAX package's
(ray_tpu/config.py): the port's fields are JAX fields, in the JAX order,
with the JAX defaults, and each has a reader in the port; booleans parse
alike, explicit overrides beat the environment, ``update`` keeps unknown
keys in ``extra``, and ``set_config``/``get_config`` are process-global.
Each field's ``RAY_TPU_<NAME>`` override is held to the JAX package's in
tests/test_torch_devmon.py (``test_config_knob_matches_jax``)."""

import dataclasses
import pathlib
import re

import pytest

from ray_tpu import config as jconfig

from ray_tpu_torch import config as tconfig

PORT = pathlib.Path(tconfig.__file__).resolve().parent


def _defaults(cls):
    return [(f.name, f.default if f.default_factory is dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


FIELDS = [f for f in dataclasses.fields(tconfig.Config) if f.name != "extra"]


def test_fields_are_jax_fields_with_jax_defaults():
    jax_defaults = dict(_defaults(jconfig.Config))
    mine = _defaults(tconfig.Config)
    assert all(jax_defaults[name] == d for name, d in mine)
    order = [n for n, _ in _defaults(jconfig.Config) if n in dict(mine)]
    assert [n for n, _ in mine] == order


def test_every_field_has_a_reader():
    """No knob is accepted and then ignored: each field is named in a
    port module other than config.py."""
    src = "\n".join(p.read_text() for p in PORT.rglob("*.py")
                    if p.name != "config.py" or p.parent != PORT)
    unread = [f.name for f in FIELDS
              if not re.search(rf"\b{f.name}\b", src)]
    assert unread == []


@pytest.mark.parametrize("raw", ["1", "true", "ON", "no", "0", "off"])
def test_bool_override_parses_like_jax(monkeypatch, raw):
    monkeypatch.setenv("RAY_TPU_HEALTH_ENABLED", raw)
    assert tconfig.Config.from_env().health_enabled is \
        jconfig.Config.from_env().health_enabled


def test_explicit_overrides_beat_env_and_update_keeps_unknowns(monkeypatch):
    monkeypatch.setenv("RAY_TPU_NUM_WORKERS_PRESTART", "7")
    for mod in (tconfig, jconfig):
        cfg = mod.Config.from_env(num_workers_prestart=2,
                                  max_workers_per_node=6)
        assert (cfg.num_workers_prestart, cfg.max_workers_per_node) == (2, 6)
        cfg.update({"lease_timeout_s": 1.5, "not_a_field": 3})
        assert cfg.lease_timeout_s == 1.5 and cfg.extra == {"not_a_field": 3}


def test_set_and_get_config(monkeypatch):
    monkeypatch.setattr(tconfig, "_global_config", None)
    first = tconfig.get_config()
    assert first is tconfig.get_config()
    assert _defaults(tconfig.Config) == _defaults(type(first))
    cfg = tconfig.Config.from_env(trace_sample_rate=0.5)
    tconfig.set_config(cfg)
    assert tconfig.get_config() is cfg
