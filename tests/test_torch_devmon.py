"""The port's device monitor (ray_tpu_torch/util/devmon.py) against the
JAX package's (ray_tpu/util/devmon.py), in one process with separate
registries and buffers: the duty cycle over the same windows (overlapping
ones included), the device-window events, the compile record's ``xla_*``
series and events, and the storm gate agree; without CUDA,
``hbm_snapshot()`` is empty. A kernel source that nvcc actually builds is
recorded as exactly one compile, and a reused build as none. The knobs
the port's config carries (``ray_tpu_torch/config.py``) have the JAX
package's defaults and ``RAY_TPU_<NAME>`` overrides."""

import dataclasses
import time

import pytest

from ray_tpu import config as jconfig
from ray_tpu.util import devmon as jdevmon
from ray_tpu.util import events as jevents
from ray_tpu.util import metrics as jmetrics

from ray_tpu_torch import config as tconfig
from ray_tpu_torch.ops import _build
from ray_tpu_torch.util import devmon as tdevmon
from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import metrics as tmetrics

PAIRS = [(jdevmon, jevents, jmetrics), (tdevmon, tevents, tmetrics)]
NOW = 1750000000.0


@pytest.fixture
def clean(monkeypatch):
    """Both packages with empty registries, buffers and detector state
    (restored afterwards), at a fixed wall clock."""
    for dm, ev, m in PAIRS:
        monkeypatch.setattr(ev, "_BUFS", {})
        monkeypatch.setattr(m, "_REGISTRY", {})
        monkeypatch.setattr(m, "_COLLECTORS", [])
        monkeypatch.setattr(m, "_REMOTE", {})
        dm._reset_for_tests()
    monkeypatch.setattr(time, "time", lambda: NOW)
    yield
    for dm, _, _ in PAIRS:
        dm._reset_for_tests()


def _no_pid(evs):
    return [{k: v for k, v in e.items() if k != "pid"} for e in evs]


WINDOWS = {
    "none": [],
    "one": [(-10.0, -4.0)],
    "disjoint": [(-25.0, -20.0), (-10.0, -9.5), (-1.0, 0.0)],
    "overlapping": [(-10.0, -5.0), (-7.0, -2.0), (-6.0, -6.5),
                    (-3.0, -1.0)],
    "nested": [(-20.0, -1.0), (-15.0, -14.0), (-5.0, -2.0)],
    "past_horizon": [(-100.0, -40.0), (-35.0, -29.0), (-29.5, -28.0)],
    "future_edge": [(-2.0, 5.0), (-1.0, -0.5)],
    "saturated": [(-40.0, 1.0), (-31.0, -1.0)],
}


@pytest.mark.parametrize("horizon", [None, 5.0, 30.0, 1e-6])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_duty_cycle_matches_jax(clean, name, horizon):
    for dm, _, _ in PAIRS:
        for t0, t1 in WINDOWS[name]:
            dm.record_device_window("decode", NOW + t0, NOW + t1,
                                    device="cuda:0", trace="t" * 32)
    got = tdevmon.duty_cycle(horizon, now=NOW)
    assert got == jdevmon.duty_cycle(horizon, now=NOW)
    assert 0.0 <= got <= 1.0
    assert _no_pid(tevents.dump()) == _no_pid(jevents.dump())


def test_device_window_defaults_match_jax(clean, monkeypatch):
    """Without an explicit device both label the CPU "cpu:0" here (jax is
    loaded on the CPU in this process; torch has not initialised CUDA),
    and the context-manager form stamps the ambient trace."""
    from ray_tpu.util import tracing as jtracing
    from ray_tpu_torch.util import tracing as ttracing
    for (dm, _, _), tr in zip(PAIRS, (jtracing, ttracing)):
        ticks = iter(range(10))
        monkeypatch.setattr(time, "time",
                            lambda ticks=ticks: NOW + 0.25 * next(ticks))
        dm.record_device_window("prefill", NOW - 1.0, NOW - 0.5)
        dm.record_device_window("prefill", NOW, NOW)     # empty: dropped
        tok = tr.set_request_context(tr.TraceContext("f" * 32, "e" * 16))
        with dm.device_window("decode"):
            pass
        tr.reset_request_context(tok)
    got = _no_pid(tevents.dump())
    assert got == _no_pid(jevents.dump())
    assert [e["device"] for e in got] == ["cpu:0", "cpu:0"]
    assert got[1]["trace"] == "f" * 32


def _xla(m):
    """The xla_* series' text (the JAX package's record_compile also
    feeds its goodput ledger, which the port has not ported)."""
    return "\n".join(x.render() for x in m._REGISTRY.values()
                     if x.name.startswith("xla_"))


def test_compile_records_match_jax(clean, monkeypatch):
    """The same compiles (repeats past the storm threshold, a cache hit,
    one under a request trace) give the same xla_* text and events."""
    from ray_tpu.util import tracing as jtracing
    from ray_tpu_torch.util import tracing as ttracing
    for (dm, _, m), tr in zip(PAIRS, (jtracing, ttracing)):
        # Config.devmon_recompile_threshold (10) compiles of a.cu flag
        # one storm
        for fn, dur in [("a.cu", 12.5), ("b.cu", 0.04), ("a.cu", 61.0)] \
                + [("a.cu", 0.3)] * 8:
            dm.record_compile(fn, dur)
        dm.record_compile("a.cu", 0.01, cache_hit=True)
        tok = tr.set_request_context(tr.TraceContext("9" * 32, "8" * 16))
        dm.record_compile("c.cu", 2.0)
        tr.reset_request_context(tok)
    text = _xla(tmetrics)
    assert text == _xla(jmetrics)
    assert 'xla_compiles_total{fn="a.cu"} 10' in text
    assert 'xla_recompiles_total{fn="a.cu"} 9' in text
    assert 'xla_recompile_storms_total{fn="a.cu"} 1' in text
    assert 'trace_id="' + "9" * 32 in text
    assert _no_pid(tevents.dump()) == _no_pid(jevents.dump())


def test_devmon_off_records_nothing(clean, monkeypatch):
    for dm, ev, m in PAIRS:
        monkeypatch.setattr(dm, "_ENABLED", False)
        dm.record_compile("a.cu", 1.0)
        dm.record_device_window("decode", NOW - 1.0, NOW)
        assert dm.hbm_snapshot() == [] and ev.dump() == []
        assert dm.duty_cycle(now=NOW) == 0.0


def test_hbm_snapshot_is_empty_without_cuda(clean):
    assert tdevmon.hbm_snapshot() == []
    assert tmetrics.render_all() == "\n"


def _fake_nvcc(tmp_path, fail=False):
    """A stand-in nvcc that writes its -o target (or fails)."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        + ("echo 'error: refused'; exit 1\n" if fail else
           'while [ "$1" != "-o" ]; do shift; done; echo ptxas ok > "$2"\n'))
    nvcc.chmod(0o755)
    return str(nvcc)


@pytest.mark.parametrize("fail", [False, True], ids=["built", "refused"])
def test_a_real_build_records_one_compile(clean, monkeypatch, tmp_path,
                                          fail):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, fail)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    loader = _build._Loader()
    if fail:
        with pytest.raises(_build.KernelBuildError, match="refused"):
            loader.build(["paged_attention", "flash_attention_fwd"])
        assert "xla_compiles_total" not in tmetrics.render_all()
        return
    loader.build(["paged_attention"])
    loader.build(["paged_attention"])           # reused: no compile
    text = tmetrics.render_all()
    assert 'xla_compiles_total{fn="paged_attention.cu"} 1' in text
    assert "xla_recompiles_total{" not in text
    [ev] = [e for e in tevents.dump() if e["name"] == "compile"]
    assert ev["fn"] == "paged_attention.cu" and ev["dur"] >= 0
    loader.build(["flash_attention_bwd_dkv", "flash_attention_bwd_dq"])
    assert 'xla_compiles_total{fn="flash_attention_bwd.cu"} 1' in \
        tmetrics.render_all()


@pytest.mark.parametrize("name", [f.name for f in
                                  dataclasses.fields(tconfig.Config)])
def test_config_knob_matches_jax(monkeypatch, name):
    """Each field of the port's Config: the JAX Config's default, and the
    same value from the same ``RAY_TPU_<NAME>`` override."""
    assert getattr(tconfig.Config(), name) == getattr(jconfig.Config(), name)
    monkeypatch.setenv(f"RAY_TPU_{name.upper()}", "7")
    got = getattr(tconfig.Config.from_env(), name)
    assert got == getattr(jconfig.Config.from_env(), name) == 7
    assert type(got) is type(getattr(tconfig.Config(), name))
