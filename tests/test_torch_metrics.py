"""The port's metrics registry (ray_tpu_torch/util/metrics.py) against the
JAX package's (ray_tpu/util/metrics.py), in one process with separate
registries: the same sequence of Counter/Gauge/Histogram operations,
with tags, boundaries and exemplars, renders byte-identical Prometheus
text (``render_all``, ``render_labeled``, ``strip_exemplars``) and the
same ``snapshot()``. The port's metric catalogs pass the repo's metric
lint."""

import importlib.util
import pathlib
import time

import pytest

from ray_tpu.util import metrics as jmetrics

from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import kvcache as tkv
from ray_tpu_torch.llm import spec as tspec
from ray_tpu_torch.serve import fault as tfault
from ray_tpu_torch.util import devmon as tdevmon
from ray_tpu_torch.util import metrics as tmetrics

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def clean(monkeypatch):
    """Both packages on empty registries (restored afterwards), and a
    fixed wall clock for the exemplars' timestamps."""
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod, "_REGISTRY", {})
        monkeypatch.setattr(mod, "_COLLECTORS", [])
        monkeypatch.setattr(mod, "_REMOTE", {})
    monkeypatch.setattr(time, "time", lambda: 1750000000.125)


def _counters(m):
    c = m.Counter("req_total", "Requests served", tag_keys=("route",))
    c.inc()
    c.inc(2, tags={"route": "/a"})
    c.inc(0.5, tags={"route": '/q"x'})          # a quote in a label
    big = m.Counter("big_total", "Past float %g precision")
    big.inc(1e7)
    big.inc(40)
    m.Counter("zero_total", "Registered, never incremented")


def _gauges(m):
    g = m.Gauge("depth", "Queue depth", tag_keys=("q",))
    g.set(3, tags={"q": "a"})
    g.inc(tags={"q": "a"})
    g.dec(0.25, tags={"q": "b"})
    g.set(1.0 / 3.0)
    m.Gauge("depth", "Same name: shared storage").inc(2)


def _histograms(m):
    h = m.Histogram("lat_s", "Latency")
    for v in (0.001, 0.005, 0.0051, 0.3, 11.0):
        h.observe(v)
    h.observe(0.02, tags={"route": "/a"}, exemplar="ab" * 16)
    h.observe(0.021, tags={"route": "/a"}, exemplar="cd" * 16)
    h.observe(99.0, tags={"route": "/a"}, exemplar="ef" * 16)
    b = m.Histogram("batch_size", "Slots", boundaries=(8, 1, 4, 2))
    for v in (1, 2, 3, 8, 9, 0):
        b.observe(v, exemplar="" if v else None)
    # same name and boundaries: one series; other boundaries: its own
    m.Histogram("batch_size", "again", boundaries=(1, 2, 4, 8)).observe(5)


def _mixed(m):
    _counters(m)
    _gauges(m)
    _histograms(m)
    m.register_collector(lambda: "# collected\nextra_total 7")
    m.merge_remote("node:1", "pushed_total{w=\"1\"} 3")
    assert m.core_metric("counter", "core_total", "Core") is \
        m.core_metric("counter", "core_total", "ignored")
    m.core_metric("gauge", "core_level", "Core level").set(9)
    m.core_metric("histogram", "core_s", "Core seconds").observe(0.5,
                                                                exemplar="x")
    with pytest.raises(ValueError, match="already registered"):
        m.Gauge("req_total", "a counter's name")


@pytest.mark.parametrize("case", [_counters, _gauges, _histograms, _mixed],
                         ids=lambda f: f.__name__.strip("_"))
def test_exposition_text_and_snapshot_match_jax(clean, case):
    out = {}
    for mod in (jmetrics, tmetrics):
        case(mod)
        text = mod.render_all()
        out[mod] = (text, mod.strip_exemplars(text), mod.snapshot(),
                    mod.render_labeled({"node": "n1", "worker": "w"}),
                    mod.render_labeled(None))
    assert out[tmetrics] == out[jmetrics]
    assert out[tmetrics][0].endswith("\n")


def test_reset_clears_registry_collectors_and_remote(clean):
    _mixed(tmetrics)
    tmetrics.reset()
    assert tmetrics.render_all() == "\n"
    assert tmetrics.snapshot() == {}


def _lint():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_lint", ROOT / "scripts" / "check_metrics_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("catalog", [
    tengine.engine_metrics, tkv.kvcache_metrics, tspec.spec_metrics,
    tfault.fault_metrics, tdevmon.devmon_metrics],
    ids=lambda f: f.__name__)
def test_port_catalogs_pass_the_metric_lint(clean, catalog):
    """Each catalog registers the JAX package's series under the same
    names, kinds and tags, and passes scripts/check_metrics_lint.py."""
    import ray_tpu.llm.engine as jengine
    import ray_tpu.llm.kvcache as jkv
    import ray_tpu.llm.spec as jspec
    import ray_tpu.serve.fault as jfault
    import ray_tpu.util.devmon as jdevmon
    jax_catalog = {"engine_metrics": jengine.engine_metrics,
                   "kvcache_metrics": jkv.kvcache_metrics,
                   "spec_metrics": jspec.spec_metrics,
                   "fault_metrics": jfault.fault_metrics,
                   "devmon_metrics": jdevmon.devmon_metrics}[catalog.__name__]
    got, want = catalog(), jax_catalog()
    assert _lint().lint({m.name: m for m in got.values()}) == []

    def shape(ms):
        return {k: (m.name, m.kind, m.tag_keys,
                    getattr(m, "boundaries", None)) for k, m in ms.items()}
    assert shape(got) == shape(want)
